"""Loss functions; counterpart of ``flexflow_tpu/core/losses.py``, op
for op. Losses are means over the batch, computed in the dtype of the
predictions (a bf16 graph's loss is a bf16 mean, as in the JAX package
without its mixed-precision policy)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

LOSS_SPARSE_CCE = "sparse_categorical_crossentropy"
LOSS_CCE = "categorical_crossentropy"
LOSS_MSE = "mean_squared_error"
LOSS_BCE = "binary_crossentropy"
LOSS_IDENTITY = "identity"


def flatten_sparse_labels(preds, labels):
    """Normalize sparse int labels against predictions: (batch,) /
    (batch, 1) labels pass through; per-position labels (batch, t...)
    matching preds (batch, t..., classes) flatten both so each position
    scores as one sample. Shared by the loss and the metrics."""
    labels = labels.to(torch.int64)
    if (labels.dim() >= 2 and labels.dim() == preds.dim() - 1
            and tuple(labels.shape) == tuple(preds.shape[:-1])):
        return preds.reshape(-1, preds.shape[-1]), labels.reshape(-1)
    return preds, labels.reshape(labels.shape[0])


def _take_clip(logp, labels):
    """logp[i, labels[i]] with labels clamped into range, as
    ``jnp.take_along_axis(..., mode="clip")``."""
    idx = labels.clamp(0, logp.shape[-1] - 1)[:, None]
    return torch.gather(logp, -1, idx)


def sparse_categorical_crossentropy(logits_or_probs, labels,
                                    from_logits: bool = False):
    """labels: int (batch,) / (batch, 1) or per-position. Takes
    probabilities (the graph ends in Softmax) unless from_logits."""
    preds, labels = flatten_sparse_labels(logits_or_probs, labels)
    if from_logits:
        logp = torch.log_softmax(preds, dim=-1)
    else:
        logp = torch.log(torch.clamp(preds, 1e-12, 1.0))
    return torch.mean(-_take_clip(logp, labels))


def categorical_crossentropy(probs, labels, from_logits: bool = False):
    if from_logits:
        logp = torch.log_softmax(probs, dim=-1)
    else:
        logp = torch.log(torch.clamp(probs, 1e-12, 1.0))
    return -torch.mean(torch.sum(labels * logp, dim=-1))


def mean_squared_error(preds, targets, from_logits: bool = False):
    return torch.mean(torch.square(preds.float() - targets.float()))


def binary_crossentropy(preds, targets, from_logits: bool = False):
    if from_logits:
        return torch.mean(torch.clamp(preds, min=0) - preds * targets
                          + torch.log1p(torch.exp(-torch.abs(preds))))
    p = torch.clamp(preds, 1e-7, 1 - 1e-7)
    return -torch.mean(targets * torch.log(p)
                       + (1 - targets) * torch.log(1 - p))


def identity(preds, targets, from_logits: bool = False):
    """Mean of predictions — when the graph computes its own loss."""
    return torch.mean(preds)


LOSSES: Dict[str, Callable] = {
    LOSS_SPARSE_CCE: sparse_categorical_crossentropy,
    "sparse_crossentropy": sparse_categorical_crossentropy,
    LOSS_CCE: categorical_crossentropy,
    LOSS_MSE: mean_squared_error,
    "mse": mean_squared_error,
    LOSS_BCE: binary_crossentropy,
    LOSS_IDENTITY: identity,
}


def resolve(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    return LOSSES[name_or_fn]
