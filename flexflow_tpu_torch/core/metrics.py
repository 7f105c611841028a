"""Training metrics; counterpart of ``flexflow_tpu/core/metrics.py``.
``compute_metrics`` returns scalar sums and counts as tensors on the
step's device (the host takes means), ``PerfMetrics`` folds them."""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from .losses import _take_clip, flatten_sparse_labels

METRICS_ACCURACY = "accuracy"
METRICS_CCE = "categorical_crossentropy"
METRICS_SPARSE_CCE = "sparse_categorical_crossentropy"
METRICS_MSE = "mean_squared_error"
METRICS_RMSE = "root_mean_squared_error"
METRICS_MAE = "mean_absolute_error"


@dataclasses.dataclass
class PerfMetrics:
    """Host-side accumulator (the reference's PerfMetrics struct)."""

    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0

    def update(self, other: "PerfMetrics"):
        self.train_all += other.train_all
        self.train_correct += other.train_correct
        self.cce_loss += other.cce_loss
        self.sparse_cce_loss += other.sparse_cce_loss
        self.mse_loss += other.mse_loss
        self.rmse_loss += other.rmse_loss
        self.mae_loss += other.mae_loss

    def accuracy(self) -> float:
        return self.train_correct / max(1, self.train_all)


def compute_metrics(metric_names: Sequence[str], preds: torch.Tensor,
                    labels: torch.Tensor, sparse: bool
                    ) -> Dict[str, torch.Tensor]:
    """Scalar sums and counts of the named metrics over one batch."""
    out: Dict[str, torch.Tensor] = {}
    lbl = None
    if sparse:
        preds, lbl = flatten_sparse_labels(preds, labels)
    out["count"] = torch.full((), preds.shape[0], dtype=torch.int32,
                              device=preds.device)
    for m in metric_names:
        if m == METRICS_ACCURACY:
            # torch.argmax, like jnp.argmax, returns the first maximum
            pred_cls = torch.argmax(preds, dim=-1)
            if sparse:
                out["correct"] = torch.sum(pred_cls == lbl)
            else:
                out["correct"] = torch.sum(
                    pred_cls == torch.argmax(labels, dim=-1))
        elif m in (METRICS_CCE, METRICS_SPARSE_CCE):
            logp = torch.log(torch.clamp(preds, 1e-12, 1.0))
            if sparse:
                nll = -_take_clip(logp, lbl)
            else:
                nll = -torch.sum(labels * logp, dim=-1)
            out["cce_sum"] = torch.sum(nll)
        elif m == METRICS_MSE:
            out["mse_sum"] = torch.sum(
                torch.mean(torch.square(preds - labels), dim=-1))
        elif m == METRICS_RMSE:
            out["rmse_sum"] = torch.sum(torch.sqrt(
                torch.mean(torch.square(preds - labels), dim=-1)))
        elif m == METRICS_MAE:
            out["mae_sum"] = torch.sum(
                torch.mean(torch.abs(preds - labels), dim=-1))
    return out
