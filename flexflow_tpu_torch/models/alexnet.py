"""AlexNet of ``flexflow_tpu/models/alexnet.py``: the conv, pool, flat,
dense and softmax stack, in its CIFAR-10 (32x32) and ImageNet (>= 64)
geometries, with the JAX builder's op names."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import FFConfig
from ..model import FFModel


def build_alexnet(config: Optional[FFConfig] = None, batch_size: int = None,
                  num_classes: int = 10, image_size: int = 32,
                  mesh=None, strategy=None, dtype=None,
                  device="cuda") -> FFModel:
    """``dtype`` is the activation dtype (bf16 activations over f32
    master weights, cast per op)."""
    cfg = config or FFConfig()
    bs = batch_size or cfg.batch_size
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)
    x = ff.create_tensor((bs, 3, image_size, image_size),
                         dtype=dtype or torch.float32, name="input")
    if image_size >= 64:
        # ImageNet geometry
        t = ff.conv2d(x, 64, 11, 11, 4, 4, 2, 2, activation="relu")
    else:
        # CIFAR-10 geometry
        t = ff.conv2d(x, 64, 5, 5, 1, 1, 2, 2, activation="relu")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation="relu")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.flat(t)
    t = ff.dense(t, 4096, activation="relu")
    t = ff.dense(t, 4096, activation="relu")
    t = ff.dense(t, num_classes)
    ff.softmax(t)
    return ff
