"""Inception-v3 of ``flexflow_tpu/models/inception.py``: modules A-E of
parallel conv + BatchNorm branches joined by channel concats, with the
standard 299x299 stem at image sizes >= 128 and a reduced stem below,
and the JAX builder's op names. Every module's 1x1 branch heads read
one tensor with one geometry: with ``sibling_conv_fusion`` they run as
one conv (core/fusion.py)."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import FFConfig
from ..model import FFModel


def _conv_bn(ff, t, ch, kh, kw, sh, sw, ph, pw, name):
    t = ff.conv2d(t, ch, kh, kw, sh, sw, ph, pw, name=f"{name}_conv")
    return ff.batch_norm(t, relu=True, name=f"{name}_bn")


def _avg_branch(ff, t, ch, name):
    b = ff.pool2d(t, 3, 3, 1, 1, 1, 1, pool_type="avg", name=f"{name}_pool")
    return _conv_bn(ff, b, ch, 1, 1, 1, 1, 0, 0, f"{name}_b4")


def _inception_a(ff, t, pool_ch, name):
    b1 = _conv_bn(ff, t, 64, 1, 1, 1, 1, 0, 0, f"{name}_b1")
    b2 = _conv_bn(ff, t, 48, 1, 1, 1, 1, 0, 0, f"{name}_b2a")
    b2 = _conv_bn(ff, b2, 64, 5, 5, 1, 1, 2, 2, f"{name}_b2b")
    b3 = _conv_bn(ff, t, 64, 1, 1, 1, 1, 0, 0, f"{name}_b3a")
    b3 = _conv_bn(ff, b3, 96, 3, 3, 1, 1, 1, 1, f"{name}_b3b")
    b3 = _conv_bn(ff, b3, 96, 3, 3, 1, 1, 1, 1, f"{name}_b3c")
    b4 = _avg_branch(ff, t, pool_ch, name)
    return ff.concat([b1, b2, b3, b4], axis=1, name=f"{name}_cat")


def _inception_b(ff, t, name):
    b1 = _conv_bn(ff, t, 384, 3, 3, 2, 2, 0, 0, f"{name}_b1")
    b2 = _conv_bn(ff, t, 64, 1, 1, 1, 1, 0, 0, f"{name}_b2a")
    b2 = _conv_bn(ff, b2, 96, 3, 3, 1, 1, 1, 1, f"{name}_b2b")
    b2 = _conv_bn(ff, b2, 96, 3, 3, 2, 2, 0, 0, f"{name}_b2c")
    b3 = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name=f"{name}_pool")
    return ff.concat([b1, b2, b3], axis=1, name=f"{name}_cat")


def _inception_c(ff, t, ch7, name):
    b1 = _conv_bn(ff, t, 192, 1, 1, 1, 1, 0, 0, f"{name}_b1")
    b2 = _conv_bn(ff, t, ch7, 1, 1, 1, 1, 0, 0, f"{name}_b2a")
    b2 = _conv_bn(ff, b2, ch7, 1, 7, 1, 1, 0, 3, f"{name}_b2b")
    b2 = _conv_bn(ff, b2, 192, 7, 1, 1, 1, 3, 0, f"{name}_b2c")
    b3 = _conv_bn(ff, t, ch7, 1, 1, 1, 1, 0, 0, f"{name}_b3a")
    b3 = _conv_bn(ff, b3, ch7, 7, 1, 1, 1, 3, 0, f"{name}_b3b")
    b3 = _conv_bn(ff, b3, ch7, 1, 7, 1, 1, 0, 3, f"{name}_b3c")
    b3 = _conv_bn(ff, b3, ch7, 7, 1, 1, 1, 3, 0, f"{name}_b3d")
    b3 = _conv_bn(ff, b3, 192, 1, 7, 1, 1, 0, 3, f"{name}_b3e")
    b4 = _avg_branch(ff, t, 192, name)
    return ff.concat([b1, b2, b3, b4], axis=1, name=f"{name}_cat")


def _inception_d(ff, t, name):
    b1 = _conv_bn(ff, t, 192, 1, 1, 1, 1, 0, 0, f"{name}_b1a")
    b1 = _conv_bn(ff, b1, 320, 3, 3, 2, 2, 0, 0, f"{name}_b1b")
    b2 = _conv_bn(ff, t, 192, 1, 1, 1, 1, 0, 0, f"{name}_b2a")
    b2 = _conv_bn(ff, b2, 192, 1, 7, 1, 1, 0, 3, f"{name}_b2b")
    b2 = _conv_bn(ff, b2, 192, 7, 1, 1, 1, 3, 0, f"{name}_b2c")
    b2 = _conv_bn(ff, b2, 192, 3, 3, 2, 2, 0, 0, f"{name}_b2d")
    b3 = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name=f"{name}_pool")
    return ff.concat([b1, b2, b3], axis=1, name=f"{name}_cat")


def _inception_e(ff, t, name):
    b1 = _conv_bn(ff, t, 320, 1, 1, 1, 1, 0, 0, f"{name}_b1")
    b2 = _conv_bn(ff, t, 384, 1, 1, 1, 1, 0, 0, f"{name}_b2a")
    b2a = _conv_bn(ff, b2, 384, 1, 3, 1, 1, 0, 1, f"{name}_b2b1")
    b2b = _conv_bn(ff, b2, 384, 3, 1, 1, 1, 1, 0, f"{name}_b2b2")
    b2 = ff.concat([b2a, b2b], axis=1, name=f"{name}_b2cat")
    b3 = _conv_bn(ff, t, 448, 1, 1, 1, 1, 0, 0, f"{name}_b3a")
    b3 = _conv_bn(ff, b3, 384, 3, 3, 1, 1, 1, 1, f"{name}_b3b")
    b3a = _conv_bn(ff, b3, 384, 1, 3, 1, 1, 0, 1, f"{name}_b3c1")
    b3b = _conv_bn(ff, b3, 384, 3, 1, 1, 1, 1, 0, f"{name}_b3c2")
    b3 = ff.concat([b3a, b3b], axis=1, name=f"{name}_b3cat")
    b4 = _avg_branch(ff, t, 192, name)
    return ff.concat([b1, b2, b3, b4], axis=1, name=f"{name}_cat")


def build_inception_v3(config: Optional[FFConfig] = None,
                       batch_size: int = None, num_classes: int = 10,
                       image_size: int = 299, mesh=None,
                       strategy=None, dtype=None,
                       device="cuda") -> FFModel:
    """``dtype`` is the activation dtype (bf16 activations over f32
    master weights, cast per op)."""
    cfg = config or FFConfig()
    bs = batch_size or cfg.batch_size
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)
    x = ff.create_tensor((bs, 3, image_size, image_size),
                         dtype=dtype or torch.float32, name="input")
    if image_size >= 128:
        t = _conv_bn(ff, x, 32, 3, 3, 2, 2, 0, 0, "stem1")
        t = _conv_bn(ff, t, 32, 3, 3, 1, 1, 0, 0, "stem2")
        t = _conv_bn(ff, t, 64, 3, 3, 1, 1, 1, 1, "stem3")
        t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="stem_pool1")
        t = _conv_bn(ff, t, 80, 1, 1, 1, 1, 0, 0, "stem4")
        t = _conv_bn(ff, t, 192, 3, 3, 1, 1, 0, 0, "stem5")
        t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="stem_pool2")
    else:
        # reduced stem for small images (keeps the module structure)
        t = _conv_bn(ff, x, 64, 3, 3, 1, 1, 1, 1, "stem1")
        t = _conv_bn(ff, t, 192, 3, 3, 1, 1, 1, 1, "stem2")
    t = _inception_a(ff, t, 32, "mixed0")
    t = _inception_a(ff, t, 64, "mixed1")
    t = _inception_a(ff, t, 64, "mixed2")
    t = _inception_b(ff, t, "mixed3")
    t = _inception_c(ff, t, 128, "mixed4")
    t = _inception_c(ff, t, 160, "mixed5")
    t = _inception_c(ff, t, 160, "mixed6")
    t = _inception_c(ff, t, 192, "mixed7")
    t = _inception_d(ff, t, "mixed8")
    t = _inception_e(ff, t, "mixed9")
    t = _inception_e(ff, t, "mixed10")
    h, w = t.shape[2], t.shape[3]
    t = ff.pool2d(t, h, w, 1, 1, 0, 0, pool_type="avg", name="gap")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, num_classes, name="fc")
    ff.softmax(t, name="softmax")
    return ff
