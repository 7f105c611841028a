"""ResNet of ``flexflow_tpu/models/resnet.py``: basic blocks at depths
18 and 34, bottlenecks at 50, 101 and 152, each conv followed by
BatchNorm, with the ImageNet stem (7x7/2 conv and a 3x3/2 max pool) at
image sizes >= 64 and a 3x3 stem below, and the JAX builder's op
names."""

from __future__ import annotations

from typing import Optional

from ..config import FFConfig
from ..model import FFModel

_DEPTHS = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def _shortcut(ff, t, channels, stride, name):
    if stride != 1 or t.shape[1] != channels:
        t = ff.conv2d(t, channels, 1, 1, stride, stride, 0, 0,
                      name=f"{name}_proj")
        t = ff.batch_norm(t, relu=False, name=f"{name}_projbn")
    return t


def _basic_block(ff, t, channels, stride, name):
    u = ff.conv2d(t, channels, 3, 3, stride, stride, 1, 1,
                  name=f"{name}_conv1")
    u = ff.batch_norm(u, relu=True, name=f"{name}_bn1")
    u = ff.conv2d(u, channels, 3, 3, 1, 1, 1, 1, name=f"{name}_conv2")
    u = ff.batch_norm(u, relu=False, name=f"{name}_bn2")
    u = ff.add(u, _shortcut(ff, t, channels, stride, name),
               name=f"{name}_res")
    return ff.relu(u, name=f"{name}_out")


def _bottleneck_block(ff, t, channels, stride, name):
    u = ff.conv2d(t, channels, 1, 1, 1, 1, 0, 0, name=f"{name}_conv1")
    u = ff.batch_norm(u, relu=True, name=f"{name}_bn1")
    u = ff.conv2d(u, channels, 3, 3, stride, stride, 1, 1,
                  name=f"{name}_conv2")
    u = ff.batch_norm(u, relu=True, name=f"{name}_bn2")
    u = ff.conv2d(u, 4 * channels, 1, 1, 1, 1, 0, 0, name=f"{name}_conv3")
    u = ff.batch_norm(u, relu=False, name=f"{name}_bn3")
    u = ff.add(u, _shortcut(ff, t, 4 * channels, stride, name),
               name=f"{name}_res")
    return ff.relu(u, name=f"{name}_out")


def build_resnet(config: Optional[FFConfig] = None, depth: int = 18,
                 batch_size: int = None, num_classes: int = 10,
                 image_size: int = 32, mesh=None, strategy=None,
                 device="cuda") -> FFModel:
    """f32 input; a bf16 run sets ``config.compute_dtype`` (the
    mixed-precision policy), as the JAX builder has no dtype."""
    cfg = config or FFConfig()
    bs = batch_size or cfg.batch_size
    kind, layers = _DEPTHS[depth]
    block = _basic_block if kind == "basic" else _bottleneck_block
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)
    x = ff.create_tensor((bs, 3, image_size, image_size), name="input")
    if image_size >= 64:
        t = ff.conv2d(x, 64, 7, 7, 2, 2, 3, 3, name="stem")
        t = ff.batch_norm(t, relu=True, name="stem_bn")
        t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="stem_pool")
    else:
        t = ff.conv2d(x, 64, 3, 3, 1, 1, 1, 1, name="stem")
        t = ff.batch_norm(t, relu=True, name="stem_bn")
    channels = 64
    for stage, n_blocks in enumerate(layers):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            t = block(ff, t, channels, stride, f"s{stage}b{b}")
        channels *= 2
    # global average pool
    h, w = t.shape[2], t.shape[3]
    t = ff.pool2d(t, h, w, 1, 1, 0, 0, pool_type="avg", name="gap")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, num_classes, name="fc")
    ff.softmax(t, name="softmax")
    return ff
