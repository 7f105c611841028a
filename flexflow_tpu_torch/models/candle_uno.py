"""CANDLE-Uno of ``flexflow_tpu/models/candle_uno.py``: one dense tower
per wide input feature, the towers and the narrow inputs concatenated,
then a deep MLP regression head (MSE loss), with the JAX builder's op
names."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..config import FFConfig
from ..model import FFModel

DEFAULT_FEATURE_SHAPES = {
    "dose1": 1,
    "cell_rnaseq": 942,
    "drug1_descriptors": 5270,
    "drug1_fingerprints": 2048,
}


def build_candle_uno(config: Optional[FFConfig] = None,
                     batch_size: int = None,
                     feature_shapes: Optional[Dict[str, int]] = None,
                     tower_layers: Sequence[int] = (1000, 1000, 1000),
                     final_layers: Sequence[int] = (1000, 1000, 1000, 1000),
                     mesh=None, strategy=None, device="cuda") -> FFModel:
    cfg = config or FFConfig()
    bs = batch_size or cfg.batch_size
    feats = feature_shapes or DEFAULT_FEATURE_SHAPES
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)
    towers = []
    for name, dim in feats.items():
        t = ff.create_tensor((bs, dim), name=name)
        if dim > 1:  # feature towers only for wide inputs
            for i, width in enumerate(tower_layers):
                t = ff.dense(t, width, activation="relu",
                             name=f"{name}_tower_{i}")
        towers.append(t)
    t = ff.concat(towers, axis=1, name="concat_features")
    for i, width in enumerate(final_layers):
        t = ff.dense(t, width, activation="relu", name=f"final_{i}")
    ff.dense(t, 1, name="growth_out")  # regression (MSE loss)
    return ff
