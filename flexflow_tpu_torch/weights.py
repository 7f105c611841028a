"""Load a JAX model's weights into the port.

The JAX initializers draw from folded ``jax.random`` keys that torch
cannot reproduce, so the two packages are held against each other on
the same WEIGHTS, not the same seed: export ``model.state.params`` of a
``flexflow_tpu`` LM to numpy and hand it to :func:`from_jax_params`, or
the ``{op: {name: array}}`` weights of a ``flexflow_tpu`` FFModel to
:func:`load_jax_params`. Takes plain arrays (anything ``np.asarray``
reads), so this module never imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .models.transformer import LMArch, TransformerLM


def arch_from_params(params: Mapping[str, Mapping[str, object]], *,
                     dtype: torch.dtype = torch.float32) -> LMArch:
    """The LMArch of a ``{op: {name: array}}`` tree, read off its
    shapes (the op-name contract of build_transformer_lm)."""
    num_layers = 0
    while f"layer{num_layers}_attn" in params:
        num_layers += 1
    if num_layers == 0:
        raise ValueError("params have no layer{i}_attn blocks")
    vocab, hidden = np.shape(params["tok_embed"]["kernel"])
    _, num_heads, head_dim = np.shape(params["layer0_attn"]["wq"])
    return LMArch(vocab=int(vocab),
                  max_positions=int(np.shape(
                      params["pos_embed"]["kernel"])[0]),
                  hidden=int(hidden), num_heads=int(num_heads),
                  head_dim=int(head_dim), num_layers=num_layers,
                  ff_dim=int(np.shape(params["layer0_ff1"]["kernel"])[1]),
                  layer_norm="layer0_ln1" in params,
                  dtype=dtype)


def from_jax_params(params: Mapping[str, Mapping[str, object]],
                    arch: Optional[LMArch] = None,
                    device="cuda") -> TransformerLM:
    """The port's TransformerLM over the given weights (f32 copies on
    ``device``). ``arch`` defaults to :func:`arch_from_params`."""
    tree = {op: {name: np.asarray(a, np.float32) for name, a in p.items()}
            for op, p in params.items()}
    if arch is None:
        arch = arch_from_params(tree)
    return TransformerLM(arch, params=tree, device=device)


def load_jax_params(ff, params: Mapping[str, Mapping[str, object]]) -> None:
    """Copy a ``{op: {name: array}}`` tree — e.g.
    ``{op.name: jax_ff.get_weights(op.name)}`` over a JAX FFModel's ops —
    into a compiled port ``FFModel`` through ``set_weights``. The ops,
    weight names and shapes must match the port model's exactly."""
    have = ff.state.params
    if set(params) != set(have):
        raise ValueError(f"ops differ: {sorted(set(params) ^ set(have))}")
    for op, ws in params.items():
        if set(ws) != set(have[op]):
            raise ValueError(f"{op}: weights {sorted(ws)} do not match "
                             f"{sorted(have[op])}")
        ff.set_weights(op, {k: np.asarray(v, np.float32)
                            for k, v in ws.items()})
