"""Load a JAX model's weights into the port, and read an LM's shape.

The JAX initializers draw from folded ``jax.random`` keys that torch
cannot reproduce, so the two packages are held against each other on
the same WEIGHTS, not the same seed: export the ``{op: {name: array}}``
weights of a ``flexflow_tpu`` FFModel (``{op.name:
jax_ff.get_weights(op.name)}``, or its ``state.params`` as numpy) and
hand them to :func:`load_jax_params` (a compiled port FFModel of the
same graph) or :func:`from_jax_params` (a port LM built to match).
Takes plain arrays (anything ``np.asarray`` reads), so this module
never imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .config import CompMode, FFConfig
from .models.transformer import LMArch, build_transformer_lm


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


def arch_from_model(model) -> LMArch:
    """The LMArch of an FFModel, read off its GRAPH as the JAX engine's
    ``_read_arch`` does: the op names of build_transformer_lm, causal
    attention blocks, and the activation dtype the token embedding
    emits."""
    ops = {op.name: op for op in model.ops}
    for required in ("tok_embed", "pos_embed", "lm_head"):
        if required not in ops:
            raise ValueError(
                f"ServeEngine needs a build_transformer_lm-shaped model "
                f"(missing op {required!r})")
    num_layers = 0
    while f"layer{num_layers}_attn" in ops:
        num_layers += 1
    if num_layers == 0:
        raise ValueError("model has no layer{i}_attn blocks")
    attn0 = ops["layer0_attn"]
    if not attn0.causal:
        raise ValueError("serving needs causal attention blocks")
    layer_norm = "layer0_ln1" in ops
    return LMArch(vocab=ops["tok_embed"].num_entries,
                  max_positions=ops["pos_embed"].num_entries,
                  hidden=attn0.embed_dim, num_heads=attn0.num_heads,
                  head_dim=attn0.head_dim, num_layers=num_layers,
                  ff_dim=ops["layer0_ff1"].out_channels,
                  ln_eps=ops["layer0_ln1"].eps if layer_norm else 1e-5,
                  layer_norm=layer_norm,
                  dtype=ops["tok_embed"].out_dtype)


def from_jax_params(params: Mapping[str, Mapping[str, object]],
                    arch: Optional[LMArch] = None, device="cuda"):
    """A port LM (an inference-compiled FFModel of build_transformer_lm,
    batch 1) over the given weights. ``arch`` defaults to
    :func:`arch_from_params`; its ``dtype`` is the activation dtype."""
    if arch is None:
        arch = arch_from_params(params)
    ff = build_transformer_lm(
        FFConfig(batch_size=1), vocab_size=arch.vocab,
        max_seq_len=arch.max_positions, batch_size=1, hidden=arch.hidden,
        num_heads=arch.num_heads, num_layers=arch.num_layers,
        ff_dim=arch.ff_dim, dtype=arch.dtype, layer_norm=arch.layer_norm,
        device=device)
    ff.compile(comp_mode=CompMode.INFERENCE)
    load_jax_params(ff, params)
    return ff


def load_jax_params(ff, params: Mapping[str, Mapping[str, object]],
                    states: Optional[Mapping[str, Mapping[str, object]]]
                    = None) -> None:
    """Copy a ``{op: {name: array}}`` tree — e.g.
    ``{op.name: jax_ff.get_weights(op.name)}`` over a JAX FFModel's ops —
    into a compiled port ``FFModel`` through ``set_weights`` (in place:
    the tensors, and any graph captured over them, stay). The ops,
    weight names and shapes must match the port model's exactly — an
    attention op with ``add_bias_kv`` carries its ``bias_k`` and
    ``bias_v`` rows like any other weight, a ``DistributedEmbedding``
    its stacked (E, vocab, dim) kernel in table order (JAX's
    ``get_weights`` order), a ``MoEFFN`` its ``gate``, ``w1``, ``b1``,
    ``w2`` and ``b2``. ``states``, the JAX
    executor's op state as numpy (``{op: jax_ff.get_states(op)}``:
    BatchNorm's running statistics), goes in through ``set_states``
    and must name exactly the port model's stateful ops."""
    have = ff.state.params
    if set(params) != set(have):
        raise ValueError(f"ops differ: {sorted(set(params) ^ set(have))}")
    for op, ws in params.items():
        if set(ws) != set(have[op]):
            raise ValueError(f"{op}: weights {sorted(ws)} do not match "
                             f"{sorted(have[op])}")
        ff.set_weights(op, {k: np.asarray(v, np.float32)
                            for k, v in ws.items()})
    if states is None:
        return
    have = ff.state.states
    if set(states) != set(have):
        raise ValueError(f"stateful ops differ: "
                         f"{sorted(set(states) ^ set(have))}")
    for op, ss in states.items():
        ff.set_states(op, {k: np.asarray(v, np.float32)
                           for k, v in ss.items()})
