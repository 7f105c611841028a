"""The transformers of ``flexflow_tpu/models/transformer.py``.

``build_transformer`` — the training flagship, the encoder classifier
— and ``build_transformer_lm`` — the causal LM — return the port's
``FFModel`` with the JAX functions' graphs and op names
(``layer{i}_attn``, ``layer{i}_ff1``, ``cls_head``, ``lm_head``, ...).
The LM's op names are the contract the serving engine reads weights
through, kept in the JAX layouts:

    tok_embed / pos_embed   {"kernel": (V, E) / (max_positions, E)}
    layer{i}_ln1, _ln2      {"scale": (E,), "bias": (E,)}
    layer{i}_attn           {"wq"/"wk"/"wv": (E, H, D), "wo": (H, D, E),
                             "bo": (E,) when present}
    layer{i}_ff1, _ff2      {"kernel": (in, out), "bias": (out,)}
    final_ln                {"scale", "bias"}
    lm_head                 {"kernel": (E, V), "bias": (V,)}

``TransformerLM`` is the serving engine's view of such a model: the
block math over the model's LIVE parameter tensors (a training step is
served without a reload). It mirrors the JAX serving engine's pure
functions (serve/engine.py ``_ln``, ``_dense``, ``_embed``,
``_attn_qkv``, ``_attn_out``, ``_ffn``, ``_head``): LayerNorm statistics
in f32, matmuls in the activation dtype, attention probabilities kept
in f32 through the p.v product.

``ShardedLM`` is the same block math on one rank of a tensor-parallel
serving group (the JAX engine's ``_embed_tp``, ``_head_tp`` and the
``psum_axis`` of ``_attn_out``/``_ffn``): a vocab block of the
embedding, H/t heads of wq/wk/wv and wo, a column block of ff1, a row
block of ff2 and a vocab block of the head, with the collectives of
``parallel/collectives.py`` where JAX's shard_map body has its psums and
its one all-gather.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..config import FFConfig
from ..model import FFModel


@dataclasses.dataclass(frozen=True)
class LMArch:
    """Shape of a served LM (what the JAX engine's ``_read_arch`` reads
    off the graph)."""

    vocab: int
    max_positions: int
    hidden: int
    num_heads: int
    head_dim: int
    num_layers: int
    ff_dim: int
    ln_eps: float = 1e-5
    layer_norm: bool = True
    dtype: torch.dtype = torch.float32   # activation dtype

    def param_shapes(self) -> Dict[str, Dict[str, tuple]]:
        e, h, d = self.hidden, self.num_heads, self.head_dim
        ln = {"scale": (e,), "bias": (e,)}
        out = {"tok_embed": {"kernel": (self.vocab, e)},
               "pos_embed": {"kernel": (self.max_positions, e)}}
        for i in range(self.num_layers):
            if self.layer_norm:
                out[f"layer{i}_ln1"] = dict(ln)
                out[f"layer{i}_ln2"] = dict(ln)
            out[f"layer{i}_attn"] = {"wq": (e, h, d), "wk": (e, h, d),
                                     "wv": (e, h, d), "wo": (h, d, e),
                                     "bo": (e,)}
            out[f"layer{i}_ff1"] = {"kernel": (e, self.ff_dim),
                                    "bias": (self.ff_dim,)}
            out[f"layer{i}_ff2"] = {"kernel": (self.ff_dim, e),
                                    "bias": (e,)}
        if self.layer_norm:
            out["final_ln"] = dict(ln)
        out["lm_head"] = {"kernel": (e, self.vocab), "bias": (self.vocab,)}
        return out


def layer_norm(p, x, eps):
    """LayerNorm with f32 statistics (population variance, as
    ``jnp.var``), cast back to the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def dense(p, x, activation=None):
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    if activation == "relu":
        y = torch.relu(y)
    return y


def causal_attention(q, k, v, scale):
    """softmax(q.k^T * scale) . v over (B, S, H, D), causal, in f32;
    returns f32 (B, S, H, D)."""
    s = q.shape[1]
    logits = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~causal, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhij,bjhd->bihd", probs, v.float())


class TransformerLM:
    """The LM's block math over ``params``, an ``{op: {name: tensor}}``
    tree with ``arch``'s shapes — the live ``model.state.params`` of an
    FFModel from :func:`build_transformer_lm` (see
    :func:`flexflow_tpu_torch.weights.arch_from_model`), not copies:
    the engine serves whatever the model holds now. Weights may be
    stored at any float dtype; each block casts them to the activation
    dtype."""

    def __init__(self, arch: LMArch, params):
        want = arch.param_shapes()
        if set(params) != set(want):
            raise ValueError(
                f"params ops {sorted(set(params) ^ set(want))} do not "
                f"match the architecture")
        for op, shapes in want.items():
            for name, t in params[op].items():
                if name not in shapes or tuple(t.shape) != shapes[name]:
                    raise ValueError(
                        f"{op}.{name}: shape {tuple(t.shape)} does not "
                        f"match {shapes.get(name)}")
        self.arch = arch
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.params["tok_embed"]["kernel"].device

    def embed(self, tokens, positions):
        """Token + position embeddings. Indices clamp into the tables
        first (the JAX engine's ``jnp.take(..., mode="clip")``): padded
        lanes may carry positions past the learned table, and torch
        indexing raises on the CPU and is undefined on CUDA for an index
        out of range. Every in-range index reads exactly its row."""
        te = self.params["tok_embed"]["kernel"]
        pe = self.params["pos_embed"]["kernel"]
        t = te[tokens.long().clamp(0, te.shape[0] - 1)]
        p = pe[positions.long().clamp(0, pe.shape[0] - 1)]
        return (t + p).to(self.arch.dtype)

    def attn_in(self, i, x):
        if not self.arch.layer_norm:
            return x
        return layer_norm(self.params[f"layer{i}_ln1"], x, self.arch.ln_eps)

    def attn_qkv(self, i, h, lora=None):
        """h (..., E) -> q, k, v (..., H, D). ``lora`` (the mixed step
        only, h (T, E)) is the lanes' gathered adapter rows of layer i,
        (a_qkv (T, 3, E, r), b_qkv (T, 3, r, H, D), scale (T,)): each
        lane adds its tenant's low-rank delta, u = h.A, d = u.B, d *
        scale (the JAX engine's order); lanes of slot 0 gather the zero
        slab and add exactly 0.0."""
        p = self.params[f"layer{i}_attn"]
        q, k, v = (torch.einsum("...e,ehd->...hd", h, p[w].to(h.dtype))
                   for w in ("wq", "wk", "wv"))
        if lora is not None:
            a, b, s = lora
            u = torch.einsum("te,tjer->tjr", h, a.to(h.dtype))
            d = torch.einsum("tjr,tjrhd->tjhd", u, b.to(h.dtype))
            d = d * s.to(h.dtype)[:, None, None, None]
            q, k, v = q + d[:, 0], k + d[:, 1], v + d[:, 2]
        return q, k, v

    def _reduce(self, y):
        """The sum of a row-parallel projection's partial outputs over
        the tensor group: nothing to sum on one device."""
        return y

    def _gather_cols(self, y):
        """The logits' column blocks of the tensor group, concatenated:
        one device holds them all."""
        return y

    def attn_out(self, i, o, x, lora=None):
        """The output projection and residual; ``lora`` = (a_wo (T, H,
        D, r), b_wo (T, r, E), scale (T,)) adds each lane's delta
        before the bias."""
        p = self.params[f"layer{i}_attn"]
        y = torch.einsum("...hd,hde->...e", o, p["wo"].to(o.dtype))
        if lora is not None:
            a, b, s = lora
            u = torch.einsum("thd,thdr->tr", o, a.to(o.dtype))
            y = y + torch.einsum("tr,tre->te", u, b.to(o.dtype)) \
                * s.to(o.dtype)[:, None]
        y = self._reduce(y)
        if "bo" in p:
            y = y + p["bo"].to(y.dtype)
        return x + y

    def ffn(self, i, x, lora=None):
        """The FFN block and residual. ``lora`` = (a_ff1, b_ff1, a_ff2,
        b_ff2, scale) adds ff1's delta BEFORE the activation (the
        merged reference folds A.B into the kernel relu then sees) and
        ff2's before its bias."""
        h = layer_norm(self.params[f"layer{i}_ln2"], x, self.arch.ln_eps) \
            if self.arch.layer_norm else x
        if lora is None:
            h = dense(self.params[f"layer{i}_ff1"], h, activation="relu")
            p2 = self.params[f"layer{i}_ff2"]
            y = self._reduce(torch.matmul(h, p2["kernel"].to(h.dtype)))
            if "bias" in p2:
                y = y + p2["bias"].to(y.dtype)
            return x + y
        a1, b1, a2, b2, s = lora
        s = s.to(h.dtype)[:, None]
        p1 = self.params[f"layer{i}_ff1"]
        z = torch.matmul(h, p1["kernel"].to(h.dtype))
        u1 = torch.einsum("te,ter->tr", h, a1.to(h.dtype))
        z = z + torch.einsum("tr,trf->tf", u1, b1.to(h.dtype)) * s
        if "bias" in p1:
            z = z + p1["bias"].to(z.dtype)
        h2 = torch.relu(z)
        p2 = self.params[f"layer{i}_ff2"]
        y = torch.matmul(h2, p2["kernel"].to(h2.dtype))
        u2 = torch.einsum("tf,tfr->tr", h2, a2.to(h2.dtype))
        y = y + torch.einsum("tr,tre->te", u2, b2.to(h2.dtype)) * s
        y = self._reduce(y)
        if "bias" in p2:
            y = y + p2["bias"].to(y.dtype)
        return x + y

    def head(self, x):
        if self.arch.layer_norm:
            x = layer_norm(self.params["final_ln"], x, self.arch.ln_eps)
        return self._gather_cols(dense(self.params["lm_head"], x))

    def hidden_states(self, tokens, on_kv=None):
        """Causal no-cache forward of (B, S) tokens up to the final
        LayerNorm's input: (B, S, E). ``on_kv(i, k, v)``, when given,
        sees each layer's (B, S, H, D) keys and values (the serving
        engine's legacy prefill scatters them into its pages)."""
        s = tokens.shape[1]
        positions = torch.arange(s, device=tokens.device)[None, :]
        x = self.embed(tokens, positions)
        scale = 1.0 / math.sqrt(self.arch.head_dim)
        for i in range(self.arch.num_layers):
            q, k, v = self.attn_qkv(i, self.attn_in(i, x))
            if on_kv is not None:
                on_kv(i, k, v)
            o = causal_attention(q, k, v, scale).to(x.dtype)
            x = self.attn_out(i, o, x)
            x = self.ffn(i, x)
        return x


class ShardedLM(TransformerLM):
    """:class:`TransformerLM`'s block math on one rank of the ``axis``
    group of the bound mesh ``bm``, over ``shards``: the rank's blocks
    of the parameters in the layouts of the JAX engine's
    ``_shard_params`` (built by the serving engine; ff and vocab padded
    to a multiple of the degree, the head's pad columns biased -1e30).
    The one-device order of operations is kept, with the collectives
    where JAX's shard_map body has them, so f32 serving stays exact:

    - the embedding gathers the rows this rank owns (indices clamped in
      range, the rest masked to exact 0.0) and all-reduces, which is
      exact: each row has one owner;
    - q, k, v are the rank's heads (their LoRA deltas too), attention
      and the pages are per head;
    - wo contracts the rank's heads, its LoRA delta a local partial,
      then the all-reduce, then ``bo``;
    - ff1 is the rank's columns (bias, ReLU), ff2 contracts them, then
      the all-reduce, then ff2's bias — never the bias before the sum;
    - the final LayerNorm, the rank's logit columns, and one all-gather
      of them on dim 1.

    Runs under ``no_grad`` (the collectives are the plain forms)."""

    def __init__(self, arch: LMArch, shards, bm, axis: str):
        self.arch = arch
        self.params = shards
        self.bm = bm
        self.axis = axis
        rows = shards["tok_embed"]["kernel"].shape[0]
        self._vocab_rows = rows
        self._vocab_lo = bm.coord(axis) * rows

    def embed(self, tokens, positions):
        from ..parallel.collectives import all_reduce_
        te = self.params["tok_embed"]["kernel"]
        pe = self.params["pos_embed"]["kernel"]
        idx = tokens.long() - self._vocab_lo
        own = (idx >= 0) & (idx < self._vocab_rows)
        t = te[idx.clamp(0, self._vocab_rows - 1)]
        t = torch.where(own[..., None], t, torch.zeros((), dtype=t.dtype,
                                                       device=t.device))
        all_reduce_(t, self.bm, self.axis)
        p = pe[positions.long().clamp(0, pe.shape[0] - 1)]
        return (t + p).to(self.arch.dtype)

    def _reduce(self, y):
        from ..parallel.collectives import all_reduce_
        y = y.contiguous()
        all_reduce_(y, self.bm, self.axis)
        return y

    def _gather_cols(self, y):
        from ..parallel.collectives import gather_tensor
        return gather_tensor(y, self.bm, self.axis, dim=y.dim() - 1)


def build_transformer_lm(config: Optional[FFConfig] = None,
                         vocab_size: int = 256, max_seq_len: int = 128,
                         batch_size: Optional[int] = None, hidden: int = 256,
                         num_heads: int = 4, num_layers: int = 2,
                         ff_dim: int = 512, dtype=None,
                         mesh=None, strategy=None,
                         layer_norm: bool = True, device="cuda") -> FFModel:
    """Causal decoder LM, the JAX builder's graph: token +
    learned-position embeddings (inputs ``tokens`` and ``positions``,
    (batch, max_seq_len) int32), pre-LN causal-attention blocks, a final
    LN and an untied vocab head ending in logits. ``dtype`` is the
    embeddings' output dtype, the activation dtype the engine serves in;
    it follows ``config.compute_dtype`` by default. Trains through the
    ordinary executor (weights from ``config.seed``'s numpy streams at
    ``compile``); ``ServeEngine`` serves the same parameter tensors."""
    cfg = config or FFConfig()
    if dtype is None:
        dtype = cfg.compute_dtype
    bs = batch_size or cfg.batch_size
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)
    tokens = ff.create_tensor((bs, max_seq_len), dtype=torch.int32,
                              name="tokens")
    positions = ff.create_tensor((bs, max_seq_len), dtype=torch.int32,
                                 name="positions")
    te = ff.embedding(tokens, vocab_size, hidden, aggr="none",
                      name="tok_embed", dtype=dtype)
    pe = ff.embedding(positions, max_seq_len, hidden, aggr="none",
                      name="pos_embed", dtype=dtype)
    t = ff.add(te, pe, name="embed_add")
    for i in range(num_layers):
        a_in = ff.layer_norm(t, name=f"layer{i}_ln1") if layer_norm else t
        a = ff.multihead_attention(a_in, a_in, a_in, hidden, num_heads,
                                   causal=True, name=f"layer{i}_attn")
        t = ff.add(a, t, name=f"layer{i}_res1")
        f_in = ff.layer_norm(t, name=f"layer{i}_ln2") if layer_norm else t
        h = ff.dense(f_in, ff_dim, activation="relu", name=f"layer{i}_ff1")
        h = ff.dense(h, hidden, name=f"layer{i}_ff2")
        t = ff.add(h, t, name=f"layer{i}_res2")
    if layer_norm:
        t = ff.layer_norm(t, name="final_ln")
    ff.dense(t, vocab_size, name="lm_head")
    return ff


def build_transformer(config: Optional[FFConfig] = None,
                      batch_size: Optional[int] = None, seq_len: int = 128,
                      hidden: int = 512, num_heads: int = 8,
                      num_layers: int = 6, ff_dim: int = 2048,
                      num_classes: int = 10, dtype=torch.float32,
                      mesh=None, strategy=None,
                      use_flash=None, layer_norm: bool = False,
                      device="cuda") -> FFModel:
    """The Transformer encoder classifier (the reference's
    examples/cpp/Transformer): ``num_layers`` blocks of self-attention
    and a relu FFN with residual adds (pre-LN when ``layer_norm``), then
    a softmax head over the first position. ``dtype`` is the activation
    dtype (bf16 activations over f32 master weights); ``use_flash=False``
    takes the einsum attention path."""
    cfg = config or FFConfig()
    bs = batch_size or cfg.batch_size
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)
    t = ff.create_tensor((bs, seq_len, hidden), dtype=dtype, name="input")
    for i in range(num_layers):
        a_in = ff.layer_norm(t, name=f"layer{i}_ln1") if layer_norm else t
        a = ff.multihead_attention(a_in, a_in, a_in, hidden, num_heads,
                                   use_flash=use_flash,
                                   name=f"layer{i}_attn")
        t = ff.add(a, t, name=f"layer{i}_res1")
        f_in = ff.layer_norm(t, name=f"layer{i}_ln2") if layer_norm else t
        h = ff.dense(f_in, ff_dim, activation="relu",
                     name=f"layer{i}_ff1")
        h = ff.dense(h, hidden, name=f"layer{i}_ff2")
        t = ff.add(h, t, name=f"layer{i}_res2")
    # classification head over the first position
    head, _rest = ff.split(t, [1, t.shape[1] - 1], axis=1,
                           name="cls_split")
    head = ff.reshape(head, (bs, hidden), name="cls_reshape")
    logits = ff.dense(head, num_classes, name="cls_head")
    ff.softmax(logits, name="cls_softmax")
    return ff
