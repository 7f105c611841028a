"""The plain reference: OPT's decoder in plain PyTorch.

Zhang et al. 2022 (arXiv:2205.01068) and ``facebook/opt-1.3b``'s
``config.json``: learned positions, pre-LayerNorm blocks
(``do_layer_norm_before``), multi-head causal attention, a ReLU FFN, a
final LayerNorm and a vocabulary head. The departures the port's
builder has, which this reference follows (listed under ``assumed`` in
the configuration files): no bias on q, k or v (the output projection
has one); an untied head with a bias; positions from 0, without OPT's
offset of 2; no dropout.

It imports nothing of the program. It computes in float32 with TF32
off (``exact()``), one row at a time, with the attention probabilities
materialized: no kernel, cache or batching. ``fp8_matmul`` puts every
matrix product's operands through float8 e4m3 with a per-tensor scale:
the control, one precision below the bfloat16 the configurations
state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tree = Dict[str, Dict[str, torch.Tensor]]


def exact() -> None:
    """float32 matrix products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def f32_matmul(a, b):
    return torch.matmul(a, b)


def _round(x, dtype, top):
    """x rounded to the float8 ``dtype`` against a per-tensor scale that
    maps its largest magnitude to the format's largest value ``top``."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


def _sum_to(g, shape):
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _Fp8Matmul(torch.autograd.Function):
    """A product in float8 as fp8 training runs it: the operands in e4m3
    (largest value 448), the gradients in e5m2 (57344), each with a
    per-tensor scale, every product accumulated in float32."""

    @staticmethod
    def forward(ctx, a, b):
        qa = _round(a, torch.float8_e4m3fn, 448.0)
        qb = _round(b, torch.float8_e4m3fn, 448.0)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = (a.shape, b.shape)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, torch.float8_e5m2, 57344.0)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        return _sum_to(ga, ctx.shapes[0]), _sum_to(gb, ctx.shapes[1])


def fp8_matmul(a, b):
    """The control's product: float8 operands and gradients
    (``_Fp8Matmul``)."""
    return _Fp8Matmul.apply(a, b)


def layer_norm(x, p, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def block(w: Tree, cfg, i: int, x, mm=f32_matmul):
    """Layer ``i`` on the (B, S, E) residual stream."""
    e, h = cfg["hidden_size"], cfg["num_attention_heads"]
    d, eps = e // h, float(cfg.get("layer_norm_eps", 1e-5))
    b, s = x.shape[0], x.shape[1]
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    a = w[f"layer{i}_attn"]
    y = layer_norm(x, w[f"layer{i}_ln1"], eps)
    q, k, v = (mm(y, a[n].reshape(e, h * d)).view(b, s, h, d)
               .transpose(1, 2) for n in ("wq", "wk", "wv"))
    scores = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    probs = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
    o = mm(probs, v).transpose(1, 2).reshape(b, s, h * d)
    x = x + mm(o, a["wo"].reshape(h * d, e)) + a["bo"]
    y = layer_norm(x, w[f"layer{i}_ln2"], eps)
    f = torch.relu(mm(y, w[f"layer{i}_ff1"]["kernel"])
                   + w[f"layer{i}_ff1"]["bias"])
    return x + mm(f, w[f"layer{i}_ff2"]["kernel"]) + w[f"layer{i}_ff2"]["bias"]


def hidden(w: Tree, cfg, tokens, mm=f32_matmul, recompute=False):
    """(B, S) token ids -> (B, S, E) residual stream before the final
    LayerNorm. ``recompute`` keeps only each layer's input for the
    backward and computes the layer again there (the same arithmetic:
    no dropout), so a training step's reference fits beside its
    optimizer state."""
    s = tokens.shape[1]
    pos = torch.arange(s, device=tokens.device)
    x = w["tok_embed"]["kernel"][tokens] + w["pos_embed"]["kernel"][pos]
    for i in range(cfg["num_hidden_layers"]):
        if recompute:
            x = checkpoint(block, w, cfg, i, x, mm, use_reentrant=False)
        else:
            x = block(w, cfg, i, x, mm)
    return x


def head(w: Tree, cfg, x, mm=f32_matmul):
    eps = float(cfg.get("layer_norm_eps", 1e-5))
    y = layer_norm(x, w["final_ln"], eps)
    return mm(y, w["lm_head"]["kernel"]) + w["lm_head"]["bias"]


@torch.no_grad()
def served_gaps(w: Tree, cfg, prompt: Sequence[int], served: Sequence[int],
                mm=f32_matmul):
    """Per served token: how far the reference's logit of that token lies
    below the reference's best at its position (the float32 forward over
    the prompt and the served tokens). With ``mm`` another product (the
    control's lower precision), also the gaps of the tokens that a
    forward in it puts first at the same positions. Returns (gaps of the served tokens, gaps of the tokens ``mm`` puts
    first), both as float lists."""
    dev = w["tok_embed"]["kernel"].device
    seq = list(prompt) + list(served[:-1])
    toks = torch.tensor([seq], dtype=torch.long, device=dev)
    at = torch.arange(len(prompt) - 1, len(seq), device=dev)
    want = torch.tensor(list(served), dtype=torch.long, device=dev)
    ref = head(w, cfg, hidden(w, cfg, toks)[0, at])
    best = ref.max(dim=-1).values
    gaps = best - ref.gather(1, want[:, None])[:, 0]
    if mm is f32_matmul:
        first = ref.argmax(dim=-1)
    else:
        low = head(w, cfg, hidden(w, cfg, toks, mm)[0, at], mm)
        first = low.argmax(dim=-1)
    low_gaps = best - ref.gather(1, first[:, None])[:, 0]
    return gaps.tolist(), low_gaps.tolist()


@torch.no_grad()
def losses_at(w: Tree, cfg, batches: List[tuple]) -> List[float]:
    """Each batch's mean cross-entropy at the weights ``w``, one row at
    a time: the losses of steps that leave their state unchanged (a
    planted fault)."""
    out = []
    for tokens, labels in batches:
        total = 0.0
        for r in range(tokens.shape[0]):
            logits = head(w, cfg, hidden(w, cfg, tokens[r:r + 1]))
            total += float(F.cross_entropy(
                logits.reshape(-1, logits.shape[-1]),
                labels[r].reshape(-1).long(), reduction="sum"))
            del logits
        out.append(total / labels.numel())
    return out


def train(w0: Tree, cfg, opt, batches: List[tuple], mm=f32_matmul,
          half_batch: bool = False):
    """``len(batches)`` Adam steps from the weights ``w0`` (left as they
    are) on [(tokens (B, S), labels (B, S))]: the loss is the mean
    cross-entropy over every position, accumulated one row at a time.
    ``opt``: {"lr", "beta1", "beta2", "eps"}. ``half_batch`` leaves the
    second half of each batch out (a planted fault: the mean over the
    rest). Returns (losses, gradient norms of step 1 by leaf, the
    weights after the last step)."""
    lr, b1, b2, eps = (float(opt[k]) for k in ("lr", "beta1", "beta2",
                                                "eps"))
    leaves = [(op, n) for op in w0 for n in w0[op]]
    w = {op: {n: t.detach().clone().requires_grad_(True)
              for n, t in ws.items()} for op, ws in w0.items()}
    m = {k: torch.zeros_like(w[k[0]][k[1]]) for k in leaves}
    v = {k: torch.zeros_like(w[k[0]][k[1]]) for k in leaves}
    losses, grad_norms = [], None
    for t, (tokens, labels) in enumerate(batches, start=1):
        rows = tokens.shape[0] // 2 if half_batch else tokens.shape[0]
        count = rows * tokens.shape[1]
        total = 0.0
        for r in range(rows):
            logits = head(w, cfg, hidden(w, cfg, tokens[r:r + 1], mm,
                                             recompute=True), mm)
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   labels[r].reshape(-1).long(),
                                   reduction="sum") / count
            loss.backward()
            total += float(loss.detach())
            del logits, loss
        losses.append(total)
        with torch.no_grad():
            if grad_norms is None:
                grad_norms = {k: float(w[k[0]][k[1]].grad.norm())
                              for k in leaves}
            alpha = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
            for k in leaves:
                p = w[k[0]][k[1]]
                g = p.grad
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                p.sub_(alpha * m[k] / (v[k].sqrt() + eps))
                p.grad = None
    final = {op: {n: t.detach() for n, t in ws.items()}
             for op, ws in w.items()}
    return losses, grad_norms, final
