"""Weights from ``--seed``, made on the device, in the port's layout.

The benchmark makes the OPT weights itself and hands the same values
to the program (copied into its parameter tensors) and to the plain
reference. The layout is the port's public one for
``build_transformer_lm`` (op and weight names, shapes):

    tok_embed / pos_embed  {"kernel": (V, E) / (P, E)}
    layer{i}_ln1, _ln2     {"scale": (E,), "bias": (E,)}
    layer{i}_attn          {"wq"/"wk"/"wv": (E, H, D), "wo": (H, D, E),
                            "bo": (E,)}
    layer{i}_ff1, _ff2     {"kernel": (in, out), "bias": (out,)}
    final_ln               {"scale", "bias"}
    lm_head                {"kernel": (E, V), "bias": (V,)}

Each group of ops (the embeddings, each layer, the head) is one
``torch.randn`` call on a generator seeded from (seed, group): 26 calls
for OPT-1.3B. Every value is ``init_std * z``, a LayerNorm scale
``1 + init_std * z``: OPT's initializer (std 0.02), with its zero
biases and unit scales drawn too so that every term of the block
reaches the comparison.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def opt_layout(cfg) -> List[List[Tuple[str, str, tuple]]]:
    """The leaves, group by group, in a fixed order: [[(op, name,
    shape), ...], ...]."""
    e, h = cfg["hidden_size"], cfg["num_attention_heads"]
    d, f, v = e // h, cfg["ffn_dim"], cfg["vocab_size"]
    p = cfg["max_position_embeddings"]
    groups = [[("tok_embed", "kernel", (v, e)),
               ("pos_embed", "kernel", (p, e))]]
    for i in range(cfg["num_hidden_layers"]):
        groups.append([
            (f"layer{i}_ln1", "scale", (e,)), (f"layer{i}_ln1", "bias", (e,)),
            (f"layer{i}_attn", "wq", (e, h, d)),
            (f"layer{i}_attn", "wk", (e, h, d)),
            (f"layer{i}_attn", "wv", (e, h, d)),
            (f"layer{i}_attn", "wo", (h, d, e)),
            (f"layer{i}_attn", "bo", (e,)),
            (f"layer{i}_ln2", "scale", (e,)), (f"layer{i}_ln2", "bias", (e,)),
            (f"layer{i}_ff1", "kernel", (e, f)),
            (f"layer{i}_ff1", "bias", (f,)),
            (f"layer{i}_ff2", "kernel", (f, e)),
            (f"layer{i}_ff2", "bias", (e,))])
    groups.append([("final_ln", "scale", (e,)), ("final_ln", "bias", (e,)),
                   ("lm_head", "kernel", (e, v)), ("lm_head", "bias", (v,))])
    return groups


def _group_seed(seed: int, group: int) -> int:
    """A 63-bit generator seed from (seed, group); any whole seed."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), group])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def groups(cfg, seed: int, device) -> Iterator[List[tuple]]:
    """Each group's leaves as [(op, name, f32 tensor on ``device``)]."""
    std = float(cfg.get("init_std", 0.02))
    for gi, leaves in enumerate(opt_layout(cfg)):
        n = sum(int(np.prod(s)) for _, _, s in leaves)
        gen = torch.Generator(device=device)
        gen.manual_seed(_group_seed(seed, gi))
        z = torch.randn(n, generator=gen, device=device,
                        dtype=torch.float32)
        z.mul_(std)
        out, off = [], 0
        for op, name, shape in leaves:
            k = int(np.prod(shape))
            t = z[off:off + k].view(shape)
            if name == "scale":
                t = t + 1.0
            out.append((op, name, t))
            off += k
        yield out


def load_into(params: Tree, cfg, seed: int) -> int:
    """Copy the seed's weights into the program's parameter tensors
    ``params`` ({op: {name: tensor}}) in place, each at its own dtype.
    Raises on any leaf the layout and the program disagree on. Returns
    the number of values written."""
    want = {(op, name) for g in opt_layout(cfg) for op, name, _ in g}
    have = {(op, name) for op, ws in params.items() for name in ws}
    if want != have:
        raise ValueError(f"the program's parameters differ from the OPT "
                         f"layout: {sorted(want ^ have)[:8]}")
    device = next(iter(next(iter(params.values())).values())).device
    n = 0
    with torch.no_grad():
        for leaves in groups(cfg, seed, device):
            for op, name, t in leaves:
                dst = params[op][name]
                if tuple(dst.shape) != tuple(t.shape):
                    raise ValueError(f"{op}.{name}: the program holds "
                                     f"{tuple(dst.shape)}, the layout "
                                     f"{tuple(t.shape)}")
                dst.copy_(t)
                n += t.numel()
    return n


def make_tree(cfg, seed: int, device, stored_dtype=torch.float32) -> Tree:
    """The seed's weights as the program stores them (rounded to
    ``stored_dtype``), returned in f32: what the reference computes
    with."""
    tree: Tree = {}
    for leaves in groups(cfg, seed, device):
        for op, name, t in leaves:
            tree.setdefault(op, {})[name] = \
                t.to(stored_dtype).to(torch.float32)
    return tree
