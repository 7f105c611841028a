"""The mixture-of-experts models of ``flexflow_tpu/models/moe.py``, with
the JAX builders' op names: ``build_moe_reference``, the composable
pipeline (gate dense, softmax, top_k, group_by, per-expert dense nets,
aggregate, softmax), and ``build_moe_fused``, a stem dense, the fused
``MoEFFN`` and a head."""

from __future__ import annotations

from typing import Optional

from ..config import FFConfig
from ..model import FFModel


def build_moe_reference(config: Optional[FFConfig] = None,
                        batch_size: int = None, input_dim: int = 784,
                        num_classes: int = 10, num_experts: int = 4,
                        k: int = 2, alpha: float = 2.0,
                        expert_hidden: int = 64, mesh=None, strategy=None,
                        device="cuda") -> FFModel:
    cfg = config or FFConfig()
    bs = batch_size or cfg.batch_size
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)
    x = ff.create_tensor((bs, input_dim), name="input")
    gate = ff.dense(x, num_experts, name="gate_dense")
    gate = ff.softmax(gate, name="gate_softmax")
    gate_vals, gate_assign = ff.top_k(gate, k, name="gate_topk")
    expert_inputs = ff.group_by(x, gate_assign, num_experts, alpha,
                                name="group_by")
    preds = []
    for i, einp in enumerate(expert_inputs):
        h = ff.dense(einp, expert_hidden, activation="relu",
                     name=f"expert{i}_fc1")
        preds.append(ff.dense(h, num_classes, name=f"expert{i}_fc2"))
    out = ff.aggregate(gate_vals, gate_assign, preds, num_experts,
                       name="aggregate")
    ff.softmax(out, name="softmax")
    return ff


def build_moe_fused(config: Optional[FFConfig] = None,
                    batch_size: int = None, input_dim: int = 784,
                    num_classes: int = 10, num_experts: int = 8, k: int = 2,
                    expert_hidden: int = 128, mesh=None, strategy=None,
                    device="cuda") -> FFModel:
    cfg = config or FFConfig()
    bs = batch_size or cfg.batch_size
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)
    x = ff.create_tensor((bs, input_dim), name="input")
    t = ff.dense(x, 256, activation="relu", name="stem")
    t = ff.moe_ffn(t, num_experts=num_experts, k=k,
                   hidden_dim=expert_hidden, capacity_factor=2.0,
                   name="moe")
    t = ff.dense(t, num_classes, name="head")
    ff.softmax(t, name="softmax")
    return ff
