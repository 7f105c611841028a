"""Keras optimizer shims; counterpart of
``flexflow_tpu/frontends/keras/optimizers.py`` over the port's
optimizers (reference: keras optimizer translation in
base_model.compile, base_model.py:127-193)."""

from __future__ import annotations

from ...core.optimizers import AdamOptimizer, Optimizer, SGDOptimizer


def SGD(learning_rate=0.01, momentum=0.0, nesterov=False, **kw):
    return SGDOptimizer(lr=learning_rate, momentum=momentum,
                        nesterov=nesterov)


def Adam(learning_rate=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-7,
         **kw):
    return AdamOptimizer(lr=learning_rate, beta1=beta_1, beta2=beta_2,
                         epsilon=epsilon)


def resolve(opt) -> Optimizer:
    if isinstance(opt, Optimizer):
        return opt
    if isinstance(opt, str):
        name = opt.lower()
        if name == "sgd":
            return SGD()
        if name == "adam":
            return Adam()
        raise ValueError(f"unknown optimizer {opt!r}")
    raise TypeError(f"cannot resolve optimizer from {type(opt)}")
