"""ResNet-50 and Inception-v3 at batch 2 trained in both packages on
the CPU, held against JAX's one-ulp witness, with the planted faults
that those limits must reject (see test_torch_conv_models.py's
docstring), in a module of their own so that they run beside it."""

import pytest
import torch
from test_torch_conv_models import DEEP, FAULTS, planted_fault_rejected, \
    train_pair
from test_torch_conv_models import test_forward_after_training as _fwd
from test_torch_conv_models import test_trajectory_losses as _losses
from test_torch_conv_models import \
    test_trajectory_running_stats as _stats
from test_torch_conv_models import test_trajectory_weights as _weights


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The port's CPU computations here run at test shapes, and beside
    other test workers on one host each worker's intra-op thread pool
    oversubscribes the cores (a serving case that takes 2 s alone took
    25 s beside two other workers). One thread for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(DEEP))
def trained(request):
    return train_pair(request.param)


def test_deep_trajectory_losses(trained):
    _losses(trained)


def test_deep_trajectory_weights(trained):
    _weights(trained)


def test_deep_trajectory_running_stats(trained):
    _stats(trained)


def test_deep_forward_after_training(trained):
    _fwd(trained)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_deep_planted_fault_rejected(trained, fault, monkeypatch):
    planted_fault_rejected(trained, fault, monkeypatch)
