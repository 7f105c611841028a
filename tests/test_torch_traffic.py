"""The port's traffic harness (flexflow_tpu_torch/serve/traffic.py)
against the JAX package's: the same spec gives the same stream, request
for request — arrivals, tenants, prompts, budgets, sampling and
cancels — under Poisson and bursty arrivals; the tenant prefixes, the
arrival rescale and the spec validation are JAX's."""

import dataclasses

import pytest
import torch

from flexflow_tpu.serve import traffic as jtraffic

from flexflow_tpu_torch.serve import traffic as ttraffic


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


SPECS = {
    "poisson": dict(requests=40, seed=0),
    "bursty": dict(requests=48, seed=3, arrival="bursty",
                   rate_rps=50.0, burst_factor=6.0, tenants=5,
                   prefix_tokens=40, max_prompt=64, output_mean=8.0,
                   max_new_cap=12, vocab=61),
    "cancels_and_sampling": dict(requests=32, seed=8, cancel_frac=0.25,
                                 sample_frac=0.3, tenants=4,
                                 rate_rps=3000.0, vocab=89),
    "router_smoke": dict(requests=64, seed=0, tenants=4,
                         prefix_tokens=48, vocab=32000, max_prompt=96,
                         rate_rps=123.4),
}


def _both(name):
    kw = SPECS[name]
    return (jtraffic.make_traffic(jtraffic.TrafficSpec(**kw)),
            ttraffic.make_traffic(ttraffic.TrafficSpec(**kw)))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_same_spec_same_stream(name):
    jt, tt = _both(name)
    assert [dataclasses.asdict(r) for r in tt] == \
        [dataclasses.asdict(r) for r in jt]
    assert [r.sampled for r in tt] == [r.sampled for r in jt]
    # arrivals sorted, stream ids in arrival order, lengths admissible
    spec = ttraffic.TrafficSpec(**SPECS[name])
    assert [r.stream_id for r in tt] == list(range(spec.requests))
    assert all(a.t_arrival <= b.t_arrival for a, b in zip(tt, tt[1:]))
    assert all(len(r.prompt) <= spec.max_prompt
               and 1 <= r.max_new <= spec.max_new_cap for r in tt)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_tenant_prefixes_and_rescale(name):
    kw = SPECS[name]
    js, ts = jtraffic.TrafficSpec(**kw), ttraffic.TrafficSpec(**kw)
    assert ttraffic.tenant_prefixes(ts) == jtraffic.tenant_prefixes(js)
    jt, tt = _both(name)
    for scale in (0.25, 3.0):
        fast = ttraffic.rescale_arrivals(tt, scale)
        assert [dataclasses.asdict(r) for r in fast] == \
            [dataclasses.asdict(r) for r in
             jtraffic.rescale_arrivals(jt, scale)]
        assert fast[0] is not tt[0]
    with pytest.raises(ValueError, match="scale"):
        ttraffic.rescale_arrivals(tt, 0.0)


@pytest.mark.parametrize("bad", [
    dict(requests=0), dict(arrival="uniform"), dict(rate_rps=0.0),
    dict(tenants=0), dict(cancel_frac=1.5), dict(sample_frac=-0.1),
    dict(prefix_tokens=96, max_prompt=96)])
def test_spec_validation_as_jax(bad):
    for mod in (jtraffic, ttraffic):
        with pytest.raises(ValueError):
            mod.make_traffic(mod.TrafficSpec(**bad))
