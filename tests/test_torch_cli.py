"""The port's command line against the JAX package's: ``FFConfig``'s
flags (JAX's three tables and ``--seq-length``) set the same fields to
the same values in both packages, and ``python -m flexflow_tpu_torch``
runs a code string, a script, an N-rank CPU rig and a job of two
processes joined over ``--coordinator``, and refuses a partial set of
the multi-process flags as JAX's launcher does.

The two-process jobs run on the CPU (``--device cpu``), over a TCP
rendezvous on a free localhost port: the data-parallel MLP's losses
equal a one-process run's (JAX's ``tests/test_multiprocess.py``), and
a t = 2 pool of 2 replicas started from flags alone (``--serve-mesh 2
--serve-replicas 2 --wall-clock``) serves the wall-clock test's stream
with the one-device engine's tokens, both ranks keeping the same
records.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from flexflow_tpu.config import FFConfig as JConfig

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core.precision import dtype_name

import test_torch_serve_shard_jobs as J
from test_torch_serve_wall_tp import TRAFFIC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a value of each flag's type that both packages' validation accepts
VALUES = {
    "compute_dtype": "bfloat16", "param_dtype": "bfloat16",
    "conv_layout": "NHWC", "moe_dispatch": "sorted",
    "sp_attention": "ring", "pipeline_schedule": "1f1b",
    "pipeline_virtual_stages": "1", "kv_dtype": "int8",
    "serve_mesh": "2", "serve_disagg_ratio": "1:2",
    "router_policy": "round_robin", "serve_transport": "tcp",
    "fault_spec": "serve.mixed:transient@2", "serve_replicas": "auto",
}
TYPED = {int: "3", float: "0.5", str: "/tmp/ff_flag_value"}


def _value(field, typ):
    return VALUES.get(field, TYPED.get(typ, "2"))


def _same(a, b):
    """Field values compared across the packages (dtypes by name)."""
    if hasattr(a, "itemsize") or "dtype" in type(a).__name__.lower():
        return dtype_name(b) == np.dtype(a).name
    return a == b


def test_flag_tables_are_jax_tables():
    """Each table names JAX's flags, each for the same field, with a
    value parser of the same name."""
    T = ft.FFConfig
    assert {k: (f, t.__name__) for k, (f, t) in T._FLAG_MAP.items()} == \
        {k: (f, t.__name__) for k, (f, t) in JConfig._FLAG_MAP.items()}
    assert T._BOOL_FLAGS == JConfig._BOOL_FLAGS
    assert T._NEG_BOOL_FLAGS == JConfig._NEG_BOOL_FLAGS


@pytest.mark.parametrize("flag", sorted(JConfig._FLAG_MAP))
def test_value_flag_sets_the_field_as_jax(flag):
    field, typ = JConfig._FLAG_MAP[flag]
    argv = [flag, _value(field, typ)]
    j = JConfig(batch_size=1, argv=argv)
    t = ft.FFConfig(argv=argv)
    assert _same(getattr(j, field), getattr(t, field)), (
        flag, getattr(j, field), getattr(t, field))
    assert _same(getattr(JConfig(), field), getattr(ft.FFConfig(), field))


@pytest.mark.parametrize("flag", sorted(JConfig._BOOL_FLAGS)
                         + sorted(JConfig._NEG_BOOL_FLAGS))
def test_switch_flag_sets_the_field_as_jax(flag):
    field = JConfig._BOOL_FLAGS.get(flag) or JConfig._NEG_BOOL_FLAGS[flag]
    j = JConfig(batch_size=1, argv=[flag])
    t = ft.FFConfig(argv=[flag])
    assert getattr(j, field) == getattr(t, field) \
        == (flag in JConfig._BOOL_FLAGS)


def test_seq_length_from_args_and_the_wall_clock_case(monkeypatch):
    """``--seq-length``, ``from_args`` over ``sys.argv`` (a script's own
    flags skipped), the new fields' defaults, JAX's ``--wall-clock`` /
    ``--transport`` case, and the device properties of one process."""
    argv = ["--seq-length", "12", "--my-own-flag", "-b", "7",
            "--serve-replicas", "3"]
    assert ft.FFConfig(argv=argv).iter_config.seq_length == \
        JConfig(argv=argv).iter_config.seq_length == 12
    monkeypatch.setattr(sys, "argv", ["script.py"] + argv)
    t, j = ft.FFConfig.from_args(), JConfig.from_args()
    assert (t.batch_size, t.serve_replicas) == (j.batch_size,
                                                j.serve_replicas) == (7, 3)
    for f in ("iterations", "weight_decay", "profiling", "synthetic_input",
              "log_instance_creation", "program_cache_dir"):
        assert getattr(ft.FFConfig(), f) == getattr(JConfig(), f), f
    cfg = ft.FFConfig(batch_size=1, argv=["--wall-clock", "--transport",
                                          "tcp", "--transport-port", "0"])
    assert cfg.serve_wall_clock and cfg.serve_transport == "tcp"
    assert cfg.argv is None
    with pytest.raises(ValueError, match="serve_transport"):
        ft.FFConfig(batch_size=1, serve_transport="udp")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ft.FFConfig(batch_size=1, serve_wall_clock=True,
                    serve_autoscale=True)
    with pytest.raises(ValueError, match="serve_replicas"):
        ft.FFConfig(argv=["--serve-replicas", "0"])
    assert (cfg.num_devices, cfg.num_nodes, cfg.workers_per_node) == \
        (1, 1, 1)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch", *args],
        capture_output=True, text=True, cwd=REPO, timeout=timeout,
        env=_env())


def test_launcher_code_mode_script_mode_and_help(tmp_path):
    r = _launch("-c", "import sys, flexflow_tpu_torch as ft; "
                "print('batch', ft.FFConfig.from_args().batch_size, "
                "sys.argv)", "-b", "9")
    assert r.returncode == 0, r.stderr
    assert "batch 9 ['-c', '-b', '9']" in r.stdout
    script = tmp_path / "job.py"
    script.write_text("import sys\nimport flexflow_tpu_torch as ft\n"
                      "print('script', sys.argv[1:], "
                      "ft.FFConfig.from_args().serve_wall_clock)\n")
    r = _launch(str(script), "--wall-clock", "x")
    assert r.returncode == 0, r.stderr
    assert "script ['--wall-clock', 'x'] True" in r.stdout
    r = _launch("--help")
    assert r.returncode == 0 and "--coordinator" in r.stdout


@pytest.mark.parametrize("flags", [
    ["--coordinator", "127.0.0.1:9999"],
    ["--coordinator", "127.0.0.1:9999", "--num-processes", "2"],
    ["--coordinator", "127.0.0.1:9999", "--process-id", "0"]])
def test_launcher_rejects_partial_multiprocess_flags(flags):
    """--coordinator without --num-processes and --process-id exits 2
    with JAX's launcher message, before joining anything."""
    r = _launch(*flags, "-c", "pass")
    assert r.returncode == 2, (r.returncode, r.stderr)
    assert "--num-processes" in r.stderr


def test_launcher_cpu_rig_runs_the_script_on_every_rank():
    """``--cpu-devices 2``: two gloo ranks on the CPU, each running the
    code with the script's flags; a failing rank's code is the exit
    code (it fails after a barrier: a rank gone before the group has
    formed fails its peer's join too)."""
    # one write a line: the ranks share the launcher's stdout
    r = _launch("--cpu-devices", "2", "-c",
                "import sys, torch.distributed as d\n"
                "import flexflow_tpu_torch as ft\n"
                "c = ft.FFConfig.from_args()\n"
                "sys.stdout.write(f'rank {d.get_rank()} of {c.num_devices} "
                "batch {c.batch_size}\\n')\n"
                "sys.stdout.flush()", "-b", "5")
    assert r.returncode == 0, r.stderr
    assert sorted(ln for ln in r.stdout.splitlines()
                  if ln.startswith("rank")) == [
        "rank 0 of 2 batch 5", "rank 1 of 2 batch 5"]
    r = _launch("--cpu-devices", "2", "-c",
                "import sys, torch.distributed as d\n"
                "d.barrier()\n"
                "sys.exit(3 if d.get_rank() == 1 else 0)")
    assert r.returncode == 3


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_ranks(script, *flags, timeout=180):
    """``script`` under ``--coordinator`` on two CPU processes: each
    rank's stdout."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "flexflow_tpu_torch", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(rank), "--device", "cpu", str(script), *flags],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, out[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _results(out):
    return [json.loads(ln[len("RESULT "):]) for ln in out.splitlines()
            if ln.startswith("RESULT ")]


DP_MLP = """
import json
import numpy as np
import torch
import torch.distributed as dist
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)
cfg = ft.FFConfig.from_args()          # -b: the GLOBAL batch
mesh = (make_mesh((dist.get_world_size(),), ("data",))
        if dist.is_initialized() else None)
ff = ft.FFModel(cfg, mesh=mesh, device="cpu")
x = ff.create_tensor((cfg.batch_size, 32), name="input")
ff.softmax(ff.dense(ff.dense(x, 64, activation="relu"), 4))
ff.compile(optimizer=ft.SGDOptimizer(lr=0.1),
           loss_type="sparse_categorical_crossentropy", metrics=[])
rng = np.random.RandomState(0)
xg = rng.randn(cfg.batch_size, 32).astype(np.float32)
yg = rng.randint(0, 4, cfg.batch_size).astype(np.int32)
losses = [float(ff.train_batch({"input": xg, "label": yg})["loss"])
          for _ in range(3)]
print("RESULT " + json.dumps(losses), flush=True)
"""


def test_two_process_dp_matches_one_process(tmp_path):
    """The data-parallel MLP over ``--coordinator`` on two ranks, each
    feeding the global batch: the same losses on both ranks, and those
    of one process on the whole batch (the gradient's all-reduce sums
    the halves in another order: f32 rounding)."""
    script = tmp_path / "dp.py"
    script.write_text(DP_MLP)
    outs = _two_ranks(script, "-b", "16")
    one = _launch(str(script), "-b", "16")
    assert one.returncode == 0, one.stderr
    ref = _results(one.stdout)[0]
    got = [_results(o)[0] for o in outs]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], ref, rtol=1e-6)


POOL = """
import json
import torch
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.config import CompMode
from flexflow_tpu_torch.serve import ReplicaPool
from flexflow_tpu_torch.serve.traffic import TrafficSpec, make_traffic

torch.set_num_threads(1)
cfg = ft.FFConfig.from_args()
arch, spec = json.loads(open(%r).read())
m = ft.build_transformer_lm(ft.FFConfig(batch_size=1), device="cpu",
                            **arch)
m.compile(comp_mode=CompMode.INFERENCE)
pool = ReplicaPool(m, config=cfg, device="cpu",
                   engine_kwargs=dict(capture=False))
res = pool.run(make_traffic(TrafficSpec(**spec)), sample_seed=0)
pool.assert_zero_recompiles()
pool.check_drained()
print("RESULT " + json.dumps({
    "degrees": [r.engine.tp for r in pool.replicas],
    "clock": res["clock"], "lockstep": res["lockstep"],
    "records": [[r["stream_id"], r["replica"], r["outcome"], r["tokens"],
                 r["t_arrival"], r["ttft_s"], r["t_finish"]]
                for r in res["requests"]]}), flush=True)
"""

POOL_FLAGS = ["-b", "1", "--kv-page-size", "4", "--kv-num-pages", "65",
              "--serve-max-seqs", "4", "--serve-prefill-budget", "32",
              "--no-spec-decode", "--serve-mesh", "2", "--serve-replicas",
              "2", "--wall-clock"]


def test_two_process_wall_clock_pool_from_flags(tmp_path):
    """``--serve-mesh 2 --serve-replicas 2 --wall-clock`` on two ranks
    over ``--coordinator``: a pool of two t = 2 replicas serves the
    stream on the wall clock in lockstep, both ranks keep the same
    records, and every stream is the one-device engine's."""
    from flexflow_tpu_torch.config import CompMode
    from flexflow_tpu_torch.serve.traffic import TrafficSpec, make_traffic
    args = tmp_path / "args.json"
    args.write_text(json.dumps([J.ARCH, TRAFFIC]))
    script = tmp_path / "pool.py"
    script.write_text(POOL % str(args))
    outs = _two_ranks(script, *POOL_FLAGS)
    got = [_results(o)[0] for o in outs]
    assert got[0] == got[1]
    assert got[0]["degrees"] == [2, 2] and got[0]["lockstep"]
    assert got[0]["clock"] == "wall"
    m = ft.build_transformer_lm(ft.FFConfig(batch_size=1), device="cpu",
                                **J.ARCH)
    m.compile(comp_mode=CompMode.INFERENCE)
    cfg = ft.FFConfig(argv=POOL_FLAGS[:-6])
    traffic = make_traffic(TrafficSpec(**TRAFFIC))
    ref = ft.ServeEngine(m, cfg, device="cpu").generate(
        [t.prompt for t in traffic], [t.max_new for t in traffic],
        temperature=[t.temperature for t in traffic],
        top_k=[t.top_k for t in traffic], sample_seed=0,
        stream_ids=[t.stream_id for t in traffic])
    want = {t.stream_id: r for t, r in zip(traffic, ref)}
    assert {r[0]: r[3] for r in got[0]["records"]} == want
    assert all(r[2] == "completed" for r in got[0]["records"])
