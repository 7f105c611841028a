"""The warm boot of the port (``FFConfig.program_cache_dir``) on the CPU:
the ProgramRegistry's store (core/programs.py: save, load_warm, merge,
the manifest, corrupt and foreign stores), the serving engine's
fingerprint (every key of the JAX engine's, and each folded field
missing the store), an engine's warm boot against its cold boot and
the JAX engine's tokens on f32 and int8 pages, and the kernel-library
cache of kernels/_build.py driven by a stub compiler (a script that
writes a real shared library with g++ where nvcc would write a kernel
library).
"""

import json
import os
import shutil
import stat
import sys
import warnings

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu.models.transformer import \
    build_transformer_lm as jbuild_lm
from flexflow_tpu.serve import ServeEngine as JEngine

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core import programs as P
from flexflow_tpu_torch.core.programs import ProgramRegistry
from flexflow_tpu_torch.kernels import _build
from flexflow_tpu_torch.serve import ServeEngine as TorchEngine


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_kernel_cache(monkeypatch):
    """Each test starts unarmed, with no library bound and no count;
    the process-wide state of kernels/_build.py is restored after."""
    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_versions", {})
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(_build, "_build_s", [0.0])
    monkeypatch.setattr(_build, "_hits", {})


GEOMETRY = dict(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                serve_prefill_budget=48)
ARCH = dict(vocab_size=89, max_seq_len=64, hidden=32, num_heads=4,
            num_layers=2, ff_dim=64)


def _fn(x, k):
    return x * (len(k) if isinstance(k, (tuple, str)) else k)


# ------------------------------------------------------------ the store
def test_save_and_load_round_trip(tmp_path):
    reg = ProgramRegistry({"model": "x"}, "cpu", cache_dir=str(tmp_path))
    reg.register("step")
    reg.call("step", _fn, torch.ones(3), 2)
    reg.call("step", _fn, torch.ones(4, dtype=torch.int32), (1, 2))
    reg.call_eager("side", _fn, torch.ones(2), "a")
    assert reg.dirty
    assert reg.save() == 3 and not reg.dirty
    path = tmp_path / f"{reg.fp_hash}{P.STORE_SUFFIX}"
    doc = json.loads(path.read_text())
    assert doc["version"] == P.STORE_VERSION
    assert doc["fp_hash"] == reg.fp_hash
    assert doc["fingerprint"] == {"model": "x"}
    assert doc["torch"] == torch.__version__ and doc["device_name"] == "cpu"
    assert {e["family"] for e in doc["entries"]} == {"step", "side"}
    assert not list(tmp_path.glob("*.tmp*"))

    warm = ProgramRegistry.load(str(tmp_path), {"model": "x"}, "cpu")
    assert warm.restored_counts() == {"step": 2, "side": 1}
    assert warm.compile_counts() == {"step": 0, "side": 0}
    # the stored recipes are the signatures of the arguments
    assert warm.pending_restored() == sorted([
        ("side", warm.signature((torch.ones(2), "a"))),
        ("step", warm.signature((torch.ones(3), 2))),
        ("step", warm.signature((torch.ones(4, dtype=torch.int32),
                                 (1, 2))))])
    rec = warm.boot_record()
    assert rec["restored"] == 3 and not rec["warm"]
    warm.call("step", _fn, torch.ones(3), 2)
    warm.call("step", _fn, torch.ones(4, dtype=torch.int32), (1, 2))
    assert not warm.boot_record()["warm"]           # one still pending
    warm.call_eager("side", _fn, torch.ones(2), "a")
    rec = warm.boot_record()
    assert rec["warm"] and rec["builds"] == 0
    assert rec["compiles"] == 3          # readied signatures still count
    assert not warm.pending_restored() and not warm.dirty


def test_save_merges_and_keeps_the_manifest(tmp_path):
    a = ProgramRegistry({"m": 1}, "cpu", cache_dir=str(tmp_path))
    a.call("step", _fn, torch.ones(3), 2)
    assert a.save() == 1
    b = ProgramRegistry({"m": 1}, "cpu", cache_dir=str(tmp_path))
    b.call("step", _fn, torch.ones(5), 2)
    assert b.save() == 2                  # merged with a's entry
    c = ProgramRegistry({"m": 2}, "cpu", cache_dir=str(tmp_path))
    c.call("other", _fn, torch.ones(1), 3)
    c.save()
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man[a.fp_hash]["entries"] == 2
    assert man[a.fp_hash]["families"] == ["step"]
    assert man[c.fp_hash]["entries"] == 1
    assert man[c.fp_hash]["fingerprint"] == {"m": "2"}
    assert ProgramRegistry.load(str(tmp_path), {"m": 1}, "cpu") \
        .restored_counts() == {"step": 2}
    # unarmed: nothing is written
    assert ProgramRegistry({"m": 1}, "cpu").save() == 0


@pytest.mark.parametrize("damage", ["truncated", "garbage", "wrong_type",
                                    "old_version", "bad_entry"])
def test_bad_store_warns_and_boots_cold(tmp_path, damage):
    reg = ProgramRegistry({"m": 1}, "cpu", cache_dir=str(tmp_path))
    reg.call("step", _fn, torch.ones(3), 2)
    reg.save()
    path = tmp_path / f"{reg.fp_hash}{P.STORE_SUFFIX}"
    text = path.read_text()
    doc = json.loads(text)
    if damage == "truncated":
        path.write_text(text[:len(text) // 2])
    elif damage == "garbage":
        path.write_bytes(os.urandom(64))
    elif damage == "wrong_type":
        path.write_text("[1, 2, 3]")
    elif damage == "old_version":
        path.write_text(json.dumps(dict(doc, version=0)))
    else:
        doc["entries"][0]["sig"] = [["t", "not a shape", 3]]
        path.write_text(json.dumps(doc))
    with pytest.warns(UserWarning, match="unreadable store"):
        fresh = ProgramRegistry.load(str(tmp_path), {"m": 1}, "cpu")
    assert fresh.restored_counts() == {}
    assert fresh.boot_record()["restored"] == 0
    # a cold boot writes the store back whole
    fresh.call("step", _fn, torch.ones(3), 2)
    with pytest.warns(UserWarning, match="unreadable store"):
        assert fresh.save() == 1
    assert ProgramRegistry.load(str(tmp_path), {"m": 1}, "cpu") \
        .restored_counts() == {"step": 1}


def test_foreign_fingerprint_misses(tmp_path):
    reg = ProgramRegistry({"m": 1}, "cpu", cache_dir=str(tmp_path))
    reg.call("step", _fn, torch.ones(3), 2)
    reg.save()
    other = ProgramRegistry({"m": 2}, "cpu", cache_dir=str(tmp_path))
    # another fingerprint's store under this one's name: a miss
    shutil.copy(tmp_path / f"{reg.fp_hash}{P.STORE_SUFFIX}",
                tmp_path / f"{other.fp_hash}{P.STORE_SUFFIX}")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert other.load_warm() == 0
    assert other.restored_counts() == {}


# ---------------------------------------------------------- fingerprint
# the JAX engine's runtime keys and the port's counterparts; every other
# key of the JAX fingerprint is folded under its own name
JAX_KEY_IN_PORT = {"jax": "torch", "use_pallas": "kernels",
                   "interpret": "backend"}


def _port_engine(cache_dir=None, **knobs):
    cfg = dict(GEOMETRY, **knobs)
    m = ft.build_transformer_lm(ft.FFConfig(batch_size=1, **cfg),
                                device="cpu", **ARCH)
    return TorchEngine(m, ft.FFConfig(program_cache_dir=cache_dir, **cfg),
                       device="cpu")


def test_fingerprint_holds_every_jax_key():
    jff = jbuild_lm(JConfig(batch_size=1, **GEOMETRY), **ARCH)
    jfp = JEngine(jff)._program_fingerprint()
    pfp = _port_engine()._program_fingerprint()
    want = {JAX_KEY_IN_PORT.get(k, k) for k in jfp}
    assert want <= set(pfp), want - set(pfp)
    # the same values but for the runtime, the dtypes' spellings and
    # attn_block_kv, which JAX resolves for the TPU (choose_block_kv:
    # 0 -> its VMEM-sized tile) and the port folds as configured
    for k, v in jfp.items():
        if k not in JAX_KEY_IN_PORT and k not in (
                "backend", "devices", "act_dtype", "kv_store_dtype",
                "attn_block_kv"):
            assert pfp[k] == v, k
    for k in ("cuda", "device_name"):
        assert k in pfp


@pytest.mark.parametrize("flip", [
    dict(kv_dtype="int8"), dict(kv_page_size=16), dict(kv_num_pages=81),
    dict(serve_prefill_budget=40), dict(serve_max_seqs=4),
    dict(adapter_rank=4), dict(serve_chunked_prefill=False),
    dict(serve_attn_block_kv=16)], ids=lambda d: next(iter(d)))
def test_each_serving_knob_misses_the_store(flip):
    assert _port_engine(**flip).programs.fp_hash != \
        _port_engine().programs.fp_hash


@pytest.mark.parametrize("field", ["torch", "cuda", "device_name",
                                   "kernel"])
def test_each_runtime_field_misses_the_store(monkeypatch, field):
    base = _port_engine().programs.fp_hash
    if field == "kernel":
        real = _build.source_digest
        monkeypatch.setattr(_build, "source_digest",
                            lambda n: real(n) + "edited")
    else:
        real = P.runtime_identity
        monkeypatch.setattr(
            "flexflow_tpu_torch.serve.engine.runtime_identity",
            lambda d: dict(real(d), **{field: "other"}))
    assert _port_engine().programs.fp_hash != base


# ------------------------------------------------------------ warm boot
@pytest.fixture(scope="module")
def shared_lm():
    jff = jbuild_lm(JConfig(batch_size=1, **GEOMETRY), **ARCH)
    JEngine(jff)                       # compiles the model for serving
    params = {op: {k: np.asarray(v) for k, v in p.items()}
              for op, p in jff.state.params.items()}
    return jff, params


def _prompts():
    rng = np.random.default_rng(3)
    return [[int(x) for x in rng.integers(1, 89, n)] for n in (5, 20, 50)]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_engine_warm_boot_equals_cold_and_jax(tmp_path, shared_lm,
                                              kv_dtype):
    jff, params = shared_lm
    knobs = dict(GEOMETRY, kv_dtype=kv_dtype)

    def boot():
        model = ft.from_jax_params(params, device="cpu")
        eng = TorchEngine(model, ft.FFConfig(program_cache_dir=str(tmp_path),
                                             **knobs), device="cpu")
        counts = eng.warmup()
        return eng, counts

    cold, cold_counts = boot()
    assert cold.programs_restored == 0 and not cold.boot_stats["warm"]
    store = tmp_path / f"{cold.programs.fp_hash}{P.STORE_SUFFIX}"
    assert store.is_file()
    entries = len(json.loads(store.read_text())["entries"])
    prompts = _prompts()
    ours_cold = cold.generate(prompts, 6)

    warm, warm_counts = boot()
    assert warm.programs.fp_hash == cold.programs.fp_hash
    assert warm.programs_restored == entries > 0
    bs = warm.boot_stats
    assert bs["warm"] and bs["restored"] == entries and bs["builds"] == 0
    assert warm_counts == cold_counts
    ours_warm = warm.generate(prompts, 6)
    assert warm.compile_counts() == warm_counts       # nothing new
    assert not warm.programs.dirty
    assert ours_warm == ours_cold

    jeng = JEngine(jff, config=JConfig(batch_size=1, **knobs))
    jeng.warmup()
    assert ours_warm == jeng.generate(prompts, 6)


def test_restored_handoff_is_readied_and_stale_steps_warn(tmp_path,
                                                         shared_lm):
    """An engine with a host tier stores its page export and import; an
    engine of the same fingerprint without one readies them in warmup
    (warm). A stored step signature this engine's steps do not have
    (another build's) warns and leaves the boot cold."""
    _, params = shared_lm

    def boot(**knobs):
        model = ft.from_jax_params(params, device="cpu")
        eng = TorchEngine(model, ft.FFConfig(program_cache_dir=str(tmp_path),
                                             **GEOMETRY, **knobs),
                          device="cpu")
        eng.warmup()
        return eng

    tiered = boot(host_tier_mb=1.0)
    assert tiered.host_tier is not None
    store = tmp_path / f"{tiered.programs.fp_hash}{P.STORE_SUFFIX}"
    doc = json.loads(store.read_text())
    assert {e["family"] for e in doc["entries"]} == \
        {"mixed", "export", "import"}
    plain = boot()
    assert plain.programs.fp_hash == tiered.programs.fp_hash
    assert plain.host_tier is None and plain.boot_stats["warm"]
    assert plain.compile_counts()["export"] == 1
    doc["entries"].append({"family": "mixed", "capture_s": 0.0,
                           "sig": [["s", "'mixed'"], ["s", "((3,),)"],
                                   ["t", [3], "torch.int32"]]})
    store.write_text(json.dumps(doc))
    with pytest.warns(UserWarning, match="does not run"):
        stale = boot()
    assert not stale.boot_stats["warm"]
    assert stale.boot_stats["restored"] == 4


def test_warm_pool_scale_up_is_labelled_warm(tmp_path, shared_lm):
    from flexflow_tpu_torch.serve import ReplicaPool
    from flexflow_tpu_torch.utils.telemetry import Telemetry
    _, params = shared_lm
    model = ft.from_jax_params(params, device="cpu")
    cfg = ft.FFConfig(program_cache_dir=str(tmp_path), **GEOMETRY)
    tel = Telemetry()
    pool = ReplicaPool(model, 1, config=cfg, telemetry=tel,
                       engine_kwargs={"device": "cpu"})
    pool._activate_replica(0.0)
    boots = [e[2] for e in tel.events if e[2].startswith("replica_boot")]
    assert boots == ["replica_boot_cold", "replica_boot_warm"]
    assert pool._last_boot["warm"] and pool._last_boot["restored"] == 1


def test_trainer_saves_its_signatures_and_restores_them(tmp_path):
    def model():
        m = ft.build_transformer_lm(
            ft.FFConfig(batch_size=2, program_cache_dir=str(tmp_path)),
            batch_size=2, device="cpu", **dict(ARCH, max_seq_len=16))
        from functools import partial
        from flexflow_tpu_torch.core.losses import \
            sparse_categorical_crossentropy as scce
        m.compile(optimizer=ft.SGDOptimizer(lr=0.01),
                  loss_type=partial(scce, from_logits=True), metrics=[])
        return m

    rng = np.random.default_rng(0)
    toks = rng.integers(0, 89, (4, 16)).astype(np.int32)
    x = {"tokens": toks,
         "positions": np.tile(np.arange(16, dtype=np.int32), (4, 1))}
    m = model()
    assert m.executor.program_registry().restored_counts() == \
        {"train_step": 0}
    m.fit(x, np.roll(toks, -1, 1), epochs=1, verbose=False)
    assert list(tmp_path.glob(f"*{P.STORE_SUFFIX}"))
    m2 = model()
    reg = m2.executor.program_registry()
    assert reg.fp_hash == m.executor.programs.fp_hash
    assert sum(reg.restored_counts().values()) == \
        sum(m.compile_counts().values()) > 0
    assert m2.executor.save_programs() == 0        # nothing new ran


# ----------------------------------------------------- the kernel cache
STUB = r"""#!{python}
import os, sys
args = sys.argv[1:]
if args == ["--version"]:
    print(os.environ.get("STUB_VERSION", "stub 1.0"))
    sys.exit(0)
log = os.environ.get("STUB_LOG")
out = args[args.index("-o") + 1]
if log:
    with open(log, "a") as f:
        f.write(out + "\n")
if os.environ.get("STUB_FAIL"):
    print("stub: refused")
    sys.exit(1)
import subprocess
sys.exit(subprocess.call(["g++", "-shared", "-fPIC", "-x", "c", "-", "-o",
                          out], stdin=open(os.devnull)))
"""


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """CUDA_HOME/bin/nvcc: a script that answers --version from
    STUB_VERSION and writes an empty but loadable shared library where
    nvcc would write the kernel library (g++ on empty C)."""
    if shutil.which("g++") is None:
        pytest.skip("the stub compiler needs g++")
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(STUB.replace("{python}", sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("STUB_LOG", str(tmp_path / "stub.log"))
    return tmp_path


def test_cache_resolves_builds_and_loads_under_kernels(stub_nvcc):
    cache = stub_nvcc / "progs"
    assert _build.arm_cache(cache)
    assert not _build.arm_cache(stub_nvcc / "elsewhere")   # once a process
    assert _build.library_dir() == cache.resolve() / "kernels"
    path = _build.library_path("dropout")
    assert path.parent == cache.resolve() / "kernels"
    assert _build.build(["dropout", "sparse_rows"]).keys() == \
        {"dropout", "sparse_rows"}
    assert path.is_file() and _build.verified(path)
    assert _build.build_counts() == {"dropout": 1, "sparse_rows": 1}
    assert _build.build_seconds() > 0
    # the compiler wrote a temporary file, renamed into place
    written = (stub_nvcc / "stub.log").read_text().split()
    assert all(w.endswith(".tmp") for w in written)
    assert not list(path.parent.glob("*.tmp"))
    _build.load_library("dropout")
    assert _build.cache_hits() == {}          # built here: not a hit
    # a second process over the same cache: a hit, no build
    _build._LIBS.clear()
    _build._builds.clear()
    _build.load_library("sparse_rows")
    assert _build.build_counts() == {} and \
        _build.cache_hits() == {"sparse_rows": 1}


def test_compiler_version_is_in_the_digest(stub_nvcc, monkeypatch):
    _build.arm_cache(stub_nvcc / "progs")
    a = _build.library_path("dropout")
    monkeypatch.setattr(_build, "_versions", {})
    monkeypatch.setenv("STUB_VERSION", "stub 2.0")
    b = _build.library_path("dropout")
    assert a != b and a.parent == b.parent
    # the program stores key on the source alone
    assert _build.source_digest("dropout") == _build.source_digest("dropout")


@pytest.mark.parametrize("damage", ["zeros", "truncated", "bytes"])
def test_corrupt_library_is_rebuilt_with_a_warning(stub_nvcc, damage):
    _build.arm_cache(stub_nvcc / "progs")
    _build.build(["dropout"])
    path = _build.library_path("dropout")
    blob = path.read_bytes()
    if damage == "zeros":
        path.write_bytes(b"\0" * len(blob))
    elif damage == "truncated":
        path.write_bytes(blob[:100])
    else:
        # a flipped byte past the header still loads; its checksum does
        # not match
        path.write_bytes(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    _build._builds.clear()
    with pytest.warns(UserWarning, match="failed to load"):
        lib = _build.load_library("dropout")
    assert lib is not None and _build.verified(path)
    assert _build.build_counts() == {"dropout": 1}
    assert path.read_bytes() != b"\0" * len(blob)


def test_failed_build_raises(stub_nvcc, monkeypatch):
    _build.arm_cache(stub_nvcc / "progs")
    monkeypatch.setenv("STUB_FAIL", "1")
    with pytest.raises(RuntimeError, match="nvcc failed for dropout"):
        _build.load_library("dropout")
    assert not list((stub_nvcc / "progs" / "kernels").glob("*.so"))
    assert not list((stub_nvcc / "progs" / "kernels").glob("*.tmp"))


def test_unarmed_libraries_stay_in_the_checkout(stub_nvcc):
    assert _build.library_dir() == _build.BUILD_DIR
    assert _build.library_path("dropout").parent == _build.BUILD_DIR


def test_native_library_follows_the_armed_cache(tmp_path):
    from flexflow_tpu_torch import native
    if shutil.which("g++") is None:
        pytest.skip("the native library needs g++")
    _build.arm_cache(tmp_path)
    path = native.library_path()
    assert path.parent == tmp_path.resolve() / "kernels"
    assert native.build() == path and _build.verified(path)
    assert _build.build_counts() == {"native": 1}
