"""The port stands alone: no module of flexflow_tpu_torch, and not
chip_smoke.py, imports JAX, ml_dtypes or the JAX package, importing
the serving, search and training packages — and the executing mesh's
collectives, layouts, rank pool and the executor's mesh half — leaves
them unloaded, and the native search engine builds from
flexflow_tpu_torch/csrc alone."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "flexflow_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flexflow_tpu", "ml_dtypes")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"engine.py", "paged_ragged_v2.py", "chip_smoke.py",
            "flash_attention.py", "executor.py", "model.py",
            "attention.py", "optimizers.py", "lstm_scan.py", "rnn.py",
            "embedding.py", "nmt_lstm.py", "disagg.py", "transport.py",
            "serve_place.py", "mesh.py", "pconfig.py", "strategy_io.py",
            "graph_pipeline.py", "ulysses.py", "cost_model.py",
            "simulator.py", "mcmc.py", "native_search.py",
            "op_measure.py", "explain.py", "fusion.py", "overlap.py",
            "wrappers.py", "collectives.py", "sharding.py",
            "launch.py"} <= names


def test_import_leaves_jax_unloaded():
    code = ("import sys, flexflow_tpu_torch.serve, flexflow_tpu_torch, "
            "flexflow_tpu_torch.search, flexflow_tpu_torch.serve.transport, "
            "flexflow_tpu_torch.parallel.strategy_io, "
            "flexflow_tpu_torch.parallel.graph_pipeline, "
            "flexflow_tpu_torch.search.native_search, "
            "flexflow_tpu_torch.search.op_measure, "
            "flexflow_tpu_torch.native.wrappers, "
            "flexflow_tpu_torch.parallel.collectives, "
            "flexflow_tpu_torch.parallel.sharding, "
            "flexflow_tpu_torch.parallel.launch, "
            "flexflow_tpu_torch.core.executor; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flexflow_tpu', 'ml_dtypes')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_native_loader_reads_only_port_sources():
    """The g++ command names sources and an include directory under
    flexflow_tpu_torch/csrc only, and every file the sources include
    from the repository is there."""
    from flexflow_tpu_torch import native
    csrc = ROOT / "flexflow_tpu_torch" / "csrc"
    assert native.CSRC == csrc
    assert native.BUILD_DIR == ROOT / "flexflow_tpu_torch" / "_build"
    for f in native.SOURCES + native.HEADERS:
        text = (csrc / f).read_text()
        assert (csrc / f).is_file()
        for line in text.splitlines():
            if line.startswith('#include "'):
                inc = line.split('"')[1]
                assert (csrc / inc).is_file(), (f, inc)
                assert inc in native.HEADERS, (f, inc)
    names = {p.name for p in csrc.iterdir()}
    assert names >= set(native.SOURCES + native.HEADERS)
    # the loader's and embedding-bag's C API: declared in the port's
    # header, defined in its sources, bound by the built library
    assert {"dataloader.cc", "embedding_bag.cc"} <= set(native.SOURCES)
    header = (csrc / "flexflow_torch_c.h").read_text()
    defined = "".join((csrc / f).read_text() for f in native.SOURCES)
    lib = native.get_lib()
    for sym in ("ffdl_create", "ffdl_start_epoch", "ffdl_num_batches",
                "ffdl_next_batch", "ffdl_destroy", "ffdl_embedding_bag"):
        assert f" {sym}(" in header, sym
        assert f" {sym}(" in defined, sym
        assert getattr(lib, sym).argtypes, sym
