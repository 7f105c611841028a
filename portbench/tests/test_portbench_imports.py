"""Nothing the benchmark runs may hold JAX or the JAX package."""

import subprocess
import sys
from pathlib import Path

from portbench.harness.cells import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_whole_name_compare():
    assert forbidden_modules(["flexflow_tpu_torch",
                              "flexflow_tpu_torch.serve.engine"]) == []
    assert forbidden_modules(["flexflow_tpu.x"]) == ["flexflow_tpu"]
    assert forbidden_modules(["flexflow_tpu"]) == ["flexflow_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                              "numpy"]) == ["flax", "jax", "jaxlib"]
    assert forbidden_modules(["jaxtyping", "flaxen"]) == []


def test_harness_and_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.harness.cells, portbench.harness.serve_cell,"
            " portbench.harness.train_cell, portbench.reference.opt,"
            " flexflow_tpu_torch, flexflow_tpu_torch.serve;"
            "from portbench.harness.cells import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without the CUDA devices a cell asks for, the run exits non-zero
    and prints nothing on standard output."""
    code = ("import torch, runpy, sys;"
            "torch.cuda.is_available = lambda: False;"
            "sys.argv = ['run.py', '--workload', 'serve-long-context',"
            " '--seed', '1', '--seconds', '1', '--trace', '0'];"
            "runpy.run_path('portbench/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
