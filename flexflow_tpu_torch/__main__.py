"""Launcher — ``python -m flexflow_tpu_torch [options] script.py [args]``.

The port's counterpart of ``python -m flexflow_tpu`` (the reference's
``flexflow_python`` interpreter and ``flexflow.py`` launcher): it joins
the process group a multi-rank job needs, then runs the user's script,
a code string or a REPL.

  python -m flexflow_tpu_torch train.py -b 64 --search-budget 1000
  python -m flexflow_tpu_torch -c "import flexflow_tpu_torch"
  python -m flexflow_tpu_torch --coordinator HOST:PORT --num-processes 2 \\
      --process-id 0 serve.py --serve-mesh 2 --serve-replicas 2 --wall-clock
  python -m flexflow_tpu_torch --cpu-devices 2 train.py

Launcher-only flags (consumed before the script sees argv):
  --coordinator A:P   one process a rank: join the group at tcp://A:P
                      (``parallel.mesh.init_distributed``; rank 0 binds
                      the port) before the script runs
  --num-processes N   the group's ranks (with --coordinator)
  --process-id I      this process's rank (with --coordinator)
  --device D          the rank's device when joining: ``cuda`` (the
                      card of its local rank, the default) or ``cpu``
  --cpu-devices N     the test rig of an N-device mesh without cards:
                      start N processes, gloo ranks on the CPU joined
                      over a ``file://`` rendezvous, each running the
                      script; the exit code is the first nonzero one
                      seen (in rank order when several ranks end
                      together), and a failing rank stops the others
  -c CODE             run a code string instead of a script
Everything else stays on ``sys.argv`` for ``FFConfig.from_args()``. The
launcher changes no device default: the script's models run where the
script puts them.
"""

from __future__ import annotations

import os
import runpy
import subprocess
import sys
import tempfile
import time

# a --cpu-devices child's rendezvous (set by the launcher for its
# children only)
_CPU_RIG = "FLEXFLOW_TORCH_CPU_RIG"

USAGE = ("usage: flexflow-tpu-torch [--cpu-devices N] "
         "[--coordinator HOST:PORT --num-processes N --process-id I "
         "[--device cuda|cpu]] (SCRIPT [ARGS...] | -c CODE | "
         "<no args for REPL>)\n\n"
         "Runs a user script under the flexflow_tpu_torch runtime "
         "(reference: flexflow_python / python/flexflow.py launcher).")


def _cpu_ranks(n: int, argv) -> int:
    """Run ``python -m flexflow_tpu_torch argv`` as ``n`` gloo ranks on
    the CPU over a ``file://`` rendezvous; a rank that fails stops the
    others (they would wait for it in a collective)."""
    with tempfile.TemporaryDirectory(prefix="ff_cpu_rig_") as tmp:
        init = f"file://{os.path.join(tmp, 'init')}"
        procs = []
        for rank in range(n):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
            env[_CPU_RIG] = init
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "flexflow_tpu_torch", *argv],
                env=env))
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [c for c in codes if c not in (None, 0)]
                if bad:
                    return bad[0]
                if all(c == 0 for c in codes):
                    return 0
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    if argv and argv[0] in ("--help", "-h"):
        print(USAGE)
        return 0

    cpu_devices = None
    code = None
    coordinator = num_processes = process_id = None
    device = "cuda"
    i = 0
    while i < len(argv):
        if argv[i] == "--cpu-devices" and i + 1 < len(argv):
            cpu_devices = int(argv[i + 1])
            del argv[i:i + 2]
        elif argv[i] == "--coordinator" and i + 1 < len(argv):
            coordinator = argv[i + 1]
            del argv[i:i + 2]
        elif argv[i] == "--num-processes" and i + 1 < len(argv):
            num_processes = int(argv[i + 1])
            del argv[i:i + 2]
        elif argv[i] == "--process-id" and i + 1 < len(argv):
            process_id = int(argv[i + 1])
            del argv[i:i + 2]
        elif argv[i] == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
            del argv[i:i + 2]
        elif argv[i] == "-c" and i + 1 < len(argv):
            code = argv[i + 1]
            del argv[i:i + 2]
        else:
            break

    if coordinator is not None and (num_processes is None
                                    or process_id is None):
        print("flexflow_tpu_torch: --coordinator requires "
              "--num-processes and --process-id (they are only "
              "auto-detected inside cluster environments like "
              "SLURM/GKE)", file=sys.stderr)
        return 2

    if cpu_devices is not None:
        rest = (["-c", code] if code is not None else []) + argv
        return _cpu_ranks(cpu_devices, rest)

    joined = False
    if coordinator is not None:
        from .parallel.mesh import init_distributed
        init_distributed(init_method=f"tcp://{coordinator}",
                         rank=process_id, world_size=num_processes,
                         device=device)
        joined = True
    elif os.environ.get(_CPU_RIG):
        from .parallel.mesh import init_distributed
        init_distributed(init_method=os.environ[_CPU_RIG], device="cpu")
        joined = True

    try:
        if code is not None:
            sys.argv = ["-c"] + argv
            exec(compile(code, "<string>", "exec"), {"__name__": "__main__"})
            return 0

        if not argv:
            # REPL mode (reference flexflow_top.py run_repl)
            import code as code_mod
            code_mod.interact(banner="flexflow_tpu_torch interactive shell")
            return 0

        script, script_args = argv[0], argv[1:]
        sys.argv = [script] + script_args
        sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
        runpy.run_path(script, run_name="__main__")
        return 0
    finally:
        if joined:
            from .parallel.mesh import shutdown_distributed
            shutdown_distributed()


if __name__ == "__main__":
    sys.exit(main())
