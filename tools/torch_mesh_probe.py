"""What the backends of the port's executing mesh accept on one card.

    python3 tools/torch_mesh_probe.py [--out mesh_probe.json]

Three probes, each in rank processes of its own (spawn), printing one
JSON line each and writing them together to ``--out``:

  * ``gloo_cuda``: two gloo ranks on card 0 call each collective the
    mesh uses (all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
    broadcast, all_gather of a list) directly on CUDA tensors, and
    record which ones gloo refuses (and with what message) and which
    give the right values. The port stages every gloo collective
    through pinned host memory whatever the answer
    (parallel/collectives.py); this records why.
  * ``nccl_capture``: one NCCL rank captures a CUDA graph holding an
    all_reduce issued on a second stream forked from the capture
    stream (the gradient buckets' pattern) and replays it: the values
    after each replay, and whether capture raised.
  * ``nccl_two_ranks_one_card``: two NCCL ranks on card 0 initialize a
    group and all-reduce: NCCL's verdict (its error text, or that it
    accepted).

Needs CUDA; run it where the card is. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def gloo_cuda():
    import torch
    import torch.distributed as dist
    r = dist.get_rank()
    dev = torch.device("cuda", 0)
    out = {}

    def check(name, fn):
        try:
            ok = fn()
            out[name] = "ok" if ok else "wrong values"
        except Exception as e:       # noqa: BLE001 - recorded, not hidden
            out[name] = f"refused: {type(e).__name__}: " \
                        f"{str(e).splitlines()[0][:160]}"

    def ar():
        t = torch.full((4,), float(r + 1), device=dev)
        dist.all_reduce(t)
        return torch.equal(t.cpu(), torch.full((4,), 3.0))

    def ag():
        t = torch.full((2,), float(r), device=dev)
        o = torch.empty(4, device=dev)
        dist.all_gather_into_tensor(o, t)
        return o.tolist() == [0.0, 0.0, 1.0, 1.0]

    def rs():
        t = torch.arange(4, dtype=torch.float32, device=dev) + r
        o = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(o, t)
        want = (torch.arange(4.0) * 2 + 1)[2 * r:2 * r + 2]
        return torch.equal(o.cpu(), want)

    def bc():
        t = torch.full((3,), float(r + 5), device=dev)
        dist.broadcast(t, src=0)
        return torch.equal(t.cpu(), torch.full((3,), 5.0))

    def agl():
        t = torch.full((2,), float(r), device=dev)
        lst = [torch.empty(2, device=dev) for _ in range(2)]
        dist.all_gather(lst, t)
        return [x.tolist() for x in lst] == [[0.0, 0.0], [1.0, 1.0]]

    for name, fn in (("all_reduce", ar), ("all_gather_into_tensor", ag),
                     ("reduce_scatter_tensor", rs), ("broadcast", bc),
                     ("all_gather", agl)):
        check(name, fn)
        dist.barrier()
    return out


def nccl_capture():
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.ones(1024, device=dev)
    comm = torch.cuda.Stream(dev)
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream())
    out = {}
    try:
        with torch.cuda.stream(side):
            y = x * 2            # warm-up outside the graph
            dist.all_reduce(y)
        torch.cuda.synchronize()
        with torch.cuda.graph(g, stream=side,
                              capture_error_mode="thread_local"):
            y = x * 2
            comm.wait_stream(side)
            with torch.cuda.stream(comm):
                dist.all_reduce(y)
            side.wait_stream(comm)
            z = y + 1
        vals = []
        for k in range(3):
            x.fill_(float(k + 1))
            g.replay()
            torch.cuda.synchronize()
            vals.append(float(z[0]))
        world = dist.get_world_size()
        out["captured"] = True
        out["replay_values"] = vals
        out["want"] = [2.0 * (k + 1) * world + 1 for k in range(3)]
        out["ok"] = vals == out["want"]
    except Exception as e:           # noqa: BLE001 - recorded
        out["captured"] = False
        out["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return out


def nccl_allreduce():
    import torch
    import torch.distributed as dist
    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return t.tolist()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_mesh_probe: CUDA is not available", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.parallel.launch import RankPool
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="mesh_probe.json")
    args = ap.parse_args()
    tmp = Path(tempfile.mkdtemp(prefix="ff_mesh_probe_"))
    res = {}
    with RankPool(2, str(tmp / "gloo"), backend="gloo", device="cuda",
                  threads=0, timeout_s=120) as pool:
        res["gloo_cuda"] = pool.run(gloo_cuda)
    print(json.dumps({"gloo_cuda": res["gloo_cuda"]}), flush=True)
    with RankPool(1, str(tmp / "nccl1"), backend="nccl", device="cuda",
                  threads=0, timeout_s=120) as pool:
        res["nccl_capture"] = pool.run(nccl_capture)[0]
    print(json.dumps({"nccl_capture": res["nccl_capture"]}), flush=True)
    try:
        with RankPool(2, str(tmp / "nccl2"), backend="nccl",
                      device="cuda", threads=0, timeout_s=90) as pool:
            vals = pool.run(nccl_allreduce)
        res["nccl_two_ranks_one_card"] = {"accepted": True,
                                          "values": vals}
    except Exception as e:           # noqa: BLE001 - NCCL's verdict
        lines = [ln for ln in str(e).splitlines()
                 if "rror" in ln or "uplicate" in ln]
        res["nccl_two_ranks_one_card"] = {"accepted": False,
                                          "error": lines[-3:]}
    print(json.dumps({"nccl_two_ranks_one_card":
                      res["nccl_two_ranks_one_card"]}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
