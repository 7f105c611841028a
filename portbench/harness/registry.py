"""Find a cell's files by name.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own under the benchmark's directory:

    configs/<config>.json     the model's sizes and the program's settings
    traffic/<mix>.json        the parameters the one generator reads
    workloads/<cell>.json     {"config", "traffic", "chips", "limits"}
    metrics/<metric>.py       a reader: ``read(run) -> float | None``

and ``BENCHMARK.json`` beside the directory says which metrics each
cell reports. A later change adds a cell, a mix or a metric by adding
files; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Tuple

BASE = Path(__file__).resolve().parent.parent


class Registry:
    def __init__(self, base: Path = BASE, bench_file: Path = None):
        self.base = Path(base)
        self.bench_file = Path(bench_file) if bench_file is not None \
            else self.base.parent / "BENCHMARK.json"

    def _json(self, kind: str, name: str) -> dict:
        path = self.base / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r} "
                                    f"({path})")
        return json.loads(path.read_text())

    def names(self, kind: str) -> List[str]:
        suffix = ".py" if kind == "metrics" else ".json"
        return sorted(p.name[:-len(suffix)]
                      for p in (self.base / kind).glob(f"*{suffix}"))

    def cell(self, name: str) -> Tuple[dict, dict, dict]:
        """(workload, config, traffic) of the cell ``name``."""
        wl = self._json("workloads", name)
        return wl, self._json("configs", wl["config"]), \
            self._json("traffic", wl["traffic"])

    def metrics_of(self, cell: str, trace: bool) -> List[Tuple[str, str]]:
        """[(name, unit)] this cell reports: with ``trace`` its
        per-layer metrics, else its end-to-end ones, as
        ``BENCHMARK.json`` lists them (a metric without ``workloads``
        belongs to every cell)."""
        bench = json.loads(self.bench_file.read_text())
        rows = bench["per_layer"] if trace else bench["end_to_end"]
        return [(m["name"], m["unit"]) for m in rows
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.base / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no reader for metric {metric!r} "
                                    f"({path})")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_")
            .replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def read_metrics(self, cell: str, trace: bool, run) -> Dict[str, dict]:
        """{name: {"value", "unit"}} of the metrics whose reader found
        something to read."""
        out = {}
        for name, unit in self.metrics_of(cell, trace):
            value = self.reader(name)(run)
            if value is not None:
                out[name] = {"value": float(value), "unit": unit}
        return out
