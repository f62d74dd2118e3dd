"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

A workload names a configuration (``configs[].file``), a traffic mix
(``traffic/<traffic>.json``) and its correctness limits
(``limits/<workload>.json``). Its metrics are the ``end_to_end`` and
``per_layer`` entries that list it, or, for an entry without a
``workloads`` key, that move an end-to-end metric the cell reports. Each
per-layer metric is read by ``metrics/<name>.py``.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    def model_config(self, **overrides):
        """The port's ``ModelConfig`` of this cell's configuration."""
        from repro_torch.configs.base import ModelConfig
        return ModelConfig(**{**self.config["model"], **overrides})

    @property
    def n_pe(self) -> int:
        return int(self.config.get("program", {}).get("n_pe", 0))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _lists(entry: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{', '.join(sorted(work))}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "perfbench" / "traffic"
                        / f"{w['traffic']}.json")
    limits = load_json(root / "perfbench" / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads",
                                                            [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _lists(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)


def metric_reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
