"""Finds everything a cell needs by the names ``BENCHMARK.json`` gives.

Under the data directory (this folder, or a test's copy of it):

- ``configs/<config>.json``: the configuration file that ``configs[].file``
  names (a scene, its viewport and its render settings);
- ``traffic/<traffic>.json``: a traffic mix (``cameras.py`` reads it);
- ``checks/<workload>.json``: how a cell's output is judged (frames
  checked against the reference, views whose counts are checked) and the
  limit of each number compared;
- ``layers/<id>.json``: a layer's kernel-name table (``trace.py``);
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.

A new configuration, traffic mix, layer or metric is a new file and a new
entry of ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    data: Path


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _metric(entry: dict) -> Metric:
    return Metric(entry["name"], entry["unit"])


class Bench:
    """A benchmark spec (the parsed ``BENCHMARK.json``) and its data directory."""

    def __init__(self, spec: dict, data: Path = HERE, root: Path = ROOT):
        self.spec, self.data, self.root = spec, Path(data), Path(root)

    @classmethod
    def load(cls, root: Path = ROOT, data: Path = HERE) -> "Bench":
        return cls(json.loads((Path(root) / "BENCHMARK.json").read_text()), data, root)

    def cell(self, name: str) -> Cell:
        work = {w["name"]: w for w in self.spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r}; the benchmark has {sorted(work)}")
        w = work[name]
        conf = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        config = json.loads((self.root / conf["file"]).read_text())
        traffic = json.loads((self.data / "traffic" / f"{w['traffic']}.json").read_text())
        check = json.loads((self.data / "checks" / f"{name}.json").read_text())
        e2e = [_metric(m) for m in self.spec["end_to_end"] if _applies(m, name)]
        per_layer = [_metric(m) for m in self.spec["per_layer"] if _applies(m, name)]
        return Cell(name, int(w["chips"]), config, traffic, check, e2e, per_layer, self.data)


def reader(data: Path, metric: str) -> Callable:
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = Path(data) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"splatbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def scene_maker(kind: str) -> Callable:
    """``make`` of ``scenes/<kind>.py``."""
    return importlib.import_module(f"splatbench.scenes.{kind}").make
