"""Finds everything a cell needs by the names ``BENCHMARK.json`` gives.

Under the data directory (this folder, or a test's copy of it):

- ``configs/<config>.json``: the configuration file that ``configs[].file``
  names (a scene, its viewport and its render settings);
- ``traffic/<traffic>.json``: a traffic mix (``cameras.py`` reads it); a
  ``"viewport"`` there takes the configuration's place for the cell;
- ``checks/<workload>.json``: how a cell's output is judged (frames
  checked against the reference, views whose counts are checked) and the
  limit of each number compared;
- ``layers/<id>.json``: a layer's kernel-name table (``trace.py``);
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``;
- ``scenes/<kind>.py``: a scene kind, the ``scene.kind`` of a
  configuration file (``scenes/__init__.py`` lists what it defines): the
  draw of its raw inputs, the program's load, the reference's own decode,
  the centres for the cull's headroom and the decode layer's work.

A new configuration, traffic mix, layer or metric is a new file and a new
entry of ``BENCHMARK.json``; so is a configuration of a new scene kind,
whose ``scenes/<kind>.py`` is one more new file: no file here changes.  A
time-dependent kind (4D Gaussian Splatting: Yang et al., ICLR 2024, each
frame a slice of 4D Gaussians at its scene time, is what this room is
for) adds the optional ``at(scene, t)``, the reference scene at a view's
time (``Camera.t``, from a traffic's ``"time"``), and ``blocks(...)``, the
frame blocks of the pass and views loops; a kind without them is static.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

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

    def kind(self):
        """The cell's scene kind, ``scenes/<kind>.py`` of its data directory."""
        return scene_kind(self.data, self.config["scene"]["kind"])


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
        if "viewport" in traffic:  # the traffic's own viewport, for this cell
            config["viewport"] = list(traffic["viewport"])
        check = json.loads((self.data / "checks" / f"{name}.json").read_text())
        e2e = [_metric(m) for m in self.spec["end_to_end"] if _applies(m, name)]
        per_layer = [_metric(m) for m in self.spec["per_layer"] if _applies(m, name)]
        return Cell(name, int(w["chips"]), config, traffic, check, e2e, per_layer, self.data)


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # what a dataclass of the module looks itself up by
    spec.loader.exec_module(mod)
    return mod


def reader(data: Path, metric: str) -> Callable:
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    return _load(Path(data) / "metrics" / f"{metric}.py", f"splatbench_metric_{metric}").read


_KINDS: Dict[Path, ModuleType] = {}


def scene_kind(data: Path, kind: str) -> ModuleType:
    """``scenes/<kind>.py`` of the data directory, loaded once a process."""
    path = (Path(data) / "scenes" / f"{kind}.py").resolve()
    if path not in _KINDS:
        _KINDS[path] = _load(path, f"splatbench_scene_{kind}")
    return _KINDS[path]
