"""A benchmark built from files alone in a temporary directory: the real
data files and spec, plus tiny cells of each configuration and traffic
(few splats, a small viewport, a short pool and loop), for CPU runs."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from splatbench import registry

REPO = Path(__file__).resolve().parents[2]
DATA = REPO / "splatbench"
TRAFFIC = {"pass8": dict(pool=8, views_per_pass=4), "close8": dict(pool=8, views_per_pass=4),
           "walk": dict(frames_per_loop=8), "views4": dict(pool=16, views_per_step=8)}


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def build(tmp: Path, splats: int = 1500, viewport=(64, 48)) -> registry.Bench:
    """A copy of the benchmark under ``tmp`` with a ``tiny-<cell>`` for each
    cell, added as new files and new spec entries only."""
    root = Path(tmp)
    data = root / "splatbench"
    for sub in ("configs", "traffic", "checks", "layers", "metrics", "scenes"):
        shutil.copytree(DATA / sub, data / sub, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for conf in list(spec["configs"]):
        c = json.loads((REPO / conf["file"]).read_text())
        c["scene"]["splats"], c["viewport"] = splats, list(viewport)
        name = "tiny-" + conf["name"]
        write(data / "configs" / f"{name}.json", c)
        spec["configs"].append(dict(conf, name=name, file=f"splatbench/configs/{name}.json"))
    for t, over in TRAFFIC.items():
        write(data / "traffic" / f"tiny-{t}.json",
              dict(json.loads((DATA / "traffic" / f"{t}.json").read_text()), **over))
    for w in list(spec["workloads"]):
        name = "tiny-" + w["name"]
        spec["workloads"].append(dict(w, name=name, config="tiny-" + w["config"],
                                      traffic="tiny-" + w["traffic"]))
        write(data / "checks" / f"{name}.json",
              json.loads((DATA / "checks" / f"{w['name']}.json").read_text()))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny-" + x for x in m["workloads"]]
    write(root / "BENCHMARK.json", spec)
    return registry.Bench.load(root=root, data=data)
