"""Scene kinds found in the data directory, scene times and a traffic's own
viewport: a third kind held only in a test's copy of the data directory
runs a pass cell and the control through its own load, decode and centres
with no file of the benchmark edited; a traffic's ``"time"`` gives the
views their scene times, which reach a time-dependent kind's ``at`` (once
for each distinct time) and ``blocks``, while a static kind decodes one
scene; a traffic's ``"viewport"`` reaches every reader."""

import dataclasses
import hashlib
import json
import math
import types
from pathlib import Path

import numpy as np

from splatbench import cameras, check, control, drivers, registry, run
from splatbench.tests import fixture

HERE = Path(__file__).resolve().parent
SEED = 2**31 + 2207


def _cell(tmp: Path, name: str, traffic: dict, scene=None, top=None, kind_file=None,
          kind_tail: str = "") -> registry.Cell:
    """A copy of the benchmark under ``tmp`` with one more cell ``name``: the
    tiny bonsai configuration (``scene`` and ``top`` merged into its scene
    and its top level), the traffic ``traffic``, and a scene kind copied
    from ``kind_file`` (``kind_tail`` appended) as ``scenes/<kind>.py``."""
    b = fixture.build(tmp)
    data, root = b.data, b.root
    conf = json.loads((data / "configs" / "tiny-bonsai-1.2m.json").read_text())
    conf["scene"].update(scene or {})
    conf.update(top or {})
    if kind_file is not None:
        (data / "scenes" / f"{conf['scene']['kind']}.py").write_text(
            (HERE / kind_file).read_text() + kind_tail)
    fixture.write(data / "configs" / f"{name}.json", conf)
    fixture.write(data / "traffic" / f"{name}.json", traffic)
    loop = traffic["loop"]
    limits = json.loads((data / "checks" / ("bonsai-1.2m.walk.json" if loop == "walk" else
                                            "bonsai-1.2m.pass8.json")).read_text())
    if loop == "views":
        limits["limits"]["total_visible_gap"] = 0
    fixture.write(data / "checks" / f"{name}.json", limits)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name=name, source="x", reduced=[], why="x",
                                file=f"splatbench/configs/{name}.json"))
    spec["workloads"].append(dict(name=name, config=name, traffic=name, chips=1, why="x"))
    if loop != "walk":
        spec["end_to_end"][0]["workloads"].append(name)
    fixture.write(root / "BENCHMARK.json", spec)
    return registry.Bench.load(root=root, data=data).cell(name)


def _traffic(name: str, **over) -> dict:
    tiny = json.loads((fixture.DATA / "traffic" / f"{name}.json").read_text())
    return dict(tiny, **fixture.TRAFFIC[name], **over)


def _benchmark_files() -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in fixture.DATA.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _calls(path: Path):
    return [line.split() for line in path.read_text().splitlines()]


def test_a_third_kind_from_files_alone(tmp_path):
    before = _benchmark_files()
    calls = tmp_path / "calls.txt"
    cell = _cell(tmp_path, "fixture-ply.pass", _traffic("pass8"),
                 scene=dict(kind="ply_bytes", calls=str(calls)), top=dict(cull_headroom=1.15),
                 kind_file="ply_kind.py")
    result, lines = run.run_cell(cell, SEED, 3.0, False, device="cpu", t_start=0.0)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert {"make", "centres", "program", "reference"} <= {c[0] for c in _calls(calls)}
    ctx = run.Ctx(cell, None, {}, types.SimpleNamespace(units=1), "cpu")
    assert (ctx.compressed, ctx.codebook_bytes) == (False, 0.0)
    nums = control.control_numbers(cell, 31, "cpu")
    assert nums["correct"] is False
    assert nums["image_rmse"] > 3 * cell.check["limits"]["image_rmse"]
    assert _benchmark_files() == before


def test_a_traffic_time_spans_the_views():
    vp = (1200, 799)
    for name, n in (("pass8", 64), ("walk", 600)):
        t = json.loads((fixture.DATA / "traffic" / f"{name}.json").read_text())
        plain = cameras.views(t, 5, vp)
        timed = cameras.views(dict(t, time=[0.5, 2.5]), 5, vp)
        assert len(plain) == len(timed) == n
        assert [c.t for c in plain] == [0.0] * n
        np.testing.assert_allclose([c.t for c in timed], 0.5 + 2.0 * np.arange(n) / n, rtol=1e-12)
        for a, b in zip(plain, timed):  # the time moves no camera
            np.testing.assert_array_equal(a.position, b.position)
            np.testing.assert_array_equal(a.quat, b.quat)
            assert (a.fovx, a.fovy) == (b.fovx, b.fovy)


def _ats(path: Path):
    return [float(c[1]) for c in _calls(path) if c[0] == "at"]


def test_at_once_for_each_time_and_blocks_at_the_times(tmp_path):
    calls = tmp_path / "calls.txt"
    tail = f"\nCALLS = {str(calls)!r}\n"
    traffic = _traffic("pass8", time=[0.0, 1.0])
    cell = _cell(tmp_path / "timed", "fixture-timed.pass", traffic,
                 scene=dict(kind="timed_cloud"), kind_file="timed_kind.py", kind_tail=tail)
    result, lines = run.run_cell(cell, SEED, 3.0, False, device="cpu", t_start=0.0)
    assert result["correct"], lines
    pool = traffic["pool"]
    blocks = [c[1:] for c in _calls(calls) if c[0] == "blocks"]
    assert [[float(t) for t in b] for b in blocks] == [[i / pool for i in range(pool)]]
    ats = _ats(calls)
    # the check renders a pass's sampled views and counts every view shown:
    # a pass of them at least, each time once, in order of time
    assert len(ats) == len(set(ats)) >= traffic["views_per_pass"]
    assert ats == sorted(ats) and set(ats) <= {i / pool for i in range(pool)}
    calls.write_text("")
    assert control.control_numbers(cell, 31, "cpu")["correct"] is False
    ats = _ats(calls)  # the control's reference, then the check's judge
    assert len(ats) == 2 * pool and len(set(ats)) == pool

    # a static kind under the same traffic: one scene for every view, no ``at``
    static = _cell(tmp_path / "static", "fixture-static.pass", traffic)
    for kind in ("cloud", "c3dgs_npz"):
        assert not hasattr(registry.scene_kind(static.data, kind), "at")
    inputs = static.kind().make(static.config["scene"], 3, "cpu")
    views = cameras.views(static.traffic, 3, tuple(static.config["viewport"]))
    scenes = list(check.reference_scenes(static, inputs, views, set(range(pool)), "cpu"))
    assert len(scenes) == 1 and scenes[0][1] == list(range(pool))


def test_the_views_step_builds_its_blocks_at_the_times(tmp_path):
    calls = tmp_path / "calls.txt"
    traffic = _traffic("views4", time=[0.0, 1.0])
    cell = _cell(tmp_path, "fixture-timed.views", traffic, scene=dict(kind="timed_cloud"),
                 kind_file="timed_kind.py", kind_tail=f"\nCALLS = {str(calls)!r}\n")
    cell = dataclasses.replace(cell, chips=2)
    result, lines = run.run_cell(cell, SEED, 1.0, False, device="cpu", t_start=0.0)
    assert result["correct"], lines
    pool, v = traffic["pool"], traffic["views_per_step"]
    steps = {tuple(float(t) for t in c[1:]) for c in _calls(calls) if c[0] == "blocks"}
    # each rank's half of each step it ran, at the pool rows' times
    expect = {tuple((k * v + r * v // 2 + j) / pool for j in range(v // 2))
              for k in range(pool // v) for r in range(2)}
    assert steps and steps <= expect
    assert {s[0] for s in steps} >= {0.0, v // 2 / pool}


def test_a_traffic_viewport_reaches_every_reader(tmp_path, monkeypatch):
    seen = {"views": [], "raster": [], "images": []}
    views, raster, judge = cameras.views, drivers.raster_config, check.judge

    def views_at(traffic, seed, viewport):
        seen["views"].append(tuple(viewport))
        return views(traffic, seed, viewport)

    def raster_at(config, cull):
        seen["raster"].append(tuple(config["viewport"]))
        return raster(config, cull)

    def judge_at(cell, inputs, views, window, *args, **kw):
        seen["images"] += [tuple(img.shape) for img in window.samples.values()]
        return judge(cell, inputs, views, window, *args, **kw)

    monkeypatch.setattr(cameras, "views", views_at)
    monkeypatch.setattr(drivers, "raster_config", raster_at)
    monkeypatch.setattr(check, "judge", judge_at)
    for loop, traffic in (("pass", _traffic("pass8", viewport=[48, 40])),
                          ("walk", _traffic("walk", viewport=[48, 40]))):
        cell = _cell(tmp_path / loop, f"fixture-{loop}.small", traffic)
        conf = json.loads((cell.data / "configs" / f"fixture-{loop}.small.json").read_text())
        assert conf["viewport"] == [64, 48] and cell.config["viewport"] == [48, 40]
        result, lines = run.run_cell(cell, SEED, 3.0, False, device="cpu", t_start=0.0)
        assert result["correct"], lines
        ctx = run.Ctx(cell, None, {}, types.SimpleNamespace(units=1), "cpu")
        assert (ctx.width, ctx.height, ctx.tiles) == (48, 40, math.ceil(48 / 32) * math.ceil(40 / 32))
        if loop == "pass":
            assert control.control_numbers(cell, 31, "cpu")["correct"] is False
    assert seen["views"] and set(seen["views"]) == {(48, 40)}
    assert seen["raster"] and set(seen["raster"]) == {(48, 40)}
    assert seen["images"] and set(seen["images"]) == {(40, 48, 3)}

