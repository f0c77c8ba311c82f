"""A cell added from files alone runs; every cell's tiny copy runs the whole
harness on the CPU (the program's plain path) and comes out correct."""

import json

import pytest

from splatbench import registry, run
from splatbench.tests import fixture

CELLS = ["bonsai-1.2m.pass8", "c3dgs-10m.pass8", "bonsai-1.2m.walk", "c3dgs-10m.close8"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return fixture.build(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_runs_correct(bench, name):
    cell = bench.cell("tiny-" + name)
    result, lines = run.run_cell(cell, 2**31 + 99, 3.0, False, device="cpu", t_start=0.0)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m.name for m in cell.end_to_end}
    assert list(result)[-1] == "checks"
    assert lines[-len(result["checks"]):] == [
        f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in result["checks"].items()]


def test_a_cell_from_files_alone(tmp_path):
    """A new configuration, traffic mix, check, layer table and per-layer
    metric, each a new file, and new spec entries: the harness finds and
    runs them with no other change."""
    b = fixture.build(tmp_path)
    data, root = b.data, b.root
    conf = json.loads((data / "configs" / "tiny-bonsai-1.2m.json").read_text())
    conf["scene"]["sh_degree"] = 1
    conf["viewport"] = [48, 40]
    fixture.write(data / "configs" / "fixture-deg1.json", conf)
    fixture.write(data / "traffic" / "fixture-low.json", dict(
        loop="pass", distance=2.5, elevation=[-0.6, -0.2], pool=4, views_per_pass=2))
    fixture.write(data / "checks" / "fixture-deg1.low.json",
                  json.loads((data / "checks" / "bonsai-1.2m.pass8.json").read_text()))
    fixture.write(data / "layers" / "fixture.json", {"layer": "fixture", "kernels": ["^nothing$"]})
    (data / "metrics" / "fixture_units.py").write_text("def read(ctx):\n    return ctx.units\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="fixture-deg1", source="x", reduced=[], why="x",
                                file="splatbench/configs/fixture-deg1.json"))
    spec["workloads"].append(dict(name="fixture-deg1.low", config="fixture-deg1",
                                  traffic="fixture-low", chips=1, why="x"))
    spec["end_to_end"][0]["workloads"].append("fixture-deg1.low")
    spec["per_layer"].append(dict(name="fixture_units", unit="views", better="higher",
                                  source="device_trace", layer="fixture", moves="views_per_s",
                                  workloads=["fixture-deg1.low"]))
    fixture.write(root / "BENCHMARK.json", spec)
    cell = registry.Bench.load(root=root, data=data).cell("fixture-deg1.low")
    assert [m.name for m in cell.per_layer] == ["fixture_units"]
    assert registry.reader(data, "fixture_units")(type("C", (), {"units": 6})()) == 6
    result, lines = run.run_cell(cell, 5, 2.0, False, device="cpu", t_start=0.0)
    assert result["correct"], lines
    assert "views_per_s" in result["metrics"]
