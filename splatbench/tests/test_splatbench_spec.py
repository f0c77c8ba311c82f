"""BENCHMARK.json keeps the benchmark's format: its keys, names, units and
lengths, and every file it names is there."""

import json
import re

from splatbench import registry
from splatbench.tests import fixture

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def spec():
    return json.loads((fixture.REPO / "BENCHMARK.json").read_text())


def test_keys_and_entries():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(s["command"]) <= 32 and all(LINE(w) for w in s["command"])
    assert s["paths"] == ["splatbench"] and 1 <= s["run_seconds"] <= 51
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE(c["source"]) and LINE(c["why"])
        assert c["file"].startswith("splatbench/") and (fixture.REPO / c["file"]).is_file()
        assert json.loads((fixture.REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE(w["why"])
        assert w["chips"] in (1, 4)
        traffic = json.loads((fixture.DATA / "traffic" / f"{w['traffic']}.json").read_text())
        if traffic["loop"] == "views":  # the step splits its views over the ranks
            assert traffic["views_per_step"] % w["chips"] == 0
        assert (fixture.DATA / "traffic" / f"{w['traffic']}.json").is_file()
        assert (fixture.DATA / "checks" / f"{w['name']}.json").is_file()
    assert len({(w["config"], w["traffic"]) for w in s["workloads"]}) == len(s["workloads"])
    four = sum(w["chips"] == 4 for w in s["workloads"])
    assert four <= max(1, len(s["workloads"]) // 4)
    assert {c["name"] for c in s["configs"]} == {w["config"] for w in s["workloads"]}
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in s["workloads"]}
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE(m["layer"]) and m["moves"] in {e["name"] for e in s["end_to_end"]}
        assert (fixture.DATA / "metrics" / f"{m['name']}.py").is_file()
        moved = next(e for e in s["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert next(m for m in s["end_to_end"] if m["name"] == "setup_s")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = registry.Bench.load()
    for w in spec()["workloads"]:
        cell = bench.cell(w["name"])
        e2e = {m.name for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
