"""The host path's per-layer metrics (``metrics/*`` reading the program's
spans through ``spans.py``) on fake records: means per call, the tail, and
None where the program recorded nothing or has no trace module."""

import sys
import types

import pytest

from splatbench import registry
from websplat_tpu_torch.utils import trace

WALK = ("graph_launch_ms.walk", "render_prep_ms.walk", "readback_ms.walk", "readback_p95_ms.walk",
        "render_ms.walk")


def _read(metric):
    return registry.reader(registry.HERE, metric)(types.SimpleNamespace())


def _records(monkeypatch, spans):
    """The program's records: (name, ms) pairs laid end to end."""
    out, t = [], 1_700_000_000_000_000_000
    for name, ms in spans:
        out.append(trace.Span(name, t, t + round(ms * 1e6), None, 0))
        t += round(ms * 1e6) + 1000
    monkeypatch.setattr(trace, "records", lambda: out)


def test_walk_means_per_call(monkeypatch):
    frames = []
    for k in range(20):
        frames += [("ws.render.prep", 0.4), ("ws.graph.lookup", 0.01), ("ws.graph.replay", 0.1),
                   ("ws.render.readback", 1.0 if k < 19 else 3.0), ("ws.render", 2.0)]
    _records(monkeypatch, frames)
    assert _read("render_prep_ms.walk") == pytest.approx(0.4)
    assert _read("graph_launch_ms.walk") == pytest.approx(0.11)
    assert _read("readback_ms.walk") == pytest.approx((19 * 1.0 + 3.0) / 20)
    assert _read("render_ms.walk") == pytest.approx(2.0)
    # the 95th percentile of 20 readbacks lies between the 19th and the 20th
    assert _read("readback_p95_ms.walk") == pytest.approx(1.0 + 0.05 * 2.0)


def test_pass_launch_averages_each_span_over_its_own_calls(monkeypatch):
    """A span recorded more often than the other (the pass before the window,
    a capture's extra lookup) is averaged over its own calls: the metric is
    the mean lookup plus the mean replay, not a sum over units."""
    _records(monkeypatch, [("ws.graph.lookup", 0.02)] * 4 + [("ws.graph.replay", 0.5),
                                                             ("ws.graph.replay", 0.7)])
    assert _read("graph_launch_ms.pass") == pytest.approx(0.02 + 0.6)


def test_tail_moves_with_slow_readbacks(monkeypatch):
    _records(monkeypatch, [("ws.render.readback", 1.0)] * 90 + [("ws.render.readback", 2.5)] * 10)
    assert _read("readback_p95_ms.walk") == pytest.approx(2.5)
    assert _read("readback_ms.walk") == pytest.approx(1.15)


def test_nothing_recorded_gives_none(monkeypatch):
    _records(monkeypatch, [("ws.render.readback", 1.0)])  # one frame: no tail
    assert _read("graph_launch_ms.pass") is None and _read("render_prep_ms.walk") is None
    assert _read("readback_p95_ms.walk") is None
    _records(monkeypatch, [])
    assert all(_read(m) is None for m in WALK + ("graph_launch_ms.pass",))


def test_a_program_without_the_trace_module_gives_none(monkeypatch):
    """A program from before utils/trace.py: the readers return None and
    raise nothing."""
    monkeypatch.setitem(sys.modules, "websplat_tpu_torch.utils.trace", None)
    monkeypatch.delattr(sys.modules["websplat_tpu_torch.utils"], "trace")
    assert all(_read(m) is None for m in WALK + ("graph_launch_ms.pass",))
