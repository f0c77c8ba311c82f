"""utils/trace.py: spans that cost one check while tracing is off, their
nesting, their clock against the profiler's, the ring's bound, the render
path's spans and the graph cache's counters (CPU)."""

import threading
import time
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.test_torch_npz import _codebook_blob
from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.io.loader import load_gaussian_cloud
from websplat_tpu_torch.io.npz import dumps_npz
from websplat_tpu_torch.render import graph
from websplat_tpu_torch.render.renderer import GaussianRenderer
from websplat_tpu_torch.synth import make_camera, make_cloud
from websplat_tpu_torch.utils import trace

FRAME_STAGES = ("ws.frame.stream", "ws.frame.sort", "ws.frame.ranges", "ws.frame.raster")


@pytest.fixture(autouse=True)
def clean():
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _names():
    return [r.name for r in trace.records()]


def test_off_spans_record_nothing_and_open_no_profiler_range(monkeypatch):
    calls = []
    real = trace._Range

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(trace, "_Range", counting)
    assert trace.span("ws.a") is trace.span("ws.b")  # the one shared no-op
    with trace.span("ws.a"):
        with trace.span("ws.b"):
            pass
    assert calls == [] and trace.records() == []

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("ws.profiled"):
            pass
    assert calls == ["ws.profiled"] and _names() == ["ws.profiled"]
    assert "ws.profiled" in {e.name() for e in prof.profiler.kineto_results.events()}

    trace.enable()
    with trace.span("ws.enabled"):
        pass
    assert _names() == ["ws.profiled", "ws.enabled"]
    assert calls == ["ws.profiled"]  # no profiler: no range
    trace.enable(False)
    with trace.span("ws.off"):
        pass
    assert _names() == ["ws.profiled", "ws.enabled"]


def test_nesting_parent_and_request():
    trace.enable()
    with trace.span("ws.a"):
        with trace.span("ws.b"):
            with trace.span("ws.c"):
                pass
        with trace.span("ws.d"):
            pass
    with trace.span("ws.e"):
        pass
    # another thread's spans have their own parents and requests
    t = threading.Thread(target=lambda: trace.span("ws.t").__enter__().__exit__(None, None, None))
    with trace.span("ws.f"):
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    recs = {r.name: r for r in trace.records()}
    assert [r.name for r in trace.records()] == ["ws.c", "ws.b", "ws.d", "ws.a", "ws.e", "ws.t",
                                                 "ws.f"]
    assert {n: recs[n].parent for n in recs} == {
        "ws.a": None, "ws.b": "ws.a", "ws.c": "ws.b", "ws.d": "ws.a", "ws.e": None,
        "ws.t": None, "ws.f": None}
    assert len({recs["ws." + n].request for n in "abcd"}) == 1
    assert len({recs[n].request for n in ("ws.a", "ws.e", "ws.t", "ws.f")}) == 4
    for r in trace.records():
        assert r.end_ns >= r.start_ns


def _sleep(us):
    end = torch.zeros(())  # a little torch work inside the span
    t = time.perf_counter_ns() + us * 1000
    while time.perf_counter_ns() < t:
        end += 1


def test_span_times_are_on_the_profilers_clock():
    """Each record lies within 50 us of its range's event in the profile (a
    span whose thread the host preempted may miss: three tries)."""
    worst = None
    for _ in range(3):
        trace.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("ws.warm"):
                pass
            for i in range(10):
                with trace.span(f"ws.clock{i}"):
                    _sleep(200)
        events = {e.name(): e for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("ws.clock")}
        recs = [r for r in trace.records() if r.name.startswith("ws.clock")]
        assert len(recs) == 10 and set(events) == {r.name for r in recs}
        off = [max(abs(r.start_ns - events[r.name].start_ns()),
                   abs(r.end_ns - events[r.name].start_ns() - events[r.name].duration_ns()))
               for r in recs]
        worst = max(off)
        if worst < 50_000:
            break
    assert worst < 50_000, f"{worst} ns from the profiler's events"


def test_a_full_ring_counts_dropped(monkeypatch):
    assert trace.CAPACITY == 65_536
    monkeypatch.setattr(trace, "_ring", deque(maxlen=4))
    trace.enable()
    for i in range(6):
        with trace.span(f"ws.s{i}"):
            pass
    assert _names() == ["ws.s2", "ws.s3", "ws.s4", "ws.s5"]
    assert trace.counters()["trace.dropped"] == 2
    trace.reset()
    assert trace.records() == [] and trace.counters() == {}


def test_counters():
    trace.count("launch.sort")
    trace.count("launch.sort", 2)
    trace.count("graph.captures")
    assert trace.counters() == {"launch.sort": 3, "graph.captures": 1}


@pytest.fixture(scope="module", params=["decoded", "compressed"])
def renderer(request):
    if request.param == "compressed":
        args, kw = _codebook_blob(np.random.default_rng(7), n=500, k=23)
        cloud = load_gaussian_cloud(dumps_npz(*args, **kw), keep_compressed=True)
    else:
        cloud = make_cloud(np.random.default_rng(5), n=300)
    return GaussianRenderer(cloud, RasterConfig(), device="cpu")


def test_render_spans(renderer):
    """One request: the whole call, its prep, the uncompiled frame's stages
    (the decompression first for a compressed cloud) and the readback."""
    cam = make_camera(viewport=(64, 48))
    renderer.render(cam, (64, 48), with_diag=True)  # tracing off: nothing recorded
    assert trace.records() == []
    trace.enable()
    img = renderer.render(cam, (64, 48), with_diag=True)
    assert isinstance(img, np.ndarray) and img.shape == (48, 64, 3)
    recs = trace.records()
    stages = (("ws.frame.decompress",) if renderer.cloud.compressed else ()) + FRAME_STAGES
    assert sorted(r.name for r in recs) == sorted(
        ("ws.render", "ws.render.prep", "ws.render.readback") + stages)
    assert len({r.request for r in recs}) == 1
    parents = {r.name: r.parent for r in recs}
    assert parents.pop("ws.render") is None
    assert set(parents.values()) == {"ws.render"}
    # the phases in order, inside the whole call
    by = {r.name: r for r in recs}
    order = ("ws.render.prep",) + stages + ("ws.render.readback",)
    for a, b in zip(order, order[1:]):
        assert by[a].end_ns <= by[b].start_ns
    assert by["ws.render"].start_ns <= by["ws.render.prep"].start_ns
    assert by["ws.render.readback"].end_ns <= by["ws.render"].end_ns
    assert renderer.last_diag is renderer._last_diag and renderer.last_diag["num_visible"] > 0


class _Fake:
    def __init__(self, source):
        self.source = source


def test_graph_cache_counts_evictions():
    cache = graph.GraphCache()
    src = object()
    trace.enable()
    made = [cache.graph(src, (i,), lambda: _Fake(src)) for i in range(graph.GRAPH_CACHE + 3)]
    assert len(cache) == graph.GRAPH_CACHE
    assert trace.counters() == {"graph.evictions": 3}
    assert cache.graph(src, (graph.GRAPH_CACHE + 2,), lambda: _Fake(src)) is made[-1]
    assert trace.counters() == {"graph.evictions": 3}  # a hit drops nothing
    assert _names() == ["ws.graph.lookup"] * (graph.GRAPH_CACHE + 4)
