"""The timing arithmetic (a rate over the whole window, a tail over all
frames) and the trace's reduction."""

import types

import numpy as np
import torch

from splatbench import drivers, registry, run, trace


def _walk(frame_s):
    return drivers.Window(float(sum(frame_s)), len(frame_s), np.zeros(len(frame_s), int),
                          np.zeros((len(frame_s), 5)), {}, list(frame_s))


def _pass(pass_s, views=8):
    w = _walk(pass_s)
    w.units = views * len(pass_s)
    return w


def _frame(frame_s):
    """The walk's per-layer frame metrics (``metrics/walk_frame*.py``) of a window."""
    ctx = types.SimpleNamespace(window=_walk(frame_s))
    return {m: (lambda m=m: registry.reader(registry.HERE, m)(ctx))
            for m in ("walk_frame_ms", "walk_frame_p95_ms")}


def test_rate_and_tail_are_over_the_whole_window():
    frames = [0.002] * 900 + [0.004] * 100
    per = run.end_to_end(_walk(frames), 7.5, 3 * 2**20)
    f = _frame(frames)
    assert abs(f["walk_frame_ms"]() - 1e3 * sum(frames) / 1000) < 1e-9
    assert abs(f["walk_frame_p95_ms"]() - 4.0) < 1e-9  # the slowest tenth sets the 95th
    assert per["peak_mem_mib"]() == 3.0 and per["setup_s"]() == 7.5
    p = run.end_to_end(_pass([0.006] * 100), 0, 0)
    assert abs(p["views_per_s"]() - 800 / 0.6) < 1e-6


def test_one_stall_moves_every_timing_metric():
    base = [0.002] * 1000
    stalled = list(base)
    stalled[400:480] = [0.007] * 80  # the card stalls for 0.56 s: 80 slow frames
    a, b = _frame(base), _frame(stalled)
    assert b["walk_frame_ms"]() > 1.1 * a["walk_frame_ms"]()
    assert b["walk_frame_p95_ms"]() > 2 * a["walk_frame_p95_ms"]()
    pa, pb = run.end_to_end(_pass(base), 0, 0), run.end_to_end(_pass(stalled), 0, 0)
    assert pb["views_per_s"]() < 0.9 * pa["views_per_s"]()


class _Ev:
    def __init__(self, start, end, name, corr=0, dev=False):
        self._s, self._e, self._n, self._c, self._d = start, end, name, corr, dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def name(self):
        return self._n

    def correlation_id(self):
        return self._c

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._n == trace.WINDOW


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


def test_trace_summary(tmp_path):
    (tmp_path / "sort.json").write_text('{"layer": "sort", "kernels": ["sort_kernel"]}')
    layers = trace.load_layers(tmp_path)
    ev = [
        _Ev(0, 1000, trace.WINDOW), _Ev(0, 1000, trace.WINDOW, dev=True),
        _Ev(100, 110, "cudaGraphLaunch", corr=1), _Ev(500, 510, "cudaGraphLaunch", corr=2),
        _Ev(50, 120, "aten::copy_"),
        _Ev(120, 300, "void ws::sort_kernel<1>(int*)", 1, True),
        _Ev(250, 400, "void other_kernel(float*)", 1, True),
        _Ev(600, 700, "void ws::sort_kernel<1>(int*)", 2, True),
        _Ev(700, 750, "Memcpy DtoH (Device -> Pageable)", 3, True),
        _Ev(900, 1200, "void ws::sort_kernel<1>(int*)", 4, True),  # clipped to the window
    ]
    s = trace.summarize(_Prof(ev), layers)
    assert abs(s.window_s - 1e-6) < 1e-15
    assert abs(s.busy_s - (280 + 150 + 100) * 1e-9) < 1e-15
    assert abs(s.layer_s["sort"] - (180 + 100 + 100) * 1e-9) < 1e-15
    assert list(s.unmatched) == ["other_kernel"]
    assert s.launches == 2 and s.lost == 1  # launch 2 kept one kernel of launch 1's two
    gaps = dict(s.idle_gaps)
    assert abs(gaps["aten::copy_"] - 120e-9) < 1e-15  # [0, 120): the copy covers its middle
    assert s.device_ops[0][0] == "ws::sort_kernel<1>"


def test_short_name():
    assert trace.short_name("void ws::k<a<b>, 2>(int (*)[3], float)") == "ws::k<a<b>, 2>"
    assert trace.short_name("Memset (Device)") == "Memset (Device)"
    assert trace.short_name("void at::(anonymous namespace)::f<1>(int)") == "at::{anon}::f<1>"
