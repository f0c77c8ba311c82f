"""The traced window, reduced: device busy time, device time by layer, the
top device operations and the longest idle gaps by what the host was doing.

The window runs under ``torch.profiler`` (CPU and CUDA activities); the
harness marks it with the annotation ``WINDOW``, which starts after one
unit of work inside the profile (the profiler on the card's machine has
been seen to drop a window's first records).  Busy time is the union of the
device activity intervals (kernels, copies, sets) inside the window.  A
kernel is given to a layer by the layer tables (``layers/*.json``: regular
expressions over the kernel's name); a kernel that no table matches is
kept by name (``unmatched``), never dropped.  Each graph launch in the
window must have as many kernel records as the fullest one: a shortfall
means lost records, and ``Summary.lost`` counts the launches short of it.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

WINDOW = "splatbench.window"
TOP = 10  # entries of each breakdown list
GAP_LOOKBACK = 256  # host events searched back from a gap for the op around it


@dataclasses.dataclass(frozen=True)
class Layer:
    id: str  # the table's file name
    name: str  # the layer as PERF.md lists it
    patterns: Tuple[re.Pattern, ...]


def load_layers(directory: Path) -> List[Layer]:
    out = []
    for path in sorted(Path(directory).glob("*.json")):
        d = json.loads(path.read_text())
        out.append(Layer(path.stem, d["layer"], tuple(re.compile(p) for p in d["kernels"])))
    return out


def layers_of(name: str, layers: List[Layer]) -> List[str]:
    """The ids of the layers whose table matches a kernel name."""
    return [ly.id for ly in layers if any(p.search(name) for p in ly.patterns)]


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.replace("(anonymous namespace)", "{anon}")
    if name.startswith("void "):
        name = name[5:]
        depth = 0
        for i, ch in enumerate(name):
            depth += ch == "<"
            depth -= ch == ">"
            if ch == "(" and depth == 0:
                return name[:i]
    return name[:160]


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    layer_s: Dict[str, float]
    unmatched: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    kernels: int
    launches: int
    lost: int


def _events(prof):
    """(device events, host events) as (start_ns, end_ns, name, correlation)."""
    import torch

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.correlation_id())
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(rec)
        elif not _annotation(e):  # an annotation's span on the device timeline is no work
            dev.append(rec)
    return dev, host


def _annotation(e) -> bool:
    """A span of the benchmark's own (``record_function``), which the
    profiler also lays on the device timeline."""
    flag = getattr(e, "is_user_annotation", None)
    return (flag is not None and bool(flag())) or e.name().startswith("splatbench.")


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def summarize(prof, layers: List[Layer]) -> Summary:
    dev, host = _events(prof)
    spans = [(s, e) for s, e, n, _ in host if n == WINDOW]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} window annotations, not 1")
    w0, w1 = spans[0]
    dev = sorted((max(s, w0), min(e, w1), n, c) for s, e, n, c in dev if e > w0 and s < w1)
    if not dev:
        raise RuntimeError("the profiler recorded no device activity in the window")

    busy, end, gaps = 0, w0, []
    for s, e, _, _ in dev:
        if s > end:
            gaps.append((end, s))
        busy += max(0, e - max(s, end))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))

    layer_ns: Dict[str, float] = defaultdict(float)
    unmatched: Dict[str, float] = defaultdict(float)
    by_op: Dict[str, float] = defaultdict(float)
    kernels = Counter()
    for s, e, name, corr in dev:
        short = short_name(name)
        by_op[short] += e - s
        if not _is_kernel(name):
            continue
        kernels[corr] += 1
        ids = layers_of(name, layers)
        if len(ids) > 1:
            raise RuntimeError(f"kernel {short} matches the tables of {ids}")
        if ids:
            layer_ns[ids[0]] += e - s
        else:
            unmatched[short] += e - s

    # kernels per graph launch: each launch must hold the fullest launch's count
    launch_ids = {c for s, e, n, c in host if n.startswith("cudaGraphLaunch") and w0 <= s <= w1}
    per_launch = [kernels[c] for c in launch_ids]
    full = max(per_launch, default=0)
    lost = sum(1 for k in per_launch if k < full)

    host = sorted((s, e, n) for s, e, n, _ in host if n != WINDOW)
    starts = [h[0] for h in host]
    by_gap: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        best, best_len = "host: no recorded op", None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - GAP_LOOKBACK), -1):
            s, e, n = host[j]
            if e >= mid and (best_len is None or e - s < best_len):
                best, best_len = n, e - s
        by_gap[best] += g1 - g0

    ns = 1e-9
    top = lambda d: [[k, v * ns] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Summary(window_s=(w1 - w0) * ns, busy_s=busy * ns,
                   layer_s={k: v * ns for k, v in layer_ns.items()},
                   unmatched={k: v * ns for k, v in unmatched.items()},
                   device_ops=top(by_op), idle_gaps=top(by_gap), kernels=sum(kernels.values()),
                   launches=len(per_launch), lost=lost)


def profile():
    """A profiler of CPU and CUDA activity (where the card is present)."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def annotate(name: str):
    import torch

    return torch.profiler.record_function(name)


def summary_line(s: Summary) -> str:
    return (f"trace: window {s.window_s:.6f} s, busy {s.busy_s:.6f} s, {s.kernels} kernels in "
            f"{s.launches} graph launches ({s.lost} short of the fullest)")
