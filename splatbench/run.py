"""One run of one cell: set-up, a measured window, the check, one JSON line.

    python3 -m splatbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards.  The
run draws the scene and the views from the seed, hands them to
``websplat_tpu_torch``, warms up every shape the traffic uses, measures for
``--seconds``, reads the peak device memory, frees the program's state and
judges the window's outputs against the plain reference (``check.py``).
The last line of standard output is the result; the numbers compared,
each beside its limit, are the last lines of standard error and the last
key of the result.  With ``--trace 1`` the window, of at most
``TRACE_SECONDS``, runs under ``torch.profiler`` and the result carries
the cell's per-layer metrics in place of its end-to-end ones.

A cell whose ``chips`` is 1 runs in this process.  A cell on D > 1 chips
runs as D spawned ranks, one a card (``ranks.py``): each makes the whole
set-up on its card, the window starts when the slowest is ready, rank 0
ends it, and each judges its own frames; this process combines them:
views over all ranks and rank 0's window, the fullest card's peak, set-up
to the slowest rank's first timed step, and each compared number the
worst over the ranks.

It exits non-zero with no result where CUDA is absent or has fewer cards
than the cell asks for, where a module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``websplat_tpu`` is loaded at the end (in any
rank), and where a rank fails.
Build and kernel caches stay inside the checkout: the port builds into
``websplat_tpu_torch/_build``; Triton and torch extensions, if anything
loads them, use ``.splatbench_cache/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional, Tuple  # noqa: E402

import numpy as np  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".splatbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

FORBIDDEN = ("jax", "jaxlib", "flax", "websplat_tpu")
# the share of a traced window's graph launches whose kernel records the
# profiler may lose (their time is then missing from busy_s and the layers)
LOST_SHARE = 0.005
# a traced run profiles a window of at most this many seconds: the
# profile's records and their reduction grow with the window
TRACE_SECONDS = 10.0


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole (``websplat_tpu_torch`` is not
    ``websplat_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Ctx:
    """What a per-layer metric's reader sees (``metrics/<name>.py``)."""

    def __init__(self, cell, summary, counts, window, device_kind):
        self.cell, self.trace, self.counts = cell, summary, counts
        self.window, self.units = window, window.units
        self.device_kind = device_kind
        cfg = cell.config
        self.width, self.height = cfg["viewport"]
        tw, th = cfg["raster"]["tile_w"], cfg["raster"]["tile_h"]
        self.tiles = -(-self.width // tw) * -(-self.height // th)
        # the decode layer's work, where the kind has one (scenes/<kind>.py)
        codebooks = cell.kind().codebook_bytes(cfg["scene"])
        self.compressed = codebooks is not None
        self.codebook_bytes = codebooks or 0.0

    def layer_ms(self, layer_id: str):
        """Device ms per unit (view or frame) of a layer's kernels, or None
        where none of them ran."""
        s = self.trace.layer_s.get(layer_id, 0.0)
        return 1e3 * s / self.units if s > 0 and self.units else None

    def share(self, work, ms):
        """100 x the least time of ``work`` over ``ms``, or None."""
        from splatbench import roofline

        least = roofline.least_seconds(work, self.device_kind)
        if least is None or not ms or not self.counts:
            return None
        return 100.0 * 1e3 * least / ms

    @property
    def unit_ms(self) -> float:
        """The traced window's host time per unit, in ms."""
        return 1e3 * self.trace.window_s / self.units


def end_to_end(window, setup_s: float, peak_bytes: int):
    per = {
        "views_per_s": lambda: window.units / window.seconds,
        "peak_mem_mib": lambda: peak_bytes / 2**20,
        "setup_s": lambda: setup_s,
    }
    return per


@dataclasses.dataclass
class RankOut:
    """What one rank measured and judged (all of a one-chip run)."""

    marks: List[Tuple[str, float]]  # set-up stages, perf_counter times
    setup_s: float
    units: int
    seconds: float
    peak: int
    kind: str
    verdict: object  # check.Verdict
    totals: Optional[np.ndarray]  # views: each step's total_visible
    step_visible: Optional[np.ndarray]  # views: each step's summed num_visible
    stop_s: Optional[np.ndarray]  # views: each step's stop check, host seconds
    trace: Optional[dict] = None  # traced: busy_s, window_s, line, lost, and rank 0's
    metrics: Optional[dict] = None  # traced, rank 0: the per-layer metrics


def run_rank(cell, seed: int, seconds: float, trace_on: bool, dev, t_start: float,
             link=None, marks=None) -> RankOut:
    """Set-up, the window and the check of one process: the whole of a
    one-chip run, or one rank of a cell on several (``link``:
    ``ranks.Link``, its place among them; ``marks``: its set-up stages so
    far)."""
    import torch

    from splatbench import cameras, check, drivers, reference, registry, trace

    marks = list(marks or [("start", t_start)]) + [("imports", time.perf_counter())]
    cfg = cell.config
    w, h = cfg["viewport"]
    if dev.type == "cuda":
        torch.cuda.init()
        marks.append(("cuda init", time.perf_counter()))
    scene_kind = cell.kind()
    inputs = scene_kind.make(cfg["scene"], seed, dev)
    marks.append(("scene draw", time.perf_counter()))
    views = cameras.views(cell.traffic, seed, (w, h))
    cull = None
    if cfg.get("cull_headroom"):
        # the cull's capacity: the headroom times the largest share of
        # centres in the frustum over the views, counted by the benchmark
        scene = scene_kind.centres(inputs, dev)
        share = max(int(reference.frustum(scene, reference.make_view(v, w, h, scene.bounds()))
                        .sum()) for v in views) / scene.n
        cull = min(1.0, float(cfg["cull_headroom"]) * share)
        del scene
    # the peak from here on is the program's: the draw's buffers are freed
    drivers.free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("views and cull", time.perf_counter()))
    loop = drivers.LOOPS[cell.traffic["loop"]](cell, inputs, views, dev, cull)
    drivers.sync(dev)
    marks.append(("load and upload", time.perf_counter()))
    loop.warm()
    drivers.sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    if link is not None:  # the window starts when the slowest rank is ready
        marks.append(("the other ranks", link.latest(marks[-1][1], dev)))
    setup_s = marks[-1][1] - t_start
    sampled = check.sampled_units(cell, seed, len(views))
    kw = {} if link is None else dict(pre=trace_on)

    traced = None
    if trace_on:
        # a traced window whose profile lost the kernel records of more than
        # LOST_SHARE of its graph launches (on any rank) is made again, once
        for _ in range(2):
            prof = trace.profile()
            if link is not None:
                kw["stop"] = link.stop(min(seconds, TRACE_SECONDS))
            with prof:
                window = loop.window(min(seconds, TRACE_SECONDS), set(sampled), prof, **kw)
            summary = trace.summarize(prof, trace.load_layers(cell.data / "layers"))
            del prof
            lost = summary.lost > LOST_SHARE * summary.launches
            if not (lost if link is None else link.any(lost, dev)):
                break
        traced = dict(busy_s=summary.busy_s, window_s=summary.window_s, lost=lost,
                      line=trace.summary_line(summary), launches=summary.launches,
                      lost_launches=summary.lost)
    else:
        if link is not None:
            kw["stop"] = link.stop(seconds)
        window = loop.window(seconds, set(sampled), **kw)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    loop.release()
    del loop
    drivers.free(dev)

    verdict = check.judge(cell, inputs, views, window, sampled, seed, dev)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    metrics = None
    if trace_on and (link is None or link.rank == 0):
        ctx = Ctx(cell, summary, verdict.counts, window, kind)
        metrics = {}
        for m in cell.per_layer:
            value = registry.reader(cell.data, m.name)(ctx)
            if value is not None:
                metrics[m.name] = {"value": float(value), "unit": m.unit}
        traced.update(device_ops=summary.device_ops, idle_gaps=summary.idle_gaps,
                      unmatched=sorted(([k, v] for k, v in summary.unmatched.items()),
                                       key=lambda kv: -kv[1]))
    step_visible = None
    if window.totals is not None:
        per = window.diags.reshape(len(window.totals), -1, 5)
        step_visible = per[:, :, 1].astype(np.int64).sum(1)
    return RankOut(marks, setup_s, int(window.units), window.seconds, int(peak), kind, verdict,
                   window.totals, step_visible, window.stop_s, traced, metrics)


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device="cuda",
             t_start: float = None, patch=None):
    """One run of ``cell`` on ``device`` -> (the result dict, stderr lines).
    ``device`` "cpu" runs the program's plain path (for the tests).  A cell
    on several chips runs as that many ranks (``ranks.py``; ``patch``, a
    picklable function each rank calls first, lets a test break them)."""
    import torch

    t_start = T_START if t_start is None else t_start
    if cell.chips > 1:
        from splatbench import ranks

        return result_of(cell, ranks.run(cell, seed, seconds, trace_on, device, t_start, patch),
                         trace_on)
    return result_of(cell, [run_rank(cell, seed, seconds, trace_on, torch.device(device),
                                     t_start)], trace_on)


def _stages(marks) -> str:
    return ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:]))


def result_of(cell, parts: List[RankOut], trace_on: bool):
    """The result line's dict and the stderr lines of a run's ranks (one,
    or the cell's chips, in rank order)."""
    from splatbench import check

    lead = parts[0]
    extra, extra_failed, notes = {}, 0, []
    if lead.totals is not None:
        steps = {len(p.totals) for p in parts}
        if len(steps) == 1:
            visible = sum(p.step_visible for p in parts)
            gaps = np.stack([np.abs(p.totals - visible) for p in parts])
            extra["total_visible_gap"] = float(gaps.max(initial=0))
            extra_failed = int((gaps.max(0) > 0).sum()) * int(cell.traffic["views_per_step"])
        else:
            notes.append(f"the ranks ran {[len(p.totals) for p in parts]} steps")
            extra["total_visible_gap"] = float("inf")
    verdict = check.combine([p.verdict for p in parts], extra, extra_failed)
    verdict.notes += notes
    if len(parts) == 1:
        lines = ["set-up: " + _stages(lead.marks)]
    else:
        lines = [f"set-up, rank {r}: " + _stages(p.marks) for r, p in enumerate(parts)]
        lines += [f"stop checks, rank {r}: median {1e6 * np.median(p.stop_s):.3f} us, mean "
                  f"{1e6 * p.stop_s.mean():.3f}, max {1e6 * p.stop_s.max():.3f} a step over "
                  f"{len(p.stop_s)} steps" for r, p in enumerate(parts)]
    peak = max(p.peak for p in parts)
    units = sum(p.units for p in parts)
    result = {"correct": verdict.correct, "attempted": units, "failed": int(verdict.failed)}
    device_out = {"platform": "gpu" if lead.kind != "cpu" else "cpu", "kind": lead.kind,
                  "count": cell.chips, "memory_peak_bytes": peak}
    if trace_on:
        tr = lead.trace
        device_out.update(busy_s=sum(p.trace["busy_s"] for p in parts) / len(parts),
                          window_s=sum(p.trace["window_s"] for p in parts) / len(parts))
        result["metrics"] = lead.metrics
        result["device"] = device_out
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        result["unmatched_kernels"] = tr["unmatched"]
        lines += [p.trace["line"] if len(parts) == 1 else f"rank {r} {p.trace['line']}"
                  for r, p in enumerate(parts)]
        for r, p in enumerate(parts):
            if p.trace["lost"]:
                verdict.notes.append(("" if len(parts) == 1 else f"rank {r}: ")
                                     + f"the profiler lost kernel records of "
                                     f"{p.trace['lost_launches']} of {p.trace['launches']} graph "
                                     "launches")
                result["correct"] = False
    else:
        window = types.SimpleNamespace(units=units, seconds=lead.seconds)
        per = end_to_end(window, max(p.setup_s for p in parts), peak)
        result["metrics"] = {m.name: {"value": float(per[m.name]()), "unit": m.unit}
                             for m in cell.end_to_end}
        result["device"] = device_out
    result["correct"] = result["correct"] and verdict.correct
    counts = ", ".join(f"{k} {v:.1f}" for k, v in verdict.counts.items())
    lines.append(f"reference counts per checked frame: {counts}")
    lines += [f"note: {n}" for n in verdict.notes]
    checks = {k: {"value": verdict.numbers[k], "limit": verdict.limits.get(k, math.nan)}
              for k in verdict.numbers}
    lines += [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    result["checks"] = checks
    return result, lines


def main(argv=None) -> int:
    args = parse(argv)
    from splatbench import ranks, registry

    bench = registry.Bench.load()
    cell = bench.cell(args.workload)
    found = forbidden_modules()
    if found:
        print(f"splatbench: loaded at start: {found}", file=sys.stderr)
        return 3
    # a cell on several chips starts its ranks first: they import torch
    # while this process looks for the cards
    started = (ranks.Ranks(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
               if cell.chips > 1 else None)
    try:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"splatbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
                  file=sys.stderr)
            return 2
        if started is None:
            result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace))
        else:
            result, lines = result_of(cell, started.wait(), bool(args.trace))
    except ranks.RankFailed as e:
        print(f"splatbench: {e}", file=sys.stderr)
        return 4
    finally:
        if started is not None:
            started.stop()
    found = forbidden_modules()
    if found:
        print(f"splatbench: loaded by the run: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
