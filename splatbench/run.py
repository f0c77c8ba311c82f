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

It exits non-zero with no result where CUDA is absent or has fewer cards
than the cell asks for, and where a module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``websplat_tpu`` is loaded at the end.
Build and kernel caches stay inside the checkout: the port builds into
``websplat_tpu_torch/_build``; Triton and torch extensions, if anything
loads them, use ``.splatbench_cache/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

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
        sc = cfg["scene"]
        self.compressed = sc["kind"] == "c3dgs_npz"
        # the two codebooks as the decode reads them: 6 f32 per covariance
        # entry, 48 f16 per SH entry
        self.codebook_bytes = (24.0 * sc["geometry_codebook"] + 96.0 * sc["sh_codebook"]
                               if self.compressed else 0.0)

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


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device="cuda",
             t_start: float = None):
    """One run of ``cell`` on ``device`` -> (the result dict, stderr lines).
    ``device`` "cpu" runs the program's plain path (for the tests)."""
    import torch

    from splatbench import cameras, check, drivers, reference, registry, trace

    t_start = T_START if t_start is None else t_start
    marks = [("start", t_start), ("imports", time.perf_counter())]
    dev = torch.device(device)
    cfg = cell.config
    w, h = cfg["viewport"]
    if dev.type == "cuda":
        torch.cuda.init()
        marks.append(("cuda init", time.perf_counter()))
    inputs = registry.scene_maker(cfg["scene"]["kind"])(cfg["scene"], seed, dev)
    marks.append(("scene draw", time.perf_counter()))
    views = cameras.views(cell.traffic, seed, (w, h))
    cull = None
    if cfg.get("cull_headroom"):
        # the cull's capacity: the headroom times the largest share of
        # centres in the frustum over the views, counted by the benchmark
        scene = reference.positions(inputs, dev)
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
    setup_s = marks[-1][1] - t_start
    sampled = check.sampled_units(cell, seed, len(views))

    if trace_on:
        # a traced window whose profile lost the kernel records of more than
        # LOST_SHARE of its graph launches is made again, once
        for _ in range(2):
            prof = trace.profile()
            with prof:
                window = loop.window(min(seconds, TRACE_SECONDS), set(sampled), prof)
            summary = trace.summarize(prof, trace.load_layers(cell.data / "layers"))
            del prof
            if summary.lost <= LOST_SHARE * summary.launches:
                break
    else:
        window = loop.window(seconds, set(sampled))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    loop.release()
    del loop
    drivers.free(dev)

    verdict = check.judge(cell, inputs, views, window, sampled, seed, dev)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_out = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    stages = (f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:]))
    lines = ["set-up: " + ", ".join(stages)]
    result = {"correct": verdict.correct, "attempted": int(window.units),
              "failed": int(verdict.failed)}
    if trace_on:
        ctx = Ctx(cell, summary, verdict.counts, window, kind)
        metrics = {}
        for m in cell.per_layer:
            value = registry.reader(cell.data, m.name)(ctx)
            if value is not None:
                metrics[m.name] = {"value": float(value), "unit": m.unit}
        device_out.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["metrics"] = metrics
        result["device"] = device_out
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
        result["unmatched_kernels"] = sorted(([k, v] for k, v in summary.unmatched.items()),
                                             key=lambda kv: -kv[1])
        lines.append(trace.summary_line(summary))
        if summary.lost > LOST_SHARE * summary.launches:
            verdict.notes.append(f"the profiler lost kernel records of {summary.lost} of "
                                 f"{summary.launches} graph launches")
            result["correct"] = False
    else:
        per = end_to_end(window, setup_s, peak)
        result["metrics"] = {m.name: {"value": float(per[m.name]()), "unit": m.unit}
                             for m in cell.end_to_end}
        result["device"] = device_out
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
    import torch

    from splatbench import registry

    bench = registry.Bench.load()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"splatbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"splatbench: loaded at start: {found}", file=sys.stderr)
        return 3
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace))
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
