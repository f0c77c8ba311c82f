"""The readings each limit of ``checks/<workload>.json`` is set from.

    python3 -m splatbench.control --workload <cell> --seeds 101 102 ... \
        [--control 3] [--seconds 2]

For each seed, in one process: a run of the cell as the benchmark makes it
(a short window at the cell's own load; ``run.run_cell``), whose compared
numbers are the program's readings; and, for the first ``--control``
seeds, the control: the reference computed in bfloat16 (the precision
below the configuration's float32) put in the program's place, judged by
the same comparison.  Prints one JSON line per run and, last, the lower
reading of each number (the largest over the program's seeds) and the
upper one (the smallest over the control's).  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from splatbench import cameras, check, drivers, reference, registry


def control_numbers(cell, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The compared numbers with the reference in ``dtype`` in the
    program's place, over one cycle of the traffic's views (of a views
    cell: each rank's units of one cycle, judged as that rank judges them,
    each number the worst over the ranks; the collective is exact, as the
    reference's total is its own sum)."""
    dev = torch.device(device)
    w, h = cell.config["viewport"]
    kind = cell.kind()
    inputs = kind.make(cell.config["scene"], seed, dev)
    views = cameras.views(cell.traffic, seed, (w, h))
    st = check.settings(cell.config)
    checked = check.counted_views(cell, seed, len(views))
    sampled = check.sampled_units(cell, seed, len(views))
    t = cell.traffic
    if t["loop"] == "views":
        n, v = len(views) // cell.chips, int(t["views_per_step"])
        view_of = [drivers.step_views(v, v // cell.chips, len(views) // v, r, n)
                   for r in range(cell.chips)]
    else:
        view_of = [np.arange(len(views))]
    shown = {int(of[u]) for of in view_of for u in sampled}
    vis, frames = {}, {}
    for scene, idx in check.reference_scenes(cell, inputs, views, set(checked) | shown, dev):
        made = {i: reference.make_view(views[i], w, h, scene.bounds()) for i in idx}
        vis.update({i: reference.num_visible(scene, made[i], st, dtype)
                    for i in checked if i in made})
        frames.update({i: reference.render(scene, made[i], st, dtype).image
                       for i in shown if i in made})
        del scene
    windows = []
    for of in view_of:
        diags = np.zeros((len(of), 5), np.int64)
        diags[:, 1] = [vis.get(int(i), 0) for i in of]
        images = {u: frames[int(of[u])] for u in sampled}
        windows.append(drivers.Window(0.0, len(of), of, diags, images, []))
    del frames
    drivers.free(dev)
    verdicts = [check.judge(cell, inputs, views, window, sampled, seed, dev) for window in windows]
    extra = {"total_visible_gap": 0.0} if t["loop"] == "views" else {}
    verdict = check.combine(verdicts, extra)
    return dict(verdict.numbers, correct=verdict.correct)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    from splatbench import run

    cell = registry.Bench.load().cell(args.workload)
    program, control = [], []
    for k, seed in enumerate(args.seeds):
        result, _ = run.run_cell(cell, seed, args.seconds, False, t_start=0.0)
        nums = {n: c["value"] for n, c in result["checks"].items()}
        program.append(nums)
        print(json.dumps(dict(side="program", seed=seed, correct=result["correct"], **nums)),
              flush=True)
        if k < args.control:
            c = control_numbers(cell, seed, "cuda")
            control.append(c)
            print(json.dumps(dict(side="control", seed=seed, **c)), flush=True)
    names = list(program[0])
    lower = {n: max(p[n] for p in program) for n in names}
    upper = {n: min(c[n] for c in control) for n in names} if control else {}
    print(json.dumps(dict(workload=args.workload, lower=lower, upper=upper,
                          seeds=len(program), control_seeds=len(control))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
