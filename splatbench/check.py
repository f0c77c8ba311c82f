"""How a run's output is judged (``correct``), and the reference's counts.

A cell's ``checks/<workload>.json`` states what is compared and each
number's limit (``PERF.md`` gives the readings each limit was set from):

- ``image_rmse``: over the sampled frames, the largest root-mean-square
  difference between the program's image and the reference's, over every
  pixel and channel;
- ``block_rmse``: the same over each ``block`` x ``block`` pixel block, the
  largest (a fault confined to a small part of a frame);
- ``visible_gap``: over every frame of the window whose view is among the
  checked views, the largest difference between the program's
  ``num_visible`` and the reference's count of visible splats;
- ``drops``: over every frame of the window, the sum of ``num_clamped``,
  ``num_dropped`` and ``num_culled_dropped`` (exact: limit 0);
- ``total_visible_gap`` (a views cell): over every step of the window and
  every rank, the largest difference between the step's ``total_visible``
  on that rank and the sum of every rank's per-view ``num_visible`` in the
  step (exact: limit 0; it checks the collective).

The reference's scene is the scene kind's own decode of the run's raw
inputs (``reference_scenes``): one a run, or, of a time-dependent kind
(one with ``at``), one for each scene time among the views compared.

The sampled frames are drawn from the seed among the window's first cycle
(a pass cell: one pass of the pool, with a frame from each half of it, the
rest anywhere; a views cell: the same, of each rank's passes; a walk: the
first loop).  The reference renders after the window has closed, the peak
memory has been read and the program's state is freed; on several ranks
each rank judges its own frames on its card, and ``combine`` takes the
worst of each number over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from splatbench import reference, seeds

DIAG = ("num_instances", "num_visible", "num_clamped", "num_dropped", "num_culled_dropped")


def settings(config: dict) -> reference.Settings:
    r = config["raster"]
    return reference.Settings(alpha_threshold=float(r["alpha_threshold"]),
                              transmittance_eps=float(r["transmittance_eps"]),
                              tile=(int(r["tile_w"]), int(r["tile_h"])))


def sampled_units(cell, seed: int, n_views: int) -> List[int]:
    """The window units whose images are compared."""
    rng = seeds.rng(seed, "sample")
    n = int(cell.check["frames"])
    t = cell.traffic
    if t["loop"] in ("pass", "views"):
        # a views cell: each rank's pass of views_per_step / chips views, the
        # same units on every rank
        step = int(t["views_per_pass"] if t["loop"] == "pass" else t["views_per_step"])
        v = step if t["loop"] == "pass" else step // cell.chips
        p = int(rng.integers(n_views // step))
        half = v // 2
        picks = [int(rng.integers(half)), half + int(rng.integers(v - half))]
        rest = [j for j in range(v) if j not in picks]
        picks += [int(j) for j in rng.permutation(rest)[:max(0, n - 2)]]
        return sorted(p * v + j for j in picks[:n])
    return sorted(int(u) for u in rng.choice(n_views, size=min(n, n_views), replace=False))


def counted_views(cell, seed: int, n_views: int) -> List[int]:
    """The views whose visible counts are checked: all of them, or a sample
    of ``count_views`` drawn from the seed."""
    k = int(cell.check["count_views"])
    if n_views <= k:
        return list(range(n_views))
    return sorted(int(i) for i in seeds.rng(seed, "sample").choice(n_views, k, replace=False))


def block_rmse(err2: torch.Tensor, block: int) -> float:
    h, w = err2.shape
    ph, pw = -h % block, -w % block
    sq = torch.nn.functional.pad(err2, (0, pw, 0, ph))
    cnt = torch.nn.functional.pad(torch.ones_like(err2), (0, pw, 0, ph))
    s = sq.reshape(-1, block, sq.shape[1] // block, block).sum((1, 3))
    c = cnt.reshape(-1, block, sq.shape[1] // block, block).sum((1, 3))
    return float(torch.sqrt((s / c).max()))


@dataclasses.dataclass
class Verdict:
    numbers: Dict[str, float]
    limits: Dict[str, float]
    failed: int
    counts: Dict[str, float]  # the reference's counts, mean over the sampled frames
    notes: List[str]

    @property
    def correct(self) -> bool:
        return (not self.notes and set(self.numbers) == set(self.limits)
                and all(self.numbers[k] <= self.limits[k] for k in self.limits))


def reference_scenes(cell, inputs: dict, views, wanted, device):
    """(scene, its views) over the views ``wanted``: the kind's reference
    decode, made once; where the kind has ``at``, the scene at each
    distinct time among the views, made once each, in order of time (one
    at a time on the device)."""
    kind = cell.kind()
    scene = kind.reference(inputs, device)
    if not hasattr(kind, "at"):
        yield scene, sorted(wanted)
        return
    at = {}
    for i in sorted(wanted):
        at.setdefault(views[i].t, []).append(i)
    for t in sorted(at):
        yield kind.at(scene, t), at[t]


def judge(cell, inputs: dict, views, window, sampled: List[int], seed: int, device,
          dtype=torch.float32, program_images: Optional[Dict[int, torch.Tensor]] = None,
          program_diags: Optional[np.ndarray] = None) -> Verdict:
    """Compares the window's outputs with the reference (module docstring)."""
    dev = torch.device(device)
    w, h = cell.config["viewport"]
    st = settings(cell.config)
    limits = {k: float(v) for k, v in cell.check["limits"].items()}
    notes = []
    diags = window.diags if program_diags is None else program_diags
    images = window.samples if program_images is None else program_images

    # only the checked views this window rendered can differ from the reference
    shown = set(np.unique(window.view_of).tolist())
    checked = [i for i in counted_views(cell, seed, len(views)) if i in shown]
    for u in sampled:
        if u not in images:
            notes.append(f"frame {u} was not rendered in the window ({window.units} frames)")
    drawn = [u for u in sampled if u in images]
    of = {u: int(window.view_of[u]) for u in drawn}
    ref_vis, frames = {}, {}
    for scene, idx in reference_scenes(cell, inputs, views, set(checked) | set(of.values()), dev):
        made = {i: reference.make_view(views[i], w, h, scene.bounds()) for i in idx}
        ref_vis.update({i: reference.num_visible(scene, made[i], st, dtype)
                        for i in checked if i in made})
        for u in drawn:
            if of[u] in made:
                frame = reference.render(scene, made[of[u]], st, dtype)
                err2 = ((images[u].to(dev).float() - frame.image) ** 2).sum(-1) / 3.0
                frames[u] = (float(torch.sqrt(err2.mean())),
                             block_rmse(err2, int(cell.check["block"])), frame.counts)
        del scene
    on = np.isin(window.view_of, checked)
    expect = np.array([ref_vis.get(int(i), 0) for i in window.view_of], np.int64)
    gap = np.abs(diags[:, 1].astype(np.int64) - expect) * on
    lost = diags[:, 2:5].astype(np.int64).sum(1)
    bad = (gap > limits.get("visible_gap", 0)) | (lost > 0)

    rmse, brmse, counts = ([frames[u][k] for u in drawn] for k in range(3))
    for u in drawn:
        if frames[u][0] > limits["image_rmse"] or frames[u][1] > limits["block_rmse"]:
            bad[u] = True
    if lost.any():
        cols = diags[:, 2:5].astype(np.int64)
        notes.append("frames with lost splats: " + ", ".join(
            f"{name} in {int((cols[:, k] > 0).sum())} (max {int(cols[:, k].max())})"
            for k, name in enumerate(DIAG[2:])))
    numbers = dict(image_rmse=max(rmse, default=float("inf")),
                   block_rmse=max(brmse, default=float("inf")),
                   visible_gap=float(gap.max(initial=0)), drops=float(lost.sum()))
    mean = {k: float(np.mean([c[k] for c in counts])) for k in counts[0]} if counts else {}
    return Verdict(numbers, limits, int(bad.sum()), mean, notes)


def combine(verdicts: List[Verdict], extra: Dict[str, float], extra_failed: int = 0) -> Verdict:
    """One verdict of several ranks' (rank order): each number the worst over
    them, ``extra`` numbers besides (the collective's), failures summed, the
    counts rank 0's; one rank's verdict and no extra is returned as it is."""
    if len(verdicts) == 1 and not extra:
        return verdicts[0]
    numbers = {k: max(v.numbers[k] for v in verdicts) for k in verdicts[0].numbers}
    numbers.update(extra)
    notes = [n if len(verdicts) == 1 else f"rank {r}: {n}"
             for r, v in enumerate(verdicts) for n in v.notes]
    return Verdict(numbers, verdicts[0].limits, sum(v.failed for v in verdicts) + extra_failed,
                   verdicts[0].counts, notes)
