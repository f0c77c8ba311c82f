"""A cell on several chips runs as one spawned rank a chip (``ranks.py``),
here as two gloo ranks on the CPU at the fixture's size; a one-chip cell
stays in the run's own process.

- The views loop over two ranks renders, for each view, the image and the
  diagnostics that the one-process pass loop renders for it (the same
  operations on the same data on the CPU: bit-equal), and each step's
  ``total_visible`` is the sum of both ranks' counts.
- A rank that raises, or is killed, in the window ends the run: it raises
  with no result and leaves no process behind.
- A one-chip cell starts no process and no ``torch.distributed`` world.
"""

import dataclasses
import functools
import multiprocessing
import os
import signal
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from splatbench import drivers, ranks, run
from splatbench.tests import fixture

SEED = 77


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return fixture.build(tmp_path_factory.mktemp("bench"))


def _views_cell(bench, chips=2):
    return dataclasses.replace(bench.cell("tiny-c3dgs-10m.views4"), chips=chips)


def _children():
    """The processes whose parent is this one."""
    me, out = os.getpid(), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            out.append(int(pid))
    return out


def _record(out_dir: Path, loop_name: str) -> None:
    """Each window of ``loop_name`` saves its units' views, diagnostics,
    totals and images; every unit of the window's first cycle is sampled."""
    from splatbench import check

    loop = getattr(drivers, loop_name)
    window = loop.window

    def sampled(cell, seed, n_views):
        return list(range(n_views // (cell.chips if cell.traffic["loop"] == "views" else 1)))

    def recorded(self, *args, **kw):
        w = window(self, *args, **kw)
        rank = self.group.rank if loop_name == "ViewsLoop" else 0
        torch.save(dict(view_of=w.view_of, diags=w.diags, totals=w.totals,
                        images={u: t.clone() for u, t in w.samples.items()}),
                   out_dir / f"{loop_name}-{rank}.pt")
        return w

    check.sampled_units = sampled
    loop.window = recorded


def test_views_loop_over_two_ranks_matches_the_pass_loop(bench, tmp_path, monkeypatch):
    result, lines = run.run_cell(_views_cell(bench), SEED, 0.0, False, device="cpu",
                                 t_start=time.perf_counter(),
                                 patch=functools.partial(_record, tmp_path, "ViewsLoop"))
    assert result["correct"] is True, lines
    assert result["checks"]["total_visible_gap"]["value"] == 0
    from splatbench import check

    monkeypatch.setattr(check, "sampled_units", check.sampled_units)
    monkeypatch.setattr(drivers.PassLoop, "window", drivers.PassLoop.window)
    # the same pool in passes of each rank's views: one cycle of it
    views = _views_cell(bench)
    per = views.traffic["views_per_step"] // views.chips
    monkeypatch.setattr(drivers, "MAX_PASSES", views.traffic["pool"] // per)
    traffic = dict(views.traffic, loop="pass", views_per_pass=per)
    _record(tmp_path, "PassLoop")
    run.run_cell(dataclasses.replace(bench.cell("tiny-c3dgs-10m.pass8"), traffic=traffic), SEED,
                 60.0, False, device="cpu", t_start=time.perf_counter())
    one = torch.load(tmp_path / "PassLoop-0.pt", weights_only=False)
    pool = len(one["view_of"])
    image_of = {int(one["view_of"][u]): img for u, img in one["images"].items()}
    diag_of = {int(v): one["diags"][u] for u, v in enumerate(one["view_of"])}
    assert sorted(image_of) == list(range(pool))
    seen = set()
    visible = 0
    for r in range(2):
        got = torch.load(tmp_path / f"ViewsLoop-{r}.pt", weights_only=False)
        for u, img in got["images"].items():
            view = int(got["view_of"][u])
            seen.add(view)
            assert torch.equal(img, image_of[view]), (r, u, view)
            np.testing.assert_array_equal(got["diags"][u], diag_of[view])
        per = got["diags"].reshape(len(got["totals"]), -1, 5)
        visible = visible + per[:, :, 1].astype(np.int64).sum(1)
    assert seen == set(range(pool))  # each view on one rank, once a cycle
    for r in range(2):
        got = torch.load(tmp_path / f"ViewsLoop-{r}.pt", weights_only=False)
        np.testing.assert_array_equal(got["totals"], visible)


def _fail(how: str) -> None:
    """Rank 1 raises, or kills itself, at its third step of the window."""
    run_step = drivers.ViewsLoop.run
    calls = []

    def broken(self, i):
        calls.append(i)
        if self.group.rank == 1 and len(calls) == drivers.WARM_PASSES + 3:
            if how == "raises":
                raise RuntimeError("rank 1 breaks")
            os.kill(os.getpid(), signal.SIGKILL)
        return run_step(self, i)

    drivers.ViewsLoop.run = broken


@pytest.mark.parametrize("how", ["raises", "killed"])
def test_a_failing_rank_ends_the_run(bench, capsys, how):
    t = time.monotonic()
    with pytest.raises(ranks.RankFailed, match="rank 1"):
        run.run_cell(_views_cell(bench), SEED, 5.0, False, device="cpu",
                     t_start=time.perf_counter(), patch=functools.partial(_fail, how))
    assert time.monotonic() - t < 60.0
    assert capsys.readouterr().out == ""
    assert multiprocessing.active_children() == []
    assert _children() == []


def test_one_chip_cell_starts_no_process_and_no_world(bench, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a one-chip cell started a process")

    monkeypatch.setattr(multiprocessing.process.BaseProcess, "start", refuse)
    result, lines = run.run_cell(bench.cell("tiny-c3dgs-10m.pass8"), SEED, 0.5, False,
                                 device="cpu", t_start=time.perf_counter())
    assert result["correct"] is True, lines
    assert result["device"]["count"] == 1
    assert not torch.distributed.is_initialized()
    assert _children() == []
