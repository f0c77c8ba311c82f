"""The harness, its look for a card skipped, driven through a whole run with
the timed path broken underneath: ``correct`` comes out false for each
fault the cells can have (a step that returns its state unchanged, half of
a pass left out, an answer altered where it is produced, and, in the views
cell over two gloo ranks, the exchange between them left out)."""

import dataclasses
import functools
import types

import pytest
import torch

from splatbench import run
from splatbench.tests import fixture


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return fixture.build(tmp_path_factory.mktemp("bench"))


def _stale(fn):
    first = []

    def broken(*args, **kw):
        if not first:
            first.append(fn(*args, **kw))
        return first[0]

    return broken


def _half_pass(fn):
    def broken(cloud, blocks, *args, **kw):
        v = blocks.shape[0]
        images, diags = fn(cloud, blocks[: v // 2], *args, **kw)
        full_i = torch.zeros((v,) + tuple(images.shape[1:]), dtype=images.dtype)
        full_d = torch.zeros((v,) + tuple(diags.shape[1:]), dtype=diags.dtype)
        full_i[: v // 2], full_d[: v // 2] = images, diags
        return full_i, full_d

    return broken


def _altered(fn, passes: bool):
    def broken(*args, **kw):
        out = fn(*args, **kw)
        img = out[0] if passes else out
        img[..., 8:16, 8:16, :] += 0.25
        return out

    return broken


PASS_FAULTS = {"stale": _stale, "half": _half_pass, "altered": lambda f: _altered(f, True)}
WALK_FAULTS = {"stale": _stale, "altered": lambda f: _altered(f, False)}


def _run(bench, name):
    result, lines = run.run_cell(bench.cell(name), 77, 3.0, False, device="cpu", t_start=0.0)
    return result, lines


@pytest.mark.parametrize("fault", sorted(PASS_FAULTS))
def test_pass_faults_are_caught(bench, monkeypatch, fault):
    from websplat_tpu_torch.render import graph

    monkeypatch.setattr(graph, "render_blocks", PASS_FAULTS[fault](graph.render_blocks))
    result, lines = _run(bench, "tiny-bonsai-1.2m.pass8")
    assert result["correct"] is False, lines


@pytest.mark.parametrize("fault", sorted(WALK_FAULTS))
def test_walk_faults_are_caught(bench, monkeypatch, fault):
    from websplat_tpu_torch.render.renderer import GaussianRenderer

    monkeypatch.setattr(GaussianRenderer, "render", WALK_FAULTS[fault](GaussianRenderer.render))
    result, lines = _run(bench, "tiny-bonsai-1.2m.walk")
    assert result["correct"] is False, lines


def _no_exchange(dist):
    """``torch.distributed`` as the view-parallel step sees it, with its
    ``all_reduce`` doing nothing: each rank keeps its own count."""
    names = {k: getattr(dist, k) for k in dir(dist) if not k.startswith("__")}
    return types.SimpleNamespace(**dict(names, all_reduce=lambda *args, **kw: None))


def _break_views(fault: str) -> None:
    """Each rank breaks the view-parallel step before its set-up."""
    from websplat_tpu_torch.parallel import multiview

    if fault == "no_exchange":
        multiview.dist = _no_exchange(multiview.dist)
    elif fault == "stale":
        multiview.make_view_parallel_renderer = _stale_steps(multiview.make_view_parallel_renderer)
    else:
        multiview.render_blocks = PASS_FAULTS[fault](multiview.render_blocks)


def _stale_steps(make):
    def broken(*args, **kw):
        return _stale(make(*args, **kw))

    return broken


@pytest.mark.parametrize("fault", ["altered", "half", "no_exchange", "stale"])
def test_views_faults_are_caught(bench, fault):
    cell = dataclasses.replace(bench.cell("tiny-c3dgs-10m.views4"), chips=2)
    result, lines = run.run_cell(cell, 77, 1.0, False, device="cpu", t_start=0.0,
                                 patch=functools.partial(_break_views, fault))
    assert result["correct"] is False, lines
