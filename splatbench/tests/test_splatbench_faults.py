"""The harness, its look for a card skipped, driven through a whole run with
the timed path broken underneath: ``correct`` comes out false for each
fault the cells can have (a step that returns its state unchanged, half of
a pass left out, an answer altered where it is produced)."""

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
