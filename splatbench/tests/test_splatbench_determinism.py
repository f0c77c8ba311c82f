"""The scene, the views and the sample of checked frames are functions of
the seed alone."""

import io
import json

import numpy as np
import pytest

from splatbench import cameras, check, seeds
from splatbench.scenes import c3dgs_npz, cloud
from splatbench.tests import fixture

BIG_SEEDS = (0, 2**31 + 12345, 2**40 + 7)


def _scene(name, splats=2000):
    sc = json.loads((fixture.DATA / "configs" / f"{name}.json").read_text())["scene"]
    sc["splats"] = splats
    return sc


def _npz_arrays(blob):
    z = np.load(io.BytesIO(blob))
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("seed", BIG_SEEDS)
def test_cloud_is_a_function_of_the_seed(seed):
    sc = _scene("bonsai-1.2m")
    a, b, c = cloud.make(sc, seed, "cpu"), cloud.make(sc, seed, "cpu"), cloud.make(sc, seed + 1,
                                                                                   "cpu")
    for k in ("xyz", "opacity", "cov", "sh"):
        np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k])
    assert a["xyz"].dtype == np.float32 and a["cov"].dtype == np.float16


@pytest.mark.parametrize("seed", BIG_SEEDS)
def test_npz_is_a_function_of_the_seed(seed):
    sc = _scene("c3dgs-10m")
    a, b, c = (_npz_arrays(c3dgs_npz.make(sc, s, "cpu")["npz"]) for s in (seed, seed, seed + 1))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["xyz"], c["xyz"])
    assert a["gaussian_indices"].max() < sc["geometry_codebook"]


@pytest.mark.parametrize("traffic", ["pass8", "close8", "walk"])
def test_views_are_a_function_of_the_seed(traffic):
    t = json.loads((fixture.DATA / "traffic" / f"{traffic}.json").read_text())
    vp = (1200, 799)
    a, b, c = (cameras.views(t, s, vp) for s in (5, 5, 6))
    n = t["pool"] if t["loop"] == "pass" else t["frames_per_loop"]
    assert len(a) == n
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.position, y.position)
        np.testing.assert_array_equal(x.quat, y.quat)
    assert not np.array_equal(a[0].position, c[0].position)
    for cam in a:  # each camera looks at the target, its rotation proper
        np.testing.assert_allclose(cam.rotation @ cam.rotation.T, np.eye(3), atol=1e-5)
        fwd = -cam.position / np.linalg.norm(cam.position)
        np.testing.assert_allclose(cam.rotation[2], fwd, atol=1e-5)
    d = [float(np.linalg.norm(cam.position)) for cam in a]
    if t["loop"] == "pass":
        np.testing.assert_allclose(d, t["distance"], rtol=1e-5)
    else:  # a closed loop: the last pose steps to the first as the others do
        steps = [np.linalg.norm(a[i + 1].position - a[i].position) for i in range(n - 1)]
        close = np.linalg.norm(a[0].position - a[-1].position)
        assert close < 2.0 * max(steps)


def test_walk_passes_through_its_keyframes():
    pts = np.random.default_rng(0).normal(size=(8, 3))
    path = cameras.catmull_rom_loop(pts, 800)
    np.testing.assert_allclose(path[::100], pts, atol=1e-12)


def test_streams_are_independent():
    assert seeds.torch_seed(3, "scene") != seeds.torch_seed(3, "views")
    assert seeds.torch_seed(2**40, "scene") < 2**63
    with pytest.raises(ValueError):
        seeds.rng(1, "other")


def test_sample_is_drawn_from_the_seed_and_covers_both_halves(tmp_path):
    bench = fixture.build(tmp_path)
    cell = bench.cell("bonsai-1.2m.pass8")
    for seed in range(20):
        units = check.sampled_units(cell, seed, 64)
        assert units == check.sampled_units(cell, seed, 64)
        assert len(units) == cell.check["frames"]
        passes = {u // 8 for u in units}
        assert len(passes) == 1 and passes.pop() < 8
        halves = {(u % 8) // 4 for u in units}
        assert halves == {0, 1}
    walk = bench.cell("bonsai-1.2m.walk")
    units = check.sampled_units(walk, 3, 600)
    assert all(0 <= u < 600 for u in units) and len(set(units)) == len(units)
