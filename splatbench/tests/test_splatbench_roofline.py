"""The reference's counts against a hand count, and the work arithmetic."""

import math

import numpy as np
import pytest
import torch

from splatbench import cameras, reference, roofline
from splatbench.scenes import cloud

SCENE = dict(kind="cloud", splats=200, sh_degree=3, extent=0.5, log_scale=[-2.2, 0.3],
             opacity_logits=dict(low_share=0.2, low=[-1.0, 1.0], high=[4.0, 0.5]),
             sh_dc_range=[-0.5, 2.0], sh_rest_sigma=0.1)


def _hand(p, width, height, st):
    """Pixel by pixel, splat by splat, as web-splat blends: the image, the
    pairs blended, the (tile, splat) pairs whose tile holds a pixel centre
    with a <= a_max, and those of them no later than the tile's last
    pixel stop."""
    n = p["idx"].numel()
    order = np.argsort(p["depth"].numpy(), kind="stable")
    f = {k: p[k].double().numpy() for k in ("px", "py", "ha", "hb", "hc", "op", "a_max")}
    rgb = p["rgb"].double().numpy()
    img = np.zeros((height, width, 3))
    pairs, cover, tile_stop = 0, set(), {}
    tw, th = st.tile
    for y in range(height):
        for x in range(width):
            t, c, stop = 1.0, np.zeros(3), n
            tile = (y // th, x // tw)
            for r, i in enumerate(order):
                dx, dy = x + 0.5 - f["px"][i], y + 0.5 - f["py"][i]
                a = f["ha"][i] * dx * dx + f["hb"][i] * dx * dy + f["hc"][i] * dy * dy
                if a <= f["a_max"][i]:
                    cover.add((r, tile))
                if a >= 2.0 * reference.CUTOFF or t <= st.transmittance_eps:
                    continue
                alpha = min(0.99, math.exp(-a) * f["op"][i])
                c += alpha * t * rgb[i]
                t *= 1.0 - alpha
                pairs += 1
                if t <= st.transmittance_eps:
                    stop = r
            tile_stop[tile] = max(tile_stop.get(tile, -1), stop)
            img[y, x] = c
    reads = sum(1 for r, tile in cover if r <= tile_stop[tile])
    return img, pairs, len(cover), reads, n


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_counts_match_a_hand_count(seed):
    width, height = 40, 28
    inputs = cloud.make(SCENE, seed, "cpu")
    scene = cloud.reference(inputs, "cpu")
    st = reference.Settings(alpha_threshold=1 / 255, transmittance_eps=4e-3, tile=(8, 8))
    cam = cameras.look_at(cameras.orbit_point(0.9, 0.3 * seed, 0.1), (0, 0, 0), (width, height))
    view = reference.make_view(cam, width, height, scene.bounds())
    frame = reference.render(scene, view, st)
    p = reference.preprocess(scene, view, st)
    img, pairs, instances, reads, visible = _hand(p, width, height, st)
    assert pairs > 200 and visible > 20 and reads < instances  # some tiles stop early
    c = frame.counts
    assert (c["pairs"], c["instances"], c["tile_reads"], c["visible"]) == (
        pairs, instances, reads, visible)
    assert c["splats"] == 200 and visible <= c["frustum"] <= 200
    np.testing.assert_allclose(frame.image.double().numpy(), img, atol=2e-5)


def test_work_arithmetic():
    c = dict(splats=1000.0, frustum=800.0, visible=600.0, instances=900.0, tile_reads=700.0,
             pairs=5000.0)
    s = roofline.stream_work(c, c["splats"])
    assert s.bytes == 12 * 1000 + 28 * 800 + 96 * 600 + 20 * 900
    assert s.f32 == 44 * 1000 + (198 + 144) * 600 and s.sfu == 600
    assert roofline.sort_work(c).bytes == 40 * 900
    r = roofline.raster_work(c, 64, 32, 8)
    assert r == roofline.Work(16 * 700 + 4 * 9 + 12 * 64 * 32, 21 * 5000, 5000)
    d = roofline.decompress_work(c, 4096.0)
    assert d.bytes == 12 * 1000 + (10 + 136) * 800 + 4096 and d.f32 == 44 * 1000 + 11 * 800
    f = roofline.frame_work(c, 64, 32, 8, True, 4096.0)
    parts = [roofline.stream_work(c, 800.0), roofline.sort_work(c), r, d]
    assert f.bytes == sum(x.bytes for x in parts)


def test_least_time():
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.least_seconds(roofline.Work(3.35e12), kind) == 1.0
    assert roofline.least_seconds(roofline.Work(0.0, 67e12), kind) == 1.0
    assert roofline.least_seconds(roofline.Work(1.0), "another card") is None
