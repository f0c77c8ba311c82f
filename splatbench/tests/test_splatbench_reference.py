"""The frozen reference against the port's plain CPU frame, and its own
decode of a c3dgs npz against the port's loader (the test may import both;
the reference imports nothing of the port)."""

import json

import numpy as np
import pytest
import torch

from splatbench import cameras, check, drivers, reference
from splatbench.scenes import c3dgs_npz, cloud
from splatbench.tests import fixture


def _config(name, splats):
    c = json.loads((fixture.DATA / "configs" / f"{name}.json").read_text())
    c["scene"]["splats"] = splats
    return c


def _port_frame(kind, inputs, config, cam, width, height):
    from websplat_tpu_torch.render.renderer import GaussianRenderer

    pc = kind.program(inputs, config)
    r = GaussianRenderer(pc, drivers.raster_config(config, 1.0 if config.get("cull_headroom")
                                                   else None), device="cpu")
    img = r.render(drivers.program_camera(cam, (width, height)), (width, height), with_diag=True)
    return torch.from_numpy(img), dict(r._last_diag)


@pytest.mark.parametrize("name,distance", [("bonsai-1.2m", 3.0), ("c3dgs-10m", 3.0),
                                           ("c3dgs-10m", 0.45)])
def test_reference_against_the_port(name, distance):
    width, height = 128, 96
    config = _config(name, 20000)
    kind = cloud if name.startswith("bonsai") else c3dgs_npz
    inputs = kind.make(config["scene"], 4, "cpu")
    scene = kind.reference(inputs, "cpu")
    st = check.settings(config)
    for k, az in enumerate((0.4, 2.5)):
        cam = cameras.look_at(cameras.orbit_point(distance, az, 0.2 * k), (0, 0, 0),
                              (width, height))
        img, diag = _port_frame(kind, inputs, config, cam, width, height)
        frame = reference.render(scene, reference.make_view(cam, width, height, scene.bounds()),
                                 st)
        rmse = float(torch.sqrt(((img - frame.image) ** 2).mean()))
        assert rmse < 2e-3, rmse
        assert diag["num_visible"] == frame.counts["visible"]
        assert diag["num_dropped"] == diag["num_clamped"] == diag["num_culled_dropped"] == 0
        assert frame.counts["pairs"] > frame.counts["instances"] > 0


def test_reference_decodes_the_npz_as_the_port_does():
    from websplat_tpu_torch.io.loader import load_gaussian_cloud

    sc = _config("c3dgs-10m", 5000)["scene"]
    blob = c3dgs_npz.make(sc, 9, "cpu")["npz"]
    ours = c3dgs_npz.decode(blob, "cpu")
    port = load_gaussian_cloud(blob, keep_compressed=False)
    idx = torch.arange(ours.n)
    cov, sh = ours.cov_rows(idx), ours.sh_rows(idx)
    np.testing.assert_array_equal(ours.xyz.numpy(), port.xyz)
    np.testing.assert_allclose(ours.opacity.numpy(), port.opacity.astype(np.float32),
                               rtol=1e-3, atol=1e-4)  # the port keeps f16
    np.testing.assert_allclose(cov.numpy(), port.cov.astype(np.float32), rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(sh.numpy(), port.sh.astype(np.float32), rtol=1e-3, atol=1e-3)
    assert ours.compressed and ours.sh_deg == 3
