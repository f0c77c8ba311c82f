"""24 slots with overflow on, and a viewport of 129 tiles on an axis,
against the JAX frame (the gates of tests/test_torch_frames.py).  JAX takes
its unfused slot-stream path for both (its fused frontend stops at 16
slots and 127 tiles per axis); the port's frontend runs them as it runs
every frame."""

import pytest

from tests.test_torch_frames import CASES, check_frames, render_both
from websplat_tpu_torch import RasterConfig


@pytest.fixture(scope="module", params=["slots24", "wide"])
def frames(request):
    return request.param, render_both(request.param)


def test_frame_matches_jax(frames):
    case, f = frames
    check_frames(f, case)


def test_wide_config_keeps_the_tiles(frames):
    """The frame really is past the TPU frontend's limits."""
    case, _ = frames
    w, h, kw = CASES[case]
    cfg = RasterConfig(**kw)
    tx, _ = cfg.tiles_for(w, h)
    assert (cfg.tile_slots > 16) if case == "slots24" else (tx > 127)
