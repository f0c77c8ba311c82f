"""The port's command-line apps on a tiny dataset, on the CPU (``--device
cpu``): the flows of tests/test_apps.py, the refusal to fall back without
CUDA, and the render app's PNGs against the JAX render app's of the same
dataset."""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from tests.synth import make_camera, random_quats
from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.io.loader import load_gaussian_cloud
from websplat_tpu_torch.io.ply import write_ply
from websplat_tpu_torch.models.scene import Scene, SceneCamera, Split
from websplat_tpu_torch.utils import trace
from websplat_tpu_torch.utils.image import psnr, read_png

torch.set_num_threads(2)
CPU = ["--device", "cpu"]


@pytest.fixture()
def dataset(tmp_path):
    """Tiny PLY + cameras.json dataset on disk (tests/test_apps.py)."""
    rng = np.random.default_rng(42)
    n = 80
    write_ply(str(tmp_path / "point_cloud.ply"),
              rng.normal(size=(n, 3)).astype(np.float32) * 0.5,
              rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3,
              rng.normal(size=n).astype(np.float32),
              rng.uniform(-4, -2.5, size=(n, 3)).astype(np.float32),
              random_quats(rng, n))
    cams = [SceneCamera.from_perspective(make_camera(azimuth=i, viewport=(64, 48)), f"img{i}", i,
                                         (64, 48), Split.TRAIN).to_json_dict()
            for i in range(6)]
    (tmp_path / "cameras.json").write_text(json.dumps(cams))
    return tmp_path


def test_render_app(dataset):
    from websplat_tpu_torch.apps.render import main

    out = dataset / "renders"
    main([str(dataset / "point_cloud.ply"), "--out", str(out), "--splits", "test,train", *CPU])
    assert len(os.listdir(out / "test")) == 1 and len(os.listdir(out / "train")) == 5
    assert read_png(str(out / "train" / "00000.png")).shape == (48, 64, 3)


def test_render_app_psnr_self_and_tile_slots(dataset, capsys):
    """--psnr-vs against its own output reports inf dB; --tile-slots 40
    (overflow off: 40 >= overflow_slots) renders too."""
    from websplat_tpu_torch.apps.render import main

    ply, out = str(dataset / "point_cloud.ply"), str(dataset / "r1")
    main([ply, "--out", out, "--splits", "test", *CPU])
    main([ply, "--out", str(dataset / "r2"), "--splits", "test", "--psnr-vs", out, *CPU])
    assert "mean PSNR vs reference = inf dB" in capsys.readouterr().out
    main([ply, "--out", str(dataset / "r3"), "--splits", "test", "--tile-slots", "40", *CPU])
    assert read_png(str(dataset / "r3" / "test" / "00000.png")).shape == (48, 64, 3)


def test_render_app_hdr(dataset):
    from websplat_tpu_torch.apps.render import main

    out = dataset / "renders_hdr"
    main([str(dataset / "point_cloud.ply"), "--out", str(out), "--splits", "test", "--hdr", *CPU])
    img = read_png(str(out / "test" / "00000.png"))
    assert img.dtype == np.uint16 and img.shape == (48, 64, 3)


def test_render_app_matches_jax_app(dataset):
    """The same dataset through both render apps: every PNG >= 50 dB."""
    from websplat_tpu.apps.render import main as jax_main
    from websplat_tpu_torch.apps.render import main

    ply = str(dataset / "point_cloud.ply")
    main([ply, "--out", str(dataset / "t"), *CPU])
    jax_main([ply, "--out", str(dataset / "j")])
    for split in ("test", "train"):
        names = sorted(os.listdir(dataset / "j" / split))
        assert names == sorted(os.listdir(dataset / "t" / split)) and names
        for name in names:
            a, b = (read_png(str(dataset / d / split / name)).astype(np.float32) / 255.0
                    for d in ("t", "j"))
            assert a.max() > 0.1 and psnr(a, b) >= 50.0, (split, name)


def test_measure_app(dataset, capsys):
    from websplat_tpu_torch.apps.measure import main

    fps = main([str(dataset / "point_cloud.ply"), "--width", "64", "--height", "64",
                "--samples", "2", *CPU])
    out = capsys.readouterr().out
    assert "average FPS:" in out and "5 train views at 64x64" in out and fps > 0
    passes = next(ln for ln in out.splitlines() if ln.startswith("ms per pass: "))
    assert len(passes.split(": ")[1].split(", ")) == 2


def test_video_app(dataset):
    from websplat_tpu_torch.apps.video import main

    out = dataset / "frames"
    main([str(dataset / "point_cloud.ply"), "--out", str(out), "--fps", "2", "--duration", "1.5",
          "--width", "64", "--height", "48", *CPU])
    assert sorted(os.listdir(out)) == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]


def test_scene_autodiscovery(dataset):
    from websplat_tpu_torch.apps.common import find_scene_file

    assert find_scene_file(str(dataset / "point_cloud.ply")) == str(dataset / "cameras.json")
    sub = dataset / "a" / "b"
    sub.mkdir(parents=True)
    (sub / "pc.ply").write_bytes(b"ply")
    assert find_scene_file(str(sub / "pc.ply")) == str(dataset / "cameras.json")


@pytest.mark.parametrize("app", ["render", "measure", "video", "viewer"])
def test_apps_default_to_the_card(dataset, app):
    """Without --device an app runs on the card: on a host without CUDA it
    raises instead of rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for CPU-only hosts")
    import importlib

    main = importlib.import_module(f"websplat_tpu_torch.apps.{app}").main
    args = [str(dataset / "point_cloud.ply"), "--out", str(dataset / "x")]
    if app in ("measure", "viewer"):
        args = args[:1] + (["--port", "0"] if app == "viewer" else [])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)


def _viewer(dataset, w, h, **kw):
    from websplat_tpu_torch.apps.viewer import ViewerState

    cloud = load_gaussian_cloud(str(dataset / "point_cloud.ply"))
    scene = Scene.from_json(str(dataset / "cameras.json"))
    return ViewerState(cloud, scene, w, h, RasterConfig(), device="cpu", **kw)


def test_viewer_smoke(dataset):
    """Boot the HTTP viewer, poke every endpoint, verify input changes
    state."""
    from websplat_tpu_torch.apps.viewer import make_handler

    state = _viewer(dataset, 64, 48)
    trace.enable()  # as main() does, for /stats's host times
    render_thread = threading.Thread(target=state.render_loop, daemon=True)
    render_thread.start()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.read()

    def post(obj):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/input",
                                     data=json.dumps(obj).encode())
        urllib.request.urlopen(req, timeout=10).read()

    try:
        assert b"viewer" in get("/")
        deadline = time.time() + 120
        while time.time() < deadline and not state.frame_png:
            time.sleep(0.2)
        assert get("/frame.png")[:4] == b"\x89PNG"
        stats = json.loads(get("/stats"))
        assert stats["num_visible"] > 0 and len(stats["cameras"]) == 6
        # the CPU frame's prep and readback; no graph is replayed on the CPU
        host = stats["host_ms"]
        assert host["prep"] > 0 and host["readback"] > 0 and host["launch"] is None
        assert host["capture"] is None
        # the counters and a capture's span reach /stats as they are recorded
        with trace.span("ws.graph.capture"):
            time.sleep(0.002)
        trace.count("graph.captures")
        trace.count("graph.evictions", 2)
        trace.count("trace.dropped")
        after = json.loads(get("/stats"))
        assert after["host_ms"]["capture"] >= 2.0
        assert after["graph_captures"] == stats["graph_captures"] + 1
        assert after["graph_evictions"] == stats["graph_evictions"] + 2
        assert after["trace_dropped"] == stats["trace_dropped"] + 1
        for ev in ({"type": "rotate", "dx": 40, "dy": 5},
                   {"type": "setting", "name": "bg", "value": "#ff0000"},
                   {"type": "snap", "id": 2}, {"type": "save_view"},
                   {"type": "tracking_shot"}):
            post(ev)
        with pytest.raises(urllib.error.HTTPError):
            post({"type": "zoom"})  # malformed: answers 400
        time.sleep(1.0)
        assert state.saved_cameras and state.settings["bg"] == (1.0, 0.0, 0.0)
    finally:
        server.shutdown()
        state.stop = True
        render_thread.join(timeout=60)
        trace.enable(False)


def test_viewer_view_keys_and_tristate(dataset):
    """View-selection keys (lib.rs:741-787) and touch forwarding."""
    state = _viewer(dataset, 64, 48)
    assert state.handle_view_key("2") and state.current_view == 2
    assert state.animation is not None
    state.animation = None
    assert state.handle_view_key("PageUp") and state.current_view == 3
    assert state.handle_view_key("PageDown") and state.current_view == 2
    assert state.handle_view_key("n") and state.handle_view_key("r")
    assert not state.handle_view_key("9") and not state.handle_view_key("w")
    ctl = state.controller
    ctl.process_touch(1, (10.0, 10.0), "started")
    ctl.process_touch(2, (30.0, 10.0), "started")
    ctl.process_touch(2, (40.0, 10.0), "moved")
    assert ctl.scroll != 0.0 or ctl.shift.any() or ctl.rotation.any()


def test_viewer_lazy_redraw(dataset):
    """An idle viewer (capped walltime, decayed inputs) stops re-rendering
    (lib.rs:829-838)."""
    state = _viewer(dataset, 32, 16)
    state.walltime = 5.0
    t = threading.Thread(target=state.render_loop, daemon=True)
    t.start()
    deadline = time.time() + 60
    while time.time() < deadline and state.lazy_skips < 3:
        time.sleep(0.1)
    state.stop = True
    t.join(timeout=60)
    assert state.lazy_skips >= 3 and state.frame_png
