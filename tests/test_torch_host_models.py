"""The port's host layer (models/scene.py, models/animation.py,
models/controller.py, utils/stopwatch.py): the checks of tests/test_scene.py,
test_animation.py and test_stopwatch.py run on the port's modules, and the
port's outputs equal the JAX package's on the same inputs."""

import json
import time

import numpy as np
import pytest

from websplat_tpu.models import animation as janim
from websplat_tpu.models import controller as jctl
from websplat_tpu.models import scene as jscene
from tests import synth as jsynth
from tests.test_scene import make_scene_json
from websplat_tpu_torch import synth as tsynth
from websplat_tpu_torch.models.animation import (Animation, TrackingShot, Transition, smoothstep,
                                                 unroll)
from websplat_tpu_torch.models.controller import CameraController
from websplat_tpu_torch.models.scene import Scene, SceneCamera, Split
from websplat_tpu_torch.utils.gmath import quat_to_mat
from websplat_tpu_torch.utils.stopwatch import FrameClock, RingBuffer, StageStopwatch


def cams_on_circle(n=6, r=3.0, synth=tsynth):
    return [synth.make_camera(distance=r, azimuth=2 * np.pi * i / n, viewport=(64, 64))
            for i in range(n)]


def _same_camera(a, b, atol=0.0):
    np.testing.assert_allclose(a.position, b.position, atol=atol, rtol=0)
    np.testing.assert_allclose(a.rotation, b.rotation, atol=atol, rtol=0)
    assert a.projection.__dict__ == pytest.approx(b.projection.__dict__, abs=atol)


# --- scene (tests/test_scene.py) ------------------------------------------

def test_split_assignment():
    scene = Scene.from_json(make_scene_json(17))
    cams = scene.cameras()
    assert len(cams) == 17
    for i, c in enumerate(cams):
        assert c.split == (Split.TEST if i % 8 == 0 else Split.TRAIN)
    assert len(scene.cameras(Split.TEST)) == 3 and len(scene.cameras(Split.TRAIN)) == 14


def test_duplicate_ids_removed_and_extend():
    data = json.loads(make_scene_json(4))
    data.append(dict(data[0]))
    assert Scene.from_json(json.dumps(data)).num_cameras() == 4
    data = json.loads(make_scene_json(5))
    pts = np.array([e["position"] for e in data])
    d = np.sqrt((((pts[:, None] - pts[None]) ** 2).sum(-1)).max())
    assert Scene.from_json(json.dumps(data)).extend() == pytest.approx(d, rel=1e-5)


def test_nearest_camera():
    scene = Scene.from_json(make_scene_json(9))
    c0 = scene.cameras()[0]
    assert scene.nearest_camera(np.asarray(c0.position)) == c0.id
    assert scene.nearest_camera(np.asarray(c0.position), Split.TEST) in {
        c.id for c in scene.cameras(Split.TEST)}


def test_to_perspective_det_fix():
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) > 0:
        q[:, 0] = -q[:, 0]
    cam = SceneCamera(id=0, img_name="x", width=640, height=480,
                      position=np.zeros(3, np.float32), rotation=q.astype(np.float32),
                      fx=500.0, fy=500.0)
    p = cam.to_perspective()
    r = quat_to_mat(p.rotation)
    assert np.linalg.det(r) == pytest.approx(1.0, abs=1e-4)
    fixed = q.copy()
    fixed[:, 1] = -fixed[:, 1]
    np.testing.assert_allclose(r, fixed.T, atol=1e-5)
    assert (p.projection.znear, p.projection.zfar) == pytest.approx((0.01, 100.0))


def test_perspective_roundtrip():
    c = Scene.from_json(make_scene_json(3)).cameras()[1]
    back = SceneCamera.from_perspective(c.to_perspective(), c.img_name, c.id,
                                        (c.width, c.height), c.split)
    np.testing.assert_allclose(back.position, c.position, atol=1e-5)
    np.testing.assert_allclose(back.fx, c.fx, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(back.rotation), np.asarray(c.rotation), atol=1e-4)


def test_scene_equal_to_jax():
    """Both packages parse the same cameras.json into the same cameras,
    splits, extend, nearest cameras, perspective cameras and JSON dicts."""
    src = make_scene_json(19, seed=3)
    t, j = Scene.from_json(src), jscene.Scene.from_json(src)
    assert t.extend() == j.extend() and t.num_cameras() == j.num_cameras()
    for a, b in zip(t.cameras(), j.cameras()):
        assert a.split.value == b.split.value and a.to_json_dict() == b.to_json_dict()
        _same_camera(a.to_perspective(), b.to_perspective())
    for pos in np.random.default_rng(1).normal(size=(5, 3)) * 3:
        assert t.nearest_camera(pos) == j.nearest_camera(pos)
        assert t.nearest_camera(pos, Split.TEST) == j.nearest_camera(pos, jscene.Split.TEST)


# --- animation and controller (tests/test_animation.py) -------------------

def test_smoothstep_and_transition():
    assert (smoothstep(0.0), smoothstep(1.0), smoothstep(-1.0), smoothstep(2.0)) == (0, 1, 0, 1)
    assert smoothstep(0.5) == pytest.approx(0.5)
    cams = cams_on_circle(2)
    tr = Transition(cams[0], cams[1])
    np.testing.assert_allclose(tr.sample(0.0).position, cams[0].position, atol=1e-6)
    np.testing.assert_allclose(tr.sample(1.0).position, cams[1].position, atol=1e-6)


def test_tracking_shot_control_points_loop_and_continuity():
    cams = cams_on_circle(5)
    shot = TrackingShot(cams)
    assert shot.num_control_points() == 9
    for i, c in enumerate(cams):
        np.testing.assert_allclose(shot.sample(((i + 1) % 5) / 5).position, c.position, atol=1e-4)
    np.testing.assert_allclose(shot.sample(0.0).position, shot.sample(1.0 - 1e-7).position,
                               atol=1e-3)
    prev = shot.sample(0.0)
    for v in np.linspace(1e-3, 0.999, 97):
        cur = shot.sample(float(v))
        assert np.linalg.norm(cur.position - prev.position) < 1.0
        assert np.linalg.norm(cur.rotation) == pytest.approx(1.0, abs=1e-5)
        prev = cur


def test_unroll_and_animation_progress():
    q = np.array([0.9, 0.1, 0, 0]) / np.linalg.norm([0.9, 0.1, 0, 0])
    rots = unroll([q, -q, q, -q])
    assert all(np.dot(rots[i], rots[i - 1]) >= 0 for i in range(1, 4)) and rots[0][0] > 0
    cams = cams_on_circle(3)
    anim = Animation(duration=3.0, looping=False, sampler=TrackingShot(cams))
    anim.update(1.0)
    assert anim.progress() == pytest.approx(1 / 3)
    anim.update(5.0)
    assert anim.done()
    loop = Animation(duration=2.0, looping=True, sampler=TrackingShot(cams))
    loop.update(3.0)
    assert 0.0 <= loop.progress() < 1.0 and not loop.done()


def test_controller_orbit_zoom_decay():
    cam = tsynth.make_camera(distance=4.0, viewport=(64, 64))
    ctl = CameraController(speed=1.0, sensitivity=1.0)
    ctl.center = np.zeros(3)
    ctl.left_mouse_pressed = True
    ctl.process_mouse(30.0, 0.0)
    d0 = np.linalg.norm(cam.position - ctl.center)
    for _ in range(10):
        ctl.update_camera(cam, 1 / 60)
    assert np.linalg.norm(cam.position - ctl.center) == pytest.approx(d0, rel=1e-3)
    fwd = quat_to_mat(cam.rotation)[2]
    to_center = (ctl.center - cam.position) / np.linalg.norm(cam.position - ctl.center)
    assert float(fwd @ to_center) == pytest.approx(1.0, abs=1e-3)
    for _ in range(200):
        ctl.update_camera(cam, 1 / 60)
    assert np.linalg.norm(ctl.rotation) == 0.0 and ctl.scroll == 0.0
    ctl.process_scroll(5.0)
    for _ in range(5):
        ctl.update_camera(cam, 1 / 60)
    assert np.linalg.norm(cam.position) < d0


def test_controller_touch_gestures():
    ctl = CameraController()
    ctl.process_touch(1, (10.0, 10.0), "started")
    ctl.process_touch(1, (20.0, 15.0), "moved")
    assert ctl.rotation[0] != 0
    ctl.process_touch(2, (50.0, 50.0), "started")
    ctl.process_touch(2, (60.0, 60.0), "moved")
    assert ctl.scroll != 0 or ctl._last_pinch_distance is not None
    ctl.process_touch(1, (0, 0), "ended")
    ctl.process_touch(2, (0, 0), "ended")
    assert len(ctl._touches) == 0


def test_animation_and_controller_equal_to_jax():
    """Tracking-shot samples, eased transitions and a run of controller
    inputs give the same cameras in both packages."""
    tc, jc = cams_on_circle(5), cams_on_circle(5, synth=jsynth)
    ts, js = TrackingShot(tc), janim.TrackingShot(jc)
    for v in np.linspace(0.0, 0.999, 23):
        _same_camera(ts.sample(float(v)), js.sample(float(v)))
        _same_camera(Transition(tc[0], tc[3]).sample(float(v)),
                     janim.Transition(jc[0], jc[3]).sample(float(v)))
    cams = [tsynth.make_camera(distance=4.0, viewport=(64, 64)),
            jsynth.make_camera(distance=4.0, viewport=(64, 64))]
    ctls = [CameraController(), jctl.CameraController()]
    for ctl, cam in zip(ctls, cams):
        ctl.center = np.zeros(3)
        ctl.reset_to_camera(cam)
        ctl.left_mouse_pressed = True
        ctl.process_mouse(25.0, -7.0)
        ctl.process_keyboard("w", True)
        ctl.process_scroll(1.5)
        ctl.process_touch(3, (5.0, 5.0), "started")
        ctl.process_touch(3, (9.0, 2.0), "moved")
        for _ in range(20):
            ctl.update_camera(cam, 1 / 30)
    _same_camera(cams[0], cams[1])
    np.testing.assert_array_equal(ctls[0].center, ctls[1].center)


# --- stopwatch (tests/test_stopwatch.py) ----------------------------------

def test_ring_buffer():
    rb = RingBuffer(4)
    for i in range(6):
        rb.push(i)
    assert len(rb) == 4 and rb.to_list() == [2, 3, 4, 5]
    rb = RingBuffer(4)
    rb.push(1)
    rb.push(2)
    assert rb.to_list() == [1, 2]


def test_stage_stopwatch_cpu():
    sw = StageStopwatch("cpu")
    with sw.stage("a"):
        time.sleep(0.01)
    with sw.stage("b"):
        pass
    m = sw.take_measurements()
    assert m["a"] >= 0.01 and "b" in m
    assert sw.take_measurements() == {}


def test_frame_clock_ema():
    fc = FrameClock(alpha=0.5)
    fc.tick()
    time.sleep(0.01)
    assert 0 < fc.tick() < 200
    assert len(fc.history) == 1
