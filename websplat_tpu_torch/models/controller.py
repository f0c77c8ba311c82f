"""Orbit camera controller: a copy of ``websplat_tpu/models/controller.py``
(web-splat controller.rs).

Device-agnostic input-accumulation + per-frame update math, reimplemented
from controller.rs: WASD/QE/space keyboard axes (:86-125), mouse rotate/pan
(:127-138), log-space scroll zoom (:140-143, :256-258), two-finger touch
rotate/pinch/pan (:145-228), alt-tilt (:274-278), axis-locked orbit around
``center`` with a pole-crossing guard (:253-314), exponential input decay
(:297-312), and ``reset_to_camera`` re-centering on the view ray (:239-251).

The windowing layer is NOT ported (winit/egui are GPU-stack idioms); any
host UI can feed ``process_*`` and call ``update_camera`` per frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from websplat_tpu_torch.models.camera import PerspectiveCamera
from websplat_tpu_torch.utils.gmath import mat_to_quat, quat_to_mat


def _quat_mul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dtype=np.float64,
    )


def _axis_angle(axis, angle):
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0:
        return np.array([1.0, 0, 0, 0])
    axis = axis / n
    h = angle / 2.0
    return np.concatenate([[np.cos(h)], axis * np.sin(h)])


def _rotate(q, v):
    return quat_to_mat(q.astype(np.float32)).astype(np.float64) @ np.asarray(v, np.float64)


def _look_at(direction, up):
    """cgmath Quaternion::look_at(dir, up): rotation mapping world so that
    `dir` becomes the view forward; equals the camera-from-world rotation
    with rows [right, up', dir] (right-handed orthonormalization)."""
    f = np.asarray(direction, np.float64)
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float64)
    s = np.cross(up, f)
    s_n = np.linalg.norm(s)
    if s_n < 1e-12:
        s = np.array([1.0, 0.0, 0.0])
    else:
        s = s / s_n
    u = np.cross(f, s)
    m = np.stack([s, u, f], axis=0)  # rows: camera axes in world
    return mat_to_quat(m.astype(np.float32)).astype(np.float64)


def closest_point(orig, direction, point):
    """controller.rs:317-324."""
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    lhs = np.asarray(point, np.float64) - np.asarray(orig, np.float64)
    return np.asarray(orig, np.float64) + d * float(lhs @ d)


def _angle_short(a, b):
    """controller.rs:326-333."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    cosv = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    ang = float(np.arccos(np.clip(cosv, -1.0, 1.0)))
    return np.pi - ang if ang > np.pi / 2 else ang


@dataclasses.dataclass
class CameraController:
    speed: float = 1.0
    sensitivity: float = 1.0
    center: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float64))
    up: Optional[np.ndarray] = None

    amount: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float64))
    shift: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2, np.float64))
    rotation: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float64))
    scroll: float = 0.0

    left_mouse_pressed: bool = False
    right_mouse_pressed: bool = False
    alt_pressed: bool = False
    user_input: bool = False

    # touch gesture state (controller.rs:13-45)
    _touches: dict = dataclasses.field(default_factory=dict)
    _last_pinch_distance: Optional[float] = None
    _last_touch_center: Optional[Tuple[float, float]] = None

    # --- input accumulation -------------------------------------------------
    def process_keyboard(self, key: str, pressed: bool) -> bool:
        """Keys: w/a/s/d/arrows, q/e roll, space/shift up-down
        (controller.rs:86-125)."""
        amount = 1.0 if pressed else 0.0
        key = key.lower()
        if key in ("w", "up"):
            self.amount[2] += amount
        elif key in ("s", "down"):
            self.amount[2] -= amount
        elif key in ("a", "left"):
            self.amount[0] -= amount
        elif key in ("d", "right"):
            self.amount[0] += amount
        elif key == "q":
            self.rotation[2] += amount / self.sensitivity
        elif key == "e":
            self.rotation[2] -= amount / self.sensitivity
        elif key == "space":
            self.amount[1] += amount
        elif key == "shift":
            self.amount[1] -= amount
        else:
            return False
        self.user_input = True
        return True

    def process_mouse(self, dx: float, dy: float) -> None:
        if self.left_mouse_pressed:
            self.rotation[0] += dx
            self.rotation[1] += dy
            self.user_input = True
        if self.right_mouse_pressed:
            self.shift[1] -= dx
            self.shift[0] += dy
            self.user_input = True

    def process_scroll(self, dy: float) -> None:
        self.scroll += -dy
        self.user_input = True

    def process_touch(self, touch_id: int, position, phase: str) -> None:
        """phase: started | moved | ended | cancelled (controller.rs:145-228)."""
        if phase == "started":
            self._touches[touch_id] = tuple(position)
        elif phase == "moved" and touch_id in self._touches:
            self._touches[touch_id] = tuple(position)
        elif phase in ("ended", "cancelled"):
            self._touches.pop(touch_id, None)
        self._handle_touch_gestures()
        self.user_input = True

    def _handle_touch_gestures(self) -> None:
        touches = list(self._touches.values())
        if len(touches) == 1:
            t = touches[0]
            if self._last_touch_center is not None:
                dx = t[0] - self._last_touch_center[0]
                dy = t[1] - self._last_touch_center[1]
                self.rotation[0] += dx * 0.3
                self.rotation[1] += dy * 0.3
            self._last_touch_center = t
        elif len(touches) == 2:
            t1, t2 = touches
            center = ((t1[0] + t2[0]) / 2, (t1[1] + t2[1]) / 2)
            dist = float(np.hypot(t2[0] - t1[0], t2[1] - t1[1]))
            if self._last_pinch_distance is not None:
                self.scroll += (dist - self._last_pinch_distance) * 0.005
            if self._last_touch_center is not None:
                self.shift[1] -= (center[0] - self._last_touch_center[0]) * 0.3
                self.shift[0] += (center[1] - self._last_touch_center[1]) * 0.3
            self._last_pinch_distance = dist
            self._last_touch_center = center
        else:
            self._last_pinch_distance = None
            self._last_touch_center = None

    def clear_touch_state(self) -> None:
        self._touches.clear()
        self._last_pinch_distance = None
        self._last_touch_center = None

    # --- per-frame update ---------------------------------------------------
    def reset_to_camera(self, camera: PerspectiveCamera) -> None:
        """controller.rs:239-251."""
        q = np.asarray(camera.rotation, np.float64)
        q_inv = q * np.array([1.0, -1, -1, -1])
        forward = _rotate(q_inv, [0.0, 0.0, 1.0])
        right = _rotate(q_inv, [1.0, 0.0, 0.0])
        self.center = closest_point(camera.position, forward, self.center)
        if self.up is not None:
            up = np.asarray(self.up, np.float64)
            new_up = up - right * float(up @ right) / float(right @ right)
            self.up = new_up / np.linalg.norm(new_up)

    def update_camera(self, camera: PerspectiveCamera, dt: float) -> None:
        """controller.rs:253-314."""
        pos = np.asarray(camera.position, np.float64)
        direction = pos - self.center
        distance = float(np.linalg.norm(direction))
        direction = direction / distance * np.exp(
            np.log(distance) + self.scroll * dt * 10.0 * self.speed
        )

        q = np.asarray(camera.rotation, np.float64)
        q_inv = q * np.array([1.0, -1, -1, -1])
        view_t = quat_to_mat(q_inv.astype(np.float32)).astype(np.float64)
        x_axis = view_t[:, 0]
        y_axis = self.up if self.up is not None else view_t[:, 1]
        z_axis = view_t[:, 2]

        offset = (
            (self.shift[1] * x_axis - self.shift[0] * y_axis)
            * dt
            * self.speed
            * 0.1
            * distance
        )
        self.center = self.center + offset
        pos = pos + offset

        theta = self.rotation[0] * dt * self.sensitivity
        phi = -self.rotation[1] * dt * self.sensitivity
        eta = 0.0
        if self.alt_pressed:
            eta = -self.rotation[1] * dt * self.sensitivity
            theta = 0.0
            phi = 0.0

        rot = _quat_mul(
            _quat_mul(_axis_angle(y_axis, theta), _axis_angle(x_axis, phi)),
            _axis_angle(z_axis, eta),
        )
        new_dir = _rotate(rot, direction)
        if _angle_short(y_axis, new_dir) < 0.1:
            new_dir = direction
        camera.position = (self.center + new_dir).astype(np.float32)
        camera.rotation = _look_at(-new_dir, y_axis).astype(np.float32)

        decay = 0.8 ** (dt * 60.0)
        if decay < 1e-4:
            decay = 0.0
        self.rotation *= decay
        if np.linalg.norm(self.rotation) < 1e-4:
            self.rotation[:] = 0
        self.shift *= decay
        if np.linalg.norm(self.shift) < 1e-4:
            self.shift[:] = 0
        self.scroll *= decay
        if abs(self.scroll) < 1e-4:
            self.scroll = 0.0
        self.user_input = False
