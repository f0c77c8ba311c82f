"""Interactive browser viewer.

The reference's interactive shell is winit + egui + a wasm/WebGPU web demo
(web-splat lib.rs:128-891, src/ui.rs, public/).  As in
``websplat_tpu/apps/viewer.py`` the viewer is a small HTTP app: the browser
shows rendered frames and forwards mouse/keyboard input; the host runs the
orbit controller (models/controller.py) and the renderer on the card.
Known gaps: frames are sent as linear u8 (no display transfer), and the
page shows FPS and counts but no per-stage timing plot.

Feature parity with the reference viewer/UI:
- orbit / pan / zoom with the mouse (controller.rs semantics)
- render-stats: FPS + visible-splat count (ui.rs:25-92)
- live render settings: gaussian scaling, SH degree, background color,
  kernel size / mip-splatting overrides (ui.rs:94-161)
- scene camera list with snap-to-view transitions (ui.rs:163-319; 200 ms
  eased transition, lib.rs:557)
- T starts a tracking shot through saved/scene cameras, C saves the current
  view (lib.rs:528-538, 595-610)
- grow-in animation driven by accumulated walltime (lib.rs:353-355)

Usage: python -m websplat_tpu_torch.apps.viewer INPUT.ply|npz [SCENE.json]
           [--port 8000] [--width 800 --height 600] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from websplat_tpu_torch.apps.common import add_device_arg, find_scene_file
from websplat_tpu_torch.config import RasterConfig, SplattingArgs
from websplat_tpu_torch.io.loader import load_gaussian_cloud
from websplat_tpu_torch.models.animation import Animation, TrackingShot, Transition
from websplat_tpu_torch.models.controller import CameraController
from websplat_tpu_torch.models.camera import PerspectiveCamera
from websplat_tpu_torch.models.scene import Scene
from websplat_tpu_torch.render.renderer import GaussianRenderer
from websplat_tpu_torch.utils import trace
from websplat_tpu_torch.utils.image import to_u8
from websplat_tpu_torch.utils.stopwatch import FrameClock

PAGE = """<!DOCTYPE html>
<html><head><title>websplat-tpu viewer</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; display:flex; }
#view { cursor:grab; }
#panel { padding:12px; width:270px; font-size:12px; }
#panel label { display:block; margin-top:8px; }
#stats { white-space:pre; color:#8f8; }
button { margin:2px; }
</style></head><body>
<canvas id="view" width="{W}" height="{H}"></canvas>
<div id="panel">
  <div id="stats">connecting...</div>
  <canvas id="plot" width="260" height="48" style="background:#181818"></canvas>
  <label>gaussian scaling <input type="range" id="scaling" min="0.01" max="1" step="0.01" value="1"></label>
  <label>max SH degree <input type="range" id="shdeg" min="0" max="3" step="1" value="3"></label>
  <label>background <input type="color" id="bg" value="#000000"></label>
  <label>mip splatting
    <select id="mip"><option value="auto">auto</option>
      <option value="on">on</option><option value="off">off</option></select>
  </label>
  <label><input type="checkbox" id="kernelauto" checked> kernel size auto</label>
  <label>kernel size <input type="range" id="kernel" min="0" max="0.5" step="0.01" value="0.3" disabled></label>
  <div id="cameras"></div>
  <button onclick="post({type:'tracking_shot'})">tracking shot (T)</button>
  <button onclick="post({type:'save_view'})">save view (C)</button>
  <button onclick="post({type:'reload'})">reload (alt+R)</button>
</div>
<script>
const cv = document.getElementById('view'), ctx = cv.getContext('2d');
let drag = null;
function post(o) { fetch('/input', {method:'POST', body: JSON.stringify(o)}); }
cv.onmousedown = e => { drag = {x:e.clientX, y:e.clientY, btn:e.button}; e.preventDefault(); };
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  post({type: drag.btn === 2 ? 'pan' : 'rotate', dx: e.clientX-drag.x, dy: e.clientY-drag.y});
  drag = {x:e.clientX, y:e.clientY, btn:drag.btn};
};
cv.oncontextmenu = e => e.preventDefault();
cv.onwheel = e => { post({type:'zoom', dy: e.deltaY/100}); e.preventDefault(); };
window.onkeydown = e => {
  if (e.key === 't') post({type:'tracking_shot'});
  else if (e.key === 'c') post({type:'save_view'});
  else if (e.key === 'r' && e.altKey) post({type:'reload'});
  else if (e.key === 'u') {  // hide UI, client-side like the reference (lib.rs:753)
    const p = document.getElementById('panel');
    p.style.display = p.style.display === 'none' ? 'block' : 'none';
  }
  else post({type:'key', key:e.key, pressed:true});
};
window.onkeyup = e => post({type:'key', key:e.key, pressed:false});
// touch gestures forwarded per-touch (rotate / two-finger pinch+pan)
for (const [ev, phase] of [['touchstart','started'], ['touchmove','moved'],
                           ['touchend','ended'], ['touchcancel','cancelled']]) {
  cv.addEventListener(ev, e => {
    for (const t of e.changedTouches)
      post({type:'touch', id:t.identifier, x:t.clientX, y:t.clientY, phase:phase});
    e.preventDefault();
  }, {passive:false});
}
for (const id of ['scaling','shdeg']) {
  document.getElementById(id).oninput = e => post({type:'setting', name:id, value:parseFloat(e.target.value)});
}
document.getElementById('bg').oninput = e => post({type:'setting', name:'bg', value:e.target.value});
document.getElementById('mip').onchange = e => post({type:'setting', name:'mip',
  value: e.target.value === 'auto' ? 'auto' : e.target.value === 'on'});
const ka = document.getElementById('kernelauto'), ks = document.getElementById('kernel');
ka.onchange = e => {
  ks.disabled = ka.checked;
  post({type:'setting', name:'kernel', value: ka.checked ? 'auto' : parseFloat(ks.value)});
};
ks.oninput = e => { if (!ka.checked) post({type:'setting', name:'kernel', value:parseFloat(ks.value)}); };
async function loop() {
  while (true) {
    const t0 = performance.now();
    const r = await fetch('/frame.png?t=' + t0);
    const blob = await r.blob();
    const img = await createImageBitmap(blob);
    ctx.drawImage(img, 0, 0);
    const s = await (await fetch('/stats')).json();
    document.getElementById('stats').textContent =
      `fps ${s.fps.toFixed(1)}\\nvisible ${s.num_visible}\\ninstances ${s.num_instances}`;
    const cams = document.getElementById('cameras');
    if (cams.childElementCount === 0 && s.cameras) {
      for (const c of s.cameras) {
        const b = document.createElement('button');
        b.textContent = c.split + ' ' + c.id;
        b.onclick = () => post({type:'snap', id:c.id});
        cams.appendChild(b);
      }
    }
  }
}
loop();
</script></body></html>
"""


class ViewerState:
    def __init__(self, cloud, scene, width, height, config, input_path=None,
                 cameras_save_path=None, scenes_dir=None, device="cuda"):
        self.device = device
        self.cameras_save_path = cameras_save_path
        self.scenes_dir = scenes_dir
        self.config = config
        self.width = width
        self.height = height
        self.lock = threading.Lock()
        self.clock = FrameClock()
        self._stats_ns = 0  # host_ms's last read, on the spans' clock
        self.frame_png = b""
        self.stop = False
        self.cloud = None
        self.scene = None
        self.renderer = None
        self.input_path = None
        self._attach(cloud, scene, input_path)

    def _attach(self, cloud, scene, input_path):
        """Bind a (cloud, scene) pair: fresh renderer, controller, camera and
        per-scene settings — shared by startup and gallery scene switches
        (the reference's URL-param loader, index.html:176-234)."""
        self.cloud = cloud
        self.scene = scene
        self.input_path = input_path
        self.renderer = (None if cloud is None
                         else GaussianRenderer(cloud, self.config, device=self.device))
        self.controller = CameraController(speed=1.0, sensitivity=1.0)
        self.settings = dict(
            gaussian_scaling=1.0,
            max_sh_deg=cloud.sh_deg if cloud is not None else 3,
            mip=None, kernel=None, bg=(0.0, 0.0, 0.0),
        )
        self.walltime = 0.0
        self.animation = None
        self.saved_cameras = []
        self.current_view = 0
        # lazy redraw (lib.rs:829-838): skip the scene render when camera +
        # settings + walltime are unchanged since the previous frame
        self._last_sig = None
        self.lazy_skips = 0
        if cloud is None:
            self.camera = PerspectiveCamera.default()
            return
        if scene is not None and scene.num_cameras() > 0:
            self.camera = scene.cameras()[0].to_perspective()
            # controller center from mean camera look-at (lib.rs:507-526)
            self.controller.center = np.asarray(cloud.center, np.float64)
            if cloud.up is not None:
                self.controller.up = np.asarray(cloud.up, np.float64)
        else:
            self.camera = PerspectiveCamera.default()
            c = cloud.bbox_center()
            r = max(cloud.bbox_radius(), 1e-3)
            self.camera.position = (c + np.array([0, 0, -2.5 * r])).astype(np.float32)
            self.controller.center = np.asarray(c, np.float64)
        self.controller.reset_to_camera(self.camera)

    def host_ms(self) -> dict:
        """Mean host ms a frame of the render's phases over the spans recorded
        since the previous call (utils/trace.py, which main() enables):
        ``prep`` (ws.render.prep), ``launch`` (ws.graph.lookup +
        ws.graph.replay; None on the CPU, which replays no graph),
        ``readback`` (ws.render.readback) and ``capture`` (ws.graph.capture,
        a graph captured anew: a new viewport or settings, or one evicted);
        None where no such span ran."""
        with self.lock:
            since, self._stats_ns = self._stats_ns, time.time_ns()
        spent = {}
        for r in trace.records():
            if r.end_ns > since:
                spent.setdefault(r.name, []).append((r.end_ns - r.start_ns) / 1e6)

        def mean(*names):
            if not all(spent.get(n) for n in names):
                return None
            return sum(sum(spent[n]) / len(spent[n]) for n in names)

        return dict(prep=mean("ws.render.prep"), launch=mean("ws.graph.lookup", "ws.graph.replay"),
                    readback=mean("ws.render.readback"), capture=mean("ws.graph.capture"))

    def load_scene(self, input_path, scene_path=None):
        """Switch to another scene file at runtime (gallery click — the
        reference loads ?file=&scene= URL params, index.html:176-234)."""
        cloud = load_gaussian_cloud(input_path)
        scene_path = scene_path or find_scene_file(input_path)
        scene = Scene.from_json(scene_path) if scene_path else None
        with self.lock:
            self._attach(cloud, scene, input_path)

    def reload(self):
        """Hot reload of the point cloud from disk (Alt+R, lib.rs:296-312)."""
        if not self.input_path:
            return
        cloud = load_gaussian_cloud(self.input_path)
        renderer = GaussianRenderer(cloud, self.config, device=self.device)
        with self.lock:
            self.cloud = cloud
            self.renderer = renderer
            self.walltime = 0.0  # grow-in restarts like the reference reload

    def save_views(self):
        """Persist saved cameras as a cameras.json-compatible list — the
        reference stubs this (cameras_save_path exists but is never written,
        lib.rs:154-155,284-285)."""
        if not self.cameras_save_path:
            return
        from websplat_tpu_torch.models.scene import SceneCamera, Split

        entries = [
            SceneCamera.from_perspective(
                c, f"saved_{i:03d}", i, (self.width, self.height), Split.TRAIN
            ).to_json_dict()
            for i, c in enumerate(self.saved_cameras)
        ]
        with open(self.cameras_save_path, "w") as f:
            json.dump(entries, f, indent=1)

    def snap_to(self, cam_id):
        sc = self.scene.camera(cam_id) if self.scene else None
        if sc is None:
            return
        target = sc.to_perspective()
        with self.lock:
            # 200 ms eased transition (lib.rs:557)
            self.animation = Animation(
                duration=0.2, looping=False, sampler=Transition(self.camera, target)
            )

    def handle_view_key(self, key: str) -> bool:
        """View-selection keys (lib.rs:741-787): digits 0-9 jump to scene
        camera i, PageUp/PageDown step through views, R picks a random view,
        N snaps to the camera nearest the current position."""
        if self.scene is None or self.scene.num_cameras() == 0:
            return False
        cams = self.scene.cameras()
        n = len(cams)
        if len(key) == 1 and key.isdigit():
            idx = int(key)
            if idx >= n:
                return False
            self.current_view = idx
        elif key in ("PageUp", "PageDown"):
            step = 1 if key == "PageUp" else -1
            self.current_view = (self.current_view + step) % n
        elif key in ("r", "R"):
            import random

            self.current_view = random.randrange(n)
        elif key in ("n", "N"):
            with self.lock:
                pos = np.asarray(self.camera.position, np.float64)
            cam_id = self.scene.nearest_camera(pos)
            if cam_id is None:
                return False
            self.snap_to(cam_id)
            return True
        else:
            return False
        self.snap_to(cams[self.current_view].id)
        return True

    def start_tracking_shot(self):
        cams = self.saved_cameras or (
            [c.to_perspective() for c in self.scene.cameras()] if self.scene else []
        )
        if len(cams) < 2:
            return
        with self.lock:
            self.animation = Animation(
                duration=2.0 * len(cams), looping=True, sampler=TrackingShot(cams)
            )

    def render_loop(self):
        last = time.perf_counter()
        while not self.stop:
            now = time.perf_counter()
            dt = now - last
            last = now
            if self.renderer is None:  # gallery mode, nothing loaded yet
                time.sleep(0.05)
                continue
            with self.lock:
                self.walltime = min(self.walltime + dt, 5.0)  # lib.rs:353-355
                if self.animation is not None:
                    self.camera = self.animation.update(dt)
                    if self.animation.done():
                        self.animation = None
                        self.controller.reset_to_camera(self.camera)
                else:
                    # clamp dt: the reference's controller integrates with
                    # per-frame dt and assumes interactive frame rates; a
                    # slow (CPU) frame would otherwise explode the orbit
                    self.controller.update_camera(self.camera, min(dt, 0.1))
                s = dict(self.settings)
                cam = self.camera
                renderer = self.renderer  # stable ref across load_scene swaps
            args = SplattingArgs(
                gaussian_scaling=s["gaussian_scaling"],
                max_sh_deg=int(s["max_sh_deg"]),
                mip_splatting=s["mip"],
                kernel_size=s["kernel"],
                walltime=self.walltime,
                background_color=tuple(s["bg"]),
            )
            # lazy redraw (lib.rs:829-838): identical SplattingArgs + camera
            # -> reuse the previous frame (walltime stops changing once the
            # grow-in caps at 5 s, so an idle viewer renders nothing)
            sig = (
                tuple(np.asarray(cam.position, np.float64).tolist()),
                tuple(np.asarray(cam.rotation, np.float64).tolist()),
                repr(cam.projection),
                args,
            )
            if sig == self._last_sig and self.frame_png:
                self.lazy_skips += 1
                time.sleep(0.005)
                continue
            self._last_sig = sig
            img = renderer.render(
                cam, (self.width, self.height), args, with_diag=True
            )
            tmp = io.BytesIO()
            _encode_png_bytes(tmp, to_u8(img))
            self.frame_png = tmp.getvalue()
            self.clock.tick()


def _encode_png_bytes(f, img_u8):
    import struct
    import zlib

    h, w, c = img_u8.shape
    color_type = 2 if c == 3 else 6

    def chunk(tag, data):
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    f.write(b"\x89PNG\r\n\x1a\n")
    f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
    raw = b"".join(b"\x00" + img_u8[y].tobytes() for y in range(h))
    f.write(chunk(b"IDAT", zlib.compress(raw, 1)))
    f.write(chunk(b"IEND", b""))


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Cache-Control", "no-store")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _gallery_page(self):
            """Demo-scene gallery: scans --scenes-dir for point clouds and
            renders a card per scene linking /?file=...&scene=... — the
            server-side analogue of the reference's static demo page
            (web-splat public/demo.html) + URL-param loader
            (index.html:176-234)."""
            root = state.scenes_dir
            cards = []
            if root:
                import os as _os

                for dirpath, _dirs, files in sorted(_os.walk(root)):
                    for fn in sorted(files):
                        if not fn.endswith((".ply", ".npz")):
                            continue
                        p = _os.path.join(dirpath, fn)
                        rel = _os.path.relpath(p, root)
                        scene_json = find_scene_file(p)
                        q = f"/?file={rel}"
                        if scene_json:
                            q += f"&scene={_os.path.relpath(scene_json, root)}"
                        mb = _os.path.getsize(p) / 1e6
                        name = _os.path.basename(_os.path.dirname(p)) or fn
                        cards.append(
                            f'<a class="card" href="{q}"><b>{name}</b>'
                            f"<br>{fn}<br><span>{mb:.1f} MB</span></a>"
                        )
            body = (
                "<!DOCTYPE html><title>websplat-tpu demo scenes</title>"
                "<style>body{font-family:sans-serif;background:#111;color:#eee}"
                ".grid{display:flex;flex-wrap:wrap;gap:12px}"
                ".card{border:1px solid #444;border-radius:8px;padding:12px;"
                "min-width:160px;color:#eee;text-decoration:none}"
                ".card:hover{background:#222}"
                "span{color:#888;font-size:smaller}</style>"
                "<h2>Demo scenes</h2><div class=grid>"
                + ("".join(cards) or "<p>no scenes found</p>")
                + "</div>"
            )
            self._send(200, body.encode())

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path == "/demo":
                self._gallery_page()
                return
            if url.path == "/" and state.scenes_dir:
                q = parse_qs(url.query)
                if "file" in q:
                    import os as _os

                    root = _os.path.realpath(state.scenes_dir)

                    def safe(rel):
                        p = _os.path.realpath(_os.path.join(root, rel))
                        if not (p == root or p.startswith(root + _os.sep)):
                            raise ValueError("path escapes --scenes-dir")
                        return p

                    try:
                        f = safe(q["file"][0])
                        s = safe(q["scene"][0]) if "scene" in q else None
                        if state.input_path != f:
                            state.load_scene(f, s)
                    except Exception as e:  # noqa: BLE001 — surface to browser
                        self._send(400, f"load failed: {e}".encode())
                        return
                elif state.renderer is None:
                    self._gallery_page()
                    return
            if self.path.startswith("/frame.png"):
                # 503 until the first frame exists (the first frame builds
                # the kernels) — a 0-byte 200 breaks <img> and clients
                if state.frame_png:
                    self._send(200, state.frame_png, "image/png")
                else:
                    self._send(503, b"first frame not rendered yet")
            elif self.path.startswith("/stats"):
                diag = state.renderer.last_diag or {}
                counts = trace.counters()
                cams = [
                    dict(id=c.id, split=c.split.value)
                    for c in (state.scene.cameras() if state.scene else [])
                ]
                body = json.dumps(
                    dict(
                        fps=state.clock.fps,
                        frame_times=[round(t * 1e3, 2) for t in state.clock.history.to_list()[-120:]],
                        num_visible=int(diag.get("num_visible", 0)),
                        num_instances=int(diag.get("num_instances", 0)),
                        host_ms=state.host_ms(),
                        graph_captures=counts.get("graph.captures", 0),
                        graph_evictions=counts.get("graph.evictions", 0),
                        trace_dropped=counts.get("trace.dropped", 0),
                        cameras=cams,
                    )
                ).encode()
                self._send(200, body, "application/json")
            else:
                page = PAGE.replace("{W}", str(state.width)).replace(
                    "{H}", str(state.height)
                )
                self._send(200, page.encode())

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                self._handle_event(json.loads(self.rfile.read(n) or b"{}"))
            except Exception as e:  # noqa: BLE001 — malformed events must
                # answer 400, not kill the connection (a zoom event without
                # "dy" would KeyError the handler thread mid-response)
                self._send(400, f"bad event: {e!r}".encode())
                return
            self._send(200, b"{}", "application/json")

        def _handle_event(self, msg):
            t = msg.get("type")
            ctl = state.controller
            if t == "rotate":
                ctl.left_mouse_pressed = True
                ctl.process_mouse(float(msg["dx"]), float(msg["dy"]))
                ctl.left_mouse_pressed = False
            elif t == "pan":
                ctl.right_mouse_pressed = True
                ctl.process_mouse(float(msg["dx"]), float(msg["dy"]))
                ctl.right_mouse_pressed = False
            elif t == "zoom":
                ctl.process_scroll(float(msg["dy"]))
            elif t == "key":
                key = str(msg.get("key", ""))
                pressed = bool(msg.get("pressed"))
                # view-selection keys act on press only (lib.rs:741-787)
                if not (pressed and state.handle_view_key(key)):
                    ctl.process_keyboard(key, pressed)
            elif t == "touch":
                # two-finger rotate/pinch/pan forwarded from the browser page
                # (reference: winit Touch events -> controller.rs:145-228)
                ctl.process_touch(
                    int(msg.get("id", 0)),
                    (float(msg.get("x", 0.0)), float(msg.get("y", 0.0))),
                    str(msg.get("phase", "moved")),
                )
            elif t == "setting":
                name, value = msg["name"], msg["value"]
                with state.lock:
                    if name == "scaling":
                        state.settings["gaussian_scaling"] = float(value)
                    elif name == "shdeg":
                        state.settings["max_sh_deg"] = int(value)
                    elif name == "kernel":
                        # tri-state (ui.rs:438-496): "auto" defers to the
                        # per-file default, a number is an explicit override
                        state.settings["kernel"] = (
                            None if value in (None, "auto") else float(value)
                        )
                    elif name == "mip":
                        state.settings["mip"] = (
                            None if value in (None, "auto") else bool(value)
                        )
                    elif name == "bg":
                        v = value.lstrip("#")
                        state.settings["bg"] = tuple(
                            int(v[i : i + 2], 16) / 255.0 for i in (0, 2, 4)
                        )
            elif t == "snap":
                state.snap_to(int(msg["id"]))
            elif t == "tracking_shot":
                state.start_tracking_shot()
            elif t == "save_view":
                with state.lock:
                    state.saved_cameras.append(state.camera)
                state.save_views()
            elif t == "reload":
                state.reload()

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input", nargs="?", default=None)
    ap.add_argument("scene", nargs="?", default=None)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--save-cameras", default=None,
                    help="write saved views (C key) to this cameras.json")
    ap.add_argument("--scenes-dir", default=None,
                    help="serve a demo-scene gallery at /demo from this "
                         "directory (reference: public/demo.html)")
    add_device_arg(ap)
    args_ns = ap.parse_args(argv)
    if args_ns.input is None and args_ns.scenes_dir is None:
        ap.error("need a scene file or --scenes-dir")
    trace.enable()  # /stats reads the frame's spans

    if args_ns.input is not None:
        cloud = load_gaussian_cloud(args_ns.input)
        scene_path = args_ns.scene or find_scene_file(args_ns.input)
        scene = Scene.from_json(scene_path) if scene_path else None
        n_pts = cloud.num_points
    else:
        cloud, scene, n_pts = None, None, 0
    state = ViewerState(
        cloud, scene, args_ns.width, args_ns.height,
        RasterConfig.for_viewport(args_ns.width, args_ns.height),
        input_path=args_ns.input, cameras_save_path=args_ns.save_cameras,
        scenes_dir=args_ns.scenes_dir, device=args_ns.device,
    )

    threading.Thread(target=state.render_loop, daemon=True).start()
    server = ThreadingHTTPServer(("127.0.0.1", args_ns.port), make_handler(state))
    print(f"viewer at http://127.0.0.1:{args_ns.port}/  ({n_pts} splats)")
    server.serve_forever()


if __name__ == "__main__":
    main()
