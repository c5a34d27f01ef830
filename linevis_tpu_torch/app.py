"""Minimal interactive application surface: a live-orbit browser viewer.

Counterpart of `linevis_tpu/app.py`. The reference is an interactive
desktop tool (frame loop + camera + renderer selection, `MainApp.cpp:914-1013`);
this is its headless counterpart: a zero-dependency HTTP server that serves
an orbit-control page and renders frames ON DEMAND through the port's
renderer registry on `device` (the card unless the caller asks for the
CPU). Drag to orbit, scroll to dolly, pick any registered rendering mode
from a dropdown; each interaction requests `/frame?...`, which renders and
returns a PNG.

Frames are pulled by the browser (one in flight at a time) and rendered
from the server's handler threads one at a time (the app's lock); each
thread launches on its own current CUDA stream. Run:

    python -m linevis_tpu_torch view <dataset> [--renderer "Opaque"] [--port 8123] [--device cuda]

`make_server(app, 0)` binds a free port (`server.server_address[1]`).
"""

from __future__ import annotations

import json
import threading
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>linevis_tpu_torch</title><style>
body { margin: 0; background: #181818; color: #ddd;
       font: 13px sans-serif; }
#bar { padding: 6px 10px; }
#view { display: block; margin: 0 auto; cursor: grab; }
select { background: #282828; color: #ddd; }
</style></head><body>
<div id="bar">
  <b>linevis_tpu_torch</b>
  <select id="mode"></select>
  <span id="stat"></span>
</div>
<img id="view" width="%(w)d" height="%(h)d"/>
<script>
let yaw = 0.6, pitch = 0.25, dist = %(dist)f, busy = false, dirty = true;
const img = document.getElementById('view');
const stat = document.getElementById('stat');
const mode = document.getElementById('mode');
fetch('/modes').then(r => r.json()).then(ms => {
  for (const m of ms) {
    const o = document.createElement('option');
    o.value = o.textContent = m;
    if (m === '%(mode)s') o.selected = true;
    mode.appendChild(o);
  }
});
mode.onchange = () => { dirty = true; };
function tick() {
  if (dirty && !busy) {
    dirty = false; busy = true;
    const t0 = performance.now();
    const u = `/frame?yaw=${yaw}&pitch=${pitch}&dist=${dist}` +
              `&mode=${encodeURIComponent(mode.value)}`;
    fetch(u).then(r => r.blob()).then(b => {
      img.src = URL.createObjectURL(b);
      stat.textContent = ` ${(performance.now() - t0).toFixed(0)} ms`;
      busy = false;
    }).catch(() => { busy = false; });
  }
  requestAnimationFrame(tick);
}
tick();
let drag = null;
img.onpointerdown = e => { drag = [e.clientX, e.clientY]; };
window.onpointerup = () => { drag = null; };
window.onpointermove = e => {
  if (!drag) return;
  yaw += (e.clientX - drag[0]) * 0.01;
  pitch = Math.max(-1.5, Math.min(1.5, pitch + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  dirty = true;
};
img.onwheel = e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001);
  dirty = true;
};
</script></body></html>
"""


class LineVisApp:
    """Owns the line data + per-mode renderer cache (the MainApp role:
    renderer factory + visualization pipeline dirty tracking live in the
    renderer registry / LineData already)."""

    def __init__(self, line_data, width=800, height=448, mode="Opaque",
                 accumulate=1, device="cuda"):
        self.line_data = line_data
        self.device = device
        self.width = int(width)
        self.height = int(height)
        self.mode = mode
        self.accumulate = int(accumulate)
        self._renderers = {}
        self._lock = threading.Lock()
        aabb = line_data.get_aabb()
        self.center = 0.5 * (np.asarray(aabb[0]) + np.asarray(aabb[1]))
        self.radius = float(
            np.linalg.norm(np.asarray(aabb[1]) - np.asarray(aabb[0])) * 0.5
        )

    def _renderer(self, mode):
        from linevis_tpu_torch.core.settings import SettingsMap
        from linevis_tpu_torch.render.renderer import create_renderer

        r = self._renderers.get(mode)
        if r is None:
            r = create_renderer(mode, SettingsMap({}), device=self.device)
            r.set_line_data(self.line_data)
            self._renderers[mode] = r
        return r

    def render_frame(self, yaw, pitch, dist, mode=None):
        """-> numpy [H, W, 4] linear RGBA."""
        from linevis_tpu_torch.render.camera import Camera

        mode = mode or self.mode
        cp, cy = np.cos(pitch), np.cos(yaw)
        sp, sy = np.sin(pitch), np.sin(yaw)
        eye = self.center + dist * self.radius * np.asarray(
            [cp * sy, sp, cp * cy]
        )
        cam = Camera(position=tuple(eye), look_at_point=tuple(self.center),
                     width=self.width, height=self.height)
        with self._lock:  # one device render at a time
            r = self._renderer(mode)
            img = r.render(cam)
            for _ in range(self.accumulate - 1):
                img = r.render(cam)
        return img

    def frame_png(self, yaw, pitch, dist, mode=None) -> bytes:
        from linevis_tpu_torch.render.framebuffer import encode_png, to_srgb_u8

        img = self.render_frame(yaw, pitch, dist, mode)
        return encode_png(to_srgb_u8(img))


def make_server(app: LineVisApp, port: int = 8123) -> ThreadingHTTPServer:
    """The viewer's HTTP server on 127.0.0.1:`port` (0: a free port, read
    back from `server.server_address[1]`); renders are serialized by the
    app's lock. A render that raises answers 500 with the error and prints
    its traceback; the server goes on serving."""
    from linevis_tpu_torch.render.renderer import RENDERING_MODE_ALL

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(u.query)
            if u.path == "/":
                page = _PAGE % dict(w=app.width, h=app.height, dist=2.2,
                                    mode=app.mode)
                self._send(200, "text/html", page.encode())
            elif u.path == "/modes":
                self._send(200, "application/json",
                           json.dumps(sorted(RENDERING_MODE_ALL)).encode())
            elif u.path == "/frame":
                try:
                    png = app.frame_png(
                        float(q.get("yaw", [0.6])[0]),
                        float(q.get("pitch", [0.25])[0]),
                        float(q.get("dist", [2.2])[0]),
                        q.get("mode", [app.mode])[0],
                    )
                except Exception as e:  # the server's boundary: report, keep serving
                    traceback.print_exc()
                    self._send(500, "text/plain", repr(e).encode())
                else:
                    self._send(200, "image/png", png)
            else:
                self._send(404, "text/plain", b"not found")

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve(app: LineVisApp, port: int = 8123):
    """Blocking HTTP loop of `make_server(app, port)`."""
    srv = make_server(app, port)
    print(f"linevis_tpu_torch viewer on http://127.0.0.1:{srv.server_address[1]}/ "
          f"({app.width}x{app.height}, {app.mode}, {app.device})", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
