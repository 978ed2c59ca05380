"""Minimal HTTP live viewer — the headless equivalent of the reference's
browser UI (App.tsx canvas + controller.ts fly camera + fps-meter).

Serves a single self-contained page that polls the progressive render and
forwards WASD/drag input to the Controller; every motion resets accumulation
exactly like the reference (renderer.ts:152-201). The render loop runs on
the caller's thread (device dispatch is not re-entrant); the HTTP server is a
background thread that only touches a lock-guarded snapshot + input queue.

    python -m wgpu_path_tracing_tpu.cli view cornell --port 8080
    # open http://localhost:8080 — or drive it headlessly:
    curl 'http://localhost:8080/key?k=w&down=1' ; sleep 1
    curl 'http://localhost:8080/key?k=w&down=0'
    curl -o frame.png http://localhost:8080/frame.png
    # runtime scene swap (App.tsx:12-34 drag-drop parity): either a server
    # path or the .glb bytes themselves; installs at the next chunk boundary
    curl 'http://localhost:8080/load?path=/path/to/scene.glb' -X POST
    curl --data-binary @scene.glb http://localhost:8080/load
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

_PAGE = """<!doctype html>
<html><head><title>path-tracing</title><style>
body{background:#111;color:#ddd;font:13px monospace;text-align:center}
img{image-rendering:pixelated;width:70vmin;height:70vmin;margin-top:2vmin}
</style></head><body>
<div id=s>connecting...</div>
<img id=v src="/frame.png" draggable=false>
<div>WASD/space/shift to fly &middot; drag to look &middot; wheel to dolly
 &middot; drop a .glb to swap scenes &middot;
 <label><input id=dn type=checkbox> denoise</label></div>
<script>
document.getElementById('dn').addEventListener('change',
 e=>fetch(`/denoise?on=${e.target.checked?1:0}`));
const v=document.getElementById('v'),s=document.getElementById('s');
setInterval(()=>{v.src='/frame.png?'+Date.now();
 fetch('/stats').then(r=>r.json()).then(j=>{
  s.textContent=`${j.spp} spp  ${j.mrays.toFixed(1)} Mrays/s  ${j.fps.toFixed(1)} fps`});},500);
for(const[ev,down]of[['keydown',1],['keyup',0]])
 addEventListener(ev,e=>{const k=e.key===' '?'space':e.key.toLowerCase();
  fetch(`/key?k=${k}&down=${down}`);});
let drag=null;
v.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 fetch(`/look?dx=${e.clientX-drag[0]}&dy=${e.clientY-drag[1]}`);
 drag=[e.clientX,e.clientY];});
v.addEventListener('wheel',e=>{e.preventDefault();
 fetch(`/pinch?d=${-e.deltaY}`);},{passive:false});
// Drag-drop scene swap — the reference's signature flow (App.tsx:12-34).
addEventListener('dragover',e=>e.preventDefault());
addEventListener('drop',e=>{e.preventDefault();
 const f=e.dataTransfer.files[0];if(!f)return;
 s.textContent=`loading ${f.name}...`;
 f.arrayBuffer().then(b=>fetch('/load',{method:'POST',body:b}));});
</script></body></html>"""


class ViewerServer:
    """Owns the HTTP thread + shared state; ``run_loop`` renders forever."""

    def __init__(self, renderer, port: int = 0, frames_per_update: int = 4):
        from wgpu_path_tracing_tpu.render.controller import Controller

        self.renderer = renderer
        self.controller = Controller(renderer)
        self.frames_per_update = frames_per_update
        self.denoise = False  # live-toggled via GET /denoise?on=1
        self._lock = threading.Lock()
        self._png: bytes = b""
        self._events: list[tuple] = []
        self._stop = threading.Event()
        # Interactive-latency meter (fps-meter.tsx parity): wall time
        # from a motion event draining to the next
        # PUBLISHED frame (accumulation reset -> fresh 1-chunk image on
        # the wire), surfaced in /stats as motion_to_frame_ms.
        self._motion_t: float | None = None
        self._motion_to_frame_ms: float | None = None

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif url.path == "/frame.png":
                    with viewer._lock:
                        png = viewer._png
                    self._send(200, "image/png", png)
                elif url.path == "/key":
                    k = q.get("k", [""])[0]
                    k = {"space": " ", "shift": "Shift"}.get(k, k)
                    down = q.get("down", ["1"])[0] == "1"
                    with viewer._lock:
                        viewer._events.append(("key", k, down))
                    self._send(200, "text/plain", b"ok")
                elif url.path == "/look":
                    dx = float(q.get("dx", ["0"])[0])
                    dy = float(q.get("dy", ["0"])[0])
                    with viewer._lock:
                        viewer._events.append(("look", dx, dy))
                    self._send(200, "text/plain", b"ok")
                elif url.path == "/pinch":
                    d = float(q.get("d", ["0"])[0])
                    with viewer._lock:
                        viewer._events.append(("pinch", d))
                    self._send(200, "text/plain", b"ok")
                elif url.path == "/denoise":
                    # Denoised PREVIEW (ops/denoise.py) — filters a copy
                    # at snapshot time; accumulation stays raw, so
                    # convergence and parity are unaffected.
                    viewer.denoise = q.get("on", ["1"])[0] == "1"
                    self._send(200, "text/plain", b"ok")
                elif url.path == "/stats":
                    st = viewer.renderer.stats()
                    body = json.dumps({
                        "spp": st["frame_index"],
                        "mrays": st["mrays_per_sec"],
                        "fps": st["frames"]["fps"],
                        "motion_to_frame_ms": viewer._motion_to_frame_ms,
                    }).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path != "/load":
                    self._send(404, "text/plain", b"not found")
                    return
                # Runtime scene swap — drag-drop parity (App.tsx:12-34 →
                # loader.ts:19-46). A ?path= query loads a server-side file;
                # a non-empty body is the .glb bytes themselves (the browser
                # drop handler posts them). Either way the scene is prepared
                # off-thread and installed race-free at the next chunk
                # boundary (Renderer.load_model_async).
                path = q.get("path", [None])[0]
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                tmp_path = None
                try:
                    if path is None and body:
                        import tempfile

                        suffix = ".glb" if body[:4] == b"glTF" else ".gltf"
                        with tempfile.NamedTemporaryFile(
                            suffix=suffix, delete=False
                        ) as f:
                            f.write(body)
                            path = tmp_path = f.name
                    if path is None:
                        self._send(400, "text/plain",
                                   b"need ?path= or a .glb body")
                        return
                    future = viewer.renderer.load_model_async(path)
                    if tmp_path is not None:
                        # The upload's temp copy is only needed until the
                        # background parse reads it — unlink when the load
                        # settles (success OR failure) so repeated
                        # drag-drops don't accumulate scene-sized files.
                        def _cleanup(_f, p=tmp_path):
                            try:
                                os.unlink(p)
                            except OSError:
                                pass

                        future.add_done_callback(_cleanup)
                    self._send(200, "text/plain", b"staged")
                except Exception as e:  # surface parse errors to the client
                    if tmp_path is not None:
                        try:
                            os.unlink(tmp_path)
                        except OSError:
                            pass
                    self._send(500, "text/plain", str(e).encode())

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def _drain_events(self, dt: float) -> None:
        with self._lock:
            events, self._events = self._events, []
        if events and self._motion_t is None:
            self._motion_t = time.perf_counter()
        for ev in events:
            if ev[0] == "key":
                (self.controller.key_down if ev[2]
                 else self.controller.key_up)(ev[1])
            elif ev[0] == "pinch":
                self.controller.pinch(ev[1])
            else:
                self.controller.mouse_move(ev[1], ev[2])
        self.controller.update(dt)

    def _snapshot(self) -> None:
        import numpy as np

        from wgpu_path_tracing_tpu.utils.image import encode_png

        img = self.renderer.image(denoise=self.denoise)
        png = encode_png((np.clip(img, 0, 1) * 255.0 + 0.5).astype("uint8"))
        with self._lock:
            self._png = png
        if self._motion_t is not None:
            self._motion_to_frame_ms = (
                time.perf_counter() - self._motion_t) * 1e3
            self._motion_t = None

    def step(self, dt: float) -> None:
        """One viewer tick: apply input, render a chunk, publish the frame
        (the rAF-loop body, renderer.ts:456-473). The render dispatches
        unsynced — the snapshot's image pull is the tick's one host
        sync."""
        self._drain_events(dt)
        self.renderer.render(spp=self.frames_per_update, fetch=False,
                             sync=False)
        self._snapshot()  # pulls + tonemaps the frame once per tick

    def run_loop(self, max_seconds: float | None = None) -> None:
        t_prev = time.perf_counter()
        t0 = t_prev
        while not self._stop.is_set():
            now = time.perf_counter()
            self.step(now - t_prev)
            t_prev = now
            if max_seconds is not None and now - t0 > max_seconds:
                break

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
