"""Live interactive display for the headless demo: a tiny in-process HTTP
server streaming the latest rendered frame (MJPEG) and feeding mouse/key
commands back into the demo loop.

This is the accelerator-host equivalent of the reference's interactive window
(FluidSimDemo.cpp:251-293 OnMouseMove orbit/zoom + the key handlers at
FluidSimDemo.cpp:7-13): there is no swapchain on an accelerator host, so the
"window" is a browser page.  Drag = orbit, wheel / right-drag = zoom,
keys + - 0 r q match the CLI/stdin command set (app/demo.py docstring).
Commands arrive as the same text commands the stdin stream uses, so the
demo loop handles both identically.

Zero new dependencies: stdlib http.server + a Pillow JPEG encode (Pillow
ships with the baked-in torch stack); if Pillow is somehow absent the
stream falls back to a pure-zlib PNG encode (stdlib only).
"""

from __future__ import annotations

import io
import re
import struct
import threading
import zlib
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

# Commands accepted from the page — the same text protocol the stdin
# stream uses, VALIDATED here so a malformed /cmd (typo'd curl, or a
# side-effecting GET fired at localhost by an unrelated webpage) can never
# inject garbage that crashes the demo's command parser.
_CMD_RE = re.compile(
    r"^([+\-0rq]"
    r"|o -?\d+(\.\d+)? -?\d+(\.\d+)?"
    r"|z -?\d+(\.\d+)?)$"
)

_PAGE = """<!doctype html>
<html><head><title>fluidsimulation live view</title>
<style>
  body { background: #111; color: #ccc; font-family: monospace;
         display: flex; flex-direction: column; align-items: center; }
  img { margin-top: 1em; cursor: grab; }
  #help { margin-top: .5em; font-size: 12px; }
</style></head>
<body>
<img id="v" src="/stream" draggable="false">
<div id="help">drag: orbit &nbsp; wheel: zoom &nbsp; keys: + - speed,
0 reset view, r reset sim, q quit</div>
<script>
const img = document.getElementById('v');
let dragging = false, lx = 0, ly = 0, pdx = 0, pdy = 0, pz = 0, timer = null;
function send(c) { fetch('/cmd?c=' + encodeURIComponent(c)); }
function flush() {
  if (pdx || pdy) { send('o ' + pdx + ' ' + pdy); pdx = pdy = 0; }
  if (pz) { send('z ' + pz); pz = 0; }
  timer = null;
}
function queue() { if (!timer) timer = setTimeout(flush, 50); }
img.addEventListener('pointerdown', e => {
  dragging = true; lx = e.clientX; ly = e.clientY;
  img.setPointerCapture(e.pointerId); e.preventDefault();
});
img.addEventListener('pointerup', () => dragging = false);
img.addEventListener('pointermove', e => {
  if (!dragging) return;
  pdx += e.clientX - lx; pdy += e.clientY - ly;
  lx = e.clientX; ly = e.clientY; queue();
});
img.addEventListener('wheel', e => {
  pz += e.deltaY > 0 ? 20 : -20; queue(); e.preventDefault();
}, { passive: false });
window.addEventListener('keydown', e => {
  if ('+-0rq'.includes(e.key)) send(e.key);
  if (e.key === '=') send('+');
});
</script></body></html>"""


def _encode_png(arr: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encode (stdlib zlib only) — Pillow fallback."""
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _quantize(arr: np.ndarray) -> np.ndarray:
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(arr)


def _encode(arr: np.ndarray) -> tuple[bytes, str]:
    try:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=88)
        return buf.getvalue(), "image/jpeg"
    except ImportError:  # pragma: no cover - Pillow is baked in here
        return _encode_png(arr), "image/png"


class LiveView:
    """Threaded frame streamer + command inbox.

    ``publish(img)`` takes the demo's float image (H, W, 3) in [0, 1-ish]
    or a uint8 array and wakes every connected /stream client; encoding is
    lazy (handler-thread side, cached per frame), so publishing with no
    viewer costs nothing.  ``poll_cmds()`` drains validated commands
    posted by the page (same text protocol as the stdin stream).  The
    server thread is a daemon: it dies with the process; ``close()`` shuts
    it down explicitly."""

    def __init__(self, port: int = 8000, host: str = "127.0.0.1"):
        self._cond = threading.Condition()
        self._raw: np.ndarray | None = None
        self._enc: tuple[int, bytes, str] | None = None
        self._seq = 0
        self._cmds: deque[str] = deque()
        self._cmd_lock = threading.Lock()
        view = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/cmd":
                    c = parse_qs(u.query).get("c", [""])[0].strip()
                    if c and _CMD_RE.match(c):
                        with view._cmd_lock:
                            view._cmds.append(c)
                    self.send_response(204)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                elif u.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    seq = -1
                    try:
                        while True:
                            with view._cond:
                                view._cond.wait_for(
                                    lambda: view._seq != seq, timeout=5.0
                                )
                                raw, s2 = view._raw, view._seq
                                enc = view._enc
                            if raw is None:
                                continue
                            # Encode HERE (handler thread, off the demo's
                            # step loop), once per published frame — shared
                            # by all connected clients via the seq cache.
                            if enc is not None and enc[0] == s2:
                                _, frame, ctype = enc
                            else:
                                frame, ctype = _encode(_quantize(raw))
                                with view._cond:
                                    view._enc = (s2, frame, ctype)
                            seq = s2
                            self.wfile.write(
                                b"--frame\r\nContent-Type: "
                                + ctype.encode()
                                + b"\r\nContent-Length: "
                                + str(len(frame)).encode()
                                + b"\r\n\r\n" + frame + b"\r\n"
                            )
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def publish(self, img) -> None:
        # O(1) for the caller: stash the array and wake waiters.  The
        # quantize + JPEG encode runs lazily in a /stream handler thread
        # (cached per seq, shared by all clients) — an unwatched --serve
        # run costs the step loop nothing.
        arr = np.asarray(img)
        with self._cond:
            self._raw = arr
            self._seq += 1
            self._cond.notify_all()

    def poll_cmds(self) -> list[str]:
        with self._cmd_lock:
            out = list(self._cmds)
            self._cmds.clear()
        return out

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
