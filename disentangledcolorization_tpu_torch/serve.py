"""Serving on the card: dynamic request batching and a minimal HTTP front.

Counterpart of ``disentangledcolorization_tpu/serve.py``:

* :class:`DynamicBatcher`: requests enqueue from any thread into a bounded
  queue; one dispatcher thread groups what is queued by bucket-padded shape
  into one ``Colorizer.colorize_batch`` call of up to ``max_batch`` images
  (waiting at most ``max_wait_ms`` for a batch to fill, carrying other shapes
  over to the next batch) and resolves each request's future with its image
  or the batch's exception. A full queue raises :class:`QueueFullError`
  at once, which the HTTP front answers with 429.
* :func:`build_server`: a stdlib ``ThreadingHTTPServer``:
    POST /colorize   image bytes -> colorized PNG
    GET  /healthz    liveness, the torch device's name, batcher stats (JSON)
  with 400 (empty, unreadable or undecodable body), 404, 413 (body or pixel
  cap), 429 (queue full) and 504 (request timeout).

One dispatcher thread owns the ``Colorizer``: its model, its generator and
the one CUDA stream it launches on. Handler threads decode and encode images
and never touch the model. This matters beyond the GIL: kernel B's weights
live in one ``__constant__`` bank per device (``csrc/affinity_head.cu``), so
two streams running models with different weights would race on it.

PNG bodies are decoded by ``utils/io.py::read_png`` and answers encoded by
``encode_png``, which need no image library (the card's host has none). Other
bodies, such as JPEG, go to OpenCV's ``imdecode`` as in the JAX server; where
OpenCV is not installed they get its 400 "could not decode image".

    python -m disentangledcolorization_tpu_torch.serve --port 8712 --checkpt disco-beta.pkl
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .utils.io import encode_png, read_png


class QueueFullError(RuntimeError):
    """Backpressure signal: the batcher's bounded queue is at capacity."""


class DynamicBatcher:
    """Groups concurrent colorize requests into single forwards on the card.

    The queue is bounded (``max_queue``): when the card cannot keep up,
    ``submit`` raises :class:`QueueFullError` at once instead of letting
    latency and host memory grow without limit.
    """

    def __init__(self, colorizer, max_batch: int = 128, max_wait_ms: float = 2.0, max_queue: int = 512):
        self.colorizer = colorizer
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue(maxsize=max(max_queue, 1))
        self._stats = {"requests": 0, "batches": 0, "max_batch_seen": 0, "rejected": 0}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one image; the future resolves to an (H, W, 3) uint8 RGB
        array. Raises :class:`QueueFullError` when the queue is at capacity."""
        fut: Future = Future()
        try:
            self._q.put_nowait((image, fut))
        except queue.Full:
            with self._lock:
                self._stats["rejected"] += 1
            raise QueueFullError(f"serving queue full ({self._q.maxsize} pending)") from None
        return fut

    def colorize(self, image: np.ndarray, timeout: float | None = None) -> np.ndarray:
        return self.submit(image).result(timeout)

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def close(self):
        self._stop.set()
        try:
            self._q.put_nowait(None)  # wake a blocked dispatcher; fine if full
        except queue.Full:
            pass
        self._thread.join(timeout=5)

    # -- dispatcher thread ----------------------------------------------------
    def _padded_shape(self, img: np.ndarray):
        b = self.colorizer.bucket
        h, w = img.shape[:2]
        return (h + (b - h % b) % b, w + (b - w % b) % b)

    def _run(self):
        pending: list = []  # carried-over items whose shape did not match the last batch
        while not self._stop.is_set():
            items, pending = pending, []
            if not items:
                try:
                    got = self._q.get(timeout=0.25)  # bounded wait: honour close()
                except queue.Empty:
                    continue
                if got is None:
                    break
                items = [got]
            # opportunistic drain: a short grace window lets concurrent callers
            # coalesce, then everything already queued is taken
            deadline = time.monotonic() + self.max_wait_s
            while len(items) < self.max_batch:
                budget = deadline - time.monotonic()
                try:
                    got = self._q.get_nowait() if budget <= 0 else self._q.get(timeout=budget)
                except queue.Empty:
                    break
                if got is None:
                    self._stop.set()
                    break
                items.append(got)
            shape0 = self._padded_shape(items[0][0])
            batch, rest = [], []
            for it in items:
                (batch if self._padded_shape(it[0]) == shape0 else rest).append(it)
            pending = rest
            try:
                results = self.colorizer.colorize_batch([img for img, _ in batch])
                for (_, fut), rgb in zip(batch, results):
                    fut.set_result(rgb)
            except Exception as e:  # noqa: BLE001 — delivered to every future; the loop keeps serving
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
            with self._lock:
                self._stats["requests"] += len(batch)
                self._stats["batches"] += 1
                self._stats["max_batch_seen"] = max(self._stats["max_batch_seen"], len(batch))
        for _, fut in pending:
            fut.cancel()


def decode_image(raw: bytes):
    """Request bytes -> (H, W, 3) uint8 RGB, or None where they cannot be
    decoded: PNG by :func:`read_png` (gray repeated to three channels, alpha
    dropped, as OpenCV's ``IMREAD_COLOR`` does), anything else by OpenCV where
    it is installed."""
    try:
        img = read_png(raw)
    except ValueError:
        try:
            import cv2
        except ImportError:
            return None
        bgr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
        return None if bgr is None else np.ascontiguousarray(bgr[..., ::-1])
    if img.ndim == 2:
        img = img[..., None]
    return np.ascontiguousarray(np.repeat(img[..., :1], 3, axis=-1) if img.shape[-1] < 3 else img[..., :3])


def device_name(colorizer) -> str:
    """The torch device the model serves on, by name (``/healthz``)."""
    import torch

    dev = getattr(colorizer, "device", None)
    if dev is None:
        return "unknown"
    dev = torch.device(dev)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def make_handler(batcher: DynamicBatcher, max_body_bytes: int = 32 * 1024 * 1024, max_pixels: int = 4096 * 4096,
                 request_timeout_s: float = 30.0):
    devices = [device_name(batcher.colorizer)]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default; stats via /healthz
            pass

        def _send(self, code: int, body: bytes, ctype: str, headers: dict | None = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                info = {"status": "ok", "devices": devices, **batcher.stats()}
                self._send(200, json.dumps(info).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/colorize":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._send(400, b"bad Content-Length", "text/plain")
                return
            if n <= 0:
                self._send(400, b"empty body", "text/plain")
                return
            if n > max_body_bytes:
                self._send(413, f"payload too large (cap {max_body_bytes} bytes)".encode(), "text/plain")
                return
            rgb = decode_image(self.rfile.read(n))
            if rgb is None:
                self._send(400, b"could not decode image", "text/plain")
                return
            if rgb.shape[0] * rgb.shape[1] > max_pixels:
                self._send(413, f"image too large ({rgb.shape[1]}x{rgb.shape[0]}; cap {max_pixels} px)".encode(),
                           "text/plain")
                return
            try:
                out = batcher.colorize(rgb, timeout=request_timeout_s)
            except QueueFullError:
                self._send(429, b"server overloaded, retry later", "text/plain", {"Retry-After": "1"})
                return
            except FutureTimeout:
                self._send(504, f"request timed out after {request_timeout_s}s".encode(), "text/plain")
                return
            self._send(200, encode_png(out), "image/png")

    return Handler


class _Server(ThreadingHTTPServer):
    # the listen backlog: at the stdlib's 5, a burst of concurrent clients
    # finds its connections reset before a handler thread accepts them
    request_queue_size = 128


def build_server(host: str, port: int, batcher: DynamicBatcher, max_body_bytes: int = 32 * 1024 * 1024,
                 max_pixels: int = 4096 * 4096, request_timeout_s: float = 30.0) -> ThreadingHTTPServer:
    """The HTTP front on (host, port) (0: a free port), one thread a
    connection, with a listen backlog of 128 (the JAX server keeps the
    stdlib's 5)."""
    handler = make_handler(batcher, max_body_bytes=max_body_bytes, max_pixels=max_pixels,
                           request_timeout_s=request_timeout_s)
    return _Server((host, port), handler)


def serve_argparser() -> argparse.ArgumentParser:
    """JAX ``serve.py::main``'s flags, plus ``--device``."""
    ap = argparse.ArgumentParser(description="DISCO colorization server on the card")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8712)
    ap.add_argument("--checkpt", default="", help="checkpoint (.pkl, reference .pth.tar or a port trainer's run dir)")
    ap.add_argument("--n_clusters", type=int, default=8)
    ap.add_argument("--max_batch", type=int, default=128)
    ap.add_argument("--max_wait_ms", type=float, default=2.0)
    ap.add_argument("--max_queue", type=int, default=512, help="pending-request cap; overflow -> 429")
    ap.add_argument("--max_body_bytes", type=int, default=32 * 1024 * 1024,
                    help="request payload cap; overflow -> 413")
    ap.add_argument("--max_pixels", type=int, default=4096 * 4096, help="decoded image pixel cap; overflow -> 413")
    ap.add_argument("--request_timeout", type=float, default=30.0,
                    help="per-request wall budget in seconds; overrun -> 504")
    ap.add_argument("--warmup", default="1,8,56,128",
                    help="comma-separated 256x256 batch buckets to run once before serving ('' to skip)")
    ap.add_argument("--data_parallel", action="store_true",
                    help="split request batches over all local cards, one model replica a card "
                    "(parallel/replicas.py)")
    ap.add_argument("--wire", default="uint8", choices=["uint8", "float32"],
                    help="the uint8 codec of the JAX server for L in and ab out (<= 0.43 ab units)")
    ap.add_argument("--quantize", default="none", choices=["none", "int8", "int8_safe"],
                    help="int8 post-training quantization of the wide convs, calibrated on the first batch "
                    "(the warmup's, when --warmup is set); int8_safe keeps the repnet (the anchor "
                    "features) in the compute dtype")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default, the card; raises without one) or 'cpu' (the plain versions)")
    return ap


def start(args):
    """The ``Colorizer`` of ``args``, warmed up, its batcher and its server
    (not yet serving). The JAX ``main`` parses ``--max_queue``,
    ``--max_body_bytes``, ``--max_pixels`` and ``--request_timeout`` but
    passes none of them on; here they reach the batcher and the handler, as
    their help texts say."""
    from .api import Colorizer

    colorizer = Colorizer(checkpoint=args.checkpt, n_clusters=args.n_clusters, data_parallel=args.data_parallel,
                          wire_dtype=args.wire, quantize=args.quantize, device=args.device)
    if args.warmup:
        buckets = [int(b) for b in args.warmup.split(",")]
        print(f"warming up batch buckets {buckets} ...", flush=True)
        colorizer.warmup(buckets=buckets)
    batcher = DynamicBatcher(colorizer, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                             max_queue=args.max_queue)
    srv = build_server(args.host, args.port, batcher, max_body_bytes=args.max_body_bytes, max_pixels=args.max_pixels,
                       request_timeout_s=args.request_timeout)
    return colorizer, batcher, srv


def main(argv=None):
    args = serve_argparser().parse_args(argv)
    _, batcher, srv = start(args)
    print(f"serving on http://{args.host}:{srv.server_address[1]}  (POST /colorize, GET /healthz)", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
