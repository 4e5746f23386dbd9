"""The port's server (``serve.py``) and PNG codec against the JAX package, on the CPU.

* The batcher and the HTTP front pass the JAX ``tests/test_serve.py`` cases,
  on copies of its stubs (``FakeColorizer``, ``SlowColorizer``): coalescing
  and order, grouping by padded shape, errors delivered and the loop alive,
  a PNG and a JPEG round trip with ``/healthz``, backpressure, and the 400,
  413, 429 and 504 answers. ``/healthz`` names the torch device.
* One real-model POST: the port's f32 ``Colorizer`` behind the server
  answers within 2 levels of JAX's ``Colorizer.colorize_batch`` on the same
  bridged weights, anchors pinned in both (``test_torch_infer_cli.py``), as
  ``test_torch_disco.py`` holds the forward.
* ``start`` passes ``--max_queue``, ``--max_body_bytes``, ``--max_pixels`` and
  ``--request_timeout`` on (the JAX ``main`` drops them); ``--quantize``
  reaches the ``Colorizer``, which calibrates on its first batch (int8 serving
  is held in ``test_torch_quant_api.py``); ``--data_parallel`` is accepted on
  one device; ``warmup`` leaves the serving draws as they were.
* ``utils/io.py::read_png`` against ``cv2.imdecode`` on gray, RGB and RGBA
  PNGs written with each filter type 0-4 (checked in the stream), exactly;
  ``encode_png`` round trips; without OpenCV a JPEG body gets 400.
"""

import json
import pickle
import struct
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib

import cv2
import jax
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.api import Colorizer as JColorizer
from disentangledcolorization_tpu_torch.api import Colorizer
from disentangledcolorization_tpu_torch.serve import (DynamicBatcher, QueueFullError, build_server, serve_argparser,
                                                      start)
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables
from disentangledcolorization_tpu_torch.utils.io import encode_png, read_png
from test_torch_infer_cli import UINT8_TOL, _unfolded, pinned  # noqa: F401 (pinned is a fixture)
from test_torch_bridge import to_jax_variables
from torch_fixtures import tmp_path  # noqa: F401 (removed after a passing test)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeColorizer:
    """Duck-typed stand-in: records batch sizes, paints each image's mean."""

    def __init__(self, bucket=16, fail_on=None):
        self.bucket = bucket
        self.batches = []
        self.fail_on = fail_on

    def colorize_batch(self, images, key=None):
        self.batches.append(len(images))
        if self.fail_on is not None and any(img.shape[0] == self.fail_on for img in images):
            raise RuntimeError("boom")
        return [np.full(img.shape[:2] + (3,), int(np.mean(img)) % 256, np.uint8) for img in images]


class SlowColorizer(FakeColorizer):
    """Blocks inside colorize_batch until released: lets tests fill the queue."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.release = threading.Event()

    def colorize_batch(self, images, key=None):
        self.release.wait(timeout=30)
        return super().colorize_batch(images, key)


def make_img(h, w, val):
    return np.full((h, w, 3), val, np.uint8)


def test_batcher_coalesces_and_preserves_order():
    fake = FakeColorizer()
    b = DynamicBatcher(fake, max_batch=8, max_wait_ms=150.0)
    try:
        futs = [b.submit(make_img(32, 32, v)) for v in (3, 7, 11, 19)]
        outs = [f.result(timeout=10) for f in futs]
        for v, out in zip((3, 7, 11, 19), outs):
            assert out.shape == (32, 32, 3) and int(out[0, 0, 0]) == v
        st = b.stats()
        assert st["requests"] == 4 and st["batches"] < 4 and st["max_batch_seen"] >= 2
    finally:
        b.close()


def test_batcher_groups_by_padded_shape():
    fake = FakeColorizer(bucket=16)
    b = DynamicBatcher(fake, max_batch=8, max_wait_ms=150.0)
    try:
        f1 = b.submit(make_img(32, 32, 5))
        f2 = b.submit(make_img(48, 32, 9))  # another padded shape
        f3 = b.submit(make_img(30, 30, 7))  # pads to 32x32: groups with f1
        assert int(f1.result(10)[0, 0, 0]) == 5
        assert int(f2.result(10)[0, 0, 0]) == 9
        assert int(f3.result(10)[0, 0, 0]) == 7
        assert all(n <= 2 for n in fake.batches)  # shapes never mixed
    finally:
        b.close()


def test_batcher_delivers_errors_and_survives():
    fake = FakeColorizer(fail_on=64)
    b = DynamicBatcher(fake, max_batch=4, max_wait_ms=20.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b.submit(make_img(64, 64, 1)).result(timeout=10)
        assert int(b.submit(make_img(32, 32, 4)).result(timeout=10)[0, 0, 0]) == 4  # loop still alive
    finally:
        b.close()
    assert not b._thread.is_alive()


def test_batcher_backpressure_queue_full():
    slow = SlowColorizer()
    b = DynamicBatcher(slow, max_batch=2, max_wait_ms=1.0, max_queue=2)
    try:
        futs = [b.submit(make_img(16, 16, 1))]
        time.sleep(0.3)  # the dispatcher pulls it and blocks in colorize_batch
        futs += [b.submit(make_img(16, 16, 2)), b.submit(make_img(16, 16, 3))]
        with pytest.raises(QueueFullError):
            b.submit(make_img(16, 16, 4))
        assert b.stats()["rejected"] == 1
        slow.release.set()
        for f in futs:
            f.result(timeout=10)  # accepted work still completes
    finally:
        slow.release.set()
        b.close()


def _post(port, data, timeout=30):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/colorize", data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


class _Serving:
    """A batcher and its server on a free port of 127.0.0.1, shut down on exit."""

    def __init__(self, batcher, srv=None, **limits):
        self.batcher = batcher
        self.srv = srv or build_server("127.0.0.1", 0, batcher, **limits)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.batcher.close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_http_roundtrip(fmt):
    with _Serving(DynamicBatcher(FakeColorizer(), max_batch=4, max_wait_ms=5.0)) as s:
        ok, body = cv2.imencode(fmt, make_img(40, 48, 128))
        assert ok
        code, png, headers = _post(s.port, body.tobytes())
        assert code == 200 and headers["Content-Type"] == "image/png"
        out = read_png(png)
        assert out.shape == (40, 48, 3) and np.array_equal(out, cv2.imdecode(np.frombuffer(png, np.uint8),
                                                                            cv2.IMREAD_COLOR)[..., ::-1])
        with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["requests"] >= 1 and health["devices"] == ["unknown"]
        code, _, _ = _post(s.port, b"not an image")
        assert code == 400
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{s.port}/nowhere", timeout=30)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        assert code == 404


def test_http_limits_and_timeouts():
    slow = SlowColorizer()
    with _Serving(DynamicBatcher(slow, max_batch=2, max_wait_ms=1.0, max_queue=1), max_body_bytes=10_000,
                  max_pixels=64 * 64, request_timeout_s=0.5) as s:
        try:
            code, body, _ = _post(s.port, b"x" * 20_000)  # oversized payload: 413 before any decode
            assert code == 413 and b"payload too large" in body
            code, body, _ = _post(s.port, encode_png(make_img(100, 100, 7)))  # above the pixel cap
            assert code == 413 and b"image too large" in body
            code, _, _ = _post(s.port, b"")
            assert code == 400
            small = encode_png(make_img(16, 16, 7))
            code, _, _ = _post(s.port, small)  # dispatcher blocked: the 0.5 s budget trips
            assert code == 504
            results = []
            threads = [threading.Thread(target=lambda: results.append(_post(s.port, small))) for _ in range(6)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            assert not any(th.is_alive() for th in threads)
            codes = [c for c, _, _ in results]
            assert 429 in codes, f"expected at least one 429, got {codes}"
            assert [h.get("Retry-After") for c, _, h in results if c == 429][0] == "1"
        finally:
            slow.release.set()


def test_jpeg_without_opencv_is_undecodable(monkeypatch):
    """A host without OpenCV (the card's) answers PNG and refuses other bodies."""
    ok, jpg = cv2.imencode(".jpg", make_img(16, 16, 9))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with _Serving(DynamicBatcher(FakeColorizer(), max_batch=2, max_wait_ms=1.0)) as s:
        code, body, _ = _post(s.port, jpg.tobytes())
        assert code == 400 and body == b"could not decode image"
        code, png, _ = _post(s.port, encode_png(make_img(16, 16, 9)[..., 0]))  # gray PNG -> 3 channels
        assert code == 200 and read_png(png).shape == (16, 16, 3)


def test_real_model_post_matches_jax(tmp_path, pinned):  # noqa: F811
    sd = _unfolded()
    variables = to_jax_variables(sd, sn_folded=True)
    pkl = tmp_path / "w.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(variables, f)
    img = cv2.GaussianBlur(np.random.default_rng(6).integers(0, 256, (48, 40, 3), dtype=np.uint8), (5, 5), 2)
    ref = JColorizer(checkpoint=str(pkl), n_clusters=2, compute_dtype="float32").colorize_batch(
        [img], key=jax.random.key(2))[0]
    col = Colorizer(n_clusters=2, device="cpu", compute_dtype="float32",
                    state_dict=from_jax_variables(variables, sn_folded=True))
    with _Serving(DynamicBatcher(col, max_batch=4, max_wait_ms=1.0)) as s:
        code, png, _ = _post(s.port, encode_png(img))
        with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["devices"] == ["cpu"]
    assert code == 200
    out = read_png(png)
    assert out.shape == ref.shape == (48, 40, 3)
    assert int(np.abs(out.astype(int) - ref.astype(int)).max()) <= UINT8_TOL


def test_start_passes_the_limits_on():
    args = serve_argparser().parse_args(["--device", "cpu", "--warmup", "", "--n_clusters", "2", "--port", "0",
                                         "--max_queue", "3", "--max_body_bytes", "100", "--max_pixels", "256",
                                         "--request_timeout", "7", "--data_parallel"])
    assert args.wire == "uint8" and serve_argparser().parse_args([]).warmup == "1,8,56,128"
    col, batcher, srv = start(args)
    with _Serving(batcher, srv) as s:
        assert batcher._q.maxsize == 3 and col.wire_uint8
        code, _, _ = _post(s.port, b"x" * 200)
        assert code == 413
        code, body, _ = _post(s.port, encode_png(make_img(20, 20, 3)))
        assert code == 413 and b"cap 256 px" in body
    col, batcher, srv = start(serve_argparser().parse_args(["--device", "cpu", "--warmup", "", "--n_clusters", "2",
                                                            "--port", "0", "--quantize", "int8"]))
    with _Serving(batcher, srv) as s:
        assert col.quantize == "int8" and not col.calibrated
        code, png, _ = _post(s.port, encode_png(make_img(32, 32, 3)))
    assert code == 200 and read_png(png).shape == (32, 32, 3) and col.calibrated


def test_warmup_runs_each_bucket_and_keeps_the_serving_draws(monkeypatch):
    imgs = [np.random.default_rng(7).integers(0, 256, (32, 32, 3), dtype=np.uint8)]
    plain = Colorizer(n_clusters=2, device="cpu", compute_dtype="float32").colorize_batch(imgs)
    col = Colorizer(n_clusters=2, device="cpu", compute_dtype="float32")
    seen = []
    real = col.model.forward
    monkeypatch.setattr(col.model, "forward", lambda g, *a, **k: seen.append(g.shape[0]) or real(g, *a, **k))
    col.warmup(size=32, buckets=(1, 3))
    assert seen == [1, 4]  # 3 images run at the batch-4 bucket
    assert np.array_equal(col.colorize_batch(imgs)[0], plain[0])


def _filters_in(png: bytes) -> set:
    """The filter type of every scanline of a non-interlaced 8-bit PNG."""
    pos, idat, header = 8, b"", None
    while pos < len(png):
        length, tag = struct.unpack(">I4s", png[pos:pos + 8])
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", png[pos + 8:pos + 8 + length])
        elif tag == b"IDAT":
            idat += png[pos + 8:pos + 8 + length]
        pos += 12 + length
    w, h, _, color_type = header[:4]
    stride = w * {0: 1, 2: 3, 6: 4}[color_type] + 1
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


FILTERS = {0: cv2.IMWRITE_PNG_FILTER_NONE, 1: cv2.IMWRITE_PNG_FILTER_SUB, 2: cv2.IMWRITE_PNG_FILTER_UP,
           3: cv2.IMWRITE_PNG_FILTER_AVG, 4: cv2.IMWRITE_PNG_FILTER_PAETH}


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ftype", list(FILTERS))
def test_read_png_matches_opencv(channels, ftype):
    rng = np.random.default_rng(channels * 10 + ftype)
    img = rng.integers(0, 256, (13, 21, channels), dtype=np.uint8)
    img = (np.cumsum(img.astype(np.int64), axis=1) // 5 % 256).astype(np.uint8)  # neighbours that predict
    ok, png = cv2.imencode(".png", img[..., 0] if channels == 1 else img, [cv2.IMWRITE_PNG_FILTER, FILTERS[ftype]])
    assert ok and _filters_in(png.tobytes()) == {ftype}
    ours, ref = read_png(png.tobytes()), cv2.imdecode(png, cv2.IMREAD_UNCHANGED)
    if channels > 1:  # OpenCV's order is BGR(A)
        ref = ref[..., [2, 1, 0, 3][:channels]]
    assert ours.dtype == np.uint8 and np.array_equal(ours, ref)


def test_encode_png_round_trips_and_read_png_refuses_others():
    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 256, (7, 9), dtype=np.uint8), rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)):
        png = encode_png(img)
        assert np.array_equal(read_png(png), img)
        ref = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED)
        assert np.array_equal(ref if img.ndim == 2 else ref[..., ::-1], img)
    ok, png16 = cv2.imencode(".png", rng.integers(0, 65535, (4, 4), dtype=np.uint16))
    for bad in (b"GIF89a", png16.tobytes(), encode_png(np.zeros((4, 4), np.uint8))[:40]):
        with pytest.raises(ValueError):
            read_png(bad)
