"""Host-side image I/O: file lists, image decoding to Lab, PNG dumps, background writers.

Counterpart of ``disentangledcolorization_tpu/utils/io.py``. Two differences,
both so that the trainers run on a host without an image library:

  * the decoders (``fetch_image_lab``, ``load_image_bgr_resized``,
    ``bgr_to_lab_item``, ``load_image_lab_resized``) import OpenCV inside the
    function, never at import time, and give the JAX package's items;
  * the PNG writers convert Lab to RGB with the port's own chain
    (``utils/color.py``, on the tensor's device) in place of OpenCV's, and
    write 8-bit PNG files with the standard library (:func:`write_png`).

PNG also goes the other way without an image library: :func:`read_png`
decodes 8-bit gray, gray + alpha, RGB and RGBA PNGs (non-interlaced, filter
types 0-4) with ``zlib`` and numpy, and :func:`encode_png` returns a PNG's
bytes. The server (``serve.py``) answers PNG with them on a host without
OpenCV. :func:`load_rgb01` reads an image for the metrics: by OpenCV where
it is installed, else a PNG already at the metric's size by :func:`read_png`.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import struct
import zlib
from queue import Queue
from threading import Thread

import numpy as np
import torch

from .color import lab2rgb


def _cv2():
    import cv2  # the decoders only: nothing else here needs an image library

    return cv2


def fetch_image_lab(img_path: str, no_resize: bool = True, scale: int = 16, resize_to: int = 256):
    """An image -> normalized (gray (H,W,1), ab (H,W,2), rgb (H,W,3) in [-1, 1]),
    original (H, W). ``no_resize`` edge-pads H, W up to multiples of ``scale``;
    otherwise a bilinear resize to (resize_to, resize_to)."""
    cv2 = _cv2()
    bgr = cv2.imread(img_path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(img_path)
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    h, w = rgb.shape[:2]
    if no_resize:
        if h % scale != 0 or w % scale != 0:
            rgb = np.pad(rgb, ((0, (scale - h % scale) % scale), (0, (scale - w % scale) % scale), (0, 0)), mode="edge")
    else:
        rgb = cv2.resize(rgb, (resize_to, resize_to), interpolation=cv2.INTER_LINEAR)
    rgb = np.asarray(rgb / 255.0, np.float32)
    lab = cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB)
    return (lab[..., :1] - 50.0) / 50.0, lab[..., 1:] / 110.0, rgb * 2.0 - 1.0, (h, w)


def load_image_bgr_resized(img_path: str, resize: int | None = None) -> np.ndarray:
    """Decode and square-resize (bicubic) to uint8 BGR: what the dataset's cache holds."""
    cv2 = _cv2()
    bgr = cv2.imread(img_path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(img_path)
    if resize:
        bgr = cv2.resize(bgr, (resize, resize), interpolation=cv2.INTER_CUBIC)
    return bgr


def bgr_to_lab_item(bgr_u8: np.ndarray) -> dict:
    """uint8 BGR -> the normalized float32 training item {'gray', 'color', 'BGR'}."""
    cv2 = _cv2()
    bgr = bgr_u8.astype(np.float32) / np.float32(255.0)
    lab = cv2.cvtColor(bgr, cv2.COLOR_BGR2LAB)
    return {"gray": (lab[..., :1] - 50.0) / 50.0, "color": lab[..., 1:] / 110.0, "BGR": bgr * 2.0 - 1.0}


def load_image_lab_resized(img_path: str, resize: int | None = None) -> dict:
    return bgr_to_lab_item(load_image_bgr_resized(img_path, resize))


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> channels (8-bit gray, RGB, gray + alpha, RGBA)


def encode_png(img: np.ndarray) -> bytes:
    """The bytes of an 8-bit PNG of a uint8 (H, W) gray or (H, W, 3) RGB
    array: one IDAT chunk, every row with filter 0, zlib level 6."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color_type = {2: 0, 3: 2}[img.ndim]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    return b"".join([
        _PNG_SIGNATURE,
        _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)),
        _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
        _png_chunk(b"IEND", b""),
    ])


def write_png(path: str, img: np.ndarray) -> None:
    """:func:`encode_png` of ``img`` written to ``path``."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def _unfilter(ftype: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes without its filter (PNG spec 9.2): None, Sub, Up
    by numpy; Average and Paeth byte by byte, each byte depending on the one
    ``bpp`` before it."""
    if ftype == 0:
        return row
    if ftype == 1:
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ftype == 2:
        return row + prior
    if ftype not in (3, 4):
        raise ValueError(f"PNG: unknown filter type {ftype}")
    out, up = bytearray(row.tobytes()), prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            out[i] = (out[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(data: bytes) -> np.ndarray:
    """An 8-bit PNG's pixels as uint8: (H, W) gray, (H, W, 2) gray + alpha,
    (H, W, 3) RGB or (H, W, 4) RGBA. Raises ``ValueError`` on anything else
    (another bit depth, a palette, interlacing, a broken stream)."""
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError("not a PNG")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG: truncated chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or no IDAT chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"PNG: bit depth {depth}, colour type {color_type}, interlace {interlace}: "
                         "only non-interlaced 8-bit gray, gray + alpha, RGB and RGBA are read")
    ch = _PNG_CHANNELS[color_type]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG: {e}") from None
    stride = w * ch
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG: {raw.size} bytes of image data for {h} rows of {stride}")
    lines = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter(int(lines[y, 0]), lines[y, 1:], prior, ch)
    return out.reshape(h, w) if ch == 1 else out.reshape(h, w, ch)


def load_rgb01(path: str, size: int | None = 256) -> np.ndarray:
    """An image as float32 (H, W, 3) RGB in [0, 1], resized to (size, size)
    as the JAX package's metrics read it: ``cv2.imread`` -> ``INTER_AREA``
    resize -> RGB / 255. Without OpenCV a ``.png`` is decoded by
    :func:`read_png` (gray widened to RGB, alpha dropped, as ``IMREAD_COLOR``
    does) and must already be ``size`` square: another size raises
    ``RuntimeError``, since a resize by another algorithm would give other
    numbers. ``size=None`` reads the image as it is stored."""
    try:
        cv2 = _cv2()
    except ImportError:
        cv2 = None
    if cv2 is not None:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(path)
        if size is not None:
            bgr = cv2.resize(bgr, (size, size), interpolation=cv2.INTER_AREA)
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    if not path.lower().endswith(".png"):
        raise RuntimeError(f"{path}: without OpenCV only PNG files are read (install opencv-python for other formats)")
    with open(path, "rb") as f:
        img = read_png(f.read())
    if img.ndim == 2:
        img = img[..., None]
    img = np.repeat(img[..., :1], 3, axis=-1) if img.shape[-1] <= 2 else img[..., :3]
    if size is not None and img.shape[:2] != (size, size):
        raise RuntimeError(f"{path} is {img.shape[1]}x{img.shape[0]}, not {size}x{size}: resizing it as the metrics "
                           "do (INTER_AREA) needs OpenCV; without it, give images at the metric's size")
    return img.astype(np.float32) / 255.0


def _dump_name(filename_list, i: int, n: int, batch_no: int, suffix) -> str:
    name = filename_list[i] if batch_no == -1 else "%05d.png" % (batch_no * n + i)
    return name.replace(".png", "-%s.png" % suffix) if suffix else name


def save_normLabs_from_batch(img_batch, save_dir, filename_list, batch_no=-1, suffix=None):
    """Normalized NHWC Lab (array or tensor) -> RGB PNGs, converted on the
    tensor's device with the port's Lab chain and clipped to [0, 1]."""
    lab = torch.as_tensor(img_batch, dtype=torch.float32)
    n, _, _, c = lab.shape
    if c != 3:
        print("@Warning: the Lab images are NOT in 3 channels!")
        return None
    rgb = (lab2rgb(lab).clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
    os.makedirs(save_dir, exist_ok=True)
    for i in range(n):
        write_png(os.path.join(save_dir, _dump_name(filename_list, i, n, batch_no, suffix)), rgb[i])
    return None


def save_images_from_batch(img_batch, save_dir, filename_list, batch_no=-1, suffix=None):
    """[-1, 1] NHWC images -> PNGs; 3 channels RGB, 1 gray, else one file a channel."""
    img_batch = np.asarray(img_batch, np.float32)
    n, _, _, c = img_batch.shape
    os.makedirs(save_dir, exist_ok=True)

    def _name(i, ch=None):
        if batch_no == -1:
            base = filename_list[i]
            if ch is not None:
                stem, _ = os.path.splitext(os.path.basename(base))
                base = f"{stem}_c{ch}.png"
        else:
            base = "%05d.png" % (batch_no * n + i) if ch is None else "%05d_c%d.png" % (batch_no * n + i, ch)
        return base.replace(".png", "-%s.png" % suffix) if suffix else base

    for i in range(n):
        if c == 3:
            write_png(os.path.join(save_dir, _name(i)), (127.5 * (img_batch[i] + 1.0)).astype(np.uint8))
        elif c == 1:
            write_png(os.path.join(save_dir, _name(i)), (127.5 * (img_batch[i, :, :, 0] + 1.0)).astype(np.uint8))
        else:
            for j in range(c):
                write_png(os.path.join(save_dir, _name(i, j)), (127.5 * (img_batch[i, :, :, j] + 1.0)).astype(np.uint8))
    return None


def mark_boundaries(image: np.ndarray, label_map: np.ndarray, color=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Paint the boundaries of an integer label map onto an RGB [0, 1] image:
    a pixel is a boundary if a 4-neighbour has another label."""
    lm = np.asarray(label_map)
    b = np.zeros(lm.shape, bool)
    b[:-1, :] |= lm[:-1, :] != lm[1:, :]
    b[1:, :] |= lm[1:, :] != lm[:-1, :]
    b[:, :-1] |= lm[:, :-1] != lm[:, 1:]
    b[:, 1:] |= lm[:, 1:] != lm[:, :-1]
    out = np.array(image, np.float32, copy=True)
    out[b] = np.asarray(color, np.float32)
    return out


def save_markedSP_from_batch(img_batch, spix_batch, save_dir, filename_list, batch_no=-1, suffix=None):
    """[-1, 1] NHWC RGB images + (N, H, W, 1) superpixel ids -> boundary-marked PNGs."""
    img_batch = np.asarray(img_batch, np.float32)
    spix_batch = np.asarray(spix_batch)
    n = img_batch.shape[0]
    os.makedirs(save_dir, exist_ok=True)
    for i in range(n):
        marked = mark_boundaries(img_batch[i] * 0.5 + 0.5, spix_batch[i, :, :, 0].astype(int))
        write_png(os.path.join(save_dir, _dump_name(filename_list, i, n, batch_no, suffix)),
                  (marked * 255.0).astype(np.uint8))
    return None


def get_filelist(data_dir: str):
    files = glob.glob(os.path.join(data_dir, "*.*"))
    files.sort()
    return files


def collect_filenames(data_dir: str):
    names = [os.path.split(p)[1] for p in get_filelist(data_dir)]
    names.sort()
    return names


def exists_or_mkdir(path: str, need_remove: bool = False):
    if not os.path.exists(path):
        os.makedirs(path)
    elif need_remove:
        shutil.rmtree(path)
        os.makedirs(path)
    return None


def get_gauss_kernel(size: int, sigma: float) -> np.ndarray:
    """MATLAB fspecial-style normalized Gaussian kernel (reference util.py:11-15)."""
    x, y = np.mgrid[-size // 2 + 1: size // 2 + 1, -size // 2 + 1: size // 2 + 1]
    g = np.exp(-((x ** 2 + y ** 2) / (2.0 * sigma ** 2)))
    return g / g.sum()


def save_list(save_path, data_list, append_mode=False):
    n = len(data_list)
    if append_mode:
        with open(save_path, "a") as f:
            f.writelines([str(data_list[i]) + "\n" for i in range(n - 1, n)])
    else:
        with open(save_path, "w") as f:
            f.writelines([str(x) + "\n" for x in data_list])
    return None


def save_dict(save_path, d):
    with open(save_path, "w") as f:
        json.dump(d, f)
    return None


class AsyncWriter:
    """A background thread that runs enqueued (fn, args) writes in order. A
    failing write records the first exception and the thread keeps draining;
    ``flush`` waits for the queue and re-raises it on the caller's thread."""

    def __init__(self):
        self.q: Queue = Queue(maxsize=0)
        self._error: Exception | None = None
        Thread(target=self._work, daemon=True).start()

    def _work(self):
        while True:
            fn, args, kwargs = self.q.get()
            try:
                fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — surfaced at flush()
                if self._error is None:
                    self._error = e
            finally:
                self.q.task_done()

    def submit(self, fn, *args, **kwargs):
        self.q.put((fn, args, kwargs))

    def flush(self):
        self.q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __len__(self):
        return self.q.qsize()


def prefetch_iter(it, depth: int = 2):
    """Run ``it`` on a background thread, buffering up to ``depth`` items
    (``depth <= 0``: serial). A producer's exception is raised to the consumer
    at the item where it failed."""
    if depth <= 0:
        yield from it
        return
    q: Queue = Queue(maxsize=depth)
    sentinel = object()

    def run():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            q.put(e)
            return
        q.put(sentinel)

    Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
