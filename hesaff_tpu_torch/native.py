"""ctypes bridge to the native host runtime (native/*.cpp).

The port's copy of ``hesaff_tpu/native.py``.  It builds the repo's own
``native/hesaff_io.cpp``, ``hesaff_jpeg.cpp`` and ``hesaff_loader.cpp``
with ``g++ -O3`` on first use into ``build/hesaff_tpu_torch/`` at the
root of the checkout, under a name keyed by a hash of the sources and
the flags, and never writes the JAX package's ``native/libhesaff_io.so``
(so two processes, or the two packages, never link the same output).
Each entry point returns None / False when the library cannot be built
or loaded, and its caller (``sift_io``) takes the pure-Python path:
this is host I/O, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

from hesaff_tpu_torch.ops.cuda_build import BUILD_DIR

_ROOT = Path(__file__).resolve().parents[1]
SOURCES = [_ROOT / "native" / f
           for f in ("hesaff_io.cpp", "hesaff_jpeg.cpp", "hesaff_loader.cpp")]
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for s in SOURCES:
        h.update(s.read_bytes())
    return BUILD_DIR / f"libhesaff_io-{h.hexdigest()[:16]}.so"


def _build(so) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, *map(str, SOURCES), "-o", str(tmp),
                    "-lz"], check=True, capture_output=True)
    os.replace(tmp, so)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            _bind(lib)
        except (OSError, subprocess.CalledProcessError, AttributeError):
            # no g++ / zlib, a failed build or a library without these
            # symbols: the callers take the pure-Python path
            return None
        _lib = lib
        return _lib


def _bind(lib) -> None:
    img = [ctypes.c_char_p, ctypes.c_int64,
           ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
           ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    for name in ("hesaff_decode_pnm_gray", "hesaff_decode_png_gray",
                 "hesaff_decode_jpeg_gray"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = img
    lib.hesaff_jpeg_dims.restype = ctypes.c_int
    lib.hesaff_jpeg_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.hesaff_write_sift.restype = ctypes.c_int
    lib.hesaff_write_sift.argtypes = [ctypes.c_char_p, ctypes.c_int64] + [
        ctypes.POINTER(ctypes.c_double)
    ] * 5 + [ctypes.POINTER(ctypes.c_uint8)]
    lib.hesaff_read_sift.restype = ctypes.c_int64
    lib.hesaff_read_sift.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.hesaff_loader_create.restype = ctypes.c_void_p
    lib.hesaff_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.hesaff_loader_next.restype = ctypes.c_int
    lib.hesaff_loader_next.argtypes = [
        ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int32)] * 4
    lib.hesaff_loader_fetch.restype = ctypes.c_int
    lib.hesaff_loader_fetch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.hesaff_loader_destroy.restype = None
    lib.hesaff_loader_destroy.argtypes = [ctypes.c_void_p]


def available() -> bool:
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_png_gray(data: bytes):
    """8/16-bit non-interlaced PNG bytes -> (H, W) float32 gray with
    equal-weight (R+G+B)/3, or None (unsupported variant / no lib)."""
    lib = _load()
    if lib is None or len(data) < 33:
        return None
    w0, h0 = struct.unpack(">II", data[16:24])
    if w0 == 0 or h0 == 0 or w0 * h0 > (1 << 31):
        return None
    out = np.empty(w0 * h0, np.float32)
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    rc = lib.hesaff_decode_png_gray(data, len(data), _fptr(out), w0 * h0,
                                    ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return out[: w.value * h.value].reshape(h.value, w.value)


def decode_jpeg_gray(data: bytes):
    """Baseline / progressive JPEG bytes -> (H, W) float32 gray with
    equal-weight (R+G+B)/3, or None (CMYK/12-bit or no lib — callers
    fall back to PIL)."""
    lib = _load()
    if lib is None or len(data) < 4:
        return None
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    if lib.hesaff_jpeg_dims(data, len(data), ctypes.byref(w),
                            ctypes.byref(h)) != 0:
        return None
    npix = int(w.value) * int(h.value)
    if npix <= 0 or npix > (1 << 27):
        return None
    out = np.empty(npix, np.float32)
    rc = lib.hesaff_decode_jpeg_gray(data, len(data), _fptr(out), npix,
                                     ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return out.reshape(h.value, w.value)


def decode_pnm_gray(data: bytes):
    """P6/P5 bytes -> (H, W) float32 gray with (R+G+B)/3, or None."""
    lib = _load()
    if lib is None:
        return None
    max_pixels = len(data)  # 3 bytes/px for P6 means this always bounds
    out = np.empty(max_pixels, np.float32)
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    rc = lib.hesaff_decode_pnm_gray(data, len(data), _fptr(out), max_pixels,
                                    ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return out[: w.value * h.value].reshape(h.value, w.value).copy()


def write_sift(path: str, u, v, e00, e01, e11, desc) -> bool:
    lib = _load()
    if lib is None:
        return False
    n = len(u)
    arrs = [np.ascontiguousarray(a, np.float64) for a in (u, v, e00, e01, e11)]
    d = np.ascontiguousarray(desc, np.uint8)
    # hesaff_write_sift reads n rows of 128 bytes and n of each field
    if d.shape != (n, 128) or any(a.shape != (n,) for a in arrs):
        raise ValueError(f"native.write_sift: desc {d.shape} and fields "
                         f"{[a.shape for a in arrs]} are not (n, 128) and "
                         f"(n,) with n = {n}")
    rc = lib.hesaff_write_sift(
        path.encode(), n,
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for a in arrs],
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return rc == 0


def read_sift(path: str):
    lib = _load()
    if lib is None:
        return None
    n = lib.hesaff_read_sift(path.encode(), None, None, 0)
    if n < 0:
        return None
    geom = np.empty((n, 5), np.float64)
    desc = np.empty((n, 128), np.uint8)
    got = lib.hesaff_read_sift(
        path.encode(),
        geom.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        desc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
    )
    if got != n:
        return None
    return {
        "u": geom[:, 0], "v": geom[:, 1],
        "e00": geom[:, 2], "e01": geom[:, 3], "e11": geom[:, 4],
        "desc": desc,
    }


class PrefetchLoader:
    """Native threaded prefetching image loader (hesaff_loader.cpp).

    Iterates (path, padded_image_or_None, (orig_h, orig_w)) strictly in
    input order while a C++ thread pool reads, decodes, and edge-pads
    the following images in the background (ctypes releases the GIL
    for the blocking next() call).  Images the native decoders cannot
    handle yield None and the caller falls back to its Python loader.
    Use as a context manager or call close().
    """

    def __init__(self, paths, threads: int = 4, pad_multiple: int = 64,
                 queue_cap: int = 16):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._paths = list(paths)
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths])
        self._handle = lib.hesaff_loader_create(
            arr, len(self._paths), threads, pad_multiple, queue_cap)
        if not self._handle:
            raise RuntimeError("hesaff_loader_create failed")
        self._pos = 0

    @property
    def pos(self) -> int:
        """Index of the next path the iterator will deliver."""
        return self._pos

    def __iter__(self):
        return self

    def __next__(self):
        if self._handle is None or self._pos >= len(self._paths):
            raise StopIteration
        wp = ctypes.c_int32()
        hp = ctypes.c_int32()
        ow = ctypes.c_int32()
        oh = ctypes.c_int32()
        rc = self._lib.hesaff_loader_next(
            self._handle, ctypes.byref(wp), ctypes.byref(hp),
            ctypes.byref(ow), ctypes.byref(oh))
        if rc < 0:
            raise StopIteration
        path = self._paths[self._pos]
        self._pos += 1
        if rc != 0:
            self._lib.hesaff_loader_fetch(self._handle, None)
            return path, None, None
        img = np.empty((hp.value, wp.value), np.float32)
        self._lib.hesaff_loader_fetch(self._handle, _fptr(img))
        return path, img, (oh.value, ow.value)

    def close(self):
        if self._handle is not None:
            self._lib.hesaff_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort; close() is the real contract
        try:
            self.close()
        except Exception:
            pass
