"""ctypes bindings for the native host library (csrc/gsplat_native.cpp).

The reference's host runtime is all C++ (happly row-wise PLY extraction,
include/happly.h; frame readback conversion, src/splat/ipu_rasteriser.cpp:
131-144). Our equivalents live in csrc/ behind a C ABI; this module loads
them opportunistically — every entry point has a numpy fallback, so the
framework works with or without `make -C csrc`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc",
    "libgsplat_native.so")
_lib = None
_tried = False


def load_library() -> Optional[ctypes.CDLL]:
    """Load libgsplat_native.so once; None when not built."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    i64 = ctypes.c_int64
    lib.deinterleave_f32.argtypes = [
        ctypes.c_void_p, i64, i64, ctypes.POINTER(i64), i64,
        ctypes.c_void_p]
    lib.deinterleave_f32.restype = None
    lib.center_flip_f32.argtypes = [ctypes.c_void_p, i64, i64,
                                    ctypes.c_void_p]
    lib.center_flip_f32.restype = None
    lib.u8_from_f32.argtypes = [ctypes.c_void_p, i64, ctypes.c_float,
                                ctypes.c_float, ctypes.c_void_p]
    lib.u8_from_f32.restype = None
    lib.loader_create.argtypes = [i64]
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.restype = None
    lib.loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64]
    lib.loader_submit.restype = i64
    lib.loader_fetch.argtypes = [
        ctypes.c_void_p, i64, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i64),
        ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.loader_fetch.restype = i64
    lib.loader_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.loader_free.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def stack_f32_columns(rec: np.ndarray,
                      names: Sequence[str]) -> Optional[np.ndarray]:
    """Gather float32 fields of a structured array into (n, k) f32.

    Returns None when the native library is absent or a field is not
    little-endian f32 (caller falls back to numpy stacking).
    """
    lib = load_library()
    if lib is None or rec.dtype.fields is None:
        return None
    if not rec.flags.c_contiguous:
        return None
    f4 = np.dtype("<f4")
    offsets = []
    for n in names:
        fld = rec.dtype.fields.get(n)
        if fld is None or fld[0] != f4:
            return None
        offsets.append(fld[1])
    n_rows = rec.shape[0]
    out = np.empty((n_rows, len(names)), np.float32)
    offs = np.asarray(offsets, np.int64)
    lib.deinterleave_f32(
        ctypes.c_void_p(rec.ctypes.data), n_rows,
        rec.dtype.itemsize,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(names), out.ctypes.data_as(ctypes.c_void_p))
    return out


def center_flip(xyz: np.ndarray) -> Optional[np.ndarray]:
    """In-place centre + z-flip of an (n, 3) f32 contiguous array.

    Returns the pre-centering (2, 3) bbox, or None without the library.
    """
    lib = load_library()
    if lib is None:
        return None
    assert xyz.dtype == np.float32 and xyz.flags.c_contiguous
    bb = np.empty(6, np.float32)
    lib.center_flip_f32(xyz.ctypes.data_as(ctypes.c_void_p),
                        xyz.shape[0], xyz.shape[1],
                        bb.ctypes.data_as(ctypes.c_void_p))
    return bb.reshape(2, 3)


class ImagePrefetcher:
    """Threaded native PNG decoder (csrc/dataloader.cpp).

    submit() paths up front; fetch() blocks until that image is decoded
    (workers run ahead on the rest — the prefetch). A fetch whose status
    is nonzero (unsupported PNG flavour, JPEG, ...) returns None and the
    caller falls back to PIL for that file. The prefetcher is this
    framework's analogue of the reference's native host loader
    (src/splat/file_io.cpp), extended to the training data path.
    """

    def __init__(self, nthreads: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library not built (make -C csrc)")
        self._lib = lib
        self._handle = lib.loader_create(nthreads)

    def submit(self, path: str, downscale: int = 1) -> int:
        return int(self._lib.loader_submit(
            self._handle, path.encode(), max(int(downscale), 1)))

    def fetch(self, job_id: int):
        """-> (array (h, w, c) f32 in [0,1], (w0, h0)) or None."""
        data = ctypes.POINTER(ctypes.c_float)()
        w = ctypes.c_int64()
        h = ctypes.c_int64()
        c = ctypes.c_int64()
        w0 = ctypes.c_int64()
        h0 = ctypes.c_int64()
        status = self._lib.loader_fetch(
            self._handle, job_id, ctypes.byref(data), ctypes.byref(w),
            ctypes.byref(h), ctypes.byref(c), ctypes.byref(w0),
            ctypes.byref(h0))
        if status != 0:
            return None
        try:
            n = w.value * h.value * c.value
            arr = np.ctypeslib.as_array(data, shape=(n,)).reshape(
                h.value, w.value, c.value).copy()
        finally:
            self._lib.loader_free(data)
        return arr, (w0.value, h0.value)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass


def to_uint8(img: np.ndarray, exposure: float = 1.0,
             gamma: float = 1.0) -> Optional[np.ndarray]:
    """Tone-map f32 image to u8 (utils/image.to_uint8 native fast path)."""
    lib = load_library()
    if lib is None:
        return None
    flat = np.ascontiguousarray(img, np.float32)
    out = np.empty(flat.shape, np.uint8)
    lib.u8_from_f32(flat.ctypes.data_as(ctypes.c_void_p), flat.size,
                    exposure, 1.0 / gamma,
                    out.ctypes.data_as(ctypes.c_void_p))
    return out
