"""ctypes loader for the native C++ codec core.

The shared library is built from native/src/felics_core.cpp (see
native/build.py). If it has not been built, ``available()`` returns False and
callers fall back to the Python oracle.

C ABI:
    int fel_compress(const int32_t* pixels_interleaved, uint32_t width,
                     uint32_t height, int color_type, int pixel_depth,
                     uint8_t** out, size_t* out_len);
    int fel_decompress(const uint8_t* data, size_t len,
                       int32_t** out_pixels, uint32_t* width,
                       uint32_t* height, int* color_type, int* pixel_depth);
    void fel_free(void* ptr);

Return codes mirror felics_tpu.errors (0 = ok; negative = error enum).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from felics_tpu import errors
from felics_tpu.format import ColorType, Header, PixelDepth

_LIB_NAME = "libfelics_core.so"
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False

_ERROR_MAP = {
    -1: errors.IoError,
    -2: errors.InvalidValue,
    -3: errors.ValueOverflow,
    -4: errors.InvalidDimensions,
    -5: errors.InvalidColorType,
    -6: errors.InvalidPixelDepth,
    -7: errors.InvalidSignature,
    -8: MemoryError,
}


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(here), "native", "build", _LIB_NAME)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    path = os.environ.get("FELICS_NATIVE_LIB", _lib_path())
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.fel_compress.restype = ctypes.c_int
    lib.fel_compress.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.fel_decompress.restype = ctypes.c_int
    lib.fel_decompress.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fel_free.restype = None
    lib.fel_free.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "fel_last_error"):  # older prebuilt .so may lack it
        lib.fel_last_error.restype = ctypes.c_char_p
        lib.fel_last_error.argtypes = []
    lib.fel_compress_tiled.restype = ctypes.c_int
    lib.fel_compress_tiled.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_uint16,
        ctypes.c_uint16,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.fel_decompress_tiled.restype = ctypes.c_int
    lib.fel_decompress_tiled.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    if hasattr(lib, "fel_qoi_encode"):  # older prebuilt .so may lack it
        lib.fel_qoi_encode.restype = ctypes.c_int
        lib.fel_qoi_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.fel_qoi_decode.restype = ctypes.c_int
        lib.fel_qoi_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int),
        ]
    if hasattr(lib, "fel_qctx_cap"):  # older prebuilt .so may lack it
        lib.fel_qctx_cap.restype = ctypes.c_uint32
        lib.fel_qctx_cap.argtypes = []
        from felics_tpu.config import QCTX_CAP

        native_cap = int(lib.fel_qctx_cap())
        if native_cap != QCTX_CAP:
            raise RuntimeError(
                f"native felics_core QCTX_CAP={native_cap} disagrees with "
                f"felics_tpu.config.QCTX_CAP={QCTX_CAP}; the FLCT bitstreams "
                "would be incompatible — rebuild native/ (python "
                "native/build.py)"
            )
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _raise(code: int) -> None:
    """Map a native status code to the exception hierarchy, carrying the
    core's per-thread failure detail (fel_last_error, e.g. "FLCT tile
    table truncated") so callers see WHAT failed, not just a code —
    mirroring the reference's descriptive DecompressionError variants
    (src/compression/error.rs:4-19)."""
    exc = _ERROR_MAP.get(code, errors.DecompressionError)
    detail = ""
    if _lib is not None and hasattr(_lib, "fel_last_error"):
        raw = _lib.fel_last_error()
        if raw:
            detail = raw.decode("utf-8", errors="replace")
    raise exc(detail or f"native codec error {code}")


def compress(image: np.ndarray, header: Header) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built; run native/build.py")
    flat = np.ascontiguousarray(image.reshape(-1), dtype=np.int32)
    out_ptr = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    code = lib.fel_compress(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        header.width,
        header.height,
        int(header.color_type),
        int(header.pixel_depth),
        ctypes.byref(out_ptr),
        ctypes.byref(out_len),
    )
    if code != 0:
        _raise(code)
    try:
        return ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.fel_free(out_ptr)


def compress_tiled(
    image: np.ndarray, header: Header, tile_w: int, tile_h: int, n_threads: int = 0
) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built; run native/build.py")
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    flat = np.ascontiguousarray(image.reshape(-1), dtype=np.int32)
    out_ptr = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    code = lib.fel_compress_tiled(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        header.width,
        header.height,
        int(header.color_type),
        int(header.pixel_depth),
        tile_w,
        tile_h,
        n_threads,
        ctypes.byref(out_ptr),
        ctypes.byref(out_len),
    )
    if code != 0:
        _raise(code)
    try:
        return ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.fel_free(out_ptr)


def decompress_tiled(data: bytes, n_threads: int = 0) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built; run native/build.py")
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out_ptr = ctypes.POINTER(ctypes.c_int32)()
    width = ctypes.c_uint32()
    height = ctypes.c_uint32()
    color = ctypes.c_int()
    depth = ctypes.c_int()
    code = lib.fel_decompress_tiled(
        buf,
        len(data),
        n_threads,
        ctypes.byref(out_ptr),
        ctypes.byref(width),
        ctypes.byref(height),
        ctypes.byref(color),
        ctypes.byref(depth),
    )
    if code != 0:
        _raise(code)
    try:
        nchan = 1 if color.value == int(ColorType.GRAY) else 3
        n = width.value * height.value * nchan
        arr = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy() if n else np.zeros(0, np.int32)
    finally:
        lib.fel_free(out_ptr)
    dtype = np.uint8 if depth.value == int(PixelDepth.EIGHT) else np.uint16
    if nchan == 1:
        return arr.astype(dtype).reshape(height.value, width.value)
    return arr.astype(dtype).reshape(height.value, width.value, 3)


def decompress(data: bytes, header: Header) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built; run native/build.py")
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out_ptr = ctypes.POINTER(ctypes.c_int32)()
    width = ctypes.c_uint32()
    height = ctypes.c_uint32()
    color = ctypes.c_int()
    depth = ctypes.c_int()
    code = lib.fel_decompress(
        buf,
        len(data),
        ctypes.byref(out_ptr),
        ctypes.byref(width),
        ctypes.byref(height),
        ctypes.byref(color),
        ctypes.byref(depth),
    )
    if code != 0:
        _raise(code)
    try:
        nchan = 1 if color.value == int(ColorType.GRAY) else 3
        n = width.value * height.value * nchan
        arr = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy()
    finally:
        lib.fel_free(out_ptr)
    dtype = np.uint8 if depth.value == int(PixelDepth.EIGHT) else np.uint16
    if nchan == 1:
        return arr.astype(dtype).reshape(height.value, width.value)
    return arr.astype(dtype).reshape(height.value, width.value, 3)


def qoi_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "fel_qoi_encode")


def qoi_encode(image: np.ndarray) -> bytes:
    """QOI-encode an (H, W, 3|4) uint8 array (grayscale callers expand to
    RGB first — matching how the reference's ImageMagick conversion treats
    gray TIFFs in bench/benchmark-small-corpus.py:39-69)."""
    lib = _load()
    if lib is None or not hasattr(lib, "fel_qoi_encode"):
        raise RuntimeError("native library with QOI not built; run native/build.py")
    if image.ndim != 3 or image.shape[2] not in (3, 4) or image.dtype != np.uint8:
        raise ValueError("QOI input must be (H, W, 3|4) uint8")
    h, w, ch = image.shape
    flat = np.ascontiguousarray(image.reshape(-1))
    out_ptr = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    code = lib.fel_qoi_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h, ch, ctypes.byref(out_ptr), ctypes.byref(out_len),
    )
    if code != 0:
        _raise(code)
    try:
        return ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.fel_free(out_ptr)


def qoi_decode(data: bytes) -> np.ndarray:
    lib = _load()
    if lib is None or not hasattr(lib, "fel_qoi_decode"):
        raise RuntimeError("native library with QOI not built; run native/build.py")
    buf = np.frombuffer(data, dtype=np.uint8)
    out_ptr = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    ch = ctypes.c_int()
    code = lib.fel_qoi_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        ctypes.byref(out_ptr),
        ctypes.byref(w),
        ctypes.byref(h),
        ctypes.byref(ch),
    )
    if code != 0:
        _raise(code)
    try:
        n = w.value * h.value * ch.value
        arr = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy()
    finally:
        lib.fel_free(out_ptr)
    return arr.reshape(h.value, w.value, ch.value)
