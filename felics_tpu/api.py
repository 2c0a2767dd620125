"""Top-level image compress/decompress API.

Reference counterpart: ``compress_image`` / ``decompress_image`` and the
``CompressDecompress`` trait impls (src/compression.rs:250-441). Images are
numpy arrays: ``(H, W)`` uint8/uint16 for grayscale, ``(H, W, 3)`` for RGB.
``decompress_image`` dispatches on the header like the reference's
``DynamicImage`` match (src/compression.rs:426-439) and returns the
appropriately-typed array.

Backends:
  * ``"oracle"`` — sequential pure-Python codec (correctness oracle).
  * ``"native"`` — the C++ runtime core (fast sequential, default when built).
  * ``"jax"``    — the vectorized XLA FLCS encoder plus the batched
                   amortized path (core.jax_codec; single-stream decode is
                   irreducibly serial and stays a lax.scan oracle there).
  * ``"auto"``   — FLCS: native if built, else oracle, for BOTH directions
                   (the jax FLCS path is never auto-selected for one-off
                   images: a single-stream encode pays host round-trips that
                   dwarf the device time at FLCS sizes — use ``"jax"``
                   explicitly, or the batched ``compress_images_bytes``
                   below). FLCT: the device pipeline unless the process
                   computes on the CPU, then the native threaded codec
                   (``_flct_backend``).

Batched serving APIs: ``compress_images_bytes(images)`` (this module)
encodes N FLCS containers in one fused device program; the FLCT equivalents
are ``parallel.batch.compress_tiled_batch``/``decompress_tiled_batch``.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Union

import numpy as np

from felics_tpu import errors
from felics_tpu.config import CodingConfig, config_for_depth
from felics_tpu.coding.bitio import BitReader, BitWriter
from felics_tpu.core import oracle
from felics_tpu.core.color import rgb_to_ycocg, ycocg_to_rgb
from felics_tpu.format import (
    ColorType,
    Header,
    PixelDepth,
    read_header,
    write_header,
)

_DTYPES = {PixelDepth.EIGHT: np.uint8, PixelDepth.SIXTEEN: np.uint16}


def _depth_for_array(image: np.ndarray) -> PixelDepth:
    if image.dtype == np.uint8:
        return PixelDepth.EIGHT
    if image.dtype == np.uint16:
        return PixelDepth.SIXTEEN
    raise ValueError(f"unsupported dtype {image.dtype}; use uint8 or uint16")


def header_for_array(image: np.ndarray) -> Header:
    if image.ndim == 2:
        color = ColorType.GRAY
    elif image.ndim == 3 and image.shape[2] == 3:
        color = ColorType.RGB
    else:
        raise ValueError("image must be (H, W) grayscale or (H, W, 3) RGB")
    h, w = image.shape[:2]
    return Header(color, _depth_for_array(image), w, h)


def _resolve_backend(backend: str, for_encode: bool):
    if backend == "auto":
        from felics_tpu.native import runtime as native_runtime

        if native_runtime.available():
            return "native"
        return "oracle"
    return backend


def _flct_backend(backend: str) -> str:
    """Backend choice for the tiled (FLCT) container.

    FLCT is the device-parallel format, so ``auto`` routes to the jax
    pipeline whenever JAX computes on an accelerator; only a process pinned
    to the CPU gets the threaded C++ codec. ``oracle`` has no tiled
    implementation and falls through to the jax (XLA) pipeline, which is
    byte-identical.
    """
    if backend in ("jax", "native"):
        return backend
    if backend == "auto":
        from felics_tpu.utils import platform

        if platform.backend() != "cpu":
            return "jax"
        from felics_tpu.native import runtime as native_runtime

        if native_runtime.available():
            return "native"
    return "jax"


def compress_image(
    image: np.ndarray,
    to: BinaryIO,
    backend: str = "auto",
    container: str = "flcs",
    tile=None,
) -> None:
    to.write(
        compress_image_bytes(image, backend=backend, container=container, tile=tile)
    )


def compress_image_bytes(
    image: np.ndarray,
    backend: str = "auto",
    container: str = "flcs",
    tile=None,
) -> bytes:
    """``container``: "flcs" (reference-compatible single stream) or "flct"
    (the tiled-parallel format; see ``_flct_backend``)."""
    image = np.ascontiguousarray(image)
    if container == "flct":
        from felics_tpu.config import TileConfig

        tile_cfg = tile or TileConfig()
        if _flct_backend(backend) == "native":
            from felics_tpu.native import runtime as native_runtime

            return native_runtime.compress_tiled(
                image,
                header_for_array(image),
                tile_cfg.tile_w,
                tile_cfg.tile_h,
            )
        from felics_tpu.parallel import tiling

        return tiling.compress_tiled_bytes(image, tile_cfg)
    if container != "flcs":
        raise ValueError(f"unknown container {container!r}")
    header = header_for_array(image)
    backend = _resolve_backend(backend, for_encode=True)

    if backend == "native":
        from felics_tpu.native import runtime as native_runtime

        return native_runtime.compress(image, header)
    if backend == "jax":
        from felics_tpu.core import jax_codec

        return jax_codec.compress_image_bytes(image, header)
    if backend != "oracle":
        raise ValueError(f"unknown backend {backend!r}")

    config = config_for_depth(header.pixel_depth)
    out = io.BytesIO()
    write_header(header, out)
    writer = BitWriter()
    if header.color_type == ColorType.GRAY:
        channel = image.reshape(-1).astype(np.int64)
        oracle.compress_channel(channel, header.width, header.height, config, writer)
    else:
        planes = image.reshape(-1, 3).astype(np.int32)
        y, co, cg = rgb_to_ycocg(planes[:, 0], planes[:, 1], planes[:, 2])
        for chan in (y, co, cg):
            oracle.compress_channel(
                chan.astype(np.int64), header.width, header.height, config, writer
            )
    writer.byte_align()
    out.write(writer.getvalue())
    return out.getvalue()


def compress_images_bytes(
    images, backend: str = "jax", container: str = "flcs", tile=None
):
    """Batched multi-image encode -> list of container byte strings.

    FLCS + ``backend="jax"`` runs core.jax_codec.compress_images_bytes (all
    images in one fused kscan+pack program on the device; bytes identical
    to per-image encodes). Other backends loop the per-image
    encoder. FLCT routes to parallel.batch.compress_tiled_batch.
    """
    if container == "flct":
        from felics_tpu.parallel.batch import compress_tiled_batch

        if _flct_backend(backend) == "native":
            return [
                compress_image_bytes(im, backend, container, tile)
                for im in images
            ]
        return compress_tiled_batch(list(images), tile)
    if container != "flcs":
        raise ValueError(f"unknown container {container!r}")
    if backend == "jax":
        from felics_tpu.core import jax_codec

        return jax_codec.compress_images_bytes(list(images))
    return [compress_image_bytes(im, backend) for im in images]


def decompress_image(from_: BinaryIO, backend: str = "auto") -> np.ndarray:
    return decompress_image_bytes(from_.read(), backend=backend)


def decompress_images_bytes(datas, backend: str = "auto"):
    """Batched multi-image decode -> list of images (mirror of
    compress_images_bytes).

    All-FLCT batches route to parallel.batch.decompress_tiled_batch (the
    fused tile pipeline). All-FLCS batches with the jax backend decode
    same-shape groups as ONE vmapped scan program (lanes = images). Mixed
    batches and other backends loop the per-image decoder. Results match
    per-image ``decompress_image_bytes`` exactly.
    """
    datas = list(datas)
    if not datas:
        return []
    if all(d[:4] == b"FLCT" for d in datas) and _flct_backend(backend) != "native":
        from felics_tpu.parallel.batch import decompress_tiled_batch

        return decompress_tiled_batch(datas)
    if (
        _resolve_backend(backend, for_encode=False) == "jax"
        and all(d[:4] == b"FLCS" for d in datas)
    ):
        from felics_tpu.core import jax_codec

        return jax_codec.decompress_images_bytes(datas)
    return [decompress_image_bytes(d, backend) for d in datas]


def decompress_image_bytes(data: bytes, backend: str = "auto") -> np.ndarray:
    if data[:4] == b"FLCT":
        if _flct_backend(backend) == "native":
            from felics_tpu.native import runtime as native_runtime

            return native_runtime.decompress_tiled(data)
        from felics_tpu.parallel import tiling

        return tiling.decompress_tiled_bytes(data)
    header = read_header(io.BytesIO(data))
    backend = _resolve_backend(backend, for_encode=False)

    if backend == "native":
        from felics_tpu.native import runtime as native_runtime

        return native_runtime.decompress(data, header)
    if backend == "jax":
        from felics_tpu.core import jax_codec

        return jax_codec.decompress_image_bytes(data, header)
    if backend != "oracle":
        raise ValueError(f"unknown backend {backend!r}")

    config = config_for_depth(header.pixel_depth)
    dtype = _DTYPES[header.pixel_depth]
    reader = BitReader(data, start_bit=14 * 8)
    w, h = header.width, header.height

    if header.color_type == ColorType.GRAY:
        channel = oracle.decompress_channel(w, h, config, reader)
        return _to_dtype(channel, dtype).reshape(h, w)

    y = oracle.decompress_channel(w, h, config, reader)
    co = oracle.decompress_channel(w, h, config, reader)
    cg = oracle.decompress_channel(w, h, config, reader)
    _check_i32(y), _check_i32(co), _check_i32(cg)
    r, g, b = ycocg_to_rgb(
        y.astype(np.int32), co.astype(np.int32), cg.astype(np.int32)
    )
    rgb = np.stack(
        [_to_dtype(r, dtype), _to_dtype(g, dtype), _to_dtype(b, dtype)], axis=-1
    )
    return rgb.reshape(h, w, 3)


def probe(data: bytes) -> dict:
    """Container-agnostic header-only metadata read (no payload decode).

    Reference counterpart: read_header used standalone
    (src/compression/traits.rs:57-64, DOC.md capability list). Extends it to
    the FLCT container: returns tile geometry and stream count when tiled.
    """
    if data[:4] == b"FLCT":
        from felics_tpu.parallel.tiling import read_tiled_header

        h = read_tiled_header(data)
        return {
            "container": "flct",
            "color_type": h.color_type.name.lower(),
            "pixel_depth": h.pixel_depth.bits,
            "width": h.width,
            "height": h.height,
            "tile_w": h.tile_w,
            "tile_h": h.tile_h,
            "n_tiles": h.n_tiles,
            "payload_bytes": int(h.tile_lengths.sum()),
        }
    h = read_header(io.BytesIO(data))
    return {
        "container": "flcs",
        "color_type": h.color_type.name.lower(),
        "pixel_depth": h.pixel_depth.bits,
        "width": h.width,
        "height": h.height,
    }


def _check_i32(arr: np.ndarray) -> None:
    if arr.size and (arr.min() < -(2**31) or arr.max() > 2**31 - 1):
        raise errors.ValueOverflow("channel value overflows i32")


def _to_dtype(channel: np.ndarray, dtype) -> np.ndarray:
    info = np.iinfo(dtype)
    if channel.size and (channel.min() < info.min or channel.max() > info.max):
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
    return channel.astype(dtype)
