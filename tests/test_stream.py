"""Pipelined streaming serving API (parallel.batch.*_tiled_stream).

The stream keeps N batches in flight (dispatch batch i+1 before fetching
batch i) to overlap host work, transfers and compute; output must be
byte/pixel-identical to the one-shot batched API for every decode engine.
"""

import jax
import numpy as np
import pytest

from felics_tpu.config import TileConfig


# NOTE: compile-state hygiene for this module (and the other heavy
# interpret-Pallas modules) lives in conftest.py
# (_clear_caches_between_heavy_modules).
from felics_tpu.parallel.batch import (
    compress_tiled_batch,
    compress_tiled_stream,
    decompress_tiled_batch,
    decompress_tiled_stream,
)

TILE16 = TileConfig(tile_h=16, tile_w=16)


def smooth(rng, w, h, dtype=np.uint8, channels=None):
    shape = (h, w) if channels is None else (h, w, channels)
    img = np.cumsum(np.cumsum(rng.integers(-6, 7, shape), 0), 1) + 128
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_stream_matches_batch(rng, engine):
    batches = [
        [smooth(rng, 64, 48), smooth(rng, 48, 64)],
        [smooth(rng, 32, 32)],
        [],
        [smooth(rng, 80, 16)],
    ]
    ref = [compress_tiled_batch(b, TILE16) for b in batches]
    got = compress_tiled_stream(batches, TILE16)
    assert got == ref
    dec = decompress_tiled_stream(ref, engine)
    for out_list, img_list in zip(dec, batches):
        for out, img in zip(out_list, img_list):
            np.testing.assert_array_equal(out, img)


def test_stream_rgb16(rng):
    batches = [
        [smooth(rng, 32, 32, np.uint16, 3)],
        [smooth(rng, 48, 16, np.uint16, 3), smooth(rng, 16, 48, np.uint16, 3)],
    ]
    ref = [compress_tiled_batch(b, TILE16) for b in batches]
    got = compress_tiled_stream(batches, TILE16)
    assert got == ref
    dec = decompress_tiled_stream(got)
    for out_list, img_list in zip(dec, batches):
        for out, img in zip(out_list, img_list):
            np.testing.assert_array_equal(out, img)


def test_stream_depth_one_and_three(rng):
    batches = [[smooth(rng, 48, 48)] for _ in range(5)]
    ref = [compress_tiled_batch(b, TILE16) for b in batches]
    for depth in (1, 3):
        assert compress_tiled_stream(batches, TILE16, depth=depth) == ref


@pytest.mark.parametrize("channels", [None, 3])
def test_same_shape_images_fast_path_bytes_identical(rng, channels):
    # Same-shape batches take the raw-pixel device path (upload original
    # dtype, YCoCg/tiling on device; decode assembles on device). Bytes
    # must equal the host-prep per-image encoder exactly.
    from felics_tpu.parallel import tiling

    images = [smooth(rng, 64, 48, np.uint8, channels) for _ in range(3)]
    ref = [tiling.compress_tiled_bytes(im, TILE16) for im in images]
    got = compress_tiled_batch(images, TILE16)
    assert got == ref
    outs = decompress_tiled_batch(got, "pallas")
    for im, out in zip(images, outs):
        np.testing.assert_array_equal(out, im)
        assert out.dtype == im.dtype
    # and through the stream
    assert compress_tiled_stream([images], TILE16) == [ref]
    souts = decompress_tiled_stream([got], "pallas")[0]
    for im, out in zip(images, souts):
        np.testing.assert_array_equal(out, im)


def test_same_shape_corrupt_batch_raises(rng):
    # The images fast path validates decoded ranges per image on device.
    from felics_tpu import errors

    images = [smooth(rng, 48, 48) for _ in range(2)]
    blobs = compress_tiled_batch(images, TILE16)
    bad = blobs[1][: len(blobs[1]) // 2] + b"\xff" * (
        len(blobs[1]) - len(blobs[1]) // 2
    )
    try:
        outs = decompress_tiled_batch([blobs[0], bad], "pallas")
        # tolerated only if the corruption decoded to in-range pixels AND
        # the first image is still exact
        np.testing.assert_array_equal(outs[0], images[0])
    except errors.DecompressionError:
        pass


def test_stream_mixed_geometry_fallback(rng):
    # An image smaller than the tile forces the per-image fallback path.
    batches = [[smooth(rng, 8, 8), smooth(rng, 64, 64)]]
    ref = [compress_tiled_batch(b, TILE16) for b in batches]
    assert compress_tiled_stream(batches, TILE16) == ref
    dec = decompress_tiled_stream(ref)
    np.testing.assert_array_equal(dec[0][0], batches[0][0])
    np.testing.assert_array_equal(dec[0][1], batches[0][1])
