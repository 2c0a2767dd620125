"""Batched multi-image FLCT API: containers identical to per-image encode."""

import numpy as np

from felics_tpu.config import TileConfig
from felics_tpu.parallel import tiling
from felics_tpu.parallel.batch import compress_tiled_batch, decompress_tiled_batch

TILE16 = TileConfig(tile_h=16, tile_w=16)


def smooth(rng, w, h, dtype=np.uint8, channels=None):
    shape = (h, w) if channels is None else (h, w, channels)
    img = np.cumsum(np.cumsum(rng.integers(-6, 7, shape), 0), 1) + 128
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


def test_batch_matches_per_image(rng):
    images = [smooth(rng, 48, 32), smooth(rng, 16, 16), smooth(rng, 33, 40)]
    batch = compress_tiled_batch(images, TILE16)
    single = [tiling.compress_tiled_bytes(im, TILE16) for im in images]
    assert batch == single


def test_batch_round_trip(rng):
    images = [smooth(rng, 48, 32, channels=3), smooth(rng, 32, 48, channels=3)]
    batch = compress_tiled_batch(images, TILE16)
    outs = decompress_tiled_batch(batch)
    for im, out in zip(images, outs):
        np.testing.assert_array_equal(out, im)


def test_batch_decode_of_per_image_containers(rng):
    images = [smooth(rng, 32, 32), smooth(rng, 64, 16)]
    datas = [tiling.compress_tiled_bytes(im, TILE16) for im in images]
    outs = decompress_tiled_batch(datas)
    for im, out in zip(images, outs):
        np.testing.assert_array_equal(out, im)


def test_batch_small_image_fallback(rng):
    # An image smaller than the tile clamps tile dims -> per-image fallback.
    images = [smooth(rng, 8, 8), smooth(rng, 32, 32)]
    batch = compress_tiled_batch(images, TILE16)
    single = [tiling.compress_tiled_bytes(im, TILE16) for im in images]
    assert batch == single


def test_empty_batch():
    assert compress_tiled_batch([]) == []
    assert decompress_tiled_batch([]) == []


def test_batch_decode_corruption_raises_or_is_exact(rng):
    """Corrupting one image's payload in a batch must either raise a clean
    DecompressionError or decode other images exactly — never silently wrap
    garbage values through the narrow-dtype fetch (tiling._narrow_bufs
    flags values outside the plane bounds before the cast)."""
    import pytest

    from felics_tpu import errors

    images = [smooth(rng, 32, 32), smooth(rng, 32, 32), smooth(rng, 32, 32)]
    blobs = compress_tiled_batch(images, TILE16)
    hdr = tiling.read_tiled_header(blobs[1])
    bad = bytearray(blobs[1])
    # flood tile 0's stream with ones: long unary runs decode to huge
    # residuals far outside any valid plane range
    for off in range(hdr.payload_off, min(hdr.payload_off + 8, len(bad))):
        bad[off] = 0xFF
    batch = [blobs[0], bytes(bad), blobs[2]]
    try:
        outs = decompress_tiled_batch(batch)
    except errors.DecompressionError:
        pass  # clean, typed failure
    else:
        # images 0 and 2 must still be exact; image 1 may be garbage but
        # must have the right shape/dtype
        np.testing.assert_array_equal(outs[0], images[0])
        np.testing.assert_array_equal(outs[2], images[2])
        assert outs[1].shape == images[1].shape
        assert outs[1].dtype == images[1].dtype
    # the clean blobs keep decoding exactly on their own
    for im, d in ((images[0], blobs[0]), (images[2], blobs[2])):
        np.testing.assert_array_equal(tiling.decompress_tiled_bytes(d), im)


def _native_bytes(images, tile):
    from felics_tpu.api import header_for_array
    from felics_tpu.native import runtime as native_runtime

    if not native_runtime.available():
        return None
    return [
        native_runtime.compress_tiled(
            im, header_for_array(im), tile.tile_w, tile.tile_h
        )
        for im in images
    ]


def test_batch_pallas_onepass_matches_xla(rng):
    """Mixed-shape batches ("tiles" path, per-image k-prior seeds through
    the tile-group gather), both depths: the batch encoder's containers
    equal the native codec's, and the Pallas decode kernel round-trips
    them."""
    from felics_tpu.parallel import batch

    for dtype in (np.uint8, np.uint16):
        images = [
            smooth(rng, 32, 32, dtype),
            smooth(rng, 48, 16, dtype),
        ]
        blobs = compress_tiled_batch(images, TILE16)
        assert batch.LAST_PATH["encode"] == "tiles"
        native = _native_bytes(images, TILE16)
        if native is not None:
            assert blobs == native, f"{dtype}: batch bytes != native"
        outs = decompress_tiled_batch(blobs, engine="pallas")
        assert batch.LAST_PATH["decode"] == "tiles"
        assert tiling.LAST_ENGINE["decode"] == "pallas"
        for im, out in zip(images, outs):
            np.testing.assert_array_equal(out, im)


def test_batch_pallas_rgb_round_trip(rng):
    images = [smooth(rng, 32, 16, channels=3), smooth(rng, 16, 32, channels=3)]
    blobs = compress_tiled_batch(images, TILE16)
    native = _native_bytes(images, TILE16)
    if native is not None:
        assert blobs == native
    outs = decompress_tiled_batch(blobs, engine="pallas")
    for im, out in zip(images, outs):
        np.testing.assert_array_equal(out, im)


def test_fast_paths_engage_for_uniform_batches(rng):
    """The serving paths are chosen from the batch's shapes; a silent
    fallback to a slower path is the failure to catch. Pin via
    batch.LAST_PATH that uniform same-shape batches take the raw-pixel
    device path BOTH directions for all three pixel classes (decode through
    the Pallas kernel; interpret mode on CPU)."""
    from felics_tpu.parallel import batch

    tc = TileConfig(16, 16)
    cases = [
        ((48, 64), np.uint8, 6),
        ((48, 64, 3), np.uint8, 6),
        ((48, 64), np.uint16, 700),
    ]
    for shape, dtype, step in cases:
        imgs = []
        for _ in range(3):
            base = np.cumsum(
                np.cumsum(rng.integers(-step, step + 1, shape), 0), 1
            ).astype(np.int64)
            imgs.append(
                np.clip(base + np.iinfo(dtype).max // 2, 0,
                        np.iinfo(dtype).max).astype(dtype)
            )
        blobs = batch.compress_tiled_batch(imgs, tc)
        assert batch.LAST_PATH["encode"] == "images", (shape, dtype)
        outs = batch.decompress_tiled_batch(blobs, engine="pallas")
        assert batch.LAST_PATH["decode"] == "images", (shape, dtype)
        assert tiling.LAST_ENGINE["decode"] == "pallas"
        for a, b in zip(imgs, outs):
            np.testing.assert_array_equal(a, b)
