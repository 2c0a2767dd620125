"""Per-item error isolation in the batched decode APIs and the
truncated-FLCT-payload batch hole.

The reference decodes images independently by construction; a serving API
must not discard a whole batch because one member is corrupt. These tests
pin: (1) ``on_error="isolate"`` returns per-member results/exceptions for
both container formats, (2) the default ``on_error="raise"`` now rejects a
truncated FLCT payload in the batch path exactly like the per-image path
(previously it zero-padded and decoded wrong pixels), (3) the jax FLCS
scan decoder's explicit unary-overrun flag (r4 advisor, low).
"""

import numpy as np
import pytest

from felics_tpu import errors
from felics_tpu.api import compress_image_bytes
from felics_tpu.config import TileConfig, config_for_depth
from felics_tpu.format import PixelDepth


def _smooth(rng, w, h, dtype=np.uint8):
    img = np.cumsum(np.cumsum(rng.integers(-6, 7, (h, w)), 0), 1) + 128
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


# ---------------------------------------------------------------------------
# FLCT batch
# ---------------------------------------------------------------------------


def _flct(img):
    return compress_image_bytes(img, container="flct", tile=TileConfig(16, 16))


def test_flct_batch_truncated_payload_raises(rng):
    # r4 advisor (medium): a truncated FLCT payload in a uniform batch was
    # silently zero-padded and decoded to WRONG pixels; the per-image path
    # raises IoError. The batch path must match it.
    from felics_tpu.parallel.batch import decompress_tiled_batch

    imgs = [_smooth(rng, 48, 40) for _ in range(2)]
    datas = [_flct(im) for im in imgs]
    truncated = datas[1][:-5]
    with pytest.raises(errors.IoError):
        decompress_tiled_batch([datas[0], truncated])


def test_flct_stream_truncated_payload_raises(rng):
    from felics_tpu.parallel.batch import decompress_tiled_stream

    imgs = [_smooth(rng, 48, 40) for _ in range(2)]
    datas = [_flct(im) for im in imgs]
    with pytest.raises(errors.IoError):
        decompress_tiled_stream([[datas[0], datas[1][:-5]]])


def test_flct_batch_isolate_good_members_survive(rng):
    from felics_tpu.parallel.batch import decompress_tiled_batch

    imgs = [_smooth(rng, 48, 40) for _ in range(3)]
    datas = [_flct(im) for im in imgs]
    bad = datas[1][:-5]  # truncated payload
    out = decompress_tiled_batch(
        [datas[0], bad, datas[2]], on_error="isolate"
    )
    assert len(out) == 3
    np.testing.assert_array_equal(out[0], imgs[0])
    assert isinstance(out[1], errors.IoError)
    np.testing.assert_array_equal(out[2], imgs[2])


def test_flct_batch_isolate_corrupt_header(rng):
    from felics_tpu.parallel.batch import decompress_tiled_batch

    imgs = [_smooth(rng, 48, 40) for _ in range(2)]
    datas = [_flct(im) for im in imgs]
    bad = datas[0][:14] + b"\x00\x00" + datas[0][16:]  # tile_w = 0
    out = decompress_tiled_batch([bad, datas[1]], on_error="isolate")
    assert isinstance(out[0], errors.DecompressionError)
    np.testing.assert_array_equal(out[1], imgs[1])


def test_flct_batch_isolate_all_good_matches_raise(rng):
    from felics_tpu.parallel.batch import decompress_tiled_batch

    imgs = [_smooth(rng, 48, 40) for _ in range(3)]
    datas = [_flct(im) for im in imgs]
    a = decompress_tiled_batch(datas)
    b = decompress_tiled_batch(datas, on_error="isolate")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_flct_batch_bad_on_error_value(rng):
    from felics_tpu.parallel.batch import decompress_tiled_batch

    with pytest.raises(ValueError):
        decompress_tiled_batch([], on_error="ignore")


# ---------------------------------------------------------------------------
# FLCS batched scan decode
# ---------------------------------------------------------------------------


def test_flcs_batch_isolate_good_members_survive(rng):
    from felics_tpu.core.jax_codec import decompress_images_bytes

    imgs = [_smooth(rng, 32, 24) for _ in range(3)]
    datas = [compress_image_bytes(im, backend="oracle") for im in imgs]
    bad = datas[1][: 14 + 8]  # truncated payload
    out = decompress_images_bytes([datas[0], bad, datas[2]],
                                  on_error="isolate")
    assert len(out) == 3
    np.testing.assert_array_equal(out[0], imgs[0])
    assert isinstance(out[1], errors.DecompressionError)
    np.testing.assert_array_equal(out[2], imgs[2])


def test_flcs_batch_isolate_corrupt_header(rng):
    from felics_tpu.core.jax_codec import decompress_images_bytes

    imgs = [_smooth(rng, 32, 24) for _ in range(2)]
    datas = [compress_image_bytes(im, backend="oracle") for im in imgs]
    bad = b"NOTF" + datas[0][4:]  # broken signature
    out = decompress_images_bytes([datas[0], bad], on_error="isolate")
    np.testing.assert_array_equal(out[0], imgs[0])
    assert isinstance(out[1], errors.DecompressionError)


def test_flcs_batch_raise_mode_still_raises(rng):
    from felics_tpu.core.jax_codec import decompress_images_bytes

    imgs = [_smooth(rng, 32, 24) for _ in range(2)]
    datas = [compress_image_bytes(im, backend="oracle") for im in imgs]
    with pytest.raises(errors.DecompressionError):
        decompress_images_bytes([datas[0], datas[1][: 14 + 8]])


# ---------------------------------------------------------------------------
# Unary overrun flag (r4 advisor, low)
# ---------------------------------------------------------------------------


def test_scan_decoder_unary_overrun_flag():
    """A corrupt all-ones tail whose unary runaway hits the word-buffer end
    must set the explicit ``overran`` flag: for a word-aligned payload the
    end-position check alone cannot catch a runaway landing exactly on
    payload_bits. Crafted stream: two raw 32-bit pixels, then one
    out-of-range symbol ("00") whose unary run is ones to the end of the
    buffer (the clamped gather would otherwise keep feeding ones)."""
    import jax.numpy as jnp

    from felics_tpu.core.jax_codec import decode_channel_scan

    cfg = config_for_depth(PixelDepth.EIGHT)
    words = jnp.asarray([5, 9, 0x3FFFFFFF, 0xFFFFFFFF], jnp.uint32)
    _buf, _end, overran = decode_channel_scan(words, 0, 3, 1, cfg)
    assert bool(overran)


def test_scan_decoder_no_overrun_on_valid_stream(rng):
    from felics_tpu.core.jax_codec import _bits_to_words, decode_channel_scan

    img = _smooth(rng, 16, 12)
    data = compress_image_bytes(img, backend="oracle")
    cfg = config_for_depth(PixelDepth.EIGHT)
    words, _ = _bits_to_words(data[14:], 0)
    buf, end, overran = decode_channel_scan(words, 0, 12, 16, cfg)
    assert not bool(overran)
    np.testing.assert_array_equal(
        np.asarray(buf).reshape(12, 16).astype(np.uint8), img
    )


def test_flct_batch_isolate_random_corruption_fuzz(rng):
    """Random corruptions under on_error='isolate': every member either
    decodes (good members ALWAYS byte-exact) or carries a
    DecompressionError — never an exception escaping the call, never a
    poisoned neighbour."""
    from felics_tpu.parallel.batch import decompress_tiled_batch

    imgs = [_smooth(rng, 48, 40) for _ in range(3)]
    datas = [_flct(im) for im in imgs]
    for _ in range(8):
        victim = int(rng.integers(0, 3))
        pos = int(rng.integers(0, len(datas[victim])))
        flip = bytes([datas[victim][pos] ^ (1 << int(rng.integers(0, 8)))])
        bad = datas[victim][:pos] + flip + datas[victim][pos + 1 :]
        blobs = [bad if i == victim else datas[i] for i in range(3)]
        out = decompress_tiled_batch(blobs, on_error="isolate")
        assert len(out) == 3
        for i in range(3):
            if i == victim:
                assert isinstance(out[i], (np.ndarray, errors.DecompressionError))
            else:
                np.testing.assert_array_equal(out[i], imgs[i])


def test_flct_stream_isolate(rng):
    """Streaming decode with on_error='isolate': corrupt members fail in
    place across batches; good members stay byte-exact and pipelined."""
    from felics_tpu.parallel.batch import (
        compress_tiled_stream,
        decompress_tiled_stream,
    )

    imgs = [_smooth(rng, 48, 40) for _ in range(6)]
    datas = [_flct(im) for im in imgs]
    batches = [
        [datas[0], datas[1][:-5], datas[2]],       # truncated member
        [datas[3][:10], datas[4]],                 # truncated header
        [datas[5]],
    ]
    out = decompress_tiled_stream(batches, on_error="isolate")
    assert [len(b) for b in out] == [3, 2, 1]
    np.testing.assert_array_equal(out[0][0], imgs[0])
    assert isinstance(out[0][1], errors.DecompressionError)
    np.testing.assert_array_equal(out[0][2], imgs[2])
    assert isinstance(out[1][0], errors.DecompressionError)
    np.testing.assert_array_equal(out[1][1], imgs[4])
    np.testing.assert_array_equal(out[2][0], imgs[5])
    # raise-mode equivalence on all-good streams
    good = [[datas[0], datas[2]], [datas[4]]]
    a = decompress_tiled_stream(good)
    b = decompress_tiled_stream(good, on_error="isolate")
    for ba, bb in zip(a, b):
        for x, y in zip(ba, bb):
            np.testing.assert_array_equal(x, y)
