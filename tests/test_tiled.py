"""FLCT tiled format tests.

Round-trips through the vectorized encoder + vmapped scan decoder, plus an
independent scalar cross-check: each tile's payload is also decoded with the
pure-Python oracle (bucketed-k mode) to pin the bitstream layout.
"""

import numpy as np
import pytest

from felics_tpu.coding.bitio import BitReader
from felics_tpu.config import TileConfig, tiled_config_for_depth
from felics_tpu.core import oracle
from felics_tpu.core.color import ycocg_to_rgb
from felics_tpu.format import ColorType, PixelDepth
from felics_tpu.parallel.tiling import (
    _FIXED_HEADER,
    compress_tiled_bytes,
    decompress_tiled_bytes,
    read_tiled_header,
)


def random_image(rng, width, height, dtype, channels=None):
    high = np.iinfo(dtype).max + 1
    shape = (height, width) if channels is None else (height, width, channels)
    return rng.integers(0, high, size=shape).astype(dtype)


def smooth_image(rng, width, height, dtype, channels=None):
    shape = (height, width) if channels is None else (height, width, channels)
    steps = rng.integers(-6, 7, size=shape)
    img = np.cumsum(np.cumsum(steps, axis=0), axis=1) + 128
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


TILE16 = TileConfig(tile_h=16, tile_w=16)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_gray_round_trip(rng, dtype):
    for w, h in [(16, 16), (33, 17), (64, 48), (7, 5)]:
        for maker in (random_image, smooth_image):
            img = maker(rng, w, h, dtype)
            data = compress_tiled_bytes(img, TILE16)
            out = decompress_tiled_bytes(data)
            np.testing.assert_array_equal(out, img)
            assert out.dtype == img.dtype


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_rgb_round_trip(rng, dtype):
    for w, h in [(16, 16), (40, 24), (9, 31)]:
        img = smooth_image(rng, w, h, dtype, channels=3)
        data = compress_tiled_bytes(img, TILE16)
        out = decompress_tiled_bytes(data)
        np.testing.assert_array_equal(out, img)


def test_header_fields(rng):
    img = random_image(rng, 40, 24, np.uint8)
    data = compress_tiled_bytes(img, TILE16)
    hdr = read_tiled_header(data)
    assert (hdr.width, hdr.height) == (40, 24)
    assert (hdr.tile_w, hdr.tile_h) == (16, 16)
    assert hdr.n_tiles == 2 * 3  # ceil(24/16) x ceil(40/16)
    assert hdr.tile_lengths.sum() + hdr.payload_off == len(data)
    # v2: u16 length table + k-prior block (1 channel x 6 capped buckets
    # -> 3 B; nb = min(bit_length(max_context), QCTX_CAP) + 1)
    from felics_tpu.parallel.tiling import FLAG_K_PRIOR, FLAG_TABLE_U16

    assert hdr.flags == FLAG_TABLE_U16 | FLAG_K_PRIOR
    assert hdr.k0.shape == (1, 6)
    assert hdr.payload_off == _FIXED_HEADER.size + 3 + 2 * hdr.n_tiles


def test_legacy_v0_streams_decode(rng):
    """k_prior=False emits a flags=0 (v0) container that decodes exactly."""
    img = smooth_image(rng, 48, 40, np.uint8)
    v0 = compress_tiled_bytes(img, TILE16, k_prior=False)
    hdr = read_tiled_header(v0)
    assert hdr.flags == 0 and hdr.k0 is None
    assert hdr.payload_off == _FIXED_HEADER.size + 4 * hdr.n_tiles
    np.testing.assert_array_equal(decompress_tiled_bytes(v0), img)
    # the prior strictly helps on adapted content: v2 is never larger here
    v2 = compress_tiled_bytes(img, TILE16)
    assert len(v2) <= len(v0)


def test_degenerate_dims():
    for shape in [(0, 4), (4, 0), (1, 1), (1, 7), (7, 1)]:
        img = np.arange(np.prod(shape), dtype=np.uint8).reshape(shape) if np.prod(shape) else np.zeros(shape, np.uint8)
        data = compress_tiled_bytes(img, TILE16)
        out = decompress_tiled_bytes(data)
        np.testing.assert_array_equal(out, img)


def scalar_decode_tile_stream(tile_bytes, th, tw, channels, cfg, prior=None):
    """Independent scalar decode of one tile stream (oracle, bucketed k,
    depth-sized preamble: plane 0 unsigned depth bits, Co/Cg signed +1;
    ``prior``: (C, nb, K) v2 k-table seed or None)."""
    reader = BitReader(tile_bytes)
    planes = []
    for ch in range(channels):
        planes.append(
            oracle.decompress_channel(
                tw, th, cfg, reader, bucketed_k=True,
                pre_bits=cfg.depth_bits + (1 if ch > 0 else 0),
                pre_signed=ch > 0,
                prior=None if prior is None else prior[ch],
            )
        )
    return planes


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_scalar_cross_validation(rng, dtype):
    """The vectorized tile streams decode identically with the Python oracle."""
    from felics_tpu.parallel.tiling import prior_from_k0

    img = smooth_image(rng, 35, 21, dtype, channels=3)
    data = compress_tiled_bytes(img, TILE16)
    hdr = read_tiled_header(data)
    cfg = tiled_config_for_depth(hdr.pixel_depth)
    th, tw = hdr.tile_h, hdr.tile_w
    ty = -(-hdr.height // th)
    tx = -(-hdr.width // tw)
    prior = prior_from_k0(hdr.k0, cfg, 3)

    payload_off = hdr.payload_off
    offsets = np.concatenate([[0], np.cumsum(hdr.tile_lengths)])
    full = decompress_tiled_bytes(data)

    # scalar-decode every tile and compare against the full decode
    for t in range(hdr.n_tiles):
        tile_data = data[payload_off + offsets[t] : payload_off + offsets[t + 1]]
        planes = scalar_decode_tile_stream(tile_data, th, tw, 3, cfg, prior)
        r, g, b = ycocg_to_rgb(
            planes[0].astype(np.int32).reshape(th, tw),
            planes[1].astype(np.int32).reshape(th, tw),
            planes[2].astype(np.int32).reshape(th, tw),
        )
        tyi, txi = divmod(t, tx)
        y0, x0 = tyi * th, txi * tw
        y1, x1 = min(y0 + th, hdr.height), min(x0 + tw, hdr.width)
        expect = full[y0:y1, x0:x1]
        got = np.stack([r, g, b], axis=-1)[: y1 - y0, : x1 - x0]
        np.testing.assert_array_equal(got, expect, err_msg=f"tile {t}")


def test_tile_independence(rng):
    """Corrupting one tile's payload must not affect other tiles."""
    img = smooth_image(rng, 48, 48, np.uint8)
    data = compress_tiled_bytes(img, TILE16)
    hdr = read_tiled_header(data)
    payload_off = hdr.payload_off
    offsets = np.concatenate([[0], np.cumsum(hdr.tile_lengths)])
    # corrupt a byte in the middle of tile 4 (interior tile)
    bad = bytearray(data)
    mid = payload_off + (offsets[4] + offsets[5]) // 2
    bad[int(mid)] ^= 0x55
    try:
        out = decompress_tiled_bytes(bytes(bad))
    except Exception:
        return  # clean error is fine
    # tiles other than 4 decode identically
    for t in [0, 1, 2, 3, 5, 6, 7, 8]:
        tyi, txi = divmod(t, 3)
        y0, x0 = tyi * 16, txi * 16
        np.testing.assert_array_equal(
            out[y0 : y0 + 16, x0 : x0 + 16], img[y0 : y0 + 16, x0 : x0 + 16]
        )


def test_compression_ratio_near_flcs(rng):
    """Tiled overhead stays small on a realistic smooth image."""
    from felics_tpu.api import compress_image_bytes

    img = smooth_image(rng, 128, 128, np.uint8)
    flcs = len(compress_image_bytes(img, backend="oracle"))
    flct = len(compress_tiled_bytes(img, TileConfig(tile_h=64, tile_w=64)))
    assert flct < flcs * 1.06


def test_long_unary_fallback():
    """Force k=0 with a huge residual: the decoder's unary run overruns the
    64-bit fast window and must take the fallback loop."""
    img = np.zeros((16, 16), dtype=np.uint16)
    # Drive bucket-0 k toward 0 with many residual-0 out-of-range pixels
    # (alternating +1 steps), then plant a huge outlier.
    img[0, ::2] = 1
    img[1:, :] = 0
    img[8, 8] = 65535
    data = compress_tiled_bytes(img, TILE16)
    out = decompress_tiled_bytes(data)
    np.testing.assert_array_equal(out, img)


def test_long_unary_fallback_kernel():
    """The same overrun, decoded by the Pallas kernel: its unary run leaves
    the 64-bit window and takes the kernel's own slow loop."""
    img = np.zeros((16, 16), dtype=np.uint16)
    img[0, ::2] = 1
    img[8, 8] = 65535
    data = compress_tiled_bytes(img, TILE16)
    out = decompress_tiled_bytes(data, engine="pallas")
    np.testing.assert_array_equal(out, img)


def test_payload_words_match_host_columns(rng):
    """_payload_words (the decoders' upload: big-endian words of the
    concatenated streams + each tile's first bit) against the per-tile word
    rows of _payload_to_columns (the sharded decoders' unit), including
    byte-irregular tile boundaries."""
    from felics_tpu.parallel import tiling

    L = 37
    tb = rng.integers(1, 80, (L,)).astype(np.int64)
    payload = rng.integers(0, 256, int(tb.sum()), dtype=np.uint8).tobytes()
    words, starts = tiling._payload_words(payload, tb)
    assert words.dtype == np.uint32 and len(words) * 4 >= len(payload) + 4
    flat = words.astype(">u4").tobytes()
    assert flat[: len(payload)] == payload
    assert not any(flat[len(payload):])
    byte_starts = np.concatenate([[0], np.cumsum(tb)[:-1]])
    np.testing.assert_array_equal(starts, byte_starts * 8)

    wd = tiling.bucket_words(int((tb.max() + 3) // 4))
    rows = tiling._payload_to_columns(payload, byte_starts, tb, wd)
    for i in range(L):
        got = rows[i].astype(">u4").tobytes()
        ref = payload[byte_starts[i] : byte_starts[i] + tb[i]]
        assert got[: tb[i]] == ref
        assert not any(got[tb[i]:])
    assert tiling._columns_to_payload(rows, tb) == payload


def test_onepass_toy_tiles_fall_back(rng):
    """Tiny tiles (streams of a few bytes) encode to the native codec's
    bytes and decode with both engines."""
    from felics_tpu.api import header_for_array
    from felics_tpu.native import runtime as native_runtime

    img = rng.integers(0, 256, (4, 4), dtype=np.uint8)
    tc = TileConfig(tile_h=2, tile_w=2)
    data = compress_tiled_bytes(img, tc)
    if native_runtime.available():
        assert data == native_runtime.compress_tiled(
            img, header_for_array(img), 2, 2
        )
    for engine in ("xla", "pallas"):
        np.testing.assert_array_equal(decompress_tiled_bytes(data, engine), img)


def test_odd_tiny_rgb_tiles_decode_kernel(rng):
    """Odd tiny rgb tile planes (5x3, 2x3: no power-of-two anything) decode
    through the Pallas kernel exactly; the kernel has no block-shape rule
    on the tile plane, only on the lane block."""
    img = rng.integers(0, 256, (11, 7, 3), dtype=np.uint8)
    for tile in ((5, 3), (2, 3)):
        data = compress_tiled_bytes(img, TileConfig(*tile))
        np.testing.assert_array_equal(
            decompress_tiled_bytes(data, engine="pallas"), img
        )
