"""The Pallas decode kernel (ops.pallas_decode, interpreter mode on CPU; the
same code compiles through Triton on the GPU) against the XLA decoder, and
the XLA encoder's container bytes against the native C++ codec's.

The XLA pipeline (stage1/stage2/bitpack + scan decoder) is itself pinned
byte-for-byte against the scalar oracle and the native C++ core, so equality
here chains the kernel into the same cross-validation web.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from felics_tpu.config import TileConfig, tiled_config_for_depth
from felics_tpu.format import PixelDepth
from felics_tpu.native import runtime as native_runtime
from felics_tpu.ops import pallas_decode as pd
from felics_tpu.ops.kscan_tiled import num_buckets
from felics_tpu.parallel import tiling


def _image(shape, depth_max, seed, smooth=True):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth_max == 255 else np.uint16
    if smooth:
        base = rng.integers(-3, 4, shape).cumsum(axis=1) + depth_max // 2
        return np.clip(base, 0, depth_max).astype(dt)
    return rng.integers(0, depth_max + 1, shape).astype(dt)


def _native_bytes(img, tile):
    """The native C++ FLCT encoder's container for the same tile size."""
    from felics_tpu.api import header_for_array

    if not native_runtime.available():
        pytest.skip("native core not built")
    return native_runtime.compress_tiled(
        img, header_for_array(img), tile[1], tile[0]
    )


CASES = [
    ((24, 24), 255, (8, 8), True),
    ((16, 16), 255, (4, 4), False),
    ((16, 24), 65535, (8, 8), True),
    ((13, 9), 255, (5, 3), False),
    ((16, 16, 3), 255, (8, 8), True),
    ((8, 8, 3), 65535, (4, 4), False),
]


@pytest.mark.parametrize("shape,depth_max,tile,smooth", CASES)
def test_container_bytes_match_xla(shape, depth_max, tile, smooth):
    img = _image(shape, depth_max, hash((shape, depth_max)) % 1000, smooth)
    tc = TileConfig(tile_h=tile[0], tile_w=tile[1])
    blob = tiling.compress_tiled_bytes(img, tc)
    assert blob == _native_bytes(img, tile)

    out_p = tiling.decompress_tiled_bytes(blob, engine="pallas")
    assert np.array_equal(out_p, img)
    assert tiling.LAST_ENGINE["decode"] == "pallas"
    out_x = tiling.decompress_tiled_bytes(blob, engine="xla")
    assert np.array_equal(out_x, img)
    assert tiling.LAST_ENGINE["decode"] == "xla"


def test_kernel_streams_match_symbol_pipeline():
    """Per-tile planes from the kernel == the XLA scan decoder's, for a
    multi-image batch whose images carry distinct k-prior seeds (the
    per-tile seed-group gather) and a lane count that is not a multiple of
    the lane block (padded lanes)."""
    from felics_tpu.parallel.batch import _prep_decode_batch, compress_tiled_batch

    imgs = [_image((40, 24), 255, s) for s in (3, 4, 5)]
    blobs = compress_tiled_batch(imgs, TileConfig(8, 8))
    prep = _prep_decode_batch(blobs)
    words, starts = tiling._payload_words(prep["payload"], prep["lens"])
    cfg = prep["cfg"]
    args = (jnp.asarray(words), jnp.asarray(starts), 8, 8, 1, cfg,
            num_buckets(cfg), jnp.asarray(prep["priors"]),
            jnp.asarray(prep["tile_group"], jnp.int32))
    assert starts.shape[0] % pd.lane_block(starts.shape[0]) != 0
    ref = np.asarray(tiling._decode_tiles(*args))
    got = np.asarray(pd.decode_tiles(*args))
    np.testing.assert_array_equal(got, ref)


def test_decode_tolerates_corrupt_columns():
    """Corrupt streams must terminate and fail validation, never hang."""
    img = _image((16, 16), 255, 9)
    tc = TileConfig(tile_h=8, tile_w=8)
    blob = bytearray(tiling.compress_tiled_bytes(img, tc))
    hdr = tiling.read_tiled_header(bytes(blob))
    blob[hdr.payload_off + 3] ^= 0xFF
    try:
        out = tiling.decompress_tiled_bytes(bytes(blob), engine="pallas")
        assert out.shape == img.shape  # decoded-but-wrong is acceptable
    except Exception as exc:  # must be our error type, not a crash
        from felics_tpu import errors

        assert isinstance(exc, errors.DecompressionError)


def test_decode_refuses_unknown_engine_and_oversized_payload():
    """The engine is resolved before dispatch: a name that is not an engine
    raises, and a payload past the int32 bit cursor is refused instead of
    being handed to another engine."""
    img = _image((16, 16), 255, 11)
    blob = tiling.compress_tiled_bytes(img, TileConfig(8, 8))
    with pytest.raises(ValueError, match="unknown decode engine"):
        tiling.decompress_tiled_bytes(blob, engine="mosaic")
    with pytest.raises(ValueError, match="int32 bit cursor"):
        tiling._payload_words(b"", np.array([1 << 28], np.int64))
    cfg = tiled_config_for_depth(PixelDepth.EIGHT)
    with pytest.raises(ValueError, match="int32 bit cursor"):
        jax.eval_shape(
            lambda w, s: pd.decode_tiles(w, s, 8, 8, 1, cfg, num_buckets(cfg)),
            jax.ShapeDtypeStruct((1 << 26,), jnp.uint32),
            jax.ShapeDtypeStruct((1,), jnp.int32),
        )


@pytest.mark.parametrize(
    "lanes,block",
    [(1, 32), (60, 32), (33_791, 32), (33_792, 64), (67_583, 64),
     (67_584, 128), (500_000, 128)],
)
def test_lane_block_choice(lanes, block):
    """Lanes per program: one warp until every SM would get at least four
    programs of a larger block, up to four warps (one lane per thread)."""
    assert pd.lane_block(lanes) == block


def test_flct_backend_choice(monkeypatch):
    """auto routes FLCT to the device pipeline on an accelerator and to the
    native C++ codec only when the process computes on the CPU; explicit
    choices are honored."""
    import felics_tpu.api as api
    from felics_tpu.utils import platform

    monkeypatch.setattr(platform, "backend", lambda: "gpu")
    assert api._flct_backend("auto") == "jax"
    monkeypatch.setattr(platform, "backend", lambda: "cpu")
    expected = "native" if native_runtime.available() else "jax"
    assert api._flct_backend("auto") == expected
    assert api._flct_backend("jax") == "jax"
    assert api._flct_backend("native") == "native"
    assert api._flct_backend("oracle") == "jax"


def test_decode_engine_and_interpret_choice(monkeypatch):
    """auto is the kernel on the GPU and the XLA scan on the CPU; the
    kernel runs interpreted only on the CPU platform."""
    from felics_tpu.utils import platform

    assert platform.backend() == "cpu"
    assert platform.interpret_kernels()
    assert tiling.resolve_decode_engine("auto") == "xla"
    assert tiling.resolve_decode_engine("pallas") == "pallas"
    monkeypatch.setattr(platform, "backend", lambda: "gpu")
    assert tiling.resolve_decode_engine("auto") == "pallas"
    assert tiling.resolve_decode_engine("xla") == "xla"
    assert not platform.interpret_kernels()
