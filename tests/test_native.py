"""Native C++ core tests: cross-validated byte-for-byte against the oracle."""

import numpy as np
import pytest

from felics_tpu.api import compress_image_bytes, decompress_image_bytes


@pytest.fixture(scope="module", autouse=True)
def built_native():
    import subprocess
    import sys

    subprocess.run([sys.executable, "native/build.py"], check=True)
    from felics_tpu.native import runtime

    runtime._load_attempted = False
    runtime._lib = None
    assert runtime.available()
    yield


def random_image(rng, width, height, dtype, channels=None):
    high = np.iinfo(dtype).max + 1
    shape = (height, width) if channels is None else (height, width, channels)
    return rng.integers(0, high, size=shape).astype(dtype)


CASES = [
    (np.uint8, None), (np.uint16, None), (np.uint8, 3), (np.uint16, 3),
]
DIMS = [(1, 1), (2, 1), (1, 2), (7, 4), (33, 17), (1, 50), (50, 1), (64, 64)]


@pytest.mark.parametrize("dtype,channels", CASES)
def test_native_matches_oracle_bytes(rng, dtype, channels):
    for width, height in DIMS:
        img = random_image(rng, width, height, dtype, channels)
        native = compress_image_bytes(img, backend="native")
        oracle = compress_image_bytes(img, backend="oracle")
        assert native == oracle, (dtype, channels, width, height)


@pytest.mark.parametrize("dtype,channels", CASES)
def test_native_round_trip(rng, dtype, channels):
    img = random_image(rng, 37, 23, dtype, channels)
    data = compress_image_bytes(img, backend="native")
    out = decompress_image_bytes(data, backend="native")
    np.testing.assert_array_equal(out, img)
    assert out.dtype == img.dtype


def test_native_decodes_oracle_and_vice_versa(rng):
    img = random_image(rng, 29, 31, np.uint8, 3)
    from_oracle = compress_image_bytes(img, backend="oracle")
    np.testing.assert_array_equal(
        decompress_image_bytes(from_oracle, backend="native"), img
    )
    from_native = compress_image_bytes(img, backend="native")
    np.testing.assert_array_equal(
        decompress_image_bytes(from_native, backend="oracle"), img
    )


def test_native_zero_area():
    img = np.zeros((0, 5), dtype=np.uint8)
    data = compress_image_bytes(img, backend="native")
    assert data == compress_image_bytes(img, backend="oracle")
    out = decompress_image_bytes(data, backend="native")
    assert out.shape == (0, 5)


def test_native_corrupt_stream_errors(rng):
    from felics_tpu import errors

    img = random_image(rng, 24, 24, np.uint8)
    data = bytearray(compress_image_bytes(img, backend="native"))
    ok = 0
    for pos in range(14, min(len(data), 150), 5):
        bad = bytearray(data)
        bad[pos] ^= 0xFF
        try:
            decompress_image_bytes(bytes(bad), backend="native")
        except errors.DecompressionError:
            ok += 1
    assert ok > 0  # most corruptions must surface as clean errors


def test_native_bad_signature():
    from felics_tpu import errors

    with pytest.raises(errors.InvalidSignature):
        decompress_image_bytes(b"XXXX" + b"\x00" * 20, backend="native")


def test_native_errors_carry_detail(rng):
    """The C ABI threads a failure detail through fel_last_error: the
    exception text must say WHAT failed (e.g. "FLCT tile table
    truncated"), not a bare "native codec error -1" (reference:
    descriptive variants in src/compression/error.rs:4-19)."""
    from felics_tpu import errors
    from felics_tpu.config import TileConfig
    from felics_tpu.native import runtime as rt

    img = random_image(rng, 48, 40, np.uint8)
    data = compress_image_bytes(
        img, container="flct", tile=TileConfig(16, 16)
    )
    with pytest.raises(errors.IoError, match="tile table truncated"):
        rt.decompress_tiled(data[:30])
    with pytest.raises(errors.IoError, match="payload truncated"):
        rt.decompress_tiled(data[:-5])
    with pytest.raises(errors.InvalidSignature, match="bad signature"):
        rt.decompress(b"XXXX" + b"\x00" * 20, None)
    # A corrupt byte inside a tile stream attributes the failing TILE.
    sweep_hits = 0
    for pos in range(len(data) - 40, len(data), 3):
        bad = bytearray(data)
        bad[pos] ^= 0xFF
        try:
            rt.decompress_tiled(bytes(bad))
        except errors.DecompressionError as e:
            assert "native codec error" not in str(e)
            if str(e).startswith("tile "):
                sweep_hits += 1
    assert sweep_hits > 0


def test_native_smooth_image_real_size(rng):
    # Exercise the lazy context-row allocation on a larger 16-bit image.
    base = np.cumsum(rng.integers(-80, 81, size=(200, 300)), axis=1)
    img = np.clip(base + 30000, 0, 65535).astype(np.uint16)
    data = compress_image_bytes(img, backend="native")
    out = decompress_image_bytes(data, backend="native")
    np.testing.assert_array_equal(out, img)
    assert len(data) < img.nbytes
