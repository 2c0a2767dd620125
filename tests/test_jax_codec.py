"""Vectorized JAX codec vs the sequential oracle: byte-for-byte equality.

This is the core bit-exactness guarantee: the parallel pipeline
(analyze → kscan → symbolize → bitpack) must reproduce the reference
bitstream exactly, including the adaptive-k evolution with halving and the
bit-continuous multi-channel RGB layout.
"""

import numpy as np
import pytest

from felics_tpu.api import compress_image_bytes, decompress_image_bytes


def random_image(rng, width, height, dtype, channels=None):
    high = np.iinfo(dtype).max + 1
    shape = (height, width) if channels is None else (height, width, channels)
    return rng.integers(0, high, size=shape).astype(dtype)


def smooth_image(rng, width, height, dtype, channels=None):
    shape = (height, width) if channels is None else (height, width, channels)
    steps = rng.integers(-6, 7, size=shape)
    img = np.cumsum(np.cumsum(steps, axis=0), axis=1) + 128
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


DIMS = [(2, 1), (1, 2), (3, 3), (7, 4), (23, 17), (64, 64), (1, 50), (50, 1)]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_gray_matches_oracle(rng, dtype):
    for width, height in DIMS:
        for maker in (random_image, smooth_image):
            img = maker(rng, width, height, dtype)
            jax_bytes = compress_image_bytes(img, backend="jax")
            oracle_bytes = compress_image_bytes(img, backend="oracle")
            assert jax_bytes == oracle_bytes, (dtype, width, height, maker.__name__)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_rgb_matches_oracle(rng, dtype):
    for width, height in [(1, 2), (5, 3), (16, 11), (32, 32)]:
        for maker in (random_image, smooth_image):
            img = maker(rng, width, height, dtype, channels=3)
            jax_bytes = compress_image_bytes(img, backend="jax")
            oracle_bytes = compress_image_bytes(img, backend="oracle")
            assert jax_bytes == oracle_bytes, (dtype, width, height, maker.__name__)


def test_degenerate_dims(rng):
    for shape in [(0, 3), (3, 0), (1, 1), (0, 0)]:
        img = np.zeros(shape, dtype=np.uint8)
        assert compress_image_bytes(img, backend="jax") == compress_image_bytes(
            img, backend="oracle"
        )


def test_constant_image():
    img = np.full((16, 16), 42, dtype=np.uint8)
    assert compress_image_bytes(img, backend="jax") == compress_image_bytes(
        img, backend="oracle"
    )


def test_adversarial_halving(rng):
    # Large residuals in few contexts: exercises count scaling heavily.
    img = (rng.integers(0, 2, size=(40, 40)) * 255).astype(np.uint8)
    assert compress_image_bytes(img, backend="jax") == compress_image_bytes(
        img, backend="oracle"
    )


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_jax_scan_decoder_round_trip(rng, dtype):
    for width, height, channels in [(9, 7, None), (16, 16, None), (8, 6, 3)]:
        img = smooth_image(rng, width, height, dtype, channels)
        data = compress_image_bytes(img, backend="oracle")
        out = decompress_image_bytes(data, backend="jax")
        np.testing.assert_array_equal(out, img)
        assert out.dtype == img.dtype


def test_jax_decoder_decodes_jax_encoder(rng):
    img = random_image(rng, 20, 15, np.uint8, channels=3)
    data = compress_image_bytes(img, backend="jax")
    out = decompress_image_bytes(data, backend="jax")
    np.testing.assert_array_equal(out, img)
