"""Seeded synthetic images (felics_tpu.io.synth): deterministic per seed,
the requested shape and dtype, the full range used without saturating,
and RGB channels correlated the way photographs are."""

import numpy as np
import pytest

from felics_tpu.io.synth import smooth_images


@pytest.mark.parametrize(
    "shape,dtype",
    [((64, 96), np.uint8), ((40, 56, 3), np.uint8), ((300, 200), np.uint16)],
)
def test_smooth_images_deterministic_and_in_range(shape, dtype):
    a = smooth_images(7, 2, shape, dtype)
    b = smooth_images(7, 2, shape, dtype)
    assert len(a) == 2
    for x, y in zip(a, b):
        assert x.shape == tuple(shape) and x.dtype == dtype
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(a[0], smooth_images(8, 1, shape, dtype)[0])


def test_smooth_images_are_smooth_and_rgb_correlated():
    gray = smooth_images(3, 1, (256, 256), np.uint8)[0].astype(np.int32)
    assert gray.min() >= 0 and gray.max() <= 255
    # a walk: neighbouring pixels differ far less than random pixels do
    assert np.abs(np.diff(gray, axis=1)).mean() < 16
    rgb = smooth_images(3, 1, (128, 128, 3), np.uint8)[0].astype(np.float64)
    r = np.corrcoef(rgb[..., 0].ravel(), rgb[..., 1].ravel())[0, 1]
    assert abs(r) > 0.5
