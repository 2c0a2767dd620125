"""Synthetic test images generated from a seed.

Smooth random walks: the double cumulative sum of unit steps, folded back
into the pixel range (a triangle wave, so nothing saturates and the walk
stays continuous). RGB channels share the walk plus a fixed offset and a
little noise, so they are correlated the way photographs are. Used by
bench.py and chip_smoke.py wherever no real corpus is available; inputs are
generated deliberately, never substituted silently for missing files.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def smooth_images(
    seed: int, n: int, shape: Sequence[int], dtype
) -> List[np.ndarray]:
    """``n`` images of ``shape`` ((H, W) or (H, W, 3)) and ``dtype``
    (uint8 or uint16), the same for the same seed."""
    rng = np.random.default_rng(seed)
    hi = int(np.iinfo(dtype).max)
    h, w = shape[0], shape[1]
    out = []
    for _ in range(n):
        steps = rng.integers(-1, 2, (h, w), dtype=np.int8)
        walk = np.cumsum(np.cumsum(steps, 0, dtype=np.int32), 1, dtype=np.int32)
        walk += hi // 2
        if len(shape) == 3:
            offsets = np.array([0, hi // 7, hi // 3], np.int32)
            noise = rng.integers(-2, 3, (h, w, 3), dtype=np.int8)
            walk = walk[..., None] + offsets + noise
        folded = np.abs(np.mod(walk, 2 * hi) - hi)
        out.append(folded.astype(dtype))
    return out
