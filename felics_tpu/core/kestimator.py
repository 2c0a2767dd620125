"""Adaptive Rice-parameter (k) selection.

Reference counterpart: src/compression/parameter_selection.rs:5-86. Per
context C, ``table[C][ki]`` accumulates the total Rice code length the stream
would have cost had parameter ``k_values[ki]`` been used for every
out-of-range residual seen so far in C.

Exact reference semantics preserved here (they shape the bitstream, so they
are interop-critical):

  * ``update`` adds ``(v >> k) + 1 + k`` to every candidate column, then, if
    count scaling is enabled and the **minimum** entry is **strictly greater**
    than the threshold, integer-halves all entries of that context's row.
  * ``get_k`` scans columns in ascending order taking ``<=`` comparisons, so
    ties select the **largest** k; the all-zero initial row therefore yields
    the largest candidate k.

This class is the scalar/numpy oracle; the vectorized batched scan used by
the vectorized encoder lives in felics_tpu.ops.kscan and is tested against it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class KEstimator:
    def __init__(
        self,
        max_context: int,
        k_values: Sequence[int],
        halve_at: Optional[int],
        prior: Optional[np.ndarray] = None,
    ) -> None:
        """``prior``: (rows, len(k_values)) seed added to the first ``rows``
        contexts' tables at init (the FLCT-v2 per-image k-prior; contexts are
        buckets there). None = all-zero init (FLCS / FLCT v0)."""
        if len(k_values) == 0:
            raise ValueError("the list of k values is empty")
        self.max_context = max_context
        self.k_values = np.asarray(k_values, dtype=np.int64)
        self.table = np.zeros((max_context + 1, len(k_values)), dtype=np.int64)
        if prior is not None:
            prior = np.asarray(prior, dtype=np.int64)
            self.table[: prior.shape[0]] = prior
        self.halve_at = halve_at

    def update(self, context: int, encoded: int) -> None:
        assert context <= self.max_context
        row = self.table[context]
        row += (encoded >> self.k_values) + 1 + self.k_values
        if self.halve_at is not None and row.min() > self.halve_at:
            row //= 2

    def get_k(self, context: int) -> int:
        assert context <= self.max_context
        row = self.table[context]
        # Last index achieving the minimum (ascending scan with '<=').
        best = len(row) - 1 - int(np.argmin(row[::-1]))
        return int(self.k_values[best])
