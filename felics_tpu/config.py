"""Runtime coding configuration.

The reference funnels per-depth compile-time constants (reference:
src/compression/traits.rs:7-43) through a ``CodingOptions`` struct
(src/compression.rs:63-68). Here the same knobs are a runtime dataclass, plus
the knobs of the parallel formats that the reference has no counterpart for
(tile geometry, mesh axis names).

Shipped constants (must match the reference bit-exactly for FLCS interop):
  8-bit:  K_VALUES = 0..=5,  MAX_CONTEXT = 510,    COUNT_SCALING = 1024
  16-bit: K_VALUES = 0..=14, MAX_CONTEXT = 131070, COUNT_SCALING = 1024
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from felics_tpu.format import PixelDepth


@dataclass(frozen=True)
class CodingConfig:
    """Everything the channel codec needs to know, independent of image size."""

    pixel_depth: PixelDepth
    k_values: Tuple[int, ...]
    max_context: int
    # Halve all cumulative code lengths in a context when the smallest exceeds
    # this (strictly '>', reference: src/compression/parameter_selection.rs:58-63).
    count_scaling: Optional[int] = 1024

    @property
    def num_k(self) -> int:
        return len(self.k_values)

    @property
    def depth_bits(self) -> int:
        return self.pixel_depth.bits

    @property
    def max_phase_in_bits(self) -> int:
        # phase-in over n = context+1 <= max_context+1; code length <= m+1,
        # m = floor(log2(n)).
        n = self.max_context + 1
        return n.bit_length() - 1 + 1

    @property
    def max_tail_bits(self) -> int:
        # out-of-range tail: terminating 0 + k remainder bits
        return max(self.k_values) + 1

    def validate(self) -> None:
        if not self.k_values:
            raise ValueError("k_values must not be empty")
        if list(self.k_values) != sorted(self.k_values):
            raise ValueError("k_values must be ascending")
        if any(k < 0 or k > 31 for k in self.k_values):
            raise ValueError("k values must be in [0, 31]")


# FLCT context-bucket cap: the tiled k-estimator is indexed by
# min(bit_length(Δ), QCTX_CAP), merging all high-Δ contexts into one bucket.
# Measured on the corpus (scripts + docs/FORMATS.md): merging is FREE on
# ratio (-0.007% gray8, +0.03% gray16, 0% rgb8 at tile 32) because rare
# high-Δ contexts all want the largest k anyway — while cutting the
# per-(tile, channel) k-table to 6 rows x K, which the decoder selects from
# and updates on every pixel (40% fewer table entries for 8-bit, 67% for
# 16-bit). Format-level constant: every engine (XLA, Pallas, native C++,
# oracle) must use the same value.
QCTX_CAP = 5

CONFIG_8BIT = CodingConfig(
    pixel_depth=PixelDepth.EIGHT,
    k_values=tuple(range(6)),
    max_context=510,
    count_scaling=1024,
)

CONFIG_16BIT = CodingConfig(
    pixel_depth=PixelDepth.SIXTEEN,
    k_values=tuple(range(15)),
    max_context=131070,
    count_scaling=1024,
)


def config_for_depth(depth: PixelDepth) -> CodingConfig:
    return CONFIG_8BIT if depth == PixelDepth.EIGHT else CONFIG_16BIT


def tiled_config_for_depth(depth: PixelDepth) -> CodingConfig:
    """FLCT coding parameters.

    Same K range as FLCS, but NO periodic count scaling: tiles restart the
    estimator every (tile, channel) domain, so exponential forgetting buys
    nothing — and without halving the cumulative tables are pure prefix
    sums, which turns the encoder's adaptive-k pass into dense cumsums with
    no sequential scan at all (felics_tpu.ops.kscan_tiled)."""
    return replace(config_for_depth(depth), count_scaling=None)


@dataclass(frozen=True)
class TileConfig:
    """Geometry + estimator knobs for the tiled (FLCT) mode.

    Tiles are independently coded bitstreams: each restarts the
    first-two-pixels raw preamble and the k statistics, so they encode and
    decode in parallel with zero cross-tile state. ``tile_h``/``tile_w`` trade
    compression ratio (smaller tiles → more restart overhead, less adapted k)
    against parallelism; 64x64 keeps the ratio within ~0.5% of single-stream
    on the reference corpus (measured, 12x512x512 grayscale batch) and gives
    a 512x512 image 64-way parallelism.
    """

    tile_h: int = 64
    tile_w: int = 64

    def grid(self, height: int, width: int) -> Tuple[int, int]:
        th = -(-height // self.tile_h) if height else 0
        tw = -(-width // self.tile_w) if width else 0
        return th, tw


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh knobs for multi-chip runs (no reference counterpart)."""

    axis_name: str = "tiles"

    def make_mesh(self, devices=None):
        import jax
        import numpy as np
        from jax.sharding import Mesh

        if devices is None:
            devices = jax.devices()
        return Mesh(np.asarray(devices), (self.axis_name,))
