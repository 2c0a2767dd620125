"""Sequential bit-exact oracle codec (pure Python/numpy).

Behavioral twin of the reference's channel codec (src/compression.rs:76-248)
and trait impls (src/compression.rs:250-410). Deliberately simple and slow —
it exists to (a) pin the exact bitstream semantics and (b) oracle-test the
vectorized JAX codec and the native C++ core against something independently
derived from the spec.

Stream layout per channel (bit-continuous; RGB channels are concatenated with
a single byte-align at the very end, so later channels start at arbitrary bit
offsets — src/compression.rs:365-369):

  * zero-area image: two raw signed 32-bit zeros
  * 1x1 image: the pixel then a raw signed 32-bit zero
  * otherwise: the first two raster pixels raw as signed 32-bit, then per
    pixel i in 2..W*H: a 1-2 bit range marker (IN=1, ABOVE=01, BELOW=00;
    src/compression.rs:29-45), then either the phase-in code of ``p - L``
    over ``n = context+1`` (in-range) or the Rice code of ``L-p-1`` /
    ``p-H-1`` (below/above) at the adaptive k for that context, updating the
    k-estimator with the encoded value.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from felics_tpu import errors
from felics_tpu.coding.bitio import BitReader, BitWriter
from felics_tpu.coding.phase_in import PhaseInCoder
from felics_tpu.coding.rice import RiceCoder
from felics_tpu.config import QCTX_CAP, CodingConfig
from felics_tpu.core.context import nearest_neighbours
from felics_tpu.core.kestimator import KEstimator

# Range-marker bit patterns (reference: src/compression.rs:29-61).
_IN_RANGE = (1, 1)  # value, nbits
_ABOVE_RANGE = (0b01, 2)
_BELOW_RANGE = (0b00, 2)


def compress_channel(
    channel: np.ndarray,
    width: int,
    height: int,
    config: CodingConfig,
    bitwriter: BitWriter,
    bucketed_k: bool = False,
    pre_bits: int = 32,
    prior=None,
) -> None:
    """``bucketed_k``: index the k-estimator by bit_length(context) instead of
    the exact context — the FLCT tiled format's rule (see
    felics_tpu.ops.kscan_tiled); FLCS uses the exact context. ``pre_bits``:
    raw preamble width (32 for FLCS; depth(+1 for signed Co/Cg planes) for
    FLCT, two's-complement truncated). ``prior``: (nb, K) k-table seed for
    the FLCT-v2 per-image k-prior (bucketed_k mode only); None = zeros."""
    channel = np.asarray(channel, dtype=np.int64)
    total = width * height
    if total > channel.size:
        raise ValueError("channel is not big enough")

    mask = (1 << pre_bits) - 1

    if width == 0 or height == 0:
        bitwriter.write(pre_bits, 0)
        bitwriter.write(pre_bits, 0)
        return
    if width == 1 and height == 1:
        bitwriter.write(pre_bits, int(channel[0]) & mask)
        bitwriter.write(pre_bits, 0)
        return
    bitwriter.write(pre_bits, int(channel[0]) & mask)
    bitwriter.write(pre_bits, int(channel[1]) & mask)

    estimator = KEstimator(
        config.max_context, config.k_values, config.count_scaling, prior
    )
    coders = {k: RiceCoder(k) for k in config.k_values}

    for i in range(2, total):
        a, b = nearest_neighbours(i, width)
        p = int(channel[i])
        v1, v2 = int(channel[a]), int(channel[b])
        h, l = max(v1, v2), min(v1, v2)
        context = h - l
        kctx = min(context.bit_length(), QCTX_CAP) if bucketed_k else context
        k = estimator.get_k(kctx)

        if l <= p <= h:
            bitwriter.write(_IN_RANGE[1], _IN_RANGE[0])
            PhaseInCoder(context + 1).encode(bitwriter, p - l)
        elif p < l:
            bitwriter.write(_BELOW_RANGE[1], _BELOW_RANGE[0])
            coders[k].encode(bitwriter, l - p - 1)
            estimator.update(kctx, l - p - 1)
        else:
            bitwriter.write(_ABOVE_RANGE[1], _ABOVE_RANGE[0])
            coders[k].encode(bitwriter, p - h - 1)
            estimator.update(kctx, p - h - 1)


def decompress_channel(
    width: int,
    height: int,
    config: CodingConfig,
    bitreader: BitReader,
    bucketed_k: bool = False,
    pre_bits: int = 32,
    pre_signed: bool = False,
    prior=None,
) -> np.ndarray:
    def read_pre() -> int:
        raw = bitreader.read(pre_bits)
        if pre_bits == 32 or pre_signed:
            sign = 1 << (pre_bits - 1)
            return (raw ^ sign) - sign
        return raw

    pixel1 = read_pre()
    pixel2 = read_pre()

    if width == 0 or height == 0:
        return np.zeros(0, dtype=np.int64)
    if width == 1 and height == 1:
        return np.array([pixel1], dtype=np.int64)

    total = width * height
    if total > 2**31:
        raise errors.InvalidDimensions("image too large")
    buf = np.zeros(total, dtype=np.int64)
    buf[0], buf[1] = pixel1, pixel2

    estimator = KEstimator(
        config.max_context, config.k_values, config.count_scaling, prior
    )
    coders = {k: RiceCoder(k) for k in config.k_values}
    i32_min, i32_max = -(2**31), 2**31 - 1

    for i in range(2, total):
        a, b = nearest_neighbours(i, width)
        v1, v2 = int(buf[a]), int(buf[b])
        h, l = max(v1, v2), min(v1, v2)
        context = h - l
        if context > config.max_context:
            # Only reachable on corrupt streams: valid pixel values keep
            # H - L within MAX_CONTEXT (the reference panics here instead).
            raise errors.InvalidValue("context exceeds MAX_CONTEXT")
        kctx = min(context.bit_length(), QCTX_CAP) if bucketed_k else context
        k = estimator.get_k(kctx)

        first = bitreader.read_bit()
        if first:  # in range
            p = PhaseInCoder(context + 1).decode(bitreader)
            value = p + l
        else:
            above = bitreader.read_bit()
            encoded = coders[k].decode(bitreader)
            estimator.update(kctx, encoded)
            if encoded > i32_max:
                raise errors.InvalidValue("decoded residual does not fit i32")
            if above:
                value = encoded + h + 1
            else:
                value = l - encoded - 1
        if not i32_min <= value <= i32_max:
            raise errors.ValueOverflow("decoded pixel overflows i32")
        buf[i] = value
    return buf
