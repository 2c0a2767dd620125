"""Parallel bitstream packing.

Replaces the reference's serial big-endian bit writer
(bitstream-io BitWriter, used at src/compression.rs:270,358) with a
data-parallel GATHER-based construction over 32-bit words:

  1. exclusive prefix-sum over per-symbol bit lengths → every symbol's start
     offset (and the exact total bit count). The offsets PARTITION the bit
     stream, so the symbol covering any bit position is found by binary
     search (vectorized searchsorted);
  2. every output word reconstructs itself by OR-ing windows of the ≤ R
     symbols that overlap it: for round j, word w gathers symbol
     ``first[w] + j`` and computes its 32-bit window arithmetically from the
     symbol's fixed layout (a-part bits, implicit run of ones, b-part bits).
     Rounds R = max symbols overlapping one word (host-synced, bucketized;
     flat image regions emit 1-bit codewords, so R can reach 33). Rounds
     past a word's last contributor gather a clipped index whose window is
     zero — or the final symbol again, which OR-idempotence makes harmless;
  3. bytes = big-endian split of the words, trimmed to the byte-aligned
     total (byte_align zero padding falls out of the zero-initialized plane).

All gathers + dense ALU — no scatter anywhere (scatters serialize on
duplicate indices), so packing runs at memory bandwidth regardless of
codeword lengths.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from felics_tpu.ops.analysis import Symbols

_ONES = jnp.uint32(0xFFFFFFFF)


@jax.jit
def symbol_offsets(symbols: Symbols):
    """Exclusive prefix sum of symbol lengths; returns (offsets, total_bits)."""
    lens = symbols.total_len
    ends = jnp.cumsum(lens, dtype=jnp.int32)
    offsets = ends - lens
    total = ends[-1] if lens.shape[0] else jnp.int32(0)
    return offsets, total


@jax.jit
def max_overlap(offsets: jnp.ndarray) -> jnp.ndarray:
    """Upper bound on symbols overlapping any 32-bit output word.

    A word's contributors are (symbols starting inside it) + at most one
    spilling in from before, so max over symbols of "starts sharing my word"
    + 1 bounds the needed pack rounds. Evaluated on the symbol grid (static
    shape) rather than the word grid, so it stays correct when long symbols
    make the stream wider than the symbol count.
    """
    w_begin = (offsets >> 5) << 5
    lo = jnp.searchsorted(offsets, w_begin, side="left")
    hi = jnp.searchsorted(offsets, w_begin + 32, side="left")
    return jnp.max(hi - lo) + 1


def _shl(value, amount):
    """uint32 << amount, 0 when amount >= 32 (XLA shift is UB past width)."""
    amount = amount.astype(jnp.uint32)
    return jnp.where(amount < 32, value << jnp.minimum(amount, 31), jnp.uint32(0))


def _shr(value, amount):
    """uint32 >> amount (logical), 0 when amount >= 32."""
    amount = amount.astype(jnp.uint32)
    return jnp.where(amount < 32, value >> jnp.minimum(amount, 31), jnp.uint32(0))


def _shift_window(aligned, t):
    """32-bit window at signed offset ``t`` of an MSB-aligned 32-bit part:
    positive t looks deeper into the part, negative t pads leading zeros."""
    return jnp.where(t >= 0, _shl(aligned, t), _shr(aligned, -t))


def _range_mask(lo, hi):
    """uint32 mask with bits [lo, hi) set (bit 0 = MSB), clipped to [0, 32)."""
    lo = jnp.clip(lo, 0, 32)
    hi = jnp.clip(hi, 0, 32)
    return _shr(_ONES, lo) & ~_shr(_ONES, hi)


@partial(jax.jit, static_argnames=("b_pad", "rounds"))
def pack_bits(
    symbols: Symbols, offsets: jnp.ndarray, b_pad: int, rounds: int = 33
) -> jnp.ndarray:
    """Materialize the byte stream.

    ``b_pad``: static bit capacity (multiple of 32) >= total bits.
    ``rounds``: static bound >= max symbols overlapping one word (33 is
    always safe for >=1-bit symbols plus one spill-in; pass the host-synced
    ``max_overlap`` bucket to skip dead rounds).
    Returns uint8[b_pad // 8].
    """
    assert b_pad % 32 == 0
    num_words = b_pad // 32
    n = offsets.shape[0]

    a_aligned = jnp.where(
        symbols.a_len > 0, _shl(symbols.a_val.astype(jnp.uint32), 32 - symbols.a_len),
        jnp.uint32(0),
    )
    b_aligned = jnp.where(
        symbols.b_len > 0, _shl(symbols.b_val.astype(jnp.uint32), 32 - symbols.b_len),
        jnp.uint32(0),
    )

    w0 = (jnp.arange(num_words, dtype=jnp.int32) << 5)
    first = (jnp.searchsorted(offsets, w0, side="right") - 1).astype(jnp.int32)
    first = jnp.maximum(first, 0)

    def round_contrib(j, acc):
        idx = jnp.minimum(first + j, n - 1)
        o = offsets[idx]
        t = w0 - o  # window offset into the symbol (negative: starts mid-word)
        al = symbols.a_len[idx]
        q = symbols.q[idx]
        bl = symbols.b_len[idx]
        wa = _shift_window(a_aligned[idx], t)
        ones = _range_mask(al - t, al + q - t)
        wb = _shift_window(b_aligned[idx], t - (al + q))
        return acc | wa | ones | wb

    acc = jnp.zeros((num_words,), jnp.uint32)
    for j in range(rounds):
        acc = round_contrib(j, acc)

    shifted = jnp.stack(
        [acc >> 24, acc >> 16, acc >> 8, acc], axis=1
    ).astype(jnp.uint8)
    return shifted.reshape(-1)


@jax.jit
def count_big_symbols(symbols: Symbols) -> jnp.ndarray:
    """Number of symbols whose codeword exceeds 32 bits (preambles + long
    unary runs). Host-synced alongside the total so pack_bits_scatter can
    compact the slow path to a tiny array."""
    total_len = symbols.a_len + symbols.q + symbols.b_len
    return jnp.sum((total_len > 32).astype(jnp.int32))


@partial(jax.jit, static_argnames=("b_pad", "n_big_pad", "as_words"))
def pack_bits_scatter(
    symbols: Symbols,
    offsets: jnp.ndarray,
    b_pad: int,
    n_big_pad: int = 0,
    as_words: bool = False,
) -> jnp.ndarray:
    """Scatter-add variant of the packer (same output as pack_bits).

    Fast path: symbols whose whole codeword fits 32 bits (the vast majority —
    marker + phase-in or marker + short Rice) compose a|ones|b into ONE
    32-bit part arithmetically and scatter-add just the ≤ 2 straddled words
    — the only two full-size scatters in the pipeline.

    Slow path (raw preambles, long unary runs — ~2 per tile-channel plus
    rare outliers): the oversized symbols are COMPACTED to an
    ``n_big_pad``-sized array first (static, host-synced via
    count_big_symbols; pass 0 to keep the uncompacted N-wide slow path),
    then per-part scatters plus a word-interval diff + cumsum for run
    interiors run on that tiny array. A scatter costs per op element
    regardless of masked-off writes, so the compaction pays for itself.
    Bit-disjoint contributions make integer add == bitwise or throughout.
    """
    assert b_pad % 32 == 0
    num_words = b_pad // 32
    acc = jnp.zeros((num_words,), jnp.uint32)

    n = offsets.shape[0]
    total_len = symbols.a_len + symbols.q + symbols.b_len
    small = total_len <= 32

    def add_part(acc, value, length, start, active):
        value = value.astype(jnp.uint32)
        aligned = jnp.where(
            active & (length > 0), _shl(value, 32 - length), jnp.uint32(0)
        )
        w0 = jnp.where(active, start >> 5, num_words)
        bit_off = start & 31
        c0 = _shr(aligned, bit_off)
        c1 = jnp.where(bit_off > 0, _shl(aligned, 32 - bit_off), jnp.uint32(0))
        acc = acc.at[w0].add(c0, mode="drop")
        acc = acc.at[w0 + 1].add(c1, mode="drop")
        return acc

    # Fast path: whole symbol as one part.
    ones_q = _shl(jnp.uint32(1), symbols.q) - 1  # q < 32 when small
    merged = (
        _shl(
            _shl(symbols.a_val.astype(jnp.uint32), symbols.q) | ones_q,
            symbols.b_len,
        )
        | symbols.b_val.astype(jnp.uint32)
    )
    acc = add_part(acc, merged, total_len, offsets, small)

    # Slow path on (compacted) oversized symbols.
    if n_big_pad > 0:
        idx = jnp.arange(n, dtype=jnp.int32)
        order = jnp.argsort(jnp.where(small, jnp.int32(0x7FFFFFFF), idx))
        sel = order[:n_big_pad]
        s_a_val = symbols.a_val[sel]
        s_a_len = symbols.a_len[sel]
        s_q = symbols.q[sel]
        s_b_val = symbols.b_val[sel]
        s_b_len = symbols.b_len[sel]
        s_off = offsets[sel]
        s_big = ~small[sel]
    else:
        s_a_val, s_a_len, s_q = symbols.a_val, symbols.a_len, symbols.q
        s_b_val, s_b_len, s_off = symbols.b_val, symbols.b_len, offsets
        s_big = ~small

    acc = add_part(acc, s_a_val, s_a_len, s_off, s_big)
    b_start = s_off + s_a_len + s_q
    acc = add_part(acc, s_b_val, s_b_len, b_start, s_big)

    rs = s_off + s_a_len
    re = rs + s_q
    has = (s_q > 0) & s_big
    head_w = rs >> 5
    head_start = rs & 31
    head_cap = jnp.minimum(re - (head_w << 5), 32)
    head_mask = _shr(_ONES, head_start) & ~_shr(_ONES, head_cap)
    acc = acc.at[jnp.where(has, head_w, num_words)].add(
        jnp.where(has, head_mask, jnp.uint32(0)), mode="drop"
    )
    tail_w = re >> 5
    tail_end = re & 31
    tail_valid = has & (tail_w > head_w) & (tail_end > 0)
    tail_mask = ~_shr(_ONES, tail_end)
    acc = acc.at[jnp.where(tail_valid, tail_w, num_words)].add(
        jnp.where(tail_valid, tail_mask, jnp.uint32(0)), mode="drop"
    )
    full_lo = (rs + 31) >> 5
    full_hi = tail_w
    span = has & (full_hi > full_lo)
    diff = jnp.zeros((num_words + 1,), jnp.int32)
    diff = diff.at[jnp.where(span, full_lo, num_words)].add(
        jnp.where(span, 1, 0), mode="drop"
    )
    diff = diff.at[jnp.where(span, full_hi, num_words)].add(
        jnp.where(span, -1, 0), mode="drop"
    )
    full = jnp.cumsum(diff[:-1], dtype=jnp.int32) > 0
    words = acc | jnp.where(full, _ONES, jnp.uint32(0))

    if as_words:
        # Logical big-endian uint32 words (word >> 24 = first stream byte)
        # — the per-tile row contract of the Pallas engine / the sharded
        # row-packed XLA engine (tiling._columns_to_payload consumes it).
        return words
    shifted = jnp.stack(
        [words >> 24, words >> 16, words >> 8, words], axis=1
    ).astype(jnp.uint8)
    return shifted.reshape(-1)


def bucket_rounds(max_over: int) -> int:
    """Bucket the overlap bound to limit recompilation."""
    for b in (4, 8, 12, 16, 24, 33):
        if max_over <= b:
            return b
    return 33


def bucket_bits(total_bits: int, minimum: int = 1 << 12) -> int:
    """Round total bits up to a word-aligned bucket (1/8-power-of-two
    granularity: ≤8 jit variants per octave, <12.5% padding waste)."""
    if total_bits <= minimum:
        return minimum
    gran = max(minimum // 8, 1 << max(8, total_bits.bit_length() - 3))
    return -(-total_bits // gran) * gran
