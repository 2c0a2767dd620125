"""FLCT tile decoder as a Pallas kernel for NVIDIA GPUs (Triton route).

Decode is the serial heart of the codec: every pixel's k and code depend on
the pixels decoded before it in the same tile. The XLA engine
(``parallel.tiling._decode_tiles``) runs that walk as a vmapped ``lax.scan``,
one round of device kernels per pixel step. This kernel runs the whole walk
inside one launch instead:

  * lanes = tiles: each lane (one GPU thread) decodes one tile stream, and a
    program decodes a block of ``B`` lanes;
  * each lane's bit cursor and its ``nb x K`` k-table stay in registers;
  * stream words are gathered from the concatenated payload at each lane's
    own cursor (a 96-bit window per step);
  * causal neighbours are read back from the output rows the lane already
    wrote, which are still in L1/L2.

The input contract is the XLA engine's: flat big-endian words, each tile's
starting bit, the (G, C, nb, K) k-table seeds and each tile's seed group.
Outputs are identical. Off the GPU (the CPU test suite) the same kernel runs
in the Pallas interpreter.

Reference behaviour reproduced (structure only): per-pixel loop
src/compression.rs:117-146, k selection
src/compression/parameter_selection.rs:71-85 (log-bucketed for FLCT, see
ops.kscan_tiled), phase-in src/coding/phase_in_coding.rs:59-112, Rice
src/coding/rice_coding.rs:26-58.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from felics_tpu.config import CodingConfig
from felics_tpu.utils import platform

_U32 = jnp.uint32
_WINDOW_PAD = 3  # zero words after the payload: a window reads wi..wi+2
_SMS = 132  # streaming multiprocessors of an H100 SXM


def _shl(v, s):
    """v << s for uint32 v and int32 s; 0 when s >= 32 (LLVM leaves
    over-wide shifts undefined, so clamp and select)."""
    return jnp.where(s < 32, v << jnp.clip(s, 0, 31).astype(_U32), _U32(0))


def _shr(v, s):
    """v >> s (logical) for uint32 v and int32 s; 0 when s >= 32."""
    return jnp.where(s < 32, v >> jnp.clip(s, 0, 31).astype(_U32), _U32(0))


def _clz(v):
    """Leading zeros of a uint32 (clz lowers for int32 only)."""
    return jax.lax.clz(jax.lax.bitcast_convert_type(v, jnp.int32))


def _neighbours(j, tw: int):
    """Causal neighbour rows (a, b) of pixel j >= 2 in a tile of width tw
    (core.context.neighbour_indices, for one traced scalar)."""
    x = jax.lax.rem(j, jnp.int32(tw))  # j >= 0: truncation is floor
    y = jax.lax.div(j, jnp.int32(tw))
    a = jnp.where(x > 0, j - 1, j - tw)
    b = jnp.where(
        (x > 0) & (y > 0),
        j - tw,
        jnp.where(y == 0, j - 2, jnp.where(y >= 2, j - 2 * tw, j - tw + 1)),
    )
    return a, b


def _kernel(
    words_ref, starts_ref, group_ref, prior_ref, out_ref, *,
    B: int, th: int, tw: int, c: int, nb: int, K: int, depth_bits: int,
    max_context: int, n_words: int,
):
    """Decode B tile streams into out_ref[:, lanes] ((C*t, Lp) int32)."""
    t = th * tw
    nbk = nb * K
    lanes = pl.ds(pl.program_id(0) * B, B)
    last = n_words - 1
    bit_limit = n_words * 32

    def word(i):
        # Clamped: a corrupt stream may run its cursor past the payload.
        return words_ref[jnp.clip(i, 0, last)]

    def window(pos):
        """64 bits at each lane's cursor, as (high word, low word)."""
        wi = pos >> 5
        off = pos & 31
        w0, w1, w2 = word(wi), word(wi + 1), word(wi + 2)
        return (_shl(w0, off) | _shr(w1, 32 - off),
                _shl(w1, off) | _shr(w2, 32 - off))

    def window_bits(win, s, n):
        """n <= 31 bits at offset s (s + n <= 64) of a 64-bit window."""
        win0, win1 = win
        lo = _shl(win0, s) | jnp.where(s > 0, _shr(win1, 32 - s), _U32(0))
        x = jnp.where(s < 32, lo, _shl(win1, s - 32))
        return _shr(x, 32 - n).astype(jnp.int32)

    def word32(p):
        """The 32 bits starting at bit p of each lane."""
        return _shl(word(p >> 5), p & 31) | _shr(word((p >> 5) + 1),
                                                 32 - (p & 31))

    def long_unary(p2, done, k):
        """Unary runs that overflow the 64-bit window (rare): count ones
        from bit p2 for lanes not ``done``, then read the k-bit remainder
        after the terminator. Returns (run, remainder, cursor after the
        terminator). Stops at the end of the payload on corrupt streams."""

        def cond(st):
            return jnp.min(st[3]) == 0

        def body(st):
            q2, p2, rem, done = st
            inv = ~word32(p2)
            ld = jnp.where(done != 0, 0, jnp.where(inv == 0, 32, _clz(inv)))
            fin = (done != 0) | (ld < 32) | (p2 >= bit_limit)
            newly = fin & (done == 0)
            p2 = p2 + ld + newly.astype(jnp.int32)
            rem = jnp.where(newly, _shr(word32(p2), 32 - k).astype(jnp.int32),
                            rem)
            return q2 + ld, p2, rem, fin.astype(jnp.int32)

        zero = jnp.zeros((B,), jnp.int32)
        q2, p2, rem, _ = jax.lax.while_loop(
            cond, body, (zero, p2, zero, done)
        )
        return q2, rem, p2

    def plane(ch, pos, gbase):
        base = ch * t
        w = depth_bits + (1 if ch else 0)
        # Raw preamble: the first two pixels, w bits each (Co/Cg planes are
        # w-bit two's complement).
        for j in range(2):
            raw = window(pos)[0] >> _U32(32 - w)
            if ch:
                val = jax.lax.bitcast_convert_type(
                    raw << _U32(32 - w), jnp.int32
                ) >> (32 - w)
            else:
                val = raw.astype(jnp.int32)
            out_ref[base + j, lanes] = val
            pos = pos + w
        # The k statistics restart from this plane's seed.
        goff = gbase + ch * nbk
        table = tuple(prior_ref[goff + r] for r in range(nbk))

        def step(j, carry):
            pos, table = carry
            ra, rb = _neighbours(j, tw)
            va = out_ref[base + ra, lanes]
            vb = out_ref[base + rb, lanes]
            h = jnp.maximum(va, vb)
            l = jnp.minimum(va, vb)
            ctx = jnp.clip(h - l, 0, max_context)
            qc = jnp.minimum(jnp.where(ctx > 0, 32 - _clz(ctx.astype(_U32)), 0),
                             nb - 1)
            # k: smallest cumulative cost in the context's bucket, ties to
            # the largest k.
            row = []
            for kk in range(K):
                v = table[kk]
                for b in range(1, nb):
                    v = jnp.where(qc == b, table[b * K + kk], v)
                row.append(v)
            k = jnp.full((B,), K - 1, jnp.int32)
            best = row[K - 1]
            for kk in range(K - 2, -1, -1):
                take = row[kk] < best
                best = jnp.where(take, row[kk], best)
                k = jnp.where(take, kk, k)

            win = window(pos)
            first = (win[0] >> _U32(31)).astype(jnp.int32)

            # In range: phase-in code over n = ctx + 1, after the marker.
            nn = ctx + 1
            m = 31 - _clz(nn.astype(_U32))
            left_p = nn - (1 << m)
            right_p = (1 << (m + 1)) - nn
            first_m = window_bits(win, jnp.int32(1), m)
            short = first_m < right_p
            extra = window_bits(win, 1 + m, jnp.int32(1))
            number = jnp.where(
                short, first_m, (first_m - right_p) * 2 + right_p + extra
            )
            xsum = number + left_p
            in_value = xsum - jnp.where(xsum >= nn, nn, 0) + l
            in_pos = pos + 1 + jnp.where(short, m, m + 1)

            # Out of range: side bit, unary quotient, k-bit remainder. The
            # run is counted across the whole 64-bit window.
            above = ((win[0] >> _U32(30)) & _U32(1)).astype(jnp.int32)
            ones1 = _clz(~(win[0] << _U32(2)))  # <= 30: low bits are set
            inv2 = ~win[1]
            ones2 = jnp.where(inv2 == 0, 32, _clz(inv2))
            lead = ones1 + jnp.where(ones1 == 30, ones2, 0)
            overrun = (first == 0) & (lead > 61 - k)
            q2, rem_slow, p2 = long_unary(
                pos + 2, (~overrun).astype(jnp.int32), k
            )
            uq = jnp.where(overrun, q2, lead)
            pos_u = jnp.where(overrun, p2, pos + 3 + lead)
            rem_fast = window_bits(win, pos_u - pos, k)
            rem = jnp.where(k > 0, jnp.where(overrun, rem_slow, rem_fast), 0)
            encoded = (uq << k) + rem
            oor_value = jnp.where(above == 1, encoded + h + 1, l - encoded - 1)

            is_in = first == 1
            out_ref[base + j, lanes] = jnp.where(is_in, in_value, oor_value)
            new_pos = jnp.where(is_in, in_pos, pos_u + k)

            oor = ~is_in
            table = list(table)
            for kk in range(K):
                add = (encoded >> kk) + 1 + kk
                for b in range(nb):
                    r = b * K + kk
                    table[r] = table[r] + jnp.where(oor & (qc == b), add, 0)
            return new_pos, tuple(table)

        pos, _ = jax.lax.fori_loop(2, t, step, (pos, table))
        return pos

    pos = starts_ref[lanes]
    gbase = group_ref[lanes] * (c * nbk)
    for ch in range(c):
        pos = plane(ch, pos, gbase)


def lane_block(n_lanes: int) -> int:
    """Lanes per program: 128 (four warps, one lane per thread) when there
    are enough tiles to give every SM a few programs, else fewer, down to
    one warp."""
    b = 128
    while b > 32 and n_lanes < b * 4 * _SMS:
        b //= 2
    return b


@partial(jax.jit, static_argnames=("th", "tw", "c", "cfg", "nb"))
def decode_tiles(
    words, tile_bit_starts, th: int, tw: int, c: int, cfg: CodingConfig,
    nb: int, prior=None, tile_group=None,
):
    """Decode every tile stream; same arguments and result as
    ``parallel.tiling._decode_tiles``.

    words: (N,) uint32 big-endian payload words; tile_bit_starts: (L,)
    int32 first bit of each tile; prior: (G, C, nb, K) int32 k-table seeds
    (None = zeros, the v0 stream); tile_group: (L,) int32 index into G.
    Returns (L, C, th*tw) int32."""
    t = th * tw
    K = cfg.num_k
    if t < 2:
        raise ValueError(
            "FLCT tile planes need >= 2 pixels (the raw preamble is two "
            f"pixels per plane); got {th}x{tw}"
        )
    if tuple(cfg.k_values) != tuple(range(K)):
        raise ValueError("the decode kernel needs k values 0..K-1")
    n_words = words.shape[0] + _WINDOW_PAD
    if n_words * 32 >= (1 << 31):
        raise ValueError(
            f"payload of {words.shape[0]} words exceeds the decoder's int32 "
            "bit cursor; decode it in smaller batches"
        )
    L = tile_bit_starts.shape[0]
    B = lane_block(L)
    Lp = -(-L // B) * B
    starts = jnp.pad(tile_bit_starts.astype(jnp.int32), (0, Lp - L))
    if tile_group is None:
        tile_group = jnp.zeros((L,), jnp.int32)
    group = jnp.pad(tile_group.astype(jnp.int32), (0, Lp - L))
    if prior is None:
        prior = jnp.zeros((1, c, nb, K), jnp.int32)
    words = jnp.concatenate(
        [words.astype(_U32), jnp.zeros((_WINDOW_PAD,), _U32)]
    )
    kernel = partial(
        _kernel, B=B, th=th, tw=tw, c=c, nb=nb, K=K,
        depth_bits=cfg.depth_bits, max_context=cfg.max_context,
        n_words=n_words,
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((c * t, Lp), jnp.int32),
        grid=(Lp // B,),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=B // 32),
        interpret=platform.interpret_kernels(),
        name="flct_decode",
    )(words, starts, group, prior.astype(jnp.int32).reshape(-1))
    return out[:, :L].T.reshape(L, c, t)
