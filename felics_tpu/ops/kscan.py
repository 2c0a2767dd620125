"""Bit-exact adaptive-k computation as a rank-synchronous batched scan.

The only sequential dependence in FELICS encoding is the k-estimator state
(reference: src/compression/parameter_selection.rs): the k used for the i-th
out-of-range pixel depends on every *prior* out-of-range residual in the same
context. Contexts evolve independently, so instead of the reference's serial
raster walk we:

  1. stable-sort the out-of-range pixels by context (stable ⇒ raster order is
     preserved within each context), assign each a rank = position within its
     context, and remap the (sparse, up to 131071-valued) contexts to compact
     ids;
  2. build a queue matrix U[compact_context, rank] of residuals;
  3. run ONE ``lax.scan`` over ranks where each step advances EVERY context's
     table by one update in parallel — get_k (argmin with ties-to-largest),
     add the Rice length row, conditionally halve — emitting the k chosen at
     that rank for all contexts at once;
  4. gather k back per pixel.

Wall-clock is O(max updates in any single context) wide steps instead of
O(total out-of-range pixels) scalar steps, and every step is a dense
(C_active × |K|) vector op. Bitstreams are bit-identical to the reference's.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from felics_tpu.config import CodingConfig


class _SortedUpdates(NamedTuple):
    order: jnp.ndarray  # int32[N] stable sort order of (oor ? context : BIG)
    compact: jnp.ndarray  # int32[N] compact context id per sorted slot
    rank: jnp.ndarray  # int32[N] rank within context per sorted slot
    num_oor: jnp.ndarray  # int32 scalar
    num_contexts: jnp.ndarray  # int32 scalar, distinct contexts among oor
    max_rank: jnp.ndarray  # int32 scalar, max updates in a single context


@jax.jit
def sort_updates(context, oor) -> _SortedUpdates:
    n = context.shape[0]
    big = jnp.int32(0x7FFFFFFF)
    key = jnp.where(oor, context, big)
    order = jnp.argsort(key, stable=True).astype(jnp.int32)
    sorted_key = key[order]
    valid = sorted_key != big

    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), sorted_key[:-1]])
    is_start = (sorted_key != prev) & valid
    # compact id: running count of segment starts - 1
    compact = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    # rank within segment: index - index_of_segment_start
    idx = jnp.arange(n, dtype=jnp.int32)
    start_idx = jnp.where(is_start, idx, 0)
    seg_start = jax.lax.associative_scan(jnp.maximum, start_idx)
    rank = idx - seg_start

    num_oor = jnp.sum(valid.astype(jnp.int32))
    num_contexts = jnp.sum(is_start.astype(jnp.int32))
    max_rank = jnp.max(jnp.where(valid, rank, -1)) + 1
    return _SortedUpdates(order, compact.astype(jnp.int32), rank, num_oor,
                          num_contexts, max_rank)


@partial(jax.jit, static_argnames=("cfg", "c_pad", "r_pad"))
def kscan(
    context: jnp.ndarray,
    oor: jnp.ndarray,
    residual: jnp.ndarray,
    sorted_updates: _SortedUpdates,
    cfg: CodingConfig,
    c_pad: int,
    r_pad: int,
) -> jnp.ndarray:
    """Return int32[N] k per pixel (meaningful only at out-of-range pixels).

    ``c_pad`` / ``r_pad`` are static paddings >= the true number of active
    contexts and max per-context update count (host-synced, bucketized to
    bound recompilation).
    """
    n = context.shape[0]
    su = sorted_updates
    k_values = jnp.asarray(cfg.k_values, dtype=jnp.int32)
    num_k = cfg.num_k

    idx = jnp.arange(n, dtype=jnp.int32)
    valid_slot = idx < su.num_oor
    values_sorted = residual[su.order]

    # Queue matrix U[compact, rank] of residuals + validity.
    flat_pos = jnp.where(valid_slot, su.compact * r_pad + su.rank, c_pad * r_pad)
    u = jnp.zeros((c_pad * r_pad + 1,), jnp.int32).at[flat_pos].set(
        jnp.where(valid_slot, values_sorted, 0), mode="drop"
    )[:-1].reshape(c_pad, r_pad)
    u_valid = jnp.zeros((c_pad * r_pad + 1,), jnp.bool_).at[flat_pos].set(
        valid_slot, mode="drop"
    )[:-1].reshape(c_pad, r_pad)

    halve_at = cfg.count_scaling

    def step(table, inputs):
        vals, vmask = inputs  # (c_pad,), (c_pad,)
        # get_k BEFORE the update: last index achieving the row minimum.
        best = (num_k - 1) - jnp.argmin(table[:, ::-1], axis=1)
        k_out = k_values[best].astype(jnp.int8)
        # update: add the Rice code-length row for vals.
        row = (vals[:, None] >> k_values[None, :]) + 1 + k_values[None, :]
        new_table = table + jnp.where(vmask[:, None], row, 0)
        if halve_at is not None:
            halve = jnp.min(new_table, axis=1, keepdims=True) > halve_at
            new_table = jnp.where(halve & vmask[:, None], new_table >> 1, new_table)
        return new_table, k_out

    init = jnp.zeros((c_pad, num_k), jnp.int32)
    # unroll amortizes the per-step loop overhead across several rank
    # updates per loop iteration.
    _, k_by_rank = jax.lax.scan(
        step, init, (u.T, u_valid.T), unroll=8
    )  # (r_pad, c_pad)

    # Gather k for each sorted out-of-range slot, scatter back to pixel order.
    rank_c = jnp.clip(su.rank, 0, r_pad - 1)
    k_sorted = k_by_rank[rank_c, jnp.clip(su.compact, 0, c_pad - 1)]
    k_pixels = jnp.zeros((n,), jnp.int32).at[su.order].set(
        jnp.where(valid_slot, k_sorted, 0).astype(jnp.int32)
    )
    default_k = k_values[num_k - 1]
    return jnp.where(oor, k_pixels, default_k).astype(jnp.int32)


def _bucket(value: int, minimum: int = 16) -> int:
    """Round up to 1/8-power-of-two granularity: bounds recompilation to at
    most 8 buckets per octave while wasting < 12.5% of scan steps."""
    if value <= minimum:
        return minimum
    gran = max(minimum, 1 << max(0, value.bit_length() - 3))
    return -(-value // gran) * gran


def compute_k(context, oor, residual, cfg: CodingConfig) -> jnp.ndarray:
    """Host-driver: sort, sync the dynamic extents, run the batched scan."""
    su = sort_updates(context, oor)
    num_contexts = int(su.num_contexts)
    max_rank = int(su.max_rank)
    if num_contexts == 0 or max_rank == 0:
        return jnp.full(context.shape, cfg.k_values[-1], jnp.int32)
    c_pad = _bucket(num_contexts)
    r_pad = _bucket(max_rank)
    return kscan(context, oor, residual, su, cfg, c_pad, r_pad)
