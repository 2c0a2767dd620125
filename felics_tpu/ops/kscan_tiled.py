"""Adaptive-k computation for the tiled (FLCT) mode — scan-free.

FLCT makes two deliberate coding changes relative to FLCS, both chosen so
the estimator maps onto dense data-parallel device work:

  1. contexts are log-bucketed for the *k estimator only*
     (``qctx = min(bit_length(Δ), QCTX_CAP)``; phase-in coding still uses
     exact Δ) — 6 buckets at the shipped cap (config.QCTX_CAP = 5) for
     either depth, so per-tile tables are tiny;
  2. NO periodic count scaling: each (tile, channel) domain restarts its
     statistics, so forgetting buys nothing — and without halving the
     cumulative code-length table for every pixel is an EXCLUSIVE PREFIX SUM
     of the per-update Rice-length rows.

Consequence: the k for every pixel is computable with ``nb`` masked cumsums
along the pixel axis and an argmin — dense VPU work, no ``lax.scan``, no
sort, no host sync. Ties select the largest k and the all-zero initial state
yields the largest k, matching the FLCS estimator's selection rule
(reference: src/compression/parameter_selection.rs:71-85).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from felics_tpu.config import CodingConfig


def qctx_of(context):
    """Log-bucket a context: min(bit_length(Δ), QCTX_CAP)
    (0 → 0, 1 → 1, 2-3 → 2, ..., ≥2^(CAP-1) → CAP; see config.QCTX_CAP)."""
    from felics_tpu.config import QCTX_CAP

    bl = jnp.where(context > 0, 32 - jax.lax.clz(context.astype(jnp.int32)), 0)
    return jnp.minimum(bl, QCTX_CAP)


def num_buckets(cfg: CodingConfig) -> int:
    from felics_tpu.config import QCTX_CAP

    return min(int(cfg.max_context).bit_length(), QCTX_CAP) + 1


@partial(jax.jit, static_argnames=("cfg", "nb"))
def kscan_tiled(qctx, oor, residual, cfg: CodingConfig, nb: int, prior=None):
    """k per pixel for (D, T) domains. Pure dense ops.

    For each bucket b: the estimator table just before pixel i is the
    exclusive cumsum of Rice-length rows over prior out-of-range pixels of
    bucket b in the same domain, plus the per-domain seed ``prior`` (the
    FLCT-v2 per-image k-prior, shape (D, nb, K); None or zeros = the v0
    cold-start behavior); k = last-argmin over the K columns.
    """
    k_values = jnp.asarray(cfg.k_values, dtype=jnp.int32)
    num_k = cfg.num_k

    # (D, T, K) per-update Rice code lengths (0 where not out-of-range).
    rows = (residual[..., None] >> k_values) + 1 + k_values
    rows = jnp.where(oor[..., None], rows, 0)

    k = jnp.full(qctx.shape, k_values[num_k - 1], jnp.int32)
    for b in range(nb):
        mask = (qctx == b) & oor
        contrib = jnp.where(mask[..., None], rows, 0)
        table = jnp.cumsum(contrib, axis=1) - contrib  # exclusive prefix sum
        if prior is not None:
            table = table + prior[:, b, :][:, None, :]
        best = (num_k - 1) - jnp.argmin(table[..., ::-1], axis=-1)
        k = jnp.where(mask, k_values[best], k)
    return k
