"""FLCT — the tiled-parallel container format.

Layout (all integers big-endian):

    0:4    magic "FLCT"
    4      color type      (0 = gray, 1 = rgb; same enum as FLCS)
    5      pixel depth     (0 = 8-bit, 1 = 16-bit)
    6:10   width  u32      (true image dims, pre-padding)
    10:14  height u32
    14:16  tile_w u16
    16:18  tile_h u16
    18:20  flags  u16      (bit 0: u16 length table; bit 1: k-prior block)
    20:24  n_tiles u32
    24:..  [flags bit 1] k-prior block: one 4-bit k0 per (channel, bucket),
           channel-major, high nibble first, zero-padded to a whole byte
           (ceil(C*nb/2) bytes;
           nb = min(bit_length(MAX_CONTEXT), QCTX_CAP) + 1 = 6)
    ..     per-tile payload byte length × n_tiles
           (u16 when flags bit 0 is set — the encoder sets it whenever every
           tile's payload fits — else u32)
    ..     payload: concatenated per-tile streams, each byte-aligned

The image is edge-replicated up to a multiple of the tile size; tiles are
row-major over the padded canvas. Each tile's stream is FELICS coding of its
channel planes (Y/Co/Cg for RGB) coded back-to-back exactly like a miniature
FLCS payload — per-tile raw first-two-pixels preamble, fresh k statistics —
with THREE deviations: (1) the k-estimator is indexed by the log-bucketed
context ``qctx = min(bit_length(Δ), QCTX_CAP)`` (felics_tpu.ops.kscan_tiled,
config.QCTX_CAP = 5) instead of exact Δ — 6 buckets keep per-tile tables
tiny (6 x K rows; merging the rare high-Δ contexts measured FREE on ratio),
which is what lets thousands of tiles decode concurrently on-chip; (2) the
raw preamble pixels
are depth-sized rather than 32-bit (plane 0: ``depth`` unsigned bits; the
signed Co/Cg planes: ``depth+1``-bit two's complement) — per-tile restart
overhead matters at tile granularity where 32-bit preambles cost ~1% of the
whole payload; (3) (v2, flags bit 1) every (tile, channel) k-table starts at
the per-image prior ``PRIOR_WEIGHT * |k - k0[channel][bucket]|`` instead of
all zeros, where k0 is the globally-best k per (channel, bucket) computed by
the encoder over the whole image and stored in the header as 4-bit nibbles —
this removes most of the per-tile estimator cold-start cost (measured: tile
32 goes from +1.3% to +0.6% vs single-stream FLCS on the corpus; see
scripts/ratio_lab.py). A zero prior reproduces the v0 (flags=0) streams
bit-exactly, so v0 containers remain decodable.

Tiles are mutually independent: encode is one batched XLA analysis over all
tiles followed by a parallel bit packer; decode walks every tile's stream at
once, either as a vmapped per-pixel scan (the XLA engine) or in the GPU
kernel of ops.pallas_decode; the tile axis shards over a
``jax.sharding.Mesh`` for multi-device runs (felics_tpu.parallel.mesh).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from functools import lru_cache as functools_lru_cache

from felics_tpu import errors
from felics_tpu.config import (
    CodingConfig,
    TileConfig,
    tiled_config_for_depth,
)
from felics_tpu.core.color import rgb_to_ycocg, ycocg_to_rgb
from felics_tpu.core.context import neighbour_indices
from felics_tpu.format import ColorType, PixelDepth
from felics_tpu.ops import bitpack
from felics_tpu.ops.analysis import phase_in_code
from felics_tpu.ops.kscan_tiled import kscan_tiled, num_buckets, qctx_of
from felics_tpu.utils import platform


def _bucket_count(value: int, minimum: int = 64) -> int:
    """Bucket a compaction count to bound jit recompilation."""
    if value <= minimum:
        return minimum
    gran = max(minimum, 1 << max(0, value.bit_length() - 2))
    return -(-value // gran) * gran

MAGIC_TILED = b"FLCT"
_FIXED_HEADER = struct.Struct(">4sBBIIHHHI")  # 24 bytes

FLAG_TABLE_U16 = 0x0001  # tile length table entries are u16 (else u32)
FLAG_K_PRIOR = 0x0002  # header carries the per-(channel, bucket) k0 prior
_KNOWN_FLAGS = FLAG_TABLE_U16 | FLAG_K_PRIOR
# Seed weight of the k-prior: every (tile, channel) k-table starts at
# PRIOR_WEIGHT * |k - k0| instead of zeros (swept in scripts/ratio_lab.py;
# 2-4 are equivalent on the corpus, larger over-commits to the global k).
PRIOR_WEIGHT = 4


@dataclass
class TiledHeader:
    color_type: ColorType
    pixel_depth: PixelDepth
    width: int
    height: int
    tile_w: int
    tile_h: int
    n_tiles: int
    tile_lengths: np.ndarray  # payload bytes per tile
    flags: int = 0
    k0: Optional[np.ndarray] = None  # (C, nb) per-(channel, bucket) prior k
    payload_off: int = _FIXED_HEADER.size

    @property
    def num_channels(self) -> int:
        return 1 if self.color_type == ColorType.GRAY else 3


def read_tiled_header(data: bytes) -> TiledHeader:
    if len(data) < _FIXED_HEADER.size:
        raise errors.IoError("truncated FLCT header")
    magic, color, depth, w, h, tw, th, flags, n_tiles = _FIXED_HEADER.unpack(
        data[: _FIXED_HEADER.size]
    )
    if magic != MAGIC_TILED:
        raise errors.InvalidSignature(f"bad magic {magic!r}")
    if flags & ~_KNOWN_FLAGS:
        raise errors.InvalidValue(f"unsupported FLCT flags {flags:#06x}")
    color_type = ColorType.from_byte(color)
    pixel_depth = PixelDepth.from_byte(depth)
    # Every header field is validated before use, like the reference's
    # format reader (src/compression/format.rs:63-84): the encoder never
    # emits tile dims < 2 (see _clamped_tile_dims), and the tile grid
    # implied by (dims, tile dims) must match n_tiles — a zeroed/corrupt
    # field would otherwise divide by zero or mis-slice the payload.
    if tw < 2 or th < 2:
        raise errors.InvalidDimensions(f"invalid tile dims {tw}x{th}")
    expect_tiles = 0 if (w == 0 or h == 0) else (-(-h // th)) * (-(-w // tw))
    if n_tiles != expect_tiles:
        raise errors.InvalidDimensions(
            f"tile grid mismatch: header says {n_tiles} tiles, dims imply "
            f"{expect_tiles}"
        )
    pos = _FIXED_HEADER.size
    k0 = None
    if flags & FLAG_K_PRIOR:
        c = 1 if color_type == ColorType.GRAY else 3
        cfg = tiled_config_for_depth(pixel_depth)
        nb = num_buckets(cfg)
        nbytes = (c * nb + 1) // 2
        if len(data) < pos + nbytes:
            raise errors.IoError("truncated FLCT k-prior block")
        nibs = np.frombuffer(data[pos : pos + nbytes], dtype=np.uint8)
        k0 = np.empty(nbytes * 2, np.int32)
        k0[0::2] = nibs >> 4
        k0[1::2] = nibs & 0x0F
        # Corrupt-stream tolerance: nibbles past the largest candidate k only
        # shape the prior, never the code itself — clamp for sanity.
        k0 = np.minimum(k0[: c * nb], cfg.k_values[-1]).reshape(c, nb)
        pos += nbytes
    entry = 2 if flags & FLAG_TABLE_U16 else 4
    end = pos + entry * n_tiles
    if len(data) < end:
        raise errors.IoError("truncated FLCT tile table")
    dt = ">u2" if flags & FLAG_TABLE_U16 else ">u4"
    lengths = np.frombuffer(data[pos:end], dtype=dt).astype(np.int64)
    return TiledHeader(
        color_type=color_type,
        pixel_depth=PixelDepth.from_byte(depth),
        width=w,
        height=h,
        tile_w=tw,
        tile_h=th,
        n_tiles=n_tiles,
        tile_lengths=lengths,
        flags=flags,
        k0=k0,
        payload_off=end,
    )


@functools_lru_cache(maxsize=4)
def _qctx_lut(max_context: int) -> np.ndarray:
    """min(bit_length, QCTX_CAP) lookup for 0..max_context (floats via log2
    measured ~10x slower on the host path; this is the container encoder's
    hot host op)."""
    from felics_tpu.config import QCTX_CAP

    v = np.arange(max_context + 1, dtype=np.uint32)
    lut = np.zeros(max_context + 1, np.int64)
    bit = 0
    while (1 << bit) <= max_context:
        lut[v >= (1 << bit)] = bit + 1
        bit += 1
    return np.minimum(lut, QCTX_CAP)


def compute_k0_batch(
    tiles_np: np.ndarray,
    counts,
    th: int,
    tw: int,
    cfg: CodingConfig,
    nb: int,
) -> np.ndarray:
    """Per-(image, channel, bucket) globally-best Rice k for a concatenated
    tile batch; ``counts`` = tiles per image. Returns (n_imgs, C, nb) int32.

    Exact int64 host arithmetic (the value is written into the header and
    read back by every decoder, so engines need not recompute it — but the
    native C++ encoder computes the same sums in uint64, and byte-parity
    tests require the identical argmin). Ties select the largest k and
    all-zero (unseen bucket) yields the largest k, mirroring the estimator's
    selection rule (reference: src/compression/parameter_selection.rs:71-85).
    One vectorized pass + K bincounts for the WHOLE batch (bincount weights
    are float64 but the sums stay << 2^53, hence exact).
    """
    nt, c, t = tiles_np.shape
    counts = np.asarray(counts, np.int64)
    n_imgs = len(counts)
    a_idx, b_idx = neighbour_indices(th, tw, xp=np)
    # All int32 until the bincount (tiles are int32; residuals fit easily) —
    # int64 intermediates doubled this host pass's memory traffic.
    v1 = tiles_np[..., a_idx]
    v2 = tiles_np[..., b_idx]
    low = np.minimum(v1, v2)
    ctx = np.abs(v1 - v2)
    p = tiles_np
    first_two = np.arange(t) < 2
    below = (p < low) & ~first_two
    above = (p > low + ctx) & ~first_two
    oor = below | above
    qctx = _qctx_lut(int(cfg.max_context))[ctx].astype(np.int32)

    k_values = np.asarray(cfg.k_values, np.int64)
    K = len(k_values)
    img_of_tile = np.repeat(np.arange(n_imgs, dtype=np.int32), counts)
    chan = np.arange(c, dtype=np.int32)[None, :, None]
    bucket_full = (img_of_tile[:, None, None] * c + chan) * nb + qctx
    bucket = bucket_full[oor]
    # residual only on the extracted subset (typically ~half the pixels).
    below_s = below[oor]
    pe, le, ce = p[oor], low[oor], ctx[oor]
    res = np.where(below_s, le - pe, pe - le - ce) - 1
    nbuckets = n_imgs * c * nb
    totals = np.zeros((K, nbuckets), np.int64)
    for ki, k in enumerate(k_values):
        wts = (res >> k) + 1 + int(k)
        totals[ki] = np.bincount(
            bucket, weights=wts.astype(np.float64), minlength=nbuckets
        ).astype(np.int64)
    best = (K - 1) - np.argmin(totals[::-1], axis=0)  # ties -> largest k
    return k_values[best].reshape(n_imgs, c, nb).astype(np.int32)


def compute_k0(
    tiles_np: np.ndarray, th: int, tw: int, cfg: CodingConfig, nb: int
) -> np.ndarray:
    """Per-(channel, bucket) globally-best Rice k over one image's tiles."""
    return compute_k0_batch(
        tiles_np, [tiles_np.shape[0]], th, tw, cfg, nb
    )[0]


def k0_device_exact(
    cfg: CodingConfig, tile_pixels: int, tiles_per_image: int
) -> bool:
    """Whether the on-device k0 sums are provably exact.

    The device pass (compute_k0_prior_jax) accumulates per-TILE int32
    partials, then carries them across an image's tiles as 16-bit-split
    (hi, lo) int32 pairs with a lexicographic argmin, exact far past
    int32 — so 16-bit images stay on the device path too (pre-r4 they
    fell back to a host int64 pass that dominated their encode time).

    Per-update weight bound: the YCoCg chroma planes span (-2^d, 2^d), so
    a residual reaches max_context - 1 = 2^(d+1) - 3 and the k=0 weight
    reaches max_context (NOT 2^d — an earlier form understated the chroma
    case by 2x); at most tile_pixels - 2 coded pixels update a bucket."""
    max_w = 2 * (1 << cfg.depth_bits) - 2 + cfg.num_k  # + k term at big k
    per_tile = max(0, tile_pixels - 2) * max_w
    lo_sum = tiles_per_image * ((1 << 16) - 1)
    hi_sum = tiles_per_image * (per_tile >> 16)
    return max(per_tile, lo_sum, hi_sum + (lo_sum >> 16)) < (1 << 31)


@partial(jax.jit, static_argnames=("th", "tw", "cfg", "nb", "n_imgs"))
def compute_k0_prior_jax(
    tiles, img_of_tile, th: int, tw: int, cfg: CodingConfig, nb: int,
    n_imgs: int,
):
    """On-device k0 + per-tile prior: (k0 (n_imgs, C, nb) int32,
    prior (nt, C, nb, K) int32).

    Same exact sums/argmin as compute_k0_batch (callers must gate with
    k0_device_exact); keeps the whole container encode chain on-device,
    instead of a host pass ahead of the dispatch.
    Cross-tile accumulation runs as 16-bit-split (hi, lo) int32 pairs so
    the per-image totals stay EXACT past int32 (the 16-bit depths need
    ~35 bits); the argmin compares the pairs lexicographically after
    carry normalization — identical result to the host int64 argmin."""
    from felics_tpu.ops.kscan_tiled import qctx_of as _qctx

    tiles = tiles.astype(jnp.int32)  # callers upload the narrow dtype
    nt, c, t = tiles.shape
    a_idx, b_idx = neighbour_indices(th, tw, xp=jnp)
    v1 = tiles[..., a_idx]
    v2 = tiles[..., b_idx]
    low = jnp.minimum(v1, v2)
    ctx = jnp.abs(v1 - v2)
    p = tiles
    first_two = jnp.arange(t) < 2
    below = (p < low) & ~first_two
    above = (p > low + ctx) & ~first_two
    oor = below | above
    residual = jnp.where(below, low - p, p - low - ctx) - 1
    qctx = _qctx(ctx)
    kv = jnp.asarray(cfg.k_values, jnp.int32)
    K = cfg.num_k
    # Two-level reduction: a masked sum per (tile, channel, bucket) over the
    # tile's pixels (one fused reduction; an integer matmul against a one-hot
    # would have no tensor-core path), then a tiny nt-element segment-sum
    # over tiles into images. int32 is exact per the k0_device_exact gate.
    in_bucket = qctx[..., None] == jnp.arange(nb, dtype=jnp.int32)
    per_tile = []
    for k in cfg.k_values:
        w = jnp.where(oor, (residual >> k) + 1 + int(k), 0)
        per_tile.append(
            jnp.sum(jnp.where(in_bucket, w[..., None], 0), axis=2)
        )
    per_tile = jnp.stack(per_tile, axis=-1)  # (nt, C, nb, K), exact int32
    # Exact-past-int32 cross-tile accumulation: 16-bit split halves summed
    # separately, carry-normalized, compared lexicographically.
    lo_sum = jax.ops.segment_sum(
        per_tile & 0xFFFF, img_of_tile, num_segments=n_imgs
    )
    hi_sum = jax.ops.segment_sum(
        per_tile >> 16, img_of_tile, num_segments=n_imgs
    )
    hi = hi_sum + (lo_sum >> 16)  # (n_imgs, C, nb, K)
    lo = lo_sum & 0xFFFF
    m_hi = jnp.min(hi, axis=-1, keepdims=True)
    lo_sel = jnp.where(hi == m_hi, lo, jnp.int32(1 << 30))
    m_lo = jnp.min(lo_sel, axis=-1, keepdims=True)
    is_best = (hi == m_hi) & (lo == m_lo)  # total == min total
    # ties -> LARGEST k: last True along K (mirror of the reversed argmin
    # in compute_k0_batch).
    best = (K - 1) - jnp.argmax(is_best[..., ::-1], axis=-1)
    k0 = kv[best]  # (n_imgs, C, nb)
    prior_img = PRIOR_WEIGHT * jnp.abs(
        kv[None, None, None, :] - k0[..., None]
    )  # (n_imgs, C, nb, K)
    return k0, prior_img[img_of_tile]


def prior_from_k0(k0: Optional[np.ndarray], cfg: CodingConfig, c: int):
    """(C, nb, K) int32 k-table seed. None (v0 stream) -> zeros."""
    nb = num_buckets(cfg)
    kv = np.asarray(cfg.k_values, np.int32)
    if k0 is None:
        return np.zeros((c, nb, len(kv)), np.int32)
    k0 = np.minimum(np.asarray(k0, np.int32), kv[-1])
    return (PRIOR_WEIGHT * np.abs(kv[None, None, :] - k0[..., None])).astype(
        np.int32
    )


def pack_tiled_container(
    base_color: ColorType,
    base_depth: PixelDepth,
    w: int,
    h: int,
    tw: int,
    th: int,
    n_tiles: int,
    tile_bytes_np: np.ndarray,
    payload: bytes,
    k0: Optional[np.ndarray],
) -> bytes:
    """Assemble header (+ optional k-prior block) + length table + payload."""
    flags = 0
    prior_blob = b""
    if k0 is not None:
        flags |= FLAG_K_PRIOR
        nib = np.asarray(k0, np.uint8).reshape(-1)
        if nib.size % 2:
            nib = np.append(nib, np.uint8(0))
        prior_blob = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()
    if n_tiles == 0 or int(tile_bytes_np.max(initial=0)) < (1 << 16):
        flags |= FLAG_TABLE_U16
        table = tile_bytes_np.astype(">u2").tobytes()
    else:
        table = tile_bytes_np.astype(">u4").tobytes()
    header = _FIXED_HEADER.pack(
        MAGIC_TILED, int(base_color), int(base_depth), w, h, tw, th, flags,
        n_tiles,
    )
    return header + prior_blob + table + payload


def _clamped_tile_dims(h: int, w: int, tile: TileConfig) -> Tuple[int, int]:
    th = max(2, min(tile.tile_h, h))
    tw = max(2, min(tile.tile_w, w))
    return th, tw


def _pad_to_tiles(image: np.ndarray, th: int, tw: int) -> np.ndarray:
    h, w = image.shape[:2]
    ph = (-h) % th
    pw = (-w) % tw
    if ph or pw:
        pad = [(0, ph), (0, pw)] + [(0, 0)] * (image.ndim - 2)
        image = np.pad(image, pad, mode="edge")
    return image


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def narrow_tile_dtype(depth_bits: int, c: int) -> np.dtype:
    """Smallest dtype that losslessly holds tile plane values (gray planes
    in [0, 2^d); YCoCg planes: Y in [0, 2^d), Co/Cg in (-2^d, 2^d)).
    Host<->device transfers move this dtype; the jitted consumers widen to
    int32 on device."""
    if depth_bits == 8:
        return np.dtype(np.uint8) if c == 1 else np.dtype(np.int16)
    return np.dtype(np.uint16) if c == 1 else np.dtype(np.int32)


@partial(jax.jit, static_argnames=("depth_bits", "out_dtype"))
def _narrow_bufs(bufs, depth_bits: int, out_dtype: str):
    """Clamp + narrow decoded tile planes for the device->host fetch, plus
    a per-tile out-of-bounds flag. A valid stream never produces values
    outside the plane bounds, but a corrupt one can — and the narrowing
    cast would wrap those into the valid range, so they are flagged here
    (and clamped) instead; callers raise InvalidValue for flagged tiles.
    bufs: (nt, C, T) int32."""
    bound = (1 << depth_bits) - 1
    lo = 0 if np.dtype(out_dtype).kind == "u" else -bound
    bad = jnp.any((bufs < lo) | (bufs > bound), axis=(1, 2))
    small = jnp.clip(bufs, lo, bound).astype(np.dtype(out_dtype))
    return small, bad


@partial(jax.jit, static_argnames=("th", "tw", "nb"))
def _tiled_stage1(tiles, th: int, tw: int, nb: int):
    """tiles: (n_tiles, C, T) int planes (any width — widened to int32 so
    callers can upload the narrow dtype). Returns analysis + rank/count
    info."""
    tiles = tiles.astype(jnp.int32)
    t = th * tw
    a_idx, b_idx = neighbour_indices(th, tw, xp=jnp)
    v1 = tiles[..., a_idx]
    v2 = tiles[..., b_idx]
    high = jnp.maximum(v1, v2)
    low = jnp.minimum(v1, v2)
    context = (high - low).astype(jnp.int32)

    pix = jnp.arange(t, dtype=jnp.int32)
    first_two = pix < 2
    p = tiles
    in_range = (p >= low) & (p <= high) & ~first_two
    below = (p < low) & ~first_two
    above = (p > high) & ~first_two
    oor = below | above
    residual = jnp.where(below, low - p - 1, jnp.where(above, p - high - 1, 0)).astype(
        jnp.int32
    )

    qctx = qctx_of(context)
    return (context, low, oor, residual, in_range, above, qctx)


@partial(jax.jit, static_argnames=("th", "tw", "cfg", "nb", "row_words"))
def _tiled_stage2(
    tiles, context, low, oor, residual, in_range, above, qctx, prior,
    th: int, tw: int, cfg: CodingConfig, nb: int, row_words: int = 0,
):
    """Symbols + per-tile/global offsets. ``prior``: (nt, C, nb, K) int32
    per-domain k-table seed (zeros = v0). Returns flat symbols, flat offsets,
    per-tile byte lengths, total payload bytes.

    ``row_words`` > 0: ROW layout — tile i's stream starts at the fixed bit
    offset i*row_words*32 instead of the compacted byte cumsum, so the
    offsets depend only on data local to each tile (no cross-tile cumsum;
    the shard-mapped XLA engine packs per-device rows with zero
    collectives). The per-tile bytes are identical either way."""
    tiles = tiles.astype(jnp.int32)  # callers upload the narrow dtype
    nt, c, t = tiles.shape
    k = kscan_tiled(
        qctx.reshape(nt * c, t),
        oor.reshape(nt * c, t),
        residual.reshape(nt * c, t),
        cfg,
        nb,
        prior.reshape(nt * c, nb, cfg.num_k),
    ).reshape(nt, c, t)

    # --- symbolize (same codeword layout as ops.analysis.symbolize) ---
    a_val = jnp.where(in_range, 1, jnp.where(above, 0b01, 0b00))
    a_len = jnp.where(in_range, 1, 2)
    phase_val, phase_len = phase_in_code(context + 1, tiles - low)
    v = residual
    q = jnp.where(oor, v >> k, 0)
    remainder = (v & ((1 << k) - 1)).astype(jnp.uint32)
    b_val = jnp.where(in_range, phase_val, remainder)
    b_len = jnp.where(in_range, phase_len, k + 1)

    pix = jnp.arange(t, dtype=jnp.int32)
    is0 = pix == 0
    is1 = pix == 1
    # Depth-sized raw preamble: plane 0 (gray/Y) is unsigned depth bits;
    # planes 1-2 (Co/Cg) are signed, stored as depth+1-bit two's complement.
    pre_w = (
        cfg.depth_bits
        + (jnp.arange(c, dtype=jnp.int32) > 0).astype(jnp.int32)
    )[None, :, None]
    pre_mask = ((jnp.uint32(1) << pre_w) - 1).astype(jnp.uint32)
    p0 = tiles[..., 0:1].astype(jnp.uint32) & pre_mask
    p1 = tiles[..., 1:2].astype(jnp.uint32) & pre_mask
    a_val = jnp.where(is0, p0, jnp.where(is1, 0, a_val)).astype(jnp.uint32)
    a_len = jnp.where(is0, pre_w, jnp.where(is1, 0, a_len)).astype(jnp.int32)
    q = jnp.where(is0 | is1, 0, q).astype(jnp.int32)
    b_val = jnp.where(is0, p1, jnp.where(is1, 0, b_val)).astype(jnp.uint32)
    b_len = jnp.where(is0, pre_w, jnp.where(is1, 0, b_len)).astype(jnp.int32)

    # --- offsets: per-tile bit cumsum, byte-aligned tile starts ---
    lens = (a_len + q + b_len).reshape(nt, c * t)
    ends = jnp.cumsum(lens, axis=1, dtype=jnp.int32)
    tile_bits = ends[:, -1]
    tile_bytes = (tile_bits + 7) >> 3
    if row_words:
        tile_starts = jnp.arange(nt, dtype=jnp.int32) * (row_words * 4)
    else:
        tile_starts = jnp.cumsum(tile_bytes) - tile_bytes  # exclusive, bytes
    within = ends - lens
    offsets = (tile_starts[:, None] << 3) + within
    total_bytes = tile_starts[-1] + tile_bytes[-1]

    from felics_tpu.ops.analysis import Symbols

    flat = Symbols(
        a_val=a_val.reshape(-1),
        a_len=a_len.reshape(-1),
        q=q.reshape(-1),
        b_val=b_val.reshape(-1),
        b_len=b_len.reshape(-1),
    )
    return flat, offsets.reshape(-1), tile_bytes, total_bytes


def _prepare_tiles(image: np.ndarray, color: ColorType, th: int, tw: int):
    padded = _pad_to_tiles(np.asarray(image), th, tw)
    hp, wp = padded.shape[:2]
    ty, tx = hp // th, wp // tw
    if color == ColorType.GRAY:
        chans = padded.astype(np.int32)[None]  # (1, Hp, Wp)
    else:
        flat = padded.astype(np.int32).reshape(-1, 3)
        y, co, cg = rgb_to_ycocg(flat[:, 0], flat[:, 1], flat[:, 2])
        chans = np.stack([y, co, cg]).reshape(3, hp, wp)
    c = chans.shape[0]
    # (C, ty, th, tx, tw) -> (ty, tx, C, th*tw)
    tiles = (
        chans.reshape(c, ty, th, tx, tw)
        .transpose(1, 3, 0, 2, 4)
        .reshape(ty * tx, c, th * tw)
    )
    return tiles, ty, tx


def _image_tiles_device(imgs, th: int, tw: int, rgb: bool):
    """(N, H, W[, 3]) narrow-dtype image batch -> (N*ty*tx, C, th*tw) int32
    tiles ON DEVICE (traced body): edge-pad to tile multiples, YCoCg for
    RGB, row-major tile reshape — the device mirror of _prepare_tiles, so
    same-shape batches upload raw pixels in their own dtype and skip the
    host transform."""
    n, h, w = imgs.shape[:3]
    ph, pw = (-h) % th, (-w) % tw
    if ph or pw:
        pad = ((0, 0), (0, ph), (0, pw)) + (
            ((0, 0),) if imgs.ndim == 4 else ()
        )
        imgs = jnp.pad(imgs, pad, mode="edge")
    hp, wp = h + ph, w + pw
    ty, tx = hp // th, wp // tw
    x = imgs.astype(jnp.int32)
    if rgb:
        y, co, cg = rgb_to_ycocg(x[..., 0], x[..., 1], x[..., 2], xp=jnp)
        chans = jnp.stack([y, co, cg], axis=1)  # (N, 3, Hp, Wp)
    else:
        chans = x[:, None]
    c = chans.shape[1]
    return (
        chans.reshape(n, c, ty, th, tx, tw)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(n * ty * tx, c, th * tw)
    )


def _columns_to_payload(words_lw: np.ndarray, lens_bytes: np.ndarray) -> bytes:
    """Compact per-tile big-endian word rows into the concatenated payload."""
    L, W = words_lw.shape
    rows = np.ascontiguousarray(words_lw.astype(">u4")).view(np.uint8)
    rows = rows.reshape(L, W * 4)
    mask = np.arange(W * 4, dtype=np.int64)[None, :] < lens_bytes[:, None]
    return rows[mask].tobytes()


def _analyze(tiles, img_of_tile, prior, th, tw, cfg, nb, n_imgs):
    """Traced encode analysis shared by both encode entry points: k0 and
    the k-table seeds (on device unless ``prior`` is given), stage 1
    (contexts), stage 2 (adaptive k, symbols, bit offsets) and the count
    the packer sizes itself by. Everything but the packing itself."""
    nt, c, _t = tiles.shape
    k0 = None
    if prior is None:
        k0, prior = compute_k0_prior_jax(
            tiles, img_of_tile, th, tw, cfg, nb, n_imgs
        )
    elif prior.ndim == 3:
        prior = jnp.broadcast_to(prior[None], (nt, c, nb, cfg.num_k))
    st1 = _tiled_stage1(tiles, th, tw, nb)
    flat, offsets, tile_bytes, total = _tiled_stage2(
        tiles, *st1, prior, th, tw, cfg, nb
    )
    return flat, offsets, tile_bytes, total, bitpack.count_big_symbols(flat), k0


_analyze_tiles = jax.jit(
    _analyze, static_argnames=("th", "tw", "cfg", "nb", "n_imgs")
)


@partial(jax.jit, static_argnames=("th", "tw", "cfg", "nb", "n_imgs", "rgb"))
def _analyze_images(imgs, th, tw, cfg, nb, n_imgs, rgb):
    tiles = _image_tiles_device(imgs, th, tw, rgb)
    img_of_tile = jnp.repeat(
        jnp.arange(n_imgs, dtype=jnp.int32), tiles.shape[0] // n_imgs
    )
    return _analyze(tiles, img_of_tile, None, th, tw, cfg, nb, n_imgs)


def _host_async(arrs) -> None:
    """Start device->host copies of already-dispatched results so the
    transfer overlaps whatever the host does next."""
    for a in arrs:
        if a is not None:
            a.copy_to_host_async()


def encode_dispatch_tiles(
    tiles_np: np.ndarray, counts, th: int, tw: int, cfg: CodingConfig,
    k_prior: bool = True,
):
    """Start the encode of host-prepared tiles (``_prepare_tiles`` output of
    one or more images; ``counts`` = tiles per image) without blocking.
    The k0 prior is computed on device when its sums are provably exact
    there (``k0_device_exact``), else exactly on the host (int64).
    ``k_prior=False``: zero seeds (the legacy v0 stream). Returns the
    pending state for ``encode_finish``."""
    _nt, c, t = tiles_np.shape
    nb = num_buckets(cfg)
    n_imgs = len(counts)
    tiles_dev = jnp.asarray(
        tiles_np.astype(narrow_tile_dtype(cfg.depth_bits, c))
    )
    img_of_tile = np.repeat(np.arange(n_imgs, dtype=np.int32), counts)
    k0_host = None
    if not k_prior:
        prior = jnp.zeros((c, nb, cfg.num_k), jnp.int32)
    elif k0_device_exact(cfg, t, int(max(counts))):
        prior = None
    else:
        k0_host = compute_k0_batch(tiles_np, counts, th, tw, cfg, nb)
        prior = jnp.asarray(prior_from_k0(k0_host, cfg, c)[img_of_tile])
    out = _analyze_tiles(
        tiles_dev, jnp.asarray(img_of_tile), prior, th, tw, cfg, nb, n_imgs
    )
    _host_async(out[2:])
    return out, k0_host


def encode_dispatch_images(
    imgs_np: np.ndarray, th: int, tw: int, cfg: CodingConfig
):
    """Start the encode of a same-shape image batch (N, H, W[, 3]) from raw
    pixels: upload in the images' own dtype; tiling, YCoCg, k0 and the
    analysis all run on device. Returns the pending state for
    ``encode_finish``, or None when the k0 sums are not provably exact on
    device for this shape (callers then prepare tiles on the host)."""
    n_imgs, h, w = imgs_np.shape[:3]
    if not k0_device_exact(cfg, th * tw, (-(-h // th)) * (-(-w // tw))):
        return None
    out = _analyze_images(
        jnp.asarray(np.ascontiguousarray(imgs_np)), th, tw, cfg,
        num_buckets(cfg), n_imgs, imgs_np.ndim == 4,
    )
    _host_async(out[2:])
    return out, None


def encode_finish(pending):
    """Blocking half of the encode: fetch the sizes, pack the payload and
    fetch it. Returns (tile byte lengths int64, payload bytes, k0 per image
    (n_imgs, C, nb) int32 or None for v0 streams)."""
    (flat, offsets, tile_bytes, total, n_big, k0_dev), k0_host = pending
    tile_bytes_np, total, n_big, k0 = jax.device_get(
        (tile_bytes, total, n_big, k0_dev)
    )
    total, n_big = int(total), int(n_big)
    packed = bitpack.pack_bits_scatter(
        flat, offsets, bitpack.bucket_bits(total * 8),
        min(_bucket_count(n_big), offsets.shape[0]),
    )
    payload = np.asarray(packed)[:total].tobytes()
    LAST_ENGINE["encode"] = "xla"
    return (
        np.asarray(tile_bytes_np, np.int64), payload,
        k0_host if k0 is None else np.asarray(k0),
    )


def compress_tiled_bytes(
    image: np.ndarray,
    tile: Optional[TileConfig] = None,
    k_prior: bool = True,
) -> bytes:
    """Encode one image into an FLCT container on the default device.
    ``k_prior=False`` emits a legacy v0 container (no per-image k-prior,
    u32 length table)."""
    from felics_tpu.api import header_for_array

    base = header_for_array(image)  # validates dtype/shape
    tile = tile or TileConfig()
    h, w = base.height, base.width
    if h == 0 or w == 0:
        th, tw = max(2, tile.tile_h), max(2, tile.tile_w)
        header = _FIXED_HEADER.pack(
            MAGIC_TILED, int(base.color_type), int(base.pixel_depth),
            w, h, tw, th, 0, 0,
        )
        return header
    th, tw = _clamped_tile_dims(h, w, tile)
    cfg = tiled_config_for_depth(base.pixel_depth)
    ty, tx = -(-h // th), -(-w // tw)

    pending = None
    if k_prior:
        pending = encode_dispatch_images(np.asarray(image)[None], th, tw, cfg)
    if pending is None:
        tiles_np, ty, tx = _prepare_tiles(image, base.color_type, th, tw)
        pending = encode_dispatch_tiles(
            tiles_np, [tiles_np.shape[0]], th, tw, cfg, k_prior
        )
    tile_bytes_np, payload_b, k0s = encode_finish(pending)
    if not k_prior:  # legacy v0: flags=0, u32 table, no prior block
        return (
            _FIXED_HEADER.pack(
                MAGIC_TILED, int(base.color_type), int(base.pixel_depth),
                w, h, tw, th, 0, ty * tx,
            )
            + tile_bytes_np.astype(">u4").tobytes()
            + payload_b
        )
    return pack_tiled_container(
        base.color_type, base.pixel_depth, w, h, tw, th, ty * tx,
        tile_bytes_np, payload_b, k0s[0],
    )


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

# The two decode engines, byte-identical: "xla" is the vmapped per-pixel
# scan below, "pallas" the GPU kernel in ops.pallas_decode (interpret mode
# on the CPU). Encode has one engine, the XLA pipeline above.
DECODE_ENGINES = ("xla", "pallas")

# What ran last, for callers and tests that check the path taken.
LAST_ENGINE = {"encode": None, "decode": None}


def resolve_decode_engine(engine: str) -> str:
    """``"auto"`` is the kernel on the GPU and the XLA scan elsewhere (the
    kernel's interpreter is far slower than the scan on the CPU). Any other
    name must be a decode engine."""
    if engine == "auto":
        return "pallas" if platform.backend() == "gpu" else "xla"
    if engine not in DECODE_ENGINES:
        raise ValueError(
            f"unknown decode engine {engine!r}; expected 'auto', "
            + " or ".join(repr(e) for e in DECODE_ENGINES)
        )
    return engine


def _read_bits_fn(words):
    def read(pos, nbits_max: int):
        word_idx = pos >> 5
        bit_off = (pos & 31).astype(jnp.uint32)
        w0 = words[word_idx]
        w1 = words[jnp.minimum(word_idx + 1, words.shape[0] - 1)]
        hi = w0 << bit_off
        lo = jnp.where(
            bit_off > 0, w1 >> (jnp.uint32(32) - bit_off), jnp.uint32(0)
        )
        window = hi | lo
        if nbits_max == 32:
            return window
        return window >> jnp.uint32(32 - nbits_max)

    return read


@partial(jax.jit, static_argnames=("th", "tw", "c", "cfg", "nb"))
def _decode_tiles(
    words, tile_bit_starts, th: int, tw: int, c: int, cfg: CodingConfig,
    nb: int, prior=None, tile_group=None,
):
    """vmapped sequential decode of every tile at once.

    ``prior``: (G, C, nb, K) int32 k-table seeds and ``tile_group``:
    (n_tiles,) int32 index into G (images in a batch have distinct priors);
    None = zero seed (v0 streams).

    Every pixel step is a round of device work, so the step is kept small:
    ONE aligned 64-bit window (3 word gathers) feeds the marker, phase-in
    code, unary run, and Rice remainder extractions arithmetically; the
    k-table row select/update is dense one-hot math (no gather/scatter);
    the long-unary fallback while_loop body never executes unless some
    lane's quotient overruns the window (rare). Returns (n_tiles, C, T)
    int32. The GPU kernel ops.pallas_decode.decode_tiles has the same
    contract and output.
    """
    t = th * tw
    k_values = jnp.asarray(cfg.k_values, dtype=jnp.int32)
    num_k = cfg.num_k
    if prior is None:
        prior = jnp.zeros((1, c, nb, num_k), jnp.int32)
    if tile_group is None:
        tile_group = jnp.zeros_like(tile_bit_starts)
    a_idx, b_idx = neighbour_indices(th, tw, xp=jnp)
    bucket_ids = jnp.arange(nb, dtype=jnp.int32)
    read = _read_bits_fn(words)
    # Consecutive word triples, so the whole 96-bit cursor window is ONE
    # gather per step (dependent-gather latency dominates decode).
    wpad = jnp.concatenate([words, jnp.zeros((2,), jnp.uint32)])
    words3 = jnp.stack([wpad[:-2], wpad[1:-1], wpad[2:]], axis=1)

    def shr32(v, s):
        s = s.astype(jnp.uint32)
        return jnp.where(s < 32, v >> jnp.minimum(s, 31), jnp.uint32(0))

    def shl32(v, s):
        s = s.astype(jnp.uint32)
        return jnp.where(s < 32, v << jnp.minimum(s, 31), jnp.uint32(0))

    def window_bits(win0, win1, s, n):
        """n bits at offset s (s in [0, 64), s+n <= 64, n traced <= 31)."""
        lo = shl32(win0, s) | jnp.where(s > 0, shr32(win1, 32 - s), 0)
        hi = shl32(win1, s - 32)
        x = jnp.where(s < 32, lo, hi)
        return shr32(x, 32 - n)

    def decode_tile(start_bit, gidx):
        prior_t = prior[gidx]  # (C, nb, K)

        def step(state, i):
            pos, table, buf = state
            j = i % t  # pixel within channel plane
            ch = i // t
            # Fresh k statistics per channel plane, seeded from the header's
            # per-image prior (zeros for v0 streams; matches the encoder's
            # per-(tile, channel) domains and FLCS's per-channel estimator).
            table = jnp.where(
                j == 0,
                jax.lax.dynamic_index_in_dim(prior_t, ch, 0, keepdims=False),
                table,
            )

            # Aligned 64-bit window at the cursor: ONE triple-word gather.
            wi = pos >> 5
            off = (pos & 31).astype(jnp.uint32)
            last = words.shape[0] - 1
            tri = words3[jnp.minimum(wi, last)]
            w_a, w_b, w_c = tri[0], tri[1], tri[2]
            carry = jnp.where(off > 0, w_b >> (jnp.uint32(32) - off), jnp.uint32(0))
            win0 = (w_a << off) | carry
            carry2 = jnp.where(off > 0, w_c >> (jnp.uint32(32) - off), jnp.uint32(0))
            win1 = (w_b << off) | carry2

            # Depth-sized raw preamble for the first two pixels of each
            # channel (planes > 0 are signed two's complement, +1 bit).
            ch_i = i // t
            pre_w = cfg.depth_bits + jnp.where(ch_i > 0, 1, 0)
            pre_sh = (jnp.int32(32) - pre_w).astype(jnp.uint32)
            raw_u = (win0 >> pre_sh).astype(jnp.uint32)
            raw_lo = jax.lax.bitcast_convert_type(raw_u << pre_sh, jnp.int32)
            raw_sx = raw_lo >> pre_sh.astype(jnp.int32)  # arithmetic
            raw = jnp.where(
                ch_i > 0, raw_sx, jax.lax.bitcast_convert_type(raw_u, jnp.int32)
            )

            va = buf[ch * t + a_idx[j]]
            vb = buf[ch * t + b_idx[j]]
            h = jnp.maximum(va, vb)
            l = jnp.minimum(va, vb)
            ctx = jnp.clip(h - l, 0, cfg.max_context)
            qc = qctx_of(ctx)

            onehot = (bucket_ids == qc).astype(jnp.int32)  # (nb,)
            row = jnp.sum(table * onehot[:, None], axis=0)  # (num_k,)
            best = (num_k - 1) - jnp.argmin(row[::-1])
            k = k_values[best]

            first = (win0 >> 31).astype(jnp.int32)

            # --- in-range: phase-in over n = ctx+1, bits at offset 1 ---
            nn = ctx + 1
            m = 31 - jax.lax.clz(nn)
            left_p = nn - (1 << m)
            right_p = (1 << (m + 1)) - nn
            first_m = window_bits(win0, win1, jnp.int32(1), m).astype(jnp.int32)
            short = first_m < right_p
            extra = window_bits(win0, win1, 1 + m, jnp.int32(1)).astype(jnp.int32)
            number = jnp.where(
                short, first_m, (first_m - right_p) * 2 + right_p + extra
            )
            in_value = (number + left_p) % nn + l
            in_pos = pos + 1 + jnp.where(short, m, m + 1)

            # --- out-of-range: second marker bit, unary run, remainder ---
            above_bit = (win0 >> 30) & 1
            u_win = shl32(win0, jnp.int32(2)) | shr32(win1, jnp.int32(30))
            inverted = (~u_win) & jnp.uint32(0xFFFFFFFF)
            lead = jnp.where(inverted == 0, 32, jax.lax.clz(inverted)).astype(
                jnp.int32
            )
            overrun = lead >= 30  # terminator or remainder may exceed window

            bit_limit = jnp.int32(words.shape[0] * 32)

            def cont_cond(st):
                return ~st[3]

            def cont_body(st):
                q2, p2, rem2, done = st
                wdw = read(p2, 32)
                inv = (~wdw) & jnp.uint32(0xFFFFFFFF)
                ld = jnp.where(inv == 0, 32, jax.lax.clz(inv)).astype(jnp.int32)
                ld = jnp.where(done, 0, ld)  # finished lanes stay put
                # p2 >= bit_limit: corrupt stream ran off the end — stop (the
                # garbage value is range-checked after assembly). ``done`` is
                # sticky so already-finished lanes cannot re-arm the loop.
                fin = done | (ld < 32) | (p2 >= bit_limit)
                # On termination also fetch the Rice remainder at the far
                # cursor (only overrun lanes ever reach here).
                rem2 = jnp.where(
                    fin & ~done,
                    (read(p2 + ld + 1, 32) >> (32 - k).astype(jnp.uint32)).astype(
                        jnp.int32
                    ),
                    rem2,
                )
                return q2 + ld, p2 + ld + jnp.where(fin & ~done, 1, 0), rem2, fin

            # Fallback continues from the cursor for overrun lanes; done=True
            # for everyone else, so the loop body is skipped when no lane
            # overruns (the overwhelmingly common case).
            q2, p2, rem_slow, _ = jax.lax.while_loop(
                cont_cond,
                cont_body,
                (jnp.int32(0), pos + 2, jnp.int32(0), ~overrun),
            )
            uq = jnp.where(overrun, q2, lead)
            pos_u = jnp.where(overrun, p2, pos + 2 + lead + 1)
            rem_fast = window_bits(win0, win1, pos_u - pos, k).astype(jnp.int32)
            rem = jnp.where(k > 0, jnp.where(overrun, rem_slow, rem_fast), 0)
            encoded = (uq << k) + rem
            oor_value = jnp.where(above_bit == 1, encoded + h + 1, l - encoded - 1)
            oor_pos = pos_u + k

            is_pre = j < 2
            is_in = (first == 1) & ~is_pre
            is_oor = ~is_in & ~is_pre

            add_row = jnp.where(is_oor, (encoded >> k_values) + 1 + k_values, 0)
            new_row = row + add_row
            if cfg.count_scaling is not None:
                halve = (jnp.min(new_row) > cfg.count_scaling) & is_oor
                new_row = jnp.where(halve, new_row >> 1, new_row)
            table = table + onehot[:, None] * (new_row - row)[None, :]

            value = jnp.where(is_pre, raw, jnp.where(is_in, in_value, oor_value))
            new_pos = jnp.where(
                is_pre, pos + pre_w, jnp.where(is_in, in_pos, oor_pos)
            )
            buf = buf.at[i].set(value)
            return (new_pos, table, buf), None

        table0 = prior_t[0]
        buf0 = jnp.zeros((c * t,), jnp.int32)
        (end_pos, _, buf), _ = jax.lax.scan(
            step,
            (start_bit, table0, buf0),
            jnp.arange(c * t, dtype=jnp.int32),
            unroll=4,  # amortize per-step loop machinery
        )
        return buf

    bufs = jax.vmap(decode_tile)(
        tile_bit_starts.astype(jnp.int32), tile_group.astype(jnp.int32)
    )
    return bufs.reshape(-1, c, t)


def _assemble_image_body(
    bufs, th: int, tw: int, c: int, ty: int, tx: int, height: int, width: int,
    depth_max: int,
):
    """(n_tiles, C, T) planes -> (H, W[, 3]) pixels + validity flag
    (traced body — also vmapped over a same-shape image batch)."""
    planes = (
        bufs.reshape(ty, tx, c, th, tw)
        .transpose(2, 0, 3, 1, 4)
        .reshape(c, ty * th, tx * tw)[:, :height, :width]
    )
    if c == 1:
        out = planes[0]
    else:
        r, g, b = ycocg_to_rgb(planes[0], planes[1], planes[2], xp=jnp)
        out = jnp.stack([r, g, b], axis=-1)
    valid = jnp.all((out >= 0) & (out <= depth_max))
    dtype = jnp.uint8 if depth_max == 255 else jnp.uint16
    return out.astype(dtype), valid


_assemble_image = jax.jit(
    _assemble_image_body,
    static_argnames=("th", "tw", "c", "ty", "tx", "height", "width",
                     "depth_max"),
)


def assemble_image_np(
    bufs_np: np.ndarray, th: int, tw: int, c: int, ty: int, tx: int,
    height: int, width: int, depth_max: int,
) -> np.ndarray:
    """Host-side mirror of _assemble_image for already-fetched tile planes
    (mixed-shape batches fetch all tiles in one transfer and assemble on
    the host). Raises on out-of-depth values like the device path."""
    planes = (
        bufs_np.reshape(ty, tx, c, th, tw)
        .transpose(2, 0, 3, 1, 4)
        .reshape(c, ty * th, tx * tw)[:, :height, :width]
    )
    if c == 1:
        out = planes[0]
    else:
        r, g, b = ycocg_to_rgb(planes[0], planes[1], planes[2])
        out = np.stack([r, g, b], axis=-1)
    if out.size and (out.min() < 0 or out.max() > depth_max):
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
    dtype = np.uint8 if depth_max == 255 else np.uint16
    return out.astype(dtype)


def _bucket_bytes(n: int) -> int:
    """Round a byte count up to a coarse bucket (bounds jit recompiles)."""
    n = max(1 << 12, int(n))
    gran = 1 << max(10, n.bit_length() - 3)
    return -(-n // gran) * gran


def bucket_words(w: int) -> int:
    """Round a per-tile word count up to a coarse bucket (bounds jit
    recompiles of the sharded decoders' row width)."""
    w = max(64, w)
    gran = max(32, 1 << max(0, w.bit_length() - 3))
    return -(-w // gran) * gran


def _payload_to_columns(
    payload: bytes, starts: np.ndarray, lens_bytes: np.ndarray, wd: int
) -> np.ndarray:
    """Expand the concatenated payload back into (L, wd) uint32 word rows,
    zero-padded past each tile's byte length (the sharded decoders' unit)."""
    buf = np.frombuffer(payload, dtype=np.uint8)
    lens_bytes = np.asarray(lens_bytes, np.int64)
    within = np.arange(wd * 4, dtype=np.int64)[None, :] < lens_bytes[:, None]
    expected = int(lens_bytes.sum())
    cums = np.cumsum(lens_bytes) - lens_bytes
    out = np.zeros((len(lens_bytes), wd * 4), np.uint8)
    if np.array_equal(np.asarray(starts, np.int64), cums) and len(buf) >= expected:
        # Contiguous tile streams (every production caller): ONE row-major
        # boolean-mask fill — ~25x faster than the padded gather below.
        out[within] = buf[:expected]
    else:
        buf2 = np.concatenate([buf, np.zeros(wd * 4, np.uint8)])
        idx = starts[:, None] + np.arange(wd * 4, dtype=np.int64)[None, :]
        out = np.where(within, buf2[np.minimum(idx, len(buf2) - 1)], 0)
    return np.ascontiguousarray(out).view(">u4").astype(np.uint32)


def _payload_words(payload: bytes, lens: np.ndarray):
    """Concatenated tile streams -> (big-endian uint32 words, zero-padded to
    a bucketed length, and each tile's starting bit)."""
    lens = np.asarray(lens, np.int64)
    expected = int(lens.sum())
    n = _bucket_bytes(expected + 4)
    if n * 8 >= (1 << 31):
        raise ValueError(
            f"a {expected}-byte payload exceeds the decoders' int32 bit "
            "cursor; decode it in smaller batches"
        )
    buf = np.frombuffer(payload[:expected].ljust(n, b"\0"), dtype=">u4")
    starts = (np.concatenate([[0], np.cumsum(lens)[:-1]]) * 8).astype(np.int32)
    return buf.astype(np.uint32), starts


def _decode_engine_fn(engine: str):
    if engine == "pallas":
        from felics_tpu.ops import pallas_decode

        return pallas_decode.decode_tiles
    return _decode_tiles


@partial(
    jax.jit,
    static_argnames=("th", "tw", "c", "cfg", "n_imgs", "ty", "tx", "h", "w",
                     "engine"),
)
def _decode_images_chain(
    words, starts, prior, tile_group, th: int, tw: int, c: int,
    cfg: CodingConfig, n_imgs: int, ty: int, tx: int, h: int, w: int,
    engine: str,
):
    """Same-shape batch: decode + batched device assembly (vmapped
    crop/inverse-YCoCg). The fetch is the final (N, H, W[, 3]) images in
    their real dtype. Returns (images, per-image validity flags).

    Validity matches the mixed-shape path's plane-level check
    (_narrow_bufs): RAW decoded plane values outside the per-plane bounds
    flag the image even when they land in tile padding or happen to
    inverse-transform back into range — a corrupt container must not be
    accepted on one path and rejected on another."""
    bufs = _decode_engine_fn(engine)(
        words, starts, th, tw, c, cfg, num_buckets(cfg), prior, tile_group
    )
    bufs = bufs.reshape(n_imgs, ty * tx, c, th * tw)
    bound = (1 << cfg.depth_bits) - 1
    lo = 0 if c == 1 else -bound
    planes_ok = jnp.all((bufs >= lo) & (bufs <= bound), axis=(1, 2, 3))
    out, valid = jax.vmap(
        lambda b: _assemble_image_body(b, th, tw, c, ty, tx, h, w, bound)
    )(bufs)
    return out, valid & planes_ok


@partial(
    jax.jit, static_argnames=("th", "tw", "c", "cfg", "out_dtype", "engine")
)
def _decode_tiles_chain(
    words, starts, prior, tile_group, th: int, tw: int, c: int,
    cfg: CodingConfig, out_dtype: str, engine: str,
):
    """Mixed-shape batch: decode + clamp/narrow for one fetch of the tile
    planes, which the host assembles. Returns (tiles, per-tile bad flags)."""
    bufs = _decode_engine_fn(engine)(
        words, starts, th, tw, c, cfg, num_buckets(cfg), prior, tile_group
    )
    return _narrow_bufs(bufs, cfg.depth_bits, out_dtype)


def decode_dispatch(
    payload: bytes, lens: np.ndarray, th: int, tw: int, c: int,
    cfg: CodingConfig, priors: np.ndarray, tile_group, engine: str,
    same_shape=None,
):
    """Start a container decode without blocking: upload the payload words,
    dispatch decode + assembly, and start the result copies.

    priors: (G, C, nb, K) k-table seeds, ``tile_group`` (n_tiles,) indexing
    G (None = group 0). ``same_shape`` = (n_imgs, h, w) assembles images on
    device (every image that shape); None fetches narrowed tile planes.
    The engine is resolved here, before dispatch, and recorded in
    ``LAST_ENGINE``. Returns the dispatched device arrays: (images (N, H,
    W[, 3]) in their dtype, per-image validity) for a same-shape dispatch,
    else (narrowed tile planes (nt, C, T), per-tile bad flags); fetch them
    with ``jax.device_get``."""
    engine = resolve_decode_engine(engine)
    words, starts = _payload_words(payload, lens)
    tg = None if tile_group is None else jnp.asarray(tile_group, jnp.int32)
    args = (jnp.asarray(words), jnp.asarray(starts), jnp.asarray(priors), tg)
    if same_shape is None:
        nd = narrow_tile_dtype(cfg.depth_bits, c)
        out = _decode_tiles_chain(*args, th, tw, c, cfg, nd.name, engine)
    else:
        n_imgs, h, w = same_shape
        out = _decode_images_chain(
            *args, th, tw, c, cfg, n_imgs, -(-h // th), -(-w // tw), h, w,
            engine,
        )
    LAST_ENGINE["decode"] = engine
    _host_async(out)
    return out


def decompress_tiled_bytes(data: bytes, engine: str = "auto") -> np.ndarray:
    header = read_tiled_header(data)
    cfg = tiled_config_for_depth(header.pixel_depth)
    h, w = header.height, header.width
    if h == 0 or w == 0:
        dtype = np.uint8 if header.pixel_depth == PixelDepth.EIGHT else np.uint16
        shape = (h, w) if header.color_type == ColorType.GRAY else (h, w, 3)
        return np.zeros(shape, dtype)

    c = header.num_channels
    payload = data[header.payload_off :]
    if len(payload) < int(header.tile_lengths.sum()):
        raise errors.IoError("truncated FLCT payload")
    images, valid = jax.device_get(
        decode_dispatch(
            payload, header.tile_lengths, header.tile_h, header.tile_w, c,
            cfg, prior_from_k0(header.k0, cfg, c)[None], None, engine,
            same_shape=(1, h, w),
        )
    )
    if not bool(valid[0]):
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
    return images[0]
