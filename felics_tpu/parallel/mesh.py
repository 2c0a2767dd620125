"""Device-mesh sharding for the tiled (FLCT) pipeline.

Tiles are mutually independent, so the natural multi-device layout is the
tile axis sharded over a 1-D mesh (data parallelism over tiles). Both
directions shard via ``jax.shard_map`` with ZERO device collectives
(asserted from compiled HLO by the tests and the dry run):

  * encode (``_shardmap_encode_xla``): each device runs the dense
    stage1/stage2 pipeline on its local tiles and packs every tile into its
    own fixed-width word ROW (row-local offsets, no cross-tile cumsum);
  * decode (``sharded_decode_bufs``): each device decodes its local word
    rows with the resolved decode engine (the GPU kernel or the XLA scan).

The container's byte-offset cumsum runs on the HOST over the gathered
4·n_tiles-byte length vector — that result gather is the only cross-device
movement, and it is output materialization, not an inner-loop exchange.
Every device reaches every other at the same rate here, so nothing is laid
out for a particular interconnect.

``fused_encode_step`` is additionally the whole encoder as ONE jittable
program with static worst-case paddings (no host syncs) — the single-chip
pjit/AOT form. Under GSPMD its global payload scatter compiles to
all-reduces over the payload buffer (HLO-measured in the dry-run), which is
why the sharded/multihost paths use the row-packed shard_map encode
instead. The host-synced dynamic-shape path in tiling.py remains the
single-device production encoder (tighter paddings → less wasted work).
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from felics_tpu.config import CodingConfig, TileConfig, tiled_config_for_depth
from felics_tpu.ops import bitpack
from felics_tpu.ops.kscan_tiled import num_buckets
from felics_tpu.parallel import tiling


def make_tile_mesh(devices=None, axis: str = "tiles") -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


# Which engine ran the last sharded encode/decode: the encode is always the
# row-packed XLA pipeline; the decode engine is resolved like the
# single-device one (tiling.resolve_decode_engine).
LAST_ENGINE = {"encode": None, "decode": None}


def sharded_decode_bufs(
    cols, prior_rep, mesh: Mesh, axis: str, th: int, tw: int, c: int,
    cfg: CodingConfig, nb: int, wd: int, engine: str,
):
    """Shard-mapped tile decode over per-tile word rows (each device holds
    and decodes only its own tiles' slice of the payload); the single
    implementation behind the sharded and multihost decode paths.
    cols: (Lp, wd) uint32 sharded over ``axis``; prior_rep: (C, nb, K)
    replicated. Returns (bufs (Lp, C, T) sharded, engine used)."""
    engine = tiling.resolve_decode_engine(engine)
    f = _decode_smfn(mesh, axis, th, tw, c, cfg, nb, wd, engine)
    return f(cols, prior_rep), engine


@functools.lru_cache(maxsize=128)
def _decode_smfn(
    mesh: Mesh, axis: str, th: int, tw: int, c: int, cfg: CodingConfig,
    nb: int, wd: int, engine: str,
):
    """Cached jitted shard_map callable for the sharded decode. Rebuilding
    the shard_map closure per invocation re-traces and re-compiles every
    call; caching on the static configuration keeps ordinary jit
    executable reuse."""
    decode = tiling._decode_engine_fn(engine)

    def local(cols_l, prior_l):
        L = cols_l.shape[0]
        words = cols_l.reshape(-1)
        starts = jnp.arange(L, dtype=jnp.int32) * (wd * 32)
        return decode(words, starts, th, tw, c, cfg, nb, prior_l[None])

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None), P()),
            out_specs=P(axis, None, None),
            check_vma=False,
        )
    )


@partial(
    jax.jit,
    static_argnames=("th", "tw", "cfg", "nb", "b_pad"),
)
def fused_encode_step(
    tiles: jnp.ndarray,
    th: int,
    tw: int,
    cfg: CodingConfig,
    nb: int,
    b_pad: int,
    prior: Optional[jnp.ndarray] = None,
):
    """Full FLCT encode as one XLA program: tiles (n_tiles, C, T) int32 →
    (packed bytes uint8[b_pad//8], per-tile byte lengths, total bytes).

    ``prior``: (C, nb, K) int32 per-image k-table seed, or (n_tiles, C,
    nb, K) per-tile (multi-image corpus), or None = zeros (the v0
    stream). ``b_pad`` bounds total payload bits (caller must guarantee
    it — the dynamic path in tiling.py sizes it exactly).
    """
    nt, c, _t = tiles.shape
    if prior is None:
        prior = jnp.zeros((c, nb, cfg.num_k), jnp.int32)
    prior_nt = (
        prior
        if prior.ndim == 4
        else jnp.broadcast_to(prior[None], (nt, c, nb, cfg.num_k))
    )
    (context, low, oor, residual, in_range, above, qctx) = (
        tiling._tiled_stage1(tiles, th, tw, nb)
    )
    flat, offsets, tile_bytes, total_bytes = tiling._tiled_stage2(
        tiles, context, low, oor, residual, in_range, above, qctx, prior_nt,
        th, tw, cfg, nb,
    )
    packed = bitpack.pack_bits_scatter(flat, offsets, b_pad)
    return packed, tile_bytes, total_bytes


def _worst_tile_bits(c: int, t: int, cfg: CodingConfig) -> int:
    """TRUE per-tile worst-case stream bits: per pixel ≤ 2 marker +
    max(phase-in, k_max tail) bits plus the worst Rice quotient, bounded by
    noting the adaptive estimator always has k_max available, whose
    quotient is ≤ residual >> k_max < 2^(depth - k_max + 1)."""
    k_max = cfg.k_values[-1]
    depth = cfg.depth_bits
    worst_pixel = 2 + max(
        cfg.max_phase_in_bits, (1 << (depth + 1 - k_max)) + 1 + k_max
    )
    return c * (64 + (t - 2) * worst_pixel) + 7


def worst_case_payload_bits(n_tiles: int, c: int, t: int, cfg: CodingConfig) -> int:
    """Loose but safe payload bound for fused (no-host-sync) encoding."""
    return ((n_tiles * _worst_tile_bits(c, t, cfg) + 255) // 256) * 256


def xla_row_width(cfg: CodingConfig, t: int, c: int) -> int:
    """Per-tile row width (uint32 words) for the shard-mapped XLA encode.
    This is the true worst-case bound: the row-packed XLA engine never
    overflows and needs no retry round trip."""
    return -(-_worst_tile_bits(c, t, cfg) // 32)


def _shardmap_encode_xla(
    tiles_dev, prior, mesh: Mesh, axis: str, th: int, tw: int, c: int,
    cfg: CodingConfig, nb: int,
):
    """Per-shard XLA encode to per-tile word ROWS, COLLECTIVE-FREE (the
    dry run and tests assert this from compiled HLO): each device runs the
    dense stage1/stage2 pipeline on its local tile slice and packs every
    tile into its own fixed-width row (row-local offsets, no cross-tile
    cumsum). The monolithic ``fused_encode_step`` under GSPMD instead
    compiles its global payload scatter to all-reduces over the whole
    payload buffer; rows avoid that by construction.

    tiles_dev: (Lp, C, T) sharded over ``axis``; prior: (C, nb, K)
    replicated OR (Lp, C, nb, K) sharded. Returns (words (Lp, W) uint32
    big-endian rows sharded, tile_bytes (Lp,) int32 sharded)."""
    f = _encode_xla_smfn(mesh, axis, th, tw, c, cfg, nb, prior.ndim)
    return f(tiles_dev, prior)


@functools.lru_cache(maxsize=128)
def _encode_xla_smfn(
    mesh: Mesh, axis: str, th: int, tw: int, c: int, cfg: CodingConfig,
    nb: int, prior_ndim: int,
):
    """Cached jitted shard_map callable for the row-packed XLA encode (see
    _decode_smfn for why)."""
    t = th * tw
    W = xla_row_width(cfg, t, c)
    prior_spec = P() if prior_ndim == 3 else P(axis, None, None, None)

    def local(tiles_l, prior_l):
        L = tiles_l.shape[0]
        pr = (
            prior_l
            if prior_l.ndim == 4
            else jnp.broadcast_to(prior_l[None], (L, c, nb, cfg.num_k))
        )
        st1 = tiling._tiled_stage1(tiles_l, th, tw, nb)
        flat, offsets, tile_bytes, _tot = tiling._tiled_stage2(
            tiles_l, *st1, pr, th, tw, cfg, nb, row_words=W
        )
        words = bitpack.pack_bits_scatter(
            flat, offsets, L * W * 32, as_words=True
        )
        return words.reshape(L, W), tile_bytes

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None, None), prior_spec),
            out_specs=(P(axis, None), P(axis)),
            check_vma=False,
        )
    )


def encode_tiled_sharded(
    image: np.ndarray,
    mesh: Mesh,
    tile: Optional[TileConfig] = None,
    axis: str = "tiles",
) -> bytes:
    """FLCT encode with the tile axis sharded over ``mesh``.

    Pads the tile count to a multiple of the mesh size (empty padding tiles
    are dropped from the container). Each device runs the row-packed XLA
    encode on its own tiles (``_shardmap_encode_xla``); the output is
    byte-identical to the single-device tiling.compress_tiled_bytes for
    the same tile geometry.
    """
    from felics_tpu.api import header_for_array

    base = header_for_array(image)
    tile = tile or TileConfig()
    h, w = base.height, base.width
    if h == 0 or w == 0:
        return tiling.compress_tiled_bytes(image, tile)
    th, tw = tiling._clamped_tile_dims(h, w, tile)
    cfg = tiled_config_for_depth(base.pixel_depth)
    nb = num_buckets(cfg)

    tiles_np, _ty, _tx = tiling._prepare_tiles(image, base.color_type, th, tw)
    n_tiles, c, _t = tiles_np.shape
    k0 = tiling.compute_k0(tiles_np, th, tw, cfg, nb)
    prior_np = tiling.prior_from_k0(k0, cfg, c)
    pad_tiles = (-n_tiles) % mesh.devices.size
    tiles_np = np.concatenate(
        [tiles_np, np.zeros((pad_tiles,) + tiles_np.shape[1:], np.int32)]
    ).astype(tiling.narrow_tile_dtype(cfg.depth_bits, c))

    # Straight from host memory to each device's shard (no staging copy on
    # the first device).
    tiles = jax.device_put(tiles_np, NamedSharding(mesh, P(axis, None, None)))
    prior_rep = jax.device_put(prior_np, NamedSharding(mesh, P()))
    words, tile_bytes = _shardmap_encode_xla(
        tiles, prior_rep, mesh, axis, th, tw, c, cfg, nb
    )
    words_np, tile_bytes_np = jax.device_get((words, tile_bytes))
    tile_bytes_np = np.asarray(tile_bytes_np, dtype=np.int64)[:n_tiles]
    payload = tiling._columns_to_payload(
        np.asarray(words_np)[:n_tiles], tile_bytes_np
    )
    LAST_ENGINE["encode"] = "xla"
    return tiling.pack_tiled_container(
        base.color_type, base.pixel_depth, w, h, tw, th, n_tiles,
        tile_bytes_np, payload, k0,
    )


def decode_tiled_sharded(
    data: bytes, mesh: Mesh, axis: str = "tiles", engine: str = "auto"
) -> np.ndarray:
    """FLCT decode with tiles sharded over ``mesh``.

    The payload is split into per-tile word rows and SHARDED over the tile
    axis — each device holds and decodes only its own tiles' slice of the
    bitstream. ``engine`` as in tiling.resolve_decode_engine;
    ``LAST_ENGINE["decode"]`` records the engine that ran.
    """
    from felics_tpu import errors

    header = tiling.read_tiled_header(data)
    if header.n_tiles == 0:
        return tiling.decompress_tiled_bytes(data)

    cfg = tiled_config_for_depth(header.pixel_depth)
    nb = num_buckets(cfg)
    h, w = header.height, header.width
    th, tw = header.tile_h, header.tile_w
    ty, tx = -(-h // th), -(-w // tw)
    c = header.num_channels
    prior_np = tiling.prior_from_k0(header.k0, cfg, c)
    lens = np.asarray(header.tile_lengths, np.int64)
    expected = int(lens.sum())
    payload = data[header.payload_off :]
    if len(payload) < expected:
        raise errors.IoError("truncated FLCT payload")

    # Per-tile word rows (the sharding unit). Padding lanes replicate tile
    # 0 — a valid stream, so every engine terminates — and are dropped.
    wd = tiling.bucket_words(int(-(-lens.max(initial=1) // 4)))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    rows = tiling._payload_to_columns(payload[:expected], starts, lens, wd)
    pad_tiles = (-header.n_tiles) % mesh.devices.size
    if pad_tiles:
        rows = np.concatenate([rows, np.repeat(rows[:1], pad_tiles, axis=0)])

    cols = jax.device_put(rows, NamedSharding(mesh, P(axis, None)))
    prior_rep = jax.device_put(prior_np, NamedSharding(mesh, P()))

    bufs, LAST_ENGINE["decode"] = sharded_decode_bufs(
        cols, prior_rep, mesh, axis, th, tw, c, cfg, nb, wd, engine
    )
    if pad_tiles:
        bufs = bufs[: header.n_tiles]
    depth_max = 255 if int(header.pixel_depth) == 0 else 65535
    out, valid = tiling._assemble_image(
        bufs, th, tw, c, ty, tx, h, w, depth_max
    )
    out_np, valid_np = jax.device_get((out, valid))
    if not bool(valid_np):
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
    return np.asarray(out_np)
