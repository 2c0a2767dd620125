"""Multi-host (multi-process) FLCT encoding over a global device mesh.

The reference is a single-threaded, single-process program (SURVEY §2:
"Parallelism / distributed inventory: none"); this module is the from-scratch
distributed tier (SURVEY §7 step 7): ``jax.distributed`` process groups, a
global 1-D tile mesh spanning every process's devices, and shard-mapped
per-device encode running SPMD over it. The row-packed XLA encode
(mesh._shardmap_encode_xla) emits per-tile word rows with ZERO device
collectives — the tests assert this from compiled HLO; the only cross-host
exchange is the result allgather plus the host-side offsets assembly from
per-tile lengths (4·n_tiles bytes) — no hand-written NCCL/MPI analog.

Design constraints honored here:

  * the encode graph is ALL-STATIC (fixed per-tile row width) — no host
    round-trip inside the step, so no per-process divergence and no
    cross-host sync beyond the result gather;
  * every process feeds the same host image (replicated input; the k-prior
    is a deterministic host computation, so the header is identical on all
    processes) and assembles the identical container — byte-equal to the
    single-process ``tiling.compress_tiled_bytes`` output, which the
    multi-process test pins;
  * result gathering uses ``multihost_utils.process_allgather`` (the
    documented way to materialize a global array on every host).

Run ``init_process()`` once per process before any JAX compute, then
``encode_tiled_multihost``. On GPUs, give each process exactly one card
(``local_device_ids``): a JAX process reserves most of a card's memory when
it first uses it, so a second process on the same card fails.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from felics_tpu.config import TileConfig, tiled_config_for_depth
from felics_tpu.ops.kscan_tiled import num_buckets
from felics_tpu.parallel import tiling


def init_process(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids=None,
) -> None:
    """Join the ``jax.distributed`` process group (idempotent per process).

    coordinator_address: "host:port" of process 0's coordination service.
    Must run before the first JAX computation in the process.
    """
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_tile_mesh(axis: str = "tiles"):
    """1-D mesh over every device of every process in the group."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def _gather_rows(words, tile_bytes, n_tiles: int):
    """Allgather the row-packed encode results to every process; returns
    (per-tile byte lengths int64, concatenated payload)."""
    from jax.experimental import multihost_utils

    words_np, tile_bytes_np = multihost_utils.process_allgather(
        (words, tile_bytes), tiled=True
    )
    lengths = np.asarray(tile_bytes_np).astype(np.int64)[:n_tiles]
    return lengths, tiling._columns_to_payload(
        np.asarray(words_np)[:n_tiles], lengths
    )


def encode_tiled_multihost(
    image: np.ndarray,
    tile: Optional[TileConfig] = None,
    mesh=None,
    axis: str = "tiles",
) -> bytes:
    """FLCT encode with tiles sharded over a multi-process global mesh.

    Every process passes the same ``image`` and receives the same container
    bytes — byte-identical to single-process tiling.compress_tiled_bytes.
    ``mesh_mod.LAST_ENGINE["encode"]`` records the engine that ran.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from felics_tpu.api import header_for_array
    from felics_tpu.parallel import mesh as mesh_mod

    base = header_for_array(image)
    tile = tile or TileConfig()
    h, w = base.height, base.width
    if h == 0 or w == 0:
        return tiling.compress_tiled_bytes(image, tile)
    if mesh is None:
        mesh = global_tile_mesh(axis)
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

    sharding = NamedSharding(mesh, P(axis, None, None))
    # Each process contributes its addressable shards of the (replicated
    # host-side) tile array — the supported construction for global arrays.
    tiles = jax.make_array_from_callback(
        tiles_np.shape, sharding, lambda idx: tiles_np[idx]
    )
    prior_rep = jax.make_array_from_callback(
        prior_np.shape,
        NamedSharding(mesh, P()),
        lambda idx: prior_np[idx],
    )
    words, tile_bytes = mesh_mod._shardmap_encode_xla(
        tiles, prior_rep, mesh, axis, th, tw, c, cfg, nb
    )
    tile_bytes_np, payload = _gather_rows(words, tile_bytes, n_tiles)
    mesh_mod.LAST_ENGINE["encode"] = "xla"
    return tiling.pack_tiled_container(
        base.color_type, base.pixel_depth, w, h, tw, th, n_tiles,
        tile_bytes_np, payload, k0,
    )


def encode_corpus_multihost(
    images,
    tile: Optional[TileConfig] = None,
    mesh=None,
    axis: str = "tiles",
):
    """FLCT-encode a CORPUS (list of images) with every image's tiles
    concatenated into one global batch sharded over the multi-process mesh
    (an archive re-encode of a large corpus). Every
    process passes the same list and receives the same per-image
    containers, byte-identical to the single-process batch API. Per-image
    k0 priors ride the tile axis (sharded), so the only cross-device
    traffic remains the per-tile length bookkeeping."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from felics_tpu.parallel import mesh as mesh_mod
    from felics_tpu.parallel.batch import (
        _pack_batch_containers,
        _prep_encode_batch,
    )
    images = list(images)
    if not images:
        return []
    tile = tile or TileConfig()
    prep = _prep_encode_batch(images, tile)
    if prep is None:  # mixed clamping: per-image multihost encode
        return [
            encode_tiled_multihost(im, tile, mesh, axis)
            for im in images
        ]
    if mesh is None:
        mesh = global_tile_mesh(axis)
    th, tw, cfg, nb, c = (
        prep["th"], prep["tw"], prep["cfg"], prep["nb"], prep["c"]
    )
    tiles_np, tile_group, counts = (
        prep["tiles_np"], prep["tile_group"], prep["counts"]
    )
    n_tiles = tiles_np.shape[0]
    # k0 per image: deterministic host pass -> identical on every process.
    k0s = tiling.compute_k0_batch(tiles_np, counts, th, tw, cfg, nb)
    priors_img = tiling.prior_from_k0(k0s, cfg, c)  # (n_imgs, C, nb, K)
    prior_tiles = priors_img[tile_group]  # (nt, C, nb, K)

    n_dev = mesh.devices.size
    pad_tiles = (-n_tiles) % n_dev
    if pad_tiles:
        tiles_np = np.concatenate(
            [tiles_np, np.zeros((pad_tiles,) + tiles_np.shape[1:], np.int32)]
        )
        prior_tiles = np.concatenate(
            [prior_tiles, np.zeros((pad_tiles,) + prior_tiles.shape[1:],
                                   np.int32)]
        )
    tiles_np = tiles_np.astype(tiling.narrow_tile_dtype(cfg.depth_bits, c))

    tiles = jax.make_array_from_callback(
        tiles_np.shape,
        NamedSharding(mesh, P(axis, None, None)),
        lambda idx: tiles_np[idx],
    )
    prior = jax.make_array_from_callback(
        prior_tiles.shape,
        NamedSharding(mesh, P(axis, None, None, None)),
        lambda idx: prior_tiles[idx],
    )

    # Row-packed XLA encode with the per-tile priors riding the sharded
    # tile axis (collective-free; see mesh._shardmap_encode_xla).
    words, tile_bytes = mesh_mod._shardmap_encode_xla(
        tiles, prior, mesh, axis, th, tw, c, cfg, nb
    )
    lengths, payload = _gather_rows(words, tile_bytes, n_tiles)
    mesh_mod.LAST_ENGINE["encode"] = "xla"
    return _pack_batch_containers(prep, lengths, payload, k0s)


def decode_tiled_multihost(
    data: bytes,
    mesh=None,
    axis: str = "tiles",
    engine: str = "auto",
) -> np.ndarray:
    """FLCT decode with tile streams sharded over a multi-process global
    mesh (the mirror of the multihost encode). Every process passes the same container bytes; the per-tile
    word rows are sharded so each process scans only its own slice, and the
    decoded planes are allgathered to every host. Returns the image
    (identical on every process)."""
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from felics_tpu import errors
    from felics_tpu.format import PixelDepth
    from felics_tpu.parallel import mesh as mesh_mod

    header = tiling.read_tiled_header(data)
    if header.n_tiles == 0:
        return tiling.decompress_tiled_bytes(data)
    if mesh is None:
        mesh = global_tile_mesh(axis)

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

    wd = tiling.bucket_words(int(-(-lens.max(initial=1) // 4)))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    rows = tiling._payload_to_columns(payload[:expected], starts, lens, wd)
    n_dev = mesh.devices.size
    pad_tiles = (-header.n_tiles) % n_dev
    if pad_tiles:
        rows = np.concatenate([rows, np.repeat(rows[:1], pad_tiles, axis=0)])

    cols = jax.make_array_from_callback(
        rows.shape, NamedSharding(mesh, P(axis, None)), lambda idx: rows[idx]
    )
    prior_rep = jax.make_array_from_callback(
        prior_np.shape, NamedSharding(mesh, P()), lambda idx: prior_np[idx]
    )

    # Every process resolves the same engine: the choice depends only on
    # the platform, which the group shares.
    bufs, mesh_mod.LAST_ENGINE["decode"] = mesh_mod.sharded_decode_bufs(
        cols, prior_rep, mesh, axis, th, tw, c, cfg, nb, wd, engine
    )

    bufs_np = np.asarray(
        multihost_utils.process_allgather(bufs, tiled=True)
    )[: header.n_tiles]
    depth_max = 255 if header.pixel_depth == PixelDepth.EIGHT else 65535
    return tiling.assemble_image_np(
        bufs_np, th, tw, c, ty, tx, h, w, depth_max
    )
