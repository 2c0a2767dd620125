"""Tiled-parallel (FLCT) mode and device-mesh sharding.

No reference counterpart: the reference is strictly single-threaded
(SURVEY.md §2, parallelism inventory). FLCT is the device-parallel scaling
story: images are partitioned into independently-coded tiles (each restarts
the raw preamble and the k statistics), so encode is one batched XLA program
over all tiles and decode — inherently bit-serial within a tile — walks
every tile at once (one GPU thread per tile in ops.pallas_decode, or a
vmapped ``lax.scan``), and the tile axis shards across a
``jax.sharding.Mesh`` for multi-device/multi-host runs.
"""

from felics_tpu.parallel.tiling import (
    compress_tiled_bytes,
    decompress_tiled_bytes,
    read_tiled_header,
    TiledHeader,
)
from felics_tpu.parallel.batch import (
    compress_tiled_batch,
    compress_tiled_stream,
    decompress_tiled_batch,
    decompress_tiled_stream,
)

__all__ = [
    "compress_tiled_bytes",
    "decompress_tiled_bytes",
    "read_tiled_header",
    "TiledHeader",
    "compress_tiled_batch",
    "decompress_tiled_batch",
    "compress_tiled_stream",
    "decompress_tiled_stream",
]
