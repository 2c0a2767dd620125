"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from felics_tpu.config import TileConfig
from felics_tpu.parallel import tiling
from felics_tpu.parallel.mesh import (
    decode_tiled_sharded,
    encode_tiled_sharded,
    fused_encode_step,
    make_tile_mesh,
    worst_case_payload_bits,
)

TILE16 = TileConfig(tile_h=16, tile_w=16)


def smooth_image(rng, width, height, dtype=np.uint8, channels=None):
    shape = (height, width) if channels is None else (height, width, channels)
    steps = rng.integers(-6, 7, size=shape)
    img = np.cumsum(np.cumsum(steps, axis=0), axis=1) + 128
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


def test_eight_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_encode_matches_single_device(rng):
    img = smooth_image(rng, 64, 32)  # 8 tiles of 16x16
    mesh = make_tile_mesh()
    sharded = encode_tiled_sharded(img, mesh, TILE16)
    single = tiling.compress_tiled_bytes(img, TILE16)
    assert sharded == single


def test_sharded_encode_with_tile_padding(rng):
    img = smooth_image(rng, 48, 32)  # 6 tiles -> padded to 8 for the mesh
    mesh = make_tile_mesh()
    sharded = encode_tiled_sharded(img, mesh, TILE16)
    single = tiling.compress_tiled_bytes(img, TILE16)
    assert sharded == single


def test_sharded_decode_matches(rng):
    img = smooth_image(rng, 64, 32, channels=3)
    data = tiling.compress_tiled_bytes(img, TILE16)
    mesh = make_tile_mesh()
    out = decode_tiled_sharded(data, mesh)
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_sharded_engines_byte_identical(rng, engine):
    # Both decode engines shard. Encode (row-packed XLA) and decode are
    # byte/pixel-identical to the single-device path on the 8-device mesh
    # (pallas = the GPU kernel, in interpret mode on CPU).
    from felics_tpu.parallel.mesh import LAST_ENGINE

    img = smooth_image(rng, 96, 64)  # 24 tiles -> 3 per device
    mesh = make_tile_mesh()
    single = tiling.compress_tiled_bytes(img, TILE16)
    data = encode_tiled_sharded(img, mesh, TILE16)
    assert data == single
    assert LAST_ENGINE["encode"] == "xla"
    out = decode_tiled_sharded(data, mesh, engine=engine)
    np.testing.assert_array_equal(out, img)
    assert LAST_ENGINE["decode"] == engine


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_sharded_engines_rgb16(rng, engine):
    img = smooth_image(rng, 48, 32, np.uint16, 3)
    mesh = make_tile_mesh()
    single = tiling.compress_tiled_bytes(img, TILE16)
    data = encode_tiled_sharded(img, mesh, TILE16)
    assert data == single
    out = decode_tiled_sharded(data, mesh, engine=engine)
    np.testing.assert_array_equal(out, img)


def test_sharded_decode_rows_are_sharded(rng):
    # The decode payload must be split per-tile and sharded, not
    # replicated: every device's addressable shard of the row
    # matrix covers only its slice of the tile axis.
    img = smooth_image(rng, 64, 64)  # 16 tiles over 8 devices
    data = tiling.compress_tiled_bytes(img, TILE16)
    mesh = make_tile_mesh()
    out = decode_tiled_sharded(data, mesh)
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_corpus_encode_sharded_matches_batch(rng, engine):
    # A corpus (many images) encoded with every tile sharded over the mesh,
    # per-image k0 priors riding the tile axis. Single-process here (the
    # 2-process variant runs in the multihost worker); bytes must equal the
    # serving batch API exactly, and decode with either engine.
    from felics_tpu.parallel.batch import (
        compress_tiled_batch,
        decompress_tiled_batch,
    )
    from felics_tpu.parallel.multihost import encode_corpus_multihost

    images = [
        smooth_image(rng, 64, 48),
        smooth_image(rng, 48, 64),
        smooth_image(rng, 32, 32),
    ]
    ref = compress_tiled_batch(images, TILE16)
    mesh = make_tile_mesh()
    got = encode_corpus_multihost(images, TILE16, mesh=mesh)
    assert got == ref
    for im, out in zip(images, decompress_tiled_batch(got, engine)):
        np.testing.assert_array_equal(out, im)


def test_fused_encode_step_matches_dynamic(rng):
    from felics_tpu.config import tiled_config_for_depth
    from felics_tpu.format import ColorType, PixelDepth
    from felics_tpu.ops.kscan_tiled import num_buckets

    img = smooth_image(rng, 32, 32)
    th = tw = 16
    tiles, ty, tx = tiling._prepare_tiles(img, ColorType.GRAY, th, tw)
    cfg = tiled_config_for_depth(PixelDepth.EIGHT)
    nb = num_buckets(cfg)
    n_tiles, c, t = tiles.shape
    # The default container is v2 (k-prior seeded): feed the fused step the
    # same per-image prior so its payload matches byte-for-byte.
    k0 = tiling.compute_k0(tiles, th, tw, cfg, nb)
    prior = jax.numpy.asarray(tiling.prior_from_k0(k0, cfg, c))
    b_pad = worst_case_payload_bits(n_tiles, c, t, cfg)
    packed, tile_bytes, total = fused_encode_step(
        jax.numpy.asarray(tiles), th, tw, cfg, nb, b_pad, prior
    )
    reference = tiling.compress_tiled_bytes(img, TILE16)
    hdr = tiling.read_tiled_header(reference)
    np.testing.assert_array_equal(np.asarray(tile_bytes), hdr.tile_lengths)
    payload_ref = reference[hdr.payload_off :]
    got = np.asarray(packed[: int(total)]).tobytes()
    assert got == payload_ref


def test_shardmap_engines_compile_collective_free(rng):
    """The sharded encode (row-packed XLA pipeline) and the sharded decode
    with either engine must compile to ZERO device collectives — tiles are
    independent, and the container's offsets assemble on the host from the
    gathered per-tile lengths. The monolithic fused_encode_step under GSPMD
    instead all-reduces the whole payload buffer."""
    import re

    from jax.sharding import NamedSharding, PartitionSpec as P

    from felics_tpu.config import tiled_config_for_depth
    from felics_tpu.format import ColorType, PixelDepth
    from felics_tpu.ops.kscan_tiled import num_buckets
    from felics_tpu.parallel import mesh as mesh_mod

    mesh = make_tile_mesh()
    n_dev = mesh.devices.size
    th = tw = 16
    cfg = tiled_config_for_depth(PixelDepth.EIGHT)
    nb = num_buckets(cfg)
    nt = 8 * n_dev
    img = smooth_image(rng, tw * 4, th * (nt // 4))

    tiles, _, _ = tiling._prepare_tiles(img, ColorType.GRAY, th, tw)
    tl = jax.device_put(tiles, NamedSharding(mesh, P("tiles", None, None)))
    prior = jax.device_put(
        np.zeros((1, nb, cfg.num_k), np.int32), NamedSharding(mesh, P())
    )

    def collectives(txt):
        return re.findall(
            r"\b(all-reduce|all-gather|reduce-scatter|collective-permute"
            r"|all-to-all)\(",
            txt,
        )

    xla_fn = jax.jit(
        lambda td, pr: mesh_mod._shardmap_encode_xla(
            td, pr, mesh, "tiles", th, tw, 1, cfg, nb
        )
    )
    assert collectives(xla_fn.lower(tl, prior).compile().as_text()) == []

    wd = 64
    cols = jax.device_put(
        np.zeros((nt, wd), np.uint32), NamedSharding(mesh, P("tiles", None))
    )
    for engine in ("xla", "pallas"):
        dec = mesh_mod._decode_smfn(
            mesh, "tiles", th, tw, 1, cfg, nb, wd, engine
        )
        txt = dec.lower(cols, prior).compile().as_text()
        assert collectives(txt) == [], engine


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_xla_row_width_bounds_worst_case_streams(rng, dtype):
    """The row-packed XLA engine writes each tile into a fixed
    xla_row_width row with NO overflow detection — the bound must hold for ANY input or streams would silently
    truncate. Adversarial check: pure-noise (incompressible) and
    alternating-extremes tiles must fit, and the sharded bytes must equal
    the unsharded encoder's."""
    from felics_tpu.config import tiled_config_for_depth
    from felics_tpu.format import PixelDepth
    from felics_tpu.parallel.mesh import (
        decode_tiled_sharded,
        encode_tiled_sharded,
        xla_row_width,
    )

    hi = np.iinfo(dtype).max
    pd = PixelDepth.EIGHT if dtype == np.uint8 else PixelDepth.SIXTEEN
    cfg = tiled_config_for_depth(pd)
    mesh = make_tile_mesh()
    th = tw = 16
    # Worst-case content: uniform noise over the full range, and a
    # checkerboard of extremes (maximal contexts + maximal residuals).
    noise = rng.integers(0, hi + 1, (32, 64)).astype(dtype)
    checker = np.zeros((32, 64), dtype)
    checker[::2, 1::2] = hi
    checker[1::2, ::2] = hi
    for img in (noise, checker):
        data = encode_tiled_sharded(img, mesh, TILE16)
        assert data == tiling.compress_tiled_bytes(img, TILE16)
        hdr = tiling.read_tiled_header(data)
        w_bound = xla_row_width(cfg, th * tw, 1) * 4
        assert int(hdr.tile_lengths.max()) <= w_bound
        out = decode_tiled_sharded(data, mesh, engine="xla")
        np.testing.assert_array_equal(out, img)
