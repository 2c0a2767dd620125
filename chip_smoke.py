#!/usr/bin/env python
"""Smoke test of the FLCT main path on NVIDIA GPUs, at the image sizes users
of a lossless codec have, through the entry points a user calls.

    python chip_smoke.py [--seed N]            # one card: every phase below
    python chip_smoke.py --cards 4 [--seed N]  # four cards: the sharded path only

Exits non-zero, printing no result, when JAX finds no GPU or when any phase
fails. Earlier lines carry the card's name and power limit and, per phase,
shapes, bytes, ratio and times; the last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

One-card phases (pixels generated from --seed, felics_tpu.io.synth):

  gray8   16 x 2048x2048, tiles 64 and 32 — batch API
  rgb8    4 x 4000x3000 (12 MP camera frames) — batch API
  gray16  1 x 10980x10980 (a Sentinel-2 L1C band) — one-image API
  stream  the gray8 batch in chunks of 4 — pipelined stream API
  flcs    2 x 768x512 gray8 (Kodak size), batched FLCS through jax; the
          decode, a per-pixel scan, runs on 256x256 crops
  decode  the Pallas kernel vs the XLA decode vs the native decoder, on the
          containers above
  stages  the XLA encode's stages, timed one by one
  parity  the cases of tests/_gpu_parity_worker.py

Every round trip is exact, every FLCT container equals the native C++
codec's at the same tile size, and the path and engine each direction took
is the one expected. Timings are warm (each shape runs once first), best of
two, on the host clock around calls that return host data or end in
``jax.block_until_ready``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Phase shapes (a rehearsal on the CPU shrinks them).
GRAY8 = (16, (2048, 2048))  # (images, shape)
RGB8 = (4, (3000, 4000, 3))
BAND = (10980, 10980)
KODAK = (512, 768)
CROP = 256

# The decode engine engine="auto" runs on the GPU: the Pallas kernel, which
# measured faster end to end than the XLA scan in every class (PERF.md).
GPU_DECODE = "pallas"


def _timed(f, passes=2):
    """(result, best seconds) of ``passes`` warm calls; one call first
    compiles every shape."""
    import jax

    out = jax.block_until_ready(f())
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f())
        best = min(best, time.perf_counter() - t0)
    return out, best


def _mpx(images):
    return sum(im.shape[0] * im.shape[1] for im in images) / 1e6


class Smoke:
    def __init__(self, card: str, seed: int):
        self.card = card
        self.seed = seed
        self.containers = {}  # class -> (images, blobs)

    def say(self, msg: str):
        print(f"[{self.card}] {msg}", flush=True)

    def native_bytes(self, images, tile):
        from felics_tpu.api import header_for_array
        from felics_tpu.native import runtime as rt

        return [rt.compress_tiled(im, header_for_array(im), tile, tile)
                for im in images]

    def check_exact(self, images, outs, what):
        assert len(outs) == len(images), what
        for i, (im, out) in enumerate(zip(images, outs)):
            assert out.dtype == im.dtype and np.array_equal(out, im), (
                f"{what}: image {i} does not round-trip exactly"
            )

    def batch_phase(self, name, images, tile):
        from felics_tpu.config import TileConfig
        from felics_tpu.parallel import batch, tiling

        tc = TileConfig(tile, tile)
        blobs, t_enc = _timed(lambda: batch.compress_tiled_batch(images, tc))
        assert batch.LAST_PATH["encode"] == "images", batch.LAST_PATH
        assert tiling.LAST_ENGINE["encode"] == "xla"
        assert blobs == self.native_bytes(images, tile), (
            f"{name}: FLCT bytes differ from the native codec's"
        )
        outs, t_dec = _timed(lambda: batch.decompress_tiled_batch(blobs))
        assert batch.LAST_PATH["decode"] == "images", batch.LAST_PATH
        assert tiling.LAST_ENGINE["decode"] == GPU_DECODE
        self.check_exact(images, outs, name)
        self.report(name, images, tile, blobs, t_enc, t_dec,
                    "batch API, encode xla images path, decode "
                    f"{GPU_DECODE} images path")
        self.containers[f"{name} tile {tile}"] = (images, blobs)
        return blobs

    def report(self, name, images, tile, blobs, t_enc, t_dec, how,
               checked="bytes == native, round trip exact"):
        mpx = _mpx(images)
        raw = sum(im.nbytes for im in images)
        size = sum(map(len, blobs))
        self.say(
            f"{name}: {len(images)} x {images[0].shape} {images[0].dtype} "
            f"tile {tile} ({how}): {raw} -> {size} bytes, ratio "
            f"{raw / size:.4f}; encode {t_enc:.4f} s ({mpx / t_enc:.1f} "
            f"Mpx/s), decode {t_dec:.4f} s ({mpx / t_dec:.1f} Mpx/s); "
            f"{checked}"
        )

    def gray16_phase(self):
        import felics_tpu
        from felics_tpu.io.synth import smooth_images
        from felics_tpu.parallel import tiling

        band = smooth_images(self.seed + 2, 1, BAND, np.uint16)[0]
        blob, t_enc = _timed(
            lambda: felics_tpu.compress_image_bytes(band, container="flct")
        )
        assert tiling.LAST_ENGINE["encode"] == "xla"
        assert blob == self.native_bytes([band], 64)[0], (
            "gray16: FLCT bytes differ from the native codec's"
        )
        out, t_dec = _timed(lambda: felics_tpu.decompress_image_bytes(blob))
        assert tiling.LAST_ENGINE["decode"] == GPU_DECODE
        self.check_exact([band], [out], "gray16")
        self.report("gray16", [band], 64, [blob], t_enc, t_dec,
                    f"one-image API, encode xla, decode {GPU_DECODE}")
        self.containers["gray16 tile 64"] = ([band], [blob])

    def stream_phase(self, images, blobs_ref):
        from felics_tpu.config import TileConfig
        from felics_tpu.parallel import batch, tiling

        chunks = [images[i : i + 4] for i in range(0, len(images), 4)]
        tc = TileConfig()
        blobs, t_enc = _timed(lambda: batch.compress_tiled_stream(chunks, tc))
        assert batch.LAST_PATH["encode"] == "images", batch.LAST_PATH
        flat = [b for chunk in blobs for b in chunk]
        assert flat == blobs_ref, "stream bytes differ from the batch API's"
        outs, t_dec = _timed(lambda: batch.decompress_tiled_stream(blobs))
        assert batch.LAST_PATH["decode"] == "images", batch.LAST_PATH
        assert tiling.LAST_ENGINE["decode"] == GPU_DECODE
        self.check_exact(images, [o for c in outs for o in c], "stream")
        self.report("stream", images, 64, flat, t_enc, t_dec,
                    f"{len(chunks)} chunks of 4, depth 2, decode "
                    f"{GPU_DECODE}", "bytes == batch API, round trip exact")

    def flcs_phase(self):
        import felics_tpu
        from felics_tpu.io.synth import smooth_images

        images = smooth_images(self.seed + 5, 2, KODAK, np.uint8)
        blobs, t_enc = _timed(
            lambda: felics_tpu.compress_images_bytes(images, backend="jax")
        )
        native = [felics_tpu.compress_image_bytes(im, backend="native")
                  for im in images]
        assert blobs == native, "FLCS jax bytes differ from the native codec's"
        crops = [im[:CROP, :CROP].copy() for im in images]
        cblobs = felics_tpu.compress_images_bytes(crops, backend="jax")
        outs, t_dec = _timed(
            lambda: felics_tpu.decompress_images_bytes(cblobs, backend="jax"),
            passes=1,
        )
        self.check_exact(crops, outs, "flcs")
        self.say(
            f"flcs: encode 2 x {KODAK} uint8 through jax {t_enc:.4f} s "
            f"({_mpx(images) / t_enc:.1f} Mpx/s), "
            f"{sum(map(len, blobs))} bytes == native FLCS; decode 2 x "
            f"{(CROP, CROP)} crops (per-pixel scan) {t_dec:.4f} s "
            f"({_mpx(crops) / t_dec:.3f} Mpx/s), exact"
        )

    def decode_phase(self):
        import jax.numpy as jnp

        from felics_tpu.native import runtime as rt
        from felics_tpu.ops import pallas_decode
        from felics_tpu.ops.kscan_tiled import num_buckets
        from felics_tpu.parallel import batch, tiling

        for key, (images, blobs) in self.containers.items():
            mpx = _mpx(images)
            e2e = {}
            for engine in ("pallas", "xla"):
                outs, e2e[engine] = _timed(
                    lambda: batch.decompress_tiled_batch(blobs, engine),
                    passes=1,
                )
                assert tiling.LAST_ENGINE["decode"] == engine
                self.check_exact(images, outs, f"{key} {engine}")
            t0 = time.perf_counter()
            outs = [rt.decompress_tiled(b) for b in blobs]
            t_native = time.perf_counter() - t0
            self.check_exact(images, outs, f"{key} native")

            prep = batch._prep_decode_batch(blobs)
            words, starts = tiling._payload_words(prep["payload"], prep["lens"])
            cfg = prep["cfg"]
            args = (jnp.asarray(words), jnp.asarray(starts), prep["th"],
                    prep["tw"], prep["c"], cfg, num_buckets(cfg),
                    jnp.asarray(prep["priors"]),
                    jnp.asarray(prep["tile_group"], jnp.int32))
            k_planes, t_kernel = _timed(
                lambda: pallas_decode.decode_tiles(*args)
            )
            x_planes, t_xla = _timed(
                lambda: tiling._decode_tiles(*args), passes=1
            )
            assert np.array_equal(np.asarray(k_planes), np.asarray(x_planes))
            self.say(
                f"decode {key}: end to end pallas {e2e['pallas']:.4f} s "
                f"({mpx / e2e['pallas']:.1f} Mpx/s), xla {e2e['xla']:.4f} s "
                f"({mpx / e2e['xla']:.1f} Mpx/s), native C++ on "
                f"{os.cpu_count()} host threads {t_native:.4f} s "
                f"({mpx / t_native:.1f} Mpx/s); device only: kernel "
                f"{t_kernel * 1e3:.3f} ms ({mpx / t_kernel:.1f} Mpx/s) vs XLA "
                f"scan {t_xla * 1e3:.3f} ms ({mpx / t_xla:.1f} Mpx/s), "
                f"{starts.shape[0]} tiles, lane block "
                f"{pallas_decode.lane_block(starts.shape[0])}; planes equal"
            )
            assert e2e[GPU_DECODE] == min(e2e.values()), (
                f"{key}: {GPU_DECODE} is not the faster decode end to end; "
                "engine='auto' must not pick it"
            )

    def stages_phase(self, images, tile):
        """The XLA encode of a same-shape batch, one stage at a time."""
        from functools import partial

        import jax
        import jax.numpy as jnp

        from felics_tpu.config import tiled_config_for_depth
        from felics_tpu.format import PixelDepth
        from felics_tpu.ops import bitpack
        from felics_tpu.ops.kscan_tiled import num_buckets
        from felics_tpu.parallel import tiling

        depth = (PixelDepth.EIGHT if images[0].dtype == np.uint8
                 else PixelDepth.SIXTEEN)
        cfg = tiled_config_for_depth(depth)
        nb, n = num_buckets(cfg), len(images)
        stacked = np.stack(images)
        times = {}
        dev, times["upload"] = _timed(lambda: jnp.asarray(stacked))
        tile_fn = jax.jit(partial(tiling._image_tiles_device, th=tile,
                                  tw=tile, rgb=stacked.ndim == 4))
        tiles, times["tiling"] = _timed(lambda: tile_fn(dev))
        group = jnp.repeat(jnp.arange(n, dtype=jnp.int32), tiles.shape[0] // n)
        (_k0, prior), times["k0 prior"] = _timed(
            lambda: tiling.compute_k0_prior_jax(
                tiles, group, tile, tile, cfg, nb, n)
        )
        st1, times["stage1 contexts"] = _timed(
            lambda: tiling._tiled_stage1(tiles, tile, tile, nb)
        )
        (flat, offsets, _tb, total), times["stage2 k-scan symbols"] = _timed(
            lambda: tiling._tiled_stage2(
                tiles, *st1, prior, tile, tile, cfg, nb)
        )
        n_big, times["count"] = _timed(lambda: bitpack.count_big_symbols(flat))
        total, n_big = int(total), int(n_big)
        packed, times["pack"] = _timed(
            lambda: bitpack.pack_bits_scatter(
                flat, offsets, bitpack.bucket_bits(total * 8),
                min(tiling._bucket_count(n_big), offsets.shape[0]))
        )
        _, times["fetch"] = _timed(lambda: np.asarray(packed))
        whole = sum(times.values())
        self.say(
            f"encode stages, {n} x {images[0].shape} {images[0].dtype} tile "
            f"{tile}, each timed alone: " + ", ".join(
                f"{k} {v * 1e3:.3f} ms ({v / whole:.0%})"
                for k, v in times.items()
            ) + f"; sum {whole * 1e3:.3f} ms"
        )

    def parity_phase(self):
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "gpu_parity", os.path.join(REPO, "tests", "_gpu_parity_worker.py")
        )
        worker = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(worker)
        n = worker.run_cases(log=self.say)
        self.say(f"gpu parity: {n} cases passed")

    def sharded_phase(self, cards: int):
        """The tile axis sharded over a 1-D mesh of ``cards`` cards, against
        the one-device encoder."""
        import jax

        from felics_tpu.config import TileConfig
        from felics_tpu.io.synth import smooth_images
        from felics_tpu.parallel import mesh as mesh_mod
        from felics_tpu.parallel import tiling
        from felics_tpu.parallel.multihost import encode_corpus_multihost

        devices = jax.devices()[:cards]
        mesh = mesh_mod.make_tile_mesh(devices)
        tc = TileConfig()
        band = smooth_images(self.seed + 2, 1, BAND, np.uint16)[0]
        ref = tiling.compress_tiled_bytes(band, tc)  # one device
        data, t_enc = _timed(lambda: mesh_mod.encode_tiled_sharded(band, mesh))
        assert mesh_mod.LAST_ENGINE["encode"] == "xla"
        assert data == ref, "sharded gray16 bytes differ from one device's"
        out, t_dec = _timed(lambda: mesh_mod.decode_tiled_sharded(data, mesh))
        assert mesh_mod.LAST_ENGINE["decode"] == GPU_DECODE
        self.check_exact([band], [out], "sharded gray16")
        self.report(f"sharded gray16 over {cards} cards", [band], 64, [data],
                    t_enc, t_dec, "encode_tiled_sharded / "
                    "decode_tiled_sharded",
                    "bytes == one-device encoder, round trip exact")

        images = smooth_images(self.seed, GRAY8[0], GRAY8[1], np.uint8)
        refs = [tiling.compress_tiled_bytes(im, tc) for im in images]
        blobs, t_enc = _timed(
            lambda: encode_corpus_multihost(images, tc, mesh=mesh)
        )
        assert mesh_mod.LAST_ENGINE["encode"] == "xla"
        assert blobs == refs, "sharded gray8 bytes differ from one device's"
        outs, t_dec = _timed(
            lambda: [mesh_mod.decode_tiled_sharded(b, mesh) for b in blobs]
        )
        assert mesh_mod.LAST_ENGINE["decode"] == GPU_DECODE
        self.check_exact(images, outs, "sharded gray8")
        self.report(f"sharded gray8 over {cards} cards", images, 64, blobs,
                    t_enc, t_dec, "encode_corpus_multihost over the mesh / "
                    "decode_tiled_sharded per image",
                    "bytes == one-device encoder, round trip exact")
        self.check_cards_worked(devices)

    def check_cards_worked(self, devices):
        """Every card of the mesh held a share of the data: its peak memory
        is far above an idle card's (not all shards on the first card)."""
        peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devices]
        self.say("peak device memory per card: " + ", ".join(
            f"{d.id}: {p / 2**30:.2f} GiB" for d, p in zip(devices, peaks)))
        assert all(p > 2**28 for p in peaks), (
            "a card of the mesh did no work: shards did not land on it"
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: only the sharded path, over four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 1
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX found "
              f"{len(devices)} GPU(s)", file=sys.stderr)
        return 1

    import subprocess

    from felics_tpu.native import runtime as native_runtime
    from felics_tpu.utils import compile_cache, platform

    # The native C++ codec is the independent byte reference.
    subprocess.run(
        [sys.executable, os.path.join(REPO, "native", "build.py")], check=True
    )
    if not native_runtime.available():
        print("chip_smoke: the native core did not load", file=sys.stderr)
        return 1
    compile_cache.enable()
    cards = platform.card_descriptions()
    for line in cards:
        print(line, flush=True)
    smoke = Smoke(cards[0], args.seed)
    smoke.say(f"{len(devices)} x {devices[0].device_kind}; jax "
              f"{jax.__version__}; compile cache {compile_cache.cache_dir()}")
    t_start = time.perf_counter()

    if args.cards == 4:
        smoke.sharded_phase(4)
    else:
        from felics_tpu.io.synth import smooth_images

        gray8 = smooth_images(args.seed, GRAY8[0], GRAY8[1], np.uint8)
        blobs64 = smoke.batch_phase("gray8", gray8, 64)
        smoke.batch_phase("gray8", gray8, 32)
        rgb8 = smooth_images(args.seed + 1, RGB8[0], RGB8[1], np.uint8)
        smoke.batch_phase("rgb8", rgb8, 64)
        smoke.gray16_phase()
        smoke.stream_phase(gray8, blobs64)
        smoke.flcs_phase()
        smoke.decode_phase()
        smoke.stages_phase(gray8, 64)
        smoke.stages_phase(rgb8, 64)
        smoke.parity_phase()
    peak = devices[0].memory_stats()["peak_bytes_in_use"]
    smoke.say(f"all phases passed in {time.perf_counter() - t_start:.1f} s; "
              f"peak memory of the first card {peak / 2**30:.2f} GiB")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
