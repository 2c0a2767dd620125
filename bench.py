#!/usr/bin/env python
"""Serving-path rows for the FLCT codec on one GPU.

    python bench.py [--seed N]

Needs an NVIDIA GPU: exits non-zero, printing no rows, when JAX finds none.
Rows, each printed beside the card's name and power limit:

  * container one-shot: ``compress_tiled_batch`` / ``decompress_tiled_batch``
    for gray8, rgb8 and gray16 batches (images in, bytes out, images back);
  * pipelined stream: the same batches through ``*_tiled_stream``;
  * batched FLCS through the jax backend (encode; the decode is a
    per-pixel scan over whole images and is slow by design);
  * one-device sharded encode (``encode_tiled_sharded``) against the
    unsharded encoder.

Inputs are generated from ``--seed`` (felics_tpu.io.synth). Every timing is
the best of a few warm passes on the host clock around the public calls,
each ended by ``jax.block_until_ready``.
The last line is one JSON object with the gray8 container row.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
TILE = 32
PASSES = 3


def _best(f, passes=PASSES):
    import jax

    jax.block_until_ready(f())  # warm: compile every shape timed below
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        best = min(best, time.perf_counter() - t0)
    return best


def _mpx(images):
    return sum(im.shape[0] * im.shape[1] for im in images) / 1e6


def container_row(images, tc):
    from felics_tpu.parallel.batch import (
        compress_tiled_batch,
        decompress_tiled_batch,
    )

    blobs = compress_tiled_batch(images, tc)
    for im, out in zip(images, decompress_tiled_batch(blobs)):
        assert np.array_equal(im, out), "container round trip mismatch"
    t_enc = _best(lambda: compress_tiled_batch(images, tc))
    t_dec = _best(lambda: decompress_tiled_batch(blobs))
    ratio = sum(im.nbytes for im in images) / sum(map(len, blobs))
    return t_enc, t_dec, ratio


def stream_row(images, tc, chunk):
    from felics_tpu.parallel.batch import (
        compress_tiled_stream,
        decompress_tiled_stream,
    )

    chunks = [images[i : i + chunk] for i in range(0, len(images), chunk)]
    blobs = compress_tiled_stream(chunks, tc)
    for ims, outs in zip(chunks, decompress_tiled_stream(blobs)):
        for im, out in zip(ims, outs):
            assert np.array_equal(im, out), "stream round trip mismatch"
    return (
        _best(lambda: compress_tiled_stream(chunks, tc)),
        _best(lambda: decompress_tiled_stream(blobs)),
    )


def flcs_row(images):
    from felics_tpu.api import compress_image_bytes
    from felics_tpu.core import jax_codec

    blobs = jax_codec.compress_images_bytes(images)
    for im, b in zip(images, blobs):
        assert b == compress_image_bytes(im, backend="native"), (
            "FLCS jax bytes differ from the native codec's"
        )
    return _best(lambda: jax_codec.compress_images_bytes(images))


def sharded_row(image, tc):
    import jax

    from felics_tpu.parallel import tiling
    from felics_tpu.parallel.mesh import encode_tiled_sharded, make_tile_mesh

    mesh = make_tile_mesh(jax.devices()[:1])
    ref = tiling.compress_tiled_bytes(image, tc)
    assert encode_tiled_sharded(image, mesh, tc) == ref
    return (
        _best(lambda: tiling.compress_tiled_bytes(image, tc)),
        _best(lambda: encode_tiled_sharded(image, mesh, tc)),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1

    import subprocess

    from felics_tpu.config import TileConfig
    from felics_tpu.io.synth import smooth_images
    from felics_tpu.native import runtime as native_runtime
    from felics_tpu.utils import compile_cache, platform

    subprocess.run(
        [sys.executable, os.path.join(REPO, "native", "build.py")], check=True
    )
    if not native_runtime.available():
        print("bench.py: the native core did not load", file=sys.stderr)
        return 1
    compile_cache.enable()
    card = platform.card_descriptions()[0]
    tc = TileConfig(TILE, TILE)
    classes = {
        "gray8": smooth_images(args.seed, 12, (512, 512), np.uint8),
        "rgb8": smooth_images(args.seed + 1, 8, (512, 512, 3), np.uint8),
        "gray16": smooth_images(args.seed + 2, 4, (512, 512), np.uint16),
    }
    summary = None
    for name, images in classes.items():
        mpx = _mpx(images)
        t_enc, t_dec, ratio = container_row(images, tc)
        s_enc, s_dec = stream_row(images, tc, chunk=max(1, len(images) // 4))
        print(
            f"[{card}] {name} {len(images)}x{images[0].shape} tile {TILE}: "
            f"ratio {ratio:.3f}; container enc {t_enc * 1e3:.1f} ms "
            f"({mpx / t_enc:.1f} Mpx/s) dec {t_dec * 1e3:.1f} ms "
            f"({mpx / t_dec:.1f} Mpx/s); stream enc {s_enc * 1e3:.1f} ms "
            f"dec {s_dec * 1e3:.1f} ms",
            flush=True,
        )
        if summary is None:
            summary = 2 * mpx / (t_enc + t_dec)
    flcs = classes["gray8"][:4]
    t_flcs = flcs_row(flcs)
    print(f"[{card}] FLCS jax encode 4x512x512 gray8: {t_flcs * 1e3:.1f} ms "
          f"({_mpx(flcs) / t_flcs:.1f} Mpx/s)", flush=True)
    t_u, t_s = sharded_row(classes["gray8"][0], tc)
    print(f"[{card}] sharded encode on a one-device mesh: {t_s * 1e3:.1f} ms "
          f"vs unsharded {t_u * 1e3:.1f} ms", flush=True)
    print(json.dumps({
        "metric": "FLCT gray8 container encode+decode, 12x512x512, "
                  f"tile {TILE}, {dev.device_kind} [{card}]",
        "value": round(summary, 2),
        "unit": "Mpx/s",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
