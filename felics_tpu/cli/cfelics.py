"""cfelics — compress an image file to a felics file.

Parity with the reference CLI (src/bin/cfelics.rs:11-79): same ``-i/--input``
``-o/--output`` flags, same per-depth progress messages, exit code 1 with a
printed message on unreadable/unsupported inputs. Extensions beyond the
reference: ``--container flct`` (tiled parallel format), ``--backend``,
``--tile-size``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from felics_tpu.utils.compile_cache import enable as _enable_cache

    _enable_cache()  # CLI processes are one-shot: reuse compiled kernels
    parser = argparse.ArgumentParser(
        prog="cfelics", description="Compresses an image file to a felics file"
    )
    parser.add_argument("-i", "--input", required=True, help="The input file.")
    parser.add_argument(
        "-o", "--output", required=True, help="The output felics file."
    )
    parser.add_argument(
        "--container",
        choices=["flcs", "flct"],
        default="flcs",
        help="flcs = reference-compatible single stream; flct = tiled parallel format.",
    )
    parser.add_argument(
        "--backend",
        choices=["auto", "oracle", "native", "jax"],
        default="auto",
        help="Codec backend for FLCS encoding.",
    )
    parser.add_argument(
        "--tile-size", type=int, default=128, help="FLCT tile side length."
    )
    args = parser.parse_args(argv)

    from felics_tpu.io.images import UnsupportedImageFormat, load_image

    try:
        image = load_image(args.input)
    except FileNotFoundError as e:
        print(f"Cannot open file: {e}")
        return 1
    except UnsupportedImageFormat as e:
        print(f"Unsupported image format: {e}")
        return 1
    except Exception as e:
        print(f"Cannot decode image: {e}")
        return 1

    depth = 8 if image.dtype.itemsize == 1 else 16
    kind = "grayscale" if image.ndim == 2 else "rgb"
    print(f"Compressing {depth}-bit {kind} image...")

    from felics_tpu.api import compress_image_bytes
    from felics_tpu.config import TileConfig

    try:
        data = compress_image_bytes(
            image,
            backend=args.backend,
            container=args.container,
            tile=TileConfig(tile_h=args.tile_size, tile_w=args.tile_size),
        )
        with open(args.output, "wb") as f:
            f.write(data)
    except Exception as e:
        print(f"Cannot compress image: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
