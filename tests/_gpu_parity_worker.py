"""GPU parity cases: on a real card, the XLA encoder's containers equal the
native C++ codec's, and both decode engines (the compiled Pallas kernel and
the XLA scan) give the pixels back exactly.

Run by tests/test_gpu_parity.py in a subprocess without the CPU pin, and by
chip_smoke.py as its GPU-parity phase. ``main`` exits 42 when JAX finds no
GPU."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = [  # (shape, dtype, tile)
    ((128, 128), np.uint8, 32),
    ((64, 64), np.uint16, 32),
    ((96, 80, 3), np.uint8, 16),
    ((40, 56, 3), np.uint16, 8),
]


def run_cases(log=print) -> int:
    """Run every case on the default device; returns the number run."""
    from felics_tpu.api import header_for_array
    from felics_tpu.config import TileConfig
    from felics_tpu.io.synth import smooth_images
    from felics_tpu.native import runtime as native_runtime
    from felics_tpu.parallel import tiling
    from felics_tpu.utils import platform

    assert platform.backend() == "gpu", platform.backend()
    assert not platform.interpret_kernels()
    assert native_runtime.available(), "native core not built"
    for i, (shape, dtype, tile) in enumerate(CASES):
        img = smooth_images(11 + i, 1, shape, dtype)[0]
        blob = tiling.compress_tiled_bytes(img, TileConfig(tile, tile))
        native = native_runtime.compress_tiled(
            img, header_for_array(img), tile, tile
        )
        assert blob == native, f"{shape} {dtype.__name__}: bytes != native"
        for engine in ("pallas", "xla"):
            out = tiling.decompress_tiled_bytes(blob, engine=engine)
            assert np.array_equal(out, img), f"{shape} {engine} decode"
            assert tiling.LAST_ENGINE["decode"] == engine
        log(f"gpu parity {shape} {dtype.__name__} tile {tile}: "
            f"{len(blob)} bytes == native; pallas and xla decode exact")
    return len(CASES)


def main() -> int:
    import jax

    if jax.devices()[0].platform != "gpu":
        print("NO_GPU")
        return 42
    import subprocess

    from felics_tpu.utils import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run(
        [sys.executable, os.path.join(repo, "native", "build.py")],
        check=True,
    )
    compile_cache.enable()
    run_cases()
    print("GPU_PARITY_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
