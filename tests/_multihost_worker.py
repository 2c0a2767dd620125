"""Worker process for the multi-host test: joins a 2-process jax.distributed
group on CPU (4 virtual devices per process = 8 global), encodes a
deterministic image over the global tile mesh, and writes the container bytes
to the path given in argv. Run by tests/test_multihost.py, not directly."""

import os
import sys


def main() -> int:
    coordinator, num_procs, pid, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")  # before any backend init
    # Join the process group BEFORE importing felics_tpu (its import chain
    # may touch the backend, and jax.distributed.initialize must come first).
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_procs,
        process_id=pid,
    )

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np

    from felics_tpu.config import TileConfig
    from felics_tpu.parallel import multihost
    assert jax.process_count() == num_procs, jax.process_count()
    assert len(jax.devices()) == 4 * num_procs, len(jax.devices())

    rng = np.random.default_rng(7)
    img = np.clip(
        np.cumsum(np.cumsum(rng.integers(-6, 7, (64, 48)), 0), 1) + 128, 0, 255
    ).astype(np.uint8)
    data = multihost.encode_tiled_multihost(img, TileConfig(16, 16))
    # The multi-process encode must produce the native C++ codec's bytes.
    from felics_tpu.api import header_for_array
    from felics_tpu.native import runtime as native_runtime

    if native_runtime.available():
        assert data == native_runtime.compress_tiled(
            img, header_for_array(img), 16, 16
        ), "multihost bytes diverge from the native codec"
    # Multihost decode, both engines, round-trip exact.
    for eng in ("xla", "pallas"):
        out = multihost.decode_tiled_multihost(data, engine=eng)
        assert np.array_equal(out, img), f"multihost {eng} decode mismatch"
    # Corpus encode: every image's tiles in one global sharded batch; containers byte-equal to the single-process
    # batch API.
    from felics_tpu.parallel.batch import compress_tiled_batch

    rng2 = np.random.default_rng(9)
    corpus = [
        np.clip(
            np.cumsum(np.cumsum(rng2.integers(-6, 7, (48, 32)), 0), 1) + 128,
            0, 255,
        ).astype(np.uint8)
        for _ in range(3)
    ]
    blobs = multihost.encode_corpus_multihost(corpus, TileConfig(16, 16))
    assert blobs == compress_tiled_batch(corpus, TileConfig(16, 16)), (
        "multihost corpus bytes diverge from the batch API"
    )
    with open(out_path, "wb") as f:
        f.write(data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
