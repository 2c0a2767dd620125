"""Multi-process (2 x 4 CPU devices) distributed-encode test.

SURVEY §7 step 7: jax.distributed.initialize, tiles sharded over the global
mesh, the per-tile length cumsum as the only collective. Each worker joins the process group, encodes the SAME image over
the 8-device global mesh, and must produce container bytes identical to the
single-process encoder — proving the multi-host path changes the execution
layout, never the format.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_encode_matches_single_process(tmp_path):
    # (timeout is enforced by the 240 s communicate() below, not a plugin)
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    outs = [str(tmp_path / f"blob_{i}.fel") for i in range(2)]
    env = {
        k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)
    }
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, "2", str(i), outs[i]],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=REPO,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i]}"

    blobs = [open(o, "rb").read() for o in outs]
    assert blobs[0] == blobs[1], "processes disagree on container bytes"

    # Single-process reference (this pytest process: 8-device CPU platform).
    from felics_tpu.config import TileConfig
    from felics_tpu.parallel import tiling

    rng = np.random.default_rng(7)
    img = np.clip(
        np.cumsum(np.cumsum(rng.integers(-6, 7, (64, 48)), 0), 1) + 128, 0, 255
    ).astype(np.uint8)
    single = tiling.compress_tiled_bytes(img, TileConfig(16, 16))
    assert blobs[0] == single, "multi-host bytes diverge from single-process"

    # And the container decodes exactly.
    out = tiling.decompress_tiled_bytes(blobs[0])
    np.testing.assert_array_equal(out, img)
