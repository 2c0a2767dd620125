"""On-card parity. The rest of the suite runs on the CPU (conftest pins
it), where the decode kernel runs in the Pallas interpreter; this test
spawns a subprocess WITHOUT the CPU pin. With an NVIDIA GPU present it runs
tests/_gpu_parity_worker.py there (compiled kernel, XLA encoder vs the
native codec); without one it skips. On the card:

    python -m pytest -m gpu tests/test_gpu_parity.py
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_gpu_parity_worker.py")


@pytest.mark.gpu
def test_gpu_parity():
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    r = subprocess.run(
        [sys.executable, WORKER], capture_output=True, text=True,
        timeout=900, cwd=REPO, env=env,
    )
    if r.returncode == 42 and "NO_GPU" in r.stdout:
        pytest.skip("no GPU attached")
    assert r.returncode == 0, f"worker failed:\n{r.stdout}\n{r.stderr}"
    assert "GPU_PARITY_OK" in r.stdout
