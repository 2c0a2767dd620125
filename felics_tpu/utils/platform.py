"""The JAX platform this process computes on, and what follows from it.

One place decides: the FLCT pipeline runs on the device when the platform
is ``"gpu"``; Pallas kernels run through the interpreter only when it is
``"cpu"`` (the test suite pins the CPU).
"""

from __future__ import annotations

import subprocess
from typing import List

import jax


def backend() -> str:
    """JAX's default platform name: ``"gpu"``, ``"cpu"``, ..."""
    return jax.default_backend()


def interpret_kernels() -> bool:
    """Whether Pallas kernels must run in interpret mode (CPU only)."""
    return backend() == "cpu"


def card_descriptions() -> List[str]:
    """Each GPU's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them. Every timing on a GPU is reported beside these: a card set below
    its maximum power runs slower under load."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line.strip() for line in r.stdout.splitlines() if line.strip()]
