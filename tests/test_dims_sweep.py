"""Exhaustive small-dims parity sweep, 0..20 x 0..20 x {u8,u16} x {gray,rgb}.

Reference counterpart: the #[ignore]d 0..20 sweep in src/compression.rs:
544-558. Here the full 13x13 grid runs BY DEFAULT across the oracle and
native codecs — the SAME 21x21 grid as the reference's #[ignore]d sweep,
but on by default (byte-equality + exact round trip — catches preamble/edge
bugs in all four format combos); including the jax backend for every shape
would jit-compile ~440 distinct programs, so the jax column covers a spanning
subset by default and the full grid under FELICS_FULL_SWEEP=1
(mirroring the reference's ignore-gating of the expensive variant).
"""

import os

import numpy as np
import pytest

from felics_tpu.api import compress_image_bytes, decompress_image_bytes

FULL_JAX = os.environ.get("FELICS_FULL_SWEEP", "0") == "1"
JAX_DIMS = {0, 1, 2, 3, 5, 12, 20}


@pytest.fixture(scope="module", autouse=True)
def built_native():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run(
        [sys.executable, os.path.join(repo, "native", "build.py")], check=True
    )
    from felics_tpu.native import runtime

    runtime._load_attempted = False
    runtime._lib = None
    assert runtime.available()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [None, 3])
def test_dims_sweep(rng, dtype, channels):
    hi = np.iinfo(dtype).max + 1
    for w in range(0, 21):
        for h in range(0, 21):
            shape = (h, w) if channels is None else (h, w, channels)
            img = rng.integers(0, hi, size=shape).astype(dtype)
            ora = compress_image_bytes(img, backend="oracle")
            nat = compress_image_bytes(img, backend="native")
            assert ora == nat, f"{dtype} {shape}: oracle/native bytes differ"
            out = decompress_image_bytes(nat, backend="native")
            np.testing.assert_array_equal(out, img)
            assert out.dtype == dtype
            out_o = decompress_image_bytes(ora, backend="oracle")
            np.testing.assert_array_equal(out_o, img)
            if FULL_JAX or (w in JAX_DIMS and h in JAX_DIMS):
                jx = compress_image_bytes(img, backend="jax")
                assert jx == ora, f"{dtype} {shape}: jax bytes differ"
                if w * h >= 2:  # jax decode path needs a non-degenerate scan
                    out_j = decompress_image_bytes(jx, backend="jax")
                    np.testing.assert_array_equal(out_j, img)
