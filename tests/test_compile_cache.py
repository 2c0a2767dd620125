"""The persistent compilation cache helper (utils.compile_cache): it uses
JAX_COMPILATION_CACHE_DIR when that is set and sets no directory itself;
otherwise it caches under the checkout's fixed .jax_cache directory."""

import os
import subprocess
import sys

import pytest

from felics_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import jax
from felics_tpu.utils import compile_cache
set_in_code = []
real_update = jax.config.update
def spy(name, value):
    if name == "jax_compilation_cache_dir":
        set_in_code.append(value)
    return real_update(name, value)
jax.config.update = spy
d = compile_cache.enable()
print(d)
print(jax.config.jax_compilation_cache_dir)
print(set_in_code)
"""


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV_VAR}
    if env_dir is not None:
        env[compile_cache.ENV_VAR] = env_dir
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=120, env=env, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-3:]


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_chooses_cache_dir(env_set, tmp_path):
    if env_set:
        want = str(tmp_path / "cache")
        chosen, active, set_in_code = _probe(want)
        assert chosen == want
        assert active == want  # JAX reads the variable itself
        assert set_in_code == "[]"  # ... and no other directory is set
    else:
        chosen, active, set_in_code = _probe(None)
        assert chosen == os.path.join(REPO, ".jax_cache")
        assert chosen == compile_cache.DEFAULT_DIR
        assert active == chosen
        assert set_in_code == repr([chosen])
