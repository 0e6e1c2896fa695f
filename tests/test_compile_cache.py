"""The compile-cache helper (utils/compile_cache.py): with
JAX_COMPILATION_CACHE_DIR set, JAX's own setting wins and no other
directory is configured; without it, a fixed directory in the checkout.
Each case runs in a fresh interpreter, so this suite's own process never
turns a cache on."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = (
    "import jax; "
    "from raytracer_tpu.utils.compile_cache import enable_compile_cache; "
    "got = enable_compile_cache(); "
    "print(got); print(jax.config.jax_compilation_cache_dir)"
)


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env, check=True,
        capture_output=True, text=True, timeout=120,
    )
    returned, configured = out.stdout.strip().splitlines()[-2:]
    return returned, configured


def test_env_var_wins(tmp_path):
    want = str(tmp_path / "cache")
    assert _probe(want) == (want, want)


def test_default_is_fixed_path_in_checkout():
    returned, configured = _probe(None)
    assert returned == configured == os.path.join(REPO, ".jax_cache")
