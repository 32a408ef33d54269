"""Entry points on a machine without a GPU: the measurement paths fail
instead of falling back to the CPU, and the compile-cache directory is
chosen by the rule the entry points share."""

import os
import shutil
import subprocess
import sys

import pytest

from cpuperformanceraytracer_tpu.utils.compile_cache import (
    DEFAULT_DIR,
    ENV_VAR,
    compile_cache_dir,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env=None):
    env = {**os.environ, **(env or {}), "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measurement_fails_without_gpu(script):
    r = _run([os.path.join(REPO, script)], cwd=REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository beside it, chip_smoke.py exits
    non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("environ,want", [
    ({}, DEFAULT_DIR),
    ({ENV_VAR: ""}, DEFAULT_DIR),
    ({ENV_VAR: "/some/cache"}, "/some/cache"),
])
def test_compile_cache_dir(environ, want):
    """The environment's directory wins; otherwise one fixed directory
    inside the checkout (git-ignored), never a temporary path."""
    assert compile_cache_dir(environ) == want
    assert DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_setup_compile_cache_respects_env(monkeypatch):
    """With the variable set, nothing is set in code (JAX reads the
    variable itself); without it, JAX's option points at the default."""
    import jax

    from cpuperformanceraytracer_tpu.utils.compile_cache import (
        setup_compile_cache,
    )

    before = jax.config.jax_compilation_cache_dir
    try:
        assert setup_compile_cache({ENV_VAR: "/env/cache"}) == "/env/cache"
        assert jax.config.jax_compilation_cache_dir == before
        assert setup_compile_cache({}) == DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
