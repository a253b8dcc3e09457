"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins when set and
no code overrides it; otherwise the cache sits at a fixed directory inside
the checkout, which .gitignore lists."""

import os
import subprocess
import sys

import pytest

import mapper_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = "import mapper_tpu, jax; print(jax.config.jax_compilation_cache_dir)"


def test_resolver_unset_is_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = mapper_tpu.compile_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_resolver_set_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert mapper_tpu.compile_cache_dir() == str(tmp_path)


@pytest.mark.parametrize("set_var", [True, False])
def test_package_import_configures_jax(set_var, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if set_var:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    assert out == (str(tmp_path) if set_var else os.path.join(REPO, ".jax_cache"))
