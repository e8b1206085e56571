"""Placement of the persistent compilation cache (heif_tpu/__init__.py):
JAX_COMPILATION_CACHE_DIR when set, else one fixed directory inside the
checkout that .gitignore lists; an installed copy outside a checkout sets
no cache and writes nothing beside itself."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("set_var", [True, False])
def test_cache_dir(tmp_path, set_var):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    if set_var:
        want = tmp_path / "cache"
        env["JAX_COMPILATION_CACHE_DIR"] = str(want)
    else:
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        want = ROOT / ".jax_cache"
        assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
    p = subprocess.run(
        [sys.executable, "-c",
         "import heif_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert p.returncode == 0, p.stderr
    assert pathlib.Path(p.stdout.strip()) == want
    assert want.is_dir()


def test_installed_copy_sets_no_cache(tmp_path):
    """A copy of the package with no pyproject.toml beside it (as in
    site-packages) imports without creating a cache directory there."""
    site = tmp_path / "site"
    shutil.copytree(ROOT / "heif_tpu", site / "heif_tpu",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(site))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    p = subprocess.run(
        [sys.executable, "-c",
         "import heif_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "None"
    assert not (site / ".jax_cache").exists()
