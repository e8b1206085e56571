"""Tests that need an NVIDIA GPU (marker `gpu`). They skip elsewhere; on
a machine with a card run them with `python -m pytest -m gpu tests/`.

Whether a card is present is decided in a fixture, by asking nvidia-smi,
so every test process collects the same tests. The conftest pins the
test process to the CPU, so the card is driven by a child process."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def gpu_env() -> dict:
    """Environment for a child process that uses the card."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
        [smi, "-L"], capture_output=True
    ).returncode != 0:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi finds none)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_env):
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=gpu_env,
        capture_output=True, text=True, timeout=1200,
    )
    assert p.returncode == 0, p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "gpu"
