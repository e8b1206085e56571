"""chip_smoke.py: its guards, phase selection and last line on the CPU,
and its decode and mesh phases on a small synthetic grid (the mesh phase
over four virtual CPU devices). The full-size run needs a GPU."""

import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_chip_smoke()


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def small_grid() -> bytes:
    """2x2 grid of 64x64 all-PCM tiles, cropped to 120x122."""
    from heif_tpu.utils.heif_mux import mux_heic
    from heif_tpu.utils.hevc_synth import synthesize_pcm_stream

    rng = np.random.default_rng(5)
    streams = []
    for _ in range(4):
        y = rng.integers(0, 256, (64, 64)).astype(np.uint8)
        cb = rng.integers(0, 256, (32, 32)).astype(np.uint8)
        cr = rng.integers(0, 256, (32, 32)).astype(np.uint8)
        streams.append(synthesize_pcm_stream(y, cb, cr))
    return mux_heic(streams, grid=(2, 2, 120, 122))


def _no_result(out: str) -> bool:
    return '"ok"' not in out


def test_refuses_without_gpu(capsys):
    assert cs.main([]) == 1
    cap = capsys.readouterr()
    assert "no GPU" in cap.err
    assert _no_result(cap.out)


def test_refuses_without_native_library(monkeypatch, capsys):
    from heif_tpu import native

    monkeypatch.setattr(cs, "require_gpu", lambda n=1: [_FakeGpu()])
    monkeypatch.setattr(native, "available", lambda: False)
    assert cs.main([]) == 1
    cap = capsys.readouterr()
    assert "native entropy library" in cap.err
    assert _no_result(cap.out)


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert p.returncode != 0
    assert "not a checkout" in p.stderr
    assert _no_result(p.stdout)


def test_result_line_format():
    line = cs.result_line([_FakeGpu()])
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )


@pytest.mark.parametrize(
    "argv, phase, count",
    [([], "decode", 1), (["--mesh", "4"], "mesh", 4)],
)
def test_phase_selection(monkeypatch, capsys, argv, phase, count):
    """No option runs the decode phase alone; --mesh 4 runs the mesh
    phase alone, on four devices, and reports count 4."""
    calls = []
    monkeypatch.setattr(cs, "require_gpu", lambda n=1: [_FakeGpu()] * n)
    monkeypatch.setattr(cs, "require_native", lambda: None)
    monkeypatch.setattr(cs, "card_lines", lambda: "NVIDIA H100, 700.00 W")
    monkeypatch.setattr(cs, "phase_decode", lambda data: calls.append(("decode",)))
    monkeypatch.setattr(
        cs, "phase_mesh", lambda data, n: calls.append(("mesh", n))
    )
    assert cs.main(argv) == 0
    assert [c[0] for c in calls] == [phase]
    if phase == "mesh":
        assert calls[0][1] == 4
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "NVIDIA H100, 700.00 W"
    last = json.loads(lines[-1])
    assert last == {
        "ok": True,
        "device": {"platform": "gpu", "kind": _FakeGpu.device_kind,
                   "count": count},
    }


def test_decode_phase_small_grid(small_grid, capsys):
    cs.phase_decode(small_grid, warm=1)
    out = capsys.readouterr().out
    assert "2 decodes in a row: bit-identical" in out
    assert "core memory_analysis: argument_size_in_bytes=" in out
    for k in ("Y", "Cb", "Cr"):
        assert f"jax vs ref {k}" in out
    assert "mismatching samples" in out
    assert " 0 mismatching" in out


def test_mesh_phase_on_four_virtual_devices(small_grid, capsys):
    import jax

    assert len(jax.devices()) >= 4
    cs.phase_mesh(small_grid, 4)
    out = capsys.readouterr().out
    for k in ("Y", "Cb", "Cr"):
        assert f"mesh 4 vs one device {k}" in out
    assert "mesh 4 decode warm" in out


def test_compare_reports_mismatch():
    a = {k: np.zeros((4, 4), np.uint8) for k in ("Y", "Cb", "Cr")}
    b = {k: v.copy() for k, v in a.items()}
    b["Cr"][1, 2] = 1
    cs.compare("same", a, {k: v.copy() for k, v in a.items()})
    with pytest.raises(cs.SmokeError, match="Cr: 1 mismatching"):
        cs.compare("diff", a, b)
