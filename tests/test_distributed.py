"""Multi-host scaffolding: distributed init fallback + sharded burst decode
with scaling-efficiency accounting (BASELINE.md config 4, on the virtual
8-device CPU mesh per SURVEY.md §4's test-without-hardware strategy)."""

import numpy as np
import pytest

from heif_tpu.parallel import distributed as D


def test_init_distributed_single_process_noop(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert D.init_distributed() is False


def test_burst_result_math():
    r = D.BurstResult(images=2, tiles=96, megapixels=24.4, wall_s=2.0,
                      n_devices=8)
    assert r.mp_per_s == pytest.approx(12.2)
    assert r.mp_per_s_per_chip == pytest.approx(1.525)
    assert r.scaling_efficiency(1.525) == pytest.approx(1.0)
    d = r.as_dict()
    assert d["n_devices"] == 8 and d["images"] == 2


_TWO_PROC_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()
import numpy as np

sys.path.insert(0, os.environ["HEIF_TPU_ROOT"])
import jax

# multi-process CPU collectives go through gloo; both settings must land
# before the backend is instantiated
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
from heif_tpu.parallel import distributed as D

pid = int(sys.argv[1])
port = sys.argv[2]
ok = D.init_distributed(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)
assert ok is True, "init_distributed must report a multi-host group"
import jax

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())  # 2 procs x 4 cpu devs

# deterministic small 2x2-grid fixture (same bytes in both processes)
from heif_tpu.utils.hevc_synth import synthesize_pcm_stream
from heif_tpu.utils.heif_mux import mux_heic

rng = np.random.default_rng(17)
W = H = 64
streams = []
for _ in range(4):
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    cb = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    cr = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    streams.append(synthesize_pcm_stream(y, cb, cr))
heic = mux_heic(streams, grid=(2, 2, 2 * W - 8, 2 * H - 6))

outs, res = D.decode_burst_sharded([heic], mesh=D.make_global_mesh())
assert res.n_processes == 2 and res.n_devices == 8
assert res.images == 1 and res.tiles == 4

if pid == 0:
    from heif_tpu.utils import oracle

    ref = oracle.decode_heic_via_de265(heic)
    for k in ("Y", "Cb", "Cr"):
        assert np.array_equal(outs[0][k], ref[k]), k
print(f"proc{pid} OK", flush=True)
"""


@pytest.mark.slow
def test_two_process_distributed_decode(tmp_path):
    """REAL jax.distributed path: a coordinator and a worker process on
    localhost form a 2-process group (8 global CPU devices), shard one
    grid over the global mesh via decode_burst_sharded, and process 0
    verifies bit-exactness against libde265 (round-4 missing #5)."""
    import socket
    import subprocess
    import sys as _sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker.py"
    script.write_text(_TWO_PROC_WORKER)
    import os
    import pathlib

    env = dict(
        os.environ,
        HEIF_TPU_ROOT=str(pathlib.Path(__file__).resolve().parents[1]),
    )
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    procs = [
        subprocess.Popen(
            [_sys.executable, str(script), str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out[-4000:]}"
        assert f"proc{pid} OK" in out


@pytest.mark.slow
def test_burst_sharded_bit_exact_and_scaling(halfmoonbay_bytes):
    """2-image burst over the 8-device mesh: bit-exact + efficiency vs
    a 1-device mesh run of the same work."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from heif_tpu.utils import oracle

    imgs = [halfmoonbay_bytes, halfmoonbay_bytes]
    outs, res = D.decode_burst_sharded(imgs, mesh=D.make_global_mesh(8))
    assert res.images == 2 and res.tiles == 96
    assert res.n_devices == 8
    ref = oracle.decode_heic_via_de265(halfmoonbay_bytes)
    for out in outs:
        assert np.array_equal(out["Y"], ref["Y"])
        assert np.array_equal(out["Cb"], ref["Cb"])
        assert np.array_equal(out["Cr"], ref["Cr"])
    # scaling vs a single-device mesh on one image. Virtual CPU devices
    # share the host's 2 cores, so per-chip efficiency is meaningless
    # here; the meaningful invariants are (a) the 8-device mesh must not
    # lose TOTAL throughput to sharding overhead (back-to-back runs sit
    # in the same host-speed window, so the ratio is stable), and (b)
    # the efficiency accounting must be internally consistent.
    _, res1 = D.decode_burst_sharded(
        [halfmoonbay_bytes], mesh=D.make_global_mesh(1)
    )
    assert res.mp_per_s >= 0.4 * res1.mp_per_s, (
        f"8-device total throughput collapsed: {res.mp_per_s:.2f} vs "
        f"1-device {res1.mp_per_s:.2f} MP/s"
    )
    eff = res.scaling_efficiency(res1.mp_per_s_per_chip)
    assert eff == pytest.approx(
        (res.mp_per_s / 8) / res1.mp_per_s_per_chip
    )
    assert sum(res.per_image_s) <= res.wall_s * 1.01
