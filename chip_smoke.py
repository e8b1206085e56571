#!/usr/bin/env python
"""Smoke test of the decode path on NVIDIA GPUs.

    python chip_smoke.py            # one card: flagship decode, checked
    python chip_smoke.py --mesh 4   # the tile-sharded path on four cards

Without options it decodes tests/assets/halfmoonbay.heic (4032x3024, a
6x8 grid of 512x512 tiles, WPP, SAO, irot 3) through
HeicDecoder.decode(backend="jax"), the CLI's path, and requires:

- zero mismatching samples in Y, Cb and Cr against the numpy reference
  (backend="ref") and against libde265 when that library loads;
- four decodes in a row (one cold, three warm) bit-identical to each other.

It prints the card's name and power limit, the core program's
memory_analysis(), the cold decode time (compilation included) and three
warm decode times. With --mesh N it runs only the sharded path
(HeicDecoder.decode(mesh_devices=N)) and compares it with the one-card
planes and with libde265.

The last line of standard output is one JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits non-zero and prints no such line when JAX finds no GPU, when the
native entropy library does not load, when it is run outside a checkout,
or when any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, "tests", "assets", "halfmoonbay.heic")


class SmokeError(RuntimeError):
    """A phase of the smoke test failed."""


def require_checkout() -> None:
    if not (
        os.path.isdir(os.path.join(ROOT, "heif_tpu")) and os.path.isfile(ASSET)
    ):
        raise SmokeError(
            f"{ROOT} is not a checkout of the repository (no heif_tpu/ or "
            "tests/assets/halfmoonbay.heic beside chip_smoke.py)"
        )
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def require_gpu(min_count: int = 1) -> list:
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SmokeError(
            f"JAX found no GPU (platform {devices[0].platform!r})"
        )
    if len(devices) < min_count:
        raise SmokeError(f"need {min_count} GPUs, JAX found {len(devices)}")
    return devices


def require_native() -> None:
    from heif_tpu import native

    if not native.available():
        raise SmokeError(
            "the native entropy library does not load; build it with "
            "`make -C heif_tpu/native`"
        )


def card_lines() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": d.platform,
                "kind": d.device_kind,
                "count": len(devices),
            },
        }
    )


def compare(name: str, got: dict, want: dict) -> None:
    """Zero mismatching samples in every plane, or SmokeError."""
    import numpy as np

    for k in ("Y", "Cb", "Cr"):
        a, b = got[k], want[k]
        if a.shape != b.shape:
            raise SmokeError(f"{name} {k}: shape {a.shape} != {b.shape}")
        bad = int(np.count_nonzero(a != b))
        print(f"{name} {k} {a.shape[1]}x{a.shape[0]}: {bad} mismatching samples")
        if bad:
            raise SmokeError(f"{name} {k}: {bad} mismatching samples")


def compare_de265(name: str, got: dict, data: bytes) -> None:
    """Compare with single-threaded libde265, or say it was not measured."""
    import numpy as np

    from heif_tpu.models.decoder import HeicDecoder
    from heif_tpu.utils import oracle

    if not oracle.de265_available():
        print(f"{name} vs libde265: not measured (libde265 not found)")
        return
    gold = oracle.decode_heic_via_de265(data)
    k = HeicDecoder.probe(data).rotation
    gold = {p: np.rot90(v, k=k) for p, v in gold.items()}
    compare(f"{name} vs libde265", got, gold)


def core_memory(data: bytes) -> str:
    """memory_analysis() of the core program the decode's first chunk
    runs (the same program the pipelined decode compiles)."""
    from heif_tpu.models.decoder import HeicDecoder
    from heif_tpu.ops import batch

    fe = HeicDecoder.front_end(data)
    bp = next(batch.plan_chunks(fe.syntaxes, fe.sps, fe.pps, fe.slices))
    ma = batch.compile_core(bp).memory_analysis()
    fields = (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    return ", ".join(f"{f}={getattr(ma, f)}" for f in fields)


def phase_decode(data: bytes, warm: int = 3) -> None:
    """Decode on one device: timings, run-to-run identity, reference
    and libde265 comparisons."""
    import numpy as np

    from heif_tpu.models.decoder import HeicDecoder

    runs = []
    for i in range(1 + warm):
        t0 = time.perf_counter()
        out = HeicDecoder.decode(data, backend="jax")
        dt = time.perf_counter() - t0
        label = "cold (compile included)" if i == 0 else f"warm {i}"
        print(f"jax decode {label}: {dt:.3f} s")
        runs.append(out)
    y = runs[0]["Y"]
    print(f"decoded {y.shape[1]}x{y.shape[0]} {y.dtype}")
    for i, out in enumerate(runs[1:], 1):
        for k in ("Y", "Cb", "Cr"):
            if not np.array_equal(out[k], runs[0][k]):
                raise SmokeError(f"decode {i} {k} differs from decode 0")
    print(f"{len(runs)} decodes in a row: bit-identical")
    print(f"core memory_analysis: {core_memory(data)}")
    t0 = time.perf_counter()
    ref = HeicDecoder.decode(data, backend="ref")
    print(f"ref decode (numpy, host): {time.perf_counter() - t0:.3f} s")
    compare("jax vs ref", runs[0], ref)
    compare_de265("jax", runs[0], data)


def phase_mesh(data: bytes, n: int) -> None:
    """The tile-sharded path over n devices against the one-device
    planes and libde265."""
    from heif_tpu.models.decoder import HeicDecoder

    one = HeicDecoder.decode(data, backend="jax")
    for i in range(2):
        t0 = time.perf_counter()
        out = HeicDecoder.decode(data, backend="jax", mesh_devices=n)
        label = "cold (compile included)" if i == 0 else "warm"
        print(f"mesh {n} decode {label}: {time.perf_counter() - t0:.3f} s")
    compare(f"mesh {n} vs one device", out, one)
    compare_de265(f"mesh {n}", out, data)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument(
        "--mesh", type=int, default=None, metavar="N",
        help="run only the tile-sharded path over N GPUs",
    )
    args = p.parse_args(argv)
    try:
        require_checkout()
        devices = require_gpu(args.mesh or 1)
        require_native()
        print(card_lines())
        with open(ASSET, "rb") as f:
            data = f.read()
        if args.mesh:
            phase_mesh(data, args.mesh)
        else:
            phase_decode(data)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
