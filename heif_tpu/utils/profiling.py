"""Decode observability: per-stage timings and throughput stats.

Replaces the reference's dbg!() dumps (src/heic/decoder.rs:38-96) and
eprintln-on-skip diagnostics with a structured stats object that the CLI
and bench emit per decode (SURVEY §5 metrics row). Wraps jax.profiler
traces when requested so device stages show up in TensorBoard-compatible
traces.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field


@dataclass
class DecodeStats:
    """Structured per-decode statistics.

    stages: stage name -> wall seconds (hdr, entropy, pack, recon, stitch).
    Counters are filled by the stages that know them; derived rates are
    computed on demand.
    """

    stages: dict = field(default_factory=dict)
    megapixels: float = 0.0
    tiles: int = 0
    tile_errors: int = 0
    errors: dict = field(default_factory=dict)  # tile index -> message
    bins: int = 0  # CABAC bins decoded (entropy stage)
    ctus: int = 0
    n_devices: int = 1
    # scheduler inputs derived from the stream's declared parallelism
    # hints (ops.batch.schedule_hints): chunk, entropy_workers,
    # parallelism_type, min_spatial_segmentation_idc
    scheduler: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    @property
    def total_s(self) -> float:
        return sum(self.stages.values())

    def rates(self) -> dict:
        out = {}
        t = self.total_s
        if t > 0 and self.megapixels:
            out["mp_per_s"] = self.megapixels / t
            out["mp_per_s_per_chip"] = self.megapixels / t / max(self.n_devices, 1)
        ent = self.stages.get("entropy", 0.0)
        if ent > 0 and self.bins:
            out["bins_per_s"] = self.bins / ent
        if t > 0 and self.ctus:
            out["ctus_per_s"] = self.ctus / t
        return out

    def as_dict(self) -> dict:
        d = {
            "stages_ms": {k: round(v * 1e3, 2) for k, v in self.stages.items()},
            "total_ms": round(self.total_s * 1e3, 2),
            "megapixels": round(self.megapixels, 3),
            "tiles": self.tiles,
            "tile_errors": self.tile_errors,
            "n_devices": self.n_devices,
        }
        if self.errors:
            d["errors"] = self.errors
        if self.scheduler:
            d["scheduler"] = self.scheduler
        d.update({k: round(v, 1) for k, v in self.rates().items()})
        return d

    def json(self) -> str:
        return json.dumps(self.as_dict())

    def summary(self) -> str:
        parts = [f"{k} {v * 1e3:.0f}ms" for k, v in self.stages.items()]
        r = self.rates()
        if "mp_per_s" in r:
            parts.append(f"{r['mp_per_s']:.1f} MP/s")
        if self.tile_errors:
            parts.append(f"{self.tile_errors}/{self.tiles} tiles FAILED")
        return "  ".join(parts)


DEFAULT_TRACE_DIR = os.path.join(tempfile.gettempdir(), "heif_tpu_trace")


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """jax.profiler trace around a decode into `logdir` (CLI --trace);
    no trace when logdir is None."""
    if logdir is None:
        yield
        return
    import jax.profiler

    with jax.profiler.trace(logdir):
        yield

