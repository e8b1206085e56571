"""Multi-host decode scaffolding: jax.distributed + global tile meshes.

SURVEY.md §2.3: the reference is single-process with no comm backend at
all; here it is JAX's distributed runtime for cross-host process
groups, a global Mesh over every device of every host, and XLA
collectives as the only transport. For a still-image decoder the
traffic pattern is trivially partitionable: tile bitstreams scatter to
hosts, decoded planes gather back — no other
communication exists (BASELINE.md config 4).

On a single host this module degenerates gracefully: init_distributed()
is a no-op without coordinator env vars, and the burst harness runs on
whatever devices exist (including the virtual
--xla_force_host_platform_device_count CPU mesh used by tests).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import jax

from heif_tpu.parallel.pipeline import (
    decode_grid_sharded_streamed,
    make_mesh,
)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize the JAX distributed runtime for multi-host meshes.

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, also
    honoring COORDINATOR_ADDRESS et al). Returns True when a multi-host
    group was initialized, False for the single-process fallback. After
    a successful init, jax.devices() spans every host in the group and
    make_global_mesh() shards tiles across the whole pod.
    """
    addr = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS", os.environ.get("COORDINATOR_ADDRESS")
    )
    nproc = num_processes or int(
        os.environ.get("JAX_NUM_PROCESSES", os.environ.get("NUM_PROCESSES", 0))
        or 0
    )
    pid = (
        process_id
        if process_id is not None
        else int(
            os.environ.get("JAX_PROCESS_ID", os.environ.get("PROCESS_ID", -1))
        )
    )
    if not addr or nproc <= 1 or pid < 0:
        return False
    jax.distributed.initialize(
        coordinator_address=addr, num_processes=nproc, process_id=pid
    )
    return True


def make_global_mesh(n_devices: int | None = None):
    """1-D 'tiles' mesh over all (possibly multi-host) devices.

    Device order follows jax.devices(), which groups by process — so
    contiguous tile shards land host-local and only the plane gather
    crosses hosts.
    """
    return make_mesh(n_devices)


@dataclass
class BurstResult:
    """Multi-image burst decode stats (BASELINE config 4 deliverable)."""

    images: int = 0
    tiles: int = 0
    megapixels: float = 0.0
    wall_s: float = 0.0
    n_devices: int = 1
    n_processes: int = 1
    per_image_s: list = field(default_factory=list)

    @property
    def mp_per_s(self) -> float:
        return self.megapixels / self.wall_s if self.wall_s else 0.0

    @property
    def mp_per_s_per_chip(self) -> float:
        return self.mp_per_s / max(self.n_devices, 1)

    def scaling_efficiency(self, single_chip_mp_s: float) -> float:
        """Throughput per chip relative to a 1-chip run of the same work."""
        if not single_chip_mp_s:
            return 0.0
        return self.mp_per_s_per_chip / single_chip_mp_s

    def as_dict(self) -> dict:
        return {
            "images": self.images,
            "tiles": self.tiles,
            "megapixels": round(self.megapixels, 2),
            "wall_s": round(self.wall_s, 4),
            "mp_per_s": round(self.mp_per_s, 2),
            "mp_per_s_per_chip": round(self.mp_per_s_per_chip, 2),
            "n_devices": self.n_devices,
            "n_processes": self.n_processes,
        }


def decode_burst_sharded(
    images: list[bytes], mesh=None, repeats: int = 1
) -> tuple[list, BurstResult]:
    """Decode a burst of HEIC images with tiles sharded over the mesh.

    This is the 100 MP+ multi-image configuration: each image's tile grid
    is scattered over the mesh's devices, decoded, and gathered. Returns
    (list of {"Y","Cb","Cr"} dicts for the last repeat, BurstResult).
    """
    from heif_tpu.container.reader import HeifReader, parse_grid_config
    from heif_tpu.hevc import params
    from heif_tpu.hevc import slice as sl
    from heif_tpu.hevc.rbsp import remove_emulation_prevention

    mesh = mesh or make_global_mesh()
    res = BurstResult(
        n_devices=int(mesh.devices.size), n_processes=jax.process_count()
    )

    parsed = []
    for data in images:
        r = HeifReader(data)
        heif = r.read()
        rec = heif.hevc_configuration_record()
        sps = params.parse_sps(
            remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:])
        )
        pps = params.parse_pps(
            remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:])
        )
        primary = heif.primary_item_id()
        grid = parse_grid_config(r.get_item_data(primary))
        tile_ids = heif.item_ids_referencing(primary, "dimg")
        slices = [
            sl.parse_slice_header(
                sl.split_length_prefixed_nals(r.get_item_data(t), 4)[0],
                sps, pps,
            )
            for t in tile_ids
        ]
        parsed.append((sps, pps, grid, slices))

    outs = []
    t0 = time.perf_counter()
    for _ in range(repeats):
        outs = []
        for sps, pps, grid, slices in parsed:
            ti0 = time.perf_counter()
            # per-chunk streamed decode: host entropy overlaps the
            # sharded device compute, no whole-image uniform pack
            y, cb, cr = decode_grid_sharded_streamed(
                sps, pps, slices, mesh=mesh
            )
            res.per_image_s.append(time.perf_counter() - ti0)
            th = sps.pic_height_in_luma_samples
            tw = sps.pic_width_in_luma_samples

            def _stitch(p, th_, tw_, oh, ow):
                return (
                    p.reshape(grid.rows, grid.columns, th_, tw_)
                    .transpose(0, 2, 1, 3)
                    .reshape(grid.rows * th_, grid.columns * tw_)[:oh, :ow]
                )

            outs.append(
                {
                    "Y": _stitch(y, th, tw, grid.output_height,
                                 grid.output_width),
                    "Cb": _stitch(cb, th // 2, tw // 2,
                                  grid.output_height // 2,
                                  grid.output_width // 2),
                    "Cr": _stitch(cr, th // 2, tw // 2,
                                  grid.output_height // 2,
                                  grid.output_width // 2),
                }
            )
            res.images += 1
            res.tiles += len(slices)
            res.megapixels += (
                grid.output_width * grid.output_height / 1e6
            )
    res.wall_s = time.perf_counter() - t0
    return outs, res
