"""End-to-end decode benchmark on one GPU: halfmoonbay.heic (12.2 MP,
48 tiles).

Pipeline measured: container parse -> slice headers -> overlapped (host
C++ entropy decode || jitted batched reconstruction on the GPU || async
plane readback) -> stitch of all three planes (Y + Cb + Cr). Also
measured: decode-to-device (planes left on the card, the path for pixels
that feed a model on the card) and a 4-image pipelined burst.
vs_baseline is the ratio to single-threaded libde265 on the same host in
the same run, "not measured" when libde265 does not load.

Refuses to run without a GPU or without the native entropy library.
Prints the card's name and power limit, then ONE JSON line.

    python bench.py
"""

import json
import subprocess
import sys
import time

REPS = 5
BURST_N = 4


def stitch(plane, rows, cols, th, tw, out_h, out_w):
    return (
        plane.reshape(rows, cols, th, tw)
        .transpose(0, 2, 1, 3)
        .reshape(rows * th, cols * tw)[:out_h, :out_w]
    )


def main():
    import gc

    import jax

    from heif_tpu import native
    from heif_tpu.container.reader import HeifReader, parse_grid_config
    from heif_tpu.hevc import params
    from heif_tpu.hevc import slice as sl
    from heif_tpu.hevc.rbsp import remove_emulation_prevention
    from heif_tpu.ops.batch import decode_burst, decode_reconstruct_overlapped
    from heif_tpu.utils import oracle
    from heif_tpu.utils.profiling import DecodeStats

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: JAX found no GPU (platform {dev.platform!r})")
    if not native.available():
        sys.exit("bench.py: the native entropy library does not load "
                 "(make -C heif_tpu/native)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"# card: {card}", file=sys.stderr)

    data = open("tests/assets/halfmoonbay.heic", "rb").read()

    def parse():
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
        return r, sps, pps, grid, tile_ids

    def slices_of(r, sps, pps, tile_ids):
        return [
            sl.parse_slice_header(
                sl.split_length_prefixed_nals(r.get_item_data(t), 4)[0],
                sps, pps,
            )
            for t in tile_ids
        ]

    def decode_once():
        """Decode with the planes read back and stitched on the host."""
        stats = DecodeStats()
        r, sps, pps, grid, tile_ids = parse()
        with stats.stage("hdr"):
            slices = slices_of(r, sps, pps, tile_ids)
        with stats.stage("recon"):
            planes = decode_reconstruct_overlapped(
                sps, pps, slices, stats=stats
            )
        with stats.stage("stitch"):
            th = sps.pic_height_in_luma_samples
            tw = sps.pic_width_in_luma_samples
            oh, ow = grid.output_height, grid.output_width
            stitch(planes[0], grid.rows, grid.columns, th, tw, oh, ow)
            for p in planes[1:]:
                stitch(p, grid.rows, grid.columns, th // 2, tw // 2,
                       oh // 2, ow // 2)
        return stats

    def decode_to_device_once():
        """Decode with the planes left on the card."""
        r, sps, pps, grid, tile_ids = parse()
        slices = slices_of(r, sps, pps, tile_ids)
        t0 = time.perf_counter()
        outs = decode_reconstruct_overlapped(sps, pps, slices,
                                             readback=False)
        jax.block_until_ready(outs)
        return time.perf_counter() - t0

    def burst_once():
        """BURST_N images pipelined, planes left on the card; seconds."""
        image_slices = []
        for _ in range(BURST_N):
            r, sps, pps, _, tids = parse()
            image_slices.append(slices_of(r, sps, pps, tids))
        t0 = time.perf_counter()
        jax.block_until_ready(decode_burst(sps, pps, image_slices))
        return time.perf_counter() - t0

    _, _, _, grid0, _ = parse()
    mp = grid0.output_width * grid0.output_height / 1e6

    t0 = time.perf_counter()
    decode_once()
    decode_to_device_once()
    burst_once()
    print(f"# warmup (compile included): {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    has_base = oracle.de265_available()
    e2e, dev_t, burst_t, base_t, all_stats = [], [], [], [], []
    for _ in range(REPS):
        gc.collect()
        t0 = time.perf_counter()
        all_stats.append(decode_once())
        e2e.append(time.perf_counter() - t0)
        dev_t.append(decode_to_device_once())
        burst_t.append(burst_once())
        if has_base:
            t0 = time.perf_counter()
            oracle.decode_heic_via_de265(data)
            base_t.append(time.perf_counter() - t0)

    best = min(e2e)
    stats = all_stats[e2e.index(best)]
    print(f"# best e2e {best:.3f}s  {stats.summary()}  ({mp:.1f} MP)",
          file=sys.stderr)
    value = mp / best
    base = mp / min(base_t) if base_t else None
    not_measured = "not measured (libde265 not found)"
    print(
        json.dumps(
            {
                "metric": "e2e_heif_decode_throughput",
                "value": round(value, 3),
                "unit": "megapixels/s",
                "baseline_mp_s": round(base, 3) if base else not_measured,
                "vs_baseline": (
                    round(value / base, 3) if base else not_measured
                ),
                "device_mp_s": round(mp / min(dev_t), 3),
                "burst_mp_s": round(BURST_N * mp / min(burst_t), 3),
                "reps": REPS,
                "stages_ms": {
                    k: round(v * 1e3, 3) for k, v in stats.stages.items()
                },
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "card": card,
            }
        )
    )


if __name__ == "__main__":
    main()
