"""Multi-image burst throughput (BASELINE config 4 analog on one host):
decode a burst of HEIC images back-to-back through the overlapped
pipeline and report aggregate MP/s plus per-image times as one JSON line.

The sticky shape cache means every image after the first reuses ONE
compiled program, so the burst measures the steady-state serving rate
rather than warmup. Usage:

    python tools/bench_burst.py [image.heic] [n_images]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from heif_tpu.container.reader import HeifReader, parse_grid_config
    from heif_tpu.hevc import params
    from heif_tpu.hevc import slice as sl
    from heif_tpu.hevc.rbsp import remove_emulation_prevention
    from heif_tpu.ops.batch import decode_reconstruct_overlapped

    path = sys.argv[1] if len(sys.argv) > 1 else "tests/assets/halfmoonbay.heic"
    n_images = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    data = open(path, "rb").read()

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
    from heif_tpu.container import grammar as cg

    info = heif.item_info_by_item_id(primary)
    if info is not None and info.item_type == cg.ItemType.GRID:
        grid = parse_grid_config(r.get_item_data(primary))
        tile_ids = heif.item_ids_referencing(primary, "dimg")
    else:
        grid = cg.GridConfig(
            rows=1, columns=1,
            output_width=sps.pic_width_in_luma_samples,
            output_height=sps.pic_height_in_luma_samples,
        )
        tile_ids = [primary]

    def hdrs():
        return [
            sl.parse_slice_header(
                sl.split_length_prefixed_nals(
                    r.get_item_data(t), rec.length_size_minus_one + 1
                )[0],
                sps, pps,
            )
            for t in tile_ids
        ]

    mp = grid.output_width * grid.output_height / 1e6

    # warmup (compile + page faults)
    outs = decode_reconstruct_overlapped(sps, pps, hdrs(), readback=False)
    jax.block_until_ready(outs)

    per_image = []
    t0 = time.perf_counter()
    for _ in range(n_images):
        ti = time.perf_counter()
        outs = decode_reconstruct_overlapped(
            sps, pps, hdrs(), readback=False
        )
        jax.block_until_ready(outs)
        per_image.append(time.perf_counter() - ti)
    wall = time.perf_counter() - t0

    print(
        json.dumps(
            {
                "metric": "burst_decode_to_device_throughput",
                "value": round(n_images * mp / wall, 2),
                "unit": "megapixels/s",
                "images": n_images,
                "megapixels_total": round(n_images * mp, 1),
                "wall_s": round(wall, 3),
                "per_image_s": [round(t, 3) for t in per_image],
                "best_image_mp_s": round(mp / min(per_image), 2),
            }
        )
    )


if __name__ == "__main__":
    main()
