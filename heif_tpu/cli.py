"""Command-line interface: decode / probe / verify / bench.

Parity target: reference src/main.rs:3-7 (a CLI that decodes one file),
extended per SURVEY.md §2.1 row 2 with verify and bench subcommands.

  python -m heif_tpu decode IMAGE.heic [-o out.ppm] [--backend jax|ref]
  python -m heif_tpu probe  IMAGE.heic
  python -m heif_tpu verify IMAGE.heic          # vs libde265/libheif oracle
  python -m heif_tpu bench  IMAGE.heic [-n 3]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from heif_tpu.utils.profiling import DEFAULT_TRACE_DIR


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_ppm(path: str, rgb: np.ndarray) -> None:
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb.tobytes())


def cmd_probe(args) -> int:
    from heif_tpu.models.decoder import HeicDecoder

    info = HeicDecoder.probe(_read(args.file))
    out = {
        "ispe": [info.ispe_width, info.ispe_height],
        "display": [info.display_width, info.display_height],
        "rotation_ccw_deg": info.rotation * 90,
        "luma_bit_depth": info.luma_bit_depth,
        "chroma_bit_depth": info.chroma_bit_depth,
        "chroma_format_idc": info.chroma_format_idc,
        "primary_item_id": info.primary_item_id,
        "grid": (
            {
                "rows": info.grid.rows,
                "columns": info.grid.columns,
                "output": [info.grid.output_width, info.grid.output_height],
                "tiles": len(info.tile_ids),
            }
            if info.grid
            else None
        ),
        "thumbnail_count": info.thumbnail_count,
    }
    print(json.dumps(out, indent=2))
    return 0


def cmd_decode(args) -> int:
    from heif_tpu.models.decoder import HeicDecoder
    from heif_tpu.utils.profiling import DecodeStats, device_trace

    stats = DecodeStats()
    stats.n_devices = args.mesh or 1
    data = _read(args.file)
    is_annexb = data[4:8] != b"ftyp"
    t0 = time.perf_counter()
    with device_trace(args.trace):
        if is_annexb:
            # raw Annex-B .hevc stream (no container)
            planes = HeicDecoder.decode_hevc(data, backend=args.backend)
        else:
            planes = HeicDecoder.decode(
                data,
                backend=args.backend,
                mesh_devices=args.mesh,
                isolate_tile_errors=args.isolate_errors,
                item_id=args.item,
                stats=stats,
            )
    dt = time.perf_counter() - t0
    y = planes["Y"]
    mp = y.size / 1e6
    stats.megapixels = mp
    stats.stages["total"] = dt
    print(
        f"decoded {y.shape[1]}x{y.shape[0]} ({mp:.1f} MP) "
        f"in {dt:.3f}s [{args.backend}]",
        file=sys.stderr,
    )
    if args.stats:
        print(stats.json(), file=sys.stderr)
    if stats.tile_errors:
        print(
            f"WARNING: {stats.tile_errors}/{stats.tiles} tiles failed "
            f"(decoded as gray): {stats.errors}",
            file=sys.stderr,
        )
    if args.output:
        if args.output.endswith(".ppm"):
            _write_ppm(args.output, HeicDecoder.to_rgb(planes))
        elif args.output.endswith(".npz"):
            np.savez(
                args.output,
                **{
                    k: planes[k]
                    for k in ("Y", "Cb", "Cr")
                    if planes[k] is not None
                },
            )
        else:
            print("unsupported output format (use .ppm or .npz)", file=sys.stderr)
            return 2
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


def cmd_verify(args) -> int:
    """Bit-exact plane comparison against the libde265 oracle."""
    from heif_tpu.models.decoder import HeicDecoder
    from heif_tpu.utils import oracle

    data = _read(args.file)
    ours = HeicDecoder.decode(data, backend=args.backend, apply_rotation=False)
    golden = oracle.decode_heic_via_de265(data)
    ok = True
    for k in ("Y", "Cb", "Cr"):
        a, b = ours[k], golden[k]
        if a.shape != b.shape:
            print(f"{k}: SHAPE MISMATCH ours={a.shape} golden={b.shape}")
            ok = False
            continue
        diff = int(np.count_nonzero(a != b))
        status = "OK (bit-exact)" if diff == 0 else f"MISMATCH {diff} px"
        print(f"{k}: {a.shape[1]}x{a.shape[0]}  {status}")
        ok = ok and diff == 0
    return 0 if ok else 1


def cmd_bench(args) -> int:
    from heif_tpu.models.decoder import HeicDecoder

    data = _read(args.file)
    HeicDecoder.decode(data, backend=args.backend)  # warmup/compile
    times = []
    for _ in range(args.n):
        t0 = time.perf_counter()
        planes = HeicDecoder.decode(data, backend=args.backend)
        times.append(time.perf_counter() - t0)
    mp = planes["Y"].size / 1e6
    best = min(times)
    print(
        json.dumps(
            {
                "metric": "e2e_heif_decode_throughput",
                "value": round(mp / best, 3),
                "unit": "megapixels/s",
                "best_s": round(best, 4),
                "runs": args.n,
                "backend": args.backend,
            }
        )
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="heif_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("probe", help="container metadata only")
    pp.add_argument("file")
    pp.set_defaults(fn=cmd_probe)

    pd = sub.add_parser("decode", help="full pixel decode")
    pd.add_argument("file")
    pd.add_argument("-o", "--output", help=".ppm or .npz output path")
    pd.add_argument("--backend", default="jax", choices=["jax", "ref"])
    pd.add_argument("--item", type=int, default=None,
                    help="decode this item id instead of the primary "
                         "(e.g. an auxiliary alpha/depth hvc1 item)")
    pd.add_argument(
        "--mesh", type=int, default=None, metavar="N",
        help="shard the tile grid over an N-device jax Mesh",
    )
    pd.add_argument(
        "--isolate-errors", action="store_true",
        help="corrupt tiles decode as gray instead of failing the image",
    )
    pd.add_argument("--stats", action="store_true",
                    help="print per-stage decode stats JSON to stderr")
    pd.add_argument("--trace", nargs="?", const=DEFAULT_TRACE_DIR,
                    default=None, metavar="DIR",
                    help="capture a jax.profiler trace of the decode into "
                         f"DIR (default {DEFAULT_TRACE_DIR})")
    pd.set_defaults(fn=cmd_decode)

    pv = sub.add_parser("verify", help="bit-exact check vs libde265 oracle")
    pv.add_argument("file")
    pv.add_argument("--backend", default="jax", choices=["jax", "ref"])
    pv.set_defaults(fn=cmd_verify)

    pb = sub.add_parser("bench", help="decode throughput benchmark")
    pb.add_argument("file")
    pb.add_argument("-n", type=int, default=3)
    pb.add_argument("--backend", default="jax", choices=["jax", "ref"])
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
