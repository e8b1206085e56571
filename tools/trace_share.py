#!/usr/bin/env python
"""Device time of a decode trace, attributed to the core's named stages.

    python tools/trace_share.py TRACE_DIR [IMAGE]

TRACE_DIR holds a jax.profiler trace of a decode, for example from
`python -m heif_tpu.cli decode IMAGE --trace TRACE_DIR`. The core program
(ops.batch._core) wraps its stages in jax.named_scope: residuals, intra,
deblock, sao. Trace events name the HLO instruction they ran (`hlo_op`),
so the script compiles the core for IMAGE's first chunk (the same
program the decode ran, found in the compilation cache), maps each
instruction to the scope in its op_name metadata, and sums the durations
of the events of each scope on the trace's GPU planes. Prints one JSON
line naming the planes it read. Exits non-zero when JAX finds no GPU
(the HLO must be the card's) or the trace has no GPU plane.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
from collections import Counter, defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCOPES = ("residuals", "intra", "deblock", "sao")
CORE_MODULE = "_core_blobs"
GPU_PLANE = "/device:GPU"

_COMPUTATION = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def op_scopes(hlo_text: str, scopes=SCOPES) -> dict:
    """HLO instruction name -> the first of `scopes` in its op_name. A
    fusion whose own metadata names no scope takes the scope most of the
    instructions of its fused computation name."""
    own = {}
    calls = {}
    in_comp = defaultdict(Counter)
    comp = None
    for line in hlo_text.splitlines():
        m = _COMPUTATION.match(line)
        if m:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name = m.group(1)
        op = _OP_NAME.search(line)
        parts = op.group(1).split("/") if op else ()
        scope = next((s for s in scopes if s in parts), None)
        if scope is not None:
            own[name] = scope
            in_comp[comp][scope] += 1
        called = _CALLS.findall(line)
        if called:
            calls[name] = called
    out = dict(own)
    for name, called in calls.items():
        if name not in out:
            votes = sum((in_comp[c] for c in called), Counter())
            if votes:
                out[name] = votes.most_common(1)[0][0]
    return out


def plane_events(xplane_path: str, module: str, plane: str):
    """(plane name, hlo_op, duration_ns) of every event of `module` on the
    trace planes whose name starts with `plane`."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    for p in pd.planes:
        if not p.name.startswith(plane):
            continue
        for line in p.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None or module not in str(stats.get("hlo_module", "")):
                    continue
                yield p.name, str(op), ev.duration_ns


def scope_times(xplane_path: str, scopes_of: dict, module: str,
                plane: str = GPU_PLANE) -> dict:
    """Summed ns per scope of the events on the `plane` planes; ops
    outside every scope count as 'other' and the 20 longest of them are
    listed by name. 'planes' names the planes the events came from."""
    times = defaultdict(float)
    other = defaultdict(float)
    planes = set()
    for name, op, ns in plane_events(xplane_path, module, plane):
        planes.add(name)
        s = scopes_of.get(op)
        if s is None:
            other[op] += ns
            s = "other"
        times[s] += ns
    top = sorted(other.items(), key=lambda kv: -kv[1])[:20]
    return {"ns": dict(times), "other_ops": dict(top),
            "planes": sorted(planes)}


def core_hlo(image: str) -> str:
    """Optimized HLO text of the core the decode of `image` runs."""
    from heif_tpu.models.decoder import HeicDecoder
    from heif_tpu.ops import batch

    with open(image, "rb") as f:
        fe = HeicDecoder.front_end(f.read())
    bp = next(batch.plan_chunks(fe.syntaxes, fe.sps, fe.pps, fe.slices))
    return batch.compile_core(bp).as_text()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    trace_dir = argv[0]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    image = argv[1] if len(argv) > 1 else os.path.join(
        root, "tests", "assets", "halfmoonbay.heic"
    )
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        print(f"no .xplane.pb under {trace_dir}", file=sys.stderr)
        return 1
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        print(f"JAX found no GPU (platform {d.platform!r})", file=sys.stderr)
        return 1
    res = scope_times(paths[-1], op_scopes(core_hlo(image)), CORE_MODULE)
    if not res["planes"]:
        print(f"no {CORE_MODULE} events on a {GPU_PLANE} plane of "
              f"{paths[-1]}", file=sys.stderr)
        return 1
    total = sum(res["ns"].values())
    res["total_ns"] = total
    res["share"] = {k: v / total for k, v in res["ns"].items()}
    res["device"] = {"platform": d.platform, "kind": d.device_kind}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
