"""Multi-chip tile-parallel reconstruction over a jax.sharding.Mesh.

Sharding model (SURVEY.md §2.2): HEIF grid tiles are independent pictures —
the primary axis is grid-tile data parallelism. Packing here is
tile-uniform ([N, ...] leading axis everywhere, per-tile transform classes
padded to a common count), so shard_map over a 1-D 'tiles' mesh keeps all
compute device-local; the only communication is the output stitch, an
all_gather of decoded planes.

Scales to multi-host the same way: jax.distributed + a global mesh; tile
bitstreams scatter to hosts, planes gather back (no other traffic).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

from heif_tpu.ops import jax_recon as J
from heif_tpu.ops import pack as P

PAD = J.PAD
CLASSES = [
    (0, 4), (0, 8), (0, 16), (0, 32),
    (1, 4), (1, 8), (1, 16),
    (2, 4), (2, 8), (2, 16),
]


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), axis_names=("tiles",))


# --------------------------------------------------------------------------
# Tile-uniform packing
# --------------------------------------------------------------------------


def pack_uniform(
    syntaxes, sps, pps, slices, n_tiles_pad: int | None = None,
    n_steps: list | None = None, class_maxc: dict | None = None,
):
    """Pack N tiles with identical per-tile shapes.

    n_steps / class_maxc: optional shared shape overrides so several
    chunks of a streamed decode hit one compiled program (see
    decode_grid_sharded_streamed).
    Returns (arrays: dict of numpy arrays with leading tile axis, static:
    dict of python scalars/flags).
    """
    counts = [[0, 0, 0] for _ in syntaxes]
    for i, st in enumerate(syntaxes):
        for row in st.tu_table:
            counts[i][int(row[0])] += 1
    if n_steps is None:
        n_steps = [
            max(1, -(-max(c[k] for c in counts) // 64) * 64) for k in range(3)
        ]
    plans = [
        P.pack_tile(st, pps_sps[0], pps_sps[1], ps.header, n_steps=n_steps)
        for st, ps, pps_sps in zip(
            syntaxes, slices, [(sps, pps)] * len(syntaxes)
        )
    ]
    n_real = len(plans)
    n = n_tiles_pad or n_real
    H, W = plans[0].height, plans[0].width
    Hc, Wc = H // 2, W // 2
    g4h, g4w = H // 4, W // 4
    ctbs = H // 32 if H % 32 == 0 else -(-H // 32)

    arrays = {}
    # per-class uniform blocks
    for comp, size in CLASSES:
        maxc = 1
        per_tile = []
        for plan in plans:
            found = None
            for tc in plan.tclasses:
                if tc.comp == comp and tc.size == size:
                    found = tc
            per_tile.append(found)
            if found is not None:
                maxc = max(maxc, found.n)
        maxc = -(-maxc // 16) * 16
        if class_maxc is not None:
            cap = class_maxc.get((comp, size), maxc)
            assert cap >= maxc, f"class ({comp},{size}): {maxc} > cap {cap}"
            maxc = cap
        cs = np.zeros((n, maxc, size, size), dtype=np.int32)
        qp = np.zeros((n, maxc), dtype=np.int32)
        dst = np.zeros((n, maxc), dtype=bool)
        skip = np.zeros((n, maxc), dtype=bool)
        byp = np.zeros((n, maxc), dtype=bool)
        valid = np.zeros((n, maxc), dtype=bool)
        pos = np.zeros((n, maxc, 2), dtype=np.int32)
        for i, tc in enumerate(per_tile):
            if tc is None:
                continue
            cs[i, : tc.n] = tc.coeffs
            qp[i, : tc.n] = tc.qp
            dst[i, : tc.n] = tc.dst
            skip[i, : tc.n] = tc.skip
            byp[i, : tc.n] = tc.bypass
            valid[i, : tc.n] = True
            pos[i, : tc.n] = tc.pos
        key = f"c{comp}s{size}"
        arrays[f"tc_{key}_coeffs"] = cs
        arrays[f"tc_{key}_qp"] = qp
        arrays[f"tc_{key}_dst"] = dst
        arrays[f"tc_{key}_skip"] = skip
        arrays[f"tc_{key}_bypass"] = byp
        arrays[f"tc_{key}_valid"] = valid
        arrays[f"tc_{key}_pos"] = pos

    for c in range(3):
        for name in ("x", "y", "size", "mode", "filter_flag", "pcm", "src"):
            vals = [getattr(p.comp_plans[c], name) for p in plans]
            stk = np.stack(vals)
            if n > n_real:
                padshape = (n - n_real,) + stk.shape[1:]
                fill = -1 if name.startswith("src") else 0
                stk = np.concatenate(
                    [stk, np.full(padshape, fill, dtype=stk.dtype)]
                )
            arrays[f"xs{c}_{name}"] = stk

    def stackpad(vals, fill=0):
        stk = np.stack(vals)
        if n > n_real:
            stk = np.concatenate(
                [stk, np.full((n - n_real,) + stk.shape[1:], fill, dtype=stk.dtype)]
            )
        return stk

    arrays["qp_map"] = stackpad([p.qp_map for p in plans])
    arrays["nf_map"] = stackpad([p.nf_map for p in plans])
    arrays["vert_edges"] = stackpad([p.vert_edges for p in plans])
    arrays["horiz_edges"] = stackpad([p.horiz_edges for p in plans])
    arrays["sao"] = stackpad([p.sao.astype(np.int32) for p in plans])

    # PCM sample planes: shipped only when some tile actually contains PCM
    # blocks (pcm_flag content is rare); zero-filled on device otherwise.
    # PCM presence from the block maps, not sample values (an all-zero
    # PCM block is still PCM; see ops.batch._finish_plan)
    if any(st.pcm_map.any() for st in syntaxes):
        for c in range(3):
            hh = H if c == 0 else Hc
            ww = W if c == 0 else Wc
            arr = np.zeros((n, hh + PAD, ww + PAD), dtype=np.int32)
            for i, p in enumerate(plans):
                if p.pcm_planes:
                    arr[i, :hh, :ww] = p.pcm_planes[c]
            arrays[f"pcm{c}"] = arr

    p0 = plans[0]
    static = dict(
        n=n,
        H=H,
        W=W,
        deblock_disabled=p0.deblock_disabled,
        sao_luma=p0.sao_luma,
        sao_chroma=p0.sao_chroma,
        beta_off=p0.beta_off,
        tc_off=p0.tc_off,
        cb_qp_off=p0.cb_qp_off,
        cr_qp_off=p0.cr_qp_off,
        strong_smoothing=bool(sps.strong_intra_smoothing_enabled_flag),
        scaling={k: v for k, v in p0.scaling.items()},
    )
    return arrays, static


# --------------------------------------------------------------------------
# Per-shard core (runs on each device's local tiles)
# --------------------------------------------------------------------------


def _shard_core(arrays, static):
    """Decode the local shard of tiles; returns local (y, cb, cr) stacks."""
    H, W = static["H"], static["W"]
    Hc, Wc = H // 2, W // 2
    dims = [(H, W), (Hc, Wc), (Hc, Wc)]
    n_loc = arrays["qp_map"].shape[0]

    # stage 1: residuals (vmapped per-tile batched transforms + scatter)
    res = [
        jnp.zeros((n_loc, (h + PAD) * (w + PAD)), jnp.int32) for h, w in dims
    ]
    for comp, size in CLASSES:
        key = f"c{comp}s{size}"
        coeffs = arrays[f"tc_{key}_coeffs"]
        if coeffs.shape[1] == 0:
            continue
        qp = arrays[f"tc_{key}_qp"]
        dst = arrays[f"tc_{key}_dst"]
        skip = arrays[f"tc_{key}_skip"]
        byp = arrays[f"tc_{key}_bypass"]
        valid = arrays[f"tc_{key}_valid"]
        pos = arrays[f"tc_{key}_pos"]
        scaling = jnp.asarray(static["scaling"][(size, comp)])
        rc = jax.vmap(
            lambda c, q, d, s, b: J.residual_class(c, q, d, s, b, scaling, size)
        )(coeffs, qp, dst, skip, byp)
        rc = jnp.where(valid[:, :, None, None], rc, 0)
        h, w = dims[comp]
        stride = w + PAD
        oy = pos[..., 0][:, :, None, None]
        ox = pos[..., 1][:, :, None, None]
        iy = jnp.arange(size)[None, None, :, None]
        ix = jnp.arange(size)[None, None, None, :]
        flat = ((oy + iy) * stride + (ox + ix)).reshape(n_loc, -1)
        res[comp] = jax.vmap(lambda p, f, v: p.at[f].add(v))(
            res[comp], flat, rc.reshape(n_loc, -1)
        )
    res = [res[c].reshape(n_loc, dims[c][0] + PAD, dims[c][1] + PAD) for c in range(3)]

    # stage 2: scans
    planes = []
    for c in range(3):
        h, w = dims[c]
        xs = tuple(
            arrays[f"xs{c}_{nm}"]
            for nm in ("x", "y", "size", "mode", "filter_flag", "pcm", "src")
        )
        # derive plane0 from a varying array so the shard_map manual axis
        # tracking sees it as device-varying (fresh zeros would be
        # 'unvarying' and break the scan carry typing)
        base = jnp.zeros((n_loc, 1 + h + J.SPAD, 1 + w + J.SPAD), jnp.int32)
        plane0 = base + (res[c][:, :1, :1] * 0)
        pcm_c = arrays.get(f"pcm{c}", res[c] * 0)
        scan_fn = partial(
            J.intra_scan_component,
            is_luma=(c == 0),
            strong_smoothing=static["strong_smoothing"],
        )
        plane = jax.vmap(scan_fn)(plane0, res[c], pcm_c, xs)
        planes.append(plane[:, 1 : 1 + h, 1 : 1 + w])

    # stage 3+4: deblock + sao (same code as ops.batch)
    qp_map = arrays["qp_map"]
    nf_map = arrays["nf_map"]
    vert_edges = arrays["vert_edges"]
    horiz_edges = arrays["horiz_edges"]
    sao = arrays["sao"]
    if not static["deblock_disabled"]:
        ne = W // 8 - 1
        cols = 2 * jnp.arange(ne) + 2
        lv = jax.vmap(
            partial(
                J._deblock_luma_pass,
                beta_off=static["beta_off"],
                tc_off=static["tc_off"],
            )
        )
        y = lv(
            planes[0], vert_edges[:, :, cols], qp_map[:, :, cols - 1],
            qp_map[:, :, cols], nf_map[:, :, cols - 1], nf_map[:, :, cols],
        )
        qT = jnp.swapaxes(qp_map, 1, 2)
        nT = jnp.swapaxes(nf_map, 1, 2)
        hT = jnp.swapaxes(horiz_edges, 1, 2)
        y = jnp.swapaxes(
            lv(
                jnp.swapaxes(y, 1, 2), hT[:, :, cols], qT[:, :, cols - 1],
                qT[:, :, cols], nT[:, :, cols - 1], nT[:, :, cols],
            ),
            1, 2,
        )
        planes[0] = y
        nec = Wc // 8 - 1
        ccols = 4 * jnp.arange(nec) + 4
        cv = jax.vmap(partial(J._deblock_chroma_pass, tc_off=static["tc_off"]))
        for ci, c_off in ((1, static["cb_qp_off"]), (2, static["cr_qp_off"])):
            qp_avg = (qp_map[:, :, ccols - 1] + qp_map[:, :, ccols] + 1) >> 1
            qpc = J._onehot_take(J._CHROMA_QP_LUT, jnp.clip(qp_avg + c_off, 0, 57), 58)
            p = cv(
                planes[ci], vert_edges[:, :, ccols], qpc,
                nf_map[:, :, ccols - 1], nf_map[:, :, ccols],
            )
            qp_avgT = (qT[:, :, ccols - 1] + qT[:, :, ccols] + 1) >> 1
            qpcT = J._onehot_take(J._CHROMA_QP_LUT, jnp.clip(qp_avgT + c_off, 0, 57), 58)
            p = jnp.swapaxes(
                cv(
                    jnp.swapaxes(p, 1, 2), hT[:, :, ccols], qpcT,
                    nT[:, :, ccols - 1], nT[:, :, ccols],
                ),
                1, 2,
            )
            planes[ci] = p

    if static["sao_luma"] or static["sao_chroma"]:
        sv = jax.vmap(J.sao_component)
        out = []
        for c in range(3):
            enabled = static["sao_luma"] if c == 0 else static["sao_chroma"]
            if not enabled:
                out.append(planes[c])
                continue
            sub = 1 if c == 0 else 2
            cs_ = 32 // sub
            h, w = dims[c]
            rep = lambda a: jnp.repeat(jnp.repeat(a, cs_, 1), cs_, 2)[:, :h, :w]
            stype = rep(sao[:, :, :, c, 0])
            sclass = rep(sao[:, :, :, c, 1])
            offs = jnp.stack([rep(sao[:, :, :, c, 2 + i]) for i in range(4)], -1)
            nf_pix = jnp.repeat(jnp.repeat(nf_map, 4 // sub, 1), 4 // sub, 2)[:, :h, :w]
            out.append(sv(planes[c], stype, sclass, offs, nf_pix))
        planes = out

    return planes[0], planes[1], planes[2]


# --------------------------------------------------------------------------
# shard_map wrapper
# --------------------------------------------------------------------------


# jitted shard_map programs keyed by (mesh geometry, gather flag, static
# scalars, array shapes): shard_map closures are fresh objects per call,
# so without this cache every invocation would recompile
_sharded_jit_cache: dict = {}


def reconstruct_sharded(arrays, static, mesh: Mesh, gather: bool = True):
    """Run the tile decode sharded over mesh axis 'tiles'.

    With gather=True the decoded plane stacks are all_gathered so
    every device holds the full set (the grid-stitch communication step);
    otherwise outputs stay tile-sharded.
    """
    from jax import shard_map

    key = (
        tuple(mesh.shape.items()),
        tuple(id(d) for d in mesh.devices.flat),
        gather,
        tuple(
            sorted(
                (k, v)
                for k, v in static.items()
                if isinstance(v, (int, bool, float, str))
            )
        ),
        # scaling matrices are baked into the program as constants
        tuple(
            (k, hash(v.tobytes()))
            for k, v in sorted(static.get("scaling", {}).items())
        ),
        tuple(sorted((k, v.shape, str(v.dtype)) for k, v in arrays.items())),
    )
    fn = _sharded_jit_cache.get(key)
    if fn is None:

        def body(arrs):
            y, cb, cr = _shard_core(arrs, static)
            if gather:
                y = jax.lax.all_gather(y, "tiles", axis=0, tiled=True)
                cb = jax.lax.all_gather(cb, "tiles", axis=0, tiled=True)
                cr = jax.lax.all_gather(cr, "tiles", axis=0, tiled=True)
            return y, cb, cr

        in_specs = jax.tree.map(lambda _: PS("tiles"), arrays)
        out_spec = PS() if gather else PS("tiles")
        fn = jax.jit(
            shard_map(
                body,
                mesh=mesh,
                in_specs=(in_specs,),
                out_specs=(out_spec, out_spec, out_spec),
                # gather=True: lax.all_gather(tiled=True) makes every
                # device hold identical full plane stacks, but the
                # varying-manual-axis checker cannot statically infer
                # replication through tiled all_gather, so the check is
                # disabled for that variant only. gather=False outputs
                # stay tile-sharded and are fully checked.
                check_vma=not gather,
            )
        )
        if len(_sharded_jit_cache) > 32:
            _sharded_jit_cache.pop(next(iter(_sharded_jit_cache)))
        _sharded_jit_cache[key] = fn
    return fn(arrays)


def _uniform_shapes(syntaxes):
    """Shared (n_steps, class_maxc) over a tile list so every chunk of a
    streamed decode compiles to one program shape."""
    n_steps = [1, 1, 1]
    class_maxc: dict = {}
    for st in syntaxes:
        tt = st.tu_table
        comp = tt[:, 0]
        for c in range(3):
            n_steps[c] = max(n_steps[c], int((comp == c).sum()))
        live = (tt[:, 4] != 0) & (tt[:, 10] == 0)
        for comp_i, size in CLASSES:
            log2 = size.bit_length() - 1
            k = int((live & (comp == comp_i) & (tt[:, 3] == log2)).sum())
            key = (comp_i, size)
            class_maxc[key] = max(class_maxc.get(key, 1), k)
    n_steps = [max(1, -(-s // 64) * 64) for s in n_steps]
    class_maxc = {k: -(-v // 16) * 16 for k, v in class_maxc.items()}
    return n_steps, class_maxc


# sticky per-geometry shapes for the streamed sharded path (same doctrine
# as ops.batch._sticky_shapes: grow monotonically so chunks and repeat
# decodes of one geometry converge on a single compiled program)
_sticky_uniform: dict = {}


def decode_grid_sharded_streamed(
    sps, pps, slices, mesh: Mesh | None = None, chunk: int | None = None,
    entropy_fn=None,
):
    """Production-shape sharded decode: the grid is processed in
    device-multiple chunks, host entropy (C++ CABAC, threaded) for chunk
    k+1 overlaps the sharded device compute of chunk k, and all chunks
    share one compiled shard_map program (sticky shapes). This replaces
    the full-grid uniform pack of decode_grid_sharded for large images —
    no whole-image host-memory spike, and the mesh never idles behind
    entropy. Returns [Y, Cb, Cr] stacked numpy planes for all N tiles.
    """
    from concurrent.futures import ThreadPoolExecutor

    from heif_tpu import native

    mesh = mesh or make_mesh()
    d = int(mesh.devices.size)
    n = len(slices)
    if entropy_fn is None:
        if native.available():
            entropy_fn = lambda ps: native.decode_tiles_parallel(sps, pps, ps)
        else:
            from heif_tpu.cabac.syntax import TileSyntaxDecoder

            entropy_fn = lambda ps: [
                TileSyntaxDecoder(sps, pps, p).decode() for p in ps
            ]
    if chunk is None:
        chunk = 2 * d  # two waves of tiles per device per dispatch
    chunk = max(d, -(-chunk // d) * d)
    chunks = [slices[lo : lo + chunk] for lo in range(0, n, chunk)]
    key = (
        sps.pic_width_in_luma_samples,
        sps.pic_height_in_luma_samples,
        sps.ctb_log2_size_y,
        d,
        min(chunk, -(-n // d) * d),
    )
    outs = []
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        futs = [ex.submit(entropy_fn, c) for c in chunks]
        if key not in _sticky_uniform and len(chunks) > 1:
            # cold geometry: derive ONE program shape from all chunks up
            # front (forfeits entropy/compute overlap this image only)
            all_syn = [s for fut in futs for s in fut.result()]
            _sticky_uniform[key] = _uniform_shapes(all_syn)
        for fi, fut in enumerate(futs):
            syn = list(fut.result())
            sl_chunk = list(chunks[fi])
            n_pad = -(-len(syn) // d) * d if len(chunks) == 1 else chunk
            n_steps, maxc = _uniform_shapes(syn)
            if key in _sticky_uniform:
                pn, pm = _sticky_uniform[key]
                n_steps = [max(a, b) for a, b in zip(n_steps, pn)]
                for k2, v in pm.items():
                    maxc[k2] = max(maxc.get(k2, 1), v)
            _sticky_uniform[key] = (n_steps, dict(maxc))
            arrays, static = pack_uniform(
                syn, sps, pps, sl_chunk, n_tiles_pad=n_pad,
                n_steps=n_steps, class_maxc=maxc,
            )
            arrays = _put_sharded(arrays, mesh)
            # multi-process: every process holds the full (replicated)
            # inputs and reads the full outputs, so the planes must come
            # back all_gathered — a tile-sharded global array is not
            # host-readable from any single process
            y, cb, cr = reconstruct_sharded(
                arrays, static, mesh, gather=_is_multiprocess()
            )
            outs.append((y, cb, cr, len(syn)))
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
    return [
        np.concatenate(
            [np.asarray(o[c])[: o[3]] for o in outs], axis=0
        )
        for c in range(3)
    ]


def _is_multiprocess() -> bool:
    try:
        return jax.process_count() > 1
    except Exception:
        return False


def _put_sharded(arrays: dict, mesh: Mesh) -> dict:
    """Place packed host arrays tile-sharded over the (possibly
    multi-process global) mesh. Every process passes the identical full
    array; device_put lays down only the shards addressable locally, so
    this is the cross-host bitstream-scatter step of SURVEY.md §2.3 on a
    multi-host mesh and a plain H2D on one host."""
    sh = NamedSharding(mesh, PS("tiles"))
    return {k: jax.device_put(v, sh) for k, v in arrays.items()}


def decode_grid_sharded(syntaxes, sps, pps, slices, mesh: Mesh | None = None):
    """Full sharded decode of a tile batch; returns [Y, Cb, Cr] stacks."""
    mesh = mesh or make_mesh()
    d = mesh.devices.size
    n = len(syntaxes)
    n_pad = -(-n // d) * d
    arrays, static = pack_uniform(syntaxes, sps, pps, slices, n_tiles_pad=n_pad)
    arrays = _put_sharded(arrays, mesh)
    # tile-sharded outputs (gather=False) on one host: the stitch happens
    # on host, so reading the sharded stacks directly avoids a redundant
    # all_gather and keeps the varying-axis checker enabled. Multi-process
    # outputs must gather (see decode_grid_sharded_streamed).
    y, cb, cr = reconstruct_sharded(
        arrays, static, mesh, gather=_is_multiprocess()
    )
    return [np.asarray(y)[:n], np.asarray(cb)[:n], np.asarray(cr)[:n]]
