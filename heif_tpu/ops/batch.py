"""Batched multi-tile reconstruction: one jitted program for N tiles.

Layout strategy:
- transform classes are flattened ACROSS tiles: each (component, size)
  class becomes one dense [Ntotal, s, s] batch -> two int32 matmuls,
  scattered into per-tile residual planes by precomputed flat indices.
- the three component scans are vmapped over the tile axis: each scan
  step processes all N tiles' k-th TU simultaneously.
- deblock/SAO vectorized passes are vmapped over tiles.

All shapes are static given (n_tiles, per-component scan lengths,
per-class totals); jit caches per shape signature.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from heif_tpu.ops import jax_recon as J
from heif_tpu.ops import pack as P

PAD = J.PAD

# fixed class list: (comp, size)
CLASSES = [
    (0, 4), (0, 8), (0, 16), (0, 32),
    (1, 4), (1, 8), (1, 16),
    (2, 4), (2, 8), (2, 16),
]


@dataclass
class BatchPlan:
    n: int
    width: int
    height: int
    # per class: dict keyed by (comp,size)
    tc_coeffs: dict
    tc_qp: dict
    tc_dst: dict
    tc_skip: dict
    tc_bypass: dict
    # per-BLOCK flat scatter origin into [N*(h+PAD)*(w+PAD)]; the device
    # expands to per-sample indices (origin + iy*stride + ix) — shipping
    # one int32 per block instead of size^2 keeps the host->device
    # transfer ~20x smaller for this tensor
    tc_org: dict
    scaling: dict
    # scans: per comp tuple of [N, S, ...] arrays
    xs: list
    pcm: list  # per comp [N, h+PAD, w+PAD] int32 (or None)
    # loop filter meta, stacked [N, ...]
    qp_map: np.ndarray
    nf_map: np.ndarray
    vert_edges: np.ndarray
    horiz_edges: np.ndarray
    sao: np.ndarray
    ctb_log2: int
    deblock_disabled: bool
    sao_luma: bool
    sao_chroma: bool
    beta_off: int
    tc_off: int
    cb_qp_off: int
    cr_qp_off: int
    strong_smoothing: bool
    bit_depth_y: int = 8
    bit_depth_c: int = 8
    # interior tile boundaries in luma pixels (§6.5.1), () = no tiles;
    # drives §6.4.1 availability in the device intra path
    tile_col_bd: tuple = ()
    tile_row_bd: tuple = ()


def _scaling_for_sps(sps):
    """Per-SPS cache of the 12 scaling-factor matrices (they are a pure
    function of the SPS scaling lists; recomputing them per packed chunk
    cost more host time than the gathers they feed)."""
    cache = getattr(sps, "_heif_tpu_scaling_cache", None)
    if cache is None:
        from heif_tpu.ops.tables import scaling_factor_matrix

        lists = sps.effective_scaling_lists()
        cache = {
            (size, mid): scaling_factor_matrix(size, mid, lists)
            for size in (4, 8, 16, 32)
            for mid in range(3)
        }
        try:
            sps._heif_tpu_scaling_cache = cache
        except Exception:
            pass
    return cache


def pack_batch(
    syntaxes, sps, pps, slices, n_steps=None, class_caps=None
) -> BatchPlan:
    """Pack N tiles (same SPS/PPS geometry) into one BatchPlan.

    Fused columnwise pack: all N tiles' TU tables are concatenated (with
    a tile column) and every per-class / per-component tensor is built by
    ONE masked gather over the whole chunk, instead of per-tile packs
    plus concatenation. The host pack sits on the decode's critical path
    between entropy and dispatch.

    n_steps / class_caps: optional shared shape overrides so several
    chunks of one image compile to identical programs (see
    reconstruct_pipelined). class_caps maps (comp, size) -> padded block
    count; padding rows are all-zero (zero coeffs scatter zero residual
    at flat index 0, a no-op).
    """
    from heif_tpu.cabac import types as T
    from heif_tpu.ops.pack import _luma_filter_flags_vec

    n = len(syntaxes)
    st0 = syntaxes[0]
    H, W = st0.height, st0.width
    Hc, Wc = H // 2, W // 2

    if all(
        getattr(st, "packed", None) is not None and st.packed.pad == PAD
        for st in syntaxes
    ):
        xs, tc = _assemble_packed(
            syntaxes, n, H, W, n_steps, class_caps
        )
        tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org = tc
        return _finish_plan(
            syntaxes, sps, pps, slices, n, H, W,
            tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org, xs,
        )

    tts = [st.tu_table for st in syntaxes]
    lens = np.fromiter((t.shape[0] for t in tts), np.int64, n)
    tt = np.concatenate(tts)
    ti = np.repeat(np.arange(n, dtype=np.int32), lens)
    comp_col = tt[:, T.TU_COMP]

    # per-tile per-component TU counts (scan lengths)
    counts = (
        np.bincount(ti * 3 + comp_col, minlength=n * 3)
        .reshape(n, 3)
        .astype(np.int32)
    )
    if n_steps is None:
        n_steps = [max(1, -(-int(s) // 64) * 64) for s in counts.max(axis=0)]

    # ---- per-component pred scans: [n, S] field arrays ----
    xs = []
    for c in range(3):
        mask = comp_col == c
        rows = tt[mask]
        rti = ti[mask]
        cnt_c = counts[:, c].astype(np.int64)
        S = n_steps[c]
        assert S >= (int(cnt_c.max()) if n else 0)
        # rows are tile-major (concat order), z-order within each tile:
        # position of each row within its tile's scan
        starts = np.concatenate([[0], np.cumsum(cnt_c)[:-1]])
        pos = np.arange(rows.shape[0], dtype=np.int64) - np.repeat(
            starts, cnt_c
        )
        size_v = (1 << rows[:, T.TU_LOG2]).astype(np.int32)
        fields = []
        for col, vals in (
            (T.TU_X, None),
            (T.TU_Y, None),
            (None, size_v),
            (T.TU_PRED_MODE, None),
            ("filter", None),
            (T.TU_PCM, None),
        ):
            out = np.zeros((n, S), np.int32)
            if col == "filter":
                if c == 0 and rows.shape[0]:
                    out[rti, pos] = _luma_filter_flags_vec(
                        size_v, rows[:, T.TU_PRED_MODE]
                    )
            elif vals is not None:
                out[rti, pos] = vals
            else:
                out[rti, pos] = rows[:, col]
            fields.append(out)
        xs.append(tuple(fields))

    # ---- transform classes: one gather per (comp, size) over the chunk ----
    cbf_mask = (tt[:, T.TU_CBF] != 0) & (tt[:, T.TU_PCM] == 0)
    tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org = (
        {}, {}, {}, {}, {}, {},
    )
    for comp, size in CLASSES:
        log2 = size.bit_length() - 1
        mask = cbf_mask & (comp_col == comp) & (tt[:, T.TU_LOG2] == log2)
        k = int(mask.sum())
        cap = None if class_caps is None else class_caps.get((comp, size), 0)
        if not k and not cap:
            continue
        key = (comp, size)
        total = k if cap is None else cap
        assert k <= total, f"class {key}: {k} > cap {cap}"
        h = H if comp == 0 else Hc
        w = W if comp == 0 else Wc
        stride = (h + PAD) * (w + PAD)
        coeffs = np.zeros((total, size, size), np.int16)
        qp = np.zeros(total, np.int32)
        dst = np.full(total, comp == 0 and size == 4, dtype=bool)
        skip = np.zeros(total, bool)
        byp = np.zeros(total, bool)
        org = np.full(total, -1, np.int32)
        if k:
            rows = tt[mask]
            rti = ti[mask]
            ys = rows[:, T.TU_Y]
            xs_ = rows[:, T.TU_X]
            # gather blocks per tile from the ORIGINAL coeff planes (a
            # [n, h, w] stacked copy would be ~160 MB per 48-tile batch).
            # HEVC transform blocks are size-aligned in the quadtree, so a
            # strided block view turns the gather into contiguous
            # (size, size) row copies instead of 3-D fancy indexing
            from numpy.lib.stride_tricks import as_strided

            by = ys >> log2
            bx = xs_ >> log2
            bounds = np.searchsorted(rti, np.arange(n + 1, dtype=np.int32))
            for t in range(n):
                lo, hi = bounds[t], bounds[t + 1]
                if lo == hi:
                    continue
                pl = syntaxes[t].coeffs[comp]
                hh, ww = pl.shape
                r0, e0 = pl.strides
                bv = as_strided(
                    pl,
                    (hh // size, ww // size, size, size),
                    (size * r0, size * e0, r0, e0),
                )
                np.copyto(
                    coeffs[lo:hi], bv[by[lo:hi], bx[lo:hi]], casting="unsafe"
                )
            qp[:k] = rows[:, T.TU_QP]
            skip[:k] = rows[:, T.TU_SKIP] != 0
            byp[:k] = rows[:, T.TU_BYPASS] != 0
            org[:k] = (
                rti * np.int32(stride)
                + ys.astype(np.int32) * np.int32(w + PAD)
                + xs_.astype(np.int32)
            )
        tc_coeffs[key] = coeffs
        tc_qp[key] = qp
        tc_dst[key] = dst
        tc_skip[key] = skip
        tc_bypass[key] = byp
        tc_org[key] = org

    return _finish_plan(
        syntaxes, sps, pps, slices, n, H, W,
        tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org, xs,
    )


def _assemble_packed(syntaxes, n, H, W, n_steps, class_caps):
    """Assemble the BatchPlan tensors from native per-tile packs
    (st.packed, see native.pack_tile_native): pure segment memcpys, no
    per-TU work on this (GIL-holding) thread."""
    Hc, Wc = H // 2, W // 2
    packs = [st.packed for st in syntaxes]
    if n_steps is None:
        n_steps = [
            max(1, -(-max(p.scans[c].shape[1] for p in packs) // 64) * 64)
            for c in range(3)
        ]

    xs = []
    for c in range(3):
        S = n_steps[c]
        fields = [np.zeros((n, S), np.int32) for _ in range(6)]
        for i, p in enumerate(packs):
            sc = p.scans[c]
            m = sc.shape[1]
            assert m <= S
            for f in range(6):
                fields[f][i, :m] = sc[f]
        xs.append(tuple(fields))

    tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org = (
        {}, {}, {}, {}, {}, {},
    )
    for ci, (comp, size) in enumerate(CLASSES):
        ks = [int(p.cls_counts[ci]) for p in packs]
        k = sum(ks)
        cap = None if class_caps is None else class_caps.get((comp, size), 0)
        if not k and not cap:
            continue
        key = (comp, size)
        total = k if cap is None else cap
        assert k <= total, f"class {key}: {k} > cap {cap}"
        h = H if comp == 0 else Hc
        w = W if comp == 0 else Wc
        stride = (h + PAD) * (w + PAD)
        coeffs = np.zeros((total, size, size), np.int16)
        qp = np.zeros(total, np.int32)
        dst = np.full(total, comp == 0 and size == 4, dtype=bool)
        skip = np.zeros(total, bool)
        byp = np.zeros(total, bool)
        org = np.full(total, -1, np.int32)
        lo = 0
        for i, p in enumerate(packs):
            ki = ks[i]
            if not ki:
                continue
            blocks, meta = p.cls[ci]
            hi = lo + ki
            coeffs[lo:hi] = blocks
            qp[lo:hi] = meta[0]
            skip[lo:hi] = meta[1]
            byp[lo:hi] = meta[2]
            np.add(meta[3], np.int32(i * stride), out=org[lo:hi])
            lo = hi
        tc_coeffs[key] = coeffs
        tc_qp[key] = qp
        tc_dst[key] = dst
        tc_skip[key] = skip
        tc_bypass[key] = byp
        tc_org[key] = org
    return xs, (tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org)


def _finish_plan(
    syntaxes, sps, pps, slices, n, H, W,
    tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org, xs,
):
    Hc, Wc = H // 2, W // 2
    # ---- PCM sample planes ----
    # presence comes from the PCM block map, NOT from sample values: a
    # pure-black PCM block (all-zero luma samples) is still PCM and must
    # ship its planes
    any_pcm = any(st.pcm_map.any() for st in syntaxes)
    pcm = []
    for c in range(3):
        h = H if c == 0 else Hc
        w = W if c == 0 else Wc
        if any_pcm:
            arr = np.zeros((n, h + PAD, w + PAD), dtype=np.int32)
            for i, st in enumerate(syntaxes):
                arr[i, :h, :w] = st.pcm_planes[c]
            pcm.append(arr)
        else:
            pcm.append(None)

    # ---- loop-filter metadata ----
    nf_map = np.stack([st.bypass_map for st in syntaxes]).copy()
    if sps.pcm_enabled_flag and sps.pcm_loop_filter_disabled_flag:
        nf_map |= np.stack([st.pcm_map for st in syntaxes])

    # ---- tiles: §6.4.1 availability bounds + boundary deblock ----
    tile_col_bd: tuple = ()
    tile_row_bd: tuple = ()
    vert_edges = np.stack([st.vert_edges for st in syntaxes])
    horiz_edges = np.stack([st.horiz_edges for st in syntaxes])
    if pps.tiles_enabled_flag:
        col_bd, row_bd = pps.tile_bounds(sps)
        cl = sps.ctb_log2_size_y
        tile_col_bd = tuple(b << cl for b in col_bd[1:-1])
        tile_row_bd = tuple(b << cl for b in row_bd[1:-1])
        if not pps.loop_filter_across_tiles_enabled_flag:
            # suppress deblocking of edges ON interior tile boundaries
            # (edge maps are on the 4-sample grid), mirroring
            # ref_recon.reconstruct_tile
            vert_edges = vert_edges.copy()
            horiz_edges = horiz_edges.copy()
            for b in tile_col_bd:
                vert_edges[:, :, b >> 2] = False
            for b in tile_row_bd:
                horiz_edges[:, b >> 2, :] = False

    sh = slices[0].header
    return BatchPlan(
        n=n,
        width=W,
        height=H,
        tc_coeffs=tc_coeffs,
        tc_qp=tc_qp,
        tc_dst=tc_dst,
        tc_skip=tc_skip,
        tc_bypass=tc_bypass,
        tc_org=tc_org,
        scaling=_scaling_for_sps(sps),
        xs=xs,
        pcm=pcm,
        qp_map=np.stack([st.qp_y for st in syntaxes]).astype(np.int32),
        nf_map=nf_map,
        vert_edges=vert_edges,
        horiz_edges=horiz_edges,
        sao=np.stack([st.sao for st in syntaxes]).astype(np.int32),
        ctb_log2=sps.ctb_log2_size_y,
        deblock_disabled=sh.slice_deblocking_filter_disabled_flag,
        sao_luma=sh.slice_sao_luma_flag,
        sao_chroma=sh.slice_sao_chroma_flag,
        beta_off=sh.slice_beta_offset_div2 * 2,
        tc_off=sh.slice_tc_offset_div2 * 2,
        cb_qp_off=pps.pps_cb_qp_offset,
        cr_qp_off=pps.pps_cr_qp_offset,
        strong_smoothing=bool(sps.strong_intra_smoothing_enabled_flag),
        bit_depth_y=sps.bit_depth_y,
        bit_depth_c=sps.bit_depth_c,
        tile_col_bd=tile_col_bd,
        tile_row_bd=tile_row_bd,
    )



# --------------------------------------------------------------------------
# jitted core
# --------------------------------------------------------------------------


def _core(
    tc_arrays,  # dict (comp,size) -> (coeffs, qp, dst, skip, bypass, org)
    scaling,  # dict (size, comp) -> matrix
    xs,  # list of 3 tuples of [N, S, ...]
    pcm,  # list of 3 ([N,h+PAD,w+PAD] or None)
    qp_map, nf_map, vert_edges, horiz_edges, sao,
    *,
    n, H, W, ctb_log2, deblock_disabled, sao_luma, sao_chroma,
    beta_off, tc_off, cb_qp_off, cr_qp_off, strong_smoothing,
    bd_y=8, bd_c=8, tile_col_bd=(), tile_row_bd=(),
):
    Hc, Wc = H // 2, W // 2
    dims = [(H, W), (Hc, Wc), (Hc, Wc)]

    # ---- stage 1: residuals ----
    with jax.named_scope("residuals"):
        # TUs are size-aligned (HEVC quadtree), so each (comp, size) class maps
        # onto a dense [n*gh*gw, size*size] slot grid: a unique-row set() of
        # whole blocks instead of an element-wise scatter-add, then
        # depth-to-space. Classes never overlap, so the per-class planes
        # just add.
        res_dense = [jnp.zeros((n, h, w), jnp.int32) for h, w in dims]
        for (comp, size), (coeffs, qp, dst, skip, bypass, org) in tc_arrays.items():
            r = J.residual_class(
                coeffs, qp, dst, skip, bypass, scaling[(size, comp)], size,
                bd_y if comp == 0 else bd_c,
            )
            h, w = dims[comp]
            gh, gw = h // size, w // size
            # recover (tile, oy, ox) from the wire-format flat origin
            stride = (h + PAD) * (w + PAD)
            ti = org // stride
            rem = org % stride
            oy = rem // (w + PAD)
            ox = rem % (w + PAD)
            slot = ti * (gh * gw) + (oy // size) * gw + (ox // size)
            # cap-padding rows (org < 0) land on a dummy trailing slot
            slot = jnp.where(org < 0, n * gh * gw, slot)
            grid = jnp.zeros((n * gh * gw + 1, size * size), jnp.int32)
            grid = grid.at[slot].set(r.reshape(-1, size * size))
            plane = (
                grid[: n * gh * gw]
                .reshape(n, gh, gw, size, size)
                .transpose(0, 1, 3, 2, 4)
                .reshape(n, h, w)
            )
            res_dense[comp] = res_dense[comp] + plane
        res = [
            jnp.pad(res_dense[c], ((0, 0), (0, PAD), (0, PAD))) for c in range(3)
        ]

    # ---- stage 2: intra scans ----
    with jax.named_scope("intra"):
        # reference-source tables computed on device (ships ~50 B of scalars
        # per TU over the host link instead of the 130-byte uint8 table).
        # Cb and Cr share TU geometry and intra mode (HEVC signals one
        # intra_chroma_pred_mode per PU), so one chroma src table serves both.
        srcs = [
            J.ref_sources_device(
                xs[c][0], xs[c][1], xs[c][2],
                comp=c, W=W, H=H, ctb_log2=ctb_log2,
                tile_col_bd=tile_col_bd, tile_row_bd=tile_row_bd,
            )
            for c in range(2)
        ]
        srcs.append(srcs[1])  # Cr reuses the Cb table
        planes = []
        for c in range(3):
            h, w = dims[c]
            pcm_c = (
                pcm[c]
                if pcm[c] is not None
                else jnp.zeros((n, h + PAD, w + PAD), jnp.int32)
            )
            plane0 = jnp.zeros((n, 1 + h + J.SPAD, 1 + w + J.SPAD), jnp.int32)
            scan_fn = partial(
                J.intra_scan_component,
                is_luma=(c == 0),
                strong_smoothing=strong_smoothing,
                bd=bd_y if c == 0 else bd_c,
            )
            plane = jax.vmap(scan_fn)(plane0, res[c], pcm_c, xs[c] + (srcs[c],))
            planes.append(plane[:, 1 : 1 + h, 1 : 1 + w])

    # ---- stage 3: deblock ----
    with jax.named_scope("deblock"):
        if not deblock_disabled:
            # vertical edges index by W, the transposed (horizontal) pass by
            # H — distinct for non-square pictures (using W for both crashed
            # any non-square picture through the batched path)
            cols = 2 * jnp.arange(W // 8 - 1) + 2
            rows = 2 * jnp.arange(H // 8 - 1) + 2
            lv = jax.vmap(
                partial(
                    J._deblock_luma_pass, beta_off=beta_off, tc_off=tc_off,
                    bd=bd_y,
                )
            )
            y = lv(
                planes[0],
                vert_edges[:, :, cols],
                qp_map[:, :, cols - 1],
                qp_map[:, :, cols],
                nf_map[:, :, cols - 1],
                nf_map[:, :, cols],
            )
            qT = jnp.swapaxes(qp_map, 1, 2)
            nT = jnp.swapaxes(nf_map, 1, 2)
            hT = jnp.swapaxes(horiz_edges, 1, 2)
            y = jnp.swapaxes(
                lv(
                    jnp.swapaxes(y, 1, 2),
                    hT[:, :, rows],
                    qT[:, :, rows - 1],
                    qT[:, :, rows],
                    nT[:, :, rows - 1],
                    nT[:, :, rows],
                ),
                1, 2,
            )
            planes[0] = y

            ccols = 4 * jnp.arange(Wc // 8 - 1) + 4
            crows = 4 * jnp.arange(Hc // 8 - 1) + 4
            cv = jax.vmap(
                partial(J._deblock_chroma_pass, tc_off=tc_off, bd=bd_c)
            )
            for ci, c_off in ((1, cb_qp_off), (2, cr_qp_off)):
                qp_avg = (qp_map[:, :, ccols - 1] + qp_map[:, :, ccols] + 1) >> 1
                qpc = J._onehot_take(J._CHROMA_QP_LUT, jnp.clip(qp_avg + c_off, 0, 57), 58)
                p = cv(
                    planes[ci],
                    vert_edges[:, :, ccols],
                    qpc,
                    nf_map[:, :, ccols - 1],
                    nf_map[:, :, ccols],
                )
                qp_avgT = (qT[:, :, crows - 1] + qT[:, :, crows] + 1) >> 1
                qpcT = J._onehot_take(J._CHROMA_QP_LUT, jnp.clip(qp_avgT + c_off, 0, 57), 58)
                p = jnp.swapaxes(
                    cv(
                        jnp.swapaxes(p, 1, 2),
                        hT[:, :, crows],
                        qpcT,
                        nT[:, :, crows - 1],
                        nT[:, :, crows],
                    ),
                    1, 2,
                )
                planes[ci] = p

    # ---- stage 4: SAO ----
    with jax.named_scope("sao"):
        if sao_luma or sao_chroma:
            out = []
            for c in range(3):
                sv = jax.vmap(
                    partial(J.sao_component, bd=bd_y if c == 0 else bd_c)
                )
                enabled = sao_luma if c == 0 else sao_chroma
                if not enabled:
                    out.append(planes[c])
                    continue
                sub = 1 if c == 0 else 2
                cs = (1 << ctb_log2) // sub
                h, w = dims[c]

                def rep(a):
                    return jnp.repeat(jnp.repeat(a, cs, 1), cs, 2)[:, :h, :w]

                stype = rep(sao[:, :, :, c, 0])
                sclass = rep(sao[:, :, :, c, 1])
                offs = jnp.stack(
                    [rep(sao[:, :, :, c, 2 + i]) for i in range(4)], axis=-1
                )
                nf_pix = jnp.repeat(jnp.repeat(nf_map, 4 // sub, 1), 4 // sub, 2)[
                    :, :h, :w
                ]
                out.append(sv(planes[c], stype, sclass, offs, nf_pix))
            planes = out

    out_dt = jnp.uint8 if max(bd_y, bd_c) <= 8 else jnp.uint16
    return [p.astype(out_dt) for p in planes]


_core_jit = jax.jit(
    _core,
    static_argnames=(
        "n", "H", "W", "ctb_log2", "deblock_disabled", "sao_luma", "sao_chroma",
        "beta_off", "tc_off", "cb_qp_off", "cr_qp_off", "strong_smoothing",
        "bd_y", "bd_c", "tile_col_bd", "tile_row_bd",
    ),
)


def schedule_hints(rec, sps, pps, n_tiles: int) -> dict:
    """Scheduler inputs from the stream's declared parallelism hints
    (SURVEY.md §2.2 'stream hints' row; the reference parses these at
    src/hevc/grammar.rs:186-191 and never uses them).

    rec: container hvcC record (or None for raw streams). Returns
    {chunk, entropy_workers, parallelism_type,
    min_spatial_segmentation_idc}, consumed by the decode orchestrator
    and recorded in DecodeStats.scheduler.
    """
    import os as _os

    ptype = getattr(rec, "parallelism_type", 0) if rec else 0
    mss = getattr(rec, "min_spatial_segmentation_idc", 0) if rec else 0
    ncpu = _os.cpu_count() or 2
    # WPP (declared via ptype 3, or authoritative in the PPS) means each
    # tile's CTB rows entropy-decode in parallel substreams, so worker
    # threads can exceed the tile count; without it, tiles are the only
    # parallel axis.
    wpp = ptype == 3 or bool(
        getattr(pps, "entropy_coding_sync_enabled_flag", False)
    )
    rows = max(int(getattr(sps, "pic_height_in_ctbs_y", 1)), 1)
    if wpp:
        workers = min(max(n_tiles, 1) * rows, ncpu)
    else:
        workers = min(max(n_tiles, 1), ncpu)
    # min_spatial_segmentation_idc bounds the smallest independently
    # decodable region (ISO 14496-15 §A.3.2: segment <= 4*PicSize/
    # (mss+4) luma samples): a declared segment at most HALF the
    # picture means real sub-picture segmentation exists, so finer
    # pipelining pays — use smaller chunks so the first device dispatch
    # starts earlier. (mss <= 4 declares no sub-picture bound: the
    # formula only drops below PicSize/2 past idc 4.)
    # idc > 4 bounds segments to at most 4*PicSize/9 < PicSize/2 luma
    # samples — real sub-picture segmentation, so finer pipelining pays
    chunk = 16 if mss <= 4 else 8
    return {
        "chunk": chunk,
        "entropy_workers": workers,
        "parallelism_type": ptype,
        "min_spatial_segmentation_idc": mss,
    }


# coefficient exception cap per chunk for the int8/sparse8 wire formats:
# levels with |v| > 127 ship as (flat index, value) pairs. 4096 is ~300x
# the count observed on the flagship image; streams exceeding it fall
# back to the plain int16 format (a per-layout flag, so the compiled
# program count stays bounded).
_EXC_CAP = 4096


def _sparse_val_cap(n_coeff: int) -> int:
    """Nonzero-value capacity of the sparse8 coefficient mode: a fixed
    3/16 of the samples (real content runs ~13% nonzero), rounded so the
    cap — and with it the compiled program shape — is a pure function of
    the class layout. Denser chunks fall back to the i8 mode."""
    return -(-(3 * n_coeff) // 16) if n_coeff else 0


def _bundle_plan(bp: BatchPlan):
    """Flatten the whole BatchPlan into three dtype-homogeneous blobs.

    A plan is ~46 arrays per chunk; three blobs plus an optional PCM
    blob cut the host->device transfer count ~15x, and the jitted
    wrapper re-slices them with static offsets (free under XLA fusion).

    The wire format is additionally size-optimized:
      - coefficients ship as a significance bitmap + densely packed int8
        values (cap 3/16 of samples) + a sparse exception list for
        |v|>127 (~0.0004% of samples on real content); int8 / int16
        fallbacks per chunk when the caps overflow
      - per-TU scan fields pack into 1 int32 (x|y) + 1 int16 (meta bits)
      - per-block qp+org pack into 1 int32 (org+1 in the high bits); the
        DST flag is not shipped at all (it is a pure function of the
        class: 4x4 luma intra)
      - qp_map ships as int8; the three boolean CTB maps (no-filter,
        vert/horiz edges) ship as packed bits
    Every call allocates fresh blobs: the device arrays made from them
    may alias host memory (the CPU backend does not copy), so a blob must
    never be rewritten while a chunk that reads it is in flight.

    Returns (b16, b32, b8, pcm_blob_or_None, layout) with `layout`
    hashable (it is a static jit argument).
    """
    keys = tuple(sorted(bp.tc_coeffs.keys()))
    cls_layout = tuple(
        (k[0], k[1], int(bp.tc_coeffs[k].shape[0])) for k in keys
    )
    ns = tuple(int(bp.xs[c][0].shape[1]) for c in range(3))
    n = bp.n
    qp_n = int(np.prod(bp.qp_map.shape))
    sao_n = int(np.prod(bp.sao.shape))
    skeys = tuple(sorted(bp.scaling.keys()))
    n_coeff = sum(t * s * s for _, s, t in cls_layout)
    val_cap = _sparse_val_cap(n_coeff)
    map_bytes = -(-qp_n // 8)

    # ---- flatten coefficients into a scratch + classify mode ----
    cf = np.empty(n_coeff, np.int16)
    off = 0
    for k in keys:
        a = bp.tc_coeffs[k].reshape(-1)
        cf[off : off + a.size] = a
        off += a.size
    nzb = np.empty(n_coeff, np.bool_)
    np.not_equal(cf, 0, out=nzb)
    nnz = int(np.count_nonzero(nzb))
    excb = np.empty(n_coeff, np.bool_)
    np.greater(cf, 127, out=excb)
    small = np.empty(n_coeff, np.bool_)
    np.less(cf, -128, out=small)
    np.logical_or(excb, small, out=excb)
    exc_idx = np.flatnonzero(excb)
    if exc_idx.size <= _EXC_CAP and nnz <= val_cap and n_coeff:
        coeff_mode = "sparse8"
    elif exc_idx.size <= _EXC_CAP:
        coeff_mode = "i8"
    else:
        coeff_mode = "i16"

    # qp (7 bits) | org+1 (high bits) packs into int32 only while
    # org+1 < 2^25 (~33.5M padded samples per plane per chunk); larger
    # geometries ship qp and org as separate words (layout flag) instead
    # of silently wrapping
    max_org = max(
        (int(bp.tc_org[k].max(initial=-1)) for k in keys), default=-1
    )
    pack_qporg = max_org + 1 < (1 << 25)

    # ---- compute blob sizes, grab pooled buffers ----
    n_blocks = sum(t for _, _, t in cls_layout)
    n_scan = sum(n * ns[c] for c in range(3))
    sz16 = (n_coeff if coeff_mode == "i16" else 0) + sao_n + n_scan
    sz32 = (
        (2 * _EXC_CAP if coeff_mode != "i16" else 0)
        + n_blocks * (1 if pack_qporg else 2)
        + n_scan
        + sum(sk[0] * sk[0] for sk in skeys)
    )
    sz8 = (
        (-(-n_coeff // 8) + val_cap if coeff_mode == "sparse8" else 0)
        + (n_coeff if coeff_mode == "i8" else 0)
        + 2 * n_blocks
        + qp_n
        + 3 * map_bytes
    )
    b16 = np.empty(sz16, np.int16)
    b32 = np.empty(sz32, np.int32)
    b8 = np.empty(sz8, np.uint8)
    o16 = o32 = o8 = 0

    # ---- b16/b32/b8 fills, in the exact order _core_blobs reads ----
    if coeff_mode == "i16":
        b16[:n_coeff] = cf
        o16 = n_coeff
    elif coeff_mode == "sparse8":
        nbytes = -(-n_coeff // 8)
        b8[:nbytes] = np.packbits(nzb)  # MSB-first, zero-padded
        o8 = nbytes
        vals16 = np.empty(n_coeff, np.int16)
        np.compress(nzb, cf, out=vals16[:nnz])
        np.clip(vals16[:nnz], -128, 127, out=vals16[:nnz])
        seg = b8[o8 : o8 + val_cap].view(np.int8)
        np.copyto(seg[:nnz], vals16[:nnz], casting="unsafe")
        seg[nnz:] = 0
        o8 += val_cap
    else:  # i8
        seg = b8[:n_coeff].view(np.int8)
        vals16 = np.empty(n_coeff, np.int16)
        np.clip(cf, -128, 127, out=vals16)
        np.copyto(seg, vals16, casting="unsafe")
        o8 = n_coeff
    if coeff_mode != "i16":
        # padding exceptions point one past the end (dropped on device)
        b32[o32 : o32 + _EXC_CAP] = n_coeff
        b32[o32 : o32 + exc_idx.size] = exc_idx
        o32 += _EXC_CAP
        b32[o32 : o32 + _EXC_CAP] = 0
        b32[o32 : o32 + exc_idx.size] = cf[exc_idx]
        o32 += _EXC_CAP

    for k in keys:
        t = bp.tc_qp[k].shape[0]
        if pack_qporg:
            # org == -1 padding -> 0 in the high bits
            np.copyto(
                b32[o32 : o32 + t],
                (bp.tc_org[k].astype(np.int64) + 1) << 7 | bp.tc_qp[k],
                casting="unsafe",
            )
            o32 += t
        else:
            b32[o32 : o32 + t] = bp.tc_qp[k]
            o32 += t
            b32[o32 : o32 + t] = bp.tc_org[k]
            o32 += t
        b8[o8 : o8 + t] = bp.tc_skip[k].view(np.uint8)
        o8 += t
        b8[o8 : o8 + t] = bp.tc_bypass[k].view(np.uint8)
        o8 += t

    b16[o16 : o16 + sao_n] = np.ascontiguousarray(
        bp.sao, dtype=np.int16
    ).reshape(-1)
    o16 += sao_n
    for c in range(3):
        m = n * ns[c]
        x, y, size, mode, filt, pcm_f = (bp.xs[c][f] for f in range(6))
        np.copyto(
            b32[o32 : o32 + m].reshape(n, ns[c]),
            x | (y << 16),
            casting="unsafe",
        )
        o32 += m
        # size in {0,4,8,16,32} -> log2-2 in {0..3}; bit 10 marks the
        # active (size > 0) steps
        log2m2 = (
            (size == 8) * 1 + (size == 16) * 2 + (size == 32) * 3
        )
        np.copyto(
            b16[o16 : o16 + m].reshape(n, ns[c]),
            log2m2
            | (mode << 2)
            | (filt << 8)
            | (pcm_f << 9)
            | ((size > 0) << 10),
            casting="unsafe",
        )
        o16 += m
    np.copyto(
        b8[o8 : o8 + qp_n].view(np.int8),
        bp.qp_map.reshape(-1),
        casting="unsafe",
    )
    o8 += qp_n
    for mp in (bp.nf_map, bp.vert_edges, bp.horiz_edges):
        b8[o8 : o8 + map_bytes] = np.packbits(mp.reshape(-1))
        o8 += map_bytes
    for sk in skeys:
        m = sk[0] * sk[0]
        b32[o32 : o32 + m] = bp.scaling[sk].reshape(-1)
        o32 += m
    assert o16 == sz16 and o32 == sz32 and o8 == sz8
    pcm_blob = None
    if any(p is not None for p in bp.pcm):
        pcm_blob = np.concatenate([p.reshape(-1) for p in bp.pcm])
    layout = (cls_layout, ns, bp.qp_map.shape, bp.sao.shape, skeys,
              pcm_blob is not None, coeff_mode, pack_qporg,
              bp.tile_col_bd, bp.tile_row_bd)
    return (b16, b32, b8, pcm_blob, layout)


def _core_blobs(
    b16, b32, b8, pcm_blob, *, layout, n, H, W, ctb_log2,
    deblock_disabled, sao_luma, sao_chroma, beta_off, tc_off,
    cb_qp_off, cr_qp_off, strong_smoothing, bd_y, bd_c,
):
    """Unbundle the three plan blobs (static offsets) and run _core."""
    (cls_layout, ns, qp_shape, sao_shape, skeys, has_pcm, coeff_mode,
     pack_qporg, tile_col_bd, tile_row_bd) = layout
    Hc, Wc = H // 2, W // 2
    o16 = o32 = o8 = 0

    def take16(m):
        nonlocal o16
        out = lax.slice(b16, (o16,), (o16 + m,))
        o16 += m
        return out

    def take32(m):
        nonlocal o32
        out = lax.slice(b32, (o32,), (o32 + m,))
        o32 += m
        return out

    def take8(m):
        nonlocal o8
        out = lax.slice(b8, (o8,), (o8 + m,))
        o8 += m
        return out

    def unpack_bits(bm, count):
        # unpack MSB-first (numpy packbits order)
        return (
            (bm[:, None] >> (7 - jnp.arange(8, dtype=jnp.uint8)[None, :]))
            & 1
        ).reshape(-1)[:count]

    # ---- coefficients: sparse8 (bitmap + packed values), int8, int16 ----
    n_coeff = sum(total * size * size for _, size, total in cls_layout)
    if coeff_mode == "sparse8":
        nbytes = -(-n_coeff // 8)
        bits = unpack_bits(take8(nbytes), n_coeff).astype(jnp.int32)
        val_cap = _sparse_val_cap(n_coeff)
        vals = lax.bitcast_convert_type(take8(val_cap), jnp.int8).astype(
            jnp.int32
        )
        rank = jnp.cumsum(bits) - 1
        base = jnp.where(
            bits > 0, vals[jnp.clip(rank, 0, val_cap - 1)], 0
        )
        exc_i = take32(_EXC_CAP)
        exc_v = take32(_EXC_CAP)
        coeff_flat = (
            jnp.concatenate([base, jnp.zeros(1, jnp.int32)])
            .at[exc_i]
            .set(exc_v)[:n_coeff]
        )
    elif coeff_mode == "i8":
        c8 = lax.bitcast_convert_type(take8(n_coeff), jnp.int8)
        exc_i = take32(_EXC_CAP)
        exc_v = take32(_EXC_CAP)
        # padding exceptions point one past the end (dropped by the slice)
        coeff_flat = (
            jnp.concatenate([c8.astype(jnp.int32), jnp.zeros(1, jnp.int32)])
            .at[exc_i]
            .set(exc_v)[:n_coeff]
        )
    else:
        coeff_flat = take16(n_coeff).astype(jnp.int32)

    tc_arrays = {}
    metas = []
    oc = 0
    for comp, size, total in cls_layout:
        m = total * size * size
        coeffs = lax.slice(coeff_flat, (oc,), (oc + m,)).reshape(
            total, size, size
        )
        oc += m
        metas.append(coeffs)
    for i, (comp, size, total) in enumerate(cls_layout):
        if pack_qporg:
            qporg = take32(total)
            qp = qporg & 127
            org = (
                (qporg.astype(jnp.uint32) >> 7).astype(jnp.int32) - 1
            )
        else:
            qp = take32(total)
            org = take32(total)
        skip = take8(total).astype(jnp.bool_)
        byp = take8(total).astype(jnp.bool_)
        # DST vs DCT is a pure function of the class: 4x4 luma intra TBs
        # use the DST (H.265 §8.6.4); nothing on the wire
        dst = jnp.full((total,), comp == 0 and size == 4, jnp.bool_)
        tc_arrays[(comp, size)] = (metas[i], qp, dst, skip, byp, org)
    sao = take16(int(np.prod(sao_shape))).astype(jnp.int32).reshape(sao_shape)
    xs = []
    for c in range(3):
        xy = take32(n * ns[c]).reshape(n, ns[c])
        meta = take16(n * ns[c]).reshape(n, ns[c]).astype(jnp.int32)
        x = xy & 0xFFFF
        y = (xy.astype(jnp.uint32) >> 16).astype(jnp.int32)
        active = (meta >> 10) & 1
        log2 = ((meta & 3) + 2) * active
        size = active << log2  # 0 when inactive, else 4/8/16/32
        mode = (meta >> 2) & 63
        filt = (meta >> 8) & 1
        pcm_f = (meta >> 9) & 1
        xs.append((x, y, size, mode, filt, pcm_f))
    qp_n = int(np.prod(qp_shape))
    map_bytes = -(-qp_n // 8)
    qp_map = (
        lax.bitcast_convert_type(take8(qp_n), jnp.int8)
        .astype(jnp.int32)
        .reshape(qp_shape)
    )
    nf_map = (
        unpack_bits(take8(map_bytes), qp_n).reshape(qp_shape).astype(jnp.bool_)
    )
    vert = (
        unpack_bits(take8(map_bytes), qp_n).reshape(qp_shape).astype(jnp.bool_)
    )
    horiz = (
        unpack_bits(take8(map_bytes), qp_n).reshape(qp_shape).astype(jnp.bool_)
    )
    scaling = {}
    for sk in skeys:
        size = sk[0]
        scaling[sk] = take32(size * size).reshape(size, size)
    pcm = [None, None, None]
    if has_pcm:
        op = 0
        for c, (h, w) in enumerate(((H, W), (Hc, Wc), (Hc, Wc))):
            m = n * (h + PAD) * (w + PAD)
            pcm[c] = lax.slice(pcm_blob, (op,), (op + m,)).reshape(
                n, h + PAD, w + PAD
            )
            op += m
    return _core(
        tc_arrays, scaling, xs, pcm,
        qp_map, nf_map, vert, horiz, sao,
        n=n, H=H, W=W, ctb_log2=ctb_log2,
        deblock_disabled=deblock_disabled,
        sao_luma=sao_luma, sao_chroma=sao_chroma,
        beta_off=beta_off, tc_off=tc_off,
        cb_qp_off=cb_qp_off, cr_qp_off=cr_qp_off,
        strong_smoothing=strong_smoothing,
        bd_y=bd_y, bd_c=bd_c,
        tile_col_bd=tile_col_bd, tile_row_bd=tile_row_bd,
    )


_core_blobs_jit = jax.jit(
    _core_blobs,
    static_argnames=(
        "layout", "n", "H", "W", "ctb_log2", "deblock_disabled",
        "sao_luma", "sao_chroma", "beta_off", "tc_off", "cb_qp_off",
        "cr_qp_off", "strong_smoothing", "bd_y", "bd_c",
    ),
)


def core_inputs(bp: BatchPlan):
    """(args, static kwargs) of the jitted core for one plan: the wire
    blobs placed on the default device, and the plan's static scalars."""
    b16, b32, b8, pcm_blob, layout = _bundle_plan(bp)
    args = (
        jnp.asarray(b16),
        jnp.asarray(b32),
        jnp.asarray(b8),
        jnp.asarray(pcm_blob)
        if pcm_blob is not None
        else jnp.zeros(0, jnp.int32),
    )
    static = dict(
        layout=layout,
        n=bp.n, H=bp.height, W=bp.width, ctb_log2=bp.ctb_log2,
        deblock_disabled=bp.deblock_disabled,
        sao_luma=bp.sao_luma, sao_chroma=bp.sao_chroma,
        beta_off=bp.beta_off, tc_off=bp.tc_off,
        cb_qp_off=bp.cb_qp_off, cr_qp_off=bp.cr_qp_off,
        strong_smoothing=bp.strong_smoothing,
        bd_y=bp.bit_depth_y, bd_c=bp.bit_depth_c,
    )
    return args, static


def compile_core(bp: BatchPlan):
    """Ahead-of-time compile of the core program `bp` runs (for its
    memory_analysis() and cost_analysis())."""
    args, static = core_inputs(bp)
    return _core_blobs_jit.lower(*args, **static).compile()


def _dispatch_core(bp: BatchPlan):
    """Launch the jitted core asynchronously; returns device plane arrays."""
    args, static = core_inputs(bp)
    return _core_blobs_jit(*args, **static)


def _chunk_shapes(syntaxes, chunk: int):
    """Shared (n_steps, class_caps) over all chunks of a tile list, so
    every chunk hits the same compiled program."""
    n = len(syntaxes)
    n_chunks = -(-n // chunk)
    steps = np.zeros((n_chunks, 3), np.int64)
    caps: dict = {}
    per_chunk: list[dict] = [dict() for _ in range(n_chunks)]
    for i, st in enumerate(syntaxes):
        ci = i // chunk
        from heif_tpu.cabac import types as T

        tt = st.tu_table
        cnt = np.bincount(tt[:, T.TU_COMP], minlength=3)
        steps[ci] = np.maximum(steps[ci], cnt)
        live = (tt[:, T.TU_CBF] != 0) & (tt[:, T.TU_PCM] == 0)
        key = tt[live, T.TU_COMP] * 8 + tt[live, T.TU_LOG2]
        kc = np.bincount(key, minlength=48)
        d = per_chunk[ci]
        for comp in range(3):
            for log2 in range(2, 6):
                c = int(kc[comp * 8 + log2])
                if c:
                    k = (comp, 1 << log2)
                    d[k] = d.get(k, 0) + c
    n_steps = [max(1, -(-int(s) // 64) * 64) for s in steps.max(axis=0)]
    for d in per_chunk:
        for k, v in d.items():
            caps[k] = max(caps.get(k, 0), v)
    # round caps up to limit distinct compiled shapes across images
    caps = {k: -(-v // 256) * 256 for k, v in caps.items()}
    return n_steps, caps


def plan_chunks(syntaxes, sps, pps, slices, chunk: int = 12):
    """Pack a tile list into BatchPlans of `chunk` tiles that all share
    one compiled program shape (the last chunk is padded by repeating its
    final tile). A list of at most `chunk` tiles is one unpadded plan."""
    n = len(syntaxes)
    if n <= chunk:
        yield pack_batch(syntaxes, sps, pps, slices)
        return
    pad = (-n) % chunk
    if pad:
        syntaxes = list(syntaxes) + [syntaxes[-1]] * pad
        slices = list(slices) + [slices[-1]] * pad
    n_steps, caps = _chunk_shapes(syntaxes, chunk)
    for lo in range(0, len(syntaxes), chunk):
        yield pack_batch(
            syntaxes[lo : lo + chunk],
            sps, pps,
            slices[lo : lo + chunk],
            n_steps=n_steps,
            class_caps=caps,
        )


def reconstruct_pipelined(
    syntaxes, sps, pps, slices, chunk: int = 12
) -> list:
    """Chunked decode pipeline: host packing of chunk k+1 overlaps device
    compute of chunk k, and device->host plane readback overlaps both.
    All chunks share one compiled program shape. Returns [Y, Cb, Cr]
    stacked numpy planes."""
    outs = []
    for bp in plan_chunks(syntaxes, sps, pps, slices, chunk):
        planes = _dispatch_core(bp)  # async dispatch
        for p in planes:
            p.copy_to_host_async()
        outs.append(planes)
    n = len(syntaxes)
    return [
        np.concatenate([np.asarray(o[c]) for o in outs], axis=0)[:n]
        for c in range(3)
    ]


# sticky per-geometry shape cache: grown monotonically so every chunk of
# every image with the same tile geometry converges on ONE compiled program
# (warmup absorbs the growth recompiles; steady state is a single shape).
# Bounded: oldest geometry evicted past _STICKY_MAX distinct keys, and
# reset_shape_cache() drops everything (e.g. after one outlier image has
# inflated the caps for a long-running service).
_sticky_shapes: dict = {}
_STICKY_MAX = 32


def reset_shape_cache() -> None:
    """Drop all sticky batch shapes (next decode re-derives minimal caps)."""
    _sticky_shapes.clear()


def _merge_sticky(key, n_steps, caps):
    prev = _sticky_shapes.get(key)
    if prev is not None:
        pn, pc = prev
        n_steps = [max(a, b) for a, b in zip(n_steps, pn)]
        merged = dict(pc)
        for k, v in caps.items():
            merged[k] = max(merged.get(k, 0), v)
        caps = merged
    elif len(_sticky_shapes) >= _STICKY_MAX:
        _sticky_shapes.pop(next(iter(_sticky_shapes)))
    _sticky_shapes[key] = (n_steps, dict(caps))
    return n_steps, caps


@jax.jit
def _flatten_jit(y, cb, cr):
    """Concatenate decoded planes into one linear buffer for D2H."""
    return jnp.concatenate(
        [y.reshape(-1), cb.reshape(-1), cr.reshape(-1)]
    )


def decode_reconstruct_overlapped(
    sps, pps, slices, entropy_fn=None, chunk: int | None = None,
    readback: bool = True, stats=None, hints: dict | None = None,
) -> list:
    """Full tile decode with host entropy overlapped against device compute.

    Entropy (C++ CABAC, threaded) for chunk k+1 runs on a background
    thread while chunk k is packed and dispatched to the device; plane
    readback is async and overlaps everything after the first chunk.
    chunk=None takes the stream hints' chunk (schedule_hints), 16 tiles
    unless the stream declares sub-picture segmentation.
    Returns [Y, Cb, Cr] stacked numpy planes for all N tiles; with
    readback=False, returns the per-chunk device arrays instead
    (list of [y, cb, cr] jax arrays — the decode-to-device serving path).

    stats: optional DecodeStats; records per-stage attribution:
      entropy (worker-thread wall across chunks), entropy_wait (main
      thread blocked on entropy), pack, dispatch (bundle + H2D + jit
      enqueue), readback (D2H drain). Overlapped stages sum to more than
      the wall time by design.
    """
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    from heif_tpu import native

    if hints is None:
        hints = schedule_hints(None, sps, pps, len(slices))
    if stats is not None:
        stats.scheduler = hints
    if entropy_fn is None:
        if native.available():
            # pack_pad=PAD: the native path also pre-packs each tile
            # (class blocks + scan fields) inside the entropy worker
            # threads, so pack_batch reduces to segment memcpys
            workers = hints.get("entropy_workers")
            entropy_fn = lambda ps: native.decode_tiles_parallel(
                sps, pps, ps, pack_pad=PAD, max_workers=workers
            )
        else:
            from heif_tpu.cabac.syntax import TileSyntaxDecoder

            entropy_fn = lambda ps: [
                TileSyntaxDecoder(sps, pps, p).decode() for p in ps
            ]
    if stats is not None:
        inner = entropy_fn

        def entropy_fn(ps):
            t0 = _time.perf_counter()
            out = inner(ps)
            stats.stages["entropy"] = stats.stages.get("entropy", 0.0) + (
                _time.perf_counter() - t0
            )
            return out

    n = len(slices)
    if chunk is None:
        # one shared default for both the readback and decode-to-device
        # paths keeps one compiled program shape per geometry. Stream
        # hints may shrink it (min_spatial_segmentation_idc, see
        # schedule_hints).
        chunk = hints.get("chunk", 16)
    chunks = [slices[lo : lo + chunk] for lo in range(0, n, chunk)]
    key = (
        sps.pic_width_in_luma_samples,
        sps.pic_height_in_luma_samples,
        sps.ctb_log2_size_y,
        sps.chroma_format_idc,
        sps.bit_depth_luma_minus8,
        sps.bit_depth_chroma_minus8,
        min(chunk, n),
    )
    outs = []
    drains = []
    # NOTE: true overlap requires the native (GIL-releasing) entropy path;
    # with the pure-Python fallback the executor serializes behind the GIL.
    ex = ThreadPoolExecutor(max_workers=1)
    # D2H drain pool: one thread per chunk, started the moment the chunk
    # is dispatched, so each chunk's readback starts as soon as its
    # planes are ready
    dpool = ThreadPoolExecutor(max_workers=4) if readback else None
    try:
        futs = [ex.submit(entropy_fn, c) for c in chunks]
        cold = key not in _sticky_shapes and len(chunks) > 1
        if cold:
            # first sight of this geometry: batch shapes drift chunk to
            # chunk as TU counts grow, and every drift is a fresh compile
            # of the core. Wait for ALL entropy results and derive ONE
            # shape for the whole image up front
            # (forfeits entropy/device overlap for this image only; the
            # sticky cache restores overlap from the next decode on).
            all_syn = []
            for fut in futs:
                got = list(fut.result())
                if len(got) < chunk:  # same padding the loop below applies
                    got += [got[-1]] * (chunk - len(got))
                all_syn.extend(got)
            n_steps, caps = _chunk_shapes(all_syn, chunk)
            _merge_sticky(key, n_steps, caps)
        def mark(name, t0):
            if stats is not None:
                stats.stages[name] = stats.stages.get(name, 0.0) + (
                    _time.perf_counter() - t0
                )

        for fi, fut in enumerate(futs):
            t0 = _time.perf_counter()
            syn = list(fut.result())
            mark("entropy_wait", t0)
            sl_chunk = list(chunks[fi])
            if len(syn) < chunk and len(chunks) > 1:
                padn = chunk - len(syn)
                syn += [syn[-1]] * padn
                sl_chunk += [sl_chunk[-1]] * padn
            t0 = _time.perf_counter()
            n_steps, caps = _chunk_shapes(syn, len(syn))
            n_steps, caps = _merge_sticky(key, n_steps, caps)
            bp = pack_batch(
                syn, sps, pps, sl_chunk, n_steps=n_steps, class_caps=caps
            )
            mark("pack", t0)
            t0 = _time.perf_counter()
            planes = _dispatch_core(bp)
            if readback:
                # flatten the three planes into ONE contiguous 1-D device
                # buffer: one D2H transfer per chunk instead of three
                flat = _flatten_jit(*planes)
                drains.append(dpool.submit(np.asarray, flat))
                outs.append((flat, [p.shape for p in planes]))
            else:
                outs.append(planes)
            mark("dispatch", t0)
    except BaseException:
        if dpool is not None:
            dpool.shutdown(wait=False, cancel_futures=True)
        raise
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
    if not readback:
        return outs
    t0 = _time.perf_counter()
    bufs = [d.result() for d in drains]
    dpool.shutdown(wait=False)
    per_chunk = []
    for buf, (_, shapes) in zip(bufs, outs):
        sizes = [int(np.prod(s)) for s in shapes]
        off = np.cumsum([0] + sizes)
        per_chunk.append(
            [
                buf[off[c] : off[c + 1]].reshape(shapes[c])
                for c in range(3)
            ]
        )
    out = [
        np.concatenate([o[c] for o in per_chunk], axis=0)[:n]
        for c in range(3)
    ]
    mark("readback", t0)
    return out


def decode_burst(
    sps, pps, image_slice_lists, chunk: int | None = None,
    hints: dict | None = None, stats=None,
):
    """Pipelined multi-image decode-to-device (BASELINE config-4 analog
    on one chip): the chunk queues of ALL images share one entropy
    executor, so host entropy of image k+1 overlaps pack/dispatch/device
    compute of image k. Steady-state throughput is bound by host CPU
    work (entropy + pack) alone — per-image dispatch tails and device
    waits are hidden by the queue.

    image_slice_lists: one list of parsed slices per image (all sharing
    sps/pps geometry). Returns a list (per image) of lists (per chunk) of
    [y, cb, cr] device arrays; call jax.block_until_ready on the result
    to wait for the last image. NOTE: an image's last chunk is padded to
    `chunk` tiles by repeating the final tile — consumers slicing per
    image must trim to its true tile count.
    """
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    from heif_tpu import native

    if not image_slice_lists:
        return []
    if hints is None:
        hints = schedule_hints(None, sps, pps, len(image_slice_lists[0]))
    if stats is not None:
        stats.scheduler = hints
    if chunk is None:
        chunk = hints.get("chunk", 16)
    if native.available():
        workers = hints.get("entropy_workers")
        entropy_fn = lambda ps: native.decode_tiles_parallel(
            sps, pps, ps, pack_pad=PAD, max_workers=workers
        )
    else:
        from heif_tpu.cabac.syntax import TileSyntaxDecoder

        entropy_fn = lambda ps: [
            TileSyntaxDecoder(sps, pps, p).decode() for p in ps
        ]

    key = (
        sps.pic_width_in_luma_samples,
        sps.pic_height_in_luma_samples,
        sps.ctb_log2_size_y,
        sps.chroma_format_idc,
        sps.bit_depth_luma_minus8,
        sps.bit_depth_chroma_minus8,
        min(chunk, len(image_slice_lists[0])),
    )
    tasks = []  # (image index, slice chunk)
    for ii, slices in enumerate(image_slice_lists):
        for lo in range(0, len(slices), chunk):
            tasks.append((ii, list(slices[lo : lo + chunk])))

    def mark(name, t0):
        if stats is not None:
            stats.stages[name] = stats.stages.get(name, 0.0) + (
                _time.perf_counter() - t0
            )

    outs = [[] for _ in image_slice_lists]
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        futs = [(ii, c, ex.submit(entropy_fn, c)) for ii, c in tasks]
        for ii, sl_chunk, fut in futs:
            t0 = _time.perf_counter()
            syn = list(fut.result())
            mark("entropy_wait", t0)
            if len(syn) < chunk and len(tasks) > 1:
                padn = chunk - len(syn)
                syn += [syn[-1]] * padn
                sl_chunk = sl_chunk + [sl_chunk[-1]] * padn
            t0 = _time.perf_counter()
            n_steps, caps = _chunk_shapes(syn, len(syn))
            n_steps, caps = _merge_sticky(key, n_steps, caps)
            bp = pack_batch(
                syn, sps, pps, sl_chunk, n_steps=n_steps, class_caps=caps
            )
            mark("pack", t0)
            t0 = _time.perf_counter()
            outs[ii].append(_dispatch_core(bp))
            mark("dispatch", t0)
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
    return outs


def reconstruct_batch(bp: BatchPlan) -> list:
    """Run the jitted batched pipeline; returns [N, H, W]-style planes as
    a list [Y, Cb, Cr] of numpy arrays."""
    tc_arrays = {
        k: (
            jnp.asarray(bp.tc_coeffs[k]),
            jnp.asarray(bp.tc_qp[k]),
            jnp.asarray(bp.tc_dst[k]),
            jnp.asarray(bp.tc_skip[k]),
            jnp.asarray(bp.tc_bypass[k]),
            jnp.asarray(bp.tc_org[k]),
        )
        for k in bp.tc_coeffs
    }
    scaling = {k: jnp.asarray(v) for k, v in bp.scaling.items()}
    xs = [tuple(jnp.asarray(a) for a in t) for t in bp.xs]
    pcm = [None if p is None else jnp.asarray(p) for p in bp.pcm]
    planes = _core_jit(
        tc_arrays,
        scaling,
        xs,
        pcm,
        jnp.asarray(bp.qp_map),
        jnp.asarray(bp.nf_map),
        jnp.asarray(bp.vert_edges),
        jnp.asarray(bp.horiz_edges),
        jnp.asarray(bp.sao),
        n=bp.n,
        H=bp.height,
        W=bp.width,
        ctb_log2=bp.ctb_log2,
        deblock_disabled=bp.deblock_disabled,
        sao_luma=bp.sao_luma,
        sao_chroma=bp.sao_chroma,
        beta_off=bp.beta_off,
        tc_off=bp.tc_off,
        cb_qp_off=bp.cb_qp_off,
        cr_qp_off=bp.cr_qp_off,
        strong_smoothing=bp.strong_smoothing,
        bd_y=bp.bit_depth_y, bd_c=bp.bit_depth_c,
        tile_col_bd=bp.tile_col_bd, tile_row_bd=bp.tile_row_bd,
    )
    return [np.asarray(p) for p in planes]
