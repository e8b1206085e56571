"""Device reconstruction pipeline (JAX/XLA): DecodePlan -> YCbCr planes.

Integer-exact mirror of ops.ref_recon, compiled by XLA for the device:

- inverse transforms: dense batched int32 matmuls per (component, size)
  class — the FLOP-heavy stage, with static shapes.
- intra prediction: one lax.scan per component over the TU worklist.
  Each step is branchless: reference samples arrive as precomputed
  source-coordinate gathers (pack.py resolved availability/substitution),
  planar/DC/angular are all computed and selected, and the plane update
  is a masked 32x32 dynamic_update_slice.
- deblocking: whole-plane vectorized segment math (63 vertical + 63
  horizontal luma edge columns at once; 2-line chroma units).
- SAO: whole-plane vectorized band/edge offsets.

Everything is int32; right shifts are arithmetic (matches spec >>).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from heif_tpu.ops import pack as P
from heif_tpu.ops.tables import (
    BETA_TABLE,
    DST4,
    INTRA_PRED_ANGLE,
    LEVEL_SCALE,
    TC_TABLE,
    dct_matrix,
)
from heif_tpu.cabac.syntax import chroma_qp_from_luma

MAX_S = P.MAX_TU  # 32
REF_LEN = P.REF_LEN  # 65
PAD = MAX_S  # residual-plane padding on bottom/right
SPAD = 2 * MAX_S  # recon-plane padding (reference strips reach 2N ahead)
# recon planes carry a 1-sample top/left border (origin shift +1) so the
# reference strips at (y0-1, x0-1) never need clamping

# ---- static tables (device constants) ----

_ANGLES = np.asarray(INTRA_PRED_ANGLE, dtype=np.int32)  # modes 2..34

# inverse-angle side-extension source indices per mode: INV_IDX[mode, k]
# gives the index into the side array (0=corner) for ref[-1-k], k=0..31.
_INV_ANGLE_MAP = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
                  -21: -390, -26: -315, -32: -256}


def _build_inv_idx() -> np.ndarray:
    out = np.zeros((35, MAX_S), dtype=np.int32)
    for mode in range(2, 35):
        angle = int(INTRA_PRED_ANGLE[mode - 2])
        if angle < 0:
            ia = _INV_ANGLE_MAP[angle]
            for k in range(MAX_S):
                x = -1 - k
                out[mode, k] = min(max((x * ia + 128) >> 8, 0), 2 * MAX_S)
    return out


_INV_IDX = np.asarray(_build_inv_idx())

_CHROMA_QP_LUT = np.asarray(
    [chroma_qp_from_luma(q, 0) for q in range(0, 58)], dtype=jnp.int32
)

_BETA = np.asarray(BETA_TABLE)
_TC = np.asarray(TC_TABLE)
_LEVEL_SCALE = np.asarray(LEVEL_SCALE)


# --------------------------------------------------------------------------
# Linear intra-prediction weights.
#
# Planar, DC and angular prediction are all linear maps of the reference
# vector followed by one rounding shift:  pred = (W @ refvec + bias) >> sh,
# refvec = concat(left[65], top[65]) post-smoothing. Folding the 35 modes x
# 4 sizes into static int8 weight tensors turns the per-TU prediction into
# a single batched matvec instead of the variable-index interpolation
# gathers of a naive formulation. The few nonlinear fix-ups (DC boundary
# smoothing, mode 10/26 edge compensation) stay as masked vector ops.
# --------------------------------------------------------------------------


def _build_pred_weights():
    n_ref = 2 * REF_LEN  # 130
    W = np.zeros((35, 4, MAX_S * MAX_S, n_ref), dtype=np.int8)
    bias = np.zeros((35, 4), dtype=np.int32)
    shift = np.zeros((35, 4), dtype=np.int32)
    inv_idx = _build_inv_idx()
    for si, s in enumerate((4, 8, 16, 32)):
        log2 = s.bit_length() - 1
        ys, xs_ = np.mgrid[0:s, 0:s]
        flat = (ys * MAX_S + xs_).ravel()
        # planar (mode 0)
        w = W[0, si]
        for y in range(s):
            for x in range(s):
                r = y * MAX_S + x
                w[r, 1 + y] += s - 1 - x          # left[1+y] = p[-1][y]
                w[r, REF_LEN + 1 + x] += s - 1 - y  # top[1+x] = p[x][-1]
                w[r, REF_LEN + s + 1] += x + 1     # p[nTbS][-1]
                w[r, s + 1] += y + 1               # p[-1][nTbS]
        bias[0, si] = s
        shift[0, si] = log2 + 1
        # DC (mode 1)
        w = W[1, si]
        w[flat[:, None], 1 + np.arange(s)[None, :]] = 1
        w[flat[:, None], REF_LEN + 1 + np.arange(s)[None, :]] = 1
        bias[1, si] = s
        shift[1, si] = log2 + 1
        # angular modes
        for mode in range(2, 35):
            angle = int(INTRA_PRED_ANGLE[mode - 2])
            vertical = mode >= 18
            w = W[mode, si]

            def ref_src(r):
                """ref_full index -> refvec index (main/side per direction)."""
                if r >= 32:
                    t = r - 32  # main[t]
                    return (REF_LEN + t) if vertical else t
                k = 31 - r  # ext[k] = side[inv_idx[mode, k]]
                t = int(inv_idx[mode, k])
                return t if vertical else (REF_LEN + t)

            for d in range(s):  # distance-1 (row for vertical, col for horiz)
                iidx = ((d + 1) * angle) >> 5
                ifact = ((d + 1) * angle) & 31
                for p in range(s):  # position along the edge
                    base = 32 + p + iidx
                    r = (d * MAX_S + p) if vertical else (p * MAX_S + d)
                    w[r, ref_src(base + 1)] += 32 - ifact
                    if ifact:
                        w[r, ref_src(base + 2)] += ifact
            bias[mode, si] = 16
            shift[mode, si] = 5
    return W, bias, shift


_PRED_W_NP, _PRED_B_NP, _PRED_SH_NP = _build_pred_weights()
_PRED_W = _PRED_W_NP
_PRED_B = _PRED_B_NP
_PRED_SH = _PRED_SH_NP


def _clip16(x):
    return jnp.clip(x, -32768, 32767)


def _onehot_take(vec, idx, n: int):
    """Gather-free take: contract a one-hot mask against `vec` instead of
    indexing it.

    vec: [..., n]; idx: int array broadcastable against vec[...,:-1] dims.
    Returns vec[..., idx] with shape idx.shape.
    """
    oh = (idx[..., None] == jnp.arange(n)).astype(vec.dtype)
    return (oh * vec).sum(-1)


# ==========================================================================
# Stage 1: batched dequant + inverse transforms -> residual planes
# ==========================================================================


def residual_class(coeffs, qp, dst, skip, bypass, scaling, size: int,
                   bd: int = 8):
    """One (comp,size) class: [n,s,s] levels -> [n,s,s] residual (int32).

    coeffs may arrive int16 (wire format); computed in int32."""
    coeffs = coeffs.astype(jnp.int32)
    n = coeffs.shape[0]
    log2 = size.bit_length() - 1
    bd_shift = bd + log2 - 5
    v = (coeffs * scaling[None]
         * jnp.asarray(_LEVEL_SCALE)[qp % 6][:, None, None])
    e = qp // 6
    # v fits int32 (|level| * 255 * 72 < 2^31) but v << (e - bd_shift)
    # need not; the result is clipped to 16 bits, so clipping v first
    # gives the same value without the overflow
    lo = jnp.where(
        e[:, None, None] < bd_shift,
        (v + (1 << jnp.maximum(bd_shift - e[:, None, None] - 1, 0)))
        >> jnp.maximum(bd_shift - e[:, None, None], 0),
        _clip16(v) << jnp.maximum(e[:, None, None] - bd_shift, 0),
    )
    d = _clip16(lo)

    t_dct = np.asarray(dct_matrix(size), dtype=np.int32)
    if size == 4:
        t_dst = np.asarray(DST4, dtype=np.int32)
        t = jnp.where(dst[:, None, None], t_dst[None], t_dct[None])
    else:
        t = jnp.broadcast_to(t_dct[None], (n, size, size))
    # stage 1: G = T^T @ D
    g1 = _clip16(
        (
            lax.dot_general(
                jnp.swapaxes(t, 1, 2), d,
                (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.int32,
            )
            + 64
        )
        >> 7
    )
    r = _clip16(
        (
            lax.dot_general(
                g1, t, (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.int32,
            )
            + (1 << (19 - bd))
        )
        >> (20 - bd)
    )
    r_skip = _clip16(((d << 7) + (1 << (19 - bd))) >> (20 - bd))
    r = jnp.where(skip[:, None, None], r_skip, r)
    r = jnp.where(bypass[:, None, None], coeffs, r)
    return r


def scatter_blocks(plane, blocks, pos, size: int, width: int):
    """Scatter non-overlapping [n,s,s] blocks into a flat padded plane."""
    n = blocks.shape[0]
    oy = pos[:, 0][:, None, None]
    ox = pos[:, 1][:, None, None]
    iy = jnp.arange(size)[None, :, None]
    ix = jnp.arange(size)[None, None, :]
    flat = ((oy + iy) * width + (ox + ix)).reshape(-1)
    return plane.at[flat].set(blocks.reshape(-1))


# ==========================================================================
# Stage 2a: reference-source resolution on device
# ==========================================================================
#
# The per-TU reference source table (availability per §6.4.1 + the
# §8.4.4.2.2 substitution scan) used to be packed on host and shipped as
# a [N, S, 2, 65] uint8 tensor — ~1.5 MB per tile, the single largest
# host->device transfer. It is fully derivable from (x, y, size) plus the z-scan
# order, and the z-scan address is closed-form bit math (raster CTB index
# + Morton interleave within the CTB — see ops.ref_recon.z_order_plane),
# so the whole table is now computed on device with no gathers from any
# z-plane: ~50 bytes of scalars per TU go over the wire instead.


def _z_addr(g4y, g4x, cl: int, ctbs_x: int):
    """Z-scan address of a 4x4 block at grid coords (g4y, g4x)."""
    ctb_idx = (g4y >> cl) * ctbs_x + (g4x >> cl)
    ix = g4x & ((1 << cl) - 1)
    iy = g4y & ((1 << cl) - 1)
    z = jnp.zeros_like(g4x)
    for b in range(cl):
        z = z | (((ix >> b) & 1) << (2 * b))
        z = z | (((iy >> b) & 1) << (2 * b + 1))
    return (ctb_idx << (2 * cl)) + z


def ref_sources_device(x, y, size, *, comp: int, W: int, H: int,
                       ctb_log2: int, tile_col_bd: tuple = (),
                       tile_row_bd: tuple = ()):
    """Device twin of pack._ref_sources_batch for mixed TU sizes.

    x/y/size: int32 arrays of any matching shape [...] (component coords;
    size == 0 marks padding steps). tile_col_bd/tile_row_bd: INTERIOR
    tile boundaries in luma pixels (§6.5.1), empty when tiles are off —
    a neighbor across a tile boundary is unavailable (§6.4.1).
    Returns uint8 [..., 2, REF_LEN] local reference-vector indices,
    255 = unavailable — bit-identical to the host packer (cross-checked
    in tests/test_jax_recon.py).
    """
    sub = 1 if comp == 0 else 2
    cl = ctb_log2 - 2
    ctbs_x = -(-(W >> 2) // (1 << cl))
    x = x.astype(jnp.int32)
    y = y.astype(jnp.int32)
    s2 = (2 * size).astype(jnp.int32)[..., None]

    walk = jnp.arange(4 * MAX_S + 1, dtype=jnp.int32)  # [129]
    is_left = walk <= s2
    cx = jnp.where(is_left, x[..., None] - 1, x[..., None] + (walk - s2 - 1))
    cy = jnp.where(is_left, y[..., None] + (s2 - 1 - walk), y[..., None] - 1)
    lx = cx * sub
    ly = cy * sub
    inb = (lx >= 0) & (ly >= 0) & (lx < W) & (ly < H)
    z_cur = _z_addr((y * sub) >> 2, (x * sub) >> 2, cl, ctbs_x)[..., None]
    zn = _z_addr(
        jnp.clip(ly, 0, H - 1) >> 2, jnp.clip(lx, 0, W - 1) >> 2, cl, ctbs_x
    )
    avail = inb & (zn < z_cur) & (walk <= 2 * s2)
    if tile_col_bd or tile_row_bd:
        # tile id via counted interior boundaries; neighbors must share
        # both the tile column and the tile row of the current TU
        cur_lx = (x * sub)[..., None]
        cur_ly = (y * sub)[..., None]

        def _tidx(v, bounds):
            t = jnp.zeros(v.shape, jnp.int32)
            for b in bounds:
                t = t + (v >= b).astype(jnp.int32)
            return t

        same = (_tidx(lx, tile_col_bd) == _tidx(cur_lx, tile_col_bd)) & (
            _tidx(ly, tile_row_bd) == _tidx(cur_ly, tile_row_bd)
        )
        avail = avail & same

    any_avail = avail.any(-1)
    first_avail = jnp.argmax(avail, axis=-1).astype(jnp.int32)
    idx = jnp.where(avail, walk, jnp.int32(-1))
    idx = jnp.where(
        walk == 0,
        jnp.where(avail[..., :1], 0, first_avail[..., None]),
        idx,
    )
    src_walk = lax.cummax(idx, axis=idx.ndim - 1)
    src_ok = any_avail[..., None] & (src_walk >= 0)

    local_of_walk = jnp.where(
        src_walk <= s2, s2 - src_walk, src_walk - s2 + REF_LEN
    )
    local_of_walk = jnp.where(src_ok, local_of_walk, 255)

    # walk layout -> (left[65], top[65]) sides. s2 = 2*size takes only the
    # values {8, 16, 32, 64} (plus 0 padding), so the variable-index
    # extraction is a 4-way select over STATIC slices instead of a
    # take_along_axis gather.
    size_b = jnp.broadcast_to(size[..., None], size.shape + (1,))
    corner = jnp.zeros_like(local_of_walk[..., :1])
    left_vals = jnp.full(local_of_walk.shape[:-1] + (2 * MAX_S,), 255,
                         local_of_walk.dtype)
    top_vals = jnp.full_like(left_vals, 255)
    for s in (4, 8, 16, 32):
        n2 = 2 * s
        sel = size_b == s
        corner = jnp.where(sel, local_of_walk[..., n2 : n2 + 1], corner)
        # left_vals[i] = low[n2-1-i] for i < n2
        lv = jnp.flip(local_of_walk[..., :n2], axis=-1)
        lv = jnp.pad(lv, [(0, 0)] * (lv.ndim - 1) + [(0, 2 * MAX_S - n2)],
                     constant_values=255)
        left_vals = jnp.where(sel, lv, left_vals)
        # top_vals[i] = low[n2+1+i] for i < n2
        tv = local_of_walk[..., n2 + 1 : 2 * n2 + 1]
        tv = jnp.pad(tv, [(0, 0)] * (tv.ndim - 1) + [(0, 2 * MAX_S - n2)],
                     constant_values=255)
        top_vals = jnp.where(sel, tv, top_vals)
    pad_mask = (size > 0)[..., None]
    left_side = jnp.where(
        pad_mask, jnp.concatenate([corner, left_vals], axis=-1), 255
    )
    top_side = jnp.where(
        pad_mask, jnp.concatenate([corner, top_vals], axis=-1), 255
    )
    return jnp.stack([left_side, top_side], axis=-2).astype(jnp.uint8)


# ==========================================================================
# Stage 2: intra prediction scan (per component)
# ==========================================================================


def _predict_block(left, top, size, log2, mode, is_luma, strong_smoothing,
                   bd: int = 8):
    """Intra prediction at padded 32x32 (§8.4.4.2.4-6) via the static
    linear weights plus masked nonlinear fix-ups.

    left/top: [REF_LEN] int32 (index 0 = corner). Returns [32,32] int32.
    """
    s = size
    refvec = jnp.concatenate([left, top])  # [130]
    si = log2 - 2
    w = jnp.asarray(_PRED_W)[mode, si].astype(jnp.int32)  # [1024, 130]
    acc = jax.lax.dot_general(
        w, refvec, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )
    pred = (
        (acc + jnp.asarray(_PRED_B)[mode, si])
        >> jnp.asarray(_PRED_SH)[mode, si]
    ).reshape(
        MAX_S, MAX_S
    )

    rr = jnp.arange(MAX_S)[:, None]
    cc = jnp.arange(MAX_S)[None, :]

    # DC boundary smoothing (luma, s < 32, mode DC)
    idx = jnp.arange(REF_LEN)
    msk = (idx >= 1) & (idx <= s)
    dc = (jnp.sum(jnp.where(msk, left + top, 0)) + s) >> (log2 + 1)
    dc_smooth = is_luma & (s < 32) & (mode == 1)
    top_row = (top[1 : MAX_S + 1] + 3 * dc + 2) >> 2
    left_col = (left[1 : MAX_S + 1] + 3 * dc + 2) >> 2
    corner_v = (left[1] + 2 * dc + top[1] + 2) >> 2
    pred = jnp.where(dc_smooth & (rr == 0), top_row[None, :], pred)
    pred = jnp.where(dc_smooth & (cc == 0) & (rr > 0), left_col[:, None], pred)
    pred = jnp.where(dc_smooth & (rr == 0) & (cc == 0), corner_v, pred)

    # pure vertical/horizontal edge compensation (luma, s < 32)
    comp_ok = is_luma & (s < 32)
    v_edge = comp_ok & (mode == 26)
    h_edge = comp_ok & (mode == 10)
    mxv = (1 << bd) - 1
    delta_v = jnp.clip(top[1] + ((left[1 : MAX_S + 1] - left[0]) >> 1), 0, mxv)
    delta_h = jnp.clip(left[1] + ((top[1 : MAX_S + 1] - top[0]) >> 1), 0, mxv)
    pred = jnp.where(v_edge & (cc == 0), delta_v[:, None], pred)
    pred = jnp.where(h_edge & (rr == 0), delta_h[None, :], pred)
    return pred


def _filter_refs(left, top, size, log2, mode, filter_flag, strong_smoothing,
                 bd: int = 8):
    """§8.4.4.2.3 reference smoothing ([1 2 1] or bilinear), branchless."""
    idx = jnp.arange(REF_LEN)
    n2 = 2 * size
    corner = left[0]

    # bilinear (strong smoothing) condition — value-dependent, 32x32 only
    thr = 1 << (bd - 5)
    bi = (
        strong_smoothing
        & (size == 32)
        & (jnp.abs(corner + top[2 * 32] - 2 * top[32]) < thr)
        & (jnp.abs(corner + left[2 * 32] - 2 * left[32]) < thr)
    )

    # [1 2 1] filter
    lpad = jnp.concatenate([left[:1], left])  # shift helper
    l_m1 = lpad[:-1]  # left[i-1] with left[-1] := corner dup (i>=1 usage ok)
    l_p1 = jnp.concatenate([left[1:], left[-1:]])
    t_m1 = jnp.concatenate([top[:1], top])[:-1]
    t_p1 = jnp.concatenate([top[1:], top[-1:]])
    lf = (l_m1 + 2 * left + l_p1 + 2) >> 2
    tf = (t_m1 + 2 * top + t_p1 + 2) >> 2
    corner_f = (left[1] + 2 * corner + top[1] + 2) >> 2
    lf = jnp.where(idx == 0, corner_f, lf)
    tf = jnp.where(idx == 0, corner_f, tf)
    lf = jnp.where(idx >= n2, left, lf)  # last sample unfiltered
    tf = jnp.where(idx >= n2, top, tf)

    # bilinear variant (size 32 fixed)
    i64 = idx  # 0..64
    tb = jnp.where(
        (i64 >= 1) & (i64 <= 63),
        ((63 - (i64 - 1)) * corner + i64 * top[64] + 32) >> 6,
        top,
    )
    lb = jnp.where(
        (i64 >= 1) & (i64 <= 63),
        ((63 - (i64 - 1)) * corner + i64 * left[64] + 32) >> 6,
        left,
    )
    tb = jnp.where(idx == 0, corner, tb)
    lb = jnp.where(idx == 0, corner, lb)

    use_f = filter_flag.astype(bool)
    lf_out = jnp.where(use_f, jnp.where(bi, lb, lf), left)
    tf_out = jnp.where(use_f, jnp.where(bi, tb, tf), top)
    return lf_out, tf_out


def intra_scan_component(
    plane0, res_plane, pcm_plane, xs, is_luma: bool, strong_smoothing: bool,
    bd: int = 8,
):
    """lax.scan over one component's TU worklist.

    plane0: [1+H+SPAD, 1+W+SPAD] int32 (origin shifted by +1; sample (r,c)
    lives at plane[r+1, c+1]). res_plane/pcm_plane: [H+PAD, W+PAD] int32.
    xs: per-step arrays from ComponentPlan (src = local ref indices).
    """

    def step(plane, x):
        tx, ty, size, mode, filt, pcm, src = x
        active = size > 0
        log2 = (
            jnp.where(size == 4, 2, 0)
            + jnp.where(size == 8, 3, 0)
            + jnp.where(size == 16, 4, 0)
            + jnp.where(size == 32, 5, 0)
        )
        # reference strips: abs (ty-1 .. ty+2N-1, tx-1) and
        # (ty-1, tx-1 .. tx+2N-1); +1 origin makes the starts (ty, tx)
        left_strip = lax.dynamic_slice(plane, (ty, tx), (REF_LEN, 1))[:, 0]
        top_strip = lax.dynamic_slice(plane, (ty, tx), (1, REF_LEN))[0]
        local = jnp.concatenate([left_strip, top_strip])  # [130]
        srci = src.astype(jnp.int32)  # uint8; 255 = unavailable
        refs = jnp.where(
            srci >= 2 * REF_LEN,
            1 << (bd - 1),
            _onehot_take(local, jnp.minimum(srci, 2 * REF_LEN - 1), 2 * REF_LEN),
        )
        left, top = refs[0], refs[1]
        if is_luma:
            left, top = _filter_refs(
                left, top, size, log2, mode, filt, strong_smoothing, bd
            )
        pred = _predict_block(
            left, top, size, log2, mode, is_luma, strong_smoothing, bd
        )
        res = lax.dynamic_slice(res_plane, (ty, tx), (MAX_S, MAX_S))
        pcmb = lax.dynamic_slice(pcm_plane, (ty, tx), (MAX_S, MAX_S))
        new = jnp.clip(pred + res, 0, (1 << bd) - 1)
        new = jnp.where(pcm.astype(bool), pcmb, new)
        cur = lax.dynamic_slice(plane, (ty + 1, tx + 1), (MAX_S, MAX_S))
        mask = (
            (jnp.arange(MAX_S)[:, None] < size)
            & (jnp.arange(MAX_S)[None, :] < size)
            & active
        )
        out = jnp.where(mask, new, cur)
        plane = lax.dynamic_update_slice(plane, out, (ty + 1, tx + 1))
        return plane, None

    plane, _ = lax.scan(step, plane0, xs)
    return plane


# ==========================================================================
# Stage 3: deblocking (vectorized)
# ==========================================================================


def _deblock_luma_pass(plane, edge_present, qp_p, qp_q, nf_p, nf_q,
                       beta_off: int, tc_off: int, bd: int = 8):
    """One direction of luma deblocking, fully vectorized.

    plane: [H, W] with W % 8 == 0; filters the W//8 - 1 internal vertical
    edges. edge_present/qp/nf: [H//4, W//8-1] per (segment, edge).
    """
    h, w = plane.shape
    ne = w // 8 - 1
    seg = plane[:, 4 : 4 + ne * 8].reshape(h // 4, 4, ne, 8).transpose(0, 2, 1, 3)
    # seg: [nseg, ne, 4 lines, 8 cols] cols = p3..p0 q0..q3
    p3, p2, p1, p0 = seg[..., 0], seg[..., 1], seg[..., 2], seg[..., 3]
    q0, q1, q2, q3 = seg[..., 4], seg[..., 5], seg[..., 6], seg[..., 7]

    qp_avg = (qp_p + qp_q + 1) >> 1
    beta = _onehot_take(_BETA, jnp.clip(qp_avg + beta_off, 0, 51), 52) << (bd - 8)
    tc = _onehot_take(
        _TC, jnp.clip(qp_avg + 2 + tc_off, 0, 53), len(TC_TABLE)
    ) << (bd - 8)

    def dd(i):
        dp = jnp.abs(p2[..., i] - 2 * p1[..., i] + p0[..., i])
        dq = jnp.abs(q2[..., i] - 2 * q1[..., i] + q0[..., i])
        return dp, dq

    dp0, dq0 = dd(0)
    dp3, dq3 = dd(3)
    d = dp0 + dq0 + dp3 + dq3
    filt = edge_present & (d < beta) & ((beta > 0) | (tc > 0))

    def strong_line(i):
        dpq = jnp.where(i == 0, dp0 + dq0, dp3 + dq3)
        return (
            (2 * dpq < (beta >> 2))
            & (jnp.abs(p3[..., i] - p0[..., i]) + jnp.abs(q0[..., i] - q3[..., i])
               < (beta >> 3))
            & (jnp.abs(p0[..., i] - q0[..., i]) < ((5 * tc + 1) >> 1))
        )

    strong = strong_line(0) & strong_line(3)
    dep = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    deq = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)

    tcb = tc[..., None]
    tc2 = 2 * tcb
    # strong filter
    sp0 = jnp.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - tc2, p0 + tc2)
    sp1 = jnp.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - tc2, p1 + tc2)
    sp2 = jnp.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - tc2, p2 + tc2)
    sq0 = jnp.clip((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3, q0 - tc2, q0 + tc2)
    sq1 = jnp.clip((q2 + q1 + q0 + p0 + 2) >> 2, q1 - tc2, q1 + tc2)
    sq2 = jnp.clip((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2 - tc2, q2 + tc2)
    # weak filter
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wmask = jnp.abs(delta) < tcb * 10
    dl = jnp.clip(delta, -tcb, tcb)
    mxv = (1 << bd) - 1
    wp0 = jnp.where(wmask, jnp.clip(p0 + dl, 0, mxv), p0)
    wq0 = jnp.where(wmask, jnp.clip(q0 - dl, 0, mxv), q0)
    tch = (tc >> 1)[..., None]
    dpv = jnp.clip((((p2 + p0 + 1) >> 1) - p1 + dl) >> 1, -tch, tch)
    wp1 = jnp.where(wmask & dep[..., None], jnp.clip(p1 + dpv, 0, mxv), p1)
    dqv = jnp.clip((((q2 + q0 + 1) >> 1) - q1 - dl) >> 1, -tch, tch)
    wq1 = jnp.where(wmask & deq[..., None], jnp.clip(q1 + dqv, 0, mxv), q1)

    sm = strong[..., None]
    fm = filt[..., None]
    fp = fm & (~nf_p[..., None])
    fq = fm & (~nf_q[..., None])
    np0 = jnp.where(fp, jnp.where(sm, sp0, wp0), p0)
    np1 = jnp.where(fp & sm, sp1, jnp.where(fp & ~sm, wp1, p1))
    np2 = jnp.where(fp & sm, sp2, p2)
    nq0 = jnp.where(fq, jnp.where(sm, sq0, wq0), q0)
    nq1 = jnp.where(fq & sm, sq1, jnp.where(fq & ~sm, wq1, q1))
    nq2 = jnp.where(fq & sm, sq2, q2)

    out = jnp.stack([p3, np2, np1, np0, nq0, nq1, nq2, q3], axis=-1)
    out = out.transpose(0, 2, 1, 3).reshape(h, ne * 8)
    return plane.at[:, 4 : 4 + ne * 8].set(out)


def _deblock_chroma_pass(plane, edge_present, qpc, nf_p, nf_q, tc_off: int,
                         bd: int = 8):
    """One direction of chroma deblocking in 2-line units.

    plane: [Hc, Wc]; edges every 8 chroma cols. edge_present/qpc/nf:
    [Hc//2, Wc//8-1].
    """
    h, w = plane.shape
    ne = w // 8 - 1
    seg = plane[:, 6 : 6 + ne * 8].reshape(h // 2, 2, ne, 8).transpose(0, 2, 1, 3)
    p1, p0, q0, q1 = seg[..., 0], seg[..., 1], seg[..., 2], seg[..., 3]
    tc = _onehot_take(
        _TC, jnp.clip(qpc + 2 + tc_off, 0, 53), len(TC_TABLE)
    ) << (bd - 8)
    mxv = (1 << bd) - 1
    tcb = tc[..., None]
    delta = jnp.clip((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tcb, tcb)
    fm = (edge_present & (tc > 0))[..., None]
    np0 = jnp.where(fm & (~nf_p[..., None]), jnp.clip(p0 + delta, 0, mxv), p0)
    nq0 = jnp.where(fm & (~nf_q[..., None]), jnp.clip(q0 - delta, 0, mxv), q0)
    out = jnp.stack(
        [p1, np0, nq0, q1, seg[..., 4], seg[..., 5], seg[..., 6], seg[..., 7]],
        axis=-1,
    )
    out = out.transpose(0, 2, 1, 3).reshape(h, ne * 8)
    return plane.at[:, 6 : 6 + ne * 8].set(out)


# ==========================================================================
# Stage 4: SAO (vectorized)
# ==========================================================================

_EO = ((( -1, 0), (1, 0)), ((0, -1), (0, 1)), ((-1, -1), (1, 1)), ((1, -1), (-1, 1)))


def sao_component(plane, sao_type, sao_class, offs, nf_pix, bd: int = 8):
    """plane [H, W]; per-pixel sao params (already upsampled per CTB)."""
    h, w = plane.shape
    offs = offs * (1 << (bd - min(bd, 10)))  # saoOffsetVal scale
    # band
    band = plane >> (bd - 5)
    bdelta = jnp.zeros_like(plane)
    for i in range(4):
        bdelta = bdelta + jnp.where(
            band == ((sao_class + i) & 31), offs[..., i], 0
        )
    # edge: compute all 4 classes, select
    padded = jnp.pad(plane, 1, mode="edge")
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    edelta = jnp.zeros_like(plane)
    for cls, ((dx0, dy0), (dx1, dy1)) in enumerate(_EO):
        n0 = padded[1 + dy0 : 1 + h + dy0, 1 + dx0 : 1 + w + dx0]
        n1 = padded[1 + dy1 : 1 + h + dy1, 1 + dx1 : 1 + w + dx1]
        sgn = jnp.sign(plane - n0) + jnp.sign(plane - n1)
        dlt = (
            jnp.where(sgn == -2, offs[..., 0], 0)
            + jnp.where(sgn == -1, offs[..., 1], 0)
            + jnp.where(sgn == 1, offs[..., 2], 0)
            + jnp.where(sgn == 2, offs[..., 3], 0)
        )
        valid = (
            (xx + dx0 >= 0) & (xx + dx0 < w) & (yy + dy0 >= 0) & (yy + dy0 < h)
            & (xx + dx1 >= 0) & (xx + dx1 < w) & (yy + dy1 >= 0) & (yy + dy1 < h)
        )
        dlt = jnp.where(valid, dlt, 0)
        edelta = jnp.where(sao_class == cls, dlt, edelta)
    mxv = (1 << bd) - 1
    res = jnp.where(
        sao_type == 1,
        jnp.clip(plane + bdelta, 0, mxv),
        jnp.where(sao_type == 2, jnp.clip(plane + edelta, 0, mxv), plane),
    )
    return jnp.where(nf_pix, plane, res)


# ==========================================================================
# Full tile pipeline
# ==========================================================================


def _plan_to_device(plan: P.DecodePlan):
    """numpy DecodePlan -> jnp arrays (component xs tuples etc.)."""
    xs = []
    for cp in plan.comp_plans:
        xs.append(
            (
                jnp.asarray(cp.x),
                jnp.asarray(cp.y),
                jnp.asarray(cp.size),
                jnp.asarray(cp.mode),
                jnp.asarray(cp.filter_flag),
                jnp.asarray(cp.pcm),
                jnp.asarray(cp.src),
            )
        )
    return xs


def reconstruct_tile_jax(plan: P.DecodePlan, sps, sh) -> list[np.ndarray]:
    """Single-tile reconstruction through the JAX pipeline."""
    H, W = plan.height, plan.width
    Hc, Wc = H // 2, W // 2

    # ---- residual planes ----
    res = [
        jnp.zeros(((H + PAD) * (W + PAD),), jnp.int32),
        jnp.zeros(((Hc + PAD) * (Wc + PAD),), jnp.int32),
        jnp.zeros(((Hc + PAD) * (Wc + PAD),), jnp.int32),
    ]
    for tc in plan.tclasses:
        r = residual_class(
            jnp.asarray(tc.coeffs),
            jnp.asarray(tc.qp),
            jnp.asarray(tc.dst),
            jnp.asarray(tc.skip),
            jnp.asarray(tc.bypass),
            jnp.asarray(plan.scaling[(tc.size, tc.comp)]),
            tc.size,
            sps.bit_depth_y if tc.comp == 0 else sps.bit_depth_c,
        )
        width = (W + PAD) if tc.comp == 0 else (Wc + PAD)
        res[tc.comp] = scatter_blocks(
            res[tc.comp], r, jnp.asarray(tc.pos), tc.size, width
        )
    res_planes = [
        res[0].reshape(H + PAD, W + PAD),
        res[1].reshape(Hc + PAD, Wc + PAD),
        res[2].reshape(Hc + PAD, Wc + PAD),
    ]

    # ---- intra scans ----
    xs = _plan_to_device(plan)
    planes = []
    strong = bool(sps.strong_intra_smoothing_enabled_flag)
    for c in range(3):
        h = H if c == 0 else Hc
        w = W if c == 0 else Wc
        pcm = jnp.zeros((h + PAD, w + PAD), jnp.int32)
        if plan.pcm_planes:
            pcm = pcm.at[:h, :w].set(jnp.asarray(plan.pcm_planes[c]))
        plane0 = jnp.zeros((1 + h + SPAD, 1 + w + SPAD), jnp.int32)
        plane = intra_scan_component(
            plane0, res_planes[c], pcm, xs[c], c == 0, strong,
            sps.bit_depth_y if c == 0 else sps.bit_depth_c,
        )
        planes.append(plane[1 : 1 + h, 1 : 1 + w])

    # ---- deblock ----
    if not plan.deblock_disabled:
        qp = jnp.asarray(plan.qp_map)
        nf = jnp.asarray(plan.nf_map)
        ve = jnp.asarray(plan.vert_edges)
        he = jnp.asarray(plan.horiz_edges)
        bo, to = plan.beta_off, plan.tc_off

        # luma vertical: edges at cols 8k+8 -> 4x4 col 2k+2
        ne = W // 8 - 1
        cols = 2 * jnp.arange(ne) + 2
        ep = ve[:, cols]
        qpp = qp[:, cols - 1]
        qpq = qp[:, cols]
        nfp = nf[:, cols - 1]
        nfq = nf[:, cols]
        bdy = sps.bit_depth_y
        bdc = sps.bit_depth_c
        y = _deblock_luma_pass(planes[0], ep, qpp, qpq, nfp, nfq, bo, to, bdy)
        # luma horizontal (transpose world)
        epT = he.T[:, cols]
        qppT = qp.T[:, cols - 1]
        qpqT = qp.T[:, cols]
        nfpT = nf.T[:, cols - 1]
        nfqT = nf.T[:, cols]
        y = _deblock_luma_pass(y.T, epT, qppT, qpqT, nfpT, nfqT, bo, to, bdy).T
        planes[0] = y

        # chroma: edges every 8 chroma cols -> luma 4x4 col 4k+4; units of
        # 2 chroma rows -> luma 4x4 row = unit index
        nec = Wc // 8 - 1
        ccols = 4 * jnp.arange(nec) + 4
        for ci, c_off in ((1, plan.cb_qp_off), (2, plan.cr_qp_off)):
            ep_v = ve[:, ccols]
            qp_avg = (qp[:, ccols - 1] + qp[:, ccols] + 1) >> 1
            qpc = _onehot_take(_CHROMA_QP_LUT, jnp.clip(qp_avg + c_off, 0, 57), 58)
            p = _deblock_chroma_pass(
                planes[ci], ep_v, qpc, nf[:, ccols - 1], nf[:, ccols], to, bdc
            )
            ep_h = he.T[:, ccols]
            qp_avgT = (qp.T[:, ccols - 1] + qp.T[:, ccols] + 1) >> 1
            qpcT = _onehot_take(_CHROMA_QP_LUT, jnp.clip(qp_avgT + c_off, 0, 57), 58)
            p = _deblock_chroma_pass(
                p.T, ep_h, qpcT, nf.T[:, ccols - 1], nf.T[:, ccols], to, bdc
            ).T
            planes[ci] = p

    # ---- SAO ----
    if plan.sao_luma or plan.sao_chroma:
        sao = jnp.asarray(plan.sao.astype(np.int32))
        nf4 = jnp.asarray(plan.nf_map)
        new_planes = []
        for c in range(3):
            enabled = plan.sao_luma if c == 0 else plan.sao_chroma
            if not enabled:
                new_planes.append(planes[c])
                continue
            sub = 1 if c == 0 else 2
            cs = sps.ctb_size_y // sub  # ctb size in component samples
            rep = lambda a: jnp.repeat(jnp.repeat(a, cs, 0), cs, 1)
            stype = rep(sao[:, :, c, 0])
            sclass = rep(sao[:, :, c, 1])
            offs = jnp.stack(
                [rep(sao[:, :, c, 2 + i]) for i in range(4)], axis=-1
            )
            nf_pix = jnp.repeat(
                jnp.repeat(nf4, 4 // sub, 0), 4 // sub, 1
            )
            h = planes[c].shape[0]
            w = planes[c].shape[1]
            new_planes.append(
                sao_component(
                    planes[c], stype[:h, :w], sclass[:h, :w], offs[:h, :w],
                    nf_pix[:h, :w],
                    sps.bit_depth_y if c == 0 else sps.bit_depth_c,
                )
            )
        planes = new_planes

    dt = (
        np.uint8
        if max(sps.bit_depth_y, sps.bit_depth_c) <= 8
        else np.uint16
    )
    return [np.asarray(p).astype(dt) for p in planes]


def reconstruct_tiles_batched(syntaxes, sps, pps, slices) -> list:
    """Decode-backend entry: chunked batched pipeline (overlaps host
    packing, device compute and plane readback; see ops.batch)."""
    from heif_tpu.ops.batch import reconstruct_pipelined

    planes = reconstruct_pipelined(syntaxes, sps, pps, slices)
    return [
        [planes[0][i], planes[1][i], planes[2][i]]
        for i in range(len(syntaxes))
    ]
