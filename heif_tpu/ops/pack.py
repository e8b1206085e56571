"""Host-side packing: SyntaxTensors -> device-ready tensors (DecodePlan).

The device reconstruction pipeline (ops.jax_recon) is fully static: every
data-dependent decision that does NOT depend on reconstructed sample values
is resolved here on host, at pack time:

- per-TU reference-sample SOURCE COORDINATES: availability (z-scan order,
  picture bounds) and the §8.4.4.2.2 substitution scan collapse into one
  absolute (y, x) source per reference position (-1 -> constant 1<<(bd-1)).
  The device just gathers from the current reconstruction plane.
- transform-class grouping: cbf TUs bucketed by (component, size) so the
  inverse transforms run as dense batched matmuls.
- deblock edge/bs/QP/no-filter maps at segment granularity.

Value-dependent logic (reference smoothing output, strong-filter
decisions, SAO classification) stays on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from heif_tpu.cabac import types as T
from heif_tpu.hevc import grammar as g
from heif_tpu.ops.ref_recon import z_order_plane
from heif_tpu.ops.tables import INTRA_FILTER_THRES, scaling_factor_matrix

MAX_TU = 32  # max transform size
REF_LEN = 2 * MAX_TU + 1  # corner + 2N samples per side at N=32

# per-component TU scan arrays (SoA layout), padded to a fixed count
PRED_FIELDS = ("x", "y", "size", "mode", "filter", "pcm")


@dataclass
class ComponentPlan:
    """Per-component intra-pred scan plan (padded to n_steps)."""

    n_real: int
    x: np.ndarray  # [n] int32, component coords
    y: np.ndarray
    size: np.ndarray  # [n] int32 (4..32); 0 => no-op pad step
    mode: np.ndarray  # [n] int32 intra mode
    filter_flag: np.ndarray  # [n] int32 (luma ref smoothing eligible)
    pcm: np.ndarray  # [n] int32
    # reference source indices into the TU's LOCAL reference vector
    # (left strip [65] ++ top strip [65], both starting at the corner):
    # [n, 2, REF_LEN]; axis1: 0=left (corner, p[-1][0..2N-1]),
    # 1=top (corner, p[0..2N-1][-1]); -1 => constant 1<<(bd-1).
    # Local-vector addressing lets the device fetch refs with two
    # dynamic_slices + a tiny gather instead of a whole-plane gather.
    # dtype uint8 (0..129; 255 = unavailable) to keep host->device
    # transfers small.
    src: np.ndarray


@dataclass
class TransformClass:
    """One (component, size) batch of cbf transforms."""

    comp: int
    size: int
    n: int
    coeffs: np.ndarray  # [n, size, size] int32 (quantized levels)
    qp: np.ndarray  # [n]
    dst: np.ndarray  # [n] bool (4x4 luma intra)
    skip: np.ndarray  # [n] transform_skip
    bypass: np.ndarray  # [n] transquant bypass
    pos: np.ndarray  # [n, 2] (y, x) component coords


@dataclass
class DecodePlan:
    width: int
    height: int
    comp_plans: list[ComponentPlan] = field(default_factory=list)
    tclasses: list[TransformClass] = field(default_factory=list)
    scaling: dict = field(default_factory=dict)  # (size, matrix_id) -> [s,s]
    pcm_planes: list[np.ndarray] = field(default_factory=list)
    # deblock metadata
    qp_map: np.ndarray = None  # [h/4, w/4] int32
    nf_map: np.ndarray = None  # [h/4, w/4] bool
    vert_edges: np.ndarray = None
    horiz_edges: np.ndarray = None
    sao: np.ndarray = None
    deblock_disabled: bool = False
    sao_luma: bool = False
    sao_chroma: bool = False
    beta_off: int = 0
    tc_off: int = 0
    cb_qp_off: int = 0
    cr_qp_off: int = 0


def _ref_sources(
    z4: np.ndarray,
    W: int,
    H: int,
    comp: int,
    x0: int,
    y0: int,
    size: int,
    luma_origin: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    """Availability + substitution resolved to absolute source coords.

    Returns (src_y, src_x) of shape [2, REF_LEN]: row 0 = left side
    (corner, p[-1][0], ..., p[-1][2N-1]), row 1 = top side (corner,
    p[0][-1], ..., p[2N-1][-1]); unused tail (beyond 2*size) padded -1.
    Semantics mirror ops.ref_recon.IntraPredictor.reference_samples.
    """
    sub = 1 if comp == 0 else 2
    z_cur = z4[luma_origin[1] >> 2, luma_origin[0] >> 2]
    n2 = 2 * size
    comp_w = W // sub
    comp_h = H // sub

    def available(cx, cy):
        lx, ly = cx * sub, cy * sub
        if lx < 0 or ly < 0 or lx >= W or ly >= H:
            return False
        return z4[ly >> 2, lx >> 2] < z_cur

    # ordered walk: p[-1][2N-1] .. p[-1][-1], then p[0][-1] .. p[2N-1][-1]
    coords = [(x0 - 1, y0 + i) for i in range(n2 - 1, -2, -1)]
    coords += [(x0 + i, y0 - 1) for i in range(n2)]
    avail = [available(cx, cy) for cx, cy in coords]
    srcs: list[tuple[int, int] | None] = [None] * len(coords)
    if any(avail):
        if avail[0]:
            srcs[0] = coords[0]
        else:
            first = avail.index(True)
            srcs[0] = coords[first]
        for i in range(1, len(coords)):
            srcs[i] = coords[i] if avail[i] else srcs[i - 1]
    out_y = np.full((2, REF_LEN), -1, dtype=np.int32)
    out_x = np.full((2, REF_LEN), -1, dtype=np.int32)

    def put(side, idx, src):
        if src is not None:
            out_x[side, idx] = src[0]
            out_y[side, idx] = src[1]

    corner = srcs[n2]
    put(0, 0, corner)
    put(1, 0, corner)
    for i in range(n2):  # left: p[-1][i] = walk index n2-1-i
        put(0, 1 + i, srcs[n2 - 1 - i])
    for i in range(n2):  # top: p[i][-1] = walk index n2+1+i
        put(1, 1 + i, srcs[n2 + 1 + i])
    return out_y, out_x


def _ref_sources_group(
    z4: np.ndarray, W: int, H: int, comp: int,
    tx: np.ndarray, ty: np.ndarray, size: int, out: np.ndarray,
) -> None:
    """_ref_sources_batch for a fixed TU size; writes into out[n,2,REF_LEN].

    Walk length is 4*size+1 instead of the worst-case 129, and all index
    math is int32 — together ~an order of magnitude less work for the
    dominant 4x4 class.
    """
    sub = 1 if comp == 0 else 2
    s2 = 2 * size
    L = 2 * s2 + 1
    walk = np.arange(L, dtype=np.int32)[None, :]
    # walk order: i in [0, 2N]: p[-1][2N-1-i] (left, bottom-up, incl corner
    # at i == 2N); i in (2N, 4N]: p[i-2N-1][-1] (top, left-to-right)
    is_left = walk <= s2
    txc = tx.astype(np.int32)[:, None]
    tyc = ty.astype(np.int32)[:, None]
    cx = np.where(is_left, txc - 1, txc + (walk - s2 - 1))
    cy = np.where(is_left, tyc + (s2 - 1 - walk), tyc - 1)
    lx = cx * sub
    ly = cy * sub
    inb = (lx >= 0) & (ly >= 0) & (lx < W) & (ly < H)
    z_cur = z4[(tyc[:, 0] * sub) >> 2, (txc[:, 0] * sub) >> 2][:, None]
    iy = np.clip(ly, 0, H - 1) >> 2
    ix = np.clip(lx, 0, W - 1) >> 2
    avail = inb & (z4[iy, ix] < z_cur)

    any_avail = avail.any(axis=1)
    first_avail = np.argmax(avail, axis=1).astype(np.int32)
    # substitution: source walk-index = last available index <= i, with
    # position 0 seeded by the first available anywhere
    idx = np.where(avail, walk, np.int32(-1))
    idx[:, 0] = np.where(avail[:, 0], 0, first_avail)
    src_walk = np.maximum.accumulate(idx, axis=1)
    src_ok = any_avail[:, None] & (src_walk >= 0)

    # walk index -> LOCAL reference-vector index:
    #   left strip local[k] = p[-1][k-1]  (k=0 corner), walk w<=2N -> 2N-w
    #   top  strip local[65+k] = p[k-1][-1], walk w>2N  -> w-2N+65
    local_of_walk = np.where(src_walk <= s2, s2 - src_walk, src_walk - s2 + REF_LEN)
    local_of_walk = np.where(src_ok, local_of_walk, 255).astype(np.uint8)

    # map walk positions -> (left[REF_LEN], top[REF_LEN]) layouts
    out[:, 0, 0] = local_of_walk[:, s2]
    out[:, 1, 0] = local_of_walk[:, s2]
    # left strip p[-1][i] = walk s2-1-i (reverse of walk[0:s2]);
    # top strip p[i][-1] = walk s2+1+i
    out[:, 0, 1 : 1 + s2] = local_of_walk[:, s2 - 1 :: -1]
    out[:, 1, 1 : 1 + s2] = local_of_walk[:, s2 + 1 :]


def _ref_sources_batch(
    z4: np.ndarray, W: int, H: int, comp: int,
    tx: np.ndarray, ty: np.ndarray, tsize: np.ndarray,
) -> np.ndarray:
    """Vectorized _ref_sources over all TUs of one component.

    Returns src of shape [n, 2, REF_LEN] (local ref-vector indices, uint8,
    255 = unavailable). Identical semantics to the scalar version
    (cross-checked by tests). Dispatches per size group.
    """
    n = tx.shape[0]
    src = np.full((n, 2, REF_LEN), 255, dtype=np.uint8)
    for size in (4, 8, 16, 32):
        sel = np.nonzero(tsize == size)[0]
        if sel.size == 0:
            continue
        sub = np.full((sel.size, 2, REF_LEN), 255, dtype=np.uint8)
        _ref_sources_group(z4, W, H, comp, tx[sel], ty[sel], size, sub)
        src[sel] = sub
    return src


def _luma_filter_flag(size: int, mode: int) -> bool:
    if mode == 1 or size == 4:
        return False
    if mode == 0:
        return True
    min_dist = min(abs(mode - 26), abs(mode - 10))
    return min_dist > INTRA_FILTER_THRES[size]


# filter threshold indexed by log2 size (2..5); size 4 never filters
_FILTER_THRES_BY_LOG2 = np.array([99, 99, 99, 7, 1, 0], dtype=np.int32)


def _luma_filter_flags_vec(size: np.ndarray, mode: np.ndarray) -> np.ndarray:
    """Vectorized _luma_filter_flag over TU arrays."""
    log2 = np.log2(np.maximum(size, 1)).astype(np.int32)
    min_dist = np.minimum(np.abs(mode - 26), np.abs(mode - 10))
    out = (mode == 0) | (min_dist > _FILTER_THRES_BY_LOG2[log2])
    return out & (mode != 1) & (size != 4)


def _gather_blocks(plane: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                   size: int) -> np.ndarray:
    """Extract [n, size, size] blocks at (ys, xs) from a 2-D plane."""
    iy = ys[:, None, None] + np.arange(size)[None, :, None]
    ix = xs[:, None, None] + np.arange(size)[None, None, :]
    return plane[iy, ix]


def pack_tile(
    st: T.SyntaxTensors,
    sps: g.SequenceParameterSet,
    pps: g.PictureParameterSet,
    sh: g.SliceSegmentHeader,
    n_steps: list[int] | None = None,
    with_src: bool = True,
) -> DecodePlan:
    """Build the DecodePlan for one tile.

    n_steps: optional per-component padded scan lengths (for batching
    tiles into one jitted program). with_src=False skips the host
    reference-source tables (the batched path computes them on device,
    ops.jax_recon.ref_sources_device — they are the largest packed tensor
    and the host->device link is the bottleneck).
    """
    plan = DecodePlan(width=st.width, height=st.height)
    z4 = z_order_plane(st.width, st.height, sps.ctb_log2_size_y)

    # ---- per-component pred plans (columnwise over tu_table) ----
    tt = st.tu_table
    comp_col = tt[:, T.TU_COMP]
    for c in range(3):
        mask = comp_col == c
        n_real = int(mask.sum())
        n = n_steps[c] if n_steps else n_real
        assert n >= n_real
        rows = tt[mask]
        cp = ComponentPlan(
            n_real=n_real,
            x=np.zeros(n, dtype=np.int32),
            y=np.zeros(n, dtype=np.int32),
            size=np.zeros(n, dtype=np.int32),
            mode=np.zeros(n, dtype=np.int32),
            filter_flag=np.zeros(n, dtype=np.int32),
            pcm=np.zeros(n, dtype=np.int32),
            src=np.full(
                (n if with_src else 1, 2, REF_LEN), 255, dtype=np.uint8
            ),
        )
        cp.x[:n_real] = rows[:, T.TU_X]
        cp.y[:n_real] = rows[:, T.TU_Y]
        cp.size[:n_real] = 1 << rows[:, T.TU_LOG2]
        cp.mode[:n_real] = rows[:, T.TU_PRED_MODE]
        cp.pcm[:n_real] = rows[:, T.TU_PCM]
        if c == 0 and n_real:
            cp.filter_flag[:n_real] = _luma_filter_flags_vec(
                cp.size[:n_real], cp.mode[:n_real]
            )
        if n_real and with_src:
            cp.src[:n_real] = _ref_sources_batch(
                z4, st.width, st.height, c,
                cp.x[:n_real], cp.y[:n_real], cp.size[:n_real],
            )
        plan.comp_plans.append(cp)

    # ---- transform classes (columnwise gather per (comp, size)) ----
    cbf_mask = (tt[:, T.TU_CBF] != 0) & (tt[:, T.TU_PCM] == 0)
    for c in range(3):
        for log2 in range(2, 6):
            size = 1 << log2
            mask = cbf_mask & (comp_col == c) & (tt[:, T.TU_LOG2] == log2)
            n = int(mask.sum())
            if n == 0:
                continue
            rows = tt[mask]
            ys = rows[:, T.TU_Y]
            xs_ = rows[:, T.TU_X]
            tc = TransformClass(
                comp=c,
                size=size,
                n=n,
                coeffs=_gather_blocks(st.coeffs[c], ys, xs_, size).astype(
                    np.int16
                ),
                qp=rows[:, T.TU_QP].astype(np.int32),
                dst=np.full(n, c == 0 and size == 4, dtype=bool),
                skip=rows[:, T.TU_SKIP] != 0,
                bypass=rows[:, T.TU_BYPASS] != 0,
                pos=np.stack([ys, xs_], axis=1).astype(np.int32),
            )
            plan.tclasses.append(tc)

    # scaling factor matrices in effect
    lists = sps.effective_scaling_lists()
    for size in (4, 8, 16, 32):
        for mid in range(3):
            plan.scaling[(size, mid)] = scaling_factor_matrix(size, mid, lists)

    # ---- loop filter metadata ----
    plan.qp_map = st.qp_y.astype(np.int32)
    nf = st.bypass_map.copy()
    if sps.pcm_enabled_flag and sps.pcm_loop_filter_disabled_flag:
        nf |= st.pcm_map
    plan.nf_map = nf
    plan.vert_edges = st.vert_edges
    plan.horiz_edges = st.horiz_edges
    plan.sao = st.sao
    plan.deblock_disabled = sh.slice_deblocking_filter_disabled_flag
    plan.sao_luma = sh.slice_sao_luma_flag
    plan.sao_chroma = sh.slice_sao_chroma_flag
    plan.beta_off = sh.slice_beta_offset_div2 * 2
    plan.tc_off = sh.slice_tc_offset_div2 * 2
    plan.cb_qp_off = pps.pps_cb_qp_offset
    plan.cr_qp_off = pps.pps_cr_qp_offset
    plan.pcm_planes = [p.astype(np.int32) for p in st.pcm_planes]
    return plan
