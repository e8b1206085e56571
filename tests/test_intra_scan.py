"""The XLA intra scan and the residual transforms against the numpy
reference: every component on real flagship tiles, and dequant plus
inverse transform at extreme levels (|c| = 32767, QP 51, scaling factors
up to 255), where the int32 products are closest to overflow."""

import numpy as np
import pytest

from heif_tpu.cabac.syntax import TileSyntaxDecoder
from heif_tpu.container.reader import HeifReader
from heif_tpu.hevc import params
from heif_tpu.hevc import slice as sl
from heif_tpu.hevc.rbsp import remove_emulation_prevention
from heif_tpu.ops import ref_recon as R


@pytest.fixture(scope="module")
def two_tiles(halfmoonbay_bytes):
    r = HeifReader(halfmoonbay_bytes)
    heif = r.read()
    rec = heif.hevc_configuration_record()
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:])
    )
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:])
    )
    slices = [
        sl.parse_slice_header(
            sl.split_length_prefixed_nals(r.get_item_data(t), 4)[0], sps, pps
        )
        for t in (1, 38)
    ]
    sts = [TileSyntaxDecoder(sps, pps, ps).decode() for ps in slices]
    return sps, pps, slices, sts


@pytest.mark.parametrize("comp", [0, 1, 2])
def test_intra_scan_matches_reference(two_tiles, comp):
    import jax
    import jax.numpy as jnp

    from heif_tpu.ops import jax_recon as J
    from heif_tpu.ops.batch import pack_batch

    sps, pps, slices, sts = two_tiles
    bp = pack_batch(sts, sps, pps, slices)
    h = bp.height if comp == 0 else bp.height // 2
    w = bp.width if comp == 0 else bp.width // 2
    res = np.zeros((bp.n, h + J.PAD, w + J.PAD), np.int32)
    want = []
    for i, st in enumerate(sts):
        rp = R.residual_planes(st, sps)
        res[i, :h, :w] = rp[comp]
        want.append(R.intra_reconstruct(st, rp, sps)[comp])
    xs = tuple(jnp.asarray(a) for a in bp.xs[comp])

    @jax.jit
    def scan(res, xs):
        src = J.ref_sources_device(
            xs[0], xs[1], xs[2], comp=min(comp, 1), W=bp.width,
            H=bp.height, ctb_log2=sps.ctb_log2_size_y,
        )
        plane0 = jnp.zeros((bp.n, 1 + h + J.SPAD, 1 + w + J.SPAD), jnp.int32)
        fn = lambda p0, r, x: J.intra_scan_component(
            p0, r, jnp.zeros_like(r), x, is_luma=comp == 0,
            strong_smoothing=bool(sps.strong_intra_smoothing_enabled_flag),
        )
        return jax.vmap(fn)(plane0, res, xs + (src,))[:, 1 : 1 + h, 1 : 1 + w]

    got = np.asarray(scan(jnp.asarray(res), xs))
    for i in range(bp.n):
        np.testing.assert_array_equal(got[i], want[i])


def _scaling_lists(kind):
    from heif_tpu.hevc.grammar import ScalingListData

    if kind == "default":
        return ScalingListData.default()
    return ScalingListData(
        scaling_list=[
            [[255] * min(64, 1 << (4 + 2 * s)) for _ in range(6)]
            for s in range(4)
        ],
        dc=[[255] * 6 for _ in range(2)],
    )


@pytest.mark.parametrize("kind", ["default", "max255"])
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_residual_class_extreme_levels(size, kind):
    import jax.numpy as jnp

    from heif_tpu.ops.jax_recon import residual_class
    from heif_tpu.ops.ref_recon import dequant_block, inverse_transform
    from heif_tpu.ops.tables import scaling_factor_matrix

    rng = np.random.default_rng(size)
    lists = _scaling_lists(kind)
    n = 8
    coeffs = rng.integers(-32768, 32768, size=(n, size, size), dtype=np.int32)
    coeffs[0] = 32767
    coeffs[1] = -32768
    coeffs[2, ::2] = -32767
    coeffs[2, 1::2] = 32767
    qp = np.asarray([51, 51, 51, 50, 47, 30, 12, 0], np.int32)
    dst = np.zeros(n, bool)
    if size == 4:
        dst[::2] = True
    got = np.asarray(
        residual_class(
            jnp.asarray(coeffs), jnp.asarray(qp), jnp.asarray(dst),
            jnp.zeros(n, bool), jnp.zeros(n, bool),
            jnp.asarray(scaling_factor_matrix(size, 0, lists)), size,
        )
    )
    for i in range(n):
        d = dequant_block(coeffs[i], int(qp[i]), size, 0, lists)
        want = inverse_transform(d, use_dst=bool(dst[i]))
        np.testing.assert_array_equal(got[i], want, err_msg=f"block {i}")
