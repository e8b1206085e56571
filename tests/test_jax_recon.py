"""JAX reconstruction pipeline vs the numpy reference (bit-exact).

Runs on the CPU backend (conftest forces JAX_PLATFORMS=cpu); the same
jitted program runs unchanged on the GPU.
"""

import numpy as np
import pytest

from heif_tpu.container.reader import HeifReader
from heif_tpu.hevc import params
from heif_tpu.hevc import slice as sl
from heif_tpu.hevc.rbsp import remove_emulation_prevention
from heif_tpu.cabac.syntax import TileSyntaxDecoder
from heif_tpu.ops import ref_recon as R


@pytest.fixture(scope="module")
def decoded(halfmoonbay_bytes):
    r = HeifReader(halfmoonbay_bytes)
    heif = r.read()
    rec = heif.hevc_configuration_record()
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:])
    )
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:])
    )
    tids = [1, 22, 38]
    sts, pss, golds = [], [], []
    for tid in tids:
        nal = sl.split_length_prefixed_nals(r.get_item_data(tid), 4)[0]
        ps = sl.parse_slice_header(nal, sps, pps)
        st = TileSyntaxDecoder(sps, pps, ps).decode()
        sts.append(st)
        pss.append(ps)
        golds.append(R.reconstruct_tile(st, sps, pps, ps.header))
    return sps, pps, tids, sts, pss, golds


def test_batched_pipeline_bit_exact(decoded):
    from heif_tpu.ops.batch import pack_batch, reconstruct_batch

    sps, pps, tids, sts, pss, golds = decoded
    bp = pack_batch(sts, sps, pps, pss)
    planes = reconstruct_batch(bp)
    for i, tid in enumerate(tids):
        for c, name in enumerate(("Y", "Cb", "Cr")):
            mism = int(
                (planes[c][i].astype(int) != golds[i][c].astype(int)).sum()
            )
            assert mism == 0, f"tile {tid} {name}: {mism} mismatches"


def test_single_tile_pipeline_bit_exact(decoded):
    from heif_tpu.ops import pack as P
    from heif_tpu.ops.jax_recon import reconstruct_tile_jax

    sps, pps, tids, sts, pss, golds = decoded
    plan = P.pack_tile(sts[0], sps, pps, pss[0].header)
    mine = reconstruct_tile_jax(plan, sps, pss[0].header)
    for c in range(3):
        assert (mine[c].astype(int) == golds[0][c].astype(int)).all()


def test_residual_class_matches_reference():
    """Batched dequant+IDCT vs scalar reference on random blocks."""
    import jax.numpy as jnp

    from heif_tpu.ops.jax_recon import residual_class
    from heif_tpu.ops.ref_recon import dequant_block, inverse_transform
    from heif_tpu.ops.tables import scaling_factor_matrix
    from heif_tpu.hevc.grammar import ScalingListData

    rng = np.random.default_rng(3)
    lists = ScalingListData.default()
    for size in (4, 8, 16, 32):
        n = 5
        coeffs = rng.integers(-3000, 3000, size=(n, size, size), dtype=np.int32)
        qp = rng.integers(0, 51, size=n, dtype=np.int32)
        dst = np.zeros(n, dtype=bool)
        if size == 4:
            dst[::2] = True
        scaling = scaling_factor_matrix(size, 0, lists)
        got = np.asarray(
            residual_class(
                jnp.asarray(coeffs), jnp.asarray(qp), jnp.asarray(dst),
                jnp.zeros(n, bool), jnp.zeros(n, bool),
                jnp.asarray(scaling), size,
            )
        )
        for i in range(n):
            d = dequant_block(coeffs[i], int(qp[i]), size, 0, lists)
            want = inverse_transform(d, use_dst=bool(dst[i]))
            assert (got[i] == want).all(), f"size {size} block {i}"


def test_ref_sources_device_matches_host_packer(decoded):
    """Device-side availability/substitution (closed-form z-scan, no
    gathers) is bit-identical to the host packer's uint8 src tables on
    real halfmoonbay tiles (all components, mixed TU sizes)."""
    import jax
    from heif_tpu.ops import jax_recon as J
    from heif_tpu.ops import pack as P

    sps, pps, tids, sts, pss, golds = decoded
    for st in sts:
        z4 = R.z_order_plane(st.width, st.height, sps.ctb_log2_size_y)
        tt = st.tu_table
        from heif_tpu.cabac import types as T

        for c in range(3):
            rows = tt[tt[:, T.TU_COMP] == c]
            x = rows[:, T.TU_X].astype(np.int32)
            y = rows[:, T.TU_Y].astype(np.int32)
            size = (1 << rows[:, T.TU_LOG2]).astype(np.int32)
            host = P._ref_sources_batch(z4, st.width, st.height, c, x, y, size)
            # padding steps (size == 0) must come back all-255
            xp = np.concatenate([x, np.zeros(3, np.int32)])
            yp = np.concatenate([y, np.zeros(3, np.int32)])
            sp = np.concatenate([size, np.zeros(3, np.int32)])
            dev = np.asarray(
                jax.jit(
                    lambda a, b, s: J.ref_sources_device(
                        a, b, s, comp=c, W=st.width, H=st.height,
                        ctb_log2=sps.ctb_log2_size_y,
                    )
                )(xp, yp, sp)
            )
            np.testing.assert_array_equal(dev[: len(x)], host)
            assert (dev[len(x):] == 255).all()
