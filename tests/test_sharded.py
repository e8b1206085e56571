"""Multi-chip sharded decode (shard_map over a tile mesh) vs the oracle.

Runs on the virtual 8-device CPU mesh built by conftest (mirrors the
reference's test-without-special-hardware strategy, SURVEY.md §4). The
same code path shards over GPUs through the identical Mesh API
(`python chip_smoke.py --mesh 4` runs it on four cards).
"""

import numpy as np
import pytest

from heif_tpu.container.reader import HeifReader, parse_grid_config
from heif_tpu.hevc import params
from heif_tpu.hevc import slice as sl
from heif_tpu.hevc.rbsp import remove_emulation_prevention


def _setup(halfmoonbay_bytes, n_tiles):
    from heif_tpu.cabac.syntax import TileSyntaxDecoder
    from heif_tpu import native

    r = HeifReader(halfmoonbay_bytes)
    heif = r.read()
    rec = heif.hevc_configuration_record()
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:])
    )
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:])
    )
    primary = heif.primary_item_id()
    tile_ids = heif.item_ids_referencing(primary, "dimg")[:n_tiles]
    slices = [
        sl.parse_slice_header(
            sl.split_length_prefixed_nals(r.get_item_data(t), 4)[0], sps, pps
        )
        for t in tile_ids
    ]
    if native.available():
        syn = native.decode_tiles_parallel(sps, pps, slices)
    else:
        syn = [TileSyntaxDecoder(sps, pps, ps).decode() for ps in slices]
    return sps, pps, slices, syn


def _oracle_tiles(halfmoonbay_bytes, n_tiles):
    from heif_tpu.utils import oracle

    ref = oracle.decode_heic_via_de265(halfmoonbay_bytes)
    tiles = []
    for t in range(n_tiles):
        rr, cc = divmod(t, 8)
        ys, xs = rr * 512, cc * 512
        tiles.append(
            (
                ref["Y"][ys : ys + 512, xs : xs + 512],
                ref["Cb"][ys // 2 : ys // 2 + 256, xs // 2 : xs // 2 + 256],
                ref["Cr"][ys // 2 : ys // 2 + 256, xs // 2 : xs // 2 + 256],
            )
        )
    return tiles


def _check(planes, refs):
    y, cb, cr = planes
    for i, (ry, rcb, rcr) in enumerate(refs):
        assert np.array_equal(y[i][: ry.shape[0], : ry.shape[1]], ry), (
            f"tile {i} Y differs"
        )
        assert np.array_equal(cb[i][: rcb.shape[0], : rcb.shape[1]], rcb), (
            f"tile {i} Cb differs"
        )
        assert np.array_equal(cr[i][: rcr.shape[0], : rcr.shape[1]], rcr), (
            f"tile {i} Cr differs"
        )


def test_sharded_decode_real_tiles_bit_exact(halfmoonbay_bytes):
    """16 real tiles sharded 2-per-device over the 8-device mesh."""
    import jax

    from heif_tpu.parallel.pipeline import decode_grid_sharded, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    sps, pps, slices, syn = _setup(halfmoonbay_bytes, 16)
    mesh = make_mesh(8)
    planes = decode_grid_sharded(syn, sps, pps, slices, mesh=mesh)
    _check(planes, _oracle_tiles(halfmoonbay_bytes, 16))


@pytest.mark.slow
def test_sharded_decode_full_grid_bit_exact(halfmoonbay_bytes):
    """All 48 halfmoonbay tiles sharded over the 8-device mesh, vs oracle."""
    import jax

    from heif_tpu.parallel.pipeline import decode_grid_sharded, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    sps, pps, slices, syn = _setup(halfmoonbay_bytes, 48)
    mesh = make_mesh(8)
    planes = decode_grid_sharded(syn, sps, pps, slices, mesh=mesh)
    _check(planes, _oracle_tiles(halfmoonbay_bytes, 48))


def test_sharded_streamed_decode_bit_exact(halfmoonbay_bytes):
    """Streamed (chunked, entropy-overlapped) sharded decode: 32 tiles in
    16-tile chunks over the 8-device mesh, bit-exact vs the oracle and
    one compiled program across chunks."""
    import jax

    from heif_tpu.parallel.pipeline import (
        decode_grid_sharded_streamed,
        make_mesh,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    sps, pps, slices, _syn = _setup(halfmoonbay_bytes, 32)
    mesh = make_mesh(8)
    planes = decode_grid_sharded_streamed(sps, pps, slices, mesh=mesh)
    _check(planes, _oracle_tiles(halfmoonbay_bytes, 32))


def test_sharded_streamed_uneven_tail(halfmoonbay_bytes):
    """Streamed sharded decode where the last chunk is partial (20 tiles,
    chunk 16): the tail chunk pads to the shared shape and the padding is
    dropped from the output."""
    import jax

    from heif_tpu.parallel.pipeline import (
        decode_grid_sharded_streamed,
        make_mesh,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    sps, pps, slices, _syn = _setup(halfmoonbay_bytes, 20)
    mesh = make_mesh(8)
    planes = decode_grid_sharded_streamed(sps, pps, slices, mesh=mesh)
    assert planes[0].shape[0] == 20
    _check(planes, _oracle_tiles(halfmoonbay_bytes, 20))
