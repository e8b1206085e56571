"""The chunked batch driver (ops.batch): wire blobs never shared between
chunks, chunk planning, the ahead-of-time compiled core, and the trace
reduction that attributes device time to the core's named stages."""

import glob

import numpy as np
import pytest


def _plans(n_tiles: int, seed0: int = 0):
    from heif_tpu.ops.batch import pack_batch
    from heif_tpu.utils.synthetic import (
        _FakeParsed,
        synthetic_sps_pps,
        synthetic_tile,
    )

    sps, pps, sh = synthetic_sps_pps(64)
    sts = [synthetic_tile(64, seed=seed0 + i) for i in range(n_tiles)]
    slices = [_FakeParsed(sh) for _ in sts]
    return sps, pps, sts, slices, pack_batch


def test_bundles_never_share_buffers():
    """A bundle's blobs stay intact while later chunks bundle: the device
    arrays made from them may alias host memory, so a rewrite would
    corrupt a chunk still in flight."""
    from heif_tpu.ops.batch import _bundle_plan, _chunk_shapes

    sps, pps, sts, slices, pack_batch = _plans(3)
    n_steps, caps = _chunk_shapes(sts, 1)  # one blob size for all three
    bps = [
        pack_batch([st], sps, pps, [sl], n_steps=n_steps, class_caps=caps)
        for st, sl in zip(sts, slices)
    ]
    first = _bundle_plan(bps[0])
    kept = [b.copy() for b in first[:3]]
    later = [_bundle_plan(bp) for bp in bps[1:]]
    for b, k in zip(first[:3], kept):
        np.testing.assert_array_equal(b, k)
    for other in later:
        for a, b in zip(first[:3], other[:3]):
            assert not np.shares_memory(a, b)


def test_plan_chunks_share_one_shape():
    """Five tiles in chunks of two: three plans of two tiles each (the last
    padded), all with one core layout, decoding like one plan."""
    from heif_tpu.ops.batch import (
        _bundle_plan,
        plan_chunks,
        reconstruct_batch,
        reconstruct_pipelined,
    )

    sps, pps, sts, slices, pack_batch = _plans(5)
    plans = list(plan_chunks(sts, sps, pps, slices, chunk=2))
    assert [bp.n for bp in plans] == [2, 2, 2]
    layouts = {_bundle_plan(bp)[4][:2] for bp in plans}  # classes, steps
    assert len(layouts) == 1
    got = reconstruct_pipelined(sts, sps, pps, slices, chunk=2)
    want = reconstruct_batch(pack_batch(sts, sps, pps, slices))
    for c in range(3):
        assert got[c].shape[0] == 5
        np.testing.assert_array_equal(got[c], want[c])


def test_compile_core_matches_dispatch():
    from heif_tpu.ops.batch import _dispatch_core, compile_core, core_inputs

    sps, pps, sts, slices, pack_batch = _plans(2)
    bp = pack_batch(sts, sps, pps, slices)
    compiled = compile_core(bp)
    assert compiled.memory_analysis().argument_size_in_bytes > 0
    args, _ = core_inputs(bp)
    got = compiled(*args)
    want = _dispatch_core(bp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_trace_scope_reduction(tmp_path):
    """tools/trace_share attributes a traced program's events to the
    named scopes of its HLO. It reads GPU planes unless told otherwise;
    here on the CPU the ops run on the host:CPU plane, which it reads
    only when asked."""
    import importlib.util
    import pathlib

    import jax
    import jax.numpy as jnp

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "trace_share.py"
    spec = importlib.util.spec_from_file_location("trace_share", path)
    ts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ts)

    def stages(x):
        with jax.named_scope("intra"):
            x = jnp.tanh(x @ x + 1)
        with jax.named_scope("sao"):
            x = jnp.sin(x).sum(axis=1)
        return x

    fn = jax.jit(stages)
    x = jnp.ones((512, 512))
    compiled = fn.lower(x).compile()
    scopes_of = ts.op_scopes(compiled.as_text())
    assert set(scopes_of.values()) == {"intra", "sao"}
    fn(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        fn(x).block_until_ready()
    (pb,) = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)
    assert ts.scope_times(pb, scopes_of, "jit_stages")["planes"] == []
    res = ts.scope_times(pb, scopes_of, "jit_stages", plane="/host:CPU")
    assert res["planes"] == ["/host:CPU"]
    assert res["ns"].get("intra", 0) > 0
    assert res["ns"].get("sao", 0) > 0
    assert ts.main([str(tmp_path)]) == 1  # no GPU: no reading at all
