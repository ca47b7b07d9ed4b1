"""Multi-host serving path (BASELINE config 5) on the virtual CPU mesh:
sharded Pallas scan + all_gather/ring merge + continuous query batching.
Parity asserted against the single-device XLA ADC engine."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cvt_tpu.index import FlatADCIndex
from cvt_tpu.parallel import (MultiHostADCServer, QueryBatcher,
                              init_distributed, serving_mesh)
from cvt_tpu.quant import OPQ, ProductQuantizer

@pytest.fixture(scope="module")
def served():
    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    rng = np.random.default_rng(7)
    base = rng.normal(size=(3000, 64)).astype(np.float32) * 20
    queries = rng.normal(size=(64, 64)).astype(np.float32) * 20
    pq = ProductQuantizer.train(jax.random.key(0), base[:2048], m=8, k=32,
                                iters=6)
    ref = FlatADCIndex(pq, chunk=512, impl="xla")
    ref.add(codes=pq.encode(base))
    d_r, i_r = ref.search(queries, 10)
    return pq, base, queries, np.asarray(d_r), np.asarray(i_r)


def _server(pq, base, merge, seg=128, impl="auto"):
    mesh = serving_mesh(jax.devices("cpu")[:8])
    srv = MultiHostADCServer(pq, mesh, merge=merge, seg=seg, impl=impl)
    srv.load(base)
    return srv


def test_init_distributed_single_process(cpu_devices):
    assert init_distributed() == jax.process_index()


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_serve_parity(served, merge, impl):
    """Plain XLA shard bodies ('auto' on the CPU mesh) and the kernel
    interpreted in every shard ('pallas') against the XLA engine."""
    pq, base, queries, d_r, i_r = served
    srv = _server(pq, base, merge, impl=impl)
    assert srv.route == {"auto": "xla", "pallas": "interpret"}[impl]
    d, i = srv.serve(queries, 10)
    # int8-quantized phase-1 scoring: top-1 must agree almost always,
    # distances within the quantization tolerance
    assert (np.asarray(i)[:, 0] == i_r[:, 0]).mean() >= 0.95
    np.testing.assert_allclose(np.asarray(d)[:, 0], d_r[:, 0],
                               rtol=2e-2, atol=2.0)


def test_serve_n_not_divisible(served):
    """3000 rows over 8 shards x tile 128 -> per-shard padding; padded
    rows must never appear."""
    pq, base, queries, d_r, i_r = served
    srv = _server(pq, base, "allgather")
    d, i = srv.serve(queries, 10)
    i = np.asarray(i)
    assert i.max() < 3000
    assert (i >= 0).all()


def test_serve_pipelined_matches_serve(served):
    pq, base, queries, d_r, i_r = served
    srv = _server(pq, base, "ring")
    d1, i1 = srv.serve(queries[:16], 5)
    qmb = queries[:48].reshape(3, 16, -1)
    d2, i2 = srv.serve_pipelined(qmb, 5)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2)[:16])
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2)[:16],
                               rtol=1e-5)


def test_per_host_ingestion_contract(served):
    """load_local with explicit n_global reproduces load() (single
    process owns every shard)."""
    pq, base, queries, d_r, i_r = served
    mesh = serving_mesh(jax.devices("cpu")[:8])
    srv = MultiHostADCServer(pq, mesh)
    codes = srv.encode(base)
    start, stop, per = srv.shard_rows(base.shape[0])
    assert start == 0 and stop == base.shape[0]
    srv.load_local(codes[start:stop], n_global=base.shape[0])
    d, i = srv.serve(queries[:8], 5)
    srv2 = _server(pq, base, "allgather")
    d2, i2 = srv2.serve(queries[:8], 5)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i2))


def test_query_batcher(served):
    pq, base, queries, d_r, i_r = served
    srv = _server(pq, base, "allgather")
    batcher = QueryBatcher(srv.serve, batch_size=32, k=10, max_wait_ms=20)
    futs = [batcher.submit(queries[j:j + 4]) for j in range(0, 64, 4)]
    try:
        for j, f in enumerate(futs):
            d, i = f.result(timeout=60)
            assert d.shape == (4, 10) and i.shape == (4, 10)
            assert (i[:, 0] == i_r[4 * j:4 * j + 4, 0]).mean() >= 0.75
    finally:
        batcher.close()


def test_query_batcher_propagates_errors(served):
    pq, base, queries, d_r, i_r = served

    def bad_serve(q, k):
        raise RuntimeError("boom")

    batcher = QueryBatcher(bad_serve, batch_size=8, k=5, max_wait_ms=5)
    fut = batcher.submit(queries[:2])
    try:
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
    finally:
        batcher.close()
