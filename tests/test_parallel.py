"""Sharded search and distributed k-means on the virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvt_tpu.index import FlatADCIndex
from cvt_tpu.ops.pallas import adc_scan
from cvt_tpu.parallel import ShardedADCSearcher, cpu_mesh, sharded_kmeans_step
from cvt_tpu.quant import OPQ, ProductQuantizer

@pytest.fixture(scope="module")
def trained(sift_like):
    if len(jax.devices("cpu")) < 4:
        pytest.skip("needs >=4 virtual CPU devices")
    base, queries = sift_like
    pq = ProductQuantizer.train(jax.random.key(0), base[:2048], m=8, k=64,
                                iters=8)
    return pq, base, queries


def test_sharded_search_matches_single_device(trained):
    pq, base, queries = trained
    mesh = cpu_mesh({"db": 4})
    s = ShardedADCSearcher(pq, mesh)
    s.load(base)
    with jax.default_device(jax.devices("cpu")[0]):
        d_s, i_s = map(np.asarray, s.search(queries[:16], 10))
        ref = FlatADCIndex(pq, impl="xla")
        ref.add(codes=pq.encode(base))
        d_r, i_r = map(np.asarray, ref.search(queries[:16], 10))
        # the same scan on one device, over the shards' 64-row segments
        dec, norm, srow = ref.scan_operand()
        d_1, _ = adc_scan.adc_search(jnp.asarray(queries[:16]), dec, norm,
                                     srow, 10, base.shape[0], seg=64,
                                     route="xla")
    # shard boundaries are segment boundaries: the merge is exact
    np.testing.assert_array_equal(d_s, np.asarray(d_1))
    # the best key does not depend on the segment size; ids may differ
    # only between rows of identical codes (ties break on the lane)
    np.testing.assert_array_equal(d_s[:, 0], d_r[:, 0])
    codes = np.asarray(pq.encode(base))
    assert (codes[i_s[:, 0]] == codes[i_r[:, 0]]).all(1).mean() > 0.95


def test_sharded_search_pallas_impl(trained):
    """The packed scan kernel inside the shard_map body (interpreted on
    the CPU mesh) gives the plain XLA twin's shard bodies bit for bit."""
    pq, base, queries = trained
    mesh = cpu_mesh({"db": 4})
    s = ShardedADCSearcher(pq, mesh, impl="pallas", seg=64)
    assert s.route == "interpret"
    s.load(base)
    d, i = s.search(queries[:16], 10)
    s_x = ShardedADCSearcher(pq, mesh, impl="xla", seg=64)
    assert s_x.route == "xla"
    s_x.load(base)
    d_x, i_x = s_x.search(queries[:16], 10)
    np.testing.assert_array_equal(np.asarray(d), np.asarray(d_x))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_x))
    assert np.asarray(i).max() < base.shape[0]


def test_sharded_search_n_not_divisible(trained):
    """Database size not divisible by the shard count: padding rows must
    never surface."""
    pq, base, queries = trained
    mesh = cpu_mesh({"db": 4})
    n = 3000
    s = ShardedADCSearcher(pq, mesh)
    s.load(base[:n])
    d, i = s.search(queries[:8], 10)
    ids = np.asarray(i)
    assert ids.max() < n
    assert (ids >= 0).all()


def test_sharded_search_with_opq(trained):
    _, base, queries = trained
    opq = OPQ.train(jax.random.key(1), base[:2048], m=8, k=64, opq_iters=2,
                    kmeans_iters=4, final_kmeans_iters=6)
    mesh = cpu_mesh({"db": 2})
    s = ShardedADCSearcher(opq, mesh)
    s.load(base)
    d, i = s.search(queries[:8], 5)
    ref = FlatADCIndex(opq, chunk=1024, impl="xla")
    ref.add(base)
    d_r, i_r = ref.search(queries[:8], 5)
    # same best key; ids differ only between rows of identical codes
    np.testing.assert_array_equal(np.asarray(d)[:, 0], np.asarray(d_r)[:, 0])
    codes = np.asarray(ref._codes)
    top1 = (codes[np.asarray(i)[:, 0]] == codes[np.asarray(i_r)[:, 0]])
    assert top1.all(1).mean() > 0.8


def test_sharded_kmeans_matches_single_device(rng, cpu_devices):
    x = rng.normal(size=(1024, 16)).astype(np.float32)
    c0 = x[:8].copy()
    mesh = cpu_mesh({"dp": 4})
    from jax.sharding import NamedSharding, PartitionSpec as P
    xs = jax.device_put(x, NamedSharding(mesh, P("dp", None)))
    cs = jax.device_put(c0, NamedSharding(mesh, P()))
    new_c, obj = sharded_kmeans_step(mesh, xs, cs)

    # single-device reference Lloyd step
    d = ((x[:, None, :] - c0[None, :, :]) ** 2).sum(-1)
    a = d.argmin(-1)
    expect = np.stack([x[a == j].mean(0) if (a == j).any() else c0[j]
                       for j in range(8)])
    np.testing.assert_allclose(np.asarray(new_c), expect, rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(obj), d.min(-1).mean(), rtol=1e-4)
