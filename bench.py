"""Benchmark of the search path on one GPU: SIFT1M-shaped flat ADC at
recall parity (BASELINE.json configs 2/4), flat SQ (config 1) and IVF-ADC.

    python bench.py          # or: python -m cvt_tpu.cli bench

Pipeline: train OPQ (M=8, K=256 -> 64-bit codes) on a sample, encode a
1M-vector database through FlatADCIndex.add, then time every search
path through its public API, each against the plain XLA route of the
same scan (cvt_tpu.ops.backend), at B=8192 and B=64 (k=10):

  * flat ADC: FlatADCIndex.search (fast and exact=True) and the packed
    scan alone (cvt_tpu.ops.pallas.adc_scan.packed_keys);
  * flat SQ:  FlatSQIndex.search_fast at d=64 and d=128;
  * IVF-ADC:  IVFADCIndex.search_fast at 8192 cells, m=16, nprobe=16,
    B=256, and the probed XLA engine (IVFADCIndex.search).

Recall@1/@10 are measured against exact float ground truth (FlatIndex,
Precision.HIGHEST) and against the independent float32 LUT-ADC
reference over the same codes (cvt_tpu.index.reference) — BASELINE.md's
parity bar is 0.5 pt of recall@1, on the rows of the B=8192 batch.

Timing: the median of REPS calls, each ended by jax.block_until_ready,
after one warm-up call that compiles. The output names the device and
the card's name and power limit; without a GPU the script exits 2.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N_DB = int(os.environ.get("BENCH_N", 1_000_000))
N_TRAIN = 131_072
N_QUERIES = 8192
K = 10
M, KSUB = 8, 256
REPS = int(os.environ.get("BENCH_REPS", 5))
N_REC = int(os.environ.get("BENCH_NREC", 8192))


def timed_ms(fn, *args) -> float:
    """Median wall time of fn(*args) in ms, after a compiling warm-up."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    from cvt_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from cvt_tpu.index import FlatADCIndex, FlatIndex, FlatSQIndex
    from cvt_tpu.index import IVFADCIndex
    from cvt_tpu.index.reference import lut_adc_topk
    from cvt_tpu.io.datasets import load_sift1m, synthetic_sift
    from cvt_tpu.ops.linalg import l2_normalize
    from cvt_tpu.ops.pallas import adc_scan
    from cvt_tpu.quant import OPQ, ScalarQuantizer
    from cvt_tpu.utils import recall_at_k

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t_start = time.time()
    data = load_sift1m()
    if data is not None:
        base, queries, _ = data
        base, queries = base[:N_DB], queries[:N_QUERIES]
        source = "sift1m"
    else:
        # fresh-draw queries (independent of base points): the honest
        # recall regime, like SIFT1M's held-out query set
        base, queries = synthetic_sift(N_DB, 128, n_queries=N_QUERIES,
                                       seed=0, query_mode="fresh")
        source = "synthetic-fresh"
    n = base.shape[0]
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "card": card, "data": source, "n_db": n, "k": K,
           "code_bits": M * 8, "reps": REPS}

    opq = OPQ.train(jax.random.key(0), base[:N_TRAIN], m=M, k=KSUB,
                    opq_iters=4, kmeans_iters=6, final_kmeans_iters=12)
    idx = FlatADCIndex(opq)
    idx.add(base[:FlatADCIndex.ENC_CHUNK])            # compile the encoder
    jax.block_until_ready(idx.search(queries[:64], K))
    idx = FlatADCIndex(opq)
    t0 = time.perf_counter()
    idx.add(base)
    jax.block_until_ready(idx.scan_operand())
    out["ingest_codes_per_s"] = n / (time.perf_counter() - t0)

    # ---- flat ADC: the index path and the scan alone, both routes -------
    dec, norm, srow = idx.scan_operand()
    lanes = {}
    for b in (8192, 64):
        q = queries[:b]
        qr = opq.rotate(q)
        lane = {
            "search_ms": timed_ms(lambda x: idx.search(x, K), q),
            "search_exact_ms": timed_ms(
                lambda x: idx.search(x, K, exact=True), q),
        }
        for route in ("pallas", "xla"):
            lane[f"scan_{route}_ms"] = timed_ms(
                lambda x: adc_scan.packed_keys(x, dec, norm, srow, n,
                                               route=route), qr)
            lane[f"search_{route}_ms"] = timed_ms(
                lambda x: adc_scan.adc_search(x, dec, norm, srow, K, n,
                                              route=route), qr)
        lane["queries_per_s"] = b / lane["search_ms"] * 1e3
        lanes[f"b{b}"] = lane
    out["flat_adc"] = lanes

    # ---- recall vs exact float ground truth and the f32 LUT reference --
    n_rec = min(N_REC, queries.shape[0])
    exact = FlatIndex(128, "l2", chunk=131_072)
    exact.add(base)
    gt = np.concatenate([np.asarray(exact.search(queries[s:e], 1)[1])
                         for s, e in ((s, min(s + 512, n_rec))
                                      for s in range(0, n_rec, 512))])[:, 0]
    del exact
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_index.npz")
    idx.save(path)
    codes = jnp.asarray(np.load(path)["codes"])
    os.remove(path)
    rec = {}
    # the first n_rec rows of the timed B=8192 searches (all by default)
    q = queries[:8192]
    for name, ids in (
            ("fast", idx.search(q, K)[1]),
            ("exact", idx.search(q, K, exact=True)[1]),
            ("f32_lut_adc", lut_adc_topk(opq.rotate(queries[:n_rec]), codes,
                                         opq.pq.codebooks, K)[1])):
        ids = np.asarray(ids)[:n_rec]
        rec[name] = {"recall_at_1": recall_at_k(ids, gt, k=1),
                     "recall_at_10": recall_at_k(ids, gt, k=10)}
    out["recall"] = rec
    out["recall_parity_pt"] = (rec["f32_lut_adc"]["recall_at_1"]
                               - rec["fast"]["recall_at_1"]) * 100

    # ---- flat SQ (sq_train.cpp:42-45: d=64, L2-normalized; also d=128) --
    sq_out = {}
    for d_sq in (64, 128):
        base_sq = np.asarray(l2_normalize(jnp.asarray(base[:, :d_sq])))
        q_sq = np.asarray(l2_normalize(jnp.asarray(queries[:, :d_sq])))
        sqi = FlatSQIndex(ScalarQuantizer.train(base_sq[:N_TRAIN],
                                                l2norm=False), chunk=131_072)
        for s in range(0, n, 262_144):
            sqi.add(base_sq[s:s + 262_144])
        sq_out[f"d{d_sq}"] = {
            "search_fast_ms": timed_ms(lambda x: sqi.search_fast(x, K), q_sq),
            "search_fast_xla_ms": timed_ms(
                lambda x: sqi.search_fast(x, K, impl="xla"), q_sq),
            "search_bf16_ms": timed_ms(lambda x: sqi.search(x, K), q_sq)}
        del sqi
    out["flat_sq_b8192"] = sq_out

    # ---- IVF-ADC at the reference operating point (IVFOPQ.cpp:56-63) ---
    ivf = IVFADCIndex(coarse_k=8192, m=16, k=256)
    ivf.train(jax.random.key(0), base)
    ivf.build(base)
    q = queries[:256]
    out["ivf_adc_b256_nprobe16"] = {
        "search_fast_ms": timed_ms(lambda x: ivf.search_fast(x, K), q),
        "search_fast_xla_ms": timed_ms(
            lambda x: ivf.search_fast(x, K, impl="xla"), q),
        "search_probed_xla_ms": timed_ms(lambda x: ivf.search(x, K), q)}
    out["total_s"] = time.time() - t_start
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
