"""Smoke run of the main path on the GPU, at the sizes users run.

    python chip_smoke.py            # one GPU: five phases
    python chip_smoke.py --multi    # four GPUs: sharded serving only

Run from the repository root. Data comes from --seed (no download):
SIFT1M-shaped vectors (N = 2^20 x d = 128) from synthetic_sift and
procedural images. Each phase prints one JSON line with its wall time
(set-up, not a metric), the scan route cvt_tpu.ops.backend chose, and
its checks. The last line is {"ok": true, "device": {...}}; a failed
check, an exception, or a route other than the compiled kernel ends the
run with a non-zero exit and no such line. So does a machine without a
GPU, or a directory without the cvt_tpu package.

Phases (one GPU):
  1. flat_adc  — OPQ 64-bit codes, FlatADCIndex at B=8192, k=10: kernel
                 vs its plain XLA twin (bit-identical keys), the fast
                 path and exact=True vs an independent float32 LUT-ADC
                 reference, recall@1/@10 vs exact float ground truth.
  2. flat_sq   — FlatSQIndex.search_fast vs search at d=128 and d=64.
  3. ivf_adc   — IVFADCIndex(8192 cells, m=16) search_fast vs search.
  4. serve     — `cvt_tpu serve` over an fvecs file, and QueryBatcher.
  5. features  — SIFT extraction, matching and homography RANSAC.
--multi (four GPUs): 4 x 2^20 codes; serve with allgather and ring
merges bitwise against a one-GPU serve, serve_pipelined, a 2-D dp x db
mesh, ShardedADCSearcher and sharded_kmeans_step against one device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
IMPL = "auto"                 # what a user passes: the switch decides
KERNEL_ROUTE = "pallas"       # the compiled kernel; never "interpret"
N_DB = 1 << 20                # SIFT1M shape
DIM = 128
N_TRAIN = 131_072
BATCH = 8192
K = 10
N_REC = BATCH                 # recall: every row of the B=8192 batch
N_SQ = 2048                   # SQ search_fast vs search queries
N_REF = 256                   # queries checked against the LUT reference
INT8_SLACK = (1.02, 1.0)      # fast-path top-1: true dist <= a*best + b
RECALL_GAP_PT = 0.5           # BASELINE.md: recall@1 parity bar
IVF_CELLS = 8192              # opq/src/IVFOPQ.cpp:56-63
IMAGE_HW = (480, 640)
MAX_FEATURES = 8192


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, route: str, t0: float, **checks) -> None:
    print(json.dumps({"phase": phase, "route": route,
                      "wall_s": round(time.perf_counter() - t0, 3),
                      **checks}), flush=True)


def check_route(route: str) -> str:
    require(route == KERNEL_ROUTE,
            f"route {route!r}, expected {KERNEL_ROUTE!r}")
    return route


def peak_bytes(dev) -> int | None:
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


# ------------------------------------------------------------ references
def int8_tolerance(got, best) -> tuple[float, float]:
    """(share of queries within the int8 tolerance, largest excess)."""
    a, b = INT8_SLACK
    excess = np.asarray(got) - (a * np.asarray(best) + b)
    return float(np.mean(excess <= 0)), float(excess.max())


def ground_truth(base, queries, k: int):
    """Exact float top-k (FlatIndex, Precision.HIGHEST products)."""
    from cvt_tpu.index import FlatIndex
    exact = FlatIndex(base.shape[1], "l2", chunk=131_072)
    exact.add(base)
    parts = [np.asarray(exact.search(queries[s:s + 512], k)[1])
             for s in range(0, len(queries), 512)]
    return np.concatenate(parts)


# ----------------------------------------------------------------- phases
def phase_flat_adc(ctx, seed: int):
    from cvt_tpu.index import FlatADCIndex
    from cvt_tpu.index.reference import lut_adc_dist, lut_adc_topk
    from cvt_tpu.io.datasets import synthetic_sift
    from cvt_tpu.ops import backend
    from cvt_tpu.ops.pallas import adc_scan
    from cvt_tpu.quant import OPQ
    from cvt_tpu.utils import recall_at_k

    t0 = time.perf_counter()
    base, queries = synthetic_sift(N_DB, DIM, n_queries=BATCH, seed=seed,
                                   query_mode="fresh")
    opq = OPQ.train(jax.random.key(seed), base[:N_TRAIN], m=8, k=256,
                    opq_iters=4, kmeans_iters=6, final_kmeans_iters=12)
    idx = FlatADCIndex(opq, impl=IMPL)
    idx.add(base)
    route = check_route(backend.scan_route(impl=idx.impl))
    d_fast, i_fast = map(np.asarray, idx.search(queries, K))
    d_ex, i_ex = map(np.asarray, idx.search(queries, K, exact=True))
    idx.build_decoded_cache()
    d_c, i_c = map(np.asarray, idx.search(queries, K))
    require(d_fast.shape == i_fast.shape == (BATCH, K), "fast shape")
    require(np.isfinite(d_fast).all() and (i_fast >= 0).all(), "fast ids")
    require(np.array_equal(i_c, i_fast) and np.array_equal(d_c, d_fast),
            "search after build_decoded_cache() differs")

    # kernel vs plain twin, on the same operand
    qr = opq.rotate(queries)
    dec, norm, srow = idx.scan_operand()
    keys_k = adc_scan.packed_keys(qr, dec, norm, srow, N_DB, route=route)
    keys_x = adc_scan.packed_keys(qr, dec, norm, srow, N_DB, route="xla")
    keys_equal = bool(jnp.array_equal(keys_k, keys_x))
    del keys_k, keys_x
    d_x, i_x = map(np.asarray, adc_scan.adc_search(
        qr, dec, norm, srow, K, N_DB, route="xla"))
    require(keys_equal, "kernel and plain twin packed keys differ")
    require(np.array_equal(i_x, i_fast) and np.array_equal(d_x, d_fast),
            f"kernel and plain twin results differ: "
            f"{int((i_x != i_fast).any(1).sum())} rows of ids, "
            f"{int((d_x != d_fast).any(1).sum())} rows of dists")

    # independent float32 LUT-ADC reference
    path = os.path.join(ctx["tmp"], "adc_index.npz")
    idx.save(path)
    codes = jnp.asarray(np.load(path)["codes"])
    cb = opq.pq.codebooks
    ref_d, ref_i = lut_adc_topk(qr[:N_REF], codes, cb, K)
    best = np.asarray(ref_d)[:, 0]
    got = np.asarray(lut_adc_dist(qr[:N_REF], codes[i_fast[:N_REF, 0]], cb))
    share_fast, excess_fast = int8_tolerance(got, best)
    rel_ex = np.abs(d_ex[:N_REF, 0] - best) / np.maximum(best, 1e-6)
    share_ex = float(np.mean(rel_ex <= 1e-4))
    require(share_fast >= 0.99, f"fast path within int8 tol {share_fast}")
    require(share_ex >= 0.99, f"exact=True within rtol 1e-4 {share_ex}")

    # recall parity against exact float ground truth, on every row of the
    # B=8192 searches above; the gap's sampling sd is sqrt(d)/N_REC for d
    # queries whose top-1 is right on one side only (printed)
    gt = ground_truth(base, queries[:N_REC], 1)[:, 0]
    lut_ids = np.asarray(lut_adc_topk(qr[:N_REC], codes, cb, K)[1])
    rec_fast = i_fast[:N_REC]
    rec = {name: (recall_at_k(ids, gt, k=1), recall_at_k(ids, gt, k=10))
           for name, ids in (("fast", rec_fast), ("exact", i_ex[:N_REC]),
                             ("f32_lut", lut_ids))}
    top1_differs = int((rec_fast[:, 0] != lut_ids[:, 0]).sum())
    discordant = int(((rec_fast[:, 0] == gt) != (lut_ids[:, 0] == gt)).sum())
    gap_pt = (rec["f32_lut"][0] - rec["fast"][0]) * 100
    require(gap_pt <= RECALL_GAP_PT,
            f"recall@1 {gap_pt:.2f} pt below the f32 LUT ({rec}; top-1 "
            f"differs from the f32 LUT on {top1_differs} queries)")
    emit("flat_adc", route, t0, n=N_DB, batch=BATCH, k=K,
         kernel_twin_bit_identical=keys_equal,
         fast_within_int8_tol=share_fast, fast_max_excess=excess_fast,
         exact_within_rtol_1e4=share_ex,
         exact_max_rel_err=float(rel_ex.max()),
         recall_at_1={k: round(v[0], 4) for k, v in rec.items()},
         recall_at_10={k: round(v[1], 4) for k, v in rec.items()},
         recall_at_1_gap_pt=round(gap_pt, 2),
         recall_at_1_gap_sd_pt=round(100 * discordant ** 0.5 / N_REC, 2),
         recall_queries=N_REC,
         recall_queries_top1_differs_from_f32_lut=top1_differs,
         peak_bytes_in_use=peak_bytes(ctx["dev"]))
    ctx.update(base=base, queries=queries, opq=opq, codes=codes,
               gt=gt, index_path=path)


def phase_flat_sq(ctx, seed: int):
    from cvt_tpu.index import FlatSQIndex
    from cvt_tpu.ops import backend
    from cvt_tpu.ops.linalg import l2_normalize
    from cvt_tpu.quant import ScalarQuantizer

    t0 = time.perf_counter()
    route = check_route(backend.scan_route(impl=IMPL))
    checks = {}
    for d in (128, 64):
        base = np.asarray(l2_normalize(jnp.asarray(ctx["base"][:, :d])))
        q = np.asarray(l2_normalize(jnp.asarray(
            ctx["queries"][:N_SQ, :d])))
        sq = ScalarQuantizer.train(base[:N_TRAIN], l2norm=False)
        idx = FlatSQIndex(sq, chunk=131_072)
        for s in range(0, len(base), 262_144):
            idx.add(base[s:s + 262_144])
        d_ref, i_ref = map(np.asarray, idx.search(q, K))
        d_f, i_f = map(np.asarray, idx.search_fast(q, K, impl=IMPL))
        top1 = float((i_ref[:, 0] == i_f[:, 0]).mean())
        rel = float(np.median(np.abs(np.sort(d_f, 1) - np.sort(d_ref, 1))
                              / np.maximum(np.sort(d_ref, 1), 1e-3)))
        require(top1 >= 0.95, f"SQ d={d} top-1 agreement {top1}")
        require(rel < 0.05, f"SQ d={d} median relative gap {rel}")
        checks[f"d{d}"] = {"top1_agreement": top1,
                           "median_rel_gap": rel}
        del idx
    emit("flat_sq", route, t0, n=N_DB, queries=N_SQ, **checks)


def phase_ivf_adc(ctx, seed: int):
    from cvt_tpu.index import IVFADCIndex
    from cvt_tpu.ops import backend
    from cvt_tpu.utils import recall_at_k

    t0 = time.perf_counter()
    route = check_route(backend.scan_route(impl=IMPL))
    idx = IVFADCIndex(coarse_k=IVF_CELLS, m=16, k=256)
    idx.train(jax.random.key(seed), ctx["base"])
    idx.build(ctx["base"])
    q = ctx["queries"][:256]
    d_ref, i_ref = map(np.asarray, idx.search(q, K, nprobe=16))
    d_f, i_f, dropped = idx.search_fast(q, K, nprobe=16, impl=IMPL)
    d_f, i_f, dropped = np.asarray(d_f), np.asarray(i_f), int(dropped)
    rel = float((np.abs(d_f - d_ref) / np.maximum(d_ref, 1.0)).max())
    gt = ctx["gt"][:256]
    r_ref = recall_at_k(i_ref, gt, k=10)
    r_f = recall_at_k(i_f, gt, k=10)
    dups = sum(len(np.unique(r[r >= 0])) != len(r[r >= 0]) for r in i_f)
    require(dropped == 0, f"{dropped} probed pages dropped")
    require(rel < 0.03, f"IVF max relative distance gap {rel}")
    require(abs(r_ref - r_f) <= 0.05, f"IVF recall@10 {r_f} vs {r_ref}")
    require(dups == 0, f"{dups} rows with duplicate ids")
    emit("ivf_adc", route, t0, coarse_k=IVF_CELLS, m=16, nprobe=16, batch=256,
         dropped=dropped, max_rel_gap=rel, recall_at_10_fast=r_f,
         recall_at_10_xla=r_ref, peak_bytes_in_use=peak_bytes(ctx["dev"]))


def phase_serve(ctx, seed: int):
    from cvt_tpu import cli
    from cvt_tpu.index.reference import lut_adc_dist, lut_adc_topk
    from cvt_tpu.io.vecs import write_fvecs
    from cvt_tpu.parallel import MultiHostADCServer, QueryBatcher
    from cvt_tpu.parallel import serving_mesh

    t0 = time.perf_counter()
    opq, codes = ctx["opq"], ctx["codes"]
    qpath = os.path.join(ctx["tmp"], "queries.fvecs")
    queries = ctx["queries"][:1024]
    write_fvecs(qpath, queries)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["serve", "--index", ctx["index_path"], "--queries", qpath,
                  "--k", str(K), "--batch", "1024"])
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    require(len(rows) == 1024, f"serve answered {len(rows)} of 1024")
    ids = np.asarray([r["ids"] for r in rows])
    require(ids.shape == (1024, K) and (ids >= 0).all()
            and (ids < N_DB).all(), "serve ids")

    srv = MultiHostADCServer(opq, serving_mesh(jax.devices()[:1]),
                             impl=IMPL)
    route = check_route(srv.route)
    srv.load(codes=np.asarray(codes))
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 65, size=16)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    batcher = QueryBatcher(srv.serve, batch_size=256, k=K, max_wait_ms=5)
    try:
        futs = [batcher.submit(queries[s:s + n])
                for s, n in zip(starts, sizes)]
        answers = [f.result(timeout=600) for f in futs]
    finally:
        batcher.close()
    for n, (d, i) in zip(sizes, answers):
        require(d.shape == i.shape == (n, K), "batcher answer shape")
    b_ids = np.concatenate([i for _, i in answers])
    n_b = int(sizes.sum())

    qr = opq.rotate(queries)
    cb = opq.pq.codebooks
    best = np.asarray(lut_adc_topk(qr, codes, cb, 1)[0])[:, 0]
    shares = {}
    for name, top1, nq in (("cli", ids[:, 0], 1024),
                           ("batcher", b_ids[:, 0], n_b)):
        got = np.asarray(lut_adc_dist(qr[:nq], codes[top1], cb))
        shares[name] = int8_tolerance(got, best[:nq])
        require(shares[name][0] >= 0.99,
                f"serve ({name}) within int8 tol {shares[name][0]}")
    emit("serve", route, t0, cli_queries=1024, batcher_requests=16,
         batcher_queries=n_b,
         within_int8_tol={k: v[0] for k, v in shares.items()},
         max_excess={k: v[1] for k, v in shares.items()})


def phase_features(ctx, seed: int):
    from cvt_tpu.apps.undistort import warp_image_homography
    from cvt_tpu.features import extract_sift
    from cvt_tpu.io.datasets import procedural_images
    from cvt_tpu.match import match_descriptors, ransac
    from cvt_tpu.match.solvers import apply_homography

    t0 = time.perf_counter()
    h, w = IMAGE_HW
    imgs = procedural_images(4, h, w, seed=seed)
    a = np.deg2rad(4.0)
    # true map from image 0 to the warped copy (source -> target)
    h_true = np.array([[0.95 * np.cos(a), -0.95 * np.sin(a), 24.0],
                       [0.95 * np.sin(a), 0.95 * np.cos(a), 12.0],
                       [2e-5, 1e-5, 1.0]], np.float32)
    warped = np.asarray(warp_image_homography(
        imgs[0], np.linalg.inv(h_true), h, w))
    feats = extract_sift(np.concatenate([imgs, warped[None]]),
                         max_features=MAX_FEATURES, first_octave=-1)
    n_feat = np.asarray(feats.valid).sum(axis=1)
    require((n_feat > 500).all(), f"features per image {n_feat}")
    m = match_descriptors(feats.descriptors[0], feats.descriptors[4],
                          feats.valid[0], feats.valid[4])
    src = feats.frames[0, :, :2]
    dst = feats.frames[4, m.idx2, :2]
    res = ransac(jax.random.key(seed), src, dst, m.valid,
                 model="homography")
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                       np.float32)
    err = np.linalg.norm(
        np.asarray(apply_homography(res.model, corners))
        - np.asarray(apply_homography(h_true, corners)), axis=1)
    require(bool(res.success), "RANSAC failed")
    require(err.max() < 2.0, f"homography corner error {err.max():.2f} px")
    require("PIL" not in sys.modules, "the features phase imported PIL")
    emit("features", "xla", t0, images=4, size=[h, w],
         features=[int(x) for x in n_feat],
         matches=int(np.asarray(m.valid).sum()),
         inliers=int(res.n_inliers), corner_err_px=float(err.max()))


# ------------------------------------------------------------- four GPUs
def run_multi(ctx, seed: int):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from cvt_tpu.index.reference import lut_adc_dist, lut_adc_topk
    from cvt_tpu.io.datasets import synthetic_sift
    from cvt_tpu.parallel import (MultiHostADCServer, ShardedADCSearcher,
                                  make_mesh, serving_mesh,
                                  sharded_kmeans_step)
    from cvt_tpu.quant import OPQ

    devs = jax.devices()
    require(len(devs) >= 4, f"--multi needs 4 GPUs, have {len(devs)}")
    devs = devs[:4]
    t0 = time.perf_counter()
    per, b = N_DB, 1024               # 2^20 rows per GPU
    base0, queries = synthetic_sift(per, DIM, n_queries=b, seed=seed)
    opq = OPQ.train(jax.random.key(seed), base0[:N_TRAIN], m=8, k=256,
                    opq_iters=4, kmeans_iters=6, final_kmeans_iters=12)
    one = MultiHostADCServer(opq, serving_mesh(devs[:1]), impl=IMPL)
    parts = []
    for s in range(4):
        x = base0 if s == 0 else synthetic_sift(per, DIM, seed=seed + s)
        parts += [one.encode(x[r:r + 262_144])
                  for r in range(0, per, 262_144)]
    del base0, x
    codes = np.concatenate(parts)
    n = codes.shape[0]
    qr = opq.rotate(queries)
    cb = opq.pq.codebooks
    best = np.asarray(lut_adc_topk(qr, jnp.asarray(codes), cb, 1)[0])[:, 0]
    codes_d = jnp.asarray(codes)

    def loose(name, ids):
        got = np.asarray(lut_adc_dist(qr, codes_d[ids[:, 0]], cb))
        share, excess = int8_tolerance(got, best)
        require(share >= 0.99, f"{name} within int8 tol {share}")
        return share

    one.load(codes=codes)
    route = check_route(one.route)
    d1, i1 = map(np.asarray, one.serve(queries, K))
    checks = {"one_gpu_within_int8_tol": loose("one-GPU serve", i1)}
    uniq = np.array([[np.sum(r == v) == 1 for v in r] for r in d1])
    uniq &= d1 < d1[:, -1:]
    for merge in ("allgather", "ring"):
        srv = MultiHostADCServer(opq, serving_mesh(devs), merge=merge,
                                 impl=IMPL)
        check_route(srv.route)
        srv.load(codes=codes)
        shard_devs = {s.device for s in srv._dec8.addressable_shards}
        require(len(shard_devs) == 4, f"shards on {len(shard_devs)} GPUs")
        d, i = map(np.asarray, srv.serve(queries, K))
        require(np.array_equal(d, d1), f"{merge}: dists != one-GPU serve")
        require(np.array_equal(i[uniq], i1[uniq]),
                f"{merge}: ids != one-GPU serve where dists are unique")
        checks[f"{merge}_bitwise_dists"] = True
        if merge == "ring":
            dp_, ip_ = srv.serve_pipelined(queries.reshape(4, b // 4, DIM),
                                           K)
            checks["pipelined_within_int8_tol"] = loose(
                "serve_pipelined", np.asarray(ip_))
        del srv
    mesh2 = make_mesh({"dp": 2, "db": 2}, devices=devs)
    srv2 = MultiHostADCServer(opq, mesh2, dp_axis="dp", merge="ring",
                              impl=IMPL)
    srv2.load(codes=codes)
    checks["dp2_db2_within_int8_tol"] = loose(
        "2-D serve", np.asarray(srv2.serve(queries, K)[1]))
    del srv2
    ss = ShardedADCSearcher(opq, make_mesh({"db": 4}, devices=devs),
                            impl=IMPL)
    check_route(ss.route)
    ss.load(codes=codes)
    d_s, i_s = map(np.asarray, ss.search(queries, K))
    checks["searcher_within_int8_tol"] = loose("ShardedADCSearcher", i_s)
    checks["searcher_bitwise_dists"] = bool(np.array_equal(d_s, d1))

    # data-parallel Lloyd step against the same step on one device
    x = jax.random.normal(jax.random.key(seed), (1 << 18, DIM)) * 30
    c0 = x[:1024]
    mesh_dp = make_mesh({"dp": 4}, devices=devs)
    c4, o4 = sharded_kmeans_step(
        mesh_dp, jax.device_put(x, NamedSharding(mesh_dp, P("dp", None))),
        jax.device_put(c0, NamedSharding(mesh_dp, P())))
    mesh_1 = make_mesh({"dp": 1}, devices=devs[:1])
    c1, o1 = sharded_kmeans_step(mesh_1, x, c0)
    c_err = float(np.abs(np.asarray(c4) - np.asarray(c1)).max())
    o_rel = abs(float(o4) - float(o1)) / float(o1)
    require(c_err < 0.05 and o_rel < 1e-4,
            f"k-means step: centroid diff {c_err}, objective {o_rel}")
    checks.update(kmeans_max_centroid_diff=c_err, kmeans_obj_rel=o_rel)
    emit("multi", route, t0, gpus=4, n=n, batch=b, k=K, **checks,
         peak_bytes_in_use=[peak_bytes(d) for d in devs])


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--multi", action="store_true",
                   help="four GPUs: the sharded serving path only")
    args = p.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform}); nothing run",
              file=sys.stderr)
        return 2
    try:
        from cvt_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: cvt_tpu not importable ({e}); run it from the "
              f"repository root", file=sys.stderr)
        return 2
    enable_compile_cache()
    print(json.dumps({"jax_devices": [str(d) for d in jax.devices()]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as tmp:
        ctx = {"dev": dev, "tmp": tmp}
        if args.multi:
            run_multi(ctx, args.seed)
            count = 4
        else:
            for phase in (phase_flat_adc, phase_flat_sq, phase_ivf_adc,
                          phase_serve, phase_features):
                phase(ctx, args.seed)
            count = 1
    require(len(jax.devices()) == count,
            f"{len(jax.devices())} GPUs visible, this run uses {count}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
