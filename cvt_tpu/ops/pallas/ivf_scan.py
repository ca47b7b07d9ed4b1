"""IVF-ADC union-probe scan: the flat packed scan over the probed pages.

Replaces the pure-XLA probed scan (`index/ivf_adc.py:_probed_scores`:
per-(query, probe) bucket gathers + per-element LUT `take_along_axis`),
the batched form of the reference's list walk (opq/src/IVFOPQ.cpp:300-309).

  * The database is stored SORTED BY COARSE CELL, each cell padded to a
    multiple of `seg` rows (segment-pure: every seg-row segment belongs
    to exactly one cell), as a DECODED int8 residual cache [N', D] plus
    per-row reconstruction norms — so scoring needs no decode and no LUT:
    one int8 product per page against the whole query batch.
  * A query batch's probed cells are resolved to the UNION of pages
    (fixed 512-row tiles of the sorted array) in XLA; the scan
    (cvt_tpu.ops.pallas.adc_scan.segmin) runs over the selected pages
    only, each program reading its own page id — an inverted-list walk
    where every "list visit" is shared by every query of the batch.
  * dist(q, row) = ||q||^2 + ||c + d||^2 - 2<q, c> - 2<q, d>: the
    residual term -2<q, d> is the int8 product; the norm ||c + d||^2
    rides the per-row norm column; the coarse term -2<q, c> is constant
    per (segment, query), so it is added AFTER the segment minimum
    (min(p + c) = min(p) + c). EXACT per-query nprobe semantics: segments
    of cells a query did NOT probe get a marker that ranks them below
    every real candidate.
  * Selection: the k+slack best SEGMENTS per query by packed minimum
    are rescored whole in f32 from an int16 decode cache — exact
    distances out.

Integer packing budget (key = (ip + norm_i + cip_i) * seg + lane):
  ip      in [-ipb, ipb],   ipb  = 127*127*D   (int8 product bound)
  norm_i  in [0, nvcap]     valid rows; pad rows get marker NIB
  cip_i   in [0, cipb]      probed segments; unprobed get marker CIB
with NIB = CIB = nvcap + 3*ipb + 1 and
nvcap = (2^31/seg - 7*ipb - 2*seg)/2 - 1 all markers rank strictly
above every valid key and nothing overflows int32 (proof in
_ivf_pack_caps). Runtime qs clamps (max norm / nvcap, max cip / cipb)
guarantee valid values never reach the markers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cvt_tpu.ops.pallas.adc_scan import (_fold_queries, _rank_keys,
                                         padded_dim, quantize_codebooks,
                                         segmin)

BIG = 3.4e38


def _ivf_pack_caps(seg: int, d: int) -> tuple[int, int]:
    """(nvcap, marker) for the IVF packing (see module docstring).

    Invariants (A = 2^31 // seg, ipb = 127*127*d, cipb = ipb,
    NIB = CIB = marker):
      valid max  = ipb + nvcap + cipb
      masked min = CIB - ipb            > valid max
      pad min    = NIB - ipb            > valid max
      global max = ipb + nvcap + CIB    <= A - 2*seg   (pad+masked rows
      keep norm<=NIB XOR cip<=CIB large, never both: pad rows' cip is
      clipped to CIB only when ALSO masked, giving NIB+CIB+ipb — the
      budget below covers that worst case too)
    marker*seg is below 2^30, so adc_scan._rank_keys ranks these keys
    exactly as well.
    """
    ipb = 127 * 127 * d
    a = (2 ** 31) // seg
    # worst key = ipb + NIB + CIB = ipb + 2*(nvcap + 3*ipb + 1) <= a - 2*seg
    nvcap = (a - 7 * ipb - 2 * seg - 2) // 2 - 1
    if nvcap <= 0:
        raise ValueError(
            f"IVF packed scan infeasible for seg={seg}, d={d}: no int32 "
            f"headroom; reduce seg or d")
    marker = nvcap + 3 * ipb + 1
    return nvcap, marker


@functools.partial(
    jax.jit,
    static_argnames=("nprobe", "k", "max_pages", "lp", "seg", "exact_probe",
                     "slack", "route"))
def ivf_union_search(q, centroids, dec8, dec16_rm, srow16, nrm_col,
                     seg_cell, rowids, srow, dsq_min, nprobe, k, max_pages,
                     lp=512, seg=32, exact_probe=True, slack=6,
                     route="xla"):
    """Batched IVF-ADC top-k via the union-probe page scan.

    q [B, D] raw space; centroids [Kc, D]; dec8 [N', Dpad] int8 decoded
    residual cache (cell-sorted, segment-pure); dec16_rm [N', D] an
    int16 row-major decode (per-dim scale srow16) for phase-2 rescoring
    — 256x finer than int8, so rescored distances match the f32 LUT
    engine to ~1e-4 even when residuals are large; nrm_col [N', 1] f32 =
    ||c + d||^2 - dsq_min (BIG on pad rows); seg_cell [N'/seg] i32
    owning cell per segment (-1 = dead); rowids [N'] i32 original vector
    ids (-1 = pad); srow [D] per-dim dequant scales of the residual
    codebooks; route as in cvt_tpu.ops.backend. Returns (dists [B, k],
    ids [B, k] with -1 padding, number of probed pages dropped for want
    of max_pages).

    exact_probe=True masks each query to its OWN nprobe lists (reference
    semantics, IVFOPQ.cpp:237-309); False scans the batch union —
    same cost, recall >= exact.

    Phase 2: the scan ranks SEGMENT minima; the k+slack best segments per
    query are re-scored exactly in f32, so the returned distances are
    exact ADC distances, not int8-quantized ones.
    """
    b, d = q.shape
    n_rows = dec8.shape[0]
    n_pages = n_rows // lp
    spt = lp // seg
    kc = centroids.shape[0]
    nvcap, marker = _ivf_pack_caps(seg, d)

    # ---- probe selection (one matmul) + page union ----------------------
    coarse_ip = jnp.matmul(q, centroids.T,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)    # [B, Kc]
    c_sq = jnp.sum(jnp.square(centroids), axis=-1)
    q_sq = jnp.sum(jnp.square(q), axis=-1)
    coarse_dist = q_sq[:, None] - 2.0 * coarse_ip + c_sq[None, :]
    _, probes = jax.lax.top_k(-coarse_dist, nprobe)               # [B, P]

    probed = jnp.zeros((kc,), bool).at[probes.reshape(-1)].set(True)
    seg_probed = jnp.where(seg_cell >= 0,
                           probed[jnp.clip(seg_cell, 0, kc - 1)], False)
    page_probed = seg_probed.reshape(n_pages, spt).any(axis=1)
    s_max = min(max_pages, n_pages)
    sel = jnp.nonzero(page_probed, size=s_max, fill_value=0)[0]
    slot = jnp.arange(s_max, dtype=jnp.int32)
    live = slot < jnp.sum(page_probed)          # fill slots fully masked
    n_dropped = jnp.maximum(jnp.sum(page_probed) - s_max, 0)

    # ---- per-segment coarse correction columns [B, S*spt] ---------------
    sel_segs = sel[:, None] * spt + jnp.arange(spt)[None, :]      # [S,spt]
    cells = seg_cell[sel_segs.reshape(-1)]                        # [S*spt]
    cent_sel = centroids[jnp.clip(cells, 0, kc - 1)]              # [.., D]
    cip = -2.0 * jnp.matmul(q, cent_sel.T,
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)   # [B,S*spt]
    c0 = jnp.min(jnp.where(cells[None, :] >= 0, cip, BIG), axis=1)
    cipz = cip - c0[:, None]
    if exact_probe:
        hit = jnp.any(probes[:, None, :] == cells[None, :, None], axis=-1)
        cipz = jnp.where(hit, cipz, BIG)                          # [B,S*spt]
    dead = (cells < 0) | ~jnp.repeat(live, spt, total_repeat_length=
                                     s_max * spt)
    cipz = jnp.where(dead[None, :], BIG, cipz)

    # ---- query fold with marker-safe qs clamps --------------------------
    # the clamps must reach _fold_queries BEFORE q2s is quantized: raising
    # qs afterwards would leave ip in score/qs_old units while norm_i and
    # cip_i use qs_new — mixed units corrupt the packed ranking exactly in
    # the regime the clamps defend against
    max_nrm = jnp.max(jnp.where(nrm_col < BIG / 2, nrm_col, 0.0))
    max_cip = jnp.max(jnp.where(cipz < BIG / 2, cipz, 0.0))
    qs_min = jnp.maximum(max_nrm / nvcap, max_cip / (127 * 127 * d))
    q2s, qs = _fold_queries(q, srow, dec8.shape[1], qs_min, 1)
    seg_bits = seg.bit_length() - 1
    # per-row norm column, one row per query block's scale; pad rows
    # (BIG) clip to the marker exactly
    rowsel = jnp.arange(n_rows, dtype=jnp.int32)
    norm_i = jnp.clip(jnp.round(nrm_col[None, :, 0] / qs[:, None]), 0.0,
                      jnp.float32(marker)).astype(jnp.int32)
    base = jax.lax.shift_left(norm_i, seg_bits) + rowsel % seg
    segpack = segmin(q2s, dec8, base, seg=seg, route=route,
                     pages=sel.astype(jnp.int32), lp=lp)   # [Bpad, S*spt]
    # per-segment coarse term, added after the segment minimum; masked
    # entries clip to the marker
    qs_rows = jnp.repeat(qs, q2s.shape[0] // qs.shape[0])[:b]
    cip_i = jnp.clip(jnp.round(cipz / qs_rows[:, None]), 0.0,
                     jnp.float32(marker)).astype(jnp.int32)
    segpack = segpack[:b] + jax.lax.shift_left(cip_i, seg_bits)

    # ---- phase 2: exact f32 rescore of the winning segments -------------
    n_take = min(k + slack, segpack.shape[1])
    # every key from the marker's lowest up ranks as one invalid key
    invalid_from = (marker - 127 * 127 * d) * seg
    _, seg_sel = jax.lax.top_k(-_rank_keys(segpack, invalid_from, seg, d),
                               n_take)                   # [B, S2] sel-order
    # fill slots duplicate page 0; their segments must not re-enter in
    # phase 2 (the kernel already ranked them at the marker, but with
    # fewer live candidates than n_take they would surface as dups)
    slot_live = (seg_sel // spt) < jnp.sum(page_probed)  # [B, S2]
    slot_live = jnp.repeat(slot_live[:, :, None], seg, axis=2
                           ).reshape(b, n_take * seg)
    gseg = sel[jnp.clip(seg_sel // spt, 0, s_max - 1)] * spt \
        + seg_sel % spt                                  # global segment
    rows = (gseg[:, :, None] * seg
            + jnp.arange(seg, dtype=jnp.int32)[None, None, :]
            ).reshape(b, n_take * seg)                   # [B, C]
    rows = jnp.clip(rows, 0, n_rows - 1)
    vec_ids = rowids[rows]                               # [B, C]
    cells_c = seg_cell[rows // seg]                      # [B, C]
    dec_c = dec16_rm[rows].astype(jnp.float32)           # [B, C, D]
    qf = q * srow16[None, :]
    # broadcast-mul + reduce: exact float32, no matmul precision mode
    ip = jnp.sum(dec_c * qf[:, None, :], axis=-1)        # <q, residual>
    cipv = -2.0 * jnp.take_along_axis(
        coarse_ip, jnp.clip(cells_c, 0, kc - 1), axis=1)
    nrm_c = nrm_col[rows, 0] + dsq_min
    dist = q_sq[:, None] + nrm_c + cipv - 2.0 * ip
    okc = (vec_ids >= 0) & (cells_c >= 0) & (nrm_c < BIG / 2) & slot_live
    if exact_probe:
        okc &= jnp.any(cells_c[:, :, None] == probes[:, None, :], axis=-1)
    dist = jnp.where(okc, dist, jnp.inf)
    k_eff = min(k, dist.shape[1])      # tiny index: pool may be < k
    neg, j = jax.lax.top_k(-dist, k_eff)
    ids = jnp.take_along_axis(vec_ids, j, axis=-1)
    out_d = -neg
    ok = jnp.isfinite(out_d)
    out_d = jnp.where(ok, out_d, jnp.inf)
    ids = jnp.where(ok, ids, -1)
    if k_eff < k:                      # honor the [B, k] contract
        pad = ((0, 0), (0, k - k_eff))
        out_d = jnp.pad(out_d, pad, constant_values=jnp.inf)
        ids = jnp.pad(ids, pad, constant_values=-1)
    return out_d, ids, n_dropped


def build_page_layout(codes, assign, dsq, codebooks, *, lp: int = 512,
                      seg: int = 32):
    """Host-side layout: cell-sorted, segment-pure decoded int8 pages.

    codes [N, M] u8 residual PQ codes; assign [N] i32 coarse cell; dsq
    [N] f32 full reconstruction norms; codebooks [M, K, ds] f32.
    Returns dict of numpy arrays (see ivf_union_search docstring).
    """
    codes = np.asarray(codes, np.uint8)
    assign = np.asarray(assign)
    dsq = np.asarray(dsq, np.float32)
    n, m = codes.shape
    cb = np.asarray(codebooks, np.float32)
    _, k, ds = cb.shape
    d = m * ds
    kc = int(assign.max()) + 1 if n else 1

    counts = np.bincount(assign, minlength=kc)
    padded = -(-counts // seg) * seg                      # per-cell rows
    total = int(padded.sum())
    total_pg = -(-max(total, lp) // lp) * lp              # whole pages
    starts = np.zeros(kc + 1, np.int64)
    np.cumsum(padded, out=starts[1:])

    order = np.argsort(assign, kind="stable")
    in_starts = np.zeros(kc + 1, np.int64)
    np.cumsum(counts, out=in_starts[1:])
    rank = np.arange(n, dtype=np.int64) - in_starts[assign[order]]
    dest = starts[assign[order]] + rank                   # [N] slot

    rowids = np.full((total_pg,), -1, np.int32)
    rowids[dest] = order.astype(np.int32)
    nrm = np.full((total_pg,), BIG, np.float32)
    nrm[dest] = dsq[order]
    dsq_min = float(dsq.min()) if n else 0.0
    nrm[rowids >= 0] -= dsq_min

    # decoded int8 residual rows straight from the quantized codebooks
    cb_q, srow = quantize_codebooks(cb)                   # [M, K, ds]
    dec8 = np.zeros((total_pg, padded_dim(d)), np.int8)
    if n:
        dec8[dest, :d] = np.concatenate(
            [cb_q[mm][codes[order, mm]] for mm in range(m)], axis=1)
    # int16 row-major decode for the exact phase-2 rescore (256x finer
    # quantization: |err| <= 0.5 * srow16 per dim ~ 1e-4 relative)
    scales16 = np.maximum(np.abs(cb).max(axis=1) / 32767.0, 1e-12)
    cb_q16 = np.clip(np.rint(cb / scales16[:, None, :]),
                     -32767, 32767).astype(np.int16)      # [M, K, ds]
    dec16 = np.zeros((total_pg, d), np.int16)
    dec16[dest] = np.concatenate(
        [cb_q16[mm][codes[order, mm]] for mm in range(m)],
        axis=1) if n else 0
    srow16 = scales16.reshape(d).astype(np.float32)

    seg_cell = np.full((total_pg // seg,), -1, np.int32)
    for c in range(kc):
        if padded[c]:
            seg_cell[starts[c] // seg:(starts[c] + padded[c]) // seg] = c

    return dict(dec8=dec8, dec16=dec16, srow16=srow16,
                nrm_col=nrm[:, None], seg_cell=seg_cell, rowids=rowids,
                srow=np.asarray(srow), dsq_min=dsq_min, lp=lp, seg=seg)
