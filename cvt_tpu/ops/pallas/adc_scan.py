"""Flat ADC scan: int8 decoded rows x int8 queries -> packed segment minima.

The scan behind FlatADCIndex, FlatSQIndex.search_fast, IVFADCIndex
.search_fast and the sharded searcher and server. It replaces the
reference's per-point LUT-gather loop (opq/src/IVFOPQ.cpp:300-309) and
hnswlib's graph walk with one batched scan of the whole database.

Scoring. Every database row is an int8 vector `dec` (PQ codes decoded
through int8-quantized codebooks, or SQ codes shifted to int8) with a
per-dimension dequant scale `srow`. The query batch is folded into an
int8 operand q2s with one runtime scale qs per block of queries (the
scan's query block, _query_block; q2s * qs ~= -2 q srow), so

    ||q - srow*dec||^2 ~= ||q||^2 + qs * (<dec, q2s> + norm/qs)

and the bracket is an exact integer: an int8 x int8 -> int32 product
(|dec|, |q2s| <= 127 and D <= 1024 keep every sum below 2^24) plus an
integer norm column, one per query block. A query's result depends only
on its own block, so a large batch quantizes a query no more coarsely
than a batch of one block.

Selection (packed keys). The integer score is packed as

    key = score * seg + lane,   lane = row % seg

an exact lexicographic (distance, position) key, so one min over a
segment of `seg` rows gives its best distance AND its argmin. The scan
returns the [B, N/seg] segment minima and never writes the [B, N] score
matrix. Selection then takes the k best segments per query, ranked
exactly on their keys: exact top-1 always, and for k > 1 a segment
holding two true winners contributes only its best; exact=True re-scores
the k+slack best segments in float32.

Two implementations compute identical keys:
  * `_segmin_pallas` — one Pallas kernel (Triton route). A program owns a
    block of `bn` rows, loads it once and loops over the query batch in
    blocks of `bq`, reducing each [bq, bn] score tile to segment minima
    in registers. An optional page vector lets each program read its own
    block index (the IVF union-probe scan).
  * `_segmin_xla` — the plain twin: the same operands, an int32 matmul
    per query block and a reshape-and-min, left to XLA.
Both write [B, N/seg] directly: nothing transposes the minima before
top_k, whose GPU kernel takes its operand row-major.
`cvt_tpu.ops.backend.scan_route` chooses between them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton


def _pack_caps(seg: int, d: int) -> tuple[int, int]:
    """(valid norm cap, invalid norm marker) for score*seg+lane packing.

    |ip| <= ipb = 127*127*d. The invariants are
      max valid key  = (vcap + ipb)*seg + seg-1  <  min invalid key
      min invalid key = (ibase - ipb)*seg
      max invalid key = (ibase + ipb)*seg + seg-1  <  2^31
    all satisfied by vcap <= 2^31//seg - 3*ipb - 2*seg, ibase = vcap +
    2*ipb + 1. The ranking view (_rank_keys) also needs the span from
    the lowest key, -ipb*seg, to the lowest invalid key to fit the
    positive normal float32 range: vcap <= (2^31 - 2^24 - 1)//seg -
    2*ipb - 1. Raises when (seg, d) leaves no headroom instead of
    silently wrapping int32 keys.
    """
    ipb = 127 * 127 * d
    vcap = min((2 ** 31) // seg - 3 * ipb - 2 * seg,
               (2 ** 31 - 2 ** 24 - 1) // seg - 2 * ipb - 1)
    ibase = vcap + 2 * ipb + 1
    if vcap <= 0:
        raise ValueError(
            f"packed selection infeasible: seg={seg}, d={d} leaves no "
            f"int32 headroom (need 2^31/seg > 3*127^2*d); reduce seg or d")
    return vcap, ibase


def padded_dim(d: int) -> int:
    """Operand width the kernel takes: a power of two, at least 32 (the
    int8 tensor-core product's depth). Extra columns are zeros."""
    return max(32, 1 << (d - 1).bit_length())


def _query_block(b: int) -> int:
    """Queries per inner step: a power of two in [16, 128]."""
    return min(128, max(16, 1 << (b - 1).bit_length()))


def quantize_codebooks(codebooks):
    """[M, K, ds] f32 -> (cb_q [M, K, ds] int8, srow [M*ds] f32).

    Per-dimension symmetric int8 quantization over the K codewords; the
    scale is folded into the query operand at search time, so the decoded
    rows stay pure int8."""
    cb = np.asarray(codebooks, np.float32)
    scales = np.maximum(np.abs(cb).max(axis=1) / 127.0, 1e-12)  # [M, ds]
    cb_q = np.clip(np.rint(cb / scales[:, None, :]), -127, 127)
    return cb_q.astype(np.int8), scales.reshape(-1).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("d_pad",))
def decode_int8(codes, cb_q, d_pad: int):
    """codes [N, M] u8 -> [N, d_pad] int8 rows of the quantized codebooks
    (zero columns beyond M*ds). A gather: sharded codes give sharded
    rows."""
    m, _, ds = cb_q.shape
    dec = cb_q[jnp.arange(m)[None, :], codes.astype(jnp.int32)]
    return jnp.pad(dec.reshape(codes.shape[0], m * ds),
                   ((0, 0), (0, d_pad - m * ds)))


@jax.jit
def int8_row_norms(codes, cb_q, srow):
    """||srow * dec||^2 per code row: the scan's norm column, in the
    quantized space it scores."""
    m, _, ds = cb_q.shape
    cbn = jnp.sum(jnp.square(cb_q.astype(jnp.float32)
                             * srow.reshape(m, 1, ds)), axis=-1)   # [M, K]
    return jnp.sum(cbn[jnp.arange(m)[None, :], codes.astype(jnp.int32)],
                   axis=-1)


def _fold_queries(q, srow, d_pad: int, norm_cap=None,
                  vcap: int | None = None):
    """q [B, D] f32 -> (q2s [Bpad, d_pad] int8, qs [Bpad/bq] f32) with
    q2s * qs ~= -2 * q * srow, B padded to whole query blocks of bq
    (_query_block) and one scale per block.

    One symmetric scale per query block keeps the dequant a single scalar
    on each block's int32 scores, so the packing stays exact. norm_cap
    (with vcap) clamps qs from below so that the integer norm column
    round(norm/qs) never exceeds vcap: a low-magnitude block against
    large-norm rows would otherwise saturate every large norm and corrupt
    the ranking. Raising qs only coarsens the query quantization."""
    b, d = q.shape
    bq = _query_block(b)
    bpad = -(-b // bq) * bq
    q2 = jnp.pad(-2.0 * q * srow[None, :], ((0, bpad - b), (0, 0)))
    qs = jnp.max(jnp.abs(q2).reshape(bpad // bq, bq * d), axis=1) / 127.0
    qs = jnp.maximum(qs, 1e-30)
    if norm_cap is not None:
        qs = jnp.maximum(qs, jnp.float32(norm_cap) / vcap)
    q2s = jnp.clip(jnp.round(q2 / jnp.repeat(qs, bq)[:, None]),
                   -127.0, 127.0).astype(jnp.int8)
    return jnp.pad(q2s, ((0, 0), (0, d_pad - d))), qs


def _base_column(norm, qs, n_valid, seg: int, cap: int, marker: int):
    """[Bpad/bq, N] int32 (norm_i * seg + lane), one row per query block
    scale qs; rows at or beyond n_valid (traced or static) get the
    marker, which ranks them after every valid row."""
    rows = jnp.arange(norm.shape[0], dtype=jnp.int32)
    norm_i = jnp.clip(jnp.round(norm[None, :] / qs[:, None]), 0.0,
                      jnp.float32(cap)).astype(jnp.int32)
    norm_i = jnp.where(rows < n_valid, norm_i, jnp.int32(marker))
    return norm_i * seg + rows % seg


# ----------------------------------------------------------------- kernel
def _segmin_kernel(*refs, bn, bq, seg, n_qblocks, n_rows, lp, paged):
    """One program: a block of bn database rows against the whole query
    batch, in query blocks of bq; writes [B, bn/seg] packed minima. The
    base column is flat [n_qblocks * n_rows]: one row per query block."""
    j = pl.program_id(0)
    if paged:
        pages_ref, q_ref, dec_ref, base_ref, out_ref = refs
        per_page = lp // bn
        # the program reads its own page id: an inverted-list visit
        row0 = pages_ref[j // per_page] * lp + (j % per_page) * bn
    else:
        q_ref, dec_ref, base_ref, out_ref = refs
        row0 = j * bn
    dec = dec_ref[pl.ds(row0, bn), :]                     # [bn, D] int8
    nsb = bn // seg
    seg_bits = seg.bit_length() - 1

    def body(qb, carry):
        q = q_ref[pl.ds(qb * bq, bq), :]                  # [bq, D] int8
        base = base_ref[pl.ds(qb * n_rows + row0, bn)]    # [bn] int32
        # int8 x int8 -> int32 on the tensor cores: exact, so the packed
        # key is exact too
        ip = jax.lax.dot_general(
            q, dec, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.int32)             # [bq, bn]
        pk = jax.lax.shift_left(ip, seg_bits) + base[None, :]
        out_ref[pl.ds(qb * bq, bq), pl.ds(j * nsb, nsb)] = jnp.min(
            pk.reshape(bq, nsb, seg), axis=2)
        return carry

    jax.lax.fori_loop(0, n_qblocks, body, 0)


def _row_block(seg: int, lp: int | None, n_rows: int) -> int:
    """Rows per program, measured on an H100 (PERF.md): 256 for the flat
    scan (a 32 KB int8 tile, 4096 programs at 1M rows, two minima per
    query row per store at seg=128), 128 over IVF pages; less where the
    row count demands; at least one segment."""
    bn = max(128 if lp is not None else 256, seg)
    if lp is not None:
        bn = min(bn, lp)
    while n_rows % bn:
        bn //= 2
    if bn < seg or bn < 16:
        raise ValueError(f"rows {n_rows} not a multiple of seg {seg}")
    return bn


@functools.partial(jax.jit, static_argnames=("seg", "lp", "interpret"))
def _segmin_pallas(q2s, dec, base, pages=None, *, seg, lp=None,
                   interpret=False):
    b = q2s.shape[0]
    n_qblocks = base.shape[0]
    bq = b // n_qblocks
    paged = pages is not None
    n_rows = dec.shape[0]
    bn = _row_block(seg, lp, lp if paged else n_rows)
    n_prog = pages.shape[0] * (lp // bn) if paged else n_rows // bn
    kernel = functools.partial(
        _segmin_kernel, bn=bn, bq=bq, seg=seg, n_qblocks=n_qblocks,
        n_rows=n_rows, lp=lp, paged=paged)
    args = ([pages] if paged else []) + [q2s, dec, base.reshape(-1)]

    def whole(x):
        return pl.BlockSpec(x.shape, lambda j, nd=x.ndim: (0,) * nd)

    n_seg = n_prog * bn // seg
    return pl.pallas_call(
        kernel,
        grid=(n_prog,),
        in_specs=[whole(x) for x in args],
        out_specs=pl.BlockSpec((b, n_seg), lambda j: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, n_seg), jnp.int32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4,
                                                 num_stages=2),
        interpret=interpret,
        name="adc_segmin",
    )(*args)


@functools.partial(jax.jit, static_argnames=("seg", "lp"))
def _segmin_xla(q2s, dec, base, pages=None, *, seg, lp=None):
    """Plain twin of _segmin_pallas: page gather, int32 product,
    reshape-and-min — no hand fusion. Query blocks go through lax.map so
    that one [block, N] score matrix stays near 256 MB."""
    b, d = q2s.shape
    if pages is not None:
        rows = (pages[:, None] * lp
                + jnp.arange(lp, dtype=jnp.int32)[None, :]).reshape(-1)
        dec, base = dec[rows], base[:, rows]
    n = dec.shape[0]
    bq = b // base.shape[0]
    bt = bq
    while bt > 1 and bt * n > (1 << 26):
        bt //= 2
    seg_bits = seg.bit_length() - 1

    def one(xs):
        q_blk, blk = xs
        ip = jax.lax.dot_general(
            q_blk, dec, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)             # [bt, N]
        pk = jax.lax.shift_left(ip, seg_bits) + base[blk * bt // bq][None, :]
        return jnp.min(pk.reshape(bt, n // seg, seg), axis=2)

    out = jax.lax.map(one, (q2s.reshape(b // bt, bt, d),
                            jnp.arange(b // bt, dtype=jnp.int32)))
    return out.reshape(b, n // seg)


def segmin(q2s, dec, base, *, seg: int, route: str, pages=None,
           lp: int | None = None):
    """Packed segment minima [Bpad, N/seg (or S*lp/seg)] int32.

    q2s [Bpad, D] int8 folded queries; dec [N, D] int8 decoded rows;
    base [Bpad/bq, N] int32 from _base_column, one row per query block of
    bq = Bpad / base.shape[0] queries; pages [S] int32 optional page ids
    of lp rows each (scan only those pages, in that order). route is
    'pallas' | 'interpret' | 'xla' (cvt_tpu.ops.backend)."""
    if route == "xla":
        return _segmin_xla(q2s, dec, base, pages, seg=seg, lp=lp)
    if route not in ("pallas", "interpret"):
        raise ValueError(f"unknown route {route!r}")
    return _segmin_pallas(q2s, dec, base, pages, seg=seg, lp=lp,
                          interpret=route == "interpret")


# -------------------------------------------------------------- selection
def _unpack(packed, seg: int):
    """packed i32 key -> (score i32, lane i32); exact for either sign."""
    lane = jnp.mod(packed, seg)
    return (packed - lane) // seg, lane


def _rank_keys(keys, invalid_from: int, seg: int, d: int):
    """Exact order-preserving float32 view of packed int32 keys.

    XLA's top_k is fast on floats, but a plain cast rounds keys near
    2^31 to 256-wide buckets, and which of the tied keys wins is then up
    to the top_k implementation. Instead, keys (invalid ones clamped to
    invalid_from) are shifted into the positive normal float32 range and
    bitcast: distinct keys stay distinct and keep their order
    (_pack_caps sizes the range)."""
    shift = 127 * 127 * d * seg + 2 ** 23
    return jax.lax.bitcast_convert_type(
        jnp.minimum(keys, invalid_from) + shift, jnp.float32)


def _select_segments(segpack, qs, q_sq, b: int, k: int, seg: int,
                     invalid_from: int, d: int):
    """Fast-path selection: the k best segments per query ARE the
    results, ranked exactly on their packed keys. qs [b]: each query's
    block scale."""
    keys = segpack[:b]                                    # [b, n_seg]
    kk = min(k, keys.shape[1])
    _, j = jax.lax.top_k(-_rank_keys(keys, invalid_from, seg, d), kk)
    packed = jnp.take_along_axis(keys, j, axis=-1)
    order = jnp.argsort(packed, axis=-1)
    packed = jnp.take_along_axis(packed, order, axis=-1)
    j = jnp.take_along_axis(j, order, axis=-1)
    score, lane = _unpack(packed, seg)
    ok = packed < invalid_from
    ids = jnp.where(ok, j * seg + lane, -1)
    dist = jnp.where(ok, score.astype(jnp.float32) * qs[:, None]
                     + q_sq[:, None], jnp.inf)
    if kk < k:
        pad = ((0, 0), (0, k - kk))
        dist = jnp.pad(dist, pad, constant_values=jnp.inf)
        ids = jnp.pad(ids, pad, constant_values=-1)
    return dist, ids


def _rescore_segments(q, q_sq, seg_ids, codes, dec_sq, codebooks, k, seg,
                      n_valid):
    """Exact path: float32 LUT-ADC re-score of the chosen segments.

    seg_ids [B, S]; codes [N, M] u8; dec_sq [N] f32. Returns the final
    (dists [B, k], ids [B, k])."""
    b, s = seg_ids.shape
    m, _, ds = codebooks.shape
    n = codes.shape[0]
    rows = (seg_ids[:, :, None] * seg
            + jnp.arange(seg, dtype=jnp.int32)[None, None, :])
    rows = rows.reshape(b, s * seg)
    safe = jnp.clip(rows, 0, n - 1)
    cand_codes = codes[safe].astype(jnp.int32)             # [B, C, M]
    lut = -2.0 * jnp.einsum("bms,mks->bmk", q.reshape(b, m, ds), codebooks,
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
    g = jnp.take_along_axis(lut, cand_codes.transpose(0, 2, 1), axis=2)
    dist = jnp.sum(g, axis=1) + dec_sq[safe] + q_sq[:, None]
    dist = jnp.where(rows < n_valid, dist, jnp.inf)
    neg, j = jax.lax.top_k(-dist, k)
    ids = jnp.take_along_axis(rows, j, axis=-1)
    return -neg, jnp.where(jnp.isfinite(neg), ids, -1)


def _prepare(q, norm, srow, n_valid, seg: int, d_pad: int):
    """Query fold and norm column shared by every search on the scan.
    Returns (q2s, per-query scale [Bpad], base, invalid_from)."""
    d = q.shape[1]
    vcap, ibase = _pack_caps(seg, d)
    # |dec| <= 127 bounds every row norm by 127^2 ||srow||^2; the bound
    # depends on the codebooks alone, so every shard of a sharded scan
    # folds its queries with the same qs
    norm_bound = 127.0 ** 2 * jnp.sum(jnp.square(srow))
    q2s, qs = _fold_queries(q, srow, d_pad, norm_bound, vcap)
    base = _base_column(norm, qs, n_valid, seg, vcap, ibase)
    qs_rows = jnp.repeat(qs, q2s.shape[0] // qs.shape[0])
    return q2s, qs_rows, base, (ibase - 127 * 127 * d) * seg


@functools.partial(jax.jit, static_argnames=("seg", "route"))
def packed_keys(q, dec, norm, srow, n_valid, *, route: str, seg: int = 128):
    """The scan's raw result for queries q: packed segment minima
    [Bpad, Npad/seg] int32 (module docstring). Every route gives the same
    keys bit for bit."""
    q2s, _, base, _ = _prepare(q.astype(jnp.float32), norm, srow, n_valid,
                               seg, dec.shape[1])
    return segmin(q2s, dec, base, seg=seg, route=route)


@functools.partial(
    jax.jit, static_argnames=("k", "seg", "route", "exact", "slack"))
def _adc_search(q, dec, norm, srow, n_valid, codes, dec_sq, codebooks, *,
                k, seg, route, exact, slack):
    b = q.shape[0]
    q = q.astype(jnp.float32)
    q_sq = jnp.sum(jnp.square(q), axis=-1)
    q2s, qs, base, invalid_from = _prepare(q, norm, srow, n_valid, seg,
                                           dec.shape[1])
    segpack = segmin(q2s, dec, base, seg=seg, route=route)
    d = q.shape[1]
    if not exact:
        return _select_segments(segpack, qs[:b], q_sq, b, k, seg,
                                invalid_from, d)
    n_take = min(k + slack, segpack.shape[1])
    _, seg_ids = jax.lax.top_k(
        -_rank_keys(segpack[:b], invalid_from, seg, d), n_take)
    return _rescore_segments(q, q_sq, seg_ids, codes, dec_sq, codebooks,
                             k, seg, n_valid)


def adc_search(q, dec, norm, srow, k: int, n_valid, *, route: str,
               seg: int = 128, exact: bool = False, codes=None,
               dec_sq=None, codebooks=None, slack: int = 4):
    """Two-phase flat ADC search over a packed segment scan.

    q [B, D] f32 (rotated space); dec [Npad, Dpad] int8 decoded rows
    (decode_int8); norm [Npad] f32 quantized-space row norms; srow [D]
    per-dim dequant scales; n_valid real rows, static or traced (a
    shard_map body passes its shard's count; ids are then local to the
    shard). Fast path (default): the k best segments are the results
    (int8-scored distances). exact=True re-scores the k+slack best
    segments in float32 from codes [N, M], dec_sq [N] and codebooks;
    exact top-k w.r.t. full-precision ADC unless a true winner sits
    outside them. Requires k <= seg."""
    if k > seg:
        raise ValueError(f"packed scan requires k <= seg ({seg})")
    if exact and codes is None:
        raise ValueError("exact=True needs codes, dec_sq and codebooks")
    return _adc_search(q, dec, norm, srow, n_valid, codes, dec_sq,
                       codebooks, k=k, seg=seg, route=route, exact=exact,
                       slack=slack)
