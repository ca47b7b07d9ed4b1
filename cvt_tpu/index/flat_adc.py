"""Flat ADC index: asymmetric-distance scan over PQ/OPQ codes.

This is the north-star engine (BASELINE.json configs 2/4): the HNSW graph
walk (hnsw_sifts_retrieval) and the IVF probe heap (opq/src/IVFOPQ.cpp
:237-309) are deliberately replaced by a flat, batched, device-resident
code scan — pointer-chasing does not batch; streaming matmuls do.

Scoring (L2): for code row c with PQ decode d(c) = concat_m CB[m, c_m],

    ||q - d(c)||^2 = ||q||^2 - 2 <q, d(c)> + ||d(c)||^2

  * ||d(c)||^2 = sum_m cbnorm[m, c_m] is precomputed per point at add()
    time (one f32 per code row);
  * <q, d(c)> = sum_m <q_m, CB[m, c_m]>: rather than the reference's
    per-point LUT-gather loop (IVFOPQ.cpp:300-309), the scan DECODES each
    code tile (one-hot matmul) and hits it with a single [T, D] x [D, B]
    score matmul — decode-first, amortized over the whole query batch.

The packed int8 segment scan (cvt_tpu.ops.pallas.adc_scan) is the
search path for k <= 128 on every route. `_adc_scan` here is the plain
bf16 engine (exact top-k): the only engine for k > 128, and a
reference for the packed scan in tests.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.ops import backend
from cvt_tpu.ops.pallas import adc_scan
from cvt_tpu.ops.topk import merge_topk
from cvt_tpu.quant.opq import OPQ
from cvt_tpu.quant.pq import ProductQuantizer


def _decode_chunk_bf16(codes, codebooks):
    """codes [T, M] int32, codebooks [M, K, ds] -> [T, D] bf16 via one-hot
    batched matmul. K-dim one-hot is built as int8 compare masks."""
    m, k, ds = codebooks.shape
    t = codes.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (m, t, k), 2)
    onehot = (codes.T[:, :, None] == iota).astype(jnp.bfloat16)  # [M, T, K]
    dec = jax.lax.dot_general(
        onehot, codebooks.astype(jnp.bfloat16),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.bfloat16)                     # [M, T, ds]
    return dec.transpose(1, 0, 2).reshape(t, m * ds)


@partial(jax.jit, static_argnames=("k", "chunk", "n_valid"))
def _adc_scan(q, q_sq, codes, dec_sq, codebooks, k, chunk, n_valid):
    """q [B, D] (already rotated), codes [Npad, M] u8, dec_sq [Npad] f32."""
    b, d = q.shape
    npad = codes.shape[0]
    n_chunks = npad // chunk
    codes_c = codes.reshape(n_chunks, chunk, codes.shape[1])
    dec_sq_c = dec_sq.reshape(n_chunks, chunk)
    qb = q.astype(jnp.bfloat16)                                  # [B, D]

    def scan_chunk(carry, xs):
        c_idx, chunk_codes, chunk_dsq = xs
        dec = _decode_chunk_bf16(chunk_codes.astype(jnp.int32),
                                 codebooks)                      # [T, D] bf16
        # [B, T] straight from the product: no transpose before top_k
        ip = jax.lax.dot_general(
            qb, dec, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)                  # [B, T]
        dist = q_sq[:, None] - 2.0 * ip + chunk_dsq[None, :]     # [B, T]
        base = c_idx * chunk
        local_ids = base + jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)
        dist = jnp.where(local_ids < n_valid, dist, jnp.inf)
        neg, j = jax.lax.top_k(-dist, min(k, chunk))
        ids = jnp.take_along_axis(
            jnp.broadcast_to(local_ids, dist.shape), j, axis=-1)
        best_d, best_i = carry
        cat_d = jnp.concatenate([best_d, -neg], axis=-1)
        cat_i = jnp.concatenate([best_i, ids], axis=-1)
        return merge_topk(cat_d, cat_i, k), None

    # derive the init from both operands so it inherits every
    # device-varying axis when this engine runs inside a shard_map body
    # (jax vma typing): q_sq may vary over a query axis, dec_sq over a
    # database axis
    zero = q_sq[:, None] * 0.0 + dec_sq[0] * 0.0
    init = (jnp.broadcast_to(zero + jnp.inf, (b, k)),
            jnp.broadcast_to(zero.astype(jnp.int32) - 1, (b, k)))
    (best_d, best_i), _ = jax.lax.scan(
        scan_chunk, init,
        (jnp.arange(n_chunks, dtype=jnp.int32), codes_c, dec_sq_c))
    return best_d, best_i


@partial(jax.jit, static_argnames=("rotate",))
def _encode_many(x, rotation, codebooks, rotate: bool):
    """x [C, T, D] device-resident chunk stack -> (codes [C, T, M] u8,
    dec_sq [C, T] f32) in ONE dispatch: a lax.map over fixed-shape chunks
    keeps peak memory at one [T, M*K] distance block and launches one
    program for the whole stack."""
    def one(xc):
        return _encode_chunk(xc, rotation, codebooks, rotate)
    return jax.lax.map(one, x)


@partial(jax.jit, static_argnames=("rotate",))
def _encode_chunk(x, rotation, codebooks, rotate: bool):
    """One fused device program: rotate -> nearest-codeword assign ->
    decode sqnorm. Returns (codes [T, M] u8, dec_sq [T] f32).

    Fusing the three stages into a single jit (instead of rotate / encode /
    gather as separate dispatches) and calling it at ONE fixed chunk shape
    is what makes add() hit >=1M codes/s: every chunk reuses the same
    executable and the argmin never round-trips to the host.
    """
    x = jnp.asarray(x, jnp.float32)
    if rotate:
        x = jnp.matmul(x, rotation, precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
    m, k, ds = codebooks.shape
    t = x.shape[0]
    # Block-diagonal [D, M*K] codebook operand: ONE matmul with a full
    # D-deep contraction replaces a per-subspace einsum whose ds-deep
    # contraction materialized an [M, T, K] block (M x redundant flops).
    # f32 (HIGHEST) so cell assignments stay identical to
    # ProductQuantizer.encode's f32 path — bf16 here flips near-tie
    # cells and makes add() disagree with pq.encode on the same data.
    cbt = jnp.zeros((m * ds, m * k), jnp.float32)
    for mm in range(m):
        cbt = cbt.at[mm * ds:(mm + 1) * ds, mm * k:(mm + 1) * k].set(
            codebooks[mm].T)
    ip = jnp.matmul(x, cbt, precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)      # [T, M*K]
    c_sq = jnp.sum(jnp.square(codebooks), axis=-1)           # [M, K]
    dist = c_sq.reshape(1, m * k) - 2.0 * ip
    codes = jnp.argmin(dist.reshape(t, m, k), axis=-1)       # [T, M]
    dsq = jnp.sum(jnp.take_along_axis(c_sq, codes.T, axis=1), axis=0)
    return codes.astype(jnp.uint8), dsq.astype(jnp.float32)


class FlatADCIndex:
    """Flat scan over PQ/OPQ codes with asymmetric (query-float) distances."""

    ENC_CHUNK = 131_072          # fixed encode sub-chunk (one compile)
    ROW_ALIGN = 1024             # scan operand rows are padded to this

    def __init__(self, quantizer, chunk: int = 16384, impl: str = "auto"):
        """quantizer: ProductQuantizer or OPQ. impl: 'auto' | 'pallas' |
        'xla', resolved by cvt_tpu.ops.backend.scan_route: 'auto' is the
        packed scan kernel on a GPU and its plain XLA twin on the CPU.
        chunk: rows per step of the bf16 engine (k > 128)."""
        if isinstance(quantizer, OPQ):
            self.pq = quantizer.pq
            self.rotation = quantizer.rotation
        elif isinstance(quantizer, ProductQuantizer):
            self.pq = quantizer
            self.rotation = None
        else:
            raise TypeError(type(quantizer))
        self.chunk = chunk
        self.impl = impl
        self._codes: jax.Array | None = None     # [N, M] u8 (rotated space)
        self._dec_sq: jax.Array | None = None    # [N] f32
        self._pending: list = []                 # unmaterialized add() chunks
        self._pending_n: int = 0

    @property
    def ntotal(self) -> int:
        base = 0 if self._codes is None else self._codes.shape[0]
        return base + self._pending_n

    def _materialize(self) -> None:
        """Concatenate pending chunks once (amortized O(N), vs the O(N^2)
        of concatenating inside every add)."""
        if not self._pending:
            return
        cs = [c for c, _ in self._pending]
        ds = [d for _, d in self._pending]
        if self._codes is not None:
            cs.insert(0, self._codes)
            ds.insert(0, self._dec_sq)
        self._codes = jnp.concatenate(cs, axis=0)
        self._dec_sq = jnp.concatenate(ds, axis=0)
        self._pending, self._pending_n = [], 0

    @property
    def dim(self) -> int:
        return self.pq.dim

    def _rotate(self, x):
        x = jnp.asarray(x, jnp.float32)
        if self.rotation is None:
            return x
        return jnp.matmul(x, self.rotation,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)

    def add(self, x=None, *, codes=None) -> None:
        """Add raw float vectors (rotated+encoded here) or precomputed codes
        (already in rotated space).

        Encoding runs as one fused jit per fixed-size sub-chunk (tail
        padded), and chunks are only concatenated lazily on first search —
        the reference encodes ~20k vec/s in its per-vector loop
        (opq/src/IVFOPQ.cpp:141-163); this path exceeds 1M vec/s.
        """
        rot = self.rotation if self.rotation is not None else jnp.zeros(())
        if codes is None:
            # device arrays stay on device (no host round-trip); host
            # arrays are staged chunk-by-chunk
            on_device = isinstance(x, jax.Array)
            if not on_device:
                x = np.asarray(x, np.float32)
            n = x.shape[0]
            step = self.ENC_CHUNK
            if on_device and n > step:
                # single dispatch: pad to a whole number of chunks and
                # run the jitted chunk-map on device
                c_num = -(-n // step)
                xp = jnp.pad(x, ((0, c_num * step - n), (0, 0)))
                cs, dsqs = _encode_many(
                    xp.reshape(c_num, step, x.shape[1]), rot,
                    self.pq.codebooks, self.rotation is not None)
                self._pending.append((cs.reshape(c_num * step, -1)[:n],
                                      dsqs.reshape(c_num * step)[:n]))
                self._pending_n += n
                return
            for s in range(0, n, step):
                chunk = x[s:s + step]
                t = chunk.shape[0]
                if t < step and n > step:
                    pad = ((0, step - t), (0, 0))
                    chunk = (jnp.pad(chunk, pad) if on_device
                             else np.pad(chunk, pad))
                c, d = _encode_chunk(chunk, rot, self.pq.codebooks,
                                     self.rotation is not None)
                self._pending.append((c if t == c.shape[0] else c[:t],
                                      d if t == d.shape[0] else d[:t]))
                self._pending_n += t
        else:
            codes = jnp.asarray(codes, jnp.uint8)
            cbn = self.pq.codeword_sqnorms()                     # [M, K]
            dsq = jnp.sum(jax.vmap(lambda t, c: t[c], in_axes=(0, 1))(
                cbn, codes.astype(jnp.int32)), axis=0)           # [N]
            self._pending.append((codes, dsq))
            self._pending_n += int(codes.shape[0])

    def search(self, q, k: int, *, exact: bool = False):
        """q [B, D] raw-space float -> (dists [B, k], ids [B, k]).

        For k <= 128 the packed scan runs on the route the backend
        switch picks: the default fast path returns int8-scored distances
        of the k best 128-row segments (top-1 exact up to the int8
        quantization of the codebooks); exact=True re-scores the winning
        segments in float32. For k > 128 the bf16 engine (_adc_scan) is
        the only one: exact top-k over its bf16 decode either way."""
        self._materialize()
        if self._codes is None:
            raise RuntimeError("empty index")
        qr = self._rotate(q)
        n = self.ntotal
        k = min(k, n)
        if k <= 128:
            dec, norm, srow = self.scan_operand()
            return adc_scan.adc_search(
                qr, dec, norm, srow, k, n,
                route=backend.scan_route(impl=self.impl), exact=exact,
                codes=self._codes, dec_sq=self._dec_sq,
                codebooks=self.pq.codebooks)
        q_sq = jnp.sum(jnp.square(qr), axis=-1)
        chunk = min(self.chunk, n)
        npad = -(-n // chunk) * chunk
        codes, dsq = self._codes, self._dec_sq
        if npad != n:
            codes = jnp.concatenate(
                [codes, jnp.zeros((npad - n, self.pq.m), jnp.uint8)], axis=0)
            dsq = jnp.concatenate(
                [dsq, jnp.zeros((npad - n,), jnp.float32)], axis=0)
        return _adc_scan(qr, q_sq, codes, dsq, self.pq.codebooks, k, chunk,
                         n)

    def build_decoded_cache(self) -> None:
        """Build the packed scan's operand: the database decoded through
        int8-quantized codebooks, [Npad, D] int8 (16x the bytes of 64-bit
        codes), plus quantized-space row norms. search() builds it on
        first use and after add(); the codes stay the index's ground
        truth."""
        self._materialize()
        if self._codes is None:
            raise RuntimeError("empty index")
        n = self.ntotal
        npad = -(-n // self.ROW_ALIGN) * self.ROW_ALIGN
        codes = jnp.pad(self._codes, ((0, npad - n), (0, 0)))
        cb_q, srow = adc_scan.quantize_codebooks(self.pq.codebooks)
        cb_q, srow = jnp.asarray(cb_q), jnp.asarray(srow)
        self._dec8 = adc_scan.decode_int8(
            codes, cb_q, adc_scan.padded_dim(self.dim))
        self._norm8 = adc_scan.int8_row_norms(codes, cb_q, srow)
        self._srow8 = srow
        self._dec8_n = n

    def scan_operand(self):
        """(dec [Npad, Dpad] int8, norm [Npad] f32, srow [D] f32): the
        packed scan's operand, built on first use and after add()."""
        if getattr(self, "_dec8_n", None) != self.ntotal:
            self.build_decoded_cache()
        return self._dec8, self._norm8, self._srow8

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        self._materialize()
        np.savez(path, codes=np.asarray(self._codes),
                 dec_sq=np.asarray(self._dec_sq),
                 codebooks=np.asarray(self.pq.codebooks),
                 rotation=(np.asarray(self.rotation)
                           if self.rotation is not None else np.zeros(0)))

    @classmethod
    def load(cls, path: str) -> "FlatADCIndex":
        z = np.load(path, allow_pickle=False)
        pq = ProductQuantizer(jnp.asarray(z["codebooks"]))
        rot = z["rotation"]
        quant = OPQ(jnp.asarray(rot), pq) if rot.size else pq
        idx = cls(quant)
        idx._codes = jnp.asarray(z["codes"])
        idx._dec_sq = jnp.asarray(z["dec_sq"])
        return idx
