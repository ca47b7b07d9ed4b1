"""Flat int8-SQ index: asymmetric distance scan over uint8 codes.

Config 1 of BASELINE.json (int8 SQ encode + brute-force L2 top-10). The
reference has no SQ search path at all (codes are used for storage;
search is float AVX scans). Here the decode is folded into the scan
algebraically so scoring stays matmul-shaped:

    decode(c) = bias + scale * c         (cvt int8_quan.cc decode form)
    ||q - decode(c)||^2 = ||r||^2 - 2 <r*scale, c> + ||scale*c||^2
        with r = q - bias.

  * term2 is an [B,D]x[D,N] matmul over the raw codes;
  * term3 is a per-point f32 precomputed at add() time;
  * term1 is a per-query constant.

Two scan modes (search):
  'bf16': codes lifted to bf16 (exact: bf16 holds integers <= 256).
  'int8': query side quantized to int8, codes stored shifted to int8
          (c - 128), scored by an int8 x int8 -> int32 product; only the
          query rounding is approximate.
search_fast runs the packed segment scan of cvt_tpu.ops.pallas.adc_scan.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cvt_tpu.ops import backend
from cvt_tpu.ops.pallas import adc_scan
from cvt_tpu.ops.topk import merge_topk
from cvt_tpu.quant.sq import ScalarQuantizer


@partial(jax.jit, static_argnames=("k", "mode", "chunk", "n_valid"))
def _sq_scan(r_scaled, r_sq, codes_s8, term3, k, mode, chunk, n_valid):
    """r_scaled = (q - bias) * scale  [B, D];  r_sq = ||q - bias||^2 [B].

    codes_s8: [Npad, D] int8 (= raw code - 128). term3: [Npad] f32.
    Returns (dists [B, k], ids [B, k]).
    """
    b, d = r_scaled.shape
    npad = codes_s8.shape[0]
    n_chunks = npad // chunk
    codes_c = codes_s8.reshape(n_chunks, chunk, d)
    term3_c = term3.reshape(n_chunks, chunk)

    if mode == "int8":
        gamma = jnp.max(jnp.abs(r_scaled), axis=-1, keepdims=True) / 127.0
        gamma = jnp.maximum(gamma, 1e-30)
        tq = jnp.round(r_scaled / gamma).astype(jnp.int8)          # [B, D]
        tq_sum = jnp.sum(tq.astype(jnp.int32), axis=-1)            # [B]

    def scan_chunk(carry, xs):
        c_idx, chunk_codes, chunk_t3 = xs
        if mode == "int8":
            ipq = jax.lax.dot_general(
                tq, chunk_codes,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32)                  # [B, chunk]
            # <r_scaled, c> = gamma * (<tq, c-128> + 128 * sum(tq))
            ip = gamma * (ipq.astype(jnp.float32)
                          + 128.0 * tq_sum[:, None].astype(jnp.float32))
        else:
            cb = (chunk_codes.astype(jnp.int32) + 128).astype(jnp.bfloat16)
            ip = jax.lax.dot_general(
                r_scaled.astype(jnp.bfloat16), cb,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)
        dist = r_sq[:, None] - 2.0 * ip + chunk_t3[None, :]
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

    # init derived from both operands so it inherits device-varying axes
    # under shard_map (jax vma typing)
    zero = r_sq[:, None] * 0.0 + term3[0] * 0.0
    init = (jnp.broadcast_to(zero + jnp.inf, (b, k)),
            jnp.broadcast_to(zero.astype(jnp.int32) - 1, (b, k)))
    (best_d, best_i), _ = jax.lax.scan(
        scan_chunk, init,
        (jnp.arange(n_chunks, dtype=jnp.int32), codes_c, term3_c))
    return best_d, best_i


class FlatSQIndex:
    """Exact-rank L2 search over int8-SQ compressed vectors."""

    def __init__(self, sq: ScalarQuantizer, mode: str = "bf16",
                 chunk: int = 65536):
        if mode not in ("bf16", "int8"):
            raise ValueError(f"unknown mode {mode!r}")
        self.sq = sq
        self.mode = mode
        self.chunk = chunk
        self._codes_s8: jax.Array | None = None   # [N, D] int8 (code-128)
        self._term3: jax.Array | None = None      # [N] f32 ||scale*c||^2

    @property
    def ntotal(self) -> int:
        return 0 if self._codes_s8 is None else self._codes_s8.shape[0]

    @property
    def dim(self) -> int:
        return self.sq.dim

    def add(self, x=None, *, codes=None) -> None:
        """Add float vectors (encoded internally) or precomputed uint8 codes."""
        if codes is None:
            codes = self.sq.encode(x)
        codes = jnp.asarray(codes, jnp.uint8)
        s8 = (codes.astype(jnp.int16) - 128).astype(jnp.int8)
        dec = self.sq.scale[None, :] * codes.astype(jnp.float32)
        t3 = jnp.sum(jnp.square(dec), axis=-1)
        if self._codes_s8 is None:
            self._codes_s8, self._term3 = s8, t3
        else:
            self._codes_s8 = jnp.concatenate([self._codes_s8, s8], axis=0)
            self._term3 = jnp.concatenate([self._term3, t3], axis=0)

    def search(self, q, k: int):
        """q [B, D] float (raw; bias/scale handled here) -> (dists, ids)."""
        if self._codes_s8 is None:
            raise RuntimeError("empty index")
        q = jnp.asarray(q, jnp.float32)
        r = q - self.sq.bias[None, :]
        r_scaled = r * self.sq.scale[None, :]
        r_sq = jnp.sum(jnp.square(r), axis=-1)
        n = self.ntotal
        chunk = min(self.chunk, n)
        npad = -(-n // chunk) * chunk
        codes = self._codes_s8
        t3 = self._term3
        if npad != n:
            codes = jnp.concatenate(
                [codes, jnp.zeros((npad - n, self.dim), jnp.int8)], axis=0)
            t3 = jnp.concatenate(
                [t3, jnp.zeros((npad - n,), jnp.float32)], axis=0)
        return _sq_scan(r_scaled, r_sq, codes, t3, min(k, n), self.mode,
                        chunk, n)

    def search_fast(self, q, k: int, *, impl: str = "auto"):
        """Packed segment scan (the production path). The SQ decode is
        per-dim affine (decode = a*c' + b with c' = code-128 int8), so the
        codes ARE the scan's int8 operand: dist(q, x) = ||(q - b) - a*c'||^2
        with the bias folded into the query and the per-dim scales as the
        dequant row. impl goes to cvt_tpu.ops.backend.scan_route."""
        if self._codes_s8 is None:
            raise RuntimeError("empty index")
        route = backend.scan_route(impl=impl)
        q = jnp.asarray(q, jnp.float32)
        n = self.ntotal
        # rebuild when vectors were added since the operand was built
        if getattr(self, "_dec8_n", -1) != n:
            npad = -(-n // 1024) * 1024
            # the packing's integer margins assume |values| <= 127
            # (_pack_caps); code 0 maps to -128, so clip it to -127 — a
            # one-step error on the rare per-dim minimum only
            s8 = jnp.maximum(self._codes_s8, jnp.int8(-127))
            nrm = jnp.sum(jnp.square(self.sq.scale[None, :]
                                     * s8.astype(jnp.float32)), axis=-1)
            self._dec8 = jnp.pad(
                s8, ((0, npad - n), (0, adc_scan.padded_dim(self.dim)
                                     - self.dim)))
            self._norm8 = jnp.pad(nrm, (0, npad - n))
            self._dec8_n = n
        b_vec = self.sq.bias + 128.0 * self.sq.scale   # decode offset
        return adc_scan.adc_search(q - b_vec[None, :], self._dec8,
                                   self._norm8, self.sq.scale, min(k, n), n,
                                   route=route)

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path, codes_s8=np.asarray(self._codes_s8),
                 term3=np.asarray(self._term3),
                 vmin=np.asarray(self.sq.vmin),
                 vdiff=np.asarray(self.sq.vdiff),
                 rounding=self.sq.rounding, mode=self.mode)

    @classmethod
    def load(cls, path: str) -> "FlatSQIndex":
        z = np.load(path, allow_pickle=False)
        sq = ScalarQuantizer(vmin=jnp.asarray(z["vmin"]),
                             vdiff=jnp.asarray(z["vdiff"]),
                             rounding=str(z["rounding"]))
        idx = cls(sq, mode=str(z["mode"]))
        idx._codes_s8 = jnp.asarray(z["codes_s8"])
        idx._term3 = jnp.asarray(z["term3"])
        return idx
