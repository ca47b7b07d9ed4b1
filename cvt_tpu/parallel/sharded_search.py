"""Sharded flat ADC search over a device mesh.

The new distributed surface (no reference counterpart — SURVEY.md §2.5):

  * the PQ code matrix [N, M] and per-point norms are sharded along N
    over the mesh's 'db' axis (NamedSharding);
  * queries are replicated over 'db';
  * each device scans its local shard with the same packed scan as the
    single-device path and extracts a LOCAL top-k with globalized ids
    (shard offset from jax.lax.axis_index);
  * per-shard candidates are merged with an all_gather over 'db' — k*S
    candidates per query, one final top-k. XLA lowers the collective to
    NCCL over NVLink; no hand-written communication.

The whole step is one shard_map-ped jitted function; XLA overlaps the
gather with the tail of the scan.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cvt_tpu.ops import backend
from cvt_tpu.ops.pallas import adc_scan
from cvt_tpu.ops.topk import merge_topk
from cvt_tpu.quant.opq import OPQ
from cvt_tpu.quant.pq import ProductQuantizer


def shard_scan_operand(pq, codes, sharding):
    """Per-shard operand of the packed scan from codes [Npad, M] u8
    already placed with a row sharding: (dec [Npad, Dpad] int8, norm
    [Npad] f32, srow [D]). Each device decodes its own rows."""
    cb_q, srow = adc_scan.quantize_codebooks(pq.codebooks)
    cb_q, srow = jnp.asarray(cb_q), jnp.asarray(srow)
    row = NamedSharding(sharding.mesh, P(sharding.spec[0]))
    dec = jax.jit(adc_scan.decode_int8, static_argnums=2,
                  out_shardings=sharding)(codes, cb_q,
                                          adc_scan.padded_dim(pq.dim))
    norm = jax.jit(adc_scan.int8_row_norms, out_shardings=row)(
        codes, cb_q, srow)
    return dec, norm, srow


def shard_seg(per: int, seg: int, k: int) -> int:
    """Segment size for a shard of `per` rows: enough segments for k
    distinct local candidates."""
    seg = min(seg, per)
    while per // seg < k and seg > 8:
        seg //= 2
    return seg


class ShardedADCSearcher:
    """Flat ADC scan sharded over a mesh 'db' axis.

    Queries are replicated across shards; the database is split evenly
    (padded) along N. search() is one jitted shard_map step running the
    packed scan (cvt_tpu.ops.pallas.adc_scan.adc_search, k <= seg) in
    every shard body, on the route cvt_tpu.ops.backend.scan_route picks
    for the MESH's devices: the kernel on a GPU mesh, its plain XLA twin
    on a CPU mesh; 'pallas' on a CPU mesh interprets the kernel.
    """

    def __init__(self, quantizer, mesh: Mesh, *, axis: str = "db",
                 impl: str = "auto", seg: int = 128):
        if isinstance(quantizer, OPQ):
            self.pq = quantizer.pq
            self.rotation = quantizer.rotation
        elif isinstance(quantizer, ProductQuantizer):
            self.pq = quantizer
            self.rotation = None
        else:
            raise TypeError(type(quantizer))
        self.mesh = mesh
        self.axis = axis
        self.seg = seg
        self.route = backend.scan_route(mesh.devices, impl)
        self._dec8 = None
        self._n = 0

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    def _rotate(self, x):
        x = jnp.asarray(x, jnp.float32)
        if self.rotation is None:
            return x
        return jnp.matmul(x, self.rotation,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)

    def load(self, x=None, *, codes=None) -> None:
        """Distribute the database: encode (if raw floats), place the
        code matrix shard-by-shard with a NamedSharding along 'db', and
        decode each shard into the scan operand on its own device."""
        if codes is None:
            codes = self.pq.encode(self._rotate(x))
        codes = np.asarray(codes, np.uint8)
        n = codes.shape[0]
        s = self.n_shards
        per = -(-n // s)
        align = max(128, self.seg)
        per = -(-per // align) * align            # align each shard
        pad = per * s - n
        if pad:
            codes = np.concatenate(
                [codes, np.zeros((pad, codes.shape[1]), np.uint8)], axis=0)
        sh = NamedSharding(self.mesh, P(self.axis, None))
        self._dec8, self._norm8, self._srow = shard_scan_operand(
            self.pq, jax.device_put(codes, sh), sh)
        self._n = n
        self._per_shard = per
        self._search_fn = None

    def _build_search(self, k: int):
        axis, per, n, route = self.axis, self._per_shard, self._n, self.route
        seg = shard_seg(per, self.seg, k)

        def body(qr, dec_l, norm_l, srow):
            start = jax.lax.axis_index(axis) * per
            n_valid_l = jnp.clip(n - start, 0, per)
            d, i = adc_scan.adc_search(qr, dec_l, norm_l, srow, k,
                                       n_valid_l, seg=seg, route=route)
            gid = jnp.where(i >= 0, i + start, -1)
            d_all = jax.lax.all_gather(d, axis, axis=1)
            i_all = jax.lax.all_gather(gid, axis, axis=1)
            bl = d.shape[0]
            return merge_topk(d_all.reshape(bl, -1),
                              i_all.reshape(bl, -1), k)

        return jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(), P(axis, None), P(axis), P()),
            out_specs=(P(), P()),
            check_vma=False,  # merged results replicated over 'db'
        ))

    def search(self, q, k: int):
        """q [B, D] raw space -> (dists [B, k], global ids [B, k]).
        Padding rows rank last only if real rows fill the top-k; ids >= n
        never appear for k <= n."""
        if self._dec8 is None:
            raise RuntimeError("load() first")
        if self._search_fn is None or self._search_k != k:
            self._search_fn = self._build_search(k)
            self._search_k = k
        # place the replicated queries on the mesh
        qr = jax.device_put(self._rotate(q), NamedSharding(self.mesh, P()))
        d, i = self._search_fn(qr, self._dec8, self._norm8, self._srow)
        # drop padding hits (only possible when k > per-shard valid rows)
        return d, jnp.where((i >= 0) & (i < self._n), i, -1)
