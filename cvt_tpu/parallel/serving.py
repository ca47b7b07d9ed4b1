"""Multi-host sharded ADC serving (BASELINE config 5).

The reference has no distributed runtime at all (SURVEY §2.5/§5.8 — its
parallelism is OpenMP threads); this module is the new surface this
build adds: a code database sharded over every GPU of one or several
hosts, continuous query batching, and a collective top-k merge.

Components:
  * init_distributed() — jax.distributed.initialize wrapper (the
    process-per-host runtime; idempotent, no-op for single-process).
  * MultiHostADCServer — code shards ingested PER HOST (each process
    device_puts only its local rows via
    jax.make_array_from_process_local_data), one jitted shard_map serve
    step per query batch running the packed scan on each shard (route
    from cvt_tpu.ops.backend.scan_route over the mesh's devices),
    candidates merged over the mesh with either one all_gather or a
    ppermute ring (`merge='ring'`) whose exchange overlaps the next
    micro-batch's scan in serve_pipelined().
  * QueryBatcher — continuous batching front-end: callers submit
    individual query rows/blocks; a background flusher pads to the
    serving batch and fans results back out through futures.

Device order in the mesh is host-major (jax.devices() order), so ring
neighbors share a host except at host boundaries. The GPUs of one host
are joined all to all, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import Future
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cvt_tpu.ops import backend
from cvt_tpu.ops.pallas import adc_scan
from cvt_tpu.ops.topk import merge_topk
from cvt_tpu.parallel.sharded_search import shard_scan_operand, shard_seg
from cvt_tpu.quant.opq import OPQ
from cvt_tpu.quant.pq import ProductQuantizer


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Initialize the JAX multi-host runtime (idempotent).

    With no arguments, reads the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) or
    cluster auto-detection; single-process when none are set. Returns the
    process index.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes > 1 and jax.process_count() == 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address
            or os.environ.get("JAX_COORDINATOR_ADDRESS"),
            num_processes=num_processes,
            process_id=(process_id if process_id is not None
                        else int(os.environ.get("JAX_PROCESS_ID", "0"))))
    return jax.process_index()


def serving_mesh(devices=None, axis: str = "db") -> Mesh:
    """1-D mesh over every device of every host, host-major order (ring
    neighbors share a host except at host boundaries)."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), (axis,))


def ring_merge_topk(d, i, axis: str, k: int):
    """Ring all-reduce with merge_topk as the reduction: S-1 ppermute
    steps rotate every shard's local candidates once around the ring;
    each stop merges into the local accumulator. Equivalent result to
    all_gather+top_k, but each step moves only [B, k] and the exchanges
    can overlap other compute (XLA async collective-permute)."""
    s = jax.lax.axis_size(axis)
    perm = [(j, (j + 1) % s) for j in range(s)]
    d_acc, i_acc, d_buf, i_buf = d, i, d, i
    for _ in range(s - 1):
        d_buf = jax.lax.ppermute(d_buf, axis, perm)
        i_buf = jax.lax.ppermute(i_buf, axis, perm)
        d_acc, i_acc = merge_topk(
            jnp.concatenate([d_acc, d_buf], axis=-1),
            jnp.concatenate([i_acc, i_buf], axis=-1), k)
    return d_acc, i_acc


class MultiHostADCServer:
    """Sharded flat-ADC serving over all devices of a (multi-host) mesh.

    The code matrix is sharded along N over the mesh 'db' axis; each
    shard runs the packed scan (kernel on a GPU mesh, plain XLA on a CPU
    mesh, the kernel interpreted on a CPU mesh with impl='pallas');
    candidates merge via all_gather (default) or a ppermute ring.
    """

    def __init__(self, quantizer, mesh: Mesh | None = None, *,
                 axis: str = "db", dp_axis: str | None = None,
                 merge: str = "allgather", seg: int = 128,
                 impl: str = "auto"):
        """axis: the database-sharding mesh axis. dp_axis: optional
        QUERY-data-parallel axis of a 2-D ('dp','db') mesh — query
        batches shard over it instead of being replicated to every
        shard (all-replicated queries waste (dp-1)/dp of the scan work).
        impl goes to cvt_tpu.ops.backend.scan_route."""
        if isinstance(quantizer, OPQ):
            self.pq = quantizer.pq
            self.rotation = quantizer.rotation
        elif isinstance(quantizer, ProductQuantizer):
            self.pq = quantizer
            self.rotation = None
        else:
            raise TypeError(type(quantizer))
        if merge not in ("allgather", "ring"):
            raise ValueError(merge)
        self.mesh = mesh if mesh is not None else serving_mesh()
        self.axis = axis
        self.dp_axis = dp_axis
        if dp_axis is not None and dp_axis not in self.mesh.shape:
            raise ValueError(f"mesh has no axis {dp_axis!r}")
        self.merge = merge
        self.seg = seg
        self.route = backend.scan_route(self.mesh.devices, impl)
        self._dec8 = None             # [Npad, Dpad] int8, sharded P(db)
        self._n = 0
        self._serve_cache: dict = {}

    # ------------------------------------------------------------ ingest
    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    def shard_rows(self, n_global: int) -> tuple[int, int, int]:
        """(start, stop, per_shard) of THIS PROCESS's row range for a
        database of n_global rows (host-sharded ingestion contract: each
        process loads rows [start, stop) itself)."""
        per = self._per_shard(n_global)
        procs = jax.process_count()
        shards_per_proc = self.n_shards // procs
        p = jax.process_index()
        start = p * shards_per_proc * per
        stop = min((p + 1) * shards_per_proc * per, n_global)
        return start, min(start, stop) if stop < start else stop, per

    def _per_shard(self, n: int) -> int:
        s = self.n_shards
        per = -(-n // s)
        # whole 128-row scan blocks and whole segments in every shard
        t = max(128, self.seg)
        return -(-per // t) * t

    def _rotate(self, x):
        x = jnp.asarray(x, jnp.float32)
        if self.rotation is None:
            return x
        return jnp.matmul(x, self.rotation,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)

    def encode(self, x) -> np.ndarray:
        """Raw floats -> [N, M] uint8 codes (rotated space)."""
        return np.asarray(self.pq.encode(self._rotate(x)))

    def load_local(self, local_codes, *, n_global: int | None = None):
        """Per-host shard ingestion: THIS process supplies only its local
        rows (uint8 [n_local, M], already encoded, covering shard_rows()).
        Single-process callers just pass the whole code matrix.

        Builds the global [Npad, M] code array without any process ever
        holding the full database; every device then decodes its own
        rows into the scan operand.
        """
        local = np.asarray(local_codes, np.uint8)
        if n_global is None:
            n_global = local.shape[0] * jax.process_count()
        per = self._per_shard(n_global)
        npad = per * self.n_shards
        procs = jax.process_count()
        local_rows = npad // procs
        if local.shape[0] < local_rows:     # pad this host's tail shard
            local = np.concatenate(
                [local, np.zeros((local_rows - local.shape[0],
                                  local.shape[1]), np.uint8)], axis=0)
        sh = NamedSharding(self.mesh, P(self.axis, None))
        codes = jax.make_array_from_process_local_data(
            sh, local, (npad, local.shape[1]))
        self._dec8, self._norm8, self._srow = shard_scan_operand(
            self.pq, codes, sh)
        self._n = n_global
        self._per = per
        self._serve_cache.clear()

    def load(self, x=None, *, codes=None) -> None:
        """Convenience single-process load from raw floats or codes."""
        if codes is None:
            codes = self.encode(x)
        self.load_local(codes, n_global=np.asarray(codes).shape[0])

    # ------------------------------------------------------------- serve
    def _local_topk(self, k: int):
        """Per-shard scan + local top-k with global ids, for shard_map
        bodies; rows beyond a shard's valid range (the last shard's
        padding) rank last through a traced n_valid."""
        axis, per, n, route = self.axis, self._per, self._n, self.route
        seg = shard_seg(per, self.seg, k)

        def local(qr, dec_l, norm_l, srow):
            start = jax.lax.axis_index(axis) * per
            n_valid_l = jnp.clip(n - start, 0, per)
            d, i = adc_scan.adc_search(qr, dec_l, norm_l, srow, k,
                                       n_valid_l, seg=seg, route=route)
            return d, jnp.where(i >= 0, i + start, -1)
        return local

    def _rotate_in(self, qr):
        """The rotation, folded into the serving program."""
        if self.rotation is None:
            return qr
        return jnp.matmul(qr, self.rotation,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)

    def _build(self, k: int, b: int):
        axis, merge, mesh = self.axis, self.merge, self.mesh
        local = self._local_topk(k)

        def body(qr, dec_l, norm_l, srow):
            d, gid = local(self._rotate_in(qr), dec_l, norm_l, srow)
            if merge == "ring":
                return ring_merge_topk(d, gid, axis, k)
            d_all = jax.lax.all_gather(d, axis, axis=1)
            i_all = jax.lax.all_gather(gid, axis, axis=1)
            bl = d.shape[0]
            return merge_topk(d_all.reshape(bl, -1),
                              i_all.reshape(bl, -1), k)

        qspec = P(self.dp_axis) if self.dp_axis else P()
        fn = jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(qspec, P(axis, None), P(axis), P()),
            out_specs=(qspec, qspec),
            check_vma=False,     # merged results replicated over db
        ))
        return fn

    def serve(self, q, k: int):
        """One serving step: q [B, D] raw space -> (dists, global ids).

        With a dp axis, the batch is padded up to a multiple of the dp
        mesh-axis size before device_put (an indivisible batch would
        otherwise fail deep inside shard_map with an opaque sharding
        error); pad rows are sliced off the result."""
        if self._dec8 is None:
            raise RuntimeError("load() first")
        qr = jnp.asarray(q, jnp.float32)      # raw space; body rotates
        b = qr.shape[0]
        bpad = b
        if self.dp_axis:
            dp = self.mesh.shape[self.dp_axis]
            bpad = -(-b // dp) * dp
            if bpad != b:
                qr = jnp.concatenate(
                    [qr, jnp.zeros((bpad - b, qr.shape[1]), qr.dtype)],
                    axis=0)
        key = (k, bpad)
        if key not in self._serve_cache:
            self._serve_cache[key] = self._build(k, bpad)
        qspec = P(self.dp_axis) if self.dp_axis else P()
        qr = jax.device_put(qr, NamedSharding(self.mesh, qspec))
        d, i = self._serve_cache[key](qr, self._dec8, self._norm8,
                                      self._srow)
        d, i = d[:b], i[:b]
        return d, jnp.where(i < self._n, i, -1)

    def serve_pipelined(self, q_microbatches, k: int):
        """Double-buffered serving over T micro-batches: micro-batch t's
        ring exchange is issued in the same step as micro-batch t+1's
        scan, so the ppermute can run while the scan computes (XLA's
        async collective-permute does the overlap). Requires
        merge='ring'.

        q_microbatches: [T, B_mb, D]. Returns (dists [T*B_mb, k], ids).
        """
        if self.merge != "ring":
            raise ValueError("serve_pipelined requires merge='ring'")
        if self._dec8 is None:
            raise RuntimeError("load() first")
        qs = jnp.asarray(q_microbatches, jnp.float32)
        t, b_mb, d_dim = qs.shape
        if self.dp_axis and b_mb % self.mesh.shape[self.dp_axis]:
            raise ValueError(
                f"micro-batch size {b_mb} must be a multiple of the "
                f"'{self.dp_axis}' mesh axis "
                f"({self.mesh.shape[self.dp_axis]})")
        axis, k_ = self.axis, k
        local = self._local_topk(k)
        rotation = self.rotation

        def body(qs, dec_l, norm_l, srow):
            if rotation is not None:
                qs = jnp.einsum("tbd,de->tbe", qs, rotation,
                                precision=jax.lax.Precision.HIGHEST,
                                preferred_element_type=jnp.float32)

            def scan_one(q_mb):
                return local(q_mb, dec_l, norm_l, srow)

            def step(carry, q_mb):
                prev_d, prev_i = carry
                # issue the previous micro-batch's ring exchange and the
                # current micro-batch's scan in the same step — no data
                # dependence between them, XLA overlaps the collective
                out_d, out_i = ring_merge_topk(prev_d, prev_i, axis, k_)
                cur_d, cur_i = scan_one(q_mb)
                return (cur_d, cur_i), (out_d, out_i)

            d0, i0 = scan_one(qs[0])
            (last_d, last_i), (outs_d, outs_i) = jax.lax.scan(
                step, (d0, i0), qs[1:])
            fin_d, fin_i = ring_merge_topk(last_d, last_i, axis, k_)
            outs_d = jnp.concatenate([outs_d, fin_d[None]], axis=0)
            outs_i = jnp.concatenate([outs_i, fin_i[None]], axis=0)
            return outs_d, outs_i

        qspec = P(None, self.dp_axis) if self.dp_axis else P()
        ospec = P(None, self.dp_axis) if self.dp_axis else P()
        # one compiled executable per (T, B_mb, k): rebuilding the jit
        # every call would recompile on every serve
        ck = ("pipe", t, b_mb, k)
        if ck not in self._serve_cache:
            self._serve_cache[ck] = jax.jit(jax.shard_map(
                body, mesh=self.mesh,
                in_specs=(qspec, P(axis, None), P(axis), P()),
                out_specs=(ospec, ospec),
                check_vma=False,
            ))
        fn = self._serve_cache[ck]
        rot = jax.device_put(qs, NamedSharding(self.mesh, qspec))
        dd, ii = fn(rot, self._dec8, self._norm8, self._srow)
        dd = dd.reshape(t * b_mb, k_)
        ii = ii.reshape(t * b_mb, k_)
        return dd, jnp.where(ii < self._n, ii, -1)


class QueryBatcher:
    """Continuous query batching: callers submit [n_i, D] blocks; a
    background flusher concatenates them into fixed serving batches
    (padding the tail), runs `serve_fn`, and resolves per-caller futures.

    A serving front-end's dynamic batcher: fixed batch shape (one
    compiled executable), flush on size or deadline.
    """

    def __init__(self, serve_fn, batch_size: int = 1024, k: int = 10,
                 max_wait_ms: float = 5.0):
        self.serve_fn = serve_fn
        self.batch_size = batch_size
        self.k = k
        self.max_wait = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, q) -> Future:
        """q [n, D] -> Future of (dists [n, k], ids [n, k])."""
        q = np.asarray(q, np.float32)
        fut: Future = Future()
        self._q.put((q, fut))
        return fut

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        import time as _time
        pending: list = []
        n_pend = 0
        deadline = None
        while not self._stop.is_set() or pending or not self._q.empty():
            timeout = self.max_wait
            if deadline is not None:
                timeout = max(deadline - _time.monotonic(), 0.0)
            try:
                item = self._q.get(timeout=timeout if pending else 0.05)
                pending.append(item)
                n_pend += item[0].shape[0]
                if deadline is None:
                    deadline = _time.monotonic() + self.max_wait
            except queue.Empty:
                pass
            flush = pending and (
                n_pend >= self.batch_size
                or (deadline is not None
                    and _time.monotonic() >= deadline)
                or self._stop.is_set())
            if flush:
                self._flush(pending)
                pending, n_pend, deadline = [], 0, None

    def _flush(self, pending) -> None:
        qs = np.concatenate([p[0] for p in pending], axis=0)
        n = qs.shape[0]
        bs = self.batch_size
        try:
            outs_d, outs_i = [], []
            for s in range(0, n, bs):
                blk = qs[s:s + bs]
                if blk.shape[0] < bs:
                    blk = np.concatenate(
                        [blk, np.zeros((bs - blk.shape[0], blk.shape[1]),
                                       np.float32)], axis=0)
                d, i = self.serve_fn(blk, self.k)
                outs_d.append(np.asarray(d))
                outs_i.append(np.asarray(i))
            d = np.concatenate(outs_d, axis=0)[:n]
            i = np.concatenate(outs_i, axis=0)[:n]
            off = 0
            for q, fut in pending:
                m = q.shape[0]
                fut.set_result((d[off:off + m], i[off:off + m]))
                off += m
        except Exception as e:               # propagate to every caller
            for _, fut in pending:
                if not fut.done():
                    fut.set_exception(e)
