"""HNSW graph index — ctypes binding over the native C++ core.

Capability parity: the reference's hnswlib usage surface
(hnsw_sifts_retrieval/hnswlib/hnswalg.h: HierarchicalNSW ctor
M/ef_construction, addPoint, searchKnn, saveIndex/loadIndex;
brute_force_search/src/hnswlib.hpp:22-57). The graph core is the native
module cvt_tpu/native/hnsw.cc (from-scratch HNSW, OpenMP batch ops).

Where it fits: on the accelerator the primary ANN engine is the flat
packed ADC scan (streaming device memory beats pointer chasing);
HnswIndex is the host-side complement for latency-sensitive small
indexes and for recall parity experiments at the reference operating
point (M=32, efC=80, IP, d=128).
"""

from __future__ import annotations

import ctypes

import numpy as np

METRIC_L2 = 0
METRIC_IP = 1
_METRICS = {"l2": METRIC_L2, "ip": METRIC_IP}


def _lib():
    from cvt_tpu.native import load_library
    lib = load_library("hnsw")
    if not getattr(lib, "_cvt_hnsw_ready", False):
        c = ctypes
        lib.cvt_hnsw_new.restype = c.c_void_p
        lib.cvt_hnsw_new.argtypes = [c.c_int, c.c_int, c.c_int64, c.c_int,
                                     c.c_int, c.c_uint64]
        lib.cvt_hnsw_free.argtypes = [c.c_void_p]
        lib.cvt_hnsw_size.restype = c.c_int64
        lib.cvt_hnsw_size.argtypes = [c.c_void_p]
        lib.cvt_hnsw_dim.restype = c.c_int
        lib.cvt_hnsw_dim.argtypes = [c.c_void_p]
        lib.cvt_hnsw_add.restype = c.c_int64
        lib.cvt_hnsw_add.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                     c.c_int64, c.c_int]
        lib.cvt_hnsw_search.restype = c.c_int
        lib.cvt_hnsw_search.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                        c.c_int, c.c_int, c.c_int,
                                        c.c_void_p, c.c_void_p]
        lib.cvt_hnsw_save.restype = c.c_int
        lib.cvt_hnsw_save.argtypes = [c.c_void_p, c.c_char_p]
        lib.cvt_hnsw_load.restype = c.c_void_p
        lib.cvt_hnsw_load.argtypes = [c.c_char_p, c.c_int64]
        lib._cvt_hnsw_ready = True
    return lib


class HnswIndex:
    """Layered proximity-graph ANN index (host-side, native core)."""

    def __init__(self, dim: int, *, metric: str = "l2",
                 capacity: int = 1 << 20, m: int = 32,
                 ef_construction: int = 80, seed: int = 0,
                 _handle=None):
        self._lib = _lib()
        self.dim = int(dim)
        self.metric = metric
        if _handle is not None:
            self._h = _handle
            return
        self._h = self._lib.cvt_hnsw_new(
            self.dim, _METRICS[metric], int(capacity), int(m),
            int(ef_construction), int(seed))
        if not self._h:
            raise MemoryError("hnsw allocation failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.cvt_hnsw_free(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.cvt_hnsw_size(self._h))

    def add(self, vectors, labels=None, *, num_threads: int = 0) -> int:
        """Add [N, dim] float32 vectors; labels default to running ids."""
        x = np.ascontiguousarray(np.asarray(vectors, np.float32))
        assert x.ndim == 2 and x.shape[1] == self.dim, x.shape
        n = x.shape[0]
        if labels is None:
            start = len(self)
            labels = np.arange(start, start + n, dtype=np.int64)
        lab = np.ascontiguousarray(np.asarray(labels, np.int64))
        added = self._lib.cvt_hnsw_add(
            self._h, x.ctypes.data, lab.ctypes.data, n, num_threads)
        if added < 0:
            raise RuntimeError("hnsw add failed (capacity exceeded?)")
        return int(added)

    def search(self, queries, k: int = 10, *, ef: int = 50,
               num_threads: int = 0):
        """[B, dim] queries -> (dists [B, k] f32, labels [B, k] i64).

        Unfilled slots (index smaller than k) hold dist=+inf, label=-1.
        """
        q = np.ascontiguousarray(np.asarray(queries, np.float32))
        if q.ndim == 1:
            q = q[None]
        assert q.shape[1] == self.dim, q.shape
        b = q.shape[0]
        out_l = np.empty((b, k), np.int64)
        out_d = np.empty((b, k), np.float32)
        rc = self._lib.cvt_hnsw_search(
            self._h, q.ctypes.data, b, k, max(ef, k), num_threads,
            out_l.ctypes.data, out_d.ctypes.data)
        if rc != 0:
            raise RuntimeError("hnsw search failed")
        return out_d, out_l

    def save(self, path: str) -> None:
        if self._lib.cvt_hnsw_save(self._h, path.encode()) != 0:
            raise IOError(f"hnsw save failed: {path}")

    @classmethod
    def load(cls, path: str, *, metric: str = "l2",
             capacity: int = 0) -> "HnswIndex":
        lib = _lib()
        h = lib.cvt_hnsw_load(path.encode(), int(capacity))
        if not h:
            raise IOError(f"hnsw load failed: {path}")
        dim = lib.cvt_hnsw_dim(h)
        return cls(dim, metric=metric, _handle=h)
