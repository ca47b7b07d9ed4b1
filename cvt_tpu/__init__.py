"""cvt-tpu: a batched, accelerator-first content-based image retrieval (CBIR)
framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of
willard-yuan/cvt ("CVT, a Computer Vision Toolkit"): local-feature
extraction (SIFT / covariant detectors), vector compression (PCA, int8
scalar quantization, PQ/OPQ), nearest-neighbor search (exact flat scan,
flat ADC code scan, IVF-ADC), geometric verification / re-ranking
(SVF, batched RANSAC, vote-and-verify), and applied subsystems
(image-level retrieval, perceptual hash, AUC metrics).

Design stance (accelerator-first, not a port):
  * Everything is batch-first: where the reference loops over
    descriptors/images with SIMD+OpenMP+pthreads, we operate on dense
    [B, ...] arrays under jit.
  * Distance scans are matmuls. The reference's AVX inner-product
    kernels (brute_force_search/src/space_ip.hpp) become a single
    [B,D]x[D,N] contraction; its per-point ADC LUT-sum loop
    (opq/src/IVFOPQ.cpp:300-309) becomes one-hot decode as matmuls
    followed by an int8/bf16 score matmul fused with top-k.
  * Scale-out is a jax.sharding.Mesh + shard_map with XLA collectives
    (the reference has no distributed layer at all).
  * A Pallas kernel covers what XLA fusion cannot: the packed int8
    segment scan that never writes the [N, B] score matrix.

Subpackages:
  io        binary vector formats (fvecs/bvecs/ivecs + cvt's record format)
  ops       core array ops: normalize, pairwise distances, top-k, k-means
  quant     codecs: scalar (int8), product (PQ), optimized product (OPQ), PCA
  index     search engines: Flat, FlatSQ, FlatADC, IVFADC
  parallel  device-mesh sharded search and training
  features  scale-space keypoint detection + SIFT descriptors
  match     descriptor matching, SVF, RANSAC, vote-and-verify
  apps      end-to-end applications (image retrieval, pHash, AUC)
"""

__version__ = "0.1.0"

from cvt_tpu import ops  # noqa: F401
