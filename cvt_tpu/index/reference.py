"""Independent float32 LUT-ADC reference for the flat ADC engines.

The reference's own search (opq/src/IVFOPQ.cpp:279-309) builds one
[M, K] table of ||q_m - cb[m, k]||^2 per query and sums table entries
over each code row. This module does exactly that, elementwise — no
matmul, so no reduced-precision product mode on any device — over every
code row. It shares no code with the scans it checks (FlatADCIndex's
bf16 engine and the packed int8 scan).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _luts(qr, codebooks):
    m, _, ds = codebooks.shape
    b = qr.shape[0]
    return jnp.sum(jnp.square(qr.reshape(b, m, 1, ds) - codebooks[None]),
                   axis=-1)                                  # [B, M, K]


@partial(jax.jit, static_argnames=("k",))
def lut_adc_topk(qr, codes, codebooks, k: int):
    """Exact float32 ADC top-k: qr [B, D] rotated queries, codes [N, M]
    u8, codebooks [M, K, ds]. Returns (dists [B, k], ids [B, k])."""
    m = codebooks.shape[0]
    sub = jnp.arange(m)[None, :]
    codes = codes.astype(jnp.int32)

    def one(t):                                              # t [M, K]
        neg, i = jax.lax.top_k(-jnp.sum(t[sub, codes], axis=-1), k)
        return -neg, i
    return jax.lax.map(one, _luts(qr, codebooks), batch_size=8)


@jax.jit
def lut_adc_dist(qr, codes_at, codebooks):
    """Exact float32 ADC distance of each query [B, D] to one code row
    each, codes_at [B, M]."""
    g = jnp.take_along_axis(_luts(qr, codebooks),
                            codes_at.astype(jnp.int32)[:, :, None], axis=2)
    return jnp.sum(g[..., 0], axis=-1)
