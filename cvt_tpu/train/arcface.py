"""ArcFace metric-learning trainer: additive-angular-margin softmax.

Reference: pytorch_arcloss/ ships only the LMDB data plumbing for an
ArcFace-style embedding trainer (image2lmdb/main.py builds the loader);
the model/loss the plumbing feeds is the standard ArcFace head. Here the
full capability is batched: an MLP/linear encoder producing
L2-normalized embeddings, an angular-margin classification head, a
jitted optax train step, and a data-parallel variant sharded over the
'dp' mesh axis with parameters replicated — gradients are averaged by
XLA's psum under `jit` with sharded inputs, no hand-written collectives.

ArcFace logits (Deng et al., CVPR'19): for the true class,
cos(theta + m) scaled by s; other classes keep s*cos(theta).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cvt_tpu.ops.linalg import l2_normalize


@dataclass
class ArcFaceState:
    """Training state: encoder params, class weights, optimizer state."""

    params: Any                 # pytree: {'layers': [{'w','b'}...], 'head': W}
    opt_state: Any
    step: int = 0


def _init_mlp(key, dims: Sequence[int]):
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        key, sub = jax.random.split(key)
        scale = jnp.sqrt(2.0 / din)
        layers.append({
            "w": jax.random.normal(sub, (din, dout), jnp.float32) * scale,
            "b": jnp.zeros((dout,), jnp.float32),
        })
    return key, layers


def _encode(layers, x):
    h = x
    for i, lyr in enumerate(layers):
        h = h @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            h = jax.nn.relu(h)
    return l2_normalize(h)


def embed(params, x: jax.Array) -> jax.Array:
    """Inference path: [B, D_in] -> L2-normalized [B, D_emb]."""
    return _encode(params["layers"], x)


def arcface_logits(params, x, y, *, scale: float = 30.0,
                   margin: float = 0.5) -> jax.Array:
    """[B, C] margin-adjusted scaled cosine logits."""
    emb = _encode(params["layers"], x)                   # [B, E] unit
    w = l2_normalize(params["head"], axis=0)             # [E, C] unit cols
    cos = jnp.clip(emb @ w, -1.0 + 1e-7, 1.0 - 1e-7)     # [B, C]
    theta = jnp.arccos(cos)
    onehot = jax.nn.one_hot(y, cos.shape[-1], dtype=cos.dtype)
    # easy-margin guard: only add margin while theta + m stays in [0, pi]
    margined = jnp.where(theta + margin < jnp.pi,
                         jnp.cos(theta + margin), cos - margin * jnp.sin(margin))
    return scale * (onehot * margined + (1.0 - onehot) * cos)


def arcface_loss(params, x, y, *, scale: float = 30.0,
                 margin: float = 0.5) -> jax.Array:
    logits = arcface_logits(params, x, y, scale=scale, margin=margin)
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


def create_state(key, *, dim_in: int, num_classes: int,
                 dim_emb: int = 128, hidden: Sequence[int] = (),
                 optimizer: optax.GradientTransformation | None = None,
                 ) -> tuple[ArcFaceState, optax.GradientTransformation]:
    """Initialize encoder (dim_in -> hidden... -> dim_emb) + head [E, C]."""
    if optimizer is None:
        optimizer = optax.adam(1e-3)
    key, layers = _init_mlp(key, [dim_in, *hidden, dim_emb])
    key, sub = jax.random.split(key)
    head = jax.random.normal(sub, (dim_emb, num_classes), jnp.float32) * 0.01
    params = {"layers": layers, "head": head}
    return ArcFaceState(params, optimizer.init(params)), optimizer


@partial(jax.jit, static_argnames=("optimizer", "scale", "margin"))
def _step(params, opt_state, x, y, optimizer, scale, margin):
    loss, grads = jax.value_and_grad(arcface_loss)(
        params, x, y, scale=scale, margin=margin)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss


def train_step(state: ArcFaceState, x, y,
               optimizer: optax.GradientTransformation, *,
               scale: float = 30.0, margin: float = 0.5,
               ) -> tuple[ArcFaceState, jax.Array]:
    params, opt_state, loss = _step(state.params, state.opt_state,
                                    jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                    optimizer, scale, margin)
    return ArcFaceState(params, opt_state, state.step + 1), loss


def make_sharded_train_step(mesh: Mesh,
                            optimizer: optax.GradientTransformation, *,
                            axis: str = "dp", scale: float = 30.0,
                            margin: float = 0.5):
    """Data-parallel train step: batch sharded on `axis`, params
    replicated; XLA inserts the gradient all-reduce.

    Returns step(state, x [B,D], y [B]) -> (state, loss) where B must be
    divisible by mesh.shape[axis].
    """
    repl = NamedSharding(mesh, P())
    batch = NamedSharding(mesh, P(axis))

    @partial(jax.jit,
             in_shardings=((repl, repl), batch, batch),
             out_shardings=((repl, repl), repl))
    def _sharded(state_tuple, x, y):
        params, opt_state = state_tuple
        loss, grads = jax.value_and_grad(arcface_loss)(
            params, x, y, scale=scale, margin=margin)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state), loss

    def step(state: ArcFaceState, x, y) -> tuple[ArcFaceState, jax.Array]:
        (params, opt_state), loss = _sharded(
            (state.params, state.opt_state),
            jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.int32))
        return ArcFaceState(params, opt_state, state.step + 1), loss

    return step
