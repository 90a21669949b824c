"""Functional layer library.

Pure-function, explicit-params re-design of the reference's
Keras-style layer objects (gcn/layers.py).  Every layer is a function
``(params, inputs, ...) -> outputs``; parameters live in plain pytrees created
by the matching ``init_*`` functions.  Numerics follow the reference
bit-for-intent:

* glorot init       — uniform(+-sqrt(6/(fan_in+fan_out)))  (TF1 default
                      glorot_uniform relied on by gcn/inits.py:10-12)
* layer norm        — per-row moments, eps 1e-9             (layers.py:87-97)
* det-dropout FC    — rectified-Gaussian moment propagation including the
                      published 1.2 variance fudge, eps 1e-10
                      (layers.py:141-202)
* dropout           — inverted scaling with keep_prob       (layers.py:415-433)
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..data.graph import PaddedSparseFeatures


# --------------------------------------------------------------------------
# initializers (gcn/inits.py)
# --------------------------------------------------------------------------

def glorot(key: jax.Array, shape, dtype=jnp.float32) -> jax.Array:
    fan_in, fan_out = shape[0], shape[1]
    limit = jnp.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, -limit, limit)


def zeros(shape, dtype=jnp.float32) -> jax.Array:
    return jnp.zeros(shape, dtype)


def ones(shape, dtype=jnp.float32) -> jax.Array:
    return jnp.ones(shape, dtype)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def matmul(x, w):
    """Dense or padded-sparse matmul.

    For :class:`PaddedSparseFeatures` inputs the product X @ W becomes a
    gather-sum over per-row (idx, val) slots — the embedding-lookup form of
    the reference's ``tf.sparse_tensor_dense_matmul`` (gcn/layers.py:31-37).
    """
    if isinstance(x, PaddedSparseFeatures):
        safe_idx = jnp.minimum(x.idx, x.dim - 1)
        rows = jnp.take(w, safe_idx, axis=0)          # [R, nnz_cap, out]
        return jnp.einsum("rc,rco->ro", x.val, rows)
    return jnp.dot(x, w)


def layer_norm(x: jax.Array, offset: jax.Array, scale: jax.Array,
               eps: float = 1e-9) -> jax.Array:
    """Per-row layer norm, TF batch_normalization semantics
    (gcn/layers.py:87-97: x_hat = (x-mean)*rsqrt(var+eps)*scale + offset)."""
    mean = jnp.mean(x, axis=1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * scale + offset


def dropout(key: jax.Array, x, keep_prob: float):
    """Inverted dropout.  For padded-sparse inputs the mask is applied to the
    stored values, matching the reference's sparse_dropout over nnz values
    (gcn/layers.py:23-28)."""
    if keep_prob >= 1.0:
        return x
    if isinstance(x, PaddedSparseFeatures):
        mask = jax.random.bernoulli(key, keep_prob, x.val.shape)
        new_val = jnp.where(mask, x.val, 0.0) * (1.0 / keep_prob)
        return PaddedSparseFeatures(idx=x.idx, val=new_val, dim=x.dim)
    mask = jax.random.bernoulli(key, keep_prob, x.shape)
    return jnp.where(mask, x, 0.0) * (1.0 / keep_prob)


# --------------------------------------------------------------------------
# Dense (gcn/layers.py:100-138)
# --------------------------------------------------------------------------

def init_dense(key, input_dim: int, output_dim: int, norm: bool) -> dict:
    p = {"weights": glorot(key, (input_dim, output_dim))}
    if norm:
        p["offset"] = zeros((1, output_dim))
        p["scale"] = ones((1, output_dim))
    return p


def dense(params: dict, x, act, norm: bool):
    out = matmul(x, params["weights"])
    if norm:
        out = layer_norm(out, params["offset"], params["scale"], eps=1e-9)
    return act(out)


# --------------------------------------------------------------------------
# AugmentedDropoutDense (gcn/layers.py:365-412) — CVD's dual-stream FC:
# noisy stream x gets dropout, clean stream mu shares the weights; both get
# the same layer norm and activation; mu is detached.
# --------------------------------------------------------------------------

def init_aug_dense(key, input_dim: int, output_dim: int, norm: bool) -> dict:
    return init_dense(key, input_dim, output_dim, norm)


def aug_dropout_dense(params: dict, key, inputs, keep_prob: float, act,
                      norm: bool):
    if isinstance(inputs, tuple):
        x, mu = inputs
    else:
        x, mu = inputs, inputs
    x = dropout(key, x, keep_prob)
    x = matmul(x, params["weights"])
    mu = matmul(mu, params["weights"])
    if norm:
        x = layer_norm(x, params["offset"], params["scale"], eps=1e-9)
        mu = layer_norm(mu, params["offset"], params["scale"], eps=1e-9)
    return act(x), jax.lax.stop_gradient(act(mu))


# --------------------------------------------------------------------------
# DetDropoutFC (gcn/layers.py:141-202) — analytic (mu, var) propagation
# through dropout -> linear -> layernorm -> rectified-Gaussian ReLU.
# --------------------------------------------------------------------------

def init_det_dropout_fc(key, input_dim: int, output_dim: int,
                        norm: bool) -> dict:
    return init_dense(key, input_dim, output_dim, norm)


def det_dropout_fc(params: dict, inputs, keep_prob: float, norm: bool):
    p = keep_prob
    if isinstance(inputs, tuple):
        mu, var = inputs
        mu2 = jnp.square(mu)
        var = (var + mu2) / p - mu2
    elif isinstance(inputs, PaddedSparseFeatures):
        # sparse first layer (reference: dot(..., sparse=True) at
        # layers.py:176-178): moments stay in padded-sparse form through
        # the linear step — squaring acts on stored nnz values
        mu = inputs
        var = PaddedSparseFeatures(
            idx=inputs.idx,
            val=(1.0 - p) / p * jnp.square(inputs.val),
            dim=inputs.dim)
    else:
        mu = inputs
        var = (1.0 - p) / p * jnp.square(inputs)

    # Linear; the 1.2 variance multiplier reproduces layers.py:178.
    w = params["weights"]
    mu = matmul(mu, w)
    var = matmul(var, jnp.square(w)) * 1.2

    if norm:
        mean = jnp.mean(mu, axis=1, keepdims=True)
        variance = jnp.mean(jnp.square(mu - mean), axis=1, keepdims=True)
        mu = ((mu - mean) * jax.lax.rsqrt(variance + 1e-10)
              * params["scale"] + params["offset"])
        # the reference divides by raw variance (layers.py:185) but its
        # dynamic shapes never produce all-zero rows; static-shape padding
        # does (sentinel slots), where 0 * inf = NaN — share the mu path's
        # batch_normalization epsilon (1e-10, layers.py:184)
        var = var * (jnp.square(params["scale"]) / (variance + 1e-10))

    # Rectified-Gaussian ReLU moments (layers.py:189-201).  The 1e-20 floor
    # keeps sentinel (all-zero) rows finite; the reference never sees
    # zero-variance rows so has no guard.
    sigma = jnp.sqrt(var + 1e-20)
    alpha = -mu / sigma
    phi = jax.scipy.stats.norm.pdf(alpha)
    big_phi = jax.scipy.stats.norm.cdf(alpha)
    z = jax.scipy.stats.norm.cdf(-alpha) + 1e-10
    phi_z = phi / z

    m = mu + sigma * phi_z
    mu_out = z * m
    var_out = jax.nn.relu(var * (1.0 + alpha * phi_z - jnp.square(phi_z))) \
        + 1e-10
    var_out = z * var_out + z * big_phi * jnp.square(mu_out)
    return mu_out, var_out


# --------------------------------------------------------------------------
# Dropout layer over the estimator-specific input types
# (gcn/layers.py:415-433)
# --------------------------------------------------------------------------

def dropout_layer(key, inputs, keep_prob: float, cvd: bool):
    if cvd and isinstance(inputs, tuple):
        h, _mu = inputs
        return dropout(key, h, keep_prob)
    if isinstance(inputs, tuple):
        mu, var = inputs
        k1, k2 = jax.random.split(key)
        x = mu + jax.random.normal(k1, var.shape) * jnp.sqrt(var + 1e-10)
        return dropout(k2, x, keep_prob)
    return dropout(key, inputs, keep_prob)


def relu(x):
    return jax.nn.relu(x)


def identity(x):
    return x
