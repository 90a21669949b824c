"""The CV full-neighbourhood contraction and the sampled fanout gather
against a float64 NumPy oracle at HIGHEST matmul precision.

The oracle and the error measure are chip_smoke.py's, which runs the same
comparison on the GPU at the Reddit-shaped widths; here the shapes are
small and the backend is the CPU.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from stochastic_gcn_tpu.data import preprocess as P  # noqa: E402
from stochastic_gcn_tpu.data.graph import pad_csr  # noqa: E402
from stochastic_gcn_tpu.models import aggregators as A  # noqa: E402


def _graph(n=300, seed=0):
    """graphsage-normalised graph with uneven degrees (2..40)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(2, 41, size=n)
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    dst = rng.integers(0, n, size=src.shape[0], dtype=np.int32)
    keep = src != dst
    edges = np.stack([src[keep], dst[keep]], 1)
    adj01 = (P.adj_from_edges(edges, n) > 0).astype(np.float32)
    return P.graphsage_normalize_adj(adj01)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["padded", "tiered", "zero_weight",
                                  "square"])
def test_full_neighborhood_mean_matches_float64_oracle(case, dtype,
                                                       monkeypatch):
    n, d = 300, 16
    g = pad_csr(_graph(n), -1, tier=(case == "tiered"))
    if case == "tiered":
        # the tier is a large-field optimisation; engage it at toy sizes
        monkeypatch.setattr(A, "TIER_MIN_ROWS", 0)
        assert 0 < g.tier_w <= g.pad_degree - 8
    else:
        g = dataclasses.replace(g, tier_w=-1)
    if case == "zero_weight":
        # real neighbour slots carrying weight 0 contribute nothing
        g = dataclasses.replace(g, w=g.w.at[::3, :2].set(0.0))
    rng = np.random.default_rng(1)
    rows = -(-(n + 1) // 8) * 8
    hist = jnp.asarray(rng.normal(size=(rows, d)).astype(np.float32)) \
        .astype(jnp.dtype(dtype))
    field = jnp.asarray(np.concatenate(
        [rng.permutation(n)[:120], [n, n]]).astype(np.int32))  # + sentinels
    with jax.default_matmul_precision("highest"):
        got = jax.jit(lambda h, gr, f: A.full_neighborhood_mean(
            h, gr, f, square=(case == "square")))(hist, g, field)
    ref, scale = C.contraction_oracle(
        np.asarray(hist.astype(jnp.float32)), np.asarray(g.nbr),
        np.asarray(g.w), np.asarray(field), square=(case == "square"))
    assert got.shape == (field.shape[0], d)
    _, rel = C.rel_error(got, ref, scale)
    assert rel <= C.CONTRACT_TOL["highest"], rel
    # sentinel rows of the field contract to exactly zero
    np.testing.assert_array_equal(np.asarray(got)[-2:], 0.0)


@pytest.mark.parametrize("parked", [False, True])
def test_fanout_gather_matches_float64_oracle(parked):
    rng = np.random.default_rng(2)
    c, f, k, d = 90, 40, 5, 12
    x = jnp.asarray(rng.normal(size=(c, d)).astype(np.float32))
    pos = rng.integers(0, c, size=(f, k)).astype(np.int32)
    w = rng.random((f, k)).astype(np.float32)
    if parked:
        # weight-0 slots parked past the table read zero rows
        from stochastic_gcn_tpu.sampler.scheduler import PARKED_POS
        w[:, -2:] = 0.0
        pos[:, -2:] = PARKED_POS
    with jax.default_matmul_precision("highest"):
        got = jax.jit(A.fanout_gather)(x, jnp.asarray(pos), jnp.asarray(w))
    ref, scale = C.fanout_oracle(np.asarray(x), pos, w)
    _, rel = C.rel_error(got, ref, scale)
    assert rel <= C.CONTRACT_TOL["highest"], rel
    assert np.isfinite(np.asarray(got)).all()


def test_rel_error_flags_nonzero_where_scale_is_zero():
    ref = np.zeros((2, 3))
    scale = np.zeros((2, 3))
    assert C.rel_error(np.zeros((2, 3)), ref, scale) == (0.0, 0.0)
    got = np.zeros((2, 3))
    got[1, 2] = 1e-9
    assert C.rel_error(got, ref, scale)[1] == np.inf
