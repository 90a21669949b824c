"""GCN model family: spec construction, parameter init, functional forward.

Replaces the reference's stateful TF1 model classes (gcn/models.py:223-337,
gcn/plaingcn.py, gcn/vrgcn.py) with:

* :func:`build_model_spec` — a static description of the layer stack,
  mirroring ``GCN._build``'s flag-driven composition exactly (PP FC blocks,
  then L x (aggregator + FC blocks), with Dense / AugmentedDropoutDense /
  DetDropoutFC selection and the --reverse dropout placement).
* :func:`init_params` / :func:`init_histories` — parameter and history
  pytrees (histories are [N+1, d] with a zero sentinel row, the functional
  form of vrgcn.py:23-36's non-trainable Variables).
* :func:`forward` — pure function over (params, batch fields, histories);
  returns logits plus the new history rows to scatter after the step.

The train/eval model distinction of the reference (two graphs built via
tf.make_template with shared weights, train.py:115-119) becomes: same params,
different ModelSpec (cv/cvd/preprocess flags) + different graph/history.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp

from ..config import Config
from ..data.graph import PaddedGraph, PaddedSparseFeatures
from ..ops import layers as L
from ..sampler.scheduler import BatchFields
from . import aggregators as agg


# ----------------------------- layer specs --------------------------------

@dataclass(frozen=True)
class DropoutSpec:
    pass


@dataclass(frozen=True)
class DenseSpec:
    name: str
    input_dim: int
    output_dim: int
    relu: bool
    norm: bool
    sparse_inputs: bool = False


@dataclass(frozen=True)
class AugDenseSpec:
    name: str
    input_dim: int
    output_dim: int
    norm: bool
    sparse_inputs: bool = False


@dataclass(frozen=True)
class DetFCSpec:
    name: str
    input_dim: int
    output_dim: int
    norm: bool
    sparse_inputs: bool = False


@dataclass(frozen=True)
class AggSpec:
    index: int


LayerSpec = Union[DropoutSpec, DenseSpec, AugDenseSpec, DetFCSpec, AggSpec]


@dataclass(frozen=True)
class ModelSpec:
    """Static model description (hashable; safe as a jit static arg)."""
    reverse_input_dropout: bool
    specs: Tuple[LayerSpec, ...]
    num_agg_layers: int          # L after the PP adjustment
    agg0_dim: int
    input_dim: int               # dim of the assembled input features
    output_dim: int
    cv: bool
    cvd: bool
    det_dropout: bool
    normalization: str
    multitask: bool
    history_dims: Tuple[int, ...]
    n_history_per_layer: int
    # (input_dim*output_dim, field index) per FC block — the FLOP
    # bookkeeping of gcn/models.py:299,336 (layer_comp)
    layer_comp: Tuple[Tuple[int, int], ...] = ()


def build_model_spec(cfg: Config, input_dim: int, output_dim: int,
                     preprocess: bool, cv: bool, cvd: bool,
                     sparse_input: bool = False) -> ModelSpec:
    """Mirror of GCN._build (gcn/models.py:258-337) + _preprocess (251-256).

    ``input_dim`` is the raw feature dimension; under PP the assembled input
    is [X_self ‖ ÂX] for graphsage norm (2x dim) or ÂX for gcn norm
    (gcn/models.py:234-241), which is what the first FC sees via dim_s.
    """
    n_agg = cfg.num_layers - 1 if preprocess else cfg.num_layers
    agg0_dim = cfg.hidden1 if preprocess else input_dim
    dim_s = 1 if cfg.normalization == "gcn" else 2

    specs: list[LayerSpec] = []
    layer_comp: list[tuple[int, int]] = []
    cnt = 0

    if preprocess:
        for l in range(cfg.num_fc_layers):
            in_dim = input_dim * dim_s if l == 0 else cfg.hidden1
            sp = sparse_input if l == 0 else False
            last = (n_agg == 0 and l + 1 == cfg.num_fc_layers)
            out_dim = output_dim if last else cfg.hidden1
            layer_comp.append((in_dim * cfg.hidden1, 0))
            if cfg.det_dropout:
                # NOTE: reference hardwires output_dim=hidden1 and
                # norm=layer_norm here (models.py:276-282); preserved.
                specs.append(DetFCSpec(f"dense{cnt}", in_dim, cfg.hidden1,
                                       cfg.layer_norm, sp))
            elif cvd:
                specs.append(AugDenseSpec(f"dense{cnt}", in_dim, cfg.hidden1,
                                          cfg.layer_norm, sp))
            else:
                specs.append(DropoutSpec())
                specs.append(DenseSpec(f"dense{cnt}", in_dim, out_dim,
                                       relu=not last,
                                       norm=(False if last
                                             else cfg.layer_norm),
                                       sparse_inputs=sp))
            cnt += 1

    for l in range(n_agg):
        specs.append(AggSpec(l))
        for l2 in range(cfg.num_fc_layers):
            dim = agg0_dim if l == 0 else cfg.hidden1
            in_dim = dim * dim_s if l2 == 0 else cfg.hidden1
            last = (l2 + 1 == cfg.num_fc_layers and l + 1 == n_agg)
            out_dim = output_dim if last else cfg.hidden1
            norm = False if last else cfg.layer_norm
            layer_comp.append((in_dim * out_dim, l + 1))
            if cfg.det_dropout and l + 1 != n_agg:
                specs.append(DetFCSpec(f"dense{cnt}", in_dim, out_dim, norm))
            elif cvd and l + 1 != n_agg:
                specs.append(AugDenseSpec(f"dense{cnt}", in_dim, out_dim,
                                          norm))
            else:
                if not cfg.reverse:
                    specs.append(DropoutSpec())
                specs.append(DenseSpec(f"dense{cnt}", in_dim, out_dim,
                                       relu=not last, norm=norm))
                if cfg.reverse and not last:
                    specs.append(DropoutSpec())
            cnt += 1

    hist_dims = tuple(agg0_dim if i == 0 else cfg.hidden1
                      for i in range(n_agg))
    return ModelSpec(
        # the reference's host-side input dropout under --reverse exists
        # only in PlainGCN (gcn/plaingcn.py:30-38); VRGCN has none
        reverse_input_dropout=cfg.reverse and not cv,
        specs=tuple(specs), num_agg_layers=n_agg, agg0_dim=agg0_dim,
        input_dim=input_dim * dim_s if preprocess and cfg.pp_nbr
        else input_dim,
        output_dim=output_dim, cv=cv, cvd=cvd,
        det_dropout=cfg.det_dropout, normalization=cfg.normalization,
        multitask=cfg.multitask, history_dims=hist_dims,
        n_history_per_layer=2 if cfg.det_dropout else 1,
        layer_comp=tuple(layer_comp))


# ----------------------------- parameters ---------------------------------

def init_params(key: jax.Array, spec: ModelSpec) -> dict:
    params = {}
    for s in spec.specs:
        if isinstance(s, (DenseSpec, AugDenseSpec, DetFCSpec)):
            key, sub = jax.random.split(key)
            params[s.name] = L.init_dense(sub, s.input_dim, s.output_dim,
                                          s.norm)
    return params


def first_param_layer(spec: ModelSpec) -> str:
    """Name of the first layer carrying variables — the weight-decay target
    (gcn/models.py:68-75)."""
    for s in spec.specs:
        if isinstance(s, (DenseSpec, AugDenseSpec, DetFCSpec)):
            return s.name
    raise ValueError("model has no parametric layers")


def weight_decay_param_names(spec: ModelSpec) -> Tuple[str, Tuple[str, ...]]:
    """(layer name, param names) the weight decay covers.

    Reference subtlety: ``Dense`` registers only its weights in
    ``self.vars`` (its layer-norm offset/scale are created inside
    MyLayerNorm without registration, gcn/layers.py:87-92,113-115), while
    AugmentedDropoutDense / DetDropoutFC register weights AND offset/scale
    (layers.py:153-158,376-381) — so the L2 term covers different sets
    depending on which layer type comes first."""
    for s in spec.specs:
        if isinstance(s, DenseSpec):
            return s.name, ("weights",)
        if isinstance(s, (AugDenseSpec, DetFCSpec)):
            names = ("weights", "offset", "scale") if s.norm \
                else ("weights",)
            return s.name, names
    raise ValueError("model has no parametric layers")


def init_histories(spec: ModelSpec, num_nodes: int, row_multiple: int = 8,
                   dtype=jnp.float32) -> Tuple[Tuple[jax.Array, ...], ...]:
    """Zero history buffers: per agg layer, 1 (or 2 for det_dropout) arrays
    of shape [>=N+1, d] (vrgcn.py:23-36 + sentinel row).

    Rows are padded up to a multiple of ``row_multiple`` so the buffers can
    be sharded along the node dimension across a device mesh; rows past the
    sentinel are never addressed (all ids <= N)."""
    if not spec.cv:
        return tuple()
    rows = -(-(num_nodes + 1) // row_multiple) * row_multiple
    return tuple(
        tuple(jnp.zeros((rows, d), dtype)
              for _ in range(spec.n_history_per_layer))
        for d in spec.history_dims)


# ----------------------------- forward ------------------------------------

def _slice_inputs(features, field0: jax.Array, mesh=None,
                  num_nodes: int = -1):
    """Gather the layer-0 field's feature rows (the functional form of the
    reference's host-side slice/dense_slice, gcn/vrgcn.py:39-47).

    With a mesh and node-sharded features the rows come from their owner
    chips (parallel/halo.py) instead of GSPMD's whole-table all-gather."""
    from ..parallel.halo import halo_tiles, row_gather, row_gather2
    if isinstance(features, PaddedSparseFeatures):
        if halo_tiles(features.idx, field0, mesh):
            idx, val = row_gather2(features.idx, features.val, field0, mesh,
                                   sentinel=num_nodes)
        else:
            idx, val = features.idx[field0], features.val[field0]
        return PaddedSparseFeatures(idx=idx, val=val, dim=features.dim)
    return row_gather(features, field0, mesh, sentinel=num_nodes)


def _tap(taps, label, h):
    """Per-layer activation moments (the reference's Layer._log_vars /
    Model.activations debugging surface, gcn/layers.py:111-137 +
    models.py:148-157 — histogram summaries there, (mean, std, absmax)
    here).  ``taps`` is a list the caller owns; None disables at trace
    time (zero cost on production paths)."""
    if taps is None:
        return
    import jax.numpy as _jnp
    # NOTE: hasattr(h, "val") is truthy on jit tracers — type-check instead
    x = h.val if isinstance(h, PaddedSparseFeatures) else h
    if isinstance(x, tuple):         # CVD (mu, var) pair: tap the mean
        x = x[0]
    x = x.astype(_jnp.float32)
    taps.append((label, _jnp.mean(x), _jnp.std(x),
                 _jnp.max(_jnp.abs(x))))


def forward(params: dict, spec: ModelSpec, pack: BatchFields,
            graph: Optional[PaddedGraph], histories, features,
            key: jax.Array, keep_prob: float, train: bool, mesh=None,
            taps=None, lazy=None):
    """Run the layer stack (gcn/models.py:147-159).

    Returns (logits [B, output_dim], new_histories) where new_histories[l]
    is a tuple of arrays on the rows of pack.fields[l], to be scattered into
    the history buffers at those node ids after the optimizer step.

    ``taps``: optional list; when given, (label, mean, std, absmax) of
    every layer output is appended — see :func:`_tap`.

    ``lazy``: epoch-frozen CV anchor under --lazy_fullterm — a pair
    ``(snapshot histories, a-bar tables)`` with the same per-layer
    structure as ``histories`` (see Config.lazy_fullterm); None = the
    reference's per-step full term.
    """
    kp = keep_prob if train else 1.0
    h = _slice_inputs(features, pack.fields[0], mesh,
                      num_nodes=graph.num_nodes if graph is not None else -1)
    if spec.reverse_input_dropout and train:
        # --reverse applies dropout directly to the sliced input features
        # (reference does this host-side: gcn/plaingcn.py:30-38)
        key, sub = jax.random.split(key)
        h = L.dropout(sub, h, kp)
    if isinstance(h, PaddedSparseFeatures) and not any(
            isinstance(s, (DenseSpec, AugDenseSpec, DetFCSpec)) and
            s.sparse_inputs for s in spec.specs):
        # no sparse-capable first layer (e.g. aggregator first): densify,
        # mirroring the reference's sparse_to_dense fallback
        # (gcn/models.py:128-133)
        dense = jnp.zeros((h.idx.shape[0], h.dim), jnp.float32)
        rows = jnp.arange(h.idx.shape[0])[:, None]
        safe = jnp.minimum(h.idx, h.dim - 1)
        dense = dense.at[rows, safe].add(h.val)
        h = dense

    _tap(taps, "input", h)
    new_histories = [None] * spec.num_agg_layers
    for i, s in enumerate(spec.specs):
        if isinstance(s, DropoutSpec):
            key, sub = jax.random.split(key)
            h = L.dropout_layer(sub, h, kp, spec.cvd)
        elif isinstance(s, DenseSpec):
            act = L.relu if s.relu else L.identity
            h = L.dense(params[s.name], h, act, s.norm)
        elif isinstance(s, AugDenseSpec):
            key, sub = jax.random.split(key)
            h = L.aug_dropout_dense(params[s.name], sub, h, kp, L.relu,
                                    s.norm)
        elif isinstance(s, DetFCSpec):
            h = L.det_dropout_fc(params[s.name], h, kp, s.norm)
        elif isinstance(s, AggSpec):
            l = s.index
            ls = pack.layers[l]
            if spec.cv:
                h, nh = agg.vr_aggregate(
                    h, ls, pack.fields[l], pack.fields[l + 1], graph,
                    histories[l], spec.cvd, spec.normalization, mesh=mesh,
                    lazy_l=None if lazy is None
                    else (lazy[0][l], lazy[1][l]))
                new_histories[l] = nh
            else:
                h = agg.plain_aggregate(h, ls, spec.normalization,
                                        mesh=mesh)
        _tap(taps, f"{i}:{type(s).__name__}", h)
    return h, tuple(new_histories)


# ------------------------- loss / metrics ---------------------------------

def loss_and_metrics(params: dict, spec: ModelSpec, logits: jax.Array,
                     labels: jax.Array, valid_mask: jax.Array,
                     weight_decay: float):
    """Loss (gcn/models.py:68-83) and accuracy (models.py:85-94), masked to
    real (non-sentinel-padded) batch rows.

    Weight decay: L2 (sum(w^2)/2, tf.nn.l2_loss semantics) over the first
    parametric layer's REGISTERED vars, matching models.py:71-75 — see
    :func:`weight_decay_param_names` for which params that covers.
    """
    first, names = weight_decay_param_names(spec)
    wd = sum(jnp.sum(jnp.square(params[first][n])) / 2.0 for n in names)
    loss = weight_decay * wd

    nvalid = jnp.maximum(jnp.sum(valid_mask), 1.0)
    if spec.multitask:
        ce = jnp.mean(
            jnp.maximum(logits, 0.0) - logits * labels
            + jnp.log1p(jnp.exp(-jnp.abs(logits))), axis=1)
        preds_ok = (logits > 0) == (labels > 0.5)
        acc_row = jnp.mean(preds_ok.astype(jnp.float32), axis=1)
    else:
        logp = jax.nn.log_softmax(logits, axis=1)
        ce = -jnp.sum(labels * logp, axis=1)
        acc_row = (jnp.argmax(logits, axis=1)
                   == jnp.argmax(labels, axis=1)).astype(jnp.float32)
    loss = loss + jnp.sum(ce * valid_mask) / nvalid
    accuracy = jnp.sum(acc_row * valid_mask) / nvalid
    return loss, accuracy


def predict(spec: ModelSpec, logits: jax.Array) -> jax.Array:
    """gcn/models.py:198-202."""
    if spec.multitask:
        return jax.nn.sigmoid(logits)
    return jax.nn.softmax(logits, axis=1)
