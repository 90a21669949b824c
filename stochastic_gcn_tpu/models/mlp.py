"""NeighbourMLP baseline: an MLP over precomputed multi-hop features.

Working re-design of the reference's (stale, unrunnable) gcn/mlp.py:
features are ``hstack(X, ÂX, Â²X, ..., Â^num_layers X)`` built once at setup
(mlp.py:35-44), then a ``num_fc_layers``-deep MLP with dropout before each
dense layer (mlp.py:72-97).  No graph sampling at train time — the batch
slices precomputed rows, which makes this the degenerate all-preprocessed
point of the estimator family.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..config import Config
from ..data.graph import dense_rows
from ..ops import layers as L


def multihop_features(feats, adj, num_hops: int):
    """hstack(X, ÂX, ..., Â^num_hops X) (mlp.py:35-42)."""
    out = [feats]
    for _ in range(num_hops):
        out.append(adj.dot(out[-1]))
    if sp.issparse(feats):
        return sp.hstack(out).tocsr()
    return np.hstack([np.asarray(x) for x in out])


def build_mlp_spec(cfg: Config, input_dim: int, output_dim: int):
    """Layer dims for the MLP stack (mlp.py:72-97): num_fc_layers total,
    hidden1 wide, final layer linear without norm."""
    dims = []
    n = cfg.num_fc_layers
    for l in range(n):
        in_dim = input_dim if l == 0 else cfg.hidden1
        out_dim = output_dim if l + 1 == n else cfg.hidden1
        last = l + 1 == n
        dims.append((f"dense{l}", in_dim, out_dim,
                     (not last), (cfg.layer_norm and not last)))
    return tuple(dims)


def init_mlp_params(key: jax.Array, spec) -> dict:
    params = {}
    for name, in_dim, out_dim, _relu, norm in spec:
        key, sub = jax.random.split(key)
        params[name] = L.init_dense(sub, in_dim, out_dim, norm)
    return params


def mlp_forward(params: dict, spec, x, key: jax.Array, keep_prob: float,
                train: bool):
    kp = keep_prob if train else 1.0
    h = x
    for name, _in, _out, relu, norm in spec:
        key, sub = jax.random.split(key)
        h = L.dropout(sub, h, kp)
        h = L.dense(params[name], h, L.relu if relu else L.identity, norm)
    return h


class MLPTrainer:
    """Minimal trainer for model='mlp' (reference train flag --model,
    train.py:26); batches slice rows of the multi-hop feature matrix."""

    def __init__(self, cfg: Config, ds):
        import optax
        self.cfg = cfg
        self.ds = ds
        feats_mh = multihop_features(ds.feats, ds.full_adj, cfg.num_layers)
        self.features = dense_rows(feats_mh, ds.num_data)
        self.labels = dense_rows(ds.labels, ds.num_data)
        self.spec = build_mlp_spec(cfg, feats_mh.shape[1], ds.num_classes)
        key = jax.random.PRNGKey(cfg.seed)
        self.key, init_key = jax.random.split(key)
        self.params = init_mlp_params(init_key, self.spec)
        self.tx = optax.adam(cfg.learning_rate, b1=cfg.beta1, b2=cfg.beta2,
                             eps=1e-8)
        self.opt_state = self.tx.init(self.params)
        self.multitask = cfg.multitask
        n = ds.num_data
        spec = self.spec
        features = self.features
        labels = self.labels
        mt = self.multitask
        wd = cfg.weight_decay
        kp = cfg.keep_prob

        def loss_fn(params, x, y, valid, key, train):
            logits = mlp_forward(params, spec, x, key, kp, train)
            # L2 covers only the first Dense 'weights' — the reference's
            # Dense never registers offset/scale in .vars (gcn/models.py:69,
            # gcn/layers.py:100-138), so layer-norm params are not decayed
            first = spec[0][0]
            l2 = jnp.sum(jnp.square(params[first]["weights"])) / 2.0
            nv = jnp.maximum(jnp.sum(valid), 1.0)
            if mt:
                ce = jnp.mean(jnp.maximum(logits, 0) - logits * y
                              + jnp.log1p(jnp.exp(-jnp.abs(logits))), axis=1)
                acc = jnp.mean(((logits > 0) == (y > 0.5))
                               .astype(jnp.float32), axis=1)
            else:
                ce = -jnp.sum(y * jax.nn.log_softmax(logits, 1), axis=1)
                acc = (logits.argmax(1) == y.argmax(1)).astype(jnp.float32)
            return (wd * l2 + jnp.sum(ce * valid) / nv,
                    (jnp.sum(acc * valid) / nv, logits))

        @jax.jit
        def train_step(params, opt_state, feats_d, labels_d, batch, key):
            x = jnp.take(feats_d, batch, axis=0)
            y = jnp.take(labels_d, batch, axis=0)
            valid = (batch < n).astype(jnp.float32)
            (loss, (acc, _)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, x, y, valid, key, True)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss, acc

        @jax.jit
        def eval_step(params, feats_d, labels_d, batch, key):
            x = jnp.take(feats_d, batch, axis=0)
            y = jnp.take(labels_d, batch, axis=0)
            valid = (batch < n).astype(jnp.float32)
            loss, (acc, logits) = loss_fn(params, x, y, valid, key, False)
            pred = jax.nn.sigmoid(logits) if mt \
                else jax.nn.softmax(logits, 1)
            return loss, acc, pred

        self._train_step = train_step
        self._eval_step = eval_step

    def features_dev(self):
        return self.features

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def train_epoch(self):
        from ..sampler.scheduler import MinibatchIterator
        cfg, n = self.cfg, self.ds.num_data
        rng = np.random.default_rng(int(jax.random.randint(
            self._next_key(), (), 0, 2**31 - 1)))
        ids = np.array(self.ds.train_d, np.int32)
        rng.shuffle(ids)
        loss = acc = 0.0
        for s in range(0, len(ids), cfg.batch_size):
            batch = MinibatchIterator.pad_batch(
                ids[s:s + cfg.batch_size], cfg.batch_size, n)
            self.params, self.opt_state, loss, acc = self._train_step(
                self.params, self.opt_state, self.features, self.labels,
                jnp.asarray(batch), self._next_key())
        return float(loss), float(acc)

    def evaluate(self, data_ids):
        from ..sampler.scheduler import MinibatchIterator
        from ..utils.metrics import calc_f1
        cfg, n = self.cfg, self.ds.num_data
        data_ids = np.asarray(data_ids, np.int32)
        preds = []
        tot_loss = tot_acc = 0.0
        for s in range(0, len(data_ids), cfg.test_batch_size):
            chunk = data_ids[s:s + cfg.test_batch_size]
            batch = MinibatchIterator.pad_batch(chunk, cfg.test_batch_size, n)
            loss, acc, pred = self._eval_step(
                self.params, self.features, self.labels, jnp.asarray(batch),
                self._next_key())
            tot_loss += float(loss) * len(chunk)
            tot_acc += float(acc) * len(chunk)
            preds.append(np.asarray(pred)[:len(chunk)])
        micro, macro = calc_f1(np.vstack(preds), self.ds.labels[data_ids],
                               self.multitask)
        return (tot_loss / len(data_ids), tot_acc / len(data_ids),
                micro, macro)
