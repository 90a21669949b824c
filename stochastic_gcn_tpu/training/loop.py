"""High-level Trainer: the functional equivalent of gcn/train.py's driver.

Owns the device-resident data (graphs, features, labels, histories), the
shared parameters, and the compiled train/eval steps; exposes ``sgd_train``,
``evaluate``, ``test`` and ``gradient_variance`` mirroring SGDTrain
(train.py:170-238), evaluate (133-160), Test (320-329) and GradientVariance
(241-277).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..config import Config
from ..data.graph import (Dataset, dense_rows, flat_csr, pad_csr,
                          pad_sparse_features)
from ..data.preprocess import cap_adj_degree
from ..models import gcn as M
from ..sampler.scheduler import MinibatchIterator, compute_importance
from ..utils.metrics import f1_from_counts
from . import step as S
from .checkpoint import (AsyncCheckpointer, load_checkpoint,
                         load_loop_extras, save_checkpoint)


def assemble_input_features(cfg: Config, feats, nbr_feats, preprocess: bool):
    """Input feature assembly (gcn/models.py:234-241): under PP the model
    consumes [X_self ‖ ÂX] (graphsage) or ÂX alone (gcn, self_dim=0)."""
    sparse_input = sp.issparse(feats)
    if preprocess and cfg.pp_nbr:
        self_dim = 0 if cfg.normalization == "gcn" else feats.shape[1]
        if sparse_input:
            out = sp.hstack((feats[:, :self_dim], nbr_feats)).tocsr()
        else:
            out = np.hstack((feats[:, :self_dim], np.asarray(nbr_feats)))
    else:
        out = feats
    return out, sparse_input


def to_device_features(cfg: Config, feats, num_nodes: int):
    dtype = jnp.dtype(cfg.features_dtype)
    if sp.issparse(feats):
        if cfg.dense_input:
            return dense_rows(feats, num_nodes, dtype=dtype)
        pf = pad_sparse_features(feats, cfg.feat_nnz_cap, num_nodes)
        if pf.val.dtype != dtype:
            pf = dataclasses.replace(pf, val=pf.val.astype(dtype))
        return pf
    return dense_rows(np.asarray(feats, np.float32), num_nodes,
                      dtype=dtype)


class Trainer:
    def __init__(self, cfg: Config, ds: Dataset):
        if cfg.det_dropout and (cfg.importance or cfg.test_importance):
            # the IS path produces no cross-term (madj) weights — the
            # reference's importance sampler doesn't either
            # (scheduler.cpp:63-122 emits no medg_w before returning)
            raise ValueError(
                "--det_dropout is incompatible with --importance")
        if cfg.partition_nodes != "none":
            # locality-improving node relabeling so contiguous-block
            # row-sharding keeps most receptive-field rows on their batch
            # node's owner chip (pairs with --owner_batching); pure
            # permutation — semantics unchanged.  The relabeling is an
            # INTERNAL layout detail: every public id surface (evaluate,
            # the ds.*_d splits, gradient_variance) stays in the caller's
            # ORIGINAL id space and is mapped at entry via _to_internal.
            import dataclasses as _dc
            from ..data.preprocess import locality_permutation, \
                relabel_dataset
            self.node_perm = locality_permutation(ds.full_adj,
                                                  cfg.partition_nodes)
            self._id_to_internal = np.empty(ds.num_data, np.int32)
            self._id_to_internal[self.node_perm] = np.arange(
                ds.num_data, dtype=np.int32)
            orig_splits = (ds.train_d, ds.val_d, ds.test_d)
            ds = relabel_dataset(ds, self.node_perm)
            ds = _dc.replace(ds, train_d=orig_splits[0],
                             val_d=orig_splits[1], test_d=orig_splits[2])
        else:
            self.node_perm = None
            self._id_to_internal = None
        self.cfg = cfg
        self.ds = ds
        n = ds.num_data

        train_adj, full_adj = ds.train_adj, ds.full_adj
        test_feats_pp = ds.test_feats
        if cfg.gradvar:
            # analyze mode aliases the eval graph to the train graph
            # (train.py:76-79)
            full_adj = train_adj.copy()
            test_feats_pp = ds.train_feats.copy() if sp.issparse(ds.train_feats) \
                else np.array(ds.train_feats)

        if cfg.pad_degree != -1:
            train_adj = cap_adj_degree(train_adj, cfg.pad_degree, cfg.seed)
            full_adj = cap_adj_degree(full_adj, cfg.pad_degree, cfg.seed)
        if cfg.graph_format == "edgelist":
            # flat-CSR layout: O(E) storage, per-batch edge enumeration for
            # the CV full-neighborhood term (power-law graphs)
            # node-shard the block tables over the data axis when a mesh
            # will be built (per-chip graph HBM ~O(E/P), window block
            # reads owner-routed — parallel/halo.py)
            parts = cfg.dp if (cfg.dp > 1 and cfg.shard_graph) else 1
            self.graph_train = flat_csr(train_adj, cfg.fadj_edge_mult,
                                        parts=parts, tier=cfg.fadj_tier,
                                        tier_w=cfg.fadj_tier_w)
            self.graph_full = flat_csr(full_adj, cfg.fadj_edge_mult,
                                       parts=parts, tier=cfg.fadj_tier,
                                       tier_w=cfg.fadj_tier_w)
        else:
            # pad each graph to its own true (post-cap) max degree: the
            # full-neighborhood gather is row-issue-rate bound, so tighter
            # padding directly cuts the CV step's dominant cost
            self.graph_train = pad_csr(train_adj, -1, tier=cfg.fadj_tier,
                                       tier_w=cfg.fadj_tier_w)
            self.graph_full = pad_csr(full_adj, -1, tier=cfg.fadj_tier,
                                      tier_w=cfg.fadj_tier_w)

        # model specs: shared params, different estimator wiring
        # (train.py:107-119)
        in_dim = ds.feature_dim
        out_dim = ds.num_classes
        tr_feats, tr_sparse = assemble_input_features(
            cfg, ds.feats, ds.train_feats, cfg.preprocess)
        te_feats, te_sparse = assemble_input_features(
            cfg, ds.feats, test_feats_pp, cfg.test_preprocess)
        self.train_spec = M.build_model_spec(
            cfg, in_dim, out_dim, cfg.preprocess, cfg.cv, cfg.cvd, tr_sparse)
        test_cfg = cfg.replace(importance=cfg.test_importance)
        self.test_spec = M.build_model_spec(
            test_cfg, in_dim, out_dim, cfg.test_preprocess, cfg.test_cv,
            cfg.test_cvd, te_sparse)

        self.train_features = to_device_features(cfg, tr_feats, n)
        self.test_features = to_device_features(cfg, te_feats, n)
        self.labels = dense_rows(ds.labels, n)

        self.train_degrees = tuple([cfg.degree] * self.train_spec
                                   .num_agg_layers)
        self.test_degrees = tuple([cfg.test_degree] * self.test_spec
                                  .num_agg_layers)

        self.importance_train = compute_importance(self.graph_train) \
            if cfg.importance else jnp.zeros((n + 1,), jnp.float32)
        self.importance_test = compute_importance(self.graph_full) \
            if cfg.test_importance else jnp.zeros((n + 1,), jnp.float32)
        # the reference's one runtime data guard: corrupt edge weights
        # must fail loudly at build, not sample garbage silently
        # (scheduler.cpp:114-115 throws on NaN importance weight) —
        # checked on the edge-weight tables themselves so the guard also
        # fires without --importance
        for nm, g in (("train", self.graph_train),
                      ("test/full", self.graph_full)):
            if not bool(jnp.isfinite(g.w).all()):
                raise ValueError(
                    f"non-finite edge weights in the {nm} graph "
                    "(reference scheduler.cpp:114-115 guard)")

        key = jax.random.PRNGKey(cfg.seed)
        self.key, init_key = jax.random.split(key)
        self.state = S.init_train_state(init_key, cfg, self.train_spec, n)
        # incremental-refresh bookkeeping for predict(): bumped on every
        # weight change; eval histories are converged for exactly one value
        self._params_version = 0
        self._hist_fresh_version = -1
        # eval-side history is SEPARATE from train-side, as in the reference
        # (tf.Variable outside make_template; train.py:174)
        self.eval_histories = M.init_histories(
            self.test_spec, n, max(8, cfg.dp),
            jnp.dtype(cfg.test_history_dtype))

        self._train_step = S.make_train_step(cfg, self.train_spec,
                                             self.train_degrees, n)
        self._eval_step = S.make_eval_step(cfg, self.test_spec,
                                           self.test_degrees, n)
        if cfg.dp > 1 or cfg.tp > 1:
            # data-parallel epoch runners over a ('data',) mesh (2-D
            # ('data', 'model') with --tp): batch sharded, history rows
            # sharded along the node dimension (columns over 'model'),
            # params replicated over 'data' with GSPMD gradient
            # all-reduce (hidden-dim sharded over 'model')
            from ..data.graph import pad_features_rows, pad_graph_rows
            from ..data.graph import pad_table_rows, PaddedGraph
            from ..parallel.mesh import (data_shardings, make_mesh,
                                         make_sharded_eval_epoch,
                                         make_sharded_train_epoch,
                                         state_shardings)
            if cfg.batch_size % cfg.dp or cfg.test_batch_size % cfg.dp:
                raise ValueError("batch sizes must divide --dp")
            self.mesh = make_mesh(cfg.dp, hosts=cfg.dp_hosts,
                                  tp=cfg.tp)
            if cfg.shard_graph:
                # row-pad every O(N) table so it tiles over the mesh, then
                # shard it along the node dimension — per-device memory
                # scales as N/P; edgelist graphs stay
                # replicated (O(E)-compact, 1-D arrays)
                if isinstance(self.graph_train, PaddedGraph):
                    self.graph_train = pad_graph_rows(self.graph_train,
                                                      cfg.dp)
                    self.graph_full = pad_graph_rows(self.graph_full,
                                                     cfg.dp)
                self.train_features = pad_features_rows(self.train_features,
                                                        cfg.dp)
                self.test_features = pad_features_rows(self.test_features,
                                                       cfg.dp)
                self.labels = pad_table_rows(self.labels, cfg.dp)
            train_data = (self.graph_train, self.train_features,
                          self.labels)
            eval_data = (self.graph_full, self.test_features, self.labels)
            self._train_epoch = make_sharded_train_epoch(
                cfg, self.train_spec, self.train_degrees, n, self.mesh,
                state_template=self.state, shard_history=True,
                data_template=train_data, shard_graph=cfg.shard_graph)
            self._eval_epoch = make_sharded_eval_epoch(
                cfg, self.test_spec, self.test_degrees, n, self.mesh,
                hist_template=self.eval_histories, shard_history=True,
                data_template=eval_data, shard_graph=cfg.shard_graph,
                params_template=self.state.params)
            self.state = jax.device_put(
                self.state, state_shardings(self.mesh, self.state, True))
            if cfg.shard_graph:
                # commit the tables to their row shardings once up front
                (self.graph_train, self.train_features,
                 self.labels) = jax.device_put(
                    train_data,
                    data_shardings(self.mesh, train_data, True))
                self.graph_full, self.test_features, _ = jax.device_put(
                    eval_data,
                    data_shardings(self.mesh, eval_data, True))
        else:
            self.mesh = None
            self._train_epoch = S.make_train_epoch(cfg, self.train_spec,
                                                   self.train_degrees, n)
            self._eval_epoch = S.make_eval_epoch(cfg, self.test_spec,
                                                 self.test_degrees, n)
        self.train_iter = MinibatchIterator(
            self._to_internal(ds.train_d), cfg.batch_size, n, cfg.seed)
        self.cost_val: list[float] = []
        self.amt_data = 0
        self.completed_epochs = 0     # checkpointed for --resume
        self.stop_requested = False   # preemption: finish epoch, save, exit
        self.epoch_stats = {}
        self._async_ckpt = None       # lazily-built AsyncCheckpointer

    # ------------------------------------------------------------------
    @property
    def truncated_edges_frac(self) -> float:
        """Fraction of full-neighborhood edges the edgelist per-row budget
        drops (max over train/eval graphs; 0.0 for padded graphs, which
        are lossless).  Surfaced in bench/validation artifacts so a lossy
        CV full term is visible in the driver record, not only in the
        flat_csr UserWarning."""
        return max(getattr(self.graph_train, "truncated_frac", 0.0),
                   getattr(self.graph_full, "truncated_frac", 0.0))

    def _eval_params(self):
        """Weights used for evaluation: the Polyak/EMA average when enabled
        (the working version of the reference's dormant backup_model/
        restore_model swap, gcn/models.py:104-121), raw weights otherwise."""
        if self.cfg.polyak_decay > 0 and self.state.avg_params is not None:
            return self.state.avg_params
        return self.state.params

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _to_internal(self, ids):
        """Map caller-space node ids to the internal (relabeled) id space
        (identity without --partition_nodes).  All public id surfaces —
        evaluate, the ds.*_d splits, gradient_variance — speak ORIGINAL
        ids; the permutation is a private multi-chip layout detail."""
        if self._id_to_internal is None:
            return ids
        return self._id_to_internal[np.asarray(ids, np.int64)]

    @staticmethod
    def _batch_matrix(ids, batch_size: int, num_nodes: int):
        """[S, B] sentinel-padded batch-id matrix for the epoch scan."""
        ids = np.asarray(ids, np.int32)
        s = max(1, -(-len(ids) // batch_size))
        out = np.full((s * batch_size,), num_nodes, np.int32)
        out[:len(ids)] = ids
        return out.reshape(s, batch_size)

    def _epoch_matrix(self, ids, batch_size: int):
        """Epoch batch matrix; partition-aware slot assignment under
        --owner_batching (parallel/mesh.py::owner_grouped_batch_matrix)."""
        if self.cfg.owner_batching and self.mesh is not None:
            from ..parallel.mesh import owner_grouped_batch_matrix
            return owner_grouped_batch_matrix(ids, batch_size,
                                              self.ds.num_data, self.cfg.dp)
        return self._batch_matrix(ids, batch_size, self.ds.num_data)

    def _profile_this(self, epoch_1based: int) -> bool:
        """--profile_dir: trace the epochs listed in --profile_epochs
        (1-based, comma-separated) with jax.profiler (Config.profile_dir)."""
        cfg = self.cfg
        if not cfg.profile_dir:
            return False
        try:
            wanted = {int(e) for e in str(cfg.profile_epochs).split(",")
                      if str(e).strip()}
        except ValueError:
            return False
        return epoch_1based in wanted

    def train_epoch(self):
        """One epoch as a single on-device scan (train.py:181-209 role).

        Loss/accuracy reported are the LAST minibatch's, matching the
        reference's window-1 Averager (train.py:167-168,208-209)."""
        cfg = self.cfg
        self.train_iter.shuffle()
        t0 = time.time()
        bm = self._epoch_matrix(self.train_iter.data, cfg.batch_size)
        self.state, metrics = self._train_epoch(
            self.state, self.graph_train, self.train_features, self.labels,
            self.importance_train, jnp.asarray(bm), self._next_key())
        self._params_version += 1
        loss = float(metrics["loss"])
        acc = float(metrics["accuracy"])
        # CUMULATIVE over the whole run (reference vrgcn.py:62 `+=`,
        # models.py:347 init-once): the data-budget stop and the epoch
        # log's `data =` column both read the running total
        amt_steps = metrics.get("amt_steps")
        if amt_steps is not None:   # int64 host sum — int32 epoch totals
            self.amt_data += int(np.asarray(amt_steps)
                                 .astype(np.int64).sum())
        else:
            self.amt_data += int(metrics["amt_data"])
        self._record_epoch_stats(metrics, time.time() - t0)
        return loss, acc, time.time() - t0, bm.shape[0]

    def _record_epoch_stats(self, metrics, run_t: float):
        """FLOP/size accounting per epoch (gcn/vrgcn.py:50-69): sparse ops
        g_ops = (adj + fadj nnz) * dim * 4, dense ops nn_ops =
        sum(layer_comp * field size) * 4, each doubled under cvd."""
        spec = self.train_spec
        field_sizes = np.asarray(metrics["field_sizes"])
        adj_sizes = np.asarray(metrics["adj_sizes"])
        fadj_sizes = np.asarray(metrics["fadj_sizes"])
        mult = 2 if spec.cvd else 1
        g_ops = 0.0
        for l in range(spec.num_agg_layers):
            dim = spec.agg0_dim if l == 0 else self.cfg.hidden1
            g_ops += float(adj_sizes[l] + fadj_sizes[l]) * dim * 4 * mult
        nn_ops = sum(comp * float(field_sizes[idx]) * 4 * mult
                     for comp, idx in spec.layer_comp)
        self.epoch_stats = dict(run_t=run_t, g_t=0.0, g_ops=g_ops,
                                nn_ops=nn_ops, field_sizes=field_sizes,
                                adj_sizes=adj_sizes, fadj_sizes=fadj_sizes)

    def evaluate(self, data_ids):
        """Batched evaluation as one on-device scan (train.py:133-160).
        Stateful when test_cv: every pass refreshes the eval-side history."""
        cfg = self.cfg
        t0 = time.time()
        n = self.ds.num_data
        data_ids = np.asarray(self._to_internal(data_ids), np.int32)
        bm = self._epoch_matrix(data_ids, cfg.test_batch_size)
        self.eval_histories, out = self._eval_epoch(
            self._eval_params(), self.eval_histories, self.graph_full,
            self.test_features, self.labels, self.importance_test,
            jnp.asarray(bm), self._next_key())
        nvalid = np.asarray(out["nvalid"])          # true rows per batch
        losses = np.asarray(out["losses"])
        accs = np.asarray(out["accs"])
        total_loss = float((losses * nvalid).sum() / len(data_ids))
        total_acc = float((accs * nvalid).sum() / len(data_ids))
        micro, macro = f1_from_counts(out["tp"], out["fp"], out["fn"],
                                      self.cfg.multitask)
        return total_loss, total_acc, micro, macro, time.time() - t0

    def _get_predict_epoch(self):
        """Lazily-built variant of the eval epoch that also stacks the
        per-node class probabilities (training/step.py::build_eval_epoch
        with_preds) — only inference pays the [S, B, C] device->host
        fetch."""
        if getattr(self, "_predict_epoch", None) is None:
            cfg, n = self.cfg, self.ds.num_data
            if self.mesh is not None:
                from ..parallel.mesh import make_sharded_eval_epoch
                eval_data = (self.graph_full, self.test_features,
                             self.labels)
                self._predict_epoch = make_sharded_eval_epoch(
                    cfg, self.test_spec, self.test_degrees, n, self.mesh,
                    hist_template=self.eval_histories, shard_history=True,
                    data_template=eval_data, shard_graph=cfg.shard_graph,
                    params_template=self.state.params, with_preds=True)
            else:
                self._predict_epoch = S.make_eval_epoch(
                    cfg, self.test_spec, self.test_degrees, n,
                    with_preds=True)
        return self._predict_epoch

    def predict(self, data_ids, refresh: bool = True):
        """Per-node class probabilities for ``data_ids`` — the
        inference/serving surface.  Returns [len(ids), num_classes]
        float32 in the CALLER's id order (original id space).

        The reference exposes predictions only implicitly (pred out of
        run_one_step, gcn/vrgcn.py:79-84, vstacked inside evaluate,
        train.py:150-156); this is the standalone equivalent.  With
        ``refresh`` and a CV eval model, first runs ``num_layers`` full
        passes over every node so the eval-side history converges and the
        returned values equal exact inference — the Test protocol
        (train.py:339-341), the predict pass itself being pass L+1.

        The refresh is INCREMENTAL: histories converged under the current
        weights stay converged (re-evaluating the fixed point reproduces
        it), so repeated serving calls pay the ``num_layers`` full passes
        once per weight change, not once per call (pass
        ``refresh="force"`` to override, e.g. after mutating
        ``eval_histories`` by hand).
        """
        cfg = self.cfg
        n = self.ds.num_data
        stale = (refresh == "force"
                 or self._hist_fresh_version != self._params_version)
        if refresh and cfg.test_cv and stale:
            all_ids = np.arange(n, dtype=np.int32)
            for _ in range(cfg.num_layers):
                self.evaluate(all_ids)
            self._hist_fresh_version = self._params_version
        ids = np.asarray(data_ids, np.int64)
        internal = np.asarray(self._to_internal(ids), np.int32)
        # order-preserving batch layout (predict reassembles by id, so the
        # owner-grouped layout would also work — but there is no reason to
        # stratify an inference batch)
        bm = self._batch_matrix(internal, cfg.test_batch_size, n)
        fn = self._get_predict_epoch()
        self.eval_histories, out = fn(
            self._eval_params(), self.eval_histories, self.graph_full,
            self.test_features, self.labels, self.importance_test,
            jnp.asarray(bm), self._next_key())
        preds = np.asarray(out["preds"])
        preds = preds.reshape(-1, preds.shape[-1])
        fields = np.asarray(out["fields"]).reshape(-1)
        # reassemble by internal node id — robust to any field-slot layout
        # (sentinel-padded rows have field id == n and are skipped)
        by_id = np.zeros((n + 1, preds.shape[1]), np.float32)
        valid = fields < n
        by_id[fields[valid]] = preds[valid]
        return by_id[internal]

    def sgd_train(self, log=print, max_epochs: Optional[int] = None):
        """SGDTrain (train.py:170-238): epoch loop + validation + early
        stopping on the trailing-window validation loss."""
        cfg = self.cfg
        if cfg.load and not cfg.resume:
            self.load()
            return
        start_epoch = self._try_resume(log) if cfg.resume else 0
        try:
            self._sgd_epoch_loop(cfg, start_epoch, max_epochs, log)
        finally:
            # once training has left the loop, SIGTERM should kill the
            # process again (a forever-installed flag-setter
            # silently swallows signals after the first stop)
            self._restore_preemption_handlers()
        log("Optimization Finished!")
        self.save()
        # the final snapshot must be durable before control returns (an
        # exiting process would orphan the daemon writer thread)
        self.finish_checkpoints()

    def _sgd_epoch_loop(self, cfg, start_epoch, max_epochs, log):
        for epoch in range(start_epoch,
                           max_epochs if max_epochs is not None
                           else 100000000):
            if self._profile_this(epoch + 1):
                import jax.profiler
                with jax.profiler.trace(cfg.profile_dir):
                    train_loss, train_acc, ttime, _ = self.train_epoch()
                log(f"profiler trace of epoch {epoch + 1} written to "
                    f"{cfg.profile_dir}")
            else:
                train_loss, train_acc, ttime, _ = self.train_epoch()
            cost, acc, micro, macro, duration = self.evaluate(self.ds.val_d)
            self.cost_val.append(cost)
            self.completed_epochs = epoch + 1
            log(f"Epoch: {epoch + 1:04d} "
                f"train_loss= {train_loss:.5f} train_acc= {train_acc:.5f} "
                f"val_loss= {cost:.5f} val_acc= {acc:.5f} "
                f"mi F1={micro:.5f} ma F1={macro:.5f}  "
                f"time= {ttime:.5f} ttime= {duration:.5f} "
                f"data = {self.amt_data}")
            if self.epoch_stats:
                es = self.epoch_stats
                g = float(2 ** 30)
                log(f"TF time = {es['run_t']}, g time = {es['g_t']}, "
                    f"G GFLOPS = {es['g_ops'] / g}, "
                    f"NN GFLOPS = {es['nn_ops'] / g}, "
                    f"field sizes = {es['field_sizes']}, "
                    f"adj sizes = {es['adj_sizes']}, "
                    f"fadj sizes = {es['fadj_sizes']}")
            if cfg.ckpt_every and (epoch + 1) % cfg.ckpt_every == 0:
                self.save()
            # preemption notice (install_preemption_handler): leave the
            # loop at the epoch boundary.  Under multi-controller launches
            # the flag is max-reduced so every process takes the SAME
            # branch — SIGTERM delivery races the boundary check, and a
            # split decision would deadlock the final save's shard gathers
            # against another process's next-epoch all-reduce.
            from ..parallel.distributed import allreduce_flag
            if allreduce_flag(self.stop_requested):
                self.stop_requested = True   # propagate to late receivers
                log(f"Preemption stop after epoch {epoch + 1}; "
                    "checkpointing for --resume...")
                break
            if (epoch > cfg.early_stopping and
                    self.cost_val[-1] > np.mean(
                        self.cost_val[-(cfg.early_stopping + 1):-1])):
                log("Early stopping...")
                break
            # reference stop: 0-based epoch > FLAGS.epochs (train.py:234)
            if self.amt_data >= cfg.data and epoch > cfg.epochs:
                break

    def test(self, log=print):
        """Test (train.py:320-329); with test_cv the caller should invoke
        this num_layers+1 times so CV inference converges to exact
        (train.py:339-341)."""
        res = self.evaluate(self.ds.test_d)
        test_cost, test_acc, micro, macro, dur = res
        log(f"Test set results: cost= {test_cost:.5f} "
            f"accuracy= {test_acc:.5f} mi F1={micro:.5f} ma F1={macro:.5f}  "
            f"time= {dur:.5f}")
        if self.cfg.test_cv:
            remaining = np.array(sorted(
                set(range(self.ds.num_data)) - set(self.ds.test_d.tolist())),
                dtype=np.int32)
            if len(remaining):
                self.evaluate(remaining)
        return test_acc, micro, macro

    def run_tests(self, log=print):
        num_runs = self.cfg.num_layers + 1 if self.cfg.test_cv else 1
        out = None
        for _ in range(num_runs):
            out = self.test(log)
        return out

    # ------------------------------------------------------------------
    def activation_stats(self, data_ids=None, train: bool = True):
        """Per-layer activation (mean, std, absmax) on one batch — the
        moment-propagation debugging surface (reference
        gcn/layers.py:111-137 TF histogram summaries + models.py:148-157
        ``self.activations``; its Analyze2 consumer is dead code there,
        so this ships as a standalone probe).  ``train`` selects the
        training model/histories (with dropout) vs the eval model.
        Returns ``{layer_label: {"mean", "std", "absmax"}}`` floats."""
        cfg = self.cfg
        n = self.ds.num_data
        if data_ids is None:
            data_ids = self.ds.train_d[:cfg.batch_size] if train \
                else self.ds.val_d[:cfg.test_batch_size]
        bsz = cfg.batch_size if train else cfg.test_batch_size
        batch = jnp.asarray(MinibatchIterator.pad_batch(
            self._to_internal(np.asarray(data_ids)[:bsz]), bsz, n))
        if train:
            fn = S.make_activation_taps(cfg, self.train_spec,
                                        self.train_degrees, n, True)
            out = fn(self.state.params, self.state.histories,
                     self.graph_train, self.train_features, self.labels,
                     self.importance_train, batch, self._next_key())
        else:
            fn = S.make_activation_taps(cfg, self.test_spec,
                                        self.test_degrees, n, False)
            out = fn(self._eval_params(), self.eval_histories,
                     self.graph_full, self.test_features, self.labels,
                     self.importance_test, batch, self._next_key())
        return {k: {"mean": float(m), "std": float(s), "absmax": float(a)}
                for k, (m, s, a) in out.items()}

    def gradient_variance(self, times: int = 1000, log=print):
        """GradientVariance (train.py:241-277): bias/stdev of predictions and
        first-layer gradients, exact-vs-sampled, over repeated resamples."""
        from ..utils.metrics import Stat
        cfg = self.cfg
        n = self.ds.num_data
        ids = self._to_internal(self.ds.train_d[:cfg.batch_size])
        if self.mesh is not None and cfg.owner_batching:
            # the dp training step sees owner-stratified batches; the
            # bias instrument must measure through the same layout
            from ..parallel.mesh import owner_grouped_batch_matrix
            batch = owner_grouped_batch_matrix(
                np.asarray(ids, np.int32), cfg.batch_size, n, cfg.dp)[0]
        else:
            batch = MinibatchIterator.pad_batch(ids, cfg.batch_size, n)
        batch = jnp.asarray(batch)

        if self.mesh is not None:
            # run the instrument through the SHARDED lowering — the same
            # node-sharded tables / halo transports / owner-aligned
            # fields as dp training
            from ..parallel.mesh import make_sharded_pred_and_grad
            eval_data = (self.graph_full, self.test_features, self.labels)
            train_data = (self.graph_train, self.train_features,
                          self.labels)
            full_fn = make_sharded_pred_and_grad(
                cfg, self.test_spec, self.test_degrees, n, self.mesh,
                train_mode=False, hist_template=self.eval_histories,
                shard_history=True, data_template=eval_data,
                shard_graph=cfg.shard_graph,
                params_template=self.state.params)
            part_fn = make_sharded_pred_and_grad(
                cfg, self.train_spec, self.train_degrees, n, self.mesh,
                train_mode=True, hist_template=self.state.histories,
                shard_history=True, data_template=train_data,
                shard_graph=cfg.shard_graph,
                params_template=self.state.params)
        else:
            full_fn = S.make_pred_and_grad(cfg, self.test_spec,
                                           self.test_degrees, n, False)
            part_fn = S.make_pred_and_grad(cfg, self.train_spec,
                                           self.train_degrees, n, True)

        full_preds, full_grads = Stat(), Stat()
        for _ in range(times):
            p, g = full_fn(self.state.params, self.eval_histories,
                           self.graph_full, self.test_features, self.labels,
                           self.importance_test, batch, self._next_key())
            full_preds.add(p)
            full_grads.add(g)
        fp_m = np.mean(np.abs(full_preds.mean()))
        fg_m = np.mean(np.abs(full_grads.mean()))
        log(f"Full pred stdev = {np.mean(full_preds.std()) / fp_m}")
        log(f"Full grad stdev = {np.mean(full_grads.std()) / fg_m}")

        part_preds, part_grads = Stat(), Stat()
        for _ in range(times):
            p, g = part_fn(self.state.params, self.state.histories,
                           self.graph_train, self.train_features,
                           self.labels, self.importance_train, batch,
                           self._next_key())
            part_preds.add(p)
            part_grads.add(g)
        pred_bias = np.mean(np.abs(part_preds.mean()
                                   - full_preds.mean())) / fp_m
        grad_bias = np.mean(np.abs(full_grads.mean()
                                   - part_grads.mean())) / fg_m
        log(f"Part pred bias = {pred_bias}")
        log(f"Part pred stdev = {np.mean(part_preds.std()) / fp_m}")
        log(f"Part grad bias = {grad_bias}")
        log(f"Part grad stdev = {np.mean(part_grads.std()) / fg_m}")
        return dict(pred_bias=pred_bias, grad_bias=grad_bias,
                    pred_stdev=np.mean(part_preds.std()) / fp_m,
                    grad_stdev=np.mean(part_grads.std()) / fg_m,
                    full_pred_stdev=np.mean(full_preds.std()) / fp_m,
                    full_grad_stdev=np.mean(full_grads.std()) / fg_m)

    # ------------------------------------------------------------------
    def save(self):
        # multi-controller: sharded leaves are gathered over the host
        # network inside save_checkpoint; process 0 writes (shared
        # filesystem assumed).
        # Loop counters ride along for --resume; plain --load ignores them.
        extra = {"completed_epochs": np.int64(self.completed_epochs),
                 "amt_data": np.int64(self.amt_data),
                 "cost_val": np.asarray(self.cost_val, np.float64)}
        from ..parallel.distributed import process_count
        if self.cfg.ckpt_async and process_count() == 1:
            # double-buffered: on-chip snapshot now, D2H + write overlap
            # the next epoch's scan (finish_checkpoints joins before exit)
            if self._async_ckpt is None:
                self._async_ckpt = AsyncCheckpointer()
            self._async_ckpt.save(
                self.cfg.ckpt_dir, self.state, self.eval_histories,
                self.key, extra=extra, compress=self.cfg.ckpt_compress)
            return
        save_checkpoint(self.cfg.ckpt_dir, self.state, self.eval_histories,
                        self.key, extra=extra,
                        compress=self.cfg.ckpt_compress)

    def finish_checkpoints(self):
        """Join any in-flight async checkpoint write (re-raising writer
        errors).  Called before process exit, load/resume, and anything
        that reads the checkpoint file back."""
        if getattr(self, "_async_ckpt", None) is not None:
            self._async_ckpt.wait()

    def install_preemption_handler(self, signals=None):
        """Route SIGTERM (the eviction notice cluster managers
        send before reclaiming a worker) to a graceful stop: the epoch in
        flight finishes, the loop exits at the boundary, and sgd_train's
        final save writes the --resume counters — so a preempted job loses
        at most one epoch and relaunches with the same command line.
        Chains to any previously installed handler.  SIGINT is left alone
        (KeyboardInterrupt stays an abort, reference behavior).  sgd_train
        restores the previous handlers on exit, so signals received after
        training are never silently swallowed."""
        import signal as _signal
        self._prev_sig_handlers = getattr(self, "_prev_sig_handlers", [])
        for sig in (signals or (_signal.SIGTERM,)):
            prev = _signal.getsignal(sig)
            self._prev_sig_handlers.append((sig, prev))

            def _handler(signum, frame, _prev=prev):
                self.stop_requested = True
                if callable(_prev):
                    _prev(signum, frame)

            _signal.signal(sig, _handler)

    def _restore_preemption_handlers(self):
        import signal as _signal
        for sig, prev in getattr(self, "_prev_sig_handlers", []):
            _signal.signal(sig, prev)
        self._prev_sig_handlers = []

    def _try_resume(self, log=print) -> int:
        """--resume: restore full state + loop counters from ckpt_dir if a
        checkpoint exists (else start fresh, so one command line serves
        first launch and relaunch).  Returns the 0-based epoch index to
        continue from.  The device RNG stream resumes exactly (the key is
        checkpointed); the host-side epoch shuffle order restarts from the
        iterator's seed, which only permutes WHICH batches follow — every
        estimator is unbiased over batch order."""
        import os
        path = os.path.join(self.cfg.ckpt_dir, "model.ckpt.npz")
        if not os.path.exists(path):
            log(f"resume: no checkpoint at {path}, starting fresh")
            return 0
        self.load(load_history=True)
        ex = load_loop_extras(self.cfg.ckpt_dir)
        self.completed_epochs = int(ex.get("completed_epochs", 0))
        self.amt_data = int(ex.get("amt_data", 0))
        self.cost_val = [float(c) for c in ex.get("cost_val", [])]
        log(f"resume: continuing from epoch {self.completed_epochs + 1} "
            f"(data = {self.amt_data})")
        return self.completed_epochs

    def load(self, load_history: bool = None):
        self.finish_checkpoints()     # read-after-write ordering
        if load_history is None:
            load_history = self.cfg.gradvar
        self.state, eval_hist, key = load_checkpoint(
            self.cfg.ckpt_dir, self.state, self.eval_histories, self.key,
            load_history=load_history)
        self.key = key          # resume the saved RNG stream
        self._params_version += 1      # new weights: predict must refresh
        if load_history:
            self.eval_histories = eval_hist
        if self.mesh is not None:
            # re-commit the restored host values to their mesh shardings
            # (required under multi-controller launches, where jit cannot
            # shard raw numpy inputs)
            from ..parallel.mesh import (global_put, history_shardings,
                                         state_shardings)
            self.state = global_put(
                self.state, state_shardings(self.mesh, self.state, True))
            self.eval_histories = global_put(
                self.eval_histories,
                history_shardings(self.mesh, self.eval_histories))
        # copy train-side history into the eval-side buffers (train.py:174);
        # only possible when the train/test models have matching history
        # shapes (same preprocess/estimator settings)
        if self.state.histories and self.eval_histories:
            t_shapes = [h.shape for h in
                        jax.tree_util.tree_leaves(self.state.histories)]
            e_shapes = [h.shape for h in
                        jax.tree_util.tree_leaves(self.eval_histories)]
            if t_shapes == e_shapes:
                # cast to the EVAL-side dtype: train histories default to
                # bf16 while eval stays f32 so CV inference converges
                # exactly (--test_history_dtype); adopting the train
                # buffers verbatim would silently demote eval history
                # precision for the rest of the session
                self.eval_histories = jax.tree_util.tree_map(
                    lambda t, e: t.astype(e.dtype),
                    self.state.histories, self.eval_histories)
