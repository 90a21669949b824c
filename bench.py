"""Benchmark: CV+PP degree=1 training throughput on a Reddit-scale graph.

North-star metric (BASELINE.md): sampled edges/s/chip on Reddit-like CV+PP
training, batch 512, hidden 128.  ``amt_data`` follows the reference's
accounting (sampled-adjacency nnz per step, gcn/vrgcn.py:62); time covers the
full training step (on-device sampling + forward + backward + Adam + history
scatter).

The original Reddit dataset does not ship with the code, so the benchmark
runs on a synthetic graph with Reddit's shape (233k nodes, load-time degree
cap as the reference does for GraphSAGE data via --max_degree, feature dim
602, 41 classes).

``vs_baseline``: the reference publishes no absolute throughput, so the
denominator is a MEASURED upper bound on the reference pipeline's edges/s
(scripts/derive_baseline.py: the reference's own C++ scheduler + copy-out +
feature slice + feed_dict PCIe copy, compiled from /root/reference and
driven at this exact recipe, total 1.31 ms/step = 3.9e5 edges/s at batch
512; GPU compute and TF1 dispatch excluded, i.e. generous to the
reference — see BASELINE.md).  vs_baseline is therefore a LOWER bound on
the true speedup.  The target from BASELINE.json is vs_baseline >= 5
against the realistic reference (~1e5 edges/s once GPU + TF overhead are
counted); against this measured bound the round-1 target maps to >= 1.3.
"""

import json
import os
import sys
import time

import numpy as np

REFERENCE_EDGES_PER_S = 3.9e5   # measured host-path bound (BASELINE.md)
REFERENCE_EDGES_PER_S_B4096 = 1.2e5

N_NODES = 233_000
AVG_DEG = 64
# Load-time degree cap (the reference's --max_degree analogue for GraphSAGE
# data, gcn/utils.py:261-263).  This synthetic graph is near-binomial with
# mean degree 64 (train subgraph ~28), so a cap of 64 keeps >99.9% of edges;
# the real Reddit recipe would use 128 per configs/reddit.sh.  Graphs are
# padded to their true post-cap max degree — the CV full-neighborhood gather
# is row-issue-rate bound, so padding waste directly costs step time.
PAD_DEG = 64
FEAT_DIM = 602
N_CLASSES = 41
BATCH = 512
HIDDEN = 128


def build_reddit_like(cache="data/bench_reddit_like.npz"):
    """The Reddit-shaped graph, generated from seed 0.  ``cache``: npz path
    to reuse across runs (about 2 GB); None builds in memory only."""
    from stochastic_gcn_tpu.data.graph import Dataset
    from stochastic_gcn_tpu.data import preprocess as P

    if cache and os.path.exists(cache):
        from stochastic_gcn_tpu.data.loaders import _load_cached
        return _load_cached(cache)

    rng = np.random.default_rng(0)
    n_edges = N_NODES * AVG_DEG // 2
    edges = rng.integers(0, N_NODES, size=(n_edges, 2), dtype=np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    adj01 = (P.adj_from_edges(edges, N_NODES) > 0).astype(np.float32)
    full_adj = P.graphsage_normalize_adj(adj01)

    feats = rng.normal(size=(N_NODES, FEAT_DIM)).astype(np.float32)
    labels = np.zeros((N_NODES, N_CLASSES), dtype=np.float32)
    labels[np.arange(N_NODES), rng.integers(0, N_CLASSES, N_NODES)] = 1

    perm = rng.permutation(N_NODES).astype(np.int32)
    n_train = int(N_NODES * 0.66)
    n_val = int(N_NODES * 0.10)
    train_d = np.sort(perm[:n_train])
    val_d = np.sort(perm[n_train:n_train + n_val])
    test_d = np.sort(perm[n_train + n_val:])

    is_train = np.zeros(N_NODES, bool)
    is_train[train_d] = True
    tr_mask = is_train[edges[:, 0]] & is_train[edges[:, 1]]
    train_adj = P.graphsage_normalize_adj(
        (P.adj_from_edges(edges[tr_mask], N_NODES) > 0).astype(np.float32))

    print("computing PP features...", file=sys.stderr)
    train_feats = train_adj.dot(feats)
    test_feats = full_adj.dot(feats)

    ds = Dataset(num_data=N_NODES, train_adj=train_adj, full_adj=full_adj,
                 feats=feats, train_feats=train_feats, test_feats=test_feats,
                 labels=labels, train_d=train_d, val_d=val_d, test_d=test_d)
    if not cache:
        return ds
    try:
        from stochastic_gcn_tpu.data.loaders import _cache_dataset
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        _cache_dataset(cache, ds, sparse_feats=False)
    except Exception as e:
        print(f"cache skipped: {e}", file=sys.stderr)
    return ds


def build_planted_labels(base, cache="data/bench_reddit_planted.npz"):
    """Labels carrying a learnable 1-hop-smoothed signal on the bench graph
    (exactly the quantity PP precomputes), so convergence measures
    optimization speed rather than task impossibility."""
    if os.path.exists(cache):
        return np.load(cache)["labels"]
    rng = np.random.default_rng(1)
    n_cls = base.labels.shape[1]
    proj = rng.normal(size=(base.feats.shape[1], n_cls)).astype(np.float32)
    smooth = base.full_adj.dot(base.feats)
    logits = smooth @ proj
    labels = np.zeros_like(base.labels)
    labels[np.arange(base.num_data), logits.argmax(1)] = 1
    os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
    np.savez(cache, labels=labels)
    return labels


# --- estimator time-to-accuracy A/B (the paper's headline claim) ---------
#
# "CVD+PP has similar accuracy with Exact, but is faster"
# (/root/reference/README.md:44); protocol = time/epochs to a val-accuracy
# threshold safely below the plateau (analyze-time.py:12-14: 0.94 on real
# Reddit vs ~0.963 plateau).  Real Reddit doesn't ship with either repo, so
# the A/B runs on a degree-corrected SBM with planted communities and
# power-law degrees (data/loaders.py::community_sbm_dataset) calibrated so
# the 2-layer GCN needs BOTH hops: raw features ~0.05 linear accuracy,
# 1-hop ~0.7, 2-hop ~1.0 — the regime where sampled-layer variance
# separates the estimators.  snr=0.04 set by a sweep on the full
# 65536-node graph (snr 0.02 is too hard: CV+PP plateaus 0.69 and CVD
# diverges at lr 0.01; snr 0.03 leaves CV+PP at 0.865, under the band):
# 40-epoch plateaus at 0.04 are NS+PP 0.847, CV+PP 0.950, CVD+PP 0.992,
# Exact 0.995 — the 0.90 band separates NS from CV/CVD/Exact just as the
# reference's 0.94-of-0.963 Reddit protocol does.
AB_TARGET_F1 = 0.90
AB_SNR = 0.04
AB_ALGOS = [
    # grid per reference scripts/analyze-time.py exps (deg, cv, pp):
    # Exact = full degree NO PP; the sampled algos ride PP (default).
    # Per-algo epoch budget: Exact is in band by epoch 2 and at plateau
    # by 8; the sampled arms get the full 40 so plateaus are converged.
    ("exact", dict(degree=10000, preprocess=False, test_preprocess=False),
     12),
    ("nspp", dict(degree=1), 40),
    ("cvpp", dict(degree=1, cv=True, test_cv=True), 40),
    ("cvdpp", dict(degree=1, cv=True, cvd=True, test_cv=True,
                   test_cvd=True), 40),
]


def build_community_reddit(cache=f"data/bench_sbm_reddit_snr{AB_SNR}.npz"):
    from stochastic_gcn_tpu.data.loaders import (_cache_dataset,
                                                 _load_cached,
                                                 community_sbm_dataset)
    if os.path.exists(cache):
        return _load_cached(cache)
    ds = community_sbm_dataset(num_nodes=65536, num_classes=N_CLASSES,
                               feature_dim=FEAT_DIM, mean_degree=25,
                               p_in=0.7, snr=AB_SNR, seed=0, max_degree=64)
    os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
    _cache_dataset(cache, ds, sparse_feats=False)
    return ds


# conservative wall-clock estimates per A/B arm (warmup trainer + compile
# + measured epochs + evals) for deadline gating
AB_ARM_EST_S = {"exact": 320, "nspp": 200, "cvpp": 200, "cvdpp": 230}


def run_estimator_ab(target_f1=AB_TARGET_F1, log=print, seeds=(1,),
                     deadline=None):
    """Epochs / train-seconds / sampled-data to the target val micro-F1 for
    Exact vs NS+PP vs CV+PP vs CVD+PP on the community benchmark graph.

    Timing counts TRAINING time only (the reference's per-epoch time
    column that analyze-time.py sums); evaluation runs between epochs with
    exact inference (test_degree huge) for every algorithm so accuracy is
    measured identically.  Per algo: one throwaway warmup epoch + eval
    (compile), then fresh Trainers reuse the compile cache for the
    measured runs.

    ``seeds``: one measured run per seed (data split/init/sampling all
    reseed); headline keys are MEANS over seeds with per-seed arrays and
    stds alongside — single-run wall-clock ordering between CV and CVD
    can flip run to run, so multi-seed means are the
    durable record (scripts/run_estimator_ab.py writes ESTIMATOR_AB.json
    at seeds=(1,2,3); the driver bench stays single-seed for time)."""
    import jax
    from stochastic_gcn_tpu.config import Config
    from stochastic_gcn_tpu.training.loop import Trainer

    ds = build_community_reddit()
    out = {"ab_target_micro_f1": target_f1,
           "ab_seeds": list(seeds)}

    def _mean(xs):
        xs = [x for x in xs if x is not None]
        return round(float(np.mean(xs)), 3) if xs else None

    def _std(xs):
        xs = [x for x in xs if x is not None]
        return round(float(np.std(xs)), 3) if len(xs) > 1 else None

    base = dict(dataset="sbm_reddit", batch_size=BATCH, test_degree=10000,
                hidden1=HIDDEN, normalization="graphsage", layer_norm=True,
                num_fc_layers=2, weight_decay=0.0, dropout=0.2,
                test_batch_size=2048, pad_degree=64)
    for name, over, max_epochs in AB_ALGOS:
        # deadline gating: a half-measured arm is worth
        # less than the budget it burns — skip arms that can't fit, and
        # say so in the artifact instead of dying mid-arm like r4
        if deadline is not None and \
                time.time() + AB_ARM_EST_S.get(name, 250) > deadline:
            out[f"ab_{name}_skipped"] = "budget"
            _RESULT.update(out)
            log(f"ab {name}: skipped (budget)", file=sys.stderr, flush=True)
            continue
        cfg0 = Config(**base, seed=seeds[0], **over)
        tr = Trainer(cfg0, ds)
        tr.train_epoch()
        tr.evaluate(ds.val_d)      # absorb compile
        del tr
        hits_ep, hits_s, hits_amt, plateaus, bests, epoch_s = \
            [], [], [], [], [], []
        hits_s_steady = []
        for seed in seeds:
            tr = Trainer(Config(**base, seed=seed, **over), ds)
            jax.block_until_ready(tr.state)   # state init off the clock
            train_s = 0.0
            amt = 0
            hit_ep = hit_s = hit_amt = None
            traj = []
            ep_times = []
            for epoch in range(max_epochs):
                # train_epoch ends in a value fetch of the loss, so the
                # wall clock closes after the device finished
                t0 = time.perf_counter()
                tr.train_epoch()
                ep_s = time.perf_counter() - t0
                train_s += ep_s
                ep_times.append(ep_s)
                amt = tr.amt_data
                _, _, micro, _, _ = tr.evaluate(ds.val_d)
                traj.append(float(micro))
                log(f"ab {name} seed {seed} epoch {epoch + 1}: micro_f1 "
                    f"{micro:.4f} (train {train_s:.1f}s)",
                    file=sys.stderr, flush=True)
                if hit_ep is None and micro >= target_f1:
                    hit_ep, hit_s, hit_amt = (epoch + 1, round(train_s, 2),
                                              amt)
            hits_ep.append(hit_ep)
            hits_s.append(hit_s)
            hits_amt.append(hit_amt)
            # Steady-state protocol: each measured Trainer's FIRST epoch
            # carries seconds of host-side tracing + buffer setup (e.g.
            # Exact 32 s vs 9.5 s/epoch steady; CVD 7.5 vs 0.2) — one-time
            # apparatus, excluded the same way the throughput bench
            # excludes warmup.  seconds_to_target_steady = median
            # steady-state epoch time x epochs_to_target; both protocols
            # are reported.
            if len(ep_times) > 1 and hit_ep is not None:
                steady = float(np.median(ep_times[1:]))
                hits_s_steady.append(round(steady * hit_ep, 2))
            bests.append(round(max(traj), 4))
            plateaus.append(round(float(np.mean(traj[-5:])), 4))
            epoch_s.append(round(train_s / max_epochs, 3))
            if seed == seeds[0]:
                # per-epoch curve for scripts/plot_results.py::plot_ab (the
                # reference's plot-convergence.py draws these from logs)
                out[f"ab_{name}_trajectory"] = [round(v, 4) for v in traj]
            del tr
        # headline keys = MEANS over seeds (backward-compatible names)
        # seeds that never reach the band within the epoch budget: _mean
        # silently averages the hitting subset, so surface the miss count
        # (a nonzero value here means the *_to_target means cover fewer
        # seeds than ab_seeds)
        out[f"ab_{name}_target_misses"] = sum(h is None for h in hits_ep)
        out[f"ab_{name}_epochs_to_target"] = _mean(hits_ep)
        out[f"ab_{name}_seconds_to_target"] = _mean(hits_s)
        out[f"ab_{name}_seconds_to_target_steady"] = _mean(hits_s_steady)
        out[f"ab_{name}_data_to_target"] = _mean(hits_amt)
        out[f"ab_{name}_best_micro_f1"] = _mean(bests)
        out[f"ab_{name}_plateau_micro_f1"] = _mean(plateaus)
        out[f"ab_{name}_epoch_train_s"] = _mean(epoch_s)
        if len(seeds) > 1:
            out[f"ab_{name}_epochs_to_target_per_seed"] = hits_ep
            out[f"ab_{name}_seconds_to_target_per_seed"] = hits_s
            out[f"ab_{name}_data_to_target_per_seed"] = hits_amt
            out[f"ab_{name}_plateau_micro_f1_per_seed"] = plateaus
            out[f"ab_{name}_seconds_to_target_std"] = _std(hits_s)
            out[f"ab_{name}_epochs_to_target_std"] = _std(hits_ep)
        # commit this arm's record before starting the next one — a failure
        # mid-A/B must not lose completed arms (_emit_partial drains
        # _RESULT; harmless duplicate of the caller's final update)
        _RESULT.update(out)
    # a 0.0 seconds_to_target is a degenerate measurement, not a missing
    # arm: guard on None and flag the degenerate case instead of silently
    # dropping the key
    for arm in ("cvdpp", "cvpp"):
        for suffix in ("", "_steady"):
            ex = out.get(f"ab_exact_seconds_to_target{suffix}")
            s = out.get(f"ab_{arm}_seconds_to_target{suffix}")
            if ex is None or s is None:
                continue
            if s <= 0.0 or ex <= 0.0:
                out[f"ab_{arm}_speedup_vs_exact{suffix}"] = None
                out["ab_degenerate_timing"] = True
            else:
                out[f"ab_{arm}_speedup_vs_exact{suffix}"] = round(ex / s, 2)
    return out


def run_convergence(target_f1=AB_TARGET_F1, pass_margin=0.02,
                    max_epochs=25, log=print):
    """Driver-facing convergence gate: CV+PP degree=1 on the planted-
    community SBM graph must reach the 0.90 acceptance band with a real
    margin (the old 0.40-target random-graph gate had a
    1% margin on a graph with almost no learnable signal; this band is
    the same one the estimator A/B and the reference's Reddit protocol
    use: a threshold safely below the plateau,
    /root/reference/scripts/plot-convergence.py:21 0.95-0.968 and
    analyze-time.py:14 0.94).

    Runs until best >= target + pass_margin + 0.01 (margin headroom) or
    ``max_epochs``; CV+PP passes 0.90 at ~epoch 7 and plateaus ~0.95
    in earlier runs, so the expected margin is ~0.05."""
    import jax
    from stochastic_gcn_tpu.config import Config
    from stochastic_gcn_tpu.training.loop import Trainer

    ds = build_community_reddit()
    cfg = Config(dataset="sbm_reddit", batch_size=BATCH, degree=1,
                 test_degree=10000, cv=True, test_cv=True, hidden1=HIDDEN,
                 normalization="graphsage", layer_norm=True,
                 num_fc_layers=2, weight_decay=0.0, dropout=0.2,
                 test_batch_size=2048, pad_degree=64, seed=1)
    tr = Trainer(cfg, ds)
    jax.block_until_ready(tr.state)    # state init off the clock
    train_s = 0.0
    best = 0.0
    hit_epochs = hit_seconds = None
    for epoch in range(max_epochs):
        t0 = time.perf_counter()
        tr.train_epoch()                # ends in a value fetch
        train_s += time.perf_counter() - t0
        _, _, micro, _, _ = tr.evaluate(ds.val_d)
        best = max(best, float(micro))
        log(f"convergence epoch {epoch + 1}: micro_f1 {micro:.4f}",
            file=sys.stderr, flush=True)
        if hit_epochs is None and micro >= target_f1:
            hit_epochs = epoch + 1
            hit_seconds = round(train_s, 2)
        if best >= target_f1 + pass_margin + 0.01:
            break
    del tr
    margin = round(best - target_f1, 4)
    return {
        "convergence_dataset": "sbm_reddit_cvpp_deg1",
        "convergence_target_micro_f1": target_f1,
        "convergence_epochs_to_target": hit_epochs,
        "convergence_seconds_to_target": hit_seconds,
        "convergence_best_micro_f1": round(best, 4),
        "convergence_margin": margin,
        "convergence_pass": bool(hit_epochs is not None
                                 and margin >= pass_margin),
        "convergence_epochs_run": epoch + 1,
    }


def run_convergence_planted(cfg, base, target_f1=0.40, max_epochs=150):
    """Epochs/seconds to target val micro-F1 on the planted-signal task —
    the OLD driver gate, kept for scripts/bench_convergence.py history
    (BASELINE.md; reference threshold protocol:
    scripts/analyze-time.py:12-71, 0.94 on real Reddit).

    Target calibration (250-epoch probe): the task passes 0.40 at
    ~epoch 95-100 and plateaus ~0.48 by 250 — 0.40 at max 150 epochs
    mirrors the reference's "threshold safely below the achievable
    plateau" protocol (0.94 vs ~0.963 on real Reddit)."""
    import dataclasses
    from stochastic_gcn_tpu.training.loop import Trainer

    labels = build_planted_labels(base)
    ds = dataclasses.replace(base, labels=labels)
    tr = Trainer(cfg.replace(test_batch_size=2048), ds)
    t_start = time.perf_counter()
    hit_epochs = hit_seconds = None
    best = 0.0
    for epoch in range(max_epochs):
        tr.train_epoch()
        _, _, micro, _, _ = tr.evaluate(ds.val_d)
        best = max(best, micro)
        print(f"convergence epoch {epoch + 1}: micro_f1 {micro:.4f}",
              file=sys.stderr, flush=True)
        if micro >= target_f1:
            hit_epochs = epoch + 1
            hit_seconds = round(time.perf_counter() - t_start, 1)
            break
    return {
        "convergence_target_micro_f1": target_f1,
        "convergence_epochs_to_target": hit_epochs,
        "convergence_seconds_to_target": hit_seconds,
        "convergence_best_micro_f1": round(float(best), 4),
        "convergence_epochs_run": epoch + 1,
    }


def run_inference(tr, ds, edges_per_node, deadline=None, export_est_s=300):
    """Inference/serving throughput at the bench recipe.

    * ``infer_nodes_per_s`` / ``infer_edges_per_s``: steady-state
      ``Trainer.predict`` over the test split (one scanned dispatch,
      histories already converged — the serving hot path).  Edges follow
      the reference's sampled-adjacency accounting: eval runs the same
      degree-1+PP recipe as training, so edges/node is the headline's
      measured ``amt_data / (steps * batch)``.
    * ``infer_cv_refresh_s``: the num_layers full passes over every node
      that CV inference pays per WEIGHT CHANGE before predictions equal
      exact inference (the Test protocol, reference train.py:339-341).
    * ``infer_*_exported``: the jax.export StableHLO artifact
      (serving.py), whose contract is one device call per
      ``scan_batches`` x test_batch_size ids.
    """
    out = {}
    n = ds.num_data
    test_ids = ds.test_d
    # cold call: compiles the eval + predict epochs AND converges the CV
    # eval history (num_layers full passes) — the one-time serving setup
    t0 = time.time()
    preds = tr.predict(test_ids)
    out["infer_cold_s"] = round(time.time() - t0, 2)
    # steady state: refresh is incremental (histories stay converged under
    # unchanged weights), so repeated calls run just the predict epoch
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        preds = tr.predict(test_ids)       # returns host arrays
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    out["infer_nodes_per_s"] = round(len(test_ids) / dt, 1)
    out["infer_edges_per_s"] = round(len(test_ids) / dt * edges_per_node, 1)
    # per-weight-change CV refresh cost: one timed full-graph eval pass
    # (compiled above) x num_layers
    all_ids = np.arange(n, dtype=np.int32)
    t0 = time.perf_counter()
    tr.evaluate(all_ids)                   # ends in value fetches
    out["infer_cv_refresh_s"] = round(
        (time.perf_counter() - t0) * tr.cfg.num_layers, 2)
    _RESULT.update(out)

    if deadline is not None and time.time() + export_est_s > deadline:
        out["infer_export_skipped"] = "budget"
        _RESULT.update(out)
        return out
    import shutil
    import tempfile
    from stochastic_gcn_tpu.serving import export_predictor, load_predictor
    d = tempfile.mkdtemp(prefix="bench_export_")
    try:
        t0 = time.time()
        # scan_batches=4: 4 x 2048 ids per device call — the bulk-serving
        # shape
        export_predictor(tr, d, scan_batches=4)
        out["serving_export_s"] = round(time.time() - t0, 1)
        pred = load_predictor(d)
        sub = np.asarray(test_ids[:8192])
        p2 = pred.predict(sub)          # warm the deserialized call path
        t0 = time.time()
        p2 = pred.predict(sub)
        dt2 = max(time.time() - t0, 1e-9)
        out["infer_nodes_per_s_exported"] = round(len(sub) / dt2, 1)
        out["infer_edges_per_s_exported"] = round(
            len(sub) / dt2 * edges_per_node, 1)
        out["infer_export_max_abs_diff"] = round(
            float(np.max(np.abs(p2 - preds[:len(sub)]))), 6)
    except Exception as e:   # noqa: BLE001 — report, don't lose the rest
        out["infer_export_error"] = repr(e)[:200]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    _RESULT.update(out)
    return out


def main():
    import jax
    import jax.numpy as jnp
    from stochastic_gcn_tpu.config import Config
    from stochastic_gcn_tpu.training.loop import Trainer
    from stochastic_gcn_tpu.utils.compile_cache import enable_compile_cache
    from stochastic_gcn_tpu.utils.device import query_cards, require_gpu

    # a measurement names its device and never falls back to the CPU
    devices = require_gpu(jax.devices())
    cards = query_cards()
    result = _RESULT
    result.update({
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": cards[0][0],
        "power_limit": cards[0][1],
    })
    # every section re-traces the same static shapes: keep the
    # executables in the persistent compilation cache
    result["compile_cache"] = enable_compile_cache()

    # Sections run most-important-first and each checks the remaining
    # budget against a conservative estimate before starting; skipped
    # sections are named in the artifact.  BENCH_BUDGET_S tunes the box.
    budget = float(os.environ.get("BENCH_BUDGET_S", "1500"))
    deadline = time.time() + budget
    result["bench_budget_s"] = budget
    skipped = []

    def gate(name, est_s):
        """Run this section only if its estimate fits the budget left."""
        left = deadline - time.time()
        if est_s > left:
            skipped.append(name)
            result["skipped_sections"] = ",".join(skipped)
            print(f"section {name}: skipped (needs ~{est_s:.0f}s, "
                  f"{left:.0f}s left)", file=sys.stderr, flush=True)
            return False
        return True

    t0 = time.time()
    ds = build_reddit_like()
    print(f"data ready in {time.time()-t0:.1f}s", file=sys.stderr)

    cfg = Config(dataset="reddit_like", batch_size=BATCH, degree=1,
                 test_degree=1, cv=True, test_cv=True, hidden1=HIDDEN,
                 normalization="graphsage", layer_norm=True,
                 num_fc_layers=2, weight_decay=0.0, dropout=0.2,
                 pad_degree=PAD_DEG, seed=1,
                 test_batch_size=2048)   # inference/serving section shape
    t0 = time.time()
    tr = Trainer(cfg, ds)
    print(f"trainer built in {time.time() - t0:.1f}s", file=sys.stderr)

    # epoch-style scan: S steps per dispatch, one host sync per dispatch
    rng = np.random.default_rng(0)

    def batch_matrix(steps):
        ids = rng.permutation(ds.train_d)[:steps * BATCH].astype(np.int32)
        return jnp.asarray(ids.reshape(steps, BATCH))

    def measure_epochs(trv, mk_matrix, steps, reps=3):
        """Timing protocol shared by the headline and every variant: batch
        matrices staged on the device before the clock starts, one warm-up
        dispatch (compile), then ``reps`` dispatches each closed by
        ``block_until_ready``.  Returns (seconds, amt_data, metrics)."""
        bms = jax.block_until_ready(
            [mk_matrix(steps) for _ in range(reps + 1)])
        t0 = time.perf_counter()
        trv.state, m = jax.block_until_ready(trv._train_epoch(
            trv.state, trv.graph_train, trv.train_features, trv.labels,
            trv.importance_train, bms[-1], trv._next_key()))
        print(f"  warmup (compile + {steps} steps) in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr,
              flush=True)
        dts, amts = [], []
        for r in range(reps):
            t0 = time.perf_counter()
            trv.state, m = jax.block_until_ready(trv._train_epoch(
                trv.state, trv.graph_train, trv.train_features,
                trv.labels, trv.importance_train, bms[r],
                trv._next_key()))
            dts.append(time.perf_counter() - t0)
            amts.append(int(m["amt_data"]))
        return dts, amts, m

    def edges_per_s_of(trv, mk_matrix, steps, reps=3):
        dts, amts, m = measure_epochs(trv, mk_matrix, steps, reps)
        mid = int(np.argsort(dts)[len(dts) // 2])
        return amts[mid] / dts[mid], m

    # ---- headline: median of 5 dispatches at the reference recipe ------
    steps = 300   # one epoch at batch 512 (real workflow granularity)
    dts, amts, metrics = measure_epochs(tr, batch_matrix, steps, reps=5)
    mid = int(np.argsort(dts)[len(dts) // 2])
    dt, amt = dts[mid], amts[mid]
    edges_per_s = amt / dt
    edges_per_node = float(np.mean(amts)) / (steps * BATCH)

    # Commit the headline the moment it exists: a failure in a later
    # section must not lose it (_emit_partial hands over whatever is in
    # _RESULT).
    result.update({
        "metric": "reddit_like_cvpp_deg1_sampled_edges_per_s",
        "value": round(edges_per_s, 1),
        "unit": "edges/s",
        "vs_baseline": round(edges_per_s / REFERENCE_EDGES_PER_S, 3),
        "steps_per_s": round(steps / dt, 2),
        "step_ms": round(1000 * dt / steps, 3),
        "step_ms_min": round(1000 * min(dts) / steps, 3),
        "step_ms_max": round(1000 * max(dts) / steps, 3),
        "loss": round(float(metrics["loss"]), 4),
        "truncated_edges_frac": tr.truncated_edges_frac,
        "peak_bytes_in_use": (devices[0].memory_stats() or {}).get(
            "peak_bytes_in_use"),
    })

    fast = os.environ.get("BENCH_FAST", "") not in ("", "0", "false",
                                                    "False")
    if fast:
        _emit(result)
        return

    def section(name, fn):
        """Run a section; a failure records an error key instead of
        aborting the whole artifact, and the bench then exits 1."""
        try:
            fn()
        except Exception as e:   # noqa: BLE001
            result[f"{name}_error"] = repr(e)[:200]
            print(f"section {name} FAILED: {e!r}", file=sys.stderr,
                  flush=True)

    # ---- driver convergence gate: SBM 0.90 band --------
    if gate("convergence", 150):
        section("convergence",
                lambda: result.update(run_convergence()))

    # ---- inference/serving throughput ------------------
    if gate("inference", 150):
        section("inference",
                lambda: run_inference(tr, ds, edges_per_node,
                                      deadline=deadline, export_est_s=150))

    # ---- 3-layer path (the field-explosion regime) ---------------------
    def _three_layer():
        tr3 = Trainer(cfg.replace(num_layers=3), ds)
        eps3, _ = edges_per_s_of(tr3, batch_matrix, steps)
        result["edges_per_s_3layer"] = round(eps3, 1)

    if gate("three_layer", 100):
        section("three_layer", _three_layer)

    def _three_layer_big():
        tr3b = Trainer(cfg.replace(num_layers=3, batch_size=4096), ds)

        def b3_matrix(s):
            ids = np.resize(rng.permutation(ds.train_d).astype(np.int32),
                            s * 4096)
            return jnp.asarray(ids.reshape(s, 4096))

        eps3b, _ = edges_per_s_of(tr3b, b3_matrix, 100)
        result["edges_per_s_3layer_batch4096"] = round(eps3b, 1)

    if gate("three_layer_b4096", 110):
        section("three_layer_b4096", _three_layer_big)

    # ---- variant keys --------------------------------------------------
    # f32-history (--history_dtype=float32, bit-level reference
    # semantics; bf16 is the validated default — REPLICA_VALIDATION_BF16)
    def _f32():
        tr16 = Trainer(cfg.replace(history_dtype="float32"), ds)
        eps16, _ = edges_per_s_of(tr16, batch_matrix, steps)
        result["edges_per_s_f32_history"] = round(eps16, 1)
        result["vs_baseline_f32_history"] = round(
            eps16 / REFERENCE_EDGES_PER_S, 3)

    if gate("f32_history", 90):
        section("f32_history", _f32)

    # max-throughput batch (per-step cost is latency-bound and nearly
    # batch-independent, so edges/s scales ~linearly with batch)
    big, big_steps = 4096, 100

    def big_matrix_for(b):
        def mk(s):
            # recycle train ids across steps so the scan is long enough
            # to amortize the fixed per-dispatch cost (batches stay
            # duplicate-free WITHIN each step, all the scheduler needs)
            ids = np.resize(rng.permutation(ds.train_d).astype(np.int32),
                            s * b)
            return jnp.asarray(ids.reshape(s, b))
        return mk

    def _big():
        tr_big = Trainer(cfg.replace(batch_size=big), ds)
        eps_big, _ = edges_per_s_of(tr_big, big_matrix_for(big), big_steps)
        result["edges_per_s_batch4096"] = round(eps_big, 1)
        result["vs_baseline_batch4096"] = round(
            eps_big / REFERENCE_EDGES_PER_S_B4096, 3)

    if gate("batch4096", 100):
        section("batch4096", _big)

    # dedup-compacted field layout (--field_dedup): reference-faithful
    # `visited`-map semantics; the headline rides the validated no-dedup
    # default (REPLICA_VALIDATION_NODEDUP) — this records what exact
    # reference field semantics cost.
    def _dedup():
        for b, s_, key in ((BATCH, steps, "edges_per_s_dedup"),
                           (big, big_steps, "edges_per_s_dedup_batch4096")):
            tr_nd = Trainer(cfg.replace(batch_size=b, field_dedup=True),
                            ds)
            eps_nd, _ = edges_per_s_of(tr_nd, big_matrix_for(b), s_)
            result[key] = round(eps_nd, 1)
            del tr_nd

    if gate("dedup", 160):
        section("dedup", _dedup)

    # IS recipe record: auto slot cap (-1 -> 8 at batch
    # 4096) vs the exact-semantics cap-0 path
    def _featbf16():
        trf = Trainer(cfg.replace(features_dtype="bfloat16"), ds)
        epsf, _ = edges_per_s_of(trf, batch_matrix, steps)
        result["edges_per_s_featbf16"] = round(epsf, 1)

    # bf16 feature tables (--features_dtype, band-validated —
    # REPLICA_VALIDATION_FEATBF16): half the input-slice bytes
    if gate("featbf16", 90):
        section("featbf16", _featbf16)

    def _importance():
        for cap, key in ((-1, "edges_per_s_is_batch4096"),
                         (0, "edges_per_s_is_cap0_batch4096")):
            tr_is = Trainer(cfg.replace(batch_size=big, cv=False,
                                        test_cv=False, importance=True,
                                        test_importance=True,
                                        is_slot_cap=cap), ds)
            eps_is, _ = edges_per_s_of(tr_is, big_matrix_for(big),
                                       big_steps)
            result[key] = round(eps_is, 1)
            del tr_is

    if gate("importance", 160):
        section("importance", _importance)

    # ---- estimator time-to-accuracy A/B (the paper's headline claim,
    # /root/reference/README.md:44) — last: most expensive, per-arm
    # deadline-gated inside ------------------------------------------------
    if gate("estimator_ab", AB_ARM_EST_S["exact"]):
        del tr, metrics
        section("estimator_ab",
                lambda: result.update(run_estimator_ab(deadline=deadline)))

    _emit(result)
    failed = [k for k in result if k.endswith("_error")]
    if failed:
        print(f"failed sections: {failed}", file=sys.stderr)
        sys.exit(1)


# A harness that keeps only the LAST ~2000 chars of combined output parses
# the final JSON line it finds there (one giant line carrying 40-element A/B
# trajectories would lose its leading keys to truncation).  Budget well
# under the cap: stderr lines can interleave.
_COMPACT_BUDGET = 1400

# Keys that must survive into the final compact line, most important first.
# Everything else is spilled (trajectories first — they are lists) to
# BENCH_VERBOSE.json + an EARLY stdout line.
_KEY_PRIORITY = [
    "metric", "value", "unit", "vs_baseline", "error", "step_ms",
    "steps_per_s", "platform", "device_kind", "device_count", "card",
    "power_limit",
    "convergence_pass", "convergence_margin", "truncated_edges_frac",
    "skipped_sections",
    "edges_per_s_3layer", "edges_per_s_3layer_batch4096",
    "infer_edges_per_s", "infer_nodes_per_s", "infer_cv_refresh_s",
    "infer_edges_per_s_exported", "serving_export_s",
    "edges_per_s_batch4096", "vs_baseline_batch4096",
    "edges_per_s_f32_history", "vs_baseline_f32_history",
    "edges_per_s_dedup", "edges_per_s_dedup_batch4096",
    "edges_per_s_is_batch4096", "edges_per_s_is_cap0_batch4096",
    "edges_per_s_featbf16",
    "convergence_epochs_to_target",
    "convergence_seconds_to_target", "convergence_best_micro_f1",
    "ab_cvdpp_speedup_vs_exact", "ab_cvpp_speedup_vs_exact",
    "ab_cvdpp_speedup_vs_exact_steady", "ab_cvpp_speedup_vs_exact_steady",
    "ab_exact_seconds_to_target_steady", "ab_cvdpp_seconds_to_target_steady",
    "ab_exact_seconds_to_target", "ab_cvpp_seconds_to_target",
    "ab_cvdpp_seconds_to_target", "ab_nspp_seconds_to_target",
    "ab_exact_epochs_to_target", "ab_cvpp_epochs_to_target",
    "ab_cvdpp_epochs_to_target", "ab_cvdpp_plateau_micro_f1",
    "ab_cvpp_plateau_micro_f1", "ab_nspp_plateau_micro_f1",
    "loss", "peak_bytes_in_use",
]


def _emit(result: dict):
    """Print the headline as the FINAL stdout line, guaranteed compact.

    Verbose values (lists like the A/B trajectories, long strings) plus any
    overflow keys go to BENCH_VERBOSE.json and an earlier stdout line, so
    the driver's tail capture always parses the headline."""
    def _prio(k):
        return (_KEY_PRIORITY.index(k) if k in _KEY_PRIORITY
                else len(_KEY_PRIORITY))

    compact, verbose = {}, {}
    for k in sorted(result, key=lambda k: (_prio(k), k)):
        v = result[k]
        small = not isinstance(v, (list, tuple, dict)) \
            and len(json.dumps(v, default=str)) <= 120
        if small and len(json.dumps({**compact, k: v})) <= _COMPACT_BUDGET:
            compact[k] = v
        else:
            verbose[k] = v
    try:
        with open("BENCH_VERBOSE.json", "w") as f:
            json.dump(result, f, indent=1, default=str)
    except OSError as e:
        print(f"BENCH_VERBOSE.json write failed: {e}", file=sys.stderr)
    if verbose:
        # early line: may be clipped by the tail capture; the file has it all
        print(json.dumps({"bench_verbose": verbose}, default=str))
    print(json.dumps(compact))


# Partial-result accumulator: main() fills this in place so a mid-run
# failure still hands over every metric measured before the fault,
# instead of nothing.
_RESULT: dict = {}


def _emit_partial(err: str, code: int):
    _RESULT.setdefault("metric", "reddit_like_cvpp_deg1_sampled_edges_per_s")
    _RESULT.setdefault("value", None)
    _RESULT.setdefault("unit", "edges/s")
    _RESULT.setdefault("vs_baseline", None)
    _RESULT["error"] = err[:300]
    _emit(_RESULT)
    sys.exit(code)


if __name__ == "__main__":
    import signal
    signal.signal(signal.SIGTERM,
                  lambda s, f: _emit_partial("bench SIGTERMed mid-run "
                                             "(driver timeout?)", 4))
    try:
        main()
    except Exception as e:        # noqa: BLE001 — report partials, then die
        _emit_partial(f"bench aborted mid-run: {e!r}", 3)
