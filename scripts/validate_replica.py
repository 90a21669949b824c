"""Estimator acceptance validation on replica-format datasets.

The reference's definition of correctness is (a) each estimator's final
accuracy matches Exact within noise ("CVD+PP has similar accuracy with
Exact", reference README.md:44; scripts/plot-test.py bars) and (b) the val
accuracy lands in per-dataset bands (scripts/plot-convergence.py:17-22).
The real datasets are unobtainable offline, so this runs the full pipeline
— fixture FILES in the exact Planetoid/GraphSAGE on-disk formats (loader
bit-parity vs the reference's own loader code is proven in
tests/test_reference_oracle.py) → our loaders → training — on a
Cora-shaped replica whose planted signal is calibrated so Exact lands in
the real Cora band (0.77-0.80), plus a PPI-shaped multilabel replica.

Algorithm grid per the reference's run-experiments.py: Exact, NS+PP,
IS+PP, CV+PP, CVD+PP (degree=1).  Pass criteria:

* CV+PP and CVD+PP within 0.025 of Exact (the reference's headline claim,
  README.md:44 "CVD+PP has similar accuracy with Exact");
* NS+PP / IS+PP within ``--tol`` (default 0.08) of Exact — the reference
  makes NO parity claim for plain neighbor sampling; degree=1 NS
  underperforming Exact by several points is the paper's motivating
  observation (arXiv:1710.10568 Fig. 3), so this is only a sanity floor;
* Cora-replica Exact val accuracy inside [0.74, 0.86] (band-calibrated).

Writes REPLICA_VALIDATION.json at the repo root and exits nonzero on
failure.  ~3 min on CPU (default), --platform gpu to run on the GPU.
"""
import sys, os
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import argparse
import json
import time


def build_cora_replica(tmp):
    import shutil
    from stochastic_gcn_tpu.data.fixtures import (PlanetoidSpec,
                                                  write_planetoid_fixture)
    d = os.path.join(tmp, "cora_replica")
    shutil.rmtree(d, ignore_errors=True)   # also drops stale loader caches
    spec = PlanetoidSpec(name="cora", num_train=140,
                         num_extra=2708 - 140 - 1000, num_val=500,
                         num_test=1000, feature_dim=1433, num_classes=7,
                         avg_degree=4, homophily=0.6, words_per_node=5,
                         seed=7)
    write_planetoid_fixture(d, spec)
    return d


def build_ppi_replica(tmp):
    import shutil
    from stochastic_gcn_tpu.data.fixtures import write_graphsage_fixture
    d = os.path.join(tmp, "ppi_replica")
    shutil.rmtree(d, ignore_errors=True)   # also drops stale loader caches
    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, "ppi")
    write_graphsage_fixture(prefix, num_nodes=2000, feature_dim=50,
                            num_classes=10, avg_degree=6, multilabel=True,
                            num_broken=5, seed=8)
    return prefix


# (name, config overrides) — grid per scripts/run_experiments.py::GRID;
# eval side is exact (test_degree huge; CV eval converges to exact via
# num_layers+1 test passes)
ALGOS = [
    ("Exact", dict(degree=10000)),
    ("NSPP", dict(degree=1)),
    ("ISPP", dict(degree=1, importance=True)),
    ("CVPP", dict(degree=1, cv=True, test_cv=True)),
    ("CVDPP", dict(degree=1, cv=True, cvd=True, test_cv=True,
                   test_cvd=True)),
]


def run_grid(make_cfg, ds, log, seeds=(1,)):
    """Train the algorithm grid; metrics averaged over ``seeds`` (the PPI
    replica is small enough that single-seed final micro-F1 has sigma
    ~0.02 — measured — so parity must be judged on a seed mean, exactly
    why the reference sweeps multi-seed, run-experiments.py:39-74)."""
    from stochastic_gcn_tpu.training.loop import Trainer
    out = {}
    trunc_frac = 0.0
    for name, over in ALGOS:
        t0 = time.time()
        acc = {"val_acc": [], "val_micro_f1": [], "test_acc": [],
               "test_micro_f1": []}
        for seed in seeds:
            tr = Trainer(make_cfg(**over).replace(seed=seed), ds)
            trunc_frac = max(trunc_frac, tr.truncated_edges_frac)
            tr.sgd_train(log=lambda *a: None, max_epochs=None)
            vloss, vacc, vmicro, _, _ = tr.evaluate(ds.val_d)
            tacc, tmicro, _ = tr.run_tests(log=lambda *a: None)
            for k, v in [("val_acc", vacc), ("val_micro_f1", vmicro),
                         ("test_acc", tacc), ("test_micro_f1", tmicro)]:
                acc[k].append(float(v))
            del tr
        out[name] = {k: round(sum(v) / len(v), 4) for k, v in acc.items()}
        out[name]["per_seed_test_micro_f1"] = [round(v, 4)
                                               for v in acc["test_micro_f1"]]
        log(f"  {name:6s} val_acc={out[name]['val_acc']:.4f} "
            f"test_acc={out[name]['test_acc']:.4f} "
            f"micro_f1={out[name]['test_micro_f1']:.4f}  "
            f"({time.time()-t0:.0f}s, {len(seeds)} seeds)")
    # a lossy CV full term must be visible in the artifact, not just the
    # flat_csr UserWarning; 0.0 on padded graphs
    out["truncated_edges_frac"] = trunc_frac
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--tol", type=float, default=0.08)
    ap.add_argument("--cv_tol", type=float, default=0.025)
    ap.add_argument("--tmp", default="/tmp/replica_validation")
    ap.add_argument("--out", default=os.path.join(_ROOT,
                                                  "REPLICA_VALIDATION.json"))
    ap.add_argument("--history_dtype", default="float32",
                    help="history buffer dtype applied to every algo "
                         "(bfloat16 validates the fast-history option "
                         "against the same acceptance bands)")
    ap.add_argument("--features_dtype", default="float32",
                    help="device feature-table dtype applied to every "
                         "algo (bfloat16 validates the half-footprint "
                         "feature option against the same bands)")
    ap.add_argument("--algos", default=None,
                    help="comma-separated subset of the grid to run "
                         "(e.g. Exact,CVPP,CVDPP); Exact is always "
                         "included as the parity anchor")
    ap.add_argument("--dp", type=int, default=1,
                    help="run every algo through the SHARDED multi-chip "
                         "path (dp-way mesh, node-sharded tables, halo "
                         "exchange) — validates multi-chip training at "
                         "the accuracy-band level, not just step parity")
    ap.add_argument("--owner_batching", action="store_true",
                    help="with --dp: partition-aware batching + "
                         "owner-aligned fields + rcm relabeling")
    ap.add_argument("--graph_format", default="padded",
                    choices=["padded", "edgelist"],
                    help="edgelist validates the flat-CSR layout "
                         "end-to-end against the same bands")
    ap.add_argument("--fadj_edge_mult", type=float, default=0.0,
                    help="edgelist full-term row budget override (0 = "
                         "config default); set high enough to cover every "
                         "row for an exact full term")
    ap.add_argument("--nofield_dedup", action="store_true",
                    help="validate the no-dedup (append-only) field "
                         "layout against the same acceptance bands "
                         "(schedule() forces dedup back on under "
                         "importance, so ISPP stays dedup-compacted)")
    ap.add_argument("--is_slot_cap", type=int, default=0,
                    help="validate the IS slot cap (is_slot_compact) "
                         "against the ISPP acceptance band")
    ap.add_argument("--fadj_tier", action="store_true",
                    help="validate the two-tier full-neighborhood term "
                         "(exact by construction; band run guards the "
                         "integration)")
    ap.add_argument("--lazy_fullterm", action="store_true",
                    help="validate the epoch-frozen CV anchor "
                         "(--lazy_fullterm: a-bar table full term + "
                         "epoch-start anchors) against the same "
                         "acceptance bands — this one is a real "
                         "estimator-semantics variant, not just a "
                         "kernel swap")
    args = ap.parse_args()
    if args.algos:
        keep = set(a.strip() for a in args.algos.split(",")) | {"Exact"}
        ALGOS[:] = [a for a in ALGOS if a[0] in keep]

    if args.platform == "cpu":
        os.environ.setdefault("XLA_FLAGS",
                              "--xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    from stochastic_gcn_tpu.config import Config
    from stochastic_gcn_tpu.data import loaders as L

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    log(f"devices: {jax.devices()}")
    results = {"device": str(jax.devices()[0])}

    # ---- Cora replica (Planetoid format, gcn normalization) -------------
    log("Cora replica (reference recipe = defaults):")
    cora_dir = build_cora_replica(args.tmp)
    shard_over = {"graph_format": args.graph_format,
                  "features_dtype": args.features_dtype}
    if args.fadj_edge_mult:
        shard_over["fadj_edge_mult"] = args.fadj_edge_mult
    if args.nofield_dedup:
        shard_over["field_dedup"] = False
    if args.is_slot_cap:
        shard_over["is_slot_cap"] = args.is_slot_cap
    if args.fadj_tier:
        shard_over["fadj_tier"] = True
        # force the tiered path at replica-scale field sizes (the
        # TIER_MIN_ROWS perf gate would otherwise leave it untraced)
        os.environ["SGT_TIER_MIN_ROWS"] = "0"
    if args.lazy_fullterm:
        shard_over["lazy_fullterm"] = True
    if args.dp > 1:
        shard_over.update(dp=args.dp, owner_batching=args.owner_batching,
                          partition_nodes="rcm" if args.owner_batching
                          else "none")
    base = Config(dataset="cora", data_dir=cora_dir, test_degree=10000,
                  epochs=200, early_stopping=10, seed=1,
                  history_dtype=args.history_dtype,
                  batch_size=1000 - 1000 % max(1, args.dp),
                  test_batch_size=1000 - 1000 % max(1, args.dp),
                  **shard_over)
    ds = L.load_gcn_data("cora", base)
    results["cora_replica"] = run_grid(
        lambda **ov: base.replace(**ov), ds, log, seeds=(1, 2, 3))

    # ---- PPI replica (GraphSAGE format, multilabel sigmoid) -------------
    log("PPI replica (scaled reference recipe):")
    prefix = build_ppi_replica(args.tmp)
    base_ppi = Config(dataset="ppi", normalization="graphsage",
                      weight_decay=0.0, dropout=0.2, layer_norm=True,
                      batch_size=256, test_batch_size=256, hidden1=64,
                      num_fc_layers=2, test_degree=10000, epochs=200,
                      early_stopping=50, seed=1,
                      history_dtype=args.history_dtype, **shard_over)
    ds_ppi = L.load_graphsage_data(prefix, base_ppi)
    results["ppi_replica"] = run_grid(
        lambda **ov: base_ppi.replace(**ov), ds_ppi, log, seeds=(1, 2, 3))

    # ---- acceptance ------------------------------------------------------
    failures = []
    for dsname, key in [("cora_replica", "test_acc"),
                        ("ppi_replica", "test_micro_f1")]:
        exact = results[dsname]["Exact"][key]
        for algo, r in results[dsname].items():
            if not isinstance(r, dict):      # e.g. truncated_edges_frac
                continue
            tol = args.cv_tol if algo in ("CVPP", "CVDPP") else args.tol
            if r[key] < exact - tol:
                failures.append(
                    f"{dsname}/{algo}: {key} {r[key]} < Exact {exact} - "
                    f"{tol}")
    cora_val = results["cora_replica"]["Exact"]["val_acc"]
    if not 0.74 <= cora_val <= 0.86:
        failures.append(
            f"cora_replica Exact val_acc {cora_val} outside the calibrated "
            "band [0.74, 0.86]")

    results["failures"] = failures
    results["passed"] = not failures
    results["truncated_edges_frac"] = max(
        results[d].get("truncated_edges_frac", 0.0)
        for d in ("cora_replica", "ppi_replica"))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"metric": "replica_estimator_parity",
                      "passed": results["passed"],
                      "failures": failures,
                      "truncated_edges_frac":
                          results["truncated_edges_frac"],
                      "cora_exact_val_acc": cora_val}))
    sys.exit(0 if results["passed"] else 1)


if __name__ == "__main__":
    main()
