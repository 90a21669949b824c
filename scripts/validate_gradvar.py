"""Gradient-variance parity record — the reference's var suite
(scripts/run-experiments.py var_exps + scripts/plot-var.py:24-48) on the
Cora replica dataset.

Protocol per the reference: train ONCE with CV+PP (VarTrainCV /
DVarTrainCV), then for each estimator reload the trained weights (+
histories) and run the GradientVariance harness (train.py:241-277 —
`times` full-graph and sampled pred/grad passes; bias/stdev of the
first-layer weight gradient, normalized by the full-gradient magnitude).
Grid: {NS (no PP), NS+PP, IS+PP, CV+PP} without dropout and {NS, NS+PP,
IS+PP, CV+PP, CVD+PP, DET+PP (det_dropout)} with dropout — the reference's
VarNS/VarNSPP/VarCV and DVar* rows plus the IS and det_dropout arms the
harness supports (train.py:241-277 runs any flag combination).

Expected orderings asserted (the paper's Fig. 4 / plot-var content):
* without dropout, CV's gradient bias ~ 0 at convergence (Theorem 2) and
  its stdev is below NS+PP's;
* with dropout, CV is no longer bias-free but CVD's stdev stays below
  NS+PP's (variance-corrected dropout);
* every sampled estimator's bias/stdev is finite and recorded.

Writes GRADVAR_VALIDATION.json at the repo root; exits nonzero on a
failed ordering.  ~6 min on CPU (default); --platform gpu for the GPU.
"""
import sys, os
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import argparse
import json
import time

from validate_replica import build_cora_replica  # noqa: E402 (same dir)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--times", type=int, default=400,
                    help="resamples per estimator (reference uses 1000; "
                         "400 gives the same orderings in a third of the "
                         "time — stdev estimates are +-5% at 400)")
    ap.add_argument("--tmp", default="/tmp/gradvar_validation")
    ap.add_argument("--out", default=None,
                    help="output JSON (default GRADVAR_VALIDATION.json, "
                         "or GRADVAR_VALIDATION_DP<P>.json with --dp)")
    ap.add_argument("--dp", type=int, default=1,
                    help="run the bias/stdev instrument through the "
                         "SHARDED pred_and_grad (dp-way mesh, node-"
                         "sharded tables, halo transports) — the code "
                         "path where a transport bug would corrupt "
                         "estimates silently")
    ap.add_argument("--owner_batching", action="store_true",
                    help="with --dp: owner-aligned fields + rcm")
    ap.add_argument("--graph_format", default="padded",
                    choices=["padded", "edgelist"])
    ap.add_argument("--algos", default=None,
                    help="comma-separated subset (e.g. NSPP,CVPP,CVDPP)")
    args = ap.parse_args()
    if args.out is None:
        args.out = os.path.join(
            _ROOT, "GRADVAR_VALIDATION.json" if args.dp == 1
            else f"GRADVAR_VALIDATION_DP{args.dp}.json")

    if args.platform == "cpu":
        os.environ.setdefault(
            "XLA_FLAGS",
            f"--xla_force_host_platform_device_count={max(args.dp, 1)}")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    from stochastic_gcn_tpu.config import Config
    from stochastic_gcn_tpu.data import loaders as L
    from stochastic_gcn_tpu.training.loop import Trainer

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    cora_dir = build_cora_replica(args.tmp)

    shard_over = {"graph_format": args.graph_format}
    if args.dp > 1:
        shard_over.update(dp=args.dp, owner_batching=args.owner_batching,
                          partition_nodes="rcm" if args.owner_batching
                          else "none")

    results = {"device": str(jax.devices()[0]), "times": args.times,
               "dp": args.dp, "owner_batching": args.owner_batching,
               "graph_format": args.graph_format}
    t_all = time.time()

    # (suite, measurement overrides shared by the suite, trainer extras,
    # [(algo, gradvar overrides), ...]) — reference var_exps rows;
    # D* = with dropout (run-experiments.py:23-32).  The suite's dropout
    # setting applies to the MEASUREMENT configs too (the reference's
    # var.sh passes --dropout 0 to both the train and --gradvar runs).
    suites = [
        ("nodrop", dict(dropout=0.0), dict(cv=True, test_cv=True, degree=1),
         [("NS", dict(degree=1, preprocess=False, test_preprocess=False,
                      cv=False, test_cv=False)),
          ("NSPP", dict(degree=1, cv=False, test_cv=False)),
          ("ISPP", dict(degree=1, cv=False, test_cv=False,
                        importance=True, test_importance=True)),
          ("CVPP", dict(degree=1, cv=True, test_cv=True))]),
        ("dropout", dict(), dict(cv=True, test_cv=True, degree=1),
         [("NS", dict(degree=1, preprocess=False, test_preprocess=False,
                      cv=False, test_cv=False)),
          ("NSPP", dict(degree=1, cv=False, test_cv=False)),
          ("ISPP", dict(degree=1, cv=False, test_cv=False,
                        importance=True, test_importance=True)),
          ("CVPP", dict(degree=1, cv=True, test_cv=True))]),
        ("dropout_cvd", dict(),
         dict(cv=True, cvd=True, test_cv=True, test_cvd=True, degree=1),
         [("CVDPP", dict(degree=1, cv=True, cvd=True, test_cv=True,
                         test_cvd=True))]),
        # det_dropout (mu, sigma^2) moment propagation — the reference's
        # --det_dropout research mode (gcn/layers.py:141-202); trains and
        # measures with CV like the CVD suite (train.py runs any flag
        # combination, train.py:241-277)
        ("dropout_det", dict(),
         dict(cv=True, test_cv=True, det_dropout=True, degree=1),
         [("DETPP", dict(degree=1, cv=True, test_cv=True,
                         det_dropout=True))]),
    ]

    if args.algos:
        keep = {a.strip() for a in args.algos.split(",")}
        suites = [(s, so, to, [a for a in algos if a[0] in keep])
                  for s, so, to, algos in suites]
        suites = [s for s in suites if s[3]]

    for suite, suite_over, train_over, algos in suites:
        ckpt = os.path.join(args.tmp, f"ckpt_{suite}")
        # no early stopping: Theorem 2's zero-bias claim needs CONVERGED
        # weights (histories == exact activations of the final params);
        # the reference's var suite likewise trains its full budget
        base = Config(dataset="cora", data_dir=cora_dir, test_degree=10000,
                      epochs=200, early_stopping=100000, seed=1,
                      batch_size=1000, test_batch_size=1000,
                      history_dtype="float32",   # estimator-math record
                      ckpt_dir=ckpt, **suite_over, **shard_over)
        ds = L.load_gcn_data("cora", base)
        t0 = time.time()
        tr = Trainer(base.replace(**train_over), ds)
        tr.sgd_train(log=lambda *a: None)
        log(f"[{suite}] trained CV model in {time.time()-t0:.0f}s")
        del tr

        res = {}
        for name, over in algos:
            cfg = base.replace(gradvar=True, load=True, **over)
            tr = Trainer(cfg, ds)
            tr.load()
            if tr.state.histories:
                # Theorem 2's zero-bias claim holds when histories equal
                # the exact activations of the measured weights (the
                # converged regime).  num_layers+1 exact eval passes
                # converge the eval-side histories (train.py:339-341);
                # copy them into the train-side buffers the sampled
                # estimator reads.
                import dataclasses as dc
                import numpy as _np
                all_ids = _np.arange(ds.num_data, dtype=_np.int32)
                for _ in range(cfg.num_layers + 1):
                    tr.evaluate(all_ids)
                tr.state = dc.replace(tr.state,
                                      histories=tr.eval_histories)
            t0 = time.time()
            r = tr.gradient_variance(times=args.times, log=lambda *a: None)
            res[name] = {k: round(float(v), 5) for k, v in r.items()}
            log(f"[{suite}] {name:6s} grad_bias={res[name]['grad_bias']:.4f} "
                f"grad_stdev={res[name]['grad_stdev']:.4f} "
                f"(full_stdev={res[name]['full_grad_stdev']:.4f}, "
                f"{time.time()-t0:.0f}s)")
            del tr
        results[suite] = res

    # ---- ordering assertions (plot-var.py's content) ---------------------
    # each assertion runs only when its arms were measured (--algos can
    # select a subset, e.g. the dp8 CVPP+CVDPP minimum)
    failures = []
    nd = results.get("nodrop", {})
    dr = results.get("dropout", {})
    cvd = results.get("dropout_cvd", {}).get("CVDPP")

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    def have(*rs):
        return all(r is not None and r != {} for r in rs)

    # Theorem 2 at convergence: the CV FORWARD is exactly the full forward
    # (prediction bias AND stdev identically zero over resamples — a
    # stronger check than the reference's bar chart).  Gradients flow
    # through the SAMPLED adjacency (h-bar is a constant w.r.t. params),
    # so they are unbiased-but-noisy: the measured grad "bias" must be
    # statistically indistinguishable from zero (within 3 standard errors
    # of the resample mean), while NS+PP's is a REAL bias (>3 SE).
    import math
    se = lambda r: r["grad_stdev"] / math.sqrt(args.times)
    if have(nd.get("CVPP")):
        check(nd["CVPP"]["pred_bias"] < 1e-5
              and nd["CVPP"]["pred_stdev"] < 1e-5,
              f"no-dropout CV forward not exact: pred_bias="
              f"{nd['CVPP']['pred_bias']}, "
              f"pred_stdev={nd['CVPP']['pred_stdev']}"
              " (Theorem 2: CV inference is exact at convergence)")
        check(nd["CVPP"]["grad_bias"] < 3 * se(nd["CVPP"]),
              f"no-dropout CV grad bias {nd['CVPP']['grad_bias']} exceeds "
              f"3 SE ({3 * se(nd['CVPP']):.4f}) — real bias, should be "
              "zero")
    if have(nd.get("NSPP")):
        check(nd["NSPP"]["grad_bias"] > 3 * se(nd["NSPP"]),
              f"no-dropout NS+PP grad bias {nd['NSPP']['grad_bias']} not "
              "significant — expected a real bias (the paper's motivating "
              "observation)")
    if have(nd.get("CVPP"), nd.get("NSPP")):
        check(nd["CVPP"]["grad_stdev"] < nd["NSPP"]["grad_stdev"],
              f"no-dropout CV grad stdev {nd['CVPP']['grad_stdev']} not "
              f"below NS+PP {nd['NSPP']['grad_stdev']}")
    if have(cvd, dr.get("NSPP")):
        check(cvd["grad_stdev"] < dr["NSPP"]["grad_stdev"],
              f"dropout CVD grad stdev {cvd['grad_stdev']} not below NS+PP "
              f"{dr['NSPP']['grad_stdev']}")
    # IS is a PlainGCN-family estimator: like NS+PP its bias through the
    # nonlinearity is REAL (the paper's motivating observation); record and
    # require significance, no stdev ordering is claimed for it.
    if have(nd.get("ISPP")):
        check(nd["ISPP"]["grad_bias"] > 3 * se(nd["ISPP"]),
              f"no-dropout IS+PP grad bias {nd['ISPP']['grad_bias']} not "
              "significant — expected the NS-family bias")
    for suite, res in (("nodrop", nd), ("dropout", dr),
                       ("dropout_cvd", results.get("dropout_cvd", {})),
                       ("dropout_det", results.get("dropout_det", {}))):
        for algo, r in res.items():
            import math
            check(all(math.isfinite(v) for v in r.values()),
                  f"{suite}/{algo}: non-finite stats {r}")

    results["failures"] = failures
    results["passed"] = not failures
    results["wall_s"] = round(time.time() - t_all, 1)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    summary = {"metric": "gradvar_parity", "passed": not failures,
               "failures": failures, "dp": args.dp}
    if have(nd.get("CVPP")):
        summary["cv_nodrop_grad_bias"] = nd["CVPP"]["grad_bias"]
        summary["cv_nodrop_grad_stdev"] = nd["CVPP"]["grad_stdev"]
    if have(nd.get("NSPP")):
        summary["nspp_nodrop_grad_stdev"] = nd["NSPP"]["grad_stdev"]
    print(json.dumps(summary))
    sys.exit(0 if not failures else 1)


if __name__ == "__main__":
    main()
