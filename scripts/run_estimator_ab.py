"""Multi-seed estimator time-to-accuracy A/B -> ESTIMATOR_AB.json.

The paper's headline claim ("CVD+PP has similar accuracy with Exact, but
is faster", /root/reference/README.md:44) measured at >= 3 seeds per arm:
single-run wall-clock ordering between CV+PP and CVD+PP can flip run to
run, so the durable record is mean +- std over seeds.  The protocol and
graph are bench.run_estimator_ab's (community SBM with the reference's
0.94-of-plateau threshold protocol, analyze-time.py:12-14).

Run from the repo root on a GPU:
    python scripts/run_estimator_ab.py [--seeds 1,2,3] [--out ...]
"""
import sys, os
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import argparse
import json


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--out", default=os.path.join(_ROOT,
                                                  "ESTIMATOR_AB.json"))
    args = ap.parse_args()
    seeds = tuple(int(s) for s in args.seeds.split(","))

    import bench
    out = bench.run_estimator_ab(seeds=seeds)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    compact = {k: v for k, v in out.items()
               if not isinstance(v, list) or len(v) <= len(seeds)}
    print(json.dumps(compact))


if __name__ == "__main__":
    main()
