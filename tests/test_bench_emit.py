"""bench.py output contract: a tail capture records
only the last ~2000 chars of combined output and parses the final JSON
line, so the headline must be the LAST, COMPACT stdout line with
trajectories split off to BENCH_VERBOSE.json / an earlier line."""

import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _full_result():
    r = {"metric": "reddit_like_cvpp_deg1_sampled_edges_per_s",
         "value": 1325000.1, "unit": "edges/s", "vs_baseline": 3.397,
         "steps_per_s": 2590.0, "step_ms": 0.39, "loss": 3.7133,
         "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
         "device_count": 1, "card": "NVIDIA H100 80GB HBM3",
         "power_limit": "700.00 W", "edges_per_s_batch4096": 3280000.0,
         "vs_baseline_batch4096": 27.3, "edges_per_s_dedup": 900000.0,
         "edges_per_s_dedup_batch4096": 2500000.0,
         "edges_per_s_is_batch4096": 410000.0,
         "edges_per_s_is_cap0_batch4096": 310000.0,
         "convergence_target_micro_f1": 0.4,
         "convergence_epochs_to_target": 97,
         "convergence_seconds_to_target": 61.2,
         "convergence_best_micro_f1": 0.4012, "convergence_epochs_run": 97,
         "ab_target_micro_f1": 0.9, "ab_seeds": [1, 2, 3],
         "edges_per_s_f32_history": 657000.0,
         "vs_baseline_f32_history": 1.685}
    for name in ("exact", "nspp", "cvpp", "cvdpp"):
        for k, v in (("epochs_to_target", 3), ("seconds_to_target", 5.1),
                     ("data_to_target", 130000), ("best_micro_f1", 0.99),
                     ("plateau_micro_f1", 0.99), ("epoch_train_s", 1.2)):
            r[f"ab_{name}_{k}"] = v
        r[f"ab_{name}_trajectory"] = [round(0.5 + i * 0.01, 4)
                                      for i in range(40)]
        r[f"ab_{name}_seconds_to_target_per_seed"] = [5.0, 5.1, 5.2]
        r[f"ab_{name}_epochs_to_target_per_seed"] = [3, 3, 4]
    r["ab_cvdpp_speedup_vs_exact"] = 9.3
    r["ab_cvpp_speedup_vs_exact"] = 7.1
    return r


def test_emit_headline_survives_tail_capture(tmp_path, monkeypatch):
    import bench
    monkeypatch.chdir(tmp_path)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench._emit(_full_result())
    out = buf.getvalue()
    last = out.strip().split("\n")[-1]
    # the final line is compact and parses on its own
    assert len(last) <= bench._COMPACT_BUDGET
    parsed = json.loads(last)
    # headline keys survive
    for k in ("metric", "value", "unit", "vs_baseline", "step_ms",
              "platform", "device_kind", "card", "power_limit",
              "ab_cvdpp_speedup_vs_exact"):
        assert k in parsed, k
    # the driver's tail capture (last 2000 chars, last JSON line) parses
    tail = out[-2000:]
    tail_last = tail.strip().split("\n")[-1]
    assert json.loads(tail_last)["vs_baseline"] == 3.397
    # verbose record written with EVERYTHING (trajectories included)
    v = json.load(open(tmp_path / "BENCH_VERBOSE.json"))
    assert v["ab_exact_trajectory"][0] == 0.5
    assert v["value"] == 1325000.1


def test_emit_partial_contract(tmp_path, monkeypatch):
    """_emit_partial keeps the metric/value/unit/vs_baseline + error keys
    in the final line even mid-run."""
    import bench
    monkeypatch.chdir(tmp_path)
    bench._RESULT.clear()
    bench._RESULT.update({"steps_per_s": 100.0})
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            bench._emit_partial("section failed", 3)
    except SystemExit as e:
        assert e.code == 3
    last = buf.getvalue().strip().split("\n")[-1]
    p = json.loads(last)
    assert p["value"] is None and "error" in p and p["steps_per_s"] == 100.0
    bench._RESULT.clear()
