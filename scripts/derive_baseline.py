"""Derive the reference-throughput proxy from MEASUREMENT.

The reference publishes no absolute throughput, so bench.py's
``vs_baseline`` needs a proxy.  Round 1 asserted 1.0e5 sampled-edges/s;
this script replaces the assertion with arithmetic from measured parts:

1. **Host scheduler + copy-out + feature slice** — the reference's per-step
   C++/Cython critical path, measured by compiling the reference's OWN
   scheduler.cpp/mult.cpp (csrc/ref_sched_bench.cpp) and driving it with
   the bench graph at the Reddit recipe (batch 512, degree 1, cv).  This
   path is strictly serial with everything else in the reference's
   single-process loop (train.py:190-207: scheduler -> get_data ->
   sess.run).
2. **feed_dict host->device copy** — bytes counted from the measured
   per-step tensor sizes, divided by an OPTIMISTIC 12 GB/s effective PCIe
   gen3 bandwidth (the era's hardware, README.md:12).
3. **GPU compute** — EXCLUDED (assumed free / perfectly overlapped), which
   is generous to the reference: sess.run is synchronous in its loop.

reference_step_time >= (1) + (2)   =>   edges/s <= adj_edges / step_time.

Writes the derived numbers; paste the result into bench.py's
REFERENCE_EDGES_PER_S and BASELINE.md.
"""
import sys, os
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import json
import subprocess

import numpy as np

REF = "/root/reference/gcn"
PCIE_GBPS = 12.0   # optimistic effective host->device bandwidth


def dump_graph(path):
    from bench import build_reddit_like, FEAT_DIM, PAD_DEG
    from stochastic_gcn_tpu.data.preprocess import cap_adj_degree
    ds = build_reddit_like()
    # the reference applies --max_degree at load (utils.py:261-263); use the
    # same cap as bench.py so the two pipelines sample the same graph
    adj = cap_adj_degree(ds.train_adj, PAD_DEG, seed=0)
    adj = adj.astype(np.float32)
    adj.sort_indices()
    with open(path, "wb") as f:
        for v in (adj.shape[0], adj.nnz, len(ds.train_d), FEAT_DIM):
            f.write(np.int32(v).tobytes())
        f.write(adj.indptr.astype(np.int32).tobytes())
        f.write(adj.indices.astype(np.int32).tobytes())
        f.write(adj.data.astype(np.float32).tobytes())
        f.write(ds.train_d.astype(np.int32).tobytes())
    return ds


def main():
    bin_path = "/tmp/ref_sched_bench"
    graph_path = "/tmp/ref_sched_graph.bin"
    print("building reference scheduler bench...", file=sys.stderr)
    subprocess.run(
        ["g++", "-O2", "-std=c++11", f"-I{REF}",
         os.path.join(_ROOT, "csrc", "ref_sched_bench.cpp"),
         f"{REF}/scheduler.cpp", f"{REF}/mult.cpp", "-o", bin_path],
        check=True)
    print("dumping bench graph...", file=sys.stderr)
    dump_graph(graph_path)

    results = {}
    for batch, steps in [(512, 300), (4096, 60)]:
        out = subprocess.run(
            [bin_path, graph_path, str(batch), str(steps)],
            check=True, capture_output=True, text=True)
        print(out.stderr, file=sys.stderr, end="")
        r = json.loads(out.stdout)

        # feed_dict bytes/step: field features [F, feat_dim] f32 + labels
        # [batch, 41] f32 + adj COO (2 int32 + f32 per edge, x2: adj + madj
        # carry the same nnz under cv) + fadj COO + fields int32
        fd_bytes = (r["field_per_step"] * r["feat_dim"] * 4
                    + r["batch"] * 41 * 4
                    + r["adj_edges_per_step"] * 12 * 2
                    + r["fadj_edges_per_step"] * 12
                    + (r["field_per_step"] + r["batch"]) * 4)
        copy_ms = fd_bytes / (PCIE_GBPS * 1e9) * 1e3
        host_ms = (r["sched_ms_per_step"] + r["copy_ms_per_step"]
                   + r["slice_ms_per_step"])
        step_ms = host_ms + copy_ms
        edges_per_s = r["adj_edges_per_step"] / (step_ms / 1e3)
        results[f"batch{batch}"] = {
            **r,
            "feed_dict_bytes_per_step": round(fd_bytes),
            "pcie_copy_ms_per_step": round(copy_ms, 4),
            "derived_min_step_ms": round(step_ms, 4),
            "derived_max_edges_per_s": round(edges_per_s, 1),
        }
        print(f"batch {batch}: host {host_ms:.3f} ms + pcie {copy_ms:.3f} "
              f"ms => step >= {step_ms:.3f} ms, adj edges/step "
              f"{r['adj_edges_per_step']:.0f} => reference edges/s <= "
              f"{edges_per_s:,.0f}", file=sys.stderr)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
