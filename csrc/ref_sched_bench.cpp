// Measure the REFERENCE's host-side per-minibatch cost (the proxy
// baseline is derived, not asserted).
//
// Compiled against the reference's own scheduler.cpp/mult.cpp from
// /root/reference/gcn (sources read at BUILD time; nothing vendored):
//
//   g++ -O2 -std=c++11 -I/root/reference/gcn csrc/ref_sched_bench.cpp \
//       /root/reference/gcn/scheduler.cpp /root/reference/gcn/mult.cpp \
//       -o /tmp/ref_sched_bench
//
// Drives Scheduler exactly as PyScheduler.batch does (_scheduler.pyx:55-66):
// start_batch(batch_ids) then expand(degree) per layer, here L=1 / degree=1 /
// cv=true — the Reddit CV+PP recipe.  After each batch it memcpy's every
// output vector into preallocated buffers (the pyx does the same into numpy,
// _scheduler.pyx:69-119) and row-copies the input-field feature slice
// (vrgcn.py:39-47 / history.cpp::c_dense_slice equivalent).  Reports
// ms/step and the per-step sampled/full edge counts; the python wrapper
// (scripts/derive_baseline.py) turns this into a derived edges/s bound.
//
// Input file format (see scripts/derive_baseline.py): little-endian
//   int32 n, int32 nnz, int32 n_train, int32 feat_dim
//   int32 indptr[n+1], int32 indices[nnz], float32 data[nnz],
//   int32 train_ids[n_train]
#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

#include "scheduler.h"

int main(int argc, char **argv) {
    if (argc < 4) {
        fprintf(stderr,
                "usage: %s graph.bin batch_size n_steps [degree=1]\n",
                argv[0]);
        return 1;
    }
    FILE *f = fopen(argv[1], "rb");
    if (!f) { perror("open"); return 1; }
    int batch = atoi(argv[2]);
    int steps = atoi(argv[3]);
    int degree = argc > 4 ? atoi(argv[4]) : 1;

    int n, nnz, n_train, feat_dim;
    if (fread(&n, 4, 1, f) != 1 || fread(&nnz, 4, 1, f) != 1 ||
        fread(&n_train, 4, 1, f) != 1 || fread(&feat_dim, 4, 1, f) != 1) {
        fprintf(stderr, "bad header\n");
        return 1;
    }
    std::vector<int> indptr(n + 1), indices(nnz), train_ids(n_train);
    std::vector<float> data(nnz);
    if (fread(indptr.data(), 4, n + 1, f) != (size_t)n + 1 ||
        fread(indices.data(), 4, nnz, f) != (size_t)nnz ||
        fread(data.data(), 4, nnz, f) != (size_t)nnz ||
        fread(train_ids.data(), 4, n_train, f) != (size_t)n_train) {
        fprintf(stderr, "bad body\n");
        return 1;
    }
    fclose(f);
    fprintf(stderr, "graph: n=%d nnz=%d train=%d feat_dim=%d\n", n, nnz,
            n_train, feat_dim);

    // feature matrix for the dense_slice cost (values irrelevant)
    std::vector<float> feats((size_t)n * feat_dim, 0.5f);

    Scheduler sch(data.data(), indices.data(), indptr.data(), n, nnz,
                  /*L=*/1, /*cv=*/true, /*is=*/false);
    sch.seed(1);

    std::mt19937 rng(0);
    std::vector<int> order(train_ids);

    // preallocated copy-out buffers (grown on demand), mirroring the numpy
    // copies in _scheduler.pyx:69-119
    std::vector<int> out_i;
    std::vector<float> out_f, slice_buf;

    long long tot_edges = 0, tot_fedges = 0, tot_field = 0;
    double sched_ms = 0.0, copy_ms = 0.0, slice_ms = 0.0;
    int cursor = 0;

    auto now = [] { return std::chrono::steady_clock::now(); };
    for (int s = 0; s < steps; ++s) {
        if (cursor + batch > (int)order.size()) {
            std::shuffle(order.begin(), order.end(), rng);
            cursor = 0;
        }
        auto t0 = now();
        sch.start_batch(batch, order.data() + cursor);
        cursor += batch;
        sch.expand(degree);
        auto t1 = now();

        // copy-out: every vector PyScheduler.batch materializes
        size_t ne = sch.edg_s.size(), nfe = sch.fedg_s.size();
        size_t nf = sch.field.size(), nff = sch.ffield.size();
        out_i.resize(2 * ne + 2 * nfe + nf + nff);
        out_f.resize(ne + nfe + sch.medg_w.size() + sch.scales.size());
        int *pi = out_i.data();
        memcpy(pi, sch.edg_s.data(), ne * 4); pi += ne;
        memcpy(pi, sch.edg_t.data(), ne * 4); pi += ne;
        memcpy(pi, sch.fedg_s.data(), nfe * 4); pi += nfe;
        memcpy(pi, sch.fedg_t.data(), nfe * 4); pi += nfe;
        memcpy(pi, sch.field.data(), nf * 4); pi += nf;
        memcpy(pi, sch.ffield.data(), nff * 4);
        float *pf = out_f.data();
        memcpy(pf, sch.edg_w.data(), ne * 4); pf += ne;
        memcpy(pf, sch.fedg_w.data(), nfe * 4); pf += nfe;
        memcpy(pf, sch.medg_w.data(), sch.medg_w.size() * 4);
        pf += sch.medg_w.size();
        memcpy(pf, sch.scales.data(), sch.scales.size() * 4);
        auto t2 = now();

        // input-feature dense row slice over the expanded field
        // (vrgcn.py:39-47; history.cpp:74-88)
        slice_buf.resize(nf * (size_t)feat_dim);
        for (size_t r = 0; r < nf; ++r)
            memcpy(slice_buf.data() + r * feat_dim,
                   feats.data() + (size_t)sch.field[r] * feat_dim,
                   feat_dim * 4);
        auto t3 = now();

        tot_edges += (long long)ne;
        tot_fedges += (long long)nfe;
        tot_field += (long long)nf;
        sched_ms += std::chrono::duration<double, std::milli>(t1 - t0)
                        .count();
        copy_ms += std::chrono::duration<double, std::milli>(t2 - t1)
                       .count();
        slice_ms += std::chrono::duration<double, std::milli>(t3 - t2)
                        .count();
    }

    // one JSON line for scripts/derive_baseline.py
    printf("{\"steps\": %d, \"batch\": %d, \"degree\": %d, "
           "\"sched_ms_per_step\": %.4f, \"copy_ms_per_step\": %.4f, "
           "\"slice_ms_per_step\": %.4f, \"adj_edges_per_step\": %.1f, "
           "\"fadj_edges_per_step\": %.1f, \"field_per_step\": %.1f, "
           "\"feat_dim\": %d}\n",
           steps, batch, degree, sched_ms / steps, copy_ms / steps,
           slice_ms / steps, (double)tot_edges / steps,
           (double)tot_fedges / steps, (double)tot_field / steps, feat_dim);
    return 0;
}
