// graphlib — native host-side graph runtime for stochastic_gcn_tpu.
//
// Counterpart of the reference's C++ layer:
//   * Fenwick-tree multinomial sampler without replacement
//     (role of gcn/mult.cpp: Mult::Add/Query)
//   * per-row uniform k-without-replacement sampling with unbiased rescale
//     (role of the hot loop in gcn/scheduler.cpp:126-165) — used as the
//     host-side ORACLE for the on-device sampler and for dataset prep
//   * CSR row slicing + dense row gather
//     (role of gcn/history.cpp: c_indptr/c_slice/c_dense_slice)
//   * fast padded-adjacency construction and degree capping for the
//     device-resident PaddedGraph (no reference counterpart; replaces a
//     slow Python loop for multi-million-edge graphs)
//
// Exposed through a plain C ABI consumed via ctypes (pybind11 not available
// in this image).  OpenMP parallel where safe.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ------------------------------------------------------------------
// Fenwick multinomial sampler without replacement.
// Draw ~ p_i / sum(p); drawing zeroes the weight (without replacement),
// matching gcn/mult.cpp:30-51 exactly.
// ------------------------------------------------------------------

struct Mult {
  int n;
  std::vector<double> tree;  // 1-based Fenwick over probabilities
};

void* mult_create(const float* probs, int n) {
  Mult* m = new Mult();
  m->n = n;
  m->tree.assign(n + 1, 0.0);
  for (int i = 1; i <= n; ++i) {
    m->tree[i] += probs[i - 1];
    int j = i + (i & -i);
    if (j <= n) m->tree[j] += m->tree[i];
  }
  return m;
}

void mult_destroy(void* h) { delete static_cast<Mult*>(h); }

double mult_total(void* h) {
  Mult* m = static_cast<Mult*>(h);
  double total = 0.0;
  for (int i = m->n; i > 0; i -= i & -i) total += m->tree[i];
  return total;
}

static void mult_add(Mult* m, int idx, double delta) {
  for (int i = idx + 1; i <= m->n; i += i & -i) m->tree[i] += delta;
}

// Draw an index with probability proportional to the remaining weights and
// remove it.  u must be uniform in [0, 1).
int mult_query(void* h, double u) {
  Mult* m = static_cast<Mult*>(h);
  double target = u * mult_total(h);
  int pos = 0;
  int log2n = 0;
  while ((1 << (log2n + 1)) <= m->n) ++log2n;
  for (int pw = 1 << log2n; pw > 0; pw >>= 1) {
    int nxt = pos + pw;
    if (nxt <= m->n && m->tree[nxt] < target) {
      target -= m->tree[nxt];
      pos = nxt;
    }
  }
  // pos is now the largest prefix with cumsum < target -> drawn index = pos
  int idx = std::min(pos, m->n - 1);
  // remove the drawn weight (without replacement)
  double w = 0.0;
  {  // point query: weight at idx
    int a = idx + 1, b = idx;
    double sa = 0.0, sb = 0.0;
    for (int i = a; i > 0; i -= i & -i) sa += m->tree[i];
    for (int i = b; i > 0; i -= i & -i) sb += m->tree[i];
    w = sa - sb;
  }
  mult_add(m, idx, -w);
  return idx;
}

// ------------------------------------------------------------------
// Per-row uniform k-without-replacement sampling (scheduler.cpp:126-165
// semantics): partial Fisher-Yates over a copy of the row, weights scaled
// by deg/k_eff.  Returns the scale factor.
// ------------------------------------------------------------------

float sample_row(const int* indices, const float* data, int deg, int k,
                 uint64_t seed, int sentinel, int* ids_out, float* w_out) {
  std::mt19937_64 gen(seed);
  std::uniform_real_distribution<float> u01(0.0f, 1.0f);
  int take = std::min(deg, k);
  float scale = (deg == 0) ? 1.0f : (float)deg / (float)std::max(take, 1);

  std::vector<int> idx(deg);
  std::vector<float> w(deg);
  std::memcpy(idx.data(), indices, deg * sizeof(int));
  std::memcpy(w.data(), data, deg * sizeof(float));

  for (int it = 0; it < take; ++it) {
    int remaining = deg - it;
    int j = std::min(it + (int)(remaining * u01(gen)), deg - 1);
    std::swap(idx[it], idx[j]);
    std::swap(w[it], w[j]);
    ids_out[it] = idx[it];
    w_out[it] = w[it] * scale;
  }
  for (int it = take; it < k; ++it) {
    ids_out[it] = sentinel;
    w_out[it] = 0.0f;
  }
  return scale;
}

// ------------------------------------------------------------------
// CSR slicing (gcn/history.cpp:50-88 roles)
// ------------------------------------------------------------------

int64_t slice_nnz(const int* indptr, const int* rows, int nrows) {
  int64_t total = 0;
#if defined(_OPENMP)
#pragma omp parallel for reduction(+ : total)
#endif
  for (int i = 0; i < nrows; ++i)
    total += indptr[rows[i] + 1] - indptr[rows[i]];
  return total;
}

void slice_fill(const int* indptr, const int* indices, const float* data,
                const int* rows, int nrows, const int64_t* out_offsets,
                int* coo_r, int* coo_c, float* vals) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int i = 0; i < nrows; ++i) {
    int64_t o = out_offsets[i];
    for (int p = indptr[rows[i]]; p < indptr[rows[i] + 1]; ++p, ++o) {
      coo_r[o] = i;
      coo_c[o] = indices[p];
      vals[o] = data[p];
    }
  }
}

void dense_slice(const float* x, int64_t dim, const int* rows, int nrows,
                 float* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < nrows; ++i)
    std::memcpy(out + (int64_t)i * dim, x + (int64_t)rows[i] * dim,
                dim * sizeof(float));
}

// ------------------------------------------------------------------
// Padded-adjacency construction (PaddedGraph backing arrays), with optional
// random degree capping (the --max_degree analogue).
// nbr/w must be sized (n+1)*dcap, deg n+1.  Rows longer than dcap keep a
// uniform random subset when cap_random != 0, else the first dcap entries.
// ------------------------------------------------------------------

void build_padded(const int* indptr, const int* indices, const float* data,
                  int n, int dcap, int cap_random, uint64_t seed, int* nbr,
                  float* w, int* deg) {
#if defined(_OPENMP)
#pragma omp parallel
#endif
  {
    std::mt19937_64 gen;
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 256)
#endif
    for (int r = 0; r < n; ++r) {
      int lo = indptr[r], hi = indptr[r + 1];
      int d = hi - lo;
      int64_t base = (int64_t)r * dcap;
      int take = std::min(d, dcap);
      if (d <= dcap || !cap_random) {
        for (int s = 0; s < take; ++s) {
          nbr[base + s] = indices[lo + s];
          w[base + s] = data[lo + s];
        }
      } else {
        // reservoir sample dcap of d entries
        gen.seed(seed + (uint64_t)r * 0x9E3779B97F4A7C15ULL);
        std::vector<int> pick(dcap);
        for (int s = 0; s < dcap; ++s) pick[s] = s;
        std::uniform_real_distribution<double> u01(0.0, 1.0);
        for (int s = dcap; s < d; ++s) {
          int j = (int)(u01(gen) * (s + 1));
          if (j < dcap) pick[j] = s;
        }
        for (int s = 0; s < dcap; ++s) {
          nbr[base + s] = indices[lo + pick[s]];
          w[base + s] = data[lo + pick[s]];
        }
      }
      for (int s = take; s < dcap; ++s) {
        nbr[base + s] = n;
        w[base + s] = 0.0f;
      }
      deg[r] = take;
    }
  }
  // sentinel row
  int64_t base = (int64_t)n * dcap;
  for (int s = 0; s < dcap; ++s) {
    nbr[base + s] = n;
    w[base + s] = 0.0f;
  }
  deg[n] = 0;
}

// max row degree of a CSR (for choosing dcap)
int max_degree(const int* indptr, int n) {
  int best = 0;
#if defined(_OPENMP)
#pragma omp parallel for reduction(max : best)
#endif
  for (int r = 0; r < n; ++r)
    best = std::max(best, indptr[r + 1] - indptr[r]);
  return best;
}

}  // extern "C"
