// Host C++ kernels of the PyTorch port, copied from the JAX package's
// native/host_kernels.cpp (same functions, same C ABI, same results).
// Built by native/__init__.py with g++ on first use and loaded via ctypes:
//
//   wae_rcm        — reverse Cuthill–McKee bandwidth reduction (the BFS
//                    before every BSR layout, ops/reorder.py)
//   wae_coo_dedup  — sort + duplicate-sum of assembly COO triplets
//                    (ops/sparse.py::coo_sum_duplicates semantics)
//   wae_csr_spmm   — multithreaded complex CSR × dense panel product
//                    (the slab solver's exact host residuals)
//
// All functions use a plain C ABI; complex arrays are passed as interleaved
// double pairs (re, im).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

extern "C" {

// Reverse Cuthill–McKee on a symmetric adjacency in CSR form.
// indptr[n+1], indices[nnz] must describe a symmetrized graph without
// self-loops.  perm_out[n] receives the new->old permutation.
void wae_rcm(int64_t n, const int64_t* indptr, const int64_t* indices,
             int64_t* perm_out) {
    std::vector<int64_t> degree(n);
    for (int64_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];

    std::vector<int64_t> seeds(n);
    std::iota(seeds.begin(), seeds.end(), 0);
    std::stable_sort(seeds.begin(), seeds.end(),
                     [&](int64_t a, int64_t b) { return degree[a] < degree[b]; });

    std::vector<char> visited(n, 0);
    std::vector<int64_t> queue;
    queue.reserve(n);
    int64_t pos = 0;
    std::vector<int64_t> nb;
    for (int64_t s : seeds) {
        if (visited[s]) continue;
        visited[s] = 1;
        size_t head = queue.size();
        queue.push_back(s);
        while (head < queue.size()) {
            int64_t u = queue[head++];
            perm_out[pos++] = u;
            nb.clear();
            for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
                int64_t v = indices[k];
                if (!visited[v]) {
                    visited[v] = 1;
                    nb.push_back(v);
                }
            }
            std::sort(nb.begin(), nb.end(), [&](int64_t a, int64_t b) {
                return degree[a] < degree[b];
            });
            for (int64_t v : nb) queue.push_back(v);
        }
    }
    // reverse (the "R" in RCM)
    std::reverse(perm_out, perm_out + n);
}

// Sort COO triplets by (row, col), sum duplicates, drop exact zeros.
// vals is interleaved complex (2*nnz doubles).  Writes compacted triplets
// in place and returns the new entry count.  n_cols packs (row, col) into
// one 64-bit sort key (requires n_rows*n_cols < 2^63 — FEM dims qualify);
// pass n_cols = 0 to force the generic comparison path.
int64_t wae_coo_dedup(int64_t nnz, int64_t* rows, int64_t* cols,
                      double* vals, int64_t n_cols) {
    if (nnz == 0) return 0;
    std::vector<std::pair<int64_t, int64_t>> kv(nnz);  // (key, src index)
    if (n_cols > 0) {
        for (int64_t i = 0; i < nnz; ++i)
            kv[i] = {rows[i] * n_cols + cols[i], i};
    } else {
        for (int64_t i = 0; i < nnz; ++i) kv[i] = {rows[i], i};
    }
    const int64_t par_threshold = 1 << 17;
    if (nnz >= par_threshold) {
        // parallel sample sort: partition by key into T buckets, sort each
        unsigned hw = std::thread::hardware_concurrency();
        int64_t T = hw ? static_cast<int64_t>(hw) : 4;
        if (T > 16) T = 16;
        auto mm = std::minmax_element(kv.begin(), kv.end());
        const int64_t lo = mm.first->first, hi = mm.second->first;
        if (hi > lo) {
            const double scale = static_cast<double>(T) /
                                 (static_cast<double>(hi - lo) + 1.0);
            std::vector<std::vector<std::pair<int64_t, int64_t>>> buckets(T);
            for (auto& b : buckets) b.reserve(2 * nnz / T);
            for (const auto& p : kv) {
                int64_t b = static_cast<int64_t>(
                    static_cast<double>(p.first - lo) * scale);
                if (b >= T) b = T - 1;
                buckets[b].push_back(p);
            }
            std::vector<std::thread> threads;
            for (int64_t t = 0; t < T; ++t)
                threads.emplace_back([&buckets, t]() {
                    std::sort(buckets[t].begin(), buckets[t].end());
                });
            for (auto& th : threads) th.join();
            int64_t o = 0;
            for (const auto& b : buckets)
                for (const auto& p : b) kv[o++] = p;
        } else {
            std::sort(kv.begin(), kv.end());
        }
    } else {
        std::sort(kv.begin(), kv.end());
    }
    if (n_cols == 0) {
        std::stable_sort(kv.begin(), kv.end(),
                         [&](const std::pair<int64_t, int64_t>& a,
                             const std::pair<int64_t, int64_t>& b) {
                             if (a.first != b.first) return a.first < b.first;
                             return cols[a.second] < cols[b.second];
                         });
    }
    std::vector<int64_t> r2(nnz), c2(nnz);
    std::vector<double> v2(2 * nnz);
    for (int64_t i = 0; i < nnz; ++i) {
        int64_t o = kv[i].second;
        r2[i] = rows[o];
        c2[i] = cols[o];
        v2[2 * i] = vals[2 * o];
        v2[2 * i + 1] = vals[2 * o + 1];
    }
    int64_t out = -1;
    for (int64_t i = 0; i < nnz; ++i) {
        if (out >= 0 && r2[i] == rows[out] && c2[i] == cols[out]) {
            vals[2 * out] += v2[2 * i];
            vals[2 * out + 1] += v2[2 * i + 1];
        } else {
            ++out;
            rows[out] = r2[i];
            cols[out] = c2[i];
            vals[2 * out] = v2[2 * i];
            vals[2 * out + 1] = v2[2 * i + 1];
        }
    }
    ++out;
    // drop exact zeros
    int64_t w = 0;
    for (int64_t i = 0; i < out; ++i) {
        if (vals[2 * i] != 0.0 || vals[2 * i + 1] != 0.0) {
            rows[w] = rows[i];
            cols[w] = cols[i];
            vals[2 * w] = vals[2 * i];
            vals[2 * w + 1] = vals[2 * i + 1];
            ++w;
        }
    }
    return w;
}

// Multithreaded complex CSR (n x n, interleaved complex data) times dense
// row-major panel X [n, k] -> Y [n, k], both interleaved complex.
void wae_csr_spmm(int64_t n, int64_t k, const int64_t* indptr,
                  const int64_t* indices, const double* data,
                  const double* x, double* y, int64_t n_threads) {
    if (n_threads <= 0) {
        n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
        if (n_threads <= 0) n_threads = 1;
    }
    std::atomic<int64_t> next_row{0};
    const int64_t chunk = 64;
    auto worker = [&]() {
        for (;;) {
            int64_t r0 = next_row.fetch_add(chunk);
            if (r0 >= n) return;
            int64_t r1 = std::min(r0 + chunk, n);
            for (int64_t i = r0; i < r1; ++i) {
                double* yi = y + 2 * i * k;
                std::memset(yi, 0, sizeof(double) * 2 * k);
                for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                    const int64_t j = indices[p];
                    const double ar = data[2 * p], ai = data[2 * p + 1];
                    const double* xj = x + 2 * j * k;
                    for (int64_t c = 0; c < k; ++c) {
                        const double xr = xj[2 * c], xi = xj[2 * c + 1];
                        yi[2 * c] += ar * xr - ai * xi;
                        yi[2 * c + 1] += ar * xi + ai * xr;
                    }
                }
            }
        }
    };
    std::vector<std::thread> threads;
    for (int64_t t = 1; t < n_threads; ++t) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
}

}  // extern "C"
