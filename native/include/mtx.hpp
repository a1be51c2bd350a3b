// Parallel MatrixMarket (.mtx) loader → CSR.
//
// Host runtime component: the data-ingest path for SuiteSparse
// matrices. Python/scipy parses .mtx at ~10 MB/s; this parser chunks the
// file across the thread pool, parses each chunk into thread-local triplet
// buffers (arena-allocated), then builds CSR with the same two-level
// count → exclusive-scan → rank-stable-scatter skeleton as the reference's
// CPU radix sort (lib/sort/radix_cpu/include/radix_sort_cpu.hpp:254-322) —
// per-thread row histograms, serial scan, parallel scatter.
#pragma once

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "threadpool.hpp"

namespace hpc_host {

struct MtxData {
  std::int64_t rows = 0, cols = 0, nnz = 0;  // nnz = entries AFTER symmetry expansion
  std::string buffer;        // file contents (data section)
  std::size_t data_offset = 0;
  bool symmetric = false;
  bool pattern = false;
  std::int64_t declared_entries = 0;
};

inline MtxData mtx_open(const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) throw std::runtime_error(std::string("cannot open ") + path);
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  MtxData m;
  m.buffer.resize((std::size_t)sz);
  if (std::fread(m.buffer.data(), 1, (std::size_t)sz, f) != (std::size_t)sz) {
    std::fclose(f);
    throw std::runtime_error("short read");
  }
  std::fclose(f);

  std::size_t pos = 0;
  auto next_line = [&](std::string_view& out) -> bool {
    if (pos >= m.buffer.size()) return false;
    std::size_t e = m.buffer.find('\n', pos);
    if (e == std::string::npos) e = m.buffer.size();
    out = std::string_view(m.buffer).substr(pos, e - pos);
    pos = e + 1;
    return true;
  };

  std::string_view line;
  if (!next_line(line) || line.substr(0, 14) != "%%MatrixMarket")
    throw std::runtime_error("not a MatrixMarket file");
  m.symmetric = line.find("symmetric") != std::string_view::npos;
  m.pattern = line.find("pattern") != std::string_view::npos;
  if (line.find("coordinate") == std::string_view::npos)
    throw std::runtime_error("only coordinate format supported");
  while (next_line(line)) {
    if (!line.empty() && line[0] == '%') continue;
    if (line.empty()) continue;
    if (std::sscanf(std::string(line).c_str(), "%ld %ld %ld", &m.rows,
                    &m.cols, &m.declared_entries) != 3)
      throw std::runtime_error("bad size line");
    break;
  }
  m.data_offset = pos;
  m.nnz = m.declared_entries;  // upper bound; symmetric expansion counted later
  return m;
}

// Parse the data section in parallel; returns triplets (row-major CSR built
// by the caller). Symmetric matrices emit both (i,j) and (j,i) for i != j.
inline void mtx_parse_triplets(const MtxData& m, ThreadPool& pool,
                               std::vector<std::int32_t>& rows,
                               std::vector<std::int32_t>& cols,
                               std::vector<float>& vals) {
  const char* base = m.buffer.data();
  std::size_t n = m.buffer.size();
  int nt = pool.size();
  std::size_t span = (n - m.data_offset) / (std::size_t)nt + 1;

  struct Local {
    std::vector<std::int32_t> r, c;
    std::vector<float> v;
  };
  std::vector<Local> locals(nt);
  std::vector<std::future<void>> futs;

  for (int t = 0; t < nt; ++t) {
    std::size_t b = m.data_offset + (std::size_t)t * span;
    std::size_t e = std::min(n, m.data_offset + (std::size_t)(t + 1) * span);
    if (b >= n) break;
    // align to line starts: skip forward past the first newline (except t=0)
    futs.push_back(pool.commit([&, t, b, e] {
      std::size_t p = b;
      if (t > 0 && base[p - 1] != '\n') {
        // b landed mid-line: the previous chunk owns this line; skip it
        while (p < n && base[p] != '\n') ++p;
        ++p;
      }
      Local& L = locals[t];
      while (p < e && p < n) {
        // parse "i j [v]\n" with manual scanning (strtol is the hot path)
        char* endp;
        long i = std::strtol(base + p, &endp, 10);
        if (endp == base + p) {  // blank/garbage line
          while (p < n && base[p] != '\n') ++p;
          ++p;
          continue;
        }
        long j = std::strtol(endp, &endp, 10);
        float v = 1.0f;
        if (!m.pattern) v = std::strtof(endp, &endp);
        p = (std::size_t)(endp - base);
        while (p < n && base[p] != '\n') ++p;
        ++p;
        L.r.push_back((std::int32_t)(i - 1));
        L.c.push_back((std::int32_t)(j - 1));
        L.v.push_back(v);
        if (m.symmetric && i != j) {
          L.r.push_back((std::int32_t)(j - 1));
          L.c.push_back((std::int32_t)(i - 1));
          L.v.push_back(v);
        }
      }
    }));
  }
  for (auto& f : futs) f.get();

  std::size_t total = 0;
  for (auto& L : locals) total += L.r.size();
  rows.resize(total);
  cols.resize(total);
  vals.resize(total);
  std::size_t off = 0;
  for (auto& L : locals) {
    std::copy(L.r.begin(), L.r.end(), rows.begin() + off);
    std::copy(L.c.begin(), L.c.end(), cols.begin() + off);
    std::copy(L.v.begin(), L.v.end(), vals.begin() + off);
    off += L.r.size();
  }
}

// Triplets → CSR via the two-level count/scan/scatter skeleton
// (per-thread histograms + serial scan + parallel rank-stable scatter —
// the radix_sort_cache_thread_v2 structure re-applied to row binning).
inline void triplets_to_csr(ThreadPool& pool, std::int64_t nrows,
                            const std::vector<std::int32_t>& rows,
                            const std::vector<std::int32_t>& cols,
                            const std::vector<float>& vals,
                            std::int32_t* indptr, std::int32_t* indices,
                            float* data) {
  std::int64_t nnz = (std::int64_t)rows.size();
  int nt = pool.size();
  std::int64_t chunk = (nnz + nt - 1) / std::max(nt, 1);

  // per-thread row histograms
  std::vector<std::vector<std::int64_t>> hist(
      nt, std::vector<std::int64_t>(nrows, 0));
  std::vector<std::future<void>> futs;
  for (int t = 0; t < nt; ++t) {
    std::int64_t b = t * chunk, e = std::min(nnz, (t + 1) * chunk);
    if (b >= nnz) break;
    futs.push_back(pool.commit([&, t, b, e] {
      auto& h = hist[t];
      for (std::int64_t k = b; k < e; ++k) ++h[rows[k]];
    }));
  }
  for (auto& f : futs) f.get();
  futs.clear();

  // serial: global base (exclusive scan over rows) + per-thread offsets
  std::vector<std::int64_t> base(nrows + 1, 0);
  for (std::int64_t r = 0; r < nrows; ++r) {
    std::int64_t tot = 0;
    for (int t = 0; t < nt; ++t) {
      std::int64_t c = hist[t][r];
      hist[t][r] = tot;  // becomes per-thread start within the row
      tot += c;
    }
    base[r + 1] = base[r] + tot;
  }
  for (std::int64_t r = 0; r <= nrows; ++r)
    indptr[r] = (std::int32_t)base[r];

  // parallel rank-stable scatter
  for (int t = 0; t < nt; ++t) {
    std::int64_t b = t * chunk, e = std::min(nnz, (t + 1) * chunk);
    if (b >= nnz) break;
    futs.push_back(pool.commit([&, t, b, e] {
      auto local = hist[t];  // copy: running cursor per row
      for (std::int64_t k = b; k < e; ++k) {
        std::int32_t r = rows[k];
        std::int64_t p = base[r] + local[r]++;
        indices[p] = cols[k];
        data[p] = vals[k];
      }
    }));
  }
  for (auto& f : futs) f.get();

  // sort columns within each row (parallel over rows)
  pool.parallel_for(nrows, [&](std::int64_t rb, std::int64_t re) {
    std::vector<std::pair<std::int32_t, float>> tmp;
    for (std::int64_t r = rb; r < re; ++r) {
      std::int64_t s = base[r], e2 = base[r + 1];
      tmp.clear();
      for (std::int64_t k = s; k < e2; ++k) tmp.push_back({indices[k], data[k]});
      std::sort(tmp.begin(), tmp.end(),
                [](auto& a, auto& b2) { return a.first < b2.first; });
      for (std::int64_t k = s; k < e2; ++k) {
        indices[k] = tmp[k - s].first;
        data[k] = tmp[k - s].second;
      }
    }
  }, 256);
}

}  // namespace hpc_host
