// Blocked-CSR -> dense-tile panelizer (host data path for sparse V).
//
// The solvers want dense tiles; recommender-scale V arrives as CSR.  This is the
// native (C++) host-side feeder that densifies (row_block x col_panel)
// tiles out of a CSR matrix, multithreaded across rows, so panels can be
// staged into device HBM while the previous panel computes (the ring
// schedule in tpunmf/parallel).  The reference has no sparse or native
// path at all (SURVEY §2B) — its de-facto native layer was vendored
// BLAS/LAPACK; this is the equivalent infrastructure for our streaming
// input pipeline.
//
// Exposed C ABI (ctypes-friendly):
//   csr_panel_f32: densify one tile into caller-provided buffer.
//   csr_panel_f32_batch: densify a strip of column panels in one call.
//
// Per-row column windows are located with binary search (indices sorted
// within each CSR row), so cost is O(rows * (log nnz_row + nnz_in_window)).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline void fill_tile_rows(const int64_t* indptr, const int32_t* indices,
                           const float* data, int64_t row0, int64_t r_begin,
                           int64_t r_end, int64_t col0, int64_t cols,
                           float* out) {
  for (int64_t r = r_begin; r < r_end; ++r) {
    const int64_t row = row0 + r;
    const int32_t* beg = indices + indptr[row];
    const int32_t* end = indices + indptr[row + 1];
    const float* vals = data + indptr[row];
    // first nonzero with column >= col0
    const int32_t* lo =
        std::lower_bound(beg, end, static_cast<int32_t>(col0));
    const int32_t* hi =
        std::lower_bound(lo, end, static_cast<int32_t>(col0 + cols));
    float* out_row = out + r * cols;
    for (const int32_t* p = lo; p < hi; ++p) {
      out_row[*p - col0] = vals[p - beg];
    }
  }
}

// float -> bfloat16 with round-to-nearest-even (the transfer-compression
// path: halves host->device panel bytes; accumulation stays f32 on device)
inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, sizeof(x));
  // NaN guard: a payload confined to the low 16 bits would carry into
  // the exponent under RNE and come out as +/-inf; quiet it instead
  // (matches ml_dtypes / the scipy fallback path)
  if ((x & 0x7FFFFFFFu) > 0x7F800000u) {
    return static_cast<uint16_t>((x >> 16) | 0x0040u);
  }
  const uint32_t lsb = (x >> 16) & 1u;
  x += 0x7FFFu + lsb;
  return static_cast<uint16_t>(x >> 16);
}

inline void fill_tile_rows_bf16(const int64_t* indptr, const int32_t* indices,
                                const float* data, int64_t row0,
                                int64_t r_begin, int64_t r_end, int64_t col0,
                                int64_t cols, uint16_t* out) {
  for (int64_t r = r_begin; r < r_end; ++r) {
    const int64_t row = row0 + r;
    const int32_t* beg = indices + indptr[row];
    const int32_t* end = indices + indptr[row + 1];
    const float* vals = data + indptr[row];
    const int32_t* lo =
        std::lower_bound(beg, end, static_cast<int32_t>(col0));
    const int32_t* hi =
        std::lower_bound(lo, end, static_cast<int32_t>(col0 + cols));
    uint16_t* out_row = out + r * cols;
    for (const int32_t* p = lo; p < hi; ++p) {
      out_row[*p - col0] = f32_to_bf16(vals[p - beg]);
    }
  }
}

void run_threaded(int64_t rows, int n_threads,
                  const std::function<void(int64_t, int64_t)>& body) {
  if (n_threads <= 1 || rows < 256) {
    body(0, rows);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min<int64_t>(rows, b + chunk);
    if (b >= e) break;
    threads.emplace_back([&body, b, e] { body(b, e); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Densify the tile [row0, row0+rows) x [col0, col0+cols) into out
// (row-major rows x cols, pre-zeroing handled here).
void csr_panel_f32(const int64_t* indptr, const int32_t* indices,
                   const float* data, int64_t row0, int64_t rows,
                   int64_t col0, int64_t cols, float* out, int n_threads) {
  std::memset(out, 0, sizeof(float) * rows * cols);
  run_threaded(rows, n_threads, [&](int64_t b, int64_t e) {
    fill_tile_rows(indptr, indices, data, row0, b, e, col0, cols, out);
  });
}

// Densify n_panels consecutive column panels (each rows x cols) for one
// row block into out (n_panels x rows x cols, contiguous).
void csr_panel_f32_batch(const int64_t* indptr, const int32_t* indices,
                         const float* data, int64_t row0, int64_t rows,
                         int64_t col0, int64_t cols, int64_t n_panels,
                         float* out, int n_threads) {
  std::memset(out, 0, sizeof(float) * n_panels * rows * cols);
  run_threaded(rows, n_threads, [&](int64_t b, int64_t e) {
    for (int64_t p = 0; p < n_panels; ++p) {
      fill_tile_rows(indptr, indices, data, row0, b, e, col0 + p * cols, cols,
                     out + p * rows * cols);
    }
  });
}

// Densify a tile directly to bfloat16 (round-to-nearest-even) — the
// panel never exists as f32 on the host, so the transfer-compressed
// streaming path costs no extra host pass.  bf16 zero is 0x0000, so the
// memset pre-zero is exact.
void csr_panel_bf16(const int64_t* indptr, const int32_t* indices,
                    const float* data, int64_t row0, int64_t rows,
                    int64_t col0, int64_t cols, uint16_t* out,
                    int n_threads) {
  std::memset(out, 0, sizeof(uint16_t) * rows * cols);
  run_threaded(rows, n_threads, [&](int64_t b, int64_t e) {
    fill_tile_rows_bf16(indptr, indices, data, row0, b, e, col0, cols, out);
  });
}

// nnz inside a tile — lets the scheduler skip all-zero panels.
int64_t csr_panel_nnz(const int64_t* indptr, const int32_t* indices,
                      int64_t row0, int64_t rows, int64_t col0, int64_t cols) {
  int64_t total = 0;
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t row = row0 + r;
    const int32_t* beg = indices + indptr[row];
    const int32_t* end = indices + indptr[row + 1];
    const int32_t* lo =
        std::lower_bound(beg, end, static_cast<int32_t>(col0));
    const int32_t* hi =
        std::lower_bound(lo, end, static_cast<int32_t>(col0 + cols));
    total += hi - lo;
  }
  return total;
}

}  // extern "C"
