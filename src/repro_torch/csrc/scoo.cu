// SCOO segment sums for Hopper (sm_90a): X_k V and Y_k = Q_k^T X_k from
// sorted flat COO triplets.
//
// Two entry points replace the two SCOO Pallas kernels of src/repro/kernels/
// scoo.py; the staged route runs them on SCOO buckets and hands their
// outputs to the staged kernels of staged.cu:
//
//   row 11  xk_times_v  (X_k V)[i, r] = sum over row i's segment of
//                       vals[k, n] * Vg[k, lcols[k, n], r]            [Kb, I, R]
//   row 12  project     Yc[k, r, c] = sum over column c's segment of
//                       vals[k, n] * Q[k, rows[k, n], r],
//                       n = cperm[k, m]                               [Kb, R, C]
//
// Shapes (one bucket): vals [Kb, N], rows / lcols / cperm int32 [Kb, N],
// row_ends int32 [Kb, I], col_ends int32 [Kb, C], Vg [Kb, C, R], Q [Kb, I, R].
// A segment is [ends[s - 1], ends[s]) (from 0 for s = 0); pad triplets lie
// past every end. T is float or double; sums accumulate in T (accum_dtype:
// f32 -> f32, f64 -> f64). Any R, I, C, N. All tensors contiguous, row-major.
//
// What bounds them on an H100 (3.35 TB/s): each triplet takes part in R
// multiply-adds against 12-24 bytes of triplet and index, far below the ~20
// operations per byte before arithmetic is the limit, so both are bound by
// bytes: the triplets, the segment ends, the factor rows they touch and the
// output (for row 12 at C_pad = 128 the dense Yc dominates). Design, simple
// first: one thread per output entry sums its own segment in order, reading
// straight from device memory; no atomics, so two runs give the same bits,
// and an empty segment (a padded column or subject) writes an exact zero.
// The TPU kernels turned each gather into a one-hot matmul on the MXU and
// skipped all-padding blocks by a scalar-prefetched nnz count; none of that
// is carried over: the segment ends say where each sum starts and stops, so
// explicit zero-valued triplets inside the true nnz count like any other.
// Threads of one (k, i) (row 11, r fastest) or one (k, r) (row 12, c
// fastest) are neighbours in a warp, so the stores are contiguous.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_launch.py):
// every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;    // grid-stride loops beyond this

int grid_for(int64_t n) {
  return (int)std::min<int64_t>(kMaxBlocks, (n + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// Row 11, xk_times_v. Replaces src/repro/kernels/scoo.py xk_times_v_pallas
// (:249, pallas_call at :276, body _xkv_kernel at :221): one thread per entry
// (k, i, r) of X_k V. Bound: the triplets' vals and lcols, row_ends, the Vg
// rows read and the output.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
xkv_kernel(const T* __restrict__ vals, const int* __restrict__ lcols,
           const T* __restrict__ vg, const int* __restrict__ row_ends,
           T* __restrict__ out, int Kb, int N, int I, int C, int R) {
  const int64_t IR = (int64_t)I * R, n_out = (int64_t)Kb * IR;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < n_out;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = t / IR;
    const int p = (int)(t - k * IR), i = p / R, r = p - i * R;
    const int* ends = row_ends + k * I;
    const int n0 = i ? ends[i - 1] : 0, n1 = ends[i];
    const T* v = vals + k * N;
    const int* lc = lcols + k * N;
    const T* g = vg + k * C * R + r;
    T acc = T(0);
    for (int n = n0; n < n1; ++n) acc += v[n] * g[(int64_t)lc[n] * R];
    out[t] = acc;
  }
}

// ---------------------------------------------------------------------------
// Row 12, project. Replaces src/repro/kernels/scoo.py project_pallas
// (:313, pallas_call at :341, body _project_kernel at :284): one thread per entry
// (k, r, c) of Yc, walking column c's run of the column-sorted view. Bound:
// vals, rows, cperm, col_ends, the Q rows read and the dense Yc output.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
project_kernel(const T* __restrict__ vals, const int* __restrict__ rows,
               const int* __restrict__ cperm, const T* __restrict__ q,
               const int* __restrict__ col_ends, T* __restrict__ out, int Kb,
               int N, int I, int C, int R) {
  const int64_t RC = (int64_t)R * C, n_out = (int64_t)Kb * RC;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < n_out;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = t / RC;
    const int p = (int)(t - k * RC), r = p / C, c = p - r * C;
    const int* ends = col_ends + k * C;
    const int m0 = c ? ends[c - 1] : 0, m1 = ends[c];
    const T* v = vals + k * N;
    const int* rw = rows + k * N;
    const int* perm = cperm + k * N;
    const T* qk = q + k * I * R + r;
    T acc = T(0);
    for (int m = m0; m < m1; ++m) {
      const int n = perm[m];
      acc += v[n] * qk[(int64_t)rw[n] * R];
    }
    out[t] = acc;
  }
}

}  // namespace

// Run the statement(s) with T = float (dtype 0) or double (dtype 1).
#define SPARTAN_BY_DTYPE(...)                                                 \
  do {                                                                        \
    if (dtype == 0) { using T = float; __VA_ARGS__; }                         \
    if (dtype == 1) { using T = double; __VA_ARGS__; }                        \
    return (int)cudaErrorInvalidValue;                                        \
  } while (0)

extern "C" {

// dtype: 0 = float32, 1 = float64. Returns a cudaError_t (0 = success).
// Both entry points need Kb, N, I, C, R >= 1 (the wrappers return zeros for
// an empty bucket without a launch).

int spartan_scoo_xk_times_v(int dtype, const void* vals, const void* lcols,
                            const void* vg, const void* row_ends, void* out,
                            int Kb, int N, int I, int C, int R, void* stream) {
  if (Kb < 1 || N < 1 || I < 1 || C < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int grid = grid_for((int64_t)Kb * I * R);
  SPARTAN_BY_DTYPE({
    xkv_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int*>(lcols),
        static_cast<const T*>(vg), static_cast<const int*>(row_ends),
        static_cast<T*>(out), Kb, N, I, C, R);
    return (int)cudaGetLastError();
  });
}

int spartan_scoo_project(int dtype, const void* vals, const void* rows,
                         const void* cperm, const void* q, const void* col_ends,
                         void* out, int Kb, int N, int I, int C, int R,
                         void* stream) {
  if (Kb < 1 || N < 1 || I < 1 || C < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int grid = grid_for((int64_t)Kb * R * C);
  SPARTAN_BY_DTYPE({
    project_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int*>(rows),
        static_cast<const int*>(cperm), static_cast<const T*>(q),
        static_cast<const int*>(col_ends), static_cast<T*>(out), Kb, N, I, C, R);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
