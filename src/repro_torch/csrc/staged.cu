// Staged PARAFAC2-ALS stages on the CC format, for Hopper (sm_90a).
//
// Six entry points replace the six staged Pallas kernels of src/repro/
// kernels/ (the counterpart of the reference's backend="pallas"); they work
// on the projected slices Yc_k = Q_k^T X_k that the caller has formed:
//
//   row 5  ykv          YkV[k] = Yc_k Vg_k                      [K, R, R]
//   row 6  mode1        M1 = sum_k (Yc_k Vg_k) * w_k            [R, R]
//   row 7  mode1_reuse  M1 = sum_k YkV_k * w_k                  [R, R]
//   row 8  mode2        A[k] = (Yc_k^T H) * w_k * col_mask[k]   [K, C, R]
//   row 9  mode3        out[k, l] = sum_r H[r, l] (Yc_k Vg_k)[r, l]   [K, R]
//   row 10 mode3_reuse  the same from YkV
//
// Rows 6 and 9 are row 5's product with another epilogue, and rows 7 and 10
// the same epilogues on a cached YkV: four kernel bodies in all.
//
// Shapes (one bucket): Yc [K, R, C], Vg [K, C, R], YkV [K, R, R], Wb [K, R]
// (W rows, subject mask folded in), H [R, R], col_mask [K, C], mask [K] (or
// null: no subject mask). T is float or double; every sum accumulates in T
// (accum_dtype: f32 -> f32, f64 -> f64). Any R and C. All tensors are
// contiguous, row-major.
//
// What bounds them on an H100 (3.35 TB/s): at rank R every Yc and Vg element
// takes part in R multiply-adds, below the ~20 operations per byte before
// arithmetic is the limit, so all six are bound by bytes; rows 7 and 10 read
// only [K, R, R] and are bound by their launch. Design, simple first: one
// thread per output entry, reading its operands straight from device memory.
// A warp's lanes cover neighbouring entries, so the Yc row a lane reads is
// the one its neighbours read (one load serves them all) and the L1 cache
// holds each 32-byte sector across the next iterations; no shared-memory
// tile, so no shape limit. The TPU kernels' padding of C to block_c is not
// carried over: a thread loops over the C it is given. The two reductions
// across subjects (rows 6, 7) are two-level and deterministic, as F2 of
// fused.cu: fixed runs of subjects per block, then a second launch sums the
// partials in a fixed order; no atomics, so two runs give the same bits.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_launch.py):
// every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int64_t kMaxBlocks = 1 << 20;    // grid-stride loops beyond this
constexpr int kReduceBlocks = 2048;        // first-level blocks of rows 6, 7

int grid_for(int64_t n) {
  return (int)std::min<int64_t>(kMaxBlocks, (n + kThreads - 1) / kThreads);
}

// (Yc_k Vg_k)[r, l] = sum_c yc_row[c] * vg_col[c * R], with yc_row =
// Yc[k, r, :] and vg_col = Vg[k, :, l]; four running sums, for independent
// loads in flight and a shorter chain of roundings.
template <typename T>
__device__ inline T yv_entry(const T* __restrict__ yc_row,
                             const T* __restrict__ vg_col, int C, int R) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int c = 0;
  for (; c + 3 < C; c += 4) {
    s0 += yc_row[c] * vg_col[(int64_t)c * R];
    s1 += yc_row[c + 1] * vg_col[(int64_t)(c + 1) * R];
    s2 += yc_row[c + 2] * vg_col[(int64_t)(c + 2) * R];
    s3 += yc_row[c + 3] * vg_col[(int64_t)(c + 3) * R];
  }
  for (; c < C; ++c) s0 += yc_row[c] * vg_col[(int64_t)c * R];
  return (s0 + s1) + (s2 + s3);
}

// ---------------------------------------------------------------------------
// Row 5, ykv. Replaces src/repro/kernels/ykv.py ykv_pallas (pallas_call at
// :53): one thread per entry (k, r, l) of YkV. Bound: the bytes of Yc and Vg.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
ykv_kernel(const T* __restrict__ yc, const T* __restrict__ vg,
           T* __restrict__ out, int K, int R, int C) {
  const int64_t RR = (int64_t)R * R, n = K * RR;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < n;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = t / RR;
    const int p = (int)(t - k * RR), r = p / R, l = p - r * R;
    out[t] = yv_entry(yc + (k * R + r) * C, vg + k * C * R + l, C, R);
  }
}

// ---------------------------------------------------------------------------
// Rows 6 and 7, mode1 / mode1_reuse. Replace src/repro/kernels/
// mttkrp_mode1.py mode1_pallas (pallas_call at :72) and mode1_reuse_pallas
// (:112), which carry the [R, R] sum across sequential grid steps. Here the
// first level gives each block a fixed run of subjects and each of its
// threads one entry (r, l); when R*R leaves threads over, G groups of R*R
// threads take every G-th subject of the run and the block adds the groups
// in order at the end. Bound: Yc and Vg bytes (row 6), YkV bytes (row 7, so
// its launch).
// ---------------------------------------------------------------------------
template <typename T, bool REUSE>
__global__ void __launch_bounds__(kThreads)
mode1_partial_kernel(const T* __restrict__ yc, const T* __restrict__ vg,
                     const T* __restrict__ ykv, const T* __restrict__ wb,
                     T* __restrict__ partials, int K, int R, int C,
                     int per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red_s = reinterpret_cast<T*>(smem_raw);   // [G, R*R] when G > 1
  const int RR = R * R;
  const int G = max(1, (int)blockDim.x / RR);
  const int k0 = blockIdx.x * per_block;
  const int k1 = min(K, k0 + per_block);
  T* part = partials + (int64_t)blockIdx.x * RR;
  for (int v = threadIdx.x; v < G * RR; v += blockDim.x) {
    const int g = v / RR, p = v - g * RR, r = p / R, l = p - r * R;
    T acc = T(0);
    for (int k = k0 + g; k < k1; k += G) {
      const T y = REUSE ? ykv[(int64_t)k * RR + p]
                        : yv_entry(yc + ((int64_t)k * R + r) * C,
                                   vg + (int64_t)k * C * R + l, C, R);
      acc += y * wb[(int64_t)k * R + l];
    }
    if (G == 1) part[p] = acc;
    else red_s[v] = acc;
  }
  if (G > 1) {                                 // block-uniform
    __syncthreads();
    for (int p = threadIdx.x; p < RR; p += blockDim.x) {
      T s = T(0);
      for (int g = 0; g < G; ++g) s += red_s[g * RR + p];
      part[p] = s;
    }
  }
}

// The second level: one warp per entry, its lanes striding over the
// partials and then summed by a fixed butterfly, so the order is fixed and
// the 2048-long chain of dependent adds is 64 long.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const T* __restrict__ partials, T* __restrict__ out,
                       int n_partials, int RR) {
  const int lane = threadIdx.x % kWarp, warps = blockDim.x / kWarp;
  for (int p = blockIdx.x * warps + threadIdx.x / kWarp; p < RR; p += gridDim.x * warps) {
    T s = T(0);
    for (int b = lane; b < n_partials; b += kWarp) s += partials[(int64_t)b * RR + p];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[p] = s;
  }
}

// ---------------------------------------------------------------------------
// Row 8, mode2_compact. Replaces src/repro/kernels/mttkrp_mode2.py
// mode2_compact_pallas (pallas_call at :61): one thread per output entry
// (k, c, l), so a warp's stores are contiguous. Masked columns (col_mask 0)
// and masked subjects (w_k folded to 0) write exact zeros, which the
// sorted-segment mode-2 scatter relies on. Bound: the bytes of Yc and A.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
mode2_compact_kernel(const T* __restrict__ yc, const T* __restrict__ h,
                     const T* __restrict__ wb, const T* __restrict__ cm,
                     T* __restrict__ out, int K, int R, int C) {
  const int64_t n = (int64_t)K * C * R;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < n;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t kc = t / R;
    const int l = (int)(t - kc * R);
    const int64_t k = kc / C;
    const int c = (int)(kc - k * C);
    const T* ycol = yc + k * R * C + c;
    T a = T(0);
    for (int r = 0; r < R; ++r) a += ycol[(int64_t)r * C] * h[r * R + l];
    out[t] = a * wb[k * R + l] * cm[kc];
  }
}

// ---------------------------------------------------------------------------
// Rows 9 and 10, mode3 / mode3_reuse. Replace src/repro/kernels/
// mttkrp_mode3.py mode3_pallas (pallas_call at :71) and mode3_reuse_pallas
// (:106): one thread per output entry (k, l), the coldot over r of H[:, l]
// with column l of Yc_k Vg_k (row 9, formed on the fly) or of YkV_k (row
// 10). The subject mask, which the reference applies after its kernel, is
// applied here. Bound: Yc and Vg bytes (row 9), YkV bytes (row 10).
// ---------------------------------------------------------------------------
template <typename T, bool REUSE>
__global__ void __launch_bounds__(kThreads)
mode3_kernel(const T* __restrict__ yc, const T* __restrict__ vg,
             const T* __restrict__ ykv, const T* __restrict__ h,
             const T* __restrict__ mask, T* __restrict__ out, int K, int R,
             int C) {
  const int64_t n = (int64_t)K * R;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < n;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = t / R;
    const int l = (int)(t - k * R);
    T s = T(0);
    for (int r = 0; r < R; ++r) {
      const T y = REUSE ? ykv[(k * R + r) * R + l]
                        : yv_entry(yc + (k * R + r) * C, vg + k * C * R + l, C, R);
      s += h[r * R + l] * y;
    }
    out[t] = mask ? s * mask[k] : s;
  }
}

// ---------------------------------------------------------------------------
// Host-side launchers
// ---------------------------------------------------------------------------
template <typename T, bool REUSE>
cudaError_t launch_mode1(const void* yc, const void* vg, const void* ykv,
                         const void* wb, void* partials, void* out, int K,
                         int R, int C, int n_partials, cudaStream_t stream) {
  const int RR = R * R;
  const int G = std::max(1, kThreads / RR);
  const size_t smem = G > 1 ? (size_t)G * RR * sizeof(T) : 0;
  const int per_block = (K + n_partials - 1) / n_partials;
  mode1_partial_kernel<T, REUSE><<<n_partials, kThreads, smem, stream>>>(
      static_cast<const T*>(yc), static_cast<const T*>(vg),
      static_cast<const T*>(ykv), static_cast<const T*>(wb),
      static_cast<T*>(partials), K, R, C, per_block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int warps = kThreads / kWarp;
  reduce_partials_kernel<T><<<std::min(1024, (RR + warps - 1) / warps), kThreads, 0, stream>>>(
      static_cast<const T*>(partials), static_cast<T*>(out), n_partials, RR);
  return cudaGetLastError();
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
// Every entry point needs K >= 1, R >= 1, C >= 1 (the wrappers return
// zeros for an empty bucket without a launch).

int spartan_ykv(int dtype, const void* yc, const void* vg, void* out, int K,
                int R, int C, void* stream) {
  if (K < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int grid = grid_for((int64_t)K * R * R);
  SPARTAN_BY_DTYPE({
    ykv_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(yc), static_cast<const T*>(vg),
        static_cast<T*>(out), K, R, C);
    return (int)cudaGetLastError();
  });
}

int spartan_mode1(int dtype, const void* yc, const void* vg, const void* wb,
                  void* partials, void* out, int K, int R, int C,
                  int n_partials, void* stream) {
  if (K < 1 || R < 1 || C < 1 || n_partials < 1) return (int)cudaErrorInvalidValue;
  SPARTAN_BY_DTYPE(return (int)(launch_mode1<T, false>(
      yc, vg, nullptr, wb, partials, out, K, R, C, n_partials,
      static_cast<cudaStream_t>(stream))));
}

int spartan_mode1_reuse(int dtype, const void* ykv, const void* wb,
                        void* partials, void* out, int K, int R,
                        int n_partials, void* stream) {
  if (K < 1 || R < 1 || n_partials < 1) return (int)cudaErrorInvalidValue;
  SPARTAN_BY_DTYPE(return (int)(launch_mode1<T, true>(
      nullptr, nullptr, ykv, wb, partials, out, K, R, 0, n_partials,
      static_cast<cudaStream_t>(stream))));
}

int spartan_mode2_compact(int dtype, const void* yc, const void* h,
                          const void* wb, const void* cm, void* out, int K,
                          int R, int C, void* stream) {
  if (K < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int grid = grid_for((int64_t)K * C * R);
  SPARTAN_BY_DTYPE({
    mode2_compact_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(yc), static_cast<const T*>(h),
        static_cast<const T*>(wb), static_cast<const T*>(cm),
        static_cast<T*>(out), K, R, C);
    return (int)cudaGetLastError();
  });
}

int spartan_mode3(int dtype, const void* yc, const void* vg, const void* h,
                  const void* mask, void* out, int K, int R, int C,
                  void* stream) {
  if (K < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int grid = grid_for((int64_t)K * R);
  SPARTAN_BY_DTYPE({
    mode3_kernel<T, false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(yc), static_cast<const T*>(vg), nullptr,
        static_cast<const T*>(h), static_cast<const T*>(mask),
        static_cast<T*>(out), K, R, C);
    return (int)cudaGetLastError();
  });
}

int spartan_mode3_reuse(int dtype, const void* ykv, const void* h,
                        const void* mask, void* out, int K, int R,
                        void* stream) {
  if (K < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int grid = grid_for((int64_t)K * R);
  SPARTAN_BY_DTYPE({
    mode3_kernel<T, true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        nullptr, nullptr, static_cast<const T*>(ykv),
        static_cast<const T*>(h), static_cast<const T*>(mask),
        static_cast<T*>(out), K, R, 0);
    return (int)cudaGetLastError();
  });
}

// The number of first-level blocks rows 6 and 7 use for K subjects (the
// wrapper allocates one [R, R] partial per block).
int spartan_staged_partials(int K) { return K < kReduceBlocks ? K : kReduceBlocks; }

}  // extern "C"
