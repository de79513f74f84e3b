// Fused PARAFAC2-ALS stages on the CC format, for Hopper (sm_90a).
//
// Four kernels replace the four fused Pallas stages of
// src/repro/kernels/fused.py (F1-F4 below). Each computes what its TPU
// kernel computes; none is carried over block by block.
//
// Shapes (one bucket): vals [K, I, C] (each subject's slab, dense over its
// kept columns), Vg [K, C, R] (gathered V rows), Q / XkV [K, I, R],
// Wb [K, R] (W rows, subject mask folded in), H [R, R], col_mask [K, C].
// T is float or double; every sum accumulates in T (accum_dtype: f32 -> f32,
// f64 -> f64). R <= 64. All tensors are contiguous, row-major.
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): at rank R each slab element takes part in about 2R operations, so
// for R = 5 in f32 that is 10 operations per 4-byte load, far below the ~20
// the card needs per byte before arithmetic is the limit. F1, F3 and F4 are
// bound by the slab bytes (K*I*C*itemsize / 3.35 TB/s); F2 reads only the
// [K, I, R] operands and is bound by those bytes. So the design reads every
// slab element once, coalesced along C, keeps the small operands (Vg_k, Q_k,
// H, w_k) in shared memory, and does the R-wide arithmetic in FMA units; it
// uses no tensor cores, no TMA and no multi-stage pipeline (later work).
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py):
// every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kMaxDynamicSmem = 232448;    // 227 KB, the most a block may use
constexpr int kDefaultSmem = 48 * 1024;    // above this, opt in per kernel
constexpr int kMode1Blocks = 2048;         // first-level blocks of F2
constexpr int kMaxR = 64;                  // the largest rank instantiated

// Row stride of an [n, R] tile in shared memory: odd, so that 32 lanes
// reading rows c = lane .. lane+31 hit 32 distinct banks.
__host__ __device__ inline int row_stride(int R) { return (R % 2) ? R : R + 1; }

template <typename T>
__device__ inline T warp_sum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ inline T* smem_base() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// Copy a contiguous [n, R] tile from global memory into shared memory with
// row stride RS.
template <typename T>
__device__ inline void stage_rows(T* dst, const T* __restrict__ src, int n,
                                  int R, int RS) {
  for (int t = threadIdx.x; t < n * R; t += blockDim.x) {
    const int row = t / R;
    dst[row * RS + (t - row * R)] = src[t];
  }
}

// One warp computes one slab row's x[r] = sum_c vals[i, c] * Vg[c, r]:
// lanes stride over c (coalesced loads), then a butterfly sum leaves the
// full row sum in every lane.
template <typename T, int RMAX>
__device__ inline void row_times_vg(const T* __restrict__ row, const T* vg_s,
                                    int C, int R, int RS, int lane,
                                    T (&acc)[RMAX]) {
#pragma unroll
  for (int r = 0; r < RMAX; ++r) acc[r] = T(0);
  for (int c = lane; c < C; c += kWarp) {
    const T v = row[c];
    const T* vrow = vg_s + c * RS;
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < R) acc[r] += v * vrow[r];
  }
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    if (r < R) acc[r] = warp_sum(acc[r]);
}

// Output entries per lane when one warp writes a row of R <= RMAX entries:
// a compile-time count, so RMAX <= 32 keeps a single `lane < R` test.
template <int RMAX>
constexpr int kLaneSlots = (RMAX + kWarp - 1) / kWarp;

// acc[lane] without indexing a register array by a run-time value.
template <typename T, int RMAX>
__device__ inline T pick(const T (&acc)[RMAX], int idx) {
  T out = T(0);
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    if (r == idx) out = acc[r];
  return out;
}

// ---------------------------------------------------------------------------
// F1 fused_procrustes_b. Replaces src/repro/kernels/fused.py
// fused_procrustes_b (pallas_call at :153): XkV_k = X_k Vg_k and
// B_k = (XkV_k * w_k) H^T in one pass over the slab. Bound: the slab bytes.
// One block per subject: Vg_k and H in shared memory, one warp per slab row,
// B formed from the row sums in registers, so XkV is written but never read
// back. The TPU kernel's block_c chunking (a VMEM budget) has no
// counterpart: a block reads its rows straight from device memory.
// ---------------------------------------------------------------------------
template <typename T, int RMAX>
__global__ void __launch_bounds__(kThreads)
procrustes_b_kernel(const T* __restrict__ vals, const T* __restrict__ vg,
                    const T* __restrict__ wb, const T* __restrict__ h,
                    T* __restrict__ xkv, T* __restrict__ bout,
                    int I, int C, int R) {
  const int RS = row_stride(R);
  T* vg_s = smem_base<T>();                 // [C, RS]
  T* h_s = vg_s + (size_t)C * RS;           // [R, R]
  T* w_s = h_s + R * R;                     // [R]
  const int64_t k = blockIdx.x;
  stage_rows(vg_s, vg + k * C * R, C, R, RS);
  for (int t = threadIdx.x; t < R * R; t += blockDim.x) h_s[t] = h[t];
  for (int t = threadIdx.x; t < R; t += blockDim.x) w_s[t] = wb[k * R + t];
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const T* vals_k = vals + k * I * C;
  for (int i = warp; i < I; i += blockDim.x / kWarp) {
    T acc[RMAX];
    row_times_vg<T, RMAX>(vals_k + (int64_t)i * C, vg_s, C, R, RS, lane, acc);
    // B[i, l] = sum_r (XkV[i, r] * w[r]) * H[l, r]; the lane writes
    // l = lane (and l = lane + 32 when RMAX = 64)
#pragma unroll
    for (int j = 0; j < kLaneSlots<RMAX>; ++j) {
      const int l = lane + j * kWarp;
      if (l < R) {
        T b = T(0);
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r < R) b += (acc[r] * w_s[r]) * h_s[l * R + r];
        const int64_t o = (k * I + i) * R + l;
        xkv[o] = pick<T, RMAX>(acc, l);
        bout[o] = b;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// F2 fused_mode1_xkv. Replaces src/repro/kernels/fused.py fused_mode1_xkv
// (pallas_call at :211): M1 = sum_k (Q_k^T XkV_k) * w_k, a reduction across
// subjects. Bound: the bytes of Q and XkV ([K, I, R] each). The TPU kernel
// carries the sum from one grid step to the next; blocks here run in no
// order, so the reduction is two-level and deterministic: each first-level
// block sums a fixed run of subjects into its own [R, R] partial (one thread
// owns each (r, l) entry), and a second launch sums the partials in block
// order. No atomics: two runs give the same bits.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
mode1_partial_kernel(const T* __restrict__ q, const T* __restrict__ xkv,
                     const T* __restrict__ wb, T* __restrict__ partials,
                     int K, int I, int R, int per_block) {
  T* q_s = smem_base<T>();                  // [I, R]
  T* x_s = q_s + I * R;                     // [I, R]
  T* w_s = x_s + I * R;                     // [R]
  T* acc_s = w_s + R;                       // [R, R], entry p owned by one thread
  const int RR = R * R;
  for (int p = threadIdx.x; p < RR; p += blockDim.x) acc_s[p] = T(0);
  const int k0 = blockIdx.x * per_block;
  const int k1 = min(K, k0 + per_block);
  for (int k = k0; k < k1; ++k) {
    __syncthreads();                        // the previous subject is done
    for (int t = threadIdx.x; t < I * R; t += blockDim.x) {
      q_s[t] = q[(int64_t)k * I * R + t];
      x_s[t] = xkv[(int64_t)k * I * R + t];
    }
    for (int t = threadIdx.x; t < R; t += blockDim.x) w_s[t] = wb[(int64_t)k * R + t];
    __syncthreads();
    for (int p = threadIdx.x; p < RR; p += blockDim.x) {
      const int r = p / R, l = p - r * R;
      T s = T(0);
      for (int i = 0; i < I; ++i) s += q_s[i * R + r] * x_s[i * R + l];
      acc_s[p] += s * w_s[l];
    }
  }
  for (int p = threadIdx.x; p < RR; p += blockDim.x)
    partials[(int64_t)blockIdx.x * RR + p] = acc_s[p];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mode1_reduce_kernel(const T* __restrict__ partials, T* __restrict__ out,
                    int n_partials, int RR) {
  for (int p = threadIdx.x; p < RR; p += blockDim.x) {
    T s = T(0);
    for (int b = 0; b < n_partials; ++b) s += partials[(int64_t)b * RR + p];
    out[p] = s;
  }
}

// ---------------------------------------------------------------------------
// F3 fused_mode2_compact. Replaces src/repro/kernels/fused.py
// fused_mode2_compact (pallas_call at :284): A[k, c, :] =
// ((X_k[:, c]^T Q_k) H) * w_k * col_mask[k, c], the second pass over the
// slab; Y_k is never written. Bound: the slab bytes. One block per subject,
// one thread per kept column (loads along C are coalesced across the warp),
// Q_k, H and w_k in shared memory, the R-wide column of Y_k in registers.
// Padded columns and masked subjects write zeros.
// ---------------------------------------------------------------------------
template <typename T, int RMAX>
__global__ void __launch_bounds__(kThreads)
mode2_compact_kernel(const T* __restrict__ vals, const T* __restrict__ q,
                     const T* __restrict__ h, const T* __restrict__ wb,
                     const T* __restrict__ col_mask, T* __restrict__ out,
                     int I, int C, int R) {
  const int RS = row_stride(R);
  T* q_s = smem_base<T>();                  // [I, RS]
  T* h_s = q_s + I * RS;                    // [R, R]
  T* w_s = h_s + R * R;                     // [R]
  const int64_t k = blockIdx.x;
  stage_rows(q_s, q + k * I * R, I, R, RS);
  for (int t = threadIdx.x; t < R * R; t += blockDim.x) h_s[t] = h[t];
  for (int t = threadIdx.x; t < R; t += blockDim.x) w_s[t] = wb[k * R + t];
  __syncthreads();

  const T* vals_k = vals + k * I * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    T y[RMAX];                              // Y_k[:, c] = Q_k^T X_k[:, c]
#pragma unroll
    for (int r = 0; r < RMAX; ++r) y[r] = T(0);
    for (int i = 0; i < I; ++i) {
      const T v = vals_k[(int64_t)i * C + c];
      const T* qrow = q_s + i * RS;
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R) y[r] += v * qrow[r];
    }
    const T cm = col_mask[k * C + c];
    T* orow = out + (k * C + c) * R;
    for (int l = 0; l < R; ++l) {
      T a = T(0);
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R) a += y[r] * h_s[r * R + l];
      orow[l] = a * w_s[l] * cm;
    }
  }
}

// ---------------------------------------------------------------------------
// F4 fused_ykv. Replaces src/repro/kernels/fused.py fused_ykv (pallas_call
// at :357): G_k = Q_k^T X_k Vg_k [R, R], the third pass over the slab; it
// feeds the mode-3 coldot and the fit. Bound: the slab bytes. One block per
// subject: the slab rows go through X_k Vg_k exactly as in F1 (one warp per
// row), the [I, R] product stays in shared memory, and one thread per
// (r, l) entry reduces Q_k^T (X_k Vg_k) over the rows in a fixed order.
// ---------------------------------------------------------------------------
template <typename T, int RMAX>
__global__ void __launch_bounds__(kThreads)
ykv_kernel(const T* __restrict__ vals, const T* __restrict__ q,
           const T* __restrict__ vg, T* __restrict__ out, int I, int C, int R) {
  const int RS = row_stride(R);
  T* vg_s = smem_base<T>();                 // [C, RS]
  T* q_s = vg_s + (size_t)C * RS;           // [I, RS]
  T* x_s = q_s + I * RS;                    // [I, RS]  X_k Vg_k
  const int64_t k = blockIdx.x;
  stage_rows(vg_s, vg + k * C * R, C, R, RS);
  stage_rows(q_s, q + k * I * R, I, R, RS);
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const T* vals_k = vals + k * I * C;
  for (int i = warp; i < I; i += blockDim.x / kWarp) {
    T acc[RMAX];
    row_times_vg<T, RMAX>(vals_k + (int64_t)i * C, vg_s, C, R, RS, lane, acc);
#pragma unroll
    for (int j = 0; j < kLaneSlots<RMAX>; ++j) {
      const int l = lane + j * kWarp;
      if (l < R) x_s[i * RS + l] = pick<T, RMAX>(acc, l);
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < R * R; p += blockDim.x) {
    const int r = p / R, l = p - r * R;
    T g = T(0);
    for (int i = 0; i < I; ++i) g += q_s[i * RS + r] * x_s[i * RS + l];
    out[k * R * R + p] = g;
  }
}

// ---------------------------------------------------------------------------
// Host-side launchers
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxDynamicSmem) return cudaErrorInvalidValue;
  if (smem > (size_t)kDefaultSmem)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

template <typename T, int RMAX>
cudaError_t launch_f1(const void* vals, const void* vg, const void* wb,
                      const void* h, void* xkv, void* b, int K, int I, int C,
                      int R, cudaStream_t stream) {
  const size_t smem = ((size_t)C * row_stride(R) + R * R + R) * sizeof(T);
  auto kernel = procrustes_b_kernel<T, RMAX>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<K, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const T*>(vg),
      static_cast<const T*>(wb), static_cast<const T*>(h),
      static_cast<T*>(xkv), static_cast<T*>(b), I, C, R);
  return cudaGetLastError();
}

template <typename T, int RMAX>
cudaError_t launch_f3(const void* vals, const void* q, const void* h,
                      const void* wb, const void* cm, void* out, int K, int I,
                      int C, int R, cudaStream_t stream) {
  const size_t smem = ((size_t)I * row_stride(R) + R * R + R) * sizeof(T);
  auto kernel = mode2_compact_kernel<T, RMAX>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<K, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const T*>(q),
      static_cast<const T*>(h), static_cast<const T*>(wb),
      static_cast<const T*>(cm), static_cast<T*>(out), I, C, R);
  return cudaGetLastError();
}

template <typename T, int RMAX>
cudaError_t launch_f4(const void* vals, const void* q, const void* vg,
                      void* out, int K, int I, int C, int R,
                      cudaStream_t stream) {
  const size_t smem = ((size_t)C * row_stride(R) + 2 * (size_t)I * row_stride(R)) * sizeof(T);
  auto kernel = ykv_kernel<T, RMAX>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<K, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const T*>(q),
      static_cast<const T*>(vg), static_cast<T*>(out), I, C, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_f2(const void* q, const void* xkv, const void* wb,
                      void* partials, void* out, int K, int I, int R,
                      int n_partials, cudaStream_t stream) {
  const int per_block = (K + n_partials - 1) / n_partials;
  const size_t smem = (2 * (size_t)I * R + R + R * R) * sizeof(T);
  auto kernel = mode1_partial_kernel<T>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<n_partials, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(xkv),
      static_cast<const T*>(wb), static_cast<T*>(partials), K, I, R, per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mode1_reduce_kernel<T><<<1, kThreads, 0, stream>>>(
      static_cast<const T*>(partials), static_cast<T*>(out), n_partials, R * R);
  return cudaGetLastError();
}

}  // namespace

// Instantiate a launcher for T in {float, double} and RMAX in
// {8, 16, 32, 64}.
#define SPARTAN_DISPATCH(LAUNCH, ...)                                         \
  do {                                                                        \
    if (R < 1 || R > kMaxR) return (int)cudaErrorInvalidValue;                \
    if (dtype == 0) {                                                         \
      if (R <= 8) return (int)LAUNCH<float, 8>(__VA_ARGS__);                  \
      if (R <= 16) return (int)LAUNCH<float, 16>(__VA_ARGS__);                \
      if (R <= 32) return (int)LAUNCH<float, 32>(__VA_ARGS__);                \
      return (int)LAUNCH<float, 64>(__VA_ARGS__);                             \
    }                                                                         \
    if (dtype == 1) {                                                         \
      if (R <= 8) return (int)LAUNCH<double, 8>(__VA_ARGS__);                 \
      if (R <= 16) return (int)LAUNCH<double, 16>(__VA_ARGS__);               \
      if (R <= 32) return (int)LAUNCH<double, 32>(__VA_ARGS__);               \
      return (int)LAUNCH<double, 64>(__VA_ARGS__);                            \
    }                                                                         \
    return (int)cudaErrorInvalidValue;                                        \
  } while (0)

extern "C" {

// dtype: 0 = float32, 1 = float64. Returns a cudaError_t (0 = success).

int spartan_fused_procrustes_b(int dtype, const void* vals, const void* vg,
                               const void* wb, const void* h, void* xkv,
                               void* b, int K, int I, int C, int R,
                               void* stream) {
  SPARTAN_DISPATCH(launch_f1, vals, vg, wb, h, xkv, b, K, I, C, R,
                   static_cast<cudaStream_t>(stream));
}

int spartan_fused_mode1_xkv(int dtype, const void* q, const void* xkv,
                            const void* wb, void* partials, void* out, int K,
                            int I, int R, int n_partials, void* stream) {
  if (R < 1 || R > kMaxR || n_partials < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f2<float>(q, xkv, wb, partials, out, K, I, R, n_partials, s);
  if (dtype == 1) return (int)launch_f2<double>(q, xkv, wb, partials, out, K, I, R, n_partials, s);
  return (int)cudaErrorInvalidValue;
}

int spartan_fused_mode2_compact(int dtype, const void* vals, const void* q,
                                const void* h, const void* wb, const void* cm,
                                void* out, int K, int I, int C, int R,
                                void* stream) {
  SPARTAN_DISPATCH(launch_f3, vals, q, h, wb, cm, out, K, I, C, R,
                   static_cast<cudaStream_t>(stream));
}

int spartan_fused_ykv(int dtype, const void* vals, const void* q,
                      const void* vg, void* out, int K, int I, int C, int R,
                      void* stream) {
  SPARTAN_DISPATCH(launch_f4, vals, q, vg, out, K, I, C, R,
                   static_cast<cudaStream_t>(stream));
}

// The number of first-level blocks F2 uses for K subjects (the wrapper
// allocates one [R, R] partial per block).
int spartan_mode1_partials(int K) { return K < kMode1Blocks ? K : kMode1Blocks; }

}  // extern "C"
