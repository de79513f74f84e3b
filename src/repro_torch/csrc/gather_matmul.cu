// BCC gather-matmul for Hopper (sm_90a): X_k V from block-compressed columns.
//
// One entry point replaces src/repro/kernels/gather_matmul.py
// gather_matmul_pallas (:42, pallas_call at :64, body _kernel at :29), row 13
// of PERF.md's kernel table:
//
//   out[k, i, r] = sum_b sum_l vals[k, i, b, l] * V[blk_ids[k, b] * L + l, r]
//
// Shapes: vals [K, I, NB, L], blk_ids int32 [K, NB], V [J_pad, R] with
// J_pad % L == 0 (the caller pads V), out [K, I, R]. Padded blocks carry
// zero values and id 0, which is harmless to read. T is float or double;
// sums accumulate in T. Any K, I, NB, L and R.
//
// What bounds it on an H100 (3.35 TB/s): every value of vals (dense over its
// kept blocks, mostly zeros at EHR sparsity) is read once and takes part in
// R multiply-adds, below the ~20 operations per byte before arithmetic is
// the limit, so it is bound by the bytes of vals, the V blocks and the
// output. A row of a subject, vals[k, i] (E = NB * L values), is one
// contiguous run, and the V rows it meets are the same for every row of the
// subject. So:
//
// - Slab reads are coalesced and 16 bytes a lane: a warp reads one row as
//   32 x 16-byte loads per step, kUnroll steps of two rows in flight at
//   once, with the streaming (evict-first) hint, since each value is read
//   once. Each lane keeps R running sums per row (register tiles of 8 or 16
//   entries of R; wider R runs in R chunks) and the warp reduces them once
//   per row, not once per block. No two threads load the same value.
// - The subject's V blocks are gathered, transposed to [R, E], into shared
//   memory (23 KB at NB = 9, R = 5, f32), where a lane's V values for its 16
//   slab bytes are one 16-byte read per r. The blocks are persistent and walk
//   over subjects; each stages the next subject's V with cp.async into the
//   second half of a double buffer while it streams the current subject's
//   slab, so the gather stays off the critical path. Three blocks an SM (a
//   register cap) keep enough slab loads in flight.
// - A row too long for the buffer (E x RC past kSmemBudget) is taken in
//   chunks of E, each adding to its outputs in place; a row whose length or
//   start is not a multiple of 16 bytes is read 4 or 8 bytes a lane.
//
// One owner per output entry and a fixed order of summation: no atomics,
// two runs give the same bits.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_launch.py):
// the entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kRows = 2;                   // rows a warp streams at once
constexpr int kUnroll = 4;                 // 16-byte loads in flight per row and lane
constexpr int kSmemBudget = 96 * 1024;     // the two V stages, at most

// Blocks an SM should hold: three for the main path's f32 8-wide tile (80
// registers a thread; the bytes in flight grow with the blocks), else what
// the registers give without spilling.
template <typename T, int RMAX>
constexpr int kMinBlocks = (sizeof(T) == 4 && RMAX <= 8) ? 3 : 1;

// VEC values of T read as one load (16 bytes when VEC > 1).
template <typename T, int VEC>
struct Frag {
  T v[VEC];
};

template <typename T, int VEC>
__device__ inline Frag<T, VEC> load_stream(const T* p) {   // device memory, read once
  Frag<T, VEC> f;
  if constexpr (VEC == 1) {
    f.v[0] = __ldcs(p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    f.v[0] = q.x; f.v[1] = q.y; f.v[2] = q.z; f.v[3] = q.w;
  } else {
    const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
    f.v[0] = q.x; f.v[1] = q.y;
  }
  return f;
}

template <typename T, int VEC>
__device__ inline Frag<T, VEC> load_shared(const T* p) {
  Frag<T, VEC> f;
  if constexpr (VEC == 1) {
    f.v[0] = *p;
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    f.v[0] = q.x; f.v[1] = q.y; f.v[2] = q.z; f.v[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    f.v[0] = q.x; f.v[1] = q.y;
  }
  return f;
}

template <typename T>
__device__ inline T warp_sum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[idx] without indexing a register array by a run-time value.
template <typename T, int RMAX>
__device__ inline T pick(const T (&acc)[RMAX], int idx) {
  T out = T(0);
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    if (r == idx) out = acc[r];
  return out;
}

// Work item = (subject k, R chunk); a block's stages are its work items'
// E chunks in order. Stage one into `buf` ([RC, ES], V transposed):
// buf[r, e] = V[blk_ids[k, (e0 + e) / L] * L + (e0 + e) % L, r0 + r].
// A thread walks t = tid, tid + blockDim, ... < en * rw with (e, r) =
// divmod(t, rw) (r fastest: V rows are read whole) and (b, l) =
// divmod(e0 + e, L) kept by additions, not a division per element.
template <typename T>
__device__ inline void stage_v(T* buf, const T* __restrict__ v,
                               const int* __restrict__ ids, int L, int R, int r0,
                               int rw, int e0, int en, int ES) {
  const int de = blockDim.x / rw, dr = blockDim.x % rw;
  int e = threadIdx.x / rw, r = threadIdx.x % rw;
  int b = (e0 + e) / L, l = (e0 + e) % L;
  while (e < en) {
    cp_async<sizeof(T)>(buf + r * ES + e, v + ((int64_t)ids[b] * L + l) * R + r0 + r);
    int step = de;
    r += dr;
    if (r >= rw) { r -= rw; ++step; }
    e += step;
    for (l += step; l >= L; l -= L) ++b;
  }
}

template <typename T, int RMAX, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, RMAX>)
gather_matmul_kernel(const T* __restrict__ vals, const int* __restrict__ blk_ids,
                     const T* __restrict__ v, T* __restrict__ out, int K, int I,
                     int NB, int L, int R, int RC, int EC, int ES) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // [2][RC, ES]
  const int E = NB * L;
  const int n_rc = (R + RC - 1) / RC, n_ec = (E + EC - 1) / EC;
  const int64_t n_items = (int64_t)K * n_rc;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  constexpr int kStep = kWarp * VEC;          // values a warp reads per load

  auto stage = [&](T* buf, int64_t item, int ec) {
    const int64_t k = item / n_rc;
    const int r0 = (int)(item - k * n_rc) * RC, e0 = ec * EC;
    stage_v(buf, v, blk_ids + k * NB, L, R, r0, min(RC, R - r0), e0, min(EC, E - e0), ES);
  };

  int64_t item = blockIdx.x;
  int ec = 0;
  if (item < n_items) stage(ring, item, 0);
  cp_async_commit();
  for (int it = 0; item < n_items; ++it) {    // block-uniform
    int64_t next = item;
    int next_ec = ec + 1;
    if (next_ec == n_ec) { next_ec = 0; next += gridDim.x; }
    if (next < n_items) stage(ring + ((it + 1) & 1) * RC * ES, next, next_ec);
    cp_async_commit();
    cp_async_wait<1>();                       // this stage's V is in
    __syncthreads();
    const T* vs = ring + (it & 1) * RC * ES;
    const int64_t k = item / n_rc;
    const int r0 = (int)(item - k * n_rc) * RC, rw = min(RC, R - r0);
    const int e0 = ec * EC, en = min(EC, E - e0);

    for (int i0 = 0; i0 < I; i0 += kRows * kWarps) {
      const T* x[kRows];
      bool ok[kRows];
      T acc[kRows][RMAX];
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        const int i = i0 + t * kWarps + warp;
        ok[t] = i < I;
        x[t] = vals + ((int64_t)k * I + (ok[t] ? i : 0)) * E + e0;
#pragma unroll
        for (int r = 0; r < RMAX; ++r) acc[t][r] = T(0);
      }
      if (!ok[0]) break;                      // warp-uniform
      for (int base = lane * VEC; base < en; base += kUnroll * kStep) {
        Frag<T, VEC> xv[kRows][kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = base + u * kStep;
#pragma unroll
          for (int t = 0; t < kRows; ++t) {
            if (ok[t] && e < en) {
              xv[t][u] = load_stream<T, VEC>(x[t] + e);
            } else {
#pragma unroll
              for (int j = 0; j < VEC; ++j) xv[t][u].v[j] = T(0);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = base + u * kStep;
          if (e < en) {
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
              if (r < rw) {
                const Frag<T, VEC> w = load_shared<T, VEC>(vs + r * ES + e);
#pragma unroll
                for (int t = 0; t < kRows; ++t)
#pragma unroll
                  for (int j = 0; j < VEC; ++j) acc[t][r] += xv[t][u].v[j] * w.v[j];
              }
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r < rw) acc[t][r] = warp_sum(acc[t][r]);
        if (ok[t] && lane < rw) {
          T* o = out + ((int64_t)k * I + i0 + t * kWarps + warp) * R + r0 + lane;
          const T s = pick<T, RMAX>(acc[t], lane);
          *o = ec == 0 ? s : *o + s;          // E chunks add in order
        }
      }
    }
    __syncthreads();                          // the stage is read: its buffer is free
    item = next;
    ec = next_ec;
  }
}

template <typename T, int RMAX, int VEC>
int launch_vec(const void* vals, const void* blk_ids, const void* v, void* out, int K,
               int I, int NB, int L, int R, cudaStream_t stream) {
  const int64_t E = (int64_t)NB * L;
  if (E > 0x3fffffff) return (int)cudaErrorInvalidValue;
  const int RC = std::min(R, RMAX);
  // the whole row when two stages of it fit the budget, else chunks of
  // whole warp steps; ES pads a staged row by 16 bytes past a multiple of VEC
  auto stride = [](int64_t n) { return (n + VEC - 1) / VEC * VEC + VEC; };
  int64_t EC = E;
  if (2 * RC * stride(E) * (int64_t)sizeof(T) > kSmemBudget)
    EC = (kSmemBudget / (2 * RC * (int64_t)sizeof(T)) - VEC) / (kWarp * VEC) * (kWarp * VEC);
  if (EC < 1) return (int)cudaErrorInvalidValue;
  const int ES = (int)stride(EC);
  const size_t smem = 2 * (size_t)RC * ES * sizeof(T);
  auto kernel = gather_matmul_kernel<T, RMAX, VEC>;
  cudaError_t e = allow_smem(kernel, smem);
  int grid = 0;
  if (e == cudaSuccess)
    e = persistent_grid(kernel, kThreads, smem, (int64_t)K * ((R + RC - 1) / RC), &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const int*>(blk_ids),
      static_cast<const T*>(v), static_cast<T*>(out), K, I, NB, L, R, RC, (int)EC, ES);
  return (int)cudaGetLastError();
}

// 16-byte slab loads when every row starts on a 16-byte boundary.
template <typename T, int RMAX>
int launch(const void* vals, const void* blk_ids, const void* v, void* out, int K, int I,
           int NB, int L, int R, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if ((int64_t)NB * L % VEC == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0)
    return launch_vec<T, RMAX, VEC>(vals, blk_ids, v, out, K, I, NB, L, R, stream);
  return launch_vec<T, RMAX, 1>(vals, blk_ids, v, out, K, I, NB, L, R, stream);
}

template <typename T>
int dispatch(const void* vals, const void* blk_ids, const void* v, void* out, int K, int I,
             int NB, int L, int R, cudaStream_t stream) {
  if (R <= 8) return launch<T, 8>(vals, blk_ids, v, out, K, I, NB, L, R, stream);
  return launch<T, 16>(vals, blk_ids, v, out, K, I, NB, L, R, stream);   // R chunks of 16
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Returns a cudaError_t (0 = success).
// Needs K, I, NB, L, R >= 1 (the wrapper returns zeros for an empty bucket
// without a launch).
int spartan_gather_matmul(int dtype, const void* vals, const void* blk_ids,
                          const void* v, void* out, int K, int I, int NB, int L,
                          int R, void* stream) {
  if (K < 1 || I < 1 || NB < 1 || L < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(vals, blk_ids, v, out, K, I, NB, L, R, s);
  if (dtype == 1) return dispatch<double>(vals, blk_ids, v, out, K, I, NB, L, R, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
