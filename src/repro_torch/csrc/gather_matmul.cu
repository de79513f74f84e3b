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
// sums accumulate in T. Any R, I, NB; L up to 6,144 (f64) / 12,288 (f32).
//
// What bounds it on an H100 (3.35 TB/s): every value of vals (dense over its
// kept blocks, mostly zeros at EHR sparsity) is read once and takes part in
// R multiply-adds, below the ~20 operations per byte before arithmetic is
// the limit, so it is bound by the bytes of vals, the V blocks and the
// output. Design, simple first: one block per (subject k, tile of I rows),
// each thread one output entry (i, r) of a chunk of R. For each of the NB
// blocks the block stages V[blk_ids[k, b] * L : + L, chunk] in shared
// memory (the TPU kernel had the DMA engine fetch that block through a
// scalar-prefetched index map), then every thread sums its row's L values
// against its column of the staged block. R is chunked so that L x chunk
// fits in 48 KB. One owner per entry and a fixed order: no atomics, two
// runs give the same bits.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_launch.py):
// the entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 32;              // R columns staged at a time
constexpr int kSmemBytes = 48 * 1024;      // default dynamic shared memory

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_matmul_kernel(const T* __restrict__ vals, const int* __restrict__ blk_ids,
                     const T* __restrict__ v, T* __restrict__ out, int K, int I,
                     int NB, int L, int R, int chunk, int tile_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vs = reinterpret_cast<T*>(smem_raw);  // [L, chunk]
  const int tiles = (I + tile_i - 1) / tile_i;
  const int k = blockIdx.x / tiles;
  const int li = threadIdx.x / chunk, lr = threadIdx.x - li * chunk;
  const int i = (blockIdx.x - k * tiles) * tile_i + li;
  const bool row_ok = li < tile_i && i < I;
  for (int r0 = 0; r0 < R; r0 += chunk) {  // block-uniform loops
    const int w = min(chunk, R - r0);
    const bool owner = row_ok && lr < w;
    T acc = T(0);
    for (int b = 0; b < NB; ++b) {
      const int64_t base = (int64_t)blk_ids[(int64_t)k * NB + b] * L;
      __syncthreads();                     // the previous block is read
      for (int e = threadIdx.x; e < L * w; e += blockDim.x) {
        const int l = e / w, c = e - l * w;
        vs[l * chunk + c] = v[(base + l) * R + r0 + c];
      }
      __syncthreads();
      if (owner) {
        const T* x = vals + (((int64_t)k * I + i) * NB + b) * L;
        T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
        int l = 0;
        for (; l + 3 < L; l += 4) {
          s0 += x[l] * vs[l * chunk + lr];
          s1 += x[l + 1] * vs[(l + 1) * chunk + lr];
          s2 += x[l + 2] * vs[(l + 2) * chunk + lr];
          s3 += x[l + 3] * vs[(l + 3) * chunk + lr];
        }
        for (; l < L; ++l) s0 += x[l] * vs[l * chunk + lr];
        acc += (s0 + s1) + (s2 + s3);
      }
    }
    if (owner) out[((int64_t)k * I + i) * R + r0 + lr] = acc;
  }
}

template <typename T>
int launch(const void* vals, const void* blk_ids, const void* v, void* out,
           int K, int I, int NB, int L, int R, cudaStream_t stream) {
  const int chunk = std::min({R, kMaxChunk, kSmemBytes / (L * (int)sizeof(T))});
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int tile_i = kThreads / chunk;
  const int64_t grid = (int64_t)K * ((I + tile_i - 1) / tile_i);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  gather_matmul_kernel<T><<<(int)grid, kThreads, (size_t)L * chunk * sizeof(T), stream>>>(
      static_cast<const T*>(vals), static_cast<const int*>(blk_ids),
      static_cast<const T*>(v), static_cast<T*>(out), K, I, NB, L, R, chunk, tile_i);
  return (int)cudaGetLastError();
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
  if (dtype == 0) return launch<float>(vals, blk_ids, v, out, K, I, NB, L, R, s);
  if (dtype == 1) return launch<double>(vals, blk_ids, v, out, K, I, NB, L, R, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
