// What the port's CUDA sources share (sm_90a): the shared-memory limits,
// the cp.async primitives, the half-width operand types and their widening
// to the compute type, a division-free index walk, the 16-byte alignment
// test, the opt-in to more than 48 KB of dynamic shared memory, the size
// of a persistent grid and the ticket of the one-launch reductions across
// subjects.
// fused.cu, staged.cu, scoo.cu and gather_matmul.cu include it, each into
// its own library; kernels/_build.py hashes it into every build.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int kMaxDynamicSmem = 232448;    // 227 KB, the most a block may use
constexpr int kDefaultSmem = 48 * 1024;    // above this, opt in per kernel

// cp.async of BYTES (4, 8 or 16) into shared memory, completed by
// cp_async_wait; cp_async_commit closes the thread's current group.
template <int BYTES>
__device__ inline void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One element of E into shared memory: cp.async for 4- and 8-byte elements;
// a plain load and store for a 2-byte one, which cp.async does not take (it
// is in shared memory at the barrier after the caller's cp_async_wait).
template <typename E>
__device__ inline void copy_elem(E* dst, const E* src) {
  if constexpr (sizeof(E) >= 4)
    cp_async<sizeof(E)>(dst, src);
  else
    *dst = *src;
}

// The operand types of the kernels (the codes the C entry points take:
// 0 float32, 1 float64, 2 bfloat16, 3 float16). A kernel that streams a
// half-width operand (bfloat16 or float16) loads it at 2 bytes and widens
// it to float, its compute type, before any product: every sum
// accumulates in float (accum_dtype), as the reference's kernels do with
// preferred_element_type=float32. widen() is the identity on float and
// double.
using bf16 = __nv_bfloat16;
using f16 = __half;
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(f16 x) { return __half2float(x); }

// A half-width value from its 16 bits (little-endian: the first of two
// values packed in 32 bits is the low half).
template <typename S>
__device__ __forceinline__ S half_from_bits(unsigned short b);
template <>
__device__ __forceinline__ bf16 half_from_bits<bf16>(unsigned short b) {
  return __ushort_as_bfloat16(b);
}
template <>
__device__ __forceinline__ f16 half_from_bits<f16>(unsigned short b) {
  return __ushort_as_half(b);
}

// The dtype code of streamed operand j (0 the first) in an entry point's
// `dtypes` word: the first operand's code in bits 0-3; operand j's in bits
// 4j to 4j+3 as one more than its code, 0 there meaning the first
// operand's code. So a word of 0 or 1 gives every operand float32 or
// float64, and the words of the f32/f64 entry points before half
// precision are the same.
inline int operand_code(int dtypes, int j) {
  const int first = dtypes & 15;
  if (j == 0) return first;
  const int n = (dtypes >> (4 * j)) & 15;
  return n ? n - 1 : first;
}

// A thread's walk over the flat index u = start, start + n, ... of an array
// of rows of `width`, keeping (row, col) = divmod(u, width) without a
// division per step.
struct Walk {
  int row, col, drow, dcol, width;
  __device__ Walk(int start, int n, int w)
      : row(start / w), col(start % w), drow(n / w), dcol(n % w), width(w) {}
  __device__ void step() {
    row += drow;
    col += dcol;
    if (col >= width) { col -= width; ++row; }
  }
};

// True when every pointer starts on a 16-byte boundary.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// Let `kernel` take `smem` bytes of dynamic shared memory (an opt-in above
// 48 KB); more than a block may use is refused.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxDynamicSmem) return cudaErrorInvalidValue;
  if (smem > (size_t)kDefaultSmem)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

// A persistent grid: the blocks of `kernel` an SM holds at `smem` bytes of
// dynamic shared memory, times the SMs, at most `items`. The occupancy query
// costs host time comparable to a short kernel, so its answer is kept per
// (kernel, smem, device), the newest 32 answers of each kernel signature.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, int64_t items,
                            int* grid) {
  struct Entry { const void* fn; size_t smem; int dev, blocks; };
  static Entry cache[32];
  static int used = 0, next = 0;
  int dev = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == fn && cache[i].smem == smem && cache[i].dev == dev) blocks = cache[i].blocks;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return e;
    blocks = std::max(1, per_sm) * std::max(1, sms);
    cache[next] = {fn, smem, dev, blocks};   // the oldest answer goes
    next = (next + 1) % 32;
    used = std::min(used + 1, 32);
  }
  *grid = (int)std::min<int64_t>(items, blocks);
  return cudaSuccess;
}

// The reductions across subjects (F2 of fused.cu, rows 6 and 7 of
// staged.cu) are one launch, two levels, with a fixed order. The first level
// sums kRuns fixed runs of contiguous subjects (fewer for fewer subjects),
// one [R, R] partial each; the block that finishes last, the one that takes
// the last ticket of a counter, sums the partials (the second level) in the
// same launch. The partials lie entry-major, [R*R, ld], so that the second
// level reads each entry's run of partials contiguously; ld rounds the run
// count up to whole 16-byte packs, so every row starts on a 16-byte
// boundary. The caller's workspace (reduction_workspace elements of T,
// zeroed once when allocated) holds the 32-bit ticket counter first, at the
// same place whatever K (a workspace serves buckets of every K), then the
// partials; the counter is 0 before a launch and 0 after it.
constexpr int kRuns = 2048;

inline int reduction_runs(int K) { return std::min(K, kRuns); }

template <typename T>
__host__ __device__ inline int partials_ld(int runs) {
  constexpr int P = 16 / sizeof(T);
  return (runs + P - 1) / P * P;
}

// The elements of T the counter takes at a workspace's start: one 16-byte
// pack, so that the partials after it start on a 16-byte boundary.
template <typename T>
constexpr int counter_elems() { return 16 / (int)sizeof(T); }

// The elements of T of a reduction's workspace for K >= 1 subjects at rank
// R >= 1: the counter, then the partials [R*R, ld]; -1 past what an int
// counts.
template <typename T>
int reduction_workspace(int K, int R) {
  const int64_t n = counter_elems<T>() + (int64_t)R * R * partials_ld<T>(reduction_runs(K));
  return n > INT32_MAX ? -1 : (int)n;
}

// Called by every thread of a block once the block has stored its partials:
// true in the block that finishes last, which then reads the other blocks'
// partials (through L2: __ldcg or cp.async.cg, never the L1 cache, which is
// not coherent across SMs) and owns the counter, set back to 0 here.
// Thread 0's answer reaches the block through __syncthreads_or, not a
// static __shared__ flag, so that a kernel may take every byte of
// kMaxDynamicSmem as dynamic shared memory.
__device__ inline bool last_block_to_finish(unsigned* counter) {
  __threadfence();            // this thread's partials, visible device-wide
  __syncthreads();            // ... for every thread of the block
  bool mine = false;
  if (threadIdx.x == 0) {
    mine = atomicAdd(counter, 1u) == gridDim.x - 1;
    if (mine) *counter = 0;   // every block has taken its ticket
  }
  const bool last = __syncthreads_or(mine) != 0;
  if (last) __threadfence();  // the partials that the tickets announced
  return last;
}

}  // namespace
