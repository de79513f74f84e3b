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
// f32 -> f32, f64 -> f64). At half precision the values (S) may be
// bfloat16 or float16, with T = float: row 11 takes vals and Vg half, row
// 12 vals half (Q stays float); a half value is loaded at 2 bytes and
// widened to float before its product (common.cuh), and the outputs are
// float, as the Pallas kernels' are. Any R, I, C, N. All tensors contiguous,
// row-major.
//
// What bounds them on an H100 (3.35 TB/s): each triplet takes part in R
// multiply-adds against 12-24 bytes of triplet and index, far below the ~20
// operations per byte before arithmetic is the limit, so both are bound by
// bytes: the triplets, the segment ends, the factor rows they touch and the
// output (for row 12 at C_pad = 128 the dense Yc dominates). Each output
// entry has one owner that sums its segment in order, m = m0 .. m1 - 1, one
// running sum: no atomics, so two runs give the same bits, and an empty
// segment (a padded column or subject) writes an exact zero. The TPU kernels
// turned each gather into a one-hot matmul on the MXU and skipped
// all-padding blocks by a scalar-prefetched nnz count; none of that is
// carried over: the segment ends say where each sum starts and stops, so
// explicit zero-valued triplets inside the true nnz count like any other.
// Both stage their subjects in shared memory, with the simple first design
// kept as the fallback for subjects too large for that (their notes below).
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_launch.py):
// every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;    // grid-stride loops beyond this

int grid_for(int64_t n) {
  return (int)std::min<int64_t>(kMaxBlocks, (n + kThreads - 1) / kThreads);
}

constexpr int kRingThreads = 128;         // 64 was 13% slower for row 12 in paired H100 timings
constexpr int kRingBudget = 64 * 1024;     // a ring block's shared memory, at most

// Copy n elements of E from src into shared memory at dst, thread t of nt:
// 16-byte packs (reading up to the next whole pack, which the caller keeps
// in bounds) when ALIGNED, else one element a copy (copy_elem).
template <typename E, bool ALIGNED>
__device__ inline void copy_run(int t, int nt, E* dst, const E* __restrict__ src, int n) {
  if constexpr (ALIGNED) {
    constexpr int V = 16 / sizeof(E);
    for (int p = t; p * V < n; p += nt) cp_async<16>(dst + p * V, src + p * V);
  } else {
    for (int u = t; u < n; u += nt) copy_elem(dst + u, src + u);
  }
}

// Write n elements of T from shared memory to dst, thread t of nt, 16 bytes
// a store when ALIGNED (n is then whole packs), else one element a store.
template <typename T, bool ALIGNED>
__device__ inline void store_run(int t, int nt, T* __restrict__ dst, const T* src, int n) {
  if constexpr (ALIGNED) {
    for (int p = t; p * (16 / (int)sizeof(T)) < n; p += nt)
      reinterpret_cast<int4*>(dst)[p] = reinterpret_cast<const int4*>(src)[p];
  } else {
    for (int u = t; u < n; u += nt) dst[u] = src[u];
  }
}

__host__ __device__ inline size_t whole_packs(size_t bytes) { return (bytes + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// Row 11, xk_times_v. Replaces src/repro/kernels/scoo.py xk_times_v_pallas
// (:249, pallas_call at :276, body _xkv_kernel at :221). Bound: vals and
// lcols up to the true nnz, row_ends, the kept rows of Vg and the dense
// output (134 MB at the main path's largest SCOO bucket). Two variants,
// picked by shape (xkv_variant):
//
// RING, the main path (a warp's stages and output tile fit in a quarter of
// kRingBudget). What held the thread-per-entry design below at 19% of the
// bound: each thread walked its segment through a chain of dependent loads
// from device memory (row_ends, then vals and lcols, then a Vg row), the R
// threads of a row repeated that chain, and every thread did two 64-bit
// divisions. Here each warp of a persistent block walks over its own
// subjects (at I = 48 a warp's lanes all own rows, where a block's would be
// 48 of 128), three subjects deep. While the warp sums subject n, cp.async
// copies subject n+2's vals and lcols (up to its true nnz, row_ends[k, I-1],
// read a subject earlier so that no copy waits for it) and its row_ends
// into one of three triplet stages, and subject n+1's Vg rows 0 .. its
// largest lcol, found from its staged lcols, into the other of two Vg
// stages: in bucketize's layout the kept slots are a prefix, so this is the
// 10-20 kept rows of C_pad 128 at CHOA's density (all 128 rows would be
// more bytes than the whole bound), and any lcols in [0, C) stay right.
// 16 bytes a copy when every run is whole 16-byte packs, else one element.
// A lane owns a row (i = lane, lane + 32, ...) and all R sums of it in
// registers (R in chunks of RMAX), walks the row's segment in shared memory
// in the fallback's order, so the bits are the same, and puts the sums in
// an output tile [I, R]; the warp then writes X_k V [I, R], one contiguous
// run, with 16-byte stores. About 9.9 KB a warp at I 48, C 128, N 136, R 5,
// f32.
//
// THREAD-PER-ENTRY (a subject too large for the ring): one thread per entry
// (k, i, r) of X_k V, reading straight from device memory (threads of one
// (k, i) are neighbours in a warp, r fastest, so the stores are contiguous).
//
// The ring stages the triplets up to the true nnz, so it takes every
// segment to lie in [0, nnz_k), nnz_k = row_ends[k, I-1], which is the
// bucket's layout.
// ---------------------------------------------------------------------------
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
xkv_kernel(const S* __restrict__ vals, const int* __restrict__ lcols,
           const S* __restrict__ vg, const int* __restrict__ row_ends,
           T* __restrict__ out, int Kb, int N, int I, int C, int R) {
  const int64_t IR = (int64_t)I * R, n_out = (int64_t)Kb * IR;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < n_out;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = t / IR;
    const int p = (int)(t - k * IR), i = p / R, r = p - i * R;
    const int* ends = row_ends + k * I;
    const int n0 = i ? ends[i - 1] : 0, n1 = ends[i];
    const S* v = vals + k * N;
    const int* lc = lcols + k * N;
    const S* g = vg + k * C * R + r;
    T acc = T(0);
    for (int n = n0; n < n1; ++n) acc += widen(v[n]) * widen(g[(int64_t)lc[n] * R]);
    out[t] = acc;
  }
}


// Row 11's ring per warp, in bytes from the warp's start: three triplet
// stages (vals [N] of S, lcols [N], row_ends [I]), two Vg stages [C, R] of
// S and the output tile [I, R] of T, each part a whole number of 16-byte
// packs.
struct XkvLayout {
  size_t lcols, ends, trip, vg, vg_stage, tile, warp_bytes;
};

template <typename T, typename S>
__host__ __device__ inline XkvLayout xkv_layout(int N, int I, int C, int R) {
  XkvLayout s;
  s.lcols = whole_packs((size_t)N * sizeof(S));
  s.ends = s.lcols + whole_packs((size_t)N * sizeof(int));
  s.trip = s.ends + whole_packs((size_t)I * sizeof(int));
  s.vg = 3 * s.trip;
  s.vg_stage = whole_packs((size_t)C * R * sizeof(S));
  s.tile = s.vg + 2 * s.vg_stage;
  s.warp_bytes = s.tile + whole_packs((size_t)I * R * sizeof(T));
  return s;
}

constexpr int kXkvWarps = kRingThreads / 32;    // walkers a block

template <typename T, typename S, int RMAX, bool ALIGNED>
__global__ void __launch_bounds__(kRingThreads)
xkv_ring_kernel(const S* __restrict__ vals, const int* __restrict__ lcols,
                const S* __restrict__ vg, const int* __restrict__ row_ends,
                T* __restrict__ out, int Kb, int N, int I, int C, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const XkvLayout lay = xkv_layout<T, S>(N, I, C, R);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  unsigned char* mine = smem_raw + warp * lay.warp_bytes;
  T* tile = reinterpret_cast<T*>(mine + lay.tile);
  const int64_t walker = (int64_t)blockIdx.x * warps + warp;
  const int64_t walkers = (int64_t)gridDim.x * warps;
  const int n_mine = Kb > walker ? (int)((Kb - 1 - walker) / walkers + 1) : 0;
  auto subject = [&](int n) { return walker + n * walkers; };
  // the true nnz of the warp's n-th subject (0 past its last)
  auto count = [&](int n) {
    return n < n_mine ? min(N, max(0, __ldg(row_ends + subject(n) * I + I - 1))) : 0;
  };
  auto trip = [&](int n) { return mine + n % 3 * lay.trip; };
  auto vg_stage = [&](int n) { return mine + lay.vg + (n & 1) * lay.vg_stage; };
  auto fetch_triplets = [&](int n, int cnt) {
    const int64_t k = subject(n);
    unsigned char* st = trip(n);
    copy_run<S, ALIGNED>(lane, 32, reinterpret_cast<S*>(st), vals + k * N, cnt);
    copy_run<int, ALIGNED>(lane, 32, reinterpret_cast<int*>(st + lay.lcols), lcols + k * N, cnt);
    copy_run<int, ALIGNED>(lane, 32, reinterpret_cast<int*>(st + lay.ends), row_ends + k * I, I);
  };
  // subject n's Vg rows 0 .. its largest lcol (its triplets are in)
  auto fetch_vg = [&](int n) {
    const unsigned char* st = trip(n);
    const int* lc = reinterpret_cast<const int*>(st + lay.lcols);
    const int cnt = min(N, max(0, reinterpret_cast<const int*>(st + lay.ends)[I - 1]));
    int top = -1;
    for (int u = lane; u < cnt; u += 32) top = max(top, lc[u]);
    top = __reduce_max_sync(0xffffffffu, top);
    copy_run<S, ALIGNED>(lane, 32, reinterpret_cast<S*>(vg_stage(n)), vg + subject(n) * C * R,
                         (top + 1) * R);
  };

  if (n_mine > 0) fetch_triplets(0, count(0));
  cp_async_commit();
  int cnt_next = count(1);                   // used by the prologue's copies
  cp_async_wait<0>();
  __syncwarp();
  if (n_mine > 0) fetch_vg(0);
  if (n_mine > 1) fetch_triplets(1, cnt_next);
  cp_async_commit();
  cnt_next = count(2);                       // used by iteration 0's copies
  for (int n = 0; n < n_mine; ++n) {         // warp-uniform
    const int cnt_after = count(n + 3);      // used by the next iteration's copies
    cp_async_wait<0>();                      // subject n's Vg rows, n+1's triplets are in
    __syncwarp();                            // the warp's; n-1's stages and the tile are read
    if (n + 1 < n_mine) fetch_vg(n + 1);
    if (n + 2 < n_mine) fetch_triplets(n + 2, cnt_next);
    cp_async_commit();
    cnt_next = cnt_after;

    const unsigned char* st = trip(n);
    const S* v_s = reinterpret_cast<const S*>(st);
    const int* lc_s = reinterpret_cast<const int*>(st + lay.lcols);
    const int* ends_s = reinterpret_cast<const int*>(st + lay.ends);
    const S* g_s = reinterpret_cast<const S*>(vg_stage(n));
    for (int i = lane; i < I; i += 32) {
      const int n0 = i ? ends_s[i - 1] : 0, n1 = ends_s[i];
      for (int r0 = 0; r0 < R; r0 += RMAX) {
        T acc[RMAX];
#pragma unroll
        for (int r = 0; r < RMAX; ++r) acc[r] = T(0);
        for (int m = n0; m < n1; ++m) {
          const T v = widen(v_s[m]);
          const S* grow = g_s + lc_s[m] * R + r0;
#pragma unroll
          for (int r = 0; r < RMAX; ++r)
            if (r0 + r < R) acc[r] += v * widen(grow[r]);
        }
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r0 + r < R) tile[i * R + r0 + r] = acc[r];
      }
    }
    __syncwarp();                            // the tile is whole
    store_run<T, ALIGNED>(lane, 32, out + subject(n) * I * R, tile, I * R);
  }
  cp_async_wait<0>();                        // leave no copy in flight
}

// ---------------------------------------------------------------------------
// Row 12, project. Replaces src/repro/kernels/scoo.py project_pallas (:313,
// pallas_call at :341, body _project_kernel at :284). Bound: vals, rows and
// cperm up to the true nnz, col_ends, the Q rows read and the dense Yc
// output (149 of ~292 MB at the main path's largest SCOO bucket). Two
// variants, picked by shape (project_variant):
//
// RING, the main path (a subject's operands, two stages of them and its
// output tile fit in kRingBudget). What held the thread-per-entry design
// below at 14% of the bound: each thread walked its segment through four
// dependent loads from device memory per triplet (cperm, then vals and
// rows, then a Q row); the R threads of one column sat in different warps
// and each repeated that chain; every thread did two 64-bit divisions.
// Here persistent blocks walk over subjects. While a block sums subject n,
// cp.async copies subject n+1's vals, rows and cperm (up to its true nnz,
// col_ends[k, C-1], read one subject earlier so that no copy waits for it),
// its col_ends and Q_k [I, R] into the other of two shared-memory stages
// (16 bytes a copy when every run is whole 16-byte packs, else one element):
// about 3.1 KB a stage at I 48, C 128, N 136, R 5, f32, so many blocks share
// an SM and their copies overlap each other's sums. A lane owns a column
// (c = tid, tid + blockDim, ...) and all R sums of it in registers (R in
// chunks of RMAX), walks the column's segment in shared memory in the same
// order as the fallback, so the bits are the same, and puts the sums in an
// output tile [R, C]; the block then writes Yc[k], one contiguous run of
// R*C values, with 16-byte stores. No division in any loop: a block's n-th
// subject is blockIdx.x + n * gridDim.x.
//
// THREAD-PER-ENTRY (a subject too large for the ring): one thread per entry
// (k, r, c) of Yc, walking column c's run of the column-sorted view
// straight from device memory; threads of one (k, r) are neighbours in a
// warp (c fastest), so the stores are contiguous.
//
// Both read the triplets a segment names: the ring stages them up to the
// true nnz, so it takes cperm[k, :nnz_k] to be a permutation of
// [0, nnz_k), nnz_k = col_ends[k, C-1], which is the bucket's layout.
// ---------------------------------------------------------------------------
// The ring's shared memory, in bytes from its start: per stage vals [N] of
// S, Q_k [I, R] of T, rows [N], cperm [N] and col_ends [C], each part a
// whole number of 16-byte packs; after the two stages the output tile [R,
// C] of T.
struct ProjectLayout {
  size_t q, rows, cperm, ends, stage, tile, smem_bytes;
};

template <typename T, typename S>
__host__ __device__ inline ProjectLayout project_layout(int N, int I, int C, int R) {
  ProjectLayout s;
  s.q = whole_packs((size_t)N * sizeof(S));
  s.rows = s.q + whole_packs((size_t)I * R * sizeof(T));
  s.cperm = s.rows + whole_packs((size_t)N * sizeof(int));
  s.ends = s.cperm + whole_packs((size_t)N * sizeof(int));
  s.stage = s.ends + whole_packs((size_t)C * sizeof(int));
  s.tile = 2 * s.stage;
  s.smem_bytes = s.tile + whole_packs((size_t)R * C * sizeof(T));
  return s;
}

template <typename T, typename S, int RMAX, bool ALIGNED>
__global__ void __launch_bounds__(kRingThreads)
project_ring_kernel(const S* __restrict__ vals, const int* __restrict__ rows,
                    const int* __restrict__ cperm, const T* __restrict__ q,
                    const int* __restrict__ col_ends, T* __restrict__ out, int Kb,
                    int N, int I, int C, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ProjectLayout lay = project_layout<T, S>(N, I, C, R);
  T* tile = reinterpret_cast<T*>(smem_raw + lay.tile);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n_mine = Kb > (int)blockIdx.x ? (Kb - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  auto subject = [&](int n) { return (int64_t)blockIdx.x + (int64_t)n * gridDim.x; };
  // the true nnz of the block's n-th subject (0 past its last)
  auto count = [&](int n) {
    return n < n_mine ? min(N, max(0, __ldg(col_ends + subject(n) * C + C - 1))) : 0;
  };
  auto fetch = [&](unsigned char* st, int64_t k, int cnt) {
    copy_run<S, ALIGNED>(tid, nthr, reinterpret_cast<S*>(st), vals + k * N, cnt);
    copy_run<T, ALIGNED>(tid, nthr, reinterpret_cast<T*>(st + lay.q), q + k * I * R, I * R);
    copy_run<int, ALIGNED>(tid, nthr, reinterpret_cast<int*>(st + lay.rows), rows + k * N, cnt);
    copy_run<int, ALIGNED>(tid, nthr, reinterpret_cast<int*>(st + lay.cperm), cperm + k * N, cnt);
    copy_run<int, ALIGNED>(tid, nthr, reinterpret_cast<int*>(st + lay.ends), col_ends + k * C, C);
  };

  int cnt_next = count(1);                   // used by iteration 0's copies
  if (n_mine > 0) fetch(smem_raw, subject(0), count(0));
  cp_async_commit();
  for (int n = 0; n < n_mine; ++n) {         // block-uniform
    const int cnt_after = count(n + 2);      // used by the next iteration's copies
    cp_async_wait<0>();                      // subject n's copies are in
    __syncthreads();                         // everyone's; stage n-1 is read
    if (n + 1 < n_mine) fetch(smem_raw + ((n + 1) & 1) * lay.stage, subject(n + 1), cnt_next);
    cp_async_commit();
    cnt_next = cnt_after;

    const unsigned char* st = smem_raw + (n & 1) * lay.stage;
    const S* v_s = reinterpret_cast<const S*>(st);
    const T* q_s = reinterpret_cast<const T*>(st + lay.q);
    const int* rw_s = reinterpret_cast<const int*>(st + lay.rows);
    const int* perm_s = reinterpret_cast<const int*>(st + lay.cperm);
    const int* ends_s = reinterpret_cast<const int*>(st + lay.ends);
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const int m0 = c ? ends_s[c - 1] : 0, m1 = ends_s[c];
      for (int r0 = 0; r0 < R; r0 += RMAX) {
        T acc[RMAX];
#pragma unroll
        for (int r = 0; r < RMAX; ++r) acc[r] = T(0);
        for (int m = m0; m < m1; ++m) {
          const int t = perm_s[m];
          const T v = widen(v_s[t]);
          const T* qrow = q_s + rw_s[t] * R + r0;
#pragma unroll
          for (int r = 0; r < RMAX; ++r)
            if (r0 + r < R) acc[r] += v * qrow[r];
        }
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r0 + r < R) tile[(r0 + r) * C + c] = acc[r];
      }
    }
    __syncthreads();                         // the tile is whole
    store_run<T, ALIGNED>(tid, nthr, out + subject(n) * R * C, tile, R * C);
  }
  cp_async_wait<0>();                        // leave no copy in flight
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
project_kernel(const S* __restrict__ vals, const int* __restrict__ rows,
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
    const S* v = vals + k * N;
    const int* rw = rows + k * N;
    const int* perm = cperm + k * N;
    const T* qk = q + k * I * R + r;
    T acc = T(0);
    for (int m = m0; m < m1; ++m) {
      const int n = perm[m];
      acc += widen(v[n]) * qk[(int64_t)rw[n] * R];
    }
    out[t] = acc;
  }
}

// The variants of rows 11 and 12, as spartan_scoo_xk_times_v_variant and
// spartan_scoo_project_variant report them.
enum Variant { kRing = 0, kRingElementCopies = 1, kThreadPerEntry = 2 };

// Row 11: RING where a block of kXkvWarps warps' rings fits kRingBudget
// (16-byte copies and stores when every run a copy or store takes is whole
// 16-byte packs and every operand starts on a 16-byte boundary), else
// THREAD-PER-ENTRY.
template <typename T, typename S>
int xkv_variant(int N, int I, int C, int R, bool aligned) {
  if (xkv_layout<T, S>(N, I, C, R).warp_bytes * kXkvWarps > (size_t)kRingBudget)
    return kThreadPerEntry;
  const int64_t V = 16 / (int)sizeof(T), VS = 16 / (int)sizeof(S);
  const bool packs = N % 4 == 0 && N % VS == 0 && I % 4 == 0 && (int64_t)I * R % V == 0 &&
                     (int64_t)C * R % VS == 0;
  return aligned && packs ? kRing : kRingElementCopies;
}

template <typename T, typename S, int RMAX>
cudaError_t launch_xkv(const void* vals, const void* lcols, const void* vg,
                       const void* row_ends, void* out, int Kb, int N, int I, int C,
                       int R, cudaStream_t stream) {
  const int variant = xkv_variant<T, S>(N, I, C, R,
                                        aligned16({vals, lcols, vg, row_ends, out}));
  if (variant == kThreadPerEntry) {
    xkv_kernel<T, S><<<grid_for((int64_t)Kb * I * R), kThreads, 0, stream>>>(
        static_cast<const S*>(vals), static_cast<const int*>(lcols), static_cast<const S*>(vg),
        static_cast<const int*>(row_ends), static_cast<T*>(out), Kb, N, I, C, R);
    return cudaGetLastError();
  }
  const size_t smem = xkv_layout<T, S>(N, I, C, R).warp_bytes * kXkvWarps;
  auto kernel = variant == kRing ? xkv_ring_kernel<T, S, RMAX, true>
                                 : xkv_ring_kernel<T, S, RMAX, false>;
  cudaError_t e = allow_smem(kernel, smem);
  int grid = 0;
  if (e == cudaSuccess)
    e = persistent_grid(kernel, kRingThreads, smem, (Kb - 1) / kXkvWarps + 1, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kRingThreads, smem, stream>>>(
      static_cast<const S*>(vals), static_cast<const int*>(lcols), static_cast<const S*>(vg),
      static_cast<const int*>(row_ends), static_cast<T*>(out), Kb, N, I, C, R);
  return cudaGetLastError();
}

// Row 12: RING where two stages and the tile fit kRingBudget (16-byte copies
// and stores when every run a copy or store takes is whole 16-byte packs and
// every operand starts on a 16-byte boundary), else THREAD-PER-ENTRY.
template <typename T, typename S>
int project_variant(int N, int I, int C, int R, bool aligned) {
  if (project_layout<T, S>(N, I, C, R).smem_bytes > (size_t)kRingBudget) return kThreadPerEntry;
  const bool packs = N % 4 == 0 && N % (16 / (int)sizeof(S)) == 0 && C % 4 == 0 &&
                     (int64_t)I * R % (16 / (int)sizeof(T)) == 0;
  return aligned && packs ? kRing : kRingElementCopies;
}

template <typename T, typename S, int RMAX>
cudaError_t launch_project(const void* vals, const void* rows, const void* cperm,
                           const void* q, const void* col_ends, void* out, int Kb,
                           int N, int I, int C, int R, cudaStream_t stream) {
  const int variant = project_variant<T, S>(N, I, C, R,
                                            aligned16({vals, rows, cperm, q, col_ends, out}));
  if (variant == kThreadPerEntry) {
    project_kernel<T, S><<<grid_for((int64_t)Kb * R * C), kThreads, 0, stream>>>(
        static_cast<const S*>(vals), static_cast<const int*>(rows),
        static_cast<const int*>(cperm), static_cast<const T*>(q),
        static_cast<const int*>(col_ends), static_cast<T*>(out), Kb, N, I, C, R);
    return cudaGetLastError();
  }
  const size_t smem = project_layout<T, S>(N, I, C, R).smem_bytes;
  auto kernel = variant == kRing ? project_ring_kernel<T, S, RMAX, true>
                                 : project_ring_kernel<T, S, RMAX, false>;
  cudaError_t e = allow_smem(kernel, smem);
  int grid = 0;
  if (e == cudaSuccess) e = persistent_grid(kernel, kRingThreads, smem, Kb, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kRingThreads, smem, stream>>>(
      static_cast<const S*>(vals), static_cast<const int*>(rows),
      static_cast<const int*>(cperm), static_cast<const T*>(q),
      static_cast<const int*>(col_ends), static_cast<T*>(out), Kb, N, I, C, R);
  return cudaGetLastError();
}

}  // namespace

// Run the statement(s) with (T, S) from the values' code CODE: 0 (float,
// float), 1 (double, double), 2 (float, bfloat16), 3 (float, float16);
// return FAIL for any other code.
#define SPARTAN_BY_VALUES(FAIL, CODE, ...)                                    \
  do {                                                                        \
    if ((CODE) == 0) { using T = float; using S = float; __VA_ARGS__; }       \
    if ((CODE) == 1) { using T = double; using S = double; __VA_ARGS__; }     \
    if ((CODE) == 2) { using T = float; using S = bf16; __VA_ARGS__; }        \
    if ((CODE) == 3) { using T = float; using S = f16; __VA_ARGS__; }         \
    return FAIL;                                                              \
  } while (0)

extern "C" {

// dtypes: the dtype code of each streamed operand (0 float32, 1 float64,
// 2 bfloat16, 3 float16), packed as common.cuh's operand_code reads it:
// vals then Vg for row 11 (one code for both), vals for row 12. With a half
// code Q and the outputs are float32, else they take the values' dtype.
// Returns a cudaError_t (0 = success); a combination not listed is
// cudaErrorInvalidValue, before any launch. Both entry points need Kb, N,
// I, C, R >= 1 (the wrappers return zeros for an empty bucket without a
// launch).

// Both take register tiles of 8 entries of R, or 32 with R in chunks of 32
// above 8.
int spartan_scoo_xk_times_v(int dtypes, const void* vals, const void* lcols,
                            const void* vg, const void* row_ends, void* out,
                            int Kb, int N, int I, int C, int R, void* stream) {
  if (Kb < 1 || N < 1 || I < 1 || C < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = operand_code(dtypes, 0);
  if (operand_code(dtypes, 1) != code) return (int)cudaErrorInvalidValue;
  SPARTAN_BY_VALUES((int)cudaErrorInvalidValue, code, return (int)(R <= 8
      ? launch_xkv<T, S, 8>(vals, lcols, vg, row_ends, out, Kb, N, I, C, R, s)
      : launch_xkv<T, S, 32>(vals, lcols, vg, row_ends, out, Kb, N, I, C, R, s)));
}

// The variant a spartan_scoo_xk_times_v launch takes (Variant: 0 ring, 1
// ring with element copies, 2 thread-per-entry) for values of dtype code
// `dtype`; aligned: every operand and the output start on a 16-byte
// boundary. -1 for an unknown dtype.
int spartan_scoo_xk_times_v_variant(int dtype, int N, int I, int C, int R, int aligned) {
  if (N < 1 || I < 1 || C < 1 || R < 1) return -1;
  SPARTAN_BY_VALUES(-1, dtype, return xkv_variant<T, S>(N, I, C, R, aligned != 0));
}

int spartan_scoo_project(int dtypes, const void* vals, const void* rows,
                         const void* cperm, const void* q, const void* col_ends,
                         void* out, int Kb, int N, int I, int C, int R,
                         void* stream) {
  if (Kb < 1 || N < 1 || I < 1 || C < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  SPARTAN_BY_VALUES((int)cudaErrorInvalidValue, operand_code(dtypes, 0),
                    return (int)(R <= 8
      ? launch_project<T, S, 8>(vals, rows, cperm, q, col_ends, out, Kb, N, I, C, R, s)
      : launch_project<T, S, 32>(vals, rows, cperm, q, col_ends, out, Kb, N, I, C, R, s)));
}

// The variant a spartan_scoo_project launch takes (Variant: 0 ring,
// 1 ring with element copies, 2 thread-per-entry) for values of dtype code
// `dtype`; aligned: every operand and the output start on a 16-byte
// boundary. -1 for an unknown dtype.
int spartan_scoo_project_variant(int dtype, int N, int I, int C, int R, int aligned) {
  if (N < 1 || I < 1 || C < 1 || R < 1) return -1;
  SPARTAN_BY_VALUES(-1, dtype, return project_variant<T, S>(N, I, C, R, aligned != 0));
}

}  // extern "C"
