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
// Rows 6 and 9 are row 5's product with another epilogue (row 9 in row 5's
// ring kernel, row 6 in row 7's reduction kernel), and rows 7 and 10 the
// same epilogues on a cached YkV.
//
// Shapes (one bucket): Yc [K, R, C], Vg [K, C, R], YkV [K, R, R], Wb [K, R]
// (W rows, subject mask folded in), H [R, R], col_mask [K, C], mask [K] (or
// null: no subject mask). T is float or double; every sum accumulates in T
// (accum_dtype: f32 -> f32, f64 -> f64). At half precision Yc (TY) and Vg
// (TV) may be half-width (bfloat16 or float16) with T = float: rows 5, 6
// and 9 take each of the two in float or half, row 8 a half Yc; a half
// value is loaded at 2 bytes and widened to float before its product
// (common.cuh). Rows 7 and 10 read YkV, float or double. Any R and C. All
// tensors are contiguous, row-major.
//
// What bounds them on an H100 (3.35 TB/s): at rank R every Yc and Vg element
// takes part in R multiply-adds, below the ~20 operations per byte before
// arithmetic is the limit, so all six are bound by bytes; rows 7 and 10 read
// only [K, R, R] and are bound by their launch. Rows 5 and 9 share one
// persistent cp.async ring (ykv_ring_kernel, two epilogues) and row 8
// streams C tiles through a ring of its own (their notes below). Rows 6, 7
// and 10, and the fallbacks for shapes too large for shared memory, take
// one thread per output entry, reading its operands straight from device
// memory: a warp's lanes cover neighbouring entries, so the Yc row a lane
// reads is the one its neighbours read (one load serves them all) and the
// L1 cache holds each 32-byte sector across the next iterations. The TPU kernels' padding
// of C to block_c is not carried over: a thread loops over the C it is
// given (row 8 masks its last tile's ragged edge). The two reductions
// across subjects (rows 6, 7) are one launch each, two-level and
// deterministic, as F2 of fused.cu: fixed runs of subjects per block, then
// the block that finishes last sums the partials in a fixed order; no
// atomic touches a sum, so two runs give the same bits.
//
// Rows 5, 9 and 10 keep one summation order whatever their variant: each
// product entry (Yc_k Vg_k)[r, l] in yv_entry's order, the coldot over r in
// order (s += H[r, l] * y), then s * mask[k]; so mode3 equals mode3_reuse
// of ykv bit for bit.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_launch.py):
// every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success); rows 6
// and 7 take the caller's workspace (spartan_mode1_workspace).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int64_t kMaxBlocks = 1 << 20;    // grid-stride loops beyond this

int grid_for(int64_t n) {
  return (int)std::min<int64_t>(kMaxBlocks, (n + kThreads - 1) / kThreads);
}

// (Yc_k Vg_k)[r, l] = sum_c yc_row[c] * vg_col[c * R], with yc_row =
// Yc[k, r, :] and vg_col = Vg[k, :, l]; four running sums, for independent
// loads in flight and a shorter chain of roundings.
template <typename T, typename TY, typename TV>
__device__ inline T yv_entry(const TY* __restrict__ yc_row,
                             const TV* __restrict__ vg_col, int C, int R) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int c = 0;
  for (; c + 3 < C; c += 4) {
    s0 += widen(yc_row[c]) * widen(vg_col[(int64_t)c * R]);
    s1 += widen(yc_row[c + 1]) * widen(vg_col[(int64_t)(c + 1) * R]);
    s2 += widen(yc_row[c + 2]) * widen(vg_col[(int64_t)(c + 2) * R]);
    s3 += widen(yc_row[c + 3]) * widen(vg_col[(int64_t)(c + 3) * R]);
  }
  for (; c < C; ++c) s0 += widen(yc_row[c]) * widen(vg_col[(int64_t)c * R]);
  return (s0 + s1) + (s2 + s3);
}

// ---------------------------------------------------------------------------
// Row 5, ykv. Replaces src/repro/kernels/ykv.py ykv_pallas (pallas_call at
// :53): YkV[k] = Yc_k Vg_k. Row 9, mode3 (its notes below), forms the same
// product in the same ring and ends in a coldot instead. Bound: the bytes of
// Yc, Vg and YkV (R = 5, f32: 2R operations per 8 bytes of Yc and Vg).
// Three variants, picked by shape (ring_variant):
//
// RING, the main path (two stages of one subject's Yc_k and Vg_k fit in the
// shared memory a block may use). What held the thread-per-entry design
// below at 35% of the bound: the R*R threads of a subject each read a whole
// Yc row and a whole Vg column from device memory, Vg at stride R, by 4-byte
// loads, and every thread divided in 64 bits. Here persistent blocks walk
// over groups of S subjects (S = 128 / (R*R) at most, 5 at R = 5). While a
// block computes one group, cp.async copies the next group's Yc and Vg (one
// contiguous run each) into the other of two shared-memory stages (16 bytes
// a copy when the rows of Yc are whole 16-byte runs; RING-ELEMENT-COPIES,
// one element a copy, otherwise: cp.async takes no 2-byte copy, so a half
// element is a plain load and store). The stages hold half operands at
// half width. A thread owns an entry (s, r, l) of the
// group and sums it from shared memory in yv_entry's order (four running
// sums over c mod 4, the tail into the first, (s0 + s1) + (s2 + s3)),
// reading four Yc values at a time with one 16-byte load, so the bits are
// the thread-per-entry kernel's. Bank conflicts: Yc rows are padded to a
// stride of 16 mod 128 bytes, so the R rows that the threads of one column
// read lie in different banks, and each subject's Vg to 64 mod 128 bytes,
// so two subjects in one warp read different banks. YkV of a group is one
// contiguous run of S*R*R values: the block writes it from an output tile
// with 16-byte stores between an element-wise head and tail (store_run; at
// R = 5 a group's run does not start on a 16-byte boundary). At R = 5, C =
// 128, f32 a block holds about 53 KB.
//
// THREAD-PER-ENTRY (one subject's two stages exceed the 227 KB a block may
// use, e.g. R = 72 at C_pad = 1024): one thread per entry (k, r, l), its
// operands straight from device memory.
// ---------------------------------------------------------------------------
template <typename T, typename TY, typename TV>
__global__ void __launch_bounds__(kThreads)
ykv_kernel(const TY* __restrict__ yc, const TV* __restrict__ vg,
           T* __restrict__ out, int K, int R, int C) {
  const int64_t RR = (int64_t)R * R, n = K * RR;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < n;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = t / RR;
    const int p = (int)(t - k * RR), r = p / R, l = p - r * R;
    out[t] = yv_entry<T>(yc + (k * R + r) * C, vg + k * C * R + l, C, R);
  }
}

constexpr int kRingThreads = 128;          // rows 5 and 9: a group's entries; row 8: the
                                           // widest C tile (64 was 13% slower in
                                           // paired H100 timings)
constexpr int kRingBudget = 64 * 1024;     // rows 5, 8 and 9 take the most that fits

// yv_entry on a staged subject: yc_row 16-byte aligned, four values a load.
template <typename T, typename TY, typename TV>
__device__ inline T yv_entry_staged(const TY* yc_row, const TV* vg_col, int C, int R) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int c = 0;
  for (; c + 3 < C; c += 4) {
    T y[4];
    if constexpr (sizeof(TY) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(yc_row + c);
      y[0] = q.x, y[1] = q.y, y[2] = q.z, y[3] = q.w;
    } else if constexpr (sizeof(TY) == 8) {
      const double2 a = *reinterpret_cast<const double2*>(yc_row + c);
      const double2 b = *reinterpret_cast<const double2*>(yc_row + c + 2);
      y[0] = a.x, y[1] = a.y, y[2] = b.x, y[3] = b.y;
    } else {                                   // four half values, 8 bytes
      const uint2 q = *reinterpret_cast<const uint2*>(yc_row + c);
      y[0] = widen(half_from_bits<TY>((unsigned short)(q.x & 0xffffu)));
      y[1] = widen(half_from_bits<TY>((unsigned short)(q.x >> 16)));
      y[2] = widen(half_from_bits<TY>((unsigned short)(q.y & 0xffffu)));
      y[3] = widen(half_from_bits<TY>((unsigned short)(q.y >> 16)));
    }
    s0 += y[0] * widen(vg_col[c * R]);
    s1 += y[1] * widen(vg_col[(c + 1) * R]);
    s2 += y[2] * widen(vg_col[(c + 2) * R]);
    s3 += y[3] * widen(vg_col[(c + 3) * R]);
  }
  for (; c < C; ++c) s0 += widen(yc_row[c]) * widen(vg_col[c * R]);
  return (s0 + s1) + (s2 + s3);
}

// The block writes a run of n values from shared memory, src[0, n), to
// dst[0, n). With PACKS, src and dst both lie m elements past a 16-byte
// boundary, and the values between the first and the last whole 16-byte
// pack go as 16-byte stores, the head and the tail one element a store;
// without, every value goes alone.
template <typename T, bool PACKS>
__device__ inline void store_run(T* dst, const T* src, int n, int m) {
  constexpr int VEC = 16 / sizeof(T);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int head = PACKS ? min(n, (VEC - m) % VEC) : n, packs = (n - head) / VEC;
  for (int j = tid; j < head; j += nthr) dst[j] = src[j];
  for (int p = tid; p < packs; p += nthr)
    reinterpret_cast<int4*>(dst + head)[p] = reinterpret_cast<const int4*>(src + head)[p];
  for (int j = head + packs * VEC + tid; j < n; j += nthr) dst[j] = src[j];
}

// The ring's shared memory, in bytes from its start: per stage the group's
// Yc rows [S*R] of TY at row_bytes, then its Vg_k [C*R] of TV at vg_bytes
// each; after
// the two stages the product tile [S*R*R], one 16-byte pack longer (a
// group's run starts up to a pack past a 16-byte boundary); with the coldot
// (row 9), then H [R, R] and the output tile [S*R], one pack longer.
struct YkvLayout {
  size_t row_bytes, vg, vg_bytes, stage, tile, h, otile, smem_bytes;
};

template <typename T, typename TY, typename TV>
__host__ __device__ inline YkvLayout ykv_layout(int R, int C, int S, bool coldot) {
  auto packs = [](size_t bytes) { return (bytes + 15) / 16 * 16; };
  YkvLayout s;
  s.row_bytes = packs((size_t)C * sizeof(TY));
  s.row_bytes += (144 - s.row_bytes % 128) % 128;      // 16 mod 128
  s.vg_bytes = packs((size_t)C * R * sizeof(TV));
  s.vg_bytes += (192 - s.vg_bytes % 128) % 128;        // 64 mod 128
  s.vg = (size_t)S * R * s.row_bytes;
  s.stage = s.vg + (size_t)S * s.vg_bytes;
  s.tile = 2 * s.stage;
  s.h = s.tile + packs(((size_t)S * R * R + 16 / sizeof(T)) * sizeof(T));
  s.otile = s.h + (coldot ? packs((size_t)R * R * sizeof(T)) : 0);
  s.smem_bytes = s.otile + (coldot ? packs(((size_t)S * R + 16 / sizeof(T)) * sizeof(T)) : 0);
  return s;
}

// Subjects a group: the most whose entries fill one pass of the block,
// fewer while the ring exceeds kRingBudget; 0 if not even one subject fits
// the most a block may use.
template <typename T, typename TY, typename TV>
int ykv_group(int R, int C, bool coldot) {
  int S = std::max(1, kRingThreads / (R * R));
  while (S > 1 && ykv_layout<T, TY, TV>(R, C, S, coldot).smem_bytes > (size_t)kRingBudget) --S;
  return ykv_layout<T, TY, TV>(R, C, S, coldot).smem_bytes <= (size_t)kMaxDynamicSmem ? S : 0;
}

// What the ring does with a group's product tile: row 5 writes it as YkV,
// row 9 takes the coldot with H and writes out[k, :].
enum Epilogue { kStoreYkv, kColdot };

template <typename T, typename TY, typename TV, bool ALIGNED, int EPI>
__global__ void __launch_bounds__(kRingThreads)
ykv_ring_kernel(const TY* __restrict__ yc, const TV* __restrict__ vg,
                const T* __restrict__ h, const T* __restrict__ mask,
                T* __restrict__ out, int K, int R, int C, int S) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr bool COLDOT = EPI == kColdot;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const YkvLayout lay = ykv_layout<T, TY, TV>(R, C, S, COLDOT);
  T* tile = reinterpret_cast<T*>(smem_raw + lay.tile);
  const int tid = threadIdx.x, nthr = blockDim.x, RR = R * R;
  const int n_groups = (K - 1) / S + 1;
  const int n_mine = n_groups > (int)blockIdx.x
      ? (n_groups - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  auto group = [&](int n) { return (int)blockIdx.x + n * (int)gridDim.x; };
  T* h_s = reinterpret_cast<T*>(smem_raw + lay.h);
  if constexpr (COLDOT)                      // read after the loop's first barrier
    for (int t = tid; t < RR; t += nthr) h_s[t] = h[t];

  // copy group g's Yc rows and Vg_k into stage `st`
  auto fetch = [&](unsigned char* st, int g) {
    const int64_t k0 = (int64_t)g * S;
    const int sn = (int)(K - k0 < S ? K - k0 : S);
    const TY* ysrc = yc + k0 * R * C;
    const TV* vsrc = vg + k0 * C * R;
    constexpr int EY = ALIGNED ? 16 / sizeof(TY) : 1;   // elements a copy
    constexpr int EV = ALIGNED ? 16 / sizeof(TV) : 1;
    const int yw = C / EY, vw = C * R / EV;  // copies a Yc row, a Vg_k
    Walk w(tid, nthr, yw);
    for (int u = tid; u < sn * R * yw; u += nthr, w.step()) {
      unsigned char* d = st + w.row * lay.row_bytes + w.col * EY * sizeof(TY);
      const TY* src = ysrc + (int64_t)w.row * C + w.col * EY;
      if constexpr (ALIGNED) cp_async<16>(d, src);
      else copy_elem(reinterpret_cast<TY*>(d), src);
    }
    Walk v(tid, nthr, vw);
    for (int u = tid; u < sn * vw; u += nthr, v.step()) {
      unsigned char* d = st + lay.vg + v.row * lay.vg_bytes + v.col * EV * sizeof(TV);
      const TV* src = vsrc + (int64_t)v.row * C * R + v.col * EV;
      if constexpr (ALIGNED) cp_async<16>(d, src);
      else copy_elem(reinterpret_cast<TV*>(d), src);
    }
  };

  if (n_mine > 0) fetch(smem_raw, group(0));
  cp_async_commit();
  for (int n = 0; n < n_mine; ++n) {         // block-uniform
    cp_async_wait<0>();                      // group n's copies are in
    __syncthreads();                         // everyone's; stage n-1 and the tiles are read
    if (n + 1 < n_mine) fetch(smem_raw + ((n + 1) & 1) * lay.stage, group(n + 1));
    cp_async_commit();

    const unsigned char* st = smem_raw + (n & 1) * lay.stage;
    const int64_t k0 = (int64_t)group(n) * S, base = k0 * RR;
    const int sn = (int)(K - k0 < S ? K - k0 : S), ne = sn * RR;
    const int m = ALIGNED ? (int)(base % VEC) : 0;   // the run's place in its first pack
    for (int e = tid; e < ne; e += nthr) {
      const int s = e / RR, p = e - s * RR, r = p / R, l = p - r * R;
      tile[m + e] = yv_entry_staged<T>(
          reinterpret_cast<const TY*>(st + (s * R + r) * lay.row_bytes),
          reinterpret_cast<const TV*>(st + lay.vg + s * lay.vg_bytes) + l, C, R);
    }
    __syncthreads();                         // the product tile is whole
    if constexpr (COLDOT) {                  // thread (s, l): the coldot over r, in order
      T* otile = reinterpret_cast<T*>(smem_raw + lay.otile);
      const int no = sn * R, mo = ALIGNED ? (int)(k0 * R % VEC) : 0;
      for (int e = tid; e < no; e += nthr) {
        const int s = e / R, l = e - s * R;
        const T* col = tile + m + s * RR + l;
        T acc = T(0);
        for (int r = 0; r < R; ++r) acc += h_s[r * R + l] * col[r * R];
        otile[mo + e] = mask ? acc * mask[k0 + s] : acc;
      }
      __syncthreads();                       // the output tile is whole
      store_run<T, ALIGNED>(out + k0 * R, otile + mo, no, mo);
    } else {
      store_run<T, ALIGNED>(out + base, tile + m, ne, m);
    }
  }
  cp_async_wait<0>();                        // leave no copy in flight
}

// ---------------------------------------------------------------------------
// Rows 6 and 7, mode1 / mode1_reuse. Replace src/repro/kernels/
// mttkrp_mode1.py mode1_pallas (pallas_call at :72) and mode1_reuse_pallas
// (:112), which carry the [R, R] sum across sequential grid steps. One
// launch (common.cuh: kRuns, last_block_to_finish). The first level gives
// each 256-thread sub-block a fixed run of subjects and each of its threads
// one entry (r, l); when R*R leaves threads over, G groups of R*R threads
// take every G-th subject of the run and the sub-block adds the groups in
// order at the end. A block holds kRunsPerBlock sub-blocks: four times fewer
// tickets than a block a run, and a last block of 32 warps for the second
// level (1.15-1.2x faster than a block a run, paired on the card).
// w_k is Wb[k] times mask[k] (mask null: no subject mask), the product
// torch forms when it folds the mask into Wb, so the bits are those of the
// folded call. The block that finishes last sums the partials: one warp per
// entry, lane L summing runs L, L + 32, ... in order (16 loads in flight a
// lane), then a fixed butterfly over the lanes, so the order is fixed and
// the chain of dependent adds is kRuns / 32 = 64 long. Bound: Yc and Vg
// bytes (row 6), YkV bytes (row 7, so its launch, each block's fence and
// ticket, and the last block's read of the partials).
// ---------------------------------------------------------------------------
constexpr int kRunsPerBlock = 4;   // runs a block sums, one a 256-thread sub-block

template <typename T>
__device__ void sum_partials_by_lanes(const T* partials, T* __restrict__ out,
                                      int runs, int ld, int RR) {
  constexpr int U = 16;                        // loads in flight a lane
  const int lane = threadIdx.x % kWarp, warps = blockDim.x / kWarp;
  for (int p = threadIdx.x / kWarp; p < RR; p += warps) {
    const T* row = partials + (int64_t)p * ld;
    T s = T(0);
    int b = lane;
    for (; b + (U - 1) * kWarp < runs; b += U * kWarp) {
      T v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = __ldcg(row + b + u * kWarp);
#pragma unroll
      for (int u = 0; u < U; ++u) s += v[u];
    }
    for (; b < runs; b += kWarp) s += __ldcg(row + b);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[p] = s;
  }
}

template <typename T, typename TY, typename TV, bool REUSE>
__global__ void __launch_bounds__(kThreads * kRunsPerBlock)
mode1_kernel(const TY* __restrict__ yc, const TV* __restrict__ vg,
             const T* __restrict__ ykv, const T* __restrict__ wb,
             const T* __restrict__ mask, unsigned* counter, T* partials,
             T* __restrict__ out, int K, int R, int C, int runs, int per_block, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int RR = R * R;
  const int G = max(1, kThreads / RR);
  const int sub = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int run = blockIdx.x * kRunsPerBlock + sub;      // this sub-block's run
  T* red_s = reinterpret_cast<T*>(smem_raw) + sub * G * RR;   // [G, R*R] when G > 1
  const int k0 = run * per_block;
  const int k1 = min(K, k0 + per_block);
  T* part = partials + run;                    // entry p at part[p * ld]
  for (int v = tid; run < runs && v < G * RR; v += kThreads) {
    const int g = v / RR, p = v - g * RR, r = p / R, l = p - r * R;
    T acc = T(0);
    for (int k = k0 + g; k < k1; k += G) {
      const T y = REUSE ? ykv[(int64_t)k * RR + p]
                        : yv_entry<T>(yc + ((int64_t)k * R + r) * C,
                                      vg + (int64_t)k * C * R + l, C, R);
      T w = wb[(int64_t)k * R + l];
      if (mask) w = w * mask[k];
      acc += y * w;
    }
    if (G == 1) part[(int64_t)p * ld] = acc;
    else red_s[v] = acc;
  }
  if (G > 1) {                                 // block-uniform
    __syncthreads();
    for (int p = tid; run < runs && p < RR; p += kThreads) {
      T s = T(0);
      for (int g = 0; g < G; ++g) s += red_s[g * RR + p];
      part[(int64_t)p * ld] = s;
    }
  }
  if (last_block_to_finish(counter))
    sum_partials_by_lanes(partials, out, runs, ld, RR);
}

// ---------------------------------------------------------------------------
// Row 8, mode2_compact. Replaces src/repro/kernels/mttkrp_mode2.py
// mode2_compact_pallas (pallas_call at :61): A[k, c, l] = (sum_r Yc[k, r, c]
// * H[r, l]) * Wb[k, l] * col_mask[k, c]. Masked columns (col_mask 0) and
// masked subjects (w_k folded to 0) write exact zeros, which the
// sorted-segment mode-2 scatter relies on. Bound: the bytes of Yc, col_mask
// and A (R = 5, f32: 2R operations per 8 bytes of Yc and A). Two variants,
// picked by shape (mode2_variant):
//
// RING, the main path (two stages of a C tile and the output tile fit in
// shared memory at a tile width TC of 128, 64 or 32 columns). What held the
// thread-per-entry design below at 28% of the bound: each of the R threads
// of a column read the column Yc[k, :, c] again with stride C, every thread
// did two 64-bit divisions, and every store was 4 bytes a lane. Here
// persistent blocks walk over (subject, C tile) work items. While a block
// computes item n, cp.async copies item n+1's Yc[k, :, c0:c0+TC] (R rows of
// TC), col_mask[k, c0:c0+TC] and Wb[k] into the other of two shared-memory
// stages (16 bytes a copy when the rows are whole 16-byte runs, else one
// element); H is staged once per block. A thread owns a column, reads its R
// values of Yc once into registers (R <= 8; wider R reads them from shared
// memory) and computes its R outputs in the fallback's order, so the bits
// are the same, into an output tile that is A[k, c0:c0+TC, :], one
// contiguous run of TC*R values, which the block writes with 16-byte stores.
// Items advance by additions, not a division per element. At R = 5, C = 128,
// f32 a block holds about 9 KB, so many blocks share an SM.
//
// THREAD-PER-ENTRY (R too wide for even a 32-column tile): one thread per
// output entry (k, c, l), so a warp's stores are contiguous.
// ---------------------------------------------------------------------------
template <typename T, typename TY>
__global__ void __launch_bounds__(kThreads)
mode2_compact_kernel(const TY* __restrict__ yc, const T* __restrict__ h,
                     const T* __restrict__ wb, const T* __restrict__ cm,
                     T* __restrict__ out, int K, int R, int C) {
  const int64_t n = (int64_t)K * C * R;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < n;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t kc = t / R;
    const int l = (int)(t - kc * R);
    const int64_t k = kc / C;
    const int c = (int)(kc - k * C);
    const TY* ycol = yc + k * R * C + c;
    T a = T(0);
    for (int r = 0; r < R; ++r) a += widen(ycol[(int64_t)r * C]) * h[r * R + l];
    out[t] = a * wb[k * R + l] * cm[kc];
  }
}

// The ring's shared memory, in bytes from its start (every part a whole
// number of 16-byte packs): per stage the Yc tile [R, TC] of TY, col_mask
// [TC] and w_k [R] of T; after the two stages the output tile [TC, R] and
// H [R, R] of T.
struct Mode2Layout {
  size_t cm, w, stage, tile, h, smem_bytes;
};

template <typename T, typename TY>
__host__ __device__ inline Mode2Layout mode2_layout(int R, int tc) {
  auto packs = [](size_t bytes) { return (bytes + 15) / 16 * 16; };
  Mode2Layout s;
  s.cm = packs((size_t)R * tc * sizeof(TY));
  s.w = s.cm + packs(tc * sizeof(T));
  s.stage = s.w + packs(R * sizeof(T));
  s.tile = 2 * s.stage;
  s.h = s.tile + packs((size_t)tc * R * sizeof(T));
  s.smem_bytes = s.h + packs((size_t)R * R * sizeof(T));
  return s;
}

// The tile width: the widest of 128, 64, 32 within kRingBudget, else 32
// within the most a block may use; 0 if not even that fits.
template <typename T, typename TY>
int mode2_tile(int R) {
  for (int tc = kRingThreads; tc >= 32; tc /= 2)
    if (mode2_layout<T, TY>(R, tc).smem_bytes <= (size_t)kRingBudget) return tc;
  return mode2_layout<T, TY>(R, 32).smem_bytes <= (size_t)kMaxDynamicSmem ? 32 : 0;
}

template <typename T, typename TY, int RMAX, bool ALIGNED>
__global__ void __launch_bounds__(kRingThreads)
mode2_ring_kernel(const TY* __restrict__ yc, const T* __restrict__ h,
                  const T* __restrict__ wb, const T* __restrict__ cm,
                  T* __restrict__ out, int K, int R, int C, int TC) {
  constexpr int VEC = 16 / sizeof(T), VY = 16 / sizeof(TY);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Mode2Layout lay = mode2_layout<T, TY>(R, TC);
  T* tile = reinterpret_cast<T*>(smem_raw + lay.tile);
  T* h_s = reinterpret_cast<T*>(smem_raw + lay.h);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n_ct = (C + TC - 1) / TC;
  const int64_t n_items = (int64_t)K * n_ct;
  const int n_mine = n_items > blockIdx.x
      ? (int)((n_items - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  for (int t = tid; t < R * R; t += nthr) h_s[t] = h[t];

  // copy item (k, ct)'s Yc tile, col_mask and w_k into the stage at `stb`
  auto fetch = [&](unsigned char* stb, int k, int ct) {
    const int c0 = ct * TC, tc = min(TC, C - c0);
    const TY* src = yc + (int64_t)k * R * C + c0;
    TY* st = reinterpret_cast<TY*>(stb);
    T* cm_d = reinterpret_cast<T*>(stb + lay.cm);
    if constexpr (ALIGNED) {                 // rows are whole 16-byte runs
      const int np = tc / VY;
      Walk w(tid, nthr, np);
      for (int u = tid; u < R * np; u += nthr, w.step())
        cp_async<16>(st + w.row * TC + w.col * VY, src + (int64_t)w.row * C + w.col * VY);
      for (int p = tid; p < tc / VEC; p += nthr)
        cp_async<16>(cm_d + p * VEC, cm + (int64_t)k * C + c0 + p * VEC);
    } else {
      Walk w(tid, nthr, tc);
      for (int u = tid; u < R * tc; u += nthr, w.step())
        copy_elem(st + w.row * TC + w.col, src + (int64_t)w.row * C + w.col);
      for (int u = tid; u < tc; u += nthr)
        cp_async<sizeof(T)>(cm_d + u, cm + (int64_t)k * C + c0 + u);
    }
    T* w_d = reinterpret_cast<T*>(stb + lay.w);
    for (int u = tid; u < R; u += nthr)
      cp_async<sizeof(T)>(w_d + u, wb + (int64_t)k * R + u);
  };
  // the block's items, (k, ct) = divmod(blockIdx.x + n * gridDim.x, n_ct)
  int fk = blockIdx.x / n_ct, fct = blockIdx.x % n_ct;          // next to fetch
  const int dk = gridDim.x / n_ct, dct = gridDim.x % n_ct;
  auto advance = [&](int& k, int& ct) {
    k += dk;
    ct += dct;
    if (ct >= n_ct) { ct -= n_ct; ++k; }
  };
  int k = fk, ct = fct;                                        // being computed

  if (n_mine > 0) fetch(smem_raw, fk, fct);
  cp_async_commit();
  advance(fk, fct);
  for (int n = 0; n < n_mine; ++n) {         // block-uniform
    cp_async_wait<0>();                      // item n's copies are in
    __syncthreads();                         // everyone's; stage n-1 is read
    if (n + 1 < n_mine) fetch(smem_raw + ((n + 1) & 1) * lay.stage, fk, fct);
    cp_async_commit();
    advance(fk, fct);

    const unsigned char* st = smem_raw + (n & 1) * lay.stage;
    const TY* y_s = reinterpret_cast<const TY*>(st);
    const T* cm_s = reinterpret_cast<const T*>(st + lay.cm);
    const T* w_s = reinterpret_cast<const T*>(st + lay.w);
    const int c0 = ct * TC, tc = min(TC, C - c0);
    for (int c = tid; c < tc; c += nthr) {
      if constexpr (RMAX > 0) {
        T y[RMAX];
#pragma unroll
        for (int r = 0; r < RMAX; ++r) y[r] = r < R ? widen(y_s[r * TC + c]) : T(0);
        for (int l = 0; l < R; ++l) {
          T a = T(0);
#pragma unroll
          for (int r = 0; r < RMAX; ++r)
            if (r < R) a += y[r] * h_s[r * R + l];
          tile[c * R + l] = a * w_s[l] * cm_s[c];
        }
      } else {
        for (int l = 0; l < R; ++l) {
          T a = T(0);
          for (int r = 0; r < R; ++r) a += widen(y_s[r * TC + c]) * h_s[r * R + l];
          tile[c * R + l] = a * w_s[l] * cm_s[c];
        }
      }
    }
    __syncthreads();                         // the tile is whole
    T* dst = out + ((int64_t)k * C + c0) * R;   // A[k, c0:c0+tc, :], contiguous
    if constexpr (ALIGNED) {                 // tc * R is whole packs
      for (int p = tid; p * VEC < tc * R; p += nthr)
        reinterpret_cast<int4*>(dst)[p] = reinterpret_cast<const int4*>(tile)[p];
    } else {
      for (int u = tid; u < tc * R; u += nthr) dst[u] = tile[u];
    }
    advance(k, ct);
  }
  cp_async_wait<0>();                        // leave no copy in flight
}

// ---------------------------------------------------------------------------
// Rows 9 and 10, mode3 / mode3_reuse. Replace src/repro/kernels/
// mttkrp_mode3.py mode3_pallas (pallas_call at :71) and mode3_reuse_pallas
// (:106): out[k, l], the coldot over r of H[:, l] with column l of Yc_k
// Vg_k (row 9, formed on the fly) or of YkV_k (row 10). The subject mask,
// which the reference applies after its kernel, is applied here. Bound: Yc
// and Vg bytes (row 9), YkV bytes (row 10, so its launch).
//
// Row 9 is row 5's ring (ykv_ring_kernel) with the coldot epilogue: once a
// group's product tile is whole, thread (s, l) takes the coldot over r with
// H from shared memory, and the block writes the group's S*R outputs as one
// run. What held the thread-per-entry design (mode3_kernel below, now the
// fallback for a subject too large for the ring) at 14% of its bound: each
// of the K*R threads read a whole Yc_k and a Vg column at stride R straight
// from device memory, 4 bytes a load. Same variants as row 5
// (ring_variant).
//
// Row 10 is the thread-per-entry kernel (mode3_kernel<T, true>) on a grid
// of at most one wave, as many 256-thread blocks as the card holds at once,
// whose threads loop over the outputs. At the main path's largest bucket
// (K*R = 290,560 outputs) the uncapped grid's 1,135 blocks left 79 for a
// second wave at eight blocks an SM. Measured on an H100 in a CUDA graph (PERF.md): the
// uncapped kernel took 0.0038 ms, its K = 1 launch floor 0.0021, the capped
// one 0.0036; staging each block's (or each warp's) run of YkV through
// shared memory with 16-byte cp.async took 0.0052 (0.0047), its floor
// 0.0026 (0.0024): a launch-bound kernel cannot hide the copy's round trip
// through shared memory and the barrier after it.
// ---------------------------------------------------------------------------
template <typename T, typename TY, typename TV, bool REUSE>
__global__ void __launch_bounds__(kThreads)
mode3_kernel(const TY* __restrict__ yc, const TV* __restrict__ vg,
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
                        : yv_entry<T>(yc + (k * R + r) * C, vg + k * C * R + l, C, R);
      s += h[r * R + l] * y;
    }
    out[t] = mask ? s * mask[k] : s;
  }
}

// ---------------------------------------------------------------------------
// Host-side launchers
// ---------------------------------------------------------------------------
template <typename T, typename TY, typename TV, bool REUSE>
cudaError_t launch_mode1(const void* yc, const void* vg, const void* ykv,
                         const void* wb, const void* mask, void* ws, void* out,
                         int K, int R, int C, cudaStream_t stream) {
  const int RR = R * R;
  const int G = std::max(1, kThreads / RR);
  const size_t smem = G > 1 ? (size_t)kRunsPerBlock * G * RR * sizeof(T) : 0;
  const int runs = reduction_runs(K);
  const int per_block = (K + runs - 1) / runs;
  auto kernel = mode1_kernel<T, TY, TV, REUSE>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(runs + kRunsPerBlock - 1) / kRunsPerBlock, kThreads * kRunsPerBlock, smem,
           stream>>>(
      static_cast<const TY*>(yc), static_cast<const TV*>(vg),
      static_cast<const T*>(ykv), static_cast<const T*>(wb),
      static_cast<const T*>(mask), static_cast<unsigned*>(ws),
      static_cast<T*>(ws) + counter_elems<T>(), static_cast<T*>(out), K, R, C, runs,
      per_block, partials_ld<T>(runs));
  return cudaGetLastError();
}

// The variants of rows 5, 8 and 9, as spartan_ykv_variant,
// spartan_mode2_compact_variant and spartan_mode3_variant report them.
enum Variant { kRing = 0, kRingElementCopies = 1, kThreadPerEntry = 2 };

// Rows 5 and 9: RING where one subject's two stages fit (16-byte copies and
// stores when the rows of Yc and each subject's Vg_k are whole 16-byte runs
// and Yc, Vg and the output start on 16-byte boundaries), else
// THREAD-PER-ENTRY.
template <typename T, typename TY, typename TV>
int ring_variant(int C, int R, bool aligned, bool coldot) {
  if (ykv_group<T, TY, TV>(R, C, coldot) == 0) return kThreadPerEntry;
  const bool packs = C % (16 / (int)sizeof(TY)) == 0 &&
                     (int64_t)C * R % (16 / (int)sizeof(TV)) == 0;
  return aligned && packs ? kRing : kRingElementCopies;
}

// Row 5 (EPI kStoreYkv: out = YkV [K, R, R]) or row 9 (kColdot: out [K, R],
// h and mask read).
template <typename T, typename TY, typename TV, int EPI>
cudaError_t launch_ring(const void* yc, const void* vg, const void* h, const void* mask,
                        void* out, int K, int R, int C, cudaStream_t stream) {
  constexpr bool coldot = EPI == kColdot;
  const int variant = ring_variant<T, TY, TV>(C, R, aligned16({yc, vg, out}), coldot);
  if (variant == kThreadPerEntry) {
    if constexpr (coldot)
      mode3_kernel<T, TY, TV, false><<<grid_for((int64_t)K * R), kThreads, 0, stream>>>(
          static_cast<const TY*>(yc), static_cast<const TV*>(vg), nullptr,
          static_cast<const T*>(h), static_cast<const T*>(mask), static_cast<T*>(out), K, R,
          C);
    else
      ykv_kernel<T, TY, TV><<<grid_for((int64_t)K * R * R), kThreads, 0, stream>>>(
          static_cast<const TY*>(yc), static_cast<const TV*>(vg), static_cast<T*>(out), K, R,
          C);
    return cudaGetLastError();
  }
  const int S = ykv_group<T, TY, TV>(R, C, coldot);
  const size_t smem = ykv_layout<T, TY, TV>(R, C, S, coldot).smem_bytes;
  auto kernel = variant == kRing ? ykv_ring_kernel<T, TY, TV, true, EPI>
                                 : ykv_ring_kernel<T, TY, TV, false, EPI>;
  cudaError_t e = allow_smem(kernel, smem);
  int grid = 0;
  if (e == cudaSuccess) e = persistent_grid(kernel, kRingThreads, smem, (K - 1) / S + 1, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kRingThreads, smem, stream>>>(
      static_cast<const TY*>(yc), static_cast<const TV*>(vg), static_cast<const T*>(h),
      static_cast<const T*>(mask), static_cast<T*>(out), K, R, C, S);
  return cudaGetLastError();
}

// Row 10: the thread-per-entry kernel on at most one wave of blocks.
template <typename T>
cudaError_t launch_mode3_reuse(const void* ykv, const void* h, const void* mask, void* out,
                               int K, int R, cudaStream_t stream) {
  auto kernel = mode3_kernel<T, T, T, true>;
  int grid = 0;
  const cudaError_t e = persistent_grid(kernel, kThreads, 0, grid_for((int64_t)K * R), &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, 0, stream>>>(
      nullptr, nullptr, static_cast<const T*>(ykv), static_cast<const T*>(h),
      static_cast<const T*>(mask), static_cast<T*>(out), K, R, 0);
  return cudaGetLastError();
}

// Row 8: RING where a 32-column tile fits (16-byte copies and stores when
// the rows of Yc and col_mask are whole 16-byte runs and Yc, col_mask and A
// start on 16-byte boundaries), else THREAD-PER-ENTRY.
template <typename T, typename TY>
int mode2_variant(int C, int R, bool aligned) {
  if (mode2_tile<T, TY>(R) == 0) return kThreadPerEntry;
  const bool packs = C % (16 / (int)sizeof(TY)) == 0 && C % (16 / (int)sizeof(T)) == 0;
  return aligned && packs ? kRing : kRingElementCopies;
}

template <typename T, typename TY>
cudaError_t launch_mode2(const void* yc, const void* h, const void* wb, const void* cm,
                         void* out, int K, int R, int C, cudaStream_t stream) {
  const int variant = mode2_variant<T, TY>(C, R, aligned16({yc, cm, out}));
  if (variant == kThreadPerEntry) {
    mode2_compact_kernel<T, TY><<<grid_for((int64_t)K * C * R), kThreads, 0, stream>>>(
        static_cast<const TY*>(yc), static_cast<const T*>(h), static_cast<const T*>(wb),
        static_cast<const T*>(cm), static_cast<T*>(out), K, R, C);
    return cudaGetLastError();
  }
  const int TC = mode2_tile<T, TY>(R);
  const size_t smem = mode2_layout<T, TY>(R, TC).smem_bytes;
  auto kernel = R <= 8 ? (variant == kRing ? mode2_ring_kernel<T, TY, 8, true>
                                           : mode2_ring_kernel<T, TY, 8, false>)
                       : (variant == kRing ? mode2_ring_kernel<T, TY, 0, true>
                                           : mode2_ring_kernel<T, TY, 0, false>);
  cudaError_t e = allow_smem(kernel, smem);
  int grid = 0;
  if (e == cudaSuccess)
    e = persistent_grid(kernel, kRingThreads, smem, (int64_t)K * ((C + TC - 1) / TC), &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kRingThreads, smem, stream>>>(
      static_cast<const TY*>(yc), static_cast<const T*>(h), static_cast<const T*>(wb),
      static_cast<const T*>(cm), static_cast<T*>(out), K, R, C, TC);
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

// Run the statement(s) with the compute type T and the types TY of Yc and
// TV of Vg from their codes CY, CV: both float or both double, or each of
// them float or one half type (bfloat16, float16) with T = float; return
// FAIL for any other pair.
#define SPARTAN_BY_OPERANDS(FAIL, CY, CV, ...)                                \
  do {                                                                        \
    SPARTAN_CASE(CY, CV, 0, 0, float, float, float, __VA_ARGS__);             \
    SPARTAN_CASE(CY, CV, 1, 1, double, double, double, __VA_ARGS__);         \
    SPARTAN_CASE(CY, CV, 2, 2, float, bf16, bf16, __VA_ARGS__);               \
    SPARTAN_CASE(CY, CV, 3, 3, float, f16, f16, __VA_ARGS__);                 \
    SPARTAN_CASE(CY, CV, 0, 2, float, float, bf16, __VA_ARGS__);             \
    SPARTAN_CASE(CY, CV, 2, 0, float, bf16, float, __VA_ARGS__);             \
    SPARTAN_CASE(CY, CV, 0, 3, float, float, f16, __VA_ARGS__);              \
    SPARTAN_CASE(CY, CV, 3, 0, float, f16, float, __VA_ARGS__);              \
    return FAIL;                                                              \
  } while (0)
#define SPARTAN_CASE(CY, CV, A, B, T_, TY_, TV_, ...)                         \
  if ((CY) == (A) && (CV) == (B)) {                                           \
    using T = T_;                                                             \
    using TY = TY_;                                                           \
    using TV = TV_;                                                           \
    __VA_ARGS__;                                                              \
  }

// Run the statement(s) with T and the type TY of Yc from its code CY: 0
// (float, float), 1 (double, double), 2 (float, bfloat16), 3 (float,
// float16); return FAIL for any other code.
#define SPARTAN_BY_YC(FAIL, CY, ...)                                          \
  do {                                                                        \
    SPARTAN_CASE(CY, CY, 0, 0, float, float, float, __VA_ARGS__);             \
    SPARTAN_CASE(CY, CY, 1, 1, double, double, double, __VA_ARGS__);         \
    SPARTAN_CASE(CY, CY, 2, 2, float, bf16, bf16, __VA_ARGS__);               \
    SPARTAN_CASE(CY, CY, 3, 3, float, f16, f16, __VA_ARGS__);                 \
    return FAIL;                                                              \
  } while (0)

extern "C" {

// dtypes: the dtype code of each streamed operand (0 float32, 1 float64,
// 2 bfloat16, 3 float16), packed as common.cuh's operand_code reads it:
// Yc then Vg for rows 5, 6 and 9, Yc for row 8. With a half code every
// other operand (H, Wb, masks) and the output are float32, else they take
// the operands' dtype. Rows 7 and 10, and the workspace query, take one
// dtype code (0, 1): the YkV's, the accumulation's. Returns a cudaError_t
// (0 = success); a combination not listed is cudaErrorInvalidValue, before
// any launch. Every entry point needs K >= 1, R >= 1, C >= 1 (the wrappers
// return zeros for an empty bucket without a launch).

int spartan_ykv(int dtypes, const void* yc, const void* vg, void* out, int K,
                int R, int C, void* stream) {
  if (K < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  SPARTAN_BY_OPERANDS((int)cudaErrorInvalidValue, operand_code(dtypes, 0),
                      operand_code(dtypes, 1),
                      return (int)(launch_ring<T, TY, TV, kStoreYkv>(
                          yc, vg, nullptr, nullptr, out, K, R, C,
                          static_cast<cudaStream_t>(stream))));
}

// The variant a spartan_ykv launch takes (Variant: 0 ring, 1 ring with
// element copies, 2 thread-per-entry) for Yc and Vg of these dtypes;
// aligned: Yc, Vg and YkV start on a 16-byte boundary. -1 for an unknown
// combination.
int spartan_ykv_variant(int dtypes, int C, int R, int aligned) {
  if (C < 1 || R < 1) return -1;
  SPARTAN_BY_OPERANDS(-1, operand_code(dtypes, 0), operand_code(dtypes, 1),
                      return ring_variant<T, TY, TV>(C, R, aligned != 0, false));
}

// Rows 6 and 7, one launch each. mask: [K] or null (no subject mask); ws:
// spartan_mode1_workspace(dtype, K, R) elements of the accumulation type,
// zeroed before its first launch (a launch leaves its counter 0).
int spartan_mode1_one_launch(int dtypes, const void* yc, const void* vg, const void* wb,
                             const void* mask, void* ws, void* out, int K, int R, int C,
                             void* stream) {
  if (K < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  SPARTAN_BY_OPERANDS((int)cudaErrorInvalidValue, operand_code(dtypes, 0),
                      operand_code(dtypes, 1),
                      return (int)(launch_mode1<T, TY, TV, false>(
                          yc, vg, nullptr, wb, mask, ws, out, K, R, C,
                          static_cast<cudaStream_t>(stream))));
}

int spartan_mode1_reuse_one_launch(int dtype, const void* ykv, const void* wb,
                                   const void* mask, void* ws, void* out, int K, int R,
                                   void* stream) {
  if (K < 1 || R < 1) return (int)cudaErrorInvalidValue;
  SPARTAN_BY_DTYPE(return (int)(launch_mode1<T, T, T, true>(
      nullptr, nullptr, ykv, wb, mask, ws, out, K, R, 0, static_cast<cudaStream_t>(stream))));
}

int spartan_mode2_compact(int dtypes, const void* yc, const void* h,
                          const void* wb, const void* cm, void* out, int K,
                          int R, int C, void* stream) {
  if (K < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  SPARTAN_BY_YC((int)cudaErrorInvalidValue, operand_code(dtypes, 0),
                return (int)(launch_mode2<T, TY>(yc, h, wb, cm, out, K, R, C,
                                                 static_cast<cudaStream_t>(stream))));
}

// The variant a spartan_mode2_compact launch takes (Variant: 0 ring,
// 1 ring with element copies, 2 thread-per-entry) for a Yc of this dtype;
// aligned: Yc, col_mask and A start on a 16-byte boundary. -1 for an
// unknown dtype.
int spartan_mode2_compact_variant(int dtypes, int C, int R, int aligned) {
  if (C < 1 || R < 1) return -1;
  SPARTAN_BY_YC(-1, operand_code(dtypes, 0), return mode2_variant<T, TY>(C, R, aligned != 0));
}

int spartan_mode3(int dtypes, const void* yc, const void* vg, const void* h,
                  const void* mask, void* out, int K, int R, int C,
                  void* stream) {
  if (K < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  SPARTAN_BY_OPERANDS((int)cudaErrorInvalidValue, operand_code(dtypes, 0),
                      operand_code(dtypes, 1),
                      return (int)(launch_ring<T, TY, TV, kColdot>(
                          yc, vg, h, mask, out, K, R, C,
                          static_cast<cudaStream_t>(stream))));
}

// The variant a spartan_mode3 launch takes (Variant: 0 ring, 1 ring with
// element copies, 2 thread-per-entry) for Yc and Vg of these dtypes;
// aligned: Yc, Vg and out start on a 16-byte boundary. -1 for an unknown
// combination.
int spartan_mode3_variant(int dtypes, int C, int R, int aligned) {
  if (C < 1 || R < 1) return -1;
  SPARTAN_BY_OPERANDS(-1, operand_code(dtypes, 0), operand_code(dtypes, 1),
                      return ring_variant<T, TY, TV>(C, R, aligned != 0, true));
}

int spartan_mode3_reuse(int dtype, const void* ykv, const void* h,
                        const void* mask, void* out, int K, int R,
                        void* stream) {
  if (K < 1 || R < 1) return (int)cudaErrorInvalidValue;
  SPARTAN_BY_DTYPE(return (int)(launch_mode3_reuse<T>(ykv, h, mask, out, K, R,
                                                      static_cast<cudaStream_t>(stream))));
}

// The elements of T of the workspace rows 6 and 7 take for K subjects at
// rank R: one counter and the partials [R*R, ld] (one column per
// first-level block); -1 for an unknown dtype, K < 1, R < 1 or a count past
// an int.
int spartan_mode1_workspace(int dtype, int K, int R) {
  if (K < 1 || R < 1) return -1;
  if (dtype == 0) return reduction_workspace<float>(K, R);
  if (dtype == 1) return reduction_workspace<double>(K, R);
  return -1;
}

}  // extern "C"
