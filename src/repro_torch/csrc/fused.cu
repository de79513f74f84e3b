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
// f64 -> f64). All tensors are contiguous, row-major.
//
// Any R, I and C: the arithmetic runs on register tiles of RMAX = 8, 16, 32
// or 64 entries of R; above 64 (WIDE) a kernel loops over R in 64-wide
// chunks and sums the chunks' contributions to outputs that need all of R.
// The small per-subject operands (Vg_k, Q_k, X_k Vg_k) are staged in shared
// memory in chunks of rows that fit in a block's 227 KB; a subject whose
// whole tile fits (the main path's buckets) is the one-chunk case and is
// staged once.
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): at rank R each slab element takes part in about 2R operations, so
// for R = 5 in f32 that is 10 operations per 4-byte load, far below the ~20
// the card needs per byte before arithmetic is the limit. F1, F3 and F4 are
// bound by the slab bytes (K*I*C*itemsize / 3.35 TB/s); F2 reads only the
// [K, I, R] operands and is bound by those bytes. So the design reads every
// slab element once, coalesced along C, keeps the small operands (Vg_k, Q_k,
// H, w_k) in shared memory, and does the R-wide arithmetic in FMA units, no
// tensor cores. F1 streams the slab through a multi-stage cp.async ring in
// persistent blocks (its note below); F2-F4 read it straight from device
// memory, one block per subject.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py):
// every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMode1Blocks = 2048;         // first-level blocks of F2
constexpr int kTile = 64;                  // the widest register tile of R

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

// Copy the [n, w] tile at src (a row-major matrix with leading dimension
// ld) into shared memory with row stride RS. A tile fits in shared memory,
// so its offsets fit in 32 bits.
template <typename T>
__device__ inline void stage_tile(T* dst, const T* __restrict__ src, int n,
                                  int w, int ld, int RS) {
  for (int t = threadIdx.x; t < n * w; t += blockDim.x) {
    const int row = t / w, col = t - row * w;
    dst[row * RS + col] = src[row * ld + col];
  }
}

// One warp adds a slab row piece's x[r] += sum_c row[c] * vg_s[c, r] over
// c < cn, r < RW: lanes stride over c (coalesced loads). The caller sums
// the lanes (warp_sum) once every chunk of the row is in.
template <typename T, int RMAX>
__device__ inline void row_times_vg(const T* __restrict__ row, const T* vg_s,
                                    int cn, int RW, int RS, int lane,
                                    T (&acc)[RMAX]) {
  for (int c = lane; c < cn; c += kWarp) {
    const T v = row[c];
    const T* vrow = vg_s + c * RS;
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < RW) acc[r] += v * vrow[r];
  }
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
// fused_procrustes_b (pallas_call at :153, body _procrustes_b_kernel at
// :100): XkV_k = X_k Vg_k and B_k = (XkV_k * w_k) H^T in one pass over the
// slab. Bound: the slab bytes (R = 5, f32: 10 operations per 4-byte load).
// Two variants, picked by shape (f1_variant):
//
// RING, the main path (R <= 64 and two subjects' operands fit in shared
// memory). What held the row-warp design below at 46% of the bound: a serial
// prologue per subject before its first slab load, 4-byte lane loads, and a
// chain of R warp reductions after every row before the next row's loads, so
// few bytes were in flight per SM. Here persistent blocks (a few per SM)
// walk over subjects through a ring of kStages shared-memory stages: while a
// block computes subject n, cp.async copies (16 bytes a thread when the
// slab's rows are whole 16-byte runs, else one element a thread) fill the
// stage of subject n+1 with its slab, Vg_k and w_k, so the slab stream
// never waits for compute; the copies' index arithmetic is a few adds a
// copy (Walk). Eight lanes split a row's C into 16-byte packs (VEC =
// 16 / sizeof(T) values); each lane owns RPT rows (32 apart) and all R sums
// of them, one 16-byte Vg read per (pack, r) feeds its RPT rows, and the
// eight lanes of a row reduce once per row (three shuffles per r), in a
// fixed order. Eight warps a block and two stages (66 KB at I = 56, C = 128,
// R = 5, f32), so three blocks share an SM: in paired timings on the H100
// the warps to hide each subject's short compute mattered more than bytes
// in flight (two blocks of three stages were 4% slower, one block of four
// stages 73% slower). The slab is
// staged with a row stride of 2 mod 8 packs and Vg_k as [C/VEC][R|1][VEC]
// packs, so that the reads are free of bank conflicts. B is formed from the
// row sums in registers (H in shared memory), so XkV is written but never
// read back. The arithmetic is FMA in full f32 / f64: at 10 operations per
// 4 bytes the card is far from its FMA limit, and TF32 tensor cores would
// break the 1e-6 relative f32 parity.
//
// ROW-WARP (R > 64, or a subject too large for two stages): one block per
// subject: Vg_k (in CC-row chunks), H and w_k in shared memory, one warp per
// slab row, B formed from the row sums in registers. WIDE (R > 64): H and
// w_k are read from global memory and B sums the R chunks in place (each
// entry has one owning lane, so the sum is in a fixed order). The TPU
// kernel's block_c chunking (a VMEM budget) has no counterpart: a block
// reads its rows straight from device memory.
// ---------------------------------------------------------------------------
constexpr int kStages = 2;                 // ring depth (subjects a block holds)
constexpr int kRingThreads = 256;
constexpr int kRingWarps = kRingThreads / kWarp;
constexpr int kGroups = 8;                 // lanes that split one row's C
constexpr int kSlots = kWarp / kGroups;    // rows a warp takes per row tile

// 16 bytes of T from shared memory.
template <typename T>
struct Pack {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};
template <typename T>
__device__ inline Pack<T> load_pack(const T* p) {
  Pack<T> f;
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    f.v[0] = q.x; f.v[1] = q.y; f.v[2] = q.z; f.v[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    f.v[0] = q.x; f.v[1] = q.y;
  }
  return f;
}

// The ring's shared-memory layout, in elements of T (every part a whole
// number of 16-byte packs): per stage the slab [I, SP packs], Vg_k
// [NP packs of c][RS][VEC] and w_k; after the stages, H [R, R].
struct RingLayout {
  int vec, np, sp, rs;
  size_t slab, vg, w, stage, smem_bytes;
};

template <typename T>
__host__ __device__ inline RingLayout ring_layout(int I, int C, int R) {
  RingLayout s;
  s.vec = 16 / (int)sizeof(T);
  s.np = (C + s.vec - 1) / s.vec;          // 16-byte packs of a row
  // SP = 2 mod 8: the 4 rows x 2 packs that 8 lanes read at once hit
  // distinct banks; RS odd: the two groups' Vg packs do too
  s.sp = s.np + ((2 - s.np % 8) + 8) % 8;
  s.rs = R | 1;
  s.slab = (size_t)I * s.sp * s.vec;
  s.vg = (size_t)s.np * s.rs * s.vec;
  s.w = (size_t)(R + s.vec - 1) / s.vec * s.vec;
  s.stage = s.slab + s.vg + s.w;
  s.smem_bytes = (kStages * s.stage + (size_t)R * R) * sizeof(T);
  return s;
}

template <typename T, int RMAX, bool ALIGNED>
__global__ void __launch_bounds__(kRingThreads)
procrustes_b_ring_kernel(const T* __restrict__ vals, const T* __restrict__ vg,
                         const T* __restrict__ wb, const T* __restrict__ h,
                         T* __restrict__ xkv, T* __restrict__ bout, int K, int I,
                         int C, int R) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RPT = RMAX <= 16 ? 2 : 1;      // rows a lane owns per row tile
  constexpr int kTileRows = RPT * kRingWarps * kSlots;
  const RingLayout lay = ring_layout<T>(I, C, R);
  const int NP = lay.np, SP = lay.sp, RS = lay.rs;
  T* ring = smem_base<T>();
  T* h_s = ring + kStages * lay.stage;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid / kWarp, lane = tid % kWarp;
  const int q = lane / kSlots, slot = lane % kSlots;   // C group, row slot
  const int n_mine = K > (int)blockIdx.x ? (K - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;

  // pads that no copy writes: slab columns and Vg rows C .. NP*VEC - 1
  const int cpad = NP * VEC - C;
  for (int s = 0; s < kStages; ++s) {
    T* st = ring + s * lay.stage;
    for (int t = tid; t < I * cpad; t += nthr)
      st[(t / cpad) * SP * VEC + C + t % cpad] = T(0);
    for (int t = tid; t < cpad * R; t += nthr) {
      const int c = C + t / R, r = t % R;
      st[lay.slab + ((c / VEC) * RS + r) * VEC + c % VEC] = T(0);
    }
  }
  for (int t = tid; t < R * R; t += nthr) h_s[t] = h[t];

  // copy subject k's slab, Vg_k and w_k into stage `st`
  const Walk slab0(tid, nthr, ALIGNED ? NP : C), vg0(tid, nthr, R);
  auto fetch = [&](T* st, int64_t k) {
    const T* src = vals + k * I * C;
    Walk w = slab0;
    if constexpr (ALIGNED) {                  // rows are whole 16-byte runs
      for (int u = tid; u < I * NP; u += nthr, w.step())
        cp_async<16>(st + (w.row * SP + w.col) * VEC, src + (int64_t)u * VEC);
    } else {
      for (int u = tid; u < I * C; u += nthr, w.step())
        cp_async<sizeof(T)>(st + w.row * SP * VEC + w.col, src + u);
    }
    const T* vsrc = vg + k * C * R;
    T* vdst = st + lay.slab;
    w = vg0;                                  // (c, r) of Vg_k
    for (int u = tid; u < C * R; u += nthr, w.step())
      cp_async<sizeof(T)>(vdst + ((w.row / VEC) * RS + w.col) * VEC + w.row % VEC, vsrc + u);
    for (int u = tid; u < R; u += nthr)
      cp_async<sizeof(T)>(st + lay.slab + lay.vg + u, wb + k * R + u);
  };
  auto subject = [&](int n) { return (int64_t)blockIdx.x + (int64_t)n * gridDim.x; };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_mine) fetch(ring + s * lay.stage, subject(s));
    cp_async_commit();
  }
  for (int n = 0; n < n_mine; ++n) {         // block-uniform
    cp_async_wait<kStages - 2>();           // subject n's copies are in
    __syncthreads();                         // everyone's; stage n-1 is read
    const int nn = n + kStages - 1;
    if (nn < n_mine) fetch(ring + (nn % kStages) * lay.stage, subject(nn));
    cp_async_commit();

    const T* st = ring + (n % kStages) * lay.stage;
    const T* x_s = st;
    const T* vg_s = st + lay.slab;
    const T* w_s = vg_s + lay.vg;
    const int64_t k = subject(n);
    for (int i0 = 0; i0 < I; i0 += kTileRows) {
      int rows[RPT];
      T acc[RPT][RMAX];
#pragma unroll
      for (int t = 0; t < RPT; ++t) {
        rows[t] = i0 + t * kRingWarps * kSlots + warp * kSlots + slot;
#pragma unroll
        for (int r = 0; r < RMAX; ++r) acc[t][r] = T(0);
      }
      if (i0 + warp * kSlots >= I) break;    // warp-uniform: no row of this warp is left
      for (int p = q; p < NP; p += kGroups) {
        Pack<T> xp[RPT];
#pragma unroll
        for (int t = 0; t < RPT; ++t)
          xp[t] = load_pack(x_s + ((rows[t] < I ? rows[t] : 0) * SP + p) * VEC);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < R) {
            const Pack<T> vp = load_pack(vg_s + (p * RS + r) * VEC);
#pragma unroll
            for (int t = 0; t < RPT; ++t)
#pragma unroll
              for (int j = 0; j < VEC; ++j) acc[t][r] += xp[t].v[j] * vp.v[j];
          }
        }
      }
#pragma unroll
      for (int t = 0; t < RPT; ++t) {
        // the kGroups C groups of a row: lanes slot + kSlots * g, in a fixed order
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < R) {
#pragma unroll
            for (int off = kSlots; off < kWarp; off <<= 1)
              acc[t][r] += __shfl_xor_sync(0xffffffffu, acc[t][r], off);
          }
        }
        if (rows[t] < I) {
          const int64_t o = (k * I + rows[t]) * R;
          for (int l = q; l < R; l += kGroups) {   // B[i, l] = sum_r (XkV w)[r] H[l, r]
            T b = T(0);
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
              if (r < R) b += (acc[t][r] * w_s[r]) * h_s[l * R + r];
            xkv[o + l] = pick<T, RMAX>(acc[t], l);
            bout[o + l] = b;
          }
        }
      }
    }
  }
  cp_async_wait<0>();                        // leave no copy in flight
}

template <typename T, int RMAX, bool WIDE, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
procrustes_b_kernel(const T* __restrict__ vals, const T* __restrict__ vg,
                    const T* __restrict__ wb, const T* __restrict__ h,
                    T* __restrict__ xkv, T* __restrict__ bout,
                    int I, int C, int R, int CC) {
  const int RS = row_stride(WIDE ? RMAX : R);
  T* vg_s = smem_base<T>();                 // [CC, RS]
  T* h_s = vg_s + (size_t)CC * RS;          // [R, R]  (not WIDE)
  T* w_s = h_s + R * R;                     // [R]     (not WIDE)
  const int64_t k = blockIdx.x;
  const T* vg_k = vg + k * C * R;
  if (!WIDE) {
    for (int t = threadIdx.x; t < R * R; t += blockDim.x) h_s[t] = h[t];
    for (int t = threadIdx.x; t < R; t += blockDim.x) w_s[t] = wb[k * R + t];
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const T* vals_k = vals + k * I * C;

  // Row i's XkV[i, r0:r0+RW] is in acc (every lane): write it, and B.
  auto finish_row = [&](int i, T (&acc)[RMAX], int r0, int RW) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < RW) acc[r] = warp_sum(acc[r]);
    const int64_t o = (k * I + i) * R;
    if constexpr (!WIDE) {
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
          xkv[o + l] = pick<T, RMAX>(acc, l);
          bout[o + l] = b;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLaneSlots<RMAX>; ++j) {
        const int l = lane + j * kWarp;
        if (l < RW) xkv[o + r0 + l] = pick<T, RMAX>(acc, l);
      }
      for (int l = lane; l < R; l += kWarp) {
        T b = T(0);
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r < RW) b += (acc[r] * wb[k * R + r0 + r]) * h[(int64_t)l * R + r0 + r];
        bout[o + l] = (r0 == 0) ? b : bout[o + l] + b;
      }
    }
  };

  for (int r0 = 0; r0 < (WIDE ? R : 1); r0 += RMAX) {   // one pass unless WIDE
    const int RW = WIDE ? min(RMAX, R - r0) : R;
    if constexpr (!CHUNKED) {               // all of Vg_k at once: a warp per row
      if (r0 > 0) __syncthreads();          // the previous R chunk is done
      stage_tile(vg_s, vg_k + r0, C, RW, R, RS);
      __syncthreads();
      for (int i = warp; i < I; i += kWarps) {
        T acc[RMAX];
#pragma unroll
        for (int r = 0; r < RMAX; ++r) acc[r] = T(0);
        row_times_vg<T, RMAX>(vals_k + (int64_t)i * C, vg_s, C, RW, RS, lane, acc);
        finish_row(i, acc, r0, RW);
      }
    } else {
      // Vg_k in chunks of CC rows: each tile of kWarps rows takes every chunk
      for (int i0 = 0; i0 < I; i0 += kWarps) {
        const int i = i0 + warp;
        T acc[RMAX];
#pragma unroll
        for (int r = 0; r < RMAX; ++r) acc[r] = T(0);
        for (int c0 = 0; c0 < C; c0 += CC) {
          const int cn = min(CC, C - c0);
          __syncthreads();
          stage_tile(vg_s, vg_k + (int64_t)c0 * R + r0, cn, RW, R, RS);
          __syncthreads();
          if (i < I)
            row_times_vg<T, RMAX>(vals_k + (int64_t)i * C + c0, vg_s, cn, RW, RS,
                                  lane, acc);
        }
        if (i < I) finish_row(i, acc, r0, RW);   // warp-uniform
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
// order. No atomics: two runs give the same bits. Q_k and XkV_k are staged
// in IT-row tiles and the entries in E-entry chunks, each the whole of it
// when it fits.
// ---------------------------------------------------------------------------
template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
mode1_partial_kernel(const T* __restrict__ q, const T* __restrict__ xkv,
                     const T* __restrict__ wb, T* __restrict__ partials,
                     int K, int I, int R, int per_block, int IT, int E) {
  T* q_s = smem_base<T>();                  // [IT, R]
  T* x_s = q_s + IT * R;                    // [IT, R]
  T* w_s = x_s + IT * R;                    // [R]
  T* acc_s = w_s + R;                       // [E], entry p owned by one thread
  const int RR = R * R;
  const int k0 = blockIdx.x * per_block;
  const int k1 = min(K, k0 + per_block);
  for (int e0 = 0; e0 < (CHUNKED ? RR : 1); e0 += (CHUNKED ? E : 1)) {   // one pass unless CHUNKED
    const int en = CHUNKED ? min(E, RR - e0) : RR;
    for (int p = threadIdx.x; p < en; p += blockDim.x) acc_s[p] = T(0);
    for (int k = k0; k < k1; ++k) {
      for (int t0 = 0; t0 < (CHUNKED ? I : 1); t0 += (CHUNKED ? IT : 1)) {
        const int in = CHUNKED ? min(IT, I - t0) : I;
        __syncthreads();                    // the previous tile is done
        const int64_t base = ((int64_t)k * I + t0) * R;
        for (int t = threadIdx.x; t < in * R; t += blockDim.x) {
          q_s[t] = q[base + t];
          x_s[t] = xkv[base + t];
        }
        for (int t = threadIdx.x; t < R; t += blockDim.x) w_s[t] = wb[(int64_t)k * R + t];
        __syncthreads();
        for (int p = threadIdx.x; p < en; p += blockDim.x) {
          const int r = (e0 + p) / R, l = (e0 + p) - r * R;
          T s = T(0);
          for (int i = 0; i < in; ++i) s += q_s[i * R + r] * x_s[i * R + l];
          acc_s[p] += s * w_s[l];
        }
      }
    }
    for (int p = threadIdx.x; p < en; p += blockDim.x)
      partials[(int64_t)blockIdx.x * RR + e0 + p] = acc_s[p];
  }
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
// Q_k (in IC-row chunks), H and w_k in shared memory, the R-wide column of
// Y_k in registers. WIDE (R > 64): H and w_k from global memory, and each
// output row sums the R chunks in place (one owning thread). Padded columns
// and masked subjects write zeros.
// ---------------------------------------------------------------------------
template <typename T, int RMAX, bool WIDE, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
mode2_compact_kernel(const T* __restrict__ vals, const T* __restrict__ q,
                     const T* __restrict__ h, const T* __restrict__ wb,
                     const T* __restrict__ col_mask, T* __restrict__ out,
                     int I, int C, int R, int IC) {
  const int RS = row_stride(WIDE ? RMAX : R);
  T* q_s = smem_base<T>();                  // [IC, RS]
  T* h_s = q_s + (size_t)IC * RS;           // [R, R]  (not WIDE)
  T* w_s = h_s + R * R;                     // [R]     (not WIDE)
  const int64_t k = blockIdx.x;
  const T* q_k = q + k * I * R;
  if (!WIDE) {
    for (int t = threadIdx.x; t < R * R; t += blockDim.x) h_s[t] = h[t];
    for (int t = threadIdx.x; t < R; t += blockDim.x) w_s[t] = wb[k * R + t];
  }
  const T* vals_k = vals + k * I * C;

  // y[r] += sum_i X_k[i0 + i, c] * Q_k[i0 + i, r0 + r] over the staged rows
  auto column_times_q = [&](int c, int i0, int in, int RW, T (&y)[RMAX]) {
    for (int i = 0; i < in; ++i) {
      const T v = vals_k[(int64_t)(i0 + i) * C + c];
      const T* qrow = q_s + i * RS;
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < RW) y[r] += v * qrow[r];
    }
  };
  // Column c's Y_k[r0:r0+RW, c] is in y: write (or add) its output row.
  auto finish_column = [&](int c, const T (&y)[RMAX], int r0, int RW) {
    const T cm = col_mask[k * C + c];
    T* orow = out + (k * C + c) * R;
    if constexpr (!WIDE) {
      for (int l = 0; l < R; ++l) {
        T a = T(0);
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r < R) a += y[r] * h_s[r * R + l];
        orow[l] = a * w_s[l] * cm;
      }
    } else {
      for (int l = 0; l < R; ++l) {
        T a = T(0);
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r < RW) a += y[r] * h[(int64_t)(r0 + r) * R + l];
        a = a * wb[k * R + l] * cm;
        orow[l] = (r0 == 0) ? a : orow[l] + a;
      }
    }
  };

  for (int r0 = 0; r0 < (WIDE ? R : 1); r0 += RMAX) {   // one pass unless WIDE
    const int RW = WIDE ? min(RMAX, R - r0) : R;
    if constexpr (!CHUNKED) {               // all of Q_k at once: a thread per column
      if (r0 > 0) __syncthreads();          // the previous R chunk is done
      stage_tile(q_s, q_k + r0, I, RW, R, RS);
      __syncthreads();
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        T y[RMAX];
#pragma unroll
        for (int r = 0; r < RMAX; ++r) y[r] = T(0);
        column_times_q(c, 0, I, RW, y);
        finish_column(c, y, r0, RW);
      }
    } else {
      // Q_k in chunks of IC rows: each tile of blockDim columns takes every chunk
      for (int c0 = 0; c0 < C; c0 += blockDim.x) {
        const int c = c0 + threadIdx.x;
        T y[RMAX];
#pragma unroll
        for (int r = 0; r < RMAX; ++r) y[r] = T(0);
        for (int i0 = 0; i0 < I; i0 += IC) {
          const int in = min(IC, I - i0);
          __syncthreads();
          stage_tile(q_s, q_k + (int64_t)i0 * R + r0, in, RW, R, RS);
          __syncthreads();
          if (c < C) column_times_q(c, i0, in, RW, y);
        }
        if (c < C) finish_column(c, y, r0, RW);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// F4 fused_ykv. Replaces src/repro/kernels/fused.py fused_ykv (pallas_call
// at :357): G_k = Q_k^T X_k Vg_k [R, R], the third pass over the slab; it
// feeds the mode-3 coldot and the fit. Bound: the slab bytes. One block per
// subject: the slab rows go through X_k Vg_k exactly as in F1 (one warp per
// row, Vg_k in CC-row chunks), the [IT, R] products of a tile of rows stay
// in shared memory beside that tile of Q_k, and one thread per (r, l) entry
// reduces Q_k^T (X_k Vg_k) over the tile's rows in a fixed order, adding the
// tiles and the 64-wide chunks of l in place (one owning thread per entry).
// ---------------------------------------------------------------------------
template <typename T, int RMAX, bool WIDE, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
ykv_kernel(const T* __restrict__ vals, const T* __restrict__ q,
           const T* __restrict__ vg, T* __restrict__ out, int I, int C, int R,
           int CC, int IT) {
  const int RS = row_stride(WIDE ? RMAX : R);   // Vg_k and X_k Vg_k tiles
  const int RQ = WIDE ? row_stride(R) : RS;     // Q_k tile: all of R
  T* vg_s = smem_base<T>();                     // [CC, RS]
  T* q_s = vg_s + (size_t)CC * RS;              // [IT, RQ]
  T* x_s = q_s + (size_t)IT * RQ;               // [IT, RS]  X_k Vg_k
  const int64_t k = blockIdx.x;
  const T* vg_k = vg + k * C * R;
  const T* q_k = q + k * I * R;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const T* vals_k = vals + k * I * C;

  // Tile row i's X_k Vg_k piece is in acc (every lane): keep it in x_s.
  auto finish_row = [&](int i, T (&acc)[RMAX], int RW) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < RW) acc[r] = warp_sum(acc[r]);
#pragma unroll
    for (int j = 0; j < kLaneSlots<RMAX>; ++j) {
      const int l = lane + j * kWarp;
      if (l < RW) x_s[i * RS + l] = pick<T, RMAX>(acc, l);
    }
  };

  for (int r0 = 0; r0 < (WIDE ? R : 1); r0 += RMAX) {   // one pass unless WIDE
    const int RW = WIDE ? min(RMAX, R - r0) : R;
    for (int t0 = 0; t0 < (CHUNKED ? I : 1); t0 += (CHUNKED ? IT : 1)) {   // one tile unless CHUNKED
      const int in = CHUNKED ? min(IT, I - t0) : I;
      if (r0 > 0 || t0 > 0) __syncthreads();   // the previous tile is done
      if (!CHUNKED || (CC >= C && t0 == 0)) stage_tile(vg_s, vg_k + r0, C, RW, R, RS);
      if (!CHUNKED || r0 == 0 || IT < I)
        stage_tile(q_s, q_k + (int64_t)t0 * R, in, R, R, RQ);
      __syncthreads();
      if (!CHUNKED || CC >= C) {                // all of Vg_k at once: a warp per row
        for (int i = warp; i < in; i += kWarps) {
          T acc[RMAX];
#pragma unroll
          for (int r = 0; r < RMAX; ++r) acc[r] = T(0);
          row_times_vg<T, RMAX>(vals_k + (int64_t)(t0 + i) * C, vg_s, C, RW, RS,
                                lane, acc);
          finish_row(i, acc, RW);
        }
      } else {                                  // Vg_k in chunks of CC rows
        for (int i0 = 0; i0 < in; i0 += kWarps) {
          const int i = i0 + warp;
          T acc[RMAX];
#pragma unroll
          for (int r = 0; r < RMAX; ++r) acc[r] = T(0);
          for (int c0 = 0; c0 < C; c0 += CC) {
            const int cn = min(CC, C - c0);
            __syncthreads();
            stage_tile(vg_s, vg_k + (int64_t)c0 * R + r0, cn, RW, R, RS);
            __syncthreads();
            if (i < in)
              row_times_vg<T, RMAX>(vals_k + (int64_t)(t0 + i) * C + c0, vg_s, cn,
                                    RW, RS, lane, acc);
          }
          if (i < in) finish_row(i, acc, RW);
        }
      }
      __syncthreads();
      // G[r, r0 + l] (+)= sum over the tile's rows of Q[i, r] * XkV[i, r0 + l]
      for (int p = threadIdx.x; p < R * RW; p += blockDim.x) {
        const int r = p / RW, l = p - r * RW;
        T g = T(0);
        for (int i = 0; i < in; ++i) g += q_s[i * RQ + r] * x_s[i * RS + l];
        T* o = out + k * R * R + r * R + r0 + l;
        *o = (CHUNKED && t0 > 0) ? *o + g : g;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host-side launchers. Each sizes its shared-memory chunks: the whole
// subject when it fits in kMaxDynamicSmem, else as many rows as fit.
// ---------------------------------------------------------------------------
// Rows of `stride` elements that fit beside `fixed` elements of T.
template <typename T>
int rows_that_fit(size_t fixed, size_t stride) {
  const size_t cap = kMaxDynamicSmem / sizeof(T);
  return fixed + stride <= cap ? (int)((cap - fixed) / stride) : 0;
}

// F1's variants, as spartan_fused_procrustes_b_variant reports them.
enum F1Variant { kRing = 0, kRingElementCopies = 1, kRowWarp = 2, kRowWarpChunked = 3,
                 kRowWarpWide = 4, kRowWarpWideChunked = 5 };

// The Vg_k rows the row-warp variant stages at a time.
template <typename T>
int f1_rows_per_chunk(int C, int R, bool wide, int rmax) {
  const size_t fixed = wide ? 0 : (size_t)R * R + R;
  return std::min(C, rows_that_fit<T>(fixed, row_stride(wide ? rmax : R)));
}

// RING where its stages fit and R <= 64 (16-byte copies when every slab
// row starts on a 16-byte boundary), else ROW-WARP.
template <typename T>
int f1_variant(int I, int C, int R, bool aligned) {
  if (R <= kTile && ring_layout<T>(I, C, R).smem_bytes <= (size_t)kMaxDynamicSmem)
    return aligned && C % (16 / (int)sizeof(T)) == 0 ? kRing : kRingElementCopies;
  const bool wide = R > kTile;
  const bool chunked = f1_rows_per_chunk<T>(C, R, wide, kTile) < C;
  return wide ? (chunked ? kRowWarpWideChunked : kRowWarpWide)
              : (chunked ? kRowWarpChunked : kRowWarp);
}

template <typename T, int RMAX, bool WIDE>
cudaError_t launch_f1(const void* vals, const void* vg, const void* wb,
                      const void* h, void* xkv, void* b, int K, int I, int C,
                      int R, cudaStream_t stream) {
  const int variant = f1_variant<T>(I, C, R, reinterpret_cast<uintptr_t>(vals) % 16 == 0);
  if (variant == kRing || variant == kRingElementCopies) {
    const size_t smem = ring_layout<T>(I, C, R).smem_bytes;
    auto kernel = variant == kRing ? procrustes_b_ring_kernel<T, RMAX, true>
                                   : procrustes_b_ring_kernel<T, RMAX, false>;
    cudaError_t e = allow_smem(kernel, smem);
    int grid = 0;
    if (e == cudaSuccess) e = persistent_grid(kernel, kRingThreads, smem, K, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kRingThreads, smem, stream>>>(
        static_cast<const T*>(vals), static_cast<const T*>(vg),
        static_cast<const T*>(wb), static_cast<const T*>(h),
        static_cast<T*>(xkv), static_cast<T*>(b), K, I, C, R);
    return cudaGetLastError();
  }
  const int RS = row_stride(WIDE ? RMAX : R);
  const size_t fixed = WIDE ? 0 : (size_t)R * R + R;
  const int CC = f1_rows_per_chunk<T>(C, R, WIDE, RMAX);
  if (CC < 1) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)CC * RS + fixed) * sizeof(T);
  auto kernel = CC < C ? procrustes_b_kernel<T, RMAX, WIDE, true>
                       : procrustes_b_kernel<T, RMAX, WIDE, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<K, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const T*>(vg),
      static_cast<const T*>(wb), static_cast<const T*>(h),
      static_cast<T*>(xkv), static_cast<T*>(b), I, C, R, CC);
  return cudaGetLastError();
}

template <typename T, int RMAX, bool WIDE>
cudaError_t launch_f3(const void* vals, const void* q, const void* h,
                      const void* wb, const void* cm, void* out, int K, int I,
                      int C, int R, cudaStream_t stream) {
  const int RS = row_stride(WIDE ? RMAX : R);
  const size_t fixed = WIDE ? 0 : (size_t)R * R + R;
  const int IC = std::min(I, rows_that_fit<T>(fixed, RS));
  if (IC < 1) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)IC * RS + fixed) * sizeof(T);
  auto kernel = IC < I ? mode2_compact_kernel<T, RMAX, WIDE, true>
                       : mode2_compact_kernel<T, RMAX, WIDE, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<K, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const T*>(q),
      static_cast<const T*>(h), static_cast<const T*>(wb),
      static_cast<const T*>(cm), static_cast<T*>(out), I, C, R, IC);
  return cudaGetLastError();
}

template <typename T, int RMAX, bool WIDE>
cudaError_t launch_f4(const void* vals, const void* q, const void* vg,
                      void* out, int K, int I, int C, int R,
                      cudaStream_t stream) {
  const int RS = row_stride(WIDE ? RMAX : R), RQ = row_stride(R);
  int CC = C, IT = I;
  if (((size_t)C * RS + (size_t)I * (RQ + RS)) * sizeof(T) > (size_t)kMaxDynamicSmem) {
    // half of the budget to tiles of rows (Q_k and X_k Vg_k), the rest to Vg_k
    IT = std::min(I, std::max(1, rows_that_fit<T>(0, 2 * (size_t)(RQ + RS))));
    CC = std::min(C, rows_that_fit<T>((size_t)IT * (RQ + RS), RS));
  }
  if (CC < 1) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)CC * RS + (size_t)IT * (RQ + RS)) * sizeof(T);
  auto kernel = CC < C || IT < I ? ykv_kernel<T, RMAX, WIDE, true>
                                 : ykv_kernel<T, RMAX, WIDE, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<K, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const T*>(q),
      static_cast<const T*>(vg), static_cast<T*>(out), I, C, R, CC, IT);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_f2(const void* q, const void* xkv, const void* wb,
                      void* partials, void* out, int K, int I, int R,
                      int n_partials, cudaStream_t stream) {
  const int per_block = (K + n_partials - 1) / n_partials;
  const size_t RR = (size_t)R * R;
  int IT = I, E = (int)RR;
  if ((2 * (size_t)I * R + R + RR) * sizeof(T) > (size_t)kMaxDynamicSmem) {
    // half of the budget to the entries, the rest to tiles of rows
    E = (int)std::min(RR, (size_t)rows_that_fit<T>(0, 2));
    IT = std::min(I, rows_that_fit<T>((size_t)E + R, 2 * (size_t)R));
  }
  if (IT < 1 || E < 1) return cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)IT * R + R + E) * sizeof(T);
  auto kernel = IT < I || E < (int)RR ? mode1_partial_kernel<T, true>
                                      : mode1_partial_kernel<T, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<n_partials, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(xkv),
      static_cast<const T*>(wb), static_cast<T*>(partials), K, I, R, per_block,
      IT, E);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mode1_reduce_kernel<T><<<1, kThreads, 0, stream>>>(
      static_cast<const T*>(partials), static_cast<T*>(out), n_partials, R * R);
  return cudaGetLastError();
}

}  // namespace

// Instantiate a launcher for T in {float, double}: register tiles of 8, 16,
// 32 or 64 entries of R, and the 64-wide tile looped over R above 64.
#define SPARTAN_DISPATCH(LAUNCH, ...)                                         \
  do {                                                                        \
    if (R < 1) return (int)cudaErrorInvalidValue;                             \
    if (dtype == 0) {                                                         \
      if (R <= 8) return (int)LAUNCH<float, 8, false>(__VA_ARGS__);           \
      if (R <= 16) return (int)LAUNCH<float, 16, false>(__VA_ARGS__);         \
      if (R <= 32) return (int)LAUNCH<float, 32, false>(__VA_ARGS__);         \
      if (R <= kTile) return (int)LAUNCH<float, kTile, false>(__VA_ARGS__);   \
      return (int)LAUNCH<float, kTile, true>(__VA_ARGS__);                    \
    }                                                                         \
    if (dtype == 1) {                                                         \
      if (R <= 8) return (int)LAUNCH<double, 8, false>(__VA_ARGS__);          \
      if (R <= 16) return (int)LAUNCH<double, 16, false>(__VA_ARGS__);        \
      if (R <= 32) return (int)LAUNCH<double, 32, false>(__VA_ARGS__);        \
      if (R <= kTile) return (int)LAUNCH<double, kTile, false>(__VA_ARGS__);  \
      return (int)LAUNCH<double, kTile, true>(__VA_ARGS__);                   \
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

// The variant a spartan_fused_procrustes_b launch takes (F1Variant: 0 ring,
// 1 ring with element copies, 2-5 row-warp, chunked, wide, wide chunked);
// aligned: the slab starts on a 16-byte boundary. -1 for an unknown dtype.
int spartan_fused_procrustes_b_variant(int dtype, int I, int C, int R, int aligned) {
  if (R < 1 || I < 1 || C < 1) return -1;
  if (dtype == 0) return f1_variant<float>(I, C, R, aligned != 0);
  if (dtype == 1) return f1_variant<double>(I, C, R, aligned != 0);
  return -1;
}

int spartan_fused_mode1_xkv(int dtype, const void* q, const void* xkv,
                            const void* wb, void* partials, void* out, int K,
                            int I, int R, int n_partials, void* stream) {
  if (R < 1 || n_partials < 1) return (int)cudaErrorInvalidValue;
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
