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
// f64 -> f64). The slab and Vg (S) may be half-width instead (bfloat16 or
// float16, with T = float): F1 and F4 take both half, F3 a half slab; each
// half value is loaded at 2 bytes and widened to float before its product
// (common.cuh), so the slab bytes halve and the arithmetic stays F1-F4's in
// float. F2 reads no slab and takes float or double. All tensors are
// contiguous, row-major.
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
// persistent blocks, and F2 its [I, R] operands (their notes below); F3 and
// F4 read the slab straight from device memory, one block per subject.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py):
// every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success); F2 takes
// the caller's workspace (spartan_fused_mode1_workspace).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
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
// ld) into shared memory with row stride RS, widened to T. A tile fits in
// shared memory, so its offsets fit in 32 bits.
template <typename T, typename S>
__device__ inline void stage_tile(T* dst, const S* __restrict__ src, int n,
                                  int w, int ld, int RS) {
  for (int t = threadIdx.x; t < n * w; t += blockDim.x) {
    const int row = t / w, col = t - row * w;
    dst[row * RS + col] = widen(src[row * ld + col]);
  }
}

// One warp adds a slab row piece's x[r] += sum_c row[c] * vg_s[c, r] over
// c < cn, r < RW: lanes stride over c (coalesced loads). The caller sums
// the lanes (warp_sum) once every chunk of the row is in.
template <typename T, typename S, int RMAX>
__device__ inline void row_times_vg(const S* __restrict__ row, const T* vg_s,
                                    int cn, int RW, int RS, int lane,
                                    T (&acc)[RMAX]) {
  for (int c = lane; c < cn; c += kWarp) {
    const T v = widen(row[c]);
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
// slab. Bound: the slab bytes (R = 5, f32: 10 operations per 4-byte load;
// half: per 2-byte load). Two variants, picked by shape (f1_variant):
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
// With a half slab and Vg (S) a 16-byte copy carries eight values, and the
// stages hold them at half width, widened as they are read. cp.async takes
// no 2-byte copy, so a half Vg_k (one contiguous run of C*R values) arrives
// by 16-byte copies in a raw area of its stage, and the block puts it in
// its packs after the stage's barrier (one more barrier a subject); where
// the run is not whole 16-byte packs, its element copies are plain loads
// and stores. (At bf16 at the main path's largest bucket on an H100, in a
// graph: element copies of every Vg_k 0.907 ms, the raw run 0.748, and
// with the register cap below 0.678, against 0.661 in f32.)
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

// 16 bytes of S from shared memory.
template <typename S>
struct Pack {
  static constexpr int kN = 16 / sizeof(S);
  S v[kN];
};
template <typename S>
__device__ inline Pack<S> load_pack(const S* p) {
  Pack<S> f;
  if constexpr (sizeof(S) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    f.v[0] = q.x; f.v[1] = q.y; f.v[2] = q.z; f.v[3] = q.w;
  } else if constexpr (sizeof(S) == 8) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    f.v[0] = q.x; f.v[1] = q.y;
  } else {                                   // eight half-width values
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f.v[2 * j] = half_from_bits<S>((unsigned short)(w[j] & 0xffffu));
      f.v[2 * j + 1] = half_from_bits<S>((unsigned short)(w[j] >> 16));
    }
  }
  return f;
}

// The ring's shared-memory layout, in bytes (every part a whole number of
// 16-byte packs): per stage the slab [I, SP packs] and Vg_k [NP packs of
// c][RS][VEC] of S, w_k of T and, for a half S, Vg_k's raw run [C*R] as it
// arrives; after the stages, H [R, R] of T. VEC = 16 / sizeof(S) values a
// pack.
struct RingLayout {
  int vec, np, sp, rs;
  size_t slab, vg, w, raw, stage, smem_bytes;
};

template <typename T, typename S>
__host__ __device__ inline RingLayout ring_layout(int I, int C, int R) {
  RingLayout s;
  s.vec = 16 / (int)sizeof(S);
  s.np = (C + s.vec - 1) / s.vec;          // 16-byte packs of a row
  // SP = 2 mod 8: the 4 rows x 2 packs that 8 lanes read at once hit
  // distinct banks; RS odd: the two groups' Vg packs do too
  s.sp = s.np + ((2 - s.np % 8) + 8) % 8;
  s.rs = R | 1;
  s.slab = (size_t)I * s.sp * 16;
  s.vg = (size_t)s.np * s.rs * 16;
  s.w = ((size_t)R * sizeof(T) + 15) / 16 * 16;
  s.raw = s.slab + s.vg + s.w;
  s.stage = s.raw + (sizeof(S) == 2 ? ((size_t)C * R * sizeof(S) + 15) / 16 * 16 : 0);
  s.smem_bytes = kStages * s.stage + (size_t)R * R * sizeof(T);
  return s;
}

// Blocks of the ring an SM must hold: four at half width up to R = 8,
// whose eight-value packs took 101 registers a thread at R = 5, two blocks
// an SM (f32 takes 64 registers, and its 66 KB of stages hold three). In a
// graph on an H100 at bf16, R = 5: no bound 0.748 ms, three blocks 0.698,
// four (64 registers) 0.678. Wider tiles keep the compiler's count.
template <typename S, int RMAX>
constexpr int kRingMinBlocks = sizeof(S) == 2 && RMAX <= 8 ? 4 : 1;

template <typename T, typename S, int RMAX, bool ALIGNED>
__global__ void __launch_bounds__(kRingThreads, kRingMinBlocks<S, RMAX>)
procrustes_b_ring_kernel(const S* __restrict__ vals, const S* __restrict__ vg,
                         const T* __restrict__ wb, const T* __restrict__ h,
                         T* __restrict__ xkv, T* __restrict__ bout, int K, int I,
                         int C, int R) {
  constexpr int VEC = 16 / sizeof(S);
  constexpr int RPT = RMAX <= 16 ? 2 : 1;      // rows a lane owns per row tile
  constexpr int kTileRows = RPT * kRingWarps * kSlots;
  const RingLayout lay = ring_layout<T, S>(I, C, R);
  const int NP = lay.np, SP = lay.sp, RS = lay.rs;
  unsigned char* ring = smem_base<unsigned char>();
  T* h_s = reinterpret_cast<T*>(ring + kStages * lay.stage);
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid / kWarp, lane = tid % kWarp;
  const int q = lane / kSlots, slot = lane % kSlots;   // C group, row slot
  const int n_mine = K > (int)blockIdx.x ? (K - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  // a half Vg_k arrives as whole 16-byte packs in the raw area
  const bool vg16 = sizeof(S) == 2 && (C * R) % VEC == 0 &&
                    reinterpret_cast<uintptr_t>(vg) % 16 == 0;

  // pads that no copy writes: slab columns and Vg rows C .. NP*VEC - 1
  const int cpad = NP * VEC - C;
  for (int s = 0; s < kStages; ++s) {
    S* st = reinterpret_cast<S*>(ring + s * lay.stage);
    S* vst = reinterpret_cast<S*>(ring + s * lay.stage + lay.slab);
    for (int t = tid; t < I * cpad; t += nthr)
      st[(t / cpad) * SP * VEC + C + t % cpad] = S(0.0f);
    for (int t = tid; t < cpad * R; t += nthr) {
      const int c = C + t / R, r = t % R;
      vst[((c / VEC) * RS + r) * VEC + c % VEC] = S(0.0f);
    }
  }
  for (int t = tid; t < R * R; t += nthr) h_s[t] = h[t];

  // copy subject k's slab, Vg_k and w_k into the stage at `stb`
  const Walk slab0(tid, nthr, ALIGNED ? NP : C), vg0(tid, nthr, R);
  auto fetch = [&](unsigned char* stb, int64_t k) {
    S* st = reinterpret_cast<S*>(stb);
    const S* src = vals + k * I * C;
    Walk w = slab0;
    if constexpr (ALIGNED) {                  // rows are whole 16-byte runs
      for (int u = tid; u < I * NP; u += nthr, w.step())
        cp_async<16>(st + (w.row * SP + w.col) * VEC, src + (int64_t)u * VEC);
    } else {
      for (int u = tid; u < I * C; u += nthr, w.step())
        copy_elem(st + w.row * SP * VEC + w.col, src + u);
    }
    const S* vsrc = vg + k * C * R;
    if (vg16) {                               // the raw run, put in its packs later
      S* raw = reinterpret_cast<S*>(stb + lay.raw);
      for (int u = tid; u * VEC < C * R; u += nthr)
        cp_async<16>(raw + u * VEC, vsrc + u * VEC);
    } else {
      S* vdst = reinterpret_cast<S*>(stb + lay.slab);
      w = vg0;                                // (c, r) of Vg_k
      for (int u = tid; u < C * R; u += nthr, w.step())
        copy_elem(vdst + ((w.row / VEC) * RS + w.col) * VEC + w.row % VEC, vsrc + u);
    }
    T* wdst = reinterpret_cast<T*>(stb + lay.slab + lay.vg);
    for (int u = tid; u < R; u += nthr)
      cp_async<sizeof(T)>(wdst + u, wb + k * R + u);
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
    if (vg16) {                               // subject n's raw Vg_k into its packs
      unsigned char* sw = ring + (n % kStages) * lay.stage;
      const S* raw = reinterpret_cast<const S*>(sw + lay.raw);
      S* vdst = reinterpret_cast<S*>(sw + lay.slab);
      Walk w = vg0;                           // (c, r) of Vg_k
      for (int u = tid; u < C * R; u += nthr, w.step())
        vdst[((w.row / VEC) * RS + w.col) * VEC + w.row % VEC] = raw[u];
      __syncthreads();                        // the packs are whole
    }

    const unsigned char* stb = ring + (n % kStages) * lay.stage;
    const S* x_s = reinterpret_cast<const S*>(stb);
    const S* vg_s = reinterpret_cast<const S*>(stb + lay.slab);
    const T* w_s = reinterpret_cast<const T*>(stb + lay.slab + lay.vg);
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
        Pack<S> xp[RPT];
#pragma unroll
        for (int t = 0; t < RPT; ++t)
          xp[t] = load_pack(x_s + ((rows[t] < I ? rows[t] : 0) * SP + p) * VEC);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < R) {
            const Pack<S> vp = load_pack(vg_s + (p * RS + r) * VEC);
#pragma unroll
            for (int t = 0; t < RPT; ++t)
#pragma unroll
              for (int j = 0; j < VEC; ++j) acc[t][r] += widen(xp[t].v[j]) * widen(vp.v[j]);
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

template <typename T, typename S, int RMAX, bool WIDE, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
procrustes_b_kernel(const S* __restrict__ vals, const S* __restrict__ vg,
                    const T* __restrict__ wb, const T* __restrict__ h,
                    T* __restrict__ xkv, T* __restrict__ bout,
                    int I, int C, int R, int CC) {
  const int RS = row_stride(WIDE ? RMAX : R);
  T* vg_s = smem_base<T>();                 // [CC, RS], widened
  T* h_s = vg_s + (size_t)CC * RS;          // [R, R]  (not WIDE)
  T* w_s = h_s + R * R;                     // [R]     (not WIDE)
  const int64_t k = blockIdx.x;
  const S* vg_k = vg + k * C * R;
  if (!WIDE) {
    for (int t = threadIdx.x; t < R * R; t += blockDim.x) h_s[t] = h[t];
    for (int t = threadIdx.x; t < R; t += blockDim.x) w_s[t] = wb[k * R + t];
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const S* vals_k = vals + k * I * C;

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
        row_times_vg<T, S, RMAX>(vals_k + (int64_t)i * C, vg_s, C, RW, RS, lane, acc);
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
            row_times_vg<T, S, RMAX>(vals_k + (int64_t)i * C + c0, vg_s, cn, RW, RS,
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
// order, so the reduction is two-level and deterministic, in one launch
// (common.cuh: kRuns, last_block_to_finish). The first level splits the
// subjects into kRuns fixed runs of contiguous subjects; one thread owns
// each (r, l) entry of a run and sums, subject by subject in order, s =
// sum_i Q[k, i, r] * XkV[k, i, l] (i in order), then acc += s * w_k[l], into
// the run's [R, R] partial. w_k is Wb[k] times mask[k] (mask null: no
// subject mask), the product torch forms when it folds the mask into Wb. The
// block that finishes last sums each entry's partials in run order, one
// chain per entry. No atomic touches a sum: two runs give the same bits.
// Three variants, picked by shape (f2_variant), in one order:
//
// RING, the main path (R*R <= 128 and one group's stages fit in shared
// memory). What held the block-per-run kernel below (CHUNKED) at a quarter
// of its bound: each block summed one subject at a time, copying it into
// shared memory with scalar loads between two barriers with no copy in
// flight while 25 of 128 threads summed, so every subject cost a full
// device-memory latency (~4 us a subject, 29 in a row, with 4.6 MB in
// flight across the card: ~1.1 TB/s); and the second level was a second
// launch of one block. Here persistent blocks of 128 threads give G =
// 128 / R^2 thread groups (5 at R = 5) a run each, in step: while the
// groups sum subject s of their runs, cp.async copies subjects s + 1 ..
// s + kF2Stages - 1 (Q_k, XkV_k in 16-byte packs, w_k) into the other
// stages, so each run keeps three subjects in flight (two or six stages
// were slower). The last block streams the partials through the same
// shared memory while thread p adds row p. What still bounds it (PERF.md):
// alone, the copies move ~2 TB/s in these 1120-byte pieces and the
// sums take two shared-memory loads a multiply-add; the in-order second
// level, a 2048-long chain of adds an entry, takes ~15 us.
// RING-ELEMENT-COPIES: the same, copying element by element, where the
// subjects' [I, R] tiles are not whole 16-byte runs or Q, XkV are not
// 16-byte aligned.
// CHUNKED (R*R > 128, or one group's stages too large): one block per run,
// Q_k and XkV_k staged in IT-row tiles and the entries in E-entry chunks
// (each the whole of it when it fits), as the first kernel of this port.
// ---------------------------------------------------------------------------
constexpr int kF2Stages = 4;
constexpr int kF2Budget = kMaxDynamicSmem / 4;   // a ring block's stages: four blocks an SM

// F2's variants, as spartan_fused_mode1_xkv_variant reports them.
enum F2Variant { kF2Ring = 0, kF2RingElementCopies = 1, kF2Chunked = 2 };

// One group's slot in a stage of F2's ring, in elements of T: Q_k [I*R] at
// 0, XkV_k [I*R] at x, w_k [R] and mask[k] at w, each padded to whole
// 16-byte packs.
struct F2Slot { int x, w, size; };

template <typename T>
__host__ __device__ inline F2Slot f2_slot(int I, int R) {
  constexpr int P = 16 / sizeof(T);
  const int ir = (I * R + P - 1) / P * P;
  return {ir, 2 * ir, 2 * ir + (R + 1 + P - 1) / P * P};
}

// The groups of a ring block: 128 / R^2, fewer where the stages would pass
// kF2Budget, 0 where the ring does not apply.
template <typename T>
int f2_groups(int I, int R) {
  if (R * R > kThreads) return 0;
  const size_t group = (size_t)kF2Stages * f2_slot<T>(I, R).size * sizeof(T);
  if (group > (size_t)kMaxDynamicSmem) return 0;
  return (int)std::max<size_t>(1, std::min<size_t>(kThreads / (R * R), kF2Budget / group));
}

// The last block's second level of F2: out[p] = sum over runs b in order of
// partials[p * ld + b], for every p < RR, one chain per entry. Chunks of NB
// runs of up to blockDim.x entries stream through the two halves of `buf`
// (cap elements) with 16-byte cp.async.cg copies, one chunk in flight while
// thread p adds its row (four parts, three in flight, were slower: smaller
// chunks). A row takes an odd number of packs in shared memory, so the
// 16-byte reads of a quarter-warp hit distinct banks. Where not one pack a
// row fits, the owners read the partials directly.
constexpr int kChunkStages = 2;

template <typename T>
__device__ void sum_partials_in_order(const T* partials, T* __restrict__ out,
                                      int runs, int ld, int RR, T* buf, int cap) {
  constexpr int P = 16 / sizeof(T);
  const int tid = threadIdx.x;
  for (int p0 = 0; p0 < RR; p0 += blockDim.x) {
    const int rows = min((int)blockDim.x, RR - p0);
    const int NB = min(((cap / kChunkStages) / rows - P) / P * P, ld);
    T s = T(0);
    if (NB < P) {
      if (tid < rows)
        for (int b = 0; b < runs; ++b) s += __ldcg(partials + (int64_t)(p0 + tid) * ld + b);
    } else {
      const int NS = (NB / P) % 2 ? NB : NB + P;       // a row's stride in buf
      const int chunks = (runs + NB - 1) / NB;
      auto issue = [&](int c) {                         // chunk c into part c % kChunkStages
        if (c < chunks) {
          T* dst = buf + (c % kChunkStages) * rows * NS;
          const int b0 = c * NB, packs = min(NB, ld - b0) / P;
          for (int j = tid; j < rows * packs; j += blockDim.x) {
            const int row = j / packs, pk = j - row * packs;
            cp_async<16>(dst + row * NS + pk * P,
                         partials + (int64_t)(p0 + row) * ld + b0 + pk * P);
          }
        }
        cp_async_commit();
      };
      for (int c = 0; c < kChunkStages - 1; ++c) issue(c);
      for (int c = 0; c < chunks; ++c) {
        issue(c + kChunkStages - 1);
        cp_async_wait<kChunkStages - 1>();
        __syncthreads();
        if (tid < rows) {
          const T* src = buf + (c % kChunkStages) * rows * NS + tid * NS;
          const int nb = min(NB, runs - c * NB);
          int j = 0;
#pragma unroll 4
          for (; j + P <= nb; j += P) {
            const Pack<T> v = load_pack(src + j);
#pragma unroll
            for (int u = 0; u < P; ++u) s += v.v[u];
          }
          for (; j < nb; ++j) s += src[j];
        }
        __syncthreads();                                // part c % kChunkStages is free
      }
      cp_async_wait<0>();
    }
    if (tid < rows) out[p0 + tid] = s;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
mode1_ring_kernel(const T* __restrict__ q, const T* __restrict__ xkv,
                  const T* __restrict__ wb, const T* __restrict__ mask,
                  unsigned* counter, T* partials, T* __restrict__ out, int K, int I,
                  int R, int G, int runs, int per_run, int ld) {
  constexpr int P = 16 / sizeof(T);
  T* ring = smem_base<T>();                 // [kF2Stages][G] slots
  const F2Slot sl = f2_slot<T>(I, R);
  const int RR = R * R, IR = I * R, tid = threadIdx.x;
  const int g = tid / RR, p = tid - g * RR, r = p / R, l = p - r * R;
  const int nw = R + (mask ? 1 : 0);        // w_k and mask[k]
  const int n_items = (runs + G - 1) / G;   // items: G runs each
  const int steps = (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x * per_run + per_run;
  // step t: subject s = t % per_run of each run of item blockIdx.x +
  // (t / per_run) * gridDim.x; its copies go to stage t % kF2Stages
  auto issue = [&](int t) {
    if (t < steps) {
      const int item = blockIdx.x + (t / per_run) * gridDim.x, s = t % per_run;
      T* stage = ring + (t % kF2Stages) * G * sl.size;
      const int per_group = VEC ? 2 * (IR / P) : 2 * IR;
      for (int j = tid; j < G * (per_group + nw); j += blockDim.x) {
        const int gg = j / (per_group + nw), e = j - gg * (per_group + nw);
        const int run = item * G + gg;
        const int64_t k = (int64_t)run * per_run + s;
        if (run >= runs || k >= K) continue;
        T* slot = stage + gg * sl.size;
        if (e >= per_group) {
          const int c = e - per_group;
          cp_async<sizeof(T)>(slot + sl.w + c, c < R ? wb + k * R + c : mask + k);
        } else if (VEC) {
          const int half = IR / P, x = e >= half, pk = e - x * half;
          cp_async<16>(slot + x * sl.x + pk * P, (x ? xkv : q) + k * IR + pk * P);
        } else {
          const int x = e >= IR, c = e - x * IR;
          cp_async<sizeof(T)>(slot + x * sl.x + c, (x ? xkv : q) + k * IR + c);
        }
      }
    }
    cp_async_commit();    // empty past the end: the groups in flight stay fixed
  };
  for (int t = 0; t < kF2Stages - 1; ++t) issue(t);
  T acc = T(0);
  for (int t = 0; t < steps; ++t) {
    issue(t + kF2Stages - 1);
    cp_async_wait<kF2Stages - 1>();
    __syncthreads();                        // step t's subjects are in
    if (g < G) {
      const int item = blockIdx.x + (t / per_run) * gridDim.x, s = t % per_run;
      const int run = item * G + g;
      if (run < runs && (int64_t)run * per_run + s < K) {
        const T* slot = ring + ((t % kF2Stages) * G + g) * sl.size;
        const T* qa = slot + r;
        const T* xa = slot + sl.x + l;
        T sum = T(0);
#pragma unroll 8
        for (int i = 0; i < I; ++i) sum += qa[i * R] * xa[i * R];   // loads ahead of the chain
        T w = slot[sl.w + l];
        if (mask) w = w * slot[sl.w + R];
        acc += sum * w;
      }
      if (s == per_run - 1) {               // the run's last subject: its partial
        if (run < runs) partials[(int64_t)p * ld + run] = acc;
        acc = T(0);
      }
    }
    __syncthreads();                        // stage t % kF2Stages is free
  }
  cp_async_wait<0>();
  if (last_block_to_finish(counter))
    sum_partials_in_order(partials, out, runs, ld, RR, ring,
                          kF2Stages * G * sl.size);
}

template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
mode1_chunked_kernel(const T* __restrict__ q, const T* __restrict__ xkv,
                     const T* __restrict__ wb, const T* __restrict__ mask,
                     unsigned* counter, T* partials, T* __restrict__ out, int K, int I,
                     int R, int per_block, int IT, int E, int ld) {
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
        for (int t = threadIdx.x; t < R; t += blockDim.x) {
          T w = wb[(int64_t)k * R + t];
          if (mask) w = w * mask[k];
          w_s[t] = w;
        }
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
      partials[(int64_t)(e0 + p) * ld + blockIdx.x] = acc_s[p];
  }
  if (last_block_to_finish(counter))
    sum_partials_in_order(partials, out, gridDim.x, ld, RR, q_s, 2 * IT * R + R + E);
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
// and masked subjects write zeros. A half slab (S) is read at 2 bytes a
// value and widened.
// ---------------------------------------------------------------------------
template <typename T, typename S, int RMAX, bool WIDE, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
mode2_compact_kernel(const S* __restrict__ vals, const T* __restrict__ q,
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
  const S* vals_k = vals + k * I * C;

  // y[r] += sum_i X_k[i0 + i, c] * Q_k[i0 + i, r0 + r] over the staged rows
  auto column_times_q = [&](int c, int i0, int in, int RW, T (&y)[RMAX]) {
    for (int i = 0; i < in; ++i) {
      const T v = widen(vals_k[(int64_t)(i0 + i) * C + c]);
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
// A half slab and Vg (S) are read at 2 bytes a value; Vg_k is staged
// widened.
// ---------------------------------------------------------------------------
template <typename T, typename S, int RMAX, bool WIDE, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
ykv_kernel(const S* __restrict__ vals, const T* __restrict__ q,
           const S* __restrict__ vg, T* __restrict__ out, int I, int C, int R,
           int CC, int IT) {
  const int RS = row_stride(WIDE ? RMAX : R);   // Vg_k and X_k Vg_k tiles
  const int RQ = WIDE ? row_stride(R) : RS;     // Q_k tile: all of R
  T* vg_s = smem_base<T>();                     // [CC, RS]
  T* q_s = vg_s + (size_t)CC * RS;              // [IT, RQ]
  T* x_s = q_s + (size_t)IT * RQ;               // [IT, RS]  X_k Vg_k
  const int64_t k = blockIdx.x;
  const S* vg_k = vg + k * C * R;
  const T* q_k = q + k * I * R;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const S* vals_k = vals + k * I * C;

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
          row_times_vg<T, S, RMAX>(vals_k + (int64_t)(t0 + i) * C, vg_s, C, RW, RS,
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
              row_times_vg<T, S, RMAX>(vals_k + (int64_t)(t0 + i) * C + c0, vg_s, cn,
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
template <typename T, typename S>
int f1_variant(int I, int C, int R, bool aligned) {
  if (R <= kTile && ring_layout<T, S>(I, C, R).smem_bytes <= (size_t)kMaxDynamicSmem)
    return aligned && C % (16 / (int)sizeof(S)) == 0 ? kRing : kRingElementCopies;
  const bool wide = R > kTile;
  const bool chunked = f1_rows_per_chunk<T>(C, R, wide, kTile) < C;
  return wide ? (chunked ? kRowWarpWideChunked : kRowWarpWide)
              : (chunked ? kRowWarpChunked : kRowWarp);
}

template <typename T, typename S, int RMAX, bool WIDE>
cudaError_t launch_f1(const void* vals, const void* vg, const void* wb,
                      const void* h, void* xkv, void* b, int K, int I, int C,
                      int R, cudaStream_t stream) {
  const int variant = f1_variant<T, S>(I, C, R, reinterpret_cast<uintptr_t>(vals) % 16 == 0);
  if (variant == kRing || variant == kRingElementCopies) {
    const size_t smem = ring_layout<T, S>(I, C, R).smem_bytes;
    auto kernel = variant == kRing ? procrustes_b_ring_kernel<T, S, RMAX, true>
                                   : procrustes_b_ring_kernel<T, S, RMAX, false>;
    cudaError_t e = allow_smem(kernel, smem);
    int grid = 0;
    if (e == cudaSuccess) e = persistent_grid(kernel, kRingThreads, smem, K, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kRingThreads, smem, stream>>>(
        static_cast<const S*>(vals), static_cast<const S*>(vg),
        static_cast<const T*>(wb), static_cast<const T*>(h),
        static_cast<T*>(xkv), static_cast<T*>(b), K, I, C, R);
    return cudaGetLastError();
  }
  const int RS = row_stride(WIDE ? RMAX : R);
  const size_t fixed = WIDE ? 0 : (size_t)R * R + R;
  const int CC = f1_rows_per_chunk<T>(C, R, WIDE, RMAX);
  if (CC < 1) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)CC * RS + fixed) * sizeof(T);
  auto kernel = CC < C ? procrustes_b_kernel<T, S, RMAX, WIDE, true>
                       : procrustes_b_kernel<T, S, RMAX, WIDE, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<K, kThreads, smem, stream>>>(
      static_cast<const S*>(vals), static_cast<const S*>(vg),
      static_cast<const T*>(wb), static_cast<const T*>(h),
      static_cast<T*>(xkv), static_cast<T*>(b), I, C, R, CC);
  return cudaGetLastError();
}

template <typename T, typename S, int RMAX, bool WIDE>
cudaError_t launch_f3(const void* vals, const void* q, const void* h,
                      const void* wb, const void* cm, void* out, int K, int I,
                      int C, int R, cudaStream_t stream) {
  const int RS = row_stride(WIDE ? RMAX : R);
  const size_t fixed = WIDE ? 0 : (size_t)R * R + R;
  const int IC = std::min(I, rows_that_fit<T>(fixed, RS));
  if (IC < 1) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)IC * RS + fixed) * sizeof(T);
  auto kernel = IC < I ? mode2_compact_kernel<T, S, RMAX, WIDE, true>
                       : mode2_compact_kernel<T, S, RMAX, WIDE, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<K, kThreads, smem, stream>>>(
      static_cast<const S*>(vals), static_cast<const T*>(q),
      static_cast<const T*>(h), static_cast<const T*>(wb),
      static_cast<const T*>(cm), static_cast<T*>(out), I, C, R, IC);
  return cudaGetLastError();
}

template <typename T, typename S, int RMAX, bool WIDE>
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
  auto kernel = CC < C || IT < I ? ykv_kernel<T, S, RMAX, WIDE, true>
                                 : ykv_kernel<T, S, RMAX, WIDE, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<K, kThreads, smem, stream>>>(
      static_cast<const S*>(vals), static_cast<const T*>(q),
      static_cast<const S*>(vg), static_cast<T*>(out), I, C, R, CC, IT);
  return cudaGetLastError();
}

// F2: RING where R*R <= 128 and a group's stages fit (16-byte copies when
// every subject's [I, R] tile is a whole number of packs and Q, XkV start
// on 16-byte boundaries), else CHUNKED.
template <typename T>
int f2_variant(int I, int R, bool aligned) {
  if (f2_groups<T>(I, R) == 0) return kF2Chunked;
  return aligned && (I * R) % (16 / (int)sizeof(T)) == 0 ? kF2Ring : kF2RingElementCopies;
}

template <typename T>
cudaError_t launch_f2(const void* q, const void* xkv, const void* wb, const void* mask,
                      void* ws, void* out, int K, int I, int R, cudaStream_t stream) {
  const int runs = reduction_runs(K), per_run = (K + runs - 1) / runs;
  const int ld = partials_ld<T>(runs);
  const int variant = f2_variant<T>(I, R, aligned16({q, xkv}));
  if (variant != kF2Chunked) {
    const int G = f2_groups<T>(I, R);
    const size_t smem = (size_t)kF2Stages * G * f2_slot<T>(I, R).size * sizeof(T);
    auto kernel = variant == kF2Ring ? mode1_ring_kernel<T, true> : mode1_ring_kernel<T, false>;
    cudaError_t e = allow_smem(kernel, smem);
    int grid = 0;
    if (e == cudaSuccess) e = persistent_grid(kernel, kThreads, smem, (runs + G - 1) / G, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(xkv), static_cast<const T*>(wb),
        static_cast<const T*>(mask), static_cast<unsigned*>(ws),
        static_cast<T*>(ws) + counter_elems<T>(), static_cast<T*>(out), K, I, R, G, runs,
        per_run, ld);
    return cudaGetLastError();
  }
  const size_t RR = (size_t)R * R;
  int IT = I, E = (int)RR;
  if ((2 * (size_t)I * R + R + RR) * sizeof(T) > (size_t)kMaxDynamicSmem) {
    // half of the budget to the entries, the rest to tiles of rows
    E = (int)std::min(RR, (size_t)rows_that_fit<T>(0, 2));
    IT = std::min(I, rows_that_fit<T>((size_t)E + R, 2 * (size_t)R));
  }
  if (IT < 1 || E < 1) return cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)IT * R + R + E) * sizeof(T);
  auto kernel = IT < I || E < (int)RR ? mode1_chunked_kernel<T, true>
                                      : mode1_chunked_kernel<T, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<runs, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(xkv), static_cast<const T*>(wb),
      static_cast<const T*>(mask), static_cast<unsigned*>(ws),
      static_cast<T*>(ws) + counter_elems<T>(), static_cast<T*>(out), K, I, R, per_run, IT,
      E, ld);
  return cudaGetLastError();
}

}  // namespace

// Instantiate a launcher for (T, S): register tiles of 8, 16, 32 or 64
// entries of R, and the 64-wide tile looped over R above 64.
#define SPARTAN_BY_RANK(T, S, LAUNCH, ...)                                    \
  do {                                                                        \
    if (R <= 8) return (int)LAUNCH<T, S, 8, false>(__VA_ARGS__);              \
    if (R <= 16) return (int)LAUNCH<T, S, 16, false>(__VA_ARGS__);            \
    if (R <= 32) return (int)LAUNCH<T, S, 32, false>(__VA_ARGS__);            \
    if (R <= kTile) return (int)LAUNCH<T, S, kTile, false>(__VA_ARGS__);      \
    return (int)LAUNCH<T, S, kTile, true>(__VA_ARGS__);                       \
  } while (0)

// The streamed operands' code (the slab, and Vg for F1 and F4, which share
// it) picks (T, S): 0 (float, float), 1 (double, double), 2 (float,
// bfloat16), 3 (float, float16).
#define SPARTAN_DISPATCH(CODE, LAUNCH, ...)                                   \
  do {                                                                        \
    if (R < 1) return (int)cudaErrorInvalidValue;                             \
    switch (CODE) {                                                           \
      case 0: SPARTAN_BY_RANK(float, float, LAUNCH, __VA_ARGS__);             \
      case 1: SPARTAN_BY_RANK(double, double, LAUNCH, __VA_ARGS__);           \
      case 2: SPARTAN_BY_RANK(float, bf16, LAUNCH, __VA_ARGS__);              \
      case 3: SPARTAN_BY_RANK(float, f16, LAUNCH, __VA_ARGS__);               \
    }                                                                         \
    return (int)cudaErrorInvalidValue;                                        \
  } while (0)

extern "C" {

// dtypes: the dtype code of each streamed operand (0 float32, 1 float64,
// 2 bfloat16, 3 float16), packed as common.cuh's operand_code reads it:
// F1 and F4 stream the slab and Vg, which take one code; F3 the slab. With
// a half code every other operand and the outputs are float32; else they
// take the streamed operands' dtype. F2 takes one dtype code (0, 1) for all
// its operands. Returns a cudaError_t (0 = success); a combination not
// listed is cudaErrorInvalidValue, before any launch.

int spartan_fused_procrustes_b(int dtypes, const void* vals, const void* vg,
                               const void* wb, const void* h, void* xkv,
                               void* b, int K, int I, int C, int R,
                               void* stream) {
  const int code = operand_code(dtypes, 0);
  if (operand_code(dtypes, 1) != code) return (int)cudaErrorInvalidValue;
  SPARTAN_DISPATCH(code, launch_f1, vals, vg, wb, h, xkv, b, K, I, C, R,
                   static_cast<cudaStream_t>(stream));
}

// The variant a spartan_fused_procrustes_b launch takes (F1Variant: 0 ring,
// 1 ring with element copies, 2-5 row-warp, chunked, wide, wide chunked)
// for a slab of dtype code `dtype`; aligned: the slab starts on a 16-byte
// boundary. -1 for an unknown dtype.
int spartan_fused_procrustes_b_variant(int dtype, int I, int C, int R, int aligned) {
  if (R < 1 || I < 1 || C < 1) return -1;
  if (dtype == 0) return f1_variant<float, float>(I, C, R, aligned != 0);
  if (dtype == 1) return f1_variant<double, double>(I, C, R, aligned != 0);
  if (dtype == 2) return f1_variant<float, bf16>(I, C, R, aligned != 0);
  if (dtype == 3) return f1_variant<float, f16>(I, C, R, aligned != 0);
  return -1;
}

// F2, one launch. mask: [K] or null (no subject mask); ws:
// spartan_fused_mode1_workspace(dtype, K, R) elements of T, zeroed before
// its first launch (a launch leaves its counter 0).
int spartan_fused_mode1_xkv_one_launch(int dtype, const void* q, const void* xkv,
                                       const void* wb, const void* mask, void* ws, void* out,
                                       int K, int I, int R, void* stream) {
  if (K < 1 || I < 1 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f2<float>(q, xkv, wb, mask, ws, out, K, I, R, s);
  if (dtype == 1) return (int)launch_f2<double>(q, xkv, wb, mask, ws, out, K, I, R, s);
  return (int)cudaErrorInvalidValue;
}

// The variant a spartan_fused_mode1_xkv_one_launch launch takes (F2Variant:
// 0 ring, 1 ring with element copies, 2 chunked); aligned: Q and XkV start
// on a 16-byte boundary. -1 for an unknown dtype.
int spartan_fused_mode1_xkv_variant(int dtype, int I, int R, int aligned) {
  if (I < 1 || R < 1) return -1;
  if (dtype == 0) return f2_variant<float>(I, R, aligned != 0);
  if (dtype == 1) return f2_variant<double>(I, R, aligned != 0);
  return -1;
}

int spartan_fused_mode2_compact(int dtypes, const void* vals, const void* q,
                                const void* h, const void* wb, const void* cm,
                                void* out, int K, int I, int C, int R,
                                void* stream) {
  SPARTAN_DISPATCH(operand_code(dtypes, 0), launch_f3, vals, q, h, wb, cm, out, K, I, C, R,
                   static_cast<cudaStream_t>(stream));
}

int spartan_fused_ykv(int dtypes, const void* vals, const void* q,
                      const void* vg, void* out, int K, int I, int C, int R,
                      void* stream) {
  const int code = operand_code(dtypes, 0);
  if (operand_code(dtypes, 1) != code) return (int)cudaErrorInvalidValue;
  SPARTAN_DISPATCH(code, launch_f4, vals, q, vg, out, K, I, C, R,
                   static_cast<cudaStream_t>(stream));
}

// The elements of T of the workspace F2 takes for K subjects at rank R: one
// counter and the partials [R*R, ld] (one column per run); -1 for an
// unknown dtype, K < 1, R < 1 or a count past an int.
int spartan_fused_mode1_workspace(int dtype, int K, int R) {
  if (K < 1 || R < 1) return -1;
  if (dtype == 0) return reduction_workspace<float>(K, R);
  if (dtype == 1) return reduction_workspace<double>(K, R);
  return -1;
}

}  // extern "C"
