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
// H, w_k) in shared memory, and does the R-wide arithmetic in FMA units; the
// exception is F1 and F4 on a half slab, whose X_k Vg_k runs on the tensor
// cores (F4's note below). F1, F3 and F4 stream the slab through multi-stage
// cp.async rings in persistent blocks (F4's f32/f64 ring is F1's with
// another epilogue), and F2 its [I, R] operands (their notes below); shapes
// too large for a ring keep a block per subject.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py):
// every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success); F2 takes
// the caller's workspace (spartan_fused_mode1_workspace).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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
// half: per 2-byte load). Three designs, picked by shape and type
// (f1_variant):
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
// RING-MMA (a half slab and Vg, R <= 8, two stages fit): the FMA ring above
// gains nothing at half width (0.6745 ms at bf16, 46% of the half-width
// byte bound): its time goes to widening each value and R FMAs a value,
// not to bytes. This is F4's tensor-core ring (mma_ring_kernel, its note
// under F4) with a B epilogue in place of G's: X_k Vg_k on
// mma.sync.m16n8k16 with f32 accumulators, from the same stages (w_k in
// place of Q_k). A lane holds XkV at rows (g, g + 8) of its m-tile and
// columns (2q, 2q + 1); the four lanes of a quad gather a row's R <= 8
// values (two shuffles a column pair), and each lane forms B[i, l] =
// sum_r (XkV[i, r] w[r]) H[l, r] for its columns l, r in order (H in
// shared memory), as the FMA ring does. XkV and B go into a tile in shared
// memory (two, by the subject's parity) and, after the next subject's
// barrier, leave as 16-byte runs of the subject's contiguous [I*R] blocks
// (element stores where I*R is not whole packs): no barrier of their own.
// XkV is never read back. Only the order of X_k Vg_k's sums differs from
// the FMA ring's (products of half values are exact in f32). Paired on an
// H100 in a graph at the main path's largest bucket: bf16 0.6786 -> 0.3875
// ms (80% of the half-width byte bound), f16 0.6557 -> 0.3871; at the rsvd
// cores' 18 rows, bf16 0.4538 -> 0.1877, so it takes subjects of any rows.
//
// ROW-WARP (R > 64, or a subject too large for two stages): one block per
// subject: Vg_k (in CC-row chunks), H and w_k in shared memory, one warp per
// slab row, B formed from the row sums in registers. WIDE (R > 64): H and
// w_k are read from global memory and B sums the R chunks in place (each
// entry has one owning lane, so the sum is in a fixed order). The TPU
// kernel's block_c chunking (a VMEM budget) has no counterpart: a block
// reads its rows straight from device memory.
// ---------------------------------------------------------------------------
constexpr int kStages = 2;                 // F1's ring depth (subjects a block holds)
constexpr int kMaxStages = 8;              // F4's deepest ring

// cp.async.wait_group with a count known only at run time (0 .. 6)
__device__ inline void cp_async_wait_dyn(int pending) {
  switch (pending) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<0>();
  }
}
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

// What the ring does with a subject's rows of X_k Vg_k: F1 forms B (and
// writes XkV), F4 reduces them to G_k = Q_k^T (X_k Vg_k).
enum RingEpi { kEpiB = 0, kEpiG = 1 };

// F4's ring keeps G's partials in registers up to this R (one owner lane a
// row of G); above it the subject's X_k Vg_k rows go through shared memory.
constexpr int kOwnerR = 8;

// The fewest rows a subject for F3's ring and F4's FMA ring: one row tile of
// F4's ring (kRingWarps warps of kSlots rows). Below it a block's warps idle
// and the per-subject barriers and epilogue are not covered: at the rsvd
// cores' I = 18 (f32, R = 5, C = 128, K = 58,112, in a graph on an H100)
// the rings took 0.3082 (F3) and 0.4281 ms (F4) against 0.3032 and 0.4151
// for the one-block-a-subject designs, which such subjects keep; at I = 56
// the rings took 0.6745 and 0.6407 against 0.7435 and 1.0474.
constexpr int kRingMinRows = 32;

// The ring's shared-memory layout, in bytes (every part a whole number of
// 16-byte packs): per stage the slab [I, SP packs] and Vg_k [NP packs of
// c][RS][VEC] of S, then F1's w_k [R] or F4's Q_k [I, R] of T and, for a
// half S, Vg_k's raw run [C*R] as it arrives; after the stages, F1's H [R, R]
// of T, or F4's partials of G, [2][kRingWarps][R*R] of T (R <= kOwnerR), or
// its rows of X_k Vg_k, [I][R|1] of T (R > kOwnerR). VEC = 16 / sizeof(S)
// values a pack.
struct RingLayout {
  int vec, np, sp, rs;
  size_t slab, vg, w, raw, stage, smem_bytes;
};

template <typename T, typename S, int EPI>
__host__ __device__ inline RingLayout ring_layout(int I, int C, int R, int nst) {
  RingLayout s;
  s.vec = 16 / (int)sizeof(S);
  s.np = (C + s.vec - 1) / s.vec;          // 16-byte packs of a row
  // SP = 2 mod 8: the 4 rows x 2 packs that 8 lanes read at once hit
  // distinct banks; RS odd: the two groups' Vg packs do too
  s.sp = s.np + ((2 - s.np % 8) + 8) % 8;
  s.rs = R | 1;
  s.slab = (size_t)I * s.sp * 16;
  s.vg = (size_t)s.np * s.rs * 16;
  s.w = ((size_t)(EPI == kEpiB ? R : I * R) * sizeof(T) + 15) / 16 * 16;
  s.raw = s.slab + s.vg + s.w;
  s.stage = s.raw + (sizeof(S) == 2 ? ((size_t)C * R * sizeof(S) + 15) / 16 * 16 : 0);
  const size_t tail = EPI == kEpiB ? (size_t)R * R
                      : R <= kOwnerR ? (size_t)2 * kRingWarps * R * R : (size_t)I * (R | 1);
  s.smem_bytes = nst * s.stage + tail * sizeof(T);
  return s;
}

// Blocks of the ring an SM must hold: four at half width up to R = 8,
// whose eight-value packs took 101 registers a thread at R = 5, two blocks
// an SM (f32 takes 64 registers, and its 66 KB of stages hold three). In a
// graph on an H100 at bf16, R = 5: no bound 0.748 ms, three blocks 0.698,
// four (64 registers) 0.678. Wider tiles keep the compiler's count.
template <typename S, int RMAX>
constexpr int kRingMinBlocks = sizeof(S) == 2 && RMAX <= 8 ? 4 : 1;

// The ring of F1 (EPI kEpiB) and F4 (kEpiG): wq is F1's Wb [K, R] or F4's
// Q [K, I, R]; h (F1's H) and xkv (F1's XkV) are null for F4; out is F1's
// B [K, I, R] or F4's G [K, R, R].
template <typename T, typename S, int RMAX, bool ALIGNED, int EPI>
__global__ void __launch_bounds__(kRingThreads, kRingMinBlocks<S, RMAX>)
slab_ring_kernel(const S* __restrict__ vals, const S* __restrict__ vg,
                 const T* __restrict__ wq, const T* __restrict__ h,
                 T* __restrict__ xkv, T* __restrict__ out, int K, int I,
                 int C, int R, int nst) {
  constexpr int VEC = 16 / sizeof(S);
  constexpr int RPT = RMAX <= 16 ? 2 : 1;      // rows a lane owns per row tile
  constexpr int kTileRows = RPT * kRingWarps * kSlots;
  constexpr bool OWNERS = EPI == kEpiG && RMAX <= kOwnerR;   // G's partials in registers
  if constexpr (EPI == kEpiB) nst = kStages;   // F1: a ring depth known at compile time
  const RingLayout lay = ring_layout<T, S, EPI>(I, C, R, nst);
  const int NP = lay.np, SP = lay.sp, RS = lay.rs, RR = R * R;
  unsigned char* ring = smem_base<unsigned char>();
  T* h_s = reinterpret_cast<T*>(ring + nst * lay.stage);   // F1's H; F4's partials or rows
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid / kWarp, lane = tid % kWarp;
  const int q = lane / kSlots, slot = lane % kSlots;   // C group, row slot
  const int n_mine = K > (int)blockIdx.x ? (K - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  // a half Vg_k arrives as whole 16-byte packs in the raw area
  const bool vg16 = sizeof(S) == 2 && (C * R) % VEC == 0 &&
                    reinterpret_cast<uintptr_t>(vg) % 16 == 0;
  // F4's Q_k arrives as whole 16-byte packs
  constexpr int PT = 16 / sizeof(T);
  const bool q16 = EPI == kEpiG && (I * R) % PT == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 16 == 0;

  // pads that no copy writes: slab columns and Vg rows C .. NP*VEC - 1
  const int cpad = NP * VEC - C;
  for (int s = 0; s < nst; ++s) {
    S* st = reinterpret_cast<S*>(ring + s * lay.stage);
    S* vst = reinterpret_cast<S*>(ring + s * lay.stage + lay.slab);
    for (int t = tid; t < I * cpad; t += nthr)
      st[(t / cpad) * SP * VEC + C + t % cpad] = S(0.0f);
    for (int t = tid; t < cpad * R; t += nthr) {
      const int c = C + t / R, r = t % R;
      vst[((c / VEC) * RS + r) * VEC + c % VEC] = S(0.0f);
    }
  }
  if constexpr (EPI == kEpiB)
    for (int t = tid; t < R * R; t += nthr) h_s[t] = h[t];

  // copy subject k's slab, Vg_k and w_k (F1) or Q_k (F4) into the stage at `stb`
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
    if constexpr (EPI == kEpiB) {
      for (int u = tid; u < R; u += nthr)
        cp_async<sizeof(T)>(wdst + u, wq + k * R + u);
    } else if (q16) {
      for (int u = tid; u * PT < I * R; u += nthr)
        cp_async<16>(wdst + u * PT, wq + k * I * R + u * PT);
    } else {
      for (int u = tid; u < I * R; u += nthr)
        cp_async<sizeof(T)>(wdst + u, wq + k * I * R + u);
    }
  };
  auto subject = [&](int n) { return (int64_t)blockIdx.x + (int64_t)n * gridDim.x; };
  // F4, R <= kOwnerR: G of the block's n-th subject, summing the warps'
  // partials (buffer n % 2) in warp order, one thread an entry
  auto sum_partials = [&](int n) {
    const T* part = h_s + (n % 2) * kRingWarps * RR;
    for (int p = tid; p < RR; p += nthr) {
      T g = T(0);
      for (int w = 0; w < kRingWarps; ++w) g += part[w * RR + p];
      out[subject(n) * RR + p] = g;
    }
  };

  for (int s = 0; s < nst - 1; ++s) {
    if (s < n_mine) fetch(ring + s * lay.stage, subject(s));
    cp_async_commit();
  }
  for (int n = 0; n < n_mine; ++n) {         // block-uniform
    if constexpr (EPI == kEpiB)
      cp_async_wait<kStages - 2>();          // subject n's copies are in
    else
      cp_async_wait_dyn(nst - 2);
    __syncthreads();                         // everyone's; stage n-1 is read
    if constexpr (OWNERS)
      if (n > 0) sum_partials(n - 1);        // written before this barrier
    const int nn = n + nst - 1;
    if (nn < n_mine) fetch(ring + (nn % nst) * lay.stage, subject(nn));
    cp_async_commit();
    if (vg16) {                               // subject n's raw Vg_k into its packs
      unsigned char* sw = ring + (n % nst) * lay.stage;
      const S* raw = reinterpret_cast<const S*>(sw + lay.raw);
      S* vdst = reinterpret_cast<S*>(sw + lay.slab);
      Walk w = vg0;                           // (c, r) of Vg_k
      for (int u = tid; u < C * R; u += nthr, w.step())
        vdst[((w.row / VEC) * RS + w.col) * VEC + w.row % VEC] = raw[u];
      __syncthreads();                        // the packs are whole
    }

    const unsigned char* stb = ring + (n % nst) * lay.stage;
    const S* x_s = reinterpret_cast<const S*>(stb);
    const S* vg_s = reinterpret_cast<const S*>(stb + lay.slab);
    const T* w_s = reinterpret_cast<const T*>(stb + lay.slab + lay.vg);   // F1's w_k, F4's Q_k
    const int64_t k = subject(n);
    T gacc[OWNERS ? RMAX : 1];                // F4: row q of G, over this lane's rows
#pragma unroll
    for (int l = 0; l < (OWNERS ? RMAX : 1); ++l) gacc[l] = T(0);
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
      // F4: whether the tile's second row slot holds a row of the block (F1
      // computes it regardless, as it always has)
      const bool second = EPI == kEpiB || i0 + kRingWarps * kSlots < I;
      for (int p = q; p < NP; p += kGroups) {
        Pack<S> xp[RPT];
#pragma unroll
        for (int t = 0; t < RPT; ++t)
          if (t == 0 || second)
            xp[t] = load_pack(x_s + ((rows[t] < I ? rows[t] : 0) * SP + p) * VEC);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < R) {
            const Pack<S> vp = load_pack(vg_s + (p * RS + r) * VEC);
#pragma unroll
            for (int t = 0; t < RPT; ++t)
              if (t == 0 || second)
#pragma unroll
                for (int j = 0; j < VEC; ++j) acc[t][r] += widen(xp[t].v[j]) * widen(vp.v[j]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < RPT; ++t) {
        if (t > 0 && !second) break;          // block-uniform
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
          if constexpr (EPI == kEpiB) {
            const int64_t o = (k * I + rows[t]) * R;
            for (int l = q; l < R; l += kGroups) {   // B[i, l] = sum_r (XkV w)[r] H[l, r]
              T b = T(0);
#pragma unroll
              for (int r = 0; r < RMAX; ++r)
                if (r < R) b += (acc[t][r] * w_s[r]) * h_s[l * R + r];
              xkv[o + l] = pick<T, RMAX>(acc[t], l);
              out[o + l] = b;
            }
          } else if constexpr (OWNERS) {
            if (q < R) {                      // G[q, l] += Q[i, q] * XkV[i, l]
              const T qv = w_s[rows[t] * R + q];
#pragma unroll
              for (int l = 0; l < RMAX; ++l)
                if (l < R) gacc[l] += qv * acc[t][l];
            }
          } else {                            // the row into shared memory
            for (int l = q; l < R; l += kGroups)
              h_s[rows[t] * RS + l] = pick<T, RMAX>(acc[t], l);
          }
        }
      }
    }
    if constexpr (OWNERS) {
      // the kSlots row slots of a warp in a fixed order, then the warps'
      // partials into buffer n % 2, summed after the next barrier
#pragma unroll
      for (int l = 0; l < RMAX; ++l) {
        gacc[l] += __shfl_xor_sync(0xffffffffu, gacc[l], 1);
        gacc[l] += __shfl_xor_sync(0xffffffffu, gacc[l], 2);
      }
      if (slot == 0 && q < R) {
        T* part = h_s + (n % 2) * kRingWarps * RR + warp * RR + q * R;
#pragma unroll
        for (int l = 0; l < RMAX; ++l)
          if (l < R) part[l] = gacc[l];
      }
    } else if constexpr (EPI == kEpiG) {
      // G[r, l] = sum_i Q[i, r] XkV[i, l], i in order, one thread an entry;
      // stage n is refilled only after the next barrier
      __syncthreads();
      for (int p = tid; p < RR; p += nthr) {
        const int r = p / R, l = p - r * R;
        T g = T(0);
        for (int i = 0; i < I; ++i) g += w_s[i * R + r] * h_s[i * RS + l];
        out[k * RR + p] = g;
      }
    }
  }
  cp_async_wait<0>();                        // leave no copy in flight
  if constexpr (OWNERS) {
    __syncthreads();                         // the last subject's partials
    if (n_mine > 0) sum_partials(n_mine - 1);
  }
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
// fused_mode2_compact (pallas_call at :284, body _mode2_kernel at :229):
// A[k, c, :] = ((X_k[:, c]^T Q_k) H) * w_k * col_mask[k, c], the second
// pass over the slab; Y_k is never written. Bound: the slab bytes (R = 5,
// f32: 10 operations per 4-byte load; half: per 2-byte load). Padded
// columns and masked subjects write zeros. Every variant keeps one order: a
// column's y[r] = sum_i X[i, c] Q[i, r] over i in order, then a = sum_r
// y[r] H[r, l] over r in order, then (a * w[l]) * col_mask[c] (WIDE: per
// 64-wide chunk of r, the chunks' products added in place). Two designs,
// picked by shape (f3_variant):
//
// RING, the main path (R <= 64, at least kRingMinRows rows a subject, and
// two stages fit in shared memory). What held the thread-per-column design
// below at 75% of the bound in f32 and 48% at half width: one block per
// subject reading its slab straight from device memory, one 4-byte (2-byte)
// load a thread a row, so half width halved the bytes in flight, a serial
// prologue staging Q_k before the first slab load, and 5-float output rows
// stored at a 20-byte stride. Here persistent blocks walk over groups of G
// consecutive subjects through a ring of kF3Stages shared-memory stages:
// while a block computes group n, cp.async copies the slabs, Q_k, w_k and
// col_mask rows of group n+1 into the next stage (16 bytes a copy where the
// slab's rows are whole 16-byte runs; RING-ELEMENT-COPIES, one element a
// copy, otherwise), so the bytes in flight no longer depend on the width
// of a value. A thread owns one column of a subject (TPS = min(C,
// kF3MaxThreads) threads a subject, looping over the columns past that)
// and sums it over every row of the stage, in chunks of kF3Chunk entries of
// R (a chunk's y in registers; the next chunk carries `a` through the
// output tile, so the order is the unchunked one). Q_k's rows are staged
// padded to whole 16-byte packs and read as 16-byte broadcasts: two loads
// a row at R = 5 in f32 instead of five, whose shared-memory wavefronts
// otherwise outnumber the slab's. The epilogue (y H) * w_k * col_mask runs
// from registers into an output tile [G][C][R] in shared memory, which the
// block stores as one contiguous run of 16-byte stores (A of G consecutive
// subjects). G is the most that keeps the block within kF3MaxThreads and
// the ring within kF3Budget, so that three blocks share an SM. Arithmetic
// is FMA in f32 / f64 (Q is f32): the order above is the thread-per-column
// kernel's, so the two give the same bits. Paired on an H100 in a graph at
// the main path's largest bucket (f32 / bf16 ms; parent 0.7423 / 0.6641):
// a thread a 16-byte pack of columns, one warp a subject, 1.0111 / 1.4325
// (the row loop's latency, three warps an SM); a thread a column with
// scalar Q reads, 0.7669 / 0.6456; at most 128 threads a block, 0.7330 /
// 0.6452; with 16-byte Q reads, 0.6745 / 0.5550.
//
// THREAD-PER-COLUMN (R > 64, a subject too large for the ring, or one of
// fewer than kRingMinRows rows): one
// block per subject, one thread per kept column (loads along C coalesced
// across the warp), Q_k (in IC-row chunks), H and w_k in shared memory, the
// R-wide column of Y_k in registers. WIDE (R > 64): H and w_k from global
// memory, and each output row sums the R chunks in place (one owning
// thread). A half slab (S) is read at 2 bytes a value and widened.
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

constexpr int kF3Stages = 2;
constexpr int kF3MaxThreads = 128;
constexpr int kF3Chunk = 8;                  // entries of R a thread sums at once
constexpr int kF3Budget = kMaxDynamicSmem / 3;   // three ring blocks an SM

// F3's ring layout, in bytes (every part a whole number of 16-byte packs):
// per stage, G subjects, each its slab [I, NP packs] of S, Q_k [I, RQ]
// (rows padded to whole 16-byte packs, so a thread reads a row's chunk of R
// with 16-byte broadcasts), w_k [R] and col_mask[k] [C] of T; after the
// stages H [R, R] and the output tile [G, C, R] of T. TPS: the threads a
// subject (one a column, at most kF3MaxThreads, which then loop over the
// columns).
struct F3Layout {
  int vec, np, rq, tps, threads;
  size_t slab, q, w, cm, subject, stage, h, tile, smem_bytes;
};

template <typename T, typename S>
__host__ __device__ inline F3Layout f3_layout(int I, int C, int R, int G) {
  auto packs = [](size_t bytes) { return (bytes + 15) / 16 * 16; };
  F3Layout s;
  s.vec = 16 / (int)sizeof(S);
  s.np = (C + s.vec - 1) / s.vec;
  s.rq = (R + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T)) * (16 / (int)sizeof(T));
  s.tps = C < kF3MaxThreads ? C : kF3MaxThreads;
  s.threads = (G * s.tps + kWarp - 1) / kWarp * kWarp;
  s.slab = (size_t)I * s.np * 16;
  s.q = s.slab + packs((size_t)I * s.rq * sizeof(T));
  s.w = s.q + packs((size_t)R * sizeof(T));
  s.cm = s.w + packs((size_t)C * sizeof(T));
  s.subject = s.cm;
  s.stage = (size_t)G * s.subject;
  s.h = kF3Stages * s.stage;
  s.tile = s.h + packs((size_t)R * R * sizeof(T));
  s.smem_bytes = s.tile + packs((size_t)G * C * R * sizeof(T));
  return s;
}

// Subjects a stage: the most of 8, 4, 2, 1 whose threads fit a block and
// whose ring fits kF3Budget, else 1 if its ring fits the most a block may
// use; 0 where the ring does not apply (R > 64, fewer than kRingMinRows
// rows, or not even one subject fits).
template <typename T, typename S>
int f3_group(int I, int C, int R) {
  if (R > kTile || I < kRingMinRows) return 0;
  for (int g = 8; g >= 1; g /= 2) {
    const F3Layout lay = f3_layout<T, S>(I, C, R, g);
    if (g * lay.tps <= kF3MaxThreads && lay.smem_bytes <= (size_t)kF3Budget) return g;
  }
  return f3_layout<T, S>(I, C, R, 1).smem_bytes <= (size_t)kMaxDynamicSmem ? 1 : 0;
}

template <typename T, typename S, bool ALIGNED>
__global__ void __launch_bounds__(kF3MaxThreads)
mode2_ring_kernel(const S* __restrict__ vals, const T* __restrict__ q,
                  const T* __restrict__ h, const T* __restrict__ wb,
                  const T* __restrict__ col_mask, T* __restrict__ out, int K,
                  int I, int C, int R, int G) {
  constexpr int VEC = 16 / sizeof(S), PT = 16 / sizeof(T);
  const F3Layout lay = f3_layout<T, S>(I, C, R, G);
  const int NP = lay.np, TPS = lay.tps, RS = NP * VEC, RQ = lay.rq;   // row strides
  unsigned char* ring = smem_base<unsigned char>();
  T* h_s = reinterpret_cast<T*>(ring + lay.h);
  T* tile = reinterpret_cast<T*>(ring + lay.tile);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int mine = tid / TPS, c0 = tid - mine * TPS;   // the thread's subject of a group, column
  const int64_t n_groups = ((int64_t)K + G - 1) / G;
  const int n_mine = n_groups > blockIdx.x
      ? (int)((n_groups - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  const bool q16 = R % PT == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;   // RQ == R
  const bool cm16 = C % PT == 0 && reinterpret_cast<uintptr_t>(col_mask) % 16 == 0;
  const bool out16 = (C * R) % PT == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int t = tid; t < R * R; t += nthr) h_s[t] = h[t];

  auto group = [&](int n) { return (int64_t)blockIdx.x + (int64_t)n * gridDim.x; };
  // copy group g's slabs, Q_k, w_k and col_mask rows into the stage at `stb`
  auto fetch = [&](unsigned char* stb, int64_t g) {
    const int64_t k0 = g * G;
    const int ng = (int)(K - k0 < G ? K - k0 : G);
    for (int s = 0; s < ng; ++s) {
      const int64_t k = k0 + s;
      unsigned char* sb = stb + s * lay.subject;
      S* st = reinterpret_cast<S*>(sb);
      const S* src = vals + k * I * C;
      if constexpr (ALIGNED) {                // rows are whole 16-byte runs
        for (int u = tid; u < I * NP; u += nthr)
          cp_async<16>(st + u * VEC, src + (int64_t)u * VEC);
      } else {
        Walk w(tid, nthr, C);
        for (int u = tid; u < I * C; u += nthr, w.step())
          copy_elem(st + w.row * NP * VEC + w.col, src + u);
      }
      T* qd = reinterpret_cast<T*>(sb + lay.slab);
      if (q16) {
        for (int u = tid; u * PT < I * R; u += nthr)
          cp_async<16>(qd + u * PT, q + k * I * R + u * PT);
      } else {
        Walk w(tid, nthr, R);                 // (i, r) of Q_k, into rows of RQ
        for (int u = tid; u < I * R; u += nthr, w.step())
          cp_async<sizeof(T)>(qd + w.row * RQ + w.col, q + k * I * R + u);
      }
      T* wd = reinterpret_cast<T*>(sb + lay.q);
      for (int u = tid; u < R; u += nthr) cp_async<sizeof(T)>(wd + u, wb + k * R + u);
      T* cd = reinterpret_cast<T*>(sb + lay.w);
      if (cm16) {
        for (int u = tid; u * PT < C; u += nthr)
          cp_async<16>(cd + u * PT, col_mask + k * C + u * PT);
      } else {
        for (int u = tid; u < C; u += nthr) cp_async<sizeof(T)>(cd + u, col_mask + k * C + u);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kF3Stages - 1; ++s) {
    if (s < n_mine) fetch(ring + s * lay.stage, group(s));
    cp_async_commit();
  }
  for (int n = 0; n < n_mine; ++n) {         // block-uniform
    cp_async_wait<kF3Stages - 2>();         // group n's copies are in
    __syncthreads();                         // everyone's; stage n-1 is read, the tile stored
    const int nn = n + kF3Stages - 1;
    if (nn < n_mine) fetch(ring + (nn % kF3Stages) * lay.stage, group(nn));
    cp_async_commit();

    const int64_t k0 = group(n) * G;
    const int ng = (int)(K - k0 < G ? K - k0 : G);
    if (mine < ng) {
      const unsigned char* sb = ring + (n % kF3Stages) * lay.stage + mine * lay.subject;
      const S* x_s = reinterpret_cast<const S*>(sb);
      const T* q_s = reinterpret_cast<const T*>(sb + lay.slab);
      const T* w_s = reinterpret_cast<const T*>(sb + lay.q);
      const T* cm_s = reinterpret_cast<const T*>(sb + lay.w);
      T* trow = tile + (size_t)mine * C * R;
      for (int c = c0; c < C; c += TPS) {
        for (int r0 = 0; r0 < R; r0 += kF3Chunk) {
          const int RW = min(kF3Chunk, R - r0);
          T y[kF3Chunk];
#pragma unroll
          for (int r = 0; r < kF3Chunk; ++r) y[r] = T(0);
#pragma unroll 4
          for (int i = 0; i < I; ++i) {
            const T v = widen(x_s[i * RS + c]);
            T qv[kF3Chunk];                   // Q[i, r0 : r0 + 8], 16-byte broadcasts
#pragma unroll
            for (int u = 0; u < kF3Chunk / PT; ++u) {
              if (u * PT < RW) {
                const Pack<T> pk = load_pack(q_s + i * RQ + r0 + u * PT);
#pragma unroll
                for (int j = 0; j < PT; ++j) qv[u * PT + j] = pk.v[j];
              }
            }
#pragma unroll
            for (int r = 0; r < kF3Chunk; ++r)
              if (r < RW) y[r] += v * qv[r];
          }
          const bool last = r0 + kF3Chunk >= R;
          for (int l = 0; l < R; ++l) {
            T a = r0 == 0 ? T(0) : trow[c * R + l];
#pragma unroll
            for (int r = 0; r < kF3Chunk; ++r)
              if (r < RW) a += y[r] * h_s[(r0 + r) * R + l];
            trow[c * R + l] = last ? a * w_s[l] * cm_s[c] : a;
          }
        }
      }
    }
    __syncthreads();                         // the tile is whole
    T* dst = out + k0 * C * R;               // A of the group's subjects, contiguous
    const int n_out = ng * C * R;
    if (out16) {
      for (int t = tid; t * PT < n_out; t += nthr)
        reinterpret_cast<int4*>(dst)[t] = reinterpret_cast<const int4*>(tile)[t];
    } else {
      for (int t = tid; t < n_out; t += nthr) dst[t] = tile[t];
    }
  }
  cp_async_wait<0>();                        // leave no copy in flight
}

// ---------------------------------------------------------------------------
// F4 fused_ykv. Replaces src/repro/kernels/fused.py fused_ykv (pallas_call
// at :357, body _ykv_kernel at :309): G_k = Q_k^T X_k Vg_k [R, R], the third
// pass over the slab; it feeds the mode-3 coldot and the fit. Bound: the
// slab bytes (R = 5, f32: 10 operations per 4-byte load; half: per 2-byte
// load). Three designs, picked by shape and type (f4_variant):
//
// RING (R <= 64, at least kRingMinRows rows a subject and two subjects'
// stages fit in shared memory; at half width only past R = 8): F1's ring
// (slab_ring_kernel, EPI kEpiG), whose X_k Vg_k is exactly F1's XkV, with
// Q_k in each stage in place of w_k. What held the row-warp design below
// at 53% of the bound in f32 (28% at half width) is what held F1's own
// row-warp design: one block per subject, a serial prologue
// staging Vg_k and Q_k before the first slab load, 4-byte (2-byte) lane
// loads, a chain of R warp sums after every row before the warp's next
// row, and a tail in which R*R of 128 threads each summed I products with
// no slab byte in flight. Here the epilogue is the G reduction: up to R =
// kOwnerR the lanes q < R of a row (which all hold the row's XkV after the
// fixed-order reduction) each accumulate row q of the outer product Q[i,
// q] XkV[i, :] in registers over the lane's rows; at the subject's end the
// four row slots of a warp add in a fixed order (two shuffles), each warp
// puts its partial in shared memory (two buffers, by the subject's parity),
// and after the next subject's barrier one thread an entry adds the eight
// warps' partials in warp order: no barrier of its own, no atomics. Past
// kOwnerR the rows of X_k Vg_k go into shared memory and, after one more
// barrier, one thread an entry sums Q_k^T XkV over the rows in order. Q_k
// arrives by 16-byte copies where its [I, R] tile is whole packs, else one
// element a copy. RING-ELEMENT-COPIES as F1's. F4's ring depth is chosen at
// run time (f4_stages: as many stages as let three blocks share an SM), and
// a row tile's second slot is skipped where it holds no row. Paired on an
// H100 in a graph at the main path's largest bucket, f32: parent 1.0474 ms,
// this ring 0.6407 (88% of the byte bound).
//
// RING-MMA (a half slab and Vg, R <= 8, two stages fit; mma_ring_kernel,
// which F1's RING-MMA shares with another epilogue): X_k Vg_k on the
// tensor cores, mma.sync.m16n8k16 (bf16 or f16 in, f32 accumulators). F1's
// FMA ring gains nothing at half width (0.6745 ms at bf16 against 0.6610
// in f32 at the main path's largest bucket, in a graph on an H100): its
// time goes to the per-subject work of the widening and R FMAs a value,
// not to bytes. Persistent blocks of kMmaThreads walk over the subjects
// through kMmaStages cp.async stages, each the slab [I rounded to 16, SPM
// packs] (SPM odd, so ldmatrix's eight rows hit distinct banks), Vg_k as
// its raw run [C, R] and Q_k [I, R] of float. Warp w takes the 16-row
// m-tiles w, w + kMmaWarps, ...; for each 16-wide k-step it loads A (16
// rows x 16 columns) with one ldmatrix.x4 and B (Vg_k's 16 rows, R padded
// to 8 columns with zeros, rows past C zeros) from the raw run, and issues
// one mma. The pads of the slab (columns C .. C rounded to 16, rows I ..
// I rounded to 16) are zeroed once a block and no copy writes them, so no
// stale byte enters a product, and rows past I are left out of G. The G
// epilogue runs from the accumulator fragments: a lane holds XkV at rows
// (g, g + 8) of the tile and columns (2q, 2q + 1), and accumulates G[r,
// 2q + e] over those rows for every r (Q_k from shared memory, f32); at
// the subject's end the eight lane groups add in a fixed order (three
// shuffles), and the warps' partials are added in warp order after the
// next barrier, as in RING. Products of half values are exact in f32, so
// only the order of the sums differs from the FMA designs; the f32 path
// stays on FMA, since TF32 would break the 1e-6 f32 parity. Paired on an
// H100 in a graph at the main path's largest bucket, bf16: parent 1.0351
// ms, this ring 0.3501 (83% of the half-width byte bound); f16 0.3495.
//
// ROW-WARP (R > 64, a subject too large for the ring, or one of fewer than
// kRingMinRows rows): one block per subject: the slab rows go through X_k
// Vg_k exactly as in F1's row-warp
// design (one warp per row, Vg_k in CC-row chunks), the [IT, R] products
// of a tile of rows stay in shared memory beside that tile of Q_k, and one
// thread per (r, l) entry reduces Q_k^T (X_k Vg_k) over the tile's rows in
// a fixed order, adding the tiles and the 64-wide chunks of l in place (one
// owning thread per entry). A half slab and Vg (S) are read at 2 bytes a
// value; Vg_k is staged widened.
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

constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / kWarp;
constexpr int kMmaStages = 2;
constexpr int kMmaMinBlocks = 4;

// RING-MMA's shared-memory layout, in bytes (every part a whole number of
// 16-byte packs): per stage the slab [I16 rows][SPM packs] of S, Vg_k's
// raw run [C * R] of S, and F4's Q_k [I, R] or F1's w_k [R] of float;
// after the stages F4's partials of G, [2][kMmaWarps][R*R] of float, or
// F1's H [R*R] (rounded to whole packs) and its output tiles, [2][2][I*R]
// of float (XkV_k and B_k, by the subject's parity). I16 and C16: I and C
// rounded up to 16 (an m-tile's rows, a k-step's columns).
struct MmaLayout {
  int np, spm, i16, c16;
  size_t slab, vg, stage, tiles, smem_bytes;
};

template <int EPI>
__host__ __device__ inline MmaLayout mma_layout(int I, int C, int R) {
  MmaLayout s;
  s.np = (C + 7) / 8;                       // 16-byte packs of a row's data
  s.i16 = (I + 15) / 16 * 16;
  s.c16 = (C + 15) / 16 * 16;
  s.spm = s.c16 / 8 + 1;                    // odd
  s.slab = (size_t)s.i16 * s.spm * 16;
  s.vg = s.slab + ((size_t)C * R * 2 + 15) / 16 * 16;
  s.stage = s.vg + ((size_t)(EPI == kEpiB ? R : I * R) * sizeof(float) + 15) / 16 * 16;
  s.tiles = kMmaStages * s.stage + ((size_t)R * R * sizeof(float) + 15) / 16 * 16;
  s.smem_bytes = EPI == kEpiB
                     ? s.tiles + (size_t)4 * I * R * sizeof(float)
                     : kMmaStages * s.stage + (size_t)2 * kMmaWarps * R * R * sizeof(float);
  return s;
}

// D += A B for one m16n8k16 tile: A row-major 16 x 16, B "col" 16 x 8, half
// operands, f32 accumulators (the PTX ISA's fragment layouts).
template <typename S>
__device__ inline void mma_16816(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  if constexpr (std::is_same<S, bf16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// Four 8x8 matrices of 16-bit values from shared memory: lane L gives the
// address of row L % 8 of matrix L / 8; the lane gets row L / 4, columns
// 2 (L % 4) and 2 (L % 4) + 1 of each matrix.
__device__ inline void ldmatrix_x4(unsigned (&a)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

// The tensor-core ring of F1 (EPI kEpiB) and F4 (kEpiG): wq is F1's Wb
// [K, R] or F4's Q [K, I, R]; h (F1's H) and xkv (F1's XkV) are null for
// F4; out is F1's B [K, I, R] or F4's G [K, R, R].
template <typename S, bool ALIGNED, int EPI>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
mma_ring_kernel(const S* __restrict__ vals, const S* __restrict__ vg,
                const float* __restrict__ wq, const float* __restrict__ h,
                float* __restrict__ xkv, float* __restrict__ out, int K, int I,
                int C, int R) {
  constexpr int VEC = 8;                     // half values a pack
  const MmaLayout lay = mma_layout<EPI>(I, C, R);
  const int NP = lay.np, SPV = lay.spm * VEC, RR = R * R, IR = I * R;
  const int MT = lay.i16 / 16, KS = lay.c16 / 16;
  unsigned char* ring = smem_base<unsigned char>();
  float* part_s = reinterpret_cast<float*>(ring + kMmaStages * lay.stage);   // F4; F1's H
  float* tile_s = reinterpret_cast<float*>(ring + lay.tiles);                // F1
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, qd = lane & 3;    // the fragments' row group and column pair
  const int n_mine = K > (int)blockIdx.x ? (K - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const bool vg16 = (C * R) % VEC == 0 && reinterpret_cast<uintptr_t>(vg) % 16 == 0;
  const bool q16 = EPI == kEpiG && IR % 4 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  // F1's tiles leave as 16-byte runs where a subject's [I*R] block is whole packs
  const bool o16 = EPI == kEpiB && IR % 4 == 0 && reinterpret_cast<uintptr_t>(xkv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;

  // pads that no copy writes: columns C .. C16 - 1 of every row, rows I .. I16 - 1
  for (int s = 0; s < kMmaStages; ++s) {
    S* st = reinterpret_cast<S*>(ring + s * lay.stage);
    for (int t = tid; t < lay.i16 * lay.c16; t += nthr) {
      const int row = t / lay.c16, col = t - row * lay.c16;
      if (row >= I || col >= C) st[row * SPV + col] = S(0.0f);
    }
  }
  if constexpr (EPI == kEpiB)
    for (int t = tid; t < RR; t += nthr) part_s[t] = h[t];

  // copy subject k's slab, Vg_k and Q_k (F4) or w_k (F1) into the stage at `stb`
  const Walk slab0(tid, nthr, ALIGNED ? NP : C);
  auto fetch = [&](unsigned char* stb, int64_t k) {
    S* st = reinterpret_cast<S*>(stb);
    const S* src = vals + k * I * C;
    Walk w = slab0;
    if constexpr (ALIGNED) {                  // rows are whole 16-byte runs
      for (int u = tid; u < I * NP; u += nthr, w.step())
        cp_async<16>(st + w.row * SPV + w.col * VEC, src + (int64_t)u * VEC);
    } else {
      for (int u = tid; u < I * C; u += nthr, w.step())
        copy_elem(st + w.row * SPV + w.col, src + u);
    }
    S* vd = reinterpret_cast<S*>(stb + lay.slab);
    const S* vsrc = vg + k * C * R;
    if (vg16) {
      for (int u = tid; u * VEC < C * R; u += nthr) cp_async<16>(vd + u * VEC, vsrc + u * VEC);
    } else {
      for (int u = tid; u < C * R; u += nthr) copy_elem(vd + u, vsrc + u);
    }
    float* qdst = reinterpret_cast<float*>(stb + lay.vg);
    if constexpr (EPI == kEpiB) {
      for (int u = tid; u < R; u += nthr) cp_async<4>(qdst + u, wq + k * R + u);
    } else {
      const float* qsrc = wq + k * IR;
      if (q16) {
        for (int u = tid; u * 4 < IR; u += nthr) cp_async<16>(qdst + u * 4, qsrc + u * 4);
      } else {
        for (int u = tid; u < IR; u += nthr) cp_async<4>(qdst + u, qsrc + u);
      }
    }
  };
  auto subject = [&](int n) { return (int64_t)blockIdx.x + (int64_t)n * gridDim.x; };
  // F4: G of the block's n-th subject, the warps' partials (buffer n % 2)
  // in warp order, one thread an entry
  auto sum_partials = [&](int n) {
    const float* part = part_s + (n % 2) * kMmaWarps * RR;
    for (int p = tid; p < RR; p += nthr) {
      float v = 0.0f;
      for (int w = 0; w < kMmaWarps; ++w) v += part[w * RR + p];
      out[subject(n) * RR + p] = v;
    }
  };
  // F1: XkV_k and B_k of the block's n-th subject from tile n % 2 to their
  // contiguous [I*R] blocks
  auto drain_tiles = [&](int n) {
    const float* t = tile_s + (n % 2) * 2 * IR;
    const int64_t o = subject(n) * IR;
    if (o16) {
      for (int u = tid; u < IR / 2; u += nthr) {     // IR / 4 packs an array, two arrays
        const int a = u / (IR / 4), p = u - a * (IR / 4);
        const float4 v = reinterpret_cast<const float4*>(t + a * IR)[p];
        reinterpret_cast<float4*>((a ? out : xkv) + o)[p] = v;
      }
    } else {
      for (int u = tid; u < 2 * IR; u += nthr) {
        const int a = u >= IR, p = u - a * IR;
        ((a ? out : xkv) + o)[p] = t[u];
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < n_mine) fetch(ring + s * lay.stage, subject(s));
    cp_async_commit();
  }
  for (int n = 0; n < n_mine; ++n) {         // block-uniform
    cp_async_wait<kMmaStages - 2>();        // subject n's copies are in
    __syncthreads();                         // everyone's; stage n-1 is read
    if constexpr (EPI == kEpiG)
      if (n > 0) sum_partials(n - 1);
    const int nn = n + kMmaStages - 1;
    if (nn < n_mine) fetch(ring + (nn % kMmaStages) * lay.stage, subject(nn));
    cp_async_commit();
    if constexpr (EPI == kEpiB)
      if (n > 0) drain_tiles(n - 1);         // written before this barrier

    const unsigned char* stb = ring + (n % kMmaStages) * lay.stage;
    const S* x_s = reinterpret_cast<const S*>(stb);
    const unsigned short* vr = reinterpret_cast<const unsigned short*>(stb + lay.slab);
    const float* q_s = reinterpret_cast<const float*>(stb + lay.vg);   // F4's Q_k, F1's w_k
    // Vg_k[c, n] as 16 bits, zero past C and past R
    auto vbits = [&](int c, int col) -> unsigned {
      return c < C && col < R ? (unsigned)vr[c * R + col] : 0u;
    };
    float gacc[kOwnerR][2];                  // F4: G[r, 2 qd + e] over this lane's rows
#pragma unroll
    for (int r = 0; r < kOwnerR; ++r) gacc[r][0] = gacc[r][1] = 0.0f;
    for (int mt = warp; mt < MT; mt += kMmaWarps) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const S* arow = x_s + (mt * 16 + (lane & 15)) * SPV + (lane >> 4) * 8;
      for (int ks = 0; ks < KS; ++ks) {
        const int c0 = ks * 16 + 2 * qd;
        const unsigned b[2] = {vbits(c0, g) | (vbits(c0 + 1, g) << 16),
                               vbits(c0 + 8, g) | (vbits(c0 + 9, g) << 16)};
        unsigned a[4];
        ldmatrix_x4(a, arow + ks * 16);
        mma_16816<S>(d, a, b);
      }
      const int ia = mt * 16 + g, ib = ia + 8;
      if constexpr (EPI == kEpiB) {
        // the quad's four lanes hold columns (0, 1), (2, 3), (4, 5), (6, 7)
        // of rows ia and ib: each lane gathers the rows' R values (two
        // shuffles a column pair and row pair), then forms B[i, l] = sum_r
        // (XkV[i, r] w[r]) H[l, r], r in order, for its columns l
        float xa[kOwnerR], xb[kOwnerR];
#pragma unroll
        for (int j = 0; j < kOwnerR / 2; ++j) {
          const int src = (lane & ~3) | j;
          xa[2 * j] = xa[2 * j + 1] = xb[2 * j] = xb[2 * j + 1] = 0.0f;
          if (2 * j < R) {                   // warp-uniform
            xa[2 * j] = __shfl_sync(0xffffffffu, d[0], src);
            xa[2 * j + 1] = __shfl_sync(0xffffffffu, d[1], src);
            xb[2 * j] = __shfl_sync(0xffffffffu, d[2], src);
            xb[2 * j + 1] = __shfl_sync(0xffffffffu, d[3], src);
          }
        }
        float* t = tile_s + (n % 2) * 2 * IR;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int l = 2 * qd + e;
          if (l < R) {
            float ba = 0.0f, bb = 0.0f;
#pragma unroll
            for (int r = 0; r < kOwnerR; ++r)
              if (r < R) {
                const float hw = part_s[l * R + r];
                ba += (xa[r] * q_s[r]) * hw;
                bb += (xb[r] * q_s[r]) * hw;
              }
            if (ia < I) { t[ia * R + l] = d[e]; t[IR + ia * R + l] = ba; }
            if (ib < I) { t[ib * R + l] = d[2 + e]; t[IR + ib * R + l] = bb; }
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < kOwnerR; ++r) {
          if (r < R) {
            if (ia < I) {
              const float qa = q_s[ia * R + r];
              gacc[r][0] += qa * d[0];
              gacc[r][1] += qa * d[1];
            }
            if (ib < I) {
              const float qb = q_s[ib * R + r];
              gacc[r][0] += qb * d[2];
              gacc[r][1] += qb * d[3];
            }
          }
        }
      }
    }
    if constexpr (EPI == kEpiG) {
      // the eight row groups of a warp in a fixed order, then the warp's
      // partial into buffer n % 2, summed after the next barrier
#pragma unroll
      for (int r = 0; r < kOwnerR; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < kWarp; off <<= 1)
            gacc[r][e] += __shfl_xor_sync(0xffffffffu, gacc[r][e], off);
      if (g == 0) {
        float* part = part_s + (n % 2) * kMmaWarps * RR + warp * RR;
#pragma unroll
        for (int r = 0; r < kOwnerR; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (r < R && 2 * qd + e < R) part[r * R + 2 * qd + e] = gacc[r][e];
      }
    }
  }
  cp_async_wait<0>();                        // leave no copy in flight
  __syncthreads();                           // the last subject's partials or tiles
  if (n_mine > 0) {
    if constexpr (EPI == kEpiG) sum_partials(n_mine - 1);
    else drain_tiles(n_mine - 1);
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

// F1's variants, as spartan_fused_procrustes_b_variant reports them (F4's
// too): the FMA ring, the row-warp designs, the tensor-core ring.
enum F1Variant { kRing = 0, kRingElementCopies = 1, kRowWarp = 2, kRowWarpChunked = 3,
                 kRowWarpWide = 4, kRowWarpWideChunked = 5, kRingMma = 6,
                 kRingMmaElementCopies = 7 };

// The Vg_k rows the row-warp variant stages at a time.
template <typename T>
int f1_rows_per_chunk(int C, int R, bool wide, int rmax) {
  const size_t fixed = wide ? 0 : (size_t)R * R + R;
  return std::min(C, rows_that_fit<T>(fixed, row_stride(wide ? rmax : R)));
}

// RING-MMA for a half slab and Vg at R <= 8 where its stages fit; else RING
// where its stages fit and R <= 64; else ROW-WARP. 16-byte copies when every
// slab row starts on a 16-byte boundary, else element copies.
template <typename T, typename S>
int f1_variant(int I, int C, int R, bool aligned) {
  const bool whole = aligned && C % (16 / (int)sizeof(S)) == 0;
  if (sizeof(S) == 2 && R <= kOwnerR &&
      mma_layout<kEpiB>(I, C, R).smem_bytes <= (size_t)kMaxDynamicSmem)
    return whole ? kRingMma : kRingMmaElementCopies;
  if (R <= kTile &&
      ring_layout<T, S, kEpiB>(I, C, R, kStages).smem_bytes <= (size_t)kMaxDynamicSmem)
    return whole ? kRing : kRingElementCopies;
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
  if (variant == kRingMma || variant == kRingMmaElementCopies) {
    if constexpr (sizeof(S) == 2 && RMAX <= kOwnerR) {
      const size_t smem = mma_layout<kEpiB>(I, C, R).smem_bytes;
      auto kernel = variant == kRingMma ? mma_ring_kernel<S, true, kEpiB>
                                        : mma_ring_kernel<S, false, kEpiB>;
      cudaError_t e = allow_smem(kernel, smem);
      int grid = 0;
      if (e == cudaSuccess) e = persistent_grid(kernel, kMmaThreads, smem, K, &grid);
      if (e != cudaSuccess) return e;
      kernel<<<grid, kMmaThreads, smem, stream>>>(
          static_cast<const S*>(vals), static_cast<const S*>(vg),
          static_cast<const float*>(wb), static_cast<const float*>(h),
          static_cast<float*>(xkv), static_cast<float*>(b), K, I, C, R);
      return cudaGetLastError();
    }
    return cudaErrorInvalidValue;            // no such shape reaches here
  }
  if (variant == kRing || variant == kRingElementCopies) {
    const size_t smem = ring_layout<T, S, kEpiB>(I, C, R, kStages).smem_bytes;
    auto kernel = variant == kRing ? slab_ring_kernel<T, S, RMAX, true, kEpiB>
                                   : slab_ring_kernel<T, S, RMAX, false, kEpiB>;
    cudaError_t e = allow_smem(kernel, smem);
    int grid = 0;
    if (e == cudaSuccess) e = persistent_grid(kernel, kRingThreads, smem, K, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kRingThreads, smem, stream>>>(
        static_cast<const S*>(vals), static_cast<const S*>(vg),
        static_cast<const T*>(wb), static_cast<const T*>(h),
        static_cast<T*>(xkv), static_cast<T*>(b), K, I, C, R, kStages);
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

// F3's variants, as spartan_fused_mode2_compact_variant reports them.
enum F3Variant { kF3Ring = 0, kF3RingElementCopies = 1, kF3Column = 2, kF3ColumnChunked = 3,
                 kF3ColumnWide = 4, kF3ColumnWideChunked = 5 };

// The rows of Q_k the thread-per-column variant stages at a time.
template <typename T>
int f3_rows_per_chunk(int I, int R, bool wide, int rmax) {
  const size_t fixed = wide ? 0 : (size_t)R * R + R;
  return std::min(I, rows_that_fit<T>(fixed, row_stride(wide ? rmax : R)));
}

// RING where a group's stages fit and R <= 64 (16-byte copies when every
// slab row starts on a 16-byte boundary), else THREAD-PER-COLUMN.
template <typename T, typename S>
int f3_variant(int I, int C, int R, bool aligned) {
  if (f3_group<T, S>(I, C, R) > 0)
    return aligned && C % (16 / (int)sizeof(S)) == 0 ? kF3Ring : kF3RingElementCopies;
  const bool wide = R > kTile;
  const bool chunked = f3_rows_per_chunk<T>(I, R, wide, kTile) < I;
  return wide ? (chunked ? kF3ColumnWideChunked : kF3ColumnWide)
              : (chunked ? kF3ColumnChunked : kF3Column);
}

template <typename T, typename S, int RMAX, bool WIDE>
cudaError_t launch_f3(const void* vals, const void* q, const void* h,
                      const void* wb, const void* cm, void* out, int K, int I,
                      int C, int R, cudaStream_t stream) {
  const int variant = f3_variant<T, S>(I, C, R, reinterpret_cast<uintptr_t>(vals) % 16 == 0);
  if (variant == kF3Ring || variant == kF3RingElementCopies) {
    const int G = f3_group<T, S>(I, C, R);
    const F3Layout lay = f3_layout<T, S>(I, C, R, G);
    auto kernel = variant == kF3Ring ? mode2_ring_kernel<T, S, true>
                                     : mode2_ring_kernel<T, S, false>;
    cudaError_t e = allow_smem(kernel, lay.smem_bytes);
    int grid = 0;
    if (e == cudaSuccess)
      e = persistent_grid(kernel, lay.threads, lay.smem_bytes, ((int64_t)K + G - 1) / G, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<grid, lay.threads, lay.smem_bytes, stream>>>(
        static_cast<const S*>(vals), static_cast<const T*>(q),
        static_cast<const T*>(h), static_cast<const T*>(wb),
        static_cast<const T*>(cm), static_cast<T*>(out), K, I, C, R, G);
    return cudaGetLastError();
  }
  const int RS = row_stride(WIDE ? RMAX : R);
  const size_t fixed = WIDE ? 0 : (size_t)R * R + R;
  const int IC = f3_rows_per_chunk<T>(I, R, WIDE, RMAX);
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

// F4's variants, as spartan_fused_ykv_variant reports them: F1's.

// The row-warp variant's chunks: Vg_k rows CC and rows IT (the whole of
// each where the subject fits in kMaxDynamicSmem).
template <typename T>
void f4_row_warp_chunks(int I, int C, int R, bool wide, int rmax, int* CC, int* IT) {
  const int RS = row_stride(wide ? rmax : R), RQ = row_stride(R);
  *CC = C;
  *IT = I;
  if (((size_t)C * RS + (size_t)I * (RQ + RS)) * sizeof(T) > (size_t)kMaxDynamicSmem) {
    // half of the budget to tiles of rows (Q_k and X_k Vg_k), the rest to Vg_k
    *IT = std::min(I, std::max(1, rows_that_fit<T>(0, 2 * (size_t)(RQ + RS))));
    *CC = std::min(C, rows_that_fit<T>((size_t)*IT * (RQ + RS), RS));
  }
}

// The stages of F4's FMA ring: as many as fit in a third of the shared
// memory a block may use (three blocks an SM, as its 79 registers a thread
// allow), from 2 to kMaxStages, so that a small subject (the rsvd cores'
// I = 18) keeps several in flight. On an H100 in a graph, f32, R = 5: at I
// = 56 two stages took 0.6384 ms against three (two blocks an SM) 0.6986;
// at I = 18 five stages 0.4703 against eight 0.6126.
template <typename T, typename S>
int f4_stages(int I, int C, int R) {
  const RingLayout lay = ring_layout<T, S, kEpiG>(I, C, R, 0);   // the tail alone
  const size_t budget = kMaxDynamicSmem / 3;
  const int fit = budget > lay.smem_bytes ? (int)((budget - lay.smem_bytes) / lay.stage) : 0;
  return std::max(2, std::min(kMaxStages, fit));
}

// RING-MMA for a half slab and Vg at R <= 8 where its stages fit; else
// RING (FMA) where its stages fit, R <= 64 and I >= kRingMinRows, never for
// a half slab at R <= 8; else ROW-WARP. Element copies where a slab row is not a whole
// number of 16-byte packs or the slab does not start on a 16-byte boundary.
template <typename T, typename S>
int f4_variant(int I, int C, int R, bool aligned) {
  const bool whole = aligned && C % (16 / (int)sizeof(S)) == 0;
  const bool half_narrow = sizeof(S) == 2 && R <= kOwnerR;
  if (half_narrow && mma_layout<kEpiG>(I, C, R).smem_bytes <= (size_t)kMaxDynamicSmem)
    return whole ? kRingMma : kRingMmaElementCopies;
  if (!half_narrow && R <= kTile && I >= kRingMinRows &&
      ring_layout<T, S, kEpiG>(I, C, R, 2).smem_bytes <= (size_t)kMaxDynamicSmem)
    return whole ? kRing : kRingElementCopies;
  const bool wide = R > kTile;
  int CC = 0, IT = 0;
  f4_row_warp_chunks<T>(I, C, R, wide, kTile, &CC, &IT);
  const bool chunked = CC < C || IT < I;
  return wide ? (chunked ? kRowWarpWideChunked : kRowWarpWide)
              : (chunked ? kRowWarpChunked : kRowWarp);
}

template <typename T, typename S, int RMAX, bool WIDE>
cudaError_t launch_f4(const void* vals, const void* q, const void* vg,
                      void* out, int K, int I, int C, int R,
                      cudaStream_t stream) {
  const int variant = f4_variant<T, S>(I, C, R, reinterpret_cast<uintptr_t>(vals) % 16 == 0);
  constexpr bool kHalfNarrow = sizeof(S) == 2 && RMAX <= kOwnerR;
  if (variant == kRingMma || variant == kRingMmaElementCopies) {
    if constexpr (kHalfNarrow) {
      const size_t smem = mma_layout<kEpiG>(I, C, R).smem_bytes;
      auto kernel = variant == kRingMma ? mma_ring_kernel<S, true, kEpiG>
                                        : mma_ring_kernel<S, false, kEpiG>;
      cudaError_t e = allow_smem(kernel, smem);
      int grid = 0;
      if (e == cudaSuccess) e = persistent_grid(kernel, kMmaThreads, smem, K, &grid);
      if (e != cudaSuccess) return e;
      kernel<<<grid, kMmaThreads, smem, stream>>>(
          static_cast<const S*>(vals), static_cast<const S*>(vg),
          static_cast<const float*>(q), static_cast<const float*>(nullptr),
          static_cast<float*>(nullptr), static_cast<float*>(out), K, I, C, R);
      return cudaGetLastError();
    }
    return cudaErrorInvalidValue;            // no such shape reaches here
  }
  if (variant == kRing || variant == kRingElementCopies) {
    if constexpr (!kHalfNarrow && !WIDE) {
      const int nst = f4_stages<T, S>(I, C, R);
      const size_t smem = ring_layout<T, S, kEpiG>(I, C, R, nst).smem_bytes;
      auto kernel = variant == kRing ? slab_ring_kernel<T, S, RMAX, true, kEpiG>
                                     : slab_ring_kernel<T, S, RMAX, false, kEpiG>;
      cudaError_t e = allow_smem(kernel, smem);
      int grid = 0;
      if (e == cudaSuccess) e = persistent_grid(kernel, kRingThreads, smem, K, &grid);
      if (e != cudaSuccess) return e;
      kernel<<<grid, kRingThreads, smem, stream>>>(
          static_cast<const S*>(vals), static_cast<const S*>(vg),
          static_cast<const T*>(q), static_cast<const T*>(nullptr),
          static_cast<T*>(nullptr), static_cast<T*>(out), K, I, C, R, nst);
      return cudaGetLastError();
    }
    return cudaErrorInvalidValue;            // no such shape reaches here
  }
  const int RS = row_stride(WIDE ? RMAX : R), RQ = row_stride(R);
  int CC = 0, IT = 0;
  f4_row_warp_chunks<T>(I, C, R, WIDE, RMAX, &CC, &IT);
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

// The variant a spartan_fused_mode2_compact launch takes (F3Variant: 0
// ring, 1 ring with element copies, 2-5 thread-per-column, chunked, wide,
// wide chunked) for a slab of dtype code `dtype`; aligned: the slab starts
// on a 16-byte boundary. -1 for an unknown dtype.
int spartan_fused_mode2_compact_variant(int dtype, int I, int C, int R, int aligned) {
  if (R < 1 || I < 1 || C < 1) return -1;
  if (dtype == 0) return f3_variant<float, float>(I, C, R, aligned != 0);
  if (dtype == 1) return f3_variant<double, double>(I, C, R, aligned != 0);
  if (dtype == 2) return f3_variant<float, bf16>(I, C, R, aligned != 0);
  if (dtype == 3) return f3_variant<float, f16>(I, C, R, aligned != 0);
  return -1;
}

int spartan_fused_ykv(int dtypes, const void* vals, const void* q,
                      const void* vg, void* out, int K, int I, int C, int R,
                      void* stream) {
  const int code = operand_code(dtypes, 0);
  if (operand_code(dtypes, 1) != code) return (int)cudaErrorInvalidValue;
  SPARTAN_DISPATCH(code, launch_f4, vals, q, vg, out, K, I, C, R,
                   static_cast<cudaStream_t>(stream));
}

// The variant a spartan_fused_ykv launch takes (F4Variant: F1's six codes,
// then 6 ring on the tensor cores, 7 the same with element copies) for a
// slab and Vg of dtype code `dtype`; aligned: the slab starts on a 16-byte
// boundary. -1 for an unknown dtype.
int spartan_fused_ykv_variant(int dtype, int I, int C, int R, int aligned) {
  if (R < 1 || I < 1 || C < 1) return -1;
  if (dtype == 0) return f4_variant<float, float>(I, C, R, aligned != 0);
  if (dtype == 1) return f4_variant<double, double>(I, C, R, aligned != 0);
  if (dtype == 2) return f4_variant<float, bf16>(I, C, R, aligned != 0);
  if (dtype == 3) return f4_variant<float, f16>(I, C, R, aligned != 0);
  return -1;
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
