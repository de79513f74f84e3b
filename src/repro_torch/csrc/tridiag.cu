// P2: the symmetric tridiagonal solve of the `smooth` constraint's prox, for
// Hopper (sm_90a).
//
//   tridiag_solve   Z = rho (rho I + two_lam D^T D)^{-1} Y          [N, R]
//
// for Y [N, R] row-major (a factor's rows; one system, R right-hand sides),
// D the first differences over rows: the matrix has the diagonal rho +
// two_lam [1, 2, ..., 2, 1] and the off-diagonals -two_lam, the same for all
// R columns. It is the prox of lam sum_k ||z_k - z_{k-1}||^2 at penalty rho
// (repro_torch/core/constraints.py::prox_smooth, two_lam = 2 lam). The
// reference solves it with lax.linalg.tridiagonal_solve inside its compiled
// program (src/repro/core/constraints.py:149); no Pallas kernel replaces it
// there, and torch has no banded solver, so this kernel is the port's own.
// `rho` is a scalar in device memory, read by the kernel: the ADMM loop
// computes it on the device (trace(A) / R), and a host value would cost a
// sync every step and could not be captured in a CUDA graph. The arithmetic
// stays in T (float or double), as the reference's does; the matrix is
// symmetric positive definite and diagonally dominant for rho > 0, so no
// pivoting is needed.
//
// Method: the partition method (Wang 1981; the SPIKE family), applied
// recursively. A chunk of contiguous rows s..e (at least 2) of a level is
// worked on apart:
//   1. down the chunk (rows s+1..e) the subdiagonal is eliminated, keeping
//      the fill-in column of x_s: row i becomes f_i x_s + g_i x_i + c_i x_{i+1}
//      = h_i; row e is then the chunk's last reduced row;
//   2. up the chunk (rows e-1..s+1) the superdiagonal is eliminated, keeping
//      the fill-in column of x_e, and row s becomes a_s x_{s-1} + beta x_s +
//      gamma x_e = delta, the chunk's first reduced row.
// The reduced rows (x_s and x_e of every chunk, in order) form again a
// tridiagonal system with one matrix for all columns, the Schur complement
// of the interior unknowns, still diagonally dominant; it is reduced the
// same way until at most kBase unknowns remain, which are solved by Thomas
// (a thread a column). Then every level, deepest first, back-substitutes
// its interior rows from its chunks' x_s and x_e:
//   3. x_i = (h_i - f_i x_s - c_i x_{i+1}) / g_i, rows e-1..s+1.
// Every division is a multiplication by a pivot's reciprocal (rcp), formed
// once a row in step 1.
//
// One launch a call. The parent design enqueued 2 L + 1 kernels (L reduced
// levels, 3 at N = 116,225), each a chain of dependent rows over few
// threads at the deeper levels, so the call was bound by latency and
// launches: 0.0727 ms in a CUDA graph at N = 116,225, R = 5, f32, against
// a byte bound of 0.0014 ms. Here the levels run inside one persistent
// grid, with one grid-wide dependency:
//   A. Level 0 is cut into P0 = ceil(N / kChunk) chunks (16 to 32 rows),
//      the chunks into U units of kUnit chunks, and the units into the
//      grid's blocks, ups = ceil(U / grid) contiguous units a block. For
//      each unit, a thread a (chunk, column) reduces its chunk (steps 1, 2)
//      to two rows of level 1; after a block barrier the unit's first TC
//      threads (a thread a column) reduce the unit's 2 kUnit rows of level
//      1, as one chunk, to two rows of level 2; the same threads then
//      reduce the block's 2 ups rows of level 2 to two rows of level 3.
//   B. The block that takes the last ticket of the workspace's counter
//      (common.cuh's last_block_to_finish, which sets it back to 0 for the
//      next call or replay) solves level 3 (2 grid <= 2 kMaxGrid rows)
//      alone: its deeper levels with block barriers between them, Thomas
//      at the bottom. It then publishes the solution by advancing a
//      generation word in the workspace.
//   C. Every other block waits (one thread spinning on that word, which it
//      read at its start, before its ticket) and then back-substitutes:
//      its level-2 rows from level 3, each unit's level-1 rows from level 2
//      (a thread a column), a block barrier, the unit's level-0 rows (a
//      thread a (chunk, column)), which writes Z.
// The grid is at most the blocks that the card holds at once (the
// occupancy query), so every block waiting in C runs beside the last one.
// Data written by one block and read by another (level 3's rows, its
// solution) is read through L2 (__ldcg); a block reads back its own writes
// with plain loads. Level 0's matrix is Toeplitz below row 0, so its
// multipliers and pivots are the same in every chunk (Table0): one thread a
// block forms them, and the column threads' level-0 chains are
// multiply-adds on their chunk's Y, loaded in one batch. At the deeper
// levels every column thread of a chunk follows the matrix recurrence
// itself (the same arithmetic, so the same bits) and writes the chunk's f,
// 1 / g and reduced matrix rows, the same values, so no barrier separates
// steps 1 and 2; a chain keeps its h in registers and takes its loads
// kGroup rows at a time, every load of a group before its arithmetic. A
// fixed order and no float atomics: two calls give the same bits. The
// order of the eliminations differs from the parent's (level 1 in units of
// 2 kUnit rows, level 2 in a block's rows, reciprocals for divisions), so
// the bits do too, within the solve's rounding (chip_smoke.py:
// p2_tolerance).
//
// Bound on an H100: the bytes, Y read once and Z written once, 2 N R
// sizeof(T) (N = 116,225, R = 5, float: 4.6 MB, 1.4 us at 3.35 TB/s); the
// operations (about 6 N R) are far below the float peak. What bounds this
// design is its chain of dependent rows: on an H100 80GB HBM3 at 700 W, at
// N = 116,225, R = 5, f32 (launch/tridiag_trace.py: globaltimer stamps at
// the phase boundaries), phase A took 9.7 us (the last block's 10.3), the
// last block's solve of level 3 (456 rows: three short chains and Thomas
// on 30) 17.3 us, the release 1.1 us and phase C 7.1 us; kernel_ab, in a
// CUDA graph: 0.0384 ms a call against the parent's 0.0732 (0.0880 against
// 0.1202 at N = 464,900, where a block takes 4
// units). No host sync and no allocation (the caller's workspace,
// spartan_tridiag_workspace elements of T, zeroed once).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kChunk = 32;     // rows a chunk takes at a level
constexpr int kUnit = 16;      // level-0 chunks a unit (a block's step) reduces together
constexpr int kBase = 64;      // at most this many unknowns are solved directly
constexpr int kCols = 16;      // column threads a chunk has at most (blocks of <= 256
                               // threads, so that a thread may take 255 registers)
constexpr int kMaxLevels = 10; // 2^31 unknowns take 9 levels
constexpr int kMaxGrid = 256;  // blocks at most: level 3 then fits one pass of kUnit chunks

// Rows whose loads a thread issues before their arithmetic at the levels
// past 0 (level 0 loads a chunk's Y in one batch): wider groups took more
// registers than a thread has and spilled.
constexpr int kGroup = 8;

// 1 / x to within an ulp or so: the approximate reciprocal and Newton steps
// (one in float, two in double), a third of the latency of a division,
// which every step of a reduction's chain would otherwise wait for. x is
// a pivot of the diagonally dominant matrix, at least rho.
__device__ inline float rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}
__device__ inline double rcp(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  r = fma(r, fma(-x, r, 1.0), r);
  return fma(r, fma(-x, r, 1.0), r);
}

// Level 0: the matrix rho I + two_lam D^T D and the right-hand side rho Y.
template <typename T>
struct Level0 {
  const T* y;
  const T* rho_ptr;
  T two_lam;
  int n, R;
  T rho;
  __device__ void load() { rho = __ldg(rho_ptr); }
  __device__ T a(int i) const { return i == 0 ? T(0) : -two_lam; }
  __device__ T b(int i) const {
    return rho + two_lam * ((i == 0 || i == n - 1) ? T(1) : T(2));
  }
  __device__ T c(int i) const { return i == n - 1 ? T(0) : -two_lam; }
  __device__ T d(int i, int r) const { return rho * __ldg(y + (int64_t)i * R + r); }
};

// A deeper level: its matrix (a, b, c) and right-hand side d in the
// workspace, written by the level above's reduction. CROSS: written by
// other blocks (level 2, read by the block that solves it), so read
// through L2; else written by the reading block, read with plain loads.
template <typename T, bool CROSS>
struct LevelN {
  const T* av;
  const T* bv;
  const T* cv;
  const T* dv;
  int n, R;
  __device__ static T ld(const T* p) {
    if constexpr (CROSS) return __ldcg(p);
    else return *p;
  }
  __device__ T a(int i) const { return ld(av + i); }
  __device__ T b(int i) const { return ld(bv + i); }
  __device__ T c(int i) const { return ld(cv + i); }
  __device__ T d(int i, int r) const { return ld(dv + (int64_t)i * R + r); }
};

// A unit's rows s0 .. s0 + 2 kUnit - 1 of level 1 in shared memory, as its
// level-0 chunks reduced them: the matrix, and the right-hand side's
// columns c0 .. c0 + kCols - 1.
template <typename T>
struct LevelS {
  const T* av;
  const T* bv;
  const T* cv;
  const T* dv;            // [2 kUnit][kCols]
  int s0, c0, R;
  __device__ T a(int i) const { return av[i - s0]; }
  __device__ T b(int i) const { return bv[i - s0]; }
  __device__ T c(int i) const { return cv[i - s0]; }
  __device__ T d(int i, int r) const { return dv[(i - s0) * kCols + r - c0]; }
};

// One level's arrays in the workspace: its matrix and right-hand side
// (levels >= 1), its solution x (level 0: Z), and its reduction's f, 1 / g
// [n] and h [n, R] (levels that are reduced).
template <typename T>
struct Arrays {
  T *a, *b, *c, *d, *x, *f, *g, *h;
  int n;
};

// A chunk's two reduced rows: a x_{s-1} + b x_s + c x_e = d (row s) and
// a x_s + b x_e + c x_{e+1} = d (row e).
template <typename T>
struct Reduced {
  T a0, b0, c0, d0, a1, b1, c1, d1;
};

// A chunk's matrix part in shared memory, kChunk entries each: f, 1 / g of
// rows s+1..e and c of rows s..e-1, at offsets from s+1 (c: from s). Every
// column thread of the chunk writes the same values, so no barrier parts
// the steps that read them.
template <typename T>
struct Slot {
  T* f;
  T* g;
  T* c;
};

__device__ inline void chunk_rows(int j, int n, int P, int* s, int* e) {
  *s = (int)((int64_t)j * n / P);
  *e = (int)((int64_t)(j + 1) * n / P) - 1;
}

// Steps 1 and 2 for one chunk s..e (e - s < kChunk) and one column `col`:
// h of rows s+1..e in registers and in `cur.h`, f and 1 / g in the slot and
// in `cur.f`, `cur.g` (for step 3); returns the chunk's two reduced rows.
// Loads are issued G rows at a time, before those rows' arithmetic; step 2
// reads only registers and the slot. Only step 1's pivots wait on a
// reciprocal; every other step is multiply-adds.
template <int G, typename T, typename Level>
__device__ Reduced<T> reduce_chunk(const Level& lv, int s, int e, int col,
                                   const Arrays<T>& cur, const Slot<T>& sl) {
  const int R = lv.R, m = e - s;             // rows s+1..e
  const T as = lv.a(s), bs = lv.b(s), ce = lv.c(e), ds = lv.d(s, col);
  T hr[kChunk - 1];
  T fp = T(0), gp = T(1), gi = T(1), hv = T(0);
  // 1. down rows s+1..e
#pragma unroll
  for (int q0 = 0; q0 < kChunk - 1; q0 += G) {
    if (q0 < m) {
      T av[G], bv[G], cv[G], dv[G];
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (q0 + q < m) {
          const int i = s + 1 + q0 + q;
          av[q] = lv.a(i);
          bv[q] = lv.b(i);
          cv[q] = lv.c(i - 1);
          dv[q] = lv.d(i, col);
        }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int qq = q0 + q;
        if (qq < kChunk - 1 && qq < m) {
          if (qq == 0) {
            fp = av[q];
            gp = bv[q];
            hv = dv[q];
          } else {
            const T k = av[q] * gi;
            fp = -k * fp;
            gp = bv[q] - k * cv[q];
            hv = dv[q] - k * hv;
          }
          gi = rcp(gp);
          hr[qq] = hv;
          sl.f[qq] = fp;
          sl.g[qq] = gi;
          sl.c[qq] = cv[q];                  // c of row s + qq
          const int i = s + 1 + qq;
          cur.h[(int64_t)i * R + col] = hv;
          cur.f[i] = fp;
          cur.g[i] = gi;
        }
      }
    }
  }
  Reduced<T> out;
  out.a1 = fp;
  out.b1 = gp;
  out.c1 = ce;
  out.d1 = hv;
  // 2. up rows e-1..s+1 (offset q = i - s - 1 from m - 2 down to 0), then row s
  out.a0 = as;
  if (m == 1) {
    out.b0 = bs;
    out.c0 = sl.c[0];
    out.d0 = ds;
  } else {
    T u = T(0), w = T(0), z = T(0);
#pragma unroll
    for (int q = kChunk - 2; q >= 0; --q) {
      if (q == m - 2) {                      // row e - 1
        u = sl.f[q];
        w = sl.c[q + 1];
        z = hr[q];
      } else if (q < m - 2) {                // row i = s + 1 + q: k = c_i / g_{i+1}
        const T k = sl.c[q + 1] * sl.g[q + 1];
        u = sl.f[q] - k * u;
        w = -k * w;
        z = hr[q] - k * z;
      }
    }
    const T k = sl.c[0] * sl.g[0];
    out.b0 = bs - k * u;
    out.c0 = -k * w;
    out.d0 = ds - k * z;
  }
  return out;
}

// reduce_chunk for a chunk of any length (a block's level-2 rows, 2 ups of
// them): h, f and 1 / g go to the workspace only, and step 2 reads them
// back, kGroup rows at a time.
template <typename T, typename Level>
__device__ Reduced<T> reduce_long(const Level& lv, int s, int e, int col, const Arrays<T>& cur) {
  const int R = lv.R;
  T fp = lv.a(s + 1), gp = lv.b(s + 1), hv = lv.d(s + 1, col);
  T gi = rcp(gp);
  cur.h[(int64_t)(s + 1) * R + col] = hv;
  cur.f[s + 1] = fp;
  cur.g[s + 1] = gi;
  for (int i0 = s + 2; i0 <= e; i0 += kGroup) {
    const int m = min(kGroup, e - i0 + 1);
    T av[kGroup], bv[kGroup], cv[kGroup], dv[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      if (q < m) {
        av[q] = lv.a(i0 + q);
        bv[q] = lv.b(i0 + q);
        cv[q] = lv.c(i0 + q - 1);
        dv[q] = lv.d(i0 + q, col);
      }
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      if (q < m) {
        const T k = av[q] * gi;
        fp = -k * fp;
        gp = bv[q] - k * cv[q];
        gi = rcp(gp);
        hv = dv[q] - k * hv;
        cur.h[(int64_t)(i0 + q) * R + col] = hv;
        cur.f[i0 + q] = fp;
        cur.g[i0 + q] = gi;
      }
  }
  Reduced<T> out;
  out.a1 = fp;
  out.b1 = gp;
  out.c1 = lv.c(e);
  out.d1 = hv;
  out.a0 = lv.a(s);
  if (e == s + 1) {
    out.b0 = lv.b(s);
    out.c0 = lv.c(s);
    out.d0 = lv.d(s, col);
    return out;
  }
  T u = cur.f[e - 1], w = lv.c(e - 1), z = cur.h[(int64_t)(e - 1) * R + col];
  for (int i0 = e - 2; i0 > s; i0 -= kGroup) {
    const int m = min(kGroup, i0 - s);
    T cv[kGroup], gv[kGroup], fv[kGroup], hw[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      if (q < m) {
        cv[q] = lv.c(i0 - q);
        gv[q] = cur.g[i0 - q + 1];
        fv[q] = cur.f[i0 - q];
        hw[q] = cur.h[(int64_t)(i0 - q) * R + col];
      }
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      if (q < m) {
        const T k = cv[q] * gv[q];
        u = fv[q] - k * u;
        w = -k * w;
        z = hw[q] - k * z;
      }
  }
  const T k = lv.c(s) * cur.g[s + 1];
  out.b0 = lv.b(s) - k * u;
  out.c0 = -k * w;
  out.d0 = lv.d(s, col) - k * z;
  return out;
}

// Level 0's matrix part at offsets q = 0 .. kChunk - 2 from a chunk's row
// s + 1: its multipliers k, f, g and 1 / g, the same for every chunk's rows
// below row N - 1 (level 0's matrix is Toeplitz past row 0), made once a
// block by one thread with level 0's arithmetic, so that the column threads'
// chains at level 0 are multiply-adds only.
template <typename T>
struct Table0 {
  T k[kChunk], f[kChunk], g[kChunk], gi[kChunk];
};

template <typename T>
__device__ void make_table0(const Level0<T>& lv, Table0<T>& t) {
  const T a = lv.a(1), b = lv.b(1), c = lv.c(1);   // an interior row's
  T fp = a, gp = b, gi = rcp(gp);
  t.k[0] = T(0);
  t.f[0] = fp;
  t.g[0] = gp;
  t.gi[0] = gi;
  for (int q = 1; q < kChunk - 1; ++q) {
    const T k = a * gi;
    fp = -k * fp;
    gp = b - k * c;
    gi = rcp(gp);
    t.k[q] = k;
    t.f[q] = fp;
    t.g[q] = gp;
    t.gi[q] = gi;
  }
}

// reduce_chunk at level 0 (N > kBase, so 16 to 32 rows a chunk) from the
// table: the chunk's Y in one batch of loads, then h down and up with one
// multiply-add a row; only h goes to the workspace (step 3 reads f and 1 / g
// from the table). The last row of the last chunk, N - 1, has its own
// diagonal entry.
template <typename T>
__device__ Reduced<T> reduce_chunk0(const Level0<T>& lv, const Table0<T>& t, int s, int e,
                                    int col, const Arrays<T>& cur) {
  const int R = lv.R, m = e - s;
  const T c = lv.c(s);                      // every off-diagonal entry above row N - 1
  T hr[kChunk - 1];                         // d, then h, of rows s+1..e
#pragma unroll
  for (int q = 0; q < kChunk - 1; ++q)
    if (q < m) hr[q] = lv.d(s + 1 + q, col);
  const T ds = lv.d(s, col);
  T hv = T(0);
#pragma unroll
  for (int q = 0; q < kChunk - 1; ++q)
    if (q < m) {
      hv = q == 0 ? hr[0] : hr[q] - t.k[q] * hv;
      hr[q] = hv;
      cur.h[(int64_t)(s + 1 + q) * R + col] = hv;
    }
  Reduced<T> out;
  out.a1 = t.f[m - 1];
  out.b1 = e == lv.n - 1 ? lv.b(e) - t.k[m - 1] * c : t.g[m - 1];
  out.c1 = lv.c(e);
  out.d1 = hv;
  out.a0 = lv.a(s);
  if (m == 1) {
    out.b0 = lv.b(s);
    out.c0 = c;
    out.d0 = ds;
  } else {
    T u = T(0), w = T(0), z = T(0);
#pragma unroll
    for (int q = kChunk - 2; q >= 0; --q) {
      if (q == m - 2) {
        u = t.f[q];
        w = c;
        z = hr[q];
      } else if (q < m - 2) {
        const T k = c * t.gi[q + 1];
        u = t.f[q] - k * u;
        w = -k * w;
        z = hr[q] - k * z;
      }
    }
    const T k = c * t.gi[0];
    out.b0 = lv.b(s) - k * u;
    out.c0 = -k * w;
    out.d0 = ds - k * z;
  }
  return out;
}

// expand_chunk at level 0: h of rows s+1..e-1 in one batch of loads, f and
// 1 / g from the table.
template <typename T>
__device__ void expand_chunk0(const Level0<T>& lv, const Table0<T>& t, int s, int e, int col,
                              int j, const Arrays<T>& cur, const T* xr) {
  const int R = lv.R, m = e - s;
  const T c = lv.c(s);
  const T xs = __ldcg(xr + (int64_t)(2 * j) * R + col);
  T xn = __ldcg(xr + (int64_t)(2 * j + 1) * R + col);
  T hv[kChunk - 2];
#pragma unroll
  for (int q = 0; q < kChunk - 2; ++q)
    if (q < m - 1) hv[q] = cur.h[(int64_t)(s + 1 + q) * R + col];
  cur.x[(int64_t)s * R + col] = xs;
  cur.x[(int64_t)e * R + col] = xn;
#pragma unroll
  for (int q = kChunk - 3; q >= 0; --q)
    if (q < m - 1) {
      xn = (hv[q] - t.f[q] * xs - c * xn) * t.gi[q];
      cur.x[(int64_t)(s + 1 + q) * R + col] = xn;
    }
}

// Row j's two reduced rows into a level's arrays (the matrix from every
// column thread, the same values).
template <typename T>
__device__ inline void put_rows(const Arrays<T>& next, int j, int col, int R,
                                const Reduced<T>& r) {
  next.a[2 * j] = r.a0;
  next.b[2 * j] = r.b0;
  next.c[2 * j] = r.c0;
  next.d[(int64_t)(2 * j) * R + col] = r.d0;
  next.a[2 * j + 1] = r.a1;
  next.b[2 * j + 1] = r.b1;
  next.c[2 * j + 1] = r.c1;
  next.d[(int64_t)(2 * j + 1) * R + col] = r.d1;
}

// Step 3 for one chunk s..e and one column: x_s and x_e from the next
// level's solution (its rows 2j and 2j + 1, read through L2: at level 1
// the block that solved level 2 wrote them), then rows e-1..s+1 from h, f
// and 1 / g, which this block's reduction wrote, G rows at a time, their
// loads first.
template <int G, typename T, typename Level>
__device__ void expand_chunk(const Level& lv, int s, int e, int col, int j,
                             const Arrays<T>& cur, const T* xr) {
  const int R = lv.R;
  const T xs = __ldcg(xr + (int64_t)(2 * j) * R + col);
  T xn = __ldcg(xr + (int64_t)(2 * j + 1) * R + col);
  cur.x[(int64_t)s * R + col] = xs;
  cur.x[(int64_t)e * R + col] = xn;
  for (int i0 = e - 1; i0 > s; i0 -= G) {
    const int m = min(G, i0 - s);
    T fv[G], cv[G], gv[G], hv[G];
#pragma unroll
    for (int q = 0; q < G; ++q)
      if (q < m) {
        fv[q] = cur.f[i0 - q];
        cv[q] = lv.c(i0 - q);
        gv[q] = cur.g[i0 - q];
        hv[q] = cur.h[(int64_t)(i0 - q) * R + col];
      }
#pragma unroll
    for (int q = 0; q < G; ++q)
      if (q < m) {
        xn = (hv[q] - fv[q] * xs - cv[q] * xn) * gv[q];
        cur.x[(int64_t)(i0 - q) * R + col] = xn;
      }
  }
}

// Thomas on n <= kBase unknowns by the whole block, from shared memory: the
// matrix staged once and the pivots by thread 0, then the right-hand side
// kCols columns at a time, staged by the block (every load in flight at
// once), solved in place by a thread a column, stored to x. Block barriers
// before and after.
template <typename T>
struct BaseSmem {
  T as[kBase], bs[kBase], cs[kBase], cp[kBase], piv[kBase];
  T ds[kBase][kCols + 1];
};

template <typename T, typename Level>
__device__ void base_solve(const Level& lv, int n, T* __restrict__ x, BaseSmem<T>& sm) {
  T *as = sm.as, *bs = sm.bs, *cs = sm.cs, *cp = sm.cp, *piv = sm.piv;
  auto& ds = sm.ds;
  const int R = lv.R, tid = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    as[i] = lv.a(i);
    bs[i] = lv.b(i);
    cs[i] = lv.c(i);
  }
  __syncthreads();
  if (tid == 0) {                            // piv: the pivots' reciprocals
    T inv = rcp(bs[0]);
    piv[0] = inv;
    cp[0] = cs[0] * inv;
    for (int i = 1; i < n; ++i) {
      inv = rcp(bs[i] - as[i] * cp[i - 1]);
      piv[i] = inv;
      cp[i] = cs[i] * inv;
    }
  }
  for (int c0 = 0; c0 < R; c0 += kCols) {
    const int w = min(kCols, R - c0);
    for (int t = tid; t < n * w; t += nt) ds[t / w][t % w] = lv.d(t / w, c0 + t % w);
    __syncthreads();                         // the pivots; this group's right-hand side
    for (int r = tid; r < w; r += nt) {
      T dp = ds[0][r] * piv[0];
      ds[0][r] = dp;
      for (int i = 1; i < n; ++i) {
        dp = (ds[i][r] - as[i] * dp) * piv[i];
        ds[i][r] = dp;
      }
      for (int i = n - 2; i >= 0; --i) {
        dp = ds[i][r] - cp[i] * dp;
        ds[i][r] = dp;
      }
    }
    __syncthreads();
    for (int t = tid; t < n * w; t += nt) x[(int64_t)(t / w) * R + c0 + t % w] = ds[t / w][t % w];
    __syncthreads();                         // before the next group is staged
  }
}

// The sizes of the levels: n_0 = N; n_1 = 2 P0 (P0 = ceil(N / kChunk)
// chunks); n_2 = 2 U (U = ceil(P0 / kUnit) units, each reduced to two
// rows); n_3 = 2 ceil(U / ups) (a block's ups units reduced to two rows);
// then n_{l+1} = 2 ceil(n_l / kChunk) while n_l > kBase. Returns L, the
// deepest level (solved by Thomas); N <= kBase: 0. ups = 1 gives every
// level's largest size.
int levels(int N, int ups, int* n) {
  n[0] = N;
  if (N <= kBase) return 0;
  const int P0 = (N + kChunk - 1) / kChunk, U = (P0 + kUnit - 1) / kUnit;
  n[1] = 2 * P0;
  n[2] = 2 * U;
  n[3] = 2 * ((U + ups - 1) / ups);
  int L = 3;
  while (n[L] > kBase) {
    n[L + 1] = 2 * ((n[L] + kChunk - 1) / kChunk);
    ++L;
  }
  return L;
}

// Thread layout: TC column threads a chunk, kUnit chunks a block.
__host__ __device__ inline int col_threads(int R) { return R < kCols ? R : kCols; }

// The workspace, in elements of T: the ticket counter and the generation
// word (two 32-bit words in the first 16 bytes), then h [n_l, R] of every
// reduced level l < L and f, 1 / g [n_l] of those past level 0, then a, b,
// c [n_l], d and x [n_l, R] of every deeper level 1 <= l <= L.
template <typename T>
int64_t workspace_elems(int N, int R) {
  int n[kMaxLevels + 1];
  const int L = levels(N, 1, n);
  int64_t total = counter_elems<T>() + (L > 0 ? (int64_t)R * N : 0);   // level 0's h
  for (int l = 1; l < L; ++l) total += (2 + (int64_t)R) * n[l];
  for (int l = 1; l <= L; ++l) total += (3 + 2 * (int64_t)R) * n[l];
  return total;
}

template <typename T>
struct Plan {
  Arrays<T> lv[kMaxLevels + 1];
  int L, ups;
};

template <typename T>
Plan<T> plan(int N, int R, int ups, void* out, void* ws) {
  Plan<T> p;
  int n[kMaxLevels + 1];
  p.L = levels(N, ups, n);
  p.ups = ups;
  T* w = static_cast<T*>(ws) + counter_elems<T>();
  for (int l = 0; l <= p.L; ++l) p.lv[l] = Arrays<T>{nullptr, nullptr, nullptr, nullptr,
                                                     nullptr, nullptr, nullptr, nullptr, n[l]};
  for (int l = 0; l < p.L; ++l) {
    if (l > 0) {                              // level 0's f and 1 / g: Table0
      p.lv[l].f = w; w += n[l];
      p.lv[l].g = w; w += n[l];
    }
    p.lv[l].h = w; w += (int64_t)n[l] * R;
  }
  p.lv[0].x = static_cast<T*>(out);
  for (int l = 1; l <= p.L; ++l) {
    p.lv[l].a = w; w += n[l];
    p.lv[l].b = w; w += n[l];
    p.lv[l].c = w; w += n[l];
    p.lv[l].d = w; w += (int64_t)n[l] * R;
    p.lv[l].x = w; w += (int64_t)n[l] * R;
  }
  return p;
}

template <typename T, bool CROSS>
__device__ inline LevelN<T, CROSS> level(const Arrays<T>& a, int R) {
  return LevelN<T, CROSS>{a.a, a.b, a.c, a.d, a.n, R};
}

// The chunks' slots of one block: kUnit chunks at a time.
template <typename T>
struct Slots {
  T f[kUnit][kChunk], g[kUnit][kChunk], c[kUnit][kChunk];
  __device__ Slot<T> operator[](int jl) { return Slot<T>{f[jl], g[jl], c[jl]}; }
};

// Levels 3 .. L by one block: reduce each level l < L in chunks of kChunk
// rows (a thread a (chunk, column), kUnit chunks a pass), Thomas on level
// L, then expand L-1 .. 3; level 3 was written by every block (CROSS).
template <typename T>
__device__ void solve_deep(const Plan<T>& p, int R, Slots<T>& slots, BaseSmem<T>& base) {
  const int TC = col_threads(R);
  const int jl = threadIdx.x / TC, lane = threadIdx.x % TC;
  for (int l = 3; l < p.L; ++l) {
    const int n = p.lv[l].n, P = p.lv[l + 1].n / 2;
    // a pass of kUnit chunks and TC columns at a time: a chunk's slot is
    // rewritten only after the barrier that ends the pass reading it
    for (int j0 = 0; j0 < P; j0 += kUnit) {
      for (int c0 = 0; c0 < R; c0 += TC) {
        const int j = j0 + jl, col = c0 + lane;
        if (j < P && col < R) {
          int s, e;
          chunk_rows(j, n, P, &s, &e);
          const Reduced<T> r =
              l == 3 ? reduce_chunk<kGroup>(level<T, true>(p.lv[l], R), s, e, col, p.lv[l],
                                               slots[jl])
                     : reduce_chunk<kGroup>(level<T, false>(p.lv[l], R), s, e, col, p.lv[l],
                                               slots[jl]);
          put_rows(p.lv[l + 1], j, col, R, r);
        }
        __syncthreads();
      }
    }
  }
  if (p.L == 3)
    base_solve(level<T, true>(p.lv[3], R), p.lv[3].n, p.lv[3].x, base);
  else
    base_solve(level<T, false>(p.lv[p.L], R), p.lv[p.L].n, p.lv[p.L].x, base);
  for (int l = p.L - 1; l >= 3; --l) {
    const int n = p.lv[l].n, P = p.lv[l + 1].n / 2;
    for (int j = jl; j < P; j += kUnit) {
      int s, e;
      chunk_rows(j, n, P, &s, &e);
      for (int col = lane; col < R; col += TC) {
        if (l == 3)
          expand_chunk<kGroup>(level<T, true>(p.lv[l], R), s, e, col, j, p.lv[l],
                                  p.lv[l + 1].x);
        else
          expand_chunk<kGroup>(level<T, false>(p.lv[l], R), s, e, col, j, p.lv[l],
                                  p.lv[l + 1].x);
      }
    }
    __syncthreads();
  }
}

// The whole solve, one launch (phases A, B, C above). Blocks of kUnit * TC
// threads; a grid of at most the blocks the card holds at once.
template <typename T>
__global__ void __launch_bounds__(kUnit * kCols, 1)
tridiag_kernel(Level0<T> top, Plan<T> p, unsigned* __restrict__ words) {
  __shared__ Slots<T> slots;
  __shared__ T u1a[2 * kUnit], u1b[2 * kUnit], u1c[2 * kUnit], u1d[2 * kUnit * kCols];
  __shared__ BaseSmem<T> base;
  __shared__ Table0<T> table0;
  top.load();
  const int N = top.n, R = top.R, TC = col_threads(R);
  if (p.L == 0) {                              // N <= kBase: one block, Thomas
    base_solve(top, N, p.lv[0].x, base);
    return;
  }
  unsigned gen0 = 0;
  if (threadIdx.x == 0) {
    gen0 = *reinterpret_cast<volatile unsigned*>(words + 1);
    make_table0(top, table0);
  }
  __syncthreads();
  const int jl = threadIdx.x / TC, lane = threadIdx.x % TC;
  const int P0 = p.lv[1].n / 2, U = p.lv[2].n / 2;
  const int u0 = blockIdx.x * p.ups, u1 = min(u0 + p.ups, U);   // this block's units
  const Arrays<T>&l0 = p.lv[0], &l1 = p.lv[1], &l2 = p.lv[2], &l3 = p.lv[3];
  // A: each unit's level-0 chunks to level 1 (its rows in shared memory,
  // c also in the workspace for step 3), its level-1 rows to level 2,
  // kCols columns at a time; then the block's level-2 rows to level 3
  for (int u = u0; u < u1; ++u) {
    const int j = u * kUnit + jl;
    const int s1 = 2 * u * kUnit, e1 = 2 * min((u + 1) * kUnit, P0) - 1;
    for (int c0 = 0; c0 < R; c0 += TC) {
      const int col = c0 + lane;
      if (j < P0 && col < R) {
        int s, e;
        chunk_rows(j, N, P0, &s, &e);
        const Reduced<T> r = reduce_chunk0(top, table0, s, e, col, l0);
        u1a[2 * jl] = r.a0;
        u1b[2 * jl] = r.b0;
        u1c[2 * jl] = r.c0;
        u1d[2 * jl * kCols + lane] = r.d0;
        u1a[2 * jl + 1] = r.a1;
        u1b[2 * jl + 1] = r.b1;
        u1c[2 * jl + 1] = r.c1;
        u1d[(2 * jl + 1) * kCols + lane] = r.d1;
        l1.c[2 * j] = r.c0;
        l1.c[2 * j + 1] = r.c1;
      }
      __syncthreads();                         // the unit's level-1 rows
      if (jl == 0 && col < R) {
        const LevelS<T> lv1{u1a, u1b, u1c, u1d, s1, c0, R};
        put_rows(l2, u, col, R, reduce_chunk<kGroup>(lv1, s1, e1, col, l1, slots[0]));
      }
      __syncthreads();                         // before the next columns' rows
    }
  }
  const LevelN<T, false> lv2 = level<T, false>(l2, R);
  if (jl == 0)
    for (int col = lane; col < R; col += TC)
      put_rows(l3, blockIdx.x, col, R, reduce_long(lv2, 2 * u0, 2 * u1 - 1, col, l2));
  // B: the last block solves level 3 and publishes it
  if (last_block_to_finish(words)) {
    solve_deep(p, R, slots, base);
    __threadfence();                           // level 3's solution, device-wide
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(words + 1, 1u);
  } else {
    if (threadIdx.x == 0) {
      while (*reinterpret_cast<volatile unsigned*>(words + 1) == gen0) __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
  }
  // C: the block's level-2 rows from level 3, then each unit's level-1 rows
  // from level 2, its level-0 rows from level 1
  if (jl == 0)
    for (int col = lane; col < R; col += TC)
      expand_chunk<kGroup>(lv2, 2 * u0, 2 * u1 - 1, col, blockIdx.x, l2, l3.x);
  __syncthreads();                             // the block's level-2 solution
  const LevelN<T, false> lv1 = level<T, false>(l1, R);
  for (int u = u0; u < u1; ++u) {
    if (jl == 0) {
      const int s = 2 * u * kUnit, e = 2 * min((u + 1) * kUnit, P0) - 1;
      for (int col = lane; col < R; col += TC)
        expand_chunk<kGroup>(lv1, s, e, col, u, l1, l2.x);
    }
    __syncthreads();                           // the unit's level-1 solution
    const int j = u * kUnit + jl;
    if (j < P0) {
      int s, e;
      chunk_rows(j, N, P0, &s, &e);
      for (int col = lane; col < R; col += TC)
        expand_chunk0(top, table0, s, e, col, j, l0, l1.x);
    }
  }
}

// The blocks of `threads` that the card holds at once, kept per (threads,
// dtype, device): the occupancy query costs host time comparable to a
// short kernel.
template <typename T>
cudaError_t resident_blocks(int threads, int* blocks) {
  struct Entry { int threads, dev, blocks; };
  static Entry cache[kCols];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < used; ++i)
    if (cache[i].threads == threads && cache[i].dev == dev) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tridiag_kernel<T>, threads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  cache[used % kCols] = {threads, dev, *blocks};
  used = used < kCols ? used + 1 : used;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_tridiag(const void* y, const void* rho, void* out, int N, int R,
                           double two_lam, void* ws, cudaStream_t st) {
  const Level0<T> top{static_cast<const T*>(y), static_cast<const T*>(rho), (T)two_lam,
                      N, R, T(0)};
  const int threads = kUnit * col_threads(R);
  // ups units a block, in a grid of at most the resident blocks (and
  // kMaxGrid), every block with work
  int grid = 1, ups = 1;
  if (N > kBase) {
    cudaError_t e = resident_blocks<T>(threads, &grid);
    if (e != cudaSuccess) return e;
    const int P0 = (N + kChunk - 1) / kChunk, U = (P0 + kUnit - 1) / kUnit;
    grid = std::min(std::min(grid, kMaxGrid), U);
    ups = (U + grid - 1) / grid;
    grid = (U + ups - 1) / ups;
  }
  const Plan<T> p = plan<T>(N, R, ups, out, ws);
  tridiag_kernel<T><<<grid, threads, 0, st>>>(top, p, static_cast<unsigned*>(ws));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. y: [N, R] row-major; rho: one element of
// the same dtype in device memory; out: [N, R], not aliasing y; two_lam:
// 2 lam; ws: spartan_tridiag_workspace elements of the dtype, zeroed before
// its first call (a call leaves its counter at 0). Needs N >= 2, R >= 1.
// Returns a cudaError_t (0 = success).
int spartan_tridiag_solve(int dtype, const void* y, const void* rho, void* out, int N, int R,
                          double two_lam, void* ws, void* stream) {
  if (N < 2 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_tridiag<float>(y, rho, out, N, R, two_lam, ws, st);
  if (dtype == 1) return (int)launch_tridiag<double>(y, rho, out, N, R, two_lam, ws, st);
  return (int)cudaErrorInvalidValue;
}

// The elements of workspace a call for N unknowns and R columns needs; -1
// for N < 2, R < 1, another dtype or a count past an int.
int spartan_tridiag_workspace(int dtype, int N, int R) {
  if (N < 2 || R < 1 || (dtype != 0 && dtype != 1)) return -1;
  const int64_t n = dtype == 0 ? workspace_elems<float>(N, R) : workspace_elems<double>(N, R);
  return n > INT32_MAX ? -1 : (int)n;
}

// The kernels one call enqueues: 1.
int spartan_tridiag_kernels(int N) { return N < 2 ? -1 : 1; }

}  // extern "C"
