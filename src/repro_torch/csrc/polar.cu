// P1: the inverse square root of the Procrustes step's Gram matrices, for
// Hopper (sm_90a).
//
//   gram_inv_sqrt   P_inv[k] = E_k diag(inv_root_k) E_k^T        [K, R, R]
//
// from G[k] = B_k^T B_k = E_k diag(lambda_k) E_k^T, symmetric, so that the
// caller's Q_k = B_k P_inv[k] is the polar factor of B_k (the Gram-eigh
// polar, repro_torch/core/procrustes.py). The reference computes this with
// jnp.linalg.eigh inside its compiled program (src/repro/core/procrustes.py:
// polar_gram_eigh); no Pallas kernel replaces it there, so this kernel is
// the port's own. Its inverse root is the reference's clamp
// (procrustes.py:41-45):
//
//   scale = max(lambda, 0); tol = max(scale) * eps;
//   inv_root = scale > tol ? 1 / sqrt(max(scale, tol)) : 0,
//
// so an all-zero G (a padded subject) gives P_inv = 0 exactly, never NaN.
// P_inv does not depend on the order or the signs of the eigenvectors, so it
// agrees with torch.linalg.eigh's to rounding.
//
// Why a kernel: torch.linalg.eigh on a CUDA batch reads its error flags back
// to the host (a device sync each call, which a CUDA graph cannot capture),
// and cuSOLVER refused the main path's largest bucket (58,112 5x5 Grams) in
// one call. This kernel takes any K and any R, decides each subject's
// convergence on the device and is one launch a call.
//
// Precision: the result is that of a double solve whatever T (float or
// double) is, then rounded to T. Any backward-stable float eigensolver
// departs from the exact P_inv by about R * kappa(G) * 2^-24 of max |P_inv|,
// past 1e-6 at R >= 40 even for kappa near 1 (chip_smoke.py prints what a
// float eigh reads), so a float solve alone cannot round to P_inv within
// float's tolerance; the plain version (kernels/polar.py) solves in double
// for the same reason.
//
// Method: cyclic Jacobi in two stages. A rotation in the plane (p, q) with t
// = tan(theta) the smaller root of t^2 + 2 tau t - 1 = 0, tau = (a_qq -
// a_pp) / (2 a_pq), zeroes a_pq: rows and columns p, q of A turn, a_pp -= t
// a_pq, a_qq += t a_pq, and the columns p, q of E (= the product of the
// rotations) turn alike; c, s and t come from two reciprocal square roots
// (rotation(), no division). G is first scaled by 2^-e (e even, max |g| in
// [1/4, 1)), which is exact and undone exactly on the inverse roots.
//   1. float: sweeps on G 2^-e in float until off(A) <= 16 FLT_EPSILON
//      ||G||_F (off: the off-diagonal Frobenius norm), at most 30 sweeps:
//      float arithmetic runs at twice double's rate and rsqrtf is one
//      instruction, and most of Jacobi's sweeps are spent here.
//   2. double: E = the float eigenvectors made orthonormal by modified
//      Gram-Schmidt, A = E^T G E (diagonal to about 1e-6 of ||G|| where G's
//      spectrum is spread out), then double sweeps until off(A) <=
//      DBL_EPSILON ||G||_F, at most 50: near the diagonal Jacobi converges
//      quadratically, so one or two sweeps where the float stage resolved
//      the spectrum; a cluster of eigenvalues under float's resolution (the
//      null space of a singular Gram, rounded to ~1e-8 of ||G||) is resolved
//      here, in as many sweeps as Jacobi needs for it.
// Both stopping rules are decided on the device, a subject at a time; the
// eigenvalues are then diag(A), the eigenvectors the columns of E.
//
// Designs (spartan_gram_inv_sqrt_variant):
//   R <= 8 (the main path's R = 5): a thread a subject, A's upper triangle
//     and E in registers (R is a template argument, so every index is a
//     constant). A sweep is R' - 1 rounds of R' / 2 disjoint pairs (a
//     round-robin tournament, R' = R rounded up to even; an odd R's phantom
//     index sits out its pair); a round's rotations are found first, so
//     that their dependent chains run side by side.
//   8 < R <= 64 (the paper's 10, 20 and 40): a warp a subject, up to four
//     subjects a block, A and E in shared memory with an odd row stride (no
//     bank conflicts down a column). A round: lane i finds pair i's rotation
//     and sets the pair's 2 x 2 block exactly; the lanes (over the columns)
//     turn rows p, q of A and columns p, q of E pair by pair, each (c, s)
//     from lane i by a shuffle; then columns p, q of A. Three __syncwarp a
//     round, no block barrier; the float stage's A and E take the double
//     A's room, and E^T G E is formed in place through one vector.
//   R > 64: a block a subject in double alone (one stage), on a persistent
//     grid that walks the subjects; A and E in shared memory or, past what
//     a block holds (R > 119), in the caller's global workspace, one slot a
//     block; the block turns every pair's rows, then every pair's columns,
//     with __syncthreads between.
//
// Bound on an H100: 2 K R^2 elements of T moved (G read once, P_inv written
// once; 11.6 MB at the main path's largest bucket, K = 58,112, R = 5, f32:
// 0.0035 ms at 3.35 TB/s), or the 9 R^3 operations a Gram of an
// eigendecomposition (chip_smoke.py's p1_work; operations from R = 20 on).
// Jacobi does several times the operations of that count, and a sweep's
// rotations form a dependent chain, so what sets the time is the
// arithmetic of the sweeps: at R <= 8 one thread's chain of rotations (the
// float stage cuts the double work several-fold), at 8 < R <= 64 the warp's
// shared-memory traffic, ~6 R^2 accesses a round. Measured on an H100 SXM
// (700 W) by `python -m repro_torch.launch.kernel_ab` on the main path's
// own Grams at K = 58,112 (f32), in a CUDA graph: R = 5 0.027 ms (13% of
// its 0.0035 ms bound), R = 10 3.6 ms, R = 20 15.0 ms, R = 40 130 ms; the
// double-only designs before these took 0.050, 5.5, 42 and 314 ms.
#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxSweeps = 50;            // the double stage's cap
constexpr int kMaxSweeps32 = 30;          // the float stage's cap; it takes 3-6 here
constexpr float kStop32 = 16.0f * FLT_EPSILON;   // the float stage stops at off <= kStop32 ||G||
constexpr int kThreadsPerSubject = 128;   // R <= 8: threads a block, a thread a subject
constexpr int kWarpMaxRank = 64;          // R <= 64: a warp a subject
constexpr int kWarpsPerBlock = 4;         // at most; fewer where shared memory is short
constexpr int kBlockThreads = 256;        // R > 64: threads a block, a block a subject
constexpr int kWorkspaceBlocks = 264;     // R > 119: blocks (workspace slots) at most

// The variants, as spartan_gram_inv_sqrt_variant reports them.
constexpr int kThreadPerSubject = 0, kWarpPerSubject = 1, kBlockShared = 2, kBlockWorkspace = 3;

__device__ inline float rsqrt_(float x) { return rsqrtf(x); }
__device__ inline double rsqrt_(double x) { return rsqrt(x); }

// Below this |a_pq| a pair is left as it is: the matrices are scaled to max
// |g| < 1, so such an entry is far under either stage's stopping rule, and
// the rotation's arithmetic stays clear of underflow.
template <typename F> __device__ inline F tiny();
template <> __device__ inline float tiny<float>() { return 1e-18f; }
template <> __device__ inline double tiny<double>() { return 1e-150; }

template <typename F>
struct Rot {
  F c, s, t;
};

// The rotation that zeroes a_pq, from y = 1 / sqrt(h^2 + 4 a_pq^2) (h = a_qq
// - a_pp): c^2 = (1 + |h| y) / 2, s = sign(h) a_pq y / c, t = s / c, the
// smaller root of t^2 + 2 tau t - 1 = 0 (tau = h / (2 a_pq)); two reciprocal
// square roots and no division, and no cancellation at any angle.
template <typename F>
__device__ inline Rot<F> rotation(F app, F aqq, F apq) {
  Rot<F> r{F(1), F(0), F(0)};
  if (fabs(apq) <= tiny<F>()) return r;
  const F h = aqq - app;
  const F y = rsqrt_(h * h + F(4) * apq * apq);
  const F x = F(0.5) + F(0.5) * fabs(h) * y;
  const F z = rsqrt_(x);                        // 1 / c
  r.c = x * z;
  r.s = (h < F(0) ? -apq : apq) * y * z;
  r.t = r.s * z;
  return r;
}

// The reference's clamp of eigenvalue lam, given the largest clamped one.
__device__ inline double inv_root(double lam, double lam_max, double eps) {
  const double scale = fmax(lam, 0.0), tol = lam_max * eps;
  return scale > tol ? 1.0 / sqrt(fmax(scale, tol)) : 0.0;
}

// The even exponent e with max |g| * 2^-e in [1/4, 1) (0 for max |g| = 0):
// scaling by 2^-e is exact, keeps the float stage clear of overflow and
// underflow, and 1 / sqrt(lambda) = 2^(-e/2) / sqrt(lambda 2^-e) exactly.
__device__ inline int even_exponent(double max_abs) {
  int e = 0;
  frexp(max_abs, &e);
  return e + (e & 1);
}

// Pair i of round `rnd` (0 <= rnd < n - 1) of the round-robin tournament of
// n (even) players: player n - 1 stays, the others turn; p < q. Every pair
// of players meets once in rounds 0 .. n - 2, and a round's pairs are
// disjoint.
__host__ __device__ constexpr int pair_x(int rnd, int i, int n) {
  return i == 0 ? n - 1 : (i + rnd >= n - 1 ? i + rnd - (n - 1) : i + rnd);
}
__host__ __device__ constexpr int pair_y(int rnd, int i, int n) {
  return i == 0 ? rnd : (n - 1 - i + rnd >= n - 1 ? rnd - i : n - 1 - i + rnd);
}
__device__ inline void tournament_pair(int rnd, int i, int n, int* p, int* q) {
  const int x = pair_x(rnd, i, n), y = pair_y(rnd, i, n);
  *p = min(x, y);
  *q = max(x, y);
}

// ---- R <= 8: a thread a subject, A (its upper triangle) and E in registers

template <int R>
__host__ __device__ constexpr int tri(int i, int j) {   // A(i, j) in the upper triangle
  return i <= j ? i * R - i * (i - 1) / 2 + (j - i) : j * R - j * (j - 1) / 2 + (i - j);
}

// One sweep of R' - 1 rounds (R' = R rounded up to even); a round's disjoint
// pairs take their rotations first, so that their chains run side by side.
template <typename F, int R>
__device__ __forceinline__ void thread_sweep(F (&a)[R * (R + 1) / 2], F (&v)[R][R]) {
  constexpr int N = R + (R & 1), H = N / 2;
#pragma unroll
  for (int rnd = 0; rnd < N - 1; ++rnd) {
    Rot<F> r[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int x = pair_x(rnd, i, N), y = pair_y(rnd, i, N);
      const int p = x < y ? x : y, q = x < y ? y : x;
      if (q < R) r[i] = rotation<F>(a[tri<R>(p, p)], a[tri<R>(q, q)], a[tri<R>(p, q)]);
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int x = pair_x(rnd, i, N), y = pair_y(rnd, i, N);
      const int p = x < y ? x : y, q = x < y ? y : x;
      if (q >= R) continue;                     // the phantom's pair
      const F c = r[i].c, s = r[i].s, t = r[i].t;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (m == p || m == q) continue;
        const F amp = a[tri<R>(m, p)], amq = a[tri<R>(m, q)];
        a[tri<R>(m, p)] = c * amp - s * amq;
        a[tri<R>(m, q)] = s * amp + c * amq;
      }
      const F apq = a[tri<R>(p, q)];
      a[tri<R>(p, p)] -= t * apq;
      a[tri<R>(q, q)] += t * apq;
      a[tri<R>(p, q)] = F(0);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const F vmp = v[m][p], vmq = v[m][q];
        v[m][p] = c * vmp - s * vmq;
        v[m][q] = s * vmp + c * vmq;
      }
    }
  }
}

// Sweeps until off(A) <= stop (off: the off-diagonal Frobenius norm) or
// max_sweeps.
template <typename F, int R>
__device__ __forceinline__ void thread_jacobi(F (&a)[R * (R + 1) / 2], F (&v)[R][R], F stop,
                                              int max_sweeps) {
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    F off = 0;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = i + 1; j < R; ++j) off += a[tri<R>(i, j)] * a[tri<R>(i, j)];
    if (F(2) * off <= stop * stop) break;
    thread_sweep<F, R>(a, v);
  }
}

// The shared memory of a block of the thread design: its subjects' Grams
// (then their results), a row of R^2 | 1 elements each, so that the threads'
// rows start in different banks.
template <typename T, int R>
constexpr size_t thread_smem_bytes() {
  return (size_t)kThreadsPerSubject * ((R * R) | 1) * sizeof(T);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreadsPerSubject)
jacobi_thread_kernel(const T* __restrict__ g, T* __restrict__ out, int K, double eps) {
  constexpr int NT = R * (R + 1) / 2, RR = R * R, LD = RR | 1;
  extern __shared__ double smem[];
  T* rows = reinterpret_cast<T*>(smem);        // [kThreadsPerSubject, LD]
  const int k0 = blockIdx.x * kThreadsPerSubject;
  const int n = min(kThreadsPerSubject, K - k0);
  // the block's Grams in, coalesced (a thread's own subject is strided R^2)
  for (int u = threadIdx.x; u < n * RR; u += kThreadsPerSubject)
    rows[u / RR * LD + u % RR] = g[(int64_t)k0 * RR + u];
  __syncthreads();
  T* gk = rows + threadIdx.x * LD;              // G(i, j) = gk[i * R + j] for i >= j
  if (threadIdx.x < n) {
    double max_abs = 0.0;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) max_abs = fmax(max_abs, fabs((double)gk[i * R + j]));
    const int ex = even_exponent(max_abs);
    const double scale = ldexp(1.0, -ex);
    // the float stage: cyclic Jacobi on G 2^-e until off <= kStop32 ||G 2^-e||
    float a32[NT], v32[R][R];
    double norm2 = 0.0;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const double x = (double)gk[i * R + j] * scale;
        a32[tri<R>(j, i)] = (float)x;
        norm2 += (i == j ? 1.0 : 2.0) * x * x;
      }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) v32[i][j] = i == j ? 1.0f : 0.0f;
    thread_jacobi<float, R>(a32, v32, kStop32 * (float)sqrt(norm2), kMaxSweeps32);
    // the double stage: E = the float eigenvectors made orthonormal (modified
    // Gram-Schmidt), A = E^T G E, then double sweeps to off <= DBL_EPSILON ||G||
    double e[R][R], a[NT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) e[i][j] = (double)v32[i][j];
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int i = 0; i < j; ++i) {
        double d = 0.0;
#pragma unroll
        for (int m = 0; m < R; ++m) d += e[m][i] * e[m][j];
#pragma unroll
        for (int m = 0; m < R; ++m) e[m][j] -= d * e[m][i];
      }
      double n2 = 0.0;
#pragma unroll
      for (int m = 0; m < R; ++m) n2 += e[m][j] * e[m][j];
      const double inv = rsqrt(n2);
#pragma unroll
      for (int m = 0; m < R; ++m) e[m][j] *= inv;
    }
    double gd[NT];                                // G 2^-e in double, converted once
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) gd[tri<R>(j, i)] = (double)gk[i * R + j] * scale;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      double tj[R];                               // (G E)[:, j]
#pragma unroll
      for (int m = 0; m < R; ++m) {
        double s = 0.0;
#pragma unroll
        for (int l = 0; l < R; ++l) s += gd[tri<R>(m, l)] * e[l][j];
        tj[m] = s;
      }
#pragma unroll
      for (int i = 0; i <= j; ++i) {
        double s = 0.0;
#pragma unroll
        for (int m = 0; m < R; ++m) s += e[m][i] * tj[m];
        a[tri<R>(i, j)] = s;
      }
    }
    thread_jacobi<double, R>(a, e, DBL_EPSILON * sqrt(norm2), kMaxSweeps);
    const double unscale = ldexp(1.0, -ex / 2);
    double lam_max = 0.0, ir[R];
#pragma unroll
    for (int l = 0; l < R; ++l) lam_max = fmax(lam_max, fmax(a[tri<R>(l, l)], 0.0));
#pragma unroll
    for (int l = 0; l < R; ++l) ir[l] = inv_root(a[tri<R>(l, l)], lam_max, eps) * unscale;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = r; m < R; ++m) {   // P_inv is symmetric: one sum for both entries
        double s = 0.0;
#pragma unroll
        for (int l = 0; l < R; ++l) s += e[r][l] * ir[l] * e[m][l];
        gk[r * R + m] = gk[m * R + r] = (T)s;    // over the thread's own Gram
      }
  }
  __syncthreads();
  for (int u = threadIdx.x; u < n * RR; u += kThreadsPerSubject)   // the results out
    out[(int64_t)k0 * RR + u] = rows[u / RR * LD + u % RR];
}

// ---- 8 < R <= 64: a warp a subject, A and E in shared memory (row stride S)

// The warp's sum of v, the same bits in every lane (each butterfly step adds
// the same two partials in every lane of a pair).
template <typename F>
__device__ inline F warp_sum(F v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A round's pairs for the warp design: (p, q) and (c, s) of pair i, in the
// warp's shared memory; q >= R marks the phantom's pair.
template <typename F>
struct Pairs {
  F* c;
  F* s;
  int* p;
  int* q;
};

constexpr int kGroup = 4;   // items a lane takes at once: loads in flight

// Rows p, q of A and columns p, q of E, for every pair i of the round and
// every column m: the half * R items (i, m) spread over the lanes, kGroup
// at a time, each group's entries read before any is written (a round's
// pairs are disjoint, so no two items share an entry). A's entries in a
// pair's own 2 x 2 block are left to the pair's lane.
template <typename F>
__device__ inline void turn_rows(F* A, F* E, const Pairs<F>& pr, int R, int S, int half) {
  const int lane = threadIdx.x & 31, items = half * R;
  Walk w(lane, 32, R);                         // (row, col) = (pair i, column m)
  for (int it = lane; it < items; it += 32 * kGroup) {
    int P[kGroup], Q[kGroup], M[kGroup];
    F c[kGroup], sn[kGroup], ax[kGroup], ay[kGroup], ex[kGroup], ey[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const bool in = it + 32 * u < items;
      const int i = w.row;
      M[u] = w.col;
      w.step();
      P[u] = in ? pr.p[i] : 0;
      Q[u] = in ? pr.q[i] : R;
      if (Q[u] >= R) continue;
      c[u] = pr.c[i];
      sn[u] = pr.s[i];
      if (M[u] != P[u] && M[u] != Q[u]) {
        ax[u] = A[P[u] * S + M[u]];
        ay[u] = A[Q[u] * S + M[u]];
      }
      ex[u] = E[M[u] * S + P[u]];
      ey[u] = E[M[u] * S + Q[u]];
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (Q[u] >= R) continue;
      if (M[u] != P[u] && M[u] != Q[u]) {
        A[P[u] * S + M[u]] = c[u] * ax[u] - sn[u] * ay[u];
        A[Q[u] * S + M[u]] = sn[u] * ax[u] + c[u] * ay[u];
      }
      E[M[u] * S + P[u]] = c[u] * ex[u] - sn[u] * ey[u];
      E[M[u] * S + Q[u]] = sn[u] * ex[u] + c[u] * ey[u];
    }
  }
}

// Columns p, q of A for every pair and row m off the pair's 2 x 2 block,
// as turn_rows spreads its items.
template <typename F>
__device__ inline void turn_columns(F* A, const Pairs<F>& pr, int R, int S, int half) {
  const int lane = threadIdx.x & 31, items = half * R;
  Walk w(lane, 32, R);                         // (row, col) = (pair i, row m)
  for (int it = lane; it < items; it += 32 * kGroup) {
    int P[kGroup], Q[kGroup], M[kGroup];
    F c[kGroup], sn[kGroup], ax[kGroup], ay[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const bool in = it + 32 * u < items;
      const int i = w.row;
      M[u] = w.col;
      w.step();
      P[u] = in ? pr.p[i] : 0;
      Q[u] = in ? pr.q[i] : R;
      if (Q[u] >= R || M[u] == P[u] || M[u] == Q[u]) continue;
      c[u] = pr.c[i];
      sn[u] = pr.s[i];
      ax[u] = A[M[u] * S + P[u]];
      ay[u] = A[M[u] * S + Q[u]];
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (Q[u] >= R || M[u] == P[u] || M[u] == Q[u]) continue;
      A[M[u] * S + P[u]] = c[u] * ax[u] - sn[u] * ay[u];
      A[M[u] * S + Q[u]] = sn[u] * ax[u] + c[u] * ay[u];
    }
  }
}

// Cyclic Jacobi on A [R, S] with E [R, S] (E <- E J) by one warp, until
// off(A) <= stop or max_sweeps. A round: lane i < R'/2 finds pair i's
// rotation, publishes it and sets the pair's 2 x 2 block of A exactly (no
// other lane touches those four entries in the round); then turn_rows and
// turn_columns, a __syncwarp before each and after.
template <typename F>
__device__ void warp_jacobi(F* A, F* E, Pairs<F> pr, int R, int S, F stop, int max_sweeps) {
  const int lane = threadIdx.x & 31, n = R + (R & 1), half = n / 2;
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    F off = 0;
    Walk w(lane, 32, R);
    for (int u = lane; u < R * R; u += 32, w.step())
      if (w.row != w.col) off += A[w.row * S + w.col] * A[w.row * S + w.col];
    if (warp_sum(off) <= stop * stop) break;     // the same answer in every lane
    for (int rnd = 0; rnd < n - 1; ++rnd) {
      if (lane < half) {
        int p, q;
        tournament_pair(rnd, lane, n, &p, &q);
        pr.p[lane] = p;
        pr.q[lane] = q;
        if (q < R) {
          const F app = A[p * S + p], aqq = A[q * S + q], apq = A[p * S + q];
          const Rot<F> r = rotation<F>(app, aqq, apq);
          pr.c[lane] = r.c;
          pr.s[lane] = r.s;
          A[p * S + p] = app - r.t * apq;
          A[q * S + q] = aqq + r.t * apq;
          A[p * S + q] = A[q * S + p] = F(0);
        }
      }
      __syncwarp();
      turn_rows<F>(A, E, pr, R, S, half);
      __syncwarp();
      turn_columns<F>(A, pr, R, S, half);
      __syncwarp();
    }
  }
}

// The doubles of shared memory one warp takes at rank R: A and E [R, S], a
// vector of R, and a round's pairs (32 c, 32 s, 32 + 32 indices).
__host__ __device__ inline int64_t warp_smem_doubles(int R) {
  return 2 * (int64_t)R * (R | 1) + R + 96;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
jacobi_warp_kernel(const T* __restrict__ g, T* __restrict__ out, int K, int R, double eps) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int k = blockIdx.x * (blockDim.x >> 5) + w;
  if (k >= K) return;                           // the whole warp
  const int S = R | 1, RS = R * S;
  double* A = smem + w * warp_smem_doubles(R);  // [R, S]; the float stage's A and E
  double* E = A + RS;                           // [R, S]
  double* vec = E + RS;                         // [R]
  double* prm = vec + R;                        // a round's pairs
  int* pidx = reinterpret_cast<int*>(prm + 64);
  float* A32 = reinterpret_cast<float*>(A);     // [R, S]
  float* E32 = A32 + RS;                        // [R, S]
  float* prm32 = reinterpret_cast<float*>(prm);
  const T* gk = g + (int64_t)k * R * R;         // G(i, j) = gk[i * R + j] for i >= j
  double max_abs = 0.0;
  for (int u = lane; u < R * R; u += 32)
    if (u % R <= u / R) max_abs = fmax(max_abs, fabs((double)gk[u]));
  const int ex = even_exponent(warp_max(max_abs));
  const double scale = ldexp(1.0, -ex);
  double norm2 = 0.0;
  for (int u = lane; u < R * R; u += 32) {
    const int i = u / R, j = u % R;
    E32[i * S + j] = i == j ? 1.0f : 0.0f;
    if (j > i) continue;
    const double x = (double)gk[u] * scale;
    A32[i * S + j] = A32[j * S + i] = (float)x;
    norm2 += (i == j ? 1.0 : 2.0) * x * x;
  }
  norm2 = warp_sum(norm2);
  __syncwarp();
  // the float stage
  warp_jacobi<float>(A32, E32, Pairs<float>{prm32, prm32 + 32, pidx, pidx + 32}, R, S,
                     kStop32 * (float)sqrt(norm2), kMaxSweeps32);
  // E: the float eigenvectors in double, made orthonormal column by column
  // by classical Gram-Schmidt twice (each pass: the projections on the
  // columns before, lanes over them, through vec; then the column less them,
  // lanes over its rows), then normalised
  for (int u = lane; u < R * R; u += 32) {
    const int i = u / R, j = u % R;
    E[i * S + j] = (double)E32[i * S + j];
  }
  for (int j = 0; j < R; ++j) {
    for (int pass = 0; pass < 2 && j > 0; ++pass) {
      __syncwarp();
      for (int i = lane; i < j; i += 32) {
        double d = 0.0;
        for (int m = 0; m < R; ++m) d += E[m * S + i] * E[m * S + j];
        vec[i] = d;
      }
      __syncwarp();
      for (int m = lane; m < R; m += 32) {
        double d = 0.0;
        for (int i = 0; i < j; ++i) d += vec[i] * E[m * S + i];
        E[m * S + j] -= d;
      }
    }
    __syncwarp();
    double n2 = 0.0;
    for (int m = lane; m < R; m += 32) n2 += E[m * S + j] * E[m * S + j];
    const double inv = rsqrt(warp_sum(n2));
    for (int m = lane; m < R; m += 32) E[m * S + j] *= inv;
  }
  __syncwarp();
  // A = E^T G E in place: G 2^-e in A; W = G E row by row, then A = E^T W
  // column by column (the upper triangle, mirrored), each through vec
  for (int u = lane; u < R * R; u += 32) {
    const int i = u / R, j = u % R;
    if (j <= i) A[i * S + j] = A[j * S + i] = (double)gk[u] * scale;
  }
  for (int i = 0; i < R; ++i) {
    __syncwarp();
    for (int l = lane; l < R; l += 32) vec[l] = A[i * S + l];
    __syncwarp();
    for (int j = lane; j < R; j += 32) {
      double s = 0.0;
      for (int l = 0; l < R; ++l) s += vec[l] * E[l * S + j];
      A[i * S + j] = s;
    }
  }
  for (int j = 0; j < R; ++j) {
    __syncwarp();
    for (int m = lane; m < R; m += 32) vec[m] = A[m * S + j];
    __syncwarp();
    for (int i = lane; i <= j; i += 32) {
      double s = 0.0;
      for (int m = 0; m < R; ++m) s += E[m * S + i] * vec[m];
      A[i * S + j] = A[j * S + i] = s;
    }
  }
  __syncwarp();
  // the double stage
  warp_jacobi<double>(A, E, Pairs<double>{prm, prm + 32, pidx, pidx + 32}, R, S,
                      DBL_EPSILON * sqrt(norm2), kMaxSweeps);
  double lam_max = 0.0;                         // every lane, the same order
  for (int l = 0; l < R; ++l) lam_max = fmax(lam_max, fmax(A[l * S + l], 0.0));
  const double unscale = ldexp(1.0, -ex / 2);
  for (int l = lane; l < R; l += 32) vec[l] = inv_root(A[l * S + l], lam_max, eps) * unscale;
  __syncwarp();
  T* ok = out + (int64_t)k * R * R;
  for (int r = 0; r < R; ++r)
    for (int m = r + lane; m < R; m += 32) {    // P_inv is symmetric: one sum for both entries
      double s = 0.0;
      for (int l = 0; l < R; ++l) s += E[r * S + l] * vec[l] * E[m * S + l];
      ok[r * R + m] = ok[m * R + r] = (T)s;
    }
}

// ---- R > 64: a block a subject, in double (A and E in shared memory or a
// global workspace)

// The block's sum of v, the same value in every thread (the partials of the
// warps added in one order). blockDim.x is a multiple of 32.
__device__ inline double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                    // the last call's readers are done with red
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) s += red[w];
  return s;
}

// The doubles of a block's shared memory at rank R: six per pair (the
// rotation and the pair's 2 x 2 block), R inverse roots, 32 warp partials,
// and A and E unless they live in the workspace.
__host__ __device__ inline int64_t block_smem_doubles(int R, bool with_matrices) {
  const int64_t half = (R + 1) / 2;
  return 6 * half + R + 32 + (with_matrices ? 2 * (int64_t)R * R : 0);
}

// R > 64: a block a subject; A and E in shared memory (ws == nullptr) or in
// workspace slot blockIdx.x (2 R^2 doubles a slot).
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
jacobi_block_kernel(const T* __restrict__ g, T* __restrict__ out, int K, int R, double eps,
                    double* __restrict__ ws) {
  extern __shared__ double smem[];
  const int n = R + (R & 1), half = n / 2, RR = R * R;
  double* pc = smem;                  // per pair: c, s, t, a_pp, a_qq, a_pq
  double* ps = pc + half;
  double* pt = ps + half;
  double* papp = pt + half;
  double* paqq = papp + half;
  double* papq = paqq + half;
  double* ir = papq + half;           // [R] inverse roots
  double* red = ir + R;               // [32] warp partials
  double* a = ws != nullptr ? ws + (int64_t)blockIdx.x * 2 * RR : red + 32;
  double* e = a + RR;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = blockIdx.x; k < K; k += gridDim.x) {
    const T* gk = g + (int64_t)k * RR;
    double part = 0.0;
    for (int u = tid; u < RR; u += nt) {
      const double v = (double)gk[u];
      a[u] = v;
      e[u] = u / R == u % R ? 1.0 : 0.0;
      part += v * v;
    }
    const double stop = DBL_EPSILON * sqrt(block_sum(part, red));
    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
      double off = 0.0;
      for (int u = tid; u < RR; u += nt)
        if (u / R != u % R) off += a[u] * a[u];
      if (sqrt(block_sum(off, red)) <= stop) break;   // the same answer in every thread
      for (int rnd = 0; rnd < n - 1; ++rnd) {
        for (int i = tid; i < half; i += nt) {        // 1: each pair's rotation
          int p, q;
          tournament_pair(rnd, i, n, &p, &q);
          if (q >= R) continue;                       // the phantom's pair
          papp[i] = a[p * R + p];
          paqq[i] = a[q * R + q];
          papq[i] = a[p * R + q];
          const Rot<double> r = rotation<double>(papp[i], paqq[i], papq[i]);
          pc[i] = r.c;
          ps[i] = r.s;
          pt[i] = r.t;
        }
        __syncthreads();
        for (int u = tid; u < half * R; u += nt) {    // 2: rows p, q; columns p, q of E
          const int i = u / R, m = u % R;
          int p, q;
          tournament_pair(rnd, i, n, &p, &q);
          if (q >= R) continue;
          const double c = pc[i], s = ps[i];
          const double x = a[p * R + m], y = a[q * R + m];
          a[p * R + m] = c * x - s * y;
          a[q * R + m] = s * x + c * y;
          const double ex = e[m * R + p], ey = e[m * R + q];
          e[m * R + p] = c * ex - s * ey;
          e[m * R + q] = s * ex + c * ey;
        }
        __syncthreads();
        for (int u = tid; u < half * R; u += nt) {    // 3: columns p, q
          const int i = u / R, m = u % R;
          int p, q;
          tournament_pair(rnd, i, n, &p, &q);
          if (q >= R) continue;
          const double c = pc[i], s = ps[i];
          const double x = a[m * R + p], y = a[m * R + q];
          a[m * R + p] = c * x - s * y;
          a[m * R + q] = s * x + c * y;
        }
        __syncthreads();
        for (int i = tid; i < half; i += nt) {        // 4: each pair's 2 x 2 block
          int p, q;
          tournament_pair(rnd, i, n, &p, &q);
          if (q >= R) continue;
          a[p * R + p] = papp[i] - pt[i] * papq[i];
          a[q * R + q] = paqq[i] + pt[i] * papq[i];
          a[p * R + q] = a[q * R + p] = 0.0;
        }
        __syncthreads();
      }
    }
    double lam_max = 0.0;                             // every thread, the same order
    for (int l = 0; l < R; ++l) lam_max = fmax(lam_max, fmax(a[l * R + l], 0.0));
    for (int l = tid; l < R; l += nt) ir[l] = inv_root(a[l * R + l], lam_max, eps);
    __syncthreads();
    T* ok = out + (int64_t)k * RR;
    for (int u = tid; u < RR; u += nt) {
      const int r = u / R, m = u % R;
      if (m < r) continue;            // P_inv is symmetric: one sum for both entries
      double s = 0.0;
      for (int l = 0; l < R; ++l) s += e[r * R + l] * ir[l] * e[m * R + l];
      ok[r * R + m] = ok[m * R + r] = (T)s;
    }
    __syncthreads();                  // before the next subject overwrites A, E and ir
  }
}

int variant_for(int R) {
  if (R <= 8) return kThreadPerSubject;
  if (R <= kWarpMaxRank) return kWarpPerSubject;
  return block_smem_doubles(R, true) * 8 <= kMaxDynamicSmem ? kBlockShared : kBlockWorkspace;
}

template <typename T, int R>
cudaError_t launch_thread(const void* g, void* out, int K, double eps, cudaStream_t stream) {
  auto kernel = jacobi_thread_kernel<T, R>;
  constexpr size_t smem = thread_smem_bytes<T, R>();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (K + kThreadsPerSubject - 1) / kThreadsPerSubject;
  kernel<<<blocks, kThreadsPerSubject, smem, stream>>>(static_cast<const T*>(g),
                                                       static_cast<T*>(out), K, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gram_inv_sqrt(const void* g, void* out, int K, int R, double eps,
                                 double* ws, cudaStream_t stream) {
  switch (R) {
    case 1: return launch_thread<T, 1>(g, out, K, eps, stream);
    case 2: return launch_thread<T, 2>(g, out, K, eps, stream);
    case 3: return launch_thread<T, 3>(g, out, K, eps, stream);
    case 4: return launch_thread<T, 4>(g, out, K, eps, stream);
    case 5: return launch_thread<T, 5>(g, out, K, eps, stream);
    case 6: return launch_thread<T, 6>(g, out, K, eps, stream);
    case 7: return launch_thread<T, 7>(g, out, K, eps, stream);
    case 8: return launch_thread<T, 8>(g, out, K, eps, stream);
    default: break;
  }
  if (variant_for(R) == kWarpPerSubject) {
    auto kernel = jacobi_warp_kernel<T>;
    const size_t per_warp = warp_smem_doubles(R) * sizeof(double);
    const int warps = (int)std::min<size_t>(kWarpsPerBlock, kMaxDynamicSmem / per_warp);
    cudaError_t e = allow_smem(kernel, warps * per_warp);
    if (e != cudaSuccess) return e;
    const int blocks = (K + warps - 1) / warps;
    kernel<<<blocks, 32 * warps, warps * per_warp, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(out), K, R, eps);
    return cudaGetLastError();
  }
  const bool in_smem = variant_for(R) == kBlockShared;
  if (!in_smem && ws == nullptr) return cudaErrorInvalidValue;
  auto kernel = jacobi_block_kernel<T>;
  const size_t smem = block_smem_doubles(R, in_smem) * sizeof(double);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int threads = kBlockThreads;
  int grid = 0;
  if (in_smem) {
    e = persistent_grid(kernel, threads, smem, K, &grid);
    if (e != cudaSuccess) return e;
  } else {
    grid = K < kWorkspaceBlocks ? K : kWorkspaceBlocks;
  }
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(g), static_cast<T*>(out), K,
                                          R, eps, in_smem ? nullptr : ws);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. g: K symmetric R x R Grams; out: P_inv,
// the same shape and dtype; eps: the clamp's relative threshold (the
// reference's 1e-12); ws: the workspace of spartan_gram_inv_sqrt_workspace
// doubles (null where that is 0). Needs K >= 1, R >= 1. Returns a
// cudaError_t (0 = success).
int spartan_gram_inv_sqrt(int dtype, const void* g, void* out, int K, int R, double eps,
                          void* ws, void* stream) {
  if (K < 1 || R < 1) return (int)cudaErrorInvalidValue;
  double* w = static_cast<double*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_gram_inv_sqrt<float>(g, out, K, R, eps, w, st);
  if (dtype == 1) return (int)launch_gram_inv_sqrt<double>(g, out, K, R, eps, w, st);
  return (int)cudaErrorInvalidValue;
}

// The doubles of global workspace a launch for K subjects at rank R needs:
// 0 where A and E fit in shared memory (R <= 119), else 2 R^2 a block; -1
// for K < 1, R < 1 or a count past an int.
int spartan_gram_inv_sqrt_workspace(int K, int R) {
  if (K < 1 || R < 1) return -1;
  if (variant_for(R) != kBlockWorkspace) return 0;
  const int64_t n = (int64_t)(K < kWorkspaceBlocks ? K : kWorkspaceBlocks) * 2 * R * R;
  return n > INT32_MAX ? -1 : (int)n;
}

// The design a launch at rank R takes: 0 a thread a subject (R <= 8), 1 a
// warp a subject (R <= 64), 2 a block a subject with A and E in shared
// memory, 3 the same in the global workspace; -1 for R < 1.
int spartan_gram_inv_sqrt_variant(int R) { return R < 1 ? -1 : variant_for(R); }

}  // extern "C"
