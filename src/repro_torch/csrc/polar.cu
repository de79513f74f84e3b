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
// Precision: a Gram is solved in double whatever T (float or double) is,
// then rounded to T. Any backward-stable float eigensolver departs from the
// exact P_inv by about R * kappa(G) * 2^-24 of max |P_inv|, past 1e-6 at R
// >= 40 even for kappa near 1 (chip_smoke.py prints what a float eigh
// reads), so only a double solve rounds to P_inv within float's tolerance;
// the plain version (kernels/polar.py) solves in double for the same
// reason. The kernel's time is its launch and its dependent chains, not its
// arithmetic, so the double solve costs little.
//
// Method: cyclic Jacobi. A rotation in the plane (p, q) with t = tan(theta)
// the smaller root of t^2 + 2 tau t - 1 = 0, tau = (a_qq - a_pp) / (2 a_pq),
// zeroes a_pq: rows and columns p, q of A turn, a_pp -= t a_pq, a_qq += t
// a_pq, and the columns p, q of E (= the product of the rotations) turn
// alike. A subject stops when the off-diagonal Frobenius mass of A is at
// most DBL_EPSILON * ||G||_F, or after kMaxSweeps sweeps; both are decided
// on the device. Its eigenvalues are then diag(A), its eigenvectors the
// columns of E.
//
// Two designs:
//   R <= 8 (the main path's R = 5): a thread a subject, A and E in registers
//     (R is a template argument, so every index is a constant); a sweep
//     rotates the pairs (p, q), p < q, in row order, one after another.
//   R > 8: a block a subject, on a persistent grid that walks the subjects;
//     A and E in shared memory or, past what a block holds (R > 119 in
//     double), in the caller's global workspace, one slot a block. A sweep
//     is R' - 1 rounds of R' / 2 disjoint pairs (a round-robin tournament,
//     R' = R rounded up to even; an odd R's phantom index sits out its
//     pair): a thread a pair finds its rotation, then the block turns every
//     pair's rows (and E's columns), then every pair's columns, then sets
//     each pair's 2 x 2 block exactly.
//
// Bound on an H100: 2 K R^2 elements of T moved (G read once, P_inv written
// once; 11.6 MB at the main path's largest bucket, K = 58,112, R = 5, f32:
// 0.0035 ms at 3.35 TB/s). The launch (~0.002 ms) and one thread's chain of
// dependent double rotations set its time.
#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxSweeps = 50;          // a sweep cap; double Jacobi takes 5-12 here
constexpr int kThreadsPerSubject = 128; // R <= 8: threads a block, a thread a subject
constexpr int kWorkspaceBlocks = 264;   // R > 119: blocks (workspace slots) at most

// The variants, as spartan_gram_inv_sqrt_variant reports them.
constexpr int kThreadPerSubject = 0, kBlockShared = 1, kBlockWorkspace = 2;

struct Rotation {
  double c, s, t;
};

// The rotation that zeroes a_pq (the identity for a_pq == 0). Where tau^2
// would overflow, t = a_pq / (a_qq - a_pp), its limit.
__device__ inline Rotation rotation(double app, double aqq, double apq) {
  Rotation r{1.0, 0.0, 0.0};
  if (apq == 0.0) return r;
  const double h = aqq - app;
  if (fabs(apq) <= fabs(h) * (DBL_EPSILON * DBL_EPSILON)) {
    r.t = apq / h;
  } else {
    const double tau = h / (2.0 * apq);
    r.t = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + sqrt(1.0 + tau * tau));
  }
  r.c = 1.0 / sqrt(1.0 + r.t * r.t);
  r.s = r.t * r.c;
  return r;
}

// The reference's clamp of eigenvalue lam, given the largest clamped one.
__device__ inline double inv_root(double lam, double lam_max, double eps) {
  const double scale = fmax(lam, 0.0), tol = lam_max * eps;
  return scale > tol ? 1.0 / sqrt(fmax(scale, tol)) : 0.0;
}

// R <= 8: a thread a subject, A and E in registers.
template <typename T, int R>
__global__ void __launch_bounds__(kThreadsPerSubject)
jacobi_thread_kernel(const T* __restrict__ g, T* __restrict__ out, int K, double eps) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const T* gk = g + (int64_t)k * R * R;
  double a[R][R], e[R][R];
  double norm2 = 0.0;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      a[i][j] = (double)gk[i * R + j];
      e[i][j] = i == j ? 1.0 : 0.0;
      norm2 += a[i][j] * a[i][j];
    }
  const double stop = DBL_EPSILON * sqrt(norm2);
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off2 = 0.0;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (i != j) off2 += a[i][j] * a[i][j];
    if (sqrt(off2) <= stop) break;
#pragma unroll
    for (int p = 0; p < R - 1; ++p)
#pragma unroll
      for (int q = p + 1; q < R; ++q) {
        const double app = a[p][p], aqq = a[q][q], apq = a[p][q];
        const Rotation r = rotation(app, aqq, apq);
#pragma unroll
        for (int m = 0; m < R; ++m) {
          if (m == p || m == q) continue;
          const double amp = a[m][p], amq = a[m][q];
          a[m][p] = a[p][m] = r.c * amp - r.s * amq;
          a[m][q] = a[q][m] = r.s * amp + r.c * amq;
        }
        a[p][p] = app - r.t * apq;
        a[q][q] = aqq + r.t * apq;
        a[p][q] = a[q][p] = 0.0;
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const double emp = e[m][p], emq = e[m][q];
          e[m][p] = r.c * emp - r.s * emq;
          e[m][q] = r.s * emp + r.c * emq;
        }
      }
  }
  double lam_max = 0.0, ir[R];
#pragma unroll
  for (int l = 0; l < R; ++l) lam_max = fmax(lam_max, fmax(a[l][l], 0.0));
#pragma unroll
  for (int l = 0; l < R; ++l) ir[l] = inv_root(a[l][l], lam_max, eps);
  T* ok = out + (int64_t)k * R * R;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = r; m < R; ++m) {   // P_inv is symmetric: one sum for both entries
      double s = 0.0;
#pragma unroll
      for (int l = 0; l < R; ++l) s += e[r][l] * ir[l] * e[m][l];
      ok[r * R + m] = ok[m * R + r] = (T)s;
    }
}

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

// Pair i of round `rnd` of the round-robin tournament of n (even)
// players: player n - 1 stays, the others turn; p < q. Every pair of players
// meets once in rounds 0 .. n - 2.
__device__ inline void tournament_pair(int rnd, int i, int n, int* p, int* q) {
  const int m = n - 1;
  const int x = i == 0 ? m : (i + rnd) % m;
  const int y = i == 0 ? rnd % m : (m - i + rnd) % m;
  *p = min(x, y);
  *q = max(x, y);
}

// The doubles of a block's shared memory at rank R: six per pair (the
// rotation and the pair's 2 x 2 block), R inverse roots, 32 warp partials,
// and A and E unless they live in the workspace.
__host__ __device__ inline int64_t block_smem_doubles(int R, bool with_matrices) {
  const int64_t half = (R + 1) / 2;
  return 6 * half + R + 32 + (with_matrices ? 2 * (int64_t)R * R : 0);
}

// R > 8: a block a subject; A and E in shared memory (ws == nullptr) or in
// workspace slot blockIdx.x (2 R^2 doubles a slot).
template <typename T>
__global__ void __launch_bounds__(256)
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
          const Rotation r = rotation(papp[i], paqq[i], papq[i]);
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
  return block_smem_doubles(R, true) * 8 <= kMaxDynamicSmem ? kBlockShared : kBlockWorkspace;
}

int block_threads(int R) { return R <= 16 ? 128 : 256; }

template <typename T, int R>
cudaError_t launch_thread(const void* g, void* out, int K, double eps, cudaStream_t stream) {
  const int blocks = (K + kThreadsPerSubject - 1) / kThreadsPerSubject;
  jacobi_thread_kernel<T, R><<<blocks, kThreadsPerSubject, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(out), K, eps);
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
  const bool in_smem = variant_for(R) == kBlockShared;
  if (!in_smem && ws == nullptr) return cudaErrorInvalidValue;
  auto kernel = jacobi_block_kernel<T>;
  const size_t smem = block_smem_doubles(R, in_smem) * sizeof(double);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int threads = block_threads(R);
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
// block a subject with A and E in shared memory, 2 the same in the global
// workspace; -1 for R < 1.
int spartan_gram_inv_sqrt_variant(int R) { return R < 1 ? -1 : variant_for(R); }

}  // extern "C"
