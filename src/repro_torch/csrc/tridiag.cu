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
// `rho` is a scalar in device memory, read by the kernels: the ADMM loop
// computes it on the device (trace(A) / R), and a host value would cost a
// sync every step and could not be captured in a CUDA graph. The arithmetic
// stays in T (float or double), as the reference's does; the matrix is
// symmetric positive definite and diagonally dominant for rho > 0, so no
// pivoting is needed.
//
// Method: the partition method (Wang 1981; the SPIKE family), applied
// recursively. At a level of n unknowns, P = ceil(n / kChunk) chunks of
// contiguous rows s..e (every chunk at least 2 rows) are worked on apart:
//   1. down the chunk (rows s+1..e) the subdiagonal is eliminated, keeping
//      the fill-in column of x_s: row i becomes f_i x_s + g_i x_i + c_i x_{i+1}
//      = h_i; row e is then the chunk's last reduced row;
//   2. up the chunk (rows e-1..s+1) the superdiagonal is eliminated, keeping
//      the fill-in column of x_e, and row s becomes a_s x_{s-1} + beta x_s +
//      gamma x_e = delta, the chunk's first reduced row.
// The 2P reduced rows (x_s and x_e of every chunk, in order) form again a
// tridiagonal system with one matrix for all columns, the Schur complement
// of the interior unknowns, still diagonally dominant; it is reduced the
// same way until at most kBase unknowns remain, which one block solves by
// Thomas (a thread a column). Then every level, deepest first, back-
// substitutes its interior rows from its chunks' x_s and x_e:
//   3. x_i = (h_i - f_i x_s - c_i x_{i+1}) / g_i, rows e-1..s+1.
//
// Threads: one a (chunk, column). A chunk's column threads are neighbouring
// lanes, so a warp's load or store of a row touches the chunk's R columns
// together, one 32-byte sector for R = 5 floats, rather than one cache
// line a lane (a thread a chunk with all its columns reads 32 rows far
// apart at once; its L1 wavefronts, not bytes or arithmetic, held the
// first build to ~35 us a kernel). Past 32 columns a thread takes columns
// c, c + 32, ... in turn. Each column thread follows the matrix recurrence
// itself (the same arithmetic, so the same bits); the chunk's first
// column thread keeps f and g in the workspace for step 2, after a block
// barrier, and for step 3. A pass over a chunk's rows is a dependent
// chain; it takes its rows kGroup at a time and issues every load of a
// group before the group's arithmetic (at N = 116,225, R = 5, float, on an
// H100 80GB HBM3 at 700 W: 0.0726 ms a call in a CUDA graph, against 0.0843
// ms for the same passes a row at a time; launch/kernel_ab.py, --kernels
// tridiag_solve). Level 0 computes its matrix from
// (rho, two_lam) and its right-hand side rho Y on the fly; deeper levels
// read theirs from the workspace.
//
// Launches: one C call (spartan_tridiag_solve) enqueues 2 L + 1 kernels on
// the stream, L the number of reduced levels (N = 116,225: 3; N = 464,900:
// 4; N <= 64: none), with no host sync and no allocation (the caller's
// workspace, spartan_tridiag_workspace elements of T).
//
// Bound on an H100: the bytes, Y read once and Z written once, 2 N R
// sizeof(T) (N = 116,225, R = 5, float: 4.6 MB, 1.4 us at 3.35 TB/s); the
// operations (about 6 N R) are far below the float peak. At that size the
// launches, not the bytes, bound the call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;     // rows a chunk takes at a level
constexpr int kBase = 64;      // at most this many unknowns are solved directly
constexpr int kCols = 32;      // column threads a chunk has at most
constexpr int kThreads = 128;  // threads a reducing or expanding block has at most
constexpr int kGroup = 8;      // rows whose loads a thread issues before their arithmetic

// Level 0: the matrix rho I + two_lam D^T D and the right-hand side rho Y.
// What a kernel only reads goes through the read-only path (__ldg).
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

// A deeper level: its matrix (a, b, c) and right-hand side d, written by
// the level above's reduce_kernel, in the workspace.
template <typename T>
struct LevelN {
  const T* av;
  const T* bv;
  const T* cv;
  const T* dv;
  int n, R;
  __device__ void load() {}
  __device__ T a(int i) const { return __ldg(av + i); }
  __device__ T b(int i) const { return __ldg(bv + i); }
  __device__ T c(int i) const { return __ldg(cv + i); }
  __device__ T d(int i, int r) const { return __ldg(dv + (int64_t)i * R + r); }
};

// The (chunk, column) thread layout of a level with R columns: TC column
// threads a chunk, CB chunks a block.
struct Layout {
  int TC, CB;
  __host__ __device__ explicit Layout(int R)
      : TC(R < kCols ? R : kCols), CB(kThreads / (R < kCols ? R : kCols)) {}
};

__device__ inline void chunk_rows(int j, int n, int P, int* s, int* e) {
  *s = (int)((int64_t)j * n / P);
  *e = (int)((int64_t)(j + 1) * n / P) - 1;
}

// Steps 1 and 2, a thread a (chunk, column): h of rows s+1..e to the
// workspace, f and g by the chunk's first column thread, the two reduced
// rows (2j, 2j + 1) to (ra, rb, rc) and rd [2P, R], the next level's matrix
// and right-hand side.
template <typename T, typename Level>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(Level lv, T* __restrict__ h_out, T* __restrict__ f, T* __restrict__ g,
              T* __restrict__ ra, T* __restrict__ rb, T* __restrict__ rc,
              T* __restrict__ rd, int P) {
  lv.load();
  const int R = lv.R;
  const Layout lay(R);
  const int j = blockIdx.x * lay.CB + threadIdx.x / lay.TC, lane = threadIdx.x % lay.TC;
  const bool active = j < P && (int)threadIdx.x < lay.CB * lay.TC;
  int s = 0, e = 1;
  if (active) chunk_rows(j, lv.n, P, &s, &e);
  for (int c0 = 0; c0 < R; c0 += lay.TC) {   // the same trip count in every thread
    const int col = c0 + lane;
    const bool mine = active && col < R;
    const bool keeper = active && lane == 0 && c0 == 0;   // writes f, g and the matrix
    T fp = T(0), gp = T(1), h = T(0);
    if (mine) {
      // 1. down rows s+1..e
      fp = lv.a(s + 1);
      gp = lv.b(s + 1);
      h = lv.d(s + 1, col);
      h_out[(int64_t)(s + 1) * R + col] = h;
      if (keeper) { f[s + 1] = fp; g[s + 1] = gp; }
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
            const T k = av[q] / gp;
            fp = -k * fp;
            gp = bv[q] - k * cv[q];
            h = dv[q] - k * h;
            h_out[(int64_t)(i0 + q) * R + col] = h;
            if (keeper) { f[i0 + q] = fp; g[i0 + q] = gp; }
          }
      }
      rd[(int64_t)(2 * j + 1) * R + col] = h;
      if (keeper) { ra[2 * j + 1] = fp; rb[2 * j + 1] = gp; rc[2 * j + 1] = lv.c(e); }
    }
    if (c0 == 0) __syncthreads();     // the keepers' f and g, for every column thread
    if (!mine) continue;
    // 2. up rows e-1..s+1, then row s
    T beta, gamma, z;
    if (e == s + 1) {
      beta = lv.b(s);
      gamma = lv.c(s);
      z = lv.d(s, col);
    } else {
      T u = f[e - 1], w = lv.c(e - 1);
      z = h_out[(int64_t)(e - 1) * R + col];
      for (int i0 = e - 2; i0 > s; i0 -= kGroup) {
        const int m = min(kGroup, i0 - s);
        T cv[kGroup], gv[kGroup], fv[kGroup], hv[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          if (q < m) {
            cv[q] = lv.c(i0 - q);
            gv[q] = g[i0 - q + 1];
            fv[q] = f[i0 - q];
            hv[q] = h_out[(int64_t)(i0 - q) * R + col];
          }
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          if (q < m) {
            const T k = cv[q] / gv[q];
            u = fv[q] - k * u;
            w = -k * w;
            z = hv[q] - k * z;
          }
      }
      const T k = lv.c(s) / g[s + 1];
      beta = lv.b(s) - k * u;
      gamma = -k * w;
      z = lv.d(s, col) - k * z;
    }
    rd[(int64_t)(2 * j) * R + col] = z;
    if (keeper) { ra[2 * j] = lv.a(s); rb[2 * j] = beta; rc[2 * j] = gamma; }
  }
}

// Step 3, a thread a (chunk, column): x_s and x_e from the next level's
// solution xr [2P, R], then rows e-1..s+1 from h, f and g, which the
// level's reduce_kernel wrote, kGroup rows at a time, their loads first.
template <typename T, typename Level>
__global__ void __launch_bounds__(kThreads)
expand_kernel(Level lv, const T* __restrict__ h, const T* __restrict__ f,
              const T* __restrict__ g, const T* __restrict__ xr, T* __restrict__ x,
              int P) {
  lv.load();
  const int R = lv.R;
  const Layout lay(R);
  const int j = blockIdx.x * lay.CB + threadIdx.x / lay.TC, lane = threadIdx.x % lay.TC;
  if (j >= P || (int)threadIdx.x >= lay.CB * lay.TC) return;
  int s, e;
  chunk_rows(j, lv.n, P, &s, &e);
  for (int col = lane; col < R; col += lay.TC) {
    const T xs = __ldg(xr + (int64_t)(2 * j) * R + col);
    T xn = __ldg(xr + (int64_t)(2 * j + 1) * R + col);
    x[(int64_t)s * R + col] = xs;
    x[(int64_t)e * R + col] = xn;
    for (int i0 = e - 1; i0 > s; i0 -= kGroup) {
      const int m = min(kGroup, i0 - s);
      T fv[kGroup], cv[kGroup], gv[kGroup], hv[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (q < m) {
          fv[q] = __ldg(f + i0 - q);
          cv[q] = lv.c(i0 - q);
          gv[q] = __ldg(g + i0 - q);
          hv[q] = __ldg(h + (int64_t)(i0 - q) * R + col);
        }
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (q < m) {
          xn = (hv[q] - fv[q] * xs - cv[q] * xn) / gv[q];
          x[(int64_t)(i0 - q) * R + col] = xn;
        }
    }
  }
}

// The last level, n <= kBase unknowns: Thomas, the modified superdiagonal
// and pivots once in shared memory, then a thread a column; the solution
// goes to x.
template <typename T, typename Level>
__global__ void base_kernel(Level lv, T* __restrict__ x) {
  __shared__ T cp[kBase], piv[kBase];
  lv.load();
  const int n = lv.n, R = lv.R;
  if (threadIdx.x == 0) {
    T den = lv.b(0);
    piv[0] = den;
    cp[0] = lv.c(0) / den;
    for (int i = 1; i < n; ++i) {
      den = lv.b(i) - lv.a(i) * cp[i - 1];
      piv[i] = den;
      cp[i] = lv.c(i) / den;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    T dp = lv.d(0, r) / piv[0];
    x[r] = dp;
    for (int i = 1; i < n; ++i) {
      dp = (lv.d(i, r) - lv.a(i) * dp) / piv[i];
      x[(int64_t)i * R + r] = dp;
    }
    T xn = dp;
    for (int i = n - 2; i >= 0; --i) {
      T* xi = x + (int64_t)i * R + r;
      xn = *xi - cp[i] * xn;
      *xi = xn;
    }
  }
}

// The sizes of the levels: n_0 = N, n_{l+1} = 2 ceil(n_l / kChunk) while
// n_l > kBase. Returns L, the number of reduced levels.
int levels(int N, int* n) {
  int L = 0;
  n[0] = N;
  while (n[L] > kBase) {
    const int P = (n[L] + kChunk - 1) / kChunk;
    n[L + 1] = 2 * P;
    ++L;
  }
  return L;
}

constexpr int kMaxLevels = 8;   // 2^31 unknowns take 7 levels

// The workspace of one call, in elements of T: f, g [n_l] and h [n_l, R]
// of every reduced level l < L, then a, b, c [n_l], d and x [n_l, R] of
// every deeper level 1 <= l <= L.
int64_t workspace_elems(int N, int R) {
  int n[kMaxLevels + 1];
  const int L = levels(N, n);
  int64_t total = 0;
  for (int l = 0; l < L; ++l) total += (2 + (int64_t)R) * n[l];
  for (int l = 1; l <= L; ++l) total += (3 + 2 * (int64_t)R) * n[l];
  return total;
}

template <typename T>
cudaError_t launch_tridiag(const void* y, const void* rho, void* out, int N, int R,
                           double two_lam, void* ws, cudaStream_t st) {
  int n[kMaxLevels + 1];
  const int L = levels(N, n);
  T* w = static_cast<T*>(ws);
  T *f[kMaxLevels], *g[kMaxLevels], *h[kMaxLevels], *a[kMaxLevels + 1],
      *b[kMaxLevels + 1], *c[kMaxLevels + 1], *d[kMaxLevels + 1], *x[kMaxLevels + 1];
  for (int l = 0; l < L; ++l) {
    f[l] = w; w += n[l];
    g[l] = w; w += n[l];
    h[l] = w; w += (int64_t)n[l] * R;
  }
  x[0] = static_cast<T*>(out);
  for (int l = 1; l <= L; ++l) {
    a[l] = w; w += n[l];
    b[l] = w; w += n[l];
    c[l] = w; w += n[l];
    d[l] = w; w += (int64_t)n[l] * R;
    x[l] = w; w += (int64_t)n[l] * R;
  }
  const Level0<T> top{static_cast<const T*>(y), static_cast<const T*>(rho), (T)two_lam,
                      N, R, T(0)};
  auto level = [&](int l) { return LevelN<T>{a[l], b[l], c[l], d[l], n[l], R}; };
  const Layout lay(R);
  const int block = lay.CB * lay.TC;
  for (int l = 0; l < L; ++l) {
    const int P = n[l + 1] / 2, grid = (P + lay.CB - 1) / lay.CB;
    if (l == 0)
      reduce_kernel<T><<<grid, block, 0, st>>>(top, h[0], f[0], g[0], a[1], b[1], c[1],
                                                  d[1], P);
    else
      reduce_kernel<T><<<grid, block, 0, st>>>(level(l), h[l], f[l], g[l], a[l + 1],
                                                  b[l + 1], c[l + 1], d[l + 1], P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int threads = R < 32 ? 32 : (R < 256 ? (R + 31) / 32 * 32 : 256);
  if (L == 0)
    base_kernel<T><<<1, threads, 0, st>>>(top, x[0]);
  else
    base_kernel<T><<<1, threads, 0, st>>>(level(L), x[L]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int l = L - 1; l >= 0; --l) {
    const int P = n[l + 1] / 2, grid = (P + lay.CB - 1) / lay.CB;
    if (l == 0)
      expand_kernel<T><<<grid, block, 0, st>>>(top, h[0], f[0], g[0], x[1], x[0], P);
    else
      expand_kernel<T><<<grid, block, 0, st>>>(level(l), h[l], f[l], g[l], x[l + 1], x[l],
                                                  P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. y: [N, R] row-major; rho: one element of
// the same dtype in device memory; out: [N, R], not aliasing y; two_lam:
// 2 lam; ws: spartan_tridiag_workspace elements of the dtype (may be null
// where that is 0). Needs N >= 2, R >= 1. Returns a cudaError_t (0 =
// success).
int spartan_tridiag_solve(int dtype, const void* y, const void* rho, void* out, int N, int R,
                          double two_lam, void* ws, void* stream) {
  if (N < 2 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_tridiag<float>(y, rho, out, N, R, two_lam, ws, st);
  if (dtype == 1) return (int)launch_tridiag<double>(y, rho, out, N, R, two_lam, ws, st);
  return (int)cudaErrorInvalidValue;
}

// The elements of workspace a call for N unknowns and R columns needs (the
// same for either dtype); -1 for N < 2, R < 1 or a count past an int.
int spartan_tridiag_workspace(int dtype, int N, int R) {
  if (N < 2 || R < 1 || (dtype != 0 && dtype != 1)) return -1;
  const int64_t n = workspace_elems(N, R);
  return n > INT32_MAX ? -1 : (int)n;
}

// The kernels one call enqueues: 2 L + 1, L the reduced levels.
int spartan_tridiag_kernels(int N) {
  if (N < 2) return -1;
  int n[kMaxLevels + 1];
  return 2 * levels(N, n) + 1;
}

}  // extern "C"
