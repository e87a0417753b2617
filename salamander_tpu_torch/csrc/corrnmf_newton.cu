// The damped Newton solve of CorrNMF's embeddings for Hopper (sm_90a), as
// two kernels that share the row algebra below:
//
// - corrnmf_newton_kernel: every row of every lane runs all of its steps in
//   one thread, for narrow rows (at most OTHERS_MAX others, the sample side's
//   signatures) in an unrolled solve (max_iter <= _UNROLL_NEWTON_LIMIT: the
//   sample side's 3 steps);
// - corrnmf_newton_wide_kernel (further down): a CTA, or a cluster of C CTAs,
//   runs one wide row (more than OTHERS_MAX others: the signature side's
//   samples), all of its steps up to an early-exit cap of 100.
//
// Neither replaces a TPU kernel: the JAX package solves these rows with XLA
// ops (salamander_tpu/ops/corrnmf.py). They take the place of the plain
// PyTorch steps of ops/corrnmf.py::_newton_step, with the same arithmetic,
// row by row:
//
//   lin   = aux_row @ O                          (once; O the M others, M x m)
//   r_i   = exp((s_row,i + s_other,i) + <b, o_i>)
//   g     = (-lin + sum_i r_i o_i) + b / var
//   H     = sum_i (r_i o_i) o_i^T + I / var
//   L     = chol(H), or chol(H + EPSILON * diag(H)) where the first fails
//           (ops/mvnmf.py::_cholesky's rule)
//   d     = -H^-1 g by two triangular solves;  slope = <g, d>
//   t     = the first of 2^0, 2^-1, ..., 2^-39 whose Armijo test passes,
//           else 2^-40 (the vectorised argmax's pick)
//   b    += t d; the row is done once sum |t d| < xtol (then frozen)
//
// and at the end _clamp_away_from_zero. The Armijo test is the plain
// path's in each dtype: in float32 each candidate's change of the
// objective read term by term, sum_i r_i expm1(t <d, o_i>) + t (linear -
// 1e-4 slope + t quadratic) <= 0 (_armijo_by_change); in float64 two whole
// objectives, f(b + t d) <= f(b) + 1e-4 t slope. Only the order of the sums
// over the M others (and over m) differs from the plain path's products.
// IEEE float32 or float64 throughout: expf/exp, expm1f/expm1, IEEE
// division and square root (no fast-math flags or intrinsics).
//
// Layout (the wrapper, ops/cuda_corrnmf.py, passes strides for the two
// large operands and makes the rest contiguous): L lanes, N rows, M others,
// m = DIM the embedding dimension.
//   b0 (L, N, m), others (L, M, m), scalings_other (L, M), variance (L,),
//   xtol (L,), out (L, N, m): contiguous.
//   scalings: element (l, n, i) at l*sl + n*sn + i*si (si = 0 where a row
//   has one scaling for all its others, as in CorrNMF; the multimodal
//   sample side has one per modality's signature).
//   aux: element (l, n, i) at l*al + n*an + i*ai; the sample side reads
//   ops/corrnmf.py::compute_aux's (L, M, N) output transposed (an = 1),
//   so consecutive threads read consecutive samples.
//
// The bound. At the multimodal pan-cancer cell (L = 8 lanes, N = 20,000
// samples, M = 11 signatures, m = 6, float32) a solve reads aux (7.0 MB),
// the scalings (7.0 MB) and b (3.8 MB), and writes b (3.8 MB): 21.7 MB,
// 6.5 us at 3.35 TB/s. Its operations, ~1,000 a row a step (M rates, the
// gradient and the 21 Hessian entries, the factor, the solves, an Armijo
// candidate or two), are ~5e8 for 3 steps: 7 us at 67 TFLOP/s in float32
// (twice that in float64). So a solve is bound by bytes and operations
// alike, at about 7 us. The plain path materialises (L, N, 41, M)
// candidate tensors and (L, N, m, m) Hessians through ~40 launches a
// step.
//
// The thread kernel's design. One thread owns one (lane, row) for all steps: b, the linear
// term, the gradient and the packed lower Hessian (m (m + 1) / 2 entries)
// live in registers, unrolled over the compile-time DIM (2..10), so the
// factor and the solves index registers only (ptxas reports no spills; a
// DIM = 1 instance spilled what lives across the IEEE division's slow-path
// call, so the wrapper runs m = 1 at DIM = 2 with a zero column, which
// adds exact zeros to every sum and stays 0, as the padded scans' m-padding
// does).
// Nothing crosses threads: no shared memory, no barrier. The others and
// their scalings (M x (m + 1) values a lane) are read through the read-only
// path; every thread of a block reads the same lane's, so each load is a
// broadcast from L1. aux and the row scalings are read with the strides
// given: for aux one coalesced load per other. The M rates are recomputed
// for each Armijo candidate rather than kept (M is a run-time size), since
// their exponentials cost less than a row's bytes. A row leaves its loop
// when done. 128 threads a block; blocks over rows (x) and lanes (y).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#define CORRNMF_NEWTON_DIM_MIN 2
#define CORRNMF_NEWTON_DIM_MAX 10
#define CORRNMF_NEWTON_THREADS 128
#define CORRNMF_WIDE_THREADS 256
#define CORRNMF_WIDE_CLUSTER_MAX 8
// the most dynamic shared memory a CTA's cached slice of the others may take
#define CORRNMF_WIDE_CACHE_BYTES 204800

namespace {

namespace cg = cooperative_groups;

constexpr int kBacktrack = 41;  // ops/corrnmf.py::_N_BACKTRACK
// ops/klnmf.py::EPSILON, float32's machine epsilon 2^-23
constexpr double kEpsilon = 1.1920928955078125e-07;
constexpr int kFloat32 = 1;
constexpr int kFloat64 = 2;

__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }
__device__ __forceinline__ float expm1_of(float x) { return expm1f(x); }
__device__ __forceinline__ double expm1_of(double x) { return expm1(x); }
__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }

// packed lower triangle: entry (j, k), k <= j
__host__ __device__ constexpr int tri(int j, int k) {
  return j * (j + 1) / 2 + k;
}

template <typename T, int DIM>
struct Other {
  T o[DIM];
  T offset;  // s_row,i + s_other,i
};

// The i-th other and its exponent offset for this row.
template <typename T, int DIM>
__device__ __forceinline__ Other<T, DIM> load_other(
    const T* __restrict__ others, const T* __restrict__ scal_other,
    const T* __restrict__ scal_row, int64_t si, int i) {
  Other<T, DIM> x;
#pragma unroll
  for (int j = 0; j < DIM; ++j) x.o[j] = __ldg(others + i * DIM + j);
  x.offset = __ldg(scal_row + i * si) + __ldg(scal_other + i);
  return x;
}

template <typename T, int DIM>
__device__ __forceinline__ T dot(const T (&a)[DIM], const T (&b)[DIM]) {
  T s = a[0] * b[0];
#pragma unroll
  for (int j = 1; j < DIM; ++j) s += a[j] * b[j];
  return s;
}

// r_i = exp(offset + <b, o_i>)
template <typename T, int DIM>
__device__ __forceinline__ T rate_of(const Other<T, DIM>& x,
                                     const T (&b)[DIM]) {
  return exp_of(x.offset + dot<T, DIM>(b, x.o));
}

// sum_i r_i o_i (into grad, with kGrad), sum_i (r_i o_i) o_i^T (packed,
// into hess) and sum_i r_i.
template <typename T, int DIM, bool kGrad>
__device__ __forceinline__ void rate_terms(
    const T (&b)[DIM], const T* __restrict__ others,
    const T* __restrict__ scal_other, const T* __restrict__ scal_row,
    int64_t si, int M, T (&grad)[DIM], T (&hess)[DIM * (DIM + 1) / 2],
    T& rate_sum) {
#pragma unroll
  for (int j = 0; j < DIM; ++j) grad[j] = T(0);
#pragma unroll
  for (int p = 0; p < DIM * (DIM + 1) / 2; ++p) hess[p] = T(0);
  rate_sum = T(0);
  for (int i = 0; i < M; ++i) {
    const Other<T, DIM> x =
        load_other<T, DIM>(others, scal_other, scal_row, si, i);
    const T r = rate_of<T, DIM>(x, b);
    rate_sum += r;
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const T w = r * x.o[j];
      if constexpr (kGrad) grad[j] += w;
#pragma unroll
      for (int k = 0; k <= j; ++k) hess[tri(j, k)] += w * x.o[k];
    }
  }
}

// In-place lower Cholesky factor of the packed SPD matrix a; false where a
// pivot is not positive (LAPACK potrf's test, as torch.linalg.cholesky_ex
// reports it).
template <typename T, int DIM>
__device__ __forceinline__ bool cholesky(T (&a)[DIM * (DIM + 1) / 2]) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    T pivot = a[tri(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) pivot -= a[tri(j, k)] * a[tri(j, k)];
    ok = ok && pivot > T(0);
    const T diagonal = sqrt_of(pivot);
    a[tri(j, j)] = diagonal;
#pragma unroll
    for (int i = j + 1; i < DIM; ++i) {
      T v = a[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= a[tri(i, k)] * a[tri(j, k)];
      a[tri(i, j)] = v / diagonal;
    }
  }
  return ok;
}

// d = -(L L^T)^-1 g from the packed lower factor L: two triangular solves.
template <typename T, int DIM>
__device__ __forceinline__ void newton_direction(
    const T (&h)[DIM * (DIM + 1) / 2], const T (&g)[DIM], T (&d)[DIM]) {
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    T v = g[j];
#pragma unroll
    for (int k = 0; k < j; ++k) v -= h[tri(j, k)] * d[k];
    d[j] = v / h[tri(j, j)];
  }
#pragma unroll
  for (int j = DIM - 1; j >= 0; --j) {
    T v = d[j];
#pragma unroll
    for (int k = j + 1; k < DIM; ++k) v -= h[tri(k, j)] * d[k];
    d[j] = v / h[tri(j, j)];
  }
#pragma unroll
  for (int j = 0; j < DIM; ++j) d[j] = -d[j];
}

// _clamp_away_from_zero: magnitudes in (0, EPSILON) go to +-EPSILON
template <typename T>
__device__ __forceinline__ T clamp_away_from_zero(T v) {
  if (v > T(0) && v < T(kEpsilon)) v = T(kEpsilon);
  if (v < T(0) && v > -T(kEpsilon)) v = -T(kEpsilon);
  return v;
}

template <typename T, int DIM>
__global__ void __launch_bounds__(CORRNMF_NEWTON_THREADS)
    corrnmf_newton_kernel(const T* __restrict__ b0,
                          const T* __restrict__ others_all,
                          const T* __restrict__ scalings, int64_t sl,
                          int64_t sn, int64_t si,
                          const T* __restrict__ scal_other_all,
                          const T* __restrict__ aux, int64_t al, int64_t an,
                          int64_t ai, const T* __restrict__ variance,
                          const T* __restrict__ xtol, T* __restrict__ out,
                          int N, int M, int max_iter) {
  const int row = blockIdx.x * CORRNMF_NEWTON_THREADS + threadIdx.x;
  const int lane = blockIdx.y;
  if (row >= N) return;
  const T* others = others_all + static_cast<int64_t>(lane) * M * DIM;
  const T* scal_other = scal_other_all + static_cast<int64_t>(lane) * M;
  const T* scal_row = scalings + lane * sl + row * sn;
  const T* aux_row = aux + lane * al + row * an;
  const T var = variance[lane];
  const T inv_var = T(1) / var;
  const T two_var = T(2) * var;
  const T row_xtol = xtol[lane];
  const int64_t at = (static_cast<int64_t>(lane) * N + row) * DIM;

  T b[DIM], lin[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    b[j] = b0[at + j];
    lin[j] = T(0);
  }
  for (int i = 0; i < M; ++i) {
    const T a = aux_row[i * ai];
#pragma unroll
    for (int j = 0; j < DIM; ++j) lin[j] += a * __ldg(others + i * DIM + j);
  }

  for (int step = 0; step < max_iter; ++step) {
    T g[DIM], h[DIM * (DIM + 1) / 2], rate_sum;
    rate_terms<T, DIM, true>(b, others, scal_other, scal_row, si, M, g, h,
                             rate_sum);
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      g[j] = (-lin[j] + g[j]) + b[j] / var;
      h[tri(j, j)] += inv_var;
    }
    if (!cholesky<T, DIM>(h)) {
      // the diagonal floor: factor H + EPSILON * diag(H) (its sums again)
      T unused[DIM], unused_sum;
      rate_terms<T, DIM, false>(b, others, scal_other, scal_row, si, M,
                                unused, h, unused_sum);
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        const T diagonal = h[tri(j, j)] + inv_var;
        h[tri(j, j)] = diagonal + T(kEpsilon) * diagonal;
      }
      cholesky<T, DIM>(h);
    }
    T d[DIM];
    newton_direction<T, DIM>(h, g, d);
    const T slope = dot<T, DIM>(g, d);

    // the first candidate t = 2^-k that passes; 2^-40 passes regardless
    T t = T(1);
    if constexpr (sizeof(T) < 8) {
      T linear = (b[0] / var - lin[0]) * d[0];
#pragma unroll
      for (int j = 1; j < DIM; ++j) linear += (b[j] / var - lin[j]) * d[j];
      const T quadratic = dot<T, DIM>(d, d) / two_var;
      const T base = linear - T(1e-4) * slope;
      for (int k = 0; k < kBacktrack - 1; ++k, t *= T(0.5)) {
        T change = T(0);
        for (int i = 0; i < M; ++i) {
          const Other<T, DIM> x =
              load_other<T, DIM>(others, scal_other, scal_row, si, i);
          change += rate_of<T, DIM>(x, b) * expm1_of(t * dot<T, DIM>(d, x.o));
        }
        if (change + t * (base + t * quadratic) <= T(0)) break;
      }
    } else {
      const T f0 = (-dot<T, DIM>(lin, b) + rate_sum) + dot<T, DIM>(b, b) /
                                                          two_var;
      for (int k = 0; k < kBacktrack - 1; ++k, t *= T(0.5)) {
        T c[DIM];
#pragma unroll
        for (int j = 0; j < DIM; ++j) c[j] = b[j] + t * d[j];
        T rates = T(0);
        for (int i = 0; i < M; ++i) {
          const Other<T, DIM> x =
              load_other<T, DIM>(others, scal_other, scal_row, si, i);
          rates += exp_of(dot<T, DIM>(c, x.o) + x.offset);
        }
        const T f = (-dot<T, DIM>(c, lin) + rates) + dot<T, DIM>(c, c) /
                                                         two_var;
        if (f <= f0 + (T(1e-4) * t) * slope) break;
      }
    }

    T moved = T(0);
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const T update = t * d[j];
      b[j] += update;
      moved += abs_of(update);
    }
    if (moved < row_xtol) break;  // done: the plain path freezes the row
  }

#pragma unroll
  for (int j = 0; j < DIM; ++j) out[at + j] = clamp_away_from_zero(b[j]);
}

template <typename T, int DIM>
cudaError_t launch(const void* b0, const void* others, const void* scalings,
                   int64_t sl, int64_t sn, int64_t si,
                   const void* scal_other, const void* aux, int64_t al,
                   int64_t an, int64_t ai, const void* variance,
                   const void* xtol, void* out, int L, int N, int M,
                   int max_iter, cudaStream_t stream) {
  const dim3 grid((N + CORRNMF_NEWTON_THREADS - 1) / CORRNMF_NEWTON_THREADS,
                  L);
  corrnmf_newton_kernel<T, DIM><<<grid, CORRNMF_NEWTON_THREADS, 0, stream>>>(
      static_cast<const T*>(b0), static_cast<const T*>(others),
      static_cast<const T*>(scalings), sl, sn, si,
      static_cast<const T*>(scal_other), static_cast<const T*>(aux), al, an,
      ai, static_cast<const T*>(variance), static_cast<const T*>(xtol),
      static_cast<T*>(out), N, M, max_iter);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int dim, const void* b0, const void* others,
                       const void* scalings, int64_t sl, int64_t sn,
                       int64_t si, const void* scal_other, const void* aux,
                       int64_t al, int64_t an, int64_t ai,
                       const void* variance, const void* xtol, void* out,
                       int L, int N, int M, int max_iter,
                       cudaStream_t stream) {
  switch (dim) {
#define CORRNMF_NEWTON_CASE(DIM)                                            \
  case DIM:                                                                 \
    return launch<T, DIM>(b0, others, scalings, sl, sn, si, scal_other,     \
                          aux, al, an, ai, variance, xtol, out, L, N, M,    \
                          max_iter, stream);
    CORRNMF_NEWTON_CASE(2)
    CORRNMF_NEWTON_CASE(3)
    CORRNMF_NEWTON_CASE(4)
    CORRNMF_NEWTON_CASE(5)
    CORRNMF_NEWTON_CASE(6)
    CORRNMF_NEWTON_CASE(7)
    CORRNMF_NEWTON_CASE(8)
    CORRNMF_NEWTON_CASE(9)
    CORRNMF_NEWTON_CASE(10)
#undef CORRNMF_NEWTON_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The wide solve: a CTA, or a cluster of C CTAs, per row
// ---------------------------------------------------------------------------
//
// Rows with more than OTHERS_MAX others: the signature side of a cohort fit
// (its K signatures of each lane against the D samples; at the multimodal
// pan-cancer cell 8 lanes of 6 and of 5 rows against 20,000 samples, m = 6)
// and the minibatch signature side against a batch of more than OTHERS_MAX
// samples. Up to 100 steps a solve, each row leaving its loop once it is
// done (ops/corrnmf.py's early exit, whose plain loop reads the done flags
// on the host after every step). The same arithmetic as the thread kernel,
// row by row; only the order of the sums over the others differs.
//
// The bound. A solve needs, per step and row, one pass over the row's M
// others for the rates, the gradient and the Hessian (m + 1 values an other
// read, one exp, ~m^2 + 3m operations) and one for each Armijo candidate
// tried (one exp and, in float32, one expm1). At the cell (8 x 6 rows, M =
// 20,000, m = 6, float32) a pass over all rows reads U and the sample
// scalings, 4.5 MB, which L2 (50 MB) holds across the passes, and takes
// 960,000 exps: 0.23 us at the SFU rate (16 a clock per SM, 132 SMs at
// 1,980 MHz), 1.3 us of the bytes at 3.35 TB/s if they came from device
// memory. So the bound is a few microseconds a step; what the kernel pays
// beyond it is latency: a pass is a loop of ~40 others a thread, the sums
// cross the CTA and the cluster twice a step, and the 6 x 6 factor and the
// candidate tests are serial.
//
// The design. Grid (N * C, L): CTA `rank` of the cluster of (lane, row)
// takes a contiguous slice of M / C others. Where lanes x rows leave most
// SMs idle, C > 1 (the wrapper picks C so that rows x C fits the SMs, at
// most 8). The slice's others and their exponent offsets (s_row,i +
// s_other,i) are copied into shared memory once where they fit in
// CORRNMF_WIDE_CACHE_BYTES, else each pass re-reads them (from L2). Each
// pass accumulates in registers, then sums over the CTA (warp shuffles,
// then the warps' partials in shared memory in warp order) and over the
// cluster through distributed shared memory: every CTA reads the C
// partials in rank order, so every CTA gets the same bits, takes the same
// Armijo candidate and leaves the loop at the same step (rounding never
// splits a cluster). The Hessian's sums stay in shared memory, so where
// the factor fails the floored factor is taken from them with no second
// pass. Every thread factors and solves the m x m system from the same sums
// (a few hundred operations, identical in every thread), so no broadcast
// is needed. Armijo: candidate 2^0 in the first pass (it usually passes),
// then kGroup candidates a pass, in order; the first that passes is
// taken, and 2^-40 where none of 2^0..2^-39 does: the plain path's
// _first_passing pick, without its (L, N, 41, M) tensor. One cluster
// barrier a sum suffices: the partials alternate between two buffers, and
// a CTA can only rewrite a buffer after every CTA has passed the next
// barrier, so after it has read that buffer. Each CTA writes its copy of
// the row (the wrapper keeps rank 0's; a test compares them), and rank 0
// the row's step count.

constexpr int kWideWarps = CORRNMF_WIDE_THREADS / 32;
constexpr int kGroup = 4;  // Armijo candidates a pass after the first

template <typename T, int NV>
struct WideShared {
  T warp[kWideWarps][NV];
  T partial[2][NV];
  T total[NV];
};

// Sums the first n values of v over the CTA's threads and then over the
// cluster's C CTAs in rank order, into sh.total (every thread reads it
// after the return); `parity` picks the partial buffer and alternates.
template <typename T, int NA, int NV>
__device__ __forceinline__ void wide_sum(const T (&v)[NA], int n,
                                         WideShared<T, NV>& sh, int C,
                                         int& parity) {
  static_assert(NA <= NV, "the sums exceed the shared buffers");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < NA; ++p) {
    if (p < n) {
      T x = v[p];
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        x += __shfl_down_sync(0xffffffffu, x, offset);
      }
      if (lane == 0) sh.warp[warp][p] = x;
    }
  }
  __syncthreads();
  const int p = threadIdx.x;
  T block = T(0);
  if (p < n) {
    block = sh.warp[0][p];
#pragma unroll
    for (int w = 1; w < kWideWarps; ++w) block += sh.warp[w][p];
  }
  if (C > 1) {
    T* partial = sh.partial[parity];
    if (p < n) partial[p] = block;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (p < n) {
      T total = cluster.map_shared_rank(partial, 0)[p];
      for (int c = 1; c < C; ++c) total += cluster.map_shared_rank(partial, c)[p];
      sh.total[p] = total;
    }
    parity ^= 1;
  } else if (p < n) {
    sh.total[p] = block;
  }
  __syncthreads();
}

template <typename T, int DIM>
__global__ void __launch_bounds__(CORRNMF_WIDE_THREADS)
    corrnmf_newton_wide_kernel(const T* __restrict__ b0,
                               const T* __restrict__ others_all,
                               const T* __restrict__ scalings, int64_t sl,
                               int64_t sn, int64_t si,
                               const T* __restrict__ scal_other_all,
                               const T* __restrict__ aux, int64_t al,
                               int64_t an, int64_t ai,
                               const T* __restrict__ variance,
                               const T* __restrict__ xtol,
                               T* __restrict__ out, int* __restrict__ steps_out,
                               int N, int M, int max_iter, int C, int cached) {
  constexpr int NH = DIM * (DIM + 1) / 2;
  constexpr int NV = DIM + NH + 1;  // the gradient's, Hessian's, rate sums
  static_assert(NV >= kGroup, "the candidates' sums exceed the buffers");
  __shared__ WideShared<T, NV> sh;
  extern __shared__ __align__(16) unsigned char wide_cache_bytes[];

  const int rank = static_cast<int>(blockIdx.x) % C;
  const int row = static_cast<int>(blockIdx.x) / C;
  const int lane = blockIdx.y;
  const int chunk = (M + C - 1) / C;
  const int begin = min(M, rank * chunk);
  const int end = min(M, begin + chunk);
  const T* others = others_all + static_cast<int64_t>(lane) * M * DIM;
  const T* scal_other = scal_other_all + static_cast<int64_t>(lane) * M;
  const T* scal_row = scalings + lane * sl + row * sn;
  const T* aux_row = aux + lane * al + row * an;
  const T var = variance[lane];
  const T inv_var = T(1) / var;
  const T two_var = T(2) * var;
  const T row_xtol = xtol[lane];
  int parity = 0;

  // the slice's others and offsets, by column: [j][i - begin], the offsets
  // as column DIM (consecutive threads read consecutive words)
  T* cache = reinterpret_cast<T*>(wide_cache_bytes);
  if (cached) {
    for (int i = begin + threadIdx.x; i < end; i += CORRNMF_WIDE_THREADS) {
      const Other<T, DIM> x =
          load_other<T, DIM>(others, scal_other, scal_row, si, i);
#pragma unroll
      for (int j = 0; j < DIM; ++j) cache[j * chunk + (i - begin)] = x.o[j];
      cache[DIM * chunk + (i - begin)] = x.offset;
    }
    __syncthreads();
  }
  auto other = [&](int i) {
    if (!cached) return load_other<T, DIM>(others, scal_other, scal_row, si, i);
    Other<T, DIM> x;
#pragma unroll
    for (int j = 0; j < DIM; ++j) x.o[j] = cache[j * chunk + (i - begin)];
    x.offset = cache[DIM * chunk + (i - begin)];
    return x;
  };

  T b[DIM], lin[DIM];
  {
    T part[DIM];
#pragma unroll
    for (int j = 0; j < DIM; ++j) part[j] = T(0);
    for (int i = begin + threadIdx.x; i < end; i += CORRNMF_WIDE_THREADS) {
      const T a = aux_row[i * ai];
      const Other<T, DIM> x = other(i);
#pragma unroll
      for (int j = 0; j < DIM; ++j) part[j] += a * x.o[j];
    }
    wide_sum<T, DIM, NV>(part, DIM, sh, C, parity);
    const int64_t at = (static_cast<int64_t>(lane) * N + row) * DIM;
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      lin[j] = sh.total[j];
      b[j] = b0[at + j];
    }
  }

  int steps = 0;
  for (int step = 0; step < max_iter; ++step) {
    // the rates' sums: gradient [0, DIM), Hessian [DIM, DIM + NH), rates
    {
      T part[NV];
#pragma unroll
      for (int p = 0; p < NV; ++p) part[p] = T(0);
      for (int i = begin + threadIdx.x; i < end; i += CORRNMF_WIDE_THREADS) {
        const Other<T, DIM> x = other(i);
        const T r = rate_of<T, DIM>(x, b);
        part[NV - 1] += r;
#pragma unroll
        for (int j = 0; j < DIM; ++j) {
          const T w = r * x.o[j];
          part[j] += w;
#pragma unroll
          for (int k = 0; k <= j; ++k) part[DIM + tri(j, k)] += w * x.o[k];
        }
      }
      wide_sum<T, NV, NV>(part, NV, sh, C, parity);
    }
    T g[DIM], h[NH];
#pragma unroll
    for (int j = 0; j < DIM; ++j) g[j] = (-lin[j] + sh.total[j]) + b[j] / var;
#pragma unroll
    for (int q = 0; q < NH; ++q) h[q] = sh.total[DIM + q];
#pragma unroll
    for (int j = 0; j < DIM; ++j) h[tri(j, j)] += inv_var;
    if (!cholesky<T, DIM>(h)) {
      // the diagonal floor: factor H + EPSILON * diag(H), H from the sums
#pragma unroll
      for (int q = 0; q < NH; ++q) h[q] = sh.total[DIM + q];
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        const T diagonal = h[tri(j, j)] + inv_var;
        h[tri(j, j)] = diagonal + T(kEpsilon) * diagonal;
      }
      cholesky<T, DIM>(h);
    }
    T d[DIM];
    newton_direction<T, DIM>(h, g, d);
    const T slope = dot<T, DIM>(g, d);

    // the candidates 2^-k in order, kGroup a pass after the first; the
    // first that passes, or 2^-40 once 2^0..2^-39 have failed
    T t = T(1);
    if constexpr (sizeof(T) < 8) {
      T linear = (b[0] / var - lin[0]) * d[0];
#pragma unroll
      for (int j = 1; j < DIM; ++j) linear += (b[j] / var - lin[j]) * d[j];
      const T quadratic = dot<T, DIM>(d, d) / two_var;
      const T base = linear - T(1e-4) * slope;
      for (int k = 0; k < kBacktrack - 1;) {
        const int G = min(k == 0 ? 1 : kGroup, kBacktrack - 1 - k);
        T part[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) part[q] = T(0);
        for (int i = begin + threadIdx.x; i < end;
             i += CORRNMF_WIDE_THREADS) {
          const Other<T, DIM> x = other(i);
          const T r = rate_of<T, DIM>(x, b);
          const T along = dot<T, DIM>(d, x.o);
          T tq = t;
#pragma unroll
          for (int q = 0; q < kGroup; ++q, tq *= T(0.5)) {
            if (q < G) part[q] += r * expm1_of(tq * along);
          }
        }
        wide_sum<T, kGroup, NV>(part, G, sh, C, parity);
        int q = 0;
        for (; q < G; ++q, t *= T(0.5)) {
          if (sh.total[q] + t * (base + t * quadratic) <= T(0)) break;
        }
        if (q < G) break;
        k += G;
      }
    } else {
      const T f0 = (-dot<T, DIM>(lin, b) + sh.total[NV - 1]) +
                   dot<T, DIM>(b, b) / two_var;
      for (int k = 0; k < kBacktrack - 1;) {
        const int G = min(k == 0 ? 1 : kGroup, kBacktrack - 1 - k);
        T part[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) part[q] = T(0);
        for (int i = begin + threadIdx.x; i < end;
             i += CORRNMF_WIDE_THREADS) {
          const Other<T, DIM> x = other(i);
          T tq = t;
#pragma unroll
          for (int q = 0; q < kGroup; ++q, tq *= T(0.5)) {
            if (q < G) {
              T c[DIM];
#pragma unroll
              for (int j = 0; j < DIM; ++j) c[j] = b[j] + tq * d[j];
              part[q] += exp_of(dot<T, DIM>(c, x.o) + x.offset);
            }
          }
        }
        wide_sum<T, kGroup, NV>(part, G, sh, C, parity);
        int q = 0;
        for (; q < G; ++q, t *= T(0.5)) {
          T c[DIM];
#pragma unroll
          for (int j = 0; j < DIM; ++j) c[j] = b[j] + t * d[j];
          const T f = (-dot<T, DIM>(c, lin) + sh.total[q]) +
                      dot<T, DIM>(c, c) / two_var;
          if (f <= f0 + (T(1e-4) * t) * slope) break;
        }
        if (q < G) break;
        k += G;
      }
    }

    T moved = T(0);
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      const T update = t * d[j];
      b[j] += update;
      moved += abs_of(update);
    }
    ++steps;
    if (moved < row_xtol) break;  // done: the plain path freezes the row
  }

  if (threadIdx.x == 0) {
    const int64_t at =
        ((static_cast<int64_t>(lane) * N + row) * C + rank) * DIM;
#pragma unroll
    for (int j = 0; j < DIM; ++j) out[at + j] = clamp_away_from_zero(b[j]);
    if (rank == 0) steps_out[static_cast<int64_t>(lane) * N + row] = steps;
  }
  // no CTA leaves while another may still read its partials
  if (C > 1) cg::this_cluster().sync();
}

template <typename T, int DIM>
cudaError_t launch_wide(const void* b0, const void* others,
                        const void* scalings, int64_t sl, int64_t sn,
                        int64_t si, const void* scal_other, const void* aux,
                        int64_t al, int64_t an, int64_t ai,
                        const void* variance, const void* xtol, void* out,
                        int* steps, int L, int N, int M, int max_iter, int C,
                        int cached, cudaStream_t stream) {
  const size_t chunk = (static_cast<size_t>(M) + C - 1) / C;
  const size_t shared = cached ? chunk * (DIM + 1) * sizeof(T) : 0;
  cudaError_t status = cudaFuncSetAttribute(
      corrnmf_newton_wide_kernel<T, DIM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (status != cudaSuccess) return status;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(N) * C, L);
  config.blockDim = dim3(CORRNMF_WIDE_THREADS);
  config.dynamicSmemBytes = shared;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = static_cast<unsigned>(C);
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = C > 1 ? 1 : 0;
  status = cudaLaunchKernelEx(
      &config, corrnmf_newton_wide_kernel<T, DIM>, static_cast<const T*>(b0),
      static_cast<const T*>(others), static_cast<const T*>(scalings), sl, sn,
      si, static_cast<const T*>(scal_other), static_cast<const T*>(aux), al,
      an, ai, static_cast<const T*>(variance), static_cast<const T*>(xtol),
      static_cast<T*>(out), steps, N, M, max_iter, C, cached);
  if (status != cudaSuccess) return status;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide_dim(int dim, const void* b0, const void* others,
                            const void* scalings, int64_t sl, int64_t sn,
                            int64_t si, const void* scal_other,
                            const void* aux, int64_t al, int64_t an,
                            int64_t ai, const void* variance, const void* xtol,
                            void* out, int* steps, int L, int N, int M,
                            int max_iter, int C, int cached,
                            cudaStream_t stream) {
  switch (dim) {
#define CORRNMF_WIDE_CASE(DIM)                                               \
  case DIM:                                                                  \
    return launch_wide<T, DIM>(b0, others, scalings, sl, sn, si, scal_other, \
                               aux, al, an, ai, variance, xtol, out, steps,  \
                               L, N, M, max_iter, C, cached, stream);
    CORRNMF_WIDE_CASE(2)
    CORRNMF_WIDE_CASE(3)
    CORRNMF_WIDE_CASE(4)
    CORRNMF_WIDE_CASE(5)
    CORRNMF_WIDE_CASE(6)
    CORRNMF_WIDE_CASE(7)
    CORRNMF_WIDE_CASE(8)
    CORRNMF_WIDE_CASE(9)
    CORRNMF_WIDE_CASE(10)
#undef CORRNMF_WIDE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int corrnmf_newton_dim_min() { return CORRNMF_NEWTON_DIM_MIN; }

int corrnmf_newton_dim_max() { return CORRNMF_NEWTON_DIM_MAX; }

int corrnmf_newton_threads() { return CORRNMF_NEWTON_THREADS; }

// One unrolled Newton solve of L x N rows (layout above); dtype 1 float32,
// 2 float64. Returns 0 or a cudaError_t code (corrnmf_newton_error_string).
int corrnmf_newton_launch(int dtype, int dim, const void* b0,
                          const void* others, const void* scalings,
                          long long sl, long long sn, long long si,
                          const void* scal_other, const void* aux,
                          long long al, long long an, long long ai,
                          const void* variance, const void* xtol, void* out,
                          int L, int N, int M, int max_iter, void* stream) {
  if (L <= 0 || L > 65535 || N <= 0 || M <= 0 || max_iter < 0 ||
      dim < CORRNMF_NEWTON_DIM_MIN || dim > CORRNMF_NEWTON_DIM_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t status;
  if (dtype == kFloat32) {
    status = launch_dim<float>(dim, b0, others, scalings, sl, sn, si,
                               scal_other, aux, al, an, ai, variance, xtol,
                               out, L, N, M, max_iter, s);
  } else if (dtype == kFloat64) {
    status = launch_dim<double>(dim, b0, others, scalings, sl, sn, si,
                                scal_other, aux, al, an, ai, variance, xtol,
                                out, L, N, M, max_iter, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(status);
}

int corrnmf_newton_wide_threads() { return CORRNMF_WIDE_THREADS; }

int corrnmf_newton_wide_cluster_max() { return CORRNMF_WIDE_CLUSTER_MAX; }

int corrnmf_newton_wide_cache_bytes() { return CORRNMF_WIDE_CACHE_BYTES; }

// One wide Newton solve of L x N rows (the thread kernel's layout), each
// row on a cluster of `cluster` CTAs, their slices of the others kept in
// shared memory where `cached`; out (L, N, cluster, m), every CTA's copy of
// its row; steps (L, N) int32, each row's steps. Returns 0 or a cudaError_t
// code.
int corrnmf_newton_wide_launch(int dtype, int dim, const void* b0,
                               const void* others, const void* scalings,
                               long long sl, long long sn, long long si,
                               const void* scal_other, const void* aux,
                               long long al, long long an, long long ai,
                               const void* variance, const void* xtol,
                               void* out, void* steps, int L, int N, int M,
                               int max_iter, int cluster, int cached,
                               void* stream) {
  if (L <= 0 || L > 65535 || N <= 0 || M <= 0 || max_iter < 0 ||
      cluster < 1 || cluster > CORRNMF_WIDE_CLUSTER_MAX ||
      static_cast<long long>(N) * cluster > 2147483647LL ||
      dim < CORRNMF_NEWTON_DIM_MIN || dim > CORRNMF_NEWTON_DIM_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* row_steps = static_cast<int*>(steps);
  cudaError_t status;
  if (dtype == kFloat32) {
    status = launch_wide_dim<float>(dim, b0, others, scalings, sl, sn, si,
                                    scal_other, aux, al, an, ai, variance,
                                    xtol, out, row_steps, L, N, M, max_iter,
                                    cluster, cached, s);
  } else if (dtype == kFloat64) {
    status = launch_wide_dim<double>(dim, b0, others, scalings, sl, sn, si,
                                     scal_other, aux, al, an, ai, variance,
                                     xtol, out, row_steps, L, N, M, max_iter,
                                     cluster, cached, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(status);
}

const char* corrnmf_newton_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
