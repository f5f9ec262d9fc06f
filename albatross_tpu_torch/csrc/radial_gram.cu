// Radial gram tile kernel, with an optional fused diagonal epilogue.
//
// Replaces the two Pallas kernels of albatross_tpu/ops/pallas_gram.py:
//   _gram_kernel       (kernel 1: K(X, Y), the predict-time cross covariance)
//   _gram_diag_kernel  (kernel 2: K(X, X) + diag, the whole training
//                       covariance -- gram, noise, target variance, jitter --
//                       in one pass over device memory)
//
// out[i, j] = sigma^2 * profile(||x_i - y_j|| / length_scale) (+ diag[i] if i == j)
// for the squared-exponential, exponential, Matern 3/2 and Matern 5/2
// profiles, in the expression order of pallas_gram.py _apply_profile.
//
// What bounds it on an H100: writing the (N, M) output.  At N = M = 28672
// in f32 that is 3.29 GB, 0.98 ms at 3.35 TB/s; X and Y (115 KB at D = 1)
// stay in L2.  The arithmetic is close behind: about 25-30 instructions an
// element at D = 1 (the IEEE division and the precise exp dominate) take
// ~0.7 ms over 822 M elements, so they have to overlap the stores.
//
// Design:
// * Large tiles, few barriers.  A block of 8 warps makes a 64 x 128 tile:
//   warp w owns rows 8w..8w+7, each thread 4 columns of each of those rows,
//   so a thread makes 32 outputs from registers and a warp writes 512
//   contiguous bytes of a row per store.  The grid is one-dimensional over
//   tiles (row-major), so no grid dimension limits the rows.
// * Wide stores.  A thread owns 4 consecutive columns of each of its rows
//   and stores them as one float4 (two double2 in f64) where they start
//   16-byte aligned -- every row when m is a multiple of 4 -- and one by
//   one elsewhere and at the ragged right edge.  Nothing is padded.
// * No staging at small D.  For D <= 4 each thread reads its rows' x and
//   its columns' y straight from global memory (L1/L2) into registers: no
//   shared memory and no barrier.  For larger D, chunks of 16 features of
//   the tile's 64 rows and 128 columns go through shared memory (two
//   barriers a chunk), read back as broadcasts and 16-byte vectors.
//
// chip_smoke.py times both grams at the main path's shapes beside this
// bound and beside a fill_ of the same buffer (the card's write floor);
// PERF.md section 6 keeps the readings.
//
// The walker-batched form (radial_gram_diag_batched_*): the ensemble
// sampler evaluates a batch of models that differ only in their length
// scale, sigma and diagonal, which the JAX package gets from jax.vmap over
// the Pallas call (its kernel reads the scalars from params_ref).  Here one
// launch writes the (W, N, N) stack: blockIdx.x walks the tiles as above,
// blockIdx.y is the walker, whose scalars and diagonal come from device
// arrays.  Both kernels run the same tile body (gram_tile), so each slice
// equals the unbatched kernel's output bit for bit; the bound is the same
// write, W times.
//
// Deliberate difference from the TPU kernel: squared distances are exact
// elementwise sums (x_k - y_k)^2 at every D.  The TPU kernel uses a centred
// matrix-unit contraction for D >= 8 and restores exact distances only
// inside the profile's support (_REFINE_D2_OVER_LS2); outside it this kernel
// is more accurate.  A tensor-core contraction for large D is later work.
//
// Symmetry: out[i, j] and out[j, i] see (x - y) and (y - x) = -(x - y)
// exactly, the same squares, summed in ascending k with round-to-nearest
// intrinsics (no FMA contraction), so K(X, X) is bitwise symmetric and
// k(x, x) = sigma^2 exactly -- the factorization relies on both.  The
// diagonal is added only where i == j, tested only in tiles that meet it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 8;              // rows per thread (all of its warp's rows)
constexpr int COLS = 4;              // columns per thread
constexpr int BM = WARPS * ROWS;     // 64 tile rows
constexpr int BN = 32 * COLS;        // 128 tile columns
constexpr int SMALL_D = 4;           // up to this D, no shared-memory stage
constexpr int DCHUNK = 16;           // feature dims staged per pass above it
constexpr int PAD = 4;               // keeps staged rows 16-byte aligned

enum Profile { SQUARED_EXPONENTIAL = 0, EXPONENTIAL = 1, MATERN_32 = 2, MATERN_52 = 3 };

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }

// One 16-byte store of consecutive elements.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<double> {
  static constexpr int N = 2;
  __device__ __forceinline__ static void store(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

// Same operation order as pallas_gram.py _apply_profile (s2 = sigma*sigma).
template <typename T, int P>
__device__ __forceinline__ T apply_profile(T d2, T ls, T s2) {
  if (P == SQUARED_EXPONENTIAL) {
    return mul_rn(s2, exp_(-(d2 / mul_rn(ls, ls))));
  }
  T d = sqrt_(d2 > T(0) ? d2 : T(0));
  T scaled = d / ls;
  if (P == EXPONENTIAL) {
    return mul_rn(s2, exp_(-scaled));
  }
  if (P == MATERN_32) {
    T s3 = mul_rn(T(1.7320508075688772), scaled);
    return mul_rn(mul_rn(s2, add_rn(T(1), s3)), exp_(-s3));
  }
  T s5 = mul_rn(T(2.23606797749979), scaled);
  T poly = add_rn(add_rn(T(1), s5), mul_rn(s5, s5) / T(3));
  return mul_rn(mul_rn(s2, poly), exp_(-s5));
}

// acc[r][c] += (x_k - y_k)^2 over one feature k, in ascending k.
template <typename T>
__device__ __forceinline__ void accumulate(T (&acc)[ROWS][COLS], const T (&xv)[ROWS], const T (&yv)[COLS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const T diff = xv[r] - yv[c];
      acc[r][c] = add_rn(acc[r][c], mul_rn(diff, diff));
    }
  }
}

// One 64 x 128 tile (blockIdx.x) of out = K(X, Y) (+ diag); the body of
// both kernels below.
template <typename T, int P, bool STAGED>
__device__ __forceinline__ void gram_tile(const T* __restrict__ X, const T* __restrict__ Y,
                                          const T* __restrict__ diag, T* __restrict__ out, int64_t n,
                                          int64_t m, int d, int64_t col_tiles, T ls, T sigma) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = (int64_t)(blockIdx.x / col_tiles) * BM;
  const int64_t col0 = (int64_t)(blockIdx.x % col_tiles) * BN;
  const int64_t i0 = row0 + warp * ROWS;  // this thread's first row
  const int64_t j0 = col0 + COLS * lane;  // this thread's first column

  T acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = T(0);

  if (!STAGED) {
    for (int k = 0; k < d; ++k) {
      T xv[ROWS], yv[COLS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) xv[r] = i0 + r < n ? X[(i0 + r) * d + k] : T(0);
#pragma unroll
      for (int c = 0; c < COLS; ++c) yv[c] = j0 + c < m ? Y[(j0 + c) * d + k] : T(0);
      accumulate(acc, xv, yv);
    }
  } else {
    __shared__ __align__(16) T xs[DCHUNK][BM + PAD];
    __shared__ __align__(16) T ys[DCHUNK][BN + PAD];
    for (int k0 = 0; k0 < d; k0 += DCHUNK) {
      const int kc = min(DCHUNK, d - k0);
      for (int e = threadIdx.x; e < BM * DCHUNK; e += THREADS) {
        const int r = e / DCHUNK, k = e % DCHUNK;
        xs[k][r] = (k < kc && row0 + r < n) ? X[(row0 + r) * d + k0 + k] : T(0);
      }
      for (int e = threadIdx.x; e < BN * DCHUNK; e += THREADS) {
        const int c = e / DCHUNK, k = e % DCHUNK;
        ys[k][c] = (k < kc && col0 + c < m) ? Y[(col0 + c) * d + k0 + k] : T(0);
      }
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        T xv[ROWS], yv[COLS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) xv[r] = xs[k][warp * ROWS + r];
#pragma unroll
        for (int c = 0; c < COLS; ++c) yv[c] = ys[k][COLS * lane + c];
        accumulate(acc, xv, yv);
      }
      __syncthreads();
    }
  }

  const T s2 = mul_rn(sigma, sigma);
  const bool meets_diag = diag != nullptr && row0 < col0 + BN && col0 < row0 + BM;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t i = i0 + r;
    if (i >= n) break;
    T v[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) v[c] = apply_profile<T, P>(acc[r][c], ls, s2);
    if (meets_diag) {
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        if (i == j0 + c) v[c] = add_rn(v[c], diag[i]);
    }
    T* row = out + i * m + j0;
    if (j0 + COLS <= m && reinterpret_cast<uintptr_t>(row) % 16 == 0) {
#pragma unroll
      for (int c = 0; c < COLS; c += Vec<T>::N) Vec<T>::store(row + c, v + c);
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        if (j0 + c < m) row[c] = v[c];
    }
  }
}

template <typename T, int P, bool STAGED>
__global__ void __launch_bounds__(THREADS)
radial_gram_kernel(const T* __restrict__ X, const T* __restrict__ Y, const T* __restrict__ diag,
                   T* __restrict__ out, int64_t n, int64_t m, int d, int64_t col_tiles, T ls,
                   T sigma) {
  gram_tile<T, P, STAGED>(X, Y, diag, out, n, m, d, col_tiles, ls, sigma);
}

// The walker-batched training covariance: slice w = blockIdx.y of out
// (W, n, n) is K(X, X) with length scale ls[w] and sigma[w], plus diag[w]
// (W, n) on its diagonal.  The scalars come from device memory, so one
// launch serves a batch of models without reading anything back.
template <typename T, int P, bool STAGED>
__global__ void __launch_bounds__(THREADS)
radial_gram_diag_batched_kernel(const T* __restrict__ X, const T* __restrict__ ls,
                                const T* __restrict__ sigma, const T* __restrict__ diag,
                                T* __restrict__ out, int64_t n, int d, int64_t col_tiles) {
  const int64_t w = blockIdx.y;
  gram_tile<T, P, STAGED>(X, X, diag + w * n, out + w * n * n, n, n, d, col_tiles, ls[w], sigma[w]);
}

template <typename T, int P>
int launch_profile(const T* X, const T* Y, const T* diag, T* out, int64_t n, int64_t m, int d,
                   T ls, T sigma, cudaStream_t stream) {
  const int64_t col_tiles = (m + BN - 1) / BN;
  const int64_t tiles = (n + BM - 1) / BM * col_tiles;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;  // grid.x limit
  auto kernel = d > SMALL_D ? &radial_gram_kernel<T, P, true> : &radial_gram_kernel<T, P, false>;
  kernel<<<(unsigned)tiles, THREADS, 0, stream>>>(X, Y, diag, out, n, m, d, col_tiles, ls, sigma);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_batched_profile(const T* X, const T* ls, const T* sigma, const T* diag, T* out, int64_t n,
                           int d, int64_t batch, cudaStream_t stream) {
  const int64_t col_tiles = (n + BN - 1) / BN;
  const int64_t tiles = (n + BM - 1) / BM * col_tiles;
  if (tiles > 0x7fffffff || batch > 65535) return (int)cudaErrorInvalidValue;  // grid.x, grid.y limits
  auto kernel = d > SMALL_D ? &radial_gram_diag_batched_kernel<T, P, true>
                            : &radial_gram_diag_batched_kernel<T, P, false>;
  kernel<<<dim3((unsigned)tiles, (unsigned)batch), THREADS, 0, stream>>>(X, ls, sigma, diag, out, n, d,
                                                                          col_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_batched(const T* X, const T* ls, const T* sigma, const T* diag, T* out, int64_t n, int d,
                   int64_t batch, int profile, cudaStream_t stream) {
  if (n <= 0 || batch <= 0) return (int)cudaSuccess;
  switch (profile) {
    case SQUARED_EXPONENTIAL:
      return launch_batched_profile<T, SQUARED_EXPONENTIAL>(X, ls, sigma, diag, out, n, d, batch, stream);
    case EXPONENTIAL:
      return launch_batched_profile<T, EXPONENTIAL>(X, ls, sigma, diag, out, n, d, batch, stream);
    case MATERN_32:
      return launch_batched_profile<T, MATERN_32>(X, ls, sigma, diag, out, n, d, batch, stream);
    case MATERN_52:
      return launch_batched_profile<T, MATERN_52>(X, ls, sigma, diag, out, n, d, batch, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const T* X, const T* Y, const T* diag, T* out, int64_t n, int64_t m,
           int d, T ls, T sigma, int profile, cudaStream_t stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  switch (profile) {
    case SQUARED_EXPONENTIAL:
      return launch_profile<T, SQUARED_EXPONENTIAL>(X, Y, diag, out, n, m, d, ls, sigma, stream);
    case EXPONENTIAL:
      return launch_profile<T, EXPONENTIAL>(X, Y, diag, out, n, m, d, ls, sigma, stream);
    case MATERN_32:
      return launch_profile<T, MATERN_32>(X, Y, diag, out, n, m, d, ls, sigma, stream);
    case MATERN_52:
      return launch_profile<T, MATERN_52>(X, Y, diag, out, n, m, d, ls, sigma, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int radial_gram_f32(const float* X, const float* Y, const float* diag, float* out,
                    int64_t n, int64_t m, int d, float ls, float sigma, int profile,
                    void* stream) {
  return launch<float>(X, Y, diag, out, n, m, d, ls, sigma, profile, (cudaStream_t)stream);
}

int radial_gram_f64(const double* X, const double* Y, const double* diag, double* out,
                    int64_t n, int64_t m, int d, double ls, double sigma, int profile,
                    void* stream) {
  return launch<double>(X, Y, diag, out, n, m, d, ls, sigma, profile, (cudaStream_t)stream);
}

// X (n, d); ls, sigma (batch,); diag (batch, n); out (batch, n, n); all
// on the device, contiguous.
int radial_gram_diag_batched_f32(const float* X, const float* ls, const float* sigma, const float* diag,
                                 float* out, int64_t n, int d, int64_t batch, int profile, void* stream) {
  return launch_batched<float>(X, ls, sigma, diag, out, n, d, batch, profile, (cudaStream_t)stream);
}

int radial_gram_diag_batched_f64(const double* X, const double* ls, const double* sigma,
                                 const double* diag, double* out, int64_t n, int d, int64_t batch,
                                 int profile, void* stream) {
  return launch_batched<double>(X, ls, sigma, diag, out, n, d, batch, profile, (cudaStream_t)stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
