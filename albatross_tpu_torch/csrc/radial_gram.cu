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
// What bounds it on an H100: the (N, M) output.  At N = M = 28672 in f32
// that is 3.3 GB written once (about 1 ms at 3.35 TB/s); the distance work
// is D subtract-multiply-adds and one exp per element, far below the FP32
// rate for the small D of the main path.  The design therefore writes each
// output element exactly once, coalesced (a warp writes 32 consecutive
// columns), and reads X and Y through shared-memory tiles so each feature
// row is fetched from device memory once per block, not once per element.
//
// Deliberate difference from the TPU kernel: squared distances are exact
// elementwise sums (x_k - y_k)^2 at every D.  The TPU kernel uses a centred
// matrix-unit contraction for D >= 8 and restores exact distances only
// inside the profile's support (_REFINE_D2_OVER_LS2); outside it this kernel
// is more accurate.  A tensor-core contraction for large D is later work.
//
// Symmetry: out[i, j] and out[j, i] see (x - y) and (y - x) = -(x - y)
// exactly, the same squares, summed in the same order with round-to-nearest
// intrinsics (no FMA contraction), so K(X, X) is bitwise symmetric and
// k(x, x) = sigma^2 exactly -- the factorization relies on both.
//
// Ragged edges are masked in the kernel; nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;      // output tile edge
constexpr int ROWS_PER = 4;   // output rows per thread (block = 32 x 8)
constexpr int DCHUNK = 16;    // feature dims staged per shared-memory pass

enum Profile { SQUARED_EXPONENTIAL = 0, EXPONENTIAL = 1, MATERN_32 = 2, MATERN_52 = 3 };

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }

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

template <typename T, int P>
__global__ void radial_gram_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                                   const T* __restrict__ diag, T* __restrict__ out,
                                   int64_t n, int64_t m, int d, T ls, T sigma) {
  __shared__ T xs[TILE][DCHUNK + 1];
  __shared__ T ys[TILE][DCHUNK + 1];
  const int tx = threadIdx.x;              // column within the tile
  const int ty = threadIdx.y;              // row group within the tile
  const int64_t row0 = (int64_t)blockIdx.y * TILE;
  const int64_t col0 = (int64_t)blockIdx.x * TILE;
  const int tid = ty * blockDim.x + tx;
  const int nthreads = blockDim.x * blockDim.y;

  T acc[ROWS_PER];
#pragma unroll
  for (int r = 0; r < ROWS_PER; ++r) acc[r] = T(0);

  for (int k0 = 0; k0 < d; k0 += DCHUNK) {
    const int kc = min(DCHUNK, d - k0);
    for (int e = tid; e < TILE * DCHUNK; e += nthreads) {
      const int r = e / DCHUNK, k = e % DCHUNK;
      const int64_t xi = row0 + r, yj = col0 + r;
      xs[r][k] = (k < kc && xi < n) ? X[xi * d + k0 + k] : T(0);
      ys[r][k] = (k < kc && yj < m) ? Y[yj * d + k0 + k] : T(0);
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const T yv = ys[tx][k];
#pragma unroll
      for (int r = 0; r < ROWS_PER; ++r) {
        const T diff = xs[ty + r * (TILE / ROWS_PER)][k] - yv;
        acc[r] = add_rn(acc[r], mul_rn(diff, diff));
      }
    }
    __syncthreads();
  }

  const T s2 = mul_rn(sigma, sigma);
  const int64_t j = col0 + tx;
  if (j >= m) return;
#pragma unroll
  for (int r = 0; r < ROWS_PER; ++r) {
    const int64_t i = row0 + ty + r * (TILE / ROWS_PER);
    if (i >= n) continue;
    T v = apply_profile<T, P>(acc[r], ls, s2);
    if (diag != nullptr && i == j) v = add_rn(v, diag[i]);
    out[i * m + j] = v;
  }
}

template <typename T>
int launch(const T* X, const T* Y, const T* diag, T* out, int64_t n, int64_t m,
           int d, T ls, T sigma, int profile, cudaStream_t stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  dim3 block(TILE, TILE / ROWS_PER);
  dim3 grid((unsigned)((m + TILE - 1) / TILE), (unsigned)((n + TILE - 1) / TILE));
  switch (profile) {
    case SQUARED_EXPONENTIAL:
      radial_gram_kernel<T, SQUARED_EXPONENTIAL><<<grid, block, 0, stream>>>(X, Y, diag, out, n, m, d, ls, sigma);
      break;
    case EXPONENTIAL:
      radial_gram_kernel<T, EXPONENTIAL><<<grid, block, 0, stream>>>(X, Y, diag, out, n, m, d, ls, sigma);
      break;
    case MATERN_32:
      radial_gram_kernel<T, MATERN_32><<<grid, block, 0, stream>>>(X, Y, diag, out, n, m, d, ls, sigma);
      break;
    case MATERN_52:
      radial_gram_kernel<T, MATERN_52><<<grid, block, 0, stream>>>(X, Y, diag, out, n, m, d, ls, sigma);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
