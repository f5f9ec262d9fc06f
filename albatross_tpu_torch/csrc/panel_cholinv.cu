// Panel Cholesky + triangular inverse of a b x b SPD panel, f32.
//
// Replaces the Pallas kernel albatross_tpu/ops/pallas_chol.py _panel_kernel
// (entered through pallas_panel_cholinv): for A (b, b) SPD, b % 128 == 0 and
// b <= 1024, returns U = chol(A)^T and Wu = U^-1, both upper-triangular with
// a strict lower triangle of exactly 0.  Everything is in the transposed
// (upper) space, as in the TPU kernel: the blocked factorization needs
// L = U^T and W = L^-1 = Wu^T.
//
// What bounds it on an H100: the TPU kernel keeps three b^2 f32 buffers
// (12.6 MB at b = 1024) in VMEM; one H100 block has at most 227 KB of shared
// memory, about three 128 x 128 f32 tiles.  So the panel lives in device
// memory (U and Wu together are 8 MB at b = 1024, L2-resident in the 50 MB
// L2) and the work is a short sequence of launches from one C entry:
//   per 128-row tile t (right-looking, in place in U):
//     1. tile_factor_inverse: one block factors the diagonal tile in shared
//        memory (128 rank-1 steps, upper triangle only) and inverts it by
//        row-wise back substitution (8 threads per column, shuffle sums);
//     2. the off-diagonal tile row: U[t, t+1:] = Wu[t,t]^T U[t, t+1:]
//        (a tiled FP32 GEMM into scratch, then copied back);
//     3. the in-panel trailing update: U[t+1:, t+1:] -= U[t, t+1:]^T U[t, t+1:]
//        (same GEMM; blocks wholly below the diagonal exit at once);
//   then per column tile r, the inverse composition
//     Wu[:r, r] = -(Wu[:r, :r] U[:r, r]) Wu[r, r]
//   and a final pass that zeroes U's strict lower triangle.
// The serial tile factor is the latency-bound step (128 dependent steps,
// two barriers each, on one SM); the GEMM steps spread over many blocks.
// The products are plain FP32 FMA loops (no tensor cores, no cuBLAS): the
// TPU kernel runs them at HIGHEST precision, and TF32 would not match it.
//
// A non-SPD pivot gives sqrtf(negative) = NaN, which flows through every
// later entry of the panel and out: it surfaces, it is not masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;       // tile edge
constexpr int LD = T + 1;    // padded shared-memory row
constexpr int FACTOR_THREADS = 1024;
constexpr int BM = 64, BN = 64, BK = 16;   // GEMM block tile
constexpr int GEMM_THREADS = 256;          // 16 x 16 threads, 4 x 4 outputs each

// Factor the diagonal tile at U[t0:t0+T, t0:t0+T] (leading dimension b) and
// write U_tt (strict lower zeroed) back, and its inverse to Wu_tt.
__global__ void __launch_bounds__(FACTOR_THREADS)
tile_factor_inverse(float* __restrict__ U, float* __restrict__ Wu, int b, int t0) {
  extern __shared__ float smem[];
  float* S = smem;            // the tile, factored in place
  float* X = smem + T * LD;   // its inverse
  const int tid = threadIdx.x;

  for (int e = tid; e < T * T; e += FACTOR_THREADS) {
    const int i = e / T, k = e % T;
    S[i * LD + k] = U[(size_t)(t0 + i) * b + t0 + k];
    X[i * LD + k] = 0.0f;
  }
  __syncthreads();

  // Right-looking factor of the upper triangle: row j of the result is
  // column j of the lower factor.  Only entries k >= i are read or written.
  for (int j = 0; j < T; ++j) {
    const float d = sqrtf(S[j * LD + j]);
    const float inv = 1.0f / d;
    __syncthreads();  // every thread has read the pivot
    if (tid > j && tid < T) S[j * LD + tid] *= inv;
    if (tid == j) S[j * LD + j] = d;
    __syncthreads();
    const int m = T - 1 - j;  // trailing triangle is rows/cols j+1..T-1
    for (int e = tid; e < m * m; e += FACTOR_THREADS) {
      const int i = j + 1 + e / m, k = j + 1 + e % m;
      if (k >= i) S[i * LD + k] -= S[j * LD + i] * S[j * LD + k];
    }
    __syncthreads();
  }
  for (int e = tid; e < T * T; e += FACTOR_THREADS) {
    const int i = e / T, k = e % T;
    if (k < i) S[i * LD + k] = 0.0f;
  }
  __syncthreads();

  // X = S^-1 by rows, bottom up: X[i][j] = (delta_ij - sum_{k=i+1..j}
  // S[i][k] X[k][j]) / S[i][i].  Row i needs only rows below it; 8 threads
  // share each column's sum.
  const int col = tid >> 3, part = tid & 7;
  for (int i = T - 1; i >= 0; --i) {
    float acc = 0.0f;
    if (col > i) {
      for (int k = i + 1 + part; k <= col; k += 8) acc += S[i * LD + k] * X[k * LD + col];
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (part == 0 && col >= i) {
      X[i * LD + col] = ((col == i ? 1.0f : 0.0f) - acc) / S[i * LD + i];
    }
    __syncthreads();
  }

  for (int e = tid; e < T * T; e += FACTOR_THREADS) {
    const int i = e / T, k = e % T;
    U[(size_t)(t0 + i) * b + t0 + k] = S[i * LD + k];
    Wu[(size_t)(t0 + i) * b + t0 + k] = X[i * LD + k];
  }
}

// C = alpha * op(A) B + beta * C, all row-major; op(A) is (M, K), A^T when
// TRANS_A (then A is stored (K, M)).  M, N multiples of 64, K of 16.  With
// skip_lower, blocks whose tile lies strictly below C's diagonal exit.
// beta == 0 never reads C.  Each output sums over k in order, so a product
// of the form B^T B is bitwise symmetric.
template <bool TRANS_A>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_f32(int M, int N, int K, float alpha, const float* __restrict__ A, int lda,
         const float* __restrict__ B, int ldb, float beta, float* C, int ldc,
         int skip_lower) {
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  if (skip_lower && bm >= bn + BN) return;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += GEMM_THREADS) {
      if (TRANS_A) {
        const int k = e / BM, mm = e % BM;
        As[k][mm] = A[(size_t)(k0 + k) * lda + bm + mm];
      } else {
        const int mm = e / BK, k = e % BK;
        As[k][mm] = A[(size_t)(bm + mm) * lda + k0 + k];
      }
    }
    for (int e = threadIdx.x; e < BK * BN; e += GEMM_THREADS) {
      const int k = e / BN, nn = e % BN;
      Bs[k][nn] = B[(size_t)(k0 + k) * ldb + bn + nn];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* c = C + (size_t)(bm + ty + 16 * i) * ldc + bn + tx + 16 * j;
      *c = beta == 0.0f ? alpha * acc[i][j] : alpha * acc[i][j] + beta * *c;
    }
  }
}

__global__ void zero_strict_lower(float* __restrict__ U, int b) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)b * b) return;
  const int i = (int)(e / b), k = (int)(e % b);
  if (k < i) U[e] = 0.0f;
}

cudaError_t gemm(bool trans_a, int M, int N, int K, float alpha, const float* A, int lda,
                 const float* B, int ldb, float beta, float* C, int ldc, bool skip_lower,
                 cudaStream_t stream) {
  dim3 grid(N / BN, M / BM);
  if (trans_a) {
    gemm_f32<true><<<grid, GEMM_THREADS, 0, stream>>>(M, N, K, alpha, A, lda, B, ldb, beta, C, ldc, skip_lower);
  } else {
    gemm_f32<false><<<grid, GEMM_THREADS, 0, stream>>>(M, N, K, alpha, A, lda, B, ldb, beta, C, ldc, skip_lower);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A, U, Wu: (b, b) row-major f32; scratch: b * 128 floats.  All on `stream`.
int panel_cholinv_f32(const float* A, float* U, float* Wu, float* scratch, int b, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (b <= 0 || b % T != 0 || b > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * T * LD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tile_factor_inverse,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(U, A, (size_t)b * b * sizeof(float), cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(Wu, 0, (size_t)b * b * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;

  const int tiles = b / T;
  for (int t = 0; t < tiles; ++t) {
    const int t0 = t * T;
    tile_factor_inverse<<<1, FACTOR_THREADS, smem, stream>>>(U, Wu, b, t0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int w = b - t0 - T;  // width of the tile row right of the diagonal
    if (w == 0) break;
    float* row = U + (size_t)t0 * b + t0 + T;  // U[t, t+1:], (T, w) with ld b
    // U[t, t+1:] = Wu[t,t]^T U[t, t+1:], via scratch (T, w) to avoid aliasing
    err = gemm(true, T, w, T, 1.0f, Wu + (size_t)t0 * b + t0, b, row, b, 0.0f, scratch, w, false, stream);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpy2DAsync(row, (size_t)b * sizeof(float), scratch, (size_t)w * sizeof(float),
                            (size_t)w * sizeof(float), T, cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return (int)err;
    // U[t+1:, t+1:] -= U[t, t+1:]^T U[t, t+1:]  (upper tiles only)
    float* trail = U + (size_t)(t0 + T) * b + t0 + T;
    err = gemm(true, w, w, T, -1.0f, row, b, row, b, 1.0f, trail, b, true, stream);
    if (err != cudaSuccess) return (int)err;
  }
  // Wu[:r0, r] = -(Wu[:r0, :r0] U[:r0, r]) Wu[r, r]; Wu's unwritten lower
  // tiles are zero, so the full-width product only adds exact zeros.
  for (int r = 1; r < tiles; ++r) {
    const int r0 = r * T;
    err = gemm(false, r0, T, r0, 1.0f, Wu, b, U + r0, b, 0.0f, scratch, T, false, stream);
    if (err != cudaSuccess) return (int)err;
    err = gemm(false, r0, T, T, -1.0f, scratch, T, Wu + (size_t)r0 * b + r0, b, 0.0f, Wu + r0, b, false, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t total = (size_t)b * b;
  zero_strict_lower<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(U, b);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
