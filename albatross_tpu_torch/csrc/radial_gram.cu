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
// The high-D branch (f32, D >= MXU_MIN_D = 8, the TPU kernel's _MXU_MIN_D):
// the TPU kernel contracts per-tile-pair centred coordinates on its matrix
// unit, d^2 = |x - c|^2 + |y - c|^2 - 2 (x - c).(y - c), and recomputes a
// tile exactly where its smallest d^2 lies inside the profile's support
// (_REFINE_D2_OVER_LS2).  Here the contraction runs on Hopper's warpgroup
// tensor-core products, and a launch is three kernels.
// * highd_sums_kernel writes each 128-row tile's feature sums in the order
//   a tile block used to reduce them, so the centre c = (mean of the x
//   tile + mean of the y tile) / 2 costs a tile pair no reduction.  The
//   symmetric forms keep x's sums across launches (ops/radial_gram.py
//   _tile_sums): a launch that finds them ready resets its counters by a
//   memset instead.
// * highd_tile_kernel is persistent, one block an SM taking the launch's
//   tiles from a counter in entry order (a column tile's row tiles in
//   turn, so the tiles in flight share their rows in L2), and
//   warp-specialised.  Two loader warpgroups measure a tile's sixteen
//   sampled pairs exactly (one inside the cut: near), else centre its
//   rows 32 features at a time, split them into a TF32 high part and the
//   rounded remainder and write them 128-byte swizzled into a ring of two
//   operand slots handed over by mbarriers, with the rows' |x - c|^2 and
//   |y - c|^2; two consumer warpgroups contract the slot before (wgmma
//   m64n128k8, lo.hi + hi.lo + hi.hi: 3xTF32, about f32 accuracy, where
//   one TF32 pass is about 1000x off in the far field, chip_smoke.py
//   phase (i)), take the tile's smallest d^2 inside the matrix (at or
//   below cut = ratio ls^2: near), apply the far field's profile (ex2) and
//   store the tile through a swizzled stage by tensor-map (TMA) stores
//   that drain while the next tile is contracted.
// * A near tile, and every diagonal tile of K(x, x), goes to a list in
//   device scratch, which highd_exact_kernel (persistent) computes with
//   the elementwise loop's arithmetic (ascending k, _rn intrinsics), so it
//   holds the low-D path's bits and k(x, x) = sigma^2 exactly.
// Against the TPU kernel's rule this refines a superset of its tiles,
// differing only where the contracted minimum sits within the
// contraction's error above the cut.  K(x, x) (the same tensor on both
// sides) is mirrored: only tiles I >= J are computed, each written as rows
// and, staged transposed, as its mirror, so it is bitwise symmetric by
// construction and half the contraction is saved; diagonal tiles are
// always exact.  The lazy loop's column blocks and the walker-batched
// stack run the same lower tiles of the same global 128-grid from the same
// sums, so each equals the materialized covariance bit for bit; a column
// block writes a tile's mirror only where it meets the block's columns.
// Ragged tiles and rows that are not 16-byte aligned (D % 4 != 0, an
// offset view, an output width not a multiple of 4) take ordinary loads
// and stores inside the kernels.  Bound: writing the output; at D = 32 the
// 3 x 2 D n m tensor-core operations and the profile sit under it.  What
// holds it back (PERF.md section 7): the loaders' memory round trips a
// tile, and the near tiles' FP32 work.  f64 keeps the exact elementwise
// loop at every D.  Profile id 4 (SQUARED_DISTANCE) writes the refined
// d^2 itself: the backward differentiates the profile on it.
//
// Symmetry (the elementwise path): out[i, j] and out[j, i] see (x - y)
// and (y - x) = -(x - y) exactly, the same squares, summed in ascending k
// with round-to-nearest intrinsics (no FMA contraction), so K(X, X) is
// bitwise symmetric and k(x, x) = sigma^2 exactly -- the factorization
// relies on both.  The diagonal is added only where i == j, tested only in
// tiles that meet it.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

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


// ---------------------------------------------------------------------------
// The high-D branch (see the header): f32, D >= MXU_MIN_D.
// ---------------------------------------------------------------------------

constexpr int HT = 128;                        // tile edge
constexpr int KC = 32;                         // features a chunk: one 128-byte operand row
constexpr int TT = HT + 4;                     // the exact kernel's feature stage row stride, 4 mod 32
constexpr int SQUARED_DISTANCE = 4;            // profile id: write the refined d^2
constexpr int LOADERS = 256;                   // warpgroups 0 and 1: the tile list, the samples, the centring
constexpr int CONSUMERS = 256;                 // warpgroups 2 and 3: the contraction, the epilogue, the stores
constexpr int TILE_THREADS = LOADERS + CONSUMERS;
constexpr int LOADER_WARPS = LOADERS / 32;
constexpr int LOADER_ROWS = HT / (4 * LOADER_WARPS);  // row groups of 4 a loader thread takes, for x and for y
constexpr int STAGES = 2;                      // slots of the operand ring
constexpr int OPERAND_BYTES = HT * KC * 4;     // one 128 x 32 TF32 operand in 128-byte swizzled rows
constexpr int SLOT_BYTES = 4 * OPERAND_BYTES;  // x hi, x lo, y hi, y lo
constexpr int STAGE_BYTES = 4 * OPERAND_BYTES;  // the output stage: four boxes of 128 rows x 32 columns
constexpr float LOG2E = 1.4426950408889634f;
constexpr long long WAIT_CYCLES = 1ll << 32;  // a wait this long is a fault: trap, never hang

// What the loader hands over with a slot.
struct SlotInfo {
  float nx[HT], ny[HT];  // |x - c|^2 and |y - c|^2 of the tile's rows, with the last chunk (8-byte reads)
  long long tile;        // the tile's entry: walker * tiles + lower tile, or the row-major tile
  int chunk, chunks, kc8, stop;
};
constexpr int PART_BYTES = 2 * HT * 8 * 4;  // the loader lanes' partial |row - c|^2, 8 a row of x and of y
constexpr int TILE_SMEM =
    1024 + STAGES * SLOT_BYTES + STAGE_BYTES + PART_BYTES + STAGES * (int)sizeof(SlotInfo) + 160;

// -- PTX primitives of the tile kernel ---------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory"); }

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of bar with this parity has completed; trap after
// WAIT_CYCLES (a fault in the schedule, never a hang).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) {
      start = clock64();
    } else if (clock64() - start > WAIT_CYCLES) {
      __trap();
    }
  }
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Shared-memory writes by threads made visible to the asynchronous proxy
// (wgmma operands, tensor-map store sources).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// wgmma descriptor of a K-major operand in 128-byte swizzled rows (8-row
// atoms of 1024 bytes; 16-byte chunk q of row r at chunk q ^ (r % 8)).
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keeps the compiler from moving the accumulators across the asynchronous products.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b^T over 8 features: a 64 x 8 block of x, b 128 x 8 of y, TF32
// from the descriptors; d = a b^T when accumulate is 0.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One 128 x 32 box of the stage (128-byte swizzled rows) to the output
// through its tensor map, at column c0, row r0 of walker w; the map clips
// what lies past the output's ends.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* box, int c0, int r0, int w) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(box)), "r"(c0), "r"(r0), "r"(w)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }
// this thread's bulk stores have read their sources (the stage may be overwritten)
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory"); }
// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }
// 2^x by the special-function unit (2 ulp; results below 2^-126 flush
// to zero): the far field's exponential.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// -- end of the PTX primitives ------------------------------------------------

// v rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero: cvt.rna.tf32.f32's result for finite v, in two integer
// operations.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

template <int P>
__device__ __forceinline__ float highd_value(float d2, float ls, float s2) {
  return P == SQUARED_DISTANCE ? d2 : apply_profile<float, P>(d2, ls, s2);
}

// The far field's profile: a = log2(e) / ls^2 (squared exponential) or
// 1 / ls; ex2's 2 ulp are far below the contraction's own error.
template <int P>
__device__ __forceinline__ float far_value(float d2, float a, float s2) {
  if (P == SQUARED_DISTANCE) return d2;
  if (P == SQUARED_EXPONENTIAL) return s2 * ex2(-d2 * a);
  const float scaled = sqrtf(d2) * a;
  if (P == EXPONENTIAL) return s2 * ex2(-scaled * LOG2E);
  if (P == MATERN_32) {
    const float s3 = 1.7320508075688772f * scaled;
    return s2 * (1.f + s3) * ex2(-s3 * LOG2E);
  }
  const float s5 = 2.23606797749979f * scaled;
  return s2 * (1.f + s5 + s5 * s5 * (1.f / 3.f)) * ex2(-s5 * LOG2E);
}

__device__ __forceinline__ int clamp4(int64_t k) { return k < 0 ? 0 : k > 4 ? 4 : (int)k; }

// Four consecutive values to dst[0..4), those at columns [lo, hi) of the
// four: one 16-byte store when all four go and dst is aligned.
__device__ __forceinline__ void store4(float* dst, float4 v, int lo, int hi) {
  if (lo <= 0 && hi >= 4 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<float4*>(dst) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k >= lo && k < hi) dst[k] = e[k];
}

// diag[i] added to the one of four values whose column is i, if any
__device__ __forceinline__ float4 add_diagonal(float4 v, int64_t i, int64_t j, float d) {
  if (i == j) v.x = add_rn(v.x, d);
  if (i == j + 1) v.y = add_rn(v.y, d);
  if (i == j + 2) v.z = add_rn(v.z, d);
  if (i == j + 3) v.w = add_rn(v.w, d);
  return v;
}

// The arguments of every high-D kernel: x (n, d) against y (m, d), entry
// (i, j) to out[(i - off) ld + (j - off)] for i in [off, n) and j in
// [off, col_hi).  The cross form: off = 0, col_hi = ld = m, the tiles
// row-major over col_tiles.  The symmetric forms (y = x, m = n): the block
// of columns [off, col_hi), the lower tiles of the global 128-grid that
// meet it, lower_tile's order from column tile jt0; the walker-batched
// stack takes walker w's scalars, out + w out_stride and diag + w
// diag_stride.
struct HdArgs {
  const float* x;
  const float* y;
  const float* diag;     // cross: min(n, m) long; symmetric: the block's, col_hi - off long; or null
  float* out;
  const float* ls_w;     // batched: the walkers' scalars (else null)
  const float* sigma_w;
  int64_t out_stride, diag_stride;
  int64_t n, m, off, col_hi, ld;
  int64_t jt0, row_tiles;  // symmetric: the first column tile; row tiles from it to the last
  int64_t col_tiles;       // cross: column tiles
  int64_t tiles, batch;    // tiles a walker; walkers
  int64_t sx, sy;          // the feature sums of x tile I at sums + (I + sx) d, of y tile J at sums + (J + sy) d
                           // (symmetric forms: sx = sy = 0)
  float* sums;
  unsigned long long* work;  // [0]: entries taken, [1]: near tiles listed, [2..]: the list, then the sums
  int d;
  int vec4;                // every row of x and y starts 16-byte aligned
  int tma;                 // the output's tensor map is set up (16-byte aligned rows)
  float ls, sigma, ratio;
};

// k-th lower tile of the block, its column tiles in turn: column tile
// jt0 + q holds row tiles jt0 + q .. last, a - q of them, from
// S(q) = q a - q (q - 1) / 2.
__device__ __forceinline__ void lower_tile(int64_t k, int64_t a, int64_t& q, int64_t& r) {
  const double A = 2.0 * (double)a + 1.0;
  int64_t s = (int64_t)((A - sqrt(A * A - 8.0 * (double)k)) * 0.5);
  while (s > 0 && s * a - s * (s - 1) / 2 > k) --s;
  while ((s + 1) * a - (s + 1) * s / 2 <= k) ++s;
  q = s;
  r = k - (s * a - s * (s - 1) / 2);
}

// Walker w's scalars, output and diagonal.
__device__ __forceinline__ void walker(const HdArgs& a, int64_t w, float& ls, float& sigma, float*& out,
                                       const float*& diag) {
  ls = a.ls_w != nullptr ? a.ls_w[w] : a.ls;
  sigma = a.sigma_w != nullptr ? a.sigma_w[w] : a.sigma;
  out = a.out + w * a.out_stride;
  diag = a.diag == nullptr ? nullptr : a.diag + w * a.diag_stride;
}

// A near tile's entry to the list that the exact kernel works through.
__device__ __forceinline__ void defer_tile(unsigned long long* work, long long entry) {
  work[2 + atomicAdd(work + 1, 1ull)] = (unsigned long long)entry;
}

// Tile entry t of a launch: its walker, corner, scalars and refinement cut.
struct TileAt {
  int64_t w, row0, col0;
  float ls, s2, cut;
  float* out;
  const float* diag;
  bool force;  // a diagonal tile of K(x, x): always exact
};

template <bool SYM>
__device__ __forceinline__ TileAt tile_at(const HdArgs& a, long long t) {
  TileAt f;
  int64_t I, J;
  if (SYM) {
    int64_t q, r;
    f.w = t / a.tiles;
    lower_tile(t % a.tiles, a.row_tiles, q, r);
    J = a.jt0 + q;
    I = J + r;
  } else {
    f.w = 0;
    I = t / a.col_tiles;
    J = t % a.col_tiles;
  }
  f.row0 = I * HT;
  f.col0 = J * HT;
  float sigma;
  walker(a, f.w, f.ls, sigma, f.out, f.diag);
  f.s2 = mul_rn(sigma, sigma);
  f.cut = mul_rn(mul_rn(a.ratio, f.ls), f.ls);
  f.force = SYM && I == J;
  return f;
}

// Each 128-row tile's feature sums, in the order the tile kernel used to
// take them: warp w sums rows w, w + 8, .. (16 of them) in turn, rows
// past the end repeating the last row (the JAX package's
// _pad_rows(edge=True)); the warps' sums are added in turn.  Blocks
// [0, xcount) take x tiles b, the rest y tiles b - xcount; sums row b.
// Block 0 also resets the tile kernel's counters.
__global__ void __launch_bounds__(THREADS)
highd_sums_kernel(const float* __restrict__ x, int64_t n, int64_t xcount, const float* __restrict__ y, int64_t m,
                  int d, float* __restrict__ sums, unsigned long long* __restrict__ work) {
  __shared__ float part[WARPS][32];
  if (blockIdx.x == 0 && threadIdx.x < 2) work[threadIdx.x] = 0;
  const bool is_x = blockIdx.x < xcount;
  const float* A = is_x ? x : y;
  const int64_t rows = is_x ? n : m;
  const int64_t row0 = (is_x ? blockIdx.x : blockIdx.x - xcount) * HT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < d; k0 += 32) {
    const int kc = min(32, d - k0);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < HT / WARPS; ++q) {
      const int64_t i = min(row0 + warp + WARPS * q, rows - 1);
      s = __fadd_rn(s, lane < kc ? A[i * d + k0 + lane] : 0.f);
    }
    part[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && lane < kc) {
      float t = 0.f;
      for (int w = 0; w < WARPS; ++w) t = __fadd_rn(t, part[w][lane]);
      sums[(int64_t)blockIdx.x * d + k0 + lane] = t;
    }
    __syncthreads();
  }
}

// Four features k.. of row i of A, those at or past `left` of them zero.
__device__ __forceinline__ float4 load4(const float* __restrict__ A, int64_t i, int d, int k, int left, int vec4) {
  const float* p = A + i * d + k;
  if (vec4 && left >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (left > 0) v.x = p[0];
  if (left > 1) v.y = p[1];
  if (left > 2) v.z = p[2];
  if (left > 3) v.w = p[3];
  return v;
}

// One loader thread's share of chunk ch of a tile pair: features k0 + 4q..
// (q its quad) of rows 4 LOADER_WARPS it + 4 lw + sub of the x and y tiles
// (rows past the end repeat the last row), 16-byte loads where rows are
// aligned; and those four features' centre c = (mean of the x tile + mean
// of the y tile) / 2 from the pre-pass's sums, so c keeps the bits a tile
// block's own reduction gave it.
struct Chunk {
  float4 xv[LOADER_ROWS], yv[LOADER_ROWS];
  float sx[4], sy[4];  // the two tiles' sums of the four features, for c
  float c[4];
};

template <bool SYM>
__device__ __forceinline__ void load_chunk(const HdArgs& a, const TileAt& f, int ch, int lw, int sub, int quad,
                                           Chunk& k) {
  const int k0 = ch * KC, left = min(KC, a.d - k0) - 4 * quad;
  const float* sx = a.sums + (f.row0 / HT + a.sx) * a.d + k0 + 4 * quad;
  const float* sy = a.sums + (f.col0 / HT + a.sy) * a.d + k0 + 4 * quad;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    k.sx[e] = e < left ? sx[e] : 0.f;
    k.sy[e] = e < left ? sy[e] : 0.f;
  }
#pragma unroll
  for (int it = 0; it < LOADER_ROWS; ++it) {
    const int r = 4 * LOADER_WARPS * it + 4 * lw + sub;
    k.xv[it] = load4(a.x, min(f.row0 + r, a.n - 1), a.d, k0 + 4 * quad, left, a.vec4);
    k.yv[it] = load4(a.y, min(f.col0 + r, a.m - 1), a.d, k0 + 4 * quad, left, a.vec4);
  }
}

// The chunk's centre, once its sums have arrived: c = (S_x / 128 + S_y /
// 128) / 2, each step rounded as the tile block's own reduction did.
__device__ __forceinline__ void centre_of(Chunk& k) {
#pragma unroll
  for (int e = 0; e < 4; ++e) k.c[e] = __fmul_rn(0.5f, __fadd_rn(__fmul_rn(k.sx[e], 1.f / HT), __fmul_rn(k.sy[e], 1.f / HT)));
}

// Four features of one row centred at c, split into TF32 hi + lo and, when
// live (the contraction reads them), written as 16-byte chunk `quad` of
// row r of the hi operand and of the lo operand OPERAND_BYTES after it, at
// chunk quad ^ (r % 8).  Returns this lane's share of |row - c|^2 from
// hi + lo, its four features in ascending k.
__device__ __forceinline__ float centre_split(float4 v, const float (&c)[4], bool live, unsigned char* hi, int r,
                                              int quad) {
  float s = 0.f;
  if (live) {
    const float e[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xc = __fsub_rn(e[k], c[k]);
      h[k] = tf32_rna(xc);
      l[k] = tf32_rna(__fsub_rn(xc, __uint_as_float(h[k])));
      const float w = __fadd_rn(__uint_as_float(h[k]), __uint_as_float(l[k]));
      s = __fadd_rn(s, __fmul_rn(w, w));
    }
    const int at = r * 128 + ((quad ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(hi + OPERAND_BYTES + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
  return s;
}

// The loader warpgroups (eight warps).  They take tiles from the launch's
// counter (work[0]) in entry order, thread 0 fetching the next entry one
// tile ahead, and measure each tile's sixteen sampled pairs exactly, with
// its first chunk's loads in flight: rows {0, 42, 84, 127} of each tile
// (clamped to the matrix), two pairs a warp, each in ascending k with
// fmaf, summed across the warp pairwise.  When one lies inside the cut the
// tile is near whatever the contraction would give (its smallest d^2 can
// only be smaller) and goes to the list, as a diagonal tile of K(x, x)
// does; the decision depends on the tile's rows only, so every launch form
// decides it alike.  A far tile's rows go to the ring a chunk of 32
// features at a time, centred, split and written swizzled into a free
// slot; with the last chunk each row's |x - c|^2 and |y - c|^2, its eight
// lanes' shares added in lane order through `part`, one code for x and y.
template <bool SYM>
__device__ __forceinline__ void tile_loader(const HdArgs& a, unsigned char* ring, SlotInfo* info, uint64_t* full,
                                           uint64_t* empty, float* part, float* smin, long long* next) {
  const int lt = threadIdx.x, lw = lt >> 5, lane = lt & 31;
  const int sub = lane >> 3, quad = lane & 7;  // rows 4 LOADER_WARPS it + 4 lw + sub, features 4 quad..
  const int d = a.d, chunks = (d + KC - 1) / KC;
  const long long total = a.tiles * a.batch;
  int stage = 0;
  uint32_t phase = 0;
  long long ahead = 0;  // thread 0: the entry after this one
  if (lt == 0) ahead = (long long)atomicAdd(a.work, 1ull);
  Chunk k;
  for (;;) {
    if (lt == 0) {
      *next = ahead;
      ahead = (long long)atomicAdd(a.work, 1ull);
    }
    bar_sync(1, LOADERS);
    const long long tile = *reinterpret_cast<volatile long long*>(next);
    if (tile >= total) break;
    const TileAt f = tile_at<SYM>(a, tile);
    load_chunk<SYM>(a, f, 0, lw, sub, quad, k);  // in flight while the samples are measured
    if (!f.force) {
      constexpr int PAIRS = 16 / LOADER_WARPS;
      int64_t i[PAIRS], j[PAIRS];
      float s[PAIRS];
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const int pair = PAIRS * lw + p;
        i[p] = min(f.row0 + (127 * (pair >> 2)) / 3, a.n - 1);
        j[p] = min(f.col0 + (127 * (pair & 3)) / 3, a.m - 1);
        s[p] = 0.f;
      }
      for (int k0 = 0; k0 < d; k0 += 32) {
        const int kk = k0 + lane;
        float diff[PAIRS];
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) diff[p] = kk < d ? a.x[i[p] * d + kk] - a.y[j[p] * d + kk] : 0.f;
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) s[p] = __fmaf_rn(diff[p], diff[p], s[p]);
      }
      float pmin = __int_as_float(0x7f800000);
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s[p] += __shfl_xor_sync(0xffffffffu, s[p], o);
        pmin = fminf(pmin, s[p]);
      }
      if (lane == 0) smin[lw] = pmin;
    }
    bar_sync(1, LOADERS);  // smin is written; every thread has read `next`
    float sampled = smin[0];
    for (int w = 1; w < LOADER_WARPS; ++w) sampled = fminf(sampled, smin[w]);
    if (f.force || sampled <= f.cut) {
      if (lt == 0) defer_tile(a.work, tile);
      continue;
    }
    float nx[LOADER_ROWS], ny[LOADER_ROWS];
#pragma unroll
    for (int it = 0; it < LOADER_ROWS; ++it) nx[it] = ny[it] = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch > 0) load_chunk<SYM>(a, f, ch, lw, sub, quad, k);
      centre_of(k);
      const int kc8 = (min(KC, d - ch * KC) + 7) & ~7;
      const bool live = 4 * quad < kc8;
      mbar_wait(&empty[stage], phase ^ 1);
      unsigned char* slot = ring + stage * SLOT_BYTES;
#pragma unroll
      for (int it = 0; it < LOADER_ROWS; ++it) {
        const int r = 4 * LOADER_WARPS * it + 4 * lw + sub;
        nx[it] = __fadd_rn(nx[it], centre_split(k.xv[it], k.c, live, slot, r, quad));
        ny[it] = __fadd_rn(ny[it], centre_split(k.yv[it], k.c, live, slot + 2 * OPERAND_BYTES, r, quad));
      }
      SlotInfo& si = info[stage];
      if (ch == chunks - 1) {  // each row's eight lane shares, added in lane order, one code for x and y
#pragma unroll
        for (int it = 0; it < LOADER_ROWS; ++it) {
          const int r = 4 * LOADER_WARPS * it + 4 * lw + sub;
          part[r * 8 + quad] = nx[it];
          part[(HT + r) * 8 + quad] = ny[it];
        }
        bar_sync(1, LOADERS);
        float norm = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) norm = __fadd_rn(norm, part[lt * 8 + q]);
        (lt < HT ? si.nx : si.ny)[lt & (HT - 1)] = norm;
      }
      if (lt == 0) {
        si.tile = tile;
        si.chunk = ch;
        si.chunks = chunks;
        si.kc8 = kc8;
        si.stop = 0;
      }
      fence_proxy_async();
      mbar_arrive(&full[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  mbar_wait(&empty[stage], phase ^ 1);
  if (lt == 0) info[stage].stop = 1;
  mbar_arrive(&full[stage]);
}

// Byte offset of entry (r, c) of a 128 x 128 tile in the stage: four
// boxes of 32 columns (the tensor map's box), each 128 rows of 128 bytes,
// 16-byte chunk q of row r at chunk q ^ (r % 8) (the map's 128-byte
// swizzle; the fragments' 8-byte and 4-byte writes meet no bank twice).
__device__ __forceinline__ int stage_at(int r, int c) {
  return (c >> 5) * OPERAND_BYTES + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// The staged tile, entry (r, c) to row R0 + r, column C0 + c of walker
// w's output where that lies inside [off, n) x [off, col_hi): by the
// tensor map, thread 0 storing the four boxes (the map clips rows and
// columns past the ends), when the map is set up and the tile starts
// inside the block; else by 16-byte or single stores, warp w taking rows
// w, w + 8, ...  Returns whether this thread issued a bulk store.
__device__ __forceinline__ bool store_tile(const unsigned char* st, const CUtensorMap* map, float* out, const HdArgs& a,
                                           int64_t w, int64_t R0, int64_t C0, int ct) {
  const int r_lo = (int)max((int64_t)0, a.off - R0), r_hi = (int)min((int64_t)HT, a.n - R0);
  const int c_lo = (int)max((int64_t)0, a.off - C0), c_hi = (int)min((int64_t)HT, a.col_hi - C0);
  if (r_lo >= r_hi || c_lo >= c_hi) return false;
  if (a.tma && r_lo == 0 && c_lo == 0) {
    if (ct != 0) return false;
#pragma unroll
    for (int b = 0; b < HT / KC; ++b)
      tma_store(map, st + b * OPERAND_BYTES, (int)(C0 + KC * b - a.off), (int)(R0 - a.off), (int)w);
    bulk_commit();
    return true;
  }
  float* first = out + (R0 - a.off) * a.ld + (C0 - a.off);  // entry (0, 0)'s place, maybe outside out
  const int lane = ct & 31;
  for (int r = r_lo + (ct >> 5); r < r_hi; r += CONSUMERS / 32) {
    const float4 v = *reinterpret_cast<const float4*>(st + stage_at(r, 4 * lane));
    store4(first + r * a.ld + 4 * lane, v, clamp4(c_lo - 4 * lane), clamp4(c_hi - 4 * lane));
  }
  return false;
}

// The near tiles, and every diagonal tile of K(x, x), from the list (the
// tile kernel's work[2..], work[1] of them), by the elementwise loop's
// arithmetic (gram_tile's staged body: each entry's squares summed in
// ascending k with round-to-nearest intrinsics, the same profile), so
// they hold the loop's bits.  A persistent grid at three blocks an SM,
// each block taking half a tile (64 rows) at a time: warp w takes rows
// 8 w.. of the half, lane l columns 4 l..; 32 features of the half's rows
// and of the y tile at a time go through shared memory (feature-major),
// all of a thread's loads issued before any is staged, read back as
// broadcasts and 16-byte vectors.  Entry (i, j) goes to
// out[(i - off) ld + (j - off)] when i is in [off, n) and j in
// [off, col_hi), plus diag[i - off] where i == j; a lower tile (I, J),
// I > J, of the symmetric forms also to its mirror (J, I) where that
// meets the block's columns, through a transposed stage (row stride EM:
// four-way bank conflicts on its writes, none on its reads).
constexpr int EH = HT / 2;               // rows a block
constexpr int EX = EH + 4, EM = EH + 1;  // the x stage's and the mirror stage's row strides
constexpr int EXACT_FLOATS = HT * EM > KC * (EX + TT) ? HT * EM : KC * (EX + TT);
template <int P, bool SYM>
__global__ void __launch_bounds__(THREADS, 3) highd_exact_kernel(const HdArgs a) {
  __shared__ __align__(16) float smem[EXACT_FLOATS];
  float (*xs)[EX] = reinterpret_cast<float (*)[EX]>(smem);
  float (*ys)[TT] = reinterpret_cast<float (*)[TT]>(smem + KC * EX);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d = a.d;
  const unsigned long long halves = 2 * a.work[1];
  for (unsigned long long u = blockIdx.x; u < halves; u += gridDim.x) {
    const TileAt f = tile_at<SYM>(a, (long long)a.work[2 + (u >> 1)]);
    const int64_t row0 = f.row0 + EH * (int64_t)(u & 1);
    if (row0 >= a.n) continue;
    const int64_t i0 = row0 + ROWS * warp, jl = f.col0 + COLS * lane;  // this thread's first row and column
    float acc[ROWS][COLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < d; k0 += KC) {
      const int kc = min(KC, d - k0);
      const bool in = lane < kc;  // feature k0 + lane
      float xf[EH / WARPS], yf[HT / WARPS];
#pragma unroll
      for (int q = 0; q < EH / WARPS; ++q) {
        const int64_t i = row0 + warp + WARPS * q;
        xf[q] = in && i < a.n ? a.x[i * d + k0 + lane] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < HT / WARPS; ++q) {
        const int64_t j = f.col0 + warp + WARPS * q;
        yf[q] = in && j < a.m ? a.y[j * d + k0 + lane] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < EH / WARPS; ++q) xs[lane][warp + WARPS * q] = xf[q];
#pragma unroll
      for (int q = 0; q < HT / WARPS; ++q) ys[lane][warp + WARPS * q] = yf[q];
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        float xv[ROWS], yv[COLS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) xv[r] = xs[k][ROWS * warp + r];
#pragma unroll
        for (int c = 0; c < COLS; ++c) yv[c] = ys[k][COLS * lane + c];
        accumulate(acc, xv, yv);
      }
      __syncthreads();  // the chunks are read: the next chunk, or the mirror, may overwrite them
    }
    const bool mirror = SYM && !f.force && f.row0 < a.col_hi;
    const int lo = clamp4(a.off - jl), hi = clamp4(min(a.col_hi, a.m) - jl);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int64_t i = i0 + r;
      float4 value = make_float4(highd_value<P>(acc[r][0], f.ls, f.s2), highd_value<P>(acc[r][1], f.ls, f.s2),
                                 highd_value<P>(acc[r][2], f.ls, f.s2), highd_value<P>(acc[r][3], f.ls, f.s2));
      if (mirror) {
        smem[(COLS * lane) * EM + ROWS * warp + r] = value.x;
        smem[(COLS * lane + 1) * EM + ROWS * warp + r] = value.y;
        smem[(COLS * lane + 2) * EM + ROWS * warp + r] = value.z;
        smem[(COLS * lane + 3) * EM + ROWS * warp + r] = value.w;
      }
      if (i >= a.n || i < a.off || lo >= hi) continue;
      if (f.diag != nullptr && i >= jl && i < jl + 4) value = add_diagonal(value, i, jl, f.diag[i - a.off]);
      store4(f.out + (i - a.off) * a.ld + (jl - a.off), value, lo, hi);
    }
    if (mirror) {
      __syncthreads();
      for (int c = warp; c < HT; c += WARPS) {  // mirror row col0 + c: the half's rows as its columns
        const int64_t j = f.col0 + c;
        if (j >= a.n || j < a.off) continue;
#pragma unroll
        for (int h = 0; h < EH; h += 32) {
          const int64_t i = row0 + h + lane;
          if (i < a.n && i >= a.off && i < a.col_hi) f.out[(j - a.off) * a.ld + (i - a.off)] = smem[c * EM + h + lane];
        }
      }
    }
    __syncthreads();  // the stages are read: the next half may fill them
  }
}

// The consumer warpgroups.  Warpgroup cw contracts rows 64 cw.. of the x
// tile with the y tile on the tensor cores (wgmma m64n128k8, TF32 from the
// ring; 3xTF32, a step of 8 features as lo.hi, hi.lo, hi.hi), forms
// d^2 = max(|x - c|^2 + |y - c|^2 - 2 cross, 0) and, with the other
// warpgroup, the tile's smallest d^2 over its entries inside the matrix.
// At or below the cut the tile is near and goes to the list.  Else each
// value takes the far field's profile (ex2, products by 1 / ls), goes
// through the swizzled stage and out by asynchronous tensor-map stores,
// which drain while the next tile is contracted; the symmetric forms stage
// the mirror (J, I) transposed and store it too where it meets the
// block's columns.
template <int P, bool SYM>
__device__ __forceinline__ void tile_consumer(const HdArgs& a, const CUtensorMap* map, unsigned char* ring,
                                             SlotInfo* info, uint64_t* full, uint64_t* empty, unsigned char* st,
                                             float* wmin) {
  const int ct = threadIdx.x - LOADERS, cw = ct >> 7, warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rbase = 64 * cw + 16 * (warp & 3) + g;  // rows rbase, rbase + 8; columns 8 j + 2 t, + 1
  int stage = 0, odd = 0;
  uint32_t phase = 0;
  bool pending = false;  // this thread's bulk stores may still read the stage
  for (;;) {
    mbar_wait(&full[stage], phase);
    __syncwarp();
    if (info[stage].stop) break;
    const long long tile = info[stage].tile;
    const TileAt f = tile_at<SYM>(a, tile);
    float acc[64];
    float lmin = __int_as_float(0x7f800000);
    for (int chunk = 0;; ++chunk) {  // the tile's chunks, one slot each
      const SlotInfo& si = info[stage];
      const int kc8 = si.kc8;
      const bool last = chunk == si.chunks - 1;
      const uint32_t slot = smem_u32(ring + stage * SLOT_BYTES);
      const uint64_t xh = operand_desc(slot + cw * 64 * 128), xl = operand_desc(slot + OPERAND_BYTES + cw * 64 * 128);
      const uint64_t yh = operand_desc(slot + 2 * OPERAND_BYTES), yl = operand_desc(slot + 3 * OPERAND_BYTES);
      fence_operands(acc);
      wgmma_fence();
      for (int k = 0; k < kc8 / 8; ++k) {  // 8 features: 32 bytes, 2 descriptor units
        wgmma_tf32(acc, xl + 2 * k, yh + 2 * k, chunk > 0 || k > 0);
        wgmma_tf32(acc, xh + 2 * k, yl + 2 * k, 1);
        wgmma_tf32(acc, xh + 2 * k, yh + 2 * k, 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_operands(acc);
      if (last) {
        const int64_t rows_in = a.n - f.row0, cols_in = a.m - f.col0;
        const float x0 = si.nx[rbase], x1 = si.nx[rbase + 8];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 yn = *reinterpret_cast<const float2*>(&si.ny[8 * j + 2 * t]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rbase + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
            const float d2 =
                fmaxf(__fmaf_rn(-2.f, acc[4 * j + e], __fadd_rn(e >> 1 ? x1 : x0, e & 1 ? yn.y : yn.x)), 0.f);
            acc[4 * j + e] = d2;
            if (r < rows_in && c < cols_in) lmin = fminf(lmin, d2);
          }
        }
      }
      mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      if (last) break;
      mbar_wait(&full[stage], phase);
      __syncwarp();
    }

#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lmin = fminf(lmin, __shfl_xor_sync(0xffffffffu, lmin, o));
    if (pending) {
      bulk_wait_read();
      pending = false;
    }
    float* wm = wmin + 8 * odd;  // two sets: a fast warp's next write cannot meet this tile's reads
    odd ^= 1;
    if (lane == 0) wm[warp] = lmin;
    bar_sync(2, CONSUMERS);  // the warps' minima are written; the stage is free
    float tmin = wm[0];
    for (int w = 1; w < CONSUMERS / 32; ++w) tmin = fminf(tmin, wm[w]);
    if (tmin <= f.cut) {
      if (ct == 0) defer_tile(a.work, tile);
      continue;
    }
    const float scale = P == SQUARED_EXPONENTIAL ? LOG2E / (f.ls * f.ls) : 1.f / f.ls;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = far_value<P>(acc[i], scale, f.s2);
    if (!SYM && f.diag != nullptr && f.row0 == f.col0) {  // the cross form's tile on the diagonal
      const int64_t on = min(a.n, a.m) - f.row0;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rbase + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
          if (r == c && r < on) acc[4 * j + e] = add_rn(acc[4 * j + e], f.diag[f.row0 + r]);
        }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(st + stage_at(rbase + 8 * h, 8 * j + 2 * t)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    fence_proxy_async();
    bar_sync(2, CONSUMERS);
    pending = store_tile(st, map, f.out, a, f.w, f.row0, f.col0, ct);
    if (SYM && f.row0 < a.col_hi) {  // the mirror (J, I) meets the block's columns
      if (pending) {
        bulk_wait_read();
        pending = false;
      }
      bar_sync(2, CONSUMERS);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<float*>(st + stage_at(8 * j + 2 * t + (e & 1), rbase + 8 * (e >> 1))) = acc[4 * j + e];
      fence_proxy_async();
      bar_sync(2, CONSUMERS);
      pending = store_tile(st, map, f.out, a, f.w, f.col0, f.row0, ct);
    }
  }
  bulk_wait();
}

// Every tile of every launch form: one block an SM walks the launch's
// tiles, a loader warpgroup feeding two consumer warpgroups through a ring
// of STAGES operand slots (mbarriers: `full` when the loader has written a
// slot, `empty` when the consumers have read it).
template <int P, bool SYM>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    highd_tile_kernel(const HdArgs a, const __grid_constant__ CUtensorMap out_map) {
  extern __shared__ unsigned char tile_smem[];
  // the ring 1024-byte aligned (the swizzle's atoms), by offsetting the shared pointer itself so the compiler
  // keeps every access below in the shared space
  unsigned char* ring = tile_smem + ((1024 - (smem_u32(tile_smem) & 1023)) & 1023);
  unsigned char* st = ring + STAGES * SLOT_BYTES;
  float* part = reinterpret_cast<float*>(st + STAGE_BYTES);
  SlotInfo* info = reinterpret_cast<SlotInfo*>(st + STAGE_BYTES + PART_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(info + STAGES);
  uint64_t* empty = full + STAGES;
  float* wmin = reinterpret_cast<float*>(empty + STAGES);  // 2 x 8
  float* smin = wmin + 16;                                 // LOADER_WARPS
  long long* next = reinterpret_cast<long long*>(smin + LOADER_WARPS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], LOADERS);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < LOADERS) {
    tile_loader<SYM>(a, ring, info, full, empty, part, smin, next);
  } else {
    tile_consumer<P, SYM>(a, &out_map, ring, info, full, empty, st, wmin);
  }
}

// Once per process for each profile, form and device: the tile kernel's
// shared-memory opt-in and grid (one block an SM) and the exact kernel's
// grid (as many blocks as the card holds at once).
struct LaunchCache {
  int tile_blocks, exact_blocks;
};
constexpr int MAX_DEVICES = 64;

int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

template <int P, bool SYM>
int launch_cache(LaunchCache& grids) {
  static LaunchCache cached[MAX_DEVICES];
  int device = 0;
  int code = (int)cudaGetDevice(&device);
  if (code != 0) return code;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  LaunchCache& c = cached[device];
  if (c.tile_blocks == 0) {
    int sms = 0, per_sm = 0;
    code = (int)cudaFuncSetAttribute(highd_tile_kernel<P, SYM>, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_SMEM);
    if (code == 0) code = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (code == 0)
      code = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, highd_exact_kernel<P, SYM>, THREADS, 0);
    if (code != 0) return code;
    c.exact_blocks = sms * (per_sm > 0 ? per_sm : 1);
    c.tile_blocks = sms;
  }
  grids = c;
  return 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once a process by the runtime's entry-point query.
int tensor_map_encoder(EncodeTiled& encode) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const int code =
        (int)cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (code != 0) return code;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(fn);
  }
  encode = cached;
  return 0;
}

// The output's tensor map for the tile kernel's stores (columns, rows,
// walkers; boxes of 32 x 128 x 1; 128-byte swizzle) when its rows start
// 16-byte aligned, a.tma = 1; else a.tma = 0 and the kernel stores by
// ordinary stores.
int out_map(HdArgs& a, CUtensorMap& map) {
  std::memset(&map, 0, sizeof(map));
  a.tma = 0;
  const int64_t rows = a.n - a.off, width = a.col_hi - a.off;
  const uint64_t walker_stride = a.batch > 1 ? (uint64_t)a.out_stride * 4 : (uint64_t)(rows * a.ld * 4 + 15) / 16 * 16;
  if ((a.ld & 3) != 0 || (reinterpret_cast<uintptr_t>(a.out) & 15) != 0 || walker_stride % 16 != 0) return 0;
  EncodeTiled encode = nullptr;
  const int code = tensor_map_encoder(encode);
  if (code != 0) return code;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)a.batch};
  const cuuint64_t strides[2] = {(cuuint64_t)a.ld * 4, walker_stride};
  const cuuint32_t box[3] = {KC, HT, 1}, unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, a.out, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  a.tma = 1;
  return 0;
}

// One launch form: the tiles' feature sums (sum_x x tiles and sum_y y
// tiles from 0; none when they are already in a.sums, and the counters
// are reset by a memset instead), the tile kernel's persistent grid over
// every tile, the exact kernel's over the near ones.
template <int P, bool SYM>
int launch_highd_profile(HdArgs a, int64_t sum_x, int64_t sum_y, cudaStream_t stream) {
  LaunchCache grids{};
  CUtensorMap map;
  int code = launch_cache<P, SYM>(grids);
  if (code == 0) code = out_map(a, map);
  if (code != 0) return code;
  const int64_t total = a.tiles * a.batch;
  if (sum_x + sum_y > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (sum_x + sum_y > 0) {
    highd_sums_kernel<<<(unsigned)(sum_x + sum_y), THREADS, 0, stream>>>(a.x, a.n, sum_x, a.y, a.m, a.d, a.sums,
                                                                        a.work);
  } else {
    code = (int)cudaMemsetAsync(a.work, 0, 2 * sizeof(unsigned long long), stream);
    if (code != 0) return code;
  }
  highd_tile_kernel<P, SYM><<<(unsigned)min64(total, grids.tile_blocks), TILE_THREADS, TILE_SMEM, stream>>>(a, map);
  highd_exact_kernel<P, SYM><<<(unsigned)min64(2 * total, grids.exact_blocks), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool SYM>
int launch_highd(const HdArgs& a, int64_t sum_x, int64_t sum_y, int profile, cudaStream_t stream) {
  switch (profile) {
    case SQUARED_EXPONENTIAL:
      return launch_highd_profile<SQUARED_EXPONENTIAL, SYM>(a, sum_x, sum_y, stream);
    case EXPONENTIAL:
      return launch_highd_profile<EXPONENTIAL, SYM>(a, sum_x, sum_y, stream);
    case MATERN_32:
      return launch_highd_profile<MATERN_32, SYM>(a, sum_x, sum_y, stream);
    case MATERN_52:
      return launch_highd_profile<MATERN_52, SYM>(a, sum_x, sum_y, stream);
    case SQUARED_DISTANCE:
      return launch_highd_profile<SQUARED_DISTANCE, SYM>(a, sum_x, sum_y, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The work words' layout (ops/radial_gram.py _work_words mirrors it): the
// entry counter, the near tiles' count, a list word for each of the
// launch's `entries` tiles, then (the cross form) the f32 sums of its row
// tiles.
float* work_sums(unsigned long long* work, int64_t entries) { return reinterpret_cast<float*>(work + 2 + entries); }

int launch_highd_cross(const float* X, const float* Y, const float* diag, float* out, int64_t n, int64_t m, int d,
                       float ls, float sigma, float ratio, int profile, unsigned long long* work,
                       cudaStream_t stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  HdArgs a{};
  const int64_t nt = (n + HT - 1) / HT, mt = (m + HT - 1) / HT;
  a.x = X;
  a.y = Y;
  a.diag = diag;
  a.out = out;
  a.n = n;
  a.m = m;
  a.col_hi = a.ld = m;
  a.col_tiles = mt;
  a.tiles = nt * mt;
  a.batch = 1;
  a.sy = nt;
  a.work = work;
  a.sums = work_sums(work, a.tiles);
  a.d = d;
  a.vec4 = d % 4 == 0 && aligned16(X) && aligned16(Y);
  a.ls = ls;
  a.sigma = sigma;
  a.ratio = ratio;
  return launch_highd<false>(a, nt, mt, profile, stream);
}

int launch_highd_sym(const float* x, const float* diag, float* out, const float* ls_w, const float* sigma_w,
                     int64_t n, int d, int64_t j0, int64_t b, int64_t batch, float ls, float sigma, float ratio,
                     int profile, unsigned long long* work, float* sums, int sums_ready, cudaStream_t stream) {
  if (n <= 0 || b <= 0 || batch <= 0) return (int)cudaSuccess;
  if (d <= 0 || j0 < 0 || j0 + b > n) return (int)cudaErrorInvalidValue;
  HdArgs a{};
  a.x = a.y = x;
  a.diag = diag;
  a.out = out;
  a.ls_w = ls_w;
  a.sigma_w = sigma_w;
  a.out_stride = (n - j0) * b;
  a.diag_stride = b;
  a.n = a.m = n;
  a.off = j0;
  a.col_hi = j0 + b;
  a.ld = b;
  a.jt0 = j0 / HT;
  a.row_tiles = (n + HT - 1) / HT - a.jt0;
  const int64_t cols = (j0 + b - 1) / HT - a.jt0 + 1;
  a.tiles = cols * a.row_tiles - cols * (cols - 1) / 2;
  a.batch = batch;
  a.work = work;
  a.sums = sums;  // every row tile of x, from the first
  a.d = d;
  a.vec4 = d % 4 == 0 && aligned16(x);
  a.ls = ls;
  a.sigma = sigma;
  a.ratio = ratio;
  return launch_highd<true>(a, sums_ready ? 0 : (n + HT - 1) / HT, 0, profile, stream);
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

// The high-D branch (f32).  ratio: the profile's refinement cut over ls^2;
// profile 4 writes the refined d^2; work: device scratch of 2 + tiles +
// ceil(sum_tiles d / 2) 8-byte words (two counters, the near list, the
// tiles' feature sums).  The cross form: X (n, d), Y (m, d), out (n, m),
// diag (min(n, m),) or null; tiles = ceil(n / 128) ceil(m / 128),
// sum_tiles = ceil(n / 128) + ceil(m / 128).
int radial_gram_highd_f32(const float* X, const float* Y, const float* diag, float* out, int64_t n, int64_t m,
                          int d, float ls, float sigma, float ratio, int profile, void* work, void* stream) {
  return launch_highd_cross(X, Y, diag, out, n, m, d, ls, sigma, ratio, profile,
                            static_cast<unsigned long long*>(work), (cudaStream_t)stream);
}

// The symmetric forms: out (n - j0, b) holds rows [j0, n) of columns
// [j0, j0 + b) of K(x, x), diag (b,) or null on its leading diagonal;
// j0 = 0, b = n is the whole training covariance; tiles: the lower tiles
// of the global 128-grid that meet the block, each a list word of work
// (2 + tiles words); sums: ceil(n / 128) x d floats, the feature sums of
// all of x's row tiles, computed by this launch unless sums_ready (x's
// earlier launches on this stream left them).
int radial_gram_highd_sym_f32(const float* x, const float* diag, float* out, int64_t n, int d, int64_t j0,
                              int64_t b, float ls, float sigma, float ratio, int profile, void* work, void* sums,
                              int sums_ready, void* stream) {
  return launch_highd_sym(x, diag, out, nullptr, nullptr, n, d, j0, b, 1, ls, sigma, ratio, profile,
                          static_cast<unsigned long long*>(work), static_cast<float*>(sums), sums_ready,
                          (cudaStream_t)stream);
}

// The walker-batched training covariance: ls, sigma (batch,), diag
// (batch, n), out (batch, n, n), all on the device; tiles times batch
// list words; sums as K(x, x)'s.
int radial_gram_highd_batched_f32(const float* x, const float* ls, const float* sigma, const float* diag,
                                  float* out, int64_t n, int d, int64_t batch, float ratio, int profile, void* work,
                                  void* sums, int sums_ready, void* stream) {
  return launch_highd_sym(x, diag, out, ls, sigma, n, d, 0, n, batch, 0.f, 0.f, ratio, profile,
                          static_cast<unsigned long long*>(work), static_cast<float*>(sums), sums_ready,
                          (cudaStream_t)stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
