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
// (_REFINE_D2_OVER_LS2).  Here that contraction runs on the tensor cores.
// A 256-thread block makes one 128 x 128 tile, each warp 32 x 64 of it:
// c is half the sum of the x tile's and the y tile's feature means (rows
// past the end replicate the last row, as _pad_rows(edge=True)); 32
// features at a time are loaded to registers, centred, zero-padded to a
// multiple of 8, split into a TF32 high part (rounded to nearest) and the
// rounded remainder, and contracted as lo.hi + hi.lo + hi.hi with
// mma.sync m16n8k8 (3xTF32: about f32 accuracy, where one TF32 pass is
// about 1000x off in the far field, chip_smoke.py phase (i)).  |x - c|^2
// and |y - c|^2 come from one reduction code, d^2 = max(x2 + y2 - 2 cross,
// 0).  The block then reduces the tile's smallest d^2 over its entries
// inside the matrix; a tile at or below cut = ratio * ls * ls (near), and
// every diagonal tile of K(x, x), is recomputed exactly; a far tile's
// profile takes exp2f.  Before contracting, the block measures sixteen
// sampled row pairs exactly; when one lies inside the cut the tile is
// certain to be near and skips the contraction, so a near tile pays for
// it only when no sample found it.  Against the TPU kernel's rule this
// refines a superset of its tiles, differing only where the contracted
// minimum sits within the contraction's error above the cut.
// Near tiles go to a second kernel: the first appends each to a list in
// device scratch (an atomic counter), and a persistent grid of the exact
// kernel -- gram_tile's staged body on two 64-row halves, its occupancy
// (no operand stage, fewer registers) -- computes them with the
// elementwise loop's arithmetic (ascending k, _rn intrinsics), so a near
// tile holds the low-D path's bits and k(x, x) = sigma^2 exactly; the
// tensor-core kernel, two blocks an SM, spends its time on far tiles
// only.  Values go through a shared stage (row strides 136, or 132
// transposed: no bank conflicts), from which rows are written as 16-byte
// stores.  K(x, x) (the same tensor on both sides) is mirrored: only tiles
// I >= J are computed, each written as rows and, staged transposed, as
// its mirror, so it is bitwise symmetric by construction and half the
// contraction is saved; the lazy loop's column blocks and the
// walker-batched stack run the same lower tiles on the same global
// 128-grid, so each equals the materialized covariance bit for bit; the
// exact kernel writes a near lower tile and its mirror each by exact sums
// (transpose-exact), diagonal tiles whole.  Bound: writing the output; at
// D = 32 the 3 x 2 D n m tensor-core operations and the profile sit under
// it.  What holds it back (PERF.md section 6): two blocks an SM (128
// registers, 77 KB of shared memory), each running its loads,
// contraction, epilogue and stores in series.
// f64 keeps the exact elementwise loop at every D.  Profile id 4
// (SQUARED_DISTANCE) writes the refined d^2 itself: the backward
// differentiates the profile on it.
//
// Symmetry (the elementwise path): out[i, j] and out[j, i] see (x - y)
// and (y - x) = -(x - y) exactly, the same squares, summed in ascending k
// with round-to-nearest intrinsics (no FMA contraction), so K(X, X) is
// bitwise symmetric and k(x, x) = sigma^2 exactly -- the factorization
// relies on both.  The diagonal is added only where i == j, tested only in
// tiles that meet it.

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


// ---------------------------------------------------------------------------
// The high-D branch (see the header): f32, D >= MXU_MIN_D.
// ---------------------------------------------------------------------------

constexpr int HT = 128;              // tile edge
constexpr int KC = 32;               // features staged per chunk
constexpr int KP = KC + 4;           // operand row stride: conflict-free fragment loads
constexpr int TN = HT + 8;           // output stage row stride (rows), 8 mod 32
constexpr int TT = HT + 4;           // output stage row stride (transposed), 4 mod 32
constexpr int SQUARED_DISTANCE = 4;  // profile id: write the refined d^2
constexpr int OPERAND_FLOATS = 4 * HT * KP;  // x hi, x lo, y hi, y lo
constexpr int HIGHD_SMEM = (int)sizeof(float) * OPERAND_FLOATS;  // 73728 bytes, opt-in
static_assert(HT * TN <= OPERAND_FLOATS && HT * TT <= OPERAND_FLOATS, "the output stage aliases the operands");
constexpr float LOG2E = 1.4426950408889634f;

// v rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero: cvt.rna.tf32.f32's result for finite v, in two integer
// operations.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// c += a b over one 16 x 8 x 8 step: a row-major 16 x 8 (a0: row g, col t;
// a1: row g + 8; a2: col t + 4; a3: both), b the 8 x 8 column block (b0:
// k = t, b1: k = t + 4, column g), c rows g / g + 8, columns 2t, 2t + 1;
// g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int P>
__device__ __forceinline__ float highd_value(float d2, float ls, float s2) {
  return P == SQUARED_DISTANCE ? d2 : apply_profile<float, P>(d2, ls, s2);
}

// The far field's profile: a = log2(e) / ls^2 (squared exponential) or
// 1 / ls; exp2f's 2 ulp are far below the contraction's own error.
template <int P>
__device__ __forceinline__ float far_value(float d2, float a, float s2) {
  if (P == SQUARED_DISTANCE) return d2;
  if (P == SQUARED_EXPONENTIAL) return s2 * exp2f(-d2 * a);
  const float scaled = sqrtf(d2) * a;
  if (P == EXPONENTIAL) return s2 * exp2f(-scaled * LOG2E);
  if (P == MATERN_32) {
    const float s3 = 1.7320508075688772f * scaled;
    return s2 * (1.f + s3) * exp2f(-s3 * LOG2E);
  }
  const float s5 = 2.23606797749979f * scaled;
  return s2 * (1.f + s5 + s5 * s5 * (1.f / 3.f)) * exp2f(-s5 * LOG2E);
}

// One 128 x 128 tile, rows row0.. of X (n rows) against rows col0.. of Y (m
// rows).  A far tile (the return value): each thread's 64 values (profile
// values, or d^2 for SQUARED_DISTANCE; those past the matrix are junk,
// never stored) in v, laid out as the contraction's fragments; the far
// field's profile takes exp2f and products by 1 / ls.  A near tile --
// force, one of sixteen sampled pairs inside the cut, or the
// contraction's smallest d^2 inside the matrix <= cut -- returns false:
// the exact kernel computes it.
template <int P>
__device__ __forceinline__ bool highd_tile(const float* __restrict__ X, int64_t n, int64_t row0,
                                           const float* __restrict__ Y, int64_t m, int64_t col0, int d, float ls,
                                           float s2, float cut, bool force, float* sm, float (&v)[64]) {
  __shared__ float part[2][WARPS][KC];  // each warp's feature sums over its 16 rows of the x and y tiles
  __shared__ float norm[2][HT];         // |x - c|^2 and |y - c|^2
  __shared__ float wmin[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;  // warp tile: rows 32 wr.., columns 64 wc..
  uint32_t* ops = reinterpret_cast<uint32_t*>(sm);  // x hi, x lo, y hi, y lo: (HT, KP) each
  const uint32_t* xh = ops;
  const uint32_t* xl = xh + HT * KP;
  const uint32_t* yh = xl + HT * KP;
  const uint32_t* yl = yh + HT * KP;

  // Sixteen pairs first, exactly: rows {0, 42, 84, 127} of each tile
  // (clamped to the matrix), two pairs a warp.  When one lies inside the
  // cut the tile is near whatever the contraction would give (its
  // smallest d^2 can only be smaller), so the contraction is skipped, as
  // for a forced tile.  The decision depends on the tile's rows only:
  // every launch form, and the mirror tile, decides it alike.
  bool exact = force;
  if (!exact) {
    float pmin = __int_as_float(0x7f800000);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int pair = 2 * warp + p;
      const int64_t i = min(row0 + (127 * (pair >> 2)) / 3, n - 1), j = min(col0 + (127 * (pair & 3)) / 3, m - 1);
      float s = 0.f;
      for (int k = lane; k < d; k += 32) {
        const float diff = X[i * d + k] - Y[j * d + k];
        s = __fmaf_rn(diff, diff, s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      pmin = fminf(pmin, s);
    }
    if (lane == 0) wmin[warp] = pmin;
    __syncthreads();
    float smin = wmin[0];
    for (int w = 1; w < WARPS; ++w) smin = fminf(smin, wmin[w]);
    exact = smin <= cut;
    __syncthreads();  // wmin is written again below
  }

  if (!exact) {
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    float nrm = 0.f;  // |row - c|^2 of x row tid (tid < 128) or y row tid - 128

    for (int k0 = 0; k0 < d; k0 += KC) {
      const int kc = min(KC, d - k0);
      const int kc8 = (kc + 7) & ~7;
      // raw values in registers, lane = feature, rows warp + 8 q; rows past the end replicate the last row
      float xv[HT / WARPS], yv[HT / WARPS];
#pragma unroll
      for (int q = 0; q < HT / WARPS; ++q) {
        const int64_t i = min(row0 + warp + WARPS * q, n - 1), j = min(col0 + warp + WARPS * q, m - 1);
        xv[q] = lane < kc ? X[i * d + k0 + lane] : 0.f;
        yv[q] = lane < kc ? Y[j * d + k0 + lane] : 0.f;
      }
      {  // feature `lane` summed over this warp's 16 rows, in turn
        float sx = 0.f, sy = 0.f;
#pragma unroll
        for (int q = 0; q < HT / WARPS; ++q) {
          sx = __fadd_rn(sx, xv[q]);
          sy = __fadd_rn(sy, yv[q]);
        }
        part[0][warp][lane] = sx;
        part[1][warp][lane] = sy;
      }
      __syncthreads();
      if (lane < kc8) {  // centre, split, store: c = (mean of the x tile + mean of the y tile) / 2, / 128 exact
        float sx = 0.f, sy = 0.f;
        for (int w = 0; w < WARPS; ++w) {
          sx = __fadd_rn(sx, part[0][w][lane]);
          sy = __fadd_rn(sy, part[1][w][lane]);
        }
        const float c = __fmul_rn(0.5f, __fadd_rn(__fmul_rn(sx, 1.f / HT), __fmul_rn(sy, 1.f / HT)));
#pragma unroll
        for (int q = 0; q < HT / WARPS; ++q) {
          const int r = (warp + WARPS * q) * KP + lane;
          const float xc = lane < kc ? __fsub_rn(xv[q], c) : 0.f, yc = lane < kc ? __fsub_rn(yv[q], c) : 0.f;
          const uint32_t xhi = tf32_rna(xc), yhi = tf32_rna(yc);
          ops[r] = xhi;
          ops[HT * KP + r] = tf32_rna(__fsub_rn(xc, __uint_as_float(xhi)));
          ops[2 * HT * KP + r] = yhi;
          ops[3 * HT * KP + r] = tf32_rna(__fsub_rn(yc, __uint_as_float(yhi)));
        }
      }
      __syncthreads();
      {  // |row - c|^2 in ascending k from hi + lo (exact in f32): x row tid < 128, else y row tid - 128
        const uint32_t* hi_row = (tid < HT ? xh : yh) + (tid & (HT - 1)) * KP;
        for (int k = 0; k < kc8; k += 8) {
          const uint4 h0 = *reinterpret_cast<const uint4*>(hi_row + k);
          const uint4 h1 = *reinterpret_cast<const uint4*>(hi_row + k + 4);
          const uint4 l0 = *reinterpret_cast<const uint4*>(hi_row + HT * KP + k);
          const uint4 l1 = *reinterpret_cast<const uint4*>(hi_row + HT * KP + k + 4);
          const uint32_t hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
          const uint32_t lv[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float v = __fadd_rn(__uint_as_float(hv[e]), __uint_as_float(lv[e]));
            nrm = __fadd_rn(nrm, __fmul_rn(v, v));
          }
        }
      }
      for (int kk = 0; kk < kc8; kk += 8) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = 32 * wr + 16 * mi + g;
          ah[mi][0] = xh[r * KP + kk + t];
          ah[mi][1] = xh[(r + 8) * KP + kk + t];
          ah[mi][2] = xh[r * KP + kk + t + 4];
          ah[mi][3] = xh[(r + 8) * KP + kk + t + 4];
          al[mi][0] = xl[r * KP + kk + t];
          al[mi][1] = xl[(r + 8) * KP + kk + t];
          al[mi][2] = xl[r * KP + kk + t + 4];
          al[mi][3] = xl[(r + 8) * KP + kk + t + 4];
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int c = 64 * wc + 8 * ni + g;
          const uint32_t bh0 = yh[c * KP + kk + t], bh1 = yh[c * KP + kk + t + 4];
          const uint32_t bl0 = yl[c * KP + kk + t], bl1 = yl[c * KP + kk + t + 4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {  // small products first, in a fixed order
            mma_tf32(acc[mi][ni], al[mi], bh0, bh1);
            mma_tf32(acc[mi][ni], ah[mi], bl0, bl1);
            mma_tf32(acc[mi][ni], ah[mi], bh0, bh1);
          }
        }
      }
      __syncthreads();  // the operands are read; the next chunk (or the stage) may overwrite them
    }
    norm[tid < HT ? 0 : 1][tid & (HT - 1)] = nrm;
    __syncthreads();

    const int64_t rows_in = n - row0, cols_in = m - col0;
    float lmin = __int_as_float(0x7f800000);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 32 * wr + 16 * mi + g + 8 * (e >> 1), c = 64 * wc + 8 * ni + 2 * t + (e & 1);
          const float d2 = fmaxf(__fmaf_rn(-2.f, acc[mi][ni][e], __fadd_rn(norm[0][r], norm[1][c])), 0.f);
          acc[mi][ni][e] = d2;
          if (r < rows_in && c < cols_in) lmin = fminf(lmin, d2);
        }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lmin = fminf(lmin, __shfl_xor_sync(0xffffffffu, lmin, o));
    if (lane == 0) wmin[warp] = lmin;
    __syncthreads();
    float tmin = wmin[0];
    for (int w = 1; w < WARPS; ++w) tmin = fminf(tmin, wmin[w]);

    if (tmin <= cut) return false;
    const float a = P == SQUARED_EXPONENTIAL ? LOG2E / (ls * ls) : 1.f / ls;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[(8 * mi + ni) * 4 + e] = far_value<P>(acc[mi][ni][e], a, s2);
    return true;
  }
  return false;
}

// A thread's 64 values of a far tile into the stage: as rows (stride TN,
// the contraction's fragments as 8-byte stores) or transposed (stride TT);
// both layouts' writes and row reads avoid bank conflicts.
__device__ __forceinline__ void stage_tile(const float (&v)[64], bool transposed, float* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp >> 1, wc = warp & 1;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * wr + 16 * mi + g + 8 * h, c = 64 * wc + 8 * ni + 2 * t;
        const float v0 = v[(8 * mi + ni) * 4 + 2 * h], v1 = v[(8 * mi + ni) * 4 + 2 * h + 1];
        if (transposed) {
          sm[c * TT + r] = v0;
          sm[(c + 1) * TT + r] = v1;
        } else {
          *reinterpret_cast<float2*>(sm + r * TN + c) = make_float2(v0, v1);
        }
      }
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

// The near tiles' list, filled by the far kernels and read by the exact
// kernels: work[0] counts the entries work[1..].
__device__ __forceinline__ void defer_tile(unsigned long long* work, unsigned long long entry) {
  if (threadIdx.x == 0) work[1 + atomicAdd(work, 1ull)] = entry;
}

// The cross form's far tiles: tile blockIdx.x (row-major over col_tiles)
// of the rectangular (n, m) gram, plus diag[i] where i == j when diag is
// given, or its index in work when it is near.
template <int P>
__global__ void __launch_bounds__(THREADS, 2)
highd_cross_kernel(const float* __restrict__ X, const float* __restrict__ Y, const float* __restrict__ diag,
                   float* __restrict__ out, int64_t n, int64_t m, int d, int64_t col_tiles, float ls, float sigma,
                   float ratio, unsigned long long* __restrict__ work) {
  extern __shared__ __align__(16) float sm[];
  const int64_t row0 = (int64_t)(blockIdx.x / col_tiles) * HT, col0 = (int64_t)(blockIdx.x % col_tiles) * HT;
  float v[64];
  if (!highd_tile<P>(X, n, row0, Y, m, col0, d, ls, mul_rn(sigma, sigma), mul_rn(mul_rn(ratio, ls), ls), false, sm,
                     v)) {
    defer_tile(work, blockIdx.x);
    return;
  }
  stage_tile(v, false, sm);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t j = col0 + 4 * lane;  // this lane's four columns
  for (int r = warp; r < HT && row0 + r < n; r += WARPS) {
    const int64_t i = row0 + r;  // X and Y differ: a far tile may meet i == j
    float4 value = *reinterpret_cast<const float4*>(sm + r * TN + 4 * lane);
    if (diag != nullptr && i >= j && i < j + 4) value = add_diagonal(value, i, j, diag[i]);
    store4(out + i * m + j, value, 0, clamp4(m - j));
  }
}

// Rows row0.. (BM of them) and columns col0.. (BN) of K(X, Y) by the
// elementwise loop's arithmetic (gram_tile's staged body: the same sums in
// the same order, the same profile), so a near tile holds the loop's bits.
// Entry (i, j) goes to out[(i - off) ld + (j - off)] when i is in [off, n)
// and j in [off, j1), plus diag[i - off] where i == j when diag is given;
// with MIRROR (K(x, x), the rows and columns from two different tiles)
// also to out[(j - off) ld + (i - off)] when j is in [off, n) and i in
// [off, j1), through a transposed stage (row stride MS: four-way bank
// conflicts on its writes, none on its reads).
constexpr int CHUNK_FLOATS = DCHUNK * (BM + PAD) + DCHUNK * (BN + PAD);
constexpr int MS = BM + 1;
template <int P, bool MIRROR>
__device__ __forceinline__ void exact_half(const float* __restrict__ X, int64_t n, int64_t row0,
                                           const float* __restrict__ Y, int64_t m, int64_t col0, int d, float ls,
                                           float s2, const float* __restrict__ diag, float* __restrict__ out,
                                           int64_t ld, int64_t off, int64_t j1) {
  __shared__ __align__(16) float smem[MIRROR && BN * MS > CHUNK_FLOATS ? BN * MS : CHUNK_FLOATS];
  float (*xs)[BM + PAD] = reinterpret_cast<float (*)[BM + PAD]>(smem);
  float (*ys)[BN + PAD] = reinterpret_cast<float (*)[BN + PAD]>(smem + DCHUNK * (BM + PAD));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i0 = row0 + warp * ROWS, jl = col0 + COLS * lane;  // this thread's first row and column
  float acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < d; k0 += DCHUNK) {
    const int kc = min(DCHUNK, d - k0);
    for (int e = threadIdx.x; e < BM * DCHUNK; e += THREADS) {
      const int r = e / DCHUNK, k = e % DCHUNK;
      xs[k][r] = (k < kc && row0 + r < n) ? X[(row0 + r) * d + k0 + k] : 0.f;
    }
    for (int e = threadIdx.x; e < BN * DCHUNK; e += THREADS) {
      const int c = e / DCHUNK, k = e % DCHUNK;
      ys[k][c] = (k < kc && col0 + c < m) ? Y[(col0 + c) * d + k0 + k] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      float xv[ROWS], yv[COLS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) xv[r] = xs[k][warp * ROWS + r];
#pragma unroll
      for (int c = 0; c < COLS; ++c) yv[c] = ys[k][COLS * lane + c];
      accumulate(acc, xv, yv);
    }
    __syncthreads();  // the chunks are read: the next chunk, or the stage, may overwrite them
  }
  const int lo = clamp4(off - jl), hi = clamp4(min(j1, m) - jl);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t i = i0 + r;
    float4 value = make_float4(highd_value<P>(acc[r][0], ls, s2), highd_value<P>(acc[r][1], ls, s2),
                               highd_value<P>(acc[r][2], ls, s2), highd_value<P>(acc[r][3], ls, s2));
    if (MIRROR) {
      smem[(COLS * lane) * MS + warp * ROWS + r] = value.x;
      smem[(COLS * lane + 1) * MS + warp * ROWS + r] = value.y;
      smem[(COLS * lane + 2) * MS + warp * ROWS + r] = value.z;
      smem[(COLS * lane + 3) * MS + warp * ROWS + r] = value.w;
    }
    if (i >= n || i < off || lo >= hi) continue;
    if (diag != nullptr && i >= jl && i < jl + 4) value = add_diagonal(value, i, jl, diag[i - off]);
    store4(out + (i - off) * ld + (jl - off), value, lo, hi);
  }
  if (MIRROR) {
    __syncthreads();
    for (int c = warp; c < BN; c += WARPS) {  // mirror row col0 + c: the half's rows as its columns
      const int64_t j = col0 + c;
      if (j >= m || j < off) continue;
#pragma unroll
      for (int h = 0; h < BM; h += 32) {
        const int64_t i = row0 + h + lane;
        if (i < n && i >= off && i < j1) out[(j - off) * ld + (i - off)] = smem[c * MS + h + lane];
      }
    }
    __syncthreads();  // the stage is read: the next half may stage its chunks
  }
}

// The cross form's near tiles, from work: each 128 x 128 tile as two
// halves of 64 rows, plus diag[i] where i == j.  A persistent grid.
template <int P>
__global__ void __launch_bounds__(THREADS, 3)
highd_exact_cross_kernel(const float* __restrict__ X, const float* __restrict__ Y, const float* __restrict__ diag,
                         float* __restrict__ out, int64_t n, int64_t m, int d, int64_t col_tiles, float ls,
                         float sigma, const unsigned long long* __restrict__ work) {
  const unsigned long long count = work[0];
  const float s2 = mul_rn(sigma, sigma);
  for (unsigned long long k = blockIdx.x; k < count; k += gridDim.x) {
    const int64_t tile = (int64_t)work[1 + k];
    const int64_t row0 = tile / col_tiles * HT, col0 = tile % col_tiles * HT;
    for (int64_t r0 = row0; r0 < row0 + HT && r0 < n; r0 += BM)
      exact_half<P, false>(X, n, r0, Y, m, col0, d, ls, s2, diag, out, m, 0, m);
  }
}

struct SymArgs {
  const float* x;        // (n, d): both sides
  const float* diag;     // b long, for out's diagonal; or null
  float* out;            // element (j0, j0) of the block; row stride ld
  const float* ls_w;     // batched: the walkers' scalars (else null) ...
  const float* sigma_w;
  int64_t out_stride;    // ... and the walker's offsets into out and diag
  int64_t diag_stride;
  int64_t n, j0, b, ld;  // the block: rows [j0, n), columns [j0, j0 + b)
  int64_t jt0;           // the block's first column tile
  int64_t row_tiles;     // row tiles from jt0 to the last
  int64_t tiles;         // lower tiles a walker
  int d;
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
__device__ __forceinline__ void walker(const SymArgs& a, int64_t w, float& ls, float& sigma, float*& out,
                                       const float*& diag) {
  ls = a.ls_w != nullptr ? a.ls_w[w] : a.ls;
  sigma = a.sigma_w != nullptr ? a.sigma_w[w] : a.sigma;
  out = a.out + w * a.out_stride;
  diag = a.diag == nullptr ? nullptr : a.diag + w * a.diag_stride;
}

// The symmetric forms' far tiles: rows [j0, n) and columns [j0, j0 + b) of
// K(x, x).  Block blockIdx.x takes a lower tile (I, J), I > J, of the
// global 128-grid and writes it and its mirror (J, I), each where it falls
// inside the block; a near tile, and every diagonal tile, goes to work.
// blockIdx.y is the walker.
template <int P>
__global__ void __launch_bounds__(THREADS, 2) highd_sym_kernel(SymArgs a, unsigned long long* __restrict__ work) {
  extern __shared__ __align__(16) float sm[];
  float ls, sigma, *out;
  const float* diag;
  walker(a, blockIdx.y, ls, sigma, out, diag);
  int64_t q, rr;
  lower_tile(blockIdx.x, a.row_tiles, q, rr);
  const int64_t J = a.jt0 + q, I = J + rr;
  const int64_t row0 = I * HT, col0 = J * HT, n = a.n, j0 = a.j0, j1 = a.j0 + a.b;
  float v[64];
  if (!highd_tile<P>(a.x, n, row0, a.x, n, col0, a.d, ls, mul_rn(sigma, sigma), mul_rn(mul_rn(a.ratio, ls), ls),
                     I == J, sm, v)) {
    defer_tile(work, blockIdx.y * a.tiles + blockIdx.x);
    return;
  }
  stage_tile(v, false, sm);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t j = col0 + 4 * lane;  // this lane's four columns
  int lo = clamp4(j0 - j), hi = clamp4(j1 - j);
  for (int r = warp; r < HT && row0 + r < n; r += WARPS) {
    const int64_t i = row0 + r;
    if (i < j0 || lo >= hi) continue;
    store4(out + (i - j0) * a.ld + (j - j0), *reinterpret_cast<const float4*>(sm + r * TN + 4 * lane), lo, hi);
  }
  __syncthreads();
  stage_tile(v, true, sm);
  __syncthreads();
  j = row0 + 4 * lane;  // out[col0 + c, row0 + r] = tile[r, c]: this lane's four r
  lo = clamp4(j0 - j);
  hi = clamp4(j1 - j);
  for (int c = warp; c < HT && col0 + c < n; c += WARPS) {
    const int64_t i = col0 + c;
    if (i < j0 || lo >= hi) continue;
    store4(out + (i - j0) * a.ld + (j - j0), *reinterpret_cast<const float4*>(sm + c * TT + 4 * lane), lo, hi);
  }
}

// The symmetric forms' near tiles, from work (entries w tiles + k): the
// lower tile (I, J) by exact_half, and, when I > J and it meets the
// block's columns, its mirror (J, I) from the same values; diag on the
// global diagonal.  A persistent grid.
template <int P>
__global__ void __launch_bounds__(THREADS, 3)
highd_exact_sym_kernel(SymArgs a, const unsigned long long* __restrict__ work) {
  const unsigned long long count = work[0];
  const int64_t n = a.n, j0 = a.j0, j1 = a.j0 + a.b;
  for (unsigned long long k = blockIdx.x; k < count; k += gridDim.x) {
    const int64_t entry = (int64_t)work[1 + k];
    float ls, sigma, *out;
    const float* diag;
    walker(a, entry / a.tiles, ls, sigma, out, diag);
    const float s2 = mul_rn(sigma, sigma);
    int64_t q, rr;
    lower_tile(entry % a.tiles, a.row_tiles, q, rr);
    const int64_t J = a.jt0 + q, I = J + rr, row0 = I * HT, col0 = J * HT;
    for (int64_t r0 = row0; r0 < row0 + HT && r0 < n; r0 += BM) {
      if (I != J && row0 < j1)
        exact_half<P, true>(a.x, n, r0, a.x, n, col0, a.d, ls, s2, diag, out, a.ld, j0, j1);
      else
        exact_half<P, false>(a.x, n, r0, a.x, n, col0, a.d, ls, s2, diag, out, a.ld, j0, j1);
    }
  }
}

template <typename Kernel>
int allow_highd_smem(Kernel kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HIGHD_SMEM);
}

// Blocks of a persistent grid of kernel: as many as the card holds at once,
// at most entries.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int64_t entries, unsigned& blocks) {
  int device = 0, sms = 0, per_sm = 0;
  int code = (int)cudaGetDevice(&device);
  if (code == 0) code = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (code == 0) code = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  blocks = (unsigned)(entries < most ? (entries > 0 ? entries : 1) : most);
  return code;
}

template <int P>
int launch_highd_cross_profile(const float* X, const float* Y, const float* diag, float* out, int64_t n,
                               int64_t m, int d, float ls, float sigma, float ratio, unsigned long long* work,
                               cudaStream_t stream) {
  const int64_t col_tiles = (m + HT - 1) / HT;
  const int64_t tiles = (n + HT - 1) / HT * col_tiles;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  unsigned blocks = 0;
  int code = allow_highd_smem(&highd_cross_kernel<P>);
  if (code == 0) code = persistent_blocks(&highd_exact_cross_kernel<P>, tiles, blocks);
  if (code == 0) code = (int)cudaMemsetAsync(work, 0, sizeof(unsigned long long), stream);
  if (code != 0) return code;
  highd_cross_kernel<P><<<(unsigned)tiles, THREADS, HIGHD_SMEM, stream>>>(X, Y, diag, out, n, m, d, col_tiles, ls,
                                                                        sigma, ratio, work);
  highd_exact_cross_kernel<P><<<blocks, THREADS, 0, stream>>>(X, Y, diag, out, n, m, d, col_tiles, ls, sigma, work);
  return (int)cudaGetLastError();
}

template <int P>
int launch_highd_sym_profile(SymArgs a, int64_t batch, unsigned long long* work, cudaStream_t stream) {
  const int64_t nt = (a.n + HT - 1) / HT;
  a.jt0 = a.j0 / HT;
  a.row_tiles = nt - a.jt0;
  const int64_t cols = (a.j0 + a.b - 1) / HT - a.jt0 + 1;
  a.tiles = cols * a.row_tiles - cols * (cols - 1) / 2;
  if (a.tiles > 0x7fffffff || batch > 65535) return (int)cudaErrorInvalidValue;
  unsigned blocks = 0;
  int code = allow_highd_smem(&highd_sym_kernel<P>);
  if (code == 0) code = persistent_blocks(&highd_exact_sym_kernel<P>, a.tiles * batch, blocks);
  if (code == 0) code = (int)cudaMemsetAsync(work, 0, sizeof(unsigned long long), stream);
  if (code != 0) return code;
  highd_sym_kernel<P><<<dim3((unsigned)a.tiles, (unsigned)batch), THREADS, HIGHD_SMEM, stream>>>(a, work);
  highd_exact_sym_kernel<P><<<blocks, THREADS, 0, stream>>>(a, work);
  return (int)cudaGetLastError();
}

int launch_highd_cross(const float* X, const float* Y, const float* diag, float* out, int64_t n, int64_t m, int d,
                       float ls, float sigma, float ratio, int profile, unsigned long long* work,
                       cudaStream_t stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  switch (profile) {
    case SQUARED_EXPONENTIAL:
      return launch_highd_cross_profile<SQUARED_EXPONENTIAL>(X, Y, diag, out, n, m, d, ls, sigma, ratio, work,
                                                             stream);
    case EXPONENTIAL:
      return launch_highd_cross_profile<EXPONENTIAL>(X, Y, diag, out, n, m, d, ls, sigma, ratio, work, stream);
    case MATERN_32:
      return launch_highd_cross_profile<MATERN_32>(X, Y, diag, out, n, m, d, ls, sigma, ratio, work, stream);
    case MATERN_52:
      return launch_highd_cross_profile<MATERN_52>(X, Y, diag, out, n, m, d, ls, sigma, ratio, work, stream);
    case SQUARED_DISTANCE:
      return launch_highd_cross_profile<SQUARED_DISTANCE>(X, Y, diag, out, n, m, d, ls, sigma, ratio, work, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch_highd_sym(const SymArgs& a, int64_t batch, int profile, unsigned long long* work, cudaStream_t stream) {
  if (a.n <= 0 || a.b <= 0 || batch <= 0) return (int)cudaSuccess;
  if (a.d <= 0 || a.j0 < 0 || a.j0 + a.b > a.n) return (int)cudaErrorInvalidValue;
  switch (profile) {
    case SQUARED_EXPONENTIAL:
      return launch_highd_sym_profile<SQUARED_EXPONENTIAL>(a, batch, work, stream);
    case EXPONENTIAL:
      return launch_highd_sym_profile<EXPONENTIAL>(a, batch, work, stream);
    case MATERN_32:
      return launch_highd_sym_profile<MATERN_32>(a, batch, work, stream);
    case MATERN_52:
      return launch_highd_sym_profile<MATERN_52>(a, batch, work, stream);
    case SQUARED_DISTANCE:
      return launch_highd_sym_profile<SQUARED_DISTANCE>(a, batch, work, stream);
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

// The high-D branch (f32).  ratio: the profile's refinement cut over ls^2;
// profile 4 writes the refined d^2; work: 1 + tiles (times batch) 8-byte
// words of device scratch for the near tiles' list.  The cross form: X
// (n, d), Y (m, d), out (n, m), diag (min(n, m),) or null; tiles =
// ceil(n / 128) ceil(m / 128).
int radial_gram_highd_f32(const float* X, const float* Y, const float* diag, float* out, int64_t n, int64_t m,
                          int d, float ls, float sigma, float ratio, int profile, void* work, void* stream) {
  return launch_highd_cross(X, Y, diag, out, n, m, d, ls, sigma, ratio, profile,
                            static_cast<unsigned long long*>(work), (cudaStream_t)stream);
}

// The symmetric forms: out (n - j0, b) holds rows [j0, n) of columns
// [j0, j0 + b) of K(x, x), diag (b,) or null on its leading diagonal;
// j0 = 0, b = n is the whole training covariance; tiles: the lower tiles
// of the global 128-grid that meet the block.
int radial_gram_highd_sym_f32(const float* x, const float* diag, float* out, int64_t n, int d, int64_t j0,
                              int64_t b, float ls, float sigma, float ratio, int profile, void* work, void* stream) {
  SymArgs a{x, diag, out, nullptr, nullptr, 0, 0, n, j0, b, b, 0, 0, 0, d, ls, sigma, ratio};
  return launch_highd_sym(a, 1, profile, static_cast<unsigned long long*>(work), (cudaStream_t)stream);
}

// The walker-batched training covariance: ls, sigma (batch,), diag
// (batch, n), out (batch, n, n), all on the device; tiles times batch
// entries of work.
int radial_gram_highd_batched_f32(const float* x, const float* ls, const float* sigma, const float* diag,
                                  float* out, int64_t n, int d, int64_t batch, float ratio, int profile, void* work,
                                  void* stream) {
  SymArgs a{x, diag, out, ls, sigma, n * n, n, n, 0, n, n, 0, 0, 0, d, 0.f, 0.f, ratio};
  return launch_highd_sym(a, batch, profile, static_cast<unsigned long long*>(work), (cudaStream_t)stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
