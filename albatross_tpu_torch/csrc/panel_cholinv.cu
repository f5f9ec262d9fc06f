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
//     1. tile_factor_inverse: one block factors the diagonal tile and
//        inverts it, all in shared memory (below);
//     2. row_solve: the off-diagonal tile row U[t, t+1:] = Wu[t,t]^T
//        U[t, t+1:], in place: each block holds all 128 rows of its column
//        slice before it writes; it also writes the zeros of U's strict
//        lower triangle in the mirrored column below the tile;
//     3. trailing_update: U[t+1:, t+1:] -= U[t, t+1:]^T U[t, t+1:] over the
//        upper 64 x 64 blocks;
//   then the inverse is composed in log depth from the tile inverses, one
//   pair of diagonal blocks per blockIdx.z, sizes 128, 256, 512:
//     Wu[o, o+s] = -(W11 U[o, o+s]) W22,  W11 = Wu[o, o], W22 = Wu[o+s, o+s],
//   two launches a level; W11 and W22 are upper-triangular, so each
//   product's K loop covers only their upper part, and the second launch
//   writes the mirrored zeros of Wu's strict lower triangle.  Every entry of
//   U and Wu is written by one of these launches: no memset, no zeroing pass.
//
// The tile step.  The first design factored the 128 x 128 tile by 128
// rank-1 steps over 1024 threads (three block-wide barriers each, a runtime
// division per element) and inverted it by 128 dependent substitution rows
// (a barrier each): about 512 barriers on one SM while the other 131 wait,
// 0.259 ms per tile and 73% of the kernel (H100, 700 W).  Its bound was
// latency, not FLOPs: a tile holds about 1.4 MFLOP.  This design is a
// right-looking factor over four 32-wide sub-panels s, 256 threads:
//   (a) warp 0 factors the 32 x 32 diagonal block in registers, one column
//       per lane; each step's pivot travels by one __shfl_sync and its row
//       of U through shared memory as broadcast float4 reads, with
//       __syncwarp only: no block-wide barrier inside the 32 steps;
//   (b) in the same steps the warp inverts that factor by forward
//       substitution: lane j forms row j of Winv_s = U_ss^-1 from the row of
//       U that step k broadcasts, so the inverse costs one FMA per entry;
//   (c) the four 64-thread groups each own one 32 x 32 block: the sub-row
//       U[s, q] = Winv_s^T A[s, q], then the upper trailing blocks
//       A[p, q] -= U[s, p]^T U[s, q]; every thread keeps a fixed 4 x 4
//       output patch in registers, reads its operands as float4s, and all
//       index arithmetic is fixed at compile time.  Beside the sub-row,
//       groups form V[k, s] = U[k, s] Winv_s (k < s) for the inverse.
// The tile's inverse is then composed by block diagonals as in the TPU
// kernel's panel recursion: Wu[c, r] = -sum_{k=c}^{r-1} Wu[c, k] V[k, r].
// The TPU kernel's Newton inverse (14 matrix products per tile) is not used:
// it trades FLOPs for steps, which pays only on a 128 x 128 matrix unit.
// That is 15 block-wide barriers per tile.  clock64() stamps put a tile at
// about 48k cycles (0.025 ms): the four warp chains about 18k (each step is
// issue-bound by its ~60 FMAs on one warp), the 14 rounds of 32 x 32 x 32
// block products about 22k, the tile's load and store about 8k.  The
// warp's code is one shared copy: four inlined copies (34 KB of straight
// code each) ran 1.6x slower from the instruction cache.
//
// No tensor cores: the path needs FP32 products.  wgmma takes no FP32
// operands, and with TF32 GEMMs the end-to-end gates fail (NLML error 3.8x
// its gate, predictive mean 43x); the TPU kernel, too, runs its products at
// HIGHEST precision.  The products here are plain FP32 FMA loops.
//
// A non-SPD pivot gives rsqrt(negative) = NaN in U and Wu from the pivot on,
// which flows out of the panel: it surfaces, it is not masked.  Rows of U,
// and rows and columns of Wu, before the pivot stay finite.
//
// The batched entry (panel_cholinv_batched_f32) factors W contiguous panels,
// the ensemble sampler's counterpart of jax.vmap over the panel
// factorization: the same launch sequence, each kernel instantiated with
// BATCHED = true and its grid widened by the panel index (the tile step on
// blockIdx.x, the row solve on blockIdx.y, the trailing update on
// blockIdx.z; the composition already spends blockIdx.z on its pairs, so
// there z = pair + pairs * panel), one copy of the whole stack, and a b x b
// scratch a panel.  A single panel's tile step keeps one SM busy while 131
// wait; W panels keep W busy, so the batch costs far less than W calls.
// Each slice equals panel_cholinv_f32's output bit for bit, and a non-SPD
// panel's NaN stays in its slice.

#include <cuda_runtime.h>

namespace {

constexpr int T = 128;       // tile edge
constexpr int SB = 32;       // sub-panel edge: one warp's factor
constexpr int NSB = T / SB;  // sub-panels per tile
// Padded shared row: a multiple of 4 (float4 rows) with LD = 4 mod 32, so
// the float4 reads of the 4 x 4 patches below are free of bank conflicts.
constexpr int LD = T + 4;
constexpr int TILE_THREADS = 256;
constexpr int GROUP = 64;    // threads per 32 x 32 block: 8 x 8, 4 x 4 outputs each
constexpr int GROUPS = TILE_THREADS / GROUP;
constexpr size_t TILE_SMEM = 3 * T * LD * sizeof(float);
constexpr unsigned FULL = 0xffffffffu;
constexpr int BM = 64, BN = 64, BK = 16;   // GEMM block tile
constexpr int GEMM_THREADS = 256;          // 16 x 16 threads, 4 x 4 outputs each
constexpr int RS_BN = 32;                  // row_solve: columns per block
constexpr int RS_THREADS = 256;            // 32 x 8 threads, 4 x 4 outputs each
constexpr int RS_LDW = T + 4, RS_LDB = RS_BN + 4;
constexpr size_t RS_SMEM = (size_t)(T * RS_LDW + T * RS_LDB) * sizeof(float);

__device__ __forceinline__ float* blk(float* M, int p, int q) { return M + p * SB * LD + q * SB; }

// Barrier over the 64 threads of group g (named barrier g + 1; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(GROUP) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Row of a thread's ii-th output in a 32 x 32 block product: 4 ty + ii when
// op(A) = A^T (one float4 of A's row m covers the four rows), else ty + 8 ii
// (one float4 of each of those rows covers four m).
template <bool TA>
__device__ __forceinline__ int row32(int ty, int ii) { return TA ? 4 * ty + ii : ty + 8 * ii; }

// acc += op(A) B over one 32-deep block.  A and B point at 32 x 32 blocks of
// shared memory; op(A)[i][m] = A[m][i] when TA, else A[i][m].  The thread's
// outputs are rows row32<TA>(ty, ii) and columns 4 tx + jj.  Every read is
// a float4: two per 16 FMAs.
template <bool TA>
__device__ __forceinline__ void mac32(float (&acc)[4][4], const float* A, const float* B, int ty,
                                      int tx) {
#pragma unroll 2
  for (int m0 = 0; m0 < SB; m0 += 4) {
    float av[4][4];  // av[mm][ii] = op(A)[row ii][m0 + mm]
    if (TA) {
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const float4 v = ld4(A + (m0 + mm) * LD + 4 * ty);
        av[mm][0] = v.x, av[mm][1] = v.y, av[mm][2] = v.z, av[mm][3] = v.w;
      }
    } else {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float4 v = ld4(A + (ty + 8 * ii) * LD + m0);
        av[0][ii] = v.x, av[1][ii] = v.y, av[2][ii] = v.z, av[3][ii] = v.w;
      }
    }
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const float4 v = ld4(B + (m0 + mm) * LD + 4 * tx);
      const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(av[mm][ii], bv[jj], acc[ii][jj]);
    }
  }
}

// C = alpha * acc + beta * C over the thread's 4 x 4 patch of a 32 x 32
// block, rows laid out as mac32<TA> left them.
template <bool TA>
__device__ __forceinline__ void store32(float* C, const float (&acc)[4][4], float alpha, float beta,
                                        int ty, int tx) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    float4* c = reinterpret_cast<float4*>(C + row32<TA>(ty, ii) * LD + 4 * tx);
    float4 v = make_float4(alpha * acc[ii][0], alpha * acc[ii][1], alpha * acc[ii][2], alpha * acc[ii][3]);
    if (beta != 0.0f) {
      const float4 old = *c;
      v = make_float4(fmaf(beta, old.x, v.x), fmaf(beta, old.y, v.y), fmaf(beta, old.z, v.z),
                      fmaf(beta, old.w, v.w));
    }
    *c = v;
  }
}

// One warp: factor the 32 x 32 diagonal block D in place (U^T U = D, upper
// triangle) and write U^-1 to X; both get a strict lower triangle of 0.
// Lane j holds column j of the block in a[] and column j of L^-1 = (U^-1)^T
// (row j of U^-1) in y[], both in registers; only D's upper triangle is
// read.  Step k writes row k of U to D, and every lane reads it back as
// broadcast float4s (8 reads a step where 31 shuffles would be needed);
// the same values drive the factor's update and the forward substitution
// of L^-1.  The next pivot is formed from lane k + 1's own entries and
// shuffled, so the serial chain of a step is one shuffle, one rsqrt and
// two FP32 operations.  Not inlined: the four sub-panels share one copy of
// this code, which then stays in the instruction cache.
__device__ __noinline__ void warp_factor_invert(float* D, float* X, int lane) {
  __syncwarp();
  float a[SB], y[SB];
#pragma unroll
  for (int i = 0; i < SB; ++i) {
    a[i] = i <= lane ? D[i * LD + lane] : 0.0f;
    y[i] = i == lane ? 1.0f : 0.0f;
  }
  float p = __shfl_sync(FULL, a[0], 0);
#pragma unroll
  for (int k = 0; k < SB; ++k) {
    // 1 / sqrt(p): NaN for p < 0; a subnormal pivot (a panel singular in
    // f32) is flushed to 0 and, like a zero pivot, gives inf and NaN
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(p));
    a[k] = lane == k ? p * r : a[k] * r;  // row k of U
    // L^-1[k][j] is 0 above the diagonal: setting it (not scaling it)
    // keeps a NaN pivot below row j out of column j
    y[k] = k >= lane ? y[k] * r : 0.0f;
    D[k * LD + lane] = lane >= k ? a[k] : 0.0f;
    if (k + 1 < SB) p = __shfl_sync(FULL, fmaf(-a[k], a[k], a[k + 1]), k + 1);
    __syncwarp();
    // lane j: A[i][j] -= U[k][i] U[k][j] and L^-1[i][j] -= U[k][i] L^-1[k][j]
    // for i > k; lanes below row i compute values of the lower triangle of
    // A, which are never read
#pragma unroll
    for (int c = (k + 1) / 4; c < SB / 4; ++c) {
      const float4 v = ld4(D + k * LD + 4 * c);
      const float u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * c + e > k) {
          a[4 * c + e] = fmaf(-u[e], a[k], a[4 * c + e]);
          y[4 * c + e] = fmaf(-u[e], y[k], y[4 * c + e]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < SB; ++i) X[lane * LD + i] = i >= lane ? y[i] : 0.0f;
}

// Sub-panel S of the tile in shared memory: S holds the tile (factored in
// place), X its inverse, V the products V[k, r] = U[k, r] Winv_r (k < r).
template <int S>
__device__ __forceinline__ void subpanel_step(float* Sm, float* Xm, float* Vm, int tid) {
  if (tid < 32) warp_factor_invert(blk(Sm, S, S), blk(Xm, S, S), tid);
  __syncthreads();
  const int g = tid / GROUP, t = tid % GROUP, ty = t / 8, tx = t % 8;
  constexpr int NSOLVE = NSB - 1 - S;  // off-diagonal blocks of the sub-row
  static_assert(NSOLVE + S <= GROUPS, "one round of sub-row and V blocks");
  float acc[4][4] = {};
  if (g < NSOLVE) {
    // U[S, q] = Winv_S^T A[S, q]: the group reads its whole block, then writes it
    float* Bq = blk(Sm, S, S + 1 + g);
    mac32<true>(acc, blk(Xm, S, S), Bq, ty, tx);
    group_sync(g);
    store32<true>(Bq, acc, 1.0f, 0.0f, ty, tx);
  } else if (g < NSOLVE + S) {
    const int k = g - NSOLVE;
    mac32<false>(acc, blk(Sm, k, S), blk(Xm, S, S), ty, tx);
    store32<false>(blk(Vm, k, S), acc, 1.0f, 0.0f, ty, tx);
  }
  __syncthreads();
  if constexpr (NSOLVE > 0) {
    // A[p, q] -= U[S, p]^T U[S, q] over the upper blocks S < p <= q
    constexpr int NU = NSOLVE * (NSOLVE + 1) / 2;
    for (int u = g; u < NU; u += GROUPS) {
      int p = S + 1, q = S + 1;
      for (int v = 0; v < u; ++v) {
        if (++q == NSB) q = ++p;
      }
      float up[4][4] = {};
      mac32<true>(up, blk(Sm, S, p), blk(Sm, S, q), ty, tx);
      store32<true>(blk(Sm, p, q), up, -1.0f, 1.0f, ty, tx);
    }
    __syncthreads();
  }
}

// Block diagonal D of the tile's inverse: Wu[c, c+D] = -sum_{k=c}^{c+D-1}
// Wu[c, k] V[k, c+D], one group per block.
template <int D>
__device__ __forceinline__ void compose_diagonal(float* Xm, float* Vm, int tid) {
  const int g = tid / GROUP, t = tid % GROUP, ty = t / 8, tx = t % 8;
  if (g < NSB - D) {
    float acc[4][4] = {};
    for (int k = g; k < g + D; ++k) mac32<false>(acc, blk(Xm, g, k), blk(Vm, k, g + D), ty, tx);
    store32<false>(blk(Xm, g, g + D), acc, -1.0f, 0.0f, ty, tx);
  }
  __syncthreads();
}

// Offset of panel `batch` in a stack of contiguous b x b panels: 0 in the
// single-panel kernels (BATCHED false), which index exactly as before.
template <bool BATCHED>
__device__ __forceinline__ size_t panel_offset(unsigned batch, int b) {
  return BATCHED ? (size_t)batch * b * b : 0;
}

// Factor the diagonal tile at U[t0:t0+T, t0:t0+T] (leading dimension b) and
// write U_tt (strict lower zeroed) back, and its inverse to Wu_tt.  BATCHED:
// panel blockIdx.x of a stack.
template <bool BATCHED>
__global__ void __launch_bounds__(TILE_THREADS)
tile_factor_inverse(float* __restrict__ U, float* __restrict__ Wu, int b, int t0) {
  U += panel_offset<BATCHED>(blockIdx.x, b);
  Wu += panel_offset<BATCHED>(blockIdx.x, b);
  extern __shared__ float4 smem4[];
  float* Sm = reinterpret_cast<float*>(smem4);
  float* Xm = Sm + T * LD;
  float* Vm = Xm + T * LD;
  const int tid = threadIdx.x;
  constexpr int ROW4 = T / 4;  // float4 per tile row

#pragma unroll
  for (int e = tid; e < T * ROW4; e += TILE_THREADS) {
    const int i = e / ROW4, k = 4 * (e % ROW4);
    *reinterpret_cast<float4*>(Sm + i * LD + k) =
        *reinterpret_cast<const float4*>(U + (size_t)(t0 + i) * b + t0 + k);
  }
  __syncthreads();
  subpanel_step<0>(Sm, Xm, Vm, tid);
  subpanel_step<1>(Sm, Xm, Vm, tid);
  subpanel_step<2>(Sm, Xm, Vm, tid);
  subpanel_step<3>(Sm, Xm, Vm, tid);
  compose_diagonal<1>(Xm, Vm, tid);
  compose_diagonal<2>(Xm, Vm, tid);
  compose_diagonal<3>(Xm, Vm, tid);

#pragma unroll 4
  for (int e = tid; e < T * ROW4; e += TILE_THREADS) {
    const int i = e / ROW4, k = 4 * (e % ROW4);
    float4 u = *reinterpret_cast<const float4*>(Sm + i * LD + k);
    float4 w = *reinterpret_cast<const float4*>(Xm + i * LD + k);
    if (k < i) u.x = w.x = 0.0f;
    if (k + 1 < i) u.y = w.y = 0.0f;
    if (k + 2 < i) u.z = w.z = 0.0f;
    if (k + 3 < i) u.w = w.w = 0.0f;
    const size_t at = (size_t)(t0 + i) * b + t0 + k;
    *reinterpret_cast<float4*>(U + at) = u;
    *reinterpret_cast<float4*>(Wu + at) = w;
  }
}

// U[t, t+1:] = Wu_tt^T U[t, t+1:] in place, RS_BN columns a block, and
// U[t+1:, t] = 0 (the mirrored strict lower part of U).  The block holds
// Wu_tt and all 128 rows of its column slice in shared memory before it
// writes, so no other block reads what it overwrites.  BATCHED: panel
// blockIdx.y of a stack.
template <bool BATCHED>
__global__ void __launch_bounds__(RS_THREADS)
row_solve(float* __restrict__ U, const float* __restrict__ Wu, int b, int t0) {
  U += panel_offset<BATCHED>(blockIdx.y, b);
  Wu += panel_offset<BATCHED>(blockIdx.y, b);
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);
  float* Bs = Ws + T * RS_LDW;
  const int c0 = t0 + T + blockIdx.x * RS_BN;  // first column of the slice
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = tid; e < T * T / 4; e += RS_THREADS) {
    const int i = e / (T / 4), k = 4 * (e % (T / 4));
    *reinterpret_cast<float4*>(Ws + i * RS_LDW + k) =
        *reinterpret_cast<const float4*>(Wu + (size_t)(t0 + i) * b + t0 + k);
  }
#pragma unroll
  for (int e = tid; e < T * RS_BN / 4; e += RS_THREADS) {
    const int i = e / (RS_BN / 4), k = 4 * (e % (RS_BN / 4));
    *reinterpret_cast<float4*>(Bs + i * RS_LDB + k) =
        *reinterpret_cast<const float4*>(U + (size_t)(t0 + i) * b + c0 + k);
  }
  __syncthreads();
  const int ty = tid / (RS_BN / 4), tx = tid % (RS_BN / 4);  // rows 4 ty + i, columns 4 tx + j
  float acc[4][4] = {};
  // out[i][c] = sum_m Wu_tt[m][i] slice[m][c]; Wu_tt[m][i] = 0 for m > i
  for (int m = 0; m < 4 * ty + 4; ++m) {
    const float4 a = *reinterpret_cast<const float4*>(Ws + m * RS_LDW + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(Bs + m * RS_LDB + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(U + (size_t)(t0 + 4 * ty + i) * b + c0 + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  for (int e = tid; e < RS_BN * T / 4; e += RS_THREADS) {
    const int c = e / (T / 4), k = 4 * (e % (T / 4));
    *reinterpret_cast<float4*>(U + (size_t)(c0 + c) * b + t0 + k) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// acc += op(A)[bm:bm+BM, kb:ke] B[kb:ke, bn:bn+BN], row-major, op(A) = A^T
// when TRANS_A (A stored (K, M)).  BK-deep slices pass through shared
// memory while the next slice is fetched into registers.  Thread (ty, tx)
// of 16 x 16 owns rows bm + 4 ty + i and columns bn + 4 tx + j; each output
// sums over k in order, so a product B^T B is bitwise symmetric.  kb, ke
// are multiples of BK and the same for the whole block.
template <bool TRANS_A>
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4], const float* __restrict__ A, int lda,
                                          const float* __restrict__ B, int ldb, int bm, int bn,
                                          int kb, int ke) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float4 ra, rb;
  auto fetch = [&](int k0) {
    if (TRANS_A) {
      ra = *reinterpret_cast<const float4*>(A + (size_t)(k0 + tid / 16) * lda + bm + 4 * (tid % 16));
    } else {
      ra = *reinterpret_cast<const float4*>(A + (size_t)(bm + tid / 4) * lda + k0 + 4 * (tid % 4));
    }
    rb = *reinterpret_cast<const float4*>(B + (size_t)(k0 + tid / 16) * ldb + bn + 4 * (tid % 16));
  };
  if (kb >= ke) return;
  fetch(kb);
  for (int k0 = kb; k0 < ke; k0 += BK) {
    if (TRANS_A) {
      *reinterpret_cast<float4*>(&As[tid / 16][4 * (tid % 16)]) = ra;
    } else {
      const int m = tid / 4, k = 4 * (tid % 4);
      As[k][m] = ra.x;
      As[k + 1][m] = ra.y;
      As[k + 2][m] = ra.z;
      As[k + 3][m] = ra.w;
    }
    *reinterpret_cast<float4*>(&Bs[tid / 16][4 * (tid % 16)]) = rb;
    __syncthreads();
    if (k0 + BK < ke) fetch(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// C[bm:bm+BM, bn:bn+BN] = alpha * acc + beta * C (beta == 0 never reads C).
__device__ __forceinline__ void gemm_store(float* C, int ldc, int bm, int bn, const float (&acc)[4][4],
                                           float alpha, float beta) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4* c = reinterpret_cast<float4*>(C + (size_t)(bm + 4 * ty + i) * ldc + bn + 4 * tx);
    float4 v = make_float4(alpha * acc[i][0], alpha * acc[i][1], alpha * acc[i][2], alpha * acc[i][3]);
    if (beta != 0.0f) {
      const float4 old = *c;
      v = make_float4(v.x + beta * old.x, v.y + beta * old.y, v.z + beta * old.z, v.w + beta * old.w);
    }
    *c = v;
  }
}

// U[t+1:, t+1:] -= U[t, t+1:]^T U[t, t+1:] over the upper 64 x 64 blocks;
// blocks wholly below the diagonal exit at once.  BATCHED: panel blockIdx.z
// of a stack.
template <bool BATCHED>
__global__ void __launch_bounds__(GEMM_THREADS) trailing_update(float* U, int b, int t0) {
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  if (bm >= bn + BN) return;
  U += panel_offset<BATCHED>(blockIdx.z, b);
  const float* row = U + (size_t)t0 * b + t0 + T;
  float acc[4][4] = {};
  gemm_tile<true>(acc, row, b, row, b, bm, bn, 0, T);
  gemm_store(U + (size_t)(t0 + T) * b + t0 + T, b, bm, bn, acc, -1.0f, 1.0f);
}

// One level of the inverse composition: pair z joins the diagonal blocks
// Wu[o, o] (s x s) and Wu[o+s, o+s] (s2 x s2, s2 <= s), o = 2 s z:
//   STEP 1: P_z = W11 U[o, o+s]        (W11 upper: k from bm)
//   STEP 2: Wu[o, o+s] = -P_z W22      (W22 upper: k below bn + BN)
// and STEP 2 writes Wu[o+s, o] = 0.  P_z is s x s2 with row stride s.
// BATCHED: blockIdx.z = z + pairs * (panel of the stack), with a b x b
// scratch a panel.
template <int STEP, bool BATCHED>
__global__ void __launch_bounds__(GEMM_THREADS)
compose_level(const float* __restrict__ U, float* __restrict__ Wu, float* __restrict__ P, int b, int s) {
  const unsigned pairs = BATCHED ? (b - s + 2 * s - 1) / (2 * s) : 1;
  const unsigned z = BATCHED ? blockIdx.z % pairs : blockIdx.z;
  const size_t panel = panel_offset<BATCHED>(blockIdx.z / pairs, b);
  U += panel;
  Wu += panel;
  P += panel;
  const int o = 2 * s * z;
  const int s2 = b - o - s < s ? b - o - s : s;
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  if (bn >= s2) return;
  float* Pz = P + (size_t)z * s * s;
  float acc[4][4] = {};
  if (STEP == 1) {
    gemm_tile<false>(acc, Wu + (size_t)o * b + o, b, U + (size_t)o * b + o + s, b, bm, bn, bm, s);
    gemm_store(Pz, s, bm, bn, acc, 1.0f, 0.0f);
  } else {
    gemm_tile<false>(acc, Pz, s, Wu + (size_t)(o + s) * b + o + s, b, bm, bn, 0, bn + BN);
    gemm_store(Wu + (size_t)o * b + o + s, b, bm, bn, acc, -1.0f, 0.0f);
    for (int e = threadIdx.x; e < BN * BM / 4; e += GEMM_THREADS) {
      const int r = e / (BM / 4), k = 4 * (e % (BM / 4));
      *reinterpret_cast<float4*>(Wu + (size_t)(o + s + bn + r) * b + o + bm + k) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// The launch sequence over `batch` contiguous panels: one panel with the
// single-panel kernels (BATCHED false, a grid of exactly the old shape), a
// stack with each grid widened by the panel index.
template <bool BATCHED>
int panel_cholinv_launches(const float* A, float* U, float* Wu, float* scratch, int b, int batch,
                           cudaStream_t stream) {
  if (b <= 0 || b % T != 0 || b > 1024 || batch <= 0) return (int)cudaErrorInvalidValue;
  // grid.y and grid.z are at most 65535: the batch, times the pairs of the
  // first composition level (at most 4) for compose_level
  if (BATCHED && 4 * batch > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tile_factor_inverse<BATCHED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TILE_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(row_solve<BATCHED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)RS_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(U, A, (size_t)batch * b * b * sizeof(float), cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;

  for (int t0 = 0; t0 < b; t0 += T) {
    tile_factor_inverse<BATCHED><<<batch, TILE_THREADS, TILE_SMEM, stream>>>(U, Wu, b, t0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int w = b - t0 - T;  // width of the tile row right of the diagonal
    if (w == 0) break;
    row_solve<BATCHED><<<dim3(w / RS_BN, batch), RS_THREADS, RS_SMEM, stream>>>(U, Wu, b, t0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    trailing_update<BATCHED><<<dim3(w / BN, w / BM, batch), GEMM_THREADS, 0, stream>>>(U, b, t0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  for (int s = T; s < b; s *= 2) {
    const int pairs = (b - s + 2 * s - 1) / (2 * s);  // pairs with o + s < b
    const dim3 grid(s / BN, s / BM, pairs * batch);
    compose_level<1, BATCHED><<<grid, GEMM_THREADS, 0, stream>>>(U, Wu, scratch, b, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    compose_level<2, BATCHED><<<grid, GEMM_THREADS, 0, stream>>>(U, Wu, scratch, b, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// A, U, Wu: (b, b) row-major f32; scratch: b * b floats.  All on `stream`.
int panel_cholinv_f32(const float* A, float* U, float* Wu, float* scratch, int b, void* stream_ptr) {
  return panel_cholinv_launches<false>(A, U, Wu, scratch, b, 1, (cudaStream_t)stream_ptr);
}

// A, U, Wu: (batch, b, b) row-major f32, panels contiguous; scratch: batch *
// b * b floats.  Each panel is factored as panel_cholinv_f32 factors it:
// the same operations in the same order, so each slice equals that call's
// output, and a non-SPD panel gives NaN in its own slice only.
int panel_cholinv_batched_f32(const float* A, float* U, float* Wu, float* scratch, int b, int batch,
                              void* stream_ptr) {
  return panel_cholinv_launches<true>(A, U, Wu, scratch, b, batch, (cudaStream_t)stream_ptr);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
