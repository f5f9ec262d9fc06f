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
// factorization: a memset of its counters and one launch, no copy of the
// stack.  What bounds it: at W = 16, b = 1024 the work is 16 x 2 b^3 / 3
// FLOP (0.171 ms at 67 TFLOP/s FP32), but each panel's eight tile steps are
// a serial chain, ~0.025 ms each on one SM, and the first design (one launch
// a step for all panels: 28 launches and a copy of the stack, 0.88 ms) kept
// 16 of 132 SMs busy during every tile step while the card waited at each
// launch boundary.  Here a panel's work is a list of tasks, one 256-thread
// block's share of one step each: a tile step; a 32-column row-solve slice
// (the next tile's column) or a whole tile column (the others, Wu_tt read
// once); a 64 x 64 update block of a diagonal tile or a whole 128 x 128 tile
// above the diagonal; a composition block, 64 x 64 or, when a panel has at
// most 8 blocks, 128 x 128.  The list is in the order of a list schedule
// made on the host (make_plan) that starts each ready task by its longest
// path to the end: after tile t's row solve the next diagonal tile's update
// comes first, and tile t + 1's step starts as soon as that tile is final
// while the other blocks update the tiles below (look-ahead); the
// composition's first half, levels 128 and 256 of tiles 0-3 and the top
// level's STEP 1, runs while tiles 4-7 are factored, and the top level's
// STEP 2 columns that read only W22's finished upper-left blocks start
// before the last tile.  One persistent grid of one block an SM (the tile
// step's shared memory), launched cooperatively so that every block is
// resident, takes the tasks of all panels from one queue; blocks synchronise
// through counters in device memory, not barriers: thread 0 waits with
// acquire loads until the counters of a task's inputs reach their targets,
// and the task raises its own (fence, atomic add).  A barrier would make
// every block wait for each tile step, which keeps the products from running
// under it.  Thread-block clusters (one a panel) were tried first: the card
// holds at most 15 clusters of 8 and 17 of 6 at once, so at W = 16 a panel
// had 6 SMs and 96 of the 132 worked: 1.12 ms, against 0.90 ms for the same
// tasks from one shared queue, which lets every block work on every panel.
// Step 0 reads A and writes U.  The tasks call the single-panel kernels'
// device functions (tile_step, row_solve_slice, the products' FMA chains),
// so each slice equals panel_cholinv_f32's output bit for bit, and a non-SPD
// panel's NaN stays in its slice.  Measured (NVIDIA H100 80GB HBM3, 700 W,
// in turns against the first design in one call): W = 1 / 4 / 16 / 21 / 32
// panels of 1024 in 0.41-0.42 / 0.43-0.44 / 0.66-0.67 / 0.82-0.84 /
// 1.23-1.24 ms against 0.40-0.42 / 0.50-0.51 / 0.87-0.88 / 1.03 / 1.37 ms;
// at W = 16 26% of the bound.  Its tile step takes 25-30 us at W = 1 and
// 35-45 us at W = 16 against 22 us in the single-panel kernel, likely
// because its code (115 KB in that kernel) is fetched from an L2 that the
// other SMs keep busy; so at W = 1 the tile chain leaves it no faster than
// the first design (PERF.md).

#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>
#include <vector>

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

// ---------------------------------------------------------------------------
// The four steps as device functions of one panel, the block's indices as
// arguments.  The single-panel kernels below are thin wrappers around them,
// and the batched kernel calls the same functions, so every entry of both
// runs the same FMAs in the same order.

// subpanel_step and compose_diagonal with the sub-panel and the diagonal as
// runtime arguments, for the batched kernel: the same calls of the same
// functions, so the same bits, but one copy of the code where the
// templates unroll four and three: in the batched kernel, whose tile
// steps run beside the products, this took a tile step from about 55k to
// 50k cycles at W = 1 (H100, 700 W).
__device__ __forceinline__ void subpanel_step_rt(int S, float* Sm, float* Xm, float* Vm, int tid) {
  if (tid < 32) warp_factor_invert(blk(Sm, S, S), blk(Xm, S, S), tid);
  __syncthreads();
  const int g = tid / GROUP, t = tid % GROUP, ty = t / 8, tx = t % 8;
  const int nsolve = NSB - 1 - S;  // off-diagonal blocks of the sub-row
  float acc[4][4] = {};
  if (g < nsolve) {
    float* Bq = blk(Sm, S, S + 1 + g);
    mac32<true>(acc, blk(Xm, S, S), Bq, ty, tx);
    group_sync(g);
    store32<true>(Bq, acc, 1.0f, 0.0f, ty, tx);
  } else if (g < nsolve + S) {
    const int k = g - nsolve;
    mac32<false>(acc, blk(Sm, k, S), blk(Xm, S, S), ty, tx);
    store32<false>(blk(Vm, k, S), acc, 1.0f, 0.0f, ty, tx);
  }
  __syncthreads();
  if (nsolve > 0) {
    const int nu = nsolve * (nsolve + 1) / 2;
    for (int u = g; u < nu; u += GROUPS) {
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

__device__ __forceinline__ void compose_diagonal_rt(int D, float* Xm, float* Vm, int tid) {
  const int g = tid / GROUP, t = tid % GROUP, ty = t / 8, tx = t % 8;
  if (g < NSB - D) {
    float acc[4][4] = {};
    for (int k = g; k < g + D; ++k) mac32<false>(acc, blk(Xm, g, k), blk(Vm, k, g + D), ty, tx);
    store32<false>(blk(Xm, g, g + D), acc, -1.0f, 0.0f, ty, tx);
  }
  __syncthreads();
}

// Copy `n` float4 a thread, element e = tid + TILE_THREADS q at (row(e),
// col(e)), from global memory to shared memory.  STAGED: all loads first,
// into registers, then the stores: without __restrict__ on the source
// (the batched kernel's blocks write what others read) the compiler cannot
// move a load above the shared store before it, and each load's latency
// would be paid in turn.
template <bool STAGED, int N, typename Src, typename Dst>
__device__ __forceinline__ void copy_in(Src src, Dst dst) {
  if (STAGED) {
    float4 v[N];
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = src(q);
#pragma unroll
    for (int q = 0; q < N; ++q) *dst(q) = v[q];
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) *dst(q) = src(q);
  }
}

// Factor the diagonal tile at [t0, t0 + T) of the panel read from `src`
// (leading dimension b) and write U_tt (strict lower zeroed) to U and its
// inverse to Wu.  Sm holds TILE_SMEM bytes of shared memory.  STAGED (the
// batched kernel): copy_in<true>, and the runtime-indexed sub-panel steps.
template <bool STAGED = false>
__device__ __forceinline__ void tile_step(const float* src, float* U, float* Wu, int b, int t0, float* Sm) {
  float* Xm = Sm + T * LD;
  float* Vm = Xm + T * LD;
  const int tid = threadIdx.x;
  constexpr int ROW4 = T / 4;  // float4 per tile row

  copy_in<STAGED, T * ROW4 / TILE_THREADS>(
      [&](int q) {
        const int e = tid + q * TILE_THREADS, i = e / ROW4, k = 4 * (e % ROW4);
        return *reinterpret_cast<const float4*>(src + (size_t)(t0 + i) * b + t0 + k);
      },
      [&](int q) {
        const int e = tid + q * TILE_THREADS, i = e / ROW4, k = 4 * (e % ROW4);
        return reinterpret_cast<float4*>(Sm + i * LD + k);
      });
  __syncthreads();
  if (STAGED) {
#pragma unroll 1
    for (int S = 0; S < NSB; ++S) subpanel_step_rt(S, Sm, Xm, Vm, tid);
#pragma unroll 1
    for (int D = 1; D < NSB; ++D) compose_diagonal_rt(D, Xm, Vm, tid);
  } else {
    subpanel_step<0>(Sm, Xm, Vm, tid);
    subpanel_step<1>(Sm, Xm, Vm, tid);
    subpanel_step<2>(Sm, Xm, Vm, tid);
    subpanel_step<3>(Sm, Xm, Vm, tid);
    compose_diagonal<1>(Xm, Vm, tid);
    compose_diagonal<2>(Xm, Vm, tid);
    compose_diagonal<3>(Xm, Vm, tid);
  }

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

// Slice `slice` (RS_BN columns) of the off-diagonal tile row: U[t, c0:c0+RS_BN]
// = Wu_tt^T src[t, c0:c0+RS_BN], c0 = t0 + T + slice RS_BN, and U[c0:c0+RS_BN,
// t] = 0 (the mirrored strict lower part of U).  The block holds Wu_tt and all
// 128 rows of its slice in shared memory (RS_SMEM bytes at smem) before it
// writes, so in place (src == U) no other block reads what it overwrites.
// LOAD_W false: Wu_tt is in shared memory already (the slice before it).
// STAGED: the loads as copy_in<true> makes them.
template <bool LOAD_W = true, bool STAGED = false>
__device__ __forceinline__ void row_solve_slice(const float* src, float* U, const float* Wu, int b, int t0,
                                                int slice, float* smem) {
  float* Ws = smem;
  float* Bs = Ws + T * RS_LDW;
  const int c0 = t0 + T + slice * RS_BN;  // first column of the slice
  const int tid = threadIdx.x;
  if (LOAD_W) {
    copy_in<STAGED, T * T / 4 / RS_THREADS>(
        [&](int q) {
          const int e = tid + q * RS_THREADS, i = e / (T / 4), k = 4 * (e % (T / 4));
          return *reinterpret_cast<const float4*>(Wu + (size_t)(t0 + i) * b + t0 + k);
        },
        [&](int q) {
          const int e = tid + q * RS_THREADS, i = e / (T / 4), k = 4 * (e % (T / 4));
          return reinterpret_cast<float4*>(Ws + i * RS_LDW + k);
        });
  }
  copy_in<STAGED, T * RS_BN / 4 / RS_THREADS>(
      [&](int q) {
        const int e = tid + q * RS_THREADS, i = e / (RS_BN / 4), k = 4 * (e % (RS_BN / 4));
        return *reinterpret_cast<const float4*>(src + (size_t)(t0 + i) * b + c0 + k);
      },
      [&](int q) {
        const int e = tid + q * RS_THREADS, i = e / (RS_BN / 4), k = 4 * (e % (RS_BN / 4));
        return reinterpret_cast<float4*>(Bs + i * RS_LDB + k);
      });
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

// C[bm:bm+BM, bn:bn+BN] = alpha * acc + beta * Cold[bm:bm+BM, bn:bn+BN]
// (beta == 0 never reads Cold; Cold is C in place).  STAGED: every old
// value is loaded before the first store (copy_in's reason).
template <bool STAGED = false>
__device__ __forceinline__ void gemm_store(float* C, const float* Cold, int ldc, int bm, int bn,
                                           const float (&acc)[4][4], float alpha, float beta) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float4 olds[4];
  if (STAGED && beta != 0.0f) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      olds[i] = *reinterpret_cast<const float4*>(Cold + (size_t)(bm + 4 * ty + i) * ldc + bn + 4 * tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t at = (size_t)(bm + 4 * ty + i) * ldc + bn + 4 * tx;
    float4 v = make_float4(alpha * acc[i][0], alpha * acc[i][1], alpha * acc[i][2], alpha * acc[i][3]);
    if (beta != 0.0f) {
      const float4 old = STAGED ? olds[i] : *reinterpret_cast<const float4*>(Cold + at);
      v = make_float4(v.x + beta * old.x, v.y + beta * old.y, v.z + beta * old.z, v.w + beta * old.w);
    }
    *reinterpret_cast<float4*>(C + at) = v;
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory"); }

// gemm_tile's product for the batched kernel, where one block an SM must
// hide the L2's latency alone: the same thread layout and, for every
// output, the same FMA chain (k ascending from kb, fmaf into acc), so the
// same bits; the operands reach shared memory (GEMM_SMEM bytes at smem,
// free while no tile step runs) by cp.async in SK-deep stages,
// GEMM_STAGES - 1 stages ahead of the FMAs, with one barrier a stage.
// op(A) = A^T keeps gemm_tile's (k, m) layout; otherwise A's rows are
// copied as they are, (m, k), and read four k at a time.  kb, ke are
// multiples of SK.
constexpr int SK = 32, GEMM_STAGES = 4;
constexpr int STAGE_FLOATS = SK * (BM + 4) + SK * (BN + 4) > BM * (SK + 4) + SK * (BN + 4)
                                 ? SK * (BM + 4) + SK * (BN + 4)
                                 : BM * (SK + 4) + SK * (BN + 4);
constexpr size_t GEMM_SMEM = GEMM_STAGES * STAGE_FLOATS * sizeof(float);

template <bool TRANS_A>
__device__ __forceinline__ void gemm_staged(float (&acc)[4][4], const float* A, int lda, const float* B, int ldb,
                                            int bm, int bn, int kb, int ke, float* smem) {
  constexpr int A_LD = TRANS_A ? BM + 4 : SK + 4;  // (k, m) or (m, k) rows
  constexpr int A_FLOATS = TRANS_A ? SK * A_LD : BM * A_LD;
  constexpr int B_LD = BN + 4;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int stages = (ke - kb) / SK;
  auto issue = [&](int st) {
    if (st < stages) {
      float* As = smem + (st % GEMM_STAGES) * STAGE_FLOATS;
      float* Bs = As + A_FLOATS;
      const int k0 = kb + st * SK;
#pragma unroll
      for (int e = tid; e < SK * BM / 4; e += GEMM_THREADS) {
        if (TRANS_A) {
          const int k = e / (BM / 4), m = 4 * (e % (BM / 4));
          cp_async16(As + k * A_LD + m, A + (size_t)(k0 + k) * lda + bm + m);
        } else {
          const int m = e / (SK / 4), k = 4 * (e % (SK / 4));
          cp_async16(As + m * A_LD + k, A + (size_t)(bm + m) * lda + k0 + k);
        }
      }
#pragma unroll
      for (int e = tid; e < SK * BN / 4; e += GEMM_THREADS) {
        const int k = e / (BN / 4), n = 4 * (e % (BN / 4));
        cp_async16(Bs + k * B_LD + n, B + (size_t)(k0 + k) * ldb + bn + n);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int st = 0; st < GEMM_STAGES - 1; ++st) issue(st);
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();  // stage st is in; every thread is done with st - 1
    issue(st + GEMM_STAGES - 1);
    const float* As = smem + (st % GEMM_STAGES) * STAGE_FLOATS;
    const float* Bs = As + A_FLOATS;
#pragma unroll 1
    for (int k4 = 0; k4 < SK; k4 += 4) {
      float av[4][4];  // av[kk][i] = op(A)[4 ty + i][k4 + kk]
      if (TRANS_A) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = ld4(As + (k4 + kk) * A_LD + 4 * ty);
          av[kk][0] = v.x, av[kk][1] = v.y, av[kk][2] = v.z, av[kk][3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = ld4(As + (4 * ty + i) * A_LD + k4);
          av[0][i] = v.x, av[1][i] = v.y, av[2][i] = v.z, av[3][i] = v.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v = ld4(Bs + (k4 + kk) * B_LD + 4 * tx);
        const float bw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[kk][i], bw[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
}

// The batched kernel's 128 x 128 blocks: acc += op(A)[bm:bm+128, k] B[k,
// bn:bn+128] over k in [kb, ke), 8 x 8 outputs a thread (rows 4 ty + i and
// 64 + 4 ty + i, columns likewise with tx), staged as gemm_staged.  Each
// 64 x 64 quarter keeps the FMA chain gemm_tile gives it: rows of the lower
// half start at row2_from (STEP 1's K starts at its block's row), columns
// of the left half stop at col1_to (STEP 2's ends past its block's
// column), so the bits equal those of four gemm_tile blocks.
constexpr int BIG = 2 * BM, BSK = 16;
constexpr int BIG_STAGE_FLOATS = BIG * (BSK + 4) + BSK * (BIG + 4) > 2 * BSK * (BIG + 4)
                                     ? BIG * (BSK + 4) + BSK * (BIG + 4)
                                     : 2 * BSK * (BIG + 4);
constexpr size_t BIG_SMEM = GEMM_STAGES * BIG_STAGE_FLOATS * sizeof(float);

// acc[i][j] += op(A)[row i][k] B[k][col j] for k in [k0, k0 + BSK) from one
// stage; ROWS / COLS: which halves take part (1 first, 2 second, 3 both).
template <bool TRANS_A, int ROWS, int COLS>
__device__ __forceinline__ void big_stage(float (&acc)[8][8], const float* As, const float* Bs, int ty, int tx) {
  constexpr int A_LD = TRANS_A ? BIG + 4 : BSK + 4, B_LD = BIG + 4;
  // not unrolled: six copies of a stage's 1024 FMAs would crowd the tile
  // step's code out of the instruction cache
#pragma unroll 1
  for (int k4 = 0; k4 < BSK; k4 += 4) {
    float av[4][8];  // av[kk][i]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!(ROWS & (1 << h))) continue;
      if (TRANS_A) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = ld4(As + (k4 + kk) * A_LD + 64 * h + 4 * ty);
          av[kk][4 * h] = v.x, av[kk][4 * h + 1] = v.y, av[kk][4 * h + 2] = v.z, av[kk][4 * h + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = ld4(As + (64 * h + 4 * ty + i) * A_LD + k4);
          av[0][4 * h + i] = v.x, av[1][4 * h + i] = v.y, av[2][4 * h + i] = v.z, av[3][4 * h + i] = v.w;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bw[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!(COLS & (1 << h))) continue;
        const float4 v = ld4(Bs + (k4 + kk) * B_LD + 64 * h + 4 * tx);
        bw[4 * h] = v.x, bw[4 * h + 1] = v.y, bw[4 * h + 2] = v.z, bw[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!(ROWS & (1 << (i / 4)))) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!(COLS & (1 << (j / 4)))) continue;
          acc[i][j] = fmaf(av[kk][i], bw[j], acc[i][j]);
        }
      }
    }
  }
}

template <bool TRANS_A>
__device__ __forceinline__ void gemm_big(float (&acc)[8][8], const float* A, int lda, const float* B, int ldb, int bm,
                                         int bn, int kb, int ke, int row2_from, int col1_to, float* smem) {
  constexpr int A_LD = TRANS_A ? BIG + 4 : BSK + 4;
  constexpr int A_FLOATS = TRANS_A ? BSK * A_LD : BIG * A_LD;
  constexpr int B_LD = BIG + 4;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int stages = (ke - kb) / BSK;
  auto issue = [&](int st) {
    if (st < stages) {
      float* As = smem + (st % GEMM_STAGES) * BIG_STAGE_FLOATS;
      float* Bs = As + A_FLOATS;
      const int k0 = kb + st * BSK;
#pragma unroll
      for (int e = tid; e < BSK * BIG / 4; e += GEMM_THREADS) {
        if (TRANS_A) {
          const int k = e / (BIG / 4), m = 4 * (e % (BIG / 4));
          cp_async16(As + k * A_LD + m, A + (size_t)(k0 + k) * lda + bm + m);
        } else {
          const int m = e / (BSK / 4), k = 4 * (e % (BSK / 4));
          cp_async16(As + m * A_LD + k, A + (size_t)(bm + m) * lda + k0 + k);
        }
      }
#pragma unroll
      for (int e = tid; e < BSK * BIG / 4; e += GEMM_THREADS) {
        const int k = e / (BIG / 4), n = 4 * (e % (BIG / 4));
        cp_async16(Bs + k * B_LD + n, B + (size_t)(k0 + k) * ldb + bn + n);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < GEMM_STAGES - 1; ++st) issue(st);
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();
    issue(st + GEMM_STAGES - 1);
    const float* As = smem + (st % GEMM_STAGES) * BIG_STAGE_FLOATS;
    const float* Bs = As + A_FLOATS;
    const int k0 = kb + st * BSK;
    const bool rows2 = k0 >= row2_from, cols1 = k0 < col1_to;
    if (rows2 && cols1) {
      big_stage<TRANS_A, 3, 3>(acc, As, Bs, ty, tx);
    } else if (!rows2) {
      big_stage<TRANS_A, 1, 3>(acc, As, Bs, ty, tx);
    } else {
      big_stage<TRANS_A, 3, 2>(acc, As, Bs, ty, tx);
    }
  }
  cp_async_wait<0>();
}

// C[bm:bm+128, bn:bn+128] = alpha acc + beta Cold (gemm_store's arithmetic),
// every old value loaded before the first store.
__device__ __forceinline__ void store_big(float* C, const float* Cold, int ldc, int bm, int bn,
                                          const float (&acc)[8][8], float alpha, float beta) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  auto at = [&](int i, int h) {
    return (size_t)(bm + 64 * (i / 4) + 4 * ty + i % 4) * ldc + bn + 64 * h + 4 * tx;
  };
  float4 olds[8][2];
  if (beta != 0.0f) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) olds[i][h] = *reinterpret_cast<const float4*>(Cold + at(i, h));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* a = acc[i] + 4 * h;
      float4 v = make_float4(alpha * a[0], alpha * a[1], alpha * a[2], alpha * a[3]);
      if (beta != 0.0f) {
        const float4 old = olds[i][h];
        v = make_float4(v.x + beta * old.x, v.y + beta * old.y, v.z + beta * old.z, v.w + beta * old.w);
      }
      *reinterpret_cast<float4*>(C + at(i, h)) = v;
    }
  }
}

// acc += op(A) B over [kb, ke): gemm_tile in the single-panel kernels,
// gemm_staged (same bits, in `smem`) in the batched one (STAGED).
template <bool STAGED, bool TRANS_A>
__device__ __forceinline__ void gemm(float (&acc)[4][4], const float* A, int lda, const float* B, int ldb, int bm,
                                     int bn, int kb, int ke, float* smem) {
  if (STAGED) {
    gemm_staged<TRANS_A>(acc, A, lda, B, ldb, bm, bn, kb, ke, smem);
  } else {
    gemm_tile<TRANS_A>(acc, A, lda, B, ldb, bm, bn, kb, ke);
  }
}

// Block (bm, bn) of the trailing update U[t+1:, t+1:] = src[t+1:, t+1:] -
// U[t, t+1:]^T U[t, t+1:] (offsets from t0 + T).
template <bool STAGED>
__device__ __forceinline__ void trailing_block(const float* src, float* U, int b, int t0, int bm, int bn,
                                               float* smem) {
  const float* row = U + (size_t)t0 * b + t0 + T;
  float acc[4][4] = {};
  gemm<STAGED, true>(acc, row, b, row, b, bm, bn, 0, T, smem);
  const size_t at = (size_t)(t0 + T) * b + t0 + T;
  gemm_store<STAGED>(U + at, src + at, b, bm, bn, acc, -1.0f, 1.0f);
}

// Block (bm, bn) of one step of the inverse's composition for the pair of
// diagonal blocks Wu[o, o] (s x s) and Wu[o+s, o+s] (s2 x s2, s2 <= s):
//   STEP 1: Pz = W11 U[o, o+s]        (W11 upper: k from bm)
//   STEP 2: Wu[o, o+s] = -Pz W22      (W22 upper: k below bn + BN)
// and STEP 2 writes Wu[o+s, o] = 0.  Pz is s x s2 with row stride s.
template <int STEP, bool STAGED>
__device__ __forceinline__ void compose_block(const float* U, float* Wu, float* Pz, int b, int s, int o, int bm,
                                              int bn, float* smem) {
  float acc[4][4] = {};
  if (STEP == 1) {
    gemm<STAGED, false>(acc, Wu + (size_t)o * b + o, b, U + (size_t)o * b + o + s, b, bm, bn, bm, s, smem);
    gemm_store(Pz, Pz, s, bm, bn, acc, 1.0f, 0.0f);
  } else {
    gemm<STAGED, false>(acc, Pz, s, Wu + (size_t)(o + s) * b + o + s, b, bm, bn, 0, bn + BN, smem);
    float* C = Wu + (size_t)o * b + o + s;
    gemm_store(C, C, b, bm, bn, acc, -1.0f, 0.0f);
    for (int e = threadIdx.x; e < BN * BM / 4; e += GEMM_THREADS) {
      const int r = e / (BM / 4), k = 4 * (e % (BM / 4));
      *reinterpret_cast<float4*>(Wu + (size_t)(o + s + bn + r) * b + o + bm + k) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// The single panel: a sequence of launches, one grid per step (see the head
// of this file).  U holds a copy of A, factored in place.

__global__ void __launch_bounds__(TILE_THREADS)
tile_factor_inverse(float* __restrict__ U, float* __restrict__ Wu, int b, int t0) {
  extern __shared__ float4 smem4[];
  tile_step(U, U, Wu, b, t0, reinterpret_cast<float*>(smem4));
}

__global__ void __launch_bounds__(RS_THREADS)
row_solve(float* __restrict__ U, const float* __restrict__ Wu, int b, int t0) {
  extern __shared__ float4 smem4[];
  row_solve_slice(U, U, Wu, b, t0, blockIdx.x, reinterpret_cast<float*>(smem4));
}

// Blocks wholly below the diagonal exit at once.
__global__ void __launch_bounds__(GEMM_THREADS) trailing_update(float* U, int b, int t0) {
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  if (bm >= bn + BN) return;
  trailing_block<false>(U, U, b, t0, bm, bn, nullptr);
}

// One level of the composition: pair blockIdx.z, o = 2 s z, its product in
// P + z s^2.
template <int STEP>
__global__ void __launch_bounds__(GEMM_THREADS)
compose_level(const float* __restrict__ U, float* __restrict__ Wu, float* __restrict__ P, int b, int s) {
  const int z = blockIdx.z, o = 2 * s * z;
  const int s2 = b - o - s < s ? b - o - s : s;
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  if (bn >= s2) return;
  compose_block<STEP, false>(U, Wu, P + (size_t)z * s * s, b, s, o, bm, bn, nullptr);
}

int panel_cholinv_launches(const float* A, float* U, float* Wu, float* scratch, int b, cudaStream_t stream) {
  if (b <= 0 || b % T != 0 || b > 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tile_factor_inverse, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TILE_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(row_solve, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)RS_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(U, A, (size_t)b * b * sizeof(float), cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;

  for (int t0 = 0; t0 < b; t0 += T) {
    tile_factor_inverse<<<1, TILE_THREADS, TILE_SMEM, stream>>>(U, Wu, b, t0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int w = b - t0 - T;  // width of the tile row right of the diagonal
    if (w == 0) break;
    row_solve<<<w / RS_BN, RS_THREADS, RS_SMEM, stream>>>(U, Wu, b, t0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    trailing_update<<<dim3(w / BN, w / BM), GEMM_THREADS, 0, stream>>>(U, b, t0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  for (int s = T; s < b; s *= 2) {
    const int pairs = (b - s + 2 * s - 1) / (2 * s);  // pairs with o + s < b
    const dim3 grid(s / BN, s / BM, pairs);
    compose_level<1><<<grid, GEMM_THREADS, 0, stream>>>(U, Wu, scratch, b, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    compose_level<2><<<grid, GEMM_THREADS, 0, stream>>>(U, Wu, scratch, b, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// ---------------------------------------------------------------------------
// The batched kernel.  A panel's work is a list of tasks, each one block's
// share of one of the steps above:
//   F t         the tile step of tile t;
//   R t c       row-solve slice c of tile row t, or flagged (bit 8), the
//               four slices of a tile column from slice c (Wu_tt read once);
//   U t bi bj   trailing-update block (bi, bj) of step t, in 64 x 64 blocks
//               of the panel: the three upper blocks of each diagonal tile
//               (the tile chain waits on them), and flagged (bit 11), the
//               whole 128 x 128 tile (bi/2, bj/2) above the diagonal;
//   C q l z m n STEP q + 1 of composition level s = T << l, pair z, block
//               (m, n) in 64 x 64 blocks, or flagged (bit 11) 128 x 128.
// A task is 16 bits: the kind in the top two, its fields below.  Every
// task waits on counters of its panel that the tasks it reads from raise
// when they end.  The ints after the products' scratch hold the queue the
// blocks take tasks from, then each panel's counters.

static_assert(GEMM_SMEM <= TILE_SMEM && BIG_SMEM <= TILE_SMEM && RS_SMEM <= TILE_SMEM,
              "the tasks share the tile step's shared memory");
constexpr int MAX_TILES = 1024 / T, MAX_B64 = 1024 / BM, LEVELS = 3;
constexpr int C_TILE = 0;                                   // [t]: tile step done
constexpr int C_RS = C_TILE + MAX_TILES;                    // [t][j]: slices of U[t, j] solved
constexpr int C_UPD = C_RS + MAX_TILES * MAX_TILES;         // [bi][bj]: update steps applied
constexpr int C_STEP1 = C_UPD + MAX_B64 * MAX_B64;          // [l][z][m]: STEP 1 blocks of row m
constexpr int C_PAIR = C_STEP1 + LEVELS * 4 * (MAX_B64 / 2);  // [l][z]: STEP 2 blocks
constexpr int CTR_INTS = (C_PAIR + LEVELS * 4 + 3) / 4 * 4;   // a panel's counters
constexpr int QUEUE_INTS = 4;                                 // the queue, padded
constexpr int MAX_TASKS = 432;  // 421 at b = 1024 with 64 x 64 compositions
constexpr int MAX_NEEDS = 5;
// Blocks a panel's list is scheduled for at most: more would wait more
// than they work.
constexpr int MAX_WORKERS = 40;
// Blocks a panel up to which the composition runs in 128 x 128 blocks.
constexpr int BIG_COMPOSE_TO = 8;
// A wait longer than this (about 1 s; a call takes about 1 ms) can only be
// a fault in the plan: the kernel traps, and the call reports an error
// instead of holding the card.
constexpr long long WAIT_CYCLES = 1LL << 31;

enum Kind : unsigned { KF = 0, KR = 1, KU = 2, KC = 3 };

__host__ __device__ constexpr unsigned task_f(int t) { return KF << 14 | t; }
__host__ __device__ constexpr unsigned task_r(int t, int c) { return KR << 14 | c << 3 | t; }
constexpr unsigned R_TILE = 1u << 8;  // the four slices of a tile column from slice c
__host__ __device__ constexpr unsigned task_rt(int t, int j) { return R_TILE | task_r(t, (j - t - 1) * (T / RS_BN)); }
__host__ __device__ constexpr unsigned task_u(int t, int bi, int bj) { return KU << 14 | bj << 7 | bi << 3 | t; }
constexpr unsigned U_TILE = 1u << 11;  // a whole tile above the diagonal
__host__ __device__ constexpr unsigned task_ut(int t, int i, int j) { return U_TILE | task_u(t, 2 * i, 2 * j); }
__host__ __device__ constexpr unsigned task_c(int step, int l, int z, int m, int n) {
  return KC << 14 | n << 8 | m << 5 | z << 3 | l << 1 | step;
}
// composition blocks of 128 x 128 (flag) or 64 x 64: the larger run at a
// higher FMA rate, the smaller shorten the tail after the last tile when a
// panel has many blocks
constexpr unsigned C_BIG = 1u << 11;
__host__ __device__ constexpr int c_edge(unsigned task) { return task & C_BIG ? BIG : BM; }

__host__ __device__ inline int pairs_at(int b, int s) { return (b - s + 2 * s - 1) / (2 * s); }

// Float offset of level l's products in a panel's scratch: each level has
// its own region, so levels of the two halves may run at once.
__host__ __device__ inline size_t level_offset(int b, int l) {
  size_t off = 0;
  for (int i = 0; i < l; ++i) {
    const int s = T << i;
    off += (size_t)pairs_at(b, s) * s * s;
  }
  return off;
}

// The counter that tells the diagonal block Wu[a, a+s) (cut at b) is
// final: the tile step for one tile, else the pair of level s/2 that
// composes it; a block whose right half lies past b is its left half.
__host__ __device__ inline void node_need(int b, int a, int s, int e, int& ctr, unsigned& target) {
  while (s > T && a + s / 2 >= b) s /= 2;
  if (s == T) {
    ctr = C_TILE + a / T, target = 1;
    return;
  }
  const int h = s / 2, s2 = b - a - h < h ? b - a - h : h;
  int l = 0;
  while ((T << l) < h) ++l;
  ctr = C_PAIR + 4 * l + a / s, target = (unsigned)((h / e) * (s2 / e));
}

// The counters task `task` waits on, with the value each must reach.
__host__ __device__ inline int task_needs(unsigned task, int b, int* ctr, unsigned* target) {
  int n = 0;
  const unsigned kind = task >> 14;
  if (kind == KF) {
    const int t = task & 7, d = 2 * t;
    if (t > 0) {
      ctr[n] = C_UPD + MAX_B64 * d + d, target[n++] = t;
      ctr[n] = C_UPD + MAX_B64 * d + d + 1, target[n++] = t;
      ctr[n] = C_UPD + MAX_B64 * (d + 1) + d + 1, target[n++] = t;
    }
  } else if (kind == KR) {
    const int t = task & 7, c = task >> 3 & 31, bj = (t * T + T + c * RS_BN) / BN;
    ctr[n] = C_TILE + t, target[n++] = 1;
    if (t > 0 && (task & R_TILE)) {
      ctr[n] = C_UPD + MAX_B64 * 2 * t + bj, target[n++] = t;  // the tile's four blocks move together
    } else if (t > 0) {
      ctr[n] = C_UPD + MAX_B64 * 2 * t + bj, target[n++] = t;
      ctr[n] = C_UPD + MAX_B64 * (2 * t + 1) + bj, target[n++] = t;
    }
  } else if (kind == KU) {
    const int t = task & 7, bi = task >> 3 & 15, bj = task >> 7 & 15;
    ctr[n] = C_RS + MAX_TILES * t + bi / 2, target[n++] = T / RS_BN;
    if (bj / 2 != bi / 2) ctr[n] = C_RS + MAX_TILES * t + bj / 2, target[n++] = T / RS_BN;
    if (t > 0) ctr[n] = C_UPD + MAX_B64 * bi + bj, target[n++] = t;
  } else {
    const int step = task & 1, l = task >> 1 & 3, z = task >> 3 & 3, m = task >> 5 & 7, nn = task >> 8 & 7;
    const int s = T << l, o = 2 * s * z, s2 = b - o - s < s ? b - o - s : s, e = c_edge(task);
    if (step == 0) {
      node_need(b, o, s, e, ctr[n], target[n]);  // W11
      ++n;
      const int c = (o + s + nn * e) / T;  // U[o + k, o + s + bn...] for k from bm: final rows
      for (int r = (o + m * e) / T; r < (o + s) / T; ++r) ctr[n] = C_RS + MAX_TILES * r + c, target[n++] = T / RS_BN;
    } else {
      ctr[n] = C_STEP1 + 32 * l + 8 * z + m, target[n++] = s2 / e;  // the row of Pz
      // W22's rows above bn + e: the smallest block of the composition
      // that holds them, so the left columns start before the last tiles
      int q = T;
      while (q < nn * e + e) q *= 2;
      node_need(b, o + s, q, e, ctr[n], target[n]);
      ++n;
    }
  }
  return n;
}

// The counters task `task` raises when it ends (a tile update raises its
// four blocks').
__host__ __device__ inline int task_signals(unsigned task, int* ctr) {
  const unsigned kind = task >> 14;
  const int t = task & 7;
  if (kind == KF) return ctr[0] = C_TILE + t, 1;
  if (kind == KR) {
    ctr[0] = C_RS + MAX_TILES * t + (t * T + T + (int)(task >> 3 & 31) * RS_BN) / T;
    if (!(task & R_TILE)) return 1;
    ctr[1] = ctr[2] = ctr[3] = ctr[0];  // four slices
    return 4;
  }
  if (kind == KU) {
    const int bi = task >> 3 & 15, bj = task >> 7 & 15;
    if (!(task & U_TILE)) return ctr[0] = C_UPD + MAX_B64 * bi + bj, 1;
    for (int q = 0; q < 4; ++q) ctr[q] = C_UPD + MAX_B64 * (bi + q / 2) + bj + q % 2;
    return 4;
  }
  const int l = task >> 1 & 3, z = task >> 3 & 3;
  return ctr[0] = (task & 1) == 0 ? C_STEP1 + 32 * l + 8 * z + (task >> 5 & 7) : C_PAIR + 4 * l + z, 1;
}

struct BatchedPlan {
  int ntasks;
  unsigned short task[MAX_TASKS];
};

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<float*>(smem4);
}

// The tasks' bodies, one function each (not inlined into the dispatch, so
// each gets its own register allocation); each takes the dynamic shared
// memory itself.
__device__ __noinline__ void run_tile(const float* src, float* U, float* Wu, int b, int t0) {
  float* smem = dynamic_smem();
  tile_step<true>(src, U, Wu, b, t0, smem);
}
__device__ __noinline__ void run_row_solve(const float* src, float* U, const float* Wu, int b, int t0, int slice) {
  float* smem = dynamic_smem();
  row_solve_slice<true, true>(src, U, Wu, b, t0, slice, smem);
}
// The four slices of one tile column, Wu_tt loaded once.
__device__ __noinline__ void run_row_solve_tile(const float* src, float* U, const float* Wu, int b, int t0,
                                                int slice) {
  float* smem = dynamic_smem();
  row_solve_slice<true, true>(src, U, Wu, b, t0, slice, smem);
  for (int q = 1; q < T / RS_BN; ++q) {
    __syncthreads();  // every thread is done with the slice before
    row_solve_slice<false, true>(src, U, Wu, b, t0, slice + q, smem);
  }
}
__device__ __noinline__ void run_update(const float* src, float* U, int b, int t0, int bm, int bn) {
  float* smem = dynamic_smem();
  trailing_block<true>(src, U, b, t0, bm, bn, smem);
}
// The update of a whole tile above the diagonal: trailing_block's four
// blocks (bm, bn offsets from t0 + T, multiples of 128).
__device__ __noinline__ void run_update_tile(const float* src, float* U, int b, int t0, int bm, int bn) {
  float* smem = dynamic_smem();
  const float* row = U + (size_t)t0 * b + t0 + T;
  float acc[8][8] = {};
  gemm_big<true>(acc, row, b, row, b, bm, bn, 0, T, 0, T, smem);
  const size_t at = (size_t)(t0 + T) * b + t0 + T;
  store_big(U + at, src + at, b, bm, bn, acc, -1.0f, 1.0f);
}
__device__ __noinline__ void run_compose_block(const float* U, float* Wu, float* Pz, int b, int s, int o, int bm,
                                               int bn, int step) {
  float* smem = dynamic_smem();
  if (step == 0) {
    compose_block<1, true>(U, Wu, Pz, b, s, o, bm, bn, smem);
  } else {
    compose_block<2, true>(U, Wu, Pz, b, s, o, bm, bn, smem);
  }
}
// compose_block's four blocks of a 128 x 128 block (bm, bn multiples of
// 128), each with its own K range.
__device__ __noinline__ void run_compose(const float* U, float* Wu, float* Pz, int b, int s, int o, int bm, int bn,
                                         int step) {
  float* smem = dynamic_smem();
  float acc[8][8] = {};
  if (step == 0) {
    gemm_big<false>(acc, Wu + (size_t)o * b + o, b, U + (size_t)o * b + o + s, b, bm, bn, bm, s, bm + BM, s, smem);
    store_big(Pz, Pz, s, bm, bn, acc, 1.0f, 0.0f);
  } else {
    gemm_big<false>(acc, Pz, s, Wu + (size_t)(o + s) * b + o + s, b, bm, bn, 0, bn + BIG, 0, bn + BN, smem);
    float* C = Wu + (size_t)o * b + o + s;
    store_big(C, C, b, bm, bn, acc, -1.0f, 0.0f);
    for (int e = threadIdx.x; e < BIG * BIG / 4; e += GEMM_THREADS) {
      const int r = e / (BIG / 4), k = 4 * (e % (BIG / 4));
      *reinterpret_cast<float4*>(Wu + (size_t)(o + s + bn + r) * b + o + bm + k) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// One persistent grid of one block an SM, launched cooperatively, so every
// block is resident and none can wait on a block that never starts.  The
// blocks take tasks of all panels from one queue: global task k is task
// k / W of panel k % W's list, so the panels' lists are interleaved.  For
// each task thread 0 waits with acquire loads until the counters of its
// inputs reach their targets, the block runs it, and thread 0 raises its
// counters (a fence, then atomic adds).  Each list is in a topological
// order, so the earliest unfinished task can always run.  The caller
// zeroes the queue and counters.
__global__ void __launch_bounds__(TILE_THREADS, 1)
panel_cholinv_tasks(const float* __restrict__ A, float* U, float* Wu, float* scratch, int b, int batch,
                    const __grid_constant__ BatchedPlan plan) {
  __shared__ int next;
  const size_t bb = (size_t)b * b;
  unsigned* queue = reinterpret_cast<unsigned*>(scratch + batch * bb);
  const int tid = threadIdx.x;
  const int total = plan.ntasks * batch;
  for (;;) {
    if (tid == 0) next = atomicAdd(queue, 1u);
    __syncthreads();
    const int k = next;
    if (k >= total) break;
    const int panel = k % batch;
    const unsigned task = plan.task[k / batch];
    unsigned* ctr = queue + QUEUE_INTS + (size_t)panel * CTR_INTS;
    if (tid == 0) {
      int c[MAX_NEEDS];
      unsigned target[MAX_NEEDS];
      const int n = task_needs(task, b, c, target);
      const long long start = clock64();
      for (int i = 0; i < n; ++i) {
        for (unsigned sleep = 32; load_acquire(ctr + c[i]) < target[i]; sleep = sleep < 256 ? 2 * sleep : sleep) {
          __nanosleep(sleep);
          if (clock64() - start > WAIT_CYCLES) __trap();  // a fault, not a hang
        }
      }
    }
    __syncthreads();
    const float* Ap = A + panel * bb;
    float* Up = U + panel * bb;
    float* Wp = Wu + panel * bb;
    const int t = task & 7, t0 = t * T;
    const float* src = t == 0 ? Ap : Up;  // step 0 reads A: no copy of the panel
    switch (task >> 14) {
      case KF:
        run_tile(src, Up, Wp, b, t0);
        break;
      case KR:
        if (task & R_TILE) {
          run_row_solve_tile(src, Up, Wp, b, t0, task >> 3 & 31);
        } else {
          run_row_solve(src, Up, Wp, b, t0, task >> 3 & 31);
        }
        break;
      case KU: {
        const int bm = (int)(task >> 3 & 15) * BM - t0 - T, bn = (int)(task >> 7 & 15) * BN - t0 - T;
        if (task & U_TILE) {
          run_update_tile(src, Up, b, t0, bm, bn);
        } else {
          run_update(src, Up, b, t0, bm, bn);
        }
        break;
      }
      default: {
        const int l = task >> 1 & 3, z = task >> 3 & 3, s = T << l;
        float* Pz = scratch + panel * bb + level_offset(b, l) + (size_t)z * s * s;
        const int e = c_edge(task);
        if (task & C_BIG) {
          run_compose(Up, Wp, Pz, b, s, 2 * s * z, (task >> 5 & 7) * e, (task >> 8 & 7) * e, task & 1);
        } else {
          run_compose_block(Up, Wp, Pz, b, s, 2 * s * z, (task >> 5 & 7) * e, (task >> 8 & 7) * e, task & 1);
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      int c[4];
      const int n = task_signals(task, c);
      __threadfence();
      for (int i = 0; i < n; ++i) atomicAdd(ctr + c[i], 1u);
    }
  }
}

// ---------------------------------------------------------------------------
// The plan: a panel's task list in the order of a list schedule of the
// blocks that share the panel (the grid's blocks over W), each task
// started, as soon as a block is free, among those whose inputs are final,
// by its longest path to the end (task times measured on an H100 at 700 W,
// in microseconds).  The tile chain is the longest path, so the schedule
// takes the next tile's inputs first (look-ahead) and fills the other
// blocks with updates and compositions.

struct Plan {
  BatchedPlan list;
  int workers;      // the blocks the schedule gave the panel
  double makespan;  // the schedule's estimate, microseconds
};

double task_us(unsigned task) {
  const unsigned kind = task >> 14;
  if (kind == KF) return 40.0;
  if (kind == KR) return task & R_TILE ? 14.0 : 7.0;
  if (kind == KU) return task & U_TILE ? 20.0 : 6.5;
  const int s = T << (task >> 1 & 3), m = task >> 5 & 7, n = task >> 8 & 7;
  const int e = c_edge(task), depth = (task & 1) == 0 ? s - m * e : n * e + e;  // the product's K
  return e == BIG ? 2.0 + 0.11 * depth : 2.0 + 0.043 * depth;
}

std::vector<unsigned> natural_tasks(int b, bool big_compose) {
  std::vector<unsigned> tasks;
  const int tiles = b / T;
  for (int t = 0; t < tiles; ++t) {
    tasks.push_back(task_f(t));
    // the tile chain's column in slices, the others whole
    if (t + 1 < tiles)
      for (int c = 0; c < T / RS_BN; ++c) tasks.push_back(task_r(t, c));
    for (int j = t + 2; j < tiles; ++j) tasks.push_back(task_rt(t, j));
    for (int i = t + 1; i < tiles; ++i) {
      tasks.push_back(task_u(t, 2 * i, 2 * i));
      tasks.push_back(task_u(t, 2 * i, 2 * i + 1));
      tasks.push_back(task_u(t, 2 * i + 1, 2 * i + 1));
    }
    for (int i = t + 1; i < tiles; ++i)
      for (int j = i + 1; j < tiles; ++j) tasks.push_back(task_ut(t, i, j));
  }
  const unsigned flag = big_compose ? C_BIG : 0;
  const int e = big_compose ? BIG : BM;
  for (int l = 0; (T << l) < b; ++l) {
    const int s = T << l;
    for (int z = 0; z < pairs_at(b, s); ++z) {
      const int o = 2 * s * z, s2 = b - o - s < s ? b - o - s : s;
      for (int step = 0; step < 2; ++step)
        for (int m = 0; m < s / e; ++m)
          for (int n = 0; n < s2 / e; ++n) tasks.push_back(flag | task_c(step, l, z, m, n));
    }
  }
  return tasks;
}

Plan make_plan(int b, int workers) {
  const std::vector<unsigned> tasks = natural_tasks(b, workers <= BIG_COMPOSE_TO);
  const int n = (int)tasks.size();
  // producers of each counter, in list order (an update counter's t-th
  // producer is step t's)
  std::vector<std::vector<int>> producers(CTR_INTS);
  for (int i = 0; i < n; ++i) {
    int c[4];
    for (int q = task_signals(tasks[i], c); q-- > 0;) producers[c[q]].push_back(i);
  }
  std::vector<std::vector<int>> preds(n), succs(n);
  for (int i = 0; i < n; ++i) {
    int c[MAX_NEEDS];
    unsigned target[MAX_NEEDS];
    const int needs = task_needs(tasks[i], b, c, target);
    for (int q = 0; q < needs; ++q) {
      const std::vector<int>& from = producers[c[q]];
      if (c[q] >= C_UPD && c[q] < C_STEP1) {
        preds[i].push_back(from[target[q] - 1]);
      } else {
        preds[i].insert(preds[i].end(), from.begin(), from.end());
      }
    }
    for (int p : preds[i]) succs[p].push_back(i);
  }
  std::vector<double> dur(n), rank(n, 0.0), finish(n, -1.0);
  for (int i = n - 1; i >= 0; --i) {  // the natural order is topological
    dur[i] = task_us(tasks[i]);
    double tail = 0.0;
    for (int q : succs[i]) tail = std::max(tail, rank[q]);
    rank[i] = dur[i] + tail;
  }
  Plan plan{};
  std::vector<double> free_at(workers, 0.0);
  std::vector<bool> started(n, false);
  for (int placed = 0; placed < n;) {
    const int w = (int)(std::min_element(free_at.begin(), free_at.end()) - free_at.begin());
    const double now = free_at[w];
    int best = -1;
    double next_end = 1e300;
    for (int i = 0; i < n; ++i) {
      if (started[i]) {
        if (finish[i] > now) next_end = std::min(next_end, finish[i]);
        continue;
      }
      bool ready = true;
      for (int p : preds[i]) ready = ready && started[p] && finish[p] <= now;
      if (ready && (best < 0 || rank[i] > rank[best])) best = i;
    }
    if (best < 0) {
      free_at[w] = next_end;  // nothing ready: this block idles until the next task ends
      continue;
    }
    started[best] = true;
    finish[best] = now + dur[best];
    free_at[w] = finish[best];
    plan.list.task[placed++] = (unsigned short)tasks[best];
    plan.makespan = std::max(plan.makespan, finish[best]);
  }
  plan.list.ntasks = n;
  plan.workers = workers;
  return plan;
}

std::mutex plan_lock;
std::map<std::pair<int, int>, Plan> plans;  // (b, blocks a panel) -> plan
std::map<int, int> grid_blocks;            // device -> blocks resident at once

// The grid (every block the card holds at once, one an SM, at most the
// tasks of the call) and the plan for a (batch, b, b) call.
int plan_for(int b, int batch, int* blocks, const Plan** plan) {
  cudaError_t err = cudaFuncSetAttribute(panel_cholinv_tasks, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TILE_SMEM);
  if (err != cudaSuccess) return (int)err;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> guard(plan_lock);
  auto it = grid_blocks.find(device);
  if (it == grid_blocks.end()) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, panel_cholinv_tasks, TILE_THREADS, TILE_SMEM);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    it = grid_blocks.emplace(device, sms * per_sm).first;
  }
  const int tasks = (int)natural_tasks(b, false).size();  // the longer of the two lists
  if (tasks > MAX_TASKS) return (int)cudaErrorInvalidValue;
  *blocks = (int)std::min<long long>(it->second, (long long)tasks * batch);
  const int workers = std::max(1, std::min(MAX_WORKERS, (*blocks + batch / 2) / batch));
  auto p = plans.find({b, workers});
  if (p == plans.end()) p = plans.emplace(std::make_pair(b, workers), make_plan(b, workers)).first;
  *plan = &p->second;
  return (int)cudaSuccess;
}

size_t batched_scratch_floats(int b, int batch) {
  return (size_t)batch * b * b + QUEUE_INTS + (size_t)batch * CTR_INTS;
}

int panel_cholinv_batched_launch(const float* A, float* U, float* Wu, float* scratch, int b, int batch,
                                 cudaStream_t stream) {
  if (b <= 0 || b % T != 0 || b > 1024 || batch <= 0 || batch > (1 << 20)) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const Plan* plan = nullptr;
  int err = plan_for(b, batch, &blocks, &plan);
  if (err != cudaSuccess) return err;
  float* queue = scratch + (size_t)batch * b * b;
  err = (int)cudaMemsetAsync(queue, 0, (QUEUE_INTS + (size_t)batch * CTR_INTS) * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(TILE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = TILE_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, panel_cholinv_tasks, A, U, Wu, scratch, b, batch, plan->list);
}

}  // namespace

extern "C" {

// A, U, Wu: (b, b) row-major f32; scratch: b * b floats.  All on `stream`.
int panel_cholinv_f32(const float* A, float* U, float* Wu, float* scratch, int b, void* stream_ptr) {
  return panel_cholinv_launches(A, U, Wu, scratch, b, (cudaStream_t)stream_ptr);
}

// Floats of scratch the batched entry takes for (batch, b, b): the
// composition's products, the queue and the panels' counters.
long long panel_cholinv_batched_scratch(int b, int batch) {
  return (long long)batched_scratch_floats(b, batch);
}

// A, U, Wu: (batch, b, b) row-major f32, panels contiguous; scratch:
// panel_cholinv_batched_scratch(b, batch) floats.  A memset of the queue
// and counters, then one launch.  Each panel is factored as
// panel_cholinv_f32 factors it: the same operations in the same order, so
// each slice equals that call's output, and a non-SPD panel gives NaN in
// its own slice only.
int panel_cholinv_batched_f32(const float* A, float* U, float* Wu, float* scratch, int b, int batch,
                              void* stream_ptr) {
  return panel_cholinv_batched_launch(A, U, Wu, scratch, b, batch, (cudaStream_t)stream_ptr);
}

// What a batched call of (batch, b, b) on the current device launches: the
// grid's blocks, the blocks a panel's list was scheduled for, the tasks of
// a panel and the schedule's estimate of one panel, in microseconds.
int panel_cholinv_batched_plan(int b, int batch, int* blocks, int* workers, int* tasks, double* estimate_us) {
  if (b <= 0 || b % T != 0 || b > 1024 || batch <= 0) return (int)cudaErrorInvalidValue;
  const Plan* plan = nullptr;
  const int err = plan_for(b, batch, blocks, &plan);
  if (err != cudaSuccess) return err;
  *workers = plan->workers;
  *tasks = plan->list.ntasks;
  *estimate_us = plan->makespan;
  return (int)cudaSuccess;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
