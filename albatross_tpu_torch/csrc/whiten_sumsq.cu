// A marginal prediction's explained variance, diag(k^T K^-1 k) =
// ||L^-1 k_j||^2 for every column k_j of the cross covariance, by a blocked
// forward substitution on the tensor cores in 3xTF32.
//
// Replaces no TPU kernel: the JAX package forms K^-1 k by two triangular
// solves that XLA runs (albatross_tpu/models/gp.py, the marginal
// prediction), then sums (K^-1 k) * k.  Here those were two cuBLAS trsm,
// which at 4096 right-hand sides run mostly as FP32 GEMMs on the SIMT
// cores.  The variance needs only the column sums of squares of L^-1 k, one
// forward substitution, and no solution has to exist as a whole.
//
// The workspace C is a copy of the cross covariance, (n, Mp) row-major with
// Mp a multiple of 128 (zero columns pad the M columns; their sums are 0).
// With b the panel size, P = n / b, D_k the diagonal blocks L_kk of the
// factor L with zeros above their diagonals and W_k = L_kk^-1 (both given,
// (P, b, b)), for k = 0..P-1, with C_k = C[k b:(k + 1) b]:
//     whiten:    X0^T = C_k^T W_k^T                         (Mp, b), into x
//     residual:  C_k -= D_k X0
//     refine:    X^T = X0^T + C_k^T W_k^T, into x
//                part[ct][j] += sum over the tile's columns of (X^T[j, .])^2
//     update:    C[(k + 1) b:] -= L[(k + 1) b:, k b:(k + 1) b] X   (k < P - 1)
// so that after panel k the rows (k + 1) b.. of C hold what is left to
// substitute, and the sums of squares of every X_k = (L^-1 k)[k b:(k + 1) b]
// sit in part, (b / 128, Mp); the caller adds its b / 128 rows.  A product
// with an explicit inverse is accurate to u |W_k| |C_k|, not to the
// substitution's u |L_kk| |X|: the one step of refinement by the residual
// brings X back to the substitution's accuracy (on the CPU, the blocked
// loop in 3xTF32 from 9.2e-7 of a sum of squares to 1.3e-7 at n = 8192,
// where an f32 solve reads 1.9e-7).  The update's and the residual's
// operands are K-major: L's rows, read in place with their row stride n,
// or D_k's, and the rows of X^T; it is the blocked Cholesky's
// trailing-update product (csrc/trailing_update.cu) at other strides.  The
// whiten's W_k is K-major and its C panel is read across its rows, so the
// loaders transpose it on its way to shared memory, as the trailing
// backward does: a warp's loads read 128 contiguous bytes of a row, each
// thread keeps 4 consecutive rows of one column and writes them as one
// 16-byte chunk.
//
// Arithmetic: 3xTF32, as csrc/trailing_update.cu's header sets out.  Each
// f32 operand is split into hi = x rounded to TF32 and lo = (x - hi)
// rounded to TF32; each step of 8 along the contraction sums lo.hi + hi.lo
// + hi.hi by wgmma m64n128k8 .tf32 into the accumulators, and these are
// added to the tile's sums by round-to-nearest f32 adds, which bounds the
// tensor cores' truncating sums.  The error that stays is one-sided: each
// product into the accumulators rounds its f32 result toward zero, by up
// to an ulp of the accumulator.  So the small products (lo.hi, hi.lo) come
// first, while the accumulators are small, and the hi.hi last, and the
// tile's sums take every step of 8 from accumulators started at zero (at
// n = 28672, Mp = 4096 on an H100: 3.0e-7 of the largest sum of squares
// from the f64 substitution, where cuBLAS's f32 solve reads 2.1e-7; sums
// taken every chunk of 32 read 7.0e-7 at 90% of the time).
// W_k and D_k are lower triangular, so the whiten tile of columns ct
// contracts over the first (ct + 1) 128 only, and the residual tile of
// rows rt over the first (rt + 1) 128.
//
// What bounds it on an H100: operations.  The updates are b^2 Mp P (P - 1)
// floating-point operations and the whiten, residual and refinement
// products b (b + 128) Mp P each (a lower triangle by whole tiles), each
// run as three tensor-core products, so the bound is the operations over
// 494.7 / 3 = 164.9 TFLOP/s; the bytes (L's lower half read once, C read
// and written once a panel) come to about a fifth of that time at
// n = 28672, Mp = 4096.  What the design does about it:
// * One persistent launch a product: one 512-thread block an SM walks the
//   launch's 128 x 128 output tiles in a static order (tile t, t + grid,
//   ...), the column tiles of one row tile next to each other, so the
//   blocks in flight share their rows of L in L2; X^T (Mp x b) stays in L2.
//   The C entry issues the 4 P - 1 launches on the caller's stream.
// * Warp specialisation as in csrc/trailing_update.cu: two loader
//   warpgroups read each 128 x 32 chunk of both operands from global memory
//   (one chunk ahead, in registers), split it into TF32 hi and lo and write
//   both K-major in 128-byte swizzled rows into a ring of STAGES slots,
//   handed over by mbarriers; two consumer warpgroups contract the slots
//   (64 rows each) and promote the partial sums.  setmaxnreg gives the
//   loaders 96 registers a thread and the consumers 160.
// * The epilogues work from the sums' registers: the update and the
//   residual read their C tile, subtract and store; the whiten stores its
//   X^T tile (the refinement adds it to the stored one) and the refinement
//   adds each row's sum of squares, reduced over the four threads of a row
//   by shuffles, into part.  Each entry of part belongs to one tile of a
//   launch and the launches run in order: no atomics, and the result is
//   the same bits in every run.
// n, b and Mp are multiples of 128 and b divides n; the C entry refuses
// anything else.  chip_smoke.py times it beside this bound, the plain
// one-solve form and the two cuBLAS trsm (PERF.md section 6).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;                      // output tile edge
constexpr int KC = 32;                         // contraction a chunk: one 128-byte operand row
constexpr int LOADERS = 256;                   // warpgroups 0 and 1: global -> split -> ring
constexpr int CONSUMERS = 256;                 // warpgroups 2 and 3: wgmma, the sums and the epilogue
constexpr int THREADS = LOADERS + CONSUMERS;
constexpr int LOADER_REGS = 96;                // registers a loader thread keeps (setmaxnreg)
constexpr int CONSUMER_REGS = 160;             // and a consumer thread: the partial and the whole sums
constexpr int STAGES = 3;                      // slots of the operand ring
constexpr int OPERAND_BYTES = TILE * KC * 4;   // one 128 x 32 TF32 operand in 128-byte swizzled rows
constexpr int SLOT_BYTES = 4 * OPERAND_BYTES;  // A hi, A lo, B hi, B lo
constexpr int SMEM_BYTES = 1024 + STAGES * SLOT_BYTES + 2 * STAGES * 8;
constexpr long long WAIT_CYCLES = 1ll << 32;   // a wait this long is a fault: trap, never hang

// One launch: D = A B^T, A (row_tiles 128, depth) and B (col_tiles 128,
// depth), B K-major with row stride ldb.  Whiten: A transposed (its row m
// is column m of the tensor at a.a, row stride lda), out = D, or out += D
// when accumulate, and with part given part[ct mp + row] += the row's sum
// of out^2 over the tile's columns; the tile of column tiles ct contracts
// over (ct + 1) 128 (B lower triangular).  Update: A K-major with row
// stride lda, out -= D; with lower, the tile of row tiles rt contracts over
// (rt + 1) 128 (A lower triangular).
struct Args {
  const float* a;
  const float* b;
  float* out;
  float* part;
  int64_t lda, ldb, ldo, mp;
  int row_tiles, col_tiles, depth, accumulate, lower;
};

// -- PTX primitives -----------------------------------------------------------
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

// Shared-memory writes by threads made visible to the asynchronous proxy
// (the wgmma operands).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// wgmma descriptor of a K-major operand in 128-byte swizzled rows (8-row
// atoms of 1024 bytes; 16-byte chunk q of row r at chunk q ^ (r % 8)).
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

template <int N>
__device__ __forceinline__ void regs_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N)); }
template <int N>
__device__ __forceinline__ void regs_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N)); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keeps the compiler from moving the accumulators across the asynchronous products.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b^T over 8 of the contraction: a 64 x 8 block of A, b 128 x 8
// of B, TF32 from the descriptors; d = a b^T when accumulate is 0.
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
// -- end of the PTX primitives ------------------------------------------------

// v rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero: cvt.rna.tf32.f32's result for finite v, in two integer
// operations.
__device__ __forceinline__ uint32_t tf32_rna(float v) { return (__float_as_uint(v) + 0x1000u) & 0xffffe000u; }

// The output tile of item t: the column tiles of one row tile next to each other.
struct Tile {
  int rt, ct;
};

__device__ __forceinline__ Tile tile_of(const Args& a, long long t) {
  return Tile{(int)(t / a.col_tiles), (int)(t % a.col_tiles)};
}

template <bool WHITEN>
__device__ __forceinline__ int tile_chunks(const Args& a, const Tile& f) {
  return WHITEN ? (f.ct + 1) * (TILE / KC) : a.lower ? (f.rt + 1) * (TILE / KC) : a.depth / KC;
}

// A loader thread's share of one 128 x 32 operand chunk at p: four groups
// of four consecutive contraction entries of one operand row.  K-major (tr
// false): group g is row 32 g + 4 w + s (w the loader warp, s = lane / 8),
// entries 4 (lane % 8).., one 16-byte load.  Transposed (tr true): group g
// is row 32 g + lane (a column of the tensor), entries 4 w.., four 4-byte
// loads, each of which reads 128 contiguous bytes of a row a warp.  Either
// way the eight lanes of each phase of a 16-byte shared store meet eight
// distinct chunks of the swizzle.
constexpr int GROUPS = 4;
static_assert(LOADERS == 256, "the loaders' layout takes eight warps");
struct Part {
  float4 v[GROUPS];
};

template <bool TR>
__device__ __forceinline__ void load_part(const float* p, int64_t ld, int lw, int lane, Part& out) {
  if (!TR) {
    const int sub = lane >> 3, quad = lane & 7;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
      out.v[g] = __ldg(reinterpret_cast<const float4*>(p + (int64_t)(32 * g + 4 * lw + sub) * ld + 4 * quad));
  } else {
    const float* q = p + (int64_t)(4 * lw) * ld + lane;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      out.v[g].x = __ldg(q + 32 * g);
      out.v[g].y = __ldg(q + ld + 32 * g);
      out.v[g].z = __ldg(q + 2 * ld + 32 * g);
      out.v[g].w = __ldg(q + 3 * ld + 32 * g);
    }
  }
}

// The part split into TF32 hi and lo, each group written as 16-byte chunk
// `chunk` of operand row r (at chunk ^ (r % 8)) of the hi operand and of
// the lo operand OPERAND_BYTES after it.
template <bool TR>
__device__ __forceinline__ void store_part(const Part& part, int lw, int lane, unsigned char* hi) {
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int r = TR ? 32 * g + lane : 32 * g + 4 * lw + (lane >> 3);
    const int chunk = TR ? lw : lane & 7;
    const float e[4] = {part.v[g].x, part.v[g].y, part.v[g].z, part.v[g].w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = tf32_rna(e[k]);
      l[k] = tf32_rna(__fsub_rn(e[k], __uint_as_float(h[k])));
    }
    const int at = r * 128 + ((chunk ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(hi + OPERAND_BYTES + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The loaders' walk over their items' chunks, in the consumers' order:
// item t's chunk c reads operand rows 128 rt.. of A and 128 ct.. of B at
// contraction entries KC c..; the whiten's A, transposed, from the
// tensor's rows KC c.. and columns 128 rt...
template <bool WHITEN>
__device__ __forceinline__ void loader(const Args& a, unsigned char* ring, uint64_t* full, uint64_t* empty) {
  const int lw = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long total = (long long)a.row_tiles * a.col_tiles;
  long long t = blockIdx.x;
  if (t >= total) return;
  Tile f = tile_of(a, t);
  int chunks = tile_chunks<WHITEN>(a, f), c = 0;
  const int64_t astep = WHITEN ? KC * a.lda : KC;
  const float* pa = a.a + (int64_t)TILE * f.rt * (WHITEN ? 1 : a.lda);
  const float* pb = a.b + (int64_t)TILE * f.ct * a.ldb;
  Part va, vb;
  load_part<WHITEN>(pa, a.lda, lw, lane, va);
  load_part<false>(pb, a.ldb, lw, lane, vb);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    bool live = true;
    if (++c < chunks) {
      pa += astep;
      pb += KC;
    } else {
      c = 0;
      t += gridDim.x;
      live = t < total;
      if (live) {
        f = tile_of(a, t);
        chunks = tile_chunks<WHITEN>(a, f);
        pa = a.a + (int64_t)TILE * f.rt * (WHITEN ? 1 : a.lda);
        pb = a.b + (int64_t)TILE * f.ct * a.ldb;
      }
    }
    Part na, nb;
    if (live) {  // the next chunk's loads, in flight while this one is split and written
      load_part<WHITEN>(pa, a.lda, lw, lane, na);
      load_part<false>(pb, a.ldb, lw, lane, nb);
    }
    mbar_wait(&empty[stage], phase ^ 1);
    unsigned char* slot = ring + stage * SLOT_BYTES;
    store_part<WHITEN>(va, lw, lane, slot);
    store_part<false>(vb, lw, lane, slot + 2 * OPERAND_BYTES);
    fence_proxy_async();
    mbar_arrive(&full[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    if (!live) return;
    va = na;
    vb = nb;
  }
}

template <bool WHITEN>
__device__ __forceinline__ void consumer(const Args& a, unsigned char* ring, uint64_t* full, uint64_t* empty) {
  const int cid = threadIdx.x - LOADERS, cw = cid >> 7, warp = cid >> 5, lane = cid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rbase = 64 * cw + 16 * (warp & 3) + g;  // rows rbase, rbase + 8; columns 8 j + 2 tq, + 1
  const long long total = (long long)a.row_tiles * a.col_tiles;
  const int64_t ldo = a.ldo;
  int stage = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile f = tile_of(a, t);
    const int chunks = tile_chunks<WHITEN>(a, f);
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&full[stage], phase);
      __syncwarp();
      const uint32_t slot = smem_u32(ring + stage * SLOT_BYTES);
      const uint64_t ah = operand_desc(slot + cw * 64 * 128), al = operand_desc(slot + OPERAND_BYTES + cw * 64 * 128);
      const uint64_t bh = operand_desc(slot + 2 * OPERAND_BYTES), bl = operand_desc(slot + 3 * OPERAND_BYTES);
      // each step of 8 entries (32 bytes, 2 descriptor units): its small
      // products first, its hi.hi last, then its sum joins the tile's by
      // round-to-nearest f32 adds (see the header)
#pragma unroll
      for (int k = 0; k < KC / 8; ++k) {
        fence_operands(acc);
        wgmma_fence();
        wgmma_tf32(acc, al + 2 * k, bh + 2 * k, 0);
        wgmma_tf32(acc, ah + 2 * k, bl + 2 * k, 1);
        wgmma_tf32(acc, ah + 2 * k, bh + 2 * k, 1);
        wgmma_commit();
        wgmma_wait();
        fence_operands(acc);
        if (k == KC / 8 - 1) mbar_arrive(&empty[stage]);  // the chunk's products are complete: its slot is free
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    float* o = a.out + ((int64_t)TILE * f.rt + rbase) * ldo + (int64_t)TILE * f.ct + 2 * tq;
    if (WHITEN) {
      if (a.accumulate) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 c0 = *reinterpret_cast<const float2*>(o + 8 * j);
          const float2 c1 = *reinterpret_cast<const float2*>(o + 8 * ldo + 8 * j);
          sum[4 * j] = __fadd_rn(c0.x, sum[4 * j]);
          sum[4 * j + 1] = __fadd_rn(c0.y, sum[4 * j + 1]);
          sum[4 * j + 2] = __fadd_rn(c1.x, sum[4 * j + 2]);
          sum[4 * j + 3] = __fadd_rn(c1.y, sum[4 * j + 3]);
        }
      }
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(sum[4 * j], sum[4 * j + 1]);
        *reinterpret_cast<float2*>(o + 8 * ldo + 8 * j) = make_float2(sum[4 * j + 2], sum[4 * j + 3]);
        s0 = __fmaf_rn(sum[4 * j], sum[4 * j], s0);
        s0 = __fmaf_rn(sum[4 * j + 1], sum[4 * j + 1], s0);
        s1 = __fmaf_rn(sum[4 * j + 2], sum[4 * j + 2], s1);
        s1 = __fmaf_rn(sum[4 * j + 3], sum[4 * j + 3], s1);
      }
      if (a.part != nullptr) {
        // the row's four threads (tq = 0..3) hold its 128 columns
        s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, 1));
        s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, 1));
        s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, 2));
        s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, 2));
        if (tq == 0) {
          float* p = a.part + (int64_t)f.ct * a.mp + (int64_t)TILE * f.rt + rbase;
          p[0] = __fadd_rn(p[0], s0);
          p[8] = __fadd_rn(p[8], s1);
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // eight column blocks at a time: their loads in flight together
        float2 c0[8], c1[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c0[j] = *reinterpret_cast<const float2*>(o + 8 * (8 * h + j));
          c1[j] = *reinterpret_cast<const float2*>(o + 8 * ldo + 8 * (8 * h + j));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = 4 * (8 * h + j);
          *reinterpret_cast<float2*>(o + 8 * (8 * h + j)) =
              make_float2(__fsub_rn(c0[j].x, sum[q]), __fsub_rn(c0[j].y, sum[q + 1]));
          *reinterpret_cast<float2*>(o + 8 * ldo + 8 * (8 * h + j)) =
              make_float2(__fsub_rn(c1[j].x, sum[q + 2]), __fsub_rn(c1[j].y, sum[q + 3]));
        }
      }
    }
  }
}

// One block an SM: two loader warpgroups feeding two consumer warpgroups
// through a ring of STAGES operand slots (mbarriers: `full` when the
// loaders have written a slot, `empty` when the consumers have read it).
template <bool WHITEN>
__global__ void __launch_bounds__(THREADS, 1) whiten_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  // the ring 1024-byte aligned (the swizzle's atoms), by offsetting the shared pointer itself so the compiler
  // keeps every access below in the shared space
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * SLOT_BYTES);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], LOADERS);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < LOADERS) {
    regs_dec<LOADER_REGS>();
    loader<WHITEN>(a, ring, full, empty);
  } else {
    regs_inc<CONSUMER_REGS>();
    consumer<WHITEN>(a, ring, full, empty);
  }
}

// Once per process for each form and device: the shared-memory opt-in and
// the grid (one block an SM).
constexpr int MAX_DEVICES = 64;

template <bool WHITEN>
int grid_for(int& blocks) {
  static int cached[MAX_DEVICES];
  int device = 0;
  int code = (int)cudaGetDevice(&device);
  if (code != 0) return code;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    int sms = 0;
    code = (int)cudaFuncSetAttribute(whiten_kernel<WHITEN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     SMEM_BYTES);
    if (code == 0) code = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (code != 0) return code;
    cached[device] = sms;
  }
  blocks = cached[device];
  return 0;
}

template <bool WHITEN>
int launch(const Args& a, cudaStream_t stream) {
  int blocks = 0;
  const int code = grid_for<WHITEN>(blocks);
  if (code != 0) return code;
  const long long tiles = (long long)a.row_tiles * a.col_tiles;
  if (tiles < blocks) blocks = (int)tiles;
  whiten_kernel<WHITEN><<<blocks, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// L (n, n) row-major f32, read below its diagonal blocks; D (P, b, b) L's
// diagonal blocks with zeros above their diagonals and W (P, b, b) their
// inverses, P = n / b; c (n, mp) row-major, the cross covariance,
// overwritten; x (mp, b) scratch; part (b / 128, mp), zeros on entry: on
// return part summed over its rows is ||L^-1 c[:, j]||^2 for every column
// j of c.  n, b and mp multiples of 128, b dividing n.  4 P - 1 launches on
// `stream`, their count in *launches.
int whiten_sumsq_f32(const float* L, const float* D, const float* W, float* c, float* x, float* part, long long n,
                     long long mp, int b, void* stream_ptr, int* launches) {
  *launches = 0;
  if (b <= 0 || b % TILE != 0 || n <= 0 || n % b != 0 || mp <= 0 || mp % TILE != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(L) || !aligned16(D) || !aligned16(W) || !aligned16(c) || !aligned16(x) || !aligned16(part))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long panels = n / b;
  for (long long k = 0; k < panels; ++k) {
    // whiten: X0^T = C_k^T W_k^T, into x
    Args w{};
    w.a = c + k * b * mp;
    w.lda = mp;
    w.b = W + k * b * b;
    w.ldb = b;
    w.out = x;
    w.ldo = b;
    w.mp = mp;
    w.row_tiles = (int)(mp / TILE);
    w.col_tiles = b / TILE;
    w.depth = b;
    int code = launch<true>(w, stream);
    if (code != 0) return code;
    ++*launches;
    // residual: C_k -= D_k X0
    Args r{};
    r.a = D + k * b * b;
    r.lda = b;
    r.b = x;
    r.ldb = b;
    r.out = c + k * b * mp;
    r.ldo = mp;
    r.mp = mp;
    r.row_tiles = b / TILE;
    r.col_tiles = (int)(mp / TILE);
    r.depth = b;
    r.lower = 1;
    code = launch<false>(r, stream);
    if (code != 0) return code;
    ++*launches;
    // refinement: X^T = X0^T + C_k^T W_k^T, and the sums of squares of X
    w.accumulate = 1;
    w.part = part;
    code = launch<true>(w, stream);
    if (code != 0) return code;
    ++*launches;
    if (k + 1 == panels) break;
    // update: C[(k + 1) b:] -= L[(k + 1) b:, k b:(k + 1) b] X
    Args u{};
    u.a = L + (k + 1) * b * n + k * b;
    u.lda = n;
    u.b = x;
    u.ldb = b;
    u.out = c + (k + 1) * b * mp;
    u.ldo = mp;
    u.mp = mp;
    u.row_tiles = (int)((n - (k + 1) * b) / TILE);
    u.col_tiles = (int)(mp / TILE);
    u.depth = b;
    code = launch<false>(u, stream);
    if (code != 0) return code;
    ++*launches;
  }
  return 0;
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
