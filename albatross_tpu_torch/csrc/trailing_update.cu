// Trailing update of the blocked Cholesky, forward and backward, on the
// tensor cores in 3xTF32.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA at
// Precision.HIGHEST (albatross_tpu/ops/blocked_cholesky.py, the trailing
// update of the right-looking loop), an f32-faithful product built from
// several bf16 passes of the TPU's matrix unit.  Here they ran as cuBLAS
// FP32 SGEMMs on the SIMT cores (one addmm_ for each later column panel
// forward, two backward), at about 68% of the card's 67 TFLOP/s FP32 peak.
//
// For column panel k of the loop, B holds the rows of the factored panel
// below its diagonal block, (R, b) with R = P b, and the P later column
// panels C_i (i = 0..P-1) hold the active rows of the trailing matrix,
// (R - i b, b) each.  The forward launch computes, in place,
//     C_i -= B[i b:] B[i b:(i + 1) b]^T                   for every i,
// and the backward launch, from the cotangents G_i of the C_i,
//     gB[I b:(I + 1) b] = -( sum_{i <= I} G_i[(I - i) b:(I - i + 1) b] B[i b:(i + 1) b]
//                            + G_I^T B[I b:] )             for every I,
// each output tile of gB written once from one accumulator (no split-K, no
// atomics): the first sum is ops/blocked_cholesky.py's gB[r0:] -= G_i B_blk
// and the second its gB_blk -= G_i^T B[r0:], regrouped by the rows they
// write.  Every backward tile then has the same depth, (P + 1) b.
//
// Arithmetic: 3xTF32.  Each f32 operand x is split into hi = x rounded to
// TF32 (10 stored mantissa bits, to nearest, ties away) and lo = (x - hi)
// rounded to TF32, which keeps about 21-22 significant bits of x; each step
// of 8 along the contraction sums lo.hi + hi.lo + hi.hi (small terms first)
// into f32 accumulators by wgmma m64n128k8 .tf32.  The dropped lo.lo term is
// about 2^-22 of a product, f32's own rounding.  One TF32 pass alone keeps
// about three digits and fails the port's gates.  The tensor cores round
// each product's f32 result toward zero.  Summed over the whole depth that
// error grows with it (on an H100, 9e-6 of the largest entry at depth 1024
// and 2e-4 at 28672, where cuBLAS's FP32 reads 1.2e-6), so each chunk's
// products go into a fresh accumulator that is added to the tile's sum in
// registers by round-to-nearest f32 adds: 4e-7 and 1.4e-6.  What stays is
// a one-sided error of about 1e-7 of a sum of squares, which no promotion
// removes (one every 8 of the depth reads the same).  The plain NLML
// carries it within its gates, but the compensated NLML
// (config.NLML_COMPENSATED), which reads the factor more exactly than f32,
// would not (1.6e-7 from the f64 NLML of the same f32 covariance at
// N = 28672, where with cuBLAS's FP32 it reads 1.3e-8), so
// ops/blocked_cholesky.py keeps that mode's trailing updates on the f32
// GEMMs (PERF.md section 7).
//
// What bounds it on an H100: operations.  The forward's P(P + 1)/2 b^3 x 2
// and the backward's 2 x P(P + 1) b^3 x 2 floating-point operations run at
// three tensor-core products each, so the bound is the operations over
// 494.7 / 3 = 164.9 TFLOP/s; the bytes (each tile streams its rows of B and
// G through L2) are far below it.  What the design does about it:
// * One persistent launch per panel and direction: one 512-thread block an
//   SM walks the launch's 128 x 128 output tiles in a static order (tile
//   t, t + grid, ...), so nothing is counted or reset between launches.
//   The forward's tiles all have depth b; the backward's all (P + 1) b.
// * Warp specialisation.  Two loader warpgroups read each 128 x 32 chunk of
//   the two operands from global memory (one chunk ahead, in registers),
//   split it into TF32 hi and lo and write both K-major in 128-byte
//   swizzled rows into a ring of STAGES slots, handed over by mbarriers;
//   two consumer warpgroups contract the slots (64 rows each) and add each
//   chunk's partial sums into the tile's; while one warpgroup adds, the
//   other's products keep the tensor cores busy.
//   The loaders give registers to the consumers (setmaxnreg: 96 and 160 a
//   thread), which hold two accumulators of 64 a thread.  wgmma's .tf32
//   form takes both operands K-major from shared memory and has no
//   transpose bit, so an operand whose contraction runs along the rows of
//   its tensor (the backward's B, and G_I^T) is transposed by the loaders
//   on its way to shared memory: a warp's loads read 128 contiguous bytes
//   of a row, each thread keeps 4 consecutive rows of one column and writes
//   them as one 16-byte chunk (no bank conflicts in either layout).  No
//   split copy of B or G ever exists in device memory.
// * The epilogue works from the sums' registers: the forward reads its C
//   tile, subtracts and stores; the backward stores the negated sums.
// The operands' rows are multiples of 128 and b a multiple of 128, which
// the loop's panel size and its padding guarantee; the C entries refuse
// anything else.  chip_smoke.py times both launches at the main path's
// shapes beside this bound and beside cuBLAS's addmm_ (PERF.md section 6).

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
constexpr int MAX_PANELS = 256;                // column panels a launch takes (kernel parameter space)
constexpr long long WAIT_CYCLES = 1ll << 32;   // a wait this long is a fault: trap, never hang

// One launch: B (R, b) row-major with R = panels b; forward: panel[i] is
// C_i, (R - i b, b) row-major, updated in place; backward: panel[i] is G_i
// (nullptr: no cotangent, a zero contribution) and out is gB (R, b).
struct Args {
  const float* B;
  float* out;
  int b, panels;
  float* panel[MAX_PANELS];
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

// Where one operand's chunks come from: chunk c starts at p + c * step.
// K-major (tr false): the operand's row m is row m of the tensor, its
// contraction runs along the row (step KC).  Transposed (tr true): the
// operand's row m is column m of the tensor, its contraction runs down the
// rows (step KC b).
struct Source {
  const float* p;
  int64_t step;
  bool tr;
};

struct Phase {
  Source a, bop;
  int chunks;
};

// The output tile of item t: forward, tile (rt, ct) of C_i, in C_i order,
// row tiles, then column tiles; backward, tile (rt, ct) of gB's block I.
struct Tile {
  int i, rt, ct;
};

__device__ __forceinline__ Tile forward_tile(const Args& a, long long t) {
  const int tb = a.b / TILE;
  int i = 0;
  for (;; ++i) {
    const long long tiles = (long long)(a.panels - i) * tb * tb;
    if (t < tiles) break;
    t -= tiles;
  }
  return Tile{i, (int)(t / tb), (int)(t % tb)};
}

__device__ __forceinline__ Tile backward_tile(const Args& a, long long t) {
  const int tb = a.b / TILE;
  const long long per = (long long)tb * tb;
  return Tile{(int)(t / per), (int)((t % per) / tb), (int)(t % tb)};
}

__device__ __forceinline__ long long tile_count(const Args& a, bool backward) {
  const long long tb = a.b / TILE, p = a.panels;
  return backward ? p * tb * tb : p * (p + 1) / 2 * tb * tb;
}

// Phase q of item tile f, counting only the phases that have chunks;
// false when there is none.  Forward: A = B[i b + 128 rt ..], its B =
// B[i b + 128 ct ..], both K-major.  Backward: phase q <= I (a cotangent's
// i, skipping those without): A = G_i[(I - i) b + 128 rt ..] K-major, its B
// = B[i b .., 128 ct ..] transposed; then A = G_I[.., 128 rt ..]
// transposed, its B = B[I b .., 128 ct ..] transposed, over (P - I) b.
__device__ __forceinline__ bool tile_phase(const Args& a, bool backward, const Tile& f, int q, Phase& ph) {
  const int64_t b = a.b;
  const int per = a.b / KC;
  if (!backward) {
    if (q > 0) return false;
    ph.a = Source{a.B + ((int64_t)f.i * b + (int64_t)TILE * f.rt) * b, KC, false};
    ph.bop = Source{a.B + ((int64_t)f.i * b + (int64_t)TILE * f.ct) * b, KC, false};
    ph.chunks = per;
    return true;
  }
  for (int i = 0; i <= f.i; ++i) {
    const float* g = a.panel[i];
    if (g == nullptr) continue;
    if (q-- == 0) {
      ph.a = Source{g + ((int64_t)(f.i - i) * b + (int64_t)TILE * f.rt) * b, KC, false};
      ph.bop = Source{a.B + (int64_t)i * b * b + (int64_t)TILE * f.ct, KC * b, true};
      ph.chunks = per;
      return true;
    }
  }
  const float* g = a.panel[f.i];
  if (g == nullptr || q != 0) return false;
  ph.a = Source{g + (int64_t)TILE * f.rt, KC * b, true};
  ph.bop = Source{a.B + (int64_t)f.i * b * b + (int64_t)TILE * f.ct, KC * b, true};
  ph.chunks = (a.panels - f.i) * per;
  return true;
}

// Chunks of item tile f: those of its phases.
__device__ __forceinline__ int tile_chunks(const Args& a, bool backward, const Tile& f) {
  int n = 0;
  Phase ph;
  for (int q = 0; tile_phase(a, backward, f, q, ph); ++q) n += ph.chunks;
  return n;
}

// A loader thread's share of one 128 x 32 operand chunk: four groups of
// four consecutive contraction entries of one operand row.  K-major: group
// g is row 32 g + 4 w + s (w the loader warp, s = lane / 8), entries
// 4 (lane % 8).., one 16-byte load.  Transposed: group g is row 32 g + lane
// (a column of the tensor), entries 4 w.., four 4-byte loads, each of which
// reads 128 contiguous bytes of a row a warp.  (A 4 x 4 block from four
// 16-byte loads, its columns written as the groups, made the backward 11%
// slower on an H100.)  Either way the eight lanes of each phase of a
// 16-byte shared store meet eight distinct chunks of the swizzle.
constexpr int GROUPS = 4;
static_assert(LOADERS == 256, "the loaders' layout takes eight warps");
struct Part {
  float4 v[GROUPS];
};

__device__ __forceinline__ void load_part(const Source& s, int c, int64_t b, int lw, int lane, Part& out) {
  const float* p = s.p + c * s.step;
  if (!s.tr) {
    const int sub = lane >> 3, quad = lane & 7;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
      out.v[g] = __ldg(reinterpret_cast<const float4*>(p + (int64_t)(32 * g + 4 * lw + sub) * b + 4 * quad));
  } else {
    const float* q = p + (int64_t)(4 * lw) * b + lane;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      out.v[g].x = __ldg(q + 32 * g);
      out.v[g].y = __ldg(q + b + 32 * g);
      out.v[g].z = __ldg(q + 2 * b + 32 * g);
      out.v[g].w = __ldg(q + 3 * b + 32 * g);
    }
  }
}

// The part split into TF32 hi and lo, each group written as 16-byte chunk
// `chunk` of operand row r (at chunk ^ (r % 8)) of the hi operand and of
// the lo operand OPERAND_BYTES after it.
__device__ __forceinline__ void store_part(const Part& part, bool tr, int lw, int lane, unsigned char* hi) {
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int r = tr ? 32 * g + lane : 32 * g + 4 * lw + (lane >> 3);
    const int chunk = tr ? lw : lane & 7;
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

// The loader's walk over its items' chunks, in the consumers' order.
struct Cursor {
  long long t;  // item
  Tile f;
  Phase ph;
  int q, c;  // phase, chunk within it
  bool live;
};

// From phase q of item t: the first phase at or after it that has chunks
// (every phase has b / KC of them or more), or the end.
template <bool BACKWARD>
__device__ __forceinline__ void cursor_phase(const Args& a, long long total, Cursor& k) {
  for (;;) {
    if (k.t >= total) {
      k.live = false;
      return;
    }
    k.f = BACKWARD ? backward_tile(a, k.t) : forward_tile(a, k.t);
    if (tile_phase(a, BACKWARD, k.f, k.q, k.ph)) return;
    k.t += gridDim.x;
    k.q = 0;
  }
}

template <bool BACKWARD>
__device__ __forceinline__ void cursor_next(const Args& a, long long total, Cursor& k) {
  if (++k.c < k.ph.chunks) return;
  k.c = 0;
  ++k.q;
  cursor_phase<BACKWARD>(a, total, k);
}

template <bool BACKWARD>
__device__ __forceinline__ void loader(const Args& a, unsigned char* ring, uint64_t* full, uint64_t* empty) {
  const int lt = threadIdx.x, lw = lt >> 5, lane = lt & 31;
  const long long total = tile_count(a, BACKWARD);
  Cursor k;
  k.t = blockIdx.x;
  k.q = 0;
  k.c = 0;
  k.live = true;
  cursor_phase<BACKWARD>(a, total, k);
  if (!k.live) return;
  Part pa, pb;
  load_part(k.ph.a, k.c, a.b, lw, lane, pa);
  load_part(k.ph.bop, k.c, a.b, lw, lane, pb);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    const bool atr = k.ph.a.tr, btr = k.ph.bop.tr;
    cursor_next<BACKWARD>(a, total, k);
    Part na, nb;
    if (k.live) {  // the next chunk's loads, in flight while this one is split and written
      load_part(k.ph.a, k.c, a.b, lw, lane, na);
      load_part(k.ph.bop, k.c, a.b, lw, lane, nb);
    }
    mbar_wait(&empty[stage], phase ^ 1);
    unsigned char* slot = ring + stage * SLOT_BYTES;
    store_part(pa, atr, lw, lane, slot);
    store_part(pb, btr, lw, lane, slot + 2 * OPERAND_BYTES);
    fence_proxy_async();
    mbar_arrive(&full[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    if (!k.live) return;
    pa = na;
    pb = nb;
  }
}

template <bool BACKWARD>
__device__ __forceinline__ void consumer(const Args& a, unsigned char* ring, uint64_t* full, uint64_t* empty) {
  const int ct = threadIdx.x - LOADERS, cw = ct >> 7, warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rbase = 64 * cw + 16 * (warp & 3) + g;  // rows rbase, rbase + 8; columns 8 j + 2 tq, + 1
  const long long total = tile_count(a, BACKWARD);
  const int64_t b = a.b;
  int stage = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile f = BACKWARD ? backward_tile(a, t) : forward_tile(a, t);
    const int chunks = tile_chunks(a, BACKWARD, f);
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&full[stage], phase);
      __syncwarp();
      const uint32_t slot = smem_u32(ring + stage * SLOT_BYTES);
      const uint64_t ah = operand_desc(slot + cw * 64 * 128), al = operand_desc(slot + OPERAND_BYTES + cw * 64 * 128);
      const uint64_t bh = operand_desc(slot + 2 * OPERAND_BYTES), bl = operand_desc(slot + 3 * OPERAND_BYTES);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KC / 8; ++k) {  // 8 entries: 32 bytes, 2 descriptor units
        wgmma_tf32(acc, al + 2 * k, bh + 2 * k, k > 0);
        wgmma_tf32(acc, ah + 2 * k, bl + 2 * k, 1);
        wgmma_tf32(acc, ah + 2 * k, bh + 2 * k, 1);
      }
      wgmma_commit();
      // the chunk's products are complete: its slot is free, and their sum
      // joins the tile's by round-to-nearest f32 adds (see the header)
      wgmma_wait();
      fence_operands(acc);
      mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (BACKWARD) {
      float* o = a.out + ((int64_t)f.i * b + (int64_t)TILE * f.rt + rbase) * b + (int64_t)TILE * f.ct + 2 * tq;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(-sum[4 * j], -sum[4 * j + 1]);
        *reinterpret_cast<float2*>(o + 8 * b + 8 * j) = make_float2(-sum[4 * j + 2], -sum[4 * j + 3]);
      }
    } else {
      float* o = a.panel[f.i] + ((int64_t)TILE * f.rt + rbase) * b + (int64_t)TILE * f.ct + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // eight column blocks at a time: their loads in flight together
        float2 c0[8], c1[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c0[j] = *reinterpret_cast<const float2*>(o + 8 * (8 * h + j));
          c1[j] = *reinterpret_cast<const float2*>(o + 8 * b + 8 * (8 * h + j));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = 4 * (8 * h + j);
          *reinterpret_cast<float2*>(o + 8 * (8 * h + j)) =
              make_float2(__fsub_rn(c0[j].x, sum[q]), __fsub_rn(c0[j].y, sum[q + 1]));
          *reinterpret_cast<float2*>(o + 8 * b + 8 * (8 * h + j)) =
              make_float2(__fsub_rn(c1[j].x, sum[q + 2]), __fsub_rn(c1[j].y, sum[q + 3]));
        }
      }
    }
  }
}

// One block an SM: a loader warpgroup feeding two consumer warpgroups through a ring of STAGES operand slots (mbarriers: `full` when
// the loaders have written a slot, `empty` when the consumers have read it).
template <bool BACKWARD>
__global__ void __launch_bounds__(THREADS, 1) trailing_kernel(const __grid_constant__ Args a) {
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
    loader<BACKWARD>(a, ring, full, empty);
  } else {
    regs_inc<CONSUMER_REGS>();
    consumer<BACKWARD>(a, ring, full, empty);
  }
}

// Once per process for each direction and device: the shared-memory
// opt-in and the grid (one block an SM).
constexpr int MAX_DEVICES = 64;

template <bool BACKWARD>
int grid_for(int& blocks) {
  static int cached[MAX_DEVICES];
  int device = 0;
  int code = (int)cudaGetDevice(&device);
  if (code != 0) return code;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    int sms = 0;
    code = (int)cudaFuncSetAttribute(trailing_kernel<BACKWARD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     SMEM_BYTES);
    if (code == 0) code = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (code != 0) return code;
    cached[device] = sms;
  }
  blocks = cached[device];
  return 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool BACKWARD>
int launch(const float* B, float* const* panels, float* out, int count, int b, cudaStream_t stream) {
  if (b <= 0 || b % TILE != 0 || count <= 0 || count > MAX_PANELS || B == nullptr || !aligned16(B))
    return (int)cudaErrorInvalidValue;
  if (BACKWARD && (out == nullptr || !aligned16(out))) return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B;
  a.out = out;
  a.b = b;
  a.panels = count;
  for (int i = 0; i < MAX_PANELS; ++i) a.panel[i] = i < count ? panels[i] : nullptr;
  for (int i = 0; i < count; ++i) {
    if (a.panel[i] == nullptr ? !BACKWARD : !aligned16(a.panel[i])) return (int)cudaErrorInvalidValue;
  }
  int blocks = 0;
  const int code = grid_for<BACKWARD>(blocks);
  if (code != 0) return code;
  long long tiles = (long long)(b / TILE) * (b / TILE) * (BACKWARD ? count : (long long)count * (count + 1) / 2);
  if (tiles < blocks) blocks = (int)tiles;
  trailing_kernel<BACKWARD><<<blocks, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward: B (count b, b) row-major f32; cols[i] (count b - i b, b)
// row-major f32, updated in place: cols[i] -= B[i b:] B[i b:(i + 1) b]^T.
// One launch on `stream`.
int trailing_update_f32(const float* B, float* const* cols, int count, int b, void* stream_ptr) {
  return launch<false>(B, cols, nullptr, count, b, (cudaStream_t)stream_ptr);
}

// Backward: grads[i] the cotangent of cols[i] (nullptr: none); writes
// every entry of gB (count b, b):
// gB[I b:(I + 1) b] = -(sum_{i <= I} grads[i][(I - i) b:] B[i b:(i + 1) b] + grads[I]^T B[I b:]).
// One launch on `stream`.
int trailing_update_backward_f32(const float* B, float* const* grads, float* gB, int count, int b,
                                 void* stream_ptr) {
  return launch<true>(B, grads, gB, count, b, (cudaStream_t)stream_ptr);
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
