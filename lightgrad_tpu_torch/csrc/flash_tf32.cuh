// The float32 flash kernels' tensor-core arithmetic, shared by the forward
// (flash_fwd.cu: flash_fwd_tf32_kernel) and the backward (flash_bwd.cu: the
// dq and dk/dv passes and the fused kernel): every product as three tf32
// passes on mma.sync m16n8k8, 495 TFLOP/s (the TPU kernels compute f32 at
// Precision.HIGHEST, several bf16 passes; the f32 matmul does the same,
// matmul.cu).  Each operand x splits into hi = tf32(x) and lo = x - hi, and
// a product is lo hi + hi lo + hi hi, lo lo dropped.  Warp-level mma.sync
// rather than wgmma: tf32 wgmma reads only K-major operands from shared
// memory, so P V's V, dQ's K and dK's and dV's Q and dO would need
// transposed hi / lo copies, 4x the raw tile, which does not fit at D 128
// and 256.  Here shared memory holds each tile once, raw, and the threads
// split what they load.
//
// Blocks (F32Tc): D 32 and 64, 4 warps over 64 resident rows; D 96 and 128,
// 8 warps over 128; D 256, 8 warps over 64, two a 16-row slab, each taking
// 128 of the columns, the two summing their halves of the S-like products
// over d through shared memory.  Streamed tiles in two cp.async stages of 32
// rows (16 at D 256).  Shared rows are D + 4 floats apart, so the ldmatrix
// rows and the permuted B rows below both hit 32 distinct banks.
//
// S-like products (X Y^T): both operands K-major, read by ldmatrix (an 8 x 4
// f32 block is an 8 x 8 b16 matrix whose fragment is tf32's).  A product
// that takes such a result as its A operand (P V, dS K, P^T dO, dS^T Q)
// reads it from the accumulator fragment, whose columns (2t, 2t + 1) become
// the depths (t, t + 4) of its A fragment, with B's rows read by the same
// permutation: no shuffles.  Each tile's share of a sum starts from zero
// and is added in f32: the tensor cores truncate as they add, and a sum
// kept in place drifts (over Mistral-7B's band, dk 1.4e-4 of the largest
// f64 element against 1.2e-6 from zero: scripts/flash_bwd_variants.py's
// in_place).
#pragma once

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// Blocks of the f32 kernels at instantiation D (32, 64, 96, 128 or 256;
// another d runs the next wider D): SLABS slabs of 16 resident rows
// (queries in the forward and the dq pass, keys in the dk/dv pass and the
// fused kernel), WN warps a slab, each taking DW = D / WN of the columns; BK
// keys a streamed tile in the forward and the dq pass, BQ queries in the
// dk/dv pass.  Shared rows are P = D + 4 floats apart, so that every
// fragment load (ldmatrix rows, the permuted B rows) hits 32 distinct banks.
template <int D>
struct F32Tc {
  static constexpr int SLABS = D == 96 || D == 128 ? 8 : 4;
  static constexpr int WN = D == 256 ? 2 : 1;
  static constexpr int NW = SLABS * WN;
  static constexpr int kThreads = 32 * NW;
  static constexpr int BR = 16 * SLABS;  // resident rows a block
  static constexpr int DW = D / WN;      // columns a warp
  static constexpr int P = D + 4;        // floats a shared row
  static constexpr int BK = D == 256 ? 16 : 32;
  static constexpr int BQ = D == 256 ? 16 : 32;
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
  // the slab's partial products over d, exchanged between its WN warps:
  // a 16 x BS fragment is 16 BS floats a warp
  static constexpr int kXFwd = WN > 1 ? NW * 16 * BK : 0;
  static constexpr int kXDq = 2 * kXFwd;
  static constexpr int kXDkv = WN > 1 ? NW * 32 * BQ : 0;
  // forward: Q resident, two stages of K and V
  static constexpr int kSmemFwd = (BR * P + 4 * BK * P + kXFwd) * 4;
  // dq: Q and dO resident, two stages of K and V
  static constexpr int kSmemDq = (2 * BR * P + 4 * BK * P + kXDq) * 4;
  // dk/dv: K and V resident, two stages of Q, dO, lse and dcap
  static constexpr int kStageDkv = 2 * BQ * P + 2 * BQ;
  static constexpr int kSmemDkv = (2 * BR * P + 2 * kStageDkv + kXDkv) * 4;
  // fused: the dk/dv pass's and the tile's dS, BQ queries x BR keys, rows
  // PK floats apart
  static constexpr int PK = BR + 4;
  static constexpr int kSmemFused = kSmemDkv + BQ * PK * 4;
  static_assert(kSmemFwd <= 232448 && kSmemDq <= 232448 &&
                    kSmemFused <= 232448,
                "a block's shared memory is at most 227 KB");
};

// Rows [r0, r0 + R) of a (rows, d) f32 slab at row stride d into shared
// rows P = D + 4 floats apart, by 16-byte cp.async copies; rows >= rows and
// columns >= d are zero-filled.
template <int R, int D, int NT>
__device__ __forceinline__ void stage_f32(uint32_t dst, const float* src,
                                          int r0, int rows, int d) {
  constexpr int C4 = D / 4, P = D + 4;
  static_assert((R * C4) % NT == 0, "uneven tile copy");
#pragma unroll
  for (int i = 0; i < R * C4 / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / C4, c = e % C4;
    const bool ok = r0 + r < rows && c * 4 < d;
    lg_cp_async16(dst + (r * P + c * 4) * 4,
                  ok ? src + (size_t)(r0 + r) * d + c * 4 : src, ok ? 16 : 0);
  }
}

// x = hi + lo: hi = tf32(x), to nearest; lo = x - hi, exact in f32, of
// which the tensor core reads the top 19 bits
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_hi(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16 x 8) += A (16 x 8) B (8 x 8), tf32 operands, f32 accumulators.
// Fragments, thread (g = lane / 4, t = lane % 4): A a0 = (g, t), a1 = (g +
// 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4); B b0 = (t, g), b1 = (t + 4,
// g); C c0, c1 = (g, 2t, 2t + 1), c2, c3 = (g + 8, 2t, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the two small products of the three passes, lo hi + hi lo, which a chain
// sums in an accumulator of their own, beside the hi hi products' one, the
// two added in f32 at the end.  The tensor cores truncate every sum to the
// accumulator's width, so one accumulator for all three would truncate at
// full size three times a depth step instead of once (against f64, twice
// the error at Pythia-1B's and Mistral-7B's shapes:
// scripts/flash_bwd_variants.py's interleaved).
__device__ __forceinline__ void mma_small(float (&c)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
}

// t (16 x 8 NB) = X Y^T over the DW columns from c0, three passes: X the
// warp's 16 rows of a resident tile, Y the 8 NB rows of a streamed one
// (shared addresses of their first rows, rows P floats apart), both
// K-major.  ldmatrix reads an 8 x 4 f32 block as an 8 x 8 b16 matrix,
// whose fragment (row lane / 4, word lane % 4) is the tf32 one: A is the
// blocks (rows 0-7, 8-15) x (words 0-3, 4-7), B four 4-word blocks of a
// row block, two 8-deep steps.  t starts from zero each tile; the small
// products sum apart (mma_small).
template <int NB, int DW, int P>
__device__ __forceinline__ void product_xyt(float (&t)[NB][4], uint32_t x,
                                            uint32_t y, int c0, int lane) {
  const uint32_t xa =
      x + (((lane & 7) + ((lane >> 3) & 1) * 8) * P + c0 + (lane >> 4) * 4) * 4;
  const uint32_t ya = y + ((lane & 7) * P + c0 + (lane >> 3) * 4) * 4;
  float ts[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[nb][e] = ts[nb][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DW / 8; ks += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t r[4];
      lg_tc::ldmatrix_x4(r, xa + (ks + h) * 32);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32(__uint_as_float(r[j]), ah[h][j], al[h][j]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t r[4], bh[4], bl[4];
      lg_tc::ldmatrix_x4(r, ya + (nb * 8 * P + ks * 8) * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32(__uint_as_float(r[j]), bh[j], bl[j]);
      mma_small(ts[nb], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
      mma_small(ts[nb], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
      mma_tf32(t[nb], ah[0], bh[0], bh[1]);
      mma_tf32(t[nb], ah[1], bh[2], bh[3]);
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[nb][e] += ts[nb][e];
}

// A 16 x 8 NB fragment to (put) or added from (add) a warp's 128 NB words
// of shared memory, a word a lane apart.
template <int NB>
__device__ __forceinline__ void put_frag(float* w, const float (&x)[NB][4],
                                         int lane) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) w[(nb * 4 + e) * 32 + lane] = x[nb][e];
}
template <int NB>
__device__ __forceinline__ void add_frag(const float* w, float (&x)[NB][4],
                                         int lane) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nb][e] += w[(nb * 4 + e) * 32 + lane];
}

// The slab's WN = 2 warps sum their partial products over d: each writes
// its fragments to its words of `xb`, and after the block's barrier adds
// its partner's.  a + b == b + a in f32, so both hold the same bits.
template <int NB>
__device__ __forceinline__ void exchange(float (&s)[NB][4], float* xb,
                                         int warp, int partner, int lane) {
  constexpr int W = NB * 4 * 32;  // floats a warp
  put_frag<NB>(xb + warp * W, s, lane);
  __syncthreads();
  add_frag<NB>(xb + partner * W, s, lane);
}
template <int NB>
__device__ __forceinline__ void exchange(float (&s)[NB][4],
                                         float (&dp)[NB][4], float* xb,
                                         int warp, int partner, int lane) {
  constexpr int W = 2 * NB * 4 * 32;
  put_frag<NB>(xb + warp * W, s, lane);
  put_frag<NB>(xb + warp * W + W / 2, dp, lane);
  __syncthreads();
  add_frag<NB>(xb + partner * W, s, lane);
  add_frag<NB>(xb + partner * W + W / 2, dp, lane);
}

// The A fragments (hi, lo) of the next product from a 16 x 8 KB accumulator
// fragment f: its columns (2t, 2t + 1) of block kb become the fragment's
// depths (t, t + 4) -- the product's depth is permuted within each 8, and
// B's rows are read by the same permutation (accumulate below), so no
// value moves between threads.
template <int KB>
__device__ __forceinline__ void to_a(uint32_t (&hi)[KB][4],
                                     uint32_t (&lo)[KB][4],
                                     const float (&f)[KB][4]) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    split_tf32(f[kb][0], hi[kb][0], lo[kb][0]);
    split_tf32(f[kb][2], hi[kb][1], lo[kb][1]);
    split_tf32(f[kb][1], hi[kb][2], lo[kb][2]);
    split_tf32(f[kb][3], hi[kb][3], lo[kb][3]);
  }
}

// acc (16 x 8 NN) += F Y, three passes (the small ones apart, mma_small):
// F the 16 x 8 KB A fragments of to_a, Y the tile's 8 KB rows at this
// warp's columns, MN-major, read as b0 = Y[8 kb + 2t][8 nb + g], b1 =
// Y[8 kb + 2t + 1][8 nb + g] (y: the thread's first word, Y + 2t P + g +
// c0): the depth order of to_a.  Each tile's share starts from
// zero and is added to acc in f32: the tensor cores truncate as they add,
// so over a long pass a sum kept in place would drift.  PK: also pk += F'
// Y in one pass, F' the hi fragments `ph` (the dq pass's sum_j p_ij k_j,
// which multiplies the small dcap correction).
template <int KB, int NN, int P, bool PK>
__device__ __forceinline__ void accumulate(float (&acc)[NN][4],
                                           float (&pk)[NN][4],
                                           const uint32_t (&fh)[KB][4],
                                           const uint32_t (&fl)[KB][4],
                                           const uint32_t (&ph)[KB][4],
                                           const float* y) {
#pragma unroll
  for (int nb = 0; nb < NN; ++nb) {
    float part[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(y[(8 * kb) * P + 8 * nb], bh0, bl0);
      split_tf32(y[(8 * kb + 1) * P + 8 * nb], bh1, bl1);
      mma_small(small, fh[kb], fl[kb], bh0, bh1, bl0, bl1);
      mma_tf32(part, fh[kb], bh0, bh1);
      if constexpr (PK) mma_tf32(pk[nb], ph[kb], bh0, bh1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] += part[e] + small[e];
  }
}

template <int NN>
__device__ __forceinline__ void zero_frag(float (&x)[NN][4]) {
#pragma unroll
  for (int nb = 0; nb < NN; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nb][e] = 0.f;
}

// Row i (0: g, 1: g + 8) of a 16 x 8 NN fragment, times mul, to the
// columns c0 + 8 nb + 2t, + 1 below d of an f32 row.
template <int NN>
__device__ __forceinline__ void store_frag(float* row, const float (&x)[NN][4],
                                           int i, int c0, int lane, int d,
                                           float mul) {
#pragma unroll
  for (int nb = 0; nb < NN; ++nb) {
    const int c = c0 + nb * 8 + (lane & 3) * 2;
    if (c < d)
      *reinterpret_cast<float2*>(row + c) =
          make_float2(x[nb][2 * i] * mul, x[nb][2 * i + 1] * mul);
  }
}

// Raise a kernel's dynamic shared memory past 48 KB, once.
template <typename K>
int smem_limit(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return (int)e;
}

}  // namespace
