// The tensor-core GEMM core that csrc/matmul.cu and csrc/conv_tc.cu share: a
// block of three warpgroups over a 128 x BN output tile, a producer that
// fills a ring of shared-memory stages and two consumers that run the
// `wgmma` products on them.  The files differ only in how the producer
// finds a stage's rows (a strided matrix; the rows of an implicit GEMM) and
// where the epilogue writes.
//
//   ring:      S stages, each an A tile (128 rows x 128 bytes) then a B tile
//              (BN rows x 128 bytes), handed over by mbarriers (full: 128
//              producer arrivals; empty: one arrival a consumer warp once
//              it is done with the stage).  Tiles are 128-byte rows in the
//              128-byte swizzle (csrc/tensor_core.cuh); a k-major tile has
//              its rows along m / n, an mn-major one 64-column blocks of BK
//              rows along k, read through the wgmma transpose bit.
//   bf16:      64-deep stages, a ring of 4, one wgmma pass a 16-deep step.
//   tf32 hi/lo: f32 operands staged beforehand as tf32 hi and lo tensors
//              (csrc/conv_tc.cu's lg_conv_layout): each 32-deep stage holds
//              A hi, A lo, B hi, B lo, copied straight into the ring, and
//              the consumers run the three products of f32x3 below on it.
//   f32x3:     32-deep stages of raw f32 (a ring of 3).  The consumers split
//              stage kt + 1 into tf32 hi and lo tiles (k-major: tf32 takes no
//              transpose bit, so an mn-major raw tile is transposed in 4 x 4
//              blocks) while the products of stage kt run on the other of
//              two hi / lo buffers; each stage's three products (the small
//              ones first) start from zero and are added to the running f32
//              sum afterwards, so the tensor cores' truncation stays within
//              a stage instead of growing with K.
//   producer:  fill(kt, stage) starts a stage's copies; with cp.async copies
//              a stage is published LAG stages behind, once they landed (the
//              ring's depth and lag are parameters of Cfg).
#pragma once

#include "common.cuh"
#include "tensor_core.cuh"

namespace lg_gemm {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                 // output rows a block
constexpr int kThreads = 384;            // consumers 0-255, producer 256-383
constexpr int kProducer = 256;
constexpr int kTile = 128 * 128;         // bytes: 128 rows of 128 bytes

enum Kind { kF32x3 = 0, kBf16 = 1, kF32Bf16 = 2, kTf32HL = 3 };

// S_: the ring's stages; LAG_: cp.async stages in flight before one is
// published
template <int KIND, int BN_ = KIND == kF32x3 ? 128 : 256,
          int S_ = (KIND == kF32x3 || (KIND == kTf32HL && BN_ > 64)) ? 3 : 4,
          int LAG_ = 2>
struct Cfg {
  // output columns a block (64, 128 or 256 in bf16; 64 or 128 in the f32
  // kinds, whose stages hold hi and lo tiles of both operands)
  static constexpr int BN = BN_;
  // depth of a stage: 128 bytes of a row, 64 bf16 or 32 tf32 elements
  static constexpr int BK = KIND == kF32x3 || KIND == kTf32HL ? 32 : 64;
  static constexpr int kBTile = BN * 128;
  // tf32 hi/lo: A hi, A lo, B hi, B lo
  static constexpr int kStageBytes =
      KIND == kTf32HL ? 2 * kTile + 2 * kBTile : kTile + kBTile;
  static constexpr int kStages = S_;
  static constexpr int kLag = LAG_;
  // the bf16 consumers release a stage once the next one's products have
  // started, the f32 ones once they split it or its products are done: the
  // producer, LAG stages ahead of what it published, must find that slot
  // free
  static_assert(LAG_ >= 1 &&
                    LAG_ + (KIND == kF32x3 || KIND == kTf32HL ? 1 : 2) <= S_,
                "a ring too shallow for its lag deadlocks");
  // f32x3: two split stages after the ring, each A hi, A lo, B hi, B lo
  static constexpr int kSplitStage = 2 * kTile + 2 * kBTile;
  static constexpr int kSplitBytes = KIND == kF32x3 ? 2 * kSplitStage : 0;
  static constexpr int kSmem =
      kStages * kStageBytes + kSplitBytes + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t sw(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// hi = tf32(x), lo = tf32(x - hi) of four elements, stored at `off` of the
// hi and lo tiles
__device__ __forceinline__ void split_store(uint32_t hi, uint32_t lo,
                                            uint32_t off, float x0, float x1,
                                            float x2, float x3) {
  const uint32_t h0 = lg_tc::tf32_rne(x0), h1 = lg_tc::tf32_rne(x1);
  const uint32_t h2 = lg_tc::tf32_rne(x2), h3 = lg_tc::tf32_rne(x3);
  lg_tc::st_shared16(hi + off, h0, h1, h2, h3);
  lg_tc::st_shared16(lo + off, lg_tc::tf32_rne(x0 - __uint_as_float(h0)),
                     lg_tc::tf32_rne(x1 - __uint_as_float(h1)),
                     lg_tc::tf32_rne(x2 - __uint_as_float(h2)),
                     lg_tc::tf32_rne(x3 - __uint_as_float(h3)));
}

// ---- raw f32 tiles (f32x3) ----------------------------------------------
// A k-major raw tile is R rows x 32 k (128-byte rows, chunk c of row r at r
// * 128 + c * 16); an mn-major one 32 k rows x R mn (R * 4-byte rows), chunk
// cm of row kr at chunk position raw_mn_chunk(cm, kr), so that the 4 x 4
// blocks the split reads from a quarter-warp fall in different banks.
__device__ __forceinline__ int raw_mn_chunk(int cm, int kr) {
  return (cm & ~7) | ((cm ^ (kr >> 2)) & 7);
}

__device__ __forceinline__ uint32_t raw_k_at(int r, int c) {
  return r * 128 + c * 16;
}

template <int R>
__device__ __forceinline__ uint32_t raw_mn_at(int kr, int cm) {
  return kr * (R * 4) + (raw_mn_chunk(cm, kr) << 4);
}

// One k-major raw tile of R rows split by the 256 consumer threads (`t`)
// into its k-major tf32 hi and lo tiles
template <int R>
__device__ __forceinline__ void split_raw_k(uint32_t raw, uint32_t hi,
                                            uint32_t lo, int t) {
  float4 v[R / 32];
#pragma unroll
  for (int i = 0; i < R / 32; ++i) {
    const int e = t + i * 256;
    v[i] = lds4(raw + raw_k_at(e >> 3, e & 7));
  }
#pragma unroll
  for (int i = 0; i < R / 32; ++i) {
    const int e = t + i * 256;
    split_store(hi, lo, sw(e >> 3, e & 7), v[i].x, v[i].y, v[i].z, v[i].w);
  }
}

// One mn-major raw tile (32 k x R mn) split into k-major hi and lo tiles in
// 4 x 4 blocks (4 consecutive mn at 4 consecutive k, transposed): block (j,
// kq) of b = t at j = 2 bits 3.. + bit 0, kq = bits 1-2 + 4 (b / R), so the
// 8 threads of a quarter-warp store to 8 different chunk columns; R 64 uses
// the first 128 threads.
template <int R>
__device__ __forceinline__ void split_raw_mn(uint32_t raw, uint32_t hi,
                                             uint32_t lo, int t) {
  if (t >= 2 * R) return;
  const int j = ((t >> 3) & (R / 8 - 1)) * 2 + (t & 1);
  const int kq = ((t >> 1) & 3) + 4 * (t / R);
  float4 b[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) b[kk] = lds4(raw + raw_mn_at<R>(4 * kq + kk, j));
  split_store(hi, lo, sw(4 * j, kq), b[0].x, b[1].x, b[2].x, b[3].x);
  split_store(hi, lo, sw(4 * j + 1, kq), b[0].y, b[1].y, b[2].y, b[3].y);
  split_store(hi, lo, sw(4 * j + 2, kq), b[0].z, b[1].z, b[2].z, b[3].z);
  split_store(hi, lo, sw(4 * j + 3, kq), b[0].w, b[1].w, b[2].w, b[3].w);
}

// the consumer warpgroups' own barrier (id 2, 256 threads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

// the producer warpgroup's own barrier (id 1, 128 threads)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// ---- the consumers' products over one stage ----------------------------

// f32x3: the two small products (lo hi, hi lo) first, then hi hi, all into
// `part`, which the first product overwrites (4 8-deep steps of 32 bytes)
template <int BN>
__device__ __forceinline__ void stage_x3(float (&part)[BN / 2], uint32_t st,
                                         int wg) {
  const uint32_t ahi = st + wg * 8192, alo = ahi + kTile;
  const uint32_t bhi = st + 2 * kTile, blo = bhi + BN * 128;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t off = ks * 32;
    lg_tc::wgmma_tf32(part, lg_tc::desc_sw128(alo + off, 16, 1024),
                      lg_tc::desc_sw128(bhi + off, 16, 1024), ks > 0);
    lg_tc::wgmma_tf32(part, lg_tc::desc_sw128(ahi + off, 16, 1024),
                      lg_tc::desc_sw128(blo + off, 16, 1024), 1);
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t off = ks * 32;
    lg_tc::wgmma_tf32(part, lg_tc::desc_sw128(ahi + off, 16, 1024),
                      lg_tc::desc_sw128(bhi + off, 16, 1024), 1);
  }
}

// bf16: acc (64 x BN) += A B over the stage's 64-deep tiles.  TA / TB: the
// tile is mn-major (16-deep steps of 16 rows, 64-column blocks 64 rows x
// 128 bytes apart) rather than k-major (steps of 32 bytes)
template <int TA, int TB, int BN>
__device__ __forceinline__ void stage_bf16(float (&acc)[BN / 2], uint32_t st,
                                           int wg) {
  const uint32_t a = st + wg * 8192, b = st + kTile;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t da = TA ? lg_tc::desc_sw128(a + ks * 2048, 8192, 1024)
                           : lg_tc::desc_sw128(a + ks * 32, 16, 1024);
    const uint64_t db = TB ? lg_tc::desc_sw128(b + ks * 2048, 8192, 1024)
                           : lg_tc::desc_sw128(b + ks * 32, 16, 1024);
    lg_tc::wgmma_bf16<TA, TB>(acc, da, db);
  }
}

// ---- the ring ------------------------------------------------------------

// the shared tiles (1024-byte aligned) and the ring's barriers; thread 0
// initialises them; a block barrier must follow
template <int S>
__device__ __forceinline__ void ring_init(uint32_t full, uint32_t empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      lg_tc::mbar_init(full + 8 * s, 128);
      lg_tc::mbar_init(empty + 8 * s, 8);   // the consumers' 8 warps
    }
    lg_tc::mbar_fence_init();
  }
}

// The producer warpgroup over nk stages of the ring of configuration C:
// fill(kt, slot) issues stage kt's loads into the slot's shared address once
// the consumers emptied it.  With `async` (cp.async copies only) a stage is
// published C::kLag stages behind, once its copies landed; otherwise at
// once.  FENCE: the tiles are read by wgmma (the async proxy) rather than
// by the consumers' own loads.
template <class C, bool FENCE, class Fill>
__device__ __forceinline__ void produce(uint32_t tiles, uint32_t full,
                                        uint32_t empty, int nk, bool async,
                                        Fill fill) {
  constexpr int S = C::kStages, STAGE_BYTES = C::kStageBytes;
  constexpr int kLag = C::kLag;
  for (int kt = 0; kt < nk; ++kt) {
    lg_tc::mbar_wait(empty + 8 * (kt % S), ((kt / S) & 1) ^ 1);
    fill(kt, tiles + (kt % S) * STAGE_BYTES);
    lg_cp_async_commit();
    if (async) {
      if (kt >= kLag) {
        lg_cp_async_wait<kLag>();
        if (FENCE) lg_tc::fence_proxy_async();
        lg_tc::mbar_arrive(full + 8 * ((kt - kLag) % S));
      }
    } else {
      lg_cp_async_wait<0>();
      if (FENCE) lg_tc::fence_proxy_async();
      lg_tc::mbar_arrive(full + 8 * (kt % S));
    }
  }
  if (async) {
    lg_cp_async_wait<0>();
    if (FENCE) lg_tc::fence_proxy_async();
    for (int kt = max(0, nk - kLag); kt < nk; ++kt)
      lg_tc::mbar_arrive(full + 8 * (kt % S));
  }
}

// f32x3 consumers: acc += the products of nk stages; split(kt, raw, hl)
// splits stage kt's raw tiles (at `raw`) into the hi / lo stage at `hl`
// (A hi, A lo, B hi, B lo)
template <class C, class Split>
__device__ __forceinline__ void consume_x3(float (&acc)[C::BN / 2],
                                           uint32_t tiles, uint32_t full,
                                           uint32_t empty, int nk,
                                           Split split) {
  constexpr int S = C::kStages, BN = C::BN;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  // stage kt's raw tiles split into hi / lo stage kt % 2 while the
  // products of stage kt - 1 run on the other
  const uint32_t split0 = tiles + S * C::kStageBytes;
  auto split_stage = [&](int kt) {
    const uint32_t raw = tiles + (kt % S) * C::kStageBytes;
    const uint32_t hl = split0 + (kt & 1) * C::kSplitStage;
    lg_tc::mbar_wait(full + 8 * (kt % S), (kt / S) & 1);
    split(kt, raw, hl);
    __syncwarp();
    if (lane == 0) lg_tc::mbar_arrive(empty + 8 * (kt % S));
    lg_tc::fence_proxy_async();
  };
  float part[BN / 2];
  if (nk > 0) split_stage(0);
  consumer_sync();
  for (int kt = 0; kt < nk; ++kt) {
    lg_tc::fence_regs(part);
    lg_tc::wg_fence();
    stage_x3<BN>(part, split0 + (kt & 1) * C::kSplitStage, wg);
    lg_tc::wg_commit();
    if (kt + 1 < nk) split_stage(kt + 1);
    lg_tc::wg_wait<0>();
    lg_tc::fence_regs(part);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] += part[e];
    consumer_sync();   // stage kt + 1 split; stage kt's products done
  }
}

// tf32 hi/lo consumers: acc += the three products of nk stages, read by
// wgmma straight from the ring; each stage's sum starts from zero and is
// added in f32 once its products are done, and then the slot is released
template <class C>
__device__ __forceinline__ void consume_hl(float (&acc)[C::BN / 2],
                                           uint32_t tiles, uint32_t full,
                                           uint32_t empty, int nk) {
  constexpr int S = C::kStages, BN = C::BN;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  float part[BN / 2];
  for (int kt = 0; kt < nk; ++kt) {
    lg_tc::mbar_wait(full + 8 * (kt % S), (kt / S) & 1);
    lg_tc::fence_regs(part);
    lg_tc::wg_fence();
    stage_x3<BN>(part, tiles + (kt % S) * C::kStageBytes, wg);
    lg_tc::wg_commit();
    lg_tc::wg_wait<0>();
    lg_tc::fence_regs(part);
    if (lane == 0) lg_tc::mbar_arrive(empty + 8 * (kt % S));
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] += part[e];
  }
}

// bf16 consumers: acc += the products of nk stages, read by wgmma straight
// from the ring
template <int TA, int TB, class C>
__device__ __forceinline__ void consume_bf16(float (&acc)[C::BN / 2],
                                             uint32_t tiles, uint32_t full,
                                             uint32_t empty, int nk) {
  constexpr int S = C::kStages, BN = C::BN, STAGE_BYTES = C::kStageBytes;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  for (int kt = 0; kt < nk; ++kt) {
    lg_tc::mbar_wait(full + 8 * (kt % S), (kt / S) & 1);
    lg_tc::fence_regs(acc);
    lg_tc::wg_fence();
    stage_bf16<TA, TB, BN>(acc, tiles + (kt % S) * STAGE_BYTES, wg);
    lg_tc::wg_commit();
    lg_tc::wg_wait<1>();   // the previous stage's products are done
    lg_tc::fence_regs(acc);
    if (kt > 0 && lane == 0) lg_tc::mbar_arrive(empty + 8 * ((kt - 1) % S));
  }
  lg_tc::wg_wait<0>();
  lg_tc::fence_regs(acc);
}

// The row of the block's tile that accumulators 4 j + 2 h and 4 j + 2 h +
// 1 of this consumer thread hold (columns 8 j + 2 (lane % 4) and one more)
__device__ __forceinline__ int acc_row(int h) {
  return (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 +
         ((threadIdx.x & 31) >> 2) + 8 * h;
}

}  // namespace lg_gemm
