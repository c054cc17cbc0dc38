// Batched matrix product C[z] = A[z] @ B[z] on Hopper's tensor cores.
//
// Replaces the TPU kernel lightgrad_tpu/ops/matmul.py::_pallas_matmul3
// (B, M, K) @ (B, K, N) -> (B, M, N), and through it every product of the
// lightgrad tape: nn.Linear, the attention scores and context, and the
// gradients of each.  Three kinds of product, as the TPU kernel's MXU
// passes:
//   bf16      bf16 operands, one wgmma pass (m64n256k16), f32 sums, one
//             rounding on the store;
//   f32x3     f32 operands at the JAX package's Precision.HIGHEST: each
//             operand x splits into hi = tf32(x) and lo = tf32(x - hi)
//             (round to nearest even), and hi*hi + hi*lo + lo*hi run as
//             three tf32 wgmma passes (m64n128k8) into f32 accumulators --
//             the lo*lo term and lo's own rounding are below f32's last
//             bit for all but cancelling sums;
//   f32bf16   f32 operands at Precision.DEFAULT (amp.set_matmul_precision
//             ("default")): rounded to bf16 on the way in, one bf16 pass,
//             an f32 result.
//
// A and B are read through strides, so a transposed operand (the weight's
// W.T of nn.Linear, k.transpose(-1, -2) of the attention scores, a^T and
// b^T of the backward) and a broadcast batch (stride 0) cost no copy.  The
// batch is up to two dims, z = b1 * B2 + b2, each with its own strides.  C
// is contiguous (batch, M, N).  Ragged M, N and K are masked: elements
// past an edge load as 0 and are not stored.
//
// What bounds it on this card: the tensor cores (989 TFLOP/s bf16, 495
// tf32, so f32x3 at 165) and, at 128-row tiles, the bytes from L2 to
// shared memory and shared memory's own bandwidth (the f32 split writes
// and rereads each tile).  Design: the producer / consumer ring of
// csrc/gemm_core.cuh (shared with the convolutions of csrc/conv_tc.cu) over
// 128 x BN output tiles.
//   bf16 kinds: 128 x 256 tiles.  The producer's loader is chosen per
//             operand by its strides (ops/matmul.py `_loader`): bf16 with
//             16-byte aligned rows along k or along m / n by cp.async
//             (async-k / async-mn), two stages in flight, each published
//             when its copies land; an mn-major tile is read through the
//             wgmma transpose bit, so no copy transposes.  f32 rounded to
//             bf16 (f32bf16), and bf16 whose rows cannot feed 16-byte
//             copies, through registers.
//   f32x3:    128 x 128 tiles.  The producer copies raw f32 tiles by
//             cp.async (vec-k: rows along k; vec-mn: rows along m / n); the
//             consumers split them into tf32 hi and lo (gemm_core.cuh; one
//             accumulator over K = 8192 erred 30x cuBLAS f32, the stage
//             sums err 0.3x).
//   scalar:   an operand with no unit stride (or, in the bf16 kinds, rows
//             not 16-byte aligned) is read element by element; in f32x3 rows
//             with a unit stride but not 16-byte aligned are copied by
//             4-byte cp.async (elem-k / elem-mn).
// Tiles are visited in groups of 8 row tiles, so the A rows and B columns
// that neighbouring blocks read stay in L2.  Not yet: TMA and clusters
// (multicast would halve the L2 bytes a tile), a persistent grid whose
// epilogue overlaps the next tile's loads, register A operands.
#include <initializer_list>
#include <type_traits>

#include "gemm_core.cuh"

namespace {

using namespace lg_gemm;

constexpr int kGroupM = 8;               // row tiles a group of blocks visits

enum Loader {
  kAsyncK = 0, kAsyncMN = 1, kVecK = 2, kVecMN = 3, kScalar = 4,
  kElemK = 5, kElemMN = 6
};

// One operand: element (b1, b2, mn, k) at p + b1 sb1 + b2 sb2 + mn smn + k sk
// (mn is A's row m or B's column n); n is the extent of mn.
struct Operand {
  const void* p;
  long long sb1, sb2, smn, sk;
  int n, loader;
};

struct Params {
  Operand a, b;
  void* c;
  int M, N, K, B2, tiles_m, tiles_n;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void bf16_store(uint32_t addr, const float (&x)[8]) {
  lg_tc::st_shared16(addr, lg_tc::pack_bf16(x[0], x[1]),
                     lg_tc::pack_bf16(x[2], x[3]),
                     lg_tc::pack_bf16(x[4], x[5]),
                     lg_tc::pack_bf16(x[6], x[7]));
}

// ---- the producer's loaders: one operand's tile of a stage ---------------
// `t` is the producer thread (0-127); the tile covers mn in [mn0, mn0 + R)
// and k in [k0, k0 + BK).

// bf16 by cp.async: k-major (R rows x 64 k) or mn-major (64 k rows x R mn,
// 64-column blocks 8 KB apart)
template <int R>
__device__ __forceinline__ void tile_async(const Operand& o, const bf16* base,
                                           int mn0, int k0, int K,
                                           uint32_t dst, int t) {
#pragma unroll
  for (int i = 0; i < R / 16; ++i) {
    const int e = t + i * 128;
    if (o.loader == kAsyncK) {
      const int r = e >> 3, c = e & 7;
      const bool ok = mn0 + r < o.n && k0 + 8 * c < K;
      const bf16* g = base + (mn0 + r) * o.smn + k0 + 8 * c;
      lg_cp_async16(dst + sw(r, c), ok ? g : base, ok ? 16 : 0);
    } else {
      const int kr = e / (R / 8), cc = e % (R / 8);
      const bool ok = k0 + kr < K && mn0 + 8 * cc < o.n;
      const bf16* g = base + (k0 + kr) * o.sk + mn0 + 8 * cc;
      lg_cp_async16(dst + (cc >> 3) * 8192 + sw(kr, cc & 7), ok ? g : base,
                    ok ? 16 : 0);
    }
  }
}

// f32 raw tiles by cp.async (f32x3) in the core's raw layouts (k-major
// sources as 128 rows x 32 k, mn-major ones as 32 k rows x 128 mn).  Rows
// 16-byte aligned (vec-k / vec-mn) take 16-byte copies; others with a unit
// stride (elem-k / elem-mn: the decoder's 30522-wide gradients) 4-byte
// copies into the same places.
template <int LOADER>
__device__ __forceinline__ void raw_async(const Operand& o, const float* base,
                                          int mn0, int k0, int K,
                                          uint32_t dst, int t) {
  constexpr bool along_k = LOADER == kVecK || LOADER == kElemK;
  constexpr bool vec = LOADER == kVecK || LOADER == kVecMN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = t + i * 128;
    if constexpr (along_k) {
      const int r = e >> 3, c = e & 7;
      const float* g = base + (mn0 + r) * o.smn + k0 + 4 * c;
      const uint32_t d = dst + raw_k_at(r, c);
      if constexpr (vec) {
        const bool ok = mn0 + r < o.n && k0 + 4 * c < K;
        lg_cp_async16(d, ok ? g : base, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = mn0 + r < o.n && k0 + 4 * c + q < K;
          lg_cp_async4(d + 4 * q, ok ? g + q : base, ok ? 4 : 0);
        }
      }
    } else {
      const int kr = e >> 5, cm = e & 31;
      const float* g = base + (k0 + kr) * o.sk + mn0 + 4 * cm;
      const uint32_t d = dst + raw_mn_at<128>(kr, cm);
      if constexpr (vec) {
        const bool ok = k0 + kr < K && mn0 + 4 * cm < o.n;
        lg_cp_async16(d, ok ? g : base, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = k0 + kr < K && mn0 + 4 * cm + q < o.n;
          lg_cp_async4(d + 4 * q, ok ? g + q : base, ok ? 4 : 0);
        }
      }
    }
  }
}

// raw_async for the operand's loader (nothing for element loads, which the
// consumers make themselves)
__device__ __forceinline__ void raw_tile(const Operand& o, const float* base,
                                         int mn0, int k0, int K,
                                         uint32_t dst, int t) {
  switch (o.loader) {
    case kVecK: raw_async<kVecK>(o, base, mn0, k0, K, dst, t); break;
    case kVecMN: raw_async<kVecMN>(o, base, mn0, k0, K, dst, t); break;
    case kElemK: raw_async<kElemK>(o, base, mn0, k0, K, dst, t); break;
    case kElemMN: raw_async<kElemMN>(o, base, mn0, k0, K, dst, t); break;
    default: break;
  }
}

// One operand's raw tile split by the 256 consumer threads (`t`) into its
// k-major tf32 hi and lo tiles (gemm_core.cuh); an operand whose rows
// cannot feed 16-byte copies (scalar) element by element from global
// memory.
__device__ __forceinline__ void split_tile(const Operand& o, uint32_t raw,
                                           const float* base, int mn0,
                                           int k0, int K, uint32_t hi,
                                           uint32_t lo, int t) {
  if (o.loader == kVecMN || o.loader == kElemMN) {
    split_raw_mn<128>(raw, hi, lo, t);
    return;
  }
  if (o.loader != kScalar) {
    split_raw_k<128>(raw, hi, lo, t);
    return;
  }
  float4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = t + i * 256, r = e >> 3, c = e & 7;
    float x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + 4 * c + q;
      x[q] = mn0 + r < o.n && k < K
                 ? base[(mn0 + r) * o.smn + (long long)k * o.sk]
                 : 0.f;
    }
    v[i] = make_float4(x[0], x[1], x[2], x[3]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = t + i * 256;
    split_store(hi, lo, sw(e >> 3, e & 7), v[i].x, v[i].y, v[i].z, v[i].w);
  }
}

// bf16 tile of R rows through registers, 128 rows a pass: f32 rounded to
// bf16 (k-major from vec-k and scalar, mn-major from vec-mn), or bf16
// whose rows cannot feed 16-byte copies (scalar)
template <typename TS, int R>
__device__ __forceinline__ void tile_reg_bf16(const Operand& o,
                                              const TS* base, int mn0, int k0,
                                              int K, uint32_t dst, int t) {
#pragma unroll 1
  for (int pass = 0; pass < R / 128; ++pass) {
    float x[8][8];
    const bool vec = sizeof(TS) == 4 && o.loader != kScalar;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = t + (8 * pass + i) * 128;
      if (vec) {
        const float* fb = reinterpret_cast<const float*>(base);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (o.loader == kVecK) {
            const int r = e >> 3, k = k0 + 8 * (e & 7) + 4 * h;
            if (mn0 + r < o.n && k < K) v = ld4(fb + (mn0 + r) * o.smn + k);
          } else {
            const int k = k0 + e / (R / 8);
            const int mn = mn0 + 8 * (e % (R / 8)) + 4 * h;
            if (k < K && mn < o.n) v = ld4(fb + k * o.sk + mn);
          }
          x[i][4 * h] = v.x;
          x[i][4 * h + 1] = v.y;
          x[i][4 * h + 2] = v.z;
          x[i][4 * h + 3] = v.w;
        }
      } else {
        const int r = e >> 3, c = e & 7;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + 8 * c + j;
          x[i][j] = mn0 + r < o.n && k < K
                        ? lg_to_f(base[(mn0 + r) * o.smn + (long long)k * o.sk])
                        : 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = t + (8 * pass + i) * 128;
      if (vec && o.loader == kVecMN) {
        const int cc = e % (R / 8);
        bf16_store(dst + (cc >> 3) * 8192 + sw(e / (R / 8), cc & 7), x[i]);
      } else {
        bf16_store(dst + sw(e >> 3, e & 7), x[i]);
      }
    }
  }
}

template <int KIND, int TA, int TB>
__global__ void __launch_bounds__(kThreads, 1)
matmul_tc_kernel(const Params p) {
  using C = Cfg<KIND>;
  using TS = typename std::conditional<KIND == kBf16, bf16, float>::type;
  using TC = TS;
  constexpr int S = C::kStages, BK = C::BK, BN = C::BN, NACC = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * S];  // full, empty
  const uint32_t tiles = (lg_smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = lg_smem_u32(bars), empty = full + 8 * S;

  // the tile of this block: groups of kGroupM row tiles, column-major
  // within a group
  const int tile = blockIdx.x, per_group = kGroupM * p.tiles_n;
  const int first = (tile / per_group) * kGroupM;
  const int rows = min(p.tiles_m - first, kGroupM);
  const int m0 = (first + (tile % per_group) % rows) * kBM;
  const int n0 = ((tile % per_group) / rows) * BN;
  const int z = blockIdx.z;
  const long long b1 = z / p.B2, b2 = z % p.B2;
  const int nk = (p.K + BK - 1) / BK;

  ring_init<S>(full, empty);
  __syncthreads();

  if (threadIdx.x >= kProducer) {
    // ---- producer: fill stage kt once its slot is empty ----
    const int t = threadIdx.x - kProducer;
    const TS* ab = static_cast<const TS*>(p.a.p) + b1 * p.a.sb1 + b2 * p.a.sb2;
    const TS* bb = static_cast<const TS*>(p.b.p) + b1 * p.b.sb1 + b2 * p.b.sb2;
    if constexpr (KIND == kF32x3) {
      // raw f32 tiles into the ring by cp.async (an operand with element
      // loads is read by the consumers themselves)
      const float* fa = reinterpret_cast<const float*>(ab);
      const float* fb = reinterpret_cast<const float*>(bb);
      produce<C, false>(
          tiles, full, empty, nk, true, [&](int kt, uint32_t st) {
            raw_tile(p.a, fa, m0, kt * BK, p.K, st, t);
            raw_tile(p.b, fb, n0, kt * BK, p.K, st + kTile, t);
          });
    } else {
      const bool a_async = KIND == kBf16 && p.a.loader <= kAsyncMN;
      const bool b_async = KIND == kBf16 && p.b.loader <= kAsyncMN;
      produce<C, true>(
          tiles, full, empty, nk, a_async && b_async,
          [&](int kt, uint32_t st) {
            const int k0 = kt * BK;
            if (a_async)
              tile_async<kBM>(p.a, reinterpret_cast<const bf16*>(ab), m0, k0,
                              p.K, st, t);
            else
              tile_reg_bf16<TS, kBM>(p.a, ab, m0, k0, p.K, st, t);
            if (b_async)
              tile_async<BN>(p.b, reinterpret_cast<const bf16*>(bb), n0, k0,
                             p.K, st + kTile, t);
            else
              tile_reg_bf16<TS, BN>(p.b, bb, n0, k0, p.K, st + kTile, t);
          });
    }
    return;
  }

  // ---- consumers: 64 rows each ----
  float acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.f;
  if constexpr (KIND == kF32x3) {
    const float* fa = static_cast<const float*>(p.a.p) + b1 * p.a.sb1 +
                      b2 * p.a.sb2;
    const float* fb = static_cast<const float*>(p.b.p) + b1 * p.b.sb1 +
                      b2 * p.b.sb2;
    consume_x3<C>(acc, tiles, full, empty, nk,
                   [&](int kt, uint32_t raw, uint32_t hl) {
                     split_tile(p.a, raw, fa, m0, kt * BK, p.K, hl,
                                hl + kTile, threadIdx.x);
                     split_tile(p.b, raw + kTile, fb, n0, kt * BK, p.K,
                                hl + 2 * kTile, hl + 2 * kTile + C::kBTile,
                                threadIdx.x);
                   });
  } else {
    consume_bf16<TA, TB, C>(acc, tiles, full, empty, nk);
  }

  // ---- epilogue: the accumulators to C, pairs of columns at a time ----
  TC* c = static_cast<TC*>(p.c) + (long long)z * p.M * p.N;
  const bool pairs = (p.N & 1) == 0;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < NACC; e += 2) {
    const int m = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * ((e >> 1) & 1);
    const int n = n0 + 8 * (e >> 2) + 2 * (lane & 3);
    if (m >= p.M || n >= p.N) continue;
    TC* dst = c + (long long)m * p.N + n;
    if (pairs) {
      if constexpr (sizeof(TC) == 4) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[e], acc[e + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst) =
            lg_tc::pack_bf16(acc[e], acc[e + 1]);
      }
    } else {
      dst[0] = lg_from_f<TC>(acc[e]);
      if (n + 1 < p.N) dst[1] = lg_from_f<TC>(acc[e + 1]);
    }
  }
}

template <int KIND, int TA, int TB>
int launch(const Params& p, int batch, cudaStream_t st) {
  auto kernel = matmul_tc_kernel<KIND, TA, TB>;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<KIND>::kSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dim3 grid(p.tiles_m * p.tiles_n, 1, batch);
  kernel<<<grid, kThreads, Cfg<KIND>::kSmem, st>>>(p);
  return (int)cudaGetLastError();
}

// a loader is "mn-major" (read through the transpose bit) when it copies
// along mn into an mn-major tile
inline bool mn_major(int loader) {
  return loader == kAsyncMN || loader == kVecMN;
}

}  // namespace

extern "C" {

// C (batch, M, N) contiguous = A @ B over `batch` = B1 * B2 products;
// element (b1, b2, m, k) of A at b1*sAb1 + b2*sAb2 + m*sAm + k*sAk, and
// likewise for B's (k, n).  Strides in elements.  kind: 0 f32 as three
// tf32 passes, 1 bf16, 2 f32 rounded to bf16 (one pass, f32 out).
// loader_a / loader_b: each operand's loader (0 async-k, 1 async-mn, 2
// vec-k, 3 vec-mn, 4 scalar, 5 elem-k, 6 elem-mn), chosen by ops/matmul.py
// from the strides and alignment.  Returns cudaErrorInvalidValue for what
// the kernel lacks.
int lg_matmul(const void* A, const void* B, void* C, int M, int N, int K,
              int batch, int B2, long long sAb1, long long sAb2,
              long long sAm, long long sAk, long long sBb1, long long sBb2,
              long long sBk, long long sBn, int kind, int loader_a,
              int loader_b, void* stream) {
  const int bn = kind == kF32x3 ? Cfg<kF32x3>::BN : Cfg<kBf16>::BN;
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + bn - 1) / bn;
  if (M < 0 || N < 0 || K < 0 || batch < 1 || batch > 65535 || B2 < 1 ||
      batch % B2 != 0 || kind < 0 || kind > 2 || loader_a < 0 ||
      loader_a > kElemMN || loader_b < 0 || loader_b > kElemMN ||
      (long long)tiles_m * tiles_n > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  // async loaders are bf16's, vec loaders f32's, elem loaders f32x3's
  const bool bf = kind == kBf16;
  for (int l : {loader_a, loader_b})
    if ((l <= kAsyncMN && !bf) || ((l == kVecK || l == kVecMN) && bf) ||
        (l >= kElemK && kind != kF32x3))
      return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  Params p{{A, sAb1, sAb2, sAm, sAk, M, loader_a},
           {B, sBb1, sBb2, sBn, sBk, N, loader_b},
           C, M, N, K, B2, tiles_m, tiles_n};
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == kF32x3) return launch<kF32x3, 0, 0>(p, batch, st);
  const int ta = mn_major(loader_a), tb = mn_major(loader_b);
  if (bf) {
    if (ta && tb) return launch<kBf16, 1, 1>(p, batch, st);
    if (ta) return launch<kBf16, 1, 0>(p, batch, st);
    if (tb) return launch<kBf16, 0, 1>(p, batch, st);
    return launch<kBf16, 0, 0>(p, batch, st);
  }
  if (ta && tb) return launch<kF32Bf16, 1, 1>(p, batch, st);
  if (ta) return launch<kF32Bf16, 1, 0>(p, batch, st);
  if (tb) return launch<kF32Bf16, 0, 1>(p, batch, st);
  return launch<kF32Bf16, 0, 0>(p, batch, st);
}

}  // extern "C"
