// N-D convolution as implicit GEMM on Hopper's tensor cores (the "tc"
// route): forward, input gradient and weight gradient, on the producer /
// consumer `wgmma` ring of csrc/gemm_core.cuh that the tape's matmul runs.
// bf16 takes one wgmma pass; f32 three tf32 passes (hi hi + hi lo + lo hi,
// each stage's products summed from zero and added in f32), the JAX
// package's Precision.HIGHEST in the sense csrc/matmul.cu's f32x3 is.
//
// Replaces kernel 4 of the JAX package, lightgrad_tpu/ops/conv.py: the
// forward (_conv_fwd_impl, :107), the backward (_conv_bwd_impl, :122) and
// the per-group GEMM (_group_matmul, :90), for the calls ops/conv.py
// `conv_route` gives it (every conv of ResNet-18; narrow channel counts
// keep the CUDA-core kernels of csrc/conv.cu).
//
// Layout.  16-byte copies need 16 contiguous bytes of one tap, which NCHW
// does not give (a tap's elements for neighbouring positions are a stride
// apart and start at any kw offset), so the activation operand is staged
// channels-last by lg_conv_layout (a tiled transpose): x as (B, D, H, W,
// G*Cp) for the forward and the weight gradient, dy as (B, OD, OH, OW,
// Cout) for both gradients.  Cp is Cg, or for G == 1 Cin padded with zeros
// to the 16-byte copy width (the stem: 3 -> 4 f32 / 8 bf16 channels, K =
// 49 Cp).  The reduction runs over (kd, kh, kw, c) with c fastest, so each
// 16-byte chunk of a tile row is one tap's channels: the matmul's cp.async
// loaders with a per-row address.  The weight is staged too: (Cout, KK, Cp)
// for the forward, (G, Cg, KK, Og) for the input gradient.  In f32 the
// forward's and the input gradient's operands are staged as their tf32 hi
// and lo parts, which the producer copies straight into the ring (the
// consumers splitting raw tiles took a third of those kernels' time); the
// weight gradient's operands are read mn-major, which tf32 wgmma cannot
// take, so its consumers transpose and split raw tiles (gemm_core.cuh).
// Outputs are written NCHW straight from the accumulator fragments.  Per
// group (grid z), with M rows and N = BN-wide columns:
//
//   fwd  y (B*OS, Og) = patches (B*OS, KK*Cp) @ w^T; A and B k-major.
//   dx   per residue class of the input positions modulo the stride (grid
//        z), gx (class positions, Cg) = dy taps (., taps*Og) @ w: only the
//        taps that reach the class, each position written once, no atomics
//        (a 1x1/s2 projection gives three of four classes no tap: zeros).
//        A (dy rows shifted by the tap, zero outside) and B k-major.
//   dw   gw^T (KK*Cp, Og) = patches^T (KK*Cp, B*OS) @ dy (B*OS, Og): both
//        operands mn-major (bf16 through the transpose bit, f32 through the
//        consumers' 4 x 4 transposes); the producer's 128 threads compute a
//        stage's row offsets into shared memory once.
//
// Splits.  Where the output tiles do not fill the card (few positions at
// ResNet's layer 4; nearly always in dw) grid y splits the reduction into
// ranges of whole stages: each split writes an f32 partial and
// sum_partials_kernel adds them in split order, so a result is the same
// bit for bit on every run (ops/conv.py `conv_splits` plans them).  dw
// always writes partials, as gw^T with its (tap, c) rows contiguous, and
// sum_dw_kernel reorders them to (Cout, Cg, KK) as it sums: the kernel's
// own stores to gw's layout, KK apart, were scattered (2x slower at
// ResNet-18's layer 3 in bf16).
//
// What bounds it on this card: the tensor cores (989 TFLOP/s bf16; f32 as
// three tf32 passes at 495, so 165) at the large layers, and the bytes of
// the staging and of split partials at the small ones.  Measured, a stage
// takes about 4x its wgmma time, as in the matmul (the tile's bytes from
// L2; no TMA or clusters yet).  Offsets are 32-bit: the wrapper routes
// tensors of 2^31 elements or more to the CUDA cores.
#include <type_traits>

#include "conv_common.cuh"
#include "gemm_core.cuh"

namespace {

using namespace lg_gemm;

enum View { kFwd = 0, kDx = 1, kDw = 2 };

struct Params {
  // fwd, dw: x staged (B, D, H, W, G*Cp); dx: dy staged (B, OD, OH, OW,
  // Cout); f32 fwd and dx: its tf32 hi part, a_lo its lo part
  const void* a;
  const void* a_lo;
  // fwd: w staged (Cout, KK, Cp); dx: w staged (G, Cg, KK, Og); dw: dy
  // staged (B*OS, Cout); b_lo as a_lo
  const void* b;
  const void* b_lo;
  // fwd and dx with splits 1: y / gx in the input type; else f32
  // partials, split s at s * part_numel (dw: gw^T, (Cout, KK, Cp))
  void* out;
  Geom g;
  int Cp;                  // staged channels of a group of x
  int M, N, K;             // a group's GEMM (dx: the largest class's M)
  int tiles_m, splits;
  long long part_numel;
};

// (kd, kh, kw) of tap index `tap` in (KD, KH, KW) order
__device__ __forceinline__ void tap_of(const Geom& g, int tap, int& kd,
                                       int& kh, int& kw) {
  kw = tap % g.KW;
  const int q = tap / g.KW;
  kh = q % g.KH;
  kd = q / g.KH;
}

// offset in staged x of output position r's window origin
__device__ __forceinline__ int window_of(const Geom& g, int r, int Ct) {
  const int OS = g.OD * g.OH * g.OW;
  const int b = r / OS, s = r - b * OS;
  const int ow = s % g.OW, q = s / g.OW;
  const int oh = q % g.OH, od = q / g.OH;
  return (((b * g.D + od * g.sd) * g.H + oh * g.sh) * g.W + ow * g.sw) * Ct;
}

// offset in staged x of tap `tap` from a window's origin
__device__ __forceinline__ int tap_offset(const Geom& g, int tap, int Ct) {
  int kd, kh, kw;
  tap_of(g, tap, kd, kh, kw);
  return ((kd * g.dd * g.H + kh * g.dh) * g.W + kw * g.dw) * Ct;
}

// shared address of chunk c (16 bytes) of row r of a k-major tile (the
// forward's and input gradient's: wgmma reads them as they land)
__device__ __forceinline__ uint32_t at_k(uint32_t tile, int r, int c) {
  return tile + sw(r, c);
}

// shared address of chunk c of k-row kr of an mn-major tile of R columns
template <int KIND, int R>
__device__ __forceinline__ uint32_t at_mn(uint32_t tile, int kr, int c) {
  return tile + (KIND == kBf16 ? (c >> 3) * 8192 + sw(kr, c & 7)
                               : raw_mn_at<R>(kr, c));
}

// The rings of gemm_core.cuh's Cfg, but for f32x3 (the f32 weight gradient)
// at N 64 a ring of 5 with 3 stages in flight (at ResNet-18's layer 1 it
// ran 10% faster on the H100; deeper bf16 rings ran no faster, and at N 64
// cost the second block an SM)
template <int KIND, int BN>
using ConvCfg = Cfg<KIND, BN,
                    KIND == kF32x3   ? (BN == 64 ? 5 : 3)
                    : KIND == kTf32HL ? (BN == 64 ? 4 : 3)
                                      : 4,
                    KIND == kF32x3 && BN == 64 ? 3 : 2>;

template <typename T>
__device__ __forceinline__ void copy16(uint32_t dst, const T* base, int off,
                                       bool ok) {
  lg_cp_async16(dst, ok ? base + off : base, ok ? 16 : 0);
}

template <int KIND, int BN, int VIEW>
__global__ void __launch_bounds__(kThreads, 1)
conv_tc_kernel(const Params p) {
  using C = ConvCfg<KIND, BN>;
  using T = typename std::conditional<KIND == kBf16, bf16, float>::type;
  constexpr int S = C::kStages, BK = C::BK, NACC = BN / 2;
  // f32 takes tf32 hi / lo operands in the forward and the input gradient
  // and splits raw ones in the weight gradient
  static_assert((KIND == kBf16) || (KIND == kF32x3) == (VIEW == kDw),
                "f32 views and kinds");
  constexpr bool HL = KIND == kTf32HL;
  // the B tile's place in a stage; a lo tile follows its hi tile
  constexpr uint32_t kB = HL ? 2 * kTile : kTile;
  constexpr int W = 16 / sizeof(T);        // elements a 16-byte chunk
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * S];  // full, empty
  __shared__ int rowoff[2][BK];   // dw: a stage's window offsets in x
  const uint32_t tiles = (lg_smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = lg_smem_u32(bars), empty = full + 8 * S;

  const Geom& g = p.g;
  const int Cg = g.Cin / g.G, Og = g.Cout / g.G;
  const int KK = g.KD * g.KH * g.KW, Ct = g.G * p.Cp;
  const int OS = g.OD * g.OH * g.OW, HWD = g.D * g.H * g.W;
  const int m0 = (blockIdx.x % p.tiles_m) * kBM;
  const int n0 = (blockIdx.x / p.tiles_m) * BN;
  const int split = blockIdx.y;

  // dx: this block's residue class, its taps and positions
  int grp = blockIdx.z, M = p.M, K = p.K;
  int rd = 0, rh = 0, rw = 0, CH = 1, CW = 1, CS = 1;
  Taps td{0, 1, 1}, th{0, 1, 1}, tw{0, 1, 1};
  if constexpr (VIEW == kDx) {
    const int ncls = g.sd * g.sh * g.sw, cls = blockIdx.z % ncls;
    grp = blockIdx.z / ncls;
    rw = cls % g.sw;
    rh = (cls / g.sw) % g.sh;
    rd = cls / (g.sw * g.sh);
    const int CD = (g.D - rd + g.sd - 1) / g.sd;
    CH = (g.H - rh + g.sh - 1) / g.sh;
    CW = (g.W - rw + g.sw - 1) / g.sw;
    CS = CD * CH * CW;
    M = g.B * CS;
    if (m0 >= M) return;   // a smaller class than the first: block idle
    td = taps_for(rd, g.KD, g.sd, g.dd);
    th = taps_for(rh, g.KH, g.sh, g.dh);
    tw = taps_for(rw, g.KW, g.sw, g.dw);
    K = td.n * th.n * tw.n * Og;
  }
  // this split's range of stages
  const int nk_all = (K + BK - 1) / BK;
  const int per = (nk_all + p.splits - 1) / p.splits;
  const int kt0 = split * per;
  const int nk = max(0, min(nk_all, kt0 + per) - kt0);

  ring_init<S>(full, empty);
  __syncthreads();

  if (threadIdx.x >= kProducer) {
    // ---- producer ----
    const int t = threadIdx.x - kProducer;
    const T* as = static_cast<const T*>(p.a);
    const T* bs = static_cast<const T*>(p.b);
    const T* as_lo = static_cast<const T*>(p.a_lo);
    const T* bs_lo = static_cast<const T*>(p.b_lo);
    if constexpr (VIEW == kFwd) {
      // A: rows (t >> 3) + 16 i, chunk t & 7; B the same over BN rows
      const int c = t & 7;
      int xo[8], wo[BN / 16];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + (t >> 3) + 16 * i;
        xo[i] = m < M ? window_of(g, m, Ct) + grp * p.Cp : -1;
      }
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        const int n = n0 + (t >> 3) + 16 * i;
        wo[i] = n < Og ? (grp * Og + n) * K : -1;
      }
      produce<C, KIND != kF32x3>(
          tiles, full, empty, nk, true, [&](int kt, uint32_t st) {
            const int k = (kt0 + kt) * BK + c * W;
            const bool kok = k < K;
            const int tap = k / p.Cp;
            const int toff = tap_offset(g, tap, Ct) + (k - tap * p.Cp);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const uint32_t d = at_k(st, (t >> 3) + 16 * i, c);
              copy16(d, as, xo[i] + toff, kok && xo[i] >= 0);
              if (HL) copy16(d + kTile, as_lo, xo[i] + toff, kok && xo[i] >= 0);
            }
#pragma unroll
            for (int i = 0; i < BN / 16; ++i) {
              const uint32_t d = at_k(st + kB, (t >> 3) + 16 * i, c);
              copy16(d, bs, wo[i] + k, kok && wo[i] >= 0);
              if (HL) copy16(d + C::kBTile, bs_lo, wo[i] + k, kok && wo[i] >= 0);
            }
          });
    } else if constexpr (VIEW == kDx) {
      // A: class positions (b, i, j, l) -> dy at (i, j, l) - q(tap)
      const int c = t & 7;
      int go[8], pi[8], pj[8], pl[8], wo[BN / 16];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + (t >> 3) + 16 * i;
        const int b = m / CS, s = m - b * CS;
        pl[i] = s % CW;
        pj[i] = (s / CW) % CH;
        pi[i] = s / (CW * CH);
        go[i] = m < M ? (((b * g.OD + pi[i]) * g.OH + pj[i]) * g.OW + pl[i]) *
                            g.Cout + grp * Og
                      : -1;
      }
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        const int n = n0 + (t >> 3) + 16 * i;
        wo[i] = n < Cg ? (grp * Cg + n) * KK * Og : -1;
      }
      produce<C, KIND != kF32x3>(
          tiles, full, empty, nk, true, [&](int kt, uint32_t st) {
            const int k = (kt0 + kt) * BK + c * W;
            const bool kok = k < K;
            // column k = (class tap jt, o)
            const int jt = k / Og, o = k - jt * Og;
            const int jw = jt % tw.n, jh = (jt / tw.n) % th.n;
            const int jd = jt / (tw.n * th.n);
            const int kd = td.k0 + jd * td.p, kh = th.k0 + jh * th.p;
            const int kw = tw.k0 + jw * tw.p;
            const int qd = (kd * g.dd - rd) / g.sd;
            const int qh = (kh * g.dh - rh) / g.sh;
            const int qw = (kw * g.dw - rw) / g.sw;
            const int aoff = o - ((qd * g.OH + qh) * g.OW + qw) * g.Cout;
            const int boff = ((kd * g.KH + kh) * g.KW + kw) * Og + o;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const bool ok = kok && go[i] >= 0 && pi[i] >= qd &&
                              pi[i] - qd < g.OD && pj[i] >= qh &&
                              pj[i] - qh < g.OH && pl[i] >= qw &&
                              pl[i] - qw < g.OW;
              const uint32_t d = at_k(st, (t >> 3) + 16 * i, c);
              copy16(d, as, go[i] + aoff, ok);
              if (HL) copy16(d + kTile, as_lo, go[i] + aoff, ok);
            }
#pragma unroll
            for (int i = 0; i < BN / 16; ++i) {
              const uint32_t d = at_k(st + kB, (t >> 3) + 16 * i, c);
              copy16(d, bs, wo[i] + boff, kok && wo[i] >= 0);
              if (HL) copy16(d + C::kBTile, bs_lo, wo[i] + boff, kok && wo[i] >= 0);
            }
          });
    } else {
      // dw.  A (patches^T, mn-major 128 columns m = (tap, c)): chunk t % CA
      // of k-rows t / CA + RA i; B (dy, mn-major BN columns o) likewise
      constexpr int CA = 128 / W, RA = 128 / CA;
      constexpr int CB = BN / W, RB = 128 / CB, NB = BK / RB;
      const int R = g.B * OS;
      const int ma = m0 + (t % CA) * W, ob = n0 + (t % CB) * W;
      const int tapa = ma / p.Cp;
      const int colo = tap_offset(g, tapa, Ct) + grp * p.Cp + ma - tapa * p.Cp;
      const bool aok = ma < M, bok = ob < Og;
      produce<C, KIND != kF32x3>(
          tiles, full, empty, nk, true, [&](int kt, uint32_t st) {
            const int r0 = (kt0 + kt) * BK;
            int* rows = rowoff[kt & 1];
            if (t < BK) rows[t] = r0 + t < R ? window_of(g, r0 + t, Ct) : -1;
            producer_sync();
#pragma unroll
            for (int i = 0; i < BK / RA; ++i) {
              const int kr = t / CA + RA * i;
              copy16(at_mn<KIND, 128>(st, kr, t % CA), as, rows[kr] + colo,
                     aok && rows[kr] >= 0);
            }
#pragma unroll
            for (int i = 0; i < NB; ++i) {
              const int kr = t / CB + RB * i;
              copy16(at_mn<KIND, BN>(st + kTile, kr, t % CB), bs,
                     (r0 + kr) * g.Cout + grp * Og + ob,
                     bok && r0 + kr < R);
            }
          });
    }
    return;
  }

  // ---- consumers: 64 rows each ----
  float acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.f;
  constexpr int TT = VIEW == kDw;   // both operands mn-major
  if constexpr (KIND == kF32x3) {
    // the weight gradient's raw mn-major f32 tiles, transposed as split
    consume_x3<C>(acc, tiles, full, empty, nk,
                  [&](int, uint32_t raw, uint32_t hl) {
                    const uint32_t bhi = hl + 2 * kTile;
                    split_raw_mn<128>(raw, hl, hl + kTile, threadIdx.x);
                    split_raw_mn<BN>(raw + kTile, bhi, bhi + C::kBTile,
                                     threadIdx.x);
                  });
  } else if constexpr (HL) {
    consume_hl<C>(acc, tiles, full, empty, nk);
  } else {
    consume_bf16<TT, TT, C>(acc, tiles, full, empty, nk);
  }

  // ---- epilogue: NCHW y / gx, or an f32 partial (dw: always, as gw^T
  // with the (tap, c) rows contiguous; sum_dw_kernel reorders it) ----
  T* out = static_cast<T*>(p.out);
  float* part = static_cast<float*>(p.out) + split * p.part_numel;
  auto put = [&](int idx, float v) {
    if (VIEW != kDw && p.splits == 1)
      out[idx] = lg_from_f<T>(v);
    else
      part[idx] = v;
  };
  // each thread's two rows: the output offset of channel 0 (-1: none) and
  // the stride between channels
  int base[2], cstride, nmax;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + acc_row(h);
    if constexpr (VIEW == kFwd) {
      const int b = m / OS, s = m - b * OS;
      base[h] = m < M ? (b * g.Cout + grp * Og) * OS + s : -1;
    } else if constexpr (VIEW == kDx) {
      const int b = m / CS, s = m - b * CS;
      const int l = s % CW, j = (s / CW) % CH, i = s / (CW * CH);
      base[h] = m < M ? (b * g.Cin + grp * Cg) * HWD +
                            ((rd + g.sd * i) * g.H + rh + g.sh * j) * g.W +
                            rw + g.sw * l
                      : -1;
    } else {
      base[h] = m < M ? grp * Og * M + m : -1;
    }
  }
  if constexpr (VIEW == kFwd) {
    cstride = OS;
    nmax = Og;
  } else if constexpr (VIEW == kDx) {
    cstride = HWD;
    nmax = Cg;
  } else {
    cstride = M;
    nmax = Og;
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < NACC; e += 2) {
    const int h = (e >> 1) & 1, n = n0 + 8 * (e >> 2) + 2 * (lane & 3);
    if (base[h] < 0 || n >= nmax) continue;
    put(base[h] + n * cstride, acc[e]);
    if (n + 1 < nmax) put(base[h] + (n + 1) * cstride, acc[e + 1]);
  }
}

// Element i of the staging's outputs: v into `out`, and for f32 its tf32 hi
// and lo parts into `hi` and `lo` (each output may be absent)
template <typename T>
__device__ __forceinline__ void put_staged(T* out, float* hi, float* lo,
                                           long long i, T v) {
  if (out) out[i] = v;
  if constexpr (std::is_same<T, float>::value) {
    if (hi) {
      const uint32_t h = lg_tc::tf32_rne(v);
      hi[i] = __uint_as_float(h);
      lo[i] = __uint_as_float(lg_tc::tf32_rne(v - __uint_as_float(h)));
    }
  }
}

// out[b][c][r] = in[b][r][c] for r < R, zero for R <= r < P (c < C): one
// 32 x 32 tile a block through shared memory
template <typename T>
__global__ void layout_kernel(const T* __restrict__ in, T* __restrict__ out,
                              float* __restrict__ hi, float* __restrict__ lo,
                              int R, int C, int P) {
  __shared__ T tile[32][33];
  const long long b = blockIdx.z;
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    tile[i][tx] = r < R && c < C ? in[(b * R + r) * C + c] : lg_from_f<T>(0.f);
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    if (c < C && r < P) put_staged(out, hi, lo, (b * C + c) * P + r, tile[tx][i]);
  }
}

// the same where a row of the output is one 16-byte chunk (P = 16 bytes:
// a padded stem's channels): a thread an output row, one 16-byte store a
// staged tensor (the general tile would read 3 of its 32 rows: 5.9-7.8x
// slower at ResNet-18's stem, scripts/ab_conv.py --staging)
template <typename T>
__global__ void layout_chunk_kernel(const T* __restrict__ in,
                                    T* __restrict__ out,
                                    float* __restrict__ hi,
                                    float* __restrict__ lo, int R, int C,
                                    long long rows) {
  constexpr int P = 16 / sizeof(T);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < rows; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / C;
    const int c = (int)(i - b * C);
    __align__(16) T v[P];
#pragma unroll
    for (int r = 0; r < P; ++r)
      v[r] = r < R ? in[(b * R + r) * C + c] : lg_from_f<T>(0.f);
    if (out)
      *reinterpret_cast<uint4*>(out + i * P) = *reinterpret_cast<uint4*>(v);
    if constexpr (std::is_same<T, float>::value) {
      if (hi) {
        __align__(16) float h[P], l[P];
#pragma unroll
        for (int r = 0; r < P; ++r) {
          h[r] = __uint_as_float(lg_tc::tf32_rne(v[r]));
          l[r] = __uint_as_float(lg_tc::tf32_rne(v[r] - h[r]));
        }
        *reinterpret_cast<uint4*>(hi + i * P) = *reinterpret_cast<uint4*>(h);
        *reinterpret_cast<uint4*>(lo + i * P) = *reinterpret_cast<uint4*>(l);
      }
    }
  }
}

// the same where rows of the input are short (C < 32: a weight's taps): a
// thread an output element, the stores coalesced (the general tile would
// read 9 or 1 of its 32 columns: 1.3-1.5x slower over ResNet-18's
// forward weights)
template <typename T>
__global__ void layout_short_kernel(const T* __restrict__ in,
                                    T* __restrict__ out,
                                    float* __restrict__ hi,
                                    float* __restrict__ lo, int R, int C,
                                    int P, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / P;
    const int r = (int)(i - row * P);
    const long long b = row / C;
    const int c = (int)(row - b * C);
    put_staged(out, hi, lo, i,
               r < R ? in[(b * R + r) * C + c] : lg_from_f<T>(0.f));
  }
}

template <int KIND, int BN, int VIEW>
int launch(const Params& p, int groups, cudaStream_t st) {
  auto kernel = conv_tc_kernel<KIND, BN, VIEW>;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ConvCfg<KIND, BN>::kSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int tiles_n = (p.N + BN - 1) / BN;
  dim3 grid(p.tiles_m * tiles_n, p.splits, groups);
  kernel<<<grid, kThreads, ConvCfg<KIND, BN>::kSmem, st>>>(p);
  return (int)cudaGetLastError();
}

template <int KIND, int VIEW>
int launch_bn(const Params& p, int bn, int groups, cudaStream_t st) {
  if (bn == 64) return launch<KIND, 64, VIEW>(p, groups, st);
  if (bn == 128) return launch<KIND, 128, VIEW>(p, groups, st);
  if constexpr (KIND == kBf16)
    if (bn == 256) return launch<KIND, 256, VIEW>(p, groups, st);
  return (int)cudaErrorInvalidValue;
}

// bf16 in every view; f32 as tf32 hi / lo operands in the forward and the
// input gradient, raw in the weight gradient
int launch_view(const Params& p, int view, int bn, int groups, bool bf,
                cudaStream_t st) {
  if (view == kFwd)
    return bf ? launch_bn<kBf16, kFwd>(p, bn, groups, st)
              : launch_bn<kTf32HL, kFwd>(p, bn, groups, st);
  if (view == kDx)
    return bf ? launch_bn<kBf16, kDx>(p, bn, groups, st)
              : launch_bn<kTf32HL, kDx>(p, bn, groups, st);
  return bf ? launch_bn<kBf16, kDw>(p, bn, groups, st)
            : launch_bn<kF32x3, kDw>(p, bn, groups, st);
}

constexpr long long kMax32 = 0x7FFFFFFFLL;

// gw (Cout, Cg, KK) = the weight gradient's partials (splits, Cout, KK, Cp)
// summed in split order, the padded channels dropped
template <typename T>
__global__ void sum_dw_kernel(const float* __restrict__ part,
                              T* __restrict__ out, long long n, int splits,
                              int Cg, int KK, int Cp) {
  const int M = KK * Cp;
  const long long pn = n / ((long long)Cg * KK) * M;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long o = i / ((long long)Cg * KK);
    const int rem = (int)(i - o * Cg * KK), c = rem / KK, tap = rem - c * KK;
    const long long src = o * M + (long long)tap * Cp + c;
    float s = 0.f;
    for (int q = 0; q < splits; ++q) s += part[q * pn + src];
    out[i] = lg_from_f<T>(s);
  }
}

// lg_conv_layout's launch for element type T
template <typename T>
int layout(const T* in, T* out, float* hi, float* lo, int nb, int R, int C,
           int P, cudaStream_t st) {
  if (P * (int)sizeof(T) == 16) {
    const long long rows = (long long)nb * C;
    const int blocks = (int)((rows + 255) / 256 < 16384 ? (rows + 255) / 256
                                                        : 16384);
    layout_chunk_kernel<T><<<blocks, 256, 0, st>>>(in, out, hi, lo, R, C,
                                                   rows);
  } else if (C < 32) {
    const long long n = (long long)nb * C * P;
    const int blocks = (int)((n + 255) / 256 < 16384 ? (n + 255) / 256
                                                     : 16384);
    layout_short_kernel<T><<<blocks, 256, 0, st>>>(in, out, hi, lo, R, C, P,
                                                   n);
  } else {
    if ((P + 31) / 32 > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((C + 31) / 32, (P + 31) / 32, nb), block(32, 8);
    layout_kernel<T><<<grid, block, 0, st>>>(in, out, hi, lo, R, C, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tensor-core convolution `view` (0 forward, 1 input gradient, 2
// weight gradient) of staged operands (see Params; `geom` the 19 ints of
// csrc/conv_common.cuh) into `out` (y, gx or gw in the input type).  f32
// forward and input gradient take each operand as tf32 hi and lo parts
// (a / a_lo, b / b_lo); every other call raw operands and null lo.  Cp:
// the staged channels of a group of x (fwd, dw; Cg, or Cin padded when
// G == 1).  bn: the tile width (64, 128; 256 in bf16).  splits > 1: the
// reduction is split over `part` (f32, splits * out's elements) and summed
// in order into out; the weight gradient always goes through `part`
// (splits * Cout * KK * Cp).  Returns cudaErrorInvalidValue for what the
// kernels lack.
int lg_conv_tc(int view, const void* a, const void* a_lo, const void* b,
               const void* b_lo, void* out, void* part, const int* geom,
               int Cp, int bn, int splits, int is_bf16, void* stream) {
  Geom g;
  const bool hl = !is_bf16 && view != kDw;
  if (!geom_of(geom, &g) || view < kFwd || view > kDw || splits < 1 ||
      splits > 65535 || (a_lo != nullptr) != hl || (b_lo != nullptr) != hl ||
      (part == nullptr) != (splits == 1 && view != kDw))
    return (int)cudaErrorInvalidValue;
  const int w = is_bf16 ? 8 : 4;
  const int Cg = g.Cin / g.G, Og = g.Cout / g.G;
  const long long KK = (long long)g.KD * g.KH * g.KW;
  const long long OS = (long long)g.OD * g.OH * g.OW;
  const long long S = (long long)g.D * g.H * g.W;
  if (Cp % w || Cp < Cg || (g.G > 1 && Cp != Cg) || Og % w)
    return (int)cudaErrorInvalidValue;
  // 32-bit offsets: every operand, staged or not, under 2^31 elements
  const long long sizes[] = {g.B * S * g.G * Cp, g.B * OS * g.Cout,
                             g.B * S * g.Cin, g.Cout * KK * Cp,
                             (long long)g.Cout * Cg * KK};
  for (long long n : sizes)
    if (n > kMax32) return (int)cudaErrorInvalidValue;
  Params p{};
  p.a = a;
  p.a_lo = a_lo;
  p.b = b;
  p.b_lo = b_lo;
  p.g = g;
  p.Cp = Cp;
  p.splits = splits;
  long long M, N, K;
  int groups = g.G;
  if (view == kFwd) {
    M = g.B * OS, N = Og, K = KK * Cp;
    p.part_numel = g.B * OS * g.Cout;
  } else if (view == kDx) {
    // the largest class is the first: ceil(D/sd) x ceil(H/sh) x ceil(W/sw)
    M = (long long)g.B * ((g.D + g.sd - 1) / g.sd) *
        ((g.H + g.sh - 1) / g.sh) * ((g.W + g.sw - 1) / g.sw);
    N = Cg, K = KK * Og;
    groups *= g.sd * g.sh * g.sw;
    p.part_numel = g.B * S * g.Cin;
  } else {
    M = KK * Cp, N = Og, K = g.B * OS;
    p.part_numel = g.Cout * M;
  }
  const long long tiles_m = (M + kBM - 1) / kBM;
  if (bn != 64 && bn != 128 && !(bn == 256 && is_bf16))
    return (int)cudaErrorInvalidValue;
  if (tiles_m * ((N + bn - 1) / bn) > kMax32 || groups > 65535 ||
      splits * p.part_numel > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  p.M = (int)M, p.N = (int)N, p.K = (int)K;
  p.tiles_m = (int)tiles_m;
  p.out = part ? part : out;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_view(p, view, bn, groups, is_bf16, st);
  if (err || !part) return err;
  const long long n = view == kDw ? (long long)g.Cout * Cg * KK
                                  : p.part_numel;
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  if (view == kDw) {
    if (is_bf16)
      sum_dw_kernel<bf16><<<blocks, 256, 0, st>>>(
          (const float*)part, (bf16*)out, n, splits, Cg, (int)KK, Cp);
    else
      sum_dw_kernel<float><<<blocks, 256, 0, st>>>(
          (const float*)part, (float*)out, n, splits, Cg, (int)KK, Cp);
  } else if (is_bf16) {
    sum_partials_kernel<bf16><<<blocks, 256, 0, st>>>(
        (const float*)part, (bf16*)out, n, splits);
  } else {
    sum_partials_kernel<float><<<blocks, 256, 0, st>>>(
        (const float*)part, (float*)out, n, splits);
  }
  return (int)cudaGetLastError();
}

// Staging for the tensor-core convolutions: out (nb, C, P) from in (nb, R,
// C), out[b][c][r] = in[b][r][c] for r < R and zero for R <= r < P.
// NCHW -> channels-last is (B, Cin, S) -> (B, S, P); the weight (Cout, Cg,
// KK) -> (Cout, KK, Cp) and (G, Og, Cg*KK) -> (G, Cg*KK, Og).  f32 may
// also (or instead: out null) write the tf32 hi and lo parts, hi = tf32(v)
// and lo = tf32(v - hi), to `hi` and `lo` (both null, or both not).
int lg_conv_layout(const void* in, void* out, void* hi, void* lo, int nb,
                   int R, int C, int P, int is_bf16, void* stream) {
  if (nb < 1 || R < 1 || C < 1 || P < R || nb > 65535 ||
      (long long)nb * C * P > kMax32 || (long long)nb * R * C > kMax32 ||
      (hi == nullptr) != (lo == nullptr) || (is_bf16 && hi) ||
      (out == nullptr && hi == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return layout((const bf16*)in, (bf16*)out, nullptr, nullptr, nb, R, C, P,
                  st);
  return layout((const float*)in, (float*)out, (float*)hi, (float*)lo, nb, R,
                C, P, st);
}

}  // extern "C"
