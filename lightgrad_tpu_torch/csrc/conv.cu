// N-D convolution as implicit GEMM on the CUDA cores (the "simt" route):
// forward, input gradient and weight gradient, f32 accumulation, for the
// calls whose channel counts do not fill the tensor-core route of
// csrc/conv_tc.cu (ops/conv.py `conv_route`: MNIST's CNN, ResNet-20's
// 16-channel layers, depthwise and other narrow groups).
//
// Replaces kernel 4 of the JAX package, lightgrad_tpu/ops/conv.py: the
// forward (_conv_fwd_impl, :107), the backward (_conv_bwd_impl, :122) and
// the per-group GEMM (_group_matmul, :90).  On the TPU these build a patch
// matrix with XLA slices, feed it to the Pallas GEMM (ops/matmul.py:112)
// and scatter-add the input gradient back tap by tap.  Here no patch matrix
// exists in device memory: each tile load gathers its patch elements from x
// (or from the output gradient) through an offset that separates into a
// row part, fixed for a thread, and a column part, computed once a K slice
// into shared memory.  A grid dimension walks the groups.
//
// Layouts (contiguous, csrc/conv_common.cuh): x (B, Cin, D, H, W), w (Cout,
// Cin/G, KD, KH, KW), y (B, Cout, OD, OH, OW).  With G groups, Cg = Cin/G,
// Og = Cout/G, KK = KD*KH*KW, per group:
//
//   conv_fwd     y  (B*OS, Og) = patches (B*OS, Cg*KK) @ w^T
//   conv_bwd_dx  gx (B*S, Cg)  = dy taps (B*S, Og*taps) @ w
//                The input positions are split by their residue modulo the
//                stride.  Within one class the same taps reach every
//                position, so each class is a dense GEMM over only those
//                taps: a 3x3/s2 conv has 4, 2, 2 or 1 tap a position, not
//                9, and a 1x1/s2 projection gives three of four classes no
//                tap (they store zeros).  Each position is written once: no
//                atomics.
//   conv_bwd_dw  gw (Og, Cg*KK) = dy^T (Og, B*OS) @ patches (B*OS, Cg*KK)
//                The reduction over B*OS into few outputs is split across
//                blocks into f32 partial tiles, which a second kernel sums
//                in a fixed order: deterministic, no atomics.
//
// What bounds it on this card: the f32 FFMA rate and shared-memory
// bandwidth: a 64 x 64 output tile per 256-thread block, 4 x 4 outputs a
// thread, 16-deep K slices staged in shared memory as f32 (bf16 inputs sum
// in f32 and round once on the store).  K = Cg*KK that is no multiple of 16
// (9 for MNIST's first conv) is masked, never padded.  Element offsets are
// 64-bit.
#include "conv_common.cuh"

namespace {


constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;
constexpr int kPad = 4;  // keeps rows 16-byte aligned, spreads banks
constexpr int kMaxGrid = 65535;

// acc += As^T Bs over one K slice: rows ty*4.., columns tx*4..
__device__ __forceinline__ void tile_fma(float (*As)[kBM + kPad],
                                         float (*Bs)[kBN + kPad], int tx,
                                         int ty, float (&acc)[4][4]) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Offset in x of patch column k = (c, kd, kh, kw) from the window's origin.
__device__ __forceinline__ long long patch_col(const Geom& g, int k, int KK,
                                               long long HW, long long DHW) {
  const int c = k / KK;
  int r = k - c * KK;
  const int kw = r % g.KW;
  r /= g.KW;
  const int kh = r % g.KH, kd = r / g.KH;
  return c * DHW + (long long)kd * g.dd * HW + (long long)kh * g.dh * g.W +
         (long long)kw * g.dw;
}

// ---------------------------------------------------------------------------
// forward: grid (M tiles, Og tiles, G)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ y, Geom g) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ long long koff[kBK];

  const int grp = blockIdx.z;
  const int Cg = g.Cin / g.G, Og = g.Cout / g.G;
  const int KK = g.KD * g.KH * g.KW, K = Cg * KK;
  const long long HW = (long long)g.H * g.W, DHW = g.D * HW;
  const long long OS = (long long)g.OD * g.OH * g.OW, M = g.B * OS;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  // A loads: one output position (row m0 + am) a thread, at k = ak + 4r;
  // neighbouring threads read neighbouring positions of x
  const int am = t % kBM, ak = t / kBM;
  const long long gm = m0 + am;
  const bool m_ok = gm < M;
  long long xbase = 0;
  if (m_ok) {
    const long long b = gm / OS, s = gm % OS;
    const int ow = (int)(s % g.OW);
    const long long q = s / g.OW;
    const int oh = (int)(q % g.OH), od = (int)(q / g.OH);
    xbase = (b * g.Cin + (long long)grp * Cg) * DHW +
            (long long)od * g.sd * HW + (long long)oh * g.sh * g.W +
            (long long)ow * g.sw;
  }
  // B loads: output channel bn + 16r of the tile at k = bk; a weight row is
  // contiguous along k
  const int bk = t % kBK, bn = t / kBK;
  const T* wg = w + (long long)grp * Og * K;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    if (t < kBK)
      koff[t] = k0 + t < K ? patch_col(g, k0 + t, KK, HW, DHW) : 0;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int k = ak + r * (kThreads / kBM);
      As[k][am] = (m_ok && k0 + k < K) ? lg_to_f(x[xbase + koff[k]]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBK * kBN / kThreads; ++r) {
      const int n = bn + r * (kThreads / kBK);
      const int gn = n0 + n, gk = k0 + bk;
      Bs[bk][n] = (gn < Og && gk < K)
                      ? lg_to_f(wg[(long long)gn * K + gk]) : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const long long b = m / OS, s = m % OS;
    T* yrow = y + (b * g.Cout + (long long)grp * Og) * OS + s;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Og) yrow[n * OS] = lg_from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// input gradient: grid (class M tiles, Cg tiles, G * stride classes)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bwd_dx_kernel(const T* __restrict__ gy, const T* __restrict__ w,
                   T* __restrict__ gx, Geom g) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ long long goff[kBK];
  __shared__ int woff[kBK], qd_s[kBK], qh_s[kBK], qw_s[kBK];

  const int ncls = g.sd * g.sh * g.sw;
  const int grp = blockIdx.z / ncls, cls = blockIdx.z % ncls;
  const int rw = cls % g.sw, rh = (cls / g.sw) % g.sh,
            rd = cls / (g.sw * g.sh);
  const int Cg = g.Cin / g.G, Og = g.Cout / g.G;
  const int KK = g.KD * g.KH * g.KW;
  const long long HW = (long long)g.H * g.W, DHW = g.D * HW;
  const long long OHW = (long long)g.OH * g.OW, OS = g.OD * OHW;
  // this class's positions (rd + sd*i, rh + sh*j, rw + sw*l)
  const int CD = (g.D - rd + g.sd - 1) / g.sd;
  const int CH = (g.H - rh + g.sh - 1) / g.sh;
  const int CW = (g.W - rw + g.sw - 1) / g.sw;
  const long long CS = (long long)CD * CH * CW, Mc = g.B * CS;
  const long long m0 = (long long)blockIdx.x * kBM;
  if (m0 >= Mc) return;  // a smaller class than the first: whole block idle
  const Taps td = taps_for(rd, g.KD, g.sd, g.dd);
  const Taps th = taps_for(rh, g.KH, g.sh, g.dh);
  const Taps tw = taps_for(rw, g.KW, g.sw, g.dw);
  const int ntap = td.n * th.n * tw.n, K = Og * ntap;
  const int n0 = blockIdx.y * kBN;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  // A loads: one input position (row m0 + am) a thread, at k = ak + 4r
  const int am = t % kBM, ak = t / kBM;
  const long long gm = m0 + am;
  const bool m_ok = gm < Mc;
  int pi = 0, pj = 0, pl = 0;
  long long gbase = 0;
  if (m_ok) {
    const long long b = gm / CS;
    long long s = gm % CS;
    pl = (int)(s % CW);
    s /= CW;
    pj = (int)(s % CH);
    pi = (int)(s / CH);
    gbase = (b * g.Cout + (long long)grp * Og) * OS + (long long)pi * OHW +
            (long long)pj * g.OW + pl;
  }
  // B loads: input channel n0 + bn at k = bk + 4r
  const int bn = t % kBN, bk = t / kBN;
  const T* wg = w + (long long)grp * Og * Cg * KK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    if (t < kBK) {
      // column k = (o, tap): dy at (od, oh, ow) = (i - qd, j - qh, l - qw)
      const int k = k0 + t;
      long long go = 0;
      int wo = 0, qd = 0, qh = 0, qw = 0;
      if (k < K) {
        const int o = k / ntap;
        int r = k - o * ntap;
        const int jw = r % tw.n;
        r /= tw.n;
        const int jh = r % th.n, jd = r / th.n;
        const int kd = td.k0 + jd * td.p, kh = th.k0 + jh * th.p,
                  kw = tw.k0 + jw * tw.p;
        qd = (kd * g.dd - rd) / g.sd;
        qh = (kh * g.dh - rh) / g.sh;
        qw = (kw * g.dw - rw) / g.sw;
        go = o * OS - qd * OHW - (long long)qh * g.OW - qw;
        wo = o * Cg * KK + (kd * g.KH + kh) * g.KW + kw;
      }
      goff[t] = go;
      woff[t] = wo;
      qd_s[t] = qd;
      qh_s[t] = qh;
      qw_s[t] = qw;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int k = ak + r * (kThreads / kBM);
      const int od = pi - qd_s[k], oh = pj - qh_s[k], ow = pl - qw_s[k];
      const bool ok = m_ok && k0 + k < K && od >= 0 && od < g.OD &&
                      oh >= 0 && oh < g.OH && ow >= 0 && ow < g.OW;
      As[k][am] = ok ? lg_to_f(gy[gbase + goff[k]]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBK * kBN / kThreads; ++r) {
      const int k = bk + r * (kThreads / kBN);
      const int gn = n0 + bn;
      Bs[k][bn] = (gn < Cg && k0 + k < K)
                      ? lg_to_f(wg[woff[k] + (long long)gn * KK]) : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= Mc) continue;
    const long long b = m / CS;
    long long s = m % CS;
    const int l = (int)(s % CW);
    s /= CW;
    const int j = (int)(s % CH), ii = (int)(s / CH);
    T* xrow = gx + (b * g.Cin + (long long)grp * Cg) * DHW +
              (long long)(rd + g.sd * ii) * HW +
              (long long)(rh + g.sh * j) * g.W + (rw + g.sw * l);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx * 4 + jj;
      if (n < Cg) xrow[n * DHW] = lg_from_f<T>(acc[i][jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradient: grid (Cg*KK tiles, Og tiles, G * splits) into f32
// partials, then a fixed-order sum
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bwd_dw_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                   float* __restrict__ part, Geom g, long long chunk,
                   int splits) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ long long groff[kBK], xroff[kBK];

  const int grp = blockIdx.z / splits, split = blockIdx.z % splits;
  const int Cg = g.Cin / g.G, Og = g.Cout / g.G;
  const int KK = g.KD * g.KH * g.KW, N = Cg * KK;
  const long long HW = (long long)g.H * g.W, DHW = g.D * HW;
  const long long OS = (long long)g.OD * g.OH * g.OW, R = g.B * OS;
  const long long r0 = split * chunk;
  const long long r1 = r0 + chunk < R ? r0 + chunk : R;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  // both loads: reduction index lk (neighbouring threads, neighbouring
  // output positions), rows / columns lr + 16rr
  const int lk = t % kBK, lr = t / kBK;
  long long xcol[4];
  bool n_ok[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int n = n0 + lr + 16 * rr;
    n_ok[rr] = n < N;
    xcol[rr] = n_ok[rr] ? patch_col(g, n, KK, HW, DHW) : 0;
  }
  const T* gyg = gy + (long long)grp * Og * OS;
  const T* xg = x + (long long)grp * Cg * DHW;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = r0; k0 < r1; k0 += kBK) {
    if (t < kBK) {
      const long long r = k0 + t;
      long long go = -1, xo = 0;
      if (r < r1) {
        const long long b = r / OS, s = r % OS;
        const int ow = (int)(s % g.OW);
        const long long q = s / g.OW;
        const int oh = (int)(q % g.OH), od = (int)(q / g.OH);
        go = b * g.Cout * OS + s;
        xo = b * g.Cin * DHW + (long long)od * g.sd * HW +
             (long long)oh * g.sh * g.W + (long long)ow * g.sw;
      }
      groff[t] = go;
      xroff[t] = xo;
    }
    __syncthreads();
    const bool k_ok = groff[lk] >= 0;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int co = m0 + lr + 16 * rr;
      As[lk][lr + 16 * rr] =
          (k_ok && co < Og) ? lg_to_f(gyg[co * OS + groff[lk]]) : 0.f;
      Bs[lk][lr + 16 * rr] =
          (k_ok && n_ok[rr]) ? lg_to_f(xg[xroff[lk] + xcol[rr]]) : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, tx, ty, acc);
    __syncthreads();
  }

  float* out = part + (long long)split * g.Cout * N +
               ((long long)grp * Og) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = m0 + ty * 4 + i;
    if (co >= Og) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(long long)co * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// y = conv(x, w); `geom` is the 19 ints of Geom (B, Cin, Cout, G, D, H, W,
// OD, OH, OW, KD, KH, KW, strides, dilations).  Returns
// cudaErrorInvalidValue for shapes the kernel lacks.
int lg_conv_fwd(const void* x, const void* w, void* y, const int* geom,
                int is_bf16, void* stream) {
  Geom g;
  if (!geom_of(geom, &g)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)g.B * g.OD * g.OH * g.OW;
  const int Og = g.Cout / g.G;
  const long long mt = (M + kBM - 1) / kBM;
  if (mt > 0x7fffffffLL || (Og + kBN - 1) / kBN > kMaxGrid || g.G > kMaxGrid)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mt, (Og + kBN - 1) / kBN, g.G);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    conv_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y,
        g);
  else
    conv_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)w, (float*)y, g);
  return (int)cudaGetLastError();
}

// gx = the input gradient of conv for the output gradient gy.
int lg_conv_bwd_dx(const void* gy, const void* w, void* gx, const int* geom,
                   int is_bf16, void* stream) {
  Geom g;
  if (!geom_of(geom, &g)) return (int)cudaErrorInvalidValue;
  const int ncls = g.sd * g.sh * g.sw, Cg = g.Cin / g.G;
  // the largest class is the first: ceil(D/sd) x ceil(H/sh) x ceil(W/sw)
  const long long M0 = (long long)g.B * ((g.D + g.sd - 1) / g.sd) *
                       ((g.H + g.sh - 1) / g.sh) * ((g.W + g.sw - 1) / g.sw);
  const long long mt = (M0 + kBM - 1) / kBM;
  if (mt > 0x7fffffffLL || (Cg + kBN - 1) / kBN > kMaxGrid ||
      (long long)g.G * ncls > kMaxGrid)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mt, (Cg + kBN - 1) / kBN, g.G * ncls);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    conv_bwd_dx_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)gy, (const __nv_bfloat16*)w,
        (__nv_bfloat16*)gx, g);
  else
    conv_bwd_dx_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)gy, (const float*)w, (float*)gx, g);
  return (int)cudaGetLastError();
}

// gw = the weight gradient of conv for the output gradient gy: `splits`
// blocks along the reduction over B*OS, `chunk` positions each, into
// `part` (splits * Cout * Cin/G * KK f32), then summed in order into gw.
int lg_conv_bwd_dw(const void* gy, const void* x, void* gw, void* part,
                   const int* geom, int splits, long long chunk, int is_bf16,
                   void* stream) {
  Geom g;
  if (!geom_of(geom, &g)) return (int)cudaErrorInvalidValue;
  const long long R = (long long)g.B * g.OD * g.OH * g.OW;
  const int Og = g.Cout / g.G, N = (g.Cin / g.G) * g.KD * g.KH * g.KW;
  if (splits < 1 || chunk < 1 || chunk % kBK ||
      (long long)(splits - 1) * chunk >= R || (long long)splits * chunk < R ||
      (long long)g.G * splits > kMaxGrid || (Og + kBM - 1) / kBM > kMaxGrid)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + kBN - 1) / kBN, (Og + kBM - 1) / kBM, g.G * splits);
  const long long total = (long long)g.Cout * N;
  const int rblocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256
                                                       : 8192);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    conv_bwd_dw_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)gy, (const __nv_bfloat16*)x, (float*)part, g,
        chunk, splits);
    sum_partials_kernel<__nv_bfloat16><<<rblocks, 256, 0, st>>>(
        (const float*)part, (__nv_bfloat16*)gw, total, splits);
  } else {
    conv_bwd_dw_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)gy, (const float*)x, (float*)part, g, chunk, splits);
    sum_partials_kernel<float><<<rblocks, 256, 0, st>>>(
        (const float*)part, (float*)gw, total, splits);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
