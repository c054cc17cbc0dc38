// Flash-attention backward for Hopper: dq, and dk/dv, of
// out = softmax(q k^T * scale) v, from the forward's (out, lse).
//
// Replaces the TPU kernels lightgrad_tpu/ops/attention.py::_flash_bwd ->
// _bwd_dq_kernel (the dq pass) and _bwd_dkv_kernel (the dk/dv pass).  Layout
// as the forward (flash_fwd.cu): q, do, dq (BH, S, D); k, v, dk, dv (BH/G, S,
// D), query row block bh reading KV row block bh / G; lse and
// dcap = rowsum(do * out) (BH, S) f32.  lse is the natural log of the SCALED
// scores' exp-sum, exactly as the forward writes it, so p = exp(s*scale - lse)
// needs no renormalisation.
//
// What bounds it on this card: FP32 FFMA issue and shared-memory reads, as in
// the forward -- every (query, key) pair costs three D-long dot products
// (q.k, do.v, and the accumulation into dq or into dk and dv), all on the
// CUDA cores (no tensor cores yet).  Design, both passes: one row of the
// resident operand per group of TPR = D / 16 adjacent threads, each thread
// owning 16 of the D columns in float4 chunks (interleaved, so the group reads
// TPR adjacent 16-byte words of a shared row: a broadcast, no bank conflict);
// per-thread registers are therefore the same at D = 64 and D = 128.  (With
// 32 columns a thread, the dk/dv pass's four row-sized register arrays
// spilled at 255 registers.)  The streamed operand is widened to f32 in
// shared memory once per tile and read by every row of the block.  Partial
// dot products are reduced across the group with shuffles, four streamed rows
// at a time for ILP.
//
//   dq pass: block = (bh, 64 query rows; 32 at D = 128); q, do and the dq
//     accumulator live in registers; K and V tiles stream.
//     dq_i = scale * sum_j ds_ij k_j.
//   dk/dv pass: block = (KV row block, 64 key rows; 32 at D = 128); k, v and
//     both accumulators live in registers; Q, dO, lse and dcap tiles stream,
//     for all G query heads of the group in turn (TPU: the inner grid index
//     walks the (head, q block) pairs).  dv_j = sum_i p_ij do_i,
//     dk_j = scale * sum_i ds_ij q_i, with ds_ij = p_ij (dp_ij - dcap_i).
//
// No atomics; every sum is taken in a fixed order, so results are
// deterministic.  Under `causal`, tiles wholly above the diagonal are never
// loaded (TPU: _pair_relevant).  Masks select and never multiply, so padded
// or out-of-range rows cannot turn into NaN (TPU: _zero_oob_rows).  Unlike
// the TPU kernel, p and ds are not rounded to the input dtype before their
// products: every sum is f32 and each output is rounded once.
#include "common.cuh"

namespace {

constexpr int kSub = 4;  // streamed rows per shuffle round

template <int D>
struct Cfg {
  static constexpr int TPR = D / 16;  // threads per resident row
  // resident rows (queries or keys) per block: 256 threads at both widths,
  // so that a thread may use up to 255 registers
  static constexpr int kRows = (D == 128) ? 32 : 64;
  static constexpr int kThreads = kRows * TPR;
  static constexpr int BS = (D == 128) ? 32 : 64;  // streamed rows per tile
  static constexpr int D4 = D / 4;             // float4 words in a row
  static constexpr int NC = 4;                 // float4 words a thread owns
};

// Sum over the TPR adjacent lanes of one row group.
template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float s, float4 x, float4& y) {
  y.x = fmaf(s, x.x, y.x);
  y.y = fmaf(s, x.y, y.y);
  y.z = fmaf(s, x.z, y.z);
  y.w = fmaf(s, x.w, y.w);
}

// Widen rows [r0, r0 + BS) of a (S, D) slab into shared f32; rows past S
// are zero.
template <typename T, int D, int BS, int NT>
__device__ __forceinline__ void stage(float4 (*dst)[D / 4], const T* src,
                                      int r0, int S) {
  constexpr int D4 = D / 4;
  for (int e = threadIdx.x; e < BS * D4; e += NT) {
    const int r = e / D4, c4 = e % D4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) val = lg_load4(src + (size_t)(r0 + r) * D + c4 * 4);
    dst[r][c4] = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dcap, T* __restrict__ dq,
                    int S, int G, float scale, int causal) {
  using C = Cfg<D>;
  constexpr int TPR = C::TPR, BS = C::BS, D4 = C::D4, NC = C::NC;
  __shared__ float4 Ks[BS][D4];
  __shared__ float4 Vs[BS][D4];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::kRows;
  const int t = threadIdx.x;
  const int row = t / TPR, part = t % TPR;
  const int qi = q0 + row;
  const size_t rq = (size_t)bh * S + min(qi, S - 1);
  const T* kb = k + (size_t)(bh / G) * S * D;
  const T* vb = v + (size_t)(bh / G) * S * D;

  float4 qr[NC], dor[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    qr[c] = lg_load4(q + rq * D + (c * TPR + part) * 4);
    dor[c] = lg_load4(dout + rq * D + (c * TPR + part) * 4);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float lse_i = lse[rq], dcap_i = dcap[rq];

  int nkt = (S + BS - 1) / BS;
  if (causal) nkt = min(nkt, (q0 + C::kRows - 1) / BS + 1);

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BS;
    __syncthreads();  // the previous tile is no longer read
    stage<T, D, BS, C::kThreads>(Ks, kb, k0, S);
    stage<T, D, BS, C::kThreads>(Vs, vb, k0, S);
    __syncthreads();

    for (int j0 = 0; j0 < BS; j0 += kSub) {
      float s[kSub], dp[kSub];
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          a = dot4(qr[c], Ks[j0 + jj][c * TPR + part], a);
          b = dot4(dor[c], Vs[j0 + jj][c * TPR + part], b);
        }
        s[jj] = a;
        dp[jj] = b;
      }
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        s[jj] = group_sum<TPR>(s[jj]);
        dp[jj] = group_sum<TPR>(dp[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int kj = k0 + j0 + jj;
        const bool valid = kj < S && (!causal || kj <= qi);
        const float p = valid ? expf(s[jj] * scale - lse_i) : 0.f;
        const float ds = valid ? p * (dp[jj] - dcap_i) : 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          axpy4(ds, Ks[j0 + jj][c * TPR + part], acc[c]);
      }
    }
  }

  if (qi < S) {
    T* out = dq + ((size_t)bh * S + qi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      lg_store4(out + (c * TPR + part) * 4,
                make_float4(acc[c].x * scale, acc[c].y * scale,
                            acc[c].z * scale, acc[c].w * scale));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dcap, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int G, float scale,
                     int causal) {
  using C = Cfg<D>;
  constexpr int TPR = C::TPR, BS = C::BS, D4 = C::D4, NC = C::NC;
  __shared__ float4 Qs[BS][D4];
  __shared__ float4 Os[BS][D4];  // dO
  __shared__ float Ls[BS];       // lse
  __shared__ float Ds[BS];       // dcap

  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * C::kRows;
  const int t = threadIdx.x;
  const int row = t / TPR, part = t % TPR;
  const int kj = k0 + row;
  const size_t rk = (size_t)bkv * S + min(kj, S - 1);

  float4 kr[NC], vr[NC], dka[NC], dva[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    kr[c] = lg_load4(k + rk * D + (c * TPR + part) * 4);
    vr[c] = lg_load4(v + rk * D + (c * TPR + part) * 4);
    dka[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[c] = dka[c];
  }

  const int nqt = (S + BS - 1) / BS;
  // causal: query tiles wholly before this key block see none of its keys
  const int qt0 = causal ? k0 / BS : 0;

  for (int g = 0; g < G; ++g) {
    const int bh = bkv * G + g;
    const T* qb = q + (size_t)bh * S * D;
    const T* ob = dout + (size_t)bh * S * D;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * BS;
      __syncthreads();  // the previous tile is no longer read
      stage<T, D, BS, C::kThreads>(Qs, qb, q0, S);
      stage<T, D, BS, C::kThreads>(Os, ob, q0, S);
      for (int r = t; r < BS; r += C::kThreads) {
        const bool in = q0 + r < S;
        Ls[r] = in ? lse[(size_t)bh * S + q0 + r] : 0.f;
        Ds[r] = in ? dcap[(size_t)bh * S + q0 + r] : 0.f;
      }
      __syncthreads();

      for (int i0 = 0; i0 < BS; i0 += kSub) {
        float s[kSub], dp[kSub];
#pragma unroll
        for (int ii = 0; ii < kSub; ++ii) {
          float a = 0.f, b = 0.f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            a = dot4(kr[c], Qs[i0 + ii][c * TPR + part], a);
            b = dot4(vr[c], Os[i0 + ii][c * TPR + part], b);
          }
          s[ii] = a;
          dp[ii] = b;
        }
#pragma unroll
        for (int ii = 0; ii < kSub; ++ii) {
          s[ii] = group_sum<TPR>(s[ii]);
          dp[ii] = group_sum<TPR>(dp[ii]);
        }
#pragma unroll
        for (int ii = 0; ii < kSub; ++ii) {
          const int qi = q0 + i0 + ii;
          const bool valid = qi < S && (!causal || kj <= qi);
          const float p = valid ? expf(s[ii] * scale - Ls[i0 + ii]) : 0.f;
          const float ds = valid ? p * (dp[ii] - Ds[i0 + ii]) : 0.f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            axpy4(p, Os[i0 + ii][c * TPR + part], dva[c]);
            axpy4(ds, Qs[i0 + ii][c * TPR + part], dka[c]);
          }
        }
      }
    }
  }

  if (kj < S) {
    T* dkr = dk + ((size_t)bkv * S + kj) * D;
    T* dvr = dv + ((size_t)bkv * S + kj) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * TPR + part) * 4;
      lg_store4(dkr + col, make_float4(dka[c].x * scale, dka[c].y * scale,
                                       dka[c].z * scale, dka[c].w * scale));
      lg_store4(dvr + col, dva[c]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dcap, void* dq, int BH, int G,
              int S, float scale, int causal, cudaStream_t stream) {
  dim3 grid((S + Cfg<D>::kRows - 1) / Cfg<D>::kRows, BH);
  flash_bwd_dq_kernel<T, D><<<grid, Cfg<D>::kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)dcap, (T*)dq, S, G, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dcap, void* dk, void* dv, int BH,
               int G, int S, float scale, int causal, cudaStream_t stream) {
  dim3 grid((S + Cfg<D>::kRows - 1) / Cfg<D>::kRows, BH / G);
  flash_bwd_dkv_kernel<T, D><<<grid, Cfg<D>::kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)dcap, (T*)dk, (T*)dv, S, G, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both return cudaErrorInvalidValue for a head dimension the kernels lack.
int lg_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dcap,
                    void* dq, int BH, int G, int S, int D, float scale,
                    int causal, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (BH <= 0 || S <= 0) return 0;
  if (D == 64) {
    return is_bf16 ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, dcap,
                                                  dq, BH, G, S, scale, causal,
                                                  st)
                   : launch_dq<float, 64>(q, k, v, dout, lse, dcap, dq, BH, G,
                                          S, scale, causal, st);
  }
  if (D == 128) {
    return is_bf16 ? launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, dcap,
                                                   dq, BH, G, S, scale,
                                                   causal, st)
                   : launch_dq<float, 128>(q, k, v, dout, lse, dcap, dq, BH,
                                           G, S, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

int lg_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dcap,
                     void* dk, void* dv, int BH, int G, int S, int D,
                     float scale, int causal, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (BH <= 0 || S <= 0) return 0;
  if (D == 64) {
    return is_bf16 ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, dcap,
                                                   dk, dv, BH, G, S, scale,
                                                   causal, st)
                   : launch_dkv<float, 64>(q, k, v, dout, lse, dcap, dk, dv,
                                           BH, G, S, scale, causal, st);
  }
  if (D == 128) {
    return is_bf16 ? launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, dcap,
                                                    dk, dv, BH, G, S, scale,
                                                    causal, st)
                   : launch_dkv<float, 128>(q, k, v, dout, lse, dcap, dk, dv,
                                            BH, G, S, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
