// One decoded token's attention over a fixed-window KV cache.
//
// Replaces the TPU kernel lightgrad_tpu/ops/decode_attention.py::
// decode_attention -> _kernel: scores + `col <= pos` mask (+ sliding-window
// band) + softmax + context in one launch.  Layout: q (KV, G, hd) -- the G
// query heads served by each KV head; kc, vc (KV, W, hd); out (KV, G, hd).
//
// What bounds it on this card: the cache bytes, 2 * (pos + 1) * hd elements
// per KV head, read once; the arithmetic is two multiply-adds per element.
// Design: one 256-thread block per KV head, so the head's K and V rows are
// each read once from device memory and serve all G query rows.  Only the
// visible rows [lo, pos] are read at all -- masked rows would contribute
// exp(-1e30 - m) = 0, so skipping them is exact.  Pass 1: one warp per key
// row (coalesced row read, warp-shuffle dot) writes f32 scores to shared
// memory; pass 2: one warp per query row turns them into probabilities;
// pass 3: threads split (head dim, key range), read V rows coalesced and
// reduce their partial contexts through shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, T* __restrict__ out, int G,
                        int W, int hd, int lo, int nv, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // G * hd
  float* sc = qs + G * hd;             // G * nv scores, then probabilities
  float* inv_l = sc + G * nv;          // G
  float* red = inv_l + kMaxG;          // kThreads * kMaxG partial contexts

  const int h = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const T* kh = kc + ((size_t)h * W + lo) * hd;
  const T* vh = vc + ((size_t)h * W + lo) * hd;
  const int per_lane = hd / 32;  // 1..4

  for (int e = t; e < G * hd; e += kThreads)
    qs[e] = lg_to_f(q[(size_t)h * G * hd + e]);
  __syncthreads();

  // pass 1: scores
  for (int w = warp; w < nv; w += kWarps) {
    float kk[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      kk[c] = c < per_lane ? lg_to_f(kh[(size_t)w * hd + lane + 32 * c]) : 0.f;
    for (int g = 0; g < G; ++g) {
      float p = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < per_lane) p = fmaf(qs[g * hd + lane + 32 * c], kk[c], p);
      p = lg_warp_sum(p);
      if (lane == 0) sc[g * nv + w] = p * scale;
    }
  }
  __syncthreads();

  // pass 2: softmax of each query row
  for (int g = warp; g < G; g += kWarps) {
    float m = LG_NEG;
    for (int w = lane; w < nv; w += 32) m = fmaxf(m, sc[g * nv + w]);
    m = lg_warp_max(m);
    float l = 0.f;
    for (int w = lane; w < nv; w += 32) {
      const float p = expf(sc[g * nv + w] - m);
      sc[g * nv + w] = p;
      l += p;
    }
    l = lg_warp_sum(l);
    if (lane == 0) inv_l[g] = 1.f / l;
  }
  __syncthreads();

  // pass 3: context, threads split as (head dim, key range)
  const int parts = kThreads / hd;
  const int d = t % hd, part = t / hd;
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  if (part < parts) {
    for (int w = part; w < nv; w += parts) {
      const float vv = lg_to_f(vh[(size_t)w * hd + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = fmaf(sc[g * nv + w], vv, acc[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G) red[(g * parts + part) * hd + d] = part < parts ? acc[g] : 0.f;
  __syncthreads();
  for (int e = t; e < G * hd; e += kThreads) {
    const int g = e / hd, dd = e % hd;
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += red[(g * parts + p) * hd + dd];
    out[(size_t)h * G * hd + e] = lg_from_f<T>(s * inv_l[g]);
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, void* out, int KV,
           int G, int W, int hd, int lo, int nv, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)G * hd + (size_t)G * nv + kMaxG +
                       (size_t)kThreads * kMaxG);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attention_kernel<T><<<KV, kThreads, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (T*)out, G, W, hd, lo, nv,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pos: the token's absolute position; keys at [max(0, pos-window+1), pos]
// (window = 0: [0, pos]) are visible, clamped to the cache's W rows.
// Returns cudaErrorInvalidValue for shapes the kernel lacks.
int lg_decode_attention(const void* q, const void* kc, const void* vc,
                        void* out, int KV, int G, int W, int hd, int pos,
                        int window, float scale, int is_bf16, void* stream) {
  if (hd % 32 != 0 || hd > 128 || kThreads % hd != 0 || G < 1 || G > kMaxG)
    return (int)cudaErrorInvalidValue;
  const int hi = pos < W - 1 ? pos : W - 1;
  int lo = window > 0 ? pos - window + 1 : 0;
  if (lo < 0) lo = 0;
  if (pos < 0 || lo > hi) return (int)cudaErrorInvalidValue;
  const int nv = hi - lo + 1;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(q, kc, vc, out, KV, G, W, hd, lo,
                                         nv, scale, st)
                 : launch<float>(q, kc, vc, out, KV, G, W, hd, lo, nv, scale,
                                 st);
}

}  // extern "C"
