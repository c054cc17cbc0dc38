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
// exp(-1e30 - m) = 0, so skipping them is exact.  The visible rows are taken
// in chunks of up to kChunk keys, whose G x chunk scores fit in shared memory
// at any window (at G 8, W 8192 all scores would need 256 KB); per chunk,
// pass 1: one warp per key row (coalesced row read, warp-shuffle dot) writes
// f32 scores to shared memory; pass 2: one warp per query row turns them into
// probabilities against the running row max, rescaling the row's running
// denominator (an online softmax across chunks); pass 3: threads split (head
// dim, key range), rescale their partial contexts by the same factor, and
// read V rows coalesced.  The partial contexts are reduced through shared
// memory at the end.  With one chunk (up to kChunk visible keys) the
// arithmetic is a plain two-pass softmax.  (A body of its own for one
// chunk, with no rescale, measured 11% faster at GPT-2's f32 step and
// 2-96% slower at every other one-chunk shape and type, PERF.md §6.)
//
// Head dims: any hd with hd % 8 == 0 and 8 <= hd <= 256 (the TPU kernel
// takes any).  A lane of pass 1 holds up to kPer elements of a key row, a
// template parameter (1, 2, 4 or 8: the narrowest that holds hd), so a
// narrow head pays for no wider one's loads; pass 3 uses floor(256 / hd) key
// ranges of hd threads.  One block a KV head is few threads for thousands of
// keys: each warp waits on one row at a time, and loading several rows ahead
// in a warp measured slower (PERF.md §6).  A model with one KV head
// (Gemma-2B) runs a single block a layer: splitting the key range across
// blocks is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kChunk = 2048;    // keys whose scores are in shared memory

// kPer: elements of a key row a lane of pass 1 holds, hd <= 32 * kPer
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, T* __restrict__ out, int G,
                        int W, int hd, int lo, int nv, float scale) {
  extern __shared__ float smem[];
  const int ch = min(nv, kChunk);
  float* qs = smem;                    // G * hd
  float* sc = qs + G * hd;             // G * ch scores, then probabilities
  float* row_m = sc + G * ch;          // G running maxima
  float* row_l = row_m + kMaxG;        // G running denominators
  float* row_c = row_l + kMaxG;        // G rescale factors of this chunk
  float* red = row_c + kMaxG;          // kThreads * kMaxG partial contexts

  const int h = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const T* kh = kc + ((size_t)h * W + lo) * hd;
  const T* vh = vc + ((size_t)h * W + lo) * hd;

  for (int e = t; e < G * hd; e += kThreads)
    qs[e] = lg_to_f(q[(size_t)h * G * hd + e]);
  if (t < G) {
    row_m[t] = LG_NEG;
    row_l[t] = 0.f;
  }
  __syncthreads();

  // pass 3's split of the threads: (head dim, key range)
  const int parts = kThreads / hd;
  const int d = t % hd, part = t / hd;
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  for (int c0 = 0; c0 < nv; c0 += ch) {
    const int n = min(ch, nv - c0);
    // pass 1: scores
    for (int w = warp; w < n; w += kWarps) {
      const T* krow = kh + (size_t)(c0 + w) * hd;
      float kk[kPer];
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        kk[c] = lane + 32 * c < hd ? lg_to_f(krow[lane + 32 * c]) : 0.f;
      for (int g = 0; g < G; ++g) {
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          if (lane + 32 * c < hd)
            p = fmaf(qs[g * hd + lane + 32 * c], kk[c], p);
        p = lg_warp_sum(p);
        if (lane == 0) sc[g * ch + w] = p * scale;
      }
    }
    __syncthreads();

    // pass 2: probabilities of each query row against its running max
    for (int g = warp; g < G; g += kWarps) {
      float m = LG_NEG;
      for (int w = lane; w < n; w += 32) m = fmaxf(m, sc[g * ch + w]);
      m = fmaxf(lg_warp_max(m), row_m[g]);
      float l = 0.f;
      for (int w = lane; w < n; w += 32) {
        const float p = expf(sc[g * ch + w] - m);
        sc[g * ch + w] = p;
        l += p;
      }
      l = lg_warp_sum(l);
      if (lane == 0) {
        const float corr = expf(row_m[g] - m);
        row_l[g] = row_l[g] * corr + l;
        row_m[g] = m;
        row_c[g] = corr;
      }
    }
    __syncthreads();

    // pass 3: context
    if (part < parts) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= row_c[g];

      for (int w = part; w < n; w += parts) {
        const float vv = lg_to_f(vh[(size_t)(c0 + w) * hd + d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] = fmaf(sc[g * ch + w], vv, acc[g]);
      }
    }
    __syncthreads();  // the next chunk overwrites the scores
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G && part < parts) red[(g * parts + part) * hd + d] = acc[g];
  __syncthreads();
  for (int e = t; e < G * hd; e += kThreads) {
    const int g = e / hd, dd = e % hd;
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += red[(g * parts + p) * hd + dd];
    out[(size_t)h * G * hd + e] = lg_from_f<T>(s / row_l[g]);
  }
}

template <typename T, int kPer>
int launch(const void* q, const void* kc, const void* vc, void* out, int KV,
           int G, int W, int hd, int lo, int nv, float scale,
           cudaStream_t stream) {
  const int ch = nv < kChunk ? nv : kChunk;
  const size_t smem =
      sizeof(float) * ((size_t)G * hd + (size_t)G * ch + 3 * kMaxG +
                       (size_t)kThreads * kMaxG);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, kPer>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attention_kernel<T, kPer><<<KV, kThreads, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (T*)out, G, W, hd, lo, nv,
      scale);
  return (int)cudaGetLastError();
}

// the narrowest instantiation whose lanes hold hd elements
template <typename T>
int launch_hd(const void* q, const void* kc, const void* vc, void* out,
              int KV, int G, int W, int hd, int lo, int nv, float scale,
              cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 1>(q, kc, vc, out, KV, G, W, hd, lo, nv, scale, st);
  if (hd <= 64)
    return launch<T, 2>(q, kc, vc, out, KV, G, W, hd, lo, nv, scale, st);
  if (hd <= 128)
    return launch<T, 4>(q, kc, vc, out, KV, G, W, hd, lo, nv, scale, st);
  return launch<T, 8>(q, kc, vc, out, KV, G, W, hd, lo, nv, scale, st);
}

}  // namespace

extern "C" {

// pos: the token's absolute position; keys at [max(0, pos-window+1), pos]
// (window = 0: [0, pos]) are visible, clamped to the cache's W rows.
// Returns cudaErrorInvalidValue for shapes the kernel lacks (hd % 8 != 0,
// hd < 8, hd > 256, G outside 1..8).
int lg_decode_attention(const void* q, const void* kc, const void* vc,
                        void* out, int KV, int G, int W, int hd, int pos,
                        int window, float scale, int is_bf16, void* stream) {
  if (hd % 8 != 0 || hd < 8 || hd > 256 || G < 1 || G > kMaxG)
    return (int)cudaErrorInvalidValue;
  const int hi = pos < W - 1 ? pos : W - 1;
  int lo = window > 0 ? pos - window + 1 : 0;
  if (lo < 0) lo = 0;
  if (pos < 0 || lo > hi) return (int)cudaErrorInvalidValue;
  const int nv = hi - lo + 1;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_hd<__nv_bfloat16>(q, kc, vc, out, KV, G, W, hd, lo,
                                            nv, scale, st)
                 : launch_hd<float>(q, kc, vc, out, KV, G, W, hd, lo, nv,
                                    scale, st);
}

}  // extern "C"
