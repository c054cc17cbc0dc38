// Flash-attention forward for Hopper: (out, lse) of softmax(q k^T * scale) v.
//
// Replaces the TPU kernel lightgrad_tpu/ops/attention.py::_flash_fwd ->
// _fwd_kernel (and serves the call shapes of its two-heads-per-step variant
// _fwd_kernel_pair).  Layout: q (BH, S, D), k/v (BH/G, S, D) -- query row
// block bh reads KV row block bh / G (grouped-query, no repeated K/V);
// out (BH, S, D) in q's dtype, lse (BH, S) f32.
//
// What bounds it on this card: FP32 FFMA issue and shared-memory reads.  At
// prefill's S = 1024, D = 64 the O(S^2 D) score and context products dwarf
// the O(S D) bytes, and this kernel does them on the CUDA cores (no tensor
// cores yet).  Design: one 128-thread block per (bh, 64-row Q tile); two
// threads per query row, each owning half of the head dimension in float4
// chunks (interleaved, so the pair reads two adjacent 16-byte words of the
// same K/V row -- a broadcast, no bank conflict).  K/V tiles of 64 rows are
// widened to f32 in shared memory once and reused by all 64 query rows.  The
// online softmax (running max, denominator, f32 context) is updated once per
// 16 keys, so the rescale costs 1/16 of a key's work.  Under `causal`, K
// tiles wholly above the diagonal are never loaded (TPU: _pair_relevant).
// Masking selects (never multiplies), so a garbage or padded row cannot turn
// into NaN (TPU: _zero_oob_rows); rows past S are zero-filled in shared
// memory and masked.
//
// Optional per-row valid lengths `lens` (BH int32; TPU: the lens_ref limit of
// _fwd_kernel): key j is valid for row block bh iff j < lens[bh], on top of
// `causal`, and K tiles past the length are never loaded.  A padded query
// row (i >= lens[bh]) sees no valid key: it writes zeros and an lse of 0, by
// select, as the TPU kernel's l_safe epilogue does (L = 0 included).
//
// Optional sliding window `window` (> 0, causal only; TPU: _valid_mask's band
// and _pair_relevant's lower edge): key j is valid for row i only if
// i - j < window as well.  K tiles that end before the block's first row's
// band (j < q0 - window + 1) are never loaded, so a banded row costs
// O(window) keys instead of O(i).  A window of S or more bands nothing.
//
// Head dims: any d with d % 8 == 0 and 8 <= d <= 256 (the TPU kernel takes
// any).  The kernel is instantiated at D = 32, 64, 128 and 256; a call with
// another d runs the next wider D, with rows addressed at stride d, the
// columns >= d loaded as zeros and never stored, so the result is exact.
// At D = 256 four threads share a row (NC stays 16 float4 words a thread, as
// at D = 128; two threads would hold 256 floats of q and context and spill),
// so a block has 256 threads, and K/V tiles shrink to 16 rows (two 16 KB
// tiles, inside the 48 KB of static shared memory).
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kSub = 16;       // keys per online-softmax update

template <int D>
struct Fwd {
  static constexpr int TPR = (D == 256) ? 4 : 2;  // threads per query row
  static constexpr int kThreads = kBQ * TPR;
  // keys per shared-memory tile
  static constexpr int BK = (D == 256) ? 16 : (D == 128) ? 32 : 64;
  static constexpr int D4 = D / 4;                // float4 words in a row
  static constexpr int NC = D4 / TPR;             // float4 words a thread owns
};

template <typename T, int D>
__global__ void __launch_bounds__(Fwd<D>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ lens,
                 int S, int G, int d, float scale, int causal, int window) {
  using C = Fwd<D>;
  constexpr int TPR = C::TPR, BK = C::BK, D4 = C::D4, NC = C::NC;
  __shared__ float4 Ks[BK][D4];
  __shared__ float4 Vs[BK][D4];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int t = threadIdx.x;
  const int row = t / TPR, part = t % TPR;
  const int qi = q0 + row;
  const int d4 = d / 4;  // float4 words of a row that hold data
  const int limit = lens ? max(0, min(lens[bh], S)) : S;
  const T* qrow = q + ((size_t)bh * S + min(qi, S - 1)) * d;
  const T* kb = k + (size_t)(bh / G) * S * d;
  const T* vb = v + (size_t)(bh / G) * S * d;

  float4 qr[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int w = c * TPR + part;
    qr[c] = w < d4 ? lg_load4(qrow + w * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = LG_NEG, l = 0.f;

  int nkt = (limit + BK - 1) / BK;
  if (causal) nkt = min(nkt, (q0 + kBQ - 1) / BK + 1);
  if (q0 >= limit) nkt = 0;  // every row of the block is padding
  // the band's lower edge: keys before the first row's band are dead
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  // this row's valid keys: [klo, khi] (empty for a padded row)
  const int klo = window > 0 ? qi - window + 1 : 0;
  const int khi = causal ? min(qi, limit - 1) : limit - 1;

  for (int kt = kt0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is no longer read
    if constexpr (D == 128) {
      // element by element: at D 128 this schedules the banded Mistral-7B
      // prefill 14% faster than lg_stage, which is 4-6% faster at D 64 and
      // 256 (PERF.md §6, `scripts/ab_flash_bwd.py`)
      for (int e = t; e < BK * D4; e += C::kThreads) {
        const int r = e / D4, c4 = e % D4;
        const int kr = k0 + r;
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (kr < S && c4 < d4) {
          kv = lg_load4(kb + (size_t)kr * d + c4 * 4);
          vv = lg_load4(vb + (size_t)kr * d + c4 * 4);
        }
        Ks[r][c4] = kv;
        Vs[r][c4] = vv;
      }
    } else {
      lg_stage<T, D, BK, C::kThreads>(Ks, kb, k0, S, d);
      lg_stage<T, D, BK, C::kThreads>(Vs, vb, k0, S, d);
    }
    __syncthreads();

    for (int j0 = 0; j0 < BK; j0 += kSub) {
      float s[kSub];
      unsigned ok = 0u;
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = j0 + jj;
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kv = Ks[j][c * TPR + part];
          p = fmaf(qr[c].x, kv.x, p);
          p = fmaf(qr[c].y, kv.y, p);
          p = fmaf(qr[c].z, kv.z, p);
          p = fmaf(qr[c].w, kv.w, p);
        }
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        p *= scale;
        const int kj = k0 + j;
        const bool valid = kj >= klo && kj <= khi;
        s[jj] = valid ? p : LG_NEG;
        ok |= (valid ? 1u : 0u) << jj;
        mx = fmaxf(mx, s[jj]);
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[c].x *= corr; acc[c].y *= corr; acc[c].z *= corr; acc[c].w *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float p = ((ok >> jj) & 1u) ? expf(s[jj] - mx) : 0.f;
        l += p;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = Vs[j0 + jj][c * TPR + part];
          acc[c].x = fmaf(p, vv.x, acc[c].x);
          acc[c].y = fmaf(p, vv.y, acc[c].y);
          acc[c].z = fmaf(p, vv.z, acc[c].z);
          acc[c].w = fmaf(p, vv.w, acc[c].w);
        }
      }
      m = mx;
    }
  }

  if (qi < S) {
    // a valid row always sees key qi itself, so l > 0 there; padded rows
    // select 0
    const bool ok = qi < limit;
    const float inv = ok ? 1.f / l : 0.f;
    T* orow = out + ((size_t)bh * S + qi) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int w = c * TPR + part;
      if (w < d4)
        lg_store4(orow + w * 4,
                  ok ? make_float4(acc[c].x * inv, acc[c].y * inv,
                                   acc[c].z * inv, acc[c].w * inv)
                     : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    if (part == 0) lse[(size_t)bh * S + qi] = ok ? m + logf(l) : 0.f;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const void* lens, int BH, int G, int S, int d, float scale,
           int causal, int window, cudaStream_t stream) {
  dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, D><<<grid, Fwd<D>::kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse,
      (const int*)lens, S, G, d, scale, causal, window);
  return (int)cudaGetLastError();
}

// the narrowest instantiation that holds d columns
template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             void* lse, const void* lens, int BH, int G, int S, int d,
             float scale, int causal, int window, cudaStream_t st) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, out, lse, lens, BH, G, S, d, scale, causal,
                         window, st);
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, lse, lens, BH, G, S, d, scale, causal,
                         window, st);
  if (d <= 128)
    return launch<T, 128>(q, k, v, out, lse, lens, BH, G, S, d, scale,
                          causal, window, st);
  return launch<T, 256>(q, k, v, out, lse, lens, BH, G, S, d, scale, causal,
                        window, st);
}

}  // namespace

extern "C" {

const char* lg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// `lens` is null or BH int32 valid lengths; `window` 0 (no band) or the
// band's width.  Returns cudaErrorInvalidValue for a head dimension the
// kernel lacks (d % 8 != 0, d < 8 or d > 256).
int lg_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, const void* lens, int BH, int G, int S, int D,
                 float scale, int causal, int window, int is_bf16,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 8 != 0 || D < 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (BH <= 0 || S <= 0) return 0;
  return is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, out, lse, lens, BH, G, S,
                                           D, scale, causal, window, st)
                 : launch_d<float>(q, k, v, out, lse, lens, BH, G, S, D,
                                   scale, causal, window, st);
}

}  // extern "C"
