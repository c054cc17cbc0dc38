// Whole-stack GPT-2 decode megakernel: n <= 8 rows through all L layers in
// ONE launch.
//
// Replaces the TPU kernels lightgrad_tpu/ops/decode_stack.py::decode_stack
// (_kernel_noscale, _kernel_int8, _kernel_kvq, _kernel_int8_kvq ->
// _kernel_body) and ::decode_stack_batch (_kernel_b_noscale, _kernel_b_int8,
// _kernel_b_kvq, _kernel_b_int8_kvq).  One kernel body, templated on three
// types, serves all eight:
//   T   compute type (x, vecs, x_out, kv_out): float or bf16;
//   TW  weight type: T, or int8 with an f32 scale per (layer, slab, output
//       column) -- the scale is constant over K, so each K-chunk partial is
//       scaled as the block reduces it;
//   TC  cache type: T, or int8 rows with an f32 scale per row -- the K
//       scale multiplies the score (before the online max), the V scale
//       folds into the context only (a += p * vs * v; the denominator sums
//       p alone, as the TPU kernel's drun does).
// Activations stay f32 in every product (the TPU's int8 variant rounds
// them to bf16 for its MXU dot).  The in-flight rows are attended and
// emitted at full precision in T even over an int8 cache; the caller
// quantizes kv_out into the cache.  One kernel serves extend and batched
// mode through a per-row table:
//   extend mode (poss == nullptr): every row is in slot 0 at positions
//     pos0 .. pos0+n-1 (pos0 read from pos_dev on the device where given,
//     so a captured launch replays at any position); row r attends cache
//     rows < pos0 plus in-flight rows
//     j <= r (the causal self-block);
//   batched mode: row r is in slot r at position poss[r]; it attends its own
//     cache rows < poss[r] plus its own new row.
// Per layer: LN1, QKV, attention, proj + residual, LN2, tanh-GELU MLP +
// residual.  The new K/V rows go to kv_out (L, 2, n, d); the caller scatters
// them into the cache, so the cache is only read here.  Weights arrive packed
// by ops/decode_stack.py::pack_gpt_stack: slabs (L, 4+2R, d, d) stored [in,
// out], so each product is `row @ slab` and a thread owning an output column
// reads coalesced; vecs (L, 9+R, d) hold the LN parameters and biases.
//
// What bounds it on this card: not the weight bytes (halving them with bf16
// leaves the time unchanged, PERF.md) but latency -- a chain of dependent
// phases, each a few round trips to memory, plus, at long positions, the
// cache rows.  The TPU grid ran its (layer, slab) steps in order on one core
// and kept the residual in VMEM between them; on Hopper blocks run in
// parallel and in no order.  Design: ONE cooperative launch with no more
// blocks than can be co-resident, whose phases are separated by grid-wide
// barriers (cooperative_groups::this_grid().sync()), 8 per layer:
//   gemv    a block takes (32-column tile, KB-row K chunk) items; each of its
//           8 warps stages its n x KB/8 input slice in shared memory, streams
//           its KB/8 x 32 weight block coalesced, and the block reduces the
//           8 warps' sums in shared memory into one partial per chunk;
//   reduce  the consumer sums the K-chunk partials in a fixed order (no
//           atomics: the result does not depend on scheduling) and adds the
//           bias, the residual, the GELU or the LayerNorm -- the q/k/v sums
//           inside the attention phase, the fc sums + GELU inside fc2's
//           input staging, the proj/fc2 sums in the per-row LayerNorm phase;
//   attend  a block per (row, head, key range): each warp loads 4 cache rows
//           before using them (online softmax), the block merges its warps,
//           and a merge phase combines the key ranges.
// The residual stays f32 across all layers in the workspace (TPU: `xacc`)
// and is rounded to the compute dtype only at x_out.  All inputs of a
// product stay f32; weights and cache widen from bf16 on load.  The wrapper
// allocates the f32 workspace; the kernel allocates nothing.  Data written
// in one phase and read by another block in a later phase is loaded with
// __ldcg (L2, never a stale L1 line).
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 8;      // rows per call
constexpr int kHD = 64;       // head dim (two dims per lane)
constexpr int kMaxD = 4096;   // residual row staged in shared memory
constexpr int kMaxWR = 32;    // K rows per warp per gemv item
constexpr int kMaxSplit = 32; // key ranges per (row, head)
constexpr int kKeyBatch = 4;  // cache rows a warp loads before using them

// K rows per gemv block item: the largest of 256/128/64 dividing d, so an
// item never straddles two d x d slabs.
__host__ __device__ inline int chunk_rows(int d) {
  return d % 256 == 0 ? 256 : d % 128 == 0 ? 128 : 64;
}

// The kernel's operands.  The pointers of x, vecs, x_out and kv_out hold
// the compute type T, slabs the weight type TW and cache the cache type TC;
// they are cast where the kernel of one instantiation reads them.
struct StackParams {
  const void* x;         // (n, d) residual input
  const void* cache;     // (slots, L, 2, H, W, hd)
  long long slot_stride; // elements between slots
  const int* poss;       // (n,) batched positions, or nullptr (extend)
  int pos0;              // extend-mode position of row 0
  const int* pos_dev;    // the same as an int32 on the device, or nullptr
  const void* slabs;     // (L, 4+2R, d, d)
  const void* vecs;      // (L, 9+R, d)
  const float* scales;   // (L, 4+2R, d) when TW is int8, else unused
  const float* kv_scales;  // (slots, L, 2, H, W) when TC is int8
  void* x_out;           // (n, d)
  void* kv_out;          // (L, 2, n, d)
  float* ws;             // f32 workspace, lg_decode_stack_workspace floats
  int n, L, d, H, W, R;
  float eps, scale;
};

template <typename U>
constexpr bool kInt8 = std::is_same<U, int8_t>::value;

struct Shared {
  float hs[kWarps][kMaxN * kMaxWR];  // staged gemv inputs
  float red[kWarps][kMaxN][32];      // per-warp gemv sums
  float row[kMaxD];                  // residual row
  float bsum[kWarps];
  float am[kWarps], al[kWarps], aacc[kWarps][kHD];
};

__device__ __forceinline__ float block_sum(float v, float* bsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = lg_warp_sum(v);
  if (lane == 0) bsum[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += bsum[i];
  __syncthreads();
  return s;
}

// out[c] = LN(row)[c] * w[c] + b[c] for the d-float row staged in `row`.
template <typename T>
__device__ void layernorm_row(const float* row, const T* w, const T* b,
                              float* out, int d, float eps, float* bsum) {
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) s += row[c];
  const float mean = block_sum(s, bsum) / d;
  float v = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float dv = row[c] - mean;
    v = fmaf(dv, dv, v);
  }
  const float inv = 1.f / sqrtf(block_sum(v, bsum) / d + eps);
  for (int c = threadIdx.x; c < d; c += kThreads)
    out[c] = (row[c] - mean) * inv * lg_ldg(w + c) + lg_ldg(b + c);
}

__device__ __forceinline__ float gelu_tanh(float y) {
  return 0.5f * y *
         (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
}

// The input of a product: a plain f32 (n, K) matrix, or -- for fc2 -- the
// GELU of the fc partial sums plus bias, reduced while staging.
struct GemvInput {
  const float* x;        // (n, K) f32, or nullptr for the GELU staging
  const float* fc_part;  // (nkc_fc, n, K) fc partial sums
  int nkc_fc;            // fc K chunks
};

// part[kc][r][c] = sum_{k in chunk kc} in[r][k] * Wfull[k][c], Wfull being
// the (K, N) product matrix assembled from d x d slabs starting at slab0.
template <typename TW, typename T>
__device__ void gemv_phase(const StackParams& p, const T* vec,
                           int l,
                           GemvInput in, int K, int N, int slab0,
                           float* part, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = p.n, d = p.d, S = 4 + 2 * p.R;
  const int KB = chunk_rows(d), WR = KB / kWarps;
  const int ntile = N / 32, total = ntile * (K / KB);
  float* hs = sh.hs[warp];
  for (int it = blockIdx.x; it < total; it += gridDim.x) {
    const int tile = it % ntile, kc = it / ntile;
    const int k0 = kc * KB + warp * WR;
    for (int e = lane; e < n * WR; e += 32) {
      const int r = e / WR, k = k0 + e % WR;
      float v;
      if (in.x) {
        v = __ldcg(in.x + (size_t)r * K + k);
      } else {
        v = lg_ldg(vec + (size_t)(9 + k / d) * d + k % d);
        for (int c = 0; c < in.nkc_fc; ++c)
          v += __ldcg(in.fc_part + ((size_t)c * n + r) * K + k);
        v = gelu_tanh(v);
      }
      hs[e] = v;
    }
    __syncwarp();
    const int c = tile * 32 + lane;
    const int slab = slab0 + k0 / d + c / d;
    const TW* w = static_cast<const TW*>(p.slabs) +
                  (((size_t)l * S + slab) * d + (k0 % d)) * d + c % d;
    float acc[kMaxN];
#pragma unroll
    for (int r = 0; r < kMaxN; ++r) acc[r] = 0.f;
#pragma unroll 16
    for (int kk = 0; kk < WR; ++kk) {
      const float wv = lg_ldg(w + (size_t)kk * d);
#pragma unroll
      for (int r = 0; r < kMaxN; ++r)
        if (r < n) acc[r] = fmaf(hs[r * WR + kk], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kMaxN; ++r) sh.red[warp][r][lane] = acc[r];
    __syncthreads();
    if (threadIdx.x < n * 32) {
      const int r = threadIdx.x >> 5;
      float s = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < kWarps; ++w8) s += sh.red[w8][r][lane];
      if constexpr (kInt8<TW>)  // every warp of an item is in one slab
        s *= __ldg(p.scales + ((size_t)l * S + slab0 + kc * KB / d + c / d) *
                                  d + c % d);
      part[((size_t)kc * n + r) * N + c] = s;
    }
    __syncthreads();  // hs and red are restaged by the next item
  }
}

// Online-softmax update of one warp's (m, l, context) with key score s.
__device__ __forceinline__ void online_update(float s, float2 vv, float& m,
                                              float& l, float2& a) {
  const float mn = fmaxf(m, s);
  const float corr = expf(m - mn), pj = expf(s - mn);
  l = fmaf(l, corr, pj);
  a.x = fmaf(a.x, corr, pj * vv.x);
  a.y = fmaf(a.y, corr, pj * vv.y);
  m = mn;
}

// Two dims (2*lane, 2*lane+1) of the q/k/v row r at column offset `col` of
// the (n, 3d) product: bias + the K-chunk partial sums.
template <typename T>
__device__ __forceinline__ float2 qkv_pair(const float* part, const T* vec,
                                           int nkc, int n, int d, int r,
                                           int col) {
  const int lane = threadIdx.x & 31;
  const int c = col + 2 * lane;
  float2 v = make_float2(lg_ldg(vec + 6 * d + c), lg_ldg(vec + 6 * d + c + 1));
  for (int kc = 0; kc < nkc; ++kc) {
    const float* pr = part + ((size_t)kc * n + r) * 3 * d + c;
    v.x += __ldcg(pr);
    v.y += __ldcg(pr + 1);
  }
  return v;
}

template <typename T, typename TW, typename TC>
__global__ void __launch_bounds__(kThreads)
decode_stack_kernel(StackParams p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Shared sh;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = p.n, d = p.d, L = p.L, H = p.H, W = p.W, R = p.R;
  const int NV = 9 + R, Rd = R * d, d3 = 3 * d;
  const int nkc = d / chunk_rows(d);            // K chunks of a K = d product
  const int nkc2 = Rd / chunk_rows(d);          // ... of fc2 (K = Rd)
  const int NS = max(1, min(kMaxSplit, (int)gridDim.x / (n * H)));
  const size_t npart = (size_t)nkc * n * (R > 3 ? R : 3) * d;
  float* const xacc = p.ws;
  float* const hln = xacc + (size_t)n * d;
  float* const att = hln + (size_t)n * d;
  float* const partA = att + (size_t)n * d;     // qkv, then fc
  float* const partB = partA + npart;           // proj, then fc2
  float* const sm = partB + npart;              // split maxima
  float* const sl = sm + (size_t)n * H * kMaxSplit;    // split sums
  float* const sacc = sl + (size_t)n * H * kMaxSplit;  // split contexts
  const T* const vecs = static_cast<const T*>(p.vecs);
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;

  // prologue: xacc = x, hln = LN1 of layer 0
  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float v = lg_to_f(static_cast<const T*>(p.x)[(size_t)r * d + c]);
      sh.row[c] = v;
      xacc[(size_t)r * d + c] = v;
    }
    __syncthreads();
    layernorm_row(sh.row, vecs, vecs + d, hln + (size_t)r * d, d, p.eps,
                  sh.bsum);
    __syncthreads();
  }
  grid.sync();

  for (int l = 0; l < L; ++l) {
    const T* vec = vecs + (size_t)l * NV * d;

    // 1. q, k, v partial products
    gemv_phase<TW>(p, vec, l, GemvInput{hln, nullptr, 0}, d, d3, 0, partA, sh);
    grid.sync();

    // 2. attention over one key range of one (row, head); q/k/v reduced
    //    from the partial sums here; split 0 also takes the in-flight rows
    //    and emits the row's new K/V
    for (int it = blockIdx.x; it < n * H * NS; it += gridDim.x) {
      const int r = it / (H * NS), h = (it / NS) % H, s = it % NS;
      const int len = min(p.poss ? p.poss[r] : p.pos_dev ? *p.pos_dev : p.pos0,
                          W);
      const int lo = (int)((long long)len * s / NS);
      const int hi = (int)((long long)len * (s + 1) / NS);
      const long long slot = p.poss ? r : 0;
      const size_t krow = (((size_t)l * 2 + 0) * H + h) * (size_t)W;
      const TC* kb = static_cast<const TC*>(p.cache) + slot * p.slot_stride +
                     krow * kHD;
      const TC* vb = kb + (size_t)H * W * kHD;
      // row scales of an int8 cache: (slots, L, 2, H, W), slot_stride / hd
      const float* ksb = nullptr;
      const float* vsb = nullptr;
      if constexpr (kInt8<TC>) {
        ksb = p.kv_scales + slot * (p.slot_stride / kHD) + krow;
        vsb = ksb + (size_t)H * W;
      }
      const float2 q2 = qkv_pair(partA, vec, nkc, n, d, r, h * kHD);
      float m = LG_NEG, lsum = 0.f;
      float2 a = make_float2(0.f, 0.f);
      for (int j0 = lo + warp * kKeyBatch; j0 < hi;
           j0 += kWarps * kKeyBatch) {
        float2 kk[kKeyBatch], vv[kKeyBatch];
        float ks[kKeyBatch], vs[kKeyBatch];
#pragma unroll
        for (int u = 0; u < kKeyBatch; ++u) {
          const int j = min(j0 + u, hi - 1);
          kk[u] = lg_load2(kb + (size_t)j * kHD + 2 * lane);
          vv[u] = lg_load2(vb + (size_t)j * kHD + 2 * lane);
          if constexpr (kInt8<TC>) {
            ks[u] = __ldg(ksb + j) * p.scale;
            vs[u] = __ldg(vsb + j);
          } else {
            ks[u] = p.scale;
          }
        }
#pragma unroll
        for (int u = 0; u < kKeyBatch; ++u) {
          if (j0 + u < hi) {
            const float sc =
                lg_warp_sum(q2.x * kk[u].x + q2.y * kk[u].y) * ks[u];
            if constexpr (kInt8<TC>) {  // V scale: context only, not l
              vv[u].x *= vs[u];
              vv[u].y *= vs[u];
            }
            online_update(sc, vv[u], m, lsum, a);
          }
        }
      }
      if (s == 0 && warp == 0) {  // in-flight rows, at full f32 precision
        for (int j = p.poss ? r : 0; j <= r; ++j) {
          const float2 k2 = qkv_pair(partA, vec, nkc, n, d, j, d + h * kHD);
          const float2 v2 =
              qkv_pair(partA, vec, nkc, n, d, j, 2 * d + h * kHD);
          if (j == r) {
            T* kr = static_cast<T*>(p.kv_out) +
                    (((size_t)l * 2) * n + r) * d + h * kHD;
            T* vr = kr + (size_t)n * d;
            kr[2 * lane] = lg_from_f<T>(k2.x);
            kr[2 * lane + 1] = lg_from_f<T>(k2.y);
            vr[2 * lane] = lg_from_f<T>(v2.x);
            vr[2 * lane + 1] = lg_from_f<T>(v2.y);
          }
          const float sc = lg_warp_sum(q2.x * k2.x + q2.y * k2.y) * p.scale;
          online_update(sc, v2, m, lsum, a);
        }
      }
      if (lane == 0) {
        sh.am[warp] = m;
        sh.al[warp] = lsum;
      }
      sh.aacc[warp][2 * lane] = a.x;
      sh.aacc[warp][2 * lane + 1] = a.y;
      __syncthreads();
      if (threadIdx.x < kHD) {
        float M = LG_NEG;
#pragma unroll
        for (int w8 = 0; w8 < kWarps; ++w8) M = fmaxf(M, sh.am[w8]);
        float Ls = 0.f, A = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < kWarps; ++w8) {
          const float e = expf(sh.am[w8] - M);
          Ls = fmaf(sh.al[w8], e, Ls);
          A = fmaf(sh.aacc[w8][threadIdx.x], e, A);
        }
        const size_t item = ((size_t)r * H + h) * kMaxSplit + s;
        sacc[item * kHD + threadIdx.x] = A;
        if (threadIdx.x == 0) {
          sm[item] = M;
          sl[item] = Ls;
        }
      }
      __syncthreads();
    }
    grid.sync();

    // 3. merge the key ranges: att = context / denominator
    for (int i = tid; i < n * d; i += nthreads) {
      const int r = i / d, c = i % d;
      const size_t base = ((size_t)r * H + c / kHD) * kMaxSplit;
      float M = LG_NEG;
      for (int s = 0; s < NS; ++s) M = fmaxf(M, __ldcg(sm + base + s));
      float Ls = 0.f, A = 0.f;
      for (int s = 0; s < NS; ++s) {
        const float e = expf(__ldcg(sm + base + s) - M);
        Ls = fmaf(__ldcg(sl + base + s), e, Ls);
        A = fmaf(__ldcg(sacc + (base + s) * kHD + c % kHD), e, A);
      }
      att[i] = A / Ls;
    }
    grid.sync();

    // 4. proj partial products
    gemv_phase<TW>(p, vec, l, GemvInput{att, nullptr, 0}, d, d, 3, partB, sh);
    grid.sync();

    // 5. residual += proj + bias; hln = LN2
    for (int r = blockIdx.x; r < n; r += gridDim.x) {
      for (int c = threadIdx.x; c < d; c += kThreads) {
        float s = __ldcg(xacc + (size_t)r * d + c) + lg_ldg(vec + 4 * d + c);
#pragma unroll 4
        for (int kc = 0; kc < nkc; ++kc)
          s += __ldcg(partB + ((size_t)kc * n + r) * d + c);
        xacc[(size_t)r * d + c] = s;
        sh.row[c] = s;
      }
      __syncthreads();
      layernorm_row(sh.row, vec + 2 * d, vec + 3 * d, hln + (size_t)r * d, d,
                    p.eps, sh.bsum);
      __syncthreads();
    }
    grid.sync();

    // 6. fc partial products
    gemv_phase<TW>(p, vec, l, GemvInput{hln, nullptr, 0}, d, Rd, 4, partA, sh);
    grid.sync();

    // 7. fc2 partial products over gelu(fc + bias), reduced while staging
    gemv_phase<TW>(p, vec, l, GemvInput{nullptr, partA, nkc}, Rd, d, 4 + R,
               partB, sh);
    grid.sync();

    // 8. residual += fc2 + bias; hln = next layer's LN1, or x_out
    for (int r = blockIdx.x; r < n; r += gridDim.x) {
      for (int c = threadIdx.x; c < d; c += kThreads) {
        float s = __ldcg(xacc + (size_t)r * d + c) + lg_ldg(vec + 5 * d + c);
#pragma unroll 4
        for (int kc = 0; kc < nkc2; ++kc)
          s += __ldcg(partB + ((size_t)kc * n + r) * d + c);
        xacc[(size_t)r * d + c] = s;
        sh.row[c] = s;
        if (l == L - 1)
          static_cast<T*>(p.x_out)[(size_t)r * d + c] = lg_from_f<T>(s);
      }
      __syncthreads();
      if (l + 1 < L) {
        const T* nvec = vec + (size_t)NV * d;
        layernorm_row(sh.row, nvec, nvec + d, hln + (size_t)r * d, d, p.eps,
                      sh.bsum);
      }
      __syncthreads();
    }
    grid.sync();
  }
}

int supported(int d, int hd, int n) {
  if (hd != kHD) return 1;
  if (d % 64 != 0 || d > kMaxD || d < 64) return 2;
  if (n < 1 || n > kMaxN) return 3;
  return 0;
}

template <typename T, typename TW, typename TC>
int grid_blocks(int* blocks) {
  // one cache per instantiation: the int8 variants use other registers
  static int cached_dev = -1, cached_blocks = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != cached_dev) {
    int coop = 0, sms = 0, occ = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, decode_stack_kernel<T, TW, TC>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached_blocks = sms * (occ < 2 ? occ : 2);
    cached_dev = dev;
  }
  *blocks = cached_blocks;
  return 0;
}

template <typename T, typename TW, typename TC>
int launch(const StackParams& prm, cudaStream_t stream) {
  int blocks = 0;
  const int e = grid_blocks<T, TW, TC>(&blocks);
  if (e) return e;
  void* args[] = {(void*)&prm};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)decode_stack_kernel<T, TW, TC>, dim3(blocks),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One instantiation's launch, or with p null its cooperative grid's blocks.
template <typename T, typename TW, typename TC>
int run(const StackParams* p, cudaStream_t st, int* grid) {
  return p ? launch<T, TW, TC>(*p, st) : grid_blocks<T, TW, TC>(grid);
}

// The instantiation for (compute type, int8 weights, int8 cache).
template <typename T>
int dispatch(const StackParams* p, int w_int8, int kv_int8, cudaStream_t st,
             int* grid) {
  if (w_int8)
    return kv_int8 ? run<T, int8_t, int8_t>(p, st, grid)
                   : run<T, int8_t, T>(p, st, grid);
  return kv_int8 ? run<T, T, int8_t>(p, st, grid) : run<T, T, T>(p, st, grid);
}

}  // namespace

extern "C" {

// f32 workspace elements: xacc, hln, att (n x d each); two partial-sum
// buffers sized for the widest product (qkv: 3d columns, fc: Rd); the key
// ranges' maxima, sums and contexts.
long long lg_decode_stack_workspace(int n, int d, int R) {
  const long long nd = (long long)n * d;
  const long long npart = (long long)(d / chunk_rows(d)) * nd * (R > 3 ? R : 3);
  const long long nsplit = (long long)n * (d / kHD) * kMaxSplit;
  return 3 * nd + 2 * npart + nsplit * (2 + kHD);
}

// Blocks of one instantiation's cooperative grid (0 on error).
int lg_decode_stack_grid(int is_bf16, int w_int8, int kv_int8) {
  int blocks = 0;
  const int e = is_bf16
      ? dispatch<__nv_bfloat16>(nullptr, w_int8, kv_int8, nullptr, &blocks)
      : dispatch<float>(nullptr, w_int8, kv_int8, nullptr, &blocks);
  return e ? 0 : blocks;
}

int lg_decode_stack(const void* x, const void* cache, long long slot_stride,
                    const void* poss, int pos0, const void* pos_dev,
                    const void* slabs,
                    const void* vecs, const void* scales,
                    const void* kv_scales, void* x_out, void* kv_out,
                    void* ws, int n, int L, int d, int H, int W, int R,
                    float eps, float scale, int is_bf16, int w_int8,
                    int kv_int8, void* stream) {
  if (supported(d, d / H, n) || H * kHD != d || (w_int8 && !scales) ||
      (kv_int8 && !kv_scales))
    return (int)cudaErrorInvalidValue;
  const StackParams p{x,
                      cache,
                      slot_stride,
                      static_cast<const int*>(poss),
                      pos0,
                      static_cast<const int*>(pos_dev),
                      slabs,
                      vecs,
                      static_cast<const float*>(scales),
                      static_cast<const float*>(kv_scales),
                      x_out,
                      kv_out,
                      static_cast<float*>(ws),
                      n, L, d, H, W, R, eps, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(&p, w_int8, kv_int8, st, nullptr)
                 : dispatch<float>(&p, w_int8, kv_int8, st, nullptr);
}

}  // extern "C"
