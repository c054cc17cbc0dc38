// One decoded token's attention over a fixed-window KV cache, with the key
// range split across blocks and merged ("flash decoding").
//
// Replaces the TPU kernel lightgrad_tpu/ops/decode_attention.py::
// decode_attention -> _kernel: scores + `col <= pos` mask (+ sliding-window
// band) + softmax + context, and its call shape under the JAX package's
// jax.vmap (LLaMA's batched step): a slot axis.  Layout: q (B, KV, G, hd)
// -- B slots, the G query heads served by each KV head; each slot's kc, vc
// (KV, W, hd), slots a fixed stride apart (the strided views of a stacked
// cache); out as q.  Slot b's position is read by the kernel from device
// memory (the TPU kernel's SMEM scalar), so a launch captured in a CUDA
// graph replays at whatever position the tensor holds then.
//
// What bounds it on this card: the cache bytes, 2 * nv * hd elements per KV
// head over the nv visible keys, read once; the arithmetic is two
// multiply-adds per element and query row.  A call is short (microseconds),
// so what counts is how many bytes are in flight and how few steps wait on
// each other.  The grid is (KV, n_split, B): block s of head h takes the
// s-th of n_split contiguous ranges of slot b's visible keys [lo, hi]
// (boundaries lo + s * nv / n_split).  The planner `plan_splits` of
// ops/decode_attention.py aims at two blocks an SM over the most rows the
// cache can show (the window, or W), never the position, so a model with
// one KV head (Gemma-2B) still fills the card; at a short position ranges
// are short or, past nv, empty: such a block writes an empty partial
// (m LG_NEG, l 0), which the merge weighs e^(LG_NEG - M) = 0.  Only the
// visible rows are read -- masked rows would contribute exp(-1e30 - m) = 0,
// so skipping them is exact.  Each block's four warps keep online-softmax
// states of their own (running max m, denominator l, context acc; f32),
// folded at the end in warp order (`finish`).  With n_split 1 the block
// writes the output; otherwise it writes its partial (m, l, acc[G, hd]) to
// scratch the wrapper allocates, and decode_merge_kernel, a second launch
// that starts while the first runs (programmatic dependent launch) and
// waits for its results, writes out = sum_s acc_s e^(m_s - M) / sum_s l_s
// e^(m_s - M), M = max_s m_s, in a fixed order (no atomics), for all slots.
//
// bfloat16 (decode_attention_tc_kernel): the tensor cores take the
// products, so the block is a pipe for bytes.  A block stages its range in
// 64-key stages of K and V rows by cp.async 16-byte copies, the whole range
// in flight at once where it fits a ring of 192 KB; the G query rows are
// rows of a 16-row mma.sync tile; each warp takes 16 keys of a stage: S = Q
// K^T and O += P V by m16n8k16, the operands by ldmatrix (V transposed on
// the way, so it stays row-major), the softmax on S's fragment.
//
// float32 (decode_attention_kernel, on the CUDA cores: tensor cores would
// round f32 to TF32): every group of LPR lanes (LPR the power of two >= a
// row's 16-byte chunks, at most 32) is a stream of its own, taking key rows
// kU a step with no barrier in the key loop; a lane holds its 16-byte
// chunks of the query rows (GP: G rounded up to 1, 4 or 8) and of the
// context; the next step's rows are loaded as soon as this step's are used
// (K after the scores, V after the context), so two steps' rows are in
// flight; a row's G dot products are summed over its lanes by halving
// exchanges (row_sums) and gathered through a few words of shared memory.
//
// Head dims: any hd with hd % 8 == 0 and 8 <= hd <= 256 (the TPU kernel
// takes any): bf16 runs the next wider D of 64, 128, 256 at row stride hd,
// columns past hd zero; f32 the narrowest (LPR, NCH chunks a lane) that
// holds a row, lanes past the row's chunks reading nothing.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxSplit = 256;  // the merge's weights are in shared memory

// The operands of a launch: B slots of q (B, KV, G, hd), caches of KV
// heads of W rows each slot (slot b's at kc / vc + b * c_slot), out like q.
// Slot b's token sits at poss[b] (int32 on the device, read by the kernel)
// or, without poss, at pos0 for every slot.
struct DecArgs {
  const void* q;
  const void* kc;
  const void* vc;
  void* out;
  float* part;        // B * KV * n_split * G * (hd + 2) f32, or nullptr
  const int* poss;    // (B,) or nullptr
  int pos0;
  long long c_slot;
  int KV, G, W, hd, window, n_split;
  float scale;
};

// Block (h, sp, z)'s keys: slot z's visible rows [lo, hi] = [max(0, pos -
// window + 1), min(pos, W - 1)], nv of them, cut into n_split contiguous
// ranges at lo + s * nv / n_split.  n_split is planned from the most rows
// the cache can show (the window, or W), so at a short position some
// ranges are empty: their blocks write an empty partial (running max
// LG_NEG, sum 0), which the merge weighs by e^(LG_NEG - M) = 0.
struct KeyRange {
  int b, n;
};
__device__ __forceinline__ KeyRange key_range(const DecArgs& a) {
  const int pos = a.poss ? a.poss[blockIdx.z] : a.pos0;
  const int hi = min(pos, a.W - 1);
  const int lo = a.window > 0 ? max(0, pos - a.window + 1) : 0;
  const long long nv = max(0, hi - lo + 1);
  const int sp = blockIdx.y;
  const int b = lo + (int)(sp * nv / a.n_split);
  return {b, lo + (int)((sp + 1) * nv / a.n_split) - b};
}

// elements of one slot's q / out, and floats of one slot's partials
__device__ __forceinline__ size_t slot_elems(const DecArgs& a) {
  return (size_t)a.KV * a.G * a.hd;
}
__device__ __forceinline__ size_t slot_part(const DecArgs& a) {
  return (size_t)a.KV * a.n_split * a.G * (a.hd + 2);
}

// a 16-byte chunk of four f32 elements
__device__ __forceinline__ void widen(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

// Sums each of a lane's N values over the 2 * O lanes of its row group
// (consecutive lanes), halving the values a lane holds at each step: a lane
// sends the half it gives up and adds its partner's copy of the half it
// keeps (N - 1 shuffles for N values, not N log2(2 O)).  On return a lane
// holds the sums of values [base, base + max(1, N / (2 O))) in v[0 ..);
// once one value is left, the remaining steps are a plain butterfly, so
// every lane of a sub-group holds the same sum.
template <int N, int O>
__device__ __forceinline__ void row_sums(float (&v)[kMaxG], int lane,
                                         int& base) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[H + i];
        const float keep = up ? v[H + i] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (up) base += H;
      row_sums<H, O / 2>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      row_sums<1, O / 2>(v, lane, base);
    }
  }
}

// The end of a block of either kernel: its warps' states are in `smem`,
// (warp, g) maxima, then (warp, g) denominators, then (warp, g, hd)
// contexts (kWarps each), G <= kMaxG rows.  Combines them in warp order
// and writes the output (n_split 1) or the block's partial.
template <typename T>
__device__ __forceinline__ void finish(T* __restrict__ out,
                                       float* __restrict__ part, float* smem,
                                       int G, int hd, int n_split) {
  const float* wm = smem;
  const float* wl = wm + kWarps * kMaxG;
  const float* wacc = wl + kWarps * kMaxG;
  const int h = blockIdx.x, sp = blockIdx.y, KV = gridDim.x;
  const int t = threadIdx.x;
  const size_t slot = (size_t)h * n_split + sp;
  float* pacc = part;                                // (KV, ns, G, hd)
  float* pm = part + (size_t)KV * n_split * G * hd;  // (KV, ns, G)
  float* pl = pm + (size_t)KV * n_split * G;         // (KV, ns, G)
  for (int e = t; e < G * hd; e += kThreads) {
    const int g = e / hd;
    float M = LG_NEG;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kMaxG + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * kMaxG + g] - M);
      L = fmaf(wl[w * kMaxG + g], f, L);
      A = fmaf(wacc[(size_t)w * G * hd + e], f, A);
    }
    if (n_split == 1) {
      out[(size_t)h * G * hd + e] = lg_from_f<T>(A / L);
    } else {
      pacc[slot * G * hd + e] = A;
      if (e % hd == 0) {
        pm[slot * G + g] = M;
        pl[slot * G + g] = L;
      }
    }
  }
}

// shared memory of a block's end: the warps' states
inline size_t finish_bytes(int G, int hd) {
  return sizeof(float) * kWarps * (2 * kMaxG + (size_t)G * hd);
}

// Each split kernel lets the merge launch as soon as all its blocks run
// (programmatic dependent launch); the merge waits for the split kernel's
// completion and memory before it reads a partial.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The merge of n_split partials: one block per (KV head, query row, 32
// columns).  Warp 0 weighs the splits, w_s = e^(m_s - M), M = max_s m_s,
// and sums l_s w_s; each warp then sums every kWarpsM-th split's contexts
// over the block's columns, and the warps' sums are added in order.
constexpr int kWarpsM = 8;
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsM)
decode_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                    int KV, int G, int hd, int n_split) {
  // z: (slot, 32-column chunk)
  __shared__ float wgt[kMaxSplit];
  __shared__ float sums[kWarpsM][32];
  __shared__ float inv_l;
  wait_primary();
  const int h = blockIdx.x, g = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nzc = (hd + 31) / 32, slot = blockIdx.z / nzc;
  const int col = (blockIdx.z % nzc) * 32 + lane;
  part += (size_t)slot * KV * n_split * G * (hd + 2);
  out += (size_t)slot * KV * G * hd;
  const size_t nacc = (size_t)KV * n_split * G * hd;
  const float* pm = part + nacc + (size_t)h * n_split * G + g;
  const float* pl = pm + (size_t)KV * n_split * G;
  if (warp == 0) {
    float m = LG_NEG;
    for (int s = lane; s < n_split; s += 32) m = fmaxf(m, pm[(size_t)s * G]);
    m = lg_warp_max(m);
    float l = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float w = expf(pm[(size_t)s * G] - m);
      wgt[s] = w;
      l = fmaf(pl[(size_t)s * G], w, l);
    }
    l = lg_warp_sum(l);
    if (lane == 0) inv_l = 1.f / l;
  }
  __syncthreads();
  const float* pa = part + ((size_t)h * n_split * G + g) * hd + col;
  float s = 0.f;
  if (col < hd) {
#pragma unroll 4
    for (int sp = warp; sp < n_split; sp += kWarpsM)
      s = fmaf(pa[(size_t)sp * G * hd], wgt[sp], s);
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < hd) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsM; ++w) tot += sums[w][lane];
    out[((size_t)h * G + g) * hd + col] = lg_from_f<T>(tot * inv_l);
  }
}

// the state of one stream (or a combination of streams) for row g: fold
// in (m2, l2, acc2)
template <int N>
__device__ __forceinline__ void fold(float& m, float& l, float (&acc)[N],
                                     float m2, float l2,
                                     const float (&acc2)[N]) {
  const float M = fmaxf(m, m2);
  const float a = expf(m - M), b = expf(m2 - M);
  l = l * a + l2 * b;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * a + acc2[i] * b;
  m = M;
}

// key rows a stream of the f32 kernel takes a step, by the floats of query
// rows (and of contexts) a lane holds: 2 to 8, so that nothing spills
__host__ __device__ constexpr int steps_of(int held) {
  return held >= 64 ? 2 : held >= 32 ? 4 : 8;
}

// LPR lanes a key row, NCH 16-byte chunks a lane, GP query rows held
template <int LPR, int NCH, int GP>
__global__ void __launch_bounds__(kThreads, 2)
decode_attention_kernel(const DecArgs a) {
  constexpr int EPC = 4;               // elements a 16-byte chunk
  constexpr int RPW = 32 / LPR;        // streams a warp
  constexpr int NA = NCH * EPC;        // context elements a lane a row
  // key rows a stream takes a step: fewer where the query rows and
  // contexts take many registers (8 at 32 or fewer floats of each)
  constexpr int kU = steps_of(GP * NA);
  constexpr int R = kU * RPW;          // rows a warp takes a step
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  launch_dependents();

  const int G = a.G, W = a.W, hd = a.hd, n_split = a.n_split;
  const float scale = a.scale;
  const size_t z = blockIdx.z;
  const float* __restrict__ q =
      static_cast<const float*>(a.q) + z * slot_elems(a);
  const float* __restrict__ kc = static_cast<const float*>(a.kc) + z * a.c_slot;
  const float* __restrict__ vc = static_cast<const float*>(a.vc) + z * a.c_slot;
  float* __restrict__ out = static_cast<float*>(a.out) + z * slot_elems(a);
  float* __restrict__ part = a.part ? a.part + z * slot_part(a) : nullptr;
  const int h = blockIdx.x;
  const KeyRange kr0 = key_range(a);
  const int b = kr0.b, n = kr0.n;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int sub = lane / LPR, cl = lane % LPR;
  const int chunks = hd / EPC;  // 16-byte chunks a row
  const float* kh = kc + ((size_t)h * W + b) * hd;
  const float* vh = vc + ((size_t)h * W + b) * hd;
  float* sc = smem + warp * GP * R;  // this warp's scores of a step

  // this lane's chunks of the query rows
  float qr[GP][NCH][EPC];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = cl + j * LPR;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (g < G && c < chunks)
        u = *reinterpret_cast<const uint4*>(q + ((size_t)h * G + g) * hd +
                                            c * EPC);
      widen(u, qr[g][j]);
    }
  float m[GP], l[GP], acc[GP][NA];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = LG_NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[g][i] = 0.f;
  }

  // row u of the step at row r0 of the range: r0 + u * RPW + sub
  uint4 kr[kU][NCH], vr[kU][NCH];
  auto load = [&](uint4 (&dst)[kU][NCH], const float* base, int r0) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int r = r0 + u * RPW + sub, c = cl + j * LPR;
        dst[u][j] = make_uint4(0u, 0u, 0u, 0u);
        if (r < n && c < chunks)
          dst[u][j] = *reinterpret_cast<const uint4*>(
              base + (size_t)r * hd + c * EPC);
      }
  };
  constexpr int kStride = kWarps * R;  // rows between a warp's steps
  int r0 = warp * R;
  load(kr, kh, r0);
  load(vr, vh, r0);
  for (; r0 < n; r0 += kStride) {
    // scores of the step's rows; then the next step's K rows
    float s[kU][GP];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float p[kMaxG];
#pragma unroll
      for (int g = 0; g < GP; ++g) p[g] = 0.f;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        float kx[EPC];
        widen(kr[u][j], kx);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int e = 0; e < EPC; ++e) p[g] = fmaf(qr[g][j][e], kx[e], p[g]);
      }
      int g0 = 0;
      row_sums<GP, LPR / 2>(p, lane, g0);
      // GP / LPR sums a lane, or one sum shared by LPR / GP lanes
      constexpr int kHeld = GP / LPR > 1 ? GP / LPR : 1;
      constexpr int kShare = LPR / GP > 1 ? LPR / GP : 1;
      if (cl % kShare == 0) {
#pragma unroll
        for (int i = 0; i < kHeld; ++i)
          sc[(g0 + i) * R + u * RPW + sub] = p[i] * scale;
      }
    }
    load(kr, kh, r0 + kStride);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int g = 0; g < GP; ++g) s[u][g] = sc[g * R + u * RPW + sub];
    __syncwarp();  // the next step's scores overwrite these

    // the online softmax and the context; then the next step's V rows
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (r0 + u * RPW + sub < n) mx = fmaxf(mx, s[u][g]);
      const float corr = expf(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[g][i] *= corr;
      m[g] = mx;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float pu =
            r0 + u * RPW + sub < n ? expf(s[u][g] - mx) : 0.f;
        l[g] += pu;
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          float vx[EPC];
          widen(vr[u][j], vx);
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            acc[g][j * EPC + e] = fmaf(pu, vx[e], acc[g][j * EPC + e]);
        }
      }
    }
    load(vr, vh, r0 + kStride);
  }

  // the warp's streams, folded: lanes of one chunk column across sub
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float a2[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i)
        a2[i] = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
      fold(m[g], l[g], acc[g], __shfl_xor_sync(0xffffffffu, m[g], o),
           __shfl_xor_sync(0xffffffffu, l[g], o), a2);
    }
  // the block's warps, through shared memory
  __syncthreads();  // the score words are no longer read
  float* wm = smem;
  float* wl = wm + kWarps * kMaxG;
  float* wacc = wl + kWarps * kMaxG;
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g >= G) break;
      if (cl == 0) {
        wm[warp * kMaxG + g] = m[g];
        wl[warp * kMaxG + g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int c = cl + j * LPR;
        if (c < chunks) {
          float* dst = wacc + ((size_t)warp * G + g) * hd + c * EPC;
#pragma unroll
          for (int e = 0; e < EPC; ++e) dst[e] = acc[g][j * EPC + e];
        }
      }
    }
  }
  __syncthreads();
  finish(out, part, smem, G, hd, n_split);
}

template <int LPR, int NCH, int GP>
int launch_f32(const DecArgs& a, int B, cudaStream_t stream) {
  const int G = a.G, hd = a.hd;
  constexpr int kU = steps_of(GP * NCH * 4);  // as in the kernel
  const size_t scores = sizeof(float) * kWarps * GP * kU * (32 / LPR);
  const size_t ends = finish_bytes(G, hd);
  const size_t smem = scores > ends ? scores : ends;
  auto kernel = decode_attention_kernel<LPR, NCH, GP>;
  if (smem + 1024 > 48 * 1024) {  // past the default, static words included
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(a.KV, a.n_split, B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// float32: the narrowest instantiation whose lanes hold a row's chunks
int launch_f32_hd(const DecArgs& a, int B, cudaStream_t st) {
  const int chunks = a.hd / 4, G = a.G;
#define LG_DECODE_G(LPR, NCH, GP) return launch_f32<LPR, NCH, GP>(a, B, st)
#define LG_DECODE(LPR, NCH)               \
  {                                       \
    if (G == 1) LG_DECODE_G(LPR, NCH, 1); \
    if (G <= 4) LG_DECODE_G(LPR, NCH, 4); \
    LG_DECODE_G(LPR, NCH, kMaxG);         \
  }
  if (chunks <= 2) LG_DECODE(2, 1);
  if (chunks <= 4) LG_DECODE(4, 1);
  if (chunks <= 8) LG_DECODE(8, 1);
  if (chunks <= 16) LG_DECODE(16, 1);
  if (chunks <= 32) LG_DECODE(32, 1);
  LG_DECODE(32, 2);
#undef LG_DECODE
#undef LG_DECODE_G
}

// ---- bfloat16: the tensor-core kernel ----------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcKeys = 64;  // keys a stage: 16 a warp

template <int D>
struct DecTc {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kStageBytes = 2 * kTcKeys * kRowBytes;  // K, then V
  // the deepest ring in 192 KB: 12 stages at D 64, 6 at 128, 3 at 256
  static constexpr int kStages = 192 * 1024 / kStageBytes;
};

// cp.async.wait_group takes an immediate: wait until at most n groups
// (n < 16) are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
#define LG_WAIT(N) \
  case N:          \
    lg_cp_async_wait<N>(); \
    break;
    LG_WAIT(0) LG_WAIT(1) LG_WAIT(2) LG_WAIT(3) LG_WAIT(4) LG_WAIT(5)
    LG_WAIT(6) LG_WAIT(7) LG_WAIT(8) LG_WAIT(9) LG_WAIT(10)
#undef LG_WAIT
    default:
      lg_cp_async_wait<11>();
  }
}

// the byte offset of 16-byte chunk c of row r in a stage's K or V tile:
// chunks swizzled by the row's low bits, so that the 8 rows an ldmatrix
// reads lie in 8 different bank groups
template <int D>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// bfloat16 decode attention on the tensor cores: q (KV, G, hd), caches
// (KV, W, hd), any hd <= D (columns past hd zero).  The G query rows are
// rows 0..G-1 of a 16-row mma.sync tile (rows 8-15 zero); each warp takes
// 16 keys of every 64-key stage: S (16 x 16) = Q K^T, two m16n8k16 a
// 16-deep step with K's B fragments by ldmatrix; the online softmax on S's
// fragment (a row lives in the 4 lanes of a quad); O (16 x D) += P V, P's
// f32 fragment packed to bf16 as the A fragment and V's B fragments by
// ldmatrix.trans (V stays row-major).  Stages arrive by cp.async in a ring
// `ring` deep (the range's stages, up to kStages: a split's whole range is
// in flight at once), each warp's softmax state is its own, and `finish` folds
// the four warps and merges the splits.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_tc_kernel(const DecArgs a, int ring) {
  using C = DecTc<D>;
  constexpr int C8 = D / 8;  // 16-byte chunks a staged row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const uint32_t s0 = lg_smem_u32(smem4);

  const int G = a.G, W = a.W, hd = a.hd, n_split = a.n_split;
  const float scale = a.scale;
  const size_t z = blockIdx.z;
  const bf16* __restrict__ q = static_cast<const bf16*>(a.q) + z * slot_elems(a);
  const bf16* __restrict__ kc = static_cast<const bf16*>(a.kc) + z * a.c_slot;
  const bf16* __restrict__ vc = static_cast<const bf16*>(a.vc) + z * a.c_slot;
  bf16* __restrict__ out = static_cast<bf16*>(a.out) + z * slot_elems(a);
  float* __restrict__ part = a.part ? a.part + z * slot_part(a) : nullptr;
  const int h = blockIdx.x;
  const KeyRange kr0 = key_range(a);
  const int b = kr0.b, n = kr0.n;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* kh = kc + ((size_t)h * W + b) * hd;
  const bf16* vh = vc + ((size_t)h * W + b) * hd;
  const int nst = (n + kTcKeys - 1) / kTcKeys;

  launch_dependents();
  // stage i's K and V rows into ring slot i % ring
  auto stage = [&](int i) {
    const uint32_t base = s0 + (i % ring) * C::kStageBytes;
    for (int e = t; e < kTcKeys * C8; e += kThreads) {
      const int r = e / C8, c = e % C8;
      const int row = i * kTcKeys + r;
      const bool ok = row < n && c * 8 < hd;
      const size_t off = ok ? (size_t)row * hd + c * 8 : 0;
      const uint32_t dst = base + tile_off<D>(r, c);
      lg_cp_async16(dst, kh + off, ok ? 16 : 0);
      lg_cp_async16(dst + kTcKeys * C::kRowBytes, vh + off, ok ? 16 : 0);
    }
  };
  for (int i = 0; i < ring - 1; ++i) {
    if (i < nst) stage(i);
    lg_cp_async_commit();
  }

  // Q's A fragments, rows g < G (rows g + 8 are zero: a1 = a3 = 0)
  uint32_t qa[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = kk * 16 + hf * 8 + 2 * tq;
      qa[kk][hf] = 0u;
      if (g < G && c < hd)
        qa[kk][hf] = *reinterpret_cast<const uint32_t*>(
            q + ((size_t)h * G + g) * hd + c);
    }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m = LG_NEG, l = 0.f;  // row g's state (l: this lane's share)
  const int kw = warp * 16;   // this warp's keys of a stage

  for (int i = 0; i < nst; ++i) {
    if (i + ring - 1 < nst) stage(i + ring - 1);
    lg_cp_async_commit();
    cp_async_wait_upto(ring - 1);
    __syncthreads();
    const uint32_t kt = s0 + (i % ring) * C::kStageBytes;
    const uint32_t vt = kt + kTcKeys * C::kRowBytes;

    // S = Q K^T over this warp's 16 keys: two n8 tiles
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // matrices: (keys +0, cols +0), (keys +0, cols +8), (keys +8, +0),
      // (keys +8, +8) -> b0, b1 of key tile 0, b0, b1 of key tile 1
      uint32_t kb[4];
      lg_tc::ldmatrix_x4(kb, kt + tile_off<D>(kw + (mi >> 1) * 8 + mr,
                                              kk * 2 + (mi & 1)));
      lg_tc::mma_16816(sc[0], qa[kk][0], 0u, qa[kk][1], 0u, kb[0], kb[1]);
      lg_tc::mma_16816(sc[1], qa[kk][0], 0u, qa[kk][1], 0u, kb[2], kb[3]);
    }
    // row g's scores: keys kw + 8 j + 2 tq + {0, 1}
    const int k0 = i * kTcKeys + kw;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + (e >> 1) * 8 + 2 * tq + (e & 1);
      x[e] = key < n ? sc[e >> 1][e & 1] * scale : LG_NEG;
    }
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, m);
    const float corr = expf(m - mx);
    m = mx;
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = x[e] == LG_NEG ? 0.f : expf(x[e] - mx);
    l = l * corr + (p[0] + p[1] + p[2] + p[3]);
    const uint32_t pa0 = lg_tc::pack_bf16(p[0], p[1]);  // keys 2tq, +1
    const uint32_t pa2 = lg_tc::pack_bf16(p[2], p[3]);  // keys 8 + 2tq, +1
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr;
      o[j][1] *= corr;
    }
    // O += P V: V's B fragments by ldmatrix.trans, two column tiles a call
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      // matrices: (keys +0, cols +0), (keys +8, cols +0), (keys +0, +8),
      // (keys +8, +8) -> b0, b1 of column tile 2j, b0, b1 of tile 2j + 1
      uint32_t vb[4];
      lg_tc::ldmatrix_x4_trans(
          vb, vt + tile_off<D>(kw + (mi & 1) * 8 + mr, j * 2 + (mi >> 1)));
      lg_tc::mma_16816(o[2 * j], pa0, 0u, pa2, 0u, vb[0], vb[1]);
      lg_tc::mma_16816(o[2 * j + 1], pa0, 0u, pa2, 0u, vb[2], vb[3]);
    }
    __syncthreads();  // the slot is refilled next iteration
  }
  lg_cp_async_wait<0>();
  __syncthreads();

  // this warp's state into the layout `finish` reads
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* wm = smem;
  float* wl = wm + kWarps * kMaxG;
  float* wacc = wl + kWarps * kMaxG;
  if (g < G) {
    if (tq == 0) {
      wm[warp * kMaxG + g] = m;
      wl[warp * kMaxG + g] = l;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * tq;
      if (c < hd) {
        float* dst = wacc + ((size_t)warp * G + g) * hd + c;
        dst[0] = o[j][0];
        dst[1] = o[j][1];
      }
    }
  }
  __syncthreads();
  finish(out, part, smem, G, hd, n_split);
}

template <int D>
int launch_tc(const DecArgs& a, int nv, int B, cudaStream_t stream) {
  using C = DecTc<D>;
  const int G = a.G, hd = a.hd;
  // the longest range of the most rows the cache can show
  const int most = (nv + a.n_split - 1) / a.n_split;
  const int nst = (most + kTcKeys - 1) / kTcKeys;
  const int ring = nst < C::kStages ? nst : C::kStages;
  const size_t ends = finish_bytes(G, hd);
  // a ring of 2 for a single stage, which takes one slot of it
  size_t smem = (size_t)ring * C::kStageBytes;
  smem = smem > ends ? smem : ends;
  auto kernel = decode_attention_tc_kernel<D>;
  static bool sized = false;  // the attribute, once: the deepest ring
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kStages * C::kStageBytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  kernel<<<dim3(a.KV, a.n_split, B), kThreads, smem, stream>>>(
      a, ring > 1 ? ring : 2);
  return (int)cudaGetLastError();
}

int launch_tc_hd(const DecArgs& a, int nv, int B, cudaStream_t st) {
  if (a.hd <= 64) return launch_tc<64>(a, nv, B, st);
  if (a.hd <= 128) return launch_tc<128>(a, nv, B, st);
  return launch_tc<256>(a, nv, B, st);
}

}  // namespace

extern "C" {

// B slots, each one token's queries q (B, KV, G, hd) over its own cache:
// kc, vc (KV, W, hd) at kc / vc + b * c_slot elements (c_slot 0 with B 1).
// Slot b's token is at poss[b] (B int32 on the device, read by the kernel:
// a captured launch replays at any position) or, with poss null, at pos0;
// keys at [max(0, pos - window + 1), pos] (window = 0: [0, pos]) are
// visible, clamped to the cache's W rows.  n_split: blocks a KV head,
// 1..min(min(W, window or W), 256), planned by the caller from the most
// rows the cache can show, never from pos; above 1 the blocks write f32
// partials to `part` (B * KV * n_split * G * (hd + 2) floats), which
// lg_decode_merge combines into `out`.  Returns cudaErrorInvalidValue for
// shapes the kernel lacks (hd % 8 != 0, hd < 8, hd > 256, G outside 1..8,
// an n_split outside its range, a host pos0 that sees no key).
int lg_decode_attention(const void* q, const void* kc, const void* vc,
                        void* out, void* part, const void* poss, int pos0,
                        int B, long long c_slot, int KV, int G, int W, int hd,
                        int window, float scale, int n_split, int is_bf16,
                        void* stream) {
  if (hd % 8 != 0 || hd < 8 || hd > 256 || G < 1 || G > kMaxG || B < 1 ||
      B > 65535 || W < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  const int nv = window > 0 && window < W ? window : W;  // the most rows
  if (n_split < 1 || n_split > nv || n_split > kMaxSplit ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (poss == nullptr) {
    const int hi = pos0 < W - 1 ? pos0 : W - 1;
    const int lo = window > 0 && pos0 - window + 1 > 0 ? pos0 - window + 1 : 0;
    if (pos0 < 0 || lo > hi) return (int)cudaErrorInvalidValue;
  }
  const DecArgs a{q,  kc, vc, out, static_cast<float*>(part),
                  static_cast<const int*>(poss), pos0, c_slot, KV, G, W, hd,
                  window, n_split, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_tc_hd(a, nv, B, st) : launch_f32_hd(a, B, st);
}

// The merge of lg_decode_attention's n_split partials into out (B, KV, G,
// hd), launched behind it on the same stream (programmatic dependent
// launch: its blocks start while the split kernel runs and wait for its
// results).
int lg_decode_merge(const void* part, void* out, int B, int KV, int G,
                    int hd, int n_split, int is_bf16, void* stream) {
  if (n_split < 2 || n_split > kMaxSplit || G < 1 || G > kMaxG || B < 1 ||
      (long long)B * ((hd + 31) / 32) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV, G, B * ((hd + 31) / 32));
  cfg.blockDim = dim3(32 * kWarpsM);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e =
      is_bf16 ? cudaLaunchKernelEx(&cfg, decode_merge_kernel<__nv_bfloat16>,
                                   (const float*)part, (__nv_bfloat16*)out, KV,
                                   G, hd, n_split)
              : cudaLaunchKernelEx(&cfg, decode_merge_kernel<float>,
                                   (const float*)part, (float*)out, KV, G, hd,
                                   n_split);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
