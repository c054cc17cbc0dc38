// Flash-attention forward for Hopper: (out, lse) of softmax(q k^T * scale) v.
//
// Replaces the TPU kernel lightgrad_tpu/ops/attention.py::_flash_fwd ->
// _fwd_kernel (and serves the call shapes of its two-heads-per-step variant
// _fwd_kernel_pair).  Layout: q (BH, S, d), k/v (BH/G, S, d) -- query row
// block bh reads KV row block bh / G (grouped-query, no repeated K/V);
// out (BH, S, d) in q's dtype, lse (BH, S) f32.  Two kernels, one by dtype:
//
// bfloat16: flash_fwd_tc_kernel, on the tensor cores.  At prefill the
// O(S^2 d) score and context products dwarf the O(S d) bytes, so the bound
// is the 989 TFLOP/s of bf16 `wgmma`.  A block is one warpgroup over 64
// query rows; its Q tile and a ring of two K/V stages of BK keys (64, or 32
// at D 256, where the 64 x 256 f32 context alone is 128 registers a thread
// and 64 keys' scores spill) sit in dynamic shared memory in the 128-byte
// swizzled layout of tensor_core.cuh, filled by cp.async 16-byte copies
// with zero-fill (rows past S, columns past d), so the next tile loads
// while the tensor cores work on this one; at most 97 KB, so two blocks
// share an SM, one's softmax beside the other's products.  Per K tile: S =
// Q K^T is D / 16 wgmma m64nBKk16 from shared memory (K-major both); the
// online softmax runs on the f32 accumulator fragment (a row lives in 4
// lanes: two shuffles for a max), with the mask by select on each
// element's (row, key) -- only on the tiles that hold the diagonal, the
// band's edge or the length; P, rounded to bf16 (as the TPU kernel's
// p.astype(v.dtype)) while l sums the f32 P, is the register A operand of O
// += P V, BK / 16 wgmma m64nDk16 with V read MN-major through the transpose
// bit (no transposing copy); O is rescaled once a tile.  Exponentials in
// base 2, the scale folded into log2(e).  Skipped: K tiles wholly above the
// block's diagonal or before its first row's band, K tiles past the length
// (TPU: _pair_relevant), Q tiles of padding alone.  Under `causal` the
// grid's first blocks take the last (heaviest) Q tiles of every head, for
// balance over the 132 SMs.
//
// float32: flash_fwd_tf32_kernel, on the tensor cores as three tf32 passes
// (flash_tf32.cuh: hi hi + hi lo + lo hi, each tile's share from zero; the
// TPU kernel computes f32 at Precision.HIGHEST).  What bounds it: the 495
// TFLOP/s of tf32 mma.sync, three passes a product.  A block is F32Tc<D>'s:
// 4 warps over 64 query rows (8 over 128 at D 96 and 128; at D 256 two
// warps a 16-row slab, each taking 128 of the columns, the two summing
// their halves of S over d through shared memory); Q resident, K and V
// tiles of 32 keys (16 at D 256) through a two-stage cp.async ring, rows D
// + 4 floats apart.  Per K tile: S = Q K^T with both operands K-major, read
// by ldmatrix and split into hi / lo by the threads as they load; the
// online softmax in f32 on the accumulator fragment (a row lives in 4
// lanes: two shuffles for a max), the mask by select only on the tiles that
// hold the diagonal, the band's edge, the length or a padded row; O = O
// corr + P V, with P taken from the accumulator fragment as the A operand
// (columns 2t, 2t + 1 as depths t, t + 4, V's rows read by the same
// permutation: no shuffles) and V MN-major by scalar loads.  Skipped as in
// bf16: K tiles above the block's diagonal, before its first row's band or
// past the length, and Q tiles of padding alone; under `causal` the
// heaviest Q tiles first.
//
// Both: masking selects (never multiplies), so a garbage or padded row
// cannot turn into NaN (TPU: _zero_oob_rows); rows past S are zero-filled in
// shared memory and masked.  Optional per-row valid lengths `lens` (BH
// int32; TPU: the lens_ref limit of _fwd_kernel): key j is valid for row
// block bh iff j < lens[bh], on top of `causal`, and K tiles past the length
// are never loaded.  A padded query row (i >= lens[bh]) sees no valid key:
// it writes zeros and an lse of 0, by select, as the TPU kernel's l_safe
// epilogue does (L = 0 included).  Optional sliding window `window` (> 0,
// causal only; TPU: _valid_mask's band and _pair_relevant's lower edge): key
// j is valid for row i only if i - j < window as well, and K tiles that end
// before the block's first row's band are never loaded, so a banded row
// costs O(window) keys instead of O(i).  A window of S or more bands nothing.
//
// Head dims: any d with d % 8 == 0 and 8 <= d <= 256 (the TPU kernel takes
// any).  The kernels are instantiated at D = 64, 128 and 256 (bf16; d <= 32
// runs on D 64) and 32, 64, 96, 128 and 256 (f32); a call with another d
// runs the next wider D, with rows addressed at stride d, the columns >= d
// loaded as zeros and never stored, so the result is exact.
#include "common.cuh"
#include "flash_tf32.cuh"
#include "tensor_core.cuh"

namespace {

// ---- float32: three tf32 passes on the tensor cores --------------------

template <int D>
__global__ void __launch_bounds__(F32Tc<D>::kThreads, F32Tc<D>::kMinBlocks)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, const int* __restrict__ lens,
                      int S, int G, int d, float scale, int causal,
                      int window) {
  using C = F32Tc<D>;
  constexpr int BR = C::BR, BK = C::BK, NT = C::kThreads, P = C::P;
  constexpr int NB = BK / 8, NN = C::DW / 8;
  extern __shared__ float4 smem_f4[];
  float* const sQ = reinterpret_cast<float*>(smem_f4);
  float* const ring = sQ + BR * P;  // stage s: K, then V
  float* const xb = ring + 4 * BK * P;
  const uint32_t uQ = lg_smem_u32(sQ), uR = lg_smem_u32(ring);

  const int bh = blockIdx.x;
  // causal: the heaviest Q tiles (the last) first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BR, q1 = q0 + BR - 1;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int slab = warp % C::SLABS, c0 = (warp / C::SLABS) * C::DW;
  const int limit = lens ? max(0, min(lens[bh], S)) : S;
  const float* kb = k + (size_t)(bh / G) * S * d;
  const float* vb = v + (size_t)(bh / G) * S * d;
  const float scale_log2 = scale * kLog2e;

  int nkt = (limit + BK - 1) / BK;
  if (causal) nkt = min(nkt, q1 / BK + 1);
  if (q0 >= limit) nkt = 0;  // every row of the block is padding
  // the band's lower edge: keys before the first row's band are dead
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  // this thread's two query rows: valid keys [klo, khi] (none for a padded
  // row)
  const int r0 = q0 + slab * 16 + lane / 4;
  int klo[2], khi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    klo[i] = window > 0 ? qi - window + 1 : 0;
    khi[i] = qi < limit ? (causal ? min(qi, limit - 1) : limit - 1) : -1;
  }

  auto stage_kv = [&](int kt, int s) {
    stage_f32<BK, D, NT>(uR + s * 2 * BK * P * 4, kb, kt * BK, S, d);
    stage_f32<BK, D, NT>(uR + (2 * s + 1) * BK * P * 4, vb, kt * BK, S, d);
  };
  if (kt0 < nkt) {
    stage_f32<BR, D, NT>(uQ, q + (size_t)bh * S * d, q0, S, d);
    stage_kv(kt0, 0);
    lg_cp_async_commit();
  }

  float acc[NN][4];  // O, unnormalised
  zero_frag(acc);
  // the rows' running max (scores in base 2) and exp-sum over this thread's
  // columns
  float m[2] = {LG_NEG, LG_NEG}, l[2] = {0.f, 0.f};
  for (int kt = kt0; kt < nkt; ++kt) {
    const int s = (kt - kt0) & 1;
    lg_cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < nkt) {
      stage_kv(kt + 1, s ^ 1);
      lg_cp_async_commit();
    }

    // S = Q K^T (over this warp's columns; at WN 2 the slab's two halves
    // summed)
    float sc[NB][4];
    product_xyt<NB, C::DW, P>(sc, uQ + slab * 16 * P * 4,
                              uR + s * 2 * BK * P * 4, c0, lane);
    if constexpr (C::WN > 1)
      exchange<NB>(sc, xb, warp, (warp + C::SLABS) % C::NW, lane);

    // the mask (a select, so a masked score is never a NaN's source) only
    // where this tile holds the diagonal, the band's edge, the length or a
    // padded row
    const int k0 = kt * BK;
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 < q1 - window + 1) ||
                      k0 + BK > limit || q1 >= limit;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = sc[nb][e] * scale_log2;
        if (edge) {
          const int kj = k0 + nb * 8 + (lane & 3) * 2 + (e & 1);
          if (kj < klo[i] || kj > khi[i]) x = LG_NEG;
        }
        sc[nb][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
    // P in f32: into l, and the A operand of O += P V
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = sc[nb][e] == LG_NEG ? 0.f : exp2f(sc[nb][e] - m[i]);
        l[i] += p;
        sc[nb][e] = p;
      }
#pragma unroll
    for (int nn = 0; nn < NN; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nn][e] *= corr[e >> 1];
    uint32_t fh[NB][4], fl[NB][4];
    to_a(fh, fl, sc);
    accumulate<NB, NN, P, false>(
        acc, acc, fh, fl, fh,
        ring + (2 * s + 1) * BK * P + 2 * (lane & 3) * P + lane / 4 + c0);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = r0 + 8 * i;
    if (qi >= S) continue;
    // a valid row always sees key qi itself (or every key < limit), so
    // l > 0 there; padded rows select 0
    const bool ok = qi < limit;
    const size_t r = (size_t)bh * S + qi;
    store_frag<NN>(out + r * d, acc, i, c0, lane, d, ok ? 1.f / l[i] : 0.f);
    if (c0 == 0 && (lane & 3) == 0)
      lse[r] = ok ? (m[i] + log2f(l[i])) * 0.69314718055994531f : 0.f;
  }
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* out,
                void* lse, const void* lens, int BH, int G, int S, int d,
                float scale, int causal, int window, cudaStream_t stream) {
  using C = F32Tc<D>;
  static bool sized = false;
  if (int e = smem_limit(flash_fwd_tf32_kernel<D>, C::kSmemFwd, sized))
    return e;
  const int nq = (S + C::BR - 1) / C::BR;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  flash_fwd_tf32_kernel<D>
      <<<dim3(BH, nq), C::kThreads, C::kSmemFwd, stream>>>(
          (const float*)q, (const float*)k, (const float*)v, (float*)out,
          (float*)lse, (const int*)lens, S, G, d, scale, causal, window);
  return (int)cudaGetLastError();
}

// the narrowest f32 instantiation that holds d columns
int launch_tf32_d(const void* q, const void* k, const void* v, void* out,
                  void* lse, const void* lens, int BH, int G, int S, int d,
                  float scale, int causal, int window, cudaStream_t st) {
  if (d <= 32)
    return launch_tf32<32>(q, k, v, out, lse, lens, BH, G, S, d, scale,
                           causal, window, st);
  if (d <= 64)
    return launch_tf32<64>(q, k, v, out, lse, lens, BH, G, S, d, scale,
                           causal, window, st);
  if (d <= 96)
    return launch_tf32<96>(q, k, v, out, lse, lens, BH, G, S, d, scale,
                           causal, window, st);
  if (d <= 128)
    return launch_tf32<128>(q, k, v, out, lse, lens, BH, G, S, d, scale,
                            causal, window, st);
  return launch_tf32<256>(q, k, v, out, lse, lens, BH, G, S, d, scale,
                          causal, window, st);
}

// ---- bfloat16: the tensor-core kernel ----------------------------------

using bf16 = __nv_bfloat16;

template <int D>
struct Tc {
  static constexpr int BQ = 64;         // query rows a block: one warpgroup
  static constexpr int kThreads = 128;
  // keys a K/V tile: 32 at D 256, where the 64 x 256 context takes 128
  // registers a thread and a 64-key tile's scores spill
  static constexpr int BK = (D == 256) ? 32 : 64;
  static constexpr int kQBytes = BQ * D * 2;
  static constexpr int kTileBytes = BK * D * 2;       // one K or V tile
  static constexpr int kStages = 2;
  // + 1 KB to align the swizzled tiles to 1024 bytes; at most 97 KB, so two
  // blocks share an SM, one's softmax beside the other's products
  static constexpr int kSmem = kQBytes + kStages * 2 * kTileBytes + 1024;
};

// S (64 x BK) = Q (64 x 16, shared) K^T (16 x BK, shared), both K-major
template <int BK>
__device__ __forceinline__ void qk_product(float (&s)[BK / 2], uint64_t a,
                                           uint64_t b, int accumulate) {
  if constexpr (BK == 32) lg_tc::wgmma_ss_n32(s, a, b, accumulate);
  else lg_tc::wgmma_ss_n64(s, a, b, accumulate);
}

// O (64 x D) += P (64 x 16, registers) V (16 x D, shared, MN-major)
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (D == 64) lg_tc::wgmma_rs_n64(o, a, b);
  else if constexpr (D == 128) lg_tc::wgmma_rs_n128(o, a, b);
  else lg_tc::wgmma_rs_n256(o, a, b);
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::kThreads, 2)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, const int* __restrict__ lens,
                    int S, int G, int d, float scale_log2, int causal,
                    int window) {
  using C = Tc<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::kThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (lg_smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::kQBytes;  // stage s: K, then V

  const int bh = blockIdx.x;
  // causal: the heaviest Q tiles (the last) first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int limit = lens ? max(0, min(lens[bh], S)) : S;
  const bf16* kb = k + (size_t)(bh / G) * S * d;
  const bf16* vb = v + (size_t)(bh / G) * S * d;

  int nkt = (limit + BK - 1) / BK;
  if (causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);
  if (q0 >= limit) nkt = 0;  // every row of the block is padding
  // the band's lower edge: keys before the first row's band are dead
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  // the block's rows [q0, q1], and this thread's two rows
  const int q1 = q0 + BQ - 1;
  const int r0 = q0 + warp * 16 + lane / 4;
  int klo[2], khi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    klo[i] = window > 0 ? qi - window + 1 : 0;
    khi[i] = causal ? min(qi, limit - 1) : limit - 1;
  }

  if (kt0 < nkt) {
    lg_tc::stage_rows<BQ, D, NT>(sQ, q + (size_t)bh * S * d, q0, S, d);
    lg_tc::stage_rows<BK, D, NT>(sKV, kb, kt0 * BK, S, d);
    lg_tc::stage_rows<BK, D, NT>(sKV + C::kTileBytes, vb, kt0 * BK, S, d);
    lg_cp_async_commit();
  }

  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m[2] = {LG_NEG, LG_NEG}, l[2] = {0.f, 0.f};

  for (int kt = kt0; kt < nkt; ++kt) {
    const uint32_t sK = sKV + ((kt - kt0) & 1) * 2 * C::kTileBytes;
    const uint32_t sV = sK + C::kTileBytes;
    if (kt + 1 < nkt) {
      // the other stage was released by the last iteration's barrier
      const uint32_t nK = sKV + ((kt + 1 - kt0) & 1) * 2 * C::kTileBytes;
      lg_tc::stage_rows<BK, D, NT>(nK, kb, (kt + 1) * BK, S, d);
      lg_tc::stage_rows<BK, D, NT>(nK + C::kTileBytes, vb, (kt + 1) * BK, S,
                                   d);
      lg_cp_async_commit();
      lg_cp_async_wait<1>();
    } else {
      lg_cp_async_wait<0>();
    }
    lg_tc::fence_proxy_async();
    __syncthreads();

    const int k0 = kt * BK;
    float s[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
    lg_tc::wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t col = (ks & 3) * 32;  // 16 columns = 32 bytes
      const uint64_t da = lg_tc::desc_sw128(
          sQ + (ks >> 2) * (BQ * 128) + col, 16, 1024);
      const uint64_t db =
          lg_tc::desc_sw128(sK + (ks >> 2) * (BK * 128) + col, 16, 1024);
      qk_product<BK>(s, da, db, ks > 0);
    }
    lg_tc::wg_commit();
    lg_tc::wg_wait0();
    lg_tc::fence_regs(s);

    // the mask, where this tile holds the diagonal, the band's edge or
    // the length (a select, so a masked score is never a NaN's source)
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 < q1 - window + 1) ||
                      k0 + BK > limit;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int i = (e >> 1) & 1;
      float x = s[e] * scale_log2;
      if (edge) {
        const int kj = k0 + (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
        if (kj < klo[i] || kj > khi[i]) x = LG_NEG;
      }
      s[e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
    // P (f32 into l; bf16 pairs into the A fragments of O += P V)
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 8 * kk + 2 * j, i = j & 1;
        const float p0 = s[e] == LG_NEG ? 0.f : exp2f(s[e] - m[i]);
        const float p1 = s[e + 1] == LG_NEG ? 0.f : exp2f(s[e + 1] - m[i]);
        l[i] += p0 + p1;
        pa[kk][j] = lg_tc::pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
    lg_tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      pv_product<D>(o, pa[kk],
                    lg_tc::desc_sw128(sV + kk * 16 * 128, BK * 128, 1024));
    lg_tc::wg_commit();
    lg_tc::wg_wait0();
    lg_tc::fence_regs(o);
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = r0 + 8 * i;
    if (qi >= S) continue;
    // a valid row always sees key qi itself (or every key < limit), so
    // l > 0 there; padded rows select 0
    const bool ok = qi < limit;
    const float inv = ok ? 1.f / l[i] : 0.f;
    bf16* orow = out + ((size_t)bh * S + qi) * d;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int c = nb * 8 + (lane & 3) * 2;
      if (c < d)
        *reinterpret_cast<uint32_t*>(orow + c) = lg_tc::pack_bf16(
            o[nb * 4 + 2 * i] * inv, o[nb * 4 + 2 * i + 1] * inv);
    }
    if ((lane & 3) == 0)
      lse[(size_t)bh * S + qi] =
          ok ? (m[i] + log2f(l[i])) * 0.69314718055994531f : 0.f;
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, const void* lens, int BH, int G, int S, int d,
              float scale, int causal, int window, cudaStream_t stream) {
  static bool sized = false;
  if (int e = smem_limit(flash_fwd_tc_kernel<D>, Tc<D>::kSmem, sized))
    return e;
  const int nq = (S + Tc<D>::BQ - 1) / Tc<D>::BQ;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  flash_fwd_tc_kernel<D><<<dim3(BH, nq), Tc<D>::kThreads, Tc<D>::kSmem,
                           stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (float*)lse, (const int*)lens, S, G, d,
      scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

int launch_tc_d(const void* q, const void* k, const void* v, void* out,
                void* lse, const void* lens, int BH, int G, int S, int d,
                float scale, int causal, int window, cudaStream_t st) {
  if (d <= 64)
    return launch_tc<64>(q, k, v, out, lse, lens, BH, G, S, d, scale, causal,
                         window, st);
  if (d <= 128)
    return launch_tc<128>(q, k, v, out, lse, lens, BH, G, S, d, scale,
                          causal, window, st);
  return launch_tc<256>(q, k, v, out, lse, lens, BH, G, S, d, scale, causal,
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
  return is_bf16 ? launch_tc_d(q, k, v, out, lse, lens, BH, G, S, D, scale,
                               causal, window, st)
                 : launch_tf32_d(q, k, v, out, lse, lens, BH, G, S, D,
                                 scale, causal, window, st);
}

}  // extern "C"
