// Flash-attention backward for Hopper: dq, and dk/dv, of
// out = softmax(q k^T * scale) v, from the forward's (out, lse).
//
// Replaces the TPU kernels lightgrad_tpu/ops/attention.py::_flash_bwd ->
// _bwd_dq_kernel (the dq pass) and _bwd_dkv_kernel (the dk/dv pass), and
// _flash_bwd_fused -> _bwd_fused_kernel (the fused backward).  Layout as the
// forward (flash_fwd.cu): q, do, dq (BH, S, d); k, v, dk, dv (BH/G, S, d),
// query row block bh reading KV row block bh / G; lse and dcap =
// rowsum(do * out) (BH, S) f32.  lse is the natural log of the SCALED
// scores' exp-sum, exactly as the forward writes it, so p = exp(s*scale -
// lse) needs no renormalisation.  Every (query, key) pair costs three
// d-long products in a pass (the fused kernel five for both): the bound is
// the card's operations.  One kernel per pass and dtype:
//
// bfloat16, on the tensor cores (`wgmma`, tensor_core.cuh), 989 TFLOP/s:
//   dq pass (flash_bwd_dq_tc_kernel): one warpgroup over 64 query rows; Q
//     and dO sit in shared memory in the 128-byte swizzle, K and V tiles of
//     64 keys (32 at D 256, where dQ alone is 128 registers a thread)
//     stream through a cp.async ring of two stages.  Per tile S = Q
//     K^T and dP = dO V^T from shared memory (K-major both), P =
//     exp2(S scale log2e - lse log2e) and dS = P (dP - dcap) on the f32
//     fragment, then dQ += dS K with dS packed to bf16 straight from the
//     fragment into the register A operand and K read MN-major through the
//     transpose bit (the forward's P V trick).  No dcap refinement (the TPU
//     kernel has none; its ~1e-3 effect is below bf16's ulp, and the extra
//     P K product would double the accumulator, which does not fit at D
//     256): dcap_out = dcap.
//   dk/dv pass (flash_bwd_dkv_tc_kernel<D, false>): one warpgroup over 64
//     key rows of a KV head (K and V resident), Q, dO, lse and dcap tiles of
//     64 rows streaming through the ring, for all G query heads of the group
//     in turn (TPU: the inner grid index over (head, q block) pairs).  Per
//     tile S^T = K Q^T and dP^T = V dO^T, P^T and dS^T with lse and dcap
//     along the fragment's columns, then dV += P^T dO and dK += dS^T Q, both
//     A operands from registers, dO and Q MN-major.  At D 256, dK and dV of
//     64 x 256 f32 would take 256 registers a thread: two warpgroups share
//     the block's tiles, one computing S^T and accumulating dV, the other
//     S^T, dP^T and dK (S^T twice: 5 products a pair instead of 4, but no
//     exchange between them and P in f32 in both).  Where KV rows x key
//     blocks would leave the card short of two blocks an SM (few KV heads,
//     e.g. 2 KV rows x 16 blocks), ops.attention.dkv_splits shares a
//     group's G query heads out over up to G blocks, each writing f32 dK
//     and dV partials that the wrapper sums in order.
//   fused (flash_bwd_dkv_tc_kernel<D, true>; G 1, no lengths or window):
//     the dk/dv pass plus, per Q tile, dS^T to shared memory as bf16 and the
//     key block's share of the tile's dq, dS K, with dS read MN-major (16-bit
//     A operands may be) and K from the block's resident tile; at D 256 each
//     warpgroup takes 128 of the columns.
//   p and ds are rounded to bf16 before their products, as the TPU kernels'
//   p.astype and ds.astype do; every sum is f32.  Masks select and never
//   multiply, and only the tiles that hold the diagonal, the band's edge, a
//   length or a padded row pay for them.  Head dims: d <= 32 runs on D 64;
//   any other d with d % 8 == 0 on the next wider D (64, 128, 256) at row
//   stride d, the columns past d zero-filled by stage_rows and never stored.
//
// float32, on the tensor cores as three tf32 passes a product, 495 TFLOP/s
// (flash_tf32.cuh: mma.sync m16n8k8, operands split into hi / lo by the
// threads as they load them, each tile's share of a sum from zero; blocks,
// rows and tiles by F32Tc<D>, D 32, 64, 96, 128 and 256).  Shared memory at
// D 32 / 64 / 96 / 128 / 256, dq (Q and dO, two stages of K and V): 36 / 68
// / 150 / 198 / 211 KB; dk/dv (K and V, two stages of Q, dO, lse and
// dcap): 37 / 69 / 151 / 199 / 211 KB, the fused kernel 9 / 9 / 17 / 17 / 4
// KB more: two blocks an SM at D 32 and 64 (by registers), one at the
// others.
//   dq pass (flash_bwd_dq_tf32_kernel): Q and dO resident, K and V tiles
//     streaming; S = Q K^T and dP = dO V^T, then dQ += dS K with K read
//     MN-major.  The pass also refines dcap against its own p and dp: dcap
//     = rowsum(dO * O) holds the row sum of p * dp only to f32 rounding, and
//     where a row of dp is nearly constant, dp - dcap cancels and that
//     rounding becomes ds's error, the same in every column (at BERT-base
//     depth 2e-3 of the query / key gradients).  The pass sums r_i = sum_j
//     ds_ij (dlse_i in exact arithmetic) and P_i = sum_j p_ij beside a_i =
//     sum_j p_ij k_j (one hi hi pass: c_i below is ~1e-3); c_i = r_i / P_i
//     - dlse_i gives dq_i -= scale * c_i * a_i, and dcap_i + c_i goes to
//     the dk/dv pass.
//   dk/dv pass (flash_bwd_dkv_tf32_kernel<D, false>): K and V resident; Q,
//     dO, lse and dcap tiles stream, for all G query heads; S^T = K Q^T and
//     dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with dO and Q read
//     MN-major.  With few KV rows the heads are shared over blocks as in
//     bf16 (ops.attention.dkv_splits).
//   fused (flash_bwd_dkv_tf32_kernel<D, true>; G 1, no lengths or window;
//     no dcap refinement, as the TPU kernel): the dk/dv pass plus, per Q
//     tile, dS to shared memory (queries as rows, the block's keys along
//     them, permuted within each 8 into the depth order of the register
//     fragments) and the key block's share of the tile's dq, dS K, three
//     passes from zero with dS read by ldmatrix and K from the block's
//     resident rows, the NW warps taking the tile's rows in 16-row slabs
//     and its columns in groups, then added to dq after its turn.
//
// dq of the fused kernels, both dtypes: no per-key-block slabs.  Every
// block adds its share into one f32 (BH, S, d) buffer in key-block order:
// the block of key block kb adds to query tile qt only once key block kb - 1
// has, through an int turn counter per (bh, qt) (one thread waits with
// ld.acquire, the block's barrier follows; after the block's writes, a
// barrier and st.release pass the turn on).  Key block 0 reaches every
// query tile, so it writes and the others add.  Each block takes its (bh,
// key block) work item from an atomic ticket when it starts, key block kb of
// every head before kb + 1, so it only ever waits on tickets that running
// blocks hold: no deadlock whatever order the blocks start in.  The sum's
// order is fixed, so results are bit-identical from run to run, and the
// buffer sees one read-modify-write of a query tile's rows x d f32 per
// (key block, query tile) pair, mostly in L2 (TPU: nk slabs of (BH, S, d) f32, summed after:
// 4.3 GB at Pythia-1B's 16 x 2048 x 256).  The wrapper casts dq to q's dtype.
//
// Optional per-row valid lengths `lens` (BH int32, both passes; TPU: the
// lens_ref limit): a pair (i, j) of row block bh counts iff i < lens[bh] and
// j < lens[bh].  Padded query rows get dq 0 and padded keys dk = dv = 0,
// and tiles past the length are never loaded.  Under GQA each query head bh
// = bkv * G + g of the dk/dv pass reads its own length.  Optional sliding
// window `window` (> 0, causal only, both passes; TPU: _valid_mask's band
// and _pair_relevant's lower edge): a pair counts only if i - j < window as
// well.  The dq pass starts at the first K tile that reaches its first
// row's band; the dk/dv pass walks only the query tiles in [k0, k0 + rows
// - 1 + window - 1].  Under `causal`, tiles wholly above the diagonal are
// never loaded (TPU: _pair_relevant).  No atomics but the fused kernel's
// ticket; every sum is taken in a fixed order, so results are deterministic.
//
// Registers (nvcc -Xptxas -v, sm_90a; scripts/ptxas_report.py, which also
// counts each kernel's HMMA / HGMMA instructions), bf16 at D 64 / 128 /
// 256: dq 145 / 212 / 238, none spilled; dk/dv 168 / 250 / 255 (8 bytes
// spilled at D 256); fused 173 / 255 / 255 (20 bytes spilled at D 128 and
// 256); every bf16 instantiation holds HGMMA.  f32 at D 32 / 64 / 96 / 128
// / 256: dq 202 / 249 / 255 / 255 / 255 (4 bytes spilled at D 128), dk/dv
// 188 / 255 / 255 / 255 / 255 (16, 124 and 8 bytes spilled at D 96, 128,
// 256), fused 200 / 255 / 255 / 255 / 255 (12 and 48 bytes spilled at D 96
// and 128); every f32 instantiation holds HMMA.
#include "common.cuh"
#include "flash_tf32.cuh"
#include "tensor_core.cuh"

namespace {

// dq's turn counters, at device scope: a block waits (one thread, then the
// block's barrier) until its key block is next, and passes the turn on once
// its writes are done.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void dq_wait_turn(const int* turn, int kb) {
  if (threadIdx.x == 0 && kb > 0)
    while (ld_acquire(turn) != kb) {
    }
  __syncthreads();
}
// the barrier orders every thread's writes before thread 0's release, which
// publishes them (cumulatively) at device scope
__device__ __forceinline__ void dq_pass_turn(int* turn, int kb) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(turn, kb + 1);
}

// The block's work item (bh, key block) from the ticket at turns[0], in
// ticket order: key block kb of every head before key block kb + 1, so a
// block only ever waits on a ticket that a running block holds.
__device__ __forceinline__ int2 fused_item(int* turns, int BH) {
  __shared__ int item;
  if (threadIdx.x == 0) item = atomicAdd(turns, 1);
  __syncthreads();
  return make_int2(item % BH, item / BH);
}

template <int D>
__global__ void __launch_bounds__(F32Tc<D>::kThreads, F32Tc<D>::kMinBlocks)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dcap,
                         const float* __restrict__ dlse, float* __restrict__ dq,
                         float* __restrict__ dcap_out,
                         const int* __restrict__ lens, int S, int G, int d,
                         float scale, int causal, int window) {
  using C = F32Tc<D>;
  constexpr int BR = C::BR, BK = C::BK, NT = C::kThreads, P = C::P;
  constexpr int NB = BK / 8, NN = C::DW / 8;
  extern __shared__ float4 smem_f4[];
  float* const sQ = reinterpret_cast<float*>(smem_f4);
  float* const sO = sQ + BR * P;
  float* const ring = sO + BR * P;  // stage s: K, then V
  float* const xb = ring + 4 * BK * P;
  const uint32_t uQ = lg_smem_u32(sQ), uO = lg_smem_u32(sO);
  const uint32_t uR = lg_smem_u32(ring);

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
  // row), lse in base 2, dcap
  const int r0 = q0 + slab * 16 + lane / 4;
  int klo[2], khi[2];
  float lse2[2], dc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    klo[i] = window > 0 ? qi - window + 1 : 0;
    khi[i] = qi < limit ? (causal ? min(qi, limit - 1) : limit - 1) : -1;
    const size_t r = (size_t)bh * S + min(qi, S - 1);
    lse2[i] = lse[r] * kLog2e;
    dc[i] = dcap[r];
  }

  auto stage_kv = [&](int kt, int s) {
    stage_f32<BK, D, NT>(uR + s * 2 * BK * P * 4, kb, kt * BK, S, d);
    stage_f32<BK, D, NT>(uR + (2 * s + 1) * BK * P * 4, vb, kt * BK, S, d);
  };
  if (kt0 < nkt) {
    stage_f32<BR, D, NT>(uQ, q + (size_t)bh * S * d, q0, S, d);
    stage_f32<BR, D, NT>(uO, dout + (size_t)bh * S * d, q0, S, d);
    stage_kv(kt0, 0);
    lg_cp_async_commit();
  }

  float acc[NN][4], pk[NN][4];  // dQ; sum_j p_ij k_j (the dcap refinement)
  zero_frag(acc);
  zero_frag(pk);
  float rsum[2] = {0.f, 0.f}, psum[2] = {0.f, 0.f};  // sum_j ds_ij, p_ij
  for (int kt = kt0; kt < nkt; ++kt) {
    const int s = (kt - kt0) & 1;
    lg_cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < nkt) {
      stage_kv(kt + 1, s ^ 1);
      lg_cp_async_commit();
    }
    const uint32_t uK = uR + s * 2 * BK * P * 4, uV = uK + BK * P * 4;

    // S = Q K^T and dP = dO V^T (over this warp's columns; at WN 2 the
    // slab's two halves summed)
    float sc[NB][4], dp[NB][4];
    product_xyt<NB, C::DW, P>(sc, uQ + slab * 16 * P * 4, uK, c0, lane);
    product_xyt<NB, C::DW, P>(dp, uO + slab * 16 * P * 4, uV, c0, lane);
    if constexpr (C::WN > 1)
      exchange<NB>(sc, dp, xb, warp, (warp + C::SLABS) % C::NW, lane);

    // P and dS = P (dP - dcap) in f32; the mask (a select) only where this
    // tile holds the diagonal, the band's edge, the length or a padded row
    const int k0 = kt * BK;
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 < q1 - window + 1) ||
                      k0 + BK > limit || q1 >= limit;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(fmaf(sc[nb][e], scale_log2, -lse2[i]));
        if (edge) {
          const int kj = k0 + nb * 8 + (lane & 3) * 2 + (e & 1);
          if (kj < klo[i] || kj > khi[i]) p = 0.f;
        }
        const float ds = p * (dp[nb][e] - dc[i]);
        psum[i] += p;
        rsum[i] += ds;
        sc[nb][e] = p;
        dp[nb][e] = ds;
      }

    // dQ += dS K (three passes) and sum_j p_ij k_j += P K (one: it
    // multiplies the correction, ~1e-3 of dq); K read MN-major
    uint32_t dh[NB][4], dl[NB][4], ph[NB][4];
    to_a(dh, dl, dp);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      ph[nb][0] = tf32_hi(sc[nb][0]);
      ph[nb][1] = tf32_hi(sc[nb][2]);
      ph[nb][2] = tf32_hi(sc[nb][1]);
      ph[nb][3] = tf32_hi(sc[nb][3]);
    }
    accumulate<NB, NN, P, true>(
        acc, pk, dh, dl, ph,
        ring + s * 2 * BK * P + 2 * (lane & 3) * P + lane / 4 + c0);
  }

  // the rows' sums over the quad's columns, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], o);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], o);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= S) continue;
    const size_t r = (size_t)bh * S + qi;
    // the dcap refinement: c = sum_j ds_ij / sum_j p_ij - dlse_i, dq_i -=
    // scale c sum_j p_ij k_j; a row with no valid key has P = 0 and none
    const float corr =
        psum[i] > 0.f ? rsum[i] / psum[i] - (dlse ? dlse[r] : 0.f) : 0.f;
#pragma unroll
    for (int nb = 0; nb < NN; ++nb)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e)
        acc[nb][e] = fmaf(-corr, pk[nb][e], acc[nb][e]);
    store_frag<NN>(dq + r * d, acc, i, c0, lane, d, scale);
    if (dcap_out && c0 == 0 && (lane & 3) == 0) dcap_out[r] = dc[i] + corr;
  }
}

// dk/dv (FUSED false) or the fused backward (FUSED true: G 1, no lengths or
// window; the work item from the ticket at turns[0]; each query tile's dq
// share added to the f32 `dq` in key-block order through `turns`).  dk/dv
// with `part` (not null): the block of blockIdx.z walks the query heads [z
// Gs, (z + 1) Gs) of its group, Gs = ceil(G / gridDim.z), and writes f32 dK
// and dV partials, part[z][0: dk, 1: dv][KV row][S][d], which the caller
// sums over z in order.
template <int D, bool FUSED>
__global__ void __launch_bounds__(F32Tc<D>::kThreads, F32Tc<D>::kMinBlocks)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dcap,
                          float* __restrict__ dk, float* __restrict__ dv,
                          float* __restrict__ dq, int* __restrict__ turns,
                          const int* __restrict__ lens,
                          float* __restrict__ part, int BH, int S, int G,
                          int d, float scale, int causal, int window) {
  using C = F32Tc<D>;
  constexpr int BR = C::BR, BQ = C::BQ, NT = C::kThreads, P = C::P;
  constexpr int NB = BQ / 8, NN = C::DW / 8, SZ = C::kStageDkv;
  // fused: the tile's dq share, dS K (BQ x D), taken by the NW warps as RS
  // slabs of 16 queries x CG groups of DQW columns
  constexpr int RS = BQ / 16, CG = C::NW / RS, DQW = D / CG, NQ = DQW / 8;
  constexpr int PK = C::PK;
  static_assert(C::NW % RS == 0 && D % (8 * CG) == 0, "uneven dq share");
  extern __shared__ float4 smem_f4[];
  float* const sK = reinterpret_cast<float*>(smem_f4);
  float* const sV = sK + BR * P;
  float* const ring = sV + BR * P;  // stage s: Q, dO, lse, dcap
  float* const xb = ring + 2 * SZ;
  float* const sDS = xb + C::kXDkv;  // fused: the tile's dS
  const uint32_t uK = lg_smem_u32(sK), uV = lg_smem_u32(sV);
  const uint32_t uR = lg_smem_u32(ring);

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int slab = warp % C::SLABS, c0 = (warp / C::SLABS) * C::DW;
  // the KV row and key block: the grid's, or (fused) the ticket's.  k0 from
  // blockIdx.y, not kb: the dk/dv pass then spills 124 bytes at D 128, not
  // 160 (scripts/ptxas_report.py)
  int bkv = blockIdx.x, k0 = blockIdx.y * BR, kb = blockIdx.y;
  if constexpr (FUSED) {
    const int2 item = fused_item(turns, BH);
    bkv = item.x;
    kb = item.y;
    k0 = kb * BR;
  }
  const float scale_log2 = scale * kLog2e;

  // the query tiles [qa, qe) of head g whose rows see a key of this block
  auto span = [&](int g, int& qa, int& qe) {
    const int limit = lens ? max(0, min(lens[bkv * G + g], S)) : S;
    qa = causal ? k0 / BQ : 0;
    const int qend = window > 0 ? min(limit, k0 + BR - 1 + window) : limit;
    qe = k0 < limit ? (qend + BQ - 1) / BQ : qa;
  };
  // Q, dO, lse and dcap of tile qt of head g into stage s
  auto stage = [&](int g, int qt, int s) {
    const int bh = bkv * G + g, q0 = qt * BQ;
    const uint32_t st = uR + s * SZ * 4;
    stage_f32<BQ, D, NT>(st, q + (size_t)bh * S * d, q0, S, d);
    stage_f32<BQ, D, NT>(st + BQ * P * 4, dout + (size_t)bh * S * d, q0, S,
                         d);
    if (t < BQ) {
      const bool in = q0 + t < S;
      const size_t r = (size_t)bh * S + (in ? q0 + t : 0);
      lg_cp_async4(st + (2 * BQ * P + t) * 4, lse + r, in ? 4 : 0);
      lg_cp_async4(st + (2 * BQ * P + BQ + t) * 4, dcap + r, in ? 4 : 0);
    }
  };

  // the (head, tile) walk over the G query heads of the group (TPU: the
  // inner grid index over (head, q block) pairs), from its first tile
  const int gs = (G + gridDim.z - 1) / gridDim.z;
  const int g_end = min(G, (int)(blockIdx.z + 1) * gs);
  int g = blockIdx.z * gs, qt, qe;
  if (g < g_end) span(g, qt, qe);
  while (g < g_end && qt >= qe && ++g < g_end) span(g, qt, qe);
  if (g < g_end) {
    stage_f32<BR, D, NT>(uK, k + (size_t)bkv * S * d, k0, S, d);
    stage_f32<BR, D, NT>(uV, v + (size_t)bkv * S * d, k0, S, d);
    stage(g, qt, 0);
    lg_cp_async_commit();
  }

  float dka[NN][4], dva[NN][4];
  zero_frag(dka);
  zero_frag(dva);
  const int j0 = k0 + slab * 16 + lane / 4;  // this thread's keys j0, + 8

  // fused: this warp's rows and columns of a tile's dq share, and the
  // share's addition to dq after key block kb - 1's (key block 0 reaches
  // every query tile, so it writes and the others add)
  const int rs = warp % RS, cg = warp / RS;
  const int nq = (S + BQ - 1) / BQ;
  float share[NQ][4];
  auto flush_dq = [&](int tile) {
    int* turn = turns + 1 + (size_t)bkv * nq + tile;
    dq_wait_turn(turn, kb);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = tile * BQ + rs * 16 + lane / 4 + 8 * i;
      if (qi >= S) continue;
      float2* row = reinterpret_cast<float2*>(
          dq + ((size_t)bkv * S + qi) * d + cg * DQW + (lane & 3) * 2);
      // every load before any store (the compiler cannot tell that they
      // do not alias, so interleaved they would run one after another)
      float2 old[NQ];
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb)
        old[nb] = kb > 0 && cg * DQW + nb * 8 < d ? __ldcg(row + nb * 4)
                                                 : make_float2(0.f, 0.f);
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb)
        if (cg * DQW + nb * 8 < d)
          __stcg(row + nb * 4,
                 make_float2(fmaf(share[nb][2 * i], scale, old[nb].x),
                             fmaf(share[nb][2 * i + 1], scale, old[nb].y)));
    }
    dq_pass_turn(turn, kb);
  };

  for (int it = 0; g < g_end; ++it) {
    const int s = it & 1;
    lg_cp_async_wait<0>();
    __syncthreads();  // this tile landed; every warp is done with the last
    int ng = g, nqt = qt + 1, nqe = qe;
    while (nqt >= nqe && ++ng < g_end) span(ng, nqt, nqe);
    if (ng < g_end) {
      stage(ng, nqt, s ^ 1);
      lg_cp_async_commit();
    }

    const int bh = bkv * G + g, q0 = qt * BQ;
    const int limit = lens ? max(0, min(lens[bh], S)) : S;
    const float* sQ = ring + s * SZ;
    const float* sO = sQ + BQ * P;
    const float* Ls = sO + BQ * P;  // lse of the tile's rows
    const float* Ds = Ls + BQ;      // dcap

    // S^T = K Q^T and dP^T = V dO^T
    float st[NB][4], dpt[NB][4];
    product_xyt<NB, C::DW, P>(st, uK + slab * 16 * P * 4, lg_smem_u32(sQ),
                              c0, lane);
    product_xyt<NB, C::DW, P>(dpt, uV + slab * 16 * P * 4, lg_smem_u32(sO),
                              c0, lane);
    if constexpr (C::WN > 1)
      exchange<NB>(st, dpt, xb, warp, (warp + C::SLABS) % C::NW, lane);

    // P^T, and dS^T = P^T (dP^T - dcap); lse and dcap run along the
    // columns.  The mask (a select) only where this tile holds the
    // diagonal, the band's edge or the length.
    const bool edge = (causal && q0 < k0 + BR - 1) ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window) ||
                      q0 + BQ > limit || k0 + BR > limit;
    int qlo[2], qhi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = j0 + 8 * i;
      qlo[i] = causal ? j : 0;
      qhi[i] = j < limit ? (window > 0 ? min(limit - 1, j + window - 1)
                                       : limit - 1)
                         : -1;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = nb * 8 + (lane & 3) * 2 + (e & 1);
        float p = exp2f(fmaf(st[nb][e], scale_log2, -Ls[c] * kLog2e));
        if (edge && (q0 + c < qlo[i] || q0 + c > qhi[i])) p = 0.f;
        st[nb][e] = p;
        dpt[nb][e] = p * (dpt[nb][e] - Ds[c]);
      }

    // dV += P^T dO and dK += dS^T Q, three passes each; dO and Q read
    // MN-major
    const int y0 = 2 * (lane & 3) * P + lane / 4 + c0;
    uint32_t fh[NB][4], fl[NB][4];
    to_a(fh, fl, st);
    accumulate<NB, NN, P, false>(dva, dva, fh, fl, fh, sO + y0);
    to_a(fh, fl, dpt);
    accumulate<NB, NN, P, false>(dka, dka, fh, fl, fh, sQ + y0);

    if constexpr (FUSED) {
      // dS to shared memory, the tile's queries as rows and the block's
      // keys along them, permuted within each 8 (key 2u at word u, 2u + 1
      // at word u + 4): ldmatrix then reads the A fragments of dS K in
      // to_a's depth order, and K's rows go by accumulate's permutation.
      // At WN 2 the slab's two warps hold the same dS.
      if (c0 == 0) {
        const int g8 = lane >> 2;
        const int w = slab * 16 + (g8 >> 1) + (g8 & 1) * 4;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sDS[(nb * 8 + (lane & 3) * 2 + (e & 1)) * PK + w + 8 * (e >> 1)] =
                dpt[nb][e];
      }
      __syncthreads();
      // this tile's share from zero, three passes (the small ones apart),
      // added to dq at once: held through the next tile's products so that
      // the wait for the turn overlapped them, it was no faster (4% slower
      // at GPT-2's shape, within 1.2% at Pythia's: scripts/ab_flash_bwd.py's
      // fused_lag_ms)
      zero_frag(share);
      float small[NQ][4];
      zero_frag(small);
      const uint32_t xa =
          lg_smem_u32(sDS) +
          ((rs * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PK +
           (lane >> 4) * 4) * 4;
      const float* y = sK + 2 * (lane & 3) * P + lane / 4 + cg * DQW;
#pragma unroll 4
      for (int kk = 0; kk < BR / 8; ++kk) {
        uint32_t r[4], ah[4], al[4];
        lg_tc::ldmatrix_x4(r, xa + kk * 32);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_tf32(__uint_as_float(r[j]), ah[j], al[j]);
#pragma unroll
        for (int nb = 0; nb < NQ; ++nb) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(y[(8 * kk) * P + 8 * nb], bh0, bl0);
          split_tf32(y[(8 * kk + 1) * P + 8 * nb], bh1, bl1);
          mma_small(small[nb], ah, al, bh0, bh1, bl0, bl1);
          mma_tf32(share[nb], ah, bh0, bh1);
        }
      }
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) share[nb][e] += small[nb][e];
      flush_dq(qt);
    }

    g = ng;
    qt = nqt;
    qe = nqe;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = j0 + 8 * i;
    if (j >= S) continue;
    const size_t r = ((size_t)bkv * S + j) * d;
    float *krow = dk + r, *vrow = dv + r;
    if (part) {
      const size_t slab_sz = (size_t)(BH / G) * S * d;  // one (KV, S, d)
      krow = part + 2 * blockIdx.z * slab_sz + r;
      vrow = krow + slab_sz;
    }
    store_frag<NN>(krow, dka, i, c0, lane, d, scale);
    store_frag<NN>(vrow, dva, i, c0, lane, d, 1.f);
  }
}

// The operands of a two-pass backward call; `dlse`, `dq` and `dcap_out` are
// the dq pass's, `dk` and `dv` the dk/dv pass's.
struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *dcap, *dlse;
  void *dq, *dcap_out, *dk, *dv, *part;
  const void* lens;
  int BH, G, S, d;
  float scale;
  int causal, window, gsplit;
};

// ---- bfloat16: the tensor-core kernels ----------------------------------

using bf16 = __nv_bfloat16;

template <int D>
struct Tc {
  static constexpr int BR = 64;  // resident rows a block: one warpgroup's M
  static constexpr int BS = 64;  // streamed rows a tile
  // dk/dv and fused: at D 256 the 64 x 256 f32 dK and dV take 128 registers
  // a thread each, so one warpgroup accumulates dV and another dK
  static constexpr int NWG = (D == 256) ? 2 : 1;
  static constexpr int kThreads = NWG * 128;
  static constexpr int kTile = 64 * D * 2;  // bytes of one 64-row tile
  // dq: keys a K/V tile, 32 at D 256, where the 64 x 256 f32 dQ takes 128
  // registers a thread and 64 keys' S and dP spill (as in the forward)
  static constexpr int BK = (D == 256) ? 32 : 64;
  static constexpr int kKTile = BK * D * 2;
  // dq: Q and dO, two stages of K and V; + 1 KB to align to 1024 bytes
  static constexpr int kSmemDq = 2 * kTile + 4 * kKTile + 1024;
  // dk/dv: K and V, two stages of Q and dO, the fused kernel's dS^T tile
  // (64 x 64 bf16), two stages of the tile's lse and dcap
  static constexpr int kDsBytes = BR * BS * 2;
  static constexpr int kSmemDkv = 6 * kTile + kDsBytes + 2 * 2 * BS * 4 + 1024;
};

// s (64 x NB) = A (64 x D, shared) B^T (B: NB x D, shared), both K-major
template <int D, int NB = 64>
__device__ __forceinline__ void product_abt(float (&s)[NB / 2], uint32_t a,
                                            uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    // a 64-column block is R rows x 128 bytes; 16 columns = 32 bytes
    const uint32_t col = (ks & 3) * 32;
    const uint64_t da =
        lg_tc::desc_sw128(a + (ks >> 2) * (64 * 128) + col, 16, 1024);
    const uint64_t db =
        lg_tc::desc_sw128(b + (ks >> 2) * (NB * 128) + col, 16, 1024);
    if constexpr (NB == 32) lg_tc::wgmma_ss_n32(s, da, db, ks > 0);
    else lg_tc::wgmma_ss_n64(s, da, db, ks > 0);
  }
}

// acc (64 x N) += A (64 x 16 KS, registers) B (16 KS x N, shared, MN-major:
// the 16 KS rows of a tile, N of its columns from address b)
template <int N, int KS = 4>
__device__ __forceinline__ void product_rs(float (&acc)[N / 2],
                                           const uint32_t (&a)[KS][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db =
        lg_tc::desc_sw128(b + kk * 16 * 128, KS * 16 * 128, 1024);
    if constexpr (N == 64) lg_tc::wgmma_rs_n64(acc, a[kk], db);
    else if constexpr (N == 128) lg_tc::wgmma_rs_n128(acc, a[kk], db);
    else lg_tc::wgmma_rs_n256(acc, a[kk], db);
  }
}

// acc (64 x N) = A (64 x 64, shared, MN-major) B (64 x N, shared, MN-major)
template <int N>
__device__ __forceinline__ void product_ss_tt(float (&acc)[N / 2],
                                              uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = lg_tc::desc_sw128(a + kk * 16 * 128, 64 * 128, 1024);
    const uint64_t db = lg_tc::desc_sw128(b + kk * 16 * 128, 64 * 128, 1024);
    if constexpr (N == 64) lg_tc::wgmma_ss_tt_n64(acc, da, db, kk > 0);
    else lg_tc::wgmma_ss_tt_n128(acc, da, db, kk > 0);
  }
}

// The 64 x 16 KS f32 fragment x, rounded to bf16 pairwise: the A fragments
// of the KS 16-deep steps of the next product.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4],
                                       const float (&x)[KS * 8]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = lg_tc::pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) x[e] = 0.f;
}

// Row `i` (0: lane / 4, 1: lane / 4 + 8 of the warp's 16) of a 64 x D f32
// fragment, times `mul`, to a bf16 row: the columns below d.
template <int D>
__device__ __forceinline__ void store_row(bf16* row, const float (&x)[D / 2],
                                          int i, int lane, int d, float mul) {
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int c = nb * 8 + (lane & 3) * 2;
    if (c < d)
      *reinterpret_cast<uint32_t*>(row + c) = lg_tc::pack_bf16(
          x[nb * 4 + 2 * i] * mul, x[nb * 4 + 2 * i + 1] * mul);
  }
}

// the same to an f32 row (the dk/dv pass's partials)
template <int D>
__device__ __forceinline__ void store_row(float* row, const float (&x)[D / 2],
                                          int i, int lane, int d, float mul) {
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int c = nb * 8 + (lane & 3) * 2;
    if (c < d)
      *reinterpret_cast<float2*>(row + c) = make_float2(
          x[nb * 4 + 2 * i] * mul, x[nb * 4 + 2 * i + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dcap, bf16* __restrict__ dq,
                       float* __restrict__ dcap_out,
                       const int* __restrict__ lens, int S, int G, int d,
                       float scale, int causal, int window) {
  using C = Tc<D>;
  constexpr int BQ = 64, BK = C::BK, NT = 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (lg_smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sO = sQ + C::kTile;
  const uint32_t sKV = sO + C::kTile;  // stage s: K, then V

  const int bh = blockIdx.x;
  // causal: the heaviest Q tiles (the last) first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, q1 = q0 + BQ - 1;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int limit = lens ? max(0, min(lens[bh], S)) : S;
  const bf16* kb = k + (size_t)(bh / G) * S * d;
  const bf16* vb = v + (size_t)(bh / G) * S * d;
  const float scale_log2 = scale * kLog2e;

  int nkt = (limit + BK - 1) / BK;
  if (causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);
  if (q0 >= limit) nkt = 0;  // every row of the block is padding
  // the band's lower edge: keys before the first row's band are dead
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  // this thread's two query rows: valid keys [klo, khi] (none for a padded
  // row), lse in base 2, dcap
  const int r0 = q0 + warp * 16 + lane / 4;
  int klo[2], khi[2];
  float lse2[2], dc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    klo[i] = window > 0 ? qi - window + 1 : 0;
    khi[i] = qi < limit ? (causal ? min(qi, limit - 1) : limit - 1) : -1;
    const size_t r = (size_t)bh * S + min(qi, S - 1);
    lse2[i] = lse[r] * kLog2e;
    dc[i] = dcap[r];
  }

  if (kt0 < nkt) {
    lg_tc::stage_rows<BQ, D, NT>(sQ, q + (size_t)bh * S * d, q0, S, d);
    lg_tc::stage_rows<BQ, D, NT>(sO, dout + (size_t)bh * S * d, q0, S, d);
    lg_tc::stage_rows<BK, D, NT>(sKV, kb, kt0 * BK, S, d);
    lg_tc::stage_rows<BK, D, NT>(sKV + C::kKTile, vb, kt0 * BK, S, d);
    lg_cp_async_commit();
  }

  float acc[D / 2];
  zero(acc);
  for (int kt = kt0; kt < nkt; ++kt) {
    const uint32_t sK = sKV + ((kt - kt0) & 1) * 2 * C::kKTile;
    const uint32_t sV = sK + C::kKTile;
    if (kt + 1 < nkt) {
      // the other stage was released by the last iteration's barrier
      const uint32_t nK = sKV + ((kt + 1 - kt0) & 1) * 2 * C::kKTile;
      lg_tc::stage_rows<BK, D, NT>(nK, kb, (kt + 1) * BK, S, d);
      lg_tc::stage_rows<BK, D, NT>(nK + C::kKTile, vb, (kt + 1) * BK, S,
                                   d);
      lg_cp_async_commit();
      lg_cp_async_wait<1>();
    } else {
      lg_cp_async_wait<0>();
    }
    lg_tc::fence_proxy_async();
    __syncthreads();

    // S = Q K^T and dP = dO V^T
    const int k0 = kt * BK;
    float s[BK / 2], dp[BK / 2];
    zero(s);
    zero(dp);
    lg_tc::wg_fence();
    product_abt<D, BK>(s, sQ, sK);
    product_abt<D, BK>(dp, sO, sV);
    lg_tc::wg_commit();
    lg_tc::wg_wait0();
    lg_tc::fence_regs(s);
    lg_tc::fence_regs(dp);

    // P and dS = P (dP - dcap), into dp; the mask (a select) only where
    // this tile holds the diagonal, the band's edge, the length or a
    // padded row
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 < q1 - window + 1) ||
                      k0 + BK > limit || q1 >= limit;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int i = (e >> 1) & 1;
      float p = exp2f(fmaf(s[e], scale_log2, -lse2[i]));
      if (edge) {
        const int kj = k0 + (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
        if (kj < klo[i] || kj > khi[i]) p = 0.f;
      }
      dp[e] = p * (dp[e] - dc[i]);
    }
    // dQ += dS K: dS rounded to bf16 (the TPU kernel's ds.astype), K read
    // MN-major
    uint32_t a[BK / 16][4];
    pack_a<BK / 16>(a, dp);
    lg_tc::wg_fence();
    product_rs<D, BK / 16>(acc, a, sK);
    lg_tc::wg_commit();
    lg_tc::wg_wait0();
    lg_tc::fence_regs(acc);
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= S) continue;
    store_row<D>(dq + ((size_t)bh * S + qi) * d, acc, i, lane, d, scale);
    // no refinement in bf16: the dk/dv pass takes dcap as given
    if (dcap_out && (lane & 3) == 0)
      dcap_out[(size_t)bh * S + qi] = dcap[(size_t)bh * S + qi];
  }
}

// dk/dv (FUSED false) or the fused backward (FUSED true: G 1, no lengths or
// window; dq added to the f32 `dq` in key-block order through `turns`).
// dk/dv with `part` (not null): the block of blockIdx.z walks the query heads
// [z Gs, (z + 1) Gs) of its group, Gs = ceil(G / gridDim.z), and writes f32
// dK and dV partials, part[z][0: dk, 1: dv][KV row][S][d], which the caller
// sums over z in order: few KV heads then still fill the card.
template <int D, bool FUSED>
__global__ void __launch_bounds__(Tc<D>::kThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dcap, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, float* __restrict__ dq,
                        int* __restrict__ turns, const int* __restrict__ lens,
                        float* __restrict__ part, int BH, int S, int G, int d,
                        float scale, int causal, int window) {
  using C = Tc<D>;
  constexpr int BR = C::BR, BS = C::BS, NT = C::kThreads, NWG = C::NWG;
  constexpr int N = D / NWG;  // the fused dq product's columns a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = lg_smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  uint8_t* const base = smem_raw + (sK - raw);  // sK as a generic pointer
  const uint32_t sV = sK + C::kTile;
  const uint32_t sQO = sV + C::kTile;  // stage s: Q, then dO
  const uint32_t sDS = sQO + 4 * C::kTile;
  const uint32_t sRow = sDS + C::kDsBytes;  // stage s: lse, then dcap
  const float* rows = reinterpret_cast<const float*>(base + (sRow - sK));

  const int t = threadIdx.x, wg = t / 128;
  const int warp = (t % 128) / 32, lane = t % 32;
  int bkv, kb;
  if constexpr (FUSED) {
    const int2 item = fused_item(turns, BH);
    bkv = item.x;
    kb = item.y;
  } else {
    bkv = blockIdx.x;
    kb = blockIdx.y;
  }
  const int k0 = kb * BR;
  const int nq = (S + BS - 1) / BS;
  const float scale_log2 = scale * kLog2e;
  // this warpgroup's products: dS (and dP) where it accumulates dK
  const bool want_ds = NWG == 1 || wg == 1;

  // the query tiles [qa, qe) of head g whose rows see a key of this block
  auto span = [&](int g, int& qa, int& qe) {
    const int limit = lens ? max(0, min(lens[bkv * G + g], S)) : S;
    qa = causal ? k0 / BS : 0;
    const int qend = window > 0 ? min(limit, k0 + BR - 1 + window) : limit;
    qe = k0 < limit ? (qend + BS - 1) / BS : qa;
  };
  // Q, dO, lse and dcap of tile qt of head g into stage s
  auto stage = [&](int g, int qt, int s) {
    const int bh = bkv * G + g, q0 = qt * BS;
    lg_tc::stage_rows<BS, D, NT>(sQO + 2 * s * C::kTile,
                                 q + (size_t)bh * S * d, q0, S, d);
    lg_tc::stage_rows<BS, D, NT>(sQO + (2 * s + 1) * C::kTile,
                                 dout + (size_t)bh * S * d, q0, S, d);
    if (t < BS) {
      const bool in = q0 + t < S;
      const size_t r = (size_t)bh * S + (in ? q0 + t : 0);
      lg_cp_async4(sRow + (2 * s * BS + t) * 4, lse + r, in ? 4 : 0);
      lg_cp_async4(sRow + ((2 * s + 1) * BS + t) * 4, dcap + r, in ? 4 : 0);
    }
  };

  // the (head, tile) walk over the G query heads of the group (TPU: the
  // inner grid index over (head, q block) pairs), from its first tile
  const int gs = (G + gridDim.z - 1) / gridDim.z;
  const int g_end = min(G, (int)(blockIdx.z + 1) * gs);
  int g = blockIdx.z * gs, qt, qe;
  if (g < g_end) span(g, qt, qe);
  while (g < g_end && qt >= qe && ++g < g_end) span(g, qt, qe);
  if (g < g_end) {
    lg_tc::stage_rows<BR, D, NT>(sK, k + (size_t)bkv * S * d, k0, S, d);
    lg_tc::stage_rows<BR, D, NT>(sV, v + (size_t)bkv * S * d, k0, S, d);
    stage(g, qt, 0);
    lg_cp_async_commit();
  }

  // acc0: dV (or, at NWG 2, this warpgroup's dV or dK); acc1: dK at NWG 1
  float acc0[D / 2], acc1[NWG == 1 ? D / 2 : 1];
  zero(acc0);
  zero(acc1);
  const int j0 = k0 + warp * 16 + lane / 4;  // this thread's key rows j0, +8
  for (int it = 0; g < g_end; ++it) {
    const int s = it & 1;
    int ng = g, nqt = qt + 1, nqe = qe;
    while (nqt >= nqe && ++ng < g_end) span(ng, nqt, nqe);
    if (ng < g_end) {
      // the other stage was released by the last iteration's barrier
      stage(ng, nqt, s ^ 1);
      lg_cp_async_commit();
      lg_cp_async_wait<1>();
    } else {
      lg_cp_async_wait<0>();
    }
    lg_tc::fence_proxy_async();
    __syncthreads();

    const int bh = bkv * G + g, q0 = qt * BS;
    const int limit = lens ? max(0, min(lens[bh], S)) : S;
    const uint32_t sQ = sQO + 2 * s * C::kTile, sO = sQ + C::kTile;
    const float* Ls = rows + 2 * s * BS;  // lse of the tile's rows
    const float* Ds = Ls + BS;            // dcap

    // S^T = K Q^T and dP^T = V dO^T
    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    lg_tc::wg_fence();
    product_abt<D>(st, sK, sQ);
    if (want_ds) product_abt<D>(dpt, sV, sO);
    lg_tc::wg_commit();
    lg_tc::wg_wait0();
    lg_tc::fence_regs(st);
    lg_tc::fence_regs(dpt);

    // P^T, and dS^T = P^T (dP^T - dcap) into dpt; lse and dcap run along
    // the columns.  The mask (a select) only where this tile holds the
    // diagonal, the band's edge or the length.
    const bool edge = (causal && q0 < k0 + BR - 1) ||
                      (window > 0 && q0 + BS - 1 - k0 >= window) ||
                      q0 + BS > limit || k0 + BR > limit;
    int qlo[2], qhi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = j0 + 8 * i;
      qlo[i] = causal ? j : 0;
      qhi[i] = j < limit ? (window > 0 ? min(limit - 1, j + window - 1)
                                       : limit - 1)
                         : -1;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      const int c = (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
      float p = exp2f(fmaf(st[e], scale_log2, -Ls[c] * kLog2e));
      if (edge && (q0 + c < qlo[i] || q0 + c > qhi[i])) p = 0.f;
      st[e] = p;
      if (want_ds) dpt[e] = p * (dpt[e] - Ds[c]);
    }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 (the TPU
    // kernel's p.astype and ds.astype) as register A fragments, dO and Q
    // read MN-major
    if constexpr (NWG == 1) {
      uint32_t pa[4][4], da[4][4];
      pack_a<4>(pa, st);
      pack_a<4>(da, dpt);
      lg_tc::wg_fence();
      product_rs<D>(acc0, pa, sO);
      product_rs<D>(acc1, da, sQ);
      lg_tc::wg_commit();
      lg_tc::wg_wait0();
      lg_tc::fence_regs(acc0);
      lg_tc::fence_regs(acc1);
    } else {
      uint32_t a[4][4];
      if (wg == 0) pack_a<4>(a, st);
      else pack_a<4>(a, dpt);
      lg_tc::wg_fence();
      product_rs<D>(acc0, a, wg == 0 ? sO : sQ);
      lg_tc::wg_commit();
      lg_tc::wg_wait0();
      lg_tc::fence_regs(acc0);
    }

    if constexpr (FUSED) {
      // dS^T to shared memory (keys as rows, queries along them, in the
      // 128-byte swizzle), then this key block's share of the tile's dq,
      // dS K, with dS read MN-major through the transpose bit
      if (want_ds) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = warp * 16 + lane / 4 + 8 * (j & 1);
            const int chunk = 2 * kk + (j >> 1);
            *reinterpret_cast<uint32_t*>(
                base + (sDS - sK) + r * 128 + ((chunk ^ (r & 7)) << 4) +
                (lane & 3) * 4) =
                lg_tc::pack_bf16(dpt[8 * kk + 2 * j], dpt[8 * kk + 2 * j + 1]);
          }
        lg_tc::fence_proxy_async();
      }
      __syncthreads();
      float dqa[N / 2];
      zero(dqa);
      lg_tc::wg_fence();
      // a 64-column block of the K tile is 64 rows x 128 bytes
      product_ss_tt<N>(dqa, sDS, sK + wg * (N / 64) * (64 * 128));
      lg_tc::wg_commit();
      lg_tc::wg_wait0();
      lg_tc::fence_regs(dqa);
      // added to dq after key block kb - 1's (key block 0 writes: it
      // reaches every query tile)
      int* turn = turns + 1 + (size_t)bh * nq + qt;
      dq_wait_turn(turn, kb);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + warp * 16 + lane / 4 + 8 * i;
        if (qi >= S) continue;
        float2* row = reinterpret_cast<float2*>(
            dq + ((size_t)bh * S + qi) * d + wg * N + (lane & 3) * 2);
        // every load before any store, as in the f32 kernel
        float2 old[N / 8];
#pragma unroll
        for (int nb = 0; nb < N / 8; ++nb)
          old[nb] = kb > 0 && wg * N + nb * 8 < d ? __ldcg(row + nb * 4)
                                                  : make_float2(0.f, 0.f);
#pragma unroll
        for (int nb = 0; nb < N / 8; ++nb)
          if (wg * N + nb * 8 < d)
            __stcg(row + nb * 4,
                   make_float2(fmaf(dqa[nb * 4 + 2 * i], scale, old[nb].x),
                               fmaf(dqa[nb * 4 + 2 * i + 1], scale,
                                    old[nb].y)));
      }
      dq_pass_turn(turn, kb);
    }
    __syncthreads();  // every warp is done with this stage

    g = ng;
    qt = nqt;
    qe = nqe;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = j0 + 8 * i;
    if (j >= S) continue;
    auto store = [&](auto* krow, auto* vrow) {
      if constexpr (NWG == 1) {
        store_row<D>(vrow, acc0, i, lane, d, 1.f);
        store_row<D>(krow, acc1, i, lane, d, scale);
      } else if (wg == 0) {
        store_row<D>(vrow, acc0, i, lane, d, 1.f);
      } else {
        store_row<D>(krow, acc0, i, lane, d, scale);
      }
    };
    const size_t r = ((size_t)bkv * S + j) * d;
    if (part) {
      const size_t slab = (size_t)(BH / G) * S * d;  // one (KV, S, d)
      float* pk = part + 2 * blockIdx.z * slab + r;
      store(pk, pk + slab);
    } else {
      store(dk + r, dv + r);
    }
  }
}

// ops/attention.py's FUSED_ROWS sets the key blocks of the fused kernels'
// dq order by these rows, and its TURN_ROWS the turn counters it allocates
// by the narrowest query tile
static_assert(F32Tc<32>::BR == 64 && F32Tc<64>::BR == 64 &&
                  F32Tc<96>::BR == 128 && F32Tc<128>::BR == 128 &&
                  F32Tc<256>::BR == 64 && Tc<64>::BR == 64 &&
                  Tc<128>::BR == 64 && Tc<256>::BR == 64,
              "update FUSED_ROWS in ops/attention.py with the kernels' rows");
static_assert(F32Tc<32>::BQ >= 16 && F32Tc<64>::BQ >= 16 &&
                  F32Tc<96>::BQ >= 16 && F32Tc<128>::BQ >= 16 &&
                  F32Tc<256>::BQ >= 16 && Tc<64>::BS >= 16,
              "update TURN_ROWS in ops/attention.py with the query tiles");

template <int D>
int launch_dq_tf32(const BwdArgs& a, cudaStream_t st) {
  using C = F32Tc<D>;
  static bool sized = false;
  if (int e = smem_limit(flash_bwd_dq_tf32_kernel<D>, C::kSmemDq, sized))
    return e;
  const int nq = (a.S + C::BR - 1) / C::BR;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  flash_bwd_dq_tf32_kernel<D><<<dim3(a.BH, nq), C::kThreads, C::kSmemDq, st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.dcap,
      (const float*)a.dlse, (float*)a.dq, (float*)a.dcap_out,
      (const int*)a.lens, a.S, a.G, a.d, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tf32(const BwdArgs& a, cudaStream_t st) {
  using C = F32Tc<D>;
  static bool sized = false;
  if (int e = smem_limit(flash_bwd_dkv_tf32_kernel<D, false>, C::kSmemDkv,
                         sized))
    return e;
  const int nk = (a.S + C::BR - 1) / C::BR;
  if (nk > 65535 || a.gsplit < 1 || a.gsplit > a.G ||
      (a.gsplit > 1) != (a.part != nullptr))
    return (int)cudaErrorInvalidValue;
  flash_bwd_dkv_tf32_kernel<D, false>
      <<<dim3(a.BH / a.G, nk, a.gsplit), C::kThreads, C::kSmemDkv, st>>>(
          (const float*)a.q, (const float*)a.k, (const float*)a.v,
          (const float*)a.dout, (const float*)a.lse, (const float*)a.dcap,
          (float*)a.dk, (float*)a.dv, nullptr, nullptr, (const int*)a.lens,
          (float*)a.part, a.BH, a.S, a.G, a.d, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

// The f32 pass `dkv` (0: dq, 1: dk/dv) at the narrowest instantiation that
// holds d columns.
int launch_pass_f32(int dkv, const BwdArgs& a, cudaStream_t st) {
  if (a.d <= 32)
    return dkv ? launch_dkv_tf32<32>(a, st) : launch_dq_tf32<32>(a, st);
  if (a.d <= 64)
    return dkv ? launch_dkv_tf32<64>(a, st) : launch_dq_tf32<64>(a, st);
  if (a.d <= 96)
    return dkv ? launch_dkv_tf32<96>(a, st) : launch_dq_tf32<96>(a, st);
  if (a.d <= 128)
    return dkv ? launch_dkv_tf32<128>(a, st) : launch_dq_tf32<128>(a, st);
  return dkv ? launch_dkv_tf32<256>(a, st) : launch_dq_tf32<256>(a, st);
}

template <int D>
int launch_dq_tc(const BwdArgs& a, cudaStream_t st) {
  static bool sized = false;
  if (int e = smem_limit(flash_bwd_dq_tc_kernel<D>, Tc<D>::kSmemDq, sized))
    return e;
  const int nq = (a.S + 63) / 64;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  flash_bwd_dq_tc_kernel<D><<<dim3(a.BH, nq), 128, Tc<D>::kSmemDq, st>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, (const float*)a.lse, (const float*)a.dcap,
      (bf16*)a.dq, (float*)a.dcap_out, (const int*)a.lens, a.S, a.G, a.d,
      a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tc(const BwdArgs& a, cudaStream_t st) {
  static bool sized = false;
  if (int e = smem_limit(flash_bwd_dkv_tc_kernel<D, false>, Tc<D>::kSmemDkv,
                         sized))
    return e;
  const int nk = (a.S + 63) / 64;
  if (nk > 65535 || a.gsplit < 1 || a.gsplit > a.G ||
      (a.gsplit > 1) != (a.part != nullptr))
    return (int)cudaErrorInvalidValue;
  flash_bwd_dkv_tc_kernel<D, false>
      <<<dim3(a.BH / a.G, nk, a.gsplit), Tc<D>::kThreads, Tc<D>::kSmemDkv,
         st>>>((const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
               (const bf16*)a.dout, (const float*)a.lse,
               (const float*)a.dcap, (bf16*)a.dk, (bf16*)a.dv, nullptr,
               nullptr, (const int*)a.lens, (float*)a.part, a.BH, a.S, a.G,
               a.d, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

// The bf16 pass `dkv` at the narrowest instantiation that holds d columns
// (d <= 32 runs on D 64).
int launch_pass_bf16(int dkv, const BwdArgs& a, cudaStream_t st) {
  if (a.d <= 64) return dkv ? launch_dkv_tc<64>(a, st) : launch_dq_tc<64>(a, st);
  if (a.d <= 128)
    return dkv ? launch_dkv_tc<128>(a, st) : launch_dq_tc<128>(a, st);
  return dkv ? launch_dkv_tc<256>(a, st) : launch_dq_tc<256>(a, st);
}

int run_pass(int dkv, const BwdArgs& a, int is_bf16, void* stream) {
  if (a.d % 8 != 0 || a.d < 8 || a.d > 256) return (int)cudaErrorInvalidValue;
  if (a.BH <= 0 || a.S <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_pass_bf16(dkv, a, st) : launch_pass_f32(dkv, a, st);
}

// The operands of a fused backward call.
struct FusedArgs {
  const void *q, *k, *v, *dout, *lse, *dcap;
  void *dq, *turns, *dk, *dv;
  int BH, S, d;
  float scale;
  int causal;
};

template <int D>
int launch_fused_f32(const FusedArgs& a, cudaStream_t st) {
  using C = F32Tc<D>;
  static bool sized = false;
  if (int e = smem_limit(flash_bwd_dkv_tf32_kernel<D, true>, C::kSmemFused,
                         sized))
    return e;
  const int nk = (a.S + C::BR - 1) / C::BR;
  flash_bwd_dkv_tf32_kernel<D, true>
      <<<a.BH * nk, C::kThreads, C::kSmemFused, st>>>(
          (const float*)a.q, (const float*)a.k, (const float*)a.v,
          (const float*)a.dout, (const float*)a.lse, (const float*)a.dcap,
          (float*)a.dk, (float*)a.dv, (float*)a.dq, (int*)a.turns, nullptr,
          nullptr, a.BH, a.S, 1, a.d, a.scale, a.causal, 0);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fused_tc(const FusedArgs& a, cudaStream_t st) {
  static bool sized = false;
  if (int e = smem_limit(flash_bwd_dkv_tc_kernel<D, true>, Tc<D>::kSmemDkv,
                         sized))
    return e;
  const int nk = (a.S + 63) / 64;
  flash_bwd_dkv_tc_kernel<D, true>
      <<<a.BH * nk, Tc<D>::kThreads, Tc<D>::kSmemDkv, st>>>(
          (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
          (const bf16*)a.dout, (const float*)a.lse, (const float*)a.dcap,
          (bf16*)a.dk, (bf16*)a.dv, (float*)a.dq, (int*)a.turns, nullptr,
          nullptr, a.BH, a.S, 1, a.d, a.scale, a.causal, 0);
  return (int)cudaGetLastError();
}

// The fused kernel at the narrowest instantiation that holds d columns.
int launch_fused_d(const FusedArgs& a, int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    if (a.d <= 64) return launch_fused_tc<64>(a, st);
    if (a.d <= 128) return launch_fused_tc<128>(a, st);
    return launch_fused_tc<256>(a, st);
  }
  if (a.d <= 32) return launch_fused_f32<32>(a, st);
  if (a.d <= 64) return launch_fused_f32<64>(a, st);
  if (a.d <= 96) return launch_fused_f32<96>(a, st);
  if (a.d <= 128) return launch_fused_f32<128>(a, st);
  return launch_fused_f32<256>(a, st);
}

}  // namespace

extern "C" {

// `lens` is null or BH int32 valid lengths and `window` 0 (no band) or the
// band's width; for the dq pass, `dlse` is null or lse's cotangent (dcap =
// rowsum(dO * O) - dlse), and `dcap_out` null or where the refined dcap goes
// (in bf16, dcap itself).  All three return cudaErrorInvalidValue for a
// head dimension they lack (d % 8 != 0, d < 8 or d > 256).
int lg_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dcap,
                    const void* dlse, void* dq, void* dcap_out,
                    const void* lens, int BH, int G, int S, int D,
                    float scale, int causal, int window, int is_bf16,
                    void* stream) {
  const BwdArgs a{q,  k,  v,       dout,     lse,     dcap,    dlse,
                  dq, dcap_out, nullptr, nullptr, nullptr, lens, BH,
                  G,  S,  D,       scale,    causal,  window,  1};
  return run_pass(0, a, is_bf16, stream);
}

// `part`: null, or where `gsplit` > 1 blocks a KV row write their f32 dk
// and dv partials, (gsplit, 2, BH / G, S, D), for the caller to sum.
int lg_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dcap,
                     void* dk, void* dv, void* part, const void* lens, int BH,
                     int G, int S, int D, float scale, int causal, int window,
                     int gsplit, int is_bf16, void* stream) {
  const BwdArgs a{q,       k,    v,       dout,  lse,    dcap,   nullptr,
                  nullptr, nullptr, dk,   dv,    part,   lens,   BH,
                  G,       S,    D,       scale, causal, window, gsplit};
  return run_pass(1, a, is_bf16, stream);
}

// `dq` is (BH, S, D) f32, written; `turns` 1 + BH * ceil(S / 16) int32
// zeros (16: the narrowest query tile, TURN_ROWS in ops/attention.py): the
// work-item ticket, then each (bh, query tile)'s count of key blocks added.
int lg_flash_bwd_fused(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dcap,
                       void* dq, void* turns, void* dk, void* dv, int BH,
                       int S, int D, float scale, int causal, int is_bf16,
                       void* stream) {
  if (D % 8 != 0 || D < 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (BH <= 0 || S <= 0) return 0;
  const FusedArgs a{q, k, v, dout, lse, dcap, dq, turns, dk, dv,
                    BH, S, D, scale, causal};
  return launch_fused_d(a, is_bf16, (cudaStream_t)stream);
}

}  // extern "C"
