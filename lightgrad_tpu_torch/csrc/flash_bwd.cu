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
// float32, on the CUDA cores (tensor cores would compute f32 as TF32, which
// the package's 1e-3 f32 tolerances do not allow): FP32 FFMA issue and
// shared-memory reads bound it.  One row of the resident operand per group
// of TPR = D / 16 adjacent threads, each owning 16 of the D columns in
// float4 chunks (interleaved: a group reads TPR adjacent 16-byte words of a
// shared row, a broadcast); partial dot products are reduced across the
// group with shuffles, four streamed rows at a time.  The streamed operand
// is widened to f32 in shared memory once a tile.  Blocks hold 64 rows (32
// at D 128, 16 at D 256, so that 256 threads of up to 255 registers fit)
// of D = 32, 64, 128 or 256 columns; another d runs the next wider D.
//   dq pass (flash_bwd_dq_kernel): q, do and the dq accumulator in
//     registers; K and V tiles stream.  The pass also refines dcap against
//     its own p and dp: dcap = rowsum(dO * O) holds the row sum of p * dp
//     only to f32 rounding, and where a row of dp is nearly constant, dp -
//     dcap cancels and that rounding becomes ds's error, the same in every
//     column (at BERT-base depth 2e-3 of the query / key gradients).  The
//     pass sums r_i = sum_j ds_ij (dlse_i in exact arithmetic) and P_i =
//     sum_j p_ij beside a_i = sum_j p_ij k_j; c_i = r_i / P_i - dlse_i gives
//     dq_i -= scale * c_i * a_i, and dcap_i + c_i goes to the dk/dv pass.
//   dk/dv pass (flash_bwd_dkv_kernel): k, v and both accumulators in
//     registers; Q, dO, lse and dcap tiles stream, for all G query heads.
//   fused (flash_bwd_fused_kernel): the dk/dv loop, which also parks each Q
//     tile's ds in shared memory beside the block's K rows, then re-maps the
//     threads to the tile's query rows for the key block's share of dq.
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
// buffer sees one read-modify-write of 64 x d f32 per (key block, query
// tile) pair, mostly in L2 (TPU: nk slabs of (BH, S, d) f32, summed after:
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
// Registers (nvcc -Xptxas -v, sm_90a; scripts/ptxas_report.py), bf16 at D
// 64 / 128 / 256: dq 145 / 212 / 238, none spilled; dk/dv 168 / 250 / 255
// (8 bytes spilled at D 256); fused 173 / 255 / 255 (20 bytes spilled at D
// 128 and 256); every bf16 instantiation holds HGMMA (cuobjdump -sass).
// f32: dq 167-171, dk/dv 229, none spilled; fused 200 at D 32, 128 with
// 28-32 bytes spilled at D 64-256 (two blocks an SM).
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kSub = 4;  // streamed rows per shuffle round

template <int D>
struct Cfg {
  static constexpr int TPR = D / 16;  // threads per resident row
  // resident rows (queries or keys) per block: 128 threads at D = 32, 256
  // at the wider D, so that a thread may use up to 255 registers
  static constexpr int kRows = (D == 256) ? 16 : (D == 128) ? 32 : 64;
  static constexpr int kThreads = kRows * TPR;
  // streamed rows per tile
  static constexpr int BS = (D == 256) ? 16 : (D == 128) ? 32 : 64;
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

// Four consecutive columns of a row at column `col`: zeros past d.
__device__ __forceinline__ float4 load_cols(const float* row, int col,
                                            int d) {
  return col < d ? lg_load4(row + col) : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dcap,
                    const float* __restrict__ dlse, float* __restrict__ dq,
                    float* __restrict__ dcap_out,
                    const int* __restrict__ lens, int S, int G, int d,
                    float scale, int causal, int window) {
  using C = Cfg<D>;
  constexpr int TPR = C::TPR, BS = C::BS, D4 = C::D4, NC = C::NC;
  __shared__ float4 Ks[BS][D4];
  __shared__ float4 Vs[BS][D4];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::kRows;
  const int t = threadIdx.x;
  const int row = t / TPR, part = t % TPR;
  const int qi = q0 + row;
  const int limit = lens ? max(0, min(lens[bh], S)) : S;
  const size_t rq = (size_t)bh * S + min(qi, S - 1);
  const float* kb = k + (size_t)(bh / G) * S * d;
  const float* vb = v + (size_t)(bh / G) * S * d;

  float4 qr[NC], dor[NC], acc[NC], pk[NC];  // pk: sum_j p_ij k_j
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    qr[c] = load_cols(q + rq * d, (c * TPR + part) * 4, d);
    dor[c] = load_cols(dout + rq * d, (c * TPR + part) * 4, d);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    pk[c] = acc[c];
  }
  const float lse_i = lse[rq], dcap_i = dcap[rq];
  float rsum = 0.f, psum = 0.f;  // sum_j ds_ij, sum_j p_ij

  int nkt = (limit + BS - 1) / BS;
  if (causal) nkt = min(nkt, (q0 + C::kRows - 1) / BS + 1);
  if (q0 >= limit) nkt = 0;  // every query row of the block is padding
  // the band's lower edge: keys before the first row's band are dead
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / BS : 0;
  // this row's valid keys: [klo, khi] (empty for a padded row)
  const int klo = window > 0 ? qi - window + 1 : 0;
  const int khi =
      qi < limit ? (causal ? min(qi, limit - 1) : limit - 1) : -1;

  for (int kt = kt0; kt < nkt; ++kt) {
    const int k0 = kt * BS;
    __syncthreads();  // the previous tile is no longer read
    lg_stage<float, D, BS, C::kThreads>(Ks, kb, k0, S, d);
    lg_stage<float, D, BS, C::kThreads>(Vs, vb, k0, S, d);
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
        const bool valid = kj >= klo && kj <= khi;
        const float p = valid ? expf(s[jj] * scale - lse_i) : 0.f;
        const float ds = valid ? p * (dp[jj] - dcap_i) : 0.f;
        rsum += ds;
        psum += p;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kv = Ks[j0 + jj][c * TPR + part];
          axpy4(ds, kv, acc[c]);
          axpy4(p, kv, pk[c]);
        }
      }
    }
  }

  if (qi < S) {
    // a row with no valid key (padding) has P = 0 and no correction
    const float corr =
        psum > 0.f ? rsum / psum - (dlse ? dlse[rq] : 0.f) : 0.f;
    float* out = dq + ((size_t)bh * S + qi) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      axpy4(-corr, pk[c], acc[c]);
      const int col = (c * TPR + part) * 4;
      if (col < d)
        lg_store4(out + col, make_float4(acc[c].x * scale, acc[c].y * scale,
                                         acc[c].z * scale, acc[c].w * scale));
    }
    if (dcap_out && part == 0) dcap_out[rq] = dcap_i + corr;
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dcap, float* __restrict__ dk,
                     float* __restrict__ dv, const int* __restrict__ lens, int S,
                     int G, int d, float scale, int causal, int window) {
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
    kr[c] = load_cols(k + rk * d, (c * TPR + part) * 4, d);
    vr[c] = load_cols(v + rk * d, (c * TPR + part) * 4, d);
    dka[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[c] = dka[c];
  }

  // causal: query tiles wholly before this key block see none of its keys
  const int qt0 = causal ? k0 / BS : 0;

  for (int g = 0; g < G; ++g) {
    const int bh = bkv * G + g;
    const int limit = lens ? max(0, min(lens[bh], S)) : S;
    if (k0 >= limit) continue;  // this head sees none of the block's keys
    // window: rows past k0 + kRows - 1 + window - 1 see none of its keys
    const int qend =
        window > 0 ? min(limit, k0 + C::kRows - 1 + window) : limit;
    const int nqt = (qend + BS - 1) / BS;
    // the query rows that see this thread's key: [qlo, qhi]
    const int qlo = causal ? kj : 0;
    const int qhi = kj < limit ? (window > 0 ? min(limit - 1, kj + window - 1)
                                             : limit - 1)
                               : -1;
    const float* qb = q + (size_t)bh * S * d;
    const float* ob = dout + (size_t)bh * S * d;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * BS;
      __syncthreads();  // the previous tile is no longer read
      lg_stage<float, D, BS, C::kThreads>(Qs, qb, q0, S, d);
      lg_stage<float, D, BS, C::kThreads>(Os, ob, q0, S, d);
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
          const bool valid = qi >= qlo && qi <= qhi;
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
    float* dkr = dk + ((size_t)bkv * S + kj) * d;
    float* dvr = dv + ((size_t)bkv * S + kj) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * TPR + part) * 4;
      if (col >= d) continue;
      lg_store4(dkr + col, make_float4(dka[c].x * scale, dka[c].y * scale,
                                       dka[c].z * scale, dka[c].w * scale));
      lg_store4(dvr + col, dva[c]);
    }
  }
}

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

template <int D>
int launch_dq(const BwdArgs& a, cudaStream_t stream) {
  dim3 grid((a.S + Cfg<D>::kRows - 1) / Cfg<D>::kRows, a.BH);
  flash_bwd_dq_kernel<D><<<grid, Cfg<D>::kThreads, 0, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.dcap,
      (const float*)a.dlse, (float*)a.dq, (float*)a.dcap_out,
      (const int*)a.lens, a.S, a.G, a.d, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  dim3 grid((a.S + Cfg<D>::kRows - 1) / Cfg<D>::kRows, a.BH / a.G);
  flash_bwd_dkv_kernel<D><<<grid, Cfg<D>::kThreads, 0, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.dcap,
      (float*)a.dk, (float*)a.dv, (const int*)a.lens, a.S, a.G, a.d,
      a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

// The f32 pass `dkv` (0: dq, 1: dk/dv) at the narrowest instantiation that
// holds d columns.
int launch_pass_f32(int dkv, const BwdArgs& a, cudaStream_t st) {
  if (a.d <= 32) return dkv ? launch_dkv<32>(a, st) : launch_dq<32>(a, st);
  if (a.d <= 64) return dkv ? launch_dkv<64>(a, st) : launch_dq<64>(a, st);
  if (a.d <= 128)
    return dkv ? launch_dkv<128>(a, st) : launch_dq<128>(a, st);
  return dkv ? launch_dkv<256>(a, st) : launch_dq<256>(a, st);
}

// Shared memory of the f32 fused kernel, in bytes: the streamed Q and dO
// tiles, the block's K rows (f32), the tile's ds with a padded row, lse
// and dcap.
template <int D>
constexpr int fused_smem_bytes() {
  using C = Cfg<D>;
  return (2 * C::BS + C::kRows) * C::D4 * (int)sizeof(float4) +
         C::BS * (C::kRows + 1) * (int)sizeof(float) +
         2 * C::BS * (int)sizeof(float);
}

// two blocks an SM (at most 128 registers a thread), so that one block's
// products run while the other waits for its turn at dq
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 2)
flash_bwd_fused_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dcap, float* __restrict__ dq,
                       int* __restrict__ turns, float* __restrict__ dk,
                       float* __restrict__ dv, int BH, int S, int d,
                       float scale, int causal) {
  using C = Cfg<D>;
  constexpr int TPR = C::TPR, BS = C::BS, D4 = C::D4, NC = C::NC;
  constexpr int KR = C::kRows;
  // the dq step maps the threads onto the tile's query rows as the loop
  // maps them onto the block's key rows
  static_assert(BS == KR, "query tile and key block must have equal rows");
  constexpr int DSW = KR + 1;  // padded: a warp's rows hit distinct banks
  extern __shared__ float4 smem[];
  float4(*Qs)[D4] = reinterpret_cast<float4(*)[D4]>(smem);
  float4(*Os)[D4] = Qs + BS;  // dO
  float4(*Ks)[D4] = Os + BS;  // the block's K rows
  float(*dSs)[DSW] = reinterpret_cast<float(*)[DSW]>(Ks + KR);
  float* Ls = reinterpret_cast<float*>(dSs + BS);  // lse
  float* Ds = Ls + BS;                              // dcap

  const int2 item = fused_item(turns, BH);
  const int bh = item.x, kb = item.y;
  const int k0 = kb * KR;
  const int t = threadIdx.x;
  const int row = t / TPR, part = t % TPR;
  const int kj = k0 + row;
  const size_t rk = (size_t)bh * S + min(kj, S - 1);
  const int nqt = (S + BS - 1) / BS;
  int* turn = turns + 1 + (size_t)bh * nqt;  // turn[qt]: key blocks added

  float4 kr[NC], vr[NC], dka[NC], dva[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    kr[c] = load_cols(k + rk * d, (c * TPR + part) * 4, d);
    vr[c] = load_cols(v + rk * d, (c * TPR + part) * 4, d);
    dka[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[c] = dka[c];
  }
  lg_stage<float, D, KR, C::kThreads>(Ks, k + (size_t)bh * S * d, k0, S,
                                      d);

  // causal: query tiles wholly before this key block see none of its keys
  // (and key block 0 reaches every tile, so it writes where others add)
  const int qt0 = causal ? k0 / BS : 0;
  const float* qb = q + (size_t)bh * S * d;
  const float* ob = dout + (size_t)bh * S * d;
  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * BS;
    __syncthreads();  // the previous tile and its ds are no longer read
    lg_stage<float, D, BS, C::kThreads>(Qs, qb, q0, S, d);
    lg_stage<float, D, BS, C::kThreads>(Os, ob, q0, S, d);
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
        const bool valid = qi < S && kj < S && (!causal || kj <= qi);
        const float p = valid ? expf(s[ii] * scale - Ls[i0 + ii]) : 0.f;
        const float ds = valid ? p * (dp[ii] - Ds[i0 + ii]) : 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          axpy4(p, Os[i0 + ii][c * TPR + part], dva[c]);
          axpy4(ds, Qs[i0 + ii][c * TPR + part], dka[c]);
        }
        if (ii % TPR == part) dSs[i0 + ii][row] = ds;
      }
    }
    __syncthreads();  // the tile's ds is complete

    // dq's share of this key block for query row q0 + row:
    // scale * sum_j ds[row][j] k_j (rows of K past S, and columns past d,
    // are zero in Ks), added to dq after key block kb - 1's
    float4 acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < KR; ++j) {
      const float w = dSs[row][j];
#pragma unroll
      for (int c = 0; c < NC; ++c) axpy4(w, Ks[j][c * TPR + part], acc[c]);
    }
    dq_wait_turn(turn + qt, kb);
    const int qi = q0 + row;
    if (qi < S) {
      float4* dst = reinterpret_cast<float4*>(dq + ((size_t)bh * S + qi) * d);
      // every load before any store (the compiler cannot tell that they
      // do not alias, so interleaved they would run one after another);
      // key block 0 writes, the others add
      float4 old[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int w = c * TPR + part;
        old[c] = kb > 0 && w * 4 < d ? __ldcg(dst + w)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int w = c * TPR + part;
        if (w * 4 < d)
          __stcg(dst + w, make_float4(fmaf(acc[c].x, scale, old[c].x),
                                      fmaf(acc[c].y, scale, old[c].y),
                                      fmaf(acc[c].z, scale, old[c].z),
                                      fmaf(acc[c].w, scale, old[c].w)));
      }
    }
    dq_pass_turn(turn + qt, kb);
  }

  if (kj < S) {
    float* dkr = dk + ((size_t)bh * S + kj) * d;
    float* dvr = dv + ((size_t)bh * S + kj) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * TPR + part) * 4;
      if (col >= d) continue;
      lg_store4(dkr + col, make_float4(dka[c].x * scale, dka[c].y * scale,
                                       dka[c].z * scale, dka[c].w * scale));
      lg_store4(dvr + col, dva[c]);
    }
  }
}

// ---- bfloat16: the tensor-core kernels ----------------------------------

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

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

// ops/attention.py's FUSED_ROWS sets the key blocks (and query tiles) of
// the fused kernel's dq order by these rows
static_assert(Cfg<32>::kRows == 64 && Cfg<64>::kRows == 64 &&
                  Cfg<128>::kRows == 32 && Cfg<256>::kRows == 16 &&
                  Tc<64>::BR == 64 && Tc<128>::BR == 64 &&
                  Tc<256>::BR == 64,
              "update FUSED_ROWS in ops/attention.py with the kernels' rows");

// Raise a kernel's dynamic shared memory past 48 KB, once.
template <typename K>
int smem_limit(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return (int)e;
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
  if (!is_bf16 && (a.gsplit != 1 || a.part)) return (int)cudaErrorInvalidValue;
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
int launch_fused_f32(const FusedArgs& a, cudaStream_t stream) {
  // 41 KB at D 32, 66 KB at D 64, 54 KB at D 128, 50 KB at D 256: above
  // the 48 KB default at the wider D
  static bool sized = false;
  constexpr int bytes = fused_smem_bytes<D>();
  if (int e = smem_limit(flash_bwd_fused_kernel<D>, bytes, sized)) return e;
  const int nk = (a.S + Cfg<D>::kRows - 1) / Cfg<D>::kRows;
  flash_bwd_fused_kernel<D><<<a.BH * nk, Cfg<D>::kThreads, bytes, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.dcap,
      (float*)a.dq, (int*)a.turns, (float*)a.dk, (float*)a.dv, a.BH, a.S,
      a.d, a.scale, a.causal);
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

// `part`: null, or (bf16 only) where `gsplit` > 1 blocks a KV row write
// their f32 dk and dv partials, (gsplit, 2, BH / G, S, D), for the caller
// to sum.
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

// `dq` is (BH, S, D) f32, written; `turns` 1 + BH * nk int32 zeros, nk =
// ceil(S / FUSED_ROWS): the work-item ticket, then each (bh, query tile)'s
// count of key blocks added.
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
