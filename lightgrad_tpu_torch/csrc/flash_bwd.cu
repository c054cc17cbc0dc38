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
// per-thread registers are therefore the same at every D.  (With
// 32 columns a thread, the dk/dv pass's four row-sized register arrays
// spilled at 255 registers.)  The streamed operand is widened to f32 in
// shared memory once per tile and read by every row of the block.  Partial
// dot products are reduced across the group with shuffles, four streamed rows
// at a time for ILP.
//
//   dq pass: block = (bh, 64 query rows; 32 at D = 128, 16 at D = 256);
//     q, do and the dq accumulator live in registers; K and V tiles stream.
//     dq_i = scale * sum_j ds_ij k_j.  The pass also refines dcap against
//     its own p and dp: dcap = rowsum(dO * O) holds the row sum of p * dp
//     only to f32 rounding, and where a row of dp is nearly constant,
//     dp - dcap cancels and that rounding becomes ds's error, the same in
//     every column (at BERT-base depth 2e-3 of the query / key gradients).
//     The pass sums r_i = sum_j ds_ij (which is dlse_i in exact arithmetic)
//     and P_i = sum_j p_ij beside a_i = sum_j p_ij k_j; the correction
//     c_i = r_i / P_i - dlse_i gives dq_i -= scale * c_i * a_i, and
//     dcap_i + c_i goes to the dk/dv pass (as ops/softmax.py takes its row
//     sum in two passes).
//   dk/dv pass: block = (KV row block, 64 key rows; 32 at D = 128, 16 at
//     D = 256); k, v and both accumulators live in registers; Q, dO, lse
//     and dcap tiles stream, for all G query heads of the group in turn
//     (TPU: the inner grid index walks the (head, q block) pairs).  dv_j = sum_i p_ij do_i,
//     dk_j = scale * sum_i ds_ij q_i, with ds_ij = p_ij (dp_ij - dcap_i).
//
//   fused (TPU: _flash_bwd_fused -> _bwd_fused_kernel): block = (bh, 64 key
//     rows; 32 at D = 128, 16 at D = 256), G = 1; the dk/dv pass's loop,
//     which also parks each Q tile's ds (BS x key rows) in shared memory
//     beside the block's K rows, then re-maps the threads to the tile's
//     query rows and writes dq's share from these keys, scale * ds @ K_blk,
//     as an f32 slab [key block][bh][query rows].  p and ds are computed
//     once for all three gradients (5 products a pair instead of the two
//     passes' 6); the price is nk slabs of (BH, S, d) f32 written and
//     summed after the kernel -- at Pythia-1B's 16 x 2048 x 256, 128 slabs,
//     4.3 GB a layer written and read back, which bounds it at that shape
//     (the TPU kernel's own cost).  Under `causal` the slab rows of the skipped
//     Q tiles are written as 0, so a plain sum over the key blocks gives
//     dq.  It takes dcap as given (a row's keys are spread over the blocks,
//     so nothing can refine dcap before its ds are used), as the TPU kernel
//     does.
//
// Optional per-row valid lengths `lens` (BH int32, both passes; TPU: the
// lens_ref limit): a pair (i, j) of row block bh counts iff i < lens[bh] and
// j < lens[bh].  Padded query rows get dq 0 and padded keys dk = dv = 0,
// written (the accumulators stay 0), and tiles past the length are never
// loaded.  Under GQA each query head bh = bkv * G + g of the dk/dv pass reads
// its own length.
//
// Optional sliding window `window` (> 0, causal only, both passes; TPU:
// _valid_mask's band and _pair_relevant's lower edge): a pair (i, j) counts
// only if i - j < window as well.  The dq pass starts at the first K tile
// that reaches its first row's band; the dk/dv pass walks, for each of the
// G query heads of its KV row, only the query tiles in [k0, k0 + kRows - 1
// + window - 1], the rows whose band reaches one of its keys.
//
// Head dims, both passes: any d with d % 8 == 0 and 8 <= d <= 256.  Cfg<D>
// is instantiated at D = 32, 64, 128 and 256; another d runs the next wider
// D with rows at stride d, the columns >= d loaded as zeros and never
// stored.  Each thread owns 16 columns at every D, so TPR = D / 16 threads
// share a row (16 at D = 256), and the rows a block holds drop with D so that
// a block stays at 256 threads or fewer (16 rows at D = 256: 256 threads of
// up to 255 registers fill the SM's 65,536).  The fused kernel takes the same
// head dims the same way, its dq slabs at row stride d too.
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
template <typename T>
__device__ __forceinline__ float4 load_cols(const T* row, int col, int d) {
  return col < d ? lg_load4(row + col) : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dcap,
                    const float* __restrict__ dlse, T* __restrict__ dq,
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
  const T* kb = k + (size_t)(bh / G) * S * d;
  const T* vb = v + (size_t)(bh / G) * S * d;

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
    lg_stage<T, D, BS, C::kThreads>(Ks, kb, k0, S, d);
    lg_stage<T, D, BS, C::kThreads>(Vs, vb, k0, S, d);
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
    T* out = dq + ((size_t)bh * S + qi) * d;
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

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dcap, T* __restrict__ dk,
                     T* __restrict__ dv, const int* __restrict__ lens, int S,
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
    const T* qb = q + (size_t)bh * S * d;
    const T* ob = dout + (size_t)bh * S * d;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * BS;
      __syncthreads();  // the previous tile is no longer read
      lg_stage<T, D, BS, C::kThreads>(Qs, qb, q0, S, d);
      lg_stage<T, D, BS, C::kThreads>(Os, ob, q0, S, d);
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
    T* dkr = dk + ((size_t)bkv * S + kj) * d;
    T* dvr = dv + ((size_t)bkv * S + kj) * d;
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

// The operands of a two-pass backward call; `dlse`, `dq` and `dcap_out` are
// the dq pass's, `dk` and `dv` the dk/dv pass's.
struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *dcap, *dlse;
  void *dq, *dcap_out, *dk, *dv;
  const void* lens;
  int BH, G, S, d;
  float scale;
  int causal, window;
};

template <typename T, int D>
int launch_dq(const BwdArgs& a, cudaStream_t stream) {
  dim3 grid((a.S + Cfg<D>::kRows - 1) / Cfg<D>::kRows, a.BH);
  flash_bwd_dq_kernel<T, D><<<grid, Cfg<D>::kThreads, 0, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.dcap, (const float*)a.dlse,
      (T*)a.dq, (float*)a.dcap_out, (const int*)a.lens, a.S, a.G, a.d,
      a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  dim3 grid((a.S + Cfg<D>::kRows - 1) / Cfg<D>::kRows, a.BH / a.G);
  flash_bwd_dkv_kernel<T, D><<<grid, Cfg<D>::kThreads, 0, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.dcap, (T*)a.dk, (T*)a.dv,
      (const int*)a.lens, a.S, a.G, a.d, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

// The pass `dkv` (0: dq, 1: dk/dv) at the narrowest instantiation that
// holds d columns.
template <typename T>
int launch_pass(int dkv, const BwdArgs& a, cudaStream_t st) {
  if (a.d <= 32)
    return dkv ? launch_dkv<T, 32>(a, st) : launch_dq<T, 32>(a, st);
  if (a.d <= 64)
    return dkv ? launch_dkv<T, 64>(a, st) : launch_dq<T, 64>(a, st);
  if (a.d <= 128)
    return dkv ? launch_dkv<T, 128>(a, st) : launch_dq<T, 128>(a, st);
  return dkv ? launch_dkv<T, 256>(a, st) : launch_dq<T, 256>(a, st);
}

int run_pass(int dkv, const BwdArgs& a, int is_bf16, void* stream) {
  if (a.d % 8 != 0 || a.d < 8 || a.d > 256) return (int)cudaErrorInvalidValue;
  if (a.BH <= 0 || a.S <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_pass<__nv_bfloat16>(dkv, a, st)
                 : launch_pass<float>(dkv, a, st);
}

// Shared memory of the fused kernel, in bytes: the streamed Q and dO tiles,
// the block's K rows (f32), the tile's ds with a padded row, lse and dcap.
template <int D>
constexpr int fused_smem_bytes() {
  using C = Cfg<D>;
  return (2 * C::BS + C::kRows) * C::D4 * (int)sizeof(float4) +
         C::BS * (C::kRows + 1) * (int)sizeof(float) +
         2 * C::BS * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dcap,
                       float* __restrict__ dq_slabs, T* __restrict__ dk,
                       T* __restrict__ dv, int BH, int S, int d, float scale,
                       int causal) {
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

  const int bh = blockIdx.y;
  const int kb = blockIdx.x;
  const int k0 = kb * KR;
  const int t = threadIdx.x;
  const int row = t / TPR, part = t % TPR;
  const int kj = k0 + row;
  const size_t rk = (size_t)bh * S + min(kj, S - 1);
  // slab [kb][bh] holds (S, d) f32 rows at stride d
  float* slab = dq_slabs + ((size_t)kb * BH + bh) * S * d;

  float4 kr[NC], vr[NC], dka[NC], dva[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    kr[c] = load_cols(k + rk * d, (c * TPR + part) * 4, d);
    vr[c] = load_cols(v + rk * d, (c * TPR + part) * 4, d);
    dka[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[c] = dka[c];
  }
  lg_stage<T, D, KR, C::kThreads>(Ks, k + (size_t)bh * S * d, k0, S, d);

  const int nqt = (S + BS - 1) / BS;
  // causal: query tiles wholly before this key block see none of its keys;
  // their slab rows are written as zeros (k0 = qt0 * BS < S)
  const int qt0 = causal ? k0 / BS : 0;
  const size_t nzero = (size_t)qt0 * BS * (d / 4);
  for (size_t e = t; e < nzero; e += C::kThreads)
    reinterpret_cast<float4*>(slab)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  const T* qb = q + (size_t)bh * S * d;
  const T* ob = dout + (size_t)bh * S * d;
  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * BS;
    __syncthreads();  // the previous tile and its ds are no longer read
    lg_stage<T, D, BS, C::kThreads>(Qs, qb, q0, S, d);
    lg_stage<T, D, BS, C::kThreads>(Os, ob, q0, S, d);
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
    // are zero in Ks)
    float4 acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < KR; ++j) {
      const float w = dSs[row][j];
#pragma unroll
      for (int c = 0; c < NC; ++c) axpy4(w, Ks[j][c * TPR + part], acc[c]);
    }
    const int qi = q0 + row;
    if (qi < S) {
      float4* dst = reinterpret_cast<float4*>(slab + (size_t)qi * d);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if ((c * TPR + part) * 4 < d)
          dst[c * TPR + part] =
              make_float4(acc[c].x * scale, acc[c].y * scale,
                          acc[c].z * scale, acc[c].w * scale);
    }
  }

  if (kj < S) {
    T* dkr = dk + ((size_t)bh * S + kj) * d;
    T* dvr = dv + ((size_t)bh * S + kj) * d;
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

// ops/attention.py's FUSED_ROWS sizes the dq slabs by these key rows
static_assert(Cfg<32>::kRows == 64 && Cfg<64>::kRows == 64 &&
                  Cfg<128>::kRows == 32 && Cfg<256>::kRows == 16,
              "update FUSED_ROWS in ops/attention.py with Cfg<D>::kRows");

// The operands of a fused backward call.
struct FusedArgs {
  const void *q, *k, *v, *dout, *lse, *dcap;
  void *dq_slabs, *dk, *dv;
  int BH, S, d;
  float scale;
  int causal;
};

template <typename T, int D>
int launch_fused(const FusedArgs& a, cudaStream_t stream) {
  // 41 KB at D 32, 66 KB at D 64, 54 KB at D 128, 50 KB at D 256: above
  // the 48 KB default at the wider D
  constexpr int bytes = fused_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + Cfg<D>::kRows - 1) / Cfg<D>::kRows, a.BH);
  flash_bwd_fused_kernel<T, D><<<grid, Cfg<D>::kThreads, bytes, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.dcap, (float*)a.dq_slabs,
      (T*)a.dk, (T*)a.dv, a.BH, a.S, a.d, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// The fused kernel at the narrowest instantiation that holds d columns.
template <typename T>
int launch_fused_d(const FusedArgs& a, cudaStream_t st) {
  if (a.d <= 32) return launch_fused<T, 32>(a, st);
  if (a.d <= 64) return launch_fused<T, 64>(a, st);
  if (a.d <= 128) return launch_fused<T, 128>(a, st);
  return launch_fused<T, 256>(a, st);
}

}  // namespace

extern "C" {

// `lens` is null or BH int32 valid lengths and `window` 0 (no band) or the
// band's width; for the dq pass, `dlse` is null or lse's cotangent (dcap =
// rowsum(dO * O) - dlse), and `dcap_out` null or where the refined dcap goes.
// All three return cudaErrorInvalidValue for a head dimension they lack
// (d % 8 != 0, d < 8 or d > 256).
int lg_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dcap,
                    const void* dlse, void* dq, void* dcap_out,
                    const void* lens, int BH, int G, int S, int D,
                    float scale, int causal, int window, int is_bf16,
                    void* stream) {
  const BwdArgs a{q,  k,        v,       dout,    lse,    dcap,
                  dlse, dq,      dcap_out, nullptr, nullptr, lens,
                  BH, G,        S,       D,       scale,  causal,
                  window};
  return run_pass(0, a, is_bf16, stream);
}

int lg_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dcap,
                     void* dk, void* dv, const void* lens, int BH, int G,
                     int S, int D, float scale, int causal, int window,
                     int is_bf16, void* stream) {
  const BwdArgs a{q,       k,       v,       dout, lse,  dcap,
                  nullptr, nullptr, nullptr, dk,   dv,   lens,
                  BH,      G,       S,       D,    scale, causal,
                  window};
  return run_pass(1, a, is_bf16, stream);
}

int lg_flash_bwd_fused(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dcap,
                       void* dq_slabs, void* dk, void* dv, int BH, int S,
                       int D, float scale, int causal, int is_bf16,
                       void* stream) {
  if (D % 8 != 0 || D < 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (BH <= 0 || S <= 0) return 0;
  const FusedArgs a{q, k, v, dout, lse, dcap, dq_slabs, dk, dv,
                    BH, S, D, scale, causal};
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_fused_d<__nv_bfloat16>(a, st)
                 : launch_fused_d<float>(a, st);
}

}  // extern "C"
