// Batched matrix product C[z] = A[z] @ B[z], f32 accumulation.
//
// Replaces the TPU kernel lightgrad_tpu/ops/matmul.py::_pallas_matmul3
// (B, M, K) @ (B, K, N) -> (B, M, N), and through it every product of the
// lightgrad tape: nn.Linear, the attention scores and context, and the
// gradients of each.  float32 inputs are multiplied in true float32 with
// FFMA (no TF32: the JAX package's "highest" precision); bfloat16 inputs
// are widened to float32 in shared memory, summed in float32 and rounded
// once on the store.
//
// A and B are read through strides, so a transposed operand (the weight's
// W.T of nn.Linear, k.transpose(-1, -2) of the attention scores, a^T and
// b^T of the backward) and a broadcast batch (stride 0) cost no copy.  The
// batch is up to two dims, z = b1 * B2 + b2, each with its own strides:
// the (batch, heads) of attention views that cannot merge into one.  C is
// contiguous (batch, M, N).
//
// What bounds it on this card: the f32 FFMA rate and shared-memory
// bandwidth (no tensor cores yet).  Design: a 64 x 64 output tile per
// 256-thread block, each thread 4 x 4 outputs in registers; 16-deep K
// slices of A and B staged in shared memory, k-major, so each thread reads
// its four A and four B values as two 16-byte loads per k.  The tile
// loaders pick the thread-to-element map from which stride is 1, so global
// reads stay coalesced for either orientation of an operand.  Ragged M, N
// and K are masked: out-of-range A/B elements load as 0, so K is never
// padded with garbage, and out-of-range C elements are not stored.
#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;
constexpr int kPad = 4;  // keeps rows 16-byte aligned, spreads banks

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ C, int M, int N, int K, int B2,
              long long sAb1, long long sAb2, long long sAm, long long sAk,
              long long sBb1, long long sBb2, long long sBk, long long sBn) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];

  const int z = blockIdx.z;
  const long long b1 = z / B2, b2 = z % B2;
  A += b1 * sAb1 + b2 * sAb2;
  B += b1 * sBb1 + b2 * sBb2;
  C += (long long)z * M * N;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const bool a_k_fast = sAk == 1;   // A rows run along k in memory
  const bool b_n_fast = sBn == 1 || sBk != 1;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int idx = t + r * kThreads;
      const int m = a_k_fast ? idx / kBK : idx % kBM;
      const int k = a_k_fast ? idx % kBK : idx / kBM;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? lg_to_f(A[gm * sAm + gk * sAk]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBK * kBN / kThreads; ++r) {
      const int idx = t + r * kThreads;
      const int n = b_n_fast ? idx % kBN : idx / kBK;
      const int k = b_n_fast ? idx / kBN : idx % kBK;
      const int gn = n0 + n, gk = k0 + k;
      Bs[k][n] = (gn < N && gk < K) ? lg_to_f(B[gk * sBk + gn * sBn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) C[(long long)gm * N + gn] = lg_from_f<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

// C (batch, M, N) contiguous = A @ B over `batch` = B1 * B2 products;
// element (b1, b2, m, k) of A at b1*sAb1 + b2*sAb2 + m*sAm + k*sAk, and
// likewise for B's (k, n).  Strides in elements.  Returns
// cudaErrorInvalidValue for shapes the kernel lacks.
int lg_matmul(const void* A, const void* B, void* C, int M, int N, int K,
              int batch, int B2, long long sAb1, long long sAb2,
              long long sAm, long long sAk, long long sBb1, long long sBb2,
              long long sBk, long long sBn, int is_bf16, void* stream) {
  if (M < 0 || N < 0 || K < 0 || batch < 1 || batch > 65535 || B2 < 1 ||
      batch % B2 != 0 || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)A, (const __nv_bfloat16*)B, (__nv_bfloat16*)C,
        M, N, K, B2, sAb1, sAb2, sAm, sAk, sBb1, sBb2, sBk, sBn);
  else
    matmul_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)A, (const float*)B, (float*)C, M, N, K, B2, sAb1, sAb2,
        sAm, sAk, sBb1, sBb2, sBk, sBn);
  return (int)cudaGetLastError();
}

}  // extern "C"
