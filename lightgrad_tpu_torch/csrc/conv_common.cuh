// What the convolution kernels of csrc/conv.cu (CUDA cores) and
// csrc/conv_tc.cu (tensor cores) share: the geometry of a call, the taps a
// residue class of the input gradient receives, and the fixed-order sum of
// split partials.
#pragma once

#include "common.cuh"

// Internal to each kernel file that includes it (a kernel whose parameter
// type sits in an anonymous namespace inside a named one breaks nvcc's
// host stubs).
namespace {

// Layouts: x (B, Cin, D, H, W), w (Cout, Cin/G, KD, KH, KW), y (B, Cout,
// OD, OH, OW); 1-D and 2-D convolutions come with unit leading spatial
// dims.  VALID padding, any stride and dilation.
struct Geom {
  int B, Cin, Cout, G, D, H, W, OD, OH, OW, KD, KH, KW, sd, sh, sw, dd, dh,
      dw;
};
constexpr int kGeomInts = 19;

// The taps of one dimension that reach input positions with residue r
// modulo the stride s under dilation d: k = k0 + j*p for j < n
// (k*d = r mod s; p = s / gcd(s, d)).
struct Taps {
  int k0, p, n;
};

__device__ __forceinline__ Taps taps_for(int r, int K, int s, int d) {
  int p = s;
  for (int i = 1; i < s; ++i)
    if ((i * d) % s == 0) {
      p = i;
      break;
    }
  for (int k = 0; k < p && k < K; ++k)
    if ((k * d) % s == r) return Taps{k, p, (K - 1 - k) / p + 1};
  return Taps{0, p, 0};
}

// out[i] = sum over p of part[p][i], p in order
template <typename T>
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    T* __restrict__ out, long long n,
                                    int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += part[p * n + i];
    out[i] = lg_from_f<T>(s);
  }
}

// The 19 geometry ints of a call (B, Cin, Cout, G, D, H, W, OD, OH, OW, KD,
// KH, KW, strides, dilations); false for shapes no convolution has.
inline bool geom_of(const int* v, Geom* g) {
  int* dst = reinterpret_cast<int*>(g);
  for (int i = 0; i < kGeomInts; ++i) {
    if (v[i] < 1) return false;
    dst[i] = v[i];
  }
  if (g->Cin % g->G || g->Cout % g->G) return false;
  const int in[3] = {g->D, g->H, g->W}, out[3] = {g->OD, g->OH, g->OW};
  const int ks[3] = {g->KD, g->KH, g->KW}, st[3] = {g->sd, g->sh, g->sw};
  const int dl[3] = {g->dd, g->dh, g->dw};
  for (int i = 0; i < 3; ++i) {
    const long long span = (long long)(ks[i] - 1) * dl[i] + 1;
    if (span > in[i] || out[i] != (in[i] - span) / st[i] + 1) return false;
  }
  // weights of one group and tap columns index with 32-bit ints
  return (long long)g->Cout * (g->Cin / g->G) * ks[0] * ks[1] * ks[2] <
         (1LL << 31);
}

}  // namespace
