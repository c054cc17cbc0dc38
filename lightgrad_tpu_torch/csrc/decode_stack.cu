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
//       column) -- constant over K, so it multiplies a column's whole sum;
//   TC  cache type: T, or int8 rows with an f32 scale per row -- the K
//       scale multiplies the score (before the online max), the V scale
//       folds into the context only (a += p * vs * v; the denominator sums
//       p alone, as the TPU kernel's drun does).
// Activations stay f32 in every product (the TPU's int8 variant rounds
// them to bf16 for its MXU dot).  The in-flight rows are attended and
// emitted at full precision in T even over an int8 cache; the caller
// quantizes kv_out into the cache.  One kernel serves extend and batched
// mode through groups of rows that share a cache slot:
//   extend mode (poss == nullptr): one group, every row in slot 0 at
//     positions pos0 .. pos0+n-1 (pos0 read from pos_dev on the device
//     where given, so a captured launch replays at any position); row r
//     attends cache rows < pos0 plus in-flight rows j <= r;
//   batched mode: n groups, row r in slot r at position poss[r]; it attends
//     its own cache rows < poss[r] plus its own new row.
// Per layer: LN1, QKV, attention, proj + residual, LN2, tanh-GELU MLP +
// residual.  The new K/V rows go to kv_out (L, 2, n, d); the caller scatters
// them into the cache, so the cache is only read here.  Weights arrive packed
// by ops/decode_stack.py::pack_gpt_stack: slabs (L, 4+2R, d, d) stored [in,
// out], vecs (L, 9+R, d) the LN parameters and biases.
//
// What bounds it on this card: latency, not bytes.  The layers are a chain
// of dependent phases; at n <= 8 each phase is a few round trips to L2
// plus a grid-wide barrier, while the weight and cache bytes a layer (28 MB
// in f32 at GPT-2 small's widths, 8.5 us at 3.35 TB/s) need not wait for
// the chain: everything the call reads from HBM is known at launch.
// Design: ONE cooperative launch, one block of 256 threads an SM, five
// phases a layer separated by grid-wide arrive / spin barriers (four after
// the last layer; 8 a layer before):
//   1 LN1 + qkv   every block computes LN1 of the n rows itself and the qkv
//                 columns it owns; writes q/k/v (f32) and kv_out;
//   2 attention   (row group, head) pairs cut into 32-key chunks of the
//                 cache rows each really sees (planned on the device from
//                 the positions), the chunks dealt evenly to the blocks;
//                 a block folds its consecutive chunks of a pair online,
//                 and the last block of a pair to finish (a counter) merges
//                 the pair's partials in block order with the in-flight
//                 rows: no merge phase;
//   3 proj        the block's proj columns, + bias into the residual;
//   4 LN2 + MLP   every block computes LN2 itself, the fc columns (hidden
//                 units) it owns and their GELU, then those units' rows of
//                 fc2 against all d outputs: one f32 partial a block (int8:
//                 each fc2 slab's column scales on its rows' sum);
//   5 fc2 sum     the block's residual columns sum the partials in block
//                 order (+ bias) -- the next layer's LN1 needs whole rows.
// Each block owns the same columns of each product in every layer, dealt in
// 16-byte vectors balanced across the blocks (full K: no split partials).
// The block's weight boxes, fc2 rows and cache chunks, in the order it uses
// them, are one stream of stages through a ring of 16 or 32 KB shared-
// memory slots, one mbarrier a slot: box rows by cp.async 16 bytes a thread
// (each thread arrives once its copies land), fc2 rows and a chunk's K / V
// rows by the copy engine (cp.async.bulk, counted in bytes).  A phase tops
// the ring up once its own input rows have landed, so the copies for later
// phases are in flight across its compute and barrier.  Products are f32
// FFMA on the CUDA cores: a thread owns four columns and takes every KW-th
// group of four K rows; the KW partial sums of a column add in a fixed
// order.  No float atomics anywhere: a call repeats bit for bit.  The
// residual stays f32 across all layers in the workspace and is rounded to T
// only at x_out.  Data written in one phase and read by another block later
// is loaded with __ldcg (L2, never a stale L1 line).  The wrapper allocates
// the f32 workspace, and zeroes once a device the sync words (the barriers'
// count, the pairs' counters) that every call leaves reusable; the kernel
// allocates nothing.
#include <type_traits>

#include "common.cuh"

// Phase stamps for scripts/ab_decode_stack.py --stamps (a build of this file
// alone defines LG_STACK_STAMPS and lg_stamp); the shipped build has none.
#ifdef LG_STACK_STAMPS
#define LG_STACK_STAMP() lg_stamp(lg_si)
#else
#define LG_STACK_STAMP()
#endif
#ifdef LG_STACK_SUBSTAMPS  // inside the phases too
#define LG_STACK_SUB() LG_STACK_STAMP()
#else
#define LG_STACK_SUB()
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 8;        // rows per call
constexpr int kHD = 64;         // head dim
constexpr int kMaxD = 4096;
// A ring slot holds one stage: 32 KB where at least four fit, else 16 KB;
// the ring takes at most 192 KB.
constexpr int kSlotBig = 32768, kSlotSmall = 16384;
constexpr int kRingMax = 196608;
constexpr int kMaxSlots = kRingMax / kSlotSmall;
constexpr int kChunk = 32;      // cache rows of one attention chunk
constexpr int kPassCols = 1024; // fc2 output columns a pass (4 a thread)
constexpr int kPart = 68;       // floats of one attention partial: m, l, acc
constexpr int kTicketBase = 32; // sync words: [0, 2) the barriers' count
constexpr int kSyncWords = 1024;
// dynamic shared memory a block may take: 227 KB less the static words
constexpr int kSmemDyn = 232448 - 2048;
constexpr int kRedFloats = kThreads * kMaxN * 4;
// a product's column biases and int8 scales, staged with its input rows
constexpr int kMaxCols = 4 * kThreads;
constexpr int kColFloats = 2 * kMaxCols;

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
  unsigned* sync;        // kSyncWords zeroed words
  int n, L, d, H, W, R;
  int slot, slots;       // ring slot bytes and count (the launch's layout)
  float eps, scale;
};

template <typename U>
constexpr bool kInt8 = std::is_same<U, int8_t>::value;

template <typename TC>
constexpr int kVOff = kChunk * kHD * (int)sizeof(TC);  // V rows in a chunk
// A chunk's K and V rows (and an int8 cache's row scales) in a slot.
template <typename TC>
constexpr int kChunkBytes = 2 * kVOff<TC> + (kInt8<TC> ? 2 * kChunk * 4 : 0);



// [v0, v0 + nv) of `total` items dealt to block b of G: shares differ by
// at most one item.
struct Share {
  int v0, nv;
};
// 32-bit arithmetic (a 64-bit division is a long subroutine on the card):
// the launch refuses a call whose total * G reaches 2^32.
__host__ __device__ inline Share share_of(int total, int b, int G) {
  const unsigned v0 = (unsigned)total * (unsigned)b / (unsigned)G;
  return {(int)v0,
          (int)((unsigned)total * (unsigned)(b + 1) / (unsigned)G - v0)};
}

// Rows of one K-box stage: as many as fill a slot, a multiple of 4.
__host__ __device__ inline int stage_rows(int nv, int K, int slot) {
  if (nv <= 0) return 0;
  const int kt = (slot / (nv * 16)) & ~3;
  return kt < K ? kt : K;
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The shared-memory layout of a launch: the ring, the staged input rows
// (n x d f32), the K-way reduction, a product's column biases and scales,
// the block's GELU rows (n x its hidden units, at most ceil(Rd / VE / G) *
// VE).
struct Layout {
  int slot, slots;
  int bytes;
};
__host__ __device__ inline Layout layout_of(int n, int d, int R, int G,
                                            int wbytes) {
  const int ve = 16 / wbytes;
  const int nj = cdiv(R * d / ve, G) * ve;
  Layout s;
  const int other = n * d * 4 + kRedFloats * 4 + kColFloats * 4 +
                    ((n * nj * 4 + 15) & ~15);
  const int ring = kSmemDyn - other < kRingMax ? kSmemDyn - other : kRingMax;
  s.slot = ring >= 4 * kSlotBig ? kSlotBig : kSlotSmall;
  s.slots = ring / s.slot;
  s.bytes = s.slots * s.slot + other;
  return s;
}

// A block's columns of one product as runs of each K row: its vectors
// [v0, v0 + nv) lie in at most two slabs (nv <= d / VE).  Elements from the
// product's first slab; hid0: fc's first hidden unit.
struct Box {
  long long col_a, col_b;
  unsigned bytes_a, bytes_b;
  int hid0;
};

template <typename TW>
__host__ __device__ Box box_of(int v0, int nv, int d) {
  constexpr int VE = 16 / (int)sizeof(TW);
  const int dv = d / VE;
  const int vnext = (v0 / dv + 1) * dv;  // the next slab's first
  const int vb = v0 + nv < vnext ? v0 + nv : vnext;
  Box x;
  x.col_a = (long long)(v0 / dv) * d * d + (long long)(v0 % dv) * VE;
  x.bytes_a = (vb - v0) * 16;
  x.col_b = (long long)(vb / dv) * d * d;
  x.bytes_b = (v0 + nv - vb) * 16;
  x.hid0 = v0 * VE;
  return x;
}

// One block's schedule, the same in every layer (ops/decode_stack.py's
// plan_stack follows the same rule; lg_decode_stack_plan exports it).  Products: qkv (K d, N
// 3d), proj (d, d), fc (d, Rd) in 16-byte column vectors; fc2 over the
// block's hidden units (its fc columns) in passes of kPassCols outputs;
// attention chunks [c0, c1) of TC in (group, head, chunk) order.
struct Plan {
  int v0q, nvq, ktq, nstq;
  int v0p, nvp, ktp, nstp;
  int v0f, nvf, ktf, nstf;
  int nj, jt_full, nst_full, passes_full, gw_last, jt_last, nstf2;
  int ng, grows;          // groups, rows a group
  int len[kMaxN], nch[kMaxN], cbase[kMaxN + 1];
  int c0, c1, cps;   // the block's chunks, chunks a stage
  int oa, op, of, of2, per_layer;
  int all_f, all_c;  // every block holds hidden units / attention chunks
  Box q, p, f;       // the block's columns of the qkv, proj and fc slabs
};

template <typename TW, typename TC>
__host__ __device__ void make_plan(const StackParams& p, Plan& pl, int G,
                                   int b) {
  constexpr int VE = 16 / (int)sizeof(TW);
  const int d = p.d;
  Share s = share_of(3 * d / VE, b, G);
  pl.v0q = s.v0;
  pl.nvq = s.nv;
  pl.ktq = stage_rows(s.nv, d, p.slot);
  pl.nstq = s.nv ? cdiv(d, pl.ktq) : 0;
  s = share_of(d / VE, b, G);
  pl.v0p = s.v0;
  pl.nvp = s.nv;
  pl.ktp = stage_rows(s.nv, d, p.slot);
  pl.nstp = s.nv ? cdiv(d, pl.ktp) : 0;
  s = share_of(p.R * d / VE, b, G);
  pl.v0f = s.v0;
  pl.nvf = s.nv;
  pl.ktf = stage_rows(s.nv, d, p.slot);
  pl.nstf = s.nv ? cdiv(d, pl.ktf) : 0;
  pl.nj = s.nv * VE;
  const int gw_full = d < kPassCols ? d : kPassCols;
  pl.passes_full = d / gw_full;
  pl.gw_last = d - pl.passes_full * gw_full;
  pl.jt_full = p.slot / (gw_full * (int)sizeof(TW));
  pl.jt_last = pl.gw_last ? p.slot / (pl.gw_last * (int)sizeof(TW)) : 1;
  pl.nst_full = pl.nj ? cdiv(pl.nj, pl.jt_full) : 0;
  pl.nstf2 = pl.passes_full * pl.nst_full +
             (pl.gw_last && pl.nj ? cdiv(pl.nj, pl.jt_last) : 0);
  // attention: the visible cache rows of each group, 32-key chunks
  const bool batched = p.poss != nullptr;
  pl.ng = batched ? p.n : 1;
  pl.grows = batched ? 1 : p.n;
  pl.cbase[0] = 0;
  for (int g = 0; g < pl.ng; ++g) {
    const int pos = batched ? p.poss[g] : p.pos_dev ? *p.pos_dev : p.pos0;
    pl.len[g] = pos < p.W ? (pos > 0 ? pos : 0) : p.W;
    pl.nch[g] = pl.len[g] ? cdiv(pl.len[g], kChunk) : 1;
    pl.cbase[g + 1] = pl.cbase[g] + p.H * pl.nch[g];
  }
  pl.q = box_of<TW>(pl.v0q, pl.nvq, d);
  pl.p = box_of<TW>(pl.v0p, pl.nvp, d);
  pl.f = box_of<TW>(pl.v0f, pl.nvf, d);
  pl.all_f = p.R * d / VE >= G;
  pl.all_c = pl.cbase[pl.ng] >= G;
  s = share_of(pl.cbase[pl.ng], b, G);
  pl.c0 = s.v0;
  pl.c1 = s.v0 + s.nv;
  pl.cps = p.slot / kChunkBytes<TC>;
  pl.oa = pl.nstq;
  pl.op = pl.oa + cdiv(s.nv, pl.cps);
  pl.of = pl.op + pl.nstp;
  pl.of2 = pl.of + pl.nstf;
  pl.per_layer = pl.of2 + pl.nstf2;
}

// Block owning chunk c of TC.
__device__ __forceinline__ int chunk_owner(int c, int TC, int G) {
  return (int)(((unsigned)(c + 1) * (unsigned)G + TC - 1) / (unsigned)TC) -
         1;
}

struct Chunk {
  int g, h, s, pair, rows;
};
__device__ __forceinline__ Chunk chunk_at(const Plan& pl, int c, int H) {
  int g = 0;
  while (g + 1 < pl.ng && pl.cbase[g + 1] <= c) ++g;
  const int rem = c - pl.cbase[g];
  Chunk k;
  k.g = g;
  k.h = rem / pl.nch[g];
  k.s = rem % pl.nch[g];
  k.pair = g * H + k.h;
  const int left = pl.len[g] - k.s * kChunk;
  k.rows = left < kChunk ? (left > 0 ? left : 0) : kChunk;
  return k;
}

// --- the stage stream: bulk copies (TMA) into the ring, one mbarrier a slot

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   lg_smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          lg_smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Waits for the phase of `parity`; a wait of seconds traps (a stage whose
// bytes never come) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  for (unsigned spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}" : "=r"(done)
        : "r"(lg_smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}
// The stream's L2 policy: evict first, so that the weights and cache rows
// passing through (28 MB a layer in f32) do not push the phases' own data
// (the residual, q / k / v, partials) out of L2.
__device__ __forceinline__ uint64_t stream_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}
// bytes (a multiple of 16, both ends 16-byte aligned) global -> shared by
// the copy engine; completion counts against the slot's mbarrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          unsigned bytes, uint64_t* bar,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(lg_smem_u32(bar)), "l"(pol)
      : "memory");
}
// 16 bytes global -> shared by cp.async under the stream's L2 policy.
__device__ __forceinline__ void stream_cp16(uint32_t dst, const void* src,
                                            uint64_t pol) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(
          dst),
      "l"(src), "l"(pol)
      : "memory");
}

// A stage's mbarrier takes an arrival from every thread once its cp.async
// copies have landed and one from thread 0 with the bulk bytes.
constexpr unsigned kArrivals = 1 + kThreads;

// A product stage's K rows by cp.async, 16 bytes a thread: a thread keeps
// one of the block's column vectors and takes every (256 / nv)-th row.
// (A bulk copy a row, at 32-80 bytes a row, was slower: the copy engine
// takes each as its own request.)
template <typename TW>
__device__ __forceinline__ void issue_box(const TW* base, int d,
                                          const Box& x, int k0, int kt,
                                          uint32_t dst) {
  constexpr int VE = 16 / (int)sizeof(TW);
  const unsigned row = x.bytes_a + x.bytes_b;
  const int nv = row / 16, nva = x.bytes_a / 16, t = threadIdx.x;
  if (t >= kThreads / nv * nv) return;
  const int v = t % nv;
  const TW* src = base + (size_t)k0 * d +
                  (v < nva ? x.col_a + v * VE : x.col_b + (v - nva) * VE);
  const uint64_t pol = stream_policy();
  for (int k = t / nv; k < kt; k += kThreads / nv)
    stream_cp16(dst + k * row + v * 16, src + (size_t)k * d, pol);
}

// Every thread issues its share of stage i (global index over the call)
// into its slot and arrives on the slot's mbarrier once its cp.async copies
// land; thread 0 also arrives with the bytes the copy engine brings (the
// K / V rows of a chunk, fc2's rows: long runs).
template <typename TW, typename TC>
__device__ void issue_stage(const StackParams& p, const Plan& pl, int i,
                            char* ring, uint64_t* full) {
  const int t = threadIdx.x;
  const int l = i / pl.per_layer, j = i % pl.per_layer;
  const int d = p.d, S = 4 + 2 * p.R;
  const int s = i % p.slots;
  uint64_t* bar = full + s;
  const uint32_t dst = lg_smem_u32(ring + (size_t)s * p.slot);
  const TW* slabs = static_cast<const TW*>(p.slabs) + (size_t)l * S * d * d;
  unsigned tx = 0;
  const uint64_t pol = stream_policy();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (j < pl.oa) {
    const int k0 = j * pl.ktq, kt = min(pl.ktq, d - k0);
    issue_box(slabs, d, pl.q, k0, kt, dst);
  } else if (j < pl.op) {
    // up to cps consecutive chunks of the block's range, one a region
    const int cf = pl.c0 + (j - pl.oa) * pl.cps;
    const int ce = min(pl.c1, cf + pl.cps);
    for (int ci = cf; ci < ce; ++ci) {
      const Chunk c = chunk_at(pl, ci, p.H);
      const uint32_t cd = dst + (ci - cf) * kChunkBytes<TC>;
      const int rows = c.rows;
      const long long slot = p.poss ? c.g : 0;
      const size_t krow = (((size_t)l * 2) * p.H + c.h) * (size_t)p.W +
                          (size_t)c.s * kChunk;
      if constexpr (kInt8<TC>) {
        const float* ksb = p.kv_scales + slot * (p.slot_stride / kHD) + krow;
        const float* vsb = ksb + (size_t)p.H * p.W;
        for (int u = t; u < rows; u += kThreads) {
          lg_cp_async4(cd + 2 * kVOff<TC> + 4 * u, ksb + u, 4);
          lg_cp_async4(cd + 2 * kVOff<TC> + 4 * (kChunk + u), vsb + u, 4);
        }
      }
      const unsigned bytes = rows * kHD * (unsigned)sizeof(TC);
      tx += 2 * bytes;
      if (t == 0 && bytes) {
        const TC* kb = static_cast<const TC*>(p.cache) +
                       slot * p.slot_stride + krow * kHD;
        bulk_copy(cd, kb, bytes, bar, pol);
        bulk_copy(cd + kVOff<TC>, kb + (size_t)p.H * p.W * kHD, bytes, bar,
                  pol);
      }
    }
  } else if (j < pl.of) {
    const int k0 = (j - pl.op) * pl.ktp, kt = min(pl.ktp, d - k0);
    issue_box(slabs + (size_t)3 * d * d, d, pl.p, k0, kt, dst);
  } else if (j < pl.of2) {
    const int k0 = (j - pl.of) * pl.ktf, kt = min(pl.ktf, d - k0);
    issue_box(slabs + (size_t)4 * d * d, d, pl.f, k0, kt, dst);
  } else {
    // fc2: the block's hidden rows, pass `ps` of the output columns; the R
    // fc2 slabs follow each other, so hidden row j is row (4 + R) * d + j
    int q = j - pl.of2, ps, jt;
    if (q < pl.passes_full * pl.nst_full) {
      ps = q / pl.nst_full;
      q %= pl.nst_full;
      jt = pl.jt_full;
    } else {
      ps = pl.passes_full;
      q -= pl.passes_full * pl.nst_full;
      jt = pl.jt_last;
    }
    const int col0 = ps * kPassCols;
    const int gw = min(kPassCols, d - col0);
    const int r0 = q * jt, rows = min(jt, pl.nj - r0);
    const unsigned rb = gw * (unsigned)sizeof(TW);
    const TW* src = slabs + ((size_t)(4 + p.R) * d + pl.f.hid0 + r0) * d + col0;
    for (int r = t; r < rows; r += kThreads)
      bulk_copy(dst + r * rb, src + (size_t)r * d, rb, bar, pol);
    tx = rows * rb;
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   lg_smem_u32(bar))
               : "memory");
  if (t == 0) mbar_expect(bar, tx);
}

// The ring's cursor: stages issued and used so far, and the end of the
// current phase's stages.
struct Ring {
  char* base;
  uint64_t* full;
  int issued, cur, limit;
};

// Issue stages up to `target` (exclusive; at most S past the next one to
// use: every call follows a __syncthreads after the last read of the stage
// just used, so all S slots are free).  Each phase tops the ring up once
// its input rows have landed, and within the phase only with its own
// stages: the copies for later phases then drain while it computes and
// waits at its barrier, and queue less in front of the next phase's input
// loads.  (A ring topped up at every stage delayed them by 2-4 us; a
// producer warp streaming beside the chain, one stage in flight, was
// slower again.)
template <typename TW, typename TC>
__device__ __forceinline__ void issue_upto(const StackParams& p,
                                           const Plan& pl, Ring& rg,
                                           int target) {
  target = min(target, min(rg.cur + p.slots, pl.per_layer * p.L));
  for (; rg.issued < target; ++rg.issued)
    issue_stage<TW, TC>(p, pl, rg.issued, rg.base, rg.full);
}

// The slot of the next stage once it has landed; first the ring is topped
// up with the current phase's stages.
template <typename TW, typename TC>
__device__ __forceinline__ const char* next_stage(const StackParams& p,
                                                  const Plan& pl, Ring& rg) {
  __syncthreads();
  issue_upto<TW, TC>(p, pl, rg, max(rg.limit, rg.cur + 1));
  const int s = rg.cur % p.slots;
  mbar_wait(rg.full + s, (rg.cur / p.slots) & 1);
  ++rg.cur;
  return rg.base + (size_t)s * p.slot;
}

// --- helpers ----------------------------------------------------------------

// Four consecutive elements of shared memory, widened to f32.
__device__ __forceinline__ float4 ld4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* s) {
  const uint2 u = *reinterpret_cast<const uint2*>(s);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// int8 -> f32 exactly, without the conversion unit: (0x4B000000 | b + 128)
// is 2^23 + b + 128 as a float.
__device__ __forceinline__ float s8f(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388736.f;
}
__device__ __forceinline__ float4 ld4(const int8_t* s) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(s) ^ 0x80808080u;
  return make_float4(s8f(w, 0x7540), s8f(w, 0x7541), s8f(w, 0x7542),
                     s8f(w, 0x7543));
}

__device__ __forceinline__ void fma4(float4& a, float s, float4 w) {
  a.x = fmaf(s, w.x, a.x);
  a.y = fmaf(s, w.y, a.y);
  a.z = fmaf(s, w.z, a.z);
  a.w = fmaf(s, w.w, a.w);
}

__device__ __forceinline__ float gelu_tanh(float y) {
  return 0.5f * y *
         (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* a) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(a)
               : "memory");
  return v;
}

// Grid-wide barriers: every block adds one to a 64-bit count and waits
// until it reaches base + G * k at the call's k-th barrier (faster than
// cooperative_groups' grid.sync() at this grid, scripts/ab_decode_stack.py
// --barriers).  The count is never reset: a call leaves it a multiple of G
// above where it found it, so the next call's base is the count rounded
// down to a multiple of G (no block passes the first barrier before every
// block has read it), and one zeroed count serves every call on a device.
// A wait of seconds means a block never came: trap rather than hang the
// card.
__device__ __forceinline__ unsigned long long barrier_base(
    const unsigned long long* count) {
  const unsigned long long c = ld_acquire(count);
  return c - c % gridDim.x;
}
// The block's arrival (release: its writes before the count) ...
__device__ __forceinline__ void barrier_arrive(unsigned long long* count) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(count)
                 : "memory");
}
// ... and its wait, with work that needs no other block's writes between.
__device__ __forceinline__ void barrier_wait(const unsigned long long* count,
                                             unsigned long long target) {
  if (threadIdx.x == 0)
    for (unsigned spins = 0; ld_acquire(count) < target;)
      if (++spins == (1u << 26)) __trap();
  __syncthreads();
}
__device__ __forceinline__ void grid_barrier(unsigned long long* count,
                                             unsigned long long target) {
  barrier_arrive(count);
  barrier_wait(count, target);
}

// n rows of d f32 from global (written by other blocks: L2) into `h`.
__device__ __forceinline__ void stage_rows_f32(const float* src, int stride,
                                               float* h, int n, int d) {
  const int q = d / 4;
  for (int c = threadIdx.x; c < q; c += kThreads) {
    float4 v[kMaxN];
#pragma unroll
    for (int r = 0; r < kMaxN; ++r)
      if (r < n)
        v[r] = __ldcg(
            reinterpret_cast<const float4*>(src + (size_t)r * stride) + c);
#pragma unroll
    for (int r = 0; r < kMaxN; ++r)
      if (r < n) reinterpret_cast<float4*>(h)[r * q + c] = v[r];
  }
}

// LayerNorm's input in one round trip: the n rows (f32 from `src`, or the
// input x in T) into h and w, b into wb, every load of a column quad issued
// before its stores.
template <typename T>
__device__ __forceinline__ void stage_ln_input(const float* src, const T* x,
                                               const T* w, const T* b,
                                               float* h, float* wb, int n,
                                               int d) {
  const int q = d / 4;
  for (int c = threadIdx.x; c < q; c += kThreads) {
    float4 v[kMaxN];
    float wv[4], bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      wv[e] = lg_ldg(w + 4 * c + e);
      bv[e] = lg_ldg(b + 4 * c + e);
    }
#pragma unroll
    for (int r = 0; r < kMaxN; ++r)
      if (r < n) {
        if (x) {
          const T* xr = x + (size_t)r * d + 4 * c;
          v[r] = make_float4(lg_to_f(xr[0]), lg_to_f(xr[1]), lg_to_f(xr[2]),
                             lg_to_f(xr[3]));
        } else {
          v[r] = __ldcg(reinterpret_cast<const float4*>(src + (size_t)r * d) +
                        c);
        }
      }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      wb[4 * c + e] = wv[e];
      wb[d + 4 * c + e] = bv[e];
    }
#pragma unroll
    for (int r = 0; r < kMaxN; ++r)
      if (r < n) reinterpret_cast<float4*>(h)[r * q + c] = v[r];
  }
}

// Per-row sums of two of a thread's values, over the block, in a fixed
// order (part: kWarps x 2 kMaxN floats).
__device__ __forceinline__ void row_sums2(float (&v)[kMaxN],
                                          float (&q)[kMaxN], int n,
                                          float (*part)[kMaxN]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kMaxN; ++r)
    if (r < n) {
      const float a = lg_warp_sum(v[r]), b = lg_warp_sum(q[r]);
      if (lane == 0) {
        part[2 * warp][r] = a;
        part[2 * warp + 1][r] = b;
      }
    }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxN; ++r) {
    float a = 0.f, b = 0.f;
    if (r < n)
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        a += part[2 * w][r];
        b += part[2 * w + 1][r];
      }
    v[r] = a;
    q[r] = b;
  }
}

// The product's column biases (and int8 scales) into `cols`: bias(i),
// scale(i) for i < ncol, issued with the input rows.
struct ColRegs {
  float b[kMaxCols / kThreads], s[kMaxCols / kThreads];
};
template <bool kScales, typename Bias, typename Scale>
__device__ __forceinline__ void load_cols(ColRegs& c, int ncol, Bias bias,
                                          Scale scale) {
#pragma unroll
  for (int u = 0; u < kMaxCols / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    c.b[u] = i < ncol ? bias(i) : 0.f;
    if constexpr (kScales) c.s[u] = i < ncol ? scale(i) : 0.f;
  }
}
__device__ __forceinline__ void store_cols(const ColRegs& c, int ncol,
                                           float* cols, bool scales) {
#pragma unroll
  for (int u = 0; u < kMaxCols / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < ncol) {
      cols[i] = c.b[u];
      if (scales) cols[kMaxCols + i] = c.s[u];
    }
  }
}

// h[r] = LN(row r) * w + b for the n rows of d f32 in h (staged by the
// caller), w and b staged in wb (2d floats); the block sums each row and
// its squares in one pass (the residual's mean is small against its
// spread: no cancellation).
__device__ void layernorm_rows(float* h, const float* wb, int n, int d,
                               float eps, float (*part)[kMaxN]) {
  __syncthreads();
  float v[kMaxN], q[kMaxN];
#pragma unroll
  for (int r = 0; r < kMaxN; ++r) v[r] = q[r] = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads)
#pragma unroll
    for (int r = 0; r < kMaxN; ++r)
      if (r < n) {
        const float e = h[(size_t)r * d + c];
        v[r] += e;
        q[r] = fmaf(e, e, q[r]);
      }
  row_sums2(v, q, n, part);
  const float inv_d = 1.f / d;
#pragma unroll
  for (int r = 0; r < kMaxN; ++r) {
    v[r] *= inv_d;                                            // mean
    q[r] = rsqrtf(fmaxf(q[r] * inv_d - v[r] * v[r], 0.f) + eps);
  }
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float w = wb[c], bb = wb[d + c];
#pragma unroll
    for (int r = 0; r < kMaxN; ++r)
      if (r < n) {
        float* e = h + (size_t)r * d + c;
        *e = (*e - v[r]) * q[r] * w + bb;
      }
  }
  __syncthreads();
}

// The product `in (n, K) @ box` over the block's nv column vectors, its K
// rows streamed as `nst` stages of `kt` rows; epi(column in the block's
// range, row, f32 sum) once per output, in the block's fixed order.
template <typename TW, typename TC, typename Epi>
__device__ void product(const StackParams& p, const Plan& pl, Ring& rg,
                        const float* in, int K, int nv, int kt, int nst,
                        float* red, Epi epi) {
  constexpr int QPV = 16 / (int)sizeof(TW) / 4;  // column quads a vector
  constexpr int VE = 16 / (int)sizeof(TW);
  const int n = p.n, nq = nv * QPV, KW = kThreads / nq;
  const int quad = threadIdx.x % nq, kw = threadIdx.x / nq;
  float4 acc[kMaxN];
#pragma unroll
  for (int r = 0; r < kMaxN; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nst; ++s) {
    const TW* box = reinterpret_cast<const TW*>(
        next_stage<TW, TC>(p, pl, rg));
    const int k0 = s * kt, rows = min(kt, K - k0);
    if (kw < KW) {
      const TW* wq = box + (quad / QPV) * VE + (quad % QPV) * 4;
      const int rel = nv * VE;
      for (int k = 4 * kw; k < rows; k += 4 * KW) {
        const float4 w0 = ld4(wq + (size_t)k * rel);
        const float4 w1 = ld4(wq + (size_t)(k + 1) * rel);
        const float4 w2 = ld4(wq + (size_t)(k + 2) * rel);
        const float4 w3 = ld4(wq + (size_t)(k + 3) * rel);
        const float* hk = in + k0 + k;
#pragma unroll
        for (int r = 0; r < kMaxN; ++r) {
          if (r < n) {
            const float4 hv = *reinterpret_cast<const float4*>(hk + r * K);
            fma4(acc[r], hv.x, w0);
            fma4(acc[r], hv.y, w1);
            fma4(acc[r], hv.z, w2);
            fma4(acc[r], hv.w, w3);
          }
        }
      }
    }
  }
  if (kw < KW) {
#pragma unroll
    for (int r = 0; r < kMaxN; ++r)
      if (r < n)
        reinterpret_cast<float4*>(red)[(kw * nq + quad) * kMaxN + r] = acc[r];
  }
  __syncthreads();
  // each output's KW sums by a group of gs lanes (a power of two), then a
  // shuffle tree: a fixed order either way
  const int outs = nq * n * 4;
  int gs = 1;
  while (gs < 32 && gs * 2 * outs <= kThreads) gs *= 2;
  for (int o0 = 0; o0 < outs; o0 += kThreads / gs) {
    const int o = o0 + threadIdx.x / gs, sub = threadIdx.x % gs;
    const int q = o / (n * 4), r = (o >> 2) % n, e = o & 3;
    float s = 0.f;
    if (o < outs)
      for (int w = sub; w < KW; w += gs)
        s += red[((w * nq + q) * kMaxN + r) * 4 + e];
    for (int m = 1; m < gs; m *= 2) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (o < outs && sub == 0) epi(q * 4 + e, r, s);
  }
  __syncthreads();
}

template <typename T, typename TW, typename TC>
__global__ void __launch_bounds__(kThreads, 1)
decode_stack_kernel(StackParams p) {
  extern __shared__ __align__(128) char smem[];
  __shared__ Plan pl;
  __shared__ float sc[kMaxN][kChunk];
  __shared__ float part[2 * kWarps][kMaxN];
  __shared__ uint64_t full[kMaxSlots];  // a slot's stage has landed
#ifdef LG_STACK_STAMPS
  int lg_si = 0;
#endif
  LG_STACK_STAMP();
  constexpr int VE = 16 / (int)sizeof(TW);
  constexpr bool W8 = kInt8<TW>;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = p.n, d = p.d, L = p.L, H = p.H, R = p.R;
  const int NV = 9 + R, S = 4 + 2 * R, d3 = 3 * d;
  const int G = gridDim.x, b = blockIdx.x;
  char* const ring = smem;
  float* const h = reinterpret_cast<float*>(smem + p.slots * p.slot);
  float* const red = h + (size_t)n * d;
  float* const cols = red + kRedFloats;   // biases, then int8 scales
  float* const gel = cols + kColFloats;

  float* const xacc = p.ws;
  float* const qkv = xacc + (size_t)n * d;
  float* const att = qkv + (size_t)n * d3;
  float* const fc2p = att + (size_t)n * d;          // (G, n, d)
  float* const attp = fc2p + (size_t)G * n * d;     // (pairs + G, rows, 68)
  unsigned long long* const count =
      reinterpret_cast<unsigned long long*>(p.sync);
  unsigned* const tickets = p.sync + kTicketBase;
  const T* const vecs = static_cast<const T*>(p.vecs);
  const T* const x = static_cast<const T*>(p.x);

  // thread 0's barrier target: base + G * k at the k-th
  unsigned long long target = 0;
  if (threadIdx.x == 0) {
    target = barrier_base(count);
    make_plan<TW, TC>(p, pl, G, b);
    for (int i = 0; i < p.slots; ++i) mbar_init(full + i, kArrivals);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  Ring rg{ring, full, 0, 0, 0};
  issue_upto<TW, TC>(p, pl, rg, p.slots);
  // each phase tops the ring up once its input rows have landed; `end`:
  // its own stages' end in the layer
  int lbase = 0;  // the layer's first stage
  auto pace = [&](int end) {
    rg.limit = lbase + end;
    issue_upto<TW, TC>(p, pl, rg, rg.cur + p.slots);
  };

  // the residual columns this block sums in phase 5: xacc = x there
  const Share own = share_of(d / 4, b, G);
  for (int i = threadIdx.x; i < n * own.nv * 4; i += kThreads) {
    const size_t e = (size_t)(i / (own.nv * 4)) * d + own.v0 * 4 +
                     i % (own.nv * 4);
    xacc[e] = lg_to_f(x[e]);
  }
  ColRegs cr;

  for (int l = 0; l < L; ++l) {
    const T* vec = vecs + (size_t)l * NV * d;
    const float* lsc = p.scales + (size_t)l * S * d;  // this layer's scales

    // 1. LN1 (every block, from the residual) and the qkv columns; the
    //    LN parameters, the columns' biases and scales in the same trip
    if (pl.nstq) {
      const int c0 = pl.v0q * VE, ncol = pl.nvq * VE;
      load_cols<W8>(cr, ncol,
                    [&](int i) {  // q, k, v biases: vecs rows 6-8
                      return lg_ldg(vec + 6 * d + c0 + i);
                    },
                    [&](int i) { return __ldg(lsc + c0 + i); });
      stage_ln_input(xacc, l == 0 ? x : nullptr, vec, vec + d, h, red, n, d);
      store_cols(cr, ncol, cols, W8);
      LG_STACK_SUB();
      layernorm_rows(h, red, n, d, p.eps, part);
      pace(pl.oa);
      LG_STACK_SUB();
      product<TW, TC>(p, pl, rg, h, d, pl.nvq, pl.ktq, pl.nstq, red,
                      [&](int cl, int r, float s) {
                        const int c = c0 + cl, kv = (c >= d) + (c >= 2 * d);
                        const int cc = c - kv * d;
                        if constexpr (W8) s *= cols[kMaxCols + cl];
                        s += cols[cl];
                        qkv[(size_t)r * d3 + c] = s;
                        if (kv)
                          static_cast<T*>(p.kv_out)[(((size_t)l * 2 + kv -
                                                      1) * n + r) * d + cc] =
                              lg_from_f<T>(s);
                      });
      LG_STACK_SUB();
    } else {
      pace(pl.oa);
    }
    grid_barrier(count, target += G);
    LG_STACK_STAMP();

    // 2. attention over the block's chunks; the last block of a pair merges
    if (pl.c1 > pl.c0) {
      stage_rows_f32(qkv, d3, h, n, d);  // q rows
      __syncthreads();
      pace(pl.op);
      LG_STACK_SUB();
      const int nchunks = pl.cbase[pl.ng];
      const int ng = pl.grows;
      // warps a row: the keys of a chunk split over them for p.v
      const int wpr = kWarps / ng, wrow = warp / wpr, wk = warp % wpr;
      float m = LG_NEG, lsum = 0.f;
      float2 a = make_float2(0.f, 0.f);
      float2* const pv = reinterpret_cast<float2*>(red);  // [warp][32]
      // the block's pairs shared with other blocks: (pair, first owner,
      // last owner, owners), ticketed together after the chunk loop
      int4* const segs = reinterpret_cast<int4*>(red + 4096);
      int nseg = 0;
      // merge a pair's partials (in block order) with its in-flight rows:
      // row `wr` of the pair's group, by the calling warp
      auto merge = [&](int pair, int bf, int bl, int wr) {
        const int g = pair / H, hh = pair % H;
        const int r = (p.poss ? g : 0) + wr;
        const float2 q2 = *reinterpret_cast<const float2*>(
            h + (size_t)r * d + hh * kHD + 2 * lane);
        const int jlo = p.poss ? r : 0;
        float2 kf[kMaxN], vf[kMaxN];
#pragma unroll
        for (int u = 0; u < kMaxN; ++u)
          if (jlo + u <= r) {
            const float* kr = qkv + (size_t)(jlo + u) * d3 + d + hh * kHD;
            kf[u] = __ldcg(reinterpret_cast<const float2*>(kr + 2 * lane));
            vf[u] = __ldcg(reinterpret_cast<const float2*>(kr + d + 2 * lane));
          }
        float M = LG_NEG, Ls = 0.f;
        float2 A = make_float2(0.f, 0.f);
        auto fold = [&](float mb, float lb, float2 ab) {
          const float Mn = fmaxf(M, mb);
          const float c = __expf(M - Mn), e = __expf(mb - Mn);
          Ls = Ls * c + lb * e;
          A.x = A.x * c + ab.x * e;
          A.y = A.y * c + ab.y * e;
          M = Mn;
        };
        for (int b0 = bf; b0 <= bl; b0 += 16) {
          float mb[16], lb[16];
          float2 ab[16];
          bool ok[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            ok[u] = b0 + u <= bl &&
                    (pl.all_c || share_of(nchunks, b0 + u, G).nv > 0);
            if (ok[u]) {
              const float* pr =
                  attp + ((size_t)(pair + b0 + u) * ng + wr) * kPart;
              mb[u] = __ldcg(pr);
              lb[u] = __ldcg(pr + 1);
              ab[u] = __ldcg(
                  reinterpret_cast<const float2*>(pr + 4 + 2 * lane));
            }
          }
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (ok[u]) fold(mb[u], lb[u], ab[u]);
        }
#pragma unroll
        for (int u = 0; u < kMaxN; ++u)  // in-flight rows, full precision
          if (jlo + u <= r)
            fold(lg_warp_sum(q2.x * kf[u].x + q2.y * kf[u].y) * p.scale, 1.f,
                 vf[u]);
        *reinterpret_cast<float2*>(att + (size_t)r * d + hh * kHD +
                                   2 * lane) = make_float2(A.x / Ls, A.y / Ls);
      };
      const char* slot = nullptr;
      for (int ci = pl.c0; ci < pl.c1; ++ci) {
        if ((ci - pl.c0) % pl.cps == 0) slot = next_stage<TW, TC>(p, pl, rg);
        const char* cb = slot + (ci - pl.c0) % pl.cps * kChunkBytes<TC>;
        const Chunk ck = chunk_at(pl, ci, H);
        const int row0 = p.poss ? ck.g : 0;
        if (ci == pl.c0 || ck.s == 0) {
          m = LG_NEG;
          lsum = 0.f;
          a = make_float2(0.f, 0.f);
        }
        const TC* ks = reinterpret_cast<const TC*>(cb);
        const TC* vs = reinterpret_cast<const TC*>(cb + kVOff<TC>);
        const float* ksc = reinterpret_cast<const float*>(cb + 2 * kVOff<TC>);
        // scores: 8 threads a key, 8 dims each
        {
          const int j = threadIdx.x >> 3, pp = threadIdx.x & 7;
          const bool ok = j < ck.rows;
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 ka = ok ? ld4(ks + j * kHD + 4 * pp) : z;
          const float4 kb = ok ? ld4(ks + j * kHD + 32 + 4 * pp) : z;
          float kscale = p.scale;
          if constexpr (kInt8<TC>) kscale *= ok ? ksc[j] : 0.f;
          for (int i = 0; i < ng; ++i) {
            const float* qr = h + (size_t)(row0 + i) * d + ck.h * kHD;
            const float4 qa = *reinterpret_cast<const float4*>(qr + 4 * pp);
            const float4 qb =
                *reinterpret_cast<const float4*>(qr + 32 + 4 * pp);
            float sdot = qa.x * ka.x;
            sdot = fmaf(qa.y, ka.y, sdot);
            sdot = fmaf(qa.z, ka.z, sdot);
            sdot = fmaf(qa.w, ka.w, sdot);
            sdot = fmaf(qb.x, kb.x, sdot);
            sdot = fmaf(qb.y, kb.y, sdot);
            sdot = fmaf(qb.z, kb.z, sdot);
            sdot = fmaf(qb.w, kb.w, sdot);
            sdot += __shfl_xor_sync(0xffffffffu, sdot, 1);
            sdot += __shfl_xor_sync(0xffffffffu, sdot, 2);
            sdot += __shfl_xor_sync(0xffffffffu, sdot, 4);
            if (pp == 0) sc[i][j] = ok ? sdot * kscale : LG_NEG;
          }
        }
        __syncthreads();
        // online softmax (every warp of a row the same), p.v over the keys
        // j = wk (mod wpr) of the row's warps, summed in warp order
        float mn = m, corr = 1.f;
        if (wrow < ng) {
          const float sj = sc[wrow][lane];
          mn = fmaxf(m, lg_warp_max(sj));
          corr = __expf(m - mn);
          const float pj = lane < ck.rows ? __expf(sj - mn) : 0.f;
          float2 ap = make_float2(0.f, 0.f);
          for (int jj = wk; jj < ck.rows; jj += wpr) {
            float pw = __shfl_sync(0xffffffffu, pj, jj);
            if constexpr (kInt8<TC>) {  // V scale: context only, not l
              pw *= ksc[kChunk + jj];
            }
            const float2 v2 = lg_load2(vs + jj * kHD + 2 * lane);
            ap.x = fmaf(pw, v2.x, ap.x);
            ap.y = fmaf(pw, v2.y, ap.y);
          }
          pv[warp * 32 + lane] = ap;
          if (wk == 0) lsum = fmaf(lsum, corr, lg_warp_sum(pj));
        }
        __syncthreads();
        if (wrow < ng) {
          if (wk == 0) {
            float2 t = make_float2(0.f, 0.f);
            for (int w = 0; w < wpr; ++w) {
              const float2 u = pv[(warp + w) * 32 + lane];
              t.x += u.x;
              t.y += u.y;
            }
            a.x = fmaf(a.x, corr, t.x);
            a.y = fmaf(a.y, corr, t.y);
          }
          m = mn;  // every warp of the row: the same running max
        }
        if (ci + 1 < pl.c1 && ck.s + 1 < pl.nch[ck.g]) continue;
        // the block's share of this pair ends
        const int first = pl.cbase[ck.g] + ck.h * pl.nch[ck.g];
        const int bf = chunk_owner(first, nchunks, G);
        const int bl = chunk_owner(first + pl.nch[ck.g] - 1, nchunks, G);
        // the blocks of [bf, bl] that hold chunks (with fewer chunks than
        // blocks, some in between hold none)
        int nown = bl - bf + 1;
        if (!pl.all_c)
          for (int bb = bf + 1; bb < bl; ++bb)
            nown -= share_of(nchunks, bb, G).nv == 0;
        if (wrow < ng && wk == 0) {
          float* pr = attp + ((size_t)(ck.pair + b) * ng + wrow) * kPart;
          if (lane == 0) {
            pr[0] = m;
            pr[1] = lsum;
          }
          *reinterpret_cast<float2*>(pr + 4 + 2 * lane) = a;
        }
        if (threadIdx.x == 0) segs[nseg] = make_int4(ck.pair, bf, bl, nown);
        ++nseg;
      }
      // after every chunk: one fence and one ticket round for the pairs
      // shared with other blocks, then the merges this block is last for,
      // a warp a pair in batched mode (their loads in flight together)
      __syncthreads();
      int* const last = reinterpret_cast<int*>(segs + nseg);
      for (int k = threadIdx.x; k < nseg; k += kThreads) {
        const int4 sg = segs[k];
        bool is_last = true;
        if (sg.w > 1) {  // acq_rel: the partials written before, read after
          unsigned old;
          asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                       : "=r"(old)
                       : "l"(tickets + sg.x)
                       : "memory");
          is_last = old == (unsigned)(sg.w - 1);
          if (is_last) tickets[sg.x] = 0;  // for the next layer
        }
        last[k] = is_last;
      }
      __syncthreads();
      if (ng == 1) {
        for (int k = warp; k < nseg; k += kWarps)
          if (last[k]) merge(segs[k].x, segs[k].y, segs[k].z, 0);
      } else if (wrow < ng && wk == 0) {
        for (int k = 0; k < nseg; ++k)
          if (last[k]) merge(segs[k].x, segs[k].y, segs[k].z, wrow);
      }
      LG_STACK_SUB();
    } else {
      pace(pl.op);
    }
    grid_barrier(count, target += G);
    LG_STACK_STAMP();

    // 3. proj columns, + bias into the residual
    if (pl.nstp) {
      const int c0 = pl.v0p * VE, ncol = pl.nvp * VE;
      load_cols<W8>(cr, ncol,
                    [&](int i) { return lg_ldg(vec + 4 * d + c0 + i); },
                    [&](int i) { return __ldg(lsc + 3 * d + c0 + i); });
      // the attention rows, and the residual's proj columns (into gel), in
      // one round trip for the first 8 columns a thread
      float xv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = threadIdx.x + u * kThreads;
        if (i < n * ncol)
          xv[u] = __ldcg(xacc + (size_t)(i / ncol) * d + c0 + i % ncol);
      }
      stage_rows_f32(att, d, h, n, d);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = threadIdx.x + u * kThreads;
        if (i < n * ncol) gel[i] = xv[u];
      }
      for (int i = threadIdx.x + 8 * kThreads; i < n * ncol; i += kThreads)
        gel[i] = __ldcg(xacc + (size_t)(i / ncol) * d + c0 + i % ncol);
      store_cols(cr, ncol, cols, W8);
      __syncthreads();
      pace(pl.of);
      product<TW, TC>(p, pl, rg, h, d, pl.nvp, pl.ktp, pl.nstp, red,
                      [&](int cl, int r, float s) {
                        if constexpr (W8) s *= cols[kMaxCols + cl];
                        s += cols[cl];
                        xacc[(size_t)r * d + c0 + cl] = gel[r * ncol + cl] + s;
                      });
    } else {
      pace(pl.of);
    }
    grid_barrier(count, target += G);
    LG_STACK_STAMP();

    // 4. LN2 (every block), the block's hidden units and their fc2 rows
    if (pl.nstf) {
      const int j0 = pl.v0f * VE, nj = pl.nj;
      load_cols<W8>(cr, nj,
                    [&](int i) { return lg_ldg(vec + 9 * d + j0 + i); },
                    [&](int i) { return __ldg(lsc + 4 * d + j0 + i); });
      stage_ln_input(xacc, (const T*)nullptr, vec + 2 * d, vec + 3 * d, h, red,
                     n, d);
      store_cols(cr, nj, cols, W8);
      LG_STACK_SUB();
      layernorm_rows(h, red, n, d, p.eps, part);
      pace(pl.per_layer);
      LG_STACK_SUB();
      product<TW, TC>(p, pl, rg, h, d, pl.nvf, pl.ktf, pl.nstf, red,
                      [&](int jl, int r, float s) {
                        if constexpr (W8) s *= cols[kMaxCols + jl];
                        gel[r * nj + jl] = gelu_tanh(s + cols[jl]);
                      });
      LG_STACK_SUB();
      // (the product's closing barrier publishes gel)
      const int passes = pl.passes_full + (pl.gw_last ? 1 : 0);
      for (int ps = 0; ps < passes; ++ps) {
        const int col0 = ps * kPassCols, gw = min(kPassCols, d - col0);
        const int jt = ps < pl.passes_full ? pl.jt_full : pl.jt_last;
        const int qd = threadIdx.x;
        const bool mine = 4 * qd < gw;
        float4 acc[kMaxN], tot[kMaxN];
#pragma unroll
        for (int r = 0; r < kMaxN; ++r)
          acc[r] = tot[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        // int8: each fc2 slab's column scales multiply its rows' sum
        int slab = j0 / d, next = (slab + 1) * d;  // the next slab's row
        auto flush = [&]() {
          const float4 sc4 = __ldg(reinterpret_cast<const float4*>(
              lsc + (size_t)(4 + R + slab) * d + col0 + 4 * qd));
#pragma unroll
          for (int r = 0; r < kMaxN; ++r) {
            tot[r].x = fmaf(acc[r].x, sc4.x, tot[r].x);
            tot[r].y = fmaf(acc[r].y, sc4.y, tot[r].y);
            tot[r].z = fmaf(acc[r].z, sc4.z, tot[r].z);
            tot[r].w = fmaf(acc[r].w, sc4.w, tot[r].w);
            acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        };
        for (int r0 = 0; r0 < nj; r0 += jt) {
          const TW* box = reinterpret_cast<const TW*>(
              next_stage<TW, TC>(p, pl, rg));
          const int rows = min(jt, nj - r0);
          if (mine) {
            for (int jj = 0; jj < rows; ++jj) {
              if constexpr (W8) {
                if (j0 + r0 + jj == next) {
                  flush();
                  ++slab;
                  next += d;
                }
              }
              const float4 w = ld4(box + (size_t)jj * gw + 4 * qd);
#pragma unroll
              for (int r = 0; r < kMaxN; ++r)
                if (r < n) fma4(acc[r], gel[r * nj + r0 + jj], w);
            }
          }
        }
        if (mine) {
          if constexpr (W8) flush();
#pragma unroll
          for (int r = 0; r < kMaxN; ++r)
            if (r < n)
              *reinterpret_cast<float4*>(fc2p + ((size_t)b * n + r) * d +
                                         col0 + 4 * qd) =
                  W8 ? tot[r] : acc[r];
        }
      }
      LG_STACK_SUB();
    } else {
      pace(pl.per_layer);
    }
    grid_barrier(count, target += G);
    LG_STACK_STAMP();

    // 5. the residual columns this block owns: the partials of every block
    //    with hidden units, in block order (8 loads in flight a thread),
    //    + bias
    if (own.nv) {
      const int no = n * own.nv;  // float4 outputs
      const int parts = kThreads / no;
      const int NVf = R * d / VE;
      const int o = threadIdx.x % no, pt = threadIdx.x / no;
      const int r = o / own.nv, c = (own.v0 + o % own.nv) * 4;
      float* xr = xacc + (size_t)r * d + c;
      float4 bias4 = make_float4(0.f, 0.f, 0.f, 0.f), x0 = bias4;
      if (threadIdx.x < no) {
        bias4 = make_float4(
            lg_ldg(vec + 5 * d + c), lg_ldg(vec + 5 * d + c + 1),
            lg_ldg(vec + 5 * d + c + 2), lg_ldg(vec + 5 * d + c + 3));
        x0 = __ldcg(reinterpret_cast<const float4*>(xr));
      }
      if (pt < parts) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int b0 = pt; b0 < G; b0 += 8 * parts) {
          float4 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int bb = b0 + u * parts;
            v[u] = bb < G && (pl.all_f || share_of(NVf, bb, G).nv)
                       ? __ldcg(reinterpret_cast<const float4*>(
                             fc2p + ((size_t)bb * n + r) * d + c))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            s.x += v[u].x;
            s.y += v[u].y;
            s.z += v[u].z;
            s.w += v[u].w;
          }
        }
        reinterpret_cast<float4*>(red)[pt * no + o] = s;
      }
      __syncthreads();
      if (threadIdx.x < no) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < parts; ++q) {
          const float4 v = reinterpret_cast<const float4*>(red)[q * no + o];
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        const float4 y = make_float4(x0.x + (s.x + bias4.x),
                                     x0.y + (s.y + bias4.y),
                                     x0.z + (s.z + bias4.z),
                                     x0.w + (s.w + bias4.w));
        *reinterpret_cast<float4*>(xr) = y;
        if (l == L - 1) {
          T* xo = static_cast<T*>(p.x_out) + (size_t)r * d + c;
          xo[0] = lg_from_f<T>(y.x);
          xo[1] = lg_from_f<T>(y.y);
          xo[2] = lg_from_f<T>(y.z);
          xo[3] = lg_from_f<T>(y.w);
        }
      }
    }
    // the next layer's first stages go out while the barrier settles
    if (l + 1 < L) {
      barrier_arrive(count);
      pace(pl.per_layer);
      barrier_wait(count, target += G);
    }
    lbase += pl.per_layer;
    LG_STACK_STAMP();
  }
}

int supported(int d, int hd, int n) {
  if (hd != kHD) return 1;
  if (d % 64 != 0 || d > kMaxD || d < 64) return 2;
  if (n < 1 || n > kMaxN) return 3;
  return 0;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// The cooperative grid of one instantiation: a block an SM, which must be
// co-resident with the most dynamic shared memory a launch asks for.
template <typename T, typename TW, typename TC>
int grid_blocks(int* blocks) {
  // one cache per instantiation and device
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
    e = cudaFuncSetAttribute(decode_stack_kernel<T, TW, TC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemDyn);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, decode_stack_kernel<T, TW, TC>, kThreads, kSmemDyn);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached_blocks = sms;
    cached_dev = dev;
  }
  *blocks = cached_blocks;
  return 0;
}

template <typename T, typename TW, typename TC>
int launch(StackParams prm, cudaStream_t stream) {
  int blocks = 0;
  const int e = grid_blocks<T, TW, TC>(&blocks);
  if (e) return e;
  const Layout lay = layout_of(prm.n, prm.d, prm.R, blocks, sizeof(TW));
  constexpr int VE = 16 / (int)sizeof(TW), QPV = VE / 4;
  // a thread a column quad of a product, at most kThreads quads a block
  if (lay.slots < 2 || cdiv(prm.R * prm.d / VE, blocks) * QPV > kThreads ||
      cdiv(3 * prm.d / VE, blocks) * QPV > kThreads ||
      prm.n * prm.H + kTicketBase > kSyncWords ||
      (long long)prm.n * prm.H * cdiv(prm.W, kChunk) * blocks >= (1LL << 32))
    return (int)cudaErrorInvalidValue;
  prm.slot = lay.slot;
  prm.slots = lay.slots;
  void* args[] = {(void*)&prm};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)decode_stack_kernel<T, TW, TC>, dim3(blocks),
      dim3(kThreads), args, (size_t)lay.bytes, stream);
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

// make_plan on the host for block b of G (weights TW, cache TC): out gets
// the qkv, proj and fc columns [first, end), the residual columns, the
// block's attention chunks [c0, c1) and its stages a layer.
template <typename TW, typename TC>
void plan_on_host(StackParams p, int G, int b, int* out) {
  constexpr int VE = 16 / (int)sizeof(TW);
  const Layout lay = layout_of(p.n, p.d, p.R, G, sizeof(TW));
  p.slot = lay.slot;
  p.slots = lay.slots;
  Plan pl;
  make_plan<TW, TC>(p, pl, G, b);
  const Share own = share_of(p.d / 4, b, G);
  const int v[] = {pl.v0q * VE, (pl.v0q + pl.nvq) * VE,
                   pl.v0p * VE, (pl.v0p + pl.nvp) * VE,
                   pl.v0f * VE, (pl.v0f + pl.nvf) * VE,
                   own.v0 * 4,  (own.v0 + own.nv) * 4,
                   pl.c0,       pl.c1,
                   pl.per_layer};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

template <typename TW>
int plan_by_cache(const StackParams& p, int cbytes, int G, int b, int* out) {
  if (cbytes == 4) plan_on_host<TW, float>(p, G, b, out);
  else if (cbytes == 2) plan_on_host<TW, __nv_bfloat16>(p, G, b, out);
  else if (cbytes == 1) plan_on_host<TW, int8_t>(p, G, b, out);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// f32 workspace elements on the current device: xacc, att (n x d), q/k/v
// (n x 3d), a block's fc2 partial (G x n x d), the attention partials
// ((pairs + G) x rows x kPart, pairs n * H at most).
long long lg_decode_stack_workspace(int n, int d, int R) {
  (void)R;
  int sms = 0;
  if (sm_count(&sms)) return 0;
  const long long nd = (long long)n * d;
  return 5 * nd + sms * nd + ((long long)n * (d / kHD) + sms) * n * kPart;
}

// int32 words, zeroed, a call needs beside the workspace.
int lg_decode_stack_sync_words() { return kSyncWords; }

// Dynamic shared memory bytes (and ring slots) of a launch of n rows at width
// d, weights of wbytes bytes, on the current device.
int lg_decode_stack_smem(int n, int d, int R, int wbytes, int* slots) {
  int sms = 0;
  if (sm_count(&sms)) return 0;
  const Layout s = layout_of(n, d, R, sms, wbytes);
  if (slots) *slots = s.slots;
  return s.bytes;
}

// Blocks of one instantiation's cooperative grid (0 on error).
int lg_decode_stack_grid(int is_bf16, int w_int8, int kv_int8) {
  int blocks = 0;
  const int e = is_bf16
      ? dispatch<__nv_bfloat16>(nullptr, w_int8, kv_int8, nullptr, &blocks)
      : dispatch<float>(nullptr, w_int8, kv_int8, nullptr, &blocks);
  return e ? 0 : blocks;
}

// Block b's schedule on a grid of G blocks, as the kernel plans it, for
// tests: n rows at width d with H heads and window W; poss (n host ints)
// in batched mode, else extend mode at pos0; weights and cache of wbytes /
// cbytes bytes an element.  out: 11 ints (plan_on_host).
int lg_decode_stack_plan(int n, int d, int R, int H, int W, const int* poss,
                         int pos0, int G, int b, int wbytes, int cbytes,
                         int* out) {
  if (supported(d, d / H, n) || H * kHD != d || G < 1 || b < 0 || b >= G)
    return (int)cudaErrorInvalidValue;
  StackParams p{};
  p.poss = poss;
  p.pos0 = pos0;
  p.n = n;
  p.L = 1;
  p.d = d;
  p.H = H;
  p.W = W;
  p.R = R;
  if (wbytes == 4) return plan_by_cache<float>(p, cbytes, G, b, out);
  if (wbytes == 2) return plan_by_cache<__nv_bfloat16>(p, cbytes, G, b, out);
  if (wbytes == 1) return plan_by_cache<int8_t>(p, cbytes, G, b, out);
  return (int)cudaErrorInvalidValue;
}

int lg_decode_stack(const void* x, const void* cache, long long slot_stride,
                    const void* poss, int pos0, const void* pos_dev,
                    const void* slabs, const void* vecs, const void* scales,
                    const void* kv_scales, void* x_out, void* kv_out,
                    void* ws, void* sync, int n, int L, int d, int H, int W,
                    int R, float eps, float scale, int is_bf16, int w_int8,
                    int kv_int8, void* stream) {
  if (supported(d, d / H, n) || H * kHD != d || (w_int8 && !scales) ||
      (kv_int8 && !kv_scales) || !sync)
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
                      static_cast<unsigned*>(sync),
                      n, L, d, H, W, R, 0, 0, eps, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(&p, w_int8, kv_int8, st, nullptr)
                 : dispatch<float>(&p, w_int8, kv_int8, st, nullptr);
}

}  // extern "C"
