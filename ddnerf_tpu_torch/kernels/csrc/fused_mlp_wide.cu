// The fused NeRF MLP at hidden widths above 512 for Hopper (sm_90a): the
// wide plan, one layer at a time.  The forward (render mode, stash mode, and
// fed raw means and covariances) and the backward, in bf16 and in float32.
//
// Replaces, at the widths the fused plans of fused_mlp_fwd.cu,
// fused_mlp_bwd.cu and fused_mlp_f32.cu do not take (every width above 512;
// the TPU kernels check no width):
//   ddnerf_tpu/kernels/fused_mlp.py::fused_mlp_forward (render and
//     stash=True)                                   -> ddnerf_wide_fwd
//   ddnerf_tpu/kernels/fused_mlp.py::fused_enc_mlp_forward
//                                                   -> ddnerf_wide_enc_fwd
//   ddnerf_tpu/kernels/fused_mlp_bwd.py::fused_mlp_backward (and the custom
//     VJP fused_mlp_train_apply)                    -> ddnerf_wide_bwd
// each at compute dtype bfloat16 and float32.
//
// What it computes is the fused kernels' network with their rounding points
// (see the tops of fused_mlp_fwd.cu, fused_mlp_bwd.cu and fused_mlp_f32.cu):
// forward, every trunk layer's accumulator starts at its bias, takes the
// products in f32, and is rounded to the compute dtype, then relu'd, as the
// next layer's input (feat: no relu); the skip layer at 5 reads the IPE's 96
// columns and x4 as two K ranges; the dir layer [Wd_feat | Wa] (144 outputs)
// adds the per-ray dir projection before its rounding and relu, alpha is its
// column 128; the heads write rgb (+ mu, sigma).  Stash mode writes the
// [9, N, Hp] trunk slabs (x0..x7, feat) and the dir layer's h [N, 128].
// Backward: g rounded on entry; the cotangent chain layer by layer (g W, the
// relu mask from the stash, the cotangent rounded to bf16 at bf16, nothing
// rounded at float32); the bias gradients are f32 sums of the cotangents
// before their rounding, the weight gradients f32 sums of act^T g; the dirs
// weight gradient as kernel_per_ray_dirs says.  No input gradients.  The
// width Hp is the network's zero-padded to a multiple of WIDE_ALIGN (64): a
// padded unit is 0 forward and its cotangent 0 backward, so the padding is
// exact.
//
// Why the fused plans do not stretch here: at 1024 a 64-row bf16 activation
// tile is 128 KB and a [H, 64] weight stage another 128 KB (a block has
// 227 KB), a consumer's accumulator for 64 rows x H/2 columns is 256
// registers a thread, and in float32 a 64-row activation tile alone is
// 256 KB.  So the activations go through device memory (and L2) between the
// layers, in buffers the wrapper allocates, one GEMM launch per layer.
//
// What bounds it on this card: the operations.  A layer at 1024 does 2 H^2
// = 2.1 MFLOP per row against 4 KB of activation traffic (512 FLOP/byte
// against the H100's ~295), so every product with a side of the width is
// bound by the tensor cores (989 TFLOP/s bf16; 165 for 3xTF32) once its
// tiles keep them fed.  What keeps a tile from that here is the chain of
// one warpgroup's K tile: its products, then the wait for them, then their
// add into the f32 sum (PERF.md: a warpgroup's turn takes about
// twice its products' time on the tensor cores).
//
// Design:
// * wide_gemm_kernel<T, TA, TB>: C[M, N] = A[M, K] B[N, K]^T plus a fused
//   epilogue, for every product with a side of the width (the trunk, the
//   dir layer and the heads forward, the cotangent chain, the trunk's
//   weight gradients).  Persistent blocks, one per SM, walk 128 x 128
//   output tiles (and K splits) in order, N fastest, so the blocks running
//   together share A's row panels in L2 (B, the weights, stays there).  A
//   block is two consumer warpgroups of 64 rows and a producer warp, one
//   thread of which keeps TMA loads in flight into a ring of stages (6 of
//   32 KB at bf16, 4 of 48 KB at float32) under full / empty mbarriers
//   across tiles, so a tile's epilogue overlaps the next tile's loads.
//   Each operand K segment has a tensor map (the skip layer's IPE and x4,
//   g_feat's g_h and g_alpha, K = 96 and ragged rows: TMA fills zeros past
//   every extent), boxes in the 128-byte swizzle: K-major tiles, or at
//   bf16 MN-major boxes for an operand read transposed (the chain's
//   weights; both operands of a weight gradient).
// * bf16: wgmma m64n128k16 per consumer; each K tile of 64 goes into a
//   partial (the first k16 step overwrites it) that is added to the f32
//   sum once its products retired, and the stage is freed then.  The two
//   consumers issue in turns (named barriers), so one's products are
//   queued on the tensor cores while the other waits for its own and adds
//   them.  float32: 3xTF32 (wgmma_tf32.cuh) with A split in registers
//   from its tile, two fragments in turn (wgmma_wait<1> between k8 steps),
//   and B's big and small planes K-major (the pack's planes, split once per
//   pack by wide_tf32_split_kernel; the chain reads the transposed ones), a
//   32-deep K tile at a time.  A thread holds the 64 x 128 sum and one
//   partial: 9 or more warps leave it 168 registers (an SM quarter's 16K
//   registers over its three warps; ptxas allocates to that, not to what
//   setmaxnreg would move later), so a second partial, which would keep a
//   consumer's next K tile in flight, or a 64 x 256 tile does not fit.  A
//   two-block cluster that multicast the B tile to both blocks was measured
//   and gained nothing (PERF.md): the tiles' L2 traffic is not what
//   holds them.
// * float32 weight gradients: C = dW^T [in, out] = act^T g, A = the
//   activation from row-major TMA boxes (the register load transposes it),
//   B = the cotangent as transposed TF32 planes, which the chain's epilogue
//   writes; each trunk layer's weight gradient follows the chain step that
//   writes its cotangent, so one [2, Hp, n] plane pair serves all.
// * The tensor cores add with truncation (fused_mlp_f32.cu): each K tile's
//   products accumulate into a fresh partial that is then added to the
//   running sum in f32, which starts at the bias.
// * Epilogues, one loop per kind (a switch per element, unrolled over the
//   tile, overflowed the instruction cache): a layer's activation
//   (bias, relu, rounding; at bf16 a quad of lanes transposes its pairs so
//   that each lane stores 8 columns, 16 bytes); the dir layer (+ dproj, h,
//   alpha); the heads; a cotangent (relu mask from the stash, rounded for
//   the next product, its column sums for the bias gradient, at float32
//   its TF32 planes); a weight-gradient split's f32 partial.
// * The small products (the dir layer's, alpha's and the heads' weight
//   gradients, ~1% of the operations at 1024) keep wide_small_gemm_kernel:
//   one warpgroup per 64 x 128 tile, operands loaded by its threads.
// * Deterministic: no atomics.  A bias sum is a column sum per 128-row
//   tile in a fixed order (each thread's rows, a butterfly over the warp,
//   the warps in order), then over the tiles in order, compensated
//   (Kahan) in f32 (the heads' and alpha's: 256-row chunks of the entry
//   tile); the weight gradients' K splits and the dirs gradient's ray
//   chunks are summed in order.  The same inputs give bitwise the same
//   outputs, and stash mode the outputs of render mode, B3 those of B1 fed
//   the same IPE.
//
// Weight/bias packing: mma_common.cuh (kernels/fused_mlp.py::pack_weights).

#include <algorithm>
#include <cstring>
#include <initializer_list>
#include <type_traits>

#include "hopper_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace ddnerf;

constexpr int BM = 64;          // rows of an output tile: one wgmma m64
constexpr int BN = 128;         // columns of an output tile: wgmma n128
constexpr int NTHREADS = 128;   // one warpgroup
constexpr int WIDE_ALIGN = 64;  // the width is zero-padded to a multiple of this
constexpr uint32_t A_BYTES = BM * 128;  // [BM][128-byte rows]
constexpr uint32_t B_BYTES = BN * 128;
constexpr int CS_ROWS = 256;    // rows of a column-sum chunk
constexpr int DIR_CHUNK = 64;   // rays of a dirs-gradient chunk
constexpr int DIR_RAYS = 32;    // rays of a dir-projection block
constexpr int MAX_SPLITS = 32;  // K splits of a weight gradient
constexpr long long MAX_SMALL_M = 128;  // the small products' widest M

template <typename T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr int KT = 64;  // K of a tile: a 128-byte row
  static constexpr int E = 8;    // elements of a 16-byte chunk
};
template <>
struct Elem<float> {
  static constexpr int KT = 32;
  static constexpr int E = 4;
};

template <typename T>
constexpr bool IS_F32 = std::is_same<T, float>::value;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// ------------------------------------------------------------------ 3xTF32

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// A fragment of an m64 k8 product (wgmma_tf32.cuh's layout), split.
struct AFrag {
  uint32_t big[4], small[4];
};

// d (+)= a b in 3xTF32, small*big + big*small + big*big (the big*big term
// alone under DDNERF_F32_ONE_PASS, the fault build of chip_smoke.py);
// `acc` 0: the first product overwrites d.
__device__ __forceinline__ void mma3(float (&d)[BN / 2], const AFrag& a,
                                     uint64_t b_big, uint64_t b_small,
                                     int acc) {
#ifndef DDNERF_F32_ONE_PASS
  wgmma_tf32<BN>(d, a.small, b_big, acc);
  wgmma_tf32<BN>(d, a.big, b_small, 1);
  wgmma_tf32<BN>(d, a.big, b_big, 1);
#else
  wgmma_tf32<BN>(d, a.big, b_big, acc);
#endif
}

// ------------------------------------------------------------- the GEMM

// An operand of wide_small_gemm_kernel, read transposed: element (r, k) at
// p[k * ld + r]; r < rows and k < kvalid are read, the rest is zero.
struct Operand {
  const void* p;
  long long ld;
  long long rows;
  int kvalid;
};

enum EpiKind { EPI_ACT, EPI_DIR, EPI_HEAD, EPI_COT, EPI_STORE };

struct Epi {
  int kind;
  const float* bias;  // the accumulator's first value (nbias columns)
  int nbias;
  int relu;           // EPI_ACT
  void* out;          // compute dtype (EPI_ACT, EPI_DIR's h, EPI_COT)
  long long ldo;
  float* out32;       // f32 (EPI_COT's unrounded copy, may be null; EPI_STORE)
  long long ldo32;
  long long split_stride;  // EPI_STORE: floats between K splits' partials
  int trans;          // EPI_STORE: element (r, c) at out32[c * ldo32 + r]
  const void* mask;   // EPI_COT: the relu mask (compute dtype), or null
  long long ldm;
  float* tplane;      // EPI_COT at float32: the cotangent's transposed TF32
  long long ldt;      // planes, big (r, c) at tplane[c * ldt + r], small
  long long tplane_stride;  // tplane_stride floats further (or null)
  const float* dproj; // EPI_DIR: [rays, 128]
  int samples;
  float* y;           // EPI_DIR / EPI_HEAD: the [N, out_dim] output
  int out_dim;
};

struct Gemm {
  Operand a, b;      // A: M rows, B: N rows
  long long m, n;    // the output's extent
  int ktiles;        // K tiles in all
  int kt_split;      // K tiles per split (blockIdx.z)
  Epi e;
};

// 16 bytes of p from idx on, of which the first `valid` elements are read
// (the rest zero): one vector load where all are read and aligned.
template <typename T>
__device__ __forceinline__ uint4 fetch(const T* p, long long idx, int valid) {
  constexpr int E = Elem<T>::E;
  if (valid >= E && (idx & (E - 1)) == 0)
    return __ldg(reinterpret_cast<const uint4*>(p + idx));
  using Raw = std::conditional_t<IS_F32<T>, uint32_t, uint16_t>;
  const Raw* raw = reinterpret_cast<const Raw*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (i >= valid) break;
    const uint32_t bits = raw[idx + i];
    if constexpr (IS_F32<T>)
      w[i] = bits;
    else
      w[i >> 1] |= bits << (16 * (i & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The TF32 parts of four floats.
__device__ __forceinline__ void split4(uint4 v, uint4& big, uint4& small) {
  split_tf32(__uint_as_float(v.x), big.x, small.x);
  split_tf32(__uint_as_float(v.y), big.y, small.y);
  split_tf32(__uint_as_float(v.z), big.z, small.z);
  split_tf32(__uint_as_float(v.w), big.w, small.w);
}

// Element e of a 16-byte chunk as 16 or 32 bits.
template <typename T>
__device__ __forceinline__ void store_elem(unsigned char* dst, uint4 v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (IS_F32<T>) {
    *reinterpret_cast<uint32_t*>(dst) = w[e];
  } else {
    *reinterpret_cast<uint16_t*>(dst) =
        static_cast<uint16_t>(w[e >> 1] >> (16 * (e & 1)));
  }
}

// Rows r0 .. r0 + R - 1 of K tile kt of `op` into the swizzled K-major
// shared tile `dst` (SPLIT: a float32 B operand, big parts into dst and
// small parts into dst_small): E consecutive rows of one k a load,
// scattered into the tile (TF32 takes K-major operands only).
template <typename T, int R, bool SPLIT>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          unsigned char* dst_small,
                                          const Operand& op, long long r0,
                                          int kt, int tid) {
  constexpr int KT = Elem<T>::KT, E = Elem<T>::E;
  constexpr int G = R / E;  // row groups of a tile column
  const T* p = static_cast<const T*>(op.p);
  for (int u = tid; u < KT * G; u += NTHREADS) {
    const int kk = u / G, r = (u % G) * E;
    const int k = kt * KT + kk;
    const long long gr = r0 + r;
    const long long left = op.rows - gr;
    const int valid = k < op.kvalid ? (left < 0 ? 0 : (left > E ? E : (int)left)) : 0;
    const long long idx = (long long)k * op.ld + gr;
    uint4 v, v_small = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (SPLIT)
      split4(fetch(p, idx, valid), v, v_small);
    else
      v = fetch(p, idx, valid);
    const uint32_t in_chunk = (kk % E) * sizeof(T);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const uint32_t off = swizzle128(r + i, kk / E) + in_chunk;
      store_elem<T>(dst + off, v, i);
      if constexpr (SPLIT) store_elem<T>(dst_small + off, v_small, i);
    }
  }
}

// A bf16 operand read transposed, as an MN-major tile: [64 k][64 r]
// blocks of 128-byte rows (what wgmma takes as an MN-major operand, and
// hopper_common.cuh's smem_desc_mn describes), a 16-byte chunk of 8
// consecutive rows of one k at a time, with no scatter.  (64 rows of 128
// bytes are also a consumer's half of a K-major tile.)
constexpr uint32_t MN_BLOCK_BYTES = 64 * 128;

template <int R>
__device__ __forceinline__ void load_tile_mn(unsigned char* dst,
                                             const Operand& op, long long r0,
                                             int kt, int tid) {
  constexpr int KT = Elem<bf16>::KT, E = Elem<bf16>::E, G = R / E;
  const bf16* p = static_cast<const bf16*>(op.p);
#pragma unroll 2
  for (int u = tid; u < KT * G; u += NTHREADS) {
    const int kk = u / G, r = (u % G) * E;
    const int k = kt * KT + kk;
    const long long gr = r0 + r;
    const long long left = op.rows - gr;
    const int valid =
        k < op.kvalid ? (left < 0 ? 0 : (left > E ? E : (int)left)) : 0;
    *reinterpret_cast<uint4*>(dst + (r / 64) * MN_BLOCK_BYTES +
                              swizzle128(kk, (r % 64) / E)) =
        fetch(p, (long long)k * op.ld + gr, valid);
  }
}

// Byte offset of element (r, c) of a float32 tile of 32-float rows.
__device__ __forceinline__ uint32_t f32_off(int r, int c) {
  return swizzle128(r, c >> 2) + ((c & 3) << 2);
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// The warp's A fragment of k8 step s: rows r, r + 8, columns 8 s + t,
// 8 s + t + 4, split.
__device__ __forceinline__ void load_a(AFrag& f, uint32_t tile, int r, int s,
                                       int t) {
  const float v[4] = {lds(tile + f32_off(r, 8 * s + t)),
                      lds(tile + f32_off(r + 8, 8 * s + t)),
                      lds(tile + f32_off(r, 8 * s + t + 4)),
                      lds(tile + f32_off(r + 8, 8 * s + t + 4))};
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], f.big[i], f.small[i]);
}

template <typename T>
__device__ __forceinline__ T mask_elem(const void* m, long long idx) {
  return static_cast<const T*>(m)[idx];
}

// Two adjacent columns c, c + 1 of row r into the compute dtype at dst.
template <typename T>
__device__ __forceinline__ void store2(void* dst, float v0, float v1) {
  if constexpr (IS_F32<T>) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  }
}

// relu of the value rounded to the compute dtype (bf16: the rounding, then
// the max, as fused_mlp_fwd.cu's epilogue; float32: fmaxf).
template <typename T>
__device__ __forceinline__ void store2_act(void* dst, float v0, float v1,
                                           bool relu) {
  if constexpr (IS_F32<T>) {
    if (relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
    }
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    const float floor = relu ? 0.f : __int_as_float(0xff800000);
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __hmax2(__floats2bfloat162_rn(v0, v1), __floats2bfloat162_rn(floor, floor));
  }
}

// f(r, c, v0, v1, j, two) for each pair of the two rows (row, row + 8) and
// the columns this thread holds (8 j + 2 q, + 1 of the tile; wgmma_k16's
// accumulator layout) inside the output's extent.
template <typename F>
__device__ __forceinline__ void for_pairs(const float (&acc)[BN / 2],
                                          long long row, long long n0, int q,
                                          long long m, long long n, F&& f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = row + 8 * h;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const long long c = n0 + 8 * j + 2 * q;
      if (c >= n) continue;
      f(r, c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], j, c + 1 < n);
    }
  }
}

// EPI_ACT at bf16 for the two rows (row, row + 8) of this thread, the
// columns [n0, n) a multiple of 32 wide: each quad of lanes (q = 0..3)
// holds a row's 4 x 8 columns of 4 column groups j, a bf16 pair a lane;
// a 4 x 4 transpose by shuffles gives lane q the 16 bytes of group j0 + q,
// one store of 8 columns (a quad writes 64 contiguous bytes).
__device__ __forceinline__ void act_rows_bf16(bf16* out, long long ldo,
                                              const float (&acc)[BN / 2],
                                              long long row, long long n0,
                                              int q, long long m, long long n,
                                              bool relu) {
  const __nv_bfloat162 floor2 = __floats2bfloat162_rn(
      relu ? 0.f : __int_as_float(0xff800000), relu ? 0.f : __int_as_float(0xff800000));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = row + 8 * h;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += 4) {
      uint32_t x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 v = __hmax2(
            __floats2bfloat162_rn(acc[4 * (j0 + k) + 2 * h],
                                  acc[4 * (j0 + k) + 2 * h + 1]),
            floor2);
        x[k] = *reinterpret_cast<const uint32_t*>(&v);
      }
      // x[k] of lane i = columns 8 (j0 + k) + 2 i, + 1; after the
      // transpose x[i] of lane q = columns 8 (j0 + q) + 2 i, + 1.
      const bool o1 = q & 1, o2 = q & 2;
      uint32_t t0 = __shfl_xor_sync(0xffffffffu, o1 ? x[0] : x[1], 1);
      uint32_t t1 = __shfl_xor_sync(0xffffffffu, o1 ? x[2] : x[3], 1);
      if (o1) {
        x[0] = t0;
        x[2] = t1;
      } else {
        x[1] = t0;
        x[3] = t1;
      }
      t0 = __shfl_xor_sync(0xffffffffu, o2 ? x[0] : x[2], 2);
      t1 = __shfl_xor_sync(0xffffffffu, o2 ? x[1] : x[3], 2);
      if (o2) {
        x[0] = t0;
        x[1] = t1;
      } else {
        x[2] = t0;
        x[3] = t1;
      }
      const long long c = n0 + 8 * (j0 + q);
      if (r < m && c < n)
        *reinterpret_cast<uint4*>(out + r * ldo + c) =
            make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
}

// The epilogue of a tile.  One loop per kind (the kind is the launch's):
// the loops stay short runs of code, where one switch per element unrolled
// over the tile would not fit the instruction cache.  SUMS (EPI_COT):
// cs[2 j + e] += the two rows' cotangents of column 8 j + 2 q + e, as the
// bias sums take them (unrounded, rows past m none).
template <typename T, bool SUMS = false>
__device__ __forceinline__ void epilogue(const Epi& e, const float (&acc)[BN / 2],
                                         long long row, long long n0, int q,
                                         int z, long long m, long long n,
                                         float (&cs)[BN / 4]) {
  switch (e.kind) {
    case EPI_ACT: {
      T* out = static_cast<T*>(e.out);
      const bool relu = e.relu != 0;
      if constexpr (!IS_F32<T>) {
        if ((n - n0) % 32 == 0) {  // 16-byte stores of 8 columns
          act_rows_bf16(out, e.ldo, acc, row, n0, q, m, n, relu);
          break;
        }
      }
      for_pairs(acc, row, n0, q, m, n,
                [&](long long r, long long c, float v0, float v1, int, bool) {
                  store2_act<T>(out + r * e.ldo + c, v0, v1, relu);
                });
      break;
    }
    case EPI_DIR:
      for_pairs(acc, row, n0, q, m, n,
                [&](long long r, long long c, float v0, float v1, int, bool) {
                  if (c < DH) {
                    const float2 d = *reinterpret_cast<const float2*>(
                        e.dproj + (r / e.samples) * DH + c);
                    store2_act<T>(static_cast<T*>(e.out) + r * DH + c,
                                  v0 + d.x, v1 + d.y, true);
                  } else if (c == DH) {
                    e.y[r * e.out_dim + 3] = v0;
                  }
                });
      break;
    case EPI_HEAD:
      for_pairs(acc, row, n0, q, m, n,
                [&](long long r, long long c, float v0, float v1, int, bool) {
                  const float v[2] = {v0, v1};
#pragma unroll
                  for (int i = 0; i < 2; ++i) {
                    const long long col = c + i;
                    if (col < 3)
                      e.y[r * e.out_dim + col] = v[i];
                    else if (col < 5 && e.out_dim == 6)
                      e.y[r * e.out_dim + col + 1] = v[i];
                  }
                });
      break;
    case EPI_COT:
      for_pairs(acc, row, n0, q, m, n,
                [&](long long r, long long c, float v0, float v1, int j, bool) {
                  float w0 = v0, w1 = v1;
                  if (e.mask != nullptr) {
                    const long long mi = r * e.ldm + c;
                    if (!(to_f(mask_elem<T>(e.mask, mi)) > 0.f)) w0 = 0.f;
                    if (!(to_f(mask_elem<T>(e.mask, mi + 1)) > 0.f)) w1 = 0.f;
                  }
                  if (e.out32 != nullptr)
                    *reinterpret_cast<float2*>(e.out32 + r * e.ldo32 + c) =
                        make_float2(w0, w1);
                  store2<T>(static_cast<T*>(e.out) + r * e.ldo + c, w0, w1);
                  if constexpr (IS_F32<T>) {
                    if (e.tplane != nullptr) {
                      uint32_t big, small;
                      float* t = e.tplane + c * e.ldt + r;
                      split_tf32(w0, big, small);
                      t[0] = __uint_as_float(big);
                      t[e.tplane_stride] = __uint_as_float(small);
                      split_tf32(w1, big, small);
                      t[e.ldt] = __uint_as_float(big);
                      t[e.ldt + e.tplane_stride] = __uint_as_float(small);
                    }
                  }
                  if constexpr (SUMS) {
                    cs[2 * j] += w0;
                    cs[2 * j + 1] += w1;
                  }
                });
      break;
    case EPI_STORE: {
      float* o = e.out32 + z * e.split_stride;
      if (e.trans)
        for_pairs(acc, row, n0, q, m, n,
                  [&](long long r, long long c, float v0, float v1, int,
                      bool two) {
                    o[c * e.ldo32 + r] = v0;
                    if (two) o[(c + 1) * e.ldo32 + r] = v1;
                  });
      else
        for_pairs(acc, row, n0, q, m, n,
                  [&](long long r, long long c, float v0, float v1, int,
                      bool two) {
                    o[r * e.ldo32 + c] = v0;
                    if (two) o[r * e.ldo32 + c + 1] = v1;
                  });
      break;
    }
  }
}

// One K tile of both operands into stage `st` of the shared ring: A's and
// B's tiles, read transposed: at bf16 into MN-major tiles, at float32
// (TF32 takes K-major operands only) by the scatter, B's TF32 small parts
// after B's.
template <typename T>
__device__ __forceinline__ void load_stage(unsigned char* st, const Gemm& p,
                                           long long m0, long long n0, int kt,
                                           int tid) {
  if constexpr (IS_F32<T>) {
    load_tile<T, BM, false>(st, nullptr, p.a, m0, kt, tid);
    load_tile<T, BN, true>(st + A_BYTES, st + A_BYTES + B_BYTES, p.b, n0, kt,
                           tid);
  } else {
    load_tile_mn<BM>(st, p.a, m0, kt, tid);
    load_tile_mn<BN>(st + A_BYTES, p.b, n0, kt, tid);
  }
  fence_proxy_async();  // the stores above, before wgmma reads the tiles
}

template <typename T>
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES * (IS_F32<T> ? 2 : 1);

// The small weight gradients: one 64 x 128 tile of C per block (grid: N
// tiles, M tiles, K splits), both operands read transposed.  Two stages:
// the next K tile is loaded while the products of this one run.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    wide_small_gemm_kernel(const __grid_constant__ Gemm p) {
  constexpr int MN = IS_F32<T> ? 0 : 1;  // bf16 tiles are MN-major
  extern __shared__ unsigned char smem_raw[];
  // Tiles start on a 1024-byte boundary (the 128-byte swizzle's period).
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  const int kt0 = blockIdx.z * p.kt_split;
  const int kt1 = kt0 + p.kt_split < p.ktiles ? kt0 + p.kt_split : p.ktiles;

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;

  if (kt0 < kt1) load_stage<T>(sm, p, m0, n0, kt0, tid);
  __syncthreads();
  for (int kt = kt0; kt < kt1; ++kt) {
    const uint32_t st = STAGE_BYTES<T> * ((kt - kt0) & 1);
    const uint32_t sa = base + st, sb = sa + A_BYTES, sbs = sb + B_BYTES;
    if constexpr (IS_F32<T>) {
      AFrag f[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) load_a(f[s], sa, 16 * warp + g, s, q);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        mma3(part, f[s], smem_desc_k<128>(sb + s * 32),
             smem_desc_k<128>(sbs + s * 32), s > 0 ? 1 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_k16<BN, MN, MN>(part,
                              smem_desc_mn(sa + kk * 2048, MN_BLOCK_BYTES),
                              smem_desc_mn(sb + kk * 2048, MN_BLOCK_BYTES));
    }
    wgmma_commit();
    // The next K tile into the other stage while the products run: that
    // stage's products finished before the barrier that ended the last
    // iteration.
    if (kt + 1 < kt1)
      load_stage<T>(sm + (STAGE_BYTES<T> ^ st), p, m0, n0, kt + 1, tid);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    __syncthreads();  // this stage is free, the next one loaded
  }
  float none[BN / 4];
  epilogue<T>(p.e, acc, m0 + 16 * warp + g, n0, q, blockIdx.z, p.m, p.n, none);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One small product on `st` with `splits` K splits (p.kt_split set here).
template <typename T>
cudaError_t small_gemm(Gemm p, int splits, cudaStream_t st) {
  if (!aligned16(p.a.p) || !aligned16(p.b.p) || p.m > MAX_SMALL_M)
    return cudaErrorInvalidValue;
  p.kt_split = (p.ktiles + splits - 1) / splits;
  splits = (p.ktiles + p.kt_split - 1) / p.kt_split;
  constexpr size_t smem = 1024 + 2 * STAGE_BYTES<T>;
  // The opt-in above 48 KB: once per process and instantiation.
  static const cudaError_t setup = cudaFuncSetAttribute(
      wide_small_gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (setup != cudaSuccess) return setup;
  const dim3 grid((unsigned)((p.n + BN - 1) / BN),
                  (unsigned)((p.m + BM - 1) / BM), (unsigned)splits);
  wide_small_gemm_kernel<T><<<grid, NTHREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------ the tiled GEMM

// C[M, N] = A[M, K] B[N, K]^T (+ the epilogue) for the products with a wide
// side: every trunk layer, the dir layer and the heads forward; the
// cotangent chain; the trunk's weight gradients.  Persistent blocks of two
// consumer warpgroups of 64 rows each (warps 0..7) and a producer warp
// (warp 8, one thread of which issues TMA loads into a ring of stages under
// mbarriers), one 128 x 128 output tile at a time, the tiles (and K splits)
// dealt out in order, N fastest: the blocks running together share A's row
// panels in L2.
constexpr int TM = 128;        // rows of an output tile
constexpr int TN = BN;         // columns: wgmma n128
constexpr int TTHREADS = 288;  // two consumer warpgroups + a producer warp
constexpr uint32_t RED_BYTES = 2 * 8 * TN * 4;  // column sums: 2 x [8 warps][TN]

template <typename T>
struct TileShape;
template <>
struct TileShape<bf16> {
  static constexpr int STAGES = 6;
  static constexpr uint32_t A_BYTES = TM * 128, B_BYTES = TN * 128;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
};
template <>
struct TileShape<float> {  // B's big and small TF32 planes
  static constexpr int STAGES = 4;
  static constexpr uint32_t A_BYTES = TM * 128, B_BYTES = TN * 128;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + 2 * B_BYTES;
};

template <typename T>
constexpr size_t TILE_SMEM =
    1024 + TileShape<T>::STAGES * TileShape<T>::STAGE_BYTES + RED_BYTES +
    16 * TileShape<T>::STAGES;
static_assert(TILE_SMEM<bf16> <= MAX_SMEM && TILE_SMEM<float> <= MAX_SMEM,
              "the ring exceeds a block's shared memory");

// One tensor map per K segment of each operand (B: per TF32 plane at
// float32, big then small).  Boxes: a K-major operand [TM or TN rows][KT];
// a bf16 MN-major one [64 k][64 rows] per 64 rows; a float32 A read
// transposed (act^T of a weight gradient) [32 k][32 rows] per 32 rows.
struct TileMaps {
  CUtensorMap a[2];
  CUtensorMap b[2][2];  // [plane][segment]
};

struct TileGemm {
  long long m, n;    // the output's extent
  int kpad0;         // K extent of segment 0, a multiple of KT
  int ktiles;        // K tiles in all
  int kt_split;      // K tiles per split
  int splits, mtiles, ntiles;
  Epi e;
  float* csum;       // EPI_COT: column sums of each row tile [mtiles, n]
};

// The K tiles of A and B for ring slot `dst` (one thread).
template <typename T, int TA, int TB>
__device__ __forceinline__ void tile_loads(const TileMaps& maps, uint32_t dst,
                                           const TileGemm& p, int kt, int m0,
                                           int n0, uint32_t bar) {
  using S = TileShape<T>;
  constexpr int KT = Elem<T>::KT;
  const int s = kt * KT < p.kpad0 ? 0 : 1;
  const int k0 = kt * KT - (s ? p.kpad0 : 0);
  if constexpr (!TA) {
    tma_load_2d(dst, &maps.a[s], k0, m0, bar);
  } else if constexpr (IS_F32<T>) {
#pragma unroll
    for (int b = 0; b < TM / 32; ++b)
      tma_load_2d(dst + b * 32 * 128, &maps.a[s], m0 + 32 * b, k0, bar);
  } else {
#pragma unroll
    for (int b = 0; b < TM / 64; ++b)
      tma_load_2d(dst + b * MN_BLOCK_BYTES, &maps.a[s], m0 + 64 * b, k0, bar);
  }
  const uint32_t db = dst + S::A_BYTES;
  if constexpr (IS_F32<T>) {
    tma_load_2d(db, &maps.b[0][s], k0, n0, bar);
    tma_load_2d(db + S::B_BYTES, &maps.b[1][s], k0, n0, bar);
  } else if constexpr (!TB) {
    tma_load_2d(db, &maps.b[0][s], k0, n0, bar);
  } else {
#pragma unroll
    for (int b = 0; b < TN / 64; ++b)
      tma_load_2d(db + b * MN_BLOCK_BYTES, &maps.b[0][s], n0 + 64 * b, k0, bar);
  }
}

// wgmma_k16<128, TA, TB> with wgmma's scale-d as a value: 0 overwrites d
// with A B (the first k16 step of a zeroed partial), 1 accumulates.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Named barriers 2 and 3: consumer 0's and consumer 1's turn to issue.
constexpr int BAR_TURN = 2;

// The products of one bf16 K tile (ring slot `slot`) into the partial
// `pt`, which the first overwrites, committed as one wgmma group.
// Consumer w multiplies its 64 rows of A: rows 64 w.. of a K-major tile,
// box w of an MN-major one.
// The consumers issue in turns (0, 1, 0, ...): one's products are queued
// on the tensor cores while the other waits for its own and adds them.
template <int TA, int TB>
__device__ __forceinline__ void tile_issue(float (&pt)[TN / 2], uint32_t ring,
                                           uint32_t full, uint32_t slot,
                                           int w) {
  using S = TileShape<bf16>;
  const uint32_t st = slot % S::STAGES;
  mbar_wait(full + 8 * st, (slot / S::STAGES) & 1);
  const uint32_t sa = ring + st * S::STAGE_BYTES + w * MN_BLOCK_BYTES;
  const uint32_t sb = ring + st * S::STAGE_BYTES + S::A_BYTES;
  named_bar_sync(BAR_TURN + w, 256);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_n128<TA, TB>(
        pt,
        TA ? smem_desc_mn(sa + kk * 2048, MN_BLOCK_BYTES) : smem_desc(sa + kk * 32),
        TB ? smem_desc_mn(sb + kk * 2048, MN_BLOCK_BYTES) : smem_desc(sb + kk * 32),
        kk > 0);
  wgmma_commit();
  named_bar_arrive(BAR_TURN + (w ^ 1), 256);
}

// Slot `slot`'s products have retired: free its stage, add them in f32.
__device__ __forceinline__ void tile_retire(float (&acc)[TN / 2],
                                            const float (&pt)[TN / 2],
                                            uint32_t empty, uint32_t slot,
                                            int stages, int lane) {
  if (lane == 0) mbar_arrive(empty + 8 * (slot % stages));
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] += pt[i];
}

// Element (row r, k) of a float32 A tile: K-major [TM][32] (TA 0), or
// [32 k][32 rows] blocks of act^T (TA 1), both in the 128-byte swizzle.
template <int TA>
__device__ __forceinline__ float tile_a_f32(uint32_t sa, int r, int k) {
  if constexpr (TA)
    return lds(sa + (r >> 5) * 32 * 128 + k * 128 +
               ((((r & 31) >> 2) ^ (k & 7)) << 4) + ((r & 3) << 2));
  else
    return lds(sa + f32_off(r, k));
}

template <typename T, int TA, int TB>
__global__ void __launch_bounds__(TTHREADS, 1)
    wide_gemm_kernel(const __grid_constant__ TileGemm p,
                     const __grid_constant__ TileMaps maps) {
  static_assert(!IS_F32<T> || TB == 0, "TF32 wgmma takes K-major B only");
  using S = TileShape<T>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t red = ring + S::STAGES * S::STAGE_BYTES;
  float* red_p = reinterpret_cast<float*>(smem_raw + (red - raw));
  const uint32_t full = red + RED_BYTES, empty = full + 8 * S::STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);  // the consumers' eight warps
    }
    fence_mbar_init();
  }
  __syncthreads();
  // The units: output tiles, N fastest, K splits outermost.  32-bit unit
  // arithmetic (tile_gemm checks the count): a consumer's registers are
  // its sum, its partial and little else.
  const int tiles = p.mtiles * p.ntiles;
  const int units = tiles * p.splits;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer warp
    if (threadIdx.x != 256) return;
    uint32_t slot = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int t = u % tiles, split = u / tiles;
      const int m0 = t / p.ntiles * TM, n0 = t % p.ntiles * TN;
      const int kt0 = split * p.kt_split;
      const int kt1 = min(kt0 + p.kt_split, p.ktiles);
      for (int kt = kt0; kt < kt1; ++kt, ++slot) {
        const uint32_t st = slot % S::STAGES;
        mbar_wait(empty + 8 * st, ((slot / S::STAGES) & 1) ^ 1);
        const uint32_t bar = full + 8 * st;
        mbar_arrive_expect_tx(bar, S::STAGE_BYTES);
        tile_loads<T, TA, TB>(maps, ring + st * S::STAGE_BYTES, p, kt, m0, n0,
                              bar);
      }
    }
    return;
  }
  const int w = wg, tid = threadIdx.x - wg * 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  uint32_t slot = 0;
  int parity = 0;
  if (!IS_F32<T> && w == 1) named_bar_arrive(BAR_TURN, 256);  // 0 first
#pragma unroll 1
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int t = u % tiles, split = u / tiles;
    const int mt = t / p.ntiles, n0 = t % p.ntiles * TN;
    const int kt0 = split * p.kt_split;
    const int nk = max(0, min(kt0 + p.kt_split, p.ktiles) - kt0);
    float acc[TN / 2];
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * q + e;
        const float bv =
            p.e.bias != nullptr && col < p.e.nbias ? p.e.bias[col] : 0.f;
        acc[4 * j + e] = acc[4 * j + 2 + e] = bv;
      }
    // Each K tile's products go into a zeroed partial added to acc in f32
    // (the tensor cores add with truncation); the stage is freed once they
    // retired.  One partial a consumer: the two consumers' products
    // interleave on the tensor cores while each adds its own.
    float part[TN / 2];
#pragma unroll 1
    for (int i = 0; i < nk; ++i, ++slot) {
      if constexpr (IS_F32<T>) {
        const uint32_t st = slot % S::STAGES;
        mbar_wait(full + 8 * st, (slot / S::STAGES) & 1);
        const uint32_t sa = ring + st * S::STAGE_BYTES;
        const uint32_t sb = sa + S::A_BYTES, sbs = sb + S::B_BYTES;
        const int r = 64 * w + 16 * warp + g;
        // Two A fragments in turn: a k8 step's products run while the next
        // step's fragment is loaded and split.
        AFrag af[2];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          AFrag& f = af[s & 1];
          const float v[4] = {tile_a_f32<TA>(sa, r, 8 * s + q),
                              tile_a_f32<TA>(sa, r + 8, 8 * s + q),
                              tile_a_f32<TA>(sa, r, 8 * s + q + 4),
                              tile_a_f32<TA>(sa, r + 8, 8 * s + q + 4)};
#pragma unroll
          for (int x = 0; x < 4; ++x) split_tf32(v[x], f.big[x], f.small[x]);
          wgmma_fence();
          mma3(part, f, smem_desc_k<128>(sb + s * 32),
               smem_desc_k<128>(sbs + s * 32), s > 0 ? 1 : 0);
          wgmma_commit();
          if (s > 0) wgmma_wait<1>();
        }
      } else {
        tile_issue<TA, TB>(part, ring, full, slot, w);
      }
      wgmma_wait<0>();
      tile_retire(acc, part, empty, slot, S::STAGES, lane);
    }
    float cs[TN / 4];
#pragma unroll
    for (int i = 0; i < TN / 4; ++i) cs[i] = 0.f;
    const long long row = (long long)mt * TM + 64 * w + 16 * warp + g;
    if (p.csum == nullptr) {
      epilogue<T>(p.e, acc, row, n0, q, split, p.m, p.n, cs);
      continue;
    }
    // The tile's column sums in a fixed order: each thread's two rows, the
    // warp's eight row groups (a butterfly), the eight warps in order.
    epilogue<T, true>(p.e, acc, row, n0, q, split, p.m, p.n, cs);
#pragma unroll
    for (int i = 0; i < TN / 4; ++i) {
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 4);
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 8);
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 16);
    }
    float* buf = red_p + parity * 8 * TN;
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        buf[(4 * w + warp) * TN + 8 * j + 2 * q] = cs[2 * j];
        buf[(4 * w + warp) * TN + 8 * j + 2 * q + 1] = cs[2 * j + 1];
      }
    }
    named_bar_sync(1, 256);
    if (w == 0 && n0 + tid < p.n) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += buf[i * TN + tid];
      p.csum[(long long)mt * p.n + n0 + tid] = sum;
    }
    parity ^= 1;  // the next tile writes the other buffer
  }
  // Consumer 1's last turn handed to consumer 0.
  if (!IS_F32<T> && w == 0) named_bar_sync(BAR_TURN, 256);
}

// A 2-D operand segment: `outer` rows of `inner` elements, `ld` apart.
struct Span {
  const void* p;
  long long inner, outer, ld;
};

// A tensor map of `s` in the 128-byte swizzle (elements past the extent
// read as zero) with a box of bi x bo elements.
template <typename T>
bool tile_map(CUtensorMap* map, const Span& s, int bi, int bo) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || !aligned16(s.p) || s.inner <= 0 || s.outer <= 0 ||
      (s.ld * (long long)sizeof(T)) % 16)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)s.inner, (cuuint64_t)s.outer};
  const cuuint64_t stride[1] = {(cuuint64_t)(s.ld * (long long)sizeof(T))};
  const cuuint32_t box[2] = {(cuuint32_t)bi, (cuuint32_t)bo};
  const cuuint32_t ones[2] = {1, 1};
  return encode(map,
                IS_F32<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(s.p), dims, stride, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K splits of a tiled product: enough (output tiles x splits) to give every
// SM one unit, at most MAX_SPLITS and one K tile each.
int tile_splits(long long m, long long n, int ktiles, int sms) {
  const long long tiles = ((m + TM - 1) / TM) * ((n + TN - 1) / TN);
  long long s = sms / tiles;
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  if (s > ktiles) s = ktiles;
  return s < 1 ? 1 : (int)s;
}

// One tiled product on `st`: A's and B's K segments (B's planes at
// float32: b[1] the small parts of b[0]), read K-major, or transposed (TA,
// TB: the segment is the stored [K, rows] tensor); `splits` K splits; a
// block per SM.
template <typename T, int TA, int TB>
cudaError_t tile_gemm(TileGemm p, const Span (&a)[2], const Span (&b)[2][2],
                      int splits, int sms, cudaStream_t st) {
  constexpr int KT = Elem<T>::KT;
  TileMaps maps;
  memset(&maps, 0, sizeof(maps));
  const int nseg = p.ktiles * KT > p.kpad0 ? 2 : 1;
  const int planes = IS_F32<T> ? 2 : 1;
  for (int s = 0; s < nseg; ++s) {
    const bool ok_a = !TA ? tile_map<T>(&maps.a[s], a[s], KT, TM)
                          : tile_map<T>(&maps.a[s], a[s], IS_F32<T> ? 32 : 64,
                                        IS_F32<T> ? 32 : 64);
    if (!ok_a) return cudaErrorInvalidValue;
    for (int pl = 0; pl < planes; ++pl) {
      const bool ok_b = !TB ? tile_map<T>(&maps.b[pl][s], b[pl][s], KT, TN)
                            : tile_map<T>(&maps.b[pl][s], b[pl][s], 64, 64);
      if (!ok_b) return cudaErrorInvalidValue;
    }
  }
  p.mtiles = (int)((p.m + TM - 1) / TM);
  p.ntiles = (int)((p.n + TN - 1) / TN);
  p.kt_split = (p.ktiles + splits - 1) / splits;
  p.splits = (p.ktiles + p.kt_split - 1) / p.kt_split;
  const long long units = (long long)p.mtiles * p.ntiles * p.splits;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  // The opt-in above 48 KB: once per process and instantiation.
  static const cudaError_t setup = cudaFuncSetAttribute(
      wide_gemm_kernel<T, TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TILE_SMEM<T>);
  if (setup != cudaSuccess) return setup;
  const unsigned grid = (unsigned)(units < sms ? units : sms);
  wide_gemm_kernel<T, TA, TB><<<grid, TTHREADS, TILE_SMEM<T>, st>>>(p, maps);
  return cudaGetLastError();
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ------------------------------------------------------- the small kernels

// dproj[r, c] = sum_j dirs[r, j] * Wd_dirs[c, j] in f32, once per ray
// (fused_mlp_fwd.cu's and fused_mlp_f32.cu's dir projections).
template <typename T>
__global__ void wide_dir_proj_kernel(const T* dirs, const T* wdirs,
                                     float* dproj, long long rays) {
  __shared__ float d[DIR_RAYS * DIRS];
  const long long r0 = (long long)blockIdx.x * DIR_RAYS;
  const int c = threadIdx.x;
  const int here = (int)(rays - r0 < DIR_RAYS ? rays - r0 : DIR_RAYS);
  for (int i = c; i < here * DIRS; i += DH) d[i] = to_f(dirs[r0 * DIRS + i]);
  float w[DIRS];
#pragma unroll
  for (int j = 0; j < DIRS; ++j) w[j] = to_f(wdirs[c * DIRS_LD + j]);
  __syncthreads();
  for (int i = 0; i < here; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < DIRS; ++j) acc = fmaf(d[i * DIRS + j], w[j], acc);
    dproj[(r0 + i) * DH + c] = acc;
  }
}

// The direct-form IPE of fused_mlp_fwd.cu's / fused_mlp_f32.cu's encoders
// (and core/math.py::integrated_pos_enc with double_angle=False), one thread
// per (row, coordinate j) climbing the 16 levels by exact scalings:
//   ipe[r, l*3 + j] = att * sin(wrap(y)), ipe[r, 48 + l*3 + j] = att *
//   sin(wrap(y + pi/2)), y = x_j 2^l, att = exp(-cov_j 4^l / 2),
// in the compute dtype (wrap: hopper_common.cuh's wrap_trig).
template <typename T>
__global__ void wide_encode_kernel(const float* means, const float* covs,
                                   long long n, T* ipe) {
  constexpr int HALF = IPE / 2;
  constexpr float HALF_PI = 1.57079632679489661923f;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * 3) return;
  const long long r = i / 3;
  const int j = (int)(i % 3);
  float y = means[i], v = covs[i];
  T* row = ipe + r * IPE;
#pragma unroll
  for (int l = 0; l < HALF / 3; ++l) {
    const float att = expf(-0.5f * v);
    row[l * 3 + j] = from_f<T>(att * sinf(wrap_trig(y)));
    row[HALF + l * 3 + j] = from_f<T>(att * sinf(wrap_trig(y + HALF_PI)));
    y *= 2.f;
    v *= 4.f;
  }
}

// The backward's entry tile gs [n, 64] in the compute dtype: g_heads in
// columns 0..4 (rgb, then mu, sigma), g_alpha in column 16, zeros.
template <typename T>
__global__ void wide_entry_kernel(const float* g, long long n, int out_dim,
                                  T* gs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * 64) return;
  const long long r = i / 64;
  const int c = (int)(i % 64);
  float v = 0.f;
  if (c < 3)
    v = g[r * out_dim + c];
  else if (c < 5 && out_dim == 6)
    v = g[r * out_dim + c + 1];
  else if (c == 16)
    v = g[r * out_dim + 3];
  gs[i] = from_f<T>(v);
}

// s += x with Kahan's compensation c: f32 arithmetic whose error does not
// grow with the number of terms (a bias gradient is a sum of up to 10^5
// cotangents that nearly cancel; a plain running sum drifted past the f32
// limit at float32 compute).  No fast-math, so nothing reassociates it.
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// Column sums of src [rows, >= cols] (row stride ld): a compensated partial
// per chunk of CS_ROWS rows, in row order, then the chunks in order.
template <typename T>
__global__ void wide_colsum_partial_kernel(const T* src, long long ld,
                                           long long rows, int cols,
                                           float* part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const long long r0 = (long long)blockIdx.y * CS_ROWS;
  const long long r1 = rows - r0 < CS_ROWS ? rows : r0 + CS_ROWS;
  float s = 0.f, comp = 0.f;
  for (long long r = r0; r < r1; ++r) kahan_add(s, comp, to_f(src[r * ld + c]));
  part[(long long)blockIdx.y * cols + c] = s;
}

__global__ void wide_colsum_reduce_kernel(const float* part, int chunks,
                                          int cols, float* out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f, comp = 0.f;
  for (int y = 0; y < chunks; ++y)
    kahan_add(s, comp, part[(long long)y * cols + c]);
  out[c] = s;
}

// out[m * ldo + j] = the sum over the splits, in order, of their partials
// [splits, M, N].
__global__ void wide_split_reduce_kernel(const float* part, int splits,
                                         long long M, long long N, float* out,
                                         long long ldo) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * M * N + i];
  out[(i / N) * ldo + i % N] = s;
}

// g_dproj[ray, c]: the f32 sum over the ray's rows, in row order, of g_h
// (float32; bf16 per ray) or of bf16(g_h) (bf16 per sample); bf16 per ray
// rounds the sum once.
template <typename T>
__global__ void wide_gdproj_kernel(const float* ghf, long long rays,
                                   int samples, int per_ray, float* gdp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays * DH) return;
  const long long ray = i / DH;
  const int c = (int)(i % DH);
  const bool round_each = !IS_F32<T> && !per_ray;
  float s = 0.f;
  for (int j = 0; j < samples; ++j) {
    const float v = ghf[(ray * samples + j) * DH + c];
    s += round_each ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  }
  if (!IS_F32<T> && per_ray) s = __bfloat162float(__float2bfloat16_rn(s));
  gdp[i] = s;
}

// d_Wd_dirs[c, j] = sum over rays of g_dproj[ray, c] dirs[ray, j] in f32:
// a partial per DIR_CHUNK rays (block), thread c, then the chunks in order.
template <typename T>
__global__ void wide_dirs_partial_kernel(const float* gdp, const T* dirs,
                                         int ld_dirs, long long rays,
                                         float* part) {
  const int c = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * DIR_CHUNK;
  const long long r1 = rays - r0 < DIR_CHUNK ? rays : r0 + DIR_CHUNK;
  float acc[DIRS];
#pragma unroll
  for (int j = 0; j < DIRS; ++j) acc[j] = 0.f;
  for (long long r = r0; r < r1; ++r) {
    const float gv = gdp[r * DH + c];
#pragma unroll
    for (int j = 0; j < DIRS; ++j)
      acc[j] = fmaf(gv, to_f(dirs[r * ld_dirs + j]), acc[j]);
  }
  float* o = part + ((long long)blockIdx.x * DH + c) * DIRS;
#pragma unroll
  for (int j = 0; j < DIRS; ++j) o[j] = acc[j];
}

__global__ void wide_dirs_reduce_kernel(const float* part, int chunks,
                                        float* gw_dirs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= DH * DIRS_LD) return;
  const int c = i / DIRS_LD, j = i % DIRS_LD;
  float s = 0.f;
  if (j < DIRS)
    for (int y = 0; y < chunks; ++y) s += part[((long long)y * DH + c) * DIRS + j];
  gw_dirs[i] = s;
}

// The TF32 planes of a float32 pack (fused_mlp_f32.cu's tf32_split_kernel,
// at any width): big and small in the packed layout, then both with every
// matrix transposed to [in, out] at its own offset.
struct SplitParams {
  const float* w;
  float *big, *small, *big_t, *small_t;
  long long plane;
  long long off[NW + 1];
  int rows[NW];
};

__global__ void wide_tf32_split_kernel(const __grid_constant__ SplitParams p) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.plane) return;
  int l = 0;
  while (l + 1 < NW && e >= p.off[l + 1]) ++l;
  const long long local = e - p.off[l];
  const int cols = (int)((p.off[l + 1] - p.off[l]) / p.rows[l]);
  const long long r = local / cols, c = local % cols;
  uint32_t big, small;
  split_tf32(p.w[e], big, small);
  p.big[e] = __uint_as_float(big);
  p.small[e] = __uint_as_float(small);
  const long long te = p.off[l] + c * p.rows[l] + r;
  p.big_t[te] = __uint_as_float(big);
  p.small_t[te] = __uint_as_float(small);
}

// ----------------------------------------------------------- host helpers

long long plane_floats(const long long* w_off) {
  return w_off[W_DIRS] + (long long)DH * DIRS_LD;
}

unsigned blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// A carving of a workspace: regions in order, each 256-byte aligned.
struct Carve {
  unsigned char* base;
  size_t at;
  template <typename T>
  T* take(size_t count) {
    T* p = base == nullptr ? nullptr : reinterpret_cast<T*>(base + at);
    at += align256(count * sizeof(T));
    return p;
  }
};

bool wide_width(int hidden) { return hidden > 0 && hidden % WIDE_ALIGN == 0; }

// The forward: every layer one GEMM.  ipe (or means / covs), dirs and the
// pack in the compute dtype T; activations into the stash or, in render
// mode, into two ping-pong slabs of the workspace.
template <typename T>
cudaError_t run_fwd(const T* ipe_in, const float* means, const float* covs,
                    const T* dirs, const T* w, const float* b, float* dproj,
                    float* out, T* stash, T* stash_h, void* ws,
                    size_t* ws_bytes, long long n, int samples, int hp,
                    int depth_head, const long long* w_off,
                    const long long* b_off, cudaStream_t st) {
  constexpr int KT = Elem<T>::KT;
  Carve cv{static_cast<unsigned char*>(ws), 0};
  T* ipe_buf = means != nullptr ? cv.take<T>((size_t)n * IPE) : nullptr;
  T* act[2] = {nullptr, nullptr};
  T* hbuf = stash_h;
  if (stash == nullptr) {
    act[0] = cv.take<T>((size_t)n * hp);
    act[1] = cv.take<T>((size_t)n * hp);
    hbuf = cv.take<T>((size_t)n * DH);
  }
  if (ws == nullptr) {  // the size query
    *ws_bytes = cv.at;
    return cudaSuccess;
  }
  if (cv.at > *ws_bytes) return cudaErrorInvalidValue;
  const long long plane = IS_F32<T> ? plane_floats(w_off) : 0;
  const long long rays = n / samples;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  wide_dir_proj_kernel<T><<<blocks(rays, DIR_RAYS), DH, 0, st>>>(
      dirs, w + w_off[W_DIRS], dproj, rays);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const T* ipe = ipe_in;
  if (means != nullptr) {
    wide_encode_kernel<T><<<blocks(n * 3, 256), 256, 0, st>>>(means, covs, n,
                                                              ipe_buf);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    ipe = ipe_buf;
  }
  auto slab = [&](int l) -> T* {
    return stash != nullptr ? stash + (long long)l * n * hp : act[l & 1];
  };
  // The weights of layer l (rows [rows, kin]) as B, K-major: at float32
  // the pack's TF32 planes, big at w + plane, small at w + 2 plane.
  auto wspan = [&](int l, long long rows, long long kin, long long col0,
                   long long kvalid, int pl) -> Span {
    return {w + (IS_F32<T> ? (pl + 1) * plane : 0) + w_off[l] + col0, kvalid,
            rows, kin};
  };
  const int ipe_pad = round_up(IPE, KT);
  for (int l = 0; l <= W_FEAT + 2; ++l) {
    TileGemm p = {};
    Span a[2] = {}, bs[2][2] = {};
    const long long rows = l <= W_FEAT ? hp : (l == W_DIR ? DHP : NHEAD);
    const long long kin = l == 0 ? IPE : (l == SKIP ? IPE + hp :
                                          (l == W_HEAD ? DH : hp));
    p.m = n;
    p.n = rows;
    if (l == 0 || l == SKIP) {
      a[0] = {ipe, IPE, n, IPE};
      for (int pl = 0; pl < 2; ++pl) bs[pl][0] = wspan(l, rows, kin, 0, IPE, pl);
      p.kpad0 = ipe_pad;
      p.ktiles = ipe_pad / KT;
      if (l == SKIP) {
        a[1] = {slab(SKIP - 1), hp, n, hp};
        for (int pl = 0; pl < 2; ++pl)
          bs[pl][1] = wspan(l, rows, kin, IPE, hp, pl);
        p.ktiles += hp / KT;
      }
    } else {
      const long long k = l == W_HEAD ? DH : hp;
      a[0] = {l == W_HEAD ? hbuf : slab(l == W_DIR ? W_FEAT : l - 1), k, n, k};
      for (int pl = 0; pl < 2; ++pl) bs[pl][0] = wspan(l, rows, kin, 0, k, pl);
      p.kpad0 = (int)k;
      p.ktiles = (int)k / KT;
    }
    p.e.nbias = (int)rows;
    p.e.out_dim = depth_head ? 6 : 4;
    p.e.y = out;
    if (l <= W_FEAT) {
      p.e.kind = EPI_ACT;
      p.e.bias = b + (l < NTRUNK ? b_off[0] + (long long)l * hp : b_off[1]);
      p.e.relu = l < NTRUNK;
      p.e.out = slab(l);
      p.e.ldo = hp;
    } else if (l == W_DIR) {  // h and out[:, 3] (alpha)
      p.e.kind = EPI_DIR;
      p.e.bias = b + b_off[2];
      p.e.out = hbuf;
      p.e.dproj = dproj;
      p.e.samples = samples;
    } else {  // the heads
      p.e.kind = EPI_HEAD;
      p.e.bias = b + b_off[3];
    }
    if ((e = tile_gemm<T, 0, 0>(p, a, bs, 1, sms, st)) != cudaSuccess)
      return e;
  }
  return cudaSuccess;
}

// K splits of a small weight gradient [M, N] (wide_small_gemm_kernel's
// 64 x 128 tiles) over `ktiles` row tiles: about two blocks per SM in all.
int wgrad_splits(long long M, long long N, int ktiles, int sms) {
  const long long tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  long long s = (2LL * sms + tiles - 1) / tiles;
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  if (s > ktiles) s = ktiles;
  return s < 1 ? 1 : (int)s;
}

// The widest weight gradient's partials, in floats: the trunk's (tiled;
// [out, in] at bf16, [in, out] at float32, the same count) and the small
// ones.
long long wgrad_part_floats(long long n, int hp, int kt_rows, int sms) {
  const int ktiles = (int)((n + kt_rows - 1) / kt_rows);
  const long long tiled[2][2] = {{hp, hp}, {hp, IPE}};
  const long long small[3][2] = {{DH, hp}, {1, hp}, {NHEAD, DH}};
  long long most = 0;
  for (const auto& s : tiled)
    most = std::max(most, tile_splits(s[0], s[1], ktiles, sms) * s[0] * s[1]);
  for (const auto& s : small)
    most = std::max(most, wgrad_splits(s[0], s[1], ktiles, sms) * s[0] * s[1]);
  return most;
}

struct BwdBufs {
  void *gs, *gd;
  float* ghf;
  void* gt;
  float* tp;    // float32: a cotangent's transposed TF32 planes [2, Hp, ldt]
  long long ldt;
  float* csum;  // column sums of row tiles
  float* wpart; // weight-gradient split partials
  float* gdp;   // g_dproj [rays, 128]
  float* dpart; // dirs-gradient partials
};

// The backward's workspace: the cotangent slabs first, where
// chip_smoke.py::_b2_slabs reads them at bf16 (gs [n, 64], gd [n, 128] in
// the compute dtype, ghf [n, 128] f32, gt [9, n, Hp] in the compute dtype),
// at float32 then the planes, then the scratch.
template <typename T>
BwdBufs bwd_layout(void* ws, size_t* bytes, long long n, int samples, int hp,
                   int sms) {
  Carve cv{static_cast<unsigned char*>(ws), 0};
  BwdBufs b;
  const long long rays = n / samples;
  const int wide = hp > DH ? hp : DH;
  b.gs = cv.take<T>((size_t)n * 64);
  b.gd = cv.take<T>((size_t)n * DH);
  b.ghf = cv.take<float>((size_t)n * DH);
  b.gt = cv.take<T>((size_t)(NTRUNK + 1) * n * hp);
  b.ldt = (n + 31) / 32 * 32;
  b.tp = IS_F32<T> ? cv.take<float>((size_t)2 * hp * b.ldt) : nullptr;
  b.csum = cv.take<float>((size_t)((n + TM - 1) / TM) * wide);
  b.wpart = cv.take<float>((size_t)wgrad_part_floats(n, hp, Elem<T>::KT, sms));
  b.gdp = cv.take<float>((size_t)rays * DH);
  b.dpart = cv.take<float>((size_t)((rays + DIR_CHUNK - 1) / DIR_CHUNK) * DH *
                           DIRS);
  *bytes = cv.at;
  return b;
}

template <typename T>
cudaError_t colsum(const T* src, long long ld, long long rows, int cols,
                   float* part, float* out, cudaStream_t st) {
  const int chunks = (int)((rows + CS_ROWS - 1) / CS_ROWS);
  wide_colsum_partial_kernel<T><<<dim3(blocks(cols, 128), chunks), 128, 0, st>>>(
      src, ld, rows, cols, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wide_colsum_reduce_kernel<<<blocks(cols, 128), 128, 0, st>>>(part, chunks,
                                                               cols, out);
  return cudaGetLastError();
}

// A small dW [M, N] (row stride ldo, at out) = A^T B over the n rows: A
// [n, M] and B [n, N] read transposed (row strides lda, ldb), f32 sums of
// K-split partials in order.
template <typename T>
cudaError_t wgrad(const T* a, long long lda, long long M, const T* bsrc,
                  long long ldb, long long N, long long n, float* out,
                  long long ldo, float* wpart, int sms, cudaStream_t st) {
  constexpr int KT = Elem<T>::KT;
  Gemm p = {};
  p.m = M;
  p.n = N;
  p.a = {a, lda, M, (int)n};
  p.b = {bsrc, ldb, N, (int)n};
  p.ktiles = round_up((int)n, KT) / KT;
  int splits = wgrad_splits(M, N, p.ktiles, sms);
  const int per = (p.ktiles + splits - 1) / splits;
  splits = (p.ktiles + per - 1) / per;
  p.e.kind = EPI_STORE;
  p.e.out32 = wpart;
  p.e.ldo32 = N;
  p.e.split_stride = M * N;
  cudaError_t e = small_gemm<T>(p, splits, st);
  if (e != cudaSuccess) return e;
  wide_split_reduce_kernel<<<blocks(M * N, 256), 256, 0, st>>>(
      wpart, splits, M, N, out, ldo);
  return cudaGetLastError();
}

// The backward: the cotangent chain, each trunk layer's weight gradient
// right after the cotangent it reads, the bias sums (the chain's folded
// into its products), the small weight gradients and the dirs gradient,
// in that order on `st`.
template <typename T>
cudaError_t run_bwd(const T* ipe, const T* dirs, int ld_dirs, const float* g,
                    const T* stash, const T* stash_h, const T* w, float* gw,
                    float* gb, void* ws, size_t ws_bytes, long long n,
                    int samples, int hp, int depth_head, int per_ray,
                    const long long* w_off, const long long* b_off, int sms,
                    cudaStream_t st) {
  constexpr int KT = Elem<T>::KT;
  constexpr int TBW = IS_F32<T> ? 0 : 1;  // the chain's B: K-major at float32
  const long long plane = IS_F32<T> ? plane_floats(w_off) : 0;
  size_t need = 0;
  BwdBufs B = bwd_layout<T>(ws, &need, n, samples, hp, sms);
  if (need > ws_bytes) return cudaErrorInvalidValue;
  const long long rays = n / samples;
  T* gs = static_cast<T*>(B.gs);
  T* gd = static_cast<T*>(B.gd);
  T* gt = static_cast<T*>(B.gt);
  auto slab = [&](const T* base, int l) {
    return const_cast<T*>(base) + (long long)l * n * hp;
  };
  // The chain's B operand: element (j, k) = W_l[row0 + k][col0 + j], ncols
  // columns j, kvalid rows k of W_l.  bf16: the pack, as stored ([k, j],
  // read MN-major); float32: the pack's transposed TF32 planes ([j, k],
  // K-major; big at w + 3 plane, small at w + 4 plane).
  auto w_t = [&](int l, long long row0, long long col0, long long ncols,
                 long long kvalid, int pl) -> Span {
    const long long rows = l <= W_FEAT ? hp : (l == W_DIR ? DHP : NHEAD);
    const long long kin = l == 0 ? IPE : (l == SKIP ? IPE + hp :
                                          (l == W_HEAD ? DH : hp));
    if constexpr (IS_F32<T>)
      return {w + (3 + pl) * plane + w_off[l] + col0 * rows + row0, kvalid,
              ncols, rows};
    else
      return {w + w_off[l] + row0 * kin + col0, ncols, kvalid, kin};
  };
  cudaError_t e = cudaMemsetAsync(gw, 0, plane_floats(w_off) * sizeof(float), st);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(gb, 0, (b_off[3] + NHEAD) * sizeof(float), st);
  if (e != cudaSuccess) return e;
  wide_entry_kernel<T><<<blocks(n * 64, 256), 256, 0, st>>>(
      g, n, depth_head ? 6 : 4, gs);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  // One product of the chain: the cotangent [n, ncols] = A B^T, masked by
  // `mask` (row stride ncols, or null), into `out` (the compute dtype) and
  // `out32` (f32, or null), its column sums (the bias gradient) into
  // `gbias`; at float32 with `planes` its transposed TF32 planes into B.tp.
  auto cot = [&](const Span (&a)[2], const Span (&bt)[2][2], int kpad0,
                 int ktiles, long long ncols, const T* mask, T* out,
                 float* out32, float* gbias, bool planes) -> cudaError_t {
    TileGemm p = {};
    p.m = n;
    p.n = ncols;
    p.kpad0 = kpad0;
    p.ktiles = ktiles;
    p.e.kind = EPI_COT;
    p.e.mask = mask;
    p.e.ldm = ncols;
    p.e.out = out;
    p.e.ldo = ncols;
    p.e.out32 = out32;
    p.e.ldo32 = ncols;
    if (IS_F32<T> && planes) {
      p.e.tplane = B.tp;
      p.e.ldt = B.ldt;
      p.e.tplane_stride = (long long)hp * B.ldt;
    }
    p.csum = B.csum;
    cudaError_t err = tile_gemm<T, 0, TBW>(p, a, bt, 1, sms, st);
    if (err != cudaSuccess) return err;
    wide_colsum_reduce_kernel<<<blocks(ncols, 128), 128, 0, st>>>(
        B.csum, (int)((n + TM - 1) / TM), (int)ncols, gbias);
    return cudaGetLastError();
  };
  // The weight gradient of trunk matrix l for its input columns [col0,
  // col0 + ins), read from act (row stride lda), over the n rows: bf16 C
  // [Hp, ins] = g^T act from the cotangent slab gsl (both read MN-major);
  // float32 C [ins, Hp] = act^T g from B.tp (the cotangent's planes),
  // stored transposed.  K-split partials summed in order into the packed
  // gradient.
  auto tile_wgrad = [&](int l, const T* gsl, const T* act, long long lda,
                        long long ins, long long col0) -> cudaError_t {
    const long long kin = l == 0 ? IPE : (l == SKIP ? IPE + hp : hp);
    TileGemm p = {};
    Span a[2] = {}, bt[2][2] = {};
    p.kpad0 = round_up((int)n, KT);
    p.ktiles = p.kpad0 / KT;
    p.e.kind = EPI_STORE;
    p.e.out32 = B.wpart;
    p.e.ldo32 = ins;
    p.e.split_stride = hp * ins;
    int splits = tile_splits(hp, ins, p.ktiles, sms);
    cudaError_t err;
    if constexpr (IS_F32<T>) {
      p.m = ins;
      p.n = hp;
      a[0] = {act, ins, n, lda};
      bt[0][0] = {B.tp, n, hp, B.ldt};
      bt[1][0] = {B.tp + (long long)hp * B.ldt, n, hp, B.ldt};
      p.e.trans = 1;
      err = tile_gemm<T, 1, 0>(p, a, bt, splits, sms, st);
    } else {
      p.m = hp;
      p.n = ins;
      a[0] = {gsl, hp, n, hp};
      bt[0][0] = {act, ins, n, lda};
      err = tile_gemm<T, 1, 1>(p, a, bt, splits, sms, st);
    }
    if (err != cudaSuccess) return err;
    const int per = (p.ktiles + splits - 1) / splits;
    splits = (p.ktiles + per - 1) / per;
    wide_split_reduce_kernel<<<blocks(hp * ins, 256), 256, 0, st>>>(
        B.wpart, splits, hp, ins, gw + w_off[l] + col0, kin);
    return cudaGetLastError();
  };

  {  // g_h = mask(h > 0, g_heads W_heads): bf16(g_h) into gd, g_h into ghf
    const Span a[2] = {{gs, NHEAD, n, 64}, {}};
    const Span bt[2][2] = {{w_t(W_HEAD, 0, 0, DH, NHEAD, 0), {}},
                           {w_t(W_HEAD, 0, 0, DH, NHEAD, 1), {}}};
    if ((e = cot(a, bt, KT, 1, DH, stash_h, gd, B.ghf, gb + b_off[2],
                 false)) != cudaSuccess)
      return e;
  }
  {  // g_feat = bf16(g_h) Wd_feat + g_alpha w_alpha, then dW_feat
    const Span a[2] = {{gd, DH, n, DH}, {gs + 16, 1, n, 64}};
    const Span bt[2][2] = {
        {w_t(W_DIR, 0, 0, hp, DH, 0), w_t(W_DIR, DH, 0, hp, 1, 0)},
        {w_t(W_DIR, 0, 0, hp, DH, 1), w_t(W_DIR, DH, 0, hp, 1, 1)}};
    if ((e = cot(a, bt, DH, DH / KT + 1, hp, nullptr, slab(gt, W_FEAT),
                 nullptr, gb + b_off[1], true)) != cudaSuccess)
      return e;
    if ((e = tile_wgrad(W_FEAT, slab(gt, W_FEAT), slab(stash, NTRUNK - 1), hp,
                        hp, 0)) != cudaSuccess)
      return e;
  }
  // The trunk: g_i = mask(x_i > 0, bf16(g_{i+1}) W_{i+1}), g_7 from g_feat
  // and fc_feat (the skip layer's x columns), then dW_i.
  for (int i = NTRUNK - 1; i >= 0; --i) {
    const int l = i == NTRUNK - 1 ? W_FEAT : i + 1;
    const long long col0 = l == SKIP ? IPE : 0;
    const Span a[2] = {{slab(gt, i + 1 == NTRUNK ? W_FEAT : i + 1), hp, n, hp},
                       {}};
    const Span bt[2][2] = {{w_t(l, 0, col0, hp, hp, 0), {}},
                           {w_t(l, 0, col0, hp, hp, 1), {}}};
    if ((e = cot(a, bt, hp, hp / KT, hp, slab(stash, i), slab(gt, i), nullptr,
                 gb + b_off[0] + (long long)i * hp, true)) != cudaSuccess)
      return e;
    if (i == 0 || i == SKIP) {
      if ((e = tile_wgrad(i, slab(gt, i), ipe, IPE, IPE, 0)) != cudaSuccess)
        return e;
    }
    if (i != 0) {
      if ((e = tile_wgrad(i, slab(gt, i), slab(stash, i - 1), hp, hp,
                          i == SKIP ? IPE : 0)) != cudaSuccess)
        return e;
    }
  }
  // The heads' and alpha's biases: sums of the entry tile.
  if ((e = colsum<T>(gs, 64, n, NHEAD, B.csum, gb + b_off[3], st)) !=
      cudaSuccess)
    return e;
  if ((e = colsum<T>(gs + 16, 64, n, 1, B.csum, gb + b_off[2] + DH, st)) !=
      cudaSuccess)
    return e;

  // The small weight gradients dW = g^T act: the dir layer, alpha, heads.
  const T* feat = slab(stash, W_FEAT);
  if ((e = wgrad<T>(gd, DH, DH, feat, hp, hp, n, gw + w_off[W_DIR], hp,
                    B.wpart, sms, st)) != cudaSuccess)
    return e;
  if ((e = wgrad<T>(gs + 16, 64, 1, feat, hp, hp, n,
                    gw + w_off[W_DIR] + (long long)DH * hp, hp, B.wpart, sms,
                    st)) != cudaSuccess)
    return e;
  if ((e = wgrad<T>(gs, 64, NHEAD, stash_h, DH, DH, n, gw + w_off[W_HEAD], DH,
                    B.wpart, sms, st)) != cudaSuccess)
    return e;

  // The dirs gradient.
  wide_gdproj_kernel<T><<<blocks(rays * DH, 256), 256, 0, st>>>(
      B.ghf, rays, samples, per_ray, B.gdp);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int dchunks = (int)((rays + DIR_CHUNK - 1) / DIR_CHUNK);
  wide_dirs_partial_kernel<T><<<dchunks, DH, 0, st>>>(B.gdp, dirs, ld_dirs,
                                                      rays, B.dpart);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wide_dirs_reduce_kernel<<<blocks(DH * DIRS_LD, 256), 256, 0, st>>>(
      B.dpart, dchunks, gw + w_off[W_DIRS]);
  return cudaGetLastError();
}

}  // namespace

// The forward at a width above 512 (`hidden`: the padded width, a multiple
// of 64) on `stream`.  Device pointers as ddnerf_fused_mlp_fwd's (ipe
// [n, 96], dirs [n / samples, 27] and the pack in the compute dtype: bf16,
// or f32 with `f32` 1, w then the pack's TF32 planes; stash [9, n, hidden]
// and stash_h [n, 128] in stash mode, both null in render mode), and a
// workspace of ws_bytes (ddnerf_wide_fwd_workspace).  Returns a cudaError_t.
extern "C" int ddnerf_wide_fwd(const void* ipe, const void* dirs,
                               const void* w, const void* b, void* dproj,
                               void* out, void* stash, void* stash_h, void* ws,
                               long long ws_bytes, long long n, int samples,
                               int hidden, int depth_head, int f32,
                               const long long* w_off, const long long* b_off,
                               void* stream) {
  if (n <= 0 || samples <= 0 || n % samples || !wide_width(hidden))
    return cudaErrorInvalidValue;
  if ((stash == nullptr) != (stash_h == nullptr) || ws == nullptr)
    return cudaErrorInvalidValue;
  size_t bytes = (size_t)ws_bytes;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return run_fwd<float>(
        static_cast<const float*>(ipe), nullptr, nullptr,
        static_cast<const float*>(dirs), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(dproj),
        static_cast<float*>(out), static_cast<float*>(stash),
        static_cast<float*>(stash_h), ws, &bytes, n, samples, hidden,
        depth_head, w_off, b_off, st);
  return run_fwd<bf16>(
      static_cast<const bf16*>(ipe), nullptr, nullptr,
      static_cast<const bf16*>(dirs), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<float*>(dproj),
      static_cast<float*>(out), static_cast<bf16*>(stash),
      static_cast<bf16*>(stash_h), ws, &bytes, n, samples, hidden, depth_head,
      w_off, b_off, st);
}

// The same network fed the IPE it computes from means / covs [n, 3] f32
// (render only).  Returns a cudaError_t.
extern "C" int ddnerf_wide_enc_fwd(const void* means, const void* covs,
                                   const void* dirs, const void* w,
                                   const void* b, void* dproj, void* out,
                                   void* ws, long long ws_bytes, long long n,
                                   int samples, int hidden, int depth_head,
                                   int f32, const long long* w_off,
                                   const long long* b_off, void* stream) {
  if (n <= 0 || samples <= 0 || n % samples || !wide_width(hidden) ||
      ws == nullptr)
    return cudaErrorInvalidValue;
  size_t bytes = (size_t)ws_bytes;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(means);
  const float* c = static_cast<const float*>(covs);
  if (f32)
    return run_fwd<float>(
        nullptr, m, c, static_cast<const float*>(dirs),
        static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<float*>(dproj), static_cast<float*>(out), nullptr, nullptr,
        ws, &bytes, n, samples, hidden, depth_head, w_off, b_off, st);
  return run_fwd<bf16>(
      nullptr, m, c, static_cast<const bf16*>(dirs),
      static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<float*>(dproj), static_cast<float*>(out), nullptr, nullptr,
      ws, &bytes, n, samples, hidden, depth_head, w_off, b_off, st);
}

// Bytes of the forward's workspace (stash / enc: 1 for stash mode / the
// in-kernel IPE); -1 for arguments the forward refuses.
extern "C" long long ddnerf_wide_fwd_workspace(long long n, int hidden,
                                               int f32, int stash, int enc) {
  if (n <= 0 || !wide_width(hidden) || (stash && enc)) return -1;
  size_t bytes = 0;
  // A dummy stash pointer selects stash mode; nothing is dereferenced.
  void* s = stash ? reinterpret_cast<void*>(16) : nullptr;
  const float* m = enc ? reinterpret_cast<const float*>(16) : nullptr;
  if (f32)
    run_fwd<float>(nullptr, m, m, nullptr, nullptr, nullptr, nullptr, nullptr,
                   static_cast<float*>(s), static_cast<float*>(s), nullptr,
                   &bytes, n, 1, hidden, 0, nullptr, nullptr, nullptr);
  else
    run_fwd<bf16>(nullptr, m, m, nullptr, nullptr, nullptr, nullptr, nullptr,
                  static_cast<bf16*>(s), static_cast<bf16*>(s), nullptr,
                  &bytes, n, 1, hidden, 0, nullptr, nullptr, nullptr);
  return (long long)(bytes == 0 ? 256 : bytes);
}

extern "C" long long ddnerf_wide_bwd_workspace(long long n, int samples,
                                               int hidden, int f32) {
  if (n <= 0 || samples <= 0 || n % samples || !wide_width(hidden)) return -1;
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  size_t bytes = 0;
  if (f32)
    bwd_layout<float>(nullptr, &bytes, n, samples, hidden, sms);
  else
    bwd_layout<bf16>(nullptr, &bytes, n, samples, hidden, sms);
  return (long long)bytes;
}

// Parameter gradients at a width above 512 on `stream`: the arguments of
// ddnerf_fused_mlp_bwd (dirs [n / samples, 32] bf16 zero-padded, or
// [n / samples, 27] f32 with `f32` 1; w the pack, at f32 with its planes),
// a workspace of ddnerf_wide_bwd_workspace bytes.  gw / gb are written in
// the packed layouts of w / b.  Returns a cudaError_t.
extern "C" int ddnerf_wide_bwd(const void* ipe, const void* dirs,
                               const void* g, const void* stash,
                               const void* stash_h, const void* w, void* gw,
                               void* gb, void* ws, long long ws_bytes,
                               long long n, int samples, int hidden,
                               int depth_head, int per_ray, int f32,
                               const long long* w_off, const long long* b_off,
                               void* stream) {
  if (n <= 0 || samples <= 0 || n % samples || !wide_width(hidden) ||
      n > 0x7fffffffLL - 1024)
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return run_bwd<float>(
        static_cast<const float*>(ipe), static_cast<const float*>(dirs), DIRS,
        static_cast<const float*>(g), static_cast<const float*>(stash),
        static_cast<const float*>(stash_h), static_cast<const float*>(w),
        static_cast<float*>(gw), static_cast<float*>(gb), ws,
        (size_t)ws_bytes, n, samples, hidden, depth_head, per_ray, w_off,
        b_off, sms, st);
  return run_bwd<bf16>(
      static_cast<const bf16*>(ipe), static_cast<const bf16*>(dirs), DIRS_LD,
      static_cast<const float*>(g), static_cast<const bf16*>(stash),
      static_cast<const bf16*>(stash_h), static_cast<const bf16*>(w),
      static_cast<float*>(gw), static_cast<float*>(gb), ws, (size_t)ws_bytes,
      n, samples, hidden, depth_head, per_ray, w_off, b_off, sms, st);
}

// The TF32 planes of a float32 pack at a width above 512 (planes 1..4 of
// the buffer at w, plane 0 the packed weights).  Returns a cudaError_t.
extern "C" int ddnerf_wide_tf32_split(void* w, int hidden,
                                      const long long* w_off, void* stream) {
  if (!wide_width(hidden)) return cudaErrorInvalidValue;
  SplitParams p = {};
  p.plane = plane_floats(w_off);
  float* base = static_cast<float*>(w);
  p.w = base;
  p.big = base + p.plane;
  p.small = base + 2 * p.plane;
  p.big_t = base + 3 * p.plane;
  p.small_t = base + 4 * p.plane;
  for (int l = 0; l < NW; ++l) p.off[l] = w_off[l];
  p.off[NW] = p.plane;
  for (int l = 0; l < NW; ++l)
    p.rows[l] = l <= W_FEAT ? hidden : (l == W_DIR ? DHP : (l == W_HEAD ? NHEAD : DH));
  wide_tf32_split_kernel<<<blocks(p.plane, 256), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
