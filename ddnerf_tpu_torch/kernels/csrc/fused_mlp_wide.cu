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
// layers, in buffers the wrapper allocates: a layer at 1024 does 2 H^2 = 2.1
// MFLOP per row against 4 KB of activation traffic (512 FLOP/byte against
// the H100's ~295), so a layer-at-a-time plan stays bound by the tensor
// cores.  What bounds this simple plan is its tile: one warpgroup per
// 64 x 128 output tile asks ~21 multiply-adds of each byte it reads from
// L2, where the tensor cores need ~49 (measured at 11-16x the bound at
// 1024, PERF.md), and at float32 the weight gradients' operands, which
// TF32's K-major layout makes it scatter into their tiles.  Wider tiles of
// two warpgroups fed by TMA, a persistent grid and clusters that share the
// weight tiles are later work.
//
// Design:
// * wide_gemm_kernel: C[M, N] = A[M, K] B[N, K]^T for one 64 x 128 tile of
//   C per block (grid: N tiles fastest, so the blocks that share A's rows run
//   together and read them from L2; M tiles; K splits), an epilogue fused
//   into it.  A K range may be two segments (the skip layer's IPE and x4,
//   the dir layer's g_h and g_alpha); an operand is read row-major, or
//   transposed (the chain's weights, both operands of a weight gradient),
//   and rows and K past their extent read as zero.  Every K tile of 128
//   bytes a row (64 bf16, 32 f32) is stored in the 128-byte swizzle of
//   hopper_common.cuh, K-major, or at bf16 MN-major for a transposed
//   operand (16-byte chunks, no scatter), and multiplied by
//   wgmma.mma_async m64n128: bf16 x bf16 (wgmma_k16), or 3xTF32
//   (wgmma_tf32.cuh, K-major only) with B's big and small parts in two
//   tiles and A split in registers.  Two shared stages: the block's 128
//   threads load the next K tile while the products of this one run.  The weights' TF32 parts
//   come from the pack's planes, split once per pack (wide_tf32_split_kernel,
//   the arithmetic of fused_mlp_f32.cu's tf32_split_kernel; the chain reads
//   the transposed planes); at f32 a weight gradient's operands
//   (cotangents, activations) are transposed by a scatter as they are
//   loaded, and B is split there.
// * The tensor cores add with truncation (fused_mlp_f32.cu): each K tile's
//   products accumulate into a zeroed accumulator that is then added to the
//   running sum in f32, which starts at the bias.
// * Epilogues: a layer's activation (bias, relu, rounding); the dir layer
//   (+ dproj, h, alpha); the heads; a cotangent (relu mask from the stash,
//   the f32 value for the bias sums and the compute-dtype one for the next
//   product); a weight-gradient split's f32 partial.
// * Deterministic: no atomics.  The bias sums are column sums over row
//   chunks in row order, then over the chunks in order, both compensated
//   (Kahan) in f32; the weight gradients' K splits and the dirs gradient's
//   ray chunks are summed in order.  The same inputs give bitwise the same outputs, and stash mode
//   the outputs of render mode, B3 those of B1 fed the same IPE.
//
// Weight/bias packing: mma_common.cuh (kernels/fused_mlp.py::pack_weights).

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
constexpr long long MAX_M_TILES = 65535;  // grid.y

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

// One K range of an operand: element (r, k) at p[r * ld + k] (trans 0) or
// p[k * ld + r] (trans 1); k < kvalid is read, the rest is zero.  A float32
// B operand with plane > 0 reads its TF32 parts from the pack's planes,
// big at p + plane and small at p + 2 plane (same index); with plane 0 it is
// split as it is loaded.
struct Seg {
  const void* p;
  long long ld;
  int trans;
  int kvalid;
  long long plane;
};

// An operand of `rows` rows (r >= rows reads zero), K in up to two
// segments: segment 0 covers K tiles below kpad0 (Gemm), segment 1 the
// rest.
struct Operand {
  Seg s[2];
  long long rows;
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
  const void* mask;   // EPI_COT: the relu mask (compute dtype), or null
  long long ldm;
  const float* dproj; // EPI_DIR: [rays, 128]
  int samples;
  float* y;           // EPI_DIR / EPI_HEAD: the [N, out_dim] output
  int out_dim;
};

struct Gemm {
  Operand a, b;      // A: M rows, B: N rows
  long long m, n;    // the output's extent
  long long m_base;  // the first row of this launch's M tiles
  int kpad0;         // K extent of segment 0, a multiple of KT
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
// small parts into dst_small).  Row-major segments go a 16-byte chunk at a
// time; transposed ones read E consecutive rows of one k and scatter them.
template <typename T, int R, bool SPLIT>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          unsigned char* dst_small,
                                          const Operand& op, long long r0,
                                          int kt, int kpad0, int tid) {
  constexpr int KT = Elem<T>::KT, E = Elem<T>::E;
  const int s = kt * KT < kpad0 ? 0 : 1;
  const Seg& g = op.s[s];
  const int k0 = kt * KT - (s ? kpad0 : 0);
  const T* p = static_cast<const T*>(g.p);
  if (!g.trans) {
#pragma unroll 2
    for (int u = tid; u < R * 8; u += NTHREADS) {
      const int r = u >> 3, c = u & 7;
      const long long gr = r0 + r;
      const int k = k0 + c * E;
      const int left = g.kvalid - k;
      const int valid = gr < op.rows ? (left < 0 ? 0 : (left > E ? E : left)) : 0;
      const long long idx = gr * g.ld + k;
      const uint32_t off = swizzle128(r, c);
      if constexpr (SPLIT) {
        uint4 big, small;
        if (g.plane) {
          big = fetch(p + g.plane, idx, valid);
          small = fetch(p + 2 * g.plane, idx, valid);
        } else {
          split4(fetch(p, idx, valid), big, small);
        }
        *reinterpret_cast<uint4*>(dst + off) = big;
        *reinterpret_cast<uint4*>(dst_small + off) = small;
      } else {
        *reinterpret_cast<uint4*>(dst + off) = fetch(p, idx, valid);
      }
    }
  } else {
    constexpr int G = R / E;  // row groups of a tile column
    for (int u = tid; u < KT * G; u += NTHREADS) {
      const int kk = u / G, r = (u % G) * E;
      const int k = k0 + kk;
      const long long gr = r0 + r;
      const long long left = op.rows - gr;
      const int valid = k < g.kvalid ? (left < 0 ? 0 : (left > E ? E : (int)left)) : 0;
      const long long idx = (long long)k * g.ld + gr;
      uint4 v, v_small = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (SPLIT) {
        if (g.plane) {
          v = fetch(p + g.plane, idx, valid);
          v_small = fetch(p + 2 * g.plane, idx, valid);
        } else {
          split4(fetch(p, idx, valid), v, v_small);
        }
      } else {
        v = fetch(p, idx, valid);
      }
      const uint32_t in_chunk = (kk % E) * sizeof(T);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const uint32_t off = swizzle128(r + i, kk / E) + in_chunk;
        store_elem<T>(dst + off, v, i);
        if constexpr (SPLIT) store_elem<T>(dst_small + off, v_small, i);
      }
    }
  }
}

// A bf16 operand read transposed, as an MN-major tile: [64 k][64 r]
// blocks of 128-byte rows (what wgmma takes as an MN-major operand, and
// hopper_common.cuh's smem_desc_mn describes), a 16-byte chunk of 8
// consecutive rows of one k at a time, with no scatter.
constexpr uint32_t MN_BLOCK_BYTES = 64 * 128;

template <int R>
__device__ __forceinline__ void load_tile_mn(unsigned char* dst,
                                             const Operand& op, long long r0,
                                             int kt, int kpad0, int tid) {
  constexpr int KT = Elem<bf16>::KT, E = Elem<bf16>::E, G = R / E;
  const int s = kt * KT < kpad0 ? 0 : 1;
  const Seg& g = op.s[s];
  const int k0 = kt * KT - (s ? kpad0 : 0);
  const bf16* p = static_cast<const bf16*>(g.p);
#pragma unroll 2
  for (int u = tid; u < KT * G; u += NTHREADS) {
    const int kk = u / G, r = (u % G) * E;
    const int k = k0 + kk;
    const long long gr = r0 + r;
    const long long left = op.rows - gr;
    const int valid =
        k < g.kvalid ? (left < 0 ? 0 : (left > E ? E : (int)left)) : 0;
    *reinterpret_cast<uint4*>(dst + (r / 64) * MN_BLOCK_BYTES +
                              swizzle128(kk, (r % 64) / E)) =
        fetch(p, (long long)k * g.ld + gr, valid);
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

// The epilogue for the two rows (row, row + 8) and the columns this thread
// holds (8 j + 2 q, + 1 of the tile; wgmma_k16's accumulator layout).
template <typename T>
__device__ __forceinline__ void epilogue(const Epi& e, const float (&acc)[BN / 2],
                                         long long row, long long n0, int q,
                                         int z, long long m, long long n) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = row + 8 * h;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const long long c = n0 + 8 * j + 2 * q;
      if (c >= n) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const bool two = c + 1 < n;
      switch (e.kind) {
        case EPI_ACT:
          store2_act<T>(static_cast<T*>(e.out) + r * e.ldo + c, v0, v1,
                        e.relu != 0);
          break;
        case EPI_DIR:
          if (c < DH) {
            const float2 d = *reinterpret_cast<const float2*>(
                e.dproj + (r / e.samples) * DH + c);
            store2_act<T>(static_cast<T*>(e.out) + r * DH + c, v0 + d.x,
                          v1 + d.y, true);
          } else if (c == DH) {
            e.y[r * e.out_dim + 3] = v0;
          }
          break;
        case EPI_HEAD: {
          const float v[2] = {v0, v1};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const long long col = c + i;
            if (col < 3)
              e.y[r * e.out_dim + col] = v[i];
            else if (col < 5 && e.out_dim == 6)
              e.y[r * e.out_dim + col + 1] = v[i];
          }
          break;
        }
        case EPI_COT: {
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
          break;
        }
        case EPI_STORE: {
          float* o = e.out32 + z * e.split_stride + r * e.ldo32 + c;
          o[0] = v0;
          if (two) o[1] = v1;
          break;
        }
      }
    }
  }
}

// One K tile of both operands into stage `st` of the shared ring: A's and
// B's tiles (B's TF32 small parts after B's at float32).  MN: the bf16
// operand is read transposed into an MN-major tile.
template <typename T, int TA, int TB>
__device__ __forceinline__ void load_stage(unsigned char* st, const Gemm& p,
                                           long long m0, long long n0, int kt,
                                           int tid) {
  if constexpr (TA)
    load_tile_mn<BM>(st, p.a, m0, kt, p.kpad0, tid);
  else
    load_tile<T, BM, false>(st, nullptr, p.a, m0, kt, p.kpad0, tid);
  if constexpr (TB)
    load_tile_mn<BN>(st + A_BYTES, p.b, n0, kt, p.kpad0, tid);
  else
    load_tile<T, BN, IS_F32<T>>(st + A_BYTES, st + A_BYTES + B_BYTES, p.b,
                                n0, kt, p.kpad0, tid);
  fence_proxy_async();  // the stores above, before wgmma reads the tiles
}

template <typename T>
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES * (IS_F32<T> ? 2 : 1);

// TA / TB (bf16 only): 1 when the operand is read transposed, into an
// MN-major tile.  Two stages: the next K tile is loaded while the products
// of this one run.
template <typename T, int TA, int TB>
__global__ void __launch_bounds__(NTHREADS)
    wide_gemm_kernel(const __grid_constant__ Gemm p) {
  static_assert(!IS_F32<T> || (TA == 0 && TB == 0),
                "TF32 wgmma takes K-major operands only");
  extern __shared__ unsigned char smem_raw[];
  // Tiles start on a 1024-byte boundary (the 128-byte swizzle's period).
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const long long m0 = p.m_base + (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  const int kt0 = blockIdx.z * p.kt_split;
  const int kt1 = kt0 + p.kt_split < p.ktiles ? kt0 + p.kt_split : p.ktiles;

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long col = n0 + 8 * j + 2 * q + e;
      const float bv =
          p.e.bias != nullptr && col < p.e.nbias ? p.e.bias[col] : 0.f;
      acc[4 * j + e] = acc[4 * j + 2 + e] = bv;
    }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;

  if (kt0 < kt1) load_stage<T, TA, TB>(sm, p, m0, n0, kt0, tid);
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
        wgmma_k16<BN, TA, TB>(
            part,
            TA ? smem_desc_mn(sa + kk * 2048, MN_BLOCK_BYTES)
               : smem_desc(sa + kk * 32),
            TB ? smem_desc_mn(sb + kk * 2048, MN_BLOCK_BYTES)
               : smem_desc(sb + kk * 32));
    }
    wgmma_commit();
    // The next K tile into the other stage while the products run: that
    // stage's products finished before the barrier that ended the last
    // iteration.
    if (kt + 1 < kt1)
      load_stage<T, TA, TB>(sm + (STAGE_BYTES<T> ^ st), p, m0, n0, kt + 1,
                            tid);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    __syncthreads();  // this stage is free, the next one loaded
  }
  epilogue<T>(p.e, acc, m0 + 16 * warp + g, n0, q, blockIdx.z, p.m, p.n);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One instantiation's launches of at most MAX_M_TILES row tiles each.
template <typename T, int TA, int TB>
cudaError_t launch_gemm(Gemm p, int splits, cudaStream_t st) {
  constexpr size_t smem = 1024 + 2 * STAGE_BYTES<T>;
  // The opt-in above 48 KB: once per process and instantiation.
  static const cudaError_t setup = cudaFuncSetAttribute(
      wide_gemm_kernel<T, TA, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (setup != cudaSuccess) return setup;
  const long long mt = (p.m + BM - 1) / BM;
  for (long long t0 = 0; t0 < mt; t0 += MAX_M_TILES) {
    const long long here = mt - t0 < MAX_M_TILES ? mt - t0 : MAX_M_TILES;
    p.m_base = t0 * BM;
    const dim3 grid((unsigned)((p.n + BN - 1) / BN), (unsigned)here,
                    (unsigned)splits);
    wide_gemm_kernel<T, TA, TB><<<grid, NTHREADS, smem, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// One GEMM on `st` with `splits` K splits (p.kt_split set here).  Every
// segment of an operand must be read the same way; at bf16 a transposed
// operand takes the MN-major tiles, at float32 (K-major only) the scatter.
template <typename T>
cudaError_t gemm(Gemm p, int splits, cudaStream_t st) {
  int trans[2] = {p.a.s[0].trans, p.b.s[0].trans};
  const Operand* ops[2] = {&p.a, &p.b};
  for (int o = 0; o < 2; ++o)
    for (const Seg& s : ops[o]->s) {
      if (s.p == nullptr) continue;
      if (!aligned16(s.p) || s.trans != trans[o])
        return cudaErrorInvalidValue;
    }
  p.kt_split = (p.ktiles + splits - 1) / splits;
  splits = (p.ktiles + p.kt_split - 1) / p.kt_split;
  if constexpr (IS_F32<T>) {
    return launch_gemm<T, 0, 0>(p, splits, st);
  } else {
    if (trans[0] && trans[1]) return launch_gemm<T, 1, 1>(p, splits, st);
    if (trans[1]) return launch_gemm<T, 0, 1>(p, splits, st);
    if (trans[0]) return cudaErrorInvalidValue;  // no product takes it
    return launch_gemm<T, 0, 0>(p, splits, st);
  }
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
// in the compute dtype.
__device__ __forceinline__ float wrap_trig(float y) {
  constexpr float T = 314.159265358979323846f;  // (float)(100 pi)
  if (fabsf(y) < T) return y;
  float m = fmodf(y, T);
  if (m < 0.f) m += T;
  return m;
}

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
  wide_dir_proj_kernel<T><<<blocks(rays, DIR_RAYS), DH, 0, st>>>(
      dirs, w + w_off[W_DIRS], dproj, rays);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
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
  const int ipe_pad = round_up(IPE, KT);
  for (int l = 0; l <= W_FEAT; ++l) {
    Gemm p = {};
    p.m = n;
    p.n = hp;
    p.a.rows = n;
    p.b.rows = hp;
    const long long kin = l == 0 ? IPE : (l == SKIP ? IPE + hp : hp);
    const T* wl = w + w_off[l];
    if (l == 0 || l == SKIP) {
      p.a.s[0] = {ipe, IPE, 0, IPE, 0};
      p.b.s[0] = {wl, kin, 0, IPE, plane};
      p.kpad0 = ipe_pad;
      p.ktiles = ipe_pad / KT;
      if (l == SKIP) {
        p.a.s[1] = {slab(SKIP - 1), hp, 0, hp, 0};
        p.b.s[1] = {wl + IPE, kin, 0, hp, plane};
        p.ktiles += hp / KT;
      }
    } else {
      p.a.s[0] = {slab(l - 1), hp, 0, hp, 0};
      p.b.s[0] = {wl, kin, 0, hp, plane};
      p.kpad0 = hp;
      p.ktiles = hp / KT;
    }
    p.e.kind = EPI_ACT;
    p.e.bias = b + (l < NTRUNK ? b_off[0] + (long long)l * hp : b_off[1]);
    p.e.nbias = hp;
    p.e.relu = l < NTRUNK;
    p.e.out = slab(l);
    p.e.ldo = hp;
    if ((e = gemm<T>(p, 1, st)) != cudaSuccess) return e;
  }
  {  // the dir layer (+ alpha): h and out[:, 3]
    Gemm p = {};
    p.m = n;
    p.n = DHP;
    p.a.rows = n;
    p.b.rows = DHP;
    p.a.s[0] = {slab(W_FEAT), hp, 0, hp, 0};
    p.b.s[0] = {w + w_off[W_DIR], hp, 0, hp, plane};
    p.kpad0 = hp;
    p.ktiles = hp / KT;
    p.e.kind = EPI_DIR;
    p.e.bias = b + b_off[2];
    p.e.nbias = DHP;
    p.e.out = hbuf;
    p.e.dproj = dproj;
    p.e.samples = samples;
    p.e.y = out;
    p.e.out_dim = depth_head ? 6 : 4;
    if ((e = gemm<T>(p, 1, st)) != cudaSuccess) return e;
  }
  {  // the heads
    Gemm p = {};
    p.m = n;
    p.n = NHEAD;
    p.a.rows = n;
    p.b.rows = NHEAD;
    p.a.s[0] = {hbuf, DH, 0, DH, 0};
    p.b.s[0] = {w + w_off[W_HEAD], DH, 0, DH, plane};
    p.kpad0 = DH;
    p.ktiles = DH / KT;
    p.e.kind = EPI_HEAD;
    p.e.bias = b + b_off[3];
    p.e.nbias = NHEAD;
    p.e.y = out;
    p.e.out_dim = depth_head ? 6 : 4;
    if ((e = gemm<T>(p, 1, st)) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// K splits of a weight gradient [M, N] over `ktiles` row tiles: about two
// blocks per SM in all.
int wgrad_splits(long long M, long long N, int ktiles, int sms) {
  const long long tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  long long s = (2LL * sms + tiles - 1) / tiles;
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  if (s > ktiles) s = ktiles;
  return s < 1 ? 1 : (int)s;
}

// The widest weight gradient's partials, in floats.
long long wgrad_part_floats(long long n, int hp, int kt_rows, int sms) {
  const int ktiles = (int)((n + kt_rows - 1) / kt_rows);
  const long long shapes[5][2] = {
      {hp, hp}, {hp, IPE}, {DH, hp}, {1, hp}, {NHEAD, DH}};
  long long most = 0;
  for (const auto& s : shapes) {
    const long long f = wgrad_splits(s[0], s[1], ktiles, sms) * s[0] * s[1];
    if (f > most) most = f;
  }
  return most;
}

struct BwdBufs {
  void *gs, *gd;
  float* ghf;
  void* gt;
  float* g32;   // bf16 only: the unrounded cotangent of the last product
  float* csum;  // column-sum partials
  float* wpart; // weight-gradient split partials
  float* gdp;   // g_dproj [rays, 128]
  float* dpart; // dirs-gradient partials
};

// The backward's workspace: the cotangent slabs first, where
// chip_smoke.py::_b2_slabs reads them at bf16 (gs [n, 64], gd [n, 128] in
// the compute dtype, ghf [n, 128] f32, gt [9, n, Hp] in the compute dtype),
// then the scratch.
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
  b.g32 = IS_F32<T> ? nullptr : cv.take<float>((size_t)n * wide);
  b.csum = cv.take<float>((size_t)((n + CS_ROWS - 1) / CS_ROWS) * wide);
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

// dW [M, N] (row stride ldo, at out) = A^T B over the n rows: A [n, M] and
// B [n, N] read transposed (row strides lda, ldb), f32 sums of K-split
// partials in order.
template <typename T>
cudaError_t wgrad(const T* a, long long lda, long long M, const T* bsrc,
                  long long ldb, long long N, long long n, float* out,
                  long long ldo, float* wpart, int sms, cudaStream_t st) {
  constexpr int KT = Elem<T>::KT;
  Gemm p = {};
  p.m = M;
  p.n = N;
  p.a.rows = M;
  p.b.rows = N;
  p.a.s[0] = {a, lda, 1, (int)n, 0};
  p.b.s[0] = {bsrc, ldb, 1, (int)n, 0};
  p.kpad0 = round_up((int)n, KT);
  p.ktiles = p.kpad0 / KT;
  int splits = wgrad_splits(M, N, p.ktiles, sms);
  const int per = (p.ktiles + splits - 1) / splits;
  splits = (p.ktiles + per - 1) / per;
  p.e.kind = EPI_STORE;
  p.e.out32 = wpart;
  p.e.ldo32 = N;
  p.e.split_stride = M * N;
  cudaError_t e = gemm<T>(p, splits, st);
  if (e != cudaSuccess) return e;
  wide_split_reduce_kernel<<<blocks(M * N, 256), 256, 0, st>>>(
      wpart, splits, M, N, out, ldo);
  return cudaGetLastError();
}

// The backward: the cotangent chain, the bias sums, the weight gradients
// and the dirs gradient, in that order on `st`.
template <typename T>
cudaError_t run_bwd(const T* ipe, const T* dirs, int ld_dirs, const float* g,
                    const T* stash, const T* stash_h, const T* w, float* gw,
                    float* gb, void* ws, size_t ws_bytes, long long n,
                    int samples, int hp, int depth_head, int per_ray,
                    const long long* w_off, const long long* b_off, int sms,
                    cudaStream_t st) {
  constexpr int KT = Elem<T>::KT;
  const long long plane = IS_F32<T> ? plane_floats(w_off) : 0;
  size_t need = 0;
  BwdBufs B = bwd_layout<T>(ws, &need, n, samples, hp, sms);
  if (need > ws_bytes) return cudaErrorInvalidValue;
  const long long rays = n / samples;
  T* gs = static_cast<T*>(B.gs);
  T* gd = static_cast<T*>(B.gd);
  T* gt = static_cast<T*>(B.gt);
  auto slab = [&](T* base, int l) { return base + (long long)l * n * hp; };
  const T* x = stash;
  // The chain's B operand: element (j, k) = W_l[row0 + k][col0 + j], the
  // layer's weights read transposed.  bf16: from the pack, MN-major;
  // float32: from the pack's transposed TF32 planes, K-major (at 2 plane +
  // the offset, so that the planes sit at +plane and +2 plane).
  auto w_t = [&](int l, long long row0, long long col0, int kvalid) -> Seg {
    const long long rows = l <= W_FEAT ? hp : (l == W_DIR ? DHP : NHEAD);
    const long long kin = l == 0 ? IPE : (l == SKIP ? IPE + hp :
                                          (l == W_HEAD ? DH : hp));
    if constexpr (IS_F32<T>)
      return {w + 2 * plane + w_off[l] + col0 * rows + row0, rows, 0, kvalid,
              plane};
    else
      return {w + w_off[l] + row0 * kin + col0, kin, 1, kvalid, 0};
  };
  cudaError_t e = cudaMemsetAsync(gw, 0, plane_floats(w_off) * sizeof(float), st);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(gb, 0, (b_off[3] + NHEAD) * sizeof(float), st);
  if (e != cudaSuccess) return e;
  wide_entry_kernel<T><<<blocks(n * 64, 256), 256, 0, st>>>(
      g, n, depth_head ? 6 : 4, gs);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  // The cotangent of a product, its relu mask, and where it goes.
  auto cot = [&](Gemm& p, const T* mask, long long ldm, T* out,
                 long long ldo, float* out32) {
    p.e.kind = EPI_COT;
    p.e.mask = mask;
    p.e.ldm = ldm;
    p.e.out = out;
    p.e.ldo = ldo;
    p.e.out32 = out32;
    p.e.ldo32 = ldo;
    return gemm<T>(p, 1, st);
  };
  {  // g_h = mask(h > 0, g_heads W_heads)
    Gemm p = {};
    p.m = n;
    p.n = DH;
    p.a.rows = n;
    p.b.rows = DH;
    p.a.s[0] = {gs, 64, 0, NHEAD, 0};
    p.b.s[0] = w_t(W_HEAD, 0, 0, NHEAD);
    p.kpad0 = KT;
    p.ktiles = 1;
    if ((e = cot(p, stash_h, DH, gd, DH, B.ghf)) != cudaSuccess) return e;
  }
  {  // g_feat = bf16(g_h) Wd_feat + g_alpha w_alpha
    Gemm p = {};
    p.m = n;
    p.n = hp;
    p.a.rows = n;
    p.b.rows = hp;
    p.a.s[0] = {gd, DH, 0, DH, 0};
    p.a.s[1] = {gs + 16, 64, 0, 1, 0};
    p.b.s[0] = w_t(W_DIR, 0, 0, DH);
    p.b.s[1] = w_t(W_DIR, DH, 0, 1);
    p.kpad0 = DH;
    p.ktiles = DH / KT + 1;
    float* o32 = IS_F32<T> ? nullptr : B.g32;
    if ((e = cot(p, nullptr, 0, slab(gt, W_FEAT), hp, o32)) != cudaSuccess)
      return e;
    if (IS_F32<T>)
      e = colsum<T>(slab(gt, W_FEAT), hp, n, hp, B.csum, gb + b_off[1], st);
    else
      e = colsum<float>(B.g32, hp, n, hp, B.csum, gb + b_off[1], st);
    if (e != cudaSuccess) return e;
  }
  // The trunk: g_i = mask(x_i > 0, bf16(g_{i+1}) W_{i+1}), g_7 from g_feat
  // and fc_feat; the skip layer's x columns.
  for (int i = NTRUNK - 1; i >= 0; --i) {
    const int l = i == NTRUNK - 1 ? W_FEAT : i + 1;
    Gemm p = {};
    p.m = n;
    p.n = hp;
    p.a.rows = n;
    p.b.rows = hp;
    p.a.s[0] = {slab(gt, i + 1 == NTRUNK ? W_FEAT : i + 1), hp, 0, hp, 0};
    p.b.s[0] = w_t(l, 0, l == SKIP ? IPE : 0, hp);
    p.kpad0 = hp;
    p.ktiles = hp / KT;
    float* o32 = IS_F32<T> ? nullptr : B.g32;
    if ((e = cot(p, slab(const_cast<T*>(x), i), hp, slab(gt, i), hp, o32)) !=
        cudaSuccess)
      return e;
    if (IS_F32<T>)
      e = colsum<T>(slab(gt, i), hp, n, hp, B.csum,
                    gb + b_off[0] + (long long)i * hp, st);
    else
      e = colsum<float>(B.g32, hp, n, hp, B.csum,
                        gb + b_off[0] + (long long)i * hp, st);
    if (e != cudaSuccess) return e;
  }
  // The heads' and alpha's biases (sums of the entry tile) and the dir
  // layer's (sums of g_h before its rounding).
  if ((e = colsum<T>(gs, 64, n, NHEAD, B.csum, gb + b_off[3], st)) !=
      cudaSuccess)
    return e;
  if ((e = colsum<T>(gs + 16, 64, n, 1, B.csum, gb + b_off[2] + DH, st)) !=
      cudaSuccess)
    return e;
  if ((e = colsum<float>(B.ghf, DH, n, DH, B.csum, gb + b_off[2], st)) !=
      cudaSuccess)
    return e;

  // The weight gradients dW = g^T act.
  for (int i = 0; i < NTRUNK; ++i) {
    const long long kin = i == 0 ? IPE : (i == SKIP ? IPE + hp : hp);
    float* o = gw + w_off[i];
    if (i == 0 || i == SKIP) {
      e = wgrad<T>(slab(gt, i), hp, hp, ipe, IPE, IPE, n, o, kin, B.wpart,
                   sms, st);
      if (e != cudaSuccess) return e;
    }
    if (i != 0) {
      e = wgrad<T>(slab(gt, i), hp, hp, slab(const_cast<T*>(x), i - 1), hp,
                   hp, n, o + (i == SKIP ? IPE : 0), kin, B.wpart, sms, st);
      if (e != cudaSuccess) return e;
    }
  }
  const T* feat = slab(const_cast<T*>(x), W_FEAT);
  if ((e = wgrad<T>(slab(gt, W_FEAT), hp, hp, slab(const_cast<T*>(x), NTRUNK - 1),
                    hp, hp, n, gw + w_off[W_FEAT], hp, B.wpart, sms, st)) !=
      cudaSuccess)
    return e;
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
