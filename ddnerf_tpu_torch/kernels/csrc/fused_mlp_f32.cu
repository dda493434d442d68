// Fused NeRF MLP in float32 for Hopper (sm_90a): the forward (render mode,
// stash mode and the in-kernel IPE) and the backward of fused_mlp_fwd.cu /
// fused_mlp_bwd.cu at compute dtype float32, where nothing is rounded.
//
// Replaces the TPU kernels' float32 instantiation (compute_dtype=f32):
//   ddnerf_tpu/kernels/fused_mlp.py::fused_mlp_forward (render and stash=True)
//     -> float_fwd_kernel<H, false>
//   ddnerf_tpu/kernels/fused_mlp.py::fused_enc_mlp_forward
//     -> float_fwd_kernel<H, true>
//   ddnerf_tpu/kernels/fused_mlp_bwd.py::fused_mlp_backward (and the custom
//     VJP fused_mlp_train_apply) -> float_chain_kernel<H>, float_wgrad_kernel
//     and the fixed-order reductions below.
// What it computes is the bf16 kernels' network (see the tops of
// fused_mlp_fwd.cu and fused_mlp_bwd.cu) with every operand, activation,
// stash slab and cotangent in float32: matmul operands are f32, products
// and sums f32, the relu masks come from the f32 activations, the dirs and
// the IPE (computed in the kernel in ENC mode) stay f32.  The stash is
// [9, N, H] + h [N, 128] f32.  The two kernel_per_ray_dirs settings are the
// same sum at f32 (nothing to round between the samples of a ray): the dirs
// weight gradient takes g_dproj[ray] = the f32 sum of g_h over the ray's
// rows in row order, then dirs^T g_dproj, for both.
//
// The products are 3xTF32 on the tensor cores: every f32 operand x is split
// as big = tf32(x) (cvt.rna, ties away from zero) and small = tf32(x - big)
// (x - big is exact in f32), and a product is small*big + big*small +
// big*big accumulated in f32 (the small*small term is below f32's
// rounding): about f32 accuracy at a third of the TF32 rate, 495 / 3 = 165
// TFLOP/s dense on an H100 SXM.  Compiled with -DDDNERF_F32_ONE_PASS the
// kernels take the big*big term alone (single-pass TF32): the fault
// chip_smoke.py reads to show that its limits separate the two.
//
// What bounds each kernel on this card.  A row costs 8 H^2 + 321 H + 640
// multiply-adds (~0.61 M at width 256): at 165 TFLOP/s the forward is
// bound by the operations (3.9 ms per 524,288 rows at 256); stash mode adds
// 4 (9 H + 128) bytes of writes per row.  The backward is twice the
// operations plus the cotangent slabs the chain writes and the weight
// gradients read.  Every tile reads all of a network's weights from L2 as
// two TF32 planes: 8 bytes per multiply-add of a row over the tile's rows,
// 38 KB per row in 128-row tiles at 256 (20 GB per B1 call of 524,288
// rows), 283 KB per row in 64-row tiles at 512.
//
// The design, against what held the first (mma.sync) design back:
// * The split happens once per pack, not once per warp: tf32_split_kernel
//   turns the packed f32 weights into four planes beside them (big, small,
//   and both with each matrix transposed to [in, out]) when the pack is
//   made (kernels/fused_mlp.py::with_tf32_planes; inside a captured graph,
//   at every step).  Two planes stream twice the bytes of one f32 plane;
//   splitting a streamed slice in shared memory per CTA would cost a
//   warpgroup's instructions and a shared-memory pass per slice instead.
// * Every product is wgmma.mma_async m64nNk8 .tf32 (wgmma_tf32.cuh), three
//   per k8 step (small*big, big*small, big*big).  TF32 takes K-major
//   operands only: B (the weights) is a K-major shared tile by descriptor,
//   the [out, in] planes for the forward and the transposed [in, out] ones
//   for the chain.  A (the activations, the cotangents) comes from
//   registers, loaded from an f32 tile and split once per k8 step per
//   warpgroup for the whole N of the product.
// * Weights stream as [n_out, 8] slices of both planes, one TMA box each
//   (two above 256 rows), 32-byte rows under TMA's 32-byte swizzle, through
//   a ring of up to 16 stages with a full and an empty mbarrier each, kept
//   in flight by one producer thread across layer and tile boundaries.
// * Persistent CTAs (one per SM) of three warpgroups: the producer and two
//   consumers of 64 rows.  Up to width 256: 128-row tiles, consumer w owns
//   rows 64 w .. 64 w + 63, and a warp multiplies and rewrites only its own
//   16 rows, so no barrier is needed between products.  At 384 and 512 (the
//   N-split plan of the bf16 kernels) a tile is 64 rows and consumer w
//   computes half of every product's columns, meeting the other consumer
//   before and after a write-back.
// * Activation and cotangent tiles are f32 [rows, 32]-column blocks of
//   128-byte rows under TMA's 128-byte swizzle (the IPE tile comes by TMA in
//   that layout, the stash leaves by TMA stores from it); a warp's
//   A-fragment loads hit 32 distinct banks.
// * The tensor cores add with truncation.  A forward layer accumulates
//   straight into the wgmma accumulator from the bias (readings <= 6.3e-6
//   of the 1e-5 limit).  The chain's cotangents pass through ten products,
//   and one accumulator per product read above the limit: the chain takes
//   zeroed partials of CHUNK k8 steps (wgmma's scale-d = 0) added in f32, so
//   a consumer holds two accumulators and takes its columns in passes of 128
//   at widths 128 and 256 (64 at the others), in the registers that
//   setmaxnreg moves from the producer warpgroup.  A pass before the last keeps its results in
//   an L2-resident scratch until the write-back.  The weight gradients sum
//   ~10^4 rows in 32-row partials the same way.
// * The chain writes its cotangent slabs transposed ([columns, rows]) and
//   already split: the weight gradients dW^T [in, out] = act^T g take B = g
//   K-major along the rows by TMA, and A = act^T from the stash through TMA
//   tiles of [32 rows, 128 in] into registers; the result goes back to the
//   [out, in] layout of the packed gradients.
// * The bias gradients stay f32 sums on the CUDA cores in a fixed order: a
//   partial row per 64 rows (the heads' and alpha's columns summed row
//   after row, bitwise as before), then float_bias_reduce_kernel.  The
//   splits of the weight gradients are summed in a fixed order: B2 is
//   bitwise repeatable.

#include "hopper_common.cuh"
#include "wgmma_tf32.cuh"

#include <type_traits>

namespace {

using namespace ddnerf;

constexpr int WG_ROWS = 64;        // rows of one wgmma (m64)
constexpr int NTHREADS = 384;      // producer warpgroup + 2 consumer warpgroups
constexpr int NENCODERS = 96;      // ENC mode: warps 1..3 of the producer warpgroup
constexpr int KS = 8;              // k depth of a streamed weight slice
constexpr int SLICE_ROW = KS * 4;  // its row: 32 bytes
constexpr int MAX_STAGES = 16;
constexpr int L_FEAT = W_FEAT, L_DIR = W_DIR, L_HEAD = W_HEAD, NLAYER = 11;
constexpr int MAX_BOX_ROWS = 256;  // TMA's largest box dimension
constexpr int BAR_BYTES = 512;

// ------------------------------------------------------------------ 3xTF32

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 values (the part of x below small's last bit
// is lost: 2^-22 of x at most).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// A fragment of an m64 k8 product (wgmma_tf32.cuh's layout), split.
struct AFrag {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
};

// d (+)= a b in 3xTF32 (the big*big term alone under DDNERF_F32_ONE_PASS);
// `acc` 0: the first product overwrites d.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const AFrag& a,
                                     uint64_t b_big, uint64_t b_small,
                                     int acc = 1) {
#ifndef DDNERF_F32_ONE_PASS
  wgmma_tf32<N>(d, a.small, b_big, acc);
  wgmma_tf32<N>(d, a.big, b_small, 1);
  wgmma_tf32<N>(d, a.big, b_big, 1);
#else
  wgmma_tf32<N>(d, a.big, b_big, acc);
#endif
}

// Byte offset of element (r, c) of an f32 tile of `rows` rows stored as
// [rows, 32]-column blocks of 128-byte rows with the 128-byte swizzle (16-byte
// chunk j of row r at chunk j ^ (r % 8)): TMA's CU_TENSOR_MAP_SWIZZLE_128B
// layout of a box 32 f32 wide.
__device__ __forceinline__ uint32_t tile_off(int rows, int r, int c) {
  return (uint32_t)((c >> 5) * rows * 128 + r * 128 +
                    ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

// Shared-memory accesses by 32-bit address (one register, not a generic
// pointer's two).
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void sts2(uint32_t addr, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(v.x), "f"(v.y) : "memory");
}

// The warp's A fragment of k8 step k0 .. k0 + 7 of a row-major tile at
// shared address `tile`: its rows r, r + 8 (r = its first row + g),
// columns k0 + t, k0 + t + 4.
__device__ __forceinline__ void load_a(AFrag& f, uint32_t tile, int rows,
                                       int r, int k0, int t) {
  f.set(lds(tile + tile_off(rows, r, k0 + t)),
        lds(tile + tile_off(rows, r + 8, k0 + t)),
        lds(tile + tile_off(rows, r, k0 + t + 4)),
        lds(tile + tile_off(rows, r + 8, k0 + t + 4)));
}

// Sum over the 8 row groups g = lane / 4 of a warp.
__device__ __forceinline__ float sum_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__host__ __device__ constexpr uint32_t round1024(uint32_t x) {
  return (x + 1023u) / 1024u * 1024u;
}

// The ring depth shared memory leaves beside `fixed` bytes.
__host__ __device__ constexpr int ring_stages(size_t fixed, uint32_t stage) {
  return (MAX_SMEM - fixed) / stage > MAX_STAGES
             ? MAX_STAGES
             : (int)((MAX_SMEM - fixed) / stage);
}

// A layer's shape in the packed layout (mma_common.cuh): rows (outputs)
// and columns (inputs) of matrix l at width H.
__host__ __device__ constexpr int mat_rows(int l, int H) {
  return l <= L_FEAT ? H : (l == L_DIR ? DHP : (l == L_HEAD ? NHEAD : DH));
}
__host__ __device__ constexpr int mat_cols(int l, int H) {
  return l == 0 ? IPE
                : (l == SKIP ? IPE + H
                             : (l == L_HEAD ? DH : (l == W_DIRS ? DIRS_LD : H)));
}

// Barriers among the consumers: 1 + w, warpgroup w's 128 threads; 3 + i,
// warp i of each consumer (64 threads).
__device__ __forceinline__ void wg_bar(int wg) { named_bar_sync(1 + wg, 128); }
__device__ __forceinline__ void pair_bar(int warp) {
  named_bar_sync(3 + warp, 64);
}

// --------------------------------------------------------------- the split

struct SplitParams {
  const float* w;  // the f32 pack (plane 0)
  float* big;      // planes 1..4, each `plane` floats
  float* small;
  float* big_t;
  float* small_t;
  long long plane;
  long long off[NW + 1];  // matrix offsets, then the plane's end
  int rows[NW];
};

// Every packed weight into its TF32 big and small parts, in place and
// transposed (matrix l [rows, cols] -> [cols, rows] at the same offset).
__global__ void tf32_split_kernel(const __grid_constant__ SplitParams p) {
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

// ---------------------------------------------------------------- forward

struct FMaps {
  CUtensorMap wb[NLAYER];  // layer l's big plane [n_out, k_in], box [KS, rows]
  CUtensorMap ws[NLAYER];  // its small plane
  CUtensorMap ipe;         // [n, 96], box [32, BM]
  CUtensorMap stash;       // [9, n, H], box [32, 16, 1]
  CUtensorMap stash_h;     // [n, 128], box [32, 16]
};

struct FParams {
  const float* means;  // [n, 3]; ENC mode only
  const float* covs;   // [n, 3]; ENC mode only
  const float* b;      // packed biases
  const float* dproj;  // [n / samples, 128]
  float* out;          // [n, out_dim]
  long long n;
  int samples;
  int out_dim;
  int stash;           // 1: store the activations through the stash maps
  long long b_off[NB_OFF];
};

template <int H>
struct FShape {
  static_assert(H % 64 == 0 && H <= 512, "no float32 forward plan");
  static constexpr bool SPLIT = H > 256;  // the N-split plan
  static constexpr int BM = SPLIT ? WG_ROWS : 2 * WG_ROWS;
  static constexpr int NW = SPLIT ? H / 2 : H;  // trunk columns per consumer
  static constexpr int ACT_W = H > DH ? H : DH;  // the trunk, later h
  static constexpr uint32_t ACT_BYTES = ACT_W * BM * 4;
  static constexpr uint32_t IPE_BYTES = IPE * BM * 4;
  static constexpr int MAXN = H > DHP ? H : DHP;
  static constexpr uint32_t PLANE_BYTES = round1024(MAXN * SLICE_ROW);
  static constexpr uint32_t STAGE_BYTES = 2 * PLANE_BYTES;
  // 1024 spare bytes to start the tiles on a 1024-byte boundary.
  static constexpr size_t FIXED = 1024 + ACT_BYTES + IPE_BYTES + BAR_BYTES;
  static constexpr int STAGES = ring_stages(FIXED, STAGE_BYTES);
  static_assert(STAGES >= 2, "the plan leaves no room for a weight ring");
  static constexpr size_t SMEM = FIXED + STAGES * STAGE_BYTES;
  __host__ __device__ static constexpr int nout(int l) { return mat_rows(l, H); }
  __host__ __device__ static constexpr int kin(int l) { return mat_cols(l, H); }
  __host__ __device__ static constexpr int boxes(int l) {
    return nout(l) > MAX_BOX_ROWS ? 2 : 1;
  }
  // Layer l's k8 steps: first those that meet the IPE tile.
  __host__ __device__ static constexpr int ipe_steps(int l) {
    return l == 0 || l == SKIP ? IPE / KS : 0;
  }
  __host__ __device__ static constexpr int steps(int l) { return kin(l) / KS; }
};

struct FSmem {
  uint32_t act, ipe, ring;                    // tiles
  uint32_t full, empty, ipe_full, ipe_empty;  // mbarriers
};

// ENC mode: the tile's IPE from the raw means and covariances, in the
// direct form of the TPU kernel's _enc_kernel and of core/math.py::
// integrated_pos_enc(double_angle=False), all in f32: for level l and
// coordinate j, y = x_j 2^l, v = cov_j 4^l (exact scalings),
//   ipe[l*3 + j] = exp(-v / 2) sin(wrap(y)),
//   ipe[48 + l*3 + j] = exp(-v / 2) sin(wrap(y + (float)(pi / 2))),
// wrap(y) = |y| < 100 pi ? y : floor-mod(y, 100 pi) (safe_sin's reduction,
// exact with fmodf; the accurate libdevice sinf / expf, no fast math).  An
// item is (row, coordinate, half of the levels); rows past n are zero.
// wrap is hopper_common.cuh's wrap_trig.
template <int BM>
__device__ __forceinline__ void encode_tile(const FParams& p,
                                            unsigned char* ipe, long long r0,
                                            int tid) {
  constexpr int HALF = IPE / 2;  // 16 levels x 3 coordinates
  constexpr int LPI = 8;         // levels per item
  constexpr float HALF_PI = 1.57079632679489661923f;
  auto at = [&](int r, int c) -> float& {
    return *reinterpret_cast<float*>(ipe + tile_off(BM, r, c));
  };
  for (int c = tid; c < BM * 3 * 2; c += NENCODERS) {
    const int l0 = c / (BM * 3) * LPI, rem = c % (BM * 3);
    const int r = rem / 3, j = rem % 3;
    const int col = l0 * 3 + j;
    if (r0 + r >= p.n) {
#pragma unroll
      for (int i = 0; i < LPI; ++i) at(r, col + i * 3) = at(r, HALF + col + i * 3) = 0.f;
      continue;
    }
    const float f = (float)(1 << l0);
    float y = p.means[(r0 + r) * 3 + j] * f;
    float v = p.covs[(r0 + r) * 3 + j] * (f * f);
#pragma unroll
    for (int i = 0; i < LPI; ++i) {
      const float att = expf(-0.5f * v);
      at(r, col + i * 3) = att * sinf(wrap_trig(y));
      at(r, HALF + col + i * 3) = att * sinf(wrap_trig(y + HALF_PI));
      y *= 2.f;
      v *= 4.f;
    }
  }
}

// The producer: every TMA load of this CTA's tiles, in the order the
// consumers use them, as far ahead as the ring (and the IPE tile) allow.
template <int H, bool ENC>
__device__ __forceinline__ void fwd_produce(const FMaps& maps, const FSmem& s,
                                            long long tiles) {
  using S = FShape<H>;
  uint32_t it = 0, round = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
    if (!ENC) {
      mbar_wait(s.ipe_empty, (round & 1) ^ 1);
      mbar_arrive_expect_tx(s.ipe_full, S::IPE_BYTES);
#pragma unroll
      for (int b = 0; b < IPE / 32; ++b)
        tma_load_2d(s.ipe + b * S::BM * 128, &maps.ipe, b * 32,
                    (int)(tile * S::BM), s.ipe_full);
    }
#pragma unroll 1
    for (int l = 0; l < NLAYER; ++l) {
      const int ni = S::ipe_steps(l), ns = S::steps(l);
      const int box_rows = S::nout(l) / S::boxes(l);
#pragma unroll 1
      for (int i = 0; i < ns; ++i, ++it) {
        const uint32_t stage = it % S::STAGES, parity = (it / S::STAGES) & 1;
        mbar_wait(s.empty + 8 * stage, parity ^ 1);
        const uint32_t full = s.full + 8 * stage;
        mbar_arrive_expect_tx(full, 2 * S::nout(l) * SLICE_ROW);
        const int col = i < ni ? i * KS : (l == SKIP ? IPE : 0) + (i - ni) * KS;
        const uint32_t dst = s.ring + stage * S::STAGE_BYTES;
        for (int b = 0; b < S::boxes(l); ++b) {
          tma_load_2d(dst + b * box_rows * SLICE_ROW, &maps.wb[l], col,
                      b * box_rows, full);
          tma_load_2d(dst + S::PLANE_BYTES + b * box_rows * SLICE_ROW,
                      &maps.ws[l], col, b * box_rows, full);
        }
      }
    }
  }
}

// ENC mode, one of the NENCODERS threads: every tile's IPE, as soon as the
// skip layer of the previous tile has read the IPE tile.
template <int H>
__device__ __forceinline__ void fwd_encode(const FParams& p, const FSmem& s,
                                           unsigned char* ipe,
                                           long long tiles, int tid) {
  using S = FShape<H>;
  uint32_t round = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
    mbar_wait(s.ipe_empty, (round & 1) ^ 1);
    encode_tile<S::BM>(p, ipe, tile * S::BM, tid);
    mbar_arrive(s.ipe_full);
  }
}

// acc = bias + A @ W_l^T for the warpgroup's 64 rows and the N outputs from
// the one whose weight row is at byte `w_rows` of a plane, over layer l's
// k8 steps as the ring delivers them.  A is read from the IPE tile, then
// the activation tile, and split in registers; two fragments alternate, so
// that a step's loads and split run under the previous step's products.  A
// stage is released (one arrival per warp) once its products have
// finished.
template <int H, int N>
__device__ __forceinline__ void fwd_products(float (&acc)[N / 2], int l,
                                             const float* bias, uint32_t& it,
                                             const FSmem& s, int arow,
                                             uint32_t w_rows, int lane) {
  using S = FShape<H>;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t);
    acc[4 * j] = acc[4 * j + 2] = bb.x;
    acc[4 * j + 1] = acc[4 * j + 3] = bb.y;
  }
  const int ni = S::ipe_steps(l), ns = S::steps(l);
  uint32_t prev = 0;
  AFrag a[2];
  auto step = [&](int i, AFrag& f) {
    const uint32_t stage = it % S::STAGES, parity = (it / S::STAGES) & 1;
    if (i < ni)
      load_a(f, s.ipe, S::BM, arow, i * KS, t);
    else
      load_a(f, s.act, S::BM, arow, (i - ni) * KS, t);
    mbar_wait(s.full + 8 * stage, parity);
    const uint32_t b = s.ring + stage * S::STAGE_BYTES + w_rows;
    wgmma_fence();
    mma3<N>(acc, f, smem_desc_k<32>(b), smem_desc_k<32>(b + S::PLANE_BYTES));
    wgmma_commit();
    if (i > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(s.empty + 8 * prev);
    }
    prev = stage;
    ++it;
  };
#pragma unroll 1
  for (int i = 0; i < ns; i += 2) {  // every layer has an even step count
    step(i, a[0]);
    step(i + 1, a[1]);
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(s.empty + 8 * prev);
}

template <int H, bool ENC>
__device__ __forceinline__ void fwd_consume(const FParams& p,
                                            const FMaps& maps, const FSmem& s,
                                            long long tiles, int wg, int tid) {
  using S = FShape<H>;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  // The narrow plan: this warpgroup's rows; the N-split plan: every row of
  // the tile and the trunk columns NW wg .. NW wg + NW - 1.
  const int row0 = S::SPLIT ? 0 : wg * WG_ROWS;
  const int col0 = S::SPLIT ? wg * S::NW : 0;
  const bool lead = !S::SPLIT || wg == 0;  // writes the dir layer and heads
  const int wrow = row0 + warp * 16;  // the warp's first row in the tile
  const int arow = wrow + g;          // the thread's rows: arow, arow + 8

  // The TMA stores of the warp's previous write-back have read the tile.
  auto stores_read = [&]() {
    if (p.stash) {
      if (lane == 0) bulk_wait_read();
      __syncwarp();
    }
  };
  // The warp's rows of activation blocks [blk0, blk1) to `map` (3D: slab l).
  auto store_rows = [&](const CUtensorMap* map, int blk0, int blk1, int l,
                        long long r) {
    fence_proxy_async();
    __syncwarp();
    if (lane == 0 && r < p.n) {
      for (int blk = blk0; blk < blk1; ++blk) {
        const uint32_t src = s.act + blk * S::BM * 128 + wrow * 128;
        if (l >= 0)
          tma_store_3d(map, src, blk * 32, (int)r, l);
        else
          tma_store_2d(map, src, blk * 32, (int)r);
      }
      bulk_commit();
    }
  };

  uint32_t it = 0, round = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
    const long long r0 = tile * S::BM;
    mbar_wait(s.ipe_full, round & 1);

    // Trunk and fc_feat: bias (+ relu) back into act, and into the stash.
    {
      float acc[S::NW / 2];
#pragma unroll 1
      for (int l = 0; l <= L_FEAT; ++l) {
        fwd_products<H, S::NW>(
            acc, l,
            p.b + (l < NTRUNK ? p.b_off[0] + l * H : p.b_off[1]) + col0, it,
            s, arow, col0 * SLICE_ROW, lane);
        if (l == SKIP && lane == 0) mbar_arrive(s.ipe_empty);
        stores_read();
        if (S::SPLIT) pair_bar(warp);  // the other consumer read the input
        const bool relu = l < NTRUNK;  // fc_feat has none
#pragma unroll
        for (int j = 0; j < S::NW / 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float2 v = make_float2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]);
            if (relu) v = make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
            sts2(s.act + tile_off(S::BM, arow + 8 * h2, col0 + j * 8 + 2 * q),
                 v);
          }
        if (p.stash)
          store_rows(&maps.stash, col0 / 32, (col0 + S::NW) / 32, l,
                     r0 + wrow);
        if (S::SPLIT) pair_bar(warp);  // published to the other consumer
      }
    }
    // The dir layer (alpha rides it as output column 128): h = relu(. +
    // dproj[ray]) back into act columns 0..127 and the stash; alpha to out.
    {
      float acc[DHP / 2];
      fwd_products<H, DHP>(acc, L_DIR, p.b + p.b_off[2], it, s, arow, 0,
                           lane);
      stores_read();
      if (S::SPLIT) pair_bar(warp);
      if (lead) {
        const long long grow[2] = {r0 + arow, r0 + arow + 8};
        // h into acc's first 128 columns (every dproj load before the
        // first shared store, whose asm orders memory), then into act.
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const bool valid = grow[h2] < p.n;
          const float* dp = p.dproj + (valid ? grow[h2] / p.samples : 0) * DH;
          if (q == 0 && valid)
            p.out[grow[h2] * p.out_dim + 3] = acc[4 * (DH / 8) + 2 * h2];
#pragma unroll
          for (int j = 0; j < DH / 8; ++j) {
            float2 h = make_float2(0.f, 0.f);
            if (valid) {
              const float2 d =
                  *reinterpret_cast<const float2*>(dp + j * 8 + 2 * q);
              h = make_float2(fmaxf(acc[4 * j + 2 * h2] + d.x, 0.f),
                              fmaxf(acc[4 * j + 2 * h2 + 1] + d.y, 0.f));
            }
            acc[4 * j + 2 * h2] = h.x;
            acc[4 * j + 2 * h2 + 1] = h.y;
          }
        }
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            sts2(s.act + tile_off(S::BM, arow + 8 * h2, j * 8 + 2 * q),
                 make_float2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]));
        if (p.stash) store_rows(&maps.stash_h, 0, DH / 32, -1, r0 + wrow);
      }
      if (S::SPLIT) pair_bar(warp);
    }
    // Heads: rgb -> out[:, 0:3], (mu, sigma) -> out[:, 4:6].
    {
      float acc[NHEAD / 2];
      fwd_products<H, NHEAD>(acc, L_HEAD, p.b + p.b_off[3], it, s, arow, 0,
                             lane);
      const long long grow[2] = {r0 + arow, r0 + arow + 8};
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        if (!lead || grow[h2] >= p.n) continue;
        float* o = p.out + grow[h2] * p.out_dim;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * 8 + 2 * q + e;
            const float v = acc[4 * j + 2 * h2 + e];
            if (col < 3)
              o[col] = v;
            else if (col < 5 && p.out_dim == 6)
              o[col + 1] = v;
          }
      }
    }
  }
  if (p.stash && lane == 0) bulk_wait();
}

template <int H, bool ENC>
__global__ void __launch_bounds__(NTHREADS, 1)
    float_fwd_kernel(const FParams p, const __grid_constant__ FMaps maps) {
  using S = FShape<H>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  FSmem s;
  s.act = base;
  s.ipe = s.act + S::ACT_BYTES;
  s.ring = s.ipe + S::IPE_BYTES;
  s.full = s.ring + S::STAGES * S::STAGE_BYTES;
  s.empty = s.full + 8 * MAX_STAGES;
  s.ipe_full = s.empty + 8 * MAX_STAGES;
  s.ipe_empty = s.ipe_full + 8;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(s.full + 8 * i, 1);   // the producer's arrive.expect_tx
      mbar_init(s.empty + 8 * i, 8);  // lane 0 of each consumer warp
    }
    mbar_init(s.ipe_full, ENC ? NENCODERS : 1);
    mbar_init(s.ipe_empty, 8);
    fence_mbar_init();
  }
  __syncthreads();

  const long long tiles = (p.n + S::BM - 1) / S::BM;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if (threadIdx.x == 0) fwd_produce<H, ENC>(maps, s, tiles);
    if constexpr (ENC) {
      if (threadIdx.x >= 128 - NENCODERS)
        fwd_encode<H>(p, s, smem + S::ACT_BYTES, tiles,
                      threadIdx.x - (128 - NENCODERS));
    }
  } else {
    fwd_consume<H, ENC>(p, maps, s, tiles, wg - 1, threadIdx.x - wg * 128);
  }
}

// dproj[r, c] = sum_j dirs[r, j] * Wd_dirs[c, j] in f32, once per ray; a
// block of DH threads takes DIR_RAYS rays, thread c keeping row c of
// Wd_dirs in registers.
constexpr int DIR_RAYS = 32;

__global__ void float_dir_proj_kernel(const float* dirs, const float* wdirs,
                                      float* dproj, long long rays) {
  __shared__ float d[DIR_RAYS * DIRS];
  const long long r0 = (long long)blockIdx.x * DIR_RAYS;
  const int c = threadIdx.x;
  const int here = (int)(rays - r0 < DIR_RAYS ? rays - r0 : DIR_RAYS);
  for (int i = c; i < here * DIRS; i += DH) d[i] = dirs[r0 * DIRS + i];
  float w[DIRS];
#pragma unroll
  for (int j = 0; j < DIRS; ++j) w[j] = wdirs[c * DIRS_LD + j];
  __syncthreads();
  for (int i = 0; i < here; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < DIRS; ++j) acc = fmaf(d[i * DIRS + j], w[j], acc);
    dproj[(r0 + i) * DH + c] = acc;
  }
}

// ---------------------------------------------------------- tensor maps

// An f32 tensor map of rank 2 or 3 (dims and box innermost first, strides
// in elements for every dimension but the innermost), `swizzle`,
// out-of-range elements read as zero and never written.
bool make_map_f32(CUtensorMap* map, const void* ptr, int rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t bytes[2] = {0, 0};
  for (int i = 0; i + 1 < rank; ++i) bytes[i] = strides[i] * sizeof(float);
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                const_cast<void*>(ptr), dims, bytes, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool map2(CUtensorMap* map, const void* ptr, cuuint64_t cols, cuuint64_t rows,
          cuuint64_t ld, cuuint32_t box_cols, cuuint32_t box_rows,
          CUtensorMapSwizzle sw) {
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {ld};
  const cuuint32_t box[2] = {box_cols, box_rows};
  return make_map_f32(map, ptr, 2, dims, strides, box, sw);
}

bool map3(CUtensorMap* map, const void* ptr, cuuint64_t cols, cuuint64_t rows,
          cuuint64_t slabs, cuuint64_t ld, cuuint32_t box_cols,
          cuuint32_t box_rows, CUtensorMapSwizzle sw) {
  const cuuint64_t dims[3] = {cols, rows, slabs}, strides[2] = {ld, ld * rows};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  return make_map_f32(map, ptr, 3, dims, strides, box, sw);
}

// The packed plane count and its planes (pointers into the pack buffer).
long long plane_floats(const long long* w_off) {
  return w_off[W_DIRS] + (long long)DH * DIRS_LD;
}

template <int H, bool ENC>
cudaError_t launch_fwd(const FParams& p, const float* w,
                       const long long* w_off, const float* ipe, float* stash,
                       float* stash_h, cudaStream_t st) {
  using S = FShape<H>;
  const long long plane = plane_floats(w_off);
  FMaps maps = {};
  bool ok = true;
  for (int l = 0; l < NLAYER; ++l) {
    const cuuint32_t rows = S::nout(l) / S::boxes(l);
    ok = ok && map2(&maps.wb[l], w + plane + w_off[l], S::kin(l), S::nout(l),
                    S::kin(l), KS, rows, CU_TENSOR_MAP_SWIZZLE_32B);
    ok = ok && map2(&maps.ws[l], w + 2 * plane + w_off[l], S::kin(l),
                    S::nout(l), S::kin(l), KS, rows, CU_TENSOR_MAP_SWIZZLE_32B);
  }
  const cuuint64_t n = (cuuint64_t)p.n;
  if (!ENC)
    ok = ok && map2(&maps.ipe, ipe, IPE, n, IPE, 32, S::BM,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (p.stash) {
    ok = ok && map3(&maps.stash, stash, H, n, NTRUNK + 1, H, 32, 16,
                    CU_TENSOR_MAP_SWIZZLE_128B);
    ok = ok && map2(&maps.stash_h, stash_h, DH, n, DH, 32, 16,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!ok) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  // The opt-in to S::SMEM bytes of dynamic shared memory: once per process
  // and instantiation, not per launch.
  static const cudaError_t setup = cudaFuncSetAttribute(
      float_fwd_kernel<H, ENC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM);
  if (setup != cudaSuccess) return setup;
  const long long tiles = (p.n + S::BM - 1) / S::BM;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  float_fwd_kernel<H, ENC><<<grid, NTHREADS, S::SMEM, st>>>(p, maps);
  return cudaGetLastError();
}

template <bool ENC>
cudaError_t run_fwd(FParams& p, const void* ipe, const void* dirs,
                    const void* w, void* stash, void* stash_h, int hidden,
                    const long long* w_off, const long long* b_off,
                    cudaStream_t st) {
  if (p.n > 0x7fffffffLL - 128) return cudaErrorInvalidValue;  // TMA: 32 bits
  for (int i = 0; i < NB_OFF; ++i) p.b_off[i] = b_off[i];
  const float* wp = static_cast<const float*>(w);
  const long long rays = p.n / p.samples;
  float_dir_proj_kernel<<<(unsigned)((rays + DIR_RAYS - 1) / DIR_RAYS), DH, 0,
                          st>>>(static_cast<const float*>(dirs),
                                wp + w_off[W_DIRS], const_cast<float*>(p.dproj),
                                rays);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const float* ip = static_cast<const float*>(ipe);
  float* sp = static_cast<float*>(stash);
  float* hp = static_cast<float*>(stash_h);
  switch (hidden) {
    case 64: return launch_fwd<64, ENC>(p, wp, w_off, ip, sp, hp, st);
    case 128: return launch_fwd<128, ENC>(p, wp, w_off, ip, sp, hp, st);
    case 192: return launch_fwd<192, ENC>(p, wp, w_off, ip, sp, hp, st);
    case 256: return launch_fwd<256, ENC>(p, wp, w_off, ip, sp, hp, st);
    case 384: return launch_fwd<384, ENC>(p, wp, w_off, ip, sp, hp, st);
    case 512: return launch_fwd<512, ENC>(p, wp, w_off, ip, sp, hp, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ chain

struct CMaps {
  CUtensorMap wb[NLAYER];  // layer l's transposed big plane [k_in, n_out]
  CUtensorMap ws[NLAYER];  // its small plane; box [KS, rows]
};

struct CParams {
  const float* g;        // [n, out_dim]
  const float* stash;    // [9, n, H]
  const float* stash_h;  // [n, 128]
  float* gtb;            // [9, H, ldt] g_0 .. g_7, g_feat: big, transposed
  float* gts;            //   and small
  float* gdb;            // [144, ldt] g_h | g_alpha | 0
  float* gds;
  float* gsb;            // [16, ldt] g_rgb | g_mu, g_sigma | 0
  float* gss;
  float* ghf;            // [n, 128] g_h
  float* bpart;          // [n / 64 rounded up, nb] bias-gradient partial rows
  float* scratch;        // per CTA: the passes a write-back waits for
  long long n, ldt;
  int out_dim;
  int nb;
  long long b_off[NB_OFF];
};

constexpr int NQ = 10;  // chain products: heads, dir, feat, W7..W1
constexpr int GS_W = NHEAD;
constexpr int CHUNK = 4;  // k8 steps per zeroed partial sum

// The chain's plan.  A product's sum is taken in zeroed partials of CHUNK
// k8 steps added in f32 (the tensor cores add with truncation, and the
// chain's cotangents pass through ten products; one accumulator per
// product read above the 1e-5 limit), so a consumer holds two accumulators
// and takes its columns in passes of NP columns.  A is loaded from the f32
// cotangent tile and split in registers.
// * Up to width 256 (NARROW) a tile is 128 rows and consumer w owns rows
//   64 w .. 64 w + 63 and every column: a warp reads and rewrites only its
//   own 16 rows, and every weight slice serves 128 rows.
// * At 384 and 512 a tile is 64 rows and consumer w computes columns NW w
//   .. NW w + NW - 1 of every product (of g_h, 64 w .. 64 w + 63); warp i
//   of each consumer meets warp i of the other before and after a
//   write-back.
// * A pass before the last keeps its results in an L2-resident scratch
//   until the write-back, since the product's input is its output's
//   place.
template <int H>
struct CShape {
  static_assert(H % 64 == 0 && H <= 512, "no float32 backward plan");
  static constexpr bool NARROW = H <= 256;
  static constexpr int BM = NARROW ? 2 * WG_ROWS : WG_ROWS;
  static constexpr int NW = NARROW ? H : H / 2;    // columns per consumer
  static constexpr int NH = NARROW ? DH : DH / 2;  // g_h columns per consumer
  // Columns per pass: 128 where the narrow plan's columns allow (two
  // 64-register accumulators, in the registers setmaxnreg gives a
  // consumer), else 64.
  static constexpr int NP = NARROW && H % 128 == 0 ? 128 : 64;
  static constexpr int PASSES = NW / NP;
  static constexpr int NB = NARROW ? 1 : 2;  // boxes per plane: per consumer
  // The cotangent tile: g_h | g_alpha | 0 (160 columns), later H wide.
  static constexpr int G_W = H > 160 ? H : 160;
  static constexpr uint32_t G_BYTES = G_W * BM * 4;
  static constexpr uint32_t GS_BYTES = 32 * BM * 4;  // the small tile
  static constexpr uint32_t PLANE_BYTES = round1024(NB * NP * SLICE_ROW);
  static constexpr uint32_t STAGE_BYTES = 2 * PLANE_BYTES;
  // Per consumer and parity: a row of column sums per warp, then 32 floats.
  static constexpr int RED_W = NP;
  static constexpr int RED_FLOATS = 4 * RED_W + 32;
  static constexpr uint32_t RED_BYTES = 2 * 2 * RED_FLOATS * 4;
  static constexpr size_t FIXED =
      1024 + G_BYTES + GS_BYTES + RED_BYTES + BAR_BYTES;
  static constexpr int STAGES = ring_stages(FIXED, STAGE_BYTES);
  static_assert(STAGES >= 2, "the plan leaves no room for a weight ring");
  static constexpr size_t SMEM = FIXED + STAGES * STAGE_BYTES;
  // Floats of a CTA's scratch: the passes before the last, per thread.
  static constexpr int SCRATCH = 256 * (PASSES - 1) * (NP / 2);
  // Product q multiplies by layer(q)'s weights, K = its outputs, N = its
  // inputs from nrow0 on (the x-part of W5): heads, dir, fc_feat, W7 .. W1.
  __host__ __device__ static constexpr int layer(int q) { return L_HEAD - q; }
  __host__ __device__ static constexpr int kdim(int q) {
    return q == 0 ? NHEAD : (q == 1 ? DHP : H);
  }
  __host__ __device__ static constexpr int nrow0(int q) {
    return layer(q) == SKIP ? IPE : 0;
  }
  __host__ __device__ static constexpr int passes(int q) {
    return q == 0 ? NH / NP : PASSES;
  }
};

struct CSmem {
  uint32_t g, gs, ring, full, empty;  // cotangent and small tiles, ring
};

template <int H>
__device__ __forceinline__ void chain_produce(const CMaps& maps,
                                              const CSmem& s,
                                              long long tiles) {
  using S = CShape<H>;
  uint32_t it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll 1
    for (int q = 0; q < NQ; ++q) {
      const int l = S::layer(q), ns = S::kdim(q) / KS, br = S::NP;
      const int cstep = q == 0 ? S::NH : S::NW;  // consumer 1's first column
#pragma unroll 1
      for (int pass = 0; pass < S::passes(q); ++pass)
#pragma unroll 1
        for (int i = 0; i < ns; ++i, ++it) {
          const uint32_t stage = it % S::STAGES, parity = (it / S::STAGES) & 1;
          mbar_wait(s.empty + 8 * stage, parity ^ 1);
          const uint32_t full = s.full + 8 * stage;
          mbar_arrive_expect_tx(full, 2 * S::NB * br * SLICE_ROW);
          const uint32_t dst = s.ring + stage * S::STAGE_BYTES;
          for (int c = 0; c < S::NB; ++c) {
            const int row = S::nrow0(q) + c * cstep + pass * br;
            tma_load_2d(dst + c * br * SLICE_ROW, &maps.wb[l], i * KS, row,
                        full);
            tma_load_2d(dst + S::PLANE_BYTES + c * br * SLICE_ROW,
                        &maps.ws[l], i * KS, row, full);
          }
        }
    }
  }
}

// STEPS k8 steps of a product into the zeroed partial `part` (wgmma's
// scale-d = 0 on the first product), then a rounded f32 addition into acc.
// A is loaded from the f32 tile at `a_tile` and split in registers, two
// fragments in turn (as in fwd_products); a stage is released (one arrival
// per warp) once its products have finished.
template <int H, int N, int STEPS>
__device__ __forceinline__ void chain_chunk(float (&acc)[N / 2],
                                            float (&part)[N / 2], int k0,
                                            uint32_t& it, const CSmem& s,
                                            uint32_t a_tile, int arow,
                                            uint32_t w_rows, int lane) {
  using S = CShape<H>;
  AFrag a[2];
  uint32_t prev = 0;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const uint32_t stage = it % S::STAGES, parity = (it / S::STAGES) & 1;
    load_a(a[i & 1], a_tile, S::BM, arow, k0 + i * KS, lane & 3);
    mbar_wait(s.full + 8 * stage, parity);
    const uint32_t b = s.ring + stage * S::STAGE_BYTES + w_rows;
    wgmma_fence();
    mma3<N>(part, a[i & 1], smem_desc_k<32>(b),
            smem_desc_k<32>(b + S::PLANE_BYTES), i > 0);
    wgmma_commit();
    if (i > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(s.empty + 8 * prev);
    }
    prev = stage;
    ++it;
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(s.empty + 8 * prev);
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] += part[j];
}

// acc = A [the warpgroup's 64 rows, NS k8 steps] @ W slices for N columns
// from the one at byte `w_rows` of a plane, in zeroed partials of CHUNK
// steps; A is the small tile for the heads, the cotangent tile otherwise.
template <int H, int N, int NS>
__device__ __forceinline__ void chain_products(float (&acc)[N / 2],
                                               float (&part)[N / 2],
                                               uint32_t& it, const CSmem& s,
                                               uint32_t a_tile, int arow,
                                               uint32_t w_rows, int lane) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
#pragma unroll 1
  for (int c = 0; c < NS / CHUNK; ++c)
    chain_chunk<H, N, CHUNK>(acc, part, c * CHUNK * KS, it, s, a_tile, arow,
                             w_rows, lane);
  if constexpr (NS % CHUNK != 0)
    chain_chunk<H, N, NS % CHUNK>(acc, part, NS / CHUNK * CHUNK * KS, it, s,
                                  a_tile, arow, w_rows, lane);
}

// The column sums of the warp's 16 rows of an epilogue's NC columns into
// row `warp` of red (shared; RED_W floats a row).
template <int NC, int RED_W>
__device__ __forceinline__ void col_sums(const float (&acc)[NC / 2],
                                         uint32_t red, int warp, int g,
                                         int q) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const float s0 = sum_rows(acc[4 * j] + acc[4 * j + 2]);
    const float s1 = sum_rows(acc[4 * j + 1] + acc[4 * j + 3]);
    if (g == 0)
      sts2(red + 4 * (warp * RED_W + j * 8 + 2 * q), make_float2(s0, s1));
  }
}

template <int H>
__device__ __forceinline__ void chain_consume(const CParams& p, const CSmem& s,
                                              uint32_t red0, long long tiles,
                                              int wg, int tid) {
  using S = CShape<H>;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  // The narrow plan: this consumer's rows; the N-split plan: every row.
  const int row0 = S::NARROW ? wg * WG_ROWS : 0;
  const int arow = row0 + warp * 16 + g;  // the thread's rows: arow, arow + 8
  const int ctid = wg * 128 + tid;        // among both consumers
  // The threads that share a tile's rows: a consumer, or both.
  auto rows_bar = [&]() {
    if constexpr (S::NARROW)
      wg_bar(wg);
    else
      named_bar_sync(7, 256);
  };
  // Around a write-back over a product's input: in the N-split plan warp
  // `warp` of each consumer reads the rows that both write.
  auto pair = [&]() {
    if constexpr (!S::NARROW) pair_bar(warp);
  };
  auto at = [&](uint32_t tile, int r, int c) {
    return tile + tile_off(S::BM, r, c);
  };
  // v, column col and row r of the tile, into a transposed slab pair.
  auto put_t = [&](float* big, float* small, int col, long long r, float v) {
    uint32_t hb, hs;
    split_tf32(v, hb, hs);
    big[col * p.ldt + r] = __uint_as_float(hb);
    small[col * p.ldt + r] = __uint_as_float(hs);
  };
  // The first column of this consumer's share of a product: w_cols, and
  // the byte offset of its weight rows in a stage.
  const int w_cols = S::NARROW ? 0 : wg * S::NW;
  const uint32_t w_rows = S::NARROW ? 0 : wg * S::NP * SLICE_ROW;

  uint32_t it = 0, parity_red = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * S::BM;
    // This consumer's 64-row partial row of bias gradients.
    float* bp = p.bpart + (S::NARROW ? 2 * tile + wg : tile) * p.nb;
    // The small tile (g_heads) and g_alpha with the zero columns after it
    // in the cotangent tile (columns 128..159), and their transposed slabs.
    const int fill_tid = S::NARROW ? tid : ctid;
    for (int e = fill_tid; e < WG_ROWS * 16; e += S::NARROW ? 128 : 256) {
      const int r = row0 + e / 16, c = 2 * (e % 16);
      const long long gr = r0 + r;
      float2 v = make_float2(0.f, 0.f), va = make_float2(0.f, 0.f);
      if (gr < p.n) {
        const float* gg = p.g + gr * p.out_dim;
        auto head = [&](int col) {
          return col < 3 ? gg[col]
                         : (col < 5 && p.out_dim == 6 ? gg[col + 1] : 0.f);
        };
        v = make_float2(head(c), head(c + 1));
        if (c == 0) va.x = gg[3];
      }
      sts2(at(s.gs, r, c), v);
      if (c < GS_W) {
        put_t(p.gsb, p.gss, c, gr, v.x);
        put_t(p.gsb, p.gss, c + 1, gr, v.y);
      }
      sts2(at(s.g, r, DH + c), va);
      if (c < DHP - DH) {
        put_t(p.gdb, p.gds, DH + c, gr, va.x);
        put_t(p.gdb, p.gds, DH + c + 1, gr, va.y);
      }
    }
    rows_bar();
    // d_b_heads, d_b_alpha: column sums of the small tile and of g_alpha
    // over the consumer's 64 rows, row after row (consumer 0 in the N-split
    // plan), after the column-sum rows of red's first parity.
    if ((S::NARROW || wg == 0) && tid < GS_W + 1) {
      float sum = 0.f;
      for (int r = row0; r < row0 + WG_ROWS; ++r)
        sum += lds(tid < GS_W ? at(s.gs, r, tid) : at(s.g, r, DH));
      sts(red0 + 4 * (4 * S::RED_W + tid), sum);
    }
    // The warpgroup's four rows of red in order into the partial row at
    // `dst` (after col_sums).
    auto bias_rows = [&](int nc, int c0, float* dst, uint32_t r_) {
      wg_bar(wg);
      for (int c = tid; c < nc; c += 128)
        dst[c0 + c] = ((lds(r_ + 4 * c) + lds(r_ + 4 * (S::RED_W + c))) +
                       lds(r_ + 4 * (2 * S::RED_W + c))) +
                      lds(r_ + 4 * (3 * S::RED_W + c));
    };

    // Heads: g_h = mask(h > 0, g_heads @ W_heads) -> tile columns 0..127,
    // ghf, the transposed gd slabs, d_b_dir; its input is the small tile,
    // so each pass writes back at once.
    {
      constexpr int NC = S::NP;
      float acc[NC / 2], part[NC / 2];
#pragma unroll 1
      for (int pass = 0; pass < S::NH / NC; ++pass) {
        const int c0 = (S::NARROW ? 0 : wg * S::NH) + pass * NC;
        chain_products<H, NC, NHEAD / KS>(acc, part, it, s, s.gs, arow,
                                          w_rows, lane);
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = arow + 8 * h2, col = c0 + j * 8 + 2 * q4;
            const long long gr = r0 + r;
            float2 v =
                make_float2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]);
            float2 m = make_float2(0.f, 0.f);
            if (gr < p.n)
              m = *reinterpret_cast<const float2*>(p.stash_h + gr * DH + col);
            v = make_float2(m.x > 0.f ? v.x : 0.f, m.y > 0.f ? v.y : 0.f);
            acc[4 * j + 2 * h2] = v.x;
            acc[4 * j + 2 * h2 + 1] = v.y;
            if (gr < p.n)
              *reinterpret_cast<float2*>(p.ghf + gr * DH + col) = v;
            put_t(p.gdb, p.gds, col, gr, v.x);
            put_t(p.gdb, p.gds, col + 1, gr, v.y);
          }
        // Into the tile after every mask load (a shared store's asm orders
        // memory).
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            sts2(at(s.g, arow + 8 * h2, c0 + j * 8 + 2 * q4),
                 make_float2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]));
        const uint32_t red = red0 + 4 * (parity_red & 1) * S::RED_FLOATS;
        col_sums<NC, S::RED_W>(acc, red, warp, g, q4);
        bias_rows(NC, c0, bp + p.b_off[2], red);
        ++parity_red;
      }
      // The small sums, made visible by bias_rows' barrier.
      const uint32_t small_sums = red0 + 4 * 4 * S::RED_W;
      if ((S::NARROW || wg == 0) && tid < DHP - DH)
        bp[p.b_off[2] + DH + tid] = tid == 0 ? lds(small_sums + 4 * GS_W) : 0.f;
      if ((S::NARROW || wg == 0) && tid < NHEAD)
        bp[p.b_off[3] + tid] = lds(small_sums + 4 * tid);
      pair();  // g_h published to the other consumer
    }
    // The dir layer (g_feat, no mask), fc_feat and W7 .. W1 (masks x7 ..
    // x0), each in PASSES passes of NP columns.  The dir product's K is
    // 144, the others' H.
    {
      constexpr int NC = S::NP;
      float acc[NC / 2], part[NC / 2];
      auto product = [&](auto steps, int q) {
        // Product q >= 2 gives g_i, i = layer(q) - 1, masked by x_i; the
        // dir product gives g_feat (slab 8).
        const int slab = q == 1 ? NTRUNK : S::layer(q) - 1;
#pragma unroll 1
        for (int pass = 0; pass < S::PASSES; ++pass) {
          chain_products<H, NC, decltype(steps)::value>(acc, part, it, s, s.g,
                                                        arow, w_rows, lane);
          const int c0 = w_cols + pass * NC;
          const float* mask = p.stash + slab * p.n * H;
          float* big = p.gtb + (long long)slab * H * p.ldt;
          float* small = p.gts + (long long)slab * H * p.ldt;
#pragma unroll
          for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int r = arow + 8 * h2, col = c0 + j * 8 + 2 * q4;
              const long long gr = r0 + r;
              float2 v =
                  make_float2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]);
              float2 m = make_float2(0.f, 0.f);
              if (gr < p.n)
                m = q == 1
                        ? make_float2(1.f, 1.f)
                        : *reinterpret_cast<const float2*>(mask + gr * H + col);
              v = make_float2(m.x > 0.f ? v.x : 0.f, m.y > 0.f ? v.y : 0.f);
              acc[4 * j + 2 * h2] = v.x;
              acc[4 * j + 2 * h2 + 1] = v.y;
              put_t(big, small, col, gr, v.x);
              put_t(big, small, col + 1, gr, v.y);
            }
          }
          const uint32_t red = red0 + 4 * (parity_red & 1) * S::RED_FLOATS;
          col_sums<NC, S::RED_W>(acc, red, warp, g, q4);
          bias_rows(NC, c0,
                    bp + (q == 1 ? p.b_off[1] : p.b_off[0] + slab * H), red);
          ++parity_red;
          // This thread's scratch, interleaved over the 256 threads.
          float* scratch =
              p.scratch + (long long)blockIdx.x * S::SCRATCH + ctid;
          if (pass + 1 < S::PASSES) {
#pragma unroll
            for (int j = 0; j < NC / 2; ++j)
              scratch[(pass * (NC / 2) + j) * 256] = acc[j];
            continue;
          }
          // The write-back, once the input is read: this pass from the
          // registers, the earlier ones from the scratch.
          pair();
#pragma unroll
          for (int j = 0; j < NC / 8; ++j)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
              sts2(at(s.g, arow + 8 * h2, c0 + j * 8 + 2 * q4),
                   make_float2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]));
#pragma unroll
          for (int pb = 0; pb + 1 < S::PASSES; ++pb) {
            float v[NC / 2];  // loaded before the stores' asm orders memory
#pragma unroll
            for (int j = 0; j < NC / 2; ++j)
              v[j] = scratch[(pb * (NC / 2) + j) * 256];
#pragma unroll
            for (int j = 0; j < NC / 8; ++j)
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2)
                sts2(at(s.g, arow + 8 * h2,
                        w_cols + pb * NC + j * 8 + 2 * q4),
                     make_float2(v[4 * j + 2 * h2], v[4 * j + 2 * h2 + 1]));
          }
          pair();
        }
      };
      product(std::integral_constant<int, DHP / KS>{}, 1);
#pragma unroll 1
      for (int q = 2; q < NQ; ++q)
        product(std::integral_constant<int, H / KS>{}, q);
    }
    // The set-up of the next tile rewrites the small tile and columns
    // 128.. of the cotangent tile, which other warps may still read.
    rows_bar();
  }
}

template <int H>
__global__ void __launch_bounds__(NTHREADS, 1)
    float_chain_kernel(const CParams p, const __grid_constant__ CMaps maps) {
  using S = CShape<H>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  CSmem s;
  s.g = base;
  s.gs = s.g + S::G_BYTES;
  s.ring = s.gs + S::GS_BYTES;
  const uint32_t red = s.ring + S::STAGES * S::STAGE_BYTES;
  s.full = red + S::RED_BYTES;
  s.empty = s.full + 8 * MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(s.full + 8 * i, 1);
      mbar_init(s.empty + 8 * i, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const long long tiles = (p.n + S::BM - 1) / S::BM;
  const int wg = threadIdx.x / 128;
  // The producer warpgroup gives registers to the consumers: 128 x 40 +
  // 256 x 232 = 384 x 168, the CTA's allocation.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) chain_produce<H>(maps, s, tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    chain_consume<H>(p, s, red + (wg - 1) * 2 * S::RED_FLOATS * 4, tiles,
                     wg - 1, threadIdx.x - wg * 128);
  }
}

// g_dproj[ray, c] = the sum over the ray's rows of g_h[row, c], in row
// order, in f32.
__global__ void float_dproj_grad_kernel(const float* ghf, float* gdp,
                                        int samples) {
  const long long ray = blockIdx.x;
  const int c = threadIdx.x;
  const float* src = ghf + ray * samples * DH + c;
  float s = 0.f;
  for (int k = 0; k < samples; ++k) s += src[(long long)k * DH];
  gdp[ray * DH + c] = s;
}

// d_Wd_dirs[c, j] = sum over rays of g_dproj[ray, c] dirs[ray, j] in f32,
// in two fixed-order passes (blocks of DG_RAYS rays, then the blocks).
constexpr int DG_RAYS = 16;

__global__ void float_dirs_grad_partial_kernel(const float* gdp,
                                               const float* dirs, float* part,
                                               long long rays) {
  __shared__ float d[DG_RAYS][DIRS];
  const long long r0 = (long long)blockIdx.x * DG_RAYS;
  const int c = threadIdx.x;
  const int here = (int)(rays - r0 < DG_RAYS ? rays - r0 : DG_RAYS);
  for (int i = c; i < here * DIRS; i += DH)
    d[i / DIRS][i % DIRS] = dirs[r0 * DIRS + i];
  __syncthreads();
  float acc[DIRS];
#pragma unroll
  for (int j = 0; j < DIRS; ++j) acc[j] = 0.f;
  for (int i = 0; i < here; ++i) {
    const float gv = gdp[(r0 + i) * DH + c];
#pragma unroll
    for (int j = 0; j < DIRS; ++j) acc[j] = fmaf(gv, d[i][j], acc[j]);
  }
  float* out = part + (long long)blockIdx.x * DIRS * DH + c;
#pragma unroll
  for (int j = 0; j < DIRS; ++j) out[j * DH] = acc[j];
}

__global__ void float_dirs_grad_reduce_kernel(const float* part,
                                              float* gw_dirs, int blocks) {
  const int j = blockIdx.x, c = threadIdx.x;
  float s = 0.f;
  if (j < DIRS)
    for (int b = 0; b < blocks; ++b)
      s += part[((long long)b * DIRS + j) * DH + c];
  gw_dirs[c * DIRS_LD + j] = s;
}

// gb[c] = sum over the partial rows of bpart[row, c] in a fixed order:
// eight interleaved row groups, then the groups in turn.
constexpr int BR_COLS = 32, BR_GROUPS = 8;

__global__ void float_bias_reduce_kernel(const float* bpart, float* gb,
                                         long long rows, int nb) {
  __shared__ float part[BR_GROUPS][BR_COLS];
  const int c = blockIdx.x * BR_COLS + threadIdx.x % BR_COLS;
  const int grp = threadIdx.x / BR_COLS;
  float s = 0.f;
  if (c < nb)
    for (long long r = grp; r < rows; r += BR_GROUPS) s += bpart[r * nb + c];
  part[grp][threadIdx.x % BR_COLS] = s;
  __syncthreads();
  if (grp == 0 && c < nb) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < BR_GROUPS; ++i) t += part[i][threadIdx.x];
    gb[c] = t;
  }
}

// ---------------------------------------------------------- weight grads

// dW^T [in, out] = act^T g over the rows, one [128 in, 128 out] tile and
// one split of the rows per CTA: A = act^T (the activation the layer
// reads, [rows, in]) in registers from TMA tiles of [32 rows, 128 in], B =
// g (the transposed cotangent planes, [out, rows]) K-major from TMA tiles
// of [128 out, 32 rows]; two consumers of 64 in-rows each.
constexpr int WT = 128;    // output tile: WT in x WT out
constexpr int WK = 32;     // rows per stage
constexpr int W_STAGES = 4;
constexpr int MAX_MATS = 12;
constexpr uint32_t WA_BYTES = WT * WK * 4;        // [32 rows, 128 in]
constexpr uint32_t WB_PLANE = WT * WK * 4;        // [128 out, 32 rows]
constexpr uint32_t W_STAGE_BYTES = WA_BYTES + 2 * WB_PLANE;
constexpr size_t W_SMEM = 1024 + W_STAGES * W_STAGE_BYTES + BAR_BYTES;
static_assert(W_SMEM <= MAX_SMEM, "the plan exceeds a block's shared memory");

enum { A_IPE = 0, A_STASH = 1, A_H = 2, NA_MAPS = 3 };
enum { B_GT = 0, B_GD = 1, B_GS = 2, NB_MAPS = 3 };

struct WMaps {
  CUtensorMap a[NA_MAPS];      // ipe {96, n}, stash {H, n, 9}, h {128, n}
  CUtensorMap b[2][NB_MAPS];   // [big, small] gt {ldt, H, 9}, gd, gs
};

// One packed weight matrix: dst[o * ld_dst + i] = sum over rows of
// g[r, o] act[r, i], o < outs, i < ins.
struct WMat {
  int a_map, a_slab, a_col0;  // act columns from a_col0
  int b_map, b_slab;
  int outs, ins, ld_dst;
  int otiles, itiles, cta_begin;
  long long part;        // float offset of its partials [splits, outs, ins]
  long long dst;         // float offset into gw
  long long elem_begin;  // its first element in the reduce launch
};

struct WParams {
  WMat mat[MAX_MATS];
  int nmat, splits;
  long long rows_per_split, n;
  float* part;
  float* gw;
};

__device__ __forceinline__ void wgrad_a_load(const WMaps& maps, const WMat& M,
                                             uint32_t dst, int i0, long long r,
                                             uint32_t bar) {
  for (int b = 0; b < WT / 32; ++b) {
    const uint32_t at = dst + b * WK * 128;
    if (M.a_map == A_STASH)
      tma_load_3d(at, &maps.a[A_STASH], M.a_col0 + i0 + 32 * b, (int)r,
                  M.a_slab, bar);
    else
      tma_load_2d(at, &maps.a[M.a_map], M.a_col0 + i0 + 32 * b, (int)r, bar);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
    float_wgrad_kernel(const __grid_constant__ WParams P,
                       const __grid_constant__ WMaps maps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + W_STAGES * W_STAGE_BYTES;
  const uint32_t empty = full + 8 * W_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < W_STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  int mi = 0;
  while (mi + 1 < P.nmat && (int)blockIdx.x >= P.mat[mi + 1].cta_begin) ++mi;
  const WMat& M = P.mat[mi];
  const int local = blockIdx.x - M.cta_begin;
  const int split = local % P.splits, tile = local / P.splits;
  const int i0 = tile / M.otiles * WT, o0 = tile % M.otiles * WT;
  const long long rb = split * P.rows_per_split;
  const long long re = min(P.n, rb + P.rows_per_split);
  const int chunks = rb < re ? (int)((re - rb + WK - 1) / WK) : 0;

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if (threadIdx.x != 0) return;
    const int bslab = M.b_map == B_GT ? M.b_slab : 0;
    for (int c = 0; c < chunks; ++c) {
      const uint32_t stage = c % W_STAGES, parity = (c / W_STAGES) & 1;
      mbar_wait(empty + 8 * stage, parity ^ 1);
      const uint32_t bar = full + 8 * stage;
      mbar_arrive_expect_tx(bar, W_STAGE_BYTES);
      const uint32_t dst = base + stage * W_STAGE_BYTES;
      const long long r = rb + (long long)c * WK;
      wgrad_a_load(maps, M, dst, i0, r, bar);
      for (int pl = 0; pl < 2; ++pl) {
        const uint32_t at = dst + WA_BYTES + pl * WB_PLANE;
        if (M.b_map == B_GT)
          tma_load_3d(at, &maps.b[pl][B_GT], (int)r, o0, bslab, bar);
        else
          tma_load_2d(at, &maps.b[pl][M.b_map], (int)r, o0, bar);
      }
    }
    return;
  }
  const int tid = threadIdx.x - wg * 128, c = wg - 1;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // The thread's in-rows of the tile: irow, irow + 8.
  const int irow = c * 64 + warp * 16 + g;
  float acc[WT / 2], part[WT / 2];
#pragma unroll
  for (int j = 0; j < WT / 2; ++j) acc[j] = 0.f;
  // A fragment of k8 step k of a stage: act^T [in irow (+8), rows k + t
  // (+4)], element (row, in) of the [32, 128] tile of [32 rows, 32 in]
  // blocks.
  auto a_el = [&](const unsigned char* a, int i, int k) {
    return *reinterpret_cast<const float*>(
        a + (i >> 5) * WK * 128 + k * 128 +
        ((((i & 31) >> 2) ^ (k & 7)) << 4) + ((i & 3) << 2));
  };
  AFrag af[2];
  for (int ch = 0; ch < chunks; ++ch) {
    const uint32_t stage = ch % W_STAGES, parity = (ch / W_STAGES) & 1;
    const unsigned char* a = smem + stage * W_STAGE_BYTES;
    const uint32_t b = base + stage * W_STAGE_BYTES + WA_BYTES;
    mbar_wait(full + 8 * stage, parity);
    // The chunk's products into a zeroed partial sum, then a rounded f32
    // add: these sums run over ~10^4 rows, and the tensor cores add with
    // truncation.
#pragma unroll
    for (int k8 = 0; k8 < WK / 8; ++k8) {
      AFrag& f = af[k8 & 1];
      const int k = k8 * 8 + t;
      f.set(a_el(a, irow, k), a_el(a, irow + 8, k), a_el(a, irow, k + 4),
            a_el(a, irow + 8, k + 4));
      wgmma_fence();
      mma3<WT>(part, f, smem_desc_k<128>(b + 32 * k8),
               smem_desc_k<128>(b + WB_PLANE + 32 * k8), k8 > 0);
      wgmma_commit();
      if (k8 > 0) wgmma_wait<1>();
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
#pragma unroll
    for (int j = 0; j < WT / 2; ++j) acc[j] += part[j];
  }

  // acc element (in irow (+8), out 8 j + 2 t (+1)) -> the [outs, ins]
  // partial of this split.
  float* out = P.part + M.part + (long long)split * M.outs * M.ins;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = i0 + irow + 8 * h2;
    if (i >= M.ins) continue;
#pragma unroll
    for (int j = 0; j < WT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = o0 + j * 8 + 2 * t + e;
        if (o < M.outs) out[(long long)o * M.ins + i] = acc[4 * j + 2 * h2 + e];
      }
  }
}

// Every matrix's partials summed over the splits in order, into gw.
__global__ void float_wgrad_reduce_kernel(const __grid_constant__ WParams P,
                                          long long elems) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  int mi = 0;
  while (mi + 1 < P.nmat && e >= P.mat[mi + 1].elem_begin) ++mi;
  const WMat& M = P.mat[mi];
  const long long local = e - M.elem_begin, count = (long long)M.outs * M.ins;
  const float* src = P.part + M.part + local;
  float s = 0.f;
  for (int sp = 0; sp < P.splits; ++sp) s += src[sp * count];
  P.gw[M.dst + local / M.ins * M.ld_dst + local % M.ins] = s;
}

// ------------------------------------------------------------------ host

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

bool known_width(int hidden) {
  return hidden == 64 || hidden == 128 || hidden == 192 || hidden == 256 ||
         hidden == 384 || hidden == 512;
}

int chain_rows(int hidden) { return hidden <= 256 ? 2 * WG_ROWS : WG_ROWS; }

// CShape<hidden>::SCRATCH, on the host.
long long chain_scratch(int hidden) {
  const int nw = hidden <= 256 ? hidden : hidden / 2;
  const int np = hidden <= 256 && hidden % 128 == 0 ? 128 : 64;
  return 256LL * (nw / np - 1) * (np / 2);
}

long long chain_tiles(long long n, int hidden) {
  return (n + chain_rows(hidden) - 1) / chain_rows(hidden);
}

// The row stride of the transposed cotangent slabs: every row of every
// chain tile (the rows past n hold zeros).
long long slab_ld(long long n, int hidden) {
  return chain_tiles(n, hidden) * chain_rows(hidden);
}

// The weight-gradient matrices in the packed layout (w_off may be null for
// the workspace query: only the sizes are read then), their tiles, and the
// split of the rows: about one CTA per SM over all tiles.
struct WPlan {
  WParams P;
  long long part_floats, elems;
  int ctas;
};

WPlan make_wplan(long long n, int hidden, int sms, const long long* w_off) {
  WPlan W = {};
  WParams& P = W.P;
  static const long long no_off[NW] = {};
  const long long* wo = w_off != nullptr ? w_off : no_off;
  auto add = [&](int a_map, int a_slab, int a_col0, int ins, int b_map,
                 int b_slab, int outs, long long dst, int ld_dst) {
    WMat& M = P.mat[P.nmat++];
    M.a_map = a_map;
    M.a_slab = a_slab;
    M.a_col0 = a_col0;
    M.ins = ins;
    M.b_map = b_map;
    M.b_slab = b_slab;
    M.outs = outs;
    M.dst = dst;
    M.ld_dst = ld_dst;
    M.otiles = (outs + WT - 1) / WT;
    M.itiles = (ins + WT - 1) / WT;
  };
  for (int i = 1; i < NTRUNK; ++i) {  // W_i [H, kin] from g_i, x_{i-1}
    const int kin = i == SKIP ? IPE + hidden : hidden;
    add(A_STASH, i - 1, 0, hidden, B_GT, i, hidden,
        wo[i] + (i == SKIP ? IPE : 0), kin);
  }
  add(A_IPE, 0, 0, IPE, B_GT, SKIP, hidden, wo[SKIP], IPE + hidden);
  add(A_IPE, 0, 0, IPE, B_GT, 0, hidden, wo[0], IPE);
  add(A_STASH, NTRUNK - 1, 0, hidden, B_GT, NTRUNK, hidden, wo[W_FEAT],
      hidden);
  // The dir layer [144, H]: g_h | g_alpha | 0 against feat; the heads [16,
  // 128]: g_heads against h.
  add(A_STASH, NTRUNK, 0, hidden, B_GD, 0, DHP, wo[W_DIR], hidden);
  add(A_H, 0, 0, DH, B_GS, 0, NHEAD, wo[W_HEAD], DH);

  int tiles = 0;
  for (int i = 0; i < P.nmat; ++i) tiles += P.mat[i].otiles * P.mat[i].itiles;
  int splits = (sms + tiles / 2) / tiles;
  const long long max_splits = (n + WK - 1) / WK;
  if (splits > max_splits) splits = (int)max_splits;
  if (splits < 1) splits = 1;
  P.splits = splits;
  P.rows_per_split = ((n + splits - 1) / splits + WK - 1) / WK * WK;
  P.n = n;
  long long part = 0, elems = 0;
  int ctas = 0;
  for (int i = 0; i < P.nmat; ++i) {
    WMat& M = P.mat[i];
    M.part = part;
    M.elem_begin = elems;
    M.cta_begin = ctas;
    part += (long long)splits * M.outs * M.ins;
    elems += (long long)M.outs * M.ins;
    ctas += M.otiles * M.itiles * splits;
  }
  W.part_floats = part;
  W.elems = elems;
  W.ctas = ctas;
  return W;
}

struct Layout {
  size_t gtb, gts, gdb, gds, gsb, gss, ghf, bpart, scratch, gdp, dpart, part,
      total;
};

Layout layout(long long n, int samples, int hidden, long long part_floats,
              int sms) {
  const long long rays = n / samples, ldt = slab_ld(n, hidden);
  const long long nb = 9LL * hidden + DHP + NHEAD;
  Layout L;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  const size_t gt_bytes = (size_t)(NTRUNK + 1) * hidden * ldt * sizeof(float);
  L.gtb = take(gt_bytes);
  L.gts = take(gt_bytes);
  L.gdb = take(DHP * ldt * sizeof(float));
  L.gds = take(DHP * ldt * sizeof(float));
  L.gsb = take(NHEAD * ldt * sizeof(float));
  L.gss = take(NHEAD * ldt * sizeof(float));
  L.ghf = take(n * DH * sizeof(float));
  L.bpart = take((n + WG_ROWS - 1) / WG_ROWS * 2 * nb * sizeof(float));
  L.scratch = take((size_t)sms * chain_scratch(hidden) * sizeof(float));
  L.gdp = take(rays * DH * sizeof(float));
  L.dpart = take((rays + DG_RAYS - 1) / DG_RAYS * DIRS * DH * sizeof(float));
  L.part = take(part_floats * sizeof(float));
  L.total = off;
  return L;
}

template <int H>
cudaError_t launch_chain(const CParams& p, const float* w,
                         const long long* w_off, cudaStream_t st) {
  using S = CShape<H>;
  const long long plane = plane_floats(w_off);
  CMaps maps = {};
  bool ok = true;
  for (int l = 1; l < NLAYER; ++l) {  // W0 meets no chain product
    // Layer l transposed: [k_in, n_out], n_out (the chain's K) innermost;
    // a box of the rows (columns of the product) of one consumer's pass.
    const int rows = mat_cols(l, H), cols = mat_rows(l, H);
    const cuuint32_t box_rows = S::NP;
    ok = ok && map2(&maps.wb[l], w + 3 * plane + w_off[l], cols, rows, cols,
                    KS, box_rows, CU_TENSOR_MAP_SWIZZLE_32B);
    ok = ok && map2(&maps.ws[l], w + 4 * plane + w_off[l], cols, rows, cols,
                    KS, box_rows, CU_TENSOR_MAP_SWIZZLE_32B);
  }
  if (!ok) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  static const cudaError_t setup = cudaFuncSetAttribute(
      float_chain_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM);  // once per process and instantiation
  if (setup != cudaSuccess) return setup;
  const long long tiles = (p.n + S::BM - 1) / S::BM;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  float_chain_kernel<H><<<grid, NTHREADS, S::SMEM, st>>>(p, maps);
  return cudaGetLastError();
}

}  // namespace

// The four TF32 planes of a float32 weight pack, on `stream`: `w` holds
// five planes of P = w_off[11] + 128 * 32 floats each, the first the
// packed f32 weights of a network of width `hidden` (kernels/fused_mlp.py::
// pack_weights); this writes the second and third (every weight's big and
// small TF32 part, in the packed layout) and the fourth and fifth (the same,
// each matrix transposed to [in, out] at its own offset).  Returns a
// cudaError_t.
extern "C" int ddnerf_tf32_split(void* w, int hidden, const long long* w_off,
                                 void* stream) {
  if (!known_width(hidden)) return cudaErrorInvalidValue;
  SplitParams p = {};
  p.plane = plane_floats(w_off);
  float* base = static_cast<float*>(w);
  p.w = base;
  p.big = base + p.plane;
  p.small = base + 2 * p.plane;
  p.big_t = base + 3 * p.plane;
  p.small_t = base + 4 * p.plane;
  for (int l = 0; l < NW; ++l) {
    p.off[l] = w_off[l];
    p.rows[l] = mat_rows(l, hidden);
  }
  p.off[NW] = p.plane;
  tf32_split_kernel<<<(unsigned)((p.plane + 255) / 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The float32 forward on `stream`: the dir projection, then the network at
// width `hidden`.  Device pointers: ipe [n, 96] f32, dirs [n / samples, 27]
// f32, w the float32 weight pack with its TF32 planes (ddnerf_tf32_split),
// packed biases, dproj [n / samples, 128] f32 scratch, out [n, 4|6] f32,
// and in stash mode stash [9, n, hidden] and stash_h [n, 128] f32 (both
// null in render mode).  w_off (12 entries) and b_off (4) are host arrays.
// Returns a cudaError_t.
extern "C" int ddnerf_fused_mlp_fwd_f32(const void* ipe, const void* dirs,
                                        const void* w, const void* b,
                                        void* dproj, void* out, void* stash,
                                        void* stash_h, long long n,
                                        int samples, int hidden,
                                        int depth_head,
                                        const long long* w_off,
                                        const long long* b_off, void* stream) {
  if (n <= 0 || samples <= 0 || n % samples) return cudaErrorInvalidValue;
  if ((stash == nullptr) != (stash_h == nullptr)) return cudaErrorInvalidValue;
  FParams p = {};
  p.b = static_cast<const float*>(b);
  p.dproj = static_cast<const float*>(dproj);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.samples = samples;
  p.out_dim = depth_head ? 6 : 4;
  p.stash = stash != nullptr;
  return run_fwd<false>(p, ipe, dirs, w, stash, stash_h, hidden, w_off, b_off,
                        static_cast<cudaStream_t>(stream));
}

// The same network fed the IPE it computes from means [n, 3] and covs
// [n, 3] f32 (ENC mode; render only).  Other arguments as
// ddnerf_fused_mlp_fwd_f32's.  Returns a cudaError_t.
extern "C" int ddnerf_fused_enc_mlp_fwd_f32(const void* means,
                                            const void* covs, const void* dirs,
                                            const void* w, const void* b,
                                            void* dproj, void* out,
                                            long long n, int samples,
                                            int hidden, int depth_head,
                                            const long long* w_off,
                                            const long long* b_off,
                                            void* stream) {
  if (n <= 0 || samples <= 0 || n % samples) return cudaErrorInvalidValue;
  FParams p = {};
  p.means = static_cast<const float*>(means);
  p.covs = static_cast<const float*>(covs);
  p.b = static_cast<const float*>(b);
  p.dproj = static_cast<const float*>(dproj);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.samples = samples;
  p.out_dim = depth_head ? 6 : 4;
  return run_fwd<true>(p, nullptr, dirs, w, nullptr, nullptr, hidden, w_off,
                       b_off, static_cast<cudaStream_t>(stream));
}

// Bytes of device workspace that ddnerf_fused_mlp_bwd_f32 needs.
extern "C" long long ddnerf_fused_mlp_bwd_workspace_f32(long long n,
                                                        int samples,
                                                        int hidden) {
  if (n <= 0 || samples <= 0 || n % samples || !known_width(hidden)) return -1;
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  const WPlan W = make_wplan(n, hidden, sms, nullptr);
  return (long long)layout(n, samples, hidden, W.part_floats, sms).total;
}

// Parameter gradients of the float32 network on `stream`.  Device
// pointers: ipe [n, 96] f32, dirs [n / samples, 27] f32, g [n, 4|6] f32,
// the forward's stash [9, n, hidden] and stash_h [n, 128] f32, w the
// float32 weight pack with its TF32 planes (ddnerf_tf32_split); outputs gw
// (f32, laid out as the pack's first plane) and gb (f32, laid out as the
// packed biases); ws a workspace of ddnerf_fused_mlp_bwd_workspace_f32
// bytes.  per_ray (kernel_per_ray_dirs) selects nothing here: at f32 both
// settings are the same sum (see the top of the file).  w_off (12 entries)
// and b_off (4) are host arrays.  Returns a cudaError_t.
extern "C" int ddnerf_fused_mlp_bwd_f32(
    const void* ipe, const void* dirs, const void* g, const void* stash,
    const void* stash_h, const void* w, void* gw, void* gb, void* ws,
    long long ws_bytes, long long n, int samples, int hidden, int depth_head,
    int per_ray, const long long* w_off, const long long* b_off,
    void* stream) {
  (void)per_ray;
  if (n <= 0 || samples <= 0 || n % samples) return cudaErrorInvalidValue;
  if (!known_width(hidden) || n > 0x7fffffffLL - 512)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long rays = n / samples, ldt = slab_ld(n, hidden);
  const int nb = 9 * hidden + DHP + NHEAD;
  if (b_off[3] + NHEAD != nb) return cudaErrorInvalidValue;
  WPlan W = make_wplan(n, hidden, sms, w_off);
  const Layout L = layout(n, samples, hidden, W.part_floats, sms);
  if (ws_bytes < (long long)L.total) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* base = static_cast<unsigned char*>(ws);
  auto at = [&](size_t off) { return reinterpret_cast<float*>(base + off); };

  CParams p = {};
  p.g = static_cast<const float*>(g);
  p.stash = static_cast<const float*>(stash);
  p.stash_h = static_cast<const float*>(stash_h);
  p.gtb = at(L.gtb);
  p.gts = at(L.gts);
  p.gdb = at(L.gdb);
  p.gds = at(L.gds);
  p.gsb = at(L.gsb);
  p.gss = at(L.gss);
  p.ghf = at(L.ghf);
  p.bpart = at(L.bpart);
  p.scratch = at(L.scratch);
  p.n = n;
  p.ldt = ldt;
  p.out_dim = depth_head ? 6 : 4;
  p.nb = nb;
  for (int i = 0; i < NB_OFF; ++i) p.b_off[i] = b_off[i];
  const float* wp = static_cast<const float*>(w);
  switch (hidden) {
    case 64: e = launch_chain<64>(p, wp, w_off, st); break;
    case 128: e = launch_chain<128>(p, wp, w_off, st); break;
    case 192: e = launch_chain<192>(p, wp, w_off, st); break;
    case 256: e = launch_chain<256>(p, wp, w_off, st); break;
    case 384: e = launch_chain<384>(p, wp, w_off, st); break;
    default: e = launch_chain<512>(p, wp, w_off, st); break;
  }
  if (e != cudaSuccess) return e;

  float* gdp = at(L.gdp);
  float* dpart = at(L.dpart);
  float_dproj_grad_kernel<<<(unsigned)rays, DH, 0, st>>>(p.ghf, gdp, samples);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int blocks = (int)((rays + DG_RAYS - 1) / DG_RAYS);
  float_dirs_grad_partial_kernel<<<blocks, DH, 0, st>>>(
      gdp, static_cast<const float*>(dirs), dpart, rays);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  float_dirs_grad_reduce_kernel<<<DIRS_LD, DH, 0, st>>>(
      dpart, static_cast<float*>(gw) + w_off[W_DIRS], blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  WMaps maps = {};
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  bool ok = map2(&maps.a[A_IPE], ipe, IPE, n, IPE, 32, WK, sw) &&
            map3(&maps.a[A_STASH], stash, hidden, n, NTRUNK + 1, hidden, 32,
                 WK, sw) &&
            map2(&maps.a[A_H], stash_h, DH, n, DH, 32, WK, sw);
  for (int pl = 0; pl < 2 && ok; ++pl) {
    ok = map3(&maps.b[pl][B_GT], pl ? p.gts : p.gtb, ldt, hidden, NTRUNK + 1,
              ldt, WK, WT, sw) &&
         map2(&maps.b[pl][B_GD], pl ? p.gds : p.gdb, ldt, DHP, ldt, WK, WT,
              sw) &&
         map2(&maps.b[pl][B_GS], pl ? p.gss : p.gsb, ldt, NHEAD, ldt, WK, WT,
              sw);
  }
  if (!ok) return cudaErrorInvalidValue;
  W.P.part = at(L.part);
  W.P.gw = static_cast<float*>(gw);
  static const cudaError_t setup = cudaFuncSetAttribute(
      float_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)W_SMEM);
  if (setup != cudaSuccess) return setup;
  float_wgrad_kernel<<<(unsigned)W.ctas, NTHREADS, W_SMEM, st>>>(W.P, maps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  float_wgrad_reduce_kernel<<<(unsigned)((W.elems + 255) / 256), 256, 0,
                              st>>>(W.P, W.elems);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  float_bias_reduce_kernel<<<(nb + BR_COLS - 1) / BR_COLS,
                             BR_COLS * BR_GROUPS, 0, st>>>(
      p.bpart, static_cast<float*>(gb), (n + WG_ROWS - 1) / WG_ROWS, nb);
  return cudaGetLastError();
}
