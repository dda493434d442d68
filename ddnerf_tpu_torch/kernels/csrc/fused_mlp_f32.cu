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
//     VJP fused_mlp_train_apply) -> float_chain_kernel<H>, float_wgrad_kernel and
//     the fixed-order reductions below.
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
// The rate the products run at: 3xTF32 on the tensor cores with
// mma.sync.m16n8k8 (warp-level, fragments loaded from shared memory).
// Every f32 operand x is split as big = tf32(x) (cvt.rna) and small =
// tf32(x - big) (x - big is exact in f32), and a product is
// small*big + big*small + big*big accumulated in f32 (the small*small term
// is below f32's rounding): about f32 accuracy at a third of the TF32 rate,
// 495 / 3 = 165 TFLOP/s dense on an H100 SXM.  A row costs 8 H^2 + 321 H +
// 640 multiply-adds (~0.61 M at width 256): the forward is bound by the
// operations (3.9 ms per 524,288 rows at 256 at that rate) and by the
// instructions around them (two cvt and a subtraction per operand element
// that a warp loads, measured 4.2x the bound; PERF.md); stash mode adds
// 4 (9 H + 128) bytes of writes per row.  The backward is twice the
// operations plus the f32 cotangent slabs that the chain writes and the
// weight gradients read (4 (9 H + 160) bytes per row each way) and the
// stash, read by both.
//
// Where trouble lies, and what the design does about it:
// * wgmma takes TF32 operands K-major only (operand transposition exists for
//   16-bit types; hopper_common.cuh's MN-major descriptor is bf16 only).
//   The backward's chain reads the packed [out, in] weights as a [K, N]
//   operand and the weight gradients read both operands along the row axis,
//   so neither carries over from the bf16 kernels.  Here every product is
//   mma.sync, whose fragments are loaded element by element from shared
//   memory in whatever layout the tile has (row strides chosen so that the
//   loads of a fragment hit 32 distinct banks).
// * A single TF32 product keeps about three decimal digits, and over eight
//   layers that misses the 1e-4 of the JAX package's own f32 kernel tests:
//   hence 3xTF32.  Compiled with -DDDNERF_F32_ONE_PASS the kernels take the
//   big*big term alone (single-pass TF32): the fault chip_smoke.py reads to
//   show that its limits separate the two.
// * The tensor cores add a product into the accumulator with truncation,
//   and the bias that leaves grows with the count of products accumulated:
//   a weight gradient summed over ~10^4 rows in the accumulator read 7.6e-5
//   off the plain version.  Every 16-deep slice goes into a zeroed partial
//   sum that a rounded f32 addition adds to the accumulator (see
//   slice_products).
// * Shared memory doubles at f32.  A block's tile is 64 rows up to width
//   256 and 32 above, and each layer's output is written over its input
//   once every warp has finished the layer's products (the sums live in
//   registers until then): one [rows, H] activation tile.  Weights come
//   through two stages of 16 k-columns copied by cp.async, one slice ahead.
//   A static_assert holds every plan within a block's shared memory.
// * Nothing is rounded to bf16 anywhere: no cast in this file, and the
//   wrappers (kernels/fused_mlp.py) pass f32 weights, IPE and dirs.
//
// Layout of a block: 256 threads, 8 warps.  In the forward and the chain,
// each warp owns 32 rows (two m16 tiles) and every WN-th n8 tile of each
// product (Tiling below): 64 accumulators a thread at widths 256 and 512.
// One block per tile.  The weight gradients are [out, in] = act^T g over
// the rows: 128 x 128 output tiles, 4 x 2 warps of 32 x 64, the rows split
// so that about two blocks per SM are busy; the splits' partials are summed
// in a fixed order, so every result is bitwise repeatable.

#include "hopper_common.cuh"

namespace {

using namespace ddnerf;

constexpr int THREADS = 256;
constexpr int KS = 16;    // k depth of a weight slice (two k8 steps)
constexpr int L_FEAT = W_FEAT, L_DIR = W_DIR, L_HEAD = W_HEAD, NLAYER = 11;
constexpr int IPE_LD = IPE + 4;  // row strides: a stride / 4 that is odd
constexpr int GS_W = 16, GS_LD = GS_W + 4;  // keeps A-fragment loads apart

// ------------------------------------------------------------ 3xTF32 mma

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

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments of m16n8k8, split: A (row-major) a0 (g, t), a1 (g + 8, t), a2
// (g, t + 4), a3 (g + 8, t + 4); B (col-major) b0 (k = t, n = g), b1 (t + 4,
// g); D d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, ...); g = lane / 4, t = lane
// % 4.
struct AFrag {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
};

struct BFrag {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, big[0], small[0]);
    split_tf32(b1, big[1], small[1]);
  }
};

// d += a b in 3xTF32 (or the big*big term alone under DDNERF_F32_ONE_PASS).
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a,
                                     const BFrag& b) {
#ifndef DDNERF_F32_ONE_PASS
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
#endif
  mma_tf32(d, a.big, b.big);
}

// Sum over the 8 row groups g = lane / 4 of a warp (the other lanes' bits).
__device__ __forceinline__ float sum_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// The work of a block of the forward and of the chain: BM rows, in row
// groups of 32 (two m16 tiles); warp w takes row group w / WN and, of every
// product of N outputs, the n8 tiles j = w % WN + WN jj (jj < NTW), each
// B fragment loaded and split once for both m16 tiles.  64 rows up to
// width 256, 32 above (a thread's accumulators: 2 NTW 4 floats, 64 at
// widths 256 and 512).
__host__ __device__ constexpr int tile_rows(int hidden) {
  return hidden > 256 ? 32 : 64;
}

template <int H>
struct Tiling {
  static constexpr int BM = tile_rows(H);
  static constexpr int RG = BM / 32;
  static constexpr int WN = 8 / RG;
  template <int N>
  struct Cols {
    static constexpr int TILES = N / 8;
    static constexpr int NTW = (TILES + WN - 1) / WN;
  };
};

// The warp's place in the block.
struct Warp {
  int row;  // its first row in the tile (a multiple of 32)
  int cg;   // its column group
  int g, t;
};

template <int H>
__device__ __forceinline__ Warp warp_of(int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  return {warp / Tiling<H>::WN * 32, warp % Tiling<H>::WN, lane >> 2,
          lane & 3};
}

// acc += A [the warp's 32 rows, k columns 0 .. 15 of `a`] x B for the
// warp's n8 tiles; A rows `lda` floats apart; B(k, n) = b[n * bn + k * bk].
// The tensor cores add a product to the accumulator with truncation, not
// rounding to nearest, and that bias grows with the number of products
// accumulated (a B2 weight gradient sums ~10^4 rows): so a slice's six
// products per tile go into a zeroed partial sum, which a rounded float
// addition then adds to acc.
template <int N, int WN>
__device__ __forceinline__ void slice_products(
    float (&acc)[2][(N / 8 + WN - 1) / WN][4], const float* a, int lda,
    const float* b, int bn, int bk, const Warp& w) {
  constexpr int TILES = N / 8, NTW = (TILES + WN - 1) / WN;
  AFrag af[2][2];  // [k8 step][m16 tile]
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* r = a + (w.row + mi * 16 + w.g) * lda + ks * 8 + w.t;
      af[ks][mi].set(r[0], r[8 * lda], r[4], r[8 * lda + 4]);
    }
#pragma unroll
  for (int jj = 0; jj < NTW; ++jj) {
    const int j = w.cg + WN * jj;
    if (TILES % WN != 0 && j >= TILES) continue;
    float part[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float* bp = b + (j * 8 + w.g) * bn + (ks * 8 + w.t) * bk;
      BFrag bf;
      bf.set(bp[0], bp[4 * bk]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma3(part[mi], af[ks][mi], bf);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][jj][e] += part[mi][e];
  }
}

// 16-byte copies global -> shared that run beside the products, one group
// per weight slice (cp.async).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- forward

struct FParams {
  const float* ipe;    // [n, 96]; null in ENC mode
  const float* means;  // [n, 3]; ENC mode only
  const float* covs;   // [n, 3]; ENC mode only
  const float* w;      // packed weights (f32)
  const float* b;      // packed biases
  const float* dproj;  // [n / samples, 128]
  float* out;          // [n, out_dim]
  float* stash;        // [9, n, H] or null
  float* stash_h;      // [n, 128] or null
  long long n;
  int samples;
  int out_dim;
  long long w_off[NW];
  long long b_off[NB_OFF];
};

template <int H>
struct FShape : Tiling<H> {
  static_assert(H % 64 == 0 && H <= 512, "no float32 forward plan");
  using Tiling<H>::BM;
  static constexpr int ACT_W = H > DH ? H : DH;  // the trunk, later h
  static constexpr int ACT_LD = ACT_W + 4;
  static constexpr int MAXN = H > DHP ? H : DHP;
  static constexpr int WS_LD = KS + 4;  // stage rows: output n, k columns
  static constexpr int STAGE = MAXN * WS_LD;  // floats; two stages
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BM * ACT_LD + BM * IPE_LD + 2 * STAGE);
  static_assert(SMEM <= MAX_SMEM, "the plan exceeds a block's shared memory");
  __host__ __device__ static constexpr int nout(int l) {
    return l <= L_FEAT ? H : (l == L_DIR ? DHP : NHEAD);
  }
  __host__ __device__ static constexpr int kin(int l) {
    return l == 0 ? IPE : (l == SKIP ? IPE + H : (l == L_HEAD ? DH : H));
  }
  // Slices that meet the IPE tile come first (layer 0 and the skip layer).
  __host__ __device__ static constexpr int ipe_slices(int l) {
    return l == 0 || l == SKIP ? IPE / KS : 0;
  }
  __host__ __device__ static constexpr int slices(int l) { return kin(l) / KS; }
};

// Slice i of layer l, columns KS i .. KS i + 15 of W_l [nout, kin] (the
// IPE part of the skip layer is its first six slices), copied into `stage`
// as float4s, thread tid taking tid, tid + 256, ...
template <int H>
__device__ __forceinline__ void copy_fwd(float* stage, const FParams& p,
                                         int l, int i, int tid) {
  using S = FShape<H>;
  const int nout = S::nout(l), kin = S::kin(l);
  const float* src = p.w + p.w_off[l] + i * KS;
  for (int q = tid; q < nout * (KS / 4); q += THREADS)
    cp_async16(stage + (q >> 2) * S::WS_LD + 4 * (q & 3),
               src + (long long)(q >> 2) * kin + 4 * (q & 3));
  cp_commit();
}

// The warp's rows times layer l's weights (N outputs), slice by slice: acc
// starts at the bias.  Slice `it` (counted over the tile's layers) is in
// stage it % 2; after the barrier that makes it visible the next one (the
// next layer's first after the last) is copied into the other stage, which
// every warp has finished reading.  Returns after a barrier past the last
// products, so that the caller may write the layer's output over its
// input.
template <int H, int N>
__device__ __forceinline__ void fwd_products(
    float (&acc)[2][Tiling<H>::template Cols<N>::NTW][4], int l,
    const float* bias, int& it, const FParams& p, const float* act,
    const float* ipe, float* ws, const Warp& w, int tid) {
  using S = FShape<H>;
  using C = typename Tiling<H>::template Cols<N>;
#pragma unroll
  for (int jj = 0; jj < C::NTW; ++jj) {
    const int j = w.cg + S::WN * jj;
    if (C::TILES % S::WN != 0 && j >= C::TILES) continue;
    const float2 bb = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * w.t);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      acc[mi][jj][0] = acc[mi][jj][2] = bb.x;
      acc[mi][jj][1] = acc[mi][jj][3] = bb.y;
    }
  }
  const int ni = S::ipe_slices(l), ns = S::slices(l);
#pragma unroll 1
  for (int i = 0; i < ns; ++i, ++it) {
    cp_wait_all();
    __syncthreads();  // slice it (and the caller's tiles) visible to all
    float* next = ws + ((it + 1) & 1) * S::STAGE;
    if (i + 1 < ns)
      copy_fwd<H>(next, p, l, i + 1, tid);
    else if (l + 1 < NLAYER)
      copy_fwd<H>(next, p, l + 1, 0, tid);
    const float* stage = ws + (it & 1) * S::STAGE;
    if (i < ni)
      slice_products<N, S::WN>(acc, ipe + i * KS, IPE_LD, stage, S::WS_LD, 1,
                               w);
    else
      slice_products<N, S::WN>(acc, act + (i - ni) * KS, S::ACT_LD, stage,
                               S::WS_LD, 1, w);
  }
  __syncthreads();  // every warp is done with the layer's input
}

// ENC mode: the tile's IPE from the raw means and covariances, in the
// direct form of the TPU kernel's _enc_kernel and of core/math.py::
// integrated_pos_enc(double_angle=False), all in f32: for level l and
// coordinate j, y = x_j 2^l, v = cov_j 4^l (exact scalings),
//   ipe[l*3 + j] = exp(-v / 2) sin(wrap(y)),
//   ipe[48 + l*3 + j] = exp(-v / 2) sin(wrap(y + (float)(pi / 2))),
// wrap(y) = |y| < 100 pi ? y : floor-mod(y, 100 pi) (safe_sin's reduction,
// exact with fmodf; the accurate libdevice sinf / expf, no fast math).  An
// item is (row, coordinate, half of the levels); rows past n are zero.
__device__ __forceinline__ float wrap_trig(float y) {
  constexpr float T = 314.159265358979323846f;  // (float)(100 pi)
  if (fabsf(y) < T) return y;
  float m = fmodf(y, T);
  if (m < 0.f) m += T;
  return m;
}

template <int BM>
__device__ __forceinline__ void encode_tile(const FParams& p, float* ipe,
                                            long long r0, int tid) {
  constexpr int HALF = IPE / 2;  // 16 levels x 3 coordinates
  constexpr int LPI = 8;         // levels per item
  constexpr float HALF_PI = 1.57079632679489661923f;
  for (int c = tid; c < BM * 3 * 2; c += THREADS) {
    const int l0 = c / (BM * 3) * LPI, rem = c % (BM * 3);
    const int r = rem / 3, j = rem % 3;
    float* dst = ipe + r * IPE_LD + l0 * 3 + j;
    if (r0 + r >= p.n) {
#pragma unroll
      for (int i = 0; i < LPI; ++i) dst[i * 3] = dst[HALF + i * 3] = 0.f;
      continue;
    }
    const float f = (float)(1 << l0);
    float y = p.means[(r0 + r) * 3 + j] * f;
    float v = p.covs[(r0 + r) * 3 + j] * (f * f);
#pragma unroll
    for (int i = 0; i < LPI; ++i) {
      const float att = expf(-0.5f * v);
      dst[i * 3] = att * sinf(wrap_trig(y));
      dst[HALF + i * 3] = att * sinf(wrap_trig(y + HALF_PI));
      y *= 2.f;
      v *= 4.f;
    }
  }
}

template <int H, bool ENC>
__global__ void __launch_bounds__(THREADS, 1)
    float_fwd_kernel(const __grid_constant__ FParams p) {
  using S = FShape<H>;
  extern __shared__ float4 smem_f4[];
  float* act = reinterpret_cast<float*>(smem_f4);
  float* ipe = act + S::BM * S::ACT_LD;
  float* ws = ipe + S::BM * IPE_LD;
  const int tid = threadIdx.x;
  const Warp w = warp_of<H>(tid);
  const long long r0 = (long long)blockIdx.x * S::BM;

  copy_fwd<H>(ws, p, 0, 0, tid);
  int it = 0;
  if (ENC) {
    encode_tile<S::BM>(p, ipe, r0, tid);
  } else {
    for (int q = tid; q < S::BM * (IPE / 4); q += THREADS) {
      const int r = q / (IPE / 4), c4 = q % (IPE / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < p.n)
        v = __ldg(reinterpret_cast<const float4*>(p.ipe + (r0 + r) * IPE) + c4);
      *reinterpret_cast<float4*>(ipe + r * IPE_LD + 4 * c4) = v;
    }
  }

  // The thread's four rows: w.row + 16 mi + 8 h2 + g.
  auto row_of = [&](int mi, int h2) { return w.row + mi * 16 + h2 * 8 + w.g; };

  // Trunk and fc_feat: bias (+ relu) back into act, and into the stash.
  {
    using C = typename Tiling<H>::template Cols<H>;
    float acc[2][C::NTW][4];
#pragma unroll 1
    for (int l = 0; l <= L_FEAT; ++l) {
      const float* bias =
          p.b + (l < NTRUNK ? p.b_off[0] + l * H : p.b_off[1]);
      fwd_products<H, H>(acc, l, bias, it, p, act, ipe, ws, w, tid);
      const bool relu = l < NTRUNK;
#pragma unroll
      for (int jj = 0; jj < C::NTW; ++jj) {
        const int col = (w.cg + S::WN * jj) * 8 + 2 * w.t;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int row = row_of(mi, h2);
            float2 v = make_float2(acc[mi][jj][2 * h2], acc[mi][jj][2 * h2 + 1]);
            if (relu) v = make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
            *reinterpret_cast<float2*>(act + row * S::ACT_LD + col) = v;
            if (p.stash != nullptr && r0 + row < p.n)
              *reinterpret_cast<float2*>(
                  p.stash + ((long long)l * p.n + r0 + row) * H + col) = v;
          }
      }
    }
  }
  // The dir layer (alpha rides it as output column 128): h = relu(. +
  // dproj[ray]) back into act columns 0..127 and the stash; alpha to out.
  {
    using C = typename Tiling<H>::template Cols<DHP>;
    float acc[2][C::NTW][4];
    fwd_products<H, DHP>(acc, L_DIR, p.b + p.b_off[2], it, p, act, ipe, ws, w,
                         tid);
#pragma unroll
    for (int jj = 0; jj < C::NTW; ++jj) {
      const int j = w.cg + S::WN * jj;
      if (C::TILES % S::WN != 0 && j >= C::TILES) continue;
      const int col = j * 8 + 2 * w.t;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = row_of(mi, h2);
          const long long grow = r0 + row;
          const float2 v =
              make_float2(acc[mi][jj][2 * h2], acc[mi][jj][2 * h2 + 1]);
          if (col < DH) {
            float2 h = make_float2(0.f, 0.f);
            if (grow < p.n) {
              const float2 d = *reinterpret_cast<const float2*>(
                  p.dproj + grow / p.samples * DH + col);
              h = make_float2(fmaxf(v.x + d.x, 0.f), fmaxf(v.y + d.y, 0.f));
              if (p.stash_h != nullptr)
                *reinterpret_cast<float2*>(p.stash_h + grow * DH + col) = h;
            }
            *reinterpret_cast<float2*>(act + row * S::ACT_LD + col) = h;
          } else if (col == DH && grow < p.n) {
            p.out[grow * p.out_dim + 3] = v.x;
          }
        }
    }
  }
  // Heads: rgb -> out[:, 0:3], (mu, sigma) -> out[:, 4:6].
  {
    using C = typename Tiling<H>::template Cols<NHEAD>;
    float acc[2][C::NTW][4];
    fwd_products<H, NHEAD>(acc, L_HEAD, p.b + p.b_off[3], it, p, act, ipe,
                           ws, w, tid);
#pragma unroll
    for (int jj = 0; jj < C::NTW; ++jj) {
      const int j = w.cg + S::WN * jj;
      if (C::TILES % S::WN != 0 && j >= C::TILES) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const long long grow = r0 + row_of(mi, h2);
          if (grow >= p.n) continue;
          float* o = p.out + grow * p.out_dim;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * 8 + 2 * w.t + e;
            const float v = acc[mi][jj][2 * h2 + e];
            if (col < 3)
              o[col] = v;
            else if (col < 5 && p.out_dim == 6)
              o[col + 1] = v;
          }
        }
    }
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

template <int H, bool ENC>
cudaError_t launch_fwd(const FParams& p, cudaStream_t st) {
  using S = FShape<H>;
  // The opt-in to S::SMEM bytes of dynamic shared memory: once per process
  // and instantiation, not per launch.
  static const cudaError_t setup = cudaFuncSetAttribute(
      float_fwd_kernel<H, ENC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM);
  if (setup != cudaSuccess) return setup;
  const unsigned grid = (unsigned)((p.n + S::BM - 1) / S::BM);
  float_fwd_kernel<H, ENC><<<grid, THREADS, S::SMEM, st>>>(p);
  return cudaGetLastError();
}

template <bool ENC>
cudaError_t run_fwd(FParams& p, const void* dirs, int hidden,
                    const long long* w_off, const long long* b_off,
                    cudaStream_t st) {
  for (int i = 0; i < NW; ++i) p.w_off[i] = w_off[i];
  for (int i = 0; i < NB_OFF; ++i) p.b_off[i] = b_off[i];
  const long long rays = p.n / p.samples;
  float_dir_proj_kernel<<<(unsigned)((rays + DIR_RAYS - 1) / DIR_RAYS), DH, 0,
                        st>>>(static_cast<const float*>(dirs),
                              p.w + w_off[W_DIRS], const_cast<float*>(p.dproj),
                              rays);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (hidden) {
    case 64: return launch_fwd<64, ENC>(p, st);
    case 128: return launch_fwd<128, ENC>(p, st);
    case 192: return launch_fwd<192, ENC>(p, st);
    case 256: return launch_fwd<256, ENC>(p, st);
    case 384: return launch_fwd<384, ENC>(p, st);
    case 512: return launch_fwd<512, ENC>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ chain

struct CParams {
  const float* g;        // [n, out_dim]
  const float* w;        // packed weights (f32)
  const float* stash;    // [9, n, H]
  const float* stash_h;  // [n, 128]
  float* gs;             // [n, 16]: g_rgb | g_mu, g_sigma | 0
  float* gd;             // [n, 144]: g_h | g_alpha | 0
  float* gt;             // [9, n, H]: g_0 .. g_7, g_feat
  float* bpart;          // [tiles, nb] bias-gradient partial rows
  long long n;
  int out_dim;
  int nb;
  long long w_off[NW];
  long long b_off[NB_OFF];
};

template <int H>
struct CShape : Tiling<H> {
  static_assert(H % 64 == 0 && H <= 512, "no float32 backward plan");
  using Tiling<H>::BM;
  using Tiling<H>::RG;
  static constexpr int G_W = H > DHP ? H : DHP;  // the cotangent tile
  static constexpr int G_LD = G_W + 4;
  static constexpr int MAXN = H > DH ? H : DH;  // product widths: 128, H
  // Stage rows: k (the weights' output rows), n columns; a row stride of
  // 8 modulo 32 keeps B-fragment loads apart.  Two stages.
  static constexpr int STAGE = KS * (MAXN + 8);
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BM * G_LD + BM * GS_LD + 2 * STAGE +
                       RG * MAXN + 32);
  static_assert(SMEM <= MAX_SMEM, "the plan exceeds a block's shared memory");
  // Product q multiplies by layer(q)'s weights [K = its outputs, N = its
  // inputs from col0]: heads, dir, fc_feat, then W7 .. W1 (x-part of W5).
  __host__ __device__ static constexpr int layer(int q) { return L_HEAD - q; }
  __host__ __device__ static constexpr int kdim(int q) {
    return q == 0 ? NHEAD : (q == 1 ? DHP : H);
  }
  __host__ __device__ static constexpr int ndim(int q) { return q == 0 ? DH : H; }
  __host__ __device__ static constexpr int kin(int q) {
    return q == 0 ? DH : (layer(q) == SKIP ? IPE + H : H);
  }
  __host__ __device__ static constexpr int col0(int q) {
    return layer(q) == SKIP ? IPE : 0;
  }
};

constexpr int NQ = 10;

// Slice s of product q, weight rows KS s .. KS s + 15 and N columns, copied
// into `stage` (rows N + 8 floats apart).
template <int H>
__device__ __forceinline__ void copy_chain(float* stage, const CParams& p,
                                           int q, int s, int tid) {
  using S = CShape<H>;
  const int n4 = S::ndim(q) / 4, kin = S::kin(q), ld = S::ndim(q) + 8;
  const float* src = p.w + p.w_off[S::layer(q)] + (long long)s * KS * kin +
                     S::col0(q);
  for (int e = tid; e < KS * n4; e += THREADS)
    cp_async16(stage + (e / n4) * ld + 4 * (e % n4),
               src + (long long)(e / n4) * kin + 4 * (e % n4));
  cp_commit();
}

// acc = A [the warp's rows, K] @ W slices for its n8 tiles of N; A is the
// small tile for the heads, the cotangent tile otherwise.  The stage
// discipline is fwd_products'.
template <int H, int N>
__device__ __forceinline__ void chain_products(
    float (&acc)[2][Tiling<H>::template Cols<N>::NTW][4], int q, int& it,
    const CParams& p, const float* a_tile, int lda, float* ws, const Warp& w,
    int tid) {
  using S = CShape<H>;
  using C = typename Tiling<H>::template Cols<N>;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int jj = 0; jj < C::NTW; ++jj)
      acc[mi][jj][0] = acc[mi][jj][1] = acc[mi][jj][2] = acc[mi][jj][3] = 0.f;
  const int ns = S::kdim(q) / KS;
#pragma unroll 1
  for (int s = 0; s < ns; ++s, ++it) {
    cp_wait_all();
    __syncthreads();
    float* next = ws + ((it + 1) & 1) * S::STAGE;
    if (s + 1 < ns)
      copy_chain<H>(next, p, q, s + 1, tid);
    else if (q + 1 < NQ)
      copy_chain<H>(next, p, q + 1, 0, tid);
    slice_products<N, S::WN>(acc, a_tile + s * KS, lda,
                             ws + (it & 1) * S::STAGE, 1, N + 8, w);
  }
  __syncthreads();
}

// The epilogue of a product of width N: relu mask (from `mask`, [n, ld_m]
// f32, or none), the result back into the cotangent tile and out to `slab`
// ([n, ld_s]), and the warp's column sums into red[row group][column].
template <int H, int N>
__device__ __forceinline__ void chain_epilogue(
    float (&acc)[2][Tiling<H>::template Cols<N>::NTW][4], const float* mask,
    int ld_m, float* slab, int ld_s, float* gtile, float* red, long long r0,
    long long n, const Warp& w, int lane) {
  using S = CShape<H>;
  using C = typename Tiling<H>::template Cols<N>;
#pragma unroll
  for (int jj = 0; jj < C::NTW; ++jj) {
    const int col = (w.cg + S::WN * jj) * 8 + 2 * w.t;
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = w.row + mi * 16 + h2 * 8 + w.g;
        const long long grow = r0 + row;
        float2 v = make_float2(acc[mi][jj][2 * h2], acc[mi][jj][2 * h2 + 1]);
        if (mask != nullptr) {
          float2 m = make_float2(0.f, 0.f);
          if (grow < n)
            m = *reinterpret_cast<const float2*>(mask + grow * ld_m + col);
          v = make_float2(m.x > 0.f ? v.x : 0.f, m.y > 0.f ? v.y : 0.f);
        }
        *reinterpret_cast<float2*>(gtile + row * S::G_LD + col) = v;
        if (grow < n)
          *reinterpret_cast<float2*>(slab + grow * ld_s + col) = v;
        sum.x += v.x;
        sum.y += v.y;
      }
    sum.x = sum_rows(sum.x);
    sum.y = sum_rows(sum.y);
    if (lane < 4) {
      red[w.row / 32 * S::MAXN + col] = sum.x;
      red[w.row / 32 * S::MAXN + col + 1] = sum.y;
    }
  }
}

template <int H>
__global__ void __launch_bounds__(THREADS, 1)
    float_chain_kernel(const __grid_constant__ CParams p) {
  using S = CShape<H>;
  constexpr int BM = S::BM;
  extern __shared__ float4 smem_f4[];
  float* gtile = reinterpret_cast<float*>(smem_f4);
  float* gsmall = gtile + BM * S::G_LD;
  float* ws = gsmall + BM * GS_LD;
  float* red = ws + 2 * S::STAGE;
  float* small_sums = red + S::RG * S::MAXN;  // the small tile's 17 sums
  const int tid = threadIdx.x, lane = tid & 31;
  const Warp w = warp_of<H>(tid);
  const long long tile = blockIdx.x, r0 = tile * BM;
  float* bp = p.bpart + tile * p.nb;

  copy_chain<H>(ws, p, 0, 0, tid);
  int it = 0;
  // The small tile (g_heads) and g_alpha with the zero columns after it in
  // the cotangent tile (columns 128..143, read by the dir product).
  for (int e = tid; e < BM * GS_W; e += THREADS) {
    const int r = e / GS_W, c = e % GS_W;
    const long long gr = r0 + r;
    float v = 0.f;
    if (gr < p.n) {
      const float* gg = p.g + gr * p.out_dim;
      if (c < 3)
        v = gg[c];
      else if (c < 5 && p.out_dim == 6)
        v = gg[c + 1];
      p.gs[gr * GS_W + c] = v;
    }
    gsmall[r * GS_LD + c] = v;
    gtile[r * S::G_LD + DH + c] =
        (c == 0 && gr < p.n) ? p.g[gr * p.out_dim + 3] : 0.f;
  }

  // A partial row, after a barrier: column c of red summed over the row
  // groups in order.
  auto bias_rows = [&](int n, float* dst) {
    for (int c = tid; c < n; c += THREADS) {
      float s = red[c];
#pragma unroll
      for (int rg = 1; rg < S::RG; ++rg) s += red[rg * S::MAXN + c];
      dst[c] = s;
    }
  };

  // Heads: g_h = mask(h > 0, g_heads @ W_heads) -> tile columns 0..127, gd.
  {
    float acc[2][Tiling<H>::template Cols<DH>::NTW][4];
    chain_products<H, DH>(acc, 0, it, p, gsmall, GS_LD, ws, w, tid);
    // d_b_heads, d_b_alpha: column sums of the small tile and of g_alpha,
    // row after row.
    if (tid < GS_W + 1) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r)
        s += tid < GS_W ? gsmall[r * GS_LD + tid] : gtile[r * S::G_LD + DH];
      small_sums[tid] = s;
    }
    chain_epilogue<H, DH>(acc, p.stash_h, DH, p.gd, DHP, gtile, red, r0, p.n,
                          w, lane);
    __syncthreads();
    bias_rows(DH, bp + p.b_off[2]);
    if (tid < DHP - DH) {
      bp[p.b_off[2] + DH + tid] = tid == 0 ? small_sums[GS_W] : 0.f;
      for (int r = 0; r < BM; ++r)  // gd's columns 128..143
        if (r0 + r < p.n)
          p.gd[(r0 + r) * DHP + DH + tid] = gtile[r * S::G_LD + DH + tid];
    }
    if (tid < NHEAD) bp[p.b_off[3] + tid] = small_sums[tid];
  }
  // The dir layer (g_feat, no mask), fc_feat and W7 .. W1 (masks x7 .. x0).
  {
    float acc[2][Tiling<H>::template Cols<H>::NTW][4];
#pragma unroll 1
    for (int q = 1; q < NQ; ++q) {
      chain_products<H, H>(acc, q, it, p, gtile, S::G_LD, ws, w, tid);
      // Product q >= 2 gives g_i, i = layer(q) - 1, masked by x_i; the dir
      // product gives g_feat (slab 8).
      const int slab = q == 1 ? NTRUNK : S::layer(q) - 1;
      chain_epilogue<H, H>(acc, q == 1 ? nullptr : p.stash + slab * p.n * H,
                           H, p.gt + slab * p.n * H, H, gtile, red, r0, p.n,
                           w, lane);
      __syncthreads();
      bias_rows(H, bp + (q == 1 ? p.b_off[1] : p.b_off[0] + slab * H));
    }
  }
}

// g_dproj[ray, c] = the sum over the ray's rows of g_h[row, c] (gd's
// columns 0..127), in row order, in f32.
__global__ void float_dproj_grad_kernel(const float* gd, float* gdp,
                                      int samples) {
  const long long ray = blockIdx.x;
  const int c = threadIdx.x;
  const float* src = gd + ray * samples * DHP + c;
  float s = 0.f;
  for (int k = 0; k < samples; ++k) s += src[(long long)k * DHP];
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
  for (int i = c; i < here * DIRS; i += DH) d[i / DIRS][i % DIRS] = dirs[r0 * DIRS + i];
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

__global__ void float_dirs_grad_reduce_kernel(const float* part, float* gw_dirs,
                                            int blocks) {
  const int j = blockIdx.x, c = threadIdx.x;
  float s = 0.f;
  if (j < DIRS)
    for (int b = 0; b < blocks; ++b) s += part[((long long)b * DIRS + j) * DH + c];
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

constexpr int WT = 128;        // output tile: WT rows (out) x WT columns (in)
constexpr int WLD = WT + 8;    // stage row stride: 8 modulo 32
constexpr int WPRE = KS * WT / 4 / THREADS;  // float4s per thread and operand
constexpr int MAX_MATS = 12;

// dst[m * ld_dst + c] = sum over rows r of a[r, m] * b[r, c], m < M, c < nc:
// act^T g for one packed weight matrix (a the cotangent slab, b the
// activation the layer reads).
struct WMat {
  const float* a;
  const float* b;
  long long part;  // float offset of its partials [splits, M, nc]
  long long dst;   // float offset into gw
  long long elem_begin;  // first element of the matrix in the reduce launch
  int lda, ldb, m, nc, ld_dst;
  int ctiles, cta_begin;
};

struct WParams {
  WMat mat[MAX_MATS];
  int nmat, splits;
  long long rows_per_split, n;
  float* part;
  float* gw;
};

__device__ __forceinline__ void fetch_wgrad(float4 (&pa)[WPRE],
                                            float4 (&pb)[WPRE], const WMat& M,
                                            long long r, long long r_end,
                                            int m0, int c0, int tid) {
#pragma unroll
  for (int j = 0; j < WPRE; ++j) {
    const int e = tid + j * THREADS, k = e / (WT / 4), c4 = e % (WT / 4);
    const bool in = r + k < r_end;
    pa[j] = in && m0 + 4 * c4 < M.m
                ? __ldg(reinterpret_cast<const float4*>(
                      M.a + (r + k) * M.lda + m0 + 4 * c4))
                : make_float4(0.f, 0.f, 0.f, 0.f);
    pb[j] = in && c0 + 4 * c4 < M.nc
                ? __ldg(reinterpret_cast<const float4*>(
                      M.b + (r + k) * M.ldb + c0 + 4 * c4))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    float_wgrad_kernel(const __grid_constant__ WParams P) {
  __shared__ __align__(16) float as[KS * WLD];
  __shared__ __align__(16) float bs[KS * WLD];
  int mi = 0;
  while (mi + 1 < P.nmat && (int)blockIdx.x >= P.mat[mi + 1].cta_begin) ++mi;
  const WMat& M = P.mat[mi];
  const int local = blockIdx.x - M.cta_begin;
  const int split = local % P.splits, tile = local / P.splits;
  const int m0 = tile / M.ctiles * WT, c0 = tile % M.ctiles * WT;
  const long long rb = split * P.rows_per_split;
  const long long re = min(P.n, rb + P.rows_per_split);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wc = (warp & 1) * 64;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  float4 pa[WPRE], pb[WPRE];
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < WPRE; ++j) {
      const int e = tid + j * THREADS, k = e / (WT / 4), c4 = e % (WT / 4);
      *reinterpret_cast<float4*>(as + k * WLD + 4 * c4) = pa[j];
      *reinterpret_cast<float4*>(bs + k * WLD + 4 * c4) = pb[j];
    }
  };
  if (rb < re) {
    fetch_wgrad(pa, pb, M, rb, re, m0, c0, tid);
    store();
  }
  __syncthreads();
#pragma unroll 1
  for (long long r = rb; r < re; r += KS) {
    if (r + KS < re) fetch_wgrad(pa, pb, M, r + KS, re, m0, c0, tid);
    AFrag af[2][2];  // [k8 step][m16 tile]
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = as + (ks * 8 + t) * WLD + wm + i * 16 + g;
        af[ks][i].set(a[0], a[8], a[4 * WLD], a[4 * WLD + 8]);
      }
    // A chunk's products into a zeroed partial sum, then a rounded add (see
    // slice_products): these sums run over ~10^4 rows.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float part[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float* b = bs + (ks * 8 + t) * WLD + wc + j * 8 + g;
        BFrag bf;
        bf.set(b[0], b[4 * WLD]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma3(part[i], af[ks][i], bf);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][e];
    }
    __syncthreads();
    if (r + KS < re) {
      store();
      __syncthreads();
    }
  }

  float* out = P.part + M.part + (long long)split * M.m * M.nc;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int m = m0 + wm + i * 16 + g + 8 * h2;
      if (m >= M.m) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + wc + j * 8 + 2 * t;
        if (c < M.nc)
          *reinterpret_cast<float2*>(out + (long long)m * M.nc + c) =
              make_float2(acc[i][j][2 * h2], acc[i][j][2 * h2 + 1]);
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
  const long long local = e - M.elem_begin, count = (long long)M.m * M.nc;
  const float* src = P.part + M.part + local;
  float s = 0.f;
  for (int sp = 0; sp < P.splits; ++sp) s += src[sp * count];
  P.gw[M.dst + local / M.nc * M.ld_dst + local % M.nc] = s;
}

// ------------------------------------------------------------------ host

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

bool known_width(int hidden) {
  return hidden == 64 || hidden == 128 || hidden == 192 || hidden == 256 ||
         hidden == 384 || hidden == 512;
}

long long chain_tiles(long long n, int hidden) {
  return (n + tile_rows(hidden) - 1) / tile_rows(hidden);
}

// The weight-gradient matrices in the packed layout (w_off may be null for
// the workspace query: only the sizes are read then), their tiles, and the
// split of the rows: about two blocks per SM over all tiles.
struct WPlan {
  WParams P;
  long long part_floats, elems;
  int ctas;
};

WPlan make_wplan(long long n, int hidden, int sms, const long long* w_off,
                 const float* ipe, const float* stash, const float* stash_h,
                 const float* gs, const float* gd, const float* gt) {
  WPlan W = {};
  WParams& P = W.P;
  static const long long no_off[NW] = {};
  const long long* wo = w_off != nullptr ? w_off : no_off;
  const long long h = hidden, slab = n * h;
  auto add = [&](const float* a, int lda, int m, const float* b, int ldb,
                 int nc, long long dst, int ld_dst) {
    WMat& M = P.mat[P.nmat++];
    M.a = a;
    M.lda = lda;
    M.m = m;
    M.b = b;
    M.ldb = ldb;
    M.nc = nc;
    M.dst = dst;
    M.ld_dst = ld_dst;
    M.ctiles = (nc + WT - 1) / WT;
  };
  const float* gt_or0 = gt;  // null in the workspace query
  auto at = [&](const float* base, long long off) {
    return base != nullptr ? base + off : nullptr;
  };
  for (int i = 1; i < NTRUNK; ++i) {  // W_i [H, kin] from g_i, x_{i-1}
    const int kin = i == SKIP ? IPE + hidden : hidden;
    add(at(gt_or0, i * slab), hidden, hidden, at(stash, (i - 1) * slab),
        hidden, hidden, wo[i] + (i == SKIP ? IPE : 0), kin);
  }
  add(at(gt_or0, SKIP * slab), hidden, hidden, ipe, IPE, IPE, wo[SKIP],
      IPE + hidden);
  add(gt_or0, hidden, hidden, ipe, IPE, IPE, wo[0], IPE);
  add(at(gt_or0, NTRUNK * slab), hidden, hidden, at(stash, (NTRUNK - 1) * slab),
      hidden, hidden, wo[W_FEAT], hidden);
  // The dir layer [144, H]: g_h | g_alpha | 0 against feat.
  add(gd, DHP, DHP, at(stash, NTRUNK * slab), hidden, hidden, wo[W_DIR],
      hidden);
  add(gs, GS_W, NHEAD, stash_h, DH, DH, wo[W_HEAD], DH);

  int tiles = 0;
  for (int i = 0; i < P.nmat; ++i)
    tiles += (P.mat[i].m + WT - 1) / WT * P.mat[i].ctiles;
  int splits = (2 * sms + tiles - 1) / tiles;
  const long long max_splits = (n + KS - 1) / KS;
  if (splits > max_splits) splits = (int)max_splits;
  if (splits < 1) splits = 1;
  P.splits = splits;
  P.rows_per_split = ((n + splits - 1) / splits + KS - 1) / KS * KS;
  P.n = n;
  long long part = 0, elems = 0;
  int ctas = 0;
  for (int i = 0; i < P.nmat; ++i) {
    WMat& M = P.mat[i];
    M.part = part;
    M.elem_begin = elems;
    M.cta_begin = ctas;
    part += (long long)splits * M.m * M.nc;
    elems += (long long)M.m * M.nc;
    ctas += (M.m + WT - 1) / WT * M.ctiles * splits;
  }
  W.part_floats = part;
  W.elems = elems;
  W.ctas = ctas;
  return W;
}

struct Layout {
  size_t gs, gd, gt, bpart, gdp, dpart, part, total;
};

Layout layout(long long n, int samples, int hidden, long long part_floats) {
  const long long rays = n / samples;
  const long long nb = 9LL * hidden + DHP + NHEAD;
  Layout L;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  L.gs = take(n * GS_W * sizeof(float));
  L.gd = take(n * DHP * sizeof(float));
  L.gt = take((size_t)(NTRUNK + 1) * n * hidden * sizeof(float));
  L.bpart = take(chain_tiles(n, hidden) * nb * sizeof(float));
  L.gdp = take(rays * DH * sizeof(float));
  L.dpart = take((rays + DG_RAYS - 1) / DG_RAYS * DIRS * DH * sizeof(float));
  L.part = take(part_floats * sizeof(float));
  L.total = off;
  return L;
}

template <int H>
cudaError_t launch_chain(const CParams& p, cudaStream_t st) {
  using S = CShape<H>;
  static const cudaError_t setup = cudaFuncSetAttribute(
      float_chain_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM);  // once per process and instantiation
  if (setup != cudaSuccess) return setup;
  float_chain_kernel<H><<<(unsigned)chain_tiles(p.n, H), THREADS, S::SMEM,
                          st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The float32 forward on `stream`: the dir projection, then the network at
// width `hidden`.  Device pointers: ipe [n, 96] f32, dirs [n / samples, 27]
// f32, packed f32 weights and biases, dproj [n / samples, 128] f32 scratch,
// out [n, 4|6] f32, and in stash mode stash [9, n, hidden] and stash_h
// [n, 128] f32 (both null in render mode).  w_off (12 entries) and b_off
// (4) are host arrays.  Returns a cudaError_t.
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
  p.ipe = static_cast<const float*>(ipe);
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.dproj = static_cast<const float*>(dproj);
  p.out = static_cast<float*>(out);
  p.stash = static_cast<float*>(stash);
  p.stash_h = static_cast<float*>(stash_h);
  p.n = n;
  p.samples = samples;
  p.out_dim = depth_head ? 6 : 4;
  return run_fwd<false>(p, dirs, hidden, w_off, b_off,
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
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.dproj = static_cast<const float*>(dproj);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.samples = samples;
  p.out_dim = depth_head ? 6 : 4;
  return run_fwd<true>(p, dirs, hidden, w_off, b_off,
                       static_cast<cudaStream_t>(stream));
}

// Bytes of device workspace that ddnerf_fused_mlp_bwd_f32 needs.
extern "C" long long ddnerf_fused_mlp_bwd_workspace_f32(long long n,
                                                        int samples,
                                                        int hidden) {
  if (n <= 0 || samples <= 0 || n % samples || !known_width(hidden)) return -1;
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  const WPlan W = make_wplan(n, hidden, sms, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, nullptr);
  return (long long)layout(n, samples, hidden, W.part_floats).total;
}

// Parameter gradients of the float32 network on `stream`.  Device
// pointers: ipe [n, 96] f32, dirs [n / samples, 27] f32, g [n, 4|6] f32,
// the forward's stash [9, n, hidden] and stash_h [n, 128] f32, packed f32
// weights w; outputs gw (f32, laid out as w) and gb (f32, laid out as the
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
  if (!known_width(hidden)) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long rays = n / samples;
  const int nb = 9 * hidden + DHP + NHEAD;
  if (b_off[3] + NHEAD != nb) return cudaErrorInvalidValue;
  const WPlan probe = make_wplan(n, hidden, sms, w_off, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, nullptr);
  const Layout L = layout(n, samples, hidden, probe.part_floats);
  if (ws_bytes < (long long)L.total) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* base = static_cast<unsigned char*>(ws);

  CParams p = {};
  p.g = static_cast<const float*>(g);
  p.w = static_cast<const float*>(w);
  p.stash = static_cast<const float*>(stash);
  p.stash_h = static_cast<const float*>(stash_h);
  p.gs = reinterpret_cast<float*>(base + L.gs);
  p.gd = reinterpret_cast<float*>(base + L.gd);
  p.gt = reinterpret_cast<float*>(base + L.gt);
  p.bpart = reinterpret_cast<float*>(base + L.bpart);
  p.n = n;
  p.out_dim = depth_head ? 6 : 4;
  p.nb = nb;
  for (int i = 0; i < NW; ++i) p.w_off[i] = w_off[i];
  for (int i = 0; i < NB_OFF; ++i) p.b_off[i] = b_off[i];
  switch (hidden) {
    case 64: e = launch_chain<64>(p, st); break;
    case 128: e = launch_chain<128>(p, st); break;
    case 192: e = launch_chain<192>(p, st); break;
    case 256: e = launch_chain<256>(p, st); break;
    case 384: e = launch_chain<384>(p, st); break;
    default: e = launch_chain<512>(p, st); break;
  }
  if (e != cudaSuccess) return e;

  float* gdp = reinterpret_cast<float*>(base + L.gdp);
  float* dpart = reinterpret_cast<float*>(base + L.dpart);
  float_dproj_grad_kernel<<<(unsigned)rays, DH, 0, st>>>(p.gd, gdp, samples);
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

  WPlan W = make_wplan(n, hidden, sms, w_off, static_cast<const float*>(ipe),
                       p.stash, p.stash_h, p.gs, p.gd, p.gt);
  W.P.part = reinterpret_cast<float*>(base + L.part);
  W.P.gw = static_cast<float*>(gw);
  float_wgrad_kernel<<<(unsigned)W.ctas, THREADS, 0, st>>>(W.P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  float_wgrad_reduce_kernel<<<(unsigned)((W.elems + 255) / 256), 256, 0, st>>>(
      W.P, W.elems);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  float_bias_reduce_kernel<<<(nb + BR_COLS - 1) / BR_COLS, BR_COLS * BR_GROUPS, 0,
                           st>>>(p.bpart, static_cast<float*>(gb),
                                 chain_tiles(n, hidden), nb);
  return cudaGetLastError();
}
