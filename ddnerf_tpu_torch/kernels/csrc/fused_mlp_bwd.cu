// Fused NeRF MLP backward for Hopper (sm_90a): the parameter gradients of
// fused_mlp_fwd.cu for a cotangent g [N, 4|6], from the forward's stash.
//
// Replaces the TPU kernel ddnerf_tpu/kernels/fused_mlp_bwd.py::
// fused_mlp_backward (body _bwd_kernel) with the same rounding points:
//   g -> bf16 on entry;  g_heads = (g_rgb | g_mu, g_sigma), g_alpha = g[:, 3]
//   d_W_heads = h^T g_heads,  d_b_heads = sum g_heads                   (f32)
//   g_h = mask(h > 0, g_heads W_heads),  d_b_dir = sum g_h,  g_h_c = bf16(g_h)
//   d_Wd_feat = feat^T g_h_c,  d_w_alpha = feat^T g_alpha,  d_b_alpha = sum g_alpha
//   d_Wd_dirs = dirs^T g_dproj in f32, over the rays: per sample
//     (kernel_per_ray_dirs false, the JAX default) g_dproj[ray] = the f32 sum
//     of bf16(g_h) over the ray's K rows, the same products as the sum over
//     rows of dirs[ray(row)]^T bf16(g_h[row]); per ray (true), g_dproj[ray] =
//     bf16(the sum of g_h over them)
//   g_feat = g_h_c Wd_feat + g_alpha w_alpha,  d_bf = sum g_feat,  g_feat_c = bf16
//   d_Wf = x7^T g_feat_c,  gx = g_feat_c Wf
//   for i = 7..0: g_i = mask(x_i > 0, gx), d_b_i = sum g_i (before rounding),
//                 d_W_i = x_{i-1}^T bf16(g_i) (layer 0 reads ipe, layer 5
//                 [ipe | x4]),  gx = bf16(g_i) W_i (x-columns of W5; not at 0)
// Relu masks are the stash forward's: the mask bits it writes beside the bf16
// stash (mask_bits.cuh), set where the stashed value is > 0; every product
// is bf16 x bf16 with f32 accumulation; no input gradients (ipe and dirs are
// detached upstream).
//
// What bounds it on an H100: tensor-core throughput for the products (the
// cotangent chain is 10 matmuls per row, the weight gradients another 10),
// and device memory for what a design of separate passes must move: the
// bf16 cotangent slabs (~2 (10 H + 192) bytes per row) written by the chain
// and read by the weight gradients, and the stash read by both.
//
// Design.  The TPU kernel keeps ~3 MB of f32 gradient accumulators in VMEM
// across a sequential grid; here blocks run in parallel and in no order, and
// a 256 x 256 f32 accumulator alone exceeds a CTA's shared memory.  So the
// backward is separate passes, deterministic from run to run (no atomics,
// every sum across CTAs in a fixed order):
// (a) chain_kernel, on the forward's skeleton: persistent CTAs (one per SM)
//     walk 128-row tiles; one producer thread, two consumer warpgroups of 64
//     rows each.  Every product is wgmma m64 n{H, 128} k16 with the cotangent
//     tile as the swizzled K-major A operand in shared memory and the weights
//     as B.  The chain multiplies by the transpose of what the forward
//     multiplies by: the packed torch [out, in] weights are [k, n] here, so B
//     is MN-major, TMA boxes of 32 rows x 64 columns cut from the same packed
//     weights, through an mbarrier ring.  The relu masks are the forward's
//     bit words, laid out in this kernel's own fragment order: each
//     consumer thread copies its words of a product (16 bytes at width 256:
//     128 masks) into shared memory with cp.async before the product
//     starts (h's a tile ahead, under the dir product: the heads' product
//     is short), so they arrive under it, holding no registers, and no
//     epilogue waits for them.
//     An epilogue masks the accumulators, rounds them to bf16 back into the
//     cotangent tile (the next A operand), stores the tile to its slab with a
//     TMA store that runs under the next product, and reduces the f32 column
//     sums (the bias gradients) with shuffles to one partial row per tile and
//     warpgroup.  g_h also goes out in f32, and dproj_grad_kernel sums it per
//     ray in row order.  Widths 384 and 512 take the N-split plan of
//     fused_mlp_fwd.cu: 64-row tiles, both consumers on every row, consumer
//     w producing columns H/2 w .. H/2 w + H/2 - 1 of each product (of g_h,
//     64 w .. 64 w + 63), with a barrier of both consumers before and after
//     each write-back; the tile and a 2- or 4-stage ring then fit in shared
//     memory.
// (b) wgrad_kernel: act^T g over the row axis for every weight matrix, both
//     operands MN-major straight from TMA boxes of 64 rows (no transposing
//     copies), output tiles of 128 x {H, 128} (two consumer warpgroups, m64
//     each), a 4-stage ring, the rows split so that about one CTA per SM is
//     busy; a split's f32 partial tile goes to the workspace.  Tiles that
//     share rows of an activation run side by side, so the second reads L2.
//     Above width 256 an output tile is 128 x H/2 (an accumulator of H/2
//     floats per thread would not fit), and the units of one launch are at
//     most MAX_UNITS: the weight gradients of widths 384 and 512 take
//     several launches.  The dirs weight gradient (128 x 27 outputs) is
//     dirs_grad_partial_kernel's and dirs_grad_reduce_kernel's instead: a
//     float32 product, since its g_dproj is a float32 sum per sample (per
//     ray a bf16 value, which f32 holds exactly).
// (c) reduce_kernel / bias_reduce_kernel: sum the partials in a fixed order
//     into the packed f32 gradients, laid out as the packed weights and
//     biases of kernels/fused_mlp.py::pack_weights.

#include <type_traits>

#include "hopper_common.cuh"
#include "mask_bits.cuh"

namespace {

using namespace ddnerf;

constexpr int WG_ROWS = 64;       // rows of one wgmma (m64)
constexpr int NTHREADS = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr int KS = 32;            // k-rows of a streamed weight slice
constexpr int MAX_STAGES = 4;
constexpr int NQ = 10;            // chain products: heads, dir, feat, W7..W1
constexpr int L_FEAT = W_FEAT, L_DIR = W_DIR, L_HEAD = W_HEAD, NLAYER = 11;
constexpr int GS_W = 64;          // small slab: g_heads | g_alpha | zeros
constexpr int GS_ALPHA = 16;      // its column of g_alpha
constexpr int NSLAB = NTRUNK + 1; // gt slabs: bf16(g_0..g_7), g_feat_c
constexpr uint32_t WG_BYTES = WG_ROWS * 128;   // 64 rows of a [rows][64] block
constexpr uint32_t WBLOCK_BYTES = KS * 128;    // [KS][64] weights

// Rows per chain tile: 128 up to width 256, 64 in the N-split plan.
constexpr int chain_rows(int hidden) {
  return hidden > 256 ? WG_ROWS : 2 * WG_ROWS;
}

// ---------------------------------------------------------------- chain

struct ChainMaps {
  CUtensorMap w[NLAYER];  // layer l's weights [n_out, k_in], box [KS, 64]
  CUtensorMap gs;         // [n, 64], box [WG_ROWS, 64]
  CUtensorMap gd;         // [n, 128], box [WG_ROWS, 64]
  CUtensorMap gt;         // [9, n, H], box [1, WG_ROWS, 64]
};

struct ChainParams {
  const float* g;   // [n, out_dim]
  const uint32_t* bits;  // the relu masks' words (mask_bits.cuh)
  float* ghf;       // [n, 128] g_h, f32
  float* bpart;     // [2 tiles, nb] bias-gradient partial rows
  long long n;
  int out_dim;
  int nb;
  long long b_off[NB_OFF];
};

template <int H>
struct Shape {
  static_assert(H % 64 == 0 && H <= 512, "no backward plan for this width");
  // The N-split plan (see the top of the file) above width 256.
  static constexpr bool SPLIT = H > 256;
  static constexpr int BM = chain_rows(H);
  static constexpr int NW = SPLIT ? H / 2 : H;    // H-wide columns per consumer
  static constexpr int NH = SPLIT ? DH / 2 : DH;  // g_h columns per consumer
  static constexpr uint32_t BLOCK_BYTES = BM * 128;  // [BM][64] bf16
  static constexpr int WIDE = H > DH ? H : DH;
  static constexpr int BLOCKS = WIDE / 64;
  // Ring depth: four stages, two at width 512 (all that shared memory holds).
  static constexpr int STAGES = H > 384 ? 2 : MAX_STAGES;
  static constexpr uint32_t ACT_BYTES = BLOCKS * BLOCK_BYTES;
  static constexpr uint32_t GS_BYTES = BLOCK_BYTES;
  static constexpr uint32_t STAGE_BYTES = BLOCKS * WBLOCK_BYTES;
  // A consumer's column sums: a row per warp, then the small tile's sums.
  static constexpr int RED_W = SPLIT ? NW : WIDE;
  static constexpr int RED_FLOATS = 4 * RED_W + 4 * 32;  // per warpgroup
  static constexpr uint32_t RED_BYTES = 2 * RED_FLOATS * sizeof(float);
  // Each consumer's mask words of a trunk product and of h (mask_bits.cuh).
  static constexpr int SLOT_WORDS = MASK_WORDS_MAX + DH / 64;
  static constexpr uint32_t WORDS_BYTES = 2 * SLOT_WORDS * 512;
  static constexpr uint32_t BAR_BYTES = 128;
  // 1024 spare bytes to start the tiles on a 1024-byte boundary.
  static constexpr size_t SMEM = 1024 + ACT_BYTES + GS_BYTES +
                                 STAGES * STAGE_BYTES + RED_BYTES +
                                 WORDS_BYTES + BAR_BYTES;
  static_assert(SMEM <= MAX_SMEM, "the plan exceeds a block's shared memory");
  static_assert(NW / 64 <= MASK_WORDS_MAX && NH / 64 <= MASK_WORDS_MAX,
                "a consumer's mask words exceed its slots");
  // Product q multiplies the cotangent by layer(q)'s weights, columns col0
  // .. col0 + ncol, in nslices slices of KS rows.
  __host__ __device__ static constexpr int layer(int q) {
    return q < 3 ? L_HEAD - q : NQ - q;
  }
  __host__ __device__ static constexpr int ncol(int q) {
    return q == 0 ? DH : H;
  }
  __host__ __device__ static constexpr int col0(int q) {
    return layer(q) == SKIP ? IPE : 0;
  }
  // The dir layer: rows 0..127 (g_h_c), then the slice of row 128 (g_alpha).
  __host__ __device__ static constexpr int nslices(int q) {
    return q == 0 ? 1 : (q == 1 ? DH / KS + 1 : H / KS);
  }
};

struct Smem {
  uint32_t act, gs, ring, words;  // tiles, mask words
  uint32_t full, empty;           // mbarriers
};

// The producer: every weight slice of this CTA's tiles, in the order the
// consumers use them, as far ahead as the ring allows.
template <int H>
__device__ __forceinline__ void produce(const ChainMaps& maps, const Smem& s,
                                        long long tiles) {
  using S = Shape<H>;
  uint32_t it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll 1
    for (int q = 0; q < NQ; ++q) {
      const int ns = S::nslices(q), nblk = S::ncol(q) / 64;
      const CUtensorMap* wm = &maps.w[S::layer(q)];
#pragma unroll 1
      for (int i = 0; i < ns; ++i, ++it) {
        const uint32_t stage = it % S::STAGES, parity = (it / S::STAGES) & 1;
        mbar_wait(s.empty + 8 * stage, parity ^ 1);
        mbar_arrive_expect_tx(s.full + 8 * stage, nblk * WBLOCK_BYTES);
        for (int b = 0; b < nblk; ++b)
          tma_load_2d(s.ring + stage * S::STAGE_BYTES + b * WBLOCK_BYTES, wm,
                      S::col0(q) + b * 64, i * KS, s.full + 8 * stage);
      }
    }
  }
}

// acc = A @ W^T-slices for this warpgroup's 64 rows: `nact` slices whose A
// is the cotangent tile at `a_act`, then, if a_tail != 0, one slice whose A
// is the two k16 steps at a_tail (the weight rows past the layer's are
// zero-filled by TMA, so columns of A beyond them do not count).  `w_cols`
// is the byte offset in a stage of the 64-column block of the first output
// column.
// acc starts at zero and every product accumulates (see the forward: an
// accumulator that a product merely overwrites looks live to the compiler
// from the previous product on).  One slice's products stay in flight while
// the next slice is awaited; a stage is released (one arrival per warp) once
// its products have finished.
template <int H, int N>
__device__ __forceinline__ void products(float (&acc)[N / 2], int nact,
                                         uint32_t a_act, uint32_t a_tail,
                                         uint32_t w_cols, uint32_t& it,
                                         const Smem& s, int lane) {
  using S = Shape<H>;
  const int ns = nact + (a_tail != 0 ? 1 : 0);
  uint32_t prev = 0;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
#pragma unroll 1
  for (int i = 0; i < ns; ++i, ++it) {
    const uint32_t stage = it % S::STAGES, parity = (it / S::STAGES) & 1;
    mbar_wait(s.full + 8 * stage, parity);
    const uint32_t b = s.ring + stage * S::STAGE_BYTES + w_cols;
    // Slice i of the tile is k16 steps 2 i and 2 i + 1 of one 64-column
    // block; the tail's second step meets zero rows of the weights.
    const uint32_t a =
        i < nact ? a_act + (i >> 1) * S::BLOCK_BYTES + (i & 1) * 64 : a_tail;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk)
      wgmma_k16<N, 0, 1>(acc, smem_desc(a + kk * 32),
                         smem_desc_mn(b + kk * 2048, WBLOCK_BYTES));
    wgmma_commit();
    if (i > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(s.empty + 8 * prev);
    }
    prev = stage;
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(s.empty + 8 * prev);
}

// Sums over the 8 row groups g = lane / 4 of a warp, for C values per thread:
// a reduce-scatter in three exchanges (C / 2 + C / 4 + C / 8 shuffles instead
// of 3 C).  Afterwards v[i], i < C / 8, is the warp's sum of value number
// (C / 8) g + i.  The order of the additions is fixed.
template <int C>
__device__ __forceinline__ void warp_column_sums(float (&v)[C], int lane) {
  static_assert(C % 8 == 0, "C / 8 values per thread remain");
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int half = C >> (step + 1);
    const int bit = 16 >> step;  // lane bit of g's bit 2 - step
    const bool hi = (lane & bit) != 0;
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      if (i < half) {
        const float keep = hi ? v[half + i] : v[i];
        const float send = hi ? v[i] : v[half + i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
      }
    }
  }
}

// One consumer warpgroup: up to width 256, rows 64 wg .. 64 wg + 63 of
// every tile of the CTA; in the N-split plan every row of the tile and
// columns NW wg .. NW wg + NW - 1 of each product (64 wg .. of g_h).
template <int H>
__device__ __forceinline__ void consume(const ChainParams& p,
                                        const ChainMaps& maps, const Smem& s,
                                        unsigned char* smem, float* red,
                                        const uint32_t* words_sm,
                                        long long tiles, int wg, int tid) {
  using S = Shape<H>;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  // The narrow plan: this warpgroup's own barrier and rows of each block.
  // The N-split plan: a barrier of both consumers, every row, and its
  // column blocks (blk_w of the H-wide products, blk_h of g_h).
  const int bar_id = S::SPLIT ? 1 : 1 + wg;
  const int bar_threads = S::SPLIT ? 256 : 128;
  const uint32_t rows_at = S::SPLIT ? 0 : wg * WG_BYTES;
  const int blk_w = S::SPLIT ? wg * (S::NW / 64) : 0;
  const int blk_h = S::SPLIT ? wg : 0;
  // Consumer 0 of the N-split plan fills the small cotangent tile alone.
  const bool lead = !S::SPLIT || wg == 0;
  // The rows it multiplies (the A operands).
  const uint32_t act_wg = s.act + rows_at;
  const uint32_t gs_wg = s.gs + rows_at;
  unsigned char* gs_p = smem + S::ACT_BYTES + rows_at;
  float* red_small = red + 4 * S::RED_W;
  // The two rows of the warpgroup's 64 whose accumulator elements this
  // thread holds: lrow and lrow + 8 (both are g modulo 8).
  const int lrow = warp * 16 + g;
  // Where cp_words puts this thread's mask words: of a trunk product word
  // c at words_sm[128 c], of h at words_sm[128 (MASK_WORDS_MAX + c)].
  const uint32_t slot = s.words + wg * S::SLOT_WORDS * 512 + 4 * tid;
  const uint32_t h_slot = slot + MASK_WORDS_MAX * 512;
  words_sm += wg * S::SLOT_WORDS * 128 + tid;
  // This thread's words of h in the group of the warpgroup's rows from r.
  auto h_words = [&](long long r) {
    return p.bits + (r / MASK_ROWS) * mask_group_words(H) +
           mask_offset(H, NTRUNK) + tid * (DH / 64) + blk_h;
  };

  // Before a write to the tiles: the TMA stores started by thread 0 must
  // have read them; in the N-split plan the other consumer must also have
  // read the product's input.
  auto stores_done = [&]() {
    if (tid == 0) bulk_wait_read();
    named_bar_sync(bar_id, bar_threads);
  };
  // After a write: publish it to the consumers' wgmma and TMA stores.
  auto publish = [&]() {
    fence_proxy_async();
    named_bar_sync(bar_id, bar_threads);
  };

  // The epilogue of a product of width N whose columns start at block
  // `blk` of the tiles: optional relu mask from the thread's mask words
  // (its N / 64 words of the product's mask, copied by cp_words and waited
  // for), the f32 column sums, bf16 rounding back into the cotangent tile.
  // Returns with the warp's column sums in red[warp][column].
  auto epilogue = [&](auto& acc, auto width, int blk, bool masked,
                      int word0, float* ghf_rows, const bool (&valid)[2]) {
    constexpr int N = decltype(width)::value;
    unsigned char* act_p = smem + blk * S::BLOCK_BYTES + rows_at;
    uint32_t m = 0;  // the mask word of the column group
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      // Row lrow + 8 is 8 * 128 bytes on, in the same swizzle phase.
      const uint32_t off =
          (j / 8) * S::BLOCK_BYTES + swizzle128(lrow, j % 8) + q4 * 4;
      if (j % 8 == 0 && masked) m = words_sm[128 * (word0 + j / 8)];
      float v[2][2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        v[half][0] = acc[4 * j + 2 * half];
        v[half][1] = acc[4 * j + 2 * half + 1];
        if (masked) {
          const int k = 2 * (j % 8) + half;
          v[half][0] = has_bit<0>(m, k) ? v[half][0] : 0.f;
          v[half][1] = has_bit<1>(m, k) ? v[half][1] : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(act_p + off + half * 1024) =
            __floats2bfloat162_rn(v[half][0], v[half][1]);
        if (ghf_rows != nullptr && valid[half])
          *reinterpret_cast<float2*>(ghf_rows + (long long)half * 8 * DH +
                                     j * 8 + 2 * q4) =
              make_float2(v[half][0], v[half][1]);
      }
      // The accumulators are dead now: their first two of each column
      // group hold the thread's two-row sums.
      acc[4 * j] = v[0][0] + v[1][0];
      acc[4 * j + 1] = v[0][1] + v[1][1];
    }
    float sums[N / 4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      sums[2 * j] = acc[4 * j];
      sums[2 * j + 1] = acc[4 * j + 1];
    }
    warp_column_sums<N / 4>(sums, lane);
#pragma unroll
    for (int i = 0; i < N / 32; ++i) {
      const int c = (N / 32) * g + i;
      red[warp * S::RED_W + 8 * (c >> 1) + 2 * q4 + (c & 1)] = sums[i];
    }
  };
  // After the epilogue's publish: the warpgroup's column sums -> its
  // partial row.
  auto bias_partial = [&](int width, float* dst) {
    for (int c = tid; c < width; c += 128)
      dst[c] = red[c] + red[S::RED_W + c] + red[2 * S::RED_W + c] +
               red[3 * S::RED_W + c];
  };

  // The first tile's words of h.
  const long long r_first =
      (long long)blockIdx.x * S::BM + (S::SPLIT ? 0 : wg * WG_ROWS);
  if (r_first < p.n) cp_words<S::NH / 64>(h_slot, h_words(r_first));
  uint32_t it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // The warpgroup's first row.
    const long long r0 = tile * S::BM + (S::SPLIT ? 0 : wg * WG_ROWS);
    const bool valid[2] = {r0 + lrow < p.n, r0 + lrow + 8 < p.n};
    const bool store = tid == 0 && r0 < p.n;
    // The mask words of the warpgroup's 64-row group (mask_bits.cuh); this
    // thread's of x_m are its NW / 64 from column block blk_w on, of h its
    // NH / 64 from block blk_h (copied a tile ahead).  A group wholly past n
    // has none, and needs none: its cotangents are zero.
    const bool have = r0 < p.n;
    const uint32_t* group = p.bits + (r0 / MASK_ROWS) * mask_group_words(H);
    // Its partial row of the bias gradients (the N-split plan's consumers
    // share one per tile, each writing its own columns).
    float* bp = p.bpart + (S::SPLIT ? tile : tile * 2 + wg) * p.nb;

    // The cotangent's small tile, rounded to bf16: columns 0..15 g_heads
    // (rgb | mu, sigma | 0), column 16 g_alpha, zeros to 63.  Two threads
    // per row, four 16-byte chunks each.
    stores_done();
    if (lead) {
      const int r = tid >> 1;
      const long long grow = r0 + r;
      uint4 c0 = make_uint4(0u, 0u, 0u, 0u), c2 = c0;
      if ((tid & 1) == 0 && grow < p.n) {
        const float* gr = p.g + grow * p.out_dim;
        const bool depth = p.out_dim == 6;
        const __nv_bfloat162 a = __floats2bfloat162_rn(gr[0], gr[1]);
        const __nv_bfloat162 b =
            __floats2bfloat162_rn(gr[2], depth ? gr[4] : 0.f);
        const __nv_bfloat162 c = __floats2bfloat162_rn(depth ? gr[5] : 0.f, 0.f);
        const __nv_bfloat162 al = __floats2bfloat162_rn(gr[3], 0.f);
        c0.x = *reinterpret_cast<const uint32_t*>(&a);
        c0.y = *reinterpret_cast<const uint32_t*>(&b);
        c0.z = *reinterpret_cast<const uint32_t*>(&c);
        c2.x = *reinterpret_cast<const uint32_t*>(&al);
      }
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const int chunk = (tid & 1) * 4 + ch;
        *reinterpret_cast<uint4*>(gs_p + swizzle128(r, chunk)) =
            chunk == 0 ? c0 : (chunk == GS_ALPHA / 8 ? c2 : zero);
      }
    }
    publish();
    if (lead && store) {
      tma_store_2d(&maps.gs, gs_wg, 0, (int)r0);
      bulk_commit();
    }
    // d_b_heads and d_b_alpha: column sums of the small tile's first 32
    // columns, 16 rows per warp; added up after the first epilogue.
    if (lead) {
      const int c = lane;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        sum += __bfloat162float(*reinterpret_cast<const bf16*>(
            gs_p + swizzle128(warp * 16 + i, c >> 3) + (c & 7) * 2));
      red_small[warp * 32 + c] = sum;
    }

    // Heads: g_h = mask(h > 0, g_heads @ W_heads), bf16 into columns 0..127
    // of the tile, f32 to ghf.
    {
      float acc[S::NH / 2];
      products<H, S::NH>(acc, 0, 0, gs_wg, blk_h * WBLOCK_BYTES, it, s, lane);
      stores_done();
      cp_words_wait();
      epilogue(acc, std::integral_constant<int, S::NH>{}, blk_h, have,
               MASK_WORDS_MAX, p.ghf + (r0 + lrow) * DH + blk_h * 64, valid);
      publish();
      if (store) {
#pragma unroll
        for (int blk = blk_h; blk < blk_h + S::NH / 64; ++blk)
          tma_store_2d(&maps.gd, act_wg + blk * S::BLOCK_BYTES, blk * 64,
                       (int)r0);
        bulk_commit();
      }
      bias_partial(S::NH, bp + p.b_off[2] + blk_h * 64);
      if (lead && tid < 32)
        bp[tid < NHEAD ? p.b_off[3] + tid : p.b_off[2] + DH + tid - NHEAD] =
            red_small[tid] + red_small[32 + tid] + red_small[64 + tid] +
            red_small[96 + tid];
    }
    {
      float acc[S::NW / 2];
      // Dir layer: g_feat = [g_h_c | g_alpha] @ [Wd_feat; w_alpha]; then
      // fc_feat and W7..W1: gx = bf16(g) @ W, g_i = mask(x_i > 0, gx).
#pragma unroll 1
      for (int q = 1; q < NQ; ++q) {
        const bool dir = q == 1;
        const int slab = dir ? NTRUNK : NQ - 1 - q;
        // The mask of x_slab, copied under the product; under the dir
        // product, the next tile's words of h.
        const bool masked = !dir && have;
        const long long r_next = r0 + (long long)gridDim.x * S::BM;
        if (masked)
          cp_words<S::NW / 64>(slot, group + mask_offset(H, slab) +
                                         tid * (H / 64) + blk_w);
        else if (dir && r_next < p.n)
          cp_words<S::NH / 64>(h_slot, h_words(r_next));
        products<H, S::NW>(acc, dir ? DH / KS : H / KS, act_wg,
                           dir ? gs_wg + (GS_ALPHA / 16) * 32 : 0u,
                           blk_w * WBLOCK_BYTES, it, s, lane);
        stores_done();
        cp_words_wait();
        epilogue(acc, std::integral_constant<int, S::NW>{}, blk_w, masked, 0,
                 nullptr, valid);
        publish();
        if (store) {
#pragma unroll
          for (int blk = blk_w; blk < blk_w + S::NW / 64; ++blk)
            tma_store_3d(&maps.gt, act_wg + blk * S::BLOCK_BYTES, blk * 64,
                         (int)r0, slab);
          bulk_commit();
        }
        bias_partial(S::NW, bp + (dir ? p.b_off[1] : p.b_off[0] + slab * H) +
                                blk_w * 64);
      }
    }
  }
  if (tid == 0) bulk_wait();
}

template <int H>
__global__ void __launch_bounds__(NTHREADS, 1)
    chain_kernel(const ChainParams p, const __grid_constant__ ChainMaps maps) {
  using S = Shape<H>;
  extern __shared__ unsigned char smem_raw[];
  // Tiles start on a 1024-byte boundary of the shared address space.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  Smem s;
  s.act = base;
  s.gs = s.act + S::ACT_BYTES;
  s.ring = s.gs + S::GS_BYTES;
  const uint32_t red_off =
      S::ACT_BYTES + S::GS_BYTES + S::STAGES * S::STAGE_BYTES;
  const uint32_t words_off = red_off + S::RED_BYTES;
  s.words = base + words_off;
  s.full = s.words + S::WORDS_BYTES;
  s.empty = s.full + 8 * S::STAGES;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(s.full + 8 * i, 1);   // the producer's arrive.expect_tx
      mbar_init(s.empty + 8 * i, 8);  // lane 0 of each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  const long long tiles = (p.n + S::BM - 1) / S::BM;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if (threadIdx.x == 0) produce<H>(maps, s, tiles);
  } else {
    float* red = reinterpret_cast<float*>(smem + red_off) +
                 (wg - 1) * S::RED_FLOATS;
    consume<H>(p, maps, s, smem, red,
               reinterpret_cast<const uint32_t*>(smem + words_off), tiles,
               wg - 1, threadIdx.x - wg * 128);
  }
}

// g_dproj[ray, c] = the sum over the ray's rows of g_h[row, c], in row
// order and in f32.  Per ray: of the f32 g_h, rounded to bf16 once; per
// sample: of each row's bf16 rounding.  Stored in f32 either way.
__global__ void dproj_grad_kernel(const float* ghf, float* gdp, int samples,
                                  int per_ray) {
  const long long ray = blockIdx.x;
  const int c = threadIdx.x;
  const float* src = ghf + ray * samples * DH + c;
  float s = 0.f;
  for (int k = 0; k < samples; ++k) {
    const float v = src[(long long)k * DH];
    s += per_ray ? v : __bfloat162float(__float2bfloat16_rn(v));
  }
  gdp[ray * DH + c] = per_ray ? __bfloat162float(__float2bfloat16_rn(s)) : s;
}

// The dirs weight gradient d_Wd_dirs[c, j] = sum over the rays of
// g_dproj[ray, c] * dirs[ray, j] in f32 (a 128 x 27 product, a few MFLOP per
// call), in two fixed-order passes:
// dirs_grad_partial_kernel adds block b's DG_RAYS rays, ray after ray, into
// part[b, j, c] (thread c); dirs_grad_reduce_kernel sums the blocks'
// partials in block order into the packed gradient's [128, 32] block
// (columns 27..31 zero).
constexpr int DG_RAYS = 16;

__global__ void dirs_grad_partial_kernel(const float* gdp, const bf16* dirs,
                                         float* part, long long rays) {
  __shared__ float d[DG_RAYS][DIRS];
  const long long r0 = (long long)blockIdx.x * DG_RAYS;
  const int c = threadIdx.x;
  const int here = (int)(rays - r0 < DG_RAYS ? rays - r0 : DG_RAYS);
  for (int i = c; i < here * DIRS; i += DH)
    d[i / DIRS][i % DIRS] =
        __bfloat162float(dirs[(r0 + i / DIRS) * DIRS_LD + i % DIRS]);
  __syncthreads();
  float acc[DIRS];
#pragma unroll
  for (int j = 0; j < DIRS; ++j) acc[j] = 0.f;
  for (int i = 0; i < here; ++i) {
    const float g = gdp[(r0 + i) * DH + c];
#pragma unroll
    for (int j = 0; j < DIRS; ++j) acc[j] = fmaf(g, d[i][j], acc[j]);
  }
  float* out = part + (long long)blockIdx.x * DIRS * DH + c;
#pragma unroll
  for (int j = 0; j < DIRS; ++j) out[j * DH] = acc[j];
}

__global__ void dirs_grad_reduce_kernel(const float* part, float* gw_dirs,
                                        int blocks) {
  const int j = blockIdx.x, c = threadIdx.x;
  float s = 0.f;
  if (j < DIRS)
    for (int b = 0; b < blocks; ++b) s += part[((long long)b * DIRS + j) * DH + c];
  gw_dirs[c * DIRS_LD + j] = s;
}

// ---------------------------------------------------------------- wgrad

constexpr int WK = 64;            // rows per ring stage
constexpr int WSTAGES = 4;
constexpr int WM = 128;           // output rows per CTA (two warpgroups)
constexpr int MAX_UNITS = 28;
constexpr uint32_t WBOX_BYTES = WK * 128;  // [WK][64] bf16

// dst[m, c] (+ over splits) = sum_r g[r, acol + m] a[r, bcol + c] for the
// rows m of the 128-row tile in [keep_lo, keep_lo + keep_n) and c < ncols.
struct WUnit {
  long long rows;      // of g and a
  long long part;      // float offset of the [splits, keep_n, ncols] partials
  long long dst;       // float offset of dst[0, 0] in the packed gradient
  int amap, aslab, acol;
  int bmap, bslab, bcol;
  int keep_lo, keep_n, ncols, ld_dst;
  int rows_per_split, splits;
  int cta_begin;       // first CTA of the unit (read for units past `nbig`)
};

struct WMaps {
  CUtensorMap a[3];  // gs, gd, gt: box [1, WK, 64]
  CUtensorMap b[3];  // stash_h, stash, ipe
};

// The first nbig units have `sbig` splits each and their CTAs are numbered
// unit fastest, so that the CTAs that read the same rows run side by side.
struct WParams {
  WUnit u[MAX_UNITS];
  int nunit, nbig, sbig;
  float* part;
};

template <int NT>
struct WShape {
  static constexpr uint32_t A_BYTES = (WM / 64) * WBOX_BYTES;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + (NT / 64) * WBOX_BYTES;
  static constexpr size_t SMEM = 1024 + WSTAGES * STAGE_BYTES + 128;
  static_assert(NT % 64 == 0 && NT <= 256, "no weight-gradient tile of this width");
  static_assert(SMEM <= MAX_SMEM, "the tile exceeds a block's shared memory");
};

template <int NT>
__global__ void __launch_bounds__(NTHREADS, 1)
    wgrad_kernel(const __grid_constant__ WParams P,
                 const __grid_constant__ WMaps maps) {
  using S = WShape<NT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + WSTAGES * S::STAGE_BYTES;
  const uint32_t empty = full + 8 * WSTAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < WSTAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  int ui, split;
  if ((int)blockIdx.x < P.nbig * P.sbig) {
    ui = blockIdx.x % P.nbig;
    split = blockIdx.x / P.nbig;
  } else {
    ui = P.nbig;
    while (ui + 1 < P.nunit && (int)blockIdx.x >= P.u[ui + 1].cta_begin) ++ui;
    split = blockIdx.x - P.u[ui].cta_begin;
  }
  const WUnit& U = P.u[ui];
  const long long rb = (long long)split * U.rows_per_split;
  const long long re = min(U.rows, rb + U.rows_per_split);
  const int nch = (int)((re - rb + WK - 1) / WK);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if (threadIdx.x != 0) return;
    const CUtensorMap* am = &maps.a[U.amap];
    const CUtensorMap* bm = &maps.b[U.bmap];
    for (int ch = 0; ch < nch; ++ch) {
      const uint32_t stage = ch % WSTAGES, parity = (ch / WSTAGES) & 1;
      const uint32_t dst = ring + stage * S::STAGE_BYTES;
      const int row = (int)(rb + (long long)ch * WK);
      mbar_wait(empty + 8 * stage, parity ^ 1);
      mbar_arrive_expect_tx(full + 8 * stage, S::STAGE_BYTES);
#pragma unroll
      for (int b = 0; b < WM / 64; ++b)
        tma_load_3d(dst + b * WBOX_BYTES, am, U.acol + b * 64, row, U.aslab,
                    full + 8 * stage);
#pragma unroll
      for (int b = 0; b < NT / 64; ++b)
        tma_load_3d(dst + S::A_BYTES + b * WBOX_BYTES, bm, U.bcol + b * 64,
                    row, U.bslab, full + 8 * stage);
    }
    return;
  }

  // Consumer warpgroup w: rows 64 w .. 64 w + 63 of the output tile.
  const int w = wg - 1, tid = threadIdx.x - wg * 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  float acc[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) acc[j] = 0.f;
  uint32_t prev = 0;
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    const uint32_t stage = ch % WSTAGES, parity = (ch / WSTAGES) & 1;
    mbar_wait(full + 8 * stage, parity);
    const uint32_t a = ring + stage * S::STAGE_BYTES + w * WBOX_BYTES;
    const uint32_t b = ring + stage * S::STAGE_BYTES + S::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      wgmma_k16<NT, 1, 1>(acc, smem_desc_mn(a + kk * 2048, WBOX_BYTES),
                          smem_desc_mn(b + kk * 2048, WBOX_BYTES));
    wgmma_commit();
    if (ch > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty + 8 * prev);
    }
    prev = stage;
  }
  wgmma_wait<0>();

  float* out = P.part + U.part + (long long)split * U.keep_n * U.ncols;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rel = w * 64 + warp * 16 + g + half * 8 - U.keep_lo;
    if (rel < 0 || rel >= U.keep_n) continue;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int c = j * 8 + 2 * q4;
      if (c < U.ncols)
        *reinterpret_cast<float2*>(out + (long long)rel * U.ncols + c) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------- reduce

struct RTask {
  long long src;     // float offset of [splits, m * n] in the partials
  long long dst;     // float offset of dst[0, 0]: dst[m * ld + c]
  long long begin;   // first element of this task in the launch
  int splits, m, n, ld;
};

struct RParams {
  RTask t[2 * MAX_UNITS];
  int ntask;
  const float* part;
  float* gw;
};

__global__ void reduce_kernel(const __grid_constant__ RParams R) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int ti = 0;
  while (ti + 1 < R.ntask && e >= R.t[ti + 1].begin) ++ti;
  const RTask& T = R.t[ti];
  const long long count = (long long)T.m * T.n;
  const long long local = e - T.begin;
  if (local < 0 || local >= count) return;
  const float* src = R.part + T.src + local;
  float s = 0.f;
  for (int sp = 0; sp < T.splits; ++sp) s += src[sp * count];
  R.gw[T.dst + (local / T.n) * T.ld + local % T.n] = s;
}

// gb[c] = sum over the `rows` partial rows of bpart[row, c], in a fixed
// order: eight interleaved row groups, then the groups in turn.
constexpr int BR_COLS = 32, BR_GROUPS = 8;

__global__ void bias_reduce_kernel(const float* bpart, float* gb,
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

// ------------------------------------------------------------------ host

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// The weight-gradient units, in launches of one tile width NT and at most
// MAX_UNITS units each: first those whose activation is a stash slab (NT =
// main_nt), then those whose activation is h or the IPE (NT = 128); and the
// floats of their partials.
constexpr int MAX_PLAN_UNITS = 80;  // 77 at width 512
constexpr int MAX_LAUNCHES = 4;

struct WLaunch {
  int first, count, nt;
  int big, sbig, ctas;
};

struct Plan {
  WUnit u[MAX_PLAN_UNITS];
  WLaunch l[MAX_LAUNCHES];
  int nunit, nlaunch;
  long long part_floats;
};

// The tile width of the weight gradients of the H-wide products: H, or
// H / 2 in the N-split plan (two column chunks per output).
int main_nt(int hidden) { return hidden > 256 ? hidden / 2 : hidden; }

Plan make_plan(long long n, int hidden, int sms, const long long* w_off) {
  Plan P = {};
  int nu = 0;
  // amap: 0 gs, 1 gd, 2 gt; bmap: 0 stash_h, 1 stash, 2 ipe.
  // One unit per 128 output rows and per nt output columns.
  auto add = [&](int nt, int amap, int aslab, int m, int bmap, int bslab,
                 long long rows, int keep_lo, int keep_n, int ncols,
                 long long dst, int ld) {
    for (int m0 = 0; m0 < m; m0 += WM) {
      for (int c0 = 0; c0 < ncols; c0 += nt) {
        WUnit& U = P.u[nu++];
        U.rows = rows;
        U.amap = amap;
        U.aslab = aslab;
        U.acol = m0;
        U.bmap = bmap;
        U.bslab = bslab;
        U.bcol = c0;
        U.keep_lo = keep_lo;
        U.keep_n = keep_n < m - m0 ? keep_n : m - m0;
        U.ncols = ncols - c0 < nt ? ncols - c0 : nt;
        U.dst = dst + (long long)m0 * ld + c0;
        U.ld_dst = ld;
      }
    }
  };
  // The workspace query has no offsets: the sizes do not depend on them.
  static const long long no_off[NW] = {};
  const long long* wo = w_off != nullptr ? w_off : no_off;
  const int nt = main_nt(hidden);
  // NT = main_nt: every product whose activation is a stash slab.
  for (int i = NTRUNK - 1; i >= 1; --i) {
    const int kin = i == SKIP ? IPE + hidden : hidden;
    add(nt, 2, i, hidden, 1, i - 1, n, 0, WM, hidden,
        wo[i] + (i == SKIP ? IPE : 0), kin);
  }
  add(nt, 2, NTRUNK, hidden, 1, NTRUNK - 1, n, 0, WM, hidden, wo[W_FEAT],
      hidden);
  add(nt, 1, 0, DH, 1, NTRUNK, n, 0, WM, hidden, wo[W_DIR], hidden);
  add(nt, 0, 0, GS_W, 1, NTRUNK, n, GS_ALPHA, 1, hidden,
      wo[W_DIR] + (long long)DH * hidden, hidden);
  const int nmain = nu;
  // NT = 128: h and the IPE as activations.
  add(DH, 2, SKIP, hidden, 2, 0, n, 0, WM, IPE, wo[SKIP], IPE + hidden);
  add(DH, 2, 0, hidden, 2, 0, n, 0, WM, IPE, wo[0], IPE);
  add(DH, 0, 0, GS_W, 0, 0, n, 0, NHEAD, DH, wo[W_HEAD], DH);
  P.nunit = nu;

  int nl = 0;
  for (int first = 0; first < nmain; first += MAX_UNITS)
    P.l[nl++] = {first, nmain - first < MAX_UNITS ? nmain - first : MAX_UNITS,
                 nt, 0, 0, 0};
  P.l[nl++] = {nmain, nu - nmain, DH, 0, 0, 0};
  P.nlaunch = nl;

  long long part = 0;
  for (int l = 0; l < nl; ++l) {
    WLaunch& L = P.l[l];
    WUnit* u = P.u + L.first;
    int big = 0;
    while (big < L.count && u[big].rows == n) ++big;
    const int sbig = big > 0 && sms / big > 1 ? sms / big : 1;
    int ctas = 0;
    for (int i = 0; i < L.count; ++i) {
      const long long per = (u[i].rows + sbig - 1) / sbig;
      u[i].rows_per_split = (int)((per + WK - 1) / WK * WK);
      u[i].splits =
          (int)((u[i].rows + u[i].rows_per_split - 1) / u[i].rows_per_split);
      u[i].cta_begin = ctas;
      ctas += u[i].splits;
      u[i].part = part;
      part += (long long)u[i].splits * u[i].keep_n * u[i].ncols;
    }
    L.big = big;
    L.sbig = big > 0 ? u[0].splits : 0;
    L.ctas = ctas;
  }
  P.part_floats = part;
  return P;
}

// Partial rows of the bias gradients: one per chain tile and consumer, or
// one per tile in the N-split plan.
long long bias_rows(long long n, int hidden) {
  const long long bm = chain_rows(hidden), tiles = (n + bm - 1) / bm;
  return hidden > 256 ? tiles : 2 * tiles;
}

struct Layout {
  size_t gs, gd, ghf, gt, bpart, gdp, dpart, part, total;
};

Layout layout(long long n, int samples, int hidden, const Plan& P) {
  const long long rays = n / samples;
  const long long nb = 9LL * hidden + DHP + NHEAD;
  Layout L;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  L.gs = take(n * GS_W * sizeof(bf16));
  L.gd = take(n * DH * sizeof(bf16));
  L.ghf = take(n * DH * sizeof(float));
  L.gt = take(NSLAB * n * hidden * sizeof(bf16));
  L.bpart = take(bias_rows(n, hidden) * nb * sizeof(float));
  // g_dproj (f32) and the partials of its product with the dirs.
  L.gdp = take(rays * DH * sizeof(float));
  L.dpart = take((rays + DG_RAYS - 1) / DG_RAYS * DIRS * DH * sizeof(float));
  L.part = take(P.part_floats * sizeof(float));
  L.total = off;
  return L;
}

// A [slabs, rows, cols] bf16 tensor map with boxes of [1, box_rows, 64].
bool map3(CUtensorMap* map, const void* ptr, long long cols, long long rows,
          long long slabs, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)cols, (cuuint64_t)(rows * cols)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return make_map(map, ptr, 3, dims, strides, box);
}

bool map2(CUtensorMap* map, const void* ptr, long long cols, long long rows,
          int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return make_map(map, ptr, 2, dims, strides, box);
}

template <int H>
cudaError_t launch_chain(const ChainParams& p, const ChainMaps& maps, int sms,
                         cudaStream_t stream) {
  using S = Shape<H>;
  // The opt-in to S::SMEM bytes of dynamic shared memory: once per process
  // and instantiation, not per launch.
  static const cudaError_t setup = cudaFuncSetAttribute(
      chain_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM);
  if (setup != cudaSuccess) return setup;
  const long long tiles = (p.n + S::BM - 1) / S::BM;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  chain_kernel<H><<<grid, NTHREADS, S::SMEM, stream>>>(p, maps);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_wgrad(const Plan& P, const WLaunch& L, float* part,
                         const WMaps& maps, cudaStream_t stream) {
  using S = WShape<NT>;
  WParams W = {};
  W.nunit = L.count;
  for (int i = 0; i < W.nunit; ++i) W.u[i] = P.u[L.first + i];
  W.nbig = L.big;
  W.sbig = L.sbig;
  W.part = part;
  static const cudaError_t setup = cudaFuncSetAttribute(
      wgrad_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM);  // once per process and instantiation
  if (setup != cudaSuccess) return setup;
  wgrad_kernel<NT><<<(unsigned)L.ctas, NTHREADS, S::SMEM, stream>>>(W, maps);
  return cudaGetLastError();
}

cudaError_t launch_wgrad_width(const Plan& P, const WLaunch& L, float* part,
                               const WMaps& maps, cudaStream_t stream) {
  switch (L.nt) {
    case 64: return launch_wgrad<64>(P, L, part, maps, stream);
    case 128: return launch_wgrad<128>(P, L, part, maps, stream);
    case 192: return launch_wgrad<192>(P, L, part, maps, stream);
    case 256: return launch_wgrad<256>(P, L, part, maps, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool known_width(int hidden) {
  return hidden == 64 || hidden == 128 || hidden == 192 || hidden == 256 ||
         hidden == 384 || hidden == 512;
}

}  // namespace

// Bytes of device workspace that ddnerf_fused_mlp_bwd needs.
extern "C" long long ddnerf_fused_mlp_bwd_workspace(long long n, int samples,
                                                    int hidden) {
  if (n <= 0 || samples <= 0 || n % samples || !known_width(hidden)) return -1;
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  const Plan P = make_plan(n, hidden, sms, nullptr);
  return (long long)layout(n, samples, hidden, P).total;
}

// Parameter gradients of the fused MLP on `stream`.  Device pointers: ipe
// [n, 96] bf16, dirs [n / samples, 32] bf16 (27 features, zero padded), g
// [n, 4|6] f32, the forward's stash [9, n, hidden] and stash_h [n, 128]
// bf16 and its relu masks' words bits (mask_bits.cuh),
// packed bf16 weights w; outputs gw (f32, laid out as w) and gb (f32,
// laid out as the packed biases); ws a workspace of
// ddnerf_fused_mlp_bwd_workspace bytes.  per_ray: the dirs weight gradient
// rounds the per-ray cotangent sum (1) or each sample's cotangent (0).
// w_off (12 entries) and b_off (4) are host arrays.  Returns a cudaError_t.
extern "C" int ddnerf_fused_mlp_bwd(
    const void* ipe, const void* dirs, const void* g, const void* stash,
    const void* stash_h, const void* bits, const void* w, void* gw, void* gb,
    void* ws, long long ws_bytes, long long n, int samples, int hidden,
    int depth_head, int per_ray, const long long* w_off, const long long* b_off,
    void* stream) {
  if (n <= 0 || samples <= 0 || n % samples) return cudaErrorInvalidValue;
  if (!known_width(hidden) || bits == nullptr) return cudaErrorInvalidValue;
  // TMA coordinates are 32-bit.
  if (n > 0x7fffffffLL - 2 * WG_ROWS) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long rays = n / samples, h = hidden;
  const int nb = 9 * hidden + DHP + NHEAD;
  if (b_off[3] + NHEAD != nb) return cudaErrorInvalidValue;
  const Plan P = make_plan(n, hidden, sms, w_off);
  const Layout L = layout(n, samples, hidden, P);
  if (ws_bytes < (long long)L.total) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* base = static_cast<unsigned char*>(ws);
  const bf16* wp = static_cast<const bf16*>(w);
  bf16* gs = reinterpret_cast<bf16*>(base + L.gs);
  bf16* gd = reinterpret_cast<bf16*>(base + L.gd);
  bf16* gt = reinterpret_cast<bf16*>(base + L.gt);
  float* gdp = reinterpret_cast<float*>(base + L.gdp);
  float* part = reinterpret_cast<float*>(base + L.part);

  ChainParams p = {};
  p.g = static_cast<const float*>(g);
  p.bits = static_cast<const uint32_t*>(bits);
  p.ghf = reinterpret_cast<float*>(base + L.ghf);
  p.bpart = reinterpret_cast<float*>(base + L.bpart);
  p.n = n;
  p.out_dim = depth_head ? 6 : 4;
  p.nb = nb;
  for (int i = 0; i < NB_OFF; ++i) p.b_off[i] = b_off[i];

  ChainMaps cm = {};
  bool ok = true;
  for (int l = 1; l < NLAYER; ++l) {
    const long long nout = l <= L_FEAT ? h : (l == L_DIR ? DHP : NHEAD);
    const long long kin = l == SKIP ? IPE + h : (l == L_HEAD ? DH : h);
    ok = ok && map2(&cm.w[l], wp + w_off[l], kin, nout, KS);
  }
  ok = ok && map2(&cm.gs, gs, GS_W, n, WG_ROWS);
  ok = ok && map2(&cm.gd, gd, DH, n, WG_ROWS);
  ok = ok && map3(&cm.gt, gt, h, n, NSLAB, WG_ROWS);
  WMaps wm = {};
  ok = ok && map3(&wm.a[0], gs, GS_W, n, 1, WK);
  ok = ok && map3(&wm.a[1], gd, DH, n, 1, WK);
  ok = ok && map3(&wm.a[2], gt, h, n, NSLAB, WK);
  ok = ok && map3(&wm.b[0], stash_h, DH, n, 1, WK);
  ok = ok && map3(&wm.b[1], stash, h, n, NSLAB, WK);
  ok = ok && map3(&wm.b[2], ipe, IPE, n, 1, WK);
  if (!ok) return cudaErrorInvalidValue;

  switch (hidden) {
    case 64: e = launch_chain<64>(p, cm, sms, st); break;
    case 128: e = launch_chain<128>(p, cm, sms, st); break;
    case 192: e = launch_chain<192>(p, cm, sms, st); break;
    case 256: e = launch_chain<256>(p, cm, sms, st); break;
    case 384: e = launch_chain<384>(p, cm, sms, st); break;
    default: e = launch_chain<512>(p, cm, sms, st); break;
  }
  if (e != cudaSuccess) return e;
  dproj_grad_kernel<<<(unsigned)rays, DH, 0, st>>>(p.ghf, gdp, samples,
                                                   per_ray);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int blocks = (int)((rays + DG_RAYS - 1) / DG_RAYS);
  float* dpart = reinterpret_cast<float*>(base + L.dpart);
  dirs_grad_partial_kernel<<<blocks, DH, 0, st>>>(
      gdp, static_cast<const bf16*>(dirs), dpart, rays);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dirs_grad_reduce_kernel<<<DIRS_LD, DH, 0, st>>>(
      dpart, static_cast<float*>(gw) + w_off[W_DIRS], blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  for (int l = 0; l < P.nlaunch; ++l) {
    e = launch_wgrad_width(P, P.l[l], part, wm, st);
    if (e != cudaSuccess) return e;
  }

  // Reduce the split partials into gw, at most 2 MAX_UNITS units a launch,
  // and the bias partial rows into gb.
  for (int t0 = 0; t0 < P.nunit; t0 += 2 * MAX_UNITS) {
    RParams R = {};
    R.part = part;
    R.gw = static_cast<float*>(gw);
    R.ntask = P.nunit - t0 < 2 * MAX_UNITS ? P.nunit - t0 : 2 * MAX_UNITS;
    long long elems = 0;
    for (int i = 0; i < R.ntask; ++i) {
      const WUnit& U = P.u[t0 + i];
      RTask& Q = R.t[i];
      Q.src = U.part;
      Q.dst = U.dst;
      Q.begin = elems;
      Q.splits = U.splits;
      Q.m = U.keep_n;
      Q.n = U.ncols;
      Q.ld = U.ld_dst;
      elems += (long long)U.keep_n * U.ncols;
    }
    reduce_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(R);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  bias_reduce_kernel<<<(nb + BR_COLS - 1) / BR_COLS, BR_COLS * BR_GROUPS, 0,
                       st>>>(p.bpart, static_cast<float*>(gb),
                             bias_rows(n, hidden), nb);
  return cudaGetLastError();
}
