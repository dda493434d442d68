// Fused NeRF MLP forward for Hopper (sm_90a): the whole MipMLP /
// DepthMipMLP network for a tile of rows in one kernel, every activation
// kept in shared memory, every product a warpgroup wgmma, the weights
// streamed by TMA through a ring of shared-memory stages.
//
// Replaces the TPU kernel ddnerf_tpu/kernels/fused_mlp.py::fused_mlp_forward
// (body _kernel -> _net_body) in render mode (no stash) and in stash mode
// (stash=True, the training forward), view directions given once per ray;
// and, as the compile-time mode ENC, fused_enc_mlp_forward (body
// _enc_kernel): the same net body fed an IPE that the kernel computes itself
// from raw means and covariances (see encode_ipe below).
//
// What it computes, per row (rows are ray-major: row r belongs to ray r / K):
//   x0 = relu(ipe @ W0 + b0)                     trunk, width H, bf16 out
//   x5 = relu([ipe, x4] @ W5 + b5)               the skip layer
//   feat = x7 @ Wf + bf                          f32, then bf16
//   alpha = feat @ Wa + ba
//   h = relu(feat @ Wd_feat + dproj[r / K] + bd) dproj = dirs @ Wd_dirs, per ray
//   [rgb | mu, sigma] = h @ [W_rgb | W_mu_sigma] + b
// Matmul operands are bf16 and every product accumulates in f32 (onto the
// bias, which is the accumulator's first value); each trunk output and h
// are rounded to bf16 after bias + relu, feat after its bias, exactly where
// the TPU kernel rounds.  The output is f32 [N, 4|6] =
// (rgb, alpha[, raw_mu, raw_sigma]).
//
// Stash mode (the activations the backward kernel fused_mlp_bwd.cu reads):
// after each layer's write-back to shared memory the tile is also stored to
// device memory, bf16, in the split layout of the TPU kernel's
// split_h_stash: trunk slabs x0..x6 as [7, N, H] and h as [N, 128].  This
// port also stashes x7 and feat, as slabs 7 and 8 of the same [9, N, H]
// buffer, so the backward reads them instead of recomputing them from x6
// (the values are the same either way).  The stash changes no arithmetic:
// the outputs are bit-identical to a render-mode launch.
//
// What bounds it on an H100: tensor-core throughput.  A row costs ~0.6
// M multiply-adds against ~200 bytes of input and 16-24 bytes of output
// (0.64 ms per 524,288 rows at width 256 at the dense bf16 peak, 0.03 ms of
// device-memory traffic).  Measured (PERF.md), the tensor pipes are busy
// about 63% of a consumer's cycles: the two consumers run in step, so the
// pipes idle through both epilogues (~16%) and through the waits for the
// weight stream (~8%; every 128-row tile reads all ~1.2 MB of a network's
// weights from L2).  Stash mode adds 2 * (9 H + 128) bytes of writes per
// row and is bound by device memory.  ENC mode reads 24 bytes per row
// instead of the IPE's 192 and spends 48 expf and 96 sinf per row, on warps
// that would otherwise idle.
//
// Design:
// * Persistent CTAs (one per SM) walk the 128-row tiles with a static
//   stride.  A CTA is three warpgroups: one producer (a single thread of it
//   starts every TMA copy) and two consumers.  Consumer w owns rows 64 w ..
//   64 w + 63 of the tile through every layer: it reads and overwrites only
//   its own rows of the activation buffer, so no CTA-wide barrier is needed
//   after set-up; a layer costs one warpgroup-scope barrier.  All three fit
//   the 168 registers a thread of a 384-thread CTA can have (ptxas allots no
//   more after setmaxnreg, so the kernel does not use it).
// * Products are wgmma.mma_async m64 n{H, 144, 16} k16, A (activations or
//   IPE) and B (weights, torch [out, in] = K-major) both from shared memory
//   in the 128-byte-swizzled layout, f32 accumulators in registers.
// * Weights stream as [n_out, 64] slices (32 KB at H = 256), one TMA box
//   each, through a ring of STAGES stages with a full and an empty mbarrier
//   per stage, across layer and tile boundaries.  There is one tensor map
//   per layer over the packed weights.  The IPE is 96 wide: its tile is
//   kept 128 wide with zero columns 96..127, and its second weight slice
//   starts at column 64 (layer 0: TMA zero-fills past column 96; skip
//   layer: columns 96..127 hold x-part weights that meet the zero columns).
// * Activations are [128, 64]-column blocks of 128-byte rows, swizzled the
//   same way.  The bias is the accumulators' first value; the epilogue
//   rounds the fragments to bf16, applies relu two values at a time and
//   writes them straight back (conflict-free), fences for the asynchronous
//   proxy and meets its warpgroup.
// * The IPE tile comes by TMA too (rows past N zero-filled), as soon as the
//   skip layer has read the previous one.  In ENC mode the three idle warps
//   of the producer warpgroup compute it instead, one tile ahead, into two
//   tiles in turn (the ring is then three stages deep, not four): the encode
//   runs under the previous tile's products.
// * Stash mode stores each layer's tile with TMA stores (which undo the
//   swizzle and drop rows past N); they run under the next layer's products
//   and are awaited before the next write-back.
// * fc_alpha rides the dir layer as its output column 128 (the merged
//   [Wd_feat | Wa] matmul of the JAX module path); the per-ray dir
//   projection comes from a small first kernel into an f32 [N/K, 128]
//   scratch buffer, so K is a runtime value and any N is accepted (rows
//   past N are masked).
//
// Weight/bias packing: see mma_common.cuh (built by
// kernels/fused_mlp.py::pack_weights).

#include "hopper_common.cuh"

namespace {

using namespace ddnerf;

constexpr int BM = 128;           // rows per tile
constexpr int WG_ROWS = 64;       // rows per consumer warpgroup
constexpr int NTHREADS = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr int NENCODERS = 96;     // ENC mode: warps 1..3 of the producer warpgroup
constexpr int KS = 64;            // k-slice of streamed weights (128 bytes)
constexpr int MAX_STAGES = 4;
constexpr int L_FEAT = W_FEAT, L_DIR = W_DIR, L_HEAD = W_HEAD, NLAYER = 11;
constexpr int IPE_SLICES = 2;     // the IPE tile padded to 2 * KS columns
constexpr uint32_t BLOCK_BYTES = BM * 128;      // [BM][KS] bf16
constexpr uint32_t WG_BYTES = WG_ROWS * 128;    // one warpgroup's rows of it

struct TensorMaps {
  CUtensorMap w[NLAYER];  // layer l's weights [n_out, k_in], box [n_out, KS]
  CUtensorMap ipe;        // [n, 96], box [BM, KS]
  CUtensorMap stash;      // [9, n, H], box [1, WG_ROWS, KS]
  CUtensorMap stash_h;    // [n, 128], box [WG_ROWS, KS]
};

struct Params {
  const float* means;  // [n, 3]; ENC mode only
  const float* covs;   // [n, 3]; ENC mode only
  const float* b;      // packed biases
  const float* dproj;  // [n / samples, 128]
  float* out;          // [n, out_dim]
  long long n;
  int samples;
  int out_dim;
  int stash;           // 1: store the activations through the stash maps
  long long b_off[4];
};

template <int H, bool ENC>
struct Shape {
  // Weight ring depth, and IPE tiles in shared memory: ENC mode encodes the
  // next tile while this one is multiplied, and pays a ring stage for the
  // second tile.
  static constexpr int STAGES = ENC ? 3 : MAX_STAGES;
  static constexpr int IPE_BUFS = ENC ? 2 : 1;
  // act holds the trunk (H wide) and later h (DH wide), in KS-column blocks.
  static constexpr int ACT_BLOCKS = (H > DH ? H : DH) / KS;
  static constexpr int MAX_NOUT = H > DHP ? H : DHP;
  static constexpr uint32_t ACT_BYTES = ACT_BLOCKS * BLOCK_BYTES;
  static constexpr uint32_t IPE_BYTES = IPE_SLICES * BLOCK_BYTES;
  static constexpr uint32_t STAGE_BYTES = (MAX_NOUT * 128 + 1023) / 1024 * 1024;
  static constexpr uint32_t BAR_BYTES = 128;  // 2 MAX_STAGES + 4 mbarriers
  // 1024 spare bytes to start the tiles on a 1024-byte boundary.
  static constexpr size_t SMEM = 1024 + ACT_BYTES + IPE_BUFS * IPE_BYTES +
                                 STAGES * STAGE_BYTES + BAR_BYTES;
  __host__ __device__ static constexpr int nout(int l) {
    return l <= L_FEAT ? H : (l == L_DIR ? DHP : NHEAD);
  }
  __host__ __device__ static constexpr int kin(int l) {
    return l == 0 ? IPE : (l == SKIP ? IPE + H : (l == L_HEAD ? DH : H));
  }
  // Layer l's slices: first those that meet the IPE tile, then those that
  // meet the activation blocks.
  __host__ __device__ static constexpr int ipe_slices(int l) {
    return l == 0 || l == SKIP ? IPE_SLICES : 0;
  }
  __host__ __device__ static constexpr int act_slices(int l) {
    return l == 0 ? 0 : (l == L_HEAD ? DH : H) / KS;
  }
};

// Shared-memory addresses (shared state space) of one CTA's buffers.
struct Smem {
  uint32_t act, ipe, ring;                    // tiles
  uint32_t full, empty, ipe_full, ipe_empty;  // mbarrier arrays
};

// ENC mode: a tile's IPE computed into the swizzled IPE tile from the raw
// [n, 3] f32 means and covariances, in the direct form of the TPU kernel's
// _enc_kernel (and of core/math.py::integrated_pos_enc with
// double_angle=False): for row r, level l = 0..15 and coordinate j,
//   y = x_j * 2^l, v = cov_j * 4^l      (exact power-of-two scalings)
//   att = exp(-0.5 * v)
//   ipe[r, l*3 + j]      = bf16(att * sin(wrap(y)))
//   ipe[r, 48 + l*3 + j] = bf16(att * sin(wrap(y + (float)(pi/2))))
// where wrap(y) = |y| < 100 pi ? y : floor-mod(y, 100 pi), safe_sin's
// reduction, written as fmodf plus a sign fix (exact; what torch.remainder
// and jnp.remainder compute).  sinf / expf are the accurate libdevice
// functions: the wrapped argument reaches 100 pi, where the __sinf
// intrinsic loses accuracy.  Rows past n are zero, as the TMA load's.
// means / covs rows are 12 bytes, so they are read with plain loads.
//
// A tile is 768 (row, coordinate, half of the levels) items.  The NENCODERS
// threads of the producer warpgroup's warps 1..3 encode tile i + 1 while the
// consumers multiply tile i, eight items each.  A thread climbs its item's
// LPI levels unrolled,
// scaling y by 2 and v by 4 per level (exact, so the values are those of
// x * 2^l and cov * 4^l): LPI independent expf / sinf chains in flight
// instead of one.
__device__ __forceinline__ float wrap_trig(float y) {
  constexpr float T = 314.159265358979323846f;  // (float)(100 pi)
  if (fabsf(y) < T) return y;
  float m = fmodf(y, T);
  if (m < 0.f) m += T;
  return m;
}

// Element (row r, column c) of an IPE tile.
__device__ __forceinline__ bf16* ipe_elem(unsigned char* ipe, int r, int c) {
  return reinterpret_cast<bf16*>(ipe + (c / KS) * BLOCK_BYTES +
                                 swizzle128(r, (c % KS) >> 3)) + (c & 7);
}

// Thread `tid` of NENCODERS: its items of the tile whose first row is r0.
__device__ __forceinline__ void encode_ipe(const Params& p, unsigned char* ipe,
                                           long long r0, int tid) {
  constexpr int HALF = IPE / 2;    // 48 = 16 levels x 3 coordinates
  constexpr int LPI = 8;           // levels per item
  constexpr int IPR = HALF / LPI;  // items per row: 3 coordinates x 2
  constexpr float HALF_PI = 1.57079632679489661923f;
  // Items are ordered level half first, so that every warp of a pass holds
  // one half only: the low levels seldom wrap, the high ones always do, and
  // a warp that mixes them runs both paths for every lane.
  for (int c = tid; c < BM * IPR; c += NENCODERS) {
    const int l0 = c / (BM * 3) * LPI, rem = c % (BM * 3);
    const int r = rem / 3, j = rem % 3;
    const int col = l0 * 3 + j;  // level l0, coordinate j
    if (r0 + r >= p.n) {
#pragma unroll
      for (int i = 0; i < LPI; ++i) {
        *ipe_elem(ipe, r, col + i * 3) = __float2bfloat16_rn(0.f);
        *ipe_elem(ipe, r, HALF + col + i * 3) = __float2bfloat16_rn(0.f);
      }
      continue;
    }
    const float f = (float)(1 << l0);
    float y = p.means[(r0 + r) * 3 + j] * f;
    float v = p.covs[(r0 + r) * 3 + j] * (f * f);
#pragma unroll
    for (int i = 0; i < LPI; ++i) {
      const float att = expf(-0.5f * v);
      *ipe_elem(ipe, r, col + i * 3) =
          __float2bfloat16_rn(att * sinf(wrap_trig(y)));
      *ipe_elem(ipe, r, HALF + col + i * 3) =
          __float2bfloat16_rn(att * sinf(wrap_trig(y + HALF_PI)));
      y *= 2.f;
      v *= 4.f;
    }
  }
}

// The producer: every TMA load of this CTA's tiles, in the order the
// consumers use them, as far ahead as the ring (and the IPE tile) allow.
template <int H, bool ENC>
__device__ __forceinline__ void produce(const TensorMaps& maps, const Smem& s,
                                        long long tiles) {
  using S = Shape<H, ENC>;
  uint32_t it = 0;  // weight slices requested so far
  uint32_t round = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
    if (!ENC) {  // the IPE tile (one buffer: S::IPE_BUFS == 1)
      mbar_wait(s.ipe_empty, (round & 1) ^ 1);
      mbar_arrive_expect_tx(s.ipe_full, S::IPE_BYTES);
      const int row = (int)(tile * BM);
#pragma unroll
      for (int i = 0; i < IPE_SLICES; ++i)
        tma_load_2d(s.ipe + i * BLOCK_BYTES, &maps.ipe, i * KS, row,
                    s.ipe_full);
    }
#pragma unroll 1
    for (int l = 0; l < NLAYER; ++l) {
      const int ni = S::ipe_slices(l), ns = ni + S::act_slices(l);
      const uint32_t bytes = S::nout(l) * 128;
#pragma unroll 1
      for (int i = 0; i < ns; ++i, ++it) {
        const uint32_t stage = it % S::STAGES, parity = (it / S::STAGES) & 1;
        mbar_wait(s.empty + 8 * stage, parity ^ 1);
        mbar_arrive_expect_tx(s.full + 8 * stage, bytes);
        const int col = i < ni ? i * KS : (l == SKIP ? IPE : 0) + (i - ni) * KS;
        tma_load_2d(s.ring + stage * S::STAGE_BYTES, &maps.w[l], col, 0,
                    s.full + 8 * stage);
      }
    }
  }
}

// ENC mode, one of the NENCODERS threads: every tile's IPE, one tile ahead
// of the consumers, into the two IPE tiles in turn.
template <int H>
__device__ __forceinline__ void encode_tiles(const Params& p, const Smem& s,
                                             unsigned char* ipe0,
                                             long long tiles, int tid) {
  using S = Shape<H, true>;
  // The tiles' zero columns 96..127, written once.
  for (int c = tid; c < S::IPE_BUFS * BM * 4; c += NENCODERS) {
    const int buf = c / (BM * 4), r = (c >> 2) % BM, chunk = 4 + (c & 3);
    *reinterpret_cast<uint4*>(ipe0 + buf * S::IPE_BYTES + BLOCK_BYTES +
                              swizzle128(r, chunk)) = make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t round = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
    const uint32_t buf = round % S::IPE_BUFS;
    const uint32_t parity = (round / S::IPE_BUFS) & 1;
    mbar_wait(s.ipe_empty + 8 * buf, parity ^ 1);
    encode_ipe(p, ipe0 + buf * S::IPE_BYTES, tile * BM, tid);
    fence_proxy_async();  // the consumers read the tile with wgmma
    mbar_arrive(s.ipe_full + 8 * buf);
  }
}

// acc = bias + A @ W_l^T for this warpgroup's 64 rows over all of layer l's
// k-slices, as the ring delivers them.  acc starts as the layer's bias (N
// floats) and every product accumulates: that spares the epilogue an add,
// and an accumulator that the first product merely overwrote would look
// live to the compiler from the previous layer on (it then spills, and
// ptxas serializes every wgmma of the kernel).  `ipe_wg` / `act_wg` are the
// shared addresses of the warpgroup's rows of the first IPE / activation
// block.
// One slice's products stay in flight while the next slice is awaited; a
// stage is released (one arrival per warp) once its products have finished.
template <int H, bool ENC, int N>
__device__ __forceinline__ void layer_products(float (&acc)[N / 2], int l,
                                               const float* bias,
                                               uint32_t& it, const Smem& s,
                                               uint32_t ipe_wg,
                                               uint32_t act_wg, int lane) {
  using S = Shape<H, ENC>;
  const int ni = S::ipe_slices(l), ns = ni + S::act_slices(l);
  uint32_t prev = 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 bb =
        *reinterpret_cast<const float2*>(bias + j * 8 + 2 * (lane & 3));
    acc[4 * j] = acc[4 * j + 2] = bb.x;
    acc[4 * j + 1] = acc[4 * j + 3] = bb.y;
  }
#pragma unroll 1
  for (int i = 0; i < ns; ++i, ++it) {
    const uint32_t stage = it % S::STAGES, parity = (it / S::STAGES) & 1;
    mbar_wait(s.full + 8 * stage, parity);
    const uint32_t a =
        i < ni ? ipe_wg + i * BLOCK_BYTES : act_wg + (i - ni) * BLOCK_BYTES;
    const uint32_t b = s.ring + stage * S::STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk)
      wgmma_k16<N>(acc, smem_desc(a + kk * 32), smem_desc(b + kk * 32));
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

// One consumer warpgroup: rows 64 wg .. 64 wg + 63 of every tile of the CTA.
template <int H, bool ENC>
__device__ __forceinline__ void consume(const Params& p,
                                        const TensorMaps& maps, const Smem& s,
                                        unsigned char* smem, long long tiles,
                                        int wg, int tid) {
  using S = Shape<H, ENC>;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int bar_id = 1 + wg;
  // This warpgroup's rows of the first activation block.
  const uint32_t act_wg = s.act + wg * WG_BYTES;
  unsigned char* act_p = smem + wg * WG_BYTES;
  // The two rows of the warpgroup's 64 whose accumulator elements this
  // thread holds: lrow and lrow + 8 (both are g modulo 8).
  const int lrow = warp * 16 + g;

  // Stash mode, before a write-back: the previous layer's stores (started by
  // thread 0) must have read the activation tile.
  auto stores_done = [&]() {
    if (p.stash) {
      if (tid == 0) bulk_wait_read();
      named_bar_sync(bar_id, 128);
    }
  };
  // After a write-back: publish it to the warpgroup's wgmma (and TMA).
  auto publish = [&]() {
    fence_proxy_async();
    named_bar_sync(bar_id, 128);
  };

  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  const float neg_inf = __int_as_float(0xff800000);
  const __nv_bfloat162 neg_inf2 = __floats2bfloat162_rn(neg_inf, neg_inf);
  uint32_t it = 0, round = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
    const long long r0 = tile * BM + wg * WG_ROWS;  // the warpgroup's first row
    const long long grow[2] = {r0 + lrow, r0 + lrow + 8};
    // This tile's IPE: from the TMA load, or from the encoders.
    const uint32_t buf = round % S::IPE_BUFS;
    const uint32_t ipe_wg = s.ipe + buf * S::IPE_BYTES + wg * WG_BYTES;
    mbar_wait(s.ipe_full + 8 * buf, (round / S::IPE_BUFS) & 1);

    // Trunk and fc_feat: bias (+ relu), round to bf16, back into act.
    {
      float acc[H / 2];
#pragma unroll 1
      for (int l = 0; l <= L_FEAT; ++l) {
        layer_products<H, ENC, H>(
            acc, l, p.b + (l < NTRUNK ? p.b_off[0] + l * H : p.b_off[1]), it, s,
            ipe_wg, act_wg, lane);
        if (l == SKIP && lane == 0) mbar_arrive(s.ipe_empty + 8 * buf);
        stores_done();
        // relu after the rounding gives the rounded relu (both monotone, 0
        // kept), on two values at once; fc_feat has no relu.
        const __nv_bfloat162 floor2 = l < NTRUNK ? zero2 : neg_inf2;
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          unsigned char* dst = act_p + (j / 8) * BLOCK_BYTES +
                               swizzle128(lrow, j % 8) + q * 4;
          // Row lrow + 8 is 8 * 128 bytes on, in the same swizzle phase.
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<__nv_bfloat162*>(dst + half * 1024) =
                __hmax2(__floats2bfloat162_rn(acc[4 * j + 2 * half],
                                              acc[4 * j + 2 * half + 1]),
                        floor2);
        }
        publish();
        if (p.stash && tid == 0 && r0 < p.n) {
#pragma unroll
          for (int blk = 0; blk < H / KS; ++blk)
            tma_store_3d(&maps.stash, act_wg + blk * BLOCK_BYTES, blk * KS,
                         (int)r0, l);
          bulk_commit();
        }
      }
    }

    // Dir layer (+ alpha in column DH): h back into act, alpha to out.
    {
      float acc[DHP / 2];
      layer_products<H, ENC, DHP>(acc, L_DIR, p.b + p.b_off[2], it, s, ipe_wg,
                             act_wg, lane);
      stores_done();
      const bool valid[2] = {grow[0] < p.n, grow[1] < p.n};
      const float* dp[2] = {
          p.dproj + (valid[0] ? grow[0] / p.samples : 0) * DH,
          p.dproj + (valid[1] ? grow[1] / p.samples : 0) * DH};
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        // Four column groups' loads in flight at a time, not all sixteen:
        // the accumulators leave no registers for more.
        if (j % 4 == 0) asm volatile("" ::: "memory");
        const int col = j * 8 + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          __nv_bfloat162 h = zero2;
          if (valid[half]) {
            const float2 d = *reinterpret_cast<const float2*>(dp[half] + col);
            h = __hmax2(__floats2bfloat162_rn(acc[4 * j + 2 * half] + d.x,
                                              acc[4 * j + 2 * half + 1] + d.y),
                        zero2);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              act_p + (j / 8) * BLOCK_BYTES + swizzle128(lrow, j % 8) + q * 4 +
              half * 1024) = h;
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (q == 0 && valid[half])
          p.out[grow[half] * p.out_dim + 3] = acc[4 * (DH / 8) + 2 * half];
      publish();
      if (p.stash && tid == 0 && r0 < p.n) {
#pragma unroll
        for (int blk = 0; blk < DH / KS; ++blk)
          tma_store_2d(&maps.stash_h, act_wg + blk * BLOCK_BYTES, blk * KS,
                       (int)r0);
        bulk_commit();
      }
    }

    // Heads: rgb -> out[:, 0:3], (mu, sigma) -> out[:, 4:6].
    {
      float acc[NHEAD / 2];
      layer_products<H, ENC, NHEAD>(acc, L_HEAD, p.b + p.b_off[3], it, s, ipe_wg,
                               act_wg, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (grow[half] >= p.n) continue;
        float* o = p.out + grow[half] * p.out_dim;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * 8 + 2 * q + e;
            const float v = acc[4 * j + 2 * half + e];
            if (col < 3) {
              o[col] = v;
            } else if (col < 5 && p.out_dim == 6) {
              o[col + 1] = v;
            }
          }
      }
    }
  }
  if (p.stash && tid == 0) bulk_wait();
}

template <int H, bool ENC>
__global__ void __launch_bounds__(NTHREADS, 1)
    fused_mlp_fwd_kernel(const Params p,
                         const __grid_constant__ TensorMaps maps) {
  using S = Shape<H, ENC>;
  extern __shared__ unsigned char smem_raw[];
  // Tiles start on a 1024-byte boundary of the shared address space.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  Smem s;
  s.act = base;
  s.ipe = s.act + S::ACT_BYTES;
  s.ring = s.ipe + S::IPE_BUFS * S::IPE_BYTES;
  s.full = s.ring + S::STAGES * S::STAGE_BYTES;
  s.empty = s.full + 8 * MAX_STAGES;
  s.ipe_full = s.empty + 8 * MAX_STAGES;
  s.ipe_empty = s.ipe_full + 8 * 2;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(s.full + 8 * i, 1);   // the producer's arrive.expect_tx
      mbar_init(s.empty + 8 * i, 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < S::IPE_BUFS; ++i) {
      // The producer's arrive.expect_tx, or every encoder.
      mbar_init(s.ipe_full + 8 * i, ENC ? NENCODERS : 1);
      mbar_init(s.ipe_empty + 8 * i, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const long long tiles = (p.n + BM - 1) / BM;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if (threadIdx.x == 0) produce<H, ENC>(maps, s, tiles);
    if constexpr (ENC) {
      if (threadIdx.x >= 128 - NENCODERS)
        encode_tiles<H>(p, s, smem + S::ACT_BYTES, tiles,
                        threadIdx.x - (128 - NENCODERS));
    }
  } else {
    consume<H, ENC>(p, maps, s, smem, tiles, wg - 1, threadIdx.x - wg * 128);
  }
}

// dproj[r, c] = sum_j dirs[r, j] * Wd_dirs[c, j], f32: the dir layer's
// view-direction half, once per ray (bf16 x bf16 products are exact in f32).
// A block of DH threads takes DIR_RAYS rays; thread c keeps row c of Wd_dirs
// in registers.
constexpr int DIR_RAYS = 32;

__global__ void dir_proj_kernel(const bf16* dirs, const bf16* wdirs,
                                float* dproj, long long rays) {
  __shared__ float d[DIR_RAYS * DIRS];
  const long long r0 = (long long)blockIdx.x * DIR_RAYS;
  const int c = threadIdx.x;
  const int here = (int)(rays - r0 < DIR_RAYS ? rays - r0 : DIR_RAYS);
  for (int i = c; i < here * DIRS; i += DH)
    d[i] = __bfloat162float(dirs[r0 * DIRS + i]);
  float w[DIRS];
#pragma unroll
  for (int j = 0; j < DIRS; ++j)
    w[j] = __bfloat162float(wdirs[c * DIRS_LD + j]);
  __syncthreads();
  for (int i = 0; i < here; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < DIRS; ++j) acc = fmaf(d[i * DIRS + j], w[j], acc);
    dproj[(r0 + i) * DH + c] = acc;
  }
}

template <int H, bool ENC>
cudaError_t launch(const Params& p, const bf16* w, const long long* w_off,
                   const bf16* ipe, bf16* stash, bf16* stash_h,
                   cudaStream_t stream) {
  using S = Shape<H, ENC>;
  TensorMaps maps = {};
  bool ok = true;
  for (int l = 0; l < NLAYER; ++l) {
    const cuuint64_t dims[2] = {(cuuint64_t)S::kin(l), (cuuint64_t)S::nout(l)};
    const cuuint64_t strides[1] = {(cuuint64_t)S::kin(l)};
    const cuuint32_t box[2] = {KS, (cuuint32_t)S::nout(l)};
    ok = ok && make_map(&maps.w[l], w + w_off[l], 2, dims, strides, box);
  }
  const cuuint64_t n = (cuuint64_t)p.n;
  if (!ENC) {
    const cuuint64_t dims[2] = {IPE, n}, strides[1] = {IPE};
    const cuuint32_t box[2] = {KS, BM};
    ok = ok && make_map(&maps.ipe, ipe, 2, dims, strides, box);
  }
  if (p.stash) {
    const cuuint64_t dims[3] = {H, n, NTRUNK + 1}, strides[2] = {H, n * H};
    const cuuint32_t box[3] = {KS, WG_ROWS, 1};
    ok = ok && make_map(&maps.stash, stash, 3, dims, strides, box);
    const cuuint64_t dims_h[2] = {DH, n}, strides_h[1] = {DH};
    ok = ok && make_map(&maps.stash_h, stash_h, 2, dims_h, strides_h, box);
  }
  if (!ok) return cudaErrorInvalidValue;

  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  // The opt-in to S::SMEM bytes of dynamic shared memory: once per process
  // and instantiation, not per launch.
  static const cudaError_t setup = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<H, ENC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (setup != cudaSuccess) return setup;
  const long long tiles = (p.n + BM - 1) / BM;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  fused_mlp_fwd_kernel<H, ENC><<<grid, NTHREADS, S::SMEM, stream>>>(p, maps);
  return cudaGetLastError();
}

// The dir projection, then the network at width `hidden`; p.dproj is the
// projection's output.
template <bool ENC>
cudaError_t run(Params& p, const void* ipe, const void* dirs, const void* w,
                void* stash, void* stash_h, int hidden, const long long* w_off,
                const long long* b_off, cudaStream_t st) {
  if (hidden != 64 && hidden != 128 && hidden != 256)
    return cudaErrorInvalidValue;
  // TMA coordinates are 32-bit.
  if (p.n > 0x7fffffffLL - BM) return cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i) p.b_off[i] = b_off[i];
  const bf16* wp = static_cast<const bf16*>(w);
  const long long rays = p.n / p.samples;
  dir_proj_kernel<<<(unsigned)((rays + DIR_RAYS - 1) / DIR_RAYS), DH, 0, st>>>(
      static_cast<const bf16*>(dirs), wp + w_off[W_DIRS],
      const_cast<float*>(p.dproj), rays);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const bf16* ip = static_cast<const bf16*>(ipe);
  bf16* sp = static_cast<bf16*>(stash);
  bf16* hp = static_cast<bf16*>(stash_h);
  switch (hidden) {
    case 64: return launch<64, ENC>(p, wp, w_off, ip, sp, hp, st);
    case 128: return launch<128, ENC>(p, wp, w_off, ip, sp, hp, st);
    default: return launch<256, ENC>(p, wp, w_off, ip, sp, hp, st);
  }
}

}  // namespace

// Launches the dir projection and the fused network on `stream`.  Device
// pointers: ipe [n, 96] bf16, dirs [n / samples, 27] bf16, packed weights
// and biases, dproj [n / samples, 128] f32 scratch, out [n, 4|6] f32, and
// in stash mode stash [9, n, hidden] and stash_h [n, 128] bf16 (both null
// in render mode).  w_off (12 entries) and b_off (4) are host arrays.
// Returns a cudaError_t.
extern "C" int ddnerf_fused_mlp_fwd(const void* ipe, const void* dirs,
                                    const void* w, const void* b, void* dproj,
                                    void* out, void* stash, void* stash_h,
                                    long long n, int samples,
                                    int hidden, int depth_head,
                                    const long long* w_off,
                                    const long long* b_off, void* stream) {
  if (n <= 0 || samples <= 0 || n % samples) return cudaErrorInvalidValue;
  if ((stash == nullptr) != (stash_h == nullptr)) return cudaErrorInvalidValue;
  Params p = {};
  p.b = static_cast<const float*>(b);
  p.dproj = static_cast<const float*>(dproj);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.samples = samples;
  p.out_dim = depth_head ? 6 : 4;
  p.stash = stash != nullptr;
  return run<false>(p, ipe, dirs, w, stash, stash_h, hidden, w_off, b_off,
                    static_cast<cudaStream_t>(stream));
}

// The same network fed the IPE that it computes from means [n, 3] and covs
// [n, 3] f32 (ENC mode; render only, no stash).  Other arguments as
// ddnerf_fused_mlp_fwd's.  Returns a cudaError_t.
extern "C" int ddnerf_fused_enc_mlp_fwd(const void* means, const void* covs,
                                        const void* dirs, const void* w,
                                        const void* b, void* dproj, void* out,
                                        long long n, int samples, int hidden,
                                        int depth_head,
                                        const long long* w_off,
                                        const long long* b_off, void* stream) {
  if (n <= 0 || samples <= 0 || n % samples) return cudaErrorInvalidValue;
  Params p = {};
  p.means = static_cast<const float*>(means);
  p.covs = static_cast<const float*>(covs);
  p.b = static_cast<const float*>(b);
  p.dproj = static_cast<const float*>(dproj);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.samples = samples;
  p.out_dim = depth_head ? 6 : 4;
  return run<true>(p, nullptr, dirs, w, nullptr, nullptr, hidden, w_off, b_off,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* ddnerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
