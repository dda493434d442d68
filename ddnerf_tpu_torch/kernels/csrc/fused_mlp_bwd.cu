// Fused NeRF MLP backward for Hopper (sm_90a): the parameter gradients of
// fused_mlp_fwd.cu for a cotangent g [N, 4|6], from the forward's stash.
//
// Replaces the TPU kernel ddnerf_tpu/kernels/fused_mlp_bwd.py::
// fused_mlp_backward (body _bwd_kernel) with the same rounding points:
//   g -> bf16 on entry;  g_heads = (g_rgb | g_mu, g_sigma), g_alpha = g[:, 3]
//   d_W_heads = h^T g_heads,  d_b_heads = sum g_heads                   (f32)
//   g_h = mask(h > 0, g_heads W_heads),  d_b_dir = sum g_h,  g_h_c = bf16(g_h)
//   d_Wd_feat = feat^T g_h_c,  d_w_alpha = feat^T g_alpha,  d_b_alpha = sum g_alpha
//   g_dproj[ray] = bf16(sum of g_h over the ray's K rows),  d_Wd_dirs = dirs^T g_dproj
//   g_feat = g_h_c Wd_feat + g_alpha w_alpha,  d_bf = sum g_feat,  g_feat_c = bf16
//   d_Wf = x7^T g_feat_c,  gx = g_feat_c Wf
//   for i = 7..0: g_i = mask(x_i > 0, gx), d_b_i = sum g_i (before rounding),
//                 d_W_i = x_{i-1}^T bf16(g_i) (layer 0 reads ipe, layer 5
//                 [ipe | x4]),  gx = bf16(g_i) W_i (x-columns of W5; not at 0)
// Relu masks come from the bf16 stash; every product is bf16 x bf16 with f32
// accumulation; no input gradients (ipe and dirs are detached upstream).
//
// What bounds it on an H100: tensor-core throughput, as the forward (the
// dgrad chain is 10 matmuls per row, the weight gradients another 10), plus
// the device-memory round trip of the bf16 cotangent slabs (~2 (10 H + 300)
// bytes per row written and read once).
//
// Design.  The TPU kernel keeps ~3 MB of f32 gradient accumulators in VMEM
// across a sequential grid; here blocks run in parallel and in no order, and
// a 256 x 256 f32 accumulator alone exceeds a CTA's shared memory.  So the
// backward is three passes, deterministic from run to run (no atomics):
// (a) dgrad_kernel: a CTA of 8 warps owns 128 rows, streams the weights in
//     32-row k-slices with cp.async as the forward does (double buffered,
//     across products), walks the chain above with the cotangent in one
//     shared [128, H] buffer, and writes the bf16 cotangent slabs (g_heads,
//     [g_h_c | g_alpha], g_feat_c, g_0..g_7), g_h in f32 for the per-ray
//     reduction, and its f32 bias-gradient column sums (one partial row per
//     CTA, in the packed bias layout).  dproj_grad_kernel then sums g_h over
//     each ray's rows in order.
// (b) wgrad_kernel: split-K products act^T g over the row axis for every
//     weight matrix in one launch (a task table), 64 x 64 output tiles,
//     mma.sync with both operands loaded transposed by ldmatrix.trans, f32
//     partials per split of 4096 rows.
// (c) reduce_kernel: sums the partials (and the bias partials) over splits
//     in a fixed order into the packed f32 gradients, laid out as the packed
//     weights and biases of kernels/fused_mlp.py::pack_weights.

#include "mma_common.cuh"

namespace {

using namespace ddnerf;

constexpr int BM = 128;          // rows per dgrad CTA
constexpr int NTHREADS = 256;    // 8 warps
constexpr int KS = 32;           // rows of a streamed weight slice
constexpr int GD_LD = DHP + PAD;
constexpr int GH_LD = NHEAD + PAD;
constexpr int NQ = 10;           // dgrad products: heads, dir, feat, W7..W1

struct DgradParams {
  const float* g;       // [n, out_dim]
  const bf16* stash;    // [9, n, H]: x0..x7, feat
  const bf16* stash_h;  // [n, 128]
  const bf16* w;        // packed weights
  bf16* gh;             // [n, 16] g_heads
  bf16* gd;             // [n, 144] g_h_c | g_alpha | 0
  float* ghf;           // [n, 128] g_h, f32
  bf16* gf;             // [n, H] g_feat_c
  bf16* gt;             // [8, n, H] bf16(g_0) .. bf16(g_7)
  float* bpart;         // [n_cta, nb] bias-gradient partials
  long long n;
  int out_dim;
  int nb;
  long long w_off[NW];
  long long b_off[NB_OFF];
};

template <int H>
struct BShape {
  static constexpr int ACT_LD = H + PAD;
  static constexpr int WN = H > DH ? H : DH;  // widest streamed slice
  static constexpr int WS_LD = WN + PAD;
  static constexpr int WSTAGE = KS * WS_LD;
  static constexpr size_t ACT_BYTES = size_t(BM) * ACT_LD * sizeof(bf16);
  static constexpr size_t GD_BYTES = size_t(BM) * GD_LD * sizeof(bf16);
  static constexpr size_t GH_BYTES = size_t(BM) * GH_LD * sizeof(bf16);
  static constexpr size_t W_BYTES = size_t(2) * WSTAGE * sizeof(bf16);
  static constexpr size_t RED_BYTES = size_t(2) * WN * sizeof(float);
  static constexpr size_t SMEM =
      ACT_BYTES + GD_BYTES + GH_BYTES + W_BYTES + RED_BYTES;
};

// Product q of the dgrad chain: out = A @ W[rows 0..k, col0 : col0 + nout].
struct Prod {
  const bf16* w;
  int k, ld, col0, nout;
};

template <int H>
__device__ __forceinline__ Prod product(const DgradParams& p, int q) {
  if (q == 0) return {p.w + p.w_off[W_HEAD], NHEAD, DH, 0, DH};
  if (q == 1) return {p.w + p.w_off[W_DIR], DHP, H, 0, H};
  if (q == 2) return {p.w + p.w_off[W_FEAT], H, H, 0, H};
  const int i = NQ - q;  // q = 3..9 -> W7..W1
  return {p.w + p.w_off[i], H, i == SKIP ? IPE + H : H, i == SKIP ? IPE : 0,
          H};
}

// Slice s of product q: W rows [s KS, s KS + KS) -> dst [KS][WS_LD].
template <int H>
__device__ __forceinline__ void load_slice(const DgradParams& p, bf16* dst,
                                           int q, int s) {
  const Prod pr = product<H>(p, q);
  const int r_beg = s * KS;
  const int nr = min(KS, pr.k - r_beg);
  const int cpr = pr.nout / 8;
  for (int c = threadIdx.x; c < nr * cpr; c += NTHREADS) {
    const int r = c / cpr, q8 = c % cpr;
    cp_async16(dst + r * BShape<H>::WS_LD + q8 * 8,
               pr.w + (long long)(r_beg + r) * pr.ld + pr.col0 + q8 * 8);
  }
}

// acc[4][NT] = A[row0 : row0 + 64, 0:k] @ W_q[0:k, n0 : n0 + 8 NT].  The
// slice being multiplied is in wst[stage]; each step first issues the next
// slice of the stream (this product's or the next one's).
template <int H, int NT>
__device__ __forceinline__ void gemm(const DgradParams& p, int q, int& stage,
                                     const bf16* a, int lda, bf16* wst,
                                     int row0, int n0, float (&acc)[4][NT][4]) {
  using S = BShape<H>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int k = product<H>(p, q).k;
  const int ns = (k + KS - 1) / KS;
#pragma unroll 1
  for (int s = 0; s < ns; ++s) {
    const bool last = s + 1 == ns;
    const int nq = last ? q + 1 : q;
    if (nq < NQ) {
      load_slice<H>(p, wst + (stage ^ 1) * S::WSTAGE, nq, last ? 0 : s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int nr = min(KS, k - s * KS);
    const bf16* w = wst + stage * S::WSTAGE;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      if (kk >= nr) break;
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], a + (row0 + mt * 16 + (lane & 15)) * lda +
                                s * KS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];  // b0, b1 of n-tile 2np, then of n-tile 2np + 1
        ldmatrix_x4_trans(
            bfr, w + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::WS_LD +
                     n0 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the slice after next
    stage ^= 1;
  }
}

// Epilogue of a product of width `width`: optional relu mask from the bf16
// stash (mask [n, width]), bf16 rounding into shared memory (sdst) and the
// slab gdst [n, gld], optional f32 copy fdst [n, width], and the f32 column
// sums of the tile into red [2][width] (one row per warp row; the caller
// adds the two rows after a barrier).
template <int NT>
__device__ __forceinline__ void epilogue(float (&acc)[4][NT][4], int row0,
                                         int n0, int width, const bf16* mask,
                                         bf16* sdst, int sld, bf16* gdst,
                                         int gld, float* fdst, long long r0,
                                         long long n, float* red) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = threadIdx.x >> 7;  // warp row: warps 0-3 -> 0, 4-7 -> 1
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + 2 * t;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + mt * 16 + g + half * 8;
        const long long grow = r0 + row;
        const bool valid = grow < n;
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (mask != nullptr) {
          float m0 = 0.f, m1 = 0.f;
          if (valid) {
            const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(
                mask + grow * width + col);
            m0 = __bfloat162float(m.x);
            m1 = __bfloat162float(m.y);
          }
          v0 = m0 > 0.f ? v0 : 0.f;
          v1 = m1 > 0.f ? v1 : 0.f;
        }
        s0 += v0;
        s1 += v1;
        const __nv_bfloat162 c = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(sdst + row * sld + col) = c;
        if (valid) {
          *reinterpret_cast<__nv_bfloat162*>(gdst + grow * gld + col) = c;
          if (fdst != nullptr)
            *reinterpret_cast<float2*>(fdst + grow * width + col) =
                make_float2(v0, v1);
        }
      }
    // Sum over the 8 row groups g of the warp (lanes t, t + 4, ...).
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (g == 0) {
      red[wr * width + col] = s0;
      red[wr * width + col + 1] = s1;
    }
  }
}

// After the epilogue's barrier: the CTA's column sums -> its partial row.
__device__ __forceinline__ void bias_partial(const float* red, int width,
                                             float* dst) {
  for (int c = threadIdx.x; c < width; c += NTHREADS)
    dst[c] = red[c] + red[width + c];
}

template <int H>
__global__ void __launch_bounds__(NTHREADS, 1)
    dgrad_kernel(const DgradParams p) {
  using S = BShape<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* gd_s = reinterpret_cast<bf16*>(smem + S::ACT_BYTES);
  bf16* gh_s = reinterpret_cast<bf16*>(smem + S::ACT_BYTES + S::GD_BYTES);
  bf16* wst = reinterpret_cast<bf16*>(smem + S::ACT_BYTES + S::GD_BYTES +
                                      S::GH_BYTES);
  float* red = reinterpret_cast<float*>(smem + S::ACT_BYTES + S::GD_BYTES +
                                        S::GH_BYTES + S::W_BYTES);

  const long long r0 = (long long)blockIdx.x * BM;
  const long long n = p.n;
  const int tid = threadIdx.x, warp = tid >> 5;
  float* bp = p.bpart + (long long)blockIdx.x * p.nb;

  load_slice<H>(p, wst, 0, 0);
  cp_async_commit();
  int stage = 0;

  // The cotangent tile, rounded to bf16: heads [BM][16] (rgb | mu, sigma)
  // and the dir-layer columns 128..143 of [g_h_c | g_alpha | 0].
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int c = tid; c < BM * NHEAD; c += NTHREADS) {
    const int r = c / NHEAD, j = c % NHEAD;
    const long long grow = r0 + r;
    float v = 0.f, a = 0.f;
    if (grow < n) {
      const float* gr = p.g + grow * p.out_dim;
      if (j < 3) {
        v = gr[j];
      } else if (j < 5 && p.out_dim == 6) {
        v = gr[j + 1];
      }
      if (j == 0) a = gr[3];
    }
    const bf16 vb = __float2bfloat16_rn(v);
    const bf16 ab = j == 0 ? __float2bfloat16_rn(a) : zero;
    gh_s[r * GH_LD + j] = vb;
    gd_s[r * GD_LD + DH + j] = ab;
    if (grow < n) {
      p.gh[grow * NHEAD + j] = vb;
      p.gd[grow * DHP + DH + j] = ab;
    }
  }
  __syncthreads();
  // d_b_heads and d_b_alpha (+ the dir layer's zero pad): column sums.
  if (tid < 2 * NHEAD) {
    const bool head = tid < NHEAD;
    const bf16* col = head ? gh_s + tid : gd_s + DH + (tid - NHEAD);
    const int ld = head ? GH_LD : GD_LD;
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s += __bfloat162float(col[r * ld]);
    bp[head ? p.b_off[3] + tid : p.b_off[2] + DH + (tid - NHEAD)] = s;
  }

  const int row0 = (warp >> 2) * 64;
  // Heads: g_h = g_heads @ W_heads, masked by h > 0.
  {
    constexpr int NT = DH / 32;
    const int n0 = (warp & 3) * (DH / 4);
    float acc[4][NT][4];
    gemm<H, NT>(p, 0, stage, gh_s, GH_LD, wst, row0, n0, acc);
    epilogue<NT>(acc, row0, n0, DH, p.stash_h, gd_s, GD_LD, p.gd, DHP, p.ghf,
                 r0, n, red);
    __syncthreads();
    bias_partial(red, DH, bp + p.b_off[2]);
  }
  {
    constexpr int NT = H / 32;
    const int n0 = (warp & 3) * (H / 4);
    float acc[4][NT][4];
    // Dir layer: g_feat = [g_h_c | g_alpha] @ [Wd_feat; w_alpha].
    gemm<H, NT>(p, 1, stage, gd_s, GD_LD, wst, row0, n0, acc);
    epilogue<NT>(acc, row0, n0, H, nullptr, act, S::ACT_LD, p.gf, H, nullptr,
                 r0, n, red);
    __syncthreads();
    bias_partial(red, H, bp + p.b_off[1]);
    // fc_feat, then W7..W1: gx = bf16(g) @ W, g_i = mask(x_i > 0, gx).
#pragma unroll 1
    for (int q = 2; q < NQ; ++q) {
      const int i = NQ - 1 - q;
      gemm<H, NT>(p, q, stage, act, S::ACT_LD, wst, row0, n0, acc);
      epilogue<NT>(acc, row0, n0, H, p.stash + i * n * H, act, S::ACT_LD,
                   p.gt + i * n * H, H, nullptr, r0, n, red);
      __syncthreads();
      bias_partial(red, H, bp + p.b_off[0] + i * H);
    }
  }
}

// g_dproj[ray, c] = bf16(sum over the ray's rows of g_h[row, c]), in row
// order.
__global__ void dproj_grad_kernel(const float* ghf, bf16* gdp, int samples) {
  const long long ray = blockIdx.x;
  const int c = threadIdx.x;
  const float* src = ghf + ray * samples * DH + c;
  float s = 0.f;
  for (int k = 0; k < samples; ++k) s += src[(long long)k * DH];
  gdp[ray * DH + c] = __float2bfloat16_rn(s);
}

// ---------------------------------------------------------------- wgrad

constexpr int WG_THREADS = 128;  // 4 warps, 2 x 2 over the output tile
constexpr int WG_M = 64, WG_N = 64, WG_K = 32;
constexpr int WG_LD = 64 + PAD;
constexpr int SPLIT_ROWS = 4096;  // rows per split-K partial
constexpr int MAX_TASKS = 14;

// dst[m, c] (+ over splits) = sum_r g[r, m] a[r, c]: one weight gradient.
struct WTask {
  const bf16* g;
  const bf16* a;
  long long rows;
  long long part;  // float offset of this task's [splits, m, n] partials
  long long dst;   // float offset of dst[0, 0] in the packed gradient
  int ldg, lda, m, n, ld_dst;
  int splits, tiles_n, cta_begin;
};

struct WParams {
  WTask t[MAX_TASKS];
  int ntask;
  float* part;
};

// Rows [base, base + WG_K) of the task's g columns [m0, m0 + 64) and
// activation columns [n0, n0 + 64) -> gsd / asd [WG_K][WG_LD]; rows past
// `re` and columns past m / n are zero.
__device__ __forceinline__ void wg_load(bf16 (*gsd)[WG_LD],
                                        bf16 (*asd)[WG_LD], const WTask& T,
                                        long long base, long long re, int m0,
                                        int n0) {
  for (int c = threadIdx.x; c < WG_K * 8; c += WG_THREADS) {
    const int r = c >> 3, q = c & 7;
    const long long row = base + r;
    const int gc = m0 + q * 8, ac = n0 + q * 8;
    if (row < re && gc < T.m)
      cp_async16(&gsd[r][q * 8], T.g + row * T.ldg + gc);
    else
      *reinterpret_cast<uint4*>(&gsd[r][q * 8]) = make_uint4(0u, 0u, 0u, 0u);
    if (row < re && ac < T.n)
      cp_async16(&asd[r][q * 8], T.a + row * T.lda + ac);
    else
      *reinterpret_cast<uint4*>(&asd[r][q * 8]) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__global__ void __launch_bounds__(WG_THREADS) wgrad_kernel(const WParams P) {
  __shared__ __align__(128) bf16 gs[2][WG_K][WG_LD];
  __shared__ __align__(128) bf16 a_s[2][WG_K][WG_LD];
  int ti = 0;
  while (ti + 1 < P.ntask && (int)blockIdx.x >= P.t[ti + 1].cta_begin) ++ti;
  const WTask& T = P.t[ti];
  int local = blockIdx.x - T.cta_begin;
  const int split = local % T.splits;
  local /= T.splits;
  const int m0 = (local / T.tiles_n) * WG_M, n0 = (local % T.tiles_n) * WG_N;
  const long long rb = (long long)split * SPLIT_ROWS;
  const long long re = min(T.rows, rb + SPLIT_ROWS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const long long nch = (re - rb + WG_K - 1) / WG_K;
  wg_load(gs[0], a_s[0], T, rb, re, m0, n0);
  cp_async_commit();
#pragma unroll 1
  for (long long ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      const int nx = (ch + 1) & 1;
      wg_load(gs[nx], a_s[nx], T, rb + (ch + 1) * WG_K, re, m0, n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = ch & 1;
#pragma unroll
    for (int kk = 0; kk < WG_K; kk += 16) {
      uint32_t af[2][4];  // A' = g^T: rows m, columns r
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4_trans(af[mt], &gs[st][kk + ((lane >> 4) << 3) + (lane & 7)]
                                     [wm + mt * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];  // B' = a: rows r, columns c
        ldmatrix_x4_trans(bfr, &a_s[st][kk + ((lane >> 3) & 1) * 8 + (lane & 7)]
                                  [wn + np * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }

  float* out = P.part + T.part + (long long)split * T.m * T.n;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + mt * 16 + g + half * 8;
        const int c = n0 + wn + nt * 8 + 2 * t;
        if (m < T.m && c < T.n)
          *reinterpret_cast<float2*>(out + (long long)m * T.n + c) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
}

// ---------------------------------------------------------------- reduce

struct RTask {
  const float* src;  // [splits, m * n]
  float* dst;        // dst[m * ld + c]
  long long begin;   // first element of this task in the launch
  int splits, m, n, ld;
};

struct RParams {
  RTask t[MAX_TASKS + 1];
  int ntask;
};

__global__ void reduce_kernel(const RParams R) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int ti = 0;
  while (ti + 1 < R.ntask && e >= R.t[ti + 1].begin) ++ti;
  const RTask& T = R.t[ti];
  const long long count = (long long)T.m * T.n;
  const long long local = e - T.begin;
  if (local < 0 || local >= count) return;
  float s = 0.f;
  for (int sp = 0; sp < T.splits; ++sp) s += T.src[sp * count + local];
  T.dst[(local / T.n) * T.ld + local % T.n] = s;
}

// ------------------------------------------------------------- workspace

struct Layout {
  size_t gh, gd, ghf, gf, gt, bpart, gdp, part, total;
};

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

long long splits_of(long long rows) {
  return rows <= 0 ? 1 : (rows + SPLIT_ROWS - 1) / SPLIT_ROWS;
}

// The weight-gradient tasks' (m, n, rows): see make_tasks.
long long partial_floats(long long n, long long rays, int hidden) {
  const long long s = splits_of(n);
  const long long h = hidden;
  long long f = s * (NHEAD * DH + DHP * h + h * h + 7 * h * h + 2 * h * IPE);
  f += splits_of(rays) * DH * DIRS_LD;
  return f;
}

Layout layout(long long n, int samples, int hidden) {
  const long long rays = n / samples, ncta = (n + BM - 1) / BM;
  const long long nb = 9LL * hidden + DHP + NHEAD;
  Layout L;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  L.gh = take(n * NHEAD * sizeof(bf16));
  L.gd = take(n * DHP * sizeof(bf16));
  L.ghf = take(n * DH * sizeof(float));
  L.gf = take(n * hidden * sizeof(bf16));
  L.gt = take(8 * n * hidden * sizeof(bf16));
  L.bpart = take(ncta * nb * sizeof(float));
  L.gdp = take(rays * DH * sizeof(bf16));
  L.part = take(partial_floats(n, rays, hidden) * sizeof(float));
  L.total = off;
  return L;
}

template <int H>
cudaError_t launch_dgrad(const DgradParams& p, cudaStream_t stream) {
  const size_t smem = BShape<H>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      dgrad_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (p.n + BM - 1) / BM;
  dgrad_kernel<H><<<(unsigned)blocks, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of device workspace that ddnerf_fused_mlp_bwd needs.
extern "C" long long ddnerf_fused_mlp_bwd_workspace(long long n, int samples,
                                                    int hidden) {
  if (n <= 0 || samples <= 0 || n % samples) return -1;
  return (long long)layout(n, samples, hidden).total;
}

// Parameter gradients of the fused MLP on `stream`.  Device pointers: ipe
// [n, 96] bf16, dirs [n / samples, 32] bf16 (27 features, zero padded), g
// [n, 4|6] f32, the forward's stash [9, n, hidden] and stash_h [n, 128]
// bf16, packed bf16 weights w; outputs gw (f32, laid out as w) and gb (f32,
// laid out as the packed biases); ws a workspace of
// ddnerf_fused_mlp_bwd_workspace bytes.  w_off (12 entries) and b_off (4)
// are host arrays.  Returns a cudaError_t.
extern "C" int ddnerf_fused_mlp_bwd(
    const void* ipe, const void* dirs, const void* g, const void* stash,
    const void* stash_h, const void* w, void* gw, void* gb, void* ws,
    long long ws_bytes, long long n, int samples, int hidden, int depth_head,
    const long long* w_off, const long long* b_off, void* stream) {
  if (n <= 0 || samples <= 0 || n % samples) return cudaErrorInvalidValue;
  if (hidden != 64 && hidden != 128 && hidden != 256)
    return cudaErrorInvalidValue;
  const Layout L = layout(n, samples, hidden);
  if (ws_bytes < (long long)L.total) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* base = static_cast<unsigned char*>(ws);
  const long long rays = n / samples, h = hidden;
  const long long ncta = (n + BM - 1) / BM;
  const int nb = 9 * hidden + DHP + NHEAD;
  const bf16* sb = static_cast<const bf16*>(stash);
  float* gwf = static_cast<float*>(gw);

  DgradParams p;
  p.g = static_cast<const float*>(g);
  p.stash = sb;
  p.stash_h = static_cast<const bf16*>(stash_h);
  p.w = static_cast<const bf16*>(w);
  p.gh = reinterpret_cast<bf16*>(base + L.gh);
  p.gd = reinterpret_cast<bf16*>(base + L.gd);
  p.ghf = reinterpret_cast<float*>(base + L.ghf);
  p.gf = reinterpret_cast<bf16*>(base + L.gf);
  p.gt = reinterpret_cast<bf16*>(base + L.gt);
  p.bpart = reinterpret_cast<float*>(base + L.bpart);
  p.n = n;
  p.out_dim = depth_head ? 6 : 4;
  p.nb = nb;
  for (int i = 0; i < NW; ++i) p.w_off[i] = w_off[i];
  for (int i = 0; i < NB_OFF; ++i) p.b_off[i] = b_off[i];
  if (b_off[3] + NHEAD != nb) return cudaErrorInvalidValue;

  cudaError_t e;
  switch (hidden) {
    case 64: e = launch_dgrad<64>(p, st); break;
    case 128: e = launch_dgrad<128>(p, st); break;
    default: e = launch_dgrad<256>(p, st); break;
  }
  if (e != cudaSuccess) return e;
  bf16* gdp = reinterpret_cast<bf16*>(base + L.gdp);
  dproj_grad_kernel<<<(unsigned)rays, DH, 0, st>>>(p.ghf, gdp, samples);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  // Weight-gradient tasks: (g slab, activation, rows, m, n, dst, ld).
  WParams W;
  W.part = reinterpret_cast<float*>(base + L.part);
  int nt = 0;
  long long part = 0, ctas = 0;
  auto add = [&](const bf16* gs, int ldg, const bf16* a, int lda,
                 long long rows, int m, int nn, long long dst, int ld) {
    WTask& T = W.t[nt++];
    T.g = gs;
    T.ldg = ldg;
    T.a = a;
    T.lda = lda;
    T.rows = rows;
    T.m = m;
    T.n = nn;
    T.dst = dst;
    T.ld_dst = ld;
    T.splits = (int)splits_of(rows);
    T.tiles_n = (nn + WG_N - 1) / WG_N;
    T.cta_begin = (int)ctas;
    T.part = part;
    ctas += (long long)T.splits * T.tiles_n * ((m + WG_M - 1) / WG_M);
    part += (long long)T.splits * m * nn;
  };
  const bf16* ipe_b = static_cast<const bf16*>(ipe);
  add(p.gh, NHEAD, p.stash_h, DH, n, NHEAD, DH, w_off[W_HEAD], DH);
  add(p.gd, DHP, sb + 8 * n * h, hidden, n, DHP, hidden, w_off[W_DIR], hidden);
  add(p.gf, hidden, sb + 7 * n * h, hidden, n, hidden, hidden, w_off[W_FEAT],
      hidden);
  for (int i = NTRUNK - 1; i >= 1; --i) {
    const int kin = i == SKIP ? IPE + hidden : hidden;
    add(p.gt + i * n * h, hidden, sb + (i - 1) * n * h, hidden, n, hidden,
        hidden, w_off[i] + (i == SKIP ? IPE : 0), kin);
    if (i == SKIP)
      add(p.gt + i * n * h, hidden, ipe_b, IPE, n, hidden, IPE, w_off[i], kin);
  }
  add(p.gt, hidden, ipe_b, IPE, n, hidden, IPE, w_off[0], IPE);
  add(gdp, DH, static_cast<const bf16*>(dirs), DIRS_LD, rays, DH, DIRS_LD,
      w_off[W_DIRS], DIRS_LD);
  W.ntask = nt;
  if (part > partial_floats(n, rays, hidden)) return cudaErrorInvalidValue;
  wgrad_kernel<<<(unsigned)ctas, WG_THREADS, 0, st>>>(W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  // Reduce the split partials into gw and the bias partials into gb.
  RParams R;
  long long elems = 0;
  for (int i = 0; i < nt; ++i) {
    const WTask& T = W.t[i];
    RTask& Q = R.t[i];
    Q.src = W.part + T.part;
    Q.dst = gwf + T.dst;
    Q.begin = elems;
    Q.splits = T.splits;
    Q.m = T.m;
    Q.n = T.n;
    Q.ld = T.ld_dst;
    elems += (long long)T.m * T.n;
  }
  RTask& B = R.t[nt];
  B.src = p.bpart;
  B.dst = static_cast<float*>(gb);
  B.begin = elems;
  B.splits = (int)ncta;
  B.m = 1;
  B.n = nb;
  B.ld = nb;
  elems += nb;
  R.ntask = nt + 1;
  reduce_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(R);
  return cudaGetLastError();
}
