// Fused NeRF MLP forward for Hopper (sm_90a): the whole MipMLP /
// DepthMipMLP network for a tile of rows in one kernel, every activation
// kept in shared memory.
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
// Matmul operands are bf16 and every product accumulates in f32; each trunk
// output and h are rounded to bf16 after bias + relu, feat after its bias,
// exactly where the TPU kernel rounds.  The output is f32 [N, 4|6] =
// (rgb, alpha[, raw_mu, raw_sigma]).
//
// Stash mode (the activations the backward kernel fused_mlp_bwd.cu reads):
// after each layer's write-back to shared memory the tile is also copied to
// device memory, bf16, in the split layout of the TPU kernel's
// split_h_stash: trunk slabs x0..x6 as [7, N, H] and h as [N, 128].  This
// port also stashes x7 and feat, as slabs 7 and 8 of the same [9, N, H]
// buffer, so the backward reads them instead of recomputing them from x6
// (the values are the same either way).  The stash changes no arithmetic:
// the outputs are bit-identical to a render-mode launch.
//
// What bounds it on an H100: tensor-core throughput.  A row costs ~0.6
// MFLOP x 2 against ~200 bytes of input and 16-24 bytes of output, and the
// ~1.2 MB of bf16 weights per network are re-read by every tile from L2.
// Stash mode adds 2 * (9 H + 128) bytes of writes per row.  ENC mode reads
// 24 bytes per row instead of the IPE's 192 and spends 48 expf and 96 sinf
// (and, past 100 pi, fmodf) per row on the encode, which nothing overlaps:
// about 10% of the time at width 256 (3.3 vs 3.0 ms per 524,288-row chunk
// on an H100 80GB HBM3 at 700 W).
//
// Design (first, simple version; wgmma/TMA are later work):
// * A CTA of 8 warps owns BM = 128 rows.  Its activations live in one
//   [BM, max(H, 128)] bf16 shared buffer that each layer overwrites in place: the
//   warps hold the whole layer output in registers, meet at a barrier, then
//   write it back.  The tile's IPE rows stay in shared memory for layer 0
//   and the skip layer.
// * Weights do not fit beside that in one SM's shared memory, so they
//   stream from L2 in k-slices of 32 columns ([n_out, 32] bf16), double
//   buffered with cp.async, one slice ahead, across layer boundaries.
// * Products are mma.sync m16n8k16 bf16 -> f32 with ldmatrix fragments.
//   Trunk layers tile the CTA 2 x 4 over warps (64 x H/4 per warp); the
//   narrow dir and head layers give each warp 16 rows and every column.
// * fc_alpha rides the dir layer as its output column 128 (the merged
//   [Wd_feat | Wa] matmul of the JAX module path); the per-ray dir
//   projection comes from a small first kernel into an f32 [N/K, 128]
//   scratch buffer, so K is a runtime value and any N is accepted (rows
//   past N are masked).
//
// Weight/bias packing: see mma_common.cuh (built by
// kernels/fused_mlp.py::pack_weights).

#include "mma_common.cuh"

namespace {

using namespace ddnerf;

constexpr int BM = 128;          // rows per CTA
constexpr int NTHREADS = 256;    // 8 warps
constexpr int KS = 32;           // k-slice of streamed weights
constexpr int L_FEAT = W_FEAT, L_DIR = W_DIR, L_HEAD = W_HEAD, NLAYER = 11;
constexpr int IPE_LD = IPE + PAD;
constexpr int WS_LD = KS + PAD;

struct Params {
  const bf16* ipe;     // [n, 96]; null in ENC mode
  const float* means;  // [n, 3]; ENC mode only
  const float* covs;   // [n, 3]; ENC mode only
  const bf16* w;       // packed weights
  const float* b;      // packed biases
  const float* dproj;  // [n / samples, 128]
  float* out;          // [n, out_dim]
  bf16* stash;         // [9, n, H] x0..x7, feat; null in render mode
  bf16* stash_h;       // [n, 128] h; null in render mode
  long long n;
  int samples;
  int out_dim;
  long long w_off[NLAYER];
  long long b_off[4];
};

template <int H>
struct Shape {
  // act holds the trunk (H wide) and later h (DH wide).
  static constexpr int ACT_LD = (H > DH ? H : DH) + PAD;
  static constexpr int MAX_NOUT = H > DHP ? H : DHP;
  static constexpr int WSTAGE = MAX_NOUT * WS_LD;  // elements per stage
  static constexpr size_t ACT_BYTES = size_t(BM) * ACT_LD * sizeof(bf16);
  static constexpr size_t IPE_BYTES = size_t(BM) * IPE_LD * sizeof(bf16);
  static constexpr size_t W_BYTES = size_t(2) * WSTAGE * sizeof(bf16);
  static constexpr size_t SMEM = ACT_BYTES + IPE_BYTES + W_BYTES;
  __host__ __device__ static constexpr int nout(int l) {
    return l <= L_FEAT ? H : (l == L_DIR ? DHP : NHEAD);
  }
  __host__ __device__ static constexpr int kin(int l) {
    return l == 0 ? IPE : (l == SKIP ? IPE + H : (l == L_HEAD ? DH : H));
  }
};

// Slice s of layer l's weights, W[:, s*KS : s*KS+KS] -> dst [n_out][WS_LD].
template <int H>
__device__ __forceinline__ void load_slice(const Params& p, bf16* dst, int l,
                                           int s) {
  const int nout = Shape<H>::nout(l), kin = Shape<H>::kin(l);
  const bf16* src = p.w + p.w_off[l] + s * KS;
  constexpr int CPR = KS / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < nout * CPR; c += NTHREADS) {
    const int r = c / CPR, q = c % CPR;
    cp_async16(dst + r * WS_LD + q * 8, src + (long long)r * kin + q * 8);
  }
}

// The tile's IPE rows -> ipe_s [BM][IPE_LD]; rows past n are zero.
__device__ __forceinline__ void load_ipe(const Params& p, bf16* ipe_s,
                                         long long r0) {
  constexpr int CPR = IPE / 8;
  for (int c = threadIdx.x; c < BM * CPR; c += NTHREADS) {
    const int r = c / CPR, q = c % CPR;
    bf16* dst = ipe_s + r * IPE_LD + q * 8;
    if (r0 + r < p.n) {
      cp_async16(dst, p.ipe + (r0 + r) * IPE + q * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// ENC mode: the tile's IPE computed into ipe_s [BM][IPE_LD] from the raw
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
// intrinsic loses accuracy.  Rows past n are zero, as load_ipe's.
// means / covs rows are 12 bytes, so they are read with plain loads.
//
// The tile's 8 warps have nothing else to run while they encode, so each
// thread takes one (row, coordinate, half of the levels) item and climbs
// its LPI levels unrolled, scaling y by 2 and v by 4 per level (exact, so
// the values are those of x * 2^l and cov * 4^l): LPI independent
// expf / sinf chains in flight instead of one.
__device__ __forceinline__ float wrap_trig(float y) {
  constexpr float T = 314.159265358979323846f;  // (float)(100 pi)
  if (fabsf(y) < T) return y;
  float m = fmodf(y, T);
  if (m < 0.f) m += T;
  return m;
}

__device__ __forceinline__ void encode_ipe(const Params& p, bf16* ipe_s,
                                           long long r0) {
  constexpr int HALF = IPE / 2;    // 48 = 16 levels x 3 coordinates
  constexpr int LPI = 8;           // levels per item
  constexpr int IPR = HALF / LPI;  // items per row: 3 coordinates x 2
  constexpr float HALF_PI = 1.57079632679489661923f;
  for (int c = threadIdx.x; c < BM * IPR; c += NTHREADS) {
    const int r = c / IPR, j = c % 3, l0 = (c % IPR) / 3 * LPI;
    bf16* dst = ipe_s + r * IPE_LD + l0 * 3 + j;  // level l0, coordinate j
    if (r0 + r >= p.n) {
#pragma unroll
      for (int i = 0; i < LPI; ++i) {
        dst[i * 3] = __float2bfloat16_rn(0.f);
        dst[HALF + i * 3] = __float2bfloat16_rn(0.f);
      }
      continue;
    }
    const float f = (float)(1 << l0);
    float y = p.means[(r0 + r) * 3 + j] * f;
    float v = p.covs[(r0 + r) * 3 + j] * (f * f);
#pragma unroll
    for (int i = 0; i < LPI; ++i) {
      const float att = expf(-0.5f * v);
      dst[i * 3] = __float2bfloat16_rn(att * sinf(wrap_trig(y)));
      dst[HALF + i * 3] =
          __float2bfloat16_rn(att * sinf(wrap_trig(y + HALF_PI)));
      y *= 2.f;
      v *= 4.f;
    }
  }
}

// acc[MT][NT] (+)= A[row0 : row0 + 16 MT, :] @ W_l^T[:, n0 : n0 + 8 NT] over
// all of layer l's k-slices.  The slice being multiplied is in wst[stage];
// each step first issues the next slice of the whole stream (this layer's
// or the next one's) into the other stage.
template <int H, int MT, int NT>
__device__ __forceinline__ void gemm_layer(const Params& p, int l, int& stage,
                                           const bf16* act, const bf16* ipe_s,
                                           bf16* wst, int row0, int n0,
                                           float (&acc)[MT][NT][4]) {
  using S = Shape<H>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int ns = S::kin(l) / KS;
#pragma unroll 1
  for (int s = 0; s < ns; ++s) {
    const bool last = s + 1 == ns;
    const int nl = last ? l + 1 : l;
    if (nl < NLAYER) {
      load_slice<H>(p, wst + (stage ^ 1) * S::WSTAGE, nl, last ? 0 : s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Layer 0 reads the IPE; the skip layer reads [ipe | x], the IPE part
    // being its first IPE / KS slices; every other layer reads act.
    const bool from_ipe = l == 0 || (l == SKIP && s < IPE / KS);
    const bf16* a = from_ipe ? ipe_s : act;
    const int lda = from_ipe ? IPE_LD : S::ACT_LD;
    const int ka = (l == SKIP && !from_ipe ? s - IPE / KS : s) * KS;
    const bf16* w = wst + stage * S::WSTAGE;

#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt],
                    a + (row0 + mt * 16 + (lane & 15)) * lda + ka + kk +
                        (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];  // b0, b1 of n-tile 2np, then of n-tile 2np + 1
        ldmatrix_x4(bfr, w + (n0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                 WS_LD +
                             kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the slice after next
    stage ^= 1;
  }
}

// Trunk / feat epilogue: bias (+ relu), round to bf16, back into act.
template <int H, int MT, int NT, bool RELU>
__device__ __forceinline__ void store_act(bf16* act, const float* bias,
                                          int row0, int n0,
                                          const float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + 2 * t;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + mt * 16 + g + half * 8;
        float v0 = acc[mt][nt][2 * half] + b0;
        float v1 = acc[mt][nt][2 * half + 1] + b1;
        if (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(act + row * Shape<H>::ACT_LD +
                                           col) = __floats2bfloat162_rn(v0, v1);
      }
  }
}

// Stash mode: copy the tile's rows of act ([BM][ld], `width` columns) to
// dst [n, width] in 16-byte chunks (rows past n are skipped).  Call after a
// barrier that follows the write-back.
__device__ __forceinline__ void stash_tile(const bf16* act, int ld, int width,
                                           bf16* dst, long long r0,
                                           long long n) {
  const int cpr = width / 8;
  for (int c = threadIdx.x; c < BM * cpr; c += NTHREADS) {
    const int r = c / cpr, q = c % cpr;
    if (r0 + r < n)
      *reinterpret_cast<uint4*>(dst + (r0 + r) * width + q * 8) =
          *reinterpret_cast<const uint4*>(act + r * ld + q * 8);
  }
}

template <int H, bool ENC>
__global__ void __launch_bounds__(NTHREADS, 1)
    fused_mlp_fwd_kernel(const Params p) {
  using S = Shape<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* ipe_s = reinterpret_cast<bf16*>(smem + S::ACT_BYTES);
  bf16* wst = reinterpret_cast<bf16*>(smem + S::ACT_BYTES + S::IPE_BYTES);

  const long long r0 = (long long)blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  if (ENC) {
    // The first weight slice streams from L2 while the tile is encoded; the
    // first gemm_layer step's barrier publishes ipe_s.
    load_slice<H>(p, wst, 0, 0);
    cp_async_commit();
    encode_ipe(p, ipe_s, r0);
  } else {
    load_ipe(p, ipe_s, r0);
    load_slice<H>(p, wst, 0, 0);
    cp_async_commit();
  }
  int stage = 0;

  // Trunk and fc_feat: warps tile the CTA 2 (rows) x 4 (columns).
  {
    constexpr int NT = H / 32;
    const int row0 = (warp >> 2) * 64, n0 = (warp & 3) * (H / 4);
    float acc[4][NT][4];
#pragma unroll 1
    for (int l = 0; l < NTRUNK; ++l) {
      gemm_layer<H, 4, NT>(p, l, stage, act, ipe_s, wst, row0, n0, acc);
      store_act<H, 4, NT, true>(act, p.b + p.b_off[0] + l * H, row0, n0, acc);
      if (p.stash) {
        __syncthreads();
        stash_tile(act, S::ACT_LD, H, p.stash + l * p.n * H, r0, p.n);
      }
    }
    gemm_layer<H, 4, NT>(p, L_FEAT, stage, act, ipe_s, wst, row0, n0, acc);
    store_act<H, 4, NT, false>(act, p.b + p.b_off[1], row0, n0, acc);
    if (p.stash) {
      __syncthreads();
      stash_tile(act, S::ACT_LD, H, p.stash + NTRUNK * p.n * H, r0, p.n);
    }
  }

  // Dir layer (+ alpha in column DH): each warp owns 16 rows.
  const int row0 = warp * 16;
  {
    constexpr int NT = DHP / 8;
    float acc[1][NT][4];
    gemm_layer<H, 1, NT>(p, L_DIR, stage, act, ipe_s, wst, row0, 0, acc);
    const float* bd = p.b + p.b_off[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + half * 8;
      const long long grow = r0 + row;
      const bool valid = grow < p.n;
      const float* dp = p.dproj + (valid ? grow / p.samples : 0) * DH;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t;
        const float v0 = acc[0][nt][2 * half], v1 = acc[0][nt][2 * half + 1];
        if (col < DH) {
          float h0 = 0.f, h1 = 0.f;
          if (valid) {
            const float2 d = *reinterpret_cast<const float2*>(dp + col);
            h0 = fmaxf((v0 + d.x) + bd[col], 0.f);
            h1 = fmaxf((v1 + d.y) + bd[col + 1], 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(act + row * S::ACT_LD + col) =
              __floats2bfloat162_rn(h0, h1);
        } else if (col == DH && valid) {
          p.out[grow * p.out_dim + 3] = v0 + bd[DH];
        }
      }
    }
  }
  if (p.stash_h) {
    __syncthreads();
    stash_tile(act, S::ACT_LD, DH, p.stash_h, r0, p.n);
  }

  // Heads: rgb -> out[:, 0:3], (mu, sigma) -> out[:, 4:6].
  {
    float acc[1][2][4];
    gemm_layer<H, 1, 2>(p, L_HEAD, stage, act, ipe_s, wst, row0, 0, acc);
    const float* bh = p.b + p.b_off[3];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long grow = r0 + row0 + g + half * 8;
      if (grow >= p.n) continue;
      float* o = p.out + grow * p.out_dim;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nt * 8 + 2 * t + j;
          const float v = acc[0][nt][2 * half + j] + bh[col];
          if (col < 3) {
            o[col] = v;
          } else if (col < 5 && p.out_dim == 6) {
            o[col + 1] = v;
          }
        }
    }
  }
}

// dproj[r, c] = sum_j dirs[r, j] * Wd_dirs[c, j], f32: the dir layer's
// view-direction half, once per ray (bf16 x bf16 products are exact in f32).
__global__ void dir_proj_kernel(const bf16* dirs, const bf16* wdirs,
                                float* dproj) {
  __shared__ float d[DIRS];
  const long long r = blockIdx.x;
  const int c = threadIdx.x;
  if (c < DIRS) d[c] = __bfloat162float(dirs[r * DIRS + c]);
  __syncthreads();
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < DIRS; ++j)
    acc = fmaf(d[j], __bfloat162float(wdirs[c * DIRS_LD + j]), acc);
  dproj[r * DH + c] = acc;
}

template <int H, bool ENC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = Shape<H>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<H, ENC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (p.n + BM - 1) / BM;
  fused_mlp_fwd_kernel<H, ENC><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
      p);
  return cudaGetLastError();
}

// The dir projection, then the network at width `hidden`; p.dproj is the
// projection's output.
template <bool ENC>
cudaError_t run(Params& p, const void* dirs, int hidden,
                const long long* w_off, const long long* b_off,
                cudaStream_t st) {
  if (hidden != 64 && hidden != 128 && hidden != 256)
    return cudaErrorInvalidValue;
  for (int i = 0; i < NLAYER; ++i) p.w_off[i] = w_off[i];
  for (int i = 0; i < 4; ++i) p.b_off[i] = b_off[i];
  const long long rays = p.n / p.samples;
  dir_proj_kernel<<<(unsigned)rays, DH, 0, st>>>(
      static_cast<const bf16*>(dirs), p.w + w_off[NLAYER],
      const_cast<float*>(p.dproj));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (hidden) {
    case 64: return launch<64, ENC>(p, st);
    case 128: return launch<128, ENC>(p, st);
    case 256: return launch<256, ENC>(p, st);
    default: return cudaErrorInvalidValue;
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
  Params p = {};
  p.ipe = static_cast<const bf16*>(ipe);
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const float*>(b);
  p.dproj = static_cast<const float*>(dproj);
  p.out = static_cast<float*>(out);
  p.stash = static_cast<bf16*>(stash);
  p.stash_h = static_cast<bf16*>(stash_h);
  if ((stash == nullptr) != (stash_h == nullptr)) return cudaErrorInvalidValue;
  p.n = n;
  p.samples = samples;
  p.out_dim = depth_head ? 6 : 4;
  return run<false>(p, dirs, hidden, w_off, b_off,
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
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const float*>(b);
  p.dproj = static_cast<const float*>(dproj);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.samples = samples;
  p.out_dim = depth_head ? 6 : 4;
  return run<true>(p, dirs, hidden, w_off, b_off,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* ddnerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
