// The pipeline's encode stage for Hopper (sm_90a): ray sections to the rows
// the fused MLP kernels read, in one pass.  For each network call it turns
//   t_vals [N, S+1], origins, directions, viewdirs [N, 3], radii [N, 1] (f32)
// into
//   ipe  [N*S, 96]: [sin(2^l x) by (l, dim) | cos(2^l x) by (l, dim)], each
//                   attenuated by exp(-4^l cov / 2), l = 0..15;
//   dirs [N, 27]:   the view-direction PE [x, sin(2^f x), cos(2^f x)], f < 4;
// both in the network's compute dtype (bf16, or f32), rounded once at the
// store.  Means and covariances live in registers only.
//
// It replaces no TPU kernel: in the JAX package XLA fuses the same
// operations (core/math.py::cast_rays, integrated_pos_enc,
// positional_encoding and the cast), and there is no Pallas counterpart.  In
// the port it replaces that plain composition, ~200 small torch kernels a
// call (16-way stacks, a cat, elementwise products, the cast), and is held
// to it on the card (tests/test_torch_port_encode.py).
//
// Arithmetic: the plain composition's, in f32, in its order, with each
// operation that torch rounds on its own written as a rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so that no FMA contraction
// merges two of them; a division by a constant is a product with its f32
// reciprocal, as torch's CUDA division by a Python number computes it.  Per
// section (core/math.py, reference math_utils.py:7-110):
//   cone:     mu = (t0 + t1) / 2, hw = (t1 - t0) / 2, D = 3 mu^2 + hw^2,
//             t_mean = mu + 2 mu hw^2 / D,
//             t_var = hw^2 / 3 - 4/15 (hw^4 (12 mu^2 - hw^2) / D^2),
//             r_var = r^2 (mu^2 / 4 + 5/12 hw^2 - 4/15 hw^4 / D)
//   cylinder: t_mean = (t0 + t1) / 2, t_var = (t1 - t0)^2 / 12, r_var = r^2 / 4
//   mean_j = d_j t_mean + o_j,
//   cov_j = t_var d_j^2 + r_var (1 - d_j^2 / max(|d|^2, 1e-10)).
// hw^4 is powf(hw, 4), as torch's pow by 4, and |d|^2 is (d_0^2 + d_2^2) +
// d_1^2, the order of torch's sum over the last axis.  The IPE follows
// parallel.ipe_double_angle: on, s, c = sin(wrap(mean)), cos(wrap(mean)) at
// level 0 and s, c <- 2 s c, 1 - 2 s^2 from level to level; off, each level
// directly, sin(wrap(y)) and sin(wrap(y + (float)(pi / 2))) with y = mean *
// 2^l.  wrap is safe_sin's reduction past 100 pi
// (hopper_common.cuh's wrap_trig).  sinf, cosf and expf are
// the accurate libdevice functions, never the __sinf intrinsics or fast
// math: the direct form's arguments reach 2^15 |x| before the wrap.
//
// What bounds it on an H100: the bytes of the rows it writes.  A bf16 row
// is 192 bytes for 32 bytes read (per ray: S + 1 fenceposts and 10 floats),
// so 524,288 rows, a render chunk, write 100.7 MB: 30 us at 3.35 TB/s.  Its
// arithmetic, ~1,100 instructions a row in the double-angle form (48 expf,
// 3 sinf + 3 cosf, the level climb, the cast), is ~20 us of the card's
// issue rate at that size, so the stores set the pace once the warps
// overlap.  Design:
// * One thread computes one row: the section's Gaussian and its 96 values,
//   level by level, packed as they come into 16-byte chunks (8 bf16 or 4 f32
//   values) that go to a shared-memory tile of the block's 128 rows.  The
//   chunk slots are XOR-swizzled by row, so that the eight threads of a
//   quarter warp writing the same chunk of their rows meet eight banks.
// * The block then writes the tile, one contiguous stretch of device memory,
//   with 16-byte stores by consecutive threads on consecutive addresses.
// * Blocks stride over the tiles (as many blocks as fit the card at once),
//   and a ray's fenceposts and vectors come from device memory once: the S
//   threads of its sections read them through L1.
// * The dirs rows (one per ray, 1/S of the work) are taken by the same
//   grid after its tiles, one thread a ray.

#include "hopper_common.cuh"

namespace {

using namespace ddnerf;

constexpr int LEVELS = 16;
constexpr int HALF = IPE / 2;  // 48 = 16 levels x 3 coordinates
constexpr int DIR_FREQS = 4;
constexpr int THREADS = 128;  // rows of a tile, threads of a block

struct EncodeParams {
  const float* t_vals;
  const float* origins;
  const float* directions;
  const float* radii;
  const float* viewdirs;
  long long t_stride, o_stride, d_stride, r_stride, v_stride;  // row strides
  void* ipe;   // [n * s, 96]
  void* dirs;  // [n, 27]
  int n;       // rays
  int s;       // sections per ray
};

// A row's 16-byte chunks in the compute dtype T: PER values each, CHUNKS a
// row; swizzle(row) is the XOR of its chunk slots in the tile.
template <typename T>
struct Chunks;

template <>
struct Chunks<bf16> {
  static constexpr int PER = 8, CHUNKS = IPE / PER;  // 12, 192 bytes a row
  // Rows alternate halves of a 128-byte bank line; (row >> 1) & 3 spreads
  // eight consecutive rows over its eight 16-byte slots.
  __device__ static int swizzle(int row) { return (row >> 1) & 3; }
  __device__ static uint4 pack(const float (&v)[PER]) {
    uint4 out;
    uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < PER / 2; ++i) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&two);
    }
    return out;
  }
  __device__ static bf16 one(float v) { return __float2bfloat16_rn(v); }
};

template <>
struct Chunks<float> {
  static constexpr int PER = 4, CHUNKS = IPE / PER;  // 24, 384 bytes a row
  __device__ static int swizzle(int row) { return row & 7; }
  __device__ static uint4 pack(const float (&v)[PER]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  __device__ static float one(float v) { return v; }
};

// Section s of ray `ray` as a Gaussian: means m and diagonal covariances v.
template <bool CONE>
__device__ __forceinline__ void gaussian(const EncodeParams& p, long long ray,
                                         int s, float (&m)[3], float (&v)[3]) {
  const float* tv = p.t_vals + ray * p.t_stride + s;
  const float t0 = __ldg(tv), t1 = __ldg(tv + 1);
  const float r = __ldg(p.radii + ray * p.r_stride);
  const float rr = __fmul_rn(r, r);
  float t_mean, t_var, r_var;
  if constexpr (CONE) {
    constexpr float C415 = (float)(4.0 / 15.0), C512 = (float)(5.0 / 12.0);
    const float mu = __fmul_rn(__fadd_rn(t0, t1), 0.5f);
    const float hw = __fmul_rn(__fsub_rn(t1, t0), 0.5f);
    const float mu2 = __fmul_rn(mu, mu), hw2 = __fmul_rn(hw, hw);
    const float hw4 = powf(hw, 4.f);
    const float denom = __fadd_rn(__fmul_rn(3.f, mu2), hw2);
    t_mean = __fadd_rn(
        mu, __fdiv_rn(__fmul_rn(__fmul_rn(2.f, mu), hw2), denom));
    t_var = __fsub_rn(
        __fmul_rn(hw2, 1.f / 3.f),
        __fmul_rn(C415, __fdiv_rn(__fmul_rn(hw4, __fsub_rn(__fmul_rn(12.f, mu2),
                                                           hw2)),
                                  __fmul_rn(denom, denom))));
    r_var = __fmul_rn(
        rr, __fsub_rn(__fadd_rn(__fmul_rn(mu2, 0.25f), __fmul_rn(C512, hw2)),
                      __fdiv_rn(__fmul_rn(C415, hw4), denom)));
  } else {
    const float w = __fsub_rn(t1, t0);
    t_mean = __fmul_rn(__fadd_rn(t0, t1), 0.5f);
    t_var = __fmul_rn(__fmul_rn(w, w), 1.f / 12.f);
    r_var = __fmul_rn(rr, 0.25f);
  }
  const float* d = p.directions + ray * p.d_stride;
  const float* o = p.origins + ray * p.o_stride;
  float dj[3], dd[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    dj[j] = __ldg(d + j);
    dd[j] = __fmul_rn(dj[j], dj[j]);
  }
  // torch.sum over the last axis of three adds them in this order.
  float mag = __fadd_rn(__fadd_rn(dd[0], dd[2]), dd[1]);
  mag = mag < 1e-10f ? 1e-10f : mag;  // clamp(min=1e-10); NaN stays NaN
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    m[j] = __fadd_rn(__fmul_rn(dj[j], t_mean), __ldg(o + j));
    v[j] = __fadd_rn(__fmul_rn(t_var, dd[j]),
                     __fmul_rn(r_var, __fsub_rn(1.f, __fdiv_rn(dd[j], mag))));
  }
}

// Column `col` of the sin half (sv) and of the cos half (cv) of a row,
// gathered into the chunk buffers; a full pair of chunks goes to the row's
// tile slots.  `col` is a compile-time constant once the loops unroll.
template <typename T>
__device__ __forceinline__ void put(uint4* row, int swz, int col, float sv,
                                    float cv, float (&sb)[Chunks<T>::PER],
                                    float (&cb)[Chunks<T>::PER]) {
  using C = Chunks<T>;
  sb[col % C::PER] = sv;
  cb[col % C::PER] = cv;
  if (col % C::PER == C::PER - 1) {
    const int c = col / C::PER;
    row[c ^ swz] = C::pack(sb);
    row[(HALF / C::PER + c) ^ swz] = C::pack(cb);
  }
}

// Row r (section r % S of ray r / S) into its tile slots.
template <typename T, bool CONE, bool DOUBLE>
__device__ __forceinline__ void encode_row(const EncodeParams& p, int r,
                                           uint4* row, int swz) {
  const int ray = r / p.s;
  float m[3], v[3];
  gaussian<CONE>(p, ray, r - ray * p.s, m, v);
  float sb[Chunks<T>::PER], cb[Chunks<T>::PER];
  if constexpr (DOUBLE) {
    float sn[3], cs[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float x = wrap_trig(m[j]);
      sn[j] = sinf(x);
      cs[j] = cosf(x);
    }
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) {
      const float k = -0.5f * (float)(1 << (2 * l));  // -4^l / 2, exact
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float w = expf(__fmul_rn(k, v[j]));
        put<T>(row, swz, l * 3 + j, __fmul_rn(w, sn[j]), __fmul_rn(w, cs[j]),
               sb, cb);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {  // sin 2a = 2 s c, cos 2a = 1 - 2 s^2
        const float two_s = __fmul_rn(2.f, sn[j]);
        const float s2 = __fmul_rn(two_s, cs[j]);
        cs[j] = __fsub_rn(1.f, __fmul_rn(two_s, sn[j]));
        sn[j] = s2;
      }
    }
  } else {
    constexpr float HALF_PI = 1.57079632679489661923f;  // (float)(pi / 2)
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) {
      const float f = (float)(1 << l);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float y = __fmul_rn(m[j], f);  // exact: powers of two
        const float att = expf(__fmul_rn(-0.5f, __fmul_rn(v[j], f * f)));
        put<T>(row, swz, l * 3 + j, __fmul_rn(att, sinf(wrap_trig(y))),
               __fmul_rn(att, sinf(wrap_trig(__fadd_rn(y, HALF_PI)))), sb,
               cb);
      }
    }
  }
}

// The view-direction PE of ray `ray`: [x, sin(2^f x) by dim, cos(2^f x) by
// dim for f = 0..3] (core/math.py::positional_encoding, no wrap).
template <typename T>
__device__ __forceinline__ void encode_dirs(const EncodeParams& p, int ray) {
  T* out = static_cast<T*>(p.dirs) + (long long)ray * DIRS;
  const float* vd = p.viewdirs + ray * p.v_stride;
  float x[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    x[j] = __ldg(vd + j);
    out[j] = Chunks<T>::one(x[j]);
  }
#pragma unroll
  for (int f = 0; f < DIR_FREQS; ++f) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float xb = __fmul_rn(x[j], (float)(1 << f));
      out[3 + 6 * f + j] = Chunks<T>::one(sinf(xb));
      out[6 + 6 * f + j] = Chunks<T>::one(cosf(xb));
    }
  }
}

template <typename T, bool CONE, bool DOUBLE>
__global__ void __launch_bounds__(THREADS, 4)
    ipe_encode_kernel(const EncodeParams p) {
  using C = Chunks<T>;
  __shared__ uint4 tile[THREADS * C::CHUNKS];
  const int t = threadIdx.x;
  const int rows = p.n * p.s;
  const int tiles = (rows + THREADS - 1) / THREADS;
  uint4* out = static_cast<uint4*>(p.ipe);
  for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
    const int r0 = i * THREADS;
    if (r0 + t < rows)
      encode_row<T, CONE, DOUBLE>(p, r0 + t, tile + t * C::CHUNKS,
                                  C::swizzle(t));
    __syncthreads();
    const int here = min(THREADS, rows - r0) * C::CHUNKS;
    uint4* dst = out + (long long)r0 * C::CHUNKS;
    for (int q = t; q < here; q += THREADS) {
      const int row = q / C::CHUNKS, c = q - row * C::CHUNKS;
      dst[q] = tile[row * C::CHUNKS + (c ^ C::swizzle(row))];
    }
    __syncthreads();  // the tile is written again by the next pass
  }
  for (int ray = blockIdx.x * THREADS + t; ray < p.n; ray += gridDim.x * THREADS)
    encode_dirs<T>(p, ray);
}

template <typename T, bool CONE, bool DOUBLE>
cudaError_t launch(const EncodeParams& p, cudaStream_t st) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  // Blocks a multiprocessor holds at once: once per process and
  // instantiation, not per launch.
  static int per_sm = 0;
  static const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ipe_encode_kernel<T, CONE, DOUBLE>, THREADS, 0);
  if (occ != cudaSuccess) return occ;
  const long long tiles = ((long long)p.n * p.s + THREADS - 1) / THREADS;
  const long long ray_blocks = ((long long)p.n + THREADS - 1) / THREADS;
  long long grid = tiles > ray_blocks ? tiles : ray_blocks;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > resident) grid = resident;
  ipe_encode_kernel<T, CONE, DOUBLE><<<(unsigned)grid, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const EncodeParams& p, int cone, int double_angle,
                     cudaStream_t st) {
  if (cone)
    return double_angle ? launch<T, true, true>(p, st)
                        : launch<T, true, false>(p, st);
  return double_angle ? launch<T, false, true>(p, st)
                      : launch<T, false, false>(p, st);
}

}  // namespace

// Launches the encode kernel on `stream`.  Device pointers: t_vals [n,
// samples + 1], origins, directions, viewdirs [n, 3] and radii [n, 1], f32,
// each with unit column stride and the given row stride (elements); ipe
// [n * samples, 96] (16-byte aligned) and dirs [n, 27], bf16, or f32 where
// `f32` is 1.  cone: 1 for conical frustums, 0 for cylinders;
// double_angle: parallel.ipe_double_angle.  Returns a cudaError_t.
extern "C" int ddnerf_ipe_encode(const void* t_vals, long long t_stride,
                                 const void* origins, long long o_stride,
                                 const void* directions, long long d_stride,
                                 const void* radii, long long r_stride,
                                 const void* viewdirs, long long v_stride,
                                 void* ipe, void* dirs, long long n,
                                 int samples, int cone, int double_angle,
                                 int f32, void* stream) {
  // Rows are counted in 32 bits.
  if (n <= 0 || samples <= 0 || n * samples > 0x7fffffffLL - THREADS)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(ipe) % 16) return cudaErrorInvalidValue;
  EncodeParams p;
  p.t_vals = static_cast<const float*>(t_vals);
  p.origins = static_cast<const float*>(origins);
  p.directions = static_cast<const float*>(directions);
  p.radii = static_cast<const float*>(radii);
  p.viewdirs = static_cast<const float*>(viewdirs);
  p.t_stride = t_stride;
  p.o_stride = o_stride;
  p.d_stride = d_stride;
  p.r_stride = r_stride;
  p.v_stride = v_stride;
  p.ipe = ipe;
  p.dirs = dirs;
  p.n = (int)n;
  p.s = samples;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch<float>(p, cone, double_angle, st)
             : dispatch<bf16>(p, cone, double_angle, st);
}
