// Helpers shared by the fused-MLP kernels (fused_mlp_fwd.cu, fused_mlp_bwd.cu):
// cp.async copies, ldmatrix fragment loads and the bf16 mma.sync m16n8k16
// tensor-core product with f32 accumulation, plus the network constants and
// the packed weight layout of kernels/fused_mlp.py::pack_weights.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ddnerf {

typedef __nv_bfloat16 bf16;

constexpr int IPE = 96;          // IPE features
constexpr int DIRS = 27;         // view-direction PE features
constexpr int DIRS_LD = 32;      // row stride of packed Wd_dirs (and padded dirs)
constexpr int DH = 128;          // dir-branch width
constexpr int DHP = 144;         // dir layer outputs: h | alpha | zero pad
constexpr int NHEAD = 16;        // head outputs: rgb | mu, sigma | zero pad
constexpr int NTRUNK = 8;
constexpr int SKIP = 5;
constexpr int PAD = 8;           // bf16 row padding: conflict-free ldmatrix

// Packed weights (torch [out, in] layout, element offsets in w_off):
//   0..7 trunk W0 [H, 96], W1..W7 [H, H] except W5 [H, 96 + H]; 8 fc_feat
//   [H, H]; 9 dir layer [144, H] (rows 0..127 Wd_feat, row 128 fc_alpha);
//   10 heads [16, 128] (rows 0..2 fc_rgb, 3..4 fc_mu_sigma); 11 Wd_dirs
//   [128, 32] (27 used).  Packed biases (b_off): 0 trunk [8, H], 1 fc_feat
//   [H], 2 dir [144] (128 = alpha), 3 heads [16].
constexpr int W_FEAT = 8, W_DIR = 9, W_HEAD = 10, W_DIRS = 11, NW = 12;
constexpr int NB_OFF = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// The same, each matrix transposed on the way into the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ddnerf
