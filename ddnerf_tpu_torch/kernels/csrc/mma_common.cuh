// What the fused-MLP kernels (fused_mlp_fwd.cu, fused_mlp_bwd.cu) share below
// the Hopper helpers of hopper_common.cuh: the network constants and the
// packed weight layout of kernels/fused_mlp.py::pack_weights.
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

}  // namespace ddnerf
