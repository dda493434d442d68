// The relu masks of the stash forward (fused_mlp_fwd.cu) as bit words, which
// the backward's cotangent chain (fused_mlp_bwd.cu) applies instead of
// reading the bf16 stash: one bit per activation of x0..x7 (H columns) and
// of h (DH columns), set where the stashed bf16 value is > 0, 0 in rows past
// n.  (8 H + DH) / 8 bytes per row, 1/16 of the stash slabs they stand for.
//
// Layout: the wgmma accumulator-fragment order (hopper_common.cuh,
// wgmma_k16), so that a consumer thread of the chain owns whole words of the
// rows and columns its accumulators hold (those the forward's consumer
// thread of the same index wrote back, where its packers read them).  Rows
// go in groups of MASK_ROWS = 64 (a wgmma's m64), each group
// mask_group_words(H) words.  In a group, mask m (x0..x7, then h as m = 8)
// takes 128 C_m words from word mask_offset(H, m), C_m = H / 64 (DH / 64
// for h): thread t of a warpgroup (warp w = t / 32, g = lane / 4, q = lane
// % 4) owns words t C_m .. t C_m + C_m - 1, and its word c holds row
// 16 w + g + 8 half of the group, column 64 c + 8 i + 2 q + e (accumulator
// register 4 (8 c + i) + 2 half + e of a product whose columns start at 0)
// at bit 16 e + 15 - (2 i + half): the order that pair_bits packs cheaply.
// A consumer that computes the N columns from 64 b (the N-split plans) owns
// the N / 64 words from t C_m + b.
// kernels/reference.py::pack_mask_bits writes the same layout in Python.
#pragma once

#include "mma_common.cuh"

namespace ddnerf {

constexpr int MASK_ROWS = 64;
constexpr int MASK_WORDS_MAX = 4;  // of a chain thread and product: N / 64

__host__ __device__ constexpr long long mask_group_words(int hidden) {
  return 128LL * (NTRUNK * hidden + DH) / 64;
}

// The first word of mask m (0..7: x_m, 8: h) in a group.
__host__ __device__ constexpr int mask_offset(int hidden, int m) {
  return 128 * (hidden / 64) * m;
}

// Pair k (= 2 i + half) of a word: bit 15 - k for its low value, 31 - k for
// its high one, each set where the relu'd (so never negative) bf16 value is
// not zero: its magnitude bits plus 0x7FFF carry into bit 15 unless they
// are all 0 (a subnormal carries; -0 does not).
__device__ __forceinline__ uint32_t pair_bits(__nv_bfloat162 v, int k) {
  const uint32_t t = (*reinterpret_cast<const uint32_t*>(&v) & 0x7fff7fffu) +
                     0x7fff7fffu;
  return (t >> k) & (0x80008000u >> k);
}

// The bits of pairs with even k (row g) or odd k (row g + 8).
constexpr uint32_t MASK_ROW_LO = 0xaaaaaaaau, MASK_ROW_HI = 0x55555555u;

// Whether word m has the low (e = 0) or high (e = 1) value of pair k.
template <int E>
__device__ __forceinline__ bool has_bit(uint32_t m, int k) {
  return (m >> (16 * E + 15 - k)) & 1u;
}

// N words from p into shared memory, word c at slot + 512 c (a warpgroup's
// slots are its threads' 4-byte columns: conflict-free reads), with
// cp.async: the copy holds no registers while it is in flight.  Committed
// as one group; cp_words_wait() waits for it.
template <int N>
__device__ __forceinline__ void cp_words(uint32_t slot, const uint32_t* p) {
#pragma unroll
  for (int c = 0; c < N; ++c)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(slot + 512 * c), "l"(p + c) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_words_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace ddnerf
