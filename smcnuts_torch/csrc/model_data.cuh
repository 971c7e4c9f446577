// How a model's data reach the NUTS kernel, for every model alike.
//
// A model owns a block of floats (arma: y; PRMwCD: y then X row-major) that
// each thread block stages in shared memory once, and up to kMaxScalars
// scalar constants passed by value. A model is a struct with
//   static constexpr int D;                           // unconstrained dim
//   static bool accepts(int n_data, int n_scalars);   // host-side check
//   __device__ Model(const float* data_s, int n_data, const ModelScalars&);
//   __device__ float logp_grad(const float* x, float phi, float* grad) const;
// and, optionally,
//   static constexpr int kGroup;  // W: lanes that evaluate one particle
// in which case the kernel calls logp_grad from the W lanes of a group
// together, each holding the same x, and every lane must return the same
// bits (group_lane, group_mask below), and
//   static constexpr int kMaxRegisters;  // a register cap for ptxas, or 0
// (nuts_tree.cuh: MinBlocks), and, for a model at W = 1,
//   static constexpr bool kPipelined;  // true: the pipelined walk
// (nuts_tree.cuh: pipelined_walk), in which case it also has
//   __device__ bool data_in_range() const;  // its divisors in the fast path's range
//   __device__ auto in_registers() const;   // its data copied into registers, whose
//     logp_grad(x, phi, grad, bool& in_range) divides by the fast path and
//     clears in_range where an operand leaves its range
// (the Gaussian, gaussian_model.cuh).
#pragma once

namespace smcnuts {

constexpr int kMaxScalars = 4;

struct ModelScalars {
  float v[kMaxScalars];
};

// The calling thread's lane in its group of W: groups are W consecutive
// threads of a block (W divides 32 and the block size).
template <int W>
__device__ __forceinline__ int group_lane() {
  return W == 1 ? 0 : static_cast<int>(threadIdx.x % W);
}

// The lanes of the calling thread's group, as a warp mask.
template <int W>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (W == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << W) - 1u) << ((threadIdx.x & 31u) & ~static_cast<unsigned>(W - 1));
  }
}

}  // namespace smcnuts
