// Logistic-regression tempered log-density and its gradient, for one particle,
// evaluated by a group of W lanes (W = 1: one thread).
//
// Replaces smcnuts_tpu/ops/nuts_pallas.py::elementwise_tile_model (the
// in-kernel jax.vjp of an elementwise tile density) applied to the logp_tiles
// of smcnuts_tpu/models/logistic.py. CUDA has no autodiff, so the gradient is
// written out in closed form. Its plain version is
// smcnuts_torch/models/logistic.py::LogisticModel.logp_and_grad(x, phi,
// group=W), op for op in the same order (the build turns off multiply-add
// contraction and fast math):
//   - lp = sum_d -((0.5 b_d) b_d) inv_ps2 in sequence, + prior_const, by
//     every lane alike;
//   - lane l of the group sums observations i = l, l + W, l + 2W, ... in
//     that order, each as the one-thread kernel did: eta = b_0 X_i0, then
//     eta += X_id b_d; e = exp(-|eta|);
//     ll = (ll + y_i eta) - (max(eta, 0) + log1p(e));
//     resid = y_i - sigmoid(eta); s_d += resid X_id. Every lane's partials
//     start from zero (b_0 * 0, which keeps a NaN);
//   - the 1 + D partials (ll, s_1..s_D) are reduced by a fixed xor
//     butterfly, v = v + shfl_xor(v, o) for o = W/2, ..., 1: both partners
//     of a step add the same two values, and IEEE addition is commutative,
//     so every lane ends with the same bits;
//   - gradient -b_d inv_ps2 + phi s_d, logp lp + phi ll.
// W = 1 is the sequential order of the JAX tile density. The derivative of
// the stable softplus is the sigmoid, written as 1 / (1 + e) for eta >= 0 and
// e / (1 + e) below: e <= 1, so it cannot overflow however large |eta| is.
//
// What bounds it on this card: FP32 issue and latency, about 4 D + 12
// operations an observation with one expf, one log1pf and one division, 64
// observations a leapfrog. At W = 1 (one thread a tree) a leapfrog is a
// chain of 64 observations and the 12,800 trees of the main path are 400
// warps, three an SM: nothing hides the latency of a dependent operation,
// and the thread's 168 registers still spill. At W > 1 a lane takes 64 / W
// observations, then 9 log2(W) shuffle-and-add steps, and the block keeps
// each group's checkpoint stack and carriers in shared memory (nuts_tree.cuh:
// group_floats): 128 registers, no spill. Measured on an H100 (chip_smoke.py
// phase 8; PERF.md keeps the widths and blocks tried): W = 16 in blocks of 64
// threads was the fastest of W = 4, 8, 16 in blocks of 64 and 128 at
// 25 x 512 trees, 3.8x one thread a tree, and still 1.6x at 1,048,576 trees,
// where one thread a tree fills the card. Data: the block stages the
// rows [X_i0 .. X_i,D-1, y_i] at a stride of D + 1 = 9 floats in shared
// memory; at W > 1 lanes l = 0 .. W - 1 read rows i0 + l at the same column,
// banks 9 l + d mod 32, distinct because the stride is odd (at a stride of
// 8 two or four lanes of a group would share a bank). Scalars 1 /
// prior_scale^2 and the prior's constant come by value, computed on the host
// in float64.
#pragma once

#include "model_data.cuh"

namespace smcnuts {

template <int Dim, int W = 1>
struct LogisticModel {
  static constexpr int D = Dim;
  static constexpr int kScalars = 2;
  static constexpr int kGroup = W;
  static constexpr int kStride = Dim + 1;  // floats a row: X_i, then y_i

  const float* rows;  // (n_obs, Dim + 1) row-major, in shared memory
  int n_obs;
  float inv_ps2, prior_const;

  static bool accepts(int n_data, int n_scalars) {
    return n_data > 0 && n_data % kStride == 0 && n_scalars == kScalars;
  }

  __device__ LogisticModel(const float* data, int n_data, const ModelScalars& s)
      : rows(data), n_obs(n_data / kStride), inv_ps2(s.v[0]), prior_const(s.v[1]) {}

  __device__ __forceinline__ float logp_grad(const float* b, float phi, float* grad) const {
    const float zero = b[0] * 0.0f;
    float lp = zero;
#pragma unroll
    for (int d = 0; d < Dim; ++d) lp = lp - ((0.5f * b[d]) * b[d]) * inv_ps2;
    lp = lp + prior_const;

    float ll = zero;
    float s[Dim];
#pragma unroll
    for (int d = 0; d < Dim; ++d) s[d] = zero;
    for (int i = group_lane<W>(); i < n_obs; i += W) {
      const float* Xi = rows + i * kStride;
      float eta = b[0] * Xi[0];
#pragma unroll
      for (int d = 1; d < Dim; ++d) eta = eta + Xi[d] * b[d];
      const float e = expf(-fabsf(eta));
      const float softplus = (eta > 0.0f ? eta : 0.0f) + log1pf(e);
      const float yi = Xi[Dim];
      ll = (ll + yi * eta) - softplus;
      const float one_e = 1.0f + e;
      const float resid = yi - (eta >= 0.0f ? 1.0f / one_e : e / one_e);
#pragma unroll
      for (int d = 0; d < Dim; ++d) s[d] = s[d] + resid * Xi[d];
    }
    if constexpr (W > 1) {
      const unsigned mask = group_mask<W>();
#pragma unroll
      for (int o = W / 2; o > 0; o /= 2) {
        ll = ll + __shfl_xor_sync(mask, ll, o);
#pragma unroll
        for (int d = 0; d < Dim; ++d) s[d] = s[d] + __shfl_xor_sync(mask, s[d], o);
      }
    }
#pragma unroll
    for (int d = 0; d < Dim; ++d) grad[d] = -b[d] * inv_ps2 + phi * s[d];
    return lp + phi * ll;
  }
};

}  // namespace smcnuts
