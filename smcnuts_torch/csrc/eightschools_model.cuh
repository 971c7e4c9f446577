// Non-centred eight-schools tempered log-density and its gradient, for one
// particle, evaluated by a group of W lanes (W = 1: one thread).
//
// Replaces smcnuts_tpu/ops/nuts_pallas.py::elementwise_tile_model (the
// in-kernel jax.vjp of an elementwise tile density) applied to the logp_tiles
// of smcnuts_tpu/models/eightschools.py. CUDA has no autodiff, so the gradient
// is written out in closed form. Its plain version is
// smcnuts_torch/models/eightschools.py::EightSchoolsModel.logp_and_grad(x,
// phi, group=W), op for op in the same order (the build turns off multiply-add
// contraction and fast math; a division by 5 is a multiplication by 0.2 on
// both sides):
//   x = [mu, log_tau, tt_1..tt_J], tau = exp(log_tau);
//   prior of mu and tau, by every lane alike:
//     lp0 = ((-0.5 zmu) zmu - c_mu) + (((c_tau - log1p(zt zt)) + log 2) + log_tau),
//     zmu = 0.2 mu, zt = 0.2 tau;
//   lane l of the group takes schools j = l, l + W, ... in that order:
//     pt = (pt - (0.5 tt_j) tt_j) - c,
//     z_j = ((y_j - mu) - tau tt_j) / sigma_j,
//     ll = ((ll - (0.5 z_j) z_j) - log sigma_j) - c,
//     zs_j = z_j / sigma_j, s_mu += zs_j, s_lt += zs_j (tau tt_j),
//     and the school's own gradient d/d tt_j = -tt_j + phi (zs_j tau);
//   the four partials pt, ll, s_mu, s_lt start from zero (mu * 0, which keeps
//   a NaN), except pt at W = 1, which starts from lp0: W = 1 is the
//   sequential order of the JAX tile density;
//   at W > 1 the partials are reduced by a fixed xor butterfly,
//   v = v + shfl_xor(v, o) for o = W/2, ..., 1 (both partners of a step add
//   the same two values, and IEEE addition is commutative, so every lane ends
//   with the same bits), and lp = lp0 + pt after it;
//   d/d mu = -0.2 zmu + phi s_mu, d/d log_tau = 1 - 2 zt^2 / (1 + zt^2) +
//   phi s_lt, logp lp + phi ll; d/d tt_j reaches every lane from the lane
//   that owns school j by a shuffle.
// A large log_tau overflows tau to inf and the density to -inf (the gradient
// to NaN), as in the JAX density; the tree's divergence guard handles it and
// nothing here guards it.
//
// What bounds it on this card: FP32 issue and latency, about 22 operations
// and two divisions a school, one expf and one log1pf an evaluation. At
// W = 1 (one thread a tree) a leapfrog is a chain through the 8 schools and
// the 12,800 trees of the main path are 400 warps, three an SM: nothing hides
// the latency of a dependent operation, and the thread's 254 registers hold
// the tree state while its checkpoint stack lives in local memory. At W > 1 a
// lane takes 8 / W schools, then a 4-value butterfly of log2(W) steps and 8
// broadcasts of the school gradients, and the block keeps each group's
// checkpoint stack and carriers in shared memory (nuts_tree.cuh:
// group_floats). The school a lane owns is chosen by a chain of selects over
// static indices of x, never by an index that depends on the lane, which
// would send the whole tree state to local memory. Data: y (J), sigma (J),
// log sigma (J) in shared memory; at any W the lanes of a group read
// consecutive floats (distinct banks) and the groups of a warp read the same
// float (a broadcast). No scalars.
#pragma once

#include "model_data.cuh"

namespace smcnuts {

template <int J, int W = 1>
struct EightSchoolsModel {
  static constexpr int D = 2 + J;
  static constexpr int kGroup = W;
  static constexpr int kPerLane = (J + W - 1) / W;  // schools a lane takes, at most
  // At W > 1 ptxas is held to 128 registers a thread (nuts_tree.cuh:
  // MinBlocks): left alone it gave the continuation stage 168.
  static constexpr int kMaxRegisters = W > 1 ? 128 : 0;

  const float* y;          // (J,) in shared memory
  const float* sigma;      // (J,)
  const float* log_sigma;  // (J,)

  static bool accepts(int n_data, int n_scalars) { return n_data == 3 * J && n_scalars == 0; }

  __device__ EightSchoolsModel(const float* data, int, const ModelScalars&)
      : y(data), sigma(data + J), log_sigma(data + 2 * J) {}

  __device__ __forceinline__ float logp_grad(const float* x, float phi, float* grad) const {
    constexpr float kLogSqrt2Pi = 0.91893853320467274178;
    constexpr float kMuConst = 1.60943791243410037460 + 0.91893853320467274178;    // log 5 + log sqrt(2 pi)
    constexpr float kTauConst = -1.14472988584940017414 - 1.60943791243410037460;  // -log pi - log 5
    constexpr float kLog2 = 0.69314718055994530942;
    constexpr float kInv5 = 0.2;

    const float mu = x[0], log_tau = x[1];
    const float tau = expf(log_tau);
    const float zmu = mu * kInv5;
    float lp = (-0.5f * zmu) * zmu - kMuConst;
    const float zt = tau * kInv5;
    const float zt2 = zt * zt;
    lp = lp + (((kTauConst - log1pf(zt2)) + kLog2) + log_tau);
    const float g_mu_lp = -zmu * kInv5;
    const float g_lt_lp = 1.0f - (2.0f * zt2) / (1.0f + zt2);

    const int lane = group_lane<W>();
    const float zero = mu * 0.0f;
    float pt = W == 1 ? lp : zero, ll = zero, g_mu_ll = zero, g_lt_ll = zero;
    float g_tt[kPerLane];  // d/d tt_j of the lane's schools j = lane + k W
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = k * W + lane;
      if (k * W + W <= J || j < J) {
        // tt_j = x[2 + j] by selects over static indices.
        float t = x[2 + k * W];
#pragma unroll
        for (int q = 1; q < W; ++q) {
          if (k * W + q < J && lane == q) t = x[2 + k * W + q];
        }
        pt = (pt - (0.5f * t) * t) - kLogSqrt2Pi;
        const float z = ((y[j] - mu) - tau * t) / sigma[j];
        ll = ((ll - (0.5f * z) * z) - log_sigma[j]) - kLogSqrt2Pi;
        const float zs = z / sigma[j];
        g_mu_ll = g_mu_ll + zs;
        g_lt_ll = g_lt_ll + zs * (tau * t);
        g_tt[k] = -t + phi * (zs * tau);
      }
    }
    if constexpr (W > 1) {
      const unsigned mask = group_mask<W>();
#pragma unroll
      for (int o = W / 2; o > 0; o /= 2) {
        pt = pt + __shfl_xor_sync(mask, pt, o);
        ll = ll + __shfl_xor_sync(mask, ll, o);
        g_mu_ll = g_mu_ll + __shfl_xor_sync(mask, g_mu_ll, o);
        g_lt_ll = g_lt_ll + __shfl_xor_sync(mask, g_lt_ll, o);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) grad[2 + j] = __shfl_sync(mask, g_tt[j / W], j % W, W);
      lp = lp + pt;
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) grad[2 + j] = g_tt[j];
      lp = pt;
    }
    grad[0] = g_mu_lp + phi * g_mu_ll;
    grad[1] = g_lt_lp + phi * g_lt_ll;
    return lp + phi * ll;
  }
};

}  // namespace smcnuts
