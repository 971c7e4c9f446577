// PRMwCD tempered log-density and its gradient, for one particle, evaluated
// by a group of W lanes (W = 1: one thread).
//
// Replaces smcnuts_tpu/ops/nuts_pallas.py::prmwcd_tile_model(y, X, q).tile_fn,
// which the Pallas NUTS kernel inlines. Its plain version is
// smcnuts_torch/models/prmwcd.py::PrmwcdModel.logp_and_grad(x, phi, group=W).
// The arithmetic is written op for op as the plain version, in the same
// order, so the two round alike (the build turns off multiply-add contraction
// and fast math):
//   - lane l of the group sums observations i = l, l + W, l + 2W, ... in
//     that order, each as the JAX tile model does it: eta = b0, then
//     eta += X[i][j] * b[j+1] for j in order; mu = exp(eta);
//     ll = (ll + y_i eta) - mu; resid = y_i - mu; s_resid += resid;
//     s_cov[j] += resid * X[i][j]. Lane 0's ll starts from the lgamma
//     constant, every other partial from zero (b0 * 0, which keeps a NaN);
//   - the 13 partials are reduced by a fixed xor butterfly,
//     v = v + shfl_xor(v, o) for o = W/2, ..., 1: both partners of a step
//     add the same two values, and IEEE addition is commutative, so every
//     lane ends with the same bits;
//   - the EP prior |b/Gamma|^q as exp(q (log|b| - g)) and its gradient with
//     the (q - 1) power, with no powf; lprior and d/dg left to right as the
//     Python expressions are. At W > 1 lane (j - 1) mod W computes beta j's
//     three transcendentals and the group gathers them by shuffles and adds
//     them in order j = 1, 2, ...: the same operations on the same values.
// W = 1 is the sequential order of the JAX tile model. A beta of exactly 0
// gives log 0 = -inf and a NaN gradient (inf * 0), as in the JAX model;
// nothing guards it.
//
// What bounds it on this card: FP32 issue, about 50 operations per
// observation and 100 observations per evaluation, one expf each. At W = 16 a
// lane does 6 or 7 observations, then 13 x 4 shuffle-and-add steps; the
// prior's 11 logf and 22 expf, issued by every lane, would then be as large a
// part, so they are split over the lanes too. Data: the
// block stages y (n_obs) then X row-major
// (n_obs x NCov) in shared memory, 4.8 KB for the asset; lanes reading rows
// l, l + 1, ... at stride NCov = 11 hit distinct banks (11 is odd), and at
// W = 1 every thread of a warp reads the same address (a broadcast). Scalars
// (q, q - 1, the lgamma sum, 2 log 1.3) come by value, computed on the host
// in float64.
#pragma once

#include "model_data.cuh"

namespace smcnuts {

template <int NCov, int W = 1>
struct PrmwcdModel {
  static constexpr int M = NCov + 1;  // betas, intercept included
  static constexpr int D = M + 1;     // + log Gamma
  static constexpr int kScalars = 4;
  static constexpr int kGroup = W;

  const float* y;  // (n_obs,) in shared memory
  const float* X;  // (n_obs, NCov) row-major, after y
  int n_obs;
  float q, qm1, lgamma_const, ig_const;

  static bool accepts(int n_data, int n_scalars) {
    return n_data > 0 && n_data % (NCov + 1) == 0 && n_scalars == kScalars;
  }

  __device__ PrmwcdModel(const float* data, int n_data, const ModelScalars& s)
      : y(data), X(data + n_data / (NCov + 1)), n_obs(n_data / (NCov + 1)),
        q(s.v[0]), qm1(s.v[1]), lgamma_const(s.v[2]), ig_const(s.v[3]) {}

  __device__ __forceinline__ float logp_grad(const float* x, float phi, float* grad) const {
    const float* b = x;
    const float g = x[M];
    const float zero = b[0] * 0.0f;
    const int lane = group_lane<W>();
    float ll = lane == 0 ? zero + lgamma_const : zero;
    float s_resid = zero;
    float s_cov[NCov];
#pragma unroll
    for (int j = 0; j < NCov; ++j) s_cov[j] = zero;

    for (int i = lane; i < n_obs; i += W) {
      const float* Xi = X + i * NCov;
      float eta = b[0];
#pragma unroll
      for (int j = 0; j < NCov; ++j) eta = eta + Xi[j] * b[j + 1];
      const float mu = expf(eta);
      const float yi = y[i];
      ll = (ll + yi * eta) - mu;
      const float resid = yi - mu;
      s_resid = s_resid + resid;
#pragma unroll
      for (int j = 0; j < NCov; ++j) s_cov[j] = s_cov[j] + resid * Xi[j];
    }
    if constexpr (W > 1) {
      const unsigned mask = group_mask<W>();
#pragma unroll
      for (int o = W / 2; o > 0; o /= 2) {
        ll = ll + __shfl_xor_sync(mask, ll, o);
        s_resid = s_resid + __shfl_xor_sync(mask, s_resid, o);
#pragma unroll
        for (int j = 0; j < NCov; ++j) s_cov[j] = s_cov[j] + __shfl_xor_sync(mask, s_cov[j], o);
      }
    }

    const float inv_gamma = expf(-g);
    float ep_sum = zero;
    if constexpr (W > 1) {
      // Lane l takes betas j = 1 + l, 1 + l + W, ... (each value picked by
      // selects, not by a dynamic index, which would go to local memory).
      constexpr int kRounds = (M - 1 + W - 1) / W;
      float pow_q[kRounds], gp[kRounds];
#pragma unroll
      for (int k = 0; k < kRounds; ++k) {
        float bj = b[1];
#pragma unroll
        for (int j = 2; j < M; ++j) bj = lane + k * W == j - 1 ? b[j] : bj;
        const float lab = logf(fabsf(bj)) - g;
        pow_q[k] = expf(q * lab);
        const float sign = bj > 0.0f ? 1.0f : (bj < 0.0f ? -1.0f : bj);
        gp[k] = ((-q * expf(qm1 * lab)) * sign) * inv_gamma;
      }
      const unsigned mask = group_mask<W>();
#pragma unroll
      for (int j = 1; j < M; ++j) {
        ep_sum = ep_sum + __shfl_sync(mask, pow_q[(j - 1) / W], (j - 1) % W, W);
        grad[j] = __shfl_sync(mask, gp[(j - 1) / W], (j - 1) % W, W);  // the EP part
      }
    } else {
#pragma unroll
      for (int j = 1; j < M; ++j) {
        const float bj = b[j];
        const float lab = logf(fabsf(bj)) - g;
        ep_sum = ep_sum + expf(q * lab);
        const float sign = bj > 0.0f ? 1.0f : (bj < 0.0f ? -1.0f : bj);
        grad[j] = ((-q * expf(qm1 * lab)) * sign) * inv_gamma;  // the EP part
      }
    }
    float lprior = ig_const - 3.0f * g;
    lprior = lprior - 1.3f * inv_gamma;
    lprior = lprior + g;
    lprior = lprior - static_cast<float>(M - 1) * g;
    lprior = lprior - ep_sum;
    float gp_g = -3.0f + 1.3f * inv_gamma;
    gp_g = gp_g + 1.0f;
    gp_g = gp_g - static_cast<float>(M - 1);
    gp_g = gp_g + q * ep_sum;

    grad[0] = phi * s_resid;  // intercept: flat prior
#pragma unroll
    for (int j = 0; j < NCov; ++j) grad[j + 1] = grad[j + 1] + phi * s_cov[j];
    grad[M] = gp_g;
    return lprior + phi * ll;
  }
};

}  // namespace smcnuts
