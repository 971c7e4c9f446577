// PRMwCD tempered log-density and its gradient, for one particle.
//
// Replaces smcnuts_tpu/ops/nuts_pallas.py::prmwcd_tile_model(y, X, q).tile_fn,
// which the Pallas NUTS kernel inlines. Its plain version is
// smcnuts_torch/models/prmwcd.py::PrmwcdModel.logp_and_grad. The arithmetic is
// written op for op as both, in the same order, so the three round alike (the
// build turns off multiply-add contraction and fast math):
//   - per observation i: eta = b0, then eta += X[i][j] * b[j+1] for j in
//     order; mu = exp(eta); ll = (ll + y_i eta) - mu; resid = y_i - mu;
//     s_resid += resid; s_cov[j] += resid * X[i][j];
//   - the EP prior |b/Gamma|^q as exp(q (log|b| - g)) and its gradient with
//     the (q - 1) power, with no powf; lprior and d/dg left to right as the
//     Python expressions are.
// A beta of exactly 0 gives log 0 = -inf and a NaN gradient (inf * 0), as in
// the JAX model; nothing guards it.
//
// What bounds it on this card: FP32 issue, about 50 operations per
// observation and 100 observations per evaluation, one expf each; the y and X
// reads are shared-memory broadcasts (every thread of a warp reads the same
// address). Data: the block stages y (n_obs) then X row-major (n_obs x NCov)
// in shared memory, 4.8 KB for the asset; scalars (q, q - 1, the lgamma sum,
// 2 log 1.3) come by value, computed on the host in float64.
#pragma once

#include "model_data.cuh"

namespace smcnuts {

template <int NCov>
struct PrmwcdModel {
  static constexpr int M = NCov + 1;  // betas, intercept included
  static constexpr int D = M + 1;     // + log Gamma
  static constexpr int kScalars = 4;

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
    float ll = zero + lgamma_const;
    float s_resid = zero;
    float s_cov[NCov];
#pragma unroll
    for (int j = 0; j < NCov; ++j) s_cov[j] = zero;

    for (int i = 0; i < n_obs; ++i) {
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

    const float inv_gamma = expf(-g);
    float ep_sum = zero;
#pragma unroll
    for (int j = 1; j < M; ++j) {
      const float bj = b[j];
      const float lab = logf(fabsf(bj)) - g;
      ep_sum = ep_sum + expf(q * lab);
      const float sign = bj > 0.0f ? 1.0f : (bj < 0.0f ? -1.0f : bj);
      grad[j] = ((-q * expf(qm1 * lab)) * sign) * inv_gamma;  // the EP part
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
