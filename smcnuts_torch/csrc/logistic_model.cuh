// Logistic-regression tempered log-density and its gradient, for one particle.
//
// Replaces smcnuts_tpu/ops/nuts_pallas.py::elementwise_tile_model (the
// in-kernel jax.vjp of an elementwise tile density) applied to the logp_tiles
// of smcnuts_tpu/models/logistic.py. CUDA has no autodiff, so the gradient is
// written out in closed form. Its plain version is
// smcnuts_torch/models/logistic.py::LogisticModel.logp_and_grad, op for op in
// the same order (the build turns off multiply-add contraction and fast math):
//   lp = sum_d -((0.5 b_d) b_d) inv_ps2 in sequence, + prior_const;
//   per observation i, in sequence: eta = b_0 X_i0, then eta += X_id b_d;
//   e = exp(-|eta|); ll = (ll + y_i eta) - (max(eta, 0) + log1p(e));
//   resid = y_i - sigmoid(eta); s_d += resid X_id;
//   gradient -b_d inv_ps2 + phi s_d.
// The derivative of the stable softplus is the sigmoid, written as 1 / (1 + e)
// for eta >= 0 and e / (1 + e) below: e <= 1, so it cannot overflow however
// large |eta| is.
//
// What bounds it on this card: the FP32 instruction rate, about 4 D + 12
// operations an observation with one expf, one log1pf and one division; the y
// and X reads are shared-memory broadcasts. Data: y (n_obs) then X row-major
// (n_obs x D) in shared memory; scalars 1 / prior_scale^2 and the prior's
// constant, computed on the host in float64.
#pragma once

#include "model_data.cuh"

namespace smcnuts {

template <int Dim>
struct LogisticModel {
  static constexpr int D = Dim;
  static constexpr int kScalars = 2;

  const float* y;  // (n_obs,) in shared memory
  const float* X;  // (n_obs, D) row-major, after y
  int n_obs;
  float inv_ps2, prior_const;

  static bool accepts(int n_data, int n_scalars) {
    return n_data > 0 && n_data % (Dim + 1) == 0 && n_scalars == kScalars;
  }

  __device__ LogisticModel(const float* data, int n_data, const ModelScalars& s)
      : y(data), X(data + n_data / (Dim + 1)), n_obs(n_data / (Dim + 1)), inv_ps2(s.v[0]),
        prior_const(s.v[1]) {}

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
    for (int i = 0; i < n_obs; ++i) {
      const float* Xi = X + i * Dim;
      float eta = b[0] * Xi[0];
#pragma unroll
      for (int d = 1; d < Dim; ++d) eta = eta + Xi[d] * b[d];
      const float e = expf(-fabsf(eta));
      const float softplus = (eta > 0.0f ? eta : 0.0f) + log1pf(e);
      const float yi = y[i];
      ll = (ll + yi * eta) - softplus;
      const float one_e = 1.0f + e;
      const float resid = yi - (eta >= 0.0f ? 1.0f / one_e : e / one_e);
#pragma unroll
      for (int d = 0; d < Dim; ++d) s[d] = s[d] + resid * Xi[d];
    }
#pragma unroll
    for (int d = 0; d < Dim; ++d) grad[d] = -b[d] * inv_ps2 + phi * s[d];
    return lp + phi * ll;
  }
};

}  // namespace smcnuts
