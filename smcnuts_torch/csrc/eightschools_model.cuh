// Non-centred eight-schools tempered log-density and its gradient, for one
// particle.
//
// Replaces smcnuts_tpu/ops/nuts_pallas.py::elementwise_tile_model (the
// in-kernel jax.vjp of an elementwise tile density) applied to the logp_tiles
// of smcnuts_tpu/models/eightschools.py. CUDA has no autodiff, so the gradient
// is written out in closed form. Its plain version is
// smcnuts_torch/models/eightschools.py::EightSchoolsModel.logp_and_grad, op
// for op in the same order (the build turns off multiply-add contraction and
// fast math; a division by 5 is a multiplication by 0.2 on both sides):
//   x = [mu, log_tau, tt_1..tt_J], tau = exp(log_tau);
//   lp = (-0.5 zmu) zmu - c_mu, zmu = 0.2 mu;
//   lp += ((c_tau - log1p(zt zt)) + log 2) + log_tau, zt = 0.2 tau;
//   per school j, in sequence: lp = (lp - (0.5 tt_j) tt_j) - c,
//   z_j = ((y_j - mu) - tau tt_j) / sigma_j,
//   ll = ((ll - (0.5 z_j) z_j) - log sigma_j) - c;
//   gradient with zs_j = z_j / sigma_j: d/d mu = -0.2 zmu + phi sum zs_j,
//   d/d log_tau = 1 - 2 zt^2 / (1 + zt^2) + phi sum zs_j (tau tt_j),
//   d/d tt_j = -tt_j + phi (zs_j tau).
// A large log_tau overflows tau to inf and the density to -inf (the gradient
// to NaN), as in the JAX density; the tree's divergence guard handles it and
// nothing here guards it.
//
// What bounds it on this card: the FP32 instruction rate and latency, about 25
// operations and two divisions a school, one expf and one log1pf an
// evaluation. Data: y (J), sigma (J), log sigma (J) in shared memory; no
// scalars.
#pragma once

#include "model_data.cuh"

namespace smcnuts {

template <int J>
struct EightSchoolsModel {
  static constexpr int D = 2 + J;

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
    const float* tt = x + 2;
    const float tau = expf(log_tau);
    const float zmu = mu * kInv5;
    float lp = (-0.5f * zmu) * zmu - kMuConst;
    const float zt = tau * kInv5;
    const float zt2 = zt * zt;
    lp = lp + (((kTauConst - log1pf(zt2)) + kLog2) + log_tau);
    const float g_mu_lp = -zmu * kInv5;
    const float g_lt_lp = 1.0f - (2.0f * zt2) / (1.0f + zt2);

    float ll = mu * 0.0f, g_mu_ll = mu * 0.0f, g_lt_ll = mu * 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float t = tt[j];
      lp = (lp - (0.5f * t) * t) - kLogSqrt2Pi;
      const float z = ((y[j] - mu) - tau * t) / sigma[j];
      ll = ((ll - (0.5f * z) * z) - log_sigma[j]) - kLogSqrt2Pi;
      const float zs = z / sigma[j];
      g_mu_ll = g_mu_ll + zs;
      g_lt_ll = g_lt_ll + zs * (tau * t);
      grad[2 + j] = -t + phi * (zs * tau);
    }
    grad[0] = g_mu_lp + phi * g_mu_ll;
    grad[1] = g_lt_lp + phi * g_lt_ll;
    return lp + phi * ll;
  }
};

}  // namespace smcnuts
