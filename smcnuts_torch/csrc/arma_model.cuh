// ARMA(1,1) tempered log-density and its gradient, for one particle.
//
// Replaces smcnuts_tpu/ops/nuts_pallas.py::arma_tile_model(y).tile_fn, which
// the Pallas NUTS kernel inlines. Its plain version is
// smcnuts_torch/models/arma.py::ArmaModel.logp_and_grad. The arithmetic is
// written op for op as that plain version runs on the card, so the two round
// alike (the build turns off multiply-add contraction): a division by a
// constant is a multiplication by its float reciprocal, as PyTorch's CUDA
// division by a scalar is.
//
// One pass over the T observations carries the error and its three tangents
// (d err / d mu, beta, theta) with four running sums; the loglik, the priors
// (N(0,10), N(0,2), N(0,2), half-Cauchy(0,2.5) with the exp Jacobian) and the
// gradients follow in closed form. y is read from shared memory, where every
// thread reads the same address (a broadcast).
//
// The likelihood part, arma_loglik_grad, is also the whole of the fused
// value-and-gradient kernel (arma_fused.cu, the port of
// smcnuts_tpu/ops/arma_fused.py::_arma_kernel), so the derivation exists once;
// its plain version is smcnuts_torch/ops/arma_fused.py::arma_ll_vg_plain.
#pragma once

#include "model_data.cuh"

namespace smcnuts {

constexpr float kArmaLogSqrt2Pi = 0.91893853320467274178;

// loglik(y | mu, beta, theta, log_sigma) of the T observations y; its
// gradient in gl[0..3]. Op for op as the JAX package's arma_ll_vg_scan and
// _assemble: err_t = ((y_t - mu) - beta y_{t-1}) - theta err_{t-1}.
__device__ __forceinline__ float arma_loglik_grad(const float* y, int T, float mu, float beta,
                                                  float th, float ls, float* gl) {
  float err = (y[0] - mu) - beta * mu;
  float emu = -1.0f - beta;
  float eb = -mu;
  float eth = 0.0f;
  float s2 = err * err, smu = err * emu, sb = err * eb, sth = err * eth;
  for (int t = 1; t < T; ++t) {
    const float b = (y[t] - mu) - beta * y[t - 1];
    const float err_n = b - th * err;
    const float emu_n = -1.0f - th * emu;
    const float eb_n = -y[t - 1] - th * eb;
    const float eth_n = -err - th * eth;
    err = err_n;
    emu = emu_n;
    eb = eb_n;
    eth = eth_n;
    s2 = s2 + err * err;
    smu = smu + err * emu;
    sb = sb + err * eb;
    sth = sth + err * eth;
  }

  const float Tf = static_cast<float>(T);
  const float inv_s2 = expf(-2.0f * ls);
  gl[0] = -smu * inv_s2;
  gl[1] = -sb * inv_s2;
  gl[2] = -sth * inv_s2;
  gl[3] = s2 * inv_s2 + -Tf;
  return -Tf * (ls + kArmaLogSqrt2Pi) - (0.5f * s2) * inv_s2;
}

struct ArmaModel {
  static constexpr int D = 4;

  const float* y;  // T observations in shared memory
  int T;

  static bool accepts(int n_data, int n_scalars) { return n_data > 0 && n_scalars == 0; }

  __device__ ArmaModel(const float* data, int n_data, const ModelScalars&)
      : y(data), T(n_data) {}

  __device__ __forceinline__ float logp_grad(const float* x, float phi, float* g) const {
    constexpr float kLogSqrt2Pi = kArmaLogSqrt2Pi;
    constexpr float kLogPi = 1.14472988584940017414;
    constexpr float kLog10 = 2.30258509299404568402;
    constexpr float kLog2 = 0.69314718055994530942;
    constexpr float kLog2_5 = 0.91629073187415506518;
    constexpr float kInv10 = 1.0f / 10.0f;
    constexpr float kInv2_5 = 1.0f / 2.5f;
    constexpr float kInv100 = 1.0f / 100.0f;

    const float mu = x[0], beta = x[1], th = x[2], ls = x[3];
    float gl[4];
    const float ll = arma_loglik_grad(y, T, mu, beta, th, ls, gl);

    const float z = expf(ls) * kInv2_5;
    const float mu_s = mu * kInv10, beta_s = beta * 0.5f, th_s = th * 0.5f;
    float lprior = -0.5f * (mu_s * mu_s);
    lprior = lprior - kLog10;
    lprior = lprior - kLogSqrt2Pi;
    lprior = lprior - 0.5f * (beta_s * beta_s);
    lprior = lprior - kLog2;
    lprior = lprior - kLogSqrt2Pi;
    lprior = lprior - 0.5f * (th_s * th_s);
    lprior = lprior - kLog2;
    lprior = lprior - kLogSqrt2Pi;
    lprior = lprior - kLogPi;
    lprior = lprior - kLog2_5;
    lprior = lprior - log1pf(z * z);
    lprior = lprior + ls;
    const float gp_mu = -mu * kInv100;
    const float gp_beta = -beta * 0.25f;
    const float gp_th = -th * 0.25f;
    const float gp_ls = 1.0f - ((2.0f * z) * z) / (z * z + 1.0f);

    g[0] = gp_mu + phi * gl[0];
    g[1] = gp_beta + phi * gl[1];
    g[2] = gp_th + phi * gl[2];
    g[3] = gp_ls + phi * gl[3];
    return lprior + phi * ll;
  }
};

}  // namespace smcnuts
