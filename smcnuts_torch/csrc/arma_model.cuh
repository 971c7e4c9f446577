// ARMA(1,1) tempered log-density and its gradient, for one particle,
// evaluated by a group of W lanes (W = 1: one thread).
//
// Replaces smcnuts_tpu/ops/nuts_pallas.py::arma_tile_model(y).tile_fn, which
// the Pallas NUTS kernel inlines. Its plain version is
// smcnuts_torch/models/arma.py::ArmaModel.logp_and_grad(x, phi, group=W). The
// arithmetic is written op for op as that plain version runs on the card, in
// the same order, so the two round alike (the build turns off multiply-add
// contraction): a division by a constant is a multiplication by its float
// reciprocal, as PyTorch's CUDA division by a scalar is.
//
// The likelihood carries the error and its three tangents v = [err, d err /
// d mu, d err / d beta, d err / d theta] through the T observations with four
// running sums; the loglik, the priors (N(0,10), N(0,2), N(0,2),
// half-Cauchy(0,2.5) with the exp Jacobian) and the gradients follow in
// closed form. The recurrence is linear with one coefficient, -theta:
//   v_t = A v_{t-1} + c_t,  A = -theta I + N,  (N v)[3] = -v[0], N^2 = 0,
// so a run of L steps is the affine map v -> M v + o with
// M = p I + q N, p = (-theta)^L, q = L (-theta)^(L-1).
//
// At W > 1 the steps t = 1..T-1 are cut into W contiguous segments of
// L = ceil((T-1) / W) steps, lane l taking t = 1 + l L .. (trailing lanes a
// short or empty segment, the identity map):
//   - pass 1: each lane runs its segment from a zero state (lane 0 from the
//     t = 0 state, which makes its map constant) and carries p and q beside
//     it, p' = -theta p and q' = p - theta q a step, by multiplication in
//     order (no powf);
//   - scan: an inclusive Hillis-Steele scan of the maps over the group by
//     __shfl_up_sync in log2 W fixed steps, a lane composing its map after
//     the one d lanes below it; then lane l takes lane l-1's end state as
//     its incoming state (lane 0 the t = 0 state);
//   - pass 2: each lane runs its segment again from its incoming state and
//     sums err^2, err emu, err eb, err eth (lane 0 also the t = 0 terms);
//   - the four partials are reduced by the fixed xor butterfly of
//     prmwcd_model.cuh (both partners add the same two values, so every lane
//     ends with the same bits), and every lane computes the closed-form tail.
// W = 1 is the sequential order of the JAX package's arma_ll_vg_scan (one
// pass, no scan). Where theta or the errors overflow, the scan can make a NaN
// where the sequential order made an inf; both are non-finite, a divergent
// leaf either way, and the plain version makes the same NaN.
//
// What bounds it on this card: the latency of the dependent chain. Each step
// is an FMUL then an FADD on the last step's value (~8 cycles with
// -fmad=false), 199 steps a leapfrog at W = 1; at W > 1 the chain is 2 L
// steps, log2 W shuffle-and-combine steps and log2 W butterfly steps, for
// about twice the operations. Lane l reads y at stride L from shared memory:
// with L odd the lanes of a warp hit distinct banks. Measured on an H100
// (chip_smoke.py phases 3 and 10a; PERF.md keeps the numbers): W = 8 was the
// fastest of W = 4, 8, 16 and 32, 1.2x one thread a particle in the NUTS
// kernel at 25 x 512 trees and in the fused kernel at the eager tree's 4,096
// lanes, where the card is far from full; at a million particles, where one
// thread a particle fills the card, the group's extra pass, scan and
// replicated tree control make it 1.7-2.3x slower.
//
// The likelihood part, arma_loglik_grad<W>, is also the whole of the fused
// value-and-gradient kernel (arma_fused.cu, the port of
// smcnuts_tpu/ops/arma_fused.py::_arma_kernel), at the same W, so the eager
// path and the whole-tree kernel round alike; its plain version is
// smcnuts_torch/ops/arma_fused.py::arma_loglik_grad.
#pragma once

#include "model_data.cuh"

namespace smcnuts {

constexpr float kArmaLogSqrt2Pi = 0.91893853320467274178;
// Lanes a particle of the arma model in both kernels that run it: the NUTS
// kernel's arma entry (nuts_tree.cu) and the fused value and gradient
// (arma_fused.cu), one fixed number whatever the lane count, so the two and
// every batch size round alike. smcnuts_torch/ops/arma_fused.py::GROUP names
// the same number (the library load checks the two agree).
constexpr int kArmaGroup = 8;

// One step of the error recurrence and its tangents, from the state at t-1
// to the state at t: err_t = ((y_t - mu) - beta y_{t-1}) - theta err_{t-1}.
__device__ __forceinline__ void arma_step(float yt, float yp, float mu, float beta, float th,
                                          float& err, float& emu, float& eb, float& eth) {
  const float b = (yt - mu) - beta * yp;
  const float err_n = b - th * err;
  const float emu_n = -1.0f - th * emu;
  const float eb_n = -yp - th * eb;
  const float eth_n = -err - th * eth;
  err = err_n;
  emu = emu_n;
  eb = eb_n;
  eth = eth_n;
}

// loglik(y | mu, beta, theta, log_sigma) of the T observations y; its
// gradient in gl[0..3]. Called by the W lanes of a group together (W = 1:
// one thread), each with the same arguments; every lane returns the same bits.
template <int W>
__device__ __forceinline__ float arma_loglik_grad(const float* y, int T, float mu, float beta,
                                                  float th, float ls, float* gl) {
  const int lane = group_lane<W>();
  const int L = (T - 1 + W - 1) / W;  // steps a lane
  const int t0 = 1 + lane * L;
  const int t1 = t0 + L < T ? t0 + L : T;  // lane l runs t0 .. t1 - 1
  const float yp0 = y[(t0 < T ? t0 : T) - 1];
  const float err0 = (y[0] - mu) - beta * mu;
  const float emu0 = -1.0f - beta;
  const float eb0 = -mu;
  const float eth0 = 0.0f;
  float in_err = err0, in_emu = emu0, in_eb = eb0, in_eth = eth0;
  if constexpr (W > 1) {
    // Pass 1: the segment's map (p, q, o) from a zero state; lane 0's from
    // the t = 0 state.
    float err = lane == 0 ? err0 : 0.0f;
    float emu = lane == 0 ? emu0 : 0.0f;
    float eb = lane == 0 ? eb0 : 0.0f;
    float eth = lane == 0 ? eth0 : 0.0f;
    float p = 1.0f, q = 0.0f;
    float yp = yp0;
    for (int t = t0; t < t1; ++t) {
      const float yt = y[t];
      arma_step(yt, yp, mu, beta, th, err, emu, eb, eth);
      q = p - th * q;
      p = -th * p;
      yp = yt;
    }
    // Scan: lane l composes its map after lane l - d's, for d = 1, 2, ...
    const unsigned mask = group_mask<W>();
#pragma unroll
    for (int d = 1; d < W; d *= 2) {
      const float pp = __shfl_up_sync(mask, p, d, W);
      const float qq = __shfl_up_sync(mask, q, d, W);
      const float o_err = __shfl_up_sync(mask, err, d, W);
      const float o_emu = __shfl_up_sync(mask, emu, d, W);
      const float o_eb = __shfl_up_sync(mask, eb, d, W);
      const float o_eth = __shfl_up_sync(mask, eth, d, W);
      if (lane >= d) {
        err = p * o_err + err;
        emu = p * o_emu + emu;
        eb = p * o_eb + eb;
        eth = (p * o_eth - q * o_err) + eth;
        q = p * qq + q * pp;
        p = p * pp;
      }
    }
    // Lane l's incoming state is lane l - 1's end state.
    const float u_err = __shfl_up_sync(mask, err, 1, W);
    const float u_emu = __shfl_up_sync(mask, emu, 1, W);
    const float u_eb = __shfl_up_sync(mask, eb, 1, W);
    const float u_eth = __shfl_up_sync(mask, eth, 1, W);
    if (lane > 0) {
      in_err = u_err;
      in_emu = u_emu;
      in_eb = u_eb;
      in_eth = u_eth;
    }
  }

  // Pass 2: the segment again from its incoming state, with the four sums.
  float err = in_err, emu = in_emu, eb = in_eb, eth = in_eth;
  float s2 = 0.0f, smu = 0.0f, sb = 0.0f, sth = 0.0f;
  if (lane == 0) {
    s2 = err * err;
    smu = err * emu;
    sb = err * eb;
    sth = err * eth;
  }
  float yp = yp0;
  for (int t = t0; t < t1; ++t) {
    const float yt = y[t];
    arma_step(yt, yp, mu, beta, th, err, emu, eb, eth);
    s2 = s2 + err * err;
    smu = smu + err * emu;
    sb = sb + err * eb;
    sth = sth + err * eth;
    yp = yt;
  }
  if constexpr (W > 1) {
    const unsigned mask = group_mask<W>();
#pragma unroll
    for (int o = W / 2; o > 0; o /= 2) {
      s2 = s2 + __shfl_xor_sync(mask, s2, o);
      smu = smu + __shfl_xor_sync(mask, smu, o);
      sb = sb + __shfl_xor_sync(mask, sb, o);
      sth = sth + __shfl_xor_sync(mask, sth, o);
    }
  }

  const float Tf = static_cast<float>(T);
  const float inv_s2 = expf(-2.0f * ls);
  gl[0] = -smu * inv_s2;
  gl[1] = -sb * inv_s2;
  gl[2] = -sth * inv_s2;
  gl[3] = s2 * inv_s2 + -Tf;
  return -Tf * (ls + kArmaLogSqrt2Pi) - (0.5f * s2) * inv_s2;
}

template <int W>
struct ArmaModel {
  static constexpr int D = 4;
  static constexpr int kGroup = W;

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
    const float ll = arma_loglik_grad<W>(y, T, mu, beta, th, ls, gl);

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
