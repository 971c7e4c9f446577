// Fused ARMA(1,1) log-likelihood and its gradient, one thread per particle,
// for sm_90a.
//
// Replaces smcnuts_tpu/ops/arma_fused.py::_arma_kernel (launched by
// arma_ll_vg_pallas): theta (N, 4) = [mu, beta, theta_ma, log_sigma] and the
// T observations y -> loglik (N,) and its gradient (N, 4), in one forward pass
// of the error recurrence with its three tangents and four running sums. The
// pass is arma_loglik_grad of arma_model.cuh, the same device function the
// whole-tree NUTS kernel inlines, so both round alike. Its plain version is
// smcnuts_torch/ops/arma_fused.py::arma_ll_vg_plain, the wrapper
// smcnuts_torch/ops/arma_fused.py::arma_ll_vg.
//
// What bounds it on this card: operations. About 21 FP32 operations a step
// of the T = 200 recurrence, ~4,200 a particle, against 36 bytes in and out
// (theta read as one float4, the gradient written as one float4, the loglik
// beside it). Each step depends on the last, so a thread's chain is serial;
// the card hides that latency with many particles in flight. At the eager
// tree's widths (a few thousand lanes a leaf) a launch is bound by its own
// latency, not by either rate.
//
// Design: the block stages y in shared memory once; every thread then reads
// the same address at each step (a broadcast), and the eight carried values
// stay in registers for the whole pass. No tensor cores, no TMA: there is no
// matrix product and 36 bytes a particle.
#include <cuda_runtime.h>

#include "arma_model.cuh"

namespace smcnuts {

constexpr int kArmaFusedThreads = 128;
// y lives in shared memory without an opt-in: at most 12,288 observations.
constexpr int kArmaFusedMaxT = 48 * 1024 / static_cast<int>(sizeof(float));

__global__ void __launch_bounds__(kArmaFusedThreads)
    arma_ll_vg_kernel(const float4* __restrict__ theta, const float* __restrict__ y, int T,
                      int n, float* __restrict__ ll, float4* __restrict__ grad) {
  extern __shared__ float y_s[];
  for (int t = threadIdx.x; t < T; t += blockDim.x) y_s[t] = y[t];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 p = theta[i];
  float g[4];
  ll[i] = arma_loglik_grad(y_s, T, p.x, p.y, p.z, p.w, g);
  grad[i] = make_float4(g[0], g[1], g[2], g[3]);
}

}  // namespace smcnuts

extern "C" {

int smcnuts_arma_fused_max_t() { return smcnuts::kArmaFusedMaxT; }

// Launches the kernel on `stream` for n particles and returns
// cudaGetLastError(). theta is (n, 4) and grad (n, 4), both 16-byte aligned;
// ll is (n,); y holds T floats. It does not synchronise and allocates nothing.
int smcnuts_arma_ll_vg(const float* theta, const float* y, int T, int n, float* ll,
                       float* grad, void* stream) {
  if (n < 1 || T < 1 || T > smcnuts::kArmaFusedMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + smcnuts::kArmaFusedThreads - 1) / smcnuts::kArmaFusedThreads;
  const size_t smem = static_cast<size_t>(T) * sizeof(float);
  smcnuts::arma_ll_vg_kernel<<<blocks, smcnuts::kArmaFusedThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(theta), y, T, n, ll, reinterpret_cast<float4*>(grad));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
