// Fused ARMA(1,1) log-likelihood and its gradient, a group of W lanes a
// particle, for sm_90a.
//
// Replaces smcnuts_tpu/ops/arma_fused.py::_arma_kernel (launched by
// arma_ll_vg_pallas): theta (N, 4) = [mu, beta, theta_ma, log_sigma] and the
// T observations y -> loglik (N,) and its gradient (N, 4), from the error
// recurrence with its three tangents and four running sums. The pass is
// arma_loglik_grad<W> of arma_model.cuh, the same device function at the same
// W as the whole-tree NUTS kernel's arma model (kArmaGroup, arma_model.cuh),
// so both round alike. Its plain version is
// smcnuts_torch/ops/arma_fused.py::arma_ll_vg_plain, the wrapper
// smcnuts_torch/ops/arma_fused.py::arma_ll_vg.
//
// What bounds it on this card: about 19 FP32 operations a step of the T = 200
// recurrence, ~3,800 a particle, against 36 bytes in and out (theta read as
// one float4, the gradient written as one float4, the loglik beside it), and
// each step depends on the last. At the eager tree's widths (a few thousand
// particles a leaf) one thread a particle fills a few dozen SMs and a launch
// lasts as long as one thread's 199-step chain; a group of W lanes a particle
// cuts the chain to 2 ceil(199 / W) steps and a 2 log2 W step scan and
// reduction (arma_model.cuh), and puts W times the threads on the card. At a
// million particles one thread a particle fills the card already, and the
// group's second pass and scan are extra work. Measured on an H100
// (chip_smoke.py phase 10a): at W = 8, 1.26x one thread a particle at 4,096
// lanes, 0.76x at 12,800 and 0.44x at 1,048,576.
//
// Design: the block stages y in shared memory once; the group's lanes read
// it at stride L; the carried values stay in registers. Lane 0 writes the
// loglik and the float4 gradient. No tensor cores, no TMA: there is no
// matrix product and 36 bytes a particle. The entry smcnuts_arma_ll_vg_w1 is
// one thread a particle (the kernel before the group design), a same-run
// witness that the main path never launches.
#include <cuda_runtime.h>

#include "arma_model.cuh"

namespace smcnuts {

constexpr int kArmaFusedThreads = 128;
// y lives in shared memory without an opt-in: at most 12,288 observations.
constexpr int kArmaFusedMaxT = 48 * 1024 / static_cast<int>(sizeof(float));

template <int W>
__global__ void __launch_bounds__(kArmaFusedThreads)
    arma_ll_vg_kernel(const float4* __restrict__ theta, const float* __restrict__ y, int T,
                      int n, float* __restrict__ ll, float4* __restrict__ grad) {
  extern __shared__ float y_s[];
  for (int t = threadIdx.x; t < T; t += blockDim.x) y_s[t] = y[t];
  __syncthreads();
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / W;
  if (i >= n) return;  // whole groups: W divides the block
  const float4 p = theta[i];
  float g[4];
  const float v = arma_loglik_grad<W>(y_s, T, p.x, p.y, p.z, p.w, g);
  if (group_lane<W>() != 0) return;
  ll[i] = v;
  grad[i] = make_float4(g[0], g[1], g[2], g[3]);
}

template <int W>
int launch_arma_ll_vg(const float* theta, const float* y, int T, int n, float* ll, float* grad,
                      void* stream) {
  static_assert(W >= 1 && W <= 32 && 32 % W == 0, "group width");
  if (n < 1 || T < 1 || T > kArmaFusedMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = static_cast<long long>(n) * W;
  const int blocks = static_cast<int>((threads + kArmaFusedThreads - 1) / kArmaFusedThreads);
  const size_t smem = static_cast<size_t>(T) * sizeof(float);
  arma_ll_vg_kernel<W><<<blocks, kArmaFusedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(theta), y, T, n, ll, reinterpret_cast<float4*>(grad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace smcnuts

extern "C" {

int smcnuts_arma_fused_max_t() { return smcnuts::kArmaFusedMaxT; }

// Each entry launches the kernel on `stream` for n particles and returns
// cudaGetLastError(). theta is (n, 4) and grad (n, 4), both 16-byte aligned;
// ll is (n,); y holds T floats. It does not synchronise and allocates nothing.
// smcnuts_arma_ll_vg runs kArmaGroup lanes a particle (arma_model.cuh), the
// same W as the NUTS kernel's arma entry; smcnuts_arma_ll_vg_w1 one thread.
int smcnuts_arma_ll_vg(const float* theta, const float* y, int T, int n, float* ll,
                       float* grad, void* stream) {
  return smcnuts::launch_arma_ll_vg<smcnuts::kArmaGroup>(theta, y, T, n, ll, grad, stream);
}

int smcnuts_arma_ll_vg_w1(const float* theta, const float* y, int T, int n, float* ll,
                          float* grad, void* stream) {
  return smcnuts::launch_arma_ll_vg<1>(theta, y, T, n, ll, grad, stream);
}

}  // extern "C"
