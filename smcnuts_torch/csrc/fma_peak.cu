// The FP32 peak of the card: independent multiply-add chains per thread.
//
// Replaces experiments/bench_vpu_peak.py::make_kernel (the
// Pallas kernel launched at :55), the TPU's VPU peak that the JAX package's
// roofline divides by. Here it measures both FP32 rates a kernel's bound
// can rest on: the FMA variant's, which the data sheet's 67 TFLOP/s states
// (a fused multiply-add counted as two operations), and the FMUL+FADD
// variant's, the most the NUTS kernels and the fused ARMA kernel can reach
// as built: with -fmad=false their multiplies and adds run as separate FMUL
// and FADD instructions.
//
// Each thread reads one float x, starts kChains chains at x + 0.125 c, runs
// `steps` steps of c <- a_c * c + b_c on each (kFma: one __fmaf_rn; else
// __fmul_rn then __fadd_rn, separately rounded, as the plain version's
// tensor ops are), and writes the sum of its chains in order. a_c and b_c are
// kernel arguments, so nothing folds. The chains are independent, so a warp
// has kChains instructions in flight; kChains = 4 separates latency-bound
// from throughput-bound, as the arma recurrence's four chains are.
//
// What bounds it: the FP32 instruction rate (128 lanes an SM a cycle), once enough
// chains and warps hide the 4-cycle latency; no memory traffic in the loop.
// Its plain version is smcnuts_torch/ops/peak.py::fma_chains_plain.

#include <cuda_runtime.h>

namespace smcnuts {

constexpr int kMaxChains = 32;

struct ChainCoeffs {
  float a[kMaxChains];
  float b[kMaxChains];
};

template <int kChains, bool kFma>
__global__ void fma_peak_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                                int steps, const ChainCoeffs cf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x0 = x[i];
  float ch[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) ch[c] = x0 + static_cast<float>(c) * 0.125f;
#pragma unroll 10
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      ch[c] = kFma ? __fmaf_rn(cf.a[c], ch[c], cf.b[c])
                   : __fadd_rn(__fmul_rn(cf.a[c], ch[c]), cf.b[c]);
    }
  }
  float acc = ch[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) acc = acc + ch[c];
  out[i] = acc;
}

template <int kChains>
cudaError_t launch_peak(const float* x, float* out, int n, int steps, bool fma,
                        const ChainCoeffs& cf, int threads, cudaStream_t st) {
  const int blocks = (n + threads - 1) / threads;
  if (fma) {
    fma_peak_kernel<kChains, true><<<blocks, threads, 0, st>>>(x, out, n, steps, cf);
  } else {
    fma_peak_kernel<kChains, false><<<blocks, threads, 0, st>>>(x, out, n, steps, cf);
  }
  return cudaGetLastError();
}

}  // namespace smcnuts

extern "C" {

// One launch of n threads (`threads` a block) on `stream`; a and b are host
// arrays of n_chains floats. Returns cudaGetLastError(); n_chains other
// than 4, 8, 16 or 32 is refused.
int smcnuts_fma_peak(const float* x, float* out, int n, int n_chains, int fma, int steps,
                     const float* a, const float* b, int threads, void* stream) {
  if (n < 1 || steps < 0 || threads < 32 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  smcnuts::ChainCoeffs cf{};
  if (n_chains < 1 || n_chains > smcnuts::kMaxChains) return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < n_chains; ++c) {
    cf.a[c] = a[c];
    cf.b[c] = b[c];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f = fma != 0;
  switch (n_chains) {
    case 4: return static_cast<int>(smcnuts::launch_peak<4>(x, out, n, steps, f, cf, threads, st));
    case 8: return static_cast<int>(smcnuts::launch_peak<8>(x, out, n, steps, f, cf, threads, st));
    case 16: return static_cast<int>(smcnuts::launch_peak<16>(x, out, n, steps, f, cf, threads, st));
    case 32: return static_cast<int>(smcnuts::launch_peak<32>(x, out, n, steps, f, cf, threads, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
