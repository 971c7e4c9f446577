// The libdevice calls a generated model emits for cos, sin, erf, erfc,
// lgamma, tan, atan, asin, acos, sinh and cosh, applied to a vector: the check that they round as ATen's own CUDA
// ops do.
//
// Replaces no TPU kernel. A generated model (ops/generated.py) emits
// cosf, sinf, erff, erfcf, lgammaf, tanf, atanf, asinf, acosf, sinhf and
// coshf as calls, as it emits expf and logf, and its plain version runs the
// ATen op of the same name on the same operands. They
// agree to the bit only if the two compilations of the same libdevice
// function round alike: the port builds with -fmad=false, ATen with FMA
// contraction on. `ops/generated.libdevice_unary` launches this kernel, and
// chip_smoke.py (phase `solvers`) and tests/test_torch_cuda.py hold it to
// torch's op on every float32 in the range the densities use.
//
// What bounds it: memory, 8 bytes a value (one read, one write); it is a
// check, not on any path.

#include <cuda_runtime.h>

namespace smcnuts {

template <int kOp>
__global__ void libdevice_unary_kernel(const float* __restrict__ x, float* __restrict__ out,
                                       long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  float r;
  if (kOp == 0) {
    r = cosf(v);
  } else if (kOp == 1) {
    r = sinf(v);
  } else if (kOp == 2) {
    r = erff(v);
  } else if (kOp == 3) {
    r = erfcf(v);
  } else if (kOp == 4) {
    r = lgammaf(v);
  } else if (kOp == 5) {
    r = tanf(v);
  } else if (kOp == 6) {
    r = atanf(v);
  } else if (kOp == 7) {
    r = asinf(v);
  } else if (kOp == 8) {
    r = acosf(v);
  } else if (kOp == 9) {
    r = sinhf(v);
  } else {
    r = coshf(v);
  }
  out[i] = r;
}

}  // namespace smcnuts

extern "C" {

// op: 0 cosf, 1 sinf, 2 erff, 3 erfcf, 4 lgammaf, 5 tanf, 6 atanf, 7 asinf,
// 8 acosf, 9 sinhf, 10 coshf. One launch of n threads on
// `stream`; returns cudaGetLastError(), cudaErrorInvalidValue for another op.
int smcnuts_libdevice_unary(int op, const float* x, float* out, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  switch (op) {
    case 0: smcnuts::libdevice_unary_kernel<0><<<blocks, threads, 0, st>>>(x, out, n); break;
    case 1: smcnuts::libdevice_unary_kernel<1><<<blocks, threads, 0, st>>>(x, out, n); break;
    case 2: smcnuts::libdevice_unary_kernel<2><<<blocks, threads, 0, st>>>(x, out, n); break;
    case 3: smcnuts::libdevice_unary_kernel<3><<<blocks, threads, 0, st>>>(x, out, n); break;
    case 4: smcnuts::libdevice_unary_kernel<4><<<blocks, threads, 0, st>>>(x, out, n); break;
    case 5: smcnuts::libdevice_unary_kernel<5><<<blocks, threads, 0, st>>>(x, out, n); break;
    case 6: smcnuts::libdevice_unary_kernel<6><<<blocks, threads, 0, st>>>(x, out, n); break;
    case 7: smcnuts::libdevice_unary_kernel<7><<<blocks, threads, 0, st>>>(x, out, n); break;
    case 8: smcnuts::libdevice_unary_kernel<8><<<blocks, threads, 0, st>>>(x, out, n); break;
    case 9: smcnuts::libdevice_unary_kernel<9><<<blocks, threads, 0, st>>>(x, out, n); break;
    case 10: smcnuts::libdevice_unary_kernel<10><<<blocks, threads, 0, st>>>(x, out, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
