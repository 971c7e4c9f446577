// The measurement entry of the Gaussian NUTS kernel at D = 3, and the check
// of its fast division.
//   - smcnuts_nuts_tree_gaussian3_witness: the kernel template
//     (nuts_tree.cuh) with GaussianModel<3> (gaussian_model.cuh), the walk
//     every other model runs, in blocks of 128: the kernel before the
//     pipelined walk, the witness of the main path's
//     smcnuts_nuts_tree_gaussian3 (nuts_tree.cu). chip_smoke.py phase 8
//     holds it to the main entry to the bit and times both in turns; the
//     main path never dispatches it (smcnuts_torch/ops/nuts_cuda.py::
//     GAUSSIAN_VARIANTS, launched by nuts_tree_variant).
//   - smcnuts_quotient_check computes quotient_in_range (gaussian_model.cuh)
//     and `/` on the same pairs, one thread a pair (ops/nuts_cuda.py::
//     gaussian_quotients); it replaces no TPU kernel: it is the check that
//     the fast path is the division's own result in its range.

#include "gaussian_model.cuh"
#include "nuts_tree.cuh"

namespace smcnuts {

__global__ void quotient_check_kernel(const float* a, const float* b, float* fast,
                                      float* slow, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    fast[i] = quotient_in_range(a[i], b[i]);
    slow[i] = a[i] / b[i];
  }
}

}  // namespace smcnuts

extern "C" {

SMCNUTS_ENTRY(smcnuts_nuts_tree_gaussian3_witness, smcnuts::GaussianModel<3>)

int smcnuts_quotient_check(const float* a, const float* b, float* fast, float* slow, int n,
                           void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  smcnuts::quotient_check_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, fast, slow, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
