// Measurement entries of the PRMwCD NUTS kernel: other designs of the kernel
// template (nuts_tree.cuh) with the PRMwCD model (prmwcd_model.cuh), timed
// beside the main path's entry (nuts_tree.cu, smcnuts_nuts_tree_prmwcd: W = 16
// lanes a particle, blocks of 64 threads) by chip_smoke.py phase 4 and held
// there to their plain versions. The main path never dispatches them;
// smcnuts_torch/ops/nuts_cuda.py::PRMWCD_VARIANTS names each one's group width
// and block, and nuts_tree_variant launches it.
//   - w1: one thread a particle, every observation summed in sequence (the
//     kernel before the group design, kept as the same-run witness);
//   - w32: a warp a particle, in blocks of 64 threads;
//   - b128: the main path's model in blocks of 128 threads (eight particles).

#include "nuts_tree.cuh"
#include "prmwcd_model.cuh"

namespace smcnuts {

constexpr int kCov = 11;  // as kPrmwcdCov of nuts_tree.cu

}  // namespace smcnuts

extern "C" {

SMCNUTS_ENTRY(smcnuts_nuts_tree_prmwcd_w1, smcnuts::PrmwcdModel<smcnuts::kCov>)
SMCNUTS_ENTRY(smcnuts_nuts_tree_prmwcd_w32, smcnuts::PrmwcdModel<smcnuts::kCov, 32>, 64)
SMCNUTS_ENTRY(smcnuts_nuts_tree_prmwcd_b128, smcnuts::PrmwcdModel<smcnuts::kCov, 16>, 128)

}  // extern "C"
