// The measurement entry of the logistic NUTS kernel: the kernel template
// (nuts_tree.cuh) with the logistic model (logistic_model.cuh) at one thread
// a particle, every observation summed in sequence (the kernel before the
// group design), timed beside the main path's entry (nuts_tree.cu,
// smcnuts_nuts_tree_logistic: kLogisticGroup lanes a particle, blocks of
// kLogisticBlock threads) by chip_smoke.py phase 8 as the same-run witness,
// and held there to its plain version. The main path never dispatches it;
// smcnuts_torch/ops/nuts_cuda.py::LOGISTIC_VARIANTS names its group width
// and block, and nuts_tree_variant launches it.

#include "logistic_model.cuh"
#include "nuts_tree.cuh"

namespace smcnuts {

constexpr int kDim = 8;  // as kLogisticDim of nuts_tree.cu

}  // namespace smcnuts

extern "C" {

SMCNUTS_ENTRY(smcnuts_nuts_tree_logistic_w1, smcnuts::LogisticModel<smcnuts::kDim>)

}  // extern "C"
