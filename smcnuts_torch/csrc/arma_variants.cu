// The measurement entry of the arma NUTS kernel: the kernel template
// (nuts_tree.cuh) with the arma model (arma_model.cuh) at one thread a
// particle, the recurrence in sequence (the kernel before the group design),
// timed beside the main path's entry (nuts_tree.cu, smcnuts_nuts_tree_arma:
// kArmaGroup lanes a particle, blocks of kArmaBlock threads) by
// chip_smoke.py phase 3 as the same-run witness, and held there to its plain
// version. The main path never dispatches it;
// smcnuts_torch/ops/nuts_cuda.py::ARMA_VARIANTS names its group width and
// block, and nuts_tree_variant launches it.

#include "arma_model.cuh"
#include "nuts_tree.cuh"

extern "C" {

SMCNUTS_ENTRY(smcnuts_nuts_tree_arma_w1, smcnuts::ArmaModel<1>)

}  // extern "C"
