// The measurement entry of the eight-schools NUTS kernel: the kernel template
// (nuts_tree.cuh) with the eight-schools model (eightschools_model.cuh) at
// one thread a particle, the schools in sequence (the kernel before the group
// design), timed beside the main path's entry (nuts_tree.cu,
// smcnuts_nuts_tree_eightschools: kSchoolsGroup lanes a particle, blocks of
// kSchoolsBlock threads) by chip_smoke.py phase 8 as the same-run witness,
// and held there to its plain version. Beside it, the main entry's model
// without its register cap (nuts_tree.cuh: MinBlocks), timed in turns with
// the main entry, equal to it to the bit. The main path never dispatches
// either; smcnuts_torch/ops/nuts_cuda.py::EIGHTSCHOOLS_VARIANTS names their
// group widths and blocks, and nuts_tree_variant launches them.

#include "eightschools_model.cuh"
#include "nuts_tree.cuh"

namespace smcnuts {

constexpr int kJ = 8;  // as kSchools of nuts_tree.cu

// The main entry's model (EightSchoolsModel<kJ, 2> in blocks of 64, as
// kSchoolsGroup and kSchoolsBlock of nuts_tree.cu) without its register cap.
struct EightSchoolsUncapped : EightSchoolsModel<kJ, 2> {
  static constexpr int kMaxRegisters = 0;
  using EightSchoolsModel<kJ, 2>::EightSchoolsModel;
};

}  // namespace smcnuts

extern "C" {

SMCNUTS_ENTRY(smcnuts_nuts_tree_eightschools_w1, smcnuts::EightSchoolsModel<smcnuts::kJ>)
SMCNUTS_ENTRY(smcnuts_nuts_tree_eightschools_uncapped, smcnuts::EightSchoolsUncapped, 64)

}  // extern "C"
