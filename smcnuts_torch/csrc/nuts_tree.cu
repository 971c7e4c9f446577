// The NUTS kernel of nuts_tree.cuh with each hand-written model inlined: one
// extern "C" entry per model, seven entries for the five models (the Gaussian
// once per dimension), each a first-stage and a continuation instantiation.
//
// The hand-written models replace these tile models of
// smcnuts_tpu/ops/nuts_pallas.py, each with its gradient written out by hand:
// arma_tile_model(y).tile_fn as ArmaModel<8> (arma_model.cuh; a group of
// lanes a particle, the T-step recurrence split over them by segments and a
// lane scan),
// prmwcd_tile_model(y, X, q).tile_fn as PrmwcdModel<11, 16>
// (prmwcd_model.cuh; a half warp a particle, the observations and the prior
// split over its lanes),
// and elementwise_tile_model (in-kernel jax.vjp) over the gaussian,
// eightschools and logistic densities as GaussianPipelined<2|3|5>
// (gaussian_model.cuh; one thread a tree through the pipelined walk of
// nuts_tree.cuh, in blocks of kGaussianBlock; the kernel before it,
// GaussianModel<3>, is its witness, gaussian_variants.cu),
// EightSchoolsModel<8> (eightschools_model.cuh) and LogisticModel<8, 16>
// (logistic_model.cuh; a half warp a particle, the observations split over
// its lanes).
// Their plain PyTorch version is smcnuts_torch/ops/nuts_cuda.py::nuts_tree_plain.

#include "arma_model.cuh"
#include "eightschools_model.cuh"
#include "gaussian_model.cuh"
#include "logistic_model.cuh"
#include "nuts_tree.cuh"
#include "prmwcd_model.cuh"

namespace smcnuts {

constexpr int kArmaBlock = 64;  // threads a block of the arma entry
using ArmaGroupModel = ArmaModel<kArmaGroup>;
constexpr int kPrmwcdCov = 11;  // covariates of the PRMwCD instantiation (D = 13)
constexpr int kPrmwcdGroup = 16;  // lanes a PRMwCD particle: a half warp
constexpr int kPrmwcdBlock = 64;  // threads a block of the PRMwCD entry: 4 particles
using PrmwcdGroupModel = PrmwcdModel<kPrmwcdCov, kPrmwcdGroup>;
constexpr int kSchools = 8;     // schools of the eight-schools instantiation (D = 10)
constexpr int kSchoolsGroup = 2;  // lanes an eight-schools particle: four schools a lane
constexpr int kSchoolsBlock = 64;  // threads a block of the eight-schools entry
using EightSchoolsGroupModel = EightSchoolsModel<kSchools, kSchoolsGroup>;
constexpr int kLogisticDim = 8; // covariates of the logistic instantiation
constexpr int kLogisticGroup = 16;  // lanes a logistic particle: a half warp
constexpr int kLogisticBlock = 64;  // threads a block of the logistic entry: 4 particles
using LogisticGroupModel = LogisticModel<kLogisticDim, kLogisticGroup>;
// Threads a block of the Gaussian entries: the pipelined walk keeps each
// thread's checkpoint stack in shared memory, 2 x 11 x D floats, 28,160
// bytes a block of 64 at D = 5 (56,320 at 128, past the 48 KB a block gets
// without an opt-in).
constexpr int kGaussianBlock = 64;

}  // namespace smcnuts

extern "C" {

int smcnuts_nuts_tree_max_depth() { return smcnuts::kMaxDepth; }

int smcnuts_arma_group() { return smcnuts::kArmaGroup; }

int smcnuts_arma_block() { return smcnuts::kArmaBlock; }

// Blocks of the arma entry an SM holds at once, with n_data floats of data.
int smcnuts_arma_blocks_per_sm(int n_data) {
  return smcnuts::blocks_per_sm<smcnuts::ArmaGroupModel, smcnuts::kArmaBlock>(n_data);
}

int smcnuts_prmwcd_n_cov() { return smcnuts::kPrmwcdCov; }

int smcnuts_prmwcd_group() { return smcnuts::kPrmwcdGroup; }

int smcnuts_prmwcd_block() { return smcnuts::kPrmwcdBlock; }

// Blocks of the PRMwCD entry an SM holds at once, with n_data floats of data.
int smcnuts_prmwcd_blocks_per_sm(int n_data) {
  return smcnuts::blocks_per_sm<smcnuts::PrmwcdGroupModel, smcnuts::kPrmwcdBlock>(n_data);
}

int smcnuts_eightschools_j() { return smcnuts::kSchools; }

int smcnuts_eightschools_group() { return smcnuts::kSchoolsGroup; }

int smcnuts_eightschools_block() { return smcnuts::kSchoolsBlock; }

// Blocks of the eight-schools entry an SM holds at once, with n_data floats of data.
int smcnuts_eightschools_blocks_per_sm(int n_data) {
  return smcnuts::blocks_per_sm<smcnuts::EightSchoolsGroupModel, smcnuts::kSchoolsBlock>(n_data);
}

int smcnuts_logistic_dim() { return smcnuts::kLogisticDim; }

int smcnuts_logistic_group() { return smcnuts::kLogisticGroup; }

int smcnuts_logistic_block() { return smcnuts::kLogisticBlock; }

// Blocks of the logistic entry an SM holds at once, with n_data floats of data.
int smcnuts_logistic_blocks_per_sm(int n_data) {
  return smcnuts::blocks_per_sm<smcnuts::LogisticGroupModel, smcnuts::kLogisticBlock>(n_data);
}

int smcnuts_gaussian_block() { return smcnuts::kGaussianBlock; }

int smcnuts_nuts_tree_bundle_rows(int dim) { return smcnuts::bundle_rows(dim); }

// The entries (SMCNUTS_ENTRY of nuts_tree.cuh says what each does).
SMCNUTS_ENTRY(smcnuts_nuts_tree_arma, smcnuts::ArmaGroupModel, smcnuts::kArmaBlock)
SMCNUTS_ENTRY(smcnuts_nuts_tree_prmwcd, smcnuts::PrmwcdGroupModel, smcnuts::kPrmwcdBlock)
// The Gaussian's dimensions: the list of ops/nuts_cuda.py::GAUSSIAN_DIMS.
SMCNUTS_ENTRY(smcnuts_nuts_tree_gaussian2, smcnuts::GaussianPipelined<2>,
              smcnuts::kGaussianBlock)
SMCNUTS_ENTRY(smcnuts_nuts_tree_gaussian3, smcnuts::GaussianPipelined<3>,
              smcnuts::kGaussianBlock)
SMCNUTS_ENTRY(smcnuts_nuts_tree_gaussian5, smcnuts::GaussianPipelined<5>,
              smcnuts::kGaussianBlock)
SMCNUTS_ENTRY(smcnuts_nuts_tree_eightschools, smcnuts::EightSchoolsGroupModel,
              smcnuts::kSchoolsBlock)
SMCNUTS_ENTRY(smcnuts_nuts_tree_logistic, smcnuts::LogisticGroupModel, smcnuts::kLogisticBlock)

}  // extern "C"
