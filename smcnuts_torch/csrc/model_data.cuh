// How a model's data reach the NUTS kernel, for every model alike.
//
// A model owns a block of floats (arma: y; PRMwCD: y then X row-major) that
// each thread block stages in shared memory once, and up to kMaxScalars
// scalar constants passed by value. A model is a struct with
//   static constexpr int D;                           // unconstrained dim
//   static bool accepts(int n_data, int n_scalars);   // host-side check
//   __device__ Model(const float* data_s, int n_data, const ModelScalars&);
//   __device__ float logp_grad(const float* x, float phi, float* grad) const;
#pragma once

namespace smcnuts {

constexpr int kMaxScalars = 4;

struct ModelScalars {
  float v[kMaxScalars];
};

}  // namespace smcnuts
