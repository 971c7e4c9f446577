// Whole-tree NUTS proposal, one thread per particle, for sm_90a.
//
// Replaces three TPU kernels of smcnuts_tpu/ops/nuts_pallas.py:
//   - _nuts_kernel in its single-kernel fused form (momenta drawn in-kernel,
//     delta_h / ke0 / moved from the epilogue), launched by
//     _nuts_pallas_batched through nuts_batch_pallas_fused;
//   - the same kernel with the momenta given (nuts_batch_pallas), here the
//     r != nullptr case;
//   - the tile models it inlines, behind the Model template parameter:
//     arma_tile_model(y).tile_fn as ArmaModel (arma_model.cuh) and
//     prmwcd_tile_model(y, X, q).tile_fn as PrmwcdModel<11> (prmwcd_model.cuh).
// One instantiation and one extern "C" entry per model; the model's data
// reach the kernel generically (model_data.cuh).
// Its plain PyTorch version is smcnuts_torch/ops/nuts_cuda.py::nuts_tree_plain.
//
// What bounds it on this card: FP32 issue and latency in the model of every
// leaf (arma: the serial T=200 error recurrence, each step depending on the
// last; PRMwCD: 100 observations of ~50 operations and one expf), and warp
// divergence, since a warp runs until its deepest tree ends while lanes stop
// at different depths. With N=512 particles the grid is 4 blocks, so most SMs
// are idle. The simple design does nothing about either yet: lane compaction
// or persistent threads that take the next particle from a counter are
// ROADMAP Queue 2 item 4.
//
// Design: each thread walks its own tree with real early exit, so the TPU
// kernel's per-lane masks become plain control flow. Run parameters (phi,
// step size, inverse mass, seed) are read per run at p / n_per_run, so B runs
// of one SMC iteration share one launch. The block stages the model's data in
// shared memory once. The checkpoint stack, 2 x (kMaxDepth+1) x D floats a
// thread, lives in local memory. Random numbers are addressed by their place
// in the tree and keyed by the run's seed alone (draws.cuh), so run b of a
// batch draws what it would draw alone.

#include <cstdint>

#include <cuda_runtime.h>

#include "arma_model.cuh"
#include "draws.cuh"
#include "model_data.cuh"
#include "prmwcd_model.cuh"

namespace smcnuts {

constexpr int kMaxDepth = 10;  // compile-time bound on max_depth
constexpr int kThreads = 128;  // threads per block
constexpr float kDivergence = 100.0f;  // nats
constexpr float kTwoPi = 6.28318530717958647693;
constexpr int kPrmwcdCov = 11;  // covariates of the PRMwCD instantiation (D = 13)
constexpr int kStats = 8;  // logp0, logp_prop, accept_stat, depth, leapfrogs, delta_h, ke0, moved

struct TreeArgs {
  const float* x;         // (P, D)
  const float* r;         // (P, D), or nullptr: momenta drawn in-kernel
  const float* data;      // (n_data,): the model's block of floats
  int n_data;
  ModelScalars scalars;   // the model's scalar constants
  const int32_t* seed;    // (n_runs,)
  const float* phi;       // (n_runs,)
  const float* eps;       // (n_runs,)
  const float* inv_mass;  // (n_runs, D)
  int n_per_run;
  int total;              // P = n_runs * n_per_run
  int max_depth;
  bool zero_bits;
  float* x_out;           // (P, D)
  float* r_out;           // (P, D)
  float* stats;           // (kStats, P)
};

template <int D>
__device__ __forceinline__ float kinetic(const float* im, const float* r) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = acc + (im[d] * r[d]) * r[d];
  return 0.5f * acc;
}

// sum_d (dx_d * im_d) * v_d, summed over d in order.
template <int D>
__device__ __forceinline__ float dot_im(const float* dx, const float* im, const float* v) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = acc + (dx[d] * im[d]) * v[d];
  return acc;
}

template <int D>
__device__ __forceinline__ void copy(float* dst, const float* src) {
#pragma unroll
  for (int d = 0; d < D; ++d) dst[d] = src[d];
}

template <class Model>
__global__ void __launch_bounds__(kThreads) nuts_tree_kernel(const TreeArgs a) {
  constexpr int D = Model::D;
  extern __shared__ float data_s[];
  for (int t = threadIdx.x; t < a.n_data; t += blockDim.x) data_s[t] = a.data[t];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.total) return;  // padding threads
  const int run = p / a.n_per_run;
  const Model model(data_s, a.n_data, a.scalars);
  const float phi = a.phi[run];
  const float eps = a.eps[run];
  float im[D];
#pragma unroll
  for (int d = 0; d < D; ++d) im[d] = a.inv_mass[run * D + d];
  const TreeDraws draws{static_cast<uint32_t>(a.seed[run]),
                        static_cast<uint32_t>(p - run * a.n_per_run), a.zero_bits};

  // Prologue: momenta, start energy, slice variable.
  float x0[D], r0[D], g0[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x0[d] = a.x[p * D + d];
  if (a.r != nullptr) {
#pragma unroll
    for (int d = 0; d < D; ++d) r0[d] = a.r[p * D + d];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float u1 = draws.uniform(kPrologue, 0, 2 * d);
      const float u2 = draws.uniform(kPrologue, 0, 2 * d + 1);
      r0[d] = (sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2)) * rsqrtf(im[d]);
    }
  }
  const float logp0 = model.logp_grad(x0, phi, g0);
  const float ke0 = kinetic<D>(im, r0);
  const float H0 = logp0 - ke0;
  const float logu = H0 - (-logf(draws.uniform(kPrologue, 0, 2 * D)));

  float xm[D], rm[D], gm[D], xp[D], rp[D], gp[D], xs[D], rs[D];
  copy<D>(xm, x0); copy<D>(rm, r0); copy<D>(gm, g0);
  copy<D>(xp, x0); copy<D>(rp, r0); copy<D>(gp, g0);
  copy<D>(xs, x0); copy<D>(rs, r0);
  float lps = logp0, n = 1.0f;
  float alpha_sum = 0.0f, alpha_cnt = 0.0f, lf_cnt = 0.0f, depth_done = 0.0f;
  float ck_x[(kMaxDepth + 1) * D], ck_r[(kMaxDepth + 1) * D];

  for (int depth = 0; depth <= a.max_depth; ++depth) {
    const bool back = !(draws.uniform(kDirection, depth, 0) < 0.5f);
    const float direction = back ? -1.0f : 1.0f;
    float x[D], r[D], g[D], xpr[D], rpr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = back ? xm[d] : xp[d];
      r[d] = back ? rm[d] : rp[d];
      g[d] = back ? gm[d] : gp[d];
      xpr[d] = x[d];
      rpr[d] = r[d];
    }
    float lppr = lps, nsub = 0.0f;
    bool sstop = false;
    const float deps = direction * eps;
    const float half = 0.5f * deps;

    const int num_leaves = 1 << depth;
    for (int leaf = 0; leaf < num_leaves && !sstop; ++leaf) {
      float r_half[D], x1[D], g1[D], r1[D];
#pragma unroll
      for (int d = 0; d < D; ++d) r_half[d] = r[d] + half * g[d];
#pragma unroll
      for (int d = 0; d < D; ++d) x1[d] = x[d] + (deps * im[d]) * r_half[d];
      const float lp1 = model.logp_grad(x1, phi, g1);
#pragma unroll
      for (int d = 0; d < D; ++d) r1[d] = r_half[d] + half * g1[d];

      const float joint = lp1 - kinetic<D>(im, r1);
      const bool ok = isfinite(joint);
      const bool valid = ok && (logu < joint);
      const bool div = !ok || ((logu - kDivergence) >= joint);
      nsub = nsub + (valid ? 1.0f : 0.0f);
      if (valid && draws.uniform(kLeaf, depth, leaf) * nsub < 1.0f) {
        copy<D>(xpr, x1);
        copy<D>(rpr, r1);
        lppr = lp1;
      }
      const float ratio = expf(joint - H0);
      alpha_sum = alpha_sum + (ok ? (ratio > 1.0f ? 1.0f : ratio) : 0.0f);  // NaN stays NaN
      alpha_cnt = alpha_cnt + 1.0f;
      lf_cnt = lf_cnt + 1.0f;

      // Checkpoints: even leaves store the left end of the sub-trees they
      // open, odd leaves test every sub-tree they close.
      const int idx_max = __popc(leaf >> 1);
      bool turned = false;
      if ((leaf & 1) == 0) {
        copy<D>(ck_x + idx_max * D, x1);
        copy<D>(ck_r + idx_max * D, r1);
      } else {
        const int idx_min = idx_max - (__popc(leaf ^ (leaf + 1)) - 1) + 1;
        for (int slot = idx_min; slot <= idx_max; ++slot) {
          float dx[D];
#pragma unroll
          for (int d = 0; d < D; ++d) dx[d] = direction * (x1[d] - ck_x[slot * D + d]);
          turned = turned || dot_im<D>(dx, im, ck_r + slot * D) < 0.0f ||
                   dot_im<D>(dx, im, r1) < 0.0f;
        }
      }
      sstop = div || turned;
      copy<D>(x, x1);
      copy<D>(r, r1);
      copy<D>(g, g1);
    }

    if (back) {
      copy<D>(xm, x); copy<D>(rm, r); copy<D>(gm, g);
    } else {
      copy<D>(xp, x); copy<D>(rp, r); copy<D>(gp, g);
    }
    if (!sstop && draws.uniform(kAccept, depth, 0) * n < nsub) {
      copy<D>(xs, xpr);
      copy<D>(rs, rpr);
      lps = lppr;
    }
    n = n + nsub;
    depth_done = depth_done + 1.0f;

    float dx[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dx[d] = xp[d] - xm[d];
    if (sstop || dot_im<D>(dx, im, rm) < 0.0f || dot_im<D>(dx, im, rp) < 0.0f) break;
  }

  // Epilogue.
  const float dh = (lps - kinetic<D>(im, rs)) - H0;
  float moved = 1.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    moved = moved * (xs[d] != x0[d] ? 1.0f : 0.0f);
    a.x_out[p * D + d] = xs[d];
    a.r_out[p * D + d] = rs[d];
  }
  const float astat = alpha_sum / (alpha_cnt > 1.0f ? alpha_cnt : 1.0f);
  const int P = a.total;
  a.stats[0 * P + p] = logp0;
  a.stats[1 * P + p] = lps;
  a.stats[2 * P + p] = astat;
  a.stats[3 * P + p] = depth_done;
  a.stats[4 * P + p] = lf_cnt + 1.0f;
  a.stats[5 * P + p] = dh;
  a.stats[6 * P + p] = ke0;
  a.stats[7 * P + p] = moved;
}

template <class Model>
int launch(const float* x, const float* r, const float* data, int n_data, const float* scalars,
           int n_scalars, const int32_t* seed, const float* phi, const float* eps,
           const float* inv_mass, int n_runs, int n_per_run, int max_depth, int zero_bits,
           float* x_out, float* r_out, float* stats, void* stream) {
  if (max_depth < 0 || max_depth > kMaxDepth || n_runs < 1 || n_per_run < 1 ||
      n_scalars < 0 || n_scalars > kMaxScalars || !Model::accepts(n_data, n_scalars)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ModelScalars s{};
  for (int i = 0; i < n_scalars; ++i) s.v[i] = scalars[i];
  const TreeArgs args{x, r, data, n_data, s, seed, phi, eps, inv_mass, n_per_run,
                      n_runs * n_per_run, max_depth, zero_bits != 0, x_out, r_out, stats};
  const int blocks = (args.total + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(n_data) * sizeof(float);
  nuts_tree_kernel<Model><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace smcnuts

extern "C" {

int smcnuts_nuts_tree_max_depth() { return smcnuts::kMaxDepth; }

int smcnuts_prmwcd_n_cov() { return smcnuts::kPrmwcdCov; }

// Each entry launches one tree per particle on `stream` and returns
// cudaGetLastError(). It does not synchronise and allocates nothing: the
// caller owns every buffer. `scalars` is a host array of n_scalars floats.
#define SMCNUTS_ENTRY(NAME, MODEL)                                                              \
  int NAME(const float* x, const float* r, const float* data, int n_data, const float* scalars, \
           int n_scalars, const int32_t* seed, const float* phi, const float* eps,              \
           const float* inv_mass, int n_runs, int n_per_run, int max_depth, int zero_bits,      \
           float* x_out, float* r_out, float* stats, void* stream) {                            \
    return smcnuts::launch<MODEL>(x, r, data, n_data, scalars, n_scalars, seed, phi, eps,       \
                                  inv_mass, n_runs, n_per_run, max_depth, zero_bits, x_out,     \
                                  r_out, stats, stream);                                        \
  }

SMCNUTS_ENTRY(smcnuts_nuts_tree_arma, smcnuts::ArmaModel)
SMCNUTS_ENTRY(smcnuts_nuts_tree_prmwcd, smcnuts::PrmwcdModel<smcnuts::kPrmwcdCov>)

}  // extern "C"
