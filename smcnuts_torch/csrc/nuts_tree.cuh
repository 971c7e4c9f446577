#pragma once

// Whole-tree NUTS proposal for sm_90a, one tree per particle, as one kernel
// or as stages with lane compaction between them: the kernel template,
// included by nuts_tree.cu and the *_variants.cu files (the hand-written
// models' entries) and by every generated model's translation
// unit (smcnuts_torch/ops/generated.py).
//
// Replaces these TPU kernels of smcnuts_tpu/ops/nuts_pallas.py:
//   - _nuts_kernel in its single-kernel fused form (momenta drawn in-kernel,
//     delta_h / ke0 / moved and the optional accept-reject from the epilogue),
//     launched by _nuts_pallas_batched through nuts_batch_pallas_fused;
//   - the same kernel with the momenta given (nuts_batch_pallas), here the
//     r != nullptr case;
//   - the tile models it inlines, behind the Model template parameter: the
//     hand-written ones of nuts_tree.cu, and the generated ones of
//     tile_model_from_logp / tile_model_from_logp_fwd (ops/generated.py);
//   - the compacted multi-stage dispatch: _nuts_kernel with start_depth,
//     stop_depth, cont_in and cont_out (nuts_pallas.py:154-259, :503-562) and
//     the sort-and-gather glue between its stages (:775-915).
// Two instantiations for each entry that SMCNUTS_ENTRY defines: the first
// stage (prologue; the whole tree when its stop depth is the maximum depth)
// and the continuation stage. The model's data reach the kernel generically
// (model_data.cuh).
// Its plain PyTorch version is smcnuts_torch/ops/nuts_cuda.py::nuts_tree_plain.
//
// Groups. A model may name a group width W (Model::kGroup, model_data.cuh;
// 1 when it names none, and then the kernel is one thread a particle). With
// W > 1 the W threads t = W s .. W s + W - 1 of the grid work on particle
// slot s together, as lanes 0..W-1 of its group: every lane holds the whole
// tree state and runs the same control flow, and only the model's evaluation
// is split over the lanes, which leave identical bits in every lane (the
// model's own reduction: prmwcd_model.cuh). The draws are addressed by their
// place in the tree, so every lane draws the same bits. Every branch is then
// uniform inside a group, and lane 0 alone writes what leaves the kernel. A
// block of kBlock threads holds kBlock / W particles. arma runs at W = 8 in
// blocks of 64 threads (the T-step recurrence split over the lanes by
// segments and a lane scan), PRMwCD at W = 16, a half warp a particle, in
// blocks of 64 threads, logistic regression at W = 16 in blocks of 64 (its
// 64 observations split over the lanes), eight schools at W = 2 in blocks of
// 64 (four schools a lane), a generated reverse-mode model whose sums split
// over lanes at its own W (ops/generated.py); every other model at W = 1 in
// blocks of 128. A model may also name a register cap (Model::kMaxRegisters:
// the eight-schools and generated group models, 128); its kernel is then
// nuts_tree_kernel_capped, the same body under a bound that makes ptxas keep
// to it (MinBlocks), while every other model keeps nuts_tree_kernel's
// bound, which names no blocks and leaves ptxas its own choice.
//
// What bounds it on this card: FP32 issue and latency in the model of every
// leaf (arma: the serial T=200 error recurrence, each step depending on the
// last; PRMwCD: 100 observations of ~50 operations and one expf), and the
// deepest tree, since a tree's leapfrogs run one after another. At W = 1 a
// warp holds 32 trees and runs until the deepest of them ends (warp
// divergence), and with N=512 particles the grid is 4 blocks, so most SMs are
// idle; at 25 x 512 it is 100 blocks, one per SM, one warp a scheduler, so
// nothing hides the latency of a dependent operation, and the launch lasts as
// long as its deepest tree. At W = 16 (PRMwCD) a warp holds two trees, the
// chain of the deepest tree shrinks to 6-7 observations a lane and a 4-step
// butterfly a leapfrog, and 25 x 512 trees are 6,400 warps, more than the
// card holds at once; what bounds it then is instruction issue: the tree
// control, which every lane of a group issues alike, and the registers, which
// cap the warps an SM holds (measured on an H100 in chip_smoke.py phase 4:
// PERF.md keeps the widths, blocks and placements tried). At W = 8 (arma) a
// leapfrog's chain is 2 x 25 recurrence steps and a 3-step scan and
// butterfly instead of 199 steps, but the tree control, which does not
// shrink, is then as long as the model's part: the kernel gains 1.2x at
// 25 x 512 and loses 1.7x at 1,048,576 trees, where one thread a tree
// already filled the card (chip_smoke.py phase 3; PERF.md).
//
// The pipelined walk (pipelined_walk below), for a model that asks for it
// (Model::kPipelined; the Gaussian): one thread a tree, one loop over
// the leaves of every doubling, the model's divisions by their fast path
// with one range check an evaluation, the U-turn tests and pick by selects,
// the stack in shared memory; the same trees to the bit, 2.2x the walk
// below at 25 x 512 x depth 10 on an H100 (chip_smoke.py phase 8). Every
// other model compiles to the walk below, unchanged.
//
// Design: each group walks its own tree with real early exit, so the TPU
// kernel's per-lane masks become plain control flow. Run parameters (phi,
// step size, inverse mass, seed) are read per run at p / n_per_run, so B runs
// of one SMC iteration share one launch. The block stages the model's data in
// shared memory once. The checkpoint stack, 2 x (kMaxDepth+1) x D floats a
// tree, lives in local memory at W = 1 and, one copy a group, in shared
// memory after the data at W > 1 (a copy a lane would multiply its traffic
// by W), and so do a group's carriers, 8 D floats touched only between
// doublings, which takes PRMwCD from 255 registers a thread to 168
// (group_floats). Random numbers are addressed by their place in the tree and
// keyed by the run's seed alone (draws.cuh), so run b of a batch draws what
// it would draw alone, and a lane draws the same bits whichever stage and
// slot it is in; a shard of the particles (p_offset, p_stride) draws what
// its particles draw in the unsharded launch.
//
// Staging (the answer to warp divergence and to the block's tail): a stage
// runs doublings start_depth..stop_depth. A group whose tree ends inside the
// stage runs the epilogue and writes its outputs at its own particle, at
// whichever stage that is, so the epilogue runs exactly once a particle. A
// group whose tree goes on reserves a slot in the next stage's bundle (one
// atomicAdd a warp at W = 1, one a group at W > 1) and writes its carriers
// and its particle index there; the next launch gives group g slot g, so the
// trees still at work fill dense warps and blocks. There is no sort, no
// gather and no un-permute, and the host never reads the survivor count: the
// continuation is launched over every particle, and a block whose first slot
// is past the count returns before it touches shared memory. The bundle is
// (8 D + 11, P) floats, slot-minor, so neighbouring slots touch neighbouring
// addresses. The start state is not carried: the epilogue reads x0 again from
// the input and draws r0 again from the same address of the stream, which
// also keeps 2 D floats a thread out of the registers during the walk.
//
// What staging buys on an H100 at W = 1 (chip_smoke.py phase 6b): nothing up
// to one block an SM (25 x 512 lanes), where no warp waits for another and
// the dispatch lasts as long as its deepest tree either way; past that, warps
// that end early make room for waiting ones, and because a stage costs only a
// launch and one pass over the survivors' carriers, a split after every
// doubling is the fastest choice (about 2x at 400 x 512 PRMwCD lanes). For
// the arma and PRMwCD group kernels models/base.py keeps the measurement.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "draws.cuh"
#include "model_data.cuh"

namespace smcnuts {

constexpr int kMaxDepth = 10;  // compile-time bound on max_depth
constexpr int kThreads = 128;  // threads per block, unless an entry names another count
constexpr float kDivergence = 100.0f;  // nats
constexpr float kTwoPi = 6.28318530717958647693;
constexpr int kStats = 8;  // logp0, logp_prop, accept_stat, depth, leapfrogs, delta_h, ke0, moved

// Rows of the bundle a stage hands to the next: the lane index (its bits),
// 8 vectors of D, 10 scalars.
constexpr int bundle_rows(int dim) { return 8 * dim + 11; }

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
  int p_offset;           // the particle map of a shard: local particle j of a
  int p_stride;           // run draws as global particle p_offset + p_stride j
  int total;              // P = n_runs * n_per_run
  int max_depth;
  bool zero_bits;
  bool acc_rej;           // accept-reject in the epilogue
  int start_depth;        // first doubling of this stage
  int stop_depth;         // last doubling of this stage; max_depth in the final one
  const float* cont_in;   // (bundle_rows(D), P): a continuation stage's lanes
  const int* n_in;        // how many slots of cont_in are filled
  float* cont_out;        // the bundle a non-final stage fills
  int* n_out;             // its slot counter, zero before the launch
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

// r0_d ~ N(0, 1 / im_d) from the prologue's draws 2d and 2d + 1.
__device__ __forceinline__ float start_momentum(const TreeDraws& draws, float im_d, int d) {
  const float u1 = draws.uniform(kPrologue, 0, 2 * d);
  const float u2 = draws.uniform(kPrologue, 0, 2 * d + 1);
  return (sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2)) * rsqrtf(im_d);
}

// The group width of a model: Model::kGroup where it names one, else 1.
template <class Model, class = void>
struct GroupWidth {
  static constexpr int value = 1;
};
template <class Model>
struct GroupWidth<Model, std::void_t<decltype(Model::kGroup)>> {
  static constexpr int value = Model::kGroup;
};

// The blocks of kBlock threads that __launch_bounds__ asks an SM to hold at
// once where the model names a register cap above 0 (Model::kMaxRegisters):
// 65536 registers / (the cap x kBlock). 0 where it names none, and then the
// kernel is nuts_tree_kernel, whose bound names no blocks (ptxas's choice).
// Why a cap, where occupancy does not call for one: shared memory holds the
// eight-schools entry at W = 2 in blocks of 64 to 5 blocks an SM, and so
// would 168 registers a thread, ptxas's own choice for its continuation
// stage. Held to 128 it ran 0.9% faster on an H100 all the same, timed in
// turns with the uncapped build (eightschools_variants.cu; PERF.md), a gap
// twenty times the spread between rounds. A bound on the shared kernel
// instead of a second one would not do: a minimum of 1 block recompiles
// every other model (arma's W = 8 entry went from 80 to 96 registers).
template <class Model, int kBlock, class = void>
struct MinBlocks {
  static constexpr int value = 0;
};
template <class Model, int kBlock>
struct MinBlocks<Model, kBlock, std::void_t<decltype(Model::kMaxRegisters)>> {
  static constexpr int value =
      Model::kMaxRegisters > 0 ? 65536 / (Model::kMaxRegisters * kBlock) : 0;
};

// A slot of the next stage's bundle for every calling thread: the threads of
// the warp that are here together take consecutive slots from one atomicAdd.
__device__ __forceinline__ int reserve_slot(int* counter) {
  const unsigned mask = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(mask));
  base = __shfl_sync(mask, base, leader);
  return base + __popc(mask & ((1u << lane) - 1u));
}

// A slot of the next stage's bundle for the calling group of W lanes: lane 0
// takes it and hands it to the group.
template <int W>
__device__ __forceinline__ int reserve_group_slot(int* counter) {
  int slot = 0;
  if (group_lane<W>() == 0) slot = atomicAdd(counter, 1);
  return __shfl_sync(group_mask<W>(), slot, 0, W);
}

template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row, int P, int slot) {
#pragma unroll
  for (int d = 0; d < D; ++d) dst[d] = src[(row + d) * P + slot];
}

template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float* src, int row, int P, int slot) {
#pragma unroll
  for (int d = 0; d < D; ++d) dst[(row + d) * P + slot] = src[d];
}

// Floats of shared memory a group keeps after the model's data: at W > 1
// its checkpoint stack and its carriers (the ends of the trajectory, their
// gradients and the sample: 8 vectors of D), one copy a group; at W = 1
// none (the stack in local memory, the carriers in registers).
template <class Model>
__host__ __device__ constexpr int group_floats() {
  return GroupWidth<Model>::value > 1 ? (2 * (kMaxDepth + 1) + 8) * Model::D : 0;
}

// Whether the model runs the pipelined walk: Model::kPipelined where the
// model names it, else false, the walk of nuts_tree_body that every other
// model runs.
template <class Model, class = void>
struct Pipelined {
  static constexpr bool value = false;
};
template <class Model>
struct Pipelined<Model, std::void_t<decltype(Model::kPipelined)>> {
  static constexpr bool value = Model::kPipelined;
};

// Floats of shared memory a thread of the pipelined walk keeps after the
// model's data: its checkpoint stack, kMaxDepth + 1 slots of x and r (the
// slot of leaf l is popc(l >> 1) <= kMaxDepth - 1; slot kMaxDepth takes an
// odd leaf's store, which no test reads).
template <class Model>
__host__ __device__ constexpr int thread_floats() {
  return Pipelined<Model>::value ? 2 * (kMaxDepth + 1) * Model::D : 0;
}

// Whether the sub-tree from checkpoint `slot` (element (slot, d) at
// ck[(slot D + d) kStride]) to the leaf (x1, r1) turns back on itself: with
// dx = direction (x1 - ck_x), either dot below zero; both dots computed, as
// independent values.
template <int D, int kStride>
__device__ __forceinline__ bool subtree_turns(const float* ck_x, const float* ck_r, int slot,
                                              const float* x1, const float* r1,
                                              const float* im, float direction) {
  float dx[D], cr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dx[d] = direction * (x1[d] - ck_x[(slot * D + d) * kStride]);
    cr[d] = ck_r[(slot * D + d) * kStride];
  }
  return (dot_im<D>(dx, im, cr) < 0.0f) | (dot_im<D>(dx, im, r1) < 0.0f);
}

// The doublings start_depth..stop_depth of one tree, one thread a tree,
// walked so that a leaf keeps its bookkeeping off the leapfrog's dependent
// chain; returns whether the tree stopped. The same trees as the walk of
// nuts_tree_body, every operation on the same operands, so the same bits:
// only the order in which independent work is issued changes.
//   - One loop over the leaves of every doubling of the stage; a
//     doubling's end, rare, is a branch inside it.
//   - The leaf's density from the model's data in registers
//     (Model::in_registers), every division by its fast path and one range
//     check (gaussian_model.cuh), evaluated again with `/` where the check
//     fails; the divisions' regions were the latency of a leaf.
//   - The U-turn test of the sub-tree an odd leaf closes, the checkpoint
//     store (an odd leaf's to a slot no test reads) and the multinomial pick
//     by predicates and selects, in every leaf; only a leaf that closes more
//     than one sub-tree (a quarter of them) branches to test the others.
//   - The checkpoint stack in shared memory after the model's data, element
//     (slot, d) of thread t at (slot D + d) kBlock + t, so the threads of a
//     warp touch 32 banks.
// On an H100 at one warp a scheduler the walk is bound by the instructions a
// warp issues: drawing the leaf's uniform a leaf ahead and issuing the next
// leaf's leapfrog before this leaf's stop decision added instructions and
// cost time (PERF.md: the levers' table), so neither is done.
template <class Model, int kBlock>
__device__ __forceinline__ bool pipelined_walk(
    const TreeArgs& a, const Model& model, const TreeDraws& draws, const float* im, float phi,
    float eps, float logu, float H0, float* stack_s, float* xm, float* rm, float* gm, float* xp,
    float* rp, float* gp, float* xs, float* rs, float& lps, float& n, float& alpha_sum,
    float& alpha_cnt, float& lf_cnt, float& depth_done) {
  constexpr int D = Model::D;
  constexpr int kStack = (kMaxDepth + 1) * D;
  static_assert(GroupWidth<Model>::value == 1, "the pipelined walk runs one thread a tree");
  float* const ck_x = stack_s + threadIdx.x;
  float* const ck_r = stack_s + kStack * kBlock + threadIdx.x;
  const auto m = model.in_registers();
  const bool data_ok = model.data_in_range();

  int depth = a.start_depth;
  bool back = !(draws.uniform(kDirection, depth, 0) < 0.5f);
  float direction = back ? -1.0f : 1.0f;
  float deps = direction * eps;
  float half = 0.5f * deps;
  // The state the next leaf's leapfrog starts from, then the leaf itself.
  float x1[D], r1[D], g1[D], xpr[D], rpr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x1[d] = back ? xm[d] : xp[d];
    r1[d] = back ? rm[d] : rp[d];
    g1[d] = back ? gm[d] : gp[d];
    xpr[d] = x1[d];
    rpr[d] = r1[d];
  }
  float lppr = lps, nsub = 0.0f;
  int leaf = 0;
  for (;;) {
    const bool last = leaf == (1 << depth) - 1;
    // This leaf's leapfrog; its density again with `/` where the fast
    // divisions' check failed.
    float r_half[D];
#pragma unroll
    for (int d = 0; d < D; ++d) r_half[d] = r1[d] + half * g1[d];
#pragma unroll
    for (int d = 0; d < D; ++d) x1[d] = x1[d] + (deps * im[d]) * r_half[d];
    bool in_range = data_ok;
    float lp1 = m.logp_grad(x1, phi, g1, in_range);
    if (!in_range) lp1 = model.logp_grad(x1, phi, g1);
#pragma unroll
    for (int d = 0; d < D; ++d) r1[d] = r_half[d] + half * g1[d];

    // The bookkeeping of this leaf.
    const float joint = lp1 - kinetic<D>(im, r1);
    const bool ok = isfinite(joint);
    const bool valid = ok & (logu < joint);
    const bool div = !ok | ((logu - kDivergence) >= joint);
    nsub = nsub + (valid ? 1.0f : 0.0f);
    const bool take = valid & (draws.uniform(kLeaf, depth, leaf) * nsub < 1.0f);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xpr[d] = take ? x1[d] : xpr[d];
      rpr[d] = take ? r1[d] : rpr[d];
    }
    lppr = take ? lp1 : lppr;
    const float ratio = expf(joint - H0);
    alpha_sum = alpha_sum + (ok ? (ratio > 1.0f ? 1.0f : ratio) : 0.0f);  // NaN stays NaN
    alpha_cnt = alpha_cnt + 1.0f;
    lf_cnt = lf_cnt + 1.0f;

    // Checkpoints: even leaves store the left end of the sub-trees they
    // open, odd leaves test every sub-tree they close.
    const int idx_max = __popc(leaf >> 1);
    const bool odd = leaf & 1;
    const int put = odd ? kMaxDepth : idx_max;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ck_x[(put * D + d) * kBlock] = x1[d];
      ck_r[(put * D + d) * kBlock] = r1[d];
    }
    bool turned = odd & subtree_turns<D, kBlock>(ck_x, ck_r, idx_max, x1, r1, im, direction);
    const int closes = __ffs(~leaf) - 1;  // sub-trees this leaf closes
    if (closes > 1) {
      for (int slot = idx_max - closes + 1; slot < idx_max; ++slot) {
        turned = turned | subtree_turns<D, kBlock>(ck_x, ck_r, slot, x1, r1, im, direction);
      }
    }
    const bool sstop = div | turned;

    if (sstop | last) {
      // The doubling's end.
      if (back) {
        copy<D>(xm, x1); copy<D>(rm, r1); copy<D>(gm, g1);
      } else {
        copy<D>(xp, x1); copy<D>(rp, r1); copy<D>(gp, g1);
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
      if (sstop || dot_im<D>(dx, im, rm) < 0.0f || dot_im<D>(dx, im, rp) < 0.0f) return true;
      if (depth == a.stop_depth) return false;
      // The next doubling, from the end it grows.
      depth = depth + 1;
      leaf = 0;
      back = !(draws.uniform(kDirection, depth, 0) < 0.5f);
      direction = back ? -1.0f : 1.0f;
      deps = direction * eps;
      half = 0.5f * deps;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        x1[d] = back ? xm[d] : xp[d];
        r1[d] = back ? rm[d] : rp[d];
        g1[d] = back ? gm[d] : gp[d];
        xpr[d] = x1[d];
        rpr[d] = r1[d];
      }
      lppr = lps;
      nsub = 0.0f;
    } else {
      leaf = leaf + 1;
    }
  }
}

// kCont = false: the first stage, group t is particle t and runs the prologue.
// kCont = true: a continuation stage, group t takes slot t of cont_in.
// A group is one thread at W = 1, and then t is the thread's index.
template <class Model, bool kCont, int kBlock>
__device__ __forceinline__ void nuts_tree_body(const TreeArgs a) {
  constexpr int D = Model::D;
  constexpr int W = GroupWidth<Model>::value;
  static_assert(W >= 1 && W <= 32 && 32 % W == 0 && kBlock % 32 == 0, "group width");
  constexpr bool kShared = W > 1;  // the stack and the carriers in shared memory
  const int P = a.total;
  int n_lanes = P;
  if constexpr (kCont) {
    n_lanes = *a.n_in;
    if (static_cast<int>(blockIdx.x * blockDim.x / W) >= n_lanes) return;  // no lane for this block
  }
  extern __shared__ float data_s[];
  for (int t = threadIdx.x; t < a.n_data; t += blockDim.x) data_s[t] = a.data[t];
  __syncthreads();

  const int t = (blockIdx.x * blockDim.x + threadIdx.x) / W;
  const int lane = group_lane<W>();
  if (t >= n_lanes) return;  // padding threads, whole groups
  int p = t;
  if constexpr (kCont) p = __float_as_int(a.cont_in[t]);
  const int run = p / a.n_per_run;
  const Model model(data_s, a.n_data, a.scalars);
  const float phi = a.phi[run];
  const float eps = a.eps[run];
  float im[D];
#pragma unroll
  for (int d = 0; d < D; ++d) im[d] = a.inv_mass[run * D + d];
  const TreeDraws draws{static_cast<uint32_t>(a.seed[run]),
                        static_cast<uint32_t>(a.p_offset + a.p_stride * (p - run * a.n_per_run)),
                        a.zero_bits};

  // The group's shared memory; every lane of the group stores the same
  // values there, and a __syncwarp after each batch of stores orders them
  // before the group's next reads.
  float* const group_s = data_s + a.n_data + (threadIdx.x / W) * group_floats<Model>();
  constexpr int kC = kShared ? 1 : D;
  float xm_r[kC], rm_r[kC], gm_r[kC], xp_r[kC], rp_r[kC], gp_r[kC], xs_r[kC], rs_r[kC];
  float* const carriers_s = group_s + 2 * (kMaxDepth + 1) * D;
  float* const xm = kShared ? carriers_s + 0 * D : xm_r;
  float* const rm = kShared ? carriers_s + 1 * D : rm_r;
  float* const gm = kShared ? carriers_s + 2 * D : gm_r;
  float* const xp = kShared ? carriers_s + 3 * D : xp_r;
  float* const rp = kShared ? carriers_s + 4 * D : rp_r;
  float* const gp = kShared ? carriers_s + 5 * D : gp_r;
  float* const xs = kShared ? carriers_s + 6 * D : xs_r;
  float* const rs = kShared ? carriers_s + 7 * D : rs_r;
  float lps, n, logu, H0, logp0, ke0, alpha_sum, alpha_cnt, lf_cnt, depth_done;
  if constexpr (kCont) {
    const float* c = a.cont_in;
    load_rows<D>(xm, c, 1 + 0 * D, P, t); load_rows<D>(rm, c, 1 + 1 * D, P, t);
    load_rows<D>(gm, c, 1 + 2 * D, P, t); load_rows<D>(xp, c, 1 + 3 * D, P, t);
    load_rows<D>(rp, c, 1 + 4 * D, P, t); load_rows<D>(gp, c, 1 + 5 * D, P, t);
    load_rows<D>(xs, c, 1 + 6 * D, P, t); load_rows<D>(rs, c, 1 + 7 * D, P, t);
    const float* sc = c + (1 + 8 * D) * P + t;
    lps = sc[0 * P]; n = sc[1 * P]; logu = sc[2 * P]; H0 = sc[3 * P]; logp0 = sc[4 * P];
    ke0 = sc[5 * P]; alpha_sum = sc[6 * P]; alpha_cnt = sc[7 * P]; lf_cnt = sc[8 * P];
    depth_done = sc[9 * P];
  } else {
    // Prologue: momenta, start energy, slice variable.
    float x0[D], r0[D], g0[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x0[d] = a.x[p * D + d];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      r0[d] = a.r != nullptr ? a.r[p * D + d] : start_momentum(draws, im[d], d);
    }
    logp0 = model.logp_grad(x0, phi, g0);
    ke0 = kinetic<D>(im, r0);
    H0 = logp0 - ke0;
    logu = H0 - (-logf(draws.uniform(kPrologue, 0, 2 * D)));
    copy<D>(xm, x0); copy<D>(rm, r0); copy<D>(gm, g0);
    copy<D>(xp, x0); copy<D>(rp, r0); copy<D>(gp, g0);
    copy<D>(xs, x0); copy<D>(rs, r0);
    lps = logp0; n = 1.0f;
    alpha_sum = 0.0f; alpha_cnt = 0.0f; lf_cnt = 0.0f; depth_done = 0.0f;
  }
  if constexpr (kShared) __syncwarp(group_mask<W>());
  constexpr int kStack = (kMaxDepth + 1) * D;
  float ck_xl[kShared ? 1 : kStack], ck_rl[kShared ? 1 : kStack];
  float* const ck_x = kShared ? group_s : ck_xl;
  float* const ck_r = kShared ? group_s + kStack : ck_rl;

  bool stopped = false;
  if constexpr (Pipelined<Model>::value) {
    stopped = pipelined_walk<Model, kBlock>(a, model, draws, im, phi, eps, logu, H0,
                                            data_s + a.n_data, xm, rm, gm, xp, rp, gp, xs, rs,
                                            lps, n, alpha_sum, alpha_cnt, lf_cnt, depth_done);
  } else {
    for (int depth = a.start_depth; depth <= a.stop_depth; ++depth) {
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
          if constexpr (kShared) __syncwarp(group_mask<W>());
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
      if constexpr (kShared) __syncwarp(group_mask<W>());

      float dx[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dx[d] = xp[d] - xm[d];
      if (sstop || dot_im<D>(dx, im, rm) < 0.0f || dot_im<D>(dx, im, rp) < 0.0f) {
        stopped = true;
        break;
      }
    }
  }

  if (!stopped && a.stop_depth < a.max_depth) {
    // The tree goes on: hand the carriers to the next stage.
    int slot;
    if constexpr (W == 1) {
      slot = reserve_slot(a.n_out);
    } else {
      slot = reserve_group_slot<W>(a.n_out);
    }
    if (lane != 0) return;
    float* c = a.cont_out;
    c[slot] = __int_as_float(p);
    store_rows<D>(c, xm, 1 + 0 * D, P, slot); store_rows<D>(c, rm, 1 + 1 * D, P, slot);
    store_rows<D>(c, gm, 1 + 2 * D, P, slot); store_rows<D>(c, xp, 1 + 3 * D, P, slot);
    store_rows<D>(c, rp, 1 + 4 * D, P, slot); store_rows<D>(c, gp, 1 + 5 * D, P, slot);
    store_rows<D>(c, xs, 1 + 6 * D, P, slot); store_rows<D>(c, rs, 1 + 7 * D, P, slot);
    float* sc = c + (1 + 8 * D) * P + slot;
    sc[0 * P] = lps; sc[1 * P] = n; sc[2 * P] = logu; sc[3 * P] = H0; sc[4 * P] = logp0;
    sc[5 * P] = ke0; sc[6 * P] = alpha_sum; sc[7 * P] = alpha_cnt; sc[8 * P] = lf_cnt;
    sc[9 * P] = depth_done;
    return;
  }

  // Epilogue, once a lane, in the stage where its tree ends. delta_h is the
  // value before the accept-reject, moved the one after it.
  const float dh = (lps - kinetic<D>(im, rs)) - H0;
  bool keep = true;
  if (a.acc_rej) {
    // u <= min(1, exp(dh)) as u <= exp(min(dh, 0)); a NaN dh stays NaN and rejects.
    keep = draws.uniform(kAccRej, 0, 0) <= expf(dh > 0.0f ? 0.0f : dh);
    if (!keep) lps = logp0;
  }
  if (lane != 0) return;  // lane 0 writes the group's outputs
  float moved = 1.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x0 = a.x[p * D + d];
    float xo = xs[d], ro = rs[d];
    if (!keep) {
      xo = x0;
      ro = a.r != nullptr ? a.r[p * D + d] : start_momentum(draws, im[d], d);
    }
    moved = moved * (xo != x0 ? 1.0f : 0.0f);
    a.x_out[p * D + d] = xo;
    a.r_out[p * D + d] = ro;
  }
  const float astat = alpha_sum / (alpha_cnt > 1.0f ? alpha_cnt : 1.0f);
  a.stats[0 * P + p] = logp0;
  a.stats[1 * P + p] = lps;
  a.stats[2 * P + p] = astat;
  a.stats[3 * P + p] = depth_done;
  a.stats[4 * P + p] = lf_cnt + 1.0f;
  a.stats[5 * P + p] = dh;
  a.stats[6 * P + p] = ke0;
  a.stats[7 * P + p] = moved;
}

template <class Model, bool kCont, int kBlock>
__global__ void __launch_bounds__(kBlock) nuts_tree_kernel(const TreeArgs a) {
  nuts_tree_body<Model, kCont, kBlock>(a);
}

// The same kernel for a model that names a register cap: ptxas is held to
// it by the blocks an SM must hold at once.
template <class Model, bool kCont, int kBlock>
__global__ void __launch_bounds__(kBlock, (MinBlocks<Model, kBlock>::value))
    nuts_tree_kernel_capped(const TreeArgs a) {
  nuts_tree_body<Model, kCont, kBlock>(a);
}

// The kernel of a model and stage.
template <class Model, bool kCont, int kBlock>
constexpr auto tree_kernel() {
  if constexpr (MinBlocks<Model, kBlock>::value > 0) {
    return nuts_tree_kernel_capped<Model, kCont, kBlock>;
  } else {
    return nuts_tree_kernel<Model, kCont, kBlock>;
  }
}

// Dynamic shared memory of a block: the model's data, then each group's, or
// each thread's stack of the pipelined walk.
template <class Model, int kBlock>
size_t block_smem(int n_data) {
  return static_cast<size_t>(n_data + kBlock / GroupWidth<Model>::value * group_floats<Model>() +
                             kBlock * thread_floats<Model>()) *
         sizeof(float);
}

// Blocks of the first-stage kernel that one SM holds at once with n_data
// floats of model data (the occupancy calculator's answer), or -1 on error.
template <class Model, int kBlock = kThreads>
int blocks_per_sm(int n_data) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, tree_kernel<Model, false, kBlock>(), kBlock, block_smem<Model, kBlock>(n_data));
  return err == cudaSuccess ? n : -1;
}

template <class Model, int kBlock = kThreads>
int launch(const float* x, const float* r, const float* data, int n_data, const float* scalars,
           int n_scalars, const int32_t* seed, const float* phi, const float* eps,
           const float* inv_mass, int n_runs, int n_per_run, int p_offset, int p_stride,
           int max_depth, int zero_bits, int acc_rej, int start_depth, int stop_depth,
           const float* cont_in, const int* n_in, float* cont_out, int* n_out, float* x_out,
           float* r_out, float* stats, void* stream) {
  const bool cont = cont_in != nullptr;
  const bool last = stop_depth == max_depth;
  if (max_depth < 0 || max_depth > kMaxDepth || n_runs < 1 || n_per_run < 1 ||
      p_offset < 0 || p_stride < 1 || p_offset >= p_stride ||
      n_scalars < 0 || n_scalars > kMaxScalars || !Model::accepts(n_data, n_scalars) ||
      start_depth < 0 || start_depth > stop_depth || stop_depth > max_depth ||
      cont != (start_depth > 0) || cont != (n_in != nullptr) ||
      last != (cont_out == nullptr) || last != (n_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ModelScalars s{};
  for (int i = 0; i < n_scalars; ++i) s.v[i] = scalars[i];
  const TreeArgs args{x, r, data, n_data, s, seed, phi, eps, inv_mass, n_per_run,
                      p_offset, p_stride, n_runs * n_per_run, max_depth, zero_bits != 0,
                      acc_rej != 0, start_depth, stop_depth, cont_in, n_in, cont_out, n_out,
                      x_out, r_out, stats};
  // A continuation stage is launched over every lane too: the count of its
  // lanes stays on the device.
  constexpr int W = GroupWidth<Model>::value;
  const int blocks = (args.total * W + kBlock - 1) / kBlock;
  const size_t smem = block_smem<Model, kBlock>(n_data);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cont) {
    const auto kernel = tree_kernel<Model, true, kBlock>();
    kernel<<<blocks, kBlock, smem, st>>>(args);
  } else {
    const auto kernel = tree_kernel<Model, false, kBlock>();
    kernel<<<blocks, kBlock, smem, st>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace smcnuts

// Each entry launches one stage of one tree per particle on `stream`
// (doublings start_depth..stop_depth; the whole tree for 0..max_depth) and
// returns cudaGetLastError(). It does not synchronise and allocates nothing:
// the caller owns every buffer. `scalars` is a host array of n_scalars
// floats. A stage with start_depth > 0 reads its lanes from cont_in / n_in; a
// stage with stop_depth < max_depth fills cont_out / n_out (n_out zeroed by
// the caller); the pointers a stage does not use are null. Local particle j
// of a run draws as global particle p_offset + p_stride j (0 and 1 unsharded;
// a shard's rank and rank count, parallel/sharding.py).
// SMCNUTS_ENTRY(NAME, MODEL) launches blocks of kThreads threads,
// SMCNUTS_ENTRY(NAME, MODEL, THREADS) blocks of THREADS.
#define SMCNUTS_ENTRY(NAME, ...)                                                                \
  int NAME(const float* x, const float* r, const float* data, int n_data, const float* scalars, \
           int n_scalars, const int32_t* seed, const float* phi, const float* eps,              \
           const float* inv_mass, int n_runs, int n_per_run, int p_offset, int p_stride,        \
           int max_depth, int zero_bits, int acc_rej, int start_depth, int stop_depth,          \
           const float* cont_in, const int* n_in, float* cont_out, int* n_out, float* x_out,    \
           float* r_out, float* stats, void* stream) {                                          \
    return smcnuts::launch<__VA_ARGS__>(x, r, data, n_data, scalars, n_scalars, seed, phi,    \
                                        eps, inv_mass, n_runs, n_per_run, p_offset, p_stride, \
                                        max_depth, zero_bits, acc_rej, start_depth,           \
                                        stop_depth, cont_in, n_in, cont_out, n_out, x_out,    \
                                        r_out, stats, stream);                                \
  }
