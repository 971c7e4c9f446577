// The adaptive Dormand-Prince solve and its continuous adjoint, one thread a
// lane, one launch a solve (smcnuts_torch/ops/ode.py: `dopri5`,
// `dopri5_adjoint`).
//
// Replaces no TPU kernel: the JAX package solves an ODE in XLA (the Stan
// frontend lowers every adaptive interface to `jax.experimental.ode.odeint`,
// smcnuts_tpu/stan/compiler.py:1031), one compiled `while_loop` under jit and
// vmap. This is its counterpart on the card: before it the port stepped the
// solve from the host, a host check and ~10 launches a step
// (`solve_batched`, which stays as the plain version).
//
// What it computes: `ops/ode.solve_batched` and `ops/ode._adjoint` for one
// lane, op for op in their order, so the kernel and its plain version on the
// card agree to the bit: JAX's controller (`_initial_step_size`,
// `_runge_kutta_step` with `_dot`'s stage order and its zero coefficients
// skipped, `_mean_error_ratio` with `_sumsq` in index order,
// `_optimal_step_size`, `_interp_fit`, `_polyval`), the same stopping rule
// (t < target, i < mxstep, dt > 0), every scalar of a tensor op rounded to R
// first as ATen rounds it, torch.maximum / minimum / clamp with ATen's NaN
// rules, and `0.01 / x` as torch computes it (reciprocal, then the product).
// A generated NUTS model whose density solves an ODE (`ops/generated.py`)
// inlines `forward_lane` and `adjoint_lane`, so the solve runs inside the
// NUTS kernel's leapfrog, in the particle's thread.
// The right-hand side F is generated code (`ops/ode.OdeProgram`): a struct
// with `Real`, `N` (the state), `A` (the argument scalars), `f(y, t, a,
// out)` and `vjp(y, t, a, ybar, out)`, out = (f, ybar df/dy, ybar df/dt,
// ybar df/da), inlined here; the build is one library a program
// (`ops/ode.build_ode`), with -fmad=false as every kernel of the port.
//
// What bounds it on an H100: the dependent chain of one lane's steps (six
// right-hand sides, a division and a sqrt a component, a pow a step), not
// the card's rate: a lane is one thread and its steps follow one another.
// The lanes run side by side, each to its own step count (a warp's lanes
// that finish early wait for its last one: measured, not optimised). The
// state, the stages and the interpolant live in local memory (L1).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace smcnuts {
namespace ode {

constexpr int kOdeBlock = 64;

// The Dormand-Prince tableau of ops/ode.py (_ALPHA, _BETA, _C_SOL, _C_ERROR,
// _DPS_C_MID) as Python computes its doubles, bit for bit (hex literals; a
// CPU test reads them back). A scalar of a tensor op is rounded to R.
constexpr double kAlpha1 = 0x1.999999999999ap-3;   // 1/5
constexpr double kAlpha2 = 0x1.3333333333333p-2;   // 3/10
constexpr double kAlpha3 = 0x1.999999999999ap-1;   // 4/5
constexpr double kAlpha4 = 0x1.c71c71c71c71cp-1;   // 8/9
constexpr double kAlpha5 = 0x1.0000000000000p+0;   // 1
constexpr double kAlpha6 = 0x1.0000000000000p+0;   // 1
constexpr double kBeta10 = 0x1.999999999999ap-3;   // 1/5
constexpr double kBeta20 = 0x1.3333333333333p-4;   // 3/40
constexpr double kBeta21 = 0x1.ccccccccccccdp-3;   // 9/40
constexpr double kBeta30 = 0x1.f49f49f49f49fp-1;   // 44/45
constexpr double kBeta31 = -0x1.ddddddddddddep+1;  // -56/15
constexpr double kBeta32 = 0x1.c71c71c71c71cp+1;   // 32/9
constexpr double kBeta40 = 0x1.79eec0fc37181p+1;   // 19372/6561
constexpr double kBeta41 = -0x1.7310bd29520e4p+3;  // -25360/2187
constexpr double kBeta42 = 0x1.3a552363c5290p+3;   // 64448/6561
constexpr double kBeta43 = -0x1.29c9eba1e3345p-2;  // -212/729
constexpr double kBeta50 = 0x1.6c52bf5a814b0p+1;   // 9017/3168
constexpr double kBeta51 = -0x1.583e0f83e0f84p+3;  // -355/33
constexpr double kBeta52 = 0x1.1d016a3721e8bp+3;   // 46732/5247
constexpr double kBeta53 = 0x1.1d1745d1745d1p-2;   // 49/176
constexpr double kBeta54 = -0x1.1818970d9cc2fp-2;  // -5103/18656
constexpr double kBeta60 = 0x1.7555555555555p-4;   // 35/384 (kBeta61 = 0)
constexpr double kBeta62 = 0x1.cc0499a5605fbp-2;   // 500/1113
constexpr double kBeta63 = 0x1.4d55555555555p-1;   // 125/192
constexpr double kBeta64 = -0x1.4a1cfb2b78c13p-2;  // -2187/6784
constexpr double kBeta65 = 0x1.0c30c30c30c31p-3;   // 11/84
// _C_SOL is _BETA's last row (its stages 1 and 6 zero).
constexpr double kErr0 = 0x1.aed6a9264e200p-11;    // 35/384 - 1951/21600
constexpr double kErr2 = -0x1.739cdc6b8ff80p-9;    // 500/1113 - 22642/50085
constexpr double kErr3 = 0x1.93e93e93e93e0p-6;     // 125/192 - 451/720
constexpr double kErr4 = -0x1.15c8be1dc1038p-5;    // -2187/6784 + 12231/42400
constexpr double kErr5 = 0x1.c9b634fce9684p-6;     // 11/84 - 649/6300
constexpr double kErr6 = -0x1.1111111111111p-6;    // -1/60
constexpr double kMid0 = 0x1.9a26718950a65p-4;     // 6025192743/30085553152/2
constexpr double kMid2 = 0x1.913c74707d7c1p-2;     // 51252292925/65400821598/2
constexpr double kMid3 = -0x1.e8a5724cdcb67p-6;    // -2691868925/45128329728/2
constexpr double kMid4 = 0x1.e2c6cb78001fcp-5;     // 187940372067/1594534317056/2
constexpr double kMid5 = -0x1.707790ab91368p-5;    // -1776094331/19743644256/2
constexpr double kMid6 = 0x1.87a5ef86e489cp-6;     // 11237099/235043384/2

// The math of R as ATen's CUDA kernels compute it.
__device__ __forceinline__ float r_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double r_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float r_pow(float x, float e) { return powf(x, e); }
__device__ __forceinline__ double r_pow(double x, double e) { return pow(x, e); }
__device__ __forceinline__ float r_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double r_abs(double x) { return fabs(x); }
__device__ __forceinline__ float r_fmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double r_fmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float r_fmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double r_fmin(double a, double b) { return fmin(a, b); }

// torch.maximum / torch.minimum: a NaN operand is the result.
template <class R>
__device__ __forceinline__ R maximum(R a, R b) {
  return a != a ? a : (b != b ? b : r_fmax(a, b));
}
template <class R>
__device__ __forceinline__ R minimum(R a, R b) {
  return a != a ? a : (b != b ? b : r_fmin(a, b));
}
// torch.clamp(v, min=0.0).
template <class R>
__device__ __forceinline__ R clamp_min0(R v) {
  return v != v ? v : r_fmax(v, R(0));
}

// sum_j v_j^2 in index order (`_sumsq`), v_j = num[j] / den[j].
template <class R, int M>
__device__ __forceinline__ R sumsq_ratio(const R* num, const R* den) {
  R q = num[0] / den[0];
  R acc = q * q;
#pragma unroll
  for (int j = 1; j < M; ++j) {
    q = num[j] / den[j];
    acc = acc + q * q;
  }
  return acc;
}

// `_initial_step_size` (order 4): Hairer, Norsett and Wanner's rule.
template <class R, int M, class Dyn>
__device__ R initial_step_size(const Dyn& dyn, R t0, const R* y0, R rtol, R atol,
                               const R* f0) {
  R scale[M], y1[M], f1[M], df[M];
#pragma unroll
  for (int j = 0; j < M; ++j) scale[j] = r_abs(y0[j]) * rtol + atol;
  const R d0 = r_sqrt(sumsq_ratio<R, M>(y0, scale));
  const R d1 = r_sqrt(sumsq_ratio<R, M>(f0, scale));
  const R h0 = (d0 < R(1e-5)) | (d1 < R(1e-5)) ? R(1e-6) : d0 * R(0.01) / d1;
#pragma unroll
  for (int j = 0; j < M; ++j) y1[j] = y0[j] + h0 * f0[j];
  dyn(y1, t0 + h0, f1);
#pragma unroll
  for (int j = 0; j < M; ++j) df[j] = f1[j] - f0[j];
  const R d2 = r_sqrt(sumsq_ratio<R, M>(df, scale)) / h0;
  const R h1 = (d1 <= R(1e-15)) & (d2 <= R(1e-15))
                   ? maximum(R(1e-6), h0 * R(1e-3))
                   : r_pow(R(1) / maximum(d1, d2) * R(0.01), R(1.0 / 5.0));
  return minimum(h0 * R(100), h1);
}

// One step (`_runge_kutta_step`): the stages k[1..6] (k[0] = f(y0, t0) given),
// the 5th-order solution y1 and its error estimate.
template <class R, int M, class Dyn>
__device__ void runge_kutta_step(const Dyn& dyn, const R* y0, R t0, R dt, R (*k)[M],
                                 R* y1, R* err) {
  R yi[M];
#pragma unroll
  for (int j = 0; j < M; ++j) yi[j] = y0[j] + dt * (R(kBeta10) * k[0][j]);
  dyn(yi, t0 + dt * R(kAlpha1), k[1]);
#pragma unroll
  for (int j = 0; j < M; ++j)
    yi[j] = y0[j] + dt * (R(kBeta20) * k[0][j] + R(kBeta21) * k[1][j]);
  dyn(yi, t0 + dt * R(kAlpha2), k[2]);
#pragma unroll
  for (int j = 0; j < M; ++j)
    yi[j] = y0[j] + dt * (R(kBeta30) * k[0][j] + R(kBeta31) * k[1][j] + R(kBeta32) * k[2][j]);
  dyn(yi, t0 + dt * R(kAlpha3), k[3]);
#pragma unroll
  for (int j = 0; j < M; ++j)
    yi[j] = y0[j] + dt * (R(kBeta40) * k[0][j] + R(kBeta41) * k[1][j] + R(kBeta42) * k[2][j] +
                          R(kBeta43) * k[3][j]);
  dyn(yi, t0 + dt * R(kAlpha4), k[4]);
#pragma unroll
  for (int j = 0; j < M; ++j)
    yi[j] = y0[j] + dt * (R(kBeta50) * k[0][j] + R(kBeta51) * k[1][j] + R(kBeta52) * k[2][j] +
                          R(kBeta53) * k[3][j] + R(kBeta54) * k[4][j]);
  dyn(yi, t0 + dt * R(kAlpha5), k[5]);
#pragma unroll
  for (int j = 0; j < M; ++j)
    yi[j] = y0[j] + dt * (R(kBeta60) * k[0][j] + R(kBeta62) * k[2][j] + R(kBeta63) * k[3][j] +
                          R(kBeta64) * k[4][j] + R(kBeta65) * k[5][j]);
  dyn(yi, t0 + dt * R(kAlpha6), k[6]);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    y1[j] = dt * (R(kBeta60) * k[0][j] + R(kBeta62) * k[2][j] + R(kBeta63) * k[3][j] +
                  R(kBeta64) * k[4][j] + R(kBeta65) * k[5][j]) + y0[j];
    err[j] = dt * (R(kErr0) * k[0][j] + R(kErr2) * k[2][j] + R(kErr3) * k[3][j] +
                   R(kErr4) * k[4][j] + R(kErr5) * k[5][j] + R(kErr6) * k[6][j]);
  }
}

// `_mean_error_ratio`: the root mean square of err / (atol + rtol max|y|).
template <class R, int M>
__device__ __forceinline__ R mean_error_ratio(const R* err, R rtol, R atol, const R* y0,
                                              const R* y1) {
  R tol[M];
#pragma unroll
  for (int j = 0; j < M; ++j) tol[j] = maximum(r_abs(y0[j]), r_abs(y1[j])) * rtol + atol;
  return r_sqrt(sumsq_ratio<R, M>(err, tol) * R(1.0 / M));
}

// `_optimal_step_size`: safety 0.9, ifactor 10, dfactor 0.2, order 5.
template <class R>
__device__ __forceinline__ R optimal_step_size(R last_step, R ratio) {
  const R dfactor = ratio < R(1) ? R(1) : R(0.2);
  const R factor = minimum(R(10), maximum(r_pow(ratio, R(-1.0 / 5.0)) * R(0.9), dfactor));
  return ratio == R(0) ? last_step * R(10) : last_step * factor;
}

// `_interp_fit`: the step's 4th-order polynomial (a, b, c, d, y0).
template <class R, int M>
__device__ __forceinline__ void interp_fit(const R* y0, const R* y1, R (*k)[M], R dt,
                                           R (*p)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const R ym = y0[j] + dt * (R(kMid0) * k[0][j] + R(kMid2) * k[2][j] + R(kMid3) * k[3][j] +
                               R(kMid4) * k[4][j] + R(kMid5) * k[5][j] + R(kMid6) * k[6][j]);
    const R dy0 = k[0][j], dy1 = k[6][j];
    p[0][j] = dt * R(-2) * dy0 + dt * R(2) * dy1 - y0[j] * R(8) - y1[j] * R(8) + ym * R(16);
    p[1][j] = dt * R(5) * dy0 - dt * R(3) * dy1 + y0[j] * R(18) + y1[j] * R(14) - ym * R(32);
    p[2][j] = dt * R(-4) * dy0 + dt * dy1 - y0[j] * R(11) - y1[j] * R(5) + ym * R(16);
    p[3][j] = dt * dy0;
    p[4][j] = y0[j];
  }
}

// One lane's solve from (y, t0) to each target in turn (`solve_batched`):
// out[q] is the state at targets[q], the step's polynomial at its point.
// Returns the steps taken, accepted and rejected.
template <class R, int M, class Dyn>
__device__ int solve(const Dyn& dyn, const R* y_start, R t0, const R* targets, int n_targets,
                     R* out, R rtol, R atol, long long mxstep) {
  R y[M], f[M], y1[M], err[M], k[7][M], p[5][M];
#pragma unroll
  for (int j = 0; j < M; ++j) y[j] = y_start[j];
  dyn(y, t0, f);
  R dt = clamp_min0(initial_step_size<R, M>(dyn, t0, y, rtol, atol, f));
  R t = t0, last_t = t0;
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int c = 0; c < 5; ++c) p[c][j] = y[j];
  int steps = 0;
  for (int q = 0; q < n_targets; ++q) {
    const R target = targets[q];
    for (long long i = 0; (t < target) & (i < mxstep) & (dt > R(0)); ++i) {
      ++steps;
#pragma unroll
      for (int j = 0; j < M; ++j) k[0][j] = f[j];
      runge_kutta_step<R, M>(dyn, y, t, dt, k, y1, err);
      const R ratio = mean_error_ratio<R, M>(err, rtol, atol, y, y1);
      const R new_dt = clamp_min0(optimal_step_size(dt, ratio));
      if (ratio <= R(1)) {
        interp_fit<R, M>(y, y1, k, dt, p);
#pragma unroll
        for (int j = 0; j < M; ++j) {
          y[j] = y1[j];
          f[j] = k[6][j];
        }
        last_t = t;
        t = t + dt;
      }
      dt = new_dt;
    }
    const R s = (target - last_t) / (t - last_t);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      R v = p[0][j];
#pragma unroll
      for (int c = 1; c < 5; ++c) v = v * s + p[c][j];
      out[q * M + j] = v;
    }
  }
  return steps;
}

// The forward dynamics: F's right-hand side at the lane's arguments.
template <class F>
struct Forward {
  using R = typename F::Real;
  const R* a;
  __device__ __forceinline__ void operator()(const R* y, R t, R* out) const {
    F::f(y, t, a, out);
  }
};

// The adjoint's augmented dynamics (`_adjoint`'s aug_dynamics): the state
// (y, ybar, t0bar, abar) at negated time s, its derivative (-f, ybar df/dy,
// ybar df/dt, ybar df/da) at (y, -s).
template <class F>
struct Augmented {
  using R = typename F::Real;
  static constexpr int M = 2 * F::N + 1 + F::A;
  const R* a;
  __device__ __forceinline__ void operator()(const R* state, R s, R* out) const {
    F::vjp(state, -s, a, state + F::N, out);
#pragma unroll
    for (int j = 0; j < F::N; ++j) out[j] = -out[j];
  }
};

// One lane's solve (`solve_batched` for one lane): y0 (N), ts (T), a (A) ->
// ys (T, N), row 0 y0. Returns the RK steps. The kernel below runs it a
// thread a lane; a generated NUTS model (ops/generated.py) inlines it, one
// call a solve of its density.
template <class F>
__device__ __forceinline__ int forward_lane(const typename F::Real* y0,
                                            const typename F::Real* ts,
                                            const typename F::Real* a, typename F::Real* ys,
                                            int T, double rtol, double atol, long long mxstep) {
  using R = typename F::Real;
  constexpr int N = F::N;
#pragma unroll
  for (int j = 0; j < N; ++j) ys[j] = y0[j];
  const Forward<F> dyn{a};
  return solve<R, N>(dyn, y0, ts[0], ts + 1, T - 1, ys + N, R(rtol), R(atol), mxstep);
}

// One lane's adjoint (`_adjoint` for one lane): ys (T, N), ts (T), g (T, N),
// a (A) -> y0_bar (N), ts_bar (T), a_bar (A), the augmented state solved
// backwards between output times, one solve an interval. Returns the RK
// steps of all intervals.
template <class F>
__device__ __forceinline__ int adjoint_lane(const typename F::Real* y,
                                            const typename F::Real* t,
                                            const typename F::Real* gl,
                                            const typename F::Real* al,
                                            typename F::Real* y0_bar, typename F::Real* tb,
                                            typename F::Real* a_bar, int T, double rtol,
                                            double atol, long long mxstep) {
  using R = typename F::Real;
  constexpr int N = F::N, A = F::A, M = Augmented<F>::M;
  const Augmented<F> aug{al};
  R state[M], next[M], fi[N];
#pragma unroll
  for (int j = 0; j < N; ++j) state[N + j] = gl[(T - 1) * N + j];
  R t0bar = R(0);
#pragma unroll
  for (int c = 0; c < A; ++c) state[2 * N + 1 + c] = R(0);
  int count = 0;
  for (int i = T - 1; i >= 1; --i) {
    F::f(y + i * N, t[i], al, fi);
    R tbar = fi[0] * gl[i * N];
#pragma unroll
    for (int j = 1; j < N; ++j) tbar = tbar + fi[j] * gl[i * N + j];
    t0bar = t0bar - tbar;
#pragma unroll
    for (int j = 0; j < N; ++j) state[j] = y[i * N + j];
    state[2 * N] = t0bar;
    const R back = -t[i - 1];
    count += solve<R, M>(aug, state, -t[i], &back, 1, next, R(rtol), R(atol), mxstep);
#pragma unroll
    for (int j = 0; j < N; ++j) state[N + j] = next[N + j] + gl[(i - 1) * N + j];
    t0bar = next[2 * N];
#pragma unroll
    for (int c = 0; c < A; ++c) state[2 * N + 1 + c] = next[2 * N + 1 + c];
    tb[i] = tbar;
  }
  tb[0] = t0bar;
#pragma unroll
  for (int j = 0; j < N; ++j) y0_bar[j] = state[N + j];
#pragma unroll
  for (int c = 0; c < A; ++c) a_bar[c] = state[2 * N + 1 + c];
  return count;
}

// y0 (B, N), ts (B, T), a (B, A) -> ys (B, T, N), row 0 y0; steps (B,).
template <class F>
__global__ void __launch_bounds__(kOdeBlock)
dopri5_forward(const typename F::Real* y0, const typename F::Real* ts,
               const typename F::Real* a, typename F::Real* ys, int* steps, int B, int T,
               double rtol, double atol, long long mxstep) {
  constexpr int N = F::N;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  steps[lane] = forward_lane<F>(y0 + static_cast<long long>(lane) * N,
                                ts + static_cast<long long>(lane) * T,
                                a + static_cast<long long>(lane) * F::A,
                                ys + static_cast<long long>(lane) * T * N, T, rtol, atol, mxstep);
}

// ys (B, T, N), ts (B, T), g (B, T, N), a (B, A) -> y0_bar (B, N), ts_bar
// (B, T), a_bar (B, A); steps (B,): `adjoint_lane` a thread a lane.
template <class F>
__global__ void __launch_bounds__(kOdeBlock)
dopri5_adjoint(const typename F::Real* ys, const typename F::Real* ts,
               const typename F::Real* g, const typename F::Real* a,
               typename F::Real* y0_bar, typename F::Real* ts_bar,
               typename F::Real* a_bar, int* steps, int B, int T, double rtol, double atol,
               long long mxstep) {
  constexpr int N = F::N, A = F::A;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const long long l = lane;
  steps[lane] = adjoint_lane<F>(ys + l * T * N, ts + l * T, g + l * T * N, a + l * A,
                                y0_bar + l * N, ts_bar + l * T, a_bar + l * A, T, rtol, atol,
                                mxstep);
}

template <class F>
int launch_forward(const void* y0, const void* ts, const void* a, void* ys, void* steps, int B,
                   int T, double rtol, double atol, long long mxstep, void* stream) {
  using R = typename F::Real;
  dopri5_forward<F><<<(B + kOdeBlock - 1) / kOdeBlock, kOdeBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const R*>(y0), static_cast<const R*>(ts), static_cast<const R*>(a),
      static_cast<R*>(ys), static_cast<int*>(steps), B, T, rtol, atol, mxstep);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_adjoint(const void* ys, const void* ts, const void* g, const void* a, void* y0_bar,
                   void* ts_bar, void* a_bar, void* steps, int B, int T, double rtol,
                   double atol, long long mxstep, void* stream) {
  using R = typename F::Real;
  dopri5_adjoint<F><<<(B + kOdeBlock - 1) / kOdeBlock, kOdeBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const R*>(ys), static_cast<const R*>(ts), static_cast<const R*>(g),
      static_cast<const R*>(a), static_cast<R*>(y0_bar), static_cast<R*>(ts_bar),
      static_cast<R*>(a_bar), static_cast<int*>(steps), B, T, rtol, atol, mxstep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ode
}  // namespace smcnuts

// The two C entries of one generated right-hand side F.
#define SMCNUTS_ODE_ENTRIES(F)                                                                  \
  int smcnuts_ode_dopri5(const void* y0, const void* ts, const void* a, void* ys, void* steps,   \
                         int B, int T, double rtol, double atol, long long mxstep,               \
                         void* stream) {                                                          \
    return smcnuts::ode::launch_forward<F>(y0, ts, a, ys, steps, B, T, rtol, atol, mxstep,       \
                                           stream);                                              \
  }                                                                                               \
  int smcnuts_ode_dopri5_adjoint(const void* ys, const void* ts, const void* g, const void* a,   \
                                 void* y0_bar, void* ts_bar, void* a_bar, void* steps, int B,    \
                                 int T, double rtol, double atol, long long mxstep,              \
                                 void* stream) {                                                  \
    return smcnuts::ode::launch_adjoint<F>(ys, ts, g, a, y0_bar, ts_bar, a_bar, steps, B, T,     \
                                           rtol, atol, mxstep, stream);                          \
  }
