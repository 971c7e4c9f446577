"""The port's Stan frontend (`smcnuts_torch.stan`) against the JAX package's
(`smcnuts_tpu.stan`): every `.stan` in examples/stan and the inline programs
of tests/test_stan_*.py that the slice covers (copied here with their data,
not imported), compiled by both, evaluated at the same numpy-seeded theta in
float32.

Compared: dim, constrained_dim, param_names, logprior, loglik, the gradient
of logp(., 0.7) and constrain (without the draws of *_rng calls), at the
tolerances of tests/test_stan_frontend.py:27-45 (rtol 1e-5 / atol 1e-4 on
logprior, atol 1e-3 on loglik, 3e-4 of the largest gradient component,
rtol 1e-6 and atol 1e-6 on constrain); the parsers' ASTs, equal; the
errors, the same on the same inputs.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcnuts_torch import stan as tstan
from smcnuts_torch.stan import math as tmath
from smcnuts_tpu import stan as jstan
from smcnuts_tpu.stan import math as jmath

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLES = sorted(glob.glob(os.path.join(_REPO, "examples", "stan", "*.stan")))

# The AR(1)-error recurrence of tests/test_stan_frontend.py:270-284 and its
# data recipe `_recurrence_data`.
RECURRENCE = """
data { int<lower=1> T; real y[T]; real phi; }
parameters { real a; real<lower=0> s; }
model {
  vector[T] e;
  real acc;
  acc = 0;
  e[1] = y[1];
  for (t in 2:T) {
    e[t] = y[t] - a * e[t-1];
    acc += e[t] * 0.001;
  }
  target += normal_lpdf(a | 0, 1);
  target += phi * (normal_lpdf(e | 0, s) + acc);
}
"""


def recurrence_data(T=40, seed=3):
    y = np.random.default_rng(seed).normal(size=T)
    return {"T": T, "y": y.tolist()}


def _rng(seed):
    return np.random.default_rng(seed)


_EIGHT_Y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
_EIGHT_SIGMA = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]


def _garch_data(T=120, seed=8):
    rng = _rng(seed)
    mu, a0, a1, b1 = 0.3, 0.1, 0.2, 0.5
    y = np.empty(T)
    h = 0.4
    y[0] = mu + np.sqrt(h) * rng.normal()
    for t in range(1, T):
        h = a0 + a1 * (y[t - 1] - mu) ** 2 + b1 * h
        y[t] = mu + np.sqrt(h) * rng.normal()
    return {"T": T, "y": y.tolist(), "sigma1": np.sqrt(0.4)}


_GLM_X = _rng(5).normal(size=(12, 3))
_HMM = _rng(4)
_HMM_LO, _HMM_G, _HMM_RHO = (_HMM.normal(size=(3, 6)), _HMM.dirichlet(np.ones(3), size=3),
                              _HMM.dirichlet(np.ones(3)))

# (id, source, data): programs of tests/test_stan_frontend.py,
# test_stan_distributions.py, test_stan_cdfs.py, test_stan_multiindex.py and
# test_stan_orientation.py.
CASES = [
    ("constrained", """
data { int<lower=1> N; array[N] real y; real<lower=0, upper=1> phi; }
parameters { real mu; real<lower=0> sigma; real<lower=-1, upper=1> rho; real<upper=2> cap; }
model {
  mu ~ normal(0, 5); sigma ~ lognormal(0, 1); rho ~ uniform(-1, 1); cap ~ normal(0, 1);
  target += phi * normal_lpdf(y | mu + rho, sigma);
}""", {"N": 4, "y": [0.1, -0.2, 0.5, 0.3]}),
    ("transformed_parameters", """
data { real phi; }
parameters { vector[2] z; }
transformed parameters { real s = z[1] + z[2]; }
model { z ~ normal(0, 1); target += phi * normal_lpdf(s | 1, 2); }""", {}),
    ("no_phi", "parameters { real x; } model { x ~ normal(3, 2); }", {}),
    ("student_t_sampling", "parameters { real x; } model { x ~ student_t(4, 0, 2); }", {}),
    ("student_t_target",
     "parameters { real x; } model { target += student_t_lpdf(x | 4, 0, 2); }", {}),
    ("conjugate", """
data { int<lower=1> N; array[N] real y; real phi; }
parameters { real mu; }
model { mu ~ normal(0, 1); target += phi * normal_lpdf(y | mu, 1); }""",
     {"N": 8, "y": _rng(0).normal(loc=1.5, size=8).tolist()}),
    ("old_style_arrays", """
data { int<lower=1> N; int<lower=1> C; real x[N*C]; real phi; }
parameters { real b; }
model {
  real acc;
  acc = 0;
  for (i in 1:N) { for (j in 1:C) { acc += x[(i-1)*C + j] * b; } }
  target += phi * normal_lpdf(acc | 0, 1) - fabs(b)^1.5;
}""", {"N": 2, "C": 3, "x": np.arange(6.0).tolist()}),
    ("recurrence_t40", RECURRENCE, recurrence_data(40)),
    ("generated_quantities", """
data { real phi; }
parameters { real m; real<lower=0> s; }
model { m ~ normal(0, 1); s ~ lognormal(0, 1); }
generated quantities { real m2; real y_rep; m2 = m * m; y_rep = normal_rng(m, s); }""", {}),
    ("user_functions", """
functions {
  real sq(real x) { return x * x; }
  real horner(vector c, real x) {
    real acc;
    acc = 0;
    for (k in 1:num_elements(c)) { acc = acc * x + c[k]; }
    return acc;
  }
}
data { real phi; }
parameters { real a; }
model {
  vector[3] c;
  c[1] = 1; c[2] = -2; c[3] = 0.5;
  target += phi * (-sq(a - 1) - 0.1 * sq(horner(c, a)));
}""", {}),
    ("function_target_increment", """
functions { void add_prior_lp(real x) { target += normal_lpdf(x | 0, 2); } }
parameters { real a; }
model { add_prior_lp(a); }""", {}),
    ("while_loop", """
data { int<lower=1> T; real y[T]; real phi; }
parameters { real a; }
model {
  int t; real acc;
  t = 1; acc = 0;
  while (t <= T) { acc += (y[t] - a)^2; t += 1; }
  target += phi * (-0.5 * acc);
}""", {"T": 9, "y": np.arange(9.0).tolist()}),
    ("ordered", "parameters { ordered[4] v; } model { target += 0; }", {}),
    ("positive_ordered", "parameters { positive_ordered[4] v; } model { target += 0; }", {}),
    ("simplex", "parameters { simplex[5] v; } model { target += 0; }", {}),
    ("unit_vector", "parameters { unit_vector[3] v; } model { target += 0; }", {}),
    ("ordered_normal", "parameters { ordered[3] c; } model { for (k in 1:3) { c[k] ~ normal(0, 1); } }",
     {}),
    ("simplex_dirichlet321",
     "parameters { simplex[3] w; } model { target += 2 * log(w[1]) + log(w[2]); }", {}),
    ("eight_schools_ncp", """
data { int<lower=0> J; real y[J]; real<lower=0> sigma[J]; real phi; }
parameters { real mu; real<lower=0> tau; vector[J] theta_t; }
transformed parameters { vector[J] theta = mu + tau * theta_t; }
model {
  mu ~ normal(0, 5); tau ~ cauchy(0, 5); theta_t ~ normal(0, 1);
  target += phi * normal_lpdf(y | theta, sigma);
}""", {"J": 8, "y": _EIGHT_Y, "sigma": _EIGHT_SIGMA}),
    ("glm_functions", """
functions {
  real lin(vector b, real x1, real x2) { return b[1]*x1 + b[2]*x2; }
  void coef_prior_lp(vector b) { target += normal_lpdf(b | 0, 3); }
}
data { int<lower=1> N; real x1[N]; real x2[N]; real y[N]; real phi; }
parameters { vector[2] b; }
model {
  real eta;
  coef_prior_lp(b);
  for (i in 1:N) { eta = lin(b, x1[i], x2[i]); target += phi * (y[i] * eta - log1p_exp(eta)); }
}""", {"N": 20, "x1": _rng(9).normal(size=20).tolist(), "x2": _rng(10).normal(size=20).tolist(),
       "y": (_rng(11).uniform(size=20) < 0.5).astype(float).tolist()}),
    ("garch", """
data { int<lower=1> T; real y[T]; real sigma1; real phi; }
parameters { real mu; real<lower=0> alpha0; real<lower=0, upper=1> alpha1; real<lower=0, upper=1> beta1; }
model {
  vector[T] h;
  h[1] = sigma1^2;
  for (t in 2:T) { h[t] = alpha0 + alpha1 * (y[t-1] - mu)^2 + beta1 * h[t-1]; }
  mu ~ normal(0, 2);
  alpha0 ~ normal(0, 2);
  target += phi * normal_lpdf(y | mu, sqrt(h));
}""", _garch_data()),
    ("range_vectorized", """
data { int<lower=1> T; vector[T] y; real phi; }
parameters { real b; real<lower=0> s; }
model { b ~ normal(0, 1); target += phi * normal_lpdf(y[2:T] | b * y[1:(T-1)], s); }""",
     {"T": 30, "y": _rng(2).normal(size=30).tolist()}),
    ("range_local", """
data { int<lower=1> T; vector[T] y; real phi; }
parameters { real a; real<lower=0> s; }
model {
  vector[T] e;
  e[1] = y[1];
  for (t in 2:T) { e[t] = y[t] - a * e[t-1]; }
  target += phi * normal_lpdf(e[2:] | 0, s);
}""", {"T": 30, "y": _rng(2).normal(size=30).tolist()}),
    ("head_tail_segment", """
data { int<lower=1> T; vector[T] y; }
parameters { real m; }
model {
  target += normal_lpdf(head(y, 3) | m, 1) + normal_lpdf(tail(y, 2) | m, 1)
          + normal_lpdf(segment(y, 2, 3) | m, 1);
}""", {"T": 8, "y": _rng(1).normal(size=8).tolist()}),
    ("multi_normal", """
data { int<lower=1> D; vector[D] mu0; matrix[D, D] Sigma; vector[D] y; }
parameters { vector[D] x; }
model { x ~ multi_normal(mu0, Sigma); y ~ multi_normal(x, Sigma); }""",
     {"D": 2, "mu0": [0.0, 0.0], "Sigma": [[1.0, 0.6], [0.6, 2.0]], "y": [1.0, -0.5]}),
    ("dirichlet", """
data { vector[3] alpha; }
parameters { simplex[3] w; }
model { w ~ dirichlet(alpha); }""", {"alpha": [2.0, 3.0, 1.5]}),
    ("cholesky_factor_corr", "parameters { cholesky_factor_corr[4] L; } model { target += 0; }", {}),
    ("lkj_corr_cholesky",
     "parameters { cholesky_factor_corr[2] L; } model { L ~ lkj_corr_cholesky(2); }", {}),
    ("corr_matrix", "parameters { corr_matrix[4] S; } model { target += 0; }", {}),
    ("cov_matrix", "parameters { cov_matrix[3] S; } model { target += 0; }", {}),
    ("cholesky_factor_cov", "parameters { cholesky_factor_cov[3] L; } model { target += 0; }", {}),
    ("matrix_algebra", """
data { matrix[2,2] A; vector[2] b; real phi; }
parameters { real z; }
model {
  target += trace(A) + determinant(A) + log_determinant(A);
  target += quad_form(A, b) + quad_form(inverse(A), b);
  target += trace(crossprod(A)) + trace(tcrossprod(A));
  target += sum(mdivide_left_tri_low(cholesky_decompose(A), b));
  target += rows(A) + cols(A) + num_elements(b);
  target += distance(col(A, 1), b) + squared_distance(row(A, 2), b);
  target += trace(quad_form_diag(A, b)) + sum(mdivide_left_spd(A, b));
  target += -0.5 * z * z;
}""", {"A": [[2.0, 0.3], [0.3, 1.5]], "b": [0.4, -0.7]}),
    ("gq_container_rng", """
data { vector[3] a; vector[2] mu0; matrix[2,2] S0; real phi; }
parameters { real z; }
model { z ~ normal(0, 1); }
generated quantities {
  int c = categorical_rng(a);
  vector[3] w = dirichlet_rng(a);
  vector[2] g = multi_normal_rng(mu0, S0);
  vector[2] h = multi_normal_cholesky_rng(mu0, cholesky_decompose(S0));
}""", {"a": [1.0, 2.0, 3.0], "mu0": [0.0, 1.0], "S0": [[1.0, 0.2], [0.2, 0.5]]}),
    ("hierarchical_correlated", """
data { int<lower=1> J; vector[2] y[J]; real phi; }
parameters { cholesky_factor_corr[2] L; vector<lower=0>[2] tau; vector[2] z[J]; }
model {
  L ~ lkj_corr_cholesky(2);
  tau ~ exponential(1);
  for (j in 1:J) {
    z[j] ~ std_normal();
    target += phi * normal_lpdf(y[j] | diag_pre_multiply(tau, L) * z[j], 0.5);
  }
}""", {"J": 3, "y": _rng(5).normal(size=(3, 2)).tolist()}),
    ("offset_multiplier", """
data { real mu0; real<lower=0> s0; }
parameters { real<offset=mu0, multiplier=s0> x; }
model { x ~ normal(mu0, s0); }""", {"mu0": 3.0, "s0": 2.0}),
    ("reject_unreachable",
     "data { int n; } parameters { real x; } "
     "model { if (n < 0) { reject(\"bad\"); } print(\"hi\", n); x ~ normal(0, 1); }", {"n": 3}),
    ("stochastic_volatility_wide", """
data { vector[20] y; real phi; }
parameters { vector[20] h_std; real m; }
transformed parameters {
  vector[20] h;
  h[1] = m + h_std[1];
  for (t in 2:20) { h[t] = m + 0.9 * (h[t-1] - m) + 0.3 * h_std[t]; }
}
model { h_std ~ std_normal(); target += phi * normal_lpdf(y | 0, exp(h / 2)); }""",
     {"y": _rng(0).normal(size=20).tolist()}),
    # test_stan_distributions.py
    ("new_families", """
data { real y; }
parameters { real<lower=0> s; }
model { s ~ rayleigh(2.0); y ~ weibull(1.5, s) T[0.5,]; }""", {"y": 1.8}),
    ("phi_functions", """
data { real u; }
parameters { real m; }
model { target += inv_Phi(u) + Phi_approx(m) + m - 0.5 * m * m; }""", {"u": 0.8}),
    ("glm_densities", """
data { int<lower=1> n; int<lower=1> d; matrix[n, d] X; vector[n] yb; vector[n] yp; vector[n] yn; }
parameters { real alpha; vector[d] beta; real<lower=0> sigma; }
model {
  yb ~ bernoulli_logit_glm(X, alpha, beta);
  yp ~ poisson_log_glm(X, alpha, beta);
  yn ~ normal_id_glm(X, alpha, beta, sigma);
  target += neg_binomial_2_log_glm_lpmf(yp | X, alpha, beta, 3.0);
}""", {"n": 12, "d": 3, "X": _GLM_X.tolist(),
       "yb": (_rng(6).uniform(size=12) < 0.5).astype(float).tolist(),
       "yp": _rng(7).poisson(2.0, size=12).astype(float).tolist(),
       "yn": _rng(8).normal(size=12).tolist()}),
    # test_stan_cdfs.py
    ("truncated_half_normal", """
data { int<lower=1> N; vector[N] y; }
parameters { real mu; real<lower=0> sigma; }
model { mu ~ normal(0, 5); sigma ~ normal(0, 2) T[0,]; y ~ normal(mu, sigma); }""",
     {"N": 8, "y": _rng(0).normal(1.0, 0.5, size=8).tolist()}),
    ("truncated_two_sided",
     "data { real y; } parameters { real mu; } model { y ~ normal(mu, 1.5) T[-1, 2]; }",
     {"y": 0.7}),
    ("truncated_upper",
     "data { real y; } parameters { real r; } model { y ~ exponential(exp(r)) T[, 3]; }",
     {"y": 1.1}),
    ("truncated_upper_outside",
     "data { real y; } parameters { real r; } model { y ~ exponential(exp(r)) T[, 3]; }",
     {"y": 4.0}),
    ("truncated_vectorized", """
data { int<lower=1> N; vector[N] y; }
parameters { real mu; }
model { y ~ normal(mu, 1) T[0,]; }""", {"N": 4, "y": [0.4, 1.2, 0.1, 2.0]}),
    ("truncated_long_loop", """
data { int<lower=1> T; vector[T] y; }
parameters { real mu; }
model { for (t in 1:T) { y[t] ~ normal(mu, 1) T[0,]; } }""",
     {"T": 64, "y": np.abs(_rng(3).normal(1.0, 0.8, size=64)).tolist()}),
    ("cdf_calls", """
data { vector[3] y; }
parameters { real m; }
model { target += normal_lcdf(y | m, 2) + gamma_lccdf(2.0 | 3, 1) + normal_cdf(y | m, 2); }""",
     {"y": [0.1, -0.5, 1.0]}),
    # test_stan_multiindex.py
    ("gather_data_vector", """
data { int<lower=1> N; int<lower=1> M; array[M] int idx; vector[N] y; }
parameters { real mu; }
model { y[idx] ~ normal(mu, 1); }""",
     {"N": 6, "M": 3, "idx": [1, 3, 5], "y": [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]}),
    ("gather_parameter_vector", """
data { int<lower=1> N; int<lower=1> J; array[N] int county; vector[N] y; }
parameters { vector[J] a; }
model { y ~ normal(a[county], 1); }""", {"N": 4, "J": 3, "county": [1, 2, 1, 3],
                                          "y": [0.1, 0.2, 0.3, 0.4]}),
    ("gather_then_scalar_index", """
data { matrix[4, 2] X; array[2] int rows; }
parameters { real m; }
model { target += m + sum(X[rows, 2]) - 0.5 * m * m; }""",
     {"X": [[1.0, 10.0], [2.0, 20.0], [3.0, 30.0], [4.0, 40.0]], "rows": [1, 4]}),
    ("log_mix_binary", """
data { int<lower=1> N; vector[N] y; }
parameters { real<lower=0, upper=1> lambda; real mu1; real mu2; }
model {
  for (n in 1:N)
    target += log_mix(lambda, normal_lpdf(y[n] | mu1, 1), normal_lpdf(y[n] | mu2, 1));
}""", {"N": 12, "y": _rng(1).normal(size=12).tolist()}),
    ("log_mix_vector", """
data { int<lower=1> K; vector[K] lp; }
parameters { simplex[K] w; }
model { target += log_mix(w, lp); }""", {"K": 3, "lp": [-1.0, -2.0, -0.5]}),
    ("assembly_builtins", """
data { int<lower=1> K; vector[K] v; }
parameters { real a; }
transformed parameters { vector[K + 1] w = append_row(a, v); }
model {
  target += sum(w) + rep_matrix(a, 2, 2)[1, 1]
          + to_matrix(v, 1, 3)[1, 2] + log_diff_exp(0, a - 1)
          + columns_dot_product(append_col(v, v), append_col(v, v))[1]
          + rows_dot_product(rep_matrix(a, 2, 2), rep_matrix(1, 2, 2))[1];
}""", {"K": 3, "v": [1.0, 2.0, 3.0]}),
    ("irt_idiom", """
data { int<lower=1> I; int<lower=1> P; int<lower=1> N; array[N] int item; array[N] int person;
       vector[N] y; }
parameters { vector[P] theta; vector<lower=0>[I] alpha; vector[I] beta; }
model {
  theta ~ std_normal();
  alpha ~ lognormal(0.5, 1);
  beta ~ normal(0, 3);
  y ~ bernoulli_logit(alpha[item] .* (theta[person] - beta[item]));
}""", {"I": 3, "P": 4, "N": 10, "item": _rng(2).integers(1, 4, size=10).tolist(),
       "person": _rng(3).integers(1, 5, size=10).tolist(),
       "y": (_rng(4).uniform(size=10) < 0.5).astype(float).tolist()}),
    ("literals", """
data { real y; }
parameters { real a; real b; }
model {
  vector[2] v = [a, b]';
  array[3] int pick = {1, 3, 2};
  vector[3] w = to_vector({y, a, b});
  y ~ normal(dot_product(v, v) + w[pick[2]], 1);
}""", {"y": 0.5}),
    ("gp_cov_exp_quad", """
data { int<lower=1> N; array[N] real x; vector[N] y; }
parameters { real<lower=0> rho; real<lower=0> alpha; real<lower=0> sigma; }
model {
  matrix[N, N] K = add_diag(cov_exp_quad(x, alpha, rho), square(sigma));
  rho ~ inv_gamma(5, 5);
  alpha ~ std_normal();
  sigma ~ std_normal();
  y ~ multi_normal_cholesky(rep_vector(0, N), cholesky_decompose(K));
}""", {"N": 6, "x": np.linspace(0, 1, 6).tolist(), "y": _rng(5).normal(size=6).tolist()}),
    ("gp_two_inputs",
     "data { int<lower=1> N; array[N] real x; } parameters { real a; } "
     "model { target += a + cov_exp_quad(x, x, 1.0, 0.5)[1, 2] - a * a; }",
     {"N": 3, "x": [0.0, 0.3, 1.0]}),
    ("reduce_sum", """
functions {
  real partial_sum(array[] real y_slice, int start, int end, real mu) {
    return normal_lpdf(y_slice | mu, 1) + 0.0 * (end - start);
  }
}
data { int<lower=1> N; array[N] real y; }
parameters { real mu; }
model { target += reduce_sum(partial_sum, y, 1, mu); }""", {"N": 4, "y": [0.1, 0.2, 0.3, 0.4]}),
    ("transformed_data_matrix_fill", """
data { int<lower=1> N; array[N] real x; vector[N] y; }
transformed data { real my = mean(y); }
parameters { real<lower=0> rho; }
model {
  matrix[N, N] K;
  for (i in 1:N) { for (j in 1:N) { K[i, j] = exp(-square(x[i] - x[j]) / rho); } }
  target += K[1, 2] + my + (N % 2);
}""", {"N": 3, "x": [0.0, 0.5, 1.0], "y": [1.0, 2.0, 3.0]}),
    ("small_builtins", """
data { vector[4] v; }
parameters { real a; }
model {
  target += multiply_log(0, 0) + lmultiply(2, a) + lchoose(5, 2) + choose(5, 2)
          + step(a - 10) + int_step(a) + fdim(a, 0.1) + hypot(3, 4)
          + sort_asc(v)[1] + sort_desc(v)[1] + sort_indices_asc(v)[1] + rank(v, 2)
          - 0.5 * a * a;
}""", {"v": [3.0, 1.0, 4.0, 1.5]}),
    ("map_rect", """
functions {
  vector shard_ll(vector phi, vector theta, data array[] real x_r, data array[] int x_i) {
    return [normal_lpdf(to_vector(x_r) | phi[1] + theta[1], 1)]';
  }
}
data { int<lower=1> J; int<lower=1> M; array[J, M] real y_sh; array[J, 1] int dummy; }
parameters { real mu; array[J] vector[1] offs; }
model {
  vector[J] lls = map_rect(shard_ll, [mu]', offs, y_sh, dummy);
  target += sum(lls);
}""", {"J": 3, "M": 4, "y_sh": _rng(3).normal(size=(3, 4)).tolist(), "dummy": [[0], [0], [0]]}),
    ("hmm_marginal", """
data { int<lower=1> K; int<lower=1> T; matrix[K, T] log_omegas; matrix[K, K] Gamma; vector[K] rho; }
parameters { real m; }
model { target += m - m * m + hmm_marginal(log_omegas, Gamma, rho); }""",
     {"K": 3, "T": 6, "log_omegas": _HMM_LO.tolist(), "Gamma": _HMM_G.tolist(),
      "rho": _HMM_RHO.tolist()}),
    # test_stan_orientation.py
    ("transpose_inner_outer", """
data { int<lower=1> N; vector[N] v; vector[N] w; real y; real phi; }
parameters { real a; }
model {
  a ~ normal(0, 1);
  y ~ normal(a * (v' * w), 1);
  target += -0.5 * square(trace(v * w') - v' * w);
}""", {"N": 4, "v": _rng(0).normal(size=4).tolist(), "w": _rng(1).normal(size=4).tolist(),
       "y": 1.3}),
    ("matrix_row_times_vector", """
data { int<lower=1> N; int<lower=1> P; matrix[N, P] X; vector[N] y; real phi; }
parameters { vector[P] beta; }
model { beta ~ normal(0, 1); for (n in 1:N) { y[n] ~ normal(X[n] * beta, 1); } }""",
     {"N": 5, "P": 3, "X": _rng(2).normal(size=(5, 3)).tolist(), "y": _rng(3).normal(size=5).tolist()}),
    ("append_row_transposed", """
data { vector[3] a; vector[3] b; vector[2] y; real phi; }
parameters { vector[3] beta; }
model { matrix[2, 3] M = append_row(a', b'); beta ~ normal(0, 1); y ~ normal(M * beta, 1); }""",
     {"a": [0.5, -1.0, 2.0], "b": [1.0, 0.3, -0.2], "y": [0.4, -0.6]}),
    ("row_vector_data", """
data { int<lower=1> P; row_vector[P] x; real y; real phi; }
parameters { vector[P] beta; }
model {
  beta ~ normal(0, 1);
  y ~ normal(x * beta, 1);
  target += -0.5 * squared_distance(x', [1.0, 2.0, 3.0]');
}""", {"P": 3, "x": [0.5, -1.0, 2.0], "y": 0.8}),
    ("row_vector_local_function", """
functions { real rowdot(row_vector r, vector v) { return r * v; } }
data { int<lower=1> P; matrix[2, P] X; real phi; }
parameters { vector[P] beta; }
model {
  row_vector[P] r;
  r = X[2];
  beta ~ normal(0, 1);
  target += -0.5 * square(rowdot(r, beta) - 1.0);
  target += head(r, 2) * segment(beta, 1, 2);
}""", {"P": 3, "X": _rng(4).normal(size=(2, 3)).tolist()}),
    ("array_of_row_vectors", """
data { int<lower=1> K; int<lower=1> P; array[K] row_vector[P] X; vector[K] y; real phi; }
parameters { vector[P] beta; }
model { beta ~ normal(0, 1); for (k in 1:K) { y[k] ~ normal(X[k] * beta, 1); } }""",
     {"K": 4, "P": 3, "X": _rng(5).normal(size=(4, 3)).tolist(), "y": _rng(6).normal(size=4).tolist()}),
    ("matrix_literal", """
data { real phi; }
parameters { vector[2] beta; }
model {
  matrix[2, 2] M = [[1.0, 2.0], [3.0, 4.0]];
  vector[2] v = [5.0, 6.0]';
  beta ~ normal(0, 1);
  target += -0.5 * squared_distance(M * beta, v);
  target += -0.5 * squared_distance((v')', v);
}""", {}),
    ("break_continue", """
data { int<lower=1> N; vector[N] y; real phi; }
parameters { real mu; }
model {
  mu ~ normal(0, 1);
  for (n in 1:N) { if (n > 3) { break; } if (n == 2) { continue; } y[n] ~ normal(mu, 1); }
  int k = 1;
  while (1) { if (k > 2) { break; } target += -0.1 * k; k += 1; }
}""", {"N": 5, "y": [0.5, -0.2, 1.0, 2.0, 3.0]}),
    ("tuples", """
data { real y; real phi; }
parameters { real a; real b; }
model {
  tuple(real, vector[2]) t = (a * 2, [a, b]');
  y ~ normal(t.1 + t.2[2], 1);
  tuple(real, real) s;
  s = (a + 1, b - 1);
  target += -0.5 * square(s.1 * s.2);
}""", {"y": 0.4}),
]

# Programs both frontends reject, with what the message names (the JAX
# tests' `match`): tests/test_stan_frontend.py:225, :374, :794, :839 and the
# rejections of the other files.
ERRORS = [
    ("undefined_variable", "parameters { real x; } model { x ~ wishart(3, I); }", {}, "undefined"),
    ("parameter_loop_bound",
     "parameters { real x; } model { for (i in 1:x) target += x; }", {}, "compile-time"),
    ("rng_outside_gq", "parameters { real m; } model { target += normal_rng(m, 1); }", {},
     "_rng|generated"),
    ("recursion", """
functions { real f(real x) { return f(x) + 1; } }
parameters { real a; }
model { target += f(a); }""", {}, "depth|recursion"),
    ("while_parameter_condition",
     "parameters { real a; } model { while (a > 0) { target += -1; } }", {}, "while"),
    ("if_parameter_condition",
     "parameters { real a; } model { if (a > 0) { target += -1; } }", {}, "if"),
    ("gather_out_of_bounds", """
data { int<lower=1> N; array[2] int idx; vector[N] y; }
parameters { real mu; }
model { y[idx] ~ normal(mu, 1); }""", {"N": 3, "idx": [1, 4], "y": [0.0, 0.0, 0.0]},
     "out of bounds"),
    ("truncated_discrete",
     "data { int y; } parameters { real l; } model { y ~ poisson(exp(l)) T[1,]; }", {"y": 2},
     "discrete"),
    ("unknown_cdf", "data { real y; } parameters { real m; } "
     "model { target += wishart_lcdf(y | m, 1); }", {"y": 0.5}, "no CDF"),
    ("offset_with_bound",
     "parameters { real<lower=0, multiplier=2> x; } model { target += x; }", {},
     "offset/multiplier"),
    ("reject_reached", "data { int n; } parameters { real x; } "
     "model { if (n < 0) { target += x; } else { reject(\"bad\"); } }", {"n": 3}, "reject"),
    ("row_times_row", "data { vector[2] a; vector[2] b; real phi; } parameters { real x; } "
     "model { x ~ normal(0, 1); target += a' * b'; }", {"a": [1.0, 2.0], "b": [3.0, 4.0]},
     "orientations"),
    ("vector_times_vector", "data { vector[2] a; vector[2] b; real phi; } parameters { real x; } "
     "model { x ~ normal(0, 1); target += sum(a * b); }", {"a": [1.0, 2.0], "b": [3.0, 4.0]},
     "ambiguous"),
    ("row_plus_column", "data { vector[2] a; vector[2] b; real phi; } parameters { real x; } "
     "model { x ~ normal(0, 1); target += sum(a' + b); }", {"a": [1.0, 2.0], "b": [3.0, 4.0]},
     "mismatch"),
    ("reduce_sum_unknown", "data { real y; } parameters { real m; } "
     "model { target += reduce_sum(nope, y, 1, m); }", {"y": 0.1}, "user-defined"),
    ("tuple_parameter", "parameters { tuple(real, real) t; } model { target += t.1; }", {},
     "tuple"),
    ("range_assignment", "parameters { real a; } model { vector[3] v; v[1:2] = a; target += v[1]; }",
     {}, ""),
]

_ODE = """
functions {
  vector rhs(real t, vector y, real k) { return -k * y; }
}
data { int<lower=1> T; array[T] real ts; vector[1] y0; }
parameters { real<lower=0> k; }
model {
  array[T] vector[1] sol = ode_rk45(rhs, y0, 0.0, ts, k);
  k ~ normal(1, 1);
  target += -0.5 * square(sol[T][1] - 0.3);
}"""


def _ast(node):
    """An AST as nested tuples of class names and field values, so the two
    parsers' (distinct) dataclasses compare by structure."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return (type(node).__name__,) + tuple(
            (f.name, _ast(getattr(node, f.name))) for f in dataclasses.fields(node))
    if isinstance(node, (list, tuple)):
        return tuple(_ast(x) for x in node)
    if isinstance(node, dict):
        return tuple(sorted((k, _ast(v)) for k, v in node.items()))
    return node


def _not_rng_entries(jm):
    """Indices of the constrained vector that no *_rng call draws."""
    return [i for i, n in enumerate(jm.param_names) if not n.startswith("gq.")]


def compare(src, data, name, n_points=3, seed=0, scale=0.5, gq_rng=False, jit=True):
    """Both frontends on one program: the model's interface and its values
    at n_points numpy-seeded float32 points. jit=False evaluates the JAX
    model op by op, unrolled, where XLA's compile of it is the cost."""
    # The JAX model's loops of 8 or more iterations lower to lax.scan, which
    # the JAX frontend states bit-identical to its unrolled interpretation
    # (smcnuts_tpu/stan/compiler.py:34-43): it keeps XLA's compile short.
    jm = jstan.compile_stan_program(src, data, name=name, scan_threshold=8 if jit else None)
    tm = tstan.compile_stan_program(src, data, name=name)
    assert (tm.name, tm.dim, tm.constrained_dim) == (jm.name, jm.dim, jm.constrained_dim)
    assert tm.param_names == tuple(jm.param_names)
    th = (_rng(seed).normal(size=(n_points, jm.dim)) * scale).astype(np.float32)
    x = torch.tensor(th)
    lp_t, ll_t = tm.logprior(x).numpy(), tm.loglik(x).numpy()
    # The interpretation (the replayed graph: test_replayed_*).
    _, g_t = tstan.compiler.CallableModel.logp_and_grad(tm, x, 0.7)
    c_t = tm.constrain(x).numpy()
    keep = _not_rng_entries(jm) if gq_rng else list(range(jm.constrained_dim))
    # The JAX side batched by vmap: one interpretation for all the points.
    def values(t):
        return (jm.logprior(t), jm.loglik(t), jax.grad(lambda u: jm.logp(u, 0.7))(t),
                jm.constrain(t))

    # One compiled function a program, called at each point (under vmap the
    # JAX frontend cannot fold a truncation's normaliser).
    f = jax.jit(values) if jit else values
    lp_j, ll_j, g_j, c_j = (np.stack(v) for v in zip(*(
        [np.asarray(u) for u in f(jnp.asarray(t))] for t in th)))
    for i in range(n_points):
        np.testing.assert_allclose(lp_t[i], lp_j[i], rtol=1e-5, atol=1e-4, err_msg="logprior")
        np.testing.assert_allclose(ll_t[i], ll_j[i], rtol=1e-5, atol=1e-3, err_msg="loglik")
        if np.isfinite(lp_j[i] + 0.7 * ll_j[i]):
            sc = float(np.abs(g_j[i]).max()) + 1e-6
            np.testing.assert_allclose(g_t[i].numpy() / sc, g_j[i] / sc, atol=3e-4,
                                       err_msg="gradient")
        # rtol 1e-6, and an absolute floor of float32 rounding on O(1)
        # values (a matrix product's entries near 0 differ by an ulp of
        # its terms).
        np.testing.assert_allclose(c_t[i][keep], c_j[i][keep], rtol=1e-6, atol=1e-6,
                                   err_msg="constrain")
    return jm, tm


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_program_matches_jax(case):
    name, src, data = case
    compare(src, data, name, gq_rng="_rng(" in src)


@pytest.mark.parametrize("path", _EXAMPLES, ids=[os.path.basename(p) for p in _EXAMPLES])
def test_example_matches_jax(path):
    with open(path) as f:
        src = f.read()
    data = tstan.load_stan_data(path[: -len(".stan")] + ".json")
    name = os.path.splitext(os.path.basename(path))[0]
    # XLA takes ~25 s to compile rowvec_regression's 60 row-vector products
    # (unrolled or scanned); op by op its three points take ~8 s.
    compare(src, data, name, scale=0.3, gq_rng="_rng(" in src,
            jit=name != "rowvec_regression")


def test_parsers_agree():
    sources = [c[1] for c in CASES] + [e[1] for e in ERRORS] + [RECURRENCE, _ODE]
    for path in _EXAMPLES:
        with open(path) as f:
            sources.append(f.read())
    for src in sources:
        assert _ast(tstan.parse(src)) == _ast(jstan.parse(src))
    with pytest.raises(tstan.StanSyntaxError):
        tstan.parse("parameters { real x } model { }")


@pytest.mark.parametrize("case", ERRORS, ids=[e[0] for e in ERRORS])
def test_errors_match_jax(case):
    name, src, data, match = case
    for frontend in (jstan, tstan):
        with pytest.raises(frontend.StanCompileError, match=match):
            frontend.compile_stan_program(src, data, name=name).logp(
                (jnp.zeros((1,)) if frontend is jstan else torch.zeros((1, 1))), 1.0)


def test_ode_raises_naming_its_roadmap_item():
    data = {"T": 3, "ts": [0.5, 1.0, 1.5], "y0": [1.0]}
    jstan.compile_stan_program(_ODE, data, name="ode")  # the JAX frontend runs it
    with pytest.raises(tstan.StanCompileError, match="Queue 1 item 11b"):
        tstan.compile_stan_program(_ODE, data, name="ode")


def test_load_stan_data_repairs_truncation(tmp_path):
    p = tmp_path / "d.json"
    p.write_text('{"N": 3, "y": [1, 2, 3], "phi": ')
    assert tstan.load_stan_data(str(p)) == jstan.load_stan_data(str(p))
    p.write_text('{"N": 3, "y": [1, 2')
    with pytest.raises(json.JSONDecodeError):
        tstan.load_stan_data(str(p))


def test_parameter_control_flow_is_never_frozen():
    """A tensor converts to bool without complaint, so a traced or vmapped
    interpreter could take one branch silently: the port raises instead,
    in the eager model and in both generated-model traces."""
    src = "parameters { real a; real b; } model { if (a > b) { target += a; } }"
    for tile in ("reverse", "forward"):
        with pytest.raises(tstan.StanCompileError, match="`if` conditions"):
            tstan.compile_stan_program(src, {}, tile=True, tile_autodiff=tile)
    ternary = "parameters { real a; } model { target += a > 0 ? -a : a; }"
    m = tstan.compile_stan_program(ternary, {})
    x = torch.tensor([[-1.0], [2.0]])
    np.testing.assert_allclose(m.logp(x).numpy(), [-1.0, -2.0])


def test_scan_threshold_is_accepted_and_ignored():
    data = recurrence_data(40)
    a = tstan.compile_stan_program(RECURRENCE, data, scan_threshold=4)
    b = tstan.compile_stan_program(RECURRENCE, data, scan_threshold=None)
    x = torch.tensor(_rng(0).normal(size=(4, 2)).astype(np.float32))
    assert torch.equal(a.logp(x, 0.7), b.logp(x, 0.7))


def test_float64_and_determinism():
    """The same program in float64 agrees with float32 to float32's
    precision; generated quantities drawn from the per-call-site stream are
    the same from call to call and differ between particles."""
    src = dict((c[0], c[1]) for c in CASES)["generated_quantities"]
    tm = tstan.compile_stan_program(src, {}, name="gq")
    x = torch.tensor(_rng(1).normal(size=(6, 2)))
    np.testing.assert_allclose(tm.logp(x, 0.7).numpy(),
                               tm.logp(x.float(), 0.7).double().numpy(), rtol=1e-5)
    c1, c2 = tm.constrain(x.float()), tm.constrain(x.float())
    assert torch.equal(c1, c2)
    assert torch.isfinite(c1).all() and len(set(c1[:, 3].tolist())) == 6
    torch.testing.assert_close(c1[:, 2], x[:, 0].float() ** 2)


# Draws of the port's RNG functions against the JAX module's: the same
# parameters, 4,000 draws each, first two moments.
_RNG_CASES = [
    ("normal", (0.4, 1.3)), ("std_normal", ()), ("uniform", (-1.0, 2.0)),
    ("exponential", (1.7,)), ("gamma", (2.5, 1.5)), ("inv_gamma", (4.0, 2.0)),
    ("beta", (2.0, 3.0)), ("lognormal", (0.1, 0.4)), ("student_t", (6.0, 0.5, 1.2)),
    ("chi_square", (3.0,)), ("inv_chi_square", (6.0,)), ("scaled_inv_chi_square", (7.0, 1.5)),
    ("logistic", (0.3, 0.8)), ("gumbel", (0.2, 0.9)), ("weibull", (1.7, 2.2)),
    ("frechet", (4.5, 1.4)), ("pareto", (1.5, 4.0)), ("pareto_type_2", (0.5, 2.0, 4.0)),
    ("rayleigh", (1.2,)), ("double_exponential", (0.3, 1.1)), ("poisson", (3.5,)),
    ("poisson_log", (1.1,)), ("bernoulli", (0.3,)), ("bernoulli_logit", (0.4,)),
    ("binomial", (10.0, 0.35)),
]


@pytest.mark.parametrize("case", _RNG_CASES, ids=[c[0] for c in _RNG_CASES])
def test_rng_draws_match_jax_in_distribution(case):
    name, args = case
    n = 4000
    fj, ft = jmath.RNG_FUNCTIONS[name], tmath.RNG_FUNCTIONS[name]
    torch.manual_seed(0)
    if args:  # parameters broadcast to (n,): n draws in one call
        dj = fj(jax.random.key(0), *[jnp.full((n,), a, jnp.float32) for a in args])
        dt = ft(*[torch.full((n,), a) for a in args])
    else:
        dj = jax.vmap(fj)(jax.random.split(jax.random.key(0), n))
        dt = torch.func.vmap(lambda _: ft(), randomness="different")(torch.zeros(n))
    dj, dt = np.asarray(dj, dtype=np.float64), dt.double().numpy()
    assert dj.shape == dt.shape == (n,)
    se_mean = np.sqrt(dj.var() / n + dt.var() / n)
    assert abs(dj.mean() - dt.mean()) < 5 * se_mean, (dj.mean(), dt.mean())
    # Variances within 5 standard errors of their difference (fourth moments).
    se_var = np.sqrt(((dj - dj.mean()) ** 4).mean() / n + ((dt - dt.mean()) ** 4).mean() / n)
    assert abs(dj.var() - dt.var()) < 5 * se_var + 1e-9, (dj.var(), dt.var())


def test_container_rng_draws():
    src = CASES[[c[0] for c in CASES].index("gq_container_rng")]
    tm = tstan.compile_stan_program(src[1], src[2], name="gqrng")
    out = tm.constrain(torch.zeros((400, 1))).numpy()
    assert np.all(np.isin(out[:, 1], [1.0, 2.0, 3.0]))
    np.testing.assert_allclose(out[:, 2:5].sum(1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(out[:, 1].mean(), (1 + 4 + 9) / 6.0, atol=0.15)
    np.testing.assert_allclose(out[:, 2:5].mean(0), [1 / 6, 2 / 6, 3 / 6], atol=0.05)
    np.testing.assert_allclose(out[:, 5:7].mean(0), [0.0, 1.0], atol=0.15)
    np.testing.assert_allclose(np.cov(out[:, 7:9].T), [[1.0, 0.2], [0.2, 0.5]], atol=0.2)


def test_replayed_logp_and_grad_equals_interpretation():
    """StanModel.logp_and_grad traces the interpretation once per shape and
    replays the graph: the same values, bit for bit, for a scalar and a
    per-particle phi; a new shape gets its own graph. The gradient of a
    gather (a[county], categorical outcomes, cutpoints) is a select, not
    index_add / scatter_add / index_put, which a GPU adds with atomics in an
    order that changes from call to call: the graph holds none."""
    src = """
data { int N; int J; array[N] int g; int y[N]; vector[N] x; }
parameters { vector[J] a; simplex[3] theta; ordered[2] c; }
model {
  a ~ normal(0, 1);
  x ~ normal(a[g], 1);
  y ~ categorical(theta);
  y ~ ordered_logistic(a[g], c);
}"""
    data = {"N": 5, "J": 2, "g": [1, 2, 2, 1, 2], "y": [1, 3, 2, 2, 1],
            "x": [0.1, -0.3, 0.4, 0.2, 0.0]}
    tm = tstan.compile_stan_program(src, data, name="gathers")
    x = torch.tensor(_rng(3).normal(size=(16, tm.dim)).astype(np.float32))
    for phi in (0.7, torch.linspace(0.1, 1.0, 16)):
        want = tstan.compiler.CallableModel.logp_and_grad(tm, x, phi)
        for _ in range(2):
            got = tm.logp_and_grad(x, phi)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(tm._graphs) == 1
    (graph,) = tm._graphs.values()
    ops = {str(n.target) for n in graph.graph.nodes if n.op == "call_function"}
    assert not [op for op in ops if any(
        k in op for k in ("index_add", "scatter", "index_put", "put_"))], ops
    tm.logp_and_grad(x[:5], 0.7)
    assert len(tm._graphs) == 2
