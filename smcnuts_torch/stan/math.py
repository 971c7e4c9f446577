"""Stan math library for the port's .stan frontend: builtins and log densities
in torch ops, the port of `smcnuts_tpu/stan/math.py`.

All densities include their normalizing constants (BridgeStan `propto=False`
semantics), matching the convention of the hand-written models in
`models/base.py` — sampling (`~`) statements therefore also keep constants,
a documented deviation from Stan's dropped-constant `~` semantics that only
shifts the target by a constant (invisible to sampling; offsets log-evidence
by the same constant at every temperature).

Container arguments follow Stan semantics: `dist_lpdf(y | args)` broadcasts
elementwise and returns the SUM over all elements.

Values. As in the JAX module, data are numpy arrays and Python numbers and
everything that depends on the parameters is a tensor (a jnp array there).
Every function here takes either kind: `apply` (the interpreter's one call
site for this module's tables) converts numpy arguments to tensors of the
evaluation's dtype and device (`evaluation`) where a tensor is among them,
and evaluates a call on data alone on the host in float64, returning numpy
arrays and Python numbers, so data-derived values stay data (loop bounds,
indices, branch conditions, folded truncation normalizers). The scalar
helpers (`_log`, `_exp`, ...) take Python numbers as well as tensors, since
the interpreter's per-element paths hand them literals.

Only ops that the generated in-kernel model lowers appear in the densities a
kernel runs where the JAX module takes a composite (log-sigmoid and softplus
in raw exp/log1p/abs/where form, as `_log_sigmoid_stable` there); a density
that needs another op (lgamma of a parameter, erf, cos) raises when a
generated model is built from it (`ops/generated.py`).
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch

LOG_SQRT_2PI = float(0.5 * math.log(2.0 * math.pi))


# ---- values: the evaluation's dtype and device, data vs tensors ----

class _Evaluation:
    """The dtype and device that numpy data meeting tensors take, and the
    model's cache of data so converted (id -> (array, tensor); the array is
    held so that its id stays its own; None: no caching)."""

    def __init__(self, dtype, device, cache=None):
        self.dtype, self.device, self.cache = dtype, torch.device(device), cache


_EVAL_CTX = contextvars.ContextVar("smcnuts_stan_evaluation",
                                   default=_Evaluation(torch.float64, "cpu"))
_CACHE_MAX = 512


def _ev() -> _Evaluation:
    return _EVAL_CTX.get()


@contextlib.contextmanager
def evaluation(dtype, device, cache=None):
    """Numpy data meeting tensors become tensors of this dtype and device,
    kept in `cache` (a dict the model owns) where one is given."""
    token = _EVAL_CTX.set(_Evaluation(dtype, device, cache))
    try:
        yield
    finally:
        _EVAL_CTX.reset(token)


@contextlib.contextmanager
def untraced():
    """Out of every trace (make_fx, torch.func): tensors made here are plain
    constants wherever they are used."""
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

    with disable_proxy_modes_tracing(), torch._C._DisableFuncTorch(), \
            torch._C.DisableTorchFunction():
        yield


@contextlib.contextmanager
def host():
    """A computation on data alone: float64 on the CPU, untraced, so its
    result can come back as numpy."""
    with untraced(), evaluation(torch.float64, "cpu"):
        yield


def is_tensor(v) -> bool:
    return isinstance(v, torch.Tensor)


def _has_tensor(v) -> bool:
    if isinstance(v, torch.Tensor):
        return True
    if isinstance(v, RowVector):
        return isinstance(v.data, torch.Tensor)
    if isinstance(v, (list, tuple)):
        return any(_has_tensor(x) for x in v)
    return False


def to_tensor(v):
    """A numpy array or Python number as a tensor of the evaluation's dtype
    and device (floating tensors pass, integer tensors are cast)."""
    ev = _ev()
    if isinstance(v, torch.Tensor):
        return v if v.is_floating_point() else v.to(ev.dtype)
    if isinstance(v, np.ndarray) and v.ndim:
        key = (id(v), ev.dtype, ev.device)
        hit = None if ev.cache is None else ev.cache.get(key)
        if hit is not None and hit[0] is v:
            return hit[1]
        with untraced():
            t = torch.as_tensor(np.asarray(v, dtype=np.float64)).to(
                dtype=ev.dtype, device=ev.device)
        if ev.cache is not None:
            if len(ev.cache) >= _CACHE_MAX:
                ev.cache.clear()
            ev.cache[key] = (v, t)
        return t
    return torch.tensor(float(v), dtype=ev.dtype, device=ev.device)


def _lift(v):
    """numpy arrays (also inside RowVectors, lists, tuples) as tensors."""
    if isinstance(v, np.ndarray):
        return to_tensor(v)
    if isinstance(v, RowVector):
        return RowVector(_lift(v.data))
    if isinstance(v, tuple):
        return tuple(_lift(x) for x in v)
    if isinstance(v, list):
        return [_lift(x) for x in v]
    return v


def to_host(v):
    """A host result back as data: 0-d tensors as Python numbers, others as
    numpy arrays (integer dtypes kept)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dim() == 0:
            return bool(v) if v.dtype == torch.bool else (
                int(v) if not v.is_floating_point() else float(v))
        return v.cpu().numpy()
    if isinstance(v, RowVector):
        return RowVector(to_host(v.data))
    if isinstance(v, tuple):
        return tuple(to_host(x) for x in v)
    if isinstance(v, list):
        return [to_host(x) for x in v]
    return v


def apply(fn, *args):
    """fn(*args) with the module's value convention: with a tensor among the
    arguments, numpy arguments become tensors alike; on data alone the call
    runs on the host and its result comes back as data."""
    if any(_has_tensor(a) for a in args):
        return fn(*(_lift(a) for a in args))
    with host():
        return to_host(fn(*(_lift(a) for a in args)))


def _uf(tfn):
    """A unary elementwise function of a tensor or a Python number (the
    number computed on the host in float64)."""

    def f(x):
        if isinstance(x, RowVector):
            x = x.data
        if isinstance(x, torch.Tensor):
            return tfn(x if x.is_floating_point() else x.to(_ev().dtype))
        return apply(lambda t: tfn(to_tensor(t)), x)

    return f


def _bf(tfn):
    """A binary elementwise torch function of tensors or numbers."""

    def f(a, b):
        a, b = _as_value(a), _as_value(b)
        if not (is_tensor(a) or is_tensor(b)):
            return apply(lambda u, v: tfn(to_tensor(u), to_tensor(v)), a, b)
        return tfn(to_tensor(a), to_tensor(b))

    return f


def _as_value(x):
    return x.data if isinstance(x, RowVector) else x


_exp = _uf(torch.exp)
_log = _uf(torch.log)
_log1p = _uf(torch.log1p)
_expm1 = _uf(torch.expm1)
_abs = _uf(torch.abs)
_lgamma = _uf(torch.lgamma)
_floor = _uf(torch.floor)
_log_ndtr = _uf(torch.special.log_ndtr)


def _where(c, a, b):
    """torch.where of a tensor or Python condition."""
    if not is_tensor(c):
        if not isinstance(c, np.ndarray):
            return a if c else b
        if not (is_tensor(a) or is_tensor(b)):
            return np.where(c, a, b)
        c = torch.as_tensor(c, device=_ev().device)
    a = a if is_tensor(a) else to_tensor(a) if isinstance(a, np.ndarray) else a
    b = b if is_tensor(b) else to_tensor(b) if isinstance(b, np.ndarray) else b
    if not (is_tensor(a) or is_tensor(b)):
        a = torch.tensor(float(a), dtype=_ev().dtype, device=c.device)
    return torch.where(c, a, b)


def _maximum(x, c: float):
    """max(x, c) for a constant c, in a where (a lowered op)."""
    if not is_tensor(x):
        return apply(lambda t: torch.clamp_min(to_tensor(t), c), x)
    return torch.where(x > c, x, c)


def _minimum(x, c: float):
    if not is_tensor(x):
        return apply(lambda t: torch.clamp_max(to_tensor(t), c), x)
    return torch.where(x < c, x, c)


def _softplus(x):
    """log(1 + exp(x)), overflow-safe, in raw elementwise primitives."""
    return _log1p(_exp(-_abs(x))) + _maximum(x, 0.0)


def _log_sigmoid_stable(z):
    """log sigmoid(z) = (z - |z|)/2 - log1p(exp(-|z|)) — exact and stable
    for all z, in raw elementwise primitives (abs, exp, log1p: each lowered
    by the generated in-kernel model, where F.logsigmoid is not)."""
    a = _abs(z)
    return 0.5 * (z - a) - _log1p(_exp(-a))


def _concrete_scalar(v):
    """float(v) when v is a data scalar (Python number, numpy scalar or 0-d
    array), else None — lets densities resolve data-dependent branches when
    a model is built and fold data elements as literals of the generated
    in-kernel model. A tensor is never concrete: like a JAX tracer it
    depends on the parameters."""
    if is_tensor(v) or isinstance(v, RowVector):
        return None
    if np.ndim(v) != 0:
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _ndim(v) -> int:
    if is_tensor(v):
        return v.dim()
    return np.ndim(_as_value(v))


def _lp(elementwise):
    """Wrap an elementwise log-density into Stan's summed-container form."""

    def f(*args):
        if all(_ndim(a) == 0 for a in args):
            # All-scalar fast path: concrete arguments stay Python numbers,
            # so a density can resolve its branches on them (_bernoulli_logit
            # picking one branch per observation).
            vals = []
            for a in args:
                c = _concrete_scalar(a)
                vals.append(c if c is not None else a)
            return elementwise(*vals)
        ts = [_as_arr(a) for a in args]
        return torch.sum(elementwise(*torch.broadcast_tensors(*ts)))

    return f


# ---- log densities (continuous) ----

def _normal(y, mu, sigma):
    z = (y - mu) / sigma
    return -0.5 * z * z - _log(sigma) - LOG_SQRT_2PI


def _cauchy(y, mu, gamma):
    z = (y - mu) / gamma
    return -_log(math.pi * gamma) - _log1p(z * z)


def _student_t(y, nu, mu, sigma):
    z = (y - mu) / sigma
    return (
        _lgamma((nu + 1.0) / 2.0)
        - _lgamma(nu / 2.0)
        - 0.5 * _log(nu * math.pi)
        - _log(sigma)
        - (nu + 1.0) / 2.0 * _log1p(z * z / nu)
    )


def _exponential(y, rate):
    return _log(rate) - rate * y


def _gamma(y, alpha, beta):
    return alpha * _log(beta) - _lgamma(alpha) + (alpha - 1.0) * _log(y) - beta * y


def _inv_gamma(y, alpha, beta):
    return alpha * _log(beta) - _lgamma(alpha) - (alpha + 1.0) * _log(y) - beta / y


def _lognormal(y, mu, sigma):
    return _normal(_log(y), mu, sigma) - _log(y)


def _beta(y, a, b):
    return (
        (a - 1.0) * _log(y)
        + (b - 1.0) * _log1p(-y)
        + _lgamma(a + b)
        - _lgamma(a)
        - _lgamma(b)
    )


def _uniform(y, a, b):
    inside = _logical_and(_ge(y, a), _le(y, b))
    return _where(inside, -_log(b - a), -math.inf)


def _double_exponential(y, mu, sigma):
    return -_abs(y - mu) / sigma - _log(2.0 * sigma)


def _chi_square(y, nu):
    return -nu / 2.0 * math.log(2.0) - _lgamma(nu / 2.0) + (nu / 2.0 - 1.0) * _log(y) - y / 2.0


def _inv_chi_square(y, nu):
    return -nu / 2.0 * math.log(2.0) - _lgamma(nu / 2.0) - (nu / 2.0 + 1.0) * _log(y) - 0.5 / y


def _scaled_inv_chi_square(y, nu, s):
    return (
        nu / 2.0 * _log(nu / 2.0)
        + nu * _log(s)
        - _lgamma(nu / 2.0)
        - (nu / 2.0 + 1.0) * _log(y)
        - nu * s * s / (2.0 * y)
    )


def _logistic(y, mu, sigma):
    z = (y - mu) / sigma
    return -z - _log(sigma) - 2.0 * _softplus(-z)


def _gumbel(y, mu, beta):
    z = (y - mu) / beta
    return -_log(beta) - z - _exp(-z)


def _weibull(y, alpha, sigma):
    return _log(alpha) - alpha * _log(sigma) + (alpha - 1.0) * _log(y) - (y / sigma) ** alpha


def _frechet(y, alpha, sigma):
    return (
        _log(alpha) - _log(sigma) + (-alpha - 1.0) * _log(y / sigma) - (y / sigma) ** (-alpha)
    )


def _pareto(y, y_min, alpha):
    lp = _log(alpha) + alpha * _log(y_min) - (alpha + 1.0) * _log(y)
    return _where(_ge(y, y_min), lp, -math.inf)


def _pareto_type_2(y, mu, lam, alpha):
    lp = _log(alpha) - _log(lam) - (alpha + 1.0) * _log1p((y - mu) / lam)
    return _where(_ge(y, mu), lp, -math.inf)


def _rayleigh(y, sigma):
    return _log(y) - 2.0 * _log(sigma) - y * y / (2.0 * sigma * sigma)


def _skew_normal(y, xi, omega, alpha):
    z = (y - xi) / omega
    return math.log(2.0) - _log(omega) - 0.5 * z * z - LOG_SQRT_2PI + _log_ndtr(alpha * z)


def _von_mises(y, mu, kappa):
    # log I0(kappa) = kappa + log i0e(kappa), overflow-safe for large kappa
    return (
        kappa * _uf(torch.cos)(y - mu)
        - math.log(2.0 * math.pi)
        - (kappa + _log(_uf(torch.special.i0e)(kappa)))
    )


def _exp_mod_normal(y, mu, sigma, lam):
    # log erfc(x) = log 2 + log_ndtr(-x*sqrt(2)): keeps the density finite
    # where erfc underflows (y far into the Gaussian-dominated tail)
    arg = (mu + lam * sigma * sigma - y) / sigma
    return (
        _log(lam / 2.0)
        + lam / 2.0 * (2.0 * mu + lam * sigma * sigma - 2.0 * y)
        + math.log(2.0)
        + _log_ndtr(-arg)
    )


# ---- comparisons and logic on numbers, arrays or tensors ----

def _cmp(op):
    def f(a, b):
        a, b = _as_value(a), _as_value(b)
        if is_tensor(a) or is_tensor(b):
            a = to_tensor(a) if isinstance(a, np.ndarray) else a
            b = to_tensor(b) if isinstance(b, np.ndarray) else b
        return op(a, b)
    return f


_ge = _cmp(lambda a, b: a >= b)
_le = _cmp(lambda a, b: a <= b)
_gt = _cmp(lambda a, b: a > b)
_lt = _cmp(lambda a, b: a < b)


def _logical_and(a, b):
    for u, v in ((a, b), (b, a)):
        if isinstance(u, (bool, np.bool_)):
            return v if u else False
    if is_tensor(a) or is_tensor(b):
        return torch.logical_and(torch.as_tensor(a), torch.as_tensor(b))
    return np.logical_and(a, b)


# ---- log probability mass functions ----

def _poisson(y, lam):
    return y * _log(lam) - lam - _lgamma(y + 1.0)


def _poisson_log(y, log_lam):
    return y * log_lam - _exp(log_lam) - _lgamma(y + 1.0)


def _bernoulli(y, p):
    # log(p) where y = 1 and log1p(-p) where y = 0, each on the probability
    # selected first: the untaken branch sees 1/2, so where float32 p rounds
    # to 1 (probit's Phi(eta) at eta above ~5.4) the untaken log1p(-p) is not
    # -inf and the select's gradient stays finite. The taken values are those
    # of log(p) and log1p(-p) themselves.
    yv = _concrete_scalar(y)
    if yv is not None:
        return _log(p) if yv > 0.5 else _log1p(-p)
    one = _gt(y, 0.5)
    return _where(one, _log(_where(one, p, 0.5)), _log1p(-_where(one, 0.5, p)))


def _bernoulli_logit(y, alpha):
    # log sigmoid(alpha) if y==1 else log sigmoid(-alpha). With concrete y
    # (the per-element path reads data elements as scalars) the branch
    # resolves when the model is built — no select, only the taken branch.
    yv = _concrete_scalar(y)
    if yv is not None:
        return _log_sigmoid_stable(alpha if yv > 0.5 else -alpha)
    return _where(_gt(y, 0.5), _log_sigmoid_stable(alpha), _log_sigmoid_stable(-alpha))


def _binomial(y, n, p):
    return (
        _lgamma(n + 1.0) - _lgamma(y + 1.0) - _lgamma(n - y + 1.0)
        + y * _log(p) + (n - y) * _log1p(-p)
    )


def _neg_binomial_2(y, mu, phi):
    return (
        _lgamma(y + phi) - _lgamma(phi) - _lgamma(y + 1.0)
        + phi * _log(phi / (phi + mu)) + y * _log(mu / (phi + mu))
    )


def _neg_binomial_2_log(y, eta, phi):
    # log-mean parameterization, stable via softplus: log(phi + mu) =
    # log phi + softplus(eta - log phi)
    log_phi = _log(phi)
    log_phi_mu = log_phi + _softplus(eta - log_phi)
    return (
        _lgamma(y + phi) - _lgamma(phi) - _lgamma(y + 1.0)
        + phi * (log_phi - log_phi_mu) + y * (eta - log_phi_mu)
    )


def _binomial_logit(y, n, alpha):
    return (
        _lgamma(n + 1.0) - _lgamma(y + 1.0) - _lgamma(n - y + 1.0)
        + y * _log_sigmoid_stable(alpha) + (n - y) * _log_sigmoid_stable(-alpha)
    )


# ---- special functions the CDFs need ----

def _igamma_series(ax, x, a, enabled, eps):
    """The series of P(a, x) and its derivative in a, each element iterated
    until its own term is below eps (XLA's `IgammaSeries`, DERIVATIVE mode)."""
    r, c, ans = a, torch.ones_like(a), torch.ones_like(a)
    dc_da, dans_da = torch.zeros_like(a), torch.zeros_like(a)
    while bool(enabled.any()):
        r1 = r + 1.0
        dc1 = dc_da * (x / r1) - (c * x) / (r1 * r1)
        dans1 = dans_da + dc1
        c1 = c * (x / r1)
        ans1 = ans + c1
        go = enabled & ((dc1 / dans1).abs() > eps)
        r, c, ans = (torch.where(enabled, u, v) for u, v in ((r1, r), (c1, c), (ans1, ans)))
        dc_da = torch.where(enabled, dc1, dc_da)
        dans_da = torch.where(enabled, dans1, dans_da)
        enabled = go
    dlogax_da = torch.log(x) - torch.digamma(a + 1.0)
    return ax * (ans * dlogax_da + dans_da) / a


def _igammac_fraction(ax, x, a, enabled, eps):
    """The continued fraction of Q(a, x) and its derivative in a, at most
    2000 terms (XLA's `IgammacContinuedFraction`, DERIVATIVE mode)."""
    y = 1.0 - a
    z = x + y + 1.0
    pkm2, qkm2, pkm1 = torch.ones_like(x), x, x + 1.0
    qkm1 = z * x
    ans = pkm1 / qkm1
    dpkm2, dqkm2, dpkm1, dqkm1 = (torch.zeros_like(x),) * 3 + (-x,)
    dans = (dpkm1 - ans * dqkm1) / qkm1
    big = 1.0 / eps
    c = 0
    while c < 2000 and bool(enabled.any()):
        c += 1
        y1, z1 = y + 1.0, z + 2.0
        yc = y1 * c
        pk = pkm1 * z1 - pkm2 * yc
        qk = qkm1 * z1 - qkm2 * yc
        nz = qk != 0
        ans1 = torch.where(nz, pk / qk, ans)
        dpk = dpkm1 * z1 - pkm1 - dpkm2 * yc + pkm2 * c
        dqk = dqkm1 * z1 - qkm1 - dqkm2 * yc + qkm2 * c
        dans1 = torch.where(nz, (dpk - ans1 * dqk) / qk, dans)
        moved = torch.where(nz, (dans1 - dans).abs(), torch.ones_like(dans))
        rescale = pk.abs() > big
        new = [pk, qk, pkm1, qkm1, dpk, dqk, dpkm1, dqkm1]
        new = [torch.where(rescale, v * eps, v) for v in new]
        old = [pkm1, qkm1, pkm2, qkm2, dpkm1, dqkm1, dpkm2, dqkm2]
        pkm1, qkm1, pkm2, qkm2, dpkm1, dqkm1, dpkm2, dqkm2 = (
            torch.where(enabled, u, v) for u, v in zip(new, old))
        ans, dans = torch.where(enabled, ans1, ans), torch.where(enabled, dans1, dans)
        y, z = torch.where(enabled, y1, y), torch.where(enabled, z1, z)
        enabled = enabled & (moved > eps)
    dlogax_da = torch.log(x) - torch.digamma(a)
    return ax * (ans * dlogax_da + dans)


@torch.library.custom_op("smcnuts::igamma_grad_a", mutates_args=())
def igamma_grad_a(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dP(a, x)/da elementwise (broadcast), JAX's `igamma_grad_a`
    (`jax/_src/lax/special.py`, XLA's `IgammaGradA`): the series below x =
    max(1, a), the continued fraction above, each element iterated to its own
    convergence; 0 at x = 0, NaN outside the domain. One op in a trace; its
    vmap rule runs the batch in one call."""
    a, x = torch.broadcast_tensors(a, x)
    eps = torch.finfo(a.dtype).eps
    is_nan = a.isnan() | x.isnan()
    x_is_zero = x == 0
    domain_error = (x < 0) | (a <= 0)
    use_igammac = (x > 1) & (x > a)
    log_ax = a * torch.log(x) - x - torch.lgamma(a)
    underflow = log_ax < -math.log(torch.finfo(a.dtype).max)
    ax = torch.exp(log_ax)
    enabled = ~(x_is_zero | domain_error | underflow | is_nan)
    out = torch.where(use_igammac,
                      -_igammac_fraction(ax, x, a, enabled & use_igammac, eps),
                      _igamma_series(ax, x, a, enabled & ~use_igammac, eps))
    out = torch.where(x_is_zero, torch.zeros_like(out), out)
    return torch.where(domain_error | is_nan, torch.full_like(out, math.nan), out)


@igamma_grad_a.register_fake
def _(a, x):
    return a.new_empty(torch.broadcast_shapes(a.shape, x.shape))


def _igamma_grad_a_vmap(info, in_dims, a, x):
    n = max(a.dim() - (in_dims[0] is not None), x.dim() - (in_dims[1] is not None))

    def lead(v, d):
        v = v.unsqueeze(0) if d is None else v.movedim(d, 0)
        return v.reshape(v.shape[:1] + (1,) * (n + 1 - v.dim()) + v.shape[1:])

    return igamma_grad_a(lead(a, in_dims[0]), lead(x, in_dims[1])), 0


igamma_grad_a.register_vmap(_igamma_grad_a_vmap)


class _IgammaGradA(torch.autograd.Function):
    """`igamma_grad_a` under the transforms (a custom op's own autograd
    wrapper is refused by torch.func); it has no derivative of its own."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, x):
        return igamma_grad_a(a, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("the second derivative of gammainc in its shape is not "
                                  "supported")


class _RegularizedGamma(torch.autograd.Function):
    """P(a, x) (upper=False) or Q(a, x) = 1 - P (upper=True), torch's values,
    with JAX's derivatives in both arguments: in x the density
    x^(a-1) e^-x / Gamma(a), in a `igamma_grad_a` (torch's gammainc has no
    derivative in a)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, x, upper):
        return (torch.special.gammaincc if upper else torch.special.gammainc)(a, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, x, ctx.upper = inputs
        ctx.save_for_backward(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        ga = gx = None
        if ctx.needs_input_grad[0]:
            ga = (sign * g * _IgammaGradA.apply(a, x)).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            dx = torch.exp(-x + (a - 1.0) * torch.log(x) - torch.lgamma(a))
            gx = (sign * g * dx).sum_to_size(x.shape)
        return ga, gx, None


def _regularized_gamma(a, x, upper):
    """P(a, x) or Q(a, x) of tensors or numbers: data alone through torch's
    op on the host (`apply`), a parameter through `_RegularizedGamma`."""
    a, x = _as_value(a), _as_value(x)
    if not (is_tensor(a) or is_tensor(x)):
        op = torch.special.gammaincc if upper else torch.special.gammainc
        return apply(lambda u, v: op(to_tensor(u), to_tensor(v)), a, x)
    return _RegularizedGamma.apply(to_tensor(a), to_tensor(x), upper)


def _gammainc(a, x):
    return _regularized_gamma(a, x, False)


def _gammaincc(a, x):
    return _regularized_gamma(a, x, True)


def _betainc_cf(a, b, x, iters=200):
    """The continued fraction of the regularized incomplete beta (modified
    Lentz), for x < (a + 1) / (a + b + 2), where it converges fast."""
    tiny = 1e-30
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 - qab * x / qap
    d = torch.where(d.abs() < tiny, tiny, d)
    d = 1.0 / d
    h = d
    for m in range(1, iters + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = torch.where(d.abs() < tiny, tiny, d)
        c = 1.0 + aa / c
        c = torch.where(c.abs() < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = torch.where(d.abs() < tiny, tiny, d)
        c = 1.0 + aa / c
        c = torch.where(c.abs() < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
    return h


def _betainc_t(a, b, x):
    """I_x(a, b), elementwise over broadcast tensors (torch has no betainc):
    the continued fraction on whichever of I_x(a, b) = 1 - I_{1-x}(b, a)
    converges, at a fixed number of terms (no data-dependent control flow,
    differentiable in x by autograd)."""
    a, b, x = torch.broadcast_tensors(to_tensor(a), to_tensor(b), to_tensor(x))
    xc = x.clamp(1e-30, 1.0 - 1e-7) if x.dtype == torch.float32 else x.clamp(1e-300, 1 - 1e-16)
    lbeta = torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
    front = torch.exp(lbeta + a * torch.log(xc) + b * torch.log1p(-xc))
    direct = front * _betainc_cf(a, b, xc) / a
    mirrored = 1.0 - front * _betainc_cf(b, a, 1.0 - xc) / b
    out = torch.where(xc < (a + 1.0) / (a + b + 2.0), direct, mirrored)
    out = torch.where(x <= 0.0, torch.zeros_like(out), out)
    return torch.where(x >= 1.0, torch.ones_like(out), out)


def _betainc(a, b, x):
    if not any(is_tensor(v) for v in (a, b, x)):
        return apply(_betainc_t, a, b, x)
    return _betainc_t(a, b, x)


# ---- log CDFs / CCDFs ----
#
# Elementwise, matching the parameterizations above. They serve (a) the
# user-callable `<dist>_lcdf` / `<dist>_lccdf` / `<dist>_cdf` functions
# (Stan container semantics: lcdf/lccdf SUM over elements, cdf is the
# product) and (b) truncated sampling statements `y ~ dist(...) T[lo, hi]`
# (`truncated_lp` below). Written in log-stable forms; `where` branches use
# clamped inputs so the untaken branch cannot poison gradients.

def _normal_lcdf(y, mu, sigma):
    return _log_ndtr((y - mu) / sigma)


def _normal_lccdf(y, mu, sigma):
    return _log_ndtr(-(y - mu) / sigma)


def _cauchy_lcdf_z(z):
    # cdf = 1/2 + atan(z)/pi = atan2(1, -z)/pi; atan2 keeps the tail
    # cdf ~ 1/(pi*|z|) representable, so the log is accurate to -inf.
    return _log(_bf(torch.atan2)(1.0, -z)) - math.log(math.pi)


def _student_t_lcdf_z(z, nu):
    # F(z) = 1/2 I_x(nu/2, 1/2) for z <= 0, x = nu/(nu + z^2); mirrored
    # above zero.
    x = nu / (nu + z * z)
    ib = _betainc(nu / 2.0, 0.5, x)
    return _where(_le(z, 0.0), _log(0.5 * ib), _log1p(-0.5 * ib))


def _exponential_lcdf(y, rate):
    return _log(-_expm1(-rate * y))


def _gamma_lcdf(y, alpha, beta):
    return _log(_gammainc(alpha, beta * y))


def _gamma_lccdf(y, alpha, beta):
    return _log(_gammaincc(alpha, beta * y))


def _inv_gamma_lcdf(y, alpha, beta):
    return _log(_gammaincc(alpha, beta / y))


def _inv_gamma_lccdf(y, alpha, beta):
    return _log(_gammainc(alpha, beta / y))


def _beta_lcdf(y, a, b):
    return _log(_betainc(a, b, y))


def _beta_lccdf(y, a, b):
    # 1 - I_y(a, b) = I_{1-y}(b, a), exact in log space
    return _log(_betainc(b, a, 1.0 - y))


def _clip01(v):
    return _minimum(_maximum(v, 0.0), 1.0)


def _uniform_lcdf(y, a, b):
    return _log(_clip01((y - a) / (b - a)))


def _uniform_lccdf(y, a, b):
    return _log(_clip01((b - y) / (b - a)))


def _dexp_lcdf_z(z):
    zn = _minimum(z, 0.0)
    zp = _maximum(z, 0.0)
    return _where(_le(z, 0.0), math.log(0.5) + zn, _log1p(-0.5 * _exp(-zp)))


def _chi_square_lcdf(y, nu):
    return _log(_gammainc(nu / 2.0, y / 2.0))


def _chi_square_lccdf(y, nu):
    return _log(_gammaincc(nu / 2.0, y / 2.0))


def _lognormal_lcdf(y, mu, sigma):
    return _normal_lcdf(_log(y), mu, sigma)


def _lognormal_lccdf(y, mu, sigma):
    return _normal_lccdf(_log(y), mu, sigma)


def _poisson_lcdf(y, lam):
    # P(Y <= y) = Q(floor(y) + 1, lam), the regularized upper gamma.
    # y < 0 would hand gammaincc a non-positive shape (nan); select -inf.
    yc = _maximum(y, 0.0)
    v = _log(_gammaincc(_floor(yc) + 1.0, lam))
    return _where(_lt(y, 0.0), -math.inf, v)


def _poisson_lccdf(y, lam):
    yc = _maximum(y, 0.0)
    v = _log(_gammainc(_floor(yc) + 1.0, lam))
    return _where(_lt(y, 0.0), 0.0, v)


def _clip(v, lo, hi):
    """clip(v, lo, hi) with a tensor or data hi."""
    v = _maximum(v, lo)
    return _where(_gt(v, hi), hi, v)


def _binomial_lcdf(y, n, p):
    # P(Y <= y) = I_{1-p}(n - y, y + 1); y == n clamps to 0 (cdf = 1),
    # y < 0 selects -inf (betainc's shape args must stay positive).
    yc = _clip(y, 0.0, n)
    a = _maximum(n - yc, 1.0)
    v = _betainc(a, yc + 1.0, 1.0 - p)
    return _where(_lt(y, 0.0), -math.inf, _where(_ge(y, n), 0.0, _log(v)))


def _binomial_lccdf(y, n, p):
    yc = _clip(y, 0.0, n)
    b = _maximum(n - yc, 1.0)
    v = _betainc(yc + 1.0, b, p)
    return _where(_lt(y, 0.0), 0.0, _where(_ge(y, n), -math.inf, _log(v)))


def _nb2_lcdf(y, mu, phi):
    yc = _maximum(y, 0.0)
    v = _log(_betainc(phi, yc + 1.0, phi / (phi + mu)))
    return _where(_lt(y, 0.0), -math.inf, v)


def _nb2_lccdf(y, mu, phi):
    yc = _maximum(y, 0.0)
    v = _log(_betainc(yc + 1.0, phi, mu / (phi + mu)))
    return _where(_lt(y, 0.0), 0.0, v)


def _log1m_exp(x):
    """log(1 - exp(x)) for x <= 0."""
    return _log(-_expm1(x))


def _pareto_lccdf(y, y_min, alpha):
    return _where(_ge(y, y_min), alpha * (_log(y_min) - _log(_bf(torch.maximum)(y, y_min))), 0.0)


def _pareto2_lccdf(y, mu, lam, alpha):
    return _where(_ge(y, mu), -alpha * _log1p(_maximum(y - mu, 0.0) / lam), 0.0)


ELEMENTWISE_LCDFS = {
    "inv_chi_square": lambda y, nu: _log(_gammaincc(nu / 2.0, 0.5 / y)),
    "scaled_inv_chi_square": lambda y, nu, s: _log(_gammaincc(nu / 2.0, nu * s * s / (2.0 * y))),
    "logistic": lambda y, mu, s: _log_sigmoid_stable((y - mu) / s),
    "gumbel": lambda y, mu, b: -_exp(-(y - mu) / b),
    "weibull": lambda y, a, s: _log1m_exp(-((y / s) ** a)),
    "frechet": lambda y, a, s: -((y / s) ** (-a)),
    "pareto": lambda y, ym, a: _log1m_exp(_pareto_lccdf(y, ym, a)),
    "pareto_type_2": lambda y, mu, lam, a: _log1m_exp(_pareto2_lccdf(y, mu, lam, a)),
    "rayleigh": lambda y, s: _log1m_exp(-y * y / (2.0 * s * s)),
    "normal": _normal_lcdf,
    "std_normal": lambda y: _normal_lcdf(y, 0.0, 1.0),
    "cauchy": lambda y, mu, g: _cauchy_lcdf_z((y - mu) / g),
    "student_t": lambda y, nu, mu, s: _student_t_lcdf_z((y - mu) / s, nu),
    "exponential": _exponential_lcdf,
    "gamma": _gamma_lcdf,
    "inv_gamma": _inv_gamma_lcdf,
    "lognormal": _lognormal_lcdf,
    "beta": _beta_lcdf,
    "uniform": _uniform_lcdf,
    "double_exponential": lambda y, mu, s: _dexp_lcdf_z((y - mu) / s),
    "chi_square": _chi_square_lcdf,
    "poisson": _poisson_lcdf,
    "poisson_log": lambda y, eta: _poisson_lcdf(y, _exp(eta)),
    "bernoulli": lambda y, p: _where(
        _lt(y, 0.0), -math.inf, _where(_ge(y, 1.0), 0.0, _log1p(-p))),
    "bernoulli_logit": lambda y, a: _where(
        _lt(y, 0.0), -math.inf, _where(_ge(y, 1.0), 0.0, _log_sigmoid_stable(-a))),
    "binomial": _binomial_lcdf,
    "neg_binomial_2": _nb2_lcdf,
}

ELEMENTWISE_LCCDFS = {
    "inv_chi_square": lambda y, nu: _log(_gammainc(nu / 2.0, 0.5 / y)),
    "scaled_inv_chi_square": lambda y, nu, s: _log(_gammainc(nu / 2.0, nu * s * s / (2.0 * y))),
    "logistic": lambda y, mu, s: _log_sigmoid_stable(-(y - mu) / s),
    "gumbel": lambda y, mu, b: _log1m_exp(-_exp(-(y - mu) / b)),
    "weibull": lambda y, a, s: -((y / s) ** a),
    "frechet": lambda y, a, s: _log1m_exp(-((y / s) ** (-a))),
    "pareto": _pareto_lccdf,
    "pareto_type_2": _pareto2_lccdf,
    "rayleigh": lambda y, s: -y * y / (2.0 * s * s),
    "normal": _normal_lccdf,
    "std_normal": lambda y: _normal_lccdf(y, 0.0, 1.0),
    "cauchy": lambda y, mu, g: _cauchy_lcdf_z(-(y - mu) / g),
    "student_t": lambda y, nu, mu, s: _student_t_lcdf_z(-(y - mu) / s, nu),
    "exponential": lambda y, rate: -rate * y,
    "gamma": _gamma_lccdf,
    "inv_gamma": _inv_gamma_lccdf,
    "lognormal": _lognormal_lccdf,
    "beta": _beta_lccdf,
    "uniform": _uniform_lccdf,
    "double_exponential": lambda y, mu, s: _dexp_lcdf_z(-(y - mu) / s),
    "chi_square": _chi_square_lccdf,
    "poisson": _poisson_lccdf,
    "poisson_log": lambda y, eta: _poisson_lccdf(y, _exp(eta)),
    "bernoulli": lambda y, p: _where(
        _lt(y, 0.0), 0.0, _where(_ge(y, 1.0), -math.inf, _log(p))),
    "bernoulli_logit": lambda y, a: _where(
        _lt(y, 0.0), 0.0, _where(_ge(y, 1.0), -math.inf, _log_sigmoid_stable(a))),
    "binomial": _binomial_lccdf,
    "neg_binomial_2": _nb2_lccdf,
}

# Truncated sampling statements follow Stan's CONTINUOUS semantics
# (normalize by F(hi) - F(lo)); the discrete convention differs (the lower
# denominator term is F(lo - 1)), so discrete families are rejected rather
# than silently mis-normalized.
DISCRETE_DISTRIBUTIONS = frozenset({
    "poisson", "poisson_log", "bernoulli", "bernoulli_logit", "binomial",
    "binomial_logit", "neg_binomial_2", "neg_binomial_2_log", "categorical",
    "categorical_logit", "multinomial", "ordered_logistic",
})


def _check_truncatable(dist, lo, hi):
    if dist in DISCRETE_DISTRIBUTIONS:
        raise ValueError(
            f"truncation (T[,]) of the discrete distribution {dist!r} is "
            "not supported (Stan's discrete truncation normalizes by "
            "F(lo - 1); only continuous families are implemented)"
        )
    density = ELEMENTWISE_DENSITIES.get(dist)
    if density is None:
        raise ValueError(f"truncation requires an elementwise density for {dist!r}")
    lcdf = ELEMENTWISE_LCDFS.get(dist)
    lccdf = ELEMENTWISE_LCCDFS.get(dist)
    if (hi is not None and lcdf is None) or (lo is not None and hi is None and lccdf is None):
        raise ValueError(
            f"no CDF implemented for {dist!r}; truncation unavailable "
            f"(supported: {', '.join(sorted(ELEMENTWISE_LCDFS))})"
        )
    return density, lcdf, lccdf


def truncation_lognorm(dist, params, lo=None, hi=None):
    """log(F(hi) - F(lo)) of a truncated sampling statement — involves only
    bounds and parameters, NOT the outcome, so the per-element path hoists
    it out of the element loop (one evaluation per statement), and with
    data bounds and parameters it is computed on the host and folds to a
    Python float before any trace sees it. That fold is load-bearing: a
    half-Cauchy `T[0,]` in a generated in-kernel model would otherwise need
    an atan2, which the lowering does not have."""
    _check_truncatable(dist, lo, hi)
    return apply(lambda *a: _truncation_lognorm(dist, *a), list(params), lo, hi)


def _truncation_lognorm(dist, params, lo, hi):
    _, lcdf, lccdf = _check_truncatable(dist, lo, hi)
    params = [_scalar_or_tensor(a) for a in params]
    if lo is not None and hi is not None:
        la = lcdf(_scalar_or_tensor(hi), *params)
        lb = lcdf(_scalar_or_tensor(lo), *params)
        return la + _log(-_expm1(lb - la))
    if lo is not None:
        return lccdf(_scalar_or_tensor(lo), *params)
    if hi is not None:
        return lcdf(_scalar_or_tensor(hi), *params)
    return 0.0


def _scalar_or_tensor(v):
    """A Python number stays one (scalar helpers take it), anything else is
    a tensor."""
    v = _as_value(v)
    if isinstance(v, (int, float, bool)) or (isinstance(v, np.ndarray) and v.ndim == 0):
        return float(v)
    return to_tensor(v)


def truncated_lp(dist, args, lo=None, hi=None, lnorm=None):
    """Summed log-density of the truncated sampling statement
    `y ~ dist(args) T[lo, hi]` (Stan reference manual, truncation chapter):
    per element, lpdf(y) - log(F(hi) - F(lo)) inside the bounds and -inf
    outside. `args` is [y, *params]; bounds broadcast like parameters and may
    depend on parameters (gradients flow through the CDFs at the bounds).
    `lnorm` may be precomputed via truncation_lognorm (the per-element path
    hoists it)."""
    density, _, _ = _check_truncatable(dist, lo, hi)
    if lnorm is None:
        lnorm = truncation_lognorm(dist, args[1:], lo, hi)

    def f(args, lo, hi, lnorm):
        y = _scalar_or_tensor(args[0])
        params = [_scalar_or_tensor(a) for a in args[1:]]
        ll = density(y, *params)
        in_range = True
        if lo is not None:
            in_range = _logical_and(in_range, _ge(y, _scalar_or_tensor(lo)))
        if hi is not None:
            in_range = _logical_and(in_range, _le(y, _scalar_or_tensor(hi)))
        out = _where(in_range, ll - lnorm, -math.inf)
        return torch.sum(out) if is_tensor(out) else out

    return apply(f, list(args), lo, hi, lnorm)


# Raw per-element densities (no broadcast/sum wrapper). The compiler's
# per-element mode (generated in-kernel models) calls these one element at a
# time so terms fold straight into the unrolled chain with no stacking.
ELEMENTWISE_DENSITIES = {
    "normal": _normal,
    "std_normal": lambda y: _normal(y, 0.0, 1.0),
    "cauchy": _cauchy,
    "student_t": _student_t,
    "exponential": _exponential,
    "gamma": _gamma,
    "inv_gamma": _inv_gamma,
    "lognormal": _lognormal,
    "beta": _beta,
    "uniform": _uniform,
    "double_exponential": _double_exponential,
    "chi_square": _chi_square,
    "inv_chi_square": _inv_chi_square,
    "scaled_inv_chi_square": _scaled_inv_chi_square,
    "logistic": _logistic,
    "gumbel": _gumbel,
    "weibull": _weibull,
    "frechet": _frechet,
    "pareto": _pareto,
    "pareto_type_2": _pareto_type_2,
    "rayleigh": _rayleigh,
    "skew_normal": _skew_normal,
    "von_mises": _von_mises,
    "exp_mod_normal": _exp_mod_normal,
    "poisson": _poisson,
    "poisson_log": _poisson_log,
    "bernoulli": _bernoulli,
    "bernoulli_logit": _bernoulli_logit,
    "binomial": _binomial,
    "binomial_logit": _binomial_logit,
    "neg_binomial_2": _neg_binomial_2,
    "neg_binomial_2_log": _neg_binomial_2_log,
}

DISTRIBUTIONS = {k: _lp(v) for k, v in ELEMENTWISE_DENSITIES.items()}

# User-callable `<dist>_lcdf(y | ...)` / `<dist>_lccdf(y | ...)`: Stan sums
# the elementwise log-CDFs over containers (and `<dist>_cdf` is the
# product, i.e. exp of the sum — handled in the compiler).
LCDFS = {k: _lp(v) for k, v in ELEMENTWISE_LCDFS.items()}
LCCDFS = {k: _lp(v) for k, v in ELEMENTWISE_LCCDFS.items()}


# ---- joint (non-elementwise) densities ----
# These take whole vectors/matrices and are NOT wrapped by _lp (no
# broadcast-and-sum semantics) and not taken per element (the compiler's
# _dist_scalarized only consults ELEMENTWISE_DENSITIES).

def _as_arr(x):
    """A value as a floating tensor of the evaluation's dtype and device."""
    if isinstance(x, RowVector):
        x = x.data
    return to_tensor(x)


def _atleast_2d(t):
    return t.reshape(1, -1) if t.dim() < 2 else t


def _mvn_chol_core(y, mu, chol):
    """Shared MVN log-density given the lower Cholesky factor. `y` may be a
    single (D,) vector or Stan's vectorized (N, D) array-of-vectors (mu
    broadcasting across rows); the per-observation normalizer is counted
    once per ROW."""
    y2 = _atleast_2d(_as_arr(y))  # (N, D)
    n, d = y2.shape
    diff = y2 - _as_arr(mu)
    z = torch.linalg.solve_triangular(chol, diff.T, upper=False)
    return -0.5 * torch.sum(z * z) - n * (torch.sum(torch.log(torch.diagonal(chol))) + d * LOG_SQRT_2PI)


def _multi_normal(y, mu, sigma):
    return _mvn_chol_core(y, mu, _cholesky(_as_arr(sigma)))


def _multi_normal_cholesky(y, mu, chol):
    return _mvn_chol_core(y, mu, _as_arr(chol))


def _dirichlet(theta, alpha):
    theta, alpha = _as_arr(theta), _as_arr(alpha)
    return (
        torch.sum((alpha - 1.0) * torch.log(theta))
        + torch.lgamma(torch.sum(alpha))
        - torch.sum(torch.lgamma(alpha))
    )


def _lkj_corr_cholesky(chol, eta):
    """LKJ density on a correlation Cholesky factor, UNNORMALIZED (Stan's
    c_K(eta) constant is omitted; eta must be DATA, so the constant cancels
    in gradients, acceptance ratios, and the tempering split). A parameter
    eta is rejected: the omitted constant depends on eta, so its gradient
    would be silently wrong."""
    if is_tensor(eta):
        raise ValueError(
            "lkj_corr_cholesky requires a data-derived eta (its "
            "normalizing constant, omitted here, depends on eta — a "
            "parameter eta would get a wrong gradient)"
        )
    chol = _as_arr(chol)
    k = chol.shape[-1]
    diag = torch.diagonal(chol)[1:]
    expo = k - torch.arange(2, k + 1, dtype=chol.dtype, device=chol.device) + 2.0 * float(eta) - 2.0
    return torch.sum(expo * torch.log(diag))


def _cholesky(m):
    """The lower Cholesky factor, NaN throughout for a matrix that is not
    positive definite, as jnp.linalg.cholesky gives it (torch.linalg.cholesky
    raises, and a proposed covariance may lose definiteness to float32
    rounding mid-run)."""
    chol, info = torch.linalg.cholesky_ex(m)
    return torch.where((info == 0)[..., None, None], chol, torch.full_like(chol, math.nan))


def _inverse(m):
    """The inverse, NaN throughout for a singular matrix (torch.linalg.inv
    raises; jnp.linalg.inv returns inf or NaN)."""
    inv, info = torch.linalg.inv_ex(_as_arr(m))
    return torch.where((info == 0)[..., None, None], inv, torch.full_like(inv, math.nan))


def _logdet_spd(m):
    """(log det, lower Cholesky factor) of a symmetric positive-definite
    matrix."""
    chol = _cholesky(_as_arr(m))
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol))), chol


def _lmultigamma(k, a):
    """Log multivariate gamma log Γ_K(a) (Wishart normalizers); `k` is a
    static Python int, `a` may depend on the parameters."""
    j = torch.arange(1, k + 1, dtype=_ev().dtype, device=_ev().device)
    return (k * (k - 1) / 4.0) * math.log(math.pi) + torch.sum(torch.lgamma(_as_arr(a) + (1.0 - j) / 2.0))


def _lkj_corr(sigma, eta):
    """LKJ density on a full correlation matrix, UNNORMALIZED like
    _lkj_corr_cholesky (same data-eta requirement, same rationale):
    log p = (eta - 1) log det Sigma."""
    if is_tensor(eta):
        raise ValueError(
            "lkj_corr requires a data-derived eta (its normalizing "
            "constant, omitted here, depends on eta — a parameter eta "
            "would get a wrong gradient)"
        )
    ld, _ = _logdet_spd(sigma)
    return (float(eta) - 1.0) * ld


def _wishart(w, nu, s):
    """Fully-normalized Wishart log-density W ~ Wishart(nu, S) — the
    constants stay because nu/S may be parameters (unlike the LKJ eta)."""
    w = _as_arr(w)
    k = w.shape[-1]
    kf = float(k)
    nu = _as_arr(nu)
    ldw, _ = _logdet_spd(w)
    lds, chol_s = _logdet_spd(s)
    tr = torch.trace(torch.cholesky_solve(w, chol_s))
    return (
        0.5 * (nu - kf - 1.0) * ldw - 0.5 * tr - 0.5 * nu * kf * math.log(2.0)
        - 0.5 * nu * lds - _lmultigamma(k, 0.5 * nu)
    )


def _inv_wishart(w, nu, s):
    """Fully-normalized inverse-Wishart log-density W ~ InvWishart(nu, S)."""
    w = _as_arr(w)
    k = w.shape[-1]
    kf = float(k)
    nu = _as_arr(nu)
    ldw, chol_w = _logdet_spd(w)
    lds, _ = _logdet_spd(s)
    tr = torch.trace(torch.cholesky_solve(_as_arr(s), chol_w))
    return (
        0.5 * nu * lds - 0.5 * (nu + kf + 1.0) * ldw - 0.5 * tr
        - 0.5 * nu * kf * math.log(2.0) - _lmultigamma(k, 0.5 * nu)
    )


def gather(values, idx, axis=0):
    """values.index_select(axis, idx) for a tensor and 0-based data indices
    (an int array or int), as a select by mask and a sum: its gradient is a
    select too, where index_select's (index_add) adds with atomics on a GPU,
    in an order that changes from call to call. Exact forward values, an
    infinite element included."""
    idx = np.asarray(idx, dtype=np.int64)
    v = torch.movedim(values, axis, 0)
    size = v.shape[0]
    mask = np.zeros(idx.shape + (size,), dtype=bool)
    mask.reshape(-1, size)[np.arange(idx.size), idx.reshape(-1)] = True
    mask_t = torch.as_tensor(mask, device=v.device).reshape(mask.shape + (1,) * (v.dim() - 1))
    out = torch.where(mask_t, v, torch.zeros((), dtype=v.dtype, device=v.device)).sum(idx.ndim)
    return torch.movedim(out, idx.ndim - 1, axis) if idx.ndim else out


def _int_index(y):
    """Data outcomes (1-based ints) as 0-based numpy indices."""
    y = _as_value(y)
    if is_tensor(y):  # data that `apply` lifted beside the parameters
        with untraced():
            y = y.detach().cpu().numpy()
    return np.asarray(y, dtype=np.float64).astype(np.int64) - 1


def _categorical(y, theta):
    """categorical_lpmf: y is 1-based data int(s), theta a simplex."""
    return torch.sum(torch.log(gather(_as_arr(theta), _int_index(y))))


def _categorical_logit(y, beta):
    ls = torch.log_softmax(_as_arr(beta), dim=-1)
    return torch.sum(gather(ls, _int_index(y)))


def _multinomial(y, theta):
    y, theta = _as_arr(y), _as_arr(theta)
    return torch.lgamma(torch.sum(y) + 1.0) - torch.sum(torch.lgamma(y + 1.0)) + torch.sum(y * torch.log(theta))


def _ordered_logistic(y, eta, c):
    """ordered_logistic_lpmf: P(y=k) = logit^-1(eta - c_{k-1}) -
    logit^-1(eta - c_k) with c_0 = -inf, c_K = +inf (pairs with the
    `ordered` cutpoint type). Stable via log_sigmoid + log1m_exp; y may be
    a data int array with eta broadcasting elementwise."""
    yi = _int_index(y) + 1
    eta, c = _as_arr(eta), _as_arr(c)
    inf = torch.full((1,), math.inf, dtype=c.dtype, device=c.device)
    cpad = torch.cat([-inf, c, inf])
    a = eta - gather(cpad, yi - 1)  # >= b elementwise
    b = eta - gather(cpad, yi)
    la = torch.nn.functional.logsigmoid(a)
    lb = torch.nn.functional.logsigmoid(b)
    return torch.sum(la + torch.log(-torch.expm1(lb - la)))


def _multi_student_t(y, nu, mu, sigma):
    """Multivariate Student-t log-density; like _mvn_chol_core, `y` may be
    one (D,) vector or an (N, D) array-of-vectors (normalizer per row)."""
    y2 = _atleast_2d(_as_arr(y))
    n, d = y2.shape
    nu = _as_arr(nu)
    chol = _cholesky(_as_arr(sigma))
    diff = y2 - _as_arr(mu)
    z = torch.linalg.solve_triangular(chol, diff.T, upper=False)
    maha = torch.sum(z * z, dim=0)  # (N,)
    df = float(d)
    norm = (
        torch.lgamma((nu + df) / 2.0) - torch.lgamma(nu / 2.0)
        - 0.5 * df * torch.log(nu * math.pi) - torch.sum(torch.log(torch.diagonal(chol)))
    )
    return torch.sum(-(nu + df) / 2.0 * torch.log1p(maha / nu)) + n * norm


# ---- GLM fused densities ----
# Stan Math's *_glm families: the linear predictor eta = alpha + X @ beta
# computed once as a matrix product and fed to the elementwise density,
# summed. alpha broadcasts (scalar or per-row vector).

def _glm_eta(x, alpha, beta):
    return _as_arr(alpha) + _as_arr(x) @ _as_arr(beta)


def _normal_id_glm(y, x, alpha, beta, sigma):
    return torch.sum(_normal(_as_arr(y), _glm_eta(x, alpha, beta), _as_arr(sigma)))


def _bernoulli_logit_glm(y, x, alpha, beta):
    return torch.sum(_bernoulli_logit(_as_arr(y), _glm_eta(x, alpha, beta)))


def _poisson_log_glm(y, x, alpha, beta):
    return torch.sum(_poisson_log(_as_arr(y), _glm_eta(x, alpha, beta)))


def _neg_binomial_2_log_glm(y, x, alpha, beta, phi):
    return torch.sum(_neg_binomial_2_log(_as_arr(y), _glm_eta(x, alpha, beta), _as_arr(phi)))


def _ordered_logistic_glm(y, x, beta, c):
    return _ordered_logistic(y, _glm_eta(x, 0.0, beta), c)


DISTRIBUTIONS.update(
    normal_id_glm=_normal_id_glm,
    bernoulli_logit_glm=_bernoulli_logit_glm,
    poisson_log_glm=_poisson_log_glm,
    neg_binomial_2_log_glm=_neg_binomial_2_log_glm,
    ordered_logistic_glm=_ordered_logistic_glm,
    multi_student_t=_multi_student_t,
    categorical=_categorical,
    categorical_logit=_categorical_logit,
    multinomial=_multinomial,
    ordered_logistic=_ordered_logistic,
    multi_normal=_multi_normal,
    multi_normal_cholesky=_multi_normal_cholesky,
    dirichlet=_dirichlet,
    lkj_corr_cholesky=_lkj_corr_cholesky,
    lkj_corr=_lkj_corr,
    wishart=_wishart,
    inv_wishart=_inv_wishart,
)


# ---- orientation ----


class RowVector:
    """A 1-D value tagged with ROW orientation (Stan's `row_vector`).

    Stan distinguishes column vectors from row vectors in its type system;
    this frontend's value layer is shape-based (1-D = column vector), so row
    orientation rides as this lightweight tag. The payload is a 1-D numpy
    array or tensor. Orientation-aware sites (transpose, `*`,
    append_row/col, indexing — compiler._binop / _index_read) inspect the
    tag; everything else unwraps through `_as_arr` / compiler's `_as_value`
    and treats the payload like any 1-D value.
    """

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data

    def __repr__(self):
        return f"RowVector({self.data!r})"


def is_row(v) -> bool:
    return isinstance(v, RowVector)


# ---- scalar / container builtins ----
# Called through `apply`: array arguments are tensors (of the evaluation's
# dtype, or float64 on the host for data alone), scalars may be numbers.


def _transpose(x):
    """Stan `'`: matrix -> matrix.T; vector <-> row_vector; scalar id."""
    if isinstance(x, RowVector):
        return _as_arr(x)
    a = _as_arr(x)
    if a.dim() == 2:
        return a.T
    if a.dim() == 1:
        return RowVector(a)
    return a


def _orient_preserving(f):
    """Wrap a vector->vector builtin so a RowVector input keeps its
    orientation (Stan: head/tail/segment/reverse/sort of a row_vector
    return a row_vector)."""

    def g(v, *rest):
        out = f(_as_arr(v), *rest)
        return RowVector(out) if isinstance(v, RowVector) else out

    return g


def _atleast_1d(t):
    return t.reshape(1) if t.dim() == 0 else t


def _append_row(a, b):
    """Stan append_row: matrices/row_vectors stack rows; vectors/scalars
    concatenate. A row_vector argument acts as a 1-row matrix (so
    append_row(r1', r2') builds a 2 x N matrix, matching Stan)."""
    if is_row(a) or is_row(b):
        return torch.cat([_atleast_2d(_as_arr(a)), _atleast_2d(_as_arr(b))])
    a2, b2 = _as_arr(a), _as_arr(b)
    if a2.dim() <= 1 and b2.dim() <= 1:
        return torch.cat([_atleast_1d(a2), _atleast_1d(b2)])
    return torch.cat([_atleast_2d(a2), _atleast_2d(b2)])


def _append_col(a, b):
    """Stan append_col: matrices/vectors stack columns; row_vectors and
    scalars CONCATENATE into a longer row_vector. For untracked 1-D values
    the legacy conventions hold: scalar+1-D concatenates (the row-vector
    idiom), 1-D+1-D column-stacks to (N, 2) (the design-matrix idiom)."""
    if is_row(a) or is_row(b):
        ar, br = _as_arr(a), _as_arr(b)
        if ar.dim() <= 1 and br.dim() <= 1:
            return RowVector(torch.cat([_atleast_1d(ar), _atleast_1d(br)]))
        raise ValueError("append_col: cannot mix a row_vector with a matrix/vector")
    a2, b2 = _as_arr(a), _as_arr(b)
    if a2.dim() == 0 or b2.dim() == 0:
        return torch.cat([_atleast_1d(a2), _atleast_1d(b2)])
    if a2.dim() == 1 and b2.dim() == 1:
        return torch.stack([a2, b2], dim=1)
    if a2.dim() == 1:
        a2 = a2[:, None]
    if b2.dim() == 1:
        b2 = b2[:, None]
    return torch.cat([a2, b2], dim=1)


def _rep_matrix(x, m, n=None):
    if n is None:  # rep_matrix(vector, n): the vector as n identical columns
        return _as_arr(x)[:, None].repeat(1, int(m))
    return _as_arr(x).expand(int(m), int(n)).clone()


def _to_matrix(v, m=None, n=None):
    if m is None:
        return _atleast_2d(_as_arr(v))
    # Stan fills COLUMN-major
    return torch.reshape(_as_arr(v), (int(n), int(m))).T


def _flatten_colmajor(x):
    """Stan's to_vector/to_row_vector flatten matrices COLUMN-major
    (round-trips with _to_matrix's column-major fill)."""
    a = _as_arr(x)
    return a.T.reshape(-1) if a.dim() == 2 else a.reshape(-1)


def _lchoose(n, k):
    """log binomial coefficient; -inf outside 0 <= k <= n (Stan rejects
    there — we take the lccdf-friendly -inf) and lgamma-safe inside."""
    n2, k2 = _as_arr(n), _as_arr(k)
    valid = (k2 >= 0.0) & (k2 <= n2)
    ks = torch.where(valid, k2, 0.0)
    val = torch.lgamma(n2 + 1.0) - torch.lgamma(ks + 1.0) - torch.lgamma(n2 - ks + 1.0)
    return torch.where(valid, val, -math.inf)


def _choose(n, k):
    n2, k2 = _as_arr(n), _as_arr(k)
    valid = (k2 >= 0.0) & (k2 <= n2)
    return torch.where(valid, torch.round(torch.exp(_lchoose(n2, torch.where(valid, k2, 0.0)))), 0.0)


def _hmm_marginal(log_omegas, gamma, rho):
    """Stan's hmm_marginal: log marginal likelihood of an HMM by the forward
    algorithm in log space. log_omegas is (K states, N obs) per-state
    observation log-likelihoods, Gamma the (K, K) transition matrix (row i =
    distribution from state i), rho the initial state distribution. A loop
    over observations, the JAX module's lax.scan step by step."""
    lo = _as_arr(log_omegas)
    lg = torch.log(_as_arr(gamma))
    lalpha = torch.log(_as_arr(rho)) + lo[:, 0]
    for t in range(1, lo.shape[1]):
        lalpha = torch.logsumexp(lalpha[:, None] + lg, dim=0) + lo[:, t]
    return torch.logsumexp(lalpha, dim=0)


def _gp_exp_quad_cov(*a):
    """cov_exp_quad(x, alpha, rho) / cov_exp_quad(x1, x2, alpha, rho) (and
    the 2.26+ gp_exp_quad_cov names): squared-exponential kernel
    alpha^2 exp(-d^2 / (2 rho^2)); x entries may be reals (1-D array) or
    vectors (rows of a 2-D array). One batched distance computation."""
    if len(a) == 3:
        x1, x2, (alpha, rho) = a[0], a[0], a[1:]
    else:
        x1, x2, (alpha, rho) = a[0], a[1], a[2:]
    xa, xb = _as_arr(x1), _as_arr(x2)
    alpha, rho = _as_arr(alpha), _as_arr(rho)
    if xa.dim() == 1:
        d2 = (xa[:, None] - xb[None, :]) ** 2
    else:
        d2 = torch.sum((xa[:, None, :] - xb[None, :, :]) ** 2, dim=-1)
    return alpha * alpha * torch.exp(-0.5 * d2 / (rho * rho))


def _log_mix(*a):
    if len(a) == 2:  # log_mix(simplex theta, vector lp)
        theta, lps = _as_arr(a[0]), _as_arr(a[1])
        return torch.logsumexp(torch.log(theta) + lps, dim=0)
    theta, lp1, lp2 = (_as_arr(v) for v in a)
    return torch.logaddexp(torch.log(theta) + lp1, torch.log1p(-theta) + lp2)


def _log_sum_exp(*a):
    if len(a) > 1:
        return torch.logsumexp(torch.stack(torch.broadcast_tensors(*(_as_arr(x) for x in a))), dim=0)
    return torch.logsumexp(_as_arr(a[0]).reshape(-1), dim=0)


def _t1(fn):
    """A unary torch function of one array argument (cast to float)."""
    return lambda x: fn(_as_arr(x))


def _t2(fn):
    """A binary torch function of two array arguments."""
    return lambda x, y: fn(*torch.broadcast_tensors(_as_arr(x), _as_arr(y)))


def _multiply_log(x, y):
    x, y = _as_arr(x), _as_arr(y)
    return torch.where((x == 0.0) & (y == 0.0), 0.0, x * torch.log(y))


def _size(m):
    shape = tuple(_as_arr(m).shape)
    return int(shape[0]) if shape else 1


def _std(x, var=False):
    a = _as_arr(x).reshape(-1)
    v = torch.sum((a - torch.mean(a)) ** 2) / (a.numel() - 1)
    return v if var else torch.sqrt(v)


FUNCTIONS = {
    "exp": _t1(torch.exp),
    "log": _t1(torch.log),
    "log1p": _t1(torch.log1p),
    "log1m": lambda x: torch.log1p(-_as_arr(x)),
    # log(1 + exp(x)) / log(1 - exp(x)), overflow-safe (Stan 2.x names).
    "log1p_exp": lambda x: _softplus(_as_arr(x)),
    "log1m_exp": lambda x: torch.log(-torch.expm1(_as_arr(x))),
    "log_inv_logit": lambda x: _log_sigmoid_stable(_as_arr(x)),
    "log1m_inv_logit": lambda x: _log_sigmoid_stable(-_as_arr(x)),
    # Stan overloads log2/log10 by arity: nullary = the constant ln 2 /
    # ln 10 (Stan functions reference "mathematical constants").
    "log2": lambda *a: torch.log2(_as_arr(a[0])) if a else math.log(2.0),
    "log10": lambda *a: torch.log10(_as_arr(a[0])) if a else math.log(10.0),
    # Nullary constants (Stan functions reference 3.1-3.2).
    "pi": lambda: math.pi,
    "e": lambda: math.e,
    "sqrt2": lambda: math.sqrt(2.0),
    "positive_infinity": lambda: math.inf,
    "negative_infinity": lambda: -math.inf,
    "not_a_number": lambda: math.nan,
    "machine_precision": lambda: float(np.finfo(np.float32).eps),
    # Container slicing (static sizes, as everywhere in this frontend).
    "head": _orient_preserving(lambda v, n: v[: int(n)]),
    # explicit start index: [-0:] would be the WHOLE vector for n=0
    "tail": _orient_preserving(lambda v, n: v[v.shape[0] - int(n):]),
    "segment": _orient_preserving(lambda v, i, n: v[int(i) - 1: int(i) - 1 + int(n)]),
    # Matrix helpers for the Cholesky-factor hierarchical idiom.
    "diag_pre_multiply": lambda d, m: _as_arr(d)[:, None] * _as_arr(m),
    "diag_post_multiply": lambda m, d: _as_arr(m) * _as_arr(d)[None, :],
    "multiply_lower_tri_self_transpose": lambda L: _as_arr(L) @ _as_arr(L).T,
    "cholesky_decompose": lambda m: _cholesky(_as_arr(m)),
    "sqrt": _t1(torch.sqrt),
    "square": lambda x: _as_arr(x) ** 2,
    "cbrt": lambda x: torch.sign(_as_arr(x)) * torch.abs(_as_arr(x)) ** (1.0 / 3.0),
    "abs": _t1(torch.abs),
    "fabs": _t1(torch.abs),
    "inv": lambda x: 1.0 / _as_arr(x),
    "inv_sqrt": lambda x: 1.0 / torch.sqrt(_as_arr(x)),
    "inv_logit": _t1(torch.sigmoid),
    "logit": _t1(torch.logit),
    "lgamma": _t1(torch.lgamma),
    "tgamma": lambda x: torch.exp(torch.lgamma(_as_arr(x))),
    "digamma": _t1(torch.digamma),
    "pow": lambda x, y: _as_arr(x) ** (y if not is_tensor(y) else _as_arr(y)),
    "fmin": _t2(torch.minimum),
    "fmax": _t2(torch.maximum),
    "fmod": _t2(torch.fmod),
    "floor": _t1(torch.floor),
    "ceil": _t1(torch.ceil),
    "round": _t1(torch.round),
    "sin": _t1(torch.sin),
    "cos": _t1(torch.cos),
    "tan": _t1(torch.tan),
    "asin": _t1(torch.asin),
    "acos": _t1(torch.acos),
    "atan": _t1(torch.atan),
    "atan2": _t2(torch.atan2),
    "sinh": _t1(torch.sinh),
    "cosh": _t1(torch.cosh),
    "tanh": _t1(torch.tanh),
    "expm1": _t1(torch.expm1),
    "erf": _t1(torch.erf),
    "erfc": _t1(torch.erfc),
    "Phi": _t1(torch.special.ndtr),
    "inv_Phi": _t1(torch.special.ndtri),
    # Stan's logistic approximation to Phi (reference manual definition).
    "Phi_approx": lambda x: torch.sigmoid(0.07056 * _as_arr(x) ** 3 + 1.5976 * _as_arr(x)),
    "log_sum_exp": _log_sum_exp,
    "log_mix": _log_mix,
    "log_diff_exp": lambda a, b: _as_arr(a) + torch.log(-torch.expm1(_as_arr(b) - _as_arr(a))),
    "append_row": _append_row,
    "append_col": _append_col,
    "rep_matrix": _rep_matrix,
    "to_matrix": _to_matrix,
    "to_row_vector": lambda x: RowVector(_flatten_colmajor(x)),
    "columns_dot_product": lambda a, b: torch.sum(_as_arr(a) * _as_arr(b), dim=0),
    "rows_dot_product": lambda a, b: torch.sum(_as_arr(a) * _as_arr(b), dim=1),
    "cov_exp_quad": _gp_exp_quad_cov,
    "gp_exp_quad_cov": _gp_exp_quad_cov,
    "hmm_marginal": _hmm_marginal,
    # multiply_log/lmultiply: x * log(y) with the 0 * log(0) = 0 convention
    "multiply_log": _multiply_log,
    "lmultiply": _multiply_log,
    "lchoose": _lchoose,
    "choose": _choose,
    "step": lambda x: torch.where(_as_arr(x) >= 0.0, 1.0, 0.0).to(_as_arr(x).dtype),
    "int_step": lambda x: torch.where(_as_arr(x) > 0.0, 1.0, 0.0).to(_as_arr(x).dtype),
    "fdim": lambda x, y: torch.clamp_min(_as_arr(x) - _as_arr(y), 0.0),
    "hypot": _t2(torch.hypot),
    "sort_asc": _orient_preserving(lambda v: torch.sort(v).values),
    "sort_desc": _orient_preserving(lambda v: torch.flip(torch.sort(v).values, (0,))),
    "sort_indices_asc": lambda v: torch.argsort(_as_arr(v), stable=True) + 1,
    "sort_indices_desc": lambda v: torch.argsort(-_as_arr(v), stable=True) + 1,
    "rank": lambda v, i: torch.sum(_as_arr(v) < _as_arr(v)[int(i) - 1]),
    "add_diag": lambda m, v: _as_arr(m) + (
        torch.diag(_as_arr(v)) if _ndim(v) == 1
        else torch.eye(_as_arr(m).shape[0], dtype=_as_arr(m).dtype,
                       device=_as_arr(m).device) * _as_arr(v)
    ),
    "softmax": lambda x: torch.softmax(_as_arr(x), dim=-1),
    "log_softmax": lambda x: torch.log_softmax(_as_arr(x), dim=-1),
    # containers
    "sum": lambda x: torch.sum(_as_arr(x)),
    "prod": lambda x: torch.prod(_as_arr(x)),
    "mean": lambda x: torch.mean(_as_arr(x)),
    "sd": _std,
    "variance": lambda x: _std(x, var=True),
    "min": lambda x: torch.min(_as_arr(x)),
    "max": lambda x: torch.max(_as_arr(x)),
    "dot_product": lambda a, b: torch.sum(_as_arr(a) * _as_arr(b)),
    "dot_self": lambda a: torch.sum(_as_arr(a) * _as_arr(a)),
    "cumulative_sum": _orient_preserving(lambda v: torch.cumsum(v, dim=0)),
    "reverse": _orient_preserving(lambda x: torch.flip(x, (0,))),
    "transpose": _transpose,
    "col": lambda m, j: _as_arr(m)[:, int(j) - 1],
    "row": lambda m, i: RowVector(_as_arr(m)[int(i) - 1, :]),
    "diag_matrix": lambda v: torch.diag(_as_arr(v)),
    "diagonal": lambda m: torch.diagonal(_as_arr(m)),
    "rep_vector": lambda v, n: _as_arr(v).expand(int(n)).clone(),
    "rep_row_vector": lambda v, n: RowVector(_as_arr(v).expand(int(n)).clone()),
    "rep_array": lambda v, n: _as_arr(v).expand(int(n)).clone(),
    "to_vector": _flatten_colmajor,
    "to_array_1d": lambda x: _as_arr(x).reshape(-1),
    # matrix algebra (pairs with the corr_matrix/cov_matrix parameter types)
    "trace": lambda m: torch.trace(_as_arr(m)),
    "inverse": _inverse,
    "inverse_spd": _inverse,
    "determinant": lambda m: torch.linalg.det(_as_arr(m)),
    "log_determinant": lambda m: torch.linalg.slogdet(_as_arr(m))[1],
    # quad_form(A, B) = B' A B; a vector B gives a scalar, a matrix B a
    # matrix — one expression covers both.
    "quad_form": lambda a, b: _as_arr(b).mT @ _as_arr(a) @ _as_arr(b)
    if _as_arr(b).dim() == 2 else _as_arr(b) @ _as_arr(a) @ _as_arr(b),
    "quad_form_sym": lambda a, b: _as_arr(b).mT @ _as_arr(a) @ _as_arr(b)
    if _as_arr(b).dim() == 2 else _as_arr(b) @ _as_arr(a) @ _as_arr(b),
    "quad_form_diag": lambda m, v: _as_arr(m) * torch.outer(_as_arr(v), _as_arr(v)),
    "crossprod": lambda m: _as_arr(m).T @ _as_arr(m),
    "tcrossprod": lambda m: _as_arr(m) @ _as_arr(m).T,
    "mdivide_left_tri_low": lambda a, b: _solve_tri(_as_arr(a), _as_arr(b)),
    "mdivide_left_spd": lambda a, b: _cho_solve(_as_arr(a), _as_arr(b)),
    "squared_distance": lambda a, b: torch.sum((_as_arr(a) - _as_arr(b)) ** 2),
    "distance": lambda a, b: torch.sqrt(torch.sum((_as_arr(a) - _as_arr(b)) ** 2)),
    # Shape queries return static Python ints (usable as loop bounds).
    "rows": lambda m: int(_as_arr(m).shape[0]),
    "cols": lambda m: int(_as_arr(m).shape[1]),
    "num_elements": lambda m: int(_as_arr(m).numel()),
    "size": _size,
}


def _solve_tri(a, b):
    vec = b.dim() == 1
    out = torch.linalg.solve_triangular(a, b[:, None] if vec else b, upper=False)
    return out[:, 0] if vec else out


def _cho_solve(a, b):
    vec = b.dim() == 1
    out = torch.cholesky_solve(b[:, None] if vec else b, _cholesky(a))
    return out[:, 0] if vec else out


# ---- RNG functions (generated quantities only) ----
#
# The reference evaluates generated quantities inside `constrain` with a
# FIXED-SEED RNG (bridgestan.py:106-120, new_rng(seed=0)) so constrained
# estimates are deterministic. The JAX module folds a fixed key per call
# site; threefry's bits cannot be reproduced in torch, so the port draws
# from torch's generator seeded per call site (the compiler's
# `_Interp._rng_seed`), which makes `constrain` deterministic from run to run
# and equal to JAX's draws in distribution, not in value.

def _bshape(*args):
    return torch.broadcast_shapes(*(tuple(_as_arr(a).shape) for a in args))


def _like_args(*args):
    t = _as_arr(args[0]) if args else torch.zeros((), dtype=_ev().dtype, device=_ev().device)
    return t.dtype, t.device


def _randn(shape, *args):
    dtype, device = _like_args(*args)
    return torch.randn(shape, dtype=dtype, device=device)


def _rand(shape, *args):
    dtype, device = _like_args(*args)
    return torch.rand(shape, dtype=dtype, device=device)


def _exponential_draw(shape, *args):
    return -torch.log1p(-_rand(shape, *args))


def _gamma_draw(alpha, shape=None):
    a = _as_arr(alpha)
    if shape is not None:
        a = a.expand(shape)
    return torch._standard_gamma(a.contiguous())


def _normal_rng(mu, sigma):
    return _as_arr(mu) + _as_arr(sigma) * _randn(_bshape(mu, sigma), mu)


def _binomial_draw(n, p):
    n, p = torch.broadcast_tensors(_as_arr(n), _as_arr(p))
    trials = int(n.max()) if n.numel() else 0
    u = _rand((trials,) + tuple(p.shape), p)
    idx = torch.arange(trials, dtype=p.dtype, device=p.device).reshape((trials,) + (1,) * p.dim())
    return torch.sum(((u < p) & (idx < n)).to(p.dtype), dim=0)


def _categorical_draw(logits):
    logits = _as_arr(logits)
    g = -torch.log(_exponential_draw(logits.shape, logits))
    return (torch.argmax(logits + g, dim=-1) + 1).to(logits.dtype)


def _student_t_draw(nu, shape):
    z = _randn(shape, nu)
    return z * torch.rsqrt(2.0 * _gamma_draw(_as_arr(nu) / 2.0, shape) / _as_arr(nu))


RNG_FUNCTIONS = {
    "normal": _normal_rng,
    "std_normal": lambda: _randn(()),
    "uniform": lambda a, b: _as_arr(a) + (_as_arr(b) - _as_arr(a)) * _rand(_bshape(a, b), a),
    "exponential": lambda rate: _exponential_draw(_bshape(rate), rate) / _as_arr(rate),
    "gamma": lambda alpha, beta: _gamma_draw(alpha, _bshape(alpha, beta)) / _as_arr(beta),
    "inv_gamma": lambda alpha, beta: _as_arr(beta) / _gamma_draw(alpha, _bshape(alpha, beta)),
    "beta": lambda a, b: (lambda ga, gb: ga / (ga + gb))(
        _gamma_draw(a, _bshape(a, b)), _gamma_draw(b, _bshape(a, b))),
    "lognormal": lambda mu, sigma: torch.exp(_normal_rng(mu, sigma)),
    "cauchy": lambda mu, gamma: _as_arr(mu) + _as_arr(gamma) * torch.tan(
        math.pi * (_rand(_bshape(mu, gamma), mu) - 0.5)),
    "student_t": lambda nu, mu, sigma: _as_arr(mu) + _as_arr(sigma) * _student_t_draw(
        nu, _bshape(nu, mu, sigma)),
    "chi_square": lambda nu: 2.0 * _gamma_draw(_as_arr(nu) / 2.0),
    "inv_chi_square": lambda nu: 0.5 / _gamma_draw(_as_arr(nu) / 2.0),
    "scaled_inv_chi_square": lambda nu, s: (
        _as_arr(nu) * _as_arr(s) ** 2 / 2.0) / _gamma_draw(_as_arr(nu) / 2.0),
    "logistic": lambda mu, s: _as_arr(mu) + _as_arr(s) * torch.logit(_rand(_bshape(mu, s), mu)),
    "gumbel": lambda mu, b: _as_arr(mu) - _as_arr(b) * torch.log(
        _exponential_draw(_bshape(mu, b), mu)),
    "weibull": lambda a, s: _as_arr(s) * _exponential_draw(_bshape(a, s), a) ** (1.0 / _as_arr(a)),
    "frechet": lambda a, s: _as_arr(s) * _exponential_draw(_bshape(a, s), a) ** (-1.0 / _as_arr(a)),
    "pareto": lambda ym, a: _as_arr(ym) * torch.exp(
        _exponential_draw(_bshape(ym, a), ym) / _as_arr(a)),
    "pareto_type_2": lambda mu, lam, a: _as_arr(mu) + _as_arr(lam) * (
        torch.exp(_exponential_draw(_bshape(mu, lam, a), mu) / _as_arr(a)) - 1.0),
    "rayleigh": lambda s: _as_arr(s) * torch.sqrt(2.0 * _exponential_draw(_bshape(s), s)),
    "double_exponential": lambda mu, sigma: _as_arr(mu) - _as_arr(sigma) * torch.sign(
        _rand(_bshape(mu, sigma), mu) - 0.5) * torch.log1p(-torch.abs(
            2.0 * _rand(_bshape(mu, sigma), mu) - 1.0)),
    "poisson": lambda lam: torch.poisson(_as_arr(lam).expand(_bshape(lam)).contiguous()),
    "poisson_log": lambda log_lam: torch.poisson(torch.exp(_as_arr(log_lam))),
    "bernoulli": lambda p: (_rand(_bshape(p), p) < _as_arr(p)).to(_as_arr(p).dtype),
    "bernoulli_logit": lambda alpha: (
        _rand(_bshape(alpha), alpha) < torch.sigmoid(_as_arr(alpha))).to(_as_arr(alpha).dtype),
    "binomial": _binomial_draw,
    "categorical": lambda theta: _categorical_draw(torch.log(_as_arr(theta))),
    "categorical_logit": _categorical_draw,
    "dirichlet": lambda alpha: (lambda g: g / torch.sum(g))(_gamma_draw(alpha)),
    "multi_normal": lambda mu, sigma: _as_arr(mu) + torch.linalg.cholesky(_as_arr(sigma)) @ _randn(
        (_as_arr(sigma).shape[0],), mu),
    "multi_normal_cholesky": lambda mu, chol: _as_arr(mu) + _as_arr(chol) @ _randn(
        (_as_arr(chol).shape[0],), mu),
}
