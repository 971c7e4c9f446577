"""Compile a parsed Stan program into a `CallableModel` in torch ops, the
port of `smcnuts_tpu/stan/compiler.py`.

The reference compiles a `.stan` file with BridgeStan into a C++ library and
crosses a per-particle FFI (reference smcnuts/model/bridgestan.py:13-120).
Here, as in the JAX package, the program is interpreted: loops unroll over
the concrete data sizes, data stay numpy arrays and Python numbers (so
bounds, indices and branch conditions on data are concrete), and everything
that depends on the parameters is a tensor. The result is a per-particle
`logprior`, `loglik` and `constrain` in torch ops that `CallableModel`
vmaps and differentiates by autograd (eager, CPU or card), and with
`tile=True` a generated in-kernel model of the same density
(`ops/generated.py`) that runs inside the CUDA NUTS kernel.

Semantics (those of the JAX frontend):

- Parameters are flattened into one unconstrained theta vector in
  declaration order. Constraints map exactly as Stan's transforms with the
  log-Jacobian added to the target (BridgeStan `adjust_transform=True`).
- The tempering split `logp = logprior + phi * loglik` is recovered from the
  program: `loglik(theta) = target(theta, phi=1) - target(theta, phi=0)` and
  `logprior(theta) = target(theta, phi=0) + jacobian(theta)`, exact whenever
  `phi` enters the target linearly. A program without `phi` in its data
  block gets `loglik = 0` and runs untempered.
- `constrain` maps theta to [parameters; transformed parameters; generated
  quantities]; every `*_rng` call in generated quantities draws from torch's
  generator seeded per call site (`_Interp._rng_seed`), so constrained
  estimates are deterministic run to run. JAX's threefry draws are not
  reproduced: the draws agree with JAX's in distribution.
- A parameter-dependent `if`, `while`, loop bound, size or index raises
  StanCompileError, as the JAX tracer's concretisation does. A tensor would
  convert to bool without complaint, so the interpreter checks the kind of
  the value itself: a tensor depends on the parameters, data never become
  tensors on their own.

Not ported: the JAX frontend lowers loops of `scan_threshold` or more
iterations to `lax.scan` for XLA's compile time and states that lowering
bit-identical to the unrolled interpretation; here every loop unrolls, the
semantics, and `scan_threshold` is accepted and ignored. The ODE solvers,
`integrate_1d` and the algebra solvers raise StanCompileError (ROADMAP
Queue 1 item 11b).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any

import numpy as np
import torch

from ..models.base import CallableModel
from . import math as smath
from .math import (
    DISTRIBUTIONS,
    ELEMENTWISE_DENSITIES,
    FUNCTIONS,
    LCCDFS,
    LCDFS,
    LOG_SQRT_2PI,
    RNG_FUNCTIONS,
    RowVector,
    apply,
    is_row,
    is_tensor,
    to_tensor,
    truncated_lp,
    truncation_lognorm,
)
from .parser import (
    Assign,
    Bin,
    Break,
    Call,
    Continue,
    Decl,
    ExprStmt,
    For,
    FuncDef,
    If,
    Index,
    Num,
    Program,
    RangeIdx,
    Reject,
    Return,
    Sampling,
    StanSyntaxError,
    TargetPlus,
    Ternary,
    Unary,
    Var,
    While,
    parse,
)

# What a program that reaches a construct this slice leaves out is told.
NOT_PORTED = "is not ported to smcnuts_torch yet (ROADMAP Queue 1 item 11b)"


class StanCompileError(Exception):
    pass


# ------------------------------------------------------------- values


def _coerce(a, b):
    """numpy arrays meeting a tensor become tensors alike (the evaluation's
    dtype and device); data alone stays data."""
    if is_tensor(a) and isinstance(b, np.ndarray):
        return a, to_tensor(b)
    if is_tensor(b) and isinstance(a, np.ndarray):
        return to_tensor(a), b
    return a, b


def _py(v):
    """numpy scalars (a data element read) as Python numbers."""
    if isinstance(v, np.ndarray) and v.ndim == 0:
        v = v[()]
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def _stack(parts):
    """Stack values: a tensor where any part is one, else a numpy array."""
    if any(is_tensor(p) for p in parts):
        return torch.stack([to_tensor(p) for p in parts])
    return np.stack([np.asarray(p, dtype=np.float64) for p in parts])


def _cat1(parts):
    """Concatenate values as 1-D (each flattened)."""
    if any(is_tensor(p) for p in parts):
        return torch.cat([to_tensor(p).reshape(-1) for p in parts])
    return np.concatenate([np.asarray(p, dtype=np.float64).reshape(-1) for p in parts])


def _ndim(v):
    if is_tensor(v):
        return v.dim()
    return np.ndim(v)


# ------------------------------------------------------------- environments


class _LocalArray:
    """Mutable local container (vector / array / matrix declared in a block).

    Elements live as individual scalars/rows in a nested Python list so that
    unrolled elementwise assignment and reads are pure constant-index Python
    operations; reading the whole container stacks it.
    """

    def __init__(self, dims, fill=None):
        def build(ds):
            if not ds:
                return fill
            return [build(ds[1:]) for _ in range(ds[0])]

        self.dims = tuple(dims)
        self.data = build(list(dims))

    def get(self, idxs):
        node = self.data
        for i in idxs:
            node = node[i - 1]  # Stan is 1-based
        if isinstance(node, list):
            return _stack_nested(node)
        if node is None:
            raise StanCompileError("read of uninitialized local element")
        return node

    def set(self, idxs, value):
        node = self.data
        for i in idxs[:-1]:
            node = node[i - 1]
        node[idxs[-1] - 1] = value

    def as_array(self):
        return _stack_nested(self.data)

    def as_array_filled(self, fill=float("nan")):
        """Like as_array, but uninitialized elements become `fill` (NaN —
        Stan's own value for undefined reals) instead of raising."""

        def conv(node):
            if isinstance(node, list):
                return _stack([conv(x) for x in node])
            return fill if node is None else node

        return conv(self.data)


def _stack_nested(node):
    if isinstance(node, list):
        parts = [_stack_nested(x) for x in node]
        if any(p is None for p in parts):
            raise StanCompileError("whole-container read of a partially-initialized local")
        return _stack(parts)
    return node


def _as_value(v):
    """Collapse a _LocalArray to an array and strip row orientation; pass
    scalars/arrays through. The orientation-BLIND accessor."""
    if isinstance(v, _LocalArray):
        return v.as_array()
    if isinstance(v, RowVector):
        return v.data
    return v


def _as_value_oriented(v):
    """Like _as_value but keeps the RowVector tag (and materializes a
    row-declared _LocalArray as a RowVector)."""
    if isinstance(v, _LocalArray):
        arr = v.as_array()
        return RowVector(arr) if getattr(v, "row", False) else arr
    return v


def _orient(v):
    """(is_row, payload) of a value, materializing containers."""
    if isinstance(v, RowVector):
        return True, v.data
    if isinstance(v, _LocalArray):
        return bool(getattr(v, "row", False)), v.as_array()
    return False, v


# Builtins whose Stan signature/result depends on row/column orientation:
# these receive orientation-tagged arguments.
_ORIENT_FNS = frozenset((
    "transpose", "append_row", "append_col", "head", "tail", "segment",
    "reverse", "sort_asc", "sort_desc", "cumulative_sum", "to_row_vector",
    "to_vector",
))

# Declared types whose trailing axis is a ROW axis: a 1-D read that keeps
# (only) the last axis of such a value is a Stan row_vector.
_ROW_LAST_AXIS_TYPES = frozenset((
    "matrix", "row_vector", "corr_matrix", "cov_matrix",
    "cholesky_factor_corr", "cholesky_factor_cov",
))

_EMPTY: dict = {}


def _require_int(v, what):
    if isinstance(v, (bool, np.bool_)):
        return int(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, float) and v == int(v):
        return int(v)
    raise StanCompileError(
        f"{what} must be a compile-time integer (data-derived); got {v!r}. "
        "Loop bounds, sizes, and indices may not depend on parameters."
    )


_STATIC = (bool, int, float, np.bool_, np.integer, np.floating)


class _FnReturn(Exception):
    """Control-flow carrier for `return` inside a user-defined function."""

    def __init__(self, value):
        self.value = value


class _LoopBreak(Exception):
    """Control-flow carrier for `break` (its guard must be data-derived)."""


class _LoopContinue(Exception):
    """Control-flow carrier for `continue`."""


class _Unanalyzable(Exception):
    """A loop body whose carried state `_body_has_carried_dep` cannot see."""


def _match_loopvar_offset(expr, varname):
    """Structurally match an index expression as loopvar + constant offset:
    `t` -> 0, `t - 2` -> -2, `t + 1`/`1 + t` -> +1. Returns the offset or
    None if the expression is not of that form."""
    if isinstance(expr, Var):
        return 0 if expr.name == varname else None
    if isinstance(expr, Bin) and expr.op in ("+", "-"):
        left, right = expr.left, expr.right
        if (
            isinstance(left, Var) and left.name == varname
            and isinstance(right, Num) and float(right.value).is_integer()
        ):
            k = int(right.value)
            return k if expr.op == "+" else -k
        if (
            expr.op == "+"
            and isinstance(right, Var) and right.name == varname
            and isinstance(left, Num) and float(left.value).is_integer()
        ):
            return int(left.value)
    return None


def _walk_writes(stmts, assigned, declared):
    """Collect names assigned (carried state) and names declared (body
    locals) in a loop body; raise _Unanalyzable on constructs whose carried
    state the analysis cannot follow."""
    for st in stmts:
        if isinstance(st, list):
            _walk_writes(st, assigned, declared)
        elif isinstance(st, Decl):
            declared.add(st.name)
            if st.dims:
                raise _Unanalyzable("container declared inside the loop body")
        elif isinstance(st, Assign):
            lv = st.lvalue
            if isinstance(lv, Var):
                assigned.add(lv.name)
            elif isinstance(lv, Index) and isinstance(lv.base, Var):
                assigned.add(lv.base.name)
            else:
                raise _Unanalyzable("unsupported assignment target")
        elif isinstance(st, For):
            declared.add(st.var)  # loop variable is body-local
            _walk_writes(st.body, assigned, declared)
        elif isinstance(st, If):
            _walk_writes(st.then, assigned, declared)
            _walk_writes(st.other, assigned, declared)
        elif isinstance(st, (While, Return, Break, Continue)):
            raise _Unanalyzable("while/return/break/continue inside the loop body")


# ------------------------------------------------------------- interpreter


# Elementwise builtins that may stay "per element" over a rank-1 container
# in scalarize mode (see _Interp.scalarize) instead of stacking it.
_ELEMENTWISE_FNS = frozenset(
    ("sqrt", "exp", "log", "log1p", "log1m", "log10", "log2", "expm1",
     "square", "fabs", "abs", "inv", "inv_sqrt", "sin", "cos", "tan",
     "sinh", "cosh", "tanh", "cbrt", "logit", "inv_logit", "erf", "erfc",
     "log1p_exp", "log1m_exp", "log_inv_logit", "log1m_inv_logit")
)

# Stan interfaces this slice does not port (ROADMAP Queue 1 item 11b).
_NOT_PORTED_FNS = frozenset({
    "ode_rk45", "ode_rk45_tol", "ode_bdf", "ode_bdf_tol",
    "ode_adams", "ode_adams_tol", "ode_ckrk", "ode_ckrk_tol",
    "integrate_ode_rk45", "integrate_ode_bdf", "integrate_ode_adams",
    "integrate_ode", "ode_rk4", "integrate_1d",
    "algebra_solver", "algebra_solver_newton", "solve_newton", "solve_powell",
})


class _Interp:
    def __init__(self, env, rng_key=None, scalarize=False):
        self.env = env  # name -> value
        self.target = 0.0
        # Generated-model mode: vectorized distribution calls and elementwise
        # builtins over rank-1 containers UNROLL per element instead of
        # stacking the container, so the statements fold into the unrolled
        # chain as straight-line scalar terms (identical values: addition
        # reassociation only), as the JAX frontend's Pallas tile bodies do.
        self.scalarize = scalarize
        # The RNG key of *_rng calls (generated quantities): a tuple that a
        # call site extends with its count; None elsewhere.
        self.rng_key = rng_key
        self._rng_count = 0

    # -- expressions --
    def ev(self, node):
        if isinstance(node, Num):
            return node.value
        if isinstance(node, Var):
            if node.name not in self.env:
                raise StanCompileError(f"undefined variable {node.name!r}")
            v = self.env[node.name]
            # Declared row_vectors are stored as plain 1-D values; the tag
            # attaches lazily at read time from the declared-type table.
            if (
                not isinstance(v, (RowVector, _LocalArray))
                and getattr(v, "ndim", None) == 1
                and self.env.get("__types__", _EMPTY).get(node.name) == "row_vector"
            ):
                return RowVector(v)
            return v
        if isinstance(node, Unary):
            v = self.ev(node.operand)
            if node.op == "-":
                row, val = _orient(v)
                return RowVector(-val) if row else -val
            if node.op == "+":
                return _as_value_oriented(v)
            if node.op == "!":
                if isinstance(v, (int, float, bool)):
                    return not v
                val = _as_value(v)
                return torch.logical_not(val) if is_tensor(val) else np.logical_not(val)
            raise StanCompileError(f"unary {node.op!r} unsupported")
        if isinstance(node, Bin):
            return self._binop(node)
        if isinstance(node, Ternary):
            cond = self.ev(node.cond)
            if isinstance(cond, _STATIC):
                return self.ev(node.then) if cond else self.ev(node.other)
            return smath._where(
                _as_value(cond), _as_value(self.ev(node.then)), _as_value(self.ev(node.other)))
        if isinstance(node, Index):
            base = self.ev(node.base)
            idxs = []
            for i in node.indices:
                if isinstance(i, RangeIdx):
                    lo = 1 if i.lo is None else _require_int(self.ev(i.lo), "range index")
                    hi = None if i.hi is None else _require_int(self.ev(i.hi), "range index")
                    idxs.append(("range", lo, hi))
                else:
                    idxs.append(self.ev(i))
            out = self._index_read(base, idxs)
            return self._wrap_row_after_index(node.base, base, idxs, out)
        if isinstance(node, Call):
            return self._call(node)
        raise StanCompileError(f"cannot evaluate node {node!r}")

    def _wrap_row_after_index(self, base_node, base, idxs, out):
        """Stan typing for indexed reads: a 1-D result that keeps (only) the
        LAST axis of a matrix-family or row_vector-family base is a
        row_vector; m[:, j] (column) and vector/array reads are column
        vectors. Applies only to declared variables (the type table)."""
        if isinstance(out, RowVector) or _ndim(out) != 1 or isinstance(out, _LocalArray):
            return out
        if isinstance(base, RowVector) or not isinstance(base_node, Var):
            return out
        t = self.env.get("__types__", _EMPTY).get(base_node.name)
        if t not in _ROW_LAST_AXIS_TYPES:
            return out
        rank = len(base.dims) if isinstance(base, _LocalArray) else _ndim(base)

        def keeps_axis(i):
            return (isinstance(i, tuple) and i and i[0] == "range") or isinstance(
                i, (list, np.ndarray, torch.Tensor))

        kept = [j for j in range(len(idxs)) if keeps_axis(idxs[j])]
        kept += list(range(len(idxs), rank))
        if len(kept) == 1 and kept[0] == rank - 1:
            return RowVector(out)
        return out

    def _index_read(self, base, idxs):
        def is_range(i):
            return isinstance(i, tuple) and i and i[0] == "range"

        if isinstance(base, RowVector):
            out = self._index_read(base.data, idxs)
            return RowVector(out) if _ndim(out) == 1 and not isinstance(out, _LocalArray) else out
        if isinstance(base, _LocalArray):
            if not any(is_range(i) for i in idxs):
                return base.get([_require_int(i, "index") for i in idxs])
            if len(idxs) == 1 and len(base.dims) == 1:
                # Keep the slice a container (element list), so scalarize
                # mode and elementwise consumption stay stack-free.
                _, lo, hi = idxs[0]
                hi = base.dims[0] if hi is None else hi
                if not 1 <= lo <= hi <= base.dims[0]:
                    raise StanCompileError(
                        f"range [{lo}:{hi}] out of bounds for dimension {base.dims[0]}")
                out = _LocalArray([hi - lo + 1])
                out.data = list(base.data[lo - 1: hi])
                out.row = getattr(base, "row", False)
                return out
            raise StanCompileError(
                "range indexing on multi-dimensional local containers is not supported")
        if any(is_range(i) for i in idxs):
            sel = []
            shape = tuple(base.shape) if is_tensor(base) else np.shape(base)
            for axis, i in enumerate(idxs):
                size = shape[axis] if axis < len(shape) else None
                if is_range(i):
                    _, lo, hi = i
                    hi = size if hi is None else hi
                    # Stan bounds-checks; a silent Python negative-index wrap
                    # or clamp would corrupt the density.
                    if size is not None and not 1 <= lo <= hi <= size:
                        raise StanCompileError(
                            f"range [{lo}:{hi}] out of bounds for dimension of size {size}")
                    sel.append(slice(lo - 1, hi))
                else:
                    sel.append(_require_int(i, "index") - 1)
            return _py(base[tuple(sel)])
        # Concrete 1-based indices; a data int ARRAY index gathers (Stan
        # multi-indexing, e.g. y[idx] or a[county]) — indices are data so
        # bounds are checked eagerly. A gather KEEPS its axis, so `ax` tracks
        # where the next index applies.
        out = base
        ax = 0
        for i in idxs:
            if isinstance(i, RowVector):
                i = i.data  # a concrete [..] literal used as an index position
            iv = np.asarray(i) if isinstance(i, (list, np.ndarray)) else i
            if isinstance(iv, np.ndarray) and iv.ndim == 1 and iv.size and (
                np.issubdtype(iv.dtype, np.integer) or np.all(iv == iv.astype(np.int64))
            ):
                iv = iv.astype(np.int64)
                size = (tuple(out.shape) if is_tensor(out) else np.shape(out))[ax]
                if not (1 <= iv.min() and iv.max() <= size):
                    raise StanCompileError(
                        f"multi-index out of bounds: values span [{iv.min()}, {iv.max()}] "
                        f"for dimension of size {size}")
                if self.scalarize and ax == 0 and len(idxs) == 1 and _ndim(out) == 1:
                    # Generated models: the gather UNROLLS into
                    # constant-index selections (the lowering has no gather).
                    la = _LocalArray([int(iv.size)])
                    la.data = [_py(out[int(j) - 1]) for j in iv]
                    return la
                if is_tensor(out):
                    out = smath.gather(out, iv - 1, ax)
                else:
                    out = np.take(np.asarray(out), iv - 1, axis=ax)
                ax += 1
            else:
                k = _require_int(i, "index") - 1
                if ax:
                    out = out.select(ax, k) if is_tensor(out) else np.take(np.asarray(out), k, axis=ax)
                else:
                    out = _py(out[k])
        return out

    _SCALARIZABLE_BINOPS = {
        "+": lambda a, b: a + b,
        "-": lambda a, b: a - b,
        ".*": lambda a, b: a * b,
        "./": lambda a, b: a / b,
    }

    def _binop_scalarized(self, op, lv, rv):
        """Generated-model elementwise binop over containers kept PER
        ELEMENT (None when not applicable): a _LocalArray operand must not
        stack."""
        if not (isinstance(lv, _LocalArray) or isinstance(rv, _LocalArray)):
            return None
        f = self._SCALARIZABLE_BINOPS.get(op)
        if f is None and op in ("*", "/"):
            # linear-algebra `*` / `/` are elementwise only against a scalar
            if self._seq_len1(lv) == 0 or self._seq_len1(rv) == 0:
                f = (lambda a, b: a * b) if op == "*" else (lambda a, b: a / b)
            else:
                return None
        if f is None:
            return None
        ln, rn = self._seq_len1(lv), self._seq_len1(rv)
        if ln is None or rn is None:
            return None
        n = max(ln, rn)
        if n == 0 or (ln and rn and ln != rn):
            return None
        out = _LocalArray([n])
        out.data = [
            f(_as_value(self._elem(lv, i)) if ln else _as_value(lv),
              _as_value(self._elem(rv, i)) if rn else _as_value(rv))
            for i in range(n)
        ]
        return out

    def _binop(self, node: Bin):
        op = node.op
        lv = self.ev(node.left)
        rv = self.ev(node.right)
        if self.scalarize:
            out = self._binop_scalarized(op, lv, rv)
            if out is not None:
                return out
        both_int = isinstance(lv, (int, np.integer)) and isinstance(rv, (int, np.integer))
        lrow, l = _orient(lv)
        rrow, r = _orient(rv)
        l, r = _coerce(l, r)
        lnd, rnd = _ndim(l), _ndim(r)

        def ew(val):
            """Elementwise result orientation: row op {row, scalar} stays a
            row_vector; a row mixed with a column vector or matrix is a Stan
            type error (caught loudly rather than silently broadcast)."""
            if not (lrow or rrow):
                return val
            if (lrow and (rrow or rnd == 0)) or (rrow and lnd == 0):
                return RowVector(val)
            raise StanCompileError(
                f"operator {op!r}: row_vector mixed with a vector/matrix operand (Stan type "
                "mismatch); transpose one side")

        if op == "+":
            return ew(l + r)
        if op == "-":
            return ew(l - r)
        if op == "*":
            # Stan `*` is LINEAR-ALGEBRA multiplication. With row orientation
            # tracked: row_vector * vector is the inner product, vector *
            # row_vector the outer product, row_vector * matrix a row_vector;
            # bare vector * vector remains REJECTED (ambiguous without a
            # declared orientation), as is row * row.
            if lrow or rrow:
                if lrow and not rrow and rnd == 1:
                    return _matmul(l, r)  # (1 x N)(N x 1) -> scalar
                if not lrow and lnd == 1 and rrow:
                    return _outer(l, r)
                if lrow and rnd == 2:
                    return RowVector(_matmul(l, r))
                if lrow and rnd == 0:
                    return RowVector(l * r)
                if lnd == 0 and rrow:
                    return RowVector(l * r)
                raise StanCompileError(
                    "illegal `*` operand orientations (row_vector * row_vector, or matrix * "
                    "row_vector)")
            if lnd >= 1 and rnd >= 1 and (lnd == 2 or rnd == 2):
                return _matmul(l, r)
            if lnd == 1 and rnd == 1:
                raise StanCompileError(
                    "vector * vector is ambiguous (neither side is a declared row_vector): use "
                    "dot_product(a, b) for the inner product, a' * b for an explicit "
                    "row*column, or a .* b for elementwise")
            return l * r
        if op == ".*":
            return ew(l * r)
        if op == "./":
            if both_int:
                return int(l / r)
            return ew(l / r)
        if op == "/":
            if both_int:
                return int(l / r)  # Stan int division truncates toward zero
            if lrow and rnd == 0:
                return RowVector(l / r)
            return l / r
        if op == "%":
            return l % r
        if op == "^":
            return _as_value(l) ** r if not both_int else l ** r
        if op == "==":
            return _py(l == r)
        if op == "!=":
            return _py(l != r)
        if op == "<":
            return _py(l < r)
        if op == "<=":
            return _py(l <= r)
        if op == ">":
            return _py(l > r)
        if op == ">=":
            return _py(l >= r)
        if op in ("&&", "||"):
            if isinstance(l, _STATIC) and isinstance(r, _STATIC):
                return (bool(l) and bool(r)) if op == "&&" else (bool(l) or bool(r))
            if is_tensor(l) or is_tensor(r):
                f = torch.logical_and if op == "&&" else torch.logical_or
                return f(torch.as_tensor(l), torch.as_tensor(r))
            f = np.logical_and if op == "&&" else np.logical_or
            return _py(f(l, r))
        raise StanCompileError(f"operator {op!r} unsupported")

    # ---- scalarize-mode helpers (generated models; see __init__) ----

    @staticmethod
    def _seq_len1(v):
        """Length of a rank-1 value, 0 for scalars, None if not scalarizable
        (rank >= 2 or partially-initialized reads raise)."""
        if isinstance(v, tuple):
            return None
        if isinstance(v, RowVector):
            v = v.data
        if isinstance(v, _LocalArray):
            return v.dims[0] if len(v.dims) == 1 else None
        nd = _ndim(v)
        if nd == 0:
            return 0
        if nd == 1:
            return int(v.shape[0])
        return None

    @staticmethod
    def _elem(v, i):
        if isinstance(v, RowVector):
            v = v.data
        if isinstance(v, _LocalArray):
            return v.get([i + 1])
        if isinstance(v, np.ndarray):
            return float(v[i])  # folds into ops as an immediate
        if _ndim(v) == 1:
            return v[i]
        return v

    def _dist_scalarized(self, dist, raw):
        """Vectorized lpdf/lpmf over rank-1 args -> Python-summed scalar
        terms (None when the args are not uniformly scalarizable).

        `normal` with scalar scale gets a sufficient-statistic form
        (accumulate squared residuals; pay log sigma and the constant once),
        the recurrence-consumer idiom (arma/GARCH)."""
        if dist not in ELEMENTWISE_DENSITIES:
            return None
        lens = [self._seq_len1(v) for v in raw]
        if any(n is None for n in lens):
            return None
        vec = [n for n in lens if n > 0]
        if not vec:
            return None
        n = vec[0]
        if any(m != n for m in vec):
            return None
        if dist == "normal" and len(raw) == 3 and lens[0] == n and lens[2] == 0:
            sigma = _as_value(raw[2])
            ss = None
            for i in range(n):
                d = _as_value(self._elem(raw[0], i)) - _as_value(self._elem(raw[1], i))
                ss = d * d if ss is None else ss + d * d
            return -0.5 * ss / (sigma * sigma) - n * (smath._log(sigma) + LOG_SQRT_2PI)
        density = ELEMENTWISE_DENSITIES[dist]
        total = None
        for i in range(n):
            term = density(*[_as_value(self._elem(v, i)) for v in raw])
            total = term if total is None else total + term
        return total

    def _truncated_scalarized(self, dist, raw, lo, hi):
        """Per-element truncated sampling terms for scalarize mode: each
        element gets its own scalar truncated_lp call, summed in Python.
        Returns None when args are not uniformly scalarizable."""
        vals = list(raw) + [v for v in (lo, hi) if v is not None]
        lens = [self._seq_len1(v) for v in vals]
        if any(n is None for n in lens):
            return None
        vec = [n for n in lens if n > 0]
        if not vec:
            return None
        n = vec[0]
        if any(m != n for m in vec):
            return None

        def elem(v, ln, i):
            return _as_value(self._elem(v, i)) if ln else _as_value(v)

        # Shared normalizer: when bounds and parameters are all scalar the
        # log(F(hi) - F(lo)) term is identical across elements — hoist it
        # (one evaluation per statement; on data it folds to a literal).
        shared_lnorm = None
        if all(m == 0 for m in lens[1:]):
            shared_lnorm = truncation_lognorm(
                dist, [_as_value(v) for v in raw[1:]],
                None if lo is None else _as_value(lo), None if hi is None else _as_value(hi))
        nraw = len(raw)
        total = None
        for i in range(n):
            args_i = [elem(v, lens[j], i) for j, v in enumerate(raw)]
            k = nraw
            lo_i = hi_i = None
            if lo is not None:
                lo_i = elem(lo, lens[k], i)
                k += 1
            if hi is not None:
                hi_i = elem(hi, lens[k], i)
            term = truncated_lp(dist, args_i, lo_i, hi_i, lnorm=shared_lnorm)
            total = term if total is None else total + term
        return total

    def _elementwise_scalarized(self, name, v):
        n = self._seq_len1(v)
        if not n:
            return None
        out = _LocalArray([n])
        for i in range(n):
            out.set([i + 1], apply(FUNCTIONS[name], _as_value(self._elem(v, i))))
        return out

    def _user_fn(self, node: Call, what):
        fns = self.env.get("__functions__") or {}
        if not node.args or not isinstance(node.args[0], Var) or node.args[0].name not in fns:
            raise StanCompileError(
                f"{node.name} requires a user-defined {what} function name as its first argument")
        return fns[node.args[0].name]

    def _call(self, node: Call):
        name = node.name
        if name in _NOT_PORTED_FNS:
            raise StanCompileError(f"{name} {NOT_PORTED}")
        if name == "map_rect":
            # Stan's multi-process map: f(phi, theta_j, x_r_j, x_i_j) per job,
            # outputs concatenated; the jobs run one after another here.
            fd = self._user_fn(node, "job")
            if len(node.args) != 5:
                raise StanCompileError("map_rect(f, phi, theta, x_r, x_i) takes 5 arguments")
            phi_v = _as_value(self.ev(node.args[1]))
            theta = _as_value(self.ev(node.args[2]))
            x_r = np.asarray(_as_value(self.ev(node.args[3])), dtype=float)
            x_i = np.asarray(_as_value(self.ev(node.args[4])))
            n_jobs = int(theta.shape[0])
            outs = [
                _as_value(self._call_user_fn(fd, [phi_v, _py(theta[j]), x_r[j], x_i[j]]))
                for j in range(n_jobs)
            ]
            return _cat1(outs)
        if name in ("reduce_sum", "reduce_sum_static"):
            # Stan's within-chain parallel map-reduce: the partial-sum
            # function applied to the WHOLE slice (start=1, end=N) — the
            # value reduce_sum contracts to produce regardless of grainsize.
            fd = self._user_fn(node, "partial-sum")
            if len(node.args) < 3:
                raise StanCompileError("reduce_sum(f, y, grainsize, ...) takes at least 3 arguments")
            y = _as_value(self.ev(node.args[1]))
            extra = [_as_value(self.ev(a)) for a in node.args[3:]]
            n = int(y.shape[0]) if _ndim(y) else 1
            return self._call_user_fn(fd, [y, 1, n] + extra)
        raw = [self.ev(a) for a in node.args]
        if name == "__stack__":  # {a, b, c} array literals
            vals = [_as_value(v) for v in raw]
            if not vals:
                return np.zeros((0,))
            if all(isinstance(v, (int, np.integer)) for v in vals):
                # keep static ints static: {1, 3} stays a data index array
                return np.asarray(vals, dtype=np.int64)
            return _stack(vals)
        if name == "__tuple__":
            return tuple(_as_value_oriented(v) for v in raw)
        if name == "__tuple_get__":
            base = raw[0]
            k = _require_int(_as_value(raw[1]), "tuple index")
            if not isinstance(base, tuple):
                raise StanCompileError(f".{k} access on a non-tuple value")
            if not 1 <= k <= len(base):
                raise StanCompileError(
                    f"tuple index .{k} out of range for a {len(base)}-element tuple")
            return base[k - 1]
        if name == "__rowvec__":
            # [a, b, c] matrix-expression literal: scalars -> row_vector;
            # row_vector elements -> matrix (rows).
            if raw and all(is_row(v) for v in raw):
                return _stack([_as_value(v) for v in raw])
            vals = [_as_value(v) for v in raw]
            if not vals:
                return RowVector(np.zeros((0,)))
            if all(isinstance(v, (int, np.integer)) for v in vals):
                return RowVector(np.asarray(vals, dtype=np.int64))
            return RowVector(_stack(vals))
        # _as_value STACKS _LocalArray containers — evaluated lazily so the
        # per-element paths never build a dead whole-container stack.
        args = lambda: [_as_value(v) for v in raw]  # noqa: E731
        fns = self.env.get("__functions__")
        if fns is not None and name in fns:
            return self._call_user_fn(fns[name], [_as_value_oriented(v) for v in raw])
        if name.endswith("_rng"):
            dist = name[: -len("_rng")]
            if self.rng_key is None:
                raise StanCompileError(
                    f"{name} called outside generated quantities (RNG is only available there, "
                    "as in Stan)")
            if dist not in RNG_FUNCTIONS:
                raise StanCompileError(f"unsupported RNG function {name!r}")
            torch.manual_seed(self._rng_seed())
            a = [v if is_tensor(v) else to_tensor(v) for v in args()]
            return RNG_FUNCTIONS[dist](*a)
        for suffix in ("_lpdf", "_lpmf", "_lupdf", "_lupmf"):
            if name.endswith(suffix):
                dist = name[: -len(suffix)]
                if dist not in DISTRIBUTIONS:
                    raise StanCompileError(f"unsupported distribution {dist!r}")
                if self.scalarize:
                    out = self._dist_scalarized(dist, raw)
                    if out is not None:
                        return out
                return apply(DISTRIBUTIONS[dist], *args())
        for suffix, table in (("_lcdf", LCDFS), ("_lccdf", LCCDFS)):
            if name.endswith(suffix):
                dist = name[: -len(suffix)]
                if dist not in table:
                    raise StanCompileError(
                        f"no CDF implemented for distribution {dist!r} "
                        f"(supported: {', '.join(sorted(table))})")
                return apply(table[dist], *args())
        if name.endswith("_cdf"):
            dist = name[: -len("_cdf")]
            if dist not in LCDFS:
                raise StanCompileError(
                    f"no CDF implemented for distribution {dist!r} "
                    f"(supported: {', '.join(sorted(LCDFS))})")
            # Stan's vectorized _cdf is the PRODUCT over elements = exp of
            # the summed log-CDF.
            return smath._exp(apply(LCDFS[dist], *args()))
        if name in FUNCTIONS:
            if self.scalarize and name in _ELEMENTWISE_FNS and len(raw) == 1:
                out = self._elementwise_scalarized(name, raw[0])
                if out is not None:
                    return out
            if name in _ORIENT_FNS:
                return apply(FUNCTIONS[name], *[_as_value_oriented(v) for v in raw])
            return apply(FUNCTIONS[name], *args())
        if name == "dims":
            arr = raw[0]
            if isinstance(arr, RowVector):
                arr = arr.data
            shape = arr.dims if isinstance(arr, _LocalArray) else tuple(np.shape(arr) if not
                                                                        is_tensor(arr) else arr.shape)
            return list(shape)
        raise StanCompileError(f"unsupported function {name!r}")

    def _rng_seed(self) -> int:
        """The seed of this *_rng call site: the key of the interpreter (a
        tuple, extended by user-function calls) and the site's count, hashed
        to 63 bits."""
        key = self.rng_key + (self._rng_count,)
        self._rng_count += 1
        digest = hashlib.sha256(repr(key).encode()).digest()
        return int.from_bytes(digest[:8], "little") >> 1

    def _call_user_fn(self, fd: FuncDef, args):
        """Inline a user-defined `functions`-block function: bind the
        arguments in a fresh env (Stan functions see only their parameters),
        run the body, and unwind at `return`. `target +=` inside the body
        accumulates into the caller's target (Stan's _lp-function semantics).
        Deeply recursive calls are rejected."""
        if len(args) != len(fd.params):
            raise StanCompileError(
                f"{fd.name}() takes {len(fd.params)} arguments, got {len(args)}")
        depth = self.env.get("__fdepth__", 0)
        if depth > 32:
            raise StanCompileError(
                f"function call depth exceeded in {fd.name!r} (unbounded recursion?)")
        fenv = {
            "__functions__": self.env.get("__functions__"),
            "__fdepth__": depth + 1,
            # parameter orientation: declared row_vector params re-tag their
            # (possibly untagged) argument values at read time
            "__types__": {p[1]: p[0] for p in fd.params},
        }
        fenv.update(zip((p[1] for p in fd.params), args))
        sub = _Interp(fenv, scalarize=self.scalarize)
        if self.rng_key is not None:
            sub.rng_key = self.rng_key + (self._rng_count,)
            self._rng_count += 1
        ret = None
        try:
            sub.run(fd.body)
        except _FnReturn as r:
            ret = r.value
        self.target = self.target + sub.target
        if ret is None and fd.ret_type != "void":
            raise StanCompileError(
                f"non-void function {fd.name!r} finished without `return` (returns inside "
                "parameter-dependent control flow are not reachable; hoist them with the "
                "ternary operator)")
        return ret

    # -- statements --
    def run(self, stmts):
        for s in stmts:
            self.run_stmt(s)

    def run_stmt(self, s):
        if isinstance(s, list):
            self.run(s)
        elif isinstance(s, Decl):
            self._declare(s)
        elif isinstance(s, Assign):
            self._assign(s)
        elif isinstance(s, TargetPlus):
            inc = _as_value(self.ev(s.expr))
            if is_tensor(inc):
                inc = torch.sum(inc) if inc.dim() else inc
            elif _ndim(inc):
                inc = float(np.sum(inc))
            self.target = self.target + inc
        elif isinstance(s, Sampling):
            dist = s.dist
            if dist not in DISTRIBUTIONS:
                raise StanCompileError(f"line {s.line}: unsupported distribution {dist!r}")
            raw = [self.ev(s.lhs)] + [self.ev(a) for a in s.args]
            if s.t_lower is not None or s.t_upper is not None:
                lo = _as_value(self.ev(s.t_lower)) if s.t_lower is not None else None
                hi = _as_value(self.ev(s.t_upper)) if s.t_upper is not None else None
                try:
                    inc = None
                    if self.scalarize:
                        inc = self._truncated_scalarized(dist, raw, lo, hi)
                    if inc is None:
                        inc = truncated_lp(dist, [_as_value(v) for v in raw], lo, hi)
                except ValueError as e:
                    raise StanCompileError(f"line {s.line}: {e}") from None
                self.target = self.target + inc
                return
            inc = None
            if self.scalarize:
                inc = self._dist_scalarized(dist, raw)
            if inc is None:
                inc = apply(DISTRIBUTIONS[dist], *[_as_value(v) for v in raw])
            self.target = self.target + inc
        elif isinstance(s, For):
            lo = _require_int(self.ev(s.lo), f"line {s.line}: loop bound")
            hi = _require_int(self.ev(s.hi), f"line {s.line}: loop bound")
            shadowed = self.env.get(s.var)
            for i in range(lo, hi + 1):
                self.env[s.var] = i
                try:
                    self.run(s.body)
                except _LoopContinue:
                    continue
                except _LoopBreak:
                    break
            if shadowed is not None:
                self.env[s.var] = shadowed
            else:
                self.env.pop(s.var, None)
        elif isinstance(s, While):
            # Bounded unroll with concrete conditions: each trip re-evaluates
            # the condition against the (possibly updated) env. A condition
            # that depends on parameters cannot steer a Python loop — same
            # rule as `if`.
            trips = 0
            while True:
                cond = self.ev(s.cond)
                if not isinstance(cond, _STATIC):
                    raise StanCompileError(
                        f"line {s.line}: `while` conditions must be data-derived "
                        "(parameter-dependent loop trip counts cannot be traced)")
                if not cond:
                    break
                try:
                    self.run(s.body)
                except _LoopContinue:
                    pass
                except _LoopBreak:
                    break
                trips += 1
                if trips > 100_000:
                    raise StanCompileError(
                        f"line {s.line}: `while` exceeded 100000 iterations "
                        "(non-terminating data-derived condition?)")
        elif isinstance(s, Return):
            raise _FnReturn(None if s.expr is None else _as_value_oriented(self.ev(s.expr)))
        elif isinstance(s, ExprStmt):
            self.ev(s.expr)  # side effect only (user fn `target +=`)
        elif isinstance(s, Break):
            raise _LoopBreak()
        elif isinstance(s, Continue):
            raise _LoopContinue()
        elif isinstance(s, Reject):
            raise StanCompileError(
                f"line {s.line}: reject() reached during tracing — with data-derived control "
                "flow only, it would reject EVERY draw (guard it with a data-derived `if`, or "
                "remove it)")
        elif isinstance(s, If):
            cond = self.ev(s.cond)
            if isinstance(cond, _STATIC):
                self.run(s.then if cond else s.other)
            else:
                raise StanCompileError(
                    f"line {s.line}: `if` conditions must be data-derived (parameter-dependent "
                    "branching cannot be traced; use the ternary operator for elementwise "
                    "selects)")
        else:
            raise StanCompileError(f"unsupported statement {s!r}")

    def _declare(self, s: Decl):
        dims = [_require_int(self.ev(d), f"line {s.line}: dimension") for d in s.dims]
        # Record the declared base type so indexed reads / Var reads can
        # attach Stan row/column orientation (see _wrap_row_after_index).
        types = self.env.get("__types__")
        if types is None:
            types = {}
            self.env["__types__"] = types
        types[s.name] = s.type
        if s.type == "tuple":
            self.env[s.name] = self.ev(s.init) if s.init is not None else None
            return []
        if s.init is not None:
            val = self.ev(s.init)
            if s.type == "row_vector" and getattr(val, "ndim", 0) == 1:
                val = _as_value_oriented(val)
                if not isinstance(val, RowVector):
                    val = RowVector(val)
            self.env[s.name] = val
        elif dims:
            la = _LocalArray(dims)
            if s.type == "row_vector" and len(dims) == 1:
                la.row = True
            self.env[s.name] = la
        else:
            self.env[s.name] = None  # scalar declared, not yet assigned
        return dims

    def _assign(self, s: Assign):
        val = self.ev(s.expr)
        if s.op != "=":
            cur = self.ev(s.lvalue)
            l, r = _coerce(_as_value(cur), _as_value(val))
            val = {
                "+=": lambda: l + r,
                "-=": lambda: l - r,
                "*=": lambda: l * r,
                "/=": lambda: l / r,
            }[s.op]()
        if isinstance(s.lvalue, Var):
            self.env[s.lvalue.name] = val
            return
        if not isinstance(s.lvalue, Index):
            raise StanCompileError(
                "unsupported assignment target (tuple-member assignment t.1 = ... is not "
                "supported; rebuild the whole tuple)")
        base_node, idx_nodes = s.lvalue.base, s.lvalue.indices
        if not isinstance(base_node, Var):
            raise StanCompileError("chained-index assignment unsupported")
        idxs = [self.ev(i) for i in idx_nodes]
        self._indexed_assign(base_node.name, idxs, val)

    def _indexed_assign(self, name, idxs, val):
        container = self.env.get(name)
        if isinstance(container, _LocalArray):
            container.set([_require_int(i, "assignment index") for i in idxs], _as_value(val))
            return
        row = isinstance(container, RowVector)
        arr = container.data if row else container
        if is_tensor(arr) or isinstance(arr, np.ndarray):
            ix = tuple(_require_int(i, "assignment index") - 1 for i in idxs)
            out = _set_at(arr, ix, _as_value(val))
            self.env[name] = RowVector(out) if row else out
            return
        raise StanCompileError(f"indexed assignment into non-local {name!r}")


def _set_at(arr, ix, val):
    """arr with arr[ix] = val, functionally: numpy data copied and set, a
    tensor (or data meeting a tensor value) by a where over a mask, which
    autograd, vmap and the generated lowering all take."""
    if not is_tensor(arr) and not is_tensor(val):
        out = np.array(arr, dtype=np.float64)
        out[ix] = val
        return out
    arr = to_tensor(arr)
    mask = np.zeros(tuple(arr.shape), dtype=bool)
    mask[ix] = True
    slot = tuple(arr.shape[len(ix):])
    v = to_tensor(val)
    if v.dim() > len(slot):
        raise StanCompileError("assigned value does not fit the indexed slot")
    v = v.reshape((1,) * (len(ix) + len(slot) - v.dim()) + tuple(v.shape))
    return torch.where(torch.as_tensor(mask, device=arr.device), v, arr)


def _matmul(a, b):
    a, b = to_tensor(a) if not is_tensor(a) else a, to_tensor(b) if not is_tensor(b) else b
    return a @ b


def _outer(a, b):
    if not is_tensor(a) and not is_tensor(b):
        return np.outer(a, b)
    return torch.outer(to_tensor(a), to_tensor(b))


# ------------------------------------------------------------ param packing


_VEC_CONSTRAINED = ("simplex", "ordered", "positive_ordered", "unit_vector",
                    "cholesky_factor_corr", "corr_matrix", "cov_matrix",
                    "cholesky_factor_cov")


def _running_sum(v):
    """cumsum of a 1-D tensor as a chain of adds (an op the generated
    lowering has)."""
    acc, out = None, []
    for i in range(v.shape[0]):
        acc = v[i] if acc is None else acc + v[i]
        out.append(acc)
    return torch.stack(out)


def _cpc_cholesky(u, k):
    """Canonical-partial-correlation Cholesky factor (Stan ch. 10.12):
    z_ij = tanh(u_ij), rows built left-to-right with unit norm. Returns
    (L, logJ) with logJ = sum_{i>j} [log(1 - z_ij^2) + 0.5 log(1 -
    sum_{k<j} L_ik^2)] — the Jacobian onto L's strictly-lower entries."""
    z = torch.tanh(u)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    jac = zero
    rows = []
    idx = 0
    for i in range(k):
        row = []
        ssq = zero
        for _ in range(i):
            zij = z[idx]
            idx += 1
            rem = 1.0 - ssq
            jac = jac + torch.log1p(-zij * zij) + 0.5 * torch.log(rem)
            x = zij * torch.sqrt(rem)
            ssq = ssq + x * x
            row.append(x)
        row.append(torch.sqrt(1.0 - ssq))
        row.extend(zero for _ in range(k - i - 1))
        rows.append(torch.stack(row))
    return torch.stack(rows), jac


class _ParamSpec:
    """Unconstrained packing + constraining transform for one parameter (the
    JAX frontend's `_ParamSpec`, Stan reference manual ch. 10).

    Scalar lower/upper bounds map elementwise (exp / negated exp / scaled
    logistic). The constrained VECTOR types carry their transform in the
    type itself:

    - ordered:          c_1 = u_1, c_k = c_{k-1} + exp(u_k);  logJ = Σ_{k≥2} u_k
    - positive_ordered: c_1 = exp(u_1), then as ordered;      logJ = Σ u_k
    - simplex (K):      stick-breaking over K-1 unconstrained coordinates,
                        z_k = logit⁻¹(u_k − log(K−k)), c_k = stick_k · z_k;
                        logJ = Σ [log z_k + log(1−z_k) + log stick_k]
    - unit_vector (K):  c = u/‖u‖ with Stan's −½‖u‖² density adjustment
                        standing in for the Jacobian term.

    Matrix-constrained types:

    - cholesky_factor_corr (K): K(K-1)/2 canonical partial correlations
      z = tanh(u), rows built left-to-right with unit norm;
    - corr_matrix (K): the cholesky_factor_corr map composed with Σ = L Lᵀ,
      logJ += Σ_{j<K} (K−j)·log L_jj;
    - cov_matrix (K): K(K+1)/2 coordinates, row-major lower triangle with
      the diagonal exp-transformed, Σ = L Lᵀ; logJ = K·log 2 + Σ_k (K−k+2)·u_kk
    - cholesky_factor_cov (K): row-major lower triangle, diagonal
      exp-transformed, no product; logJ = Σ_k u_kk.
    """

    def __init__(self, decl: Decl, sizes, lower, upper, offset=None, multiplier=None):
        self.name = decl.name
        if (offset is not None or multiplier is not None) and (
            lower is not None or upper is not None
        ):
            raise StanCompileError(
                f"{decl.name}: offset/multiplier cannot combine with lower/upper bounds (as in "
                "Stan)")
        if multiplier is not None and multiplier <= 0:
            raise StanCompileError(f"{decl.name}: multiplier must be positive")
        self.offset = offset
        self.multiplier = multiplier
        self.decl_type = decl.type  # for the orientation type table
        self.vtype = decl.type if decl.type in _VEC_CONSTRAINED else None
        if self.vtype is not None and len(sizes) != 1:
            raise StanCompileError(
                f"{decl.type}[{'x'.join(map(str, sizes))}] {decl.name}: constrained vector "
                "types take exactly one dimension")
        if self.vtype is not None and sizes[0] < 2:
            raise StanCompileError(f"{decl.type} {decl.name} needs dimension >= 2")
        self.sizes = tuple(sizes)  # () for scalar
        self.count = int(np.prod(sizes)) if sizes else 1
        if self.vtype == "simplex":
            self.count = self.sizes[0] - 1
        elif self.vtype in ("cholesky_factor_corr", "corr_matrix"):
            k = self.sizes[0]
            self.count = k * (k - 1) // 2
            self.sizes = (k, k)
        elif self.vtype in ("cov_matrix", "cholesky_factor_cov"):
            k = self.sizes[0]
            self.count = k * (k + 1) // 2
            self.sizes = (k, k)
        self.lower = lower
        self.upper = upper

    def constrain(self, u):
        """u: (count,) slice of theta → (constrained values, log-Jacobian)."""
        if self.vtype == "ordered":
            return _running_sum(torch.cat([u[:1], torch.exp(u[1:])])), torch.sum(u[1:])
        if self.vtype == "positive_ordered":
            return _running_sum(torch.exp(u)), torch.sum(u)
        if self.vtype == "simplex":
            k = self.sizes[0]
            adj = u - torch.log(torch.arange(k - 1, 0, -1, dtype=u.dtype, device=u.device))
            log_z = smath._log_sigmoid_stable(adj)
            log1m_z = smath._log_sigmoid_stable(-adj)
            cum = _running_sum(log1m_z)
            log_stick = torch.cat([torch.zeros((1,), dtype=u.dtype, device=u.device), cum[:-1]])
            c = torch.cat([torch.exp(log_stick + log_z), torch.exp(cum[-1:])])
            return c, torch.sum(log_z + log1m_z + log_stick)
        if self.vtype == "unit_vector":
            norm2 = torch.sum(u * u)
            return u / torch.sqrt(norm2), -0.5 * norm2
        if self.vtype in ("cholesky_factor_corr", "corr_matrix"):
            ell, jac = _cpc_cholesky(u, self.sizes[0])
            if self.vtype == "cholesky_factor_corr":
                return ell, jac
            # corr_matrix: Sigma = L L^T; each column j's diagonal enters
            # K-1-j times (0-based). L_00 = 1 contributes nothing.
            k = self.sizes[0]
            mult = torch.arange(k - 1, -1, -1, dtype=u.dtype, device=u.device)
            jac = jac + torch.sum(mult * torch.log(torch.diagonal(ell)))
            return ell @ ell.T, jac
        if self.vtype in ("cov_matrix", "cholesky_factor_cov"):
            k = self.sizes[0]
            zero = torch.zeros((), dtype=u.dtype, device=u.device)
            rows, log_diag = [], []
            idx = 0
            for i in range(k):
                off = [u[idx + j] for j in range(i)]
                log_diag.append(u[idx + i])
                idx += i + 1
                row = off + [torch.exp(u[idx - 1])]
                row.extend(zero for _ in range(k - i - 1))
                rows.append(torch.stack(row))
            ell = torch.stack(rows)
            log_diag = torch.stack(log_diag)
            if self.vtype == "cholesky_factor_cov":
                return ell, torch.sum(log_diag)
            # cov_matrix (Stan manual 10.10): logJ = K log 2 + sum_k (K - k + 2) u_kk
            mult = torch.arange(k + 1, 1, -1, dtype=u.dtype, device=u.device)
            jac = k * float(np.log(2.0)) + torch.sum(mult * log_diag)
            return ell @ ell.T, jac
        c, jac_e = self._bounded(u)
        jac = 0.0 if jac_e is None else torch.sum(jac_e)
        if not self.sizes:
            return c[0], jac
        return c.reshape(self.sizes), jac

    def _bounded(self, u):
        """Elementwise scalar-bound transform shared by `constrain` (array
        slice) and `constrain_seq` (single scalar): (constrained, per-element
        log-Jacobian or None when unbounded)."""
        if self.offset is not None or self.multiplier is not None:
            off = 0.0 if self.offset is None else self.offset
            mult = 1.0 if self.multiplier is None else self.multiplier
            return off + mult * u, torch.full_like(u, float(np.log(mult)))
        if self.lower is not None and self.upper is not None:
            # logistic via tanh and log-sigmoid via the stable softplus
            # expansion (ops the generated lowering has).
            span = self.upper - self.lower
            c = self.lower + span * 0.5 * (torch.tanh(0.5 * u) + 1.0)
            jac = float(np.log(span)) - smath._softplus(u) - smath._softplus(-u)
            return c, jac
        if self.lower is not None:
            return self.lower + torch.exp(u), u
        if self.upper is not None:
            return self.upper - torch.exp(u), u
        return u, None

    def constrain_seq(self, us):
        """Like `constrain`, but from a SEQUENCE of scalar coordinates — the
        forward-mode generated model's contract
        (ops/generated.tile_model_from_logp_fwd): scalar parameters apply
        their transform directly on the scalar, with NO stack, so a
        coordinate's tangent stays absent where it is symbolically zero.
        Rank-1 parameters with elementwise transforms get the same treatment
        per element, returned as a _LocalArray of scalars (the D=64 IRT model
        traces ~2k operations so against ~167k stacked, as measured by the
        JAX frontend)."""
        if self.vtype is not None or len(self.sizes) > 1:
            return self.constrain(torch.stack(list(us)))
        if self.sizes:
            arr = _LocalArray([self.sizes[0]])
            jac = 0.0
            for i, u in enumerate(us):
                c, j = self._bounded(u)
                arr.set([i + 1], c)
                if j is not None:
                    jac = jac + j
            return arr, jac
        c, jac = self._bounded(us[0])
        return c, 0.0 if jac is None else jac

    def names(self):
        if not self.sizes:
            return [self.name]
        idx_lists = np.indices(self.sizes).reshape(len(self.sizes), -1).T + 1
        return [self.name + "." + ".".join(str(i) for i in row) for row in idx_lists]


# ---------------------------------------------------------------- compile


def load_stan_data(path: str) -> dict:
    """Load a Stan data JSON. Tolerates the reference's truncated-rewrite
    corruption (SURVEY.md §2 #15: PRMwCD.json ends mid-`"phi": ` after an
    interrupted in-place rewrite by bridgestan.py:134-141) by completing the
    dangling `phi` field in memory."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        repaired = text.rstrip()
        if repaired.endswith('"phi":'):
            repaired += " 1.0}"
        elif repaired.endswith('"phi": '):
            repaired += "1.0}"
        else:
            raise
        return json.loads(repaired)


def _build_data_env(prog: Program, data: dict) -> tuple[dict, bool]:
    env = {"__types__": {}}
    # User-defined functions ride the env under a reserved key (Stan
    # identifiers cannot start with '_').
    fdefs = prog.blocks.get("functions", [])
    if fdefs:
        env["__functions__"] = {f.name: f for f in fdefs}
    has_phi = False
    for decl in prog.blocks.get("data", []):
        if not isinstance(decl, Decl):
            raise StanCompileError("only declarations allowed in data block")
        if decl.type == "tuple":
            raise StanCompileError(
                "tuple-typed data is not supported (pass the members as separate data entries)")
        if decl.name == "phi":
            has_phi = True
            continue  # bound per-evaluation as the tempering argument
        if decl.name not in data:
            raise StanCompileError(f"data variable {decl.name!r} missing")
        env["__types__"][decl.name] = decl.type
        raw = data[decl.name]
        if decl.type == "int" and not decl.dims:
            env[decl.name] = int(raw)
        elif decl.type == "int":
            env[decl.name] = np.asarray(raw, dtype=np.int64)
        elif not decl.dims:
            env[decl.name] = float(raw)
        else:
            arr = np.asarray(raw, dtype=np.float64)
            env[decl.name] = arr.reshape([int(_Interp(env).ev(d)) for d in decl.dims])
    # transformed data: evaluated once with concrete values
    td = prog.blocks.get("transformed data", [])
    if td:
        interp = _Interp(env)
        interp.run(td)
        env.update(interp.env)
    return env, has_phi


def _body_has_carried_dep(body, loopvar) -> bool:
    """Does a loop body carry state across iterations? True when some
    container assigned in the body is read at a LAGGED index (err[t-1]), or
    some scalar assigned in the body is read before its first write of the
    iteration (e = y[t] - a*e; acc += ...). A fresh per-iteration temp is NOT
    carried. Unanalyzable constructs answer True (forward mode is the safe
    direction)."""
    assigned, declared = set(), set()
    try:
        _walk_writes(body, assigned, declared)
    except _Unanalyzable:
        return True
    assigned = assigned | declared
    written: set = set()
    found = False

    def reads(node):
        nonlocal found
        if found or node is None or isinstance(node, Num):
            return
        if isinstance(node, Var):
            if node.name in assigned and node.name not in written:
                found = True
            return
        if isinstance(node, Index):
            if isinstance(node.base, Var) and node.base.name in assigned:
                if len(node.indices) == 1:
                    off = _match_loopvar_offset(node.indices[0], loopvar)
                    if off is not None:
                        if off < 0:
                            found = True
                        else:
                            for i in node.indices:
                                reads(i)
                        return
                found = True  # complex index into a written container
                return
            if not isinstance(node.base, Var):
                reads(node.base)
            for i in node.indices:
                reads(i)
            return
        if isinstance(node, Unary):
            reads(node.operand)
        elif isinstance(node, Bin):
            reads(node.left)
            reads(node.right)
        elif isinstance(node, Ternary):
            reads(node.cond)
            reads(node.then)
            reads(node.other)
        elif isinstance(node, Call):
            for a in node.args:
                reads(a)

    def walk(stmts):
        nonlocal found
        for st in stmts if isinstance(stmts, (list, tuple)) else [stmts]:
            if found:
                return
            if isinstance(st, list):
                walk(st)
            elif isinstance(st, Decl):
                reads(st.init)
                written.add(st.name)
            elif isinstance(st, Assign):
                reads(st.expr)
                if st.op != "=":
                    reads(st.lvalue)
                lv = st.lvalue
                if isinstance(lv, Var):
                    written.add(lv.name)
                elif isinstance(lv, Index):
                    for i in lv.indices:
                        reads(i)
                    if isinstance(lv.base, Var):
                        written.add(lv.base.name)
            elif isinstance(st, TargetPlus):
                reads(st.expr)
            elif isinstance(st, Sampling):
                reads(st.lhs)
                for a in st.args:
                    reads(a)
                reads(st.t_lower)
                reads(st.t_upper)
            elif isinstance(st, For):
                reads(st.lo)
                reads(st.hi)
                walk(st.body)
            elif isinstance(st, If):
                reads(st.cond)
                # Branch writes may not execute; do not add them to
                # `written` (conservative toward "carried").
                walk(st.then)
                walk(st.other)
            elif isinstance(st, (While, Return, ExprStmt, Break, Continue)):
                found = True  # unanalyzable control flow / side effects

    walk(body)
    return found


def _has_long_recurrence(blocks, env, threshold=48) -> bool:
    """Is there a static `for` loop of more than `threshold` iterations
    whose body carries state across iterations (a RECURRENCE)? This — not
    loop length alone — is what picks the forward-mode generated model: a
    long non-carried loop (PRMwCD's 100-observation sum) reverse-
    differentiates in one pass where forward costs D. Searches the given
    blocks AND every user-function body; `while` counts as a recurrence."""
    interp = _Interp(dict(env))

    def trip(s: For) -> int:
        try:
            lo = _require_int(interp.ev(s.lo), "loop bound")
            hi = _require_int(interp.ev(s.hi), "loop bound")
            return max(0, hi - lo + 1)
        except Exception:
            return 0

    def walk(stmts, mult=1) -> bool:
        # `mult` = product of enclosing static trip counts: a recurrence
        # spelled as nested short loops is still a long chain.
        for st in stmts if isinstance(stmts, (list, tuple)) else [stmts]:
            if isinstance(st, list):
                if walk(st, mult):
                    return True
            elif isinstance(st, For):
                eff = mult * max(1, trip(st))
                if eff > threshold and _body_has_carried_dep(st.body, st.var):
                    return True
                if walk(st.body, eff):
                    return True
            elif isinstance(st, While):
                return True
            elif isinstance(st, If):
                if walk(st.then, mult) or walk(st.other, mult):
                    return True
        return False

    fn_bodies = [f.body for f in env.get("__functions__", {}).values() if isinstance(f, FuncDef)]
    return any(walk(b) for b in tuple(blocks) + tuple(fn_bodies))


def _scalar_tensor(v, like):
    """A target value as a 0-d tensor of like's dtype and device (a target
    that depends on no parameter is a Python number)."""
    if is_tensor(v):
        return v
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


class StanModel(CallableModel):
    """A compiled Stan program: a `CallableModel` whose eager
    `logp_and_grad` is replayed from a traced graph, and whose `constrain`
    draws generated quantities from a generator seeded per call site.

    `logp_and_grad(x, phi)` interprets the program once for each shape,
    dtype and device of x (the eager tree calls it with one shape a block):
    `make_fx` records the ATen ops of `CallableModel.logp_and_grad`
    (vmapped autograd of the interpretation) with phi a per-particle tensor,
    and later calls run that graph, the same ops on the same operands, so
    the values equal the interpreted ones bit for bit. Interpreting the
    program every call costs the host ~14 ms for radon at 512 particles on
    an H100's host, against a negligible device time (PERF.md, §5);
    `CallableModel.logp_and_grad(model, x, phi)` is the interpretation.

    `constrain` runs under `vmap(randomness="different")` inside a forked
    RNG state, so generated quantities that draw (`*_rng`) are deterministic
    from run to run and differ between particles."""

    # Graphs kept per model (shapes, dtypes, devices of x), the oldest
    # dropped beyond.
    MAX_GRAPHS = 8

    def __init__(self, *args, has_rng=False, **kw):
        super().__init__(*args, **kw)
        self.has_rng = has_rng
        self._graphs: dict = {}

    def logp_and_grad(self, x, phi=1.0):
        if not (isinstance(phi, torch.Tensor) and phi.dim() > 0):
            phi = torch.as_tensor(phi, dtype=x.dtype, device=x.device).expand(x.shape[0])
        key = (tuple(x.shape), x.dtype, x.device, phi.dtype)
        graph = self._graphs.get(key)
        if graph is None:
            from torch.fx.experimental.proxy_tensor import make_fx

            interpreted = super().logp_and_grad
            graph = make_fx(lambda xx, pp: interpreted(xx, pp))(x, phi.contiguous())
            if len(self._graphs) >= self.MAX_GRAPHS:
                self._graphs.pop(next(iter(self._graphs)))
            self._graphs[key] = graph
        return graph(x, phi.contiguous())

    def constrain(self, x):
        if not self.has_rng:
            return super().constrain(x)
        devices = [x.device] if x.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            return torch.func.vmap(self._constrain, randomness="different")(x)


def _uses_rng(stmts) -> bool:
    found = False

    def visit(node):
        nonlocal found
        if isinstance(node, Call) and node.name.endswith("_rng"):
            found = True
        if isinstance(node, (list, tuple)):
            for x in node:
                visit(x)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                visit(getattr(node, f.name))

    visit(stmts)
    return found


def compile_stan_program(source: str, data: dict, name: str = "stan",
                         scan_threshold: int | None = 64,
                         tile: bool = False,
                         tile_autodiff: str = "auto") -> StanModel:
    """Compile Stan source + data dict into a `CallableModel` (a
    `StanModel`): `name`, `dim`, `constrained_dim`, `param_names` (with
    `tp.i` and `gq.i` for transformed parameters and generated quantities),
    per-particle `logprior`, `loglik` and `constrain` in torch ops.

    `scan_threshold` is accepted for the JAX frontend's signature and
    ignored: there it lowers long loops to `lax.scan` for XLA's compile time,
    bit-identical to the unrolled interpretation that this port always runs.

    `tile=True` also builds a generated in-kernel model (`ops/generated.py`)
    of the tempered target evaluated ONCE per leaf (target(theta, phi) +
    jacobian, exact under the linear-phi convention), so the program runs
    inside the CUDA NUTS kernel; an op the lowering does not have raises
    NotImplementedError naming it. `tile_autodiff`:
    - "reverse": `tile_model_from_logp` (make_fx of grad_and_value), one
      pass, one thread a particle;
    - "forward": `tile_model_from_logp_fwd`, one tangent pass a coordinate
      over the primal (D <= MAX_FORWARD_DIM), the coordinates as a sequence
      of scalars (`_ParamSpec.constrain_seq`);
    - "auto" (default): forward when dim <= MAX_FORWARD_DIM and the model/TP
      blocks (or a user function body) hold a long static loop that CARRIES
      state across iterations, reverse otherwise — the JAX frontend's choice
      (`smcnuts_tpu/stan/compiler.py:2854-2863`).
    """
    del scan_threshold
    prog = parse(source)
    if "parameters" not in prog.blocks:
        raise StanCompileError("program has no parameters block")

    data_env, has_phi = _build_data_env(prog, data)

    # Parameter specs (constraint bound exprs may reference data).
    spec_interp = _Interp(dict(data_env))
    specs = []
    for decl in prog.blocks["parameters"]:
        if not isinstance(decl, Decl):
            raise StanCompileError("only declarations allowed in parameters block")
        if decl.type == "tuple":
            raise StanCompileError(
                "tuple-typed parameters are not supported (declare the members as separate "
                "parameters)")
        sizes = [_require_int(spec_interp.ev(d), "parameter dimension") for d in decl.dims]
        lower = upper = offset = multiplier = None
        if decl.constraint is not None:
            c = decl.constraint
            if c.lower is not None:
                lower = float(spec_interp.ev(c.lower))
            if c.upper is not None:
                upper = float(spec_interp.ev(c.upper))
            if c.offset is not None:
                offset = float(spec_interp.ev(c.offset))
            if c.multiplier is not None:
                multiplier = float(spec_interp.ev(c.multiplier))
        specs.append(_ParamSpec(decl, sizes, lower, upper, offset=offset, multiplier=multiplier))
    dim = sum(s.count for s in specs)

    tp_block = prog.blocks.get("transformed parameters", [])
    model_block = prog.blocks.get("model", [])
    gq_block = prog.blocks.get("generated quantities", [])

    def _unpack(theta):
        """theta → (param env, total log-Jacobian). Accepts the (dim,)
        vector, or a SEQUENCE of scalar coordinates (the forward-mode
        generated model's no-stack contract; see _ParamSpec.constrain_seq)."""
        seq = isinstance(theta, (list, tuple))
        env = {}
        jac = 0.0
        off = 0
        for s in specs:
            u = theta[off: off + s.count]
            c, j = s.constrain_seq(u) if seq else s.constrain(u)
            env[s.name] = c
            jac = jac + j
            off += s.count
        return env, jac

    param_types = {s.name: s.decl_type for s in specs}
    # The data as tensors of each dtype and device the model meets (`smath.to_tensor`).
    data_cache: dict = {}

    def _env(penv):
        env = dict(data_env)
        # Fresh orientation table per evaluation (the shallow env copy would
        # otherwise share data_env's dict and leak model-block decls).
        env["__types__"] = {**data_env.get("__types__", _EMPTY), **param_types}
        env.update(penv)
        return env

    def _eval_target(theta, phi, scalarize=False):
        like = theta[0] if isinstance(theta, (list, tuple)) else theta
        with smath.evaluation(like.dtype, like.device, data_cache):
            penv, jac = _unpack(theta)
            env = _env(penv)
            if has_phi:
                env["phi"] = phi
            interp = _Interp(env, scalarize=scalarize)
            interp.run(tp_block)
            interp.run(model_block)
            return interp.target, jac

    def logprior(theta):
        t0, jac = _eval_target(theta, 0.0)
        return _scalar_tensor(t0 + jac, theta)

    if has_phi:

        def loglik(theta):
            t1, _ = _eval_target(theta, 1.0)
            t0, _ = _eval_target(theta, 0.0)
            return _scalar_tensor(t1 - t0, theta)

    else:

        def loglik(theta):
            return theta.new_zeros(())

    def _block_values(env, block, rng_key=None):
        """Run a block and return the flattened values of its declarations
        in order (the reference's param_constrain output layout for TP/GQ,
        bridgestan.py:106-120)."""
        interp = _Interp(env, rng_key=rng_key)
        interp.run(block)
        parts = []
        for stmt in block:
            if isinstance(stmt, Decl):
                v = interp.env[stmt.name]
                if v is None:
                    v = float("nan")  # declared, never assigned: Stan's NaN
                elif isinstance(v, _LocalArray):
                    v = v.as_array_filled()
                elif isinstance(v, RowVector):
                    v = v.data
                parts.append(v)
        return parts, interp.env

    def constrain(theta, include_gq=True):
        with smath.evaluation(theta.dtype, theta.device, data_cache):
            penv, _ = _unpack(theta)
            parts = [penv[s.name] for s in specs]
            env = _env(penv)
            if has_phi:
                env["phi"] = 1.0
            if tp_block:
                tp_parts, env = _block_values(env, tp_block)
                parts.extend(tp_parts)
            if gq_block and include_gq:
                gq_parts, _ = _block_values(env, gq_block, rng_key=(0,))
                parts.extend(gq_parts)
            return torch.cat([to_tensor(p).reshape(-1).to(theta.dtype) for p in parts])

    # Eager validation: evaluate the target once so unsupported
    # distributions, undefined variables, and parameter-dependent control
    # flow surface at compile time, not first use.
    probe = torch.zeros(dim, dtype=torch.float32)
    try:
        with torch.no_grad():
            _eval_target(probe, 0.5)
    except (StanCompileError, StanSyntaxError):
        raise
    except Exception as e:  # errors of bad programs
        raise StanCompileError(f"model block failed to evaluate: {e}") from e

    param_names = []
    for s in specs:
        param_names.extend(s.names())
    has_rng = _uses_rng(gq_block)
    with torch.no_grad(), torch.random.fork_rng(devices=[]):
        n_tp_all = int(constrain(probe, include_gq=False).shape[0])
        n_all = int(constrain(probe).shape[0])
    n_tp = n_tp_all - len(param_names)
    n_gq = n_all - n_tp_all
    param_names.extend(f"tp.{i + 1}" for i in range(n_tp))
    param_names.extend(f"gq.{i + 1}" for i in range(n_gq))

    tile_model = None
    if tile:
        from ..ops.generated import MAX_FORWARD_DIM, tile_model_from_logp, tile_model_from_logp_fwd

        def logp_direct(theta, phi):
            # One target evaluation per leaf: logprior + phi*loglik ==
            # target(theta, phi) + jacobian under the linear-phi convention.
            t, jac = _eval_target(theta, phi, scalarize=True)
            return _scalar_tensor(t + jac, theta)

        def logp_direct_seq(coords, phi):
            # Forward-mode contract: coordinates arrive as a sequence of
            # scalars so scalar parameters never pass through a stack.
            t, jac = _eval_target(list(coords), phi, scalarize=True)
            return _scalar_tensor(t + jac, coords[0])

        if tile_autodiff == "auto":
            tile_autodiff = (
                "forward"
                if dim <= MAX_FORWARD_DIM and _has_long_recurrence((tp_block, model_block), data_env)
                else "reverse"
            )
        if tile_autodiff == "forward":
            tile_model = tile_model_from_logp_fwd(logp_direct_seq, dim, name=name)
        elif tile_autodiff == "reverse":
            tile_model = tile_model_from_logp(logp_direct, dim, name=name)
        else:
            raise StanCompileError(
                f"unknown tile_autodiff {tile_autodiff!r}; expected 'auto', 'forward', or "
                "'reverse'")

    return StanModel(
        name, dim, logprior, loglik, constrain=constrain, constrained_dim=n_all,
        param_names=tuple(param_names), tile_model=tile_model, has_rng=has_rng,
    )


def compile_stan_file(stan_path: str, data: Any = None, name: str | None = None,
                      scan_threshold: int | None = 64, tile: bool = False,
                      tile_autodiff: str = "auto") -> StanModel:
    """Compile a `.stan` file (the reference's user-facing model asset,
    reference smcnuts/model/bridgestan.py:13-25) into a `StanModel`.

    `data` may be a dict or a path to a Stan data JSON; `phi` in the data
    block is recognized as the tempering parameter and bound at run time."""
    with open(stan_path) as f:
        source = f.read()
    if data is None:
        data = {}
    elif isinstance(data, (str, os.PathLike)):
        data = load_stan_data(os.fspath(data))
    if name is None:
        name = os.path.splitext(os.path.basename(stan_path))[0]
    return compile_stan_program(source, data, name=name, scan_threshold=scan_threshold,
                                tile=tile, tile_autodiff=tile_autodiff)
