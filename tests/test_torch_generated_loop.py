"""Forward-mode generated programs with their recurrences emitted as loops
(`ops/generated.py`: `_reroll`, `Recurrence`, `Register`, `_c_recurrences`,
`_unroll`).

- The re-roll pass finds the recurrence of the generated arma (T = 200), of
  the Stan AR(1)-error recurrence at T = 200 (two loops, the second
  gathering the first's values at the same step, so run in the first's
  iterations) and of the Stan
  irt_ar (four kinds of step, y[t] in {0, 1} times an item's first or later
  visit; the gather of b[item[t]] and the accumulator of its gradient as
  arrays of 60 slots indexed by the data).
- Each re-rolled program's ops are the straight-line program's, traced on
  its own (`reroll=False`), and that witness's source is byte for byte the
  emission before this pass (its hash).
- An emulation in numpy float32 of what the emitted CUDA computes (the
  straight-line ops in order; each loop step by step with its kind read from
  the data block, its registers, slots, columns and export arrays, assigned
  at the step's end; then the nodes read after it) equals the plain version
  (`GeneratedModel.logp_and_grad`, the fx graph) to the bit.
- The loop's source does not grow with T (T = 50 against T = 200); a
  program without a recurrence, one whose steps differ beyond
  REROLL_MAX_KINDS kinds, and those whose loops would pass values through
  local memory (a copy of the straight line's values, or a gather that
  cannot run in the other loop's iterations) keep the straight-line source
  byte for byte.
"""

import json

import numpy as np
import pytest
import torch

from smcnuts_torch.models.arma import arma_model_fwd, load_asset
from smcnuts_torch.ops import generated
from smcnuts_torch.ops.generated import (
    REROLL_MAX_KINDS, count_ops, peak_live, straight_line, tile_model_from_logp_fwd)
from smcnuts_torch.stan import compile_stan_program, load_stan_data

torch.set_num_threads(2)

F = np.float32
# The AR(1)-error recurrence of tests/test_stan_frontend.py's scan tests.
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
# Source hashes of the straight-line emission, as the default emitted them
# before recurrences were re-rolled.
STRAIGHT_HASHES = {"arma": "1ff502da53b0384c", "ar1_errors_t200": "d86dc246cbc61b72",
                   "irt_ar": "56310678f6d48322"}
RADON_HASH = "1d3c44e1383890f3"


def _recurrence(T, reroll=True):
    y = np.random.default_rng(3).normal(size=T)
    return compile_stan_program(RECURRENCE, {"T": T, "y": y.tolist()}, name="ar1_errors_t200",
                                tile=True, tile_reroll=reroll).tile_model


def _stan_file(name, reroll=True):
    path = f"examples/stan/{name}.stan"
    with open(path) as f:
        src = f.read()
    return compile_stan_program(src, load_stan_data(path[:-5] + ".json"), name=name, tile=True,
                                tile_reroll=reroll).tile_model


MAKERS = {
    "arma": lambda reroll: arma_model_fwd(reroll=reroll).tile_model,
    "ar1_errors_t200": lambda reroll: _recurrence(200, reroll),
    "irt_ar": lambda reroll: _stan_file("irt_ar", reroll),
}


@pytest.fixture(scope="module")
def programs():
    """Each program re-rolled (the default) and straight-line, each traced."""
    return {name: {r: build(r) for r in (True, False)} for name, build in MAKERS.items()}


def _points(tm, n, seed):
    rng = np.random.default_rng(seed)
    if tm.dim == 4:  # arma: near its posterior
        c = np.array([0.007, 0.957, -0.034, -1.8])
        return (c + 0.05 * rng.normal(size=(n, 4))).astype(np.float32)
    return (0.4 * rng.normal(size=(n, tm.dim))).astype(np.float32)


def test_arma_is_one_loop_of_one_kind(programs):
    prog = programs["arma"][True].program
    (rec,) = prog.recurrences
    assert len(rec.bounds) - 1 == 197 and len(rec.classes) == 1 and rec.kind == -1
    # The error, its three tangents and the sums of their products carried
    # in registers; y[t] and y[t - 1] columns of the data block.
    assert len(rec.registers) == 11 and all(r.index == -1 for r in rec.registers)
    assert rec.arrays == () and len(prog.data) > 2 * 197
    assert rec.bounds[-1] - rec.bounds[0] > 0.95 * len(prog.ops)
    # 19 template ops a step: unrolled by 8, the most (REROLL_UNROLL_OPS).
    assert "#pragma unroll 8" in programs["arma"][True].source


def test_the_stan_recurrence_is_two_loops(programs):
    prog = programs["ar1_errors_t200"][True].program
    first, second = prog.recurrences
    assert len(first.bounds) - 1 >= 190 and len(second.bounds) - 1 >= 190
    # The second, the sum of squares of normal_lpdf(e | 0, s), gathers e[t]
    # and its tangent from the first at the same step: it runs in the
    # first's iterations, and the values pass in registers, not through the
    # first's export arrays.
    assert len(first.arrays) == 2
    gathers = [r for r in second.registers if r.alias]
    assert {r.alias for r in gathers} == {(0, 0), (0, 1)}
    assert (first.head, second.head, second.shift) == (-1, 0, 0)
    src = programs["ar1_errors_t200"][True].source
    assert "r0e0[" not in src and "r0x0 = " in src and src.count("for (int ") == 1
    covered = sum(r.bounds[-1] - r.bounds[0] for r in prog.recurrences)
    assert covered > 0.9 * len(prog.ops)


def test_irt_ar_is_one_loop_of_four_kinds(programs):
    prog = programs["irt_ar"][True].program
    (rec,) = prog.recurrences
    data = json.load(open("examples/stan/irt_ar.json"))
    assert len(rec.bounds) - 1 == 118 and len(rec.classes) == 4
    # The kinds: y[t] and whether item[t] was seen before, the first two
    # steps peeled.
    seen, want = set(data["item"][:2]), []
    for t in range(2, 120):
        want.append((data["y"][t], data["item"][t] in seen))
        seen.add(data["item"][t])
    assert len(set(want)) == 4
    ids = {}
    assert [ids.setdefault(w, len(ids)) for w in want] == list(rec.kinds)
    assert [int(v) for v in prog.data[rec.kind:rec.kind + 118]] == list(rec.kinds)
    # b[item[t]] gathered, and the gradient of b[item[t]] accumulated, in
    # arrays of J = 60 slots indexed by the data: item[t] - 1 rotated by the
    # two peeled steps.
    indexed = [r for r in rec.registers if r.index >= 0]
    assert sorted(len(r.init) for r in indexed) == [60, 60]
    slots = [int(v) for v in prog.data[indexed[0].index:indexed[0].index + 118]]
    assert slots == [(i - 3) % 60 for i in data["item"][2:]]
    assert {r.writes == () for r in indexed} == {True, False}
    assert rec.arrays == ()
    # 202 template ops in its four kinds: unrolled by 2 (REROLL_UNROLL_OPS).
    assert "#pragma unroll 2" in programs["irt_ar"][True].source


@pytest.mark.parametrize("name", list(MAKERS))
def test_the_program_is_the_straight_line_one(programs, name):
    loop, flat = programs[name][True], programs[name][False]
    assert loop.program.recurrences and not flat.program.recurrences
    assert loop.program.ops == flat.program.ops
    assert (loop.program.logp, loop.program.grad) == (flat.program.logp, flat.program.grad)
    assert loop.program.data[:len(flat.program.data)] == flat.program.data
    assert count_ops(loop.program) == count_ops(flat.program) == loop.n_ops
    assert peak_live(loop.program) == peak_live(flat.program)
    assert flat.hash == STRAIGHT_HASHES[name]
    assert straight_line(loop).source == flat.source
    assert loop.source != flat.source and "#pragma unroll" in loop.source
    for k in range(len(loop.program.recurrences)):
        generated._check_unrolled(loop.program, k)


def _unary(op, a):
    return generated._UNARY[op](torch.from_numpy(a)).numpy()


def _apply(op, a):
    binary = {"add": np.add, "sub": np.subtract, "mul": np.multiply, "div": np.divide}
    if op in binary:
        return binary[op](a[0], a[1]).astype(F)
    if op in generated._CMP:
        return generated._CMP[op](a[0], a[1])
    if op == "where":
        return np.where(a[0], a[1], a[2]).astype(F)
    if op == "pow":
        return torch.pow(torch.from_numpy(a[0]), float(a[1])).numpy()
    return _unary(op, a[0])


def _emulate(prog, x, phi):
    """The emitted CUDA of a program with recurrences, for particles x (P, D),
    each value a float32 vector over the particles: the straight-line ops in
    order; each loop, with the loops that run in its iterations, over its
    iterations, a loop's gathers of the loop before it in the same
    iteration reading the entry that loop has just made; then the nodes
    read after the loops."""
    data, P, recs = np.asarray(prog.data, F), x.shape[0], prog.recurrences
    v = {}

    def val(a):
        return v[a] if type(a) is int else np.full(P, a, F)

    def line(i):
        op, *a = prog.ops[i]
        v[i] = (x[:, a[0]].copy() if op == "x" else np.full(P, phi, F) if op == "phi"
                else np.full(P, data[a[0]], F) if op == "data"
                else _apply(op, [val(u) for u in a]))

    arrays, regs, done, k = {}, {}, 0, 0
    while k < len(recs):
        group = [k] + [m for m in range(k + 1, len(recs)) if recs[m].head == k]
        for i in range(done, recs[k].bounds[0]):
            line(i)
        for a, b in zip(group, group[1:]):
            for i in range(recs[a].bounds[-1], recs[b].bounds[0]):
                line(i)
        for m in group:
            regs[m] = [[val(u) if u is not None else np.zeros(P, F) for u in r.init]
                       for r in recs[m].registers]
            arrays[m] = [[None] * (len(recs[m].bounds) - 1) for _ in recs[m].arrays]
        span = {m: (recs[m].shift, recs[m].shift + len(recs[m].bounds) - 1) for m in group}
        for it in range(min(a for a, _ in span.values()), max(b for _, b in span.values())):
            current = {}
            for m in group:
                rec, step = recs[m], it - span[m][0]
                if not 0 <= step < len(rec.bounds) - 1:
                    continue
                kind = int(data[rec.kind + step]) if rec.kind >= 0 else 0
                t = []

                def slot(r):
                    return int(data[r.index + step]) if r.index >= 0 else 0

                def ref(r):
                    kind_, u = r
                    if kind_ == "t":
                        return t[u]
                    if kind_ == "u":
                        return val(u)
                    if kind_ == "col":
                        return np.full(P, data[u + step], F)
                    reg = rec.registers[u]
                    if reg.alias and rec.head >= 0:
                        return current[reg.alias]
                    if reg.alias:
                        return arrays[reg.alias[0]][reg.alias[1]][slot(reg)]
                    return regs[m][u][slot(reg)]

                for op, refs in rec.classes[kind]:
                    t.append(np.full(P, phi, F) if op == "phi" else ref(refs[0]) if op == "data"
                             else _apply(op, [ref(r) for r in refs]))
                for R, reg in enumerate(rec.registers):
                    for c, j in reg.writes:
                        if c == kind:
                            regs[m][R][slot(reg)] = t[j]
                for a, arr in enumerate(rec.arrays):
                    for c, j in arr:
                        if c == kind:
                            arrays[m][a][step] = current[(m, a)] = t[j]
        for m in group:
            for node, src in recs[m].outs:
                v[node] = (arrays[m][src[1]][src[2]] if src[0] == "e"
                           else regs[m][src[1]][src[2] if len(src) == 3 else 0])
        done, k = recs[group[-1]].bounds[-1], group[-1] + 1
    for i in range(done, len(prog.ops)):
        line(i)
    return val(prog.logp), np.stack([val(g) for g in prog.grad], axis=1)


def _same_bits(a, b):
    a, b = np.asarray(a, F), np.asarray(b, F)
    return np.all((a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b)))


@pytest.mark.parametrize("phi", [1.0, 0.4])
@pytest.mark.parametrize("name", list(MAKERS))
def test_the_emulated_loop_equals_the_plain_version_to_the_bit(programs, name, phi):
    tm = programs[name][True]
    x = _points(tm, 32, seed=len(name))
    lp, g = tm.logp_and_grad(torch.as_tensor(x), phi)
    with np.errstate(all="ignore"):
        lp_e, g_e = _emulate(tm.program, x, phi)
    assert _same_bits(lp.numpy(), lp_e) and _same_bits(g.numpy(), g_e)
    assert np.isfinite(lp_e).all() and np.isfinite(g_e).all()


def test_the_source_does_not_grow_with_T(programs):
    y = load_asset()["y"]
    for name, build in (("arma", lambda T, r: arma_model_fwd(y[:T], reroll=r).tile_model),
                        ("ar1_errors_t200", _recurrence)):
        short, long = build(50, True), programs[name][True]
        assert len(short.program.recurrences) == len(long.program.recurrences)
        lines = [len(tm.source.splitlines()) for tm in (short, long)]
        assert abs(lines[0] - lines[1]) <= 3, lines
        flat = [len(tm.source.splitlines()) for tm in (build(50, False), programs[name][False])]
        assert flat[1] - flat[0] > 1000 and lines[1] < flat[1] / 10, (lines, flat)


def test_a_program_without_a_recurrence_keeps_its_source():
    def logp(c, phi):
        x, y = c
        return -0.5 * (x * x + y * y) + phi * torch.tanh(x * y) - torch.log1p(torch.exp(y))

    loop, flat = (tile_model_from_logp_fwd(logp, 2, reroll=r) for r in (True, False))
    assert loop.program.recurrences == () and loop.source == flat.source
    # A reverse-mode program (radon, through the Stan frontend) is not
    # re-rolled: the source before this pass.
    radon = _stan_file("radon_intercepts")
    assert radon.autodiff == "reverse" and radon.program.recurrences == ()
    assert radon.hash == RADON_HASH


def test_a_gather_of_straight_line_values_keeps_the_straight_line_emission():
    """An AR(1) error recurrence with no sum inside its steps: no chain of
    one op finds its steps, and the sum of squares after it would gather
    each e[t] (and its tangents) from a slot of its own, copying the
    straight line's values into local memory: no loop, the straight-line
    source."""
    y = [float(v) for v in np.random.default_rng(5).normal(size=120)]

    def logp(c, phi):
        mu, a, ls = c
        e = [y[0] - mu]
        for t in range(1, len(y)):
            e.append(y[t] - mu - a * e[-1])
        s2 = 0.5 * sum(v * v for v in e)
        return -0.5 * (mu * mu + a * a + ls * ls) - phi * (s2 * torch.exp(-2.0 * ls)
                                                           + len(y) * ls)

    loop, flat = (tile_model_from_logp_fwd(logp, 3, name="ar errors", reroll=r)
                  for r in (True, False))
    assert loop.program.recurrences == () and loop.source == flat.source


def test_a_gather_that_cannot_run_in_the_loop_keeps_the_straight_line_emission():
    """An error recurrence with its sum in its steps, then a sum of e[t]^2
    from t = 7: its loop gathers e[t] from the first loop's steps, but its
    peeled first steps read them too, so it cannot run in the first loop's
    iterations and would pass e[t] through export arrays in local memory.
    No loop, the straight-line source."""
    y = [float(v) for v in np.random.default_rng(5).normal(size=80)]

    def logp(c, phi):
        a, s = c
        e, first = [y[0] - a * 0.5], a * 0.0
        for t in range(1, len(y)):
            e.append(y[t] - a * e[-1])
            first = first + e[-1]
        acc = a * 0.0
        for t in range(7, len(y)):
            acc = acc + e[t] * e[t]
        return -0.5 * (a * a + s * s) - phi * 0.01 * (acc + first) * torch.exp(-s)

    loop, flat = (tile_model_from_logp_fwd(logp, 2, name="two sums", reroll=r)
                  for r in (True, False))
    assert loop.program.recurrences == () and loop.source == flat.source


def test_steps_that_differ_keep_the_straight_line_emission():
    """A recurrence whose step t applies one of twelve maps (more kinds of
    step than REROLL_MAX_KINDS): no loop, no error, the straight-line
    source."""
    maps = [torch.exp, torch.tanh, torch.log1p, torch.sqrt, torch.abs, torch.sigmoid,
            torch.expm1, lambda u: 1.0 / (1.0 + u), lambda u: u * u, lambda u: u * u * u,
            lambda u: torch.log(u), lambda u: torch.tanh(2.0 * u)]
    order = np.random.default_rng(4).permutation(np.arange(60) % len(maps))
    assert len(maps) > REROLL_MAX_KINDS

    def logp(c, phi):
        a, b = c
        th, acc = b * 0.0 + 1.0, a * 0.0
        for t in range(60):
            th = 0.9 * th + 0.1 * torch.exp(a)
            acc = acc + maps[order[t]](th * th + 0.5)
        return -0.5 * (a * a + b * b) + phi * 0.01 * acc

    loop, flat = (tile_model_from_logp_fwd(logp, 2, name="twelve maps", reroll=r)
                  for r in (True, False))
    assert loop.program.recurrences == () and loop.source == flat.source
    x = torch.tensor([[0.1, -0.2], [0.3, 0.5]])
    assert torch.isfinite(loop.logp_and_grad(x, 0.5)[0]).all()
