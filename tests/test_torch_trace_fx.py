"""`ops.generated.trace_fx`, the port's tracer of densities, against
make_fx: node for node the same graph.

trace_fx is make_fx(fn)(*inputs) run inside one TracingContext, so that
every node's metadata comes from one FakeTensorMode instead of a new one a
node (`torch._guards.tracing`, `TracingContext` and `FakeTensorMode` are
torch's own, as of torch 2.11 and 2.13). Every trace the port makes goes
through it: a generated model's (reverse mode: eight schools, lv_rk4 under
--stan-tile; forward mode: arma) and a StanModel's replayed graph. Each case
records what trace_fx traced and traces it again with make_fx alone; the
two graphs must have the same nodes in the same order (op, name, target,
arguments) and the same constants, to the bit.
"""

import os
import sys

import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from smcnuts_torch.ops import generated as gen

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nodes(gm):
    """(op, name, target, arguments) of every node, arguments by name."""
    out = []
    for n in gm.graph.nodes:
        args = torch.fx.node.map_arg((n.args, n.kwargs), lambda a: a.name)
        out.append((n.op, n.name, str(n.target), repr(args)))
    return out


def _constants(gm):
    return {n.target: getattr(gm, n.target) for n in gm.graph.nodes if n.op == "get_attr"}


def _lv_rk4(steps=2, years=4):
    """chip_smoke.py's lv_rk4 at `steps` RK4 steps a year over its first
    `years` years (there 12 steps over 20 years)."""
    sys.path.insert(0, _REPO)
    from chip_smoke import LV_PROGRAM, lv_data

    data = lv_data()
    data = {**data, "N": years, "ts": data["ts"][:years], "y": data["y"][:years]}
    return (LV_PROGRAM.replace("{solver}", f"ode_rk4(dz_dt, z_init, 0, ts, {steps}, theta)"),
            data)


def _build(case):
    if case == "arma":
        from smcnuts_torch.models.arma import arma_model_fwd

        arma_model_fwd()
    elif case == "eightschools":
        from smcnuts_torch.models.eightschools import make_eightschools_generated

        make_eightschools_generated()
    elif case == "lv_rk4_tile":
        from smcnuts_torch.stan import compile_stan_program

        compile_stan_program(*_lv_rk4(), name="lv_rk4", tile=True)
    else:  # a StanModel's graph, traced at its first call of a shape
        from smcnuts_torch.stan import compile_stan_program

        m = compile_stan_program(*_lv_rk4(), name="lv_rk4")
        m.logp_and_grad(torch.zeros(3, m.dim), torch.ones(3))


@pytest.mark.parametrize("case", ["arma", "eightschools", "lv_rk4_tile", "lv_rk4_replay"])
def test_trace_fx_graph_equals_make_fx_node_for_node(monkeypatch, case):
    traced = []
    real = gen.trace_fx

    def recording(fn, *inputs):
        gm = real(fn, *inputs)
        traced.append((gm, make_fx(fn)(*inputs)))
        return gm

    monkeypatch.setattr(gen, "trace_fx", recording)
    _build(case)
    assert traced, f"{case}: nothing went through trace_fx"
    for ours, theirs in traced:
        assert _nodes(ours) == _nodes(theirs)
        a, b = _constants(ours), _constants(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
