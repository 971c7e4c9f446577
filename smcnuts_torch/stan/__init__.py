"""Stan-language frontend of the port: compile `.stan` + data JSON into a
`CallableModel` in torch ops (the port of `smcnuts_tpu/stan/`).

`compile_stan_file("model.stan", data="model.json")` returns a model whose
log-density is an interpretation of the program in torch ops, differentiated
by autograd on the eager backend, and with `tile=True` also a generated
in-kernel model (`ops/generated.py`) that runs inside the CUDA NUTS kernel:
every program the JAX frontend tiles (dense linear algebra, the algebra
solvers, the adaptive ODE solvers inlined in the kernel, reverse mode), an op
the lowering lacks raising NotImplementedError naming it.
See compiler.py for the supported subset and semantics.
"""

from .compiler import (
    StanCompileError,
    compile_stan_file,
    compile_stan_program,
    load_stan_data,
)
from .parser import StanSyntaxError, parse

__all__ = [
    "compile_stan_file",
    "compile_stan_program",
    "load_stan_data",
    "parse",
    "StanCompileError",
    "StanSyntaxError",
]
