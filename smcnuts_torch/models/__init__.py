"""Target models, each an `nn.Module` whose data are buffers (see base.Model)."""

from . import arma, prmwcd
from .arma import ArmaModel, make_arma
from .base import Model
from .prmwcd import PrmwcdModel, make_prmwcd

_MODULES = {"arma": arma, "prmwcd": prmwcd, "PRMwCD": prmwcd}
_NOT_PORTED = ("eightschools", "logistic", "gaussian")


def _module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model '{name}' is not ported to smcnuts_torch yet "
            "(ROADMAP Queue 1 item 8)"
        )
    if name not in _MODULES:
        raise KeyError(f"Unknown model '{name}'. Available: {sorted(_MODULES)}")
    return _MODULES[name]


def get_model(name: str, **kwargs) -> Model:
    """Look up a model by name (reference model_name strings accepted)."""
    module = _module(name)
    return (make_arma if module is arma else make_prmwcd)(**kwargs)


def default_step_size(name: str) -> float:
    """The step size stored with the model's data."""
    return _module(name).default_step_size()


def ground_truth(name: str):
    """(posterior mean, posterior variance) of the reference's long Stan run."""
    return _module(name).ground_truth()


__all__ = [
    "ArmaModel", "Model", "PrmwcdModel", "default_step_size", "get_model",
    "ground_truth", "make_arma", "make_prmwcd",
]
