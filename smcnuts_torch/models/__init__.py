"""Target models, each an `nn.Module` whose data are buffers (see base.Model)."""

from . import arma, prmwcd
from .arma import ArmaModel, make_arma
from .base import Model
from .eightschools import EightSchoolsModel, make_eightschools
from .gaussian import GaussianModel, make_gaussian, tempered_moments
from .logistic import LogisticModel, make_logistic
from .prmwcd import PrmwcdModel, make_prmwcd

# The Gaussian target has no name here, as in the JAX package: it is built
# with make_gaussian(mean, var, prior_var).
_REGISTRY = {
    "arma": make_arma,
    "prmwcd": make_prmwcd,
    "PRMwCD": make_prmwcd,
    "eightschools": make_eightschools,
    "logistic": make_logistic,
}
_MODULES = {"arma": arma, "prmwcd": prmwcd, "PRMwCD": prmwcd}


def get_model(name: str, **kwargs) -> Model:
    """Look up a model by name (reference model_name strings accepted)."""
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model '{name}'. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(
            f"model '{name}' stores no step size or ground truth; those of "
            f"{sorted(_MODULES)} come with their data"
        )
    return _MODULES[name]


def default_step_size(name: str) -> float:
    """The step size stored with the model's data; 0.5 for a model without
    one (the reference's default)."""
    return _MODULES[name].default_step_size() if name in _MODULES else 0.5


def ground_truth(name: str):
    """(posterior mean, posterior variance) of the reference's long Stan run."""
    return _module(name).ground_truth()


__all__ = [
    "ArmaModel", "EightSchoolsModel", "GaussianModel", "LogisticModel", "Model",
    "PrmwcdModel", "default_step_size", "get_model", "ground_truth", "make_arma",
    "make_eightschools", "make_gaussian", "make_logistic", "make_prmwcd",
    "tempered_moments",
]
