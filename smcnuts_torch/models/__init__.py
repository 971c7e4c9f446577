"""Target models, each an `nn.Module` whose data are buffers (see base.Model)."""

from .arma import ArmaModel, make_arma
from .base import Model

_REGISTRY = {"arma": make_arma}
_NOT_PORTED = ("prmwcd", "PRMwCD", "eightschools", "logistic", "gaussian")


def get_model(name: str, **kwargs) -> Model:
    """Look up a model by name (reference model_name strings accepted)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model '{name}' is not ported to smcnuts_torch yet "
            "(ROADMAP Queue 1 item 8)"
        )
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model '{name}'. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


__all__ = ["ArmaModel", "Model", "get_model", "make_arma"]
