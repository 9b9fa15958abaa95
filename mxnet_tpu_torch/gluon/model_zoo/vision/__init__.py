"""Vision model zoo of the port: the ResNets, by the reference's
`get_model` names."""
from .resnet import *  # noqa: F401,F403
from . import resnet as _resnet

_MODELS = {name: getattr(_resnet, name) for name in _resnet.__all__
           if name.startswith("resnet")}


def get_model(name, **kwargs):
    """Return a model by name (the ResNets of the reference's model
    zoo)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(
            "Model %s is not supported. Available options are:\n\t%s"
            % (name, "\n\t".join(sorted(_MODELS))))
    return _MODELS[name](**kwargs)
