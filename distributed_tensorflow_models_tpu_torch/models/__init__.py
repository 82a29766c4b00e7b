"""Model zoo registry: ``register`` a builder under a config name and
``get_model`` it back.  Counterpart of
``distributed_tensorflow_models_tpu/models/__init__.py``; the port has the
ImageNet ResNets and the dense transformer LM."""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, **kwargs):
    """Instantiate a registered model builder by config name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_models() -> list[str]:
    return sorted(_REGISTRY)


# Import for registration side effects.
from distributed_tensorflow_models_tpu_torch.models import resnet  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models.resnet import ResNet  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models import transformer_lm  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import TransformerLM  # noqa: E402,F401
