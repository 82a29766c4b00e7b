"""Model zoo registry: ``register`` a builder under a config name and
``get_model`` it back.  Counterpart of
``distributed_tensorflow_models_tpu/models/__init__.py``; the port has the
whole reference zoo: LeNet, CIFAR ResNet-32, the ImageNet ResNets,
Inception-v3, VGG-16, AlexNet, the PTB LSTM and the dense transformer LM."""

from __future__ import annotations

import inspect
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


def builder_takes(name: str, kwarg: str) -> bool:
    """Whether the builder registered as ``name`` names ``kwarg`` among its
    parameters (a class registered directly: its ``__init__``'s)."""
    return kwarg in inspect.signature(_REGISTRY[name]).parameters


def available_models() -> list[str]:
    return sorted(_REGISTRY)


# Import for registration side effects, in the JAX registry's order.
from distributed_tensorflow_models_tpu_torch.models import lenet  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models import resnet_cifar  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models import resnet  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models import inception_v3  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models import vgg  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models import alexnet  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models import ptb_lstm  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models import transformer_lm  # noqa: E402,F401

from distributed_tensorflow_models_tpu_torch.models.lenet import LeNet  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models.resnet_cifar import CifarResNet  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models.resnet import ResNet  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models.inception_v3 import InceptionV3  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models.vgg import VGG16  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models.alexnet import AlexNet  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models.ptb_lstm import PTBLSTM  # noqa: E402,F401
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import TransformerLM  # noqa: E402,F401
