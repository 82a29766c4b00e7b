"""The parallel layers of the port: the Switch-MoE FFN over the data x seq
processes or the expert axis (``moe.py``), tensor parallelism over the
model axis (``tensor.py``: the rule sets and the split layers), sequence
parallelism over the seq axis (``ring.py``: ring and Ulysses attention)
and pipeline parallelism over the pipe axis (``pipeline.py``: GPipe)."""

from distributed_tensorflow_models_tpu_torch.parallel import (
    moe,
    pipeline,
    ring,
    tensor,
)

__all__ = ["moe", "pipeline", "ring", "tensor"]
