"""The parallel layers of the port: the Switch-MoE FFN over the data x seq
processes (``moe.py``), tensor parallelism over the model axis
(``tensor.py``: the rule sets and the split layers) and sequence
parallelism over the seq axis (``ring.py``: ring and Ulysses attention).
Pipeline and expert parallelism are not ported yet."""

from distributed_tensorflow_models_tpu_torch.parallel import moe, ring, tensor

__all__ = ["moe", "ring", "tensor"]
