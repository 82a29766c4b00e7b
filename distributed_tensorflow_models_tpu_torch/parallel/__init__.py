"""The parallel layers of the port: the Switch-MoE FFN over the data x seq
processes or the expert axis (``moe.py``), tensor parallelism over the
model axis (``tensor.py``: the rule sets and the split layers), sequence
parallelism over the seq axis (``ring.py``: ring and Ulysses attention),
pipeline parallelism over the pipe axis (``pipeline.py``: GPipe), and the
reference's async parameter-server and backup-replica training, emulated
(``async_ps.py``, ``backup.py``)."""

from distributed_tensorflow_models_tpu_torch.parallel import (
    async_ps,
    backup,
    moe,
    pipeline,
    ring,
    tensor,
)

__all__ = ["async_ps", "backup", "moe", "pipeline", "ring", "tensor"]
