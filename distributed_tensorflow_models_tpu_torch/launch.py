"""Joining a multi-process cluster from the launcher's environment.

PyTorch counterpart of the bootstrap half of
``distributed_tensorflow_models_tpu/launch.py``: a launcher (the JAX
package's ``launch_local``, or any other) starts one process per device
and gives each the cluster's facts in ``DTM_*`` variables;
:func:`initialize_from_env` joins this process to the others' process
group (``core/mesh.py::initialize_multihost``).  The launcher itself and
its supervision, and the fleet heartbeat the reference starts here, are
not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

ENV_COORDINATOR = "DTM_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "DTM_NUM_PROCESSES"
ENV_PROCESS_ID = "DTM_PROCESS_ID"
# Read by the JAX package (fake CPU devices per process); the port runs one
# device per process and ignores it.
ENV_CPU_DEVICES = "DTM_CPU_DEVICES_PER_PROCESS"


def initialize_from_env(device: Optional[str | torch.device] = None) -> bool:
    """Join the process group the ``DTM_*`` variables describe.

    Returns False, and does nothing, when the environment carries no
    cluster facts (a single process: the common case).  Otherwise joins
    the group of ``DTM_NUM_PROCESSES`` processes as ``DTM_PROCESS_ID``
    through the store at ``DTM_COORDINATOR_ADDRESS`` (``host:port``) and
    returns True.  ``device`` is this process's device: by default
    ``cuda:{LOCAL_RANK or 0}`` over NCCL; ``"cpu"`` joins over gloo."""
    coord = os.environ.get(ENV_COORDINATOR)
    nproc = os.environ.get(ENV_NUM_PROCESSES)
    pid = os.environ.get(ENV_PROCESS_ID)
    if not (coord and nproc and pid):
        return False

    from distributed_tensorflow_models_tpu_torch.core.mesh import (
        initialize_multihost,
    )

    initialize_multihost(coord, int(nproc), int(pid), device=device)
    return True
