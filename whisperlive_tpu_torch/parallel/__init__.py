"""Tensor and data parallelism over torch.distributed: the rank grid and
parameter slices (mesh), multi-host worlds (multihost) and multi-process
serving through the op log (serve_multihost)."""

from whisperlive_tpu_torch.parallel.mesh import EngineShardings, make_mesh  # noqa: F401
from whisperlive_tpu_torch.parallel import multihost  # noqa: F401
