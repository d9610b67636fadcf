"""Device meshes: the counterpart of the reference package's
``launch/mesh.py``.

Both builders return a ``torch.distributed.device_mesh.DeviceMesh`` with
named dimensions.  ``make_production_mesh`` is a FUNCTION, not a module
constant, so importing this module touches no device and no process
group.

* ``make_production_mesh`` lays the current process group out as one
  pod of 16×16 = 256 GPUs (``data`` × ``model``), or two pods of 512
  with a leading ``pod`` axis.  A group of any other size raises: it
  never falls back to a smaller mesh.
* ``make_cpu_mesh`` is "a tiny mesh over the real devices" for examples
  and tests.  Without a process group it starts a world of size 1 from a
  ``FileStore`` in a temporary directory (no socket), with NCCL on the
  card and gloo on the host; the caller destroys the group.

The constants are NVIDIA H100 SXM data-sheet figures
(https://www.nvidia.com/en-us/data-center/h100/), not measurements:

* ``PEAK_FLOPS_BF16``: dense bf16 tensor-core rate, without sparsity;
* ``HBM_BW``: HBM3 bandwidth;
* ``ICI_BW``: NVLink 4 per GPU in one direction (half the 900 GB/s
  bidirectional figure).  It stands for the intra-group collective rate
  that :mod:`.cosched` scales by a placement's group crossings.
"""

from __future__ import annotations

import math
import os
import tempfile

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

PEAK_FLOPS_BF16 = 989.4e12     # per GPU, FLOP/s
HBM_BW = 3.35e12               # per GPU, bytes/s
ICI_BW = 450e9                 # per GPU, one direction, bytes/s


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The 256- or 512-GPU mesh over the current process group.
    ``device=None`` is CUDA.  Raises ``RuntimeError`` without a process
    group and ``ValueError`` when its size is not the mesh's."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh needs a process group of "
                           f"{n} ranks; none is initialized")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs {n} "
            f"ranks; the process group has world size {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_cpu_mesh(n_data: int = 1, n_model: int = 1, *,
                  device=None) -> DeviceMesh:
    """A (``data``, ``model``) mesh over the real devices.  ``device=None``
    is CUDA; pass ``"cpu"`` for gloo.  Starts a world of size 1 when no
    process group exists (so ``n_data * n_model`` must then be 1)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"),
                            "store")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.FileStore(path, 1),
                                world_size=1, rank=0)
    world = dist.get_world_size()
    if world != n_data * n_model:
        raise ValueError(
            f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks; "
            f"the process group has world size {world}")
    return init_device_mesh(dev.type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))
