"""Meshes of ranks over ``torch.distributed``: the counterparts of
``repro.launch.mesh``.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh``: one rank a
device, the axes named as the reference names them ("data" and "model",
with "pod" in front across pods).  Functions, never module-level
constants, so importing this module touches no process group and no
device.

The device resolves as everywhere in the port: the card unless the caller
names the CPU (``isn.backend.resolve_device``), raising when no CUDA
device is present.  NCCL carries the card's collectives, gloo the CPU's.
``mesh_context`` puts a mesh in scope for the model code, as the
reference enters JAX's abstract mesh: inside it
``models.common.get_abstract_mesh_or_none()`` returns the mesh, and the
model code takes its mesh branches (MoE's, ``sharded_streaming_topk``'s)
and its ``constrain`` calls.
"""

from __future__ import annotations

import contextlib
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.isn.backend import resolve_device
from repro_torch.models.common import use_mesh

# how long a collective of a locally created group may wait for its peers
LOCAL_TIMEOUT = timedelta(seconds=120)


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh):
    """Put ``mesh`` in scope for the model code (the reference enters the
    physical and the abstract mesh; a ``DeviceMesh`` is both here).  Inside
    it a plain tensor that meets a DTensor (a constant the model code
    makes, say the positions) counts as replicated, as a JAX constant is
    under the reference's mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    with use_mesh(mesh), implicit_replication():
        yield mesh


def backend_for(device: torch.device) -> str:
    """The collective backend of a device type: NCCL on the card, gloo on
    the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None,
                         fake: bool = False) -> DeviceMesh:
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks).

    The default process group is the launcher's (``torchrun`` sets each
    rank's environment, and ``init_device_mesh`` initializes the group from
    it when none exists); its world size must be the mesh's.  With
    ``fake`` (the dry run's ``fake`` group) the device type is taken as
    named, with no card behind it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    kind = torch.device(device or "cuda").type if fake else \
        resolve_device(device).type
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_local_mesh(model_axis: int = 1,
                    device: str | torch.device | None = None) -> DeviceMesh:
    """A (world // model_axis, model_axis) mesh over the ranks that exist
    (tests, the smoke run).

    When no default process group exists, this initializes one explicitly:
    world size 1, rank 0, over an in-process ``HashStore``, NCCL on the
    card (the current CUDA device) and gloo on the CPU, with a finite
    timeout (``LOCAL_TIMEOUT``).  The caller ends it with
    ``torch.distributed.destroy_process_group()``.  Several ranks bring
    their own group (``init_process_group`` with a store, a rank and a
    world size) before calling this."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device()
                                  if dev.index is None else dev.index)
        dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                                rank=0, world_size=1, timeout=LOCAL_TIMEOUT)
    n = dist.get_world_size()
    data = max(n // model_axis, 1)
    return init_device_mesh(dev.type, (data, model_axis),
                            mesh_dim_names=("data", "model"))


def mesh_info(mesh: DeviceMesh) -> dict:
    return {
        "axes": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "n_devices": int(mesh.size()),
    }
