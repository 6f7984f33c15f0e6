"""Device meshes for frame- and segment-sharded coding
(gpujpeg_tpu.parallel.mesh).

The reference is single-GPU (gpujpeg_init_device selects ONE device,
gpujpeg_common.c:220-288); the JAX package added two mesh axes, and the
port keeps them:

  'data': frames of a batch (no communication between them)
  'seg':  horizontal stripes of one frame, each a run of whole restart
          segments of every scan, so each stripe codes on its own

A Mesh is a (data, seg) numpy array of MeshDevice entries, built the way
jax.sharding.Mesh(devices, ("data", "seg")) is.  An entry names a torch
device and the process that owns it; entries are distinct objects, so a
torch device may stand in more than one place of a mesh: the CPU tests'
meshes put "cpu" in every place, and a mesh of cuda:0 four times drives
the 'seg' path on one card.  frame_sharding and replicated are the
placements P("data") and P() of the JAX package, as small descriptors
that parallel.dist.make_global_batch reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

AXES = ("data", "seg")


@dataclasses.dataclass(frozen=True)
class MeshDevice:
    """One place of a mesh: a torch device and the process that owns it
    (the process_index of a JAX device).  id tells places apart, so two
    places of one torch device are two entries."""

    id: int
    device: torch.device
    process_index: int = 0


class Mesh:
    """A (data, seg) array of MeshDevice entries with named axes
    (jax.sharding.Mesh's .devices, .shape and .axis_names)."""

    def __init__(self, devices, axis_names: Sequence[str] = AXES) -> None:
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of axes {tuple(axis_names)} needs a "
                             f"{len(axis_names)}-D device array, got "
                             f"{arr.shape}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, row: int, seg: int = 0) -> torch.device:
        """The torch device of place (row, seg)."""
        return self.devices[row, seg].device

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def local_devices(n_devices: Optional[int] = None,
                  device=None) -> Tuple[torch.device, ...]:
    """The torch devices of a mesh's places: the CUDA devices (the first
    n_devices, all of them by default; raises without CUDA), or n_devices
    entries of one device when `device` names one ("cpu", "cuda:0")."""
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)            # raises: no CUDA device
        devs = tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"{n_devices} devices asked for, "
                                 f"{len(devs)} CUDA devices present")
            devs = devs[:n_devices]
        return devs
    dev = resolve_device(device)
    return (dev,) * (1 if n_devices is None else n_devices)


def make_mesh(n_devices: Optional[int] = None,
              data: Optional[int] = None,
              seg: int = 1, device=None) -> Mesh:
    """Build a ('data', 'seg') mesh over the first n_devices CUDA devices,
    or over n_devices places of `device` ("cpu" for the tests, "cuda:0"
    to stack every place on one card)."""
    devs = local_devices(n_devices, device)
    n_devices = len(devs)
    if data is None:
        data = n_devices // seg
    assert data * seg == n_devices, (data, seg, n_devices)
    places = [MeshDevice(i, d) for i, d in enumerate(devs)]
    arr = np.empty(n_devices, dtype=object)
    arr[:] = places
    return Mesh(arr.reshape(data, seg), AXES)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A placement of a batch over a mesh: the mesh axes that split its
    leading dimensions, in order (("data",) is P("data"), ("data",
    "seg") is P("data", "seg"), () is P(): every place holds all of it)."""

    mesh: Mesh
    spec: Tuple[str, ...]


def frame_sharding(mesh: Mesh) -> Sharding:
    """Batch-of-frames arrays: leading axis over 'data'."""
    return Sharding(mesh, ("data",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
