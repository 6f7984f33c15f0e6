"""Multi-process execution on torch.distributed (gpujpeg_tpu.parallel.dist).

The reference has no multi-device story (single-GPU select,
gpujpeg_common.c:220-288); the JAX package made its processes' devices
one global mesh.  The port keeps the process-local plumbing around such a
mesh, with torch.distributed and its Gloo backend in place of
jax.distributed:

  * initialize()            -- process-group bring-up (args or env)
  * make_global_mesh()      -- ('data', 'seg') mesh over ALL processes'
                               devices, 'seg' minor and inside a process:
                               a frame's stripes stay on one host, frames
                               spread over hosts
  * data_rows_of_process()  -- which mesh 'data' rows this process owns
  * local_frame_indices()   -- which global frames this process feeds
  * make_global_batch(), local_rows(), local_batch() -- this process's
                               share of a batch and of its outputs, as
                               {global frame index: array}
  * allgather_max()         -- elementwise max of a small vector over
                               the processes

Frame routing is fully local: every frame's ('data' row x all 'seg')
places belong to one process, so batch encode and decode move no pixel
or codestream byte between processes.  There is no global array in torch:
each process holds its own frames and outputs, keyed by their global
index.  Everything degrades to the single-process behaviour when no
process group is up, so the tests run unchanged in one process;
tests/test_torch_multihost.py also runs two real Gloo processes on CPU
meshes.
"""

from __future__ import annotations

import collections
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from .mesh import Mesh, MeshDevice, Sharding, local_devices

_INITIALIZED = False

#: one block of an output held by this process: index, a tuple of slices
#: of the global (frames, stripes, ...) array as a JAX shard's .index;
#: data, the block
Shard = collections.namedtuple("Shard", ["index", "data"])


def _group_up() -> bool:
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the torch.distributed process group, Gloo backend
    (idempotent).

    Explicit args win; otherwise GPUJPEG_TPU_COORDINATOR ("host:port" or
    "tcp://host:port") / GPUJPEG_TPU_NUM_PROCESSES /
    GPUJPEG_TPU_PROCESS_ID env vars.  A no-op when none of those are
    present (single-process run)."""
    global _INITIALIZED
    if _INITIALIZED or _group_up():
        _INITIALIZED = True
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("GPUJPEG_TPU_COORDINATOR")
    if num_processes is None and "GPUJPEG_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["GPUJPEG_TPU_NUM_PROCESSES"])
    if process_id is None and "GPUJPEG_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["GPUJPEG_TPU_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("initialize needs the coordinator address, the "
                         "process count and this process's id")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    torch.distributed.init_process_group(
        "gloo", init_method=coordinator_address, world_size=num_processes,
        rank=process_id)
    _INITIALIZED = True


def process_count() -> int:
    """The processes of the group (jax.process_count()); 1 without one."""
    return torch.distributed.get_world_size() if _group_up() else 1


def _rank() -> int:
    return torch.distributed.get_rank() if _group_up() else 0


def process_index() -> int:
    """This process's rank (jax.process_index()); 0 without a group."""
    return _rank()


def make_global_mesh(seg: int = 1, n_local: Optional[int] = None,
                     device=None) -> Mesh:
    """('data', 'seg') mesh over the GLOBAL device list: every process's
    local places (mesh.local_devices(n_local, device): the CUDA devices,
    or n_local places of `device`), process-major, each entry carrying
    its process_index.

    'seg' must divide the per-process place count so that every frame's
    segment shards stay inside one process (reshaping (data, seg) with
    seg minor puts each row's seg block inside one process)."""
    local = local_devices(n_local, device)
    if len(local) % seg:
        raise ValueError(
            f"seg={seg} must divide the per-process device count "
            f"{len(local)} so segment shards of a frame stay intra-host")
    counts = [len(local)]
    if process_count() > 1:
        counts = [None] * process_count()
        torch.distributed.all_gather_object(counts, len(local))
    me = _rank()
    places = []
    for p, n in enumerate(counts):
        if n % seg:
            raise ValueError(
                f"seg={seg} must divide process {p}'s device count {n} so "
                "segment shards of a frame stay intra-host")
        for i in range(n):
            # another process's place: its device's name, not usable here
            dev = local[i] if p == me else (
                torch.device(local[0].type, i) if local[0].type == "cuda"
                else local[0])
            places.append(MeshDevice(len(places), dev, p))
    arr = np.empty(len(places), dtype=object)
    arr[:] = places
    return Mesh(arr.reshape(len(places) // seg, seg))


def _default_proc_of(d) -> int:
    return d.process_index


def data_rows_of_process(mesh, process_index: Optional[int] = None,
                         proc_of: Optional[Callable] = None) -> List[int]:
    """Sorted 'data' coordinates whose device rows belong to this
    process.  proc_of is injectable so the routing math is unit-testable
    without real multi-process runs; a row split across processes (a
    layout make_global_mesh never produces) is an error."""
    if process_index is None:
        process_index = _rank()
    proc_of = proc_of or _default_proc_of
    devs = np.asarray(mesh.devices)
    rows = []
    for r in range(devs.shape[0]):
        procs = {proc_of(d) for d in devs[r].reshape(-1)}
        if len(procs) > 1:
            raise ValueError(
                f"mesh 'data' row {r} spans processes {sorted(procs)}; "
                "build the mesh with make_global_mesh so 'seg' stays "
                "intra-host")
        if procs == {process_index}:
            rows.append(r)
    return rows


def local_frame_indices(mesh, batch_size: int,
                        process_index: Optional[int] = None,
                        proc_of: Optional[Callable] = None) -> List[int]:
    """Global indices of the frames THIS process feeds for a batch of
    batch_size frames sharded P('data') over the mesh (contiguous
    per-row blocks of batch_size / data_extent frames)."""
    data = mesh.shape["data"]
    if batch_size % data:
        raise ValueError(f"batch_size {batch_size} not divisible by the "
                         f"mesh 'data' extent {data}")
    per = batch_size // data
    out: List[int] = []
    for r in data_rows_of_process(mesh, process_index, proc_of):
        out.extend(range(r * per, (r + 1) * per))
    return out


def make_global_batch(mesh, spec, local_frames, global_batch: int,
                      process_index: Optional[int] = None,
                      proc_of: Optional[Callable] = None) -> dict:
    """THIS process's share of a global batch of global_batch frames:
    {global frame index: frame}.  spec is the placement (a mesh.Sharding
    or its axes: ("data",) or ("data", "seg"), whose frames this process
    feeds in local_frame_indices order, or () for a replicated batch,
    every frame of which each process holds).  local_frames must hold
    exactly this process's frames."""
    axes = spec.spec if isinstance(spec, Sharding) else tuple(spec or ())
    frames = list(local_frames)
    if "data" not in axes:
        if len(frames) != global_batch:
            raise ValueError(f"a replicated batch of {global_batch} frames "
                             f"is held whole by every process, got "
                             f"{len(frames)}")
        return dict(enumerate(frames))
    idx = local_frame_indices(mesh, global_batch, process_index, proc_of)
    if len(frames) != len(idx):
        raise ValueError(f"this process feeds {len(idx)} frames of the "
                         f"batch of {global_batch}, got {len(frames)}")
    return dict(zip(idx, frames))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def local_rows(arr, mesh, batch_size: int) -> dict:
    """{global frame index: np.ndarray} for the frames whose blocks this
    process holds.  arr: this process's Shard blocks (index, data) of a
    (B, n_seg, ...) output split P('data', 'seg'); a frame's seg blocks
    are all in one process by mesh construction, so each frame
    reassembles locally, its blocks concatenated along axis 1."""
    parts: dict = {}
    for s in arr:
        idx = s.index
        b0 = idx[0].start or 0
        b1 = idx[0].stop if idx[0].stop is not None else batch_size
        g0 = (idx[1].start or 0) if len(idx) > 1 else 0
        parts.setdefault((b0, b1), {})[g0] = _host(s.data)
    out: dict = {}
    for (b0, b1), segs in parts.items():
        blocks = [segs[k] for k in sorted(segs)]
        whole = np.concatenate(blocks, axis=1) if len(blocks) > 1 \
            else blocks[0]
        for i, b in enumerate(range(b0, b1)):
            out[b] = whole[i]
    return out


def local_batch(arr, batch_size: int) -> dict:
    """{global frame index: np.ndarray} for this process's Shard blocks
    of a P('data')-split output with no 'seg' axis (e.g. decoded
    images)."""
    out: dict = {}
    for s in arr:
        b0 = s.index[0].start or 0
        d = _host(s.data)
        for i in range(d.shape[0]):
            out[b0 + i] = d[i]
    return out


def allgather_max(x) -> np.ndarray:
    """Elementwise max of a small per-process vector across processes
    (identity on one process): an all-gather over the group, then a
    max."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x))
    got = [torch.empty_like(t) for _ in range(process_count())]
    torch.distributed.all_gather(got, t)
    return np.max(np.stack([g.numpy() for g in got]), axis=0)
