"""Host meshes over ``torch.distributed``, and the collectives the
distributed matcher runs on them.

Port of the JAX package's ``launch/mesh.py`` (``make_host_mesh``). A
JAX mesh names devices of one process; here every rank of a process
group is one shard, and the mesh is a ``DeviceMesh`` with the
reference's axis names ``("data", "model")`` over the initialised
default group, ranks laid out data-major (rank = d·model + m).

The backend is chosen by the caller, never switched behind its back:

  * ``"nccl"`` — each rank drives its own card (``torchrun
    --nproc-per-node=N``, ``cuda:<local rank>``);
  * ``"gloo"`` — CPU tensors (the tests), or several ranks sharing one
    card: gloo runs every collective the matcher needs on CUDA tensors
    (``all_reduce`` MAX and SUM, ``all_gather``, bool
    included; checked on the H100 with torch 2.11), staging them through
    the host itself.

``mesh_axes`` resolves a subset of the axis names to the process group
that spans those axes (``axis_names=("data",)`` on a (4, 2) mesh: the 4
ranks that share this rank's model coordinate), as ``P(axis_names)``
shards over them and replicates over the rest. The collectives below
count themselves in ``collectives`` (one a call, as the kernels count
their launches).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import subprocess
import tempfile
import time
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels._build import LaunchCounter

AXES = ("data", "model")

#: Collective calls made through this module (all_reduce, all_gather,
#: barrier), one each.
collectives = LaunchCounter("collectives")


def backend_string(backend: str, device="cuda") -> str:
    """The ``init_process_group`` backend of ``backend`` ("nccl" or
    "gloo") for tensors on ``device``: gloo on CUDA tensors is
    ``"cuda:gloo,cpu:gloo"``, so that the group never picks NCCL for
    them."""
    dev = torch.device(device).type
    if backend == "nccl":
        if dev != "cuda":
            raise ValueError("nccl takes CUDA tensors only")
        return "nccl"
    if backend == "gloo":
        return "cuda:gloo,cpu:gloo" if dev == "cuda" else "gloo"
    raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")


def init_group(backend: str, *, init_method: str, rank: int,
               world_size: int, device="cuda",
               timeout_s: float = 120.0) -> None:
    """Initialise the default process group for ``make_host_mesh``.
    ``init_method`` is a rendezvous URL (``file://<path>`` for ranks on
    one host, ``tcp://host:port``); a collective that waits longer than
    ``timeout_s`` raises instead of hanging."""
    dist.init_process_group(backend_string(backend, device),
                            init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _group_backend(device_type: str) -> str:
    """The default group's backend for tensors of ``device_type``."""
    name = str(dist.get_backend())
    if ":" not in name:
        return name
    return dict(part.split(":") for part in name.split(",")).get(
        device_type, "")


def make_host_mesh(data: int = 1, model: int = 1, *, backend: str,
                   device="cuda") -> DeviceMesh:
    """A (data, model) ``DeviceMesh`` with the axis names ``("data",
    "model")`` over the initialised default group, whose world size must
    be data·model. Raises unless the group runs ``backend`` for
    ``device``'s tensors."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (init_group)")
    dev = torch.device(device).type
    got = _group_backend(dev)
    if got != backend:
        raise RuntimeError(f"the process group runs {got!r} for {dev} "
                           f"tensors, not {backend!r}")
    if data * model != dist.get_world_size():
        raise ValueError(f"mesh ({data}, {model}) on a world of "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev, (data, model), mesh_dim_names=AXES)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """The shards of a mesh along some of its axes, as one rank sees
    them: the process group spanning those axes, this rank's shard index
    (data-major over the axes, as ``P(axis_names)`` orders shards) and
    the number of shards."""
    group: object
    index: int
    size: int


def mesh_axes(mesh: DeviceMesh, axis_names: Sequence[str]) -> MeshAxes:
    """``MeshAxes`` of ``axis_names``, one axis or all of the mesh's
    axes in the mesh's order."""
    names = tuple(axis_names)
    dims = tuple(mesh.mesh_dim_names)
    if len(names) == 1 and names[0] in dims:
        return MeshAxes(mesh.get_group(names[0]),
                        mesh.get_local_rank(names[0]),
                        mesh.size(dims.index(names[0])))
    if names != dims:
        raise ValueError(f"axis_names {names}: one of {dims}, or all of "
                         f"them in that order")
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError("a mesh over all of its axes must span the "
                         "default group in rank order")
    return MeshAxes(dist.group.WORLD, dist.get_rank(), len(ranks))


def mesh_writer(mesh: DeviceMesh) -> bool:
    """True on the one rank that writes for the mesh (its first)."""
    return dist.get_rank() == int(mesh.mesh.flatten()[0])


def all_reduce(x: torch.Tensor, op, ax: MeshAxes) -> torch.Tensor:
    """``x`` reduced over ``ax``'s shards with ``op``
    (``dist.ReduceOp.MAX`` / ``SUM``), into a new tensor; bool travels
    as uint8."""
    y = (x.to(torch.uint8) if x.dtype == torch.bool else x).clone(
        memory_format=torch.contiguous_format)   # NCCL takes dense rows
    dist.all_reduce(y, op=op, group=ax.group)
    collectives.add()
    return y.bool() if x.dtype == torch.bool else y


def all_gather(x: torch.Tensor, dim: int, ax: MeshAxes) -> torch.Tensor:
    """Every shard's ``x`` concatenated along ``dim`` in shard order;
    bool travels as uint8."""
    y = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(ax.size)]
    dist.all_gather(parts, y, group=ax.group)
    collectives.add()
    out = torch.cat(parts, dim)
    return out.bool() if x.dtype == torch.bool else out


def barrier() -> None:
    """Wait for every rank of the default group."""
    dist.barrier()
    collectives.add()


class RankFailed(RuntimeError):
    """A rank of ``run_ranks`` exited non-zero: the first one seen to,
    with its exit code and the tail of its stderr."""

    def __init__(self, rank: int, returncode: int, stderr: str):
        super().__init__(f"rank {rank} exited {returncode}: "
                         f"{stderr[-3000:]}")
        self.rank, self.returncode, self.stderr = rank, returncode, stderr


def run_ranks(commands: Sequence[Sequence[str]], *, timeout_s: float,
              env=None, cwd=None) -> List[Tuple[int, str, str]]:
    """Run one command per rank at once on this host and wait for all of
    them. Returns ``(returncode, stdout, stderr)`` per rank, every code
    0. Every rank is polled on each pass: once one exits non-zero, the
    others are killed (they would wait in a collective until the group's
    timeout) and ``RankFailed`` names that rank; when they do not all
    end within ``timeout_s``, every rank is killed and ``TimeoutError``
    raised. Output goes through files, so a rank that writes much never
    blocks on a full pipe."""
    with contextlib.ExitStack() as stack:
        files = [(stack.enter_context(tempfile.TemporaryFile("w+")),
                  stack.enter_context(tempfile.TemporaryFile("w+")))
                 for _ in commands]
        procs = [subprocess.Popen(list(c), env=env, cwd=cwd, stdout=fo,
                                  stderr=fe, text=True)
                 for c, (fo, fe) in zip(commands, files)]
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while True:
                states = [p.poll() for p in procs]
                failed = next((r for r, s in enumerate(states) if s), None)
                if failed is not None or None not in states:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{len(procs)} ranks did not end "
                                       f"within {timeout_s} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out = []
        for p, (fo, fe) in zip(procs, files):
            fo.seek(0)
            fe.seek(0)
            out.append((p.returncode, fo.read(), fe.read()))
        if failed is not None:
            rc, _, err = out[failed]
            raise RankFailed(failed, rc, err)
        return out
