"""Host meshes over ``torch.distributed``, and the collectives the
distributed matcher runs on them.

Port of the JAX package's ``launch/mesh.py`` (``make_host_mesh``,
``make_production_mesh``). A JAX mesh names devices of one process;
here every rank of a process group is one shard, and the mesh is a
``DeviceMesh`` with the reference's axis names over the initialised
default group, ranks laid out in the axes' order: ``("data", "model")``
(rank = d·model + m), or on the multi-pod production mesh ``("pod",
"data", "model")``, pod-major.

``fake_group(world_size)`` initialises a default group of the fake
backend (``torch.testing._internal.distributed.fake_pg``) in which this
one process is rank 0 of ``world_size``: collectives return at once and
leave every tensor as it is (a gathered slot holds this rank's own
input, as if every rank were this one), on ``meta`` tensors too. The
dry run (``launch/dryrun.py``) lays the production meshes out on it.

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
ranks that share this rank's model coordinate; ``("pod", "data")`` on
the multi-pod mesh: the 32 ranks of the FSDP group, pod-major), as
``P(axis_names)`` shards over them and replicates over the rest. The
collectives below, and those of ``runtime.mesh_ctx``, count themselves
in ``collectives``, the one tally of them: how many calls there were of
each ``Collective`` (its kind, the bytes of its result on this rank, its
group's size and the caller's tag), from which the call count, the
sharded layers' bytes (``mesh_ctx.traffic``) and the dry run's ring wire
bytes are all read.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import itertools
import math
import subprocess
import tempfile
import time
import weakref
from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model")
#: the multi-pod production mesh's axes
POD_AXES = ("pod", "data", "model")

@dataclasses.dataclass(frozen=True)
class Collective:
    """One kind of collective call: its kind (``"all-reduce"``,
    ``"all-gather"``, ``"barrier"``), the bytes of its result on this
    rank (an all-gather's the gathered tensor's), the number of ranks in
    its group, and the caller's tag (``"mesh"`` here; ``"layer"`` and
    ``"cache"`` from ``runtime.mesh_ctx``)."""
    kind: str
    nbytes: int
    group_size: int
    source: str = "mesh"


class Collectives:
    """The tally of collective calls: ``calls`` counts each distinct
    ``Collective``, so it stays as small as the set of shapes a program
    moves, however long it runs."""

    def __init__(self):
        self.calls: collections.Counter = collections.Counter()

    def reset(self) -> None:
        self.calls.clear()

    def note(self, kind: str, nbytes: int, group_size: int,
             source: str = "mesh") -> None:
        self.calls[Collective(kind, int(nbytes), int(group_size),
                              source)] += 1

    @property
    def count(self) -> int:
        """Calls of every kind."""
        return sum(self.calls.values())

    def result_bytes(self, kind: str, sources: Iterable[str]) -> int:
        """Result bytes of the ``kind`` calls tagged with ``sources``."""
        sources = set(sources)
        return sum(c.nbytes * n for c, n in self.calls.items()
                   if c.kind == kind and c.source in sources)

    def received_bytes(self, kind: str, sources: Iterable[str]) -> int:
        """The part of ``result_bytes`` that came from the other ranks:
        (g − 1)/g of each result."""
        sources = set(sources)
        return sum(c.nbytes // c.group_size * (c.group_size - 1) * n
                   for c, n in self.calls.items()
                   if c.kind == kind and c.source in sources)


#: every collective call made through this module and ``mesh_ctx``
collectives = Collectives()


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


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """The reference's production mesh over the initialised default
    group: (16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``; the group's world size must
    be 256 or 512 (``fake_group`` plays one rank of it)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = POD_AXES if multi_pod else AXES
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialised "
                           "process group (init_group, fake_group)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} on a world of "
                         f"{dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A default group of the fake backend in which this process is
    ``rank`` of ``world_size``, destroyed when the block ends. Its
    collectives move nothing: every gathered slot holds this rank's
    input, a reduction leaves its input as it is."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """The shards of a mesh along some of its axes, as one rank sees
    them: the process group spanning those axes, this rank's shard index
    (data-major over the axes, as ``P(axis_names)`` orders shards) and
    the number of shards."""
    group: object
    index: int
    size: int


#: per live mesh (by identity: meshes of one layout compare equal), the
#: ``MeshAxes`` of its multi-axis groups (``_subgroups``)
_SUBGROUPS: Dict[int, Tuple[weakref.ref, Dict]] = {}


def _subgroups(mesh: DeviceMesh) -> Dict[Tuple[str, ...], MeshAxes]:
    """This rank's ``MeshAxes`` of every choice of two or more, but not
    all, of the mesh's axes (in the mesh's order). ``dist.new_group``
    must be called by every rank of the default group, for every group,
    in one order: so all of them are made at once, in the order of the
    choices, the first time any is asked for, and every rank makes the
    same calls whichever it asks for first. A group's ranks are those
    that share this rank's other coordinates, in the axes' order
    (pod-major), which must be their rank order, as ``new_group`` numbers
    them."""
    dims = tuple(mesh.mesh_dim_names)
    grid, me = mesh.mesh, dist.get_rank()
    out = {}
    for k in range(2, len(dims)):
        for names in itertools.combinations(dims, k):
            keep = [dims.index(a) for a in names]
            rest = [i for i in range(len(dims)) if i not in keep]
            rows = grid.permute(*rest, *keep).reshape(
                -1, math.prod(grid.shape[i] for i in keep)).tolist()
            for row in rows:
                if row != sorted(row):
                    raise ValueError(f"the mesh's ranks do not ascend "
                                     f"along {names}")
                group = dist.new_group(ranks=row)
                if me in row:
                    out[names] = MeshAxes(group, row.index(me), len(row))
    return out


def mesh_axes(mesh: DeviceMesh, axis_names: Sequence[str]) -> MeshAxes:
    """``MeshAxes`` of ``axis_names``: one axis, all of the mesh's axes,
    or several of them, each in the mesh's order (``_subgroups``: every
    rank must ask for them alike)."""
    names = tuple(axis_names)
    dims = tuple(mesh.mesh_dim_names)
    if len(names) == 1 and names[0] in dims:
        return MeshAxes(mesh.get_group(names[0]),
                        mesh.get_local_rank(names[0]),
                        mesh.size(dims.index(names[0])))
    if names == dims:
        ranks = mesh.mesh.flatten().tolist()
        if ranks != list(range(dist.get_world_size())):
            raise ValueError("a mesh over all of its axes must span the "
                             "default group in rank order")
        return MeshAxes(dist.group.WORLD, dist.get_rank(), len(ranks))
    if names != tuple(d for d in dims if d in names):
        raise ValueError(f"axis_names {names}: axes of {dims}, in that "
                         f"order")
    key = id(mesh)
    held = _SUBGROUPS.get(key)
    if held is None or held[0]() is not mesh:
        held = _SUBGROUPS[key] = (
            weakref.ref(mesh, lambda _: _SUBGROUPS.pop(key, None)),
            _subgroups(mesh))
    return held[1][names]


def mesh_writer(mesh: DeviceMesh) -> bool:
    """True on the one rank that writes for the mesh (its first)."""
    return dist.get_rank() == int(mesh.mesh.flatten()[0])


def all_reduce(x: torch.Tensor, op, ax: MeshAxes,
               source: str = "mesh") -> torch.Tensor:
    """``x`` reduced over ``ax``'s shards with ``op``
    (``dist.ReduceOp.MAX`` / ``SUM``), into a new tensor; bool travels
    as uint8. Counted in ``collectives`` under ``source``."""
    y = (x.to(torch.uint8) if x.dtype == torch.bool else x).clone(
        memory_format=torch.contiguous_format)   # NCCL takes dense rows
    dist.all_reduce(y, op=op, group=ax.group)
    collectives.note("all-reduce", y.numel() * y.element_size(), ax.size,
                     source)
    return y.bool() if x.dtype == torch.bool else y


def all_gather(x: torch.Tensor, dim: int, ax: MeshAxes,
               source: str = "mesh") -> torch.Tensor:
    """Every shard's ``x`` concatenated along ``dim`` in shard order;
    bool travels as uint8. Counted in ``collectives`` under
    ``source``."""
    y = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(ax.size)]
    dist.all_gather(parts, y, group=ax.group)
    collectives.note("all-gather", y.numel() * y.element_size() * ax.size,
                     ax.size, source)
    out = torch.cat(parts, dim)
    return out.bool() if x.dtype == torch.bool else out


def barrier() -> None:
    """Wait for every rank of the default group."""
    dist.barrier()
    collectives.note("barrier", 0, dist.get_world_size())


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
