"""Mesh context: which mesh the model's layers run on, and the
collectives a sharded layer calls.

Port of the JAX package's ``runtime/mesh_ctx.py``. The step factories
(``train_loop``, ``serve_loop``) enter ``with mesh_context(mesh,
profile)`` around the model call. There the reference's
``constrain(x, *symbols)`` pins an activation's sharding for GSPMD. In
eager PyTorch a tensor on a rank *is* its local shard, so ``constrain``
moves no data and returns ``x``; its call sites stay where the
reference's are, and ``constrain_spec`` is the resolution it stands
for: "batch" → the combined FSDP/data axes, "tensor" → the model axis,
None → replicated, and a dim whose size does not divide its axes → None
(the contract of ``runtime.sharding``).

What GSPMD derives from the layouts, a sharded layer does by hand,
reading its parameters' ``shard`` (``ParamShard``, set by
``runtime.shard.shard_model``):

  * ``weight(p, dtype)`` — a parameter whose d_model dim is sharded
    over the FSDP axes is cast to ``dtype`` and all-gathered over them
    just before use (freed after); the gradient returns by the
    conjugate reduction (a SUM over those axes, in float32, one
    all-reduce a rank's slice) into this rank's slice. A recompute
    under remat gathers again;
  * ``enter_tensor(x, ax)`` / ``row_parallel(x, p, ax)`` — Megatron's
    pair around a column- then row-parallel product: identity forward
    and an all-reduce of the gradient over the model axis; the
    row-parallel product taken at float32 on each rank, all-reduced and
    rounded once to ``x``'s dtype (as one device's product, which
    accumulates in float32, rounds once), identity backward.
    ``reduce_tensor(y, ax)`` is the bare all-reduce;
  * ``gather_tensor(x, dim, ax)`` — a width the model axis shards that
    the next layer needs whole (vlm's patch projection): all-gather
    forward, this rank's slice of the gradient backward. That is right
    where every rank computes the same from the whole tensor;
    ``gather_partial`` is the gather for a whole tensor that each rank
    then uses only in part (the mLSTM's up projection, of which a rank
    keeps its channels): its backward sums the ranks' gradients over
    ``ax`` before it takes this rank's slice. ``share(x, dim, ax)`` is
    the same reading of a tensor every rank holds whole (Mamba2's z,
    xBC and dt, each read in the share its own layer's cut gives);
  * ``reduce_shared(y, ax)`` — a sum every rank needs whole and reaches
    the loss through on its own slice (a norm's sum of squares over a
    width the model axis cuts, ``models.common.RMSNorm``): all-reduce
    forward and backward.

A step whose batch the batch axes do not divide, or whose caches the
rules cut on their sequence, says so in a ``SeqCut`` (``seq_context``;
``current_cut``): each field names the axes that cut one sequence, and
the layers read it. ``seq_offset`` is a cut sequence's first global
position on this rank, and ``softmax_combine`` the attention over keys
cut on their sequence (flash-decode: the row maxima and the sums of
exponentials all-reduced, the partial outputs summed in float32).

``traffic`` counts the bytes these move (``gathered``: all-gathers,
``reduced``: all-reduces; ``cache_gathered``: the part of ``gathered``
that MLA's latent caches, cut over the model axis, gather at each decode
step), read from ``launch.mesh.collectives``, where every collective
here counts itself once, tagged ``"layer"`` (``"cache"`` for the caches'
gathers).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MeshAxes
from repro_torch.runtime.sharding import mesh_axes, mesh_shape

_STATE = threading.local()
#: what a layout this slice does not run names when it raises
NOT_YET = "ROADMAP Queue 1, item 10d"


def current_mesh():
    return getattr(_STATE, "mesh", None)


@dataclasses.dataclass(frozen=True)
class SeqCut:
    """Where a step's rows and sequences lie on the mesh (None: whole on
    every rank of the axes). The step sets the batch's part
    (``runtime.shard.seq_cut``), the model the rest (``models.model``):

      * ``rows``: the batch axes, when they cut the batch's rows (the
        global token order is rank-major);
      * ``tokens``, ``patches``, ``frames``: the batch axes, when they
        cut that batch leaf's sequence (a batch they do not divide: its
        sequence is cut, context parallelism); ``seq``: when they cut
        the sequence of the activations a layer is given;
      * ``kv`` / ``kv_dh``: the axes that cut a GQA cache's S (the batch
        axes at a batch they do not divide, or the model axis where it
        does not divide the KV heads: flash-decode) and its Dh (the
        model axis, where neither can take S); ``latent``: MLA's
        ``ckv`` / ``k_rope`` S; ``memory``: the encoder memory's S."""
    rows: Optional[MeshAxes] = None
    tokens: Optional[MeshAxes] = None
    patches: Optional[MeshAxes] = None
    frames: Optional[MeshAxes] = None
    seq: Optional[MeshAxes] = None
    kv: Optional[MeshAxes] = None
    kv_dh: Optional[MeshAxes] = None
    latent: Optional[MeshAxes] = None
    memory: Optional[MeshAxes] = None


#: the cut off a mesh: everything whole
WHOLE = SeqCut()


def current_cut() -> Optional[SeqCut]:
    """The running step's ``SeqCut``; None outside a step on a mesh."""
    return getattr(_STATE, "cut", None)


@contextlib.contextmanager
def seq_context(cut: Optional[SeqCut]):
    prev = current_cut()
    _STATE.cut = cut
    try:
        yield
    finally:
        _STATE.cut = prev


def seq_offset(ax: Optional[MeshAxes], n: int) -> int:
    """The first global position of this rank's ``n`` positions of a
    sequence cut over ``ax`` (0 when whole)."""
    return 0 if ax is None else ax.index * n


def current_profile() -> str:
    return getattr(_STATE, "profile", "2d")


@contextlib.contextmanager
def mesh_context(mesh, profile: str = "2d", cut: Optional[SeqCut] = None):
    prev, prev_p = current_mesh(), current_profile()
    _STATE.mesh, _STATE.profile = mesh, profile
    try:
        with seq_context(cut):
            yield
    finally:
        _STATE.mesh, _STATE.profile = prev, prev_p


def constrain_spec(shape, *symbols, mesh=None, profile: Optional[str] = None
                   ) -> Tuple:
    """The dim-spec ``constrain(x, *symbols)`` pins an ``x`` of global
    ``shape`` to on ``mesh`` (the active one by default)."""
    mesh = current_mesh() if mesh is None else mesh
    fsdp, tensor = mesh_axes(mesh, current_profile() if profile is None
                             else profile)
    sizes = mesh_shape(mesh)
    spec = []
    for dim, sym in enumerate(symbols):
        if sym == "batch" and fsdp:
            size = math.prod(sizes[a] for a in fsdp)
            spec.append((fsdp if len(fsdp) > 1 else fsdp[0])
                        if shape[dim] % size == 0 and shape[dim] > 1
                        else None)
        elif sym == "tensor" and tensor:
            spec.append(tensor if shape[dim] % sizes[tensor] == 0
                        else None)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x, *symbols):
    """The reference's sharding constraint. A tensor on a rank is its
    local shard already: returns ``x``."""
    return x


# ---------------------------------------------------------------------------
# what a sharded layer reads, and the collectives it calls
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamShard:
    """How a parameter is cut, in the port's layout: its dim-spec, the
    dim sharded over the FSDP axes and the dim sharded over the model
    axis (None where the rules replicate), with those axes' groups."""
    spec: Tuple
    fsdp_dim: Optional[int]
    fsdp: Optional[MeshAxes]
    tensor_dim: Optional[int]
    tensor: Optional[MeshAxes]


#: the tags of the sharded layers' collectives in ``launch.mesh.
#: collectives``
_SOURCES = ("layer", "cache")


class Traffic:
    """Bytes moved by the sharded layers' collectives, read from
    ``launch.mesh.collectives`` (``collectives.reset()`` clears them):
    ``gathered`` the bytes each all-gather brought from the other ranks,
    ``reduced`` the bytes of each all-reduce's result, and
    ``cache_gathered`` the caches' part of ``gathered``."""

    @property
    def gathered(self) -> int:
        return mesh_lib.collectives.received_bytes("all-gather", _SOURCES)

    @property
    def reduced(self) -> int:
        return mesh_lib.collectives.result_bytes("all-reduce", _SOURCES)

    @property
    def cache_gathered(self) -> int:
        return mesh_lib.collectives.received_bytes("all-gather", ("cache",))


traffic = Traffic()


def axes_of(mesh, axes) -> MeshAxes:
    """The ``MeshAxes`` of a spec entry (one axis name or a tuple), in
    the mesh's axis order (data-major, as ``_mesh_slice`` cuts)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    order = tuple(mesh.mesh_dim_names)
    return mesh_lib.mesh_axes(mesh, tuple(a for a in order if a in names))


def shard_of(p) -> Optional[ParamShard]:
    return getattr(p, "shard", None)


def tensor_axes(p) -> Optional[MeshAxes]:
    """The model axis ``p`` is split over, or None (whole on each rank)."""
    s = shard_of(p)
    return None if s is None else s.tensor


def all_gather(x: torch.Tensor, dim: int, ax: MeshAxes,
               source: str = "layer") -> torch.Tensor:
    return mesh_lib.all_gather(x, dim, ax, source)


def all_reduce(x: torch.Tensor, ax: MeshAxes, op=None) -> torch.Tensor:
    return mesh_lib.all_reduce(x, dist.ReduceOp.SUM if op is None else op,
                               ax, "layer")


def own_slice(x: torch.Tensor, dim: int, ax: MeshAxes) -> torch.Tensor:
    """This rank's piece of ``x`` cut into ``ax.size`` along ``dim``."""
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * n, n)


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, dtype, dim, ax):
        ctx.dim, ctx.ax, ctx.pdtype = dim, ax, p.dtype
        return all_gather(p.to(dtype), dim, ax)

    @staticmethod
    def backward(ctx, g):
        # a reduce-scatter as one all-reduce a rank's slice, each in a
        # float32 copy of that slice alone: a full-width expert leaf's
        # gradient is 2.5 GB at float32, and gloo stages a collective in
        # pinned host memory
        ax, dim = ctx.ax, ctx.dim
        n = g.shape[dim] // ax.size
        mine = None
        for j in range(ax.size):
            part = g.narrow(dim, j * n, n).to(
                torch.float32, memory_format=torch.contiguous_format,
                copy=True)
            dist.all_reduce(part, group=ax.group)
            mesh_lib.collectives.note(
                "all-reduce", part.numel() * part.element_size(), ax.size,
                "layer")
            if j == ax.index:
                mine = part
        return mine.to(ctx.pdtype), None, None, None


class _EnterTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.ax), None


class _ReduceTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, ax):
        return _reduce(y, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, source):
        ctx.dim, ctx.ax = dim, ax
        return all_gather(x, dim, ax, source)

    @staticmethod
    def backward(ctx, g):
        return own_slice(g, ctx.dim, ctx.ax), None, None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return own_slice(_reduce(g.contiguous(), ctx.ax), ctx.dim,
                         ctx.ax), None, None


class _ReduceShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, ax):
        ctx.ax = ax
        return _reduce(y, ax)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous(), ctx.ax), None


class _RowParallel(torch.autograd.Function):
    """``x @ w`` at float32 (the products of 16-bit inputs are exact in
    float32, their sums accumulate in float32, as inside a 16-bit GEMM);
    the backward at ``x``'s dtype, as one device's product's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.dtype == torch.float32 or not x.is_cuda:
            return x.float() @ w.float()
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.view(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.t()
        gw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return gx, gw


def _reduce(y: torch.Tensor, ax: MeshAxes) -> torch.Tensor:
    """SUM over ``ax``, in float32 for a 16-bit ``y``. A 16-bit ``y`` is
    a sum of partials each rounded already (the input gradient of a
    column-parallel product, in ``enter_tensor``'s backward), so it is
    rounded twice where one device rounds once; ``row_parallel`` takes
    its partials at float32 and rounds once."""
    if y.dtype in (torch.bfloat16, torch.float16):
        return all_reduce(y.to(torch.float32), ax).to(y.dtype)
    return all_reduce(y, ax)


def weight(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p`` at ``dtype``, whole along its FSDP dim (all-gathered when a
    mesh shards it over more than one rank; the model axis's cut
    stays)."""
    s = shard_of(p)
    if s is None or s.fsdp is None or s.fsdp.size == 1:
        return p.to(dtype)
    return _GatherWeight.apply(p, dtype, s.fsdp_dim, s.fsdp)


def enter_tensor(x: torch.Tensor, ax: Optional[MeshAxes]) -> torch.Tensor:
    return x if ax is None else _EnterTensor.apply(x, ax)


def reduce_tensor(y: torch.Tensor, ax: Optional[MeshAxes]) -> torch.Tensor:
    return y if ax is None else _ReduceTensor.apply(y, ax)


def row_parallel(x: torch.Tensor, p: torch.Tensor,
                 ax: Optional[MeshAxes], out_dims: int = 1) -> torch.Tensor:
    """``x @ p`` at ``x``'s dtype, ``p`` row-parallel over the model axis
    ``ax`` (None: whole): each rank's partial product at float32, the
    SUM over ``ax`` rounded once to ``x``'s dtype. A ``p`` of more than
    two dims has its leading dims merged into the rows and its last
    ``out_dims`` into the columns (MLA's ``wo``, (H, v, d), at 1; the
    mLSTM's ``wqkv``, (d_in, 3, H, Dh), at 3)."""
    w = weight(p, x.dtype).flatten(0, -1 - out_dims).flatten(1)
    if ax is None:
        return x @ w
    return reduce_tensor(_RowParallel.apply(x, w), ax).to(x.dtype)


def gather_tensor(x: torch.Tensor, dim: int, ax: Optional[MeshAxes],
                  source: str = "layer") -> torch.Tensor:
    return x if ax is None else _GatherTensor.apply(x, dim % x.dim(), ax,
                                                    source)


def gather_partial(x: torch.Tensor, dim: int,
                   ax: Optional[MeshAxes]) -> torch.Tensor:
    return x if ax is None else _GatherPartial.apply(x, dim % x.dim(), ax)


def reduce_shared(y: torch.Tensor, ax: Optional[MeshAxes]) -> torch.Tensor:
    return y if ax is None else _ReduceShared.apply(y, ax)


def own(x: torch.Tensor, dim: int, ax: Optional[MeshAxes]) -> torch.Tensor:
    """``own_slice``, or ``x`` when ``ax`` is None."""
    return x if ax is None else own_slice(x, dim, ax)


def share(x: torch.Tensor, dim: int, ax: Optional[MeshAxes]) -> torch.Tensor:
    """This rank's slice over ``ax`` of an ``x`` that every rank holds
    whole, for a layer that reads only that slice: its gradient, this
    rank's slice of it, is summed over ``ax`` (``enter_tensor``, then
    ``own_slice``); ``x`` when ``ax`` is None."""
    return x if ax is None else own_slice(enter_tensor(x, ax), dim, ax)


def softmax_combine(logits: torch.Tensor, v: torch.Tensor,
                    ax: Optional[MeshAxes], dtype: torch.dtype
                    ) -> torch.Tensor:
    """``softmax(logits) @ v`` at ``dtype``: ``logits`` (..., q, k)
    float32 and masked, ``v`` (..., k, d). The probabilities are cast to
    ``dtype`` before the product, as the reference casts them. With
    ``ax`` the keys are cut over it (this rank's slice of them in both):
    the row maxima all-reduced (MAX), the float32 sums of exp(l − m)
    all-reduced (SUM), each rank's product with its V at float32 summed
    over ``ax`` and rounded once; each probability is the one device's
    up to the order of one sum."""
    if ax is None:
        return torch.softmax(logits, dim=-1).to(dtype) @ v.to(dtype)
    m = all_reduce(logits.amax(-1, keepdim=True), ax, dist.ReduceOp.MAX)
    e = torch.exp(logits - m)
    s = all_reduce(e.sum(-1, keepdim=True), ax)
    probs = (e / s).to(dtype)
    return all_reduce(probs.float() @ v.to(dtype).float(), ax).to(dtype)


def gather_cache(x: torch.Tensor, dim: int,
                 ax: Optional[MeshAxes]) -> torch.Tensor:
    """A cache buffer cut over the model axis ``ax`` along ``dim``, whole
    (``gather_tensor``; a cache is read under inference mode, so no
    gradient); its bytes also count in ``traffic.cache_gathered``."""
    return gather_tensor(x, dim, ax, "cache")
