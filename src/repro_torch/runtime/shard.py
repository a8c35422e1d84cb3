"""A model and its training state laid out on a mesh, one rank's slice
each.

What the reference gets from ``jax.jit``'s in/out shardings: here each
rank of a ``DeviceMesh`` (``launch/mesh.py``) holds only its slice of
every parameter, optimizer-state leaf and gradient accumulator, cut by
``runtime.sharding``'s rules, and the layers gather and reduce what
they need (``runtime.mesh_ctx``).

  * ``shard_model(model, mesh, profile)`` cuts a built model in place.
    The rules resolve on the reference's leaf shapes (``RefLeaf``,
    stacks included); the port stores some of them flattened (``wq``
    as (d, H·Dh) for the reference's (d, H, Dh)), so each resolved spec
    is mapped onto the port's layout dim by dim, and a merged dim may be
    cut only on its leading part (H of H·Dh; the rules never shard Dh,
    and this checks it).
  * The sharded compute covers every family: ``dense``, ``vlm``, ``moe``
    (the routed experts on the model axis, MLA's heads on it and its
    latent cache cut on R, each where the axis divides it), ``ssm``
    (xLSTM), ``hybrid`` (Zamba2's Mamba2 blocks, each projection on its
    own cut and the state on its heads or N, and the shared attention)
    and ``encdec``/``audio`` (the recurrent blocks' layouts in
    ``models.ssm``), with KV heads that the model axis does not divide
    (``models.attention.GQA``) and batches that the batch axes do not
    divide (their sequence cut, or whole on every rank: ``seq_cut``).
    An mLSTM or sLSTM block cut unlike itself raises
    ``NotImplementedError`` (ROADMAP Queue 1, 10d; no config reaches
    one), never runs replicated.
  * ``shard_batch``, ``slice_state`` and ``gather_state`` carry inputs
    and state between the global (reference) tree and a rank's slices
    (``abstract_state`` gives the global shapes the specs resolve on);
    a ``LocalBatch`` carries its global specs to the steps;
    ``load_train_state`` takes the slices, from ``slice_state`` or from
    ``CheckpointManager.restore(shardings=placements(state_specs(...)))``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import ssm
from repro_torch.models.attention import MLA
from repro_torch.models.model import (LM, RefLeaf, build_model, nest,
                                      ref_leaves)
from repro_torch.optim import get_optimizer
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.mesh_ctx import (NOT_YET, ParamShard, SeqCut,
                                          all_gather, axes_of)

#: families whose layers run sharded
SHARDED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec",
                    "audio")


def _cut(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec`` (``_mesh_slice``'s cut:
    each sharded dim in as many pieces as its axes hold ranks)."""
    for dim, axes in enumerate(spec):
        if axes is not None:
            ax = axes_of(mesh, axes)
            n = t.shape[dim] // ax.size
            t = t.narrow(dim, ax.index * n, n)
    return t


def _port_spec(ref_shape: Tuple[int, ...], port_shape: Tuple[int, ...],
               spec: Tuple, name: str) -> Tuple:
    """A per-layer dim-spec of the reference's shape, mapped onto the
    port's shape of the same parameter, whose dims merge runs of the
    reference's (``wq``: (d, H, Dh) → (d, H·Dh)). The cut of a merged dim
    is the cut of its leading reference dim only when the others are
    whole: raises otherwise."""
    out, r = [], 0
    for size in port_shape:
        group, prod = [], 1
        while r < len(ref_shape) and (prod < size or not group):
            group.append(r)
            prod *= ref_shape[r]
            r += 1
        if prod != size:
            raise ValueError(f"{name}: the port's shape {port_shape} does "
                             f"not merge the reference's {ref_shape}")
        if any(spec[g] is not None for g in group[1:]):
            raise RuntimeError(f"{name}: spec {spec} cuts a trailing dim "
                               f"of a merged dim of {port_shape}")
        out.append(spec[group[0]])
    if r != len(ref_shape):
        raise ValueError(f"{name}: {port_shape} against {ref_shape}")
    return tuple(out)


class Layout:
    """What ``shard_model`` attaches to a model as ``model.layout``: the
    mesh, the profile, this rank's slice of each reference leaf (a
    ``RefLeaf`` with its spec), and the batch (FSDP/data) and model
    axes."""

    def __init__(self, mesh, profile: str, leaves: List[RefLeaf]):
        self.mesh, self.profile, self.leaves = mesh, profile, leaves
        fsdp, tensor = shd.mesh_axes(mesh, profile)
        self.dp = axes_of(mesh, fsdp) if fsdp else None
        self.tp = axes_of(mesh, tensor) if tensor else None
        self.dp_names = fsdp

    def local_values(self, values: Dict) -> Dict:
        """``{path: array}`` with each whole array cut to this rank's
        slice (a slice already is kept)."""
        out = {}
        for leaf in self.leaves:
            v = values.get(leaf.path)
            if v is not None and tuple(np.shape(v)) == leaf.global_shape \
                    and leaf.global_shape != leaf.shape:
                v = _cut(torch.from_numpy(np.asarray(v)), leaf.spec,
                         self.mesh).numpy()
            out[leaf.path] = v
        for path, v in values.items():
            out.setdefault(path, v)
        return out


def _owners(model: nn.Module) -> Dict[int, Tuple[nn.Module, str]]:
    return {id(p): (m, name) for m in model.modules()
            for name, p in m._parameters.items() if p is not None}


def _cuts(module: nn.Module, *names: str) -> set:
    """Whether each named parameter of ``module`` is cut over the model
    axis."""
    return {getattr(module, n).shard.tensor is not None for n in names}


def _check_consistent(model: LM) -> None:
    """Raise for a layout this slice does not run: an mLSTM or sLSTM
    block whose projections the rules cut unlike each other on the model
    axis (walking every recurrent module). No published config, nor a
    tiny one with its heads changed on a model axis of up to 8, has
    one: the mLSTM's d_in, 2·d_in and heads and the sLSTM's heads and d
    are cut together there."""
    name = model.cfg.name
    for m in model.modules():
        if isinstance(m, (ssm.MLSTM, ssm.SLSTM)):
            names = {ssm.MLSTM: ("up_proj", "conv_w", "conv_b", "wqkv",
                                 "wif", "down_proj"),
                     ssm.SLSTM: ("w_in", "r")}[type(m)]
            if len(_cuts(m, *names)) > 1:
                raise NotImplementedError(
                    f"{name}: {type(m).__name__}'s {', '.join(names)} cut "
                    f"unlike each other on this mesh ({NOT_YET})")
            if isinstance(m, ssm.SLSTM) and _cuts(m, "w_in") == {True} \
                    and _cuts(m, "out_proj") != {True}:
                raise NotImplementedError(
                    f"{name}: sLSTM heads cut, its out_proj whole "
                    f"({NOT_YET})")


def shard_model(model: LM, mesh, profile: str = "2d") -> LM:
    """Cut ``model`` (built whole, on this rank's device or ``meta``) to
    this rank's slice of every parameter, in place, by the rules of
    ``runtime.sharding`` on ``mesh`` (a ``DeviceMesh``). Returns it with
    ``model.layout``."""
    if model.cfg.family not in SHARDED_FAMILIES:
        raise NotImplementedError(
            f"{model.cfg.name}: the {model.cfg.family} family on a mesh "
            f"({NOT_YET}; sharded: {', '.join(SHARDED_FAMILIES)})")
    if getattr(model, "layout", None) is not None:
        raise ValueError("the model is laid out on a mesh already")
    owners = _owners(model)
    fsdp, tensor = shd.mesh_axes(mesh, profile)
    dp_entry = shd.batch_entry(fsdp)
    leaves = []
    with torch.no_grad():
        for leaf in ref_leaves(model):
            spec = shd.spec_for_param(leaf.path, leaf.shape, mesh, profile)
            spec = spec or (None,) * len(leaf.shape)
            if any(e is not None for e in spec[:leaf.lead]):
                raise RuntimeError(f"{'/'.join(leaf.path)}: {spec} cuts a "
                                   f"stack axis")
            per = spec[leaf.lead:]
            ref_shape = leaf.shape[leaf.lead:]
            new = []
            for p in leaf.params:
                module, name = owners[id(p)]
                pspec = _port_spec(ref_shape, tuple(p.shape), per,
                                   "/".join(leaf.path))
                local = _cut(p.detach(), pspec, mesh)
                q = nn.Parameter(local.clone(),
                                 requires_grad=p.requires_grad)
                fsdp_dim = next((d for d, e in enumerate(pspec)
                                 if e is not None and e == dp_entry), None)
                tensor_dim = next((d for d, e in enumerate(pspec)
                                   if tensor is not None and e == tensor),
                                  None)
                q.shard = ParamShard(
                    spec=pspec, fsdp_dim=fsdp_dim,
                    fsdp=None if fsdp_dim is None else axes_of(mesh, fsdp),
                    tensor_dim=tensor_dim,
                    tensor=None if tensor_dim is None
                    else axes_of(mesh, tensor))
                setattr(module, name, q)
                new.append(q)
            leaves.append(leaf._replace(
                params=new, shape=shd.local_shape(leaf.shape, spec, mesh),
                global_shape=leaf.shape, spec=spec, mesh=mesh))
    model.layout = Layout(mesh, profile, leaves)
    # the blocks whose caches the rules cut apart from their parameters
    # (MLA's latent rank, Mamba2's state on its heads or N) read the
    # model axis
    for m in model.modules():
        if isinstance(m, (MLA, ssm.Mamba2)):
            m.model_axis = model.layout.tp
    _check_consistent(model)
    return model


def check_layout(model: LM, mesh, profile: str) -> None:
    """Raise ``ValueError`` unless ``model`` is laid out on ``mesh`` with
    ``profile`` (``mesh`` None: unless it is on no mesh)."""
    layout = getattr(model, "layout", None)
    if mesh is None:
        if layout is not None:
            raise ValueError("the model is laid out on a mesh: pass it")
    elif layout is None or layout.mesh is not mesh or \
            layout.profile != profile:
        raise ValueError("a step on a mesh takes a model laid out on it "
                         "(runtime.shard.shard_model(model, mesh, "
                         "profile))")


def resident_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (a model's parameters, a state,
    a list of accumulators)."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(resident_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(resident_bytes(v) for v in tree)
    return 0


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

class LocalBatch(dict):
    """This rank's slice of a global batch (``shard_batch``), with the
    global batch's dim-specs (``specs``), which tell a step whether the
    batch axes cut its rows, its sequence or nothing of it."""

    def __init__(self, leaves, specs):
        super().__init__(leaves)
        self.specs = specs


def check_batch_specs(specs: Dict[str, Tuple], mesh,
                      profile: str = "2d") -> None:
    """Raise ``ValueError`` unless each batch leaf's spec is one that
    ``infer_batch_specs`` gives: its batch axis (axis 1 of
    ``positions3``) over the batch axes, its sequence (dim 1) over them,
    or nothing, with the rows cut in every leaf or in none."""
    fsdp, _ = shd.mesh_axes(mesh, profile)
    dp = shd.batch_entry(fsdp)
    if shd.axes_size(shd.mesh_shape(mesh), fsdp) == 1:
        return
    rows = set()
    for k, spec in specs.items():
        axis = 1 if k == "positions3" else 0
        cut = [i for i, e in enumerate(spec) if e is not None]
        if cut and (cut not in ([axis], [1]) or spec[cut[0]] != dp):
            raise ValueError(f"batch leaf {k}: spec {spec}, not its batch "
                             f"axis or its sequence over {dp}")
        rows.add(cut == [axis])
    if len(rows) > 1:
        raise ValueError(f"batch specs {specs}: rows cut in some leaves "
                         f"only")


def shard_batch(batch: Dict[str, torch.Tensor], mesh,
                profile: str = "2d") -> LocalBatch:
    """This rank's slice of a global batch, as the reference's
    ``in_shardings`` of ``infer_batch_specs`` give it: its data rows, or
    at a batch that the batch axes do not divide, its part of each
    leaf's sequence (or the whole leaf, where they do not divide that
    either)."""
    specs = shd.infer_batch_specs(batch, mesh, profile)
    check_batch_specs(specs, mesh, profile)
    return LocalBatch({k: _cut(v, specs[k], mesh).contiguous()
                       for k, v in batch.items()}, specs)


def batch_specs_of(model: LM, batch, batch_specs=None) -> Dict[str, Tuple]:
    """The global dim-specs of a step's local ``batch``: ``batch_specs``
    if given, else a ``LocalBatch``'s, else those of a batch cut on its
    rows (the global batch has this rank's rows times the batch axes'
    ranks)."""
    if batch_specs is None:
        batch_specs = getattr(batch, "specs", None)
    if batch_specs is not None:
        return batch_specs
    layout = model.layout
    n = 1 if layout.dp is None else layout.dp.size
    glob = {k: torch.empty(tuple(v.shape[:axis]) + (v.shape[axis] * n,)
                           + tuple(v.shape[axis + 1:]), device="meta")
            for k, v in batch.items()
            for axis in [1 if k == "positions3" else 0]}
    return shd.infer_batch_specs(glob, layout.mesh, layout.profile)


def seq_cut(model: LM, batch, batch_specs=None) -> SeqCut:
    """The batch's part of a step's ``SeqCut`` on the model's mesh, from
    its global specs (``batch_specs_of``): the batch axes where they cut
    the rows, or else the sequence of the tokens (and labels), patches
    and frames."""
    layout = model.layout
    specs = batch_specs_of(model, batch, batch_specs)
    check_batch_specs(specs, layout.mesh, layout.profile)
    sizes = shd.mesh_shape(layout.mesh)

    def axes(name, dim):
        spec = specs.get(name, ())
        e = spec[dim] if len(spec) > dim else None
        return None if e is None or shd.axes_size(sizes, e) == 1 \
            else axes_of(layout.mesh, e)
    rows = axes("tokens", 0)
    if rows is not None:
        return SeqCut(rows=rows)
    tokens = axes("tokens", 1)
    return SeqCut(tokens=tokens, seq=tokens, patches=axes("patches", 1),
                  frames=axes("frames", 1))


def gather_batch(batch, specs, mesh) -> Dict[str, torch.Tensor]:
    """The global batch from every rank's ``batch`` under ``specs``."""
    sizes = shd.mesh_shape(mesh)
    out = {}
    for k, v in batch.items():
        for dim, axes in enumerate(specs[k]):
            if axes is not None and shd.axes_size(sizes, axes) > 1:
                v = all_gather(v.contiguous(), dim, axes_of(mesh, axes))
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# state: gathered to the reference's tree, and its specs
# ---------------------------------------------------------------------------

def gather(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole array of this rank's slice ``t`` under ``spec`` (a new
    tensor)."""
    if not shd.spec_axes(spec):
        return t.detach().clone()
    for dim, axes in enumerate(spec):
        if axes is not None:
            t = all_gather(t.contiguous(), dim, axes_of(mesh, axes))
    return t


def gather_params(model: LM) -> Dict:
    """The whole parameter pytree of a model on a mesh (every rank takes
    part; every rank gets it), as float32 numpy arrays in the
    reference's shapes."""
    layout = model.layout
    return nest((leaf.path, gather(leaf.value().detach().float(), leaf.spec,
                                   layout.mesh).cpu().numpy())
                for leaf in layout.leaves)


def _gather_tree(local, specs, mesh):
    if isinstance(local, dict):
        return {k: _gather_tree(local[k], specs[k], mesh) for k in local}
    return gather(local, specs, mesh)


def gather_state(state, abstract) -> Dict:
    """The whole training state of a model on a mesh in the reference's
    tree (``train_loop.train_state_tree``'s form): params as float32
    numpy arrays, the optimizer's state and the step as tensors.
    ``abstract`` is ``abstract_state`` of the model's config (the
    global shapes the specs resolve on). Every rank takes part."""
    layout = state["params"].layout
    specs = state_specs(abstract, layout.mesh, layout.profile)
    return {"params": gather_params(state["params"]),
            "opt": _gather_tree(state["opt"], specs["opt"], layout.mesh),
            "step": state["step"]}


def slice_state(tree, abstract, mesh, profile: str = "2d") -> Dict:
    """This rank's slices of a whole training state in the reference's
    tree (``train_loop.train_state_tree`` of a one-device state), cut by
    ``state_specs`` of ``abstract`` (``abstract_state``): what
    ``train_loop.load_train_state`` takes on a mesh."""
    specs = state_specs(abstract, mesh, profile)

    def cut(node, spec):
        if isinstance(node, dict):
            return {k: cut(node[k], spec[k]) for k in node}
        t = node if torch.is_tensor(node) else torch.from_numpy(
            np.asarray(node))
        return _cut(t, spec, mesh).contiguous()
    return {"params": cut(tree["params"], specs["params"]),
            "opt": cut(tree["opt"], specs["opt"]), "step": tree["step"]}


def abstract_state(cfg, train_cfg) -> Dict:
    """The training state's global tree on the ``meta`` device: params
    (the reference's shapes), the optimizer's initial state, the step."""
    leaves = ref_leaves(build_model(cfg, device="meta",
                                    generator=torch.Generator()))
    return {"params": nest((l.path, torch.empty(l.shape, device="meta"))
                           for l in leaves),
            "opt": get_optimizer(train_cfg).init(leaves),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def state_specs(state, mesh, profile: str = "2d") -> Dict:
    """Dim-specs of a training state in the reference's tree (the
    reference's ``train_loop.state_specs``): params and the optimizer's
    tree by ``infer_param_specs`` (moments inherit their parameter's
    rule), the step replicated. ``state`` holds the global shapes:
    ``train_loop.train_state_tree`` of a one-device state, or
    ``abstract_state`` (``meta`` tensors)."""
    return {"params": shd.infer_param_specs(state["params"], mesh, profile),
            "opt": shd.infer_param_specs(state["opt"], mesh, profile),
            "step": ()}

