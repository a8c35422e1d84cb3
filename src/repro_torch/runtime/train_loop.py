"""Training step: loss, gradient accumulation, global-norm clipping and
the optimizer, on one device or on a mesh.

Port of the JAX package's ``runtime/train_loop.py``: the step is eager
PyTorch, and autograd takes the place of ``jax.value_and_grad``. Nothing
is compiled: ``jit_train_step`` checks the layouts the reference's jit
would be given and returns the step.

  * the loss is the reference's causal-LM cross-entropy with z-loss;
  * microbatches: the batch is split along its batch axis (axis 1 of
    ``positions3``), each microbatch's gradients are taken with
    ``torch.autograd.grad`` and added into float32 accumulators (one a
    leaf of the reference's parameter pytree, at its shape), then
    divided by the count. ``.grad`` never accumulates, so a bfloat16
    parameter's microbatches are summed in float32, as the reference's
    scan sums them;
  * the global norm is a float32 sum of per-leaf sums of squares, the
    gradients are scaled by ``min(1, clip / max(norm, 1e-9))``, and the
    optimizer updates the parameters in place (``optim/``);
  * the state is ``{"params": the model, "opt": the optimizer's state in
    the reference's tree, "step": int32}``. ``train_state_tree`` and
    ``load_train_state`` carry it in the reference's tree and shapes
    (params as ``params_to_numpy`` gives them), which is what a
    checkpoint holds, so each package resumes from the other's.

On a mesh (a model cut by ``runtime.shard.shard_model``; the batch this
rank's rows, ``shard.shard_batch``) every rank holds only its slice of
the parameters, the optimizer state and the accumulators, and the step
does what GSPMD derives for the reference:

  * the loss is ``Σ nll·mask / Σ mask`` over the *global* batch: the
    mask sum is all-reduced over the batch axes (the z-loss shares the
    denominator), and each rank backpropagates its rows' share, so the
    data-axis gradient reduction is a SUM; with vocab-parallel logits
    the log-sum-exp is a MAX all-reduce, then a SUM of the
    exponentials, and the target logit comes from its owning shard;
  * a batch that the batch axes do not divide has its sequence cut
    over them (``runtime.shard.seq_cut``; the layers gather K/V and the
    recurrent blocks' inputs over the cut, and their backward sums and
    slices), or else is whole on every rank, whose share of the loss is
    then 1/ranks of it (the label count all-reduced counts it on every
    rank);
  * microbatch i is this rank's slice of the global rows [i·B/M,
    (i+1)·B/M), as the reference splits the global batch, then shards
    each piece by its own specs (its rows where they divide over the
    batch axes, else its sequence; the batch is all-gathered over the
    batch axes first);
  * the FSDP weights' gradients arrive reduced into this rank's slice
    (``runtime.mesh_ctx``); the leaves the batch axes do not cut are
    all-reduced over them once a step;
  * the norm's per-leaf sums of squares are all-reduced over the axes
    that cut that leaf only (a leaf whole on an axis counts once), and
    Adafactor's means over a cut dim are all-reduced (``RefLeaf.mean``);
    AdamW is elementwise.

The step makes no host sync of its own: the loss, the norm and the
learning rate stay 0-dim tensors on the device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import TrainConfig
from repro_torch.models.model import (LM, params_from_numpy, params_to_numpy,
                                      ref_leaves)
from repro_torch.optim import get_optimizer
from repro_torch.optim.adamw import f32_scalar
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime import shard as shard_lib
from repro_torch.runtime import sharding as shd
from repro_torch.launch.mesh import MeshAxes
from repro_torch.runtime.mesh_ctx import (all_reduce, axes_of, mesh_context,
                                          reduce_tensor)
from repro_torch.runtime.shard import state_specs


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 1e-4, mesh=None, profile: str = "2d",
                       vocab: Optional[MeshAxes] = None) -> torch.Tensor:
    """Mean token cross-entropy (+ z-loss) in float32 over the labels
    that are ≥ 0. ``logits`` may have more positions than ``labels``
    (a vlm's patches come first): the last ``S`` are scored.

    On ``mesh`` (a ``DeviceMesh``), ``logits`` and ``labels`` are this
    rank's rows, and its logits are the cut of the vocabulary over
    ``vocab``, the model axis that cuts it (``LM.vocab_axes()``; None:
    whole); the denominator counts the global batch's labels, and the
    value returned is this rank's share of the global loss (its sum over
    the batch axes is the loss)."""
    logits = logits.to(torch.float32)
    S = labels.shape[1]
    logits = logits[:, -S:]
    labels = labels.long()
    mask = (labels >= 0).to(torch.float32)
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        # gather raises on a negative index (a device-side assert on the
        # card), where the reference's take_along_axis wraps: clamp, then
        # mask
        ll = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        fsdp, _ = shd.mesh_axes(mesh, profile)
        dp = axes_of(mesh, fsdp) if fsdp else None
        lse, ll = _vocab_parallel(logits, labels, vocab)
        count = mask.sum()
        if dp is not None:
            count = all_reduce(count, dp)
        denom = torch.clamp(count, min=1.0)
    nll = lse - ll
    loss = (nll * mask).sum() / denom
    if z_loss:
        loss = loss + z_loss * ((lse * mask) ** 2).sum() / denom
    return loss


def _vocab_parallel(logits, labels, tp):
    """(log-sum-exp, target logit) of logits whose columns the model
    axis ``tp`` cuts (whole when None): the max all-reduced (MAX, no
    gradient), the exponentials' sum and the target logit, held by one
    rank, summed (forward all-reduce, identity backward)."""
    if tp is None:
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0])
    V = logits.shape[-1]
    m = all_reduce(logits.detach().amax(dim=-1), tp, dist.ReduceOp.MAX)
    se = reduce_tensor(torch.exp(logits - m[..., None]).sum(dim=-1), tp)
    lse = torch.log(se) + m
    idx = labels - tp.index * V
    inside = (idx >= 0) & (idx < V)
    ll = logits.gather(-1, idx.clamp(0, V - 1)[..., None])[..., 0]
    ll = reduce_tensor(torch.where(inside, ll, torch.zeros_like(ll)), tp)
    return lse, ll


def make_train_state(model: LM, train_cfg: TrainConfig) -> Dict[str, Any]:
    """``{"params": model, "opt": the optimizer's initial state, "step":
    0}``; the model's weights are its own (drawn when it was built). On
    a mesh the state is this rank's slice."""
    opt = get_optimizer(train_cfg)
    return {"params": model, "opt": opt.init(ref_leaves(model)),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def train_state_tree(state) -> Dict[str, Any]:
    """The state in the reference's tree: params as ``params_to_numpy``
    gives them (float32 numpy arrays), the optimizer's state and the
    step as tensors (on a mesh this rank's slices;
    ``runtime.shard.gather_state`` gives them whole)."""
    return {"params": params_to_numpy(state["params"]), "opt": state["opt"],
            "step": state["step"]}


def load_train_state(state, tree) -> Dict[str, Any]:
    """``state`` with the weights, optimizer state and step of ``tree``
    (the reference's tree, e.g. restored from a checkpoint): the weights
    are copied into the model, the rest moved to its device at the
    current state's dtypes. On a mesh ``tree`` holds this rank's slices
    (``CheckpointManager.restore(shardings=placements(state_specs(...)))``
    cuts them), or whole params."""
    model = state["params"]
    params_from_numpy(model, tree["params"])

    def like(cur, new):
        if isinstance(cur, dict):
            return {k: like(cur[k], new[k]) for k in cur}
        return torch.as_tensor(np.asarray(new) if not torch.is_tensor(new)
                               else new).to(device=cur.device,
                                            dtype=cur.dtype)
    return {"params": model, "opt": like(state["opt"], tree["opt"]),
            "step": like(state["step"], tree["step"])}


def _split(batch: Dict[str, torch.Tensor], M: int) -> List[Dict]:
    """The batch as M microbatches along the batch axis (axis 1 of
    ``positions3``, which is (3, B, S))."""
    out = []
    for i in range(M):
        mb = {}
        for k, v in batch.items():
            axis = 1 if k == "positions3" else 0
            n = v.shape[axis] // M
            mb[k] = v.narrow(axis, i * n, n)
        out.append(mb)
    return out


class TrainStep:
    """``train_step(state, batch) -> (state, metrics)`` for ``model``.

    ``batch`` holds tensors on the model's device with leading dim the
    global batch (on a mesh, this rank's rows of it); with
    ``train_cfg.microbatches > 1`` they are split. ``metrics`` is
    ``{"loss", "grad_norm", "lr"}``, 0-dim float32 tensors, the global
    batch's on every rank. The state's parameters and optimizer state
    are updated in place (as the reference's jit donates them).
    ``grads`` holds the float32 accumulators, one a leaf of ``leaves``
    at its shape (on a mesh, its slice's): after a step, its clipped
    gradients."""

    def __init__(self, model: LM, train_cfg: TrainConfig, mesh=None,
                 profile: str = "2d", batch_specs=None):
        shard_lib.check_layout(model, mesh, profile)
        self.model = model
        self.cfg = train_cfg
        self.mesh, self.profile = mesh, profile
        self.batch_specs = batch_specs
        self.layout = getattr(model, "layout", None)
        self.opt = get_optimizer(train_cfg)
        self.lr_fn = warmup_cosine(train_cfg.learning_rate,
                                   train_cfg.warmup_steps,
                                   train_cfg.total_steps)
        self.leaves = ref_leaves(model)
        self.params = [p for leaf in self.leaves for p in leaf.params]
        self.grads: List[torch.Tensor] = []
        self._slots: List[torch.Tensor] = []

    def loss(self, batch, cut=None) -> torch.Tensor:
        """The loss of ``batch`` (on a mesh, this rank's share of it, the
        batch laid out as ``cut`` says: ``runtime.shard.seq_cut``)."""
        with mesh_context(self.mesh, self.profile, cut):
            logits = self.model.train_logits(batch)
            labels = self.model.aligned_labels(batch)
        return cross_entropy_loss(logits, labels, self.cfg.z_loss,
                                  self.mesh, self.profile,
                                  self.model.vocab_axes())

    def _accumulators(self) -> List[torch.Tensor]:
        if not self.grads:
            self.grads = [torch.empty(leaf.shape, dtype=torch.float32,
                                      device=self.model.device)
                          for leaf in self.leaves]
            self._slots = [s for leaf, g in zip(self.leaves, self.grads)
                           for s in leaf.slices(g)]
        return self.grads

    def _microbatches(self, batch) -> List[Tuple[Dict, Any]]:
        """(microbatch, its ``SeqCut`` on the mesh) pairs."""
        M = self.cfg.microbatches
        if self.mesh is None:
            return [(mb, None) for mb in (_split(batch, M) if M > 1
                                          else [batch])]
        if M == 1:
            return [(batch, shard_lib.seq_cut(self.model, batch,
                                              self.batch_specs))]
        specs = shard_lib.batch_specs_of(self.model, batch, self.batch_specs)
        full = shard_lib.gather_batch(batch, specs, self.mesh)
        return [(mb, shard_lib.seq_cut(self.model, mb)) for mb in (
            shard_lib.shard_batch(part, self.mesh, self.profile)
            for part in _split(full, M))]

    def grads_of(self, batch):
        """(mean loss over the microbatches, the float32 accumulators
        holding the mean gradient of each leaf). On a mesh the loss is
        this rank's share until ``__call__`` sums it."""
        M = self.cfg.microbatches
        grads = self._accumulators()
        total = None
        for i, (mb, cut) in enumerate(self._microbatches(batch)):
            loss = self.loss(mb, cut)
            gs = torch.autograd.grad(loss, self.params, allow_unused=True)
            with torch.no_grad():
                for slot, g in zip(self._slots, gs):
                    if g is None:              # a parameter the batch
                        if i == 0:             # does not reach
                            slot.zero_()
                    elif i == 0:
                        slot.copy_(g)
                    else:             # upcast inside the add: no
                        slot.add_(g)  # float32 copy of a bfloat16 grad
            del gs
            total = loss.detach() if total is None else total + loss.detach()
        if self.mesh is not None:
            constrain_like_params(grads, self.leaves)
            self._reduce_replicated(grads)
        if M > 1:
            with torch.no_grad():
                m = f32_scalar(M, total)
                for g in grads:
                    g.div_(m)
            total = total / m
        return total, grads

    def _reduce_replicated(self, grads) -> None:
        """SUM over the batch axes of the leaves they do not cut (the
        others arrived reduced through the FSDP gathers' backward), in
        one all-reduce."""
        dp = self.layout.dp
        if dp is None or dp.size == 1:
            return
        names = set(self.layout.dp_names)
        idle = [g for g, leaf in zip(grads, self.leaves)
                if not names & set(shd.spec_axes(leaf.spec))]
        if not idle:
            return
        with torch.no_grad():
            flat = all_reduce(torch.cat([g.reshape(-1) for g in idle]), dp)
            for g, part in zip(idle, flat.split([g.numel() for g in idle])):
                g.copy_(part.view(g.shape))

    def _global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of per-leaf sums of squares; on a mesh each
        leaf's is all-reduced over the axes that cut it only (one
        all-reduce per set of axes)."""
        sq = [torch.sum(torch.square(g)) for g in grads]
        if self.mesh is not None:
            groups: Dict[frozenset, List[int]] = {}
            for i, leaf in enumerate(self.leaves):
                groups.setdefault(frozenset(shd.spec_axes(leaf.spec)),
                                  []).append(i)
            for axes, idx in groups.items():
                if axes:
                    red = all_reduce(torch.stack([sq[i] for i in idx]),
                                     axes_of(self.mesh, axes))
                    for j, i in enumerate(idx):
                        sq[i] = red[j]
        return torch.sqrt(sum(sq))

    def __call__(self, state, batch):
        loss, grads = self.grads_of(batch)
        with torch.no_grad():
            if self.mesh is not None and self.layout.dp is not None:
                loss = all_reduce(loss, self.layout.dp)
            gnorm = self._global_norm(grads)
            clip = f32_scalar(self.cfg.grad_clip, gnorm)
            scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            for g in grads:
                g.mul_(scale)
            lr = self.lr_fn(state["step"])
            opt = self.opt.update(grads, state["opt"], self.leaves, lr)
        new_state = {"params": state["params"], "opt": opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}


def constrain_like_params(grads: List[torch.Tensor], leaves) -> List:
    """The reference pins the gradient accumulators to the parameters'
    sharding (replicated, the f32 accumulator of a 480B model is ~1.9 TB
    per device). Here an accumulator is born at its leaf's slice:
    raises if one is not."""
    for g, leaf in zip(grads, leaves):
        if tuple(g.shape) != tuple(leaf.shape):
            raise RuntimeError(f"{'/'.join(leaf.path)}: accumulator "
                               f"{tuple(g.shape)}, slice {leaf.shape}")
    return grads


def make_train_step(model: LM, train_cfg: TrainConfig, mesh=None,
                    profile: str = "2d", batch_specs=None) -> TrainStep:
    """Returns ``train_step(state, batch) -> (state, metrics)``; on
    ``mesh``, for a model laid out on it, the batch this rank's slice of
    the global one, whose dim-specs are ``batch_specs``, a
    ``LocalBatch``'s own, or else those of a batch cut on its rows."""
    return TrainStep(model, train_cfg, mesh, profile, batch_specs)


def jit_train_step(model: LM, train_cfg: TrainConfig, mesh, state,
                   batch_specs, profile: str = "2d") -> TrainStep:
    """The reference's jit with explicit shardings, eager: checks that
    ``state`` (this rank's) is laid out by ``state_specs`` and that
    ``batch_specs`` are the rules' (``check_batch_specs``), then returns
    the step on batches of those specs. Nothing is compiled."""
    shard_lib.check_batch_specs(batch_specs, mesh, profile)
    step = make_train_step(model, train_cfg, mesh, profile, batch_specs)
    abstract = shard_lib.abstract_state(model.cfg, train_cfg)
    specs = state_specs(abstract, mesh, profile)

    def check(local, glob, spec, path):
        if isinstance(local, dict):
            for k in local:
                check(local[k], glob[k], spec[k], path + (k,))
            return
        want = shd.local_shape(tuple(glob.shape), spec, mesh)
        if tuple(local.shape) != want:
            raise ValueError(f"opt/{'/'.join(path)}: {tuple(local.shape)}, "
                             f"its slice is {want}")
    check(state["opt"], abstract["opt"], specs["opt"], ())
    return step
