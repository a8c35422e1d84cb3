"""Training step: loss, gradient accumulation, global-norm clipping and
the optimizer, on one device.

Port of the JAX package's ``runtime/train_loop.py`` without its mesh
(``state_specs``, ``jit_train_step``, the sharding constraints): the
step here is eager PyTorch, and autograd takes the place of
``jax.value_and_grad``.

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

The step makes no host sync of its own: the loss, the norm and the
learning rate stay 0-dim tensors on the device.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.model import (LM, params_from_numpy, params_to_numpy,
                                      ref_leaves)
from repro_torch.optim import get_optimizer
from repro_torch.optim.adamw import f32_scalar
from repro_torch.optim.schedule import warmup_cosine


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy (+ z-loss) in float32 over the labels
    that are ≥ 0. ``logits`` may have more positions than ``labels``
    (a vlm's patches come first): the last ``S`` are scored."""
    logits = logits.to(torch.float32)
    S = labels.shape[1]
    logits = logits[:, -S:]
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    # gather raises on a negative index (a device-side assert on the
    # card), where the reference's take_along_axis wraps: clamp, then mask
    ll = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    nll = lse - ll
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    if z_loss:
        loss = loss + z_loss * ((lse * mask) ** 2).sum() / denom
    return loss


def make_train_state(model: LM, train_cfg: TrainConfig) -> Dict[str, Any]:
    """``{"params": model, "opt": the optimizer's initial state, "step":
    0}``; the model's weights are its own (drawn when it was built)."""
    opt = get_optimizer(train_cfg)
    return {"params": model, "opt": opt.init(ref_leaves(model)),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def train_state_tree(state) -> Dict[str, Any]:
    """The state in the reference's tree: params as ``params_to_numpy``
    gives them (float32 numpy arrays), the optimizer's state and the
    step as tensors."""
    return {"params": params_to_numpy(state["params"]), "opt": state["opt"],
            "step": state["step"]}


def load_train_state(state, tree) -> Dict[str, Any]:
    """``state`` with the weights, optimizer state and step of ``tree``
    (the reference's tree, e.g. restored from a checkpoint): the weights
    are copied into the model, the rest moved to its device at the
    current state's dtypes."""
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
    global batch; with ``train_cfg.microbatches > 1`` they are split.
    ``metrics`` is ``{"loss", "grad_norm", "lr"}``, 0-dim float32
    tensors. The state's parameters and optimizer state are updated in
    place (as the reference's jit donates them). ``grads`` holds the
    float32 accumulators, one a leaf of ``leaves`` at its shape: after a
    step, its clipped gradients."""

    def __init__(self, model: LM, train_cfg: TrainConfig):
        self.model = model
        self.cfg = train_cfg
        self.opt = get_optimizer(train_cfg)
        self.lr_fn = warmup_cosine(train_cfg.learning_rate,
                                   train_cfg.warmup_steps,
                                   train_cfg.total_steps)
        self.leaves = ref_leaves(model)
        self.params = [p for leaf in self.leaves for p in leaf.params]
        self.grads: List[torch.Tensor] = []
        self._slots: List[torch.Tensor] = []

    def loss(self, batch) -> torch.Tensor:
        logits = self.model.train_logits(batch)
        return cross_entropy_loss(logits, batch["labels"], self.cfg.z_loss)

    def _accumulators(self) -> List[torch.Tensor]:
        if not self.grads:
            self.grads = [torch.empty(leaf.shape, dtype=torch.float32,
                                      device=self.model.device)
                          for leaf in self.leaves]
            self._slots = [s for leaf, g in zip(self.leaves, self.grads)
                           for s in leaf.slices(g)]
        return self.grads

    def grads_of(self, batch):
        """(mean loss over the microbatches, the float32 accumulators
        holding the mean gradient of each leaf)."""
        M = self.cfg.microbatches
        grads = self._accumulators()
        total = None
        for i, mb in enumerate(_split(batch, M) if M > 1 else [batch]):
            loss = self.loss(mb)
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
        if M > 1:
            with torch.no_grad():
                m = f32_scalar(M, total)
                for g in grads:
                    g.div_(m)
            total = total / m
        return total, grads

    def __call__(self, state, batch):
        loss, grads = self.grads_of(batch)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                   for g in grads))
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


def make_train_step(model: LM, train_cfg: TrainConfig) -> TrainStep:
    """Returns ``train_step(state, batch) -> (state, metrics)``."""
    return TrainStep(model, train_cfg)
