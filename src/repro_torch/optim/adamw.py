"""AdamW over the reference's parameter leaves, with configurable moment
dtype.

Port of the JAX package's ``optim/adamw.py``. The optimizers of this
package see the leaves of the reference's parameter pytree
(``models.model.ref_leaves``), not ``model.parameters()``: a stack of
layers is one leaf with a leading layer axis there, and the rules that
turn on a leaf's rank follow the stacked shape (AdamW decays every leaf
of two or more dimensions, so a stacked ``(L, d)`` norm scale decays and
an unstacked ``(d,)`` one does not).

``Optimizer.init(leaves)`` returns the state in the reference's tree and
shapes (``{"m", "v", "count"}``, ``count`` int32); ``update(grads,
state, leaves, lr)`` takes one float32 gradient a leaf (at the leaf's
shape), writes the new parameters into the leaves' parameters in place
and returns the new state. Moments are upcast to float32 inside the
update and stored at ``state_dtype`` (``"bfloat16"`` rounds to nearest
even, as ``astype`` does); the new parameters are computed in float32
and cast to the parameter's dtype. One leaf at a time, so a leaf's
float32 temporaries are freed before the next's.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence

import torch

from repro_torch.models.common import DTYPES
from repro_torch.models.model import RefLeaf, nest


class Optimizer(NamedTuple):
    init: Callable        # (leaves) -> state
    update: Callable      # (grads, state, leaves, lr) -> state


def at(tree: Dict, path: Sequence[str]):
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def write_back(leaf: RefLeaf, new_p: torch.Tensor) -> None:
    """Cast ``new_p`` (float32, the leaf's shape) into its parameters."""
    for p, v in zip(leaf.params, leaf.slices(new_p)):
        p.copy_(v)


def f32_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          state_dtype: str = "float32") -> Optimizer:
    sdt = DTYPES[state_dtype]

    def init(leaves: List[RefLeaf]):
        def zeros():
            return nest((l.path, torch.zeros(l.shape, dtype=sdt,
                                             device=l.params[0].device))
                        for l in leaves)
        return {"m": zeros(), "v": zeros(),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].params[0].device)}

    @torch.no_grad()
    def update(grads: Sequence[torch.Tensor], state, leaves: List[RefLeaf],
               lr):
        count = state["count"] + 1
        cf = count.to(torch.float32)
        c1 = 1.0 - f32_scalar(b1, cf) ** cf
        c2 = 1.0 - f32_scalar(b2, cf) ** cf
        new_m, new_v = [], []
        for g, leaf in zip(grads, leaves):
            g = g.to(torch.float32)
            m, v = at(state["m"], leaf.path), at(state["v"], leaf.path)
            m32 = m.to(torch.float32) * b1 + (1 - b1) * g
            v32 = v.to(torch.float32) * b2 + (1 - b2) * g * g
            step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
            p32 = leaf.value().to(torch.float32)
            if weight_decay and len(leaf.shape) >= 2:   # no decay on
                step = step + weight_decay * p32        # norms / biases
            write_back(leaf, p32 - lr * step)
            new_m.append((leaf.path, m32.to(sdt)))
            new_v.append((leaf.path, v32.to(sdt)))
            del g, m32, v32, step, p32
        return {"m": nest(new_m), "v": nest(new_v), "count": count}

    return Optimizer(init=init, update=update)
