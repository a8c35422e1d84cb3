"""Adafactor: factored second moments for ≥2-D leaves (O(n+m) state
instead of O(n·m)). The giant-arch optimizer (qwen1.5-110b, deepseek-v2,
arctic): optimizer memory shrinks from 2×params to ~per-row/col vectors.
No first moment (classic Adafactor-without-momentum).

Port of the JAX package's ``optim/adafactor.py`` over the reference's
leaves (``optim/adamw.py`` says why): a stacked ``(L, d)`` norm scale is
factored (``vr`` of (L,), ``vc`` of (d,), a mean over the layers), and
the RMS step clipping takes one RMS over the whole stacked leaf. The
state is ``{"f": {... {"vr", "vc"} | {"v"}}, "count"}`` in the
reference's tree and shapes, ``count`` int32.

Every mean is the whole leaf's, through ``RefLeaf.mean``: on a mesh a
leaf is this rank's slice and its state the slice of the reference's,
and the means over a dim the mesh cuts (``vr`` over the last, ``vc``
over the second-to-last, ``vr``'s mean, the RMS over the whole leaf)
are all-reduced.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.models.common import DTYPES
from repro_torch.models.model import RefLeaf
from repro_torch.optim.adamw import (Optimizer, at, f32_scalar, nest,
                                     write_back)


def adafactor(decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              state_dtype: str = "float32") -> Optimizer:
    sdt = DTYPES[state_dtype]

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(leaves: List[RefLeaf]):
        def one(leaf):
            kw = dict(dtype=sdt, device=leaf.params[0].device)
            s = leaf.shape
            if _factored(s):
                return {"vr": torch.zeros(s[:-1], **kw),
                        "vc": torch.zeros(s[:-2] + s[-1:], **kw)}
            return {"v": torch.zeros(s, **kw)}
        return {"f": nest((l.path, one(l)) for l in leaves),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].params[0].device)}

    @torch.no_grad()
    def update(grads: Sequence[torch.Tensor], state, leaves: List[RefLeaf],
               lr):
        count = state["count"] + 1
        beta = 1.0 - count.to(torch.float32) ** -decay
        eps32 = f32_scalar(eps, beta)
        new_f = []
        for g, leaf in zip(grads, leaves):
            g = g.to(torch.float32)
            st = at(state["f"], leaf.path)
            # the reference's expressions, in place where the rounding
            # is the same: at full width a leaf's float32 temporaries
            # (the embedding's are 5 GB each at qwen1.5-110b) bound the
            # step's peak memory
            g2 = (g * g).add_(eps)
            if _factored(leaf.shape):
                vr = beta * st["vr"].to(torch.float32) + \
                    (1 - beta) * leaf.mean(g2, -1)
                vc = beta * st["vc"].to(torch.float32) + \
                    (1 - beta) * leaf.mean(g2, -2)
                del g2
                step = (vr[..., None] * vc[..., None, :]).div_(
                    torch.maximum(leaf.mean(vr, -1, of=-2)[..., None, None],
                                  eps32)
                ).add_(eps)
                new_st = {"vr": vr.to(sdt), "vc": vc.to(sdt)}
            else:
                v = beta * st["v"].to(torch.float32) + (1 - beta) * g2
                del g2
                step = v + eps
                new_st = {"v": v.to(sdt)}
            step = step.rsqrt_().mul_(g)                 # g · rsqrt(· + eps)
            # relative step clipping (RMS-based), over the whole leaf
            rms = torch.sqrt(leaf.mean(step * step) + eps)
            step.div_(torch.clamp(rms / f32_scalar(clip_threshold, rms),
                                  min=1.0))
            p32 = leaf.value().to(torch.float32, copy=True)
            if weight_decay and len(leaf.shape) >= 2:
                step.add_(weight_decay * p32)
            write_back(leaf, p32.sub_(step.mul_(lr)))
            new_f.append((leaf.path, new_st))
            del g, step, p32
        return {"f": nest(new_f), "count": count}

    return Optimizer(init=init, update=update)
