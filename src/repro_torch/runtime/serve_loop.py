"""Serving step factories: prefill, and a decode step with the greedy
token on the device.

Port of the JAX package's ``runtime/serve_loop.py`` on one device. The
model holds its weights, so a step takes the batch (and the caches and
the absolute position ``index``, a Python int) and no parameters. The
caches are written in place, as the reference's donated buffers are.
The mesh argument and ``jit_decode_step`` (sharded caches) wait for the
port of ``runtime/sharding.py``.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import LM


def make_prefill_step(model: LM, max_len: int):
    @torch.inference_mode()
    def prefill_step(batch):
        return model.prefill(batch, max_len=max_len)
    return prefill_step


def make_decode_step(model: LM):
    @torch.inference_mode()
    def decode_step(batch, caches, index: int):
        logits, caches = model.decode(batch, caches, index)
        # greedy token for the serving loop (sampling lives client-side);
        # argmax takes the first maximum, as jnp.argmax does
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, logits, caches
    return decode_step
