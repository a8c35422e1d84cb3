"""Model assembly: the decoder-only family behind the reference's API.

Port of the JAX package's ``models/model.py`` for the families ``dense``
(llama3, qwen1.5, qwen2.5) and ``vlm`` (qwen2-vl's text backbone with
stub patch embeddings and M-RoPE)::

    build_model(cfg, device=None, generator=None) -> DecoderOnly with
        .train_logits(batch)                  -> (B, S, V) logits
        .prefill(batch, max_len)              -> (logits, caches)
        .decode(batch, caches, index)         -> (logits, caches)
        .init_caches(batch_size, max_len)     -> caches
        .num_params()                         -> int

The blocks are ``nn.Module``s in an ``nn.ModuleList`` holding parameters
at ``param_dtype`` and casting them at use, as the reference does. Caches
keep the reference's layout, ``{"blocks": {"k", "v"}}`` of (L, B, max_len,
Hkv, Dh) in bfloat16 whatever the compute dtype, and are written in place
at ``index`` (a Python int, so a decode step needs no host sync).

``params_from_numpy`` and ``params_to_numpy`` carry the reference's
parameter pytree (numpy arrays, ``blocks`` stacked on a leading layer
axis, ``wq`` as (d, H, Dh), ``wo`` as (H, Dh, d)) into and out of the
port's modules.

The families ``moe`` (deepseek-v2, arctic), ``ssm`` (xlstm), ``hybrid``
(zamba2) and ``encdec``/``audio`` (seamless) are not ported yet:
``build_model`` raises for them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common
from repro_torch.models.common import dense_init, embed_init
from repro_torch.models.ffn import MLP

CACHE_DTYPE = torch.bfloat16
#: patch positions a ``vlm`` prompt starts with (the stub vision frontend)
VLM_PATCHES = 8


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return common.rmsnorm(self.scale, x, self.eps)


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(ln1 x), then x + mlp(ln2 x)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        dtype = common.dt(cfg.param_dtype)
        self.ln1 = RMSNorm(cfg.d_model, dtype, cfg.norm_eps, device)
        self.ln2 = RMSNorm(cfg.d_model, dtype, cfg.norm_eps, device)
        self.attn = attention.GQA(cfg, generator=generator, device=device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, dtype,
                       common.dt(cfg.compute_dtype), generator=generator,
                       device=device)

    def forward(self, x, positions, cache=None, cache_index: int = 0):
        a, cache = self.attn(self.ln1(x), positions, cache, cache_index)
        x = x + a
        return x + self.ffn(self.ln2(x)), cache


class DecoderOnly(nn.Module):
    """The ``dense`` and ``vlm`` decoder-only model."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        dtype = common.dt(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.embed = nn.Parameter(embed_init(cfg.vocab_size, cfg.d_model,
                                             dtype, **kw))
        self.final_ln = RMSNorm(cfg.d_model, dtype, cfg.norm_eps, device)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            dense_init((cfg.d_model, cfg.vocab_size), dtype, **kw))
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.patch_proj = nn.Parameter(dense_init(
            (cfg.d_model, cfg.d_model), dtype, **kw)) \
            if cfg.frontend == "vision" else None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- embedding and head ------------------------------------------------

    def _assemble_x(self, batch) -> torch.Tensor:
        cd = common.dt(self.cfg.compute_dtype)
        # gather, then cast: the values of the reference's cast-then-gather
        # without a copy of the whole table a step
        x = self.embed[batch["tokens"].long()].to(cd)
        if self.patch_proj is not None and "patches" in batch:
            pe = batch["patches"].to(cd) @ self.patch_proj.to(cd)
            x = torch.cat([pe, x], dim=1)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cd = common.dt(self.cfg.compute_dtype)
        x = self.final_ln(x)
        w = self.embed.t() if self.lm_head is None else self.lm_head
        return x.to(cd) @ w.to(cd)

    def _positions(self, batch, B: int, S: int, cache_index: int):
        if self.cfg.mrope:
            pos = batch.get("positions3")
            if pos is None:   # the reference's default: 0..S-1, no offset
                pos = common.positions_for(B, S, device=self.device)[None]
                pos = pos.expand(3, B, S)
            return pos
        return common.positions_for(B, S, cache_index, device=self.device)

    def _run(self, batch, caches, cache_index: int):
        x = self._assemble_x(batch)
        B, S = x.shape[:2]
        positions = self._positions(batch, B, S, cache_index)
        for l, block in enumerate(self.blocks):
            cache = None if caches is None else {
                k: c[l] for k, c in caches["blocks"].items()}
            x, _ = block(x, positions, cache, cache_index)
        return x

    # -- the reference's API -------------------------------------------------

    def train_logits(self, batch) -> torch.Tensor:
        """The forward alone over the whole sequence → (B, S, V)."""
        return self._head(self._run(batch, None, 0))

    def init_caches(self, batch_size: int, max_len: int):
        proto = attention.init_gqa_cache(self.cfg, batch_size, max_len,
                                         CACHE_DTYPE, device=self.device)
        L = self.cfg.num_layers
        return {"blocks": {k: torch.zeros((L,) + tuple(c.shape),
                                          dtype=c.dtype, device=c.device)
                           for k, c in proto.items()}}

    @torch.inference_mode()
    def prefill(self, batch, max_len: int):
        """Fill fresh caches of ``max_len`` with the prompt → (logits of
        the last position (B, 1, V), caches)."""
        caches = self.init_caches(batch["tokens"].shape[0], max_len)
        x = self._run(batch, caches, 0)
        return self._head(x[:, -1:]), caches

    @torch.inference_mode()
    def decode(self, batch, caches, index: int):
        """One step at absolute position ``index``: the caches are
        written in place → (logits (B, S, V), caches)."""
        x = self._run(batch, caches, int(index))
        return self._head(x), caches

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def resolve_device(device=None) -> torch.device:
    """``device``, the card if None; raises without a card unless the
    CPU is asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' (--device "
                           "cpu) to run on the CPU")
    return device


def build_model(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None) -> DecoderOnly:
    """The model of ``cfg`` on ``device`` (the card unless ``"cpu"``),
    its weights drawn from ``generator`` (one seeded with 0 on the device
    if None)."""
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"ROADMAP.md Queue 1 item 10 lists it")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return DecoderOnly(cfg, generator=generator, device=device)


# ---------------------------------------------------------------------------
# The reference's parameter pytree, as numpy arrays
# ---------------------------------------------------------------------------

def _block_layout(cfg: ModelConfig) -> Dict[str, Dict[str, tuple]]:
    """For each reference leaf of a block: (port attribute path, the
    reference's per-layer shape)."""
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.kv_heads
    Dh, f = cfg.resolved_head_dim, cfg.d_ff
    attn = {"wq": (d, H, Dh), "wk": (d, Hkv, Dh), "wv": (d, Hkv, Dh),
            "wo": (H, Dh, d)}
    if cfg.qkv_bias:
        attn.update(bq=(H, Dh), bk=(Hkv, Dh), bv=(Hkv, Dh))
    return {"ln1": {"scale": (d,)}, "ln2": {"scale": (d,)}, "attn": attn,
            "ffn": {"gate": (d, f), "up": (d, f), "down": (f, d)}}


def params_from_numpy(model: DecoderOnly, tree) -> DecoderOnly:
    """Copy the reference's parameter pytree (numpy arrays) into
    ``model``, in place, at each parameter's dtype and device."""
    cfg = model.cfg

    def put(param: torch.Tensor, value) -> None:
        value = np.asarray(value)
        if value.size != param.numel():
            raise ValueError(f"parameter of {tuple(param.shape)} given "
                             f"{value.shape}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.ascontiguousarray(
                value, dtype=np.float32)).reshape(param.shape))

    put(model.embed, tree["embed"])
    put(model.final_ln.scale, tree["final_ln"]["scale"])
    if model.lm_head is not None:
        put(model.lm_head, tree["lm_head"])
    if model.patch_proj is not None:
        put(model.patch_proj, tree["patch_proj"])
    for group, leaves in _block_layout(cfg).items():
        for leaf in leaves:
            stacked = np.asarray(tree["blocks"][group][leaf])
            if stacked.shape[0] != cfg.num_layers:
                raise ValueError(f"blocks/{group}/{leaf}: {stacked.shape[0]}"
                                 f" layers, the model has {cfg.num_layers}")
            for l, block in enumerate(model.blocks):
                sub = getattr(block, group)
                put(getattr(sub, "scale" if group.startswith("ln") else leaf),
                    stacked[l])
    return model


def params_to_numpy(model: DecoderOnly) -> dict:
    """The inverse of ``params_from_numpy``: the reference's pytree, as
    float32 numpy arrays in the reference's shapes."""
    cfg = model.cfg

    def get(param: torch.Tensor, shape=None) -> np.ndarray:
        a = param.detach().float().cpu().numpy()
        return a if shape is None else a.reshape(shape)

    tree = {"embed": get(model.embed),
            "final_ln": {"scale": get(model.final_ln.scale)}}
    if model.lm_head is not None:
        tree["lm_head"] = get(model.lm_head)
    if model.patch_proj is not None:
        tree["patch_proj"] = get(model.patch_proj)
    blocks: Dict[str, Dict[str, np.ndarray]] = {}
    for group, leaves in _block_layout(cfg).items():
        blocks[group] = {}
        for leaf, shape in leaves.items():
            attr = "scale" if group.startswith("ln") else leaf
            blocks[group][leaf] = np.stack(
                [get(getattr(getattr(b, group), attr), shape)
                 for b in model.blocks])
    tree["blocks"] = blocks
    return tree
