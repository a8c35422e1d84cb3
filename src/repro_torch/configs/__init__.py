"""Architecture registry: ``--arch <id>`` resolution + per-arch policies.

Port of the JAX package's ``configs/__init__.py``. ``get_config(arch)``
returns the exact published ``ModelConfig``; ``get_train_config(arch)``
the training policy (optimizer family, state dtype, gradient-accumulation
microbatches), which ``launch/train.py`` reads; ``input_specs``
builds the input dict: tensors on the ``meta`` device (shapes and dtypes,
nothing allocated, the counterpart of ``jax.ShapeDtypeStruct``), or
zeros on a device for smoke runs.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      PREFILL_32K, TRAIN_4K, ModelConfig,
                                      ShapeConfig, TrainConfig, shapes_for)

_MODULES = {
    "llama3-8b": "llama3_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2.5-3b": "qwen2_5_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "arctic-480b": "arctic_480b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-7b": "zamba2_7b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCHS: List[str] = list(_MODULES)

# the reference's training policies per arch (sized there for a 16 GB
# accelerator)
_TRAIN_POLICY: Dict[str, TrainConfig] = {
    "llama3-8b": TrainConfig(microbatches=4),
    "qwen1.5-110b": TrainConfig(microbatches=16, optimizer="adafactor",
                                opt_state_dtype="bfloat16"),
    "qwen1.5-0.5b": TrainConfig(microbatches=1),
    "qwen2.5-3b": TrainConfig(microbatches=2),
    "seamless-m4t-medium": TrainConfig(microbatches=1),
    "deepseek-v2-236b": TrainConfig(microbatches=16, optimizer="adafactor",
                                    opt_state_dtype="bfloat16"),
    "arctic-480b": TrainConfig(microbatches=16, optimizer="adafactor",
                               opt_state_dtype="bfloat16"),
    "xlstm-1.3b": TrainConfig(microbatches=2),
    "zamba2-7b": TrainConfig(microbatches=4),
    "qwen2-vl-7b": TrainConfig(microbatches=4),
}

# modality frontends (stubs): token split for mixed inputs
VLM_PATCH_TOKENS = 1024          # of the seq_len, for family == vlm
AUDIO_FRAME_RATIO = 1.0          # encoder frames per decoder token

# parallelism profile per (arch, shape): "2d" (FSDP×TP, default) or
# "fsdp_only"; no cell uses the latter, as in the reference
_PARALLELISM: Dict = {}


def parallelism_profile(arch: str, shape_name: str) -> str:
    return _PARALLELISM.get((arch, shape_name), "2d")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_train_config(arch: str) -> TrainConfig:
    return _TRAIN_POLICY[arch]


def arch_shapes(arch: str):
    return shapes_for(get_config(arch))


def input_specs(arch: str, shape: ShapeConfig, abstract: bool = True,
                batch_override: int = 0, device="cuda"):
    """Input dict for (arch × shape). ``abstract=True`` → tensors on the
    ``meta`` device (no allocation); else zeros on ``device``.

    train:   full-sequence tokens + labels (+ frontend embeddings)
    prefill: full-sequence tokens (+ frontend embeddings)
    decode:  one new token (KV cache of seq_len managed by the decode step)
    """
    cfg = get_config(arch)
    B = batch_override or shape.global_batch
    S = shape.seq_len

    def make(shp, dtype):
        return torch.zeros(shp, dtype=dtype,
                           device="meta" if abstract else device)

    batch = {}
    if shape.mode == "decode":
        batch["tokens"] = make((B, 1), torch.int32)
        if cfg.mrope:
            batch["positions3"] = make((3, B, 1), torch.int32)
    else:
        s_text = S
        if cfg.family == "vlm":
            n_patch = min(VLM_PATCH_TOKENS, S // 4)
            s_text = S - n_patch
            batch["patches"] = make((B, n_patch, cfg.d_model),
                                    torch.bfloat16)
        if cfg.family in ("encdec", "audio"):
            n_frames = max(int(S * AUDIO_FRAME_RATIO) // 2, 8)
            batch["frames"] = make((B, n_frames, cfg.d_model),
                                   torch.bfloat16)
        batch["tokens"] = make((B, s_text), torch.int32)
        if cfg.mrope:
            batch["positions3"] = make((3, B, S), torch.int32)
        if shape.mode == "train":
            batch["labels"] = make((B, s_text), torch.int32)
    return batch
