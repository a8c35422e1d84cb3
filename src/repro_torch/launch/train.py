"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 300 --reduced --checkpoint-dir CKPT [--device cpu]

Port of the JAX package's ``launch/train.py``, with its flags and log
lines and ``--device`` (the card unless ``cpu``). ``--reduced`` shrinks
the architecture (same family/topology) so a ~100M model trains a few
hundred steps on the CPU. Features exercised: the deterministic
resumable data pipeline, AdamW/Adafactor as the arch's training policy
says (``get_train_config``, one microbatch), checkpoint/restart (resume
from the latest checkpoint automatically: weights, optimizer state, step
and the data cursor, in the reference's tree, so either package resumes
from the other's checkpoint), the straggler watchdog, and an abort with
return code 1 on a non-finite loss. The weights are drawn from a
generator on the device seeded with ``--seed``.

On the card ``main`` turns off cuBLAS's reduced-precision reduction for
bfloat16 products and keeps TF32 off, as ``launch/serve.py`` does.

``reduced_config`` is the JAX package's; ``tiny_config`` is the smallest
variant its smoke tests run (``tests/test_smoke_archs.py``
``reduce_config``), for every family.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_train_config
from repro_torch.configs.base import MLAConfig, MoEConfig, SSMConfig
from repro_torch.data import DataPipeline, SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.models.model import resolve_device
from repro_torch.runtime.ft import StepWatchdog
from repro_torch.runtime.train_loop import (load_train_state,
                                            make_train_state,
                                            make_train_step,
                                            train_state_tree)


def reduced_config(cfg, d_model: int = 512, layers: int = 8):
    """~100M-class variant of the same family (the tests use a tinier
    one). The reference's takes 4 KV heads whatever the query heads; at
    a width whose head count 4 does not divide (d_model 768: 6 heads)
    its models raise, its own ``examples/train_lm.py`` included. Here
    the KV heads are gcd(heads, 4), which is 4 wherever the reference's
    runs."""
    heads = max(4, d_model // 128)
    kw = dict(num_layers=layers, d_model=d_model,
              num_heads=heads, kv_heads=math.gcd(heads, 4),
              d_ff=d_model * 3, vocab_size=32000,
              compute_dtype="float32", param_dtype="float32")
    if cfg.family == "ssm":
        kw["num_layers"] = (layers // cfg.ssm.slstm_period + 1) \
            * cfg.ssm.slstm_period
        kw["kv_heads"] = kw["num_heads"]
    if cfg.family == "hybrid":
        kw["kv_heads"] = kw["num_heads"]
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=8, top_k=2,
                              expert_d_ff=d_model,
                              shared_experts=min(cfg.moe.shared_experts, 1),
                              dense_residual_d_ff=d_model
                              if cfg.moe.dense_residual_d_ff else 0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=128, q_lora_rank=192,
                              rope_head_dim=32, nope_head_dim=64,
                              v_head_dim=64)
    if cfg.mrope:
        hd = d_model // kw["num_heads"]
        kw["mrope_sections"] = (hd // 4, hd // 8, hd // 8)
    if cfg.family in ("encdec", "audio"):
        kw["encoder_layers"] = layers
    return cfg.replace(**kw)


def tiny_config(cfg):
    """The smallest variant of a config that keeps its family's
    structure: d_model 64, 2 layers, 4 query heads over 2 KV heads, d_ff
    128, vocab 256, float32; xlstm 4 layers in groups of 2, zamba2 5 (two
    groups of 2 and a tail), 8 experts top-2, MLA of ranks 16 / 24."""
    kw = dict(num_layers=2, d_model=64, num_heads=4, kv_heads=2,
              d_ff=128, vocab_size=256, compute_dtype="float32",
              param_dtype="float32", remat="none")
    if cfg.family == "ssm":      # xlstm: layers % slstm_period == 0
        kw.update(num_layers=4, kv_heads=4,
                  ssm=SSMConfig(kind="xlstm", expand=2, conv_dim=4,
                                chunk=8, slstm_period=2))
    if cfg.family == "hybrid":   # zamba2: groups of period + tail
        kw.update(num_layers=5, kv_heads=4,
                  ssm=SSMConfig(kind="mamba2", state_dim=8, expand=2,
                                conv_dim=4, chunk=8, shared_attn_period=2))
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=8, top_k=2, expert_d_ff=32,
            shared_experts=min(cfg.moe.shared_experts, 1),
            dense_residual_d_ff=32 if cfg.moe.dense_residual_d_ff else 0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=16, q_lora_rank=24,
                              rope_head_dim=4, nope_head_dim=8,
                              v_head_dim=8)
    if cfg.mrope:
        kw["mrope_sections"] = (2, 3, 3)   # head_dim 16 -> half 8
    if cfg.family in ("encdec", "audio"):
        kw["encoder_layers"] = 2
    return cfg.replace(**kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg, args.d_model, args.layers)
    tcfg = dataclasses.replace(get_train_config(args.arch), microbatches=1,
                               total_steps=args.steps,
                               warmup_steps=max(args.steps // 20, 5))

    model = build_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(args.seed))
    train_step = make_train_step(model, tcfg)

    dataset = SyntheticLMDataset(vocab_size=cfg.vocab_size,
                                 seq_len=args.seq, seed=args.seed)
    pipeline = DataPipeline(dataset, global_batch=args.batch)

    state = make_train_state(model, tcfg)
    n_params = model.num_params()
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    ckpt = None
    start_step = 0
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)
        if ckpt.latest_step() is not None:
            tree, extras = ckpt.restore(train_state_tree(state))
            state = load_train_state(state, tree)
            start_step = int(extras["step"])
            pipeline.load_state_dict(extras["pipeline"])
            print(f"resumed from step {start_step}")

    watchdog = StepWatchdog()
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipeline.next().items()}
        t0 = time.time()
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if watchdog.observe(dt):
            print(f"[watchdog] step {step} straggled: {dt * 1e3:.0f} ms")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:6.0f} ms")
        if not np.isfinite(loss):
            print("NaN loss — aborting")
            return 1
        if ckpt and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, train_state_tree(state),
                      extras={"step": step + 1,
                              "pipeline": pipeline.state_dict()})
    if ckpt:
        ckpt.save(args.steps, train_state_tree(state),
                  extras={"step": args.steps,
                          "pipeline": pipeline.state_dict()})
        ckpt.wait()
    print(f"done in {time.time() - t_start:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
