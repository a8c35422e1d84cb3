"""Workload zoo: the paper's nine evaluation models + LM-config lowering.

Simple  (AR/VR):  MobileNetV2, ResNet50, UNet
Middle  (NAS):    EfficientNet-B0, NASNet-A, PNASNet-5
Complex (LLM):    DeepSeek-7B, Qwen-7B, Llama-3-8B

Layer graphs are structural models (kinds, MAC counts, activation bytes,
branch topology) — faithful enough for scheduling/energy studies; they are
*not* the numerics (the numerics live in ``repro.models``). LM workloads can
also be generated from any model config (an object with ``name``,
``num_layers``, ``d_model``, ``d_ff``, ``num_heads``, ``kv_heads`` and
``vocab_size``) via ``lm_workload_from_config``.

Numpy copy of the JAX package's ``workloads/zoo.py``; the port keeps its
own copy so that importing it never pulls in JAX.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.workloads.layers import (Builder, LayerKind, WorkloadGraph,
                                    conv_macs, conv_out_bytes)

K = LayerKind


# ---------------------------------------------------------------------------
# Simple
# ---------------------------------------------------------------------------

def mobilenet_v2(res: int = 224) -> WorkloadGraph:
    b = Builder("mobilenetv2")
    h = res // 2
    b.add("stem", K.CONV, conv_macs(3, 32, 3, h, h), conv_out_bytes(32, h, h))
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    cin = 32
    for t, c, n, s in cfg:
        for i in range(n):
            stride = s if i == 0 else 1
            h = max(h // stride, 7)
            hid = cin * t
            p = b.add(f"ir{c}_{i}.expand", K.CONV,
                      conv_macs(cin, hid, 1, h, h), conv_out_bytes(hid, h, h))
            b.add(f"ir{c}_{i}.dw", K.CONV, 9.0 * hid * h * h,
                  conv_out_bytes(hid, h, h))
            b.add(f"ir{c}_{i}.project", K.CONV,
                  conv_macs(hid, c, 1, h, h), conv_out_bytes(c, h, h))
            if stride == 1 and cin == c:
                b.add(f"ir{c}_{i}.add", K.ELEMENTWISE, c * h * h,
                      conv_out_bytes(c, h, h), preds=[p - 1, len(b.layers) - 1])
            cin = c
    b.add("head", K.CONV, conv_macs(cin, 1280, 1, 7, 7),
          conv_out_bytes(1280, 7, 7))
    b.add("pool", K.POOL, 1280 * 49, 1280)
    b.add("fc", K.MATMUL, 1280 * 1000, 1000)
    return b.build()


def resnet50(res: int = 224) -> WorkloadGraph:
    b = Builder("resnet50")
    h = res // 4
    b.add("stem", K.CONV, conv_macs(3, 64, 7, res // 2, res // 2),
          conv_out_bytes(64, h, h))
    b.add("maxpool", K.POOL, 64 * h * h, conv_out_bytes(64, h, h))
    cin = 64
    for stage, (c, n) in enumerate([(64, 3), (128, 4), (256, 6), (512, 3)]):
        if stage:
            h = h // 2
        for i in range(n):
            inp = len(b.layers) - 1
            b.add(f"s{stage}b{i}.c1", K.CONV, conv_macs(cin, c, 1, h, h),
                  conv_out_bytes(c, h, h), preds=[inp])
            b.add(f"s{stage}b{i}.c2", K.CONV, conv_macs(c, c, 3, h, h),
                  conv_out_bytes(c, h, h))
            b.add(f"s{stage}b{i}.c3", K.CONV, conv_macs(c, 4 * c, 1, h, h),
                  conv_out_bytes(4 * c, h, h))
            b.add(f"s{stage}b{i}.add", K.ELEMENTWISE, 4 * c * h * h,
                  conv_out_bytes(4 * c, h, h),
                  preds=[inp, len(b.layers) - 1])
            cin = 4 * c
    b.add("pool", K.POOL, cin * h * h, cin)
    b.add("fc", K.MATMUL, cin * 1000, 1000)
    return b.build()


def unet(res: int = 256) -> WorkloadGraph:
    b = Builder("unet")
    enc_out = []
    h, cin = res, 3
    for d, c in enumerate([64, 128, 256, 512]):
        b.add(f"enc{d}.c1", K.CONV, conv_macs(cin, c, 3, h, h),
              conv_out_bytes(c, h, h))
        i = b.add(f"enc{d}.c2", K.CONV, conv_macs(c, c, 3, h, h),
                  conv_out_bytes(c, h, h))
        enc_out.append((i, c, h))
        b.add(f"enc{d}.pool", K.POOL, c * h * h, conv_out_bytes(c, h // 2,
                                                                h // 2))
        cin, h = c, h // 2
    b.add("mid.c1", K.CONV, conv_macs(cin, 1024, 3, h, h),
          conv_out_bytes(1024, h, h))
    b.add("mid.c2", K.CONV, conv_macs(1024, 1024, 3, h, h),
          conv_out_bytes(1024, h, h))
    cin = 1024
    for d, (skip, c, sh) in enumerate(reversed(enc_out)):
        h = h * 2
        b.add(f"dec{d}.up", K.CONV, conv_macs(cin, c, 2, h, h),
              conv_out_bytes(c, h, h))
        b.add(f"dec{d}.cat", K.ELEMENTWISE, c * h * h,
              conv_out_bytes(2 * c, h, h), preds=[skip, len(b.layers) - 1])
        b.add(f"dec{d}.c1", K.CONV, conv_macs(2 * c, c, 3, h, h),
              conv_out_bytes(c, h, h))
        b.add(f"dec{d}.c2", K.CONV, conv_macs(c, c, 3, h, h),
              conv_out_bytes(c, h, h))
        cin = c
    b.add("head", K.CONV, conv_macs(cin, 2, 1, h, h), conv_out_bytes(2, h, h))
    return b.build()


# ---------------------------------------------------------------------------
# Middle (NAS family) — cell-based topologies with branchy DAGs
# ---------------------------------------------------------------------------

def _nas_cell(b: Builder, name: str, cin: int, c: int, h: int,
              branches: int, inputs) -> int:
    outs = []
    for j in range(branches):
        src = inputs[j % len(inputs)]
        b.add(f"{name}.b{j}.sep", K.CONV, conv_macs(cin, c, 3, h, h) * 0.35,
              conv_out_bytes(c, h, h), preds=[src])
        o = b.add(f"{name}.b{j}.pw", K.CONV, conv_macs(c, c, 1, h, h),
                  conv_out_bytes(c, h, h))
        outs.append(o)
    return b.add(f"{name}.concat", K.ELEMENTWISE, c * branches * h * h,
                 conv_out_bytes(c * branches, h, h), preds=outs)


def efficientnet_b0(res: int = 224) -> WorkloadGraph:
    b = Builder("efficientnet")
    h = res // 2
    b.add("stem", K.CONV, conv_macs(3, 32, 3, h, h), conv_out_bytes(32, h, h))
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 40, 2, 2), (6, 80, 3, 2),
           (6, 112, 3, 1), (6, 192, 4, 2), (6, 320, 1, 1)]
    cin = 32
    for t, c, n, s in cfg:
        for i in range(n):
            h = max(h // (s if i == 0 else 1), 7)
            hid = cin * t
            b.add(f"mb{c}_{i}.expand", K.CONV, conv_macs(cin, hid, 1, h, h),
                  conv_out_bytes(hid, h, h))
            b.add(f"mb{c}_{i}.dw", K.CONV, 25.0 * hid * h * h,
                  conv_out_bytes(hid, h, h))
            b.add(f"mb{c}_{i}.se", K.REDUCE, hid * h * h,
                  conv_out_bytes(hid, 1, 1))
            b.add(f"mb{c}_{i}.project", K.CONV, conv_macs(hid, c, 1, h, h),
                  conv_out_bytes(c, h, h))
            cin = c
    b.add("head", K.CONV, conv_macs(cin, 1280, 1, 7, 7),
          conv_out_bytes(1280, 7, 7))
    b.add("pool", K.POOL, 1280 * 49, 1280)
    b.add("fc", K.MATMUL, 1280 * 1000, 1000)
    return b.build()


def nasnet_a(res: int = 224) -> WorkloadGraph:
    b = Builder("nasnet")
    h = res // 4
    prev = b.add("stem", K.CONV, conv_macs(3, 96, 3, res // 2, res // 2),
                 conv_out_bytes(96, h, h))
    cin = 96
    for stage, (c, n) in enumerate([(168, 4), (336, 4), (672, 4)]):
        if stage:
            h = max(h // 2, 7)
        for i in range(n):
            prev2 = max(prev - 1, 0)
            prev = _nas_cell(b, f"s{stage}c{i}", cin, c // 4, h, 5,
                             [prev, prev2])
            cin = c * 5 // 4
    b.add("pool", K.POOL, cin * h * h, cin)
    b.add("fc", K.MATMUL, cin * 1000, 1000)
    return b.build()


def pnasnet_5(res: int = 224) -> WorkloadGraph:
    b = Builder("pnasnet")
    h = res // 4
    prev = b.add("stem", K.CONV, conv_macs(3, 96, 3, res // 2, res // 2),
                 conv_out_bytes(96, h, h))
    cin = 96
    for stage, (c, n) in enumerate([(270, 3), (540, 3), (1080, 3)]):
        if stage:
            h = max(h // 2, 7)
        for i in range(n):
            prev2 = max(prev - 1, 0)
            prev = _nas_cell(b, f"s{stage}c{i}", cin, c // 5, h, 5,
                             [prev, prev2])
            cin = c
    b.add("pool", K.POOL, cin * h * h, cin)
    b.add("fc", K.MATMUL, cin * 1000, 1000)
    return b.build()


# ---------------------------------------------------------------------------
# Complex (LLM decode-step workloads: per-token transformer DAGs)
# ---------------------------------------------------------------------------

def _llm_workload(name: str, layers: int, d_model: int, d_ff: int,
                  n_heads: int, kv_heads: int, vocab: int,
                  seq_ctx: int = 2048, qkv_bias: bool = False,
                  block_group: int = 0) -> WorkloadGraph:
    """Per-token decode DAG for the full model (``block_group`` > 0
    truncates to that many blocks — used when callers want just a
    scheduler-window-sized graph). The preemptible-DAG window bounds the
    matcher size regardless, so the default models all layers."""
    b = Builder(name)
    head_dim = d_model // n_heads
    act = 2.0  # bf16 activation bytes
    b.add("embed", K.EMBED, d_model, d_model * act)
    for l in range(block_group if block_group > 0 else layers):
        b.add(f"l{l}.ln1", K.NORM, d_model, d_model * act)
        q = b.add(f"l{l}.q", K.MATMUL, d_model * d_model, d_model * act)
        kv = b.add(f"l{l}.kv", K.MATMUL,
                   2 * d_model * kv_heads * head_dim,
                   2 * kv_heads * head_dim * act, preds=[q - 1])
        b.add(f"l{l}.attn", K.ATTN, 2.0 * seq_ctx * d_model,
              d_model * act, preds=[q, kv])
        b.add(f"l{l}.o", K.MATMUL, d_model * d_model, d_model * act)
        r1 = b.add(f"l{l}.res1", K.ELEMENTWISE, d_model, d_model * act,
                   preds=[q - 1, len(b.layers) - 1])
        b.add(f"l{l}.ln2", K.NORM, d_model, d_model * act)
        g = b.add(f"l{l}.ffn_gate", K.MATMUL, d_model * d_ff, d_ff * act)
        u = b.add(f"l{l}.ffn_up", K.MATMUL, d_model * d_ff, d_ff * act,
                  preds=[g - 1])
        b.add(f"l{l}.ffn_mul", K.ELEMENTWISE, d_ff, d_ff * act, preds=[g, u])
        b.add(f"l{l}.ffn_down", K.MATMUL, d_ff * d_model, d_model * act)
        b.add(f"l{l}.res2", K.ELEMENTWISE, d_model, d_model * act,
              preds=[r1, len(b.layers) - 1])
    b.add("final_ln", K.NORM, d_model, d_model * act)
    b.add("lm_head", K.MATMUL, d_model * vocab, vocab * act)
    wg = b.build()
    wg.name = name
    return wg


def deepseek_7b() -> WorkloadGraph:
    return _llm_workload("deepseek-7b", 30, 4096, 11008, 32, 32, 102400)


def qwen_7b() -> WorkloadGraph:
    return _llm_workload("qwen-7b", 32, 4096, 11008, 32, 32, 151936,
                         qkv_bias=True)


def llama3_8b_workload() -> WorkloadGraph:
    return _llm_workload("llama3-8b", 32, 4096, 14336, 32, 8, 128256)


def lm_workload_from_config(cfg, seq_ctx: int = 2048,
                            block_group: int = 0) -> WorkloadGraph:
    """Lower a model config to a scheduler workload —
    the bridge between the training/serving framework and the paper's
    scheduler."""
    d_ff = cfg.d_ff if cfg.d_ff else 4 * cfg.d_model
    return _llm_workload(cfg.name, cfg.num_layers, cfg.d_model, d_ff,
                         cfg.num_heads, cfg.kv_heads, cfg.vocab_size,
                         seq_ctx=seq_ctx, block_group=block_group)


WORKLOAD_ZOO: Dict[str, object] = {
    "mobilenetv2": mobilenet_v2,
    "resnet50": resnet50,
    "unet": unet,
    "efficientnet": efficientnet_b0,
    "nasnet": nasnet_a,
    "pnasnet": pnasnet_5,
    "deepseek-7b": deepseek_7b,
    "qwen-7b": qwen_7b,
    "llama3-8b-wl": llama3_8b_workload,
}

_COMPLEXITY = {
    "simple": ["mobilenetv2", "resnet50", "unet"],
    "middle": ["efficientnet", "nasnet", "pnasnet"],
    "complex": ["deepseek-7b", "qwen-7b", "llama3-8b-wl"],
}


def get_workload(name: str) -> WorkloadGraph:
    return WORKLOAD_ZOO[name]()


def workload_complexity_class(cls: str):
    return [get_workload(n) for n in _COMPLEXITY[cls]]
