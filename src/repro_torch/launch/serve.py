"""Serving launcher: prefill + batched greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduced --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Port of the JAX package's ``launch/serve.py``: one prefill step, then
token-at-a-time greedy decode against caches written in place. Runs on
the card unless given ``--device cpu``. The weights are random, drawn
from a generator on the device seeded with ``--seed``; the prompt from a
host generator seeded with ``--seed`` + 1.

Times: prefill is its first call; decode is the sum of the ``gen`` − 1
steps, and tokens/s counts ``batch · (gen − 1)`` over it, as the
reference does; the first decode step is reported apart from the median
of the rest. On the card every mark is a CUDA event, read after one
synchronisation at the end, so the loop itself never waits for the
device.

On the card ``main`` turns off cuBLAS's reduced-precision reduction for
bfloat16 products (``allow_bf16_reduced_precision_reduction``, on by
default), so that they accumulate in float32 as XLA's do, and keeps TF32
off for float32 products. ``serve`` itself changes no global setting.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import reduced_config
from repro_torch.models import build_model
from repro_torch.models.model import LM, VLM_PATCHES, resolve_device
from repro_torch.runtime.serve_loop import make_decode_step, make_prefill_step


class _Clock:
    """Marks on the card's stream (CUDA events) or on the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def prompt_batch(model: LM, batch: int, prompt_len: int, seed: int):
    """The seeded random prompt on the model's device: tokens, 8 patch
    embeddings for a ``vlm``, ``prompt_len`` frame embeddings for an
    ``encdec``/``audio`` model. Drawn on the host, so that one seed gives
    one prompt on every device."""
    cfg = model.cfg
    gen = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=gen, dtype=torch.int32)}
    if cfg.family == "vlm":
        out["patches"] = torch.randn((batch, VLM_PATCHES, cfg.d_model),
                                     generator=gen)
    if cfg.family in ("encdec", "audio"):
        out["frames"] = torch.randn((batch, prompt_len, cfg.d_model),
                                    generator=gen)
    return {k: v.to(model.device) for k, v in out.items()}


def serve(model: LM, batch: int = 4, prompt_len: int = 64, gen: int = 32,
          seed: int = 0) -> dict:
    """Prefill a seeded prompt, then ``gen`` − 1 greedy decode steps.
    Returns the generated tokens (B, gen), the logits of every step
    (prefill's first), the caches and the times (ms).

    The caches hold ``prompt_len + gen`` positions, as the reference
    launcher's do. A ``vlm``'s prompt takes 8 more (the patches), so its
    last 7 decode writes clamp onto the buffer's last slot, as theirs
    do; with ``gen`` < 8 its prompt does not fit, and this raises."""
    cfg, device = model.cfg, model.device
    start = prompt_len + (VLM_PATCHES if cfg.family == "vlm" else 0)
    max_len = prompt_len + gen
    if start > max_len:
        raise ValueError(f"the prompt fills {start} positions (patches "
                         f"included), more than the cache's prompt_len + "
                         f"gen = {max_len}: gen must be at least "
                         f"{start - prompt_len}")
    inputs = prompt_batch(model, batch, prompt_len, seed)
    prefill = make_prefill_step(model, max_len=max_len)
    decode = make_decode_step(model)
    clock = _Clock(device)

    clock.sync()
    marks = [clock.mark()]
    logits, caches = prefill(inputs)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    marks.append(clock.mark())
    out, step_logits = [tok], [logits]
    for i in range(gen - 1):
        step = {"tokens": tok[:, None]}
        if cfg.mrope:
            step["positions3"] = torch.full((3, batch, 1), start + i,
                                            dtype=torch.int32, device=device)
        tok, logits, caches = decode(step, caches, start + i)
        out.append(tok)
        step_logits.append(logits)
        marks.append(clock.mark())
    clock.sync()
    steps = [clock.ms(a, b) for a, b in zip(marks[1:], marks[2:])]
    decode_ms = sum(steps)
    return dict(
        tokens=torch.stack(out, dim=1), logits=step_logits, caches=caches,
        max_len=max_len, prefill_ms=clock.ms(marks[0], marks[1]),
        decode_ms=decode_ms, step_ms=steps,
        first_step_ms=steps[0] if steps else None,
        step_ms_median=statistics.median(steps[1:]) if len(steps) > 1
        else None,
        tok_s=batch * (gen - 1) / max(decode_ms / 1e3, 1e-9))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg, d_model=256, layers=4)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    model = build_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(args.seed))
    r = serve(model, args.batch, args.prompt_len, args.gen, args.seed + 1)
    print(f"arch={cfg.name} batch={args.batch} "
          f"prefill {r['prefill_ms']:.0f} ms, "
          f"decode {r['decode_ms']:.0f} ms ({r['tok_s']:.1f} tok/s)")
    if r["first_step_ms"] is not None:
        later = ("" if r["step_ms_median"] is None else
                 f", later steps median {r['step_ms_median']:.2f} ms")
        print(f"first decode step {r['first_step_ms']:.2f} ms{later}")
    print("sample generation (token ids):",
          r["tokens"][0][:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
