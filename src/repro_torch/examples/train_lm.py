"""End-to-end driver: train a ~100M-parameter qwen-family LM for a few
hundred steps with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \
        [--device cpu] [--ckpt DIR]

The twin of the JAX package's ``examples/train_lm.py``: it wraps the
launcher (``repro_torch.launch.train``) with a reduced config — the
family and topology of qwen1.5-0.5b at d_model 768 and 10 layers (~100M
parameters), synthetic deterministic data, AdamW, batch 8 × 256, a
checkpoint every 50 steps. Kill it halfway and run again: it resumes
from the latest checkpoint. Runs on the card unless given ``--device
cpu``; the checkpoints go to ``--ckpt`` (by default a directory under
the system's temporary directory).
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    return train_main([
        "--arch", "qwen1.5-0.5b", "--reduced",
        "--d-model", "768", "--layers", "10",
        "--steps", str(args.steps), "--batch", "8", "--seq", "256",
        "--checkpoint-dir", args.ckpt, "--checkpoint-every", "50",
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
