#!/usr/bin/env python3
"""This checkout's CUDA kernels against another checkout's, in one process.

    python3 kernel_ab.py BASE_DIR [--rounds 4] [--reps 10]

BASE_DIR is another checkout of the repo, for example a parent commit
unpacked with ``git archive``. For every kernel entry of
``chip_smoke.KERNELS`` whose CUDA source both checkouts have, the script
builds both libraries with the same flags and

  * compares their SASS, function by function (``cuobjdump -sass``);
  * runs the entry through this checkout's wrapper on chip_smoke's
    phase-3 inputs (the burst of 8 problems, N = 64, K = 12, bucket
    (56, 144), quantized, τ = 0) with each library in turn, and checks
    that both give the same bits;
  * times it with CUDA events, base, change, change, base in each round,
    so that both see the same card, inputs and allocator state.

It prints the card's name and power limit, then one JSON line per entry
(ms per call of each library in each round, their medians and the
change's ratio to the base). It exits non-zero without a card.
"""
import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def base_libraries(kb, base: Path, names):
    """Build ``names`` from the base checkout's sources, with this
    checkout's flags, into a build directory of their own."""
    own = kb.CSRC
    kb.CSRC = base / "src" / "repro_torch" / "csrc"
    try:
        kb.build_all(names)
        out = kb._build_dir()
    finally:
        kb.CSRC = own
    return {n: out / f"lib{n}.so" for n in names}


def sass(tool: Path, lib: Path):
    """``{kernel function: SASS text}`` of a library, or None without
    ``cuobjdump``."""
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    # an anonymous namespace's mangled name carries a hash of its file
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
    return {parts[i]: parts[i + 1].strip() for i in range(1, len(parts), 2)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, help="the other checkout")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import pso
    from repro_torch.kernels import _build as kb, cases

    base = args.base.resolve()
    stems = sorted({Path(src).stem for src, _ in cs.KERNELS.values()
                    if (base / src).exists()})
    kb.build_all()
    change = {n: kb._build_dir() / f"lib{n}.so" for n in stems}
    base_paths = base_libraries(kb, base, stems)
    libs = {"base": {n: ctypes.CDLL(str(p)) for n, p in base_paths.items()},
            "change": {n: kb.library(n) for n in stems}}
    print(cs.card_line(), flush=True)

    tool = Path(kb._nvcc()).with_name("cuobjdump")
    identical = {}
    for n in stems:
        a, b = sass(tool, base_paths[n]), sass(tool, change[n])
        identical[n] = (None if a is None else
                        {f: a.get(f) == b.get(f) for f in sorted({*a, *b})})

    _, _, _, Qb, Gb, Mb = cs.build_requests()
    x = cases.swarm_inputs(Qb, Gb, Mb, cs.N, cs.K, seed=cs.SEED)
    pairs = cases.kernel_pairs(Qb, Gb, Mb, x, quantized=True, gumbel_tau=0.0,
                               elite_k=pso.elite_k_for(pso.PSOConfig()))
    for name, (src, _) in cs.KERNELS.items():
        stem = Path(src).stem
        if stem not in stems:
            continue
        kern = pairs[name][0]
        calls = Mb.shape[0] if name in cases.PER_PROBLEM else 1
        outs = {}
        for side in ("base", "change"):
            kb._libs[stem] = libs[side][stem]
            got = kern()
            outs[side] = got if isinstance(got, tuple) else (got,)
        same = all(torch.equal(a, b)
                   for a, b in zip(outs["base"], outs["change"])
                   if isinstance(a, torch.Tensor))
        ms = {"base": [], "change": []}
        for _ in range(args.rounds):
            for side in ("base", "change", "change", "base"):
                kb._libs[stem] = libs[side][stem]
                ms[side].append(cs.cuda_ms(kern, reps=args.reps) / calls)
        kb._libs[stem] = libs["change"][stem]
        med = {k: statistics.median(v) for k, v in ms.items()}
        print(json.dumps(dict(
            kernel=name, source=src, same_bits=same,
            sass_identical=identical[stem], base_ms=ms["base"],
            change_ms=ms["change"], base_median_ms=med["base"],
            change_median_ms=med["change"],
            ratio=med["change"] / med["base"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
