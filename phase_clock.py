#!/usr/bin/env python3
"""Where the cycles of the two fitness bodies go, phase by phase, on one
card.

    python3 phase_clock.py [--csrc DIR] [--reps 3]

Copies ``pso_fitness.cu`` and ``fitness_quantized.cu`` from ``--csrc``
(this checkout's ``src/repro_torch/csrc`` by default; another
checkout's, such as a parent unpacked with ``git archive``, to measure
that one), and inserts into every ``__global__`` kernel a ``clock64()``
stamp that thread 0 of each CTA takes at its start, after every
``__syncthreads();`` line and at its end. A stamp adds the cycles since
the CTA's previous stamp to its own counter, so a stamp inside a loop
sums over the loop's turns and every counter sums over the CTAs. The
copies are built with ``_build.NVCC_FLAGS`` into a directory of their
own and swapped in for this checkout's libraries for the counted calls;
the wrappers (this checkout's) are unchanged, so ``--csrc`` must hold
sources with the same C entry points.

The cases are the wide bucket of ``chip_smoke.py`` phase 4f
(deepseek-7b's (312, 528) problem, N = 64), the Tier-0 call there (N =
1 on the projection's 0/255 tile, 0/1 for the float body) and the
window-8 bucket (56, 528), N = 64. For each body and case one JSON line:
the counted cycles by stamp (its source line and the code before it)
and their shares, the call's CUDA-event ms and the device ms of each
kernel function under the profiler, both with the uninstrumented
libraries. It exits non-zero without a card.
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
SOURCES = ("pso_fitness", "fitness_quantized")
MAX_STAMPS = 64
SLOTS = 1 << 16            # CTAs whose last stamp is kept apart

PRELUDE = f"""
__device__ unsigned long long g_ph[{MAX_STAMPS}];
__device__ long long g_last[{SLOTS}];
__device__ __forceinline__ unsigned ph_slot() {{
  return (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) &
         {SLOTS - 1}u;
}}
#define PH_START                                                    \\
  if (threadIdx.x == 0) g_last[ph_slot()] = clock64();
#define PH(k)                                                       \\
  if (threadIdx.x == 0) {{                                           \\
    const long long ph_now = clock64();                             \\
    atomicAdd(&g_ph[k],                                             \\
              (unsigned long long)(ph_now - g_last[ph_slot()]));    \\
    g_last[ph_slot()] = ph_now;                                     \\
  }}
"""

EPILOGUE = f"""
extern "C" int phase_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_ph, sizeof(g_ph));
}}
extern "C" int phase_zero() {{
  static const unsigned long long z[{MAX_STAMPS}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_ph, z, sizeof(z));
}}
"""


def _code(line: str) -> str:
    return line.split("//", 1)[0]


def instrument(text: str):
    """The source with the stamps, and ``{stamp: (line, context)}``: a
    ``__global__`` kernel gets a start stamp, one after every barrier and
    an end stamp; a ``__device__`` function with a barrier (a body that
    its kernels call) one after every barrier."""
    lines = text.split("\n")
    last_inc = max(j for j, ln in enumerate(lines)
                   if ln.startswith("#include"))
    out, names = [], {}
    i = 0
    while i < len(lines):
        out.append(lines[i])
        if i == last_inc:
            out.append(PRELUDE)
        code = _code(lines[i])
        kernel = "__global__" in code
        if not (kernel or "__device__" in code):
            i += 1
            continue
        j = i        # the line that opens the body, or ends a declaration
        while not re.search(r"[{;]", _code(lines[j])):
            j += 1
        if "{" not in _code(lines[j]).split(";")[0]:
            i += 1
            continue
        depth, end = 0, j
        while True:
            c = _code(lines[end])
            depth += c.count("{") - c.count("}")
            if depth == 0:
                break
            end += 1
        body = lines[j + 1:end]
        if not kernel and not any(_code(ln).strip() == "__syncthreads();"
                                  for ln in body):
            i += 1
            continue
        out.extend(lines[i + 1:j + 1])
        if kernel:
            out.append("PH_START")
        for t in range(j + 1, end):
            out.append(lines[t])
            if _code(lines[t]).strip() in ("__syncthreads();",
                                           "cluster.sync();"):
                k = len(names)
                ctx = " | ".join(s.strip() for s in lines[max(0, t - 2):t]
                                 if s.strip())
                out.append(f"PH({k})")
                names[k] = (t + 1, ctx[-160:])
        if kernel:
            k = len(names)
            out.append(f"PH({k})")
            names[k] = (end + 1, "end of kernel")
        out.append(lines[end])
        i = end + 1
    assert len(names) <= MAX_STAMPS, len(names)
    return "\n".join(out) + EPILOGUE, names


def build(kb, csrc: Path, work: Path):
    """``{stem: (library, stamp names)}`` of the instrumented copies."""
    work.mkdir(parents=True, exist_ok=True)
    procs, names = [], {}
    for stem in SOURCES:
        text, names[stem] = instrument((csrc / f"{stem}.cu").read_text())
        src = work / f"{stem}.cu"
        src.write_text(text)
        out = work / f"lib{stem}_phases.so"
        procs.append((stem, out, subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    libs = {}
    for stem, out, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}:\n{err}")
        libs[stem] = (ctypes.CDLL(str(out)), names[stem])
    return libs


def problems(cs, ref):
    """``{case: (Q, G, float S, uint8 S)}``."""
    tgt, _, reqs = cs.wide_requests()
    _, Q, G, M, x = cs.wide_bucket_problem(tgt, reqs)
    tile = ref.structured_project(x["S_star"], Q, G, M).float()[:, None]
    out = {f"{cs.WIDE_BUCKET} N=64": (Q, G, x["S"], x["S_q"]),
           f"{cs.WIDE_BUCKET} N=1 tier0": (Q, G, (tile != 0).float(),
                                           ref.quantize_s(tile))}
    _, Q, G, M, x = cs.window_bucket_problem()
    out[f"{cs.WINDOW_BUCKET} N=64"] = (Q, G, x["S"], x["S_q"])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, help="the CUDA sources to measure")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase_clock: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build as kb, ref
    from repro_torch.kernels.pso_fitness import edge_fitness_cuda
    csrc = (args.csrc or kb.CSRC).resolve()
    print(cs.card_line(), flush=True)
    kb.build_all()
    plain = {stem: kb.library(stem) for stem in SOURCES}
    if csrc != kb.CSRC.resolve():      # the other checkout's, uninstrumented
        own = kb.CSRC
        kb.CSRC = csrc
        try:
            kb.build_all(SOURCES)
            plain = {s: ctypes.CDLL(str(kb._build_dir() / f"lib{s}.so"))
                     for s in SOURCES}
        finally:
            kb.CSRC = own
    libs = build(kb, csrc, kb.BUILD_ROOT / "phase_clock")
    for case, (Q, G, S, S_q) in problems(cs, ref).items():
        for stem, quantized in (("fitness_quantized", True),
                                ("pso_fitness", False)):
            def call():
                return edge_fitness_cuda(S_q if quantized else S, Q, G,
                                         quantized=quantized)
            kb._libs[stem] = plain[stem]
            want = call()
            ms = statistics.median(cs.cuda_ms(call, reps=5)
                                   for _ in range(args.reps))
            rows = cs.profiled(call)[2]
            lib, names = libs[stem]
            kb._libs[stem] = lib
            got = call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * MAX_STAMPS)()
            kb.check(lib.phase_zero(), "phase_zero")
            call()
            torch.cuda.synchronize()
            kb.check(lib.phase_read(buf), "phase_read")
            kb._libs[stem] = plain[stem]
            cyc = {k: int(buf[k]) for k in names if buf[k]}
            tot = sum(cyc.values()) or 1
            print(json.dumps(dict(
                body=stem, case=case, shape=list(S.shape),
                same_bits=bool(torch.equal(got, want)), ms=ms,
                device_ms={key: dev for key, dev, _ in rows},
                stamps={f"{k} L{names[k][0]}": dict(
                    cycles=c, share=c / tot, after=names[k][1])
                    for k, c in cyc.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
