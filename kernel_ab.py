#!/usr/bin/env python3
"""This checkout's CUDA kernels against another checkout's on one card.

    python3 kernel_ab.py BASE_DIR [--rounds 4] [--reps 10] [--bucket]

BASE_DIR is another checkout of the repo, for example a parent commit
unpacked with ``git archive``. For every kernel entry of
``chip_smoke.KERNELS`` whose CUDA source both checkouts have, the script
builds both libraries with the same flags, compares their SASS function
by function (``cuobjdump -sass``; blanks and branch label numbers
normalised), and runs the entry on chip_smoke's phase-3 inputs (the
burst of 8 problems, N = 64, K = 12, bucket (56, 144), quantized, τ = 0;
``epoch_fused`` float too):

  * the kernel alone, where the source's C entry points are the same in
    both checkouts: in this process, through this checkout's wrapper
    with each library in turn; same bits, then CUDA-event times base,
    change, change, base in each round, so that both see the same card,
    inputs and allocator state (``"per_side": false``);
  * wrapper and kernel together, where the C entry points differ or the
    Python between caller and kernel does (the entry's wrapper module
    ``kernels/<source>.py`` or ``kernels/_build.py``): through each
    checkout's own wrapper, one subprocess per side that imports that
    side's ``repro_torch`` and builds that side's kernels, in the order
    base, change, change, base, each timing ``--rounds`` runs of
    ``--reps`` calls on the same saved inputs; each side's outputs are
    saved and compared (``"per_side": true``). Both fitness bodies are
    also timed at the Tier-0 check's shape, and ``prune_fixpoint`` on one
    problem as a single ``match`` calls it (``"case"``); each side also
    runs chip_smoke's float ``match`` of unet and reports the device time
    of one profiled call (``"kernel": "IMMSchedMatcher.match"``).

An entry whose C entry points are the same but whose Python differs gets
both lines. An entry whose source is new in this checkout is timed
through each checkout's own wrapper, with ``"sass_identical": null``.
The script prints the card's name and power limit, then one
JSON line per entry and mode (ms per call of each side, their medians
and the change's ratio to the base; for the phase-3 calls and the cases
timed per side also each side's device time of one call under the
profiler, ``*_device_ms``, which a host-bound entry's CUDA-event times
do not show). Last, it times this checkout's ``ullmann_refine_step``
beside an empty launch of its grid and block, the floor its design can
reach (``"case": "empty launch"``). It exits non-zero without a card.

With ``--bucket`` it compares the SASS as above (one ``"sass"`` line)
and then times the five main-path entries past n, m = 256 instead:
phase 4f's problems at ``chip_smoke.WIDE_BUCKET`` (deepseek-7b mapped
whole, N = 64, K = 12) and ``WINDOW_BUCKET`` (pnasnet's window-8
problem, (56, 528)) and phase 3's random problems at every shape of
``chip_smoke.WIDE_CASES``, quantized (``epoch_fused`` float too), τ = 0,
through each checkout's own wrapper in the order base, change, change,
base, with the same bits on both sides; one JSON line an entry, mode and
case, with the instantiation the change ran there. Both fitness bodies
are also timed at the two buckets' Tier-0 call (``"tier0"``) and on
random problems at every (n, m) of ``CROSSOVER_SHAPES``, P of
``CROSSOVER_P`` and N of ``FITNESS_CROSSOVER_N`` (``"crossover"``,
CUDA events only), then one line a body counts the crossover cases where
the change's row-split body (``pso_fitness.path`` > 0) is slower than
the base by more than ``CROSSOVER_MARGIN``.

    python3 kernel_ab.py --crossover [--rounds 4] [--reps 10]

takes no other checkout. It builds this checkout's ``epoch_fused`` twice
more, with ``-DEPOCH_FUSED_CLUSTERS=0`` (the step never on clusters) and
``=1`` (on clusters wherever one fits past 256), and times the two on
random problems at every (n, m) of ``CROSSOVER_SHAPES`` and every P of
the service's batch classes (N = 64, K = 12), quantized and float, in
the order never, always, always, never, with the same bits on both; one
JSON line a case, with the kernel each build ran and the one this
checkout's rule picks (``"rule"``), then one line that counts the cases
where the rule picks the slower build by more than ``CROSSOVER_MARGIN``.
"""
import argparse
import ctypes
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
#: the extra cases of the per-side runs: the Tier-0 check's fitness
#: calls, and the pre-prune of a single-problem ``match``
CASES = {"tier0": "Tier 0: N = 1, the 0/255 tile of each problem's "
                  "projection (0/1 for the float body)",
         "p1": "P = 1: problem 1 (unet) of the burst, as a single match "
               "prunes it",
         "float_unet": "device ms of one profiled IMMSchedMatcher.match of "
                       "unet with the default (float) PSOConfig"}
#: the per-side key of that match: the path through both redesigned entries
MATCH_KEY = "IMMSchedMatcher.match/float_unet"
#: ``--crossover``: (n, m) past 256 (the scheduler's window-8 buckets on
#: the 512-engine platform reach n = 56, m = 528; the rest is the way to
#: deepseek-7b's n), the batch classes of ``MatcherService`` (problems a
#: launch), and the share by which the rule's pick may be the slower
CROSSOVER_SHAPES = ((8, 400), (8, 528), (40, 400), (40, 528), (56, 400),
                    (56, 528), (64, 528), (96, 400), (96, 528), (128, 528),
                    (200, 528))
CROSSOVER_P = (1, 2, 4, 8)
CROSSOVER_MARGIN = 0.03
#: ``--bucket``: the swarm widths of the fitness crossover cases (the
#: Tier-0 call's N = 1 and the swarm's 64)
FITNESS_CROSSOVER_N = (1, 64)
FITNESS = ("edge_fitness", "edge_fitness_quantized")    # by quantized


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


def variant_libraries(kb, name, defines):
    """``{label: loaded library}``: ``name`` built from this checkout's
    source once for each ``{label: -D flag}``, each into a build
    directory of its own."""
    own, libs = kb.NVCC_FLAGS, {}
    try:
        for label, flag in defines.items():
            kb.NVCC_FLAGS = (*own, flag)
            kb.build_all([name])
            libs[label] = ctypes.CDLL(str(kb._build_dir() / f"lib{name}.so"))
    finally:
        kb.NVCC_FLAGS = own
    return libs


def crossover(args, cs, cases, kb):
    """``--crossover``: ``epoch_fused``'s step off clusters against on
    clusters (see the module docstring)."""
    from repro_torch.kernels import epoch_fused
    own = kb.library("epoch_fused")
    libs = variant_libraries(kb, "epoch_fused",
                             {"never": "-DEPOCH_FUSED_CLUSTERS=0",
                              "always": "-DEPOCH_FUSED_CLUSTERS=1"})
    misses = []
    for n, m in CROSSOVER_SHAPES:
        Q, G, M = (t.cuda() for t in cases.random_problem(
            max(CROSSOVER_P), n, m, cs.SEED))
        for P in CROSSOVER_P:
            x = cases.swarm_inputs(Q[:P], G[:P], M[:P], cs.N, cs.K,
                                   seed=cs.SEED)
            for q in (True, False):
                kern = cases.kernel_pairs(Q[:P], G[:P], M[:P], x,
                                          quantized=q, gumbel_tau=0.0,
                                          elite_k=16)["epoch_fused"][0]
                kb._libs["epoch_fused"] = own
                rule = epoch_fused.path(P, cs.N, n, m, q)
                paths, outs = {}, {}
                for side, lib in libs.items():
                    kb._libs["epoch_fused"] = lib
                    paths[side] = epoch_fused.path(P, cs.N, n, m, q)
                    outs[side] = kern()
                rec = dict(kernel="epoch_fused", case="crossover", n=n, m=m,
                           P=P, N=cs.N, quantized=q, paths=paths, rule=rule,
                           same_bits=all(torch.equal(a, b) for a, b in zip(
                               outs["never"], outs["always"])))
                if paths["never"] != paths["always"]:
                    ms = {"never": [], "always": []}
                    for _ in range(args.rounds):
                        for side in ("never", "always", "always", "never"):
                            kb._libs["epoch_fused"] = libs[side]
                            ms[side].append(cs.cuda_ms(kern, reps=args.reps))
                    med = {k: statistics.median(v) for k, v in ms.items()}
                    picked = "always" if rule == paths["always"] else "never"
                    other = "never" if picked == "always" else "always"
                    rec.update(never_ms=ms["never"], always_ms=ms["always"],
                               never_median_ms=med["never"],
                               always_median_ms=med["always"],
                               ratio=med["always"] / med["never"],
                               rule_picks=picked)
                    if med[picked] > (1 + CROSSOVER_MARGIN) * med[other]:
                        misses.append([n, m, P, q])
                print(json.dumps(rec), flush=True)
            del x
            torch.cuda.empty_cache()
    kb._libs["epoch_fused"] = own
    print(json.dumps(dict(kernel="epoch_fused", case="crossover summary",
                          margin=CROSSOVER_MARGIN, rule_slower=misses)),
          flush=True)


def sass(tool: Path, lib: Path):
    """``{kernel function: SASS text}`` of a library, or None without
    ``cuobjdump``."""
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    # an anonymous namespace's mangled name carries a hash of its file,
    # and a second one after the file's stem (``<stem>_cu_<hash>``), which
    # can differ between two builds of one source
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    text = re.sub(r"(_cu)_[0-9a-f]{8}(?=\d)", r"\1", text)
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
    return {parts[i]: local_text(parts[i + 1])
            for i in range(1, len(parts), 2)}


def local_text(body: str) -> str:
    """A function's SASS as it compares between builds: runs of blanks as
    one (cuobjdump pads the columns to the widest line of the file) and
    the branch labels (``.L_x_<k>``, numbered across the file) numbered
    from 0 in the order they appear, so that a function compares equal
    when only the functions around it changed."""
    names = {}
    body = re.sub(r"[ \t]+", " ", body.strip())
    return re.sub(r"\.L_x_\d+",
                  lambda mt: names.setdefault(mt.group(0),
                                              f".L_x_{len(names)}"), body)


def c_entries(src: Path):
    """The ``extern "C"`` declarations of a CUDA source, whitespace
    normalised."""
    return {" ".join(d.split())
            for d in re.findall(r'extern "C"[^{;]*\)', src.read_text())}


def wrapper_differs(base: Path, stem: str) -> bool:
    """Whether the Python between a caller and the kernels of ``stem``
    (its wrapper module, the build and binding module) differs between
    the checkouts."""
    rel = Path("src") / "repro_torch" / "kernels"
    for f in (f"{stem}.py", "_build.py"):
        a, b = base / rel / f, ROOT / rel / f
        if not a.exists() or a.read_bytes() != b.read_bytes():
            return True
    return False


def modes(name):
    """(quantized) modes an entry is timed in."""
    return (True, False) if name == "epoch_fused" else (True,)


def extra_cases(name, d):
    """``{case: thunk}`` of an entry's calls beside phase 3 (``CASES``),
    through the wrapper of the side that runs them."""
    from repro_torch.kernels.prune_fixpoint import prune_fixpoint_cuda
    from repro_torch.kernels.pso_fitness import edge_fitness_cuda
    Q, G, M = d["Q"], d["G"], d["M"]
    if name == "edge_fitness_quantized":
        return {"tier0": lambda: edge_fitness_cuda(d["tier0"], Q, G,
                                                   quantized=True)}
    if name == "edge_fitness":
        tile = (d["tier0"] != 0).float()
        return {"tier0": lambda: edge_fitness_cuda(tile, Q, G)}
    if name == "prune_fixpoint":
        one = [t[1:2].contiguous() for t in (M, Q, G)]
        return {"p1": lambda: prune_fixpoint_cuda(*one)}
    return {}


def float_match(rounds):
    """chip_smoke's float ``match`` of unet through this side's package:
    its outcome (mapping, found, epochs_run, prune_sweeps) and the device
    time of ``rounds`` profiled calls."""
    import chip_smoke as cs
    from repro_torch.core import pso
    from repro_torch.core.matcher import IMMSchedMatcher
    reqs, tgt = cs.build_requests()[:2]
    unet = reqs[cs.WORKLOADS.index("unet")]

    # a side from before per-problem draw streams takes a generator; at
    # P = 1 it draws what the stream of the same seed draws
    kw = ({"stream": cs.SEED} if "stream" in inspect.signature(
        IMMSchedMatcher.match).parameters else {"generator": torch.Generator(
            device="cuda").manual_seed(cs.SEED)})

    def match():
        return IMMSchedMatcher(pso.PSOConfig()).match(unet["q"], tgt, **kw)
    r = match()
    mapping = torch.as_tensor(r.mapping if r.found else [])
    outcome = torch.tensor([r.found, r.epochs_run, r.prune_sweeps])
    return ((mapping, outcome),
            [sum(row[1] for row in cs.profiled(match)[2])
             for _ in range(rounds)])


def worker(side: Path, inputs: Path, names, out: Path, rounds, reps):
    """One side's run in its own process: that side's ``repro_torch``,
    its kernels built from its sources, the saved inputs."""
    sys.path.insert(0, str(side / "src"))
    from chip_smoke import cuda_ms, profiled
    from repro_torch.kernels import _build as kb, cases
    kb.build_all()
    d = torch.load(inputs, map_location="cuda")
    res, bits, dev = {}, {}, {}
    for name in names:
        for q in modes(name):
            pairs = cases.kernel_pairs(d["Q"], d["G"], d["M"], d["x"],
                                       quantized=q, gumbel_tau=0.0,
                                       elite_k=d["elite_k"])
            kern = pairs[name][0]
            calls = d["M"].shape[0] if name in cases.PER_PROBLEM else 1
            got = kern()
            got = got if isinstance(got, tuple) else (got,)
            # own storage each: torch.save refuses two dtypes viewing one
            bits[f"{name}/q={q}"] = tuple(
                t.clone() if isinstance(t, torch.Tensor) else t for t in got)
            res[f"{name}/q={q}"] = [cuda_ms(kern, reps) / calls
                                    for _ in range(rounds)]
            dev[f"{name}/q={q}"] = [device_ms(profiled, kern) / calls
                                    for _ in range(rounds)]
        for case, kern in extra_cases(name, d).items():
            got = kern()
            got = got if isinstance(got, tuple) else (got,)
            bits[f"{name}/{case}"] = tuple(t.clone() for t in got)
            res[f"{name}/{case}"] = [cuda_ms(kern, reps)
                                     for _ in range(rounds)]
            dev[f"{name}/{case}"] = [device_ms(profiled, kern)
                                     for _ in range(rounds)]
    bits[MATCH_KEY], res[MATCH_KEY] = float_match(rounds)
    torch.save(bits, str(out) + ".bits")
    out.write_text(json.dumps({"ms": res, "device_ms": dev}))


def worker_bucket(side: Path, inputs: Path, names, out: Path, rounds,
                  reps):
    """One side's ``--bucket`` run in its own process (see ``worker``):
    every entry of ``names`` on every saved case."""
    sys.path.insert(0, str(side / "src"))
    from chip_smoke import cuda_ms, profiled
    from repro_torch.kernels import _build as kb, cases
    kb.build_all()
    from repro_torch.kernels.pso_fitness import edge_fitness_cuda
    d = torch.load(inputs, map_location="cuda")
    crossover = d.pop("crossover")
    res, bits, dev, shape = {}, {}, {}, {}

    def run(key, kern, profile=True):
        got = kern()
        got = got if isinstance(got, tuple) else (got,)
        bits[key] = tuple(t.clone() if isinstance(t, torch.Tensor) else t
                          for t in got)
        res[key] = [cuda_ms(kern, reps) for _ in range(rounds)]
        if profile:
            dev[key] = [device_ms(profiled, kern) for _ in range(rounds)]

    for label, c in d.items():
        P, N = c["x"]["S"].shape[:2]
        for name in names:
            for q in modes(name):
                pairs = cases.kernel_pairs(c["Q"], c["G"], c["M"], c["x"],
                                           quantized=q, gumbel_tau=0.0,
                                           elite_k=c["elite_k"])
                key = f"{name}/q={q}/{label}"
                shape[key] = [P, N, *c["M"].shape[1:]]
                run(key, pairs[name][0])
            if "tier0" in c and name in FITNESS:
                for case, kern in extra_cases(name, c).items():
                    key = f"{name}/q=True/{label} {case}"
                    shape[key] = [P, 1, *c["M"].shape[1:]]
                    run(key, kern)
        torch.cuda.empty_cache()
    for (n, m), c in crossover.items():
        for P in CROSSOVER_P:
            for N in FITNESS_CROSSOVER_N:
                Q, G = c["Q"][:P], c["G"][:P]
                for name in FITNESS:
                    if name not in names:
                        continue
                    q = name == "edge_fitness_quantized"
                    S = c["S_q" if q else "S"][:P, :N].contiguous()
                    key = f"{name}/q=True/crossover {(P, N, n, m)}"
                    shape[key] = [P, N, n, m]
                    run(key, lambda: edge_fitness_cuda(S, Q, G, quantized=q),
                        profile=False)
        torch.cuda.empty_cache()
    torch.save(bits, str(out) + ".bits")
    out.write_text(json.dumps({"ms": res, "device_ms": dev, "shape": shape}))


def bucket_inputs(cs, cases, pso, ref):
    """``{case: problem}``: phase 4f's problems at ``WIDE_BUCKET`` and
    ``WINDOW_BUCKET`` (with their Tier-0 tiles) and phase 3's random
    problems at ``WIDE_CASES``; under ``"crossover"`` the fitness
    crossover's random problems by (n, m)."""
    elite_k = pso.elite_k_for(pso.PSOConfig(**cs.WIDE_SWARM))
    tgt, _, reqs = cs.wide_requests()
    name, Q, G, M, x = cs.wide_bucket_problem(tgt, reqs)
    out = {f"{name} {cs.WIDE_BUCKET}": dict(Q=Q, G=G, M=M, x=x,
                                           elite_k=elite_k)}
    name, Q, G, M, x = cs.window_bucket_problem()
    out[f"{name} {cs.WINDOW_BUCKET}"] = dict(Q=Q, G=G, M=M, x=x,
                                            elite_k=elite_k)
    for (n, m), (P, N) in cs.WIDE_CASES.items():
        Q, G, M = (t.cuda() for t in cases.random_problem(P, n, m, cs.SEED))
        out[f"random {(P, N, n, m)}"] = dict(
            Q=Q, G=G, M=M, elite_k=min(elite_k, N),
            x=cases.swarm_inputs(Q, G, M, N, cs.WIDE_K, seed=cs.SEED))
    # the Tier-0 call at the two buckets: N = 1 on the 0/255 tile of the
    # structured projection of S* (0/1 for the float body)
    for c in list(out.values())[:2]:
        c["tier0"] = ref.quantize_s(ref.structured_project(
            c["x"]["S_star"], c["Q"], c["G"], c["M"]).float()[:, None])
    # the fitness crossover's problems: the most problems and particles,
    # sliced per case
    P, N = max(CROSSOVER_P), max(FITNESS_CROSSOVER_N)
    out["crossover"] = {}
    for n, m in CROSSOVER_SHAPES:
        Q, G, M = (t.cuda() for t in cases.random_problem(P, n, m, cs.SEED))
        x = cases.swarm_inputs(Q, G, M, N, 1, seed=cs.SEED)
        out["crossover"][n, m] = dict(Q=Q, G=G, S=x["S"], S_q=x["S_q"])
    return out


def bucket(base: Path, args, cs, cases, pso, ref, identical):
    """``--bucket``: the five past 256, parent against change (see the
    module docstring)."""
    print(json.dumps({"sass": identical}), flush=True)
    names = cs.MAIN_KERNELS
    problems = bucket_inputs(cs, cases, pso, ref)
    ms, dev, bits, shapes = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs.pt"
        torch.save(problems, str(inputs))
        for slot, (side, root) in enumerate((("base", base),
                                             ("change", ROOT),
                                             ("change", ROOT),
                                             ("base", base))):
            out = Path(tmp) / f"{slot}.json"
            subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 str(root), "--bucket", "--inputs", str(inputs), "--names",
                 ",".join(names), "--out", str(out), "--rounds",
                 str(args.rounds), "--reps", str(args.reps)],
                check=True, env={**os.environ, "PYTHONPATH": ""})
            got = json.loads(out.read_text())
            shapes.update(got["shape"])
            for key, v in got["ms"].items():
                ms.setdefault(key, {"base": [], "change": []})[side] += v
            for key, v in got["device_ms"].items():
                dev.setdefault(key, {"base": [], "change": []})[side] += v
            got = torch.load(str(out) + ".bits", map_location="cpu")
            for key, v in got.items():
                bits.setdefault(key, {}).setdefault(side, []).append(v)
    from repro_torch.kernels import pso_fitness
    slower = {name: [] for name in FITNESS}
    for key, sides in ms.items():
        runs = bits[key]["base"] + bits[key]["change"]
        # each output equal across the four runs (S̄ is an output too)
        outs = [all(torch.equal(r[k], runs[0][k]) for r in runs)
                for k in range(len(runs[0]))
                if isinstance(runs[0][k], torch.Tensor)]
        name, mode, label = key.split("/", 2)
        q = mode == "q=True"
        inst = cs.instantiation(
            cs.FLOAT_EPOCH if name == "epoch_fused" and not q else name,
            *shapes[key])
        med = {k: statistics.median(v) for k, v in sides.items()}
        ratio = med["change"] / med["base"]
        if (label.startswith("crossover") and ratio > 1 + CROSSOVER_MARGIN
                and pso_fitness.path(*shapes[key],
                                     name == "edge_fitness_quantized") > 0):
            slower[name].append(shapes[key])
        print(json.dumps(dict(
            kernel=name, per_side=True, bucket=True,
            quantized=q if name == "epoch_fused" else None, case=label,
            instantiation=inst, same_bits=all(outs), same_outputs=outs,
            base_ms=sides["base"],
            change_ms=sides["change"], base_median_ms=med["base"],
            change_median_ms=med["change"], ratio=ratio,
            **device_fields(dev.get(key)))), flush=True)
    for name, cases_ in slower.items():
        print(json.dumps(dict(kernel=name, case="crossover summary",
                              margin=CROSSOVER_MARGIN,
                              row_split_slower=cases_)), flush=True)


def per_side(base: Path, names, inputs: Path, args, identical, sources):
    """Time ``names`` through each checkout's own wrapper (see the module
    docstring) and print one JSON line per entry and mode."""
    ms, dev, bits = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for slot, (side, root) in enumerate((("base", base),
                                             ("change", ROOT),
                                             ("change", ROOT),
                                             ("base", base))):
            out = Path(tmp) / f"{slot}.json"
            subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 str(root), "--inputs", str(inputs), "--names",
                 ",".join(names), "--out", str(out), "--rounds",
                 str(args.rounds), "--reps", str(args.reps)],
                check=True, env={**os.environ, "PYTHONPATH": ""})
            got = json.loads(out.read_text())
            for key, v in got["ms"].items():
                ms.setdefault(key, {"base": [], "change": []})[side] += v
            for key, v in got["device_ms"].items():
                dev.setdefault(key, {"base": [], "change": []})[side] += v
            got = torch.load(str(out) + ".bits", map_location="cpu")
            for key, v in got.items():
                bits.setdefault(key, {}).setdefault(side, []).append(v)
    for key, sides in ms.items():
        runs = bits[key]["base"] + bits[key]["change"]
        same = all(len(r) == len(runs[0]) and all(
            torch.equal(a, b) for a, b in zip(r, runs[0])
            if isinstance(a, torch.Tensor)) for r in runs)
        name, mode = key.split("/")
        med = {k: statistics.median(v) for k, v in sides.items()}
        print(json.dumps(dict(
            kernel=name, per_side=True,
            quantized=mode == "q=True" if name == "epoch_fused" else None,
            case=CASES.get(mode, "phase 3"),
            source=sources.get(name), same_bits=same,
            sass_identical=(identical.get(Path(sources[name]).stem)
                            if name in sources else None),
            base_ms=sides["base"], change_ms=sides["change"],
            base_median_ms=med["base"], change_median_ms=med["change"],
            ratio=med["change"] / med["base"],
            **device_fields(dev.get(key)))), flush=True)


def device_ms(profiled, kern):
    """Device time of one ``kern()`` under the profiler (kernels and
    copies), in ms."""
    return sum(row[1] for row in profiled(kern)[2])


def device_fields(dev):
    """The JSON fields of each side's device times: a host-bound entry's
    CUDA-event times measure its host, these its kernels."""
    if not dev:
        return {}
    med = {k: statistics.median(v) for k, v in dev.items()}
    return dict(base_device_ms=dev["base"], change_device_ms=dev["change"],
                base_device_median_ms=med["base"],
                change_device_median_ms=med["change"],
                device_ratio=med["change"] / med["base"])


def refine_floor(cs, Qb, Gb, Mb, x, args):
    """This checkout's ``ullmann_refine_step`` on phase 3's per-problem
    calls (the threshold candidates of each problem's 64 particles) beside
    an empty launch of the same grid and block, in turns; ms per call
    (CUDA events) and device ms per call (the profiler) of each."""
    from repro_torch.kernels import _build as kb
    from repro_torch.kernels.ullmann_refine import ullmann_refine_step_cuda
    P = Mb.shape[0]
    rowmax = x["S"].amax(-1, keepdim=True)
    cand = ((x["S"] >= 0.5 * rowmax) & (Mb[:, None] != 0)).to(torch.uint8)
    empty = kb.bind("ullmann_refine", "ullmann_refine_empty_launch",
                    [kb.I_, kb.P_])
    runs = {"entry": lambda: [ullmann_refine_step_cuda(cand[p], Qb[p], Gb[p])
                              for p in range(P)],
            "empty": lambda: [kb.check(empty(cand.shape[1], kb.stream()),
                                       "ullmann_refine_empty_launch")
                              for _ in range(P)]}
    ms = {k: [] for k in runs}
    dev = {k: [] for k in runs}
    for _ in range(args.rounds):
        for k in ("entry", "empty", "empty", "entry"):
            ms[k].append(cs.cuda_ms(runs[k], reps=args.reps) / P)
            dev[k].append(device_ms(cs.profiled, runs[k]) / P)
    fields = {}
    for k in runs:
        fields.update({f"{k}_ms": ms[k],
                       f"{k}_median_ms": statistics.median(ms[k]),
                       f"{k}_device_ms": dev[k],
                       f"{k}_device_median_ms": statistics.median(dev[k])})
    print(json.dumps(dict(kernel="ullmann_refine_step", case="empty launch",
                          **fields)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, nargs="?", help="the other checkout")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--bucket", action="store_true",
                    help="time the five past 256 at phase 4f's bucket and "
                         "phase 3's wide cases")
    ap.add_argument("--crossover", action="store_true",
                    help="time epoch_fused's step off and on clusters "
                         "past 256 (no BASE_DIR)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--names", help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.worker is not None:
        run = worker_bucket if args.bucket else worker
        run(args.worker.resolve(), args.inputs, args.names.split(","),
            args.out, args.rounds, args.reps)
        return 0
    if args.base is None and not args.crossover:
        ap.error("BASE_DIR is required")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import pso
    from repro_torch.kernels import _build as kb, cases, ref

    if args.crossover:
        print(cs.card_line(), flush=True)
        crossover(args, cs, cases, kb)
        return 0

    base = args.base.resolve()
    stems = sorted({Path(src).stem for src, _ in cs.KERNELS.values()
                    if (base / src).exists()})
    changed = {n for n in stems
               if c_entries(base / "src" / "repro_torch" / "csrc" / f"{n}.cu")
               != c_entries(kb.CSRC / f"{n}.cu")}
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

    if args.bucket:
        bucket(base, args, cs, cases, pso, ref, identical)
        return 0
    _, _, _, Qb, Gb, Mb = cs.build_requests()
    x = cases.swarm_inputs(Qb, Gb, Mb, cs.N, cs.K, seed=cs.SEED)
    elite_k = pso.elite_k_for(pso.PSOConfig())
    pairs = cases.kernel_pairs(Qb, Gb, Mb, x, quantized=True, gumbel_tau=0.0,
                               elite_k=elite_k)
    # a source new in this checkout (a body moved to a file of its own) is
    # timed per side, without a SASS comparison
    sided = [name for name, (src, _) in cs.KERNELS.items()
             if Path(src).stem not in stems or Path(src).stem in changed
             or wrapper_differs(base, Path(src).stem)]
    if sided:
        with tempfile.TemporaryDirectory() as tmp:
            inputs = Path(tmp) / "inputs.pt"
            # the Tier-0 check's fitness input (core/pso.py,
            # revalidate_carry): the structured projection of S* as a
            # 0/255 tile
            tier0 = ref.quantize_s(ref.structured_project(
                x["S_star"], Qb, Gb, Mb).float()[:, None])
            torch.save(dict(Q=Qb, G=Gb, M=Mb, x=x, elite_k=elite_k,
                            tier0=tier0), str(inputs))
            per_side(base, sided, inputs, args, identical,
                     {k: src for k, (src, _) in cs.KERNELS.items()})
    for name, (src, _) in cs.KERNELS.items():
        stem = Path(src).stem
        if stem not in stems or stem in changed:
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
        dev = {"base": [], "change": []}
        for _ in range(args.rounds):
            for side in ("base", "change", "change", "base"):
                kb._libs[stem] = libs[side][stem]
                ms[side].append(cs.cuda_ms(kern, reps=args.reps) / calls)
                dev[side].append(device_ms(cs.profiled, kern) / calls)
        kb._libs[stem] = libs["change"][stem]
        med = {k: statistics.median(v) for k, v in ms.items()}
        print(json.dumps(dict(
            kernel=name, per_side=False, source=src, same_bits=same,
            sass_identical=identical[stem], base_ms=ms["base"],
            change_ms=ms["change"], base_median_ms=med["base"],
            change_median_ms=med["change"],
            ratio=med["change"] / med["base"], **device_fields(dev))),
            flush=True)
    refine_floor(cs, Qb, Gb, Mb, x, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
