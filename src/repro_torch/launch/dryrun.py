"""Multi-pod dry run: every (arch × shape × mesh) cell's step, run to its
end on ``meta`` tensors as rank 0 of a fake process group.

Counterpart of the JAX package's ``launch/dryrun.py``, with its CLI and,
where they mean the same thing, its names and JSON keys. Where the
reference lowers and compiles each cell's jitted step with abstract
inputs, the port has no compiler to ask: it lays the model, its training
state or its caches and the batch out on the production mesh as
tensors on ``meta`` (shapes and dtypes, nothing allocated), and runs the
cell's sharded train, prefill or decode step (backward pass and
optimizer update included) to its end, under a default group of the
fake backend (``launch.mesh.fake_group``) in which this process is rank
0 of 256 (16 × 16) or 512 (2 × 16 × 16). Each cell gives, with no
device allocation:

  * ``ok``: the step ran to its end (the layout is coherent: the
    reference's proof is that ``lower().compile()`` succeeds);
  * ``memory``: ``argument_bytes`` (the state, caches and batch a rank
    holds, from the local shapes), ``output_bytes`` (what the step
    returns, each storage once), ``peak_bytes`` (the peak of live
    tensor bytes during the step: each new storage counted from the op
    that makes it until it is freed; no allocator slack, no
    fragmentation; the caches' global shapes, which the program makes
    on ``meta`` on any device, not counted), ``temp_bytes`` = peak − arguments, and
    ``fits_h100_80gb`` (peak ≤ 80 GiB). The reference's
    ``generated_code_bytes`` and ``alias_bytes`` have no counterpart;
  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count
    for this rank, forward and backward. It counts matrix products and
    convolutions only, where XLA's ``cost_analysis`` (the reference's
    ``hlo_flops``) counts elementwise work too. ``model_flops`` is the
    reference's 6·N·D / 2·N·D with N from the port's parameters;
  * ``collectives``: the reference's ``{"bytes", "counts",
    "total_bytes"}``, from the tally of every collective this rank made
    (``launch.mesh.collectives``) with the reference's ring wire
    formulas, and the port's own counters beside them, read from the
    same tally (``calls``, ``gathered``, ``reduced``, ``cache_gathered``,
    ``mesh_ctx.traffic``'s definitions);
  * ``wall_s``: the host's seconds for the cell.

The matcher cell (``--matcher``, or ``--arch immsched-matcher``) runs
rank 0's share of ``core.matcher.build_distributed_match`` at the
reference's settings (128 × 128, ``PSOConfig(32, 4, 12,
quantized=True)``, the swarm sharded over all of the mesh's axes) for
real, on ``--device`` (the card by default): the matcher reads values
to the host (the prune fixpoint, the early exit), so it cannot run on
``meta``. Under the fake group every gathered slot holds rank 0's own
share, so the cell counts collectives, kernel launches and bytes and
makes no claim about the match; ``run_matcher(outputs=True)`` hands its
output leaves back, so that a caller can hold two suites' runs of it
against each other.

``probe_config`` and ``run_probe`` (``--probes``) run the reference's
reduced-depth probes (k = 2, 3; 5 for the hybrid); each probe records
``pattern_counts``, the full config's pattern units, to scale it by.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
      --matcher --device cpu --out dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import sys
import time
import traceback
import weakref
from typing import Dict, List

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ARCHS, arch_shapes, get_config,
                                 get_train_config, input_specs,
                                 parallelism_profile)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build_model
from repro_torch.runtime import mesh_ctx
from repro_torch.runtime import shard as shard_lib
from repro_torch.runtime.serve_loop import (jit_decode_step,
                                            make_prefill_step)
from repro_torch.runtime.train_loop import make_train_state, make_train_step

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: an H100's memory
H100_BYTES = 80 * 2 ** 30

#: the production meshes: name, multi_pod
MESHES = {"single": ("pod-16x16", False), "multi": ("2pods-2x16x16", True)}

MATCHER = "immsched-matcher"


def collective_bytes(tally: mesh_lib.Collectives) -> dict:
    """Per-rank *wire bytes* of the tallied collectives, by the
    reference's ring formulas on the result bytes R and the group size
    g: all-gather (g−1)/g·R, all-reduce 2(g−1)/g·R, reduce-scatter
    (g−1)·R, all-to-all (g−1)/g·R, collective-permute R. The port makes
    no reduce-scatter, all-to-all or permute (its reduce-scatter is an
    all-reduce a slice), and a barrier moves nothing."""
    out = {k: 0.0 for k in _COLLECTIVES}
    count = {k: 0 for k in _COLLECTIVES}
    for c, calls in tally.calls.items():
        if c.kind not in out:
            continue
        g = max(c.group_size, 1)
        if c.kind in ("all-gather", "all-to-all"):
            wire = c.nbytes * (g - 1) / g
        elif c.kind == "reduce-scatter":
            wire = c.nbytes * (g - 1)
        elif c.kind == "all-reduce":
            wire = c.nbytes * 2 * (g - 1) / g
        else:
            wire = c.nbytes
        out[c.kind] += wire * calls
        count[c.kind] += calls
    return {"bytes": {k: int(v) for k, v in out.items()}, "counts": count,
            "total_bytes": int(sum(out.values()))}


def _meta_model(cfg):
    return build_model(cfg, device="meta", generator=torch.Generator())


@functools.lru_cache(maxsize=None)
def param_count(arch: str) -> int:
    """The port's parameter count of ``arch`` (built on ``meta``)."""
    return sum(p.numel()
               for p in _meta_model(get_config(arch)).parameters())


def model_flops(arch: str, shape: ShapeConfig) -> float:
    """The reference's 6·N_active·D (train) / 2·N_active·D (inference),
    D = tokens, N from the port's parameters (``param_count``)."""
    cfg = get_config(arch)
    total = param_count(arch)
    active = total
    if cfg.moe is not None:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.expert_d_ff
        routed_all = cfg.num_layers * m.num_experts * per_expert
        routed_active = cfg.num_layers * m.top_k * per_expert
        active = total - routed_all + routed_active
    if shape.mode == "train":
        return 6.0 * active * shape.seq_len * shape.global_batch
    if shape.mode == "prefill":
        return 2.0 * active * shape.seq_len * shape.global_batch
    return 2.0 * active * shape.global_batch      # decode: 1 new token


def probe_config(arch: str, k: int):
    """The reference's reduced-depth config of k pattern units: 1 layer
    (dense/moe/vlm; deepseek keeps its dense block0), 1 encoder + 1
    decoder layer (encdec), ``slstm_period`` layers (xlstm),
    ``shared_attn_period`` layers (zamba2); k = 5 gives zamba2 two groups
    and one trailing Mamba2 layer."""
    cfg = get_config(arch)
    if cfg.family in ("dense", "moe", "vlm"):
        first = 1 if cfg.name.startswith("deepseek") else 0
        return cfg.replace(num_layers=first + k, unroll=True)
    if cfg.family in ("encdec", "audio"):
        return cfg.replace(num_layers=k, encoder_layers=k, unroll=True)
    if cfg.family == "ssm":
        return cfg.replace(num_layers=k * cfg.ssm.slstm_period, unroll=True)
    if cfg.family == "hybrid":
        period = cfg.ssm.shared_attn_period
        n = k * period if k <= 4 else 2 * period + 1
        return cfg.replace(num_layers=n, unroll=True)
    raise ValueError(cfg.family)


def pattern_counts(arch: str) -> dict:
    """How many pattern units the full config has (for probe scaling)."""
    cfg = get_config(arch)
    if cfg.family in ("dense", "moe", "vlm"):
        first = 1 if cfg.name.startswith("deepseek") else 0
        return {"units": cfg.num_layers - first, "tail": 0}
    if cfg.family in ("encdec", "audio"):
        assert cfg.num_layers == cfg.encoder_layers
        return {"units": cfg.num_layers, "tail": 0}
    if cfg.family == "ssm":
        return {"units": cfg.num_layers // cfg.ssm.slstm_period, "tail": 0}
    if cfg.family == "hybrid":
        period = cfg.ssm.shared_attn_period
        return {"units": cfg.num_layers // period,
                "tail": cfg.num_layers % period}
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# what a step holds: bytes of a tree, live bytes during a step
# ---------------------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def tree_bytes(*trees) -> int:
    """Bytes of the storages under ``trees``, each storage once."""
    seen = {}
    for t in (t for tree in trees for t in _tensors(tree)):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


class StepRecorder(TorchDispatchMode):
    """What a step does, op by op, while the mode is on:

      * ``peak``: the most bytes at once of the storages that ops make,
        each from the op that makes it until it is freed (a storage's
        finalizer); storages of ``held`` (the step's arguments) are not
        counted. No allocator slack: a caching allocator's rounding and
        fragmentation come on top;
      * ``flops``: ``torch.utils.flop_counter``'s formulas (matrix
        products, convolutions, attention; ``FlopCounterMode``'s count
        without its module bookkeeping, one Python mode an op less);
      * ``memo``: an op that makes one new tensor (no view, nothing
        written in place) from tensors all on ``meta`` runs its meta
        function once for each distinct (op, the inputs' shapes,
        strides and dtypes, the other arguments); unless that call
        handed back an input's storage, a repeat returns an empty
        ``meta`` tensor of the shape, strides and dtype that the
        first call gave. Many meta functions are Python, which makes a
        loop over 32,768 time steps take hours, and a loop repeats the
        same keys. It changes
        no shape, dtype, byte count, flop or collective: the records
        with and without it are equal (``tests/test_torch_dryrun.py``).
    """

    def __init__(self, held=(), memo: bool = True):
        super().__init__()
        self._held = {t.untyped_storage()._cdata for t in _tensors(held)}
        self._sizes: Dict[int, int] = {}
        self._memo: Dict = {} if memo else None
        self.live = self.peak = 0
        self.flops = 0
        self._atomic = set()            # ops that do not decompose
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        """Ops run but are not counted: tensors the program makes on
        ``meta`` by design (shapes, not bytes)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self._atomic and \
                func is not torch.ops.prim.device.default:
            with self:                      # as FlopCounterMode counts
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            self._atomic.add(func)
        key = None if self._memo is None else _memo_key(func, args, kwargs)
        hit = None if key is None else self._memo.get(key)
        if hit:
            out = torch.empty_strided(hit[0], hit[1], dtype=hit[2],
                                      device="meta")
        else:
            out = func(*args, **kwargs)
            if key is not None:
                # an op that hands back an input's storage
                # (``_unsafe_view``) is never memoised
                shared = not isinstance(out, torch.Tensor) or any(
                    isinstance(a, torch.Tensor) and
                    a.untyped_storage()._cdata ==
                    out.untyped_storage()._cdata
                    for a in _leaves(args, kwargs))
                self._memo[key] = False if shared else (
                    tuple(out.shape), out.stride(), out.dtype)
        if self._paused:
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if isinstance(out, torch.Tensor):
            self._track(out)
        else:
            for t in pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._held or key in self._sizes:
            return
        n = s.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)


_SCALARS = (bool, int, float, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _leaves(args, kwargs):
    """The arguments of an op call, lists and tuples flattened."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, (list, tuple)):
            yield from a
        else:
            yield a


def _memo_key(func, args, kwargs):
    """``StepRecorder``'s memo key of an op call, or None where the op
    views or writes, or a tensor is not on ``meta``."""
    schema = func._schema
    if schema.is_mutable or len(schema.returns) != 1 or \
            schema.returns[0].alias_info is not None or \
            str(schema.returns[0].type) != "Tensor":
        return None
    key, n = [func, len(args), tuple(kwargs)], 0
    for a in _leaves(args, kwargs):
        if isinstance(a, torch.Tensor):
            if not a.is_meta:
                return None
            n += 1
            key.append((tuple(a.shape), a.stride(), a.dtype))
        elif isinstance(a, _SCALARS):
            key.append((type(a), a))
        else:
            return None
    return tuple(key) if n else None


def _measured(fn, held, fast: bool = True, model=None):
    """``fn()`` under a ``StepRecorder`` (``fast``: with its memo), the
    collectives' tally cleared before it: (its output, the recorder).
    ``model``'s ``cache_shapes`` (the caches' global shapes, on ``meta``
    on any device) runs uncounted."""
    mesh_lib.collectives.reset()
    rec = StepRecorder(held, memo=fast)
    if model is not None:
        shapes = model.cache_shapes

        def cache_shapes(*a, **kw):
            with rec.paused():
                return shapes(*a, **kw)
        model.cache_shapes = cache_shapes
    gc.collect()
    # a storage that only the cyclic collector would free counts as live
    # until the step ends: a collection's timing varies from run to run,
    # and so would the peak
    gc.disable()
    try:
        with rec:
            out = fn()
    finally:
        gc.enable()
        if model is not None:
            del model.cache_shapes
    return out, rec


def _collectives() -> dict:
    """The step's collectives, from ``launch.mesh.collectives``."""
    out = collective_bytes(mesh_lib.collectives)
    t = mesh_ctx.traffic
    out.update(calls=mesh_lib.collectives.count, gathered=t.gathered,
               reduced=t.reduced, cache_gathered=t.cache_gathered)
    return out


def _memory(argument_bytes: int, output_bytes: int,
            live: StepRecorder) -> dict:
    peak = argument_bytes + live.peak
    return {"argument_bytes": argument_bytes, "output_bytes": output_bytes,
            "peak_bytes": peak, "temp_bytes": peak - argument_bytes,
            "fits_h100_80gb": peak <= H100_BYTES}


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def run_step_abstract(arch: str, shape: ShapeConfig, mesh, cfg=None,
                      tcfg=None, batch_override: int = 0,
                      microbatch_override: int = 0,
                      fast: bool = True) -> dict:
    """Build the cell's model on ``meta``, lay it out on ``mesh`` (a
    ``DeviceMesh`` of the initialised group) and run its sharded train,
    prefill or decode step to its end (``fast``: with
    ``StepRecorder``'s memo). Returns ``{"memory", "flops", "collectives",
    "params_bytes", "profile", "microbatches"}``."""
    cfg = cfg or get_config(arch)
    B = batch_override or shape.global_batch
    profile = parallelism_profile(arch, shape.name)
    model = shard_lib.shard_model(_meta_model(cfg), mesh, profile)
    batch = shard_lib.shard_batch(
        input_specs(arch, shape, abstract=True, batch_override=B), mesh,
        profile)
    rec = {"profile": profile, "params_bytes": tree_bytes(model)}
    if shape.mode == "train":
        tcfg = tcfg or get_train_config(arch)
        if profile == "fsdp_only":
            # the batch shards over every axis: no microbatch split
            microbatch_override = 1
        if microbatch_override:
            tcfg = dataclasses.replace(tcfg,
                                       microbatches=microbatch_override)
        rec["microbatches"] = tcfg.microbatches
        state = make_train_state(model, tcfg)
        step = make_train_step(model, tcfg, mesh, profile)
        held = (state, batch)
        out, live = _measured(lambda: step(state, batch), held, fast)
        args = tree_bytes(*held)
        new_state, metrics = out
        outs = tree_bytes(new_state, metrics)
    elif shape.mode == "prefill":
        step = make_prefill_step(model, mesh, max_len=shape.seq_len,
                                 profile=profile)
        held = (model, batch)
        out, live = _measured(lambda: step(batch), held, fast, model)
        args = tree_bytes(*held)
        outs = tree_bytes(out)
    else:
        caches = model.init_caches(B, shape.seq_len)
        step = jit_decode_step(model, mesh, caches, batch.specs, profile)
        held = (model, batch, caches)
        out, live = _measured(
            lambda: step(batch, caches, shape.seq_len - 1), held, fast,
            model)
        args = tree_bytes(*held)
        outs = tree_bytes(out)
    rec.update(memory=_memory(args, outs, live), flops=float(live.flops),
               collectives=_collectives())
    return rec


def kernel_counters():
    """Every kernel wrapper's launch counter."""
    from repro_torch.kernels import (argmax_project, epoch_fused,
                                     finish_fused, prune_fixpoint,
                                     pso_fitness, pso_update,
                                     ullmann_refine)
    return [prune_fixpoint.launches, pso_fitness.launches,
            pso_fitness.launches_quantized, epoch_fused.launches,
            epoch_fused.launches_float, finish_fused.launches,
            pso_update.launches, ullmann_refine.launches,
            argmax_project.launches_greedy, argmax_project.launches_argmax]


def _planted_problem(n: int, m: int, seed: int = 0):
    from repro_torch.core import graphs
    rng = np.random.default_rng(seed)
    q = graphs.random_dag(rng, n, 0.05)
    return q, graphs.embed_query_in_target(rng, q, m)


def run_matcher(mesh, device="cuda", n: int = 128, m: int = 128,
                cfg=None, seed: int = 0, outputs: bool = False) -> dict:
    """Rank 0's share of the distributed matcher on ``mesh`` at the
    reference's settings, run for real on ``device`` over a planted
    ``n`` × ``m`` problem (``seed``), the swarm sharded over all of the
    mesh's axes. Returns ``{"memory", "flops", "collectives",
    "launches", "epochs_run", "shards", "mappings_shape"}``, and with
    ``outputs`` the match's output leaves under ``"outputs"``."""
    from repro_torch.core import pso
    from repro_torch.core.graphs import (as_device_graphs,
                                         topological_relabel)
    from repro_torch.core.matcher import (build_distributed_match,
                                          shard_streams)
    cfg = cfg or pso.PSOConfig(num_particles=32, epochs=4, inner_steps=12,
                               quantized=True)
    axis_names = tuple(mesh.mesh_dim_names)
    shards = math.prod(mesh.mesh.shape)
    q, g = _planted_problem(n, m, seed)
    q, _ = topological_relabel(q)
    Q, G, mask = as_device_graphs(q, g, device=device)
    fn = build_distributed_match(Q.shape, mesh, cfg, axis_names)
    streams = shard_streams(seed, shards)
    counters = kernel_counters()
    for c in counters:
        c.reset()
    held = (Q, G, mask)
    out, live = _measured(lambda: fn(streams, Q, G, mask), held)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    args = tree_bytes(*held)
    return {"memory": _memory(args, tree_bytes(out), live),
            "flops": float(live.flops), "collectives": _collectives(),
            "launches": {c.name: c.count for c in counters},
            "epochs_run": int(out["epochs_run"]), "shards": shards,
            "mappings_shape": list(out["mappings"].shape),
            **({"outputs": out} if outputs else {})}


def run_probe(arch: str, shape: ShapeConfig, mesh, mesh_name: str,
              k: int) -> dict:
    """The reference's reduced-depth probe: the cell at k pattern units
    (``probe_config``), its microbatch as the batch."""
    t0 = time.time()
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "probe": k, "ok": False}
    try:
        tcfg = get_train_config(arch) if shape.mode == "train" else None
        B, mb = shape.global_batch, 0
        if shape.mode == "train" and tcfg.microbatches > 1 and \
                parallelism_profile(arch, shape.name) != "fsdp_only":
            B = shape.global_batch // tcfg.microbatches
            mb = 1
        out = run_step_abstract(arch, shape, mesh, cfg=probe_config(arch, k),
                                batch_override=B, microbatch_override=mb)
        rec.update(flops=out["flops"], collectives=out["collectives"],
                   memory=out["memory"], probe_batch=B,
                   pattern_counts=pattern_counts(arch),
                   microbatches_full=(
                       1 if (tcfg is None or parallelism_profile(
                           arch, shape.name) == "fsdp_only")
                       else tcfg.microbatches))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — a failed probe is a report
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 3)
    return rec


def run_cell(arch: str, shape, mesh, mesh_name: str, matcher_mesh=None,
             device="cuda") -> dict:
    """One cell's record; ``arch`` ``"immsched-matcher"`` runs
    ``run_matcher`` on ``matcher_mesh`` (a mesh on ``device``)."""
    t0 = time.time()
    rec = {"arch": arch, "shape": getattr(shape, "name", shape),
           "mesh": mesh_name, "ok": False}
    try:
        if arch == MATCHER:
            rec.update(run_matcher(matcher_mesh, device))
            rec["model_flops"] = 0.0
        else:
            rec.update(run_step_abstract(arch, shape, mesh))
            rec["model_flops"] = model_flops(arch, shape)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug report
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 3)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help=f"arch id, 'all', or '{MATCHER}'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="")
    ap.add_argument("--matcher", action="store_true",
                    help="include the distributed-matcher cell")
    ap.add_argument("--probes", action="store_true",
                    help="also run the reduced-depth probes (single-pod "
                         "mesh)")
    ap.add_argument("--device", default="cuda",
                    help="the matcher cell's device")
    args = ap.parse_args(argv)
    if args.matcher or args.arch in ("all", MATCHER):
        if torch.device(args.device).type == "cuda" and \
                not torch.cuda.is_available():
            raise SystemExit("the matcher cell runs on the card: no CUDA "
                             "device (pass --device cpu)")

    names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCHS if args.arch == "all" else [args.arch]
    results = []
    for key in names:
        mesh_name, multi_pod = MESHES[key]
        with mesh_lib.fake_group(512 if multi_pod else 256):
            mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                 device="cpu")
            cells = []
            for arch in archs:
                if arch == MATCHER:
                    continue
                shapes = arch_shapes(arch)
                if args.shape != "all":
                    shapes = [s for s in shapes if s.name == args.shape]
                cells += [(arch, s) for s in shapes]
            if args.arch in ("all", MATCHER) or args.matcher:
                cells.append((MATCHER, "matcher_128x128"))
            for arch, shape in cells:
                mm = None
                if arch == MATCHER:
                    mm = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                       device=args.device)
                rec = run_cell(arch, shape, mesh, mesh_name, mm,
                               args.device)
                results.append(rec)
                _report(rec)
                if args.probes and key == "single" and arch != MATCHER:
                    ks = [2, 3] + ([5] if get_config(arch).family
                                   == "hybrid" else [])
                    for k in ks:
                        prec = run_probe(arch, shape, mesh, mesh_name, k)
                        results.append(prec)
                        _report_probe(prec)

    cells = [r for r in results if "probe" not in r]
    n_ok = sum(r["ok"] for r in cells)
    probe_fail = sum(1 for r in results if "probe" in r and not r["ok"])
    results = cells + [r for r in results if "probe" in r]
    print(f"\nDRYRUN {n_ok}/{len(cells)} cells OK"
          + (f" ({probe_fail} probe failures)" if probe_fail else ""))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 0 if n_ok == len(cells) and not probe_fail else 1


def _report_probe(rec: dict) -> None:
    if rec["ok"]:
        print(f"  [probe k={rec['probe']}] {rec['arch']} {rec['shape']} "
              f"flops={rec['flops']:.3e} "
              f"coll={rec['collectives']['total_bytes']:.3e} "
              f"({rec['wall_s']}s)")
    else:
        print(f"  [probe k={rec['probe']} FAIL] {rec['arch']} "
              f"{rec['shape']} {rec.get('error', '')[:140]}")
    sys.stdout.flush()


def _report(rec: dict) -> None:
    if rec["ok"]:
        mem = rec["memory"]
        print(f"[OK ] {rec['mesh']:14s} {rec['arch']:20s} "
              f"{str(rec['shape']):16s} flops={rec['flops']:.3e} "
              f"coll={rec['collectives']['total_bytes']:.3e} "
              f"args={mem['argument_bytes']:.3e} "
              f"peak={mem['peak_bytes']:.3e} ({rec['wall_s']}s)")
    else:
        print(f"[FAIL] {rec['mesh']:14s} {rec['arch']:20s} "
              f"{str(rec['shape']):16s} {rec.get('error', '')[:160]}")
    sys.stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
