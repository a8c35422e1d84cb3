"""The recurrent and encoder-decoder families on a mesh (``models.ssm``'s
Mamba2, mLSTM and sLSTM blocks, the hybrid's shared attention and the
encoder-decoder under ``runtime.shard``): the sharded train and serve
steps on gloo worlds of CPU processes, against the port's one-device
steps and against the JAX package's sharded step.

Each world runs once (a module fixture: ``_worlds.run_in_turn`` runs
the reference's process, then each world, one after another);
every rank builds the same tiny model from a seed (``tiny_config``:
d_model 64, 4 heads; xlstm-1.3b's 4 layers in groups of an mLSTM and an
sLSTM block, zamba2-7b's 5 in two groups of 2 Mamba2 blocks and the
shared attention and a tail, seamless-m4t-medium's 2 + 2; float32). The
norm scales, ``A_log``, ``D``, ``dt_bias``, ``if_bias`` and the sLSTM's
``bias`` are perturbed from their init, which is the same for every
head: a gradient that misses the sum over the model axis of a
replicated vector that each rank reads in its own heads would go
unseen at init. Each rank runs the one-device step on the whole batch
and the sharded step on its rows, and writes what it measured:

* train, (2, 2) "2d" (Mamba2's and the mLSTM's heads 2 a model rank,
  the sLSTM's heads cut, d over the data axis) for the three configs,
  (1, 4) "2d" for xlstm at 2 heads (the mLSTM state cut on Dk, the
  sLSTM's ``w_in`` and ``r`` replicated over the model axis) and (4, 1)
  "fsdp_only" for zamba2: AdamW and Adafactor, two microbatches, two
  steps (the first at lr 0), labels −1 on most of the first rows'
  positions. Held at ``tests/test_torch_shard_moe.py``'s float32
  criteria: loss and grad norm within 1e-5 relative; every gradient
  leaf within 1e-4 of its largest |g| (+1e-6), as this rank's slice of
  the one-device accumulator; every parameter after the steps within
  2e-6, or within 2·lr on at most 1e-3 of the elements (Adam's sign
  flips), whole and as this rank's slice; the optimizer state as the
  slice of the one-device state; the resident parameters, optimizer
  state and accumulators exactly the slices' bytes.
* serve, (2, 2) for the three configs and (1, 4) for the 2-head xlstm:
  prefill and 8 greedy decode steps with float32 caches; every step's
  logits within 2e-4 of the one device's slice, equal tokens, and every
  cache leaf (Mamba2's and the mLSTM's ``state`` and ``conv``, the
  sLSTM's ``c``/``n``/``h``/``m``, the shared attention's and the
  decoder's ``k``/``v``, the encoder's ``memory``) the ``_mesh_slice``
  of the one-device cache in shape and within 2e-4 in value.
* the JAX package's sharded step on an Auto-axis (4, 2) mesh (8 fake CPU
  devices, in its own process) at ``tests/test_smoke_archs.py``'s
  ``reduce_config`` of each of the three configs, fed the same weights
  and batch as the port's step on a (4, 2) world: loss within rtol 2e-4
  and every parameter within 3e-4 after each of two steps
  (``tests/test_sharding.py``'s tolerances).
"""
import json
import os
import pathlib
import sys
import textwrap

import numpy as np
import pytest

from _worlds import run_in_turn

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: each call's seconds alone on an 8-core CPU, rounded up (``_worlds``)
ALONE_S = {"reference": 71, 4: 16, 8: 19}
METRIC_RTOL = 1e-5
STEP_TOL = 2e-6
LR = 1e-3
SERVE_TOL = 2e-4
REF_LOSS_RTOL, REF_PARAM_ATOL = 2e-4, 3e-4
B, S = 8, 16
ARCHS = ("xlstm-1.3b", "zamba2-7b", "seamless-m4t-medium")
SHORT = {"xlstm-1.3b": "xlstm", "zamba2-7b": "zamba2",
         "seamless-m4t-medium": "seamless"}

#: (name, mesh, profile, arch, optimizer, heads (None: the config's))
TRAIN_CASES = [
    *[(f"2x2-{SHORT[a]}-{o}", (2, 2), "2d", a, o, None)
      for a in ARCHS for o in ("adamw", "adafactor")],
    ("1x4-xlstm-2heads", (1, 4), "2d", "xlstm-1.3b", "adamw", 2),
    ("4x1-fsdp_only-zamba2", (4, 1), "fsdp_only", "zamba2-7b", "adafactor",
     None),
]
#: (name, mesh, arch, heads)
SERVE_CASES = [*[(f"serve-{SHORT[a]}", (2, 2), a, None) for a in ARCHS],
               ("serve-1x4-xlstm-2heads", (1, 4), "xlstm-1.3b", 2)]
#: the cache leaves each config's serve must hold, and their specs on
#: (2, 2) past a stack's leading layer axes (which no rule cuts)
CACHE_SPECS = {
    "xlstm-1.3b": {"state": ["data", "model", None, None],
                   "conv": ["data", None, "model"],
                   **{k: ["data", None, None] for k in "cnhm"}},
    "zamba2-7b": {"state": ["data", "model", None, None],
                  "conv": ["data", None, "model"],
                  "k": ["data", None, "model", None],
                  "v": ["data", None, "model", None]},
    "seamless-m4t-medium": {"k": ["data", None, "model", None],
                            "v": ["data", None, "model", None],
                            "memory": ["data", None, None]},
}

WORKER = r'''
import json, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.checkpoint.manager import _mesh_slice
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import prompt_batch
from repro_torch.launch.train import tiny_config
from repro_torch.models import model as tmodel
from repro_torch.runtime import serve_loop as sl, shard, sharding as shd
from repro_torch.runtime import train_loop as tl

rank, world, store, spec_file, out_dir = (int(sys.argv[1]),
                                          int(sys.argv[2]), *sys.argv[3:6])
work = json.load(open(spec_file))
torch.manual_seed(0)
mesh_lib.init_group("gloo", init_method="file://" + store, rank=rank,
                    world_size=world, device="cpu", timeout_s=120)
meshes = {}
#: replicated vectors a rank reads in its own heads, perturbed from the
#: init that is the same for every head
PERTURB = ("scale", "A_log", "D", "dt_bias", "if_bias", "bias")

def get_mesh(shape):
    if tuple(shape) not in meshes:
        meshes[tuple(shape)] = mesh_lib.make_host_mesh(
            *shape, backend="gloo", device="cpu")
    return meshes[tuple(shape)]

def config(arch, heads=None):
    cfg = tiny_config(get_config(arch))
    if heads is not None:
        cfg = cfg.replace(num_heads=heads, kv_heads=heads)
    return cfg

def weights(cfg, seed):
    tree = tmodel.params_to_numpy(tmodel.build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in PERTURB:
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
    perturb(tree)
    return tree

def model_of(cfg, tree):
    return tmodel.params_from_numpy(tmodel.build_model(cfg, device="cpu"),
                                    tree)

def make_batch(cfg, seed, rows, seq):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (rows, seq)),
           "labels": rng.integers(0, cfg.vocab_size, (rows, seq))}
    out["labels"][rng.random((rows, seq)) < 0.2] = -1
    out["labels"][:rows // 4 + 1, 2:] = -1     # uneven over data slices
    out = {k: v.astype(np.int32) for k, v in out.items()}
    if cfg.family in ("encdec", "audio"):
        out["frames"] = rng.standard_normal(
            (rows, seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}

def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree

def param_errs(got, want, tol):
    within = past = total = 0
    worst = 0.0
    for (p, a), (q, b) in zip(flat(got), flat(want)):
        assert p == q, (p, q)
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        past += int((d > tol).sum())
        total += d.size
        worst = max(worst, float(d.max()))
        within = max(within, float(np.where(d > tol, 0, d).max()))
    return within, past, total, worst

def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()

def cut(t, spec, mesh):
    return torch.from_numpy(_mesh_slice(t.detach().float().numpy(), mesh,
                                        spec))

def train_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = config(c["arch"], c["heads"])
    tree = weights(cfg, 11)
    batch = make_batch(cfg, 12, c["rows"], c["seq"])
    tcfg = TrainConfig(optimizer=c["optimizer"], microbatches=2,
                       learning_rate=1e-3, warmup_steps=1, total_steps=10)
    one = model_of(cfg, tree)
    sh = shard.shard_model(model_of(cfg, tree), mesh, c["profile"])
    local = shard.shard_batch(batch, mesh, c["profile"])
    st1 = tl.make_train_state(one, tcfg)
    step1 = tl.make_train_step(one, tcfg)
    st2 = tl.make_train_state(sh, tcfg)
    bspecs = shd.infer_batch_specs(batch, mesh, c["profile"])
    step2 = tl.jit_train_step(sh, tcfg, mesh, st2, bspecs, c["profile"])
    rec = {"loss": [], "gnorm": [], "grad_err": 0.0, "grad_worst": ""}
    for _ in range(2):
        st1, m1 = step1(st1, batch)
        st2, m2 = step2(st2, local)
        rec["loss"].append([float(m1["loss"]), float(m2["loss"])])
        rec["gnorm"].append([float(m1["grad_norm"]), float(m2["grad_norm"])])
        for leaf, g1, g2 in zip(step2.leaves, step1.grads, step2.grads):
            want = _mesh_slice(g1.numpy(), mesh, leaf.spec)
            tol = 1e-4 * float(g1.abs().max()) + 1e-6
            err = float(np.abs(want - g2.numpy()).max()) / tol
            if err > rec["grad_err"]:
                rec["grad_err"], rec["grad_worst"] = err, "/".join(leaf.path)
    whole1 = tmodel.params_to_numpy(one)
    rec["params"] = param_errs(shard.gather_params(sh), whole1, 2e-6)
    sliced = {p: _mesh_slice(v, mesh, leaf.spec) for (p, v), leaf in
              zip(flat(whole1), step2.leaves)}
    rec["param_slices"] = param_errs(
        dict(flat(tmodel.params_to_numpy(sh))), sliced, 2e-6)
    specs = tl.state_specs(shard.abstract_state(cfg, tcfg), mesh,
                           c["profile"])
    want_opt = {p: _mesh_slice(v, mesh, s) for (p, v), (_, s) in
                zip(flat(to_np(st1["opt"])), flat(specs["opt"]))}
    rec["opt_slices"] = param_errs(dict(flat(to_np(st2["opt"]))), want_opt,
                                   2e-6)
    rec["resident"] = {
        "params": shard.resident_bytes(sh),
        "params_want": sum(4 * int(np.prod(shd.local_shape(
            l.global_shape, l.spec, mesh))) for l in step2.leaves),
        "opt": shard.resident_bytes(st2["opt"]),
        "opt_want": sum(v.nbytes for v in want_opt.values()),
        "grads": shard.resident_bytes(step2.grads),
        "grads_want": sum(4 * int(np.prod(l.shape)) for l in step2.leaves),
        "single": shard.resident_bytes(one)}
    return rec

def serve_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = config(c["arch"], c["heads"])
    tree = weights(cfg, 31)
    one, sh = model_of(cfg, tree), shard.shard_model(model_of(cfg, tree),
                                                     mesh)
    Bs, P, gen = 4, 8, c["gen"]
    prompt = prompt_batch(one, Bs, P, seed=33)
    lspec = shd.logits_spec(mesh)
    rec = {"logits": 0.0, "caches": 0.0, "tokens_equal": True,
           "cache_shapes": []}
    tmodel.CACHE_DTYPE = torch.float32
    l1, c1 = sl.make_prefill_step(one, max_len=P + gen)(prompt)
    l2, c2 = sl.make_prefill_step(sh, mesh, max_len=P + gen)(
        shard.shard_batch(prompt, mesh))

    def score(l1, l2, t1, t2):
        rec["logits"] = max(rec["logits"],
                            float((l2 - cut(l1, lspec, mesh)).abs().max()))
        rec["tokens_equal"] &= bool(torch.equal(
            t2, cut(t1, (lspec[0],), mesh).int()))
    t1, t2 = sl.greedy_token(one, l1), sl.greedy_token(sh, l2)
    score(l1, l2, t1, t2)
    step = {"tokens": t1[:, None]}
    dec1 = sl.make_decode_step(one)
    dec2 = sl.jit_decode_step(sh, mesh, c2, shd.infer_batch_specs(step,
                                                                  mesh))
    for i in range(gen):
        t1, l1, c1 = dec1({"tokens": t1[:, None]}, c1, P + i)
        t2, l2, c2 = dec2({"tokens": t2[:, None]}, c2, P + i)
        score(l1, l2, t1, t2)
    cspecs = shd.infer_cache_specs(c1, mesh)
    for (p, a), (_, b), (_, s) in zip(flat(c2), flat(c1), flat(cspecs)):
        rec["caches"] = max(rec["caches"],
                            float((a.float() - cut(b, s, mesh)).abs().max()))
        rec["cache_shapes"].append(["/".join(p), list(a.shape), list(
            shd.local_shape(b.shape, s, mesh)), [
                e if e is None or isinstance(e, str) else list(e)
                for e in s]])
    return rec

def ref_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = config(c["arch"])
    inp = np.load(c["inputs"])
    tree = tmodel.nest((tuple(k.split("/")), inp["w:" + k]) for k in
                       [k[2:] for k in inp.files if k.startswith("w:")])
    batch = {k[2:]: torch.from_numpy(inp[k]) for k in inp.files
             if k.startswith("b:")}
    tcfg = TrainConfig(learning_rate=1e-3, microbatches=2, z_loss=0.0,
                       warmup_steps=1, total_steps=10)
    sh = shard.shard_model(model_of(cfg, tree), mesh)
    st = tl.make_train_state(sh, tcfg)
    step = tl.make_train_step(sh, tcfg, mesh)
    local = shard.shard_batch(batch, mesh)
    losses, params = [], []
    for _ in range(2):
        st, m = step(st, local)
        losses.append(float(m["loss"]))
        params.append(shard.gather_params(sh))
    if rank == 0:
        np.savez(c["out"], **{f"p{i}:" + "/".join(p): v
                              for i, t in enumerate(params)
                              for p, v in flat(t)})
    return {"loss": losses}

results = {}
for c in work:
    fn = {"train": train_case, "serve": serve_case, "ref": ref_case}
    results[c["name"]] = fn[c["kind"]](c)
json.dump(results, open(f"{out_dir}/rank{rank}.json", "w"))
mesh_lib.barrier()
dist.destroy_process_group()
print("WORKER-OK")
'''

#: the reference's sharded step (tests/test_sharding.py's script, fed the
#: port's weights and batch, on a mesh of Auto axes, two steps) at each
#: config's reduce_config, one after the other in one process
REFERENCE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs.base import TrainConfig
    from repro.models import build_model
    from repro.runtime.train_loop import (make_train_state, make_train_step,
                                          state_specs)
    from repro.runtime import sharding as shd
    sys.path.insert(0, "tests")
    from test_smoke_archs import reduce_config
    jax.config.update("jax_platform_name", "cpu")

    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    tcfg = TrainConfig(learning_rate=1e-3, microbatches=2, z_loss=0.0,
                       warmup_steps=1, total_steps=10)
    for arch, src, dst in zip(sys.argv[1].split(","), sys.argv[2::2],
                              sys.argv[3::2]):
        inp = np.load(src)
        cfg = reduce_config(get_config(arch))
        model = build_model(cfg)
        state = make_train_state(model, tcfg, jax.random.PRNGKey(0))
        flat = jax.tree_util.tree_flatten_with_path(state["params"])
        leaves = [jnp.asarray(inp["w:" + "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in p)])
            for p, _ in flat[0]]
        state["params"] = jax.tree.unflatten(flat[1], leaves)
        batch = {k[2:]: jnp.asarray(inp[k]) for k in inp.files
                 if k.startswith("b:")}
        sspecs = state_specs(state, mesh)
        bspecs = shd.infer_batch_specs(batch, mesh)
        step8 = jax.jit(make_train_step(model, tcfg, mesh),
                        in_shardings=(shd.named(sspecs, mesh),
                                      shd.named(bspecs, mesh)),
                        out_shardings=(shd.named(sspecs, mesh), None))
        out = {}
        for i in range(2):
            state, m = step8(state, batch)
            out[f"loss{i}"] = np.asarray(m["loss"])
            for p, v in jax.tree_util.tree_flatten_with_path(
                    state["params"])[0]:
                out[f"p{i}:" + "/".join(
                    str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in p)] = np.asarray(v)
        np.savez(dst, **out)
    print("REF-OK")
''')


def _cases(tmp):
    rows = dict(rows=B, seq=S)
    train = [dict(kind="train", name=n, mesh=list(m), profile=p, arch=a,
                  optimizer=o, heads=h, **rows)
             for n, m, p, a, o, h in TRAIN_CASES]
    serve = [dict(kind="serve", name=n, mesh=list(m), arch=a, heads=h,
                  gen=8) for n, m, a, h in SERVE_CASES]
    ref = [dict(kind="ref", name="ref-" + SHORT[a], mesh=[4, 2], arch=a,
                inputs=str(tmp / f"ref_in_{SHORT[a]}.npz"),
                out=str(tmp / f"port_out_{SHORT[a]}.npz")) for a in ARCHS]
    return {4: train + serve, 8: ref}


def _ref_inputs(arch, path):
    """``arch``'s tiny weights (the port's initialiser, seeded, the
    replicated vectors perturbed) and a batch, as the reference's tree
    flattened to ``w:a/b`` keys."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import model as tmodel
    cfg = tiny_config(get_config(arch))
    tree = tmodel.params_to_numpy(tmodel.build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(5)))
    rng = np.random.default_rng(6)
    out = {}
    for p, v in tmodel._paths(tree):
        if p[-1] in ("scale", "A_log", "D", "dt_bias", "if_bias", "bias"):
            v = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        out["w:" + "/".join(p)] = v
    for k in ("tokens", "labels"):
        out["b:" + k] = rng.integers(0, cfg.vocab_size, (B, S)
                                     ).astype(np.int32)
    if cfg.family in ("encdec", "audio"):
        out["b:frames"] = rng.standard_normal((B, S, cfg.d_model)
                                              ).astype(np.float32)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_ssm")
    ref_args = []
    for a in ARCHS:
        _ref_inputs(a, tmp / f"ref_in_{SHORT[a]}.npz")
        ref_args += [str(tmp / f"ref_in_{SHORT[a]}.npz"),
                     str(tmp / f"ref_out_{SHORT[a]}.npz")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    calls = [("reference", [[sys.executable, "-c", REFERENCE, ",".join(ARCHS),
                               *ref_args]],
              ALONE_S["reference"])]
    for w, cases in _cases(tmp).items():
        (tmp / f"w{w}.json").write_text(json.dumps(cases))
        (tmp / f"out{w}").mkdir()
        calls.append((f"world{w}", [
            [sys.executable, "-c", WORKER, str(r), str(w),
             str(tmp / f"store{w}"), str(tmp / f"w{w}.json"),
             str(tmp / f"out{w}")] for r in range(w)], ALONE_S[w]))
    outs = run_in_turn(calls, env=env, cwd=str(ROOT))
    assert "REF-OK" in outs["reference"][0][1]
    assert all("WORKER-OK" in o for name, cmds in outs.items()
               if name != "reference" for _, o, _ in cmds)
    res = {w: [json.loads((tmp / f"out{w}" / f"rank{r}.json").read_text())
               for r in range(w)] for w in (4, 8)}
    return tmp, res


def _ranks(worlds, name):
    """Each rank's record of case ``name``."""
    return [r[name] for r in worlds[1][8 if name.startswith("ref-") else 4]]


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_sharded_recurrent_step_matches_one_device(worlds, case):
    """Loss, grad norm, gradient slices (the replicated vectors' and the
    d_in norms' included), parameters (whole and sliced) and
    optimizer-state slices after two steps of two microbatches."""
    for rec in _ranks(worlds, case):
        for one, sharded in rec["loss"] + rec["gnorm"]:
            assert _close(sharded, one, METRIC_RTOL), (one, sharded)
        assert rec["grad_err"] <= 1.0, (rec["grad_err"], rec["grad_worst"])
        for key in ("params", "param_slices", "opt_slices"):
            within, past, total, worst = rec[key]
            assert within <= STEP_TOL, (key, within)
            assert past <= 1e-3 * total, (key, past, total)
            assert worst <= 2 * LR + STEP_TOL, (key, worst)


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_recurrent_ranks_hold_only_their_slices(worlds, case):
    """Parameters, optimizer state and float32 accumulators are exactly
    the bytes of this rank's slices, less than half of the whole (the
    rules cut no FSDP dim of the mLSTM's ``wqkv`` and ``wif``)."""
    for rec in _ranks(worlds, case):
        r = rec["resident"]
        assert r["params"] == r["params_want"]
        assert r["opt"] == r["opt_want"]
        assert r["grads"] == r["grads_want"]
        assert r["params"] < r["single"] / 2, r


@pytest.mark.parametrize("case", [c[0] for c in SERVE_CASES])
def test_sharded_recurrent_decode_matches_one_device(worlds, case):
    """float32 caches: prefill and 8 decode steps, logits within 2e-4,
    equal greedy tokens, the caches this rank holds the slices of the
    one-device caches within 2e-4."""
    for rec in _ranks(worlds, case):
        assert rec["tokens_equal"]
        assert rec["logits"] <= SERVE_TOL, rec["logits"]
        assert rec["caches"] <= SERVE_TOL, rec["caches"]


@pytest.mark.parametrize("case", [c[0] for c in SERVE_CASES])
def test_recurrent_caches_are_laid_out_by_the_rules(worlds, case):
    """Each cache leaf has the shape ``infer_cache_specs`` cuts the
    one-device leaf to. On (2, 2): the recurrent states on the batch and
    the heads, the conv caches on the batch and the channels, the
    sLSTM's c/n/h/m and the memory on the batch only, the KV caches on
    the batch and the KV heads. On (1, 4) at 2 heads the mLSTM state is
    cut on Dk."""
    arch = next(a for n, _, a, _ in SERVE_CASES if n == case)
    want = dict(CACHE_SPECS[arch])
    if case.startswith("serve-1x4"):
        want.update(state=["data", None, "model", None])
    for rec in _ranks(worlds, case):
        names = set()
        for path, got, shape, spec in rec["cache_shapes"]:
            assert got == shape, (path, got, shape)
            name = path.split("/")[-1]
            lead = len(spec) - len(want[name])
            assert spec[lead:] == want[name] and not any(spec[:lead]), (
                path, spec)
            names.add(name)
        assert names == set(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_recurrent_step_matches_the_reference_sharded_step(worlds,
                                                                   arch):
    """The port's (4, 2) step against the reference's on an Auto-axis
    mesh: the reference test's tolerances, on every parameter."""
    tmp, _ = worlds
    ref = np.load(tmp / f"ref_out_{SHORT[arch]}.npz")
    port = np.load(tmp / f"port_out_{SHORT[arch]}.npz")
    for i in range(2):
        for rec in _ranks(worlds, "ref-" + SHORT[arch]):
            np.testing.assert_allclose(rec["loss"][i], float(ref[f"loss{i}"]),
                                       rtol=REF_LOSS_RTOL)
        keys = [k for k in ref.files if k.startswith(f"p{i}:")]
        assert keys and set(keys) == {k for k in port.files
                                      if k.startswith(f"p{i}:")}
        for k in keys:
            np.testing.assert_allclose(port[k], ref[k], atol=REF_PARAM_ATOL,
                                       err_msg=k)
