"""The MoE family on a mesh (``models.moe`` and MLA in
``models.attention`` under ``runtime.shard``): the sharded train and
serve steps on gloo worlds of CPU processes, against the port's
one-device steps and against the JAX package's sharded step.

Each world runs once (a module fixture: ``_worlds.run_in_turn`` runs
the reference's process, then each world, one after another);
every rank builds the same tiny model from a seed (``tiny_config``:
d_model 64, 8 experts top-2 of width 32; deepseek-v2-236b's with MLA of
ranks 16 / 24, one shared expert and its dense ``block0``, arctic-480b's
with GQA and the dense residual; float32, norm scales perturbed), runs
the one-device step on the whole batch and the sharded step on its
rows, and writes what it measured:

* train, (2, 2) "2d" (experts 4 a model rank, MLA's heads 2, d over the
  data axis) and (4, 1) "fsdp_only" (every expert on every rank, d over
  all four): AdamW and Adafactor, two microbatches, two steps (the first
  at lr 0), labels −1 on most of the first rows' positions. Held at the
  float32 criteria: loss and grad norm within 1e-5 relative; every
  gradient leaf within 1e-4 of its largest |g| (+1e-6), as this rank's
  slice of the one-device accumulator; every parameter after the steps
  within 2e-6, or within 2·lr on at most 1e-3 of the elements (Adam's
  sign flips), whole and as this rank's slice; the optimizer state as
  the slice of the one-device state; each MoE layer's global drop count
  equal to the one device's; the resident parameters, optimizer state
  and accumulators exactly the slices' bytes; the expert leaves stored
  in the reference's shapes, cut as ``_EXPERT_RULES`` says.
* drops: deepseek at ``capacity_factor`` 0.5, so that the global batch
  overflows its experts: the drop counts above 0 and equal, the logits
  of a forward within 1e-5 of the one device's (their slice), and the
  step held as above.
* serve, (2, 2): prefill and 8 greedy decode steps with float32 caches;
  every step's logits within 2e-4 of the one device's slice, equal
  tokens and drop counts, and every cache leaf (``ckv`` cut on R over
  the model axis, ``k_rope`` on the batch only, GQA's ``k``/``v`` on the
  KV heads) the ``_mesh_slice`` of the one-device cache in shape and
  within 2e-4 in value.
* the layouts that earlier slices refused run: at a batch of 1, whose
  prompt and caches are cut on the sequence over the data axis, held
  against the one device (prefill and 3 decode steps, float32 caches,
  logits within 2e-4, equal tokens and drops): tiny deepseek
  (``batch-1``, a prompt of 32 at a capacity factor that drops), zamba2
  (``hybrid-family``), seamless (``encdec-family``) and deepseek with a
  latent rank of 15, which the model axis does not divide while it
  divides the heads (``mla-latent-rank``: the heads cut, ``ckv`` whole
  on each model rank); and arctic on the production (16, 16) mesh,
  whose 8 KV heads the model axis does not divide
  (``arctic-16x16-kv-heads``: ``serve_loop.check_serve_layout`` on the
  mesh's shape passes).
* the JAX package's sharded step on an Auto-axis (4, 2) mesh (8 fake CPU
  devices, in its own process) at ``tests/test_smoke_archs.py``'s
  ``reduce_config`` of deepseek-v2-236b, fed the same weights and batch:
  loss within rtol 2e-4 and every parameter within 3e-4 after each of
  two steps (``tests/test_sharding.py``'s tolerances).
"""
import json
import os
import pathlib
import sys
import textwrap

import numpy as np
import pytest

from _worlds import run_in_turn
from repro_torch.runtime import sharding as shd

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: each call's seconds alone on an 8-core CPU, rounded up (``_worlds``)
ALONE_S = {"reference": 38, 4: 10, 8: 4}
METRIC_RTOL = 1e-5
STEP_TOL, FLIP_SHARE = 2e-6, 1e-3
LR = 1e-3
LOGITS_TOL = 1e-5
SERVE_TOL = 2e-4
REF_LOSS_RTOL, REF_PARAM_ATOL = 2e-4, 3e-4
B, S = 8, 16
DROP_FACTOR = 0.5

#: (name, mesh, profile, arch, optimizer, capacity factor (None: the
#: config's))
TRAIN_CASES = [
    ("2x2-deepseek-adamw", (2, 2), "2d", "deepseek-v2-236b", "adamw", None),
    ("2x2-deepseek-adafactor", (2, 2), "2d", "deepseek-v2-236b",
     "adafactor", None),
    ("2x2-arctic-adamw", (2, 2), "2d", "arctic-480b", "adamw", None),
    ("2x2-arctic-adafactor", (2, 2), "2d", "arctic-480b", "adafactor",
     None),
    ("4x1-fsdp_only-deepseek", (4, 1), "fsdp_only", "deepseek-v2-236b",
     "adafactor", None),
    ("2x2-deepseek-drops", (2, 2), "2d", "deepseek-v2-236b", "adamw",
     DROP_FACTOR),
]
SERVE_ARCHS = ("deepseek-v2-236b", "arctic-480b")
#: layouts that earlier slices refused
ONCE_REFUSED = ("hybrid-family", "encdec-family", "mla-latent-rank",
                "batch-1", "arctic-16x16-kv-heads")
#: the cases of ``ONCE_REFUSED`` held against the one device
RUNS = ("hybrid-family", "encdec-family", "mla-latent-rank", "batch-1")

WORKER = r'''
import dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.checkpoint.manager import _mesh_slice
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import prompt_batch
from repro_torch.launch.train import tiny_config
from repro_torch.models import model as tmodel
from repro_torch.models.moe import MoE
from repro_torch.runtime import serve_loop as sl, shard, sharding as shd
from repro_torch.runtime import train_loop as tl

rank, world, store, spec_file, out_dir = (int(sys.argv[1]),
                                          int(sys.argv[2]), *sys.argv[3:6])
work = json.load(open(spec_file))
torch.manual_seed(0)
mesh_lib.init_group("gloo", init_method="file://" + store, rank=rank,
                    world_size=world, device="cpu", timeout_s=120)
meshes = {}

def get_mesh(shape):
    if tuple(shape) not in meshes:
        meshes[tuple(shape)] = mesh_lib.make_host_mesh(
            *shape, backend="gloo", device="cpu")
    return meshes[tuple(shape)]

def config(arch, factor=None):
    cfg = tiny_config(get_config(arch))
    if factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=factor))
    return cfg

def weights(cfg, seed):
    tree = tmodel.params_to_numpy(tmodel.build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "scale":
                t[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(
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
    return {k: torch.from_numpy(v.astype(np.int32)) for k, v in out.items()}

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

def drops(model):
    return [int(m.last_dropped) for m in model.modules()
            if isinstance(m, MoE)]

def cut(t, spec, mesh):
    return torch.from_numpy(_mesh_slice(t.detach().float().numpy(), mesh,
                                        spec))

def train_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = config(c["arch"], c["factor"])
    tree = weights(cfg, 11)
    batch = make_batch(cfg, 12, c["rows"], c["seq"])
    tcfg = TrainConfig(optimizer=c["optimizer"], microbatches=2,
                       learning_rate=1e-3, warmup_steps=1, total_steps=10)
    one = model_of(cfg, tree)
    sh = shard.shard_model(model_of(cfg, tree), mesh, c["profile"])
    local = shard.shard_batch(batch, mesh, c["profile"])
    rec = {"loss": [], "gnorm": [], "grad_err": 0.0, "drops": []}
    with torch.no_grad():
        l1 = one.train_logits(batch)
        d1 = drops(one)
        l2 = sh.train_logits(local)
        rec["drops"].append([d1, drops(sh)])
    lspec = shd.logits_spec(mesh, c["profile"])
    rec["logits"] = float((l2 - cut(l1, lspec, mesh)).abs().max())
    st1 = tl.make_train_state(one, tcfg)
    step1 = tl.make_train_step(one, tcfg)
    st2 = tl.make_train_state(sh, tcfg)
    bspecs = shd.infer_batch_specs(batch, mesh, c["profile"])
    step2 = tl.jit_train_step(sh, tcfg, mesh, st2, bspecs, c["profile"])
    for _ in range(2):
        st1, m1 = step1(st1, batch)
        d1 = drops(one)
        st2, m2 = step2(st2, local)
        rec["drops"].append([d1, drops(sh)])
        rec["loss"].append([float(m1["loss"]), float(m2["loss"])])
        rec["gnorm"].append([float(m1["grad_norm"]), float(m2["grad_norm"])])
        for leaf, g1, g2 in zip(step2.leaves, step1.grads, step2.grads):
            want = _mesh_slice(g1.numpy(), mesh, leaf.spec)
            tol = 1e-4 * float(g1.abs().max()) + 1e-6
            err = float(np.abs(want - g2.numpy()).max())
            rec["grad_err"] = max(rec["grad_err"], err / tol)
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
    # the expert leaves and the router: the reference's per-layer shapes,
    # their spec the port's
    rec["experts"] = {"/".join(l.path): dict(
        spec=[e if e is None or isinstance(e, str) else list(e)
              for e in l.spec],
        port_spec=[e if e is None or isinstance(e, str) else list(e)
                   for e in l.params[0].shard.spec],
        shapes=[list(p.shape) for p in l.params],
        want=list(shd.local_shape(l.global_shape, l.spec, mesh)[l.lead:]))
        for l in step2.leaves if "experts" in l.path or "router" in l.path}
    return rec

def serve_case(arch, mesh_shape, gen):
    mesh = get_mesh(mesh_shape)
    cfg = config(arch)
    tree = weights(cfg, 31)
    one, sh = model_of(cfg, tree), shard.shard_model(model_of(cfg, tree),
                                                     mesh)
    Bs, P = 4, 8
    prompt = prompt_batch(one, Bs, P, seed=33)
    lspec = shd.logits_spec(mesh)
    rec = {"logits": 0.0, "caches": 0.0, "tokens_equal": True,
           "drops_equal": True, "cache_shapes": []}
    tmodel.CACHE_DTYPE = torch.float32
    l1, c1 = sl.make_prefill_step(one, max_len=P + gen)(prompt)
    d1 = drops(one)
    l2, c2 = sl.make_prefill_step(sh, mesh, max_len=P + gen)(
        shard.shard_batch(prompt, mesh))
    rec["drops_equal"] &= d1 == drops(sh)
    rec["prefill_drops"] = d1

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
        d1 = drops(one)
        t2, l2, c2 = dec2({"tokens": t2[:, None]}, c2, P + i)
        rec["drops_equal"] &= d1 == drops(sh)
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

def batch_of_one(mesh, cfg, P):
    """Prefill a prompt of ``P`` at a batch of 1 (cut on its sequence
    over the data axis) and 3 decode steps, float32 caches, on the mesh
    and on one device: (largest logits error, tokens and drops equal,
    the prefill's drops)."""
    tmodel.CACHE_DTYPE = torch.float32
    tree = weights(cfg, 51)
    one, sh = model_of(cfg, tree), shard.shard_model(model_of(cfg, tree),
                                                     mesh)
    prompt = prompt_batch(one, 1, P, seed=52)
    lspec = (None, None, "model")          # the batch of 1 on every rank
    l1, c1 = sl.make_prefill_step(one, max_len=P + 4)(prompt)
    l2, c2 = sl.make_prefill_step(sh, mesh, max_len=P + 4)(
        shard.shard_batch(prompt, mesh))
    rec = {"logits": float((l2 - cut(l1, lspec, mesh)).abs().max()),
           "prefill_drops": sum(drops(one)),
           "drops_equal": drops(one) == drops(sh)}
    t1, t2 = sl.greedy_token(one, l1), sl.greedy_token(sh, l2)
    rec["tokens_equal"] = bool(torch.equal(t1, t2))
    dec2 = sl.jit_decode_step(sh, mesh, c2, shd.infer_batch_specs(
        {"tokens": t1[:, None]}, mesh))
    for i in range(3):
        t1, l1, c1 = sl.make_decode_step(one)({"tokens": t1[:, None]}, c1,
                                              P + i)
        t2, l2, c2 = dec2({"tokens": t2[:, None]}, c2, P + i)
        rec["logits"] = max(rec["logits"], float(
            (l2 - cut(l1, lspec, mesh)).abs().max()))
        rec["tokens_equal"] &= bool(torch.equal(t1, t2))
        rec["drops_equal"] &= drops(one) == drops(sh)
    return rec

def raises_case(c):
    mesh = get_mesh(c["mesh"])
    out = {}
    def expect(name, fn, exc=NotImplementedError):
        try:
            fn()
            out[name] = "ran"
        except exc as e:
            out[name] = "raised: " + str(e)[:200]
    for name, arch in (("hybrid-family", "zamba2-7b"),
                       ("encdec-family", "seamless-m4t-medium")):
        out[name] = batch_of_one(mesh, config(arch), 8)
    ds = config("deepseek-v2-236b")
    out["mla-latent-rank"] = batch_of_one(mesh, ds.replace(
        mla=dataclasses.replace(ds.mla, kv_lora_rank=15)), 8)
    out["batch-1"] = batch_of_one(mesh, config("deepseek-v2-236b", 0.25), 32)
    expect("arctic-16x16-kv-heads", lambda: sl.check_serve_layout(
        get_config("arctic-480b"), 16, 4096, {"data": 16, "model": 16}))
    sl.check_serve_layout(get_config("deepseek-v2-236b"), 16, 4096,
                          {"data": 16, "model": 16})
    out["deepseek-16x16"] = "ran"
    return out

def ref_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = config(c["arch"])
    inp = np.load(c["inputs"])
    tree = tmodel.nest((tuple(k.split("/")), inp["w:" + k]) for k in
                       [k[2:] for k in inp.files if k.startswith("w:")])
    batch = {k: torch.from_numpy(inp["b:" + k]) for k in ("tokens", "labels")}
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
    if c["kind"] == "train":
        results[c["name"]] = train_case(c)
    elif c["kind"] == "serve":
        results[c["name"]] = serve_case(c["arch"], c["mesh"], c["gen"])
    elif c["kind"] == "raises":
        results[c["name"]] = raises_case(c)
    else:
        results[c["name"]] = ref_case(c)
json.dump(results, open(f"{out_dir}/rank{rank}.json", "w"))
mesh_lib.barrier()
dist.destroy_process_group()
print("WORKER-OK")
'''

#: the reference's sharded step (tests/test_sharding.py's script, fed the
#: port's weights and batch, on a mesh of Auto axes, two steps) at
#: deepseek-v2-236b's reduce_config
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

    inp = np.load(sys.argv[1])
    cfg = reduce_config(get_config("deepseek-v2-236b"))
    model = build_model(cfg)
    tcfg = TrainConfig(learning_rate=1e-3, microbatches=2, z_loss=0.0,
                       warmup_steps=1, total_steps=10)
    state = make_train_state(model, tcfg, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(state["params"])
    leaves = [jnp.asarray(inp["w:" + "/".join(k.key for k in p)])
              for p, _ in flat[0]]
    state["params"] = jax.tree.unflatten(flat[1], leaves)
    batch = {k: jnp.asarray(inp["b:" + k]) for k in ("tokens", "labels")}
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
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
            out[f"p{i}:" + "/".join(k.key for k in p)] = np.asarray(v)
    np.savez(sys.argv[2], **out)
    print("REF-OK")
''')


def _cases(tmp):
    rows = dict(rows=B, seq=S)
    train = [dict(kind="train", name=n, mesh=list(m), profile=p, arch=a,
                  optimizer=o, factor=f, **rows)
             for n, m, p, a, o, f in TRAIN_CASES]
    serve = [dict(kind="serve", name="serve-" + a, arch=a, mesh=[2, 2],
                  gen=8) for a in SERVE_ARCHS]
    return {4: train + serve + [dict(kind="raises", name="raises",
                                     mesh=[2, 2])],
            8: [dict(kind="ref", name="ref", mesh=[4, 2],
                     arch="deepseek-v2-236b",
                     inputs=str(tmp / "ref_in.npz"),
                     out=str(tmp / "port_out.npz"))]}


def _ref_inputs(path):
    """deepseek-v2-236b's tiny weights (the port's initialiser, seeded)
    and a batch, as the reference's tree flattened to ``w:a/b`` keys."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import model as tmodel
    cfg = tiny_config(get_config("deepseek-v2-236b"))
    tree = tmodel.params_to_numpy(tmodel.build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(5)))
    out = {"w:" + "/".join(p): v for p, v in tmodel._paths(tree)}
    rng = np.random.default_rng(6)
    for k in ("tokens", "labels"):
        out["b:" + k] = rng.integers(0, cfg.vocab_size, (B, S)
                                     ).astype(np.int32)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_moe")
    _ref_inputs(tmp / "ref_in.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    calls = [("reference", [[sys.executable, "-c", REFERENCE, str(tmp / "ref_in.npz"),
                               str(tmp / "ref_out.npz")]],
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
    return [r[name] for r in worlds[1][8 if name == "ref" else 4]]


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_sharded_moe_step_matches_one_device(worlds, case):
    """Loss, grad norm, gradient slices, parameters (whole and sliced),
    optimizer-state slices and the global drop counts after two steps of
    two microbatches."""
    for rec in _ranks(worlds, case):
        for one, sharded in rec["loss"] + rec["gnorm"]:
            assert _close(sharded, one, METRIC_RTOL), (one, sharded)
        assert rec["grad_err"] <= 1.0, rec["grad_err"]
        for key in ("params", "param_slices", "opt_slices"):
            within, past, total, worst = rec[key]
            assert within <= STEP_TOL, (key, within)
            assert past <= FLIP_SHARE * total, (key, past, total)
            assert worst <= 2 * LR + STEP_TOL, (key, worst)
        for one, sharded in rec["drops"]:
            assert one == sharded, rec["drops"]


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_moe_ranks_hold_only_their_slices(worlds, case):
    """Parameters, optimizer state and float32 accumulators are exactly
    the bytes of this rank's slices, and about a quarter of the whole."""
    for rec in _ranks(worlds, case):
        r = rec["resident"]
        assert r["params"] == r["params_want"]
        assert r["opt"] == r["opt_want"]
        assert r["grads"] == r["grads_want"]
        assert r["params"] < 1.2 * r["single"] / 4 + 4096, r


def test_global_drops_match_one_device(worlds):
    """At capacity factor 0.5 the global batch overflows its experts:
    every rank counts the one device's drops (above 0), and the forward's
    logits and the steps match (``test_sharded_moe_step_matches_one_
    device``)."""
    for rec in _ranks(worlds, "2x2-deepseek-drops"):
        assert rec["logits"] <= LOGITS_TOL, rec["logits"]
        for one, sharded in rec["drops"]:
            assert one == sharded and sum(one) > 0, rec["drops"]


@pytest.mark.parametrize("case", ["2x2-deepseek-adamw",
                                  "4x1-fsdp_only-deepseek"])
def test_expert_leaves_keep_the_reference_shapes(worlds, case):
    """The port stores the experts (E, d, f) / (E, f, d) and the router
    (d, E) in the reference's shapes, so the port's spec is the
    reference's, and each layer's parameter is its slice: "2d" cuts E
    over the model axis and d over the data axis, "fsdp_only" d over
    both and E nowhere; the router's d over the FSDP axes only."""
    fsdp = ["data", "model"] if case.startswith("4x1") else "data"
    for rec in _ranks(worlds, case):
        ex = rec["experts"]
        assert set(ex) == {"blocks/ffn/router", "blocks/ffn/experts/gate",
                           "blocks/ffn/experts/up",
                           "blocks/ffn/experts/down"}
        for path, e in ex.items():
            assert e["spec"][1:] == e["port_spec"], (path, e)
            assert all(s == e["want"] for s in e["shapes"]), (path, e)
        E = None if case.startswith("4x1") else "model"
        assert ex["blocks/ffn/experts/gate"]["spec"] == [None, E, fsdp, None]
        assert ex["blocks/ffn/experts/down"]["spec"] == [None, E, None, fsdp]
        assert ex["blocks/ffn/router"]["spec"] == [None, fsdp, None]


def test_adafactor_expert_state_specs():
    """Adafactor's factored state of a stacked expert leaf (L, E, d, f):
    ``vr`` (L, E, d) by ("E", "D"), ``vc`` (L, E, f) by ("E", None), so
    ``vc``'s mean over d is all-reduced over the FSDP axes and never over
    the model axis that cuts E."""
    mesh = {"data": 2, "model": 2}
    path = ("opt", "f", "blocks", "ffn", "experts", "gate")
    assert shd.spec_for_param(path + ("vr",), (1, 8, 64), mesh) == (
        None, "model", "data")
    assert shd.spec_for_param(path + ("vc",), (1, 8, 32), mesh) == (
        None, "model", None)
    down = ("opt", "f", "blocks", "ffn", "experts", "down")
    assert shd.spec_for_param(down + ("vr",), (1, 8, 32), mesh) == (
        None, "model", None)
    assert shd.spec_for_param(down + ("vc",), (1, 8, 64), mesh) == (
        None, "model", "data")


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_moe_decode_matches_one_device(worlds, arch):
    """float32 caches: prefill and 8 decode steps, logits within 2e-4,
    equal greedy tokens and drop counts, the caches this rank holds the
    slices of the one-device caches."""
    for rec in _ranks(worlds, "serve-" + arch):
        assert rec["tokens_equal"] and rec["drops_equal"]
        assert rec["logits"] <= SERVE_TOL, rec["logits"]
        assert rec["caches"] <= SERVE_TOL, rec["caches"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_moe_caches_are_laid_out_by_the_rules(worlds, arch):
    """Each cache leaf has the shape ``infer_cache_specs`` cuts the
    one-device leaf to: MLA's ``ckv`` on its batch over data and R over
    model, ``k_rope`` on its batch only; GQA's ``k``/``v`` on the batch
    and the KV heads."""
    want_specs = {"ckv": [None, "data", None, "model"],
                  "k_rope": [None, "data", None, None],
                  "k": [None, "data", None, "model", None],
                  "v": [None, "data", None, "model", None]}
    for rec in _ranks(worlds, "serve-" + arch):
        names = set()
        for path, got, want, spec in rec["cache_shapes"]:
            assert got == want, (path, got, want)
            name = path.split("/")[-1]
            assert spec == want_specs[name], (path, spec)
            names.add(name)
        assert names == ({"ckv", "k_rope"} if arch.startswith("deepseek")
                         else {"k", "v"})


@pytest.mark.parametrize("what", ONCE_REFUSED)
def test_once_refused_moe_layouts_run(worlds, what):
    """The cases of ``RUNS``, which earlier slices refused, run against
    the one device (logits within 2e-4, equal tokens and drops;
    deepseek's batch of 1 drops; deepseek's latent rank of 15 on the
    model axis of 2 that cuts its heads), and arctic's (16, 16) layout
    check passes."""
    for rec in _ranks(worlds, "raises"):
        got = rec[what]
        if what in RUNS:
            assert got["tokens_equal"] and got["drops_equal"], got
            assert got["logits"] <= SERVE_TOL, got
            if what == "batch-1":
                assert got["prefill_drops"] > 0, got
        else:
            assert got == "ran", got
        assert rec["deepseek-16x16"] == "ran"


def test_sharded_moe_step_matches_the_reference_sharded_step(worlds):
    """The port's (4, 2) deepseek step against the reference's on an
    Auto-axis mesh: the reference test's tolerances, on every
    parameter."""
    tmp, _ = worlds
    ref = np.load(tmp / "ref_out.npz")
    port = np.load(tmp / "port_out.npz")
    for i in range(2):
        for rec in _ranks(worlds, "ref"):
            np.testing.assert_allclose(rec["loss"][i], float(ref[f"loss{i}"]),
                                       rtol=REF_LOSS_RTOL)
        keys = [k for k in ref.files if k.startswith(f"p{i}:")]
        assert keys and set(keys) == {k for k in port.files
                                      if k.startswith(f"p{i}:")}
        for k in keys:
            np.testing.assert_allclose(port[k], ref[k], atol=REF_PARAM_ATOL,
                                       err_msg=k)
