"""The layouts whose model axis does not divide MLA's or Mamba2's heads
(``models.attention.MLA``, ``models.ssm.Mamba2`` under
``runtime.shard``): the sharded train and serve steps on gloo worlds of
3, 6 and 8 CPU processes, against the port's one-device steps and
against the JAX package's sharded steps.

The rules cut a dim only where the model axis divides it, so on an axis
of 3 or 8 the tiny configs (``tiny_config``: d_model 64, 4 heads;
deepseek-v2-236b's MLA of latent rank R = 16, zamba2-7b's Mamba2 of
d_in 128, N = 8, so z | xBC | dt of 276 columns and xBC of 144
channels) fall into every case:

* tiny deepseek on (1, 3) and (2, 3): neither the 4 heads nor R = 16
  divide 3, so nothing of MLA is cut on the model axis and ``ckv`` is
  whole there; on (1, 8) R is cut and the heads whole (``ckv`` holds
  R/8 between steps, gathered before the expansion); with 6 heads on
  (2, 3) the heads are cut and ``ckv`` is whole on each model rank.
* tiny zamba2 on (1, 3) and (2, 3): ``in_proj`` and the conv are cut
  (276 and 144 divide 3), ``out_proj`` (128 rows) is whole and the
  state whole; on (1, 8) ``in_proj`` is whole, the conv and
  ``out_proj`` are cut, and the state (4 heads) is cut on N.

Each world runs once (a module fixture: ``_worlds.run_in_turn`` runs
the reference's process, then each world, one after another);
every rank builds the same tiny model from a seed (float32, the norm
scales and Mamba2's vectors perturbed), runs the one-device step on the
whole batch and the sharded step on its slice, and writes what it
measured:

* serve: prefill and 4 greedy decode steps with float32 caches; every
  step's logits within 2e-4 of this rank's slice of the one device's
  (its rows, and its vocabulary columns where the model axis divides
  the vocabulary), equal tokens and MoE drops, and every cache leaf the
  slice ``infer_cache_specs`` gives of the one-device leaf, in shape
  and within 2e-4.
* train: AdamW, two microbatches, two steps (the first at lr 0): loss
  and grad norm within 1e-5 relative, every gradient leaf within 1e-4
  of its largest |g| (+1e-6) as this rank's slice of the one device's,
  every parameter after the steps within 2e-6 (or 2·lr on at most 1e-3
  of the elements: Adam's sign flips), the resident parameters exactly
  the slices' bytes.
* the JAX package's sharded steps, in one process on 8 fake CPU devices
  with Auto axes, at ``tests/test_smoke_archs.py``'s ``reduce_config``
  (which ``tiny_config`` equals), fed the same weights and batches as
  the port's: the train step on (2, 3) and (1, 8), loss within rtol
  2e-4 and every parameter within 3e-4 after each of two steps
  (``tests/test_sharding.py``'s tolerances); prefill and 4 decode steps
  jitted with the rules' shardings on (1, 3) and (1, 8), and zamba2's
  on (2, 3) too, float32 caches, logits within 2e-4 and equal tokens
  (each decode step's token laid out by the batch specs first, as the
  reference's jit takes a committed array only at its in_shardings).
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
ALONE_S = {"reference": 94, 3: 3, 6: 10, 8: 17}
METRIC_RTOL = 1e-5
STEP_TOL = 2e-6
LR = 1e-3
SERVE_TOL = 2e-4
REF_LOSS_RTOL, REF_PARAM_ATOL = 2e-4, 3e-4
B, S = 8, 16
P, G = 8, 4
DEEPSEEK, ZAMBA2 = "deepseek-v2-236b", "zamba2-7b"
SHORT = {DEEPSEEK: "deepseek", ZAMBA2: "zamba2"}

#: (name, mesh, arch, heads (None: the config's))
SERVE_CASES = [
    ("1x3-deepseek", (1, 3), DEEPSEEK, None),
    ("1x3-zamba2", (1, 3), ZAMBA2, None),
    ("2x3-deepseek", (2, 3), DEEPSEEK, None),
    ("2x3-deepseek-6heads", (2, 3), DEEPSEEK, 6),
    ("2x3-zamba2", (2, 3), ZAMBA2, None),
    ("1x8-deepseek", (1, 8), DEEPSEEK, None),
    ("1x8-zamba2", (1, 8), ZAMBA2, None),
]
TRAIN_CASES = [c for c in SERVE_CASES if not c[0].startswith("1x3")]
#: (mesh, arch) of the reference's train and serve steps
REF_TRAIN = [((2, 3), DEEPSEEK), ((2, 3), ZAMBA2), ((1, 8), DEEPSEEK),
             ((1, 8), ZAMBA2)]
REF_SERVE = [((1, 3), DEEPSEEK), ((1, 3), ZAMBA2), ((2, 3), ZAMBA2),
             ((1, 8), DEEPSEEK), ((1, 8), ZAMBA2)]
#: what each case's model axis cuts: the cut of each named cache leaf
#: (past its batch and sequence: R of ``ckv``; N of ``state``; C of
#: ``conv``, "model" or None) and whether the heads are cut
LAYOUTS = {
    "1x3-deepseek": dict(ckv=None, heads=False),
    "2x3-deepseek": dict(ckv=None, heads=False),
    "2x3-deepseek-6heads": dict(ckv=None, heads=True),
    "1x8-deepseek": dict(ckv="model", heads=False),
    "1x3-zamba2": dict(state=[None, None, None], conv="model", heads=False,
                       in_proj=True, out_proj=False),
    "2x3-zamba2": dict(state=[None, None, None], conv="model", heads=False,
                       in_proj=True, out_proj=False),
    "1x8-zamba2": dict(state=[None, "model", None], conv="model",
                       heads=False, in_proj=False, out_proj=True),
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
PERTURB = ("scale", "A_log", "D", "dt_bias")
STEP_TOL = 2e-6
tmodel.CACHE_DTYPE = torch.float32

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

def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree

def cut(t, spec, mesh):
    return torch.from_numpy(_mesh_slice(t.detach().float().numpy(), mesh,
                                        spec))

def dropped(model):
    return sum(int(m.last_dropped) for m in model.modules()
               if isinstance(m, MoE))

def logits_spec(sh, mesh, local):
    """This rank's logits' spec: its rows where the batch axes cut them,
    its vocabulary columns where the model axis cuts the head."""
    rows = local.specs["tokens"][0]
    return (rows, None, None if sh.vocab_axes() is None else "model")

def layout_of(sh):
    return {"/".join(l.path): [list(l.shape), list(l.global_shape)]
            for l in sh.layout.leaves}

def serve(mesh, cfg, tree, prompt, out=None):
    """Prefill and G greedy decode steps on the mesh: against the one
    device's, or (``out``) the whole logits and tokens of each step saved
    there by rank 0."""
    sh = shard.shard_model(model_of(cfg, tree), mesh)
    local = shard.shard_batch(prompt, mesh)
    lspec = logits_spec(sh, mesh, local)
    l2, c2 = sl.make_prefill_step(sh, mesh, max_len=P + G + 8)(local)
    t2 = sl.greedy_token(sh, l2)
    steps, drops = [(l2, t2)], [dropped(sh)]
    dec2 = sl.jit_decode_step(sh, mesh, c2, shd.infer_batch_specs(
        {"tokens": prompt["tokens"][:, :1]}, mesh))
    for i in range(G):
        t2, l2, c2 = dec2({"tokens": t2[:, None]}, c2, P + i)
        steps.append((l2, t2))
        drops.append(dropped(sh))
    if out is not None:
        whole = {}
        for i, (l, t) in enumerate(steps):
            whole[f"logits{i}"] = shard.gather(l, lspec, mesh).numpy()
            whole[f"tokens{i}"] = shard.gather(t, lspec[:1], mesh).numpy()
        if rank == 0:
            np.savez(out, **whole)
        return {}
    one = model_of(cfg, tree)
    l1, c1 = sl.make_prefill_step(one, max_len=P + G + 8)(prompt)
    t1 = sl.greedy_token(one, l1)
    rec = {"logits": 0.0, "tokens_equal": True, "drops_equal": True,
           "caches": 0.0, "cache_shapes": [], "layout": layout_of(sh)}
    for i, (l2, t2) in enumerate(steps):
        if i:
            t1, l1, c1 = sl.make_decode_step(one)({"tokens": t1[:, None]},
                                                  c1, P + i - 1)
        rec["logits"] = max(rec["logits"],
                            float((l2 - cut(l1, lspec, mesh)).abs().max()))
        rec["tokens_equal"] &= bool(torch.equal(
            t2, cut(t1, lspec[:1], mesh).int()))
        rec["drops_equal"] &= dropped(one) == drops[i]
    cspecs = shd.infer_cache_specs(c1, mesh)
    for (p, a), (_, b), (_, s) in zip(flat(c2), flat(c1), flat(cspecs)):
        rec["caches"] = max(rec["caches"], float(
            (a.float() - cut(b, s, mesh)).abs().max()))
        rec["cache_shapes"].append(["/".join(p), list(a.shape), list(
            shd.local_shape(b.shape, s, mesh)), [
                e if e is None or isinstance(e, str) else list(e)
                for e in s]])
    return rec

def serve_case(c):
    cfg = config(c["arch"], c["heads"])
    one = tmodel.build_model(cfg, device="cpu")
    return serve(get_mesh(c["mesh"]), cfg, weights(cfg, 31),
                 prompt_batch(one, 4, P, seed=33))

def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, SEQ)),
           "labels": rng.integers(0, cfg.vocab_size, (ROWS, SEQ))}
    out["labels"][rng.random((ROWS, SEQ)) < 0.2] = -1
    out["labels"][:ROWS // 4 + 1, 2:] = -1     # uneven over data slices
    return {k: torch.from_numpy(v.astype(np.int32)) for k, v in out.items()}

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

def train_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = config(c["arch"], c["heads"])
    tree = weights(cfg, 11)
    batch = make_batch(cfg, 12)
    tcfg = TrainConfig(optimizer="adamw", microbatches=2,
                       learning_rate=1e-3, warmup_steps=1, total_steps=10)
    one = model_of(cfg, tree)
    sh = shard.shard_model(model_of(cfg, tree), mesh)
    local = shard.shard_batch(batch, mesh)
    st1, st2 = tl.make_train_state(one, tcfg), tl.make_train_state(sh, tcfg)
    step1 = tl.make_train_step(one, tcfg)
    step2 = tl.jit_train_step(sh, tcfg, mesh, st2, local.specs)
    rec = {"loss": [], "gnorm": [], "grad_err": 0.0, "grad_worst": "",
           "drops_equal": True}
    for _ in range(2):
        st1, m1 = step1(st1, batch)
        st2, m2 = step2(st2, local)
        rec["drops_equal"] &= dropped(one) == dropped(sh)
        rec["loss"].append([float(m1["loss"]), float(m2["loss"])])
        rec["gnorm"].append([float(m1["grad_norm"]), float(m2["grad_norm"])])
        for leaf, g1, g2 in zip(step2.leaves, step1.grads, step2.grads):
            want = _mesh_slice(g1.numpy(), mesh, leaf.spec)
            tol = 1e-4 * float(g1.abs().max()) + 1e-6
            err = float(np.abs(want - g2.numpy()).max()) / tol
            if err > rec["grad_err"]:
                rec["grad_err"], rec["grad_worst"] = err, "/".join(leaf.path)
    whole1 = tmodel.params_to_numpy(one)
    rec["params"] = param_errs(shard.gather_params(sh), whole1, STEP_TOL)
    sliced = {p: _mesh_slice(v, mesh, leaf.spec) for (p, v), leaf in
              zip(flat(whole1), step2.leaves)}
    rec["param_slices"] = param_errs(
        dict(flat(tmodel.params_to_numpy(sh))), sliced, STEP_TOL)
    rec["resident"] = [shard.resident_bytes(sh), sum(
        4 * int(np.prod(shd.local_shape(l.global_shape, l.spec, mesh)))
        for l in step2.leaves)]
    return rec

def inputs_of(path):
    inp = np.load(path)
    tree = tmodel.nest((tuple(k.split("/")), inp["w:" + k]) for k in
                       [k[2:] for k in inp.files if k.startswith("w:")])
    batch = {k[2:]: torch.from_numpy(inp[k]) for k in inp.files
             if k.startswith("b:")}
    return tree, batch

def ref_train_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = config(c["arch"])
    tree, batch = inputs_of(c["inputs"])
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

def ref_serve_case(c):
    cfg = config(c["arch"])
    tree, batch = inputs_of(c["inputs"])
    return serve(get_mesh(c["mesh"]), cfg, tree, batch, c["out"])

ROWS, SEQ, P, G = work[0]["rows"], work[0]["seq"], work[0]["P"], work[0]["G"]
results = {}
for c in work:
    fn = {"serve": serve_case, "train": train_case,
          "ref_train": ref_train_case, "ref_serve": ref_serve_case}
    results[c["name"]] = fn[c["kind"]](c)
json.dump(results, open(f"{out_dir}/rank{rank}.json", "w"))
mesh_lib.barrier()
dist.destroy_process_group()
print("WORKER-OK")
'''

#: the reference's sharded train step (tests/test_sharding.py's script,
#: two steps) and its prefill and decode jitted with the rules'
#: shardings (float32 caches), on meshes of Auto axes over the first of
#: 8 fake devices, fed the port's weights and batches
REFERENCE = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs.base import TrainConfig
    from repro.models import build_model, model as jmodel
    from repro.runtime.serve_loop import jit_decode_step, make_prefill_step
    from repro.runtime.train_loop import (make_train_state, make_train_step,
                                          state_specs)
    from repro.runtime import sharding as shd
    sys.path.insert(0, "tests")
    from test_smoke_archs import reduce_config
    jax.config.update("jax_platform_name", "cpu")
    jmodel.CACHE_DTYPE = jnp.float32

    def mesh_of(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto),
                             devices=jax.devices()[:shape[0] * shape[1]])

    def load(tree, inp):
        flat = jax.tree_util.tree_flatten_with_path(tree)
        return jax.tree.unflatten(flat[1], [jnp.asarray(inp["w:" + "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in p)])
            for p, _ in flat[0]])

    def train(model, mesh, inp):
        tcfg = TrainConfig(learning_rate=1e-3, microbatches=2, z_loss=0.0,
                           warmup_steps=1, total_steps=10)
        state = make_train_state(model, tcfg, jax.random.PRNGKey(0))
        state["params"] = load(state["params"], inp)
        batch = {k[2:]: jnp.asarray(inp[k]) for k in inp.files
                 if k.startswith("b:")}
        sspecs = state_specs(state, mesh)
        bspecs = shd.infer_batch_specs(batch, mesh)
        step = jax.jit(make_train_step(model, tcfg, mesh),
                       in_shardings=(shd.named(sspecs, mesh),
                                     shd.named(bspecs, mesh)),
                       out_shardings=(shd.named(sspecs, mesh), None))
        out = {}
        for i in range(2):
            state, m = step(state, batch)
            out[f"loss{i}"] = np.asarray(m["loss"])
            for p, v in jax.tree_util.tree_flatten_with_path(
                    state["params"])[0]:
                out[f"p{i}:" + "/".join(
                    str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in p)] = np.asarray(v)
        return out

    def serve(model, mesh, inp, P, G):
        params = load(model.init(jax.random.PRNGKey(0)), inp)
        batch = {"tokens": jnp.asarray(inp["b:tokens"])}
        pspecs = shd.infer_param_specs(params, mesh)
        prefill = jax.jit(make_prefill_step(model, mesh, max_len=P + G + 8),
                          in_shardings=(shd.named(pspecs, mesh), shd.named(
                              shd.infer_batch_specs(batch, mesh), mesh)))
        logits, caches = prefill(params, batch)
        caches = jax.device_put(caches, shd.named(
            shd.infer_cache_specs(caches, mesh), mesh))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        out = {"logits0": np.asarray(logits), "tokens0": np.asarray(tok)}
        bspecs = shd.infer_batch_specs({"tokens": tok[:, None]}, mesh)
        dec = jit_decode_step(model, mesh, params, caches, bspecs)
        for i in range(G):
            # the token laid out as the step's batch specs say (argmax
            # leaves it as the logits' rows lie, which a committed array
            # must not differ from)
            step = jax.device_put({"tokens": tok[:, None]},
                                  shd.named(bspecs, mesh))
            tok, logits, caches = dec(params, step, caches, P + i)
            out[f"logits{i + 1}"] = np.asarray(logits)
            out[f"tokens{i + 1}"] = np.asarray(tok)
        return out

    P, G = int(sys.argv[1]), int(sys.argv[2])
    for job in json.loads(sys.argv[3]):
        model = build_model(reduce_config(get_config(job["arch"])))
        mesh = mesh_of(tuple(job["mesh"]))
        inp = np.load(job["inputs"])
        out = (train(model, mesh, inp) if job["kind"] == "ref_train"
               else serve(model, mesh, inp, P, G))
        np.savez(job["ref"], **out)
    print("REF-OK")
''')


def _name(kind, mesh, arch):
    return f"{kind}-{mesh[0]}x{mesh[1]}-{SHORT[arch]}"


def _ref_inputs(arch, path, seed, train):
    """``arch``'s tiny weights (the port's initialiser, seeded, the norm
    scales and Mamba2's vectors perturbed) and a batch (``train``) or a
    prompt of 4 x ``P``, as the reference's tree flattened to ``w:a/b``
    keys."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import model as tmodel
    cfg = tiny_config(get_config(arch))
    tree = tmodel.params_to_numpy(tmodel.build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed + 1)
    out = {}
    for p, v in tmodel._paths(tree):
        if p[-1] in ("scale", "A_log", "D", "dt_bias"):
            v = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        out["w:" + "/".join(p)] = v
    shape = (B, S) if train else (4, P)
    for k in ("tokens", "labels") if train else ("tokens",):
        out["b:" + k] = rng.integers(0, cfg.vocab_size, shape
                                     ).astype(np.int32)
    np.savez(path, **out)


def _cases(tmp):
    """The port's cases, by world size, and the reference's jobs."""
    serve = [dict(kind="serve", name=n, mesh=list(m), arch=a, heads=h)
             for n, m, a, h in SERVE_CASES]
    train = [dict(kind="train", name="train-" + n, mesh=list(m), arch=a,
                  heads=h) for n, m, a, h in TRAIN_CASES]
    ref = []
    for kind, jobs in (("ref_train", REF_TRAIN), ("ref_serve", REF_SERVE)):
        for m, a in jobs:
            n = _name(kind, m, a)
            ref.append(dict(kind=kind, name=n, mesh=list(m), arch=a,
                            inputs=str(tmp / f"{n}_in.npz"),
                            ref=str(tmp / f"{n}_ref.npz"),
                            out=str(tmp / f"{n}_port.npz")))
    worlds = {}
    for c in serve + train + ref:
        worlds.setdefault(c["mesh"][0] * c["mesh"][1], []).append(
            dict(c, rows=B, seq=S, P=P, G=G))
    return worlds, ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_odd")
    by_world, ref = _cases(tmp)
    for i, job in enumerate(ref):
        _ref_inputs(job["arch"], job["inputs"], 5 + 2 * i,
                    job["kind"] == "ref_train")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    calls = [("reference", [[sys.executable, "-c", REFERENCE, str(P), str(G),
                             json.dumps(ref)]], ALONE_S["reference"])]
    for w, cases in by_world.items():
        (tmp / f"w{w}.json").write_text(json.dumps(cases))
        (tmp / f"out{w}").mkdir()
        calls.append((f"world{w}", [
            [sys.executable, "-c", WORKER, str(r), str(w),
             str(tmp / f"store{w}"), str(tmp / f"w{w}.json"),
             str(tmp / f"out{w}")] for r in range(w)], ALONE_S[w]))
    outs = run_in_turn(calls, env=env, cwd=str(ROOT))
    assert "REF-OK" in outs["reference"][0][1]
    assert all("WORKER-OK" in o for w in by_world
               for _, o, _ in outs[f"world{w}"])
    res = {}
    for w in by_world:
        for r in range(w):
            for name, rec in json.loads(
                    (tmp / f"out{w}" / f"rank{r}.json").read_text()).items():
                res.setdefault(name, []).append(rec)
    return tmp, res


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


@pytest.mark.parametrize("case", [c[0] for c in SERVE_CASES])
def test_odd_mesh_serve_matches_one_device(worlds, case):
    """float32 caches: prefill and 4 decode steps, logits within 2e-4,
    equal greedy tokens and drops, every cache leaf the slice of the
    one-device leaf within 2e-4."""
    for rec in worlds[1][case]:
        assert rec["tokens_equal"] and rec["drops_equal"]
        assert rec["logits"] <= SERVE_TOL, rec["logits"]
        assert rec["caches"] <= SERVE_TOL, rec["caches"]


@pytest.mark.parametrize("case", [c[0] for c in SERVE_CASES])
def test_odd_mesh_caches_and_heads_are_cut_by_the_rules(worlds, case):
    """Every cache leaf has the shape ``infer_cache_specs`` cuts the
    one-device leaf to, and the model axis cuts what ``LAYOUTS`` says:
    MLA's ``ckv`` on R with its heads whole (1, 8), or neither; its
    heads with ``ckv`` whole (6 heads on (2, 3)); Mamba2's conv cache on
    C with the heads whole, its state on N (1, 8) or whole, and
    ``in_proj`` and ``out_proj`` each on its own cut."""
    want = LAYOUTS[case]
    for rec in worlds[1][case]:
        seen = set()
        for path, got, shape, spec in rec["cache_shapes"]:
            assert got == shape, (path, got, shape)
            name = path.split("/")[-1]
            if name == "ckv":
                assert spec[-1] == want["ckv"], (path, spec)
            elif name == "state":
                assert spec[-3:] == want["state"], (path, spec)
            elif name == "conv":
                assert spec[-1] == want["conv"], (path, spec)
            seen.add(name)
        assert seen >= set(want) - {"heads", "in_proj", "out_proj"}
        layout = rec["layout"]
        for leaf, (local, whole) in layout.items():
            name = leaf.split("/")[-1]
            if name in ("wk_b", "wv_b", "wq_b"):
                assert (local[-2] != whole[-2]) == want["heads"], leaf
            elif name in ("in_proj", "out_proj"):
                dim = -1 if name == "in_proj" else -2
                assert (local[dim] != whole[dim]) == want[name], leaf


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_odd_mesh_train_step_matches_one_device(worlds, case):
    """Loss and grad norm within 1e-5 relative, every gradient leaf's
    slice within 1e-4 of its largest |g|, the parameters (whole and as
    this rank's slices) after two steps, equal drops, and the resident
    parameters exactly the slices' bytes."""
    for rec in worlds[1]["train-" + case]:
        for one, sharded in rec["loss"] + rec["gnorm"]:
            assert _close(sharded, one, METRIC_RTOL), (one, sharded)
        assert rec["grad_err"] <= 1.0, (rec["grad_err"], rec["grad_worst"])
        assert rec["drops_equal"]
        for key in ("params", "param_slices"):
            within, past, total, worst = rec[key]
            assert within <= STEP_TOL, (key, within)
            assert past <= 1e-3 * total, (key, past, total)
            assert worst <= 2 * LR + STEP_TOL, (key, worst)
        assert rec["resident"][0] == rec["resident"][1], rec["resident"]


@pytest.mark.parametrize("mesh,arch", REF_TRAIN,
                         ids=[_name("ref_train", m, a) for m, a in REF_TRAIN])
def test_odd_mesh_train_step_matches_the_reference_sharded_step(
        worlds, mesh, arch):
    """The port's step against the reference's on the same mesh of Auto
    axes: the reference test's tolerances, on every parameter."""
    tmp, res = worlds
    name = _name("ref_train", mesh, arch)
    ref = np.load(tmp / f"{name}_ref.npz")
    port = np.load(tmp / f"{name}_port.npz")
    for i in range(2):
        for rec in res[name]:
            np.testing.assert_allclose(rec["loss"][i], float(ref[f"loss{i}"]),
                                       rtol=REF_LOSS_RTOL)
        keys = [k for k in ref.files if k.startswith(f"p{i}:")]
        assert keys and set(keys) == {k for k in port.files
                                      if k.startswith(f"p{i}:")}
        for k in keys:
            np.testing.assert_allclose(port[k], ref[k], atol=REF_PARAM_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("mesh,arch", REF_SERVE,
                         ids=[_name("ref_serve", m, a) for m, a in REF_SERVE])
def test_odd_mesh_serve_matches_the_reference_sharded_serve(worlds, mesh,
                                                            arch):
    """The port's prefill and decode (the ranks' logits and tokens
    gathered) against the reference's jitted with the rules' shardings:
    logits within 2e-4, equal tokens."""
    tmp, _ = worlds
    name = _name("ref_serve", mesh, arch)
    ref = np.load(tmp / f"{name}_ref.npz")
    port = np.load(tmp / f"{name}_port.npz")
    for i in range(G + 1):
        np.testing.assert_array_equal(port[f"tokens{i}"], ref[f"tokens{i}"])
        np.testing.assert_allclose(port[f"logits{i}"], ref[f"logits{i}"],
                                   rtol=0, atol=SERVE_TOL)
