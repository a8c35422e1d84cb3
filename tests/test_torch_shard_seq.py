"""Sequence-sharded caches and batches on the mesh: KV heads that the
model axis does not divide (``wk``/``wv`` whole on each model rank, the
cache cut on its sequence over the model axis, flash-decode, or on Dh)
and batches that the batch axes do not divide (a batch of 1, or 3 on 2
data ranks: the sequence cut over them, context parallelism), on gloo
worlds of CPU processes against the port's one-device steps, and
against the JAX package's sharded prefill and decode.

Each world runs once (a module fixture: ``_worlds.run_in_turn`` runs
the reference's process, then each world, one after another); every
rank builds the same tiny model from a seed (``tiny_config``: 4 query
heads over 2 KV heads, float32; ``kv`` overrides the KV heads), with
the norm scales, biases and recurrent vectors perturbed, runs the
one-device step on the whole batch and the sharded step on its slice
(``shard.shard_batch``, which carries the global specs), and writes
what it measured:

* serve: prefill and greedy decode steps with float32 caches; every
  step's logits within 2e-4 of the one device's (this rank's rows where
  the batch axes cut them, its vocabulary columns), equal tokens and
  MoE drop counts, and every cache leaf in shape and value (2e-4) the
  slice ``infer_cache_specs`` gives of the one-device leaf. Every family
  at a batch of 1 on (2, 2) (the sequence and the KV, latent and memory
  caches cut over the data axis); a dense config with one KV head at a
  batch of 1 on (2, 2) (the cache cut on S over data and Dh over model);
  the families with GQA at 2 KV heads on (1, 4) (the cache cut on S over
  the model axis, flash-decode); a dense config at a batch of 1 on
  (1, 4) (Dh); dense and arctic's MoE at a batch of 3 on (2, 2).
* train: loss and grad norm within 1e-5 relative, and every gradient
  leaf within 1e-4 of its largest |g| (+1e-6) as this rank's slice of
  the one device's, ``wk``/``wv``/``bk``/``bv`` among them: KV heads the
  model axis does not divide on (1, 4) and (2, 2), batches of 1 and 3
  on (2, 2) (their sequence cut; with remat, whose recompute runs under
  the forward's cut, for dense, zamba2 and seamless), and microbatches
  of one row on (2, 2).
* the JAX package's prefill and decode steps jitted with the rules'
  shardings on an Auto-axis (2, 4) mesh (8 fake CPU devices, its own
  process, float32 caches) at ``tests/test_smoke_archs.py``'s
  ``reduce_config``, fed the same weights and prompt as the port's steps
  on a (2, 4) world: logits within 2e-4 and equal tokens, at a batch of
  1 (the cache cut on S over data and on Dh over model) and of 2 (S over
  model).
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
ALONE_S = {"reference": 11, 4: 16, 8: 7}
SERVE_TOL = 2e-4
METRIC_RTOL = 1e-5
P, G = 8, 4

#: (name, mesh, arch, batch, KV heads (None: the config's))
SERVE_CASES = [
    *[(f"2x2-b1-{n}", (2, 2), a, 1, None) for n, a in (
        ("dense", "qwen2.5-3b"), ("vlm", "qwen2-vl-7b"),
        ("deepseek", "deepseek-v2-236b"), ("arctic", "arctic-480b"),
        ("xlstm", "xlstm-1.3b"), ("zamba2", "zamba2-7b"),
        ("seamless", "seamless-m4t-medium"))],
    ("2x2-b1-dense-kv1", (2, 2), "qwen2.5-3b", 1, 1),
    ("2x2-b3-dense", (2, 2), "qwen2.5-3b", 3, None),
    ("2x2-b3-arctic", (2, 2), "arctic-480b", 3, None),
    ("1x4-kv-dense", (1, 4), "qwen2.5-3b", 4, None),
    ("1x4-kv-vlm", (1, 4), "qwen2-vl-7b", 4, None),
    ("1x4-kv-arctic", (1, 4), "arctic-480b", 4, None),
    ("1x4-kv-zamba2", (1, 4), "zamba2-7b", 4, 2),
    ("1x4-kv-seamless", (1, 4), "seamless-m4t-medium", 4, None),
    ("1x4-b1-dense", (1, 4), "qwen2.5-3b", 1, None),
]
#: (name, mesh, arch, rows, microbatches, KV heads, remat)
TRAIN_CASES = [
    ("1x4-kv-dense", (1, 4), "qwen2.5-3b", 4, 2, None, "none"),
    ("2x2-kv1-dense", (2, 2), "qwen2.5-3b", 4, 1, 1, "none"),
    ("2x2-b1-dense", (2, 2), "qwen2.5-3b", 1, 1, None, "none"),
    ("2x2-b1-dense-remat", (2, 2), "qwen2.5-3b", 1, 1, None, "block"),
    ("2x2-b1-vlm", (2, 2), "qwen2-vl-7b", 1, 1, None, "none"),
    ("2x2-b3-arctic", (2, 2), "arctic-480b", 3, 1, None, "none"),
    ("2x2-b1-deepseek", (2, 2), "deepseek-v2-236b", 1, 1, None, "none"),
    ("2x2-b1-zamba2", (2, 2), "zamba2-7b", 1, 1, 2, "full"),
    ("2x2-b1-xlstm", (2, 2), "xlstm-1.3b", 1, 1, None, "none"),
    ("2x2-b1-seamless", (2, 2), "seamless-m4t-medium", 1, 1, None, "full"),
    ("2x2-mb-rows-dense", (2, 2), "qwen2.5-3b", 4, 4, None, "none"),
]
#: (name, arch, batch) of the reference's (2, 4) serve
REF_CASES = [("ref-b1-dense", "qwen2.5-3b", 1),
             ("ref-b2-dense", "qwen2.5-3b", 2)]

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
P, G = work[0]["P"], work[0]["G"]
torch.manual_seed(0)
mesh_lib.init_group("gloo", init_method="file://" + store, rank=rank,
                    world_size=world, device="cpu", timeout_s=120)
meshes = {}
PERTURB = ("scale", "A_log", "D", "dt_bias", "if_bias", "bias", "bq", "bk",
           "bv")
tmodel.CACHE_DTYPE = torch.float32

def get_mesh(shape):
    if tuple(shape) not in meshes:
        meshes[tuple(shape)] = mesh_lib.make_host_mesh(
            *shape, backend="gloo", device="cpu")
    return meshes[tuple(shape)]

def config(arch, kv=None):
    cfg = tiny_config(get_config(arch))
    if kv is not None:
        cfg = cfg.replace(kv_heads=kv)
    if cfg.moe is not None:       # a capacity that drops
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
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

def logits_spec(mesh, rows):
    return (shd.logits_spec(mesh)[0] if rows else None, None, "model")

def serve(mesh, cfg, tree, prompt, gen):
    """The one device's and this rank's logits, tokens and caches."""
    one, sh = model_of(cfg, tree), shard.shard_model(model_of(cfg, tree),
                                                     mesh)
    rows = shd.infer_batch_specs(prompt, mesh)["tokens"][0] is not None
    lspec = logits_spec(mesh, rows)
    rec = {"logits": 0.0, "tokens_equal": True, "drops_equal": True,
           "caches": 0.0, "cache_shapes": [], "tokens": []}
    l1, c1 = sl.make_prefill_step(one, max_len=P + gen + 8)(prompt)
    l2, c2 = sl.make_prefill_step(sh, mesh, max_len=P + gen + 8)(
        shard.shard_batch(prompt, mesh))

    def score(l1, l2, t1, t2):
        rec["logits"] = max(rec["logits"],
                            float((l2 - cut(l1, lspec, mesh)).abs().max()))
        rec["tokens_equal"] &= bool(torch.equal(
            t2, cut(t1, lspec[:1], mesh).int()))
        rec["drops_equal"] &= dropped(one) == dropped(sh)
        rec["tokens"].append(t2.tolist())
    t1, t2 = sl.greedy_token(one, l1), sl.greedy_token(sh, l2)
    score(l1, l2, t1, t2)
    rec["prefill_drops"] = dropped(sh)
    start = P + (tmodel.VLM_PATCHES if cfg.family == "vlm" else 0)
    step = {"tokens": t1[:, None]}
    dec1 = sl.make_decode_step(one)
    dec2 = sl.jit_decode_step(sh, mesh, c2, shd.infer_batch_specs(step,
                                                                  mesh))
    for i in range(gen):
        t1, l1, c1 = dec1({"tokens": t1[:, None]}, c1, start + i)
        t2, l2, c2 = dec2({"tokens": t2[:, None]}, c2, start + i)
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

def serve_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = config(c["arch"], c["kv"])
    one = tmodel.build_model(cfg, device="cpu")
    return serve(mesh, cfg, weights(cfg, 31),
                 prompt_batch(one, c["batch"], P, seed=33), G)

def make_batch(cfg, seed, rows, seq):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (rows, seq)),
           "labels": rng.integers(0, cfg.vocab_size, (rows, seq))}
    out["labels"][rng.random((rows, seq)) < 0.3] = -1
    out = {k: v.astype(np.int32) for k, v in out.items()}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (rows, 8, cfg.d_model)).astype(np.float32)
        pos = np.arange(8 + seq, dtype=np.int32)
        out["positions3"] = np.ascontiguousarray(np.broadcast_to(
            np.stack([pos, pos // 2, pos // 3])[:, None], (3, rows, 8 + seq)))
    if cfg.family in ("encdec", "audio"):
        out["frames"] = rng.standard_normal(
            (rows, seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}

def train_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = config(c["arch"], c["kv"]).replace(remat=c["remat"])
    tree = weights(cfg, 11)
    batch = make_batch(cfg, 12, c["rows"], 16)
    tcfg = TrainConfig(optimizer="adamw", microbatches=c["M"],
                       learning_rate=1e-3, warmup_steps=1, total_steps=10)
    one = model_of(cfg, tree)
    sh = shard.shard_model(model_of(cfg, tree), mesh)
    st1, st2 = tl.make_train_state(one, tcfg), tl.make_train_state(sh, tcfg)
    step1 = tl.make_train_step(one, tcfg)
    step2 = tl.jit_train_step(sh, tcfg, mesh, st2,
                              shd.infer_batch_specs(batch, mesh))
    local = shard.shard_batch(batch, mesh)
    rec = {"loss": [], "gnorm": [], "grad_err": 0.0, "grad_worst": "",
           "kv_grads": {}}
    for _ in range(2):
        st1, m1 = step1(st1, batch)
        st2, m2 = step2(st2, local)
        rec["loss"].append([float(m1["loss"]), float(m2["loss"])])
        rec["gnorm"].append([float(m1["grad_norm"]), float(m2["grad_norm"])])
        for leaf, g1, g2 in zip(step2.leaves, step1.grads, step2.grads):
            want = _mesh_slice(g1.numpy(), mesh, leaf.spec)
            tol = 1e-4 * float(g1.abs().max()) + 1e-6
            err = float(np.abs(want - g2.numpy()).max()) / tol
            if leaf.path[-1] in ("wk", "wv", "bk", "bv"):
                name = "/".join(leaf.path)
                rec["kv_grads"][name] = max(rec["kv_grads"].get(name, 0.0),
                                            err)
            if err > rec["grad_err"]:
                rec["grad_err"], rec["grad_worst"] = err, "/".join(leaf.path)
    return rec

def ref_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = tiny_config(get_config(c["arch"]))
    inp = np.load(c["inputs"])
    tree = tmodel.nest((tuple(k.split("/")), inp["w:" + k]) for k in
                       [k[2:] for k in inp.files if k.startswith("w:")])
    prompt = {"tokens": torch.from_numpy(inp["b:tokens"])}
    sh = shard.shard_model(model_of(cfg, tree), mesh)
    rows = shd.infer_batch_specs(prompt, mesh)["tokens"][0] is not None
    lspec = logits_spec(mesh, rows)
    l2, c2 = sl.make_prefill_step(sh, mesh, max_len=c["max_len"])(
        shard.shard_batch(prompt, mesh))
    t2 = sl.greedy_token(sh, l2)
    steps = [(l2, t2)]
    dec = sl.jit_decode_step(sh, mesh, c2, shd.infer_batch_specs(
        {"tokens": prompt["tokens"][:, :1]}, mesh))
    for i in range(c["gen"]):
        t2, l2, c2 = dec({"tokens": t2[:, None]}, c2, P + i)
        steps.append((l2, t2))
    ref = np.load(c["ref"])
    rec = {"logits": 0.0, "tokens_equal": True}
    for i, (l, t) in enumerate(steps):
        want = cut(torch.from_numpy(ref[f"logits{i}"]), lspec, mesh)
        rec["logits"] = max(rec["logits"], float((l - want).abs().max()))
        rec["tokens_equal"] &= bool(torch.equal(t, cut(torch.from_numpy(
            ref[f"tokens{i}"]), lspec[:1], mesh).int()))
    return rec

results = {}
for c in work:
    fn = {"serve": serve_case, "train": train_case, "ref": ref_case}
    results[c["name"]] = fn[c["kind"]](c)
json.dump(results, open(f"{out_dir}/rank{rank}.json", "w"))
mesh_lib.barrier()
dist.destroy_process_group()
print("WORKER-OK")
'''

#: the reference's prefill and decode steps jitted with the rules'
#: shardings on a (2, 4) mesh of Auto axes, float32 caches
REFERENCE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.models import build_model, model as jmodel
    from repro.runtime import sharding as shd
    from repro.runtime.serve_loop import jit_decode_step, make_prefill_step
    sys.path.insert(0, "tests")
    from test_smoke_archs import reduce_config
    jax.config.update("jax_platform_name", "cpu")
    jmodel.CACHE_DTYPE = jnp.float32

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    P, G = int(sys.argv[1]), int(sys.argv[2])
    for arch, src, dst in zip(sys.argv[3].split(","), sys.argv[4::2],
                              sys.argv[5::2]):
        inp = np.load(src)
        model = build_model(reduce_config(get_config(arch)))
        params = model.init(jax.random.PRNGKey(0))
        flat = jax.tree_util.tree_flatten_with_path(params)
        params = jax.tree.unflatten(flat[1], [jnp.asarray(inp["w:" + "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in p)])
            for p, _ in flat[0]])
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
        step = {"tokens": tok[:, None]}
        dec = jit_decode_step(model, mesh, params, caches,
                              shd.infer_batch_specs(step, mesh))
        for i in range(G):
            tok, logits, caches = dec(params, {"tokens": tok[:, None]},
                                      caches, P + i)
            out[f"logits{i + 1}"] = np.asarray(logits)
            out[f"tokens{i + 1}"] = np.asarray(tok)
        np.savez(dst, **out)
    print("REF-OK")
''')


def _ref_inputs(arch, batch, path):
    """``arch``'s tiny weights (the port's initialiser, seeded, the norm
    scales and biases perturbed) and a prompt, as the reference's tree
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
        if p[-1] in ("scale", "bq", "bk", "bv"):
            v = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        out["w:" + "/".join(p)] = v
    out["b:tokens"] = rng.integers(0, cfg.vocab_size, (batch, P)
                                   ).astype(np.int32)
    np.savez(path, **out)


def _cases(tmp):
    serve = [dict(kind="serve", name=n, mesh=list(m), arch=a, batch=b, kv=k)
             for n, m, a, b, k in SERVE_CASES]
    train = [dict(kind="train", name="train-" + n, mesh=list(m), arch=a,
                  rows=r, M=M, kv=k, remat=x)
             for n, m, a, r, M, k, x in TRAIN_CASES]
    ref = [dict(kind="ref", name=n, mesh=[2, 4], arch=a, max_len=P + G + 8,
                gen=G, inputs=str(tmp / f"{n}_in.npz"),
                ref=str(tmp / f"{n}_ref.npz")) for n, a, _ in REF_CASES]
    return {w: [dict(c, P=P, G=G) for c in cases]
            for w, cases in ((4, serve + train), (8, ref))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_seq")
    ref_args = []
    for n, a, b in REF_CASES:
        _ref_inputs(a, b, tmp / f"{n}_in.npz")
        ref_args += [str(tmp / f"{n}_in.npz"), str(tmp / f"{n}_ref.npz")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    calls = [("reference", [[sys.executable, "-c", REFERENCE, str(P), str(G),
                             ",".join(a for _, a, _ in REF_CASES),
                             *ref_args]], ALONE_S["reference"])]
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
    return {w: [json.loads((tmp / f"out{w}" / f"rank{r}.json").read_text())
                for r in range(w)] for w in (4, 8)}


def _ranks(worlds, name):
    return [r[name] for r in worlds[8 if name.startswith("ref-") else 4]]


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


@pytest.mark.parametrize("case", [c[0] for c in SERVE_CASES])
def test_sequence_sharded_serve_matches_one_device(worlds, case):
    """float32 caches: prefill and decode steps, logits within 2e-4,
    equal greedy tokens and drop counts (arctic's batch of 3 drops in
    its prefill), every cache leaf the slice of the one-device leaf
    within 2e-4."""
    for rec in _ranks(worlds, case):
        assert rec["tokens_equal"] and rec["drops_equal"], rec["tokens"]
        assert rec["logits"] <= SERVE_TOL, rec["logits"]
        assert rec["caches"] <= SERVE_TOL, rec["caches"]
        if case == "2x2-b3-arctic":   # the capacity drops assignments
            assert rec["prefill_drops"] > 0, rec["prefill_drops"]


@pytest.mark.parametrize("case", [c[0] for c in SERVE_CASES])
def test_sequence_sharded_caches_are_laid_out_by_the_rules(worlds, case):
    """Each cache leaf has the shape ``infer_cache_specs`` cuts the
    one-device leaf to; at a batch of 1 the KV, latent and memory caches
    are cut on S over the data axis, and where the model axis does not
    divide the KV heads, on S over it or on Dh."""
    mesh, batch, kv = next((m, b, k) for n, m, _, b, k in SERVE_CASES
                           if n == case)
    # (S, Dh) of a KV cache: a batch the data axis does not divide cuts
    # S over it (also one of size 1); 2 KV heads on a model axis of 4, or
    # 1 on 2, leave S to the model axis, or else Dh
    want_kv = {(2, 2): ("data", "model" if kv == 1 else None),
               (1, 4): ("data", "model") if batch == 1 else ("model", None)
               }[mesh]
    for rec in _ranks(worlds, case):
        specs = {}
        for path, got, shape, spec in rec["cache_shapes"]:
            assert got == shape, (path, got, shape)
            specs[path.split("/")[-1]] = spec
        if "k" in specs:
            assert (specs["k"][-3], specs["k"][-1]) == want_kv, specs["k"]
        for name in ("ckv", "k_rope", "memory"):
            if name in specs and batch < 4:
                assert specs[name][-2] == "data", (name, specs[name])


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_sequence_sharded_train_step_matches_one_device(worlds, case):
    """Loss and grad norm within 1e-5 relative over two steps, every
    gradient leaf (``wk``/``wv``/``bk``/``bv`` where the model axis does
    not divide the KV heads) within 1e-4 of its largest |g|."""
    for rec in _ranks(worlds, "train-" + case):
        for one, sharded in rec["loss"] + rec["gnorm"]:
            assert _close(sharded, one, METRIC_RTOL), (one, sharded)
        assert rec["grad_err"] <= 1.0, (rec["grad_err"], rec["grad_worst"])
        for name, err in rec["kv_grads"].items():
            assert err <= 1.0, (name, err)


@pytest.mark.parametrize("case", [c[0] for c in REF_CASES])
def test_sequence_sharded_serve_matches_the_reference_sharded_serve(
        worlds, case):
    """The port's (2, 4) prefill and decode against the reference's
    jitted with the rules' shardings: logits within 2e-4, equal
    tokens."""
    for rec in _ranks(worlds, case):
        assert rec["tokens_equal"]
        assert rec["logits"] <= SERVE_TOL, rec["logits"]


def test_kv_heads_fewer_than_the_model_axis_have_their_gradients_summed(
        worlds):
    """On (1, 4) the dense config's 2 KV heads are whole on each model
    rank: ``wk``, ``wv``, ``bk`` and ``bv`` are held, and their
    gradients equal the one device's."""
    for rec in _ranks(worlds, "train-1x4-kv-dense"):
        names = {n.split("/")[-1] for n in rec["kv_grads"]}
        assert names == {"wk", "wv", "bk", "bv"}, names
