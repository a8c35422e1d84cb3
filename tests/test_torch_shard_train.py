"""The sharded train step (``runtime.train_loop`` on a mesh,
``runtime.shard``) on gloo worlds of CPU processes, against the port's
one-device step and against the JAX package's sharded step.

Each world runs once (a module fixture: ``_worlds.run_in_turn`` runs
the reference's process, then each world, one after another); every
rank builds the same tiny model from a seed (``tiny_config``, float32,
norm scales and biases perturbed), runs the one-device step on the whole
batch and the sharded step on its rows, and writes what it measured:

* (2, 2) "2d": a dense config with QKV bias and a tied head
  (qwen2.5-3b's) and the vlm (patches, M-RoPE), AdamW and Adafactor;
  the dense one again with remat "block"; (4, 1) "fsdp_only"; (4, 2)
  in a world of 8 with an untied head (llama3-8b's). Two microbatches,
  two steps (the first at lr 0), labels −1 on most of the first rows'
  positions (so the data slices hold unequal counts). Held: loss and
  grad norm within 1e-5 relative; every gradient leaf within 1e-4 of
  its largest |g| (+1e-6), as this rank's slice of the one-device
  accumulator (``_mesh_slice`` by its spec); every parameter after the
  steps within 2e-6, or within 2·lr on at most 1e-3 of the elements
  (Adam's sign flips), whole (gathered) and as this rank's slice; the
  optimizer state as the slice of the one-device state (same rule);
  the resident parameters, optimizer state and accumulators exactly
  the slices' bytes.
* checkpoints on (2, 2): the gathered state of a sharded step resumes on
  one device with the next loss of the sharded run; a one-device save
  restores onto the mesh through ``CheckpointManager.restore(
  shardings=placements(state_specs(...)))``, and the one-device state
  sliced in memory (``shard.slice_state``) loads there, each with the
  one-device next loss.
* a bfloat16 row-parallel product (``mesh_ctx.row_parallel``) on
  (2, 2) rounds once, as one device's product does.
* a step on a model that is not laid out on the mesh raises; the
  layouts that earlier slices refused run since the sequence slice, one
  step each against the one device (loss and grad norm within 1e-5
  relative, every gradient leaf within 1e-4 of its largest |g|): one KV
  head on a model axis of 2 (``kv-heads``: ``wk``/``wv``/``bk``/``bv``
  whole on each model rank, their gradients summed over it), a batch of
  1 (``batch-1``: its sequence cut over the data axis; ``ssm-family``:
  xlstm's at a batch of 1) and 4 microbatches of 4 rows on 2 data ranks
  (``microbatch-rows``: each microbatch's row cut on its sequence).
* the JAX package's sharded step on an Auto-axis (4, 2) mesh (8 fake
  CPU devices, in its own process; ``jax.make_mesh`` makes Explicit
  axes in jax 0.9, on which the reference's own test fails) at
  ``tests/test_sharding.py``'s ``reduce_config`` of llama3-8b, fed the
  same weights and batch: loss within rtol 2e-4 and every parameter
  within 3e-4 after each of two steps, the reference test's tolerances.
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
ALONE_S = {"reference": 17, 4: 19, 8: 12}
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
METRIC_RTOL = 1e-5
STEP_TOL, FLIP_SHARE = 2e-6, 1e-3
LR = 1e-3
REF_LOSS_RTOL, REF_PARAM_ATOL = 2e-4, 3e-4
B, S = 8, 16

#: (name, world, mesh, profile, arch, optimizer, remat)
TRAIN_CASES = [
    ("2x2-dense-adamw", 4, (2, 2), "2d", "qwen2.5-3b", "adamw", "none"),
    ("2x2-dense-adafactor", 4, (2, 2), "2d", "qwen2.5-3b", "adafactor",
     "none"),
    ("2x2-vlm-adamw", 4, (2, 2), "2d", "qwen2-vl-7b", "adamw", "none"),
    ("2x2-vlm-adafactor", 4, (2, 2), "2d", "qwen2-vl-7b", "adafactor",
     "none"),
    ("2x2-dense-remat", 4, (2, 2), "2d", "qwen2.5-3b", "adamw", "block"),
    ("4x1-fsdp_only-dense", 4, (4, 1), "fsdp_only", "qwen2.5-3b", "adamw",
     "none"),
    ("4x1-fsdp_only-vlm", 4, (4, 1), "fsdp_only", "qwen2-vl-7b",
     "adafactor", "none"),
    ("4x2-dense-adafactor", 8, (4, 2), "2d", "llama3-8b", "adafactor",
     "none"),
    ("4x2-vlm-adamw", 8, (4, 2), "2d", "qwen2-vl-7b", "adamw", "none"),
]
RAISES = ("ssm-family", "kv-heads", "batch-1", "microbatch-rows",
          "unsharded-model")
#: the cases of ``RAISES`` that run since the sequence slice
RUNS = ("ssm-family", "kv-heads", "batch-1", "microbatch-rows")

WORKER = r'''
import json, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.checkpoint.manager import CheckpointManager, _mesh_slice
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import tiny_config
from repro_torch.models import model as tmodel
from repro_torch.runtime import shard, sharding as shd, train_loop as tl

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
            elif k in ("bq", "bk", "bv"):
                t[k] = (0.1 * rng.standard_normal(v.shape)).astype(
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
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (rows, 8, cfg.d_model)).astype(np.float32)
        pos = np.arange(8 + seq, dtype=np.int32)
        out["positions3"] = np.ascontiguousarray(np.broadcast_to(
            np.stack([pos, pos // 2, pos // 3])[:, None], (3, rows, 8 + seq)))
    return {k: torch.from_numpy(v) for k, v in out.items()}

def tcfg_of(optimizer, M=2):
    return TrainConfig(optimizer=optimizer, microbatches=M,
                       learning_rate=1e-3, warmup_steps=1, total_steps=10)

def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree

def param_errs(got, want, tol):
    """(largest |Δ| within tol, elements past tol, elements, largest
    |Δ|) over two trees of arrays."""
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

def train_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = tiny_config(get_config(c["arch"])).replace(remat=c["remat"])
    tree = weights(cfg, 11)
    batch = make_batch(cfg, 12, c["rows"], c["seq"])
    tcfg = tcfg_of(c["optimizer"])
    one = model_of(cfg, tree)
    st1 = tl.make_train_state(one, tcfg)
    step1 = tl.make_train_step(one, tcfg)
    sh = shard.shard_model(model_of(cfg, tree), mesh, c["profile"])
    st2 = tl.make_train_state(sh, tcfg)
    bspecs = shd.infer_batch_specs(batch, mesh, c["profile"])
    step2 = tl.jit_train_step(sh, tcfg, mesh, st2, bspecs, c["profile"])
    local = shard.shard_batch(batch, mesh, c["profile"])
    rec = {"loss": [], "gnorm": [], "grad_err": 0.0}
    for _ in range(2):
        st1, m1 = step1(st1, batch)
        st2, m2 = step2(st2, local)
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
    sizes = shd.mesh_shape(mesh)
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

def ckpt_case(c, tmp):
    mesh = get_mesh(c["mesh"])
    cfg = tiny_config(get_config(c["arch"]))
    tree = weights(cfg, 21)
    batch = make_batch(cfg, 22, c["rows"], c["seq"])
    tcfg = tcfg_of("adamw")
    one = model_of(cfg, tree)
    st1 = tl.make_train_state(one, tcfg)
    step1 = tl.make_train_step(one, tcfg)
    sh = shard.shard_model(model_of(cfg, tree), mesh)
    st2 = tl.make_train_state(sh, tcfg)
    step2 = tl.make_train_step(sh, tcfg, mesh)
    local = shard.shard_batch(batch, mesh)
    abstract = shard.abstract_state(cfg, tcfg)
    for _ in range(2):
        st1, _ = step1(st1, batch)
        st2, _ = step2(st2, local)
    gathered = shard.gather_state(st2, abstract)
    ck_a, ck_b = CheckpointManager(tmp + "/a", async_save=False), \
        CheckpointManager(tmp + "/b", async_save=False)
    if mesh_lib.mesh_writer(mesh):
        ck_a.save(2, gathered)
        ck_b.save(2, tl.train_state_tree(st1))
    mesh_lib.barrier()
    # a (2, 2) save resumed on one device
    fresh = model_of(cfg, tree)
    st3 = tl.make_train_state(fresh, tcfg)
    restored, _ = ck_a.restore(tl.train_state_tree(st3))
    st3 = tl.load_train_state(st3, restored)
    step3 = tl.make_train_step(fresh, tcfg)
    _, m3 = step3(st3, batch)
    _, m2 = step2(st2, local)
    # a one-device save restored onto the mesh
    sh4 = shard.shard_model(tmodel.build_model(cfg, device="cpu"), mesh)
    st4 = tl.make_train_state(sh4, tcfg)
    like = {"params": abstract["params"], "opt": st4["opt"],
            "step": st4["step"]}
    places = shd.placements(tl.state_specs(abstract, mesh), mesh)
    tree4, _ = ck_b.restore(like, shardings=places)
    st4 = tl.load_train_state(st4, tree4)
    step4 = tl.make_train_step(sh4, tcfg, mesh)
    _, m4 = step4(st4, local)
    # the same one-device state sliced in memory
    sh5 = shard.shard_model(tmodel.build_model(cfg, device="cpu"), mesh)
    st5 = tl.load_train_state(tl.make_train_state(sh5, tcfg),
                              shard.slice_state(tl.train_state_tree(st1),
                                                abstract, mesh))
    _, m5 = tl.make_train_step(sh5, tcfg, mesh)(st5, local)
    _, m1 = step1(st1, batch)
    return {"mesh_to_one": [float(m2["loss"]), float(m3["loss"])],
            "one_to_mesh": [float(m1["loss"]), float(m4["loss"])],
            "one_to_mesh_in_memory": [float(m1["loss"]), float(m5["loss"])],
            "step": [int(st3["step"]), int(st4["step"]), int(st5["step"])]}

def step_vs_one(mesh, cfg, rows, M):
    """One step of ``rows`` rows in ``M`` microbatches on the mesh
    (``shard_batch``'s slice) and on one device: (losses, grad norms,
    the largest gradient error over 1e-4 of the leaf's largest |g|)."""
    tree = weights(cfg, 41)
    batch = make_batch(cfg, 42, rows, 16)
    tcfg = tcfg_of("adamw", M=M)
    one = model_of(cfg, tree)
    sh = shard.shard_model(model_of(cfg, tree), mesh)
    step1, step2 = tl.make_train_step(one, tcfg), tl.make_train_step(
        sh, tcfg, mesh)
    _, m1 = step1(tl.make_train_state(one, tcfg), batch)
    _, m2 = step2(tl.make_train_state(sh, tcfg), shard.shard_batch(batch,
                                                                   mesh))
    err = max(float(np.abs(_mesh_slice(g1.numpy(), mesh, leaf.spec)
                           - g2.numpy()).max())
              / (1e-4 * float(g1.abs().max()) + 1e-6)
              for leaf, g1, g2 in zip(step2.leaves, step1.grads,
                                      step2.grads))
    return {"loss": [float(m1["loss"]), float(m2["loss"])],
            "gnorm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
            "grad_err": err}

def raises_case(c):
    mesh = get_mesh(c["mesh"])
    dense = tiny_config(get_config("qwen2.5-3b"))
    out = {"ssm-family": step_vs_one(
               mesh, tiny_config(get_config("xlstm-1.3b")), 1, 1),
           "kv-heads": step_vs_one(mesh, dense.replace(kv_heads=1), 4, 1),
           "batch-1": step_vs_one(mesh, dense, 1, 1),
           "microbatch-rows": step_vs_one(mesh, dense, 4, 4)}
    try:
        tl.make_train_step(tmodel.build_model(dense, device="cpu"),
                           tcfg_of("adamw"), mesh)
        out["unsharded-model"] = "ran"
    except ValueError as e:
        out["unsharded-model"] = "raised: " + str(e)[:200]
    return out

def ref_case(c):
    mesh = get_mesh(c["mesh"])
    cfg = tiny_config(get_config(c["arch"]))
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

def ulps(a, b):
    """|a − b| of bfloat16 tensors in units of b's last place."""
    a, b = a.float(), b.float()
    e = torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -120)))
    return ((a - b).abs() / torch.exp2(e - 7)).max().item()

def rowpar_case(c):
    """``mesh_ctx.row_parallel`` at bfloat16 against one device's product:
    the partials at float32, the sum rounded once."""
    from repro_torch.runtime import mesh_ctx
    mesh = get_mesh(c["mesh"])
    tp = mesh_ctx.axes_of(mesh, "model")
    gen = torch.Generator().manual_seed(31)
    x = torch.randn(4, 8, 256, generator=gen).to(torch.bfloat16)
    w = (torch.randn(256, 96, generator=gen) / 16).to(torch.bfloat16)
    g = torch.randn(4, 8, 96, generator=gen).to(torch.bfloat16)
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    y1 = x1 @ w1
    y1.backward(g)
    n = 256 // tp.size
    xl = x[..., tp.index * n:(tp.index + 1) * n].clone().requires_grad_()
    wl = w[tp.index * n:(tp.index + 1) * n].clone().requires_grad_()
    y = mesh_ctx.row_parallel(xl, wl, tp)
    y.backward(g)
    twice = mesh_ctx.reduce_tensor(xl.detach() @ wl.detach(), tp)
    rows = slice(tp.index * n, (tp.index + 1) * n)
    return {"dtype": str(y.dtype),
            "ulps": ulps(y, y1), "unequal": float((y != y1).float().mean()),
            "ulps_rounded_twice": ulps(twice, y1),
            "unequal_rounded_twice": float((twice != y1).float().mean()),
            "gx_ulps": ulps(xl.grad, x1.grad[..., rows]),
            "gw_ulps": ulps(wl.grad, w1.grad[rows])}

results = {}
for c in work:
    fn = {"train": train_case, "raises": raises_case,
          "ref": ref_case, "rowpar": rowpar_case}.get(c["kind"])
    results[c["name"]] = (ckpt_case(c, out_dir) if c["kind"] == "ckpt"
                          else fn(c))
json.dump(results, open(f"{out_dir}/rank{rank}.json", "w"))
mesh_lib.barrier()
dist.destroy_process_group()
print("WORKER-OK")
'''

#: the reference's sharded step (tests/test_sharding.py's script, fed the
#: port's weights and batch, on a mesh of Auto axes, two steps)
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
    cfg = reduce_config(get_config("llama3-8b"))
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
    train = [dict(kind="train", name=n, world=w, mesh=list(m), profile=p,
                  arch=a, optimizer=o, remat=r, **rows)
             for n, w, m, p, a, o, r in TRAIN_CASES]
    return {4: [c for c in train if c["world"] == 4] + [
        dict(kind="ckpt", name="ckpt", mesh=[2, 2], arch="qwen2.5-3b",
             **rows),
        dict(kind="raises", name="raises", mesh=[2, 2]),
        dict(kind="rowpar", name="rowpar", mesh=[2, 2])],
        8: [c for c in train if c["world"] == 8] + [
        dict(kind="ref", name="ref", mesh=[4, 2], arch="llama3-8b",
             inputs=str(tmp / "ref_in.npz"), out=str(tmp / "port_out.npz"))]}


def _ref_inputs(path):
    """The llama3-8b tiny weights (the port's initialiser, seeded) and a
    batch, as the reference's tree flattened to ``w:a/b`` keys."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import model as tmodel
    cfg = tiny_config(get_config("llama3-8b"))
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
    tmp = tmp_path_factory.mktemp("shard_train")
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
    res = {}
    for w in (4, 8):
        res[w] = [json.loads((tmp / f"out{w}" / f"rank{r}.json").read_text())
                  for r in range(w)]
    return tmp, res


#: the world each case runs in
WORLD_OF = {**{c[0]: c[1] for c in TRAIN_CASES}, "ckpt": 4, "raises": 4,
            "rowpar": 4, "ref": 8}


def _ranks(worlds, name):
    """Each rank's record of case ``name``."""
    return [r[name] for r in worlds[1][WORLD_OF[name]]]


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_sharded_step_matches_one_device(worlds, case):
    """Loss, grad norm, gradient slices, parameters (whole and sliced)
    and optimizer-state slices after two steps of two microbatches."""
    for rec in _ranks(worlds, case):
        for one, sharded in rec["loss"] + rec["gnorm"]:
            assert _close(sharded, one, METRIC_RTOL), (one, sharded)
        assert rec["grad_err"] <= 1.0, rec["grad_err"]
        for key in ("params", "param_slices", "opt_slices"):
            within, past, total, worst = rec[key]
            assert within <= STEP_TOL, (key, within)
            assert past <= FLIP_SHARE * total, (key, past, total)
            assert worst <= 2 * LR + STEP_TOL, (key, worst)


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_each_rank_holds_only_its_slice(worlds, case):
    """Parameters, optimizer state and float32 accumulators are exactly
    the bytes of this rank's slices; on a mesh of n ranks that cuts
    every large leaf, about 1/n of the whole."""
    world = WORLD_OF[case]
    for rec in _ranks(worlds, case):
        r = rec["resident"]
        assert r["params"] == r["params_want"]
        assert r["opt"] == r["opt_want"]
        assert r["grads"] == r["grads_want"]
        assert r["params"] < 1.2 * r["single"] / world + 4096, r


def test_sharded_checkpoints_resume_across_layouts(worlds):
    """A (2, 2) save resumes on one device, a one-device save restores on
    (2, 2) (and the one-device state sliced in memory loads there), each
    with the other side's next loss."""
    for rec in _ranks(worlds, "ckpt"):
        assert rec["step"] == [2, 2, 2]
        for name in ("mesh_to_one", "one_to_mesh", "one_to_mesh_in_memory"):
            a, b = rec[name]
            assert _close(a, b, METRIC_RTOL), (name, a, b)


def test_row_parallel_rounds_once_in_bfloat16(worlds):
    """A bfloat16 row-parallel product on the model axis of (2, 2) is one
    device's product: partials at float32, the sum rounded once, so at
    most 1 unit in the last place off and on at most 1% of the elements
    (the float32 sums' order); its gradients within 1 unit. Partials
    rounded to bfloat16 before the sum miss more often."""
    for rec in _ranks(worlds, "rowpar"):
        assert rec["dtype"] == "torch.bfloat16"
        assert rec["ulps"] <= 1.0 and rec["unequal"] <= 0.01, rec
        assert rec["gx_ulps"] <= 1.0 and rec["gw_ulps"] <= 1.0, rec
        assert rec["unequal_rounded_twice"] > 2 * rec["unequal"], rec


@pytest.mark.parametrize("what", RAISES)
def test_unimplemented_layouts_raise(worlds, what):
    """A step on a model not laid out on the mesh raises; the cases of
    ``RUNS``, which earlier slices refused, run one step within the
    float32 criteria of the one device."""
    for rec in _ranks(worlds, "raises"):
        got = rec[what]
        if what in RUNS:
            for one, sharded in (got["loss"], got["gnorm"]):
                assert abs(sharded - one) <= METRIC_RTOL * abs(one), got
            assert got["grad_err"] <= 1.0, got
        else:
            assert got.startswith("raised"), got


def test_sharded_step_matches_the_reference_sharded_step(worlds):
    """The port's (4, 2) step against the reference's on an Auto-axis
    mesh: the reference test's tolerances, on every parameter."""
    tmp, _ = worlds
    ref = np.load(tmp / "ref_out.npz")
    port = np.load(tmp / "port_out.npz")
    losses = _ranks(worlds, "ref")
    for i in range(2):
        for rec in losses:
            np.testing.assert_allclose(rec["loss"][i], float(ref[f"loss{i}"]),
                                       rtol=REF_LOSS_RTOL)
        keys = [k for k in ref.files if k.startswith(f"p{i}:")]
        assert keys and set(keys) == {k for k in port.files
                                      if k.startswith(f"p{i}:")}
        for k in keys:
            np.testing.assert_allclose(port[k], ref[k], atol=REF_PARAM_ATOL,
                                       err_msg=k)
