"""The sharded serve path (``runtime.serve_loop`` on a mesh) on a gloo
world of 4 CPU processes, a (2, 2) mesh, against the port's one-device
prefill and decode on the same weights and prompt.

Every rank builds the same tiny model from a seed (``tiny_config``,
float32 compute, norm scales and biases perturbed), serves the whole
prompt batch on one device and its rows on the mesh, and writes what it
measured; the tests hold, for a dense config (QKV bias, tied head) and
the vlm (patches, M-RoPE):

* float32 caches, free-running: prefill and 4 greedy decode steps; every
  step's logits (this rank's rows and vocabulary columns, ``logits_spec``)
  within 2e-4 of the one-device logits' slice, the greedy tokens equal,
  and the caches after the last step, laid out by ``infer_cache_specs``,
  within 2e-4 of the one-device caches' slice (``_mesh_slice``);
* bfloat16 caches, step by step: each sharded decode step starts from
  the slice of the one-device caches, and its logits are within 2e-4;
* ``jit_decode_step`` takes the cache and batch layouts the rules give,
  and a one-device step on a sharded model raises. The layouts that
  earlier slices refused run since the sequence slice, each held
  against the one device (prefill and 3 decode steps, float32 caches,
  logits within 2e-4, equal tokens): a batch of 1, whose prompt and
  caches are cut on the sequence over the data axis (``batch-1-prefill``
  through ``shard_batch``, ``batch-1-decode`` through
  ``jit_decode_step``), and xlstm's family at a batch of 1
  (``ssm-family``);
* ``check_serve_layout`` passes all ten configs as published on the
  production (16, 16) mesh, on (1, 8) (the mLSTM state cut on Dk there)
  and on (2, 4), at a batch of 16 with 4096 positions and at a batch of
  1 with 32768 (524288 for xlstm-1.3b and zamba2-7b, the ``long_500k``
  cell), on the shapes alone.
"""
import json
import os
import pathlib
import sys

import pytest

from repro_torch.launch import mesh as mesh_lib

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
WORLD_TIMEOUT_S = 240
TOL = 2e-4
ARCHS = ("qwen2.5-3b", "qwen2-vl-7b")
RAISES = ("batch-1-prefill", "batch-1-decode", "ssm-family",
          "one-device-step")
#: the cases of ``RAISES`` that run since the sequence slice
RUNS = ("batch-1-prefill", "batch-1-decode", "ssm-family")

WORKER = r'''
import json, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.checkpoint.manager import _mesh_slice
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import prompt_batch
from repro_torch.launch.train import tiny_config
from repro_torch.models import model as tmodel
from repro_torch.runtime import serve_loop as sl, shard, sharding as shd

rank, store, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
archs = sys.argv[4].split(",")
mesh_lib.init_group("gloo", init_method="file://" + store, rank=rank,
                    world_size=4, device="cpu", timeout_s=120)
mesh = mesh_lib.make_host_mesh(2, 2, backend="gloo", device="cpu")
B, P, GEN = 4, 8, 5

def build(cfg):
    model = tmodel.build_model(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(31))
    tree = tmodel.params_to_numpy(model)
    rng = np.random.default_rng(32)
    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "scale" or k in ("bq", "bk", "bv"):
                t[k] = (float(k == "scale") + 0.1 * rng.standard_normal(
                    v.shape)).astype(np.float32)
    perturb(tree)
    return tmodel.params_from_numpy(model, tree), tree

def cut(t, spec):
    return torch.from_numpy(_mesh_slice(t.float().numpy(), mesh, spec))

def max_err(local, whole, spec):
    return float((local.float() - cut(whole, spec)).abs().max())

def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree

def step_inputs(cfg, tok, pos):
    b = {"tokens": tok[:, None]}
    if cfg.mrope:
        b["positions3"] = torch.full((3, tok.shape[0], 1), pos,
                                     dtype=torch.int32)
    return b

def serve_case(arch):
    cfg = tiny_config(get_config(arch))
    one, tree = build(cfg)
    sh = shard.shard_model(tmodel.params_from_numpy(tmodel.build_model(
        cfg, device="cpu"), tree), mesh)
    prompt = prompt_batch(one, B, P, seed=33)
    start = P + (tmodel.VLM_PATCHES if cfg.family == "vlm" else 0)
    max_len = start + GEN
    lspec = shd.logits_spec(mesh)
    rec = {"logits": 0.0, "caches": 0.0, "tokens_equal": True,
           "bf16_logits": 0.0}
    # float32 caches, free-running
    tmodel.CACHE_DTYPE = torch.float32
    pre1 = sl.make_prefill_step(one, max_len=max_len)
    dec1 = sl.make_decode_step(one)
    pre2 = sl.make_prefill_step(sh, mesh, max_len=max_len)
    local = shard.shard_batch(prompt, mesh)
    l1, c1 = pre1(prompt)
    l2, c2 = pre2(local)
    rec["logits"] = max(rec["logits"], max_err(l2, l1, lspec))
    t1 = torch.argmax(l1[:, -1], -1).to(torch.int32)
    t2 = sl.greedy_token(sh, l2)
    rec["tokens_equal"] &= bool(torch.equal(t2, cut(t1, (lspec[0],)).int()))
    step_specs = shd.infer_batch_specs(step_inputs(cfg, t1, 0), mesh)
    dec2 = sl.jit_decode_step(sh, mesh, c2, step_specs)
    for i in range(GEN - 1):
        t1, l1, c1 = dec1(step_inputs(cfg, t1, start + i), c1, start + i)
        t2, l2, c2 = dec2(step_inputs(cfg, t2, start + i), c2, start + i)
        rec["logits"] = max(rec["logits"], max_err(l2, l1, lspec))
        rec["tokens_equal"] &= bool(torch.equal(t2, cut(t1, (lspec[0],))
                                                .int()))
    cspecs = shd.infer_cache_specs(c1, mesh)
    for (p, a), (_, b), (_, s) in zip(flat(c2), flat(c1), flat(cspecs)):
        rec["caches"] = max(rec["caches"], max_err(a, b, s))
        rec.setdefault("cache_shapes", []).append(
            [list(a.shape), list(shd.local_shape(b.shape, s, mesh))])
    # bfloat16 caches, each sharded step from the one-device caches
    tmodel.CACHE_DTYPE = torch.bfloat16
    l1, c1 = pre1(prompt)
    t1 = torch.argmax(l1[:, -1], -1).to(torch.int32)
    for i in range(GEN - 1):
        before = {k: {n: v.clone() for n, v in d.items()}
                  for k, d in c1.items()}
        inp = step_inputs(cfg, t1, start + i)
        t1, l1, c1 = dec1(inp, c1, start + i)
        mine = {k: {n: cut(v, s).to(v.dtype) for (n, v), (_, s) in
                    zip(d.items(), cspecs[k].items())}
                for k, d in before.items()}
        _, l2, _ = dec2(shard.shard_batch(inp, mesh), mine, start + i)
        rec["bf16_logits"] = max(rec["bf16_logits"], max_err(l2, l1, lspec))
    return rec

def batch_of_one(arch):
    """Prefill (a prompt cut on its sequence over the data axis) and 3
    decode steps at a batch of 1, float32 caches, against the one
    device: (prefill's logits error, the decode steps', tokens equal)."""
    tmodel.CACHE_DTYPE = torch.float32
    cfg = tiny_config(get_config(arch))
    one, tree = build(cfg)
    sh = shard.shard_model(tmodel.params_from_numpy(tmodel.build_model(
        cfg, device="cpu"), tree), mesh)
    prompt = prompt_batch(one, 1, 8, seed=34)
    lspec = (None, None, "model")          # the batch of 1 on every rank
    l1, c1 = sl.make_prefill_step(one, max_len=16)(prompt)
    l2, c2 = sl.make_prefill_step(sh, mesh, max_len=16)(
        shard.shard_batch(prompt, mesh))
    t1, t2 = sl.greedy_token(one, l1), sl.greedy_token(sh, l2)
    rec = {"prefill": max_err(l2, l1, lspec), "decode": 0.0,
           "tokens_equal": bool(torch.equal(t1, t2))}
    dec2 = sl.jit_decode_step(sh, mesh, c2, shd.infer_batch_specs(
        {"tokens": t1[:, None]}, mesh))
    for i in range(3):
        t1, l1, c1 = sl.make_decode_step(one)({"tokens": t1[:, None]}, c1,
                                              8 + i)
        t2, l2, c2 = dec2({"tokens": t2[:, None]}, c2, 8 + i)
        rec["decode"] = max(rec["decode"], max_err(l2, l1, lspec))
        rec["tokens_equal"] &= bool(torch.equal(t1, t2))
    return rec

def raises_case():
    cfg = tiny_config(get_config("qwen2.5-3b"))
    one, tree = build(cfg)
    sh = shard.shard_model(tmodel.params_from_numpy(tmodel.build_model(
        cfg, device="cpu"), tree), mesh)
    dense = batch_of_one("qwen2.5-3b")
    out = {"batch-1-prefill": {"logits": dense["prefill"],
                               "tokens_equal": dense["tokens_equal"]},
           "batch-1-decode": {"logits": dense["decode"],
                              "tokens_equal": dense["tokens_equal"]}}
    xl = batch_of_one("xlstm-1.3b")
    out["ssm-family"] = {"logits": max(xl["prefill"], xl["decode"]),
                         "tokens_equal": xl["tokens_equal"]}
    try:
        sl.make_decode_step(sh)
        out["one-device-step"] = "ran"
    except ValueError as e:
        out["one-device-step"] = "raised: " + str(e)[:200]
    return out

results = {a: serve_case(a) for a in archs}
results["raises"] = raises_case()
json.dump(results, open(f"{out_dir}/rank{rank}.json", "w"))
mesh_lib.barrier()
dist.destroy_process_group()
print("WORKER-OK")
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("shard_serve")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    cmds = [[sys.executable, "-c", WORKER, str(r), str(tmp_path / "store"),
             str(tmp_path), ",".join(ARCHS)] for r in range(WORLD)]
    outs = mesh_lib.run_ranks(cmds, timeout_s=WORLD_TIMEOUT_S, env=env)
    assert all("WORKER-OK" in o for _, o, _ in outs)
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_one_device(ranks, arch):
    """float32 caches: logits within 2e-4, equal greedy tokens, the
    caches this rank holds the slices of the one-device caches."""
    for r in ranks:
        rec = r[arch]
        assert rec["tokens_equal"]
        assert rec["logits"] <= TOL, rec["logits"]
        assert rec["caches"] <= TOL, rec["caches"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_caches_are_laid_out_by_the_rules(ranks, arch):
    """Each cache leaf on each rank has the shape ``infer_cache_specs``
    cuts the one-device leaf to (batch over data, KV heads over
    model)."""
    for r in ranks:
        for got, want in r[arch]["cache_shapes"]:
            assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_with_bfloat16_caches_step_by_step(ranks, arch):
    for r in ranks:
        assert r[arch]["bf16_logits"] <= TOL, r[arch]["bf16_logits"]


@pytest.mark.parametrize("what", RAISES)
def test_unimplemented_serve_layouts_raise(ranks, what):
    """A one-device step on a sharded model raises; the cases of
    ``RUNS``, which earlier slices refused, run and are held against the
    one device (logits within 2e-4, equal tokens)."""
    for r in ranks:
        rec = r["raises"][what]
        if what in RUNS:
            assert rec["tokens_equal"], rec
            assert rec["logits"] <= TOL, rec
        else:
            assert rec.startswith("raised"), rec


def test_recurrent_families_pass_the_serve_layout_check():
    """All ten configs as published, on the production (16, 16) mesh,
    on (1, 8), where the rules cut xlstm's mLSTM state on Dk (its 4
    heads over 8) and replicate its sLSTM's ``w_in`` and ``r``, and on
    (2, 4): at a batch of 16 with 4096 positions, and at a batch of 1
    with 32768 (524288 for the sub-quadratic xlstm-1.3b and zamba2-7b,
    the ``long_500k`` cell), whose caches the rules cut on the sequence
    over the data axis (and KV heads fewer than the model axis on S or
    Dh over it)."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.runtime import serve_loop as sl
    for arch in ARCHS:
        long = 524288 if arch in ("xlstm-1.3b", "zamba2-7b") else 32768
        for mesh in ({"data": 16, "model": 16}, {"data": 1, "model": 8},
                     {"data": 2, "model": 4}):
            sl.check_serve_layout(get_config(arch), 16, 4096, mesh)
            sl.check_serve_layout(get_config(arch), 1, long, mesh)
