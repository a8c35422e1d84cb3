"""The port's training path (``repro_torch.runtime.train_loop``, remat in
the models, ``repro_torch.launch.train``) against the JAX package's, on
the CPU, at the reference smoke tests' reduced configs
(``tests/test_smoke_archs.py`` ``reduce_config``, float32), the
reference's weights carried through ``params_from_numpy`` and every
input made from a numpy seed:

* every family's loss (with z-loss, labels with −1 entries) and every
  gradient leaf, mapped through the reference's tree, against
  ``jax.value_and_grad`` of the reference's loss: each leaf within
  ``1e-4 · max |g_leaf| + 1e-6``, the loss within rtol 1e-5;
* ``remat="block"`` and ``"full"`` give the loss and gradients of
  ``"none"`` bit for bit (the recomputed forward is the same program);
* whole steps (adamw and adafactor, one and two microbatches) against
  the reference's ``make_train_step``: loss, grad norm and lr within
  rtol 1e-5; the parameters after the step within ``STEP_TOL``, except
  where Adam's normalisation flips a near-zero gradient's sign (an
  update of ±lr either way): those are counted, and at most
  ``FLIP_SHARE`` of the elements;
* a resume from a checkpoint the reference's ``CheckpointManager``
  wrote, the launcher's ``main`` with a checkpoint dir and the
  ``train_lm`` example, on the CPU.

The reference's functions are jitted once a family."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import DataPipeline as JDataPipeline
from repro.data import SyntheticLMDataset as JSyntheticLMDataset
from repro.models import build_model as jbuild_model
from repro.runtime import train_loop as jtrain
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.models import model as tmodel
from repro_torch.optim.adamw import at
from repro_torch.runtime import train_loop as ttrain
from test_smoke_archs import reduce_config
from test_torch_families import perturbed
from test_torch_models import as_jax, as_torch, port_cfg

jax.config.update("jax_platform_name", "cpu")

FAMILIES = ("qwen1.5-0.5b", "qwen2-vl-7b", "deepseek-v2-236b",
            "arctic-480b", "xlstm-1.3b", "zamba2-7b", "seamless-m4t-medium")
B, S, PATCHES, FRAMES = 4, 16, 8, 16
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_TOL = dict(rtol=1e-5, atol=0)
#: parameters after one whole step: within 2e-6 of the reference's,
#: past it only where Adam flipped a near-zero gradient's sign (|Δ| ≤
#: 2·lr + 2e-6), at most FLIP_SHARE of the elements
STEP_TOL = 2e-6
FLIP_SHARE = 1e-3
LR = 1e-3


def make_batch(cfg, seed, batch=B, seq=S):
    """Tokens, labels (a fifth −1), and the family's frontend inputs: a
    vlm's patches and M-RoPE positions over patches + text, an
    encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)
                                  ).astype(np.int32)}
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels[rng.random((batch, seq)) < 0.2] = -1
    out["labels"] = labels
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, PATCHES, cfg.d_model)).astype(np.float32)
        pos = np.arange(PATCHES + seq, dtype=np.int32)
        pos = np.stack([pos, pos // 2, pos // 3])[:, None]
        out["positions3"] = np.ascontiguousarray(
            np.broadcast_to(pos, (3, batch, PATCHES + seq)))
    if cfg.family in ("encdec", "audio"):
        out["frames"] = rng.standard_normal(
            (batch, FRAMES, cfg.d_model)).astype(np.float32)
    return out


class Family:
    """One family at the reduced config: the reference's model, weights
    in the reference's tree (numpy; drawn by the port, which is quicker
    than the reference's eager initialisers, then perturbed) and the
    reference's jitted loss-and-gradient."""

    def __init__(self, arch, z_loss=1e-4):
        self.jcfg = reduce_config(jget_config(arch))
        self.cfg = port_cfg(self.jcfg)
        self.jmodel = jbuild_model(self.jcfg)
        self.weights = perturbed(
            tmodel.params_to_numpy(tmodel.build_model(self.cfg,
                                                      device="cpu")),
            np.random.default_rng(1))

        def loss(params, batch):
            return jtrain.cross_entropy_loss(
                self.jmodel.train_logits(params, batch), batch["labels"],
                z_loss)
        self.value_and_grad = jax.jit(jax.value_and_grad(loss))

    def port(self, **cfg_kw):
        model = tmodel.build_model(self.cfg.replace(**cfg_kw), device="cpu")
        return tmodel.params_from_numpy(model, self.weights)


_FAMILY_CACHE = {}


def family(arch) -> Family:
    if arch not in _FAMILY_CACHE:
        _FAMILY_CACHE[arch] = Family(arch)
    return _FAMILY_CACHE[arch]


def check_grads(leaves, got, want_tree):
    assert len(got) == len(jax.tree.leaves(want_tree))
    for leaf, g in zip(leaves, got):
        want = np.asarray(at(want_tree, leaf.path))
        assert g.shape == want.shape, leaf.path
        tol = GRAD_RTOL * np.abs(want).max() + GRAD_ATOL
        err = np.abs(g.numpy() - want).max()
        assert err <= tol, (leaf.path, err, tol)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_manual():
    logits = torch.tensor([[[2.0, 0.0, -1.0], [0.0, 1.0, 0.0]]])
    labels = torch.tensor([[0, 1]])
    loss = ttrain.cross_entropy_loss(logits, labels, z_loss=0.0)
    manual = -(torch.log_softmax(logits[0, 0], -1)[0]
               + torch.log_softmax(logits[0, 1], -1)[1]) / 2
    np.testing.assert_allclose(loss.numpy(), manual.numpy(), rtol=1e-6)


def test_cross_entropy_ignores_negative_labels():
    logits = torch.zeros((1, 3, 5))
    labels = torch.tensor([[1, -1, 2]])
    loss = ttrain.cross_entropy_loss(logits, labels, z_loss=0.0)
    np.testing.assert_allclose(loss.numpy(), np.log(5.0), rtol=1e-6)


def test_cross_entropy_matches_reference_with_patches_and_z_loss():
    """float32 logits longer than the labels (patches first), labels
    with −1 (a gather that would raise unclamped), z-loss, and an
    all-masked row set."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 9, 11)).astype(np.float32) * 3
    labels = rng.integers(-1, 11, (3, 6)).astype(np.int32)
    for lab in (labels, np.full_like(labels, -1)):
        got = ttrain.cross_entropy_loss(torch.from_numpy(logits),
                                        torch.from_numpy(lab), 1e-2)
        want = jtrain.cross_entropy_loss(jnp.asarray(logits),
                                         jnp.asarray(lab), 1e-2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# gradients of every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_grads_match_reference(arch):
    fam = family(arch)
    batch = make_batch(fam.cfg, seed=11)
    want_loss, want_grads = fam.value_and_grad(fam.weights, as_jax(batch))
    model = fam.port()
    step = ttrain.make_train_step(model, TrainConfig(microbatches=1))
    loss, grads = step.grads_of(as_torch(batch))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               **LOSS_TOL)
    check_grads(step.leaves, grads, want_grads)
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("arch", ("qwen2-vl-7b", "deepseek-v2-236b",
                                  "xlstm-1.3b", "zamba2-7b",
                                  "seamless-m4t-medium"))
def test_remat_gives_the_same_loss_and_grads(arch):
    fam = family(arch)
    batch = as_torch(make_batch(fam.cfg, seed=12))
    out = {}
    for remat in ("none", "block", "full"):
        step = ttrain.make_train_step(fam.port(remat=remat),
                                      TrainConfig(microbatches=1))
        loss, grads = step.grads_of(batch)
        out[remat] = (loss, [g.clone() for g in grads])
    for remat in ("block", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


def test_remat_stays_out_of_inference():
    """prefill and decode never checkpoint: the same logits with and
    without remat, under inference mode."""
    fam = family("qwen1.5-0.5b")
    batch = as_torch(make_batch(fam.cfg, seed=13))
    prompt = {"tokens": batch["tokens"]}
    a, _ = fam.port(remat="none").prefill(prompt, S + 2)
    b, _ = fam.port(remat="block").prefill(prompt, S + 2)
    assert torch.equal(a, b) and torch.is_inference(b)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

def _tcfg(cls, optimizer, M, **kw):
    return cls(optimizer=optimizer, microbatches=M, learning_rate=LR,
               warmup_steps=1, total_steps=10,
               opt_state_dtype="float32", **kw)


_REF_STEPS = {}


def ref_step(fam, optimizer, M):
    key = (fam.jcfg.name, optimizer, M)
    if key not in _REF_STEPS:
        _REF_STEPS[key] = jax.jit(jtrain.make_train_step(
            fam.jmodel, _tcfg(JTrainConfig, optimizer, M), mesh=None))
    return _REF_STEPS[key]


def ref_state(fam, optimizer):
    from repro.optim import get_optimizer
    params = jax.tree.map(jnp.asarray, fam.weights)
    return {"params": params,
            "opt": get_optimizer(_tcfg(JTrainConfig, optimizer,
                                       1)).init(params),
            "step": jnp.zeros((), jnp.int32)}


def check_params(model, want_tree):
    """The model's weights against the reference's tree: STEP_TOL, but
    for Adam's sign flips (counted, each within 2·lr)."""
    got = tmodel.params_to_numpy(model)
    flips = total = 0
    for path, want in jax.tree_util.tree_leaves_with_path(want_tree):
        keys = tuple(k.key for k in path)
        d = np.abs(at(got, keys) - np.asarray(want))
        assert d.max() <= 2 * LR + STEP_TOL, (keys, d.max())
        flips += int((d > STEP_TOL).sum())
        total += d.size
    assert flips <= FLIP_SHARE * total, (flips, total)
    return flips


def check_metrics(got, want):
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
@pytest.mark.parametrize("M", (1, 2))
def test_whole_step_matches_reference(optimizer, M):
    fam = family("qwen2-vl-7b")        # positions3 splits on axis 1
    batch = make_batch(fam.cfg, seed=21)
    jstate, jm = ref_step(fam, optimizer, M)(ref_state(fam, optimizer),
                                             as_jax(batch))
    model = fam.port()
    tcfg = _tcfg(TrainConfig, optimizer, M)
    state = ttrain.make_train_state(model, tcfg)
    state, tm = ttrain.make_train_step(model, tcfg)(state, as_torch(batch))
    check_metrics(tm, jm)
    check_params(model, jstate["params"])
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    assert state["opt"]["count"].dtype == torch.int32
    # the optimizer's state in the reference's tree and shapes
    for path, want in jax.tree_util.tree_leaves_with_path(jstate["opt"]):
        keys = tuple(k.key if hasattr(k, "key") else k for k in path)
        got = at(state["opt"], keys).float().numpy()
        want = np.asarray(want)
        assert got.shape == want.shape, keys
        tol = GRAD_RTOL * np.abs(want).max() + 1e-12
        assert np.abs(got - want).max() <= tol, keys


def test_grad_accumulation_matches_single_batch():
    """Ported from the reference's test: one batch as 1 or 4
    microbatches gives the same loss and the same first leaf."""
    cfg = port_cfg(reduce_config(jget_config("llama3-8b")))
    ds = JSyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16, seed=0)
    batch = as_torch(JDataPipeline(ds, global_batch=8).next())
    outs = {}
    for M in (1, 4):
        model = tmodel.build_model(cfg, device="cpu")
        tcfg = TrainConfig(microbatches=M, learning_rate=1e-3, z_loss=0.0)
        state = ttrain.make_train_state(model, tcfg)
        _, metrics = ttrain.make_train_step(model, tcfg)(state, batch)
        outs[M] = (float(metrics["loss"]),
                   tmodel.ref_leaves(model)[0].value().detach().clone())
    assert abs(outs[1][0] - outs[4][0]) < 5e-3
    np.testing.assert_allclose(outs[1][1], outs[4][1], atol=2e-4)


def test_train_step_reduces_loss_small_model():
    """Ported from the reference's test: 40 steps on one repeated batch
    take the loss down by more than 1."""
    from repro_torch.data import DataPipeline, SyntheticLMDataset
    cfg = port_cfg(reduce_config(jget_config("qwen1.5-0.5b")))
    model = tmodel.build_model(cfg, device="cpu")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60,
                       microbatches=2)
    step = ttrain.make_train_step(model, tcfg)
    state = ttrain.make_train_state(model, tcfg)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16, seed=0)
    batch = as_torch(DataPipeline(ds, global_batch=8).next())
    losses = []
    for _ in range(40):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 1.0, losses[::8]
    assert np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# checkpoints, the launcher and the example
# ---------------------------------------------------------------------------

def test_resume_from_a_reference_checkpoint(tmp_path):
    """The reference trains 2 steps and checkpoints; the port restores
    the checkpoint and takes step 3, which equals the reference's step 3
    (adamw: moments, count and step restored)."""
    fam = family("qwen2-vl-7b")
    step = ref_step(fam, "adamw", 1)
    jstate = ref_state(fam, "adamw")
    batches = [make_batch(fam.cfg, seed=30 + i) for i in range(3)]
    for b in batches[:2]:
        jstate, _ = step(jstate, as_jax(b))
    JCheckpointManager(str(tmp_path), async_save=False).save(
        2, jstate, extras={"step": 2})
    want_state, want = step(jstate, as_jax(batches[2]))

    model = tmodel.build_model(fam.cfg, device="cpu")    # fresh weights
    tcfg = _tcfg(TrainConfig, "adamw", 1)
    state = ttrain.make_train_state(model, tcfg)
    tree, extras = CheckpointManager(str(tmp_path)).restore(
        ttrain.train_state_tree(state))
    state = ttrain.load_train_state(state, tree)
    assert extras["step"] == 2 and int(state["step"]) == 2
    assert int(state["opt"]["count"]) == 2
    state, got = ttrain.make_train_step(model, tcfg)(
        state, as_torch(batches[2]))
    check_metrics(got, want)
    check_params(model, want_state["params"])


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    from repro_torch.launch.train import main
    argv = ["--device", "cpu", "--reduced", "--d-model", "64", "--layers",
            "2", "--batch", "2", "--seq", "16", "--log-every", "1",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    assert main(argv + ["--steps", "3"]) == 0
    first = capsys.readouterr().out
    assert "step     2 loss" in first and "done in" in first
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    assert main(argv + ["--steps", "5"]) == 0
    second = capsys.readouterr().out
    assert "resumed from step 3" in second
    assert "step     3 loss" in second and "step     4 loss" in second
    assert "step     2 loss" not in second


def test_train_lm_example_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.examples import train_lm
    monkeypatch.setattr(sys, "argv", ["train_lm", "--device", "cpu",
                                      "--steps", "2", "--ckpt",
                                      str(tmp_path)])
    assert train_lm.main() == 0
    out = capsys.readouterr().out
    assert "arch=qwen1.5-0.5b" in out and "step     1 loss" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
