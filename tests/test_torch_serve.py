"""The port's serve path (``repro_torch.runtime.serve_loop`` and
``repro_torch.launch.serve``) against the JAX package's on the CPU, on
the same weights: prefill and 8 greedy decode steps at the reference's
reduced configs within rtol 2e-4 / atol 2e-4 with equal tokens, one case
at the configs' own bfloat16 compute, the teacher-forcing identity, and
the launcher's command line."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import serve_loop as jserve_loop
from repro_torch.launch import serve as tserve
from repro_torch.runtime import serve_loop as tserve_loop
from test_torch_models import (ARCHS, B, MODEL_TOL, S, as_jax, as_np,
                               as_torch, close, make_batch, model_pair)

jax.config.update("jax_platform_name", "cpu")

STEPS = 8
#: bfloat16 compute: the head rounds the logits to bfloat16, and with
#: |logit| < 8 here one unit in the last place is 2^-5; upstream, each
#: block's products, norms and residual adds round again, and where the
#: two packages' float32 sums straddle a rounding boundary a logit moves
#: by about a unit. Four units: 0.125 (the gap on these inputs is 0.04)
BF16_TOL = dict(rtol=0.0, atol=4 * 2.0 ** -5)


def run_both(arch, steps=STEPS, teacher=True, **overrides):
    """Prefill, then ``steps`` greedy decode steps on both packages. With
    ``teacher`` both are fed the reference's tokens. Returns per step
    (reference logits, port logits, reference token, port token)."""
    jm, jp, tm = model_pair(arch, **overrides)
    cfg = tm.cfg
    batch = make_batch(cfg, seed=21)
    pos = S                      # prompt positions, the patches included
    max_len = S + steps
    jprefill = jax.jit(jserve_loop.make_prefill_step(jm, max_len=max_len))
    jdecode = jax.jit(jserve_loop.make_decode_step(jm))
    tprefill = tserve_loop.make_prefill_step(tm, max_len=max_len)
    tdecode = tserve_loop.make_decode_step(tm)
    jl, jc = jprefill(jp, as_jax(batch))
    tl, tc = tprefill(as_torch(batch))
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], -1).to(torch.int32)
    out = [(jl, tl, jtok, ttok)]
    for i in range(steps):
        feed = np.array(jtok) if teacher else None
        jstep = {"tokens": jtok[:, None]}
        tstep = {"tokens": (torch.from_numpy(feed) if teacher
                            else ttok)[:, None]}
        if cfg.mrope:
            p3 = np.full((3, B, 1), pos + i, np.int32)
            jstep["positions3"] = jnp.asarray(p3)
            tstep["positions3"] = torch.from_numpy(p3)
        jtok, jl, jc = jdecode(jp, jstep, jc, jnp.int32(pos + i))
        ttok, tl, tc = tdecode(tstep, tc, pos + i)
        assert ttok.dtype == torch.int32 and tl.shape == (B, 1,
                                                          cfg.vocab_size)
        out.append((jl, tl, jtok, ttok))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """Each side feeds its own greedy tokens: logits within 2e-4 and the
    tokens equal at every step."""
    for jl, tl, jtok, ttok in run_both(arch, teacher=False):
        close(tl, jl, MODEL_TOL)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_bfloat16_compute_matches_within_bfloat16_rounding():
    """qwen1.5-0.5b reduced at its config's own compute dtype (bfloat16,
    parameters float32), both fed the reference's tokens: logits within
    ``BF16_TOL``, and the greedy token equal wherever the reference's
    top-2 margin exceeds twice it."""
    decided = 0
    for jl, tl, jtok, ttok in run_both("qwen1.5-0.5b",
                                       compute_dtype="bfloat16"):
        assert tl.dtype == torch.bfloat16
        close(tl, jl, BF16_TOL)
        top2 = np.sort(as_np(jl)[:, -1], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL["atol"]
        np.testing.assert_array_equal(ttok.numpy()[clear],
                                      np.asarray(jtok)[clear])
        decided += int(clear.sum())
    assert decided > 0


def test_decode_matches_prefill_logits():
    """Teacher forcing (the port's twin of the reference's
    ``test_decode_matches_prefill_logits``): prefill over t tokens and
    one decode step equal a prefill over t + 1 tokens."""
    _, _, tm = model_pair("llama3-8b")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (B, 9),
                                         dtype=np.int32))
    lg_full, _ = tm.prefill({"tokens": toks}, max_len=16)
    _, caches = tm.prefill({"tokens": toks[:, :8]}, max_len=16)
    lg_step, _ = tm.decode({"tokens": toks[:, 8:9]}, caches, 8)
    close(lg_step[:, 0], lg_full[:, 0], MODEL_TOL)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-vl-7b"])
def test_launch_serve_runs_on_the_cpu(arch, capsys):
    # gen 9: a vlm's 8 patch positions must fit the prompt + gen buffer
    assert tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "12",
                        "--gen", "9"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch} batch=2 prefill " in out
    assert " ms, decode " in out and " tok/s)" in out
    assert "first decode step " in out and "sample generation" in out


def test_serve_returns_tokens_in_the_vocabulary():
    _, _, tm = model_pair("qwen2-vl-7b")
    r = tserve.serve(tm, batch=B, prompt_len=6, gen=9, seed=3)
    assert r["tokens"].shape == (B, 9)
    assert int(r["tokens"].min()) >= 0
    assert int(r["tokens"].max()) < tm.cfg.vocab_size
    # the reference launcher's buffer: prompt + gen, the patches not
    # counted (its last decode writes clamp)
    assert r["max_len"] == 6 + 9
    assert len(r["step_ms"]) == 8 and r["tok_s"] > 0
    assert len(r["logits"]) == 9
    assert all(torch.isfinite(l).all() for l in r["logits"])


def test_vlm_serve_sizes_its_cache_as_the_reference_launcher():
    """Repair F2: qwen2-vl served by the port's launcher and by the
    reference's steps with its launcher's ``max_len = prompt_len + gen``
    on the same weights, tokens and patches. Decode starts past the 8
    patches, so its last 7 writes clamp onto the buffer's last slot;
    every step's logits agree within 2e-4, the clamped ones included,
    and the tokens are equal. With gen < 8 the prompt does not fit and
    the port raises."""
    jm, jp, tm = model_pair("qwen2-vl-7b")
    prompt_len, gen = 12, 11
    r = tserve.serve(tm, batch=B, prompt_len=prompt_len, gen=gen, seed=5)
    assert r["max_len"] == prompt_len + gen
    inputs = tserve.prompt_batch(tm, B, prompt_len, 5)
    jprefill = jax.jit(jserve_loop.make_prefill_step(
        jm, max_len=prompt_len + gen))
    jdecode = jax.jit(jserve_loop.make_decode_step(jm))
    jl, jc = jprefill(jp, {k: jnp.asarray(v.numpy())
                           for k, v in inputs.items()})
    tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    want, toks = [jl], [tok]
    start = prompt_len + 8
    for i in range(gen - 1):
        p3 = jnp.full((3, B, 1), start + i, jnp.int32)
        tok, jl, jc = jdecode(jp, {"tokens": tok[:, None],
                                   "positions3": p3}, jc,
                              jnp.int32(start + i))
        want.append(jl)
        toks.append(tok)
    assert start + gen - 2 > prompt_len + gen - 1     # the writes clamp
    for got, w in zip(r["logits"], want):
        close(got, w, MODEL_TOL)
    np.testing.assert_array_equal(r["tokens"].numpy(),
                                  np.stack([np.asarray(t) for t in toks], 1))
    with pytest.raises(ValueError, match="gen must be at least 8"):
        tserve.serve(tm, batch=B, prompt_len=prompt_len, gen=7, seed=5)
