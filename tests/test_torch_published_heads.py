"""The five families the card had not run, at their published head
layouts, held to the JAX package on the CPU.

The smoke configs of qwen2_vl_7b, yi_34b, command_r_plus_104b,
llama4_scout_17b and musicgen_medium cut the heads as well as the
widths (4 / 2 heads of 16, and the like).  Here each keeps its published
query heads, KV heads, head dim and M-RoPE sections (llama4 also its 16
experts, top-1, with the shared expert), so the GQA groups of 7, 7, 12,
5 and 1 run, at 2 layers, d_model 64, a small d_ff and vocabulary, in
fp32.  The port draws the params (seed 0); they cross
``repro_torch.bridge`` to JAX, once an arch for its three tests.  Both
packages run the forward, a one-pass prefill of the first half followed
by 3 decode steps, and one train step's loss and gradients, within the
model-level tolerance of ``tests/test_models.py`` (2e-3 / 5e-4; a
gradient leaf also within a relative rms of 1e-4).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import arch_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import arch_config  # noqa: E402
from repro_torch.data import SyntheticTokens, to_device  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import loss_and_grads  # noqa: E402

TOL = dict(rtol=2e-3, atol=5e-4)
B, P, STEPS = 2, 5, 3           # prompt of P, then STEPS decode steps
FAMILIES = ["qwen2_vl_7b", "yi_34b", "command_r_plus_104b", "llama4_scout_17b",
            "musicgen_medium"]
# the published head layout kept, the rest cut to a CPU's size
NARROW = dict(n_layers=2, d_model=64, d_ff=96, vocab=320, loss_chunk=0, remat=False,
              dtype="float32", logit_dtype="float32")


def narrow(cfg):
    """``cfg`` at NARROW's size with its published heads (``head_dim`` made
    explicit: musicgen's 64 is d_model / n_heads at full width)."""
    return cfg.replace(head_dim=cfg.hd, **NARROW)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    tm = Model(narrow(arch_config(arch)), device="cpu")
    tp, _ = tm.init(torch.Generator().manual_seed(0))
    jp = {k: jnp.asarray(v) for k, v in bridge.to_numpy(tp).items()}
    return JaxModel(narrow(jax_config(arch))), jp, tm, tp


def pair(arch):
    """(JAX model, JAX params, port model, port params): the same weights
    (the port's a fresh copy each call)."""
    jm, jp, tm, tp = _pair(arch)
    return jm, jp, tm, {k: v.clone() for k, v in tp.items()}


def test_the_layouts_are_the_published_ones():
    """The narrow configs keep the published head layouts: GQA
    groups of 7, 7, 12, 5 and 1 at head dims 128 and 64."""
    got = {a: (narrow(arch_config(a)).n_heads, narrow(arch_config(a)).n_kv_heads,
               narrow(arch_config(a)).hd) for a in FAMILIES}
    assert got == {"qwen2_vl_7b": (28, 4, 128), "yi_34b": (56, 8, 128),
                   "command_r_plus_104b": (96, 8, 128), "llama4_scout_17b": (40, 8, 128),
                   "musicgen_medium": (24, 24, 64)}
    assert narrow(arch_config("qwen2_vl_7b")).mrope_sections == (16, 24, 24)
    moe = narrow(arch_config("llama4_scout_17b"))
    assert (moe.n_experts, moe.top_k, moe.n_shared_experts) == (16, 1, 1)


def inputs(cfg, S, seed):
    """Tokens (or embeddings) and positions ((3, B, S) for M-RoPE) as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        batch = {"embeds": rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    batch["positions"] = np.stack([pos] * 3) if cfg.mrope_sections else np.array(pos)
    return batch


def cut(batch, lo, hi):
    """Positions lo..hi-1 of a batch (the last axis of the positions)."""
    return {k: (v[..., lo:hi] if k == "positions" else v[:, lo:hi]) for k, v in batch.items()}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch):
    jm, jp, tm, tp = pair(arch)
    batch = inputs(tm.cfg, P + STEPS, seed=1)
    want, _ = jax.jit(jm.forward)(jp, as_jax(batch))
    with torch.no_grad():
        got, _ = tm.forward(tp, as_torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_then_decode_matches_jax(arch):
    """A one-pass prefill of P positions into a cache of P + STEPS, then
    STEPS decode steps: every logit JAX's, whose prefill is its one-pass
    ``forward(collect_kv=True)`` written into its cache (the MoE capacity
    is per call, so a prefill is not the token-by-token loop) and whose
    steps are its ``decode_step``."""
    jm, jp, tm, tp = pair(arch)
    batch = inputs(tm.cfg, P + STEPS, seed=2)
    jl, (jk, jv) = jax.jit(lambda p, b: jm.forward(p, b, collect_kv=True))(
        jp, as_jax(cut(batch, 0, P)))
    step = jax.jit(jm.decode_step)
    jcache = jm.init_cache(B, P + STEPS)
    jcache = {"k": jcache["k"].at[:, :, :P].set(jk), "v": jcache["v"].at[:, :, :P].set(jv)}
    want = [np.asarray(jl)]
    with torch.no_grad():
        cache = tm.init_cache(B, P + STEPS)
        got = [tm.prefill(tp, cache, as_torch(cut(batch, 0, P))).numpy()]
        for t in range(P, P + STEPS):
            tok = cut(batch, t, t + 1)
            lg, jcache = step(jp, jcache, as_jax(tok) | {"cache_pos": jnp.int32(t)})
            want.append(np.asarray(lg))
            lg, cache = tm.decode_step(tp, cache, as_torch(tok) | {"cache_pos": t})
            got.append(lg.numpy())
    np.testing.assert_allclose(np.concatenate(got, 1), np.concatenate(want, 1), **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch):
    """One step's loss and every gradient leaf (``SyntheticTokens``, some
    labels masked), against ``jax.value_and_grad(model.loss)``.  With
    top-1 routing the router takes no gradient in either package."""
    jm, jp, tm, tp = pair(arch)
    batch = SyntheticTokens(tm.cfg, B, 2 * P, seed=3).sample(0)
    batch["labels"] = batch["labels"].copy()
    batch["labels"][1, :2] = -1
    want_loss, want = jax.jit(jax.value_and_grad(jm.loss))(jp, as_jax(batch))
    loss, got = loss_and_grads(tm, {k: v.requires_grad_() for k, v in tp.items()},
                               to_device(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].detach().numpy(), np.asarray(want[k], np.float64)
        if tm.cfg.top_k == 1 and k.endswith("moe/router"):
            assert not w.any() and not g.any(), k
            continue
        np.testing.assert_allclose(g, w, err_msg=k, **TOL)
        rms = np.sqrt(np.mean((g - w) ** 2)) / max(np.sqrt(np.mean(w ** 2)), 1e-30)
        assert rms <= 1e-4 and np.abs(w).max() > 0, (k, rms)
