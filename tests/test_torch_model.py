"""The port's model against ``repro.models.Model`` on the CPU: the dense
transformer, the hybrid Mamba2 family (zamba2) and xLSTM.

The JAX package's params are handed to the port through
``repro_torch.bridge``; inputs are numpy arrays made from a seed.  fp32,
with the tolerance of ``tests/test_models.py::test_decode_matches_forward``.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402

TOL = dict(rtol=2e-3, atol=5e-4)
B, S = 2, 8


def fp32(cfg):
    return cfg.replace(dtype="float32", logit_dtype="float32")


def pair(arch, seed=2):
    """(JAX model, JAX params, port model, port params): the same weights."""
    jm = JaxModel(fp32(jax_smoke_config(arch)))
    jp, _ = jm.init(jax.random.key(seed))
    tm = Model(fp32(smoke_config(arch)), device="cpu")
    tp = bridge.to_torch({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    return jm, jp, tm, tp


def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        batch = {"embeds": rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.mrope_sections:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        batch["positions"] = np.stack([pos, pos, pos])
    return batch


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def step_batch(cfg, batch, t):
    """Token t of ``batch`` as a one-token decode batch (numpy; the caller
    adds ``cache_pos``)."""
    tok = {}
    key = "embeds" if cfg.embed_inputs else "tokens"
    tok[key] = batch[key][:, t:t + 1]
    p = np.full((B, 1), t, np.int32)
    tok["positions"] = np.stack([p, p, p]) if cfg.mrope_sections else p
    return tok


def jax_decode_all(jm, jp, batch):
    """Logits of the JAX token-by-token loop, (B, S, V)."""
    cache = jm.init_cache(B, S)
    step = jax.jit(jm.decode_step)
    outs = []
    for t in range(S):
        tok = jax_batch(step_batch(jm.cfg, batch, t)) | {"cache_pos": jnp.int32(t)}
        lg, cache = step(jp, cache, tok)
        outs.append(np.asarray(lg))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("arch", ["stablelm_3b", "yi_34b", "gemma2_9b", "qwen2_vl_7b",
                                  "musicgen_medium"])
def test_forward_and_prefill_caches_match(arch):
    """Logits and the collect_kv caches; gemma2 covers window + softcaps,
    qwen2-vl M-RoPE, musicgen embedding inputs."""
    jm, jp, tm, tp = pair(arch)
    batch = make_batch(tm.cfg, seed=3)
    jl, (jk, jv) = jax.jit(lambda p, b: jm.forward(p, b, collect_kv=True))(jp, jax_batch(batch))
    with torch.no_grad():
        tl, caches = tm.forward(tp, torch_batch(batch), collect_kv=True)
    assert set(caches) == {"k", "v"}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(caches["k"].numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(caches["v"].numpy(), np.asarray(jv), **TOL)


def prompt_batch(cfg, batch, P):
    """The first P positions of ``batch`` (tokens or embeddings, and the
    (3, B, P) M-RoPE positions where the config has them)."""
    key = "embeds" if cfg.embed_inputs else "tokens"
    out = {key: batch[key][:, :P]}
    if cfg.mrope_sections:
        out["positions"] = batch["positions"][..., :P]
    return out


@pytest.mark.parametrize("arch", ["stablelm_3b", "yi_34b", "zamba2_1p2b", "xlstm_125m",
                                  "qwen2_vl_7b", "musicgen_medium", "gemma2_9b"])
def test_decode_steps_and_one_pass_prefill_match(arch):
    """Per-step decode logits equal JAX's; a one-pass prefill of the first
    half followed by decode gives the logits of JAX's token-by-token loop
    (for zamba2 and xlstm the half, 4, is ragged against their chunk of 8).
    qwen2-vl decodes with (3, B, 1) M-RoPE positions, musicgen from
    embeddings, gemma2 with softcaps at a cache of S = 8, its smoke
    window (no ring cache, ROADMAP.md A11)."""
    jm, jp, tm, tp = pair(arch)
    batch = make_batch(tm.cfg, seed=4)
    ref = jax_decode_all(jm, jp, batch)                      # (B, S, V)

    with torch.no_grad():
        cache = tm.init_cache(B, S)
        for t in range(S):
            lg, cache = tm.decode_step(tp, cache, torch_batch(step_batch(tm.cfg, batch, t))
                                       | {"cache_pos": t})
            np.testing.assert_allclose(lg.numpy(), ref[:, t:t + 1], **TOL)

        P = S // 2
        cache = tm.init_cache(B, S)
        prompt = torch_batch(prompt_batch(tm.cfg, batch, P))
        logits = [tm.prefill(tp, cache, prompt)]
        for t in range(P, S):
            lg, cache = tm.decode_step(tp, cache, torch_batch(step_batch(tm.cfg, batch, t))
                                       | {"cache_pos": t})
            logits.append(lg)
    np.testing.assert_allclose(torch.cat(logits, dim=1).numpy(), ref, **TOL)


def test_port_init_shapes_dtypes_scales():
    """The port's own init: JAX's keys, shapes, dtypes and axes, and the
    JAX builder's scales (values are PyTorch's bits, never compared)."""
    cfg = smoke_config("stablelm_3b").replace(d_model=256, d_ff=512, vocab=1024)
    jshapes, jspecs = JaxModel(jax_smoke_config("stablelm_3b").replace(
        d_model=256, d_ff=512, vocab=1024)).abstract_params()
    params, specs = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert set(params) == set(jshapes)
    for k, p in params.items():
        assert tuple(p.shape) == tuple(jshapes[k].shape), k
        assert str(p.dtype).removeprefix("torch.") == str(jshapes[k].dtype), k
        assert tuple(specs[k]) == tuple(jspecs[k]), k
    assert float(params["embed/table"].std()) == pytest.approx(0.02, rel=0.05)
    for k in ("final_norm/scale", "blocks/ln_attn/scale", "blocks/ln_mlp/scale"):
        assert bool((params[k] == 1).all()), k
    # "normal" init: 1/sqrt(fan_in), fan_in = the per-layer shape's first dim
    for k, fan_in in (("head/w", 256), ("blocks/attn/wq", 256), ("blocks/mlp/wi_up", 256),
                      ("blocks/mlp/wo", 512), ("blocks/attn/wo", cfg.n_heads)):
        assert float(params[k].std()) == pytest.approx(1 / math.sqrt(fan_in), rel=0.05), k


def jax_cache_after(jm, jp, batch, P):
    """JAX's cache after the token-by-token loop over the first P tokens."""
    cache = jm.init_cache(B, S)
    step = jax.jit(jm.decode_step)
    for t in range(P):
        tok = jax_batch(step_batch(jm.cfg, batch, t)) | {"cache_pos": jnp.int32(t)}
        _, cache = step(jp, cache, tok)
    return {k: np.asarray(v) for k, v in cache.items()}


def test_hybrid_forward_matches_jax():
    """zamba2 smoke: logits of one forward pass (S a whole number of
    chunks: the JAX forward asserts it)."""
    jm, jp, tm, tp = pair("zamba2_1p2b")
    batch = make_batch(tm.cfg, seed=3)
    jl, _ = jax.jit(jm.forward)(jp, jax_batch(batch))
    with torch.no_grad():
        tl, _ = tm.forward(tp, torch_batch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("P", [8, 4, 2])
def test_hybrid_prefill_cache_matches_jax_loop(P):
    """zamba2 smoke: one prefill pass of P tokens fills the cache as JAX's
    P decode steps do: every layer's SSM state and conv tail, and the
    shared block's k/v at each of its applications.  P = 4 is ragged
    against the chunk of 8; P = 2 is shorter than the conv's K - 1 = 3."""
    jm, jp, tm, tp = pair("zamba2_1p2b")
    batch = make_batch(tm.cfg, seed=6)
    ref = jax_cache_after(jm, jp, batch, P)
    with torch.no_grad():
        cache = tm.init_cache(B, S)
        tm.prefill(tp, cache, torch_batch({"tokens": batch["tokens"][:, :P]}))
    assert set(cache) == set(ref) == {"ssm", "conv", "attn_k", "attn_v"}
    for name, want in ref.items():
        assert tuple(cache[name].shape) == want.shape, name
        np.testing.assert_allclose(cache[name].numpy(), want, **TOL, err_msg=name)


def test_hybrid_short_prefill_then_decode_matches_jax_loop():
    """zamba2 smoke: a 2-token prefill (shorter than K - 1) and 6 decode
    steps give the logits of JAX's token-by-token loop."""
    jm, jp, tm, tp = pair("zamba2_1p2b")
    batch = make_batch(tm.cfg, seed=7)
    ref = jax_decode_all(jm, jp, batch)
    with torch.no_grad():
        cache = tm.init_cache(B, S)
        logits = [tm.prefill(tp, cache, torch_batch({"tokens": batch["tokens"][:, :2]}))]
        for t in range(2, S):
            lg, cache = tm.decode_step(tp, cache, torch_batch(step_batch(tm.cfg, batch, t))
                                       | {"cache_pos": t})
            logits.append(lg)
    np.testing.assert_allclose(torch.cat(logits, dim=1).numpy(), ref, **TOL)


def test_hybrid_scan_goes_through_ops_in_prefill_only():
    """Every Mamba2 layer's chunked scan calls ``ops.ssd_scan`` once in a
    prefill; a decode step never does (it is plain PyTorch on every
    device).  The shared block's attention goes through
    ``ops.flash_attention`` once per application in both."""
    from unittest import mock

    from repro_torch.kernels import ops

    cfg = fp32(smoke_config("zamba2_1p2b"))
    m = Model(cfg, device="cpu")
    params, _ = m.init(torch.Generator().manual_seed(0))
    batch = torch_batch(make_batch(cfg, seed=5))
    n_attn = cfg.n_layers // cfg.attn_every
    with torch.no_grad(), \
            mock.patch.object(ops, "ssd_scan", wraps=ops.ssd_scan) as scan, \
            mock.patch.object(ops, "flash_attention", wraps=ops.flash_attention) as attn:
        cache = m.init_cache(B, S + 1)
        m.prefill(params, cache, batch)
        assert (scan.call_count, attn.call_count) == (cfg.n_layers, n_attn)
        m.decode_step(params, cache, {"tokens": batch["tokens"][:, :1],
                                      "positions": torch.full((B, 1), S), "cache_pos": S})
        assert (scan.call_count, attn.call_count) == (cfg.n_layers, 2 * n_attn)


def test_hybrid_init_matches_jax_abstract_params():
    """The port's own zamba2 init: JAX's keys (stacked Mamba2 layers and the
    shared_attn/ block), shapes, dtypes and logical axes."""
    jshapes, jspecs = JaxModel(jax_smoke_config("zamba2_1p2b")).abstract_params()
    params, specs = Model(smoke_config("zamba2_1p2b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert set(params) == set(jshapes)
    assert any(k.startswith("shared_attn/") for k in params)
    for k, p in params.items():
        assert tuple(p.shape) == tuple(jshapes[k].shape), k
        assert str(p.dtype).removeprefix("torch.") == str(jshapes[k].dtype), k
        assert tuple(specs[k]) == tuple(jspecs[k]), k


def test_hybrid_cache_shapes_match_jax():
    cfg = smoke_config("zamba2_1p2b")
    mine = Model(cfg, device="cpu").init_cache(B, 12)
    want = JaxModel(jax_smoke_config("zamba2_1p2b")).init_cache(B, 12)
    assert set(mine) == set(want)
    for k, v in want.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype).removeprefix("torch.") == str(v.dtype), k


def test_bridge_round_trip():
    """JAX params -> port -> numpy keep keys, shapes, dtypes and values;
    bfloat16 comes back as the same values in fp32."""
    _, jp, _, tp = pair("yi_34b")
    back = bridge.to_numpy(tp)
    assert set(back) == set(jp)
    for k, v in jp.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], np.asarray(v))
    bf = jnp.linspace(-3, 3, 17).astype(jnp.bfloat16)
    t = bridge.to_torch({"x": np.asarray(bf)}, device="cpu")["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy({"x": t})["x"], np.asarray(bf, np.float32))


@pytest.mark.parametrize("attn_impl", ["chunked", "reference", "pallas"])
def test_attention_always_goes_through_ops(attn_impl):
    """Every layer's attention calls ``ops.flash_attention``, whatever the
    config's ``attn_impl`` says: the tensors' device alone picks the path."""
    from unittest import mock

    from repro_torch.kernels import ops

    cfg = fp32(smoke_config("stablelm_3b")).replace(attn_impl=attn_impl)
    m = Model(cfg, device="cpu")
    params, _ = m.init(torch.Generator().manual_seed(0))
    batch = torch_batch(make_batch(cfg, seed=5))
    with torch.no_grad(), mock.patch.object(
            ops, "flash_attention", wraps=ops.flash_attention) as spy:
        cache = m.init_cache(B, S + 1)
        m.prefill(params, cache, batch)
        m.decode_step(params, cache, {"tokens": batch["tokens"][:, :1],
                                      "positions": torch.full((B, 1), S), "cache_pos": S})
    assert spy.call_count == 2 * cfg.n_layers


def test_ring_cache_raises_plain_cache_builds():
    """gemma2's local layers would need ring caches once the cache outgrows
    the window: not ported, so init_cache raises; within the window it
    builds the plain per-layer cache, as the JAX package does."""
    cfg = smoke_config("gemma2_9b")
    m = Model(cfg, device="cpu")
    cache = m.init_cache(B, cfg.sliding_window)
    assert set(cache) == {"k", "v"}
    assert tuple(cache["k"].shape) == (cfg.n_layers, B, cfg.sliding_window,
                                       cfg.n_kv_heads, cfg.hd)
    assert set(JaxModel(jax_smoke_config("gemma2_9b")).init_cache(B, cfg.sliding_window)) \
        == {"k", "v"}
    with pytest.raises(NotImplementedError, match="A11"):
        m.init_cache(B, cfg.sliding_window + 1)


def test_serving_params_cast_once():
    cfg = smoke_config("stablelm_3b")
    m = Model(cfg, device="cpu")
    params, _ = m.init(torch.Generator().manual_seed(0))
    sp = m.serving_params(params)
    assert set(sp) == set(params)
    assert all(v.dtype == torch.bfloat16 for v in sp.values())


def test_xlstm_forward_matches_jax():
    """xlstm smoke: logits of one forward pass (S a whole number of chunks:
    the JAX mLSTM forward asserts it)."""
    jm, jp, tm, tp = pair("xlstm_125m")
    batch = make_batch(tm.cfg, seed=3)
    jl, _ = jax.jit(jm.forward)(jp, jax_batch(batch))
    with torch.no_grad():
        tl, _ = tm.forward(tp, torch_batch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


XLSTM_CACHE = {"mlstm_S", "mlstm_n", "mlstm_m", "slstm_c", "slstm_n", "slstm_h", "slstm_m"}


@pytest.mark.parametrize("P", [8, 5, 3])
def test_xlstm_prefill_cache_matches_jax_loop(P):
    """xlstm smoke: one prefill pass of P tokens fills the cache as JAX's P
    decode steps do (JAX has no one-pass xLSTM prefill): every mLSTM
    layer's final (S, n, m) and every sLSTM layer's (c, n, h, m).  P = 5 is
    ragged against the chunk of 8; P = 3 is shorter than a chunk."""
    jm, jp, tm, tp = pair("xlstm_125m")
    batch = make_batch(tm.cfg, seed=6)
    ref = jax_cache_after(jm, jp, batch, P)
    with torch.no_grad():
        cache = tm.init_cache(B, S)
        tm.prefill(tp, cache, torch_batch({"tokens": batch["tokens"][:, :P]}))
    assert set(cache) == set(ref) == XLSTM_CACHE
    for name, want in ref.items():
        assert tuple(cache[name].shape) == want.shape, name
        np.testing.assert_allclose(cache[name].numpy(), want, **TOL, err_msg=name)


def test_xlstm_short_prefill_then_decode_matches_jax_loop():
    """xlstm smoke: a 3-token prefill and 5 decode steps give the logits of
    JAX's token-by-token loop."""
    jm, jp, tm, tp = pair("xlstm_125m")
    batch = make_batch(tm.cfg, seed=7)
    ref = jax_decode_all(jm, jp, batch)
    with torch.no_grad():
        cache = tm.init_cache(B, S)
        logits = [tm.prefill(tp, cache, torch_batch({"tokens": batch["tokens"][:, :3]}))]
        for t in range(3, S):
            lg, cache = tm.decode_step(tp, cache, torch_batch(step_batch(tm.cfg, batch, t))
                                       | {"cache_pos": t})
            logits.append(lg)
    np.testing.assert_allclose(torch.cat(logits, dim=1).numpy(), ref, **TOL)


def test_xlstm_scan_goes_through_ops_in_prefill_only():
    """Every mLSTM layer's chunked scan calls ``ops.mlstm_scan`` once in a
    prefill; a decode step never does (it is plain PyTorch on every
    device).  Nothing calls the other kernels."""
    from unittest import mock

    from repro_torch.kernels import ops

    cfg = fp32(smoke_config("xlstm_125m"))
    m = Model(cfg, device="cpu")
    params, _ = m.init(torch.Generator().manual_seed(0))
    batch = torch_batch(make_batch(cfg, seed=5))
    n_mlstm = cfg.n_layers // cfg.xlstm_slstm_every * (cfg.xlstm_slstm_every - 1)
    with torch.no_grad(), \
            mock.patch.object(ops, "mlstm_scan", wraps=ops.mlstm_scan) as scan, \
            mock.patch.object(ops, "ssd_scan", wraps=ops.ssd_scan) as ssd, \
            mock.patch.object(ops, "flash_attention", wraps=ops.flash_attention) as attn:
        cache = m.init_cache(B, S + 1)
        m.prefill(params, cache, batch)
        assert scan.call_count == n_mlstm == 2
        m.decode_step(params, cache, {"tokens": batch["tokens"][:, :1],
                                      "positions": torch.full((B, 1), S), "cache_pos": S})
        assert scan.call_count == n_mlstm
    assert ssd.call_count == attn.call_count == 0


def test_xlstm_init_matches_jax_abstract_params():
    """The port's own xLSTM init: JAX's keys (units stacked, mLSTM and sLSTM
    blocks in each), shapes, dtypes and logical axes; the sLSTM's R at scale
    1/sqrt(dh) and its bias at zero."""
    jshapes, jspecs = JaxModel(jax_smoke_config("xlstm_125m")).abstract_params()
    cfg = smoke_config("xlstm_125m")
    params, specs = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert set(params) == set(jshapes)
    assert any("mlstm0/" in k for k in params) and any("slstm/" in k for k in params)
    for k, p in params.items():
        assert tuple(p.shape) == tuple(jshapes[k].shape), k
        assert str(p.dtype).removeprefix("torch.") == str(jshapes[k].dtype), k
        assert tuple(specs[k]) == tuple(jspecs[k]), k
    dh = cfg.d_model // cfg.n_heads
    assert float(params["blocks/slstm/r"].std()) == pytest.approx(1 / math.sqrt(dh), rel=0.1)
    assert bool((params["blocks/slstm/bias"] == 0).all())


def test_xlstm_cache_shapes_match_jax():
    """Keys, shapes, dtypes and initial values: mlstm_m starts at -inf,
    everything else at 0."""
    cfg = smoke_config("xlstm_125m")
    mine = Model(cfg, device="cpu").init_cache(B, 12)
    want = JaxModel(jax_smoke_config("xlstm_125m")).init_cache(B, 12)
    assert set(mine) == set(want) == XLSTM_CACHE
    for k, v in want.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype).removeprefix("torch.") == str(v.dtype), k
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v), err_msg=k)
    assert bool(torch.isneginf(mine["mlstm_m"]).all())
