"""The port's CUDA kernels on the card (marked ``cuda``; they skip without one).

    python -m pytest -m cuda tests/test_torch_cuda.py

Imports no JAX: each kernel is held against the port's plain version,
which ``tests/test_torch_flash_attention.py``, ``tests/test_torch_ssd.py``
and ``tests/test_torch_mlstm.py`` hold against the JAX package on the CPU.
The attention backward is held against autograd of ``attention_ref``, and
a train step on the card against the same step on the CPU, which
``tests/test_torch_train.py`` holds against the JAX package.
"""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mlstm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    attention_lse_ref,
    attention_ref,
    mlstm_chunked,
    mlstm_ref,
    ssd_chunked,
    ssd_ref,
)
from repro_torch.data import SyntheticTokens, to_device  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import build_init_fn, build_train_step  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rand(shape, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,D,causal,window,softcap",
    [
        (1, 2, 2, 128, 128, 64, True, 0, 0.0),
        (2, 8, 2, 128, 128, 64, True, 0, 0.0),
        (1, 4, 1, 64, 256, 32, False, 0, 0.0),
        (2, 3, 3, 96, 96, 16, True, 0, 0.0),
        (2, 4, 4, 1, 37, 80, False, 0, 0.0),
        (2, 4, 2, 5, 37, 80, True, 0, 0.0),
        (1, 4, 4, 100, 77, 80, False, 20, 0.0),
        (1, 8, 2, 70, 70, 128, True, 0, 0.0),
        # softcap before the mask, in prefill and decode mode
        (1, 2, 2, 64, 64, 32, True, 0, 20.0),
        (1, 4, 2, 80, 80, 80, True, 0, 2.0),
        (2, 4, 1, 3, 90, 64, False, 0, 2.0),
        # sliding windows, prefill and decode mode
        (1, 2, 2, 128, 128, 32, True, 16, 0.0),
        (1, 2, 2, 128, 128, 32, True, 64, 0.0),
        (1, 2, 2, 128, 128, 32, True, 128, 0.0),
        (1, 4, 2, 200, 200, 80, True, 48, 0.0),
        (1, 4, 4, 7, 40, 64, True, 3, 0.0),
        # decode mode with GQA group 4: Sq from 1 to 15 query rows share K/V
        (2, 8, 2, 1, 575, 80, False, 0, 0.0),
        (2, 8, 2, 2, 100, 64, False, 0, 0.0),
        (1, 8, 2, 3, 33, 128, True, 0, 0.0),
        (2, 8, 2, 4, 70, 16, False, 0, 0.0),
        (1, 8, 2, 5, 260, 64, True, 0, 0.0),
        (2, 8, 2, 6, 31, 80, False, 0, 0.0),
        (1, 8, 2, 7, 7, 32, True, 0, 0.0),
        (1, 8, 2, 8, 200, 128, False, 0, 0.0),
        (1, 8, 2, 9, 129, 80, False, 0, 0.0),
        (2, 8, 2, 10, 96, 16, True, 0, 0.0),
        (1, 8, 2, 11, 500, 80, False, 0, 0.0),
        (1, 8, 2, 12, 12, 64, True, 0, 0.0),
        (2, 8, 2, 13, 77, 32, False, 0, 0.0),
        (1, 8, 2, 14, 41, 128, True, 0, 0.0),
        (2, 8, 2, 15, 64, 64, True, 0, 0.0),
        (1, 8, 2, 15, 300, 128, False, 0, 0.0),
        (1, 4, 4, 1, 0, 64, False, 0, 0.0),
        # every head dim with ragged Sq != Sk, in prefill mode
        (2, 4, 2, 37, 53, 16, True, 0, 0.0),
        (2, 4, 2, 53, 37, 32, False, 0, 0.0),
        (2, 4, 2, 81, 130, 64, True, 0, 0.0),
        (2, 4, 2, 130, 81, 80, False, 0, 0.0),
        (2, 4, 2, 17, 200, 128, True, 0, 0.0),
        # gemma2's head dim 256: softcap 50, window, GQA 16/8, ragged, decode
        # over a full ring (Sk 4096) and a global cache
        (1, 16, 8, 130, 130, 256, True, 0, 50.0),
        (1, 4, 2, 300, 300, 256, True, 64, 50.0),
        (2, 4, 2, 37, 100, 256, True, 0, 0.0),
        (2, 4, 2, 150, 61, 256, False, 0, 0.0),
        (2, 16, 8, 1, 4096, 256, False, 0, 50.0),
        (2, 16, 8, 1, 5184, 256, False, 0, 50.0),
        (1, 8, 2, 7, 300, 256, True, 0, 0.0),
    ],
)
def test_kernel_matches_plain_version(dev, B, H, KV, Sq, Sk, D, causal, window, softcap, dtype):
    q = rand((B, H, Sq, D), dtype, 0, dev)
    k = rand((B, KV, Sk, D), dtype, 1, dev)
    v = rand((B, KV, Sk, D), dtype, 2, dev)
    before = fa.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,D,causal,window,softcap",
    [
        (8, 32, 32, 1, 288, 80, False, 0, 0.0),     # stablelm decode, half a 575-row cache
        (2, 16, 8, 1, 2592, 256, False, 0, 50.0),   # gemma2's global decode, split in two
        (2, 8, 2, 3, 37, 64, True, 0, 0.0),
        (1, 4, 4, 100, 77, 80, False, 20, 0.0),
        (1, 8, 2, 70, 70, 128, True, 0, 2.0),
        (1, 2, 2, 20, 16, 32, True, 0, 0.0),        # rows 16-19 admit every key
        (2, 4, 2, 1, 1, 16, False, 0, 0.0),
    ],
)
def test_lse_entry_matches_plain_version(dev, B, H, KV, Sq, Sk, D, causal, window, softcap,
                                         dtype):
    """``flash_attention_lse`` against ``attention_lse_ref``: the output
    as the forward's, the fp32 log-sum-exp of every row within 2e-5 (a
    bf16 case within 2e-2); one launch of its counter."""
    q = rand((B, H, Sq, D), dtype, 0, dev)
    k = rand((B, KV, Sk, D), dtype, 1, dev)
    v = rand((B, KV, Sk, D), dtype, 2, dev)
    before = fa.lse_launches
    out, lse = ops.flash_attention_lse(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert fa.lse_launches == before + 1
    want, want_lse = attention_lse_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **TOL[dtype])


def test_lse_entry_rows_with_no_key(dev):
    """A row that admits no key (a window past the keys) gives 0 and a
    log-sum-exp of -inf, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        q = rand((1, 2, 40, 64), dtype, 0, dev)
        k = rand((1, 2, 8, 64), dtype, 1, dev)
        out, lse = ops.flash_attention_lse(q, k, k, causal=True, window=4)
        torch.cuda.synchronize()
        want, want_lse = attention_lse_ref(q, k, k, causal=True, window=4)
        assert torch.equal(torch.isneginf(lse), torch.isneginf(want_lse))
        assert torch.isneginf(lse[:, :, 11:]).all() and not out[:, :, 11:].any()
        finite = torch.isfinite(want_lse)
        torch.testing.assert_close(lse[finite], want_lse[finite], **TOL[dtype])


def test_kernel_refuses_what_it_does_not_take(dev):
    q = rand((1, 2, 16, 48), torch.float32, 0, dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = rand((1, 2, 16, 64), torch.float16, 0, dev)
    with pytest.raises(TypeError, match="not supported"):
        ops.flash_attention(q, q, q)


def test_gemma2_ring_decode_on_card_matches_cpu(dev):
    """Smoke gemma2 at head dim 256 in fp32, a prompt of 11 past its window
    of 8: the one-pass prefill (its rings written wrapped) and 3 decode
    steps through the ring caches on the card (the kernel) give the CPU's
    (plain version) logits; the kernel runs once per layer and step."""
    cfg = smoke_config("gemma2_9b").replace(dtype="float32", logit_dtype="float32",
                                            head_dim=256)
    params, _ = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 14), generator=torch.Generator().manual_seed(1))
    P = 11
    logits = {}
    for device in ("cpu", dev):
        m = Model(cfg, device=device)
        p = {k: v.to(device) for k, v in params.items()}
        t = tokens.to(device)
        with torch.no_grad():
            cache = m.init_cache(2, 14)
            assert cache["k_loc"].shape[2] == cfg.sliding_window
            before = fa.launches
            out = [m.prefill(p, cache, {"tokens": t[:, :P]})]
            for i in range(P, 14):
                pos = torch.full((2, 1), i, dtype=torch.int32, device=device)
                out.append(m.decode_step(p, cache, {"tokens": t[:, i:i + 1], "positions": pos,
                                                    "cache_pos": i})[0])
        logits[str(device)] = torch.cat(out, dim=1).cpu()
        if device == dev:
            assert fa.launches - before == cfg.n_layers * (1 + 14 - P)
    torch.testing.assert_close(logits[str(dev)], logits["cpu"], rtol=2e-3, atol=5e-4)


def test_model_on_card_matches_cpu(dev):
    """Smoke stablelm in fp32: the card (kernel) and the CPU (plain version)
    give the same prefill logits; the kernel runs once per layer."""
    cfg = smoke_config("stablelm_3b").replace(dtype="float32", logit_dtype="float32")
    cpu = Model(cfg, device="cpu")
    params, _ = cpu.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = cpu.forward(params, {"tokens": tokens})
        gpu = Model(cfg, device=dev)
        before = fa.launches
        got, _ = gpu.forward({k: p.to(dev) for k, p in params.items()},
                             {"tokens": tokens.to(dev)})
    assert fa.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=5e-4)


def ssd_inputs(B, S, H, P, N, dtype, dev, seed=0, A_value=None):
    """x, dt, A, B, C on the card: x/B/C in ``dtype``; dt post-softplus and
    A negative in fp32, as the model makes them."""
    x = rand((B, S, H, P), dtype, seed, dev)
    dt = torch.nn.functional.softplus(rand((B, S, H), torch.float32, seed + 1, dev))
    A = (-torch.exp(rand((H,), torch.float32, seed + 2, dev) * 0.5) if A_value is None
         else torch.full((H,), A_value, device=dev))
    return x, dt, A, rand((B, S, N), dtype, seed + 3, dev), rand((B, S, N), dtype, seed + 4, dev)


SSD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


def check_ssd(args, chunk, dtype, tol):
    """One launch through ops.ssd_scan: y and the final state against
    ssd_chunked and, for a ragged length, the sequential ssd_ref."""
    B, S, H, P = args[0].shape
    N = args[3].shape[-1]
    before = ssd.launches
    y, st = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert y.dtype == dtype and y.shape == (B, S, H, P)
    assert st.dtype == torch.float32 and st.shape == (B, H, N, P)
    oracles = [lambda: ssd_chunked(*args, chunk)] + ([lambda: ssd_ref(*args)] if S % chunk else [])
    for oracle in oracles:
        want_y, want_st = oracle()
        torch.testing.assert_close(y.float(), want_y.float(), **tol(want_y))
        torch.testing.assert_close(st, want_st, **tol(want_st))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,P,N,chunk",
    [
        (1, 64, 2, 16, 8, 16),     # tests/test_kernels.py cases
        (2, 128, 3, 16, 8, 32),
        (1, 128, 1, 32, 16, 64),
        (2, 96, 2, 8, 4, 32),
        (2, 40, 8, 16, 16, 8),     # the zamba2 smoke config's widths
        (1, 100, 2, 16, 8, 32),    # ragged: S not a multiple of the chunk
        (1, 40, 2, 4, 4, 4),       # N = P = 4, chunk 4: zero-padded to the tensor-core tile
        (2, 64, 3, 8, 8, 16),      # N = P = 8, chunk 16
        (1, 37, 2, 8, 4, 4),       # ragged, chunk 4
        (2, 50, 2, 4, 8, 16),      # ragged, N 8, P 4
        (1, 70, 2, 48, 24, 32),    # widths of 6 and 3 units (padded rows)
        (1, 45, 2, 12, 20, 12),    # P and N not multiples of 8: no 16-byte copies
        (2, 200, 2, 32, 16, 128),  # ragged against chunk 128
    ],
)
def test_ssd_kernel_matches_plain_version(dev, B, S, H, P, N, chunk, dtype):
    check_ssd(ssd_inputs(B, S, H, P, N, dtype, dev), chunk, dtype, lambda want: SSD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_full_widths(dev, dtype):
    """The full config's widths (N = P = 64, chunk 128) with unit-normal
    inputs: y reaches ~170 and single outputs come from terms of ~100 that
    cancel, so in fp32 the tolerance is the worst-case rounding of a
    (chunk + N)-term fp32 sum at the output's scale (~2e-3 here); fp32
    rounding alone puts the plain chunked and sequential versions 3e-4
    apart at this shape.  bf16 keeps 3e-2."""
    chunk, N = 128, 64

    def tol(want):
        if dtype == torch.bfloat16:
            return SSD_TOL[dtype]
        return dict(rtol=1e-4, atol=(chunk + N) * 2.0 ** -24 * float(want.abs().max()))

    check_ssd(ssd_inputs(2, 256, 4, 64, N, dtype, dev), chunk, dtype, tol)


@pytest.mark.parametrize(
    "B,S,H,P,N,chunk",
    [
        (2, 64, 4, 16, 8, 16),
        (2, 100, 4, 64, 64, 128),   # zamba2_1p2b's widths, ragged
        (1, 48, 3, 8, 4, 16),       # B and C slices not 16-byte aligned
    ],
)
def test_ssd_kernel_strided_model_layout(dev, B, S, H, P, N, chunk):
    """x, B and C as slices of one (B,S,d_in+2N) tensor, as mamba2_block
    passes them: the same result as contiguous copies, and within the bf16
    tolerance of the plain version."""
    conv_out = rand((B, S, H * P + 2 * N), torch.bfloat16, 7, dev)
    xs, Bm, Cm = torch.split(conv_out, [H * P, N, N], dim=-1)
    x = xs.reshape(B, S, H, P)
    assert not x.is_contiguous()
    _, dt, A, _, _ = ssd_inputs(B, S, H, P, N, torch.bfloat16, dev)
    y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y2, st2 = ops.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), chunk=chunk)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(st, st2, rtol=0, atol=0)
    check_ssd((x, dt, A, Bm, Cm), chunk, torch.bfloat16, lambda want: SSD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_decay_property(dev, dtype):
    """With A = -50 the state dies between steps: y ~ dt (C.B) x (in bf16
    against the same formula on the bf16 inputs, to the bf16 tolerance)."""
    x, _, A, Bm, Cm = ssd_inputs(1, 32, 1, 8, 4, dtype, dev, seed=11, A_value=-50.0)
    dt = torch.full((1, 32, 1), 0.5, device=dev)
    y, _ = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    local = torch.einsum("bsn,bsn->bs", Cm.float(), Bm.float())[:, :, None, None] * 0.5 * x.float()
    tol = dict(rtol=1e-3, atol=1e-3) if dtype == torch.float32 else SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), local, **tol)


def test_ssd_kernel_refuses_what_it_does_not_take(dev):
    args = ssd_inputs(1, 32, 2, 16, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="not supported"):
        ops.ssd_scan(*args, chunk=256)
    x, dt, A, Bm, Cm = ssd_inputs(1, 32, 2, 14, 8, torch.float32, dev)   # P not a multiple of 4
    with pytest.raises(ValueError, match="not supported"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    x, dt, A, Bm, Cm = ssd_inputs(1, 32, 2, 16, 8, torch.float16, dev)
    with pytest.raises(TypeError, match="not supported"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)


def test_zamba2_on_card_matches_cpu(dev):
    """Smoke zamba2 in fp32: the card (kernels) and the CPU (plain versions)
    give the same prefill logits and caches; the SSD kernel runs once per
    Mamba2 layer, the attention kernel once per shared-block application."""
    cfg = smoke_config("zamba2_1p2b").replace(dtype="float32", logit_dtype="float32")
    cpu = Model(cfg, device="cpu")
    params, _ = cpu.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 20), generator=torch.Generator().manual_seed(1))
    n_attn = cfg.n_layers // cfg.attn_every
    with torch.no_grad():
        want_cache = cpu.init_cache(2, 24)
        want = cpu.prefill(params, want_cache, {"tokens": tokens})
        gpu = Model(cfg, device=dev)
        cache = gpu.init_cache(2, 24)
        before_ssd, before_fa = ssd.launches, fa.launches
        got = gpu.prefill({k: p.to(dev) for k, p in params.items()}, cache,
                          {"tokens": tokens.to(dev)})
    assert ssd.launches == before_ssd + cfg.n_layers
    assert fa.launches == before_fa + n_attn
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=5e-4)
    for name in want_cache:
        torch.testing.assert_close(cache[name].cpu(), want_cache[name], rtol=2e-3, atol=5e-4)


MLSTM_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def mlstm_inputs(B, S, H, D, dtype, dev, seed=0, gate_scale=None):
    """q, k, v unit normal; i ~ N(0,1) and f ~ N(1,1) (tests/test_kernels.py),
    or both N(0, gate_scale^2) for the extreme-gate case."""
    q, k, v = (rand((B, S, H, D), dtype, seed + i, dev) for i in range(3))
    ig = rand((B, S, H), torch.float32, seed + 3, dev)
    fg = rand((B, S, H), torch.float32, seed + 4, dev)
    if gate_scale is None:
        fg = fg + 1.0
    else:
        ig, fg = ig * gate_scale, fg * gate_scale
    return q, k, v, ig.to(dtype), fg.to(dtype)


def check_mlstm(args, chunk, tol, oracle=None):
    """One launch through ops.mlstm_scan: h and the final (S, n, m) against
    mlstm_chunked (or ``oracle``); h in q's dtype, the state in fp32."""
    B, S, H, D = args[0].shape
    before = mlstm.launches
    h, (S_f, n_f, m_f) = ops.mlstm_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert mlstm.launches == before + 1
    assert h.dtype == args[0].dtype and h.shape == (B, S, H, D)
    assert (S_f.shape, n_f.shape, m_f.shape) == ((B, H, D, D), (B, H, D), (B, H))
    assert S_f.dtype == n_f.dtype == m_f.dtype == torch.float32
    assert all(bool(torch.isfinite(t).all()) for t in (h, S_f, n_f, m_f))
    want_h, want_st = (oracle or (lambda *a: mlstm_chunked(*a, chunk)))(*args)
    torch.testing.assert_close(h.float(), want_h.float(), **tol)
    for got, want in zip((S_f, n_f, m_f), want_st):
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,D,chunk",
    [
        (1, 64, 2, 16, 16),     # tests/test_kernels.py cases
        (2, 128, 2, 16, 32),
        (1, 96, 1, 32, 32),
        (2, 64, 2, 8, 16),
        (2, 40, 4, 32, 8),      # the xlstm smoke config's widths
        (1, 256, 2, 384, 128),  # xlstm_125m's head dim and chunk
        (2, 40, 2, 16, 4),      # chunks that do not fill a 16-row tile
        (1, 48, 2, 16, 12),
        (2, 80, 2, 32, 20),
        (2, 64, 2, 24, 8),      # head dims that do not fill a 16-wide tile
        (2, 48, 2, 12, 16),     # ... nor whole 16-byte rows (plain loads, no TMA)
        (1, 40, 2, 20, 8),
        (1, 96, 3, 64, 32),     # every value-column width: 64 ...
        (1, 128, 2, 96, 64),    # ... 96 ...
        (1, 256, 1, 512, 128),  # ... and 64 again at the widest head
    ],
)
def test_mlstm_kernel_matches_plain_version(dev, B, S, H, D, chunk, dtype):
    check_mlstm(mlstm_inputs(B, S, H, D, dtype, dev), chunk, MLSTM_TOL[dtype])


@pytest.mark.parametrize(
    "S,chunk,D",
    [(37, 16, 8), (37, 16, 32), (200, 128, 384), (16, 128, 384), (5, 8, 96)],
)
def test_mlstm_kernel_bf16_ragged(dev, S, chunk, D):
    """bf16, S not a multiple of the chunk (S 16 against chunk 128 is the
    serve warm-up's shape): the tensor-core kernels against mlstm_chunked."""
    check_mlstm(mlstm_inputs(2, S, 2, D, torch.bfloat16, dev, seed=6), chunk,
                MLSTM_TOL[torch.bfloat16])


@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("D,S,chunk", [(8, 32, 8), (384, 256, 128)])
def test_mlstm_kernel_bf16_extreme_gates(dev, seed, D, S, chunk):
    """bf16 gate preactivations of +-20: finite, and within the bf16
    tolerance of mlstm_chunked."""
    check_mlstm(mlstm_inputs(1, S, 1, D, torch.bfloat16, dev, seed=seed, gate_scale=20.0), chunk,
                MLSTM_TOL[torch.bfloat16])


@pytest.mark.parametrize("S,chunk,D", [(100, 32, 16), (37, 16, 8), (5, 8, 32), (200, 128, 384)])
def test_mlstm_kernel_ragged_matches_sequential(dev, S, chunk, D):
    """S not a multiple of the chunk: the sequential recurrence is the oracle."""
    check_mlstm(mlstm_inputs(2, S, 2, D, torch.float32, dev, seed=5), chunk,
                MLSTM_TOL[torch.float32], oracle=mlstm_ref)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_mlstm_kernel_extreme_gates(dev, seed):
    """Gate preactivations of +-20 (tests/test_kernels.py): finite, and
    within 5e-4 of the sequential oracle."""
    check_mlstm(mlstm_inputs(1, 32, 1, 8, torch.float32, dev, seed=seed, gate_scale=20.0), 8,
                dict(rtol=5e-4, atol=5e-4), oracle=mlstm_ref)


def test_mlstm_kernel_strided_model_layout(dev):
    """The gates as the two halves of one (B,S,2H) tensor, as mlstm_block
    passes them: the same result as contiguous copies."""
    B, S, H, D = 2, 48, 4, 32
    q, k, v, _, _ = mlstm_inputs(B, S, H, D, torch.bfloat16, dev, seed=9)
    gates = rand((B, S, 2 * H), torch.bfloat16, 12, dev)
    ig, fg = torch.split(gates, [H, H], dim=-1)
    assert not ig.is_contiguous()
    h, st = ops.mlstm_scan(q, k, v, ig, fg, chunk=16)
    h2, st2 = ops.mlstm_scan(q, k, v, ig.contiguous(), fg.contiguous(), chunk=16)
    torch.testing.assert_close(h, h2, rtol=0, atol=0)
    for a, b in zip(st, st2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    check_mlstm((q, k, v, ig, fg), 16, MLSTM_TOL[torch.bfloat16])


def test_mlstm_kernel_bf16_head_major_layout(dev):
    """q, k, v as (B,H,S,D) tensors viewed as (B,S,H,D): other strides for
    the tile loads, the same result as contiguous copies, within the bf16
    tolerance of mlstm_chunked; S ragged against the chunk."""
    B, S, H, D = 2, 100, 3, 64
    q, k, v = (rand((B, H, S, D), torch.bfloat16, 20 + i, dev).transpose(1, 2) for i in range(3))
    _, _, _, ig, fg = mlstm_inputs(B, S, H, D, torch.bfloat16, dev, seed=23)
    h, st = ops.mlstm_scan(q, k, v, ig, fg, chunk=32)
    h2, st2 = ops.mlstm_scan(q.contiguous(), k.contiguous(), v.contiguous(), ig, fg, chunk=32)
    torch.testing.assert_close(h, h2, rtol=0, atol=0)
    for a, b in zip(st, st2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    check_mlstm((q, k, v, ig, fg), 32, MLSTM_TOL[torch.bfloat16])


def test_mlstm_kernel_refuses_what_it_does_not_take(dev):
    args = mlstm_inputs(1, 32, 2, 16, torch.float32, dev)
    with pytest.raises(ValueError, match="not supported"):
        ops.mlstm_scan(*args, chunk=256)
    with pytest.raises(ValueError, match="not supported"):
        ops.mlstm_scan(*mlstm_inputs(1, 32, 2, 48, torch.float32, dev), chunk=16)   # D 48
    with pytest.raises(TypeError, match="not supported"):
        ops.mlstm_scan(*mlstm_inputs(1, 32, 2, 16, torch.float16, dev), chunk=16)
    q, k, v, ig, fg = args
    with pytest.raises(TypeError, match="expected q's"):
        ops.mlstm_scan(q, k, v, ig.bfloat16(), fg, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mlstm_scan(q.transpose(1, 3).contiguous().transpose(1, 3), k, v, ig, fg, chunk=16)
    before = mlstm.launches
    with pytest.raises(ValueError, match="do not match"):
        ops.mlstm_scan(q, k, v[:, :16], ig, fg, chunk=16)
    assert mlstm.launches == before


def test_xlstm_on_card_matches_cpu(dev):
    """Smoke xlstm in fp32: the card (kernel) and the CPU (plain version)
    give the same prefill logits and caches, and the same decode step after
    it; the mLSTM kernel runs once per mLSTM layer in the prefill and not
    in decode.  20 tokens are ragged against the smoke chunk of 8."""
    cfg = smoke_config("xlstm_125m").replace(dtype="float32", logit_dtype="float32")
    cpu = Model(cfg, device="cpu")
    params, _ = cpu.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 21), generator=torch.Generator().manual_seed(1))
    n_mlstm = cfg.n_layers // cfg.xlstm_slstm_every * (cfg.xlstm_slstm_every - 1)
    step = {"positions": torch.full((2, 1), 20), "cache_pos": 20}
    with torch.no_grad():
        want_cache = cpu.init_cache(2, 24)
        want = cpu.prefill(params, want_cache, {"tokens": tokens[:, :20]})
        want_step, _ = cpu.decode_step(params, want_cache, {"tokens": tokens[:, 20:]} | step)
        gpu = Model(cfg, device=dev)
        gparams = {k: p.to(dev) for k, p in params.items()}
        cache = gpu.init_cache(2, 24)
        before = mlstm.launches
        got = gpu.prefill(gparams, cache, {"tokens": tokens[:, :20].to(dev)})
        assert mlstm.launches == before + n_mlstm
        got_step, _ = gpu.decode_step(gparams, cache, {
            "tokens": tokens[:, 20:].to(dev), "positions": step["positions"].to(dev),
            "cache_pos": 20})
    assert mlstm.launches == before + n_mlstm
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=5e-4)
    torch.testing.assert_close(got_step.cpu(), want_step, rtol=2e-3, atol=5e-4)
    for name in want_cache:
        torch.testing.assert_close(cache[name].cpu(), want_cache[name], rtol=2e-3, atol=5e-4)


# ------------------------------------------------- training: autograd (C1) --

GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,causal,window,softcap",
    [
        (2, 4, 4, 64, 64, True, 0, 0.0),
        (1, 8, 2, 100, 100, True, 16, 0.0),    # GQA 4, ragged S, window
        (1, 4, 1, 37, 70, False, 0, 50.0),     # Sq != Sk, MQA, gemma2's softcap
        (1, 4, 2, 100, 100, True, 32, 50.0),
        (1, 4, 4, 100, 77, False, 20, 0.0),    # rows 96.. see no key: fully masked
    ],
)
def test_attention_grads_match_plain_version(dev, B, H, KV, Sq, Sk, D, causal, window,
                                             softcap, dtype):
    """Through ops.flash_attention on inputs that require grad: the output
    carries a gradient, made by the backward kernel (one call), equal to
    autograd of attention_ref in fp32 on the same inputs."""
    q = rand((B, H, Sq, D), dtype, 0, dev).requires_grad_()
    k = rand((B, KV, Sk, D), dtype, 1, dev).requires_grad_()
    v = rand((B, KV, Sk, D), dtype, 2, dev).requires_grad_()
    dout = rand((B, H, Sq, D), dtype, 3, dev)
    before, before_bwd = fa.launches, fa.bwd_launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    assert out.requires_grad and out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (before + 1, before_bwd + 1)
    ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want_out = attention_ref(*ref_in, causal=causal, window=window, softcap=softcap)
    want = torch.autograd.grad(want_out, ref_in, dout.float())
    for got, w, t in zip(grads, want, (q, k, v)):
        assert got.dtype == t.dtype and got.shape == t.shape
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), w, **GRAD_TOL[dtype])


def attention_grads(q, k, v, dout, **opts):
    """(dq, dk, dv) through ops.flash_attention (one backward call, counted)
    and autograd of attention_ref in fp32 on the same inputs."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    before = fa.bwd_launches
    grads = torch.autograd.grad(ops.flash_attention(q, k, v, **opts), (q, k, v), dout)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    return grads, torch.autograd.grad(attention_ref(*ref_in, **opts), ref_in, dout.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [80, 128, 256])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,causal",
    [
        (1, 4, 4, 63, 63, True),     # one row / key short of a 64-row tile
        (1, 4, 4, 65, 65, True),     # one past it
        (1, 4, 2, 127, 127, True),
        (1, 4, 2, 129, 129, True),
        (1, 4, 4, 1, 300, False),    # one query row against a ragged 300 keys
        (1, 4, 4, 17, 300, False),
        (1, 8, 1, 129, 129, True),   # GQA 8: dk / dv sum over 8 query heads
    ],
)
def test_attention_grads_on_tile_edges(dev, B, H, KV, Sq, Sk, D, causal, dtype):
    """Shapes on the edges of the bf16 kernels' 64-row / 64-key tiles (32
    query rows at D 128 and 256 in the dK / dV launches, 32-key tiles at D
    256 in the dQ launch) and of the scalar kernels' 32-row tiles, against
    autograd of attention_ref in fp32."""
    q = rand((B, H, Sq, D), dtype, 10, dev)
    k, v = rand((B, KV, Sk, D), dtype, 11, dev), rand((B, KV, Sk, D), dtype, 12, dev)
    grads, want = attention_grads(q, k, v, rand((B, H, Sq, D), dtype, 13, dev), causal=causal)
    for got, w, t in zip(grads, want, (q, k, v)):
        assert got.dtype == t.dtype and got.shape == t.shape
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), w, **GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [80, 128, 256])
def test_attention_grads_with_large_logits(dev, D, dtype):
    """q and k scaled by 4 (scores of std ~16: a peaked softmax, where dS
    cancels most and the bf16 path's delta and dS roundings would show),
    GQA 4, causal, against autograd of attention_ref in fp32."""
    q = rand((1, 8, 129, D), torch.float32, 20, dev).mul(4).to(dtype)
    k = rand((1, 2, 129, D), torch.float32, 21, dev).mul(4).to(dtype)
    v = rand((1, 2, 129, D), dtype, 22, dev)
    grads, want = attention_grads(q, k, v, rand((1, 8, 129, D), dtype, 23, dev), causal=True)
    for got, w in zip(grads, want):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), w, **GRAD_TOL[dtype])


def test_attention_bwd_bf16_is_deterministic(dev):
    """No atomics: two backward calls on the same bf16 inputs give bitwise
    equal dq, dk and dv."""
    q, k, v, out_grad = (rand((2, 8, 256, 80), torch.bfloat16, 30 + i, dev) for i in range(4))
    out = fa.flash_attention_cuda(q, k, v, causal=True)
    first = fa.flash_attention_bwd_cuda(q, k, v, out, out_grad, causal=True)
    second = fa.flash_attention_bwd_cuda(q, k, v, out, out_grad, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_grads_in_the_model_layout(dev):
    """Strided q/k/v (transposed (B,S,H,D) activations) and a strided dout:
    the grads keep q's layout and match the plain version."""
    base = [rand((2, 48, 4, 32), torch.float32, i, dev).requires_grad_() for i in range(3)]
    q, k, v = (t.transpose(1, 2) for t in base)
    out = ops.flash_attention(q, k, v, causal=True)
    dout = rand((2, 4, 32, 48), torch.float32, 5, dev).transpose(2, 3)   # not row-contiguous
    grads = torch.autograd.grad(out, base, dout)
    ref_in = [t.detach().clone().requires_grad_() for t in base]
    want = torch.autograd.grad(
        attention_ref(*(t.transpose(1, 2) for t in ref_in), causal=True), ref_in, dout)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, **GRAD_TOL[torch.float32])


def test_forward_kernel_alone_refuses_grad(dev):
    q = rand((1, 2, 16, 32), torch.float32, 0, dev).requires_grad_()
    with pytest.raises(RuntimeError, match="ops.flash_attention"):
        fa.flash_attention_cuda(q, q.detach(), q.detach())
    with torch.no_grad():
        assert not fa.flash_attention_cuda(q, q, q).requires_grad


def test_ssd_and_mlstm_refuse_grad_and_serve_without(dev):
    """The raw forward wrappers record no gradient: under grad mode an input
    that requires grad is refused, naming the differentiable entry in ops.
    ops trains: its output carries a gradient, through one backward call.
    Under inference_mode and no_grad the kernels run as before."""
    sargs = list(ssd_inputs(1, 32, 2, 16, 8, torch.float32, dev))
    margs = list(mlstm_inputs(1, 32, 2, 16, torch.float32, dev))
    for i in range(5):
        for raw, name, args in ((lambda a: ssd.ssd_scan_cuda(*a, chunk=16), "ops.ssd_scan", sargs),
                                (lambda a: mlstm.mlstm_scan_cuda(*a, chunk=16), "ops.mlstm_scan",
                                 margs)):
            grad_args = [t.detach().requires_grad_() if j == i else t for j, t in enumerate(args)]
            with pytest.raises(RuntimeError, match=name):
                raw(grad_args)
            with torch.inference_mode():
                raw(grad_args)
            with torch.no_grad():
                raw(grad_args)
        for fn, args, kernel in ((lambda a: ops.ssd_scan(*a, chunk=16), sargs, ssd),
                                 (lambda a: ops.mlstm_scan(*a, chunk=16), margs, mlstm)):
            grad_args = [t.detach().requires_grad_() if j == i else t for j, t in enumerate(args)]
            before = kernel.bwd_launches
            out = fn(grad_args)[0]
            (g,) = torch.autograd.grad(out.square().sum(), grad_args[i])
            torch.cuda.synchronize()
            assert kernel.bwd_launches == before + 1 and bool(torch.isfinite(g).all())
    before = (ssd.launches, mlstm.launches)
    with torch.inference_mode():
        y, _ = ops.ssd_scan(*sargs, chunk=16)
        h, _ = ops.mlstm_scan(*margs, chunk=16)
    assert (ssd.launches, mlstm.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(y, ssd_chunked(*sargs, 16)[0], **SSD_TOL[torch.float32])
    torch.testing.assert_close(h, mlstm_chunked(*margs, 16)[0], **MLSTM_TOL[torch.float32])


# ------------------------------------------ SSD and mLSTM backward kernels --
#
# Each backward against autograd of its plain version in fp32 on the same
# inputs, as chip_smoke.py holds them: fp32 a relative rms of 1e-4 and a
# max abs error of 1e-4 times the gradient's largest entry (an entry that
# is small because its terms cancel differs by more between two fp32
# summation orders); bf16 a relative rms of 2e-2 (the SSD backward's bf16
# path is its tensor-core kernel, the mLSTM's the same scalar fp32
# arithmetic as its fp32 path, inputs and gradients rounded to bf16).

BWD_REL_RMS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def rel_rms(got, want) -> float:
    return float((got.double() - want.double()).square().mean().sqrt()
                 / want.double().square().mean().sqrt().clamp_min(1e-30))


def assert_bwd_close(got, want, inputs, dtype):
    for g, w, t in zip(got, want, inputs):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert bool(torch.isfinite(g).all())
        assert rel_rms(g.float(), w) <= BWD_REL_RMS[dtype]
        if dtype == torch.float32:
            assert float((g - w).abs().max()) <= BWD_REL_RMS[dtype] * float(w.abs().max())


def ssd_plain_grads(args, chunk, dy, dfinal):
    t = [a.detach().float().requires_grad_() for a in args]
    y, st = ssd_chunked(*t, chunk)
    outs, cots = [y], [dy.float()]
    if dfinal is not None:
        outs.append(st)
        cots.append(dfinal)
    return torch.autograd.grad(outs, t, cots)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,with_final", [
    (1, 64, 2, 16, 8, 16, False),
    (2, 100, 3, 8, 4, 32, True),      # ragged S
    (1, 5, 2, 4, 4, 8, False),        # S shorter than a chunk
    (2, 96, 2, 64, 64, 32, True),     # the widest N and P
    (1, 37, 3, 12, 20, 12, False),    # widths that are not powers of two
    (2, 200, 4, 64, 64, 128, True),   # zamba2's widths and chunk, ragged
    (1, 40, 2, 4, 4, 4, False),       # chunk 4: one 16-row tile, 12 rows of it padding
    (2, 50, 3, 20, 12, 128, True),    # S shorter than a chunk of 128, widths not multiples of 16
    (1, 230, 2, 48, 36, 100, True),   # 7 row tiles of 16, 3 column tiles of N and of P
])
def test_ssd_grads_match_plain_version(dev, B, S, H, P, N, chunk, with_final, dtype):
    args = ssd_inputs(B, S, H, P, N, dtype, dev, seed=S + N)
    dy = rand((B, S, H, P), dtype, S + 7, dev)
    dfinal = rand((B, H, N, P), torch.float32, S + 8, dev) if with_final else None
    before = ssd.bwd_launches
    got = ssd.ssd_scan_bwd_cuda(*args, dy, dfinal, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.bwd_launches == before + 1
    assert_bwd_close(got, ssd_plain_grads(args, chunk, dy, dfinal), args, dtype)


def test_ssd_grads_in_the_model_layout(dev):
    """x, B and C as views of one (B,S,H*P+2N) tensor, as mamba2_block
    passes them, through ops.ssd_scan and autograd: the gradients land in
    the split."""
    B, S, H, P, N = 2, 48, 2, 16, 8
    xbc = rand((B, S, H * P + 2 * N), torch.float32, 3, dev).requires_grad_()
    dt = torch.nn.functional.softplus(rand((B, S, H), torch.float32, 4, dev))
    A = -torch.exp(rand((H,), torch.float32, 5, dev) * 0.5)
    dy = rand((B, S, H, P), torch.float32, 6, dev)

    def run(fn):
        xs, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
        y, _ = fn(xs.reshape(B, S, H, P), dt, A, Bm, Cm)
        return torch.autograd.grad(y, xbc, dy)[0]

    got = run(lambda *a: ops.ssd_scan(*a, chunk=16))
    want = run(lambda *a: ssd_chunked(*a, 16))
    torch.testing.assert_close(got, want, **GRAD_TOL[torch.float32])


def test_ssd_grads_finite_where_the_unmasked_exp_overflows(dev):
    """Chunk 128 with dt 0.8 and A -1: a chunk's log-decay spans ~100, past
    fp32's exp range; the gradient is finite and equals the sequential
    oracle's."""
    x, _, _, Bm, Cm = ssd_inputs(1, 256, 2, 8, 4, torch.float32, dev, seed=9)
    dt = torch.full((1, 256, 2), 0.8, device=dev)
    A = torch.tensor([-1.0, -0.5], device=dev)
    dy = rand((1, 256, 2, 8), torch.float32, 10, dev)
    got = ssd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=128)
    t = [a.detach().requires_grad_() for a in (x, dt, A, Bm, Cm)]
    want = torch.autograd.grad(ssd_ref(*t)[0], t, dy)
    assert_bwd_close(got, want, (x, dt, A, Bm, Cm), torch.float32)


def test_ssd_grads_bf16_where_the_unmasked_exp_overflows(dev):
    """The bf16 twin of the case above: the tensor-core kernel forms
    2^(cum_i - cum_j) only where j <= i, so its gradient stays finite."""
    x, _, _, Bm, Cm = ssd_inputs(1, 256, 2, 8, 4, torch.bfloat16, dev, seed=9)
    dt = torch.full((1, 256, 2), 0.8, device=dev)
    A = torch.tensor([-1.0, -0.5], device=dev)
    dy = rand((1, 256, 2, 8), torch.bfloat16, 10, dev)
    got = ssd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=128)
    t = [a.detach().float().requires_grad_() for a in (x, dt, A, Bm, Cm)]
    want = torch.autograd.grad(ssd_ref(*t)[0], t, dy.float())
    assert_bwd_close(got, want, (x, dt, A, Bm, Cm), torch.bfloat16)


@pytest.mark.parametrize("P,N", [(12, 20), (64, 64)])
def test_ssd_grads_bf16_in_the_model_layout(dev, P, N):
    """x, B and C as views of one bf16 (B,S,H*P+2N) tensor straight into
    the backward: with P 12, N 20 (and dy a view starting 4 bytes into its
    rows) the rows are not whole 16-byte units and the kernel loads them
    element by element; with P = N = 64 by cp.async."""
    B, S, H = 2, 150, 3
    xbc = rand((B, S, H * P + 2 * N), torch.bfloat16, 21, dev)
    xs, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
    x = xs.reshape(B, S, H, P)
    dt = torch.nn.functional.softplus(rand((B, S, H), torch.float32, 22, dev))
    A = -torch.exp(rand((H,), torch.float32, 23, dev) * 0.5)
    dy = (rand((B, S + 3, H, P + 4), torch.bfloat16, 24, dev)[:, 3:, :, 2:P + 2] if P == 12
          else rand((B, S, H, P), torch.bfloat16, 24, dev))
    args = (x, dt, A, Bm, Cm)
    got = ssd.ssd_scan_bwd_cuda(*args, dy, chunk=64)
    assert_bwd_close(got, ssd_plain_grads(args, 64, dy, None), args, torch.bfloat16)


def exact_ratio(got, exact) -> float:
    """Worst err / (1e-4 + 1e-4 |exact|) over every entry of every gradient."""
    return max(float(((g.double() - e).abs() / (1e-4 + 1e-4 * e.abs())).max())
               for g, e in zip(got, exact))


@pytest.mark.parametrize("case", ["ssd zamba2 widths S 200 chunk 128 +dfinal",
                                  "ssd (1,128,1,32) N 16 chunk 64",
                                  "mlstm D 384 S 200 chunk 128"])
def test_fp32_backward_elementwise_against_fp64(dev, case):
    """ROADMAP C2: at these shapes the fp32 plain versions stay within
    err / (1e-4 + 1e-4 |exact|) <= 1 of the fp64 gradient (autograd of the
    oracle on fp64 inputs), and so must each fp32 kernel, entry by entry."""
    if case.startswith("mlstm"):
        args = mlstm_inputs(1, 200, 2, 384, torch.float32, dev, seed=31)
        dh = rand((1, 200, 2, 384), torch.float32, 32, dev)
        got = mlstm.mlstm_scan_bwd_cuda(*args, dh, chunk=128)
        t = [a.detach().double().requires_grad_() for a in args]
        exact = torch.autograd.grad(mlstm_ref(*t)[0], t, dh.double())
    else:
        B, S, H, P, N, chunk, with_final = ((2, 200, 4, 64, 64, 128, True) if "zamba2" in case
                                            else (1, 128, 1, 32, 16, 64, False))
        args = ssd_inputs(B, S, H, P, N, torch.float32, dev, seed=33)
        dy = rand((B, S, H, P), torch.float32, 34, dev)
        dfinal = rand((B, H, N, P), torch.float32, 35, dev) if with_final else None
        got = ssd.ssd_scan_bwd_cuda(*args, dy, dfinal, chunk=chunk)
        t = [a.detach().double().requires_grad_() for a in args]
        y, st = ssd_ref(*t) if with_final else ssd_chunked(*t, chunk)
        outs, cots = [y], [dy.double()]
        if with_final:
            outs.append(st)
            cots.append(dfinal.double())
        exact = torch.autograd.grad(outs, t, cots)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert exact_ratio(got, exact) <= 1.0


def mlstm_plain_grads(args, chunk, dh):
    t = [a.detach().float().requires_grad_() for a in args]
    return torch.autograd.grad(mlstm_chunked(*t, chunk)[0], t, dh.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,D,chunk,gate_scale", [
    (1, 64, 2, 16, 16, None),
    (2, 100, 2, 16, 32, None),        # ragged S
    (1, 5, 2, 8, 8, None),            # S shorter than a chunk
    (2, 64, 2, 12, 16, None),         # D not a multiple of 8
    (1, 96, 1, 64, 32, None),         # two value-column blocks
    (1, 230, 2, 96, 64, None),        # three column tiles, four row tiles, ragged S
    (1, 200, 2, 384, 128, None),      # xlstm's head dim and chunk, ragged
    (1, 32, 1, 8, 8, 20.0),           # gates of +-20: the e^{-m} floor wins on some rows
])
def test_mlstm_grads_match_plain_version(dev, B, S, H, D, chunk, gate_scale, dtype):
    args = mlstm_inputs(B, S, H, D, dtype, dev, seed=S + D, gate_scale=gate_scale)
    dh = rand((B, S, H, D), dtype, S + 9, dev)
    before = mlstm.bwd_launches
    got = mlstm.mlstm_scan_bwd_cuda(*args, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert mlstm.bwd_launches == before + 1
    assert_bwd_close(got, mlstm_plain_grads(args, chunk, dh), args, dtype)


def test_mlstm_grads_bf16_in_the_model_layout(dev):
    """The gates as the two halves of one (B,S,2H) bf16 tensor, as
    mlstm_block passes them, straight into the tensor-core backward."""
    B, S, H, D = 2, 150, 4, 64
    q, k, v, _, _ = mlstm_inputs(B, S, H, D, torch.bfloat16, dev, seed=41)
    gates = rand((B, S, 2 * H), torch.float32, 42, dev)
    gates[..., H:] += 1.0
    ig, fg = torch.split(gates.to(torch.bfloat16), H, dim=-1)
    dh = rand((B, S, H, D), torch.bfloat16, 43, dev)
    args = (q, k, v, ig, fg)
    got = mlstm.mlstm_scan_bwd_cuda(*args, dh, chunk=32)
    assert_bwd_close(got, mlstm_plain_grads(args, 32, dh), args, torch.bfloat16)


def test_mlstm_backward_path_follows_dtype(dev):
    """The dtype alone picks the backward's kernels: a bf16 call runs the
    five tensor-core kernels, an fp32 call the four scalar ones; each call
    counts once in bwd_launches."""
    from torch.profiler import ProfilerActivity, profile

    ran = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = mlstm_inputs(1, 64, 2, 32, dtype, dev, seed=44)
        dh = rand((1, 64, 2, 32), dtype, 45, dev)
        before = mlstm.bwd_launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mlstm.mlstm_scan_bwd_cuda(*args, dh, chunk=16)
            torch.cuda.synchronize()
        assert mlstm.bwd_launches == before + 1
        ran[dtype] = sorted({m.group(1) for e in prof.key_averages()
                             for m in [re.search(r"(mlstm_bwd_\w+)", e.key)] if m})
    assert ran[torch.bfloat16] == sorted(["mlstm_bwd_states_bf16", "mlstm_bwd_chunk_bf16",
                                          "mlstm_bwd_dstates_bf16", "mlstm_bwd_out_bf16",
                                          "mlstm_bwd_gates_bf16"])
    assert ran[torch.float32] == sorted(["mlstm_bwd_states", "mlstm_bwd_main",
                                         "mlstm_bwd_reduce_qk", "mlstm_bwd_reduce_gates"])


def test_mlstm_function_final_state_is_not_differentiable(dev):
    args = [a.requires_grad_() for a in mlstm_inputs(1, 32, 2, 16, torch.float32, dev)]
    h, (S_f, n_f, m_f) = ops.mlstm_scan(*args, chunk=16)
    assert h.requires_grad
    assert not any(t.requires_grad for t in (S_f, n_f, m_f))
    dh = rand(h.shape, torch.float32, 11, dev)
    got = torch.autograd.grad(h, args, dh)
    assert_bwd_close(got, mlstm_plain_grads(args, 16, dh), args, torch.float32)


@pytest.mark.parametrize("kind", ["ssd", "mlstm"])
def test_recurrent_backward_bf16_is_deterministic(dev, kind):
    """No atomics: two calls at the train shape give the same bits."""
    if kind == "ssd":
        args = ssd_inputs(8, 512, 64, 64, 64, torch.bfloat16, dev)
        dy = rand((8, 512, 64, 64), torch.bfloat16, 12, dev)
        a, b = (ssd.ssd_scan_bwd_cuda(*args, dy, chunk=128) for _ in range(2))
    else:
        args = mlstm_inputs(8, 512, 4, 384, torch.bfloat16, dev)
        dh = rand((8, 512, 4, 384), torch.bfloat16, 13, dev)
        a, b = (mlstm.mlstm_scan_bwd_cuda(*args, dh, chunk=128) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_card_matches_cpu(dev, remat):
    """Smoke stablelm in fp32: two train steps on the card (both attention
    kernels) and on the CPU (plain attention) from the same params and
    batches give the same losses, grad norms and params; per step the
    forward kernel runs once per layer (twice with remat, the recompute)
    and the backward once per layer."""
    cfg = smoke_config("stablelm_3b").replace(dtype="float32", logit_dtype="float32",
                                              remat=remat)
    cpu = Model(cfg, device="cpu")
    state = build_init_fn(cpu)(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=dev)
    gstate = state._replace(
        params={k: p.detach().to(dev).requires_grad_() for k, p in state.params.items()},
        opt=state.opt._replace(step=state.opt.step.to(dev),
                               mu={k: m.to(dev) for k, m in state.opt.mu.items()},
                               nu={k: m.to(dev) for k, m in state.opt.nu.items()}),
        step=state.step.to(dev))
    cpu_step, gpu_step = build_train_step(cpu, lr=1e-2), build_train_step(gpu, lr=1e-2)
    data = SyntheticTokens(cfg, 2, 24)
    for i in range(2):
        batch = data.sample(i)
        before, before_bwd = fa.launches, fa.bwd_launches
        gstate, gm = gpu_step(gstate, to_device(batch, dev))
        torch.cuda.synchronize()
        assert fa.launches - before == cfg.n_layers * (2 if remat else 1)
        assert fa.bwd_launches - before_bwd == cfg.n_layers
        state, m = cpu_step(state, to_device(batch, "cpu"))
        torch.testing.assert_close(gm["loss"].cpu(), m["loss"], rtol=2e-3, atol=5e-4)
        torch.testing.assert_close(gm["grad_norm"].cpu(), m["grad_norm"], rtol=2e-3, atol=5e-4)
    for k, p in state.params.items():
        torch.testing.assert_close(gstate.params[k].detach().cpu(), p.detach(),
                                   rtol=2e-3, atol=5e-4)


# ------------------------------------------------------------- elastic loop --


def test_slots_resolve_to_the_card(dev):
    from repro_torch.elastic import DevicePool, ElasticTrainer, device_slots
    from repro_torch.malleability import get_scenario

    assert all(s.device.type == "cuda" for s in device_slots(3))
    assert all(s.device.type == "cuda" for devs in DevicePool().nodes.values() for s in devs)
    tr = ElasticTrainer.from_scenario(Model(smoke_config("stablelm_3b"), device=dev),
                                      get_scenario("steady-cycle"), batch=2, seq=8)
    assert all(s.device.type == "cuda" for s in tr.runtime.devices)


def test_elastic_trainer_on_card_matches_cpu(dev):
    """Smoke stablelm in fp32 on the scripted trace of
    ``tests/test_elastic_trainer.py`` (expand 1->4, TS-shrink to 2, a
    failure to 1): the card's run (both attention kernels) and the CPU's
    (plain attention) from the same params give the same records, node
    counts and logged bytes, and losses within the model tolerance."""
    from repro_torch.elastic import DevicePool, ElasticRuntime, ElasticTrainer, SimulatedRMS
    from repro_torch.elastic import device_slots
    from repro_torch.elastic.rms import EventKind

    cfg = smoke_config("stablelm_3b").replace(dtype="float32", logit_dtype="float32")
    events = [(5, EventKind.GROW, 4), (10, EventKind.SHRINK, (2, 3)), (15, EventKind.FAIL, 1)]
    state = build_init_fn(Model(cfg, device="cpu"))(torch.Generator().manual_seed(0))

    def trainer(device):
        tr = ElasticTrainer(
            model=Model(cfg, device=device),
            runtime=ElasticRuntime(pool=DevicePool(devices=device_slots(8, device)),
                                   initial_nodes=1),
            rms=SimulatedRMS.scripted(events), batch=8, seq=32)
        # copies: a run updates its state in place
        params = {k: p.detach().clone().to(device).requires_grad_()
                  for k, p in state.params.items()}
        tr._state = state._replace(
            params=params,
            opt=state.opt._replace(step=state.opt.step.clone().to(device),
                                   mu={k: m.clone().to(device) for k, m in state.opt.mu.items()},
                                   nu={k: m.clone().to(device) for k, m in state.opt.nu.items()}),
            step=state.step.clone().to(device))
        return tr

    gpu = trainer(dev)
    before, before_bwd = fa.launches, fa.bwd_launches
    gpu.run(20)
    torch.cuda.synchronize()
    assert fa.launches - before == 20 * cfg.n_layers * (1 + int(cfg.remat))
    assert fa.bwd_launches - before_bwd == 20 * cfg.n_layers
    cpu = trainer("cpu")
    cpu.run(20)
    assert [r.n_nodes for r in gpu.history] == [r.n_nodes for r in cpu.history]
    assert gpu.runtime.history == cpu.runtime.history
    assert gpu.transfer_log == cpu.transfer_log
    torch.testing.assert_close(torch.tensor(gpu.losses()), torch.tensor(cpu.losses()),
                               rtol=2e-3, atol=5e-4)


def test_moe_train_step_on_card_matches_cpu(dev):
    """Smoke phi3.5-MoE in fp32 with remat: a train step on the card (both
    attention kernels; the MoE layer's batched matmuls) and on the CPU
    (plain attention) from the same params and batch give the same loss,
    grad norm and params; the forward kernel runs twice a layer (the
    recompute) and the backward once."""
    cfg = smoke_config("phi35_moe_42b").replace(dtype="float32", logit_dtype="float32",
                                                remat=True)
    cpu = Model(cfg, device="cpu")
    state = build_init_fn(cpu)(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=dev)
    gstate = state._replace(
        params={k: p.detach().clone().to(dev).requires_grad_() for k, p in state.params.items()},
        opt=state.opt._replace(step=state.opt.step.clone().to(dev),
                               mu={k: m.clone().to(dev) for k, m in state.opt.mu.items()},
                               nu={k: m.clone().to(dev) for k, m in state.opt.nu.items()}),
        step=state.step.clone().to(dev))
    batch = SyntheticTokens(cfg, 2, 24).sample(0)
    before, before_bwd = fa.launches, fa.bwd_launches
    gstate, gm = build_train_step(gpu, lr=1e-2)(gstate, to_device(batch, dev))
    torch.cuda.synchronize()
    assert fa.launches - before == 2 * cfg.n_layers
    assert fa.bwd_launches - before_bwd == cfg.n_layers
    state, m = build_train_step(cpu, lr=1e-2)(state, to_device(batch, "cpu"))
    torch.testing.assert_close(gm["loss"].cpu(), m["loss"], rtol=2e-3, atol=5e-4)
    torch.testing.assert_close(gm["grad_norm"].cpu(), m["grad_norm"], rtol=2e-3, atol=5e-4)
    for k, p in state.params.items():
        torch.testing.assert_close(gstate.params[k].detach().cpu(), p.detach(),
                                   rtol=2e-3, atol=5e-4)


def test_gemma2_train_step_on_card_matches_cpu(dev):
    """Smoke gemma2 at its own head dim of 256, in fp32 with remat (local
    layers of window 8 and global ones, softcap 50, over 24 positions): a
    train step on the card (the attention backward at D 256) and on the
    CPU (plain attention) from the same params and batch give the same
    loss, grad norm and params; the forward kernel runs twice a layer and
    the backward once."""
    cfg = smoke_config("gemma2_9b").replace(dtype="float32", logit_dtype="float32",
                                            remat=True, head_dim=256)
    cpu = Model(cfg, device="cpu")
    state = build_init_fn(cpu)(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=dev)
    gstate = state._replace(
        params={k: p.detach().clone().to(dev).requires_grad_() for k, p in state.params.items()},
        opt=state.opt._replace(step=state.opt.step.clone().to(dev),
                               mu={k: m.clone().to(dev) for k, m in state.opt.mu.items()},
                               nu={k: m.clone().to(dev) for k, m in state.opt.nu.items()}),
        step=state.step.clone().to(dev))
    batch = SyntheticTokens(cfg, 2, 24).sample(0)
    before, before_bwd = fa.launches, fa.bwd_launches
    gstate, gm = build_train_step(gpu, lr=1e-2)(gstate, to_device(batch, dev))
    torch.cuda.synchronize()
    assert fa.launches - before == 2 * cfg.n_layers
    assert fa.bwd_launches - before_bwd == cfg.n_layers
    state, m = build_train_step(cpu, lr=1e-2)(state, to_device(batch, "cpu"))
    torch.testing.assert_close(gm["loss"].cpu(), m["loss"], rtol=2e-3, atol=5e-4)
    torch.testing.assert_close(gm["grad_norm"].cpu(), m["grad_norm"], rtol=2e-3, atol=5e-4)
    for k, p in state.params.items():
        torch.testing.assert_close(gstate.params[k].detach().cpu(), p.detach(),
                                   rtol=2e-3, atol=5e-4)


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_125m"])
def test_recurrent_train_step_on_card_matches_cpu(dev, arch):
    """Smoke zamba2 and xlstm in fp32 with remat: a train step on the card
    (the SSD or mLSTM kernels forward and backward, and attention's for
    zamba2's shared block) and on the CPU (plain versions) from the same
    params and batch give the same loss, grad norm and params; per step the
    forward kernel runs twice a layer (the recompute) and the backward
    once."""
    cfg = smoke_config(arch).replace(dtype="float32", logit_dtype="float32", remat=True)
    cpu = Model(cfg, device="cpu")
    state = build_init_fn(cpu)(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=dev)
    gstate = state._replace(
        params={k: p.detach().clone().to(dev).requires_grad_() for k, p in state.params.items()},
        opt=state.opt._replace(step=state.opt.step.clone().to(dev),
                               mu={k: m.clone().to(dev) for k, m in state.opt.mu.items()},
                               nu={k: m.clone().to(dev) for k, m in state.opt.nu.items()}),
        step=state.step.clone().to(dev))
    kernel = ssd if arch == "zamba2_1p2b" else mlstm
    n = (cfg.n_layers if arch == "zamba2_1p2b"
         else cfg.n_layers // cfg.xlstm_slstm_every * (cfg.xlstm_slstm_every - 1))
    batch = SyntheticTokens(cfg, 2, 24).sample(0)
    before, before_bwd = kernel.launches, kernel.bwd_launches
    gstate, gm = build_train_step(gpu, lr=1e-2)(gstate, to_device(batch, dev))
    torch.cuda.synchronize()
    assert kernel.launches - before == 2 * n
    assert kernel.bwd_launches - before_bwd == n
    state, m = build_train_step(cpu, lr=1e-2)(state, to_device(batch, "cpu"))
    torch.testing.assert_close(gm["loss"].cpu(), m["loss"], rtol=2e-3, atol=5e-4)
    torch.testing.assert_close(gm["grad_norm"].cpu(), m["grad_norm"], rtol=2e-3, atol=5e-4)
    for k, p in state.params.items():
        torch.testing.assert_close(gstate.params[k].detach().cpu(), p.detach(),
                                   rtol=2e-3, atol=5e-4)


# ------------------------------------------------------------ ranks (A16) --


def _card_tp_ranks(out_dir: str):
    """One rank of a (1, 2) mesh on the card: one fp32 step of the
    stablelm smoke config from seed 0 (drawn on the card), tensor and
    sequence parallel over the two ranks; rank 0 saves the loss, the
    params after the step (whole) and its attention launches."""
    import os

    from repro_torch.data import make_batch_on_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import ShardingContext
    from repro_torch.train import gather_params, param_layout

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(2, device=dev)
    ctx = ShardingContext(mesh=mesh)
    cfg = smoke_config("stablelm_3b").replace(dtype="float32", logit_dtype="float32")
    model = Model(cfg, dev)
    state = build_init_fn(model, ctx)(torch.Generator(device=dev).manual_seed(0))
    before, before_bwd = fa.launches, fa.bwd_launches
    state, metrics = build_train_step(model, ctx, lr=3e-4)(
        state, make_batch_on_mesh(SyntheticTokens(cfg, 2, 24).sample(0), cfg, ctx))
    torch.cuda.synchronize()
    full = gather_params(state.params, param_layout(model, ctx))
    if mesh.rank == 0:
        torch.save({"loss": float(metrics["loss"]), "params": full,
                    "launches": (fa.launches - before, fa.bwd_launches - before_bwd),
                    "backend": mesh.backend}, os.path.join(out_dir, "tp.pt"))


def test_two_ranks_on_the_card_match_the_single_process_step(dev, tmp_path):
    """Two ranks share the card (gloo, CUDA tensors): a tensor/sequence
    parallel fp32 step equals the single-process step on the card, and
    each rank ran both attention kernels on its half of the heads."""
    from repro_torch.launch.mesh import spawn

    spawn(_card_tp_ranks, 2, (str(tmp_path),), init_file=str(tmp_path / "store"), device="cuda")
    got = torch.load(tmp_path / "tp.pt")
    assert got["backend"] == "gloo"
    cfg = smoke_config("stablelm_3b").replace(dtype="float32", logit_dtype="float32")
    assert got["launches"] == (cfg.n_layers, cfg.n_layers)
    model = Model(cfg, dev)
    state = build_init_fn(model)(torch.Generator(device=dev).manual_seed(0))
    state, metrics = build_train_step(model, lr=3e-4)(
        state, to_device(SyntheticTokens(cfg, 2, 24).sample(0), dev))
    assert abs(got["loss"] - float(metrics["loss"])) < 1e-5
    for k, p in state.params.items():
        torch.testing.assert_close(got["params"][k], p.detach().cpu(), rtol=2e-5, atol=2e-5)


def _card_collective_ranks(out_dir: str):
    """The collectives on CUDA and on CPU tensors of the same values, over
    gloo: equal results and equal gradients, fp32 and bf16."""
    import os

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives as coll

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(2, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(mesh.rank)
        x = torch.randn(4, 6, generator=g).to(dtype)
        out = {}
        for where in ("cpu", dev):
            t = x.to(where, copy=True).requires_grad_()
            y = coll.all_gather(t, mesh, "model", 1)
            z = coll.reduce_scatter(y * 2, mesh, "model", 0)
            w = coll.all_reduce(z, mesh, "model")
            m = coll.all_reduce(w.detach(), mesh, "model", op="max")
            w.sum().backward()
            out[str(where)] = [a.detach().cpu() for a in (y, z, w, m, t.grad)]
        for a, b in zip(out["cpu"], out[str(dev)]):
            assert torch.equal(a, b), dtype
    open(os.path.join(out_dir, f"ok{mesh.rank}"), "w").close()


def test_collectives_take_cuda_tensors_under_gloo(dev, tmp_path):
    from repro_torch.launch.mesh import spawn

    spawn(_card_collective_ranks, 2, (str(tmp_path),), init_file=str(tmp_path / "store"),
          device="cuda")
    assert (tmp_path / "ok0").exists() and (tmp_path / "ok1").exists()


def _card_recurrent_tp_ranks(out_dir: str):
    """One rank of a (1, 2) mesh: one fp32 step of one zamba2 smoke layer
    and of one xlstm unit, their heads split over the two ranks, on the
    card (the SSD and mLSTM kernels forward and backward on the rank's
    heads), then the same step by the same ranks on the CPU (the plain
    versions) from the same initial shards and batch: the loss, the grad
    norm and this rank's shards of the params after the step agree."""
    import dataclasses
    import os

    from repro_torch.data import make_batch_on_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import ShardingContext
    from repro_torch.train import TrainState

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(2, device=dev)
    ctx = ShardingContext(mesh=mesh)
    cpu_ctx = ShardingContext(mesh=dataclasses.replace(mesh, device=torch.device("cpu")))
    for arch, layers, kernel in (("zamba2_1p2b", 1, ssd), ("xlstm_125m", 2, mlstm)):
        cfg = smoke_config(arch).replace(n_layers=layers, dtype="float32", logit_dtype="float32")
        batch = SyntheticTokens(cfg, 2, 24).sample(0)
        model = Model(cfg, dev)
        state = build_init_fn(model, ctx)(torch.Generator(device=dev).manual_seed(0))
        init = {k: p.detach().to("cpu", copy=True) for k, p in state.params.items()}
        before, before_bwd = kernel.launches, kernel.bwd_launches
        state, got = build_train_step(model, ctx, lr=1e-2)(state,
                                                            make_batch_on_mesh(batch, cfg, ctx))
        torch.cuda.synchronize()
        assert (kernel.launches - before, kernel.bwd_launches - before_bwd) == (1, 1), arch
        params = {k: p.requires_grad_() for k, p in init.items()}
        twin = TrainState(params=params, opt=adamw_init(params),
                          step=torch.zeros((), dtype=torch.int32))
        twin, want = build_train_step(Model(cfg, "cpu"), cpu_ctx, lr=1e-2)(
            twin, make_batch_on_mesh(batch, cfg, cpu_ctx))
        torch.testing.assert_close(got["loss"].cpu(), want["loss"], rtol=2e-3, atol=5e-4)
        torch.testing.assert_close(got["grad_norm"].cpu(), want["grad_norm"], rtol=2e-3,
                                   atol=5e-4)
        for k, p in twin.params.items():
            torch.testing.assert_close(state.params[k].detach().cpu(), p.detach(), rtol=2e-3,
                                       atol=5e-4, msg=k)
    open(os.path.join(out_dir, f"ok{mesh.rank}"), "w").close()


def test_recurrent_heads_split_over_two_ranks_on_the_card_match_the_cpu(dev, tmp_path):
    """Two ranks share the card (gloo): the SSD and mLSTM kernels and their
    backwards on a slice of the heads (views of the rank's columns) give
    the plain versions' step on the same ranks on the CPU."""
    from repro_torch.launch.mesh import spawn

    spawn(_card_recurrent_tp_ranks, 2, (str(tmp_path),), init_file=str(tmp_path / "store"),
          device="cuda")
    assert (tmp_path / "ok0").exists() and (tmp_path / "ok1").exists()


# ------------------------------------------------- per-layer gathers (A16c) --

HELD_CFG = dict(d_model=256, n_heads=4, n_kv_heads=4, d_ff=1024, vocab=512, remat=True)


def _card_held_beyond_storage(ctx, layers: int) -> int:
    """The peak the card allocates in the bf16 remat forward and backward
    (``loss_and_grads``) of the narrow dense config at ``layers`` layers,
    less this rank's storage shards (params, grads, AdamW mu and nu)."""
    from repro_torch.data import make_batch_on_mesh
    from repro_torch.train import loss_and_grads, param_layout

    dev = ctx.mesh.device
    cfg = smoke_config("stablelm_3b").replace(n_layers=layers, **HELD_CFG)
    model = Model(cfg, dev)
    state = build_init_fn(model, ctx)(torch.Generator(device=dev).manual_seed(0))
    batch = make_batch_on_mesh(SyntheticTokens(cfg, 2, 64).sample(0), cfg, ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    loss_and_grads(model, state.params, batch, param_layout(model, ctx))
    torch.cuda.synchronize()
    trees = (state.params, state.params, state.opt.mu, state.opt.nu)
    storage = sum(t.numel() * t.element_size() for tree in trees for t in tree.values())
    return torch.cuda.max_memory_allocated(dev) - storage


def _card_held_ranks(out_dir: str):
    """One rank of a (1, 2) mesh on the card, at 2 and at 6 layers of a
    narrow dense config (:func:`_card_held_beyond_storage`); rank 0 saves
    both."""
    import json
    import os

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import ShardingContext

    mesh = make_host_mesh(2, device=torch.device("cuda", torch.cuda.current_device()))
    held = {layers: _card_held_beyond_storage(ShardingContext(mesh=mesh), layers)
            for layers in (2, 6)}
    if mesh.rank == 0:
        with open(os.path.join(out_dir, "held.json"), "w") as f:
            json.dump(held, f)


def test_mesh_step_holds_one_blocks_gathered_weights_on_the_card(dev, tmp_path):
    """Two ranks share the card (gloo): what a rank holds beyond its
    storage shards in a remat forward and backward grows by less than two
    blocks' gathered weights from 2 to 6 layers (each block is gathered
    in its unit; gathering the whole model first would add four)."""
    import json
    import math

    from repro_torch.launch.mesh import spawn
    from repro_torch.parallel.sharding import Mesh, ShardingContext
    from repro_torch.train import param_layout

    spawn(_card_held_ranks, 2, (str(tmp_path),), init_file=str(tmp_path / "store"), device="cuda")
    with open(tmp_path / "held.json") as f:
        held = {int(k): v for k, v in json.load(f).items()}
    cfg = smoke_config("stablelm_3b").replace(n_layers=2, **HELD_CFG)
    model = Model(cfg, "cpu")
    layout = param_layout(model, ShardingContext(mesh=Mesh((0, 1), ("data", "model"), (1, 2))))
    block = sum(math.prod(s.shape[1:]) // 2 ** sum(e == "model" for e in layout.compute[k]) * 2
                for k, s in model.abstract_params()[0].items() if k.startswith("blocks/"))
    assert held[6] - held[2] < 2 * block, (held, block)
