"""The port's CUDA kernels on the card (marked ``cuda``; they skip without one).

    python -m pytest -m cuda tests/test_torch_cuda.py

Imports no JAX: each kernel is held against the port's plain version,
which ``tests/test_torch_flash_attention.py``, ``tests/test_torch_ssd.py``
and ``tests/test_torch_mlstm.py`` hold against the JAX package on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mlstm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    attention_ref,
    mlstm_chunked,
    mlstm_ref,
    ssd_chunked,
    ssd_ref,
)
from repro_torch.models import Model  # noqa: E402

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


def test_kernel_refuses_what_it_does_not_take(dev):
    q = rand((1, 2, 16, 48), torch.float32, 0, dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = rand((1, 2, 16, 64), torch.float16, 0, dev)
    with pytest.raises(TypeError, match="not supported"):
        ops.flash_attention(q, q, q)


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
    ],
)
def test_mlstm_kernel_matches_plain_version(dev, B, S, H, D, chunk, dtype):
    check_mlstm(mlstm_inputs(B, S, H, D, dtype, dev), chunk, MLSTM_TOL[dtype])


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
