"""The port's CUDA kernels on the card (marked ``cuda``; they skip without one).

    python -m pytest -m cuda tests/test_torch_cuda.py

Imports no JAX: each kernel is held against the port's plain version,
which ``tests/test_torch_flash_attention.py``, ``tests/test_torch_ssd.py``
and ``tests/test_torch_mlstm.py`` hold against the JAX package on the CPU.
The attention backward is held against autograd of ``attention_ref``, and
a train step on the card against the same step on the CPU, which
``tests/test_torch_train.py`` holds against the JAX package.
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
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
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
@pytest.mark.parametrize("D", [80, 128])
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
    query rows at D 128 in the dK / dV launch) and of the scalar kernels'
    32-row tiles, against autograd of attention_ref in fp32."""
    q = rand((B, H, Sq, D), dtype, 10, dev)
    k, v = rand((B, KV, Sk, D), dtype, 11, dev), rand((B, KV, Sk, D), dtype, 12, dev)
    grads, want = attention_grads(q, k, v, rand((B, H, Sq, D), dtype, 13, dev), causal=causal)
    for got, w, t in zip(grads, want, (q, k, v)):
        assert got.dtype == t.dtype and got.shape == t.shape
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), w, **GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [80, 128])
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
    """No backward yet (ROADMAP.md A18): under grad mode an input that
    requires grad is refused, naming the item; under inference_mode and
    no_grad the kernels run as before."""
    sargs = list(ssd_inputs(1, 32, 2, 16, 8, torch.float32, dev))
    margs = list(mlstm_inputs(1, 32, 2, 16, torch.float32, dev))
    for i in range(5):
        for fn, args in ((lambda a: ops.ssd_scan(*a, chunk=16), sargs),
                         (lambda a: ops.mlstm_scan(*a, chunk=16), margs)):
            grad_args = [t.detach().requires_grad_() if j == i else t for j, t in enumerate(args)]
            with pytest.raises(RuntimeError, match="A18"):
                fn(grad_args)
            with torch.inference_mode():
                fn(grad_args)
            with torch.no_grad():
                fn(grad_args)
    before = (ssd.launches, mlstm.launches)
    with torch.inference_mode():
        y, _ = ops.ssd_scan(*sargs, chunk=16)
        h, _ = ops.mlstm_scan(*margs, chunk=16)
    assert (ssd.launches, mlstm.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(y, ssd_chunked(*sargs, 16)[0], **SSD_TOL[torch.float32])
    torch.testing.assert_close(h, mlstm_chunked(*margs, 16)[0], **MLSTM_TOL[torch.float32])


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
