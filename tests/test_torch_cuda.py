"""The port's CUDA kernels on the card (marked ``cuda``; they skip without one).

    python -m pytest -m cuda tests/test_torch_cuda.py

Imports no JAX: each kernel is held against the port's plain version,
which ``tests/test_torch_flash_attention.py`` and
``tests/test_torch_ssd.py`` hold against the JAX package on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.kernels.ref import attention_ref, ssd_chunked, ssd_ref  # noqa: E402
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
    "B,H,KV,Sq,Sk,D,causal,window",
    [
        (1, 2, 2, 128, 128, 64, True, 0),
        (2, 8, 2, 128, 128, 64, True, 0),
        (1, 4, 1, 64, 256, 32, False, 0),
        (2, 3, 3, 96, 96, 16, True, 0),
        (2, 4, 4, 1, 37, 80, False, 0),
        (2, 4, 2, 5, 37, 80, True, 0),
        (1, 4, 4, 100, 77, 80, False, 20),
        (1, 8, 2, 70, 70, 128, True, 0),
    ],
)
def test_kernel_matches_plain_version(dev, B, H, KV, Sq, Sk, D, causal, window, dtype):
    q = rand((B, H, Sq, D), dtype, 0, dev)
    k = rand((B, KV, Sk, D), dtype, 1, dev)
    v = rand((B, KV, Sk, D), dtype, 2, dev)
    before = fa.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
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


def test_ssd_kernel_strided_model_layout(dev):
    """x, B and C as slices of one (B,S,d_in+2N) tensor, as mamba2_block
    passes them: the same result as contiguous copies."""
    B, S, H, P, N = 2, 64, 4, 16, 8
    conv_out = rand((B, S, H * P + 2 * N), torch.bfloat16, 7, dev)
    xs, Bm, Cm = torch.split(conv_out, [H * P, N, N], dim=-1)
    x = xs.reshape(B, S, H, P)
    assert not x.is_contiguous()
    _, dt, A, _, _ = ssd_inputs(B, S, H, P, N, torch.bfloat16, dev)
    y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    y2, st2 = ops.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), chunk=16)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(st, st2, rtol=0, atol=0)


def test_ssd_kernel_decay_property(dev):
    """With A = -50 the state dies between steps: y ~ dt (C.B) x."""
    x, _, A, Bm, Cm = ssd_inputs(1, 32, 1, 8, 4, torch.float32, dev, seed=11, A_value=-50.0)
    dt = torch.full((1, 32, 1), 0.5, device=dev)
    y, _ = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    local = torch.einsum("bsn,bsn->bs", Cm, Bm)[:, :, None, None] * 0.5 * x
    torch.testing.assert_close(y, local, rtol=1e-3, atol=1e-3)


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
