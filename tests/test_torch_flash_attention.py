"""The port's flash attention on the CPU against the JAX package.

The port's ``ops.flash_attention`` on CPU tensors is its plain version;
it is held against JAX ``attention_ref`` and against the Pallas kernel
run in interpret mode, as ``tests/test_kernels.py`` runs it, on the same
numpy inputs.  The CUDA kernel itself is held against the same plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import attention_lse_ref, attention_ref  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def inputs(seed, B, H, KV, Sq, Sk, D, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D), dtype=np.float32) * scale
    k = rng.standard_normal((B, KV, Sk, D), dtype=np.float32) * scale
    v = rng.standard_normal((B, KV, Sk, D), dtype=np.float32)
    return q, k, v


def both(q, k, v, dtype):
    """The same values as JAX arrays and as CPU tensors of ``dtype``."""
    j = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (q, k, v)]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    return j, t


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def check(out, ref, tol):
    np.testing.assert_allclose(f32(out), f32(ref), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,D,bq,bk,causal",
    [
        (1, 2, 2, 128, 128, 64, 64, 64, True),    # MHA square
        (2, 8, 2, 128, 128, 64, 32, 64, True),    # GQA group=4
        (1, 4, 1, 64, 256, 32, 64, 64, False),    # MQA, cross lengths
        (2, 3, 3, 96, 96, 16, 32, 32, True),      # head dim 16, odd blocks
        (1, 4, 4, 64, 64, 80, 32, 32, True),      # stablelm's head dim 80
        (2, 4, 4, 1, 37, 80, 1, 37, False),       # decode: Sq 1, ragged Sk
    ],
)
def test_matches_jax_ref_and_pallas(B, H, KV, Sq, Sk, D, bq, bk, causal, dtype):
    fa.launches = 0
    (jq, jk, jv), (tq, tk, tv) = both(*inputs(0, B, H, KV, Sq, Sk, D), dtype)
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == (B, H, Sq, D)
    check(out, jax_attention_ref(jq, jk, jv, causal=causal), TOL[dtype])
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk)
    check(out, pallas, TOL[dtype])
    assert fa.launches == 0   # CPU tensors never reach the kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (40, 40, True, 16),     # gemma2's local layers: window, softcap
    (40, 40, True, 0),      # its global layers: causal, softcap
    (1, 24, False, 0),      # a decode step over a ring's slots
])
def test_head_dim_256_matches_jax_ref_and_pallas(Sq, Sk, causal, window, dtype):
    """gemma2's head dim, 256, with its attention softcap of 50 and GQA 2."""
    (jq, jk, jv), (tq, tk, tv) = both(*inputs(10, 1, 4, 2, Sq, Sk, 256, scale=2.0), dtype)
    opts = dict(causal=causal, window=window, softcap=50.0)
    out = ops.flash_attention(tq, tk, tv, **opts)
    assert out.dtype == tq.dtype and out.shape == (1, 4, Sq, 256)
    check(out, jax_attention_ref(jq, jk, jv, **opts), TOL[dtype])
    pallas = jax_flash_attention(jq, jk, jv, **opts, block_q=8, block_k=8)
    check(out, pallas, TOL[dtype])


@pytest.mark.parametrize("window", [16, 64, 128])
def test_window(window):
    (jq, jk, jv), (tq, tk, tv) = both(*inputs(1, 1, 2, 2, 128, 128, 32), "float32")
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    check(out, jax_attention_ref(jq, jk, jv, causal=True, window=window), TOL["float32"])
    pallas = jax_flash_attention(jq, jk, jv, causal=True, window=window,
                                 block_q=32, block_k=32)
    check(out, pallas, TOL["float32"])


def test_softcap():
    (jq, jk, jv), (tq, tk, tv) = both(*inputs(2, 1, 2, 2, 64, 64, 32, scale=4.0), "float32")
    out = ops.flash_attention(tq, tk, tv, causal=True, softcap=20.0)
    check(out, jax_attention_ref(jq, jk, jv, causal=True, softcap=20.0),
          dict(rtol=3e-5, atol=3e-5))
    pallas = jax_flash_attention(jq, jk, jv, causal=True, softcap=20.0,
                                 block_q=32, block_k=32)
    check(out, pallas, dict(rtol=3e-5, atol=3e-5))


def test_fully_masked_rows_are_zero():
    """Non-causal with a window and Sk < Sq: rows whose window holds no
    key output 0, not NaN, in both packages."""
    (jq, jk, jv), (tq, tk, tv) = both(*inputs(3, 1, 2, 2, 64, 16, 32), "float32")
    out = ops.flash_attention(tq, tk, tv, causal=False, window=8)
    ref = jax_attention_ref(jq, jk, jv, causal=False, window=8)
    assert torch.isfinite(out).all()
    assert float(out[:, :, 30:].abs().max()) == 0.0
    check(out, ref, TOL["float32"])


@pytest.mark.parametrize("seed,logsq,group", [(0, 5, 1), (7, 6, 2), (42, 7, 4), (99, 8, 2)])
def test_convex_combination(seed, logsq, group):
    """Each output row is a convex combination of V rows (|out| <= max |v|)."""
    S, KV, D = 2 ** logsq, 2, 32
    (jq, jk, jv), (tq, tk, tv) = both(*inputs(seed, 1, KV * group, KV, S, S, D), "float32")
    out = ops.flash_attention(tq, tk, tv, causal=True)
    check(out, jax_attention_ref(jq, jk, jv, causal=True), TOL["float32"])
    assert float(out.abs().max()) <= float(tv.abs().max()) + 1e-4


def test_strided_views_match_contiguous():
    """The model hands (B,S,H,D) activations transposed, without a copy."""
    q, k, v = inputs(4, 2, 4, 2, 32, 32, 16)
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).transpose(1, 2)
                  for a in (q, k, v))
    assert not tq.is_contiguous()
    out = ops.flash_attention(tq, tk, tv, causal=True)
    ref = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# The bf16 prefill kernel (csrc/flash_attention.cu, attn_prefill_wgmma)
# reads q, k and v in 64-column slabs: at D 16, 32 and 80 TMA fills the
# columns past D with zeros, Q K^T sums them (nothing), P V gives zero
# columns, and the output's stores drop them; the scale is 1/sqrt of the
# true D.  That argument on the CPU, in fp32: the plain version on the
# zero-padded inputs, q times sqrt(padded width / D) so that its
# 1/sqrt(padded width) is the true D's scale, cropped, is the unpadded
# attention (the port's and the JAX package's), output and log-sum-exp,
# within the fp32 tolerance; with the padded width's scale it is not.
PAD_CASES = {  # B, H, KV, Sq, Sk, causal, window, softcap
    "causal": (1, 2, 2, 40, 40, True, 0, 0.0),
    "window": (1, 2, 2, 40, 40, True, 16, 0.0),
    "softcap": (1, 2, 2, 40, 40, True, 0, 20.0),
    "gqa 4": (1, 8, 2, 40, 56, False, 0, 0.0),
}


def _padded(D, case, seed, *, true_scale=True):
    B, H, KV, Sq, Sk, causal, window, softcap = PAD_CASES[case]
    q, k, v = inputs(seed, B, H, KV, Sq, Sk, D, 2.0)
    width = -(-D // 64) * 64
    pad = [(0, 0)] * 3 + [(0, width - D)]
    qs = q * np.float32(math.sqrt(width / D)) if true_scale else q
    padded = [torch.from_numpy(np.pad(a, pad)) for a in (qs, k, v)]
    return (q, k, v), padded, dict(causal=causal, window=window, softcap=softcap)


@pytest.mark.parametrize("case", list(PAD_CASES))
@pytest.mark.parametrize("D", [16, 32, 80])
def test_zero_padded_head_dim_with_true_scale_is_the_attention(D, case):
    (q, k, v), padded, opts = _padded(D, case, 60 + D)
    out, lse = attention_lse_ref(*padded, **opts)
    assert out.shape[-1] > D and not out[..., D:].any()   # P V over zero columns
    out = out[..., :D]
    plain = [torch.from_numpy(a) for a in (q, k, v)]
    want, want_lse = attention_lse_ref(*plain, **opts)
    check(out, want, TOL["float32"])
    check(attention_ref(*padded, **opts)[..., :D], want, TOL["float32"])
    check(out, jax_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), **opts), TOL["float32"])
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **TOL["float32"])


@pytest.mark.parametrize("D", [16, 32, 80])
def test_zero_padded_head_dim_with_the_padded_scale_misses(D):
    (q, k, v), padded, opts = _padded(D, "causal", 60 + D, true_scale=False)
    wrong = attention_ref(*padded, **opts)[..., :D]     # 1/sqrt(width): the padded width's scale
    want = jax_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), **opts)
    assert not np.allclose(f32(wrong), f32(want), **TOL["float32"])


def test_both_directions_take_the_same_head_dims():
    """No head dim is taken by the forward and refused by the backward:
    one list, SUPPORTED_D, holds both (gemma2's 256 among them)."""
    assert fa.SUPPORTED_D == (16, 32, 64, 80, 128, 256)
    assert not hasattr(fa, "BWD_SUPPORTED_D")


def test_kernel_wrapper_refuses_cpu_tensors():
    tq, tk, tv = (torch.from_numpy(a) for a in inputs(5, 1, 2, 2, 16, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(tq, tk, tv)


# ------------------------------------------------------------- gradients --

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal,window,softcap", [
    (2, 4, 4, 24, 24, 16, True, 0, 0.0),
    (1, 8, 2, 20, 20, 32, True, 6, 0.0),      # GQA 4, window
    (1, 4, 1, 9, 17, 16, False, 0, 50.0),     # Sq != Sk, softcap 50
    (1, 4, 2, 20, 20, 80, True, 4, 2.0),      # window so short some rows see 1 key
    (1, 2, 2, 12, 5, 16, False, 3, 0.0),      # rows 7.. see no key: fully masked
    (1, 4, 2, 20, 20, 256, True, 6, 50.0),    # gemma2's head dim: GQA 2, window, softcap 50
    (1, 2, 2, 9, 17, 256, False, 0, 0.0),     # head dim 256, Sq != Sk
])
def test_plain_version_grads_match_jax(B, H, KV, Sq, Sk, D, causal, window, softcap):
    """Autograd of the plain version, which the backward kernel is held
    against on the card, equals jax.grad of the JAX attention_ref."""
    import jax

    q, k, v = inputs(7, B, H, KV, Sq, Sk, D)
    dout = np.random.default_rng(8).standard_normal((B, H, Sq, D), dtype=np.float32)
    opts = dict(causal=causal, window=window, softcap=softcap)
    _, vjp = jax.vjp(lambda *a: jax_attention_ref(*a, **opts), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*t, **opts), t, torch.from_numpy(dout))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(f32(g), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("D", [16, 80, 128, 256])
def test_autograd_function_wires_forward_and_backward(monkeypatch, D):
    """FlashAttentionFunction saves q, k, v and the forward's output and
    hands them, with the output's gradient and the mask options, to the
    backward kernel; its grads go back to q, k, v in order, at every head
    dim the kernels take (gemma2's 256 too).  The two CUDA wrappers are
    replaced by plain versions here (the kernels run on the card only)."""
    seen = {}

    def fwd(q, k, v, **opts):
        assert not torch.is_grad_enabled()
        return ops.attention_ref(q, k, v, **opts)

    def bwd(q, k, v, out, dout, **opts):
        seen.update(opts, out=out, dout=dout)
        t = [x.detach().requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            return torch.autograd.grad(ops.attention_ref(*t, **opts), t, dout)

    monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", bwd)
    q, k, v = inputs(9, 1, 4, 2, 12, 12, D)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.FlashAttentionFunction.apply(*t, True, 5, 3.0)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, t, dout)
    assert seen["causal"] is True and seen["window"] == 5 and seen["softcap"] == 3.0
    torch.testing.assert_close(seen["out"], out.detach(), rtol=0, atol=0)
    torch.testing.assert_close(seen["dout"], dout, rtol=0, atol=0)
    r = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(ops.attention_ref(*r, causal=True, window=5, softcap=3.0), r, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# The bf16 backward's roundings (csrc/flash_attention_bwd.cu, "Rounding"),
# emulated on the CPU: operands bf16, products exact, sums in fp32.  The
# kernel forms lse and delta = rowsum(P dP) in fp32 from its own scores,
# and P and dS enter the accumulations P^T dO, dS K and dS^T Q as bf16 hi
# + lo; dq, dk and dv are written in bf16.  Held against the gradient in
# float64 at the bf16 tolerance, with q and k scaled by 4 (a peaked
# softmax, where dS cancels most), causal, 129 rows (one past a dq item).
BF16_GRAD_TOL = 2e-2


def bf16(x):
    return x.to(torch.bfloat16).float()


def rounding_inputs(D, KV, seed=0, H=8, S=129):
    rng = np.random.default_rng(seed)
    draw = lambda h, scale: bf16(torch.from_numpy(  # noqa: E731
        rng.standard_normal((1, h, S, D), dtype=np.float32)) * scale)
    return draw(H, 4.0), draw(KV, 4.0), draw(KV, 1.0), draw(H, 1.0)


def exact_bwd(q, k, v, dout):
    """dq, dk, dv of causal attention written in float64."""
    group = q.shape[1] // k.shape[1]
    x = [t.double().requires_grad_() for t in (q, k, v)]
    kf, vf = (t.repeat_interleave(group, dim=1) for t in x[1:])
    s = torch.einsum("bhqd,bhkd->bhqk", x[0], kf) / math.sqrt(q.shape[-1])
    rows, keys = torch.arange(s.shape[2])[:, None], torch.arange(s.shape[3])[None, :]
    p = torch.softmax(s.masked_fill(keys > rows, float("-inf")), dim=-1)
    return torch.autograd.grad(torch.einsum("bhqk,bhkd->bhqd", p, vf), x, dout.double())


def emulate_bwd(q, k, v, dout, *, split_ds=True, delta_from_out=False):
    """The kernel's arithmetic on bf16-valued fp32 tensors: scores in log2
    units, lse and delta in fp32, P and dS as hi + lo (dS rounded once
    where ``split_ds`` is false; delta = rowsum(dO O) from the output in
    bf16 where ``delta_from_out``)."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    kf, vf = (t.repeat_interleave(group, dim=1) for t in (k, v))
    scale = 1.0 / math.sqrt(D)
    x = torch.einsum("bhqd,bhkd->bhqk", q, kf) * (scale * 1.4426950408889634)
    rows, keys = torch.arange(S)[:, None], torch.arange(S)[None, :]
    x = x.masked_fill(keys > rows, float("-inf"))
    m = x.amax(-1, keepdim=True)
    p = torch.exp2(x - (m + torch.log2(torch.exp2(x - m).sum(-1, keepdim=True))))
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, vf)
    if delta_from_out:
        delta = (dout * bf16(torch.einsum("bhqk,bhkd->bhqd", p, vf))).sum(-1, keepdim=True)
    else:
        delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)

    def hi_lo(t):
        return bf16(t) + bf16(t - bf16(t))

    ds_in = hi_lo(ds) if split_ds else bf16(ds)
    per_kv = lambda t: t.reshape(B, k.shape[1], group, S, D).sum(2)  # noqa: E731
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_in, kf) * scale
    dk = per_kv(torch.einsum("bhqk,bhqd->bhkd", ds_in, q) * scale)
    dv = per_kv(torch.einsum("bhqk,bhqd->bhkd", hi_lo(p), dout))
    return bf16(dq), bf16(dk), bf16(dv)


def tol_ratios(got, exact):
    """Each gradient's largest |got - exact| / (atol + rtol |exact|) at the
    bf16 tolerance: at most 1 is within it."""
    return [float(((g.double() - e).abs() / (BF16_GRAD_TOL * (1 + e.abs()))).max())
            for g, e in zip(got, exact)]


ROUNDING_CASES = [(80, 2), (80, 1), (128, 2), (128, 1)]   # D, KV of 8 heads: GQA 4, MQA


@pytest.mark.parametrize("D,KV", ROUNDING_CASES)
def test_bwd_bf16_rounding_plan_holds_the_tolerance(D, KV):
    """delta = rowsum(P dP) in fp32, P and dS as hi + lo: dq, dk and dv
    within the bf16 tolerance of the float64 gradient."""
    q, k, v, dout = rounding_inputs(D, KV)
    ratios = tol_ratios(emulate_bwd(q, k, v, dout), exact_bwd(q, k, v, dout))
    assert max(ratios) < 1, ratios


def test_bwd_single_rounding_of_ds_misses():
    """dS rounded once to bf16 for dS K puts dq several times further from
    the float64 gradient than hi + lo does, at every case, and past the
    bf16 tolerance (MQA at D 128): why the kernel splits dS."""
    worst = 0.0
    for D, KV in ROUNDING_CASES:
        q, k, v, dout = rounding_inputs(D, KV)
        exact = exact_bwd(q, k, v, dout)
        plan = tol_ratios(emulate_bwd(q, k, v, dout), exact)[0]
        once = tol_ratios(emulate_bwd(q, k, v, dout, split_ds=False), exact)[0]
        assert once > 3 * plan, (D, KV, once, plan)
        worst = max(worst, once)
    assert worst > 1, worst


@pytest.mark.parametrize("D,KV", ROUNDING_CASES)
def test_bwd_delta_from_the_bf16_output_misses(D, KV):
    """delta = rowsum(dO O) from the output as the backward receives it
    (bf16) puts dq and dk past the bf16 tolerance: why the kernel forms
    delta = rowsum(P dP) from its own scores."""
    q, k, v, dout = rounding_inputs(D, KV)
    ratios = tol_ratios(emulate_bwd(q, k, v, dout, delta_from_out=True), exact_bwd(q, k, v, dout))
    assert min(ratios[:2]) > 1, ratios


def test_kernel_wrappers_refuse_grad():
    """No CUDA wrapper returns an output cut from the autograd graph: under
    grad mode each forward wrapper sends callers to its differentiable entry
    in ops (ops.flash_attention, ops.ssd_scan, ops.mlstm_scan), whose
    autograd Function runs the backward kernel.  Without grad they reach
    their device check."""
    from repro_torch.kernels import mlstm, ssd

    q, k, v = (torch.from_numpy(a) for a in inputs(5, 1, 2, 2, 16, 16, 16))
    x = torch.zeros(1, 8, 2, 4)
    ssd_args = (x, torch.ones(1, 8, 2), -torch.ones(2), torch.zeros(1, 8, 4), torch.zeros(1, 8, 4))
    m = torch.zeros(1, 8, 2, 4)
    mlstm_args = (m, m, m, torch.zeros(1, 8, 2), torch.zeros(1, 8, 2))
    calls = [
        (lambda a: fa.flash_attention_cuda(*a), (q, k, v), "ops.flash_attention"),
        (lambda a: ssd.ssd_scan_cuda(*a, chunk=4), ssd_args, "ops.ssd_scan"),
        (lambda a: mlstm.mlstm_scan_cuda(*a, chunk=4), mlstm_args, "ops.mlstm_scan"),
    ]
    for fn, args, match in calls:
        for i in range(len(args)):
            grad_args = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
            with pytest.raises(RuntimeError, match=match):
                fn(grad_args)
            with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
                fn(grad_args)


def test_ops_keeps_cpu_grads_on_the_plain_version():
    t = [torch.from_numpy(a).requires_grad_() for a in inputs(6, 1, 2, 2, 8, 8, 16)]
    out = ops.flash_attention(*t)
    assert "FlashAttentionFunction" not in type(out.grad_fn).__name__


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("window", [512, 1024])
@pytest.mark.parametrize("shift", [-1, 1])
def test_d256_train_gate_sees_a_window_off_by_one(window, shift):
    """chip_smoke.py's gate at gemma2's train shapes (S = 2 x window, D
    256, softcap 50; ``region_rms_gate`` at ``ATTN_D256_TRAIN_REL_RMS``),
    at smaller windows: the exact gradient rounded to bf16 passes in every
    region, and the gradient of a window one key short or long fails on
    dq's rows past the window."""
    cs = _chip_smoke()
    S, H, D = 2 * window, 2 if window == 512 else 1, 256
    rng = np.random.default_rng(window + shift)
    q, dout = (torch.from_numpy(rng.standard_normal((1, H, S, D), dtype=np.float32))
               for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 1, S, D), dtype=np.float32))
            for _ in range(2))

    def grads(w):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attention_ref(*x, causal=True, window=w, softcap=50.0)
        return torch.autograd.grad(out, x, dout)

    exact = grads(window)
    regions = [("all", slice(None), slice(None)),
               ("before", slice(0, window), slice(0, S - window)),
               ("past", slice(window, S), slice(S - window, S))]
    failures = []
    cs.region_rms_gate(torch, "exact", [g.bfloat16() for g in exact], exact, regions, failures)
    assert failures == []
    off = [g.bfloat16() for g in grads(window + shift)]
    read = cs.region_rms_gate(torch, "off by one", off, exact, regions, failures)
    assert read["rel_rms"]["past"][0] > cs.ATTN_D256_TRAIN_REL_RMS
    assert any(f.startswith("off by one past") for f in failures)


# The bf16 D 256 prefill (csrc/flash_attention.cu, attn_prefill_wgmma)
# applies gemma2's softcap c tanh(s / c) with tanh y = 1 - 2 / (1 + 2^(2 y
# log2 e)): ex2.approx.ftz.f32 (relative error 2^-22) and rcp.approx.ftz.f32
# (one ulp, 2^-23), two special-function operations a score, where
# tanh.approx.f32 would be one with a relative error of up to 2^-10.987
# (PTX ISA).  The choice is made here on the CPU: attention_ref with its
# tanh perturbed by each form's worst error, with both signs and with the
# sign that pushes each row's output away from the exact one, against the
# exact plain version, at softcap 50.
EX2_REL, RCP_REL, TANH_APPROX_REL = 2.0 ** -22, 2.0 ** -23, 2.0 ** -10.987
SOFTCAP_EMULATION = dict(B=1, H=4, KV=2, S=384, D=256, cap=50.0)


def _pushing_sign(q, k, v, window):
    """+-1 a (query, key) score: the sign of an error in tanh that moves the
    row's output column with the widest spread of v away from the exact
    output (a larger score weights keys whose v lies above it)."""
    c = SOFTCAP_EMULATION
    group = c["H"] // c["KV"]
    kf, vf = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kf) / math.sqrt(c["D"])
    pos = torch.arange(c["S"])
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.softmax((c["cap"] * torch.tanh(s / c["cap"])).masked_fill(~mask, -math.inf), -1)
    exact = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    spread = torch.einsum("bhqk,bhkd->bhqd", p, vf.abs()) + exact.abs()
    col = spread.argmax(-1)                                      # (B, H, Sq)
    vcol = torch.gather(vf.unsqueeze(2).expand(-1, -1, c["S"], -1, -1), 4,
                        col[..., None, None].expand(-1, -1, -1, c["S"], 1))[..., 0]
    ecol = torch.gather(exact, 3, col[..., None])
    return torch.sign(vcol - ecol) * torch.sign(s)


def _tanh_two_mufu(sign):
    """tanh as the kernel forms it, each operation at its worst error with
    ``sign`` (the errors aligned: both move tanh the same way), in fp64."""
    def tanh(y):
        y = y.double()
        arg = 2.0 * math.log2(math.e) * y
        e = torch.exp2(arg) * (1 + sign * (EX2_REL + arg.abs() * math.log(2) * 2.0 ** -24))
        r = (1 + e).reciprocal() * (1 - sign * RCP_REL)
        return (1 - 2 * r).float()
    return tanh


def _tanh_approx(sign, exact):
    return lambda y: exact(y) * (1 + sign * TANH_APPROX_REL)


def _softcap_error(monkeypatch, form, signs, window, scale):
    c = SOFTCAP_EMULATION
    q, k, v = (torch.from_numpy(a) for a in inputs(40, c["B"], c["H"], c["KV"], c["S"], c["S"],
                                                   c["D"], scale))
    opts = dict(causal=True, window=window, softcap=c["cap"])
    want = attention_ref(q, k, v, **opts)
    exact = torch.tanh
    sign = {"+": 1.0, "-": -1.0}.get(signs)
    if sign is None:
        sign = _pushing_sign(q, k, v, window)
    monkeypatch.setattr(torch, "tanh", _tanh_two_mufu(sign) if form == "two_mufu"
                        else _tanh_approx(sign, exact))
    got = attention_ref(q, k, v, **opts)
    monkeypatch.undo()
    return float((got - want).abs().max()), got, want


@pytest.mark.parametrize("signs", ["+", "-", "pushing"])
@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("window", [0, 128], ids=["global", "local"])
def test_d256_prefill_softcap_holds_the_bf16_tolerance(monkeypatch, window, scale, signs):
    """The softcap's two-operation tanh at its documented worst error keeps
    the output within the bf16 tolerance of the exact plain version
    (global and local, q and k scaled by 4 saturating the cap); it stays
    far inside it, so the kernel's bf16 roundings keep the margin."""
    err, got, want = _softcap_error(monkeypatch, "two_mufu", signs, window, scale)
    check(got, want, TOL["bfloat16"])
    assert err < 1e-3, err


@pytest.mark.parametrize("window", [0, 128], ids=["global", "local"])
def test_d256_prefill_softcap_tanh_approx_would_miss_it(monkeypatch, window):
    """Why the kernel does not take tanh.approx.f32: at its documented
    worst relative error, with the sign that pushes each row's output, q
    and k scaled by 4 put the output past the bf16 tolerance (2e-2)."""
    err, got, want = _softcap_error(monkeypatch, "tanh_approx", "pushing", window, 4.0)
    assert not np.allclose(f32(got), f32(want), **TOL["bfloat16"]), err
