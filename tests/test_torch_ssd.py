"""The port's SSD scan and Mamba2 block on the CPU against the JAX package.

The port's ``ops.ssd_scan`` on CPU tensors is its plain version,
``ref.ssd_chunked``; it is held against JAX ``ssd_chunked`` and
``ssd_ref`` (y and the final state) and, on two small cases, against the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it.
The Mamba2 block's pieces are held against ``repro.models.ssm`` with the
same numpy inputs.  The CUDA kernel is held against the same plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Tolerances are those of ``tests/test_kernels.py``: 1e-4 in fp32, 3e-2
in bf16; the block-level checks use the model tolerance of
``tests/test_models.py`` (rtol 2e-3, atol 5e-4) in fp32.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd as ssd_kernel  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
MODEL_TOL = dict(rtol=2e-3, atol=5e-4)
CASES = [  # tests/test_kernels.py:89-112
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 16, 8, 32),
    (1, 128, 1, 32, 16, 64),
    (2, 96, 2, 8, 4, 32),
]


def inputs(seed, B, S, H, P, N, A_value=None):
    """x, dt (post-softplus), A (negative), B, C as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5) if A_value is None
         else np.full(H, A_value)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


def both(arrays, dtype):
    """JAX arrays and CPU tensors of the same values; x, B and C in
    ``dtype``, dt and A in fp32."""
    x, dt, A, Bm, Cm = arrays
    j = [jnp.asarray(x).astype(dtype), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm).astype(dtype), jnp.asarray(Cm).astype(dtype)]
    td = getattr(torch, dtype)
    t = [torch.from_numpy(x).to(td), torch.from_numpy(dt), torch.from_numpy(A),
         torch.from_numpy(Bm).to(td), torch.from_numpy(Cm).to(td)]
    return j, t


def f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def check(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES)
def test_ssd_chunked_matches_jax(B, S, H, P, N, chunk, dtype):
    """The port's ssd_chunked against JAX ssd_chunked and ssd_ref: y and
    the final state."""
    j, t = both(inputs(0, B, S, H, P, N), dtype)
    y, st = ref.ssd_chunked(*t, chunk)
    assert y.dtype == t[0].dtype and y.shape == (B, S, H, P)
    assert st.dtype == torch.float32 and st.shape == (B, H, N, P)
    jy, jst = jax_ssm.ssd_chunked(*j, chunk)
    check(y, jy, TOL[dtype])
    check(st, jst, TOL[dtype])
    ry, rst = jax_ssd_ref(*j)
    check(y, ry, TOL[dtype])
    check(st, rst, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_ref_matches_jax(dtype):
    j, t = both(inputs(1, 2, 24, 2, 8, 4), dtype)
    y, st = ref.ssd_ref(*t)
    jy, jst = jax_ssd_ref(*j)
    check(y, jy, TOL[dtype])
    check(st, jst, TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(1, 64, 2, 16, 8, 16), (2, 96, 2, 8, 4, 32)])
def test_ops_ssd_scan_matches_pallas_interpret(B, S, H, P, N, chunk):
    """ops.ssd_scan on CPU tensors against the Pallas kernel run in
    interpret mode; the CPU path never reaches the CUDA kernel."""
    j, t = both(inputs(2, B, S, H, P, N), "float32")
    before = ssd_kernel.launches
    y, _ = ops.ssd_scan(*t, chunk=chunk)
    assert ssd_kernel.launches == before
    check(y, jax_ssd_scan(*j, chunk=chunk), TOL["float32"])


@pytest.mark.parametrize("S,chunk", [(100, 32), (5, 8), (3, 8), (17, 16)])
def test_ragged_length_matches_jax_ssd_ref(S, chunk):
    """S not a multiple of the chunk (the JAX function asserts): the port
    pads with dt = x = B = C = 0, which is exact; y and the state equal the
    sequential recurrence."""
    j, t = both(inputs(3, 2, S, 2, 16, 8), "float32")
    y, st = ops.ssd_scan(*t, chunk=chunk)
    assert y.shape == (2, S, 2, 16)
    jy, jst = jax_ssd_ref(*j)
    check(y, jy, TOL["float32"])
    check(st, jst, TOL["float32"])


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_decay_property(seed):
    """With A = -50 the state dies between steps: y ~ dt (C.B) x
    (tests/test_kernels.py::test_ssd_decay_property)."""
    x, _, A, Bm, Cm = inputs(seed, 1, 32, 1, 8, 4, A_value=-50.0)
    dt = np.full((1, 32, 1), 0.5, np.float32)
    y, _ = ops.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=8)
    local = np.einsum("bsn,bsn->bs", Cm, Bm)[:, :, None, None] * 0.5 * x
    check(y, local, dict(rtol=1e-3, atol=1e-3))


def test_upper_triangle_cannot_overflow():
    """Large dt |A| makes cum_i - cum_j above the diagonal large and
    positive; the masked exp must not turn into inf * 0 = NaN."""
    x, dt, A, Bm, Cm = inputs(4, 1, 64, 2, 8, 4)
    dt = dt * 200.0
    y, st = ops.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    jy, jst = jax_ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    check(y, jy, TOL["float32"])


def test_kernel_wrapper_refuses_cpu_tensors():
    _, t = both(inputs(5, 1, 16, 2, 8, 4), "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernel.ssd_scan_cuda(*t, chunk=8)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(6)
    B, H, N, P = 2, 3, 4, 8
    state = rng.standard_normal((B, H, N, P), dtype=np.float32)
    x = rng.standard_normal((B, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, N), dtype=np.float32)
    Cm = rng.standard_normal((B, N), dtype=np.float32)
    args = (state, x, dt, A, Bm, Cm)
    y, st = ssm.ssd_decode_step(*(torch.from_numpy(a) for a in args))
    jy, jst = jax_ssm.ssd_decode_step(*(jnp.asarray(a) for a in args))
    check(y, jy, TOL["float32"])
    check(st, jst, TOL["float32"])


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(7)
    B, K, C = 2, 4, 12
    S = 1 if with_state else 9
    x = rng.standard_normal((B, S, C), dtype=np.float32)
    w = rng.standard_normal((K, C), dtype=np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    state = rng.standard_normal((B, K - 1, C), dtype=np.float32) if with_state else None
    out, new = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                None if state is None else torch.from_numpy(state))
    jout, jnew = jax_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      None if state is None else jnp.asarray(state))
    check(out, jout, TOL["float32"])
    if with_state:
        check(new, jnew, TOL["float32"])
    else:
        assert new is None and jnew is None


def mamba_params(seed):
    """One Mamba2 layer's params for the zamba2 smoke config, as numpy."""
    cfg = jax_smoke_config("zamba2_1p2b")
    d, d_in, N = cfg.d_model, cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    H = d_in // cfg.ssm_head_dim
    rng = np.random.default_rng(seed)
    shapes = {"in_proj": (d, 2 * d_in + 2 * N + H), "conv_w": (cfg.ssm_conv_width, d_in + 2 * N),
              "conv_b": (d_in + 2 * N,), "A_log": (H,), "D": (H,), "dt_bias": (H,),
              "norm_scale": (d_in,), "out_proj": (d_in, d)}
    return {f"m/{k}": (rng.standard_normal(s) / np.sqrt(s[0] if len(s) > 1 else 4)
                       ).astype(np.float32) for k, s in shapes.items()}


def jax_block_decode(params, cfg, x):
    """JAX mamba2_block one token at a time from zero states: the outputs
    (B,S,d) and the states after the last token."""
    shapes = jax_ssm.mamba2_state_shapes(cfg, x.shape[0])
    st = {"ssm": jnp.zeros(shapes["ssm"]), "conv": jnp.zeros(shapes["conv"])}
    outs = []
    for t in range(x.shape[1]):
        o, st = jax_ssm.mamba2_block(params, "m", cfg, x[:, t:t + 1], state=st)
        outs.append(np.asarray(o))
    return np.concatenate(outs, axis=1), st


@pytest.mark.parametrize("S", [8, 13, 2])
def test_mamba2_block_matches_jax(S):
    """Forward (S a multiple of the chunk 8, ragged, and shorter than the
    conv's K - 1 = 3), the state it collects for decode, and decode steps."""
    cfg32 = dict(dtype="float32", logit_dtype="float32")
    jcfg = jax_smoke_config("zamba2_1p2b").replace(**cfg32)
    tcfg = smoke_config("zamba2_1p2b").replace(**cfg32)
    params = mamba_params(8)
    x = np.random.default_rng(9).standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}

    ref_steps, ref_state = jax_block_decode(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        out, st = ssm.mamba2_block(tp, "m", tcfg, torch.from_numpy(x), collect_state=True)
        if S % jcfg.ssm_chunk == 0:   # the JAX forward asserts a whole number of chunks
            jout, _ = jax_ssm.mamba2_block(jp, "m", jcfg, jnp.asarray(x))
            check(out, jout, MODEL_TOL)
        check(out, ref_steps, MODEL_TOL)
        check(st["ssm"], ref_state["ssm"], MODEL_TOL)
        check(st["conv"], ref_state["conv"], MODEL_TOL)

        shapes = ssm.mamba2_state_shapes(tcfg, 2)
        state = {k: torch.zeros(s) for k, s in shapes.items()}
        for t in range(S):
            o, state = ssm.mamba2_block(tp, "m", tcfg, torch.from_numpy(x[:, t:t + 1]),
                                        state=state)
            check(o, ref_steps[:, t:t + 1], MODEL_TOL)
    check(state["ssm"], ref_state["ssm"], MODEL_TOL)
    check(state["conv"], ref_state["conv"], MODEL_TOL)


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """The library's name changes when a header under csrc/ changes (a
    shared header must not leave a stale library), and not when another
    kernel's source does."""
    from repro_torch.kernels import _build

    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "b.cu").write_text("// b\n")
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("a")
    (tmp_path / "b.cu").write_text("// b, edited\n")
    assert _build.library_path("a") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _build.library_path("a")
    assert second != first
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build.library_path("a") not in (first, second)


# ------------------------------------------------------------- gradients --
#
# Autograd of the port's plain version, which the backward kernel is held
# against on the card, against jax.vjp of the JAX functions (which
# jax.value_and_grad differentiates in training).  fp32: every gradient
# within rtol/atol 1e-4 and a relative rms of 1e-4; bf16 (both sides round
# the gradients to bf16): a relative rms of 2e-2.

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL_RMS = {"float32": 1e-4, "bfloat16": 2e-2}


def rel_rms(got, want) -> float:
    want = np.asarray(want, np.float64)
    err = np.asarray(got, np.float64) - want
    return float(np.sqrt(np.mean(err ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def assert_grads_close(got, want, dtype, tol=GRAD_TOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = f32(g), f32(w)
        assert np.isfinite(g).all(), i
        assert rel_rms(g, w) <= GRAD_REL_RMS[dtype], (i, rel_rms(g, w))
        if dtype == "float32":
            np.testing.assert_allclose(g, w, err_msg=str(i), **tol)


def cotangents(seed, B, S, H, P, N):
    """dy (B,S,H,P) and the final state's cotangent (B,H,N,P), fp32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P), dtype=np.float32),
            rng.standard_normal((B, H, N, P), dtype=np.float32))


def port_grads(t, chunk, dy, dfinal=None):
    """Autograd of ops.ssd_scan (the plain version on CPU tensors) at ``t``."""
    ins = [a.clone().requires_grad_() for a in t]
    y, st = ops.ssd_scan(*ins, chunk=chunk)
    outs, cots = [y], [torch.from_numpy(dy).to(y.dtype)]
    if dfinal is not None:
        outs.append(st)
        cots.append(torch.from_numpy(dfinal))
    return torch.autograd.grad(outs, ins, cots)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES)
def test_ssd_chunked_grads_match_jax(B, S, H, P, N, chunk, dtype):
    """dx, ddt, dA, dB, dC of y and the final state against jax.vjp of JAX
    ssd_chunked, with a cotangent on both outputs."""
    j, t = both(inputs(10, B, S, H, P, N), dtype)
    dy, dfinal = cotangents(11, B, S, H, P, N)
    _, vjp = jax.vjp(lambda *a: jax_ssm.ssd_chunked(*a, chunk), *j)
    want = vjp((jnp.asarray(dy).astype(dtype), jnp.asarray(dfinal)))
    got = port_grads(t, chunk, dy, dfinal)
    for g, a in zip(got, t):
        assert g.dtype == a.dtype and g.shape == a.shape
    assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("S,chunk", [(100, 32), (5, 8), (17, 16)])
def test_ragged_grads_match_jax_ssd_ref(S, chunk):
    """S not a multiple of the chunk: the padded tail takes no gradient, and
    the gradients equal jax.vjp of the sequential ssd_ref."""
    j, t = both(inputs(12, 2, S, 2, 16, 8), "float32")
    dy, dfinal = cotangents(13, 2, S, 2, 16, 8)
    _, vjp = jax.vjp(jax_ssd_ref, *j)
    want = vjp((jnp.asarray(dy), jnp.asarray(dfinal)))
    assert_grads_close(port_grads(t, chunk, dy, dfinal), want, "float32")


def test_masked_exp_gradient_is_finite_where_jax_chunked_is_nan():
    """A chunk of 128 whose log-decay spans more than ~88.7 (dt 0.8, A -1
    and -0.5): exp(cum_i - cum_j) above the diagonal overflows to inf, which
    JAX's where() after the exp hides from the forward but not from the vjp
    (0 x inf): its ddt and dA are NaN.  The port masks before the exp, so
    its gradient is finite, and equals the sequential ssd_ref's."""
    x, _, _, Bm, Cm = inputs(14, 1, 256, 2, 8, 4)
    dt = np.full((1, 256, 2), 0.8, np.float32)
    A = np.array([-1.0, -0.5], np.float32)
    dy, _ = cotangents(15, 1, 256, 2, 8, 4)
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    _, vjp = jax.vjp(lambda *a: jax_ssm.ssd_chunked(*a, 128)[0], *j)
    jax_grads = vjp(jnp.asarray(dy))
    assert np.isnan(np.asarray(jax_grads[1])).any() and np.isnan(np.asarray(jax_grads[2])).any()
    _, vjp_ref = jax.vjp(lambda *a: jax_ssd_ref(*a)[0], *j)
    want = vjp_ref(jnp.asarray(dy))
    got = port_grads([torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)], 128, dy)
    assert_grads_close(got, want, "float32")


def test_mamba2_block_grads_match_jax():
    """The whole Mamba2 block (in_proj, conv, the scan, gated norm, out_proj)
    at S a multiple of the smoke chunk: the gradients of every param and of
    x against jax.vjp of JAX's block, at the model tolerance and a relative
    rms of 1e-4."""
    cfg32 = dict(dtype="float32", logit_dtype="float32")
    jcfg = jax_smoke_config("zamba2_1p2b").replace(**cfg32)
    tcfg = smoke_config("zamba2_1p2b").replace(**cfg32)
    params = mamba_params(16)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 2 * jcfg.ssm_chunk, jcfg.d_model), dtype=np.float32)
    dout = rng.standard_normal(x.shape, dtype=np.float32)
    _, vjp = jax.vjp(lambda p, a: jax_ssm.mamba2_block(p, "m", jcfg, a)[0],
                     {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(dout))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = ssm.mamba2_block(tp, "m", tcfg, tx)
    got = torch.autograd.grad(out, [*tp.values(), tx], torch.from_numpy(dout))
    assert_grads_close(got, [want_p[k] for k in tp] + [want_x], "float32", MODEL_TOL)


def test_ssd_function_wires_forward_and_backward(monkeypatch):
    """SsdScanFunction saves x, dt, A, B, C and hands them, with y's and the
    final state's cotangents and the chunk, to the backward kernel; its
    grads go back to the five inputs in order, and chunk takes none.  An
    unused final state arrives as None.  The two CUDA wrappers are replaced
    by plain versions here (the kernels run on the card only)."""
    seen = []

    def fwd(x, dt, A, Bm, Cm, *, chunk):
        assert not torch.is_grad_enabled()
        return ref.ssd_chunked(x, dt, A, Bm, Cm, chunk)

    def bwd(x, dt, A, Bm, Cm, dy, dfinal=None, *, chunk):
        seen.append(dict(inputs=(x, dt, A, Bm, Cm), dy=dy, dfinal=dfinal, chunk=chunk))
        t = [a.detach().requires_grad_() for a in (x, dt, A, Bm, Cm)]
        with torch.enable_grad():
            y, st = ref.ssd_chunked(*t, chunk)
            outs, cots = [y], [dy]
            if dfinal is not None:
                outs.append(st)
                cots.append(dfinal)
            return torch.autograd.grad(outs, t, cots)

    monkeypatch.setattr(ssd_kernel, "ssd_scan_cuda", fwd)
    monkeypatch.setattr(ssd_kernel, "ssd_scan_bwd_cuda", bwd)
    _, t = both(inputs(18, 2, 24, 2, 8, 4), "float32")
    t = [a.requires_grad_() for a in t]
    dy, dfinal = (torch.from_numpy(a) for a in cotangents(19, 2, 24, 2, 8, 4))
    for use_final in (True, False):
        y, st = ssd_kernel.SsdScanFunction.apply(*t, 8)
        outs, cots = ([y, st], [dy, dfinal]) if use_final else ([y], [dy])
        got = torch.autograd.grad(outs, t, cots)
        call = seen[-1]
        assert call["chunk"] == 8
        assert all(a is b for a, b in zip(call["inputs"], t))
        torch.testing.assert_close(call["dy"], dy, rtol=0, atol=0)
        if use_final:
            torch.testing.assert_close(call["dfinal"], dfinal, rtol=0, atol=0)
        else:
            assert call["dfinal"] is None
        want = port_grads([a.detach() for a in t], 8, dy.numpy(),
                          dfinal.numpy() if use_final else None)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert len(seen) == 2


def test_ops_routes_to_the_function_only_off_the_cpu_under_grad(monkeypatch):
    """ops.ssd_scan: CPU tensors take the plain version (differentiated by
    autograd) whatever the grad mode; any other device takes the Function
    when grad mode is on and an input requires grad, and the forward kernel
    directly otherwise.  Meta tensors stand in for CUDA ones here."""
    calls = []
    monkeypatch.setattr(ops, "ssd_scan_cuda", lambda *a, chunk: calls.append("kernel"))

    class Recorder:
        @staticmethod
        def apply(*a):
            calls.append("function")

    monkeypatch.setattr(ops, "SsdScanFunction", Recorder)
    _, t = both(inputs(20, 1, 16, 2, 8, 4), "float32")
    y, _ = ops.ssd_scan(*[a.clone().requires_grad_(i == 1) for i, a in enumerate(t)], chunk=8)
    assert y.grad_fn is not None and calls == []
    meta = [a.to("meta") for a in t]
    for i in range(5):
        ops.ssd_scan(*[a.clone().requires_grad_(j == i) for j, a in enumerate(meta)], chunk=8)
    assert calls == ["function"] * 5
    calls.clear()
    ops.ssd_scan(*meta, chunk=8)
    with torch.no_grad():
        ops.ssd_scan(*[a.clone().requires_grad_() for a in meta], chunk=8)
    assert calls == ["kernel", "kernel"]
