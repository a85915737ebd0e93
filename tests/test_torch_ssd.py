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
