"""The port's mLSTM scan and xLSTM blocks on the CPU against the JAX package.

The port's ``ops.mlstm_scan`` on CPU tensors is its plain version,
``ref.mlstm_chunked``; it is held against JAX ``mlstm_chunked`` (h and
the final S, n, m) and ``mlstm_ref`` and, on two small cases, against the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it.
The mLSTM and sLSTM blocks are held against ``repro.models.xlstm`` with
the same numpy inputs.  The CUDA kernel is held against the same plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Tolerances are those of ``tests/test_kernels.py``: 2e-4 in fp32 (5e-4
for the extreme gates), 2e-2 in bf16; the block-level checks use the
model tolerance of ``tests/test_models.py`` (rtol 2e-3, atol 5e-4) in
fp32.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import mlstm_scan as jax_mlstm_scan  # noqa: E402
from repro.kernels.ref import mlstm_ref as jax_mlstm_ref  # noqa: E402
from repro.models import xlstm as jax_xlstm  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import mlstm as mlstm_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
EXTREME_TOL = dict(rtol=5e-4, atol=5e-4)
MODEL_TOL = dict(rtol=2e-3, atol=5e-4)
CASES = [  # tests/test_kernels.py:152-165
    (1, 64, 2, 16, 16),
    (2, 128, 2, 16, 32),
    (1, 96, 1, 32, 32),
]


def inputs(seed, B, S, H, D, gate_scale=None):
    """q, k, v unit normal; i ~ N(0,1), f ~ N(1,1) (tests/test_kernels.py),
    or both N(0, gate_scale^2); fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D), dtype=np.float32) for _ in range(3))
    ig = rng.standard_normal((B, S, H), dtype=np.float32)
    fg = rng.standard_normal((B, S, H), dtype=np.float32)
    if gate_scale is None:
        fg = fg + 1.0
    else:
        ig, fg = ig * gate_scale, fg * gate_scale
    return q, k, v, ig, fg


def both(arrays, dtype):
    """JAX arrays and CPU tensors of the same values, all in ``dtype``."""
    j = [jnp.asarray(a).astype(dtype) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def check(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,D,chunk", CASES)
def test_mlstm_chunked_matches_jax(B, S, H, D, chunk, dtype):
    """The port's mlstm_chunked against JAX mlstm_chunked (h and the final
    S, n, m) and JAX mlstm_ref (h)."""
    j, t = both(inputs(0, B, S, H, D), dtype)
    h, (S_f, n_f, m_f) = ref.mlstm_chunked(*t, chunk)
    assert h.dtype == t[0].dtype and h.shape == (B, S, H, D)
    assert (S_f.shape, n_f.shape, m_f.shape) == ((B, H, D, D), (B, H, D), (B, H))
    assert S_f.dtype == n_f.dtype == m_f.dtype == torch.float32
    jh, jst = jax_xlstm.mlstm_chunked(*j, chunk)
    check(h, jh, TOL[dtype])
    for got, want in zip((S_f, n_f, m_f), jst):
        check(got, want, TOL[dtype])
    check(h, jax_mlstm_ref(*j), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_ref_matches_jax(dtype):
    """The port's sequential oracle: h against JAX mlstm_ref, and its final
    state (which the JAX oracle does not return) against JAX mlstm_chunked's."""
    j, t = both(inputs(1, 2, 32, 2, 8), dtype)
    h, st = ref.mlstm_ref(*t)
    check(h, jax_mlstm_ref(*j), TOL[dtype])
    _, jst = jax_xlstm.mlstm_chunked(*j, 8)
    for got, want in zip(st, jst):
        check(got, want, TOL[dtype])


@pytest.mark.parametrize("B,S,H,D,chunk", [(1, 64, 2, 16, 16), (2, 64, 2, 8, 16)])
def test_ops_mlstm_scan_matches_pallas_interpret(B, S, H, D, chunk):
    """ops.mlstm_scan on CPU tensors against the Pallas kernel run in
    interpret mode; the CPU path never reaches the CUDA kernel."""
    j, t = both(inputs(2, B, S, H, D), "float32")
    before = mlstm_kernel.launches
    h, _ = ops.mlstm_scan(*t, chunk=chunk)
    assert mlstm_kernel.launches == before
    check(h, jax_mlstm_scan(*j, chunk=chunk), TOL["float32"])


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_extreme_gates_stay_finite(seed):
    """Gate preactivations of +-20 (tests/test_kernels.py::
    test_mlstm_extreme_gates_stable): finite h and state, within 5e-4 of the
    sequential oracle."""
    j, t = both(inputs(seed, 1, 32, 1, 8, gate_scale=20.0), "float32")
    h, st = ops.mlstm_scan(*t, chunk=8)
    assert all(bool(torch.isfinite(a).all()) for a in (h, *st))
    check(h, jax_mlstm_ref(*j), EXTREME_TOL)


@pytest.mark.parametrize("S,chunk", [(100, 32), (5, 8), (3, 8), (37, 16), (16, 128)])
def test_ragged_length_matches_jax_mlstm_ref(S, chunk):
    """S not a multiple of the chunk (the JAX function asserts): the port
    pads with log-forget 0 and input gate -inf, which is exact; h equals the
    sequential recurrence, and so does the final state."""
    j, t = both(inputs(3, 2, S, 2, 16), "float32")
    h, st = ops.mlstm_scan(*t, chunk=chunk)
    assert h.shape == (2, S, 2, 16)
    check(h, jax_mlstm_ref(*j), TOL["float32"])
    _, want = ref.mlstm_ref(*t)
    for got, w in zip(st, want):
        check(got, w, TOL["float32"])


def split_bf16(x, lo=True):
    """x as the kernel feeds it to a bf16 product: hi = bf16(x) and, with
    ``lo``, plus lo = bf16(x - hi) (two mma into one accumulator)."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float() if lo else hi


def emulate_kernel(q, k, v, i_gate, f_gate, chunk, split_w=True):
    """The bf16 CUDA kernels' arithmetic in plain PyTorch: fp32 everywhere
    (q k^T, q S and the state update accumulate in fp32 from the bf16
    inputs; 1/sqrt(D) on the fp32 products; den, the row sums of W and n
    from fp32 values), except the three operands rounded for the tensor
    cores, each split into bf16 hi + lo: W, the copy of S that feeds q S,
    and cw (.) k.  ``split_w=False`` rounds W once.  h is rounded to bf16
    as the kernel stores it; the state stays fp32."""
    B, S, H, D = q.shape
    Q = chunk
    pad = (-S) % Q
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))   # (B,H,S,D)
    ig, lf = i_gate.float().permute(0, 2, 1), torch.nn.functional.logsigmoid(
        f_gate.float()).permute(0, 2, 1)
    if pad:
        qf, kf, vf = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (qf, kf, vf))
        ig = torch.nn.functional.pad(ig, (0, pad), value=float("-inf"))
        lf = torch.nn.functional.pad(lf, (0, pad))
    St = torch.zeros(B, H, D, D)
    n = torch.zeros(B, H, D)
    m = torch.full((B, H), float("-inf"))
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    hs = []
    for c in range(0, S + pad, Q):
        qc, kc, vc = qf[:, :, c:c + Q], kf[:, :, c:c + Q], vf[:, :, c:c + Q]
        b = torch.cumsum(lf[:, :, c:c + Q], -1)
        total = b[..., -1]
        igc = ig[:, :, c:c + Q]
        logw = (b[..., :, None] - b[..., None, :] + igc[..., None, :]).masked_fill(
            ~mask, float("-inf"))
        mi = torch.maximum(m[..., None] + b, logw.amax(-1))
        first = torch.isinf(m)[..., None]
        e = torch.where(first, torch.zeros(()), torch.exp(m[..., None] + b - mi))
        W = (qc @ kc.transpose(-1, -2)) / math.sqrt(D) * torch.exp(logw - mi[..., None])
        qS = (qc @ split_bf16(St)) / math.sqrt(D)
        qn = (qc @ n[..., None])[..., 0] / math.sqrt(D)
        den = torch.maximum((e * qn + W.sum(-1)).abs(), torch.exp(-mi))
        hs.append((e[..., None] * qS + split_bf16(W, split_w) @ vc) / den[..., None])
        w = total[..., None] - b + igc
        m_new = torch.maximum(m + total, w.amax(-1))
        scale = torch.where(torch.isinf(m), torch.zeros(()), torch.exp(m + total - m_new))
        cwk = torch.exp(w - m_new[..., None])[..., None] * kc
        St = scale[..., None, None] * St + split_bf16(cwk).transpose(-1, -2) @ vc
        n = scale[..., None] * n + cwk.sum(-2)
        m = m_new
    h = torch.cat(hs, 2)[:, :, :S].permute(0, 2, 1, 3).to(q.dtype)
    return h, (St, n, m)


def tol_ratio(got, want, tol):
    """Largest |got - want| / (atol + rtol |want|): above 1 fails allclose."""
    got, want = f32(got), f32(want)
    return float((np.abs(got - want) / (tol["atol"] + tol["rtol"] * np.abs(want))).max())


@pytest.mark.parametrize("gate_scale,S,chunk", [(None, 512, 128), (20.0, 256, 128)])
def test_kernel_rounding_plan_holds_bf16_tolerance(gate_scale, S, chunk):
    """The bf16 kernels' roundings (W, the S copy and cw (.) k each split
    into bf16 hi + lo) keep h and the final S, n, m within the bf16
    tolerance of mlstm_chunked: at the serve path's head dim and chunk
    with model-like gates (i ~ N(0,1), f ~ N(1,1)), and with gates of
    +-20."""
    B, H, D = (2, 2, 384) if gate_scale is None else (1, 1, 384)
    _, t = both(inputs(11, B, S, H, D, gate_scale), "bfloat16")
    h, st = emulate_kernel(*t, chunk)
    want_h, want_st = ref.mlstm_chunked(*t, chunk)
    for got, want in zip((h, *st), (want_h, *want_st)):
        assert tol_ratio(got, want, TOL["bfloat16"]) <= 1.0


def test_single_rounding_of_w_misses_bf16_tolerance():
    """Why W is split: rounded to bf16 once, the emulated kernel puts h past
    the bf16 tolerance at the serve path's head dim and chunk."""
    _, t = both(inputs(11, 2, 512, 2, 384), "bfloat16")
    h, _ = emulate_kernel(*t, 128, split_w=False)
    want_h, _ = ref.mlstm_chunked(*t, 128)
    assert tol_ratio(h, want_h, TOL["bfloat16"]) > 1.0


# The bf16 backward kernels' rounding plan (csrc/mlstm_bwd.cu).  Every
# product takes bf16 operands into fp32 accumulators; q, k, v and dh are
# bf16 already; of the computed operands, these are split into hi + lo
# (two products into one accumulator), each because rounding it once put
# a gradient past the bf16 tolerance (see the test below):
BWD_SPLITS = (
    "S_p",   # the state before the chunk, in q S_p (h) and dh S_p^T (dq)
    "P",     # P = q k^T / sqrt(D) (.) A, in P v (h)
    "q_dS",  # s / g / sqrt(D) (.) q, in the dS update
    "dS",    # the state's cotangent, in v dS^T (dk) and k dS (dv)
)


def emulate_bwd(q, k, v, i_gate, f_gate, dh, chunk, splits=BWD_SPLITS):
    """The bf16 backward kernels' arithmetic in plain PyTorch on the CPU:
    gate math in fp64 with each exponent rounded once (m' rounded to fp32
    first); products accumulated in fp32 from operands rounded to bf16
    where the kernels feed an mma (``split_bf16``: hi + lo for the names in
    ``splits``, hi alone otherwise: cw (.) k in the states, A (.) dP /
    sqrt(D) and P / g); h in fp32; the sums that cancel (G's row and column
    sums, dw, dtot, the reverse cumsum of db) in fp64.  Returns dq, dk, dv,
    d i_gate, d f_gate in q's dtype."""
    B, S, H, D = q.shape
    Q = chunk
    pad = (-S) % Q
    isd = 1.0 / math.sqrt(D)
    F = torch.nn.functional

    def rnd(x, name):
        return split_bf16(x, name in splits)

    qf, kf, vf, dhf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, dh))   # (B,H,S,D)
    ig = i_gate.double().permute(0, 2, 1)
    lf = F.logsigmoid(f_gate.float()).double().permute(0, 2, 1)
    fgf = f_gate.float().permute(0, 2, 1)
    if pad:
        qf, kf, vf, dhf = (F.pad(t, (0, 0, 0, pad)) for t in (qf, kf, vf, dhf))
        ig = F.pad(ig, (0, pad), value=float("-inf"))
        lf, fgf = F.pad(lf, (0, pad)), F.pad(fgf, (0, pad))
    nc = (S + pad) // Q
    valid = (torch.arange(S + pad) < S).float().reshape(nc, Q)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    rows = [slice(c * Q, (c + 1) * Q) for c in range(nc)]

    # Launch 1: the gate math and the states before each chunk.
    gates, Sp, npv = [], [], []
    m = torch.full((B, H), float("-inf"), dtype=torch.float64)
    St, n = torch.zeros(B, H, D, D), torch.zeros(B, H, D)
    for c, sl in enumerate(rows):
        b = torch.cumsum(lf[..., sl], -1)
        igc, tot = ig[..., sl], b[..., -1]
        logw = (b[..., :, None] - b[..., None, :] + igc[..., None, :]).masked_fill(
            ~mask, float("-inf"))
        mi = torch.maximum(m[..., None] + b, logw.amax(-1))
        first = torch.isinf(m)
        s = torch.where(first[..., None], 0.0, torch.exp((m[..., None] + b - mi).float()))
        w = tot[..., None] - b + igc
        m_new = torch.maximum(m + tot, w.amax(-1)).float().double()
        so = torch.where(first, 0.0, torch.exp((m + tot - m_new).float()))
        cw = torch.exp((w - m_new[..., None]).float())
        A = torch.exp((logw - mi[..., None]).float())
        gates.append(dict(s=s, so=so, cw=cw, A=A, floor=torch.exp((-mi).float())))
        Sp.append(St)
        npv.append(n)
        kc, vc = kf[:, :, sl], vf[:, :, sl]
        St = so[..., None, None] * St + rnd(cw[..., None] * kc, "cw_k").transpose(-1, -2) @ vc
        n = so[..., None] * n + (cw[..., None] * kc).sum(-2)
        m = m_new

    # Launch 2: per chunk, P, den, h in fp32, dden, G's sums, A (.) dP, P / g.
    recs = []
    for c, sl in enumerate(rows):
        gt = gates[c]
        qc, kc, vc, dhc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], dhf[:, :, sl]
        P = (qc @ kc.transpose(-1, -2)) * isd * gt["A"]
        qn = (qc @ npv[c][..., None])[..., 0] * isd
        den = gt["s"] * qn + P.double().sum(-1).float()
        ginv = valid[c] / torch.maximum(den.abs(), gt["floor"])
        Pr = rnd(P, "P")   # kept in shared memory as hi + lo; G and P / g read it back
        hint = qc @ rnd(Sp[c], "S_p")
        x = (dhc * hint).sum(-1)
        h = (hint * (gt["s"] * isd)[..., None] + Pr @ vc) * ginv[..., None]
        dd = (dhc * h).sum(-1)
        dden = torch.where((den.abs() > gt["floor"]) & (valid[c] > 0),
                           -torch.sign(den) * dd * ginv, 0.0)
        dP = (dhc @ vc.transpose(-1, -2) * ginv[..., None] + dden[..., None]) * mask
        G = (Pr * dP).double()
        binter = (gt["s"] * (ginv * isd * x + qn * dden)).double()
        recs.append(dict(ginv=ginv, dden=dden, dig=G.sum(-2),
                         db=G.sum(-1) - G.sum(-2) + binter,
                         AdP=rnd(gt["A"] * dP * isd, "AdP"), Pg=rnd(Pr * ginv[..., None], "Pg")))

    # Launch 3: dS and dn after each chunk, going backward; <dS, S_p> + <dn, n_p>.
    dS, dn = torch.zeros(B, H, D, D), torch.zeros(B, H, D)
    dSs, dns, tdot = [None] * nc, [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        gt, r, qc = gates[c], recs[c], qf[:, :, rows[c]]
        dSs[c], dns[c] = dS, dn
        tdot[c] = ((dS.double() * Sp[c].double()).sum((-1, -2))
                   + (dn.double() * npv[c].double()).sum(-1))
        wq = (gt["s"] * r["ginv"] * isd)[..., None] * qc
        dS = gt["so"][..., None, None] * dS + rnd(wq, "q_dS").transpose(-1, -2) @ dhf[:, :, rows[c]]
        dn = gt["so"][..., None] * dn + ((gt["s"] * r["dden"] * isd)[..., None] * qc).sum(-2)

    # Launches 4 and 5: dq, dk, dv per chunk; the gates' gradients.
    outs = [[], [], [], [], []]
    for c, sl in enumerate(rows):
        gt, r = gates[c], recs[c]
        qc, kc, vc, dhc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], dhf[:, :, sl]
        s, cw = gt["s"], gt["cw"]
        dSr = rnd(dSs[c], "dS")
        dq = ((dhc @ rnd(Sp[c], "S_p").transpose(-1, -2)) * (s * r["ginv"] * isd)[..., None]
              + (s * r["dden"] * isd)[..., None] * npv[c][..., None, :] + r["AdP"] @ kc)
        dk_in = vc @ dSr.transpose(-1, -2) + dns[c][..., None, :]
        dk = dk_in * cw[..., None] + r["AdP"].transpose(-1, -2) @ qc
        dv = (kc @ dSr) * cw[..., None] + r["Pg"].transpose(-1, -2) @ dhc
        dw = cw.double() * (kc * dk_in).double().sum(-1) * valid[c].double()
        db = r["db"] - dw
        db[..., int(valid[c].sum()) - 1] += dw.sum(-1) + gt["so"].double() * tdot[c]
        dlogf = torch.flip(torch.cumsum(torch.flip(db, [-1]), -1), [-1])
        for lst, val in zip(outs, (dq, dk, dv, r["dig"] + dw,
                                   dlogf.float() * torch.sigmoid(-fgf[..., sl]))):
            lst.append(val)
    grads = [torch.cat(o, 2)[:, :, :S].permute(0, 2, 1, 3) for o in outs[:3]]
    grads += [torch.cat(o, -1)[..., :S].permute(0, 2, 1).float() for o in outs[3:]]
    return tuple(g.to(q.dtype) for g in grads)


def test_kernel_wrapper_refuses_cpu_tensors():
    _, t = both(inputs(5, 1, 16, 2, 8), "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        mlstm_kernel.mlstm_scan_cuda(*t, chunk=8)


@pytest.mark.parametrize("fresh", [True, False])
def test_mlstm_decode_step_matches_jax(fresh):
    """From the cache's initial state (m = -inf) and from a random one."""
    rng = np.random.default_rng(6)
    B, H, D = 2, 3, 8
    if fresh:
        state = (np.zeros((B, H, D, D), np.float32), np.zeros((B, H, D), np.float32),
                 np.full((B, H), -np.inf, np.float32))
    else:
        state = (rng.standard_normal((B, H, D, D), dtype=np.float32),
                 rng.standard_normal((B, H, D), dtype=np.float32),
                 rng.standard_normal((B, H), dtype=np.float32))
    q, k, v = (rng.standard_normal((B, H, D), dtype=np.float32) for _ in range(3))
    ig, fg = (rng.standard_normal((B, H), dtype=np.float32) for _ in range(2))
    h, st = xlstm.mlstm_decode_step(tuple(torch.from_numpy(a) for a in state),
                                    *(torch.from_numpy(a) for a in (q, k, v, ig, fg)))
    jh, jst = jax_xlstm.mlstm_decode_step(tuple(jnp.asarray(a) for a in state),
                                          *(jnp.asarray(a) for a in (q, k, v, ig, fg)))
    check(h, jh, TOL["float32"])
    for got, want in zip(st, jst):
        check(got, want, TOL["float32"])


def block_params(kind, seed):
    """One mLSTM or sLSTM block's params for the xlstm smoke config, as
    numpy, drawn at the JAX init's scales."""
    cfg = jax_smoke_config("xlstm_125m")
    d, H = cfg.d_model, cfg.n_heads
    rng = np.random.default_rng(seed)
    if kind == "mlstm":
        dp = int(cfg.xlstm_proj_factor * d)
        shapes = {"up": (d, 2 * dp), "wq": (dp, dp), "wk": (dp, dp), "wv": (dp, dp),
                  "w_if": (dp, 2 * H), "out_scale": (dp,), "down": (dp, d)}
    else:
        dh, ff = d // H, max(int(4 * d / 3), 1)
        shapes = {"w_in": (d, 4 * d), "r": (4, H, dh, dh), "bias": (4 * d,),
                  "ff_gate": (d, ff), "ff_up": (d, ff), "ff_down": (ff, d)}
    scale = {"r": 1 / np.sqrt(d // H), "bias": 0.1, "out_scale": 1.0}
    return {f"x/{k}": (rng.standard_normal(s) * scale.get(k, 1 / np.sqrt(s[0]))
                       ).astype(np.float32) for k, s in shapes.items()}


def zero_state(kind, cfg, B):
    if kind == "mlstm":
        sh = jax_xlstm.mlstm_state_shapes(cfg, B)
        return (np.zeros(sh["S"], np.float32), np.zeros(sh["n"], np.float32),
                np.full(sh["m"], -np.inf, np.float32))
    return tuple(np.zeros(s, np.float32) for s in jax_xlstm.slstm_state_shapes(cfg, B))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [8, 13, 3])
def test_block_matches_jax(kind, S):
    """A prompt pass (S a multiple of the smoke chunk 8, ragged, shorter
    than a chunk) against JAX's block fed token by token from a zero state;
    the state the prompt pass collects; and the port's own decode steps."""
    cfg32 = dict(dtype="float32", logit_dtype="float32")
    jcfg = jax_smoke_config("xlstm_125m").replace(**cfg32)
    tcfg = smoke_config("xlstm_125m").replace(**cfg32)
    jblock = getattr(jax_xlstm, f"{kind}_block")
    tblock = getattr(xlstm, f"{kind}_block")
    params = block_params(kind, 8)
    x = np.random.default_rng(9).standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}

    st = tuple(jnp.asarray(a) for a in zero_state(kind, jcfg, 2))
    steps = []
    for t in range(S):
        o, st = jblock(jp, "x", jcfg, jnp.asarray(x[:, t:t + 1]), state=st)
        steps.append(np.asarray(o))
    ref_steps = np.concatenate(steps, axis=1)
    with torch.no_grad():
        out, got = tblock(tp, "x", tcfg, torch.from_numpy(x), collect_state=True)
        if kind == "slstm" or S % jcfg.xlstm_chunk == 0:   # JAX's mlstm forward asserts
            jout, _ = jblock(jp, "x", jcfg, jnp.asarray(x))
            check(out, jout, MODEL_TOL)
        check(out, ref_steps, MODEL_TOL)
        for a, b in zip(got, st):
            check(a, b, MODEL_TOL)

        state = tuple(torch.from_numpy(a) for a in zero_state(kind, tcfg, 2))
        for t in range(S):
            o, state = tblock(tp, "x", tcfg, torch.from_numpy(x[:, t:t + 1]), state=state)
            check(o, ref_steps[:, t:t + 1], MODEL_TOL)
    for a, b in zip(state, st):
        check(a, b, MODEL_TOL)


def test_block_without_state_collects_none():
    """Without a state or collect_state a prompt pass returns no state, as
    the JAX blocks do."""
    cfg = smoke_config("xlstm_125m").replace(dtype="float32")
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((1, 8, cfg.d_model),
                                                                  dtype=np.float32))
    for kind in ("mlstm", "slstm"):
        tp = {k: torch.from_numpy(v) for k, v in block_params(kind, 11).items()}
        with torch.no_grad():
            _, st = getattr(xlstm, f"{kind}_block")(tp, "x", cfg, x)
        assert st is None


def test_state_shapes_match_jax():
    jcfg = jax_smoke_config("xlstm_125m")
    tcfg = smoke_config("xlstm_125m")
    assert xlstm.mlstm_state_shapes(tcfg, 3) == jax_xlstm.mlstm_state_shapes(jcfg, 3)
    assert xlstm.slstm_state_shapes(tcfg, 3) == jax_xlstm.slstm_state_shapes(jcfg, 3)


# ------------------------------------------------------------- gradients --
#
# Autograd of the port's plain version, which the backward kernel is held
# against on the card, against jax.vjp of the JAX functions.  The port's
# plain version sends no gradient through the stabilisers' max, where
# jax.grad does; those contributions cancel only up to rounding (h does not
# depend on m), ~3e-5 relative at most in fp32.  fp32: every gradient within
# rtol/atol 1e-4 and a relative rms of 1e-4; bf16: a relative rms of 2e-2.

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


def port_grads(t, chunk, dh):
    """Autograd of h = ops.mlstm_scan(...)[0] (the plain version on CPU
    tensors) at ``t``."""
    ins = [a.clone().requires_grad_() for a in t]
    h, _ = ops.mlstm_scan(*ins, chunk=chunk)
    return torch.autograd.grad(h, ins, torch.from_numpy(dh).to(h.dtype))


def cotangent(seed, B, S, H, D):
    return np.random.default_rng(seed).standard_normal((B, S, H, D), dtype=np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,D,chunk", CASES)
def test_mlstm_chunked_grads_match_jax(B, S, H, D, chunk, dtype):
    """dq, dk, dv, d i_gate, d f_gate of h against jax.vjp of JAX
    mlstm_chunked."""
    j, t = both(inputs(20, B, S, H, D), dtype)
    dh = cotangent(21, B, S, H, D)
    _, vjp = jax.vjp(lambda *a: jax_xlstm.mlstm_chunked(*a, chunk)[0], *j)
    want = vjp(jnp.asarray(dh).astype(dtype))
    got = port_grads(t, chunk, dh)
    for g, a in zip(got, t):
        assert g.dtype == a.dtype and g.shape == a.shape
    assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("S,chunk", [(100, 32), (5, 8), (37, 16)])
def test_ragged_grads_match_jax_mlstm_ref(S, chunk):
    """S not a multiple of the chunk: the padded tail (input gate -inf,
    log-forget 0) takes no gradient and makes no NaN; the gradients equal
    jax.vjp of the sequential mlstm_ref."""
    j, t = both(inputs(22, 2, S, 2, 16), "float32")
    dh = cotangent(23, 2, S, 2, 16)
    _, vjp = jax.vjp(jax_mlstm_ref, *j)
    assert_grads_close(port_grads(t, chunk, dh), vjp(jnp.asarray(dh)), "float32")


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_extreme_gate_grads_stay_finite(seed):
    """Gate preactivations of +-20 (stabilisers far from 0, the e^{-m}
    floor of the normaliser winning on some rows): finite gradients, equal
    to jax.vjp of the sequential oracle within the extreme-gate tolerance of
    tests/test_kernels.py, and no farther from it in relative rms than
    jax.vjp of JAX's own mlstm_chunked is (nor than 1e-4).  At seed 0 the
    two JAX gradients are 1.4e-3 apart in dq: the chunked and sequential
    forms round differently where these gates make dq span 13 decades."""
    j, t = both(inputs(seed, 1, 32, 1, 8, gate_scale=20.0), "float32")
    dh = jnp.asarray(cotangent(seed + 1, 1, 32, 1, 8))
    want = jax.vjp(jax_mlstm_ref, *j)[1](dh)
    jax_chunked = jax.vjp(lambda *a: jax_xlstm.mlstm_chunked(*a, 8)[0], *j)[1](dh)
    for g, w, c in zip(port_grads(t, 8, np.array(dh)), want, jax_chunked):
        g, w = f32(g), f32(w)
        assert np.isfinite(g).all()
        assert rel_rms(g, w) <= max(GRAD_REL_RMS["float32"], rel_rms(f32(c), w))
        np.testing.assert_allclose(g, w, **EXTREME_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_grads_match_jax(kind):
    """The whole mLSTM block (up-projection, q/k/v, gates, the scan, output
    gate, down-projection) and the sLSTM block (its recurrence and FFN) at S
    a multiple of the smoke chunk: the gradients of every param and of x
    against jax.vjp of JAX's block, at the model tolerance and a relative
    rms of 1e-4."""
    cfg32 = dict(dtype="float32", logit_dtype="float32")
    jcfg = jax_smoke_config("xlstm_125m").replace(**cfg32)
    tcfg = smoke_config("xlstm_125m").replace(**cfg32)
    jblock = getattr(jax_xlstm, f"{kind}_block")
    tblock = getattr(xlstm, f"{kind}_block")
    params = block_params(kind, 24)
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, 2 * jcfg.xlstm_chunk, jcfg.d_model), dtype=np.float32)
    dout = rng.standard_normal(x.shape, dtype=np.float32)
    _, vjp = jax.vjp(lambda p, a: jblock(p, "x", jcfg, a)[0],
                     {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(dout))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = tblock(tp, "x", tcfg, tx)
    got = torch.autograd.grad(out, [*tp.values(), tx], torch.from_numpy(dout))
    assert_grads_close(got, [want_p[k] for k in tp] + [want_x], "float32", MODEL_TOL)


def test_mlstm_function_wires_forward_and_backward(monkeypatch):
    """MlstmScanFunction saves q, k, v and the gates and hands them, with
    h's cotangent and the chunk, to the backward kernel; its grads go back
    to the five inputs in order, and chunk takes none.  The final (S, n, m)
    carries no grad_fn and takes no gradient.  The two CUDA wrappers are
    replaced by plain versions here (the kernels run on the card only)."""
    seen = []

    def fwd(q, k, v, i_gate, f_gate, *, chunk):
        assert not torch.is_grad_enabled()
        return ref.mlstm_chunked(q, k, v, i_gate, f_gate, chunk)

    def bwd(q, k, v, i_gate, f_gate, dh, *, chunk):
        seen.append(dict(inputs=(q, k, v, i_gate, f_gate), dh=dh, chunk=chunk))
        t = [a.detach().requires_grad_() for a in (q, k, v, i_gate, f_gate)]
        with torch.enable_grad():
            return torch.autograd.grad(ref.mlstm_chunked(*t, chunk)[0], t, dh)

    monkeypatch.setattr(mlstm_kernel, "mlstm_scan_cuda", fwd)
    monkeypatch.setattr(mlstm_kernel, "mlstm_scan_bwd_cuda", bwd)
    _, t = both(inputs(26, 2, 24, 2, 8), "float32")
    t = [a.requires_grad_() for a in t]
    h, S_f, n_f, m_f = mlstm_kernel.MlstmScanFunction.apply(*t, 8)
    assert h.grad_fn is not None
    for a in (S_f, n_f, m_f):
        assert a.grad_fn is None and not a.requires_grad
    want_st = ref.mlstm_chunked(*[a.detach() for a in t], 8)[1]
    for a, b in zip((S_f, n_f, m_f), want_st):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dh = torch.from_numpy(cotangent(27, 2, 24, 2, 8))
    got = torch.autograd.grad(h, t, dh)
    (call,) = seen
    assert call["chunk"] == 8
    assert all(a is b for a, b in zip(call["inputs"], t))
    torch.testing.assert_close(call["dh"], dh, rtol=0, atol=0)
    want = port_grads([a.detach() for a in t], 8, dh.numpy())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ops_routes_to_the_function_only_off_the_cpu_under_grad(monkeypatch):
    """ops.mlstm_scan: CPU tensors take the plain version whatever the grad
    mode; any other device takes the Function when grad mode is on and an
    input requires grad (returning h and the final state as (S, n, m)), and
    the forward kernels directly otherwise.  Meta tensors stand in for CUDA
    ones here."""
    calls = []
    monkeypatch.setattr(ops, "mlstm_scan_cuda", lambda *a, chunk: calls.append("kernel"))

    class Recorder:
        @staticmethod
        def apply(*a):
            calls.append("function")
            return "h", "S", "n", "m"

    monkeypatch.setattr(ops, "MlstmScanFunction", Recorder)
    _, t = both(inputs(28, 1, 16, 2, 8), "float32")
    h, _ = ops.mlstm_scan(*[a.clone().requires_grad_(i == 3) for i, a in enumerate(t)], chunk=8)
    assert h.grad_fn is not None and calls == []
    meta = [a.to("meta") for a in t]
    for i in range(5):
        out = ops.mlstm_scan(*[a.clone().requires_grad_(j == i) for j, a in enumerate(meta)],
                             chunk=8)
        assert out == ("h", ("S", "n", "m"))
    assert calls == ["function"] * 5
    calls.clear()
    ops.mlstm_scan(*meta, chunk=8)
    with torch.no_grad():
        ops.mlstm_scan(*[a.clone().requires_grad_() for a in meta], chunk=8)
    assert calls == ["kernel", "kernel"]


# The bf16 backward's rounding plan, emulated on the CPU (emulate_bwd), against
# autograd of the fp32 plain version and jax.vjp: within the bf16 gradient
# tolerance with BWD_SPLITS split, and past it with any one of them rounded
# once.


def bf16_case(seed, B, S, H, D, gate_scale=None):
    _, t = both(inputs(seed, B, S, H, D, gate_scale), "bfloat16")
    return t, torch.from_numpy(cotangent(seed + 1, B, S, H, D)).to(torch.bfloat16)


def fp32_plain_grads(t, dh, chunk):
    return port_grads([a.float() for a in t], chunk, f32(dh))


@pytest.mark.parametrize("B,S,H,D,chunk,gate_scale", [(1, 256, 1, 384, 128, None),
                                                      (1, 128, 1, 64, 32, 20.0)])
def test_bwd_rounding_plan_holds_bf16_tolerance(B, S, H, D, chunk, gate_scale):
    """At xlstm_125m's head dim and chunk with model-like gates, and with
    gates of +-20: every gradient of the emulated bf16 kernels within a
    relative rms of 2e-2 of autograd of the fp32 plain version."""
    t, dh = bf16_case(30, B, S, H, D, gate_scale)
    got = emulate_bwd(*t, dh, chunk)
    for g, w, a in zip(got, fp32_plain_grads(t, dh, chunk), t):
        assert g.dtype == a.dtype and g.shape == a.shape
        assert rel_rms(f32(g), f32(w)) <= GRAD_REL_RMS["bfloat16"]


def test_bwd_rounding_plan_matches_jax_vjp():
    """The emulated bf16 kernels against jax.vjp of JAX's mlstm_chunked in
    fp32 on the same bf16 values, at a chunk of 24 (the kernels pad it to
    32 rows)."""
    t, dh = bf16_case(31, 2, 96, 2, 16)
    _, vjp = jax.vjp(lambda *a: jax_xlstm.mlstm_chunked(*a, 24)[0],
                     *(jnp.asarray(f32(a)) for a in t))
    want = vjp(jnp.asarray(f32(dh)))
    for g, w in zip(emulate_bwd(*t, dh, 24), want):
        assert rel_rms(f32(g), np.asarray(w)) <= GRAD_REL_RMS["bfloat16"]


@pytest.mark.parametrize("once", BWD_SPLITS)
def test_bwd_single_rounding_misses_bf16_tolerance(once):
    """Why each operand of BWD_SPLITS is split: with gates of +-20 (1,32,1,8)
    chunk 8, the plan holds every gradient within 2e-2 of the fp32 plain
    version, and rounding that one operand to bf16 once puts one past it."""
    t, dh = bf16_case(0, 1, 32, 1, 8, 20.0)
    want = fp32_plain_grads(t, dh, 8)

    def worst(splits):
        return max(rel_rms(f32(g), f32(w)) for g, w in zip(emulate_bwd(*t, dh, 8, splits), want))

    assert worst(BWD_SPLITS) <= GRAD_REL_RMS["bfloat16"]
    assert worst(tuple(s for s in BWD_SPLITS if s != once)) > GRAD_REL_RMS["bfloat16"]
