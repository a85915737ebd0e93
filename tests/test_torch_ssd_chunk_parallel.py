"""The decomposition the bf16 SSD kernels (``ssd_fwd_wgmma``,
``ssd_bwd_wgmma``) implement, emulated in plain PyTorch and held against
the JAX package on the CPU.

The kernels split a (b, head) scan's nc chunks over the blocks of a
thread-block cluster (at most 8, each taking ceil(nc / 8) consecutive
chunks) and give a block a group of G heads.  The emulation below, kept
here and not in the package, follows them step by step in fp64:

- per chunk, the local state L_c = sum_j e^(tot - cum_j) dt_j B_j x_j^T
  and decay e^tot, summed over a block's chunks from zero (pass A);
- the state passed from block to block in chunk order, S_out = e^(sum of
  tot) S_in + L, the last block's S_out the final state;
- y of each chunk from the state before it, C B^T formed once per (b,
  chunk) for all heads and each head's decay applied to it (pass B), the
  decay e^(cum_i - cum_j) formed as the forward kernel forms it: directly
  on a 16-row band's diagonal block, off it as a row factor times a
  column factor split at the end of j's band;
- in the backward, the local dS_c term sum_i e^cum_i C_i dy_i^T summed
  backward over a block's chunks and passed from block to block against
  chunk order from the final state's cotangent; the states before the
  chunks inside a block from S_in and the block's local states before
  them (the scratch the kernel keeps where a block takes several chunks);
- dB and dC summed over a group's heads, then over the groups; dA over
  the (b, block) partials.

It is held on the same numpy inputs against ``repro.models.ssm.
ssd_chunked``, ``repro.kernels.ref.ssd_ref`` where S is ragged, and
``jax.vjp`` of them, in fp32 at 1e-4 (the JAX package's fp32 kernel
tolerance), at nc 1, 4, 9 and 35, ragged S, and H 3 and 5 under groups of
2 and 4.  The group-size rule (``ssd.group_size``, the kernels' rule
mirrored in Python) is held to its choices at zamba2's shapes on an H100.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    dy = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dfinal = rng.standard_normal((B, H, N, P), dtype=np.float32)
    return (x, dt, A, Bm, Cm), dy, dfinal


def chunks(a, Q, nc):
    """(B, S, ...) -> (B, nc, Q, ...) in fp64, zero-padded past S."""
    t = torch.from_numpy(np.asarray(a)).double()
    pad = nc * Q - t.shape[1]
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], 1)
    return t.reshape(t.shape[0], nc, Q, *t.shape[2:])


def band_decay(cum):
    """e^(cum_i - cum_j) where j <= i, else 0, for cum (B, nc, Q, H) as
    (B, nc, i, j, H), as the forward kernel forms it: on 16-row bands'
    diagonal blocks directly; where j's band is before i's, as e^(cum_i -
    cum_e) e^(cum_e - cum_j) with e the last row of j's band, both
    exponents <= 0.  Rows past the chunk keep its last cum, as in the
    kernel's 128-row tiles."""
    Q = cum.shape[2]
    idx = torch.arange(Q)
    band = idx // 16
    ce = cum[:, :, torch.clamp(16 * band + 15, max=Q - 1)]   # (B, nc, j, H)
    fac = torch.exp(cum[:, :, :, None, :] - ce[:, :, None, :, :]) * \
        torch.exp(ce - cum)[:, :, None, :, :]
    direct = torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :]).clamp(max=0))
    same = (band[:, None] == band[None, :])[None, None, :, :, None]
    below = (band[:, None] > band[None, :])[None, None, :, :, None]
    tri = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    return torch.where(same & tri, direct, torch.where(below, fac, 0.0))


def emulate(arrays, dy, dfinal, Q, G):
    """y, the final state and (dx, ddt, dA, dB, dC) by the kernels'
    decomposition, in fp64."""
    x, dt, A, Bm, Cm = arrays
    Bsz, S, H, P = x.shape
    nc = -(-S // Q)
    k, cs = ssd.chunk_plan(nc)
    xc, dtc, bc, cc, dyc = (chunks(a, Q, nc) for a in (x, dt, Bm, Cm, dy))
    Ah = torch.from_numpy(A).double()
    cum = torch.cumsum(dtc * Ah, 2)                         # (B, nc, Q, H)
    tot = cum[:, :, -1]                                     # (B, nc, H)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B, nc, i, j, H)
    Lmat = torch.where(tri[None, None, :, :, None], torch.exp(seg.clamp(max=0)), 0.0)
    Lband = band_decay(cum)                                 # the forward's
    CB = torch.einsum("bcin,bcjn->bcij", cc, bc)            # once per (b, chunk)
    u = torch.exp(tot[:, :, None] - cum) * dtc              # (B, nc, Q, H)
    # Local terms of each chunk: L_c (n, p) and the backward's M_c.
    Lc = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, u, xc)
    Mc = torch.einsum("bcin,bcih,bcihp->bchnp", cc, torch.exp(cum), dyc)
    D = torch.exp(tot)                                      # (B, nc, H)
    rng = [(r * k, min(nc, r * k + k)) for r in range(cs)]

    # Pass A and the hand-offs.
    Lr, Mr, Dr, Lpre = [], [], [], {}
    for c0, c1 in rng:
        L = torch.zeros(Bsz, H, Bm.shape[-1], P, dtype=torch.float64)
        d = torch.ones(Bsz, H, dtype=torch.float64)
        for c in range(c0, c1):
            Lpre[c] = L
            L = D[:, c, :, None, None] * L + Lc[:, c]
            d = d * D[:, c]
        M = torch.zeros_like(L)
        for c in reversed(range(c0, c1)):
            M = D[:, c, :, None, None] * M + Mc[:, c]
        Lr.append(L)
        Mr.append(M)
        Dr.append(d)
    S_in = [torch.zeros_like(Lr[0])]
    for r in range(cs):
        S_in.append(Dr[r][:, :, None, None] * S_in[r] + Lr[r])
    final = S_in.pop()
    dS_in = [None] * cs
    dS_in[cs - 1] = torch.from_numpy(dfinal).double()
    for r in reversed(range(1, cs)):
        dS_in[r - 1] = Dr[r][:, :, None, None] * dS_in[r] + Mr[r]

    # Pass B: y, and the gradients chunk by chunk (backward inside a block).
    y = torch.zeros(Bsz, nc, Q, H, P, dtype=torch.float64)
    dx = torch.zeros_like(y)
    dBh = torch.zeros(Bsz, nc, Q, H, Bm.shape[-1], dtype=torch.float64)
    dCh = torch.zeros_like(dBh)
    ddt = torch.zeros(Bsz, nc, Q, H, dtype=torch.float64)
    dAp = torch.zeros(Bsz, cs, H, dtype=torch.float64)
    for r, (c0, c1) in enumerate(rng):
        dpre = torch.zeros(Bsz, H, dtype=torch.float64)
        prev = {}
        for c in range(c0, c1):       # the states before each chunk
            prev[c] = torch.exp(dpre)[:, :, None, None] * S_in[r] + Lpre[c]
            dpre = dpre + tot[:, c]
        dS = dS_in[r]
        for c in reversed(range(c0, c1)):
            Sp = prev[c]
            W = CB[:, c, :, :, None] * Lmat[:, c] * dtc[:, c, None, :, :]      # (b, i, j, h)
            Wy = CB[:, c, :, :, None] * Lband[:, c] * dtc[:, c, None, :, :]
            dyx = torch.einsum("bihp,bjhp->bijh", dyc[:, c], xc[:, c])
            V = CB[:, c, :, :, None] * Lmat[:, c] * dyx
            E = Lmat[:, c] * dtc[:, c, None, :, :] * dyx
            ec = torch.exp(cum[:, c])                                          # (b, i, h)
            y[:, c] = (torch.einsum("bijh,bjhp->bihp", Wy, xc[:, c])
                       + ec[..., None] * torch.einsum("bin,bhnp->bihp", cc[:, c], Sp))
            BdS = torch.einsum("bjn,bhnp->bjhp", bc[:, c], dS)
            dx[:, c] = torch.einsum("bijh,bihp->bjhp", W, dyc[:, c]) + u[:, c, ..., None] * BdS
            Sdy = torch.einsum("bhnp,bihp->bihn", Sp, dyc[:, c])
            dCh[:, c] = torch.einsum("bijh,bjn->bihn", E, bc[:, c]) + ec[..., None] * Sdy
            dBh[:, c] = (torch.einsum("bijh,bin->bjhn", E, cc[:, c])
                         + u[:, c, ..., None] * torch.einsum("bhnp,bjhp->bjhn", dS, xc[:, c]))
            du = (BdS * xc[:, c]).sum(-1)                                      # (b, j, h)
            cpart = ec * (cc[:, c, :, None, :] * Sdy).sum(-1)
            dcum = (cpart + (V * dtc[:, c, None, :, :]).sum(2) - dtc[:, c] * V.sum(1)
                    - u[:, c] * du)
            dtot = D[:, c] * (dS * Sp).sum((-1, -2)) + (u[:, c] * du).sum(1)
            dcum[:, -1] += dtot
            da = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
            ddt[:, c] = Ah * da + V.sum(1) + torch.exp(tot[:, c, None] - cum[:, c]) * du
            dAp[:, r] += (dtc[:, c] * da).sum(1)
            dS = D[:, c, :, None, None] * dS + Mc[:, c]

    def unchunk(t):
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :S]

    # dB, dC: per group of G heads, then the groups in order; dA over (b, block).
    groups = [range(h0, min(H, h0 + G)) for h0 in range(0, H, G)]
    dB = sum(sum(dBh[..., h, :] for h in grp) for grp in groups)
    dC = sum(sum(dCh[..., h, :] for h in grp) for grp in groups)
    grads = (unchunk(dx), unchunk(ddt), dAp.sum((0, 1)), unchunk(dB), unchunk(dC))
    return unchunk(y), final, grads


def jax_oracle(arrays, dy, dfinal, Q):
    j = [jnp.asarray(a) for a in arrays]
    fn = jax_ssd_ref if arrays[0].shape[1] % Q else (lambda *a: jax_ssm.ssd_chunked(*a, Q))
    out, vjp = jax.vjp(jax.jit(fn), *j)
    return out, vjp((jnp.asarray(dy), jnp.asarray(dfinal)))


# (B, S, H, P, N, chunk, G): nc 1, 4, 9 and 35; ragged S; H 3 and 5 under
# groups of 2 and 4.
CASES = [
    (2, 32, 3, 8, 4, 32, 2),     # nc 1
    (1, 64, 5, 8, 8, 16, 4),     # nc 4
    (2, 72, 3, 4, 8, 8, 2),      # nc 9: blocks of 2 chunks
    (1, 140, 5, 8, 4, 4, 2),     # nc 35: blocks of 5 chunks
    (1, 100, 3, 8, 8, 32, 4),    # ragged, nc 4
    (2, 70, 5, 4, 4, 8, 4),      # ragged, nc 9
]


@pytest.mark.parametrize("B,S,H,P,N,Q,G", CASES)
def test_chunk_parallel_forward_matches_jax(B, S, H, P, N, Q, G):
    arrays, dy, dfinal = inputs(S + H, B, S, H, P, N)
    y, final, _ = emulate(arrays, dy, dfinal, Q, G)
    (wy, wfinal), _ = jax_oracle(arrays, dy, dfinal, Q)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(wfinal), **TOL)


@pytest.mark.parametrize("B,S,H,P,N,Q,G", CASES)
def test_chunk_parallel_backward_matches_jax_vjp(B, S, H, P, N, Q, G):
    arrays, dy, dfinal = inputs(S + 7 * H, B, S, H, P, N)
    _, _, grads = emulate(arrays, dy, dfinal, Q, G)
    _, want = jax_oracle(arrays, dy, dfinal, Q)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("nc,k,cs", [(1, 1, 1), (4, 1, 4), (8, 1, 8), (9, 2, 5), (32, 4, 8),
                                     (35, 5, 7)])
def test_chunk_plan(nc, k, cs):
    """At most 8 blocks a cluster, each ceil(nc / 8) chunks, none empty."""
    assert ssd.chunk_plan(nc) == (k, cs)
    assert (cs - 1) * k < nc <= cs * k


# The blocks of these kernels an H100 80GB HBM3 runs at once, by the
# occupancy query the library makes: 30 clusters of 4, 15 of 8 (whole
# clusters: not 132).
SLOTS = {4: 120, 8: 120}


@pytest.mark.parametrize("B,S,H,backward,G,blocks", [
    (8, 512, 64, False, 4, 512),    # zamba2's serve and train forward: 5 waves of 2 pairs
    (8, 512, 64, True, 2, 1024),    # its backward: a head a warpgroup
    (4, 512, 32, False, 2, 256),    # a (2, 2) mesh rank's heads: 3 waves of 1 pair, not 2 of 2
    (4, 512, 32, True, 2, 256),
    (1, 4096, 64, False, 2, 256),   # the long serve mode, clusters of 8: likewise
])
def test_group_size_rule(B, S, H, backward, G, blocks):
    """The group rule at zamba2's shapes on an H100: the G it picks, the
    blocks it gives, and no G with a smaller modelled time (waves times a
    fixed 11/25 and a unit a pair of heads).  With G 2 the mesh rank's and
    the long mode's forwards ran 1.15x and 1.22x faster than with G 4."""
    _, cs = ssd.chunk_plan(-(-S // 128))
    slots = SLOTS[cs]
    got = ssd.group_size(B, S, H, 128, slots, backward=backward)
    assert got == G
    assert B * cs * -(-H // got) == blocks

    def cost(g):
        return -(-(B * cs * -(-H // g)) // slots) * (11 + 25 * -(-g // 2))
    assert all(cost(got) <= cost(g) for g in range(1, ssd.MAX_GROUP[backward] + 1))


@pytest.mark.parametrize("Q", [12, 64, 128])
def test_band_decay_is_the_masked_decay(Q):
    """The forward kernel's band-factored decay equals e^(cum_i - cum_j)
    masked to j <= i, and no entry exceeds 1 (at Q 128 the chunk's
    log-decay reaches ~-100)."""
    rng = np.random.default_rng(Q)
    dt = np.log1p(np.exp(rng.standard_normal((1, 2, Q, 3))))
    A = -np.exp(rng.standard_normal(3))
    cum = torch.cumsum(torch.from_numpy(dt * A), 2)
    got = band_decay(cum)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, None, :, :, None]
    want = torch.where(tri, torch.exp(seg.clamp(max=0)), 0.0)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    assert float(got.max()) <= 1.0
