"""The split decode of the port's flash attention, on the CPU.

A bf16 decode call whose (b, KV head) blocks would leave the card's SMs
idle cuts its keys into ranges, forms each range's partial (o, lse) and
merges them (``flash_attention_decode_split``: below D 256 one launch
whose ranges merge in a cluster, at D 256 two launches).  Here its plain
version (``ref.attention_split_ref``) is held against the JAX package's
attention on the same numpy inputs, the rules that pick the number of
ranges (``flash_attention.decode_split`` below D 256,
``d256_decode_split`` at D 256) are held at the served models' decode
shapes, and the wrappers' routing is checked with the C entries replaced
by recorders.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import contextlib
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.kernels.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels import abstract  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import attention_split_ref  # noqa: E402
from repro_torch.launch.graph_analysis import Recorder  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
H100_SMS = 132


def jax_lse(q, k, *, causal, window, softcap):
    """Each row's log-sum-exp of its scaled, soft-capped, masked scores, in
    JAX, as ``repro.kernels.ref.attention_ref`` forms the scores."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    kf = jnp.repeat(k, H // KV, axis=1).astype(jnp.float32)
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32), kf) / np.sqrt(D)
    if softcap > 0:
        s = softcap * jnp.tanh(s / softcap)
    q_pos, k_pos = jnp.arange(Sq)[:, None], jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return jax.nn.logsumexp(jnp.where(mask[None, None], s, -jnp.inf), axis=-1)


def inputs(seed, B, H, KV, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D), dtype=np.float32) * 2
    k = rng.standard_normal((B, KV, Sk, D), dtype=np.float32) * 2
    v = rng.standard_normal((B, KV, Sk, D), dtype=np.float32)
    return q, k, v


def wrapped_ring(k, positions, window):
    """The ring cache of ``window`` slots after ``positions`` writes, slot
    p % window holding position p: the last ``window`` keys, rotated."""
    ring = np.empty_like(k[:, :, :window])
    for p in range(positions - window, positions):
        ring[:, :, p % window] = k[:, :, p]
    return ring


# label, B, H, KV, Sq, Sk, D, causal, window, softcap
CASES = [
    ("gemma2 D 256 softcap 50 gqa 16/8", 1, 16, 8, 1, 40, 256, False, 0, 50.0),
    ("wrapped ring D 256", 1, 4, 2, 1, 24, 256, False, 0, 50.0),
    ("window 3, Sq 4 causal", 1, 4, 2, 4, 30, 64, True, 3, 0.0),
    ("ragged Sk 37 gqa 4", 2, 8, 2, 2, 37, 32, False, 0, 0.0),
]


def case_inputs(case):
    """(the port's q, k, v; JAX's q, k, v) of a case, as numpy: the same
    arrays, but for a wrapped ring, whose port cache holds the last keys
    of 40 positions rotated into its slots and JAX's the same keys in
    order."""
    label, B, H, KV, Sq, Sk, D = case[:7]
    if label.startswith("wrapped ring"):
        q, k, v = inputs(7, B, H, KV, Sq, 40, D)
        return (q, wrapped_ring(k, 40, Sk), wrapped_ring(v, 40, Sk)), (q, k[:, :, -Sk:],
                                                                      v[:, :, -Sk:])
    q, k, v = inputs(sum(map(ord, label)), B, H, KV, Sq, Sk, D)
    return (q, k, v), (q, k, v)


@functools.lru_cache(maxsize=None)
def jax_reference(index, dtype):
    """JAX's attention and log-sum-exp of CASES[index] on its inputs
    rounded to ``dtype``, computed in fp32 (as JAX's attention_ref computes
    a bf16 call), as numpy; once a case and dtype."""
    label, B, H, KV, Sq, Sk, D, causal, window, softcap = CASES[index]
    opts = dict(causal=causal, window=window, softcap=softcap)
    rounded = [jnp.asarray(a).astype(jnp.dtype(dtype)).astype(jnp.float32)
               for a in case_inputs(CASES[index])[1]]
    both = jax.jit(lambda q, k, v: (jax_attention_ref(q, k, v, **opts), jax_lse(q, k, **opts)))
    return tuple(np.asarray(a, np.float32) for a in both(*rounded))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 3, "more than keys"])
@pytest.mark.parametrize("index", range(len(CASES)), ids=[c[0] for c in CASES])
def test_split_plain_version_matches_jax(index, splits, dtype):
    """The keys cut into ranges, each range's (o, lse) from
    attention_lse_ref, merged: JAX's attention and log-sum-exp on the same
    inputs, with 1 range, 3, and more ranges than keys (the empty ones add
    nothing).  A wrapped ring's slots hold the last keys rotated: attention
    over them (no mask) is JAX's over the same keys in order."""
    label, B, H, KV, Sq, Sk, D, causal, window, softcap = CASES[index]
    n = Sk + 5 if splits == "more than keys" else splits
    opts = dict(causal=causal, window=window, softcap=softcap)
    want, want_lse = jax_reference(index, dtype)
    td = getattr(torch, dtype)
    out, lse = attention_split_ref(*(torch.from_numpy(a).to(td) for a in case_inputs(CASES[index])[0]),
                                   n, **opts)
    assert out.dtype == td and out.shape == (B, H, Sq, D) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), want, **TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL[dtype])


def test_split_rows_with_no_key_give_zero_and_minus_inf():
    """A row no range admits a key to (a window past the keys) gives 0 and
    lse -inf, not NaN, whatever the ranges: with 5 keys and a window of
    3, rows 7.. see none."""
    q, k, v = (torch.from_numpy(a) for a in inputs(3, 1, 2, 2, 12, 5, 16))
    for n in (1, 2, 9):
        out, lse = attention_split_ref(q, k, v, n, causal=False, window=3)
        assert torch.isfinite(out).all()
        assert torch.isneginf(lse[:, :, 7:]).all() and not out[:, :, 7:].any()
        assert torch.isfinite(lse[:, :, :7]).all()


# label, B, H, KV, Sq, Sk, D: the served models' decode calls (Sk 575:
# prompt 512 + 63 tokens), the lse entry's over a rank's half cache
DECODE_CALLS = [
    ("gemma2 ring", 2, 16, 8, 1, 4096, 256),
    ("gemma2 global", 2, 16, 8, 1, 5183, 256),
    ("gemma2 global, the kernel phase's", 2, 16, 8, 1, 5184, 256),
    ("gemma2 lse, a rank's half cache", 2, 16, 8, 1, 2592, 256),
    ("stablelm", 8, 32, 32, 1, 575, 80),
    ("zamba2", 8, 32, 32, 1, 575, 64),
    ("phi3.5", 8, 32, 8, 1, 575, 128),
    ("qwen2_vl", 8, 28, 4, 1, 575, 128),
    ("yi", 8, 56, 8, 1, 575, 128),
    ("command_r", 8, 96, 8, 1, 575, 128),
    ("llama4", 8, 40, 8, 1, 575, 128),
    ("musicgen", 8, 24, 24, 1, 575, 64),
    ("stablelm lse, a rank's half cache", 8, 32, 32, 1, 288, 80),
]
# Below D 256, the (splits, keys a split) that measured fastest on an H100
# (PERF.md): the fewest tiles a block streams with no more blocks
# than SMs.
SERVED_PLANS = {"stablelm": (1, 575), "zamba2": (1, 575), "musicgen": (1, 575),
                "stablelm lse, a rank's half cache": (1, 288), "qwen2_vl": (3, 192),
                "phi3.5": (2, 288), "yi": (2, 288), "command_r": (2, 288), "llama4": (2, 288)}


def rule(D):
    return fa.d256_decode_split if D == 256 else fa.decode_split


def assert_ranges(splits, chunk, Sk, step):
    """One range of every key, or ranges of whole ``step`` keys that cover
    Sk with none empty."""
    if splits == 1:
        assert chunk == Sk
    else:
        assert chunk % step == 0 and (splits - 1) * chunk < Sk <= splits * chunk


@pytest.mark.parametrize("call", DECODE_CALLS, ids=[c[0] for c in DECODE_CALLS])
def test_split_rule_at_the_served_decode_shapes(call):
    """Each rule is a pure function whose ranges cover the keys with none
    empty.  At D 256 gemma2's decode calls (ring, global, the lse entry's
    half cache) come out at >= 132 blocks on an H100.  Below D 256 the
    MHA calls stay whole (192-256 blocks: every SM has work), the GQA ones
    split as measured (``SERVED_PLANS``): qwen2_vl's 32 blocks 3 ways, the
    KV-8 families' 64 two ways; no grid above the SMs, a block streaming
    at most 3-5 tiles of 64 keys where it would stream 9."""
    label, B, H, KV, Sq, Sk, D = call
    rows = H // KV * Sq
    splits, chunk = rule(D)(B, KV, rows, Sk, H100_SMS)
    assert (splits, chunk) == rule(D)(B, KV, rows, Sk, H100_SMS)   # a pure function
    blocks = -(-rows // fa.DECODE_ROWS) * KV * B
    if D == 256:
        assert splits > 1 and blocks * splits >= H100_SMS
        assert_ranges(splits, chunk, Sk, fa.D256_SPLIT_STEP)
        assert chunk >= fa.D256_SPLIT_MIN_KEYS
        return
    assert (splits, chunk) == SERVED_PLANS[label]
    assert_ranges(splits, chunk, Sk, fa.SPLIT_KEYS)
    assert splits == 1 or blocks * splits <= H100_SMS
    if KV == H:
        assert splits == 1 and blocks >= H100_SMS
    else:
        assert splits > 1 and -(-chunk // fa.TILE_KEYS) < -(-Sk // fa.TILE_KEYS)


@pytest.mark.parametrize("Sk", [1, 64, 128, 129, 300, 5000, 100_000])
@pytest.mark.parametrize("blocks", [(1, 1), (2, 8), (4, 32), (8, 16)])
def test_split_rule_covers_the_keys(Sk, blocks):
    """Below D 256, for any cache length: one split, or at most MAX_SPLITS
    ranges of whole SPLIT_KEYS that cover Sk with no empty one, no more
    blocks than SMs, and fewer tiles a block than one range would stream
    (no split where the blocks already fill the SMs)."""
    B, KV = blocks
    splits, chunk = fa.decode_split(B, KV, 2, Sk, H100_SMS)
    assert_ranges(splits, chunk, Sk, fa.SPLIT_KEYS)
    if 2 * B * KV > H100_SMS or Sk <= fa.SPLIT_KEYS:
        assert splits == 1
    if splits > 1:
        assert splits <= fa.MAX_SPLITS and B * KV * splits <= H100_SMS
        assert -(-chunk // fa.TILE_KEYS) < -(-Sk // fa.TILE_KEYS)
        # no fewer ranges stream as few tiles
        for fewer in range(1, splits):
            c = -(-Sk // (fa.SPLIT_KEYS * fewer)) * fa.SPLIT_KEYS
            assert -(-c // fa.TILE_KEYS) > -(-chunk // fa.TILE_KEYS)


@pytest.mark.parametrize("Sk", [1, 64, 128, 129, 300, 5000, 100_000])
@pytest.mark.parametrize("blocks", [(1, 1), (2, 8), (4, 32), (8, 16)])
def test_d256_split_rule_covers_the_keys(Sk, blocks):
    """At D 256, for any cache length: one split, or ranges of whole
    D256_SPLIT_STEPs of at least D256_SPLIT_MIN_KEYS that cover Sk with no
    empty one, and no split where the blocks already fill the SMs."""
    B, KV = blocks
    splits, chunk = fa.d256_decode_split(B, KV, 2, Sk, H100_SMS)
    if B * KV >= H100_SMS or Sk <= fa.D256_SPLIT_MIN_KEYS:
        assert splits == 1
    if splits > 1:
        assert chunk % fa.D256_SPLIT_STEP == 0 and chunk >= fa.D256_SPLIT_MIN_KEYS
        assert (splits - 1) * chunk < Sk <= splits * chunk
        assert B * KV * splits <= 2 * fa.D256_SPLIT_WAVES * H100_SMS


@pytest.fixture
def recorded(monkeypatch):
    """The C entries replaced by recorders on CPU tensors (the launch's
    device and stream stubbed, an H100's SM count): which entry each
    wrapper call reached, with its arguments."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return lambda: fn

    monkeypatch.setattr(fa, "_require_cuda", lambda q: None)
    monkeypatch.setattr(fa, "_launch_stream", lambda device: contextlib.nullcontext(0))
    monkeypatch.setattr(fa, "sm_count", lambda device: H100_SMS)
    for attr, name in (("_kernel", "fwd"), ("_lse_kernel", "lse"), ("_split_kernel", "split")):
        monkeypatch.setattr(fa, attr, entry(name))
    monkeypatch.setattr(fa, "launches", 0)
    monkeypatch.setattr(fa, "lse_launches", 0)
    return calls


@pytest.mark.parametrize("B,H,KV,Sq,Sk,dtype,want", [
    (2, 16, 8, 1, 4096, torch.bfloat16, "split"),    # gemma2's ring decode
    (2, 16, 8, 1, 2592, torch.bfloat16, "split"),    # its lse half cache
    (8, 32, 32, 1, 575, torch.bfloat16, "plain"),    # stablelm: 256 blocks
    (2, 16, 8, 1, 4096, torch.float32, "plain"),     # fp32 never splits
    (2, 16, 8, 16, 4096, torch.bfloat16, "plain"),   # Sq 16: prefill mode
    (2, 16, 8, 1, 100, torch.bfloat16, "plain"),     # too few keys to cut at D 256
])
def test_wrappers_route_decode_calls_by_the_rule(recorded, B, H, KV, Sq, Sk, dtype, want):
    """flash_attention_cuda and flash_attention_lse_cuda send a bf16 decode
    call the rule splits to the split entry, with the rule's (splits,
    chunk) and, from the lse wrapper, the lse pointer; every other call to
    their own entry; each call counts one launch of its wrapper's counter.
    ``want`` is D 256's route (``d256_decode_split``); below D 256
    (``decode_split``) a bf16 decode call splits where that rule cuts it."""
    for D in (256, 16):
        q = torch.zeros(B, H, Sq, D, dtype=dtype)
        k = torch.zeros(B, KV, Sk, D, dtype=dtype)
        splits, chunk = rule(D)(B, KV, H // KV * Sq, Sk, H100_SMS)
        split = dtype == torch.bfloat16 and Sq < fa.DECODE_ROWS and splits > 1
        if D == 256:
            assert split == (want == "split")
        for wrapper in ("fwd", "lse"):
            before = len(recorded)
            if wrapper == "fwd":
                out = fa.flash_attention_cuda(q, k, k, causal=False, softcap=50.0)
            else:
                out, lse = fa.flash_attention_lse_cuda(q, k, k, causal=False, softcap=50.0)
            name, args = recorded[-1]
            assert len(recorded) == before + 1 and out.shape == (B, H, Sq, D)
            if split:
                assert name == "split" and args[6:8] == (splits, chunk) and splits > 1
                assert (args[4] is None) == (wrapper == "fwd")
                if wrapper == "lse":
                    assert args[4] == lse.data_ptr()
            else:
                assert name == wrapper
    assert (fa.launches, fa.lse_launches) == (2, 2)


def test_abstract_decode_records_the_same_flops():
    """On abstract tensors a bf16 decode call the rule would split records
    the call's FLOPs (4 D a query-key pair), as an unsplit one, and one
    launch; no SM count is asked for."""
    B, H, KV, Sk, D = 2, 16, 8, 4096, 256
    for entry in ("flash_attention", "flash_attention_lse"):
        rec = Recorder()
        with FakeTensorMode():
            q = torch.empty(B, H, 1, D, dtype=torch.bfloat16)
            k = torch.empty(B, KV, Sk, D, dtype=torch.bfloat16)
            with abstract.recording(rec):
                getattr(ops, entry)(q, k, k, causal=False, softcap=50.0)
        assert rec.kernel_launches == {entry: 1}
        assert rec.flops == abstract.attention_flops(B, H, 1, Sk, D) == 4 * D * B * H * Sk
