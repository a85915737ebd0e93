"""The port's int8 gradient compression against the JAX package's
(``repro.optim.compression``), on the same numpy inputs: the cases of
``tests/test_compression.py``.  The int8 payload is equal, the scales
within 1e-7 relative (both compute max / 127 + 1e-12 in fp32), the byte
counts exact, and the error feedback the same over the steps.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import compression as jax_comp  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.compression import (  # noqa: E402
    compress_grads,
    compressed_bytes,
    compression_init,
    dequantize_int8,
    quantize_int8,
)


def _inputs(seed, scale, n=1000):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (7, 1.0), (42, 3.7), (100, 1e3)])
@pytest.mark.parametrize("block", [256, 64])
def test_quantize_matches_jax(seed, scale, block):
    x = _inputs(seed, scale)
    q, s = quantize_int8(torch.from_numpy(x), block=block)
    jq, js = jax_comp.quantize_int8(jnp.asarray(x), block=block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    deq = dequantize_int8(q, s, x.shape, torch.float32)
    np.testing.assert_allclose(deq.numpy(), np.asarray(
        jax_comp.dequantize_int8(jq, js, x.shape, jnp.float32)), rtol=1e-7, atol=0)
    # tests/test_compression.py's bound: within a block's max / 127
    assert float((deq - torch.from_numpy(x)).abs().max()) <= np.abs(x).max() / 127.0 + 1e-6


def test_error_feedback_carries_over_steps_as_jax():
    """Three steps of compress_grads on a tree whose grads change per step:
    the dequantized grads and the carried residual equal JAX's."""
    rng = np.random.default_rng(3)
    trees = [{"w": rng.standard_normal((300,)).astype(np.float32) * 0.01,
              "b": np.full((7, 5), 0.003, np.float32)} for _ in range(3)]
    state = compression_init({k: torch.from_numpy(v) for k, v in trees[0].items()})
    jstate = jax_comp.compression_init({k: jnp.asarray(v) for k, v in trees[0].items()})
    for tree in trees:
        deq, state = compress_grads({k: torch.from_numpy(v) for k, v in tree.items()}, state)
        jdeq, jstate = jax_comp.compress_grads({k: jnp.asarray(v) for k, v in tree.items()},
                                               jstate)
        for k in tree:
            np.testing.assert_allclose(deq[k].numpy(), np.asarray(jdeq[k]), rtol=1e-7, atol=1e-12)
            np.testing.assert_allclose(state.error[k].numpy(), np.asarray(jstate.error[k]),
                                       rtol=1e-6, atol=1e-12)
    assert float(state.error["b"].abs().max()) > 0   # a residual is carried at all


def test_error_feedback_accumulates():
    """tests/test_compression.py's: the long-run mean of the dequantized
    grads approaches the true gradient even when each step truncates."""
    g = {"w": torch.full((256,), 0.003)}
    state = compression_init(g)
    total = torch.zeros(256)
    for _ in range(50):
        deq, state = compress_grads(g, state)
        total += deq["w"]
    np.testing.assert_allclose((total / 50).numpy(), 0.003, rtol=0.05)


@pytest.mark.parametrize("shapes,dtype", [
    ([(1 << 16,)], np.float32),
    ([(1000,), (3, 5), (256,)], np.float32),
    ([(4, 4, 4), (1,)], np.float16),
])
@pytest.mark.parametrize("block", [256, 100])
def test_compressed_bytes_equal_jax(shapes, dtype, block):
    tree = {f"g{i}": np.zeros(s, dtype) for i, s in enumerate(shapes)}
    mine = compressed_bytes({k: torch.from_numpy(v) for k, v in tree.items()}, block)
    assert mine == jax_comp.compressed_bytes({k: jnp.asarray(v) for k, v in tree.items()}, block)
    if shapes == [(1 << 16,)]:
        assert mine[0] / mine[1] > 3.5


def test_training_converges_with_compression():
    params = {"x": torch.tensor([4.0, -2.0, 1.0])}
    opt = adamw_init(params)
    cstate = compression_init(params)
    for _ in range(300):
        g = {"x": 2 * params["x"]}
        g, cstate = compress_grads(g, cstate)
        params, opt = adamw_update(g, opt, params, 3e-2, weight_decay=0.0)
    assert float(torch.sum(params["x"] ** 2)) < 1e-2
