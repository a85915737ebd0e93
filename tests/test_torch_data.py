"""The port's synthetic stream against ``repro.data.SyntheticTokens``.

The stream is numpy in both packages and must be bit-identical: tokens,
labels, the embeddings of ``embed_inputs`` configs and the (3, B, S)
M-RoPE positions, at every seed and step, in ``iter``'s order too.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.data import SyntheticTokens as JaxTokens  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data import SyntheticTokens, to_device  # noqa: E402


def assert_same(mine: dict, ref: dict):
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype, k
        assert mine[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


@pytest.mark.parametrize("arch,keys", [
    ("stablelm_3b", {"tokens", "labels"}),
    ("qwen2_vl_7b", {"embeds", "labels", "positions"}),
    ("musicgen_medium", {"embeds", "labels"}),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_sample_is_bit_identical(arch, keys, seed):
    mine = SyntheticTokens(smoke_config(arch), 3, 12, seed=seed)
    ref = JaxTokens(jax_smoke_config(arch), 3, 12, seed=seed)
    for step in (0, 1, 7, 1000):
        got = mine.sample(step)
        assert set(got) == keys
        assert_same(got, ref.sample(step))
    if "positions" in keys:
        assert got["positions"].shape == (3, 3, 12)


@pytest.mark.parametrize("start", [0, 5])
def test_iter_keeps_the_order(start):
    cfg = smoke_config("stablelm_3b")
    mine = list(itertools.islice(SyntheticTokens(cfg, 2, 8).iter(start), 4))
    ref = list(itertools.islice(JaxTokens(jax_smoke_config("stablelm_3b"), 2, 8).iter(start), 4))
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert_same(a, b)
        assert_same(a, SyntheticTokens(cfg, 2, 8).sample(start + i))


def test_to_device_keeps_dtypes():
    batch = to_device(SyntheticTokens(smoke_config("qwen2_vl_7b"), 2, 8).sample(0), "cpu")
    assert batch["labels"].dtype == torch.int32
    assert batch["positions"].dtype == torch.int32
    assert batch["embeds"].dtype == torch.float32
    assert batch["positions"].shape == (3, 2, 8)
