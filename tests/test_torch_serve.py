"""The port's static serve driver against the JAX package's decode loop.

On the smoke config, in fp32, with the JAX package's params bridged to
the port and the same numpy prompts: the port's one-pass prefill plus
greedy decode gives exactly the ids of a JAX token-by-token loop, as
``repro.launch.serve._run_static`` runs it.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mlstm, ssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402


def jax_greedy(cfg, params, prompts, G):
    """The token-by-token loop of ``repro.launch.serve._run_static``."""
    m = JaxModel(cfg)
    B, P = prompts.shape
    cache = m.init_cache(B, P + G)
    decode = jax.jit(m.decode_step)

    def tok(tokens, t):
        pos = jnp.full((B, 1), t, jnp.int32)
        return {"tokens": tokens, "cache_pos": jnp.int32(t),
                "positions": jnp.stack([pos, pos, pos]) if cfg.mrope_sections else pos}

    for t in range(P):
        logits, cache = decode(params, cache, tok(prompts[:, t:t + 1], t))
    nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    out = [nxt]
    for t in range(P, P + G - 1):
        logits, cache = decode(params, cache, tok(nxt, t))
        nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        out.append(nxt)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch,P", [("stablelm_3b", 8), ("yi_34b", 8), ("zamba2_1p2b", 8),
                                    ("zamba2_1p2b", 5), ("xlstm_125m", 8), ("xlstm_125m", 5),
                                    ("qwen2_vl_7b", 8), ("musicgen_medium", 8),
                                    ("gemma2_9b", 2), ("gemma2_9b", 13)])
def test_greedy_ids_equal_jax_token_by_token(arch, P):
    """zamba2 and xlstm at P = 5 prefill a prompt that is not a whole
    number of their chunks of 8.  qwen2-vl decodes with (3, B, 1) M-RoPE
    positions; musicgen is served from token ids (``_run_static`` sets
    ``embed_inputs=False``); gemma2, with its softcaps, at a cache of
    P + G = 8, its smoke window (the plain cache), and at P 13, past it:
    its local layers' ring caches wrap in the prefill and in decode."""
    B, G = 2, 6
    fp32 = dict(dtype="float32", logit_dtype="float32", embed_inputs=False)
    jcfg = jax_smoke_config(arch).replace(**fp32)
    jparams, _ = JaxModel(jcfg).init(jax.random.key(0))
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab, (B, P), dtype=np.int32)
    ref = jax_greedy(jcfg, jparams, jnp.asarray(prompts), G)

    model = Model(smoke_config(arch).replace(**fp32), device="cpu")
    params = bridge.to_torch({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    fa.launches = ssd.launches = mlstm.launches = 0
    res = serve.generate(model, params, torch.from_numpy(prompts).long(), G)
    assert res.generated.shape == (B, G)
    np.testing.assert_array_equal(res.generated.numpy(), ref)
    assert res.finite
    assert res.prefill_logits.shape == (B, jcfg.vocab)
    assert fa.launches == ssd.launches == mlstm.launches == 0   # CPU: the plain versions


def test_cli_runs_on_cpu_when_asked(capsys):
    rc = serve.main(["--static", "--arch", "stablelm_3b", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=stablelm-smoke batch=2 on cpu" in out
    assert "sample output ids:" in out


def test_cli_serves_zamba2_with_a_ragged_prompt(capsys):
    """The hybrid model through the CLI, with a prompt that is not a
    whole number of its chunks (as chip_smoke's 16-token warm-up is for
    the full config's chunk of 128)."""
    rc = serve.main(["--static", "--arch", "zamba2_1p2b", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "13", "--gen-len", "3"])
    assert rc == 0
    assert "arch=zamba2-smoke batch=2 on cpu" in capsys.readouterr().out


def test_cli_serves_xlstm_with_a_ragged_prompt(capsys):
    """xLSTM through the CLI, with a prompt shorter than its chunk of 8 and
    one that is not a whole number of chunks."""
    for prompt_len in ("3", "13"):
        rc = serve.main(["--static", "--arch", "xlstm_125m", "--device", "cpu",
                         "--batch", "2", "--prompt-len", prompt_len, "--gen-len", "3"])
        assert rc == 0
        assert "arch=xlstm-smoke batch=2 on cpu" in capsys.readouterr().out


def test_cli_serves_moe(capsys):
    """The MoE family through the CLI, its depth cut to one layer (phi3.5's
    top-2 routing, with capacity drops in the decode steps' calls of B
    tokens)."""
    rc = serve.main(["--static", "--arch", "phi35_moe_42b", "--device", "cpu",
                     "--layers", "1", "--batch", "3", "--prompt-len", "9", "--gen-len", "4"])
    assert rc == 0
    assert "arch=phi35-moe-smoke batch=3 on cpu" in capsys.readouterr().out


def test_profile_refuses_the_cpu():
    """--profile reports device time: it does not run on the CPU."""
    with pytest.raises(SystemExit):
        serve.main(["--static", "--arch", "stablelm_3b", "--device", "cpu", "--profile"])


def test_entry_points_without_a_card_raise():
    """No device given means cuda; with no card the port raises rather
    than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(smoke_config("stablelm_3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_model("stablelm_3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--static", "--arch", "stablelm_3b"])
    # the elastic plane's live executor puts its slots on the card too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--scenario", "serve-slo", "--executor", "live"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--scenario", "serve-slo"])
