"""The port's training path against the JAX package's, on the CPU.

The same numpy inputs (``SyntheticTokens``, bridged params) go through
``repro.models.Model.loss`` with ``jax.value_and_grad``, ``repro.optim``,
``repro.train.steps.build_train_step`` and ``repro.checkpoint``, and
through their ports.  fp32 configs (``tests/test_torch_model.py``: the
JAX model rounds softmax probabilities to bf16 at bf16), with the
model-level tolerance of ``tests/test_models.py``; a gradient leaf must
also be within a relative rms of 1e-4, so that a zero gradient cannot
pass on atol.
"""
import argparse
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.parallel.sharding import ShardingContext  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch import bridge, checkpoint, optim  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data import SyntheticTokens, to_device  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import TrainState, build_train_step, loss_and_grads  # noqa: E402

MODEL_TOL = dict(rtol=2e-3, atol=5e-4)
B, S = 2, 16


def fp32(cfg, **kw):
    return cfg.replace(dtype="float32", logit_dtype="float32", **kw)


def pair(arch, seed=2, **kw):
    """(JAX model, JAX params, port model, port params that require grad)."""
    jm = JaxModel(fp32(jax_smoke_config(arch), **kw))
    jp, _ = jm.init(jax.random.key(seed))
    tm = Model(fp32(smoke_config(arch), **kw), device="cpu")
    tp = bridge.to_torch({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    return jm, jp, tm, {k: v.requires_grad_() for k, v in tp.items()}


def rel_rms(got, want) -> float:
    want = np.asarray(want, np.float64)
    err = np.asarray(got, np.float64) - want
    return float(np.sqrt(np.mean(err ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def assert_grads_close(got: dict, want: dict, zero=()):
    """Every leaf close to JAX's and reached; the leaves ``zero`` exactly 0
    in both packages."""
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].detach().numpy()
        w = np.asarray(want[k])
        if k in zero:
            assert not np.abs(w).any() and not np.abs(g).any(), k
            continue
        np.testing.assert_allclose(g, w, err_msg=k, **MODEL_TOL)
        assert rel_rms(g, w) <= 1e-4, (k, rel_rms(g, w))
        assert np.abs(w).max() > 0, k   # the leaf is reached at all


@pytest.mark.parametrize("arch,kw", [
    ("stablelm_3b", {}),
    ("gemma2_9b", {}),                       # window 8 < S, softcaps, local/global
    ("qwen2_vl_7b", {}),                     # embeddings in, (3, B, S) positions
    ("musicgen_medium", {}),                 # embeddings in
    ("stablelm_3b", {"loss_chunk": 4}),      # divides S: the chunked sum
    ("stablelm_3b", {"loss_chunk": 5}),      # does not: unchunked, as in JAX
    ("gemma2_9b", {"loss_chunk": 8}),
    ("gemma2_9b", {"head_dim": 256}),        # gemma2's own head dim
    ("zamba2_1p2b", {}),                     # Mamba2 layers + the shared block
    ("xlstm_125m", {}),                      # mLSTM + sLSTM units
    ("phi35_moe_42b", {}),                   # top-2 routing with capacity drops
    ("llama4_scout_17b", {}),                # top-1 routing + a shared expert
])
def test_loss_and_grads_match_jax(arch, kw):
    jm, jp, tm, tp = pair(arch, **kw)
    batch = SyntheticTokens(tm.cfg, B, S, seed=1).sample(3)
    batch["labels"] = batch["labels"].copy()
    batch["labels"][0, :3] = -1            # masked labels
    want_loss, want_grads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(tm, tp, to_device(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(want_loss), **MODEL_TOL)
    # top-1 routing: the softmax over one selected logit is 1, so the
    # router gets no gradient in either package
    top1 = tm.cfg.family == "moe" and tm.cfg.top_k == 1
    assert_grads_close(grads, want_grads, zero=("blocks/moe/router",) if top1 else ())


@pytest.mark.parametrize("arch", ["stablelm_3b", "zamba2_1p2b", "xlstm_125m", "phi35_moe_42b"])
def test_remat_changes_nothing(arch):
    """Recomputing each layer (a dense block; a Mamba2 layer with the shared
    block after it; an xLSTM unit) in the backward gives the same bits."""
    _, _, tm, tp = pair(arch)
    remat = Model(tm.cfg.replace(remat=True), device="cpu")
    batch = to_device(SyntheticTokens(tm.cfg, B, S).sample(0), "cpu")
    l0, g0 = loss_and_grads(tm, tp, batch)
    l1, g1 = loss_and_grads(remat, tp, batch)
    assert float(l0) == float(l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0)


def _tree(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # clipping off / on
def test_adamw_matches_jax(grad_scale):
    rng = np.random.default_rng(0)
    shapes = {"b/w": (4, 3), "a": (5,), "c/d/e": (2, 2, 2)}
    params = _tree(rng, shapes)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jax_optim.adamw_init(jp), optim.adamw_init(tp)
    for step in range(3):
        grads = _tree(rng, shapes, grad_scale)
        np.testing.assert_allclose(
            float(optim.global_norm({k: torch.from_numpy(v) for k, v in grads.items()})),
            float(jax_optim.global_norm({k: jnp.asarray(v) for k, v in grads.items()})),
            rtol=1e-6)
        jp, jstate = jax_optim.adamw_update({k: jnp.asarray(v) for k, v in grads.items()},
                                            jstate, jp, 1e-2)
        with torch.no_grad():
            tp, tstate = optim.adamw_update({k: torch.from_numpy(v) for k, v in grads.items()},
                                            tstate, tp, 1e-2)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (tstate.mu[k], jstate.mu[k]),
                              (tstate.nu[k], jstate.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 57, 100, 150])
def test_schedules_match_jax(step):
    for mine, ref in ((optim.cosine_schedule(3e-4, 100), jax_optim.cosine_schedule(3e-4, 100)),
                      (optim.linear_warmup_cosine(3e-4, 10, 100),
                       jax_optim.linear_warmup_cosine(3e-4, 10, 100))):
        np.testing.assert_allclose(float(mine(step)), float(ref(jnp.int32(step))), rtol=1e-6)
        np.testing.assert_allclose(float(mine(torch.tensor(step))), float(ref(step)), rtol=1e-6)


@pytest.mark.parametrize("arch,n_steps", [("stablelm_3b", 1), ("stablelm_3b", 10),
                                           ("zamba2_1p2b", 1), ("xlstm_125m", 1),
                                           ("phi35_moe_42b", 1), ("llama4_scout_17b", 1)],
                         ids=["1", "10", "zamba2_1p2b-1", "xlstm_125m-1", "phi35_moe_42b-1",
                              "llama4_scout_17b-1"])
def test_train_steps_match_jax(arch, n_steps):
    jm, jp, tm, tp = pair(arch)
    ctx = ShardingContext(mesh=make_host_mesh(1), mode="train")
    jstep, _, _ = jax_steps.build_train_step(jm, ctx, lr=1e-2)
    jstep = jax.jit(jstep)
    jstate = jax_steps.TrainState(params=jp, opt=jax_optim.adamw_init(jp),
                                  step=jnp.zeros((), jnp.int32))
    tstate = TrainState(params=tp, opt=optim.adamw_init(tp),
                        step=torch.zeros((), dtype=torch.int32))
    tstep = build_train_step(tm, lr=1e-2)
    data = SyntheticTokens(tm.cfg, B, S, seed=4)
    for i in range(n_steps):
        batch = data.sample(i)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm_ = tstep(tstate, to_device(batch, "cpu"))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), **MODEL_TOL)
        assert int(tm_["step"]) == int(jm_["step"]) == i + 1
    for k, want in jstate.params.items():
        got = tstate.params[k].detach().numpy()
        if n_steps == 1:
            np.testing.assert_allclose(got, np.asarray(want), err_msg=k, **MODEL_TOL)
        else:
            # a gradient component at rounding noise may flip an update's
            # sign (2 lr apart); the leaf as a whole stays close
            assert rel_rms(got, want) <= 1e-3, (k, rel_rms(got, want))


def _state_trees(seed=0):
    """The same train-state-like tree as JAX arrays and as port tensors."""
    rng = np.random.default_rng(seed)
    params = _tree(rng, {"blocks/attn/wq": (2, 4, 3), "embed/table": (6, 4),
                         "final_norm/scale": (4,)})
    mu, nu = _tree(rng, {k: v.shape for k, v in params.items()}), \
        _tree(rng, {k: v.shape for k, v in params.items()})
    jtree = jax_steps.TrainState(
        params={k: jnp.asarray(v) for k, v in params.items()},
        opt=jax_optim.AdamWState(step=jnp.int32(3), mu={k: jnp.asarray(v) for k, v in mu.items()},
                                 nu={k: jnp.asarray(v) for k, v in nu.items()}),
        step=jnp.int32(3))
    ttree = TrainState(
        params={k: torch.from_numpy(v) for k, v in params.items()},
        opt=optim.AdamWState(step=torch.tensor(3, dtype=torch.int32),
                             mu={k: torch.from_numpy(v) for k, v in mu.items()},
                             nu={k: torch.from_numpy(v) for k, v in nu.items()}),
        step=torch.tensor(3, dtype=torch.int32))
    return jtree, ttree


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_snapshot_layouts_are_equal(tmp_path):
    jtree, ttree = _state_trees()
    jpath = jax_ckpt.save_tree(jtree, str(tmp_path / "jax"), 7)
    tpath = checkpoint.save_tree(ttree, str(tmp_path / "port"), 7)
    assert os.path.basename(jpath) == os.path.basename(tpath) == "step_000000007"
    assert _manifest(jpath) == _manifest(tpath)
    assert sorted(os.listdir(jpath)) == sorted(os.listdir(tpath))
    assert _manifest(tpath)["leaves"][0]["key"] == "params/blocks/attn/wq"


def test_jax_snapshot_restores_in_the_port(tmp_path):
    jtree, ttree = _state_trees(1)
    jax_ckpt.save_tree({"params": jtree.params}, str(tmp_path), 2)
    jax_ckpt.save_tree(jtree, str(tmp_path / "state"), 5)
    assert checkpoint.latest_step(str(tmp_path)) == 2
    got = checkpoint.restore_tree({"params": ttree.params}, str(tmp_path), 2)
    for k, v in jtree.params.items():
        np.testing.assert_array_equal(got["params"][k].numpy(), np.asarray(v))
    state = checkpoint.restore_tree(ttree, str(tmp_path / "state"), 5)
    assert isinstance(state, TrainState) and isinstance(state.opt, optim.AdamWState)
    assert int(state.step) == int(state.opt.step) == 3
    for k, v in jtree.opt.nu.items():
        np.testing.assert_array_equal(state.opt.nu[k].numpy(), np.asarray(v))


def test_port_snapshot_restores_in_jax(tmp_path):
    jtree, ttree = _state_trees(2)
    checkpoint.save_tree(ttree, str(tmp_path), 4)
    assert jax_ckpt.latest_step(str(tmp_path)) == 4
    got = jax_ckpt.restore_tree(jtree, str(tmp_path), 4)
    for mine, ref in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(ref))


def test_restore_refuses_another_tree(tmp_path):
    _, ttree = _state_trees()
    checkpoint.save_tree({"params": ttree.params}, str(tmp_path), 1)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore_tree({"params": {"a": torch.zeros(1)}}, str(tmp_path), 1)
    renamed = {"params": {k.replace("wq", "wk"): v for k, v in ttree.params.items()}}
    with pytest.raises(ValueError, match="wq"):
        checkpoint.restore_tree(renamed, str(tmp_path), 1)
    with pytest.raises(TypeError, match="bfloat16"):
        checkpoint.save_tree({"w": torch.zeros(2, dtype=torch.bfloat16)}, str(tmp_path), 9)
    assert not os.path.exists(tmp_path / "step_000000009.tmp")


def test_manager_keeps_the_last_k_and_snapshots_eagerly(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    w = torch.zeros(3)
    for step in range(1, 5):
        w.fill_(float(step))
        mgr.save({"w": w}, step)
        w.fill_(-1.0)      # mutating after save() must not reach the snapshot
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_000000003", "step_000000004"]
    restored, step = mgr.restore_latest({"w": w})
    assert step == 4
    np.testing.assert_array_equal(restored["w"].numpy(), np.full(3, 4.0, np.float32))


def test_restore_into_copies_in_place_and_checks_each_leaf(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.restore_latest_into({"w": torch.zeros(3)}) == (None, 0)
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    mgr.save({"w": w}, 2)
    live = torch.zeros(2, 3)
    ptr = live.data_ptr()
    assert mgr.restore_latest_into({"w": live}) == (2, 24)
    assert live.data_ptr() == ptr and torch.equal(live, w)
    with pytest.raises(ValueError, match=r"\(2, 3\)"):
        checkpoint.restore_into({"w": torch.zeros(3, 2)}, str(tmp_path), 2)
    wrong = torch.zeros(2, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="float64"):
        checkpoint.restore_into({"w": wrong}, str(tmp_path), 2)
    assert not wrong.any()


def test_cli_trains_on_cpu_when_asked(capsys, tmp_path):
    rc = train_cli.main(["--device", "cpu", "--arch", "stablelm_3b", "--steps", "3",
                         "--batch", "2", "--seq", "16", "--checkpoint-dir", str(tmp_path),
                         "--checkpoint-every", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "step     0 loss" in out and "step     2 loss" in out
    assert os.listdir(tmp_path) == ["step_000000002"]
    keys = [m["key"] for m in _manifest(tmp_path / "step_000000002")["leaves"]]
    assert keys == sorted(keys) and all(k.startswith("params/") for k in keys)


@pytest.mark.parametrize("argv,item", [
    pytest.param(["--arch", "zamba2_1p2b", "--model-parallel", "2"], "A16b", id="argv1-A16b"),
    pytest.param(["--arch", "xlstm_125m", "--model-parallel", "2"], "A16b", id="argv2-A16b"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, argv, item):
    """What the CLI refused until its ROADMAP.md item (``item``) was
    ported now runs: the hybrid and xLSTM families on a model axis of 2,
    two ranks under ``torchrun``, their blocks tensor parallel over their
    heads."""
    from test_torch_parallel import _torchrun

    proc = _torchrun(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16", *argv],
                     tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh data 1 x model 2" in proc.stdout and "step     1 loss" in proc.stdout
    assert item not in proc.stdout + proc.stderr


def test_cli_refuses_nothing_of_gemma2_on_the_card():
    """gemma2's head dim 256 has a forward and a backward kernel, so the
    CLI refuses it nowhere: the refusal reads no config, and the full
    config goes on to look for the card (this needs none)."""
    for device in ("cuda", "cpu", None):
        args = argparse.Namespace(model_parallel=1, device=device)
        assert train_cli.refusal(args) is None
    if not torch.cuda.is_available():   # it goes on to look for the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--arch", "gemma2_9b", "--full-config", "--steps", "1"])


@pytest.mark.parametrize("scenario", [None, "steady-cycle"])
def test_cli_trains_gemma2_on_cpu(capsys, scenario):
    """gemma2 (local and global layers, softcaps) trains through the CLI at
    smoke size, plain and through the elastic loop, with finite losses."""
    argv = ["--device", "cpu", "--arch", "gemma2_9b", "--steps", "2", "--batch", "2",
            "--seq", "16"]
    if scenario:
        argv += ["--scenario", scenario]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    if scenario:
        assert f"scenario {scenario!r}: 30 steps" in out and out.count("reconfig ") == 4
    else:
        assert "step     0 loss" in out and "step     1 loss" in out


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_125m"])
@pytest.mark.parametrize("scenario", [None, "steady-cycle"])
def test_cli_trains_the_recurrent_families_on_cpu(capsys, arch, scenario):
    """The hybrid and xLSTM families train through the CLI at smoke size,
    plain and through the elastic loop (steady-cycle's 30 steps, a floor
    over --steps), with finite losses."""
    argv = ["--device", "cpu", "--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16"]
    if scenario:
        argv += ["--scenario", scenario]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    if scenario:
        assert f"scenario {scenario!r}: 30 steps" in out and out.count("reconfig ") == 4
    else:
        assert "step     0 loss" in out and "step     1 loss" in out


@pytest.mark.parametrize("arch", ["phi35_moe_42b", "llama4_scout_17b"])
@pytest.mark.parametrize("scenario", [None, "steady-cycle"])
def test_cli_trains_moe_on_cpu(capsys, arch, scenario):
    """The MoE family trains through the CLI at smoke width and one layer,
    plain and through the elastic loop, with finite losses."""
    argv = ["--device", "cpu", "--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16",
            "--layers", "1"]
    if scenario:
        argv += ["--scenario", scenario]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    if scenario:
        assert f"scenario {scenario!r}: 30 steps" in out and out.count("reconfig ") == 4
    else:
        assert "step     0 loss" in out and "step     1 loss" in out


def test_cli_runs_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "stablelm_3b", "--steps", "1"])
