"""The port's ElasticTrainer and ``--scenario`` driver against the JAX package's.

One JAX subprocess (8 forced host devices, as ``tests/test_elastic_trainer.py``
runs the JAX trainer) runs ``ElasticTrainer`` twice on the stablelm_3b
smoke config — on that test's scripted trace, and on ``restart-vs-shrink``
with a checkpoint directory and ``checkpoint_every=2`` — and the JAX
driver's ``run_scenario`` on ``steady-cycle``.  It dumps each trainer's
initial params (``_init_state()`` before ``run``), losses, node count
per step, the parity keys of ``runtime.history`` and ``transfer_log``,
and the driver's ``reconfig`` lines.  The port reruns both traces on the
CPU from those params (its own init cannot draw ``jax.random``'s bits):
records, node counts and logged bytes must be equal, the losses within
the model-level tolerance of ``tests/test_torch_train.py``.  The JAX
global batch is split over 1, 2 or 4 devices; the port computes it whole,
which gives the same loss.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.elastic import (  # noqa: E402
    DevicePool,
    ElasticRuntime,
    ElasticTrainer,
    SimulatedRMS,
    device_slots,
)
from repro_torch.elastic.rms import EventKind  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.malleability import get_scenario  # noqa: E402
from repro_torch.malleability.scenarios import RuntimeAdapter, record_parity_key  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train import TrainState  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TOL = dict(rtol=2e-3, atol=5e-4)
SCRIPT_EVENTS = [(5, EventKind.GROW, 4), (10, EventKind.SHRINK, (2, 3)), (15, EventKind.FAIL, 1)]

JAX_RUNS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import argparse, contextlib, io, json, sys, tempfile
    import numpy as np
    from repro.configs import smoke_config
    from repro.elastic import DevicePool, ElasticRuntime, ElasticTrainer, SimulatedRMS
    from repro.elastic.rms import EventKind
    from repro.launch.train import run_scenario
    from repro.malleability import get_scenario
    from repro.malleability.scenarios import RuntimeAdapter, record_parity_key
    from repro.models import Model

    out_dir = sys.argv[1]
    cfg = smoke_config("stablelm_3b")
    out = {}

    def run(name, tr, steps):
        tr._init_state()
        np.savez(os.path.join(out_dir, name + ".npz"),
                 **{k: np.asarray(v) for k, v in tr._state.params.items()})
        tr.run(steps)
        out[name] = {
            "losses": tr.losses(),
            "n_nodes": [r.n_nodes for r in tr.history],
            "history": [record_parity_key(RuntimeAdapter._convert(r))
                        for r in tr.runtime.history],
            "transfer_log": tr.transfer_log,
        }

    rms = SimulatedRMS.scripted([(5, EventKind.GROW, 4), (10, EventKind.SHRINK, (2, 3)),
                                 (15, EventKind.FAIL, 1)])
    run("scripted", ElasticTrainer(model=Model(cfg), runtime=ElasticRuntime(
        pool=DevicePool(), initial_nodes=1), rms=rms, batch=8, seq=32), 20)
    sc = get_scenario("restart-vs-shrink")
    run("restart", ElasticTrainer.from_scenario(
        Model(cfg), sc, batch=8, seq=32, checkpoint_dir=tempfile.mkdtemp(dir=out_dir),
        checkpoint_every=2), sc.steps)
    args = argparse.Namespace(scenario="steady-cycle", lr=3e-4, batch=8, seq=32, steps=50,
                              checkpoint_dir=None, checkpoint_every=50)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_scenario(Model(cfg), args)
    out["driver"] = [ln for ln in buf.getvalue().splitlines() if ln.startswith("reconfig ")]
    with open(os.path.join(out_dir, "runs.json"), "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("jax_elastic")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_RUNS, str(out_dir)],
                          capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out_dir / "runs.json") as f:
        runs = json.load(f)
    for name in ("scripted", "restart"):
        runs[name]["params"] = dict(np.load(out_dir / f"{name}.npz"))
    return runs


def with_jax_params(trainer: ElasticTrainer, arrays: dict) -> ElasticTrainer:
    """The JAX trainer's initial state, set before the first ``run`` (which
    keeps a state it finds)."""
    params = {k: v.requires_grad_() for k, v in bridge.to_torch(arrays, "cpu").items()}
    trainer._state = TrainState(params=params, opt=adamw_init(params),
                                step=torch.zeros((), dtype=torch.int32))
    return trainer


def assert_runs_equal(tr: ElasticTrainer, want: dict):
    assert [r.n_nodes for r in tr.history] == want["n_nodes"]
    got_keys = [list(record_parity_key(RuntimeAdapter._convert(r)))
                for r in tr.runtime.history]
    assert got_keys == want["history"]
    # every value in a transfer_log entry is an integer: compared exactly
    assert tr.transfer_log == want["transfer_log"]
    np.testing.assert_allclose(tr.losses(), want["losses"], **MODEL_TOL)


def test_scripted_trace_equals_jax(jax_runs):
    want = jax_runs["scripted"]
    tr = with_jax_params(ElasticTrainer(
        model=Model(smoke_config("stablelm_3b"), device="cpu"),
        runtime=ElasticRuntime(pool=DevicePool(devices=device_slots(8, "cpu")),
                               initial_nodes=1),
        rms=SimulatedRMS.scripted(SCRIPT_EVENTS), batch=8, seq=32), want["params"])
    tr.run(20)
    assert_runs_equal(tr, want)
    assert [r.n_nodes for r in tr.history][4:6] == [1, 4]
    kinds = [(r.kind, r.mechanism) for r in tr.runtime.history]
    assert kinds == [("expand", "hypercube"), ("shrink", "termination_shrinkage"),
                     ("fail", "termination_shrinkage")]


def test_restart_vs_shrink_equals_jax(jax_runs, tmp_path):
    want = jax_runs["restart"]
    sc = get_scenario("restart-vs-shrink")
    tr = with_jax_params(ElasticTrainer.from_scenario(
        Model(smoke_config("stablelm_3b"), device="cpu"), sc, batch=8, seq=32,
        checkpoint_dir=str(tmp_path), checkpoint_every=2), want["params"])
    tr.run(sc.steps)
    assert_runs_equal(tr, want)
    # the RESTART at step 5 rolled the params back to step 4's snapshot
    restores = [t for t in tr.transfer_log if "restored_from_step" in t]
    assert [(t["step"], t["restored_from_step"]) for t in restores] == [(5, 4)]
    assert tr.wall_log[1]["kinds"] == ["restart"] and tr.wall_log[1]["bytes_read"] > 0
    assert tr.wall_log[1]["read_s"] > 0 and tr.wall_log[0]["read_s"] == 0


def test_restart_restores_the_snapshot_bitwise(tmp_path):
    """Right after the restore, every param equals the latest snapshot on
    disk and the params the trainer held when it saved that snapshot; the
    optimizer state carries on."""
    from repro_torch.checkpoint import latest_step, restore_tree

    sc = get_scenario("restart-vs-shrink")
    tr = ElasticTrainer.from_scenario(Model(smoke_config("stablelm_3b"), device="cpu"), sc,
                                      batch=8, seq=32, checkpoint_dir=str(tmp_path),
                                      checkpoint_every=2)
    tr.run(4)
    at_save = {k: v.clone() for k, v in tr.state.params.items()}   # step 4's snapshot
    tr.run(1)
    mu = {k: v.clone() for k, v in tr.state.opt.mu.items()}
    step = latest_step(str(tmp_path))
    assert step == 4
    snap = restore_tree({"params": tr.state.params}, str(tmp_path), step)["params"]
    assert any(not torch.equal(tr.state.params[k], at_save[k]) for k in at_save)
    tr._ctx = tr._make_ctx()
    tr._restore_from_store(5)
    for k, v in snap.items():
        assert torch.equal(tr.state.params[k], v), k
        assert torch.equal(v, at_save[k]), k
        assert torch.equal(tr.state.opt.mu[k], mu[k]), k
    assert tr.transfer_log[-1]["restored_from_step"] == 4


def test_without_a_snapshot_restart_reshards_live():
    sc = get_scenario("restart-vs-shrink")
    tr = ElasticTrainer.from_scenario(Model(smoke_config("stablelm_3b"), device="cpu"), sc,
                                      batch=2, seq=8)
    tr.run(7)
    assert [t["step"] for t in tr.transfer_log] == [2, 5]
    assert all("restored_from_step" not in t for t in tr.transfer_log)


def test_cli_scenario_prints_the_jax_drivers_reconfigs(jax_runs, capsys):
    rc = train_cli.main(["--device", "cpu", "--arch", "stablelm_3b", "--scenario",
                         "steady-cycle", "--batch", "8", "--seq", "32"])
    out = capsys.readouterr().out
    assert rc == 0
    got = [ln for ln in out.splitlines() if ln.startswith("reconfig ")]
    want = jax_runs["driver"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        # the JAX line, then the label that says its costs are modelled
        assert g.startswith(w) and g[len(w):] == " (modelled, mn5 cluster)", (g, w)
    assert "scenario 'steady-cycle': 50 steps" in out


def test_from_scenario_builds_slots_on_the_models_device():
    sc = get_scenario("hetero-nasp")
    tr = ElasticTrainer.from_scenario(Model(smoke_config("stablelm_3b"), device="cpu"), sc,
                                      batch=2, seq=8)
    pool = tr.runtime.pool
    assert pool.node_widths == sc.core_pool and pool.total_devices() == sum(sc.core_pool)
    assert all(s.device.type == "cpu" for devs in pool.nodes.values() for s in devs)
    assert [s.id for s in tr.runtime.devices] == list(range(sc.core_pool[0]))


def test_cli_scenario_runs_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "stablelm_3b", "--scenario", "steady-cycle"])
