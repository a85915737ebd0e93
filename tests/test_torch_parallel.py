"""Training across ranks: the port's mesh path against the JAX package's
under the same mesh, on the CPU.

Each case's smoke config in fp32 starts from the port's
``Model.init`` (seed 0), saved as numpy.  One JAX subprocess per mesh (4
forced host devices, as ``tests/test_torch_elastic_trainer.py`` runs its
JAX side; the meshes' subprocesses run at once) trains it under a
("data", "model") mesh through ``repro.train.steps.build_train_step`` and
``make_batch_on_mesh``, and saves the loss and every gradient leaf of the
first batch, and the losses and the params after two AdamW steps.  While
they run, the port runs the same cases in one process per rank
(``repro_torch.launch.mesh.spawn``: gloo, a ``FileStore`` under
``tmp_path``), each rank holding its storage shards and its data shard;
rank 0 gathers the grads and params whole.  fp32, so the two agree to
rounding: within 2e-5.  One case runs in bf16 (stablelm on (2, 2)), held
at the bf16 tolerance of ``tests/test_kernels.py``, 2e-2.

The recurrent families (zamba2, xlstm) run tensor parallel over their
heads on (1, 2) and (2, 2); qwen2_vl (M-RoPE positions), musicgen (an
``embeds`` input) and llama4 (a shared expert beside EP) on (2, 2).

phi3.5's and llama4's smoke configs on a (2, 2) mesh are the
expert-parallel cases JAX computes differently from one device (each
data shard routes its own tokens with a capacity from its own count), so
they are also held apart from JAX's single-device loss: a port that ran
the dense MoE on every rank would match that and fail here.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS, arch_config, smoke_config  # noqa: E402
from repro_torch.data import SyntheticTokens, make_batch_on_mesh  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, spawn  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402
from repro_torch.parallel.sharding import (ACT_RULES, Mesh, ProcessMesh,  # noqa: E402
                                           ShardingContext, resolve_spec, use_sharding)
from repro_torch.train import (TrainState, build_init_fn, build_train_step,  # noqa: E402
                               gather_params, loss_and_grads, param_layout)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, LR, STEPS = 2, 16, 3e-4, 2
TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)     # tests/test_kernels.py
BF16 = {"dtype": "bfloat16", "logit_dtype": "bfloat16"}
# mesh (data, model) -> [(case name, arch, config overrides)]
CASES = {
    (1, 2): [("stablelm", "stablelm_3b", {}),
             ("zamba2", "zamba2_1p2b", {}),                  # SSD heads over 'model'
             ("xlstm", "xlstm_125m", {})],                   # mLSTM / sLSTM heads
    (2, 2): [("stablelm", "stablelm_3b", {}),
             ("gemma2", "gemma2_9b", {}),                    # windows, both softcaps
             ("gemma2_chunked", "gemma2_9b", {"loss_chunk": 8}),
             ("phi35", "phi35_moe_42b", {}),                 # EP, local capacity
             ("zamba2", "zamba2_1p2b", {}),
             ("xlstm", "xlstm_125m", {}),                    # the sLSTM FFN (85) whole
             ("qwen2_vl", "qwen2_vl_7b", {}),                # M-RoPE positions (3, B, S)
             ("musicgen", "musicgen_medium", {}),            # an embeds input
             ("llama4", "llama4_scout_17b", {}),             # a shared expert beside EP
             ("stablelm_bf16", "stablelm_3b", BF16)],
    (1, 4): [("stablelm", "stablelm_3b", {}),
             ("phi35", "phi35_moe_42b", {})],                # EP; KV 2 replicated over 4
    (2, 1): [("zamba2", "zamba2_1p2b", {}),
             ("xlstm", "xlstm_125m", {}),
             ("phi35_dense", "phi35_moe_42b", {})],          # the global batch's dense MoE
}
# cases whose sequence the model axis does not divide (S 15 on a model
# axis of 2): the residual whole over 'model', as JAX falls back there
UNEVEN_S = 15
UNEVEN = {(1, 2): [("stablelm_s15", "stablelm_3b", {})],
          (2, 2): [("stablelm_s15", "stablelm_3b", {}),
                   ("gemma2_s15", "gemma2_9b", {}),
                   ("phi35_s15", "phi35_moe_42b", {}),
                   ("qwen2_vl_s15", "qwen2_vl_7b", {})]}
for _mesh, _cases in UNEVEN.items():
    CASES[_mesh] = CASES[_mesh] + _cases
CASE_SEQ = {name: UNEVEN_S for cases in UNEVEN.values() for name, _, _ in cases}
ALL_CASES = [(mesh, name) for mesh, cases in CASES.items() for name, _, _ in cases]
CASE_KW = {(mesh, name): (arch, kw) for mesh, cases in CASES.items() for name, arch, kw in cases}
# the JAX runs, at most this many cases a subprocess (they all run at once)
JAX_GROUP = 5


def fp32(arch, **kw):
    """The smoke config in fp32, unless ``kw`` names another dtype."""
    return smoke_config(arch).replace(**{"dtype": "float32", "logit_dtype": "float32", **kw})


# one step's collective bytes on (2, 2), beside chip_smoke's prediction:
# with remat, with a shared expert, and in bf16 (params gathered in bf16,
# their gradients reduce-scattered in fp32)
COMM_CASES = {"remat_stablelm_3b": fp32("stablelm_3b", remat=True),
              "remat_llama4_scout_17b": fp32("llama4_scout_17b", remat=True),
              "remat_zamba2_1p2b": fp32("zamba2_1p2b", remat=True),
              "remat_xlstm_125m": fp32("xlstm_125m", remat=True),
              "bf16_stablelm_3b": fp32("stablelm_3b", **BF16)}


# a rank's gathered weights under remat, tracked during one step of each
# arch's smoke config at HELD_LAYERS layers on each mesh
HELD_MESHES, HELD_ARCHS, HELD_LAYERS = ((1, 2), (2, 2)), ("stablelm_3b", "zamba2_1p2b"), 4
HELD_CASES = [(mesh, arch) for mesh in HELD_MESHES for arch in HELD_ARCHS]
# what a rank holds beyond its storage shards in a remat forward and
# backward of a narrow dense config, at each depth (the card test's config)
DEPTH_CFG, DEPTHS = dict(d_model=256, n_heads=4, n_kv_heads=4, d_ff=1024, vocab=512,
                         remat=True), (2, 6)


JAX_RUNS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import smoke_config
    from repro.data.pipeline import SyntheticTokens, make_batch_on_mesh
    from repro.models import Model
    from repro.optim import adamw_init
    from repro.parallel.sharding import ShardingContext, use_sharding
    from repro.train.steps import TrainState, build_train_step

    out_dir, spec = sys.argv[1], json.loads(sys.argv[2])
    B, LR, STEPS = spec["B"], spec["LR"], spec["STEPS"]
    for (D, M), name, arch, kw, S in spec["cases"]:
        cfg = smoke_config(arch).replace(**{"dtype": "float32", "logit_dtype": "float32", **kw})
        model = Model(cfg)
        init = {k: jnp.asarray(v) for k, v in np.load(os.path.join(out_dir, f"init_{name}.npz")).items()}
        mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M), ("data", "model"))
        ctx = ShardingContext(mesh=mesh, mode="train")
        step_fn, shardings, _ = build_train_step(model, ctx, lr=LR)
        params = jax.device_put(init, shardings.params)

        def value_and_grad(p, b):
            with use_sharding(ctx):
                return jax.value_and_grad(model.loss)(p, b)

        data = SyntheticTokens(cfg, B, S)
        loss, grads = jax.jit(value_and_grad)(params, make_batch_on_mesh(data.sample(0), cfg, ctx))
        state = TrainState(params=params, opt=adamw_init(params), step=jnp.zeros((), jnp.int32))
        step = jax.jit(step_fn)
        losses = []
        for i in range(STEPS):
            state, metrics = step(state, make_batch_on_mesh(data.sample(i), cfg, ctx))
            losses.append(float(metrics["loss"]))
        out = {"loss": np.float32(loss), "losses": np.array(losses)}
        out.update({"grad/" + k: np.asarray(v) for k, v in grads.items()})
        out.update({"param/" + k: np.asarray(v) for k, v in state.params.items()})
        if kw == {} and (arch in ("phi35_moe_42b", "llama4_scout_17b") or S != spec["S"]):
            host = {k: jnp.asarray(v) for k, v in data.sample(0).items()}
            out["single_device_loss"] = np.float32(jax.jit(model.loss)(init, host))
        np.savez(os.path.join(out_dir, f"{D}x{M}_{name}.npz"), **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, the port's results by mesh): the initial params
    drawn once, then the JAX subprocesses (a mesh's cases, ``JAX_GROUP``
    at most in each) started at once, and the port's spawns run while
    they work."""
    root = tmp_path_factory.mktemp("parallel")
    for name, arch, kw in {(n, a, tuple(sorted(k.items()))) for c in CASES.values()
                           for n, a, k in c}:
        params, _ = Model(fp32(arch, **dict(kw)), "cpu").init(torch.Generator().manual_seed(0))
        np.savez(root / f"init_{name}.npz", **{k: v.numpy() for k, v in params.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    procs = []
    groups = [(mesh, cases[i::n]) for mesh, cases in CASES.items()
              for n in [-(-len(cases) // JAX_GROUP)] for i in range(n)]
    for mesh, cases in groups:
        spec = {"B": B, "S": S, "LR": LR, "STEPS": STEPS,
                "cases": [[list(mesh), name, arch, kw, CASE_SEQ.get(name, S)]
                          for name, arch, kw in cases]}
        procs.append(subprocess.Popen([sys.executable, "-c", JAX_RUNS, str(root), json.dumps(spec)],
                                      stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                      text=True, env=env, cwd=ROOT))
    port = {}
    try:
        for mesh, cases in CASES.items():
            port[mesh] = root / ("port_%dx%d" % mesh)
            port[mesh].mkdir()
            spawn(_port_ranks, mesh[0] * mesh[1], (str(port[mesh]), str(root), mesh, cases),
                  init_file=str(port[mesh] / "store"), timeout=600)
        for proc in procs:
            _, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-3000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return root, port


def _port_ranks(out_dir: str, init_dir: str, mesh_shape: tuple, cases: list):
    """One rank of the port: every case of one mesh from its saved initial
    params; rank 0 saves what the test compares.  On the (2, 2) mesh also
    ``build_init_fn(model, ctx)``'s shards, gathered whole."""
    mesh = make_host_mesh(mesh_shape[1], device=torch.device("cpu"))
    ctx = ShardingContext(mesh=mesh, mode="train")
    for name, arch, kw in cases:
        cfg = fp32(arch, **kw)
        model = Model(cfg, "cpu")
        layout = param_layout(model, ctx)
        full = bridge.to_torch(dict(np.load(os.path.join(init_dir, f"init_{name}.npz"))), "cpu")
        params = {k: v[mesh.shard_slices(layout.storage[k], tuple(v.shape))].clone()
                  .requires_grad_() for k, v in full.items()}
        state = TrainState(params=params, opt=adamw_init(params),
                           step=torch.zeros((), dtype=torch.int32))
        data = SyntheticTokens(cfg, B, CASE_SEQ.get(name, S))
        loss, grads = loss_and_grads(model, state.params, make_batch_on_mesh(data.sample(0), cfg,
                                                                             ctx), layout)
        grads = gather_params(grads, layout)
        step = build_train_step(model, ctx, lr=LR)
        losses, comm = [], {}
        for i in range(STEPS):
            mesh.comm_bytes.clear()
            state, metrics = step(state, make_batch_on_mesh(data.sample(i), cfg, ctx))
            losses.append(float(metrics["loss"]))
            comm = comm or {f"{op} {ax}": n for (op, ax), n in mesh.comm_bytes.items()}
        after = gather_params(state.params, layout)
        if mesh.rank == 0:
            out = {"loss": np.float32(loss), "losses": np.array(losses),
                   "comm": np.array(json.dumps(comm))}
            out.update({"grad/" + k: v.numpy() for k, v in grads.items()})
            out.update({"param/" + k: v.detach().numpy() for k, v in after.items()})
            np.savez(os.path.join(out_dir, f"{name}.npz"), **out)
    if mesh_shape in HELD_MESHES:
        for arch in HELD_ARCHS:
            held = _held_gathers(ctx, smoke_config(arch).replace(n_layers=HELD_LAYERS, remat=True))
            if mesh.rank == 0:
                with open(os.path.join(out_dir, f"held_{arch}.json"), "w") as f:
                    json.dump(held, f)
        beyond = {n: _held_beyond_storage(ctx, smoke_config("stablelm_3b").replace(
            n_layers=n, **DEPTH_CFG)) for n in DEPTHS}
        if mesh.rank == 0:
            with open(os.path.join(out_dir, "beyond.json"), "w") as f:
                json.dump(beyond, f)
    if mesh_shape == (2, 2):
        for name, cfg in COMM_CASES.items():
            model = Model(cfg, "cpu")
            state = build_init_fn(model, ctx)(torch.Generator().manual_seed(0))
            mesh.comm_bytes.clear()
            build_train_step(model, ctx)(state, make_batch_on_mesh(
                SyntheticTokens(cfg, B, S).sample(0), cfg, ctx))
            if mesh.rank == 0:
                with open(os.path.join(out_dir, f"comm_{name}.json"), "w") as f:
                    json.dump({f"{op} {ax}": n for (op, ax), n in mesh.comm_bytes.items()}, f)
        model = Model(fp32("stablelm_3b"), "cpu")
        state = build_init_fn(model, ctx)(torch.Generator().manual_seed(0))
        drawn = gather_params(state.params, param_layout(model, ctx))
        if mesh.rank == 0:
            np.savez(os.path.join(out_dir, "drawn.npz"),
                     **{k: v.detach().numpy() for k, v in drawn.items()})


def _held_gathers(ctx, cfg) -> dict:
    """One train step of ``cfg`` on ``ctx``'s mesh with every output of
    ``ParamLayout.to_compute`` that owns memory of its own (a gather or a
    cast; not a view of the storage shard) tracked by weakref: the bytes
    of their storages alive at once at the peak, and the params they were
    gathered from then."""
    from repro_torch.train import ParamLayout

    tracked, peak = [], {"bytes": 0, "names": []}
    to_compute = ParamLayout.to_compute

    def tracking(self, name, p, dtype):
        out = to_compute(self, name, p, dtype)
        storage = out.untyped_storage()
        if storage.data_ptr() != p.untyped_storage().data_ptr():
            tracked.append((name, storage.nbytes(), weakref.ref(out)))
        alive = [(n, b) for n, b, ref in tracked if ref() is not None]
        if sum(b for _, b in alive) > peak["bytes"]:
            peak.update(bytes=sum(b for _, b in alive), names=sorted(n for n, _ in alive))
        return out

    model = Model(cfg, "cpu")
    state = build_init_fn(model, ctx)(torch.Generator().manual_seed(0))
    ParamLayout.to_compute = tracking
    try:
        build_train_step(model, ctx)(state, make_batch_on_mesh(SyntheticTokens(cfg, B, S).sample(0),
                                                               cfg, ctx))
    finally:
        ParamLayout.to_compute = to_compute
    return peak


class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops create, alive at once at the
    peak (weakrefs to the tensors; views of the storages in ``old`` do
    not count): ``torch.cuda.max_memory_allocated`` on the CPU."""

    def __init__(self, old):
        super().__init__()
        self.old, self.live, self.peak = set(old), {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                storage = t.untyped_storage()
                ptr = storage.data_ptr()
                if ptr and ptr not in self.old and ptr not in self.live:
                    self.live[ptr] = (storage.nbytes(), weakref.ref(t))
        self.live = {k: (b, ref) for k, (b, ref) in self.live.items() if ref() is not None}
        self.peak = max(self.peak, sum(b for b, _ in self.live.values()))
        return out


def _held_beyond_storage(ctx, cfg) -> int:
    """The peak of the bytes one forward and backward (``loss_and_grads``)
    of ``cfg`` creates, less the grads (storage, as the params and AdamW's
    moments are)."""
    model = Model(cfg, "cpu")
    state = build_init_fn(model, ctx)(torch.Generator().manual_seed(0))
    batch = make_batch_on_mesh(SyntheticTokens(cfg, B, 64).sample(0), cfg, ctx)
    trees = (state.params, state.opt.mu, state.opt.nu)
    live = _LiveBytes(t.untyped_storage().data_ptr() for tree in trees for t in tree.values())
    with live:
        loss_and_grads(model, state.params, batch, param_layout(model, ctx))
    return live.peak - sum(p.numel() * p.element_size() for p in state.params.values())


def _results(runs, mesh, name):
    root, port = runs
    return np.load(root / f"{mesh[0]}x{mesh[1]}_{name}.npz"), np.load(port[mesh] / f"{name}.npz")


@pytest.mark.parametrize("mesh,name", ALL_CASES, ids=[f"{m[0]}x{m[1]}-{n}" for m, n in ALL_CASES])
def test_step_matches_jax_under_the_same_mesh(runs, mesh, name):
    """The loss and every gradient leaf of the first batch, the losses of
    two AdamW steps and the params after them within 2e-5 of the JAX
    package's under the same mesh (2e-2 in bf16, where the worst leaf is
    printed).  An element whose first gradient is smaller than that
    tolerance has no sign the check pins, and AdamW steps it by about lr
    whatever its size: there the params are held within 2 lr a step, the
    most two such steps can set them apart."""
    arch, kw = CASE_KW[(mesh, name)]
    tol = BF16_TOL if kw == BF16 else TOL
    top1 = fp32(arch, **kw).top_k == 1
    ref, got = _results(runs, mesh, name)
    np.testing.assert_allclose(got["loss"], ref["loss"], **tol)
    np.testing.assert_allclose(got["losses"], ref["losses"], **tol)
    keys = sorted(k[5:] for k in ref.files if k.startswith("grad/"))
    assert keys == sorted(k[5:] for k in got.files if k.startswith("grad/"))
    worst = []
    for k in keys:
        g, w = got["grad/" + k], ref["grad/" + k]
        np.testing.assert_allclose(g, w, err_msg=k, **tol)
        if top1 and k.endswith("moe/router"):
            # top-1 routing weighs a token by the softmax of one logit, 1:
            # the router picks the expert and takes no gradient, in JAX too
            assert not w.any() and not g.any(), k
        else:
            assert np.abs(w).max() > 0, k      # the leaf is reached at all
        worst.append((float(np.max(np.abs(g - w) / (tol["atol"] + tol["rtol"] * np.abs(w)))), k))
        p, want = got["param/" + k], ref["param/" + k]
        free = np.abs(w) < tol["atol"]
        np.testing.assert_allclose(p[~free], want[~free], err_msg=k, **tol)
        assert np.abs(p - want)[free].max(initial=0.0) <= 2 * LR * STEPS, k
    if tol is BF16_TOL:
        print(f"{name}: loss {float(got['loss']):.6f} vs JAX {float(ref['loss']):.6f}; worst grad "
              f"leaf {max(worst)[1]} at {max(worst)[0]:.3f} of the bf16 tolerance")


@pytest.mark.parametrize("name", ["phi35", "llama4"])
def test_expert_parallel_routes_per_data_shard(runs, name):
    """phi3.5 and llama4 on (2, 2): JAX's loss there is not its
    single-device loss (capacity from each data shard's tokens), and the
    port's is JAX's."""
    ref, got = _results(runs, (2, 2), name)
    single = float(ref["single_device_loss"])
    assert abs(float(ref["loss"]) - single) > 1e-3
    assert abs(float(got["loss"]) - single) > 1e-3
    np.testing.assert_allclose(got["loss"], ref["loss"], **TOL)


def test_sharded_init_is_the_single_process_init(runs):
    """``build_init_fn(model, ctx)``: every rank draws from the seed and
    keeps its shard, so the gathered params are ``Model.init``'s."""
    drawn = np.load(runs[1][(2, 2)] / "drawn.npz")
    want, _ = Model(fp32("stablelm_3b"), "cpu").init(torch.Generator().manual_seed(0))
    assert sorted(drawn.files) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(drawn[k], v.numpy(), err_msg=k)


def test_collective_bytes_match_the_shapes(runs):
    """One step's bytes on the (2, 2) mesh, by collective and axis, equal
    chip_smoke.py's prediction from the shapes alone (also with remat,
    whose recompute repeats the forward's collectives but a block's last,
    with a shared expert, and in bf16)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, arch, kw in CASES[(2, 2)]:
        if name in CASE_SEQ:
            continue   # the prediction is of the sequence-parallel layout
        got = json.loads(str(np.load(runs[1][(2, 2)] / f"{name}.npz")["comm"]))
        cfg = fp32(arch, **kw)
        want = smoke.predicted_comm_bytes(torch, cfg, (2, 2), B, S)
        assert got == {f"{op} {ax}": n for (op, ax), n in want.items()}, name
    for name, cfg in COMM_CASES.items():
        with open(runs[1][(2, 2)] / f"comm_{name}.json") as f:
            got = json.load(f)
        want = smoke.predicted_comm_bytes(torch, cfg, (2, 2), B, S)
        assert got == {f"{op} {ax}": n for (op, ax), n in want.items()}, name


@pytest.mark.parametrize("mesh,arch", HELD_CASES, ids=[f"{m[0]}x{m[1]}-{a}" for m, a in HELD_CASES])
def test_a_rank_holds_one_units_gathered_weights(runs, mesh, arch):
    """A remat step at 4 layers gathers each block's params in its unit:
    the gathered weights alive at once are at most one layer's slice of
    each stacked param in its compute layout (every one of them, at the
    peak) plus the embedding, the head, the final norm and zamba2's shared
    block (the JAX package's scan gathers inside its body too)."""
    from collections import Counter

    with open(runs[1][mesh] / f"held_{arch}.json") as f:
        peak = json.load(f)
    cfg = smoke_config(arch).replace(n_layers=HELD_LAYERS, remat=True)
    model = Model(cfg, "cpu")
    layout = param_layout(model, ShardingContext(mesh=Mesh(tuple(range(math.prod(mesh))),
                                                           ("data", "model"), mesh)))
    bound = 0
    for k, shape in model.abstract_params()[0].items():
        n = math.prod(shape.shape) // mesh[1] ** sum(e == "model" for e in layout.compute[k])
        if k.startswith("blocks/"):
            n //= shape.shape[0]          # one layer's slice
        item = torch.empty((), dtype=cfg.compute_dtype).element_size() if k in layout.cast else 4
        bound += n * item
    blocks = {k for k in layout.storage if k.startswith("blocks/")}
    assert 0 < peak["bytes"] <= bound, (peak["bytes"], bound)
    assert blocks <= set(peak["names"]), sorted(blocks - set(peak["names"]))
    assert max(Counter(peak["names"]).values()) == 1, peak["names"]


@pytest.mark.parametrize("mesh", HELD_MESHES, ids=[f"{m[0]}x{m[1]}" for m in HELD_MESHES])
def test_what_a_rank_holds_beyond_storage_does_not_grow_with_depth(runs, mesh):
    """A remat forward and backward at 2 and at 6 layers of a narrow dense
    config: the bytes it holds at its peak beyond the storage shards
    (params, grads, AdamW moments) grow by less than two blocks' gathered
    weights (the
    remat carries, 4 x 32 KiB, are the growth; gathering the whole model
    first, or holding each layer's gradient to the end of the backward,
    adds a block a layer); the card test does the same on the card."""
    with open(runs[1][mesh] / "beyond.json") as f:
        beyond = {int(k): v for k, v in json.load(f).items()}
    cfg = smoke_config("stablelm_3b").replace(n_layers=DEPTHS[0], **DEPTH_CFG)
    model = Model(cfg, "cpu")
    layout = param_layout(model, ShardingContext(mesh=Mesh(tuple(range(math.prod(mesh))),
                                                           ("data", "model"), mesh)))
    block = sum(math.prod(s.shape[1:]) // mesh[1] ** sum(e == "model" for e in layout.compute[k])
                * 2 for k, s in model.abstract_params()[0].items() if k.startswith("blocks/"))
    assert 0 < beyond[DEPTHS[1]] - beyond[DEPTHS[0]] < 2 * block, (beyond, block)


# ------------------------------------------------------------------ specs --


def _jax_mesh(axis_names, shape):
    """What the JAX package's resolution reads of a mesh: its axis names
    and its devices' shape."""
    class _Mesh:
        pass
    m = _Mesh()
    m.axis_names, m.devices = tuple(axis_names), np.empty(shape)
    return m


ACT_AXES = [
    ("batch", "seq", "embed"), ("batch", "residual_seq", "embed"),
    ("batch", "seq", "heads", "head_dim"), ("batch", "seq", "kv_heads", "head_dim"),
    ("batch", "kv_seq", "kv_heads", "head_dim"), ("batch", "seq", "mlp"),
    ("batch", "seq", "vocab"), ("experts", "exp_capacity", "embed"),
    ("experts", "exp_capacity", "mlp"), ("batch", "seq"), (None, "batch", "seq"),
    ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    ("layers", "batch", "ssm_heads", "ssm_state", None), ("layers", "batch", None, "ssm_inner"),
    ("layers", None, "batch", "xlstm_heads", None, None), ("layers", "batch", "xlstm_heads", None),
]
MESHES = [(("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (2, 2)), (("data", "model"), (1, 4))]


def _act_shape(cfg, axes, batch, seq):
    dims = {"batch": batch, "seq": seq, "residual_seq": seq, "kv_seq": seq, "embed": cfg.d_model,
            "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
            "mlp": cfg.d_ff or 1, "vocab": cfg.vocab, "experts": max(cfg.n_experts, 1),
            "exp_capacity": max(int(batch * seq * max(cfg.top_k, 1) * cfg.capacity_factor
                                    / max(cfg.n_experts, 1)), 1) + 1,
            "layers": cfg.n_layers, "ssm_heads": 64, "ssm_state": cfg.ssm_state or 64,
            "ssm_inner": 4096, "xlstm_heads": cfg.n_heads, None: 3}
    return tuple(dims[a] for a in axes)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["train", "decode", "long"])
def test_activation_specs_equal_jax(arch, mode):
    """``resolve_spec(kind="act")`` equals the JAX package's for every
    activation axes the layers and caches use, at the train, decode and
    long shapes, on the production meshes and the host meshes."""
    from repro.parallel import sharding as jax_sharding

    for cfg in (arch_config(arch), smoke_config(arch)):
        for names, shape in MESHES:
            mine = ShardingContext(mesh=Mesh(tuple(range(int(np.prod(shape)))), names, shape),
                                   mode=mode)
            ref = jax_sharding.ShardingContext(mesh=_jax_mesh(names, shape), mode=mode)
            for batch, seq in ((256, 4096), (128, 32768), (1, 524288), (2, 16), (3, 5)):
                for axes in ACT_AXES:
                    dims = _act_shape(cfg, axes, batch, seq)
                    want = tuple(jax_sharding.resolve_spec(axes, dims, ref, "act"))
                    assert resolve_spec(axes, dims, mine, "act") == want, (axes, dims, names)
                    want_w = tuple(jax_sharding.resolve_spec(axes, dims, ref, "weight"))
                    assert resolve_spec(axes, dims, mine, "weight") == want_w, (axes, dims)


def test_overrides_and_unknown_modes_follow_jax():
    from repro.parallel import sharding as jax_sharding

    names, shape = ("data", "model"), (2, 4)
    kw = dict(weight_overrides={"embed": None}, act_overrides={"seq": "model", "batch": None})
    mine = ShardingContext(mesh=Mesh(tuple(range(8)), names, shape), **kw)
    ref = jax_sharding.ShardingContext(mesh=_jax_mesh(names, shape), **kw)
    for axes, dims in ((("batch", "seq", "embed"), (8, 16, 64)), (("embed", "mlp"), (64, 128))):
        for kind in ("act", "weight"):
            assert resolve_spec(axes, dims, mine, kind) == \
                tuple(jax_sharding.resolve_spec(axes, dims, ref, kind))
    with pytest.raises(KeyError):
        ShardingContext(mesh=mine.mesh, mode="prefill").act_rule("batch")
    assert set(ACT_RULES) == set(jax_sharding.ACT_RULES)


@pytest.mark.parametrize("arch", ["stablelm_3b", "gemma2_9b", "zamba2_1p2b", "xlstm_125m"])
def test_cache_layouts_equal_jax_where_the_batch_is_smaller_than_its_axes(arch):
    """``Model.cache_layouts`` is JAX's ``cache_shardings`` spec for every
    leaf, on (2, 2) in both serving modes, at a batch of 1 (smaller than
    the data axis: kept whole) and 2; stablelm's cache at batch 1 in
    decode mode is split over 'model' on its sequence alone."""
    from repro.models.transformer import init_cache_shapes as jax_cache_shapes
    from repro.parallel import sharding as jax_sharding

    cfg = smoke_config(arch)
    names, shape = ("data", "model"), (2, 2)
    for mode in ("decode", "long"):
        mine = ShardingContext(mesh=Mesh(tuple(range(4)), names, shape), mode=mode)
        ref = jax_sharding.ShardingContext(mesh=_jax_mesh(names, shape), mode=mode)
        for batch in (1, 2):
            got = Model(cfg, "cpu").cache_layouts(batch, 12, mine)
            want = {name: tuple(jax_sharding.resolve_spec(tuple(axes), tuple(dims), ref, "act"))
                    for name, (dims, _dt, axes, _f) in jax_cache_shapes(cfg, batch, 12).items()}
            assert got == want, (mode, batch)
    if arch == "stablelm_3b":
        ctx = ShardingContext(mesh=Mesh(tuple(range(4)), names, shape), mode="decode")
        assert Model(cfg, "cpu").cache_layouts(1, 12, ctx)["k"] == (None, None, "model", None,
                                                                     None)


@pytest.mark.parametrize("arch", ["stablelm_3b", "phi35_moe_42b", "qwen2_vl_7b", "musicgen_medium",
                                  "zamba2_1p2b", "xlstm_125m"])
def test_state_and_batch_shardings_equal_jax(arch):
    """``train_state_shardings``: params, mu and nu under the weight specs
    JAX's ``param_sharding_abstract`` resolves, the counters replicated;
    ``batch_shardings``: each field's spec as JAX's ``batch_shardings``
    resolves it."""
    from repro.data.pipeline import batch_spec as jax_batch_spec
    from repro.models import Model as JaxModel
    from repro.parallel import sharding as jax_sharding

    from repro_torch.train import batch_shardings, train_state_shardings

    cfg = arch_config(arch)
    for names, shape in MESHES:
        mine = ShardingContext(mesh=Mesh(tuple(range(int(np.prod(shape)))), names, shape))
        ref = jax_sharding.ShardingContext(mesh=_jax_mesh(names, shape))
        abstract, specs = train_state_shardings(Model(cfg, "cpu"), mine)
        jshapes, jspecs = JaxModel(cfg).abstract_params()
        want = {k: tuple(jax_sharding.resolve_spec(tuple(jspecs[k]), s.shape, ref, "weight"))
                for k, s in jshapes.items()}
        assert specs.params == specs.opt.mu == specs.opt.nu == want
        assert specs.step == specs.opt.step == ()
        assert {k: tuple(v.shape) for k, v in abstract.params.items()} == \
            {k: tuple(v.shape) for k, v in jshapes.items()}
        fields, spec_for = jax_batch_spec(cfg, ref)
        got = batch_shardings(cfg, mine, 256, 4096)
        assert sorted(got) == sorted(fields)
        for name, ndim in fields.items():
            dims = {"positions": (3, 256, 4096), "embeds": (256, 4096, cfg.d_model)}.get(
                name, (256, 4096))
            assert got[name] == tuple(jax_sharding.resolve_spec(
                tuple(spec_for(name, ndim)), dims, ref, "act")), name


def _rank_mesh(shape, rank):
    """A ProcessMesh seen from ``rank``, without a process group (enough
    for what reads only coordinates)."""
    return ProcessMesh(tuple(range(math.prod(shape))), ("data", "model"), shape, rank, {},
                       "gloo", torch.device("cpu"))


@pytest.mark.parametrize("arch", ["stablelm_3b", "qwen2_vl_7b", "musicgen_medium"])
def test_batch_shards_tile_the_host_batch(arch):
    """Every rank's ``make_batch_on_mesh`` shard is its block of the host
    batch (batch over 'data'; M-RoPE positions (None, batch, seq);
    embeddings (batch, seq, embed)), and they tile it."""
    cfg = smoke_config(arch)
    host = SyntheticTokens(cfg, 4, 8).sample(3)
    for shape in ((2, 2), (4, 1), (1, 4)):
        for rank in range(4):
            mesh = _rank_mesh(shape, rank)
            shard = make_batch_on_mesh(host, cfg, ShardingContext(mesh=mesh))
            d, n = mesh.axis_index("data"), shape[0]
            for k, v in host.items():
                axis = 1 if k == "positions" else 0
                rows = np.take(v, range(d * 4 // n, (d + 1) * 4 // n), axis=axis)
                np.testing.assert_array_equal(shard[k].numpy(), rows, err_msg=k)
    with pytest.raises(ValueError, match="evenly"):
        make_batch_on_mesh(SyntheticTokens(cfg, 3, 8).sample(0), cfg,
                           ShardingContext(mesh=_rank_mesh((2, 2), 0)))


def test_collectives_are_each_others_transposes(tmp_path):
    spawn(_collective_ranks, 4, (str(tmp_path),), init_file=str(tmp_path / "store"))
    for rank in range(4):
        assert (tmp_path / f"ok{rank}").exists()


def test_cast_gather_sums_gradients_in_the_masters_dtype(tmp_path):
    spawn(_cast_ranks, 2, (str(tmp_path),), init_file=str(tmp_path / "store"))
    assert (tmp_path / "ok0").exists() and (tmp_path / "ok1").exists()


def _cast_ranks(out_dir: str):
    """``redistribute(x, ..., dtype)``, as the train step gathers an fp32
    master into its bf16 compute layout: the gather moves bf16, and the
    gradient comes back in fp32, reduce-scattered in fp32.  The two ranks'
    cotangents, 1 and 2^-8, sum to a number bf16 does not hold."""
    mesh = make_host_mesh(2, device=torch.device("cpu"))
    r = mesh.rank
    x = torch.full((2, 3), 1.0 + 2.0 ** -7 * (r + 1) + 2.0 ** -12, requires_grad=True)
    y = coll.redistribute(x, mesh, (("model",), ()), ((), ()), torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.shape == (4, 3)
    rows = [torch.full((2, 3), 1.0 + 2.0 ** -7 * (p + 1) + 2.0 ** -12).bfloat16() for p in (0, 1)]
    assert torch.equal(y, torch.cat(rows))
    y.backward(torch.full_like(y, 1.0 if r == 0 else 2.0 ** -8))
    assert x.grad.dtype == torch.float32
    assert torch.equal(x.grad, torch.full((2, 3), 1.0 + 2.0 ** -8))
    assert mesh.comm_bytes == {("all_gather", "model"): 4 * 3 * 2,
                               ("reduce_scatter", "model"): 4 * 3 * 4}
    # a dimension the target adds (a take): the gradient is zero-padded
    z = torch.ones(4, requires_grad=True)
    w = coll.redistribute(z, mesh, ((),), (("model",),), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (2,)
    w.backward(torch.full_like(w, 3.0))
    assert torch.equal(z.grad, torch.tensor([3.0, 3.0, 0.0, 0.0]).roll(2 * r))
    open(os.path.join(out_dir, f"ok{r}"), "w").close()


def _collective_ranks(out_dir: str):
    """all_gather / reduce_scatter / all_reduce against their definitions,
    and their backwards against the transposes, on a (2, 2) mesh: with
    x_r the rank's input and a fixed cotangent per rank, the gradient of
    sum_r <ct_r, f(x)_r> is what the transpose gives."""
    mesh = make_host_mesh(2, device=torch.device("cpu"))
    r = mesh.rank
    m = mesh.axis_index("model")
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    g = coll.all_gather(x, mesh, "model", 1)                      # (2, 6)
    peers = [mesh.axis_index("data") * 2 + j for j in range(2)]
    assert torch.equal(g, torch.cat([torch.full((2, 3), float(p + 1)) for p in peers], 1))
    g.backward(torch.full_like(g, float(r + 1)))
    # d/dx_r of sum_p <c_p, gather(x)_p> = sum over the peers of c_p (my columns)
    assert torch.equal(x.grad, torch.full((2, 3), float(sum(p + 1 for p in peers))))
    y = torch.arange(8, dtype=torch.float32).reshape(2, 4).requires_grad_()
    s = coll.reduce_scatter(y * (r + 1), mesh, "model", 1)
    assert torch.equal(s, (torch.arange(8.).reshape(2, 4) * sum(p + 1 for p in peers))[:, 2 * m:2 * m + 2])
    s.sum().backward()
    assert torch.equal(y.grad, torch.full((2, 4), float(r + 1)))
    z = torch.ones(3, requires_grad=True)
    a = coll.all_reduce(z * (r + 1), mesh, "data")
    a.sum().backward()
    assert torch.equal(z.grad, torch.full((3,), 2.0 * (r + 1)))
    mx = coll.all_reduce(torch.tensor([float(r)]), mesh, "model", op="max")
    assert float(mx) == max(peers)
    with pytest.raises(ValueError, match="no gradient"):
        coll.all_reduce(z * 1.0, mesh, "model", op="max")
    assert mesh.comm_bytes[("all_gather", "model")] == 2 * 6 * 4 + 2 * 4 * 4
    # A remat'ed block's recompute sees the context of its forward, also
    # when the backward runs where that context is not current (autograd
    # runs CUDA backwards on a thread of its own).
    from repro_torch.parallel.sharding import use_sharding
    from repro_torch.train.steps import param_layout as layout_of

    ctx = ShardingContext(mesh=mesh)
    cfg = fp32("stablelm_3b", remat=True)
    model = Model(cfg, "cpu")
    layout = layout_of(model, ctx)
    params = build_init_fn(model, ctx)(torch.Generator().manual_seed(0)).params
    batch = make_batch_on_mesh(SyntheticTokens(cfg, 2, 8).sample(0), cfg, ctx)
    grads = []
    for inside in (True, False):
        with use_sharding(ctx):
            loss = model.loss({k: layout.to_compute(k, v, cfg.compute_dtype)
                               for k, v in params.items()}, batch)
            if inside:
                grads.append(torch.autograd.grad(loss, list(params.values())))
        if not inside:
            grads.append(torch.autograd.grad(loss, list(params.values())))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    open(os.path.join(out_dir, f"ok{r}"), "w").close()


# -------------------------------------------------------------------- CLI --


def _torchrun(args, tmp_path, world=2):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", "-m", "repro_torch.launch.train", *args]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env,
                          cwd=str(tmp_path))


def test_cli_trains_on_a_mesh_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train
    --model-parallel 2 --device cpu``: rank 0 prints the JAX CLI's step
    lines and the backend, and ``--checkpoint-dir`` writes the full params
    in the store's layout, which the JAX package restores."""
    import jax

    from repro import checkpoint as jax_ckpt
    from repro.configs import smoke_config as jax_smoke
    from repro.models import Model as JaxModel

    ckpt = tmp_path / "ckpt"
    proc = _torchrun(["--arch", "stablelm_3b", "--model-parallel", "2", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16", "--checkpoint-dir",
                      str(ckpt), "--checkpoint-every", "2"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert out.count("step     0 loss") == 1 and out.count("step     1 loss") == 1
    assert "mesh data 1 x model 2, backend gloo" in out
    assert os.listdir(ckpt) == ["step_000000002"]
    template, _ = JaxModel(jax_smoke("stablelm_3b")).init(jax.random.key(0))
    got = jax_ckpt.restore_tree({"params": template}, str(ckpt), 2)
    single = tmp_path / "single"
    assert train_cli.main(["--arch", "stablelm_3b", "--device", "cpu", "--steps", "2",
                           "--batch", "2", "--seq", "16", "--checkpoint-dir", str(single),
                           "--checkpoint-every", "2"]) == 0
    want = jax_ckpt.restore_tree({"params": template}, str(single), 2)
    for k, v in want["params"].items():
        # bf16 compute: the two runs round differently, and each of the two
        # AdamW steps of lr 3e-4 moves an element by at most about lr
        np.testing.assert_allclose(np.asarray(got["params"][k]), np.asarray(v),
                                   atol=2 * 2 * 3e-4, err_msg=k)


def test_cli_trains_every_family_on_a_data_only_mesh(tmp_path):
    proc = _torchrun(["--arch", "zamba2_1p2b", "--device", "cpu", "--steps", "2", "--batch",
                      "2", "--seq", "16"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh data 2 x model 1" in proc.stdout and "step     1 loss" in proc.stdout


def test_cli_refuses_a_model_axis_the_world_cannot_hold(capsys):
    assert train_cli.main(["--arch", "stablelm_3b", "--device", "cpu", "--steps", "1",
                           "--model-parallel", "2"]) == 2
    assert "torchrun" in capsys.readouterr().err


def test_mesh_refuses_a_model_axis_that_splits_no_sequence(runs):
    """No longer refused: a model axis of 2 that does not divide S 15
    runs the step with the residual whole over 'model', as JAX's
    ``_row_parallel_ctx`` falls back there.  On (1, 2) and (2, 2) the
    dense step's loss is JAX's under the same mesh and JAX's on one
    device, and its gradients and the params after two AdamW steps are
    JAX's under the same mesh (every S 15 case's are in
    ``test_step_matches_jax_under_the_same_mesh``)."""
    for mesh in UNEVEN:
        ref, got = _results(runs, mesh, "stablelm_s15")
        np.testing.assert_allclose(got["loss"], ref["loss"], **TOL)
        np.testing.assert_allclose(got["loss"], ref["single_device_loss"], **TOL)
        np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
        for k in (k for k in ref.files if k.startswith(("grad/", "param/"))):
            assert np.isfinite(got[k]).all(), k
            np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)


@pytest.mark.parametrize("config,m,split", [(smoke_config, 2, False), (arch_config, 4, True)])
def test_slstm_ffn_splits_where_the_model_axis_divides_its_width(config, m, split):
    """The sLSTM FFN's width is int(4 d / 3), not ``cfg.d_ff`` (0 for
    xlstm): 85 on the smoke config, whole on a model axis of 2; 1024 on
    the full one, split over 4.  The recurrent heads split (4 of them),
    and the params whose columns concatenate parts stay whole."""
    from repro_torch.models.layers import compute_spec

    cfg = config("xlstm_125m")
    shapes, specs = Model(cfg, "cpu").abstract_params()
    width = int(4 * cfg.d_model / 3)
    assert shapes["blocks/slstm/ff_gate"].shape[-1] == width == (1024 if split else 85)

    def spec(k):
        return compute_spec(k, tuple(specs[k]), tuple(shapes[k].shape), cfg, m)

    ffn = "model" if split else None
    assert spec("blocks/slstm/ff_gate") == spec("blocks/slstm/ff_up") == (None, None, ffn)
    assert spec("blocks/slstm/ff_down") == (None, ffn, None)
    assert spec("blocks/slstm/r") == (None, None, "model", None, None)
    assert spec("blocks/mlstm0/wq") == (None, None, "model")
    assert spec("blocks/mlstm0/down") == (None, "model", None)
    for k in ("blocks/slstm/w_in", "blocks/slstm/bias", "blocks/mlstm0/up", "blocks/mlstm0/w_if"):
        assert set(spec(k)) == {None}, k


def test_chip_smoke_defines_every_phase_before_it_runs():
    """``python3 chip_smoke.py`` calls ``main`` from its ``__main__``
    guard: every function ``main`` calls must be defined above the guard
    (the CPU cannot reach the phases, which need a card)."""
    import ast

    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    guard = [i for i, node in enumerate(tree.body) if isinstance(node, ast.If)
             and "__main__" in ast.unparse(node.test)]
    assert guard == [len(tree.body) - 1]
    defined = {node.name for node in tree.body[:-1] if isinstance(node, ast.FunctionDef)}
    main = next(node for node in tree.body if isinstance(node, ast.FunctionDef)
                and node.name == "main")
    called = {node.func.id for node in ast.walk(main) if isinstance(node, ast.Call)
              and isinstance(node.func, ast.Name) and node.func.id in
              {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}}
    assert "train_parallel_phase" in called and called <= defined


# ------------------------------------------------------ serving on a mesh --

# (mesh, case name, arch, mode): each family's smoke config served in both
# serving modes on (1, 2) and (2, 2); gemma2's rings (8 slots) wrap within
# SERVE_STEPS tokens of a cache of SERVE_LEN, and the written slot crosses
# from one rank's slice of every cache into the next's
SERVE_FAMILIES = [("stablelm", "stablelm_3b"), ("gemma2", "gemma2_9b"), ("zamba2", "zamba2_1p2b"),
                  ("xlstm", "xlstm_125m"), ("phi35", "phi35_moe_42b")]
SERVE_STEPS, SERVE_LEN, SERVE_PROMPT = 10, 12, 4
SERVE_BATCH = {"decode": 2, "long": 1}
# (mesh, case name, arch, mode, batch); and a decode batch of 1 on (2, 2),
# smaller than the data axis its rule names: JAX keeps it whole, its cache
# P(None, None, 'model', None, None), and both data rows of ranks compute it
SERVE_CASES = [((D, M), name, arch, mode, SERVE_BATCH[mode]) for D, M in ((1, 2), (2, 2))
               for name, arch in SERVE_FAMILIES for mode in ("decode", "long")] + [
    ((2, 2), "stablelm", "stablelm_3b", "decode", 1)]


def _serve_tag(mesh, name, mode, batch) -> str:
    """A serving case's file tag (and, with '-' for '_', its test id)."""
    return (f"{mesh[0]}x{mesh[1]}_{name}_{mode}"
            + ("" if batch == SERVE_BATCH[mode] else f"_batch{batch}"))

JAX_SERVE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import smoke_config
    from repro.models import Model
    from repro.parallel.sharding import (ShardingContext, param_sharding_abstract, resolve_spec,
                                         use_sharding)
    from repro.train.steps import build_serve_step, cache_shardings, serving_param_shapes

    out_dir, spec = sys.argv[1], json.loads(sys.argv[2])
    for (D, M), name, arch, mode, B in spec["cases"]:
        cfg = smoke_config(arch).replace(dtype="float32", logit_dtype="float32")
        model = Model(cfg)
        mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M), ("data", "model"))
        ctx = ShardingContext(mesh=mesh, mode=mode)
        shapes, pspecs = serving_param_shapes(model)
        p_sh = param_sharding_abstract(shapes, pspecs, ctx)
        init = dict(np.load(os.path.join(out_dir, f"init_{name}.npz")))
        params = jax.device_put({k: jnp.asarray(v) for k, v in init.items()}, p_sh)
        c_sh = cache_shardings(model, ctx, B, spec["len"])
        cache = jax.device_put(model.init_cache(B, spec["len"]), c_sh)
        tokens = np.load(os.path.join(out_dir, f"tokens_{B}.npy"))
        tok_sh = {"cache_pos": NamedSharding(mesh, P()),
                  "tokens": NamedSharding(mesh, resolve_spec(("batch", "seq"), (B, 1), ctx, "act")),
                  "positions": NamedSharding(mesh, resolve_spec(("batch", "seq"), (B, 1), ctx,
                                                                "act"))}
        step = jax.jit(build_serve_step(model, ctx), in_shardings=(p_sh, c_sh, tok_sh),
                       out_shardings=(None, c_sh), donate_argnums=(1,))
        def decode(cache, start, logits):
            for t in range(start, spec["steps"]):
                tok = {"tokens": jnp.asarray(tokens[:, t:t + 1]), "cache_pos": jnp.int32(t),
                       "positions": jnp.full((B, 1), t, jnp.int32)}
                lg, cache = step(params, cache, tok)
                logits.append(np.asarray(lg[:, 0]))
            return np.stack(logits, 1)

        tag = f"{D}x{M}_{name}_{mode}" + spec["suffix"].get(str(B), "")
        np.save(os.path.join(out_dir, f"jax_{tag}.npy"), decode(cache, 0, []))
        if cfg.family in ("hybrid", "ssm"):
            continue   # the JAX forward collects no recurrent state: token by token is the reference
        # dense and MoE: JAX's prefill cell (train mode) fills the cache, then the steps
        # (the MoE capacity of a prompt differs from a token's, so the logits do too)
        P_ = spec["prompt"]
        # JAX's train mode needs the data axis to split the batch; a batch of
        # one is the same prompt on every data shard: one device's prefill
        tctx = ShardingContext(mesh=mesh, mode="train") if B % D == 0 else None

        def prefill(p, b):
            with use_sharding(tctx):
                return model.forward(p, b, collect_kv=True)

        lg, (k, v) = jax.jit(prefill)(params, {"tokens": jnp.asarray(tokens[:, :P_])})
        host = {n: np.array(x) for n, x in model.init_cache(B, spec["len"]).items()}
        loc = list(range(0, cfg.n_layers, 2)) if "k_loc" in host else []
        glob = [i for i in range(cfg.n_layers) if i not in loc]
        for name_, idx in (("k", glob), ("k_loc", loc)):
            if idx:
                host[name_][:, :, :P_] = np.asarray(k)[idx]
                host["v" + name_[1:]][:, :, :P_] = np.asarray(v)[idx]
        cache = jax.device_put({n: jnp.asarray(x) for n, x in host.items()}, c_sh)
        np.save(os.path.join(out_dir, f"jaxprefill_{tag}.npy"),
                decode(cache, P_, [np.asarray(lg[:, -1])]))
""")


def _serve_tok(tokens, t):
    B = tokens.shape[0]
    return {"tokens": torch.as_tensor(tokens[:, t:t + 1]), "cache_pos": t,
            "positions": torch.full((B, 1), t, dtype=torch.int32)}


def _serve_ranks(out_dir: str, mesh_shape: tuple, cases: list):
    """One rank of the port: every serving case of one mesh, token by token
    from an empty cache, then from a prefill of the first SERVE_PROMPT
    tokens (in train mode, its K/V and states moved into the cache's
    layout); rank 0 saves the logits of both, and the collective bytes."""
    import dataclasses

    from repro_torch.train import build_prefill_step, build_serve_step, place_batch, shard_params

    torch.set_num_threads(1)   # tiny tensors: the ranks' threads would only contend
    mesh = make_host_mesh(mesh_shape[1], device=torch.device("cpu"))
    for name, arch, mode, B in cases:
        ctx = ShardingContext(mesh=mesh, mode=mode)
        model = Model(fp32(arch), "cpu")
        full = bridge.to_torch(dict(np.load(os.path.join(out_dir, f"init_{name}.npz"))), "cpu")
        params = shard_params(full, param_layout(model, ctx))
        tokens = np.load(os.path.join(out_dir, f"tokens_{B}.npy"))
        step = build_serve_step(model, ctx)
        runs = {}
        with torch.no_grad():
            for prefill in (False, True):
                with use_sharding(ctx):
                    cache = model.init_cache(B, SERVE_LEN)
                logits, start = [], 0
                mesh.comm_bytes.clear()
                if prefill:
                    prompt = place_batch({"tokens": tokens[:, :SERVE_PROMPT]}, model.cfg,
                                         dataclasses.replace(ctx, mode="train"))
                    lg = build_prefill_step(model, ctx, B, SERVE_LEN)(params, cache, prompt)
                    logits.append(lg[:, 0].numpy())
                    start = SERVE_PROMPT
                for t in range(start, SERVE_STEPS):
                    lg, cache = step(params, cache, place_batch(_serve_tok(tokens, t), model.cfg,
                                                                ctx))
                    logits.append(lg[:, 0].numpy())
                runs[prefill] = np.stack(logits, 1)
        if mesh.rank == 0:   # its data shard's rows, whole over the vocabulary
            tag = _serve_tag(mesh_shape, name, mode, B)
            np.save(os.path.join(out_dir, f"port_{tag}.npy"), runs[False])
            np.save(os.path.join(out_dir, f"prefill_{tag}.npy"), runs[True])


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """The JAX serve steps (one subprocess a mesh and mode, all started at
    once) and, while they work, the port's ranks."""
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    for B in {case[-1] for case in SERVE_CASES}:
        np.save(root / f"tokens_{B}.npy", rng.integers(0, 256, (B, SERVE_STEPS)).astype(np.int32))
    for name, arch in SERVE_FAMILIES:
        params, _ = Model(fp32(arch), "cpu").init(torch.Generator().manual_seed(0))
        np.savez(root / f"init_{name}.npz", **{k: v.numpy() for k, v in params.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    procs = []
    for mesh in ((1, 2), (2, 2)):
        for mode in ("decode", "long"):
            spec = {"len": SERVE_LEN, "steps": SERVE_STEPS, "prompt": SERVE_PROMPT,
                    "suffix": {str(b): f"_batch{b}" for b in range(1, 3)
                               if b != SERVE_BATCH[mode]},
                    "cases": [[list(m), name, arch, md, b] for m, name, arch, md, b in SERVE_CASES
                              if m == mesh and md == mode]}
            procs.append(subprocess.Popen([sys.executable, "-c", JAX_SERVE, str(root),
                                           json.dumps(spec)], stdout=subprocess.DEVNULL,
                                          stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT))
    try:
        for mesh in ((1, 2), (2, 2)):
            cases = [(n, a, mode, b) for m, n, a, mode, b in SERVE_CASES if m == mesh]
            spawn(_serve_ranks, mesh[0] * mesh[1], (str(root), mesh, cases),
                  init_file=str(root / ("store_%dx%d" % mesh)), timeout=600)
        for proc in procs:
            _, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-3000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return root


@pytest.mark.parametrize("mesh,name,arch,mode,batch", SERVE_CASES,
                         ids=[_serve_tag(m, n, mode, b).replace("_", "-", 2)
                              for m, n, _, mode, b in SERVE_CASES])
def test_serve_steps_match_jax_under_the_same_mesh(serve_runs, mesh, name, arch, mode, batch):
    """Every decode step's logits within 2e-5 of JAX's ``build_serve_step``
    jitted with ``cache_shardings`` under the same mesh and mode (rank 0's
    rows: its data shard in decode mode, the whole batch in long mode),
    token by token from an empty cache; and after a prefill of the first
    tokens in train mode moved into the cache's layout, against JAX's
    prefill (its forward in train mode, the cache filled from its K/V)
    and the same steps, or, for the recurrent families, whose JAX forward
    collects no state, against the token-by-token steps.  A decode batch
    of 1 on (2, 2) is whole on every rank (its cache split over 'model'
    alone, JAX's layout), so rank 0's row is the batch."""
    tag = _serve_tag(mesh, name, mode, batch)
    want = np.load(serve_runs / f"jax_{tag}.npy")
    rows = slice(0, want.shape[0] // mesh[0]) if mode == "decode" and batch >= mesh[0] \
        else slice(None)
    got = np.load(serve_runs / f"port_{tag}.npy")
    np.testing.assert_allclose(got, want[rows], **TOL)
    after = np.load(serve_runs / f"prefill_{tag}.npy")
    if (serve_runs / f"jaxprefill_{tag}.npy").exists():     # dense and MoE
        want = np.load(serve_runs / f"jaxprefill_{tag}.npy")
        np.testing.assert_allclose(after, want[rows], **TOL)
    else:
        np.testing.assert_allclose(after, want[rows, SERVE_PROMPT - 1:], **TOL)
