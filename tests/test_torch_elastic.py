"""The port's elastic runtime and stage 3 against the JAX package's.

The runtime cases mirror ``tests/test_node_group.py`` and
``tests/test_elastic.py`` on the port's classes over fabricated slots.
Stage 3: ``PytreeBytesModel(model).stats(ns, nt)`` must equal the JAX
one byte for byte on four smoke configs for ns, nt in 1..8; the JAX side
runs once in a subprocess with 8 forced host devices (as
``tests/test_reshard.py`` does), so this process keeps seeing one.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import arch_config, smoke_config  # noqa: E402
from repro_torch.core import ShrinkKind, Strategy  # noqa: E402
from repro_torch.elastic import (  # noqa: E402
    DevicePool,
    ElasticRuntime,
    PytreeBytesModel,
    Slot,
    device_slots,
    predicted_transfer_stats,
    reshard_tree,
    transfer_stats,
)
from repro_torch.malleability.scenarios import param_bytes_for_arch  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    NamedSharding,
    ShardingContext,
    mesh_of,
    param_specs,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE3_ARCHS = ("stablelm_3b", "yi_34b", "qwen2_vl_7b", "zamba2_1p2b")
ZEROS = {"bytes_total": 0, "bytes_stayed": 0, "bytes_moved": 0}


def cpu_slots(n):
    return device_slots(n, "cpu")


def make_runtime(n_free=8):
    return ElasticRuntime(pool=DevicePool(devices=cpu_slots(n_free)), initial_nodes=1)


def uneven_pool(widths=(2, 1, 2, 1)):
    return DevicePool(devices=cpu_slots(sum(widths)), node_widths=widths)


# ---------------------------------------------------------------------------
# Slots and pools
# ---------------------------------------------------------------------------


def test_slots_lie_where_asked():
    slots = device_slots(3, "cpu")
    assert [s.id for s in slots] == [0, 1, 2]
    assert all(s.device == torch.device("cpu") for s in slots)
    assert slots[1] == Slot(1, torch.device("cpu"))


def test_slots_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_slots(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePool()


def test_uneven_widths_partition_in_pool_order():
    slots = cpu_slots(6)
    pool = DevicePool(devices=slots, node_widths=(2, 1, 3))
    assert pool.nodes[0] == tuple(slots[0:2]) and pool.nodes[2] == tuple(slots[3:6])
    assert pool.width(2) == 3 and not pool.uniform and pool.total_devices() == 6
    with pytest.raises(ValueError, match="needs 7 devices"):
        DevicePool(devices=cpu_slots(6), node_widths=(2, 2, 3))
    with pytest.raises(ValueError, match="uneven"):
        uneven_pool().devices_per_node


def test_uneven_expand_and_whole_node_release():
    rt = ElasticRuntime(pool=uneven_pool(), strategy=Strategy.PARALLEL_DIFFUSIVE,
                        initial_nodes=1)
    rec = rt.expand(4)
    assert rec.mechanism == "diffusive" and rt.ranks_in_use() == 6
    rec = rt.shrink_nodes([2, 3])
    assert rec.mechanism == "termination_shrinkage" and rec.nodes_returned == (2, 3)
    assert rt.pool.free == {2, 3} and rt.ranks_in_use() == 3


def test_exhaustion_leaks_nothing():
    rt = ElasticRuntime(pool=uneven_pool((2, 1)), strategy=Strategy.PARALLEL_DIFFUSIVE,
                        initial_nodes=1)
    with pytest.raises(RuntimeError, match="exhausted"):
        rt.expand(5)
    assert rt.pool.free == {1}


def test_hypercube_refuses_an_uneven_pool():
    rt = ElasticRuntime(pool=uneven_pool(), initial_nodes=1)
    with pytest.raises(ValueError, match="PARALLEL_DIFFUSIVE"):
        rt.expand(4)


def test_regrow_reuses_lowest_freed_node():
    rt = ElasticRuntime(pool=uneven_pool(), strategy=Strategy.PARALLEL_DIFFUSIVE,
                        initial_nodes=1)
    rt.expand(4)
    rt.shrink_nodes([1, 2])
    assert rt.expand(3).nodes_after == 3
    assert sorted(rt.state.nodes_in_use()) == [0, 1, 3]


def test_fail_and_straggler_are_ts():
    rt = make_runtime()
    rt.expand(4)
    rec = rt.fail_node(3)
    assert (rec.kind, rec.mechanism) == ("fail", ShrinkKind.TS.value)
    assert 3 in rec.nodes_returned and 3 not in rt.state.nodes_in_use()
    rec = rt.drop_straggler(1)
    assert (rec.kind, rec.mechanism) == ("straggler", ShrinkKind.TS.value)
    assert rt.n_nodes == 2


def test_shrink_is_cheap_expand_is_not():
    rt = make_runtime()
    e = rt.expand(8)
    s = rt.shrink(6)
    assert s.est_wall_s < 1e-3 < e.est_wall_s
    assert len(rt.pool.free) == 6


def test_mesh_is_the_live_slots_in_eq9_order():
    slots = cpu_slots(8)
    rt = ElasticRuntime(pool=DevicePool(devices=slots), initial_nodes=1)
    rt.expand(4)
    rt.shrink_nodes([1])
    mesh = rt.mesh()
    assert mesh.axis_names == ("data",) and mesh.shape == (3,)
    assert mesh.devices == (slots[0], slots[2], slots[3])
    assert rt.mesh(("pod", "data"), (1, 3)).axis_sizes() == {"pod": 1, "data": 3}


# ---------------------------------------------------------------------------
# Stage 3
# ---------------------------------------------------------------------------


def test_empty_trees():
    assert transfer_stats({}, {}) == ZEROS
    assert transfer_stats([], []) == ZEROS
    assert predicted_transfer_stats({}, {}, {}) == ZEROS


def test_reshard_records_equal_their_prediction():
    """``tests/test_reshard.py``'s grow and shrink cases: a replicated leaf
    ships a copy to each new slot, a sharded one moves whole; the
    recorded placements' stats equal the shape-only prediction."""
    slots = cpu_slots(4)
    tree = {"replicated": torch.ones(16, 16), "sharded": torch.ones(8, 4)}
    specs = {"replicated": (), "sharded": ("data",)}

    def shardings(k):
        mesh = mesh_of(slots[:k])
        return {n: NamedSharding(mesh, s) for n, s in specs.items()}

    for ns, nt, moved, stayed in ((2, 4, 2 * 1024 + 128, 2 * 1024), (4, 2, 128, 2 * 1024)):
        old = reshard_tree(tree, mesh_of(slots[:ns]), specs)
        new = reshard_tree(tree, mesh_of(slots[:nt]), specs)
        measured = transfer_stats(old, new)
        assert measured == predicted_transfer_stats(tree, shardings(ns), shardings(nt))
        assert (measured["bytes_moved"], measured["bytes_stayed"]) == (moved, stayed)
    # a single spec for every leaf, and None for replicated
    rep = reshard_tree(tree, mesh_of(slots[:2]), None)
    assert all(p.shards[0][1] == ((0, x.shape[0]), (0, x.shape[1]))
               for p, x in zip(rep.values(), tree.values()))


def test_live_runtime_reshard_equals_the_bytes_model():
    """Placements on the runtime's own meshes across an expand and a TS
    shrink equal ``PytreeBytesModel``'s prediction for the resize."""
    model = Model(smoke_config("stablelm_3b"), device="cpu")
    shapes, specs = model.abstract_params()
    rt = make_runtime(4)
    bm = PytreeBytesModel(model)

    def placement():
        ctx = ShardingContext(mesh=rt.mesh())
        return reshard_tree(shapes, ctx.mesh, param_specs(shapes, specs, ctx))

    before = placement()
    rt.expand(4)
    grown = placement()
    assert transfer_stats(before, grown) == bm.stats(1, 4)
    rt.shrink_nodes([1, 2, 3])
    assert transfer_stats(grown, placement()) == bm.stats(4, 1)


WEIGHT_MESHES = tuple((("data",), (k,)) for k in range(1, 9)) + (
    (("data", "model"), (2, 4)), (("pod", "data", "model"), (2, 2, 2)))


@pytest.mark.parametrize("arch", STAGE3_ARCHS)
def test_weight_specs_equal_jax(arch):
    """The port's ``resolve_spec`` gives JAX's ``resolve_spec(..., "weight")``
    for every leaf, on 1-D meshes of 1..8 slots and on 2-D and 3-D ones.
    The JAX side reads only a mesh's axis names and shape, so a stand-in
    mesh serves there."""
    from types import SimpleNamespace

    import numpy as np
    from repro.parallel import sharding as jsh

    shapes, specs = Model(smoke_config(arch), device="cpu").abstract_params()
    for axes, shape in WEIGHT_MESHES:
        mesh = mesh_of(device_slots(int(np.prod(shape)), "meta"), axes, shape)
        got = param_specs(shapes, specs, ShardingContext(mesh=mesh))
        jctx = jsh.ShardingContext(
            mesh=SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=object)))
        want = {k: tuple(jsh.resolve_spec(tuple(specs[k]), tuple(s.shape), jctx, "weight"))
                for k, s in shapes.items()}
        assert got == want, (arch, axes, shape)


JAX_STATS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    from repro.configs import smoke_config
    from repro.elastic import PytreeBytesModel
    from repro.models import Model

    out = {}
    for arch in %r:
        bm = PytreeBytesModel(Model(smoke_config(arch)))
        out[arch] = {"total": bm.total_bytes(1),
                     "stats": [[ns, nt, bm.stats(ns, nt)]
                               for ns in range(1, 9) for nt in range(1, 9)]}
    print("JSON" + json.dumps(out))
""" % (STAGE3_ARCHS,))


@pytest.fixture(scope="module")
def jax_stats():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_STATS], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("JSON"))
    return json.loads(line[4:])


@pytest.mark.parametrize("arch", STAGE3_ARCHS)
def test_bytes_model_equals_jax(jax_stats, arch):
    bm = PytreeBytesModel(Model(smoke_config(arch), device="cpu"))
    want = jax_stats[arch]
    assert bm.total_bytes(1) == want["total"]
    for ns, nt, stats in want["stats"]:
        assert bm.stats(ns, nt) == stats, (arch, ns, nt)
        assert bm(ns, nt) == stats["bytes_moved"]


def test_total_bytes_is_param_bytes_for_arch():
    """At full size, from the shape-only model (nothing is allocated)."""
    bm = PytreeBytesModel(Model(arch_config("stablelm_3b"), device="meta"))
    assert bm.total_bytes(1) == param_bytes_for_arch("stablelm_3b")
    # every leaf splits 4-way, so a 1 -> 4 expand moves the whole pytree
    assert bm.stats(1, 4)["bytes_total"] == param_bytes_for_arch("stablelm_3b")
