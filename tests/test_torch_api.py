"""``repro_torch.api``: the JAX package's stable import surface, resolved
to the port.

The names equal ``repro.api.__all__`` (the 133 of ``API_SNAPSHOT.txt``),
each resolves on the CPU to the port's counterpart, importing the module
loads no ``jax``, nothing of ``repro`` and no kernel and leaves CUDA
uninitialised, and ``param_sharding`` (the one name the port had no
function for) gives the JAX package's shard bounds.
"""
import dataclasses
import enum
import importlib
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel.sharding import Mesh, ShardingContext, param_sharding  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the meshes of tests/test_torch_parallel.py's CASES
MESHES = [(1, 2), (2, 2), (1, 4), (2, 1)]


def test_names_equal_the_jax_surface():
    assert len(api.__all__) == len(set(api.__all__)) == 133
    assert set(api.__all__) == set(jax_api.__all__)
    with open(os.path.join(ROOT, "API_SNAPSHOT.txt")) as f:
        snapshot = {line.strip() for line in f if line.strip() and not line.startswith("#")}
    assert set(api.__all__) == snapshot
    assert set(api._LAZY_EXPORTS) == set(jax_api._LAZY_EXPORTS)
    assert set(dir(api)) >= set(api.__all__)


@pytest.mark.parametrize("name", sorted(jax_api.__all__))
def test_every_name_resolves_to_the_port(name):
    """A lazy name is its module's attribute, under the JAX module's path
    with ``repro.`` -> ``repro_torch.``; an eager one comes from the
    port's copies (``ClusterState`` the RMS-side ledger, as in JAX)."""
    value = getattr(api, name)
    lazy = jax_api._LAZY_EXPORTS.get(name)
    if lazy is not None:
        assert api._LAZY_EXPORTS[name] == lazy.replace("repro.", "repro_torch.", 1)
        assert value is getattr(importlib.import_module(api._LAZY_EXPORTS[name]), name)
    want = getattr(jax_api, name)
    if callable(want):
        assert value.__module__.startswith("repro_torch."), (name, value.__module__)
    else:   # a constant: the same data, in the port's own classes
        assert _plain(value) == _plain(want), name


def _plain(x):
    """``x`` with every dataclass and enum member spelled out by name, so
    the two packages' constants compare."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x).__name__, {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return type(x).__name__, x.name
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def test_cluster_state_is_the_rms_ledger():
    from repro_torch.malleability.policies import ClusterState

    assert api.ClusterState is ClusterState


def test_unknown_names_raise():
    with pytest.raises(AttributeError, match="no attribute"):
        api.not_a_name  # noqa: B018


def test_import_loads_no_jax_no_repro_no_kernel_and_leaves_cuda_alone():
    code = textwrap.dedent("""
        import sys
        import torch
        import repro_torch.api as api
        loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                        or m == "repro" or m.startswith("repro.")
                        or m.startswith("repro_torch.kernels"))
        assert not loaded, loaded
        assert not torch.cuda.is_initialized()
        assert len(api.__all__) == 133
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


JAX_BOUNDS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import smoke_config
    from repro.models import Model
    from repro.parallel.sharding import ShardingContext, param_sharding

    params, specs = Model(smoke_config("stablelm_3b")).init(jax.random.key(0))
    out = {}
    for D, M in json.loads(sys.argv[1]):
        devices = np.array(jax.devices()[:D * M]).reshape(D, M)
        ctx = ShardingContext(mesh=Mesh(devices, ("data", "model")))
        order = list(devices.flat)
        out[f"{D}x{M}"] = {
            k: [[list(s.indices(n)[:2]) for s, n in zip(sh.devices_indices_map(params[k].shape)[d],
                                                       params[k].shape)] for d in order]
            for k, sh in param_sharding(params, specs, ctx).items()}
    print(json.dumps(out))
""")


def test_param_sharding_gives_jax_shard_bounds():
    """stablelm's smoke params on each mesh: every slot's block of every
    param equals the block JAX's ``param_sharding`` gives the device at
    the same place of the mesh."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_BOUNDS, json.dumps(MESHES)],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    params, specs = Model(smoke_config("stablelm_3b"), "cpu").init(torch.Generator().manual_seed(0))
    split = False
    for shape in MESHES:
        ctx = ShardingContext(mesh=Mesh(tuple(range(math.prod(shape))), ("data", "model"), shape))
        got = param_sharding(params, specs, ctx)
        assert sorted(got) == sorted(want["%dx%d" % shape])
        for k, sh in got.items():
            dims = tuple(params[k].shape)
            bounds = [[list(s.indices(n)[:2]) for s, n in zip(sh.devices_indices_map(dims)[slot],
                                                              dims)]
                      for slot in ctx.mesh.devices]
            assert bounds == want["%dx%d" % shape][k], (shape, k)
            split = split or any(b - a < n for (a, b), n in zip(bounds[0], dims))
    assert split    # the meshes cut some param
