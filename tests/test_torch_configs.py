"""The port's configs equal the JAX package's, and the port stands alone.

``repro_torch`` keeps its own copy of the configs and ``ModelConfig``;
it must import neither ``jax`` nor any module of ``repro``.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import registry  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_configs_equal_reference(arch):
    for mine, ref in ((configs.arch_config(arch), jax_configs.arch_config(arch)),
                      (configs.smoke_config(arch), jax_configs.smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert (mine.hd, mine.q_per_kv) == (ref.hd, ref.q_per_kv)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
        assert str(mine.compute_dtype).removeprefix("torch.") == str(ref.compute_dtype)


def test_registry_equals_reference():
    assert registry.ARCHS == jax_registry.ARCHS
    assert registry.ALIASES == jax_registry.ALIASES
    assert registry.LONG_OK == jax_registry.LONG_OK
    assert [dataclasses.astuple(s) for s in registry.SHAPES] == [
        dataclasses.astuple(s) for s in jax_registry.SHAPES]
    for alias, arch in registry.ALIASES.items():
        assert configs.arch_config(alias) == configs.arch_config(arch)
    for arch in registry.ARCHS:
        assert [s.name for s in registry.input_shapes(arch)] == [
            s.name for s in jax_registry.input_shapes(arch)]


def test_stablelm_full_size():
    """The serve path's model: ~2.8 B params, head_dim 80."""
    cfg = configs.arch_config("stablelm_3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (32, 2560, 32, 32, 80)
    assert 2.7e9 < cfg.param_count() < 2.9e9


def test_port_imports_neither_jax_nor_repro():
    """Import every module of repro_torch in a fresh interpreter."""
    code = """
import pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    __import__(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad, " ".join(names))
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20
    walked = set(out.stdout.split("] ", 1)[1].split())
    assert {"repro_torch.data.pipeline", "repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.train.steps", "repro_torch.checkpoint.store",
            "repro_torch.launch.train", "repro_torch.core.engine",
            "repro_torch.malleability.scenarios", "repro_torch.elastic.trainer",
            "repro_torch.parallel.sharding", "repro_torch.serving.service",
            "repro_torch.launch.serve", "repro_torch.launch.dryrun",
            "repro_torch.launch.dryrun_all", "repro_torch.launch.graph_analysis",
            "repro_torch.launch.specs", "repro_torch.launch.mesh",
            "repro_torch.kernels.abstract"} <= walked


def test_port_sources_name_no_jax_or_repro_import():
    pattern = re.compile(r"^\s*(import jax|from jax|from repro\.|import repro\.|"
                         r"from repro import|import repro\s*$)", re.M)
    files = [REPO / "chip_smoke.py", *sorted((REPO / "src" / "repro_torch").rglob("*.py"))]
    assert len(files) > 20
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
