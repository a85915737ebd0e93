"""The port's copy of the control plane against the JAX package's.

``repro_torch.core`` and ``repro_torch.malleability`` are copies of
``repro.core`` and ``repro.malleability`` (plain Python and numpy); the
copies must register the same strategies and scenarios in the same
order, and charge every scenario x strategy pair that
``scripts/check_matrix.py`` runs to the same records, compared through
``record_parity_key``.  The three functions that differ — the pytree
sizes from the port's shape-only model, the FLOPs from its configs, and
the H100 defaults of ``ThroughputModel`` — are held equal where they
must be, with equal explicit constants where the defaults differ.
"""
import pytest

pytest.importorskip("torch")

from repro import core as jax_core  # noqa: E402
from repro import malleability as jax_mall  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro_torch import core, malleability  # noqa: E402
from repro_torch.malleability import scenarios as port_scenarios  # noqa: E402
from repro_torch.malleability import throughput as port_throughput  # noqa: E402

SCENARIOS = [sc.name for sc in jax_mall.registered_scenarios()]
# TPU-class constants in both packages (the port's defaults are the H100's).
HW = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)


def pairs(mall, core_mod, name):
    """(scenario, strategy key) pairs of one scenario, as check_matrix
    walks them (homogeneous-only strategies skip uneven pools)."""
    sc = mall.get_scenario(name)
    return sc, [spec.key for spec in core_mod.registered_strategies()
                if not (spec.homogeneous_only and sc.heterogeneous)]


def keys(mall, recs):
    return [mall.record_parity_key(r) for r in recs]


def test_registries_are_equal():
    assert ([s.key for s in core.registered_strategies()]
            == [s.key for s in jax_core.registered_strategies()])
    assert ([s.name for s in malleability.registered_scenarios()]
            == [s.name for s in jax_mall.registered_scenarios()])
    assert len(SCENARIOS) == 22


def test_the_matrix_has_150_pairs():
    n = sum(len(pairs(malleability, core, name)[1]) for name in SCENARIOS)
    assert n == 150


@pytest.mark.parametrize("name", SCENARIOS)
def test_sim_records_equal_jax(name):
    sc, strategies = pairs(malleability, core, name)
    jsc, jstrategies = pairs(jax_mall, jax_core, name)
    assert strategies == jstrategies
    port_tp = malleability.ThroughputModel(flops_per_token=1.5e9, param_bytes=10**9, **HW)
    jax_tp = jax_mall.ThroughputModel(flops_per_token=1.5e9, param_bytes=10**9, **HW)
    for key in strategies:
        got = malleability.run_scenario_sim(sc, engine=sc.default_engine(strategy=key))
        want = jax_mall.run_scenario_sim(jsc, engine=jsc.default_engine(strategy=key))
        assert got, (name, key)
        assert keys(malleability, got) == keys(jax_mall, want), (name, key)
        got = malleability.run_scenario_sim(sc, engine=sc.default_engine(strategy=key),
                                            throughput=port_tp)
        want = jax_mall.run_scenario_sim(jsc, engine=jsc.default_engine(strategy=key),
                                         throughput=jax_tp)
        assert keys(malleability, got) == keys(jax_mall, want), (name, key, "throughput")


@pytest.mark.parametrize("name", SCENARIOS)
def test_vectorized_and_live_equal_the_ports_sim(name):
    """The port's other two executors, the live one on its own runtime
    over fabricated slots, against its sim."""
    sc, strategies = pairs(malleability, core, name)
    tp = malleability.ThroughputModel(flops_per_token=1.5e9, param_bytes=10**9, **HW)
    for key in strategies:
        for throughput in (None, tp):
            eng = sc.default_engine(strategy=key)
            sim = keys(malleability, malleability.run_scenario_sim(
                sc, engine=eng, throughput=throughput))
            vec = keys(malleability, malleability.run_scenario_vectorized(
                sc, engine=eng, throughput=throughput))
            live = keys(malleability, malleability.run_scenario_live(
                sc, engine=eng, throughput=throughput))
            assert vec == sim, (name, key, throughput)
            assert live == sim, (name, key, throughput)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_flop_counts_equal_jax(arch):
    from repro.malleability import scenarios as jax_scenarios
    from repro.malleability import throughput as jax_throughput

    assert (port_scenarios.param_bytes_for_arch(arch)
            == jax_scenarios.param_bytes_for_arch(arch))
    assert (port_throughput.flops_per_token_for_arch(arch)
            == jax_throughput.flops_per_token_for_arch(arch))


def test_throughput_defaults_are_the_h100_data_sheet():
    tp = malleability.ThroughputModel()
    assert (tp.peak_flops, tp.hbm_bw, tp.ici_bw) == (989e12, 3.35e12, 450e9)
    # everything else is the reference's
    jtp = jax_mall.ThroughputModel()
    assert tp.global_batch == jtp.global_batch and tp.seq_len == jtp.seq_len


def test_shape_only_params_equal_jax_abstract_params():
    """The port's shape-only path against ``jax.eval_shape``: keys,
    shapes, dtypes and logical axes, for every family (moe included)."""
    import numpy as np

    from repro.models import Model as JaxModel
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import abstract_params
    from repro.configs import smoke_config as jax_smoke_config

    for arch in ARCHS:
        shapes, specs = abstract_params(smoke_config(arch))
        jshapes, jspecs = JaxModel(jax_smoke_config(arch)).abstract_params()
        assert sorted(shapes) == sorted(jshapes), arch
        for k, s in shapes.items():
            assert s.shape == tuple(jshapes[k].shape), (arch, k)
            assert s.nbytes == int(np.prod(jshapes[k].shape)) * jshapes[k].dtype.itemsize
            assert tuple(specs[k]) == tuple(jspecs[k]) == s.axes, (arch, k)
