"""The port's elastic serving plane (``repro_torch.serving``) on the CPU.

Each test of ``tests/test_serving.py`` runs here against the port's copy,
with the same assertions: paged KV-cache parity (predicted == measured
migration), continuous-batching invariants under random interleavings,
the registered serve traces replayed on both executors, and the
ElasticTrainer loop on every serve trace (the port's, in process).  Then
the port is held to the JAX package itself: page bytes for every arch,
``serve_parity_key`` for every serve trace on the simulator and the live
runtime (its slots on the CPU here), and the CLI's report lines.  The
service runs no model, so nothing here needs a card; without one, the
live executor's default device raises (``tests/test_torch_serve.py``).
"""
import contextlib
import io

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro import malleability as jax_mall  # noqa: E402
from repro import serving as jax_serving  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.launch import serve as jax_serve_cli  # noqa: E402
from repro_torch.configs import arch_config, smoke_config  # noqa: E402
from repro_torch.core import ReconfigEngine  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.malleability import (  # noqa: E402
    MN5,
    ThroughputModel,
    get_scenario,
    record_parity_key,
    registered_scenarios,
    run_scenario_live,
    run_scenario_sim,
)
from repro_torch.malleability.policies import SERVE_SCENARIO_NAMES, SERVE_TRAFFIC  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.transformer import init_cache_shapes  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatcher,
    KVBytesModel,
    KVPageTable,
    PageSpec,
    Request,
    ServeConfig,
    check_serve_agreement,
    page_bytes_for_arch,
    run_serve,
    serve_config,
    serve_parity_key,
)

SPEC = PageSpec(page_tokens=16, page_bytes=1024)
CPU = "cpu"
# TPU-class constants on both sides (the port's ThroughputModel defaults
# are the H100's), as tests/test_torch_control_plane.py passes them.
HW = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)


def make_table(workers=2, pages_per_worker=8, **kw):
    return KVPageTable(SPEC, range(workers), pages_per_worker, **kw)


# ============================================================ page table ==
class TestPageGeometry:
    def test_pages_for_rounds_up(self):
        assert SPEC.pages_for(1) == 1
        assert SPEC.pages_for(16) == 1
        assert SPEC.pages_for(17) == 2
        assert SPEC.pages_for(0) == 1          # every request holds a page

    def test_bad_geometry_rejected(self):
        with pytest.raises(ValueError):
            PageSpec(page_tokens=0, page_bytes=1024)
        with pytest.raises(ValueError):
            PageSpec(page_tokens=16, page_bytes=0)

    def test_page_bytes_for_arch_is_real_cache_bytes(self):
        pb = page_bytes_for_arch("xlstm_125m", 16)
        assert pb > 0
        # deterministic (lru_cache or not, same inputs -> same bytes)
        assert pb == page_bytes_for_arch("xlstm_125m", 16)


class TestAllocation:
    def test_allocate_append_free_roundtrip(self):
        t = make_table()
        t.allocate(0, 2, worker=1)
        assert t.request_worker(0) == 1
        assert t.used_pages(1) == 2 and t.free_pages(1) == 6
        t.append_page(0)
        assert len(t.request_pages(0)) == 3
        assert t.request_bytes(0) == 3 * SPEC.page_bytes
        assert t.free_request(0) == 3
        assert t.total_pages() == 0
        assert t.pages_allocated == t.pages_freed == 3

    def test_allocation_errors(self):
        t = make_table()
        t.allocate(0, 1, worker=0)
        with pytest.raises(ValueError):
            t.allocate(0, 1, worker=0)          # duplicate rid
        with pytest.raises(KeyError):
            t.allocate(1, 1, worker=9)          # unknown worker
        with pytest.raises(ValueError):
            t.allocate(1, 0, worker=0)          # no pages

    def test_capacity_overrides(self):
        t = KVPageTable(SPEC, range(2), 8, capacities={1: 3})
        assert t.capacity(0) == 8 and t.capacity(1) == 3
        with pytest.raises(ValueError):
            KVPageTable(SPEC, range(2), 8, capacities={0: 0})


# ===================================== predicted == measured migration ==
class TestResizeParity:
    """``predicted_resize_stats`` (pure, from the plan) equals
    ``apply_resize().stats`` (measured from the page->worker diff), byte
    for byte, for every resize shape."""

    def loaded_table(self, **kw):
        t = make_table(workers=2, **kw)
        t.allocate(0, 3, worker=0)
        t.allocate(1, 2, worker=0)
        t.allocate(2, 1, worker=1)
        return t

    def check(self, table, workers_after):
        predicted = table.predicted_resize_stats(workers_after)
        result = table.apply_resize(workers_after)
        assert result.stats == predicted, (predicted, result.stats)
        stats = result.stats
        assert stats["bytes_total"] == stats["bytes_stayed"] + stats["bytes_moved"]
        assert table.worker_ids() == tuple(sorted(workers_after))
        return result

    def test_grow_parity_and_fresh_only_moves(self):
        t = self.loaded_table()
        res = self.check(t, range(4))
        assert res.added == (2, 3)
        for _rid, _src, dst in res.moves:
            assert dst in (2, 3)               # survivors untouched on grow

    def test_shrink_parity_and_clean_eviction(self):
        t = self.loaded_table()
        res = self.check(t, [0])
        assert res.evicted == (1,)
        assert t.used_pages(0) == 6            # everything landed on 0
        assert res.stats["bytes_moved"] == 1 * SPEC.page_bytes

    def test_uneven_capacities_parity(self):
        t = self.loaded_table(capacities={0: 20, 1: 4})
        self.check(t, range(4))
        t2 = self.loaded_table(capacities={0: 20, 1: 4})
        self.check(t2, [1])

    def test_plan_is_deterministic(self):
        t = self.loaded_table()
        assert t.plan_resize(range(4)) == t.plan_resize(range(4))

    def test_slot_limit_caps_fresh_workers(self):
        t = make_table(workers=1, slot_limit=1)
        for rid in range(4):
            t.allocate(rid, 2, worker=0)
        res = t.apply_resize(range(3))
        landed = {}
        for _rid, _src, dst in res.moves:
            landed[dst] = landed.get(dst, 0) + 1
        assert all(n <= 1 for w, n in landed.items() if w in res.added)

    def test_empty_target_rejected(self):
        with pytest.raises(ValueError):
            self.loaded_table().plan_resize([])


# ================================================== engine bytes model ==
class TestKVBytesModel:
    def test_noop_and_degenerate_resizes_are_free(self):
        m = KVBytesModel(make_table())
        zeros = {"bytes_total": 0, "bytes_stayed": 0, "bytes_moved": 0}
        assert m.stats(2, 2) == zeros
        assert m.stats(0, 4) == zeros
        assert m(2, 2) == zeros

    def test_prefix_contract_enforced(self):
        t = KVPageTable(SPEC, [0, 2], 8)     # hole in the worker range
        with pytest.raises(ValueError, match="prefix"):
            KVBytesModel(t).stats(2, 4)
        with pytest.raises(ValueError, match="width"):
            KVBytesModel(make_table(), width=2).stats(3, 4)

    def test_stats_match_table_prediction(self):
        t = make_table()
        t.allocate(0, 3, worker=0)
        t.allocate(1, 2, worker=1)
        m = KVBytesModel(t)
        assert m.stats(2, 4) == t.predicted_resize_stats(range(4))
        assert m.stats(2, 1) == t.predicted_resize_stats(range(1))

    def test_engine_charges_the_table_bytes(self):
        """A ReconfigEngine with the KV bytes model prices a pool resize
        from the actual resident pages."""
        t = make_table()
        t.allocate(0, 3, worker=0)
        t.allocate(1, 2, worker=1)
        engine = ReconfigEngine(cost_model=MN5, bytes_model=KVBytesModel(t))
        predicted = t.predicted_resize_stats(range(1))
        stayed, moved = engine.redistribution_stats(2, 1)
        assert (stayed, moved) == (predicted["bytes_stayed"], predicted["bytes_moved"])


# ============================================== batching: random walks ==
SIZES = (1, 2, 3, 4, 6, 8)


def drive(batcher, ops):
    """Replay (op, arg) pairs; check invariants after every operation."""
    rid = step = 0
    for op, arg in ops:
        if op == 0:                                    # arrival
            batcher.submit(Request(rid=rid, arrival_step=step,
                                   prompt_tokens=1 + 3 * arg, gen_tokens=1 + arg))
            rid += 1
        elif op == 1:                                  # pool resize
            batcher.resize(range(SIZES[arg % len(SIZES)]), step)
        else:                                          # serve one step
            batcher.admit(step)
            batcher.decode(step)
        batcher.check_invariants()
        step += 1
    return rid, step


def drain(batcher, step, limit=600):
    for _ in range(limit):
        if not batcher.in_flight():
            return True
        batcher.admit(step)
        batcher.decode(step)
        batcher.check_invariants()
        step += 1
    return False


class TestBatcherProperties:
    """Random arrival/decode/resize interleavings: nothing is ever dropped
    or duplicated, and the page ledger balances at drain."""

    @settings(max_examples=40, deadline=None)
    @given(ops=st.lists(
        st.tuples(st.integers(min_value=0, max_value=2),
                  st.integers(min_value=0, max_value=7)),
        min_size=1, max_size=60))
    def test_interleavings_never_drop_or_duplicate(self, ops):
        table = make_table(workers=2, slot_limit=3)
        b = ContinuousBatcher(table, slots_per_worker=3)
        submitted, step = drive(b, ops)
        assert drain(b, step), "batcher failed to drain"
        assert b.dropped == 0
        assert set(b.completed) == set(range(submitted))
        assert table.total_pages() == 0
        assert table.pages_allocated == table.pages_freed

    @settings(max_examples=25, deadline=None)
    @given(ops=st.lists(
        st.tuples(st.integers(min_value=0, max_value=2),
                  st.integers(min_value=0, max_value=7)),
        min_size=1, max_size=40),
        n_after=st.sampled_from(SIZES))
    def test_resize_preserves_in_flight_and_progress(self, ops, n_after):
        table = make_table(workers=2, slot_limit=3)
        b = ContinuousBatcher(table, slots_per_worker=3)
        _, step = drive(b, ops)
        flight_before = b.in_flight()
        progress_before = dict(b.progress)
        b.resize(range(n_after), step)
        b.check_invariants()
        assert b.in_flight() == flight_before
        for rid, done in progress_before.items():
            assert b.progress.get(rid, done) == done   # nothing restarted

    def test_requeued_request_readmits_where_its_pages_are(self):
        """A resize survivor sent back to the queue re-admits only on the
        worker holding its pages: re-admission moves zero bytes."""
        table = make_table(workers=2, slot_limit=1)
        b = ContinuousBatcher(table, slots_per_worker=1)
        for rid in range(2):
            b.submit(Request(rid, 0, prompt_tokens=8, gen_tokens=6))
        b.admit(0)
        assert len(b.active) == 2              # one slot on each worker
        b.resize([0], 0)                       # both now hold pages on 0
        b.check_invariants()
        assert b.requeued >= 1 and b.dropped == 0
        queued = list(b.queue)
        assert queued
        allocated_before = table.pages_allocated
        b.admit(1)
        assert table.pages_allocated == allocated_before
        for rid in queued:
            if rid in b.active:
                assert b.active[rid] == table.request_worker(rid) == 0

    def test_head_of_line_blocking_is_fair(self):
        """When the oldest waiting request cannot be placed, nothing behind
        it jumps the queue."""
        table = make_table(workers=1, pages_per_worker=4)
        b = ContinuousBatcher(table, slots_per_worker=4)
        b.submit(Request(0, 0, prompt_tokens=64, gen_tokens=1))   # 4 pages
        b.submit(Request(1, 0, prompt_tokens=64, gen_tokens=1))   # blocked
        b.submit(Request(2, 0, prompt_tokens=1, gen_tokens=1))    # would fit
        assert b.admit(0) == [0]
        assert list(b.queue) == [1, 2]          # 2 did not overtake 1


# ================================================== the serve traces ==
class TestServeTraces:
    def test_traces_are_registered_scenarios(self):
        names = {s.name for s in registered_scenarios()}
        assert set(SERVE_SCENARIO_NAMES) <= names
        assert set(SERVE_SCENARIO_NAMES) == set(SERVE_TRAFFIC)

    @pytest.mark.parametrize("name", SERVE_SCENARIO_NAMES)
    def test_scenario_machinery_sim_live_parity(self, name):
        """As plain scenarios (nominal bytes model) the serve traces
        already agree per event on both scenario executors."""
        sc = get_scenario(name)
        sim = run_scenario_sim(sc)
        live = run_scenario_live(sc)
        assert len(sim) >= 2, "serve trace must actually reconfigure"
        assert [record_parity_key(r) for r in sim] == [record_parity_key(r) for r in live]

    @pytest.mark.parametrize("name", SERVE_SCENARIO_NAMES)
    def test_zero_drop_pinned(self, name):
        """No serve trace drops an in-flight request across any resize,
        and every page is returned at drain."""
        rep = run_serve(name)
        assert rep.dropped == 0
        assert rep.submitted == rep.completed > 0
        assert len(rep.records) >= 2
        assert rep.migrated + rep.requeued > 0   # resizes hit live requests
        assert rep.bytes_moved > 0               # ...and moved their KV
        assert len(rep.latencies) == rep.completed
        assert rep.downtime_s == sum(r.downtime_s for r in rep.records)

    @pytest.mark.parametrize("name", SERVE_SCENARIO_NAMES)
    def test_sim_equals_live_on_every_number(self, name):
        sim = run_serve(name, executor="sim")
        live = run_serve(name, executor="live", device=CPU)
        assert serve_parity_key(sim) == serve_parity_key(live)

    def test_check_serve_agreement_is_clean(self):
        assert check_serve_agreement(device=CPU) == 0

    def test_trace_specific_pricing(self):
        """The knobs that make each trace distinct actually bite."""
        flash = run_serve("serve-flashcrowd")
        assert flash.bytes_cross_rack > 0        # burst grow pays off-rack
        diurnal = run_serve("serve-diurnal")
        assert diurnal.bytes_cross_rack == 0     # no topology, no split
        slo = run_serve("serve-slo")
        assert slo.queued_s > 0                  # delayed grants are queued

    def test_phases_cover_the_run(self):
        rep = run_serve("serve-diurnal")
        assert rep.phases[0].start_step == 0
        for a, b in zip(rep.phases, rep.phases[1:]):
            assert a.end_step == b.start_step
        assert sum(p.completed for p in rep.phases) == rep.completed
        workers = [p.workers for p in rep.phases]
        assert max(workers) == 8 and workers[0] == workers[-1] == 2

    def test_unknown_trace_rejected(self):
        with pytest.raises(KeyError):
            run_serve("no-such-trace")
        with pytest.raises(KeyError, match="traffic"):
            run_serve("steady-cycle")            # registered, but not serve

    def test_bad_executor_rejected(self):
        with pytest.raises(ValueError, match="executor"):
            run_serve("serve-diurnal", executor="quantum")

    def test_serve_config_tracks_the_policy(self):
        for name in SERVE_SCENARIO_NAMES:
            cfg = serve_config(name)
            pol = SERVE_TRAFFIC[name]
            assert cfg.slots_per_worker == pol.slots_per_worker
            assert cfg.gen_tokens == pol.hold_steps - 2

    def test_launch_driver_agrees_and_prints_phases(self, capsys):
        """The serve entry point replays sim + live and exits 0 only when
        every number matches."""
        assert serve_cli.run_elastic(("serve-diurnal",), "both", None, CPU) == 0
        out = capsys.readouterr().out
        assert "sim == live: OK" in out
        assert "total: wall" in out
        assert serve_cli.main(["--scenario", "serve-slo", "--executor", "sim"]) == 0
        assert "queued" in capsys.readouterr().out


def test_trainer_loop_matches_serve_simulator():
    """The port's ElasticTrainer on every serve trace (xlstm_125m's smoke
    config, batch 8 x 32 on the CPU): its runtime history carries exactly
    the simulator's per-event downtimes, queue spans and bytes,
    ``bytes_cross_rack`` included, with finite losses.  One intra-op
    thread: the steps are small ops, which torch's thread pool slows
    ~80x when the suite's other workers hold every core."""
    from repro_torch.elastic import ElasticTrainer

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run_trainer_on_serve_traces(ElasticTrainer, Model(smoke_config("xlstm_125m"), device=CPU))
    finally:
        torch.set_num_threads(threads)


def run_trainer_on_serve_traces(ElasticTrainer, model):
    for name in SERVE_SCENARIO_NAMES:
        sc = get_scenario(name)
        sim = run_scenario_sim(sc)
        tr = ElasticTrainer.from_scenario(model, sc, batch=8, seq=32)
        tr.run(sc.steps)
        live = tr.runtime.history
        assert len(live) == len(sim), (name, len(live), len(sim))
        for s, lv in zip(sim, live):
            assert lv.downtime_s == s.downtime_s, (name, s, lv)
            assert lv.est_wall_s == s.est_wall_s, (name, s, lv)
            assert lv.queued_s == s.queued_s, (name, s, lv)
            assert (lv.bytes_moved, lv.bytes_stayed) == (s.bytes_moved, s.bytes_stayed)
            assert lv.bytes_cross_rack == s.bytes_cross_rack, (name, s, lv)
            assert (lv.nodes_before, lv.nodes_after) == (s.nodes_before, s.nodes_after)
        assert np.isfinite(np.array(tr.losses())).all(), name


# ====================================== the port against the JAX package ==
@pytest.mark.parametrize("arch", ARCHS)
def test_page_bytes_equal_jax(arch):
    """The port's page bytes (item sizes from torch) equal the JAX
    package's (from numpy) for every arch: at 16 tokens, at a batch > 1,
    and for gemma2 past its window, where the local layers' rings start."""
    for page_tokens, batch in ((16, 1), (16, 3), (4096, 1), (4097, 2)):
        assert page_bytes_for_arch(arch, page_tokens, batch) == \
            jax_serving.page_bytes_for_arch(arch, page_tokens, batch), (arch, page_tokens, batch)


def test_gemma2_page_has_no_ring_below_the_window():
    """At 16 tokens, far below gemma2's 4096 window, neither package gives
    its local layers a ring: the page slices k / v of every layer."""
    cfg = arch_config("gemma2_9b")
    shapes = init_cache_shapes(cfg, 1, 16)
    assert set(shapes) == {"k", "v"}
    assert shapes["k"][0] == (cfg.n_layers, 1, 16, cfg.n_kv_heads, cfg.hd)
    assert page_bytes_for_arch("gemma2_9b", 16) == 2 * 42 * 16 * 8 * 256 * 2
    assert set(init_cache_shapes(cfg, 1, 4097)) == {"k_loc", "v_loc", "k", "v"}


@pytest.mark.parametrize("name", SERVE_SCENARIO_NAMES)
def test_serve_parity_key_equals_jax(name):
    """Each serve trace replays to the JAX package's report, every number:
    the port's simulator and its live runtime (slots on the CPU) against
    the JAX simulator and live runtime."""
    want_sim = jax_serving.serve_parity_key(jax_serving.run_serve(name, executor="sim"))
    want_live = jax_serving.serve_parity_key(jax_serving.run_serve(name, executor="live"))
    assert want_sim == want_live
    assert serve_parity_key(run_serve(name, executor="sim")) == want_sim
    assert serve_parity_key(run_serve(name, executor="live", device=CPU)) == want_live


@pytest.mark.parametrize("name", SERVE_SCENARIO_NAMES)
def test_modelled_step_times_equal_jax(name):
    """With a ThroughputModel pricing each step for its worker count
    (equal explicit constants on both sides), the port's replay still
    equals the JAX package's."""
    kw = dict(flops_per_token=1.5e9, param_bytes=10**9, **HW)
    cfg = ServeConfig(**{**serve_config(name).__dict__, "throughput": ThroughputModel(**kw)})
    jcfg = jax_serving.ServeConfig(**{**jax_serving.serve_config(name).__dict__,
                                      "throughput": jax_mall.ThroughputModel(**kw)})
    got = run_serve(name, executor="live", config=cfg, device=CPU)
    want = jax_serving.run_serve(name, executor="live", config=jcfg)
    assert serve_parity_key(got) == jax_serving.serve_parity_key(want)
    assert got.wall_s != run_serve(name).wall_s     # the model changed the pricing


def test_cli_prints_the_jax_report():
    """``python -m repro_torch.launch.serve --device cpu`` (every serve
    trace, both executors) returns 0 and prints the JAX driver's lines."""
    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue()

    rc, out = run(serve_cli.main, ["--device", "cpu", "--scenario", "all"])
    want_rc, want = run(jax_serve_cli.main, ["--scenario", "all"])
    assert rc == want_rc == 0
    assert out == want
    assert out.count("sim == live: OK") == len(SERVE_SCENARIO_NAMES)
