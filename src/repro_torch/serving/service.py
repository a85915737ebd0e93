"""The elastic decode service: traffic in, priced reconfigurations out.

:func:`run_serve` replays a registered serve trace end to end:

* the **requests** come from the same rate trace the
  :class:`~repro_torch.malleability.policies.TrafficPolicy` sized the pool
  from (``SERVE_TRAFFIC`` — single-sourced, so the autoscaler and the
  service always see the same load);
* the **resizes** are the trace's scenario events, dispatched through
  the exact machinery every other consumer uses
  (:func:`~repro_torch.malleability.scenarios.dispatch_event` over either the
  device-free ``_SimCluster`` or the live
  :class:`~repro_torch.elastic.ElasticRuntime`), with the engine's bytes
  model swapped for the live :class:`~repro_torch.serving.kv_cache
  .KVBytesModel` — so each resize is priced from the **actual resident
  KV pages** at that moment;
* on every resize the loop asserts the three-way byte parity —
  engine-charged == predicted == measured page migration — and the
  prefix-range worker contract, then lets the
  :class:`~repro_torch.serving.batching.ContinuousBatcher` drain-and-remap
  (zero dropped requests, by construction and by assertion);
* serving time advances ``step_time_s`` per step plus each resize's
  charged ``downtime_s``, so request latency feels reconfiguration
  stalls exactly as the timeline priced them.

Because every input is deterministic, a sim run and a live run of the
same trace produce **identical** :class:`ServeReport`\\ s — per-event
records, per-request latencies, throughput, downtime — which
:func:`serve_parity_key` pins (the serving analog of
:func:`~repro_torch.malleability.scenarios.record_parity_key`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.malleability.policies import SERVE_TRAFFIC
from repro_torch.malleability.throughput import ThroughputModel
from repro_torch.malleability.scenarios import (
    Scenario,
    ScenarioRecord,
    _dispatch,
    _SimCluster,
    get_scenario,
    record_parity_key,
    scenario_pool,
)

from .batching import ContinuousBatcher, Request
from .kv_cache import KVBytesModel, KVPageTable, PageSpec, page_bytes_for_arch

EXECUTORS = ("sim", "live")


@dataclass(frozen=True)
class ServeConfig:
    """Knobs of the decode service (defaults match the traffic policy).

    ``gen_spread`` staggers generation lengths (request ``rid`` decodes
    ``gen_tokens + rid % gen_spread`` tokens) so completions don't all
    land on the same step; ``page_bytes`` overrides the
    ``init_cache``-derived page size when nonzero (unit tests price
    round numbers, the real service prices the model's actual cache).

    ``throughput`` replaces the flat ``step_time_s`` with the modeled
    per-allocation decode step time
    (:class:`~repro_torch.malleability.throughput.ThroughputModel`): each
    step is priced for the worker count actually serving it, so a
    scale-down cheap on migration bytes still pays its slower steps in
    every latency and throughput number.  ``None`` (the default) keeps
    the historical constant bit for bit.
    """

    arch: str = "xlstm_125m"        # model whose KV cache the pages slice
    page_tokens: int = 16
    page_bytes: int = 0             # 0 -> derive from arch via init_cache
    pages_per_worker: int = 24
    slots_per_worker: int = 5
    prompt_tokens: int = 24
    gen_tokens: int = 8
    gen_spread: int = 3
    step_time_s: float = 0.05
    max_drain_steps: int = 2000
    throughput: Optional[ThroughputModel] = None

    def resolved_step_time_s(self, workers: int = 0) -> float:
        """Seconds per decode step on ``workers`` nodes: modeled when a
        ``throughput`` model and a real worker count are given, the flat
        ``step_time_s`` otherwise.
        """
        if self.throughput is None or workers <= 0:
            return self.step_time_s
        return self.throughput.step_time(self.throughput.widths_for(workers))

    def page_spec(self) -> PageSpec:
        pb = self.page_bytes or page_bytes_for_arch(self.arch,
                                                    self.page_tokens)
        return PageSpec(page_tokens=self.page_tokens, page_bytes=pb)

    def request_for(self, rid: int, step: int) -> Request:
        gen = self.gen_tokens + (rid % self.gen_spread if self.gen_spread > 1
                                 else 0)
        return Request(rid=rid, arrival_step=step,
                       prompt_tokens=self.prompt_tokens, gen_tokens=gen)


def serve_config(name: str) -> ServeConfig:
    """The config a registered serve trace runs with.

    ``slots_per_worker`` / ``gen_tokens`` are taken from the trace's
    :class:`~repro_torch.malleability.policies.TrafficPolicy` so the service
    honors the capacity model the autoscaler planned with (one request
    holds a slot for roughly ``hold_steps`` steps at one token/step).
    """
    pol = SERVE_TRAFFIC[name]
    return ServeConfig(slots_per_worker=pol.slots_per_worker,
                       gen_tokens=pol.hold_steps - 2, gen_spread=3)


@dataclass(frozen=True)
class ServePhase:
    """One steady allocation span between resizes."""

    start_step: int
    end_step: int                   # exclusive
    workers: int
    completed: int
    p50_latency_s: float
    throughput_tok_s: float


@dataclass(frozen=True)
class ServeReport:
    """Everything one serve replay produced (deterministic per trace)."""

    scenario: str
    executor: str
    records: Tuple[ScenarioRecord, ...]
    latencies: Tuple[float, ...]    # per completed request, in rid order
    phases: Tuple[ServePhase, ...]
    wall_s: float
    downtime_s: float
    queued_s: float
    bytes_moved: int
    bytes_cross_rack: int
    tokens_decoded: int
    submitted: int
    completed: int
    migrated: int                   # resize survivors that kept decoding
    requeued: int                   # resize survivors sent back to the queue
    dropped: int                    # MUST be 0 (asserted before reporting)

    @property
    def p50_latency_s(self) -> float:
        return _percentile(self.latencies, 0.50)

    @property
    def p99_latency_s(self) -> float:
        return _percentile(self.latencies, 0.99)

    @property
    def throughput_tok_s(self) -> float:
        return self.tokens_decoded / self.wall_s if self.wall_s > 0 else 0.0


def _percentile(values: Tuple[float, ...], q: float) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


def serve_parity_key(report: ServeReport) -> tuple:
    """THE canonical serve-replay parity tuple for sim == live checks.

    Extends :func:`~repro_torch.malleability.scenarios.record_parity_key` (one
    entry per reconfiguration) with the serving-side outcomes: request
    latencies, token counts, migration/requeue tallies, and the wall
    clock.  Two executors replaying the same trace must match on ALL of
    it — the numbers are produced by identical arithmetic on identical
    state, so the comparison is exact, not approximate.
    """
    return (
        report.scenario,
        tuple(record_parity_key(r) for r in report.records),
        report.latencies,
        report.wall_s,
        report.downtime_s,
        report.queued_s,
        report.bytes_moved,
        report.bytes_cross_rack,
        report.tokens_decoded,
        report.submitted,
        report.completed,
        report.migrated,
        report.requeued,
        report.dropped,
    )


class _ByteParityError(AssertionError):
    """A resize's charged, predicted, and measured bytes disagreed."""


def _serve_cluster_for(scenario: Scenario, engine, executor: str, device=None):
    if executor == "sim":
        return _SimCluster(scenario=scenario, engine=engine)
    if executor == "live":
        from repro_torch.elastic.node_group import device_slots
        from repro_torch.elastic.runtime import ElasticRuntime

        from repro_torch.malleability.scenarios import RuntimeAdapter

        # The pool's slots are logical, all on one device (the card unless
        # the caller names the CPU), as ElasticTrainer.from_scenario builds it.
        need = (sum(scenario.core_pool) if scenario.core_pool
                else scenario.pool_nodes() * scenario.cores_per_node)
        rt = ElasticRuntime(pool=scenario_pool(scenario, devices=device_slots(need, device)),
                            initial_nodes=scenario.initial_nodes,
                            engine=engine)
        return RuntimeAdapter(rt)
    raise ValueError(f"unknown executor {executor!r}; pick from {EXECUTORS}")


def run_serve(
    name: str,
    *,
    executor: str = "sim",
    strategy=None,
    config: Optional[ServeConfig] = None,
    device=None,
) -> ServeReport:
    """Replay a registered serve trace through one executor.

    The engine is the scenario's default engine (same strategy
    resolution as every other consumer) with its bytes model swapped for
    the live :class:`~repro_torch.serving.kv_cache.KVBytesModel`, so resize
    pricing tracks the actual in-flight KV pages.  Raises on any parity
    violation: engine-charged vs predicted vs measured bytes, the
    prefix-range worker contract, a dropped request, or a trace that
    fails to drain.  The live executor's slots lie on ``device`` (the
    card unless the caller names the CPU; without a card it raises).
    """
    scenario = get_scenario(name)
    if name not in SERVE_TRAFFIC:
        raise KeyError(
            f"{name!r} has no traffic trace; serve scenarios: "
            f"{sorted(SERVE_TRAFFIC)}")
    rates = SERVE_TRAFFIC[name].rates
    cfg = config or serve_config(name)

    table = KVPageTable(
        cfg.page_spec(), range(scenario.initial_nodes), cfg.pages_per_worker,
        slot_limit=cfg.slots_per_worker)
    batcher = ContinuousBatcher(table, cfg.slots_per_worker)
    engine = scenario.default_engine(strategy)
    engine.bytes_model = KVBytesModel(table)
    cluster = _serve_cluster_for(scenario, engine, executor, device)

    events_at: Dict[int, List] = {}
    for ev in sorted(scenario.events, key=lambda e: e.step):
        events_at.setdefault(ev.step, []).append(ev)

    wall = 0.0
    next_rid = 0
    carry = 0.0                      # fractional-arrival accumulator
    arrival_wall: Dict[int, float] = {}
    latency: Dict[int, float] = {}
    records: List[ScenarioRecord] = []
    tokens_by_step: List[int] = []
    completions: List[Tuple[int, int]] = []      # (step, rid)
    downtime_by_step: Dict[int, float] = {}

    def one_step(step: int, rate: float) -> None:
        nonlocal wall, next_rid, carry
        for ev in events_at.get(step, ()):
            for rec in _dispatch(cluster, ev):
                rec = replace(rec, step=step)
                nodes_after = sorted(cluster.state.nodes_in_use())
                if nodes_after != list(range(len(nodes_after))):
                    raise RuntimeError(
                        f"serve trace {name!r} broke the prefix-range "
                        f"worker contract at step {step}: {nodes_after}")
                predicted = table.predicted_resize_stats(nodes_after)
                result = batcher.resize(nodes_after, step)
                if result.stats != predicted:
                    raise _ByteParityError(
                        f"step {step}: measured migration {result.stats} "
                        f"!= predicted {predicted}")
                charged = (rec.bytes_stayed, rec.bytes_moved)
                planned = (predicted["bytes_stayed"],
                           predicted["bytes_moved"])
                if charged != planned:
                    raise _ByteParityError(
                        f"step {step}: engine charged (stayed, moved)="
                        f"{charged} but the page table planned {planned}")
                wall += rec.downtime_s
                downtime_by_step[step] = (downtime_by_step.get(step, 0.0)
                                          + rec.downtime_s)
                records.append(rec)
        carry += rate
        while carry >= 1.0:
            carry -= 1.0
            batcher.submit(cfg.request_for(next_rid, step))
            arrival_wall[next_rid] = wall
            next_rid += 1
        batcher.admit(step)
        n_tokens, done = batcher.decode(step)
        wall += cfg.resolved_step_time_s(cluster.n_nodes)
        tokens_by_step.append(n_tokens)
        for rid in done:
            latency[rid] = wall - arrival_wall[rid]
            completions.append((step, rid))
        batcher.check_invariants()

    for step in range(scenario.steps):
        one_step(step, rates[step] if step < len(rates) else 0.0)
    step = scenario.steps
    while batcher.in_flight():
        if step >= scenario.steps + cfg.max_drain_steps:
            raise RuntimeError(
                f"serve trace {name!r} failed to drain: "
                f"{len(batcher.in_flight())} requests still in flight")
        one_step(step, 0.0)
        step += 1

    if batcher.dropped or len(batcher.completed) != next_rid:
        raise RuntimeError(
            f"serve trace {name!r} lost requests: submitted {next_rid}, "
            f"completed {len(batcher.completed)}, dropped {batcher.dropped}")
    if table.total_pages() or table.pages_allocated != table.pages_freed:
        raise RuntimeError(
            f"serve trace {name!r} leaked KV pages: {table.total_pages()} "
            f"resident, {table.pages_allocated} allocated, "
            f"{table.pages_freed} freed")

    phases = _phases(scenario, records, step, completions, latency,
                     tokens_by_step, downtime_by_step, cfg)
    return ServeReport(
        scenario=name,
        executor=executor,
        records=tuple(records),
        latencies=tuple(latency[r] for r in sorted(latency)),
        phases=phases,
        wall_s=wall,
        downtime_s=sum(r.downtime_s for r in records),
        queued_s=sum(r.queued_s for r in records),
        bytes_moved=sum(r.bytes_moved for r in records),
        bytes_cross_rack=sum(r.bytes_cross_rack for r in records),
        tokens_decoded=batcher.tokens_decoded,
        submitted=next_rid,
        completed=len(batcher.completed),
        migrated=batcher.migrated,
        requeued=batcher.requeued,
        dropped=batcher.dropped,
    )


def _phases(
    scenario: Scenario,
    records: List[ScenarioRecord],
    total_steps: int,
    completions: List[Tuple[int, int]],
    latency: Dict[int, float],
    tokens_by_step: List[int],
    downtime_by_step: Dict[int, float],
    cfg: ServeConfig,
) -> Tuple[ServePhase, ...]:
    """Slice the run into steady allocation spans between resizes.

    A resize happens at the top of its step, so that step opens a new
    phase (and carries the resize's downtime in the phase's wall time).
    Each phase's span is priced at ITS worker count
    (:meth:`ServeConfig.resolved_step_time_s`), matching the per-step
    accumulation in the run loop.
    """
    starts = [0]
    workers = [scenario.initial_nodes]
    for rec in records:
        if rec.step != starts[-1]:
            starts.append(rec.step)
            workers.append(rec.nodes_after)
        else:
            workers[-1] = rec.nodes_after
    bounds = starts + [total_steps]
    out = []
    for i, start in enumerate(starts):
        end = bounds[i + 1]
        lats = sorted(latency[rid] for s, rid in completions
                      if start <= s < end)
        toks = sum(tokens_by_step[start:end])
        span = (end - start) * cfg.resolved_step_time_s(workers[i]) + sum(
            dt for s, dt in downtime_by_step.items() if start <= s < end)
        out.append(ServePhase(
            start_step=start,
            end_step=end,
            workers=workers[i],
            completed=len(lats),
            p50_latency_s=_percentile(tuple(lats), 0.50),
            throughput_tok_s=toks / span if span > 0 else 0.0,
        ))
    return tuple(out)


def check_serve_agreement(names=None, *, strategy=None, device=None) -> int:
    """Replay every serve trace on BOTH executors; 0 iff all agree.

    The serving analog of :func:`examples.malleability_sim
    .check_sim_live_agreement`: prints each disagreement to stderr and
    returns the number of disagreeing traces, so callers can
    ``sys.exit`` on it.
    """
    import sys

    bad = 0
    for name in (names if names is not None else sorted(SERVE_TRAFFIC)):
        sim = run_serve(name, executor="sim", strategy=strategy)
        live = run_serve(name, executor="live", strategy=strategy, device=device)
        if serve_parity_key(sim) != serve_parity_key(live):
            bad += 1
            print(f"serve sim/live DISAGREE on {name!r}:", file=sys.stderr)
            for fld in ServeReport.__dataclass_fields__:
                a, b = getattr(sim, fld), getattr(live, fld)
                if a != b:
                    print(f"  {fld}: sim={a!r} live={b!r}", file=sys.stderr)
    return bad
