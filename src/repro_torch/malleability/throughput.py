"""Per-allocation step-time model: what an allocation *earns*.

``est_wall`` prices what a reconfiguration *costs*; nothing priced what
the resulting allocation *earns* per application step, so a cheap shrink
that halves step throughput looked like a good trade (ROADMAP item 1).
This module closes that gap with the same three-term roofline the
dry-run analysis uses (``benchmarks/roofline.py``, §Roofline):

* **compute** — ``global_batch x seq_len`` tokens at ``flops_per_token``
  (default ``6 x active params``, the training FLOP rule) over the
  allocation's chips at ``peak_flops``;
* **memory** — the parameter working set streamed once per step at the
  HBM bandwidth (allocation-independent: every chip holds/streams the
  full replicated pytree, matching the engine's replicated bytes model);
* **collective** — the gradient all-reduce, ``2 x param_bytes`` on the
  ICI link, degraded by ``contention x (n - 1)`` as more nodes share
  the fabric.  The base (zero-contention) term is charged at every
  allocation size, so under zero contention adding nodes NEVER
  increases the modeled step time — the monotonicity property
  ``tests/test_throughput.py`` pins.

**Width-weighted batch shares** (Iserte et al., arXiv:2506.14743): on an
uneven ``node_widths`` pool the compute term loads every *chip* equally
— a 4-chip node takes 4x the batch of a 1-chip node — so the step time
follows the pool's total width.  ``width_weighted=False`` reproduces
today's data plane instead (every *node* gets an equal share), where the
narrowest node is the straggler and adding a narrow node can genuinely
slow the step down — the contrast the weighted shares exist to fix.
:func:`batch_shares` is the matching integer data-plane split
(largest-remainder apportionment: shares sum EXACTLY to the global
batch).

The **contention hook** is calibrated, not guessed:
:meth:`ThroughputModel.calibrate` inverts the model against a measured
(overlapped) step time and returns the model with the implied
contention coefficient.

Coupling to the timeline: the ``run_scenario_*`` executors accept
``throughput=`` and accrue ``(steps since the last charged event) x
step_time(allocation)`` into each record's ``time_to_result_s`` (which
otherwise equals ``est_wall_s``);  :func:`time_to_result` sums a run
end to end, including the tail after the last reconfiguration — the
number :class:`~repro_torch.malleability.optimizer.ScheduleObjective`
minimizes when the model is enabled.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Sequence, Tuple

from .scenarios import Scenario, ScenarioRecord, param_bytes_for_arch

#: H100 SXM data-sheet values (one card), not measurements: dense bf16
#: tensor-core peak, HBM3 rate, and NVLink 4 per direction in ``ici_bw``
#: (the field keeps the reference's name).
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
ICI_BW = 450e9


@functools.lru_cache(maxsize=None)
def flops_per_token_for_arch(arch: str) -> float:
    """Analytic training FLOPs per token: ``6 x active params``.

    The same rule the roofline's ``model_flops_per_device`` applies to
    the train shape, from the port's own configs.
    """
    from repro_torch.configs import arch_config  # local: keep the import light

    return 6.0 * arch_config(arch).active_param_count()


def batch_shares(global_batch: int, widths: Sequence[int]) -> Tuple[int, ...]:
    """Integer per-node batch shares, weighted by node width.

    Largest-remainder apportionment: node ``i`` gets
    ``global_batch x widths[i] / sum(widths)`` rounded down, and the
    leftover samples go to the largest fractional remainders (ties to
    the lowest node id — deterministic).  The shares sum EXACTLY to
    ``global_batch`` on every pool, even or uneven — the property the
    data plane needs to never drop or duplicate a sample.
    """
    if global_batch < 0:
        raise ValueError(f"global_batch must be >= 0, got {global_batch}")
    if not widths or min(widths) <= 0:
        raise ValueError(f"widths must be non-empty and positive: {widths!r}")
    total = sum(widths)
    quotas = [global_batch * w / total for w in widths]
    shares = [int(q) for q in quotas]
    leftover = global_batch - sum(shares)
    order = sorted(range(len(widths)),
                   key=lambda i: (shares[i] - quotas[i], i))
    for i in order[:leftover]:
        shares[i] += 1
    return tuple(shares)


@dataclass(frozen=True)
class ThroughputModel:
    """The per-allocation step-time model (hashable, pure data).

    ``flops_per_token=0`` / ``param_bytes=0`` resolve lazily from
    ``arch`` (the port's configs and its shape-only model); give both
    explicitly to skip that.  ``node_widths`` declares the pool's chip widths in node-id
    order; when empty, :meth:`widths_for` falls back to the scenario's
    ``core_pool`` / ``cores_per_node`` widths, so the model prices the
    same pool the executors run against.
    """

    arch: str = ""                      # config for the lazy defaults
    global_batch: int = 256             # the train_4k shape cell
    seq_len: int = 4096
    flops_per_token: float = 0.0        # 0 -> 6 x active params (arch)
    param_bytes: int = 0                # 0 -> param_bytes_for_arch(arch)
    node_widths: Tuple[int, ...] = ()   # uneven pool widths (chips/node)
    width_weighted: bool = True         # False: equal per-node shares
    contention: float = 0.0             # fabric-sharing degradation
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW

    def resolved_flops_per_token(self) -> float:
        if self.flops_per_token > 0.0:
            return self.flops_per_token
        if not self.arch:
            raise ValueError(
                "ThroughputModel needs flops_per_token or an arch")
        return flops_per_token_for_arch(self.arch)

    def resolved_param_bytes(self) -> int:
        if self.param_bytes > 0:
            return self.param_bytes
        if not self.arch:
            raise ValueError("ThroughputModel needs param_bytes or an arch")
        return param_bytes_for_arch(self.arch)

    def widths_for(self, count: int, core_pool: Sequence[int] = (),
                   default_width: int = 1) -> Tuple[int, ...]:
        """Chip widths of a ``count``-node allocation on this pool.

        Allocations are node-id prefixes in both executors (the greedy
        lowest-free-node order), so the width vector is the prefix of
        ``node_widths`` — or of the scenario's ``core_pool`` when the
        model doesn't pin its own — padded with ``default_width`` past
        the declared pool.
        """
        if count <= 0:
            raise ValueError(f"an allocation needs >= 1 node, got {count}")
        base = tuple(self.node_widths or core_pool)
        if count <= len(base):
            return base[:count]
        pad = default_width if default_width > 0 else 1
        return base + (pad,) * (count - len(base))

    def shares(self, widths: Sequence[int]) -> Tuple[int, ...]:
        """This model's integer data-plane split for an allocation."""
        return batch_shares(self.global_batch, widths)

    def step_time(self, widths: Sequence[int]) -> float:
        """Modeled seconds per application step on an allocation.

        ``compute + memory + collective``.  The compute term uses exact
        fractional width-weighted shares — every chip equally loaded,
        so the term is ``total tokens / total chip throughput`` and
        strictly shrinks as capacity is added.  (The integer
        :func:`batch_shares` split rounds per node; pricing the rounded
        shares would let a narrow added node *raise* the modeled time,
        which is a data-plane artifact, not a capacity statement.)
        ``width_weighted=False`` prices today's equal-per-node shares
        instead: the narrowest node is the straggler.
        """
        widths = tuple(widths)
        if not widths or min(widths) <= 0:
            raise ValueError(f"widths must be non-empty and positive: {widths!r}")
        n = len(widths)
        fpt = self.resolved_flops_per_token()
        pb = self.resolved_param_bytes()
        if self.width_weighted:
            t_compute = (self.global_batch * self.seq_len * fpt
                         / (sum(widths) * self.peak_flops))
        else:
            t_compute = ((self.global_batch / n) * self.seq_len * fpt
                         / (min(widths) * self.peak_flops))
        t_memory = pb / self.hbm_bw
        t_collective = (2.0 * pb / self.ici_bw) * (
            1.0 + self.contention * (n - 1))
        return t_compute + t_memory + t_collective

    def calibrate(self, measured_step_s: float,
                  widths: Sequence[int]) -> "ThroughputModel":
        """The model with ``contention`` fitted to a measured step.

        Inverts :meth:`step_time` against an overlapped run's measured
        step seconds on ``widths``: whatever the zero-contention model
        cannot explain is attributed to fabric sharing, clamped at 0
        (a measurement *faster* than the model calibrates to zero, not
        to a negative coefficient).  Single-node measurements carry no
        contention signal and calibrate to zero.
        """
        widths = tuple(widths)
        n = len(widths)
        base = replace(self, contention=0.0).step_time(widths)
        t_coll = 2.0 * self.resolved_param_bytes() / self.ici_bw
        if n <= 1 or t_coll <= 0.0:
            return replace(self, contention=0.0)
        rho = max(0.0, (measured_step_s - base) / (t_coll * (n - 1)))
        return replace(self, contention=rho)


def time_to_result(records: Sequence[ScenarioRecord], scenario: Scenario,
                   throughput: ThroughputModel) -> float:
    """Modeled end-to-end seconds for one scenario run.

    Charged reconfiguration walls (``est_wall_s``, QUEUE spans included)
    plus modeled compute for every application step of the horizon under
    the allocation in force at that step — the segment after the last
    event (through ``scenario.steps``) included, which is exactly where
    a cheap shrink keeps paying.  Works on records from any executor,
    accrued or not: when the executor already accrued ``throughput=``
    segments, ``sum(r.time_to_result_s for r in records)`` equals this
    value minus the tail segment.
    """
    memo: dict[int, float] = {}

    def st(count: int) -> float:
        t = memo.get(count)
        if t is None:
            t = memo[count] = throughput.step_time(throughput.widths_for(
                count, core_pool=scenario.core_pool,
                default_width=scenario.cores_per_node))
        return t

    total = 0.0
    last = 0
    count = scenario.initial_nodes
    for rec in sorted(records, key=lambda r: r.step):
        if rec.step > last:
            total += (rec.step - last) * st(rec.nodes_before)
            last = rec.step
        total += rec.est_wall_s
        count = rec.nodes_after
    total += max(0, scenario.steps - last) * st(count)
    return total
