"""ElasticTrainer: the full malleability loop as a library component.

Ports :mod:`repro.elastic.trainer`.  Wraps a Model + ElasticRuntime +
SimulatedRMS into one training loop: every step it drains due RMS
events, reconfigures (expand via the parallel spawn plan,
shrink/fail/straggler via TS), places the params on the rebuilt slot
mesh (stage 3) and continues.  Checkpoints — periodic, or
CHECKPOINT-event-driven — cover the full-stop path: a RESTART event
rebuilds the world at the target size and reads the params back from
the latest snapshot.

What differs from the JAX trainer follows from one card holding every
slot (:mod:`repro_torch.elastic.node_group`):

* the step function is built once and never re-jitted: a world of k
  slots computes the whole global batch on the card, the loss a data-
  parallel step over k devices computes;
* stage 3 records the new placement (:mod:`repro_torch.elastic.reshard`)
  and logs its stayed and moved bytes; the train state stays where it
  is, so a resize takes no memory;
* RESTART is the one stage 3 that moves bytes on the card: the latest
  snapshot is copied into the live params leaf by leaf.

Besides the JAX trainer's logs, ``StepRecord.seconds`` is each step's
host wall (ended by the loss's device sync) and ``wall_log`` the host
wall of each step's reconfigurations on the card; for a restore also
the bytes it read, the time it waited for the last snapshot's write to
land and the time it took to read them back.  The records' ``est_wall_s`` and ``downtime_s`` are the
engine's modelled cluster costs, not card times.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.malleability.scenarios import RuntimeAdapter, dispatch_event
from repro_torch.models import Model
from repro_torch.parallel.sharding import ShardingContext, param_specs
from repro_torch.train import TrainState, build_init_fn, build_train_step

from .reshard import reshard_tree, transfer_stats
from .rms import Event, EventKind, SimulatedRMS
from .runtime import ElasticRuntime


@dataclass
class StepRecord:
    step: int
    loss: float
    n_nodes: int
    seconds: float = 0.0   # host clock of the step, ended by the loss's sync


@dataclass
class ElasticTrainer:
    model: Model
    runtime: ElasticRuntime
    rms: SimulatedRMS
    lr: float = 1e-3
    batch: int = 8
    seq: int = 64
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    history: list[StepRecord] = field(default_factory=list)
    transfer_log: list[dict] = field(default_factory=list)
    wall_log: list[dict] = field(default_factory=list)

    _NO_RESTORE = {"bytes_read": 0, "wait_s": 0.0, "read_s": 0.0}

    def __post_init__(self):
        self._shapes, self._specs = self.model.abstract_params()
        self._ctx = self._make_ctx()
        self._placement = self._place()
        self._step_fn = build_train_step(self.model, lr=self.lr)
        self._restore_pending = False
        self._restore_io = self._NO_RESTORE
        self._state: Optional[TrainState] = None
        self._data = SyntheticTokens(self.model.cfg, self.batch, self.seq, self.seed)
        self._ckpt = (
            CheckpointManager(self.checkpoint_dir) if self.checkpoint_dir else None
        )

    @classmethod
    def from_scenario(cls, model: Model, scenario, pool=None, engine=None,
                      **kwargs) -> "ElasticTrainer":
        """Build the full loop from a declarative scenario: the runtime
        executes the trace through the same ReconfigEngine the simulator
        charges, so per-event downtimes (and charged bytes) agree across
        both paths.  Pass ``engine`` to override the scenario's default —
        e.g. one carrying a :class:`~repro_torch.elastic.reshard.PytreeBytesModel`
        so charged bytes exactly equal the recorded reshard.

        Without a ``pool`` the scenario's pool is built from slots on the
        model's device (``scenario.core_pool`` widths for a heterogeneous
        trace)."""
        from repro_torch.malleability.scenarios import check_scenario_pool, scenario_pool

        from .node_group import device_slots

        if pool is None:
            need = (sum(scenario.core_pool) if scenario.core_pool
                    else scenario.pool_nodes() * scenario.cores_per_node)
            pool = scenario_pool(scenario, devices=device_slots(need, model.device))
        else:
            check_scenario_pool(scenario, pool)
        runtime = ElasticRuntime(
            pool=pool,
            initial_nodes=scenario.initial_nodes,
            engine=engine or scenario.default_engine(),
        )
        rms = SimulatedRMS.from_scenario(scenario)
        return cls(model=model, runtime=runtime, rms=rms, **kwargs)

    # ------------------------------------------------------------------ mesh --
    def _make_ctx(self) -> ShardingContext:
        return ShardingContext(mesh=self.runtime.mesh(("data",)))

    def _place(self) -> dict:
        """The params' placement on the current slot mesh."""
        return reshard_tree(self._shapes, self._ctx.mesh,
                            param_specs(self._shapes, self._specs, self._ctx))

    def _init_state(self):
        gen = torch.Generator(device=self.model.device).manual_seed(self.seed)
        self._state = build_init_fn(self.model)(gen)

    # --------------------------------------------------------------- resharding --
    def _reshard_state(self, step: int = -1, charged_bytes: int = 0):
        """Stage 3: place the live TrainState on the rebuilt mesh.

        Logs the bytes of the parameter pytree's placement change next
        to the engine-*charged* bytes for the drained events, so the two
        accountings can be compared (they are equal when the engine uses
        a :class:`~repro_torch.elastic.reshard.PytreeBytesModel` and one
        event was drained; multi-event drains reshard once over the net
        mesh change while the engine charges each hop).  The tensors
        stay where they are.
        """
        old = self._placement
        self._placement = self._place()
        stats = dict(transfer_stats(old, self._placement))
        stats["step"] = step
        stats["charged_bytes_moved"] = charged_bytes
        self.transfer_log.append(stats)

    def _restore_from_store(self, step: int, charged_bytes: int = 0):
        """SS-restart stage 3: params come back from the latest snapshot.

        The snapshot's leaves are copied into the live params on the
        card one at a time; optimizer state and the step counter carry
        on, as in the JAX trainer (whose saves persist only the params).
        With no store (or an empty one) the live state reshards instead:
        the charged cost story is identical, only the data source
        differs.
        """
        ck_step = None
        if self._ckpt is not None and self._state is not None:
            tw = time.perf_counter()
            self._ckpt.wait()   # saves are written on a worker thread
            tr = time.perf_counter()
            ck_step, nbytes = self._ckpt.restore_latest_into({"params": self._state.params})
            self._sync()
            self._restore_io = {"bytes_read": nbytes, "wait_s": tr - tw,
                                "read_s": time.perf_counter() - tr}
        self._reshard_state(step=step, charged_bytes=charged_bytes)
        if ck_step is not None:
            self.transfer_log[-1]["restored_from_step"] = ck_step

    # -------------------------------------------------------------------- events --
    def _handle(self, ev: Event):
        """One RMS event through the SAME dispatch the scenario executors
        use — the mapping lives once, in repro_torch.malleability.scenarios."""
        if ev.kind is EventKind.NOOP:
            return False
        applied = list(dispatch_event(
            RuntimeAdapter(self.runtime), ev.kind.value,
            nodes=ev.nodes, target_nodes=ev.target_nodes,
            queue_delay_s=ev.queue_delay_s,
        ))
        if ev.kind is EventKind.CHECKPOINT:
            # Persist the real snapshot next to the charged record, so a
            # later RESTART (or failure recovery) has bytes to read back.
            if self._ckpt is not None and self._state is not None:
                self._ckpt.save({"params": self._state.params},
                                len(self.history))
            return False  # no allocation change: keep the placement
        if ev.kind is EventKind.RESTART and applied:
            self._restore_pending = True
        return bool(applied)

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    # ---------------------------------------------------------------------- run --
    def run(self, steps: int) -> list[StepRecord]:
        if self._state is None:
            self._init_state()
        for i in range(steps):
            step_no = len(self.history)
            reconfigured = False
            records_before = len(self.runtime.history)
            t0 = time.perf_counter()
            self._restore_io = self._NO_RESTORE
            for ev in self.rms.events_until(step_no):
                reconfigured |= self._handle(ev)
            if reconfigured:
                self._ctx = self._make_ctx()
                charged = sum(
                    r.bytes_moved
                    for r in self.runtime.history[records_before:]
                )
                if self._restore_pending:
                    self._restore_pending = False
                    self._restore_from_store(step_no, charged_bytes=charged)
                else:
                    self._reshard_state(step=step_no, charged_bytes=charged)
            if len(self.runtime.history) > records_before:
                self._sync()
                self.wall_log.append({
                    "step": step_no,
                    "kinds": [r.kind for r in self.runtime.history[records_before:]],
                    "host_s": time.perf_counter() - t0,
                    **self._restore_io,
                })
            ts = time.perf_counter()
            batch = to_device(self._data.sample(step_no), self.model.device)
            self._state, metrics = self._step_fn(self._state, batch)
            loss = float(metrics["loss"])
            self.history.append(
                StepRecord(step=step_no, loss=loss, n_nodes=self.runtime.n_nodes,
                           seconds=time.perf_counter() - ts)
            )
            if self._ckpt and (step_no + 1) % self.checkpoint_every == 0:
                self._ckpt.save({"params": self._state.params}, step_no + 1)
        if self._ckpt:
            self._ckpt.wait()
        return self.history

    # ------------------------------------------------------------------ queries --
    @property
    def state(self) -> TrainState:
        return self._state

    def losses(self) -> list[float]:
        return [r.loss for r in self.history]
