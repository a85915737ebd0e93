"""Continuous batching over an elastic decode pool.

The scheduler half of the serving plane: an **admission queue** feeding
per-worker **decode slots**, one token decoded per active request per
application step, KV pages tracked by a :class:`~repro_torch.serving.kv_cache
.KVPageTable`.  What makes it the serving counterpart of the trainer's
drain-and-reshard is :meth:`ContinuousBatcher.resize` — the
**drain-and-remap** path with one hard invariant:

    a resize NEVER drops (or duplicates) an in-flight request.

Requests on evicted workers keep their KV pages — the page table
migrates them to the remaining workers, and those bytes are exactly
what the :class:`~repro_torch.serving.kv_cache.KVBytesModel` charged the
engine as REDISTRIBUTION — and either stay active on the worker now
holding their pages (a free decode slot there: *migrated*) or go back
to the FRONT of the admission queue in request order (*requeued*),
resuming from their decoded position once a slot frees.  Nothing is
restarted, nothing is lost; ``tests/test_torch_serving.py`` drives random
arrival/decode/resize interleavings through
:meth:`ContinuousBatcher.check_invariants` to pin it.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from .kv_cache import KVPageTable, ResizeResult


@dataclass(frozen=True)
class Request:
    """One decode request: prompt in, ``gen_tokens`` tokens out."""

    rid: int
    arrival_step: int
    prompt_tokens: int
    gen_tokens: int

    def __post_init__(self) -> None:
        if self.prompt_tokens < 1 or self.gen_tokens < 1:
            raise ValueError(
                f"request {self.rid}: prompt and generation must be "
                f"at least one token")

    def total_tokens(self) -> int:
        return self.prompt_tokens + self.gen_tokens


class ContinuousBatcher:
    """Admission queue + decode slots over the elastic worker pool.

    * :meth:`submit` enqueues (FIFO);
    * :meth:`admit` fills free slots in queue order — a request whose
      pages already sit on some worker (a requeued survivor of a
      resize) only re-admits where its pages are, so re-admission moves
      zero bytes; fresh requests take the worker with the most free
      slots (most free pages, then lowest id, on ties) and allocate
      their prompt's pages there (prefill);
    * :meth:`decode` advances every active request one token, growing
      its page list across page boundaries, completing and freeing at
      ``gen_tokens``;
    * :meth:`resize` applies a worker-set change via the page table's
      migration plan and remaps/requeues the affected requests.

    Admission is strict about the page budget; decode growth and
    migration may overcommit it (the soft-capacity contract documented
    on :class:`~repro_torch.serving.kv_cache.KVPageTable`).
    """

    def __init__(self, table: KVPageTable, slots_per_worker: int) -> None:
        if slots_per_worker <= 0:
            raise ValueError("slots_per_worker must be positive")
        self.table = table
        self.slots_per_worker = slots_per_worker
        self.queue: Deque[int] = deque()
        self.requests: Dict[int, Request] = {}
        self.active: Dict[int, int] = {}          # rid -> worker
        self.progress: Dict[int, int] = {}        # rid -> tokens generated
        self.completed: Dict[int, int] = {}       # rid -> completion step
        self.tokens_decoded = 0
        self.requeued = 0                         # resize -> back to queue
        self.migrated = 0                         # resize -> stayed active
        self.dropped = 0                          # MUST stay 0, forever

    # ------------------------------------------------------------- queries --
    def workers(self) -> Tuple[int, ...]:
        return self.table.worker_ids()

    def slots_free(self, worker: int) -> int:
        used = sum(1 for w in self.active.values() if w == worker)
        return self.slots_per_worker - used

    def in_flight(self) -> Tuple[int, ...]:
        """Submitted but not completed, in request order."""
        return tuple(sorted(set(self.queue) | set(self.active)))

    def utilization(self) -> float:
        total = self.slots_per_worker * self.table.n_workers
        return len(self.active) / total if total else 0.0

    # ------------------------------------------------------------ pipeline --
    def submit(self, request: Request) -> None:
        if request.rid in self.requests:
            raise ValueError(f"request {request.rid} already submitted")
        self.requests[request.rid] = request
        self.queue.append(request.rid)

    def _admission_worker(self, rid: int) -> Optional[int]:
        pages_held = rid in self.table.requests()
        if pages_held:
            # Requeued mid-flight request: its KV pages already live
            # somewhere; re-admission must not move bytes, so it waits
            # for a slot exactly there.
            w = self.table.request_worker(rid)
            return w if self.slots_free(w) > 0 else None
        need = self.table.spec.pages_for(self.requests[rid].prompt_tokens)
        best = None
        best_key = None
        for w in self.workers():
            if self.slots_free(w) <= 0 or self.table.free_pages(w) < need:
                continue
            key = (self.slots_free(w), self.table.free_pages(w), -w)
            if best_key is None or key > best_key:
                best, best_key = w, key
        return best

    def admit(self, step: int) -> List[int]:
        """Fill free slots in FIFO order; returns the admitted rids.

        Head-of-line blocking is deliberate: if the oldest waiting
        request cannot be placed, nothing behind it jumps the queue
        (arrival-order fairness — the latency numbers mean something).
        """
        admitted: List[int] = []
        while self.queue:
            rid = self.queue[0]
            worker = self._admission_worker(rid)
            if worker is None:
                break
            self.queue.popleft()
            if rid not in self.table.requests():
                need = self.table.spec.pages_for(
                    self.requests[rid].prompt_tokens)
                self.table.allocate(rid, need, worker)
            self.active[rid] = worker
            self.progress.setdefault(rid, 0)
            admitted.append(rid)
        return admitted

    def decode(self, step: int) -> Tuple[int, List[int]]:
        """One decode step for every active request.

        Returns ``(tokens_decoded, completed_rids)``.  Page growth: a
        request's KV occupancy is ``prompt + generated``; crossing a
        page boundary appends a page on its worker.
        """
        done: List[int] = []
        n_decoded = len(self.active)
        for rid in sorted(self.active):
            req = self.requests[rid]
            before = req.prompt_tokens + self.progress[rid]
            self.progress[rid] += 1
            self.tokens_decoded += 1
            if (before + 1 > len(self.table.request_pages(rid))
                    * self.table.spec.page_tokens):
                self.table.append_page(rid)
            if self.progress[rid] >= req.gen_tokens:
                done.append(rid)
        for rid in done:
            self.table.free_request(rid)
            del self.active[rid]
            del self.progress[rid]
            self.completed[rid] = step
        return n_decoded, done

    # -------------------------------------------------------------- resize --
    def resize(self, workers_after: Sequence[int], step: int) -> ResizeResult:
        """Drain-and-remap onto a new worker set; never drops a request.

        The page table migrates in-flight KV (its plan is exactly what
        the engine's :class:`~repro_torch.serving.kv_cache.KVBytesModel`
        priced); each moved ACTIVE request keeps decoding on the worker
        now holding its pages when a slot is free there, and otherwise
        rejoins the admission queue at the FRONT (request order
        preserved) with pages and progress intact.
        """
        before_active = dict(self.active)
        result = self.table.apply_resize(workers_after)
        back: List[int] = []
        for rid, _src, dst in result.moves:
            if rid not in before_active:
                continue                      # queued survivor: pages only
            if self.slots_free(dst) > 0:
                self.active[rid] = dst
                self.migrated += 1
            else:
                del self.active[rid]
                back.append(rid)
                self.requeued += 1
        for rid in sorted(back, reverse=True):
            self.queue.appendleft(rid)
        gone = [rid for rid, w in self.active.items()
                if w not in self.table.worker_ids()]
        if gone:                              # pragma: no cover - invariant
            raise RuntimeError(
                f"resize left active requests on evicted workers: {gone}")
        return result

    # ---------------------------------------------------------- invariants --
    def check_invariants(self) -> None:
        """Raise unless every slot/page/request invariant holds.

        The property-based suite calls this after every random
        operation: no request is ever lost or duplicated, slots never
        overcommit, completed requests hold no pages, and the page
        ledger balances (allocated == freed + resident).
        """
        queued = list(self.queue)
        if len(set(queued)) != len(queued):
            raise AssertionError(f"duplicate queue entries: {queued}")
        q, a, c = set(queued), set(self.active), set(self.completed)
        if q & a or q & c or a & c:
            raise AssertionError(
                f"request in two states: queue={q} active={a} done={c}")
        if q | a | c != set(self.requests):
            raise AssertionError("a submitted request vanished")
        if self.dropped:
            raise AssertionError(f"dropped={self.dropped} (must be 0)")
        for w in self.workers():
            if self.slots_free(w) < 0:
                raise AssertionError(f"worker {w} slots overcommitted")
        for rid, w in self.active.items():
            if self.table.request_worker(rid) != w:
                raise AssertionError(
                    f"active request {rid} decodes on {w} but its pages "
                    f"are on {self.table.request_worker(rid)}")
        paged = set(self.table.requests())
        if paged & c:
            raise AssertionError(f"completed requests hold pages: {paged & c}")
        if not a <= paged:
            raise AssertionError(f"active requests without pages: {a - paged}")
        ledger = self.table.pages_allocated - self.table.pages_freed
        if ledger != self.table.total_pages():
            raise AssertionError(
                f"page ledger off: allocated-freed={ledger} but "
                f"{self.table.total_pages()} resident")
