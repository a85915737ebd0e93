"""Paged KV-cache manager: page table + per-request page lists.

Decode workers hold their requests' KV caches in fixed-size **pages**
(the MaxText ``inference.page_manager`` / vLLM PagedAttention idea): a
request owns ``ceil(tokens / page_tokens)`` pages, all resident on the
worker decoding it.  :class:`KVPageTable` is the bookkeeping — which
page lives where, which request owns it — and, critically for this
repo, the **bytes model** for reconfiguration pricing: when the serving
pool resizes, the pages of migrated requests are REDISTRIBUTION bytes
exactly like resharded parameters are for training.

Pricing follows :mod:`repro_torch.elastic.reshard` one-for-one:

* :meth:`KVPageTable.predicted_resize_stats` is the *predicted* side —
  a pure function of the current table and the target worker set,
  returning the same ``{"bytes_total", "bytes_stayed", "bytes_moved"}``
  dict as :func:`repro_torch.elastic.reshard.predicted_transfer_stats`;
* :meth:`KVPageTable.apply_resize` performs the migration and
  *measures* the same stats from the page→worker diff; the two agree
  byte for byte (pinned by ``tests/test_torch_serving.py``);
* :class:`KVBytesModel` adapts the table to the
  :class:`~repro_torch.core.engine.ReconfigEngine` bytes-model protocol
  (``stats(ns, nt)``, mirroring
  :class:`~repro_torch.elastic.reshard.PytreeBytesModel`), so an engine
  planning a decode-pool resize charges the in-flight KV footprint as
  stage-3 bytes — distance-class splitting (``bytes_cross_rack`` /
  ``bytes_cross_pod``) rides on top via the engine's placement
  machinery, unchanged.

Migration placement is deterministic (worker with the most free pages,
then lowest id; grows rebalance onto the fresh workers only), which is
what lets the simulator and the live runtime charge identical bytes
without exchanging any state.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class PageSpec:
    """Fixed page geometry: tokens per page and bytes per page."""

    page_tokens: int
    page_bytes: int

    def __post_init__(self) -> None:
        if self.page_tokens <= 0 or self.page_bytes <= 0:
            raise ValueError(
                f"page geometry must be positive, got {self}")

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` KV entries (at least one)."""
        return max(1, -(-int(tokens) // self.page_tokens))


@functools.lru_cache(maxsize=None)
def page_bytes_for_arch(arch: str, page_tokens: int, batch: int = 1) -> int:
    """Exact bytes of one ``page_tokens``-token KV page for a model config.

    ``init_cache``-compatible by construction: sums the abstract
    :func:`repro_torch.models.transformer.init_cache_shapes` spec for a
    ``(batch, page_tokens)`` cache — the same shapes
    :meth:`repro_torch.models.model.Model.init_cache` allocates — so a page
    priced here is a real slice of the model's decode cache, no weights
    allocated.  The spec names its dtypes as strings (``"bfloat16"``); their
    item sizes come from torch.
    """
    import math

    from repro_torch.configs import arch_config
    from repro_torch.models.common import torch_dtype
    from repro_torch.models.transformer import init_cache_shapes

    shapes = init_cache_shapes(arch_config(arch), batch, page_tokens)
    return int(sum(
        math.prod(shape) * torch_dtype(dt).itemsize
        for shape, dt, _axes, _fill in shapes.values()
    ))


@dataclass(frozen=True)
class ResizeResult:
    """One applied page migration: who moved, and the measured stats.

    ``stats`` is MEASURED from the page→worker diff after the move (not
    read off the plan), so asserting it against
    :meth:`KVPageTable.predicted_resize_stats` is a real
    predicted-vs-measured parity check, like
    ``transfer_stats == predicted_transfer_stats`` in
    :mod:`repro_torch.elastic.reshard`.
    """

    moves: Tuple[Tuple[int, int, int], ...]   # (request, src, dst) per move
    stats: Dict[str, int]                     # bytes_total/stayed/moved
    evicted: Tuple[int, ...]                  # workers removed
    added: Tuple[int, ...]                    # workers added

    @property
    def moved_requests(self) -> Tuple[int, ...]:
        return tuple(rid for rid, _s, _d in self.moves)


class KVPageTable:
    """Page table for a pool of decode workers.

    One request's pages all live on one worker (its decode slot's
    worker).  ``pages_per_worker`` is the admission capacity; migration
    may overcommit a survivor (shedding capacity under shrink must never
    fail — the zero-drop invariant outranks the soft page budget).
    ``slot_limit`` caps how many requests a grow may rebalance onto one
    fresh worker (the batching layer passes its decode-slot count, so a
    remapped request always finds a slot).
    """

    def __init__(
        self,
        spec: PageSpec,
        workers: Iterable[int],
        pages_per_worker: int,
        *,
        capacities: Optional[Dict[int, int]] = None,
        slot_limit: Optional[int] = None,
    ) -> None:
        if pages_per_worker <= 0:
            raise ValueError("pages_per_worker must be positive")
        self.spec = spec
        self.pages_per_worker = pages_per_worker
        self.slot_limit = slot_limit
        self._capacity: Dict[int, int] = {}
        for w in workers:
            self._capacity[int(w)] = pages_per_worker
        if capacities:
            for w, cap in capacities.items():
                if int(cap) <= 0:
                    raise ValueError(f"worker {w}: capacity must be positive")
                self._capacity[int(w)] = int(cap)
        if not self._capacity:
            raise ValueError("page table needs at least one worker")
        # page id -> worker / owning request; request -> its pages (ordered)
        self._page_worker: Dict[int, int] = {}
        self._page_owner: Dict[int, int] = {}
        self._request_pages: Dict[int, List[int]] = {}
        self._request_worker: Dict[int, int] = {}
        self._next_page = 0
        self.pages_allocated = 0
        self.pages_freed = 0

    # ------------------------------------------------------------- queries --
    def worker_ids(self) -> Tuple[int, ...]:
        return tuple(sorted(self._capacity))

    @property
    def n_workers(self) -> int:
        return len(self._capacity)

    def capacity(self, worker: int) -> int:
        return self._capacity[worker]

    def used_pages(self, worker: int) -> int:
        if worker not in self._capacity:
            raise KeyError(f"unknown worker {worker}")
        return sum(1 for w in self._page_worker.values() if w == worker)

    def free_pages(self, worker: int) -> int:
        return self._capacity[worker] - self.used_pages(worker)

    def total_pages(self) -> int:
        return len(self._page_worker)

    def total_bytes(self) -> int:
        return self.total_pages() * self.spec.page_bytes

    def requests(self) -> Tuple[int, ...]:
        return tuple(sorted(self._request_pages))

    def request_worker(self, rid: int) -> int:
        return self._request_worker[rid]

    def request_pages(self, rid: int) -> Tuple[int, ...]:
        return tuple(self._request_pages[rid])

    def request_bytes(self, rid: int) -> int:
        return len(self._request_pages[rid]) * self.spec.page_bytes

    def requests_on(self, worker: int) -> Tuple[int, ...]:
        return tuple(sorted(
            r for r, w in self._request_worker.items() if w == worker))

    def pages_on(self, worker: int) -> int:
        """Pages resident on one worker (its migration load)."""
        return self.used_pages(worker)

    # ---------------------------------------------------------- allocation --
    def allocate(self, rid: int, n_pages: int, worker: int) -> Tuple[int, ...]:
        """Give a new request ``n_pages`` pages on ``worker``."""
        if rid in self._request_pages:
            raise ValueError(f"request {rid} already holds pages")
        if worker not in self._capacity:
            raise KeyError(f"unknown worker {worker}")
        if n_pages <= 0:
            raise ValueError("n_pages must be positive")
        ids = []
        for _ in range(n_pages):
            pid = self._next_page
            self._next_page += 1
            self._page_worker[pid] = worker
            self._page_owner[pid] = rid
            ids.append(pid)
        self._request_pages[rid] = ids
        self._request_worker[rid] = worker
        self.pages_allocated += n_pages
        return tuple(ids)

    def append_page(self, rid: int) -> int:
        """One more page for a decoding request (on its worker)."""
        worker = self._request_worker[rid]
        pid = self._next_page
        self._next_page += 1
        self._page_worker[pid] = worker
        self._page_owner[pid] = rid
        self._request_pages[rid].append(pid)
        self.pages_allocated += 1
        return pid

    def free_request(self, rid: int) -> int:
        """Release every page a finished request holds; returns the count."""
        pages = self._request_pages.pop(rid)
        del self._request_worker[rid]
        for pid in pages:
            del self._page_worker[pid]
            del self._page_owner[pid]
        self.pages_freed += len(pages)
        return len(pages)

    # ------------------------------------------------------------ resizing --
    def plan_resize(
        self, workers_after: Sequence[int],
    ) -> Dict[int, Tuple[int, int]]:
        """Deterministic migration plan for a new worker set.

        Pure (no mutation).  Returns ``{request: (src, dst)}``:

        * every request on an **evicted** worker moves to the remaining
          worker with the most free pages (lowest id on ties) — requests
          in id order, loads updated as they land, overcommit allowed
          (fresh workers join with ``pages_per_worker`` capacity and
          zero load, so they naturally absorb evictions first);
        * a **grow** additionally rebalances page load onto the fresh
          workers: while some remaining worker carries more pages than a
          fresh one plus the candidate request's pages, the newest
          request (highest id) moves over.  Moving strictly decreases
          the sum of squared loads, so the loop terminates; surviving
          placements are otherwise untouched.

        ``slot_limit`` (when set) caps TOTAL requests placed onto each
        fresh worker across both phases, so every remapped request finds
        a decode slot there.
        """
        after = {int(w) for w in workers_after}
        if not after:
            raise ValueError("cannot resize to an empty worker set")
        current = set(self._capacity)
        evicted = sorted(current - after)
        added = sorted(after - current)
        remaining = sorted(after)

        loads = {w: (self.used_pages(w) if w in current else 0)
                 for w in remaining}
        caps = {w: (self._capacity[w] if w in current
                    else self.pages_per_worker) for w in remaining}
        incoming = {w: 0 for w in added}
        moves: Dict[int, Tuple[int, int]] = {}

        def open_for(w: int) -> bool:
            return (w not in incoming or self.slot_limit is None
                    or incoming[w] < self.slot_limit)

        def place(rid: int, src: int, dst: int) -> None:
            moves[rid] = (src, dst)
            loads[dst] += len(self._request_pages[rid])
            if dst in incoming:
                incoming[dst] += 1

        # 1) evictions: drain every request off the removed workers.
        for w in evicted:
            for rid in self.requests_on(w):
                candidates = [s for s in remaining if open_for(s)]
                if not candidates:
                    raise RuntimeError(
                        "resize cannot place evicted requests: every "
                        "remaining worker is at its slot limit")
                dst = max(candidates, key=lambda s: (caps[s] - loads[s], -s))
                place(rid, w, dst)

        # 2) grow rebalance: spread page load onto the fresh workers.
        if added:
            survivors = sorted(current & after)
            movable = {
                w: [r for r in self.requests_on(w) if r not in moves]
                for w in survivors
            }
            while survivors:
                src = max(survivors, key=lambda s: (loads[s], -s))
                open_new = [w for w in added if open_for(w)]
                if not open_new or not movable[src]:
                    break
                dst = min(open_new, key=lambda w: (loads[w], w))
                rid = movable[src][-1]          # newest request first
                pages = len(self._request_pages[rid])
                if loads[src] - loads[dst] <= pages:
                    break                        # balanced: stop moving
                movable[src].pop()
                loads[src] -= pages
                place(rid, src, dst)
        return moves

    def _stats(self, moved_bytes: int) -> Dict[str, int]:
        total = self.total_bytes()
        return {
            "bytes_total": total,
            "bytes_stayed": total - moved_bytes,
            "bytes_moved": moved_bytes,
        }

    def predicted_resize_stats(
        self, workers_after: Sequence[int],
    ) -> Dict[str, int]:
        """Predicted transfer stats for a resize — pure, from the plan.

        The serving analog of :func:`repro_torch.elastic.reshard
        .predicted_transfer_stats`: moved = pages of migrated requests,
        stayed = pages revalidated in place, total = the whole resident
        KV footprint.
        """
        moves = self.plan_resize(workers_after)
        moved = sum(self.request_bytes(rid) for rid in moves)
        return self._stats(moved)

    def apply_resize(self, workers_after: Sequence[int]) -> ResizeResult:
        """Perform the planned migration; MEASURE the stats from the diff."""
        moves = self.plan_resize(workers_after)
        after = {int(w) for w in workers_after}
        before_worker = dict(self._page_worker)
        for rid, (_src, dst) in moves.items():
            self._request_worker[rid] = dst
            for pid in self._request_pages[rid]:
                self._page_worker[pid] = dst
        evicted = tuple(sorted(set(self._capacity) - after))
        added = tuple(sorted(after - set(self._capacity)))
        for w in evicted:
            if self.used_pages(w):
                raise RuntimeError(
                    f"eviction left pages on worker {w}")  # pragma: no cover
            del self._capacity[w]
        for w in added:
            self._capacity[w] = self.pages_per_worker
        moved = sum(
            self.spec.page_bytes
            for pid, w in self._page_worker.items() if before_worker[pid] != w
        )
        return ResizeResult(
            moves=tuple((rid, src, dst)
                        for rid, (src, dst) in sorted(moves.items())),
            stats=self._stats(moved),
            evicted=evicted,
            added=added,
        )


@dataclass
class KVBytesModel:
    """The page table as a :class:`~repro_torch.core.engine.ReconfigEngine`
    bytes model — KV migration priced as REDISTRIBUTION bytes.

    Mirrors :class:`~repro_torch.elastic.reshard.PytreeBytesModel`'s protocol:
    ``stats(ns, nt)`` returns the per-link split the engine charges
    (stayed on the local link, moved across), and calling the model
    returns the same mapping.  The engine hands over **rank** counts;
    the serving pool runs 1-wide workers on the prefix node range
    ``0..n-1`` (grows acquire lowest-free, traffic-policy shrinks evict
    the top ids), so ``ns`` names the current workers and ``nt`` the
    target set ``range(nt)`` — enforced, not assumed.

    ``stats`` is pure: the engine prices the plan *before* the service
    applies the migration, and the measured
    :meth:`KVPageTable.apply_resize` stats must then equal the charged
    bytes exactly (the serve loop asserts it on every resize).
    """

    table: KVPageTable
    width: int = 1                  # ranks per worker (serve pools are 1-wide)

    def _check(self, ns: int) -> None:
        if ns % self.width:
            raise ValueError(
                f"rank count {ns} is not a multiple of worker width "
                f"{self.width}")
        workers = self.table.worker_ids()
        if workers != tuple(range(ns // self.width)):
            raise ValueError(
                f"page table holds workers {workers} but the engine is "
                f"pricing a resize from {ns} ranks (expected the prefix "
                f"range 0..{ns // self.width - 1})")

    def stats(self, ns: int, nt: int) -> Dict[str, int]:
        if ns == nt or ns <= 0 or nt <= 0:
            return {"bytes_total": 0, "bytes_stayed": 0, "bytes_moved": 0}
        self._check(ns)
        out = self.table.predicted_resize_stats(range(nt // self.width))
        return dict(out)

    def __call__(self, ns: int, nt: int) -> Dict[str, int]:
        return self.stats(ns, nt)
