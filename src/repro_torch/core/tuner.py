"""PhysicalTuner: asynchronous physical-design tuning off the scan path.

TASM's headline property is that the storage manager tunes tile layouts
*dynamically* as the query workload evolves (paper §4.3–4.4).  Running each
policy-triggered re-tile synchronously inside the scan that triggered it —
the pre-tuner behaviour — makes the unlucky query pay the full re-encode
latency.  This module moves that work into a background subsystem, the way
VStore separates configuration "backfill" from query serving and the online
indexing framing of §4.4 presumes tuning is amortized off the critical path:

- **Observation emission** — the scheduler's per-SOT policy hooks no longer
  call ``policy.observe`` or ``engine._retile``.  In ``"background"`` mode
  they append a lightweight :class:`Observation` (video, sot_id, labels,
  frame range, requested boxes) to a *bounded* workload log and return
  immediately; queries are never charged re-encode time
  (``ScanStats.retile_s`` stays 0, tuning work shows up in
  :class:`TunerStats` instead).
- **Tuning loop** — a daemon thread drains the log in submission order,
  replays each observation through the video's policy (``observe`` is a pure
  proposal function: it may mutate policy runtime state but never touches
  tile data), **coalesces** repeated proposals for the same SOT keeping only
  the newest, scores each winner through the §4.1 what-if interface
  (estimated decode savings of the observed workload vs. the re-encode cost
  of adopting the layout — recorded in :class:`TunerStats`; admission is
  delegated to the policies' own alpha/regret gates so ``"background"``
  converges to the same layouts as ``"inline"``), and applies winners via
  the durable, lock-taking, epoch-bumping ``VideoStore`` retile path, so
  in-flight scans and the tile cache stay exactly as consistent as they are
  for a foreground ``retile``.
- **Crash-safe ordering** — a drained batch is only *removed* from the log
  after the resulting state (policy runtime state + new layouts) has been
  persisted to the video's manifest shard, so a flush can never drop an
  observation whose effects were not yet durable.
- **Modes** — ``"background"`` (the ``VideoStore`` default) as above;
  ``"inline"`` preserves the old synchronous semantics bit-for-bit (observe
  + retile inside the scan, charged to ``ScanStats.retile_s``) for policy
  convergence tests and per-query cost attribution benchmarks; ``"off"``
  disables query-driven tuning entirely (ingest-time pre-tiling still runs).

``VideoStore.drain_tuner()`` is the deterministic barrier: it returns once
every observation emitted before the call has been replayed, every surviving
proposal applied, and the resulting state persisted — tests and benchmarks
use it to compare ``"background"`` against ``"inline"`` exactly.

Coalescing tradeoff: a policy that resets internal bookkeeping when it
*proposes* (RegretPolicy zeroes the winning alternative's regret) cannot
tell that a superseded proposal was never re-encoded — within a batch the
newer proposal wins and the older one's reset regret is simply gone, so
under large unflushed backlogs background tuning can lag inline's
adoption schedule for such policies (the per-query ``drain_tuner()``
cadence reproduces inline exactly; see the ROADMAP open item on proposal
feedback).  Layout-*content* is unaffected: whatever layout is eventually
adopted produces bit-identical pixels regardless of the path taken.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Optional

from repro_torch.core.layout import TileLayout
from repro_torch.core.policies import ALPHA, Policy, QueryInfo

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.engine import VideoEntry, VideoStore
    from repro_torch.core.query import SOTScan

#: valid VideoStore ``tuning=`` modes
TUNING_MODES = ("background", "inline", "off")

#: valid ``admission=`` modes: "policy" trusts the policies' own
#: alpha/regret gates (background adopts exactly what inline would);
#: "gated" additionally scores every coalesced winner through the §4.1
#: what-if interface, DEFERS net-negative proposals
#: (est_savings < alpha * est_reencode, alpha from the proposing policy),
#: and applies the survivors ranked by net benefit — a budgeted tuner that
#: spends re-encode time where the observed workload says it pays off
ADMISSION_MODES = ("policy", "gated")

#: default bound on the workload log (observations, not bytes)
DEFAULT_MAX_LOG = 4096

#: idle worker threads exit after this long with an empty log (they restart
#: on the next observation), so a dropped-but-never-closed store is not
#: pinned in memory forever by its parked tuner thread
IDLE_EXIT_S = 5.0


@dataclass
class Observation:
    """One executed per-SOT query as recorded in the workload log.

    Deliberately *not* a :class:`~repro_torch.core.policies.QueryInfo`: the SOT
    record is looked up at replay time, so the policy always sees the
    layout of record (a foreground retile may land between emission and
    replay), exactly as it would have inline.
    """
    video: str
    sot_id: int
    labels: tuple
    query_range: tuple
    boxes_by_frame: dict


@dataclass
class TunerStats:
    """Cumulative tuning accounting (see also ``ScanStats.retile_s``: in
    ``"background"`` mode queries are never charged re-encode time — it all
    lands here).

    - ``observed``/``dropped`` — observations appended to / evicted from the
      bounded workload log (an eviction means the tuner fell behind and the
      oldest workload evidence was discarded).
    - ``proposals`` — layouts returned by policy ``observe`` calls.
    - ``coalesced`` — proposals superseded by a newer proposal for the same
      SOT within one drain batch (their re-encode was skipped entirely).
    - ``applied``/``skipped`` — coalesced winners re-encoded vs. discarded
      as no-ops (the SOT already had the proposed layout, or the video/SOT
      disappeared before application).
    - ``deferred`` — winners rejected by ``admission="gated"`` as
      net-negative (``est_savings_s < alpha * est_reencode_s``); the
      proposing policy's ``on_superseded`` hook restores its bookkeeping,
      so a deferred retile re-proposes once more workload accumulates.
    - ``retile_s`` — seconds spent re-encoding applied retiles.
    - ``tuning_s`` — total wall seconds inside drain batches (replay +
      what-if scoring + re-encode); ``tuning_s - retile_s`` is the pure
      tuning overhead.
    - ``est_savings_s``/``est_reencode_s`` — §4.1 what-if scores of applied
      retiles: estimated decode seconds saved on the observed workload, and
      estimated re-encode cost paid.
    """
    observed: int = 0
    dropped: int = 0
    proposals: int = 0
    coalesced: int = 0
    applied: int = 0
    skipped: int = 0
    deferred: int = 0
    retile_s: float = 0.0
    tuning_s: float = 0.0
    est_savings_s: float = 0.0
    est_reencode_s: float = 0.0


class PhysicalTuner:
    """Background physical-design tuner owned by a :class:`VideoStore`.

    The scan path talks to it through :meth:`on_scan` (mode dispatch lives
    here so the scheduler stays a pure executor); everything else —
    :meth:`drain`, :meth:`pause`/:meth:`resume`, :meth:`stop`,
    :meth:`stats` — is control surface.
    """

    def __init__(self, engine: "VideoStore", mode: str = "background", *,
                 admission: str = "policy", max_log: int = DEFAULT_MAX_LOG):
        if mode not in TUNING_MODES:
            raise ValueError(f"unknown tuning mode {mode!r}; "
                             f"want one of {TUNING_MODES}")
        if admission not in ADMISSION_MODES:
            raise ValueError(f"unknown admission mode {admission!r}; "
                             f"want one of {ADMISSION_MODES}")
        self.engine = engine
        self.mode = mode
        self.admission = admission
        self.max_log = max(1, int(max_log))
        self._log: deque[Observation] = deque()
        #: the batch currently being replayed/applied: moved out of _log at
        #: take time (so bounded-log overflow can never evict a member of
        #: an in-flight batch) but still counted as backlog until its
        #: effects are persisted — drain()/crash-safe ordering see it
        self._inflight: list[Observation] = []
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._busy = False      # a drained batch is being replayed/applied
        self._paused = False
        self._stats = TunerStats()
        #: last exception a drain batch raised (a failing batch is dropped
        #: so tuning continues; the next drain() re-raises it)
        self.last_error: Optional[BaseException] = None

    # ------------------------------------------------------------ scan hook
    def on_scan(self, sot_scans: "list[SOTScan]") -> float:
        """Per-query policy hook, called by the scheduler (which holds its
        lock) once per finished plan.  Returns the re-encode seconds to
        charge to the query: >0 only in ``"inline"`` mode — background
        emission is O(1) per SOT and never re-encodes."""
        if not sot_scans:
            return 0.0
        # workload-log tap: the scheduler's prefetch predictor watches the
        # full query stream — unconditionally, because prediction needs to
        # see every scan, not just those whose policy listens, and works
        # even with tuning "off"/"inline".  No-op unless CacheConfig
        # enables prefetch; caller already holds the scheduler lock.
        self.engine.scheduler.note_scan(sot_scans)
        if self.mode == "off":
            return 0.0
        if self.mode == "inline":
            return self._observe_inline(sot_scans)
        emitted = False
        with self._cv:
            for ss in sot_scans:
                if not self._policy_listens(ss.video):
                    continue
                if len(self._log) >= self.max_log:
                    self._log.popleft()
                    self._stats.dropped += 1
                self._log.append(Observation(
                    video=ss.video, sot_id=ss.sot_id, labels=ss.labels,
                    query_range=ss.query_range,
                    boxes_by_frame=ss.boxes_by_frame))
                self._stats.observed += 1
                emitted = True
            if emitted:
                self._ensure_thread()
                self._cv.notify_all()
        return 0.0

    def _policy_listens(self, video: str) -> bool:
        """Skip emission for videos whose policy never reacts to queries
        (base ``observe``) — no point waking the tuner for NoTilingPolicy."""
        entry = self.engine._videos.get(video)
        return entry is not None and \
            type(entry.policy).observe is not Policy.observe

    def _observe_inline(self, sot_scans: "list[SOTScan]") -> float:
        """The pre-tuner synchronous path, bit-for-bit: observe + retile
        inside the scan, under the scheduler lock the caller holds."""
        engine = self.engine
        t0 = time.perf_counter()
        retile_s = 0.0
        for ss in sot_scans:
            # same filter as background emission, so TunerStats.observed
            # counts the same events in both modes
            if not self._policy_listens(ss.video):
                continue
            entry = engine._videos.get(ss.video)
            if entry is None:
                continue
            rec = entry.store.sots[ss.sot_id]
            qi = QueryInfo(ss.video, ss.labels, ss.query_range,
                           ss.boxes_by_frame, rec)
            proposal = entry.policy.observe(qi, entry.index, entry.store,
                                            entry.cost_model)
            with self._cv:
                self._stats.observed += 1
                # unlike the background path, proposal-less observes do NOT
                # dirty the shard: inline saves stay on the pre-tuner
                # cadence (retiles + close) so no full-shard rewrite lands
                # inside the timed scan path; the mutation is *noted* and
                # VideoStore.close() flushes it durably
                if entry.policy.stateful:
                    if proposal is not None:
                        engine._mark_dirty(ss.video)
                    else:
                        engine._stale_policy_state.add(ss.video)
                if proposal is not None:
                    self._stats.proposals += 1
            if proposal is not None:
                dt = engine._retile(ss.video, ss.sot_id, proposal)
                # resolved synchronously (applied, or already installed):
                # the policy's proposal bookkeeping is now legitimate
                entry.policy.on_applied(ss.sot_id, proposal)
                retile_s += dt
                with self._cv:
                    if dt:
                        self._stats.applied += 1
                        self._stats.retile_s += dt
                    else:
                        self._stats.skipped += 1
        with self._cv:
            self._stats.tuning_s += time.perf_counter() - t0
        return retile_s

    # ------------------------------------------------------------- control
    def stats(self) -> TunerStats:
        """Snapshot of the cumulative counters."""
        with self._cv:
            return replace(self._stats)

    @property
    def backlog(self) -> int:
        """Observations waiting in the workload log (including any batch
        currently being replayed)."""
        with self._cv:
            return len(self._log) + len(self._inflight)

    def pause(self) -> None:
        """Stop draining (observations keep accumulating).  A paused tuner
        lets tests build a multi-observation batch deterministically;
        :meth:`resume` before :meth:`drain`."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            if self._log:
                self._ensure_thread()
            self._cv.notify_all()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Barrier: block until every observation emitted before this call
        has been replayed, surviving proposals applied, and the resulting
        state persisted.  No-op in ``"inline"``/``"off"`` modes (there is
        nothing asynchronous to wait for).  Raises :class:`TimeoutError`
        on timeout; a paused tuner must be resumed first or the wait
        cannot finish."""
        if self.mode != "background":
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            if self._log:
                self._ensure_thread()
                self._cv.notify_all()
            while self._log or self._busy:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"drain_tuner timed out with {len(self._log)} "
                        "observations outstanding")
                self._cv.wait(remaining)
            if self.last_error is not None:
                err, self.last_error = self.last_error, None
                raise err

    def stop(self) -> None:
        """Flush the remaining log, persist, and stop the worker thread.
        Idempotent; a later scan restarts the thread on demand.  Callers
        must NOT hold the scheduler lock (the flush needs to take it)."""
        with self._cv:
            self._stopping = True
            self._paused = False
            thread = self._thread
            self._cv.notify_all()
        if thread is not None:
            thread.join()
        # thread never ran (or died): flush whatever is left synchronously
        while True:
            batch = self._take_batch()
            if not batch:
                break
            self._process_batch(batch)
        with self._cv:
            self._thread = None
            self._stopping = False

    # -------------------------------------------------------------- worker
    def _ensure_thread(self) -> None:
        """Caller holds ``_cv``."""
        if self._stopping or (self._thread is not None
                              and self._thread.is_alive()):
            return
        self._thread = threading.Thread(target=self._run, name="tasm-tuner",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cv:
                idle_since = time.monotonic()
                while not self._stopping and (self._paused or not self._log):
                    self._cv.wait(IDLE_EXIT_S)
                    if not self._paused and not self._log \
                            and not self._stopping \
                            and time.monotonic() - idle_since >= IDLE_EXIT_S:
                        # idle exit: stop pinning the engine from a parked
                        # thread; _ensure_thread restarts us on demand
                        if self._thread is threading.current_thread():
                            self._thread = None
                        return
                if self._stopping and (self._paused or not self._log):
                    return
            batch = self._take_batch()
            if batch:
                self._process_batch(batch)

    def _take_batch(self) -> list[Observation]:
        """Move the whole backlog into the in-flight slot.  The entries
        stay part of :attr:`backlog` until their effects are persisted
        (crash-safe ordering), but live outside ``_log`` so a concurrent
        bounded-log overflow can only evict not-yet-taken observations."""
        with self._cv:
            if not self._log:
                return []
            self._busy = True
            self._inflight = list(self._log)
            self._log.clear()
            return self._inflight

    def _process_batch(self, batch: list[Observation]) -> None:
        """Replay one drained batch: observe in submission order, coalesce
        proposals per SOT (newest wins), score + apply, persist — then drop
        the batch from the log."""
        engine = self.engine
        t0 = time.perf_counter()
        proposals = coalesced = applied = skipped = deferred = 0
        retile_s = savings_s = reencode_s = 0.0
        # keyed (video, sot_id); insertion order = first-proposal order, so
        # application order is deterministic for a given batch.  The layout
        # is the NEWEST proposal (recorded with the epoch it was proposed
        # against); the observation list keeps every proposing query so the
        # what-if score reflects the whole observed workload
        pending: dict[tuple[str, int],
                      tuple[TileLayout, int, list[Observation]]] = {}
        # every pending proposal must reach exactly one feedback hook;
        # keys leave this set as they are resolved, and whatever an
        # aborted batch leaves behind is superseded in the error cleanup
        # (so RegretPolicy's zeroed regret is never simply lost)
        unresolved: set[tuple[str, int]] = set()
        err: Optional[BaseException] = None
        try:
            # replay phase: one lock hold PER observation (matching the
            # inline cadence), so concurrent scans interleave with the
            # replay of a large backlog instead of stalling behind it
            for obs in batch:
                with engine.scheduler.lock:
                    entry = engine._videos.get(obs.video)
                    if entry is None or obs.sot_id >= len(entry.store.sots):
                        continue  # video dropped since emission
                    rec = entry.store.sots[obs.sot_id]
                    qi = QueryInfo(obs.video, obs.labels, obs.query_range,
                                   obs.boxes_by_frame, rec)
                    proposal = entry.policy.observe(
                        qi, entry.index, entry.store, entry.cost_model)
                    if entry.policy.stateful:
                        engine._mark_dirty(obs.video)
                    if proposal is None:
                        continue
                    proposals += 1
                    key = (obs.video, obs.sot_id)
                    prev = pending.get(key)
                    if prev is not None:
                        coalesced += 1
                        # a *different* older layout will never re-encode:
                        # tell the policy so reset bookkeeping (RegretPolicy's
                        # zeroed regret) is restored instead of silently
                        # lost.  A re-proposal of the SAME layout is merely
                        # subsumed — the winner's eventual on_applied/
                        # on_superseded resolves every stacked proposal
                        if prev[0] != proposal:
                            entry.policy.on_superseded(obs.sot_id, prev[0])
                        prev[2].append(obs)
                        pending[key] = (proposal, rec.epoch, prev[2])
                    else:
                        pending[key] = (proposal, rec.epoch, [obs])
                    unresolved.add(key)
            # admission (``"gated"``): score every coalesced winner first,
            # defer the net-negative ones, and rank the survivors by net
            # benefit so a budgeted backlog re-encodes best-payoff-first.
            # ``"policy"`` applies in first-proposal order with no gate —
            # admission already happened inside the policies
            if self.admission == "gated":
                ranked = []
                for i, ((video, sot_id), (layout, epoch, obs_list)) in \
                        enumerate(pending.items()):
                    with engine.scheduler.lock:
                        entry = engine._videos.get(video)
                        if entry is None \
                                or sot_id >= len(entry.store.sots):
                            skipped += 1
                            unresolved.discard((video, sot_id))
                            continue
                        if entry.store.sots[sot_id].epoch != epoch:
                            # stale before scoring: a foreground retile
                            # won, so the current layout is a meaningless
                            # baseline — same skipped+superseded outcome
                            # the apply phase gives stale proposals
                            skipped += 1
                            entry.policy.on_superseded(sot_id, layout)
                            unresolved.discard((video, sot_id))
                            continue
                        saved, reenc = self._score(entry, sot_id, layout,
                                                   obs_list)
                        alpha = getattr(entry.policy, "alpha", ALPHA)
                        if saved < alpha * reenc:
                            deferred += 1
                            entry.policy.on_superseded(sot_id, layout)
                            unresolved.discard((video, sot_id))
                            continue
                    ranked.append((saved - alpha * reenc, -i,
                                   ((video, sot_id),
                                    (layout, epoch, obs_list),
                                    (saved, reenc))))
                ranked.sort(reverse=True)   # net benefit desc, ties FIFO
                order = [item for *_, item in ranked]
            else:
                order = [(k, v, None) for k, v in pending.items()]
            # apply phase: one lock hold PER re-encode, so concurrent
            # scans interleave between retiles instead of stalling for the
            # whole batch (epoch bumps keep interleaved plans consistent)
            for (video, sot_id), (layout, epoch, obs_list), score in order:
                with engine.scheduler.lock:
                    # NOTE: the key leaves `unresolved` only once its hook
                    # has fired (or no policy exists to notify) — if
                    # _retile/save below raises first, the error cleanup
                    # still supersedes this proposal instead of leaking it
                    entry = engine._videos.get(video)
                    if entry is None or sot_id >= len(entry.store.sots):
                        skipped += 1
                        unresolved.discard((video, sot_id))
                        continue
                    rec = entry.store.sots[sot_id]
                    if rec.epoch != epoch:
                        # a retile landed after this proposal was made:
                        # applying it would revert a newer foreground
                        # layout with a wasted re-encode — never applied,
                        # so the policy restores its bookkeeping
                        skipped += 1
                        entry.policy.on_superseded(sot_id, layout)
                        unresolved.discard((video, sot_id))
                        continue
                    if layout == rec.layout:
                        # already installed exactly this layout: the
                        # proposal's intent is satisfied without work
                        skipped += 1
                        entry.policy.on_applied(sot_id, layout)
                        unresolved.discard((video, sot_id))
                        continue
                    # gated mode already scored this winner and the epoch
                    # check above proves the inputs are unchanged: reuse it
                    # instead of paying the what-if walk a second time
                    saved, reenc = score if score is not None else \
                        self._score(entry, sot_id, layout, obs_list)
                    retile_s += engine._retile(video, sot_id, layout)
                    entry.policy.on_applied(sot_id, layout)
                    unresolved.discard((video, sot_id))
                    applied += 1
                    savings_s += saved
                    reencode_s += reenc
            with engine.scheduler.lock:
                if engine.dirty:
                    engine.save()  # BEFORE the batch leaves the backlog
        except Exception as e:   # noqa: BLE001 - keep the tuner alive
            err = e
            # resolve proposals the aborted batch never reached, so policy
            # bookkeeping is restored rather than leaked (best-effort: the
            # original error stays the one drain() re-raises)
            for key in unresolved:
                try:
                    with engine.scheduler.lock:
                        entry = engine._videos.get(key[0])
                        if entry is not None:
                            entry.policy.on_superseded(key[1],
                                                       pending[key][0])
                except Exception:   # noqa: BLE001 - cleanup must not mask
                    pass
        finally:
            # the batch is dropped even on failure (re-processing a batch
            # that raises would wedge the tuner); drain() re-raises the
            # recorded error so the failure is not silent
            with self._cv:
                self._inflight = []
                self._busy = False
                st = self._stats
                st.proposals += proposals
                st.coalesced += coalesced
                st.applied += applied
                st.skipped += skipped
                st.deferred += deferred
                st.retile_s += retile_s
                st.est_savings_s += savings_s
                st.est_reencode_s += reencode_s
                st.tuning_s += time.perf_counter() - t0
                if err is not None:
                    self.last_error = err
                self._cv.notify_all()

    def _score(self, entry: "VideoEntry", sot_id: int, layout: TileLayout,
               obs_list: "list[Observation]") -> tuple[float, float]:
        """§4.1 what-if score of adopting ``layout`` for one SOT: estimated
        decode seconds saved summed over every observation that proposed
        for the SOT this batch (the observed workload, not just the
        coalesced winner), and the estimated re-encode cost.  Recorded for
        observability — admission is the policies' job (alpha/regret
        gates), so background tuning adopts exactly what inline would."""
        walk = self.engine._sot_cost_walk
        saved = 0.0
        for obs in obs_list:
            cur = sum(c for rec, *_, c, _b in
                      walk(entry, obs.boxes_by_frame)
                      if rec.sot_id == sot_id)
            alt = sum(c for rec, *_, c, _b in
                      walk(entry, obs.boxes_by_frame,
                           layout_by_sot={sot_id: layout})
                      if rec.sot_id == sot_id)
            saved += cur - alt
        rec = entry.store.sots[sot_id]
        n_frames = rec.frame_end - rec.frame_start
        reenc = entry.cost_model.encode_cost(
            layout.total_pixels() * n_frames, layout.n_tiles)
        return saved, reenc
