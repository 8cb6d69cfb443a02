"""Background repair/rebalance worker: the cluster's self-healing data
plane (modeled on the physical tuner's worker skeleton).

``ClusterRouter.repair()`` / ``rebalance(apply=True)`` enqueue
:class:`RepairJob`\\ s here; a daemon thread drains them OFF the serving
path, streaming one video per job node→node over dedicated connections
(never the router's shared serving channels, so bulk chunk frames cannot
head-of-line-block scans).  Each job:

1. opens (or resumes) the destination's staging namespace
   (``import_begin`` returns chunks already staged intact — a killed and
   restarted destination re-streams only what is missing);
2. streams every (SOT, tile) chunk with bounded retry + exponential
   backoff per chunk, rotating to another live source replica when one
   keeps failing;
3. detects a mid-copy foreground retile by epoch re-check — an exported
   chunk stamped with a different epoch than the manifest snapshot, or a
   final manifest re-fetch whose table moved — and re-streams the
   affected SOTs;
4. commits (``import_commit`` re-verifies every per-tile checksum and
   the epoch table against the router's expected generations — a
   pre-retile copy can never flip live), then asks the router to swap
   the placement assignment.  Until that flip, reads keep routing to the
   existing live replicas; a half-copied replica is never read.

Failures are bounded: a chunk that keeps failing past ``chunk_retries``
fails the JOB (status + error on the job record, surfaced through the
``repair_status`` RPC), never the worker thread.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.core import wire

#: connection-level failures that trigger redial + per-chunk retry
_CONN_ERRORS = (wire.ConnectionClosed, wire.WireError, OSError)

#: worker thread exits after this much idle time (restarted on demand)
IDLE_EXIT_S = 5.0

#: a copy re-streams (manifest re-fetch after an epoch bump) at most this
#: many times — each pass otherwise makes progress, so only a foreground
#: retile loop racing the copy forever can hit it
MAX_PASSES = 50


@dataclass
class RepairJob:
    """One video copy: ``src`` node → ``dst`` node, with progress
    counters exposed through the ``repair_status`` RPC."""
    job_id: str
    video: str
    src: str
    dst: str
    kind: str = "replicate"     # "replicate" (heal K) | "move" (rebalance)
    #: nodes dropped from the assignment when the copy flips (the dead
    #: replicas this copy replaces)
    drop: tuple = ()
    #: "move" puts dst first (new primary); "replicate" appends it
    dst_primary: bool = False
    status: str = "queued"      # queued | running | done | failed
    chunks_total: int = 0
    chunks_done: int = 0
    bytes_copied: float = 0.0
    retries: int = 0            # chunk-level reconnect/retry count
    restreams: int = 0          # SOT re-streams forced by epoch bumps
    error: str = ""

    def describe(self) -> dict:
        return {"job_id": self.job_id, "video": self.video,
                "src": self.src, "dst": self.dst, "kind": self.kind,
                "drop": list(self.drop), "status": self.status,
                "chunks_total": self.chunks_total,
                "chunks_done": self.chunks_done,
                "bytes_copied": self.bytes_copied,
                "retries": self.retries, "restreams": self.restreams,
                "error": self.error}


@dataclass
class RepairStats:
    """Worker-lifetime accounting (jobs come and go; this accumulates)."""
    jobs_queued: int = 0
    jobs_done: int = 0
    jobs_failed: int = 0
    chunks_copied: int = 0
    bytes_copied: float = 0.0
    retries: int = 0
    restreams: int = 0
    copy_s: float = 0.0


def _doc_epochs(meta: dict) -> dict[int, int]:
    return {int(s["sot_id"]): int(s["epoch"]) for s in meta["sots"]}


def _n_tiles(sot_doc: dict) -> int:
    return len(sot_doc["heights"]) * len(sot_doc["widths"])


class _Chan:
    """One end of a copy: a dedicated node connection with bounded
    per-call retry + exponential backoff and redial-on-failure.  The
    source end additionally rotates to another live replica when a node
    keeps failing (``rotate`` returns the next candidate or None)."""

    def __init__(self, worker: "RepairWorker", job: RepairJob, name: str,
                 *, rotate=None):
        self.worker = worker
        self.job = job
        self.name = name
        self.rotate = rotate
        self._ch = None

    def call(self, fn):
        w = self.worker
        attempt = 0
        while True:
            try:
                if self._ch is None:
                    self._ch = w.router._dial_node(self.name)
                return fn(self._ch)
            except _CONN_ERRORS as e:
                self.drop()
                with w._cv:
                    self.job.retries += 1
                    w._stats.retries += 1
                attempt += 1
                if attempt > w.chunk_retries:
                    if self.rotate is not None:
                        nxt = self.rotate(self.name)
                        if nxt is not None:
                            self.name = nxt
                            attempt = 0
                            continue
                    raise
                time.sleep(w.backoff_s * (2 ** (attempt - 1)))

    def drop(self) -> None:
        ch, self._ch = self._ch, None
        if ch is not None:
            try:
                ch.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass

    def close(self) -> None:
        self.drop()


class RepairWorker:
    """FIFO job queue + on-demand daemon thread (the tuner's skeleton:
    condition variable, idle-exit, ``drain()`` barrier, synchronous
    ``stop()``)."""

    def __init__(self, router, *, chunk_retries: int = 4,
                 backoff_s: float = 0.05):
        self.router = router
        self.chunk_retries = int(chunk_retries)
        self.backoff_s = float(backoff_s)
        self._cv = threading.Condition()
        self._queue: deque[RepairJob] = deque()
        self._jobs: list[RepairJob] = []   # every job ever submitted
        self._busy = False
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._next_id = 1
        self._stats = RepairStats()
        self.last_error: Optional[BaseException] = None

    # ------------------------------------------------------------- intake
    def submit(self, video: str, src: str, dst: str, *,
               kind: str = "replicate", drop=(),
               dst_primary: bool = False) -> RepairJob:
        with self._cv:
            job = RepairJob(job_id=f"r{self._next_id}", video=video,
                            src=src, dst=dst, kind=kind, drop=tuple(drop),
                            dst_primary=dst_primary)
            self._next_id += 1
            self._queue.append(job)
            self._jobs.append(job)
            self._stats.jobs_queued += 1
            self._ensure_thread()
            self._cv.notify_all()
        return job

    def _ensure_thread(self) -> None:
        # caller holds _cv
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run,
                                            name="tasm-repair",
                                            daemon=True)
            self._thread.start()

    # ---------------------------------------------------------- the worker
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopping:
                    if not self._cv.wait(timeout=IDLE_EXIT_S):
                        if not self._queue:   # idle: exit, restart on demand
                            self._thread = None
                            return
                if self._stopping and not self._queue:
                    self._thread = None
                    return
                job = self._queue.popleft()
                self._busy = True
                job.status = "running"
            t0 = time.perf_counter()
            try:
                self._run_job(job)
                with self._cv:
                    job.status = "done"
                    self._stats.jobs_done += 1
            except BaseException as e:  # noqa: BLE001 - keep worker alive
                with self._cv:
                    job.status = "failed"
                    job.error = f"{type(e).__name__}: {e}"
                    self._stats.jobs_failed += 1
                    self.last_error = e
            finally:
                with self._cv:
                    self._stats.copy_s += time.perf_counter() - t0
                    self._busy = False
                    self._cv.notify_all()

    def _run_job(self, job: RepairJob) -> None:
        router = self.router
        video = job.video
        if not job.src:
            raise RuntimeError(
                f"no live replica of {video!r} to copy from")
        tried = {job.dst, *job.drop}
        src = _Chan(self, job, job.src,
                    rotate=lambda cur: router._repair_source(
                        video, exclude=tried | {cur}))
        dst = _Chan(self, job, job.dst)
        try:
            try:
                begun = dst.call(lambda ch: ch.import_begin(video))
            except ValueError:
                # destination already holds the video (an earlier copy
                # committed but the flip was lost): verify its generation
                # and just flip placement
                have = dst.call(lambda ch: ch.epochs(video))
                expected = router.expected_epochs(video)
                if all(have.get(s, -1) >= e for s, e in expected.items()):
                    router._apply_repair(job)
                    return
                raise RuntimeError(
                    f"node {job.dst} already holds {video!r} at older "
                    f"epochs; drop it there before repairing")
            staged = {(int(s), int(e), int(t)): sha
                      for s, e, t, sha in begun["staged"]}
            meta = src.call(lambda ch: ch.export_meta(video))
            for _ in range(MAX_PASSES):
                expected = router.expected_epochs(video)
                if any(_doc_epochs(meta).get(s, -1) < e
                       for s, e in expected.items()):
                    # the snapshot pre-dates a retile the router already
                    # acknowledged — refresh before streaming stale chunks
                    self._count_restream(job)
                    time.sleep(self.backoff_s)
                    meta = src.call(lambda ch: ch.export_meta(video))
                    continue
                if self._stream_pass(job, src, dst, meta, staged):
                    # epoch bump seen mid-stream: refresh and re-stream
                    meta = src.call(lambda ch: ch.export_meta(video))
                    continue
                # every chunk staged for this snapshot; one last manifest
                # re-fetch catches a retile that landed while we streamed
                meta2 = src.call(lambda ch: ch.export_meta(video))
                if _doc_epochs(meta2) != _doc_epochs(meta):
                    self._count_restream(job)
                    meta = meta2
                    continue
                try:
                    dst.call(lambda ch: ch.import_commit(
                        video, meta,
                        min_epochs=router.expected_epochs(video)))
                except ValueError as e:
                    msg = str(e)
                    if "stale" in msg:
                        # retile raced the commit window: stream the bump
                        self._count_restream(job)
                        meta = src.call(lambda ch: ch.export_meta(video))
                        continue
                    if "not staged" in msg:
                        # destination restarted and lost (in-memory)
                        # staging: resync what survived and re-stream
                        begun = dst.call(lambda ch: ch.import_begin(video))
                        staged = {(int(s), int(e), int(t)): sha
                                  for s, e, t, sha in begun["staged"]}
                        continue
                    raise
                router._apply_repair(job)
                return
            raise RuntimeError(
                f"copy of {video!r} to {job.dst} kept racing retiles; "
                f"gave up after {MAX_PASSES} passes")
        finally:
            src.close()
            dst.close()

    def _stream_pass(self, job: RepairJob, src: _Chan, dst: _Chan,
                     meta: dict, staged: dict) -> bool:
        """Stream every chunk the manifest snapshot expects that isn't
        staged yet.  Returns True if an epoch bump was detected (caller
        refreshes the manifest and re-streams)."""
        sots = meta["sots"]
        with self._cv:
            job.chunks_total = sum(_n_tiles(s) for s in sots)
            job.chunks_done = sum(
                1 for s in sots for t in range(_n_tiles(s))
                if (int(s["sot_id"]), int(s["epoch"]), t) in staged)
        for s in sots:
            sid, ep = int(s["sot_id"]), int(s["epoch"])
            for t in range(_n_tiles(s)):
                if (sid, ep, t) in staged:
                    continue
                for attempt in range(self.chunk_retries + 1):
                    chunk = src.call(
                        lambda ch, sid=sid, t=t: ch.export_chunk(job.video,
                                                                 sid, t))
                    if int(chunk["epoch"]) != ep:
                        # mid-copy foreground retile on this SOT
                        self._count_restream(job)
                        return True
                    try:
                        dst.call(lambda ch, sid=sid, ep=ep, t=t, c=chunk:
                                 ch.import_chunk(job.video, sid, ep, t,
                                                 c["enc"], c["checksum"]))
                    except ValueError as e:
                        # the destination recomputed the checksum and the
                        # chunk arrived torn: re-export and re-send
                        if "torn" not in str(e) or \
                                attempt >= self.chunk_retries:
                            raise
                        with self._cv:
                            job.retries += 1
                            self._stats.retries += 1
                        continue
                    break
                staged[(sid, ep, t)] = chunk["checksum"]
                nbytes = float(chunk["enc"]["size_bytes"])
                with self._cv:
                    job.chunks_done += 1
                    job.bytes_copied += nbytes
                    self._stats.chunks_copied += 1
                    self._stats.bytes_copied += nbytes
        return False

    def _count_restream(self, job: RepairJob) -> None:
        with self._cv:
            job.restreams += 1
            self._stats.restreams += 1

    # ------------------------------------------------------------ plumbing
    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every queued job finished (done or failed).  Raises
        ``TimeoutError`` if they don't settle in time; re-raises the most
        recent job failure once (cleared after raising)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._queue or self._busy:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"repair queue not drained after {timeout}s "
                        f"({len(self._queue)} queued, busy={self._busy})")
                self._cv.wait(timeout=left)
            err, self.last_error = self.last_error, None
        if err is not None:
            raise err

    def stop(self) -> None:
        """Stop accepting progress: finish the running job, leave the
        rest queued, join the thread."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=60)

    def jobs(self) -> list[dict]:
        with self._cv:
            return [j.describe() for j in self._jobs]

    def stats(self) -> RepairStats:
        with self._cv:
            return replace(self._stats)
