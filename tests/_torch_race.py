"""Scans racing the background tuner's retiles on one port store, shared by
the CPU suite (``test_torch_tuner.py``), the card (``test_torch_cuda.py``)
and ``chip_smoke.py``'s tuner race phase, which loads this file by path.

A store with the background tuner and the cache on serves ``threads``
client threads, each running the mix of ``tests/test_tuner.py``'s race
(car 0-32 x4, person 0-32 x4, car 0-32 x4), and a ``serve()`` session of
``SESSION`` car 0-32 submissions beside them, while the tuner thread
retiles under ``RegretPolicy``.  Its regions are held bit for bit against
an inline-tuned store running the same mix serially: reconstruction is
layout-invariant inside the port (a block encodes to the same coefficients
whatever tile holds it).  The store's scheduler lock serialises a batch's
decode and a retile's re-encode, so "racing" means a scan in flight (from
its call to its return) while a retile ran: ``encodes`` is read before and
after each scan.  Whether that happens depends on timing (the tuner thread
can lag the scans on a loaded host), so only the card's callers demand it
(``check(..., must_race=True)``), and each client thread repeats the mix,
up to ``max_passes`` times, until a scan has seen a retile in flight."""
import threading
import time

import numpy as np

from repro_torch.codec.encode import EncoderConfig, decode_tile
from repro_torch.core import (CacheConfig, DecodeConfig, RegretPolicy,
                              TuningConfig, VideoStore)
from repro_torch.core.cost import CostModel

ATOL, RTOL = 1e-3, 1e-5
ENC = EncoderConfig(gop=16, qp=8)
MIX = ([("car", (0, 32))] * 4 + [("person", (0, 32))] * 4
       + [("car", (0, 32))] * 4)
SESSION = 8


def _store(frames, dets, device, mode, cache):
    store = VideoStore(decode=DecodeConfig(device=device),
                       tuning=TuningConfig(mode=mode), cache=cache)
    store.ingest("v", frames, detections=dets, encoder=ENC,
                 policy=RegretPolicy(),
                 cost_model=CostModel(beta=1.4e-8, gamma=1e-5))
    return store


def oracle_frames(ts) -> np.ndarray:
    """Every frame of the tile store ``ts``, decoded tile by tile by the
    numpy oracle."""
    last = ts.sots[-1]
    out = np.zeros((last.frame_end, last.layout.frame_height,
                    last.layout.frame_width), dtype=np.float32)
    for rec in ts.sots:
        for i, (y1, x1, y2, x2) in enumerate(rec.layout.tile_rects()):
            out[rec.frame_start:rec.frame_end, y1:y2, x1:x2] = \
                decode_tile(ts._read_tile(rec, i))
    return out


def race(frames, dets, device, encodes=None, *, threads=3, max_passes=4,
         timeout=600, start=None):
    """Run the race; returns what :func:`check` holds, each scan's latency
    (``latencies``, seconds) and the serial store's epochs and time.
    ``encodes`` counts the retiles' encodes (a scan in flight is seen only
    where it is given); ``start``, if given, is called just before the
    threads start."""
    serial = _store(frames, dets, device, "inline",
                    CacheConfig(budget_bytes=0))
    t0 = time.perf_counter()
    want = [serial.scan("v").labels(lbl).frames(*fr).execute().regions
            for lbl, fr in MIX]
    serial_s = time.perf_counter() - t0
    serial_epochs = serial.epochs("v")
    serial.close()

    bg = _store(frames, dets, device, "background", CacheConfig())
    got = {k: [] for k in range(threads)}
    latencies, in_flight, errors = [], [], []
    lock = threading.Lock()

    def scan_loop(k):
        try:
            for _ in range(max_passes):
                for lbl, fr in MIX:
                    before = encodes and encodes()
                    t = time.perf_counter()
                    res = bg.scan("v").labels(lbl).frames(*fr).execute()
                    dt = time.perf_counter() - t
                    grew = encodes is not None and encodes() > before
                    with lock:
                        got[k].append(res)
                        latencies.append(dt)
                        if grew:
                            in_flight.append(k)
                if in_flight:
                    break
        except BaseException as e:  # noqa: BLE001 - raised by check
            errors.append(e)

    served = []

    def session_loop():
        try:
            with bg.serve() as session:
                futs = [session.submit(bg.scan("v").labels("car")
                                       .frames(0, 32))
                        for _ in range(SESSION)]
                served.extend(f.result(timeout=timeout) for f in futs)
        except BaseException as e:  # noqa: BLE001 - raised by check
            errors.append(e)

    workers = [threading.Thread(target=scan_loop, args=(k,))
               for k in range(threads)]
    workers.append(threading.Thread(target=session_loop))
    if start is not None:
        start()
    t0 = time.perf_counter()
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=timeout)
    race_s = time.perf_counter() - t0
    hung = sum(t.is_alive() for t in workers)
    tuner = bg.drain_tuner(timeout=timeout)
    out = dict(want=want, got=got, served=served, in_flight=in_flight,
               errors=errors, hung=hung, tuner=tuner,
               epochs=bg.epochs("v"), oracle=oracle_frames(bg.video("v")
                                                           .store),
               latencies=latencies, race_s=race_s, serial_s=serial_s,
               serial_epochs=serial_epochs)
    bg.close()
    return out


def _equal(a, b, what):
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} regions"
    for ra, rb in zip(a, b):
        assert ra[:-1] == rb[:-1], f"{what}: region keys differ"
        np.testing.assert_array_equal(ra[-1], rb[-1], err_msg=what)


def check(out, must_race=False) -> float:
    """The race's contract: no thread raised or hung, every region bit for
    bit the serial store's and within the decode oracle's tolerance, no
    query charged a retile, and an epoch risen; with ``must_race``, also
    a retile encoded while a scan was in flight.  Returns the largest
    |region - oracle|."""
    if out["errors"]:
        raise out["errors"][0]
    assert out["hung"] == 0, f"{out['hung']} threads hung"
    results = [r for rs in out["got"].values() for r in rs] + out["served"]
    assert len(out["served"]) == SESSION
    for k, rs in out["got"].items():
        assert rs and len(rs) % len(MIX) == 0, f"thread {k}: {len(rs)} scans"
        for i, r in enumerate(rs):
            _equal(out["want"][i % len(MIX)], r.regions,
                   f"thread {k} scan {i}")
    for i, r in enumerate(out["served"]):
        _equal(out["want"][0], r.regions, f"session scan {i}")
    worst = 0.0
    for r in results:
        assert r.stats.retile_s == 0.0
        for frame, (y1, x1, y2, x2), px in r.regions:
            want = out["oracle"][frame, y1:y2, x1:x2]
            np.testing.assert_allclose(px, want, atol=ATOL, rtol=RTOL)
            worst = max(worst, float(np.abs(px - want).max(initial=0.0)))
    assert any(out["epochs"].values()), f"no retile: {out['epochs']}"
    assert out["tuner"].applied >= 1
    if must_race:
        assert out["in_flight"], \
            "no retile encoded while a scan was in flight"
    return worst
