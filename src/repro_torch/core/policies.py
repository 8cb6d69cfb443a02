"""Tiling policies (paper §4.2–4.4).

Every policy sees each executed query (per-SOT) and proposes re-tilings.

- :class:`KQKOPolicy`      — §4.2 known-query/known-object optimization.
- :class:`LazyPolicy`      — §4.3 lazy detection (tile once locations known).
- :class:`MorePolicy`      — §5.3 "Incremental, more": after a query, re-tile
                              queried SOTs around all labels queried so far.
- :class:`RegretPolicy`    — §4.4 online regret accumulation; re-tile when
                              accumulated regret exceeds eta * R(s, L).
- :class:`NoTilingPolicy`  — baseline ω everywhere.

All policies share the cost model's what-if interface: candidate layouts are
costed with C(s,q,L) without re-encoding anything (paper §4.1's [12]).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

from repro_torch.core.cost import CostModel, pixels_and_tiles
from repro_torch.core.layout import TileLayout, partition, single_tile_layout
from repro_torch.core.semantic_index import SemanticIndex
from repro_torch.core.storage import SOTRecord, TileStore

ALPHA = 0.8  # §3.4.4/§5.2.3 minimum decode-reduction threshold
ETA = 1.0    # §4.4 regret multiplier (online-indexing setting of [11])


@dataclass
class QueryInfo:
    """One executed query as seen by a policy, restricted to one SOT."""
    video: str
    labels: tuple[str, ...]           # flat set of labels requested
    frame_range: tuple[int, int]
    boxes_by_frame: dict              # frame -> [bbox] (requested regions)
    sot: SOTRecord


class Policy:
    name = "base"
    #: True for policies carrying runtime state that must be persisted in
    #: the manifest (and re-saved after every ``observe``): see
    #: :meth:`state_dict`/:meth:`load_state`.
    stateful = False

    def on_ingest(self, index: SemanticIndex, store: TileStore,
                  video: str, frame_hw) -> dict[int, TileLayout]:
        """Layouts to apply at ingest time (sot_id -> layout)."""
        return {}

    def observe(self, q: QueryInfo, index: SemanticIndex, store: TileStore,
                model: CostModel) -> Optional[TileLayout]:
        """Pure proposal function, called once per executed query per SOT:
        returns a layout *proposal* for ``q.sot`` (or None).  It may mutate
        the policy's own runtime state but must never touch tile data —
        whether/when the proposal is applied is the caller's business (the
        scan path applies it synchronously under ``tuning="inline"``; the
        :class:`~repro_torch.core.tuner.PhysicalTuner` coalesces, scores, and
        applies asynchronously under ``tuning="background"``)."""
        return None

    def on_applied(self, sot_id: int, layout: TileLayout) -> None:
        """Proposal-feedback hook: an :meth:`observe` proposal for
        ``sot_id`` was resolved — applied (or found to be a no-op because
        the SOT already had the layout).  Policies that mutate bookkeeping
        when *proposing* can finalize it here.  Called under the scheduler
        lock by whichever path resolves the proposal (inline hook or the
        background tuner)."""

    def on_superseded(self, sot_id: int, layout: TileLayout) -> None:
        """Proposal-feedback hook: an :meth:`observe` proposal for
        ``sot_id`` will never be applied — a newer proposal coalesced it
        away, a foreground retile made it stale, or tuner admission
        deferred it as net-negative.  Policies that reset bookkeeping when
        proposing (RegretPolicy zeroes the winning alternative's regret)
        restore it here instead of silently losing it, so a superseded
        proposal can re-trigger once the workload warrants it again."""

    def spec(self) -> dict:
        """JSON-serializable constructor spec for manifest persistence.
        Runtime state travels separately via :meth:`state_dict`."""
        return {"name": self.name}

    def state_dict(self) -> dict:
        """JSON-serializable runtime state (accumulated regret, seen
        labels, ...), persisted per video in the manifest shard so a
        reopened store resumes tuning where it left off instead of cold.
        Stateless policies return ``{}``."""
        return {}

    def load_state(self, state: dict) -> None:
        """Restore :meth:`state_dict` output (tolerant of ``{}``/missing
        keys: absent state means a cold start)."""


class NoTilingPolicy(Policy):
    name = "not_tiled"


def _sot_boxes(index: SemanticIndex, video: str, labels: Iterable[str],
               sot: SOTRecord) -> list:
    out = []
    for label in labels:
        for f, boxes in index.boxes_for_label(
                video, label, (sot.frame_start, sot.frame_end)).items():
            out.extend(boxes)
    return out


def _alpha_ok(layout: TileLayout, q: QueryInfo, gop: int, alpha: float) -> bool:
    """P(s,q,L) < alpha * P(s,q,omega)."""
    omega = single_tile_layout(layout.frame_height, layout.frame_width)
    span = (q.sot.frame_start, q.sot.frame_end)
    p_l, _ = pixels_and_tiles(layout, q.boxes_by_frame, gop=gop, sot_frames=span)
    p_o, _ = pixels_and_tiles(omega, q.boxes_by_frame, gop=gop, sot_frames=span)
    return p_l < alpha * p_o if p_o > 0 else True


class PretileAllPolicy(Policy):
    """Tile every SOT around ALL detected objects before queries ("All
    objects" baseline in §5.3)."""

    name = "pretile_all"

    def __init__(self, granularity: str = "fine"):
        self.granularity = granularity

    def spec(self):
        return {"name": self.name, "granularity": self.granularity}

    def on_ingest(self, index, store, video, frame_hw):
        H, W = frame_hw
        layouts = {}
        for rec in store.sots:
            boxes = _sot_boxes(index, video, index.labels(video), rec)
            if boxes:
                layouts[rec.sot_id] = partition(H, W, boxes,
                                                granularity=self.granularity)
        return layouts


class KQKOPolicy(Policy):
    """§4.2: known workload objects O_Q with locations in the index.  Tiles
    each SOT with the fine-grained layout around O_Q ∩ SOT, unless the alpha
    rule says tiling won't pay."""

    name = "kqko"

    def __init__(self, query_objects: Iterable[str], alpha: float = ALPHA):
        self.o_q = tuple(query_objects)
        self.alpha = alpha

    def spec(self):
        return {"name": self.name, "query_objects": list(self.o_q),
                "alpha": self.alpha}

    def on_ingest(self, index, store, video, frame_hw):
        H, W = frame_hw
        layouts = {}
        for rec in store.sots:
            boxes = _sot_boxes(index, video, self.o_q, rec)
            if not boxes:
                continue
            cand = partition(H, W, boxes, granularity="fine")
            # alpha rule against the whole-workload proxy: pixels of tiles
            # containing the boxes vs full frames
            boxes_by_frame = {}
            for label in self.o_q:
                for f, bs in index.boxes_for_label(
                        video, label, (rec.frame_start, rec.frame_end)).items():
                    boxes_by_frame.setdefault(f, []).extend(bs)
            qi = QueryInfo(video, self.o_q, (rec.frame_start, rec.frame_end),
                           boxes_by_frame, rec)
            if _alpha_ok(cand, qi, store.encoder.gop, self.alpha):
                layouts[rec.sot_id] = cand
        return layouts


class LazyPolicy(Policy):
    """§4.3 lazy detection: after each query, tile the touched SOTs whose O_Q
    locations are now all known."""

    name = "lazy"

    def __init__(self, query_objects: Iterable[str], alpha: float = ALPHA):
        self.o_q = tuple(query_objects)
        self.alpha = alpha

    def spec(self):
        return {"name": self.name, "query_objects": list(self.o_q),
                "alpha": self.alpha}

    def observe(self, q, index, store, model):
        rec = q.sot
        span = (rec.frame_start, rec.frame_end)
        if not index.has_locations(q.video, self.o_q, span):
            return None  # wait: future queries target objects not yet located
        H, W = rec.layout.frame_height, rec.layout.frame_width
        boxes = _sot_boxes(index, q.video, self.o_q, rec)
        if not boxes:
            return None
        cand = partition(H, W, boxes, granularity="fine")
        if cand == rec.layout:
            return None
        if not _alpha_ok(cand, q, store.encoder.gop, self.alpha):
            return None
        return cand


class MorePolicy(Policy):
    """"Incremental, more" (§5.3): re-tile each queried SOT around all object
    classes queried so far."""

    name = "incremental_more"
    stateful = True

    def __init__(self):
        self.seen: set[str] = set()

    def state_dict(self):
        return {"seen": sorted(self.seen)}

    def load_state(self, state):
        self.seen = set(state.get("seen", ()))

    def observe(self, q, index, store, model):
        self.seen.update(q.labels)
        rec = q.sot
        H, W = rec.layout.frame_height, rec.layout.frame_width
        boxes = _sot_boxes(index, q.video, self.seen, rec)
        if not boxes:
            return None
        cand = partition(H, W, boxes, granularity="fine")
        if cand == rec.layout:
            return None
        return cand


class RegretPolicy(Policy):
    """§4.4: accumulate regret per (SOT, alternative layout); re-tile when
    delta_k > eta * R(s, L_k), skipping layouts that would hurt (alpha rule
    on any observed query)."""

    name = "incremental_regret"
    stateful = True

    def __init__(self, eta: float = ETA, alpha: float = ALPHA,
                 max_subsets: int = 16):
        self.eta = eta
        self.alpha = alpha
        self.max_subsets = max_subsets
        self.seen: set[str] = set()
        self.queried_combos: set[frozenset] = set()
        # (sot_id, labelset) -> accumulated regret seconds
        self.regret: dict[tuple[int, frozenset], float] = {}
        # (sot_id, labelset) vetoed by the alpha rule on some observed query
        self.vetoed: set[tuple[int, frozenset]] = set()
        # in-flight proposal bookkeeping: (sot_id, layout) -> list of
        # (regret key, pre-reset regret value), one per not-yet-resolved
        # proposal of that layout.  observe() resets the winning
        # alternative's regret when it proposes; the whole entry is
        # discarded when the layout is applied and restored when it is
        # superseded (transient — not part of state_dict: the tuner
        # resolves every pending proposal before a durable flush)
        self._pending: dict[tuple[int, TileLayout], list] = {}

    def spec(self):
        return {"name": self.name, "eta": self.eta, "alpha": self.alpha,
                "max_subsets": self.max_subsets}

    def state_dict(self):
        # frozenset keys become sorted label lists; entry order is sorted so
        # the serialization is deterministic across runs/hash seeds
        key = lambda k: (k[0], sorted(k[1]))   # (sot_id, labelset)
        return {
            "seen": sorted(self.seen),
            "queried_combos": sorted(sorted(c) for c in self.queried_combos),
            "regret": [[s, sorted(ls), v] for (s, ls), v in
                       sorted(self.regret.items(), key=lambda kv: key(kv[0]))],
            "vetoed": [[s, sorted(ls)] for s, ls in
                       sorted(self.vetoed, key=key)],
        }

    def load_state(self, state):
        self.seen = set(state.get("seen", ()))
        self.queried_combos = {frozenset(c)
                               for c in state.get("queried_combos", ())}
        self.regret = {(s, frozenset(ls)): float(v)
                       for s, ls, v in state.get("regret", ())}
        self.vetoed = {(s, frozenset(ls))
                       for s, ls in state.get("vetoed", ())}

    def _alternatives(self) -> list[frozenset]:
        alts = [frozenset([l]) for l in sorted(self.seen)]
        if len(self.seen) > 1:
            alts.append(frozenset(self.seen))
        for combo in self.queried_combos:
            if combo not in alts:
                alts.append(combo)
        return alts[: self.max_subsets]

    def observe(self, q, index, store, model):
        self.seen.update(q.labels)
        if len(q.labels) >= 1:
            self.queried_combos.add(frozenset(q.labels))
        rec = q.sot
        H, W = rec.layout.frame_height, rec.layout.frame_width
        gop = store.encoder.gop
        span = (rec.frame_start, rec.frame_end)
        p_cur, t_cur = pixels_and_tiles(rec.layout, q.boxes_by_frame,
                                        gop=gop, sot_frames=span)
        c_cur = model.cost(p_cur, t_cur)

        best = None
        for labelset in self._alternatives():
            key = (rec.sot_id, labelset)
            boxes = _sot_boxes(index, q.video, labelset, rec)
            if not boxes:
                continue
            cand = partition(H, W, boxes, granularity="fine")
            if cand == rec.layout:
                continue
            p_k, t_k = pixels_and_tiles(cand, q.boxes_by_frame,
                                        gop=gop, sot_frames=span)
            # delta regret = C(s, q, L_cur) - C(s, q, L_k)
            self.regret[key] = self.regret.get(key, 0.0) + (
                c_cur - model.cost(p_k, t_k))
            if not _alpha_ok(cand, q, gop, self.alpha):
                self.vetoed.add(key)
            if key in self.vetoed:
                continue
            # R(s, L_k): re-encode cost of the whole SOT under L_k
            n_frames = rec.frame_end - rec.frame_start
            r = model.encode_cost(cand.total_pixels() * n_frames, cand.n_tiles)
            if self.regret[key] > self.eta * r:
                score = self.regret[key] - self.eta * r
                if best is None or score > best[0]:
                    best = (score, key, cand)
        if best is None:
            return None
        _, key, cand = best
        self._pending.setdefault((rec.sot_id, cand), []).append(
            (key, self.regret[key]))
        self.regret[key] = 0.0
        return cand

    def on_applied(self, sot_id, layout):
        # every pending proposal of this exact layout is satisfied by the
        # one re-encode (re-proposals of one layout pile up under one key,
        # see the tuner's coalescing): all their resets become legitimate
        self._pending.pop((sot_id, layout), None)

    def on_superseded(self, sot_id, layout):
        # the re-encode never happened (coalesced away by a *different*
        # layout, deferred, or epoch-stale): restore the regret the
        # proposal(s) zeroed so the alternative can win again on evidence
        for key, value in self._pending.pop((sot_id, layout), ()):
            self.regret[key] = self.regret.get(key, 0.0) + value


# ---------------------------------------------------------------------------
# Manifest persistence: JSON-serializable policy specs (engine.py manifest)
# ---------------------------------------------------------------------------
def policy_spec(policy: Policy) -> dict:
    """Serialize a policy's *construction* (not its runtime state)."""
    return policy.spec()


_REGISTRY: dict[str, type] = {
    NoTilingPolicy.name: NoTilingPolicy,
    PretileAllPolicy.name: PretileAllPolicy,
    KQKOPolicy.name: KQKOPolicy,
    LazyPolicy.name: LazyPolicy,
    MorePolicy.name: MorePolicy,
    RegretPolicy.name: RegretPolicy,
}


def policy_from_spec(spec: dict) -> Policy:
    """Rebuild a policy from :func:`policy_spec` output.  Unknown names fall
    back to :class:`NoTilingPolicy` (manifests stay readable across
    versions)."""
    kwargs = {k: v for k, v in spec.items() if k != "name"}
    cls = _REGISTRY.get(spec.get("name", ""), NoTilingPolicy)
    try:
        return cls(**kwargs)
    except TypeError:
        return NoTilingPolicy()
