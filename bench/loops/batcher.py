"""A prefill pool: closed-loop clients send long prompts to the program's
``ContinuousBatcher`` and take back the first token (and the cache the
prefill built).

Mix parameters: ``clients`` (each sends its next prompt as soon as its
last one is answered), ``slots`` and ``max_len`` of the batcher,
``prompt_min``, ``prompt_max`` and ``cycle_prompts`` (a cycle holds the
log-uniform distribution's ``cycle_prompts`` quantile midpoints between
the two), ``max_new``, ``check_waves`` and ``check_from`` (the compared
prefills: the one that admits the first cycle's longest prompt, and others
drawn from the seed among the first ``check_from``; the window lasts
``--seconds`` and until they are served).

Every seed sends the same cycle of lengths, each cycle in its own order,
so every window holds the same work, while which prompts share a prefill,
and so the padding, is the batcher's doing; token ids are uniform over the
vocabulary.  Set-up draws the weights and serves a prefill of the cycle's
longest and one of its shortest prompts.

The harness reads the program through three taps, none of which adds work
on the card: the logits each step turns into tokens
(``serve.batching.next_tokens``), the shape of each call of
``zoo.decode_step`` (the positions each prefill ran, padding included) and
the experts each routed layer chose (``moe.route``).  The reference follows
the program's routing (a bf16 run sends some near-tied tokens elsewhere
than f32 does, and one such token moves its row by up to a spread) and
checks that routing by itself: how far below the reference's own top k
the program's choices lie.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from frozen import flops
from harness import RunOutput
from loops import common
from modelspec import model_spec
from reference import lm
from devtrace import DeviceTrace, Spans, by_kind


def cycle_lengths(mix: dict) -> np.ndarray:
    """A cycle's prompt lengths, the same for every seed: the log-uniform
    distribution's ``cycle_prompts`` quantile midpoints."""
    n = mix["cycle_prompts"]
    lo, hi = math.log(mix["prompt_min"]), math.log(mix["prompt_max"])
    q = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(lo + q * (hi - lo))).astype(np.int64)


def prompts(mix: dict, vocab: int, seed: int):
    """Endless prompts (int64 arrays), a cycle at a time, each cycle's
    lengths in an order drawn from the seed."""
    rng = common.rng(seed, 1)
    base = cycle_lengths(mix)
    while True:
        for n in rng.permutation(base):
            yield rng.integers(0, vocab, int(n))


def check_order(mix: dict, seed: int) -> list:
    """The prefills that may be compared besides the one that admits the
    longest prompt: the first ``check_waves`` of a permutation, drawn from
    the seed, of the first ``check_from``."""
    perm = common.rng(seed, 2).permutation(mix["check_from"])
    return [int(i) for i in perm[:mix["check_waves"]]]


class Taps:
    """Records what the program computed in one scheduler step: the
    logits it turned into tokens, the ``[rows, positions]`` of each model
    call and the experts each routed layer chose, in call order.  It
    keeps references to the program's own tensors, copying nothing; it
    also counts the positions the program prefilled."""

    def __init__(self):
        from repro_torch.models import moe, zoo
        from repro_torch.serve import batching

        self._patched = [(batching, "next_tokens"), (zoo, "decode_step"),
                         (moe, "route")]
        self._real = {name: getattr(mod, name)
                      for mod, name in self._patched}
        self.prefill_positions = 0
        self.prefill_shapes: dict = {}     # (rows, positions) -> calls
        self.clear()

    def clear(self) -> None:
        self.logits, self.calls, self.picks = [], [], []

    def __enter__(self):
        real = self._real

        def next_tokens(cfg, logits):
            self.logits.append(logits)
            return real["next_tokens"](cfg, logits)

        def decode_step(params, cfg, batch, caches, **kw):
            rows, n = batch["tokens"].shape
            self.calls.append((rows, n))
            if n > 1:
                self.prefill_positions += rows * n
                self.prefill_shapes[(rows, n)] = \
                    self.prefill_shapes.get((rows, n), 0) + 1
            return real["decode_step"](params, cfg, batch, caches, **kw)

        def route(logits, cfg, **kw):
            plan = real["route"](logits, cfg, **kw)
            self.picks.append(plan["idx"])
            return plan

        for fn in (next_tokens, decode_step, route):
            mod = next(m for m, n in self._patched if n == fn.__name__)
            setattr(mod, fn.__name__, fn)
        return self

    def __exit__(self, *exc):
        for mod, name in self._patched:
            setattr(mod, name, self._real[name])


def _latent(caches: dict, n: int) -> tuple:
    """Every layer's latent and rope key rows [L, B, n, *] of the
    program's cache (dense layers first)."""
    stacks = [caches[k] for k in ("dense_layers", "layers") if k in caches]
    return (torch.cat([s["c_kv"][:, :, :n] for s in stacks]).clone(),
            torch.cat([s["k_rope"][:, :, :n] for s in stacks]).clone())


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref).norm() / ref.norm())


def _logit_errs(cand: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's and position's largest logit error over the reference's
    spread across the vocabulary."""
    cand, ref = cand.float().flatten(0, -2), ref.float().flatten(0, -2)
    return (cand - ref).abs().amax(-1) / ref.std(-1)


def _token_gaps(tokens: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """How far each served token's reference logit lies below the
    reference's best, over the reference's spread: ``tokens`` [B, P],
    ``ref`` [B, P, V]."""
    ref = ref.float()
    got = ref.gather(-1, tokens[..., None].to(ref.device))[..., 0]
    return (ref.amax(-1) - got) / ref.std(-1)


TWICE = 1e9     # the route gap of a token that chose one expert twice


class _RouteCheck:
    """The reference's ``on_route``: how far below its own k-th best
    router logit the worst of each token's chosen experts lies, over the
    token's spread of logits (0 where the choice is the reference's own
    top k; ``TWICE`` where a token chose one expert twice)."""

    def __init__(self):
        self.gap = 0.0

    def __call__(self, layer, group, logits, picks):
        k = picks.shape[1]
        kth = logits.topk(k, dim=-1).values[:, -1]
        worst = logits.gather(1, picks).amin(1)
        gap = ((kth - worst).clamp(min=0)
               / logits.std(-1)).max()
        srt = picks.sort(1).values
        twice = bool((srt[:, 1:] == srt[:, :-1]).any())
        self.gap = max(self.gap, TWICE if twice else float(gap))


def _inputs(wave: dict) -> tuple:
    """The reference's tokens [rows, pad + 1] of one compared prefill, as
    the batcher lays them out (each admitted prompt left-padded with token
    0 to the longest, in its row; a row no request holds all 0), each
    row's first served token at the decode position, and the routing
    groups: the prefill's tokens dispatched together, then the decode
    step's."""
    B, pad, dev = wave["rows"], wave["pad"], wave["c_kv"].device
    tokens = torch.zeros((B, pad + 1), dtype=torch.long)
    for b, (p, s) in enumerate(zip(wave["prompts"], wave["served"])):
        tokens[b, pad - len(p):pad] = torch.from_numpy(p)
        tokens[b, pad] = int(s[0])
    flat = torch.arange(B * (pad + 1), device=dev).view(B, pad + 1)
    return tokens.to(dev), dict(
        logit_positions=[pad - 1, pad],
        routing_groups=[flat[:, :pad].reshape(-1), flat[:, pad]])


def _numbers(logits, served, lat: dict, route: _RouteCheck, ref) -> dict:
    """The compared numbers of one prefill: ``logits`` [B, 2, V] and
    ``served`` [n, 2] (the first n rows') of the candidate, ``lat`` each
    layer's latent errors, ``ref`` the reference's logits."""
    n = served.shape[0]
    return {"token_gap": float(_token_gaps(served, ref[:n]).max()),
            "logit_err": float(_logit_errs(logits, ref).max()),
            "latent_err": max(lat.values()),
            "route_gap": route.gap}


def _served_numbers(spec, weights, wave: dict, control: bool) -> tuple:
    """The compared numbers of one prefill, and the control's (or None).
    The reference runs the prefill and the decode step after it as the
    batcher did, routed as the candidate routed."""
    tokens, kw = _inputs(wave)
    n_moe = spec.n_layers - spec.first_dense
    picks = wave["picks"]
    if len(picks) != 2 * n_moe:
        raise RuntimeError(f"the program routed {len(picks)} times in a "
                           f"prefill and its decode step, not {2 * n_moe}")
    routing = [[picks[i], picks[n_moe + i]] for i in range(n_moe)]
    lat, route = {}, _RouteCheck()

    def latent(layer, c_kv, k_rope):
        lat[layer] = max(_rel(wave["c_kv"][layer], c_kv),
                         _rel(wave["k_rope"][layer], k_rope))

    ref = lm.forward(spec, weights, tokens, routing=routing,
                     on_latent=latent, on_route=route, **kw)
    served = torch.tensor(wave["served"])
    out = _numbers(wave["logits"], served, lat, route, ref)
    if not control:
        return out, None
    del ref
    # the control routes by itself; the reference then follows it
    ctl_picks, ctl_lat = {}, {}

    def record(layer, group, logits, chosen):
        ctl_picks[(layer, group)] = chosen

    def keep(layer, c_kv, k_rope):
        ctl_lat[layer] = (c_kv, k_rope)

    ctl = lm.forward(spec, weights, tokens, quant="fp8", on_route=record,
                     on_latent=keep, **kw)
    lat, route = {}, _RouteCheck()

    def latent_ctl(layer, c_kv, k_rope):
        got = ctl_lat.pop(layer)
        lat[layer] = max(_rel(got[0], c_kv), _rel(got[1], k_rope))

    ref = lm.forward(spec, weights, tokens, on_latent=latent_ctl,
                     on_route=route, routing=[
                         [ctl_picks[(i, 0)], ctl_picks[(i, 1)]]
                         for i in range(n_moe)], **kw)
    first = ctl.argmax(-1).cpu()[:served.shape[0]]
    return out, _numbers(ctl, first, lat, route, ref)


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> RunOutput:
    from repro_torch.serve import ContinuousBatcher

    import sut

    config, mix = cell.config, cell.traffic
    spec = model_spec(config)
    t_weights = common.now()
    common.reset_peak(device)
    weights = lm.Weights(spec, seed, device)
    pcfg = sut.program_config(config)
    model = sut.build_model(pcfg, weights)
    batcher = ContinuousBatcher(pcfg, model, slots=mix["slots"],
                                max_len=mix["max_len"], device=device)
    common.sync(device)
    t_warm = common.now()
    lengths = cycle_lengths(mix)
    warm = np.random.default_rng(0)
    for n in (lengths.max(), lengths.min()):
        for _ in range(mix["clients"]):
            batcher.submit(warm.integers(0, spec.vocab, int(n)),
                           mix["max_new"])
        while batcher.step():
            pass
    common.sync(device)

    maybe = check_order(mix, seed)
    gen = prompts(mix, spec.vocab, seed)
    spans, dev_trace = Spans(), DeviceTrace(trace)
    clients: list = []
    sent, kept = [], {}
    longest = None              # the prefill that admits the longest
    prefills = 0
    before = sut.launch_counts()
    with Taps() as tap:
        dev_trace.start()
        t0 = common.now()
        setup_s = t0 - t_start
        for _ in range(mix["clients"]):
            clients.append(batcher.submit(next(gen), mix["max_new"]))
        sent.extend(clients)
        while True:
            waiting = [r for r in clients if r.first_token_at is None]
            tap.clear()
            a = common.now()
            batcher.step()
            b = common.now()
            spans.add("step", a, b)
            admitted = sorted((r for r in waiting
                               if r.first_token_at is not None),
                              key=lambda r: r.rid)
            pre = [c for c in tap.calls if c[1] > 1]
            if admitted and len(pre) == 1:
                if longest is None and any(
                        len(r.prompt) == lengths.max() for r in admitted):
                    longest = prefills
                if prefills == longest or prefills in maybe:
                    rows, pad = pre[0]
                    c_kv, k_rope = _latent(batcher.caches, pad + 1)
                    kept[prefills] = dict(
                        rows=rows, pad=pad, c_kv=c_kv, k_rope=k_rope,
                        prompts=[r.prompt for r in admitted],
                        served=[r.out_tokens[:2] for r in admitted],
                        logits=torch.cat(tap.logits, dim=1),
                        picks=list(tap.picks))
            prefills += len(pre)
            if b - t0 >= seconds and longest is not None \
                    and prefills >= mix["check_from"]:
                break
            for i, r in enumerate(clients):
                if r.done_at is not None:
                    clients[i] = batcher.submit(next(gen), mix["max_new"])
                    sent.append(clients[i])
        window_s = b - t0
        dev_trace.stop()
        t_end = b
        tap.clear()
        positions, shapes = tap.prefill_positions, tap.prefill_shapes
    launches = {k: v - before[k] for k, v in sut.launch_counts().items()}
    # requests still waiting at the close are served after it, untimed
    while batcher.step():
        pass
    common.log(f"setup: imports_s={t_weights - t_start:.3f} weights_s="
               f"{t_warm - t_weights:.3f} warm_s={t0 - t_warm:.3f}")
    common.log(f"window: prefills={prefills} requests={len(sent)} "
               f"step_s={spans.total('step'):.3f}")
    peak = common.memory_peak(device)
    del batcher, model
    common.free(device)
    trace_out = dev_trace.reduce(spans)
    if trace_out is not None:
        common.log("device: " + " ".join(
            f"{k}_s={v:.4f}" for k, v in
            by_kind(trace_out["kernel_s"]).items()))

    # the longest prompt's prefill, and the first others the seed drew
    compare = [longest] + [i for i in maybe if i != longest][
        :mix["check_waves"] - 1]
    t_cmp = common.now()
    common.plain_f32()
    numbers, control_numbers = {}, {}
    for i in compare:
        got, ctl = _served_numbers(spec, weights, kept.pop(i), control)
        for into, vals in ((numbers, got), (control_numbers, ctl or {})):
            for k, v in vals.items():
                into[k] = max(into.get(k, 0.0), v)
    kept.clear()
    compare_s = common.now() - t_cmp
    common.log(f"compare: prefills={len(compare)} compare_s={compare_s:.3f}")

    served = [r for r in sent if r.done_at is not None and r.done_at <= t_end]
    prefilled = [r for r in sent if r.first_token_at is not None
                 and r.first_token_at <= t_end]
    real = sum(len(r.prompt) for r in prefilled)
    failed = sum(1 for r in sent if r.first_token_at is None
                 or len(r.out_tokens) < r.max_new)
    ttft = [r.first_token_at - r.submitted_at for r in served]
    calls = {(rows, spec.n_heads, spec.attn_kv_heads, n, spec.qk_dim,
              spec.v_dim): count * spec.n_layers
             for (rows, n), count in shapes.items()}
    ctx = {"window_s": window_s, "spans": {"step": spans.total("step")},
           "counters": {"requests": len(served), "prefills": prefills,
                        "prompt_tokens": real,
                        "prefill_positions": positions,
                        "padded_positions": positions - real},
           "useful_flops": sum(flops.model_flops(spec, [len(r.prompt)])
                               for r in prefilled),
           "attention_calls": calls, "launches": launches}
    e2e = {"setup_s": setup_s, "prefill_tokens_per_s": real / window_s,
           "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft else None}
    return RunOutput(attempted=len(sent), failed=failed, end_to_end=e2e,
                     ctx=ctx, numbers=numbers, memory_peak_bytes=peak,
                     trace=trace_out, control=control_numbers)
