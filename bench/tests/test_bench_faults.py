"""The comparison that decides ``correct`` fails a broken program and the
control: each cell's loop runs on the CPU at a tiny size with the timed
path broken underneath (an answer or a token altered where it is
produced, a step that leaves its state unchanged, half of the batch left
out, and in the routed model each stage: the router, the expert GEMMs,
the combine's weights, the attention past the first layer's latent), and
with the control (the reference in the precision below the
configuration's) in the program's place."""
import time

import pytest
import torch
from conftest import ANALYTICS, PREFILL, tiny_cell

import harness


def _run(name, control=False):
    cell = tiny_cell(name)
    out = harness.run_loop(cell, seed=2 ** 31 + 21, seconds=1.5,
                           trace=False, device="cpu",
                           t_start=time.perf_counter(), control=control)
    return cell, out


def _shift_decode(monkeypatch):
    from repro_torch.codec import batch

    real = batch.decode_fused_op
    monkeypatch.setattr(batch, "decode_fused_op",
                        lambda q, qp: real(q, qp=qp) + 1.0)


def _shift_logits(monkeypatch):
    from repro_torch.models import zoo

    real = zoo.logits_fn

    def shifted(params, cfg, h):
        out = real(params, cfg, h).clone()
        out[..., 0] += 50.0
        return out

    monkeypatch.setattr(zoo, "logits_fn", shifted)


def _next_token_plus_one(monkeypatch):
    from repro_torch.serve import batching

    real = batching.next_tokens
    monkeypatch.setattr(batching, "next_tokens",
                        lambda cfg, logits: (real(cfg, logits) + 1)
                        % cfg.vocab)


def _cache_unwritten(monkeypatch):
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "_cache_write",
                        lambda cache, rows, idx: None)


def _half_batch(monkeypatch):
    """The second half of each call's rows computed from the first's
    tokens."""
    from repro_torch.models import zoo

    real = zoo.decode_step

    def half(params, cfg, batch, caches, **kw):
        tok = batch["tokens"].clone()
        h = tok.shape[0] // 2
        tok[h:2 * h] = tok[:h]
        return real(params, cfg, dict(batch, tokens=tok), caches, **kw)

    monkeypatch.setattr(zoo, "decode_step", half)


def _router_bottom_k(monkeypatch):
    from repro_torch.models import moe

    def bottom_k(router_logits, top_k):
        gates = torch.softmax(router_logits.float(), dim=-1)
        idx = torch.argsort(gates, dim=-1, stable=True)[:, :top_k]
        vals = gates.gather(1, idx)
        return vals / vals.sum(-1, keepdim=True), idx

    monkeypatch.setattr(moe, "_topk_routing", bottom_k)


def _experts_without_silu(monkeypatch):
    from repro_torch.models import moe

    def experts(p, buf, cd):
        h = torch.bmm(buf, p.w_gate.to(cd)) * torch.bmm(buf, p.w_up.to(cd))
        return torch.bmm(h, p.w_down.to(cd))

    monkeypatch.setattr(moe, "experts_apply", experts)


def _combine_unnormalised(monkeypatch):
    from repro_torch.models import moe

    real = moe._topk_routing

    def raw(router_logits, top_k):
        vals, idx = real(router_logits, top_k)
        gates = torch.softmax(router_logits.float(), dim=-1)
        return gates.gather(1, idx), idx

    monkeypatch.setattr(moe, "_topk_routing", raw)


def _attention_sees_ahead(monkeypatch):
    from repro_torch.models import attention

    real = attention._flash_attention
    monkeypatch.setattr(attention, "_flash_attention",
                        lambda q, k, v, *, causal: real(q, k, v,
                                                        causal=False))


@pytest.mark.parametrize("name,fault,number", [
    (ANALYTICS, _shift_decode, "scan_px_off"),
    (ANALYTICS, _shift_logits, "logit_err"),
    (PREFILL, _next_token_plus_one, "token_gap"),
    (PREFILL, _cache_unwritten, "latent_err"),
    (PREFILL, _half_batch, "latent_err"),
    (PREFILL, _router_bottom_k, "route_gap"),
    (PREFILL, _experts_without_silu, "latent_err"),
    (PREFILL, _combine_unnormalised, "latent_err"),
    (PREFILL, _attention_sees_ahead, "latent_err"),
])
def test_a_broken_program_is_not_correct(monkeypatch, name, fault, number):
    fault(monkeypatch)
    cell, out = _run(name)
    ok, _ = harness.judge(out.numbers, cell.limits)
    assert not ok
    assert out.numbers[number] > cell.limits[number], out.numbers


@pytest.mark.parametrize("name", [ANALYTICS, PREFILL])
def test_the_program_is_correct_and_the_control_is_not(name):
    cell, out = _run(name, control=True)
    assert harness.judge(out.numbers, cell.limits)[0], out.numbers
    assert not harness.judge(out.control, cell.limits)[0], out.control
    assert out.attempted > 0 and out.failed == 0
    assert torch.get_default_dtype() == torch.float32
