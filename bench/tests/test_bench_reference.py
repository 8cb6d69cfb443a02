"""The plain references against the program at tiny sizes on the CPU:
the model's logits and (through the batcher) its served tokens and latent
cache, and the codec's pixels of scanned boxes."""

import numpy as np
import pytest
import torch
from conftest import ANALYTICS, PREFILL, tiny_cell

from frozen.video_gen import generate, sparse_spec
from loops import batcher as batcher_loop
from modelspec import model_spec
from reference import codec, lm

import sut


def _model(name, compute="float32", seed=2 ** 31 + 11):
    cell = tiny_cell(name)
    spec = model_spec(cell.config)
    weights = lm.Weights(spec, seed, "cpu")
    pcfg = sut.program_config(cell.config, compute_dtype=compute)
    return cell, spec, weights, pcfg, sut.build_model(pcfg, weights)


@pytest.mark.parametrize("name", [ANALYTICS, PREFILL])
def test_forward_matches_the_program(name):
    from repro_torch.serve import make_prefill_step

    cell, spec, weights, pcfg, model = _model(name)
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, spec.vocab, (3, 12), generator=g)
    batch, pe = {"tokens": tok}, None
    if spec.frontend_dim:
        pe = torch.rand(3, spec.frontend_tokens, spec.frontend_dim,
                        generator=g)
        batch["patch_embeds"] = pe
    n = tok.shape[1] + (spec.frontend_tokens if pe is not None else 0)
    got, _ = make_prefill_step(pcfg, n, device="cpu")(model, batch)
    want = lm.forward(spec, weights, tok, logit_positions=[n - 1],
                      patch_embeds=pe)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    ctl = lm.forward(spec, weights, tok, logit_positions=[n - 1],
                     patch_embeds=pe, quant="fp8")
    assert float((ctl - want).abs().max()) > 1e-2


def test_weights_redraw_bit_for_bit():
    cell = tiny_cell(PREFILL)
    spec = model_spec(cell.config)
    a, b = lm.Weights(spec, 7, "cpu"), lm.Weights(spec, 7, "cpu")
    for group, _ in a.groups:
        for k, v in a.draw(group).items():
            assert torch.equal(v, b.draw(group)[k]), k
    assert not torch.equal(a.draw("layers.0")["layers.0.moe.w_up"],
                           lm.Weights(spec, 8, "cpu").draw("layers.0")
                           ["layers.0.moe.w_up"])


def _wave(pcfg, model, spec, lengths):
    """One prefill of the program's batcher (and the decode step after
    it), recorded by the harness's taps as the window records it."""
    from repro_torch.serve import ContinuousBatcher

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, spec.vocab, n) for n in lengths]
    b = ContinuousBatcher(pcfg, model, slots=4, max_len=40, device="cpu")
    with batcher_loop.Taps() as tap:
        reqs = [b.submit(p, 1) for p in prompts]
        b.step()
        rows, pad = next(c for c in tap.calls if c[1] > 1)
        c_kv, k_rope = batcher_loop._latent(b.caches, pad + 1)
        logits = torch.cat(tap.logits, dim=1)
        picks = list(tap.picks)
    assert logits.shape == (4, 2, spec.vocab)
    assert tap.prefill_positions == rows * pad == 4 * max(lengths)
    return dict(rows=rows, pad=pad, c_kv=c_kv, k_rope=k_rope,
                prompts=prompts, served=[r.out_tokens[:2] for r in reqs],
                logits=logits, picks=picks)


def _holds(lengths):
    cell, spec, weights, pcfg, model = _model(PREFILL)
    wave = _wave(pcfg, model, spec, lengths)
    got, ctl = batcher_loop._served_numbers(spec, weights, wave, True)
    assert got["token_gap"] == 0 and got["route_gap"] == 0
    assert got["logit_err"] <= 1e-4
    assert got["latent_err"] <= 1e-5
    assert ctl["latent_err"] > 100 * max(got["latent_err"], 1e-7)
    assert ctl["logit_err"] > 100 * max(got["logit_err"], 1e-7)


def test_batcher_wave_matches_the_reference():
    """One prefill through the program's batcher (f32 compute): its logits,
    tokens, latent cache and routing are the reference's, with the
    prefill's and the decode step's tokens dispatched to the experts apart
    and the prompts left-padded."""
    _holds((9, 30, 17, 24))


def test_batcher_wave_with_an_empty_row_matches_the_reference():
    """Three prompts in four slots: the row no request holds is all 0 and
    is dispatched with the rest."""
    _holds((12, 30, 5))


def test_the_reference_follows_the_routing_it_is_given():
    """Routed as the program routed, the reference matches it however the
    program chose; the route gap alone sees a choice that is not its own
    top k."""
    from repro_torch.models import moe

    cell, spec, weights, pcfg, model = _model(PREFILL)
    real = moe._topk_routing

    def bottom_k(router_logits, top_k):
        """The k worst experts, weighted by their own gates."""
        gates = torch.softmax(router_logits.float(), dim=-1)
        idx = torch.argsort(gates, dim=-1, stable=True)[:, :top_k]
        vals = gates.gather(1, idx)
        return vals / vals.sum(-1, keepdim=True), idx

    moe._topk_routing = bottom_k
    try:
        wave = _wave(pcfg, model, spec, (9, 30, 17, 24))
    finally:
        moe._topk_routing = real
    got, _ = batcher_loop._served_numbers(spec, weights, wave, False)
    assert got["logit_err"] <= 1e-4 and got["latent_err"] <= 1e-5
    assert got["route_gap"] > 1.0


def test_codec_matches_the_store():
    from repro_torch.codec.encode import EncoderConfig
    from repro_torch.core import CacheConfig, DecodeConfig, VideoStore

    frames, dets = generate(sparse_spec(3, n_frames=32, height=96,
                                        width=160))
    store = VideoStore(decode=DecodeConfig(device="cpu"),
                       cache=CacheConfig(budget_bytes=0))
    try:
        store.ingest("v", frames, detections=dets,
                     encoder=EncoderConfig(gop=16, qp=8))
        res = store.scan("v").labels("car").frames(4, 28).execute()
    finally:
        store.close()
    boxes = [(f, tuple(b)) for f, b, _ in res.regions]
    assert boxes
    ref = codec.decode_boxes(frames, boxes, gop=16, qp=8)
    ctl = codec.decode_boxes(frames, boxes, gop=16, qp=8, control=True)
    px = np.concatenate([r[2].ravel() for r in res.regions])
    ref, ctl = np.concatenate([r.ravel() for r in ref]), np.concatenate(
        [c.ravel() for c in ctl])
    assert np.mean(np.abs(px - ref) > 0.01) < 1e-3
    assert np.mean(np.abs(ctl - ref) > 0.01) > 0.5
