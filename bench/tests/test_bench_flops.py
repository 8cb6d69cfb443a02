"""The yardstick's FLOP and byte counts against hand counts, and its
parameter count against the program's at the published widths."""
import pytest
from conftest import ANALYTICS, PREFILL, TINY

import harness
from frozen import flops
from modelspec import model_spec
from reference import lm


def test_attention_call_hand_count():
    f, b, t = flops.attention_call(2, 4, 2, 3, 8, 8)
    assert f == 2 * 2 * 4 * 6 * (8 + 8)            # 6 causal pairs
    assert b == 2 * (2 * 4 * 3 * 8 * 2 + 2 * 2 * 3 * 8 * 2)
    assert t == max(f / flops.PEAK_FLOPS_BF16, b / flops.HBM_BW)
    f, _, _ = flops.attention_call(1, 16, 16, 4, 192, 128)   # MLA widths
    assert f == 2 * 16 * 10 * 320


def test_model_flops_hand_count_dense():
    cfg = dict(harness.find_cell(ANALYTICS).config, **TINY[ANALYTICS])
    s = model_spec(cfg)
    d, h, kv, hd, ff, v, L = 64, 4, 2, 16, 96, 256, 2
    layer = d * h * hd * 2 + d * kv * hd * 2 + 3 * d * ff
    proj = 48 * d + d * d
    n, img = 20, 16
    want = (2 * L * layer * n + 2 * proj * img
            + 2 * h * (hd + hd) * (n * (n + 1) // 2) * L + 2 * d * v)
    assert flops.model_flops(s, [n], image_tokens=img) == want
    assert flops.model_flops(s, [n, n], image_tokens=img) == 2 * want


def test_model_flops_hand_count_mla_moe():
    cfg = dict(harness.find_cell(PREFILL).config, **TINY[PREFILL])
    s = model_spec(cfg)
    d, h, r, dn, dr, dv = 64, 4, 32, 16, 8, 16
    attn = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    dense = attn + 3 * d * 96
    moe = attn + d * 8 + 2 * 3 * d * 24 + 3 * d * 2 * 24
    n = 10
    want = (2 * (dense + 2 * moe) * n
            + 2 * h * (dn + dr + dv) * (n * (n + 1) // 2) * 3 + 2 * d * 256)
    assert flops.model_flops(s, [n]) == want


@pytest.mark.parametrize("cell", [ANALYTICS, PREFILL])
def test_counts_match_the_program_at_published_width(cell):
    """The layout holds every parameter of the program's model (total)
    and the yardstick's active count plus embedding, head and norms is
    the program's active count."""
    from repro_torch.models.zoo import analytic_param_count

    import sut

    config = harness.find_cell(cell).config
    s, pcfg = model_spec(config), sut.program_config(config)
    entries = [e for _, es in lm.layout(s) for e in es]
    total = sum(_numel(shape) for _, shape, _ in entries)
    assert total == analytic_param_count(pcfg)
    other = sum(_numel(shape) for name, shape, _ in entries
                if "attn.w" not in name and ".mlp." not in name
                and ".moe." not in name and "projector" not in name)
    active = flops.active_layer_params(s) + other + flops.projector_params(s)
    if s.frontend_dim:
        active += 2 * s.d_model          # the projector's biases
    assert active == analytic_param_count(pcfg, active_only=True)
    assert total == {ANALYTICS: 19_918_682_112,
                     PREFILL: 15_706_484_224}[cell]


def _numel(shape):
    n = 1
    for x in shape:
        n *= x
    return n
