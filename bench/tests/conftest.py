"""The benchmark's own tests: the harness's pieces on the CPU at tiny
sizes, and (marked ``cuda``, skipping without a card) its cells on the
card.  The harness's modules live in ``bench/``, the program in ``src/``."""
import copy
import json
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

ANALYTICS = "internvl2-26b.analytics_crops"
PREFILL = "deepseek-v2-lite-16b.long_prompt"

#: the cells' configurations at a width the CPU runs in seconds; every
#: other key is the cell's own
TINY = {
    ANALYTICS: dict(hidden_size=64, num_attention_heads=4,
                    num_key_value_heads=2, intermediate_size=96,
                    vocab_size=256, num_hidden_layers=2,
                    vision_hidden_size=48,
                    video_height=96, video_width=160, video_frames=32),
    PREFILL: dict(hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=4, intermediate_size=96,
                  vocab_size=256, num_hidden_layers=3, kv_lora_rank=32,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                  n_routed_experts=8, num_experts_per_tok=2,
                  moe_intermediate_size=24),
}
TINY_MIX = {ANALYTICS: dict(start_step=8, check_from=2, warm_cycles_max=3),
            PREFILL: dict(prompt_min=16, prompt_max=64, max_len=80,
                          cycle_prompts=16, check_from=4, check_waves=2)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


def tiny_cell(name: str):
    """The cell ``name`` of BENCHMARK.json, with its configuration and mix
    cut to ``TINY`` and ``TINY_MIX`` and its own limits."""
    import harness

    cell = harness.find_cell(name)
    cell = copy.deepcopy(cell)
    cell.config.update(TINY[name])
    if name == ANALYTICS:   # the stub's patch tokens, a departure it runs
        cell.config["assumed"]["num_image_token"]["run"] = 16
    cell.traffic.update(TINY_MIX[name])
    return cell


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.get_device_name(0)


def load_json(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())
