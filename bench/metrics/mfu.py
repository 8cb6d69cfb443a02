"""The model's useful FLOPs over the window (``frozen/flops.py``: the
active matrix parameters at the real tokens, causal attention at the real
lengths, the head once a sequence) over the window times the card's bf16
peak, in %."""
from frozen.flops import PEAK_FLOPS_BF16


def read(ctx):
    if not ctx["window_s"] or not ctx["useful_flops"]:
        return None
    return 100.0 * ctx["useful_flops"] / (ctx["window_s"] * PEAK_FLOPS_BF16)
