"""The attention kernel's share of its roofline, in %: the least time of
each call at its shapes (``frozen/flops.py::attention_call``) summed, over
the device time of the kernels named ``flash_attention`` in the trace.
Nothing where the trace holds no such kernel, or the program's launch
counter disagrees with the calls the loop made."""
from frozen.flops import attention_call


def read(ctx):
    trace = ctx.get("device_trace")
    calls = ctx["attention_calls"]
    if trace is None or sum(calls.values()) != \
            ctx["launches"]["flash_attention"]:
        return None
    spent = sum(s for name, s in trace["kernel_s"].items()
                if "flash_attention" in name and "bwd" not in name)
    if not spent:
        return None
    least = sum(n * attention_call(*shape)[2] for shape, n in calls.items())
    return 100.0 * least / spent
