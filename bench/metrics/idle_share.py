"""Share of the traced window in which nothing ran on the card (the window
less the union of its kernels, copies and fills), in %."""


def read(ctx):
    trace = ctx.get("device_trace")
    if trace is None or not trace["window_s"]:
        return None
    return 100.0 * (trace["window_s"] - trace["busy_s"]) / trace["window_s"]
