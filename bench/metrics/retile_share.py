"""Share of the window the store's background tuner spent re-encoding
tiles (``TunerStats.retile_s`` over the window, a program counter), in %:
0 where the layouts learned in set-up held."""


def read(ctx):
    if not ctx["window_s"]:
        return None
    return 100.0 * ctx["counters"]["retile_s"] / ctx["window_s"]
