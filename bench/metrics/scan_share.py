"""Share of the window the harness spent inside the store's scans (its host
spans around each ``execute()``), in %."""


def read(ctx):
    if not ctx["window_s"]:
        return None
    return 100.0 * ctx["spans"]["scan"] / ctx["window_s"]
