"""Share of the positions the batcher prefilled that were left padding (a
wave pads every prompt to its longest), in %."""


def read(ctx):
    total = ctx["counters"]["prefill_positions"]
    return 100.0 * ctx["counters"]["padded_positions"] / total if total \
        else None
