"""Pixels the store decoded (``ScanStats.pixels_decoded``, summed over the
window's scans) per crop scored."""


def read(ctx):
    crops = ctx["counters"]["crops"]
    return ctx["counters"]["pixels_decoded"] / crops if crops else None
