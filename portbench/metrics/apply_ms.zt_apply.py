"""apply_ms.zt_apply: the zip-up applies of the window (the synchronised
spans around the program's ``_apply_fused``, two a pole search on the
apply readout), summed per search."""


def read(rec):
    spans = rec.span_seconds("apply_fused")
    searches = sum(1 for r in rec.requests if r.ok)
    return 1e3 * sum(spans) / searches if spans and searches else None
