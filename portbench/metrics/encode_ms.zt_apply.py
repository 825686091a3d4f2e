"""encode_ms.zt_apply: the mean of the synchronised spans around
ZTPipeline.encode (the rsvd encode of one 2^n-sample signal) that start in
the window, per search. The set-up's warm-up request records one too, and
on a checkout's first run it holds the kernels' build."""


def read(rec):
    spans = [t1 - t0 for name, t0, t1 in rec.spans
             if name == "encode" and t0 >= rec.window[0]]
    return 1e3 * sum(spans) / len(spans) if spans else None
