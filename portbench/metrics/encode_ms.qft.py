"""encode_ms.qft: the mean of the synchronised span around
QFTPipeline.encode, per signal."""


def read(rec):
    spans = rec.span_seconds("encode")
    return 1e3 * sum(spans) / len(spans) if spans else None
