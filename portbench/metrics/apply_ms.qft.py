"""apply_ms.qft: the mean of the synchronised span around
QFTPipeline.forward (the zip-up apply), per signal."""


def read(rec):
    spans = rec.span_seconds("forward")
    return 1e3 * sum(spans) / len(spans) if spans else None
