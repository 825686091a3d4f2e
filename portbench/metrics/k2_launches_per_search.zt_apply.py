"""k2_launches_per_search.zt_apply: K2 launches over the traced window (the
program's own counter), per pole search that succeeded."""


def read(rec):
    searches = sum(1 for r in rec.requests if r.ok)
    if "k2_launches" not in rec.counters or not searches:
        return None
    return rec.counters["k2_launches"] / searches
