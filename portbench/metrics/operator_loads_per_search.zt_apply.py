"""operator_loads_per_search.zt_apply: zT operators built or read from disk
over the traced window (the program's counters ``zt_mpo.builds`` and
``zt_mpo.loads``), per pole search that succeeded. None where the program
does not count them."""


def read(rec):
    searches = sum(1 for r in rec.requests if r.ok)
    if "operator_loads" not in rec.counters or not searches:
        return None
    return (rec.counters["operator_loads"]
            + rec.counters["operator_builds"]) / searches
