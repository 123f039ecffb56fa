"""Mean requests fused per coalesced launch over the window
(``Service.stats()``'s ``pg_sched_coalesce_width`` histogram)."""


def read(m):
    c = m["counters"]
    if "coalesce_count" not in c or not c["coalesce_count"]:
        return None
    return c["coalesce_sum"] / c["coalesce_count"]
