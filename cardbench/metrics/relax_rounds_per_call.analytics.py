"""Frontier-engine rounds (``traverse/engine.rounds``, summed over the
verbs) per analytics call over the window."""


def read(m):
    n = len(m["records"])
    c = m["counters"]
    return c["rounds"] / n if n and "rounds" in c else None
