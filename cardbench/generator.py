"""The one generator that turns a traffic mix's parameters into requests.

A pattern mix names templates (``text`` with ``{NAME}`` placeholders) and
how each placeholder is drawn (``params``: a regular expression over
placeholder names, and ``int`` [low, high) or ``float`` [low, high) with
``digits``).  A template marked ``anchored`` takes some placeholders from
an anchor edge instead: the mix's ``anchors`` name, per placeholder, a
field of an edge drawn from the graph (``anchors()``), so that the request
is answered differently by a column held below the precision the store
holds it in.
Kinds come in shuffled rounds of one template each, so every seed sends
the same shares, and every request is drawn afresh.

Each client's stream depends only on (seed, stream, client) and, for
anchored templates, on the graph made from the same seed.
"""
from __future__ import annotations

import re

import numpy as np

WARM_STREAM, WINDOW_STREAM, SAMPLE_STREAM, ANCHOR_STREAM = 1, 2, 3, 4


def rng(seed: int, stream: int, client: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream, client])


def anchors(mix: dict, data: dict, seed: int):
    """``mix["anchors"]["count"]`` edges drawn from the seed among those
    whose endpoints both carry a label and which carry a relationship, with
    the fields the mix names, as host lists (None when the mix has no
    anchors).  Fields: ``src_label``, ``dst_label`` and ``relationship``
    (attribute ids; where an entity has several, the largest id),
    ``src_below:<column>`` (the source's integer value of ``column`` less
    one: the source matches ``>`` it), and ``next_up:<column>:<dtype>``
    (the edge's value of ``column`` in ``dtype``, the type the store holds
    it in, raised by one unit in the last place and printed exactly: the
    edge matches ``<`` it, and a copy of the column in a lower precision
    does not)."""
    import torch

    spec = mix.get("anchors")
    if not spec:
        return None
    src, dst, n, m = data["esrc"], data["edst"], data["n"], data["m"]
    dev = src.device

    def largest(size, ents, ids):
        return torch.full((size,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
            0, ents.to(dev), ids.to(dev, torch.int64), "amax")

    vlab = largest(n, data["label_ent"], data["label_id"])
    erel = largest(m, data["rel_ent"], data["rel_id"])
    ok = torch.nonzero((erel >= 0) & (vlab[src] >= 0) & (vlab[dst] >= 0)).squeeze(1)
    g = torch.Generator(device=dev).manual_seed(
        (int(seed) * 1_000_003 + ANCHOR_STREAM) % 2**63)
    pick = ok[torch.randint(0, len(ok), (int(spec["count"]),), generator=g, device=dev)]
    out = {}
    for name, field in spec["fields"].items():
        if field == "src_label":
            vals = vlab[src[pick]]
        elif field == "dst_label":
            vals = vlab[dst[pick]]
        elif field == "relationship":
            vals = erel[pick]
        elif field.startswith("src_below:"):
            vals = data["vprops"][field.split(":", 1)[1]][src[pick]] - 1
        elif field.startswith("next_up:"):
            _, column, dtype = field.split(":")
            col = data["eprops"][column][pick].to(getattr(torch, dtype))
            vals = torch.nextafter(col, torch.full_like(col, float("inf"))).double()
        else:
            raise KeyError(f"unknown anchor field {field!r}")
        out[name] = vals.cpu().tolist()
    return out


def _print(value) -> str:
    if isinstance(value, float):
        return np.format_float_positional(value, unique=True, trim="0")
    return str(value)


class PatternStream:
    def __init__(self, mix: dict, seed: int, stream: int, client: int, anchored=None):
        self._rng = rng(seed, stream, client)
        self._templates = mix["templates"]
        self._params = [(re.compile(p["match"]), p) for p in mix["params"]]
        self._anchored = anchored
        self._round: list = []

    def _value(self, name: str, r):
        for pattern, spec in self._params:
            if pattern.fullmatch(name):
                lo, hi = spec["range"]
                if spec["type"] == "int":
                    return str(int(r.integers(lo, hi)))
                return f"{lo + (hi - lo) * r.random():.{spec['digits']}f}"
        raise KeyError(f"no parameter rule for placeholder {name!r}")

    def next(self):
        """(kind, pattern text)."""
        r = self._rng
        if not self._round:
            self._round = list(range(len(self._templates)))
            r.shuffle(self._round)
        t = self._templates[self._round.pop()]
        names = set(re.findall(r"\{([A-Za-z_][A-Za-z0-9_]*)\}", t["text"]))
        fixed = {}
        if t.get("anchored"):
            if self._anchored is None:
                raise ValueError(f"template {t['kind']!r} is anchored; the stream has no anchors")
            i = int(r.integers(len(next(iter(self._anchored.values())))))
            fixed = {k: _print(v[i]) for k, v in self._anchored.items() if k in names}
        return t["kind"], t["text"].format(
            **{k: fixed[k] if k in fixed else self._value(k, r) for k in sorted(names)})
