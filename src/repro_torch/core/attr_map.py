"""Attribute string→integer remapping (§V step 1 of the paper).

Arkouda performs the "remap attribute values to an integer identifier" step with
its string/groupby machinery on the host; the device-side DIP stores only ever
see dense int ids.  This module is the host-side equivalent: a stable,
order-preserving interning table with numpy-vectorized encode/decode.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Union

import numpy as np

__all__ = ["AttributeMap"]


class AttributeMap:
    """Stable bidirectional map ``attribute value (str) <-> dense int id``.

    Ids are assigned in first-seen order; the table only grows (static property
    graphs never retire attributes).  ``decode`` uses the "sorted array" lookup
    the paper describes for DIP-ARR row recovery (Fig. 4 caption) — here it is a
    plain list index because ids are dense.
    """

    def __init__(self, values: Iterable[str] = ()):  # noqa: D401
        self._to_id: Dict[str, int] = {}
        self._to_val: List[str] = []
        if values:
            self.encode(list(values))

    # -- encoding ---------------------------------------------------------
    def encode(self, values: Union[str, Sequence[str], np.ndarray]) -> np.ndarray:
        """Intern value(s); returns int32 id array (scalar input → shape ())."""
        scalar = isinstance(values, str)
        vals = [values] if scalar else list(np.asarray(values, dtype=object).ravel())
        out = np.empty(len(vals), dtype=np.int32)
        to_id = self._to_id
        to_val = self._to_val
        for i, v in enumerate(vals):
            v = str(v)
            ident = to_id.get(v)
            if ident is None:
                ident = len(to_val)
                to_id[v] = ident
                to_val.append(v)
            out[i] = ident
        return out[0] if scalar else out

    def lookup(self, values: Union[str, Sequence[str]]) -> np.ndarray:
        """Encode without interning; unknown values map to -1 (empty query)."""
        scalar = isinstance(values, str)
        vals = [values] if scalar else list(values)
        out = np.array([self._to_id.get(str(v), -1) for v in vals], dtype=np.int32)
        return out[0] if scalar else out

    # -- decoding ---------------------------------------------------------
    def decode(self, ids: Union[int, Sequence[int], np.ndarray]) -> Union[str, List[str]]:
        if np.isscalar(ids) or getattr(ids, "ndim", 1) == 0:
            return self._to_val[int(ids)]
        return [self._to_val[int(i)] for i in np.asarray(ids).ravel()]

    # -- protocol ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._to_val)

    def __contains__(self, value: str) -> bool:
        return str(value) in self._to_id

    @property
    def values(self) -> List[str]:
        return list(self._to_val)

    def mask(self, values: Union[str, Sequence[str]], k: int) -> np.ndarray:
        """Boolean (k,) query mask over the attribute set — the device-side
        query format.  Unknown values are simply absent from the mask, and so
        are ids ≥ k: a store sealed at ``k`` attributes can be queried for
        values interned later (the overlay's delta buffers answer those)."""
        ids = np.atleast_1d(self.lookup(values))
        mask = np.zeros(k, dtype=bool)
        mask[ids[(ids >= 0) & (ids < k)]] = True
        return mask
