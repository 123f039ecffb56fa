"""Wire codec for the pgd network front-end — length-prefixed JSON + binary.

Arachne rides Arkouda's request/reply server: a thin Python client sends
small messages naming server-held objects, the server answers with small
metadata plus (when needed) bulk array payloads (paper §III,
docs/ARCHITECTURE.md §9).  This module is that message format for the
analytics service — one codec shared by ``server.py`` and ``client.py`` so
the two can never disagree about framing.

Frame layout (all integers big-endian)::

    MAGIC (4 bytes, b"PGW1")
    payload_len   uint32        # bytes after this field
    header_len    uint32        # JSON part of the payload
    header        UTF-8 JSON    # op/id/fields + "arrays": [spec, ...]
    blob          bytes         # the arrays' buffers, concatenated

The header is small and human-debuggable JSON; bulk data (masks, id
arrays, property columns) travels as raw buffers described by per-array
specs ``{"dtype", "shape"}`` appended by the codec.  Bool arrays are
``np.packbits(bitorder="little")``-packed on the wire (8× smaller) and
restored exactly — mask round-trips are bitwise, which the cross-process
equivalence gate relies on (``pgserve --net --smoke``).  Little-endian bit
order makes the wire bytes IDENTICAL to the ``core.bitplane`` word plane's
byte view, so a mask the server already holds packed ships verbatim
(:class:`PackedMask` — no unpack→repack; ``result_to_wire`` packs torch
masks on their own device and hands the codec the raw words).

The format is the reference package's, byte for byte: the same header and
the same masks give the same frame from either package, so each package's
client talks to the other's server.  ``torch`` is imported only where a
torch mask is packed, so a client that sends numpy payloads needs none.

``recv_msg`` raises ``ConnectionError`` on a clean EOF at a frame
boundary (peer closed) and ``ProtocolError`` on everything else —
truncated frames, bad magic, oversized payloads.
"""
from __future__ import annotations

import dataclasses
import json
import socket
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "MAGIC",
    "MAX_PAYLOAD",
    "ProtocolError",
    "RemoteError",
    "PackedMask",
    "encode_msg",
    "send_msg",
    "recv_msg",
    "result_to_wire",
    "wire_to_result",
    "WireMatchResult",
    "WireSampledBlock",
    "blocks_to_wire",
    "wire_to_blocks",
    "exc_to_wire",
    "wire_to_exc",
]

MAGIC = b"PGW1"
MAX_PAYLOAD = 1 << 30  # 1 GiB — fail fast on garbage length prefixes
_LEN = struct.Struct("!I")

# process-global frame/byte accounting (docs/ARCHITECTURE.md §13); the
# counters are resolved once at import so the per-frame cost with metrics
# ON is two lock+add pairs, and with metrics OFF a single flag check
from repro_torch.obs.metrics import enabled as _obs_enabled  # noqa: E402


def _wire_counters(direction: str):
    from repro_torch.obs.metrics import GLOBAL

    return (GLOBAL.counter("pg_wire_frames", "wire frames", dir=direction),
            GLOBAL.counter("pg_wire_bytes", "wire bytes", dir=direction))


_SENT = _wire_counters("sent")
_RECEIVED = _wire_counters("received")


class ProtocolError(RuntimeError):
    """Malformed frame: bad magic, truncated payload, oversized length."""


class RemoteError(RuntimeError):
    """A server-side exception type we cannot reconstruct locally."""

    def __init__(self, type_name: str, message: str):
        super().__init__(f"{type_name}: {message}")
        self.type_name = type_name
        self.message = message


# ------------------------------------------------------------------ arrays
@dataclasses.dataclass(frozen=True)
class PackedMask:
    """A (n,) bool mask already bit-packed in ``core.bitplane`` layout.

    The codec ships its little-endian byte view verbatim (tail bits are
    zero by the bitplane invariant, exactly what ``np.packbits`` would
    emit) and the receiver sees a plain bool array — senders holding
    packed words skip the unpack→repack round-trip entirely."""

    words: np.ndarray  # (ceil(n/32),) uint32, little-endian bit order
    n: int


def _pack_array(a) -> Tuple[dict, bytes]:
    if isinstance(a, PackedMask):
        spec = {"dtype": "bool", "shape": [int(a.n)]}
        nbytes = (int(a.n) + 7) // 8
        words = np.ascontiguousarray(np.asarray(a.words, dtype="<u4"))
        return spec, words.view(np.uint8)[:nbytes].tobytes()
    a = np.ascontiguousarray(a)
    spec = {"dtype": str(a.dtype), "shape": list(a.shape)}
    if a.dtype == np.bool_:
        return spec, np.packbits(a.reshape(-1), bitorder="little").tobytes()
    return spec, a.tobytes()


def _parse_spec(spec) -> Tuple[np.dtype, Tuple[int, ...], int]:
    """Validate an untrusted array spec → (dtype, shape, element count);
    anything off is ``ProtocolError`` (a corrupt frame must never surface
    as a raw numpy error — the server session and client loops only handle
    protocol exceptions).  The count is computed with Python ints, so an
    absurd shape cannot overflow into a plausible-looking size."""
    try:
        dtype = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"bad array spec {spec!r}: {e}") from None
    if dtype.hasobject or not all(
            isinstance(d, int) and 0 <= d <= MAX_PAYLOAD for d in shape):
        raise ProtocolError(f"bad array spec {spec!r}")
    count = 1
    for d in shape:
        count *= d
    if count * max(dtype.itemsize, 1) > MAX_PAYLOAD:
        raise ProtocolError(f"bad array spec {spec!r}: too large")
    return dtype, shape, count


def _blob_nbytes(dtype: np.dtype, count: int) -> int:
    if dtype == np.bool_:
        return (count + 7) // 8
    return count * dtype.itemsize


def _unpack_array(dtype: np.dtype, shape: Tuple[int, ...], count: int,
                  buf: memoryview) -> np.ndarray:
    if dtype == np.bool_:
        bits = np.unpackbits(np.frombuffer(buf, np.uint8), count=count,
                             bitorder="little")
        return bits.astype(np.bool_).reshape(shape)
    return np.frombuffer(buf, dtype=dtype, count=count).reshape(shape)


# ------------------------------------------------------------------ framing
def encode_msg(header: Dict, arrays: Sequence[np.ndarray] = ()) -> bytes:
    """One complete frame.  ``header`` must be JSON-serializable; the codec
    owns the ``"arrays"`` key."""
    specs, blobs = [], []
    for a in arrays:
        spec, blob = _pack_array(a if isinstance(a, PackedMask)
                                 else np.asarray(a))
        specs.append(spec)
        blobs.append(blob)
    hdr = dict(header)
    hdr["arrays"] = specs
    hbytes = json.dumps(hdr, sort_keys=True).encode("utf-8")
    payload_len = _LEN.size + len(hbytes) + sum(len(b) for b in blobs)
    if payload_len > MAX_PAYLOAD:
        raise ProtocolError(f"frame too large: {payload_len} bytes")
    parts = [MAGIC, _LEN.pack(payload_len), _LEN.pack(len(hbytes)), hbytes]
    parts.extend(blobs)
    return b"".join(parts)


def send_msg(sock: socket.socket, header: Dict,
             arrays: Sequence[np.ndarray] = ()) -> None:
    buf = encode_msg(header, arrays)
    if _obs_enabled():
        frames, nbytes = _SENT
        frames.inc()
        nbytes.inc(len(buf))
    sock.sendall(buf)


def _recv_exact(sock: socket.socket, n: int, *, at_boundary: bool) -> bytes:
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if at_boundary and got == 0:
                raise ConnectionError("peer closed the connection")
            raise ProtocolError(f"truncated frame: wanted {n} bytes, got {got}")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> Tuple[Dict, List[np.ndarray]]:
    """Read one frame → ``(header, arrays)``; blocks until complete."""
    head = _recv_exact(sock, len(MAGIC) + _LEN.size, at_boundary=True)
    if _obs_enabled():
        frames, nbytes = _RECEIVED
        frames.inc()
        nbytes.inc(len(head))
    if head[: len(MAGIC)] != MAGIC:
        raise ProtocolError(f"bad magic {head[:len(MAGIC)]!r}")
    (payload_len,) = _LEN.unpack(head[len(MAGIC):])
    if payload_len > MAX_PAYLOAD or payload_len < _LEN.size:
        raise ProtocolError(f"bad payload length {payload_len}")
    payload = memoryview(_recv_exact(sock, payload_len, at_boundary=False))
    if _obs_enabled():
        _RECEIVED[1].inc(payload_len)
    (header_len,) = _LEN.unpack(payload[: _LEN.size])
    if _LEN.size + header_len > payload_len:
        raise ProtocolError(f"bad header length {header_len}")
    try:
        header = json.loads(bytes(payload[_LEN.size:_LEN.size + header_len]))
    except ValueError as e:
        raise ProtocolError(f"bad header JSON: {e}") from None
    specs = header.pop("arrays", []) if isinstance(header, dict) else None
    if not isinstance(specs, list):
        raise ProtocolError("header is not an object with an array list")
    arrays: List[np.ndarray] = []
    off = _LEN.size + header_len
    for spec in specs:
        dtype, shape, count = _parse_spec(spec)
        n = _blob_nbytes(dtype, count)
        if off + n > payload_len:
            raise ProtocolError("array blobs exceed payload")
        arrays.append(_unpack_array(dtype, shape, count, payload[off:off + n]))
        off += n
    return header, arrays


# ------------------------------------------------------------ MatchResult
@dataclasses.dataclass(frozen=True)
class WireMatchResult:
    """Client-side view of a ``query.executor.MatchResult``.

    Carries the participation masks and name-keyed bindings (computed
    server-side — the ``Plan`` object itself never crosses the wire); the
    mask payloads are bitwise-identical to the in-process result's.
    """

    vertex_mask: np.ndarray  # (n,) bool
    edge_mask: np.ndarray  # (m,) bool
    _bindings: Dict[str, np.ndarray]

    def bindings(self) -> Dict[str, np.ndarray]:
        return dict(self._bindings)

    def n_vertices(self) -> int:
        return int(self.vertex_mask.sum())

    def n_edges(self) -> int:
        return int(self.edge_mask.sum())


def _mask_payload(mask):
    """A 1-D bool torch mask packs on its own device into bitplane words
    (int32, the uint32 bits, read through ``.view``) and ships as
    :class:`PackedMask` — the codec's wire bytes without a byte-per-entity
    host copy.  Anything else (host arrays, non-bool) goes through the
    generic path."""
    try:
        import torch

        from repro_torch.core import bitplane
    except ImportError:  # torch-free client process
        return np.asarray(mask)
    if torch.is_tensor(mask):
        if mask.dtype == torch.bool and mask.dim() == 1:
            n = int(mask.shape[0])
            words = bitplane.pack_mask(mask).cpu().numpy().view(np.uint32)
            return PackedMask(words=words, n=n)
        return mask.cpu().numpy()
    return np.asarray(mask)


def result_to_wire(res) -> Tuple[Dict, List[np.ndarray]]:
    """``MatchResult`` → (meta, arrays): masks first, bindings after in
    ``meta["vars"]`` order.  Masks travel bit-packed end to end."""
    bindings = res.bindings()
    names = sorted(bindings)
    arrays = [_mask_payload(res.vertex_mask), _mask_payload(res.edge_mask)]
    arrays.extend(_mask_payload(bindings[k]) for k in names)
    return {"vars": names}, arrays


def _as_bool_mask(a) -> np.ndarray:
    """Normalize a result payload to a (n,) bool array.  The codec already
    delivers bool (``_unpack_array``); in-process callers that short-circuit
    the transport may hand back the ``PackedMask`` from ``result_to_wire``
    (possibly wrapped in a 0-d object array by ``np.asarray``) — unpack it
    host-side (numpy only, so torch-free clients stay torch-free)."""
    if isinstance(a, np.ndarray) and a.dtype == object and a.ndim == 0:
        a = a.item()
    if isinstance(a, PackedMask):
        words = np.ascontiguousarray(np.asarray(a.words, dtype="<u4"))
        bits = np.unpackbits(words.view(np.uint8), bitorder="little")
        return bits[:a.n].astype(bool)
    return np.asarray(a)


def wire_to_result(meta: Dict, arrays: Sequence[np.ndarray]) -> WireMatchResult:
    names = meta["vars"]
    if len(arrays) != 2 + len(names):
        raise ProtocolError(
            f"result carries {len(arrays)} arrays for {len(names)} vars")
    arrays = [_as_bool_mask(a) for a in arrays]
    return WireMatchResult(
        vertex_mask=arrays[0], edge_mask=arrays[1],
        _bindings=dict(zip(names, arrays[2:])),
    )


# ------------------------------------------------------------ SampledBlock
@dataclasses.dataclass(frozen=True)
class WireSampledBlock:
    """Client-side view of one ``graph.sampler.SampledBlock`` layer.

    Same field contract (ids are the server graph's INTERNAL ids, edge_*
    are local indices into src_nodes/dst_nodes, edge_mask False = padded
    slot) in plain numpy.  Payloads are
    bitwise the in-process blocks': the deterministic-mode wire-parity
    gate in ``pgserve --net --smoke`` depends on that.
    """

    src_nodes: np.ndarray  # (n_src,) int32
    dst_nodes: np.ndarray  # (n_dst,) int32
    edge_src: np.ndarray  # (n_edges,) int32 local
    edge_dst: np.ndarray  # (n_edges,) int32 local
    edge_mask: np.ndarray  # (n_edges,) bool

    @property
    def n_src(self) -> int:
        return int(self.src_nodes.shape[0])

    @property
    def n_dst(self) -> int:
        return int(self.dst_nodes.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])


def blocks_to_wire(blocks) -> Tuple[Dict, List[np.ndarray]]:
    """SampledBlock list → (meta, arrays): five arrays per layer in block
    order (src_nodes, dst_nodes, edge_src, edge_dst, edge_mask) — the id/
    index arrays as int32 blobs, the mask bit-packed by the codec (§15's
    "blocks ship as packed masks + index arrays")."""
    arrays: List[np.ndarray] = []
    for b in blocks:
        arrays.append(np.asarray(b.src_nodes, np.int32))
        arrays.append(np.asarray(b.dst_nodes, np.int32))
        arrays.append(np.asarray(b.edge_src, np.int32))
        arrays.append(np.asarray(b.edge_dst, np.int32))
        arrays.append(_mask_payload(b.edge_mask))
    return {"layers": len(blocks)}, arrays


def wire_to_blocks(meta: Dict, arrays: Sequence[np.ndarray]
                   ) -> List[WireSampledBlock]:
    layers = int(meta["layers"])
    if len(arrays) != 5 * layers:
        raise ProtocolError(
            f"sample result carries {len(arrays)} arrays for {layers} layers")
    blocks = []
    for li in range(layers):
        s, d, es, ed, em = arrays[5 * li:5 * li + 5]
        blocks.append(WireSampledBlock(
            src_nodes=np.asarray(s, np.int32),
            dst_nodes=np.asarray(d, np.int32),
            edge_src=np.asarray(es, np.int32),
            edge_dst=np.asarray(ed, np.int32),
            edge_mask=_as_bool_mask(em),
        ))
    return blocks


# -------------------------------------------------------------- exceptions
def exc_to_wire(e: BaseException) -> Dict[str, str]:
    return {"type": type(e).__name__, "message": str(e)}


def wire_to_exc(d: Dict[str, str]) -> BaseException:
    """Rebuild a builtin exception when possible (so ``pytest.raises
    (KeyError)`` works across the wire), ``RemoteError`` otherwise."""
    cls = getattr(__builtins__, d["type"], None) if not isinstance(
        __builtins__, dict) else __builtins__.get(d["type"])
    if isinstance(cls, type) and issubclass(cls, Exception):
        try:
            return cls(d["message"])
        except Exception:  # noqa: BLE001 — odd constructor signature
            pass
    return RemoteError(d["type"], d["message"])
