"""Zero-copy payload <-> bytes codec for cross-silo transport.

The port's copy of ``fedml_tpu/comm/serialization.py``. The reference
ships model state as pickled torch ``state_dict``s over MPI
(mpi_send_thread.py:27) or JSON float-lists over MQTT (fedavg/utils.py:12),
both of which copy and re-encode every float. Here a payload tree (dicts,
lists, tuples) of numpy arrays and scalars becomes:

    [u32 header_len][JSON header][raw buffer 0][raw buffer 1]...

where the header records the tree (a nested spec with leaf slots) and
each array's dtype and shape. Decoding builds numpy views straight into the
received buffer: no per-element work, no copies. Scalars, strings, bools
and None ride in the header; ``bytes`` ride as raw buffers. The JAX
package packs its header with msgpack; the port uses the standard
library's ``json``, so the two frames differ in their header bytes only
(and the port needs no msgpack). Torch tensors are converted by the
callers (``.cpu().numpy()``) before they reach the codec.
"""

from __future__ import annotations

import json
import struct
import threading
from typing import Any, List, Optional, Tuple

import numpy as np

_LEAF = "__leaf__"  # marker: {"__leaf__": buffer_index, "dtype", "shape"}


class SharedPayload:
    """Encode-once wrapper for a payload fanned out to N peers.

    A broadcast sends ONE model tree to every silo; wrapping it makes
    ``_encode`` splice the cached (spec, buffers) pair instead of
    re-walking the tree per peer, so the tree is encoded exactly once per
    wrapper and each per-peer frame differs only in its small envelope
    keys. The emitted bytes equal the uncached encoder's. Each broadcast
    wraps a fresh instance, which is the cache invalidation.

    Thread-safe: concurrent encodes race on the lock; the first wins and
    the rest reuse its result.
    """

    __slots__ = ("value", "_lock", "_spec", "_buffers", "encode_count")

    def __init__(self, value: Any):
        self.value = value
        self._lock = threading.Lock()
        self._spec: Optional[Any] = None
        self._buffers: Optional[List[bytes]] = None
        self.encode_count = 0  # test hook: encodes actually performed

    def _encoded(self) -> Tuple[Any, List[bytes]]:
        with self._lock:
            if self._spec is None:
                buffers: List[bytes] = []
                self._spec = _encode(self.value, buffers)
                self._buffers = buffers
                self.encode_count += 1
            return self._spec, self._buffers


def _rebase(spec: Any, base: int) -> Any:
    """Copy of ``spec`` with every buffer index shifted by ``base``, for a
    cached subtree spliced into a frame that already emitted buffers."""
    t = spec["t"]
    if t == "d":
        return {"t": "d", "k": spec["k"],
                "v": [_rebase(v, base) for v in spec["v"]]}
    if t in ("l", "u"):
        return {"t": t, "v": [_rebase(v, base) for v in spec["v"]]}
    if t in ("a", "b"):
        out = dict(spec)
        out[_LEAF] = spec[_LEAF] + base
        return out
    return spec


def _encode(obj: Any, buffers: List[bytes]) -> Any:
    if isinstance(obj, SharedPayload):
        spec, bufs = obj._encoded()
        base = len(buffers)
        buffers.extend(bufs)
        return spec if base == 0 else _rebase(spec, base)
    if isinstance(obj, dict):
        return {"t": "d", "k": list(obj.keys()),
                "v": [_encode(v, buffers) for v in obj.values()]}
    if isinstance(obj, (list, tuple)):
        return {"t": "l" if isinstance(obj, list) else "u",
                "v": [_encode(v, buffers) for v in obj]}
    if isinstance(obj, (bytes, bytearray)):
        buffers.append(bytes(obj))
        return {"t": "b", _LEAF: len(buffers) - 1}
    if isinstance(obj, np.ndarray):
        # the TRUE shape, captured before ascontiguousarray (which
        # promotes 0-d to (1,)): the compression layer's structure
        # fingerprints depend on it
        shape = list(obj.shape)
        arr = np.ascontiguousarray(obj)
        # flat byte view (len == nbytes even for ndim > 1), no copy; a
        # zero-size leaf ships an empty buffer slot
        buffers.append(arr.data.cast("B") if arr.size else b"")
        return {"t": "a", _LEAF: len(buffers) - 1, "dtype": arr.dtype.str,
                "shape": shape}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "s", "v": obj}
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return {"t": "s", "v": obj.item()}
    raise TypeError(f"unserializable payload leaf: {type(obj)}")


def _decode(spec: Any, buffers: List[memoryview]) -> Any:
    t = spec["t"]
    if t == "d":
        return {k: _decode(v, buffers)
                for k, v in zip(spec["k"], spec["v"])}
    if t == "l":
        return [_decode(v, buffers) for v in spec["v"]]
    if t == "u":
        return tuple(_decode(v, buffers) for v in spec["v"])
    if t == "a":
        buf = buffers[spec[_LEAF]]
        return np.frombuffer(buf, dtype=np.dtype(spec["dtype"])).reshape(
            spec["shape"])
    if t == "b":
        return bytes(buffers[spec[_LEAF]])
    return spec["v"]


#: the header is length-prefixed with a u32; a larger one would truncate
#: its own length field and desync every later frame, so it is refused
_MAX_HEADER = (1 << 32) - 1


def dumps_parts(tree: Any) -> List[Any]:
    """Serialize to the frame's constituent buffers without joining them:
    ``[u32 len][JSON header][raw buffer 0][raw buffer 1]...`` as a list, so
    a transport can write the parts without one contiguous copy."""
    buffers: List[bytes] = []
    spec = _encode(tree, buffers)
    header = json.dumps({"spec": spec, "sizes": [len(b) for b in buffers]},
                        separators=(",", ":")).encode()
    if len(header) > _MAX_HEADER:
        raise ValueError(
            f"serialized header is {len(header)} bytes, larger than the u32 "
            "length prefix can carry; refusing to emit a torn frame")
    return [struct.pack("<I", len(header)), header, *buffers]


def dumps(tree: Any) -> bytes:
    """Serialize a payload tree into one contiguous frame."""
    return b"".join(dumps_parts(tree))


def loads(frame) -> Any:
    """Decode a frame produced by ``dumps`` with numpy views into ``frame``
    (bytes, bytearray or memoryview)."""
    view = memoryview(frame)
    (hlen,) = struct.unpack_from("<I", view, 0)
    header = json.loads(bytes(view[4:4 + hlen]))
    buffers: List[memoryview] = []
    off = 4 + hlen
    for size in header["sizes"]:
        buffers.append(view[off:off + size])
        off += size
    return _decode(header["spec"], buffers)
