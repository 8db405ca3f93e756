"""The solve path's wire messages in plain Python and numpy
(ref: kubebatch_tpu/rpc/solver_pb2.py, the protoc classes of
rpc/solver.proto, and rpc/victims_wire.py ``to_tensor`` / ``from_tensor``).

Nine proto3 messages: ``NodeTensors``, ``TaskTensors``, ``JobTensors``,
``PolicyTerms``, ``QueueTensors``, ``SnapshotRequest``, ``Decision``,
``DecisionsResponse`` and ``Tensor`` (the schema is this package's copy,
``solver.proto``). Each keeps the field names the reference code reads
(``req.nodes.idle``, ``req.terms.sig_pred``, ``resp.decisions``, ...) and
has ``SerializeToString()`` and ``FromString()``; the bytes equal what
protoc's classes write for the same message:

- fields in field-number order; a scalar at its default is left out (a
  float counts as default only when all its bits are zero, so -0.0 is
  written), a repeated field only when empty;
- packed repeated floats, int32s and bools are numpy buffers: assigning
  one converts it once (float32, int32, bool), and it is written and read
  in bulk (int32s as varints, negatives as ten bytes);
- a submessage is written when it is present: when the encoder assigned
  any of its fields (even an empty list or a default scalar, as protoc's
  classes count an ``extend([])``) or the parser met it.

Repeated strings and repeated messages are Python lists; append to them
in place. Nothing here imports protobuf or grpc.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

__all__ = ["NodeTensors", "TaskTensors", "JobTensors", "PolicyTerms",
           "QueueTensors", "SnapshotRequest", "Decision",
           "DecisionsResponse", "Tensor", "to_tensor", "from_tensor",
           "DecodeError"]

# field kinds
F32, I32, BOOL, STR, BYTES, MSG = "f32", "i32", "bool", "str", "bytes", "msg"
RF32, RI32, RBOOL, RSTR, RMSG = "rf32", "ri32", "rbool", "rstr", "rmsg"

_PACKED = {RF32: np.float32, RI32: np.int32, RBOOL: np.bool_}
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


class DecodeError(ValueError):
    """The bytes are not a well-formed message of this schema."""


# ---------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------

def _varint(v: int) -> bytes:
    """One varint; a negative int32 is its 64-bit two's complement."""
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _varints(arr: np.ndarray) -> bytes:
    """int32 values as a run of varints (vectorized)."""
    v = arr.astype(np.int64).view(np.uint64)
    if not v.size:
        return b""
    if int(v.max()) < 0x80:
        return v.astype(np.uint8).tobytes()
    shifts = np.arange(10, dtype=np.uint64) * np.uint64(7)
    groups = (v[:, None] >> shifts[None, :]) & np.uint64(0x7F)
    nbytes = np.ones(v.shape, np.int64)
    for k in range(1, 10):
        nbytes += (v >> shifts[k]) != 0
    cont = np.arange(10)[None, :] < (nbytes - 1)[:, None]
    groups = groups.astype(np.uint8) | np.where(cont, 0x80, 0).astype(
        np.uint8)
    return groups[np.arange(10)[None, :] < nbytes[:, None]].tobytes()


def _unvarints(data: bytes) -> np.ndarray:
    """A run of varints as int32 (two's complement truncation, as proto3
    reads an int32)."""
    b = np.frombuffer(data, np.uint8)
    if not b.size:
        return np.zeros(0, np.int32)
    if int(b.max()) < 0x80:
        return b.astype(np.int32)
    if b[-1] >= 0x80:
        raise DecodeError("truncated packed varints")
    ends = np.flatnonzero(b < 0x80)
    starts = np.concatenate(([0], ends[:-1] + 1))
    lengths = ends - starts + 1
    if int(lengths.max()) > 10:
        raise DecodeError("varint longer than ten bytes")
    pos = np.arange(b.size) - np.repeat(starts, lengths)
    contrib = (b & 0x7F).astype(np.uint64) << (pos.astype(np.uint64)
                                                * np.uint64(7))
    vals = np.add.reduceat(contrib, starts)
    return vals.view(np.int64).astype(np.int32)


def _key(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


# ---------------------------------------------------------------------
# the message base
# ---------------------------------------------------------------------

class _Message:
    """A proto3 message over a schema of (number, name, kind, class)."""

    _SCHEMA: Tuple[tuple, ...] = ()
    _BY_NUM: Dict[int, tuple] = {}
    _BY_NAME: Dict[str, tuple] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_NUM = {f[0]: f for f in cls._SCHEMA}
        cls._BY_NAME = {f[1]: f for f in cls._SCHEMA}

    def __init__(self, **fields):
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_present", False)
        d = self.__dict__
        for num, name, kind, sub in self._SCHEMA:
            if kind == MSG:
                child = sub()
                object.__setattr__(child, "_parent", self)
                d[name] = child
            else:
                d[name] = _default(kind)
        for name, value in fields.items():
            setattr(self, name, value)

    # -- presence --------------------------------------------------------
    def _mark(self) -> None:
        msg = self
        while msg is not None and not msg._present:
            object.__setattr__(msg, "_present", True)
            msg = msg._parent

    def __setattr__(self, name, value):
        field = self._BY_NAME.get(name)
        if field is None:
            raise AttributeError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
        _, _, kind, sub = field
        if kind == MSG:
            if not isinstance(value, sub):
                raise TypeError(f"{name} takes a {sub.__name__}")
            object.__setattr__(value, "_parent", self)
        else:
            value = _convert(kind, value, name)
        self.__dict__[name] = value
        self._mark()

    def HasField(self, name: str) -> bool:
        f = self._BY_NAME.get(name)
        if f is None or f[2] != MSG:
            raise ValueError(f"{name!r} is not a submessage field")
        return self.__dict__[name]._present

    # -- equality --------------------------------------------------------
    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        for _, name, kind, _ in self._SCHEMA:
            a, b = self.__dict__[name], other.__dict__[name]
            if kind in _PACKED:
                if a.shape != b.shape or a.tobytes() != b.tobytes():
                    return False
            elif kind == F32:
                if struct.pack("<f", a) != struct.pack("<f", b):
                    return False
            elif a != b:
                return False
        return True

    def __repr__(self):
        parts = []
        for _, name, kind, _ in self._SCHEMA:
            v = self.__dict__[name]
            if kind in _PACKED:
                parts.append(f"{name}=<{v.size} {v.dtype}>")
            elif kind in (RSTR, RMSG):
                parts.append(f"{name}=<{len(v)}>")
            else:
                parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    # -- encode ----------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        self._encode(out)
        return bytes(out)

    def _encode(self, out: bytearray) -> None:
        d = self.__dict__
        for num, name, kind, _ in self._SCHEMA:
            v = d[name]
            if kind == F32:
                raw = struct.pack("<f", v)
                if raw != b"\0\0\0\0":
                    out += _key(num, 5)
                    out += raw
            elif kind in (I32, BOOL):
                if v:
                    out += _key(num, 0)
                    out += _varint(int(v))
            elif kind in (STR, BYTES):
                if v:
                    raw = v.encode() if kind == STR else v
                    out += _key(num, 2)
                    out += _varint(len(raw))
                    out += raw
            elif kind in _PACKED:
                if v.size:
                    raw = (v.astype("<f4").tobytes() if kind == RF32
                           else v.astype(np.uint8).tobytes() if kind == RBOOL
                           else _varints(v))
                    out += _key(num, 2)
                    out += _varint(len(raw))
                    out += raw
            elif kind == RSTR:
                key = _key(num, 2)
                for s in v:
                    raw = s.encode()
                    out += key
                    out += _varint(len(raw))
                    out += raw
            elif kind == MSG:
                if v._present:
                    raw = v.SerializeToString()
                    out += _key(num, 2)
                    out += _varint(len(raw))
                    out += raw
            elif kind == RMSG:
                key = _key(num, 2)
                for m in v:
                    raw = m.SerializeToString()
                    out += key
                    out += _varint(len(raw))
                    out += raw

    # -- decode ----------------------------------------------------------
    @classmethod
    def FromString(cls, data: bytes):
        msg = cls()
        msg._decode(bytes(data), 0, len(data))
        return msg

    def _decode(self, buf: bytes, pos: int, end: int) -> None:
        d = self.__dict__
        packed_parts: Dict[str, list] = {}
        while pos < end:
            tag, pos = _read_varint(buf, pos)
            num, wire = tag >> 3, tag & 7
            field = self._BY_NUM.get(num)
            if (wire == 5 and pos + 4 > end) or (wire == 1 and pos + 8 > end):
                raise DecodeError("truncated fixed-width field")
            if wire == 2:
                n, pos = _read_varint(buf, pos)
                if pos + n > end:
                    raise DecodeError("truncated length-delimited field")
                chunk_end = pos + n
            if field is None:
                pos = _skip(buf, pos, wire, chunk_end if wire == 2 else 0)
                continue
            _, name, kind, sub = field
            if kind in _PACKED:
                if wire == 2:
                    raw = buf[pos:chunk_end]
                    vals = (np.frombuffer(raw, "<f4").astype(np.float32)
                            if kind == RF32 else _unvarints(raw))
                    pos = chunk_end
                elif wire == 5 and kind == RF32:
                    vals = np.frombuffer(buf[pos:pos + 4], "<f4")
                    pos += 4
                elif wire == 0 and kind != RF32:
                    v, pos = _read_varint(buf, pos)
                    vals = np.asarray([_as_int32(v)], np.int32)
                else:
                    raise DecodeError(f"{name}: wire type {wire}")
                packed_parts.setdefault(name, []).append(vals)
            elif kind == F32:
                if wire != 5:
                    raise DecodeError(f"{name}: wire type {wire}")
                d[name] = struct.unpack_from("<f", buf, pos)[0]
                pos += 4
            elif kind in (I32, BOOL):
                if wire != 0:
                    raise DecodeError(f"{name}: wire type {wire}")
                v, pos = _read_varint(buf, pos)
                d[name] = bool(v) if kind == BOOL else _as_int32(v)
            elif wire != 2:
                raise DecodeError(f"{name}: wire type {wire}")
            elif kind == STR:
                d[name] = buf[pos:chunk_end].decode()
                pos = chunk_end
            elif kind == BYTES:
                d[name] = buf[pos:chunk_end]
                pos = chunk_end
            elif kind == RSTR:
                d[name].append(buf[pos:chunk_end].decode())
                pos = chunk_end
            elif kind == MSG:
                child = d[name]
                child._decode(buf, pos, chunk_end)
                object.__setattr__(child, "_present", True)
                pos = chunk_end
            else:                                   # RMSG
                child = sub()
                child._decode(buf, pos, chunk_end)
                d[name].append(child)
                pos = chunk_end
        if pos != end:
            raise DecodeError("field overruns its message")
        for name, parts in packed_parts.items():
            kind = self._BY_NAME[name][2]
            vals = parts[0] if len(parts) == 1 else np.concatenate(parts)
            d[name] = vals.astype(_PACKED[kind])


def _default(kind):
    if kind in _PACKED:
        return np.zeros(0, _PACKED[kind])
    if kind in (RSTR, RMSG):
        return []
    return {F32: 0.0, I32: 0, BOOL: False, STR: "", BYTES: b""}[kind]


def _convert(kind, value, name):
    if kind in _PACKED:
        if kind == RI32:
            arr = np.asarray(value)
            if arr.dtype != np.int32:
                wide = arr.astype(np.int64)
                if wide.size and (wide.min() < _INT32_MIN
                                  or wide.max() > _INT32_MAX):
                    raise ValueError(f"{name}: value out of int32 range")
                arr = wide
            return np.ascontiguousarray(arr, np.int32).reshape(-1)
        return np.ascontiguousarray(value, _PACKED[kind]).reshape(-1)
    if kind == F32:
        return float(np.float32(value))
    if kind == I32:
        v = int(value)
        if not _INT32_MIN <= v <= _INT32_MAX:
            raise ValueError(f"{name}: value out of int32 range")
        return v
    if kind == BOOL:
        return bool(value)
    if kind == STR:
        if not isinstance(value, str):
            raise TypeError(f"{name} takes a str")
        return value
    if kind == BYTES:
        return bytes(value)
    return list(value)                               # RSTR, RMSG


def _as_int32(v: int) -> int:
    v &= (1 << 32) - 1
    return v - (1 << 32) if v >= 1 << 31 else v


def _skip(buf: bytes, pos: int, wire: int, chunk_end: int) -> int:
    """Step over an unknown field's value."""
    if wire == 0:
        return _read_varint(buf, pos)[1]
    if wire == 1:
        return pos + 8
    if wire == 2:
        return chunk_end
    if wire == 5:
        return pos + 4
    raise DecodeError(f"unsupported wire type {wire}")


# ---------------------------------------------------------------------
# the schema (solver.proto)
# ---------------------------------------------------------------------

class NodeTensors(_Message):
    _SCHEMA = ((1, "names", RSTR, None), (2, "idle", RF32, None),
               (3, "releasing", RF32, None), (4, "backfilled", RF32, None),
               (5, "max_task_num", RI32, None), (6, "n_tasks", RI32, None),
               (7, "schedulable", RBOOL, None))


class TaskTensors(_Message):
    _SCHEMA = ((1, "uids", RSTR, None), (2, "resreq", RF32, None),
               (3, "init_resreq", RF32, None), (4, "job_index", RI32, None),
               (5, "rank", RI32, None))


class JobTensors(_Message):
    _SCHEMA = ((1, "uids", RSTR, None), (2, "min_available", RI32, None),
               (3, "init_ready", RI32, None), (4, "queue_index", RI32, None),
               (5, "priority", RF32, None), (6, "create_rank", RI32, None),
               (7, "allocated", RF32, None))


class PolicyTerms(_Message):
    _SCHEMA = ((1, "n_sigs", I32, None), (2, "sig_pred", RBOOL, None),
               (3, "sig_scores", RF32, None), (4, "task_sig", RI32, None),
               (5, "least_requested_weight", F32, None),
               (6, "balanced_resource_weight", F32, None),
               (7, "task_nz", RF32, None), (8, "node_nz", RF32, None),
               (9, "allocatable_cm", RF32, None))


class QueueTensors(_Message):
    _SCHEMA = ((1, "names", RSTR, None), (2, "weight", RF32, None),
               (3, "deserved", RF32, None), (4, "allocated", RF32, None))


class Tensor(_Message):
    """dtype: 0 = float32, 1 = int32, 2 = bool; data: C-order bytes."""
    _SCHEMA = ((1, "shape", RI32, None), (2, "dtype", I32, None),
               (3, "data", BYTES, None))


class SnapshotRequest(_Message):
    _SCHEMA = ((1, "nodes", MSG, NodeTensors), (2, "tasks", MSG, TaskTensors),
               (3, "jobs", MSG, JobTensors), (4, "queues", MSG, QueueTensors),
               (5, "gang_enabled", BOOL, None),
               (6, "proportion_enabled", BOOL, None),
               (7, "drf_enabled", BOOL, None),
               (8, "priority_enabled", BOOL, None),
               (9, "cluster_total", RF32, None),
               (10, "job_order_keys", RSTR, None),
               (11, "terms", MSG, PolicyTerms),
               (12, "affinity", RMSG, Tensor),
               (13, "affinity_ip_weight", F32, None),
               (14, "affinity_ip_enabled", BOOL, None))


class Decision(_Message):
    """kind: 0 skip, 1 allocated, 2 allocated-over-backfill, 3 pipelined,
    4 failed; order: the global application order (-1 for a skip)."""
    _SCHEMA = ((1, "task_uid", STR, None), (2, "kind", I32, None),
               (3, "node_name", STR, None), (4, "order", I32, None))


class DecisionsResponse(_Message):
    _SCHEMA = ((1, "decisions", RMSG, Decision), (2, "solve_ms", F32, None),
               (3, "iterations", I32, None))


# ---------------------------------------------------------------------
# numpy <-> Tensor (ref: rpc/victims_wire.py)
# ---------------------------------------------------------------------

_DTYPES = {0: np.float32, 1: np.int32, 2: np.bool_}
_DTYPE_IDS = {np.dtype(np.float32): 0, np.dtype(np.int32): 1,
              np.dtype(np.bool_): 2}


def to_tensor(arr: np.ndarray) -> Tensor:
    """A C-order ``Tensor``; any other float dtype travels as float32,
    any other dtype as int32."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _DTYPE_IDS:
        floatish = np.issubdtype(arr.dtype, np.floating)
        arr = arr.astype(np.float32 if floatish else np.int32)
    return Tensor(shape=list(arr.shape), dtype=_DTYPE_IDS[arr.dtype],
                  data=arr.tobytes())


def from_tensor(t: Tensor) -> np.ndarray:
    arr = np.frombuffer(t.data, dtype=_DTYPES[t.dtype])
    return arr.reshape(tuple(int(s) for s in t.shape))
