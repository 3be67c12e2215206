"""framework.proto's messages as a proto2 wire codec in plain Python.

Counterpart of paddle_tpu/fluid/proto/framework_pb2.py, which protoc
generated and which imports ``google.protobuf``; this module needs
neither. It gives the messages and fields that ``framework.py`` and
``io.py`` use the same names: ``ProgramDesc``, ``BlockDesc``, ``VarDesc``,
``VarType`` (with ``TensorDesc``, ``LoDTensorDesc`` and the ``Type``
values as class attributes), ``OpDesc`` (with ``Var`` and ``Attr``),
``Version``, the ``AttrType`` values as module attributes (``INT``,
``FLOAT``, ...), and ``SerializeToString`` / ``ParseFromString``.

The bytes are protobuf's for the same message:
  * fields are written in field-number order, not declaration order;
  * an optional field is written exactly when it was set (a sub-message
    when one of its fields was set, however deep);
  * repeated scalars are written unpacked (proto2); a parse takes both
    forms;
  * a negative int32, int64 or enum is a 10-byte varint;
  * ``float`` is fixed32, little-endian: a Python float is rounded to
    float32 when it is set, as protobuf does;
  * unknown fields are skipped on parse.
A missing required field raises at serialization, as protobuf's
``EncodeError`` does.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

_OPT, _REQ, _REP = 0, 1, 2
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


class EncodeError(ValueError):
    pass


class DecodeError(ValueError):
    pass


class _F:
    """One field: number, name, kind ('int32', 'int64', 'enum', 'bool',
    'float', 'string', or a message class), label and proto2 default."""

    __slots__ = ("number", "name", "kind", "label", "default")

    def __init__(self, number, name, kind, label=_OPT, default=None):
        self.number = number
        self.name = name
        self.kind = kind
        self.label = label
        if default is None and not isinstance(kind, type):
            default = {"string": "", "bool": False, "float": 0.0}.get(kind, 0)
        self.default = default

    @property
    def is_message(self):
        return isinstance(self.kind, type)


def _f32(v) -> float:
    """``v`` rounded to float32, as a float field stores it."""
    with np.errstate(over="ignore"):
        return float(np.float32(float(v)))


def _check(f: _F, v):
    k = f.kind
    if k in ("int32", "int64", "enum"):
        if isinstance(v, (bool, float)) or not isinstance(v, (int, np.integer)):
            raise TypeError(f"field {f.name}: expected int, got {v!r}")
        v = int(v)
        bits = 64 if k == "int64" else 32
        if not -(1 << (bits - 1)) <= v < (1 << (bits - 1)):
            raise ValueError(f"field {f.name}: {v} out of int{bits} range")
        return v
    if k == "bool":
        return bool(v)
    if k == "float":
        return _f32(v)
    if k == "string":
        if isinstance(v, bytes):
            v = v.decode("utf-8")
        if not isinstance(v, str):
            raise TypeError(f"field {f.name}: expected str, got {v!r}")
        return v
    raise TypeError(f"field {f.name}: a message field cannot be assigned")


class _Repeated(list):
    """A repeated field: a list that marks its message present when it
    grows (a lazily made sub-message becomes part of its parent)."""

    __slots__ = ("_owner", "_field")

    def __init__(self, owner, field):
        super().__init__()
        self._owner = owner
        self._field = field

    def _conv(self, v):
        f = self._field
        if f.is_message:
            if not isinstance(v, f.kind):
                raise TypeError(f"field {f.name}: expected {f.kind.__name__}")
            return v
        return _check(f, v)

    def append(self, v):
        super().append(self._conv(v))
        self._owner._mark_present()

    def extend(self, vs):
        vs = [self._conv(v) for v in vs]
        super().extend(vs)
        if vs:
            self._owner._mark_present()

    def add(self):
        m = self._field.kind()
        super().append(m)
        self._owner._mark_present()
        return m

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            v = [self._conv(x) for x in v]
        else:
            v = self._conv(v)
        super().__setitem__(i, v)


class Message:
    """Base of the messages below: fields as attributes, protobuf's
    presence rules, and the wire codec."""

    _FIELDS: Tuple[_F, ...] = ()
    _BY_NAME: Dict[str, _F] = {}
    _BY_NUMBER: Dict[int, _F] = {}
    _ORDER: Tuple[_F, ...] = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._finish()

    @classmethod
    def _finish(cls):
        """Index the class's own fields; called again for a class whose
        fields are set after its body (they name a later class)."""
        fields = cls.__dict__.get("_FIELDS", ())
        cls._BY_NAME = {f.name: f for f in fields}
        cls._BY_NUMBER = {f.number: f for f in fields}
        cls._ORDER = tuple(sorted(fields, key=lambda f: f.number))

    def __init__(self):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_lazy", {})
        object.__setattr__(self, "_owner", None)

    @classmethod
    def _field(cls, name) -> _F:
        f = cls._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{cls.__name__} has no field {name!r}")
        return f

    # -- presence ----------------------------------------------------------
    def _mark_present(self):
        owner = self._owner
        if owner is not None:
            parent, name = owner
            object.__setattr__(self, "_owner", None)
            parent._lazy.pop(name, None)
            parent._values[name] = self
            parent._mark_present()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        f = self._field(name)
        vals = self._values
        if name in vals:
            return vals[name]
        if f.label == _REP:
            r = vals[name] = _Repeated(self, f)
            return r
        if f.is_message:
            child = self._lazy.get(name)
            if child is None:
                child = self._lazy[name] = f.kind()
                object.__setattr__(child, "_owner", (self, name))
            return child
        return f.default

    def __setattr__(self, name, value):
        f = self._field(name)
        if f.label == _REP or f.is_message:
            raise AttributeError(
                f"assignment to {'repeated' if f.label == _REP else 'message'}"
                f" field {name!r} is not allowed")
        self._values[name] = _check(f, value)
        self._mark_present()

    def HasField(self, name) -> bool:
        f = self._field(name)
        if f.label == _REP:
            raise ValueError(f"{name!r} is a repeated field")
        return name in self._values

    def Clear(self):
        self._values.clear()
        self._lazy.clear()

    # -- encoding ----------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        self._encode(out)
        return bytes(out)

    def _encode(self, out: bytearray):
        vals = self._values
        for f in self._ORDER:
            v = vals.get(f.name)
            if v is None:
                if f.label == _REQ:
                    raise EncodeError(f"{type(self).__name__}: required "
                                      f"field {f.name!r} is not set")
                continue
            if f.label == _REP:
                for x in v:
                    _put(out, f, x)
            else:
                _put(out, f, v)

    # -- decoding ----------------------------------------------------------
    def ParseFromString(self, data: bytes) -> int:
        self.Clear()
        self.MergeFromString(data)
        return len(data)

    def MergeFromString(self, data) -> int:
        data = bytes(data)
        self._decode(memoryview(data), 0, len(data))
        return len(data)

    def _decode(self, buf, pos, end):
        by_number = self._BY_NUMBER
        vals = self._values
        while pos < end:
            tag, pos = _get_varint(buf, pos)
            number, wt = tag >> 3, tag & 7
            f = by_number.get(number)
            if f is None:
                pos = _skip(buf, pos, wt)
                continue
            if wt == _LEN and (f.is_message or f.kind == "string"):
                n, pos = _get_varint(buf, pos)
                if pos + n > end:
                    raise DecodeError("truncated length-delimited field")
                if f.is_message:
                    if f.label == _REP:
                        m = f.kind()
                        m._decode(buf, pos, pos + n)
                        list.append(self._rep(f), m)
                    else:
                        m = vals.get(f.name)
                        if m is None:
                            m = self._lazy.pop(f.name, None) or f.kind()
                            object.__setattr__(m, "_owner", None)
                            vals[f.name] = m
                        m._decode(buf, pos, pos + n)
                else:
                    s = bytes(buf[pos:pos + n]).decode("utf-8")
                    if f.label == _REP:
                        list.append(self._rep(f), s)
                    else:
                        vals[f.name] = s
                pos += n
            elif wt == _LEN and f.label == _REP:  # a packed scalar run
                n, pos = _get_varint(buf, pos)
                stop = pos + n
                rep = self._rep(f)
                while pos < stop:
                    v, pos = _get_scalar(buf, pos, f, _wire_of(f))
                    list.append(rep, v)
            elif wt == _wire_of(f):
                v, pos = _get_scalar(buf, pos, f, wt)
                if f.label == _REP:
                    list.append(self._rep(f), v)
                else:
                    vals[f.name] = v
            else:
                raise DecodeError(f"{type(self).__name__}.{f.name}: wire "
                                  f"type {wt} does not fit {f.kind}")
        if pos != end:
            raise DecodeError("truncated message")

    def _rep(self, f) -> _Repeated:
        r = self._values.get(f.name)
        if r is None:
            r = self._values[f.name] = _Repeated(self, f)
        return r


def _wire_of(f: _F) -> int:
    if f.is_message or f.kind == "string":
        return _LEN
    if f.kind == "float":
        return _I32
    return _VARINT


def _put_varint(out: bytearray, v: int):
    v &= (1 << 64) - 1  # a negative value is its 64-bit two's complement
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _put(out: bytearray, f: _F, v):
    wt = _wire_of(f)
    _put_varint(out, (f.number << 3) | wt)
    if f.is_message:
        sub = bytearray()
        v._encode(sub)
        _put_varint(out, len(sub))
        out += sub
    elif f.kind == "string":
        b = v.encode("utf-8")
        _put_varint(out, len(b))
        out += b
    elif f.kind == "float":
        with np.errstate(over="ignore"):
            out += np.float32(v).tobytes()
    else:
        _put_varint(out, int(v))


def _get_varint(buf, pos) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _get_scalar(buf, pos, f: _F, wt):
    if wt == _I32:
        if pos + 4 > len(buf):
            raise DecodeError("truncated fixed32")
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    v, pos = _get_varint(buf, pos)
    k = f.kind
    if k == "bool":
        return v != 0, pos
    v &= (1 << 64) - 1
    if v >= 1 << 63:
        v -= 1 << 64
    if k in ("int32", "enum"):
        v = ((v + (1 << 31)) & ((1 << 32) - 1)) - (1 << 31)
    return v, pos


def _skip(buf, pos, wt) -> int:
    if wt == _VARINT:
        return _get_varint(buf, pos)[1]
    if wt == _I64:
        return pos + 8
    if wt == _I32:
        return pos + 4
    if wt == _LEN:
        n, pos = _get_varint(buf, pos)
        return pos + n
    raise DecodeError(f"unsupported wire type {wt}")


# --------------------------------------------------------------------------
# framework.proto
# --------------------------------------------------------------------------
# enum AttrType
INT = 0
FLOAT = 1
STRING = 2
INTS = 3
FLOATS = 4
STRINGS = 5
BOOLEAN = 6
BOOLEANS = 7
BLOCK = 8
LONG = 9
BLOCKS = 10
LONGS = 11


class Version(Message):
    _FIELDS = (_F(1, "version", "int64", default=0),)


class OpDesc(Message):
    class Attr(Message):
        _FIELDS = (
            _F(1, "name", "string", _REQ),
            _F(2, "type", "enum", _REQ),
            _F(3, "i", "int32"),
            _F(4, "f", "float"),
            _F(5, "s", "string"),
            _F(6, "ints", "int32", _REP),
            _F(7, "floats", "float", _REP),
            _F(8, "strings", "string", _REP),
            _F(10, "b", "bool"),
            _F(11, "bools", "bool", _REP),
            _F(12, "block_idx", "int32"),
            _F(13, "l", "int64"),
            _F(14, "blocks_idx", "int32", _REP),
            _F(15, "longs", "int64", _REP),
        )

    class Var(Message):
        _FIELDS = (
            _F(1, "parameter", "string", _REQ),
            _F(2, "arguments", "string", _REP),
        )

    _FIELDS = (
        _F(3, "type", "string", _REQ),
        _F(1, "inputs", Var, _REP),
        _F(2, "outputs", Var, _REP),
        _F(4, "attrs", Attr, _REP),
        _F(5, "is_target", "bool", default=False),
    )


class VarType(Message):
    # enum Type
    BOOL = 0
    INT16 = 1
    INT32 = 2
    INT64 = 3
    FP16 = 4
    FP32 = 5
    FP64 = 6
    SIZE_T = 19
    UINT8 = 20
    INT8 = 21
    BF16 = 22
    LOD_TENSOR = 7
    SELECTED_ROWS = 8
    FEED_MINIBATCH = 9
    FETCH_LIST = 10
    STEP_SCOPES = 11
    LOD_RANK_TABLE = 12
    LOD_TENSOR_ARRAY = 13
    PLACE_LIST = 14
    READER = 15
    RAW = 17
    TUPLE = 18

    class TensorDesc(Message):
        _FIELDS = (
            _F(1, "data_type", "enum", _REQ),
            _F(2, "dims", "int64", _REP),  # -1 marks an unknown (batch) dim
        )

    class LoDTensorDesc(Message):
        pass

    class LoDTensorArrayDesc(Message):
        pass

    class ReaderDesc(Message):
        pass

    class Tuple(Message):
        _FIELDS = (_F(1, "element_type", "enum", _REP),)


# the nested messages that hold TensorDesc, defined once it exists
VarType.LoDTensorDesc._FIELDS = (
    _F(1, "tensor", VarType.TensorDesc, _REQ),
    _F(2, "lod_level", "int32", default=0),
)
VarType.LoDTensorArrayDesc._FIELDS = VarType.LoDTensorDesc._FIELDS
VarType.ReaderDesc._FIELDS = (
    _F(1, "lod_tensor", VarType.LoDTensorDesc, _REP),)
VarType._FIELDS = (
    _F(1, "type", "enum", _REQ),
    _F(2, "selected_rows", VarType.TensorDesc),
    _F(3, "lod_tensor", VarType.LoDTensorDesc),
    _F(4, "tensor_array", VarType.LoDTensorArrayDesc),
    _F(5, "reader", VarType.ReaderDesc),
    _F(7, "tuple", VarType.Tuple),
)
for _cls in (VarType.LoDTensorDesc, VarType.LoDTensorArrayDesc,
             VarType.ReaderDesc, VarType):
    _cls._finish()


class VarDesc(Message):
    _FIELDS = (
        _F(1, "name", "string", _REQ),
        _F(2, "type", VarType, _REQ),
        _F(3, "persistable", "bool", default=False),
        _F(4, "need_check_feed", "bool", default=False),
    )


class BlockDesc(Message):
    _FIELDS = (
        _F(1, "idx", "int32", _REQ),
        _F(2, "parent_idx", "int32", _REQ),
        _F(3, "vars", VarDesc, _REP),
        _F(4, "ops", OpDesc, _REP),
        _F(5, "forward_block_idx", "int32", default=-1),
    )


class CompatibleInfo(Message):
    COMPATIBLE = 0
    DEFINITELY_NOT = 1
    POSSIBLE = 2
    BUG_FIX = 3
    PRECISION_CHANGE = 4
    _FIELDS = (
        _F(1, "version", "string", _REQ),
        _F(2, "type", "enum", _REQ),
    )


class OpCompatibleMap(Message):
    class OpCompatiblePair(Message):
        _FIELDS = (
            _F(1, "op_name", "string", _REQ),
            _F(2, "compatible_info", CompatibleInfo, _REQ),
        )

    _FIELDS = (
        _F(1, "pair", OpCompatiblePair, _REP),
        _F(2, "default_required_version", "string"),
    )


class ProgramDesc(Message):
    _FIELDS = (
        _F(1, "blocks", BlockDesc, _REP),
        _F(4, "version", Version),
        _F(3, "op_compatible_map", OpCompatibleMap),
    )
