"""Minimal protobuf wire codec for the ONNX message subset (a copy of
`mxnet_tpu.contrib.onnx.proto`).

reference: python/mxnet/contrib/onnx/ depends on the `onnx` package; the
wire format is small, so the subset of onnx.proto that the exporter emits
(ModelProto/GraphProto/NodeProto/AttributeProto/TensorProto/
ValueInfoProto/TypeProto) is encoded directly, with no dependency. Field
numbers follow onnx.proto (stable since IR v3); the files load in stock
onnx/onnxruntime, and import_model reads them and files written by
onnx.helper.

Wire format: varint (wire 0) for ints/enums, fixed32 (wire 5) for floats,
length-delimited (wire 2) for strings/bytes/messages/packed-repeated.
"""
from __future__ import annotations

import struct

__all__ = ["Message", "Field", "ModelProto", "GraphProto", "NodeProto",
           "AttributeProto", "TensorProto", "ValueInfoProto", "TypeProto",
           "TensorTypeProto", "TensorShapeProto", "Dimension",
           "OperatorSetIdProto", "DT", "AT"]


# TensorProto.DataType / AttributeProto.AttributeType enums (onnx.proto)
class DT:
    FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL, \
        FLOAT16, DOUBLE, UINT32, UINT64, COMPLEX64, COMPLEX128, BFLOAT16 \
        = range(1, 17)


class AT:
    FLOAT, INT, STRING, TENSOR, GRAPH = 1, 2, 3, 4, 5
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = 6, 7, 8, 9, 10


def _uvarint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varint(v):
    if v < 0:
        v += 1 << 64          # two's-complement 64-bit
    return _uvarint(v)


def _read_uvarint(buf, pos):
    shift = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _to_signed(v):
    return v - (1 << 64) if v >= (1 << 63) else v


class Field:
    def __init__(self, num, kind, repeated=False, msg=None):
        self.num = num
        self.kind = kind        # "int" | "float" | "string" | "bytes" | "msg"
        self.repeated = repeated
        self.msg = msg          # Message subclass when kind == "msg"


class Message:
    SCHEMA: dict = {}

    def __init__(self, **kwargs):
        for name, f in self.SCHEMA.items():
            setattr(self, name, [] if f.repeated else None)
        for k, v in kwargs.items():
            if k not in self.SCHEMA:
                raise TypeError("%s has no field %r" % (type(self).__name__,
                                                        k))
            setattr(self, k, v)

    # -- encode --------------------------------------------------------
    def encode(self):
        out = bytearray()
        for name, f in self.SCHEMA.items():
            val = getattr(self, name)
            if val is None or (f.repeated and not val):
                continue
            vals = val if f.repeated else [val]
            if f.kind == "int":
                if f.repeated:          # packed
                    body = b"".join(_varint(int(v)) for v in vals)
                    out += _uvarint((f.num << 3) | 2)
                    out += _uvarint(len(body)) + body
                else:
                    out += _uvarint(f.num << 3) + _varint(int(vals[0]))
            elif f.kind == "float":
                if f.repeated:          # packed fixed32
                    body = b"".join(struct.pack("<f", float(v))
                                    for v in vals)
                    out += _uvarint((f.num << 3) | 2)
                    out += _uvarint(len(body)) + body
                else:
                    out += _uvarint((f.num << 3) | 5)
                    out += struct.pack("<f", float(vals[0]))
            else:
                for v in vals:
                    if f.kind == "msg":
                        body = v.encode()
                    elif f.kind == "string":
                        body = v.encode("utf-8") if isinstance(v, str) else v
                    else:                     # bytes
                        body = bytes(v)
                    out += _uvarint((f.num << 3) | 2)
                    out += _uvarint(len(body)) + body
        return bytes(out)

    # -- decode --------------------------------------------------------
    @classmethod
    def decode(cls, buf):
        self = cls()
        by_num = {f.num: (name, f) for name, f in cls.SCHEMA.items()}
        pos = 0
        n = len(buf)
        while pos < n:
            tag, pos = _read_uvarint(buf, pos)
            num, wire = tag >> 3, tag & 7
            entry = by_num.get(num)
            if entry is None:               # skip unknown field
                if wire == 0:
                    _, pos = _read_uvarint(buf, pos)
                elif wire == 2:
                    ln, pos = _read_uvarint(buf, pos)
                    pos += ln
                elif wire == 5:
                    pos += 4
                elif wire == 1:
                    pos += 8
                else:
                    raise ValueError("bad wire type %d" % wire)
                continue
            name, f = entry
            if wire == 0:
                raw, pos = _read_uvarint(buf, pos)
                val = _to_signed(raw) if f.kind == "int" else raw
                self._store(name, f, val)
            elif wire == 5:
                (val,) = struct.unpack_from("<f", buf, pos)
                pos += 4
                self._store(name, f, val)
            elif wire == 1:
                (val,) = struct.unpack_from("<d", buf, pos)
                pos += 8
                self._store(name, f, val)
            elif wire == 2:
                ln, pos = _read_uvarint(buf, pos)
                chunk = buf[pos:pos + ln]
                pos += ln
                if f.kind == "msg":
                    self._store(name, f, f.msg.decode(chunk))
                elif f.kind == "string":
                    self._store(name, f, chunk.decode("utf-8",
                                                      errors="replace"))
                elif f.kind == "bytes":
                    self._store(name, f, bytes(chunk))
                elif f.kind == "int" and f.repeated:    # packed
                    p2 = 0
                    while p2 < len(chunk):
                        raw, p2 = _read_uvarint(chunk, p2)
                        getattr(self, name).append(_to_signed(raw))
                elif f.kind == "float" and f.repeated:  # packed fixed32
                    for i in range(0, len(chunk) - 3, 4):
                        getattr(self, name).append(
                            struct.unpack_from("<f", chunk, i)[0])
                else:
                    raise ValueError("field %s: unexpected wire 2" % name)
            else:
                raise ValueError("bad wire type %d" % wire)
        return self

    def _store(self, name, f, val):
        if f.repeated:
            getattr(self, name).append(val)
        else:
            setattr(self, name, val)


class OperatorSetIdProto(Message):
    SCHEMA = {"domain": Field(1, "string"), "version": Field(2, "int")}


class Dimension(Message):
    SCHEMA = {"dim_value": Field(1, "int"), "dim_param": Field(2, "string")}


class TensorShapeProto(Message):
    SCHEMA = {"dim": Field(1, "msg", repeated=True, msg=Dimension)}


class TensorTypeProto(Message):
    SCHEMA = {"elem_type": Field(1, "int"),
              "shape": Field(2, "msg", msg=TensorShapeProto)}


class TypeProto(Message):
    SCHEMA = {"tensor_type": Field(1, "msg", msg=TensorTypeProto)}


class ValueInfoProto(Message):
    SCHEMA = {"name": Field(1, "string"),
              "type": Field(2, "msg", msg=TypeProto),
              "doc_string": Field(3, "string")}


class TensorProto(Message):
    SCHEMA = {
        "dims": Field(1, "int", repeated=True),
        "data_type": Field(2, "int"),
        "float_data": Field(4, "float", repeated=True),
        "int32_data": Field(5, "int", repeated=True),
        "string_data": Field(6, "bytes", repeated=True),
        "int64_data": Field(7, "int", repeated=True),
        "name": Field(8, "string"),
        "raw_data": Field(9, "bytes"),
        "doc_string": Field(12, "string"),
    }


class AttributeProto(Message):
    SCHEMA = {
        "name": Field(1, "string"),
        "f": Field(2, "float"),
        "i": Field(3, "int"),
        "s": Field(4, "bytes"),
        "t": Field(5, "msg", msg=TensorProto),
        "floats": Field(7, "float", repeated=True),
        "ints": Field(8, "int", repeated=True),
        "strings": Field(9, "bytes", repeated=True),
        "tensors": Field(10, "msg", repeated=True, msg=TensorProto),
        "doc_string": Field(13, "string"),
        "type": Field(20, "int"),
    }


class NodeProto(Message):
    SCHEMA = {
        "input": Field(1, "string", repeated=True),
        "output": Field(2, "string", repeated=True),
        "name": Field(3, "string"),
        "op_type": Field(4, "string"),
        "attribute": Field(5, "msg", repeated=True, msg=AttributeProto),
        "doc_string": Field(6, "string"),
        "domain": Field(7, "string"),
    }


class GraphProto(Message):
    SCHEMA = {
        "node": Field(1, "msg", repeated=True, msg=NodeProto),
        "name": Field(2, "string"),
        "initializer": Field(5, "msg", repeated=True, msg=TensorProto),
        "doc_string": Field(10, "string"),
        "input": Field(11, "msg", repeated=True, msg=ValueInfoProto),
        "output": Field(12, "msg", repeated=True, msg=ValueInfoProto),
        "value_info": Field(13, "msg", repeated=True, msg=ValueInfoProto),
    }


class ModelProto(Message):
    SCHEMA = {
        "ir_version": Field(1, "int"),
        "producer_name": Field(2, "string"),
        "producer_version": Field(3, "string"),
        "domain": Field(4, "string"),
        "model_version": Field(5, "int"),
        "doc_string": Field(6, "string"),
        "graph": Field(7, "msg", msg=GraphProto),
        "opset_import": Field(8, "msg", repeated=True,
                              msg=OperatorSetIdProto),
    }
