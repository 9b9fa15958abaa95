"""RecordIO: the reference's binary record format and its packing helpers
(the port of `mxnet_tpu.recordio`, numpy only).

dmlc RecordIO (reference: 3rdparty/dmlc-core/include/dmlc/recordio.h:
magic 0xced7230a framing, multi-part records for payloads of 2^29 bytes
and more) and python/mxnet/recordio.py (`MXRecordIO`,
`MXIndexedRecordIO`, `IRHeader`, `pack`/`unpack`). The files are
byte-identical to the JAX package's and to the reference's im2rec, so
either package reads the other's packs. A missing ``.idx`` is rebuilt by
the native framing scan (`native.index_recordio_file`, over a memory map
of the file).
"""
from __future__ import annotations

import numbers
import os
import struct

import numpy as _np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_KFLAG_BITS = 29
_LENGTH_MASK = (1 << _KFLAG_BITS) - 1


def _encode_lrec(cflag, length):
    return (cflag << _KFLAG_BITS) | length


def _decode_lrec(lrec):
    return (lrec >> _KFLAG_BITS) & 7, lrec & _LENGTH_MASK


class MXRecordIO:
    """Sequential .rec reader/writer.
    reference: python/mxnet/recordio.py (MXRecordIO) over
    dmlc::RecordIOWriter/Reader."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.fid = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.fid = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fid = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("fid", None)
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        self.fid = None
        is_open = d.get("is_open", False)
        self.is_open = False
        if is_open:
            self.open()

    def _check_pid(self, allow_reset=False):
        """Post-fork safety (reference: MXRecordIO._check_pid)."""
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise RuntimeError("Forbidden operation in forked process")

    def close(self):
        if not self.is_open:
            return
        self.fid.close()
        self.is_open = False
        self.pid = None

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        """Append one record. reference: dmlc::RecordIOWriter::WriteRecord."""
        assert self.writable
        self._check_pid(allow_reset=False)
        n = len(buf)
        # single-part record (cflag 0); multipart for giant payloads
        if n <= _LENGTH_MASK:
            self.fid.write(struct.pack("<II", _MAGIC, _encode_lrec(0, n)))
            self.fid.write(buf)
            pad = (4 - n % 4) % 4
            if pad:
                self.fid.write(b"\x00" * pad)
        else:
            nparts = (n + _LENGTH_MASK - 1) // _LENGTH_MASK
            off = 0
            for i in range(nparts):
                part = buf[off:off + _LENGTH_MASK]
                off += len(part)
                cflag = 1 if i == 0 else (2 if i < nparts - 1 else 3)
                self.fid.write(struct.pack("<II", _MAGIC,
                                           _encode_lrec(cflag, len(part))))
                self.fid.write(part)
                pad = (4 - len(part) % 4) % 4
                if pad:
                    self.fid.write(b"\x00" * pad)

    def read(self):
        """Read next record or None at EOF.
        reference: dmlc::RecordIOReader::NextRecord."""
        assert not self.writable
        self._check_pid(allow_reset=True)
        parts = []
        while True:
            header = self.fid.read(8)
            if len(header) < 8:
                return None if not parts else b"".join(parts)
            magic, lrec = struct.unpack("<II", header)
            if magic != _MAGIC:
                raise IOError("Invalid RecordIO magic number")
            cflag, length = _decode_lrec(lrec)
            data = self.fid.read(length)
            pad = (4 - length % 4) % 4
            if pad:
                self.fid.read(pad)
            if cflag == 0:
                return data
            parts.append(data)
            if cflag == 3:
                return b"".join(parts)

    def tell(self):
        return self.fid.tell()

    def seek(self, pos):
        assert not self.writable
        self.fid.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """.rec + .idx random access.
    reference: python/mxnet/recordio.py (MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r":
            if os.path.isfile(self.idx_path):
                with open(self.idx_path) as fin:
                    for line in fin.readlines():
                        line = line.strip().split("\t")
                        key = self.key_type(line[0])
                        self.idx[key] = int(line[1])
                        self.keys.append(key)
            else:
                self.rebuild_index()
            self.fidx = None
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def rebuild_index(self, write=False):
        """Scan the .rec and regenerate the key -> offset index, keys
        being the record ordinals (the reference needs a written .idx;
        here a missing one is recovered by the native framing scan).
        write=True also writes the .idx file."""
        from . import native
        starts = native.index_recordio_file(self.uri)[0].tolist()
        self.idx = {}
        self.keys = []
        for i, s in enumerate(starts):
            key = self.key_type(i)
            self.idx[key] = int(s)
            self.keys.append(key)
        if write:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write("%s\t%d\n" % (str(key), self.idx[key]))

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None

    def seek(self, idx):
        """Seek to the record with key `idx`."""
        assert not self.writable
        self._check_pid(allow_reset=True)
        pos = self.idx[idx]
        self.fid.seek(pos)

    def read_idx(self, idx):
        """reference: MXIndexedRecordIO.read_idx."""
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        """reference: MXIndexedRecordIO.write_idx."""
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


IndexedRecordIO = MXIndexedRecordIO


class IRHeader:
    """Image record header. reference: python/mxnet/recordio.py (IRHeader:
    flag, label, id, id2)."""

    __slots__ = ("flag", "label", "id", "id2")
    _FMT = "<IfQQ"

    def __init__(self, flag, label, id_, id2):
        self.flag = flag
        self.label = label
        self.id = id_
        self.id2 = id2


def pack(header, s):
    """Pack a header + byte payload into a record string.
    reference: recordio.py (pack)."""
    flag = header.flag
    label = header.label
    if isinstance(label, (numbers.Number,)):
        hdr = struct.pack(IRHeader._FMT, 0, float(label), header.id,
                          header.id2)
        return hdr + s
    label = _np.asarray(label, dtype=_np.float32)
    hdr = struct.pack(IRHeader._FMT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """Unpack a record into (IRHeader, payload).
    reference: recordio.py (unpack)."""
    hdr_size = struct.calcsize(IRHeader._FMT)
    flag, label, id_, id2 = struct.unpack(IRHeader._FMT, s[:hdr_size])
    s = s[hdr_size:]
    if flag > 0:
        label = _np.frombuffer(s[:flag * 4], dtype=_np.float32)
        s = s[flag * 4:]
    header = IRHeader(flag, label, id_, id2)
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array as a record whose payload is the array's
    ``.npy`` bytes, as the JAX package's pack_img writes (`quality` and
    `img_fmt` are accepted and unused: no JPEG encoder is needed).
    `image.imdecode` reads such payloads with numpy, and JPEG/PNG ones
    with PIL where it is installed. reference: recordio.py (pack_img)."""
    import io
    buf = io.BytesIO()
    _np.save(buf, img, allow_pickle=False)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    """Unpack a record into (IRHeader, image array).
    reference: recordio.py (unpack_img)."""
    header, s = unpack(s)
    from .image import imdecode
    img = imdecode(s, to_ndarray=False)
    return header, img
