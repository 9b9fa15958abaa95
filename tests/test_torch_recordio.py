"""The port's RecordIO, native host helpers, image decoding and `im2rec`
against the JAX package's.

Every case makes its records and images with numpy from a seed and runs
them through both packages. Everything here is exact: the files are
byte-identical, the framing scan and the normalize passes equal their
plain versions (and the JAX package's C library) bit for bit, and a
decoded image is the same array.
"""
import io
import os
import pickle
import struct
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import native as jnative
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import native, recordio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _payloads(seed, sizes=(1, 3, 4, 1000, 7, 0, 33)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).astype(np.uint8).tobytes() for n in sizes]


def _write(mod, tmp_path, name, payloads, indexed=True):
    rec, idx = str(tmp_path / (name + ".rec")), str(tmp_path / (name + ".idx"))
    w = mod.MXIndexedRecordIO(idx, rec, "w") if indexed else \
        mod.MXRecordIO(rec, "w")
    for i, p in enumerate(payloads):
        if indexed:
            w.write_idx(i, p)
        else:
            w.write(p)
    w.close()
    return rec, idx


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _multipart_buffer(seed):
    """A .rec buffer holding a record split in three parts (cflag 1, 2,
    3) between two whole ones, then a truncated tail, as dmlc writes
    payloads of 2^29 bytes and more."""
    rng = np.random.RandomState(seed)
    out = bytearray()

    def part(cflag, n):
        out.extend(struct.pack("<II", 0xced7230a, (cflag << 29) | n))
        out.extend(rng.randint(0, 256, n).astype(np.uint8).tobytes())
        out.extend(b"\0" * ((4 - n % 4) % 4))
    part(0, 5)
    part(1, 8)
    part(2, 3)
    part(3, 6)
    part(0, 0)
    part(0, 9)
    out.extend(struct.pack("<II", 0xced7230a, 100))   # truncated tail
    out.extend(b"\1" * 10)
    return bytes(out)


# -- the native helpers (tests/test_native.py, as comparisons) --------------

def test_native_builds():
    lib = native.build()
    assert lib.mxtpu_version() == 1
    assert native.build() is lib
    assert os.path.basename(lib._name).startswith("libmxnet_tpu_native-")
    assert os.path.dirname(lib._name).endswith(
        os.path.join("build", "torch_kernels"))


def test_native_failed_build_raises(monkeypatch, tmp_path):
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


def test_recordio_index_matches_python(tmp_path):
    payloads = _payloads(0)
    rec, idx = _write(recordio, tmp_path, "a", payloads)
    starts, sizes = native.index_recordio_buffer(_bytes(rec))
    assert sizes.tolist() == [len(p) for p in payloads]
    with open(idx) as f:
        assert starts.tolist() == [int(line.split("\t")[1]) for line in f]
    want = jnative.index_recordio_buffer(_bytes(rec))
    for a, b, c in zip((starts, sizes), want,
                       native.index_recordio_buffer_plain(_bytes(rec))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("seed", [0, 1])
def test_recordio_index_multipart_and_truncated_tail(seed):
    buf = _multipart_buffer(seed)
    got = native.index_recordio_buffer(buf)
    plain = native.index_recordio_buffer_plain(buf)
    ref = jnative.index_recordio_buffer(buf)
    assert got[0].tolist() == [0, 16, 60, 68]
    assert got[1].tolist() == [5, 17, 0, 9]
    for a, b, c in zip(got, plain, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_recordio_index_file_and_empty(tmp_path):
    rec, _ = _write(recordio, tmp_path, "f", _payloads(3))
    for a, b in zip(native.index_recordio_file(rec),
                    native.index_recordio_buffer(_bytes(rec))):
        np.testing.assert_array_equal(a, b)
    empty = tmp_path / "empty.rec"
    empty.write_bytes(b"")
    starts, sizes = native.index_recordio_file(str(empty))
    assert starts.size == sizes.size == 0


def test_recordio_missing_idx_recovery(tmp_path):
    rec, idx = _write(recordio, tmp_path, "b",
                      [("rec%d" % i).encode() for i in range(5)],
                      indexed=False)
    for mod in (recordio, jrec):
        r = mod.MXIndexedRecordIO(idx, rec, "r")
        assert len(r.keys) == 5
        assert r.read_idx(3) == b"rec3"
        assert r.read_idx(0) == b"rec0"
        r.close()
    r = recordio.MXIndexedRecordIO(idx, rec, "r")
    r.rebuild_index(write=True)
    r.close()
    port_idx = _bytes(idx)
    os.remove(idx)
    r = jrec.MXIndexedRecordIO(idx, rec, "r")
    r.rebuild_index(write=True)
    r.close()
    assert port_idx == _bytes(idx)


def test_rebuilt_index_equals_written(tmp_path):
    rec, idx = _write(recordio, tmp_path, "c", _payloads(5) * 3)
    written = _bytes(idx)
    os.remove(idx)
    r = recordio.MXIndexedRecordIO(idx, rec, "r")
    r.rebuild_index(write=True)
    r.close()
    assert _bytes(idx) == written


def test_recordio_index_corrupt_magic():
    for fn in (native.index_recordio_buffer, jnative.index_recordio_buffer,
               native.index_recordio_buffer_plain):
        with pytest.raises(IOError):
            fn(b"\x00" * 16)


@pytest.mark.parametrize("shape,mean,std", [
    ((17, 23, 3), [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    ((5, 9, 1), [0.5], [0.25]),
    ((8, 8, 4), None, None),
    ((3, 7, 3), [123.0 / 255, 117.0 / 255, 104.0 / 255], None),
])
def test_img_to_chw_norm_matches_numpy(shape, mean, std):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape,
                                                    dtype=np.uint8)
    m = None if mean is None else np.array(mean, np.float32)
    s = None if std is None else np.array(std, np.float32)
    got = native.img_to_chw_norm(img, m, s)
    assert got.dtype == np.float32 and got.shape == shape[2:] + shape[:2]
    np.testing.assert_array_equal(got, native.img_to_chw_norm_plain(
        img, m, s))
    np.testing.assert_array_equal(got, jnative.img_to_chw_norm(img, m, s))


@pytest.mark.parametrize("b", [0, 1, 4])
def test_batch_to_chw_norm(b):
    batch = np.random.RandomState(b).randint(0, 256, (b, 8, 9, 3),
                                             dtype=np.uint8)
    mean = np.array([0.5, 0.5, 0.5], np.float32)
    std = np.array([0.25, 0.25, 0.25], np.float32)
    got = native.batch_to_chw_norm(batch, mean, std)
    assert got.shape == (b, 3, 8, 9)
    np.testing.assert_array_equal(got, native.batch_to_chw_norm_plain(
        batch, mean, std))
    if b:
        np.testing.assert_array_equal(got, jnative.batch_to_chw_norm(
            batch, mean, std))


# -- the files ------------------------------------------------------------

@pytest.mark.parametrize("indexed", [True, False])
def test_written_files_byte_identical(tmp_path, indexed):
    payloads = _payloads(7)
    mine = _write(recordio, tmp_path, "mine", payloads, indexed)
    ref = _write(jrec, tmp_path, "ref", payloads, indexed)
    assert _bytes(mine[0]) == _bytes(ref[0])
    if indexed:
        assert _bytes(mine[1]) == _bytes(ref[1])


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0], np.arange(
    7, dtype=np.float32)])
def test_pack_and_pack_img_same_bytes(label):
    rng = np.random.RandomState(11)
    img = rng.randint(0, 256, (6, 5, 3), dtype=np.uint8)
    a = recordio.pack(recordio.IRHeader(0, label, 9, 2), b"payload")
    b = jrec.pack(jrec.IRHeader(0, label, 9, 2), b"payload")
    assert a == b
    a = recordio.pack_img(recordio.IRHeader(0, label, 4, 0), img)
    b = jrec.pack_img(jrec.IRHeader(0, label, 4, 0), img)
    assert a == b
    for s in (a, b):
        h1, p1 = recordio.unpack(s)
        h2, p2 = jrec.unpack(s)
        assert p1 == p2
        assert (h1.flag, h1.id, h1.id2) == (h2.flag, h2.id, h2.id2)
        np.testing.assert_array_equal(np.asarray(h1.label),
                                      np.asarray(h2.label))
        h, got = recordio.unpack_img(s)
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(got, jrec.unpack_img(s)[1])


@pytest.mark.parametrize("writer,reader", [(recordio, jrec),
                                           (jrec, recordio)])
def test_each_reads_the_others_pack(tmp_path, writer, reader):
    rng = np.random.RandomState(5)
    imgs = [rng.randint(0, 256, (7 + i, 9, 3), dtype=np.uint8)
            for i in range(6)]
    rec, idx = str(tmp_path / "x.rec"), str(tmp_path / "x.idx")
    w = writer.MXIndexedRecordIO(idx, rec, "w")
    for i, img in enumerate(imgs):
        w.write_idx(i, writer.pack_img(writer.IRHeader(0, float(i), i, 0),
                                       img))
    w.close()
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == list(range(6))
    for i in (3, 0, 5):
        h, img = reader.unpack_img(r.read_idx(i))
        assert float(h.label) == float(i)
        np.testing.assert_array_equal(img, imgs[i])
    r.close()
    seq = reader.MXRecordIO(rec, "r")
    for img in imgs:
        np.testing.assert_array_equal(reader.unpack_img(seq.read())[1], img)
    assert seq.read() is None
    seq.close()


def test_corrupt_magic_raises_in_both(tmp_path):
    path = tmp_path / "bad.rec"
    path.write_bytes(struct.pack("<II", 0xdeadbeef, 4) + b"abcd")
    for mod in (recordio, jrec):
        r = mod.MXRecordIO(str(path), "r")
        with pytest.raises(IOError, match="magic"):
            r.read()
        r.close()
        with pytest.raises(IOError, match="magic"):
            mod.MXIndexedRecordIO(str(tmp_path / "bad.idx"), str(path), "r")


def test_reader_pickles_and_reopens(tmp_path):
    rec, idx = _write(recordio, tmp_path, "p", _payloads(2))
    r = recordio.MXIndexedRecordIO(idx, rec, "r")
    first = r.read_idx(3)
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.is_open and r2.read_idx(3) == first
    # the pickled reader was closed; it reopens at its next read
    assert r.read_idx(3) == first
    r.close()
    r2.close()


# -- decoding ---------------------------------------------------------------

def _png_bytes(img):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("shape", [(9, 7, 3), (6, 5, 1), (4, 8)])
def test_imdecode_npy(shape):
    img = np.random.RandomState(len(shape)).randint(0, 256, shape,
                                                    dtype=np.uint8)
    buf = io.BytesIO()
    np.save(buf, img)
    for to_ndarray in (True, False):
        a = mx.image.imdecode(buf.getvalue(), to_ndarray=to_ndarray)
        b = jmx.image.imdecode(buf.getvalue(), to_ndarray=to_ndarray)
        if to_ndarray:
            assert a.context == mx.cpu() and a.dtype == np.uint8
            a, b = a.asnumpy(), b.asnumpy()
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_png_and_imread(tmp_path, flag, to_rgb):
    pytest.importorskip("PIL")
    img = np.random.RandomState(flag).randint(0, 256, (10, 12, 3),
                                              dtype=np.uint8)
    data = _png_bytes(img)
    a = mx.image.imdecode(data, flag=flag, to_rgb=to_rgb).asnumpy()
    b = jmx.image.imdecode(data, flag=flag, to_rgb=to_rgb).asnumpy()
    np.testing.assert_array_equal(a, b)
    if flag == 1 and to_rgb:
        np.testing.assert_array_equal(a, img)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(
        mx.image.imread(str(path), flag=flag, to_rgb=to_rgb).asnumpy(),
        jmx.image.imread(str(path), flag=flag, to_rgb=to_rgb).asnumpy())


def test_imdecode_jpeg_without_pil_names_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        mx.image.imdecode(b"\xff\xd8\xff\xe0 not an npy payload")


# -- im2rec (tests/test_tools.py::test_im2rec_list_and_pack) ----------------

def _image_folder(root, seed, classes=2, per_class=3, npy=False):
    from PIL import Image
    rng = np.random.RandomState(seed)
    for c in range(classes):
        d = os.path.join(root, "class%d" % c)
        os.makedirs(d)
        for i in range(per_class):
            arr = rng.randint(0, 255, (10 + i, 12, 3), np.uint8)
            if npy:
                np.save(os.path.join(d, "img%d.npy" % i), arr)
            else:
                Image.fromarray(arr).save(os.path.join(d, "img%d.png" % i))


def _im2rec(cmd, prefix, root, *args):
    r = subprocess.run(cmd + [prefix, root, *args], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr


PORT_TOOL = [sys.executable, "-m", "mxnet_tpu_torch.tools.im2rec"]
REF_TOOL = [sys.executable, os.path.join(REPO, "tools", "im2rec.py")]


@pytest.mark.parametrize("resize", [None, "8"])
def test_im2rec_list_and_pack_equal_to_reference(tmp_path, resize):
    pytest.importorskip("PIL")
    root = str(tmp_path / "imgs")
    _image_folder(root, seed=3)
    files = {}
    for name, tool in (("port", PORT_TOOL), ("ref", REF_TOOL)):
        prefix = str(tmp_path / name)
        _im2rec(tool, prefix, root, "--list", "--recursive")
        _im2rec(tool, prefix, root, *(["--resize", resize] if resize
                                      else []))
        files[name] = [_bytes(prefix + ext) for ext in (".lst", ".rec",
                                                        ".idx")]
    assert files["port"] == files["ref"]
    prefix = str(tmp_path / "port")
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    assert len(rec.keys) == 6
    header, payload = recordio.unpack(rec.read_idx(rec.keys[0]))
    assert payload[:2] == b"\xff\xd8"  # JPEG SOI
    assert float(np.asarray(header.label)) in (0.0, 1.0)
    img = mx.image.imdecode(payload, to_ndarray=False)
    assert img.shape[2] == 3
    if resize:
        assert min(img.shape[:2]) == 8
    rec.close()


def test_im2rec_npy_folder_needs_no_codec(tmp_path):
    root = str(tmp_path / "imgs")
    _image_folder(root, seed=4, npy=True)
    prefix = str(tmp_path / "npy")
    _im2rec(PORT_TOOL, prefix, root, "--list", "--recursive",
            "--shuffle", "0")
    _im2rec(PORT_TOOL, prefix, root)
    with open(prefix + ".lst") as f:
        rels = [line.split("\t")[-1].strip() for line in f]
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    for key, rel in zip(rec.keys, rels):
        header, img = recordio.unpack_img(rec.read_idx(key))
        np.testing.assert_array_equal(img, np.load(os.path.join(root, rel)))
        assert float(header.label) == float(rel.startswith("class1"))
    rec.close()
    # --resize: the shorter side, with the port's antialiased bilinear
    _im2rec(PORT_TOOL, prefix, root, "--resize", "6")
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    shapes = [recordio.unpack_img(rec.read_idx(k))[1].shape
              for k in rec.keys]
    assert all(min(s[:2]) == 6 and s[2] == 3 for s in shapes), shapes
    rec.close()
