"""The port's `contrib.text` and `contrib.tensorboard` against the JAX
package's.

text: `Vocabulary` indices and tokens, `count_tokens_from_str`, and the
vectors of `CustomEmbedding` (a vector file the test writes: a fastText
header, a trained unknown vector, a duplicate token, a line of the wrong
width), `CompositeEmbedding`, `update_token_vectors` and the registry are
equal; GloVe without a local file raises in both and loads one that is
there. tensorboard: the event file's scalars are the metric's values, step
by step (read back with a TFRecord reader of the test's own).
"""
import collections
import glob
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib import text as jtext
from mxnet_tpu_torch.contrib import text

from _torch_seed import _seed_torch  # noqa: F401

CORPUS = ("the cat sat on the mat\nthe dog ate the cat\n"
          "A Cat and a DOG\nmat mat mat")


@pytest.mark.parametrize("kw", [
    {}, {"most_freq_count": 3}, {"min_freq": 2},
    {"reserved_tokens": ["<pad>", "<bos>"], "unknown_token": "<oov>"}])
def test_vocabulary_matches_reference(kw):
    for to_lower in (False, True):
        got = text.utils.count_tokens_from_str(CORPUS, to_lower=to_lower)
        want = jtext.utils.count_tokens_from_str(CORPUS, to_lower=to_lower)
        assert got == want
    counter = text.utils.count_tokens_from_str(
        "extra words", counter_to_update=collections.Counter(got))
    v, jv = text.Vocabulary(counter, **kw), jtext.Vocabulary(counter, **kw)
    assert v.idx_to_token == jv.idx_to_token
    assert v.token_to_idx == jv.token_to_idx
    assert v.reserved_tokens == jv.reserved_tokens
    toks = ["the", "mat", "zebra", "cat"]
    assert v.to_indices(toks) == jv.to_indices(toks)
    assert v.to_indices("zebra") == jv.to_indices("zebra") == 0
    assert v.to_tokens([0, 1, len(v) - 1]) == jv.to_tokens(
        [0, 1, len(jv) - 1])
    with pytest.raises(ValueError):
        v.to_tokens(len(v))


def test_vocabulary_argument_errors():
    for mod in (text, jtext):
        with pytest.raises(ValueError):
            mod.Vocabulary(min_freq=0)
        with pytest.raises(ValueError):
            mod.Vocabulary(reserved_tokens=["<unk>"])


def _vector_file(tmp_path):
    rng = np.random.RandomState(0)
    lines = ["5 4"]
    for tok in ("the", "cat", "<unk>", "mat", "the", "Dog"):
        lines.append(" ".join([tok] + ["%.6f" % v for v in rng.randn(4)]))
    lines.append("bad 1.0 2.0")
    lines.append("lonely")
    path = tmp_path / "vecs.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _vectors(pkg, mod, path):
    with pkg.cpu():
        emb = mod.embedding.create("customembedding",
                                   pretrained_file_path=path)
        out = {"tokens": list(emb.idx_to_token),
               "idx_to_vec": emb.idx_to_vec.asnumpy(),
               "lookup": emb.get_vecs_by_tokens(
                   ["cat", "dog", "zebra"], lower_case_backup=True)
               .asnumpy(),
               "one": emb["mat"].asnumpy(), "len": emb.vec_len}
        emb.update_token_vectors("cat", pkg.nd.array(np.ones(4)))
        out["updated"] = emb.get_vecs_by_tokens("cat").asnumpy()
        with pytest.raises(ValueError):
            emb.update_token_vectors("zebra", np.ones(4))
        vocab = mod.Vocabulary(collections.Counter(
            ["cat", "cat", "mat", "Dog", "owl"]))
        comp = mod.embedding.CompositeEmbedding(vocab, [emb, emb])
        out["composite"] = comp.idx_to_vec.asnumpy()
        out["composite_tokens"] = comp.idx_to_token
    return out


def test_custom_and_composite_embeddings_match(tmp_path):
    path = _vector_file(tmp_path)
    got = _vectors(mx, text, path)
    want = _vectors(jmx, jtext, path)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    assert got["composite"].shape == (5, 8)


def test_pretrained_registry_and_local_root(tmp_path):
    assert text.embedding.get_pretrained_file_names() == \
        jtext.embedding.get_pretrained_file_names()
    assert text.embedding.get_pretrained_file_names("glove") == \
        jtext.embedding.get_pretrained_file_names("glove")
    for mod in (text, jtext):
        with pytest.raises(FileNotFoundError):
            mod.embedding.GloVe("glove.6B.50d.txt",
                                embedding_root=str(tmp_path))
        with pytest.raises(KeyError):
            mod.embedding.GloVe("no_such.txt", embedding_root=str(tmp_path))
        with pytest.raises(KeyError):
            mod.embedding.create("word2vec_x")
    (tmp_path / "wiki.simple.vec").write_text("2 3\nowl 1 2 3\nbat 4 5 6\n")
    with mx.cpu():
        ft = text.embedding.FastText("wiki.simple.vec",
                                     embedding_root=str(tmp_path))
        np.testing.assert_array_equal(ft["bat"].asnumpy(), [4, 5, 6])
        assert ft.idx_to_token == ["<unk>", "owl", "bat"]


def _tf_records(path):
    """Payloads of a TFRecord file (length, crc, data, crc)."""
    buf = open(path, "rb").read()
    pos, out = 0, []
    while pos < len(buf):
        (n,) = struct.unpack_from("<Q", buf, pos)
        pos += 12
        out.append(buf[pos:pos + n])
        pos += n + 4
    return out


def _fields(msg):
    """(field number, wire type, value) of a protobuf message."""
    from mxnet_tpu_torch.contrib.onnx.proto import _read_uvarint
    pos, out = 0, []
    while pos < len(msg):
        key, pos = _read_uvarint(msg, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_uvarint(msg, pos)
        elif wire == 1:
            val, pos = msg[pos:pos + 8], pos + 8
        elif wire == 5:
            val, pos = msg[pos:pos + 4], pos + 4
        else:
            n, pos = _read_uvarint(msg, pos)
            val, pos = msg[pos:pos + n], pos + n
        out.append((field, wire, val))
    return out


def _scalars(logdir):
    """[(step, tag, value)] of the event files under `logdir` (Event: step
    2, summary 5; Summary.Value: tag 1, simple_value 2)."""
    out = []
    for path in sorted(glob.glob(logdir + "/events.out.tfevents.*")):
        for rec in _tf_records(path):
            ev = _fields(rec)
            step = next((v for f, _, v in ev if f == 2), 0)
            for f, _, summ in ev:
                if f != 5:
                    continue
                for _, _, val in _fields(summ):
                    kv = dict((g, v) for g, _, v in _fields(val))
                    out.append((step, kv[1].decode(),
                                struct.unpack("<f", kv[2])[0]))
    return out


def test_tensorboard_scalars_are_the_metric(tmp_path):
    from mxnet_tpu_torch.contrib.tensorboard import LogMetricsCallback
    from mxnet_tpu_torch.model import BatchEndParam
    cb = LogMetricsCallback(str(tmp_path), prefix="train")
    metric = mx.metric.create("acc")
    want = []
    with mx.cpu():
        for step, pred in enumerate(([0.9, 0.1], [0.2, 0.8], [0.7, 0.3]), 1):
            metric.update([mx.nd.array([0.0])], [mx.nd.array([pred])])
            cb(BatchEndParam(epoch=0, nbatch=step, eval_metric=metric,
                             locals=None))
            want.append((step, "train-accuracy",
                         float(np.float32(metric.get()[1]))))
    cb(BatchEndParam(epoch=0, nbatch=4, eval_metric=None, locals=None))
    cb.summary_writer.close()
    assert _scalars(str(tmp_path)) == want
    assert cb.step == 3
