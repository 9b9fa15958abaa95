"""Token embeddings. reference: python/mxnet/contrib/text/embedding.py —
`TokenEmbedding` base with registered sources (`glove`, `fasttext`),
`CustomEmbedding` for local vector files, `CompositeEmbedding`, and the
`register`/`create`/`get_pretrained_file_names` mechanism.

The port of `mxnet_tpu.contrib.text.embedding`. It downloads nothing:
GloVe/FastText enumerate their pretrained file names but load only from a
local `embedding_root` that already holds the files; `CustomEmbedding`
reads any local vector file. Vectors live on the current context.
"""
from __future__ import annotations

import io
import logging
import os

import numpy as _np

from ... import ndarray as nd
from .vocab import Vocabulary

__all__ = ["register", "create", "get_pretrained_file_names",
           "TokenEmbedding", "CustomEmbedding", "CompositeEmbedding",
           "GloVe", "FastText"]

_REGISTRY = {}


def register(klass):
    """reference: embedding.py (register) — lowercased class name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(embedding_name, **kwargs):
    """reference: embedding.py (create)."""
    name = embedding_name.lower()
    if name not in _REGISTRY:
        raise KeyError("unknown embedding %r (registered: %s)"
                       % (embedding_name, sorted(_REGISTRY)))
    return _REGISTRY[name](**kwargs)


def get_pretrained_file_names(embedding_name=None):
    """reference: embedding.py (get_pretrained_file_names)."""
    if embedding_name is not None:
        return list(_REGISTRY[embedding_name.lower()]
                    .pretrained_file_names)
    return {name: list(k.pretrained_file_names)
            for name, k in _REGISTRY.items()}


class TokenEmbedding:
    """Base token embedding: token -> vector with an unknown fallback.
    reference: embedding.py (_TokenEmbedding)."""

    pretrained_file_names = ()

    def __init__(self, unknown_token="<unk>",
                 init_unknown_vec=None):
        self._unknown_token = unknown_token
        self._init_unknown_vec = init_unknown_vec or (lambda s: _np.zeros(s))
        self._idx_to_token = [unknown_token]
        self._token_to_idx = {unknown_token: 0}
        self._idx_to_vec = None
        self._idx_to_vec_np = None   # host cache: one copy, not per lookup
        self._vec_len = 0

    # -- loading ----------------------------------------------------------
    def _load_embedding_txt(self, path, elem_delim=" ", encoding="utf8"):
        """Parse `token v0 v1 ...` lines (the GloVe/fastText text format).
        reference: embedding.py (_load_embedding)."""
        vectors = []
        loaded_unk = None
        with io.open(path, "r", encoding=encoding) as f:
            for lineno, line in enumerate(f):
                parts = line.rstrip().split(elem_delim)
                if lineno == 0 and len(parts) == 2 and \
                        parts[0].isdigit() and parts[1].isdigit():
                    continue    # fastText header "count dim"
                token, elems = parts[0], parts[1:]
                if not elems:
                    logging.warning("line %d: token with no vector, skipped",
                                    lineno + 1)
                    continue
                vec = _np.asarray([float(e) for e in elems], _np.float32)
                if self._vec_len == 0:
                    self._vec_len = vec.shape[0]
                elif vec.shape[0] != self._vec_len:
                    logging.warning("line %d: dim %d != %d, skipped",
                                    lineno + 1, vec.shape[0], self._vec_len)
                    continue
                if token == self._unknown_token:
                    # the file ships a trained unknown vector — prefer it
                    # over init_unknown_vec (reference _load_embedding)
                    loaded_unk = vec
                    continue
                if token in self._token_to_idx:
                    continue
                self._token_to_idx[token] = len(self._idx_to_token)
                self._idx_to_token.append(token)
                vectors.append(vec)
        unk = (loaded_unk if loaded_unk is not None else
               self._init_unknown_vec((self._vec_len,))).astype(_np.float32)
        self._idx_to_vec = nd.array(
            _np.vstack([unk[None]] + [v[None] for v in vectors]))

    # -- API --------------------------------------------------------------
    def __len__(self):
        return len(self._idx_to_token)

    def __contains__(self, token):
        return token in self._token_to_idx

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    def _vecs_np(self):
        if self._idx_to_vec_np is None:
            self._idx_to_vec_np = _np.array(self._idx_to_vec.asnumpy())
        return self._idx_to_vec_np

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        """Token(s) -> vector(s) NDArray.
        reference: embedding.py (get_vecs_by_tokens)."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        idx = []
        for t in toks:
            if t in self._token_to_idx:
                idx.append(self._token_to_idx[t])
            elif lower_case_backup and t.lower() in self._token_to_idx:
                idx.append(self._token_to_idx[t.lower()])
            else:
                idx.append(0)
        vecs = self._vecs_np()[idx]
        out = nd.array(vecs[0] if single else vecs)
        return out

    def update_token_vectors(self, tokens, new_vectors):
        """Overwrite vectors of known tokens.
        reference: embedding.py (update_token_vectors)."""
        if isinstance(tokens, str):
            tokens = [tokens]
        arr = _np.array(self._vecs_np())   # asnumpy views are read-only
        newv = new_vectors.asnumpy() if isinstance(new_vectors, nd.NDArray) \
            else _np.asarray(new_vectors)
        newv = newv.reshape(len(tokens), -1)
        for t, v in zip(tokens, newv):
            if t not in self._token_to_idx:
                raise ValueError("token %r is unknown; only known tokens "
                                 "can be updated" % (t,))
            arr[self._token_to_idx[t]] = v
        self._idx_to_vec = nd.array(arr)
        self._idx_to_vec_np = arr

    def __getitem__(self, tokens):
        return self.get_vecs_by_tokens(tokens)


@register
class CustomEmbedding(TokenEmbedding):
    """Embedding from a local `token v0 v1 ...` text file.
    reference: embedding.py (CustomEmbedding)."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 encoding="utf8", **kwargs):
        super().__init__(**kwargs)
        self._load_embedding_txt(pretrained_file_path, elem_delim, encoding)


class _PretrainedEmbedding(TokenEmbedding):
    """Shared loader for named pretrained sources living under
    embedding_root (nothing is downloaded: the files must already be on
    disk)."""

    pretrained_file_names = ()

    def __init__(self, pretrained_file_name, embedding_root=None, **kwargs):
        super().__init__(**kwargs)
        if pretrained_file_name not in self.pretrained_file_names:
            raise KeyError(
                "unknown pretrained file %r for %s (choose from %s)"
                % (pretrained_file_name, type(self).__name__,
                   list(self.pretrained_file_names)))
        root = embedding_root or os.path.join(
            os.path.expanduser("~"), ".mxnet", "embeddings",
            type(self).__name__.lower())
        path = os.path.join(root, pretrained_file_name)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                "%s not found. This package downloads nothing: place the "
                "file at that path (reference downloads it from the %s "
                "repository)." % (path, type(self).__name__))
        self._load_embedding_txt(path)


@register
class GloVe(_PretrainedEmbedding):
    """reference: embedding.py (GloVe)."""

    pretrained_file_names = (
        "glove.42B.300d.txt", "glove.6B.50d.txt", "glove.6B.100d.txt",
        "glove.6B.200d.txt", "glove.6B.300d.txt", "glove.840B.300d.txt",
        "glove.twitter.27B.25d.txt", "glove.twitter.27B.50d.txt",
        "glove.twitter.27B.100d.txt", "glove.twitter.27B.200d.txt")


@register
class FastText(_PretrainedEmbedding):
    """reference: embedding.py (FastText)."""

    pretrained_file_names = (
        "wiki.en.vec", "wiki.simple.vec", "crawl-300d-2M.vec")


class CompositeEmbedding(TokenEmbedding):
    """Concatenate several embeddings over one vocabulary.
    reference: embedding.py (CompositeEmbedding)."""

    def __init__(self, vocabulary, token_embeddings):
        assert isinstance(vocabulary, Vocabulary)
        if not isinstance(token_embeddings, (list, tuple)):
            token_embeddings = [token_embeddings]
        super().__init__(unknown_token=vocabulary.unknown_token)
        self._vocab = vocabulary
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = dict(vocabulary.token_to_idx)
        parts = []
        for emb in token_embeddings:
            parts.append(emb.get_vecs_by_tokens(
                self._idx_to_token).asnumpy())
        mat = _np.concatenate(parts, axis=1)
        self._vec_len = mat.shape[1]
        self._idx_to_vec = nd.array(mat)

    @property
    def vocabulary(self):
        return self._vocab
