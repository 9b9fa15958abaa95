"""Text vocabulary. reference: python/mxnet/contrib/text/vocab.py
(Vocabulary): frequency-sorted indexing with reserved tokens and an
unknown-token slot at index 0."""
from __future__ import annotations

import collections

__all__ = ["Vocabulary"]


class Vocabulary:
    """Maps tokens <-> indices. Index 0 is the unknown token; reserved
    tokens follow; then corpus tokens by descending frequency (ties broken
    alphabetically, like the reference).

    counter: collections.Counter of token frequencies (None -> only the
    unknown + reserved tokens). most_freq_count caps the number of corpus
    tokens kept; min_freq drops rare tokens."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be >= 1")
        if reserved_tokens is not None:
            seen = set(reserved_tokens)
            if len(seen) != len(reserved_tokens) or unknown_token in seen:
                raise ValueError("reserved tokens must be unique and must "
                                 "not contain the unknown token")
        self._unknown_token = unknown_token
        self._reserved_tokens = (list(reserved_tokens)
                                 if reserved_tokens else None)
        self._idx_to_token = [unknown_token] + (
            list(reserved_tokens) if reserved_tokens else [])
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            self._index_counter(counter, most_freq_count, min_freq)

    def _index_counter(self, counter, most_freq_count, min_freq):
        assert isinstance(counter, collections.Counter), \
            "counter must be a collections.Counter"
        # frequency desc, then token asc — the reference's ordering
        pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        kept = 0
        for token, freq in pairs:
            if freq < min_freq:
                break
            if most_freq_count is not None and kept >= most_freq_count:
                break
            if token not in self._token_to_idx:
                self._token_to_idx[token] = len(self._idx_to_token)
                self._idx_to_token.append(token)
                kept += 1

    def __len__(self):
        return len(self._idx_to_token)

    def __contains__(self, token):
        return token in self._token_to_idx

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token(s) -> index/indices (unknown -> 0).
        reference: vocab.py (Vocabulary.to_indices)."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices):
        """Index/indices -> token(s). reference: Vocabulary.to_tokens."""
        single = isinstance(indices, int)
        idxs = [indices] if single else indices
        out = []
        for i in idxs:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError("token index %d out of range [0, %d)"
                                 % (i, len(self._idx_to_token)))
            out.append(self._idx_to_token[i])
        return out[0] if single else out
