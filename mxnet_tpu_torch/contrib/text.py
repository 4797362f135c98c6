"""``mx.contrib.text``: vocabulary and token embeddings.

The port's own copy of ``mxnet_tpu/contrib/text.py`` (host code; reference:
python/mxnet/contrib/text/: vocab.py ``Vocabulary``, embedding.py
``TokenEmbedding`` / ``GloVe`` / ``FastText`` / ``CustomEmbedding``,
utils.py ``count_tokens_from_str``). The named pretrained classes read
files provisioned under ``<config home>/embeddings/<name>/`` and raise
when one is missing; nothing is downloaded. ``idx_to_vec`` is an
``mx.np`` array on the current context.
"""
from __future__ import annotations

import io
import os
import re

import numpy as onp

from ..base import MXNetError


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Reference: text/utils.py count_tokens_from_str."""
    import collections
    source_str = re.sub(
        f"({re.escape(token_delim)})|({re.escape(seq_delim)})", " ",
        source_str)
    if to_lower:
        source_str = source_str.lower()
    counter = (collections.Counter() if counter_to_update is None
               else counter_to_update)
    counter.update(source_str.split())
    return counter


class Vocabulary:
    """Indexed vocabulary from a token counter (reference: text/vocab.py).

    Index 0 is the unknown token; reserved tokens follow; then counted
    tokens by frequency (ties broken alphabetically)."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise MXNetError("min_freq must be >= 1")
        reserved_tokens = list(reserved_tokens or [])
        if unknown_token in reserved_tokens or \
                len(set(reserved_tokens)) != len(reserved_tokens):
            raise MXNetError("reserved tokens must be unique and must not "
                             "contain the unknown token")
        self._unknown_token = unknown_token
        self._reserved_tokens = reserved_tokens or None
        self._idx_to_token = [unknown_token] + reserved_tokens
        if counter is not None:
            pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
            if most_freq_count is not None:
                pairs = pairs[:most_freq_count]
            skip = set(self._idx_to_token)
            for tok, freq in pairs:
                if freq >= min_freq and tok not in skip:
                    self._idx_to_token.append(tok)
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}

    def __len__(self):
        return len(self._idx_to_token)

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
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices):
        single = isinstance(indices, int)
        idxs = [indices] if single else indices
        out = []
        for i in idxs:
            if not 0 <= i < len(self._idx_to_token):
                raise MXNetError(f"token index {i} out of range")
            out.append(self._idx_to_token[i])
        return out[0] if single else out


class TokenEmbedding(Vocabulary):
    """Token -> vector table (reference: text/embedding.py TokenEmbedding).

    ``idx_to_vec`` is an mx ndarray (len(vocab), dim); unknown tokens map
    to ``init_unknown_vec`` (zeros by default)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._idx_to_vec = None
        self._vec_len = 0

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    def _load_embedding_txt(self, path, elem_delim=" ",
                            init_unknown_vec=onp.zeros, encoding="utf8"):
        tokens, vecs = [], []
        with io.open(path, "r", encoding=encoding) as f:
            for line_num, line in enumerate(f):
                parts = line.rstrip().split(elem_delim)
                if line_num == 0 and len(parts) == 2 and \
                        all(p.isdigit() for p in parts):
                    continue  # fastText header "count dim"
                if len(parts) < 3:
                    continue
                tokens.append(parts[0])
                vecs.append(onp.asarray([float(x) for x in parts[1:]],
                                        "float32"))
        if not tokens:
            raise MXNetError(f"no embedding vectors found in {path}")
        self._vec_len = len(vecs[0])
        table = {t: v for t, v in zip(tokens, vecs)}
        # extend the index with embedding tokens not already present
        for t in tokens:
            if t not in self._token_to_idx:
                self._token_to_idx[t] = len(self._idx_to_token)
                self._idx_to_token.append(t)
        mat = onp.stack(
            [table.get(t, init_unknown_vec(self._vec_len).astype("float32"))
             for t in self._idx_to_token])
        from ..numpy import array
        self._idx_to_vec = array(mat)

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        idxs = []
        for t in toks:
            i = self._token_to_idx.get(t, 0)
            if i == 0 and lower_case_backup:
                i = self._token_to_idx.get(t.lower(), 0)
            idxs.append(i)
        vecs = self._idx_to_vec[onp.asarray(idxs)]
        return vecs[0] if single else vecs

    def update_token_vectors(self, tokens, new_vectors):
        from ..numpy import array
        toks = [tokens] if isinstance(tokens, str) else tokens
        mat = onp.array(self._idx_to_vec.asnumpy())  # writable copy
        new = onp.asarray(new_vectors.asnumpy()
                          if hasattr(new_vectors, "asnumpy")
                          else new_vectors, "float32").reshape(len(toks), -1)
        for t, v in zip(toks, new):
            if t not in self._token_to_idx:
                raise MXNetError(f"token {t!r} is not in the vocabulary")
            mat[self._token_to_idx[t]] = v
        self._idx_to_vec = array(mat)


class CustomEmbedding(TokenEmbedding):
    """Embedding from a user text file: '<token> <v0> <v1> ...' per line
    (reference: embedding.py CustomEmbedding)."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 encoding="utf8", init_unknown_vec=onp.zeros, **kwargs):
        super().__init__(**kwargs)
        self._load_embedding_txt(pretrained_file_path, elem_delim,
                                 init_unknown_vec, encoding)


class _ProvisionedEmbedding(TokenEmbedding):
    """Named pretrained source loading from MXNET_HOME/embeddings/<name>/
    (nothing is downloaded; the reference downloads from its repo)."""

    _source_dir = None

    def __init__(self, pretrained_file_name, init_unknown_vec=onp.zeros,
                 **kwargs):
        super().__init__(**kwargs)
        from .. import config
        root = os.path.join(os.path.expanduser(config.get("home")),
                            "embeddings", self._source_dir)
        path = os.path.join(root, pretrained_file_name)
        if not os.path.exists(path):
            raise MXNetError(
                f"pretrained embedding file {path} not found; nothing is "
                "downloaded: provision the file there")
        self._load_embedding_txt(path,
                                 init_unknown_vec=init_unknown_vec)


class GloVe(_ProvisionedEmbedding):
    _source_dir = "glove"


class FastText(_ProvisionedEmbedding):
    _source_dir = "fasttext"


def get_pretrained_file_names(embedding_name=None):
    """Reference: embedding.py get_pretrained_file_names — here it lists
    locally provisioned files."""
    from .. import config
    base = os.path.join(os.path.expanduser(config.get("home")), "embeddings")
    names = {"glove": [], "fasttext": []}
    for k in names:
        d = os.path.join(base, k)
        if os.path.isdir(d):
            names[k] = sorted(os.listdir(d))
    if embedding_name is not None:
        return names.get(embedding_name, [])
    return names
