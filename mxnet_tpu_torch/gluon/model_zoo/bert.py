"""BERT through the Gluon API (the port of
`mxnet_tpu.gluon.model_zoo.bert`): GluonNLP's BERTModel over the
interleaved self-attention ops (`_contrib_interleaved_matmul_selfatt_qk` /
`_valatt`), in TNC layout inside the encoder, with the reference's
parameter names, so `.params` files cross between the two packages.

Outputs in GluonNLP's order: (sequence output[, pooled][, next-sentence
logits][, masked-LM logits]). With `valid_length` the padded key
positions get an additive -1e9 mask; as in the reference, that fp32 mask
promotes the scores (and what follows) of a bf16 model to fp32.
"""
from __future__ import annotations

from ..block import HybridBlock
from .. import nn

__all__ = ["BERTEncoderCell", "BERTEncoder", "BERTModel",
           "bert_12_768_12", "bert_24_1024_16", "get_bert_model"]


class BERTEncoderCell(HybridBlock):
    """One transformer encoder layer: self-attention and FFN, each with a
    post-layernorm residual."""

    def __init__(self, units=768, hidden_size=3072, num_heads=12,
                 dropout=0.1, layer_norm_eps=1e-12, **kwargs):
        super().__init__(**kwargs)
        self._num_heads = num_heads
        with self.name_scope():
            self.attention_qkv = nn.Dense(3 * units, flatten=False,
                                          prefix="qkv_")
            self.attention_proj = nn.Dense(units, flatten=False,
                                           prefix="proj_")
            self.attention_dropout = nn.Dropout(dropout)
            self.layer_norm = nn.LayerNorm(epsilon=layer_norm_eps,
                                           prefix="ln1_")
            self.ffn_1 = nn.Dense(hidden_size, flatten=False, prefix="ffn1_")
            self.activation = nn.GELU()
            self.ffn_2 = nn.Dense(units, flatten=False, prefix="ffn2_")
            self.dropout_layer = nn.Dropout(dropout)
            self.ffn_layer_norm = nn.LayerNorm(epsilon=layer_norm_eps,
                                               prefix="ln2_")

    def hybrid_forward(self, F, x, mask=None):
        # x: (seq, batch, units); mask: additive (batch*heads, seq, seq)
        qkv = self.attention_qkv(x)
        scores = F.contrib.interleaved_matmul_selfatt_qk(
            qkv, heads=self._num_heads)
        if mask is not None:
            scores = scores + mask
        att = F.softmax(scores, axis=-1)
        att = self.attention_dropout(att)
        out = F.contrib.interleaved_matmul_selfatt_valatt(
            qkv, att, heads=self._num_heads)
        x = self.layer_norm(x + self.dropout_layer(
            self.attention_proj(out)))
        y = self.ffn_2(self.activation(self.ffn_1(x)))
        return self.ffn_layer_norm(x + self.dropout_layer(y))


class BERTEncoder(HybridBlock):
    """Embedding sum (word + position + token type), layernorm, dropout and
    N encoder cells."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 token_type_vocab_size=2, dropout=0.1,
                 layer_norm_eps=1e-12, **kwargs):
        super().__init__(**kwargs)
        self._num_heads = num_heads
        self._max_length = max_length
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, units,
                                           prefix="word_embed_")
            self.token_type_embed = nn.Embedding(token_type_vocab_size,
                                                 units,
                                                 prefix="token_type_embed_")
            # no init of its own: the initializer given to initialize()
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units))
            self.embed_layer_norm = nn.LayerNorm(epsilon=layer_norm_eps,
                                                 prefix="embed_ln_")
            self.embed_dropout = nn.Dropout(dropout)
            self.transformer_cells = []
            for i in range(num_layers):
                cell = BERTEncoderCell(units=units, hidden_size=hidden_size,
                                       num_heads=num_heads, dropout=dropout,
                                       layer_norm_eps=layer_norm_eps,
                                       prefix="layer%d_" % i)
                self.register_child(cell)
                self.transformer_cells.append(cell)

    def _length_mask(self, F, inputs, valid_length):
        """(batch,) valid lengths -> additive (batch*heads, seq, seq) mask,
        -1e9 on the padded key positions."""
        seq = inputs.shape[1]
        steps = F.arange(seq, ctx=inputs.context)
        valid = F.broadcast_lesser(steps.reshape((1, -1)),
                                   valid_length.reshape((-1, 1)))
        neg = (1.0 - valid) * -1e9
        mask = neg.reshape((-1, 1, 1, seq)).broadcast_to(
            (valid_length.shape[0], self._num_heads, seq, seq))
        return mask.reshape((-3, 0, 0))

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None,
                       position_weight=None):
        # inputs: (batch, seq) token ids
        seq = inputs.shape[1]
        x = self.word_embed(inputs)
        if token_types is None:
            token_types = F.zeros_like(inputs)
        x = x + self.token_type_embed(token_types)
        pos = F.slice_axis(position_weight, axis=0, begin=0, end=seq)
        x = x + pos.reshape((1, seq, -1))
        x = self.embed_dropout(self.embed_layer_norm(x))
        mask = (None if valid_length is None
                else self._length_mask(F, inputs, valid_length))
        x = F.transpose(x, axes=(1, 0, 2))   # NTC -> TNC
        for cell in self.transformer_cells:
            x = cell(x, mask) if mask is not None else cell(x)
        return F.transpose(x, axes=(1, 0, 2))  # TNC -> NTC


class BERTModel(HybridBlock):
    """Encoder, pooler, masked-LM decoder and next-sentence classifier."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 token_type_vocab_size=2, dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True, **kwargs):
        super().__init__(**kwargs)
        if use_classifier and not use_pooler:
            raise ValueError("BERTModel: use_classifier=True requires "
                             "use_pooler=True (pass use_classifier=False)")
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier
        with self.name_scope():
            self.encoder = BERTEncoder(
                vocab_size=vocab_size, units=units, hidden_size=hidden_size,
                num_layers=num_layers, num_heads=num_heads,
                max_length=max_length,
                token_type_vocab_size=token_type_vocab_size,
                dropout=dropout, prefix="encoder_")
            if use_pooler:
                self.pooler = nn.Dense(units, activation="tanh",
                                       flatten=False, prefix="pooler_")
            if use_decoder:
                # MLM head: transform, GELU, layernorm, vocab projection
                self.decoder = nn.HybridSequential(prefix="decoder_")
                with self.decoder.name_scope():
                    self.decoder.add(nn.Dense(units, flatten=False))
                    self.decoder.add(nn.GELU())
                    self.decoder.add(nn.LayerNorm(epsilon=1e-12))
                    self.decoder.add(nn.Dense(vocab_size, flatten=False))
            if use_classifier:
                self.classifier = nn.Dense(2, flatten=False,
                                           prefix="nsp_")

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None):
        seq_out = self.encoder(inputs, token_types, valid_length)
        outputs = [seq_out]
        pooled = None
        if self._use_pooler:
            cls = F.slice_axis(seq_out, axis=1, begin=0, end=1)
            pooled = self.pooler(cls.reshape((0, -1)))
            outputs.append(pooled)
        if self._use_classifier and pooled is not None:
            outputs.append(self.classifier(pooled))
        if self._use_decoder:
            outputs.append(self.decoder(seq_out))
        return outputs[0] if len(outputs) == 1 else tuple(outputs)


_PRESETS = {
    "bert_12_768_12": dict(units=768, hidden_size=3072, num_layers=12,
                           num_heads=12),
    "bert_24_1024_16": dict(units=1024, hidden_size=4096, num_layers=24,
                            num_heads=16),
}


def get_bert_model(model_name="bert_12_768_12", vocab_size=30522,
                   dropout=0.1, **kwargs):
    """A BERTModel by GluonNLP's name, bert_{layers}_{units}_{heads}."""
    if model_name not in _PRESETS:
        raise ValueError("unknown BERT preset %r (have %s)"
                         % (model_name, sorted(_PRESETS)))
    cfg = dict(_PRESETS[model_name])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, dropout=dropout, **cfg)


def bert_12_768_12(**kwargs):
    """BERT-base."""
    return get_bert_model("bert_12_768_12", **kwargs)


def bert_24_1024_16(**kwargs):
    """BERT-large."""
    return get_bert_model("bert_24_1024_16", **kwargs)
