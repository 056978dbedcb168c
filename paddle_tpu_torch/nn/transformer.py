"""Transformer layers: the port of ``paddle_tpu/nn/transformer.py``.

``MultiHeadAttention`` projects with four ``Linear`` layers and attends
through ``F.scaled_dot_product_attention`` on ``[B, S, heads, head_dim]``:
with no mask and no dropout that is the no-cache dispatch of
``ops/flash_attention.py`` (the CUDA flash kernels on the card; a shape
they cannot take raises there), with a mask the composite.  A boolean mask
becomes ``0`` where True and ``-1e9`` elsewhere, in the query's dtype
(``_convert_attention_mask``).  ``Cache`` grows the keys and values of
incremental decoding; ``StaticCache`` holds a cross-attention's projected
memory.

The layers register their sub-layers in the JAX order, so
``convert.paddle_parameter_order`` gives the JAX parameter list.  Built on
``device`` in ``dtype`` from ``generator``; dropouts draw from torch's
default generator.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from . import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


def _convert_attention_mask(attn_mask, dtype):
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        zero = torch.zeros((), dtype=dtype, device=attn_mask.device)
        neg = torch.full((), -1e9, dtype=dtype, device=attn_mask.device)
        return torch.where(attn_mask, zero, neg)
    return attn_mask.to(dtype)


class MultiHeadAttention(nn.Module):
    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    class StaticCache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _shape_kv(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        if type == MultiHeadAttention.StaticCache:
            k = self._shape_kv(self.k_proj(key))
            v = self._shape_kv(self.v_proj(value if value is not None
                                           else key))
            return self.StaticCache(k, v)
        empty = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                            dtype=key.dtype, device=key.device)
        return self.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        B, Sq = query.shape[0], query.shape[1]
        q = self._shape_kv(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape_kv(self.k_proj(key))
            v = self._shape_kv(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        mask = _convert_attention_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(B, Sq, self.embed_dim))
        if cache is not None and not isinstance(cache, self.StaticCache):
            return (out, None, cache) if self.need_weights else (out, cache)
        if self.need_weights:
            return out, None
        return out


def _ffn_parts(layer, d_model, dim_feedforward, act_dropout, weight_attr,
               bias_attr, kw):
    """``linear1``, ``dropout``, ``linear2``, registered in the JAX order."""
    layer.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr,
                           **kw)
    layer.dropout = Dropout(act_dropout)
    layer.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr,
                           **kw)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, device=None, dtype=None,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        _ffn_parts(self, d_model, dim_feedforward, act_dropout,
                   weight_attr, bias_attr, kw)
        norm = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **norm)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **norm)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output, new_caches = src, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, device=None, dtype=None,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **kw)
        _ffn_parts(self, d_model, dim_feedforward, act_dropout,
                   weight_attr, bias_attr, kw)
        norm = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **norm)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **norm)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, **norm)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            static_cache = None
        else:
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
            static_cache = cache[1]
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if static_cache is not None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                                  static_cache)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr, static_cache))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output, new_caches = tgt, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(nn.Module):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        kw = dict(device=device, dtype=dtype, generator=generator)
        norm = dict(device=device, dtype=dtype)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            enc_norm = LayerNorm(d_model, **norm) if normalize_before \
                else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            dec_norm = LayerNorm(d_model, **norm) if normalize_before \
                else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``[length, length]`` fp32: 0 on and below the diagonal, -inf
        above."""
        return torch.triu(torch.full((length, length), float("-inf"),
                                     device=device), diagonal=1)
