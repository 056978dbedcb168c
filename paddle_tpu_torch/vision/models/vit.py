"""The Vision Transformer: the port of
``paddle_tpu/vision/models/vit.py``.

A strided ``Conv2D`` cuts the image into patch tokens, a class token and
learned position embeddings are added, and pre-LN blocks of
``nn.MultiHeadAttention`` (through the no-cache attention dispatch: the
CUDA flash kernels on the card, MHA, head dim 64 at ViT-B/16, S = 197
non-causal) and a GELU MLP follow; the head reads the class token.
Built on ``device`` (the card unless ``device="cpu"``) in ``dtype`` from
``generator``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from ...nn.activation import GELU
from ...nn.common import Dropout, Linear, make_parameter
from ...nn.container import LayerList, Sequential
from ...nn.conv import Conv2D
from ...nn.initializer import Constant, TruncatedNormal
from ...nn.norm import LayerNorm
from ...nn.transformer import MultiHeadAttention


class PatchEmbed(nn.Module):
    """Image ``[B, C, H, W]`` → patch tokens ``[B, N, E]`` by a strided
    conv."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 embed_dim=768, device=None, dtype=None, generator=None):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = Conv2D(in_chans, embed_dim, kernel_size=patch_size,
                           stride=patch_size, device=device, dtype=dtype,
                           generator=generator)

    def forward(self, x):
        x = self.proj(x)                               # [B, E, H/P, W/P]
        return x.reshape(x.shape[0], x.shape[1], -1).transpose(1, 2)


class ViTBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 dropout=0.0, epsilon=1e-6, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        norm = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(dim, epsilon=epsilon, **norm)
        self.attn = MultiHeadAttention(dim, num_heads, dropout=dropout,
                                       need_weights=False, **kw)
        self.norm2 = LayerNorm(dim, epsilon=epsilon, **norm)
        hidden = int(dim * mlp_ratio)
        self.mlp = Sequential(Linear(dim, hidden, **kw), GELU(),
                              Dropout(dropout), Linear(hidden, dim, **kw),
                              Dropout(dropout))

    def forward(self, x):
        h = self.norm1(x)
        x = x + self.attn(h, h, h)
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """ViT-B/16 defaults: a ``class_num`` head, learned position
    embeddings and a class token."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 class_num=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, qkv_bias=True, drop_rate=0.0, epsilon=1e-6,
                 device=None, dtype=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.class_num = class_num
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, **kw)
        n = self.patch_embed.num_patches
        self.cls_token = make_parameter(None, Constant(0.0),
                                        (1, 1, embed_dim), **kw)
        self.pos_embed = make_parameter(None, TruncatedNormal(std=0.02),
                                        (1, n + 1, embed_dim), **kw)
        self.pos_drop = Dropout(drop_rate)
        self.blocks = LayerList([
            ViTBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate,
                     epsilon, **kw) for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, epsilon=epsilon, device=device,
                              dtype=dtype)
        self.head = (Linear(embed_dim, class_num, **kw)
                     if class_num > 0 else None)

    def forward(self, x):
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        # a bf16 token (AMP's conv) beside the fp32 class token: the JAX
        # concatenate promotes to fp32, and so does torch.cat
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        x = self.pos_drop(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        if self.head is None:
            return x
        return self.head(x[:, 0])


def vit_base_patch16_224(**kwargs):
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12, **kwargs)


def vit_large_patch16_224(**kwargs):
    return VisionTransformer(embed_dim=1024, depth=24, num_heads=16,
                             **kwargs)
