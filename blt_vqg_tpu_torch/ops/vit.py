"""ViT-B/16 image encoder (counterpart of ``blt_vqg_tpu/ops/vit.py``).

The alternative to the ResNet-18 feature extractor (``image_encoder=
"vit_b16"``): a 16x16 patch embedding by a strided convolution (with bias,
as flax's ``nn.Conv``), a CLS token, learned position embeddings, pre-LN
GELU encoder layers (``ops/transformer.py`` ``EncoderLayer``, flax's tanh
GELU, LayerNorm eps 1e-6), a final LayerNorm, and the CLS row.  The ViT's
own layers take no dropout and the plain attention, never the flash
kernels, whatever ``use_pallas_attention`` says, as in the JAX package.

The backbone sits under ``encoder_cnn.backbone.``, so the optimizer's
frozen-backbone rule (train/state.py ``is_frozen``) freezes it unchanged;
``fc`` and ``feat_bn`` train.  Images are NHWC; the patch kernel is stored
OIHW (``convert.py`` maps flax's HWIO).  Weights are made from a seed:
nothing pretrained is downloaded.
"""

from __future__ import annotations

import torch
from torch import nn

from blt_vqg_tpu_torch.ops.layers import BatchNorm, Conv, Dense, LayerNorm
from blt_vqg_tpu_torch.ops.transformer import EncoderLayer

POS_STD = 0.02


class ViTBackbone(nn.Module):
    def __init__(self, image_size: int, patch: int = 16, depth: int = 12,
                 dim: int = 768, heads: int = 12, mlp_dim: int = 3072,
                 dtype=torch.bfloat16):
        super().__init__()
        self.depth, self.dim = depth, dim
        n = (image_size // patch) ** 2
        self.patch_embed = Conv(3, dim, patch, patch, 0, dtype, bias=True)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim))
        for i in range(depth):
            self.add_module(f"block_{i}", EncoderLayer(
                dim, heads, mlp_dim, dtype, attention_dropout=0.0,
                relu_dropout=0.0, layer_dropout=0.0, activation="gelu"))
        self.final_ln = LayerNorm(dim, dtype)

    @torch.no_grad()
    def seed_init(self, generator: torch.Generator) -> None:
        """The JAX initializers: a zero CLS token, position embeddings
        normal(0.02)."""
        self.cls_token.zero_()
        self.pos_embed.copy_(torch.randn(self.pos_embed.shape,
                                         generator=generator) * POS_STD)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, S, S] (NCHW) -> the CLS feature [B, dim]."""
        x = self.patch_embed(x)                       # [B, dim, S/p, S/p]
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)              # [B, n, dim], row-major
        cls = self.cls_token.expand(b, 1, self.dim).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        return self.final_ln(x)[:, 0]


class ViTEncoder(nn.Module):
    """Frozen ViT backbone + trainable fc + batch norm (momentum 0.99): a
    drop-in for ``EncoderCNN``, images [B, H, W, 3] -> [B, hidden]."""

    def __init__(self, hidden_dim: int, image_size: int,
                 dtype=torch.bfloat16, patch: int = 16, depth: int = 12,
                 dim: int = 768, heads: int = 12, mlp_dim: int = 3072):
        super().__init__()
        self.backbone = ViTBackbone(image_size, patch, depth, dim, heads,
                                    mlp_dim, dtype)
        self.fc = Dense(dim, hidden_dim, dtype=dtype, init_std=0.02)
        self.feat_bn = BatchNorm(hidden_dim, dtype, momentum=0.99)
        self.dtype = dtype

    def forward(self, images: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        return self.feat_bn(self.fc(self.backbone(x)), train)
