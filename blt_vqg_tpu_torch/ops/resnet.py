"""ResNet-18 image encoder (counterpart of ``blt_vqg_tpu/ops/resnet.py``).

``train=True`` normalises with the batch statistics and updates the running
statistics (flax momentum 0.9 in the backbone, 0.99 in ``feat_bn``); the
default eval mode uses the running statistics.  The backbone is frozen in
training (the train state turns off its gradients), but its batch-norm
statistics still update, as in the JAX package.

The public input stays NHWC [B, H, W, 3], as in the JAX package; it is
transposed to NCHW once for ``torch.nn.functional.conv2d``.  Convolutions
are library calls, as in the JAX package, which leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from blt_vqg_tpu_torch.ops.layers import BatchNorm, Conv, Dense


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = Conv(cin, filters, 3, stride, 1, dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, filters, 3, 1, 1, dtype)
        self.bn2 = BatchNorm(filters, dtype)
        self.has_down = stride != 1 or cin != filters
        if self.has_down:
            # flax's "SAME" padding of a 1x1 kernel is no padding
            self.down_conv = Conv(cin, filters, 1, stride, 0, dtype)
            self.down_bn = BatchNorm(filters, dtype)

    def forward(self, x, train: bool = False):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = (self.down_bn(self.down_conv(x), train) if self.has_down
                    else x)
        return torch.relu(y + residual)


class ResNet18Backbone(nn.Module):
    """Conv stem + 4 stages of 2 BasicBlocks + global average pool, NCHW in,
    [B, 512] out.  Blocks are registered as ``stage{s}_block{b}``."""

    def __init__(self, dtype=torch.bfloat16,
                 stage_sizes=(2, 2, 2, 2), stage_filters=(64, 128, 256, 512)):
        super().__init__()
        self.stem_conv = Conv(3, 64, 7, 2, 3, dtype)
        self.stem_bn = BatchNorm(64, dtype)
        self.block_names = []
        cin = 64
        for stage, (blocks, filters) in enumerate(zip(stage_sizes,
                                                      stage_filters)):
            for block in range(blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage}_block{block}"
                self.add_module(name, BasicBlock(cin, filters, stride, dtype))
                self.block_names.append(name)
                cin = filters

    def forward(self, x, train: bool = False):
        x = torch.relu(self.stem_bn(self.stem_conv(x), train))
        x = F.max_pool2d(x, 3, 2, 1)   # pads with -inf, as flax max_pool
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return x.mean(dim=(2, 3))


class EncoderCNN(nn.Module):
    """Backbone + fc(512→hidden) + batch norm over the features."""

    def __init__(self, hidden_dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.backbone = ResNet18Backbone(dtype)
        self.fc = Dense(512, hidden_dim, dtype=dtype, init_std=0.02)
        self.feat_bn = BatchNorm(hidden_dim, dtype, momentum=0.99)
        self.dtype = dtype

    def forward(self, images: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        """images [B, H, W, 3] NHWC float -> [B, hidden] in ``dtype``."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        return self.feat_bn(self.fc(self.backbone(x, train)), train)
