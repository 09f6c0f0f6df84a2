"""Generic MLP (counterpart of ``blt_vqg_tpu/ops/mlp.py``): the image-feature
reconstructor.  He-normal kernels (std sqrt(2/fan_in)), zero biases; dropout
after each hidden ReLU (rate 0 by default, as in the JAX package)."""

from __future__ import annotations

import math

import torch
from torch import nn

from blt_vqg_tpu_torch.ops.layers import Dense, dropout


class MLP(nn.Module):
    def __init__(self, in_size: int, hidden_size: int, out_size: int,
                 num_layers: int = 1, dtype=torch.bfloat16,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_layers, self.dropout_rate = num_layers, dropout_rate
        dims = [in_size] + [hidden_size] * (num_layers - 1) + [out_size]
        for i in range(num_layers):
            self.add_module(f"fc{i}", Dense(
                dims[i], dims[i + 1], dtype=dtype,
                init_std=math.sqrt(2.0 / dims[i])))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if i != self.num_layers - 1:
                x = dropout(torch.relu(x), self.dropout_rate, generator)
        return x
