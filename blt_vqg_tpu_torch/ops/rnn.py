"""LSTM and GRU sequence encoder and decoder (counterpart of
``blt_vqg_tpu/ops/rnn.py``).

Plain per-step cell arithmetic in the order of flax's cells, so that the
port matches the JAX package step for step:

- ``LSTMCellStack``: flax's ``OptimizedLSTMCell`` per layer, parameters
  ``ii``/``if``/``ig``/``io`` (input kernels, no bias) and
  ``hi``/``hf``/``hg``/``ho`` (hidden kernels with biases); gate = act(h part
  + x part) for i, f, g, o in that order, c' = f c + i g, h' = o tanh(c');
- ``GRUCellStack``: flax's ``GRUCell``, ``ir``/``iz``/``in`` with biases,
  ``hr``/``hz`` without, ``hn`` with; r, z = sigmoid(x part + h part),
  n = tanh(x_n + r (h_n)), h' = (1 - z) n + z h.

The products run in the compute dtype; the carry starts at zeros in f32
(flax's ``param_dtype``), and the f32 carry promotes what it touches, as
in flax, so a bf16 model carries c and h (and emits its outputs) in f32.
Each call concatenates a layer's gate kernels once and runs one product per
step for the input side and one for the hidden side.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from blt_vqg_tpu_torch.ops.layers import Dense, Embed


def _cat_weights(cell, names, bias: bool):
    """The gates' Dense kernels stacked [G*H, in] (and biases [G*H]) in the
    compute dtype."""
    dt = cell.dtype
    denses = [getattr(cell, n) for n in names]
    w = torch.cat([d.weight for d in denses]).to(dt)
    if not bias:
        return w, None
    return w, torch.cat([d.bias for d in denses]).to(dt)


class LSTMCell(nn.Module):
    GATES = ("i", "f", "g", "o")

    def __init__(self, in_dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        for g in self.GATES:
            self.add_module("i" + g, Dense(in_dim, hidden, bias=False,
                                           dtype=dtype))
            self.add_module("h" + g, Dense(hidden, hidden, dtype=dtype))

    def weights(self):
        wi, _ = _cat_weights(self, ["i" + g for g in self.GATES], False)
        wh, bh = _cat_weights(self, ["h" + g for g in self.GATES], True)
        return wi, wh, bh

    def init_carry(self, batch: int, device):
        z = torch.zeros((batch, self.hidden), dtype=torch.float32,
                        device=device)
        return z, z

    def step(self, w, carry, x):
        wi, wh, bh = w
        c, h = carry
        dt = self.dtype
        dh = torch.nn.functional.linear(h.to(dt), wh, bh).chunk(4, dim=-1)
        di = torch.nn.functional.linear(x.to(dt), wi).chunk(4, dim=-1)
        i = torch.sigmoid(dh[0] + di[0])
        f = torch.sigmoid(dh[1] + di[1])
        g = torch.tanh(dh[2] + di[2])
        o = torch.sigmoid(dh[3] + di[3])
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class GRUCell(nn.Module):
    def __init__(self, in_dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        for g in ("r", "z", "n"):
            self.add_module("i" + g, Dense(in_dim, hidden, dtype=dtype))
        self.hr = Dense(hidden, hidden, bias=False, dtype=dtype)
        self.hz = Dense(hidden, hidden, bias=False, dtype=dtype)
        self.hn = Dense(hidden, hidden, dtype=dtype)

    def weights(self):
        wi, bi = _cat_weights(self, ("ir", "iz", "in"), True)
        wh, _ = _cat_weights(self, ("hr", "hz"), False)
        return wi, bi, wh, self.hn.weight.to(self.dtype), \
            self.hn.bias.to(self.dtype)

    def init_carry(self, batch: int, device):
        return torch.zeros((batch, self.hidden), dtype=torch.float32,
                           device=device)

    def step(self, w, h, x):
        wi, bi, wh, whn, bhn = w
        dt = self.dtype
        xi = torch.nn.functional.linear(x.to(dt), wi, bi).chunk(3, dim=-1)
        hd = h.to(dt)
        hrz = torch.nn.functional.linear(hd, wh).chunk(2, dim=-1)
        r = torch.sigmoid(xi[0] + hrz[0])
        z = torch.sigmoid(xi[1] + hrz[1])
        n = torch.tanh(xi[2] + r * torch.nn.functional.linear(hd, whn, bhn))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class _CellStack(nn.Module):
    """Layers ``cell_{i}``: the first takes ``in_dim`` inputs, the rest the
    layer below's hidden outputs."""

    cell_cls = None

    def __init__(self, in_dim: int, hidden: int, num_layers: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"cell_{i}", self.cell_cls(
                in_dim if i == 0 else hidden, hidden, dtype))

    @property
    def cells(self):
        return [getattr(self, f"cell_{i}") for i in range(self.num_layers)]

    def weights(self):
        return [cell.weights() for cell in self.cells]

    def init_carry(self, batch: int, device):
        return [cell.init_carry(batch, device) for cell in self.cells]

    def step(self, weights, carry, x):
        """One time step through every layer: (new carry, top output)."""
        new_carry = []
        for cell, w, c in zip(self.cells, weights, carry):
            c, x = cell.step(w, c, x)
            new_carry.append(c)
        return new_carry, x

    def scan(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, in] from a zero carry -> the top outputs [B, T, H]."""
        weights = self.weights()
        carry = self.init_carry(x.shape[0], x.device)
        ys = []
        for t in range(x.shape[1]):
            carry, y = self.step(weights, carry, x[:, t])
            ys.append(y)
        return torch.stack(ys, dim=1)


class LSTMCellStack(_CellStack):
    cell_cls = LSTMCell


class GRUCellStack(_CellStack):
    cell_cls = GRUCell


def stack_for(rnn_cell: str, in_dim: int, hidden: int, layers: int, dtype):
    cell = rnn_cell.lower()
    if cell == "lstm":
        return LSTMCellStack(in_dim, hidden, layers, dtype)
    if cell == "gru":
        return GRUCellStack(in_dim, hidden, layers, dtype)
    raise ValueError(f"unknown rnn cell {rnn_cell!r} (lstm|gru)")


class RNNEncoder(nn.Module):
    """Embeds tokens and scans the cell stack; returns the outputs
    [B, T, H] and each row's output at its last non-pad token."""

    def __init__(self, vocab_size: int, emb_dim: int, hidden_size: int,
                 num_layers: int = 1, rnn_cell: str = "lstm",
                 dtype=torch.float32):
        super().__init__()
        self.embed = Embed(vocab_size, emb_dim, dtype,
                           init_std=emb_dim ** -0.5)
        self.stack = stack_for(rnn_cell, emb_dim, hidden_size, num_layers,
                               dtype)

    def forward(self, tokens: torch.Tensor, pad_id: int = 0):
        ys = self.stack.scan(self.embed(tokens))
        t = tokens.shape[1]
        lengths = (tokens != pad_id).sum(dim=1)
        idx = torch.clamp(lengths - 1, 0, t - 1)
        final = ys[torch.arange(ys.shape[0], device=ys.device), idx]
        return ys, final


class RNNDecoder(nn.Module):
    """Teacher-forced decoding and greedy unrolling over the cell stack; the
    vocab head ``out_proj`` computes in f32."""

    def __init__(self, vocab_size: int, emb_dim: int, hidden_size: int,
                 num_layers: int = 1, rnn_cell: str = "lstm",
                 dtype=torch.float32):
        super().__init__()
        self.embed = Embed(vocab_size, emb_dim, dtype,
                           init_std=emb_dim ** -0.5)
        self.in_proj = Dense(emb_dim, hidden_size, dtype=dtype)
        self.stack = stack_for(rnn_cell, hidden_size, hidden_size,
                               num_layers, dtype)
        self.out_proj = Dense(hidden_size, vocab_size, dtype=torch.float32)

    def teacher_forced(self, tokens: torch.Tensor,
                       init_context: Optional[torch.Tensor] = None):
        """tokens [B, T] (already shifted) -> logits [B, T, V] f32;
        ``init_context`` [B, H] is added at step 0."""
        x = self.in_proj(self.embed(tokens))
        if init_context is not None:
            x = torch.cat([x[:, :1] + init_context.to(x.dtype)[:, None],
                           x[:, 1:]], dim=1)
        return self.out_proj(self.stack.scan(x))

    def greedy(self, batch: int, max_len: int, start_id: int,
               init_context: Optional[torch.Tensor] = None,
               device=None) -> torch.Tensor:
        """Greedy unroll from ``start_id``: tokens [B, max_len] int32."""
        weights = self.stack.weights()
        carry = self.stack.init_carry(batch, device)
        token = torch.full((batch,), start_id, dtype=torch.int32,
                           device=device)
        tokens = []
        for i in range(max_len):
            x = self.in_proj(self.embed(token))
            if i == 0 and init_context is not None:
                x = x + init_context.to(x.dtype)
            carry, y = self.stack.step(weights, carry, x)
            token = torch.argmax(self.out_proj(y), dim=-1).to(torch.int32)
            tokens.append(token)
        return torch.stack(tokens, dim=1)
