"""Pre-LN transformer encoder and decoder stacks (counterpart of
``blt_vqg_tpu/ops/transformer.py``).

The full-sequence forwards (the encoders, and the teacher-forced decoder)
take a ``generator``: with one, input, attention, ReLU and layer dropout
are drawn from it at the configured rates (train mode); without one they
are deterministic.

The decoder exposes the KV-cache decode step in three forms that compute
the same function:

- the plain step: per layer, :meth:`DecoderLayer.step` over caches
  [B, L, H, Dh];
- the per-layer step (``use_pallas_decode=True``): per layer, the two fused
  ops of ``ops/kernels/decode_layer.py`` over caches [H, L, B, Dh], with the
  layer's regrouped weights from :meth:`DecoderLayer.decode_weights`;
- the streaming step (``use_stream_decode=True``, which takes precedence):
  the whole stack in one call of
  ``ops/kernels/decode_stream.decode_stack_step`` over one stacked cache
  pair [Layers, H, L, B, Dh], with the loop-invariant stacked weights from
  :meth:`TransformerDecoder.stream_prep`.

All write the caches in place; :attr:`TransformerDecoder.cache_batch_axis`
names the batch axis of each layout.  Not ported yet (ROADMAP.md): MoE
FFNs and GPipe; asking for them raises.
``remat`` (the JAX package's activation recompute) is not carried: it
changes memory, not values.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from blt_vqg_tpu_torch.ops.attention import MultiHeadAttention
from blt_vqg_tpu_torch.ops.kernels import decode_layer, decode_stream
from blt_vqg_tpu_torch.ops.layers import Dense, LayerNorm, cached, dropout
from blt_vqg_tpu_torch.ops.timing import timing_signal


class PositionwiseFeedForward(nn.Module):
    """linear -> ReLU -> dropout -> linear; ``compat_trailing_relu`` adds
    the reference's ReLU + dropout after the last linear too."""

    def __init__(self, hidden_dim: int, pwffn_dim: int, dtype,
                 compat_trailing_relu: bool = False,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.ffn_in = Dense(hidden_dim, pwffn_dim, dtype=dtype)
        self.ffn_out = Dense(pwffn_dim, hidden_dim, dtype=dtype)
        self.compat_trailing_relu = compat_trailing_relu
        self.dropout_rate = dropout_rate

    def forward(self, x, generator=None):
        h = dropout(torch.relu(self.ffn_in(x)), self.dropout_rate, generator)
        h = self.ffn_out(h)
        if self.compat_trailing_relu:
            h = dropout(torch.relu(h), self.dropout_rate, generator)
        return h


def _check_unported(moe_num_experts=0, pipeline_stages=1):
    if moe_num_experts > 1:
        raise NotImplementedError("MoE FFNs are not ported yet (ROADMAP.md)")
    if pipeline_stages > 1:
        raise NotImplementedError("GPipe is not ported yet (ROADMAP.md)")


class EncoderLayer(nn.Module):
    def __init__(self, hidden_dim, num_heads, pwffn_dim, dtype,
                 use_pallas=False, compat_trailing_relu=False, ring_mesh=None,
                 moe_num_experts=0, attention_dropout=0.1, relu_dropout=0.1,
                 layer_dropout=0.0, ring_impl="xla"):
        super().__init__()
        _check_unported(moe_num_experts)
        self.ln_mha = LayerNorm(hidden_dim, dtype)
        self.mha = MultiHeadAttention(hidden_dim, num_heads, dtype,
                                      use_pallas=use_pallas,
                                      ring_mesh=ring_mesh,
                                      dropout_rate=attention_dropout,
                                      ring_impl=ring_impl)
        self.ln_ffn = LayerNorm(hidden_dim, dtype)
        self.ffn = PositionwiseFeedForward(hidden_dim, pwffn_dim, dtype,
                                           compat_trailing_relu, relu_dropout)
        self.layer_dropout = layer_dropout

    def forward(self, x, mask=None, generator=None):
        xn = self.ln_mha(x)
        x = dropout(x + self.mha(xn, xn, mask, generator),
                    self.layer_dropout, generator)
        return dropout(x + self.ffn(self.ln_ffn(x), generator),
                       self.layer_dropout, generator)


class TransformerEncoder(nn.Module):
    """Stack of pre-LN encoder layers + input timing signal + final LN.
    Layers are registered as ``layer_{i}``, the JAX parameter names."""

    def __init__(self, hidden_dim, num_layers, num_heads, pwffn_dim,
                 dtype=torch.bfloat16, use_pallas=False,
                 compat_trailing_relu=False, ring_mesh=None,
                 moe_num_experts=0, attention_dropout=0.1, relu_dropout=0.1,
                 layer_dropout=0.0, input_dropout=0.0, ring_impl="xla"):
        super().__init__()
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.input_dropout = input_dropout
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                hidden_dim, num_heads, pwffn_dim, dtype, use_pallas,
                compat_trailing_relu, ring_mesh, moe_num_experts,
                attention_dropout, relu_dropout, layer_dropout, ring_impl))
        self.final_ln = LayerNorm(hidden_dim, dtype)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, x, mask=None, generator=None):
        x = dropout(x, self.input_dropout, generator)
        x = x + timing_signal(x.shape[1], self.hidden_dim, dtype=x.dtype,
                              device=x.device)
        for layer in self.layers:
            x = layer(x, mask, generator)
        return self.final_ln(x)


class DecoderLayer(nn.Module):
    def __init__(self, hidden_dim, num_heads, pwffn_dim, dtype,
                 use_pallas=False, compat_trailing_relu=False, ring_mesh=None,
                 moe_num_experts=0, attention_dropout=0.1, relu_dropout=0.1,
                 layer_dropout=0.0, use_pallas_decode=False, ring_impl="xla"):
        super().__init__()
        _check_unported(moe_num_experts)
        self.hidden_dim, self.num_heads, self.dtype = hidden_dim, num_heads, dtype
        self.use_pallas_decode = use_pallas_decode
        self.ln_self = LayerNorm(hidden_dim, dtype)
        # the ring serves self-attention only, never cross-attention
        self.self_attn = MultiHeadAttention(hidden_dim, num_heads, dtype,
                                            causal=True,
                                            use_pallas=use_pallas,
                                            ring_mesh=ring_mesh,
                                            dropout_rate=attention_dropout,
                                            ring_impl=ring_impl)
        self.ln_cross = LayerNorm(hidden_dim, dtype)
        self.cross_attn = MultiHeadAttention(hidden_dim, num_heads, dtype,
                                             use_pallas=use_pallas,
                                             dropout_rate=attention_dropout)
        self.ln_ffn = LayerNorm(hidden_dim, dtype)
        self.ffn = PositionwiseFeedForward(hidden_dim, pwffn_dim, dtype,
                                           compat_trailing_relu, relu_dropout)
        self.layer_dropout = layer_dropout

    def forward(self, x, enc_out, src_mask=None, trg_mask=None,
                generator=None):
        """Teacher-forced layer.  ``trg_mask`` is the target key-padding
        mask [B, 1, 1, T]; causality comes from ``self_attn.causal``."""
        rate = self.layer_dropout
        xn = self.ln_self(x)
        x = dropout(x + self.self_attn(xn, xn, trg_mask, generator), rate,
                    generator)
        x = dropout(x + self.cross_attn(self.ln_cross(x), enc_out, src_mask,
                                        generator), rate, generator)
        return dropout(x + self.ffn(self.ln_ffn(x), generator), rate,
                       generator)

    def cross_kv(self, enc_out):
        return self.cross_attn.kv(enc_out)

    def step(self, x_t, cache_k, cache_v, ck, cv, pos: int, src_mask,
             key_pad=None, weights=None):
        """One decode step. x_t [B,1,D]; caches [B,L,H,Dh], or [H,L,B,Dh]
        on the per-layer path (written in place at ``pos``); (ck, cv) this
        layer's precomputed cross K/V.  ``key_pad`` [B, L] must never mark
        a position > ``pos``.  ``weights`` (per-layer path) is
        :meth:`decode_weights`, looked up here when None."""
        if self.use_pallas_decode:
            return self._step_pallas(x_t, cache_k, cache_v, ck, cv, pos,
                                     src_mask, key_pad, weights)
        xn = self.ln_self(x_t)
        y, cache_k, cache_v = self.self_attn.step(xn, cache_k, cache_v, pos,
                                                  key_pad)
        x_t = x_t + y
        x_t = x_t + self.cross_attn.attend_cached(self.ln_cross(x_t), ck, cv,
                                                  src_mask)
        return x_t + self.ffn(self.ln_ffn(x_t)), cache_k, cache_v

    def _step_pallas(self, x_t, cache_k, cache_v, ck, cv, pos, src_mask,
                     key_pad=None, weights=None):
        """The per-layer step: ``self_attn_step`` then ``cross_ffn_step``
        (ops/kernels/decode_layer.py), the counterpart of the JAX
        ``DecoderLayer._step_pallas``."""
        w = self.decode_weights() if weights is None else weights
        b, tc = x_t.shape[0], ck.shape[1]
        pad = (src_mask[:, 0, 0, :].expand(b, tc) if src_mask is not None
               else torch.zeros((b, tc), dtype=torch.bool, device=x_t.device))
        x, _, _ = decode_layer.self_attn_step(
            x_t[:, 0].contiguous(), *w["ln_self"], w["wqkv"], w["wout"],
            cache_k, cache_v, pos, self.num_heads,
            key_pad=None if key_pad is None else key_pad.float().T)
        out = decode_layer.cross_ffn_step(
            x, *w["ln_cross"], w["wq"], ck, cv, pad, w["wo"], *w["ln_ffn"],
            w["w1"], w["b1"], w["w2"], w["b2"], self.num_heads)
        return out[:, None], cache_k, cache_v

    def decode_weights(self) -> dict:
        """The per-layer step's weights, in the layouts of
        ``decode_layer``: ``wqkv`` [H, D, 3*Dh] (head-h column slices of
        q|k|v), ``wout`` [H, Dh, D], the cross ``wq``/``wo`` and the FFN
        ``w1``/``w2`` in flax's [in, out] layout, all in the compute dtype;
        the LayerNorm pairs and the FFN biases in f32.  Built on first use
        and kept until a parameter changes (:func:`cached`)."""
        return cached(self, "_decode_weights", self._build_decode_weights)

    @torch.no_grad()
    def _build_decode_weights(self) -> dict:
        h, dt = self.num_heads, self.dtype
        dh = self.hidden_dim // h

        def kernel(dense):   # flax kernel layout [in, out]
            return dense.weight.float().T

        def ln(norm):
            return (norm.weight.float().contiguous(),
                    norm.bias.float().contiguous())

        sa, ca = self.self_attn, self.cross_attn
        ws = [kernel(sa.q_proj), kernel(sa.k_proj), kernel(sa.v_proj)]
        wqkv = torch.stack([torch.cat([w[:, i * dh:(i + 1) * dh] for w in ws],
                                      dim=1) for i in range(h)])
        wout = kernel(sa.out_proj).reshape(h, dh, self.hidden_dim)
        return {"ln_self": ln(self.ln_self), "ln_cross": ln(self.ln_cross),
                "ln_ffn": ln(self.ln_ffn),
                "wqkv": wqkv.to(dt).contiguous(),
                "wout": wout.to(dt).contiguous(),
                "wq": kernel(ca.q_proj).to(dt).contiguous(),
                "wo": kernel(ca.out_proj).to(dt).contiguous(),
                "w1": kernel(self.ffn.ffn_in).to(dt).contiguous(),
                "b1": self.ffn.ffn_in.bias.float().contiguous(),
                "w2": kernel(self.ffn.ffn_out).to(dt).contiguous(),
                "b2": self.ffn.ffn_out.bias.float().contiguous()}


class TransformerDecoder(nn.Module):
    """Stack of pre-LN decoder layers (self + cross attention + FFN)."""

    def __init__(self, hidden_dim, num_layers, num_heads, pwffn_dim,
                 dtype=torch.bfloat16, max_decode_len: int = 64,
                 use_pallas=False, compat_trailing_relu=False, ring_mesh=None,
                 use_pallas_decode=False, use_stream_decode=False,
                 stream_weight_dtype="bfloat16", pipeline_stages=1,
                 moe_num_experts=0, attention_dropout=0.1, relu_dropout=0.1,
                 layer_dropout=0.0, input_dropout=0.0, ring_impl="xla"):
        super().__init__()
        _check_unported(moe_num_experts, pipeline_stages)
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.num_heads, self.pwffn_dim, self.dtype = num_heads, pwffn_dim, dtype
        self.use_stream_decode = use_stream_decode
        # the streaming path takes precedence, as in the JAX package
        self.use_pallas_decode = use_pallas_decode and not use_stream_decode
        self.stream_weight_dtype = stream_weight_dtype
        self.input_dropout = input_dropout
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                hidden_dim, num_heads, pwffn_dim, dtype, use_pallas,
                compat_trailing_relu, ring_mesh, moe_num_experts,
                attention_dropout, relu_dropout, layer_dropout,
                self.use_pallas_decode, ring_impl))
        self.final_ln = LayerNorm(hidden_dim, dtype)
        self.register_buffer(
            "timing", timing_signal(max_decode_len, hidden_dim)[0],
            persistent=False)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, x, enc_out, src_mask=None, trg_mask=None,
                generator=None):
        """Teacher-forced decoder over the whole target: x [B, T, D]."""
        x = dropout(x, self.input_dropout, generator)
        x = x + timing_signal(x.shape[1], self.hidden_dim, dtype=x.dtype,
                              device=x.device)
        for layer in self.layers:
            x = layer(x, enc_out, src_mask, trg_mask, generator)
        return self.final_ln(x)

    # ---- decode path ----
    def precompute_cross(self, enc_out) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [layer.cross_kv(enc_out) for layer in self.layers]

    @property
    def cache_batch_axis(self) -> int:
        """Axis of the batch dim in the KV caches (beam search reorders
        along it)."""
        if self.use_stream_decode:
            return 3
        return 2 if self.use_pallas_decode else 0

    def layer_weights(self) -> list:
        """Each layer's :meth:`DecoderLayer.decode_weights` (per-layer
        path); decode loops fetch them once and pass them to :meth:`step`."""
        return [layer.decode_weights() for layer in self.layers]

    def init_cache(self, batch: int, max_len: int, device=None):
        """Zeroed KV caches: a list of per-layer (k, v) [B,L,H,Dh] ([H,L,B,Dh]
        on the per-layer path), or on the streaming path one stacked pair
        [Layers,H,L,B,Dh] in a list."""
        dh = self.hidden_dim // self.num_heads
        if self.use_stream_decode:
            shape = (self.num_layers, self.num_heads, max_len, batch, dh)
            return [(torch.zeros(shape, dtype=self.dtype, device=device),
                     torch.zeros(shape, dtype=self.dtype, device=device))]
        if self.use_pallas_decode:
            shape = (self.num_heads, max_len, batch, dh)
        else:
            shape = (batch, max_len, self.num_heads, dh)
        return [(torch.zeros(shape, dtype=self.dtype, device=device),
                 torch.zeros(shape, dtype=self.dtype, device=device))
                for _ in range(self.num_layers)]

    def step(self, x_t, caches, cross_kvs, pos: int, src_mask=None,
             key_pad=None, skip_final_ln: bool = False, stream=None,
             layers=None):
        """One decode step: x_t [B,1,D] at position ``pos``.  ``key_pad``
        [B, L] bool (optional) masks pad-token keys and must never mark a
        position > ``pos``.  ``skip_final_ln`` returns the raw stack output
        (the fused head applies the final LN itself).  ``stream`` is the
        bundle from :meth:`stream_prep` (built here when None); ``layers``
        is :meth:`layer_weights` on the per-layer path (looked up per layer
        when None).  Returns (output [B,1,D], caches), the caches updated in
        place."""
        x_t = x_t + self.timing[pos].to(x_t.dtype)
        if self.use_stream_decode:
            if stream is None:
                stream = self.stream_prep(cross_kvs, src_mask, x_t.shape[0])
            return self._step_stream(x_t, caches, stream, pos,
                                     skip_final_ln, key_pad=key_pad)
        if layers is None:
            layers = [None] * self.num_layers
        for layer, (cache_k, cache_v), (ck, cv), w in zip(
                self.layers, caches, cross_kvs, layers):
            x_t, _, _ = layer.step(x_t, cache_k, cache_v, ck, cv, pos,
                                   src_mask, key_pad, w)
        if skip_final_ln:
            return x_t, caches
        return self.final_ln(x_t), caches

    @torch.no_grad()
    def stream_prep(self, cross_kvs, src_mask, batch: int) -> dict:
        """Loop-invariant tensors of the streaming step, in the layouts of
        ``decode_stack_step``: the model's weight bundle
        (:meth:`stream_weights`) with this request batch's regrouped cross
        K/V and source mask."""
        h, dt = self.num_heads, self.dtype
        dh = self.hidden_dim // h
        hc, _ = decode_stream.pick_stages(h, self.pwffn_dim)
        hpc = h // hc

        def ckv(xs):      # list of [B,Tc,H,Dh] -> [L,Hc,Tc,B,hpc*Dh]
            stacked = torch.stack(xs)                    # [L, B, Tc, H, Dh]
            nl, b, tc = stacked.shape[:3]
            out = stacked.transpose(1, 2).reshape(nl, tc, b, hc, hpc * dh)
            return out.permute(0, 3, 1, 2, 4).to(dt).contiguous()

        tc = cross_kvs[0][0].shape[1]
        dev = cross_kvs[0][0].device
        smask = (src_mask[:, 0, 0, :].expand(batch, tc).T
                 if src_mask is not None
                 else torch.zeros((tc, batch), dtype=torch.bool, device=dev))
        return {
            **self.stream_weights(),
            "ckc": ckv([ck for ck, _ in cross_kvs]),
            "cvc": ckv([cv for _, cv in cross_kvs]),
            "smask": smask.to(torch.int32).contiguous(),
        }

    def stream_weights(self) -> dict:
        """The model-constant part of the streaming bundle: per-layer weight
        stacks (int8-quantized under ``stream_weight_dtype="int8"``) and the
        LayerNorm and bias stacks.  Built on first use and kept until a
        parameter changes (:func:`~blt_vqg_tpu_torch.ops.layers.cached`)."""
        return cached(self, "_stream_weights", self._build_stream_weights)

    @torch.no_grad()
    def _build_stream_weights(self) -> dict:
        h, d, dt = self.num_heads, self.hidden_dim, self.dtype
        dh = d // h
        hc, fc = decode_stream.pick_stages(h, self.pwffn_dim)
        hpc = h // hc
        fchunk = self.pwffn_dim // fc

        def per_layer(fn):
            return torch.stack([fn(layer) for layer in self.layers]).contiguous()

        def kernel(dense):   # flax kernel layout [in, out]
            return dense.weight.float().T

        def lns(layer):
            return torch.stack([
                layer.ln_self.weight, layer.ln_self.bias,
                layer.ln_cross.weight, layer.ln_cross.bias,
                layer.ln_ffn.weight, layer.ln_ffn.bias]).float()

        def wqkv(layer):  # [H, D, 3*Dh]: head-h column slices of q|k|v
            sa = layer.self_attn
            ws = [kernel(sa.q_proj), kernel(sa.k_proj), kernel(sa.v_proj)]
            return torch.stack([
                torch.cat([w[:, i * dh:(i + 1) * dh] for w in ws], dim=1)
                for i in range(h)]).to(dt)

        def wout(layer):  # [H, Dh, D]: head-h row slices
            w = kernel(layer.self_attn.out_proj)
            return torch.stack([w[i * dh:(i + 1) * dh] for i in range(h)]).to(dt)

        def wqc(layer):   # [Hc, D, hpc*Dh]: head-group column slices
            w = kernel(layer.cross_attn.q_proj)
            return torch.stack([w[:, j * hpc * dh:(j + 1) * hpc * dh]
                                for j in range(hc)]).to(dt)

        def woc(layer):   # [Hc, hpc*Dh, D]: head-group row slices
            w = kernel(layer.cross_attn.out_proj)
            return torch.stack([w[j * hpc * dh:(j + 1) * hpc * dh]
                                for j in range(hc)]).to(dt)

        def w1(layer):    # [Fc, D, F/Fc]
            w = kernel(layer.ffn.ffn_in)
            return torch.stack([w[:, c * fchunk:(c + 1) * fchunk]
                                for c in range(fc)]).to(dt)

        def b1(layer):    # [Fc, 1, F/Fc] f32
            bv = layer.ffn.ffn_in.bias.float()
            return torch.stack([bv[None, c * fchunk:(c + 1) * fchunk]
                                for c in range(fc)])

        def w2(layer):    # [Fc, F/Fc, D]
            w = kernel(layer.ffn.ffn_out)
            return torch.stack([w[c * fchunk:(c + 1) * fchunk]
                                for c in range(fc)]).to(dt)

        def b2(layer):    # [1, D] f32
            return layer.ffn.ffn_out.bias.float()[None]

        stacks = [per_layer(wqkv), per_layer(wout), per_layer(wqc),
                  per_layer(woc), per_layer(w1), per_layer(w2)]
        scales = None
        if self.stream_weight_dtype == "int8":
            stacks, scales = map(list, zip(*[decode_stream.quantize_stack(w)
                                             for w in stacks]))
            scales = tuple(s.contiguous() for s in scales)
        return {"lns": per_layer(lns), "stacks": tuple(stacks),
                "scales": scales, "b1": per_layer(b1), "b2": per_layer(b2)}

    def _step_stream(self, x_t, caches, prep, pos: int,
                     skip_final_ln: bool = False, key_pad=None):
        """Whole-stack step through ``decode_stack_step``; the kernel reads
        the caches and returns the current position's K/V, which are then
        written into the caches at ``pos`` in place."""
        k_all, v_all = caches[0]
        hc, fc = decode_stream.pick_stages(self.num_heads, self.pwffn_dim)
        s_wqkv, s_wout, s_wqc, s_woc, s_w1, s_w2 = prep["stacks"]
        kp = kp_cur = None
        if key_pad is not None:
            kp = key_pad.float().T.contiguous()              # [Lmax, B]
            kp_cur = kp[pos:pos + 1].contiguous()
        x_out, k_new, v_new = decode_stream.decode_stack_step(
            x_t[:, 0].contiguous(), pos, prep["lns"], s_wqkv, s_wout, k_all,
            v_all, s_wqc, s_woc, prep["ckc"], prep["cvc"], prep["smask"],
            s_w1, prep["b1"], s_w2, prep["b2"], num_heads=self.num_heads,
            cross_stages=hc, ffn_stages=fc, weight_scales=prep["scales"],
            key_pad=kp, key_pad_cur=kp_cur)
        k_all[:, :, pos] = k_new
        v_all[:, :, pos] = v_new
        if skip_final_ln:
            return x_out[:, None], caches
        return self.final_ln(x_out[:, None]), caches
