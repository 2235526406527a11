"""The neural building blocks of the baselines, as `torch.nn.Module`s, in
the meaning of `insite_tpu.models.nn.blocks`:

- `GradReverse` / `grad_reverse`: identity forward, -scale * g backward;
- `bce`: the per-(row, step) treatment loss;
- `BRTreatmentOutcomeHead`: balanced representation, adversarial treatment
  classifier and treatment-conditioned outcome head;
- `ROutcomeVitalsHead`: G-Net's sequentially conditioned output heads;
- `VariationalLSTM`: a stacked LSTM whose dropout masks are drawn once per
  batch and multiply the carried state; under `torch.func.vmap` over
  stacked parameters its step is `lstm_step`;
- `fixed_sin_cos`, `RelativePositionalEncoding`, `MultiHeadedAttention` with
  relative positions on keys and values, `PositionwiseFeedForward`,
  `TransformerMultiInputBlock` (CT's two- or three-stream block) and
  EDCT's `TransformerEncoderBlock` and `TransformerDecoderBlock`;
- `first_attention_maps`: each attention module's map of one forward
  pass, kept only while it runs.

Every `nn.Linear` keeps PyTorch's default init, U(+-1/sqrt(fan_in)) for
weight and bias, which is the JAX package's `TorchDense`. Every module takes
its ``device`` and ``dtype``. Dropout is on exactly when a forward pass is
given a ``torch.Generator`` (``gen``), which draws every mask.

The attention is explicit `einsum`s, not `scaled_dot_product_attention`:
the relative positions enter both the scores and the output, and masked
scores are set to -1e9 (a row masked everywhere softmaxes to uniform, not
NaN).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6
MASKED_SCORE = -1e9


def dropout(x, rate: float, gen):
    """Inverted dropout drawn from ``gen``; the identity without one."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty_like(x).bernoulli_(keep, generator=gen)
    return x * mask / keep


class GradReverse(torch.autograd.Function):
    """Identity forward; the backward pass multiplies the gradient by
    ``-scale``. `torch.func.vmap` generates its batching rule."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, scale):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, g):
        (scale,) = ctx.saved_tensors
        return -scale * g, None


def grad_reverse(x, scale=1.0):
    return GradReverse.apply(x, torch.as_tensor(scale, dtype=x.dtype,
                                                device=x.device))


def bce(treatment_pred, current_treatments, mode: str):
    """Per-(row, step) treatment loss of logits ``[B, T, A]``: softmax
    cross-entropy ('multiclass') or the mean sigmoid BCE over the columns
    ('multilabel')."""
    if mode == 'multiclass':
        logp = F.log_softmax(treatment_pred, dim=-1)
        return -(current_treatments * logp).sum(-1)
    if mode == 'multilabel':
        logp = F.logsigmoid(treatment_pred)
        lognotp = F.logsigmoid(-treatment_pred)
        return -(current_treatments * logp +
                 (1 - current_treatments) * lognotp).mean(-1)
    raise NotImplementedError(mode)


class BRTreatmentOutcomeHead(nn.Module):
    """Balanced representation ``br = elu(linear1(seq))``; treatment logits
    ``linear3(elu(linear2(br)))`` (the adversary, `treatment_head_params`);
    outcome ``linear5(elu(linear4([br, current_treatment])))``."""

    treatment_head_params = ('linear2', 'linear3')

    def __init__(self, seq_hidden_units, br_size, fc_hidden_units,
                 dim_treatments, dim_outcome, balancing='grad_reverse', *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.balancing = balancing
        self.linear1 = nn.Linear(seq_hidden_units, br_size, **kw)
        self.linear2 = nn.Linear(br_size, fc_hidden_units, **kw)
        self.linear3 = nn.Linear(fc_hidden_units, dim_treatments, **kw)
        self.linear4 = nn.Linear(br_size + dim_treatments, fc_hidden_units,
                                 **kw)
        self.linear5 = nn.Linear(fc_hidden_units, dim_outcome, **kw)

    def build_br(self, seq_output):
        return F.elu(self.linear1(seq_output))

    def build_treatment(self, br, alpha, detached=False):
        if detached:
            br = br.detach()
        if self.balancing == 'grad_reverse':
            br = grad_reverse(br, alpha)
        return self.linear3(F.elu(self.linear2(br)))

    def build_outcome(self, br, current_treatment):
        x = torch.cat([br, current_treatment], dim=-1)
        return self.linear5(F.elu(self.linear4(x)))

    def forward(self, seq_output, current_treatment, alpha=0.0,
                detach_treatment=False):
        br = self.build_br(seq_output)
        treatment_pred = self.build_treatment(br, alpha, detach_treatment)
        outcome_pred = self.build_outcome(br, current_treatment)
        return treatment_pred, outcome_pred, br


class ROutcomeVitalsHead(nn.Module):
    """G-Net's heads: ``r = elu(r_layer(seq))``, then per component c of
    ``comp_sizes`` the output ``out[c](elu(fc[c](r)))``, which is put in
    front of ``r`` for the next component; returns the outputs
    concatenated in order."""

    def __init__(self, seq_hidden_units, r_size, fc_hidden_units,
                 comp_sizes, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.r_layer = nn.Linear(seq_hidden_units, r_size, **kw)
        self.fc = nn.ModuleList()
        self.out = nn.ModuleList()
        width = r_size
        for size in comp_sizes:
            self.fc.append(nn.Linear(width, fc_hidden_units, **kw))
            self.out.append(nn.Linear(fc_hidden_units, size, **kw))
            width += size

    def forward(self, seq_output):
        r = F.elu(self.r_layer(seq_output))
        outs = []
        for fc, out in zip(self.fc, self.out):
            outs.append(out(F.elu(fc(r))))
            r = torch.cat([outs[-1], r], dim=-1)
        return torch.cat(outs, dim=-1)


def lstm_input_gates(x, w_ih, b_ih, b_hh):
    """The input's share of the LSTM gates, ``x W_ih^T + b_ih + b_hh``, for
    every step of ``x [..., T, in]`` at once."""
    return x @ w_ih.T + (b_ih + b_hh)


def lstm_step(x_gates, hx, cx, w_hh):
    """One step of `torch.lstm_cell`'s math in plain ops, which
    `torch.func.vmap` can batch: gates ``x_gates + h W_hh^T`` (from
    `lstm_input_gates`) in the order i, f, g, o; ``c' = sigmoid(f) c +
    sigmoid(i) tanh(g)``, ``h' = sigmoid(o) tanh(c')``. Returns (h', c')."""
    gates = torch.addmm(x_gates, hx, w_hh.T)
    H = hx.shape[-1]
    s = torch.sigmoid(gates)
    c = torch.addcmul(s[:, H:2 * H] * cx, s[:, :H],
                      torch.tanh(gates[:, 2 * H:3 * H]))
    return s[:, 3 * H:] * torch.tanh(c), c


class VariationalLSTM(nn.Module):
    """Stacked LSTM, gate order i, f, g, o, with the parameters of
    `nn.LSTM` (``weight_ih_l{k}`` ``[4H, in]``, ``weight_hh_l{k}``
    ``[4H, H]`` and both biases, all U(+-1/sqrt(H))). With ``gen``, three
    masks (output, h, c) of shape ``[B, H]`` are drawn per layer, once per
    call, each scaled by 1/keep: the output of every step is multiplied by
    the first, and the carried h and c by the other two. ``init_states``
    seeds both h and c of every layer.

    cuDNN's fused LSTM cannot mask the carried state, so this loops over
    time with `torch.lstm_cell` (on the card: two matmuls and one fused
    gate kernel a step), masking between the steps. `torch.lstm_cell` has
    no batching rule: under `torch.func.vmap` (parameters stacked over
    seeds) the input gates of every step come from one matmul and the step
    is `lstm_step`. The masks and the zero state are made from the input,
    so that under `vmap` they carry its batch (seed) axis."""

    def __init__(self, input_size, hidden_size, num_layer=1,
                 dropout_rate=0.0, *, device=None, dtype=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layer = num_layer
        self.dropout_rate = dropout_rate
        bound = 1.0 / math.sqrt(hidden_size)
        kw = dict(device=device, dtype=dtype)
        for layer in range(num_layer):
            in_dim = input_size if layer == 0 else hidden_size
            for name, shape in (('weight_ih', (4 * hidden_size, in_dim)),
                                ('weight_hh', (4 * hidden_size,
                                               hidden_size)),
                                ('bias_ih', (4 * hidden_size,)),
                                ('bias_hh', (4 * hidden_size,))):
                p = nn.Parameter(torch.empty(shape, **kw))
                nn.init.uniform_(p, -bound, bound)
                self.register_parameter(f'{name}_l{layer}', p)

    def forward(self, x, init_states=None, gen=None):
        T = x.shape[1]
        H = self.hidden_size
        h = x
        for layer in range(self.num_layer):
            weights = [getattr(self, f'{name}_l{layer}') for name in
                       ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')]
            # [B, H] with x's batch dimensions
            state = torch.zeros_like(h[:, 0, :1]).repeat(1, H)
            if init_states is None:
                hx = cx = state
            else:
                hx = cx = init_states.to(h.dtype)
            if gen is not None and self.dropout_rate > 0.0:
                keep = 1.0 - self.dropout_rate
                out_m, h_m, c_m = (
                    torch.empty_like(state).bernoulli_(keep, generator=gen)
                    / keep for _ in range(3))
            else:
                out_m = h_m = c_m = None
            stacked = torch._C._functorch.is_batchedtensor(weights[1])
            if stacked:
                x_gates = lstm_input_gates(h, weights[0], *weights[2:])
            outputs = []
            for t in range(T):
                if stacked:
                    hx, cx = lstm_step(x_gates[:, t], hx, cx, weights[1])
                else:
                    hx, cx = torch.lstm_cell(h[:, t], (hx, cx), *weights)
                if out_m is None:
                    outputs.append(hx)
                else:
                    outputs.append(hx * out_m)
                    hx, cx = hx * h_m, cx * c_m
            h = torch.stack(outputs, dim=1)
        return h


def fixed_sin_cos(d_model: int, max_len: int, *, device=None, dtype=None):
    """The sinusoidal table ``[max_len, d_model]``."""
    position = torch.arange(max_len, device=device, dtype=dtype)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, device=device, dtype=dtype)
                    * (-math.log(1e4) / d_model))
    pe = torch.zeros(max_len, d_model, device=device, dtype=dtype)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


class RelativePositionalEncoding(nn.Module):
    """A relative-position table shared across heads: ``forward(Tq, Tk)``
    gives ``[Tq, Tk, d_model]``. Self-attention distances ``k - q`` clipped
    to +-max_relative_position (2 * max + 1 rows); with ``cross_attn``,
    ``(Tk - 1 - k) + q`` clipped likewise (max + 1 rows). The table is
    trainable (N(0, 1) init) or the fixed sinusoid."""

    def __init__(self, max_relative_position: int, d_model: int,
                 trainable=True, cross_attn=False, *, device=None,
                 dtype=None):
        super().__init__()
        self.max_relative_position = max_relative_position
        self.cross_attn = cross_attn
        if trainable:
            num = (max_relative_position * 2 + 1 if not cross_attn
                   else max_relative_position + 1)
            self.embeddings_table = nn.Parameter(
                torch.randn(num, d_model, device=device, dtype=dtype))
        else:
            self.register_buffer('embeddings_table', fixed_sin_cos(
                d_model, max_relative_position * 2 + 1, device=device,
                dtype=dtype))

    def forward(self, length_q: int, length_k: int):
        m = self.max_relative_position
        dev = self.embeddings_table.device
        q = torch.arange(length_q, device=dev)[:, None]
        if self.cross_attn:
            dist = torch.arange(length_k - 1, -1, -1, device=dev)[None] + q
            dist = dist.clamp(-m, m)
        else:
            dist = torch.arange(length_k, device=dev)[None] - q
            dist = dist.clamp(-m, m) + m
        return self.embeddings_table[dist]


class MultiHeadedAttention(nn.Module):
    """Multi-head attention with relative positions ``rel_k`` / ``rel_v``
    (``[Tq, Tk, head_size]``, or None for none) on keys and values, masked
    scores (and, when ``causal``, those of later keys) set to -1e9, with
    ``final_layer`` a ``d_model`` linear layer on the heads' output, then
    LayerNorm(out + query). Every attention of CT is causal; EDCT's
    cross-attention is not."""

    def __init__(self, num_heads: int, d_model: int, head_size=None,
                 dropout_rate=0.0, final_layer=False, causal=True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.head_size = head_size or d_model // num_heads
        self.dropout_rate = dropout_rate
        self.causal = causal
        width = num_heads * self.head_size
        self.q_proj = nn.Linear(d_model, width, **kw)
        self.k_proj = nn.Linear(d_model, width, **kw)
        self.v_proj = nn.Linear(d_model, width, **kw)
        self.final = nn.Linear(width, d_model, **kw) if final_layer else None
        self.layer_norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, **kw)
        # a list only while `first_attention_maps` runs: the first call's
        # attention probabilities, before dropout
        self.recorded = None

    def forward(self, query, key, value, mask=None, gen=None, rel_k=None,
                rel_v=None):
        hs = self.head_size
        B, Tq, _ = query.shape
        Tk = key.shape[1]

        def heads(x, proj):
            return proj(x).view(B, -1, self.num_heads, hs).transpose(1, 2)

        q = heads(query, self.q_proj)
        k = heads(key, self.k_proj)
        v = heads(value, self.v_proj)
        scores = torch.einsum('bhqd,bhkd->bhqk', q, k)
        if rel_k is not None:
            scores = scores + torch.einsum('bhqd,qkd->bhqk', q, rel_k)
        scores = scores / math.sqrt(hs)
        # one pass for both masks: the keys' and the causal one
        keep = None if mask is None else mask != 0
        if self.causal:
            tril = torch.ones(Tq, Tk, dtype=torch.bool,
                              device=scores.device).tril()
            keep = tril if keep is None else tril & keep
        if keep is not None:
            scores = scores.masked_fill(~keep, MASKED_SCORE)
        p_attn = torch.softmax(scores, dim=-1)
        if self.recorded is not None and not self.recorded:
            self.recorded.append(p_attn)
        p_attn = dropout(p_attn, self.dropout_rate, gen)
        out = torch.einsum('bhqk,bhkd->bhqd', p_attn, v)
        if rel_v is not None:
            out = out + torch.einsum('bhqv,qvd->bhqd', p_attn, rel_v)
        out = out.transpose(1, 2).reshape(B, Tq, self.num_heads * hs)
        if self.final is not None:
            out = self.final(out)
        return self.layer_norm(out + query)


class PositionwiseFeedForward(nn.Module):
    """LayerNorm(x + dropout(linear2(dropout(relu(linear1(x))))))."""

    def __init__(self, d_model: int, d_ff: int, dropout_rate=0.1, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dropout_rate = dropout_rate
        self.linear1 = nn.Linear(d_model, d_ff, **kw)
        self.linear2 = nn.Linear(d_ff, d_model, **kw)
        self.layer_norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, **kw)

    def forward(self, x, gen=None):
        h = dropout(F.relu(self.linear1(x)), self.dropout_rate, gen)
        h = dropout(self.linear2(h), self.dropout_rate, gen)
        return self.layer_norm(h + x)


class TransformerMultiInputBlock(nn.Module):
    """CT's block over the treatment and outcome streams: causal self
    attention on each, causal cross attention of each onto the other's
    input, the static stream added, then a feed-forward layer per stream.
    Every attention of the block is masked by the active entries of the
    keys.

    With ``has_vitals`` the block also takes a vitals stream ``x_v``, with
    the JAX package's weight sharing: the vitals self-attention is
    ``self_attention_o``, t<-v and o<-v are ``cross_attention_to``, v<-t
    and v<-o are ``cross_attention_ot``; ``ff_v`` is its only parameter of
    its own. A cross attention between the vitals and another stream is
    masked by the query's activity times the key's, ``[B, 1, T, T]``."""

    def __init__(self, hidden: int, attn_heads: int, head_size: int,
                 feed_forward_hidden: int, dropout_rate: float,
                 attn_dropout: float, has_vitals=False, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)

        def mha():
            return MultiHeadedAttention(attn_heads, hidden, head_size,
                                        attn_dropout, **kw)

        def ff():
            return PositionwiseFeedForward(hidden, feed_forward_hidden,
                                           dropout_rate, **kw)

        self.self_attention_t = mha()
        self.self_attention_o = mha()
        self.cross_attention_to = mha()
        self.cross_attention_ot = mha()
        self.ff_t = ff()
        self.ff_o = ff()
        self.ff_v = ff() if has_vitals else None

    def forward(self, x_t, x_o, x_s, active_entries, gen=None, rel_k=None,
                rel_v=None, x_v=None, active_vitals=None):
        """(t, o) streams, or (t, o, v) given ``x_v``; ``active_vitals``
        (the active entries unless given) masks the vitals keys."""
        mask = active_entries[:, None, None, :, 0]          # [B, 1, 1, T]
        kw = dict(gen=gen, rel_k=rel_k, rel_v=rel_v)
        x_t_ = self.self_attention_t(x_t, x_t, x_t, mask, **kw)
        x_o_ = self.self_attention_o(x_o, x_o, x_o, mask, **kw)
        x_to = self.cross_attention_to(x_t_, x_o, x_o, mask, **kw)
        x_ot = self.cross_attention_ot(x_o_, x_t, x_t, mask, **kw)
        if x_v is None:
            return (self.ff_t(x_to + x_s, gen), self.ff_o(x_ot + x_s, gen))
        ao = active_entries[..., 0]                         # [B, T]
        av = (active_entries if active_vitals is None
              else active_vitals)[..., 0]
        mask_v = av[:, None, None, :]
        mask_to_v = (ao[:, :, None] * av[:, None, :])[:, None]
        mask_v_to = (av[:, :, None] * ao[:, None, :])[:, None]
        x_v_ = self.self_attention_o(x_v, x_v, x_v, mask_v, **kw)
        x_tv = self.cross_attention_to(x_t_, x_v, x_v, mask_to_v, **kw)
        x_ov = self.cross_attention_to(x_o_, x_v, x_v, mask_to_v, **kw)
        x_vt = self.cross_attention_ot(x_v_, x_t, x_t, mask_v_to, **kw)
        x_vo = self.cross_attention_ot(x_v_, x_o, x_o, mask_v_to, **kw)
        return (self.ff_t(x_to + x_tv + x_s, gen),
                self.ff_o(x_ot + x_ov + x_s, gen),
                self.ff_v(x_vt + x_vo + x_s, gen))


class TransformerEncoderBlock(nn.Module):
    """EDCT's encoder block: causal self-attention with a final layer,
    masked by the active entries of the keys, then the feed-forward
    layer."""

    def __init__(self, hidden: int, attn_heads: int, head_size: int,
                 feed_forward_hidden: int, dropout_rate: float,
                 attn_dropout: float, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attention = MultiHeadedAttention(
            attn_heads, hidden, head_size, attn_dropout, final_layer=True,
            **kw)
        self.feed_forward = PositionwiseFeedForward(
            hidden, feed_forward_hidden, dropout_rate, **kw)

    def forward(self, x, active_entries, gen=None, rel_k=None, rel_v=None):
        mask = active_entries[:, None, None, :, 0]          # [B, 1, 1, T]
        x = self.self_attention(x, x, x, mask, gen, rel_k, rel_v)
        return self.feed_forward(x, gen)


class TransformerDecoderBlock(nn.Module):
    """EDCT's decoder block: causal self-attention masked by the active
    entries of the keys; then attention, not causal, over the encoder's
    representations ``encoder_x``, masked by the encoder's active steps
    and, per query, by the query's own active entry; then the
    feed-forward layer."""

    def __init__(self, hidden: int, attn_heads: int, head_size: int,
                 feed_forward_hidden: int, dropout_rate: float,
                 attn_dropout: float, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attention = MultiHeadedAttention(
            attn_heads, hidden, head_size, attn_dropout, **kw)
        self.cross_attention = MultiHeadedAttention(
            attn_heads, hidden, head_size, attn_dropout, causal=False, **kw)
        self.feed_forward = PositionwiseFeedForward(
            hidden, feed_forward_hidden, dropout_rate, **kw)

    def forward(self, x, encoder_x, active_entries, active_encoder_br,
                gen=None, rel_k=None, rel_v=None, cross_rel_k=None,
                cross_rel_v=None):
        self_mask = active_entries[:, None, None, :, 0]     # [B, 1, 1, Tq]
        cross_mask = (active_encoder_br[:, None, :] *
                      active_entries[:, :, :1])[:, None]    # [B, 1, Tq, Tk]
        x = self.self_attention(x, x, x, self_mask, gen, rel_k, rel_v)
        x = self.cross_attention(x, encoder_x, encoder_x, cross_mask, gen,
                                 cross_rel_k, cross_rel_v)
        return self.feed_forward(x, gen)


def first_attention_maps(net: nn.Module, run) -> dict:
    """Call ``run()`` with every `MultiHeadedAttention` of ``net`` keeping
    the attention probabilities of its first call in that run (before
    dropout, ``[B, heads, Tq, Tk]``); return them by module path, '/'
    between the names, as the JAX package's 'intermediates' name them. A
    module called more than once (CT's vitals stream reuses three) keeps
    its first call's. Nothing is kept outside this call."""
    modules = {name.replace('.', '/'): m for name, m in net.named_modules()
               if isinstance(m, MultiHeadedAttention)}
    for m in modules.values():
        m.recorded = []
    try:
        run()
        return {name: m.recorded[0] for name, m in modules.items()
                if m.recorded}
    finally:
        for m in modules.values():
            m.recorded = None
