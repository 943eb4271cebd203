"""Message-passing LSTM over padded edge-message tables (counterpart of
``ggpm_tpu/models/rnn.py:MPNLSTMCell``: the dense forward, the decoder's
one-step ``cell`` and the teacher-forced split-step API; the GRU cell
arrives with the hier family).

State layout: ``h`` and ``c`` are ``[num_messages, hidden]`` buffers whose
row 0 is the all-zero padding message.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gather_nd_t, gather_rows, zero_row0, zero_row0_


class MPNLSTMCell(nn.Module):
    """Edge-message LSTM with per-neighbour forget gates (reference
    rnn.py:61-121).  Each gate is one ``Linear`` over ``[x | h]``
    (``input_size + hidden_size`` inputs), as the flax ``Dense`` it is
    bridged from."""

    def __init__(self, input_size: int, hidden_size: int, depth: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.depth = depth
        n_in = input_size + hidden_size
        self.W_i = nn.Linear(n_in, hidden_size)
        self.W_o = nn.Linear(n_in, hidden_size)
        self.W_f = nn.Linear(n_in, hidden_size)
        self.W = nn.Linear(n_in, hidden_size)

    def init_state(self, num_mess: int, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero ``(h, c)`` buffers of ``num_mess`` rows."""
        h = torch.zeros((num_mess, self.hidden_size), device=device)
        return h, torch.zeros_like(h)

    @staticmethod
    def hidden(state) -> torch.Tensor:
        return state[0]

    def cell(self, x: torch.Tensor, state_nei) -> Tuple[torch.Tensor, ...]:
        """One application to rows with inputs ``x`` [R, in] and gathered
        neighbour states ``(h_nei, c_nei)``, each [R, A, H] (reference
        rnn.py:86-121).  The per-neighbour forget gate by linearity:
        W_f([x, h_k]) = W_f([x, 0]) + h_k @ Kf."""
        h_nei, c_nei = state_nei
        in_dim = x.shape[-1]
        h_sum = h_nei.sum(dim=-2)
        xh = torch.cat([x, h_sum], dim=-1)
        i = torch.sigmoid(self.W_i(xh))
        o = torch.sigmoid(self.W_o(xh))
        u = torch.tanh(self.W(xh))
        xf = F.linear(x, self.W_f.weight[:, :in_dim], self.W_f.bias)
        f = torch.sigmoid(xf[..., None, :] + h_nei @ self.W_f.weight[:, in_dim:].t())
        c = i * u + (f * c_nei).sum(dim=-2)
        return o * torch.tanh(c), c

    # -- split-step API for the teacher-forced decoder scan (reference
    # rnn.py:228-266): the same math as ``cell`` --------------------------
    def x_proj(self, x: torch.Tensor) -> torch.Tensor:
        """Loop-invariant gate terms xi | xo | xu | xf ([..., 4H]), biases
        included."""
        in_dim = x.shape[-1]
        return torch.cat([F.linear(x, m.weight[:, :in_dim], m.bias)
                          for m in (self.W_i, self.W_o, self.W, self.W_f)],
                         dim=-1)

    def k_h(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """h-side kernels: (K_iou stacked [H, 3H], kf [H, H])."""
        H = self.hidden_size
        kiou = torch.cat([m.weight[:, -H:] for m in (self.W_i, self.W_o,
                                                      self.W)]).t()
        return kiou, self.W_f.weight[:, -H:].t()

    @staticmethod
    def step(xp: torch.Tensor, state_nei, ks) -> Tuple[torch.Tensor, ...]:
        """One cell application from hoisted x terms: ``xp`` [R, 4H] from
        ``x_proj``, ``state_nei = (h_nei, c_nei)`` each [R, A, H], ``ks``
        from ``k_h``."""
        kiou, kf = ks
        h_nei, c_nei = state_nei
        xi, xo, xu, xf = xp.chunk(4, dim=-1)
        gi, go, gu = (h_nei.sum(dim=-2) @ kiou).chunk(3, dim=-1)
        i = torch.sigmoid(xi + gi)
        o = torch.sigmoid(xo + go)
        u = torch.tanh(xu + gu)
        f = torch.sigmoid(xf[..., None, :] + h_nei @ kf)
        c = i * u + (f * c_nei).sum(dim=-2)
        return o * torch.tanh(c), c

    def forward(self, fmess: torch.Tensor, bgraph: torch.Tensor,
                bt=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``depth`` rounds over every message; returns ``(h, c)``.

        The x-side projections of every gate are loop-invariant and are
        computed once (biases live there); each round projects ``h`` by the
        forget gate's h-side kernel and gathers ``[h | h·Kf | c]`` by
        ``bgraph`` in one gather, so the per-neighbour forget gate costs an
        [E, H]×[H, H] product instead of an [E, A, in+H]×[in+H, H] one.

        The gather is the row-gather kernel, ``gather_rows``.  With
        ``bt``, the host-built transpose ``(t_idx, t_mask)`` of ``bgraph``
        (``bgraph_t``/``bgraph_tm`` of the batch), it is ``gather_nd_t``:
        that kernel forward and a gather over the transpose backward
        (reference rnn.py:23-44); without it the loop has no backward on
        the card.  Row 0 is zeroed out of place while autograd records, in
        place otherwise."""
        in_dim = fmess.shape[-1]
        H = self.hidden_size
        xi, xo, xu, xf = (F.linear(fmess, m.weight[:, :in_dim], m.bias)
                          for m in (self.W_i, self.W_o, self.W, self.W_f))
        xf = xf[:, None, :]
        k_iou = torch.cat([m.weight[:, in_dim:]
                           for m in (self.W_i, self.W_o, self.W)]).t()
        k_f = self.W_f.weight[:, in_dim:].t()

        if bt is None:
            gather = lambda v: gather_rows(v, bgraph)
        else:
            gather = lambda v: gather_nd_t(v, bgraph, *bt)
        zero = zero_row0 if torch.is_grad_enabled() else zero_row0_

        h = fmess.new_zeros(fmess.shape[0], H)
        c = torch.zeros_like(h)
        for _ in range(self.depth):
            g = gather(torch.cat([h, h @ k_f, c], dim=-1))
            h_nei, fh_nei, c_nei = g.split(H, dim=-1)
            h_sum = h_nei.sum(dim=1)
            gi, go, gu = (h_sum @ k_iou).split(H, dim=-1)
            i = torch.sigmoid(xi + gi)
            o = torch.sigmoid(xo + go)
            u = torch.tanh(xu + gu)
            f = torch.sigmoid(xf + fh_nei)
            c = i * u + (f * c_nei).sum(dim=1)
            h = zero(o * torch.tanh(c))
            c = zero(c)
        return h, c
