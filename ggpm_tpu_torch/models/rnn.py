"""Message-passing LSTM over padded edge-message tables (forward of
``ggpm_tpu/models/rnn.py:MPNLSTMCell.__call__``; the GRU cell and the
decoder's split-step API arrive with the decode slice).

State layout: ``h`` and ``c`` are ``[num_messages, hidden]`` buffers whose
row 0 is the all-zero padding message.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gather_nd, zero_row0_


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

    def forward(self, fmess: torch.Tensor,
                bgraph: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``depth`` rounds over every message; returns ``(h, c)``.

        The x-side projections of every gate are loop-invariant and are
        computed once (biases live there); each round projects ``h`` by the
        forget gate's h-side kernel and gathers ``[h | h·Kf | c]`` by
        ``bgraph`` in one gather, so the per-neighbour forget gate costs an
        [E, H]×[H, H] product instead of an [E, A, in+H]×[in+H, H] one."""
        in_dim = fmess.shape[-1]
        H = self.hidden_size
        xi, xo, xu, xf = (F.linear(fmess, m.weight[:, :in_dim], m.bias)
                          for m in (self.W_i, self.W_o, self.W, self.W_f))
        xf = xf[:, None, :]
        k_iou = torch.cat([m.weight[:, in_dim:]
                           for m in (self.W_i, self.W_o, self.W)]).t()
        k_f = self.W_f.weight[:, in_dim:].t()

        h = fmess.new_zeros(fmess.shape[0], H)
        c = torch.zeros_like(h)
        for _ in range(self.depth):
            g = gather_nd(torch.cat([h, h @ k_f, c], dim=-1), bgraph)
            h_nei, fh_nei, c_nei = g.split(H, dim=-1)
            h_sum = h_nei.sum(dim=1)
            gi, go, gu = (h_sum @ k_iou).split(H, dim=-1)
            i = torch.sigmoid(xi + gi)
            o = torch.sigmoid(xo + go)
            u = torch.tanh(xu + gu)
            f = torch.sigmoid(xf + fh_nei)
            c = i * u + (f * c_nei).sum(dim=1)
            h = o * torch.tanh(c)
            zero_row0_(h)
            zero_row0_(c)
        return h, c
