"""The edge-message LSTM in plain PyTorch (a frozen copy of the port's
``models/rnn.py``, float32 only): the encoder's depth loop and the split
step the decoders' teacher-forced scans apply.  The depth loop's row
gather is ``v[bgraph]``, whose backward autograd gives.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import zero_row0


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

    def init_state(self, num_mess: int, init_rows: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero ``(h, c)`` of ``num_mess`` rows with ``init_rows`` [R, H]
        appended to ``h`` (zeros to ``c``)."""
        zeros = torch.zeros((num_mess, self.hidden_size),
                            device=init_rows.device)
        return (torch.cat([zeros, init_rows]),
                torch.cat([zeros, torch.zeros_like(init_rows)]))

    # -- split-step API for the teacher-forced decoder scans (reference
    # rnn.py:228-266) ------------------------------------------------------
    def x_weights(self, in_dim: int):
        """``x_proj``'s x-side kernels with their biases."""
        return [(m.weight[:, :in_dim], m.bias)
                for m in (self.W_i, self.W_o, self.W, self.W_f)]

    def x_proj(self, x: torch.Tensor, xw=None) -> torch.Tensor:
        """Loop-invariant gate terms xi | xo | xu | xf ([..., 4H])."""
        xw = self.x_weights(x.shape[-1]) if xw is None else xw
        return torch.cat([F.linear(x, w, b) for w, b in xw], dim=-1)

    def k_h(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """h-side kernels: (K_iou stacked [H, 3H], kf [H, H])."""
        H = self.hidden_size
        kiou = torch.cat([m.weight[:, -H:] for m in (self.W_i, self.W_o,
                                                      self.W)]).t()
        return kiou, self.W_f.weight[:, -H:].t()

    @staticmethod
    def step(xp: torch.Tensor, state_nei, ks) -> Tuple[torch.Tensor, ...]:
        """One cell application from ``x_proj``'s terms ``xp`` [R, 4H] and
        the gathered neighbour states ``(h_nei, c_nei)``, each [R, A, H]."""
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

    def forward(self, fmess: torch.Tensor, bgraph: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``depth`` rounds over every message; returns ``(h, c)``.  The
        forget gate of neighbour k is ``W_f([x, h_k])``, its x-side term
        computed once; row 0 (the padding message) is zeroed every
        round."""
        in_dim = fmess.shape[-1]
        xi, xo, xu, xf = (F.linear(fmess, m.weight[:, :in_dim], m.bias)
                          for m in (self.W_i, self.W_o, self.W, self.W_f))
        xf = xf[:, None, :]
        k_iou, k_f = self.k_h()
        bgraph = bgraph.long()
        h = xi.new_zeros(fmess.shape[0], self.hidden_size)
        c = torch.zeros_like(h)
        for _ in range(self.depth):
            h_nei, c_nei = h[bgraph], c[bgraph]
            gi, go, gu = (h_nei.sum(dim=1) @ k_iou).chunk(3, dim=-1)
            i = torch.sigmoid(xi + gi)
            o = torch.sigmoid(xo + go)
            u = torch.tanh(xu + gu)
            f = torch.sigmoid(xf + h_nei @ k_f)
            c = i * u + (f * c_nei).sum(dim=1)
            h = zero_row0(o * torch.tanh(c))
            c = zero_row0(c)
        return h, c
