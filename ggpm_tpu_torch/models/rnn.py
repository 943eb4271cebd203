"""Message-passing cells over padded edge-message tables (counterpart of
``ggpm_tpu/models/rnn.py``: ``MPNGRUCell`` and ``MPNLSTMCell``, each with
the dense forward, the decoder's one-step ``cell`` and the teacher-forced
split-step API, and ``make_cell``).

State layout: a tuple of ``[num_messages, hidden]`` buffers, ``(h,)`` for
the GRU and ``(h, c)`` for the LSTM, whose row 0 is the all-zero padding
message.

``dtype`` is the dense forward's compute type (the encoders' depth loops;
JAX ``MPNEncoder(dtype=...)``): with ``torch.bfloat16`` every ``Linear`` of
the loop runs as flax's ``nn.Dense(dtype=bf16)`` does (input, kernel and
bias cast to bf16, a bf16 output), the hoisted kernel slices are cast the
same way, and the loop's state and gathers are bf16.  The parameters stay
f32.  The decoders' cells run in f32 (JAX builds them without a dtype).

Where a bf16 value is rounded follows what the JAX package computes: each
primitive rounds its result to bf16, a matmul's product before its bias
is added (``linear``), and a sigmoid is ``1 / (1 + exp(-x))`` with each of
its three steps rounded (``sigmoid``), as XLA expands ``jax.nn.sigmoid``;
sums over neighbours accumulate in f32 and round once.  The backwards of
the sigmoid and of tanh are JAX's, op by op in bf16 (``g·(y·(1 − y))``,
and ``a + a·y`` with ``a = g·(1 − y)``, the transpose of JAX's tanh
JVP), where PyTorch's own would round once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gather_nd_t, gather_rows, zero_row0, zero_row0_


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``F.linear`` in ``dtype`` (None: as given), as ``nn.Dense(dtype=)``
    computes: input, weight and bias cast first, the bias added to the
    rounded product."""
    if dtype is None:
        return F.linear(x, w, b)
    y = F.linear(x.to(dtype), w.to(dtype))
    return y if b is None else y + b.to(dtype)


class _SigmoidBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (y * (1.0 - y))


class _TanhBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        a = g * (1.0 - y)
        return a + a * y


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid``; for bf16, ``1 / (1 + exp(-x))`` with each step
    rounded to bf16, as XLA computes ``jax.nn.sigmoid`` in bf16, with
    JAX's backward ``g·(y·(1 − y))``."""
    if x.dtype == torch.bfloat16:
        return _SigmoidBF16.apply(x)
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """``torch.tanh``, with JAX's backward ``a + a·y``, ``a = g·(1 − y)``,
    op by op for bf16."""
    if x.dtype == torch.bfloat16:
        return _TanhBF16.apply(x)
    return torch.tanh(x)


def _cast(dtype, *ts):
    return ts if dtype is None else tuple(t.to(dtype) for t in ts)


def _depth_gather(bgraph: torch.Tensor, bt):
    """The depth loop's fused row gather: ``gather_rows`` (K3), or with
    ``bt``, the host-built transpose ``(t_idx, t_mask)`` of ``bgraph``,
    ``gather_nd_t`` (K3 forward, K2 backward; reference rnn.py:23-44);
    without it the loop has no backward on the card."""
    if bt is None:
        return lambda v: gather_rows(v, bgraph)
    return lambda v: gather_nd_t(v, bgraph, *bt)


class _Cell(nn.Module):
    """What both cells share: the state buffers and their hidden."""
    n_state = 1

    def init_state(self, num_mess: int, device=None,
                   init_rows: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, ...]:
        """Zero state buffers of ``num_mess`` rows; with ``init_rows``
        [R, H] those rows are appended to ``h`` (zeros to the others), as
        JAX ``init_state(num_mess, init_rows)`` does."""
        if init_rows is not None:
            device = init_rows.device
        zeros = torch.zeros((num_mess, self.hidden_size), device=device)
        state = [zeros] + [torch.zeros_like(zeros)
                           for _ in range(self.n_state - 1)]
        if init_rows is not None:
            state = [torch.cat([s, init_rows if k == 0 else
                                torch.zeros_like(init_rows)])
                     for k, s in enumerate(state)]
        return tuple(state)

    @staticmethod
    def hidden(state) -> torch.Tensor:
        return state[0]


class MPNGRUCell(_Cell):
    """Edge-message GRU (reference rnn.py:5-59): ``W_z`` and ``W_h`` over
    ``[x | h]``, ``W_r`` over ``x`` without a bias, ``U_r`` over one
    neighbour's ``h``, as the flax ``Dense`` layers they are bridged
    from."""
    n_state = 1

    def __init__(self, input_size: int, hidden_size: int, depth: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.depth = depth
        self.dtype = dtype
        n_in = input_size + hidden_size
        self.W_z = nn.Linear(n_in, hidden_size)
        self.W_r = nn.Linear(input_size, hidden_size, bias=False)
        self.U_r = nn.Linear(hidden_size, hidden_size)
        self.W_h = nn.Linear(n_in, hidden_size)

    def cell(self, x: torch.Tensor, state_nei) -> Tuple[torch.Tensor]:
        """One application to rows with inputs ``x`` [R, in] and gathered
        neighbour states ``(h_nei,)`` [R, A, H] (JAX rnn.py:73-87)."""
        h_nei, = state_nei
        sum_h = h_nei.sum(dim=-2)
        z = torch.sigmoid(self.W_z(torch.cat([x, sum_h], dim=-1)))
        r = torch.sigmoid(self.W_r(x)[..., None, :] + self.U_r(h_nei))
        sum_gated_h = (r * h_nei).sum(dim=-2)
        pre_h = torch.tanh(self.W_h(torch.cat([x, sum_gated_h], dim=-1)))
        return ((1.0 - z) * sum_h + z * pre_h,)

    # -- split-step API for the teacher-forced decoder scan (JAX
    # rnn.py:89-121): the same math as ``cell`` ------------------------
    def x_weights(self, in_dim: int):
        """``x_proj``'s x-side kernels with their biases (``U_r``'s bias
        folded into the reset gate's), for inputs of ``in_dim``
        features."""
        return [(self.W_z.weight[:, :in_dim], self.W_z.bias),
                (self.W_r.weight, self.U_r.bias),
                (self.W_h.weight[:, :in_dim], self.W_h.bias)]

    def x_proj(self, x: torch.Tensor, xw=None) -> torch.Tensor:
        """Loop-invariant gate terms xz | xr' | xh_pre ([..., 3H]), biases
        included; ``xw`` from ``x_weights``, else taken here."""
        xw = self.x_weights(x.shape[-1]) if xw is None else xw
        return torch.cat([F.linear(x, w, b) for w, b in xw], dim=-1)

    def k_h(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """h-side kernels (kz [H, H], kh [H, H], U_r's kernel [H, H])."""
        H = self.hidden_size
        return (self.W_z.weight[:, -H:].t(), self.W_h.weight[:, -H:].t(),
                self.U_r.weight.t())

    @staticmethod
    def step(xp: torch.Tensor, state_nei, ks) -> Tuple[torch.Tensor]:
        """One cell application from hoisted x terms: ``xp`` [R, 3H] from
        ``x_proj``, ``state_nei = (h_nei,)`` [R, A, H], ``ks`` from
        ``k_h``."""
        kz, kh, ku = ks
        h_nei, = state_nei
        xz, xr, xh_pre = xp.chunk(3, dim=-1)
        sum_h = h_nei.sum(dim=-2)
        z = torch.sigmoid(xz + sum_h @ kz)
        r = torch.sigmoid(xr[..., None, :] + h_nei @ ku)
        sum_gated_h = (r * h_nei).sum(dim=-2)
        pre_h = torch.tanh(xh_pre + sum_gated_h @ kh)
        return ((1.0 - z) * sum_h + z * pre_h,)

    def forward(self, fmess: torch.Tensor, bgraph: torch.Tensor,
                bt=None) -> Tuple[torch.Tensor]:
        """``depth`` rounds over every message; returns ``(h,)`` in the
        compute type (JAX rnn.py:123-175).

        The x-side projections of every gate are loop-invariant and are
        computed once (biases there); each round projects ``h`` by
        ``U_r`` and gathers ``[h | h·U_r + b_r]`` by ``bgraph`` in one
        gather (``_depth_gather``), so the per-neighbour reset gate costs
        an [E, H]×[H, H] product.  Row 0 of that table holds ``b_r``, not
        zeros: the gather reads it like any other row, and it is harmless
        because the reset gate multiplies ``h_nei``, zero there.  Row 0 of
        the state is zeroed out of place while autograd records, in place
        otherwise."""
        dt = self.dtype
        in_dim = fmess.shape[-1]
        H = self.hidden_size
        xz = linear(fmess, self.W_z.weight[:, :in_dim], self.W_z.bias, dt)
        xr = linear(fmess, self.W_r.weight, None, dt)[:, None, :]
        xh_pre = linear(fmess, self.W_h.weight[:, :in_dim], self.W_h.bias,
                        dt)
        kz, kh, ur_k, ur_b = _cast(
            dt, self.W_z.weight[:, in_dim:].t(),
            self.W_h.weight[:, in_dim:].t(), self.U_r.weight.t(),
            self.U_r.bias)
        gather = _depth_gather(bgraph, bt)
        zero = zero_row0 if torch.is_grad_enabled() else zero_row0_

        h = xz.new_zeros(fmess.shape[0], H)
        for _ in range(self.depth):
            g = gather(torch.cat([h, h @ ur_k + ur_b], dim=-1))
            h_nei, r_pre = g.split(H, dim=-1)
            sum_h = h_nei.sum(dim=1)
            z = sigmoid(xz + sum_h @ kz)
            r = sigmoid(xr + r_pre)
            sum_gated_h = (r * h_nei).sum(dim=1)
            pre_h = tanh(xh_pre + sum_gated_h @ kh)
            h = zero((1.0 - z) * sum_h + z * pre_h)
        return (h,)


class MPNLSTMCell(_Cell):
    """Edge-message LSTM with per-neighbour forget gates (reference
    rnn.py:61-121).  Each gate is one ``Linear`` over ``[x | h]``
    (``input_size + hidden_size`` inputs), as the flax ``Dense`` it is
    bridged from."""
    n_state = 2

    def __init__(self, input_size: int, hidden_size: int, depth: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.depth = depth
        self.dtype = dtype
        n_in = input_size + hidden_size
        self.W_i = nn.Linear(n_in, hidden_size)
        self.W_o = nn.Linear(n_in, hidden_size)
        self.W_f = nn.Linear(n_in, hidden_size)
        self.W = nn.Linear(n_in, hidden_size)

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
    def x_weights(self, in_dim: int):
        """``x_proj``'s x-side kernels with their biases, for inputs of
        ``in_dim`` features.  A loop that projects new inputs each
        iteration takes them once, so that the slices' backward runs once
        (for a sum of the iterations' gradients)."""
        return [(m.weight[:, :in_dim], m.bias)
                for m in (self.W_i, self.W_o, self.W, self.W_f)]

    def x_proj(self, x: torch.Tensor, xw=None) -> torch.Tensor:
        """Loop-invariant gate terms xi | xo | xu | xf ([..., 4H]), biases
        included; ``xw`` from ``x_weights``, else taken here."""
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
        """``depth`` rounds over every message; returns ``(h, c)`` in the
        compute type.

        The x-side projections of every gate are loop-invariant and are
        computed once (biases live there); each round projects ``h`` by the
        forget gate's h-side kernel and gathers ``[h | h·Kf | c]`` by
        ``bgraph`` in one gather (``_depth_gather``), so the per-neighbour
        forget gate costs an [E, H]×[H, H] product instead of an
        [E, A, in+H]×[in+H, H] one.  Row 0 is zeroed out of place while
        autograd records, in place otherwise."""
        dt = self.dtype
        in_dim = fmess.shape[-1]
        H = self.hidden_size
        xi, xo, xu, xf = (linear(fmess, m.weight[:, :in_dim], m.bias, dt)
                          for m in (self.W_i, self.W_o, self.W, self.W_f))
        xf = xf[:, None, :]
        k_iou, k_f = _cast(
            dt, torch.cat([m.weight[:, in_dim:]
                           for m in (self.W_i, self.W_o, self.W)]).t(),
            self.W_f.weight[:, in_dim:].t())
        gather = _depth_gather(bgraph, bt)
        zero = zero_row0 if torch.is_grad_enabled() else zero_row0_

        h = xi.new_zeros(fmess.shape[0], H)
        c = torch.zeros_like(h)
        for _ in range(self.depth):
            g = gather(torch.cat([h, h @ k_f, c], dim=-1))
            h_nei, fh_nei, c_nei = g.split(H, dim=-1)
            h_sum = h_nei.sum(dim=1)
            gi, go, gu = (h_sum @ k_iou).split(H, dim=-1)
            i = sigmoid(xi + gi)
            o = sigmoid(xo + go)
            u = tanh(xu + gu)
            f = sigmoid(xf + fh_nei)
            c = i * u + (f * c_nei).sum(dim=1)
            h = zero(o * tanh(c))
            c = zero(c)
        return h, c


def make_cell(rnn_type: str, input_size: int, hidden_size: int, depth: int,
              dtype: Optional[torch.dtype] = None) -> _Cell:
    """The cell of ``rnn_type`` ('GRU' or 'LSTM'; JAX rnn.py:344)."""
    if rnn_type == 'GRU':
        return MPNGRUCell(input_size, hidden_size, depth, dtype)
    if rnn_type == 'LSTM':
        return MPNLSTMCell(input_size, hidden_size, depth, dtype)
    raise ValueError(f'unsupported rnn cell type {rnn_type}')
