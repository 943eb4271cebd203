"""Motif-level graph encoder (counterpart of ``ggpm_tpu/models/encoder.py``:
``MPNEncoder``, ``pos_onehot``, ``MotifEncoder``; the hierarchical encoder
arrives with the hier family).

Both readouts, over ``agraph`` and at the roots, go through the ``nei_sum``
kernel; a training batch (``data.batching.train_tables``) brings their
transpose tables, and then they go through ``nei_sum_t``, whose backward is
the kernel's transpose.  The motif and attachment embeddings are owned by
the VAE and shared with the decoder (reference encoder.py:92-94), so the
encoder holds them without registering them as its own parameters.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from ..ops import gather_nd, nei_sum, nei_sum_t, zero_row0, zero_row0_
from .rnn import MPNLSTMCell


def dropout(p: float) -> nn.Module:
    """``nn.Dropout(p)``, or nothing to launch at p = 0 (flax's ``Dropout``
    at rate 0 is the identity)."""
    return nn.Dropout(p) if p > 0 else nn.Identity()


def readout(h: torch.Tensor, graph: torch.Tensor, t=None) -> torch.Tensor:
    """``nei_sum(h, graph)``; with ``t = (t_idx, t_mask)``, the transpose of
    ``graph`` over the rows of ``h``, ``nei_sum_t``."""
    return nei_sum(h, graph) if t is None else nei_sum_t(h, graph, *t)


def level_tables(level: Dict[str, torch.Tensor], name: str):
    """The transpose table ``(level[name + '_t'], level[name + '_tm'])``
    of a training batch, or None."""
    t = level.get(name + '_t')
    return None if t is None else (t, level[name + '_tm'])


class MPNEncoder(nn.Module):
    """One message-passing level (reference encoder.py:8-38): the depth loop
    over messages, then the node readout."""

    def __init__(self, input_size: int, node_size: int, hidden_size: int,
                 depth: int, dropout_rate: float = 0.0):
        super().__init__()
        self.W_o = nn.Linear(node_size + hidden_size, hidden_size)
        self.drop = dropout(dropout_rate)
        self.rnn = MPNLSTMCell(input_size, hidden_size, depth)

    def forward(self, hnode, hmess, agraph, bgraph, bt=None, at=None):
        """``bt``/``at``: the transposes of ``bgraph`` and ``agraph``
        (training batches), for the depth loop's gather and the readout."""
        h, _ = self.rnn(hmess, bgraph, bt)
        nei_message = readout(h, agraph, at)
        node_hiddens = self.drop(F.relu(
            self.W_o(torch.cat([hnode, nei_message], -1))))
        zero = zero_row0 if torch.is_grad_enabled() else zero_row0_
        return zero(node_hiddens), h


def pos_onehot(idx: torch.Tensor) -> torch.Tensor:
    return F.one_hot(idx.clamp(0, MAX_POS - 1).long(), MAX_POS).float()


class MotifEncoder(nn.Module):
    """Motif-level-only encoder — the thesis "MotifG2G" (reference
    encoder.py:252-341)."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 depthT: int, dropout_rate: float = 0.0):
        super().__init__()
        embed_size = E_c.embedding_dim
        self._embed = (E_c, E_i)   # a tuple: not registered as submodules
        self.drop = dropout(dropout_rate)
        self.W_root = nn.Linear(embed_size + hidden_size, hidden_size)
        self.tree_encoder = MPNEncoder(embed_size + MAX_POS, embed_size,
                                       hidden_size, depthT, dropout_rate)

    def embed_tree(self, tree: Dict[str, torch.Tensor]):
        E_c, E_i = self._embed
        fnode, fmess = tree['fnode'], tree['fmess']
        hnode = self.drop(E_c(fnode[:, 0]))
        hmess_nodes = self.drop(E_i(fnode[:, 1]))
        hmess = torch.cat([gather_nd(hmess_nodes, fmess[:, 0]),
                           pos_onehot(fmess[:, 2])], dim=-1)
        return hnode, hmess

    def forward(self, tree: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        hnode_in, hmess_in = self.embed_tree(tree)
        node, mess = self.tree_encoder(
            hnode_in, hmess_in, tree['agraph'], tree['bgraph'],
            level_tables(tree, 'bgraph'), level_tables(tree, 'agraph'))
        # root readout (reference encoder.py:317-328)
        roots = tree['scope'][:, 0]
        froot = gather_nd(hnode_in, roots)
        nei = readout(mess, gather_nd(tree['agraph'], roots),
                      level_tables(tree, 'root'))
        root = torch.tanh(self.W_root(torch.cat([froot, nei], dim=-1)))
        return root, node
