"""Motif-level graph encoder (counterpart of ``ggpm_tpu/models/encoder.py``:
``MPNEncoder``, ``pos_onehot``, ``MotifEncoder``; the hierarchical encoder
arrives with the hier family).

Both readouts, over ``agraph`` and at the roots, go through the ``nei_sum``
kernel.  The motif and attachment embeddings are owned by the VAE and shared
with the decoder (reference encoder.py:92-94), so the encoder holds them
without registering them as its own parameters.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from ..ops import gather_nd, nei_sum, zero_row0_
from .rnn import MPNLSTMCell


class MPNEncoder(nn.Module):
    """One message-passing level (reference encoder.py:8-38): the depth loop
    over messages, then the node readout."""

    def __init__(self, input_size: int, node_size: int, hidden_size: int,
                 depth: int):
        super().__init__()
        self.W_o = nn.Linear(node_size + hidden_size, hidden_size)
        self.rnn = MPNLSTMCell(input_size, hidden_size, depth)

    def forward(self, hnode, hmess, agraph, bgraph):
        h, _ = self.rnn(hmess, bgraph)
        nei_message = nei_sum(h, agraph)
        node_hiddens = F.relu(self.W_o(torch.cat([hnode, nei_message], -1)))
        return zero_row0_(node_hiddens), h


def pos_onehot(idx: torch.Tensor) -> torch.Tensor:
    return F.one_hot(idx.clamp(0, MAX_POS - 1).long(), MAX_POS).float()


class MotifEncoder(nn.Module):
    """Motif-level-only encoder — the thesis "MotifG2G" (reference
    encoder.py:252-341)."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 depthT: int):
        super().__init__()
        embed_size = E_c.embedding_dim
        self._embed = (E_c, E_i)   # a tuple: not registered as submodules
        self.W_root = nn.Linear(embed_size + hidden_size, hidden_size)
        self.tree_encoder = MPNEncoder(embed_size + MAX_POS, embed_size,
                                       hidden_size, depthT)

    def embed_tree(self, tree: Dict[str, torch.Tensor]):
        E_c, E_i = self._embed
        fnode, fmess = tree['fnode'], tree['fmess']
        hnode = E_c(fnode[:, 0])
        hmess_nodes = E_i(fnode[:, 1])
        hmess = torch.cat([gather_nd(hmess_nodes, fmess[:, 0]),
                           pos_onehot(fmess[:, 2])], dim=-1)
        return hnode, hmess

    def forward(self, tree: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        hnode_in, hmess_in = self.embed_tree(tree)
        node, mess = self.tree_encoder(hnode_in, hmess_in, tree['agraph'],
                                       tree['bgraph'])
        # root readout (reference encoder.py:317-328)
        roots = tree['scope'][:, 0]
        froot = gather_nd(hnode_in, roots)
        nei = nei_sum(mess, gather_nd(tree['agraph'], roots))
        root = torch.tanh(self.W_root(torch.cat([froot, nei], dim=-1)))
        return root, node
