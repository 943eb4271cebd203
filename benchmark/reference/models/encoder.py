"""Graph encoders in plain PyTorch: ``MPNEncoder``, ``MotifEncoder`` and
the three-level ``HierMPNEncoder`` (a frozen copy of the port's
``models/encoder.py``, float32 and LSTM only).  Every neighbour sum is
``h[graph].sum(1)`` and every row gather ``h[graph]``: autograd gives
their backward, where the port launches its kernels.  The embeddings are
the VAE's, shared with the decoder (reference encoder.py:92-94).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from ..ops import nei_sum, zero_row0
from .rnn import MPNLSTMCell


def pos_onehot(idx: torch.Tensor) -> torch.Tensor:
    return F.one_hot(idx.clamp(0, MAX_POS - 1).long(), MAX_POS).float()


class MPNEncoder(nn.Module):
    """One message-passing level (reference encoder.py:8-38): the depth
    loop over messages, then the node readout."""

    def __init__(self, input_size: int, node_size: int, hidden_size: int,
                 depth: int):
        super().__init__()
        self.W_o = nn.Linear(node_size + hidden_size, hidden_size)
        self.rnn = MPNLSTMCell(input_size, hidden_size, depth)

    def forward(self, hnode, hmess, agraph, bgraph):
        """The node hiddens and the messages."""
        h, _ = self.rnn(hmess, bgraph)
        nei_message = nei_sum(h, agraph)
        node_hiddens = F.relu(self.W_o(torch.cat([hnode, nei_message], -1)))
        return zero_row0(node_hiddens), h


class MotifEncoder(nn.Module):
    """Motif-level-only encoder — the thesis "MotifG2G" (reference
    encoder.py:252-341)."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 depthT: int):
        super().__init__()
        embed_size = E_c.embedding_dim
        self._embed = (E_c, E_i)        # the VAE's: not registered here
        self.W_root = nn.Linear(embed_size + hidden_size, hidden_size)
        self.tree_encoder = MPNEncoder(embed_size + MAX_POS, embed_size,
                                       hidden_size, depthT)

    def forward(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The root vectors."""
        E_c, E_i = self._embed
        fnode, fmess = tree['fnode'], tree['fmess']
        hnode = E_c(fnode[:, 0])
        hmess = torch.cat([E_i(fnode[:, 1])[fmess[:, 0]],
                           pos_onehot(fmess[:, 2])], dim=-1)
        _, mess = self.tree_encoder(hnode, hmess, tree['agraph'],
                                    tree['bgraph'])
        # root readout (reference encoder.py:317-328)
        roots = tree['scope'][:, 0]
        nei = nei_sum(mess, tree['agraph'][roots])
        return torch.tanh(self.W_root(torch.cat([hnode[roots], nei], dim=-1)))


class HierMPNEncoder(nn.Module):
    """Three-level atom → attachment → motif encoder (reference
    encoder.py:41-157): the atom level runs ``depthG`` rounds over the
    molecule's bonds, the attachment and motif levels ``depthT`` rounds
    each over the junction tree."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 depthT: int, depthG: int, atom_vocab_size: int):
        super().__init__()
        embed_size = E_c.embedding_dim
        h = hidden_size
        self._embed = (E_c, E_i)
        self.atom_vocab_size = atom_vocab_size
        self.W_c = nn.Linear(embed_size + h, h)
        self.W_i = nn.Linear(embed_size + h, h)
        self.W_root = nn.Linear(2 * h, h)
        self.tree_encoder = MPNEncoder(h + MAX_POS, h, h, depthT)
        self.inter_encoder = MPNEncoder(h + MAX_POS, h, h, depthT)
        self.graph_encoder = MPNEncoder(atom_vocab_size + 4 + MAX_POS,
                                        atom_vocab_size, h, depthG)

    def forward(self, tree: Dict[str, torch.Tensor],
                graph: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The root vectors."""
        E_c, E_i = self._embed
        # atom level (reference encoder.py:119-126)
        gnode, gmess = graph['fnode'], graph['fmess']
        hnode_g = F.one_hot(gnode.long(), self.atom_vocab_size).float()
        hmess_g = torch.cat([
            hnode_g[gmess[:, 0]],
            F.one_hot(gmess[:, 2].clamp(0, 3).long(), 4).float(),
            pos_onehot(gmess[:, 3])], dim=-1)
        hatom, _ = self.graph_encoder(hnode_g, hmess_g, graph['agraph'],
                                      graph['bgraph'])
        fnode, fmess = tree['fnode'], tree['fmess']
        # attachment level (reference embed_inter, encoder.py:96-107)
        hclu = nei_sum(hatom, tree['cgraph'])
        hnode_i = F.relu(self.W_i(torch.cat([E_i(fnode[:, 1]), hclu], -1)))
        hmess_i = torch.cat([hnode_i[fmess[:, 0]], pos_onehot(fmess[:, 2])],
                            dim=-1)
        hinter, _ = self.inter_encoder(hnode_i, hmess_i, tree['agraph'],
                                       tree['bgraph'])
        # motif level (reference embed_tree, encoder.py:109-117)
        hnode_t = F.relu(self.W_c(torch.cat([E_c(fnode[:, 0]), hinter], -1)))
        hmess_t = torch.cat([hnode_t[fmess[:, 0]], pos_onehot(fmess[:, 2])],
                            dim=-1)
        _, hmess = self.tree_encoder(hnode_t, hmess_t, tree['agraph'],
                                     tree['bgraph'])
        # root readout over the motif level (reference encoder.py:128-138)
        roots = tree['scope'][:, 0]
        nei = nei_sum(hmess, tree['agraph'][roots])
        return torch.tanh(self.W_root(torch.cat([hnode_t[roots], nei],
                                                dim=-1)))
