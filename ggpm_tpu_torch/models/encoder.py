"""Graph encoders (counterpart of ``ggpm_tpu/models/encoder.py``:
``MPNEncoder``, ``pos_onehot``, ``MotifEncoder`` and the three-level
``HierMPNEncoder``).

Every readout (over ``agraph`` at each level, at the roots, and the hier
encoder's cluster sum over ``cgraph``) goes through the ``nei_sum`` kernel,
and every depth loop gathers through ``gather_rows``; a training batch (``data.batching.train_tables``) brings their
transpose tables, and then they go through ``nei_sum_t``, whose backward is
the kernel's transpose.  With tied embeddings (``tie_embedding``, the
default) the motif and attachment embeddings are owned by the VAE and
shared with the decoder (reference encoder.py:92-94), so the encoder holds
them without registering them as its own parameters; untied, it owns them
as ``E_c_mod`` and ``E_i_mod`` (JAX encoder.py:87-90).

``dtype`` (``torch.bfloat16`` for a config's ``compute_dtype`` 'bf16') is
the compute type of each level's depth loop, its node readout and ``W_o``
(JAX encoder.py:42-55): the messages are cast in, the loop's gathers and
the readout's neighbour sum run on bf16 tables (the sums accumulate in f32
and round once, as ``jnp.sum`` does), and the node hiddens and messages
come back as f32.  The root readouts, the hier cluster sum and every other
layer stay f32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from ..ops import gather_nd, nei_sum, nei_sum_t, zero_row0, zero_row0_
from .rnn import linear, make_cell


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
    over messages, then the node readout, in ``dtype`` (None: f32)."""

    def __init__(self, input_size: int, node_size: int, hidden_size: int,
                 depth: int, dropout_rate: float = 0.0,
                 rnn_type: str = 'LSTM', dtype=None):
        super().__init__()
        self.dtype = dtype
        self.W_o = nn.Linear(node_size + hidden_size, hidden_size)
        self.drop = dropout(dropout_rate)
        self.rnn = make_cell(rnn_type, input_size, hidden_size, depth, dtype)

    def forward(self, hnode, hmess, agraph, bgraph, bt=None, at=None):
        """``bt``/``at``: the transposes of ``bgraph`` and ``agraph``
        (training batches), for the depth loop's gather and the readout.
        Returns the node hiddens and the messages, both f32."""
        dt = self.dtype
        if dt is not None:
            hmess, hnode = hmess.to(dt), hnode.to(dt)
        h = self.rnn.hidden(self.rnn(hmess, bgraph, bt))
        nei_message = readout(h, agraph, at)
        node_hiddens = self.drop(F.relu(linear(
            torch.cat([hnode, nei_message], -1), self.W_o.weight,
            self.W_o.bias, dt)))
        zero = zero_row0 if torch.is_grad_enabled() else zero_row0_
        return zero(node_hiddens).float(), h.float()


def pos_onehot(idx: torch.Tensor) -> torch.Tensor:
    return F.one_hot(idx.clamp(0, MAX_POS - 1).long(), MAX_POS).float()


def own_embeddings(module: nn.Module, E_c: nn.Embedding, E_i: nn.Embedding,
                   owned: bool) -> None:
    """Give ``module`` its embeddings ``_embed = (E_c, E_i)``: shared ones
    (tied, owned by the VAE) in a tuple, which does not register them;
    with ``owned`` (untied), also registered as ``E_c_mod`` and
    ``E_i_mod``, the flax names of a module's own tables."""
    if owned:
        module.E_c_mod, module.E_i_mod = E_c, E_i
    module._embed = (E_c, E_i)


class MotifEncoder(nn.Module):
    """Motif-level-only encoder — the thesis "MotifG2G" (reference
    encoder.py:252-341).  ``owned``: the embeddings are this encoder's own
    (untied)."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 depthT: int, dropout_rate: float = 0.0,
                 rnn_type: str = 'LSTM', dtype=None, owned: bool = False):
        super().__init__()
        embed_size = E_c.embedding_dim
        own_embeddings(self, E_c, E_i, owned)
        self.drop = dropout(dropout_rate)
        self.W_root = nn.Linear(embed_size + hidden_size, hidden_size)
        self.tree_encoder = MPNEncoder(embed_size + MAX_POS, embed_size,
                                       hidden_size, depthT, dropout_rate,
                                       rnn_type, dtype)

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


class HierMPNEncoder(nn.Module):
    """Three-level atom → attachment → motif encoder (reference
    encoder.py:41-157): the atom level runs ``depthG`` rounds over the
    molecule's bonds, the attachment and motif levels ``depthT`` rounds
    each over the junction tree.  Each level's readout, the cluster sum
    ``nei_sum(hatom, cgraph)`` and the root readout go through the
    ``nei_sum`` kernel (five launches an encode); ``cgraph`` pads with 0,
    so it reads row 0 of ``hatom``, which ``MPNEncoder`` zeroes.
    ``owned``: the embeddings are this encoder's own (untied)."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 depthT: int, depthG: int, atom_vocab_size: int,
                 dropout_rate: float = 0.0, rnn_type: str = 'LSTM',
                 dtype=None, owned: bool = False):
        super().__init__()
        embed_size = E_c.embedding_dim
        h = hidden_size
        own_embeddings(self, E_c, E_i, owned)
        self.atom_vocab_size = atom_vocab_size
        self.drop = dropout(dropout_rate)
        self.W_c = nn.Linear(embed_size + h, h)
        self.W_i = nn.Linear(embed_size + h, h)
        self.W_root = nn.Linear(2 * h, h)
        level = dict(dropout_rate=dropout_rate, rnn_type=rnn_type,
                     dtype=dtype)
        self.tree_encoder = MPNEncoder(h + MAX_POS, h, h, depthT, **level)
        self.inter_encoder = MPNEncoder(h + MAX_POS, h, h, depthT, **level)
        self.graph_encoder = MPNEncoder(atom_vocab_size + 4 + MAX_POS,
                                        atom_vocab_size, h, depthG, **level)

    def embed_graph(self, graph: Dict[str, torch.Tensor]):
        """Atom-level features (reference encoder.py:119-126): the atom
        type one-hot of each atom, and of each bond message its source
        atom's, its bond type's (4) and its position's."""
        fnode, fmess = graph['fnode'], graph['fmess']
        hnode = F.one_hot(fnode.long(), self.atom_vocab_size).float()
        hmess = torch.cat([
            gather_nd(hnode, fmess[:, 0]),
            F.one_hot(fmess[:, 2].clamp(0, 3).long(), 4).float(),
            pos_onehot(fmess[:, 3])], dim=-1)
        return hnode, hmess

    def forward(self, tree: Dict[str, torch.Tensor],
                graph: Dict[str, torch.Tensor]):
        """(root vectors, motif node hiddens, attachment node hiddens, atom
        hiddens)."""
        E_c, E_i = self._embed
        hnode_g, hmess_g = self.embed_graph(graph)
        hatom, _ = self.graph_encoder(
            hnode_g, hmess_g, graph['agraph'], graph['bgraph'],
            level_tables(graph, 'bgraph'), level_tables(graph, 'agraph'))
        fnode, fmess = tree['fnode'], tree['fmess']
        # attachment level (reference embed_inter, encoder.py:96-107)
        finput = self.drop(E_i(fnode[:, 1]))
        hclu = readout(hatom, tree['cgraph'], level_tables(tree, 'cgraph'))
        hnode_i = self.drop(F.relu(self.W_i(torch.cat([finput, hclu], -1))))
        hmess_i = torch.cat([gather_nd(hnode_i, fmess[:, 0]),
                             pos_onehot(fmess[:, 2])], dim=-1)
        hinter, _ = self.inter_encoder(
            hnode_i, hmess_i, tree['agraph'], tree['bgraph'],
            level_tables(tree, 'bgraph'), level_tables(tree, 'agraph'))
        # motif level (reference embed_tree, encoder.py:109-117)
        cinput = self.drop(E_c(fnode[:, 0]))
        hnode_t = self.drop(F.relu(self.W_c(torch.cat([cinput, hinter], -1))))
        hmess_t = torch.cat([gather_nd(hnode_t, fmess[:, 0]),
                             pos_onehot(fmess[:, 2])], dim=-1)
        hnode, hmess = self.tree_encoder(
            hnode_t, hmess_t, tree['agraph'], tree['bgraph'],
            level_tables(tree, 'bgraph'), level_tables(tree, 'agraph'))
        # root readout over the motif level (reference encoder.py:128-138)
        roots = tree['scope'][:, 0]
        froot = gather_nd(hnode_t, roots)
        nei = readout(hmess, gather_nd(tree['agraph'], roots),
                      level_tables(tree, 'root'))
        hroot = torch.tanh(self.W_root(torch.cat([froot, nei], dim=-1)))
        return hroot, hnode, hinter, hatom
