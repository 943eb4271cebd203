"""Hierarchical (3-level) decoder: its parameters and the exact decode's
steps (counterpart of ``ggpm_tpu/models/hier_decoder.py``: ``HierDecoder``'s
modules, ``_sparse_direct``, ``hdec_init``, ``hdec_graph_update``,
``hdec_topo``, ``hdec_mess_update``, ``hdec_cls``, ``hdec_step_fused`` and
``hdec_assm``).  The teacher-forced training forward and the turbo decode's
propose loop are ROADMAP A5's rest.

The decode state is ``(tree, inter, graph, hatom, hinter_node)``: the tree
and attachment levels' LSTM message states over the junction tree's edge
rows, the atom level's over the molecule's bond rows, and the atom and
attachment node hiddens.  Every buffer keeps row 0 at zero: the host loop
(``models/decode.py:decode_hier``) pads its index tables with 0, and the
steps write only zeros there.  The steps update the state in place and
return it.

The frontier gather-sums of a step (the atom readout over ``agraph``, the
cluster sums over ``cgraph`` and the attachment and tree readouts over the
frontier's incoming messages) go through the ``nei_sum`` kernel: five
launches a fused step.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from ..ops import nei_sum
from .decode import hier_topk
from .decoder import PredictionMLP
from .encoder import pos_onehot
from .rnn import MPNLSTMCell

Level = Tuple[torch.Tensor, torch.Tensor]
State = Tuple[Level, Level, Level, torch.Tensor, torch.Tensor]


def scatter_rows_(buf: torch.Tensor, rows: torch.Tensor,
                  values: torch.Tensor) -> None:
    """``buf[rows] = values`` in place, for ``rows`` [R] and ``values``
    [R, ...] whose lanes at row 0 hold zeros.  On the card ``index_put_``
    keeps one arbitrary writer of a row that appears twice, so that is sound
    only where every writer of a row writes the same values: row 0, and
    rows whose inputs coincide.  The CPU checks it."""
    rows = rows.long()
    if buf.device.type == 'cpu' and rows.numel() > 1:
        order = torch.argsort(rows, stable=True)
        r, v = rows[order], values[order]
        dup = (r[1:] == r[:-1]).nonzero().flatten()
        differ = (v[dup] != v[dup + 1]).flatten(1).any(1)
        if differ.any():
            raise AssertionError(
                'duplicate rows written with different values: '
                f'{sorted(set(r[dup[differ]].tolist()))}')
    buf.index_put_((rows,), values)


class HierDecoder(nn.Module):
    """The JAX ``HierDecoder`` without attention.  The motif and attachment
    embeddings are owned by the VAE (``tie_embedding``) and shared with the
    encoder, so the decoder holds them without registering them."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 latent_size: int, atom_vocab_size: int, diterT: int = 1,
                 diterG: int = 3, dropout_rate: float = 0.0):
        super().__init__()
        embed_size = E_c.embedding_dim
        h = hidden_size
        self._embed = (E_c, E_i)   # a tuple: not registered as submodules
        self.hidden_size = h
        self.latent_size = latent_size
        self.atom_vocab_size = atom_vocab_size
        self.diterT = diterT
        self.diterG = diterG
        # three incremental levels (reference IncHierMPNEncoder)
        self.tree_rnn = MPNLSTMCell(h + MAX_POS, h, diterT)
        self.inter_rnn = MPNLSTMCell(h + MAX_POS, h, diterT)
        self.graph_rnn = MPNLSTMCell(atom_vocab_size + 4 + MAX_POS, h, diterG)
        self.W_tree_node = nn.Linear(2 * h, h)
        self.W_inter_node = nn.Linear(2 * h, h)
        self.W_graph_node = nn.Linear(atom_vocab_size + h, h)
        self.W_c = nn.Linear(embed_size + h, h)
        self.W_i = nn.Linear(embed_size + h, h)
        head_in = h + latent_size
        self.topoNN = PredictionMLP(head_in, h, 1, dropout_rate)
        self.clsNN = PredictionMLP(head_in, h, E_c.num_embeddings,
                                   dropout_rate)
        self.iclsNN = PredictionMLP(head_in, h, E_i.num_embeddings,
                                    dropout_rate)
        self.matchNN = nn.Linear(h + embed_size + MAX_POS, h)
        self.W_assm = nn.Linear(h, latent_size)
        if latent_size != hidden_size:
            self.W_root = nn.Linear(latent_size, h)

    def root_vecs_to_hidden(self, root_vecs: torch.Tensor) -> torch.Tensor:
        if hasattr(self, 'W_root'):
            return self.W_root(root_vecs)
        return root_vecs

    def _atom_onehot(self, av: torch.Tensor) -> torch.Tensor:
        return F.one_hot(av.long(), self.atom_vocab_size).float()

    def _sparse_direct(self, rnn: MPNLSTMCell, state: Level,
                       rows: torch.Tensor, x: torch.Tensor,
                       bg_rows: torch.Tensor, n_iter: int) -> Level:
        """``n_iter`` cell applications to ``rows`` [R] with inputs ``x``
        and predecessor-row tables ``bg_rows`` [R, A], written into
        ``state`` in place each round; the x-side gate terms are computed
        once (the cell's split-step API).  Invalid lanes have row 0 and
        write zeros there."""
        valid = (rows > 0)[:, None]
        xp = rnn.x_proj(x)
        ks = rnn.k_h()
        bg = bg_rows.long()
        for _ in range(n_iter):
            new = rnn.step(xp, tuple(s[bg] for s in state), ks)
            for s, nr in zip(state, new):
                scatter_rows_(s, rows, torch.where(valid, nr, 0.0))
        return state

    # -- the decode steps (JAX hier_decoder.py:413-570) --------------------
    def hdec_init(self, n_tree_rows: int, n_graph_rows: int, n_gnodes: int,
                  n_tnodes: int, root_vecs: torch.Tensor) -> State:
        """Zero state with the latent wired into tree rows 1..B (the
        super-root→root edges)."""
        dev = root_vecs.device
        tree = self.tree_rnn.init_state(n_tree_rows, dev)
        tree[0][1:root_vecs.shape[0] + 1] = self.root_vecs_to_hidden(root_vecs)
        h = self.hidden_size
        return (tree, self.inter_rnn.init_state(n_tree_rows, dev),
                self.graph_rnn.init_state(n_graph_rows, dev),
                torch.zeros((n_gnodes, h), device=dev),
                torch.zeros((n_tnodes, h), device=dev))

    def hdec_root_cls(self, root_vecs: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Root motif and attachment logits from the latent."""
        x = torch.cat([self.root_vecs_to_hidden(root_vecs), root_vecs], -1)
        return self.clsNN(x), self.iclsNN(x)

    def _g_mess_input(self, src_av, bt, nth) -> torch.Tensor:
        return torch.cat([self._atom_onehot(src_av),
                          F.one_hot(bt.clamp(0, 3).long(), 4).float(),
                          pos_onehot(nth)], dim=-1)

    def hdec_graph_update(self, state: State, g_rows, g_src_av, g_bt, g_nth,
                          g_bg_rows, g_nodes, g_node_av, g_ag_rows) -> State:
        """Atom-level refresh of the frontier clusters: ``diterG`` rounds on
        their bond rows ``g_rows`` [B, KE], then their atoms' hiddens
        (``g_nodes`` [B, KN]) from the ``nei_sum`` readout over
        ``g_ag_rows`` [B, KN, A]."""
        tree_s, inter_s, graph_s, hatom, hinter_node = state
        x = self._g_mess_input(g_src_av.reshape(-1), g_bt.reshape(-1),
                               g_nth.reshape(-1))
        self._sparse_direct(self.graph_rnn, graph_s, g_rows.reshape(-1), x,
                            g_bg_rows.reshape(-1, g_bg_rows.shape[-1]),
                            self.diterG)
        gn = g_nodes.reshape(-1)
        nei = nei_sum(self.graph_rnn.hidden(graph_s),
                      g_ag_rows.reshape(-1, g_ag_rows.shape[-1]))
        node_h = F.relu(self.W_graph_node(torch.cat(
            [self._atom_onehot(g_node_av.reshape(-1)), nei], dim=-1)))
        scatter_rows_(hatom, gn, torch.where((gn > 0)[:, None], node_h, 0.0))
        return state

    def hdec_topo(self, state: State, v_nodes, v_clab, v_ilab, v_cgraph,
                  v_ag_rows, root_vecs) -> Tuple[State, torch.Tensor]:
        """Frontier readout at the three levels and the topology logit;
        refreshes the frontier's attachment-node hidden."""
        tree_s, inter_s, graph_s, hatom, hinter_node = state
        E_c, E_i = self._embed
        hclu = nei_sum(hatom, v_cgraph)
        inter_emb = F.relu(self.W_i(torch.cat([E_i(v_ilab), hclu], dim=-1)))
        inter_node = F.relu(self.W_inter_node(torch.cat(
            [inter_emb, nei_sum(self.inter_rnn.hidden(inter_s), v_ag_rows)],
            dim=-1)))
        scatter_rows_(hinter_node, v_nodes,
                      torch.where((v_nodes > 0)[:, None], inter_node, 0.0))
        tree_emb = F.relu(self.W_c(torch.cat([E_c(v_clab), inter_node], -1)))
        tree_node = F.relu(self.W_tree_node(torch.cat(
            [tree_emb, nei_sum(self.tree_rnn.hidden(tree_s), v_ag_rows)],
            dim=-1)))
        logits = self.topoNN(torch.cat([tree_node, root_vecs], -1))[..., 0]
        return state, logits

    def hdec_mess_update(self, state: State, rows, src_nodes, src_clab,
                         src_ilab, src_cgraph, pos, inter_bg_rows,
                         tree_bg_rows) -> State:
        """Attachment- and tree-level messages of this step's new edges."""
        tree_s, inter_s, graph_s, hatom, hinter_node = state
        E_c, E_i = self._embed
        hclu = nei_sum(hatom, src_cgraph)
        inter_emb = F.relu(self.W_i(torch.cat([E_i(src_ilab), hclu], -1)))
        pos_e = pos_onehot(pos)
        self._sparse_direct(self.inter_rnn, inter_s, rows,
                            torch.cat([inter_emb, pos_e], -1), inter_bg_rows,
                            self.diterT)
        tree_emb = F.relu(self.W_c(torch.cat(
            [E_c(src_clab), hinter_node[src_nodes.long()]], -1)))
        self._sparse_direct(self.tree_rnn, tree_s, rows,
                            torch.cat([tree_emb, pos_e], -1), tree_bg_rows,
                            self.diterT)
        return state

    def hdec_cls(self, state: State, rows, root_vecs
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        th = self.tree_rnn.hidden(state[0])
        x = torch.cat([th[rows.long()], root_vecs], dim=-1)
        return self.clsNN(x), self.iclsNN(x)

    def hdec_step_fused(self, state: State, g_rows, g_src_av, g_bt, g_nth,
                        g_bg_rows, g_nodes, g_node_av, g_ag_rows, v_nodes,
                        v_clab, v_ilab, v_cgraph, v_ag_rows, can_expand, u,
                        new_rows, exp_bg_rows, bt_valid, bt_pos, bt_bg_rows,
                        root_vecs, vocab_mask, beam: int
                        ) -> Tuple[State, torch.Tensor]:
        """One decode step: the atom-level refresh of the previous step's
        cluster, the frontier topology, the message update of the branch
        the device picks (expand iff sigmoid(topo) > u and the frontier can
        expand, else backtrack) and the motif top-k.  Returns the state and
        one packed [B, 2 + 3·beam] f32 array (topo logit, choice, beam
        scores, motif and attachment ids): one host sync a step."""
        self.hdec_graph_update(state, g_rows, g_src_av, g_bt, g_nth,
                               g_bg_rows, g_nodes, g_node_av, g_ag_rows)
        state, topo_logits = self.hdec_topo(state, v_nodes, v_clab, v_ilab,
                                            v_cgraph, v_ag_rows, root_vecs)
        choose = (torch.sigmoid(topo_logits) > u) & can_expand
        rows = torch.where(choose | bt_valid, new_rows, 0)
        pos = torch.where(choose, 0, bt_pos)
        bg = torch.where(choose[:, None], exp_bg_rows, bt_bg_rows)
        self.hdec_mess_update(state, rows, v_nodes, v_clab, v_ilab, v_cgraph,
                              pos, bg, bg)
        cls_scores, icls_scores = self.hdec_cls(state, rows, root_vecs)
        scores, cls_k, icls_k = hier_topk(cls_scores, icls_scores,
                                          vocab_mask, beam)
        packed = torch.cat(
            [topo_logits[:, None], choose.float()[:, None], scores,
             cls_k.float(), icls_k.float()], dim=1)
        return state, packed

    def hdec_assm(self, state: State, cand_atoms, icls_ids, n_icls, nth,
                  ctx) -> torch.Tensor:
        """Assembly scores of candidates against the current atom hiddens
        (reference enum_attach + get_assm_score): ``cand_atoms`` [..., C, 2]
        (the two anchor atoms of each candidate), ``icls_ids`` [..., 2]
        (the child's anchor attachments), ``n_icls`` and ``nth`` [...],
        ``ctx`` [..., latent]; returns [..., C].  The leading dims batch the
        queued cases of a step (JAX ``HierDecodeKernel.assm_batch``, a
        vmap)."""
        cand_h = state[3][cand_atoms.long()]                 # [..., C, 2, H]
        icls_e = self._embed[1](icls_ids)[..., None, :, :].expand(
            *cand_h.shape[:-1], -1)
        pos_e = pos_onehot(nth)[..., None, None, :].expand(
            *cand_h.shape[:-1], MAX_POS)
        mvec = F.relu(self.matchNN(torch.cat([cand_h, icls_e, pos_e], -1)))
        k_mask = torch.arange(2, device=mvec.device) < n_icls[..., None]
        cand_vecs = (mvec * k_mask[..., None, :, None]).sum(dim=-2)
        return (self.W_assm(cand_vecs) * ctx[..., None, :]).sum(-1)
