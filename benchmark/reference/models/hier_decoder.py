"""The hierarchical decoder's teacher-forced training loss in plain
PyTorch (a frozen copy of the port's ``models/hier_decoder.py:
HierDecoder`` training path, LSTM, float32, no attention).

Where the port reads host-built per-step tables and their transposes
(``data.batching.hier_train_tables``), each step here indexes the
batch's own tables by that step's rows (``agraph[gstep_nodes[t]]``,
``cgraph[src]``, ``bgraph[mess[t]]``, ...), and autograd gives every
backward.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from .decoder import PredictionMLP, cls_terms, topo_terms
from .encoder import pos_onehot
from .rnn import MPNLSTMCell


class HierDecoder(nn.Module):
    """The hier decoder's training modules (JAX ``HierDecoder``)."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 latent_size: int, atom_vocab_size: int, diterT: int = 1,
                 diterG: int = 3):
        super().__init__()
        embed_size = E_c.embedding_dim
        h = hidden_size
        self._embed = (E_c, E_i)        # the VAE's: not registered here
        self.hidden_size = h
        self.atom_vocab_size = atom_vocab_size
        self.diterT = diterT
        self.diterG = diterG
        self.tree_rnn = MPNLSTMCell(h + MAX_POS, h, diterT)
        self.inter_rnn = MPNLSTMCell(h + MAX_POS, h, diterT)
        self.graph_rnn = MPNLSTMCell(atom_vocab_size + 4 + MAX_POS, h, diterG)
        self.W_tree_node = nn.Linear(2 * h, h)
        self.W_inter_node = nn.Linear(2 * h, h)
        self.W_graph_node = nn.Linear(atom_vocab_size + h, h)
        self.W_c = nn.Linear(embed_size + h, h)
        self.W_i = nn.Linear(embed_size + h, h)
        head_in = h + latent_size
        self.topoNN = PredictionMLP(head_in, h, 1)
        self.clsNN = PredictionMLP(head_in, h, E_c.num_embeddings)
        self.iclsNN = PredictionMLP(head_in, h, E_i.num_embeddings)
        self.matchNN = nn.Linear(h + embed_size + MAX_POS, h)
        self.W_assm = nn.Linear(h, latent_size)
        if latent_size != hidden_size:
            self.W_root = nn.Linear(latent_size, h)

    def _onehot(self, av: torch.Tensor) -> torch.Tensor:
        return F.one_hot(av.long(), self.atom_vocab_size).float()

    @staticmethod
    def _update(rnn, state, rows, x, bgraph_rows, n_iter):
        """``n_iter`` cell applications to the messages ``rows`` [R] with
        inputs ``x`` and predecessor rows ``bgraph_rows`` [R, A], each
        round's rows written into a new state (JAX ``sparse_update``);
        an invalid lane (row 0) writes zeros there."""
        valid = (rows > 0)[:, None]
        xp = rnn.x_proj(x)
        ks = rnn.k_h()
        for _ in range(n_iter):
            new = rnn.step(xp, tuple(s[bgraph_rows] for s in state), ks)
            state = tuple(s.index_put((rows,), torch.where(valid, nr, 0.0))
                          for s, nr in zip(state, new))
        return state

    def forward(self, tree: Dict[str, torch.Tensor],
                graph: Dict[str, torch.Tensor], plan: Dict[str, torch.Tensor],
                root_vecs: torch.Tensor, vocab_mask: torch.Tensor):
        """(loss, metrics) of a batch with its unpacked plan (JAX
        hier_decoder.py:109-346).  Each step refreshes the atoms of the
        previous step's cluster (``diterG`` rounds over its bonds, then
        the atom readout), embeds the frontier at the attachment and motif
        levels (``diterT`` rounds each) and scores the assembly candidates
        against the current atom hiddens."""
        E_c, E_i = self._embed
        fnode, fmess = tree['fnode'], tree['fmess']
        H = self.hidden_size
        dev = root_vecs.device
        init_vecs = self.W_root(root_vecs) if hasattr(self, 'W_root') \
            else root_vecs
        ec_emb, ei_emb = E_c(fnode[:, 0]), E_i(fnode[:, 1])
        gfnode, gfmess = graph['fnode'], graph['fmess']
        g_mess_in = torch.cat([
            self._onehot(gfnode[gfmess[:, 0].long()]),
            F.one_hot(gfmess[:, 2].clamp(0, 3).long(), 4).float(),
            pos_onehot(gfmess[:, 3])], dim=-1)
        pos_tab = pos_onehot(fmess[:, 2])

        tree_s = self.tree_rnn.init_state(fmess.shape[0], init_vecs)
        zeros = torch.zeros((fmess.shape[0], H), device=dev)
        inter_s = (zeros, zeros)
        gzeros = torch.zeros((gfmess.shape[0], H), device=dev)
        graph_s = (gzeros, gzeros)
        hatom = torch.zeros((gfnode.shape[0], H), device=dev)
        hinter_node = torch.zeros((fnode.shape[0], H), device=dev)

        agraph, bgraph = tree['agraph'].long(), tree['bgraph'].long()
        cgraph = tree['cgraph'].long()
        agraph_dec = tree['agraph_dec'].long()
        bgraph_dec = tree['bgraph_dec'].long()
        g_agraph, g_bgraph = graph['agraph'].long(), graph['bgraph'].long()
        mess, xid = plan['mess'].long(), plan['xid'].long()
        T = mess.shape[0]
        gstep_mess = plan['gstep_mess'].long().reshape(T, -1)
        gstep_nodes = plan['gstep_nodes'].long().reshape(T, -1)
        cands = plan['assm_cands'].long()                 # [T, B, C, 2]
        k_mask = (torch.arange(2, device=dev) <
                  plan['assm_n_icls'][..., None])[:, :, None, :, None]
        topo_vecs, cls_vecs, cand_scores = [], [], []
        for t in range(T):
            rows, x_nodes = mess[t], xid[t]
            src = fmess[:, 0].long()[rows]
            # 1. atom level: the cluster unmasked at the previous step
            gr, gn = gstep_mess[t], gstep_nodes[t]
            graph_s = self._update(self.graph_rnn, graph_s, gr, g_mess_in[gr],
                                   g_bgraph[gr], self.diterG)
            g_node_h = F.relu(self.W_graph_node(torch.cat(
                [self._onehot(gfnode[gn]), graph_s[0][g_agraph[gn]].sum(1)],
                dim=-1)))
            hatom = hatom.index_put(
                (gn,), torch.where((gn > 0)[:, None], g_node_h, 0.0))

            # 2. attachment level
            hclu = hatom[cgraph[src]].sum(1)
            x_i = torch.cat([F.relu(self.W_i(torch.cat([ei_emb[src], hclu],
                                                       dim=-1))),
                             pos_tab[rows]], dim=-1)
            inter_s = self._update(self.inter_rnn, inter_s, rows, x_i,
                                   bgraph[rows], self.diterT)
            hclu_x = hatom[cgraph[x_nodes]].sum(1)
            inter_embed_x = F.relu(self.W_i(torch.cat([ei_emb[x_nodes],
                                                       hclu_x], dim=-1)))
            inter_node_h = F.relu(self.W_inter_node(torch.cat(
                [inter_embed_x, inter_s[0][agraph[x_nodes]].sum(1)], dim=-1)))
            hinter_node = hinter_node.index_put(
                (x_nodes,),
                torch.where((x_nodes > 0)[:, None], inter_node_h, 0.0))

            # 3. motif level
            x_t = torch.cat([F.relu(self.W_c(torch.cat(
                [ec_emb[src], hinter_node[src]], dim=-1))), pos_tab[rows]],
                dim=-1)
            tree_s = self._update(self.tree_rnn, tree_s, rows, x_t,
                                  bgraph_dec[rows], self.diterT)
            tree_embed_x = F.relu(self.W_c(torch.cat(
                [ec_emb[x_nodes], hinter_node[x_nodes]], dim=-1)))
            topo_vecs.append(F.relu(self.W_tree_node(torch.cat(
                [tree_embed_x, tree_s[0][agraph_dec[x_nodes]].sum(1)],
                dim=-1))))
            cls_vecs.append(tree_s[0][rows])

            # 4. assembly candidates: matchNN([hatom, E_i(icls), pos])
            # summed over the anchor pair (reference enum_attach)
            cand_h = hatom[cands[t]]                          # [B, C, 2, H]
            icls_e = E_i(plan['assm_icls'][t])[:, None].expand(
                *cand_h.shape[:3], -1)
            pos_e = pos_onehot(plan['assm_nth'][t])[:, None, None].expand(
                *cand_h.shape[:3], -1)
            mvec = F.relu(self.matchNN(torch.cat([cand_h, icls_e, pos_e],
                                                 dim=-1)))
            cand_vecs = (mvec * k_mask[t]).sum(2) * \
                plan['assm_cand_ok'][t][..., None]
            cand_scores.append((self.W_assm(cand_vecs) *
                                root_vecs[:, None, :]).sum(-1))
        return self._losses(plan, root_vecs, init_vecs, vocab_mask,
                            torch.stack(topo_vecs), torch.stack(cls_vecs),
                            torch.stack(cand_scores))

    def _losses(self, plan, root_vecs, init_vecs, vocab_mask, topo_vecs,
                cls_vecs, cand_scores):
        """Topology BCE, motif and attachment cross-entropies and the
        assembly cross-entropy over the real candidate slots and
        ``max_cls_size − nc`` zero-vector pad slots (score ``W_assm(0)·z``),
        summed and divided by the batch size, with the accuracies (JAX
        hier_decoder.py:262-346)."""
        B = root_vecs.shape[0]
        T = topo_vecs.shape[0]
        latent_b = root_vecs[None].expand(T, B, -1)
        topo_logits = self.topoNN(torch.cat([topo_vecs, latent_b],
                                            dim=-1))[..., 0]
        topo_loss, topo_acc = topo_terms(topo_logits, plan)
        cls_loss, icls_loss, cls_acc, icls_acc = cls_terms(
            self.clsNN, self.iclsNN, plan, init_vecs, root_vecs, cls_vecs,
            latent_b, vocab_mask)

        p_score = (self.W_assm.bias * root_vecs).sum(-1)[None, :]   # [1, B]
        ok = plan['assm_cand_ok']
        nc = plan['assm_nc'].float()
        maxc = plan['max_cls_size'].float()
        neg = torch.finfo(torch.float32).min / 4
        masked = torch.where(ok, cand_scores, neg)
        m = torch.maximum(masked.max(-1).values, p_score)
        real_sum = (torch.exp(masked - m[..., None]) * ok).sum(-1)
        lse = torch.log(real_sum + torch.clamp(maxc - nc, min=0.0) *
                        torch.exp(p_score - m) + 1e-12) + m
        gold = cand_scores[..., 0]
        has_assm = plan['has_assm'].float()
        assm_loss = ((lse - gold) * has_assm).sum()
        best = torch.maximum(masked.max(-1).values,
                             torch.where(nc >= maxc, neg, p_score))
        n_assm = has_assm.sum()
        assm_acc = torch.where(
            n_assm > 0,
            ((gold >= best) * has_assm).sum() / torch.clamp(n_assm, min=1),
            torch.ones_like(n_assm))

        loss = (topo_loss + cls_loss + icls_loss + assm_loss) / B
        return loss, {'Word': cls_acc, 'I-Word': icls_acc, 'Topo': topo_acc,
                      'Assm': assm_acc}
