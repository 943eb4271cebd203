"""Hierarchical (3-level) decoder: its parameters, the teacher-forced
training forward and the exact decode's steps (counterpart of
``ggpm_tpu/models/hier_decoder.py``: ``HierDecoder``'s modules and
``__call__`` with its losses, ``_sparse_direct``, ``hdec_init``,
``hdec_graph_update``, ``hdec_topo``, ``hdec_mess_update``, ``hdec_cls``,
``hdec_step_fused`` and ``hdec_assm``), and the turbo decode's propose
loop (``hdec_propose``: ``_sparse_local``, ``_graft_rows_vec``,
``propose_carry``, ``propose_init_``, ``propose_step_``).

Training: ``forward`` runs the scan step by step, each state written out
of place for autograd; its five sums a step go through ``nei_sum_t`` and
its message updates' neighbour gathers through ``gather_nd_t``, each with
the step's own table and transpose (``data.batching.hier_train_tables``),
so their backward is the kernels' transpose.

The decode state is ``(tree, inter, graph, hatom, hinter_node)``: the tree
and attachment levels' message states (the cell's tuple, ``(h,)`` or
``(h, c)``) over the junction tree's edge rows, the atom level's over the
molecule's bond rows, and the atom and attachment node hiddens.  Every buffer keeps row 0 at zero: the host loop
(``models/decode.py:decode_hier``) pads its index tables with 0, and the
steps write only zeros there.  The steps update the state in place and
return it.

The frontier gather-sums of a step (the atom readout over ``agraph``, the
cluster sums over ``cgraph`` and the attachment and tree readouts over the
frontier's incoming messages) go through the ``nei_sum`` kernel: five
launches a fused step.

The propose loop runs the whole decode on the device, its tree, assembly
oracle and atom-level row bookkeeping included, one ``propose_step_`` at a
time on a carry of preallocated tensors that it updates in place, so that
a step can be captured in a CUDA graph (``models/decode.py:HierProposer``).
Its four frontier sums go through ``nei_sum``: four launches a step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from ..ops import gather_nd_t, nei_sum, nei_sum_t
from .decode import HIER_CAND_CAP, hier_topk
from .decoder import (PredictionMLP, _ce, attend, carry_state, drop_put_,
                      put_rows, scatter_rows_, scope_mask, state_carry)
from .encoder import dropout, own_embeddings, pos_onehot
from .rnn import make_cell

Level = Tuple[torch.Tensor, ...]
State = Tuple[Level, Level, Level, torch.Tensor, torch.Tensor]


class HierDecoder(nn.Module):
    """The JAX ``HierDecoder``.  Tied (``tie_embedding``), the motif and
    attachment embeddings are owned by the VAE and shared with the
    encoder, so the decoder holds them without registering them; untied
    (``owned``), they are its own ``E_c_mod`` and ``E_i_mod``.  With
    ``use_attention`` the training heads take their context from the
    encoder's memories through ``A_topo``, ``A_cls`` (the motif level's)
    and ``A_assm`` (the atom level's; JAX hier_decoder.py:79-86); the
    decode steps have no attention (JAX refuses to decode such a model)."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 latent_size: int, atom_vocab_size: int, diterT: int = 1,
                 diterG: int = 3, dropout_rate: float = 0.0,
                 use_attention: bool = False, rnn_type: str = 'LSTM',
                 owned: bool = False):
        super().__init__()
        embed_size = E_c.embedding_dim
        h = hidden_size
        own_embeddings(self, E_c, E_i, owned)
        self.hidden_size = h
        self.latent_size = latent_size
        self.atom_vocab_size = atom_vocab_size
        self.diterT = diterT
        self.diterG = diterG
        self.drop = dropout(dropout_rate)
        # three incremental levels (reference IncHierMPNEncoder)
        self.tree_rnn = make_cell(rnn_type, h + MAX_POS, h, diterT)
        self.inter_rnn = make_cell(rnn_type, h + MAX_POS, h, diterT)
        self.graph_rnn = make_cell(rnn_type, atom_vocab_size + 4 + MAX_POS, h,
                                   diterG)
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
        self.use_attention = use_attention
        if use_attention:
            self.A_topo = nn.Linear(h, latent_size)
            self.A_cls = nn.Linear(h, latent_size)
            self.A_assm = nn.Linear(h, latent_size)

    def root_vecs_to_hidden(self, root_vecs: torch.Tensor) -> torch.Tensor:
        if hasattr(self, 'W_root'):
            return self.W_root(root_vecs)
        return root_vecs

    def _atom_onehot(self, av: torch.Tensor) -> torch.Tensor:
        return F.one_hot(av.long(), self.atom_vocab_size).float()

    def _sparse_direct(self, rnn, state: Level,
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

    # -- teacher-forced training loss (JAX hier_decoder.py:109-346) --------
    @staticmethod
    def _sparse_update(rnn, weights, state: Level,
                       rows: torch.Tensor, x: torch.Tensor, tables,
                       n_iter: int) -> Level:
        """``_sparse_direct`` out of place (JAX ``sparse_update``), for
        autograd: ``n_iter`` cell applications to ``rows`` with inputs
        ``x``, each round's rows written into a new state, invalid lanes
        writing zeros to row 0; ``weights`` the cell's ``(x_weights,
        k_h())``, taken once a scan.  The neighbour rows are gathered by
        ``gather_nd_t`` over ``tables = (bg_rows, t_idx, t_mask)``, the
        step's predecessor-row table and its transpose, so the gather's
        backward is the kernel's transpose, which leaves row 0 out: plain
        indexing's backward sorts the indices, and the many padding lanes
        reading row 0 serialise it."""
        valid = (rows > 0)[:, None]
        xw, ks = weights
        xp = rnn.x_proj(x, xw)
        for _ in range(n_iter):
            new = rnn.step(xp, tuple(gather_nd_t(s, *tables) for s in state),
                           ks)
            state = tuple(put_rows(s, rows, torch.where(valid, nr, 0.0))
                          for s, nr in zip(state, new))
        return state

    def forward(self, tree: Dict[str, torch.Tensor],
                graph: Dict[str, torch.Tensor], plan: Dict[str, torch.Tensor],
                root_vecs: torch.Tensor, vocab_mask: torch.Tensor,
                src_tree_mem: Optional[torch.Tensor] = None,
                src_graph_mem: Optional[torch.Tensor] = None):
        """(loss, metrics) of a batch whose ``plan`` carries the scan's
        per-step tables and transposes (``data.batching.hier_train_tables``).
        ``src_tree_mem`` / ``src_graph_mem`` (the encoder's motif- and
        atom-level memories) turn the attention heads on for a decoder
        built with them: topo and cls attend over the motif level, each
        assembly candidate's score over the atom level, inside the scan
        step (JAX hier_decoder.py:239-250).

        The scan carries the three levels' message states and the atom and
        attachment node hiddens, each written out of place as JAX's
        ``.at[rows].set`` writes them, row 0 only with zeros.  Each step
        refreshes the atoms of the previous step's cluster (``diterG``
        rounds over its bonds, then the atom readout), embeds the frontier
        at the attachment and motif levels (``diterT`` rounds each) and
        scores the assembly candidates against the current atom hiddens.
        Its five sums read the step's own state through ``nei_sum_t`` with
        the step's table, whose backward is the kernel's transpose, as is
        that of its message updates' gathers: the tables leave row 0 out,
        which is exact here because every state's row 0 is a constant zero
        (zeros at the start, zeros written)."""
        E_c, E_i = self._embed
        fnode, fmess = tree['fnode'], tree['fmess']
        num_mess = fmess.shape[0]
        H = self.hidden_size
        att = self.use_attention and src_tree_mem is not None
        masks = None
        if att:
            masks = (scope_mask(tree['scope'], src_tree_mem.shape[0]),
                     scope_mask(graph['scope'], src_graph_mem.shape[0]))

        init_vecs = self.root_vecs_to_hidden(root_vecs)
        ec_emb = self.drop(E_c(fnode[:, 0]))
        ei_emb = self.drop(E_i(fnode[:, 1]))
        gfnode, gfmess = graph['fnode'], graph['fmess']
        g_mess_in = self._g_mess_input(gfnode[gfmess[:, 0].long()],
                                       gfmess[:, 2], gfmess[:, 3])
        pos_tab = pos_onehot(fmess[:, 2])

        dev = root_vecs.device
        tree_s = self.tree_rnn.init_state(num_mess, init_rows=init_vecs)
        inter_s = self.inter_rnn.init_state(num_mess, dev)
        graph_s = self.graph_rnn.init_state(gfmess.shape[0], dev)
        hatom = torch.zeros((gfnode.shape[0], H), device=dev)
        hinter_node = torch.zeros((fnode.shape[0], H), device=dev)

        def site(name, t):
            return tuple(plan[name + sfx][t] for sfx in ('', '_t', '_tm'))

        # each step's inputs that the state does not change, for all T
        # steps at once (``unbind`` where they need a gradient: its
        # backward stacks the steps' gradients in one op): its messages'
        # and nodes' embeddings, positions and atom features, the
        # candidates' attachment embeddings (no dropout, JAX :229) and
        # anchor masks, and the cells' weights
        mess, xid = plan['mess'].long(), plan['xid'].long()
        T = mess.shape[0]
        src_all = fmess[:, 0].long()[mess]
        ec_src, ei_src, ec_x, ei_x = (
            emb[idx].unbind(0) for emb, idx in ((ec_emb, src_all),
                                                 (ei_emb, src_all),
                                                 (ec_emb, xid), (ei_emb, xid)))
        pos_rows = pos_tab[mess]
        gstep_mess = plan['gstep_mess'].long().reshape(T, -1)
        gstep_nodes = plan['gstep_nodes'].long().reshape(T, -1)
        g_x = g_mess_in[gstep_mess]
        g_node_oh = self._atom_onehot(gfnode[gstep_nodes])
        cands = plan['assm_cands'].long()
        icls_e = E_i(plan['assm_icls']).unbind(0)
        pos_e = pos_onehot(plan['assm_nth'])[:, :, None, None].expand(
            *cands.shape[:4], -1)
        k_mask = (torch.arange(2, device=dev) <
                  plan['assm_n_icls'][..., None])[:, :, None, :, None]
        cand_ok = plan['assm_cand_ok'][..., None]
        w_graph, w_inter, w_tree = (
            (rnn.x_weights(n_in), rnn.k_h()) for rnn, n_in in (
                (self.graph_rnn, g_mess_in.shape[-1]),
                (self.inter_rnn, H + MAX_POS), (self.tree_rnn, H + MAX_POS)))
        topo_vecs, cls_vecs, cand_scores = [], [], []
        for t in range(T):
            rows, x_nodes, src = mess[t], xid[t], src_all[t]
            # 1. atom level: the cluster unmasked at the previous step
            gr, gn = gstep_mess[t], gstep_nodes[t]
            graph_s = self._sparse_update(
                self.graph_rnn, w_graph, graph_s, gr, g_x[t],
                site('u_atom', t), self.diterG)
            g_node_h = F.relu(self.W_graph_node(torch.cat(
                [g_node_oh[t], nei_sum_t(graph_s[0], *site('s_atom', t))],
                dim=-1)))
            hatom = put_rows(hatom, gn,
                             torch.where((gn > 0)[:, None], g_node_h, 0.0))

            # 2. attachment level
            hclu = nei_sum_t(hatom, *site('s_clu_src', t))
            x_i = torch.cat([F.relu(self.W_i(torch.cat([ei_src[t], hclu],
                                                       dim=-1))),
                             pos_rows[t]], dim=-1)
            inter_s = self._sparse_update(
                self.inter_rnn, w_inter, inter_s, rows, x_i,
                site('u_inter', t), self.diterT)
            hclu_x = nei_sum_t(hatom, *site('s_clu_x', t))
            inter_embed_x = F.relu(self.W_i(torch.cat([ei_x[t], hclu_x],
                                                      dim=-1)))
            inter_node_h = F.relu(self.W_inter_node(torch.cat(
                [inter_embed_x, nei_sum_t(inter_s[0], *site('s_inter', t))],
                dim=-1)))
            hinter_node = put_rows(
                hinter_node, x_nodes,
                torch.where((x_nodes > 0)[:, None], inter_node_h, 0.0))

            # 3. motif level
            x_t = torch.cat([F.relu(self.W_c(torch.cat(
                [ec_src[t], hinter_node[src]], dim=-1))), pos_rows[t]],
                dim=-1)
            tree_s = self._sparse_update(
                self.tree_rnn, w_tree, tree_s, rows, x_t,
                site('u_tree', t), self.diterT)
            tree_embed_x = F.relu(self.W_c(torch.cat(
                [ec_x[t], hinter_node[x_nodes]], dim=-1)))
            topo_vecs.append(F.relu(self.W_tree_node(torch.cat(
                [tree_embed_x, nei_sum_t(tree_s[0], *site('s_tree', t))],
                dim=-1))))
            cls_vecs.append(tree_s[0][rows])

            # 4. assembly candidates: matchNN([hatom, E_i(icls), pos])
            # summed over the anchor pair (reference enum_attach)
            cand_h = hatom[cands[t]]                          # [B, C, 2, H]
            mvec = F.relu(self.matchNN(torch.cat(
                [cand_h, icls_e[t][:, None].expand(*cand_h.shape[:3], -1),
                 pos_e[t]], dim=-1)))
            cand_vecs = (mvec * k_mask[t]).sum(2) * cand_ok[t]
            # per candidate, the atom-level memory of its molecule
            assm_ctx = (attend(src_graph_mem, masks[1][:, None, :],
                               cand_vecs, self.A_assm) if att
                        else root_vecs[:, None, :])
            cand_scores.append((self.W_assm(cand_vecs) * assm_ctx).sum(-1))
        return self._losses(plan, root_vecs, init_vecs, vocab_mask,
                            torch.stack(topo_vecs), torch.stack(cls_vecs),
                            torch.stack(cand_scores),
                            (src_tree_mem, src_graph_mem) if att else None,
                            masks)

    def _losses(self, plan, root_vecs, init_vecs, vocab_mask, topo_vecs,
                cls_vecs, cand_scores, mems=None, masks=None):
        """Topology BCE, motif and attachment cross-entropies (the
        attachment logits masked by the additive vocab mask) and the
        assembly cross-entropy over the real candidate slots and
        ``max_cls_size − nc`` zero-vector pad slots (score ``W_assm(0)·z``),
        summed and divided by the batch size, with the accuracies (JAX
        hier_decoder.py:262-346).  With the memories ``mems`` and their
        scope ``masks``, the heads' contexts are attention contexts, the
        pad slots' a zero query's over the atom level.  Nothing is read on
        the host."""
        batch_size = root_vecs.shape[0]
        T = topo_vecs.shape[0]
        latent_b = root_vecs[None].expand(T, batch_size, -1)
        active = plan['active']
        if mems is not None:
            (tree_mem, graph_mem), (tmask, gmask) = mems, masks
            topo_ctx = attend(tree_mem, tmask, topo_vecs, self.A_topo)
            root_cls_ctx = attend(tree_mem, tmask, init_vecs, self.A_cls)
            step_cls_ctx = attend(tree_mem, tmask, cls_vecs, self.A_cls)
            pad_ctx = attend(graph_mem, gmask, root_vecs.new_zeros(
                (batch_size, self.hidden_size)), self.A_assm)
        else:
            topo_ctx, root_cls_ctx, step_cls_ctx, pad_ctx = \
                latent_b, root_vecs, latent_b, root_vecs

        topo_logits = self.topoNN(torch.cat([topo_vecs, topo_ctx],
                                            dim=-1))[..., 0]
        tlab = plan['tlab'].float()
        topo_bce = torch.clamp(topo_logits, min=0) - topo_logits * tlab + \
            torch.log1p(torch.exp(-torch.abs(topo_logits)))
        topo_loss = (topo_bce * active.float()).sum()
        topo_acc = (((topo_logits >= 0).long() == plan['tlab'].long())
                    * active).sum() / torch.clamp(active.sum(), min=1)

        def heads(vec, ctx):
            x = torch.cat([vec, ctx], dim=-1)
            return self.clsNN(x), self.iclsNN(x)

        root_clab, root_ilab = plan['root_clab'].long(), plan['root_ilab'].long()
        clab, ilab = plan['clab'].long(), plan['ilab'].long()
        root_cls, root_icls = heads(init_vecs, root_cls_ctx)
        step_cls, step_icls = heads(cls_vecs, step_cls_ctx)
        root_icls = root_icls + vocab_mask[root_clab]
        step_icls = step_icls + vocab_mask[clab]
        has_cls = plan['has_cls'].float()
        cls_loss = _ce(root_cls, root_clab).sum() + \
            (_ce(step_cls, clab) * has_cls).sum()
        icls_loss = _ce(root_icls, root_ilab).sum() + \
            (_ce(step_icls, ilab) * has_cls).sum()
        n_cls = batch_size + has_cls.sum()
        cls_acc = ((root_cls.argmax(-1) == root_clab).sum() +
                   ((step_cls.argmax(-1) == clab) * has_cls).sum()) / n_cls
        icls_acc = ((root_icls.argmax(-1) == root_ilab).sum() +
                    ((step_icls.argmax(-1) == ilab) * has_cls).sum()) / n_cls

        p_score = (self.W_assm.bias * pad_ctx).sum(-1)[None, :]     # [1, B]
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

        loss = (topo_loss + cls_loss + icls_loss + assm_loss) / batch_size
        return loss, {'Word': cls_acc, 'I-Word': icls_acc, 'Topo': topo_acc,
                      'Assm': assm_acc}

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

    # -- device-resident decode: the propose loop (JAX hier_decoder.py:378,
    # 699, 916) ------------------------------------------------------------
    # The JAX package runs the loop as one ``lax.while_loop``; here its
    # carry is a dict of preallocated tensors that ``propose_init_`` resets
    # and ``propose_step_`` advances in place, as the motif decoder's
    # (``MotifDecoder.propose_step_``).  A step makes no host sync.  JAX's
    # ``mode='drop'`` scatters write to a sink past each flat table instead
    # (``drop_put_``): one row more than ``1 + B·A`` atoms, ``1 + B·Eg``
    # bond rows, and one element past the cluster-row lists.

    def _sparse_local(self, rnn, state: Level,
                      rows: torch.Tensor, x: torch.Tensor,
                      bg_rows: torch.Tensor, n_iter: int) -> Level:
        """``_sparse_direct`` with the full-state traffic out of the
        iteration loop, bit for bit (JAX hier_decoder.py:378-411): only
        ``rows`` change across the rounds, so the neighbours outside them
        are gathered once, the rounds update a local [R, H] buffer, and the
        state is written once at the end.  A neighbour is in ``rows`` when
        its id round-trips through ``loc_of``; padding lanes (row 0) go to
        ``loc_of``'s sink, so row 0 is never a member."""
        valid = (rows > 0)[:, None]
        rows = rows.long()
        bg = bg_rows.long()
        n_all = state[0].shape[0]
        loc_of = torch.zeros(n_all + 1, dtype=torch.long, device=rows.device)
        drop_put_(loc_of, torch.where(rows > 0, rows, n_all),
                  torch.arange(rows.shape[0], device=rows.device), n_all)
        lbg = loc_of[bg]                                   # [R, NB]
        member = ((rows[lbg] == bg) & (bg > 0))[..., None]
        nei_out = tuple(torch.where(member, 0.0, s[bg]) for s in state)
        local = tuple(s[rows] for s in state)
        xp = rnn.x_proj(x)
        ks = rnn.k_h()
        for _ in range(n_iter):
            nei = tuple(torch.where(member, lo[lbg], out)
                        for lo, out in zip(local, nei_out))
            new = rnn.step(xp, nei, ks)
            local = tuple(torch.where(valid, nr, lo)
                          for lo, nr in zip(local, new))
        for s, lo in zip(state, local):
            scatter_rows_(s, rows, torch.where(valid, lo, 0.0))
        return state

    @staticmethod
    def _graft_rows_vec(tabs: Dict[str, torch.Tensor],
                        cy: Dict[str, torch.Tensor], b_of: torch.Tensor,
                        new_ilab: torch.Tensor, ch_atom_f: torch.Tensor,
                        do_c: torch.Tensor, nth_edge: torch.Tensor,
                        skip_anchor: torch.Tensor,
                        nn_flat: torch.Tensor) -> None:
        """One graft's atom-level row bookkeeping in closed form, in place
        on the carry ``cy`` (JAX hier_decoder.py:699-915, the loop-free
        ``IncGraph.add_mol`` bond loop; docs/TURBO_DECODE.md states its
        invariant): two directed bond rows per new motif bond (their source
        atom, bond type and position, ``e_av``/``e_bt``/``e_nth``), each
        row's predecessor list ``e_bg`` (the source atom's in-rows in
        creation order, its own reverse left out), the new rows appended to
        the existing out-rows of their destination, the atoms' in/out lists
        and counts, the bond-row count, and the new node's cluster-row list
        ``clist``/``ccnt`` (an existing anchor bond's rows reused).

        ``b_of`` [B] each sample's bond-row offset; ``ch_atom_f`` [B, S]
        the child's slots' flat atom ids (0 where not grafted); ``do_c``
        [B] the samples that graft; ``nth_edge`` [B] the position the new
        rows carry at attached atoms; ``skip_anchor`` [B] the anchor pair's
        bond exists in the parent; ``nn_flat`` [B] the new node.  Every
        write of a masked lane goes to a sink (``drop_put_``)."""
        B = do_c.shape[0]
        ar = cy['ar']
        e_av, e_bt, e_nth, e_bg = cy['e_av'], cy['e_bt'], cy['e_nth'], \
            cy['e_bg']
        in_g, in_cnt, out_g, out_dst, out_cnt = cy['in_g'], cy['in_cnt'], \
            cy['out_g'], cy['out_dst'], cy['out_cnt']
        clist, ccnt, edge_cnt = cy['clist'], cy['ccnt'], cy['edge_cnt']
        NBG = in_g.shape[1]
        NA = in_g.shape[0] - 1                      # the sink atom row
        NE = e_av.shape[0] - 1                      # the sink bond row
        n_nodes, KE = ccnt.shape[1], clist.shape[0] // (B * ccnt.shape[1])
        nbond = tabs['nbond'][new_ilab].long()
        bonds = tabs['bondpack'][new_ilab].long()             # [B, BMAX, 4]
        d_att = tabs['dst_att'][new_ilab]                     # [B, S]
        BMAX, S = bonds.shape[1], d_att.shape[1]
        dev = do_c.device
        kk = torch.arange(BMAX, device=dev)[None, :]
        sidx = torch.arange(S, device=dev)

        a_s, b_s, bt = bonds[..., 0], bonds[..., 1], bonds[..., 2]
        anch = bonds[..., 3].bool() & skip_anchor[:, None]
        on = do_c[:, None] & (kk < nbond[:, None])            # [B, BMAX]
        add = on & ~anch
        u = torch.gather(ch_atom_f, 1, a_s)                   # [B, BMAX]
        w = torch.gather(ch_atom_f, 1, b_s)

        # bond row ids: e1_k = 1 + b_of + edge_cnt + 2·(add bonds before k)
        add_i = add.long()
        e_off = 2 * (torch.cumsum(add_i, dim=1) - add_i)
        e1 = 1 + b_of[:, None] + edge_cnt[:, None] + e_off
        e2 = e1 + 1

        # ---- reads before the graft (everything below writes) -----------
        c0_in = in_cnt[ch_atom_f]                             # [B, S]
        c0_out = out_cnt[ch_atom_f]
        pre_out_rows = out_g[ch_atom_f]                       # [B, S, NBG]
        pre_out_dst = out_dst[ch_atom_f]
        pre_in = in_g[ch_atom_f].long()
        av_u, av_w = cy['a_av'][u], cy['a_av'][w]

        # each slot's incident new bonds and their exclusive ranks
        inc_a = (a_s[:, None, :] == sidx[None, :, None]) & add[:, None, :]
        inc_b = (b_s[:, None, :] == sidx[None, :, None]) & add[:, None, :]
        incid = inc_a | inc_b                                 # [B, S, BMAX]
        inc_i = incid.long()
        rank = torch.cumsum(inc_i, dim=2) - inc_i
        cnt_s = inc_i.sum(dim=2)                              # [B, S]
        # per (slot, rank): the new in-row (bond j gives e2_j to a_j's atom,
        # e1_j to b_j's) and the bond's other endpoint
        contrib = torch.where(inc_a, e2[:, None, :],
                              torch.where(inc_b, e1[:, None, :], 0))
        oth = torch.where(inc_a, w[:, None, :],
                          torch.where(inc_b, u[:, None, :], 0))
        bsn = (ar[:, None, None] * S + sidx[None, :, None]) * NBG
        n_lin = B * S * NBG
        lin_r = torch.where(incid, bsn + rank.clamp(max=NBG - 1), n_lin)
        nl = torch.zeros(n_lin + 1, dtype=torch.long, device=dev)
        drop_put_(nl, lin_r, contrib, n_lin)
        nl = nl[:n_lin].view(B, S, NBG)
        ol = torch.zeros(n_lin + 1, dtype=torch.long, device=dev)
        drop_put_(ol, lin_r, oth, n_lin)
        ol = ol[:n_lin].view(B, S, NBG)

        # per-bond views of the per-slot quantities
        def take_s(x, s):
            if x.dim() == 3:
                return torch.gather(x, 1, s[:, :, None].expand(
                    -1, -1, x.shape[2]))
            return torch.gather(x, 1, s)
        rank_t = rank.transpose(1, 2)
        rank_u = torch.gather(rank_t, 2, a_s[:, :, None])[..., 0]
        rank_w = torch.gather(rank_t, 2, b_s[:, :, None])[..., 0]
        c0_u, c0_w = take_s(c0_in, a_s), take_s(c0_in, b_s)
        cnt_u, cnt_w = take_s(cnt_s, a_s), take_s(cnt_s, b_s)

        # ---- the new rows' content --------------------------------------
        t12 = torch.cat([torch.where(add, e1, NE).reshape(-1),
                         torch.where(add, e2, NE).reshape(-1)])
        drop_put_(e_av, t12, torch.cat([av_u.reshape(-1), av_w.reshape(-1)]),
                  NE)
        drop_put_(e_bt, t12, torch.cat([bt.reshape(-1), bt.reshape(-1)]), NE)
        nthv = nth_edge[:, None]
        drop_put_(e_nth, t12, torch.cat(
            [torch.where(take_s(d_att, b_s), nthv, 0).reshape(-1),
             torch.where(take_s(d_att, a_s), nthv, 0).reshape(-1)]), NE)

        # ---- the new rows' predecessor lists (closed form) ---------------
        m = torch.arange(NBG, device=dev)[None, None, :]

        def row_view(pre, c0, nlx, cnt, rk):
            # slot m: the atom's rows below c0, then its new in-rows in bond
            # order with this bond's own reverse left out
            idx = m - c0[:, :, None]
            idx_adj = idx + (idx >= rk[:, :, None]).long()
            new_v = torch.gather(nlx, 2, idx_adj.clamp(0, NBG - 1))
            new_ok = (idx >= 0) & (idx < cnt[:, :, None] - 1)
            return torch.where(idx < 0, pre, torch.where(new_ok, new_v, 0))
        row1 = row_view(take_s(pre_in, a_s), c0_u, take_s(nl, a_s), cnt_u,
                        rank_u)                               # e1 = u→w
        row2 = row_view(take_s(pre_in, b_s), c0_w, take_s(nl, b_s), cnt_w,
                        rank_w)                               # e2 = w→u
        drop_put_(e_bg, t12, torch.cat([row1.reshape(-1, NBG),
                                        row2.reshape(-1, NBG)]), NE)

        # ---- appends into existing rows: slot s's r-th new in-row lands in
        # every existing out-row of s but the one to that bond's other end,
        # at slot c0_in(s) - 1 + r, that row's fill level
        rr = torch.arange(NBG, device=dev)
        r_ok = rr[None, None, :] < cnt_s[:, :, None]          # [B, S, R]
        ret_mask = (pre_out_rows > 0)[..., None] & r_ok[:, :, None, :] & \
            (pre_out_dst[..., None] != ol[:, :, None, :])
        ret_slot = (c0_in[:, :, None, None] - 1 +
                    rr[None, None, None, :]).clamp(0, NBG - 1)
        ret_lin = torch.where(ret_mask, pre_out_rows[..., None] * NBG +
                              ret_slot, NE * NBG)
        drop_put_(e_bg.view(-1), ret_lin,
                  nl[:, :, None, :].expand(ret_lin.shape), NE * NBG)

        # ---- in/out list appends and counts -----------------------------
        slot_in_w = (c0_w + rank_w).clamp(0, NBG - 1)
        slot_in_u = (c0_u + rank_u).clamp(0, NBG - 1)
        slot_out_u = (take_s(c0_out, a_s) + rank_u).clamp(0, NBG - 1)
        slot_out_w = (take_s(c0_out, b_s) + rank_w).clamp(0, NBG - 1)
        tu = torch.where(add, u, NA).reshape(-1)
        tw = torch.where(add, w, NA).reshape(-1)
        e12 = torch.cat([e1.reshape(-1), e2.reshape(-1)])
        lin_in = torch.cat([tw, tu]) * NBG + torch.cat(
            [slot_in_w.reshape(-1), slot_in_u.reshape(-1)])
        drop_put_(in_g.view(-1), lin_in, e12, NA * NBG)
        lin_out = torch.cat([tu, tw]) * NBG + torch.cat(
            [slot_out_u.reshape(-1), slot_out_w.reshape(-1)])
        drop_put_(out_g.view(-1), lin_out, e12, NA * NBG)
        drop_put_(out_dst.view(-1), lin_out,
                  torch.cat([w.reshape(-1), u.reshape(-1)]), NA * NBG)
        ch_t = torch.where(cnt_s > 0, ch_atom_f, NA).reshape(-1)
        in_cnt.scatter_add_(0, ch_t, cnt_s.reshape(-1))    # integers: exact
        out_cnt.scatter_add_(0, ch_t, cnt_s.reshape(-1))

        # ---- the new node's cluster rows: an existing anchor bond's rows
        # are found in its endpoints' out-lists from before the graft
        def reused(po, pd, other):
            hit = (pd == other[:, :, None]) & (po > 0)
            return (po * hit).amax(dim=-1)
        r1 = reused(take_s(pre_out_rows, a_s), take_s(pre_out_dst, a_s), w)
        r2 = reused(take_s(pre_out_rows, b_s), take_s(pre_out_dst, b_s), u)
        reuse = on & anch
        c1 = torch.where(add, e1, torch.where(reuse, r1, 0))
        c2 = torch.where(add, e2, torch.where(reuse, r2, 0))
        on_i = on.long()
        sl = (ccnt[ar, nn_flat][:, None] + 2 * (torch.cumsum(on_i, dim=1) -
                                                 on_i)).clamp(0, KE - 2)
        cl_base = (ar[:, None] * n_nodes + nn_flat[:, None]) * KE
        cl_oob = B * n_nodes * KE
        drop_put_(clist, torch.where(on, cl_base + sl, cl_oob), c1, cl_oob)
        drop_put_(clist, torch.where(on, cl_base + sl + 1, cl_oob), c2,
                  cl_oob)
        ccnt[ar, nn_flat] += 2 * on_i.sum(dim=1)
        edge_cnt += 2 * add_i.sum(dim=1)

    def propose_carry(self, batch_size: int, T: int, S: int, A: int,
                      Eg: int, NBG: int, KE: int, max_nb: int, device
                      ) -> Dict[str, torch.Tensor]:
        """Zero carry of the propose loop for ``batch_size`` samples, a
        ``T``-step budget, ``S``-slot motifs, and the per-sample budgets
        ``A`` atoms, ``Eg`` bond rows, ``NBG`` in-rows an atom and ``KE``
        cluster rows a node (JAX hier_decoder.py:947-1003): the tree and
        attachment states over ``1 + B·(T+1)`` rows, the atom level's over
        ``1 + B·Eg``, the atom hiddens over ``1 + B·A`` and the attachment
        node hiddens over ``1 + B·(T+2)``; the motif oracle's per-node
        tables over ``T + 2`` nodes; the atom and bond-row bookkeeping,
        each flat table with its sink; the step counter ``t``."""
        B, n, H = batch_size, T + 2, self.hidden_size
        NA, NE = 1 + B * A, 1 + B * Eg

        def z(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)
        ar = torch.arange(B, device=device)
        return dict(
            **state_carry('tree_', self.tree_rnn.init_state(1 + B * (T + 1),
                                                            device)),
            **state_carry('inter_', self.inter_rnn.init_state(
                1 + B * (T + 1), device)),
            **state_carry('graph_', self.graph_rnn.init_state(NE, device)),
            hatom=torch.zeros((NA, H), device=device),
            hinter=torch.zeros((1 + B * n, H), device=device),
            clab=z(B, n), ilab=z(B, n), slot_used=z(B, n, S, dtype=torch.bool),
            atom_fv=z(B, A + 1), slot_atom=z(B, n, S), atom_cnt=z(B),
            node_as2=z(B, n, dtype=torch.bool), in_deg=z(B, n),
            agraph=z(B, n, max_nb, dtype=torch.int32), down_row=z(B, n),
            stack=z(B, n), sp=z(B), nxt=z(B),
            poisoned=z(B, dtype=torch.bool),
            a_av=z(NA), e_av=z(NE + 1), e_bt=z(NE + 1), e_nth=z(NE + 1),
            e_bg=z(NE + 1, NBG), in_g=z(NA + 1, NBG, dtype=torch.int32),
            in_cnt=z(NA + 1), out_g=z(NA + 1, NBG), out_dst=z(NA + 1, NBG),
            out_cnt=z(NA + 1), edge_cnt=z(B), clist=z(B * n * KE + 1),
            ccnt=z(B, n), t=z(1), n_run=z(1), root_cls=z(B), root_icls=z(B),
            ar=ar, sidx=torch.arange(S, device=device),
            base=1 + ar * (T + 1), b_of_a=ar * A, b_of_e=ar * Eg)

    def propose_init_(self, carry: Dict[str, torch.Tensor],
                      root_vecs: torch.Tensor, vocab_mask: torch.Tensor,
                      tabs: Dict[str, torch.Tensor]) -> None:
        """Reset ``carry`` to the loop's start for latents ``root_vecs``
        (JAX hier_decoder.py:953-1025): the latent wired into each sample's
        first tree row, the root motif (argmax motif, masked argmax
        attachment) with its oracle state, and the root's graft, which a
        root that does not fit the budgets skips, poisoning its sample."""
        cy = carry
        for k, x in cy.items():
            if k not in ('ar', 'sidx', 'base', 'b_of_a', 'b_of_e'):
                x.zero_()
        S = cy['sidx'].shape[0]
        A = cy['atom_fv'].shape[1] - 1
        Eg = (cy['e_av'].shape[0] - 2) // root_vecs.shape[0]
        sidx, base = cy['sidx'], cy['base']
        init = self.root_vecs_to_hidden(root_vecs)
        cy['tree_h'][base] = init
        cls_l, icls_l = self.hdec_root_cls(root_vecs)
        root_cls = torch.argmax(cls_l, dim=-1)
        root_icls = torch.argmax(icls_l + vocab_mask[root_cls], dim=-1)
        cy['root_cls'].copy_(root_cls)
        cy['root_icls'].copy_(root_icls)
        cy['clab'][:, 0] = root_cls
        cy['ilab'][:, 0] = root_icls
        cy['slot_used'][:, 0] = tabs['bused'][root_icls]
        cy['atom_fv'][:, :S] = tabs['bfv'][root_icls]
        cy['slot_atom'][:, 0] = sidx
        cy['atom_cnt'].copy_(tabs['n_at'][root_icls])
        cy['in_deg'][:, 0] = 1
        cy['agraph'][:, 0, 0] = base.int()
        cy['down_row'][:, 0] = base
        cy['sp'].fill_(1)
        cy['nxt'].fill_(1)
        # the root's graft: add_mol(root, [], 0), every bond new
        root_n = tabs['n_at'][root_icls].long()
        root_fits = (2 * tabs['nbond'][root_icls] <= Eg) & (root_n <= A)
        cy['poisoned'].copy_(tabs['poison'][root_icls] |
                             tabs['noop'][root_icls] | ~root_fits)
        root_valid = (sidx[None, :] < root_n[:, None]) & root_fits[:, None]
        root_atom_f = torch.where(root_valid, 1 + cy['b_of_a'][:, None] +
                                  sidx[None, :], 0)
        scatter_rows_(cy['a_av'], root_atom_f.reshape(-1), torch.where(
            root_valid, tabs['av'][root_icls], 0).reshape(-1).long())
        zeros = torch.zeros_like(root_cls)
        self._graft_rows_vec(tabs, cy, cy['b_of_e'], root_icls, root_atom_f,
                             root_fits, zeros, zeros.bool(), zeros)

    def propose_step_(self, carry: Dict[str, torch.Tensor],
                      root_vecs: torch.Tensor, vocab_mask: torch.Tensor,
                      tabs: Dict[str, torch.Tensor], trace: torch.Tensor,
                      beam: int, max_nb: int = 12) -> None:
        """One step of the propose loop (JAX hier_decoder.py:1029-1412), in
        place: (1) the atom-level refresh of the frontier cluster and its
        atoms' hiddens, (2) the frontier readout at the three levels and
        the topology choice, (3) the message update and the joint top-k,
        (4) the assembly candidates of each beam (the parent cluster's slot
        runs, typed and valence-checked by the oracle), scored against the
        live atom hiddens, the first beam with a feasible one and its best
        candidate, then the tree and oracle bookkeeping, the budget guard
        (a graft that would outrun a budget poisons its sample) and the
        graft's rows.  Writes the packed row [B, 9 + 3·beam] (the exact
        step's columns, the committed beam, the committed attachment, the
        candidate's kind and slot, and the committed beam's three
        feasibility bit masks) into ``trace[t]``: zeros once no sample is
        active, as the JAX loop's early exit leaves them.  The caller runs
        it for ``t < T`` only.  Its four frontier sums are ``nei_sum``
        launches."""
        cy = carry
        E_c, E_i = self._embed
        ar, sidx, t = cy['ar'], cy['sidx'], cy['t']
        B, S = ar.shape[0], sidx.shape[0]
        n_nodes = cy['clab'].shape[1]
        A = cy['atom_fv'].shape[1] - 1
        KE = cy['clist'].shape[0] // (B * n_nodes)
        Eg = (cy['e_av'].shape[0] - 2) // B
        b_of_a = cy['b_of_a']
        sp, nxt, stack, in_deg = cy['sp'], cy['nxt'], cy['stack'], \
            cy['in_deg']
        clab, ilab, agraph, down_row = cy['clab'], cy['ilab'], \
            cy['agraph'], cy['down_row']
        slot_used, slot_atom, atom_fv = cy['slot_used'], cy['slot_atom'], \
            cy['atom_fv']
        hatom, hinter = cy['hatom'], cy['hinter']
        tree_s = carry_state(cy, 'tree_')
        inter_s = carry_state(cy, 'inter_')
        graph_s = carry_state(cy, 'graph_')

        active = sp > 0
        any_active = active.any()
        v = stack[ar, (sp - 1).clamp(min=0)]
        v_clab, v_il, v_ag = clab[ar, v], ilab[ar, v], agraph[ar, v]

        # ---- (1) atom-level refresh of the frontier cluster --------------
        cr = cy['clist'][:-1].view(B, n_nodes, KE)[ar, v].reshape(-1)
        x_g = self._g_mess_input(cy['e_av'][cr], cy['e_bt'][cr],
                                 cy['e_nth'][cr])
        self._sparse_local(self.graph_rnn, graph_s, cr, x_g, cy['e_bg'][cr],
                           self.diterG)
        pp = tabs['ppack'][v_il].long()                    # [B, 3 + 7S]
        p_n = pp[:, 0]
        s_valid = sidx[None, :] < p_n[:, None]
        p_slot_atom = slot_atom[ar, v]                     # [B, S] local
        catoms = torch.where(s_valid & active[:, None],
                             1 + b_of_a[:, None] + p_slot_atom, 0)
        cf = catoms.reshape(-1)
        atom_nei = nei_sum(graph_s[0], cy['in_g'][cf])
        node_h = F.relu(self.W_graph_node(torch.cat(
            [self._atom_onehot(cy['a_av'][cf]), atom_nei], dim=-1)))
        scatter_rows_(hatom, cf, torch.where((cf > 0)[:, None], node_h, 0.0))

        # ---- (2) frontier readout at three levels and the topology -------
        hclu_v = nei_sum(hatom, catoms.int())
        inter_emb = F.relu(self.W_i(torch.cat([E_i(v_il), hclu_v], dim=-1)))
        inter_nei = nei_sum(inter_s[0], v_ag)
        inter_node = F.relu(self.W_inter_node(torch.cat(
            [inter_emb, inter_nei], dim=-1)))
        v_flat = 1 + ar * n_nodes + v
        # inactive lanes write zeros to row 0 (their v_flat is a live row)
        scatter_rows_(hinter, torch.where(active, v_flat, 0),
                      torch.where(active[:, None], inter_node, 0.0))
        tree_emb = F.relu(self.W_c(torch.cat([E_c(v_clab), inter_node],
                                             dim=-1)))
        tree_nei = nei_sum(tree_s[0], v_ag)
        tree_node = F.relu(self.W_tree_node(torch.cat([tree_emb, tree_nei],
                                                      dim=-1)))
        topo_logits = self.topoNN(torch.cat([tree_node, root_vecs],
                                            dim=-1))[..., 0]
        can_exp = in_deg[ar, v] < max_nb
        choose = (torch.sigmoid(topo_logits) > 0.5) & can_exp & active
        top = stack[ar, (sp - 2).clamp(min=0)]
        bt_valid = active & ~choose & (sp >= 2)
        bt_pos = in_deg[ar, top].clamp(max=MAX_POS - 1)
        bt_bg = torch.where(v_ag == down_row[ar, v][:, None], 0, v_ag)

        # ---- (3) message update and the joint top-k ----------------------
        row_t = cy['base'] + 1 + t
        rows = torch.where(choose | bt_valid, row_t, 0)
        pos = torch.where(choose, 0, bt_pos)
        bg = torch.where(choose[:, None], v_ag, bt_bg)
        pos_e = pos_onehot(pos)
        self._sparse_direct(self.inter_rnn, inter_s, rows,
                            torch.cat([inter_emb, pos_e], dim=-1), bg,
                            self.diterT)
        x_t = torch.cat([F.relu(self.W_c(torch.cat(
            [E_c(v_clab), hinter[v_flat]], dim=-1))), pos_e], dim=-1)
        self._sparse_direct(self.tree_rnn, tree_s, rows, x_t, bg, self.diterT)
        cls_s, icls_s = self.hdec_cls((tree_s,), rows, root_vecs)
        scores, cls_k, icls_k = hier_topk(cls_s, icls_s, vocab_mask, beam)

        # ---- (4) candidates, oracle and scores (JAX :1114-1271) ----------
        p_ap = pp[:, 1:3]
        p_typ, t_nxt, t_prv, ab_nxt, ab_prv, nxt_s, prv_s = (
            pp[:, 3 + i * S:3 + (i + 1) * S] for i in range(7))
        p_used = slot_used[ar, v]                          # [B, S], a copy
        p_fv = torch.gather(atom_fv, 1, p_slot_atom)
        p_as2 = cy['node_as2'][ar, v]
        p_single = p_n <= 1
        fv2 = torch.gather(p_fv, 1, torch.cat([nxt_s, prv_s], dim=1))
        fv_nxt, fv_prv = fv2[:, :S], fv2[:, S:]
        ap0, ap1 = p_ap[:, 0:1], p_ap[:, 1:2]
        si = sidx[None, :]
        excl_f = p_as2[:, None] & (((si == ap0) & (nxt_s == ap1)) |
                                   ((si == ap1) & (nxt_s == ap0)))
        excl_r = p_as2[:, None] & (((si == ap0) & (prv_s == ap1)) |
                                   ((si == ap1) & (prv_s == ap0)))

        cp = tabs['cpack'][icls_k].long()                  # [B, K, 10]
        c_isz = cp[..., 0]
        c_fail, c_sym = cp[..., 1].bool(), cp[..., 3].bool()
        c_t0, c_t1, c_n0, c_n1, c_apb = (cp[..., i] for i in (4, 5, 6, 7, 8))
        c_track = ~cp[..., 9].bool() & ~cp[..., 2].bool() & ~c_fail

        # membership in get_assm_cands' list, per kind, and its rank there
        typ, fv = p_typ[:, None, :], p_fv[:, None, :]
        elig1 = s_valid[:, None, :] & ~p_used[:, None, :] & \
            (c_isz[..., None] == 1)                        # [B, K, S]
        tm0 = typ == c_t0[..., None]
        tm_f = tm0 & (t_nxt[:, None, :] == c_t1[..., None])
        tm_r = tm0 & (t_prv[:, None, :] == c_t1[..., None])
        pairable = s_valid[:, None, :] & (p_n[:, None, None] >= 2) & \
            (c_isz[..., None] == 2)
        elig_f = pairable & ~excl_f[:, None, :] & tm_f
        elig_r = pairable & ~excl_r[:, None, :] & tm_r & ~c_sym[..., None]
        rank1 = torch.cumsum(elig1.long(), dim=-1) - 1
        rank_f = torch.cumsum(elig_f.long(), dim=-1) - 1
        nf = elig_f.long().sum(dim=-1, keepdim=True)
        # reverse pairs are enumerated from the largest slot down
        rank_r = nf + torch.flip(torch.cumsum(torch.flip(
            elig_r.long(), dims=(-1,)), dim=-1), dims=(-1,)) - 1
        n_cands = elig1.long().sum(-1) + elig_f.long().sum(-1) + \
            elig_r.long().sum(-1)

        # the oracle's feasibility (valence; try_add_mol)
        f1 = elig1 & tm0 & (fv >= c_n0[..., None])
        ex_f = (ab_nxt[:, None, :] == 0).long() * c_apb[..., None]
        ff = elig_f & (fv >= c_n0[..., None] + ex_f) & \
            (fv_nxt[:, None, :] >= c_n1[..., None] + ex_f)
        ex_r = (ab_prv[:, None, :] == 0).long() * c_apb[..., None]
        fr = elig_r & (fv >= c_n0[..., None] + ex_r) & \
            (fv_prv[:, None, :] >= c_n1[..., None] + ex_r)

        # assembly scores against the live atom hiddens (hdec_assm)
        nth_sc = in_deg[ar, v].clamp(max=MAX_POS - 1)
        base_a = 1 + b_of_a[:, None]

        def aflat(loc):
            return torch.where(s_valid, base_a + torch.gather(
                p_slot_atom, 1, loc), 0)
        a_self = torch.where(s_valid, base_a + p_slot_atom, 0)
        h_self, h_nxt, h_prv = (hatom[a] for a in (a_self, aflat(nxt_s),
                                                   aflat(prv_s)))
        ap_c = tabs['apack'][icls_k].long()                # [B, K, 3]
        ic_e = E_i(ap_c[..., :2])                          # [B, K, 2, E]
        nmask = (torch.arange(2, device=ar.device)[None, None, :] <
                 ap_c[..., 2:3])                           # [B, K, 2]
        pos_sc = pos_onehot(nth_sc)                        # [B, P]
        K = beam

        def pair_score(h0, h1):
            # [B, S, H] endpoints -> [B, K, S] scores
            hh = torch.stack([h0, h1], dim=2)[:, None].expand(
                B, K, S, 2, h0.shape[-1])
            ie = ic_e[:, :, None].expand(B, K, S, 2, ic_e.shape[-1])
            pe = pos_sc[:, None, None, None, :].expand(B, K, S, 2,
                                                       pos_sc.shape[-1])
            mvec = F.relu(self.matchNN(torch.cat([hh, ie, pe], dim=-1)))
            cand = (mvec * nmask[:, :, None, :, None]).sum(dim=3)
            return (self.W_assm(cand) * root_vecs[:, None, None, :]).sum(-1)
        sc1 = pair_score(h_self, h_self)
        scf = pair_score(h_self, h_nxt)
        scr = pair_score(h_self, h_prv)

        neg = torch.finfo(torch.float32).min / 4
        # the first HIER_CAND_CAP candidates of a kind are scored
        m1, mf, mr = (f & (r < HIER_CAND_CAP)
                      for f, r in ((f1, rank1), (ff, rank_f), (fr, rank_r)))
        all_sc = torch.cat([torch.where(m1, sc1, neg),
                            torch.where(mf, scf, neg),
                            torch.where(mr, scr, neg)], dim=-1)  # [B, K, 3S]
        all_rank = torch.cat([rank1, rank_f, rank_r], dim=-1)
        feas_any = (m1 | mf | mr).any(dim=-1)              # [B, K]
        best = all_sc.amax(dim=-1)
        is_best = all_sc >= best[..., None]
        # ties: the smallest enumeration rank among the best scores
        pick = torch.argmin(torch.where(is_best, all_rank, 10 ** 6), dim=-1)
        any_feas = feas_any.any(dim=1)
        j_star = torch.argmax(feas_any.int(), dim=1)       # the first

        def take(x):
            return torch.gather(x, 1, j_star[:, None])[:, 0]
        new_clab = torch.where(any_feas, take(cls_k), cls_k[:, 0])
        new_ilab = torch.where(any_feas, take(icls_k), icls_k[:, 0])
        kindA, slotA = take(pick // S), take(pick % S)
        nxt_a = torch.gather(nxt_s, 1, slotA[:, None])[:, 0]
        prv_a = torch.gather(prv_s, 1, slotA[:, None])[:, 0]
        slotB = torch.where(kindA == 2, prv_a, nxt_a)
        ex_all = torch.where((kindA == 2)[:, None, None], ex_r, ex_f)
        exA = torch.gather(torch.gather(ex_all, 1, j_star[:, None, None]
                                        .expand(-1, 1, S))[:, 0], 1,
                           slotA[:, None])[:, 0]
        nc_j, ct_j = take(n_cands), take(c_track)
        is2 = take(c_isz) == 2
        extraA = take(c_n0) + torch.where(is2, exA, 0)
        extraB = take(c_n1) + torch.where(is2, exA, 0)

        # ---- (5) tree bookkeeping (JAX :1273-1302) -----------------------
        def set_at(tab, idx, cond, value):
            # tab[b, idx[b]] = value[b] where cond[b]
            tab[ar, idx] = torch.where(cond, value, tab[ar, idx])
        forced = active & choose & ~any_feas
        commit = choose & any_feas
        nn_i = nxt.clamp(max=n_nodes - 1)
        set_at(clab, nn_i, choose, new_clab)
        set_at(ilab, nn_i, choose, new_ilab)
        set_at(down_row, nn_i, choose, row_t)
        agraph[ar, nn_i, 0] = torch.where(choose, row_t.int(),
                                          agraph[ar, nn_i, 0])
        set_at(in_deg, nn_i, choose, torch.ones_like(nxt))
        set_at(stack, sp.clamp(max=n_nodes - 1), choose, nn_i)
        slot = in_deg[ar, top].clamp(max=max_nb - 1)
        agraph[ar, top, slot] = torch.where(bt_valid, row_t.int(),
                                            agraph[ar, top, slot])
        close_top = bt_valid | (forced & (sp >= 2))
        in_deg[ar, top] = in_deg[ar, top] + close_top.long()
        in_deg[ar, v] = in_deg[ar, v] + forced.long()
        push = choose & ~forced
        pop = active & ~choose
        sp += push.long() - pop.long() - forced.long()
        nxt += choose.long()

        # ---- the budget guard: a graft that would outrun a sample's bond
        # rows, atoms or cluster rows poisons it instead of spilling into
        # the next sample's rows (JAX :1304-1321)
        bp = tabs['bpack'][new_ilab].long()                # [B, 8 + 5S]
        isz2c = bp[:, 1] >= 2
        n_new_c = (bp[:, 0] - 1 - isz2c.long()).clamp(min=0)
        need_e = 2 * bp[:, 7]
        ovf = (cy['edge_cnt'] + need_e > Eg) | \
            (cy['atom_cnt'] + n_new_c > A) | \
            (cy['ccnt'][ar, nn_i] + need_e > KE)
        poisoned = cy['poisoned']
        do_c = commit & ct_j & ~poisoned & ~ovf
        poisoned |= commit & (~ct_j | ovf)
        do_pair = do_c & is2

        # ---- the oracle's bookkeeping (JAX :1323-1361) -------------------
        cur_a = torch.gather(p_used, 1, slotA[:, None])[:, 0]
        cur_b = torch.gather(p_used, 1, slotB[:, None])[:, 0]
        slot_used[ar, v, slotA] = torch.where(do_c & ~p_single, True, cur_a)
        slot_used[ar, v, slotB] = torch.where(do_pair & ~p_single, True,
                                              cur_b)
        pa_a = torch.gather(p_slot_atom, 1, slotA[:, None])[:, 0]
        pa_b = torch.gather(p_slot_atom, 1, slotB[:, None])[:, 0]
        atom_fv[ar, pa_a] += torch.where(do_c, -extraA, 0)
        atom_fv[ar, pa_b] += torch.where(do_pair, -extraB, 0)
        slot_used[ar, nn_i] = torch.where(choose[:, None],
                                          bp[:, 8:8 + S].bool(),
                                          slot_used[ar, nn_i])
        ch_ap = bp[:, 5:7]
        ch_new_atom = (cy['atom_cnt'][:, None] +
                       bp[:, 8 + 2 * S:8 + 3 * S]).clamp(max=A - 1)
        ch_atom = torch.where(
            si == ch_ap[:, 0:1], pa_a[:, None],
            torch.where(isz2c[:, None] & (si == ch_ap[:, 1:2]),
                        pa_b[:, None], ch_new_atom))
        slot_atom[ar, nn_i] = torch.where(choose[:, None], ch_atom,
                                          slot_atom[ar, nn_i])
        ch_valid = si < bp[:, 0:1]
        wmask = do_c[:, None] & ch_valid & ~bp[:, 8 + 3 * S:8 + 4 * S].bool()
        # the new atoms' birth valences; masked lanes write to the sink
        # column A, which nothing reads (JAX writes them to atom A - 1)
        atom_fv[ar[:, None], torch.where(wmask, ch_atom, A)] = \
            bp[:, 8 + S:8 + 2 * S]
        cy['atom_cnt'] += torch.where(do_c, n_new_c, 0)
        # grafted onto an existing parent bond: no extra anchor valence
        as2_child = do_pair & (bp[:, 3] > 0) & (exA == 0)
        set_at(cy['node_as2'], nn_i, choose, as2_child)

        # ---- (6) the graft's atom-level rows (JAX :1363-1386) ------------
        ch_atom_f = torch.where(ch_valid & do_c[:, None],
                                base_a + ch_atom, 0)
        scatter_rows_(cy['a_av'], torch.where(wmask, ch_atom_f, 0).reshape(-1),
                      torch.where(wmask, bp[:, 8 + 4 * S:8 + 5 * S],
                                  0).reshape(-1))
        # the anchor pair's motif bond order: ab_prv / ab_nxt at slotA
        pbond = torch.gather(torch.where((kindA == 2)[:, None], ab_prv,
                                         ab_nxt), 1, slotA[:, None])[:, 0]
        skip_anchor = do_pair & (pbond > 0)
        nth_edge = torch.where(nc_j == 1, 0, in_deg[ar, v])
        self._graft_rows_vec(tabs, cy, cy['b_of_e'], new_ilab, ch_atom_f,
                             do_c, nth_edge, skip_anchor, nn_i)

        # ---- the packed row: the committed beam's feasibility bit masks,
        # S bits each (exact in f32), for the host replay's check
        j_pack = torch.where(choose, torch.where(any_feas, j_star, -1), 0)
        bitw = 2.0 ** torch.arange(S, dtype=torch.float32, device=ar.device)
        fm = [take((mk.float() * bitw).sum(-1)) for mk in (m1, mf, mr)]
        packed = torch.cat(
            [topo_logits[:, None], choose.float()[:, None], scores,
             cls_k.float(), icls_k.float()] +
            [x.float()[:, None] for x in (j_pack, new_ilab, kindA, slotA)] +
            [x[:, None] for x in fm], dim=1)
        trace.index_copy_(0, t, torch.where(any_active, packed, 0.0)[None])
        cy['n_run'] += any_active.long()
        t += 1
