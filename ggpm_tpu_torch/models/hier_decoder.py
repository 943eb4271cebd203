"""Hierarchical (3-level) decoder: its parameters, the teacher-forced
training forward and the exact decode's steps (counterpart of
``ggpm_tpu/models/hier_decoder.py``: ``HierDecoder``'s modules and
``__call__`` with its losses, ``_sparse_direct``, ``hdec_init``,
``hdec_graph_update``, ``hdec_topo``, ``hdec_mess_update``, ``hdec_cls``,
``hdec_step_fused`` and ``hdec_assm``).  The turbo decode's propose loop
is ROADMAP A5's rest.

Training: ``forward`` runs the scan step by step, each state written out
of place for autograd; its five sums a step go through ``nei_sum_t`` and
its message updates' neighbour gathers through ``gather_nd_t``, each with
the step's own table and transpose (``data.batching.hier_train_tables``),
so their backward is the kernels' transpose.

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

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from ..ops import gather_nd_t, nei_sum, nei_sum_t
from .decode import hier_topk
from .decoder import PredictionMLP, _ce
from .encoder import dropout, pos_onehot
from .rnn import MPNLSTMCell

Level = Tuple[torch.Tensor, torch.Tensor]
State = Tuple[Level, Level, Level, torch.Tensor, torch.Tensor]


def _check_writers(buf: torch.Tensor, rows: torch.Tensor,
                   values: torch.Tensor) -> None:
    """On the CPU, raise if two writers of one row of ``buf`` write
    different values: ``index_put`` keeps one arbitrary writer of a
    repeated row on the card, which is sound only where they agree (row 0,
    written with zeros, and rows whose inputs coincide)."""
    if buf.device.type == 'cpu' and rows.numel() > 1:
        order = torch.argsort(rows, stable=True)
        r, v = rows[order], values[order]
        dup = (r[1:] == r[:-1]).nonzero().flatten()
        differ = (v[dup] != v[dup + 1]).flatten(1).any(1)
        if differ.any():
            raise AssertionError(
                'duplicate rows written with different values: '
                f'{sorted(set(r[dup[differ]].tolist()))}')


def scatter_rows_(buf: torch.Tensor, rows: torch.Tensor,
                  values: torch.Tensor) -> None:
    """``buf[rows] = values`` in place, for ``rows`` [R] and ``values``
    [R, ...] whose lanes at row 0 hold zeros (``_check_writers``)."""
    rows = rows.long()
    _check_writers(buf, rows, values)
    buf.index_put_((rows,), values)


def put_rows(buf: torch.Tensor, rows: torch.Tensor,
             values: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``values`` written at ``rows``, out of place (JAX
    ``buf.at[rows].set(values)``), under ``scatter_rows_``'s rule."""
    rows = rows.long()
    _check_writers(buf, rows, values)
    return buf.index_put((rows,), values)


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
        self.drop = dropout(dropout_rate)
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

    # -- teacher-forced training loss (JAX hier_decoder.py:109-346) --------
    @staticmethod
    def _sparse_update(rnn: MPNLSTMCell, weights, state: Level,
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
                root_vecs: torch.Tensor, vocab_mask: torch.Tensor):
        """(loss, metrics) of a batch whose ``plan`` carries the scan's
        per-step tables and transposes (``data.batching.hier_train_tables``).

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

        init_vecs = self.root_vecs_to_hidden(root_vecs)
        ec_emb = self.drop(E_c(fnode[:, 0]))
        ei_emb = self.drop(E_i(fnode[:, 1]))
        gfnode, gfmess = graph['fnode'], graph['fmess']
        g_mess_in = self._g_mess_input(gfnode[gfmess[:, 0].long()],
                                       gfmess[:, 2], gfmess[:, 3])
        pos_tab = pos_onehot(fmess[:, 2])

        dev = root_vecs.device
        tree_s = (torch.cat([init_vecs.new_zeros((num_mess, H)), init_vecs]),
                  init_vecs.new_zeros((num_mess + init_vecs.shape[0], H)))
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
            cand_scores.append((self.W_assm(cand_vecs) *
                                root_vecs[:, None, :]).sum(-1))
        return self._losses(plan, root_vecs, init_vecs, vocab_mask,
                            torch.stack(topo_vecs), torch.stack(cls_vecs),
                            torch.stack(cand_scores))

    def _losses(self, plan, root_vecs, init_vecs, vocab_mask, topo_vecs,
                cls_vecs, cand_scores):
        """Topology BCE, motif and attachment cross-entropies (the
        attachment logits masked by the additive vocab mask) and the
        assembly cross-entropy over the real candidate slots and
        ``max_cls_size − nc`` zero-vector pad slots (score ``W_assm(0)·z``),
        summed and divided by the batch size, with the accuracies (JAX
        hier_decoder.py:262-346).  Nothing is read on the host."""
        batch_size = root_vecs.shape[0]
        T = topo_vecs.shape[0]
        latent_b = root_vecs[None].expand(T, batch_size, -1)
        active = plan['active']

        topo_logits = self.topoNN(torch.cat([topo_vecs, latent_b],
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
        root_cls, root_icls = heads(init_vecs, root_vecs)
        step_cls, step_icls = heads(cls_vecs, latent_b)
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
