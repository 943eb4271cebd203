"""Motif decoder: the teacher-forced training path and the decode-step
functions (counterpart of ``ggpm_tpu/models/decoder.py``:
``PredictionMLP``, ``MotifDecoder`` with its ``forward``/``mean_forward``
losses and its ``dec_*`` API; attention and the device-resident
``dec_propose`` arrive with later slices).

Training: ``forward`` runs the teacher-forced scan (``_run_scan``), which
carries only the message state, then the losses (``_losses``).  The scan's
frontier readouts come after it, as one ``nei_sum_t`` over the host-built
masked frontier table (``data.batching.frontier_table``): B1's fourth call
site, with the kernel's transpose as its backward.

Each decode step is one call of ``dec_step_fused`` on [B]-shaped inputs that
the host loop (``models/decode.py``) builds from its growing trees.  The
message state is a pair of ``[max_edges * B, H]`` buffers whose row 0 is the
zero padding message; ``dec_update`` writes the step's new rows in place.
The frontier readout of ``dec_topo`` goes through the ``nei_sum`` kernel.

The motif and attachment embeddings are owned by the VAE and shared with
the encoder (reference vae.py tie_embedding), so the decoder holds them
without registering them as its own parameters.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from ..ops import nei_sum, nei_sum_t
from .decode import hier_topk
from .encoder import dropout, pos_onehot
from .rnn import MPNLSTMCell

State = Tuple[torch.Tensor, torch.Tensor]


class PredictionMLP(nn.Module):
    """hidden→out two-layer head used by the topo/cls/icls predictors
    (reference decoder.py:492-511); layers named after the flax ones."""

    def __init__(self, input_size: int, hidden_size: int, out_size: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.Dense_0 = nn.Linear(input_size, hidden_size)
        self.drop = dropout(dropout_rate)
        self.Dense_1 = nn.Linear(hidden_size, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(self.drop(F.relu(self.Dense_0(x))))


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy per row: logsumexp − the gold logit."""
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


class MotifDecoder(nn.Module):
    """The JAX ``MotifDecoder`` without attention.  ``matchNN`` and
    ``W_assm`` score attachments in the training loss only."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 latent_size: int, diterT: int = 1,
                 dropout_rate: float = 0.0):
        super().__init__()
        embed_size = E_c.embedding_dim
        self._embed = (E_c, E_i)   # a tuple: not registered as submodules
        self.hidden_size = hidden_size
        self.latent_size = latent_size
        self.diterT = diterT
        self.drop = dropout(dropout_rate)
        self.rnn = MPNLSTMCell(embed_size + MAX_POS, hidden_size, diterT)
        self.W_node = nn.Linear(embed_size + hidden_size, hidden_size)
        head_in = hidden_size + latent_size
        self.topoNN = PredictionMLP(head_in, hidden_size, 1, dropout_rate)
        self.clsNN = PredictionMLP(head_in, hidden_size, E_c.num_embeddings,
                                   dropout_rate)
        self.iclsNN = PredictionMLP(head_in, hidden_size, E_i.num_embeddings,
                                    dropout_rate)
        self.matchNN = nn.Linear(embed_size + MAX_POS, hidden_size)
        self.W_assm = nn.Linear(hidden_size, latent_size)
        if latent_size != hidden_size:
            self.W_root = nn.Linear(latent_size, hidden_size)

    # -- shared helpers ----------------------------------------------------
    def root_vecs_to_hidden(self, root_vecs: torch.Tensor) -> torch.Tensor:
        if hasattr(self, 'W_root'):
            return self.W_root(root_vecs)
        return root_vecs

    def topo_logit(self, ctx: torch.Tensor, topo_vecs: torch.Tensor
                   ) -> torch.Tensor:
        return self.topoNN(torch.cat([topo_vecs, ctx], dim=-1))[..., 0]

    def cls_logits(self, cls_vecs: torch.Tensor, ctx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([cls_vecs, ctx], dim=-1)
        return self.clsNN(x), self.iclsNN(x)

    def match_vec(self, icls_ids: torch.Tensor, n_icls: torch.Tensor,
                  nth_child: torch.Tensor) -> torch.Tensor:
        """Sum of matchNN over the (1 or 2) anchor attachment embeddings
        (reference decoder.py:143; candidate-independent for the motif
        decoder)."""
        emb = self.drop(self._embed[1](icls_ids.long()))       # [..., 2, E]
        pos = pos_onehot(nth_child)[..., None, :].expand(
            *emb.shape[:-1], MAX_POS)
        v = F.relu(self.matchNN(torch.cat([emb, pos], dim=-1)))
        k_mask = torch.arange(2, device=v.device) < n_icls[..., None]
        return (v * k_mask[..., None]).sum(dim=-2)

    # -- teacher-forced training loss (reference decoder.py:155-409) -------
    def forward(self, tree: Dict[str, torch.Tensor],
                plan: Dict[str, torch.Tensor], root_vecs: torch.Tensor,
                vocab_mask: torch.Tensor):
        """(loss, metrics) of a batch whose ``plan`` carries the frontier
        table (``data.batching.train_tables``); packed (``mol_lane``) or
        unpacked."""
        topo_vecs, cls_vecs, init_vecs = self._run_scan(tree, plan, root_vecs)
        return self._losses(plan, root_vecs, init_vecs, vocab_mask,
                            topo_vecs, cls_vecs)

    def mean_forward(self, tree: Dict[str, torch.Tensor],
                     plan: Dict[str, torch.Tensor], root_vecs: torch.Tensor,
                     vocab_mask: torch.Tensor):
        """``forward`` with the per-sample loss partition ([B]) as a third
        output (reference decoder.py:169-188)."""
        topo_vecs, cls_vecs, init_vecs = self._run_scan(tree, plan, root_vecs)
        return self._losses(plan, root_vecs, init_vecs, vocab_mask,
                            topo_vecs, cls_vecs, return_per_sample=True)

    def _run_scan(self, tree, plan, root_vecs):
        """Teacher-forced state recurrence and readouts (reference
        decoder.py:190-287).  The loop carries only the concatenated state
        ``S = [h | c]`` over ``num_mess + B`` rows (the last B are the
        virtual root messages, wired to the latent); each step gathers its
        lanes' neighbour rows, applies the cell from hoisted x terms and
        writes the new rows out of place, as ``.at[rows].set`` does, with
        invalid lanes writing zeros to row 0.  One application per step
        reproduces any diterT >= 1 (the message DAG is acyclic).  The
        frontier readouts come after the loop: each row is written once,
        so the final state read through the masked ``plan['frontier']``
        equals the reference's per-step readout."""
        fnode, fmess = tree['fnode'], tree['fmess']
        bgraph = tree['bgraph_dec']
        num_mess = fmess.shape[0]
        H = self.hidden_size

        init_vecs = self.root_vecs_to_hidden(root_vecs)
        hnode_emb = self.drop(self._embed[0](fnode[:, 0]))
        hmess_input = torch.cat([hnode_emb[fmess[:, 0].long()],
                                 pos_onehot(fmess[:, 2])], dim=-1)

        zeros = init_vecs.new_zeros((num_mess, 2 * H))
        S = torch.cat([zeros, torch.cat([init_vecs, torch.zeros_like(
            init_vecs)], dim=-1)])
        xid, mess = plan['xid'].long(), plan['mess'].long()
        T, L = mess.shape
        valid = (mess > 0)[..., None]
        xp = self.rnn.x_proj(hmess_input)[mess]           # [T, L, 4H]
        bg_rows = bgraph[mess].long()                     # [T, L, A]
        ks = self.rnn.k_h()
        for t in range(T):
            nei = S[bg_rows[t]]                           # [L, A, 2H]
            h, c = self.rnn.step(xp[t], (nei[..., :H], nei[..., H:]), ks)
            upd = torch.where(valid[t], torch.cat([h, c], dim=-1), 0.0)
            S = S.index_put((mess[t],), upd)
        h_final = S[:, :H].contiguous()

        nei_msg = nei_sum_t(h_final, plan['frontier'], plan['frontier_t'],
                            plan['frontier_tm']).view(T, L, H)
        topo_vecs = F.relu(self.W_node(torch.cat([hnode_emb[xid], nei_msg],
                                                 dim=-1)))
        cls_vecs = h_final[mess]
        return topo_vecs, cls_vecs, init_vecs

    def _losses(self, plan, root_vecs, init_vecs, vocab_mask, topo_vecs,
                cls_vecs, return_per_sample=False):
        """Topology BCE, motif and attachment cross-entropies (the
        attachment logits masked by the additive vocab mask) and the
        closed-form assembly loss, summed and divided by the batch size,
        with the accuracies (reference decoder.py:289-409)."""
        batch_size = root_vecs.shape[0]
        active = plan['active']
        T, L = active.shape
        mol_lane = plan.get('mol_lane')
        if mol_lane is not None:
            mol_lane = mol_lane.long()
            latent_b = root_vecs[mol_lane]
        else:
            latent_b = root_vecs[None].expand(T, batch_size, -1)

        # topology loss (BCE with logits, summed over active steps)
        topo_logits = self.topo_logit(latent_b, topo_vecs)
        tlab = plan['tlab'].float()
        topo_bce = torch.clamp(topo_logits, min=0) - topo_logits * tlab + \
            torch.log1p(torch.exp(-torch.abs(topo_logits)))
        act_f = active.float()
        topo_loss = (topo_bce * act_f).sum()
        topo_pred = (topo_logits >= 0).long()
        topo_acc = ((topo_pred == plan['tlab'].long()) * active).sum() / \
            torch.clamp(active.sum(), min=1)

        # motif (cls + icls) loss: the B roots, then every expand step
        root_cls, root_icls = self.cls_logits(init_vecs, root_vecs)
        step_cls, step_icls = self.cls_logits(cls_vecs, latent_b)
        root_clab, root_ilab = plan['root_clab'].long(), plan['root_ilab'].long()
        clab, ilab = plan['clab'].long(), plan['ilab'].long()
        root_icls = root_icls + vocab_mask[root_clab]
        step_icls = step_icls + vocab_mask[clab]

        has_cls = plan['has_cls'].float()
        cls_ce_root, cls_ce_step = _ce(root_cls, root_clab), _ce(step_cls, clab)
        icls_ce_root = _ce(root_icls, root_ilab)
        icls_ce_step = _ce(step_icls, ilab)
        cls_loss = cls_ce_root.sum() + (cls_ce_step * has_cls).sum()
        icls_loss = icls_ce_root.sum() + (icls_ce_step * has_cls).sum()

        n_cls = batch_size + has_cls.sum()
        cls_correct = (root_cls.argmax(-1) == root_clab).sum() + \
            ((step_cls.argmax(-1) == clab) * has_cls).sum()
        icls_correct = (root_icls.argmax(-1) == root_ilab).sum() + \
            ((step_icls.argmax(-1) == ilab) * has_cls).sum()

        # assembly loss, in closed form (module docstring of the reference)
        mvec = self.match_vec(plan['assm_icls'], plan['assm_n_icls'],
                              plan['assm_nth'])
        s = (self.W_assm(mvec) * latent_b).sum(-1)        # real-cand score
        p_mol = (self.W_assm.bias * root_vecs).sum(-1)     # pad-slot score
        p = p_mol[mol_lane] if mol_lane is not None else p_mol[None, :]
        nc = plan['assm_nc'].float()
        maxc = plan['max_cls_size'].float()
        m = torch.maximum(s, p)
        lse = torch.log(nc * torch.exp(s - m) + torch.clamp(maxc - nc, min=0)
                        * torch.exp(p - m) + 1e-12) + m
        has_assm = plan['has_assm'].float()
        assm_loss = ((lse - s) * has_assm).sum()
        assm_correct = (s >= p) | (nc >= maxc)
        n_assm = has_assm.sum()
        assm_acc = torch.where(
            n_assm > 0,
            (assm_correct * has_assm).sum() / torch.clamp(n_assm, min=1),
            torch.ones_like(n_assm))

        loss = (topo_loss + cls_loss + icls_loss + assm_loss) / batch_size
        metrics = {'Word': cls_correct / n_cls, 'I-Word': icls_correct / n_cls,
                   'Topo': topo_acc, 'Assm': assm_acc}
        if not return_per_sample:
            return loss, metrics
        # the per-sample partition: over mol_lane for a packed plan, over
        # the step axis otherwise (inactive slots carry zero terms)
        if mol_lane is not None:
            def seg(x):
                return x.new_zeros(batch_size).scatter_add(
                    0, mol_lane.reshape(-1), x.reshape(-1))
        else:
            def seg(x):
                return x.sum(0)
        per_sample = (seg(topo_bce * act_f) + cls_ce_root +
                      seg(cls_ce_step * has_cls) + icls_ce_root +
                      seg(icls_ce_step * has_cls) + seg((lse - s) * has_assm))
        return loss, metrics, per_sample

    # -- autoregressive decode steps (reference decoder.py:979, 1012) -------
    def dec_init_state(self, num_rows: int, root_vecs: torch.Tensor) -> State:
        """Zero message state with the latent wired into rows 1..B (the
        super-root→root edges; reference decoder.py:954-958)."""
        h, c = self.rnn.init_state(num_rows, root_vecs.device)
        h[1:root_vecs.shape[0] + 1] = self.root_vecs_to_hidden(root_vecs)
        return h, c

    def dec_update(self, state: State, rows: torch.Tensor,
                   src_clab: torch.Tensor, pos: torch.Tensor,
                   bgraph_rows: torch.Tensor) -> State:
        """Messages of the edges added this step, written into ``state`` in
        place at ``rows``.  Invalid lanes have ``rows == 0`` and write zeros
        there, which keeps the padding row zero whatever order the
        duplicate writes take."""
        x = torch.cat([self._embed[0](src_clab), pos_onehot(pos)], dim=-1)
        valid = (rows > 0)[:, None]
        rows, bg = rows.long(), bgraph_rows.long()
        for _ in range(self.diterT):
            new = self.rnn.cell(x, tuple(s[bg] for s in state))
            for s, nr in zip(state, new):
                s.index_put_((rows,), torch.where(valid, nr, 0.0))
        return state

    def dec_topo(self, state: State, v_clab: torch.Tensor,
                 agraph_rows: torch.Tensor, root_vecs: torch.Tensor
                 ) -> torch.Tensor:
        """Frontier-node readout (the ``nei_sum`` kernel over the frontier's
        incoming messages, int32 ``agraph_rows`` [B, A]) and the topology
        logit (expand vs backtrack)."""
        nei = nei_sum(self.rnn.hidden(state), agraph_rows)
        node_h = F.relu(self.W_node(
            torch.cat([self._embed[0](v_clab), nei], dim=-1)))
        return self.topo_logit(root_vecs, node_h)

    def dec_cls(self, state: State, rows: torch.Tensor,
                root_vecs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Motif/attachment logits from the new expand messages."""
        return self.cls_logits(self.rnn.hidden(state)[rows.long()], root_vecs)

    def dec_root_cls(self, root_vecs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_logits(self.root_vecs_to_hidden(root_vecs), root_vecs)

    def dec_step_fused(self, state: State, v_clab, agraph_rows, can_expand, u,
                       new_rows, exp_src_clab, exp_bg_rows, bt_valid,
                       bt_src_clab, bt_pos, bt_bg_rows, root_vecs, vocab_mask,
                       beam: int) -> Tuple[State, torch.Tensor]:
        """One decode step with both branches' inputs given (reference
        decoder.py:999-1004; JAX decoder.py:568).  The device picks per
        sample: expand iff sigmoid(topo) > u and the frontier can expand,
        else backtrack (a message row only if a backtrack edge exists).
        ``u`` is 0.5 for greedy decoding or a uniform sample.  Returns the
        state and one packed [B, 2 + 3·beam] f32 array (topo logit, choice,
        beam scores, motif and attachment ids), so that the host syncs once
        per step."""
        topo_logits = self.dec_topo(state, v_clab, agraph_rows, root_vecs)
        choose = (torch.sigmoid(topo_logits) > u) & can_expand
        rows = torch.where(choose | bt_valid, new_rows, 0)
        src_clab = torch.where(choose, exp_src_clab, bt_src_clab)
        pos = torch.where(choose, 0, bt_pos)
        bg = torch.where(choose[:, None], exp_bg_rows, bt_bg_rows)
        state = self.dec_update(state, rows, src_clab, pos, bg)
        cls_scores, icls_scores = self.dec_cls(state, rows, root_vecs)
        scores, cls_k, icls_k = hier_topk(cls_scores, icls_scores,
                                          vocab_mask, beam)
        packed = torch.cat(
            [topo_logits[:, None], choose.float()[:, None], scores,
             cls_k.float(), icls_k.float()], dim=1)
        return state, packed
