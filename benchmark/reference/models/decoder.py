"""The motif decoder's teacher-forced training loss in plain PyTorch (a
frozen copy of the port's ``models/decoder.py:MotifDecoder`` training
path, LSTM, float32, no attention).

It departs from the port's formulation where the port precomputes: the
plan is read unpacked ([T, B], one lane a molecule; the port packs lanes),
and each step's frontier readout sums the state as that step left it,
inside the scan (the port reads the final state once through a masked
frontier table).  Both give the same terms; only the order of float
sums may differ.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from .encoder import pos_onehot
from .rnn import MPNLSTMCell


class PredictionMLP(nn.Module):
    """hidden→out two-layer head used by the topo/cls/icls predictors
    (reference decoder.py:492-511); layers named after the flax ones."""

    def __init__(self, input_size: int, hidden_size: int, out_size: int):
        super().__init__()
        self.Dense_0 = nn.Linear(input_size, hidden_size)
        self.Dense_1 = nn.Linear(hidden_size, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))


def ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy per row: logsumexp − the gold logit."""
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def topo_terms(topo_logits: torch.Tensor, plan) -> tuple:
    """The topology BCE summed over the active steps, and its accuracy."""
    active = plan['active']
    tlab = plan['tlab'].float()
    bce = torch.clamp(topo_logits, min=0) - topo_logits * tlab + \
        torch.log1p(torch.exp(-torch.abs(topo_logits)))
    acc = (((topo_logits >= 0).long() == plan['tlab'].long()) * active
           ).sum() / torch.clamp(active.sum(), min=1)
    return (bce * active.float()).sum(), acc


def cls_terms(cls_nn, icls_nn, plan, init_vecs, root_ctx, cls_vecs, step_ctx,
              vocab_mask) -> tuple:
    """Motif and attachment cross-entropies of the roots and every expand
    step (the attachment logits under the additive vocab mask), and their
    accuracies."""
    def heads(vec, ctx):
        x = torch.cat([vec, ctx], dim=-1)
        return cls_nn(x), icls_nn(x)
    root_clab, root_ilab = plan['root_clab'].long(), plan['root_ilab'].long()
    clab, ilab = plan['clab'].long(), plan['ilab'].long()
    root_cls, root_icls = heads(init_vecs, root_ctx)
    step_cls, step_icls = heads(cls_vecs, step_ctx)
    root_icls = root_icls + vocab_mask[root_clab]
    step_icls = step_icls + vocab_mask[clab]
    has_cls = plan['has_cls'].float()
    cls_loss = ce(root_cls, root_clab).sum() + \
        (ce(step_cls, clab) * has_cls).sum()
    icls_loss = ce(root_icls, root_ilab).sum() + \
        (ce(step_icls, ilab) * has_cls).sum()
    n_cls = root_clab.shape[0] + has_cls.sum()
    cls_acc = ((root_cls.argmax(-1) == root_clab).sum() +
               ((step_cls.argmax(-1) == clab) * has_cls).sum()) / n_cls
    icls_acc = ((root_icls.argmax(-1) == root_ilab).sum() +
                ((step_icls.argmax(-1) == ilab) * has_cls).sum()) / n_cls
    return cls_loss, icls_loss, cls_acc, icls_acc


class MotifDecoder(nn.Module):
    """The motif decoder's training modules (reference decoder.py)."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 latent_size: int, diterT: int = 1):
        super().__init__()
        embed_size = E_c.embedding_dim
        self._embed = (E_c, E_i)        # the VAE's: not registered here
        self.hidden_size = hidden_size
        self.rnn = MPNLSTMCell(embed_size + MAX_POS, hidden_size, diterT)
        self.W_node = nn.Linear(embed_size + hidden_size, hidden_size)
        head_in = hidden_size + latent_size
        self.topoNN = PredictionMLP(head_in, hidden_size, 1)
        self.clsNN = PredictionMLP(head_in, hidden_size, E_c.num_embeddings)
        self.iclsNN = PredictionMLP(head_in, hidden_size, E_i.num_embeddings)
        self.matchNN = nn.Linear(embed_size + MAX_POS, hidden_size)
        self.W_assm = nn.Linear(hidden_size, latent_size)
        if latent_size != hidden_size:
            self.W_root = nn.Linear(latent_size, hidden_size)

    def forward(self, tree: Dict[str, torch.Tensor],
                plan: Dict[str, torch.Tensor], root_vecs: torch.Tensor,
                vocab_mask: torch.Tensor):
        """(loss, metrics) of a batch with its unpacked plan.

        The teacher-forced recurrence (reference decoder.py:190-287)
        carries the cell's state ``[h | c]`` over ``num_mess + B`` rows,
        the last B rows' ``h`` being the latent's projection (the virtual
        root messages).  Step t applies the cell to its lanes' messages
        from their neighbours' rows, writes them (an invalid lane writes
        zeros to row 0), then reads the frontier of its nodes, the sum of
        their incoming messages as they stand.  One application a step
        gives any diterT >= 1: the message DAG is acyclic."""
        E_c, E_i = self._embed
        fnode, fmess = tree['fnode'], tree['fmess']
        H = self.hidden_size
        B = root_vecs.shape[0]
        init_vecs = self.W_root(root_vecs) if hasattr(self, 'W_root') \
            else root_vecs
        hnode_emb = E_c(fnode[:, 0])
        hmess_input = torch.cat([hnode_emb[fmess[:, 0].long()],
                                 pos_onehot(fmess[:, 2])], dim=-1)
        h0, c0 = self.rnn.init_state(fmess.shape[0], init_vecs)
        S = torch.cat([h0, c0], dim=-1)
        mess, xid = plan['mess'].long(), plan['xid'].long()
        T = mess.shape[0]
        xp = self.rnn.x_proj(hmess_input)
        ks = self.rnn.k_h()
        bgraph_dec = tree['bgraph_dec'].long()
        agraph_dec = tree['agraph_dec'].long()
        nei_msgs = []
        for t in range(T):
            rows = mess[t]
            nei = S[bgraph_dec[rows]]
            new = self.rnn.step(xp[rows], nei.split(H, dim=-1), ks)
            upd = torch.where((rows > 0)[:, None], torch.cat(new, dim=-1), 0.0)
            S = S.index_put((rows,), upd)
            nei_msgs.append(S[agraph_dec[xid[t]], :H].sum(1))
        topo_vecs = F.relu(self.W_node(torch.cat(
            [hnode_emb[xid], torch.stack(nei_msgs)], dim=-1)))
        cls_vecs = S[mess, :H]
        return self._losses(plan, root_vecs, init_vecs, vocab_mask, topo_vecs,
                            cls_vecs)

    def _losses(self, plan, root_vecs, init_vecs, vocab_mask, topo_vecs,
                cls_vecs):
        """Topology BCE, motif and attachment cross-entropies and the
        closed-form assembly loss, summed and divided by the batch size,
        with the accuracies (reference decoder.py:289-409)."""
        B = root_vecs.shape[0]
        T = plan['active'].shape[0]
        latent_b = root_vecs[None].expand(T, B, -1)
        topo_logits = self.topoNN(torch.cat([topo_vecs, latent_b],
                                            dim=-1))[..., 0]
        topo_loss, topo_acc = topo_terms(topo_logits, plan)
        cls_loss, icls_loss, cls_acc, icls_acc = cls_terms(
            self.clsNN, self.iclsNN, plan, init_vecs, root_vecs, cls_vecs,
            latent_b, vocab_mask)

        # assembly loss in closed form: the gold candidate's score s
        # against nc real candidates of the same score and max_cls_size −
        # nc pad slots of score p (reference decoder.py:143, 360-409)
        emb = self._embed[1](plan['assm_icls'].long())      # [T, B, 2, E]
        pos = pos_onehot(plan['assm_nth'])[..., None, :].expand(
            *emb.shape[:-1], MAX_POS)
        v = F.relu(self.matchNN(torch.cat([emb, pos], dim=-1)))
        k_mask = torch.arange(2, device=v.device) < \
            plan['assm_n_icls'][..., None]
        mvec = (v * k_mask[..., None]).sum(dim=-2)
        s = (self.W_assm(mvec) * latent_b).sum(-1)
        p = (self.W_assm.bias * root_vecs).sum(-1)[None, :]
        nc = plan['assm_nc'].float()
        maxc = plan['max_cls_size'].float()
        m = torch.maximum(s, p)
        lse = torch.log(nc * torch.exp(s - m) + torch.clamp(maxc - nc, min=0)
                        * torch.exp(p - m) + 1e-12) + m
        has_assm = plan['has_assm'].float()
        assm_loss = ((lse - s) * has_assm).sum()
        n_assm = has_assm.sum()
        assm_acc = torch.where(
            n_assm > 0,
            ((((s >= p) | (nc >= maxc)) * has_assm).sum()
             / torch.clamp(n_assm, min=1)), torch.ones_like(n_assm))

        loss = (topo_loss + cls_loss + icls_loss + assm_loss) / B
        return loss, {'Word': cls_acc, 'I-Word': icls_acc, 'Topo': topo_acc,
                      'Assm': assm_acc}
