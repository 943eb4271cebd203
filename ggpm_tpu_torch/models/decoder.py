"""Motif decoder: the teacher-forced training path and the decode-step
functions (counterpart of ``ggpm_tpu/models/decoder.py``:
``scope_mask``, ``attend``, ``PredictionMLP``, ``MotifDecoder`` with its
``forward``/``mean_forward`` losses and their attention heads, the
scheduled-sampling ``scheduled_forward``, its ``dec_*`` API and the step
of the device-resident ``dec_propose``).

Training: ``forward`` runs the teacher-forced scan (``_run_scan``), which
carries only the message state, then the losses (``_losses``).  The scan's
frontier readouts come after it, as one ``nei_sum_t`` over the host-built
masked frontier table (``data.batching.frontier_table``): B1's fourth call
site, with the kernel's transpose as its backward.  ``scheduled_forward``
runs the same scan with the motif embeddings fed back from the model's
own predictions, and reads its frontier the same way (B1's site in JAX's
per-step readout, decoder.py:470).

Each decode step is one call of ``dec_step_fused`` on [B]-shaped inputs that
the host loop (``models/decode.py``) builds from its growing trees.  The
message state is the cell's tuple of ``[max_edges * B, H]`` buffers (``(h,)``
for the GRU, ``(h, c)`` for the LSTM) whose row 0 is the zero padding
message; ``dec_update`` writes the step's new rows in place.
The frontier readout of ``dec_topo`` goes through the ``nei_sum`` kernel.
The turbo decode's propose loop (``propose_step_``) runs the same steps on
the device for the whole decode, its tree and chemistry state included.

With tied embeddings the motif and attachment embeddings are owned by the
VAE and shared with the encoder (reference vae.py tie_embedding), so the
decoder holds them without registering them as its own parameters; untied,
it owns them as ``E_c_mod`` and ``E_i_mod`` (JAX decoder.py:99-102), and
every step reads its own.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from ..ops import nei_sum, nei_sum_t
from .decode import hier_topk
from .encoder import dropout, own_embeddings, pos_onehot
from .rnn import make_cell

State = Tuple[torch.Tensor, ...]


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


def scope_mask(scope: torch.Tensor, n_rows: int) -> torch.Tensor:
    """[B, N] membership mask: row n belongs to molecule b iff it lies in
    b's scope window (JAX decoder.py:43)."""
    ar = torch.arange(n_rows, device=scope.device)[None, :]
    return (ar >= scope[:, :1]) & (ar < scope[:, :1] + scope[:, 1:2])


def attend(src_mem: torch.Tensor, mask: torch.Tensor, query: torch.Tensor,
           A: nn.Linear) -> torch.Tensor:
    """Attention context over per-molecule source memory (JAX
    decoder.py:50): the scores of ``A(query)`` [..., B, latent] against
    every row of ``src_mem`` [N, latent], those outside the molecule's
    scope (``mask`` [..., B, N]) set to ``finfo(float32).min / 4`` before
    the softmax; returns [..., B, latent].  A row whose mask is all False
    (a padding slot) gets a uniform softmax, as in JAX."""
    scores = A(query) @ src_mem.t()
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min / 4)
    return torch.softmax(scores, dim=-1) @ src_mem


def _check_writers(buf: torch.Tensor, rows: torch.Tensor,
                   values: torch.Tensor, limit: Optional[int] = None) -> None:
    """On the CPU, raise if two writers of one row of ``buf`` write
    different values: ``index_put`` keeps one arbitrary writer of a
    repeated row on the card, which is sound only where they agree (row 0,
    written with zeros, and rows whose inputs coincide).  Rows at or above
    ``limit`` are a sink that nothing reads, and are not checked."""
    if buf.device.type == 'cpu' and rows.numel() > 1:
        if limit is not None:
            values = values[rows < limit]
            rows = rows[rows < limit]
        order = torch.argsort(rows, stable=True)
        r, v = rows[order], values[order]
        dup = (r[1:] == r[:-1]).nonzero().flatten()
        differ = v[dup] != v[dup + 1]
        if differ.dim() > 1:
            differ = differ.flatten(1).any(1)
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
             values: torch.Tensor, limit: Optional[int] = None
             ) -> torch.Tensor:
    """``buf`` with ``values`` written at ``rows``, out of place (JAX
    ``buf.at[rows].set(values)``), under ``scatter_rows_``'s rule; rows at
    or above ``limit`` are a sink (``_check_writers``)."""
    rows = rows.long()
    _check_writers(buf, rows, values, limit)
    return buf.index_put((rows,), values)


def drop_put_(buf: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
              limit: int) -> None:
    """JAX ``buf.at[idx].set(values, mode='drop')`` with out-of-bounds
    lanes pointing at or above ``limit``: ``buf`` holds a sink past
    ``limit`` (the row or elements it is allocated with beyond the
    table), which takes those lanes and which nothing reads; the other
    lanes under ``scatter_rows_``'s rule.  ``buf`` [N, ...] is indexed on
    its first dimension, ``idx`` [R] and ``values`` [R, ...]."""
    idx = idx.reshape(-1).long()
    values = values.reshape((idx.shape[0],) + buf.shape[1:]).to(buf.dtype)
    _check_writers(buf, idx, values, limit)
    buf.index_put_((idx,), values)


_STATE_KEYS = ('h', 'c')


def state_carry(prefix: str, state) -> Dict[str, torch.Tensor]:
    """A cell state's buffers as propose-carry entries: ``prefix + 'h'``
    and, for the LSTM, ``prefix + 'c'``."""
    return {prefix + k: s for k, s in zip(_STATE_KEYS, state)}


def carry_state(carry: Dict[str, torch.Tensor], prefix: str) -> State:
    """The cell state that ``state_carry`` put into ``carry``."""
    return tuple(carry[prefix + k] for k in _STATE_KEYS
                 if prefix + k in carry)


class MotifDecoder(nn.Module):
    """The JAX ``MotifDecoder``.  ``matchNN`` and ``W_assm`` score
    attachments in the training loss only.  With ``use_attention`` the
    topology, motif and assembly heads take their context from the
    encoder's node memory through ``A_topo``, ``A_cls`` and ``A_assm``
    (JAX decoder.py:116-120) where a caller passes that memory.

    ``sched_hook``, when set, is called at the end of ``scheduled_forward``
    with a dict: ``emb_buf``, the motif embeddings it fed its last step
    ([nodes, embed]); ``pred`` and ``margin`` [T, L], each step's motif
    prediction and the gap between its two largest logits; and ``use``
    [T, L], the lanes whose prediction was fed back."""
    sched_hook: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 latent_size: int, diterT: int = 1,
                 dropout_rate: float = 0.0, use_attention: bool = False,
                 rnn_type: str = 'LSTM', owned: bool = False):
        super().__init__()
        embed_size = E_c.embedding_dim
        own_embeddings(self, E_c, E_i, owned)
        self.hidden_size = hidden_size
        self.latent_size = latent_size
        self.diterT = diterT
        self.drop = dropout(dropout_rate)
        self.rnn = make_cell(rnn_type, embed_size + MAX_POS, hidden_size,
                             diterT)
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
        self.use_attention = use_attention
        if use_attention:
            self.A_topo = nn.Linear(hidden_size, latent_size)
            self.A_cls = nn.Linear(hidden_size, latent_size)
            self.A_assm = nn.Linear(hidden_size, latent_size)

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
                vocab_mask: torch.Tensor,
                src_mem: Optional[torch.Tensor] = None):
        """(loss, metrics) of a batch whose ``plan`` carries the frontier
        table (``data.batching.train_tables``); packed (``mol_lane``) or
        unpacked.  ``src_mem`` ([N, latent] encoder node memory) turns the
        attention heads on for a decoder built with them."""
        topo_vecs, cls_vecs, init_vecs = self._run_scan(tree, plan, root_vecs)
        return self._losses(plan, root_vecs, init_vecs, vocab_mask,
                            topo_vecs, cls_vecs, scope=tree['scope'],
                            src_mem=src_mem)

    def mean_forward(self, tree: Dict[str, torch.Tensor],
                     plan: Dict[str, torch.Tensor], root_vecs: torch.Tensor,
                     vocab_mask: torch.Tensor,
                     src_mem: Optional[torch.Tensor] = None):
        """``forward`` with the per-sample loss partition ([B]) as a third
        output (reference decoder.py:169-188)."""
        topo_vecs, cls_vecs, init_vecs = self._run_scan(tree, plan, root_vecs)
        return self._losses(plan, root_vecs, init_vecs, vocab_mask,
                            topo_vecs, cls_vecs, return_per_sample=True,
                            scope=tree['scope'], src_mem=src_mem)

    def _run_scan(self, tree, plan, root_vecs):
        """Teacher-forced state recurrence and readouts (reference
        decoder.py:190-287).  The loop carries only the cell's state
        concatenated, ``S = [h]`` or ``[h | c]``, over ``num_mess + B`` rows
        (the last B are the virtual root messages, wired to the latent);
        each step gathers its lanes' neighbour rows, applies the cell from
        hoisted x terms and writes the new rows out of place, as
        ``.at[rows].set`` does, with invalid lanes writing zeros to row 0.  One application per step
        reproduces any diterT >= 1 (the message DAG is acyclic).  The
        frontier readouts come after the loop: each row is written once,
        so the final state read through the masked ``plan['frontier']``
        equals the reference's per-step readout."""
        fnode, fmess = tree['fnode'], tree['fmess']
        H = self.hidden_size

        init_vecs = self.root_vecs_to_hidden(root_vecs)
        hnode_emb = self.drop(self._embed[0](fnode[:, 0]))
        hmess_input = torch.cat([hnode_emb[fmess[:, 0].long()],
                                 pos_onehot(fmess[:, 2])], dim=-1)

        S = self._scan_state(fmess.shape[0], init_vecs)
        mess = plan['mess'].long()
        T = mess.shape[0]
        valid = (mess > 0)[..., None]
        xp = self.rnn.x_proj(hmess_input)[mess]           # [T, L, kH]
        bg_rows = tree['bgraph_dec'][mess].long()         # [T, L, A]
        ks = self.rnn.k_h()
        for t in range(T):
            nei = S[bg_rows[t]]                           # [L, A, n·H]
            new = self.rnn.step(xp[t], nei.split(H, dim=-1), ks)
            upd = torch.where(valid[t], torch.cat(new, dim=-1), 0.0)
            S = S.index_put((mess[t],), upd)
        return self._readout(S, hnode_emb, plan) + (init_vecs,)

    def _scan_state(self, num_mess: int, init_vecs: torch.Tensor
                    ) -> torch.Tensor:
        """The scan's zero state, the cell's buffers side by side (``[h]``
        or ``[h | c]``) over ``num_mess + B`` rows, the last B rows' ``h``
        wired to the latent."""
        return torch.cat(self.rnn.init_state(num_mess, init_rows=init_vecs),
                         dim=-1)

    def _readout(self, S: torch.Tensor, hnode_emb: torch.Tensor,
                 plan: Dict[str, torch.Tensor]):
        """The scan's frontier and motif readouts from its final state:
        ``nei_sum_t`` over the masked frontier table (each row is written
        once, so the final state through the mask is the state each step
        read), then ``W_node``; and the rows each step wrote."""
        H = self.hidden_size
        xid, mess = plan['xid'].long(), plan['mess'].long()
        T, L = mess.shape
        h_final = S[:, :H].contiguous()
        nei_msg = nei_sum_t(h_final, plan['frontier'], plan['frontier_t'],
                            plan['frontier_tm']).view(T, L, H)
        topo_vecs = F.relu(self.W_node(torch.cat([hnode_emb[xid], nei_msg],
                                                 dim=-1)))
        return topo_vecs, h_final[mess]

    def scheduled_forward(self, tree: Dict[str, torch.Tensor],
                          plan: Dict[str, torch.Tensor],
                          root_vecs: torch.Tensor, vocab_mask: torch.Tensor,
                          tf_ratio: float = 1.0,
                          coins: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
        """Teacher forcing with scheduled sampling (JAX decoder.py:412-489;
        the repaired intent of the reference's MotifSchedulingDecoder).
        At each step, in each lane whose coin is set, the gold motif
        embedding of the node the step expands is replaced by the
        embedding of the model's own prediction, ``argmax clsNN([h of the
        new message | the lane's latent])``, so that later messages out of
        that node see the model's choice; the losses keep the gold labels.

        ``coins`` [T, L] (bool) are JAX's ``uniform(rng, (T, L)) >
        tf_ratio``; without them they are drawn from ``generator`` the same
        way, and at ``tf_ratio`` 1 none is set (nothing is drawn).  The
        prediction runs every step whatever the coins.  Each message row
        is written once, at its step, so the frontier readout comes after
        the loop, as ``_run_scan``'s (``_readout``): it equals JAX's
        per-step ``nei_sum(h, agraph[x_nodes])``.  The embeddings are a
        table over the nodes and a sink row past them: a lane whose coin
        is not set, or that expands nothing, writes the sink, so every
        node row has at most one writer a step (JAX writes such lanes'
        own values back, and resets row 0, which no valid lane writes)."""
        fnode, fmess = tree['fnode'], tree['fmess']
        n_nodes = fnode.shape[0]
        H = self.hidden_size
        E_c = self._embed[0]
        dev = root_vecs.device

        init_vecs = self.root_vecs_to_hidden(root_vecs)
        hnode_emb = self.drop(E_c(fnode[:, 0]))
        S = self._scan_state(fmess.shape[0], init_vecs)
        mess = plan['mess'].long()
        T, L = mess.shape
        if coins is None:
            coins = (torch.rand((T, L), generator=generator, device=dev)
                     > tf_ratio if tf_ratio < 1.0 else
                     torch.zeros((T, L), dtype=torch.bool, device=dev))
        mol_lane = plan.get('mol_lane')
        lane_mol = (mol_lane.long() if mol_lane is not None else
                    torch.arange(root_vecs.shape[0], device=dev)
                    .expand(T, L))
        valid = mess > 0
        src_all = fmess[:, 0].long()[mess]
        use = coins.bool() & plan['has_cls'].bool() & valid
        dst_w = torch.where(use, fmess[:, 1].long()[mess], n_nodes)
        pos_rows = pos_onehot(fmess[:, 2])[mess]          # [T, L, MAX_POS]
        bg_rows = tree['bgraph_dec'][mess].long()         # [T, L, A]
        ctx = root_vecs[lane_mol]                         # [T, L, latent]
        xw = self.rnn.x_weights(hnode_emb.shape[1] + MAX_POS)
        ks = self.rnn.k_h()
        emb_buf = torch.cat([hnode_emb, hnode_emb.new_zeros(
            (1, hnode_emb.shape[1]))])
        record = [] if self.sched_hook is not None else None
        for t in range(T):
            x = torch.cat([emb_buf[src_all[t]], pos_rows[t]], dim=-1)
            nei = S[bg_rows[t]]                           # [L, A, n·H]
            new = self.rnn.step(self.rnn.x_proj(x, xw), nei.split(H, dim=-1),
                                ks)
            v = valid[t][:, None]
            new = [torch.where(v, s, 0.0) for s in new]
            h = new[0]
            S = S.index_put((mess[t],), torch.cat(new, dim=-1))
            logits = self.clsNN(torch.cat([h, ctx[t]], dim=-1))
            pred = logits.argmax(-1)
            emb_buf = put_rows(emb_buf, dst_w[t], E_c(pred), limit=n_nodes)
            if record is not None:
                top2 = logits.detach().topk(2, dim=-1).values
                record.append((pred, top2[:, 0] - top2[:, 1]))
        if record is not None:
            self.sched_hook(dict(
                emb_buf=emb_buf[:n_nodes].detach(), use=use,
                pred=torch.stack([r[0] for r in record]),
                margin=torch.stack([r[1] for r in record])))
        topo_vecs, cls_vecs = self._readout(S, hnode_emb, plan)
        return self._losses(plan, root_vecs, init_vecs, vocab_mask,
                            topo_vecs, cls_vecs)

    def _losses(self, plan, root_vecs, init_vecs, vocab_mask, topo_vecs,
                cls_vecs, return_per_sample=False, scope=None, src_mem=None):
        """Topology BCE, motif and attachment cross-entropies (the
        attachment logits masked by the additive vocab mask) and the
        closed-form assembly loss, summed and divided by the batch size,
        with the accuracies (reference decoder.py:289-409).  With
        ``src_mem`` and the attention heads, each head's context is its
        query's attention over the memory rows of its molecule (``scope``,
        and ``mol_lane`` for a packed plan), the pad-slot score's a zero
        query's (JAX decoder.py:304-311, 360-365)."""
        batch_size = root_vecs.shape[0]
        active = plan['active']
        T, L = active.shape
        mol_lane = plan.get('mol_lane')
        if mol_lane is not None:
            mol_lane = mol_lane.long()
            latent_b = root_vecs[mol_lane]
        else:
            latent_b = root_vecs[None].expand(T, batch_size, -1)

        att = self.use_attention and src_mem is not None
        if att:
            mask = scope_mask(scope, src_mem.shape[0])
            mask_steps = mask[mol_lane] if mol_lane is not None else mask
            topo_ctx = attend(src_mem, mask_steps, topo_vecs, self.A_topo)
            root_cls_ctx = attend(src_mem, mask, init_vecs, self.A_cls)
            step_cls_ctx = attend(src_mem, mask_steps, cls_vecs, self.A_cls)
        else:
            topo_ctx, root_cls_ctx, step_cls_ctx = latent_b, root_vecs, \
                latent_b

        # topology loss (BCE with logits, summed over active steps)
        topo_logits = self.topo_logit(topo_ctx, topo_vecs)
        tlab = plan['tlab'].float()
        topo_bce = torch.clamp(topo_logits, min=0) - topo_logits * tlab + \
            torch.log1p(torch.exp(-torch.abs(topo_logits)))
        act_f = active.float()
        topo_loss = (topo_bce * act_f).sum()
        topo_pred = (topo_logits >= 0).long()
        topo_acc = ((topo_pred == plan['tlab'].long()) * active).sum() / \
            torch.clamp(active.sum(), min=1)

        # motif (cls + icls) loss: the B roots, then every expand step
        root_cls, root_icls = self.cls_logits(init_vecs, root_cls_ctx)
        step_cls, step_icls = self.cls_logits(cls_vecs, step_cls_ctx)
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
        if att:
            assm_ctx = attend(src_mem, mask_steps, mvec, self.A_assm)
            pad_ctx = attend(src_mem, mask, mvec.new_zeros(
                (batch_size, self.hidden_size)), self.A_assm)
        else:
            assm_ctx, pad_ctx = latent_b, root_vecs
        s = (self.W_assm(mvec) * assm_ctx).sum(-1)        # real-cand score
        p_mol = (self.W_assm.bias * pad_ctx).sum(-1)       # pad-slot score
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
        state = self.rnn.init_state(num_rows, root_vecs.device)
        state[0][1:root_vecs.shape[0] + 1] = self.root_vecs_to_hidden(
            root_vecs)
        return state

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

    def _dec_ctx(self, query: torch.Tensor, head: Optional[nn.Linear],
                 root_ctx: torch.Tensor, src_mem: Optional[torch.Tensor],
                 src_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """A decode head's context (JAX decoder.py:521): with encoder node
        memory and the attention heads, ``query``'s attention over the
        memory rows of its molecule (``src_mask`` [B, N]), as the training
        heads take it; otherwise the latent."""
        if self.use_attention and src_mem is not None:
            return attend(src_mem, src_mask, query, head)
        return root_ctx

    def dec_topo(self, state: State, v_clab: torch.Tensor,
                 agraph_rows: torch.Tensor, root_vecs: torch.Tensor,
                 src_mem: Optional[torch.Tensor] = None,
                 src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Frontier-node readout (the ``nei_sum`` kernel over the frontier's
        incoming messages, int32 ``agraph_rows`` [B, A]) and the topology
        logit (expand vs backtrack)."""
        nei = nei_sum(self.rnn.hidden(state), agraph_rows)
        node_h = F.relu(self.W_node(
            torch.cat([self._embed[0](v_clab), nei], dim=-1)))
        ctx = self._dec_ctx(node_h, getattr(self, 'A_topo', None), root_vecs,
                            src_mem, src_mask)
        return self.topo_logit(ctx, node_h)

    def dec_cls(self, state: State, rows: torch.Tensor,
                root_vecs: torch.Tensor, src_mem: Optional[torch.Tensor] = None,
                src_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Motif/attachment logits from the new expand messages."""
        h = self.rnn.hidden(state)[rows.long()]
        ctx = self._dec_ctx(h, getattr(self, 'A_cls', None), root_vecs,
                            src_mem, src_mask)
        return self.cls_logits(h, ctx)

    def dec_root_cls(self, root_vecs: torch.Tensor,
                     src_mem: Optional[torch.Tensor] = None,
                     src_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        init = self.root_vecs_to_hidden(root_vecs)
        ctx = self._dec_ctx(init, getattr(self, 'A_cls', None), root_vecs,
                            src_mem, src_mask)
        return self.cls_logits(init, ctx)

    def dec_step_fused(self, state: State, v_clab, agraph_rows, can_expand, u,
                       new_rows, exp_src_clab, exp_bg_rows, bt_valid,
                       bt_src_clab, bt_pos, bt_bg_rows, root_vecs, vocab_mask,
                       beam: int, src_mem: Optional[torch.Tensor] = None,
                       src_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[State, torch.Tensor]:
        """One decode step with both branches' inputs given (reference
        decoder.py:999-1004; JAX decoder.py:568).  The device picks per
        sample: expand iff sigmoid(topo) > u and the frontier can expand,
        else backtrack (a message row only if a backtrack edge exists).
        ``u`` is 0.5 for greedy decoding or a uniform sample; ``src_mem``
        and ``src_mask`` as ``_dec_ctx`` takes them.  Returns the
        state and one packed [B, 2 + 3·beam] f32 array (topo logit, choice,
        beam scores, motif and attachment ids), so that the host syncs once
        per step."""
        topo_logits = self.dec_topo(state, v_clab, agraph_rows, root_vecs,
                                    src_mem, src_mask)
        choose = (torch.sigmoid(topo_logits) > u) & can_expand
        rows = torch.where(choose | bt_valid, new_rows, 0)
        src_clab = torch.where(choose, exp_src_clab, bt_src_clab)
        pos = torch.where(choose, 0, bt_pos)
        bg = torch.where(choose[:, None], exp_bg_rows, bt_bg_rows)
        state = self.dec_update(state, rows, src_clab, pos, bg)
        cls_scores, icls_scores = self.dec_cls(state, rows, root_vecs,
                                               src_mem, src_mask)
        scores, cls_k, icls_k = hier_topk(cls_scores, icls_scores,
                                          vocab_mask, beam)
        packed = torch.cat(
            [topo_logits[:, None], choose.float()[:, None], scores,
             cls_k.float(), icls_k.float()], dim=1)
        return state, packed

    # -- device-resident decode: the propose loop (JAX decoder.py:614) -------
    # The JAX package runs the whole loop as one ``lax.while_loop``.  Here
    # the loop's carry is a dict of preallocated tensors that
    # ``propose_init_`` resets and ``propose_step_`` advances in place, so
    # that a step can be captured in a CUDA graph and replayed
    # (``models/decode.py:Proposer``, which also runs the loop eagerly).
    # A step makes no host sync: no ``.item()``, no ``nonzero``, no boolean
    # indexing, no host-to-device copy.  JAX's ``mode='drop'`` scatters
    # write to a sink column at index ``n_nodes`` of every per-node table
    # instead, which nothing reads.

    def propose_carry(self, batch_size: int, T: int, S: int, A: int,
                      max_nb: int, device) -> Dict[str, torch.Tensor]:
        """Zero carry of the propose loop for ``batch_size`` samples and a
        ``T``-step budget: the message state over ``1 + B·(T+1)`` rows, the
        per-node tables over ``T + 2`` nodes plus the sink column, the
        oracle's per-atom free valences over ``A`` atoms of ``S``-slot
        motifs, the stack, and the step counter ``t``.  The state's
        buffers are ``h`` and, for the LSTM, ``c`` (``state_carry``)."""
        n = T + 3                         # T + 2 nodes and the sink column
        B = batch_size

        def z(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)
        return dict(
            **state_carry('', self.rnn.init_state(1 + B * (T + 1), device)),
            clab=z(B, n), ilab=z(B, n),
            slot_used=z(B, n, S, dtype=torch.bool),
            atom_fv=z(B, A, dtype=torch.int32), slot_atom=z(B, n, S),
            atom_cnt=z(B), node_as2=z(B, n, dtype=torch.bool),
            node_noop=z(B, n, dtype=torch.bool), in_deg=z(B, n),
            agraph=z(B, n, max_nb, dtype=torch.int32), down_row=z(B, n),
            stack=z(B, n), sp=z(B), nxt=z(B), t=z(1), n_run=z(1),
            root_cls=z(B), root_icls=z(B),
            base=1 + torch.arange(B, device=device) * (T + 1),
            ar=torch.arange(B, device=device),
            sidx=torch.arange(S, device=device))

    def propose_init_(self, carry: Dict[str, torch.Tensor],
                      root_vecs: torch.Tensor, vocab_mask: torch.Tensor,
                      tabs: Dict[str, torch.Tensor]) -> None:
        """Reset ``carry`` to the loop's start for latents ``root_vecs``:
        the latent wired into each sample's first row, the root motif (the
        masked fine argmax, reference decoder.py:914-948) and its oracle
        state (JAX decoder.py:666-710)."""
        for s in carry_state(carry, ''):
            s.zero_()
        for k in ('clab', 'ilab', 'slot_used', 'atom_fv', 'slot_atom',
                  'node_as2', 'node_noop', 'in_deg', 'agraph', 'down_row',
                  'stack', 't', 'n_run'):
            carry[k].zero_()
        S = carry['slot_used'].shape[2]
        base = carry['base']
        init = self.root_vecs_to_hidden(root_vecs)
        carry['h'][base] = init
        cls_l, icls_l = self.cls_logits(init, root_vecs)
        root_cls = torch.argmax(cls_l, dim=-1)
        root_icls = torch.argmax(icls_l + vocab_mask[root_cls], dim=-1)
        carry['root_cls'].copy_(root_cls)
        carry['root_icls'].copy_(root_icls)
        carry['clab'][:, 0] = root_cls
        carry['ilab'][:, 0] = root_icls
        carry['slot_used'][:, 0] = tabs['bused'][root_icls]
        carry['atom_fv'][:, :S] = tabs['bfv'][root_icls]
        carry['slot_atom'][:, 0] = carry['sidx']
        carry['atom_cnt'].copy_(tabs['n_at'][root_icls])
        carry['node_noop'][:, 0] = tabs['noop'][root_icls]
        carry['in_deg'][:, 0] = 1
        carry['agraph'][:, 0, 0] = base.int()
        carry['down_row'][:, 0] = base
        carry['sp'].fill_(1)
        carry['nxt'].fill_(1)

    def propose_step_(self, carry: Dict[str, torch.Tensor],
                      root_vecs: torch.Tensor, vocab_mask: torch.Tensor,
                      u_seq: torch.Tensor, pin_op: torch.Tensor,
                      pin_clab: torch.Tensor, pin_ilab: torch.Tensor,
                      tabs: Dict[str, torch.Tensor], trace: torch.Tensor,
                      beam: int, T: int, max_nb: int = 12) -> None:
        """One step of the propose loop (JAX decoder.py:712-1023), in place:
        the frontier readout and topology choice, the message update, the
        joint top-k, the assembly oracle (the first beam candidate with a
        feasible attachment), the tree and chemistry bookkeeping.  Writes
        the step's packed row [B, 5 + 3·beam] into ``trace[t]``: zeros once
        no sample is active, as the JAX loop's early exit leaves them.
        The caller runs it for ``t < T`` only."""
        from .decode import hier_topk
        cy = carry
        ar, sidx, base = cy['ar'], cy['sidx'], cy['base']
        t = cy['t']
        S = sidx.shape[0]
        A = cy['atom_fv'].shape[1]
        n_nodes = cy['clab'].shape[1] - 1          # the sink's index
        sp, nxt, in_deg, stack = cy['sp'], cy['nxt'], cy['in_deg'], cy['stack']
        u = u_seq[t][0]
        p_op, p_clab, p_ilab = pin_op[t][0], pin_clab[t][0], pin_ilab[t][0]

        active = (sp > 0) & (t < T)
        any_active = active.any()
        v = stack[ar, (sp - 1).clamp(min=0)]
        v_clab = cy['clab'][ar, v]
        v_ag = cy['agraph'][ar, v]
        state = carry_state(cy, '')

        topo_logits = self.dec_topo(state, v_clab, v_ag, root_vecs)
        can_exp = in_deg[ar, v] < max_nb
        spec = (torch.sigmoid(topo_logits) > u) & can_exp
        free = p_op == 0
        top = stack[ar, (sp - 2).clamp(min=0)]
        # "attempt expand" covers both a commit and a predicted forced
        # backtrack: the oracle needs the expand message's top-k
        choose = torch.where(free, spec, (p_op == 1) | (p_op == 3)) & active
        bt_valid = active & ~choose & (sp >= 2)
        bt_pos = in_deg[ar, top].clamp(max=MAX_POS - 1)
        down_v = cy['down_row'][ar, v]
        bt_bg = torch.where(v_ag == down_v[:, None], 0, v_ag)

        row_t = base + 1 + t
        rows = torch.where(choose | bt_valid, row_t, 0)
        pos = torch.where(choose, 0, bt_pos)
        bg = torch.where(choose[:, None], v_ag, bt_bg)
        self.dec_update(state, rows, v_clab, pos, bg)
        cls_s, icls_s = self.dec_cls(state, rows, root_vecs)
        scores, cls_k, icls_k = hier_topk(cls_s, icls_s, vocab_mask, beam)

        # ---- assembly oracle: the parent's columns, then feas_for --------
        v_il = cy['ilab'][ar, v]
        pp = tabs['ppack'][v_il]                       # [B, 3 + 7S]
        p_n = pp[:, 0]
        p_ap = pp[:, 1:3]
        p_typ = pp[:, 3:3 + S]
        t_nxt = pp[:, 3 + S:3 + 2 * S]
        t_prv = pp[:, 3 + 2 * S:3 + 3 * S]
        ab_nxt = pp[:, 3 + 3 * S:3 + 4 * S]
        ab_prv = pp[:, 3 + 4 * S:3 + 5 * S]
        nxt_s = pp[:, 3 + 5 * S:3 + 6 * S].long()
        prv_s = pp[:, 3 + 6 * S:3 + 7 * S].long()
        p_used = cy['slot_used'][ar, v]                # [B, S], a copy
        p_slot_atom = cy['slot_atom'][ar, v]           # [B, S]
        p_fv = torch.gather(cy['atom_fv'], 1, p_slot_atom)
        p_as2 = cy['node_as2'][ar, v]
        p_noop = cy['node_noop'][ar, v]
        p_single = p_n <= 1

        s_valid = sidx[None, :] < p_n[:, None]
        fv2 = torch.gather(p_fv, 1, torch.cat([nxt_s, prv_s], dim=1))
        fv_nxt, fv_prv = fv2[:, :S], fv2[:, S:]
        ap0, ap1 = p_ap[:, 0:1], p_ap[:, 1:2]
        excl_f = p_as2[:, None] & (
            ((sidx[None, :] == ap0) & (nxt_s == ap1)) |
            ((sidx[None, :] == ap1) & (nxt_s == ap0)))
        excl_r = p_as2[:, None] & (
            ((sidx[None, :] == ap0) & (prv_s == ap1)) |
            ((sidx[None, :] == ap1) & (prv_s == ap0)))

        def first(mask):
            # the first True along the last axis (0 if none), as jnp.argmax
            # of a boolean array
            return torch.argmax(mask.to(torch.int32), dim=-1)

        def feas_for(c_il):
            """Feasibility and first-candidate slots of child icls
            ``c_il`` [B, Kc] against the parent's state (JAX
            decoder.py:787-861)."""
            cp = tabs['cpack'][c_il]                   # [B, Kc, 10]
            c_isz = cp[..., 0]
            c_fail, c_noop, c_sym = (cp[..., i].bool() for i in (1, 2, 3))
            c_t0, c_t1, c_n0, c_n1, c_apb = (cp[..., i, None]
                                             for i in (4, 5, 6, 7, 8))
            typ, fv = p_typ[:, None, :], p_fv[:, None, :]
            # 1-point: any unused, type-matching slot with free valence
            f1 = s_valid[:, None, :] & ~p_used[:, None, :] & \
                (typ == c_t0) & (fv >= c_n0)
            any1, first1 = f1.any(-1), first(f1)
            # 2-point forward pairs (s, s+1 mod n)
            ex_f = (ab_nxt[:, None, :] == 0) * c_apb
            pair_ok = s_valid[:, None, :] & (p_n[:, None, None] >= 2)
            ff = pair_ok & ~excl_f[:, None, :] & (typ == c_t0) & \
                (t_nxt[:, None, :] == c_t1) & (fv >= c_n0 + ex_f) & \
                (fv_nxt[:, None, :] >= c_n1 + ex_f)
            anyf, firstf = ff.any(-1), first(ff)
            # reverse pairs (a, a-1 mod n), enumerated from a = n-1 down
            ex_r = (ab_prv[:, None, :] == 0) * c_apb
            fr = pair_ok & ~excl_r[:, None, :] & (typ == c_t0) & \
                (t_prv[:, None, :] == c_t1) & (fv >= c_n0 + ex_r) & \
                (fv_prv[:, None, :] >= c_n1 + ex_r)
            anyr = fr.any(-1)
            lastr = S - 1 - first(torch.flip(fr, dims=(-1,)))
            use_rev = ~c_sym & ~anyf & anyr
            feas2 = anyf | (~c_sym & anyr)
            feas = ~c_fail & (c_noop | p_noop[:, None] |
                              ((c_isz == 1) & any1) | ((c_isz == 2) & feas2))
            is2 = (c_isz == 2) & ~c_noop & ~p_noop[:, None]
            slotA = torch.where(c_isz == 1, first1,
                                torch.where(use_rev, lastr, firstf))
            sel = (slotA + torch.where(use_rev, 0, S))[..., None]
            kc = c_il.shape[1]
            slotB = torch.gather(torch.cat([prv_s, nxt_s], dim=1)[:, None, :]
                                 .expand(-1, kc, -1), 2, sel)[..., 0]
            exA = torch.gather(torch.cat([ex_r, ex_f], dim=2), 2, sel)[..., 0]
            two = c_isz == 2
            extraA = c_n0[..., 0] + torch.where(two, exA, 0)
            extraB = c_n1[..., 0] + torch.where(two, exA, 0)
            return feas, slotA, slotB, extraA, extraB, is2

        # one oracle call for the beam and the pinned child (column beam)
        cand_il = torch.cat([icls_k, p_ilab[:, None]], dim=1)
        feas_all, slotA_all, slotB_all, exA_all, exB_all, is2_all = \
            feas_for(cand_il)
        feasible = feas_all[:, :beam]
        any_feas = feasible.any(dim=1)
        j_star = first(feasible)
        spec_clab = torch.gather(cls_k, 1, j_star[:, None])[:, 0]
        spec_ilab = torch.gather(icls_k, 1, j_star[:, None])[:, 0]

        # pinned expands commit the host's motif; free expands the first
        # feasible beam (beam 0 if none); an infeasible free expand is a
        # forced backtrack
        forced_free = free & choose & ~any_feas
        forced = ((p_op == 3) & active) | forced_free
        new_clab = torch.where(p_op == 1, p_clab,
                               torch.where(any_feas, spec_clab, cls_k[:, 0]))
        new_ilab = torch.where(p_op == 1, p_ilab,
                               torch.where(any_feas, spec_ilab, icls_k[:, 0]))

        # ---- expand and backtrack bookkeeping (sink column: dropped) -----
        nn_i = nxt.clamp(max=n_nodes - 1)
        i_ch = torch.where(choose, nn_i, n_nodes)
        row32 = row_t.int()
        cy['clab'][ar, i_ch] = new_clab
        cy['down_row'][ar, i_ch] = row_t
        cy['agraph'][ar, i_ch, 0] = row32
        in_deg.index_put_((ar, i_ch), torch.ones_like(nxt))  # no host scalar
        stack[ar, torch.where(choose, sp.clamp(max=n_nodes - 1), n_nodes)] = \
            nn_i
        # the closing edge joins top's agraph (host add_edge); read after
        # the new child's in-degree was set, as in the JAX step
        slot = in_deg[ar, top].clamp(max=max_nb - 1)
        cy['agraph'][ar, torch.where(bt_valid, top, n_nodes), slot] = row32
        # a forced backtrack closes new->v and v->top with zero messages:
        # only the in-degrees advance
        close_top = bt_valid | (forced & (sp >= 2))
        in_deg[ar, top] += close_top.long()
        in_deg[ar, v] += forced.long()

        push = choose & ~forced
        pop = active & ~choose
        sp += push.long() - pop.long() - forced.long()
        nxt += choose.long()

        # ---- chemistry-state bookkeeping on committed expands ------------
        commit = choose & ~forced
        cy['ilab'][ar, i_ch] = new_ilab
        j_commit = torch.where(p_op == 1, beam,
                               torch.where(any_feas, j_star, 0))[:, None]

        def sel_c(x):
            return torch.gather(x, 1, j_commit)[:, 0]
        c_feas, slotA, slotB = sel_c(feas_all), sel_c(slotA_all), \
            sel_c(slotB_all)
        exA, exB, is2 = sel_c(exA_all), sel_c(exB_all), sel_c(is2_all)
        bp = tabs['bpack'][new_ilab]                   # [B, 8 + 5S]
        ni_noop = bp[:, 2].bool()
        oracle_on = ~p_noop & ~ni_noop
        do_c = commit & c_feas & oracle_on
        do_pair = do_c & is2
        # a pinned commit the oracle deems infeasible: its state for this
        # node has drifted, stop predicting from it
        mispin = commit & ~c_feas & oracle_on
        node_noop = cy['node_noop']
        node_noop[ar, v] = node_noop[ar, v] | mispin

        # parent slots used (not for singleton parents); valence is paid on
        # the atoms, which parent and child share
        slot_used = cy['slot_used']
        cur_a = torch.gather(p_used, 1, slotA[:, None])[:, 0]
        cur_b = torch.gather(p_used, 1, slotB[:, None])[:, 0]
        slot_used[ar, v, slotA] = torch.where(do_c & ~p_single, True, cur_a)
        slot_used[ar, v, slotB] = torch.where(do_pair & ~p_single, True,
                                              cur_b)
        pa_a = torch.gather(p_slot_atom, 1, slotA[:, None])[:, 0]
        pa_b = torch.gather(p_slot_atom, 1, slotB[:, None])[:, 0]
        atom_fv = cy['atom_fv']
        atom_fv[ar, pa_a] += torch.where(do_c, -exA, 0).int()
        atom_fv[ar, pa_b] += torch.where(do_pair, -exB, 0).int()

        # the child: used flags at birth; its slot->atom map follows
        # add_mol's numbering (attach endpoints alias the parent's atoms,
        # every other slot a fresh sequential id)
        ch_used = torch.where(choose[:, None], bp[:, 8:8 + S].bool(),
                              slot_used[ar, nn_i])
        slot_used[ar, nn_i] = ch_used
        ch_ap = bp[:, 5:7]
        isz2c = bp[:, 1] >= 2
        ch_bfv = bp[:, 8 + S:8 + 2 * S]
        ch_new_atom = (cy['atom_cnt'][:, None] +
                       bp[:, 8 + 2 * S:8 + 3 * S]).clamp(max=A - 1)
        ch_atom = torch.where(
            sidx[None, :] == ch_ap[:, 0:1], pa_a[:, None],
            torch.where(isz2c[:, None] & (sidx[None, :] == ch_ap[:, 1:2]),
                        pa_b[:, None], ch_new_atom))
        slot_atom = cy['slot_atom']
        slot_atom[ar, nn_i] = torch.where(choose[:, None], ch_atom,
                                          slot_atom[ar, nn_i])
        # birth free valences of the new atoms only; every masked slot
        # writes to the sink atom A - 1, in no defined order among the
        # duplicates.  That is harmless while no real atom id reaches
        # A - 1 (ch_new_atom is clamped there): the sink is read only in
        # masked lanes.
        ch_valid = sidx[None, :] < bp[:, 0:1]
        wmask = do_c[:, None] & ch_valid & ~bp[:, 8 + 3 * S:8 + 4 * S].bool()
        wtgt = torch.where(wmask, ch_atom, A - 1)
        atom_fv[ar[:, None], wtgt] = ch_bfv
        n_new = bp[:, 0] - 1 - isz2c.long()
        cy['atom_cnt'] += torch.where(do_c, n_new.clamp(min=0), 0)
        # grafted onto an existing bond: add_mol records the anchor pair as
        # used (inc_graph.py:195-196); exA is extraA = needs0 + raw extra
        as2_child = do_pair & (bp[:, 3] > 0) & (exA == bp[:, 4])
        node_as2 = cy['node_as2']
        node_as2[ar, nn_i] = torch.where(choose, as2_child,
                                         node_as2[ar, nn_i])
        node_noop[ar, nn_i] = torch.where(
            choose, ni_noop | p_noop | (commit & ~do_c), node_noop[ar, nn_i])

        j_pack = torch.where(free & choose,
                             torch.where(any_feas, j_star, -1), 0)
        feas_bits = (feasible.long() << torch.arange(
            beam, device=feasible.device)).sum(dim=1)
        packed = torch.cat(
            [topo_logits[:, None], choose.float()[:, None], scores,
             cls_k.float(), icls_k.float(), j_pack.float()[:, None],
             new_ilab.float()[:, None], feas_bits.float()[:, None]], dim=1)
        trace.index_copy_(0, t, torch.where(any_active, packed, 0.0)[None])
        cy['n_run'] += any_active.long()
        t += 1
