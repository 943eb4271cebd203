"""Autoregressive motif decoder, its decode-step functions (counterpart of
``ggpm_tpu/models/decoder.py``: ``PredictionMLP``, ``MotifDecoder`` and its
``dec_*`` API; the teacher-forced training path, attention and the
device-resident ``dec_propose`` arrive with training and the turbo path).

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

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.mol_graph import MAX_POS
from ..ops import nei_sum
from .decode import hier_topk
from .encoder import pos_onehot
from .rnn import MPNLSTMCell

State = Tuple[torch.Tensor, torch.Tensor]


class PredictionMLP(nn.Module):
    """hidden→out two-layer head used by the topo/cls/icls predictors
    (reference decoder.py:492-511); layers named after the flax ones."""

    def __init__(self, input_size: int, hidden_size: int, out_size: int):
        super().__init__()
        self.Dense_0 = nn.Linear(input_size, hidden_size)
        self.Dense_1 = nn.Linear(hidden_size, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))


class MotifDecoder(nn.Module):
    """The modules of the JAX ``MotifDecoder`` that a checkpoint holds.
    ``matchNN`` and ``W_assm`` score attachments in the training loss only;
    they are kept so that every checkpoint leaf has its module."""

    def __init__(self, E_c: nn.Embedding, E_i: nn.Embedding, hidden_size: int,
                 latent_size: int, diterT: int = 1):
        super().__init__()
        embed_size = E_c.embedding_dim
        self._embed = (E_c, E_i)   # a tuple: not registered as submodules
        self.hidden_size = hidden_size
        self.diterT = diterT
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
