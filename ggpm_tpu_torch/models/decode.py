"""Batched autoregressive decoding: reconstruction and sampling (counterpart
of ``ggpm_tpu/models/decode.py``: ``hier_topk``, the exact motif path
``decode_motif``, ``decode_best`` and ``sample_prior``; the device-resident
turbo path and the hier family come later).

The host loop grows one junction tree and one molecule per sample
(``models/inc_graph.py``) and makes one device call per step,
``MotifDecoder.dec_step_fused``, on [B]-sized tables uploaded that step.
The call returns one packed array, fetched once: the only host sync of a
step.  Motif assembly and validity checks stay on the host, in the port's
pure-Python chemistry.  The assembly scorer is candidate-independent for the
motif decoder, so candidates are tried in the reference's stable
enumeration order with no device call.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.vocab import PairVocab, Vocab
from .inc_graph import IncGraph, IncTree


def _topk_small(x: torch.Tensor, k: int):
    """Top-k by k argmax passes: the JAX package's ``_topk_small``, whose
    ties break to the lowest index (``torch.argmax`` returns the first
    maximal index; ``torch.topk`` promises no order among ties)."""
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, i)[..., 0])
        idxs.append(i[..., 0])
        x = x.scatter(-1, i, float('-inf'))
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def hier_topk(cls_scores: torch.Tensor, icls_scores: torch.Tensor,
              mask: torch.Tensor, beam: int):
    """Joint coarse×fine top-k (reference nnutils.py:131-153) on the
    device: the best ``beam`` motifs, the best ``beam`` attachments of each
    under the vocab mask, and the best ``beam`` of those pairs.  Returns
    (scores, motif ids, attachment ids), each [B, beam]."""
    top_scores, top_cls = _topk_small(F.log_softmax(cls_scores, dim=-1), beam)
    icls_lsm = F.log_softmax(icls_scores[:, None, :] + mask[top_cls], dim=-1)
    iscores, itop = _topk_small(icls_lsm, beam)                 # [B, K, K]
    b = cls_scores.shape[0]
    flat = (top_scores[..., None] + iscores).reshape(b, beam * beam)
    fscores, fidx = _topk_small(flat, beam)
    cls_k = torch.gather(top_cls, -1, fidx // beam)
    icls_k = torch.gather(itop.reshape(b, beam * beam), -1, fidx)
    return fscores, cls_k, icls_k


def _pick_beam(greedy, beam, scores_row, rng):
    """Candidate visiting order: greedy rank order or score-weighted shuffle
    (reference decoder.py:1033)."""
    if greedy:
        return range(beam)
    prob = np.exp(scores_row - scores_row.max())
    prob = prob / prob.sum()
    return rng.choice(beam, size=beam, replace=False, p=prob)


def _forced_backtrack(tree, stack, b):
    """Pop the failed node and close the backtrack edges (reference
    decoder.py:1079-1089)."""
    child = stack[b].pop()
    top = stack[b][-1]
    tree.add_edge(child, top, (child, top, tree.in_degree(top)))
    child = stack[b].pop()
    if stack[b]:
        top = stack[b][-1]
        tree.add_edge(child, top, (child, top, tree.in_degree(top)))


def _try_assemble(tree, graph, vocab, b, new_node, fa_node, cls_beam,
                  cls_topk_row, icls_topk_row, log_entry):
    """Beam-retry motif assembly with chemical-validity rollback (reference
    decoder.py:1037-1077).  The motif decoder scores every candidate the
    same, so candidates are tried in the stable enumeration order; returns
    the committed ``(clab, ilab)`` on success (truthy), None on total
    failure."""
    try:
        for kk in cls_beam:
            clab, ilab = int(cls_topk_row[kk]), int(icls_topk_row[kk])
            tree.set_node_feature(new_node, (clab, ilab))
            ismiles = vocab.get_ismiles(ilab)
            fa_cluster, _, fa_used = tree.get_cluster(fa_node)
            inter_cands, _, attach_points = \
                graph.get_assm_cands(fa_cluster, fa_used, ismiles)
            if len(inter_cands) == 0:
                continue
            nth_child = 0 if len(inter_cands) == 1 else tree.in_degree(fa_node)
            for inter_label in inter_cands:
                pairs = list(zip(inter_label, attach_points))
                if graph.try_add_mol(b, ismiles, pairs):
                    new_atoms, new_bonds, attached = graph.add_mol(
                        b, ismiles, pairs, nth_child)
                    tree.register_cgraph(new_node, new_atoms, new_bonds,
                                         attached)
                    tree.update_attached(fa_node, pairs)
                    if log_entry is not None:
                        log_entry['Attaching Fragment'] = (
                            ismiles, attach_points, pairs)
                    return (clab, ilab)
    except Exception:
        # the reference's semantics: any failure of the chemistry on a
        # candidate ends this sample's attempt, which backtracks
        pass
    return None


def _upload(device: torch.device, *arrays: np.ndarray):
    """One host-to-device copy per host table, made this step: the host
    mutates its tables, so no device copy is kept."""
    return [torch.from_numpy(a).to(device) for a in arrays]


@torch.inference_mode()
def decode_motif(model, vocab: PairVocab, avocab: Vocab, root_vecs,
                 greedy: bool = True, max_decode_step: int = 150,
                 beam: int = 5, max_nodes: int = 400, max_edges: int = 500,
                 rng: Optional[np.random.Generator] = None,
                 log_steps: bool = True):
    """Decode a batch of latent vectors [B, latent] into molecules on the
    model's device (the exact path, JAX decode.py:1513).

    Returns (results, smiles_list); ``results[b]`` is a list of per-step log
    dicts mirroring the reference's ``results`` structure
    (decoder.py:924-948, 993, 1035-1036, 1072)."""
    rng = rng or np.random.default_rng(0)
    dec = model._decoder()
    device = next(dec.parameters()).device
    if not isinstance(root_vecs, torch.Tensor):
        root_vecs = torch.from_numpy(np.array(root_vecs, dtype=np.float32))
    root_vecs = root_vecs.to(device, torch.float32)
    mask = torch.from_numpy(vocab.mask).to(device)
    batch_size = root_vecs.shape[0]
    results = [[] for _ in range(batch_size)]

    tree = IncTree(batch_size, max_nodes=max_nodes, max_edges=max_edges)
    graph = IncGraph(avocab, batch_size, max_nodes=max_nodes,
                     max_edges=max_edges + 100)
    stack: List[List[int]] = [[] for _ in range(batch_size)]

    # --- root prediction (reference decoder.py:914-948) -------------------
    cls_scores, icls_scores = dec.dec_root_cls(root_vecs)
    root_cls = torch.argmax(cls_scores, dim=-1).cpu().numpy()
    icls_masked = icls_scores.cpu().numpy() + vocab.get_mask(root_cls)
    root_icls = icls_masked.argmax(axis=-1)

    for b in range(batch_size):
        r = {'root': vocab.get_smiles(int(root_cls[b]))}
        order = np.argsort(-icls_masked[b])[:5]
        r['top-5-root-attachments'] = [
            (vocab.get_ismiles(int(c)), float(icls_masked[b, c])) for c in order]
        r['Attaching Fragment'] = {'mol': int(root_cls[b]),
                                   'attachment': vocab.get_ismiles(int(root_icls[b]))}
        results[b].append(r)

    super_root = tree.add_node()
    for b in range(batch_size):
        clab, ilab = int(root_cls[b]), int(root_icls[b])
        root_idx = tree.add_node((clab, ilab))
        tree.add_edge(super_root, root_idx)
        stack[b].append(root_idx)
        root_smiles = vocab.get_ismiles(ilab)
        new_atoms, new_bonds, attached = graph.add_mol(b, root_smiles, [], 0)
        tree.register_cgraph(root_idx, new_atoms, new_bonds, attached)

    state = dec.dec_init_state(max_edges * batch_size, root_vecs)
    max_nb = tree.max_nb
    u_greedy = np.full(batch_size, 0.5, dtype=np.float32)

    for t in range(max_decode_step):
        for r in results:
            r.append({})
        batch_list = [b for b in range(batch_size) if stack[b]]
        if not batch_list:
            break

        # ---- both branches' step inputs, for one device call ------------
        v_clab = np.zeros(batch_size, dtype=np.int32)
        agraph_rows = np.zeros((batch_size, max_nb), dtype=np.int32)
        can_exp = np.zeros(batch_size, dtype=bool)
        new_rows = np.zeros(batch_size, dtype=np.int32)
        bt_valid = np.zeros(batch_size, dtype=bool)
        bt_pos = np.zeros(batch_size, dtype=np.int32)
        bt_bg = np.zeros((batch_size, max_nb), dtype=np.int32)
        first = tree.reserve_edges(len(batch_list))
        reserved = {}
        for r_i, b in enumerate(batch_list):
            v = stack[b][-1]
            row = first + r_i
            reserved[b] = row
            new_rows[b] = row
            v_clab[b] = tree.fnode[v, 0]
            agraph_rows[b] = tree.agraph[v]
            can_exp[b] = tree.can_expand(v)
            if len(stack[b]) >= 2:
                top = stack[b][-2]
                bt_valid[b] = True
                bt_pos[b] = min(tree.in_degree(top), 19)
                rev = tree.edge_dict.get((top, v), 0)
                bg = tree.agraph[v].copy()
                bg[bg == rev] = 0
                bt_bg[b] = bg
        u = u_greedy if greedy else rng.random(batch_size).astype(np.float32)

        d_clab, d_agraph, d_can, d_u, d_rows, d_btv, d_btpos, d_btbg = \
            _upload(device, v_clab, agraph_rows, can_exp, u, new_rows,
                    bt_valid, bt_pos, bt_bg)
        state, packed = dec.dec_step_fused(
            state, d_clab, d_agraph, d_can, d_u, d_rows, d_clab, d_agraph,
            d_btv, d_clab, d_btpos, d_btbg, root_vecs, mask, beam)
        packed = packed.cpu().numpy()      # the step's one host sync
        topo_p = 1.0 / (1.0 + np.exp(-packed[:, 0]))
        choose = packed[:, 1] > 0.5
        scores = packed[:, 2:2 + beam]
        cls_topk = packed[:, 2 + beam:2 + 2 * beam].astype(np.int32)
        icls_topk = packed[:, 2 + 2 * beam:2 + 3 * beam].astype(np.int32)

        # ---- replay the device's branch choice on the host tree ---------
        expand_bids = []
        for b in batch_list:
            results[b][-1]['Generate fragment'] = float(topo_p[b])
            row = reserved[b]
            if choose[b]:
                parent = stack[b][-1]
                new_node = tree.add_node()
                tree.add_edge(parent, new_node, (parent, new_node, 0), row=row)
                stack[b].append(new_node)
                expand_bids.append(b)
            else:
                child = stack[b].pop()
                if stack[b]:
                    top = stack[b][-1]
                    nth_child = tree.in_degree(top)
                    tree.add_edge(child, top, (child, top, nth_child), row=row)

        for b in expand_bids:
            new_node, fa_node = stack[b][-1], stack[b][-2]
            cls_beam = _pick_beam(greedy, beam, scores[b], rng)
            if log_steps:
                results[b][-1]['top-5-inter-cands'] = [
                    (vocab.get_smiles(int(x)), vocab.get_ismiles(int(y)), float(s))
                    for x, y, s in zip(cls_topk[b], icls_topk[b], scores[b])]
            ok = _try_assemble(tree, graph, vocab, b, new_node, fa_node,
                               cls_beam, cls_topk[b], icls_topk[b],
                               results[b][-1] if log_steps else None)
            if not ok:  # forced backtrack (reference decoder.py:1079-1089)
                _forced_backtrack(tree, stack, b)

    smiles_out = graph.get_smiles()
    while len(smiles_out) < batch_size:
        smiles_out.append(None)
    return results, smiles_out


def decode_best(model, vocab: PairVocab, avocab: Vocab, root_vecs,
                greedy: bool = True, log_steps: bool = False, **kwargs):
    """The JAX package's ``decode_best`` surface.  The motif family takes
    the exact path, which returns the JAX turbo path's SMILES
    (tests/test_decode.py pins the two equal)."""
    if type(model).__name__.startswith('Hier'):
        raise NotImplementedError('the port decodes the motif family only')
    # ``chunk`` pipelines the turbo path, which the port does not have yet
    kwargs.pop('chunk', None)
    return decode_motif(model, vocab, avocab, root_vecs, greedy=greedy,
                        log_steps=log_steps, **kwargs)


def sample_prior(model, vocab: PairVocab, avocab: Vocab, batch_size: int,
                 rng: Optional[np.random.Generator] = None,
                 latent_size: Optional[int] = None, **decode_kwargs):
    """Sample molecules from the prior N(0, I) over the latent space
    (reference HierVAE.sample, hpgnn.py:35-37 / HierPropertyVAE.sample,
    property_vae.py:35-37)."""
    rng = rng or np.random.default_rng(0)
    if latent_size is None:
        latent_size = model.cfg.latent_size
    z = rng.standard_normal((batch_size, latent_size)).astype(np.float32)
    return decode_best(model, vocab, avocab, z, greedy=True, **decode_kwargs)
