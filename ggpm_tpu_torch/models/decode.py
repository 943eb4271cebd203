"""Batched autoregressive decoding: reconstruction and sampling (counterpart
of ``ggpm_tpu/models/decode.py``: ``hier_topk``, the exact motif path
``decode_motif``, the device-resident turbo path ``decode_motif_turbo``,
the exact hier path ``decode_hier``, its turbo path ``decode_hier_turbo``,
``decode_best`` and ``sample_prior``).

The exact path grows one junction tree and one molecule per sample
(``models/inc_graph.py``) and makes one device call per step,
``MotifDecoder.dec_step_fused``, on [B]-sized tables uploaded that step.
The call returns one packed array, fetched once: the only host sync of a
step.  Motif assembly and validity checks stay on the host, in the port's
pure-Python chemistry.  The assembly scorer is candidate-independent for the
motif decoder, so candidates are tried in the reference's stable
enumeration order with no device call.

The turbo path runs the whole loop on the device (``MotifDecoder.
propose_step_``, with a tensorised assembly oracle over ``_assm_tables``)
and fetches one decision trace per round, which the host replays with the
real chemistry (``_replay_pinned``); samples where the chemistry disagrees
re-enter the next round with their executed prefix pinned.  On the card a
``Proposer`` replays each step from a captured CUDA graph.  The hier
family's turbo path (``decode_hier_turbo``) runs its propose loop
(``HierDecoder.propose_step_``) the same way, through a ``HierProposer``,
and sends a sample whose replay diverges to the exact path whole.
``decode_best`` sends greedy decodes without per-step logs to the turbo
paths, as the JAX package does; each gives its exact path's SMILES.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.vocab import PairVocab, Vocab
from ..ops import add_replay, capture_record, captured_counts
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
                  cls_topk_row, icls_topk_row, log_entry, score_cands=None):
    """Beam-retry motif assembly with chemical-validity rollback (reference
    decoder.py:1037-1077).  ``score_cands(b, smiles, inter_cands,
    anchor_smiles, nth_child, ilab)`` orders a set of several candidates
    (the hier decoder scores them against its atom hiddens); without it
    they are tried in the stable enumeration order, the motif decoder's
    case, which scores every candidate the same.  Returns the committed
    ``(clab, ilab)`` on success (truthy), None on total failure."""
    try:
        for kk in cls_beam:
            clab, ilab = int(cls_topk_row[kk]), int(icls_topk_row[kk])
            tree.set_node_feature(new_node, (clab, ilab))
            ismiles = vocab.get_ismiles(ilab)
            fa_cluster, _, fa_used = tree.get_cluster(fa_node)
            inter_cands, anchor_smiles, attach_points = \
                graph.get_assm_cands(fa_cluster, fa_used, ismiles)
            if len(inter_cands) == 0:
                continue
            nth_child = 0 if len(inter_cands) == 1 else tree.in_degree(fa_node)
            if len(inter_cands) > 1 and score_cands is not None:
                inter_cands = score_cands(b, vocab.get_smiles(clab),
                                          inter_cands, anchor_smiles,
                                          nth_child, ilab)
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


def _check_no_attention(model, has_src: bool = False) -> None:
    """Refuse to decode a ``use_attention`` model without its encoder
    attention memory (JAX decode.py:167): its heads were trained on
    attention contexts.  Only the exact motif path threads the memory."""
    if model.cfg.use_attention and not has_src:
        raise NotImplementedError(
            'this decode path does not thread encoder attention memory: a '
            'model built with use_attention=True would be decoded with '
            'contexts its heads were never trained on (see ADVICE r2). '
            'For reconstruction, pass src_mem/src_scope from '
            'encode_attention_memory to decode_motif; prior sampling has '
            'no source molecule, so train without use_attention for it.')


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` (a tensor, an array or nested lists) on ``device`` as
    ``dtype``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device, dtype)


@torch.inference_mode()
def decode_motif(model, vocab: PairVocab, avocab: Vocab, root_vecs,
                 greedy: bool = True, max_decode_step: int = 150,
                 beam: int = 5, max_nodes: int = 400, max_edges: int = 500,
                 rng: Optional[np.random.Generator] = None,
                 log_steps: bool = True, src_mem=None, src_scope=None):
    """Decode a batch of latent vectors [B, latent] into molecules on the
    model's device (the exact path, JAX decode.py:1513).  ``src_mem`` and
    ``src_scope`` (from the model's ``encode_attention_memory``) decode a
    ``use_attention`` model: its topology and motif heads attend over the
    encoder's node memory as in training; such a model refuses to decode
    without them.

    Returns (results, smiles_list); ``results[b]`` is a list of per-step log
    dicts mirroring the reference's ``results`` structure
    (decoder.py:924-948, 993, 1035-1036, 1072)."""
    rng = rng or np.random.default_rng(0)
    _check_no_attention(model, has_src=src_mem is not None)
    dec = model._decoder()
    device = next(dec.parameters()).device
    root_vecs = _as_tensor(root_vecs, device, torch.float32)
    mask = torch.from_numpy(vocab.mask).to(device)
    src_mask = None
    if src_mem is not None:
        # not at the top: decoder.py imports this module
        from .decoder import scope_mask
        src_mem = _as_tensor(src_mem, device, torch.float32)
        src_mask = scope_mask(_as_tensor(src_scope, device),
                              src_mem.shape[0])
    batch_size = root_vecs.shape[0]
    results = [[] for _ in range(batch_size)]

    tree = IncTree(batch_size, max_nodes=max_nodes, max_edges=max_edges)
    graph = IncGraph(avocab, batch_size, max_nodes=max_nodes,
                     max_edges=max_edges + 100)
    stack: List[List[int]] = [[] for _ in range(batch_size)]

    # --- root prediction (reference decoder.py:914-948) -------------------
    cls_scores, icls_scores = dec.dec_root_cls(root_vecs, src_mem, src_mask)
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
            d_btv, d_clab, d_btpos, d_btbg, root_vecs, mask, beam, src_mem,
            src_mask)
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


# the hier decode's fixed widths (JAX ``decode_hier``'s defaults): the
# atoms (kn) and bond rows (ke) of a frontier cluster that a step
# refreshes, and the assembly candidates scored per case (cand_cap)
HIER_KN, HIER_KE, HIER_CAND_CAP = 32, 72, 24
# the last ``decode_hier`` call's device steps (``hdec_step_fused``: five
# ``nei_sum`` launches each) and ``hdec_assm`` calls, for profiling and
# chip_smoke.py's launch checks
HIER_STATS: dict = {}


def is_hier(model) -> bool:
    """Whether ``model`` is of the hier family (JAX ``api._is_hier``)."""
    return type(model).__name__.startswith('Hier')


@torch.inference_mode()
def decode_hier(model, vocab: PairVocab, avocab: Vocab, root_vecs,
                greedy: bool = True, max_decode_step: int = 150,
                beam: int = 5, max_nodes: int = 400, max_edges: int = 500,
                rng: Optional[np.random.Generator] = None,
                log_steps: bool = False):
    """Decode a batch of latent vectors [B, latent] with a hier model on
    its device (the exact path, JAX decode.py:334-605; reference
    HierMPNDecoder.decode, decoder.py:303-472).

    As ``decode_motif``, plus the atom level: each step's one device call,
    ``HierDecoder.hdec_step_fused``, refreshes the frontier cluster's atom
    hiddens (its first ``HIER_KE`` bond rows and ``HIER_KN`` atoms), and a
    set of several assembly candidates is ordered by ``hdec_assm``'s scores
    against them.  Greedy decodes score every sample's first attempt in one
    batched call a step (its first ``HIER_CAND_CAP`` candidates); retries
    score one case a call.  Returns (results, smiles_list); ``results[b]`` holds
    the per-step entries (the topology probability, and with
    ``log_steps`` the attached fragment)."""
    rng = rng or np.random.default_rng(0)
    _check_no_attention(model)
    kn, ke, cand_cap = HIER_KN, HIER_KE, HIER_CAND_CAP
    dec = model._decoder()
    device = next(dec.parameters()).device
    root_vecs = _as_tensor(root_vecs, device, torch.float32)
    mask = torch.from_numpy(vocab.mask).to(device)
    batch_size = root_vecs.shape[0]
    results = [[] for _ in range(batch_size)]

    tree = IncTree(batch_size, max_nodes=max_nodes, max_edges=max_edges,
                   max_sub_nodes=kn)
    graph = IncGraph(avocab, batch_size, max_nodes=max_nodes,
                     max_edges=max_edges + 100)
    stack: List[List[int]] = [[] for _ in range(batch_size)]

    # root prediction (reference decoder.py:313-324)
    cls_scores, icls_scores = dec.hdec_root_cls(root_vecs)
    root_cls = torch.argmax(cls_scores, dim=-1).cpu().numpy()
    icls_masked = icls_scores.cpu().numpy() + vocab.get_mask(root_cls)
    root_icls = icls_masked.argmax(axis=-1)

    super_root = tree.add_node()
    for b in range(batch_size):
        clab, ilab = int(root_cls[b]), int(root_icls[b])
        results[b].append({'root': vocab.get_smiles(clab),
                           'Attaching Fragment': {
                               'mol': clab,
                               'attachment': vocab.get_ismiles(ilab)}})
        root_idx = tree.add_node((clab, ilab))
        tree.add_edge(super_root, root_idx)
        stack[b].append(root_idx)
        new_atoms, new_bonds, attached = graph.add_mol(
            b, vocab.get_ismiles(ilab), [], 0)
        tree.register_cgraph(root_idx, new_atoms, new_bonds, attached)

    state = dec.hdec_init(max_edges * batch_size,
                          (max_edges + 100) * batch_size,
                          max_nodes * batch_size, max_nodes * batch_size,
                          root_vecs)
    max_nb, g_nb = tree.max_nb, graph.max_nb
    u_greedy = np.full(batch_size, 0.5, dtype=np.float32)

    def pack_cands(smiles, inter_cands, anchor_smiles, nth_child):
        icls_ids = np.zeros(2, dtype=np.int32)
        for j, a_s in enumerate(anchor_smiles[:2]):
            try:
                icls_ids[j] = vocab[(smiles, a_s)][1]
            except KeyError:
                pass
        cand_arr = np.zeros((cand_cap, 2), dtype=np.int32)
        use = inter_cands[:cand_cap]
        for j, c in enumerate(use):
            cand_arr[j, 0] = c[0]
            cand_arr[j, 1] = c[-1]
        return (cand_arr, icls_ids, min(len(anchor_smiles), 2),
                min(nth_child, 19), use)

    def order_cands(sc, use):
        order = np.argsort(-sc[:len(use)], kind='stable')
        return [list(use[j]) for j in order]

    def assm_scores(packs, bids):
        """``hdec_assm`` of the packed cases (one device call)."""
        cand, icls, n_icls, nth = _upload(
            device, np.stack([p[0] for p in packs]),
            np.stack([p[1] for p in packs]),
            np.array([p[2] for p in packs], dtype=np.int64),
            np.array([p[3] for p in packs], dtype=np.int64))
        ctx = root_vecs[torch.as_tensor(bids, device=device)]
        HIER_STATS['assm_calls'] += 1
        return dec.hdec_assm(state, cand, icls, n_icls, nth, ctx).cpu().numpy()

    HIER_STATS.update(steps=0, assm_calls=0)

    for t in range(max_decode_step):
        for r in results:
            r.append({})
        batch_list = [b for b in range(batch_size) if stack[b]]
        if not batch_list:
            break

        # ---- the frontier clusters' atom rows, and both branches' inputs
        g_rows = np.zeros((batch_size, ke), dtype=np.int32)
        g_nodes = np.zeros((batch_size, kn), dtype=np.int32)
        v_nodes = np.zeros(batch_size, dtype=np.int32)
        v_clab = np.zeros(batch_size, dtype=np.int32)
        v_ilab = np.zeros(batch_size, dtype=np.int32)
        v_cg = np.zeros((batch_size, kn), dtype=np.int32)
        v_ag = np.zeros((batch_size, max_nb), dtype=np.int32)
        can_exp = np.zeros(batch_size, dtype=bool)
        new_rows = np.zeros(batch_size, dtype=np.int32)
        bt_valid = np.zeros(batch_size, dtype=bool)
        bt_pos = np.zeros(batch_size, dtype=np.int32)
        bt_bg = np.zeros((batch_size, max_nb), dtype=np.int32)
        first = tree.reserve_edges(len(batch_list))
        reserved = {}
        for r_i, b in enumerate(batch_list):
            v = stack[b][-1]
            edges = tree.get_cluster_edges([v])[:ke]
            atoms = tree.get_cluster_nodes([v])[:kn]
            g_rows[b, :len(edges)] = edges
            g_nodes[b, :len(atoms)] = atoms
            row = first + r_i
            reserved[b] = row
            new_rows[b] = row
            v_nodes[b] = v
            v_clab[b] = tree.fnode[v, 0]
            v_ilab[b] = tree.fnode[v, 1]
            v_cg[b] = tree.cgraph[v][:kn]
            v_ag[b] = tree.agraph[v]
            can_exp[b] = tree.can_expand(v)
            if len(stack[b]) >= 2:
                top = stack[b][-2]
                bt_valid[b] = True
                bt_pos[b] = min(tree.in_degree(top), 19)
                rev = tree.edge_dict.get((top, v), 0)
                bg = tree.agraph[v].copy()
                bg[bg == rev] = 0
                bt_bg[b] = bg
        fr, fn = g_rows.reshape(-1), g_nodes.reshape(-1)
        u = u_greedy if greedy else rng.random(batch_size).astype(np.float32)

        (d_grows, d_gsrc, d_gbt, d_gnth, d_gbg, d_gnodes, d_gnav, d_gag,
         d_vnodes, d_vclab, d_vilab, d_vcg, d_vag, d_can, d_u, d_rows,
         d_btv, d_btpos, d_btbg) = _upload(
            device, g_rows, np.ascontiguousarray(
                graph.fmess[fr, 0].reshape(g_rows.shape)),
            np.ascontiguousarray(graph.fmess[fr, 1].reshape(g_rows.shape)),
            np.ascontiguousarray(graph.fmess[fr, 2].reshape(g_rows.shape)),
            np.ascontiguousarray(graph.bgraph[fr].reshape(batch_size, ke,
                                                          g_nb)),
            g_nodes, np.ascontiguousarray(
                graph.fnode[fn, 0].reshape(g_nodes.shape)),
            np.ascontiguousarray(graph.agraph[fn].reshape(batch_size, kn,
                                                          g_nb)),
            v_nodes, v_clab, v_ilab, v_cg, v_ag, can_exp, u, new_rows,
            bt_valid, bt_pos, bt_bg)
        state, packed = dec.hdec_step_fused(
            state, d_grows, d_gsrc, d_gbt, d_gnth, d_gbg, d_gnodes, d_gnav,
            d_gag, d_vnodes, d_vclab, d_vilab, d_vcg, d_vag, d_can, d_u,
            d_rows, d_vag, d_btv, d_btpos, d_btbg, root_vecs, mask, beam)
        HIER_STATS['steps'] += 1
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

        # greedy: every sample's first beam attempt with several candidates
        # is scored in one device call (a sample's enumeration does not
        # depend on the other samples' assemblies this step)
        prescored = {}
        if greedy:
            queue = []
            for b in expand_bids:
                fa_node = stack[b][-2]
                clab, ilab = int(cls_topk[b][0]), int(icls_topk[b][0])
                try:
                    smiles = vocab.get_smiles(clab)
                    fa_cluster, _, fa_used = tree.get_cluster(fa_node)
                    inter_cands, anchor_smiles, _ = graph.get_assm_cands(
                        fa_cluster, fa_used, vocab.get_ismiles(ilab))
                except Exception:
                    continue
                if len(inter_cands) > 1:
                    queue.append((b, ilab, pack_cands(
                        smiles, inter_cands, anchor_smiles,
                        tree.in_degree(fa_node))))
            if queue:
                sc = assm_scores([q[2] for q in queue], [q[0] for q in queue])
                for (b, ilab, pk), row in zip(queue, sc):
                    prescored[b] = (ilab, order_cands(row, pk[4]))

        for b in expand_bids:
            new_node, fa_node = stack[b][-1], stack[b][-2]
            cls_beam = _pick_beam(greedy, beam, scores[b], rng)
            pre = prescored.get(b)

            def scorer(bb, smiles, inter_cands, anchor_smiles, nth_child,
                       ilab_cur, _pre=pre):
                # the prescored order serves only the same attachment label
                # and candidate set: scores depend on the child's anchor
                # embeddings
                if _pre is not None and _pre[0] == ilab_cur and \
                        len(_pre[1]) == len(inter_cands) and \
                        sorted(map(tuple, _pre[1])) == \
                        sorted(map(tuple, inter_cands)):
                    return _pre[1]
                pk = pack_cands(smiles, inter_cands, anchor_smiles,
                                nth_child)
                return order_cands(assm_scores([pk], [bb])[0], pk[4])

            ok = _try_assemble(tree, graph, vocab, b, new_node, fa_node,
                               cls_beam, cls_topk[b], icls_topk[b],
                               results[b][-1] if log_steps else None,
                               score_cands=scorer)
            if not ok:  # forced backtrack (reference decoder.py:1079-1089)
                _forced_backtrack(tree, stack, b)

    smiles_out = graph.get_smiles()
    while len(smiles_out) < batch_size:
        smiles_out.append(None)
    return results, smiles_out


ORACLE_SLOTS = 24          # motifs larger than this get no-opinion treatment
ORACLE_ATOMS = 1024        # per-sample atom-id capacity of the device oracle
_FV_BIG = 63               # "unlimited valence" sentinel (max_valence == 0)

# diagnostics of the last ``decode_motif_turbo`` or ``decode_hier_turbo``
# call: the JAX package's keys (rounds, batch, fallbacks, pending per
# round, rungs) and, per dispatched round, the steps with a sample active
# (``steps``, the JAX loop's trip count), the steps the device ran
# (``steps_run``: up to the lookahead past ``steps``), and the host's
# seconds waiting for the trace (``wait_s``) and replaying it
# (``replay_s``); ``eager_steps`` counts the steps run outside the rounds:
# one before each graph's capture, and for the motif family the exact
# path's for samples that fell back (the hier family's are
# ``exact_steps``, and ``fallback_causes`` says why each fell back).  A motif step launches B1 once; a hier propose step
# four times, an exact hier step five times.
TURBO_STATS: dict = {}

# the turbo decode on the card, chosen by ``profile_serve.propose_sweep``
# (PERF.md, section 6): steps queued ahead of the host's last check of the
# loop's alive flag (one step a graph: a host check costs less than the
# idle steps a longer block runs past the loop's end), and the scan-length
# rungs below max_decode_step (none: the loop stops at the longest decode
# anyway, and a rung only adds rounds).  On the CPU a step is checked at
# once, and the ladder is the JAX package's CPU default.
CUDA_LOOKAHEAD = 1
CUDA_LADDER = ()
CPU_LADDER = (64,)
_PROPOSERS_MAX = 6         # captured graphs kept (rung x width)

_TABLES: Dict[int, tuple] = {}
_PROPOSERS: "OrderedDict" = OrderedDict()
_lock = threading.RLock()


def _assm_tables_np(vocab: PairVocab, avocab: Vocab) -> Dict[str, np.ndarray]:
    """Per-icls motif tables of the device-side assembly oracle (JAX
    decode.py:606-905, whose docstring describes every array): a
    tensorised model of ``IncGraph.get_assm_cands`` + ``try_add_mol``, the
    hier-decode columns, and the packed views ``cpack`` [V, 10], ``ppack``
    [V, 3 + 7S], ``bpack`` [V, 8 + 5S], ``apack`` and ``bondpack``."""
    from ..chem import get_mol_shared
    from ..chem.elements import max_valence
    from ..graph.chemutils import get_anchor_smiles
    from ..graph.mol_graph import bond_type_index
    from .inc_graph import is_anchor_self
    S = ORACLE_SLOTS
    n = vocab.size()[1]
    n_at = np.zeros(n, np.int32)
    isz_t = np.ones(n, np.int32)
    fail = np.zeros(n, bool)
    noop = np.zeros(n, bool)
    sym = np.zeros(n, bool)
    stype = np.full((n, S), -1, np.int32)
    bused = np.zeros((n, S), bool)
    bfv = np.zeros((n, S), np.int32)
    adj = np.zeros((n, S, S), np.int8)
    appos = np.zeros((n, 2), np.int32)
    apbond = np.zeros(n, np.int32)
    needs = np.zeros((n, 2), np.int32)
    ctype = np.full((n, 2), -1, np.int32)

    def type_idx(a):
        try:
            return avocab[(a.symbol, a.charge)]
        except KeyError:
            return -1

    def parse(i):
        try:
            return get_mol_shared(vocab.get_ismiles(i))
        except Exception:   # an unparseable motif: the oracle abstains
            return None

    for i in range(n):
        emol = parse(i)
        if emol is None:
            fail[i] = True
            noop[i] = True
            continue
        na = emol.num_atoms
        n_at[i] = min(na, S)
        if na > S:
            noop[i] = True
            continue
        types = [type_idx(a) for a in emol.atoms]
        if any(t < 0 for t in types):
            noop[i] = True
        stype[i, :na] = types
        for j, a in enumerate(emol.atoms):
            # birth-used: every atom but map-2 ones, and none of a singleton
            bused[i, j] = a.map_num != 2 and na > 1
            mv = max_valence(a.symbol, a.charge)
            if mv == 0:
                bfv[i, j] = _FV_BIG
            else:
                # grafted atoms keep symbol and charge only: no explicit Hs
                bonded = sum(b.order for b in emol.bonds
                             if b.a1 == j or b.a2 == j)
                bfv[i, j] = max(mv - bonded, 0)
        for b in emol.bonds:
            adj[i, b.a1, b.a2] = b.order
            adj[i, b.a2, b.a1] = b.order

        if na == 1:
            isz_t[i] = 1
            appos[i] = (0, 0)
            ctype[i] = (types[0], types[0])
            continue
        attach = [j for j, a in enumerate(emol.atoms) if a.map_num == 1]
        isz = len(attach)
        if isz == 1:
            a0 = a1 = attach[0]
        elif isz == 2:
            a0, a1 = attach
            try:
                s0 = get_anchor_smiles(emol, a0, by_index=True)
                s1 = get_anchor_smiles(emol, a1, by_index=True)
                sym[i] = s0 == s1
            except Exception:
                noop[i] = True
        else:
            anchors = [a for a in attach if is_anchor_self(emol, a, attach)]
            if len(anchors) != 2:
                fail[i] = True
                continue
            a0, a1 = anchors
            noop[i] = True           # >2-point attachment: oracle abstains
        isz_t[i] = max(isz, 1)
        appos[i] = (a0, a1)
        ctype[i] = (types[a0], types[a1])
        ap_set = set(attach)
        for b in emol.bonds:
            for (x, y) in ((b.a1, b.a2), (b.a2, b.a1)):
                if x in (a0, a1) and y not in ap_set:
                    needs[i, 0 if x == a0 else 1] += b.order
                    if isz == 1:
                        break            # single endpoint: count once
        apbond[i] = adj[i, a0, a1] if isz >= 2 else 0

    # newrank: each slot's rank among the motif's non-attach atoms, which
    # add_mol numbers in motif-atom order; is_att: an attachment endpoint
    newrank = np.zeros((n, S), np.int32)
    is_att = np.zeros((n, S), bool)
    for i in range(n):
        att = {int(appos[i, 0])}
        if isz_t[i] >= 2:
            att.add(int(appos[i, 1]))
        r = 0
        for j in range(S):
            if j in att and n_at[i] > 0:
                is_att[i, j] = True
            else:
                newrank[i, j] = r
                r += 1

    # the hier decode's columns (device-side add_mol and assembly scoring)
    BMAX = S + 6
    av = np.zeros((n, S), np.int32)
    map1 = np.zeros((n, S), bool)
    dst_att = np.zeros((n, S), bool)
    b_a = np.zeros((n, BMAX), np.int32)
    b_b = np.zeros((n, BMAX), np.int32)
    b_bt = np.zeros((n, BMAX), np.int32)
    b_anch = np.zeros((n, BMAX), bool)
    nbond = np.zeros(n, np.int32)
    a_icls = np.zeros((n, 2), np.int32)
    n_anch = np.ones(n, np.int32)
    poison = np.zeros(n, bool)
    for i in range(n):
        emol = parse(i)
        if emol is None or emol.num_atoms > S:
            poison[i] = True
            continue
        na = emol.num_atoms
        attach = [j for j, a in enumerate(emol.atoms) if a.map_num == 1]
        if na > 1 and len(attach) > 2:
            poison[i] = True
            continue
        for j, a in enumerate(emol.atoms):
            try:
                av[i, j] = avocab[(a.symbol, a.charge)]
            except KeyError:
                av[i, j] = 0
            map1[i, j] = a.map_num == 1
            dst_att[i, j] = is_att[i, j] or map1[i, j]
        ap = (int(appos[i, 0]), int(appos[i, 1]))
        for k, b in enumerate(emol.bonds[:BMAX]):
            b_a[i, k], b_b[i, k] = b.a1, b.a2
            b_bt[i, k] = bond_type_index(emol, b)
            b_anch[i, k] = isz_t[i] >= 2 and {b.a1, b.a2} == set(ap)
        nbond[i] = min(len(emol.bonds), BMAX)
        if len(emol.bonds) > BMAX:
            poison[i] = True
        smiles = vocab.vocab[i][0]
        isz = int(isz_t[i])
        if na == 1 or isz == 1:
            anchor_smi = [vocab.get_ismiles(i)]
        else:
            try:
                anchor_smi = [
                    get_anchor_smiles(emol, int(appos[i, 0]), by_index=True),
                    get_anchor_smiles(emol, int(appos[i, 1]), by_index=True)]
            except Exception:
                anchor_smi = []
                poison[i] = True
        n_anch[i] = min(len(anchor_smi), 2) or 1
        for k, a_s in enumerate(anchor_smi[:2]):
            try:
                a_icls[i, k] = vocab[(smiles, a_s)][1]
            except Exception:
                a_icls[i, k] = 0

    # packed views: one gather per index role in the propose step
    cpack = np.stack([isz_t, fail, noop, sym, ctype[:, 0], ctype[:, 1],
                      needs[:, 0], needs[:, 1], apbond, poison],
                     axis=1).astype(np.int32)
    sidx_np = np.arange(S)[None, :]
    pn_np = n_at[:, None]
    nxt_np = np.where(sidx_np + 1 >= pn_np, 0, sidx_np + 1).astype(np.int32)
    prv_np = np.where(sidx_np == 0, np.maximum(pn_np - 1, 0),
                      sidx_np - 1).astype(np.int32)
    adj32 = adj.astype(np.int32)
    ppack = np.concatenate(
        [np.stack([n_at, appos[:, 0], appos[:, 1]], axis=1), stype,
         np.take_along_axis(stype, nxt_np, 1),
         np.take_along_axis(stype, prv_np, 1),
         np.take_along_axis(adj32, nxt_np[:, :, None], 2)[:, :, 0],
         np.take_along_axis(adj32, prv_np[:, :, None], 2)[:, :, 0],
         nxt_np, prv_np], axis=1).astype(np.int32)
    bpack = np.concatenate(
        [np.stack([n_at, isz_t, noop, apbond, needs[:, 0], appos[:, 0],
                   appos[:, 1], nbond], axis=1),
         bused, bfv, newrank, is_att, av], axis=1).astype(np.int32)
    apack = np.concatenate([a_icls, n_anch[:, None]], axis=1).astype(np.int32)
    bondpack = np.stack([b_a, b_b, b_bt, b_anch.astype(np.int32)],
                        axis=2).astype(np.int32)
    return dict(
        n_at=n_at, isz=isz_t, fail=fail, noop=noop, sym=sym, stype=stype,
        bused=bused, bfv=bfv, adj=adj32, appos=appos, apbond=apbond,
        needs=needs, ctype=ctype, newrank=newrank, is_att=is_att, av=av,
        map1=map1, dst_att=dst_att, b_a=b_a, b_b=b_b, b_bt=b_bt,
        b_anch=b_anch, nbond=nbond, a_icls=a_icls, n_anch=n_anch,
        poison=poison, cpack=cpack, ppack=ppack, bpack=bpack, apack=apack,
        bondpack=bondpack)


def _vocab_entry(vocab: PairVocab, avocab: Vocab) -> dict:
    """The vocab's tables, built once and kept while the vocab lives (a
    weak reference: an id can be reused once its vocab has died), with
    their copies on each device."""
    with _lock:
        hit = _TABLES.get(id(vocab))
        if hit is not None and hit[0]() is vocab:
            return hit[1]
        for k in [k for k, (ref, _) in _TABLES.items() if ref() is None]:
            del _TABLES[k]
        entry = {'np': _assm_tables_np(vocab, avocab), 'device': {}}
        _TABLES[id(vocab)] = (weakref.ref(vocab), entry)
        return entry


def _assm_tables(vocab: PairVocab, avocab: Vocab, device='cpu'
                 ) -> Dict[str, torch.Tensor]:
    """``_assm_tables_np`` as tensors on ``device``, with the JAX package's
    keys and dtypes."""
    return _device_vocab(vocab, avocab, torch.device(device))[0]


def _device_vocab(vocab: PairVocab, avocab: Vocab, device: torch.device):
    """(oracle tables, vocab mask) on ``device``, built once per vocab."""
    entry = _vocab_entry(vocab, avocab)
    with _lock:
        hit = entry['device'].get(device)
        if hit is None:
            tabs = {k: torch.from_numpy(v).to(device)
                    for k, v in entry['np'].items()}
            hit = entry['device'][device] = (
                tabs, torch.from_numpy(vocab.mask).to(device))
        return hit


class Proposer:
    """The propose loop of one model and vocab at one rung length ``T`` and
    column width on one device: the counterpart of the JAX package's
    ``MotifDecodeKernel.propose`` (a jitted ``dec_propose``), which the
    turbo decode keeps per shape (``_proposer``).

    It owns the loop's carry, its inputs (latents, pins, and ``u`` = 0.5:
    the turbo path is greedy) and its trace as static tensors.  ``start``
    copies a round's inputs in and resets the carry; each ``run_step``
    advances one step and sets the ``alive`` flag (a sample still active
    and ``t < T``); ``outputs`` are the tensors a round returns.  With
    ``graph`` (CUDA tensors only) a step is one replay of a captured
    ``torch.cuda.CUDAGraph``; it is captured at construction, after one
    eager step on a side stream, and a failure raises.  Each replay adds
    the kernel launches its capture recorded to the wrappers' counts.
    Without it the step runs eagerly.  Steps past the last active one
    write zero rows."""

    def __init__(self, model, mask: torch.Tensor,
                 tabs: Dict[str, torch.Tensor], beam: int, T: int,
                 width: int, graph: bool, max_nb: int = 12):
        self.dec = model._decoder()
        self.mask, self.tabs, self.beam = mask, tabs, beam
        self.T, self.max_nb = T, max_nb
        device = mask.device
        self.rv = torch.zeros((width, self.dec.latent_size), device=device)
        self._alloc(width, device)
        self.alive = torch.zeros(1, dtype=torch.bool, device=device)
        self.graph = None
        self.replay_launches: list = []
        self.replay_launches_bf16: list = []
        if graph:
            self._capture()

    def _alloc(self, width: int, device) -> None:
        T = self.T
        self.u = torch.full((T, width), 0.5, device=device)  # greedy
        self.pins = torch.zeros((3, T, width), dtype=torch.int64,
                                device=device)
        self.carry = self.dec.propose_carry(
            width, T, self.tabs['stype'].shape[1], ORACLE_ATOMS, self.max_nb,
            device)
        self.trace = torch.zeros((T, width, 5 + 3 * self.beam), device=device)

    def _step(self) -> None:
        self.dec.propose_step_(
            self.carry, self.rv, self.mask, self.u, self.pins[0],
            self.pins[1], self.pins[2], self.tabs, self.trace, self.beam,
            self.T, self.max_nb)
        self._set_alive()

    def _set_alive(self) -> None:
        cy = self.carry
        self.alive.copy_((cy['sp'] > 0).any() & (cy['t'] < self.T))

    def _capture(self) -> None:
        if self.mask.device.type != 'cuda':
            raise ValueError('a CUDA graph needs CUDA tensors')
        self.dec.propose_init_(self.carry, self.rv, self.mask, self.tabs)
        side = torch.cuda.Stream(self.mask.device)
        side.wait_stream(torch.cuda.current_stream(self.mask.device))
        with torch.cuda.stream(side):
            self._step()         # builds and loads the kernels, warms caches
        torch.cuda.current_stream(self.mask.device).wait_stream(side)
        before = captured_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step()
        self.replay_launches, self.replay_launches_bf16 = capture_record(
            before)
        self.graph = graph

    def start(self, root_vecs: torch.Tensor, pins: np.ndarray) -> None:
        """Queue a round: latents [width, latent] on the device and pins
        [3, T, width] (op, clab, ilab) from the host."""
        self.rv.copy_(root_vecs)
        self.pins.zero_()
        if pins.any():
            src = torch.from_numpy(pins)
            if self.pins.is_cuda:
                src = src.pin_memory()
            self.pins.copy_(src, non_blocking=True)
        self.trace.zero_()
        self.dec.propose_init_(self.carry, self.rv, self.mask, self.tabs)

    def outputs(self) -> tuple:
        """(packed trace, root motifs, root attachments, steps active)."""
        cy = self.carry
        return self.trace, cy['root_cls'], cy['root_icls'], cy['n_run']

    def run_step(self) -> None:
        if self.graph is None:
            self._step()
            return
        self.graph.replay()
        add_replay(self.replay_launches, self.replay_launches_bf16)


class HierProposer(Proposer):
    """The hier family's propose loop (``HierDecoder.propose_step_``, the
    counterpart of the JAX package's ``HierDecodeKernel.propose``) at one
    rung length, width and set of ``budgets`` (atoms, bond rows, in-rows an
    atom, cluster rows a node), driven as ``Proposer`` drives the motif
    family's.  It takes no pins: a hier sample whose replay diverges falls
    back to the exact path whole.  Its outputs add the ``poisoned`` flags
    [width]."""

    def __init__(self, model, mask: torch.Tensor,
                 tabs: Dict[str, torch.Tensor], beam: int, T: int,
                 width: int, graph: bool, budgets: tuple):
        self.budgets = budgets
        super().__init__(model, mask, tabs, beam, T, width, graph)

    def _alloc(self, width: int, device) -> None:
        self.carry = self.dec.propose_carry(
            width, self.T, self.tabs['stype'].shape[1], *self.budgets,
            self.max_nb, device)
        self.trace = torch.zeros((self.T, width, 9 + 3 * self.beam),
                                 device=device)

    def _step(self) -> None:
        self.dec.propose_step_(self.carry, self.rv, self.mask, self.tabs,
                               self.trace, self.beam, max_nb=self.max_nb)
        self._set_alive()

    def start(self, root_vecs: torch.Tensor, pins=None) -> None:
        """Queue a round for latents [width, latent] on the device."""
        self.rv.copy_(root_vecs)
        self.trace.zero_()
        self.dec.propose_init_(self.carry, self.rv, self.mask, self.tabs)

    def outputs(self) -> tuple:
        """``Proposer.outputs`` and the ``poisoned`` flags."""
        return super().outputs() + (self.carry['poisoned'],)


def _proposer(cls, model, vocab: PairVocab, mask, tabs, beam: int, T: int,
              width: int, **kwargs) -> Proposer:
    """The proposer of class ``cls`` (``Proposer``, or ``HierProposer``
    with its ``budgets`` in ``kwargs``) of this shape, kept in a small LRU
    (each holds its carry and, on the card, a graph's memory pool), keyed
    like the JAX package's ``_get_kernel``; the entry keeps the model and
    vocab alive so that their ids are not reused.  A capture's eager step
    counts in ``TURBO_STATS['eager_steps']``."""
    cuda = mask.device.type == 'cuda'
    key = (cls, id(model), id(vocab), beam, T, width, str(mask.device),
           tuple(sorted(kwargs.items())))
    with _lock:
        hit = _PROPOSERS.get(key)
        if hit is not None:
            _PROPOSERS.move_to_end(key)
            return hit[0]
        prop = cls(model, mask, tabs, beam, T, width, graph=cuda, **kwargs)
        TURBO_STATS['eager_steps'] = TURBO_STATS.get('eager_steps', 0) + \
            cuda
        _PROPOSERS[key] = (prop, model, vocab)
        while len(_PROPOSERS) > _PROPOSERS_MAX:
            _PROPOSERS.popitem(last=False)
        return prop


class _Round:
    """One dispatched propose round: its steps run on the device while the
    host checks the alive flag of each, ``lookahead`` steps behind the
    newest queued; when a flag reads false, the trace is copied to pinned
    host memory (``non_blocking``) and a CUDA event marks its arrival."""

    def __init__(self, prop: Proposer, root_vecs: torch.Tensor,
                 pins: np.ndarray, lookahead: int):
        self.prop, self.rv, self.pins = prop, root_vecs, pins
        self.lookahead = lookahead
        self.cuda = prop.mask.device.type == 'cuda'
        self.started = self.finished = False
        self.queued = self.checked = 0
        self.flags: list = []
        self.out = self.done = None

    def _queue_step(self) -> None:
        p = self.prop
        p.run_step()
        self.queued += 1
        if self.cuda:
            flag = torch.empty(1, dtype=torch.bool, pin_memory=True)
            flag.copy_(p.alive, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self.flags.append((flag, ev))
        else:
            self.flags.append((bool(p.alive.item()), None))

    def advance(self, block: bool) -> bool:
        """Queue and check steps; returns True once the trace's copy is
        queued.  Without ``block`` it stops at the first flag that has not
        arrived yet."""
        if not self.started:
            self.started = True
            self.prop.start(self.rv, self.pins)
        T = self.prop.T
        while True:
            while self.queued < T and self.queued <= self.checked + \
                    self.lookahead:
                self._queue_step()
            flag, ev = self.flags[self.checked]
            if ev is not None:
                if not block and not ev.query():
                    return False
                ev.synchronize()
                flag = bool(flag[0])
            self.checked += 1
            if not flag or self.checked == T:
                self._finish()
                return True

    def _finish(self) -> None:
        outs = self.prop.outputs()
        if self.cuda:
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    for o in outs]
            for h, o in zip(host, outs):
                h.copy_(o, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            host, self.done = [o.clone() for o in outs], None
        self.out = host
        self.finished = True

    def result(self):
        """The proposer's ``outputs`` as numpy, once the copy has arrived:
        (packed [T, width, C], root_cls, root_icls, steps active, and the
        hier family's ``poisoned``)."""
        if self.done is not None:
            self.done.synchronize()
        packed, rc, ri, n_run, *rest = (o.numpy() for o in self.out)
        return (packed, rc, ri, int(n_run[0]), *rest)


class _RoundQueue:
    """Dispatched rounds, run on the device one after another in the order
    they were queued (one ``Proposer`` per shape is shared by the rounds,
    so they cannot overlap).  ``pump`` advances without waiting and is
    called by the host between the samples it replays, so the card works
    on the next round while the host replays the last; ``wait`` blocks
    until a round's trace is on the host."""

    def __init__(self):
        self.rounds: deque = deque()

    def submit(self, rnd: _Round) -> None:
        self.rounds.append(rnd)
        self.pump()

    def pump(self) -> None:
        while self.rounds and self.rounds[0].advance(block=False):
            self.rounds.popleft()

    def wait(self, rnd: _Round):
        while not rnd.finished:
            if self.rounds[0].advance(block=True):
                self.rounds.popleft()
        self.pump()              # start the next round before the fetch
        return rnd.result()


def propose_round(prop: Proposer, root_vecs: torch.Tensor, pins=None,
                  lookahead: Optional[int] = None):
    """One propose round of ``prop`` over ``root_vecs`` (and the motif
    family's ``pins``), driven as the turbo decodes drive a round (a
    ``_Round`` through a ``_RoundQueue``, ``lookahead`` steps ahead: by
    default the device's): the round's ``result`` and the steps it
    ran."""
    if lookahead is None:
        lookahead = CUDA_LOOKAHEAD if root_vecs.is_cuda else 0
    rnd = _Round(prop, root_vecs, pins, lookahead)
    queue = _RoundQueue()
    queue.submit(rnd)
    return queue.wait(rnd), rnd.queued


class _ReplayState:
    """Live single-sample chemistry state carried across turbo rounds (JAX
    decode.py:908): a re-entering sample's pinned prefix replays exactly
    as before, so the resolved state lives here and the next round's
    replay resumes at ``t = len(pins)``."""

    __slots__ = ('tree', 'graph', 'stack', 'pins', 'seeded')

    def __init__(self, vocab, avocab, max_nodes, max_edges, max_nb):
        self.tree = IncTree(1, max_nodes=max_nodes, max_edges=max_edges,
                            max_nb=max_nb)
        self.graph = IncGraph(avocab, 1, max_nodes=max_nodes,
                              max_edges=max_edges + 100)
        self.stack: List[int] = []
        self.pins: List[tuple] = []
        self.seeded = False


def _replay_pinned(trace_b, root_cls_b, root_icls_b, rs: _ReplayState,
                   vocab: PairVocab, beam: int, final: bool = True):
    """Replay one sample's device decision trace with real chemistry,
    resuming from ``rs`` (JAX decode.py:930-1010).  Pin ops: 1 = expand
    committing (clab, ilab), 2 = backtrack, 3 = expand then forced
    backtrack.  Returns ``('done', smiles)``; ``('diverge', None)`` when the
    chemistry committed another motif than the device (resolved the exact
    path's way and recorded as the last pin); or ``('continue', None)`` when
    a short rung's trace ran out with the stack alive and not ``final``."""
    tree, graph, stack = rs.tree, rs.graph, rs.stack

    if not rs.seeded:
        rs.seeded = True
        clab, ilab = int(root_cls_b), int(root_icls_b)
        super_root = tree.add_node()
        root_idx = tree.add_node((clab, ilab))
        tree.add_edge(super_root, root_idx)
        stack.append(root_idx)
        try:
            new_atoms, new_bonds, attached = graph.add_mol(
                0, vocab.get_ismiles(ilab), [], 0)
        except Exception:
            # an ungraftable root fragment: no root retry, no molecule
            return 'done', None
        tree.register_cgraph(root_idx, new_atoms, new_bonds, attached)

    T = trace_b.shape[0]
    for t in range(len(rs.pins), T):
        if not stack:
            break
        if trace_b[t, 1] > 0.5:
            parent = stack[-1]
            new_node = tree.add_node()
            tree.add_edge(parent, new_node, (parent, new_node, 0))
            stack.append(new_node)
            cls_topk = trace_b[t, 2 + beam:2 + 2 * beam].astype(np.int32)
            icls_topk = trace_b[t, 2 + 2 * beam:2 + 3 * beam].astype(np.int32)
            dev_j = int(trace_b[t, 2 + 3 * beam])   # -1: predicted op 3
            ok = _try_assemble(tree, graph, vocab, 0, new_node, parent,
                               range(beam), cls_topk, icls_topk, None)
            if ok is None:
                _forced_backtrack(tree, [stack], 0)
                rs.pins.append((3, int(cls_topk[0]), int(icls_topk[0])))
                if dev_j == -1:
                    continue      # the oracle predicted it
                return 'diverge', None
            rs.pins.append((1, int(ok[0]), int(ok[1])))
            if 0 <= dev_j < beam and int(cls_topk[dev_j]) == ok[0] \
                    and int(icls_topk[dev_j]) == ok[1]:
                continue          # the device committed the same motif
            return 'diverge', None
        child = stack.pop()
        if stack:
            top = stack[-1]
            tree.add_edge(child, top, (child, top, tree.in_degree(top)))
        rs.pins.append((2, 0, 0))
    if stack and not final:
        return 'continue', None
    smiles = graph.get_smiles()
    return 'done', (smiles[0] if smiles else None)


@torch.inference_mode()
def decode_motif_turbo(model, vocab: PairVocab, avocab: Vocab, root_vecs,
                       greedy: bool = True, max_decode_step: int = 150,
                       beam: int = 5, max_nodes: int = 400,
                       max_edges: int = 500,
                       rng: Optional[np.random.Generator] = None,
                       log_steps: bool = False, max_rounds: int = 16,
                       ladder: Optional[tuple] = None,
                       chunk: Optional[int] = None):
    """The device-resident speculative decode of the motif family (JAX
    decode.py:1014-1174).  Each round runs the whole loop on the device
    (``MotifDecoder.propose_step_``) and fetches one decision trace; the
    host replays it with the real chemistry.  Samples where the chemistry
    disagrees re-enter with their executed prefix pinned; after
    ``max_rounds`` rounds the rest take the exact path (counted in
    ``TURBO_STATS['fallbacks']``).  Stochastic decoding takes the exact
    path.

    ``ladder``: scan-length rungs below ``max_decode_step``; a sample whose
    stack outlives a short rung re-enters at a longer one.  ``None`` is
    ``CPU_LADDER`` on the CPU and ``CUDA_LADDER`` on the card.
    ``chunk``: decode in chunks of this many samples; every chunk's first
    round is queued before the first trace is fetched, and the card runs
    the next round while the host replays the last.

    Returns (results, smiles) like ``decode_motif``; per-step logs exist
    only for samples that fell back to the exact path."""
    if not greedy:
        return decode_motif(model, vocab, avocab, root_vecs, greedy=False,
                            max_decode_step=max_decode_step, beam=beam,
                            max_nodes=max_nodes, max_edges=max_edges,
                            rng=rng, log_steps=log_steps)
    _check_no_attention(model)
    device = next(model._decoder().parameters()).device
    root_vecs = _as_tensor(root_vecs, device, torch.float32)
    with _lock:
        return _turbo(model, vocab, avocab, root_vecs, device,
                      max_decode_step, beam, max_nodes, max_edges, rng,
                      log_steps, max_rounds, ladder, chunk)


def _turbo(model, vocab, avocab, root_vecs, device, T, beam, max_nodes,
           max_edges, rng, log_steps, max_rounds, ladder, chunk):
    cuda = device.type == 'cuda'
    batch_size = root_vecs.shape[0]
    tabs, mask = _device_vocab(vocab, avocab, device)
    if ladder is None:
        ladder = CUDA_LADDER if cuda else CPU_LADDER
    ahead = CUDA_LOOKAHEAD if cuda else 0

    states = [_ReplayState(vocab, avocab, max_nodes, max_edges, 12)
              for _ in range(batch_size)]
    smiles_out: List[Optional[str]] = [None] * batch_size
    results: List[list] = [[] for _ in range(batch_size)]
    TURBO_STATS.clear()
    TURBO_STATS.update(rounds=0, batch=batch_size, fallbacks=0,
                       pending_per_round=[], rungs=[], steps=[],
                       steps_run=[], eager_steps=0, wait_s=[], replay_s=[])
    rungs = sorted({min(r, T) for r in ladder} | {T})

    if chunk is None or chunk >= batch_size:
        chunk = batch_size
    chunks = [{'pending': list(range(i, min(i + chunk, batch_size))),
               'rnd': 0, 'size': chunk}
              for i in range(0, batch_size, chunk)]
    queue = _RoundQueue()

    def dispatch(ch):
        """Queue one propose round for a chunk."""
        pending, rnd = ch['pending'], ch['rnd']
        # the smallest rung every pending sample's pinned prefix fits
        # strictly under, else the full budget
        max_pins = max((len(states[b].pins) for b in pending), default=0)
        T_r = next((r for r in rungs if r > max_pins), T)
        ch['final'] = T_r == T
        TURBO_STATS['rungs'].append(T_r)
        # at most three widths per rung: the chunk's, a 16-wide straggler
        # width, and (padded up to the chunk's) a short last chunk
        n_p = len(pending)
        nb = 16 if (rnd and n_p <= 16 and ch['size'] > 16) else ch['size']
        cols = pending + [pending[0]] * (nb - n_p)
        pins = np.zeros((3, T_r, nb), dtype=np.int64)
        for j, b in enumerate(cols[:n_p]):
            for t, pin in enumerate(states[b].pins):
                pins[:, t, j] = pin
        prop = _proposer(Proposer, model, vocab, mask, tabs, beam, T_r, nb)
        rv = root_vecs.index_select(
            0, torch.as_tensor(cols, dtype=torch.int64, device=device))
        ch['round'] = _Round(prop, rv, pins, ahead)
        queue.submit(ch['round'])
        ch['cols'], ch['n_p'] = cols, n_p
        ch['rnd'] = rnd + 1
        TURBO_STATS['rounds'] = max(TURBO_STATS['rounds'], ch['rnd'])
        TURBO_STATS['pending_per_round'].append(n_p)

    inflight = deque()
    for ch in chunks:                 # every chunk's first round, then fetch
        dispatch(ch)
        inflight.append(ch)
    exhausted: List[int] = []
    while inflight:
        ch = inflight.popleft()
        t0 = time.perf_counter()
        packed, root_cls, root_icls, n_run = queue.wait(ch['round'])
        TURBO_STATS['wait_s'].append(time.perf_counter() - t0)
        TURBO_STATS['steps'].append(n_run)
        TURBO_STATS['steps_run'].append(ch['round'].queued)
        ch['round'] = None
        t0 = time.perf_counter()
        still = []
        for j, b in enumerate(ch['cols'][:ch['n_p']]):
            status, out = _replay_pinned(
                packed[:, j, :], root_cls[j], root_icls[j], states[b],
                vocab, beam, final=ch['final'])
            if status == 'done':
                smiles_out[b] = out
            else:         # 'diverge' or 'continue': the pins grew
                still.append(b)
            queue.pump()
        TURBO_STATS['replay_s'].append(time.perf_counter() - t0)
        ch['pending'] = still
        if not still:
            continue
        if ch['rnd'] >= max_rounds:
            exhausted += still
        else:
            dispatch(ch)
            inflight.append(ch)

    TURBO_STATS['fallbacks'] = len(exhausted)
    if exhausted:
        # the round cap: deep chains of divergences take the exact path
        res2, sm2 = decode_motif(
            model, vocab, avocab,
            root_vecs.index_select(0, torch.as_tensor(exhausted,
                                                      device=device)),
            greedy=True, max_decode_step=T, beam=beam, max_nodes=max_nodes,
            max_edges=max_edges, rng=rng, log_steps=log_steps)
        for j, b in enumerate(exhausted):
            smiles_out[b] = sm2[j]
            results[b] = res2[j]
        TURBO_STATS['eager_steps'] += decode_steps(res2)
    return results, smiles_out


# the hier turbo decode's per-sample budgets (JAX ``decode_hier_turbo``'s
# defaults): atoms, bond rows and in-rows an atom; a graft that would
# outrun one poisons its sample, which then takes the exact path
HIER_A_BUDGET, HIER_EG_BUDGET, HIER_NBG_BUDGET = 256, 384, 8


def hier_budgets(vocab: PairVocab, avocab: Vocab,
                 a_budget: int = HIER_A_BUDGET,
                 eg_budget: int = HIER_EG_BUDGET,
                 nbg_budget: int = HIER_NBG_BUDGET) -> tuple:
    """A ``HierProposer``'s budgets: atoms, bond rows, in-rows an atom, and
    cluster rows a node, KE = min(64, 2·max(nbond) + 2): a graft records
    two rows a motif bond, so that covers every trackable motif of the
    vocab (JAX decode.py:1373)."""
    nbond = _vocab_entry(vocab, avocab)['np']['nbond']
    return (a_budget, eg_budget, nbg_budget,
            min(64, 2 * int(nbond.max()) + 2))


def _hier_candidate(cluster, kind, slot):
    """The host's candidate atom run of the device's (kind, slot) code
    (JAX decode.py:1177): kind 0 a one-point or forward pair starting at
    ``slot``, kind 2 a reverse pair."""
    n = len(cluster)
    if n == 0:
        return None
    if kind == 2:
        return [cluster[slot % n], cluster[(slot - 1) % n]]
    return [cluster[slot % n], cluster[(slot + 1) % n]]


def _replay_hier(trace_b, root_cls_b, root_icls_b, vocab: PairVocab,
                 avocab: Vocab, beam: int, max_nodes: int, max_edges: int):
    """Replay one sample's hier trace with the real chemistry and check
    every assembly decision (JAX decode.py:1189-1332): that each beam the
    device skipped had no feasible candidate, that the device's
    feasibility bit of every enumerated candidate of the committed beam is
    ``try_add_mol``'s answer (an oracle false negative would change the
    best feasible candidate), and that the chosen candidate is feasible.
    Returns ('done', smiles) or ('diverge', None): a hier sample that
    diverges takes the exact path whole (its trace carries no candidate
    scores to resolve it)."""
    tree = IncTree(1, max_nodes=max_nodes, max_edges=max_edges, max_nb=12,
                   max_sub_nodes=32)
    graph = IncGraph(avocab, 1, max_nodes=max_nodes,
                     max_edges=max_edges + 100)
    stack: List[int] = []
    clab, ilab = int(root_cls_b), int(root_icls_b)
    super_root = tree.add_node()
    root_idx = tree.add_node((clab, ilab))
    tree.add_edge(super_root, root_idx)
    stack.append(root_idx)
    try:
        new_atoms, new_bonds, attached = graph.add_mol(
            0, vocab.get_ismiles(ilab), [], 0)
    except Exception:
        # an ungraftable root fragment: no molecule
        return 'done', None
    tree.register_cgraph(root_idx, new_atoms, new_bonds, attached)

    K = beam
    for t in range(trace_b.shape[0]):
        if not stack:
            break
        if not trace_b[t, 1] > 0.5:
            child = stack.pop()
            if stack:
                top = stack[-1]
                tree.add_edge(child, top, (child, top, tree.in_degree(top)))
            continue
        parent = stack[-1]
        new_node = tree.add_node()
        tree.add_edge(parent, new_node, (parent, new_node, 0))
        stack.append(new_node)
        cls_topk = trace_b[t, 2 + K:2 + 2 * K].astype(np.int32)
        icls_topk = trace_b[t, 2 + 2 * K:2 + 3 * K].astype(np.int32)
        dev_j = int(trace_b[t, 2 + 3 * K])
        kind = int(trace_b[t, 2 + 3 * K + 2])
        slot = int(trace_b[t, 2 + 3 * K + 3])

        def beam_has_valid(kk):
            try:
                ismiles = vocab.get_ismiles(int(icls_topk[kk]))
                fa_cluster, _, fa_used = tree.get_cluster(parent)
                cands, _, attach_points = graph.get_assm_cands(
                    fa_cluster, fa_used, ismiles)
                return any(graph.try_add_mol(0, ismiles,
                                             list(zip(list(c), attach_points)))
                           for c in cands[:HIER_CAND_CAP])
            except Exception:
                return False

        # the beams the device skipped must have no feasible assembly
        if any(beam_has_valid(kk) for kk in range(K if dev_j < 0 else dev_j)):
            return 'diverge', None
        if dev_j < 0:
            _forced_backtrack(tree, [stack], 0)
            continue
        clab_j, ilab_j = int(cls_topk[dev_j]), int(icls_topk[dev_j])
        try:
            ismiles = vocab.get_ismiles(ilab_j)
            tree.set_node_feature(new_node, (clab_j, ilab_j))
            fa_cluster, _, fa_used = tree.get_cluster(parent)
            cands, _, attach_points = graph.get_assm_cands(
                fa_cluster, fa_used, ismiles)
            # each enumerated candidate's (kind, slot) code: its real
            # feasibility must be the device's bit
            fmask = [int(trace_b[t, 2 + 3 * K + i]) for i in (4, 5, 6)]
            fc = list(fa_cluster)
            n_fc = len(fc)
            for c in cands[:HIER_CAND_CAP]:
                cl = list(c)
                if cl[0] not in fc:
                    return 'diverge', None
                s0 = fc.index(cl[0])
                if s0 >= ORACLE_SLOTS:
                    return 'diverge', None
                if len(cl) == 1:
                    dev_ok = (fmask[0] >> s0) & 1
                elif n_fc == 2:
                    # the forward and reverse runs of a 2-atom cluster
                    # coincide: the device may code the pair as either
                    dev_ok = ((fmask[1] | fmask[2]) >> s0) & 1
                elif cl[-1] == fc[(s0 + 1) % n_fc]:
                    dev_ok = (fmask[1] >> s0) & 1
                elif cl[-1] == fc[(s0 - 1) % n_fc]:
                    dev_ok = (fmask[2] >> s0) & 1
                else:
                    return 'diverge', None
                if bool(dev_ok) != graph.try_add_mol(
                        0, ismiles, list(zip(cl, attach_points))):
                    return 'diverge', None
            want = _hier_candidate(fc, kind, slot)
            chosen = None
            if want is not None:
                for c in cands[:HIER_CAND_CAP]:
                    cl = list(c)
                    if (len(cl) == 1 and cl[0] == want[0]) or \
                            (len(cl) >= 2 and cl[0] == want[0] and
                             cl[-1] == want[1]):
                        chosen = cl
                        break
            if chosen is None:
                return 'diverge', None
            pairs = list(zip(chosen, attach_points))
            if not graph.try_add_mol(0, ismiles, pairs):
                return 'diverge', None
            nth_child = 0 if len(cands) == 1 else tree.in_degree(parent)
            new_atoms, new_bonds, attached = graph.add_mol(
                0, ismiles, pairs, nth_child)
            tree.register_cgraph(new_node, new_atoms, new_bonds, attached)
            tree.update_attached(parent, pairs)
        except Exception:
            return 'diverge', None
    smiles = graph.get_smiles()
    return 'done', (smiles[0] if smiles else None)


def _unfinished(trace_b, beam: int) -> bool:
    """A short rung's trace ends with the sample's stack alive (its depth
    replayed from the choices and committed beams)."""
    depth = 1
    for row in trace_b:
        if depth <= 0:
            return False
        if row[1] > 0.5:
            depth += 1 if row[2 + 3 * beam] >= 0 else -1
        else:
            depth -= 1
    return depth > 0


@torch.inference_mode()
def decode_hier_turbo(model, vocab: PairVocab, avocab: Vocab, root_vecs,
                      greedy: bool = True, max_decode_step: int = 150,
                      beam: int = 5, max_nodes: int = 400,
                      max_edges: int = 500,
                      rng: Optional[np.random.Generator] = None,
                      log_steps: bool = False,
                      ladder: Optional[tuple] = None,
                      chunk: Optional[int] = None,
                      a_budget: int = HIER_A_BUDGET,
                      eg_budget: int = HIER_EG_BUDGET,
                      nbg_budget: int = HIER_NBG_BUDGET):
    """The device-resident speculative decode of the hier family (JAX
    decode.py:1335-1473).  Each round runs the whole loop on the device
    (``HierDecoder.propose_step_``, a ``HierProposer``: the three-level
    message passing, candidates scored against the live atom hiddens and
    the valence oracle, one CUDA graph replay a step on the card) and
    fetches one trace, which the host replays and checks with the real
    chemistry (``_replay_hier``).  A sample that is poisoned (it grafted a
    motif the device cannot track, or would outrun ``a_budget`` atoms,
    ``eg_budget`` bond rows, or its cluster rows) or whose replay
    diverges takes the exact path, ``decode_hier``, whole; a sample whose
    stack outlives a short rung re-enters at the next rung, from scratch.
    ``ladder`` and ``chunk`` as in ``decode_motif_turbo``.  Stochastic
    decoding and per-step logs take the exact path.

    ``TURBO_STATS`` holds the motif turbo's keys (``eager_steps`` counts
    the captures' eager steps), ``fallback_causes`` ([sample, 'poisoned'
    or 'diverged'] of each sample that fell back, in the order they did)
    and ``exact_steps``, the steps of the exact decode of the samples that
    fell back.  A propose step launches
    ``nei_sum`` four times, an exact step five times."""
    if not greedy or log_steps:
        return decode_hier(model, vocab, avocab, root_vecs, greedy=greedy,
                           max_decode_step=max_decode_step, beam=beam,
                           max_nodes=max_nodes, max_edges=max_edges, rng=rng,
                           log_steps=log_steps)
    _check_no_attention(model)
    device = next(model._decoder().parameters()).device
    root_vecs = _as_tensor(root_vecs, device, torch.float32)
    with _lock:
        return _hier_turbo(model, vocab, avocab, root_vecs, device,
                           max_decode_step, beam, max_nodes, max_edges, rng,
                           ladder, chunk, (a_budget, eg_budget, nbg_budget))


def _hier_turbo(model, vocab, avocab, root_vecs, device, T, beam, max_nodes,
                max_edges, rng, ladder, chunk, budgets):
    cuda = device.type == 'cuda'
    batch_size = root_vecs.shape[0]
    tabs, mask = _device_vocab(vocab, avocab, device)
    budgets = hier_budgets(vocab, avocab, *budgets)
    if ladder is None:
        ladder = CUDA_LADDER if cuda else CPU_LADDER
    ahead = CUDA_LOOKAHEAD if cuda else 0
    rungs = sorted({min(r, T) for r in ladder} | {T})

    smiles_out: List[Optional[str]] = [None] * batch_size
    results: List[list] = [[] for _ in range(batch_size)]
    fallback: List[int] = []
    TURBO_STATS.clear()
    TURBO_STATS.update(rounds=0, batch=batch_size, fallbacks=0,
                       fallback_causes=[], pending_per_round=[], rungs=[],
                       steps=[], steps_run=[], eager_steps=0, exact_steps=0,
                       wait_s=[], replay_s=[])
    if chunk is None or chunk >= batch_size:
        chunk = batch_size
    chunks = [{'pending': list(range(i, min(i + chunk, batch_size))),
               'ri': 0, 'size': chunk}
              for i in range(0, batch_size, chunk)]
    queue = _RoundQueue()

    def dispatch(ch):
        """Queue one propose round for a chunk at its rung."""
        pending, ri = ch['pending'], ch['ri']
        T_r = rungs[ri]
        TURBO_STATS['rungs'].append(T_r)
        TURBO_STATS['pending_per_round'].append(len(pending))
        TURBO_STATS['rounds'] = max(TURBO_STATS['rounds'], ri + 1)
        n_p = len(pending)
        nb = 16 if (ri and n_p <= 16 and ch['size'] > 16) else ch['size']
        cols = pending + [pending[0]] * (nb - n_p)
        prop = _proposer(HierProposer, model, vocab, mask, tabs, beam, T_r,
                         nb, budgets=budgets)
        rv = root_vecs.index_select(
            0, torch.as_tensor(cols, dtype=torch.int64, device=device))
        ch['round'] = _Round(prop, rv, None, ahead)
        queue.submit(ch['round'])
        ch['cols'], ch['n_p'], ch['final'] = cols, n_p, T_r == T

    inflight = deque()
    for ch in chunks:                 # every chunk's first round, then fetch
        dispatch(ch)
        inflight.append(ch)
    while inflight:
        ch = inflight.popleft()
        t0 = time.perf_counter()
        packed, root_cls, root_icls, n_run, poisoned = queue.wait(ch['round'])
        TURBO_STATS['wait_s'].append(time.perf_counter() - t0)
        TURBO_STATS['steps'].append(n_run)
        TURBO_STATS['steps_run'].append(ch['round'].queued)
        ch['round'] = None
        t0 = time.perf_counter()
        still = []
        for j, b in enumerate(ch['cols'][:ch['n_p']]):
            if poisoned[j]:
                fallback.append(b)
                TURBO_STATS['fallback_causes'].append([b, 'poisoned'])
            elif not ch['final'] and _unfinished(packed[:, j], beam):
                still.append(b)
            else:
                status, out = _replay_hier(packed[:, j], root_cls[j],
                                           root_icls[j], vocab, avocab, beam,
                                           max_nodes, max_edges)
                if status == 'done':
                    smiles_out[b] = out
                else:
                    fallback.append(b)
                    TURBO_STATS['fallback_causes'].append([b, 'diverged'])
            queue.pump()
        TURBO_STATS['replay_s'].append(time.perf_counter() - t0)
        if still:
            # the rungs end with T (final), so a chunk with samples still
            # alive always has a next rung
            ch['pending'] = still
            ch['ri'] += 1
            dispatch(ch)
            inflight.append(ch)

    TURBO_STATS['fallbacks'] = len(fallback)
    if fallback:
        res2, sm2 = decode_hier(
            model, vocab, avocab,
            root_vecs.index_select(0, torch.as_tensor(fallback,
                                                      device=device)),
            greedy=True, max_decode_step=T, beam=beam, max_nodes=max_nodes,
            max_edges=max_edges, rng=rng, log_steps=False)
        for j, b in enumerate(fallback):
            smiles_out[b] = sm2[j]
            results[b] = res2[j]
        TURBO_STATS['exact_steps'] = HIER_STATS['steps']
    return results, smiles_out


def decode_steps(results) -> int:
    """Device steps an exact decode made, from its per-step entries
    (``decode_motif``'s results, with or without logs): one for the root,
    one per step, and one empty entry more if the loop ended because every
    sample had finished."""
    n = len(results[0]) - 1
    return n - 1 if all(not r[-1] for r in results) else n


def decode_best(model, vocab: PairVocab, avocab: Vocab, root_vecs,
                greedy: bool = True, log_steps: bool = False, **kwargs):
    """The JAX package's ``decode_best``: greedy decodes without per-step
    logs take the family's turbo path (``decode_hier_turbo`` for the hier
    family, ``decode_motif_turbo`` otherwise; both take ``chunk``),
    everything else the exact one (``decode_hier`` / ``decode_motif``)."""
    if is_hier(model):
        if greedy and not log_steps:
            return decode_hier_turbo(model, vocab, avocab, root_vecs,
                                     greedy=True, **kwargs)
        kwargs.pop('chunk', None)
        return decode_hier(model, vocab, avocab, root_vecs, greedy=greedy,
                           log_steps=log_steps, **kwargs)
    if greedy and not log_steps:
        return decode_motif_turbo(model, vocab, avocab, root_vecs,
                                  greedy=True, **kwargs)
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
