"""Fixed-shape batch assembly (copy of ``ggpm_tpu/data/batching.py``; the
lane packing of decode plans, ``compact_plan_dict``, arrives with training).

Converts host-side ``MolGraphBatch`` numpy tensors into (optionally
bucket-padded) arrays.  Padding to a small ladder of bucket shapes bounds the
number of distinct shapes a device program sees while wasting little compute.

Padding invariants: row/col padding of index tables is 0 (the padding
node/message); the decoder's virtual root-message slots (which index past the
real messages) are re-based when the message table grows.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..graph.mol_graph import DecodePlan, LevelTensors, MolGraphBatch
from ..ops.graph_ops import build_transpose


def _round_up(n: int, minimum: int = 32) -> int:
    """Round to the next power-of-two-ish bucket: {m, 2m, 4m, ...}."""
    size = max(n, minimum)
    bucket = minimum
    while bucket < size:
        bucket *= 2
    return bucket


def _pad2(a: np.ndarray, rows: int, cols: Optional[int] = None) -> np.ndarray:
    out_shape = (rows,) + ((cols,) if cols is not None else a.shape[1:])
    if a.ndim > 2 and cols is not None:
        out_shape = (rows, cols) + a.shape[2:]
    out = np.zeros(out_shape, dtype=a.dtype)
    sl = tuple(slice(0, s) for s in a.shape)
    out[sl] = a
    return out


def pad_level(lv: LevelTensors, n_nodes: int, n_mess: int, n_nb: int,
              n_cls: Optional[int] = None, batch_size: Optional[int] = None,
              n_nb_b: Optional[int] = None) -> LevelTensors:
    old_mess = lv.fmess.shape[0]
    fnode = _pad2(lv.fnode, n_nodes)
    fmess = _pad2(lv.fmess, n_mess)
    agraph = _pad2(lv.agraph, n_nodes, n_nb)
    # bgraph gets its OWN (usually narrower) width: it is gathered inside
    # the depth loop ``depth`` times per step, so its padding multiplies
    # into the loop's memory traffic
    bgraph = _pad2(lv.bgraph, n_mess, n_nb_b or n_nb)
    out = LevelTensors(fnode=fnode, fmess=fmess, agraph=agraph, bgraph=bgraph,
                       scope=lv.scope.copy())
    if lv.cgraph is not None:
        out.cgraph = _pad2(lv.cgraph, n_nodes, n_cls or lv.cgraph.shape[1])
    if lv.agraph_dec is not None:
        agraph_dec = _pad2(lv.agraph_dec, n_nodes, n_nb)
        bgraph_dec = _pad2(lv.bgraph_dec, n_mess, n_nb)
        # re-base virtual root-message slots past the padded message table
        shift = n_mess - old_mess
        agraph_dec[agraph_dec >= old_mess] += shift
        bgraph_dec[bgraph_dec >= old_mess] += shift
        out.agraph_dec = agraph_dec
        out.bgraph_dec = bgraph_dec
    return out


def pad_plan(plan: DecodePlan, n_steps: int, cand_width: int) -> DecodePlan:
    """Pad step count and candidate/cluster table widths.  ``max_cls_size``
    itself stays exact — inflating it would add pad slots to the assembly
    cross-entropy, changing the loss."""
    def padT(a, width=None):
        shape = [n_steps] + list(a.shape[1:])
        if width is not None:
            shape[2] = max(width, shape[2])
        out = np.zeros(tuple(shape), dtype=a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    def padT_opt(a, width=None):
        return None if a is None else padT(a, width)

    return DecodePlan(
        active=padT(plan.active), xid=padT(plan.xid), mess=padT(plan.mess),
        tlab=padT(plan.tlab), has_cls=padT(plan.has_cls), clab=padT(plan.clab),
        ilab=padT(plan.ilab), has_assm=padT(plan.has_assm),
        assm_nc=padT(plan.assm_nc), assm_icls=padT(plan.assm_icls),
        assm_n_icls=np.maximum(padT(plan.assm_n_icls), 1),
        assm_nth=padT(plan.assm_nth),
        root_clab=plan.root_clab, root_ilab=plan.root_ilab,
        max_cls_size=plan.max_cls_size,
        gstep_nodes=padT_opt(plan.gstep_nodes, 32),
        gstep_mess=padT_opt(plan.gstep_mess, 80),
        assm_cands=padT_opt(plan.assm_cands, cand_width),
        assm_cand_ok=padT_opt(plan.assm_cand_ok, cand_width))


# Joint size-class base shapes: every batch pads to BASE × 2^k for the
# smallest k covering all of its data-proportional dims: one shape signature
# per size class (independent per-dim rounding multiplies signatures).
_BASE = {'nt': 32, 'mt': 64, 'ng': 128, 'mg': 256, 'ts': 16}


def pad_batch(mb: MolGraphBatch) -> MolGraphBatch:
    """Pad a MolGraphBatch to joint bucket shapes (pure numpy, host-side)."""
    t, g, p = mb.tree, mb.graph, mb.plan
    need = {'nt': t.fnode.shape[0], 'mt': t.fmess.shape[0],
            'ng': g.fnode.shape[0], 'mg': g.fmess.shape[0]}
    f = 1
    for key, base in _BASE.items():
        if key == 'ts':
            continue
        while base * f < need[key]:
            f *= 2
    # intermediate ladder rung: if 3/4 of the power-of-two factor still
    # fits every dim, take it (bases are multiples of 4, so dims stay
    # integral) — caps padding waste at ~33% instead of ~100% for sizes
    # just past a power of two, at the cost of one extra bucket signature
    if f >= 4 and all(_BASE[k] * f * 3 // 4 >= need[k]
                      for k in need):
        dims = {k: _BASE[k] * f * 3 // 4 for k in _BASE}
    else:
        dims = {k: _BASE[k] * f for k in _BASE}
    # the decode-plan scan EXECUTES every padded step, so its length gets
    # its own fine-grained bucket (multiple of 32) instead of riding the
    # joint power-of-two factor
    dims['ts'] = max(32, -(-p.active.shape[0] // 32) * 32)
    # widths are data-bounded, not size-proportional: fixed small ladder.
    # bgraph (the in-loop gather table) rounds to a multiple of 2 with
    # minimum 4 — molecule graphs have max in-degree 3-4, and the loop's
    # gather traffic scales linearly with this width; agraph and the
    # decoder's incremental tables keep the coarser min-8 bucket (used
    # once per encode / sized for decode-time appends).
    def _round2(n: int, minimum: int = 4) -> int:
        return max(minimum, (n + 1) // 2 * 2)
    at = _round_up(max(t.agraph.shape[1], t.bgraph.shape[1]), minimum=8)
    bt_w = min(_round2(t.bgraph.shape[1]), at)
    ct = _round_up(t.cgraph.shape[1], minimum=16)
    ag = _round_up(max(g.agraph.shape[1], g.bgraph.shape[1]), minimum=8)
    bg_w = min(_round2(g.bgraph.shape[1]), ag)
    tree = pad_level(t, dims['nt'], dims['mt'], at, ct, n_nb_b=bt_w)
    graph = pad_level(g, dims['ng'], dims['mg'], ag, n_nb_b=bg_w)
    cand_w = _round_up(p.assm_cands.shape[2] if p.assm_cands is not None
                       else 16, minimum=16)
    plan = pad_plan(p, dims['ts'], cand_w)
    return MolGraphBatch(smiles=mb.smiles, tree=tree, graph=graph, plan=plan,
                         homos=mb.homos, lumos=mb.lumos)


def level_to_dict(lv: LevelTensors) -> Dict[str, np.ndarray]:
    d = {'fnode': lv.fnode, 'fmess': lv.fmess, 'agraph': lv.agraph,
         'bgraph': lv.bgraph, 'scope': lv.scope}
    # host-precomputed bgraph transpose: lets the depth loop's gather
    # backward be a dense gather instead of a scatter-add
    # (ops.build_transpose).  Width bound: message m recurs deg(dst(m))-1
    # times ≤ bgraph's own neighbour width, so k = bgraph.shape[1] is a
    # static bound and the table shape tracks the bucket dims.
    d['bgraph_t'], d['bgraph_tm'] = build_transpose(
        lv.bgraph, lv.bgraph.shape[0], k=lv.bgraph.shape[1])
    if lv.cgraph is not None:
        d['cgraph'] = lv.cgraph
    if lv.agraph_dec is not None:
        d['agraph_dec'] = lv.agraph_dec
        d['bgraph_dec'] = lv.bgraph_dec
    return d


def plan_to_dict(plan: DecodePlan) -> Dict[str, np.ndarray]:
    return {
        'active': plan.active, 'xid': plan.xid.astype(np.int32),
        'mess': plan.mess.astype(np.int32), 'tlab': plan.tlab,
        'has_cls': plan.has_cls, 'clab': plan.clab, 'ilab': plan.ilab,
        'has_assm': plan.has_assm, 'assm_nc': plan.assm_nc,
        'assm_icls': plan.assm_icls, 'assm_n_icls': plan.assm_n_icls,
        'assm_nth': plan.assm_nth, 'root_clab': plan.root_clab,
        'root_ilab': plan.root_ilab,
        'max_cls_size': np.asarray(plan.max_cls_size, dtype=np.int32),
        **({'gstep_nodes': plan.gstep_nodes, 'gstep_mess': plan.gstep_mess,
            'assm_cands': plan.assm_cands, 'assm_cand_ok': plan.assm_cand_ok}
           if plan.gstep_nodes is not None else {}),
    }


def to_model_batch(mb: MolGraphBatch, vocab_mask: np.ndarray,
                   pad: bool = True) -> Dict:
    """Assemble the dict consumed by the VAE models."""
    if pad:
        mb = pad_batch(mb)
    return {
        'tree': level_to_dict(mb.tree),
        'graph': level_to_dict(mb.graph),
        'plan': plan_to_dict(mb.plan),
        'homos': mb.homos,
        'lumos': mb.lumos,
        'vocab_mask': vocab_mask,
    }
