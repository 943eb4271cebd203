"""Fixed-shape batch assembly (copy of ``ggpm_tpu/data/batching.py``), and
the host tables of the training path's backward kernels (``train_tables``;
``hier_train_tables`` for the hier family).

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


# DecodePlan keys laid out [T, B, ...] (re-scheduled by compact_plan_dict);
# root_clab/root_ilab/max_cls_size stay per-molecule/static.
_PLAN_STEP_KEYS = ('active', 'xid', 'mess', 'tlab', 'has_cls', 'clab',
                   'ilab', 'has_assm', 'assm_nc', 'assm_icls',
                   'assm_n_icls', 'assm_nth')


def compact_plan_dict(plan: Dict[str, np.ndarray], lane_quantum: int = 16,
                      step_quantum: int = 32) -> Dict[str, np.ndarray]:
    """Lane-pack a motif-family decode plan (the sequence-packing analogue).

    The teacher-forcing decoder scan executes every padded ``[T, B]`` slot,
    but DFS chain lengths vary ~3× within a batch, so slot utilisation is
    ~0.3 at large batch (measured, scripts/step_cost_breakdown.py).  The
    scan body is lane-agnostic — each slot is driven purely by global
    message/node indices — and chains of different molecules are
    independent, so the chains can be packed back-to-back onto ``L < B``
    lanes (LPT onto the emptiest lane; within-molecule step order is
    preserved, which is the only dependency).  ``mol_lane[t, l]`` records
    which molecule owns each slot so the loss heads can gather their
    per-molecule latent context.  The loss is numerically identical (same
    terms, re-scheduled) — verified in tests/test_compact.py.

    Hier-extension tables (``gstep_*``/``assm_cand*``) are dropped: the
    motif decoder does not read them, and the hierarchical family keeps
    unpacked plans (its scan is not lane-agnostic).

    Returns a new plan dict with ``[T', L]`` step arrays and ``mol_lane``;
    at batch 240 / HOPV15 this is ~2.5× fewer scan slots (util 0.30→0.74).
    """
    act = np.asarray(plan['active'])
    T, B = act.shape
    lens = act.sum(0).astype(np.int64)
    total = int(lens.sum())
    max_len = int(lens.max()) if B else 0

    rup = lambda n, q: max(q, -(-int(n) // q) * q)
    if total == 0:
        L, T2 = max(1, min(B, lane_quantum)), step_quantum
        dst_t = dst_l = src_t = src_b = np.zeros(0, np.int64)
    else:
        T_target = rup(max_len, step_quantum)
        L = max(1, min(B, rup(-(-total // T_target), lane_quantum)))
        order = np.argsort(-lens, kind='stable')
        lane_end = np.zeros(L, np.int64)
        st, sb, dt, dl = [], [], [], []
        for m in order:
            k = int(lens[m])
            if k == 0:
                continue
            lane = int(np.argmin(lane_end))
            s = int(lane_end[lane])
            lane_end[lane] += k
            st.append(np.flatnonzero(act[:, m]))
            sb.append(np.full(k, m, np.int64))
            dt.append(np.arange(s, s + k))
            dl.append(np.full(k, lane, np.int64))
        src_t, src_b = np.concatenate(st), np.concatenate(sb)
        dst_t, dst_l = np.concatenate(dt), np.concatenate(dl)
        T2 = rup(int(lane_end.max()), step_quantum)

    def relay(a):
        out = np.zeros((T2, L) + a.shape[2:], dtype=a.dtype)
        out[dst_t, dst_l] = a[src_t, src_b]
        return out

    out = {k: relay(np.asarray(plan[k])) for k in _PLAN_STEP_KEYS}
    # inactive anchor counts stay 1 (pad_plan convention)
    out['assm_n_icls'] = np.maximum(out['assm_n_icls'], 1)
    mol_lane = np.zeros((T2, L), np.int32)
    mol_lane[dst_t, dst_l] = src_b
    out['mol_lane'] = mol_lane
    for k in ('root_clab', 'root_ilab', 'max_cls_size'):
        out[k] = plan[k]
    return out

def frontier_table(tree: Dict[str, np.ndarray], plan: Dict[str, np.ndarray]
                   ) -> np.ndarray:
    """The teacher-forced decoder's frontier readout table, [T·L, A] int32
    over the rows of its message state (``num_mess + B``).

    JAX ``MotifDecoder._run_scan`` (decoder.py:265-283) reads the final
    state under a visibility mask: slot (t, l) sums the state rows
    ``agraph_dec[xid[t, l]]`` written at a step ``<= t`` (virtual root rows,
    ``>= num_mess``, from step 0; rows never written, row 0 included, never).
    The mask depends on the plan alone, so it is applied here: the masked
    entries become the padding row 0, which is zero in the state, and the
    readout is ``nei_sum`` over this table."""
    agraph = np.asarray(tree['agraph_dec'])
    num_mess = tree['fmess'].shape[0]
    xid, mess = np.asarray(plan['xid']), np.asarray(plan['mess'])
    T, L = mess.shape
    B = len(plan['root_clab'])
    never = T + 1
    ws = np.full(num_mess + B, never, np.int64)
    ws[num_mess:] = -1
    valid = mess > 0
    ws[mess[valid]] = np.broadcast_to(np.arange(T)[:, None], (T, L))[valid]
    ag = agraph[xid]                                      # [T, L, A]
    vis = ws[ag] <= np.arange(T)[:, None, None]
    return np.where(vis, ag, 0).reshape(T * L, -1).astype(np.int32)


def train_tables(batch: Dict) -> Dict:
    """``batch`` (a ``to_model_batch`` dict, its plan packed or not) with
    the host tables the training forward reads and its backward kernels
    gather over (``ops.build_transpose``, row 0 left out):

    * ``tree['agraph_t'/'agraph_tm']``: transpose of ``agraph`` over the
      messages (the node readout's backward);
    * ``tree['root_t'/'root_tm']``: of ``agraph[roots]`` (the root
      readout's);
    * ``plan['frontier']`` (``frontier_table``) and
      ``plan['frontier_t'/'frontier_tm']``: the decoder's masked frontier
      readout and its transpose over the ``num_mess + B`` state rows.

    ``tree['bgraph_t'/'bgraph_tm']`` (the depth loop's) come from
    ``level_to_dict``.  Every width is a bound the bucket shapes give, so
    the tables' shapes, and with them the
    device batch's signature, follow the host batch's: a message is one
    node's incoming message, so it appears once in ``agraph`` and in the
    root rows (width 1); and a frontier slot reads the incoming messages of
    its node, which is the frontier once per child and once more (the
    backtrack to its parent, or the root's last step), no more often than
    its row of ``agraph_dec`` has entries (the root's holds its virtual
    root message too), so the frontier table's own width bounds its
    transpose's.  A table that broke a bound would raise.  Masked columns
    add nothing (``transpose_sum`` loads none on the card)."""
    tree, plan = dict(batch['tree']), dict(batch['plan'])
    n_mess = tree['fmess'].shape[0]
    roots = tree['agraph'][tree['scope'][:, 0]]
    fr = frontier_table(tree, plan)
    tree['agraph_t'], tree['agraph_tm'] = build_transpose(tree['agraph'],
                                                          n_mess, 1)
    tree['root_t'], tree['root_tm'] = build_transpose(roots, n_mess, 1)
    plan['frontier'] = fr
    plan['frontier_t'], plan['frontier_tm'] = build_transpose(
        fr, n_mess + len(plan['root_clab']), fr.shape[1])
    return dict(batch, tree=tree, plan=plan)


def step_transposes(tables: np.ndarray, num_src: int, k: int):
    """The transposes of T per-step tables at once: ``tables`` [T, N, A]
    over a state of ``num_src`` rows gives ``(t_idx, t_mask)`` [T,
    num_src, k], where ``t_idx[t]`` indexes the flat positions of
    ``tables[t]`` (``build_transpose(tables[t], num_src, k)`` for each t).
    One ``build_transpose`` covers every step: step t's rows are offset
    by t·num_src, and its positions come back less t·N·A."""
    T, N, A = tables.shape
    shift = (np.arange(T) * num_src)[:, None, None]
    t_idx, t_mask = build_transpose(
        np.where(tables > 0, tables + shift, 0).reshape(T * N, A),
        T * num_src, k)
    t_idx = t_idx.reshape(T, num_src, k) - (
        (np.arange(T) * N * A)[:, None, None] * (t_mask.reshape(
            T, num_src, k) > 0))
    return t_idx.astype(np.int32), t_mask.reshape(T, num_src, k)


def hier_train_tables(batch: Dict) -> Dict:
    """``batch`` (a ``to_model_batch`` dict of the hier family, its plan
    unpacked) with the host tables its training forward reads and its
    backward kernels gather over (``ops.build_transpose``, row 0 left
    out):

    * ``graph['agraph_t'/'agraph_tm']``: transpose of the atom readout's
      ``agraph`` over the bond messages; ``tree['cgraph_t'/'cgraph_tm']``
      of the cluster sum over the atoms; ``tree['agraph_t'/'agraph_tm']``
      of the attachment and motif readouts (one table for both) and
      ``tree['root_t'/'root_tm']`` of the root readout, over the tree's
      messages;
    * for the teacher-forced scan, each of its five per-step sums as a
      [T, N, A] table of step t's rows and its per-step transposes
      (``step_transposes``) over the state that sum reads: ``plan['s_atom'
      / '_t' / '_tm']`` the atom refresh's ``agraph[gstep_nodes[t]]``
      over the atom-message state; ``plan['s_clu_src']`` and
      ``plan['s_clu_x']`` the cluster sums ``cgraph[src]`` and
      ``cgraph[xid[t]]`` over the atom hiddens (``src`` the source node of
      step t's message); ``plan['s_inter']`` the attachment frontier's
      ``agraph[xid[t]]`` over the attachment messages; ``plan['s_tree']``
      the tree frontier's ``agraph_dec[xid[t]]`` over the tree state's
      ``num_mess + B`` rows;
    * likewise the scan's message updates' neighbour gathers (K3 forward,
      K2 backward): ``plan['u_atom']`` the atom level's
      ``bgraph[gstep_mess[t]]``, ``plan['u_inter']`` and ``plan['u_tree']``
      the attachment and motif levels' ``bgraph[mess[t]]`` and
      ``bgraph_dec[mess[t]]``.

    Each sum reads step t's state, which later steps rewrite (a cluster
    shares atoms with its parent), so the tables are per step.  Every
    width is a bound the bucket shapes give, as in ``train_tables``: a
    message enters one node, so it appears once in ``agraph`` and the root
    rows, and once in a step's tables (a step's lanes hold distinct
    molecules, one node or one cluster of distinct atoms each): width 1;
    a message recurs in a cluster's ``bgraph`` rows at most as often as in
    the whole table, whose width bounds that (``level_to_dict``).
    An atom lies in the clusters of the rings and bonds through it (at
    most 5 in HOPV), fewer than the atom graph's ``agraph`` width (at
    least 8): that width bounds the cluster sum's.  A table that broke a
    bound would raise."""
    tree, graph, plan = (dict(batch['tree']), dict(batch['graph']),
                         dict(batch['plan']))
    n_mess, n_gmess = tree['fmess'].shape[0], graph['fmess'].shape[0]
    n_gnodes = graph['fnode'].shape[0]
    agraph, cgraph = tree['agraph'], tree['cgraph']
    graph['agraph_t'], graph['agraph_tm'] = build_transpose(
        graph['agraph'], n_gmess, 1)
    tree['cgraph_t'], tree['cgraph_tm'] = build_transpose(
        cgraph, n_gnodes, graph['agraph'].shape[1])
    tree['agraph_t'], tree['agraph_tm'] = build_transpose(agraph, n_mess, 1)
    tree['root_t'], tree['root_tm'] = build_transpose(
        agraph[tree['scope'][:, 0]], n_mess, 1)
    xid = np.asarray(plan['xid'])
    src = tree['fmess'][np.asarray(plan['mess']), 0]
    T = xid.shape[0]
    n_tree = n_mess + len(plan['root_clab'])
    g_bgraph = graph['bgraph']
    sites = {
        's_atom': (graph['agraph'][plan['gstep_nodes']].reshape(
            T, -1, graph['agraph'].shape[1]), n_gmess, 1),
        's_clu_src': (cgraph[src], n_gnodes, 1),
        's_clu_x': (cgraph[xid], n_gnodes, 1),
        's_inter': (agraph[xid], n_mess, 1),
        's_tree': (tree['agraph_dec'][xid], n_tree, 1),
        'u_atom': (g_bgraph[plan['gstep_mess']].reshape(
            T, -1, g_bgraph.shape[1]), n_gmess, g_bgraph.shape[1]),
        'u_inter': (tree['bgraph'][plan['mess']], n_mess, 1),
        'u_tree': (tree['bgraph_dec'][plan['mess']], n_tree, 1),
    }
    for name, (tables, n_src, k) in sites.items():
        plan[name] = np.ascontiguousarray(tables, dtype=np.int32)
        plan[name + '_t'], plan[name + '_tm'] = step_transposes(
            plan[name], n_src, k)
    return dict(batch, tree=tree, graph=graph, plan=plan)


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
