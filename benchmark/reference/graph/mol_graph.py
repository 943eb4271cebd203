"""Hierarchical motif decomposition and fixed-shape batch tensorization
(copy of ``ggpm_tpu/graph/mol_graph.py`` on a graph type of its own in place
of networkx).

``MolGraph`` mirrors the reference decomposition pipeline
(ggpm/mol_graph.py:13-197): atom graph → clusters
(non-ring bonds + SSSR rings) → motif pooling against a fragment vocabulary →
junction tree via maximum spanning tree → DFS generation order with
inter/assembly labels.

``tensorize`` departs from the reference deliberately (TPU-first): instead of
ragged index lists consumed by per-step Python loops (reference
mol_graph.py:199-281 + decoder.py:811-874), it emits *padded numpy arrays*
plus a precomputed **decode plan** — per-step index/label tensors that let the
teacher-forced decoder run as a single scan on device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import AbstractSet, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chem import AROMATIC, DOUBLE, SINGLE, TRIPLE, Mol, get_mol, get_smiles
from .chemutils import find_fragments, get_assm_cands, get_inter_label

# ---------------------------------------------------------------------------
# A small insertion-ordered graph: the part of networkx 3.x that the
# decomposition and tensorization use, with the same iteration orders and
# tie-breaking, so that the tensors come out identical to the JAX package's
# (tests/test_torch_graph.py compares them array for array).  Nodes and
# neighbours iterate in insertion order; edge and node attributes are dicts.
# ---------------------------------------------------------------------------

class Graph:
    """Undirected graph; both directions of an edge share one attr dict."""

    def __init__(self):
        self._node: Dict = {}
        self._adj: Dict = {}

    def add_node(self, n, /, **attr):
        if n not in self._node:
            self._node[n] = {}
            self._adj[n] = {}
        self._node[n].update(attr)

    def add_edge(self, u, v, /, **attr):
        self.add_node(u)
        self.add_node(v)
        d = self._adj[u].get(v, {})
        d.update(attr)
        self._adj[u][v] = d
        self._adj[v][u] = d

    def __getitem__(self, n):
        return self._adj[n]

    def __len__(self):
        return len(self._node)

    def number_of_edges(self) -> int:
        return len(self.edges())

    @property
    def node(self) -> Dict:
        """``G.nodes[n]``: node -> attr dict."""
        return self._node

    def nodes(self, data=False):
        """``G.nodes(data=...)``: n, (n, attr dict) or (n, attr.get(data))."""
        if data is True:
            return list(self._node.items())
        if data:
            return [(n, d.get(data)) for n, d in self._node.items()]
        return list(self._node)

    def edges(self, data=False):
        """Each edge once, as (u, v[, d]) with u the earlier node."""
        out, seen = [], set()
        for u, nbrs in self._adj.items():
            for v, d in nbrs.items():
                if v not in seen:
                    out.append((u, v, d) if data else (u, v))
            seen.add(u)
        return out


class DiGraph(Graph):
    """Directed graph with successor (``G[u]``) and predecessor maps."""

    def __init__(self):
        super().__init__()
        self._pred: Dict = {}

    def add_node(self, n, /, **attr):
        if n not in self._node:
            self._pred[n] = {}
        super().add_node(n, **attr)

    def add_edge(self, u, v, /, **attr):
        self.add_node(u)
        self.add_node(v)
        d = self._adj[u].get(v, {})
        d.update(attr)
        self._adj[u][v] = d
        self._pred[v][u] = d

    def successors(self, n):
        return iter(self._adj[n])

    def predecessors(self, n):
        return iter(self._pred[n])

    def edges(self, data=False):
        """(u, v[, d]) in node order, then successor order."""
        if data is True:
            return [(u, v, d) for u, nbrs in self._adj.items()
                    for v, d in nbrs.items()]
        if data:
            return [(u, v, d.get(data)) for u, nbrs in self._adj.items()
                    for v, d in nbrs.items()]
        return [(u, v) for u, nbrs in self._adj.items() for v in nbrs]


def empty_graph(n: int) -> Graph:
    g = Graph()
    for i in range(n):
        g.add_node(i)
    return g


def to_directed(g: Graph) -> DiGraph:
    """``nx.DiGraph(g)``: both directions of every edge, each with its own
    copy of the attr dict."""
    out = DiGraph()
    for n in g._node:
        out.add_node(n)
    for u, nbrs in g._adj.items():
        for v, d in nbrs.items():
            out.add_edge(u, v, **d)
    for n, d in g._node.items():
        out._node[n].update(d)
    return out


def relabel_to_integers(g: DiGraph, first_label: int) -> DiGraph:
    """``nx.convert_node_labels_to_integers(g, first_label)``: nodes renumbered
    in node order; node and edge attr dicts are shallow copies."""
    mapping = {n: first_label + i for i, n in enumerate(g._node)}
    out = DiGraph()
    for n, d in g._node.items():
        out.add_node(mapping[n], **d)
    for u, v, d in g.edges(data=True):
        out.add_edge(mapping[u], mapping[v], **d)
    return out


def union_all(graphs: Sequence[DiGraph]) -> DiGraph:
    """``nx.union_all`` of graphs with disjoint node sets."""
    out = DiGraph()
    for g in graphs:
        if not out._node.keys().isdisjoint(g._node):
            raise ValueError('union_all: node sets are not disjoint')
        for n, d in g._node.items():
            out.add_node(n, **d)
        for u, v, d in g.edges(data=True):
            out.add_edge(u, v, **d)
    return out


def maximum_spanning_tree(g: Graph) -> Graph:
    """``nx.maximum_spanning_tree`` by Kruskal: edges taken in ``g.edges()``
    order, stably sorted by descending weight (default 1), each kept when it
    joins two components."""
    edges = sorted(g.edges(data=True), key=lambda e: e[2].get('weight', 1),
                   reverse=True)
    root = {n: n for n in g._node}

    def find(x):
        while root[x] != x:
            root[x] = root[root[x]]
            x = root[x]
        return x

    out = Graph()
    for n, d in g._node.items():
        out.add_node(n, **d)
    for u, v, d in edges:
        ru, rv = find(u), find(v)
        if ru != rv:
            root[ru] = rv
            out.add_edge(u, v, **d)
    return out

# Bond-type feature index (reference MolGraph.BOND_LIST, mol_graph.py:14-15).
BOND_LIST = (SINGLE, DOUBLE, TRIPLE, AROMATIC)
MAX_POS = 20


def bond_type_index(mol: Mol, bond) -> int:
    if bond.aromatic:
        return 3
    return {SINGLE: 0, DOUBLE: 1, TRIPLE: 2}[bond.order]


class MolGraph:
    """Three-level decomposition of one molecule."""

    def __init__(self, smiles: str, fragments: AbstractSet[str] = frozenset()):
        """``fragments``: canonical SMILES of the frequent fragments that
        motif pooling merges (``PairVocab.fragments``)."""
        self.smiles = smiles
        self.fragments = fragments
        self.mol = get_mol(smiles)
        if self.mol is None:
            raise ValueError(f'unparseable SMILES: {smiles!r}')

        self.mol_graph = self.build_mol_graph()
        self.clusters = self.find_clusters()
        self.clusters, self.atom_cls = self.pool_clusters()
        self.mol_tree = self.tree_decomp()
        self.order = self.label_tree()

    # -- decomposition (reference mol_graph.py:34-119) ---------------------
    def find_clusters(self):
        mol = self.mol
        if mol.num_atoms == 1:
            return [(0,)]
        clusters = []
        for b in mol.bonds:
            if not mol.bond_in_ring(b.a1, b.a2):
                clusters.append((b.a1, b.a2))
        clusters.extend(tuple(r) for r in mol.sssr())
        return clusters

    def pool_clusters(self):
        """Merge clusters that lie inside a frequent vocabulary fragment
        (reference ``pool_clusters``, mol_graph.py:91-119)."""
        hoptions = []
        visited = set()
        for fsmiles, fatoms in find_fragments(self.mol):
            if fsmiles not in self.fragments:
                continue
            fclusters = [i for i, cls in enumerate(self.clusters)
                         if set(cls) <= fatoms]
            if set(fclusters) & visited:
                raise ValueError('overlapping fragment clusters')
            hoptions.append(sorted(fatoms))
            visited.update(fclusters)
        for i, cls in enumerate(self.clusters):
            if i not in visited:
                hoptions.append(list(cls))
        hoptions = sorted(hoptions, key=lambda x: min(x))

        atom_cls = [[] for _ in range(self.mol.num_atoms)]
        for i, cls in enumerate(hoptions):
            for atom in cls:
                atom_cls[atom].append(i)
        return hoptions, atom_cls

    def tree_decomp(self) -> Graph:
        clusters = self.clusters
        graph = empty_graph(len(clusters))
        for atom, nei_cls in enumerate(self.atom_cls):
            if len(nei_cls) <= 1:
                continue
            inter = set(clusters[nei_cls[0]])
            for cid in nei_cls:
                inter &= set(clusters[cid])
            assert len(inter) >= 1
            if len(nei_cls) > 2 and len(inter) == 1:
                # multiple clusters sharing one atom: star around a singleton
                clusters.append([atom])
                c2 = len(clusters) - 1
                graph.add_node(c2)
                for c1 in nei_cls:
                    graph.add_edge(c1, c2, weight=100)
            else:
                for i, c1 in enumerate(nei_cls):
                    for c2 in nei_cls[i + 1:]:
                        union = set(clusters[c1]) | set(clusters[c2])
                        graph.add_edge(c1, c2, weight=len(union))
        n, m = len(graph), graph.number_of_edges()
        assert n - m <= 1, 'motif graph must be connected'
        return graph if n - m == 1 else maximum_spanning_tree(graph)

    def label_tree(self):
        """DFS-order the junction tree and attach generation labels
        (reference ``label_tree``, mol_graph.py:121-178)."""
        def dfs(order, pa, prev_sib, x, fa):
            pa[x] = fa
            sorted_child = sorted(y for y in self.mol_tree[x] if y != fa)
            for idx, y in enumerate(sorted_child):
                self.mol_tree[x][y]['label'] = 0
                self.mol_tree[y][x]['label'] = idx + 1
                prev_sib[y] = sorted_child[:idx]
                prev_sib[y] += [x, fa] if fa >= 0 else [x]
                order.append((x, y, 1))
                dfs(order, pa, prev_sib, y, x)
                order.append((y, x, 0))

        order: List[Tuple[int, Optional[int], int]] = []
        pa: Dict[int, int] = {}
        self.mol_tree = to_directed(self.mol_tree)
        prev_sib = [[] for _ in range(len(self.clusters))]
        import sys
        limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(limit, 10000))
        try:
            dfs(order, pa, prev_sib, 0, -1)
        finally:
            sys.setrecursionlimit(limit)
        order.append((0, None, 0))

        mol = get_mol(self.smiles)
        for i, a in enumerate(mol.atoms):
            a.map_num = i + 1

        tree = self.mol_tree
        for i, cls in enumerate(self.clusters):
            inter_atoms = set(cls) & set(self.clusters[pa[i]]) if pa[i] >= 0 else {0}
            cmol, inter_label = get_inter_label(mol, cls, inter_atoms, self.atom_cls)
            tree.node[i]['ismiles'] = ismiles = get_smiles(cmol)
            tree.node[i]['inter_label'] = inter_label
            tree.node[i]['smiles'] = smiles = get_smiles(cmol.set_atom_maps(0))
            tree.node[i]['label'] = (smiles, ismiles) if len(cls) > 1 else (smiles, smiles)
            tree.node[i]['cluster'] = cls
            tree.node[i]['assm_cands'] = []

            if pa[i] >= 0 and len(self.clusters[pa[i]]) > 2:
                hist = [a for c in prev_sib[i] for a in self.clusters[c]]
                pa_cls = self.clusters[pa[i]]
                tree.node[i]['assm_cands'] = get_assm_cands(
                    mol, hist, inter_label, pa_cls, len(inter_atoms))

                child_order = tree[i][pa[i]]['label']
                diff = set(cls) - set(pa_cls)
                for fa_atom in inter_atoms:
                    for ch_atom in self.mol_graph[fa_atom]:
                        if ch_atom in diff:
                            label = self.mol_graph[ch_atom][fa_atom]['label']
                            if isinstance(label, int):
                                self.mol_graph[ch_atom][fa_atom]['label'] = (label, child_order)
        return order

    def build_mol_graph(self) -> DiGraph:
        mol = self.mol
        graph = DiGraph()
        for i, a in enumerate(mol.atoms):
            graph.add_node(i, label=(a.symbol, a.charge))
        for u in range(mol.num_atoms):
            for v in sorted(mol.neighbors(u)):
                b = mol.bond_between(u, v)
                graph.add_edge(u, v, label=bond_type_index(mol, b))
        return graph


# ---------------------------------------------------------------------------
# Batch tensorization (fixed-shape numpy; index 0 of every table is padding,
# following the reference convention, mol_graph.py:240-276).
# ---------------------------------------------------------------------------

@dataclass
class LevelTensors:
    """One message-passing level (motif tree or atom graph)."""
    fnode: np.ndarray        # tree: [N,2] (cls,icls); graph: [N] atom type
    fmess: np.ndarray        # [M,4] int32: (src, dst, label, pos)
    agraph: np.ndarray       # [N, A]: incoming message ids per node
    bgraph: np.ndarray       # [M, A]: predecessor message ids per message
    scope: np.ndarray        # [B, 2]: (offset, length) per molecule
    cgraph: Optional[np.ndarray] = None   # [N, C]: member atom ids (tree only)
    # decoder variants with the virtual root-message slot wired in
    # (reference init_decoder_state, decoder.py:531-552)
    agraph_dec: Optional[np.ndarray] = None
    bgraph_dec: Optional[np.ndarray] = None


@dataclass
class DecodePlan:
    """Per-DFS-step index/label arrays driving the scan-based teacher-forced
    decoder.  Shapes: [T, B] unless noted.  Index arrays point into the padded
    batch-level tree tensors; inactive slots are 0."""
    active: np.ndarray       # bool: step t exists for sample b
    xid: np.ndarray          # frontier tree node
    mess: np.ndarray         # message id (xid->yid) enabled this step; 0 if none
    tlab: np.ndarray         # topology label (1 expand / 0 backtrack)
    has_cls: np.ndarray      # bool: motif prediction event (tlab==1)
    clab: np.ndarray         # coarse motif label
    ilab: np.ndarray         # fine attachment label
    has_assm: np.ndarray     # bool: assembly prediction event
    assm_nc: np.ndarray      # number of real candidates
    assm_icls: np.ndarray    # [T, B, 2] attachment vocab ids of anchors
    assm_n_icls: np.ndarray  # 1 or 2 anchors
    assm_nth: np.ndarray     # nth-child order feature
    root_clab: np.ndarray    # [B]
    root_ilab: np.ndarray    # [B]
    max_cls_size: int        # padded candidate slots (2 * largest cluster)
    # -- hierarchical-decoder extensions (atom-level teacher forcing;
    #    reference HierMPNDecoder.forward, decoder.py:166-284) -------------
    # Graph-level sparse updates at step t process the atoms/bonds unmasked
    # at step t-1 (clusters of the previous step's target node; step 0 =
    # root clusters).
    gstep_nodes: Optional[np.ndarray] = None   # [T, B, KN] atom ids
    gstep_mess: Optional[np.ndarray] = None    # [T, B, KE] atom-graph mess ids
    assm_cands: Optional[np.ndarray] = None    # [T, B, MAXC, 2] cand atom ids
    assm_cand_ok: Optional[np.ndarray] = None  # [T, B, MAXC] real-slot mask


@dataclass
class MolGraphBatch:
    smiles: List[str]
    tree: LevelTensors
    graph: LevelTensors
    plan: DecodePlan
    homos: np.ndarray
    lumos: np.ndarray


def _pad_rows(rows: List[List[int]], extra: int = 1) -> np.ndarray:
    width = max(len(r) for r in rows) + extra
    out = np.zeros((len(rows), width), dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def tensorize_graph(graph_batch: List[DiGraph], vocab):
    """Flatten a batch of graphs into index tensors with batch offsets
    (reference ``tensorize_graph``, mol_graph.py:238-281)."""
    fnode, fmess = [None], [(0, 0, 0, 0)]
    agraph_rows, bgraph_rows = [[]], [[]]
    scope = []
    edge_dict = {}
    all_g = []

    for bid, g in enumerate(graph_batch):
        offset = len(fnode)
        scope.append((offset, len(g)))
        g = relabel_to_integers(g, first_label=offset)
        all_g.append(g)
        fnode.extend([None] * len(g))

        for v, attr in g.nodes(data='label'):
            g.node[v]['batch_id'] = bid
            fnode[v] = vocab[attr]
            agraph_rows.append([])
        for u, v, attr in g.edges(data='label'):
            if isinstance(attr, tuple):
                fmess.append((u, v, attr[0], min(attr[1], MAX_POS - 1)))
            else:
                fmess.append((u, v, attr, 0))
            edge_dict[(u, v)] = eid = len(edge_dict) + 1
            g[u][v]['mess_idx'] = eid
            agraph_rows[v].append(eid)
            bgraph_rows.append([])
        for u, v in g.edges():
            eid = edge_dict[(u, v)]
            for w in g.predecessors(u):
                if w == v:
                    continue
                bgraph_rows[eid].append(edge_dict[(w, u)])

    fnode[0] = fnode[1]
    fnode = np.asarray(fnode, dtype=np.int32)
    fmess = np.asarray(fmess, dtype=np.int32)
    agraph = _pad_rows(agraph_rows)
    bgraph = _pad_rows(bgraph_rows)
    scope = np.asarray(scope, dtype=np.int32)
    return LevelTensors(fnode, fmess, agraph, bgraph, scope), union_all(all_g)


def tensorize(mol_batch, vocab, avocab) -> MolGraphBatch:
    """Tensorize [(smiles, homo, lumo), ...] into a MolGraphBatch (reference
    ``MolGraph.tensorize``, mol_graph.py:199-236, plus the decode plan)."""
    smiles_list, homos, lumos, hmols = [], [], [], []
    for x in mol_batch:
        smiles_list.append(x[0])
        homos.append(float('nan') if x[1] is None else float(x[1]))
        lumos.append(float('nan') if x[2] is None else float(x[2]))
        hmols.append(MolGraph(x[0], vocab.fragments))
    return tensorize_mols(smiles_list, homos, lumos, hmols, vocab, avocab)


def tensorize_mols(smiles_list, homos, lumos, hmols, vocab,
                   avocab) -> MolGraphBatch:
    """Tensorize ALREADY-DECOMPOSED MolGraphs.  Lets large-corpus prep
    decompose each molecule exactly once (label collection and tensorize
    share the MolGraph); ``tensorize`` itself is the one-shot wrapper.
    NOTE: mutates the hmols' tree node attrs (batch offsets) — each hmol
    may be tensorized only once."""
    tree_tensors, tree_batch_g = tensorize_graph([h.mol_tree for h in hmols], vocab)
    graph_tensors, graph_batch_g = tensorize_graph([h.mol_graph for h in hmols], avocab)
    tree_scope = tree_tensors.scope
    graph_scope = graph_tensors.scope

    # cgraph: tree node -> member atom ids (batch-offset)
    max_cls_size = max(len(c) for h in hmols for c in h.clusters)
    n_tree = tree_tensors.fnode.shape[0]
    cgraph = np.zeros((n_tree, max_cls_size), dtype=np.int32)
    for v, attr in tree_batch_g.nodes(data=True):
        bid = attr['batch_id']
        offset = int(graph_scope[bid][0])
        # write batch-offset attrs back (reference mol_graph.py:217-222)
        attr['cluster'] = cls = [x + offset for x in attr['cluster']]
        attr['inter_label'] = [(x + offset, y) for x, y in attr['inter_label']]
        attr['assm_cands'] = [
            (x + offset if isinstance(x, (int, np.integer))
             else tuple(xx + offset for xx in x))
            for x in attr['assm_cands']]
        cgraph[v, :len(cls)] = cls
    tree_tensors.cgraph = cgraph

    # decoder agraph/bgraph with virtual root-message slots (the +1 slack
    # column from _pad_rows holds them; reference decoder.py:531-552)
    num_mess = tree_tensors.fmess.shape[0]
    agraph_dec = tree_tensors.agraph.copy()
    bgraph_dec = tree_tensors.bgraph.copy()
    for i in range(len(hmols)):
        root = int(tree_scope[i][0])
        assert agraph_dec[root, -1] == 0
        agraph_dec[root, -1] = num_mess + i
        for v in tree_batch_g.successors(root):
            mess_idx = tree_batch_g[root][v]['mess_idx']
            assert bgraph_dec[mess_idx, -1] == 0
            bgraph_dec[mess_idx, -1] = num_mess + i
    tree_tensors.agraph_dec = agraph_dec
    tree_tensors.bgraph_dec = bgraph_dec

    plan = _build_plan(hmols, tree_batch_g, tree_scope, vocab,
                       graph_batch_g, graph_scope)
    return MolGraphBatch(
        smiles=smiles_list, tree=tree_tensors, graph=graph_tensors, plan=plan,
        homos=np.asarray(homos, dtype=np.float32),
        lumos=np.asarray(lumos, dtype=np.float32),
    )


def _build_plan(hmols, tree_batch_g, tree_scope, vocab,
                graph_batch_g=None, graph_scope=None) -> DecodePlan:
    batch_size = len(hmols)
    maxt = max(len(h.order) for h in hmols)
    shape = (maxt, batch_size)
    active = np.zeros(shape, dtype=bool)
    xid = np.zeros(shape, dtype=np.int32)
    mess = np.zeros(shape, dtype=np.int32)
    tlab = np.zeros(shape, dtype=np.int32)
    has_cls = np.zeros(shape, dtype=bool)
    clab = np.zeros(shape, dtype=np.int32)
    ilab = np.zeros(shape, dtype=np.int32)
    has_assm = np.zeros(shape, dtype=bool)
    assm_nc = np.zeros(shape, dtype=np.int32)
    assm_icls = np.zeros(shape + (2,), dtype=np.int32)
    assm_n_icls = np.ones(shape, dtype=np.int32)
    assm_nth = np.zeros(shape, dtype=np.int32)
    root_clab = np.zeros(batch_size, dtype=np.int32)
    root_ilab = np.zeros(batch_size, dtype=np.int32)

    max_cls_size = 2 * max(len(attr) for _, attr in tree_batch_g.nodes(data='cluster'))

    # hier extensions: per-step cluster atoms / edges and assembly candidates
    kn = max(len(attr) for _, attr in tree_batch_g.nodes(data='cluster'))
    def _cluster_edges(cluster):
        cset = set(cluster)
        out = []
        for u in cluster:
            for v in graph_batch_g[u]:
                if v in cset:
                    out.append(graph_batch_g[u][v]['mess_idx'])
        return out
    ke = max((len(_cluster_edges(attr))
              for _, attr in tree_batch_g.nodes(data='cluster')), default=1)
    ke = max(ke, 1)
    gstep_nodes = np.zeros(shape + (kn,), dtype=np.int32)
    gstep_mess = np.zeros(shape + (ke,), dtype=np.int32)
    assm_cands = np.zeros(shape + (max_cls_size, 2), dtype=np.int32)
    assm_cand_ok = np.zeros(shape + (max_cls_size,), dtype=bool)

    for i, hmol in enumerate(hmols):
        offset = int(tree_scope[i][0])
        goffset = int(graph_scope[i][0]) if graph_scope is not None else 0
        root = tree_batch_g.node[offset]
        root_clab[i], root_ilab[i] = vocab[root['label']]

        def put_cluster(t, cluster, i=i):
            # clusters carry batch offsets already (written back in tensorize)
            atoms = list(cluster)[:kn]
            gstep_nodes[t, i, :len(atoms)] = atoms
            edges = _cluster_edges(atoms)[:ke]
            gstep_mess[t, i, :len(edges)] = edges

        # step 0 processes the root cluster (reference decoder.py:189-195);
        # step t+1 processes the cluster unmasked at step t
        put_cluster(0, root['cluster'])

        for t, (x, y, tl) in enumerate(hmol.order):
            active[t, i] = True
            gx = x + offset
            xid[t, i] = gx
            tlab[t, i] = tl
            if y is None:
                continue
            gy = y + offset
            mess[t, i] = tree_batch_g[gx][gy]['mess_idx']
            ynode = tree_batch_g.node[gy]
            # the target's cluster is unmasked this step regardless of tlab
            # (reference decoder.py:230) and processed at step t+1
            if t + 1 < maxt:
                put_cluster(t + 1, ynode['cluster'])
            if tl == 0:
                continue
            has_cls[t, i] = True
            c, il = vocab[ynode['label']]
            clab[t, i], ilab[t, i] = c, il
            if len(tree_batch_g.node[gx]['cluster']) > 2:
                cands = ynode['assm_cands']
                if len(cands) == 0:
                    continue
                has_assm[t, i] = True
                assm_nc[t, i] = min(len(cands), max_cls_size)
                cls_s = ynode['smiles']
                icls_ids = [vocab[(cls_s, s)][1] for _, s in ynode['inter_label']]
                assm_n_icls[t, i] = len(icls_ids)
                for k, ic in enumerate(icls_ids[:2]):
                    assm_icls[t, i, k] = ic
                assm_nth[t, i] = min(tree_batch_g[gy][gx]['label'], MAX_POS - 1)
                for j, cand in enumerate(cands[:max_cls_size]):
                    assm_cand_ok[t, i, j] = True
                    if isinstance(cand, (tuple, list)):
                        assm_cands[t, i, j, 0] = cand[0]
                        assm_cands[t, i, j, 1] = cand[-1]
                    else:
                        assm_cands[t, i, j, 0] = cand

    return DecodePlan(
        active=active, xid=xid, mess=mess, tlab=tlab, has_cls=has_cls,
        clab=clab, ilab=ilab, has_assm=has_assm, assm_nc=assm_nc,
        assm_icls=assm_icls, assm_n_icls=assm_n_icls, assm_nth=assm_nth,
        root_clab=root_clab, root_ilab=root_ilab, max_cls_size=max_cls_size,
        gstep_nodes=gstep_nodes, gstep_mess=gstep_mess,
        assm_cands=assm_cands, assm_cand_ok=assm_cand_ok)
