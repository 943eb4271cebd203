"""The port's tensorization equals the JAX package's, array for array.

``ggpm_tpu_torch.graph.mol_graph`` replaces networkx with a small ordered
graph of its own; the tensors depend on its iteration order and on Kruskal's
tie-breaking, so they are compared exactly, and the graph type is held
against networkx directly.
"""

import random

import networkx as nx
import numpy as np
import pytest
import torch

from ggpm_tpu.cli.common import read_csv_data as jax_read_csv
from ggpm_tpu.data import batching as jax_batching
from ggpm_tpu.data.dataset import prune_to_vocab as jax_prune
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import PairVocab as JaxPairVocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.ops.graph_ops import build_transpose as jax_build_transpose
from ggpm_tpu_torch.data import batching
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph import mol_graph as mg
from ggpm_tpu_torch.graph.vocab import PairVocab, common_atom_vocab, load_vocab_file
from ggpm_tpu_torch.ops.graph_ops import build_transpose

torch.set_num_threads(1)

VOCAB = 'runs/QUALITY_hopv.json.vocab.txt'
DATA = 'data/hopv15.csv'


@pytest.fixture(scope='module')
def jax_fragments():
    """Restores the JAX package's class-level fragment set after the module:
    other test files in this worker may rely on it."""
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


@pytest.fixture(scope='module')
def hopv(jax_fragments):
    """Both packages' vocabs for the trained HOPV model, and the first 16
    in-vocab HOPV molecules (the same for both)."""
    jvocab, _ = jax_load_vocab(VOCAB)
    vocab = load_vocab_file(VOCAB)
    rows = prune_to_vocab(read_csv_data(DATA)[:24], vocab, verbose=False)
    jrows = jax_prune(jax_read_csv(DATA)[:24], jvocab, verbose=False)
    assert rows == jrows
    return dict(jvocab=jvocab, vocab=vocab, rows=rows[:16])


@pytest.fixture(scope='module')
def golden(jax_fragments, golden_smiles):
    """A vocab over the golden molecules, as tests/conftest.py builds it,
    with no fragments in either package."""
    jax_mg.MolGraph.FRAGMENTS = set()
    labels = set()
    for s in golden_smiles:
        h = jax_mg.MolGraph(s)
        for _, d in h.mol_tree.nodes(data=True):
            labels.add(d['label'])
            for _, anc in d['inter_label']:
                labels.add((d['smiles'], anc))
    pairs = sorted(labels)
    return dict(jvocab=JaxPairVocab(pairs), vocab=PairVocab(pairs),
                rows=[[s, None, None] for s in golden_smiles])


def _assert_same(a, b, path='batch'):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f'{path}/{k}')
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, path
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _both(setup, rows, pad):
    jmb = jax_mg.tensorize(rows, setup['jvocab'], jax_avocab)
    mb = mg.tensorize(rows, setup['vocab'], common_atom_vocab)
    assert mb.smiles == jmb.smiles
    return (batching.to_model_batch(mb, setup['vocab'].mask, pad=pad),
            jax_batching.to_model_batch(jmb, setup['jvocab'].mask, pad=pad))


@pytest.mark.parametrize('pad', [False, True])
def test_golden_batch_equal(golden, pad):
    ours, theirs = _both(golden, golden['rows'], pad)
    _assert_same(ours, theirs)
    assert 'bgraph_t' in ours['tree'] and 'bgraph_tm' in ours['graph']


@pytest.mark.parametrize('pad', [False, True])
def test_hopv_batch_equal(hopv, pad):
    ours, theirs = _both(hopv, hopv['rows'], pad)
    _assert_same(ours, theirs)


@pytest.mark.parametrize('i', range(8))
def test_hopv_molecule_equal(hopv, i):
    ours, theirs = _both(hopv, hopv['rows'][i:i + 1], pad=False)
    _assert_same(ours, theirs)


def test_vocab_file_matches(hopv):
    vocab, jvocab = hopv['vocab'], hopv['jvocab']
    assert vocab.size() == jvocab.size() == (91, 380)
    assert vocab.vocab == jvocab.vocab and vocab.hvocab == jvocab.hvocab
    np.testing.assert_array_equal(vocab.mask, jvocab.mask)
    assert vocab.fragments == jax_mg.MolGraph.FRAGMENTS


def test_decomposition_uses_vocab_fragments(hopv):
    """Fragment pooling reads the vocab's fragments: without them a HOPV
    molecule decomposes into more motifs."""
    s = hopv['rows'][0][0]
    pooled = mg.MolGraph(s, hopv['vocab'].fragments)
    plain = mg.MolGraph(s)
    assert len(plain.mol_tree) > len(pooled.mol_tree)


@pytest.mark.parametrize('k', [None, 12])
def test_build_transpose_equal(k):
    rng = np.random.default_rng(3)
    graph = rng.integers(0, 40, size=(40, 5)).astype(np.int32)
    graph[rng.random(graph.shape) < 0.3] = 0     # padding slots
    for x, y in zip(build_transpose(graph, 40, k=k),
                    jax_build_transpose(graph, 40, k=k)):
        np.testing.assert_array_equal(x, y)


# -- the ordered graph against networkx ------------------------------------

def _random_weighted_edges(seed, n=12, m=30):
    rng = random.Random(seed)
    return [(rng.randrange(n), rng.randrange(n), rng.choice([2, 3, 3, 4, 100]))
            for _ in range(m)]


def _pair(seed):
    ours, theirs = mg.empty_graph(12), nx.empty_graph(12)
    for u, v, w in _random_weighted_edges(seed):
        if u != v:
            ours.add_edge(u, v, weight=w)
            theirs.add_edge(u, v, weight=w)
    return ours, theirs


@pytest.mark.parametrize('seed', range(6))
def test_maximum_spanning_tree_matches_networkx(seed):
    ours, theirs = _pair(seed)
    assert ours.edges(data=True) == list(theirs.edges(data=True))
    t_ours = mg.maximum_spanning_tree(ours)
    t_theirs = nx.maximum_spanning_tree(theirs)
    assert t_ours.nodes() == list(t_theirs.nodes())
    assert t_ours.edges(data=True) == list(t_theirs.edges(data=True))
    for n in t_ours.nodes():
        assert list(t_ours[n]) == list(t_theirs[n])


@pytest.mark.parametrize('seed', range(3))
def test_directed_relabel_union_match_networkx(seed):
    ours, theirs = _pair(seed)
    d_ours, d_theirs = mg.to_directed(ours), nx.DiGraph(theirs)
    parts_ours, parts_theirs = [], []
    offset = 1
    for g_ours, g_theirs in ((d_ours, d_theirs), (d_ours, d_theirs)):
        parts_ours.append(mg.relabel_to_integers(g_ours, first_label=offset))
        parts_theirs.append(nx.convert_node_labels_to_integers(
            g_theirs, first_label=offset))
        offset += len(g_ours)
    u_ours, u_theirs = mg.union_all(parts_ours), nx.union_all(parts_theirs)
    for a, b in ((d_ours, d_theirs), (u_ours, u_theirs)):
        assert a.nodes(data=True) == list(b.nodes(data=True))
        assert a.edges(data=True) == list(b.edges(data=True))
        for n in a.nodes():
            assert list(a.predecessors(n)) == list(b.predecessors(n))
            assert list(a.successors(n)) == list(b.successors(n))
    # each direction of a converted edge owns its attr dict
    u, v = d_ours.edges()[0]
    d_ours[u][v]['label'] = 1
    assert 'label' not in d_ours[v][u]
