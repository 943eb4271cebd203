"""Motif-vocabulary extraction and preprocessing (counterpart of
``ggpm_tpu/data/vocab_extract.py``; reference get_vocab.py, preprocess.py
and merge_vocab.py).

The JAX package's pass 2 reads the frequent fragments from the class state
``MolGraph.FRAGMENTS``, which forked pool workers inherit; here they are
passed to every decomposition (``MolGraph(smiles, fragments)``), so a
result does not depend on how a worker was started.  Pools start their
workers from a ``forkserver``: a pool may start after CUDA is initialised,
which a forked child cannot use.  The workers do host chemistry only.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import pickle
import random
from collections import Counter
from typing import AbstractSet, List, Sequence, Tuple

from ..chem import canon_smiles, get_mol
from ..graph.chemutils import find_fragments
from ..graph.mol_graph import MolGraph, tensorize
from ..graph.vocab import canon_fragments
from .batching import pad_batch


def pool(ncpu: int):
    """A pool of ``ncpu`` host-chemistry workers, safe to start after CUDA
    is initialised."""
    return multiprocessing.get_context('forkserver').Pool(ncpu)


def fragment_counts(smiles_list: Sequence[str]) -> Counter:
    """Pass 1: count motif fragments (reference get_vocab.py:30-40)."""
    counter: Counter = Counter()
    for smiles in smiles_list:
        try:
            mol = get_mol(smiles)
            if mol is None:
                continue
            for fsmiles, _ in find_fragments(mol):
                counter[fsmiles] += 1
        except Exception as e:
            print(f'Error at {smiles}: {e}')
    return counter


def collect_labels(smiles_list: Sequence[str],
                   fragments: AbstractSet[str] = frozenset()) -> set:
    """Pass 2: collect (smiles, ismiles) labels incl. anchor pairs
    (reference get_vocab.py:11-27); ``fragments`` are the canonical SMILES
    of the frequent fragments that motif pooling merges."""
    vocab = set()
    for i, line in enumerate(smiles_list):
        try:
            line = line.strip('\r\n ')
            hmol = MolGraph(line, fragments)
            for _, attr in hmol.mol_tree.nodes(data=True):
                smiles = attr['smiles']
                vocab.add(attr['label'])
                for _, s in attr['inter_label']:
                    vocab.add((smiles, s))
        except Exception as e:
            print(f'Error at line {i} ({line}): {e}')
    return vocab


def _collect_labels_task(task) -> set:
    return collect_labels(*task)


def build_vocab(smiles_list: Sequence[str], min_frequency: int = 100,
                ncpu: int = 1) -> Tuple[List[Tuple[str, str, bool]], set]:
    """Full two-pass vocabulary build.  Returns ([(smiles, ismiles,
    is_frequent_fragment)], fragment_set)."""
    smiles_list = [s for s in dict.fromkeys(smiles_list) if s]
    bs = len(smiles_list) // max(ncpu, 1) + 1
    chunks = [smiles_list[i:i + bs] for i in range(0, len(smiles_list), bs)]
    with pool(ncpu) if ncpu > 1 else contextlib.nullcontext() as p:
        mapped = p.map if p else map
        counter = sum(mapped(fragment_counts, chunks), Counter())
        fragments = [f for f, cnt in counter.most_common()
                     if cnt >= min_frequency]
        fragment_set = set(fragments)
        pooled = canon_fragments(fragments)
        vocab = set().union(*mapped(_collect_labels_task,
                                    [(c, pooled) for c in chunks]))

    rows = []
    for x, y in sorted(vocab):
        cx = canon_smiles(x)
        rows.append((x, y, cx in fragment_set))
    return rows, fragment_set


def write_vocab(rows, path: str) -> None:
    with open(path, 'w') as f:
        f.write('\n'.join(' '.join([x, y, str(flag)]) for x, y, flag in rows))


def merge_vocabs(paths: Sequence[str]) -> List[str]:
    """Order-preserving union of vocab files (reference merge_vocab.py),
    keyed on the (smiles, ismiles) pair so the same entry appearing with
    and without a fragment flag merges into one row (flags OR together)."""
    seen: dict = {}
    for p in paths:
        with open(p) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                key = (parts[0], parts[1])
                flag = len(parts) >= 3 and parts[2] == 'True'
                seen[key] = seen.get(key, False) or flag
    return [f'{x} {y} {flag}' for (x, y), flag in seen.items()]


def _tensorize_chunk(args):
    batches, vocab, avocab, do_pad = args
    out = []
    for batch in batches:
        try:
            mb = tensorize(batch, vocab, avocab)
            out.append(pad_batch(mb) if do_pad else mb)
        except Exception as e:
            print(f'tensorize error: {e}')
    return out


def _fan_out(batches: Sequence, vocab, avocab, ncpu: int, pad: bool):
    """``_tensorize_chunk`` over ``batches``, split into ``ncpu`` chunks on
    a pool when ``ncpu`` > 1; the batches keep their order."""
    if ncpu <= 1:
        return _tensorize_chunk((list(batches), vocab, avocab, pad))
    bs = len(batches) // ncpu + 1
    chunks = [(list(batches[i:i + bs]), vocab, avocab, pad)
              for i in range(0, len(batches), bs)]
    with pool(ncpu) as p:
        results = p.map(_tensorize_chunk, chunks)
    return [b for r in results for b in r]


def tensorize_batches(batches: Sequence, vocab, avocab, ncpu: int = 1,
                      pad: bool = True):
    """Tensorize (and optionally pad) pre-split molecule batches, fanning
    out over ``ncpu`` processes (the reference preprocesses with a
    multiprocessing Pool too, preprocess.py:57-63)."""
    return _fan_out(batches, vocab, avocab,
                    ncpu if len(batches) > ncpu else 1, pad)


def preprocess_to_shards(data: Sequence, vocab, avocab, out_dir: str,
                         batch_size: int = 20, batches_per_shard: int = 1000,
                         ncpu: int = 1, seed: int = 1, pad: bool = True) -> int:
    """Tensorize and pickle training shards (reference preprocess.py:45-78):
    ``data`` shuffled by ``random.seed(seed)`` as the JAX package shuffles
    it, split into full batches of ``batch_size`` (the trailing partial
    batch is dropped), each padded to its bucket shape, ``batches_per_shard``
    to a file ``tensors-<i>.pkl``.  Returns the number of batches."""
    random.seed(seed)
    data = list(data)
    random.shuffle(data)
    batches = [data[i:i + batch_size] for i in range(0, len(data), batch_size)]
    batches = [b for b in batches if len(b) == batch_size]
    all_batches = _fan_out(batches, vocab, avocab, ncpu, pad)

    os.makedirs(out_dir, exist_ok=True)
    for n, i in enumerate(range(0, len(all_batches), batches_per_shard)):
        with open(os.path.join(out_dir, f'tensors-{n}.pkl'), 'wb') as f:
            pickle.dump(all_batches[i:i + batches_per_shard], f,
                        pickle.HIGHEST_PROTOCOL)
    return len(all_batches)
