"""Model-level convenience API (counterpart of ``ggpm_tpu/models/api.py``:
``encode``, ``reconstruct``, ``sample``, ``reconstruct_enum_roots`` and
``optimize_recs``)."""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.batching import to_model_batch
from ..graph.vocab import PairVocab, common_atom_vocab
from .decode import decode_best, is_hier, sample_prior

_TREE_KEYS = ('fnode', 'fmess', 'agraph', 'bgraph', 'scope')

# the last ``reconstruct_enum_roots``: its rootings, and the seconds it took
# to build them, tensorize and encode them, and decode them
ENUM_ROOT_STATS: dict = {}


def _check_tree(tree: Dict[str, np.ndarray], n_atoms: int = 0) -> None:
    """Index tables must point inside the tables they index: the gathers
    on the card do not check their indices.  ``n_atoms``: the atom count
    that a tree's ``cgraph`` indexes."""
    n_nodes, n_mess = len(tree['fnode']), len(tree['fmess'])
    bounds = [(tree['agraph'], n_mess), (tree['bgraph'], n_mess),
              (tree['fmess'][:, :2], n_nodes), (tree['scope'][:, 0], n_nodes)]
    if n_atoms:
        bounds.append((tree['cgraph'], n_atoms))
    for table, n in bounds:
        if table.size and (table.min() < 0 or table.max() >= n):
            raise ValueError(f'tree index table out of range [0, {n})')


def tree_to_device(tree: Dict[str, np.ndarray], device: torch.device,
                   keys=_TREE_KEYS, n_atoms: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """The ``keys`` of a level of a ``to_model_batch`` dict (the tree
    level's by default) as tensors on ``device``."""
    _check_tree(tree, n_atoms)
    return {k: torch.as_tensor(np.ascontiguousarray(tree[k]), device=device)
            for k in keys}


@torch.no_grad()
def encode(model, batch: dict, eps: Optional[torch.Tensor] = None):
    """Latent code and KL of a model batch, on the model's device; no noise
    unless ``eps`` is given (reference eval-time convention).  The hier
    family also reads the atom level, ``batch['graph']``, and the tree's
    cluster table ``cgraph`` (JAX ``api.encode``)."""
    device = next(model.parameters()).device
    if not is_hier(model):
        return model.encode_latent(tree_to_device(batch['tree'], device),
                                   eps)
    graph = tree_to_device(batch['graph'], device)
    tree = tree_to_device(batch['tree'], device, _TREE_KEYS + ('cgraph',),
                          n_atoms=len(batch['graph']['fnode']))
    return model.encode_latent(tree, eps, graph=graph)


def reconstruct(model, mb, vocab: PairVocab, avocab=common_atom_vocab,
                greedy: bool = True, max_decode_step: int = 150, **kwargs):
    """Encode without noise, then decode (reference ``reconstruct``).
    Returns (property_outputs_or_None, (results, smiles))."""
    z, _ = encode(model, to_model_batch(mb, vocab.mask, pad=False))
    props = None
    if hasattr(model, 'predict_properties'):
        with torch.no_grad():
            props = tuple(p.cpu().numpy() for p in model.predict_properties(z))
    out = decode_best(model, vocab, avocab, z, greedy=greedy,
                      max_decode_step=max_decode_step, **kwargs)
    return props, out


def sample(model, vocab: PairVocab, batch_size: int,
           avocab=common_atom_vocab, seed: int = 0, **kwargs):
    """Sample from the prior (reference ``sample``)."""
    return sample_prior(model, vocab, avocab, batch_size,
                        rng=np.random.default_rng(seed), **kwargs)


def _enum_prune_chunk(task):
    """Pool worker: the in-vocab rootings of a chunk of molecules, as
    (molecule index, rooting SMILES) pairs (each rooting costs a full
    ``MolGraph`` decomposition)."""
    rows, max_roots, vocab = task
    from ..chem import get_mol, mol_to_smiles
    from ..data.dataset import prune_to_vocab
    from ..graph.chemutils import get_leaves
    out = []
    for i, smiles in rows:
        mol = get_mol(smiles)
        if mol is None:
            continue
        roots = get_leaves(mol)[:max_roots]
        vs = sorted({mol_to_smiles(mol, root=r) for r in roots}) or [smiles]
        for row in prune_to_vocab([[v, None, None] for v in vs], vocab,
                                  verbose=False):
            out.append((i, row[0]))
    return out


def reconstruct_enum_roots(model, smiles_list, vocab: PairVocab,
                           avocab=common_atom_vocab, max_roots: int = 6,
                           max_decode_step: int = 150,
                           decode_batch: int = 120, ncpu: int = 8,
                           record: Optional[dict] = None, **kwargs):
    """Robust reconstruction via root enumeration (the reference's
    MolEnumRootDataset protocol, dataset.py:46-75 + vae_test harness):
    re-root each input SMILES at up to ``max_roots`` of its leaves, encode
    every in-vocab rooting without noise and decode them all, and report
    success if any decode reproduces the molecule.

    The rootings of all molecules are pooled, tensorized in padded chunks
    of 64 (on ``ncpu`` host processes) and encoded chunk by chunk; one
    ``decode_best`` call decodes them all (greedy, without logs: the
    family's turbo path, ``decode_batch`` latents a round).

    Returns [(original, best_decode, matched_bool)]: ``best`` is the first
    rooting's decode that reproduces the molecule, else the first that
    decoded at all, else None.  A ``record`` dict receives what was
    decoded: ``src`` (each pooled rooting's molecule index), ``batches``
    (the padded chunks, 64 rootings each, as encoded) and ``z`` (the
    rootings' latents, one row each, in that order)."""
    from ..chem import canon_smiles
    from ..data.vocab_extract import pool, tensorize_batches

    t0 = time.time()
    rows = list(enumerate(smiles_list))
    tasks = [(rows[i:i + 64], max_roots, vocab)
             for i in range(0, len(rows), 64)]
    if ncpu > 1 and len(tasks) > 1:
        with pool(min(ncpu, len(tasks))) as p:
            chunks = p.map(_enum_prune_chunk, tasks)
    else:
        chunks = [_enum_prune_chunk(t) for t in tasks]
    variants, src = [], []
    for ch in chunks:
        for i, v in ch:
            variants.append(v)
            src.append(i)
    ENUM_ROOT_STATS.clear()
    ENUM_ROOT_STATS.update(molecules=len(smiles_list), rootings=len(variants),
                           rooting_s=time.time() - t0)
    if len(variants) > 4096:
        print(f'enum-root: {len(variants)} rootings for '
              f'{len(smiles_list)} molecules ({time.time() - t0:.0f}s)',
              flush=True)

    vchunks = [[[v, None, None] for v in variants[i:i + 64]]
               for i in range(0, len(variants), 64)]
    mbs = tensorize_batches(vchunks, vocab, avocab, ncpu=ncpu)
    zs = []
    for k, mb in enumerate(mbs):
        if k and (k * 64) % 8192 == 0:
            print(f'enum-root: encoded {k * 64}/{len(variants)} rootings '
                  f'({time.time() - t0:.0f}s)', flush=True)
        z, _ = encode(model, to_model_batch(mb, vocab.mask, pad=False))
        zs.append(z[:len(vchunks[k])])
    t1 = time.time()
    ENUM_ROOT_STATS['encode_s'] = t1 - t0 - ENUM_ROOT_STATS['rooting_s']

    decoded: list = []
    z_all = torch.cat(zs) if zs else None
    if zs:
        _, decoded = decode_best(model, vocab, avocab, z_all,
                                 greedy=True, max_decode_step=max_decode_step,
                                 log_steps=False, chunk=decode_batch,
                                 **kwargs)
    ENUM_ROOT_STATS['decode_s'] = time.time() - t1
    if record is not None:
        record.update(src=src, batches=mbs, z=z_all)

    by_src: dict = {}
    for v_idx, s_idx in enumerate(src):
        by_src.setdefault(s_idx, []).append(v_idx)
    out = []
    for i, smiles in enumerate(smiles_list):
        target = canon_smiles(smiles)
        best, matched = None, False
        for v_idx in by_src.get(i, []):
            d = decoded[v_idx]
            if d is None:
                continue
            if best is None:
                best = d
            if canon_smiles(d) == target:
                best, matched = d, True
                break
        out.append((smiles, best, matched))
    return out


def optimize_recs(model, mb, vocab: PairVocab, avocab=common_atom_vocab,
                  optimize_type: str = 'hard', **opt_kwargs):
    """Latent property optimisation, then decode (reference
    ``optimize_recs``): encode ``mb`` without noise, search its latents
    against its own HOMO/LUMO labels (``LatentOptimizer``), predict the
    properties at the searched latents and decode them greedily through
    ``decode_best``.  Returns ((homo, lumo) as numpy, (results,
    smiles))."""
    from ..latent.control import LatentOptimizer
    z, _ = encode(model, to_model_batch(mb, vocab.mask, pad=False))
    opt = LatentOptimizer(model, optimize_type=optimize_type, **opt_kwargs)
    z_opt = opt.optimize(z, mb.homos, mb.lumos)
    with torch.no_grad():
        props = tuple(p.cpu().numpy() for p in model.predict_properties(z_opt))
    out = decode_best(model, vocab, avocab, z_opt, greedy=True,
                      max_decode_step=150)
    return props, out
