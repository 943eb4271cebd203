"""End-to-end quality run on the port: vocab → train → reconstruct →
metrics (counterpart of ``scripts/quality_run.py``, with the same flags and
JSON keys).

Usage:
    python -m ggpm_tpu_torch.quality_run [--epochs N] [--data PATH] \\
        [--device cpu] ...

Eval only, from a trained checkpoint (``--data``/``--min-freq`` must be the
saving run's, so that the rebuilt vocab is its vocab):

    python -m ggpm_tpu_torch.quality_run --data data/hopv15.csv \\
        --min-freq 10 --load-ckpt runs/QUALITY_hopv.json.ckpt --epochs 0 \\
        --ft-epochs 0 --n-test 60 --enum-root 6 --out /tmp/q.json

Training goes through the port's ``Trainer``: each group of same-shape
batches an epoch through ``scan_steps`` (CUDA graphs on the card), a group
of one through ``train_step``.  The JSON's ``platform`` is the torch device
type (``cuda`` on the card, with ``device_name``); like the JAX script it
writes ``<out>.ckpt`` and ``<out>.vocab.txt`` beside ``--out``.
"""

from __future__ import annotations

import argparse
import csv
import json
import random
import time
from typing import Dict, List

import numpy as np
import torch

# the metrics read from the reconstructions' strings, the prior samples'
# and the enum-root decodes' (``compare``)
RECON_METRICS = ('validity', 'diversity', 'SNN', 'Frag', 'MW', 'SA',
                 'FP-Frechet', 'recon_accuracy')
# every one is held to 1e-12 relative but FP-Frechet: its matrix square
# root of an ill-conditioned product (condition ~1e6) may move further
# under another LAPACK build
METRIC_RTOL = 1e-12
FP_FRECHET_RTOL = 1e-6
PROPERTY_MAE_ATOL = 1e-4


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument('--data', default='data/hopv15.csv')
    ap.add_argument('--epochs', type=int, default=300)
    ap.add_argument('--ft-epochs', type=int, default=150)
    ap.add_argument('--min-freq', type=int, default=10)
    ap.add_argument('--n-test', type=int, default=60)
    ap.add_argument('--hidden', type=int, default=250)
    ap.add_argument('--latent', type=int, default=24)
    ap.add_argument('--batch-size', type=int, default=20)
    ap.add_argument('--out', default='QUALITY.json')
    ap.add_argument('--limit', type=int, default=0)
    ap.add_argument('--model', default='prop-opt',
                    choices=['prop-opt', 'prop', 'hier-prop', 'hier-prop-opt'])
    ap.add_argument('--holdout', type=int, default=0,
                    help='hold out N molecules from training and evaluate '
                         'reconstruction/property MAE on them (default 0 = '
                         'evaluate on training molecules)')
    ap.add_argument('--eval-data', default=None,
                    help='evaluate on this file instead of a holdout slice')
    ap.add_argument('--eval-limit', type=int, default=0,
                    help='cap the --eval-data set size')
    ap.add_argument('--enum-root', type=int, default=6,
                    help='also evaluate reconstruction with the enum-root '
                         'protocol (re-root each eval molecule at up to N '
                         'leaves; success if ANY rooting round-trips); 0 '
                         'disables')
    ap.add_argument('--decode-steps', type=int, default=150,
                    help='autoregressive decode budget (reference cap 150)')
    ap.add_argument('--load-ckpt', default=None,
                    help='initialise params from this checkpoint (with '
                         '--epochs 0 --ft-epochs 0: an eval-only run)')
    ap.add_argument('--dump-recon', default=None,
                    help='write an original,reconstructed,org_homo,'
                         'org_lumo,homo,lumo CSV')
    ap.add_argument('--device', default='cuda',
                    help='torch device (default: cuda)')
    return ap


def _read(path: str) -> List[list]:
    from .data.dataset import read_csv_data
    if path.endswith('.txt'):
        with open(path) as f:
            return [[line.strip(), None, None] for line in f if line.strip()]
    return read_csv_data(path)


def run(args) -> Dict:
    """The run; returns ``qual`` (the JSON the script writes) beside its
    strings, ``recon`` [(original, decoded)], ``sampled`` and
    ``enum_root`` [(original, best, matched)], its train metrics
    unrounded (``train_metrics``), and the latents it decoded with the
    padded batches it encoded them from (``decoded``: ``recon`` holds
    ``z``, ``batches`` and ``batch_size``, ``enum_root`` what
    ``reconstruct_enum_roots`` records)."""
    from .bridge import load_flax_params, to_flax_tree
    from .chem import canon_smiles
    from .cli.common import MODELS
    from .data.batching import pad_batch, to_model_batch
    from .data.dataset import prune_to_vocab
    from .data.vocab_extract import build_vocab, tensorize_batches, write_vocab
    from .eval.metrics import Metrics
    from .graph.mol_graph import tensorize
    from .graph.vocab import PairVocab, canon_fragments, common_atom_vocab
    from .models.api import encode, reconstruct_enum_roots
    from .models.decode import decode_best, sample_prior
    from .models.vae import ModelConfig, init_params
    from .train import checkpoint as ckpt
    from .train.loop import Trainer, signature
    from .train.optim import make_optimizer

    device = torch.device(args.device)
    t_start = time.time()
    data = _read(args.data)
    if args.limit:
        data = data[:args.limit]
    print(f'{len(data)} molecules', flush=True)

    vocab_rows, fragments = build_vocab([r[0] for r in data], args.min_freq,
                                        ncpu=8)
    vocab = PairVocab([(x, y) for x, y, _ in vocab_rows],
                      fragments=canon_fragments(fragments))
    print(f'vocab {vocab.size()}', flush=True)

    data = prune_to_vocab(data, vocab)
    if args.eval_data:
        eval_rows = _read(args.eval_data)
        if args.eval_limit:
            eval_rows = eval_rows[:args.eval_limit]
        holdout = prune_to_vocab(eval_rows, vocab)
        print(f'evaluating on {len(holdout)} molecules from '
              f'{args.eval_data}; training on {len(data)}', flush=True)
    elif args.holdout > 0:
        # the vocab comes from the full set, so that held-out molecules
        # tensorize; training never sees their tensors
        random.Random(1).shuffle(data)
        holdout, data = data[:args.holdout], data[args.holdout:]
        print(f'held out {len(holdout)} molecules; training on {len(data)}',
              flush=True)
    else:
        holdout = None
    batch_size = args.batch_size
    raw = [data[i:i + batch_size]
           for i in range(0, len(data) - batch_size + 1, batch_size)]
    batches = tensorize_batches(raw, vocab, common_atom_vocab, ncpu=8)
    print(f'{len(batches)} train batches in {time.time() - t_start:.0f}s',
          flush=True)

    cfg = ModelConfig(hvocab_size=vocab.size()[0], ivocab_size=vocab.size()[1],
                      rnn_type='LSTM', hidden_size=args.hidden,
                      embed_size=args.hidden, latent_size=args.latent,
                      linear_hidden_size=128, depthT=20, depthG=20,
                      diterT=1, diterG=3, dropout=0.0)
    model = MODELS[args.model](cfg)
    init_params(model, torch.Generator().manual_seed(0))
    opt = make_optimizer(lr=1e-3, clip_norm=20.0, anneal_rate=0.995,
                         steps_per_epoch=len(batches))
    trainer = Trainer(model, opt, vocab.mask, beta=0.1, print_iter=500,
                      device=args.device)
    model = trainer.model
    if args.load_ckpt:
        load_flax_params(model, ckpt.load_params(to_flax_tree(model),
                                                 args.load_ckpt))
        print(f'loaded params from {args.load_ckpt}', flush=True)

    # same-shape batches as one group an epoch, in the order the groups
    # open (the JAX script's scan over each group)
    groups: Dict = {}
    for mb in batches:
        host = trainer.host_batch(mb)
        groups.setdefault(signature(host), []).append(
            trainer.device_batch(host))
    t0 = time.time()
    n_epochs = args.epochs + args.ft_epochs
    metrics = None
    for epoch in range(n_epochs):
        for group in groups.values():
            if len(group) == 1:
                metrics, _ = trainer.train_step(group[0])
            else:
                metrics, _ = trainer.scan_steps(group)
        if epoch % 50 == 0:
            m = {k: round(float(v.reshape(-1)[-1]), 3)
                 for k, v in metrics.items()}
            print(f'epoch {epoch}: {m}', flush=True)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    print(f'trained in {time.time() - t0:.0f}s', flush=True)
    if n_epochs > 0:
        ckpt.save_params(to_flax_tree(model), args.out + '.ckpt')
        write_vocab(vocab_rows, args.out + '.vocab.txt')
        print(f'checkpoint saved to {args.out}.ckpt', flush=True)
    ev = trainer.evaluate(batches)
    print('final train metrics:', {k: round(v, 3) for k, v in ev.items()},
          flush=True)

    # ---- reconstruction + property prediction on the eval subset ----------
    model.eval()
    test = holdout if holdout is not None else data[:args.n_test]
    kept, zs, hps, lps, padded = [], [], [], [], []
    for i in range(0, len(test), batch_size):
        chunk = test[i:i + batch_size]
        padded.append(pad_batch(tensorize(chunk, vocab, common_atom_vocab)))
        z, _ = encode(model, to_model_batch(padded[-1], vocab.mask,
                                            pad=False))
        z = z[:len(chunk)]
        if hasattr(model, 'predict_properties'):
            with torch.no_grad():
                hp, lp = (p.cpu().numpy()
                          for p in model.predict_properties(z))
        else:
            hp = lp = np.full(len(chunk), np.nan)
        kept += chunk
        zs.append(z)
        hps.append(hp)
        lps.append(lp)
    zs = (torch.cat(zs) if zs
          else torch.zeros((0, args.latent), device=device))
    hps = np.concatenate(hps) if hps else np.zeros(0)
    lps = np.concatenate(lps) if lps else np.zeros(0)

    homo_err = [abs(hh - h) for (s, h, l), hh in zip(kept, hps)
                if h is not None and np.isfinite(hh)]
    lumo_err = [abs(ll - l) for (s, h, l), ll in zip(kept, lps)
                if l is not None and np.isfinite(ll)]

    recon_pairs, recon_rows = [], []
    t_dec = time.time()
    dec_bs = min(120, max(len(kept), 1))
    for i in range(0, len(kept), dec_bs):
        chunk = kept[i:i + dec_bs]
        _, smiles = decode_best(model, vocab, common_atom_vocab,
                                zs[i:i + dec_bs], greedy=True,
                                max_decode_step=args.decode_steps,
                                log_steps=False)
        recon_pairs += list(zip([c[0] for c in chunk], smiles))
        for (s, h, l), dec, hh, ll in zip(chunk, smiles, hps[i:i + dec_bs],
                                          lps[i:i + dec_bs]):
            recon_rows.append((s, dec or '', h, l,
                               float(hh) if np.isfinite(hh) else '',
                               float(ll) if np.isfinite(ll) else ''))
        print(f'decoded {len(recon_pairs)} molecules '
              f'({time.time() - t_dec:.0f}s)', flush=True)
    decode_seconds = time.time() - t_dec

    gen = [d for _, d in recon_pairs]
    ref = [o for o, _ in recon_pairs]
    M = Metrics(device=args.device)
    qual = M.get_recon_n_sample_metrics(gen, ref)

    _, sampled = sample_prior(model, vocab, common_atom_vocab,
                              min(40, batch_size * 2),
                              rng=np.random.default_rng(7),
                              max_decode_step=min(120, args.decode_steps),
                              log_steps=False)
    qual['prior_sample'] = {
        'validity': M.validity(sampled),
        'uniqueness': M.uniqueness(sampled),
        'diversity': M.internal_diversity(sampled),
        'SNN_to_train': M.snn(sampled, [r[0] for r in data[:200]]),
    }
    matches = sum(1 for o, d in recon_pairs
                  if d and canon_smiles(o) == canon_smiles(d))
    qual['recon_accuracy'] = matches / max(len(recon_pairs), 1)
    enum_out, enum_decoded = [], {}
    if args.enum_root and kept:
        t_enum = time.time()
        enum_out = reconstruct_enum_roots(
            model, [r[0] for r in kept], vocab, common_atom_vocab,
            max_roots=args.enum_root, max_decode_step=args.decode_steps,
            record=enum_decoded)
        qual['recon_accuracy_enum_root'] = (
            sum(1 for _, _, m in enum_out if m) / len(enum_out))
        qual['enum_root_seconds'] = round(time.time() - t_enum, 1)
        print(f'enum-root recon: {qual["recon_accuracy_enum_root"]:.3f} '
              f'({qual["enum_root_seconds"]}s)', flush=True)
    qual['HOMO_MAE'] = float(np.mean(homo_err)) if homo_err else None
    qual['LUMO_MAE'] = float(np.mean(lumo_err)) if lumo_err else None
    qual['train_metrics'] = {k: round(float(v), 4) for k, v in ev.items()}
    qual['wall_seconds'] = round(time.time() - t_start, 1)
    qual['decode_seconds'] = round(decode_seconds, 1)
    qual['decode_mols_per_sec'] = round(len(recon_pairs) /
                                        max(decode_seconds, 1e-9), 2)
    qual['eval_split'] = 'holdout' if holdout is not None else 'train'
    qual['platform'] = device.type
    if device.type == 'cuda':
        qual['device_name'] = torch.cuda.get_device_name(device)
    print(json.dumps(qual, indent=2, default=float), flush=True)
    with open(args.out, 'w') as f:
        json.dump(qual, f, indent=2, default=float)

    if args.dump_recon:
        with open(args.dump_recon, 'w', newline='') as f:
            w = csv.writer(f)
            w.writerow(['original', 'reconstructed', 'org_homo', 'org_lumo',
                        'homo', 'lumo'])
            w.writerows(recon_rows)
        print(f'wrote {args.dump_recon}', flush=True)

    ckpt.save_params(to_flax_tree(model), args.out + '.ckpt')
    write_vocab(vocab_rows, args.out + '.vocab.txt')
    return dict(qual=qual, recon=recon_pairs, sampled=list(sampled),
                enum_root=enum_out, train_metrics=ev,
                decoded=dict(recon=dict(z=zs, batches=padded,
                                        batch_size=batch_size),
                             enum_root=enum_decoded))


def _close(got, want, rtol: float) -> bool:
    if got is None or want is None:
        return got is want
    return abs(got - want) <= rtol * max(1.0, abs(want))


def compare(result: Dict, golden: Dict) -> Dict[str, list]:
    """``run``'s result against a JAX golden (``scripts/quality_run.py``'s
    JSON and strings, its train metrics unrounded): ``differing`` holds
    the indices of the reconstructions, samples and enum-root triples whose
    strings differ; ``bad`` each metric that breaks the rule: a metric
    read from strings equals the golden's (``METRIC_RTOL``, FP-Frechet
    ``FP_FRECHET_RTOL``) wherever all its strings are equal, HOMO/LUMO MAE
    within ``PROPERTY_MAE_ATOL``, and each train metric within the
    tolerance ``profile_train.check_golden`` holds a later step's to."""
    from .profile_train import (ACC_ATOL, ACCURACIES, PROPERTY_ATOL,
                                PROPERTY_KEYS, RTOL)
    qual, want = result['qual'], golden['qual']
    differing = {
        'recon': [i for i, (a, b) in enumerate(zip(result['recon'],
                                                   golden['recon']))
                  if list(a) != list(b)],
        'sampled': [i for i, (a, b) in enumerate(zip(result['sampled'],
                                                     golden['sampled']))
                    if a != b],
        'enum_root': [i for i, (a, b) in enumerate(zip(result['enum_root'],
                                                       golden['enum_root']))
                      if list(a) != list(b)]}
    bad = [f'{k}: {len(result[k])} entries, the golden has '
           f'{len(golden[k])}' for k in differing
           if len(result[k]) != len(golden[k])]
    checks = []
    if not differing['recon']:
        n = len(golden['recon'])
        checks += [(k, qual.get(k), want[k]) for k in RECON_METRICS]
        checks.append((f'unique@{n}', qual.get(f'unique@{n}'),
                       want[f'unique@{n}']))
    if not differing['sampled']:
        checks += [(f'prior_sample {k}', qual['prior_sample'].get(k), w)
                   for k, w in want['prior_sample'].items()]
    if not differing['enum_root'] and 'recon_accuracy_enum_root' in want:
        checks.append(('recon_accuracy_enum_root',
                       qual.get('recon_accuracy_enum_root'),
                       want['recon_accuracy_enum_root']))
    bad += [f'{k}: {g} vs {w}' for k, g, w in checks
            if not _close(g, w, FP_FRECHET_RTOL if k == 'FP-Frechet'
                          else METRIC_RTOL)]
    bad += [f'{k}: {qual[k]} vs {want[k]}' for k in ('HOMO_MAE', 'LUMO_MAE')
            if (qual[k] is None) != (want[k] is None) or (
                want[k] is not None and
                not abs(qual[k] - want[k]) <= PROPERTY_MAE_ATOL)]
    for k, w in golden['train_metrics'].items():
        g = result['train_metrics'].get(k, float('nan'))
        tol = (ACC_ATOL if k in ACCURACIES else
               PROPERTY_ATOL if k in PROPERTY_KEYS else RTOL * abs(w))
        if not abs(g - w) <= tol:
            bad.append(f'train {k}: {g} vs {w}')
    return dict(differing=differing, bad=bad)


def main(argv=None) -> Dict:
    return run(parser().parse_args(argv))


if __name__ == '__main__':
    main()
