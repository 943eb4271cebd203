"""Reconstruction inference CLI (counterpart of
``ggpm_tpu/cli/reconstruct.py``; reference reconstruct.py).

Usage:
    python -m ggpm_tpu_torch.cli.reconstruct --path-to-config configs.json \\
        [--model-type prop-opt|hier-prop|...] [--fast-decode] [--device cpu]

Encodes each test molecule (the config's ``test_data``, else ``data``)
without latent noise, decodes greedily, and writes the config's ``output``
CSV (default ``reconstructions.csv``: original and reconstructed SMILES,
and the predicted HOMO/LUMO for ``prop-opt`` and ``hier-prop-opt``) and a
pickle of the per-step decode logs beside it.  ``--fast-decode`` takes the
turbo decode (the same SMILES, no per-step logs; the hier family decodes
through its exact path either way).  Runs on the card
(``cuda``) unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch

from ..configs import Configs
from ..data.batching import to_model_batch
from ..data.dataset import MoleculeDataset
from ..graph.vocab import common_atom_vocab
from ..models.api import encode
from ..models.decode import (decode_best, decode_hier, decode_motif,
                             is_hier)
from .common import load_checkpoint, read_csv_data, setup_model, write_csv


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--path-to-config', required=True)
    parser.add_argument('--model-type', default='prop')
    parser.add_argument('--batch-size', type=int, default=20)
    parser.add_argument('--max-decode-step', type=int, default=150)
    parser.add_argument('--fast-decode', action='store_true',
                        help='use the turbo decode (the propose loop on '
                             'the device); identical SMILES output, but no '
                             'per-step logs in logs.pkl')
    parser.add_argument('--device', default='cuda',
                        help='torch device to run on (default: cuda)')
    args = parser.parse_args(argv)

    configs = Configs(path=args.path_to_config)
    model, vocab, _ = setup_model(configs, args.model_type)
    load_checkpoint(model, configs)
    model = model.eval().to(args.device)
    data = read_csv_data(configs.get('test_data') or configs.get('data'))
    dataset = MoleculeDataset(data, vocab, common_atom_vocab, args.batch_size)
    # the JAX CLI's list: prop-opt-sched has heads but counts as none
    has_props = args.model_type in ('prop-opt', 'hier-prop-opt')
    if args.fast_decode:
        def decode_fn(*a, **kw):
            return decode_best(*a, log_steps=False, **kw)
    else:
        decode_fn = decode_hier if is_hier(model) else decode_motif

    rows, logs = [], []
    for i in range(len(dataset)):
        mb = dataset[i]
        z, _ = encode(model, to_model_batch(mb, vocab.mask, pad=False))
        if has_props:
            with torch.no_grad():
                homo_p, lumo_p = (p.cpu().numpy()
                                  for p in model.predict_properties(z))
        else:
            homo_p = lumo_p = [None] * len(mb.smiles)
        results, smiles = decode_fn(model, vocab, common_atom_vocab, z,
                                    greedy=True,
                                    max_decode_step=args.max_decode_step)
        logs.extend(results)
        for org, dec, h, l in zip(mb.smiles, smiles, homo_p, lumo_p):
            rows.append({'original': org, 'reconstructed': dec,
                         'HOMO': None if h is None else float(h),
                         'LUMO': None if l is None else float(l)})
        print(f'batch {i + 1}/{len(dataset)} done')

    out = configs.get('output', 'reconstructions.csv')
    write_csv(out, rows)
    with open(os.path.splitext(out)[0] + '_logs.pkl', 'wb') as f:
        pickle.dump(logs, f)
    print(f'wrote {out}')
    return rows


if __name__ == '__main__':
    main()
