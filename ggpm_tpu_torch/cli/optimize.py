"""Property-guided latent optimisation CLI (counterpart of
``ggpm_tpu/cli/optimize.py``; reference optimize.py).

Usage:
    python -m ggpm_tpu_torch.cli.optimize --path-to-config configs.json \\
        [--optimize-type soft|patience|fixed|hard] [--fast-decode] \\
        [--device cpu]

Encodes each batch of the config's ``test_data`` (else ``data``) CSV,
searches the latents against the molecules' own HOMO/LUMO labels
(``latent.control.LatentOptimizer``; the flags override the config's
``optimize_type``, ``latent_lr``, ``property_optim_step``,
``property_delta``, ``patience`` and ``patience_threshold``), predicts the
properties before and after, decodes the searched latents, and writes
``reconstructed_molecules_after_{prefix}.csv``,
``property_prediction_after_{prefix}.csv`` and ``{prefix}_logs.pkl`` in
the working directory (``prefix``: the config's ``output`` without its
extension, else ``{optimize_type}_optimize``).  ``--fast-decode`` takes
the turbo decode (the same SMILES, no per-step logs).  Runs on the card
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
from ..latent.control import POLICIES, LatentOptimizer
from ..models.api import encode
from ..models.decode import (decode_best, decode_hier, decode_motif,
                             is_hier)
from .common import load_checkpoint, read_csv_data, setup_model, write_csv


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--path-to-config', required=True)
    parser.add_argument('--model-type', default='prop-opt')
    parser.add_argument('--optimize-type', default=None,
                        choices=[None, *POLICIES])
    parser.add_argument('--optim-step', type=int, default=None)
    parser.add_argument('--latent-lr', type=float, default=None)
    parser.add_argument('--property-delta', type=float, default=None)
    parser.add_argument('--patience-threshold', type=float, default=None)
    parser.add_argument('--patience', type=int, default=None)
    parser.add_argument('--batch-size', type=int, default=20)
    parser.add_argument('--fast-decode', action='store_true',
                        help='use the turbo decode (the propose loop on '
                             'the device); identical SMILES output, but no '
                             'per-step logs in logs.pkl')
    parser.add_argument('--device', default='cuda',
                        help='torch device to run on (default: cuda)')
    args = parser.parse_args(argv)

    configs = Configs(path=args.path_to_config)
    # CLI overrides config (reference optimize.py:36-43)
    opt_type = args.optimize_type or configs.get('optimize_type', 'soft')
    opt = dict(
        optimize_type=opt_type,
        latent_lr=args.latent_lr or configs.get('latent_lr', 1.0),
        property_optim_step=args.optim_step or configs.get(
            'property_optim_step', 50),
        property_delta=args.property_delta or configs.get('property_delta',
                                                          0.1),
        patience=args.patience or configs.get('patience', 5),
        patience_threshold=args.patience_threshold or configs.get(
            'patience_threshold', 0.1),
    )

    model, vocab, _ = setup_model(configs, args.model_type)
    load_checkpoint(model, configs)
    model = model.eval().to(args.device)
    data = read_csv_data(configs.get('test_data') or configs.get('data'))
    dataset = MoleculeDataset(data, vocab, common_atom_vocab, args.batch_size)
    latent_opt = LatentOptimizer(model, **opt)
    if args.fast_decode:
        def decode_fn(*a, **kw):
            return decode_best(*a, log_steps=False, **kw)
    else:
        decode_fn = decode_hier if is_hier(model) else decode_motif

    recon_rows, prop_rows, logs = [], [], []
    for i in range(len(dataset)):
        mb = dataset[i]
        z, _ = encode(model, to_model_batch(mb, vocab.mask, pad=False))
        z_opt = latent_opt.optimize(z, mb.homos, mb.lumos)
        with torch.no_grad():
            h0, l0, h1, l1 = (p.cpu().numpy() for p in (
                *model.predict_properties(z), *model.predict_properties(z_opt)))
        results, smiles = decode_fn(model, vocab, common_atom_vocab, z_opt,
                                    greedy=True, max_decode_step=150)
        logs.extend(results)
        for org, dec, a, b, c, d, ht, lt in zip(
                mb.smiles, smiles, h0, l0, h1, l1, mb.homos, mb.lumos):
            recon_rows.append({'original': org, 'reconstructed': dec})
            prop_rows.append({'org_homo': float(a), 'org_lumo': float(b),
                              'new_homo': float(c), 'new_lumo': float(d),
                              'target_homo': float(ht),
                              'target_lumo': float(lt)})
        print(f'batch {i + 1}/{len(dataset)} done')

    prefix = os.path.splitext(configs.get('output', f'{opt_type}_optimize'))[0]
    write_csv(f'reconstructed_molecules_after_{prefix}.csv', recon_rows)
    write_csv(f'property_prediction_after_{prefix}.csv', prop_rows)
    with open(f'{prefix}_logs.pkl', 'wb') as f:
        pickle.dump(logs, f)
    print(f'wrote {prefix} outputs')
    return recon_rows, prop_rows


if __name__ == '__main__':
    main()
