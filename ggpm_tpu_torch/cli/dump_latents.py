"""Dump encoder latent vectors for a molecule set (counterpart of
``ggpm_tpu/cli/dump_latents.py``; the role of the reference's
``Scripts/hg2g/geth.py`` latent-dump helper).

Usage:
    python -m ggpm_tpu_torch.cli.dump_latents --path-to-config configs.json \\
        [--model-type prop] [--output latents.npy] [--batch-size 20] \\
        [--device cpu]

Encodes the config's ``test_data`` (else ``data``), pruned to the vocab,
without latent noise with the ``output_model`` (else ``saved_model``)
checkpoint, and writes the latents as one ``.npy`` array and the SMILES
they encode, one a line, to ``<output>.smiles.txt``.  Runs on the card
(``cuda``) unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..configs import Configs
from ..data.batching import to_model_batch
from ..data.dataset import MoleculeDataset
from ..graph.vocab import common_atom_vocab
from ..models.api import encode
from .common import load_checkpoint, read_csv_data, setup_model


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--path-to-config', required=True)
    parser.add_argument('--model-type', default='prop')
    parser.add_argument('--output', default='latents.npy')
    parser.add_argument('--batch-size', type=int, default=20)
    parser.add_argument('--device', default='cuda',
                        help='torch device to run on (default: cuda)')
    args = parser.parse_args(argv)

    configs = Configs(path=args.path_to_config)
    model, vocab, _ = setup_model(configs, args.model_type)
    load_checkpoint(model, configs)
    model = model.eval().to(args.device)
    data = read_csv_data(configs.get('test_data') or configs.get('data'))
    dataset = MoleculeDataset(data, vocab, common_atom_vocab, args.batch_size)

    zs, smiles = [], []
    for i in range(len(dataset)):
        mb = dataset[i]
        z, _ = encode(model, to_model_batch(mb, vocab.mask, pad=False))
        zs.append(z.cpu().numpy())
        smiles += mb.smiles
    np.save(args.output, np.concatenate(zs, axis=0))
    with open(args.output + '.smiles.txt', 'w') as f:
        f.write('\n'.join(smiles))
    print(f'wrote {sum(z.shape[0] for z in zs)} latents to {args.output}')
    return np.concatenate(zs, axis=0)


if __name__ == '__main__':
    main()
