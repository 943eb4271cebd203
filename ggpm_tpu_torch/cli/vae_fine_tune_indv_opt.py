"""Per-subnetwork-optimizer fine-tuning CLI (counterpart of
``ggpm_tpu/cli/vae_fine_tune_indv_opt.py``; reference
vae_fine_tune_indv_opt.py): the encoder, decoder, HOMO head and LUMO head
each get their own Adam with exponential decay
(``train.optim.make_multi_optimizer``).  ``vae_fine_tune --indv-opt``."""

from __future__ import annotations

import sys

from .vae_fine_tune import main as _main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if '--indv-opt' not in argv:
        argv.append('--indv-opt')
    return _main(argv)


if __name__ == '__main__':
    main()
