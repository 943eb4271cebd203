"""The one traffic generator: what a training cell feeds the program,
from its traffic file's parameters and the run's seed.

A training traffic names a CSV of (SMILES, HOMO, LUMO) rows (``data``),
which the program prunes to its vocab and cuts into full batches of the
configuration's size, the short last one left out; how many batches a
flush of the trainer takes at most (``scan_chunk``) and how many epochs
set-up runs before the window (``warmup_epochs``).  Each epoch takes the
batches in an order drawn from the seed and the epoch's index (the
reference's ``DataFolder`` shuffles alike), so every seed runs the same
batches and the same work, in another order.  The steps' latent noise is
seeded with ``noise_seed``.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..reference.data.rows import read_csv_data


def rows(traffic: Dict, root: str) -> List[list]:
    """The traffic's raw rows, as the data file holds them."""
    return read_csv_data(os.path.join(root, traffic['data']))


def n_batches(n_rows: int, batch_size: int) -> int:
    """How many batches an epoch runs over ``n_rows`` in-vocab rows."""
    return n_rows // batch_size


def epoch_order(seed: int, epoch: int, n: int) -> List[int]:
    """The order of the ``n`` batches in epoch ``epoch`` of a run."""
    rng = np.random.default_rng([int(seed), int(epoch)])
    return [int(i) for i in rng.permutation(n)]


def noise_seed(seed: int) -> int:
    """The seed of the steps' latent noise (a generator on the device)."""
    return int(np.random.SeedSequence([int(seed), 1]).generate_state(
        1, np.uint64)[0] >> 1)
