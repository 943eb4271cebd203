"""Where the time of a training step goes on a GPU, and the 3-step check of
the port's training against the JAX package's (``golden_steps``,
``check_golden``) that chip_smoke.py, tests/test_torch_train.py and
tests/test_torch_propopt.py share.

    python -m ggpm_tpu_torch.profile_train [--out PATH]

The canonical configuration (``prop``: LSTM, hidden = embed = 250, latent
24, depthT 20, diterT 1, batch 20, dropout 0, β 0.1, Adam lr 1e-3, clip 20,
anneal 0.9 per epoch of 17 steps) from the ``vae/`` weights of the trained
HOPV checkpoint, on the 17 full batches of 20 of ``data/hopv15.csv``
(padded to their bucket shapes, lane-packed, as ``cli/vae_train.py`` and
the JAX ``Trainer`` make them).  It profiles an epoch of eager steps, then
one through ``Trainer.scan_steps``'s CUDA graphs (every flush replayed, a
flush of one too, as ``Trainer.train_epoch`` runs them on the card).
After one untimed epoch each reports, on the card: train mols/s over one
epoch of steps on batches already on the device (``bench.py``'s
definition), and through ``Trainer.train_epoch`` with the host's batch
preparation included; host ms per step, split into batch preparation and
the step's dispatch (or replay); device busy ms and the device's
idle share per step, both over one epoch run under torch.profiler (its
wall time is printed beside them; the profiler slows the host more than
the device, so the share may read higher than an unprofiled epoch's);
launches per step, in all and per kernel (B1 ``nei_sum``, its transpose
``transpose_sum``, the row gather ``gather_rows``); through graphs, the
graphs captured, their capture seconds and pools, and the peak memory.
Prints one JSON object (and writes it to ``--out``).  Needs a CUDA
device; it has no CPU mode.  ``hier_trainer`` gives the hier family's
step, which chip_smoke.py profiles alike.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .bridge import (HIER_TRAINED, flatten, load_flax_params, load_model,
                     load_prop_model, read_checkpoint, to_flax_tree)
from .data.batching import pad_batch
from .data.dataset import prune_to_vocab, read_csv_data
from .graph.mol_graph import MolGraphBatch, tensorize
from .graph.vocab import PairVocab, common_atom_vocab, load_vocab_file
from .models.vae import (HierPropertyVAE, HierPropOptVAE, ModelConfig,
                         PropertyVAE, PropOptSchedulingVAE, PropOptVAE,
                         init_params)
from .ops import gather_rows, nei_sum, transpose_sum
from .profile_serve import (HIER_CKPT, HIER_VOCAB, _device_us, by_kernel,
                            kernel_of, profiled, profiler_loss, top_kernels)
from .train.loop import MetricAccumulator, Trainer, flushes, signature
from .train.optim import (default_group_fn, make_multi_optimizer,
                          make_optimizer)

__all__ = ['golden_steps', 'check_golden', 'finetune_trainer', 'hier_trainer',
           'sched_trainer', 'attention_trainer', 'sched_step',
           'check_sched_step', 'hopv_batches', 'hopv_rows',
           'load_vocab_file', 'main']

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(_ROOT, 'runs', 'QUALITY_hopv.json.ckpt')
VOCAB = os.path.join(_ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(_ROOT, 'data', 'hopv15.csv')
BATCH_SIZE = 20
STEPS_PER_EPOCH = 17         # 350 in-vocab molecules: 17 full batches
BETA = 0.1
OPTIMIZER = dict(lr=1e-3, clip_norm=20.0, anneal_rate=0.9,
                 steps_per_epoch=STEPS_PER_EPOCH)
GOLDEN_STEPS = 3
# the prop-opt fine-tuning step (chip_smoke.py's finetune phase): the full
# checkpoint, OPTIMIZER's clip and decay, and one Adam per group
FINETUNE_LRS = {'encoder': 1e-3, 'decoder': 1e-3, 'homo': 5e-4, 'lumo': 5e-4}

# The rule holding the port's first 3 steps to the JAX package's
# (goldens/train_hopv.json), fixed before any card run.  Step 1: Loss and
# KL within 1e-5 relative, GNorm within 1e-4, and each leaf's update along
# its gradient (``update_norms``) within 1e-3, the same leaves' gradients
# being rounding noise.  Steps 2 and 3: Loss and KL within 1e-4, GNorm
# within 5e-3, and the update along the gradient within 1e-3 for every
# leaf whose gradient norm is at least 1e-2 of the step's GNorm in the
# golden (29 to 34 of the 46 leaves); the others' are printed, not held.
# Every step: the accuracies within 1e-4 (the same counts).  Why steps 2
# and 3 are held more loosely: step 1 moves every entry whose gradient is
# rounding noise (decoder/W_assm/bias, whose exact gradient is zero;
# attachment logits of probability 1 less 6e-8) by up to the learning
# rate, in a direction each package draws from its own rounding, and the
# later gradients see it.  Between the port and the JAX package, both on
# the CPU, step 2's GNorm differs by 8.6e-4; step 3's updates along the
# gradient differ by up to 17 % for leaves whose gradient is below 2.4e-3
# of the GNorm (decoder/W_node 17 % and 4.7 %, decoder/topoNN 2.3 % and
# 1.7 %), and by at most 3.9e-4 for the held leaves; every Loss and KL
# agrees within 2.6e-5.
FIRST_RTOL = 1e-5
RTOL = 1e-4
LATER_GNORM_RTOL = 5e-3
ACC_ATOL = 1e-4
UPDATE_RTOL = 1e-3
STRONG = 1e-2
NOISE = 1e-6
ACCURACIES = ('Word', 'I-Word', 'Topo', 'Assm')
# The fine-tuning golden (goldens/train_propopt_hopv.json) is held by the
# same rule, with its per-group gradient norms held as GNorm is, its
# property losses (about 2e-4) within PROPERTY_ATOL absolute, and the
# updates of steps 2 and 3 within FINETUNE_LATER_UPDATE_RTOL.  Between the
# port and the JAX package, both on the CPU: the property losses differ by
# at most 1.5e-8; the group norms by at most 8.9e-4 relative (step 2's
# decoder); the held updates of step 3 by up to 1.6e-3 (vae/R_mean/bias,
# which the property losses' gradients reach through the latent), those
# of steps 1 and 2 by at most 2.9e-4.  Fixed before any card run.
PROPERTY_KEYS = ('HOMO_MSE', 'LUMO_MSE')
PROPERTY_ATOL = 2e-7
FINETUNE_LATER_UPDATE_RTOL = 5e-3
# The hier goldens (goldens/train_hier_hopv.json, train_hier_propopt_hopv
# .json) are held by the same rule but for the assembly accuracy, held
# within HIER_ASSM_ATOL: 3 of a step's 100 to 160 assembly events.  Where
# a molecule is symmetric, candidates on symmetric atoms score exactly the
# gold's score in the port (3 of the 154 events of step 1 on the CPU), and
# XLA's reductions break such a tie by an ulp either way: the JAX package
# counts one of the three wrong (Assm 0.99351 against the port's 1.0).
# Between the port and the JAX package, both on the CPU, the hier-prop
# steps meet the rest of the rule: Loss within 1.0e-5, GNorm within
# 4.1e-5, the held updates within 1.3e-4.  The hier-prop-opt golden's
# property losses are held within RTOL relative, not PROPERTY_ATOL: its
# heads are untrained (HEADS_SEED), so the losses are about 0.15, not 2e-4,
# and on the CPU they differ by up to 3.3e-7 (2.2e-6 relative, step 3's
# HOMO); the rest as the prop-opt golden (group norms within 1.9e-5, held
# updates within 7.3e-5).  Fixed before any card run.
HIER_ASSM_ATOL = 0.02


def hier_rule(finetune: bool = False) -> dict:
    """``check_golden``'s arguments for a hier golden (above)."""
    return dict(later_update_rtol=FINETUNE_LATER_UPDATE_RTOL if finetune
                else UPDATE_RTOL, assm_atol=HIER_ASSM_ATOL,
                property_rtol=RTOL)


# the kernels of a training step: wrapper, what it counts
KERNELS = {'nei_sum': nei_sum, 'transpose_sum': transpose_sum,
           'gather_rows': gather_rows}


def hopv_rows(vocab: PairVocab) -> List[list]:
    """The in-vocab rows of ``data/hopv15.csv`` (all 350)."""
    return prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)


def hopv_batches(n: Optional[int] = None, vocab: Optional[PairVocab] = None
                 ) -> Tuple[PairVocab, List[MolGraphBatch]]:
    """The vocab and the first ``n`` (default all) full HOPV batches of 20,
    each padded to its bucket shapes (``pad_batch``)."""
    vocab = vocab or load_vocab_file(VOCAB)
    rows = hopv_rows(vocab)
    n_full = len(rows) // BATCH_SIZE
    n = n_full if n is None else min(n, n_full)
    return vocab, [pad_batch(tensorize(rows[i * BATCH_SIZE:(i + 1) * BATCH_SIZE],
                                       vocab, common_atom_vocab))
                   for i in range(n)]


def canonical_trainer(device: str, vocab: Optional[PairVocab] = None,
                      mesh=None) -> Tuple[Trainer, PairVocab]:
    """A ``Trainer`` of the canonical configuration on ``device``, from the
    checkpoint's ``vae/`` weights, without latent noise; with ``mesh`` one
    rank of a data-parallel (or dp×tp) run on it."""
    model, vocab = load_prop_model(CKPT, VOCAB, device=device)
    trainer = Trainer(model, make_optimizer(**OPTIMIZER), vocab.mask,
                      beta=BETA, print_iter=10 ** 9, perturb_z=False,
                      device=device, mesh=mesh)
    return trainer, vocab


def finetune_trainer(device: str, compute_dtype: str = 'float32'
                     ) -> Tuple[Trainer, PairVocab]:
    """A ``Trainer`` of the prop-opt fine-tuning step on ``device``: the
    full trained checkpoint (``vae/`` and ``property_optim/``), β 0.1, no
    latent noise, ``make_multi_optimizer`` over ``default_group_fn``'s
    groups at ``FINETUNE_LRS`` with ``OPTIMIZER``'s clip and decay; the
    encoder in ``compute_dtype``."""
    model, vocab = load_model(CKPT, VOCAB, device=device,
                              compute_dtype=compute_dtype)
    opt = make_multi_optimizer(default_group_fn, FINETUNE_LRS, **{
        k: v for k, v in OPTIMIZER.items() if k != 'lr'})
    trainer = Trainer(model, opt, vocab.mask, beta=BETA,
                      print_iter=10 ** 9, perturb_z=False, device=device)
    return trainer, vocab


# the hier family's steps (chip_smoke.py's hier train phase): the trained
# hier-prop checkpoint at its configuration (scripts/quality_run.py:135-140),
# OPTIMIZER and BETA as above; hier-prop-opt takes the checkpoint's weights
# under hier/ and property heads initialised from a generator seeded with
# HEADS_SEED (no trained hier-prop-opt checkpoint exists), with one Adam a
# group at FINETUNE_LRS
HEADS_SEED = 0


def hier_model(finetune: bool = False, vocab: Optional[PairVocab] = None):
    """The ``hier-prop`` model of the trained hier checkpoint or, with
    ``finetune``, ``hier-prop-opt`` with that model under ``hier/`` and
    property heads from ``init_params`` seeded with ``HEADS_SEED``; on the
    CPU, with its vocab."""
    vocab = vocab or load_vocab_file(HIER_VOCAB)
    hv, iv = vocab.size()
    cfg = ModelConfig(hvocab_size=hv, ivocab_size=iv, **HIER_TRAINED)
    tree = read_checkpoint(HIER_CKPT)
    if not finetune:
        model = HierPropertyVAE(cfg)
        load_flax_params(model, tree)
        return model, vocab
    return with_heads(HierPropOptVAE(cfg),
                      {'hier': tree.get('params', tree)}), vocab


def hier_trainer(device: str, finetune: bool = False,
                 vocab: Optional[PairVocab] = None
                 ) -> Tuple[Trainer, PairVocab]:
    """A ``Trainer`` of the hier family on ``device`` (``hier_model``),
    without latent noise: ``hier-prop`` with ``OPTIMIZER``, or with
    ``finetune`` ``hier-prop-opt`` with ``make_multi_optimizer`` over
    ``default_group_fn``'s groups at ``FINETUNE_LRS``."""
    model, vocab = hier_model(finetune, vocab)
    if finetune:
        opt = make_multi_optimizer(default_group_fn, FINETUNE_LRS, **{
            k: v for k, v in OPTIMIZER.items() if k != 'lr'})
    else:
        opt = make_optimizer(**OPTIMIZER)
    trainer = Trainer(model, opt, vocab.mask, beta=BETA, print_iter=10 ** 9,
                      perturb_z=False, device=device)
    return trainer, vocab


# prop-opt-sched and the attention models (chip_smoke.py phase 13):
# ``sched_trainer`` is ``finetune_trainer`` with the model type swapped (the
# full checkpoint's tree in a ``PropOptSchedulingVAE``, which the JAX
# ``Trainer`` steps at tf_ratio 1); ``attention_trainer`` the trained
# prop-opt checkpoint (``finetune_trainer``'s settings) or the trained
# hier-prop one (``hier_trainer``'s) with ``use_attention``, its ``A_*``
# heads from ``init_params`` seeded with HEADS_SEED (no trained checkpoint
# has them).
#
# The rules.  goldens/train_propsched_hopv.json: its 3 steps by the
# prop-opt fine-tuning golden's rule (PROPERTY_ATOL,
# FINETUNE_LATER_UPDATE_RTOL); at tf_ratio 1 no coin is set, so the steps
# differ from prop-opt's only by the property losses' weight 20.
# goldens/train_propopt_att_hopv.json the same rule;
# goldens/train_hier_att_hopv.json by ``hier_rule()``.  The tf_ratio 0.5
# step (``sched_step`` on the first HOPV batch from the checkpoint, its
# coins JAX's ``uniform(split(PRNGKey(SCHED_SEED))[1], (T, L)) > 0.5``,
# stored in the golden): the motif predictions fed back (coin set, an
# expand step) equal the CPU port's, except where the CPU port's two
# largest logits lie within NEAR_TIE (printed with its margin); Loss,
# Recs_Loss and KL within FIRST_RTOL of the golden, the property losses
# within PROPERTY_ATOL, the accuracies within ACC_ATOL; each gradient
# leaf within SCHED_GRAD_RTOL of its largest entry (or of 1e-3 of the
# largest entry of any leaf) of the CPU port's with the same coins.  A
# flip at a near-tie changes every later embedding of its lane, so the
# decoder's losses and, through the latent, every gradient but the
# property heads'; the step is then held only where the scan does not
# reach: KL and the property losses (the step runs at the latent's mean)
# and the property heads' gradients (SCAN_FREE_*).  SCHED_GRAD_RTOL
# (3e-4) is set from the card's readings, above the CPU tests' 1e-4: a
# leaf whose entries are small and summed over the scan's steps in
# another order differs by about 1e-4 of its largest entry between the
# card and the CPU (run 1 of chip_smoke.py's phase 13 on an H100:
# decoder/W_root/kernel, entries at most 1.4e-3, 1.1e-4; every other
# leaf 9.2e-5 or less); every leaf's deviation is printed.
# Between the CPU port and the JAX package, both on the CPU: the sched
# steps' Loss within 1.1e-5, KL 2.2e-5, GNorm 5.8e-4 (step 2), group norms
# 8.8e-4 (step 2's decoder), property losses 1.6e-8 absolute, held updates
# 6.1e-5 / 2.7e-4 / 2.6e-3 (steps 1-3; step 3's lumo head bias, within
# FINETUNE_LATER_UPDATE_RTOL), accuracies equal; the tf_ratio 0.5 step's
# metrics within 6.9e-7 relative, its 131 fed-back predictions JAX's, the
# smallest CPU margin among them 4.0.  The prop-opt attention steps: Loss
# within 6.8e-7, GNorm 4.8e-6, group norms 2.3e-5, held updates 1.9e-4;
# the hier attention steps: Loss 2.2e-6, GNorm 2.6e-6, held updates
# 1.0e-4, Assm 0.0068 at step 2 (one tie, within HIER_ASSM_ATOL).  The
# attention goldens' gradients are taken before the clip, which binds at
# their first step (GNorm 181 and 194: the seeded heads are far from
# trained).
SCHED_TF = 0.5
SCHED_SEED = 0
NEAR_TIE = 1e-4
SCHED_GRAD_RTOL = 3e-4
SCAN_FREE_METRICS = ('KL',) + PROPERTY_KEYS
SCAN_FREE_LEAVES = 'params/property_optim/'


def _merge(base: dict, over: dict) -> dict:
    """``base`` with every leaf of ``over`` put in (nested dicts)."""
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base.get(k, {}), v) if isinstance(v, dict) else v
    return out


def with_heads(model, tree) -> torch.nn.Module:
    """``model`` with the weights of a checkpoint's ``tree`` and, for the
    leaves the tree lacks (attention or property heads), those of
    ``init_params`` seeded with ``HEADS_SEED``."""
    init_params(model, torch.Generator().manual_seed(HEADS_SEED))
    load_flax_params(model, {'params': _merge(
        to_flax_tree(model)['params'], tree.get('params', tree))})
    return model


def _finetune_optimizer():
    return make_multi_optimizer(default_group_fn, FINETUNE_LRS, **{
        k: v for k, v in OPTIMIZER.items() if k != 'lr'})


def sched_model(vocab: Optional[PairVocab] = None):
    """The full trained checkpoint's tree in a ``PropOptSchedulingVAE``,
    on the CPU, with its vocab."""
    vocab = vocab or load_vocab_file(VOCAB)
    hv, iv = vocab.size()
    model = PropOptSchedulingVAE(ModelConfig(hvocab_size=hv,
                                             ivocab_size=iv))
    load_flax_params(model, read_checkpoint(CKPT))
    return model, vocab


def sched_trainer(device: str, vocab: Optional[PairVocab] = None
                  ) -> Tuple[Trainer, PairVocab]:
    """``finetune_trainer`` with the model ``sched_model``."""
    model, vocab = sched_model(vocab)
    return Trainer(model, _finetune_optimizer(), vocab.mask, beta=BETA,
                   print_iter=10 ** 9, perturb_z=False,
                   device=device), vocab


def attention_model(hier: bool = False, vocab: Optional[PairVocab] = None):
    """The trained prop-opt model (or, with ``hier``, hier-prop model)
    built with ``use_attention``, its heads seeded (``with_heads``, once a
    process); on the CPU, with its vocab."""
    vocab = vocab or load_vocab_file(HIER_VOCAB if hier else VOCAB)
    model = _attention_shell(hier, vocab)
    load_flax_params(model, _attention_tree(hier))
    return model, vocab


def _attention_shell(hier: bool, vocab: PairVocab):
    hv, iv = vocab.size()
    cls = HierPropertyVAE if hier else PropOptVAE
    return cls(ModelConfig(hvocab_size=hv, ivocab_size=iv,
                           use_attention=True,
                           **(HIER_TRAINED if hier else {})))


@functools.lru_cache(maxsize=2)
def _attention_tree(hier: bool) -> dict:
    """``attention_model``'s weights, read-only (its trainers in phase 13
    build three models a family from them)."""
    model = _attention_shell(hier, load_vocab_file(HIER_VOCAB if hier
                                                   else VOCAB))
    return to_flax_tree(with_heads(model, read_checkpoint(
        HIER_CKPT if hier else CKPT)))


def attention_trainer(device: str, hier: bool = False,
                      vocab: Optional[PairVocab] = None
                      ) -> Tuple[Trainer, PairVocab]:
    """A ``Trainer`` of ``attention_model`` on ``device`` without latent
    noise: prop-opt with ``finetune_trainer``'s optimizer, hier-prop with
    ``OPTIMIZER``."""
    model, vocab = attention_model(hier, vocab)
    opt = make_optimizer(**OPTIMIZER) if hier else _finetune_optimizer()
    return Trainer(model, opt, vocab.mask, beta=BETA, print_iter=10 ** 9,
                   perturb_z=False, device=device), vocab


# ROADMAP A5's options (chip_smoke.py phase 14).  No GRU or untied
# checkpoint is trained, so those models start from ``init_params`` seeded
# with A5_SEED at the full width (the canonical configuration, or the
# trained hier model's, HIER_TRAINED), and the goldens hold the JAX
# package's steps from the same params (bridged with ``to_flax_tree``):
#
# - goldens/train_gru_hopv.json (tests/test_torch_gru.py rewrites it):
#   ``prop`` with ``rnn_type`` GRU, tied, f32, seeded (``gru_trainer``:
#   OPTIMIZER, BETA, the latent's mean), its first 3 steps on the first
#   three HOPV batches of 20, held by the prop rule above (``check_golden``
#   with its defaults).
# - goldens/train_propopt_bf16_hopv.json (tests/test_torch_bf16.py): the
#   trained prop-opt checkpoint with ``compute_dtype`` bf16, LSTM
#   (``finetune_trainer(..., 'bf16')``), held by the prop-opt fine-tuning
#   rule widened by the bf16 rule to the size of JAX's own bf16 error
#   (``check_golden(..., f32=...)``): each quantity the rule holds may also
#   lie as far from JAX's bf16 value as JAX's bf16 lies from JAX's f32
#   (the golden's ``f32_steps``), or as far relative as the step's largest
#   such distance among its losses and gradient norms (``bf16_error``: a
#   single norm can land near its f32 value by chance; at step 1 JAX's
#   encoder group norm lies 9.8e-5 from its f32 one, the LUMO head's
#   2.4e-3); or it may lie no farther from JAX's f32 value than JAX's bf16
#   value does (its own bf16 error no larger than JAX's).
# - goldens/train_hier_gru_bf16_hopv.json (tests/test_torch_bf16_hier.py):
#   ``hier-prop`` with GRU, untied embeddings and bf16, seeded
#   (``hier_a5_trainer``: OPTIMIZER), held by ``hier_rule()`` widened the
#   same way, its leaves' updates at step 1 only (``HIER_A5_RULE``).  Its
#   untrained model's gradients are clipped (GNorm 84 to 214 against the
#   clip's 20), so JAX's bf16 and f32 trajectories part after step 1: at
#   step 3 their GNorm differ by 26 %, KL by 15 %, and the held leaves'
#   updates by up to 21 % at step 2 and 22 % at step 3 (median 2.3 % and
#   7.2 %; at step 1 3.5 %, median 0.044 %).  A third bf16 computation
#   lands elsewhere again: on an H100 (NVIDIA H100 80GB HBM3, 700.00 W,
#   chip_smoke.py phase 14) step 3's update of encoder/W_root/kernel lay 71 %
#   from JAX's bf16 and 33 % from JAX's f32, the steps' losses, KL, GNorm
#   and accuracies within the rule.  So the later steps' updates are
#   printed, not held; the metrics of all three steps are.
#
# JAX's bf16 references run with XLA's excess precision off
# (tests/torch_a5.py: with it on, XLA:CPU keeps some bf16 intermediates of
# a gradient program in f32, so its forward differs from the model's own
# forward).  Between the port and the JAX package, both on the CPU (the
# ``-m slow`` tests of tests/test_torch_{gru,bf16,bf16_hier}.py), fixed
# before any card run: the GRU steps' Loss within 2.3e-7, KL 7.9e-7, GNorm
# 8.8e-8, held updates 1.4e-7 / 3.6e-5 / 1.0e-5 (steps 1-3), accuracies
# equal.  The bf16 prop-opt steps' Loss within 1.0e-6 / 7.5e-6 / 7.6e-6
# (JAX's bf16 from its f32: 2.5e-5 / 2.0e-5 / 4.5e-5), GNorm 1.5e-4 /
# 2.7e-3 / 5.6e-4 (JAX: 2.6e-4 / 7.0e-3 / 1.1e-3), group norms up to
# 4.4e-4 / 3.2e-3 / 2.7e-3 (step 1's encoder: JAX's bf16 lies 9.8e-5 from
# its f32, the step's bf16 error 2.4e-3), held updates 6.6e-4 / 2.4e-3 /
# 2.7e-3, accuracies equal.  The hier steps' Loss within 8.7e-6 / 1.3e-4 /
# 6.5e-3 (JAX: 2.2e-6 / 2.4e-3 / 1.4e-2), KL 2.4e-4 / 1.4e-3 / 0.12 (JAX:
# 2.7e-4 / 1.9e-2 / 0.13), GNorm 5.9e-3 / 0.10 / 0.12 (JAX: 1.7e-2 /
# 8.4e-2 / 0.21; step 2's port lies 1.5e-2 from JAX's f32), held updates
# up to 1.8e-2 at step 1, accuracies up to 0.040 (step 3's Assm).
A5_SEED = 5
HIER_A5_RULE = dict(hier_rule(), update_steps=1)
# goldens/decode_gru_hopv16.json's step cap: the seeded models are
# untrained and grow every molecule to the cap (40-character repeats and
# more within 20 steps), so the cap sets the molecules' size
A5_DECODE_STEP = 40
GRU_CONFIG = dict(rnn_type='GRU')
HIER_A5_CONFIG = dict(HIER_TRAINED, rnn_type='GRU', tie_embedding=False,
                      compute_dtype='bf16')


def gru_model(vocab: Optional[PairVocab] = None):
    """The canonical ``prop`` model with the GRU cell from ``init_params``
    seeded with ``A5_SEED``, on the CPU, with its vocab."""
    vocab = vocab or load_vocab_file(VOCAB)
    hv, iv = vocab.size()
    model = PropertyVAE(ModelConfig(hvocab_size=hv, ivocab_size=iv,
                                    **GRU_CONFIG))
    return init_params(model, torch.Generator().manual_seed(A5_SEED)), vocab


def gru_trainer(device: str, vocab: Optional[PairVocab] = None
                ) -> Tuple[Trainer, PairVocab]:
    """A ``Trainer`` of ``gru_model`` on ``device`` with ``OPTIMIZER``,
    without latent noise."""
    model, vocab = gru_model(vocab)
    return Trainer(model, make_optimizer(**OPTIMIZER), vocab.mask, beta=BETA,
                   print_iter=10 ** 9, perturb_z=False,
                   device=device), vocab


def hier_a5_model(vocab: Optional[PairVocab] = None):
    """``hier-prop`` at ``HIER_A5_CONFIG`` (GRU, untied, bf16) from
    ``init_params`` seeded with ``A5_SEED``, on the CPU, with its vocab."""
    vocab = vocab or load_vocab_file(HIER_VOCAB)
    hv, iv = vocab.size()
    model = HierPropertyVAE(ModelConfig(hvocab_size=hv, ivocab_size=iv,
                                        **HIER_A5_CONFIG))
    return init_params(model, torch.Generator().manual_seed(A5_SEED)), vocab


def hier_a5_trainer(device: str, vocab: Optional[PairVocab] = None
                    ) -> Tuple[Trainer, PairVocab]:
    """A ``Trainer`` of ``hier_a5_model`` on ``device`` with
    ``OPTIMIZER``, without latent noise."""
    model, vocab = hier_a5_model(vocab)
    return Trainer(model, make_optimizer(**OPTIMIZER), vocab.mask, beta=BETA,
                   print_iter=10 ** 9, perturb_z=False,
                   device=device), vocab


def gru_serve_models(vocab: Optional[PairVocab] = None,
                     hvocab: Optional[PairVocab] = None):
    """The two models that phase 14 serves (goldens/decode_gru_hopv16.json,
    tests/test_torch_untied.py rewrites it): ``prop-opt`` and
    ``hier-prop`` with GRU and untied embeddings, f32, at the full width
    (the hier one at ``HIER_TRAINED``), from ``init_params`` seeded with
    ``A5_SEED``; on the CPU, with their vocabs."""
    vocab = vocab or load_vocab_file(VOCAB)
    hvocab = hvocab or load_vocab_file(HIER_VOCAB)
    out = []
    for cls, v, extra in ((PropOptVAE, vocab, {}),
                          (HierPropertyVAE, hvocab, HIER_TRAINED)):
        hv, iv = v.size()
        model = cls(ModelConfig(hvocab_size=hv, ivocab_size=iv,
                                rnn_type='GRU', tie_embedding=False,
                                **extra))
        out.append((init_params(model, torch.Generator().manual_seed(
            A5_SEED)), v))
    return out


def sched_coins(golden: dict, device) -> torch.Tensor:
    """The tf_ratio 0.5 step's coins [T, L] of the sched golden."""
    return torch.tensor([[c == '1' for c in row]
                         for row in golden['sched_step']['coins']],
                        device=device)


def sched_step(model, batch: dict, coins: torch.Tensor) -> dict:
    """One forward and backward of a ``PropOptSchedulingVAE`` (its
    training mode) on a device batch at ``SCHED_TF`` with ``coins``, at
    the latent's mean and β ``BETA``: its metrics, the gradient of every
    leaf (flax paths) and the decoder's record of the scan
    (``MotifDecoder.sched_hook``: ``pred``, ``margin``, ``use``)."""
    record = {}
    dec = model.vae.decoder
    dec.sched_hook = record.update
    model.train()
    try:
        for p in model.parameters():
            p.grad = None
        total, metrics, _ = model(batch, BETA, perturb_z=False,
                                  tf_ratio=SCHED_TF, coins=coins)
        total.backward()
    finally:
        dec.sched_hook = None
    return dict(metrics={k: float(v) for k, v in sorted(metrics.items())},
                grads=flatten(to_flax_tree(model, lambda p: p.grad)),
                **{k: record[k].cpu() for k in ('pred', 'margin', 'use')})


def check_sched_step(got: dict, cpu: dict, golden: dict) -> Tuple[List[str],
                                                                 List[str]]:
    """The tf_ratio 0.5 step's rule (above): ``got`` (``sched_step`` on
    the card) against ``cpu`` (the CPU port's, the same coins) and the
    golden; after a flip at a near-tie, only what the scan does not reach
    (``SCAN_FREE_*``).  Returns (failures, the fed-back predictions that
    differ at a near-tie, each with its CPU margin)."""
    use = cpu['use']
    differ = (got['pred'] != cpu['pred']) & use
    ties = [f'step {t} lane {l}: {int(got["pred"][t, l])} vs '
            f'{int(cpu["pred"][t, l])}, CPU margin '
            f'{float(cpu["margin"][t, l])}'
            for t, l in differ.nonzero().tolist()]
    bad = [f'fed-back prediction beyond a near-tie: {x}'
           for x, (t, l) in zip(ties, differ.nonzero().tolist())
           if not float(cpu['margin'][t, l]) < NEAR_TIE]
    want = golden['sched_step']['metrics']
    for k, w in want.items():
        if ties and k not in SCAN_FREE_METRICS:
            continue
        g = got['metrics'].get(k, float('nan'))
        tol = (ACC_ATOL if k in ACCURACIES else PROPERTY_ATOL
               if k in PROPERTY_KEYS else FIRST_RTOL * abs(w))
        if not abs(g - w) <= tol:
            bad.append(f'{k}: {g} vs {w}')
    for k, dev in grad_deviation(got, cpu).items():
        if ties and not k.startswith(SCAN_FREE_LEAVES):
            continue
        if not dev <= SCHED_GRAD_RTOL:
            bad.append(f'gradient of {k}: max error {dev} of its scale')
    return bad, ties


def grad_deviation(got: dict, cpu: dict) -> Dict[str, float]:
    """Per leaf, the largest deviation of ``got``'s gradient from
    ``cpu``'s over the leaf's largest entry in ``cpu`` (or 1e-3 of the
    largest entry of any leaf, where that is larger)."""
    top = max(float(np.abs(v).max()) for v in cpu['grads'].values())
    return {k: float(np.abs(got['grads'][k] - v).max()) /
            max(float(np.abs(v).max()), 1e-3 * top)
            for k, v in sorted(cpu['grads'].items())}


def update_norms(before: Dict[str, np.ndarray], after: Dict[str, np.ndarray],
                 grads: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Per leaf, the component of a step's update along the leaf's
    gradient, ``-⟨g, Δ⟩ / ‖g‖``; None for a leaf whose gradient is
    rounding noise (norm below ``NOISE`` of the whole gradient's).  Not the
    update's norm: Adam moves every entry whose gradient is noise by up to
    the learning rate, in a direction each package draws from its own
    rounding, and that makes norms differ by up to 1 % between the JAX
    package and the port on the CPU; the component along the gradient
    weighs such entries by their gradient, so it does not see them, and it
    sees any error of step size or sign in the others."""
    norms = {k: float(np.linalg.norm(g.astype(np.float64)))
             for k, g in grads.items()}
    total = float(np.sqrt(sum(n * n for n in norms.values())))
    return {k: None if norms[k] < NOISE * total else float(
        -np.vdot(grads[k].astype(np.float64),
                 after[k].astype(np.float64) - before[k]) / norms[k])
        for k in after}


def golden_steps(device: str, trainer: Optional[Trainer] = None,
                 batches: Optional[List[MolGraphBatch]] = None,
                 finetune: bool = False, hier: bool = False) -> List[dict]:
    """The port's first ``GOLDEN_STEPS`` steps as ``goldens/train_hopv.json``
    (``goldens/train_propopt_hopv.json`` with ``finetune``;
    ``goldens/train_hier_hopv.json`` and
    ``goldens/train_hier_propopt_hopv.json`` with ``hier``) records the
    JAX package's: per-step metrics, per-leaf update norms (flax paths,
    ``update_norms``) and, under a per-group optimizer, each group's
    gradient norm.  Without ``trainer``, the canonical, fine-tuning or
    hier trainer on the first HOPV batches."""
    if trainer is None:
        if hier:
            trainer, vocab = hier_trainer(device, finetune)
        else:
            trainer, vocab = (finetune_trainer if finetune
                              else canonical_trainer)(device)
        _, batches = hopv_batches(GOLDEN_STEPS, vocab)
    steps = []
    for mb in batches[:GOLDEN_STEPS]:
        before = flatten(to_flax_tree(trainer.model))
        metrics, _ = trainer.train_step(trainer.device_batch(
            trainer.host_batch(mb)))
        after = flatten(to_flax_tree(trainer.model))
        steps.append(dict({k: float(v) for k, v in sorted(metrics.items())},
                          update_norms=update_norms(before, after, flatten(
                              to_flax_tree(trainer.model, lambda p: p.grad)))))
        groups = getattr(trainer.opt_state, 'group_norms', None)
        if groups:
            steps[-1]['group_norms'] = {g: float(v)
                                        for g, v in groups.items()}
    return steps


def check_golden(steps: List[dict], golden: dict,
                 later_update_rtol: float = UPDATE_RTOL,
                 assm_atol: float = ACC_ATOL,
                 property_rtol: Optional[float] = None,
                 f32: Optional[List[dict]] = None,
                 update_steps: Optional[int] = None) -> List[str]:
    """Where ``steps`` break the rule above against ``golden`` (the
    updates after step 1 held within ``later_update_rtol``, the assembly
    accuracy within ``assm_atol``, the property losses within
    ``property_rtol`` relative where it is given); empty if they meet
    it.  With ``f32`` (a bf16 golden's ``f32_steps``, JAX's f32 steps from
    the same params) each quantity is held by the bf16 rule, to the size
    of JAX's own bf16 error: it meets the rule if it lies within
    ``max(tol, |w − w32|, bf16_error · |w|)`` of JAX's bf16 value ``w``
    (``w32`` JAX's f32 value, ``bf16_error`` the step's), or no farther
    from ``w32`` than ``w`` is, plus ``tol``.  With ``update_steps`` the
    leaves' updates are held at the first ``update_steps`` steps only (the
    later ones printed by ``update_deviation``)."""
    bad = []
    if len(steps) != len(golden['steps']):
        return [f'{len(steps)} steps, the golden has {len(golden["steps"])}']

    def meets(g, w, tol, i, key, leaf=None):
        if abs(g - w) <= tol:
            return True
        if f32 is None or w is None:
            return False
        ref = f32[i]
        if leaf is not None:
            w32 = ref['update_norms'].get(leaf)
        elif key.startswith('group '):
            w32 = ref.get('group_norms', {}).get(key.split()[1])
        else:
            w32 = ref.get(key)
        err = bf16_error(golden['steps'][i], ref) * abs(w)
        if w32 is None:
            return abs(g - w) <= max(tol, err)
        return (abs(g - w) <= max(tol, abs(w - w32), err) or
                abs(g - w32) <= abs(w - w32) + tol)

    for i, (got, want) in enumerate(zip(steps, golden['steps'])):
        gnorm_tol = RTOL if i == 0 else LATER_GNORM_RTOL
        # every golden holds these; only a prop-opt golden the properties
        # and the per-group norms
        pairs = [(key, got.get(key, float('nan')), want[key])
                 for key in ('Loss', 'KL', 'GNorm', *ACCURACIES)]
        pairs += [(key, got.get(key, float('nan')), want[key])
                  for key in PROPERTY_KEYS if key in want]
        pairs += [(f'group {g} norm', got.get('group_norms', {}).get(
            g, float('nan')), w) for g, w in want.get('group_norms', {}).items()]
        for key, g, w in pairs:
            if key == 'Assm':
                tol = assm_atol
            elif key in ACCURACIES:
                tol = ACC_ATOL
            elif key in PROPERTY_KEYS:
                tol = PROPERTY_ATOL if property_rtol is None else \
                    property_rtol * abs(w)
            elif key == 'GNorm' or key.startswith('group '):
                tol = gnorm_tol * abs(w)
            else:
                tol = (FIRST_RTOL if i == 0 else RTOL) * abs(w)
            if not meets(g, w, tol, i, key):
                bad.append(f'step {i + 1} {key}: {g} vs {w}')
        held = held_leaves(i, want)
        if update_steps is not None and i >= update_steps:
            held = []
        for leaf, w in want['update_norms'].items():
            g = got['update_norms'].get(leaf, 'missing')
            if i == 0 and (g is None) != (w is None):
                bad.append(f'step {i + 1} update of {leaf}: {g} vs {w}')
            elif leaf in held and not (g is not None and meets(
                    g, w, (UPDATE_RTOL if i == 0 else later_update_rtol)
                    * abs(w), i, None, leaf)):
                bad.append(f'step {i + 1} update of {leaf}: {g} vs {w}')
    return bad


def bf16_error(step: dict, f32: dict) -> float:
    """The size of JAX's bf16 error at a step of a bf16 golden: the
    largest relative distance between its bf16 and its f32 value among
    the step's losses and gradient norms (Loss, KL, GNorm, the property
    losses and each group's norm).  One aggregate may land near its f32
    value by chance; their largest distance is the error's size."""
    pairs = [(step[k], f32[k]) for k in ('Loss', 'KL', 'GNorm',
                                         *PROPERTY_KEYS) if k in step]
    pairs += [(v, f32['group_norms'][g])
              for g, v in step.get('group_norms', {}).items()]
    return max(abs(a - b) / abs(b) for a, b in pairs if b)


def held_leaves(i: int, want: dict) -> List[str]:
    """The leaves whose update the rule holds at step ``i + 1`` of the
    golden record ``want``: every one at step 1, the strong ones later."""
    return [k for k, w in want['update_norms'].items() if w is not None and (
        i == 0 or want['grad_norms'][k] >= STRONG * want['GNorm'])]


def update_deviation(steps: List[dict], golden: dict) -> List[dict]:
    """Per step, the largest relative deviation of a leaf's update along
    its gradient from the golden's, over the held leaves and over all, and
    the leaves beyond ``UPDATE_RTOL`` (printed)."""
    out = []
    for i, (got, want) in enumerate(zip(steps, golden['steps'])):
        dev = {k: abs(got['update_norms'][k] - w) / abs(w)
               for k, w in want['update_norms'].items() if w}
        held = held_leaves(i, want)
        out.append(dict(held=max((dev[k] for k in held), default=0.0),
                        n_held=len(held),
                        all=max(dev.values(), default=0.0),
                        beyond={k: v for k, v in dev.items()
                                if v > UPDATE_RTOL}))
    return out


def _counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


@contextlib.contextmanager
def recorded_epochs():
    """Records what every ``Trainer.train_epoch`` run inside the context
    does, for a caller that drives a CLI: ``trainers`` (each trainer whose
    epoch ran), ``batches`` (the batches as they arrived), ``steps`` (each
    step's metrics as device values, in the order the steps ran) and
    ``seconds`` (each epoch's wall time, to the device's end on a CUDA
    device).  It wraps ``Trainer.train_epoch`` and
    ``MetricAccumulator.add``, which every flush of an epoch calls once,
    and restores them on exit."""
    rec = dict(trainers=[], batches=[], steps=[], seconds=[])
    train_epoch, add = Trainer.train_epoch, MetricAccumulator.add

    def recorded_epoch(trainer, data, *args, **kwargs):
        if trainer not in rec['trainers']:
            rec['trainers'].append(trainer)

        def arrivals():
            for mb in data:
                rec['batches'].append(mb)
                yield mb
        t0 = time.perf_counter()
        stop = train_epoch(trainer, arrivals(), *args, **kwargs)
        if trainer.device.type == 'cuda':
            torch.cuda.synchronize(trainer.device)
        rec['seconds'].append(time.perf_counter() - t0)
        return stop

    def recorded_add(acc, metrics):
        flat = {k: v.reshape(-1) for k, v in metrics.items()}
        n = len(next(iter(flat.values())))
        rec['steps'] += [{k: v[i] for k, v in flat.items()} for i in range(n)]
        add(acc, metrics)

    Trainer.train_epoch, MetricAccumulator.add = recorded_epoch, recorded_add
    try:
        yield rec
    finally:
        Trainer.train_epoch, MetricAccumulator.add = train_epoch, add


def flush_groups(trainer: Trainer, batches: List[MolGraphBatch]
                 ) -> List[List[dict]]:
    """``batches`` on the device, grouped in the flushes the JAX
    ``Trainer`` steps through them by (``flushes``)."""
    hosts = [trainer.host_batch(mb) for mb in batches]
    pairs = [(signature(h), trainer.device_batch(h)) for h in hosts]
    return [[dev for _, dev in group]
            for group in flushes(pairs, lambda x: x[0])]


def run_epoch(trainer: Trainer, groups: List[List[dict]], graph: bool,
              rows: Optional[list] = None) -> List[float]:
    """One epoch over device batches in flush ``groups`` through
    ``scan_steps``, every flush through CUDA graphs with ``graph`` (a
    flush of one too, as ``Trainer.train_epoch`` runs it on the card),
    else eagerly.  Returns each step's host seconds (a flush's divided
    among its steps); with ``rows``, appends each step's metrics, breaker
    flag and group norms (device values)."""
    out = []
    for group in groups:
        t0 = time.perf_counter()
        metrics, aux = trainer.scan_steps(group, graph=graph)
        dt = time.perf_counter() - t0
        out += [dt / len(group)] * len(group)
        if rows is not None:
            rows += step_rows(metrics, aux)
    return out


def step_rows(metrics: Dict[str, torch.Tensor], aux: dict) -> List[dict]:
    """Each step's metrics, breaker flag and group norms (device values)
    of a ``scan_steps`` result."""
    return [dict({k: v[i] for k, v in metrics.items()},
                 **({'clipped': aux['clipped'][i]}
                    if isinstance(aux['clipped'], torch.Tensor) else {}),
                 **{f'group {g}': v[i]
                    for g, v in aux.get('group_norms', {}).items()})
            for i in range(len(next(iter(metrics.values()))))]


def replay_windows(trainer: Trainer, groups: List[List[dict]]
                   ) -> List[dict]:
    """Each step of ``groups`` (their graphs already captured) replayed
    in a profiler window of its own: the wrappers' launches
    (``launches``, and those on bf16 tables, ``launches_bf16``), the
    launches that ran by the kernels' own device counts (``ran``), the
    profiler's device records of each kernel (``device``, and by the
    kernel's full name, whose template names a bf16 sum's,
    ``device_by_name``), the window's device records (``records``), and
    the replay's wall ms under the profiler and device busy ms."""
    out = []
    for db in (db for g in groups for db in g):
        before = _counts()
        before_bf16 = {k: w.launches_bf16 for k, w in KERNELS.items()}
        wall, ran = [], {}

        def replay(db=db):
            t0 = time.perf_counter()
            trainer.scan_steps([db])
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
        busy_us, events = profiled(replay, ran=ran)
        out.append(dict(
            scan_steps=db['plan']['mess'].shape[0],
            wall_ms=wall[0], device_busy_ms=busy_us / 1e3,
            launches={k: float(v - before[k]) for k, v in _counts().items()},
            launches_bf16={k: float(w.launches_bf16 - before_bf16[k])
                           for k, w in KERNELS.items()},
            ran={k: float(v) for k, v in ran.items()},
            device={k: float(v) for k, v in by_kernel(events).items()},
            device_by_name={e.key: e.count for e in events
                            if kernel_of(e.key) in KERNELS},
            records=sum(e.count for e in events)))
    return out


def check_replay_windows(windows: List[dict], expected
                         ) -> Tuple[list, list]:
    """Where ``replay_windows`` break ``expected`` launches a replayed
    step (a dict, or a function of the window's ``scan_steps`` giving
    one), and the windows whose device records the profiler lost.  In
    every window the wrappers' counts (``launches``) and the launches that
    ran by the kernels' own device counts (``ran``) are held; the
    profiler's records of a kernel (``device``) may fall short of those
    that ran, which is the profiler's loss (``profiler_loss``), reported
    as ``(window, {kernel: records lost})``, but never exceed them."""
    want = expected if callable(expected) else lambda _: expected
    bad = [(i, key, w[key]) for i, w in enumerate(windows)
           for key in ('launches', 'ran')
           if w[key] != want(w.get('scan_steps'))]
    lost = []
    for i, w in enumerate(windows):
        loss = profiler_loss(w['device'], w['ran'])
        if any(v < 0 for v in loss.values()):
            bad.append((i, 'device', w['device']))
        elif loss:
            lost.append((i, loss))
    return bad, lost


def profile_epoch(trainer: Trainer, batches: List[MolGraphBatch],
                  graph: bool = False, full: bool = True) -> dict:
    """Train mols/s and where a step's time goes, on the card, after one
    untimed epoch over ``batches``, with the steps eager or, with
    ``graph``, every step replayed from the trainer's captured step graphs
    (``Trainer.scan_steps``).  Without ``full`` it runs only the epochs the
    step's own figures need: no untimed epoch for eager steps (the caller
    has warmed the card), no epoch through ``train_epoch`` with the host's
    batch preparation; for the hier step, whose eager epoch takes half a
    minute."""
    n_mols = BATCH_SIZE * len(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prep_s = []
    for mb in batches:
        t0 = time.perf_counter()
        trainer.device_batch(trainer.host_batch(mb))
        prep_s.append(time.perf_counter() - t0)
    # the JAX Trainer's order over the pre-uploaded batches
    groups = flush_groups(trainer, batches)
    n_steps = sum(len(g) for g in groups)

    def epoch_on_device():
        dispatch = run_epoch(trainer, groups, graph)
        torch.cuda.synchronize()
        return dispatch

    if full or graph:
        epoch_on_device()                              # untimed
    before = _counts()
    t0 = time.perf_counter()
    dispatch = epoch_on_device()
    wall = time.perf_counter() - t0
    per_kernel = {k: (v - before[k]) / n_steps
                  for k, v in _counts().items()}
    if full:
        t0 = time.perf_counter()
        trainer.train_epoch(batches, log=lambda *_: None, graph=graph)
        torch.cuda.synchronize()
        wall_prep = time.perf_counter() - t0
    walls = []

    def timed_epoch():
        t0 = time.perf_counter()
        epoch_on_device()
        walls.append(time.perf_counter() - t0)

    # busy time and the wall it is a share of, from the same window: the
    # profiled epoch (the profiler adds host time, not device time)
    busy_us, events = profiled(timed_epoch)
    copies = [e for e in events if e.key.startswith(('Memcpy', 'Memset'))]
    out = dict(
        graph=graph, steps=n_steps, mols_per_step=BATCH_SIZE,
        train_mols_per_s=n_mols / wall,
        epoch_wall_s=wall, step_wall_ms=1e3 * wall / n_steps,
        host_prep_ms_per_step=1e3 * float(np.median(prep_s)),
        host_dispatch_ms_per_step=1e3 * float(np.median(dispatch)),
        profiled_epoch_wall_s=walls[0],
        device_busy_ms_per_step=busy_us / 1e3 / n_steps,
        device_idle_share=1.0 - busy_us / 1e6 / walls[0],
        device_ops_per_step=sum(e.count for e in events) / n_steps,
        device_copies_per_step=sum(e.count for e in copies) / n_steps,
        kernel_launches_per_step=per_kernel,
        kernel_device_launches_per_step={
            name: n / n_steps for name, n in by_kernel(events).items()},
        kernel_device_us_per_step={
            name: sum(_device_us(e) for e in events
                      if kernel_of(e.key) == name) / n_steps
            for name in KERNELS},
        top_device_kernels=top_kernels(events, n_steps, n=12),
        max_memory_allocated=torch.cuda.max_memory_allocated())
    if full:
        out['train_mols_per_s_with_prep'] = n_mols / wall_prep
    if graph:
        out.update(trainer.graph_stats())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_train needs a CUDA device')
    from .kernel_bench import nvidia_smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer, vocab = canonical_trainer('cuda')
    _, batches = hopv_batches(vocab=vocab)
    out = dict(device=nvidia_smi(),
               eager=profile_epoch(trainer, batches),
               graph=profile_epoch(trainer, batches, graph=True))
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(text + '\n')
    return out


if __name__ == '__main__':
    main()
