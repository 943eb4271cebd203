#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printing one line with its seconds; any failure raises and the
script exits non-zero:

1. device  — a CUDA device must be present (else exit 1 with no result);
             prints ``nvidia-smi``'s name and power limit; TF32 off.
2. build   — compiles every kernel of ``ggpm_tpu_torch/csrc`` with nvcc
             into ``build/`` (one nvcc per source, started together).
3. load    — the trained HOPV prop-opt model and vocab through the bridge,
             and the first 120 in-vocab molecules of ``data/hopv15.csv``
             (the first 64 are the request).
4. kernel  — each kernel against its plain PyTorch version on the card, at
             the shapes the serve path gives it (the 64 molecules' tables),
             at that tree tiled 64 times (a 4,096-molecule request), over
             the neighbour widths A = 1..8 at the serve width, at the
             decoder's frontier readout for B = 64 and B = 120 (state
             [500·B, 250], frontier table [B, 12] seeded from the
             molecules' trees, ``kernel_bench.frontier_graph``), and at
             ragged and large cases (``kernel_bench.measure_cases``).
             ``ms``, ``plain_ms`` and ``library_ms`` are device times
             (calls captured in a CUDA graph, replayed between CUDA
             events); ``floor_ms`` is a one-element launch in the same
             harness; ``bound_ms`` counts the distinct rows the case
             reads; ``host_ms`` is the eager back-to-back time, which the
             host's dispatch sets at small shapes.  ``kinds`` forces each
             launch kind of the kernel on the same inputs, each checked
             and timed; ``plan`` is the launch the wrapper chose.  Then
             the depth loop's row gather (``gather_rows``) at the 64
             molecules' ``bgraph`` and width 750, held bit for bit to the
             plain copy and timed alike (``kernel_bench.gather_case``),
             and at every edge case of the card tests
             (``kernel_bench.GATHER_EDGES``: each path of the kernel,
             every base offset, one entry, several waves), each bit for
             bit the plain copy with one launch by the wrapper and by the
             kernel's own device count (``kernel gather_rows edges``).
5. serve   — ``GgpmServer`` on a free port answers ``/health``, ``/encode``
             and ``/properties`` for the 64 molecules; checks the latents,
             the kernel launch counts (each request: 2 ``nei_sum``, one
             ``gather_rows`` per depth round, no ``transpose_sum``), the
             HOMO/LUMO MAE against the JAX package's, and the latents
             against the port on the CPU.
6. decode  — the same server answers ``/reconstruct`` for the 64 molecules
             and ``/sample`` with ``{"n": 64, "seed": 0}``; both decode
             through the turbo path (``decode_motif_turbo``: the propose
             loop replayed from CUDA graphs, the host replaying its traces
             with the chemistry).  Each request runs under the profiler;
             the counts are reset just before and read just after (a
             graph's replay adds to them the launches its capture
             recorded).  Every answer is held to the JAX package's
             (``decode_best`` on the CPU, the same checkpoint, the JAX
             encoder's latents, max_decode_step 150;
             ``ggpm_tpu_torch/goldens/decode_hopv64.json``, which
             tests/test_torch_decode.py recomputes).  The rule, fixed before
             any card run: every string equals the reference's and the
             count of None is the same, except for fp32 near-ties.  For
             each string that differs, the batch is decoded again with
             per-step logs (the exact path) on the card and on the port's
             CPU path; the first step where ``Generate fragment`` falls on
             the other side of 0.5, or where the order of the top-5
             candidates differs, is printed with its margin in the CPU log
             (|p − 0.5| or the score gap).  The phase passes only if every
             such margin is below 1e-4 and at most 2 of the 128 strings
             differ.  ``gather_rows`` must have launched once per depth
             round of ``/reconstruct``'s encode.  In each request,
             ``nei_sum_kernel``'s device launches (the profiler's, which
             see the server thread's graph replays) and the wrapper's
             count must both equal 2 for the encode of ``/reconstruct``,
             plus the propose steps the turbo rounds ran (the lookahead's
             steps past the last active one count too;
             ``TURBO_STATS['steps_run']``), plus the steps run outside
             the rounds (one before each graph's capture, and the exact
             path's for samples that fell back;
             ``TURBO_STATS['eager_steps']``); it prints rounds,
             fallbacks, rungs and pending samples per round.  Last, outside HTTP, it
             decodes the first 64 and the first 120 molecules' latents
             through the turbo path and through the exact path and prints
             a ``decode B64``/``decode B120`` line for each
             (``profile_serve.profile_decode``: wall s, molecules/s, the
             host's split, device busy ms, idle share, launches, rounds).
7. train  — the canonical configuration (``prop``: LSTM, hidden = embed
             = 250, latent 24, depthT 20, batch 20, β 0.1, Adam lr 1e-3,
             clip 20) from the ``vae/`` weights of the same checkpoint,
             trained through the port's ``Trainer`` on the 17 full HOPV
             batches of 20 (``profile_train``); the counts are reset just
             before and read just after.  Its first 3 steps are held to the
             JAX package's (``ggpm_tpu_torch/goldens/train_hopv.json``,
             which tests/test_torch_train.py recomputes) by the rule in
             ``profile_train`` fixed before any card run.  Then two
             fresh trainers from the same weights each train two epochs
             in the JAX order, one eagerly and one through
             ``Trainer.scan_steps``'s CUDA graphs (one captured per batch
             signature, every flush replayed, a flush of one too):
             every step's metrics and the parameters, Adam moments and
             counts after must be equal bit for bit, and each replayed
             step must launch
             ``nei_sum`` / ``transpose_sum`` / ``gather_rows`` 3 / 22 / 20
             times by the wrappers' counts and by the profiler's device
             events (``train graph vs eager``: signatures captured, capture
             seconds, the graphs' pools, peak memory).  Then it times
             epochs eagerly and through graphs in turns (eager, graph:
             ``train eager|graph turn i`` and ``train
             turns``; train mols/s, host ms per step, device busy ms, the
             device's idle share, launches per step, from
             ``profile_train.profile_epoch``), each step launching 3 / 22
             / 20, and fails unless every kernel of the step launched.
             Last, each kernel of the step at the first batch's shapes
             against its plain version (max abs error at most 1e-5) and
             against its sum written out in the kernel's order (bit for
             bit), timed as in phase 4 (``kernel_bench.train_cases``).
8. optimize — the same server answers ``/optimize`` for the 64 molecules,
             the targets each molecule's own HOMO + 0.01 and LUMO − 0.01
             (Hartree): ``hard`` over HTTP (the body passes the policy
             only: the JAX defaults), ``soft`` and ``patience`` through
             ``GgpmServer.optimize`` with the settings of
             ``profile_serve.OPTIMIZE_SETTINGS`` (the profiled request of
             ``profile_serve.profile_optimize``).  Each answer is held to
             the JAX package's (``LatentOptimizer`` and ``decode_best`` on
             the CPU from the JAX encoder's latents;
             ``ggpm_tpu_torch/goldens/optimize_hopv64.json``, which
             tests/test_torch_latent.py recomputes) by a rule fixed before
             any card run: predicted HOMO/LUMO within 1e-4; the strings by
             phase 6's rule (at most 2 of the 64 differ, each at an fp32
             near-tie, its card and CPU logs decoded from each side's own
             search); the iterations and each row's stop reason (delta,
             patience) equal, except rows whose decision came within 1e-6
             of its threshold on the CPU (the golden lists them).  In each
             request ``nei_sum``'s launches (the wrapper's count and the
             profiler's device events) equal 2 for the encode plus the
             propose steps the turbo decode ran plus its eager steps (the
             search launches none), ``gather_rows`` one per depth round,
             ``transpose_sum`` none.  Each policy's request split
             (``profile_serve.profile_optimize``) is printed.
9. finetune — the prop-opt fine-tuning step from the full checkpoint
             (``vae/`` and ``property_optim/``; β 0.1, batch 20, clip 20,
             per-group Adam at encoder/decoder/homo/lumo lrs 1e-3, 1e-3,
             5e-4, 5e-4: ``profile_train.finetune_trainer``) through the
             port's ``Trainer``; the counts are reset just before and read
             just after.  Its first 3 steps are held to the JAX package's
             (``ggpm_tpu_torch/goldens/train_propopt_hopv.json``, which
             tests/test_torch_propopt.py recomputes) by ``profile_train``'s
             rule for it, fixed before any card run; then the graph check
             and the epochs in turns as phase 7 (the group norms and the
             breaker's flags held too; ``finetune vs train`` beside the
             prop step's), and fails unless every kernel of the step
             launched.
10. hier  — the hier family's serve path: the trained ``hier-prop``
             checkpoint (``runs/QUALITY_hier_hopv.json.ckpt``: LSTM,
             hidden = embed = 250, latent 24, depthT = depthG = 20,
             diterG 3) on the card and on the CPU, and the first 64
             molecules in its vocab.  First ``nei_sum`` at each of its call
             sites (the encoder's five readouts, the decode step's five
             frontier sums) and ``gather_rows`` at the atom and tree levels,
             on the inputs the path gives them
             (``kernel_bench.hier_cases``), against the plain version and
             the in-order sum, timed as in phase 4.  Then a second
             ``GgpmServer`` answers ``/encode`` of the 64, ``/reconstruct``
             of the 16 molecules of
             ``ggpm_tpu_torch/goldens/decode_hier_hopv16.json`` (the JAX
             package's answers, which tests/test_torch_hier.py recomputes)
             and ``/sample`` of its request (8 at seed 0), through
             ``HierMPNEncoder`` and the turbo ``decode_hier_turbo`` (its
             propose loop replayed from CUDA graphs; samples that fall back
             take the exact ``decode_hier``), each under the profiler with
             the counts read just before and after.  The latents must lie
             within 1e-4 of the CPU port's; the strings meet phase 6's rule
             (at most 2 differ a request, each at an fp32 near-tie,
             printed); each request's launches, by the wrappers and by the
             profiler's device events alike, are 5 ``nei_sum`` and depthG +
             2·depthT = 60 ``gather_rows`` an encode, 4 ``nei_sum`` a
             propose step run (eager before a graph's capture, or
             replayed) and 5 an exact step; and each call site's launches,
             the wrappers' launches counted at the site whose line made the
             call (``kernel_bench.hier_sites``), are its share of them, the
             graph replays' under ``replay``, equal to the device events
             that graph replays launched (their correlation ids are the
             ``cudaGraphLaunch`` calls'), with no launch outside a site.
             The kernels line's ``hier_sites`` carry these measured
             launches.  Last, the hier encode and exact-decode
             (``decode_hier`` called directly) profiles of the 64
             (``profile_serve.hier_profiles``), the exact decode's
             ``nei_sum`` launches 5 a step by the wrapper and the device
             events, none by a graph.
11. hier train — the hier family's training path: the trained
             ``hier-prop`` checkpoint (as phase 10) through the port's
             ``Trainer`` on the 17 full HOPV batches of 20 in its vocab
             (β 0.1, Adam lr 1e-3, clip 20; ``profile_train.hier_trainer``);
             the counts are reset just before and read just after.  Its
             first 3 steps are held to the JAX package's
             (``ggpm_tpu_torch/goldens/train_hier_hopv.json``), and the
             first 3 ``hier-prop-opt`` fine-tuning steps (the checkpoint
             under ``hier/``, seeded property heads, per-group Adam) to
             ``train_hier_propopt_hopv.json``, both recomputed by
             tests/test_torch_hier_train.py, by ``profile_train``'s rule for
             them (``hier_rule``), fixed before any card run.  Then the
             graph check of phase 7 (one epoch eager and one through
             ``Trainer.scan_steps``'s graphs, bit for bit; one epoch each,
             to keep the script well inside its time), each replayed step
             launching ``nei_sum`` 5 + 5·T, ``transpose_sum`` 59 +
             15·T and ``gather_rows`` 60 + 10·T times (T the scan's padded
             steps; ``hier_step_launches``), by the wrappers and the device
             events; one eager and one graph epoch profiled (``hier train
             eager|graph``: mols/s, host ms a step, device busy ms, idle
             share, launches a step, peak memory, the graphs' pools);
             and the kernels at the step's new call sites
             (``kernel_bench.hier_train_cases``: ``nei_sum`` at the
             encoder's five readouts and the scan's five per-step sums,
             ``transpose_sum`` at their transposes, the atom level's depth
             gather and the scan's atom-level message-update gather, each
             with its backward) against the plain version and the
             in-order sum, timed as in phase 4.  The kernels line's
             ``hier_train_sites`` carry them.
12. hier turbo — the hier family's turbo decode (``decode_hier_turbo``)
             on the trained ``hier-prop`` checkpoint, the counts reset just
             before each part and read just after.  First the 16 golden
             molecules' latents (the card's encoder) through one propose
             round on the card (replayed from its CUDA graph) and on the
             CPU port: the traces' integer columns equal and their floats
             within 1e-4, except at most 2 samples whose first difference
             is an fp32 near-tie of the CPU trace (the topology probability
             within 1e-4 of 0.5, or two beam scores within 1e-4), printed
             (``hier turbo traces``); then their ``decode_best`` on the card
             against the golden by phase 6's rule, its fallbacks equal to
             the CPU port's, and ``nei_sum``'s launches equal to 4 a
             propose step run (``steps_run``) and a capture's eager step,
             and 5 an exact step (``profile_serve.hier_turbo_launches``).
             Then ``decode_best`` of the 64 molecules' latents and of 120
             prior draws (``default_rng(0)``, the draws of
             ``goldens/hier_turbo_prior120.json``), first once under the
             profiler with each call site counted (``hier turbo decode
             B64|B120``): the propose sites' eager launches equal to the
             captures' eager steps, the exact step's sites' to the steps
             of the fallbacks' exact decode, the wrappers' ``replay``
             launches equal to the device events that graph replays
             launched and to 4 a replayed step, and the wrapper, the
             device events and the sites' sum equal to the count above;
             the 120's fallbacks (printed with their causes, poisoned or
             diverged) are the JAX package's and at most 2 of its strings
             differ from the JAX package's.  Then turbo and exact profiled
             (``profile_serve.profile_decode``'s ``hier-turbo`` and
             ``hier`` paths; ``hier turbo B64|B120``: wall s, rounds,
             rungs, fallbacks, a profiled propose round's device ms and
             launches a step, replay and chemistry s, idle share), the
             turbo's ``nei_sum`` launches equal to that count by the
             wrapper and by the profiler's device events (those of graph
             replays 4 a replayed step), the exact's 5 a step, and at most
             2 strings differing between turbo and exact.  Last
             ``nei_sum`` at the four propose sums
             (``kernel_bench.hier_turbo_cases``, at step 20 of a round at
             B = 64 and B = 120) against the plain version and the
             in-order sum, timed as in phase 4; the kernels line's
             ``hier_turbo_sites`` carry them with each site's eager
             launches in the counted decodes, and ``nei_sum``'s
             ``hier_turbo_replays`` the graph replays' launches there by
             the device events (and the exact step's sites' launches, and
             the records the profiler lost, ``profiler_lost``).
13. sched+att — the rest of property optimisation (the counts reset just
             before and read just after).  ``prop-opt-sched``
             (``profile_train.sched_trainer``: ``finetune_trainer``'s
             settings, the full checkpoint in a ``PropOptSchedulingVAE``,
             tf_ratio 1 as the ``Trainer`` steps it): its first 3 steps
             held to ``goldens/train_propsched_hopv.json`` (which
             tests/test_torch_sched.py recomputes) by the prop-opt
             fine-tuning rule; one tf_ratio 0.5 forward and backward on
             the first batch with the golden's coins on the card and on
             the CPU port (``profile_train.sched_step``), held by
             ``check_sched_step`` (the fed-back predictions the CPU
             port's but at a named fp32 near-tie, printed with its
             margin; the metrics the golden's; the gradients the CPU
             port's); one epoch eager and one through ``scan_steps``'
             graphs bit for bit, each replayed step launching ``nei_sum``
             / ``transpose_sum`` / ``gather_rows`` 3 / 22 / 20 times by
             the wrappers and the device events (``graph_vs_eager``); a
             graph epoch profiled (``sched graph``: the replayed step's
             wall and device ms beside prop-opt's); and ``nei_sum`` and
             its transpose at the scheduled readout
             (``kernel_bench.sched_cases``) against the plain version and
             the in-order sum, timed as in phase 4 (the kernels line's
             ``sched_sites``, whose launches are those made at the
             readout and in its backward during the steps above, counted
             at the call by ``kernel_bench.sched_site``, each eager
             launch of one with one of the other; a replay's are in the
             device events).  Then prop-opt and hier-prop with
             ``use_attention`` (``profile_train.attention_trainer``: the
             trained checkpoints, heads seeded with ``HEADS_SEED``): 3
             golden steps each (``goldens/train_propopt_att_hopv.json``
             by the prop-opt rule, ``train_hier_att_hopv.json`` by
             ``hier_rule``; tests/test_torch_attention.py recomputes
             them), their peak memory, and ``graph_vs_eager`` on the
             first two batches of one signature, each replay launching
             3 / 23 / 20 (the node readout's transpose, which the
             attention memory makes the loss read) or
             ``hier_step_launches`` by the wrappers and the device events
             (``att|hier att graph vs eager``, with each replay's wall
             and device ms).
             Last ``decode_motif`` with the attention memory of the 16
             molecules of ``goldens/decode_att_hopv16.json`` (the JAX
             package's strings) by phase 6's rule.
14. a5    — ROADMAP A5's options at full width (the counts reset just
             before and read just after; ``profile_train``'s phase-14
             models and rules).  ``prop`` with the GRU cell, tied, f32,
             from ``init_params`` seeded with ``A5_SEED``
             (``gru_trainer``): 3 steps held to
             ``goldens/train_gru_hopv.json`` by the prop rule
             (tests/test_torch_gru.py rewrites it); one epoch eager and
             one through ``scan_steps``' graphs bit for bit, each replayed
             step launching 3 / 22 / 20 (the GRU's depth gather of
             ``[h | h·U_r + b_r]`` is one ``gather_rows`` a round, as the
             LSTM's) and none on bf16 tables; a graph epoch profiled
             (``gru graph``); then the kernels at the step's new sites
             (``kernel_bench.a5_cases``: K3/K2 at the GRU's width 500 in
             f32, K3/K2 in bf16 at 750 and 500, K1 and its transpose in
             bf16 at the node readout) against the plain version and the
             in-order sum, bit for bit, timed as in phase 4 (the kernels
             line's ``a5_sites``).  ``prop-opt`` with ``compute_dtype``
             bf16 from the trained checkpoint (``finetune_trainer(...,
             'bf16')``): 3 steps held to
             ``goldens/train_propopt_bf16_hopv.json`` by the prop-opt
             rule widened by the bf16 rule (tests/test_torch_bf16.py);
             graph = eager, each replayed step launching 3 / 22 / 20 of
             which 1 / 20 / 20 on bf16 tables (``BF16_LAUNCHES``); a
             graph epoch profiled (``bf16 graph``).  ``hier-prop`` with
             GRU, untied embeddings and bf16 (``hier_a5_trainer``,
             seeded): 3 steps held to
             ``goldens/train_hier_gru_bf16_hopv.json`` by ``hier_rule()``
             widened by the bf16 rule, its leaves' updates at step 1 only
             (``HIER_A5_RULE``; tests/test_torch_bf16_hier.py), and
             graph = eager on the first two batches of one signature, each
             replay launching ``hier_step_launches`` of the GRU (3 / d + 2
             / d of them on bf16 tables, d = depthG + 2·depthT).  Last the
             ``prop-opt`` and ``hier-prop`` of
             ``goldens/decode_gru_hopv16.json`` (GRU and untied, seeded;
             tests/test_torch_untied.py rewrites it): ``/encode`` of its
             16 molecules within 1e-4 of the CPU port, and from the
             golden's latents the turbo and exact decodes on the card
             held to its strings by phase 6's rule (``a5 serve``).
15. a6    — ROADMAP A6's data CLIs and evaluation suite.  ``get_vocab``
             on ``data/hopv15.csv`` at ``--min_frequency 10`` must write
             ``runs/QUALITY_hopv.json.vocab.txt`` byte for byte;
             ``preprocess`` shards the in-vocab HOPV rows (batch 20, seed
             1); one epoch of ``vae_train`` from those shards on the card,
             from the checkpoint's ``vae/`` (the counts reset just before
             and read just after), and one from a CSV of the same batches
             in the order the shards gave them: every step's metrics equal
             bit for bit, each replayed step launching 3 / 22 / 20 by the
             wrappers and the device events (``a6 shard epoch``, with the
             epoch's mols/s).  Then the quality twin
             (``ggpm_tpu_torch.quality_run``) eval-only at ``--n-test 60
             --enum-root 6 --decode-steps 150`` (the counts reset just
             before and read just after), held to
             ``goldens/quality_hopv60.json`` (the JAX script's;
             tests/test_torch_quality.py rewrites it) by
             ``quality_run.compare``; its strings by phase 6's rule, at
             most 2 differing in all, each an fp32 near-tie of the card's
             and the CPU port's logs of the rows the run decoded, the CPU
             port's from its encode of the same padded batches
             (``decoded_rows``; ``a6 quality``).  Last ChemNet of
             ``random_checkpoint`` over the 60 originals on the card,
             within 1e-4 of the CPU port's, and the FCD of the
             reconstructions (``a6 chemnet``); ``a6 times`` gives the
             phase's seconds, the enum-root evaluation's rootings and
             seconds, the shard epoch's mols/s and ChemNet's ms a molecule
             beside ``nvidia-smi``'s name and power limit.
16. a7    — data-parallel training, the ChemBERTa baseline, a trace.
             (a) NCCL at world size 1: the ``prop`` epoch over the 17 HOPV
             batches from the checkpoint's ``vae/`` by a ``Trainer`` on a
             1-rank mesh, its flushes replayed from CUDA graphs with the
             step's all-reduce captured inside, bit for bit the one-card
             ``Trainer``'s epoch (parameters, moments, counts), one
             all-reduce a step counted at the call; each replayed step
             launches 3 / 22 / 20 by the wrappers and the device events
             (``a7 dp nccl``).  (e) ``profiling.trace`` around one replayed
             DP step writes a Chrome trace that parses and holds its
             ``named_scope`` (``a7 trace``; no count is held on the
             profiler's records).  (b) 2 gloo ranks on the card (NCCL
             refuses two ranks a card), three DP steps from the checkpoint
             over HOPV batches 0-5 in the Trainer's groups (0, 1), (2, 4),
             (3, 3), every rank's parameters equal bit for bit, and equal
             bit for bit to one process taking the same steps on the card
             without a collective (``profile_dp.emulated_steps``, ``a7 dp
             emulated``); held to ``goldens/train_dp2_hopv.json`` (JAX's
             ``make_dp_train_step`` on 2 virtual devices) by the prop rule
             of ``profile_train.check_golden``, the leaves' updates at
             step 1 (the card's own arithmetic, in that one process as in
             the ranks, moves one leaf's step-2 update 1.01e-3 from JAX's
             on the CPU; the CPU port meets the whole rule,
             tests/test_torch_parallel_golden.py), and printed for every
             step (``update_deviation``); one all-reduce a step, each rank
             launching 3 / 22 / 20 a step (``a7 dp2``).  (c) dp 2 × tp
             2, 4 gloo ranks, held alike to the same golden, each rank
             holding 190 of the 380 attachment rows and ``icls`` columns
             and of their moments (``a7 dp2xtp2``).  (d) ChemBERTa at the
             default width on ``data/hopv15.csv`` in batches of 16: three steps at dropout
             0 held to ``goldens/chemberta_hopv.json`` by
             ``profile_chemberta.check_golden``, steps/s and mols/s of 20
             steps at dropout 0.1 by ``profiling.Throughput`` (``a7
             chemberta``), then the ``chemberta_pr2_fine_tune`` CLI for 2
             epochs at dropout 0.1 on 300 rows with the other 50 for
             validation, its checkpoint reloaded with equal predictions
             (``a7 chemberta cli``); ``a7 times`` the seconds.  The ranks'
             launches are added into the kernels line's totals.

Where a phase holds launches "by the device events", it holds the
kernels' own device counts: each kernel's first thread counts its launch on
the card (``ops.device_launches``), read just before and just after the
profiled run, so a launch that ran is never missed.  The profiler's device
records of a kernel may fall short of those, which is its loss (it loses a
record now and then, printed as ``profiler_lost``, or in the replay
windows as ``windows_with_lost_records``), but never exceed them; what
only the profiler tells (the launches made by graph replays) is held
exactly where it lost none of the kernel's records, and as at most where
it lost some.

The line before the last is ``nvidia-smi``'s; the one before it a JSON
object listing every kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

from ggpm_tpu_torch import (kernel_bench, profile_chemberta, profile_dp,
                            profile_serve, profile_train, quality_run)
from ggpm_tpu_torch.bridge import chemberta_to_flax, flatten, load_model
from ggpm_tpu_torch.chem import canon_smiles
from ggpm_tpu_torch.data.batching import to_model_batch, train_tables
from ggpm_tpu_torch.cli import (chemberta_pr2_fine_tune, get_vocab,
                                preprocess, vae_train)
from ggpm_tpu_torch.cli.common import write_csv
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.eval import chemnet
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab, load_vocab_file
from ggpm_tpu_torch.kernel_bench import (device_ms, eager_ms, floor_ms,
                                         nvidia_smi)
from ggpm_tpu_torch.models import api, chemberta
from ggpm_tpu_torch.models.api import encode
from ggpm_tpu_torch.models import decode
from ggpm_tpu_torch.models.decode import decode_best
from ggpm_tpu_torch import ops
from ggpm_tpu_torch.ops import cuda_build, graph_ops, nei_sum
from ggpm_tpu_torch.ops.nei_sum import KINDS, device_plan, launch
from ggpm_tpu_torch.latent.control import LatentOptimizer
from ggpm_tpu_torch.profile_serve import (HIER_CKPT, HIER_VOCAB,
                                          OPTIMIZE_SETTINGS, by_kernel,
                                          optimize_targets, profile_decode,
                                          profile_optimize, profiled,
                                          profiler_loss)
from ggpm_tpu_torch.parallel import mesh as pmesh
from ggpm_tpu_torch.parallel.distributed import init_distributed
from ggpm_tpu_torch.serve import GgpmServer
from ggpm_tpu_torch.train import profiling
from ggpm_tpu_torch.train.loop import flushes, signature, to_device

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.ckpt')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens', 'decode_hopv64.json')
TRAIN_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                            'train_hopv.json')
OPT_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                          'optimize_hopv64.json')
HIER_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                           'decode_hier_hopv16.json')
FINETUNE_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                               'train_propopt_hopv.json')
HIER_TURBO_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                                 'hier_turbo_prior120.json')
HIER_TRAIN_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                                 'train_hier_hopv.json')
SCHED_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                            'train_propsched_hopv.json')
ATT_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                          'train_propopt_att_hopv.json')
HIER_ATT_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                               'train_hier_att_hopv.json')
DECODE_ATT_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                                 'decode_att_hopv16.json')
HIER_FINETUNE_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                                    'train_hier_propopt_hopv.json')
GRU_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                          'train_gru_hopv.json')
BF16_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                           'train_propopt_bf16_hopv.json')
HIER_A5_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                              'train_hier_gru_bf16_hopv.json')
DECODE_GRU_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                                 'decode_gru_hopv16.json')
DP_GOLDEN = profile_dp.GOLDEN
CHEMBERTA_GOLDEN = profile_chemberta.GOLDEN
QUALITY_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                              'quality_hopv60.json')
N_MOLS = 64
N_DECODE = 120           # the separate decode measurement (ROADMAP A1)
SAMPLE = {'n': 64, 'seed': 0}
MAX_DECODE_STEP = 150
N_CPU_CHECK = 8
HTTP_TIMEOUT = 120

# HOMO/LUMO MAE of ggpm_tpu (JAX on the CPU, the same checkpoint) on the
# same 64 molecules against the CSV labels; tests/test_torch_serve.py
# recomputes them.
JAX_MAE = {'homo': 0.011003298468887807, 'lumo': 0.012340991850236266}
MAE_TOL = 1e-4
# 20 LSTM rounds at width 250 in another summation order than the CPU's
LATENT_ATOL = 1e-4
# a sum of at most a few values of magnitude <= 1 in another order: a few
# ulps of the sum
KERNEL_ATOL = 1e-5
# the decode rule (docstring, phase 6)
NEAR_TIE = 1e-4
MAX_DIFFERING = 2
# the card's propose trace against the CPU port's (phase 12)
TRACE_ATOL = 1e-4
# the optimize rule (docstring, phase 8)
OPT_PRED_ATOL = 1e-4
# a training step's launches of each kernel (phases 7 and 9): the node,
# root and frontier readouts; their transposes and the depth loop's 20
# rounds' (2 + 20); the 20 rounds
STEP_LAUNCHES = {'nei_sum': 3.0, 'transpose_sum': 22.0, 'gather_rows': 20.0}
# with the attention heads (phase 13) the node readout's transpose too:
# the attention memory reads the node hiddens, which no loss read before
ATT_LAUNCHES = dict(STEP_LAUNCHES, transpose_sum=23.0)
# phase 14: of a replayed step's launches, those on bf16 tables (derived in
# PERF.md before the first run): with bf16 encoders, the node readout
# (its transpose is not run: no loss reads the node hiddens), the depth
# loop's 20 gathers and their transposes; an f32 model launches none
NO_BF16 = {'nei_sum': 0.0, 'transpose_sum': 0.0, 'gather_rows': 0.0}
BF16_LAUNCHES = {'nei_sum': 1.0, 'transpose_sum': 20.0, 'gather_rows': 20.0}
# phase 15: the quality twin's settings (the golden's, tests/
# test_torch_quality.py), the host processes of the data CLIs, and ChemNet's
# activations on the card against the CPU port's
QUALITY_FLAGS = ['--data', DATA, '--min-freq', '10', '--load-ckpt', CKPT,
                 '--epochs', '0', '--ft-epochs', '0', '--n-test', '60',
                 '--enum-root', '6', '--decode-steps', '150']
A6_NCPU = 8
CHEMNET_ATOL = 1e-4
# the profiled epochs of the train and finetune phases, in turns: eager,
# graph (PR 11's four turns, eager, graph, graph, eager, cut to two so that
# the hier train phase fits the run's time)
TURNS = (False, True)
# what the train and finetune phases print of each turn, eager and graph
TURN_KEYS = ('train_mols_per_s', 'train_mols_per_s_with_prep', 'step_wall_ms',
             'host_dispatch_ms_per_step', 'device_busy_ms_per_step',
             'device_idle_share')


def nei_sum_kinds(h, g):
    """Each launch kind of ``nei_sum`` forced on (h, g): its plan, max abs
    error against the plain version, and device ms; and the plan the
    wrapper chooses."""
    ref = graph_ops.nei_sum(h, g)
    out = torch.empty((g.shape[0], h.shape[1]), device=h.device)
    kinds = {}
    for kind in KINDS:
        p = device_plan(h, g, out, kind)
        err = (launch(h, g, out, p) - ref).abs().max().item()
        kinds[kind] = dict(ms=device_ms(lambda p=p: launch(h, g, out, p)),
                           max_abs_err=err, plan=dataclasses.asdict(p))
    return dataclasses.asdict(device_plan(h, g, out)), kinds


# every kernel of the port, keyed as ``profile_train.KERNELS`` (which holds
# the wrappers and their launch counts): what it replaces, where it is
# called, the paths that launch it (``decode``: the decoding requests, whose
# ``/reconstruct`` encodes first; ``turbo``: the turbo decode's propose
# graph), and the case of its row in the kernels line (``readout`` of phase
# 4, the others of the train phase)
KERNELS = {
    'nei_sum': dict(
        route='cuda', source='ggpm_tpu_torch/csrc/nei_sum.cu',
        replaces='ggpm_tpu/ops/pallas_gather.py:33', main_case='readout',
        paths=('serve', 'decode', 'turbo', 'train'),
        call_sites=['ggpm_tpu_torch/models/encoder.py:60 (node readout)',
                    'ggpm_tpu_torch/models/encoder.py:103 (root readout)',
                    'ggpm_tpu_torch/models/decoder.py:298 (dec_topo, '
                    'the decode frontier: each step of the exact path, and '
                    'each step of the turbo path\'s propose loop, '
                    'decoder.py:440 propose_step_, replayed from a CUDA '
                    'graph)',
                    'ggpm_tpu_torch/models/decoder.py:174 (_run_scan, the '
                    'teacher-forced frontier)',
                    'ggpm_tpu_torch/models/encoder.py (HierMPNEncoder: the '
                    'readouts of its three levels, the cluster sum over '
                    'cgraph and the root readout)',
                    'ggpm_tpu_torch/models/hier_decoder.py '
                    '(hdec_graph_update, hdec_topo, hdec_mess_update: the '
                    'hier decode step\'s five frontier sums)',
                    'ggpm_tpu_torch/models/hier_decoder.py (propose_step_: '
                    'the hier turbo decode\'s four frontier sums a step, '
                    'replayed from a CUDA graph)']),
    'transpose_sum': dict(
        route='cuda', source='ggpm_tpu_torch/csrc/transpose_sum.cu',
        replaces='ggpm_tpu/ops/graph_ops.py:111 (_nei_sum_t_bwd) and :134 '
                 '(_gather_nd_t_bwd): XLA gathers, no Pallas kernel; the '
                 'backward of B1, ggpm_tpu/ops/pallas_gather.py:33',
        main_case='depth-gather-bwd', paths=('train',),
        call_sites=['ggpm_tpu_torch/ops/nei_sum.py (nei_sum_t backward)',
                    'ggpm_tpu_torch/ops/gather_rows.py (gather_nd_t '
                    'backward)']),
    'gather_rows': dict(
        route='cuda', source='ggpm_tpu_torch/csrc/gather_rows.cu',
        replaces='ggpm_tpu/ops/graph_ops.py:122 (gather_nd_t forward): an '
                 'XLA gather, no Pallas kernel',
        main_case='depth-gather', paths=('serve', 'decode', 'train'),
        call_sites=['ggpm_tpu_torch/models/rnn.py (MPNLSTMCell.forward, '
                    'the depth loop; in HierMPNEncoder at the atom, '
                    'attachment and motif levels)']),
}
WRAPPERS = profile_train.KERNELS
assert set(KERNELS) == set(WRAPPERS)
# the hier family's call sites (phase 10), each with the JAX line it ports
HIER_SITES = {f'hier-{site}': line for site, line in (
    kernel_bench.HIER_ENCODE_SITES + kernel_bench.HIER_STEP_SITES +
    kernel_bench.HIER_GATHER_SITES)}
# the hier turbo decode's propose sums (phase 12), with the JAX line each
# ports
HIER_PROPOSE_SITES = {f'hier-turbo-{site}': line
                      for site, line in kernel_bench.HIER_PROPOSE_SITES}
# phase 14's kernel cases (kernel_bench.a5_cases), each with the JAX line
# it ports
A5_SITES = dict(
    **{f'{c}{s}': line for c in ('gru-depth-gather', 'bf16-depth-gather',
                                 'bf16-gru-depth-gather')
       for s, line in (('', 'ggpm_tpu/ops/graph_ops.py:122 (gather_nd_t '
                            'forward; ggpm_tpu/models/rnn.py:166)'),
                       ('-bwd', 'ggpm_tpu/ops/graph_ops.py:134 '
                                '(_gather_nd_t_bwd)'))},
    **{'bf16-readout': 'ggpm_tpu/models/encoder.py:48 (nei_sum of a bf16 '
                       'h; B1, ggpm_tpu/ops/pallas_gather.py:33)',
       'bf16-readout-bwd': 'ggpm_tpu/ops/graph_ops.py:111 '
                           '(_nei_sum_t_bwd)'})
# the hier training step's sums (phase 11), each with the JAX line it ports
HIER_TRAIN_SITES = dict(kernel_bench.HIER_TRAIN_SITES,
                        **{'atom-gather': 'ggpm_tpu/ops/graph_ops.py:122 '
                                          '(graph level)',
                           'atom-update': 'ggpm_tpu/models/hier_decoder.py:'
                                          '169 (sparse_update, an XLA '
                                          'gather)'})


def phase(name, t0):
    print(f'phase {name} ok {time.perf_counter() - t0:.3f}s', flush=True)


def check_kernels(tree, decode_trees):
    """The serve and decode paths' kernels at their shapes: ``nei_sum`` at
    every case of ``kernel_bench.measure_cases`` with each launch kind
    forced, and the depth loop's ``gather_rows`` of the request's tree."""
    floor = floor_ms()
    print(f'floor_ms {floor}', flush=True)
    report = {}
    for case, h, g, row in kernel_bench.measure_cases(tree, floor, nei_sum,
                                                      decode_trees):
        row['plan'], row['kinds'] = nei_sum_kinds(h, g)
        errs = [row['max_abs_err']] + [
            r['max_abs_err'] for r in row['kinds'].values()]
        if not max(errs) <= KERNEL_ATOL:
            raise AssertionError(f'nei_sum/{case}: max abs err {errs}')
        row['host_ms'], row['plain_host_ms'] = (
            eager_ms(lambda f=f: f(h, g))
            for f in (nei_sum, graph_ops.nei_sum))
        print(f'kernel nei_sum {case} ' + json.dumps(row), flush=True)
        report.setdefault('nei_sum', {})[case] = row
    gen = torch.Generator(device='cuda').manual_seed(2)
    for row in checked(kernel_bench.measure(
            [kernel_bench.gather_case('depth-gather-serve', tree, gen)],
            floor)):
        report.setdefault(row['kernel'], {})[row['case']] = row
    print('kernel gather_rows edges ' + json.dumps(check_gather_edges()),
          flush=True)
    return report


def check_gather_edges():
    """``gather_rows`` at every edge case of ``kernel_bench.GATHER_EDGES``
    (the card tests'): each bit for bit the plain copy, with the wrapper's
    launches and the kernel's own device count each up by one.  Returns
    the cases, the plans' paths and the seconds."""
    t0 = time.perf_counter()
    kinds = {}
    for case in kernel_bench.GATHER_EDGES:
        src, graph = kernel_bench.gather_edge_inputs(*case, device='cuda')
        before = (ops.gather_rows.launches,
                  ops.device_launches()['gather_rows'])
        out = ops.gather_rows(src, graph)
        after = (ops.gather_rows.launches,
                 ops.device_launches()['gather_rows'])
        if not (torch.equal(out, src[graph.long()]) and
                after == tuple(b + 1 for b in before)):
            raise AssertionError(f'gather_rows edge {case}: launches '
                                 f'{before} -> {after}, equal '
                                 f'{torch.equal(out, src[graph.long()])}')
        kind = kernel_bench.gather_plan(src, graph)['kind']
        kinds[kind] = kinds.get(kind, 0) + 1
    return dict(cases=len(kernel_bench.GATHER_EDGES), kinds=kinds,
                seconds=time.perf_counter() - t0)


def checked(rows):
    """Print and check each row of ``kernel_bench.measure``: max abs error
    at most ``KERNEL_ATOL`` against the plain version, and bit for bit
    against the in-order sum."""
    for row in rows:
        print(f'kernel {row["kernel"]} {row["case"]} ' + json.dumps(row),
              flush=True)
        if not (row['max_abs_err'] <= KERNEL_ATOL and row['bit_exact']):
            raise AssertionError(f'{row["kernel"]}/{row["case"]}: max abs '
                                 f'err {row["max_abs_err"]}, bit exact '
                                 f'{row["bit_exact"]}')
        yield row


def request(port, path, payload=None):
    url = f'http://127.0.0.1:{port}{path}'
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={'Content-Type': 'application/json'})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
        out = json.loads(r.read())
    print(f'request {path} {time.perf_counter() - t0:.3f}s', flush=True)
    return out


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def read_counts():
    return {name: w.launches for name, w in WRAPPERS.items()}


def check_ran(what, launches, ran, device):
    """A profiled run's launches: the wrappers' counts (``launches``)
    must equal those that ran by the kernels' own device counts (``ran``,
    from ``profiled``), and the profiler's records by kernel (``device``)
    may fall short of those (records it lost) but never exceed them.
    Returns the records lost (``profiler_loss``)."""
    lost = profiler_loss(device, ran)
    if {k: launches[k] for k in ran} != ran or \
            any(v < 0 for v in lost.values()):
        raise AssertionError(f'{what}: launches by the wrappers {launches}, '
                             f'that ran {ran}, profiler records {device}')
    return lost


def graph_records_held(graph, want, lost):
    """The profiler's records of each kernel's launches by graph replays
    (``graph``) against ``want``: equal where the profiler lost none of
    the kernel's records (``lost``, ``check_ran``), at most ``want`` where
    it lost some."""
    return all(graph[k] <= want[k] if k in lost else graph[k] == want[k]
               for k in want)


def serve(port, rows):
    """The encoding requests of the main path through GgpmServer.  Returns
    the answers, the kernel launches they made, and each request's."""
    smiles = [r[0] for r in rows]
    reset_counts()
    per_request = []
    health = request(port, '/health')
    for path in ('/encode', '/properties'):
        before = read_counts()
        out = request(port, path, {'smiles': smiles})
        per_request.append({k: v - before[k]
                            for k, v in read_counts().items()})
        if path == '/encode':
            enc = out
    return health, enc, out, read_counts(), per_request


def check_answers(health, enc, props, rows, model_cpu, batch):
    if health.get('status') != 'ok':
        raise AssertionError(f'/health: {health}')
    z = np.asarray(enc['latents'], dtype=np.float64)
    if z.shape != (N_MOLS, 24) or not np.isfinite(z).all():
        raise AssertionError(f'/encode: latents {z.shape}, finite '
                             f'{np.isfinite(z).all()}')
    mae = {}
    for key, col in (('homo', 1), ('lumo', 2)):
        pred = np.asarray(props[key], dtype=np.float64)
        if pred.shape != (N_MOLS,) or not np.isfinite(pred).all():
            raise AssertionError(f'/properties: {key} {pred.shape}')
        mae[key] = float(np.abs(pred - np.array([r[col] for r in rows])).mean())
        if abs(mae[key] - JAX_MAE[key]) > MAE_TOL:
            raise AssertionError(f'{key} MAE {mae[key]} vs JAX {JAX_MAE[key]}')
    z_cpu, _ = encode(model_cpu, batch)
    lat_err = float(np.abs(z[:N_CPU_CHECK] - z_cpu.numpy()).max())
    if not lat_err <= LATENT_ATOL:
        raise AssertionError(f'latents vs the CPU port: max abs err {lat_err}')
    print('answers ' + json.dumps(dict(homo_mae=mae['homo'],
                                       lumo_mae=mae['lumo'],
                                       jax_mae=JAX_MAE,
                                       latent_err_vs_cpu=lat_err)), flush=True)


def decode_requests(port, rows):
    """The decoding requests of the main path, each under the profiler.
    Returns their answers, seconds (profiled, without the profiler's
    processing after the request), kernel launches (the wrappers''
    counts, those that ran by the kernels' own device counts and the
    profiler's records of each kernel) and the turbo decode's
    ``TURBO_STATS``, and the kernel counts of both."""
    smiles = [r[0] for r in rows]
    reset_counts()
    out = {}
    for name, path, payload in (('reconstruct', '/reconstruct',
                                 {'smiles': smiles}),
                                ('sample', '/sample', SAMPLE)):
        before = read_counts()
        answer, ran = [], {}

        def run():
            t0 = time.perf_counter()
            answer.append(request(port, path, payload))
            torch.cuda.synchronize()
            answer.append(time.perf_counter() - t0)
        _, events = profiled(run, ran=ran)
        out[name] = dict(
            smiles=answer[0]['smiles'], seconds=answer[1],
            launches={k: v - before[k] for k, v in read_counts().items()},
            ran=ran, device=by_kernel(events),
            turbo=dict(decode.TURBO_STATS))
    return out, read_counts()


def _order_gap(card, cpu):
    """Where two logged candidate lists part: the first position whose
    entry differs, and the CPU's score gap between its entry there and the
    card's entry (the CPU list's last score if the card's is not in it)."""
    keys = [c[:-1] for c in cpu]
    for k, (a, c) in enumerate(zip(card, cpu)):
        if a[:-1] != c[:-1]:
            other = cpu[keys.index(a[:-1])][-1] if a[:-1] in keys else cpu[-1][-1]
            return abs(c[-1] - other)
    return None


def first_divergence(card_log, cpu_log):
    """First step where one molecule's card and CPU logs part: (step,
    what, margin in the CPU log); None if they never do."""
    for t, (a, c) in enumerate(zip(card_log, cpu_log)):
        if t == 0 and a['root'] != c['root']:
            return t, 'root', float('inf')   # the log holds no cls scores
        for key in ('top-5-root-attachments', 'top-5-inter-cands'):
            if key in a and key in c:
                gap = _order_gap(a[key], c[key])
                if gap is not None:
                    return t, key, gap
        pa, pc = a.get('Generate fragment'), c.get('Generate fragment')
        if (pa is None) != (pc is None) or (
                pa is not None and (pa > 0.5) != (pc > 0.5)):
            return t, 'Generate fragment', (
                float('inf') if pc is None else abs(pc - 0.5))
    return None


def check_decode(name, got, ref, card_logs, cpu_logs):
    """The decode rule for one request: returns the differing indices and
    prints each one's first divergence."""
    if len(got) != len(ref):
        raise AssertionError(f'/{name}: {len(got)} answers, need {len(ref)}')
    if sum(s is None for s in got) != sum(s is None for s in ref):
        raise AssertionError(f'/{name}: None count differs from the JAX '
                             f'reference')
    differ = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    for i in differ:
        div = first_divergence(card_logs()[i], cpu_logs()[i])
        print(f'decode {name} differs at {i}: {got[i]} vs {ref[i]}; first '
              f'divergence (step, what, CPU margin) {div}', flush=True)
        if div is None or not div[2] < NEAR_TIE:
            raise AssertionError(f'/{name}[{i}] differs from the JAX '
                                 f'reference beyond an fp32 near-tie: {div}')
    return differ


def logs_of(model, vocab, latents):
    """Per-step logs of a greedy decode of ``latents()`` on the model's
    device, computed once on first use."""
    memo = []

    def get():
        if not memo:
            memo.append(decode_best(model, vocab, common_atom_vocab,
                                    latents(), max_decode_step=MAX_DECODE_STEP,
                                    log_steps=True)[0])
        return memo[0]
    return get


def decode_phase(model, model_cpu, vocab, rows, answers, enc, batch,
                 depth):
    """Hold the decoding answers to the JAX reference and their launches
    to the steps the decodes ran (``depth`` rounds of the depth loop an
    encode); returns what the phase prints."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    smiles = [r[0] for r in rows]
    if golden['inputs'] != smiles or golden['sample_request'] != SAMPLE:
        raise AssertionError('the golden file is not for these requests')
    z_card = np.asarray(enc['latents'], dtype=np.float32)
    z_prior = np.random.default_rng(SAMPLE['seed']).standard_normal(
        (SAMPLE['n'], z_card.shape[1])).astype(np.float32)
    differ = {}
    for name, z_c, z_p in (
            ('reconstruct', lambda: z_card,
             lambda: encode(model_cpu, batch)[0]),
            ('sample', lambda: z_prior, lambda: z_prior)):
        differ[name] = check_decode(
            name, answers[name]['smiles'], golden[name],
            logs_of(model, vocab, z_c), logs_of(model_cpu, vocab, z_p))
    n_differ = sum(len(d) for d in differ.values())
    if n_differ > MAX_DIFFERING:
        raise AssertionError(f'{n_differ} decoded strings differ from the '
                             f'JAX reference, at most {MAX_DIFFERING} may')

    # the depth loop's launches, and B1's against the steps the decode ran
    turbo = {}
    for name, encodes in (('reconstruct', 1), ('sample', 0)):
        a, st = answers[name], answers[name]['turbo']
        expected = (2 * encodes + sum(st['steps_run']) + st['eager_steps'])
        lost = check_ran(f'/{name}', a['launches'], a['ran'], a['device'])
        turbo[name] = dict(
            nei_sum_launches=a['launches']['nei_sum'],
            nei_sum_ran=a['ran']['nei_sum'],
            nei_sum_device_launches=a['device']['nei_sum'],
            profiler_lost=lost, expected=expected, encodes=encodes,
            **{k: st[k] for k in ('rounds', 'fallbacks', 'rungs',
                                  'pending_per_round', 'steps', 'steps_run',
                                  'eager_steps')})
        print(f'decode turbo {name} ' + json.dumps(turbo[name]), flush=True)
        if not (a['launches']['gather_rows'] == depth * encodes and
                a['launches']['nei_sum'] == expected):
            raise AssertionError(
                f'/{name}: launches {a["launches"]}; expected nei_sum '
                f'{expected}, gather_rows {depth * encodes}')
    canon = [canon_smiles(s) for s in smiles]
    rec = answers['reconstruct']['smiles']
    return dict(
        {f'{n}_seconds': answers[n]['seconds'] for n in answers},
        turbo=turbo, launches={n: answers[n]['launches'] for n in answers},
        validity={n: sum(s is not None for s in answers[n]['smiles']) /
                  len(answers[n]['smiles']) for n in answers},
        exact_reconstruction=sum(a == b for a, b in zip(rec, canon)) / len(rec),
        differ_from_jax=differ)


def golden_check(name, trainer, batches, path, **rule):
    """The first golden steps of ``trainer`` on ``batches`` held to the
    JAX package's in ``path`` by ``profile_train.check_golden`` (``rule``;
    a bf16 golden's ``f32_steps`` widen it by the bf16 rule); prints the
    steps, the updates' deviation, the peak memory and the failures, and
    raises on any.  Returns the printed record and the golden."""
    with open(path) as f:
        golden = json.load(f)
    torch.cuda.reset_peak_memory_stats()
    steps = profile_train.golden_steps('cuda', trainer, batches)
    bad = profile_train.check_golden(steps, golden,
                                     f32=golden.get('f32_steps'), **rule)
    out = dict(steps=[{k: v for k, v in s.items() if k != 'update_norms'}
                      for s in steps],
               update_deviation=profile_train.update_deviation(steps, golden),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               failures=bad)
    print(f'{name} golden ' + json.dumps(out), flush=True)
    if bad:
        raise AssertionError(f'{name} steps differ from the JAX package\'s: '
                             f'{bad}')
    return out, golden


def golden_train_epoch(name, trainer, make, batches, golden_path, **rule):
    """Phases 7 and 9: the golden steps of ``trainer`` held to the JAX
    package's, the eager and graph epochs held to each other
    (``graph_vs_eager``, fresh trainers from ``make``), then epochs
    profiled eager and through graphs in ``TURNS``; the counts are reset
    just before and read just after, and
    every kernel must have launched.  Returns the first eager profile, the
    counts, the turns and the graph check."""
    reset_counts()
    golden_check(name, trainer, batches, golden_path, **rule)
    check = graph_vs_eager(name, make, batches)
    turns = {False: [], True: []}
    for i, graph in enumerate(TURNS):
        prof = profile_train.profile_epoch(trainer, batches, graph=graph)
        turns[graph].append(prof)
        print(f'{name} {"graph" if graph else "eager"} turn {i} '
              + json.dumps(prof), flush=True)
        # the device events of a whole epoch are printed, not held: the
        # profiler may lose some of its 100,000 records (graph_vs_eager)
        if prof['kernel_launches_per_step'] != STEP_LAUNCHES:
            raise AssertionError(f'{name} turn {i}: launches per step '
                                 f'{prof["kernel_launches_per_step"]}, '
                                 f'expected {STEP_LAUNCHES}')
    counts = read_counts()
    if min(counts.values()) == 0:
        raise AssertionError(f'a kernel never launched on the {name} '
                             f'path: {counts}')
    print(f'{name} turns ' + json.dumps({
        k: {'eager': [p.get(k) for p in turns[False]],
            'graph': [p.get(k) for p in turns[True]]} for k in TURN_KEYS}),
        flush=True)
    return turns[False][0], counts, turns, check


def graph_vs_eager(name, make, batches, expected=STEP_LAUNCHES, epochs=2,
                   expected_bf16=None):
    """``epochs`` epochs from the same checkpoint in the JAX order, once
    eager and once through graphs (``Trainer.scan_steps``; the first epoch
    captures one graph per signature, a second replays only): every
    step's metrics, breaker flag and group norms, and the parameters,
    Adam moments and counts after, must be equal bit for bit.  Then every
    replayed step runs again in a profiler window of its own: each must
    launch ``expected`` (``STEP_LAUNCHES``, or a function of the scan's
    steps T) by the wrappers' counts and by the kernels' own device
    counts, and the profiler's device events may fall short of those
    (records it lost, printed) but not exceed them
    (``profile_train.check_replay_windows``).  With ``expected_bf16`` (a
    dict, or a function of T) the wrappers' launches on bf16 tables are
    held in every window too.
    Prints and returns the signatures captured, the
    capture seconds, the graphs' pools, the peak memory and each replay
    window's wall ms (under the profiler) and device busy ms."""
    rows, states = {}, {}
    for graph in (False, True):
        tr = make()
        groups = profile_train.flush_groups(tr, batches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows[graph] = []
        for _ in range(epochs):
            profile_train.run_epoch(tr, groups, graph, rows[graph])
        torch.cuda.synchronize()
        states[graph] = opt_states(tr)
        if not graph:
            del tr
    differ = [f'step {i} {k}' for i, (e, g) in enumerate(
        zip(rows[False], rows[True])) for k in e
        if not torch.equal(bits(e[k]), bits(g[k]))]
    differ += [k for k in states[False]
               if not torch.equal(bits(states[False][k]),
                                  bits(states[True][k]))]
    windows = profile_train.replay_windows(tr, groups)
    bad, lost = profile_train.check_replay_windows(windows, expected)
    if expected_bf16 is not None:
        want = expected_bf16 if callable(expected_bf16) else \
            (lambda _: expected_bf16)
        bad += [(i, 'launches_bf16', w['launches_bf16'])
                for i, w in enumerate(windows)
                if w['launches_bf16'] != want(w['scan_steps'])]
    out = dict(steps=len(rows[True]), differing=differ[:20],
               n_differing=len(differ), keys=sorted(rows[True][0]),
               **tr.graph_stats(),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               replayed_steps=len(windows),
               launches_per_replayed_step=windows[0]['launches'],
               ran_per_replayed_step=windows[0]['ran'],
               launches_bf16_per_replayed_step=windows[0]['launches_bf16'],
               device_kernels_per_replayed_step=max(
                   windows, key=lambda w: w['records'])['device_by_name'],
               device_launches_per_replayed_step=max(
                   windows, key=lambda w: w['records'])['device'],
               windows_with_lost_records=lost,
               replayed_step_wall_ms=[w['wall_ms'] for w in windows],
               replayed_step_device_ms=[w['device_busy_ms']
                                        for w in windows])
    print(f'{name} graph vs eager ' + json.dumps(out), flush=True)
    if differ or len(rows[True]) != epochs * len(batches):
        raise AssertionError(f'{name}: graph and eager epochs differ at '
                             f'{differ[:20]}')
    if bad:
        raise AssertionError(f'{name}: replayed steps (step, count, '
                             f'launches) {bad}, expected {expected}')
    return out


def bits(t):
    """A float32 tensor's bits, to compare bit for bit."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def opt_states(tr):
    """Copies of a trainer's parameters, Adam moments and device counts,
    by group."""
    opt = getattr(tr.opt_state, 'groups', {'': tr.opt_state})
    return {f'{g}/{k}': getattr(st, k).clone() for g, st in opt.items()
            for k in ('flat', 'mu', 'nu', 'count_dev')}


def device_scalars(trainer):
    """The optimizer's learning rate and bias corrections on the card for
    counts 1..3 epochs against the host's floats for them: how many
    differ (the device form equals them bit for bit on the CPU)."""
    st, opt = trainer.opt_state, trainer.opt_state.opt
    counts = range(1, 3 * opt.steps_per_epoch + 1)
    n = torch.tensor(list(counts), device='cuda')
    bc1, bc2 = st.bias_corrections(n)
    lr = st.schedule_t(n - 1)
    f32 = lambda b, k: float(1 - torch.tensor(b, dtype=torch.float32) ** k)
    host = {'bc1': [f32(opt.b1, k) for k in counts],
            'bc2': [f32(opt.b2, k) for k in counts],
            'lr': [opt.schedule(k - 1) for k in counts]}
    dev = {'bc1': bc1.tolist(), 'bc2': bc2.tolist(), 'lr': lr.tolist()}
    return dict(counts=len(counts), differing={
        k: sum(a != b for a, b in zip(host[k], dev[k])) for k in host})


def train_phase(vocab, batches):
    """The training path: the golden steps, the graph check, epochs
    profiled in turns, the counts of the path, and the step's kernels at
    its shapes.  Returns the first eager profile, the counts, the kernel
    rows, the turns and the graph check."""
    trainer, _ = profile_train.canonical_trainer('cuda', vocab)
    print('train device scalars ' + json.dumps(device_scalars(trainer)),
          flush=True)
    prof, counts, turns, check = golden_train_epoch(
        'train', trainer,
        lambda: profile_train.canonical_trainer('cuda', vocab)[0], batches,
        TRAIN_GOLDEN)
    rows = {}
    batch = trainer.device_batch(trainer.host_batch(batches[0]))
    gen = torch.Generator(device='cuda').manual_seed(1)
    for row in checked(kernel_bench.measure(
            kernel_bench.train_cases(batch, gen), floor_ms())):
        rows.setdefault(row['kernel'], {})[row['case']] = row
    return prof, counts, rows, turns, check


def finetune_phase(vocab, batches, train_turns):
    """The prop-opt fine-tuning path: its golden steps, the graph check
    and epochs profiled in turns, beside the prop step's
    (``train_turns``).  Returns the first eager profile, the counts and
    the graph check."""
    trainer, _ = profile_train.finetune_trainer('cuda')
    prof, counts, turns, check = golden_train_epoch(
        'finetune', trainer, lambda: profile_train.finetune_trainer('cuda')[0],
        batches, FINETUNE_GOLDEN,
        later_update_rtol=profile_train.FINETUNE_LATER_UPDATE_RTOL)
    print('finetune vs train ' + json.dumps({
        k: {mode: [[p.get(k) for p in t[graph]] for t in (turns, train_turns)]
            for mode, graph in (('eager', False), ('graph', True))}
        for k in TURN_KEYS}), flush=True)
    return prof, counts, check


def hier_step_launches(cfg):
    """A hier training step's launches of each kernel for a scan of T
    padded steps (phase 11, derived in PERF.md §6): ``nei_sum`` the
    encoder's five readouts and the scan's five sums a step;
    ``gather_rows`` the three depth loops' D = depthG + 2·depthT rounds and
    the scan's U = n·(diterG + 2·diterT) message-update gathers a step, n
    the cell's states (2 for the LSTM's h and c, 1 for the GRU's h);
    ``transpose_sum`` the backward of each of those but the motif level's
    node readout, which the loss does not read unless the attention heads
    do (``use_attention``: its memory), and 3·n − 1 gathers of step 0
    whose states need no gradient yet (the atom level's first round and
    the attachment level's, each state; the motif level's but ``h``)."""
    n = 1 if cfg.rnn_type == 'GRU' else 2
    d = cfg.depthG + 2 * cfg.depthT
    u = n * (cfg.diterG + 2 * cfg.diterT)
    node = float(cfg.use_attention)
    return lambda T: {'nei_sum': 5.0 + 5 * T,
                      'transpose_sum': 4.0 + node + d + (5 + u) * T
                      - (3 * n - 1),
                      'gather_rows': float(d + u * T)}


def hier_train_phase(floor):
    """Phase 11: the hier family's training path.  Returns the eager and
    graph profiles, the counts of the path, the kernel rows and the graph
    check."""
    vocab = profile_train.load_vocab_file(HIER_VOCAB)
    _, batches = profile_train.hopv_batches(vocab=vocab)
    if len(batches) != profile_train.STEPS_PER_EPOCH:
        raise AssertionError(f'{len(batches)} HOPV batches in the hier '
                             f'vocab, need {profile_train.STEPS_PER_EPOCH}')
    reset_counts()
    for finetune, path in ((False, HIER_TRAIN_GOLDEN),
                           (True, HIER_FINETUNE_GOLDEN)):
        tr, _ = profile_train.hier_trainer('cuda', finetune, vocab)
        golden_check('hier finetune' if finetune else 'hier train', tr,
                     batches, path, **profile_train.hier_rule(finetune))
        del tr
    trainer, _ = profile_train.hier_trainer('cuda', vocab=vocab)
    expected = hier_step_launches(trainer.model.cfg)
    check = graph_vs_eager(
        'hier train', lambda: profile_train.hier_trainer('cuda',
                                                         vocab=vocab)[0],
        batches, expected, epochs=1)
    torch.cuda.empty_cache()
    groups = profile_train.flush_groups(trainer, batches)
    want = [expected(db['plan']['mess'].shape[0]) for g in groups for db in g]
    per_step = {k: sum(w[k] for w in want) / len(want) for k in want[0]}
    profs = {}
    for graph in (False, True):
        prof = profile_train.profile_epoch(trainer, batches, graph=graph,
                                           full=False)
        profs[graph] = prof
        print(f'hier train {"graph" if graph else "eager"} '
              + json.dumps(prof), flush=True)
        if prof['kernel_launches_per_step'] != per_step:
            raise AssertionError(f'hier train: launches per step '
                                 f'{prof["kernel_launches_per_step"]}, '
                                 f'expected {per_step}')
    counts = read_counts()
    if min(counts.values()) == 0:
        raise AssertionError(f'a kernel never launched on the hier train '
                             f'path: {counts}')
    rows = {}
    batch = trainer.device_batch(trainer.host_batch(batches[0]))
    gen = torch.Generator(device='cuda').manual_seed(1)
    for row in checked(kernel_bench.measure(
            kernel_bench.hier_train_cases(batch, gen), floor)):
        rows.setdefault(row['kernel'], {})[row['case']] = row
    return profs, counts, rows, check


def first_pair(trainer, batches):
    """The first two of ``batches`` that the trainer steps through in one
    flush (one signature), for ``graph_vs_eager``."""
    keyed = [(signature(trainer.host_batch(b)), b) for b in batches]
    return next([b for _, b in group[:2]]
                for group in flushes(keyed, lambda x: x[0])
                if len(group) > 1)


def sched_att_phase(vocab, batches, floor):
    """Phase 13: prop-opt-sched and the attention models (docstring).
    Returns the phase's summary, the launches of its paths, the kernel rows
    at the scheduled readout and the calls and launches counted there
    (``kernel_bench.sched_site``)."""
    summary, seconds = {}, {}
    t_part = [time.perf_counter()]

    def part(name):
        t = time.perf_counter()
        seconds[name] = t - t_part[0]
        t_part[0] = t
    reset_counts()
    # 1. prop-opt-sched: the golden steps, the tf_ratio 0.5 step, the
    # graph check and the replayed step's profile, each launch at the
    # scheduled readout counted where it is made
    with kernel_bench.sched_site() as site:
        trainer, _ = profile_train.sched_trainer('cuda', vocab)
        _, golden = golden_check(
            'sched', trainer, batches, SCHED_GOLDEN,
            later_update_rtol=profile_train.FINETUNE_LATER_UPDATE_RTOL)
        host = trainer.host_batch(batches[0])
        got = profile_train.sched_step(
            profile_train.sched_model(vocab)[0].to('cuda'),
            trainer.device_batch(host),
            profile_train.sched_coins(golden, 'cuda'))
        cpu = profile_train.sched_step(
            profile_train.sched_model(vocab)[0],
            to_device(train_tables(host), 'cpu'),
            profile_train.sched_coins(golden, 'cpu'))
        bad, ties = profile_train.check_sched_step(got, cpu, golden)
        summary['sched_step'] = dict(
            metrics=got['metrics'], golden=golden['sched_step']['metrics'],
            fed_back=int(cpu['use'].sum()), near_ties=ties, failures=bad,
            grad_deviation=profile_train.grad_deviation(got, cpu))
        print('sched tf0.5 step ' + json.dumps(summary['sched_step']),
              flush=True)
        if bad:
            raise AssertionError(f'sched tf_ratio 0.5 step: {bad}')
        del got, cpu
        part('sched golden and tf0.5 step')
        summary['graph'] = graph_vs_eager(
            'sched', lambda: profile_train.sched_trainer('cuda', vocab)[0],
            batches, epochs=1)
        part('sched graph vs eager')
        prof = profile_train.profile_epoch(trainer, batches, graph=True)
        summary['profile'] = prof
        print('sched graph ' + json.dumps(prof), flush=True)
        if prof['kernel_launches_per_step'] != STEP_LAUNCHES:
            raise AssertionError(f'sched: launches per step '
                                 f'{prof["kernel_launches_per_step"]}, '
                                 f'expected {STEP_LAUNCHES}')
    print('sched readout site ' + json.dumps(site), flush=True)
    if not site['sched-readout']['launches'] == \
            site['sched-readout-bwd']['launches'] > 0:
        raise AssertionError(f'sched: the readout\'s launches and its '
                             f'backward\'s differ, or none: {site}')
    rows = {}
    gen = torch.Generator(device='cuda').manual_seed(3)
    for row in checked(kernel_bench.measure(kernel_bench.sched_cases(
            trainer.device_batch(host), gen), floor)):
        rows.setdefault(row['kernel'], {})[row['case']] = row
    del trainer
    torch.cuda.empty_cache()
    part('sched profile and kernels')

    # 2. the attention models: golden steps and the graph check of the
    # first two batches of one signature each
    hvocab = profile_train.load_vocab_file(HIER_VOCAB)
    _, hbatches = profile_train.hopv_batches(profile_train.GOLDEN_STEPS,
                                             hvocab)
    for name, hier, path, bs in (('att', False, ATT_GOLDEN, batches),
                                 ('hier att', True, HIER_ATT_GOLDEN,
                                  hbatches)):
        v = hvocab if hier else vocab
        tr, _ = profile_train.attention_trainer('cuda', hier, v)
        rule = (profile_train.hier_rule() if hier else dict(
            later_update_rtol=profile_train.FINETUNE_LATER_UPDATE_RTOL))
        peak = golden_check(name, tr, bs, path,
                            **rule)[0]['max_memory_allocated']
        expected = (hier_step_launches(tr.model.cfg) if hier
                    else ATT_LAUNCHES)
        pair = first_pair(tr, bs)
        del tr
        summary[name] = graph_vs_eager(
            name, lambda: profile_train.attention_trainer('cuda', hier, v)[0],
            pair, expected, epochs=1)
        summary[name]['golden_max_memory_allocated'] = peak
        torch.cuda.empty_cache()
        part(name)

    # 3. decode_motif with the attention memory of the 16 golden molecules
    with open(DECODE_ATT_GOLDEN) as f:
        dgold = json.load(f)
    model = profile_train.attention_model(vocab=vocab)[0].eval().to('cuda')
    model_cpu = profile_train.attention_model(vocab=vocab)[0].eval()
    drows = prune_to_vocab(read_csv_data(DATA), vocab,
                           verbose=False)[:len(dgold['inputs'])]
    if [r[0] for r in drows] != dgold['inputs']:
        raise AssertionError('the attention decode golden is not for these '
                             'molecules')
    batch = to_model_batch(tensorize(drows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)

    def att_decode(m, device, logs):
        z, _ = encode(m, batch)
        with torch.no_grad():
            mem, scope = m.encode_attention_memory(
                to_device(batch['tree'], device))
        return decode.decode_motif(m, vocab, common_atom_vocab, z,
                                   max_decode_step=dgold['max_decode_step'],
                                   log_steps=logs, src_mem=mem,
                                   src_scope=scope)

    def logs(m, device):
        memo = []
        return lambda: memo[0] if memo else memo.append(
            att_decode(m, device, True)[0]) or memo[0]

    t0 = time.perf_counter()
    _, smiles = att_decode(model, 'cuda', False)
    decode_s = time.perf_counter() - t0
    differ = check_decode('att-reconstruct', smiles, dgold['reconstruct'],
                          logs(model, 'cuda'), logs(model_cpu, 'cpu'))
    summary['decode'] = dict(seconds=decode_s, differ_from_jax=differ,
                             validity=sum(x is not None for x in smiles) /
                             len(smiles))
    print('att decode ' + json.dumps(summary['decode']), flush=True)
    if len(differ) > MAX_DIFFERING:
        raise AssertionError(f'{len(differ)} attention decode strings '
                             f'differ from the JAX reference')
    counts = read_counts()
    if min(counts.values()) == 0:
        raise AssertionError(f'a kernel never launched on the phase 13 '
                             f'paths: {counts}')
    summary['launches'] = counts
    part('att decode')
    print('sched+att seconds ' + json.dumps(seconds), flush=True)
    return summary, counts, rows, site


def a5_serve(golden, models):
    """Phase 14's serving: for each model of ``goldens/decode_gru_hopv16
    .json`` (GRU + untied ``prop-opt`` and ``hier-prop``, seeded, on the
    card and on the CPU), ``/encode`` of its 16 molecules through a
    ``GgpmServer`` within ``LATENT_ATOL`` of the CPU port's latents; then,
    from the golden's latents (so that the strings do not depend on the
    encoder's rounding), the greedy turbo decode (``decode_best``) and the
    exact one on the card, each held to the golden's strings by phase 6's
    rule, and the turbo's to the exact's."""
    out = {}
    for name, ((model, vocab), (model_cpu, _)) in models.items():
        g = golden['models'][name]
        server = GgpmServer(model, vocab, max_decode_step=golden[
            'max_decode_step'], device='cuda')
        port = server.start(port=0).server_address[1]
        try:
            enc = request(port, '/encode', {'smiles': g['inputs']})
        finally:
            server.stop()
        batch = to_model_batch(tensorize([[s, None, None] for s in
                                          g['inputs']], vocab,
                                         common_atom_vocab),
                               vocab.mask, pad=False)
        with torch.no_grad():
            z_cpu = encode(model_cpu, batch)[0].numpy()
        lat_err = float(np.abs(np.asarray(enc['latents']) - z_cpu).max())
        if not lat_err <= LATENT_ATOL:
            raise AssertionError(f'{name} /encode: latents {lat_err} from '
                                 f'the CPU port\'s')
        z = np.asarray(g['latents'], np.float32)
        kw = dict(greedy=True, max_decode_step=golden['max_decode_step'])
        t0 = time.perf_counter()
        _, turbo = decode_best(model, vocab, common_atom_vocab, z, **kw)
        turbo_s = time.perf_counter() - t0
        stats = dict(decode.TURBO_STATS)
        exact_fn = decode.decode_hier if name == 'hier-prop' else \
            decode.decode_motif
        t0 = time.perf_counter()
        _, exact = exact_fn(model, vocab, common_atom_vocab, z,
                            log_steps=False, **kw)
        exact_s = time.perf_counter() - t0

        def logs(m):
            memo = []
            return lambda: memo[0] if memo else memo.append(decode_best(
                m, vocab, common_atom_vocab, z, log_steps=True,
                **kw)[0]) or memo[0]
        card_logs, cpu_logs = logs(model), logs(model_cpu)
        differ = {which: check_decode(f'{name}-{which}', got,
                                      g['reconstruct'], card_logs, cpu_logs)
                  for which, got in (('turbo', turbo), ('exact', exact))}
        out[name] = dict(latent_err_vs_cpu=lat_err, differ_from_jax=differ,
                         turbo_vs_exact=[i for i, (a, b) in enumerate(
                             zip(turbo, exact)) if a != b],
                         turbo_s=turbo_s, exact_s=exact_s,
                         rounds=stats.get('rounds'),
                         fallbacks=stats.get('fallbacks'),
                         mean_len=float(np.mean([len(s or '')
                                                 for s in turbo])))
        if any(len(d) > MAX_DIFFERING for d in differ.values()) or \
                len(out[name]['turbo_vs_exact']) > MAX_DIFFERING:
            raise AssertionError(f'{name} decodes: {out[name]}')
    return out


def a5_phase(vocab, batches, floor):
    """Phase 14: ROADMAP A5's options on the card (docstring).  Returns the
    phase's summary, the launches of its paths (and of them those on bf16
    tables) and the kernel rows of its new sites."""
    summary, seconds = {}, {}
    t_part = [time.perf_counter()]

    def part(name):
        t = time.perf_counter()
        seconds[name] = t - t_part[0]
        t_part[0] = t
    reset_counts()
    bf16_before = {n: w.launches_bf16 for n, w in WRAPPERS.items()}
    # 1. prop with the GRU cell (seeded): golden steps, graph = eager,
    # a graph epoch profiled
    trainer, _ = profile_train.gru_trainer('cuda', vocab)
    summary['gru golden'] = golden_check('gru', trainer, batches,
                                         GRU_GOLDEN)[0]
    summary['gru'] = graph_vs_eager(
        'gru', lambda: profile_train.gru_trainer('cuda', vocab)[0], batches,
        epochs=1, expected_bf16=NO_BF16)
    summary['gru graph'] = profile_train.profile_epoch(
        trainer, batches, graph=True, full=False)
    print('gru graph ' + json.dumps(summary['gru graph']), flush=True)
    rows = {}
    gen = torch.Generator(device='cuda').manual_seed(5)
    for row in checked(kernel_bench.measure(kernel_bench.a5_cases(
            trainer.device_batch(trainer.host_batch(batches[0])), gen),
            floor)):
        rows.setdefault(row['kernel'], {})[row['case']] = row
    del trainer
    torch.cuda.empty_cache()
    part('gru')

    # 2. prop-opt with bf16 encoders (the trained checkpoint)
    trainer, _ = profile_train.finetune_trainer('cuda', 'bf16')
    summary['bf16 golden'] = golden_check(
        'bf16', trainer, batches, BF16_GOLDEN,
        later_update_rtol=profile_train.FINETUNE_LATER_UPDATE_RTOL)[0]
    summary['bf16'] = graph_vs_eager(
        'bf16', lambda: profile_train.finetune_trainer('cuda', 'bf16')[0],
        batches, epochs=1, expected_bf16=BF16_LAUNCHES)
    summary['bf16 graph'] = profile_train.profile_epoch(
        trainer, batches, graph=True, full=False)
    print('bf16 graph ' + json.dumps(summary['bf16 graph']), flush=True)
    del trainer
    torch.cuda.empty_cache()
    part('bf16')

    # 3. hier-prop with GRU, untied embeddings and bf16 (seeded)
    hvocab = profile_train.load_vocab_file(HIER_VOCAB)
    _, hbatches = profile_train.hopv_batches(profile_train.GOLDEN_STEPS,
                                             hvocab)
    tr, _ = profile_train.hier_a5_trainer('cuda', hvocab)
    summary['hier a5 golden'] = golden_check(
        'hier a5', tr, hbatches, HIER_A5_GOLDEN,
        **profile_train.HIER_A5_RULE)[0]
    cfg = tr.model.cfg
    d = cfg.depthG + 2 * cfg.depthT
    pair = first_pair(tr, hbatches)
    del tr
    torch.cuda.empty_cache()
    summary['hier a5'] = graph_vs_eager(
        'hier a5', lambda: profile_train.hier_a5_trainer('cuda', hvocab)[0],
        pair, hier_step_launches(cfg), epochs=1,
        expected_bf16={'nei_sum': 3.0, 'transpose_sum': d + 2.0,
                       'gather_rows': float(d)})
    torch.cuda.empty_cache()
    part('hier a5')

    # 4. serving a GRU + untied model of each family (seeded)
    with open(DECODE_GRU_GOLDEN) as f:
        dgold = json.load(f)
    cpu = profile_train.gru_serve_models(vocab, hvocab)
    card = profile_train.gru_serve_models(vocab, hvocab)
    summary['serve'] = a5_serve(dgold, {
        name: ((m.eval().to('cuda'), v), (c.eval(), v))
        for name, (m, v), (c, _) in zip(('prop-opt', 'hier-prop'), card,
                                        cpu)})
    print('a5 serve ' + json.dumps(summary['serve']), flush=True)
    part('serve')
    counts = read_counts()
    bf16 = {n: w.launches_bf16 - bf16_before[n] for n, w in WRAPPERS.items()}
    if min(counts.values()) == 0 or min(bf16.values()) == 0:
        raise AssertionError(f'a kernel never launched on the phase 14 '
                             f'paths: {counts}, on bf16 tables {bf16}')
    summary['launches'], summary['launches_bf16'] = counts, bf16
    print('a5 seconds ' + json.dumps(seconds), flush=True)
    return summary, counts, bf16, rows


def optimize_requests(server, port, rows, golden):
    """The /optimize requests of the main path, each under the profiler:
    ``hard`` over HTTP, the others through ``GgpmServer.optimize`` with the
    golden's settings (``profile_serve.profile_optimize``, whose profiled
    request is the one held to the golden).  Returns each one's answer,
    the search's stats, kernel launches (the wrappers' counts, those that
    ran by the kernels' own device counts and the profiler's records of
    each kernel) and the turbo decode's stats, and each policy's
    ``profile_optimize`` split."""
    smiles = [r[0] for r in rows]
    out, profiles = {}, {}
    for policy, g in golden['policies'].items():
        if g['settings'] != OPTIMIZE_SETTINGS[policy]:
            raise AssertionError(f'the golden\'s {policy} settings are not '
                                 f'OPTIMIZE_SETTINGS\'s')
        if policy == 'hard':
            before = read_counts()
            answer, ran = [], {}
            _, events = profiled(lambda: answer.append(request(
                port, '/optimize', {'smiles': smiles, 'homo': golden['homo'],
                                    'lumo': golden['lumo'],
                                    'policy': 'hard'})), ran=ran)
            out[policy] = dict(
                answer=answer[0], search=dict(server.search_stats),
                launches={k: v - before[k] for k, v in read_counts().items()},
                ran=ran, device=by_kernel(events),
                turbo=dict(decode.TURBO_STATS))
        prof = profile_optimize(server, rows, policy, **g['settings'])
        out.setdefault(policy, {k: prof[k] for k in (
            'answer', 'search', 'launches', 'ran', 'device')})
        out[policy].setdefault('turbo', {k: prof[k] for k in (
            'rounds', 'fallbacks', 'steps_run', 'eager_steps')})
        profiles[policy] = {k: v for k, v in prof.items()
                            if k not in ('answer', 'search')}
    return out, profiles


def searched(model, batch, homo, lumo, policy, settings):
    """The latents a search of ``batch``'s encoding on the model's device
    reaches (for the decode logs of a differing string)."""
    z = encode(model, batch)[0]
    return LatentOptimizer(model, optimize_type=policy,
                           **settings).optimize(z, homo, lumo)


def optimize_phase(model, model_cpu, vocab, rows, answers, golden, batch,
                   depth):
    """Hold each /optimize answer to the JAX reference and its launches to
    the steps its decode ran; returns what the phase prints."""
    if golden['inputs'] != [r[0] for r in rows]:
        raise AssertionError('the optimize golden is not for these requests')
    homo, lumo = optimize_targets(rows)
    if not (np.allclose(homo, golden['homo'], rtol=0, atol=1e-7) and
            np.allclose(lumo, golden['lumo'], rtol=0, atol=1e-7)):
        raise AssertionError('the optimize golden\'s targets differ')
    summary = {}
    for policy, a in answers.items():
        g = golden['policies'][policy]
        ans = a['answer']
        err = max(float(np.abs(np.asarray(ans[k], np.float64) -
                               np.asarray(g[k])).max())
                  for k in ('homo', 'lumo'))
        if len(ans['homo']) != N_MOLS or not err <= OPT_PRED_ATOL:
            raise AssertionError(f'/optimize {policy}: predictions off the '
                                 f'JAX reference by {err}')
        args = (homo, lumo, policy, g['settings'])
        differ = check_decode(
            f'optimize {policy}', ans['smiles'], g['smiles'],
            logs_of(model, vocab, lambda: searched(model, batch, *args)),
            logs_of(model_cpu, vocab,
                    lambda: searched(model_cpu, batch, *args)))
        if len(differ) > MAX_DIFFERING:
            raise AssertionError(f'/optimize {policy}: {len(differ)} strings '
                                 f'differ from the JAX reference')
        st, near = a['search'], set(g['near'])
        stops = [i for i in range(N_MOLS) if i not in near and (
            (i in st['by_delta']) != (i in g['by_delta']) or
            (i in st['by_patience']) != (i in g['by_patience']))]
        if stops or (not near and st['iterations'] != g['iterations']):
            raise AssertionError(
                f'/optimize {policy}: iterations {st["iterations"]} vs '
                f'{g["iterations"]}, stop reasons differ at {stops}')
        t = a['turbo']
        expected = 2 + sum(t['steps_run']) + t['eager_steps']
        launches = a['launches']
        lost = check_ran(f'/optimize {policy}', launches, a['ran'],
                         a['device'])
        if not (launches['nei_sum'] == expected and
                launches['gather_rows'] == depth and
                launches['transpose_sum'] == 0):
            raise AssertionError(
                f'/optimize {policy}: launches {launches}; expected nei_sum '
                f'{expected}, gather_rows {depth}')
        canon = [canon_smiles(s) for s in (r[0] for r in rows)]
        summary[policy] = dict(
            prediction_err_vs_jax=err,
            differ_from_jax=differ,
            changed_from_input=sum(s != c for s, c in zip(ans['smiles'],
                                                          canon)),
            validity=sum(s is not None for s in ans['smiles']) / N_MOLS,
            iterations=st['iterations'], by_delta=len(st['by_delta']),
            by_patience=len(st['by_patience']), near=sorted(near),
            nei_sum_launches=launches['nei_sum'],
            nei_sum_ran=a['ran']['nei_sum'],
            nei_sum_device_launches=a['device']['nei_sum'],
            profiler_lost=lost, expected=expected, launches=launches,
            **{k: t[k] for k in ('rounds', 'fallbacks', 'steps_run',
                                 'eager_steps')})
        print(f'optimize {policy} ' + json.dumps(summary[policy]),
              flush=True)
    return summary


def hier_requests(port, rows, golden):
    """The hier family's requests, each under the profiler with the counts
    read just before and just after it: ``/encode`` of ``rows`` (64),
    ``/reconstruct`` of the golden's 16 and ``/sample`` of its request.
    Returns per request the answer, seconds, the wrappers' launches, the
    device events' launches of each kernel and of them those made by CUDA
    graph replays, each call site's launches (``kernel_bench.hier_sites``
    with the propose step's sites; None: launches no site made;
    ``replay``: the launches the wrappers added for graph replays),
    ``decode.TURBO_STATS`` of its turbo decode and ``decode.HIER_STATS`` of
    its exact fallback."""
    out = {}
    for name, path, payload in (
            ('encode', '/encode', {'smiles': [r[0] for r in rows]}),
            ('reconstruct', '/reconstruct', {'smiles': golden['inputs']}),
            ('sample', '/sample', golden['sample_request'])):
        decode.HIER_STATS.clear()
        decode.TURBO_STATS.clear()
        before = read_counts()
        answer, ran = [], {}

        def run():
            t0 = time.perf_counter()
            answer.append(request(port, path, payload))
            torch.cuda.synchronize()
            answer.append(time.perf_counter() - t0)
        with kernel_bench.hier_sites() as sites:
            _, events = profiled(run, ran=ran)
        out[name] = dict(answer=answer[0], seconds=answer[1],
                         launches={k: v - before[k]
                                   for k, v in read_counts().items()},
                         ran=ran, device_launches=by_kernel(events),
                         graph_device_launches=by_kernel(events,
                                                         'graph_count'),
                         site_launches={site: c['launches']
                                        for site, c in sites.items()},
                         stats=dict(decode.HIER_STATS),
                         turbo=dict(decode.TURBO_STATS))
    return out


def hier_phase(floor):
    """Phase 10: the hier family's serve path on the card (docstring).
    Returns the phase's summary, the counts of its requests, the kernel
    rows at its call sites and each site's launches in the requests."""
    with open(HIER_GOLDEN) as f:
        golden = json.load(f)
    hmodel, hvocab = load_model(HIER_CKPT, HIER_VOCAB, device='cuda')
    hmodel_cpu, _ = load_model(HIER_CKPT, HIER_VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data(DATA), hvocab,
                          verbose=False)[:N_MOLS]
    if [r[0] for r in rows[:len(golden['inputs'])]] != golden['inputs']:
        raise AssertionError('the hier golden is not for these molecules')
    site_rows = {}
    for row in checked(kernel_bench.measure(
            kernel_bench.hier_cases(hmodel, hvocab, rows), floor)):
        site_rows.setdefault(row['kernel'], {})[row['case']] = row
    server = GgpmServer(hmodel, hvocab, max_decode_step=MAX_DECODE_STEP,
                        device='cuda')
    port = server.start(port=0).server_address[1]
    try:
        reset_counts()
        answers = hier_requests(port, rows, golden)
        counts = read_counts()
    finally:
        server.stop()

    # the answers: latents against the CPU port's, strings against the
    # golden by the decode rule
    batch = to_model_batch(tensorize(rows, hvocab, common_atom_vocab),
                           hvocab.mask, pad=False)
    z = np.asarray(answers['encode']['answer']['latents'], np.float32)
    z_cpu = encode(hmodel_cpu, batch)[0].numpy()
    lat_err = float(np.abs(z - z_cpu).max())
    if z.shape != (N_MOLS, hmodel.cfg.latent_size) or \
            not lat_err <= LATENT_ATOL:
        raise AssertionError(f'hier /encode: latents {z.shape}, max abs err '
                             f'{lat_err} against the CPU port')
    n16 = len(golden['inputs'])
    b16 = to_model_batch(tensorize(rows[:n16], hvocab, common_atom_vocab),
                         hvocab.mask, pad=False)
    z_prior = np.random.default_rng(golden['sample_request']['seed']) \
        .standard_normal((golden['sample_request']['n'], z.shape[1])) \
        .astype(np.float32)
    differ = {}
    for name, z_c, z_p in (
            ('reconstruct', lambda: encode(hmodel, b16)[0],
             lambda: encode(hmodel_cpu, b16)[0]),
            ('sample', lambda: z_prior, lambda: z_prior)):
        differ[name] = check_decode(
            f'hier {name}', answers[name]['answer']['smiles'], golden[name],
            logs_of(hmodel, hvocab, z_c), logs_of(hmodel_cpu, hvocab, z_p))
        if len(differ[name]) > MAX_DIFFERING:
            raise AssertionError(f'hier /{name}: {len(differ[name])} strings '
                                 f'differ from the JAX reference')

    # the launches: an encode's 5 readouts and its depth loops' rounds, a
    # propose step's 4 frontier sums (eager before a capture, then graph
    # replays), an exact step's 5; by the wrappers, the kernels' own device
    # counts and each call site (the wrappers' launches counted where the
    # site calls; the replays' launches under ``replay``, held to the
    # profiler's records of graph replays, ``graph_records_held``)
    cfg = hmodel.cfg
    encodes = {'encode': 1, 'reconstruct': 1, 'sample': 0}
    launches = {}
    sites = {f'hier-{site}': 0 for site in kernel_bench.HIER_SITE_NAMES +
             kernel_bench.HIER_PROPOSE_NAMES + ('replay',)}
    for name, a in answers.items():
        ts = a['turbo'] or dict(steps_run=[], eager_steps=0, exact_steps=0)
        n = encodes[name]
        expected_sites = {
            **{site: n for site, _ in kernel_bench.HIER_ENCODE_SITES},
            **{site: ts['exact_steps']
               for site, _ in kernel_bench.HIER_STEP_SITES},
            **{site: ts['eager_steps']
               for site in kernel_bench.HIER_PROPOSE_NAMES},
            'atom-gather': cfg.depthG * n, 'tree-gather': 2 * cfg.depthT * n,
            None: 0, 'replay': 4 * sum(ts['steps_run'])}
        expected = {'nei_sum': 5 * n + profile_serve.hier_turbo_launches(ts),
                    'gather_rows': (cfg.depthG + 2 * cfg.depthT) * n,
                    'transpose_sum': 0}
        by_site = a['site_launches']
        graph = a['graph_device_launches']
        lost = check_ran(f'hier /{name}', a['launches'], a['ran'],
                         a['device_launches'])
        launches[name] = dict(wrappers=a['launches'], ran=a['ran'],
                              device=a['device_launches'],
                              graph_device=graph, profiler_lost=lost,
                              expected=expected,
                              steps_run=sum(ts['steps_run']),
                              eager_steps=ts['eager_steps'],
                              exact_steps=ts['exact_steps'],
                              fallbacks=ts.get('fallbacks', 0),
                              rounds=ts.get('rounds', 0),
                              sites={str(k): v for k, v in by_site.items()},
                              seconds=a['seconds'])
        print(f'hier launches {name} ' + json.dumps(launches[name]),
              flush=True)
        if a['launches'] != expected:
            raise AssertionError(f'hier /{name}: launches {a["launches"]}, '
                                 f'expected {expected}')
        if by_site != expected_sites or not graph_records_held(graph, dict(
                nei_sum=by_site['replay'], transpose_sum=0, gather_rows=0),
                lost):
            raise AssertionError(f'hier /{name}: launches by call site '
                                 f'{by_site}, expected {expected_sites}; '
                                 f'by graph replays {graph}')
        for site, v in by_site.items():
            if site is not None:
                sites[f'hier-{site}'] += v
    for kernel in ('nei_sum', 'gather_rows'):
        at_sites = sum(v for k, v in sites.items() if (
            'nei_sum' if k == 'hier-replay' else
            kernel_bench.HIER_SITE_CALLS[k[5:]][0]) == kernel)
        if at_sites != counts[kernel]:
            raise AssertionError(f'hier: {kernel} launches at the sites '
                                 f'{at_sites}, by the wrapper '
                                 f'{counts[kernel]}')
    prof = profile_serve.hier_profiles(hmodel, hvocab, rows)
    prof['decode'].pop('smiles')
    print('hier encode ' + json.dumps(prof['encode']), flush=True)
    print(f'hier decode B{N_MOLS} ' + json.dumps(prof['decode']), flush=True)
    check_exact_launches(f'hier decode B{N_MOLS}', prof['decode'])
    canon = [canon_smiles(s) for s in golden['inputs']]
    rec = answers['reconstruct']['answer']['smiles']
    summary = dict(
        latent_err_vs_cpu=lat_err, differ_from_jax=differ,
        validity={n: sum(s is not None for s in answers[n]['answer'][
            'smiles']) / len(answers[n]['answer']['smiles'])
            for n in ('reconstruct', 'sample')},
        exact_reconstruction=sum(a == b for a, b in zip(rec, canon)) /
        len(rec), launches=launches, site_launches=sites)
    print('hier ' + json.dumps(summary), flush=True)
    return summary, counts, site_rows, sites


def check_exact_launches(what: str, prof: dict) -> None:
    """An exact hier decode's profile (``profile_decode``'s ``hier``
    path): ``nei_sum`` launched 5 times a step, by the wrapper in the
    timed and in the profiled run and by the kernel's own device count in
    the profiled run; the profiler's records of it fall short of those
    (records lost, ``profiler_lost``) or equal them, and none is from a
    graph replay."""
    want = 5 * prof['steps']
    if not (prof['nei_sum_launches'] == prof['nei_sum_ran'] ==
            prof['profiled_nei_sum_launches'] == want) or \
            prof['nei_sum_device_launches'] > want or \
            any(v < 0 for v in prof['profiler_lost'].values()) or \
            prof['nei_sum_graph_device_launches']:
        raise AssertionError(
            f'{what}: nei_sum launches {prof["nei_sum_launches"]}, that ran '
            f'{prof["nei_sum_ran"]}, device events '
            f'{prof["nei_sum_device_launches"]} (by graph replays '
            f'{prof["nei_sum_graph_device_launches"]}), profiled '
            f'{prof["profiled_nei_sum_launches"]}, expected {want}')


def turbo_round(model, vocab, z):
    """One propose round of the hier turbo decode over latents ``z`` at the
    full rung: on the card replayed from the captured graph with the
    lookahead, as ``decode_hier_turbo`` runs it; on the CPU eagerly.
    Returns the round's outputs as numpy (packed, root motifs, root
    attachments, steps active, poisoned) and the steps run."""
    tabs, mask = decode._device_vocab(vocab, common_atom_vocab, z.device)
    with torch.inference_mode():
        prop = decode._proposer(
            decode.HierProposer, model, vocab, mask, tabs, 5,
            MAX_DECODE_STEP, len(z),
            budgets=decode.hier_budgets(vocab, common_atom_vocab))
        return decode.propose_round(prop, z)


def trace_divergence(card, cpu, beam=5):
    """Per sample, where the card's propose trace parts from the CPU
    port's: the first step whose integer columns differ or whose floats
    differ by more than ``TRACE_ATOL``, what differs there, and the CPU's
    margin at that step (|p − 0.5| of the topology probability, or the
    least gap between consecutive beam scores); infinite where the trace
    holds no margin (the roots, or the assembly candidate alone, whose
    scores the trace does not carry).  ``{}`` if every trace agrees."""
    (pc, rc_c, ri_c, _, pois_c), (pp, rc_p, ri_p, _, pois_p) = card, cpu
    cols = pc.shape[2]
    floats = [0] + list(range(2, 2 + beam))
    ints = [c for c in range(cols) if c not in floats]
    out = {}
    for b in range(pc.shape[1]):
        if (rc_c[b], ri_c[b]) != (rc_p[b], ri_p[b]):
            out[b] = (0, 'root', float('inf'))
            continue
        bad_i = (pc[:, b, ints] != pp[:, b, ints]).any(axis=1)
        bad_f = (np.abs(pc[:, b, floats] - pp[:, b, floats]) >
                 TRACE_ATOL).any(axis=1)
        steps = np.flatnonzero(bad_i | bad_f)
        if not len(steps):
            if pois_c[b] != pois_p[b]:
                out[b] = (None, 'poisoned', float('inf'))
            continue
        t = int(steps[0])
        row = pp[t, b]
        p_topo = 1.0 / (1.0 + np.exp(-float(row[0])))
        gaps = -np.diff(row[2:2 + beam])
        if pc[t, b, 1] != row[1]:
            out[b] = (t, 'choice', abs(p_topo - 0.5))
        elif (pc[t, b, 2:2 + 3 * beam] != row[2:2 + 3 * beam]).any():
            out[b] = (t, 'top-k', float(gaps.min()))
        else:
            out[b] = (t, 'assembly', float('inf'))
    return out


def hier_turbo_phase(floor):
    """Phase 12: the hier turbo decode on the card (docstring).  Returns
    the phase's summary, the launches of its decodes, the kernel rows at
    the propose sites and each propose site's launches in its decodes."""
    with open(HIER_GOLDEN) as f:
        golden = json.load(f)
    hmodel, hvocab = load_model(HIER_CKPT, HIER_VOCAB, device='cuda')
    hmodel_cpu, _ = load_model(HIER_CKPT, HIER_VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data(DATA), hvocab,
                          verbose=False)[:N_MOLS]
    n16 = len(golden['inputs'])
    summary, counts = {}, {k: 0 for k in WRAPPERS}

    # 1. traces: the 16 golden molecules' latents through the propose loop
    # on the card and on the CPU port, then their decode against the golden
    b16 = to_model_batch(tensorize(rows[:n16], hvocab, common_atom_vocab),
                         hvocab.mask, pad=False)
    z16 = encode(hmodel, b16)[0]
    card, _ = turbo_round(hmodel, hvocab, z16)
    cpu, _ = turbo_round(hmodel_cpu, hvocab, z16.cpu())
    div = trace_divergence(card, cpu)
    near = {b: d for b, d in div.items() if d[2] < NEAR_TIE}
    trace = dict(samples=n16, steps_active=[card[3], cpu[3]],
                 poisoned=[int(card[4].sum()), int(cpu[4].sum())],
                 differ={str(b): d for b, d in div.items()},
                 max_float_diff_where_equal=float(max(
                     (np.abs(card[0][:, b] - cpu[0][:, b]).max()
                      for b in range(n16) if b not in div), default=0.0)))
    print('hier turbo traces ' + json.dumps(trace), flush=True)
    if len(div) > MAX_DIFFERING or len(near) != len(div):
        raise AssertionError(f'hier turbo: traces of {sorted(div)} differ '
                             f'from the CPU port\'s, near-ties only at '
                             f'{sorted(near)}')
    reset_counts()
    _, smiles = decode_best(hmodel, hvocab, common_atom_vocab, z16,
                            max_decode_step=MAX_DECODE_STEP)
    card_stats = dict(decode.TURBO_STATS)
    got = read_counts()
    with torch.inference_mode():
        decode_best(hmodel_cpu, hvocab, common_atom_vocab, z16.cpu(),
                    max_decode_step=MAX_DECODE_STEP)
    cpu_stats = dict(decode.TURBO_STATS)
    differ = check_decode(
        'hier turbo golden', smiles, golden['reconstruct'],
        logs_of(hmodel, hvocab, lambda: z16),
        logs_of(hmodel_cpu, hvocab, lambda: encode(hmodel_cpu, b16)[0]))
    expected = profile_serve.hier_turbo_launches(card_stats)
    summary['golden'] = dict(
        trace=trace, differ_from_jax=differ,
        fallbacks=[card_stats['fallbacks'], cpu_stats['fallbacks']],
        rounds=card_stats['rounds'], nei_sum_launches=got['nei_sum'],
        expected_nei_sum_launches=expected)
    print('hier turbo golden ' + json.dumps(summary['golden']), flush=True)
    if len(differ) > MAX_DIFFERING or \
            card_stats['fallbacks'] != cpu_stats['fallbacks'] or \
            got['nei_sum'] != expected:
        raise AssertionError(f'hier turbo golden: {summary["golden"]}')
    for k in counts:
        counts[k] += got[k]

    # 2. the requests: decode_best of the 64 molecules' latents and of 120
    # prior draws.  First one decode under the profiler, with each call
    # site counted: eager launches at the propose sites (each capture's
    # step) and at the exact step's sites (the fallbacks' decode), and the
    # graph replays' launches by the wrappers and by the device events;
    # then turbo and exact profiled (profile_decode)
    with open(HIER_TURBO_GOLDEN) as f:
        prior_golden = json.load(f)
    b64 = to_model_batch(tensorize(rows, hvocab, common_atom_vocab),
                         hvocab.mask, pad=False)
    z120 = torch.as_tensor(np.random.default_rng(
        prior_golden['seed']).standard_normal(
        (prior_golden['n'], hmodel.cfg.latent_size)).astype(np.float32),
        device='cuda')
    latents = [encode(hmodel, b64)[0], z120]
    site_launches, replays = {}, {}
    for z in latents:
        B = len(z)
        reset_counts()
        out, ran = [], {}
        with kernel_bench.hier_sites() as at:
            _, events = profiled(lambda: out.append(decode_best(
                hmodel, hvocab, common_atom_vocab, z,
                max_decode_step=MAX_DECODE_STEP)), ran=ran)
        stats = dict(decode.TURBO_STATS)
        got = read_counts()
        smiles = out[0][1]
        device = by_kernel(events)
        graph = by_kernel(events, 'graph_count')['nei_sum']
        lost = check_ran(f'hier turbo B{B}', got, ran, device)
        by_site = {str(k): v['launches'] for k, v in at.items()}
        expected_sites = {
            **{str(k): 0 for k in at},
            **{site: stats['eager_steps']
               for site in kernel_bench.HIER_PROPOSE_NAMES},
            **{site: stats['exact_steps']
               for site, _ in kernel_bench.HIER_STEP_SITES},
            'replay': 4 * sum(stats['steps_run'])}
        decoded = dict(
            nei_sum_launches=got['nei_sum'], nei_sum_ran=ran['nei_sum'],
            device_launches=device['nei_sum'], graph_device_launches=graph,
            profiler_lost=lost,
            expected=profile_serve.hier_turbo_launches(stats),
            sites=by_site, steps_run=sum(stats['steps_run']),
            eager_steps=stats['eager_steps'],
            exact_steps=stats['exact_steps'],
            fallbacks=stats['fallbacks'],
            fallback_causes=stats['fallback_causes'])
        print(f'hier turbo decode B{B} ' + json.dumps(decoded), flush=True)
        if not (got['nei_sum'] == decoded['expected'] == sum(
                by_site.values())) or by_site != expected_sites or \
                not graph_records_held({'nei_sum': graph},
                                       {'nei_sum': by_site['replay']}, lost):
            raise AssertionError(f'hier turbo B{B}: launches {decoded}, '
                                 f'by site expected {expected_sites}')
        for k in counts:
            counts[k] += got[k]
        site_launches.update({f'hier-turbo-{site}-B{B}': by_site[site]
                              for site in kernel_bench.HIER_PROPOSE_NAMES})
        replays[f'B{B}'] = dict(launches=graph, steps_run=decoded[
            'steps_run'], profiler_lost=lost, exact_step_launches={
                site: by_site[site]
                for site, _ in kernel_bench.HIER_STEP_SITES})

        turbo = profile_decode(hmodel, hvocab, z, 'hier-turbo',
                               max_decode_step=MAX_DECODE_STEP)
        exact = profile_decode(hmodel, hvocab, z, 'hier',
                               max_decode_step=MAX_DECODE_STEP)
        t_smiles, e_smiles = turbo.pop('smiles'), exact.pop('smiles')
        differ = [i for i, (a, b) in enumerate(zip(t_smiles, e_smiles))
                  if a != b]
        row = dict(turbo=turbo, exact=exact, turbo_vs_exact_differ=differ)
        if z is z120:
            # the prior draws against the JAX package's turbo decode of
            # them (its CPU ladder: one sample outlives rung 64)
            row['vs_jax'] = dict(
                differ=[i for i, (a, b) in enumerate(
                    zip(smiles, prior_golden['smiles'])) if a != b],
                fallback_causes=[sorted(stats['fallback_causes']),
                                 prior_golden['fallback_causes']])
        print(f'hier turbo B{B} ' + json.dumps(row), flush=True)
        summary[f'B{B}'] = dict(
            wall_s=[turbo['wall_s'], exact['wall_s']],
            rounds=turbo['rounds'], rungs=turbo['rungs'],
            fallbacks=turbo['fallbacks'],
            fallback_causes=stats['fallback_causes'],
            propose_ms_per_step=turbo['round']['device_ms_per_step'],
            launches_per_step=turbo['round']['device_launches_per_step'],
            replay_s=sum(turbo['replay_s']),
            chemistry_s=turbo['chemistry_s'],
            idle_share=[turbo['device_idle_share'],
                        exact['device_idle_share']],
            differ=differ)
        check_exact_launches(f'hier turbo B{B} exact', exact)
        # (the profiled round's launches a step are printed, not held: the
        # profiler loses records in some replay windows, PERF.md section 7)
        if not (turbo['nei_sum_launches'] ==
                turbo['expected_nei_sum_launches'] ==
                turbo['nei_sum_ran'] ==
                turbo['profiled_nei_sum_launches']) or \
                turbo['nei_sum_device_launches'] > turbo['nei_sum_ran'] or \
                any(v < 0 for v in turbo['profiler_lost'].values()) or \
                not graph_records_held(
                    {'nei_sum': turbo['nei_sum_graph_device_launches']},
                    {'nei_sum': 4 * sum(turbo['steps_run'])},
                    turbo['profiler_lost']) or \
                len(differ) > MAX_DIFFERING or t_smiles != smiles or \
                'vs_jax' in row and (
                    len(row['vs_jax']['differ']) > MAX_DIFFERING or
                    row['vs_jax']['fallback_causes'][0] !=
                    row['vs_jax']['fallback_causes'][1]):
            raise AssertionError(f'hier turbo B{B}: {row}')

    # 3. the kernel at the four propose sums, B = 64 and B = 120
    turbo_rows = {}
    for row in checked(kernel_bench.measure(
            kernel_bench.hier_turbo_cases(hmodel, hvocab, latents), floor)):
        turbo_rows.setdefault(row['kernel'], {})[row['case']] = row
    print('hier turbo ' + json.dumps(summary), flush=True)
    return summary, counts, turbo_rows, site_launches, replays


def shard_epochs(tmp, vocab_path, shards):
    """One epoch of the ``vae_train`` CLI on the card from ``shards``, and
    one from a CSV of the same batches in the order the shards gave them,
    both from the checkpoint's ``vae/`` (``saved_model``), each recorded
    (``profile_train.recorded_epochs``); the counts are reset just before
    the shards' run and read just after it.  Every step's metrics must be
    equal bit for bit.  Returns the two records and the shards' counts."""
    def run(name, extra):
        cfg = os.path.join(tmp, f'{name}.json')
        with open(cfg, 'w') as f:
            json.dump(dict(vocab_=vocab_path, saved_model=CKPT, data=shards,
                           save_dir=os.path.join(tmp, f'train_{name}'),
                           batch_size=20,
                           epoch=1, print_iter=10 ** 9, seed=1), f)
        with profile_train.recorded_epochs() as rec:
            vae_train.main(['--path-to-config', cfg, '--model-type', 'prop',
                            '--device', 'cuda'] + extra)
        return rec

    reset_counts()
    by_shards = run('shards', [])
    counts = read_counts()
    csv_path = os.path.join(tmp, 'shard_order.csv')
    write_csv(csv_path, [dict(SMILES=s, HOMO=float(h), LUMO=float(l))
                         for mb in by_shards['batches']
                         for s, h, l in zip(mb.smiles, mb.homos, mb.lumos)])
    by_csv = run('csv', ['--data-csv', csv_path])
    a, b = by_shards['steps'], by_csv['steps']
    differ = [f'step {i} {k}' for i, (x, y) in enumerate(zip(a, b))
              for k in x if not torch.equal(bits(x[k]), bits(y[k]))]
    if differ or len(a) != len(b) or not a:
        raise AssertionError(f'shard epoch: {len(a)} steps against the CSV '
                             f'path\'s {len(b)}; differing {differ[:20]}')
    return by_shards, by_csv, counts


def decoded_rows(model_cpu, vocab, res, kind, i):
    """The latents behind the quality twin's string ``res[kind][i]``: the
    rows the run decoded (the reconstruction's, or each in-vocab rooting's
    of the enum-root molecule) beside the CPU port's encode of the same
    padded batches, or the prior draw on both sides; with the decode's
    step limit.  Returns (card rows, CPU rows, steps)."""
    if kind == 'sampled':
        z = torch.as_tensor(np.random.default_rng(7).standard_normal(
            (len(res['sampled']), model_cpu.cfg.latent_size)).astype(
            np.float32)[i:i + 1])
        return z, z, 120
    dec = res['decoded'][kind]
    if kind == 'recon':
        size, rows = dec['batch_size'], [i]
    else:
        size = 64
        rows = [r for r, s in enumerate(dec['src']) if s == i]
        if not rows:
            raise AssertionError(f'quality enum_root[{i}]: no rooting of '
                                 f'the molecule was decoded')
    cpu = {}
    for k in {r // size for r in rows}:
        cpu[k] = encode(model_cpu, to_model_batch(dec['batches'][k],
                                                  vocab.mask, pad=False))[0]
    return (dec['z'][rows], torch.stack([cpu[r // size][r % size]
                                         for r in rows]), MAX_DECODE_STEP)


def quality_near_ties(model, model_cpu, vocab, res, golden, differing):
    """Each string of the quality twin that differs from the golden, with
    the first divergence of the card's and the CPU port's per-step logs of
    the rows behind it (``decoded_rows``), printed; raises unless each is
    an fp32 near-tie (phase 6's rule) and at most ``MAX_DIFFERING`` differ
    in all."""
    n = sum(len(v) for v in differing.values())
    if n > MAX_DIFFERING:
        raise AssertionError(f'quality twin: {n} strings differ from the '
                             f'JAX golden: {differing}')
    for kind, idx in differing.items():
        for i in idx:
            card, cpu, steps = decoded_rows(model_cpu, vocab, res, kind, i)
            logs = [decode_best(m, vocab, common_atom_vocab,
                                z.to(next(m.parameters()).device),
                                max_decode_step=steps, log_steps=True)[0]
                    for m, z in ((model, card), (model_cpu, cpu))]
            divs = [first_divergence(a, c) for a, c in zip(*logs)]
            div = next((d for d in divs if d is not None), None)
            print(f'quality {kind} differs at {i}: {res[kind][i]} vs '
                  f'{golden[kind][i]}; first divergence (step, what, CPU '
                  f'margin) {div}', flush=True)
            if div is None or not div[2] < NEAR_TIE:
                raise AssertionError(f'quality {kind}[{i}] differs from the '
                                     f'JAX golden beyond an fp32 near-tie')


def a6_phase(model, model_cpu):
    """Phase 15: the data CLIs, training from shards, the quality twin and
    ChemNet on the card (module docstring).  Returns the phase's summary
    and the launches of its paths: the shard epoch's and the quality
    run's."""
    smi = nvidia_smi()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        vocab_path = os.path.join(tmp, 'vocab.txt')
        get_vocab.main(['--data', DATA, '--min_frequency', '10',
                        '--output', vocab_path, '--ncpu', str(A6_NCPU)])
        with open(vocab_path, 'rb') as f, open(VOCAB, 'rb') as g:
            if f.read() != g.read():
                raise AssertionError('get_vocab did not write '
                                     'runs/QUALITY_hopv.json.vocab.txt')
        out['get_vocab_s'] = time.perf_counter() - t0

        t0 = time.perf_counter()
        vocab = load_vocab_file(vocab_path)
        rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)
        rows_csv = os.path.join(tmp, 'hopv_in_vocab.csv')
        write_csv(rows_csv, [dict(SMILES=s, HOMO=h, LUMO=l)
                             for s, h, l in rows])
        shards = os.path.join(tmp, 'shards')
        preprocess.main(['--train', rows_csv, '--vocab', vocab_path,
                         '--out-dir', shards, '--batch_size', '20',
                         '--seed', '1', '--ncpu', str(A6_NCPU)])
        out['preprocess_s'] = time.perf_counter() - t0

        t0 = time.perf_counter()
        by_shards, by_csv, train_counts = shard_epochs(tmp, vocab_path,
                                                       shards)
        trainer = by_shards['trainers'][0]
        n_mols = sum(len(mb.smiles) for mb in by_shards['batches'])
        groups = profile_train.flush_groups(trainer, by_shards['batches'])
        windows = profile_train.replay_windows(trainer, groups)
        bad, lost = profile_train.check_replay_windows(windows,
                                                       STEP_LAUNCHES)
        out['shard_epoch'] = dict(
            steps=len(by_shards['steps']), mols=n_mols,
            shard_epoch_s=by_shards['seconds'][0],
            shard_mols_per_s=n_mols / by_shards['seconds'][0],
            csv_epoch_s=by_csv['seconds'][0],
            csv_mols_per_s=n_mols / by_csv['seconds'][0],
            **trainer.graph_stats(), launches=train_counts,
            replayed_steps=len(windows),
            launches_per_replayed_step=windows[0]['launches'],
            ran_per_replayed_step=windows[0]['ran'],
            device_launches_per_replayed_step=max(
                windows, key=lambda w: w['records'])['device'],
            windows_with_lost_records=lost,
            replayed_step_wall_ms=[w['wall_ms'] for w in windows],
            replayed_step_device_ms=[w['device_busy_ms'] for w in windows])
        print('a6 shard epoch ' + json.dumps(out['shard_epoch']), flush=True)
        if bad:
            raise AssertionError(f'shard epoch: replayed steps (step, count, '
                                 f'launches) {bad}, expected {STEP_LAUNCHES}')
        if min(train_counts.values()) == 0:
            raise AssertionError(f'a kernel never launched in the shard '
                                 f'epoch: {train_counts}')
        out['train_s'] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with open(QUALITY_GOLDEN) as f:
            golden = json.load(f)
        reset_counts()
        res = quality_run.main(QUALITY_FLAGS + [
            '--out', os.path.join(tmp, 'q.json'), '--device', 'cuda'])
        quality_counts = read_counts()
        out['quality_run_s'] = time.perf_counter() - t0
        out['enum_root'] = dict(api.ENUM_ROOT_STATS)
        check = quality_run.compare(res, golden)
        qual = res['qual']
        out['quality'] = dict(
            differing=check['differing'], bad=check['bad'],
            launches=quality_counts, platform=qual['platform'],
            device_name=qual.get('device_name'),
            **{k: qual.get(k) for k in (
                'validity', 'recon_accuracy', 'recon_accuracy_enum_root',
                'HOMO_MAE', 'LUMO_MAE', 'enum_root_seconds',
                'decode_seconds', 'wall_seconds')},
            train_metrics=res['train_metrics'])
        print('a6 quality ' + json.dumps(out['quality'], default=float),
              flush=True)
        if check['bad']:
            raise AssertionError(f'quality twin against the JAX golden: '
                                 f'{check["bad"]}')
        quality_near_ties(model, model_cpu, vocab, res, golden,
                          check['differing'])
        if quality_counts['nei_sum'] == 0 or \
                quality_counts['gather_rows'] == 0:
            raise AssertionError(f'the quality run launched '
                                 f'{quality_counts}')

        t0 = time.perf_counter()
        ckpt = chemnet.random_checkpoint(os.path.join(tmp, 'chemnet.npz'))
        originals = [o for o, _ in res['recon']]
        net = chemnet.ChemNet.load(ckpt, 'cuda')
        net.activations(originals)                     # warm-up
        t1 = time.perf_counter()
        acts = net.activations(originals)              # ends on the host
        chem_s = time.perf_counter() - t1
        cpu = chemnet.ChemNet.load(ckpt, 'cpu').activations(originals)
        err = float(np.abs(acts - cpu).max())
        fcd = chemnet.compute_fcd([d for _, d in res['recon']], originals,
                                  ckpt, device='cuda')
        out['chemnet'] = dict(molecules=len(originals),
                              activations_s=chem_s,
                              ms_per_molecule=1e3 * chem_s / len(originals),
                              max_abs_err=err, fcd_recon=fcd)
        print('a6 chemnet ' + json.dumps(out['chemnet']), flush=True)
        if not err <= CHEMNET_ATOL:
            raise AssertionError(f'ChemNet on the card against the CPU '
                                 f'port: max abs err {err}')
        out['chemnet_s'] = time.perf_counter() - t0
    out['launches_per_replayed_step'] = out['shard_epoch'][
        'launches_per_replayed_step']
    print('a6 times ' + json.dumps(dict(
        nvidia_smi=smi, enum_root=out['enum_root'],
        shard_mols_per_s=out['shard_epoch']['shard_mols_per_s'],
        chemnet_ms_per_molecule=out['chemnet']['ms_per_molecule'],
        **{k: v for k, v in out.items() if k.endswith('_s')})), flush=True)
    counts = {k: train_counts[k] + quality_counts[k] for k in train_counts}
    return out, counts


# phase 16: the steps whose leaf updates the DP golden holds (docstring; the
# metrics and GNorm at all three), and the rows of each split leaf and of
# its two moments that each rank of the dp×tp grid holds (380 / 2)
DP_UPDATE_STEPS = 1
A7_SHARDS = {'E_i.weight': [190] * 3,
             'decoder.iclsNN.Dense_1.weight': [190] * 3}


def a7_phase(vocab, batches):
    """Phase 16: data-parallel and dp×tp training, the ChemBERTa baseline
    and a trace (module docstring).  Returns the phase's summary and the
    launches of its paths, the ranks' included."""
    smi = nvidia_smi()
    out = {}
    t0 = time.perf_counter()
    rdv = tempfile.mkdtemp()
    init_distributed(f'file://{rdv}/rendezvous', 1, 0, device='cuda')
    try:
        # (a) NCCL at world size 1: the DP Trainer's graph epoch against
        # the one-card Trainer's, bit for bit
        dp_tr, _ = profile_train.canonical_trainer(
            'cuda', vocab, mesh=pmesh.make_mesh(1))
        one_tr, _ = profile_train.canonical_trainer('cuda', vocab)
        reset_counts()
        reduces = pmesh.all_reduce.calls
        t1 = time.perf_counter()
        if dp_tr.train_epoch(batches, log=lambda *_: None):
            raise AssertionError('the DP epoch stopped early')
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t1
        dp_counts = read_counts()
        epoch_reduces = pmesh.all_reduce.calls - reduces
        one_tr.train_epoch(batches, log=lambda *_: None)
        dp_st, one_st = opt_states(dp_tr), opt_states(one_tr)
        differ = [k for k in one_st
                  if not torch.equal(bits(dp_st[k]), bits(one_st[k]))]
        groups = profile_train.flush_groups(dp_tr, batches)
        reduces = pmesh.all_reduce.calls
        windows = profile_train.replay_windows(dp_tr, groups)
        window_reduces = pmesh.all_reduce.calls - reduces
        bad, lost = profile_train.check_replay_windows(windows,
                                                       STEP_LAUNCHES)
        replay_counts = {k: sum(w['launches'][k] for w in windows)
                         for k in STEP_LAUNCHES}
        out['nccl'] = dict(
            steps=dp_tr.total_step - len(windows), epoch_s=epoch_s,
            epoch_mols_per_s=profile_train.BATCH_SIZE * len(batches) /
            epoch_s, all_reduces=epoch_reduces, differing_states=differ,
            **dp_tr.graph_stats(), replayed_steps=len(windows),
            all_reduces_per_replayed_step=window_reduces / len(windows),
            launches_per_replayed_step=windows[0]['launches'],
            ran_per_replayed_step=windows[0]['ran'],
            windows_with_lost_records=lost,
            replayed_step_wall_ms=[w['wall_ms'] for w in windows],
            replayed_step_device_ms=[w['device_busy_ms'] for w in windows])
        print('a7 dp nccl ' + json.dumps(out['nccl']), flush=True)
        if differ:
            raise AssertionError(f'the DP epoch differs from the one-card '
                                 f'epoch in {differ}')
        if epoch_reduces != len(batches) or window_reduces != len(windows):
            raise AssertionError(f'{epoch_reduces} all-reduces in an epoch '
                                 f'of {len(batches)} steps, '
                                 f'{window_reduces} in {len(windows)} '
                                 f'replayed steps')
        if bad or dp_tr.graph_stats()['signatures'] == 0:
            raise AssertionError(f'DP replayed steps (step, count, '
                                 f'launches) {bad}, expected {STEP_LAUNCHES}')

        # (e) a trace of one replayed DP step
        with profiling.trace(os.path.join(rdv, 'trace')) as prof:
            with profiling.named_scope('dp_step'):
                dp_tr.scan_steps(next(g for g in groups if len(g) > 1)[:1])
            torch.cuda.synchronize()
        with open(prof.trace_path) as f:
            events = json.load(f)['traceEvents']
        out['trace'] = dict(events=len(events),
                            bytes=os.path.getsize(prof.trace_path),
                            scope=any(e.get('name') == 'dp_step'
                                      for e in events))
        print('a7 trace ' + json.dumps(out['trace']), flush=True)
        if not out['trace']['scope']:
            raise AssertionError('the trace holds no dp_step range')
    finally:
        torch.distributed.destroy_process_group()
    out['nccl_s'] = time.perf_counter() - t0

    # (b) 2 gloo ranks, (c) dp 2 × tp 2, all on the one card, against the
    # golden and against one process taking the same steps on the card
    with open(DP_GOLDEN) as f:
        golden = json.load(f)
    t0 = time.perf_counter()
    emulated, emulated_digest = profile_dp.emulated_steps('cuda')
    out['emulated'] = dict(
        digest=emulated_digest[:16], loss=[s['Loss'] for s in emulated],
        update_deviation=profile_train.update_deviation(emulated, golden),
        seconds=time.perf_counter() - t0)
    print('a7 dp emulated ' + json.dumps(out['emulated']), flush=True)
    rank_counts = {k: 0 for k in STEP_LAUNCHES}
    for name, world, tp, shards in (('dp2', 2, 1, None),
                                    ('dp2xtp2', 4, 2, A7_SHARDS)):
        t0 = time.perf_counter()
        reports = profile_dp.run_ranks(world, tp=tp, device='cuda:0',
                                       backend='gloo')
        check = profile_dp.check_ranks(reports, golden, shards,
                                       update_steps=DP_UPDATE_STEPS)
        if tp == 1 and reports[0]['digest'] != emulated_digest:
            check.append(f'the ranks\' parameters are not the one-process '
                         f'steps\' ({reports[0]["digest"][:16]} against '
                         f'{emulated_digest[:16]})')
        for r in reports:
            for k in rank_counts:
                rank_counts[k] += r['launches'][k]
        want = {k: v * len(golden['steps']) for k, v in STEP_LAUNCHES.items()}
        out[name] = dict(
            ranks=world, tp=tp, bad=check,
            digests=[r['digest'][:16] for r in reports],
            equal_to_emulated=reports[0]['digest'] == emulated_digest,
            update_deviation=profile_train.update_deviation(
                reports[0]['steps'], golden),
            all_reduces=[r['all_reduces'] for r in reports],
            all_gathers=[r['all_gathers'] for r in reports],
            launches=[r['launches'] for r in reports],
            shards=reports[0]['shards'], steps_s=[r['steps_s'] for r in
                                                  reports],
            setup_s=[r['setup_s'] for r in reports],
            loss=[s['Loss'] for s in reports[0]['steps']],
            seconds=time.perf_counter() - t0)
        print(f'a7 {name} ' + json.dumps(out[name]), flush=True)
        if check:
            raise AssertionError(f'{name}: {check}')
        if any(r['launches'] != want for r in reports):
            raise AssertionError(f'{name}: launches {out[name]["launches"]}'
                                 f', expected {want} a rank')

    # (d) ChemBERTa: the golden steps, the throughput, the CLI
    t0 = time.perf_counter()
    with open(CHEMBERTA_GOLDEN) as f:
        cgolden = json.load(f)
    steps = profile_chemberta.golden_steps('cuda')
    cbad = profile_chemberta.check_golden(steps, cgolden)
    rates = profile_chemberta.throughput('cuda')
    out['chemberta'] = dict(bad=cbad, loss=[s['loss'] for s in steps],
                            golden_loss=[s['loss'] for s in cgolden['steps']],
                            **rates)
    print('a7 chemberta ' + json.dumps(out['chemberta']), flush=True)
    if cbad:
        raise AssertionError(f'ChemBERTa against the JAX golden: {cbad}')
    rows = read_csv_data(DATA)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        for name, part in (('train.csv', rows[:300]), ('val.csv', rows[300:])):
            write_csv(os.path.join(tmp, name),
                      [dict(SMILES=s, HOMO=h, LUMO=l) for s, h, l in part])
        cfg = os.path.join(tmp, 'cfg.json')
        with open(cfg, 'w') as f:
            json.dump(dict(data=os.path.join(tmp, 'train.csv'),
                           val_data=os.path.join(tmp, 'val.csv'),
                           save_dir=os.path.join(tmp, 'out')), f)
        t1 = time.perf_counter()
        os.chdir(tmp)           # the best checkpoint goes to runs/
        try:
            model, tok = chemberta_pr2_fine_tune.main(
                ['--path-to-config', cfg, '--epochs', '2', '--device',
                 'cuda'])
        finally:
            os.chdir(cwd)
        cli_s = time.perf_counter() - t1
        fresh = chemberta.ChemBertaForPR2(vocab_size=tok.vocab_size)
        _, n = chemberta.load_pretrained_backbone(
            fresh, os.path.join(tmp, 'out'), log=lambda *_: None)
        fresh.to('cuda').eval()
        toks = torch.as_tensor(tok.encode_batch([r[0] for r in rows[300:]]),
                               device='cuda')
        with torch.no_grad():
            same = torch.equal(model.eval()(toks), fresh(toks))
    out['chemberta_cli'] = dict(epochs=2, train=300, val=len(rows) - 300,
                                seconds=cli_s, leaves_reloaded=n,
                                reload_equal=same)
    print('a7 chemberta cli ' + json.dumps(out['chemberta_cli']), flush=True)
    if not same or n != len(flatten(chemberta_to_flax(fresh))):
        raise AssertionError(f'the saved ChemBERTa reloads {n} leaves, '
                             f'predictions equal: {same}')
    out['chemberta_s'] = time.perf_counter() - t0
    print('a7 times ' + json.dumps(dict(
        nvidia_smi=smi, **{k: v for k, v in out.items()
                           if k.endswith('_s')},
        dp2_s=out['dp2']['seconds'], dp2xtp2_s=out['dp2xtp2']['seconds'],
        chemberta_steps_per_sec=rates['steps_per_sec'],
        chemberta_mols_per_sec=rates['mols_per_sec'])), flush=True)
    counts = {k: dp_counts[k] + replay_counts[k] + rank_counts[k]
              for k in dp_counts}
    return out, counts


def main() -> int:
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase('device', t0)

    t0 = time.perf_counter()
    for name, info in cuda_build.build().items():
        print(f'build {name} {info["seconds"]:.2f}s\n{info["ptxas"].strip()}',
              flush=True)
    phase('build', t0)

    t0 = time.perf_counter()
    model, vocab = load_model(CKPT, VOCAB, device='cuda')
    all_rows = prune_to_vocab(read_csv_data(DATA), vocab,
                              verbose=False)[:N_DECODE]
    if len(all_rows) != N_DECODE:
        raise AssertionError(f'{len(all_rows)} in-vocab molecules, need '
                             f'{N_DECODE}')
    rows = all_rows[:N_MOLS]
    batches = [to_model_batch(tensorize(r, vocab, common_atom_vocab),
                              vocab.mask, pad=False) for r in (rows, all_rows)]
    tree = batches[0]['tree']
    phase('load', t0)

    t0 = time.perf_counter()
    report = check_kernels(tree, [b['tree'] for b in batches])
    phase('kernel', t0)

    t0 = time.perf_counter()
    server = GgpmServer(model, vocab, max_decode_step=MAX_DECODE_STEP,
                        device='cuda')
    port = server.start(port=0).server_address[1]
    try:
        health, enc, props, counts, per_request = serve(port, rows)
        for name, k in KERNELS.items():
            if (counts[name] > 0) != ('serve' in k['paths']):
                raise AssertionError(f'kernel {name}: {counts[name]} '
                                     f'launches on the encoding path')
        # two readouts and one depth loop of ``depth`` rounds a request
        depth = model.cfg.depthT
        if not all(r['nei_sum'] == 2 and r['gather_rows'] == depth
                   for r in per_request):
            raise AssertionError(f'launches per encoding request '
                                 f'{per_request}, expected nei_sum 2 and '
                                 f'gather_rows {depth}')
        model_cpu, _ = load_model(CKPT, VOCAB, device='cpu')
        small = to_model_batch(tensorize(rows[:N_CPU_CHECK], vocab,
                                         common_atom_vocab), vocab.mask,
                               pad=False)
        check_answers(health, enc, props, rows, model_cpu, small)
        print(f'launches per encoding request {per_request}', flush=True)
        phase('serve', t0)

        t0 = time.perf_counter()
        answers, dcounts = decode_requests(port, rows)
        for name, k in KERNELS.items():
            if (dcounts[name] > 0) != ('decode' in k['paths']):
                raise AssertionError(f'kernel {name}: {dcounts[name]} '
                                     f'launches on the decoding path')
        summary = decode_phase(model, model_cpu, vocab, rows, answers, enc,
                               batches[0], depth)
        print('decode ' + json.dumps(summary), flush=True)
        decode_profiles = {}
        for batch in batches:
            z = encode(model, batch)[0]
            for path in ('turbo', 'exact'):
                prof_d = profile_decode(model, vocab, z, path,
                                        max_decode_step=MAX_DECODE_STEP)
                decode_profiles[(len(z), path)] = prof_d
                print(f'decode B{len(z)} {path} ' + json.dumps(prof_d),
                      flush=True)
        phase('decode', t0)

        t0 = time.perf_counter()
        with open(OPT_GOLDEN) as f:
            opt_golden = json.load(f)
        reset_counts()
        opt_answers, opt_profiles = optimize_requests(server, port, rows,
                                                      opt_golden)
        ocounts = read_counts()
    finally:
        server.stop()
    opt_summary = optimize_phase(model, model_cpu, vocab, rows, opt_answers,
                                 opt_golden, batches[0], depth)
    for policy, prof in opt_profiles.items():
        print(f'optimize profile {policy} ' + json.dumps(prof), flush=True)
    phase('optimize', t0)

    t0 = time.perf_counter()
    hier_summary, hcounts, hier_rows, hier_sites = hier_phase(floor_ms())
    phase('hier', t0)

    t0 = time.perf_counter()
    _, train_batches = profile_train.hopv_batches(vocab=vocab)
    if len(train_batches) != profile_train.STEPS_PER_EPOCH:
        raise AssertionError(f'{len(train_batches)} HOPV batches, need '
                             f'{profile_train.STEPS_PER_EPOCH}')
    prof, tcounts, train_rows, train_turns, train_check = train_phase(
        vocab, train_batches)
    phase('train', t0)

    t0 = time.perf_counter()
    ft_prof, fcounts, ft_check = finetune_phase(vocab, train_batches,
                                                train_turns)
    phase('finetune', t0)

    t0 = time.perf_counter()
    hier_profs, htcounts, htrain_rows, htrain_check = hier_train_phase(
        floor_ms())
    phase('hier train', t0)

    t0 = time.perf_counter()
    hturbo_summary, htbcounts, hturbo_rows, hturbo_sites, hturbo_replays = \
        hier_turbo_phase(floor_ms())
    phase('hier turbo', t0)

    t0 = time.perf_counter()
    sa_summary, sacounts, sched_rows, sched_site = sched_att_phase(
        vocab, train_batches, floor_ms())
    phase('sched+att', t0)

    t0 = time.perf_counter()
    a5_summary, a5counts, a5_bf16, a5_rows = a5_phase(vocab, train_batches,
                                                      floor_ms())
    phase('a5', t0)

    t0 = time.perf_counter()
    a6_summary, a6counts = a6_phase(model, model_cpu)
    counts = {name: counts[name] + dcounts[name] + ocounts[name] +
              hcounts[name] + tcounts[name] + fcounts[name] +
              htcounts[name] + htbcounts[name] + sacounts[name] +
              a5counts[name] + a6counts[name] for name in counts}
    phase('a6', t0)

    t0 = time.perf_counter()
    a7_summary, a7counts = a7_phase(vocab, train_batches)
    counts = {name: counts[name] + a7counts[name] for name in counts}
    phase('a7', t0)

    keys = ('max_abs_err', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
            'bound_by', 'floor_ms', 'host_ms')
    kernels = []
    # B1 inside the turbo decode's propose graph: device launches per decode
    # of each request, and µs per launch from the profiled B64/B120 decodes
    in_graph = dict(
        device_launches={n: t['nei_sum_ran']
                         for n, t in summary['turbo'].items()},
        device_us_per_launch={f'B{b}': p['nei_sum_device_us_per_launch']
                              for (b, path), p in decode_profiles.items()
                              if path == 'turbo'})
    for name, k in KERNELS.items():
        rows_of = {**report.get(name, {}), **train_rows[name]}
        r = rows_of[k['main_case']]
        kernels.append(dict(
            name=name, route=k['route'], source=k['source'],
            replaces=k['replaces'], launches=counts[name],
            launches_per_step=prof['kernel_launches_per_step'][name],
            launches_per_finetune_step=ft_prof['kernel_launches_per_step'][
                name],
            launches_per_replayed_step={
                'train': train_check['launches_per_replayed_step'][name],
                'finetune': ft_check['launches_per_replayed_step'][name],
                'hier_train': htrain_check['launches_per_replayed_step'][
                    name],
                'sched': sa_summary['graph']['launches_per_replayed_step'][
                    name],
                'att': sa_summary['att']['launches_per_replayed_step'][name],
                'hier_att': sa_summary['hier att'][
                    'launches_per_replayed_step'][name],
                'gru': a5_summary['gru']['launches_per_replayed_step'][name],
                'bf16': a5_summary['bf16']['launches_per_replayed_step'][
                    name],
                'hier_a5': a5_summary['hier a5'][
                    'launches_per_replayed_step'][name],
                'shards': a6_summary['launches_per_replayed_step'][name],
                'dp_nccl': a7_summary['nccl']['launches_per_replayed_step'][
                    name]},
            launches_a7_ranks={
                run: [r[name] for r in a7_summary[run]['launches']]
                for run in ('dp2', 'dp2xtp2')},
            launches_a6={
                'shard_epoch': a6_summary['shard_epoch']['launches'][name],
                'quality_run': a6_summary['quality']['launches'][name]},
            launches_bf16=a5_bf16[name],
            launches_bf16_per_replayed_step={
                k: a5_summary[k]['launches_bf16_per_replayed_step'][name]
                for k in ('bf16', 'hier a5')},
            launches_per_hier_train_step={
                mode: hier_profs[graph]['kernel_launches_per_step'][name]
                for mode, graph in (('eager', False), ('graph', True))},
            **{key: r[key] for key in keys},
            max_abs_err_all_cases=max(
                x['max_abs_err'] for x in list(rows_of.values()) +
                list(hier_rows.get(name, {}).values()) +
                list(htrain_rows.get(name, {}).values()) +
                list(hturbo_rows.get(name, {}).values()) +
                list(sched_rows.get(name, {}).values()) +
                list(a5_rows.get(name, {}).values())),
            call_sites=k['call_sites'], case=k['main_case'],
            **({'turbo_decode': in_graph, 'per_optimize_request': {
                p: o['nei_sum_launches'] for p, o in opt_summary.items()},
                'hier_turbo_replays': hturbo_replays}
               if name == 'nei_sum' else {}),
            shape=r.get('shape') or dict(h=r['h'], graph=r['graph']),
            cases={case: {key: row[key] for key in keys}
                   for case, row in rows_of.items()
                   if case != k['main_case']},
            hier_sites={case: dict(
                {key: row[key] for key in keys}, shape=row['shape'],
                launches=hier_sites[case], replaces=HIER_SITES[case])
                for case, row in hier_rows.get(name, {}).items()},
            hier_train_sites={case: dict(
                {key: row[key] for key in keys}, shape=row['shape'],
                replaces=HIER_TRAIN_SITES.get(case.split('hier-train-')[-1]
                                              .removesuffix('-bwd')))
                for case, row in htrain_rows.get(name, {}).items()},
            hier_turbo_sites={case: dict(
                {key: row[key] for key in keys}, shape=row['shape'],
                launches=hturbo_sites[case],
                replaces=HIER_PROPOSE_SITES[case.split('-B')[0]])
                for case, row in hturbo_rows.get(name, {}).items()},
            sched_sites={case: dict(
                {key: row[key] for key in keys}, shape=row['shape'],
                launches=sched_site[case]['launches'],
                replaces=kernel_bench.SCHED_SITE)
                for case, row in sched_rows.get(name, {}).items()},
            a5_sites={case: dict(
                {key: row[key] for key in keys}, shape=row['shape'],
                dtype=row['dtype'], replaces=A5_SITES[case])
                for case, row in a5_rows.get(name, {}).items()}))
    print(f'total {time.perf_counter() - t_all:.1f}s', flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
