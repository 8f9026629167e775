#!/usr/bin/env python3
"""Chip smoke of temp_tpu_torch: the port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds as it ends:

1. device  - the card's name and power limit;
2. build   - one nvcc call for every kernel source, with the register and
             spill summary of each kernel;
3. setup   - a synthetic dataset at icews14's sizes (7128 entities, 230
             relations, 365 times, 200 train facts a time) with K1's static
             CSR tables of every train snapshot (ring_layout; their size)
             and the grid/icews14/config_grrgcn.json model with seeded
             random weights;
4. k1      - kernel K1 (spmm_fwd) at the final-snapshot shape, the eval
             conv1-table shape and the training shape (the 50% edge
             subsample): over the data's tables (one launch, no sort in the
             call, no synchronizing call) and sorting the call's edges (the
             in-call route), timed side by side and equal bit for bit, both
             within 1e-5 of its plain PyTorch version;
5. k2      - kernel K2f (fused_window_fwd) against its plain version on
             one eval batch of windows, for both conv1_in values, two runs
             bit-equal;
6. path    - Trainer.run_eval over the whole valid split, with the kernels
             and then with their plain versions; the launch counts of the
             kernel run (no K1 call sorting its edges), the MRR of both,
             and the share of identical ranks;
7. k1b     - kernel K1b (spmm_bwd) at the training final-step shape (the
             50% edge subsample) and under the full mask, as k1 does K1f;
8. k2b     - kernel K2f in train mode (dropout masks) and K2b
             (fused_window_bwd) against autograd through the plain forward
             on one training batch of windows: all 12 cotangents (each
             also scaled to its largest plain entry), and two runs of K2f
             and of K2b bit-equal;
9. k3      - kernel K3 (fused_final_fwd: the dense final step and the
             exact-softmax loss of all B elements) against its plain version
             on the first training batch, as the main path prepares it (the
             window's history from K2f, the batch's draws); beside it the
             unfused final step (K1, one element at a time) on that batch;
10. k4     - kernel K4 (fused_final_bwd_loss) against its plain version on
             the same saved table and upstream cotangent;
11. k5     - kernel K5 (fused_final_bwd_layer) against its plain version for
             layer 2 and layer 1, each given the same cotangent on both
             sides: all 8 cotangents, and two runs of each layer bit-equal;
             and the whole final step and loss, forward and backward, fused
             (K3-K5) and unfused (K1, K1b);
12. train  - Trainer.train_step at the full config for a few optimizer steps
             from seeded weights and draws on three paths: the kernels with
             fused_final on (the main path), the kernels with fused_final
             off (K1f/K1b for the final step), and the plain versions; the
             three loss trajectories, the launch counts of each path (no K1
             call sorting its edges), then one run_eval of the trained
             weights.
12a. bf16_kernels - compute_dtype="bfloat16": the bfloat16 modes of K2f
             (eval with the conv1 table, and training with dropout
             masks), K2b, K3, K4 and K5 at the main path's shapes, each
             against its plain bfloat16 version on the same inputs: RMS
             of the gap at most BF16_RULE of the plain float32 version's
             RMS distance from the plain bfloat16 one (K3's loss within
             LOSS_TOL), with times and bounds at the bfloat16 and TF32
             rates; K5's two runs bit-equal, and each of its native
             bfloat16 launches' shared memory, threads, blocks an SM,
             registers and spill (the library's occupancy query and the
             build's report);
12b. bf16_path  - GRRGCN in bfloat16: TRAIN_STEPS steps on the fused path,
             the unfused one and the plain versions of both, each path's
             losses within TRAIN_TOL and trained leaves within PARAM_TOL of
             its plain versions', the launches a step (K2f 28, K2b 72, K3
             4, K4 4, K5 10; none of K6-K13); the valid sweep with the
             kernels and plain (K1f 737, K2f 1,288), its MRR against
             plain; the bfloat16 - float32 gaps of the losses and MRR, and
             the fused path's peak memory beside float32's.

Then the flagship, BiGRRGCN --impute (grid/icews14/config_bigrrgcn.json with
impute on, PostBiDynamicRGCNModel), on the same data:

13. flagship_setup - its model with seeded random weights;
14. k2_flagship    - K2f and K2b in the flagship's modes (a ReLU on layer
                     2, the third "local" buffer) for the forward and the
                     backward window of its first training batch, against
                     the plain version: three buffers, 12 cotangents (the
                     plain ones through the kernels' ReLU pattern, and the
                     elements where the two forwards' patterns differ
                     counted), two runs of K2f and of K2b bit-equal;
15. k6k7      - the bi layer forward (K6+K7) of both layers of that batch's
                final step against its plain version;
16. k8        - the loss from the table (K8) against its plain version;
17. k9k10     - the bi layer backward (K9+K10) of both layers against its
                plain version (layer 2's through the kernel's ReLU pattern,
                bi_relu_pattern), from the loss's cotangent and from a unit
                one, two runs bit-equal; its GRU launch (bi_bwd_gru_kernel)
                timed alone with its bounds; and the final step and loss
                forward and backward, fused (K6-K10, K4) and unfused (K1 one
                element at a time);
18. flagship_path  - the flagship's valid sweep with the kernels and with
                     their plain versions (MRR within 1e-4; no K1 call
                     sorting its edges);
19. flagship_train - 8 optimizer steps of the flagship on the three paths,
                     as `train`, with the launch counts of the new kernels.

Then the switches that are off by default, on GRRGCN and the flagship:

20. k11             - kernel K11 (fused_eval_ranks: the final step in eval
                      mode, the filtered ranks and the BCE of all B elements)
                      against its plain version on one batch of the valid
                      split (ranks equal but for counted near-ties, BCE to
                      1e-5 relative), its ranking half on a table with
                      copies of target rows planted (they must not count),
                      and beside it the unfused eval of that batch;
21. path_fused_eval - the valid sweep with fused_eval on, with the kernels
                      and with their plain versions: MRR within 1e-4 of each
                      other and of `path`'s, walls and queries/s;
22. mb              - fused_window_mb on (K12): its forward against its
                      plain version on a training batch of windows, 8 fused
                      training steps of GRRGCN and of the flagship and a
                      GRRGCN valid sweep, held to the runs without the switch
                      (the same launches and draws: equal losses, parameters
                      and ranks).

Then the TeMP variants (models/post.py, models/bidynamic.py), on the same
data:

23. k2_modes   - K2f and K2b in the two modes these models add, in train
                 mode at the full shape: (a) three buffers without the ReLU
                 (the unidirectional Post models' windows, L1 = 14) and (b)
                 two buffers with it (BiGRRGCN's forward and backward
                 windows, L1 = 7), against the plain versions (mode (b)'s
                 cotangents through the kernels' ReLU pattern), two runs
                 bit-equal, with times and bounds;
23a. bf16_flagship_kernels - compute_dtype="bfloat16" for the flagship:
                 K2f and K2b in its modes (both windows with three buffers
                 and the ReLU; mode (a); mode (b), both windows), K6+K7,
                 K8, K4 on the bi table and K9+K10 in their bfloat16 mode
                 at full width, each against its plain bfloat16 version
                 under BF16_RULE (K8's loss within LOSS_TOL), two runs
                 bit-equal, with times and bounds at the bfloat16 and TF32
                 rates; K9+K10's launches as K5's, and the count of layer
                 2's ReLU signs where its recompute (native bfloat16
                 products) and K6+K7's forward (TF32 products of the
                 rounded operands) differ;
23b. bf16_flagship_path - the flagship in bfloat16: TRAIN_STEPS steps on
                 the fused path, the unfused one and the plain versions of
                 both, losses within TRAIN_TOL and leaves within
                 BF16_PARAM_TOL of each path's plain versions', the
                 launches a step (K2f 28, K2b 74, K6+K7 2, K8 2, K4 4,
                 K9+K10 10; none of K3, K5, K11-K13); the valid sweep (K1f
                 736, K2f 1,288) against plain; the gaps to float32 and the
                 peak memory beside float32's;
23c. bf16_k11   - K11 in bfloat16 (its two bfloat16 layer launches, its
                 float32 rank and reduce launches) on the k11 batch, the
                 histories rounded to bfloat16, against its plain bfloat16
                 version: ranks equal but for the counted near-ties
                 (BF16_NEAR_TIE), the BCE under BF16_RULE, two runs
                 bit-equal, its launches apart timed; then GRRGCN's
                 bfloat16 valid sweep with fused_eval on, kernels and
                 plain, MRR within 1e-4 of each other and of bf16_path's
                 unfused bfloat16 sweep;
23d. bf16_mb    - K12 in bfloat16 in train mode (dropout masks) and eval
                 mode (the conv1 table), bit-equal to K2f's bfloat16
                 launches one element at a time, under BF16_RULE against
                 its plain version; 8 fused bfloat16 steps of GRRGCN and of
                 the flagship and GRRGCN's bfloat16 sweep with
                 fused_window_mb on, held to bf16_path's and
                 bf16_flagship_path's runs without it (losses within
                 LOSS_TOL, leaves within BF16_PARAM_TOL, MRR within 1e-4);
23e. bf16_variants - TED, BiGRRGCN --post-aggregation, plain BiGRRGCN,
                 GRRGCN --impute, and GRRGCN under random_dropout and under
                 edge_dropout (its windows step by step in training) in
                 bfloat16 at full width and VARIANT_SEQ_LEN, as `variants`
                 holds them (leaves within BF16_PARAM_TOL), with the gaps
                 of their plain versions to float32's.
24. ted_setup  - TED, BiGRRGCN --impute --post-ensemble, with seeded random
                 weights, and the seconds its frequency features take to
                 build;
25. ted_path   - its valid sweep with the kernels and with their plain
                 versions (MRR within 1e-4, the gated eval's loss 0), K1f
                 and K2f launched and none of K3-K12;
26. ted_train  - 8 optimizer steps with the kernels and with their plain
                 versions: losses and every parameter leaf (the gates')
                 held together as in `train`; K1f, K1b, K2f and K2b
                 launched, none of K3-K12;
27. variants   - GRRGCN --impute --post-ensemble, BiGRRGCN
                 --post-aggregation and plain BiGRRGCN at full width and
                 train_seq_len VARIANT_SEQ_LEN: 2 steps and one valid batch
                 each, kernels against plain.

Then the self-attention models (models/selfattn.py, models/postselfattn.py),
on the same data, whose every graph product is K1:

28. sa_setup    - SARGCN (grid/icews14/config_sargcn.json, L1 = 14) with
                  seeded random weights;
29. sa_k1       - K1f and K1b at its history's shape: one element's 14
                  window slots side by side in one call, each over all 7128
                  rows in global ids (a window inside the data and one
                  running off t = 0, whose first slots name the clamped
                  position 0 with every edge masked), and the same window
                  in sa_compact's form (A rows a slot); over the data's
                  tables, one launch, no sort, no host sync, two runs and
                  the in-call route bit-equal, within K1_TOL of the plain
                  versions; times, bounds and one index_add_'s time;
30. sa_train    - TRAIN_STEPS optimizer steps with the kernels and with
                  their plain versions: losses within TRAIN_TOL, every
                  leaf within PARAM_TOL, K1f and K1b launched and no other
                  kernel, no K1 call sorting its edges;
31. sa_path     - the valid sweep, kernels against plain (MRR within
                  MRR_TOL, the same query mask), queries/s;
32-34. bisa_setup, bisa_train, bisa_path - the same for BiSARGCN
                  (config_bisargcn.json, L1 = 7 a window);
35. sa_variants - SARGCN and BiSARGCN --post-aggregation and SARGCN with
                  sa_compact, learnable_lambda and ema at full width and
                  VARIANT_SEQ_LEN: 2 steps and one valid batch each,
                  kernels against plain.

Then the linear-recurrence and static models (models/dynamic.py,
models/bidynamic.py, models/static.py) and the recurrent options, on the
same data:

36. rrgcn_setup  - RRGCN (grid/icews14/config_rrgcn.json, L1 = 14) with
                   seeded random weights, and the seconds DropEdge's rates
                   take to build at its window length;
37. rrgcn_k1     - K1f and K1b at its window step's shape: the 8 graphs of
                   a batch side by side, 640 compact rows each, each naming
                   its own time position in the data's tables, under its
                   own mask and an 80% subsample of it; as sa_k1 holds
                   them;
38. rrgcn_train  - TRAIN_STEPS optimizer steps with the kernels and with
                   their plain versions: losses within TRAIN_TOL, every
                   leaf within PARAM_TOL, K1f and K1b launched (exactly
                   k1_launches_a_step a step: 28 window calls of the
                   batch's graphs side by side and 2 an element) and no
                   other kernel, no K1 call sorting its edges; ms a step,
                   peak memory;
39. rrgcn_path   - the valid sweep, kernels against plain (MRR within
                   MRR_TOL, the same query mask), queries/s;
40-42. birrgcn_setup, birrgcn_train, birrgcn_path - the same for BiRRGCN
                   (config_birrgcn.json, two windows of L1 = 7);
43-45. srgcn_setup, srgcn_train, srgcn_path - the same for SRGCN
                   (config_srgcn.json, no window: 2 K1 calls an element);
46. rec_variants - GRRGCN with type1 + learnable_lambda +
                   use_time_embedding, with rec_only_last_layer, with
                   edge_dropout and with random_dropout, BiGRRGCN --impute
                   --edge-dropout and --post-aggregation with time
                   embeddings, RRGCN with random_dropout, and DRGCN at full
                   width and VARIANT_SEQ_LEN: 2 steps and one valid batch
                   each, kernels against plain, each with the kernels it
                   must and must not launch (under the dropouts the
                   training windows run through K1 and the final step
                   through K3-K5, or the flagship's K6-K10 and K4; eval
                   through K2f), and the DropEdge rates' build seconds.

Then TimeDynamicRGCN (models/timedynamic.py), the other decoders and
negative pools, the embedding baselines (models/baselines.py) and the
Aggregator (models/aggregator.py), on the same data:

47. tdyn_setup   - TimeDynamicRGCN (grid/icews14/config_grrgcn.json with
                   module TimeDynamicRGCN, L1 = 14) with seeded weights;
48. tdyn_train   - TRAIN_STEPS optimizer steps with the kernels and with
                   their plain versions on the same draws: losses within
                   TRAIN_TOL, every leaf (w_temp and b_temp among them)
                   within PARAM_TOL; K2f, K2b, K1f and K1b launched exactly
                   as tdyn_launches predicts, none of K3-K13; ms a step,
                   peak memory;
49. tdyn_path    - the valid sweep, kernels against plain (MRR within
                   MRR_TOL, the same query mask), K2f and K1f launched as
                   predicted, queries/s;
50. zoo_variants - GRRGCN with distmult, with transE, with the shared pool
                   and with the per_query pool, BiGRRGCN --impute with
                   transE and per_query, GRRGCN --impute --post-ensemble
                   with transE and shared, SARGCN with distmult, at full
                   width and VARIANT_SEQ_LEN: 2 steps and one valid batch
                   each, kernels against plain on the same draws, each
                   with the kernels it must and must not launch (windows
                   K2f/K2b, the final step K1, none of K3-K12); each
                   training run's peak memory;
51-55. baselines_Static, _DE, _ATiSE, _Hyte, _SimplE - each baseline at
                   d = 128: TRAIN_STEPS steps on the card, the CPU
                   replaying them from the same seeded weights on the
                   card's draws (losses within
                   TRAIN_TOL, leaves within PARAM_TOL), the valid sweep on
                   the card (queries/s); no kernel launched;
56. agg_setup    - seeded SRGCN (config_srgcn.json) and BiGRRGCN
                   (config_bigrrgcn.json) written as two port run
                   directories (config.json, checkpoints/best.pt) in a
                   temporary directory, and the Aggregator that loads both
                   (load_checkpoint_params);
57. agg_train    - 2 steps with the kernels and with their plain versions:
                   losses and the gates' leaves held together, every
                   submodel leaf bit-equal to its checkpoint; K1f and K2f
                   launched, no K1b or K2b;
58. agg_path     - one valid batch, kernels against plain: the same mask,
                   ranks equal but for the plain scores' near-ties; K1f
                   and K2f launched; the temporary directory removed.

Then the model-parallel path, GRRGCN with edge_partition="ring_pallas" over
RING_M = 4 ranks, all on the one card, each on its own CUDA streams:

59. ring_setup - the dataset regrouped for 4 ranks (ring_layout: the edges
                 grouped by destination owner, K13's and K1's static CSR
                 tables of every train snapshot) and the model on it with the
                 same seeded weights; prints the ranks' placement and the
                 number of cards;
60. k13        - kernel K13 (ring_spmm_fwd) at the final-snapshot shape
                 (7128 rows in 4 shards of 1792) and at one window step's
                 compact shape (the 8 graphs of an eval batch): walking
                 the data's tables (the path's route) and sorting the
                 call's edges (the in-call route), timed side by side and
                 equal bit for bit, also under a 50% dynamic mask; both
                 within 1e-5 of the largest entry of the plain version,
                 rows without in-edges exactly 0, 4 launches a call; then
                 K13's backward kernels (ring_spmm_bwd) over the tables at
                 both shapes against autograd through the plain forward
                 and against ring_spmm_bwd_plain, with their times;
61. ring_path  - the valid sweep under the partition with the kernels and
                 with their plain versions, and without a partition on the
                 same data (K1 over the data's K1 tables of that layout):
                 MRR within 1e-4; K13's launches, no sort in a call, and
                 none of K1, K2, K3-K5, K11 or K12 under the partition;
62. ring_train - 8 optimizer steps under the partition (kernels, plain)
                 and without it (fused_final off): losses and parameters
                 held together as in `train`; K13's forward and backward
                 launched, no sort in a call.
63. bf16_k13   - K13 and its backward in bfloat16 at k13's shapes on the
                 whole-card route (csrc/ring_spmm_bf16.cu: every shard read
                 in place from the float32 h and rounded in registers, one
                 launch a forward call and one a backward call), bit-equal
                 to the stepped bfloat16 route (the shards rounded and
                 copied round the ring, 4 and 6 launches a call), against
                 their plain bfloat16 versions under BF16_RULE, two runs
                 bit-equal, with times (the stepped route's beside them),
                 bounds, the library's index_add_ of the same rounded
                 messages, and each launch's blocks, registers and
                 resident blocks an SM;
64. bf16_ring  - GRRGCN under ring_pallas in bfloat16: the valid sweep and
                 8 steps with the kernels and with their plain versions
                 (MRR within 1e-4, losses within TRAIN_TOL, leaves within
                 BF16_PARAM_TOL), K13 and its backward launched, none of
                 K1-K12, no sort in a call; the gaps to ring_path's and
                 ring_train's float32 runs.
65. bf16_k1    - K1f and K1b in bfloat16 (csrc/spmm_bf16.cu: h and w read
                 as the path gives them, each gathered value rounded in
                 registers) at every K1 shape above, on the operands the
                 path hands the wrapper, against their plain bfloat16
                 versions within K1_TOL of the largest entry, two runs
                 bit-equal, with times, bounds and the library's index_add_;
66. bf16_spmm_pallas - under the SpMM method "pallas" in bfloat16:
                 GRRGCN's unfused valid sweep (K1f bf16 737 launches, no
                 float32 K1) and SARGCN's 8 steps and sweep (K1f and K1b
                 bf16 32 each a step), kernels against plain;
67. bf16_zoo   - every other model, decoder, pool and option in bfloat16
                 at depth 4 (bf16_zoo), the baselines (bf16_baselines_*)
                 and the Aggregator (bf16_agg_*), kernels against plain,
                 with the launches of their float32 phases.

Then a "kernels" JSON line (each record with its "id", K1f to K13b; the
bfloat16 modes as "<name>_bf16" records after the float32 ones, their
launches the bf16 fused training path's: GRRGCN's K2f, K2b, K3-K5, K2's
with the flagship's modes and K4's with the bi table beside, then the
flagship's K6+K7, K8 and K9+K10, then K11's (the bfloat16 fused eval
sweep's launches), K12's (the fused bfloat16 steps with the batched
window's), K13's and K13b's (the bfloat16 ring steps', on the
whole-card route: one launch a call, the stepped route's time and bits
beside, each launch's blocks and registers), K1f's and K1b's
(GRRGCN's bfloat16 sweep's and SARGCN's bfloat16 steps' under "pallas");
each kernel's bound_share, bound / ms, and for
K2f, K2b, K5, K9+K10 and K12, whose products run in 3xTF32 on the tensor
cores, bound_tc_ms: their operations at 3xTF32's 165 TFLOP/s beside the f32
bound_ms; K2f's and K2b's rows with their modes apart, `extra_modes` the
k2_modes phase's; K1f's and K1b's rows with the attention history's
shapes, `sa_history`, `sa_history_edge`, `sa_compact`, and the linear
recurrence's window step, `rrgcn_window`, `rrgcn_window_sub`; every path's
launches, the attention, linear-recurrence and static models', the
recurrent options', TimeDynamicRGCN's, the other decoders' and pools',
the baselines' and the Aggregator's among them), the
nvidia-smi name/power-limit line, and the
result line {"ok": true, "device": {...}}. Any failed check raises and exits
non-zero; there is no result line then. Without CUDA it exits 1 at once. A
watchdog ends a run whose phase runs past WATCHDOG_S and names the phase.
TF32 is off for every product, on the kernels' side and the plain side.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import json
import math
import os
import signal
import subprocess
import sys
import time
from contextlib import contextmanager

WATCHDOG_S = 300
TOL = 1e-4           # kernel vs plain, max abs error, f32 at full width
# K1 (the relational SpMM) vs plain, max abs error: at full width its
# outputs and cotangents lie below 1 (xavier-sized h and w, norm^2 <= 1)
# and each row sums a few edges
K1_TOL = 1e-5
LOSS_TOL = 1e-4      # the final step's per-element losses, relative
MRR_TOL = 1e-4       # whole valid sweep, kernels vs plain path
# gradients summed over many rows (weight cotangents over B*L1*A = 71,680
# rows, or B*N = 57,024 in the final step): max abs error relative to
# max(1, the largest entry)
GRAD_TOL = 1e-4
# the final step's cotangents (K4, K5): max abs error relative to the
# largest entry of the plain version's, with no floor, since at full width
# they lie far below 1 (each positive weighs 1/count, each softmax weight
# is about 1/N)
SCALED_TOL = 1e-5
# loss trajectories over a few Adam steps, kernels vs plain path, relative:
# f32 sums in another order, carried through the steps
TRAIN_TOL = 1e-4
# the parameters after those steps, each leaf: the norm of the gap between
# two paths relative to the norm of the change the plain path made to it.
# Adam moves each entry by about lr * sign(gradient) a step, so a gradient
# of the wrong direction shows at the scale of that change. A norm, not a
# max: where weight decay all but cancels an entry's gradient (|g + wd * p|
# near Adam's eps), f32 rounding moves that entry's step by a few percent
PARAM_TOL = 1e-2
# the bfloat16 flagship's and variants' parameters after those steps (each
# leaf as PARAM_TOL, the bfloat16 kernels against their plain versions): a
# bfloat16 gradient carries rounding flips where a float32 sum lands on a
# rounding boundary in one and not the other, and Adam moves an entry whose
# gradient is near 0 by a full step of either sign, so the two drift apart
# chaotically from the first step (on an H100 at these sizes, GRRGCN's
# bfloat16 path: 0.105 of the float32 path's distance after one step, 0.283
# after 8, each leaf within PARAM_TOL of its change; the flagship's: its
# input embeddings 2% of their change, its other leaves under 1.3%). A
# gradient of the wrong direction still shows at the scale of the change
BF16_PARAM_TOL = 5e-2
TRAIN_STEPS = 8
RING_M = 4  # ranks of the edge partition's ring (all on the one card)
H100_F32_FLOPS = 67e12   # f32 outside the tensor cores, SXM data sheet
# the tensor-core kernels' products in 3xTF32: three TF32 tensor-core
# products for each f32 one, at the data sheet's 495 TFLOP/s dense TF32
H100_TF32X3_FLOPS = 495e12 / 3
H100_BYTES_S = 3.35e12   # HBM3

_state = {"phase": "start"}


def _on_alarm(signum, frame):
    print(f"WATCHDOG: phase not done after {WATCHDOG_S} s; stuck in phase "
          f"'{_state['phase']}'", flush=True)
    os._exit(1)


@contextmanager
def phase(name: str, out: dict):
    """Run one phase; print its line with the elapsed seconds at its end.
    Under ``main`` the watchdog restarts at each phase: WATCHDOG_S a
    phase."""
    _state["phase"] = name
    if _state.get("watchdog"):
        signal.alarm(WATCHDOG_S)
        faulthandler.dump_traceback_later(WATCHDOG_S + 15, exit=True)
    t0 = time.perf_counter()
    yield out
    out["seconds"] = time.perf_counter() - t0
    fields = " ".join(f"{k}={v}" for k, v in out.items()
                      if not isinstance(v, (dict, list)))
    print(f"[{name}] {fields}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, device, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call; CUDA events on the card. The CPU
    rehearsal of the phases times one call on the CPU clock: no check reads
    its value."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def phase_device() -> dict:
    import torch

    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "smi": smi_line()}


# the register and spill lines of this process's build (phase_build), or
# "" when the library was built before it
_PTXAS = {"summary": ""}


def phase_build() -> dict:
    from temp_tpu_torch import _build

    t0 = time.perf_counter()
    report = _build.build()
    seconds = time.perf_counter() - t0
    _build.lib()
    _PTXAS["summary"] = _build.ptxas_summary(report)
    print(_PTXAS["summary"], flush=True)
    return {"nvcc_s": round(seconds, 3), "built": bool(report)}


def ptxas_of(source: str, kernel: str):
    """Kernel `kernel` of csrc/`source` as nvcc's -Xptxas -v report of this
    process's build gives it: {"registers", "spill_stores", "spill_loads"}
    (a thread, bytes), or None when the library was built before."""
    import re

    tag = source.replace(".", "_") + "_"
    mangled = f"{len(kernel)}{kernel}E"
    out = {}
    for line in _PTXAS["summary"].splitlines():
        name, _, info = line.partition(": ")
        if tag not in name or mangled not in name:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, info)
            if m:
                out[key] = int(m.group(1))
    return out or None


def bf16_launch_info(query: str, which: dict, source: str, d: int):
    """The launches of a bfloat16 kernel set (`query` the library's
    occupancy function, ``final_bf16_occupancy`` or ``bi_bf16_occupancy``;
    `which` launch name -> (its index there, its kernel's name)) at width
    d: each launch's shared memory a block, threads, resident blocks an SM,
    registers and local bytes a thread from the library, and registers and
    spill from the build's report (``ptxas_of``). None off the card."""
    import ctypes

    import torch

    from temp_tpu_torch import _build

    if not torch.cuda.is_available():
        return None
    out = {}
    for name, (i, kernel) in which.items():
        buf = (ctypes.c_int * 5)()
        _build.check(getattr(_build.lib(), query)(
            i, d, ctypes.addressof(buf)), query)
        out[name] = {**dict(zip(("smem_bytes", "threads", "blocks_per_sm",
                                 "registers", "local_bytes"), buf)),
                     "ptxas": ptxas_of(source, kernel)}
    return out


def phase_setup(device, num_ents=7128, num_rels=230, num_times=365,
                edges_per_time=200, seed=0, config="config_grrgcn.json",
                data=None, **cfg_over) -> dict:
    import torch

    from temp_tpu_torch.config import TKGConfig
    from temp_tpu_torch.data.snapshots import make_synthetic, ring_layout
    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    # the phases name their dtype: "auto" is bfloat16 on the card
    cfg_over = {"compute_dtype": "float32", **cfg_over}
    cfg = TKGConfig.from_json_file(
        os.path.join(root, "grid", "icews14", config), fused_window=True,
        **cfg_over)
    # with K1's static tables of every train snapshot (TKGData.spmm);
    # `data`, when given, is such a dataset already (another setup's)
    if data is None:
        data = ring_layout(cfg, make_synthetic(
            num_ents=num_ents, num_rels=num_rels, num_times=num_times,
            edges_per_time=edges_per_time, seed=seed,
            edge_pad_multiple=cfg.edge_pad_multiple))
    model = get_model(cfg, data, device=device)
    params = model.init_params(cfg.seed)
    trainer = Trainer(cfg, model, data)
    setup_kw = dict(num_ents=num_ents, num_rels=num_rels,
                    num_times=num_times, edges_per_time=edges_per_time,
                    seed=seed, **cfg_over)
    return {"cfg": cfg, "data": data, "model": model, "params": params,
            "trainer": trainer, "device": torch.device(device),
            "setup_kw": setup_kw,
            "N": num_ents, "T": data.num_times,
            "A": int(data.act_idx.shape[1]),
            "E": int(data.train.src.shape[1]),
            "L1": cfg.train_seq_len - 1, "B": cfg.eval_batch,
            "d": cfg.embed_size,
            "k1_tables_mb": {sp: sum(getattr(tab, f.name).nbytes
                                     for f in dataclasses.fields(tab)
                                     if f.name != "rows") / 2**20
                             for sp, tab in (("glob", data.spmm.glob),
                                             ("comp", data.spmm.comp))}}


def _spmm_bound(h, src, rel, emask, n_rows):
    """Least time for one K1 call: the referenced rows of h and w, the edge
    arrays and the output moved once, against 3 flops per edge column."""
    m = emask.bool()
    d = h.shape[1]
    rows = int(src[m].unique().numel()) + int(rel[m].unique().numel())
    nbytes = rows * d * 4 + src.numel() * 16 + n_rows * d * 4
    flops = 3 * int(m.sum()) * d
    t_b, t_f = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _k1_cases(ctx):
    """K1's shapes on the main path, each with the data's tables and the
    time positions that the path's call names: (tag, (h, src, dst, rel,
    emask, w), tables). "final": all N entity rows and one snapshot's
    edges (eval's final step); "table": the T snapshots' active rows side
    by side (eval's conv1 table, compact slots); "train": the final step
    on the 50% edge subsample (unfused training)."""
    import torch

    from temp_tpu_torch.ops.sampling import subsample_edges

    dev, p, data = ctx["device"], ctx["params"], ctx["trainer"].data
    tr, tab = data.train, data.spmm
    w = p["encoder"]["layer1"]["weight"]
    t = data.num_times // 2
    tp = torch.tensor([t], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    sub = subsample_edges(gen, tr.emask[t], 0.5)
    h_tab = p["ent_embeds"][data.act_idx.long().clamp(max=ctx["N"] - 1)]
    edges = (tr.src[t], tr.dst[t], tr.rel[t])
    return (("final", (p["ent_embeds"], *edges, tr.emask[t], w),
             (tab.glob, tp)),
            ("table", (h_tab.reshape(-1, ctx["d"]).contiguous(),
                       data.train_src_loc, data.train_dst_loc, tr.rel,
                       tr.emask, w),
             (tab.comp, torch.arange(data.num_times, device=dev))),
            ("train", (p["ent_embeds"], *edges, sub, w), (tab.glob, tp)))


def _flat(args):
    """A call's (h, src, dst, rel, emask, w) with its graphs flattened
    into one (the plain versions' and the yardsticks' form)."""
    from temp_tpu_torch.ops.spmm import flat_graph

    h, src, dst, rel, em, w = args
    if src.dim() == 1:
        return args
    s, t = flat_graph(src, dst, h.shape[0] // src.shape[0])
    return h, s, t, rel.reshape(-1), em.reshape(-1), w


@contextmanager
def _no_sync():
    """Raise on any synchronizing CUDA call PyTorch makes inside."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _one_launch(fn, counter, what: str, device):
    """Run fn once; on the card it must launch `counter`'s kernel once,
    sort nothing in the call and make no synchronizing call."""
    from temp_tpu_torch.ops.spmm import spmm_fwd

    if device.type != "cuda":
        return fn()
    launches, builds = counter.launches, spmm_fwd.csr_builds
    with _no_sync():
        out = fn()
    if counter.launches != launches + 1 or spmm_fwd.csr_builds != builds:
        raise AssertionError(f"{what}: {counter.launches - launches} "
                             f"launches, {spmm_fwd.csr_builds - builds} "
                             f"sorts in the call")
    return out


def phase_k1(ctx, cases=None) -> dict:
    """K1f at the main path's shapes (``_k1_cases``, or `cases` of that
    form) over the data's tables (the path's route: one launch, no sort,
    no host sync; two runs bit for bit equal) and over tables sorted in
    the call (the in-call route): bit for bit equal, both within K1_TOL of
    the plain version; their times beside the plain version's, one
    ``index_add_`` of the same messages and the bound."""
    import torch

    from temp_tpu_torch.ops.spmm import _spmm_fwd, spmm_fwd, spmm_fwd_plain

    dev = ctx["device"]
    out = {}
    for tag, args, tables in (cases or _k1_cases(ctx)):
        k, kn2, _ = _one_launch(lambda: _spmm_fwd(*args, tables=tables),
                                spmm_fwd, f"K1 {tag}", dev)
        again = _spmm_fwd(*args, tables=tables)[0]
        builds = spmm_fwd.csr_builds
        c, cn2, _ = _spmm_fwd(*args)
        if dev.type == "cuda" and spmm_fwd.csr_builds != builds + 1:
            raise AssertionError(f"K1 {tag}: the in-call route sorted "
                                 f"{spmm_fwd.csr_builds - builds} times")
        flat = _flat(args)
        ref = spmm_fwd_plain(*flat)
        err = max_err(k, ref)
        bitwise = bool(torch.equal(k, c) and torch.equal(kn2, cn2)
                       and torch.equal(k, again))
        if not (err <= K1_TOL and bitwise):
            raise AssertionError(f"K1 {tag}: max abs err {err} (> {K1_TOL}?)"
                                 f", table route bit-equal to itself and "
                                 f"the in-call route: {bitwise}")
        h, src, dst, rel, em, w = flat
        msg = h[src.long()] * w[rel.long()] * em.to(h.dtype)[:, None]
        lib = torch.zeros_like(h)
        bound_ms, bound_by = _spmm_bound(h, src, rel, em, h.shape[0])
        out[tag] = {
            "shape": f"N={h.shape[0]} B={tables[1].numel()} "
                     f"E={src.numel()} kept={int(em.sum())} "
                     f"R={w.shape[0]} d={h.shape[1]}",
            "max_abs_err": err, "bitwise": bitwise,
            "ms": time_ms(lambda: spmm_fwd(*args, tables=tables), dev),
            "in_call_ms": time_ms(lambda: spmm_fwd(*args), dev),
            "plain_ms": time_ms(lambda: spmm_fwd_plain(*flat), dev),
            "library_ms": time_ms(
                lambda: lib.zero_().index_add_(0, dst.long(), msg), dev),
            "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"  K1 {tag}: {out[tag]}", flush=True)
    return out


def window_batch(ctx, conv1_in: bool):
    """The K2 arguments of the first eval batch of the valid sweep, as the
    path prepares them."""
    import torch

    from temp_tpu_torch.models.dynamic import gather_window

    model, data, p = ctx["model"], ctx["trainer"].data, ctx["params"]
    L1, B = ctx["L1"], ctx["B"]
    tp = torch.arange(B, device=ctx["device"]) + data.num_times // 2
    win = gather_window(data, tp, L1 + 1)
    prev_step = model.tbl_fwd.prev_step[tp].long()
    prev_row = model.tbl_fwd.prev_row[tp].long()
    pos = torch.arange(L1, device=ctx["device"])[None, :, None]
    dt = (pos - prev_step.clamp(min=0)).to(torch.float32)
    if conv1_in:
        h0 = model._window_conv1(model.precompute_eval_conv1(p, data), tp,
                                 L1 + 1)
    else:
        h0 = model._rows(p, win.act_idx[:, :L1])
    return win, dict(h0_xs=h0, src=win.src_loc[:, :L1],
                     dst=win.dst_loc[:, :L1], rel=win.rel[:, :L1],
                     emask=win.emask[:, :L1], prev_step=prev_step,
                     prev_row=prev_row, dt=dt, live=prev_step >= 0,
                     conv1_in=conv1_in)


def _window_bound(ctx, win, conv1_in: bool, masks: bool = False,
                  extra_bytes: int = 0) -> dict:
    """Least time for one K2f call: f32 flops of the GRU gate products
    (4 of [rows, d] x [d, 3d] a step), the self-loop products and the SpMMs
    over the active rows and real edges, against the buffers and inputs
    (the two dropout masks in training, and `extra_bytes`) moved once:
    "bound_ms" at f32's rate, "bound_tc_ms" at 3xTF32's, the rate of K2f's
    products."""
    L1, d = ctx["L1"], ctx["d"]
    rows = int(win.act_mask[:, :L1].sum())
    edges = int(win.emask[:, :L1].sum())
    n_conv = 1 if conv1_in else 2
    flops = rows * (4 * 2 * d * 3 * d + n_conv * 2 * d * d) \
        + n_conv * edges * 3 * d
    n_rel = ctx["params"]["encoder"]["layer1"]["weight"].shape[0]
    w_bytes = (2 * d * 3 * d * 2 + 2 * d * d + n_rel * 2 * d) * 4
    nbytes = (rows * d * 4 * (5 if masks else 3) + edges * 16 + rows * 12
              + w_bytes + extra_bytes)
    return _bounds(flops, nbytes)


def phase_k2(ctx) -> dict:
    from temp_tpu_torch.ops.fused_window import fused_window_scan

    dev, p, cfg = ctx["device"], ctx["params"], ctx["cfg"]
    out = {}
    for conv1_in in (True, False):
        win, kw = window_batch(ctx, conv1_in)
        run_k = lambda: fused_window_scan(p["encoder"], cfg, **kw)  # noqa
        run_p = lambda: fused_window_scan(p["encoder"], cfg,  # noqa: E731
                                          kernels=False, **kw)
        got = run_k()
        r1, r2 = run_p()
        err = max(max_err(got[0], r1), max_err(got[1], r2))
        bitwise = _bitwise(got, run_k())
        if not (err <= TOL and bitwise):
            raise AssertionError(f"K2 conv1_in={conv1_in}: max abs err "
                                 f"{err} > {TOL}, or two runs differ "
                                 f"(bit-equal: {bitwise})")
        tag = "conv1_in" if conv1_in else "recompute"
        out[tag] = {
            "shape": f"B={ctx['B']} L1={ctx['L1']} A={ctx['A']} "
                     f"E={ctx['E']} d={ctx['d']}",
            "max_abs_err": err, "bitwise": bitwise,
            "ms": time_ms(run_k, dev, reps=5),
            "plain_ms": time_ms(run_p, dev, reps=5),
            "library_ms": None, **_window_bound(ctx, win, conv1_in)}
        out[tag]["bound_share"] = out[tag]["bound_ms"] / out[tag]["ms"]
        print(f"  K2 {tag}: {out[tag]}", flush=True)
    return out


def _counters():
    """Every kernel wrapper, whose ``launches`` counts its launches, in the
    kernels line's order."""
    from temp_tpu_torch.ops import fused_final_bi as fb
    from temp_tpu_torch.ops.fused_final import (
        fused_eval_ranks, fused_final_bwd_layer, fused_final_bwd_loss,
        fused_final_fwd,
    )
    from temp_tpu_torch.ops.fused_window import (
        fused_window_bwd, fused_window_fwd,
    )
    from temp_tpu_torch.ops.fused_window_mb import fused_window_mb_fwd
    from temp_tpu_torch.ops.spmm import spmm_bwd, spmm_fwd
    from temp_tpu_torch.parallel.ring_spmm import ring_spmm_bwd, ring_spmm_fwd

    return (spmm_fwd, spmm_bwd, fused_window_fwd, fused_window_bwd,
            fused_final_fwd, fused_final_bwd_loss, fused_final_bwd_layer,
            fb.bi_layer_fwd, fb.bi_loss_fwd, fb.bi_layer_bwd,
            fused_eval_ranks, fused_window_mb_fwd, ring_spmm_fwd,
            ring_spmm_bwd)


def _reset_counts() -> None:
    """Every launch counter, and K1's and K13's counts of in-call sorts, to
    0."""
    from temp_tpu_torch.ops.spmm import spmm_bwd, spmm_fwd
    from temp_tpu_torch.parallel.ring_spmm import ring_spmm_fwd

    for fn in _counters():
        fn.launches = 0
    spmm_fwd.launches_bf16 = spmm_bwd.launches_bf16 = 0
    spmm_fwd.launches_onehot = spmm_bwd.launches_onehot = 0
    ring_spmm_fwd.csr_builds = spmm_fwd.csr_builds = 0


def _csr_builds() -> int:
    """The tables K13 sorted in a call since the last reset (0 on a path
    that walks the data's tables)."""
    from temp_tpu_torch.parallel.ring_spmm import ring_spmm_fwd

    return ring_spmm_fwd.csr_builds


def _k1_csr_builds() -> int:
    """The tables K1 sorted in a call since the last reset (0 on a path
    whose calls all name the data's tables)."""
    from temp_tpu_torch.ops.spmm import spmm_fwd

    return spmm_fwd.csr_builds


def _counts() -> dict:
    """Every kernel's launches since the last reset, and K1's in its
    bfloat16 modes apart ("spmm_fwd_bf16", "spmm_bwd_bf16": the wrappers
    count every mode in ``launches``; "spmm_fwd_onehot", "spmm_bwd_onehot"
    the "onehot" rounding's among the bfloat16 ones)."""
    from temp_tpu_torch.ops.spmm import spmm_bwd, spmm_fwd

    out = {fn.__name__: fn.launches for fn in _counters()}
    out["spmm_fwd_bf16"] = spmm_fwd.launches_bf16
    out["spmm_bwd_bf16"] = spmm_bwd.launches_bf16
    out["spmm_fwd_onehot"] = spmm_fwd.launches_onehot
    out["spmm_bwd_onehot"] = spmm_bwd.launches_onehot
    return out


def _peak_mb(dev):
    """The card's peak allocated memory since the last reset, in MiB (None
    off the card)."""
    import torch

    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**20


def _allocated_mb(dev):
    """The card's allocated memory now, in MiB (None off the card): taken
    at a reset of the peak, so that a run's own rise above what earlier
    phases hold, peak - this, compares across phases."""
    import torch

    if dev.type != "cuda":
        return None
    return torch.cuda.memory_allocated(dev) / 2**20


def _rise_mb(dev, base):
    return None if base is None else _peak_mb(dev) - base


def _sweep(ctx, c):
    """One valid sweep of config c (every launch counter from 0): its
    metrics, wall seconds, queries/s and launches; ranks and mask (numpy)."""
    import torch

    from temp_tpu_torch.models.objectives import metrics_from_ranks
    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer

    dev = ctx["device"]
    tr = Trainer(c, get_model(c, ctx["data"], device=dev), ctx["data"],
                 mesh=ctx.get("mesh"))
    _reset_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    base = _allocated_mb(dev)
    t0 = time.perf_counter()
    ranks, mask, bces = tr.eval_sweep(ctx["params"], "valid")
    ranks, mask = ranks.cpu().numpy(), mask.cpu().numpy()
    wall = time.perf_counter() - t0
    m = metrics_from_ranks(ranks, mask)
    m["loss"] = float(bces.mean())
    m["wall_s"] = wall
    m["queries_per_s"] = m["n"] / wall
    m["launches"] = _counts()
    m["csr_builds"] = _csr_builds()
    m["k1_csr_builds"] = _k1_csr_builds()
    m["peak_mb"] = _peak_mb(dev)
    m["peak_rise_mb"] = _rise_mb(dev, base)
    return m, ranks, mask


def phase_path(ctx, want=None, **over) -> dict:
    """The valid sweep with the kernels, then with their plain versions
    (the config's switches set as `over` gives them); `want`: the kernels
    the sweep must launch on the card (default: the recurrent models', K1f
    and K2f or its batched form, with K11 under fused_eval)."""
    import numpy as np

    dev, cfg = ctx["device"], ctx["cfg"].replace(**over)
    res = {}
    runs = {}
    for name, kernels in (("kernels", True), ("plain", False)):
        m, ranks, mask = _sweep(ctx, cfg.replace(kernels=kernels))
        runs[name] = (ranks, mask)
        res[name] = m
        print(f"  path {name}: {m}", flush=True)
    (rk, mk), (rp, mp) = runs["kernels"], runs["plain"]
    n_q = 2 * int(ctx["data"].valid.emask.sum())
    k, pl = res["kernels"], res["plain"]
    if not (np.array_equal(mk, mp) and k["n"] == pl["n"] == n_q):
        raise AssertionError(f"query masks differ or miss queries: "
                             f"{k['n']} / {pl['n']} / {n_q}")
    if not (np.isfinite(k["mrr"]) and np.isfinite(k["loss"])
            and 0.0 < k["mrr"] <= 1.0):
        raise AssertionError(f"bad metrics {k}")
    if not abs(k["mrr"] - pl["mrr"]) <= MRR_TOL:
        raise AssertionError(f"MRR kernels {k['mrr']} vs plain {pl['mrr']}")
    if want is None:
        want = ["spmm_fwd", "fused_window_mb_fwd" if cfg.fused_window_mb
                else "fused_window_fwd"] + (["fused_eval_ranks"]
                                            if cfg.fused_eval else [])
    if dev.type == "cuda" and not all(k["launches"][n] > 0 for n in want):
        raise AssertionError(f"main path missed a kernel of {want}: {k}")
    if dev.type == "cuda" and k["k1_csr_builds"]:
        raise AssertionError(f"K1 sorted {k['k1_csr_builds']} calls' edges "
                             f"on the path (every call names the data's "
                             f"tables)")
    if any(pl["launches"].values()):
        raise AssertionError(f"kernels launched on the plain versions' path:"
                             f" {pl['launches']}")
    res["same_rank_share"] = float(np.mean(rk[mk] == rp[mp]))
    if not over:
        ctx["path_runs"] = runs
    return res


def rel_err(a, b) -> float:
    """max |a - b| / max(1, max |b|)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def scaled_errs(pairs, tol=SCALED_TOL) -> dict:
    """{name: {"abs": max |got - ref|, "max_ref": max |ref|}} over
    (name, got, ref) triples; unless tol is None, raises unless every abs is
    at most tol times its max_ref (no floor: exact zeros must agree
    exactly)."""
    errs, bad = {}, []
    for n, got, ref in pairs:
        e = {"abs": float((got - ref).abs().max()),
             "max_ref": float(ref.abs().max())}
        errs[n] = e
        if tol is not None and not e["abs"] <= tol * e["max_ref"]:
            bad.append(n)
    if bad:
        raise AssertionError(f"beyond {tol} of the largest entry: "
                             f"{ {n: errs[n] for n in bad} }")
    return errs


def phase_k1b(ctx, cases=None, tags=("train", "final")) -> dict:
    """K1b at the training final-step shape (all N rows, one snapshot's
    padded train edges with the 50% subsample) and under the full mask
    (or at the `tags` of `cases`, ``_k1_cases``' form): over the data's
    tables (one launch, no sort, no host sync; two runs bit for bit equal)
    and over tables sorted in the call, bit for bit equal, both within
    K1_TOL of the plain version; their times beside the plain version's,
    two ``index_add_`` calls on the same messages and the bound."""
    import torch

    from temp_tpu_torch.ops.spmm import _spmm_fwd, spmm_bwd, spmm_bwd_plain

    dev = ctx["device"]
    cases = {tag: (args, tables)
             for tag, args, tables in (cases or _k1_cases(ctx))}
    out = {}
    for tag in tags:
        args, tables = cases[tag]
        _, n2, _ = _spmm_fwd(*args, tables=tables)
        gen = torch.Generator(device=dev).manual_seed(1)
        g = torch.randn(args[0].shape, generator=gen, device=dev)
        bargs = (g, n2) + tuple(args)
        dh, dw = _one_launch(lambda: spmm_bwd(*bargs, tables=tables),
                             spmm_bwd, f"K1b {tag}", dev)
        ah, aw = spmm_bwd(*bargs, tables=tables)
        ch, cw = spmm_bwd(*bargs)
        h, src, dst, rel, em, w = _flat(args)
        flat = (g, n2, h, src, dst, rel, em, w)
        rh, rw = spmm_bwd_plain(*flat)
        err_h, err_w = max_err(dh, rh), max_err(dw, rw)
        bitwise = bool(torch.equal(dh, ch) and torch.equal(dw, cw)
                       and torch.equal(dh, ah) and torch.equal(dw, aw))
        if not (err_h <= K1_TOL and err_w <= K1_TOL and bitwise):
            raise AssertionError(f"K1b {tag}: max abs err dh {err_h}, dw "
                                 f"{err_w} (> {K1_TOL}?), table route "
                                 f"bit-equal to itself and the in-call "
                                 f"route: {bitwise}")
        # the library yardstick: the same backward as two index_add_ calls
        # on the per-edge messages (computed outside the timing)
        emf = em.to(torch.float32)[:, None]
        dmsg = (g * n2[:, None])[dst.long()] * emf
        mh, mw = dmsg * w[rel.long()], dmsg * h[src.long()]
        lib_h, lib_w = torch.zeros_like(h), torch.zeros_like(w)

        def library():
            lib_h.zero_().index_add_(0, src.long(), mh)
            lib_w.zero_().index_add_(0, rel.long(), mw)

        m = em.bool()
        d, n_kept = h.shape[1], int(m.sum())
        rows = (int(dst[m].unique().numel()) + int(src[m].unique().numel())
                + int(rel[m].unique().numel()))
        nbytes = (rows * d * 4 + src.numel() * 16 + h.shape[0] * 4
                  + (h.shape[0] + w.shape[0]) * d * 4)
        flops = 6 * n_kept * d
        t_b, t_f = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
        out[tag] = {
            "shape": f"N={h.shape[0]} B={tables[1].numel()} "
                     f"E={src.numel()} kept={n_kept} R={w.shape[0]} d={d}",
            "max_abs_err": max(err_h, err_w), "err_dh": err_h,
            "err_dw": err_w, "bitwise": bitwise,
            "ms": time_ms(lambda: spmm_bwd(*bargs, tables=tables), dev),
            "in_call_ms": time_ms(lambda: spmm_bwd(*bargs), dev),
            "plain_ms": time_ms(lambda: spmm_bwd_plain(*flat), dev),
            "library_ms": time_ms(library, dev),
            "bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations"}
        print(f"  K1b {tag}: {out[tag]}", flush=True)
    return out


_COTANGENTS = ("dh0x", "dwrel", "dloop1", "dloop2", "dwih1", "dwhh1",
               "dwih2", "dwhh2", "dbih1", "dbhh1", "dbih2", "dbhh2")


def _window_bwd_bound(ctx, win, extra_bytes: int = 0) -> dict:
    """Least time for one K2b call: f32 flops over the active rows (per row
    and layer two GRU gate products and one self-loop product recomputed,
    and for each of them the input and the weight cotangent products:
    84 d^2 a row) and the SpMMs and their transposes over the real edges
    (16 d an edge), against the buffers, masks and cotangents read once
    and dh0x written once (and `extra_bytes`): "bound_ms" at f32's rate,
    "bound_tc_ms" at 3xTF32's, the rate of K2b's products."""
    L1, d = ctx["L1"], ctx["d"]
    rows = int(win.act_mask[:, :L1].sum())
    edges = int(win.emask[:, :L1].sum())
    flops = rows * 84 * d * d + edges * 16 * d
    n_rel = ctx["params"]["encoder"]["layer1"]["weight"].shape[0]
    w_bytes = (4 * d * 3 * d * 2 + 2 * d * d * 2 + n_rel * 2 * d * 2) * 4
    nbytes = (rows * d * 4 * 8 + edges * 16 + rows * 12 + w_bytes
              + extra_bytes)
    return _bounds(flops, nbytes)


def _bounds(flops: float, nbytes: float) -> dict:
    """The least time of a kernel whose products run in 3xTF32: at f32's
    rate (every kernel's bound, comparable across the table) and at
    3xTF32's, each the larger of the operations' and the bytes' time."""
    bound_ms, bound_by = _bound(flops, nbytes)
    t_b = nbytes / H100_BYTES_S
    return {"bound_ms": bound_ms, "bound_by": bound_by,
            "bound_tc_ms": max(t_b, flops / H100_TF32X3_FLOPS) * 1e3}


def _bitwise(a, b) -> bool:
    """Two runs' outputs (tuples, None where a cotangent is not given)
    equal bit for bit."""
    import torch

    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))




def phase_k2b(ctx) -> dict:
    """K2f in train mode and K2b against autograd through the plain forward
    on the first training-shaped batch of windows, seeded masks and
    cotangents."""
    import torch

    from temp_tpu_torch.ops.fused_window import (
        fused_window_bwd, fused_window_bwd_plain, fused_window_fwd,
        fused_window_fwd_plain, window_args,
    )

    dev, p, cfg = ctx["device"], ctx["params"], ctx["cfg"]
    win, kw = window_batch(ctx, False)
    kw.pop("conv1_in")
    B, L1, A, d = kw["h0_xs"].shape
    keep = 1.0 - cfg.dropout
    gen = torch.Generator(device=dev).manual_seed(0)
    m1, m2 = ((torch.rand(B, L1, A, d, generator=gen, device=dev) < keep)
              .to(torch.float32) / keep for _ in range(2))
    gb1, gb2 = (torch.randn(B, L1, A, d, generator=gen, device=dev)
                for _ in range(2))
    a = window_args(p["encoder"], cfg, masks=(m1, m2), **kw)
    fwd_args = dict(a, conv1_in=False)
    k1, k2 = fused_window_fwd(**fwd_args)
    r1, r2 = fused_window_fwd_plain(**fwd_args)
    err_fwd = max(max_err(k1, r1), max_err(k2, r2))
    fwd_bitwise = _bitwise((k1, k2), fused_window_fwd(**fwd_args))
    if not (err_fwd <= TOL and fwd_bitwise):
        raise AssertionError(f"K2f train: max abs err {err_fwd} > {TOL}, or "
                             f"two runs differ (bit-equal: {fwd_bitwise})")
    bwd_args = dict(a, buf1=k1, buf2=k2, gb1=gb1, gb2=gb2)
    got = fused_window_bwd(**bwd_args)
    bitwise = _bitwise(got, fused_window_bwd(**bwd_args))
    ref = fused_window_bwd_plain(**a, gb1=gb1, gb2=gb2)
    errs = {n: rel_err(x, y) for n, x, y in zip(_COTANGENTS, got, ref)}
    bad = {n: e for n, e in errs.items() if not e <= GRAD_TOL}
    if bad or not bitwise:
        raise AssertionError(f"K2b: cotangents beyond {GRAD_TOL}: {bad}; "
                             f"two runs bit-equal: {bitwise}")
    bwd_bounds = _window_bwd_bound(ctx, win)
    shape = f"B={B} L1={L1} A={A} E={ctx['E']} d={d}"
    out = {
        "fwd": {"shape": shape, "max_abs_err": err_fwd,
                "bitwise": fwd_bitwise,
                "ms": time_ms(lambda: fused_window_fwd(**fwd_args), dev,
                              reps=5),
                "plain_ms": time_ms(lambda: fused_window_fwd_plain(
                    **fwd_args), dev, reps=3),
                "library_ms": None,
                **_window_bound(ctx, win, False, masks=True)},
        "bwd": {"shape": shape, "max_abs_err": max(errs.values()),
                "errors": errs,
                # printed beside the GRAD_TOL gate, as K5's
                "scaled_errs": scaled_errs(zip(_COTANGENTS, got, ref),
                                           tol=None),
                "bitwise": bitwise,
                "ms": time_ms(lambda: fused_window_bwd(**bwd_args), dev,
                              reps=5),
                "plain_ms": time_ms(lambda: fused_window_bwd_plain(
                    **a, gb1=gb1, gb2=gb2), dev, reps=3),
                "library_ms": None, **bwd_bounds}}
    for r in out.values():
        r["bound_share"] = r["bound_ms"] / r["ms"]
    print(f"  K2f train: {out['fwd']}", flush=True)
    print(f"  K2b: {out['bwd']}", flush=True)
    return out


def final_batch(ctx) -> dict:
    """The inputs of K3-K5 for the first training batch of epoch 0, as the
    main path prepares them: the batch's draws, the window's history (K2f),
    the FinalGraph and the weights in the kernels' layout."""
    if "final" in ctx:
        return ctx["final"]
    import torch

    from temp_tpu_torch.models.dynamic import gather_window
    from temp_tpu_torch.ops.fused_final import final_graph, final_weights

    dev, p, cfg, model = ctx["device"], ctx["params"], ctx["cfg"], ctx["model"]
    tr = ctx["trainer"]
    t_pos, t_valid = tr.epoch_batches(0)[0]
    tp = torch.as_tensor(t_pos, device=dev).long()
    draws = model.draw_train(tr.step_generator(0, 0), tr.data, tp)
    L = cfg.train_seq_len
    with torch.no_grad():
        win = gather_window(tr.data, tp, L)
        hist1, hist2, last_pos = model.pre_forward(
            p, win, L, tp, train=True, masks=(draws["win1"], draws["win2"]))
    gr = final_graph(tr.data, model.answers, tp, draws, last_pos,
                     cfg.inv_temperature, model.lc2.dropout, L,
                     cfg.use_embed_for_non_active)
    h0, wrel, loop1, loop2, g1, g2, rtab = final_weights(p)
    ctx["final"] = {
        "t_pos": [int(t) for t in t_pos],
        "tv_host": [bool(v) for v in t_valid], "tv": torch.as_tensor(
            t_valid, device=dev, dtype=torch.float32),
        "draws": draws, "gr": gr, "hist1": hist1.contiguous(),
        "hist2": hist2.contiguous(), "last_pos": last_pos,
        "fwd": (h0, hist1.contiguous(), hist2.contiguous(), gr, wrel, loop1,
                loop2, g1, g2, rtab)}
    return ctx["final"]


def _bound(flops: float, nbytes: float):
    t_b, t_f = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _final_counts(ctx, fb):
    """(B, N, d, queries): the positive queries of both directions, the
    rows the score products run over."""
    B, N, d = fb["hist1"].shape
    return B, N, d, 2 * float(fb["gr"].posm.sum())


def _k3_work(ctx, fb):
    """(layer flops, score flops, bytes) of one K3 call: per element and
    layer two GRU gate products and a self-loop product over all N rows (14
    N d^2 flops), the SpMM over the kept edges (3 d an edge); per positive
    query its scores against all N rows (2 N d); against the history,
    masks, input rows and weights read once and the table and out1 written
    once."""
    B, N, d, q = _final_counts(ctx, fb)
    gr = fb["gr"]
    kept = float(gr.emf.sum())
    n_masks = 0 if gr.m1 is None else 2
    nbytes = 4 * (B * N * d * (2 + n_masks + 2) + N * d + B * N
                  + 2 * (2 * 3 * d * d + d * d) + fb["fwd"][4].numel()
                  + fb["fwd"][-1].numel())
    return (2 * B * 14 * N * d * d + 2 * kept * 3 * d, q * N * 2 * d,
            nbytes)


def _k3_layer_bytes_bf16(fb) -> float:
    """Bytes K3's two bfloat16 layer launches move at least: both
    histories (bfloat16) read once, the input embeddings, the dropout
    masks, dt, the activity, the select's rows of the inactive entities and
    the SpMM's kept edges read once (float32 and int32), out1 and the
    table written once (float32), and the weights (the self-loops and GRU
    matrices bfloat16, the biases and relation weights float32)."""
    _, _, _, gr, wrel, *_ = fb["fwd"]
    B, N, d = fb["hist1"].shape
    n_masks = 0 if gr.m1 is None else 2
    sel_rows = 0 if gr.active is None else float((gr.active <= 0).sum())
    edges = float(gr.emf.sum())
    return (2 * (2 * B * N * d + 2 * 7 * d * d)
            + 4 * ((n_masks + 2) * B * N * d + N * d + 2 * B * N
                   + sel_rows * d + wrel.numel() + 2 * 6 * d + B * N
                   + 3 * edges))


def phase_k3(ctx) -> dict:
    """K3 against its plain version on the first training batch, run twice
    (bit-equal); its two layer launches and its score launch timed apart on
    the card; beside it the unfused forward (K1, one element at a time) on
    the same batch."""
    import torch

    from temp_tpu_torch.ops.fused_final import (
        fused_final_fwd, fused_final_fwd_launchers, fused_final_fwd_plain,
    )

    dev, fb = ctx["device"], final_batch(ctx)
    args = fb["fwd"]
    loss, saved = fused_final_fwd(*args)
    ref, table, out1 = fused_final_fwd_plain(*args)
    err_loss = float(((loss - ref) / ref.abs().clamp(min=1.0)).abs().max())
    err_rows = max(max_err(saved["table"], table), max_err(saved["out1"],
                                                            out1))
    keys = [k for k in ("table", "out1", "qhat", "lse") if k in saved]
    again, saved2 = fused_final_fwd(*args)
    bitwise = _bitwise([loss] + [saved[k] for k in keys],
                       [again] + [saved2[k] for k in keys])
    if not (err_loss <= LOSS_TOL and err_rows <= TOL and bitwise
            and bool(torch.isfinite(loss).all())):
        raise AssertionError(f"K3: loss err {err_loss} > {LOSS_TOL} or rows "
                             f"err {err_rows} > {TOL}, or two runs differ "
                             f"(bit-equal: {bitwise})")
    model, data, p = ctx["model"], ctx["trainer"].data, ctx["params"]
    gr, d = fb["gr"], args[0].shape[1]
    hists = (fb["hist1"], fb["hist2"], fb["last_pos"])

    def unfused():
        return model.unfused_final_loss(p, data, fb["t_pos"], fb["tv_host"],
                                        hists, fb["draws"])

    with torch.no_grad():
        un = float(unfused())
    fused_sum = float(ref.sum())
    if not abs(un - fused_sum) <= LOSS_TOL * max(1.0, abs(fused_sum)):
        raise AssertionError(f"K3: unfused loss {un} vs plain {fused_sum}")
    layer_flops, score_flops, nbytes = _k3_work(ctx, fb)
    B, N, _, q = _final_counts(ctx, fb)
    with torch.no_grad():
        out = {"shape": f"B={B} N={N} E={gr.src.shape[1]} d={d} "
                        f"positive queries={int(q)}",
               "max_abs_err": max(err_loss, err_rows), "err_loss": err_loss,
               "err_rows": err_rows, "bitwise": bitwise,
               "ms": time_ms(lambda: fused_final_fwd(*args), dev, reps=10),
               "plain_ms": time_ms(lambda: fused_final_fwd_plain(*args), dev,
                                   reps=5),
               "unfused_ms": time_ms(unfused, dev, reps=3),
               "library_ms": None,
               **_bounds(layer_flops + score_flops, nbytes)}
        # the two layer launches and the score launch apart: the layers
        # read and write the rows, the scores read the table once
        E = gr.src.shape[1]
        parts = {"layers": _bounds(layer_flops, nbytes),
                 "scores": _bounds(score_flops,
                                   4 * (B * N * d + B * 2 * E * d))}
        launchers = (fused_final_fwd_launchers(*args) if dev.type == "cuda"
                     else (None, None))
        for (name, part), fn in zip(parts.items(), launchers):
            part["ms"] = None if fn is None else time_ms(fn, dev, reps=10)
            part["bound_share"] = (None if fn is None
                                   else part["bound_ms"] / part["ms"])
            out[name] = part
    out["bound_share"] = out["bound_ms"] / out["ms"]
    ctx["k3_saved"] = saved
    print(f"  K3: {out}", flush=True)
    return out


def phase_k4(ctx) -> dict:
    """K4 against its plain version: the same saved table and the same
    upstream cotangent (the batch's t_valid) on both sides; run twice
    (bit-equal)."""
    from temp_tpu_torch.ops.fused_final import (
        fused_final_bwd_loss, fused_final_bwd_loss_plain,
    )

    dev, fb = ctx["device"], final_batch(ctx)
    saved, gr, rtab, g = ctx["k3_saved"], fb["gr"], fb["fwd"][-1], fb["tv"]
    got = fused_final_bwd_loss(saved, rtab, gr, g)
    ref = fused_final_bwd_loss_plain(saved["table"], rtab, gr, g)
    try:
        errs = scaled_errs(zip(("d_table", "d_rtab"), got, ref))
    except AssertionError as e:
        raise AssertionError(f"K4: {e}") from None
    bitwise = _bitwise(got, fused_final_bwd_loss(saved, rtab, gr, g))
    if not bitwise:
        raise AssertionError("K4: two runs differ")
    ctx["k4_ref"] = ref
    B, N, d, q = _final_counts(ctx, fb)
    # recompute the scores, then p . table and p^T . qhat: 3 products of
    # 2 N d flops per positive query; the table read and d_table written
    out = {"shape": f"B={B} N={N} E={gr.src.shape[1]} d={d} "
                    f"positive queries={int(q)}",
           "max_abs_err": max(e["abs"] for e in errs.values()),
           "errors": errs, "bitwise": bitwise,
           "ms": time_ms(lambda: fused_final_bwd_loss(saved, rtab, gr, g),
                         dev, reps=10),
           "plain_ms": time_ms(lambda: fused_final_bwd_loss_plain(
               saved["table"], rtab, gr, g), dev, reps=5),
           "library_ms": None,
           **_bounds(q * N * 2 * d * 3, 4 * 2 * B * N * d)}
    out["bound_share"] = out["bound_ms"] / out["ms"]
    print(f"  K4: {out}", flush=True)
    return out


_LAYER_COTANGENTS = ("d_h", "d_prev", "d_wrel", "d_loop", "d_wih_t",
                     "d_whh_t", "d_bih", "d_bhh")


def phase_k5(ctx) -> dict:
    """K5 against its plain version for layer 2, then layer 1, each given
    the same output cotangent on both sides (the plain chain's): once from
    the loss's d_table, once from a unit-scale random cotangent; then the
    final step and loss forward and backward, fused and unfused."""
    import torch

    from temp_tpu_torch.ops.fused_final import (
        fused_final_bwd_layer, fused_final_bwd_layer_plain, select_bwd,
    )

    dev, fb = ctx["device"], final_batch(ctx)
    saved, gr = ctx["k3_saved"], fb["gr"]
    h0, hist1, hist2, _, wrel, loop1, loop2, g1, g2, _ = fb["fwd"]
    d = h0.shape[1]
    d_out2, _ = select_bwd(ctx["k4_ref"][0], gr.active)
    gen = torch.Generator(device=dev).manual_seed(5)
    d_unit = torch.randn(d_out2.shape, generator=gen, device=dev)

    pairs, layers = [], {}
    for up, d_out in (("loss", d_out2), ("unit", d_unit)):
        layer2 = (saved["out1"], hist2, gr, gr.m2, wrel, d, loop2, g2, d_out)
        ref2 = fused_final_bwd_layer_plain(*layer2)
        layer1 = (h0, hist1, gr, gr.m1, wrel, 0, loop1, g1, ref2[0])
        layers[up] = layer2, layer1
        for tag, args, ref in (("layer2", layer2, ref2),
                               ("layer1", layer1, None)):
            got = fused_final_bwd_layer(*args)
            if ref is None:
                ref = fused_final_bwd_layer_plain(*args)
            pairs += [(f"{up} {tag} {n}", x, y)
                      for n, x, y in zip(_LAYER_COTANGENTS, got, ref)]
    try:
        errs = scaled_errs(pairs)
    except AssertionError as e:
        raise AssertionError(f"K5: {e}") from None
    layer2, layer1 = layers["loss"]
    bitwise = all(_bitwise(fused_final_bwd_layer(*args),
                           fused_final_bwd_layer(*args))
                  for args in (layer2, layer1))
    if not bitwise:
        raise AssertionError("K5: two runs differ")
    B, N, _, _ = _final_counts(ctx, fb)
    # per layer and row: the layer forward recomputed (14 d^2) and the
    # input, history and weight cotangent products (28 d^2); the inputs,
    # history, mask and output cotangent read, d_h and d_prev written
    n_masks = 0 if gr.m1 is None else 1
    bounds = _bounds(2 * B * N * 42 * d * d,
                     2 * 4 * B * N * d * (5 + n_masks))

    def both_layers(fn, **kw):
        return lambda: (fn(*layer2, **kw), fn(*layer1, **kw))

    # timed as the training backward calls it, with the forward's CSRs
    out = {"shape": f"B={B} N={N} E={gr.src.shape[1]} d={d}, both layers",
           "max_abs_err": max(e["abs"] for e in errs.values()),
           "errors": errs,
           "ms": time_ms(both_layers(fused_final_bwd_layer,
                                     csr=saved.get("csr")), dev, reps=10),
           "plain_ms": time_ms(both_layers(fused_final_bwd_layer_plain), dev,
                               reps=5),
           "library_ms": None, "bitwise": bitwise, **bounds}
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out.update(final_step_ms(ctx, fb))
    print(f"  K5: {out}", flush=True)
    return out


def final_step_ms(ctx, fb) -> dict:
    """The final step and loss of the batch, forward and backward, as the
    fused path (K3-K5) and as the unfused path (K1f/K1b, one element at a
    time) run them, from the same history and draws."""
    import torch

    from temp_tpu_torch.ops.fused_final import fused_final_loss
    from temp_tpu_torch.train.optim import param_leaves

    dev, model, data = ctx["device"], ctx["model"], ctx["trainer"].data
    params = {k: v for k, v in ctx["params"].items()}
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    h1 = fb["hist1"].clone().requires_grad_(True)
    h2 = fb["hist2"].clone().requires_grad_(True)
    tv = fb["tv"]

    def fused():
        loss = (fused_final_loss(params, fb["gr"], h1, h2) * tv).sum()
        torch.autograd.grad(loss, leaves + [h1, h2], allow_unused=True)

    def unfused():
        loss = model.unfused_final_loss(params, data, fb["t_pos"],
                                        fb["tv_host"],
                                        (h1, h2, fb["last_pos"]),
                                        fb["draws"])
        torch.autograd.grad(loss, leaves + [h1, h2], allow_unused=True)

    try:
        return {"final_step_fused_ms": time_ms(fused, dev, reps=5),
                "final_step_unfused_ms": time_ms(unfused, dev, reps=3)}
    finally:
        for t in leaves:
            t.requires_grad_(False)


_PATHS = (("fused", {}), ("unfused", {"fused_final": False}),
          ("plain", {"kernels": False}))


def _train_kernels(flagship: bool, mb: bool = False) -> dict:
    """The kernels each kernel path of training must launch on the card:
    GRRGCN's (K1, K2, K3-K5) or the flagship's (K1, K2, K6-K10 with K4);
    with `mb` the fused path's windows through K12."""
    if flagship:
        final = ("bi_layer_fwd", "bi_loss_fwd", "fused_final_bwd_loss",
                 "bi_layer_bwd")
    else:
        final = ("fused_final_fwd", "fused_final_bwd_loss",
                 "fused_final_bwd_layer")
    window = "fused_window_mb_fwd" if mb else "fused_window_fwd"
    return {"fused": (window, "fused_window_bwd") + final,
            "unfused": ("spmm_fwd", "spmm_bwd", "fused_window_fwd",
                        "fused_window_bwd")}


def _train_path(ctx, c):
    """The first steps of epoch 0 (TRAIN_STEPS) of config c from the seeded
    weights and draws, every launch counter from 0. Returns (model, result:
    losses, ms a step and launches; initial and final parameter leaves;
    trainer; params)."""
    import torch

    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer
    from temp_tpu_torch.train.optim import param_leaves

    dev = ctx["device"]
    model = get_model(c, ctx["data"], device=dev)
    tr = Trainer(c, model, ctx["data"], mesh=ctx.get("mesh"))
    params, opt = tr.init_state()
    init = [t.detach().clone() for t in param_leaves(params)]
    batches = tr.epoch_batches(0)[:ctx.get("train_steps", TRAIN_STEPS)]
    _reset_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    base = _allocated_mb(dev)
    t0 = time.perf_counter()
    losses = [tr.train_step(params, opt, t_pos, t_valid,
                            gen=tr.step_generator(0, i))
              for i, (t_pos, t_valid) in enumerate(batches)]
    losses = torch.stack(losses).cpu().tolist()
    wall = time.perf_counter() - t0
    res = {"losses": losses, "ms_per_step": wall * 1e3 / len(batches),
           "launches": _counts(), "csr_builds": _csr_builds(),
           "k1_csr_builds": _k1_csr_builds(), "peak_mb": _peak_mb(dev),
           "peak_rise_mb": _rise_mb(dev, base)}
    finals = [t.detach().clone() for t in param_leaves(params)]
    return model, res, init, finals, tr, params


def phase_train(ctx, flagship: bool = False) -> dict:
    """A few optimizer steps at the full config on three paths from the
    same seeded weights and draws: the kernels with fused_final on (the
    main path), the kernels with fused_final off, and the plain versions;
    each path's launches counted from 0; then one valid sweep of the
    weights the main path trained. `flagship`: the flagship's context and
    kernels. Keeps the main path's losses and parameters in ctx
    ("train_ref") for the phases that switch more on."""
    import numpy as np
    import torch

    dev, cfg = ctx["device"], ctx["cfg"]
    want = _train_kernels(flagship)
    res, trained, init, finals = {}, None, None, {}
    for name, over in _PATHS:
        model, res[name], leaves, finals[name], tr, params = _train_path(
            ctx, cfg.replace(**over))
        if model.fused_final_on() != (name != "unfused"):
            raise AssertionError(f"train {name}: fused_final resolved "
                                 f"{model.fused_final_on()}")
        if init is None:
            init = leaves
        elif not all(torch.equal(a, b) for a, b in zip(leaves, init)):
            raise AssertionError(f"train {name}: other initial weights")
        print(f"  train {name}: {res[name]}", flush=True)
        if name == "fused":
            trained = (tr, params)
    ctx["train_ref"] = {"losses": res["fused"]["losses"], "init": init,
                        "params": finals["fused"]}
    gaps = {}
    for a, b in (("fused", "plain"), ("fused", "unfused"),
                 ("unfused", "plain")):
        x, y = np.array(res[a]["losses"]), np.array(res[b]["losses"])
        if not np.isfinite(x).all():
            raise AssertionError(f"train {a}: losses not finite: {x}")
        gaps[f"{a}/{b}"] = float(np.max(np.abs(x - y)
                                        / np.maximum(1.0, np.abs(y))))
    res["max_rel_gaps"] = gaps
    if not all(g <= TRAIN_TOL for g in gaps.values()):
        raise AssertionError(f"train: loss trajectories differ: {gaps} > "
                             f"{TRAIN_TOL}")
    res["params"] = param_gaps(init, finals)
    print(f"  train params: {res['params']}", flush=True)
    for name, kernels in want.items():
        n = res[name]["launches"]
        if dev.type == "cuda" and not all(n[k] > 0 for k in kernels):
            raise AssertionError(f"train {name} missed a kernel: {n}")
        if dev.type == "cuda" and res[name]["k1_csr_builds"]:
            raise AssertionError(f"train {name}: K1 sorted "
                                 f"{res[name]['k1_csr_builds']} calls' "
                                 f"edges (every call names the data's "
                                 f"tables)")
    for name in ("plain",) + (tuple(want) if dev.type == "cpu" else ()):
        if any(res[name]["launches"].values()):
            raise AssertionError(f"train {name}: kernels launched on the "
                                 f"plain versions' path: "
                                 f"{res[name]['launches']}")
    tr, params = trained
    m = tr.run_eval(params, "valid")
    if not (np.isfinite(m["mrr"]) and 0.0 < m["mrr"] <= 1.0
            and m["n"] == 2 * int(ctx["data"].valid.emask.sum())):
        raise AssertionError(f"eval after training: {m}")
    res["eval"] = m
    print(f"  train eval: {m}", flush=True)
    return res


def param_gaps(init, finals, names=("fused", "unfused", "plain"),
               tol=PARAM_TOL) -> dict:
    """For each pair of the training paths `names` (the last the plain
    path) and each leaf, |a - b| / |plain - init| (norms; the plain path's
    change to that leaf); raises where a leaf's gap exceeds `tol` of its
    change (a leaf the plain path left as it was must agree exactly).
    Beside it, for reading only, the same ratio of the largest entries."""
    plain = names[-1]
    change = [(f - i) for f, i in zip(finals[plain], init)]
    norms = [float(c.norm()) for c in change]
    gaps, maxes, bad = {}, {}, {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            worst = worst_max = 0.0
            for k, (x, y, c, n) in enumerate(zip(finals[a], finals[b],
                                                 change, norms)):
                gap = float((x - y).norm())
                if not gap <= tol * n:
                    bad[f"{a}/{b} leaf {k}"] = {"gap": gap, "change": n}
                if n > 0:
                    worst = max(worst, gap / n)
                    worst_max = max(worst_max, float((x - y).abs().max())
                                    / float(c.abs().max()))
            gaps[f"{a}/{b}"] = worst
            maxes[f"{a}/{b}"] = worst_max
    if bad:
        raise AssertionError(f"train: parameters differ beyond {tol} "
                             f"of the plain path's change: {bad}")
    return {"max_rel_gaps": gaps, "max_entry_gaps": maxes,
            "largest_change": max(norms), "smallest_change": min(norms)}


# -- bfloat16 (compute_dtype="bfloat16"): K2f, K2b, K3, K4, K5 ---------------

# the card's dense bfloat16 tensor-core rate (the bound of the bfloat16
# modes) and its TF32 rate (the ceiling of their design: one TF32 product of
# bfloat16-rounded operands a k8 step), SXM data sheet
H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12
# a bfloat16 mode against its plain version: RMS(kernel - plain) at most
# this share of RMS(plain float32 - plain bfloat16) on the same inputs, the
# distance between the two precisions being the yardstick (the kernel and
# the plain version round at the same points and differ by float32 sums in
# another order, and where one lands on a bfloat16 rounding boundary)
BF16_RULE = 0.1


def _rms(x) -> float:
    return float(x.double().pow(2).mean().sqrt()) if x.numel() else 0.0


def bf16_rule(pairs, what: str) -> dict:
    """{name: RMS(kernel - plain bf16) / RMS(plain f32 - plain bf16)} over
    (name, kernel, plain bf16, plain f32) quadruples; raises where a ratio
    exceeds BF16_RULE (a yardstick of 0 needs an exact match)."""
    import torch

    ratios, bad = {}, {}
    for n, k, pb, pf in pairs:
        k, pb, pf = (t.detach().to(torch.float32) for t in (k, pb, pf))
        gap, yard = _rms(k - pb), _rms(pf - pb)
        ratios[n] = gap / yard if yard else (0.0 if gap == 0 else math.inf)
        if not gap <= BF16_RULE * yard:
            bad[n] = {"gap": gap, "yard": yard}
    if bad:
        raise AssertionError(f"{what}: beyond {BF16_RULE} of the bfloat16 - "
                             f"float32 distance: {bad}")
    return ratios


def _bf16_bounds(flops: float, nbytes: float) -> dict:
    """The least time of a bfloat16 mode: the larger of its bytes (bfloat16
    buffers) over the card's memory rate and its operations over the dense
    bfloat16 rate ("bound_ms"), and the same at the TF32 rate of its
    design ("bound_tf32_ms")."""
    t_b = nbytes / H100_BYTES_S
    t_f = flops / H100_BF16_FLOPS
    return {"bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "bound_tf32_ms": max(t_b, flops / H100_TF32_FLOPS) * 1e3}


def _bf16_case(kernel, plain_bf, plain_f32, errs: dict, flops, nbytes,
               shape, dev, reps=5, plain_reps=3) -> dict:
    """One bfloat16 mode's record: its errors, times and bounds."""
    out = {"shape": shape, "max_abs_err": max(e["abs"] for e in
                                              errs["abs"].values()),
           "rms_ratio": max(errs["ratio"].values()),
           "rms_ratios": errs["ratio"],
           "ms": time_ms(kernel, dev, reps=reps),
           "plain_ms": time_ms(plain_bf, dev, reps=plain_reps),
           "plain_f32_ms": time_ms(plain_f32, dev, reps=plain_reps),
           "library_ms": None, **_bf16_bounds(flops, nbytes)}
    out["bound_share"] = out["bound_ms"] / out["ms"]
    return out


def _bits_differ(a, b) -> int:
    """The entries where two tensors of one dtype and size differ bit for
    bit (+0 and -0 differ)."""
    import torch

    it = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    a, b = a.contiguous().reshape(-1), b.contiguous().reshape(-1)
    return int((a.view(it[a.dtype]) != b.view(it[b.dtype])).sum())


def k3_bf16_shares(h0, h1, h2, gr, wrel, loop1, loop2, g1, g2, rtab) -> dict:
    """K3's bfloat16 layer launches against the routines of K2f's and K5's
    bfloat16 launches, on K3's arguments (h1, h2 bfloat16) without the
    select: K3's layer 2 (the table) rounded to bfloat16 against K2f's
    layer on the same rows (step k = 1 of a two-step window whose rows are
    layer 2's input rounded and whose previous states, step 0's rows, hold
    the history; K2f stores bfloat16), and K2f's conv output there against
    the one K5's GRU launch recomputes (its bfloat16 step scratch). Returns
    the entries that differ bit for bit of each pair and the entries
    compared; both counts are 0 when the three share their sums."""
    import torch

    from temp_tpu_torch import _build
    from temp_tpu_torch.ops import fused_final as ff
    from temp_tpu_torch.ops.fused_window import layer_operands

    BF = torch.bfloat16
    gr = gr._replace(active=None)
    _, saved = ff.fused_final_fwd(h0, h1, h2, gr, wrel, loop1, loop2, g1, g2,
                                  rtab, hot=BF)
    out1, table = saved["out1"], saved["table"]
    B, N, d = out1.shape
    dev = out1.device
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    f32 = dict(device=dev, dtype=torch.float32)
    rowptr, s_src, s_rel, s_em = saved["csr"][0]
    counts = (rowptr[1:] - rowptr[:-1]).reshape(B, 1, N)
    counts = torch.cat([torch.zeros_like(counts), counts], 1).reshape(-1)
    ptr2 = torch.zeros(B * 2 * N + 1, device=dev, dtype=torch.int32)
    ptr2[1:] = torch.cumsum(counts, 0).to(torch.int32)
    x = torch.zeros(B, 2, N, d, device=dev, dtype=BF)
    x[:, 1] = out1
    buf = torch.zeros(B, 2, N, d, device=dev, dtype=BF)
    buf[:, 0] = h2
    loc = torch.zeros(B, 2, N, d, device=dev, dtype=BF)
    mask = None
    if gr.m2 is not None:
        mask = torch.ones(B, 2, N, d, **f32)
        mask[:, 1] = gr.m2
    gidx = torch.arange(N, device=dev, dtype=torch.int32).expand(
        B, 2, N).contiguous()
    live = torch.ones(B, 2, N, **f32)
    dt = torch.stack([gr.dt, gr.dt], 1).contiguous()
    w = layer_operands(loop2, g2, BF, bwd=True)
    _build.check(lib.window_layer_launch_bf16(
        p(x), 0, p(ptr2), p(s_src), p(s_rel), p(s_em), p(wrel), 2 * d, d,
        p(w["loop"]), p(mask), 0, p(w["wih_t"]), p(w["whh_t"]), p(g2["bih"]),
        p(g2["bhh"]), p(gidx), p(live), p(dt), float(gr.lam), p(buf), p(loc),
        B, 2, N, d, 1, 1, stream), "window_layer_bf16")
    rows = B * N
    x2 = out1.to(BF)
    d_out, d_prev = torch.ones(B, N, d, **f32), torch.empty(B, N, d, **f32)
    n2 = torch.empty(rows, **f32)
    scr = [torch.empty(rows * d, device=dev, dtype=BF) for _ in range(2)] + [
        torch.empty(rows * n * d, **f32) for n in (3, 3, 1, 1)]
    _build.check(lib.final_bwd_gru_launch_bf16(
        p(x2), p(rowptr), p(s_src), p(s_rel), p(s_em), p(wrel), 2 * d, d,
        p(w["loop"]), p(gr.m2), p(w["wih_t"]), p(w["whh_t"]), p(g2["bih"]),
        p(g2["bhh"]), p(w["wih"]), p(w["whh"]), p(gr.dt), float(gr.lam),
        p(h2), p(d_out), p(d_prev), p(n2), *(p(t) for t in scr), B, N, d,
        stream), "final_bwd_gru_bf16")
    torch.cuda.synchronize(dev)
    return {"table_vs_k2f": _bits_differ(buf[:, 1], table.to(BF)),
            "conv_k2f_vs_k5": _bits_differ(loc[:, 1], scr[0]),
            "entries": table.numel()}


def bi_bf16_recompute(a, kw, d_out, csr=None) -> dict:
    """K6+K7's bfloat16 GRU input against K9+K10's bfloat16 recompute on
    one layer's arguments (``bi_layer_fwd``'s positional `a` and keywords
    `kw`: relu, hl, imp): the float32 GRU input K6+K7 forms
    (``bi_gru_input``) rounded to bfloat16 against the gin_s K9+K10's GRU
    launch writes, and with the ReLU the signs of K6+K7's conv output (its
    GRU input without the blend) against the ReLU's pattern K9+K10 take
    (``bi_relu_pattern``). Returns the entries that differ of each; both
    are 0 when the forward and the recompute share their sums."""
    import torch

    from temp_tpu_torch.ops import fused_final_bi as fb

    BF = torch.bfloat16
    relu, hl, imp = kw.get("relu", False), kw.get("hl"), kw.get("imp")
    gin = fb.bi_gru_input(*a, relu=relu, hl=hl, imp=imp, csr=csr, hot=BF)
    st, gru = fb._bi_bwd_prepare(*a, d_out, relu, hl, imp, csr,
                                 pattern=relu, hot=BF)
    gru()
    flips = 0
    if relu:
        conv = fb.bi_gru_input(*a, relu=True, csr=csr, hot=BF)
        flips = int(((st["relu"] > 0) != (conv > 0)).sum())
    torch.cuda.synchronize(d_out.device)
    return {"gin_vs_k9k10": _bits_differ(gin.to(BF), st["scr"]["gin"]),
            "relu_fwd_flips": flips, "entries": gin.numel()}


def window_occupancy(d: int, hot=None):
    """The window kernels' launch shapes at width d from the library's
    query (``window_occupancy``, or its bfloat16 mode's for hot): for K2f's
    layer launch and K2b's GRU, input and weight launches, the shared
    memory a block in bytes, the threads a block and the blocks an SM
    holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor). None off the
    card."""
    import ctypes

    import torch

    from temp_tpu_torch import _build

    if not torch.cuda.is_available():
        return None
    fn = getattr(_build.lib(),
                 "window_occupancy" + ("" if hot is None else "_bf16"))
    out = {}
    for which, name in enumerate(("layer", "bwd_gru", "bwd_input", "wgrad")):
        buf = (ctypes.c_int * 3)()
        _build.check(fn(which, d, ctypes.addressof(buf)), "window_occupancy")
        out[name] = {"smem_bytes": buf[0], "threads": buf[1],
                     "blocks_per_sm": buf[2]}
    return out


def _errs(pairs, what):
    """The rule's ratios and the max abs errors of (name, kernel, plain
    bf16, plain f32) quadruples."""
    pairs = list(pairs)
    return {"ratio": bf16_rule(pairs, what),
            "abs": {n: {"abs": float((k.float() - pb.float()).abs().max())}
                    for n, k, pb, _ in pairs}}


def bf16_param_ratio(kernels, plain, f32) -> float:
    """For reading: the trained parameters of a bfloat16 kernel path
    against its plain bfloat16 path, all leaves as one vector, in BF16_RULE's
    terms: RMS(kernels - plain) over RMS(float32 - plain), `f32` the float32
    run's leaves from the same weights and draws (BF16_PARAM_TOL says why
    it grows with the steps)."""
    import torch

    flat = [torch.cat([t.flatten().double().cpu() for t in v])
            for v in (kernels, plain, f32)]
    gap, yard = _rms(flat[0] - flat[1]), _rms(flat[2] - flat[1])
    return gap / yard if yard else 0.0


def phase_bf16_kernels(ctx) -> dict:
    """K2f (eval with the conv1 table, and training with dropout masks),
    K2b, K3, K4 and K5 in their bfloat16 mode at the main path's shapes,
    each against its plain bfloat16 version on the same inputs under
    BF16_RULE (the plain float32 version's distance from it the
    yardstick), with times and bounds; K3 two runs bit-equal, its layer
    launches bit for bit K2f's and K5's sums (``k3_bf16_shares``), its
    layer and score launches timed apart, its layer launch's occupancy.
    Every launch here is a check's: the counters are not read."""
    import torch

    from temp_tpu_torch.ops import fused_final as ff
    from temp_tpu_torch.ops import fused_window as fw

    BF = torch.bfloat16
    dev, p, cfg = ctx["device"], ctx["params"], ctx["cfg"]
    out = {}

    # K2f: the eval sweep's mode (conv1_in) and training's (masks)
    win, kw = window_batch(ctx, True)
    ev = fw.window_args(p["encoder"], cfg, **{k: v for k, v in kw.items()
                                             if k != "conv1_in"})
    ev = dict(ev, conv1_in=True)
    k_ev = fw.fused_window_fwd(**ev, hot=BF)
    pb_ev = fw.fused_window_fwd_plain(**ev, hot=BF)
    pf_ev = fw.fused_window_fwd_plain(**ev)
    errs = _errs(((f"buf{i + 1}", k_ev[i], pb_ev[i], pf_ev[i])
                  for i in range(2)), "K2f bf16 conv1_in")
    bitwise = {"k2f": _bitwise(k_ev, fw.fused_window_fwd(**ev, hot=BF))}
    L1, d = ctx["L1"], ctx["d"]
    n_rel = p["encoder"]["layer1"]["weight"].shape[0]
    w_bytes = (2 * d * 3 * d * 2 + 2 * d * d + n_rel * 2 * d) * 4
    shape = f"B={ctx['B']} L1={L1} A={ctx['A']} E={ctx['E']} d={d}"
    out["k2f"] = _bf16_case(
        lambda: fw.fused_window_fwd(**ev, hot=BF),
        lambda: fw.fused_window_fwd_plain(**ev, hot=BF),
        lambda: fw.fused_window_fwd_plain(**ev), errs,
        *_k2f_bf16_work(ctx, win, True, p), shape + " conv1_in", dev)

    win, kw = window_batch(ctx, False)
    kw.pop("conv1_in")
    B, L1, A, d = kw["h0_xs"].shape
    keep = 1.0 - cfg.dropout
    gen = torch.Generator(device=dev).manual_seed(0)
    masks = tuple((torch.rand(B, L1, A, d, generator=gen, device=dev) < keep)
                  .to(torch.float32) / keep for _ in range(2))
    gbs = [torch.randn(B, L1, A, d, generator=gen, device=dev).to(BF)
           for _ in range(2)]
    a = fw.window_args(p["encoder"], cfg, masks=masks, **kw)
    tr_args = dict(a, conv1_in=False)
    k_tr = fw.fused_window_fwd(**tr_args, hot=BF)
    pb_tr = fw.fused_window_fwd_plain(**tr_args, hot=BF)
    pf_tr = fw.fused_window_fwd_plain(**tr_args)
    errs = _errs(((f"buf{i + 1}", k_tr[i], pb_tr[i], pf_tr[i])
                  for i in range(2)), "K2f bf16 train")
    bitwise["k2f_train"] = _bitwise(k_tr,
                                    fw.fused_window_fwd(**tr_args, hot=BF))
    rows = int(win.act_mask[:, :L1].sum())
    edges = int(win.emask[:, :L1].sum())
    out["k2f_train"] = _bf16_case(
        lambda: fw.fused_window_fwd(**tr_args, hot=BF),
        lambda: fw.fused_window_fwd_plain(**tr_args, hot=BF),
        lambda: fw.fused_window_fwd_plain(**tr_args), errs,
        *_k2f_bf16_work(ctx, win, False, p), shape + " train", dev)

    bwd = dict(a, buf1=k_tr[0], buf2=k_tr[1], gb1=gbs[0], gb2=gbs[1])
    got = fw.fused_window_bwd(**bwd, hot=BF)
    ref_bf = fw.fused_window_bwd_plain(**a, gb1=gbs[0], gb2=gbs[1], hot=BF)
    ref_f = fw.fused_window_bwd_plain(**a, gb1=gbs[0].float(),
                                      gb2=gbs[1].float())
    errs = _errs(zip(_COTANGENTS, got, ref_bf, ref_f), "K2b bf16")
    bitwise["k2b"] = _bitwise(got, fw.fused_window_bwd(**bwd, hot=BF))
    if not all(bitwise.values()):
        raise AssertionError(f"K2 bf16: two runs differ {bitwise}")
    out["k2b"] = _bf16_case(
        lambda: fw.fused_window_bwd(**bwd, hot=BF),
        lambda: fw.fused_window_bwd_plain(**a, gb1=gbs[0], gb2=gbs[1],
                                          hot=BF),
        lambda: fw.fused_window_bwd_plain(**a, gb1=gbs[0].float(),
                                          gb2=gbs[1].float()), errs,
        rows * 84 * d * d + edges * 16 * d,
        rows * d * (4 * 4 + 4 * 2) + edges * 16 + rows * 12 + 2 * w_bytes,
        shape, dev)
    # the launch shapes of K2f's and K2b's launches (and float32's beside)
    occ = {"bf16": window_occupancy(d, BF), "f32": window_occupancy(d)}
    for tag in ("k2f", "k2f_train", "k2b"):
        out[tag].update(bitwise=bitwise[tag], occupancy=occ)

    # K3-K5 on the first training batch, its history rounded to bfloat16
    fb = final_batch(ctx)
    h0, h1, h2, gr, wrel, loop1, loop2, g1, g2, rtab = fb["fwd"]
    h1, h2 = h1.to(BF).contiguous(), h2.to(BF).contiguous()
    args = (h0, h1, h2, gr, wrel, loop1, loop2, g1, g2, rtab)
    loss, saved = ff.fused_final_fwd(*args, hot=BF)
    lb, tb, o1b = ff.fused_final_fwd_plain(*args, hot=BF)
    lf, tf, o1f = ff.fused_final_fwd_plain(*args)
    # the loss is held as float32's is: each element's is a mean over its
    # positives of log-sum-exps of 7128 scores, where bfloat16's roundings
    # average out below float32's summation noise, so the rule's yardstick
    # says nothing there; the rows take the rule
    err_loss = float(((loss - lb) / lb.abs().clamp(min=1.0)).abs().max())
    if not (err_loss <= LOSS_TOL and bool(torch.isfinite(loss).all())):
        raise AssertionError(f"K3 bf16: loss err {err_loss} > {LOSS_TOL}")
    errs = _errs((("table", saved["table"], tb, tf),
                  ("out1", saved["out1"], o1b, o1f)), "K3 bf16")
    errs["abs"]["loss"] = {"abs": float((loss - lb).abs().max())}
    layer_flops, score_flops, nbytes = _k3_work(ctx, fb)
    Bf, N, _, q = _final_counts(ctx, fb)
    keys3 = [k for k in ("table", "out1", "qhat", "lse") if k in saved]
    again = ff.fused_final_fwd(*args, hot=BF)
    if not _bitwise([loss] + [saved[k] for k in keys3],
                    [again[0]] + [again[1][k] for k in keys3]):
        raise AssertionError("K3 bf16: two runs differ")
    # its layer launches share K2f's and K5's sums bit for bit
    shares = k3_bf16_shares(*args) if dev.type == "cuda" else None
    if shares is not None and (shares["table_vs_k2f"]
                               or shares["conv_k2f_vs_k5"]):
        raise AssertionError(f"K3 bf16's layers and K2f/K5 bf16 differ: "
                             f"{shares}")
    # the history read in bfloat16; the score launch scores two query sets
    out["k3"] = _bf16_case(
        lambda: ff.fused_final_fwd(*args, hot=BF),
        lambda: ff.fused_final_fwd_plain(*args, hot=BF),
        lambda: ff.fused_final_fwd_plain(*args), errs,
        layer_flops + 2 * score_flops, nbytes - 2 * 2 * Bf * N * d,
        f"B={Bf} N={N} E={gr.src.shape[1]} d={d} "
        f"positive queries={int(q)}", dev, reps=10)
    # the layer launches (native bfloat16 products; layer 2's input
    # rounded between them) and the score launch (TF32 products of the
    # rounded operands) apart, each bound at the bfloat16 rate and at its
    # design's
    E = gr.src.shape[1]
    parts = {"layers": _mixed_bounds(
                 ((layer_flops, H100_BF16_FLOPS, H100_BF16_FLOPS),),
                 _k3_layer_bytes_bf16(fb)),
             "scores": _mixed_bounds(
                 ((2 * score_flops, H100_BF16_FLOPS, H100_TF32_FLOPS),),
                 4 * (Bf * N * d + Bf * 2 * E * d + rtab.numel()))}
    launchers = (ff.fused_final_fwd_launchers(*args, hot=BF)
                 if dev.type == "cuda" else (None, None))
    for (name, part), fn in zip(parts.items(), launchers):
        part["ms"] = None if fn is None else time_ms(fn, dev, reps=10)
        part["bound_share"] = (None if fn is None
                               else part["bound_ms"] / part["ms"])
        out["k3"][name] = part
    out["k3"].update(bitwise=True, shares=shares, launch=bf16_launch_info(
        "final_bf16_occupancy", {"layer": (3, "final_layer_kernel")},
        "fused_final_bf16.cu", d))

    g = fb["tv"]
    got = ff.fused_final_bwd_loss(saved, rtab, gr, g, hot=BF)
    ref_bf = ff.fused_final_bwd_loss_plain(saved["table"], rtab, gr, g,
                                           hot=BF)
    ref_f = ff.fused_final_bwd_loss_plain(saved["table"], rtab, gr, g)
    errs = _errs(zip(("d_table", "d_rtab"), got, ref_bf, ref_f), "K4 bf16")
    out["k4"] = _bf16_case(
        lambda: ff.fused_final_bwd_loss(saved, rtab, gr, g, hot=BF),
        lambda: ff.fused_final_bwd_loss_plain(saved["table"], rtab, gr, g,
                                              hot=BF),
        lambda: ff.fused_final_bwd_loss_plain(saved["table"], rtab, gr, g),
        errs, q * N * 2 * d * 3, 4 * 2 * Bf * N * d, out["k3"]["shape"],
        dev, reps=10)

    d_out2, _ = ff.select_bwd(ref_bf[0], gr.active)
    layer2 = (saved["out1"], h2, gr, gr.m2, wrel, d, loop2, g2, d_out2)
    l2b = ff.fused_final_bwd_layer_plain(*layer2, hot=BF)
    layer1 = (h0, h1, gr, gr.m1, wrel, 0, loop1, g1, l2b[0])
    pairs = []
    for tag, la in (("layer2", layer2), ("layer1", layer1)):
        got = ff.fused_final_bwd_layer(*la, hot=BF)
        rb = ff.fused_final_bwd_layer_plain(*la, hot=BF)
        rf = ff.fused_final_bwd_layer_plain(*la)
        pairs += [(f"{tag} {n}", x, y, z) for n, x, y, z in
                  zip(_LAYER_COTANGENTS, got, rb, rf)]
    errs = _errs(pairs, "K5 bf16")
    n_masks = 0 if gr.m1 is None else 1

    def both(fn, **kw):
        return lambda: (fn(*layer2, **kw), fn(*layer1, **kw))

    k5 = both(ff.fused_final_bwd_layer, csr=saved.get("csr"), hot=BF)
    if not all(_bitwise(x, y) for x, y in zip(k5(), k5())):
        raise AssertionError("K5 bf16: two runs differ")
    out["k5"] = _bf16_case(
        k5, both(ff.fused_final_bwd_layer_plain, hot=BF),
        both(ff.fused_final_bwd_layer_plain), errs,
        2 * Bf * N * 42 * d * d, 2 * 4 * Bf * N * d * (4.5 + n_masks),
        f"B={Bf} N={N} E={gr.src.shape[1]} d={d}, both layers", dev,
        reps=10)
    # each launch's shared memory, threads, blocks an SM, registers, spill
    out["k5"].update(bitwise=True, launch=bf16_launch_info(
        "final_bf16_occupancy",
        {"gru": (0, "final_bwd_gru_kernel"),
         "input": (1, "final_bwd_input_kernel"),
         "weights": (2, "final_wgrad_kernel")}, "fused_final_bf16.cu", d))
    for name, r in out.items():
        print(f"  bf16 {name}: {r}", flush=True)
    return out


# the bfloat16 path's launches a training step (fused) and a valid sweep
_BF16_STEP = {"fused_window_fwd": 28, "fused_window_bwd": 72,
              "fused_final_fwd": 4, "fused_final_bwd_loss": 4,
              "fused_final_bwd_layer": 10}
_BF16_SWEEP = {"spmm_fwd": 737, "fused_window_fwd": 1288}
_NOT_BF16 = ("bi_layer_fwd", "bi_loss_fwd", "bi_layer_bwd",
             "fused_eval_ranks", "fused_window_mb_fwd", "ring_spmm_fwd",
             "ring_spmm_bwd")


def phase_bf16_path(ctx, train_res, path_res) -> dict:
    """GRRGCN with compute_dtype="bfloat16": TRAIN_STEPS training steps on
    the fused path (K2f, K2b, K3-K5) and the unfused one (K2, K1f, K1b),
    each with the kernels and with the plain versions, from the seeded
    weights and draws, then the valid sweep with the kernels and with the
    plain versions. The launches a step and a sweep (_BF16_STEP,
    _BF16_SWEEP; none of K6-K13), the losses of each kernel path within
    TRAIN_TOL of the plain versions of the same path and its trained
    parameters within PARAM_TOL of their change (``param_gaps``), beside
    them BF16_RULE's ratio of the parameters against the float32 path
    (`train_res`, the train phase's) for reading, and
    the MRR within MRR_TOL of plain or within BF16_RULE of
    the float32 sweep's distance from it (`path_res`, the path phase's);
    beside them the bfloat16 - float32 gaps of the losses and MRR, and
    each run's peak memory above what the earlier phases hold, beside
    float32's."""
    import numpy as np
    import torch

    dev, cfg = ctx["device"], ctx["cfg"].replace(compute_dtype="bfloat16")
    if cfg.hot_dtype != torch.bfloat16:
        raise AssertionError(f"bf16 path: hot dtype {cfg.hot_dtype}")
    steps = ctx.get("train_steps", TRAIN_STEPS)
    res, finals, init = {}, {}, None
    # in bfloat16 the fused final step and the unfused one are two
    # functions, as the JAX package's Pallas and XLA paths are (the fused
    # kernels round the SpMM's messages, the unfused SpMM K1 stays float32):
    # each kernel path is held to the plain versions of its own path
    for name, over in _PATHS + (("unfused_plain", {"fused_final": False,
                                                   "kernels": False}),):
        _, res[name], init, finals[name], _, _ = _train_path(
            ctx, cfg.replace(**over))
        print(f"  bf16 train {name}: {res[name]}", flush=True)
    losses = {n: torch.tensor(r["losses"], dtype=torch.float64)
              for n, r in res.items()}
    f32 = torch.tensor(train_res["plain"]["losses"], dtype=torch.float64)
    pairs = (("fused", "plain"), ("unfused", "unfused_plain"))
    # the losses and the trained parameters held as float32's are
    # (TRAIN_TOL; each leaf within PARAM_TOL of the plain path's change):
    # at these random weights bfloat16's roundings average out of each loss
    # below float32's resolution, so BF16_RULE's yardstick may be 0 there.
    # Beside them, for reading, the rule's ratio of the parameters (all
    # leaves as one vector; the float32 fused path's the yardstick)
    res["max_rel_gaps"] = {
        k: float(((losses[k] - losses[pl]).abs()
                  / losses[pl].abs().clamp(min=1.0)).max()) for k, pl in pairs}
    if not all(g <= TRAIN_TOL for g in res["max_rel_gaps"].values()):
        raise AssertionError(f"bf16 train: loss trajectories differ: "
                             f"{res['max_rel_gaps']} > {TRAIN_TOL}")
    res["params"] = {k: param_gaps(init, finals, names=(k, pl))
                     for k, pl in pairs}
    res["param_ratios"] = {
        k: bf16_param_ratio(finals[k], finals[pl], ctx["train_ref"]["params"])
        for k, pl in pairs}
    res["loss_gap_to_f32"] = float((losses["plain"] - f32).abs().max())
    res["loss_rel_gap_to_f32"] = res["loss_gap_to_f32"] / float(
        f32.abs().max())
    res["loss_gap_unfused_to_fused"] = float(
        (losses["unfused_plain"] - losses["plain"]).abs().max())
    n = res["fused"]["launches"]
    want = {k: v * steps for k, v in _BF16_STEP.items()}
    if dev.type == "cuda":
        got = {k: n[k] for k in want}
        if got != want or any(n[k] for k in _NOT_BF16) or n["spmm_fwd"]:
            raise AssertionError(f"bf16 fused train launches {n}, want "
                                 f"{want} and none of {_NOT_BF16} or K1")
        u = res["unfused"]["launches"]
        if not (u["spmm_fwd"] and u["spmm_bwd"] and u["fused_window_fwd"]
                and u["fused_window_bwd"]) or any(
                    u[k] for k in _NOT_BF16 + ("fused_final_fwd",)):
            raise AssertionError(f"bf16 unfused train launches {u}")
    for name in ("plain", "unfused_plain"):
        if any(res[name]["launches"].values()):
            raise AssertionError(f"bf16 {name} train launched kernels: "
                                 f"{res[name]['launches']}")
    runs = {}
    for name, kernels in (("kernels", True), ("plain", False)):
        m, ranks, mask = _sweep(ctx, cfg.replace(kernels=kernels))
        runs[name] = (ranks, mask)
        res[f"eval_{name}"] = m
        print(f"  bf16 path {name}: {m}", flush=True)
    k, pl = res["eval_kernels"], res["eval_plain"]
    (rk, mk), (rp, mp) = runs["kernels"], runs["plain"]
    mrr_f32 = path_res["plain"]["mrr"]
    if not (np.array_equal(mk, mp) and np.isfinite(k["mrr"])
            and 0.0 < k["mrr"] <= 1.0):
        raise AssertionError(f"bf16 sweep: masks differ or bad MRR {k}")
    mrr_tol = max(MRR_TOL, BF16_RULE * abs(mrr_f32 - pl["mrr"]))
    if not abs(k["mrr"] - pl["mrr"]) <= mrr_tol:
        raise AssertionError(f"bf16 sweep MRR kernels {k['mrr']} vs plain "
                             f"{pl['mrr']} (tolerance {mrr_tol})")
    if dev.type == "cuda":
        if (k["launches"]["spmm_fwd"], k["launches"]["fused_window_fwd"]) \
                != (_BF16_SWEEP["spmm_fwd"], _BF16_SWEEP["fused_window_fwd"]) \
                or any(k["launches"][x] for x in _NOT_BF16 + (
                    "fused_final_fwd", "spmm_bwd")):
            raise AssertionError(f"bf16 sweep launches {k['launches']}")
    if any(pl["launches"].values()):
        raise AssertionError(f"bf16 plain sweep launched kernels: "
                             f"{pl['launches']}")
    res["mrr_gap_to_f32"] = pl["mrr"] - mrr_f32
    res["mrr_kernels_gap_to_plain"] = k["mrr"] - pl["mrr"]
    res["same_rank_share"] = float(np.mean(rk[mk] == rp[mp]))
    # each run's rise above what the earlier phases hold
    res["peak_rise_mb_fused"] = res["fused"]["peak_rise_mb"]
    # the fused bfloat16 run and sweep the batched window is held to
    ctx["bf16_ref"] = {"losses": res["fused"]["losses"],
                       "params": finals["fused"], "init": init,
                       "ranks": runs["kernels"],
                       "mrr": res["eval_kernels"]["mrr"]}
    res["peak_rise_mb_fused_f32"] = train_res["fused"]["peak_rise_mb"]
    res["eval_peak_rise_mb"] = k["peak_rise_mb"]
    res["eval_peak_rise_mb_f32"] = path_res["kernels"]["peak_rise_mb"]
    return res


def phase_setup_flagship(ctx) -> dict:
    """The flagship on the same data and sizes as `ctx`:
    grid/icews14/config_bigrrgcn.json with impute on."""
    return phase_setup(ctx["device"].type, config="config_bigrrgcn.json",
                       **{**ctx["setup_kw"], "impute": True})


def flagship_window_batch(fctx, direction: str):
    """The K2 arguments of one direction's windows of the flagship's first
    training batch, as its path prepares them, with seeded dropout masks."""
    import torch

    from temp_tpu_torch.models.dynamic import gather_window

    model, data, p, cfg = (fctx["model"], fctx["trainer"].data,
                           fctx["params"], fctx["cfg"])
    dev, L1 = fctx["device"], fctx["L1"]
    t_pos, _ = fctx["trainer"].epoch_batches(0)[0]
    tp = torch.as_tensor(t_pos, device=dev).long()
    win = gather_window(data, tp, L1 + 1, backward=direction == "bwd")
    tbl = model._tables_for(direction)
    prev_step = tbl.prev_step[tp].long()
    pos = torch.arange(L1, device=dev)[None, :, None]
    B, A, d = tp.shape[0], fctx["A"], fctx["d"]
    keep = 1.0 - cfg.dropout
    gen = torch.Generator(device=dev).manual_seed(7)
    masks = tuple((torch.rand(B, L1, A, d, generator=gen, device=dev) < keep)
                  .to(torch.float32) / keep for _ in range(2))
    return win, dict(h0_xs=model._rows(p, win.act_idx[:, :L1]),
                     src=win.src_loc[:, :L1], dst=win.dst_loc[:, :L1],
                     rel=win.rel[:, :L1], emask=win.emask[:, :L1],
                     prev_step=prev_step, prev_row=tbl.prev_row[tp].long(),
                     dt=(pos - prev_step.clamp(min=0)).to(torch.float32),
                     live=prev_step >= 0, masks=masks, direction=direction,
                     activation2="relu")


def phase_k2_flagship(fctx) -> dict:
    """K2f and K2b in the flagship's modes (ReLU on layer 2, n_buf=3, either
    direction's GRUs) against their plain versions on both windows of the
    first training batch: the three buffers, and the 12 cotangents from
    random cotangents on all three."""
    import torch

    from temp_tpu_torch.ops.fused_window import (
        fused_window_bwd, fused_window_bwd_plain, fused_window_fwd,
        fused_window_fwd_plain, window_args,
    )

    dev, p, cfg = fctx["device"], fctx["params"], fctx["cfg"]
    out = {}
    for direction in ("fwd", "bwd"):
        win, kw = flagship_window_batch(fctx, direction)
        B, L1, A, d = kw["h0_xs"].shape
        gen = torch.Generator(device=dev).manual_seed(8)
        gb1, gb2, gb3 = (torch.randn(B, L1, A, d, generator=gen, device=dev)
                         for _ in range(3))
        a = window_args(p["encoder"], cfg, **kw)
        fwd_args = dict(a, conv1_in=False, n_buf=3)
        got = fused_window_fwd(**fwd_args)
        ref = fused_window_fwd_plain(**fwd_args)
        err_fwd = max(max_err(x, y) for x, y in zip(got, ref))
        fwd_bitwise = _bitwise(got, fused_window_fwd(**fwd_args))
        if not (err_fwd <= TOL and len(got) == 3 and fwd_bitwise):
            raise AssertionError(f"K2f {direction} flagship: max abs err "
                                 f"{err_fwd} > {TOL}, or two runs differ "
                                 f"(bit-equal: {fwd_bitwise})")
        bwd_args = dict(a, buf1=got[0], buf2=got[1], gb1=gb1, gb2=gb2,
                        gb3=gb3)
        cot = fused_window_bwd(**bwd_args)
        bitwise = _bitwise(cot, fused_window_bwd(**bwd_args))
        # the plain cotangents through the kernels' ReLU pattern (their
        # third buffer > 0), as K2b takes it: where layer 2's conv output
        # lies within rounding of 0 the two forwards may fall on either side
        relu = (got[2] > 0).to(torch.float32)
        cot_ref = fused_window_bwd_plain(**a, gb1=gb1, gb2=gb2, gb3=gb3,
                                         relu_mask=relu)
        flips = int(((got[2] > 0) != (ref[2] > 0)).sum())
        errs = {n: rel_err(x, y) for n, x, y in zip(_COTANGENTS, cot,
                                                     cot_ref)}
        bad = {n: e for n, e in errs.items() if not e <= GRAD_TOL}
        if bad or not bitwise:
            raise AssertionError(f"K2b {direction} flagship: cotangents "
                                 f"beyond {GRAD_TOL}: {bad}; two runs "
                                 f"bit-equal: {bitwise}")
        # the third buffer written (forward) and read (backward) once more
        buf3_bytes = B * L1 * A * d * 4
        fwd = _window_bound(fctx, win, False, masks=True,
                            extra_bytes=buf3_bytes)
        bwd = _window_bwd_bound(fctx, win, extra_bytes=buf3_bytes)
        out[direction] = {
            "shape": f"B={B} L1={L1} A={A} E={fctx['E']} d={d} n_buf=3 relu",
            "fwd_max_abs_err": err_fwd, "bwd_max_rel_err": max(errs.values()),
            "relu_flips": flips,
            "fwd_ms": time_ms(lambda: fused_window_fwd(**fwd_args), dev,
                              reps=5),
            "fwd_plain_ms": time_ms(lambda: fused_window_fwd_plain(
                **fwd_args), dev, reps=2),
            "bwd_ms": time_ms(lambda: fused_window_bwd(**bwd_args), dev,
                              reps=5),
            "bwd_plain_ms": time_ms(lambda: fused_window_bwd_plain(
                **a, gb1=gb1, gb2=gb2, gb3=gb3), dev, reps=2),
            "bwd_scaled_errs": scaled_errs(zip(_COTANGENTS, cot, cot_ref),
                                           tol=None),
            "fwd_bitwise": fwd_bitwise, "bwd_bitwise": bitwise,
            **{f"fwd_{k}": v for k, v in fwd.items()},
            **{f"bwd_{k}": v for k, v in bwd.items()}}
        r = out[direction]
        for part in ("fwd", "bwd"):
            r[f"{part}_bound_share"] = r[f"{part}_bound_ms"] / r[f"{part}_ms"]
        print(f"  K2 flagship {direction}: {out[direction]}", flush=True)
    return out


# impute scalars whose clamp max(w dt + b, 0) is open for some of the
# window's dt (1..7) and closed for others, so the kernel checks reach both
# branches (the seeded init may close it everywhere)
_OPEN_IMPUTE = (0.3, 0.2, -0.1, 0.5)


def final_batch_flagship(fctx) -> dict:
    """The inputs of K6-K10 for the flagship's first training batch, as its
    path prepares them: the draws, both windows' history (K2f), the BiGraph
    and the weights in the kernels' layout."""
    if "final" in fctx:
        return fctx["final"]
    import torch

    from temp_tpu_torch.ops.fused_final import final_csr
    from temp_tpu_torch.ops.fused_final_bi import bi_weights, final_graph_bi

    dev, p, cfg, model = (fctx["device"], fctx["params"], fctx["cfg"],
                          fctx["model"])
    tr = fctx["trainer"]
    t_pos, t_valid = tr.epoch_batches(0)[0]
    tp = torch.as_tensor(t_pos, device=dev).long()
    draws = model.draw_train(tr.step_generator(0, 0), tr.data, tp)
    L = cfg.train_seq_len
    with torch.no_grad():
        h1f, h2f, hlf, lpf, h1b, h2b, hlb, lpb = model.batch_hists(
            p, tr.data, tp, L, draws)
    bg = final_graph_bi(tr.data, model.answers, tp, draws, lpf, lpb,
                        cfg.inv_temperature, model.lc2.dropout, L, True,
                        cfg.use_embed_for_non_active)
    h0, wrel, loop1, loop2, grus, rtab, _ = bi_weights(p)
    imp = torch.tensor(_OPEN_IMPUTE, device=dev)
    N, d = h0.shape
    fctx["final"] = {
        "t_pos": [int(t) for t in t_pos],
        "tv_host": [bool(v) for v in t_valid], "tv": torch.as_tensor(
            t_valid, device=dev, dtype=torch.float32),
        "draws": draws, "bg": bg, "lp": (lpf, lpb),
        "hists": tuple(h.contiguous() for h in (h1f, h2f, hlf, h1b, h2b,
                                                hlb)),
        "h0x": h0.expand(len(t_pos), N, d).contiguous(), "h0": h0,
        "wrel": wrel, "loops": (loop1, loop2), "grus": grus, "rtab": rtab,
        "imp": imp,
        "csr": final_csr(bg.gr, N, max(wrel.shape[0], rtab.shape[0]))}
    return fctx["final"]


def _bi_layer_args(fb_, layer: int, h_in=None):
    """(positional, keyword) arguments of bi_layer_fwd/_bwd (less d_out) for
    one layer of the flagship's final step."""
    h1f, h2f, hlf, h1b, h2b, hlb = fb_["hists"]
    bg, d = fb_["bg"], fb_["h0"].shape[1]
    loop1, loop2 = fb_["loops"]
    if layer == 1:
        return ((fb_["h0x"], h1f, h1b, bg, bg.gr.m1, fb_["wrel"], 0, loop1,
                 fb_["grus"]["1f"], fb_["grus"]["1b"]), {"csr": fb_["csr"]})
    return ((h_in, h2f, h2b, bg, bg.gr.m2, fb_["wrel"], d, loop2,
             fb_["grus"]["2f"], fb_["grus"]["2b"]),
            {"relu": True, "hl": (hlf, hlb), "imp": fb_["imp"],
             "csr": fb_["csr"]})


def _bi_bytes(fb_, layer: int, extra_rows: int = 0) -> int:
    """Bytes one bi layer moves at least: its [B, N, d] operands (input,
    both histories, the dropout mask, layer 2's two local tables, and
    `extra_rows` more) read or written once, and the weights."""
    B, N, d = fb_["hists"][0].shape
    rows = 3 + 1 + (1 if fb_["bg"].gr.m1 is not None else 0) + extra_rows
    if layer == 2:
        rows += 2
    weights = 4 * d * 3 * d + 4 * 3 * d + d * d + fb_["wrel"].shape[0] * d
    return 4 * (rows * B * N * d + weights + 2 * B * N)


def phase_k6k7(fctx) -> dict:
    """The bi layer forward (K6+K7) of both layers against its plain
    version (layer 2 fed the plain layer 1's output); run twice
    (bit-equal)."""
    from temp_tpu_torch.ops.fused_final_bi import (
        bi_layer_fwd, bi_layer_fwd_plain,
    )

    dev, fb_ = fctx["device"], final_batch_flagship(fctx)
    sel = fb_["h0x"] if fb_["bg"].noact else None
    a1, k1 = _bi_layer_args(fb_, 1)
    out1 = bi_layer_fwd(*a1, **k1)
    k1p = {k: v for k, v in k1.items() if k != "csr"}
    ref1 = bi_layer_fwd_plain(*a1, **k1p)
    a2, k2 = _bi_layer_args(fb_, 2, ref1)
    k2p = {k: v for k, v in k2.items() if k != "csr"}
    table = bi_layer_fwd(*a2, **k2, sel=sel)
    ref2 = bi_layer_fwd_plain(*a2, **k2p, sel=sel)
    try:
        errs = scaled_errs([("layer1", out1, ref1), ("layer2", table, ref2)])
    except AssertionError as e:
        raise AssertionError(f"K6+K7: {e}") from None
    bitwise = _bitwise((out1, table), (bi_layer_fwd(*a1, **k1),
                                       bi_layer_fwd(*a2, **k2, sel=sel)))
    if not bitwise:
        raise AssertionError("K6+K7: two runs differ")
    fb_["table"], fb_["out1"] = ref2, ref1
    B, N, d = ref1.shape
    kept = float(fb_["bg"].gr.emf.sum())
    # per element and layer: the self-loop (2 N d^2) and four gate
    # products (24 N d^2); the SpMM 3 d a kept edge
    flops = 2 * B * 26 * N * d * d + 2 * kept * 3 * d
    out = {"shape": f"B={B} N={N} E={fb_['bg'].gr.src.shape[1]} d={d}, both "
                    f"layers",
           "max_abs_err": max(e["abs"] for e in errs.values()),
           "errors": errs, "bitwise": bitwise,
           "ms": time_ms(lambda: (bi_layer_fwd(*a1, **k1),
                                  bi_layer_fwd(*a2, **k2, sel=sel)), dev,
                         reps=10),
           "plain_ms": time_ms(lambda: (
               bi_layer_fwd_plain(*a1, **k1p),
               bi_layer_fwd_plain(*a2, **k2p, sel=sel)), dev, reps=5),
           "library_ms": None,
           **_bounds(flops, _bi_bytes(fb_, 1) + _bi_bytes(fb_, 2))}
    out["bound_share"] = out["bound_ms"] / out["ms"]
    print(f"  K6+K7: {out}", flush=True)
    return out


def phase_k8(fctx) -> dict:
    """The loss from the flagship's table (K8) against its plain version;
    keeps K8's saved residuals for K4."""
    from temp_tpu_torch.ops.fused_final import _loss_plain
    from temp_tpu_torch.ops.fused_final_bi import bi_loss_fwd

    dev, fb_ = fctx["device"], final_batch_flagship(fctx)
    table, gr, rtab = fb_["table"], fb_["bg"].gr, fb_["rtab"]
    loss, saved = bi_loss_fwd(table, rtab, gr, fb_["csr"])
    ref = _loss_plain(table, rtab, gr)
    try:
        errs = scaled_errs([("loss", loss, ref)])
    except AssertionError as e:
        raise AssertionError(f"K8: {e}") from None
    again, saved2 = bi_loss_fwd(table, rtab, gr, fb_["csr"])
    keys = [k for k in ("qhat", "lse") if k in saved]
    bitwise = _bitwise([loss] + [saved[k] for k in keys],
                       [again] + [saved2[k] for k in keys])
    if not bitwise:
        raise AssertionError("K8: two runs differ")
    fb_["saved"] = dict(saved, out1=fb_["out1"], h0x=fb_["h0x"])
    B, N, d = table.shape
    q = 2 * float(gr.posm.sum())
    out = {"shape": f"B={B} N={N} E={gr.src.shape[1]} d={d} "
                    f"positive queries={int(q)}",
           "max_abs_err": errs["loss"]["abs"], "errors": errs,
           "bitwise": bitwise,
           "ms": time_ms(lambda: bi_loss_fwd(table, rtab, gr, fb_["csr"]),
                         dev, reps=10),
           "plain_ms": time_ms(lambda: _loss_plain(table, rtab, gr), dev,
                               reps=5),
           "library_ms": None,
           **_bounds(q * N * 2 * d, 4 * (B * N * d + rtab.numel()))}
    print(f"  K8: {out}", flush=True)
    return out


_BI_COTANGENTS = ("d_h", "d_prev_f", "d_prev_b", "d_hl_f", "d_hl_b", "d_imp",
                  "d_wrel", "d_loop", "d_wih_f", "d_whh_f", "d_bih_f",
                  "d_bhh_f", "d_wih_b", "d_whh_b", "d_bih_b", "d_bhh_b")


def phase_k9k10(fctx) -> dict:
    """The bi layer backward (K9+K10) against its plain version for layer 2,
    then layer 1, each given the same output cotangent on both sides: once
    the loss's (K4's plain d_table through the select), once a unit-scale
    random one; then the final step and loss forward and backward, fused
    and unfused."""
    import torch

    from temp_tpu_torch.ops.fused_final import (
        fused_final_bwd_loss_plain, select_bwd,
    )
    from temp_tpu_torch.ops.fused_final_bi import (
        _rows_plain, bi_bwd_gru_launcher, bi_layer_bwd, bi_layer_bwd_plain,
        bi_relu_pattern,
    )

    dev, fb_ = fctx["device"], final_batch_flagship(fctx)
    bg = fb_["bg"]
    d_table, _ = fused_final_bwd_loss_plain(fb_["table"], fb_["rtab"], bg.gr,
                                            fb_["tv"])
    d_out2, _ = select_bwd(d_table, bg.gr.active if bg.noact else None)
    gen = torch.Generator(device=dev).manual_seed(9)
    d_unit = torch.randn(d_out2.shape, generator=gen, device=dev)
    pairs, calls = [], {}
    # layer 2's plain version through the kernels' ReLU pattern: where its
    # conv output lies within rounding of 0 the kernel's recompute and the
    # plain conv may fall on either side
    a2, k2 = _bi_layer_args(fb_, 2, fb_["out1"])
    relu2 = bi_relu_pattern(*a2, d_unit, **k2)
    conv2 = _rows_plain(*a2[:8], True, k2["hl"], k2["imp"])[0]
    flips = 0 if relu2 is None else int(((relu2 > 0) != (conv2 > 0)).sum())
    for up, d_out in (("loss", d_out2.contiguous()), ("unit", d_unit)):
        k2p = {k: v for k, v in k2.items() if k != "csr"}
        k2p["relu_mask"] = relu2
        ref2 = bi_layer_bwd_plain(*a2, d_out, **k2p)
        a1, k1 = _bi_layer_args(fb_, 1)
        k1p = {k: v for k, v in k1.items() if k != "csr"}
        calls[up] = ((a2, d_out, k2, k2p), (a1, ref2[0], k1, k1p))
        for tag, (a, g, k, kp) in (("layer2", calls[up][0]),
                                   ("layer1", calls[up][1])):
            got = bi_layer_bwd(*a, g, **k)
            ref = ref2 if tag == "layer2" else bi_layer_bwd_plain(*a, g, **kp)
            pairs += [(f"{up} {tag} {n}", x, y) for n, x, y in
                      zip(_BI_COTANGENTS, got, ref) if y is not None]
    try:
        errs = scaled_errs(pairs)
    except AssertionError as e:
        raise AssertionError(f"K9+K10: {e}") from None
    bitwise = all(_bitwise(bi_layer_bwd(*a, g, **k), bi_layer_bwd(*a, g, **k))
                  for a, g, k, _ in calls["loss"])
    if not bitwise:
        raise AssertionError("K9+K10: two runs differ")
    B, N, d = fb_["hists"][0].shape
    kept = float(bg.gr.emf.sum())
    # per layer and element: the forward recomputed (26 N d^2), the input,
    # history and weight cotangent products of both GRUs (48 N d^2) and of
    # the self-loop (4 N d^2); the SpMM's transpose 6 d a kept edge
    flops = 2 * B * 78 * N * d * d + 2 * kept * 6 * d
    nbytes = _bi_bytes(fb_, 1, extra_rows=4) + _bi_bytes(fb_, 2, extra_rows=6)
    (a2, g2, k2, k2p), (a1, g1, k1, k1p) = calls["loss"]
    out = {"shape": f"B={B} N={N} E={bg.gr.src.shape[1]} d={d}, both layers",
           "max_abs_err": max(e["abs"] for e in errs.values()),
           "errors": errs,
           "ms": time_ms(lambda: (bi_layer_bwd(*a2, g2, **k2),
                                  bi_layer_bwd(*a1, g1, **k1)), dev,
                         reps=10),
           "plain_ms": time_ms(lambda: (bi_layer_bwd_plain(*a2, g2, **k2p),
                                        bi_layer_bwd_plain(*a1, g1, **k1p)),
                               dev, reps=3),
           "library_ms": None, **_bounds(flops, nbytes), "bitwise": bitwise,
           "relu_flips": flips}
    out["bound_share"] = out["bound_ms"] / out["ms"]
    # the GRU launch (bi_bwd_gru_kernel) of both layers alone: the forward
    # recomputed (26 N d^2 a layer and element) and the transposed gate
    # products of both GRUs (24 N d^2), against its reads (d_out and, on
    # layer 2, both local tables, beside the layer's inputs) and writes
    # (both previous states' cotangents, the GRU input, both h0g, the four
    # gate cotangents of 3d, d_conv and d_lp; on layer 2 both local tables'
    # cotangents). Timed on the card only: it has no plain counterpart
    out.update({f"gru_{k}": v for k, v in _bounds(
        2 * B * 50 * N * d * d + 2 * kept * 3 * d,
        _bi_bytes(fb_, 1, extra_rows=19)
        + _bi_bytes(fb_, 2, extra_rows=21)).items()})
    out["gru_ms"] = out["gru_bound_share"] = None
    if dev.type == "cuda":
        gru = [bi_bwd_gru_launcher(*a, g, **k) for a, g, k in
               ((a2, g2, k2), (a1, g1, k1))]
        out["gru_ms"] = time_ms(lambda: [f() for f in gru], dev, reps=10)
        out["gru_bound_share"] = out["gru_bound_ms"] / out["gru_ms"]
    out.update(flagship_step_ms(fctx, fb_))
    print(f"  K9+K10: {out}", flush=True)
    return out


def flagship_step_ms(fctx, fb_) -> dict:
    """The flagship's final step and loss of the batch, forward and
    backward, fused (K6-K10 with K4) and unfused (K1f/K1b, one element at a
    time), from the same history and draws."""
    import torch

    from temp_tpu_torch.ops.fused_final_bi import fused_final_bi_loss
    from temp_tpu_torch.train.optim import param_leaves

    dev, model, data = fctx["device"], fctx["model"], fctx["trainer"].data
    params = dict(fctx["params"])
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    hs = [h.clone().requires_grad_(True) for h in fb_["hists"]]
    lpf, lpb = fb_["lp"]
    tv = fb_["tv"]

    def fused():
        loss = (fused_final_bi_loss(params, fb_["bg"], hs) * tv).sum()
        torch.autograd.grad(loss, leaves + hs, allow_unused=True)

    def unfused():
        h1f, h2f, hlf, h1b, h2b, hlb = hs
        loss = model.unfused_final_loss(
            params, data, fb_["t_pos"], fb_["tv_host"],
            (h1f, h2f, hlf, lpf, h1b, h2b, hlb, lpb), fb_["draws"])
        torch.autograd.grad(loss, leaves + hs, allow_unused=True)

    try:
        return {"final_step_fused_ms": time_ms(fused, dev, reps=5),
                "final_step_unfused_ms": time_ms(unfused, dev, reps=2)}
    finally:
        for t in leaves:
            t.requires_grad_(False)


# -- the switches that are off by default: K11 and K12 ----------------------

def eval_batch(ctx) -> dict:
    """K11's inputs for the valid split's batch of targets that
    ``window_batch`` takes, as the fused eval prepares them: the window's
    history (K2f from the conv1 table), the eval graph and queries with the
    total-table answer lists, the weights in the kernels' layout."""
    import torch

    from temp_tpu_torch.data.snapshots import build_answer_lists, to_device
    from temp_tpu_torch.ops.fused_final import (
        final_graph_eval, final_weights,
    )

    model, data, p, cfg = (ctx["model"], ctx["trainer"].data, ctx["params"],
                           ctx["cfg"])
    L, B, dev = ctx["L1"] + 1, ctx["B"], ctx["device"]
    tp = torch.arange(B, device=dev) + data.num_times // 2
    with torch.no_grad():
        hist1, hist2, last_pos = model.batch_hists(
            p, data, tp, L, conv1_all=model.precompute_eval_conv1(p, data))
    answers = to_device(build_answer_lists(ctx["data"], "valid"), dev)
    gr, q = final_graph_eval(data, answers, tp, last_pos,
                             cfg.inv_temperature, L,
                             cfg.use_embed_for_non_active, "valid")
    h0, wrel, loop1, loop2, g1, g2, rtab = final_weights(p)
    return {"tp": tp, "hists": (hist1, hist2, last_pos), "gr": gr, "q": q,
            "args": (h0, hist1.contiguous(), hist2.contiguous(), gr, q, wrel,
                     loop1, loop2, g1, g2, rtab)}


def _direction_scores(table, rtab, q, direction: str):
    """The plain version's scores [B, Q, N] of one direction, the target of
    each query and its true answers (bool [B, Q, N])."""
    import torch

    from temp_tpu_torch.ops.membership import true_answer_mask
    from temp_tpu_torch.ops.scores import complex_all

    bidx = torch.arange(table.shape[0], device=table.device)[:, None]
    src, dst, rel = q.src.long(), q.dst.long(), q.rel.long()
    remb, N = rtab[rel], table.shape[1]
    if direction == "tail":
        sc = complex_all(table[bidx, src], remb, table, "tail")
        known = true_answer_mask(q.tail_grp, q.tail_val, src * q.r2 + rel, N)
        return sc, dst, known
    sc = complex_all(table[bidx, dst], remb, table, "head")
    known = true_answer_mask(q.head_grp, q.head_val, dst * q.r2 + rel, N)
    return sc, src, known


def near_ties(table, rtab, q, tol=SCALED_TOL):
    """[B, 2Q] bool in the [head, tail] layout: the queries whose plain
    scores hold a column other than the target, not a true answer, within
    `tol` of the row's largest |score| of the target's score (there an
    f32 sum in another order may put the column on the other side)."""
    import torch

    return torch.cat([_tied(*_direction_scores(table, rtab, q, direction),
                            tol) for direction in ("head", "tail")], -1)


def _tied(sc, target, known, tol=SCALED_TOL):
    """[..., Q] bool: the rows of scores sc [..., Q, N] that hold a column
    other than the target [..., Q], not a true answer (`known`), within
    `tol` of the row's largest |score| of the target's score."""
    import torch

    tgt = torch.gather(sc, -1, target[..., None])
    cols = torch.arange(sc.shape[-1], device=sc.device)
    other = ~known & (cols != target[..., None])
    scale = tol * sc.abs().amax(-1, keepdim=True)
    return ((sc - tgt).abs() <= scale).logical_and(other).any(-1)


def plant_copies(table, rtab, q, n_copies: int = 32):
    """The table with, for the first real query of each element (the tail
    direction on even elements, the head on odd), its target's row copied
    into the n_copies columns that score lowest for that query (not true
    answers, well below the target). Returns (table, [(b, rank column)])."""
    import torch

    planted, picks = table.clone(), []
    Q = q.src.shape[1]
    dirs = {k: _direction_scores(table, rtab, q, k) for k in ("tail", "head")}
    for b in range(table.shape[0]):
        real = torch.nonzero(q.mask[b] > 0)[:, 0]
        if real.numel() == 0:
            continue
        qi, direction = int(real[0]), ("tail", "head")[b % 2]
        sc, target, known = dirs[direction]
        row, t = sc[b, qi], int(target[b, qi])
        margin = 1e-3 * float(row.abs().max())
        ok = ~known[b, qi] & (row < row[t] - margin)
        ok[int(q.src[b, qi])] = ok[int(q.dst[b, qi])] = False
        cols = torch.nonzero(ok)[:, 0]
        cols = cols[torch.argsort(row[cols])][:n_copies]
        planted[b, cols] = table[b, t]
        picks.append((b, qi + (Q if direction == "tail" else 0)))
    return planted, picks


def phase_k11(ctx) -> dict:
    """K11 against its plain version on one eval batch at full width: ranks
    equal on every real query but the counted near-ties, the BCE to
    SCALED_TOL relative; its ranking half on a table with copies of target
    rows planted (they must not count); beside it the unfused eval of the
    batch (forward_element and eval_ranks_single, one element at a time)."""
    import torch

    from temp_tpu_torch.models.objectives import eval_ranks_single
    from temp_tpu_torch.ops.fused_final import (
        _N_SPLIT, _encoder_plain, fused_eval_ranks,
        fused_eval_ranks_launchers, fused_eval_ranks_plain, table_ranks,
        table_ranks_plain,
    )

    dev, eb = ctx["device"], eval_batch(ctx)
    args, q = eb["args"], eb["q"]
    h0, hist1, hist2, gr, _, wrel, loop1, loop2, g1, g2, rtab = args
    with torch.no_grad():
        ranks, mask, bce = fused_eval_ranks(*args)
        r_p, m_p, bce_p = fused_eval_ranks_plain(*args)
        table, _ = _encoder_plain(h0, hist1, hist2, gr, wrel, loop1, loop2,
                                  g1, g2)
        near = near_ties(table, rtab, q) & mask
        if not torch.equal(mask, m_p):
            raise AssertionError("K11: query masks differ")
        off = (ranks != r_p) & mask
        if bool((off & ~near).any()):
            raise AssertionError(f"K11: {int((off & ~near).sum())} ranks "
                                 f"differ from the plain version's away "
                                 f"from a near-tie")
        bce_err = float(((bce - bce_p).abs()
                         / bce_p.abs().clamp(min=1e-30)).max())
        if not (bce_err <= SCALED_TOL and bool(torch.isfinite(bce).all())):
            raise AssertionError(f"K11: BCE relative error {bce_err} > "
                                 f"{SCALED_TOL}")
        # planted copies of the targets' rows: the ranking half on the
        # plain table, before and after
        planted, picks = plant_copies(table, rtab, q)
        before, _, _ = table_ranks(table, rtab, q)
        after, _, _ = table_ranks(planted, rtab, q)
        moved = [(b, c) for b, c in picks
                 if int(after[b, c]) != int(before[b, c])]
        if moved or not picks:
            raise AssertionError(f"K11: planted copies counted at {moved}")
        plain_after, _, _ = table_ranks_plain(planted, rtab, q)
        plain_agrees = sum(int(plain_after[b, c]) == int(after[b, c])
                           for b, c in picks)

    model, data, p, cfg = (ctx["model"], ctx["trainer"].data, ctx["params"],
                           ctx["cfg"])
    hist1_, hist2_, last_pos = eb["hists"]
    t_host = [int(t) for t in eb["tp"]]
    ev = data.valid

    def unfused():
        return [eval_ranks_single(
            cfg, data, model.score_all, model.score_single, p["rel_embeds"],
            model.forward_element(p, data, t, hists=(hist1_[b], hist2_[b],
                                                     last_pos[b])),
            t, ev.src[t], ev.rel[t], ev.dst[t], ev.emask[t])
            for b, t in enumerate(t_host)]

    B, N, d = hist1.shape
    Q, E = q.src.shape[1], gr.src.shape[1]
    n_q = float(q.mask.sum())
    edges = float(gr.emf.sum())
    # per element two layers of 14 N d^2 (K3's count: four GRU gate
    # products and a self-loop product a row) and the SpMMs, then both
    # directions' scores of each real query against all N rows and its
    # target; the history, input rows, weights and queries read once, the
    # ranks and BCE written once. Apart, the layer launches also write
    # out1 and the table (out1 read back), and the rank launch reads the
    # table, the relation embeddings and the queries and writes the counts
    # and the targets' scores
    layer_flops = B * 2 * 14 * N * d * d + 2 * edges * 3 * d
    rank_flops = 2 * n_q * (N + 1) * 2 * d
    nbytes = 4 * (2 * B * N * d + N * d + 2 * B * N + wrel.numel()
                  + 2 * 7 * d * d + rtab.numel() + 5 * B * (E + Q)
                  + 2 * B * Q + B)
    layer_bytes = 4 * (5 * B * N * d + N * d + 2 * B * N + wrel.numel()
                       + 2 * 7 * d * d + 5 * B * E)
    rank_bytes = 4 * (B * N * d + rtab.numel() + 4 * B * Q
                      + 2 * B * _N_SPLIT * Q + B * Q)
    with torch.no_grad():
        bitwise = _bitwise((ranks, bce), fused_eval_ranks(*args)[::2])
        if not bitwise:
            raise AssertionError("K11: two runs differ")
        out = {"shape": f"B={B} N={N} E={E} Q={Q} d={d} real queries="
                        f"{int(n_q)}",
               "max_abs_err": float((bce - bce_p).abs().max()),
               "bce_rel_err": bce_err, "rank_mismatches": int(off.sum()),
               "near_ties": int(near.sum()),
               "planted": len(picks), "planted_plain_agrees": plain_agrees,
               "ms": time_ms(lambda: fused_eval_ranks(*args), dev, reps=10),
               "plain_ms": time_ms(lambda: fused_eval_ranks_plain(*args),
                                   dev, reps=5),
               "unfused_ms": time_ms(unfused, dev, reps=3),
               "library_ms": None,
               **_bounds(layer_flops + rank_flops, nbytes),
               "bitwise": bitwise}
        # the two layer launches and the rank launch apart
        parts = {"layers": _bounds(layer_flops, layer_bytes),
                 "ranks": _bounds(rank_flops, rank_bytes)}
        launchers = (fused_eval_ranks_launchers(*args)[:2]
                     if dev.type == "cuda" else (None, None))
        for (name, part), fn in zip(parts.items(), launchers):
            part["ms"] = None if fn is None else time_ms(fn, dev, reps=10)
            part["bound_share"] = (None if fn is None
                                   else part["bound_ms"] / part["ms"])
            out[name] = part
    out["bound_share"] = out["bound_ms"] / out["ms"]
    print(f"  K11: {out}", flush=True)
    return out


def phase_path_fused_eval(ctx, path: dict) -> dict:
    """The valid sweep with fused_eval on (kernels, then plain versions):
    MRR within MRR_TOL of each other and of `path`'s, the default sweep."""
    res = phase_path(ctx, fused_eval=True)
    k = res["kernels"]
    gap = abs(k["mrr"] - path["kernels"]["mrr"])
    if not gap <= MRR_TOL:
        raise AssertionError(f"fused eval MRR {k['mrr']} vs the unfused "
                             f"sweep's {path['kernels']['mrr']}")
    res["mrr_gap_to_path"] = gap
    res["k11_launches"] = k["launches"]["fused_eval_ranks"]
    return res


def phase_mb(ctx, fctx) -> dict:
    """fused_window_mb on: K12's forward against its plain version (and
    K2f's output) on a training batch of windows; 8 fused training steps of
    GRRGCN and of the flagship and a GRRGCN valid sweep, held to the runs
    of `train`, `flagship_train` and `path` without the switch."""
    import numpy as np
    import torch

    from temp_tpu_torch.ops.fused_window import (
        fused_window_fwd, window_args,
    )
    from temp_tpu_torch.ops.fused_window_mb import (
        fused_window_mb_fwd, fused_window_mb_fwd_plain,
    )

    dev, p, cfg = ctx["device"], ctx["params"], ctx["cfg"]
    win, kw = window_batch(ctx, False)
    kw.pop("conv1_in")
    B, L1, A, d = kw["h0_xs"].shape
    keep = 1.0 - cfg.dropout
    gen = torch.Generator(device=dev).manual_seed(0)
    masks = tuple((torch.rand(B, L1, A, d, generator=gen, device=dev) < keep)
                  .to(torch.float32) / keep for _ in range(2))
    fwd_args = dict(window_args(p["encoder"], cfg, masks=masks, **kw),
                    conv1_in=False)
    with torch.no_grad():
        got = fused_window_mb_fwd(**fwd_args)
        ref = fused_window_mb_fwd_plain(**fwd_args)
        k2f = fused_window_fwd(**fwd_args)
    err = max(max_err(x, y) for x, y in zip(got, ref))
    if not err <= TOL:
        raise AssertionError(f"K12: max abs err {err} > {TOL}")
    with torch.no_grad():
        res = {"k12": {
            "shape": f"B={B} L1={L1} A={A} E={ctx['E']} d={d}, train mode",
            "max_abs_err": err,
            "same_as_k2f": all(torch.equal(x, y) for x, y in zip(got, k2f)),
            "ms": time_ms(lambda: fused_window_mb_fwd(**fwd_args), dev,
                          reps=5),
            "plain_ms": time_ms(lambda: fused_window_mb_fwd_plain(
                **fwd_args), dev, reps=2),
            "library_ms": None,
            **_window_bound(ctx, win, False, masks=True)}}
        res["k12"]["bound_share"] = res["k12"]["bound_ms"] / res["k12"]["ms"]
    print(f"  K12: {res['k12']}", flush=True)

    for tag, c, flagship in (("train", ctx, False),
                             ("flagship_train", fctx, True)):
        mb_cfg = c["cfg"].replace(fused_window_mb=True)
        model, r, _, finals, _, _ = _train_path(c, mb_cfg)
        if not model.fused_window_mb_on(mb_cfg.train_seq_len, train=True):
            raise AssertionError(f"mb {tag}: the batched window is off")
        ref = c["train_ref"]
        x, y = np.array(r["losses"]), np.array(ref["losses"])
        r["loss_gap"] = float(np.max(np.abs(x - y)
                                     / np.maximum(1.0, np.abs(y))))
        r["bitwise"] = bool(np.array_equal(x, y)) and all(
            torch.equal(a, b) for a, b in zip(finals, ref["params"]))
        r["param_gap"] = max(
            float((a - b).norm()) / max(float((b - i).norm()), 1e-30)
            for a, b, i in zip(finals, ref["params"], ref["init"]))
        if not (np.isfinite(x).all() and r["loss_gap"] <= TRAIN_TOL
                and r["param_gap"] <= PARAM_TOL):
            raise AssertionError(f"mb {tag}: differs from the run without "
                                 f"the switch: {r}")
        n = r["launches"]
        want = _train_kernels(flagship, mb=True)["fused"]
        if dev.type == "cuda" and not (all(n[k] > 0 for k in want)
                                       and n["fused_window_fwd"] == 0):
            raise AssertionError(f"mb {tag} missed a kernel: {n}")
        res[tag] = r
        print(f"  mb {tag}: {r}", flush=True)

    m, ranks, mask = _sweep(ctx, cfg.replace(fused_window_mb=True))
    rk, mk = ctx["path_runs"]["kernels"]
    m["ranks_equal"] = bool(np.array_equal(mask, mk)
                            and np.array_equal(ranks[mask], rk[mk]))
    if not m["ranks_equal"]:
        raise AssertionError(f"mb eval: ranks differ from the sweep without "
                             f"the switch: {m}")
    n = m["launches"]
    if dev.type == "cuda" and not (n["fused_window_mb_fwd"] > 0
                                   and n["fused_window_fwd"] == 0):
        raise AssertionError(f"mb eval missed K12: {n}")
    res["eval"] = m
    print(f"  mb eval: {m}", flush=True)
    return res


# -- the TeMP variants: K2's two new modes, TED, and the other variants -----

# (mode, buffers, layer 2's ReLU): the unidirectional Post models' windows
# (GRRGCN's weights, L1 = 14) and BiGRRGCN's (L1 = 7, either direction)
_K2_MODES = (("a", 3, False), ("b_fwd", 2, True), ("b_bwd", 2, True))
# the kernels a path that runs its final step one element at a time must
# not launch: K3-K12 and the ring's
_NOT_UNFUSED = ("fused_final_fwd", "fused_final_bwd_loss",
                "fused_final_bwd_layer", "bi_layer_fwd", "bi_loss_fwd",
                "bi_layer_bwd", "fused_eval_ranks", "fused_window_mb_fwd",
                "ring_spmm_fwd", "ring_spmm_bwd")
_UNFUSED_TRAIN = ("spmm_fwd", "spmm_bwd", "fused_window_fwd",
                  "fused_window_bwd")
# the variants held kernels against plain at full width and this window
# length (the configs' 15 and 8 cut to keep the smoke inside its watchdog)
VARIANT_SEQ_LEN = 4
_VARIANTS = (
    ("grrgcn_impute_ensemble", "config_grrgcn.json",
     {"impute": True, "post_ensemble": True}),
    ("bigrrgcn_aggregation", "config_bigrrgcn.json",
     {"post_aggregation": True}),
    ("bigrrgcn", "config_bigrrgcn.json", {}))


def _k2_mode_case(ctx, fctx, mode: str):
    """(context, window, K2's arguments) of one mode's windows of a
    training batch with seeded dropout masks: mode "a" GRRGCN's eval batch
    of ``window_batch`` on its own weights (the Post model's windows have
    its weights and shape), "b_fwd"/"b_bwd" the flagship's first training
    batch's windows of that direction (``flagship_window_batch``)."""
    import torch

    from temp_tpu_torch.ops.fused_window import window_args

    if mode == "a":
        c = ctx
        win, kw = window_batch(ctx, False)
        kw.pop("conv1_in")
        B, L1, A, d = kw["h0_xs"].shape
        keep = 1.0 - ctx["cfg"].dropout
        gen = torch.Generator(device=ctx["device"]).manual_seed(3)
        kw["masks"] = tuple(
            (torch.rand(B, L1, A, d, generator=gen, device=ctx["device"])
             < keep).to(torch.float32) / keep for _ in range(2))
    else:
        c = fctx
        win, kw = flagship_window_batch(fctx, mode[2:])
    return c, win, window_args(c["params"]["encoder"], c["cfg"], **kw)


def phase_k2_modes(ctx, fctx) -> dict:
    """K2f and K2b in the two modes the TeMP variants add, at the smoke's
    full shape in train mode: (a) three buffers without the ReLU (the
    unidirectional Post models) and (b) two buffers with it (BiGRRGCN, both
    windows), against their plain versions: the buffers, the 12 cotangents
    from random cotangents on every buffer (mode (b)'s plain ones through
    the kernels' ReLU pattern, read from the same launches with the third
    buffer written), two runs of each bit-equal; times and bounds."""
    import torch

    from temp_tpu_torch.ops.fused_window import (
        fused_window_bwd, fused_window_bwd_plain, fused_window_fwd,
        fused_window_fwd_plain,
    )

    out = {}
    for mode, n_buf, relu in _K2_MODES:
        c, win, a = _k2_mode_case(ctx, fctx, mode)
        dev = c["device"]
        B, L1, A, d = a["h0x"].shape
        if a["act2"] != relu:
            raise AssertionError(f"K2 mode {mode}: act2 {a['act2']}")
        fwd_args = dict(a, conv1_in=False, n_buf=n_buf)
        got = fused_window_fwd(**fwd_args)
        ref = fused_window_fwd_plain(**fwd_args)
        err_fwd = max(max_err(x, y) for x, y in zip(got, ref))
        fwd_bitwise = _bitwise(got, fused_window_fwd(**fwd_args))
        if not (err_fwd <= TOL and len(got) == n_buf and fwd_bitwise):
            raise AssertionError(f"K2f mode {mode}: max abs err {err_fwd} > "
                                 f"{TOL}, or two runs differ (bit-equal: "
                                 f"{fwd_bitwise})")
        gen = torch.Generator(device=dev).manual_seed(8)
        gbs = [torch.randn(B, L1, A, d, generator=gen, device=dev)
               for _ in range(n_buf)]
        bwd_args = dict(a, buf1=got[0], buf2=got[1], gb1=gbs[0], gb2=gbs[1],
                        gb3=gbs[2] if n_buf == 3 else None)
        cot = fused_window_bwd(**bwd_args)
        bitwise = _bitwise(cot, fused_window_bwd(**bwd_args))
        relu_mask, flips = None, 0
        if relu:
            # the ReLU's pattern of these launches: the same launches with
            # the local buffer written, whose other buffers must not change
            loc = fused_window_fwd(**dict(fwd_args, n_buf=3))
            if not _bitwise(got, loc[:2]):
                raise AssertionError(f"K2f mode {mode}: the third buffer "
                                     f"changes the other two")
            relu_mask = (loc[2] > 0).to(torch.float32)
            plain_loc = fused_window_fwd_plain(**dict(fwd_args, n_buf=3))[2]
            flips = int(((loc[2] > 0) != (plain_loc > 0)).sum())
        cot_ref = fused_window_bwd_plain(**a, gb1=gbs[0], gb2=gbs[1],
                                         gb3=bwd_args["gb3"],
                                         relu_mask=relu_mask)
        errs = {n: rel_err(x, y) for n, x, y in zip(_COTANGENTS, cot,
                                                     cot_ref)}
        bad = {n: e for n, e in errs.items() if not e <= GRAD_TOL}
        if bad or not bitwise:
            raise AssertionError(f"K2b mode {mode}: cotangents beyond "
                                 f"{GRAD_TOL}: {bad}; two runs bit-equal: "
                                 f"{bitwise}")
        buf3_bytes = (n_buf - 2) * B * L1 * A * d * 4
        r = {"shape": f"B={B} L1={L1} A={A} E={c['E']} d={d} n_buf={n_buf}"
                      f"{' relu' if relu else ''}",
             "relu_flips": flips,
             "fwd": {"max_abs_err": err_fwd, "bitwise": fwd_bitwise,
                     "ms": time_ms(lambda: fused_window_fwd(**fwd_args), dev,
                                   reps=5),
                     "plain_ms": time_ms(lambda: fused_window_fwd_plain(
                         **fwd_args), dev, reps=2),
                     "library_ms": None,
                     **_window_bound(c, win, False, masks=True,
                                     extra_bytes=buf3_bytes)},
             "bwd": {"max_abs_err": max(errs.values()), "errors": errs,
                     "scaled_errs": scaled_errs(zip(_COTANGENTS, cot,
                                                    cot_ref), tol=None),
                     "bitwise": bitwise,
                     "ms": time_ms(lambda: fused_window_bwd(**bwd_args), dev,
                                   reps=5),
                     "plain_ms": time_ms(lambda: fused_window_bwd_plain(
                         **a, gb1=gbs[0], gb2=gbs[1], gb3=bwd_args["gb3"]),
                         dev, reps=2),
                     "library_ms": None,
                     **_window_bwd_bound(c, win, extra_bytes=buf3_bytes)}}
        for part in ("fwd", "bwd"):
            r[part]["bound_share"] = r[part]["bound_ms"] / r[part]["ms"]
        out[mode] = r
        print(f"  K2 mode {mode}: {r}", flush=True)
    return out


# -- bfloat16 for the flagship and the TeMP variants ------------------------

# K2's flagship modes in bfloat16: (tag, _k2_mode_case's case, buffers,
# ReLU): the flagship's two windows (three buffers and the ReLU), the
# unidirectional Post models' (mode (a), GRRGCN's eval batch of windows on
# its own weights) and BiGRRGCN's two (mode (b))
_K2_BF16_MODES = (("flagship_fwd", "b_fwd", 3, True),
                  ("flagship_bwd", "b_bwd", 3, True), ("a", "a", 3, False),
                  ("b_fwd", "b_fwd", 2, True), ("b_bwd", "b_bwd", 2, True))


def _k2_bf16_mode(ctx, fctx, tag, case, n_buf, relu) -> dict:
    """One of K2's flagship modes in bfloat16 (``phase_bf16_flagship_
    kernels``): K2f and K2b against their plain bfloat16 versions under
    BF16_RULE, two runs bit-equal; the "fwd" and "bwd" records."""
    import torch

    from temp_tpu_torch.ops import fused_window as fw

    BF = torch.bfloat16
    c, win, a = _k2_mode_case(ctx, fctx, case)
    dev = c["device"]
    B, L1, A, d = a["h0x"].shape
    if a["act2"] != relu:
        raise AssertionError(f"K2 bf16 {tag}: act2 {a['act2']}")
    fwd_args = dict(a, conv1_in=False, n_buf=n_buf)
    got = fw.fused_window_fwd(**fwd_args, hot=BF)
    if len(got) != n_buf or any(b.dtype != BF for b in got):
        raise AssertionError(f"K2f bf16 {tag}: buffers "
                             f"{[b.dtype for b in got]}")
    fwd_errs = _errs(((f"buf{i + 1}", got[i], pb, pf) for i, (pb, pf) in
                      enumerate(zip(fw.fused_window_fwd_plain(**fwd_args,
                                                              hot=BF),
                                    fw.fused_window_fwd_plain(**fwd_args)))),
                     f"K2f bf16 {tag}")
    fwd_bitwise = _bitwise(got, fw.fused_window_fwd(**fwd_args, hot=BF))
    gen = torch.Generator(device=dev).manual_seed(8)
    gbs = [torch.randn(B, L1, A, d, generator=gen, device=dev).to(BF)
           for _ in range(n_buf)]
    g3 = gbs[2] if n_buf == 3 else None
    bwd_args = dict(a, buf1=got[0], buf2=got[1], gb1=gbs[0], gb2=gbs[1],
                    gb3=g3, hot=BF)
    cot = fw.fused_window_bwd(**bwd_args)
    bitwise = _bitwise(cot, fw.fused_window_bwd(**bwd_args))
    # the plain backward through the kernels' ReLU pattern (their third
    # buffer > 0; in mode (b) from the same launches with it written, whose
    # other buffers must not change)
    relu_mask = None
    if relu:
        loc = got[2] if n_buf == 3 else None
        if loc is None:
            full = fw.fused_window_fwd(**dict(fwd_args, n_buf=3), hot=BF)
            if not _bitwise(got, full[:2]):
                raise AssertionError(f"K2f bf16 {tag}: the third buffer "
                                     f"changes the other two")
            loc = full[2]
        relu_mask = (loc > 0).to(torch.float32)

    def plain_bwd(hot):
        gs = gbs if hot is not None else [g.float() for g in gbs]
        return fw.fused_window_bwd_plain(
            **a, gb1=gs[0], gb2=gs[1], gb3=gs[2] if n_buf == 3 else None,
            relu_mask=relu_mask, hot=hot)

    bwd_errs = _errs(zip(_COTANGENTS, cot, plain_bwd(BF), plain_bwd(None)),
                     f"K2b bf16 {tag}")
    if not (fwd_bitwise and bitwise):
        raise AssertionError(f"K2 bf16 {tag}: two runs differ (K2f "
                             f"{fwd_bitwise}, K2b {bitwise})")
    rows = int(win.act_mask[:, :L1].sum())
    edges = int(win.emask[:, :L1].sum())
    n_rel = c["params"]["encoder"]["layer1"]["weight"].shape[0]
    w_bytes = (2 * d * 3 * d * 2 + 2 * d * d + n_rel * 2 * d) * 4
    shape = (f"B={B} L1={L1} A={A} E={c['E']} d={d} n_buf={n_buf}"
             f"{' relu' if relu else ''}")
    # per active row the gate products and both self-loops, the input and
    # both masks read in float32, the buffers written in bfloat16; the
    # backward (84 d^2 a row) reads the buffers and their cotangents in
    # bfloat16 and writes dh0x in float32
    fwd = _bf16_case(
        lambda: fw.fused_window_fwd(**fwd_args, hot=BF),
        lambda: fw.fused_window_fwd_plain(**fwd_args, hot=BF),
        lambda: fw.fused_window_fwd_plain(**fwd_args), fwd_errs,
        rows * (4 * 2 * d * 3 * d + 2 * 2 * d * d) + 2 * edges * 3 * d,
        rows * d * (4 + 2 * n_buf + 2 * 4) + edges * 16 + rows * 12
        + w_bytes, shape, dev, plain_reps=2)
    bwd = _bf16_case(
        lambda: fw.fused_window_bwd(**bwd_args),
        lambda: plain_bwd(BF), lambda: plain_bwd(None), bwd_errs,
        rows * 84 * d * d + edges * 16 * d,
        rows * d * (4 * 4 + 2 * (2 + n_buf)) + edges * 16 + rows * 12
        + 2 * w_bytes, shape, dev, plain_reps=2)
    fwd["bitwise"], bwd["bitwise"] = fwd_bitwise, bitwise
    return {"fwd": fwd, "bwd": bwd}


def phase_bf16_flagship_kernels(ctx, fctx) -> dict:
    """The flagship's kernels in their bfloat16 mode at its full width,
    each against its plain bfloat16 version on the same inputs under
    BF16_RULE (the plain float32 version's distance from it the
    yardstick), two runs of each bit-equal, with times and bounds at the
    bfloat16 and TF32 rates: K2f and K2b in the flagship's modes (both
    windows of the flagship's first training batch with three buffers and
    the ReLU, mode (a) on GRRGCN's windows, mode (b) on both of the
    flagship's windows); then on that batch's final step, its history
    rounded to bfloat16, K6+K7 for both layers, K8 on the table (its loss
    within LOSS_TOL, as K3's: at this width bfloat16's roundings average out
    of each element's loss below float32's noise), K4 on the bi table and
    K9+K10 for both layers from K4's cotangent (layer 2's plain version
    through the kernels' ReLU pattern, ``bi_relu_pattern``). K6+K7's GRU
    input equals bit for bit the one K9+K10 recompute and their ReLU takes
    its branches (``bi_bf16_recompute``, both layers); its two launches are
    timed apart too, with its occupancy. Every launch here is a check's:
    the counters are not read."""
    import torch

    from temp_tpu_torch.ops import fused_final as ff
    from temp_tpu_torch.ops import fused_final_bi as fb

    BF = torch.bfloat16
    out = {}
    for tag, case, n_buf, relu in _K2_BF16_MODES:
        r = _k2_bf16_mode(ctx, fctx, tag, case, n_buf, relu)
        out[f"k2_{tag}_fwd"], out[f"k2_{tag}_bwd"] = r["fwd"], r["bwd"]

    dev, fb_ = fctx["device"], final_batch_flagship(fctx)
    h1f, h2f, hlf, h1b, h2b, hlb = (h.to(BF).contiguous()
                                    for h in fb_["hists"])
    bg, h0x, wrel, rtab = fb_["bg"], fb_["h0x"], fb_["wrel"], fb_["rtab"]
    gr, csr, g = bg.gr, fb_["csr"], fb_["grus"]
    B, N, d = h0x.shape
    loop1, loop2 = fb_["loops"]
    sel = h0x if bg.noact else None
    a1 = (h0x, h1f, h1b, bg, gr.m1, wrel, 0, loop1, g["1f"], g["1b"])
    kw2 = {"relu": True, "hl": (hlf, hlb), "imp": fb_["imp"]}

    def layers(fn, **kw):
        out1 = fn(*a1, **kw)
        a2 = (out1, h2f, h2b, bg, gr.m2, wrel, d, loop2, g["2f"], g["2b"])
        return out1, fn(*a2, **kw2, sel=sel, **kw)

    got = layers(fb.bi_layer_fwd, csr=csr, hot=BF)
    ref_bf = layers(fb.bi_layer_fwd_plain, hot=BF)
    ref_f = layers(fb.bi_layer_fwd_plain)
    # layer 2 of all three from the plain bfloat16 layer 1's output
    a2 = (ref_bf[0], h2f, h2b, bg, gr.m2, wrel, d, loop2, g["2f"], g["2b"])
    got = (got[0], fb.bi_layer_fwd(*a2, **kw2, sel=sel, csr=csr, hot=BF))
    ref_f = (ref_f[0], fb.bi_layer_fwd_plain(*a2, **kw2, sel=sel))
    errs = _errs((("layer1", got[0], ref_bf[0], ref_f[0]),
                  ("layer2", got[1], ref_bf[1], ref_f[1])), "K6+K7 bf16")
    bitwise = _bitwise(got, (fb.bi_layer_fwd(*a1, csr=csr, hot=BF),
                             fb.bi_layer_fwd(*a2, **kw2, sel=sel, csr=csr,
                                             hot=BF)))
    if not bitwise:
        raise AssertionError("K6+K7 bf16: two runs differ")
    # its GRU input equals bit for bit the one K9+K10 recompute, and its
    # ReLU takes their branch, on both layers
    gen = torch.Generator(device=dev).manual_seed(12)
    d_rand = torch.randn(B, N, d, generator=gen, device=dev)
    recompute = ({f"layer{i}": bi_bf16_recompute(a, k, d_rand, csr)
                  for i, a, k in ((1, a1, {}), (2, a2, kw2))}
                 if dev.type == "cuda" else None)
    if recompute is not None and any(
            r["gin_vs_k9k10"] or r["relu_fwd_flips"]
            for r in recompute.values()):
        raise AssertionError(f"K6+K7 bf16 and K9+K10 bf16's recompute "
                             f"differ: {recompute}")
    kept = float(gr.emf.sum())
    # the four histories and two local tables read in bfloat16
    hist_bytes = 6 * 2 * B * N * d
    layer_flops = B * 26 * N * d * d + kept * 3 * d
    out["k6k7"] = _bf16_case(
        lambda: (fb.bi_layer_fwd(*a1, csr=csr, hot=BF),
                 fb.bi_layer_fwd(*a2, **kw2, sel=sel, csr=csr, hot=BF)),
        lambda: layers(fb.bi_layer_fwd_plain, hot=BF),
        lambda: layers(fb.bi_layer_fwd_plain), errs, 2 * layer_flops,
        _bi_bytes(fb_, 1) + _bi_bytes(fb_, 2) - hist_bytes,
        f"B={B} N={N} E={gr.src.shape[1]} d={d}, both layers", dev, reps=10)
    # each layer's launch apart (layer 1 two histories, layer 2 two more
    # local tables, in bfloat16)
    for tag, fn, nbytes in (
            ("layer1", lambda: fb.bi_layer_fwd(*a1, csr=csr, hot=BF),
             _bi_bytes(fb_, 1) - 2 * 2 * B * N * d),
            ("layer2", lambda: fb.bi_layer_fwd(*a2, **kw2, sel=sel, csr=csr,
                                               hot=BF),
             _bi_bytes(fb_, 2) - 4 * 2 * B * N * d)):
        part = _mixed_bounds(((layer_flops, H100_BF16_FLOPS,
                               H100_BF16_FLOPS),), nbytes)
        part["ms"] = time_ms(fn, dev, reps=10)
        part["bound_share"] = part["bound_ms"] / part["ms"]
        out["k6k7"][tag] = part
    out["k6k7"].update(
        bitwise=bitwise, recompute=recompute, launch=bf16_launch_info(
            "bi_bf16_occupancy", {"layer": (2, "bi_layer_kernel")},
            "fused_final_bi_bf16.cu", d))

    table = ref_bf[1]
    loss, saved = fb.bi_loss_fwd(table, rtab, gr, csr, hot=BF)
    lb = ff._loss_plain(table, rtab, gr, BF)
    lf = ff._loss_plain(table, rtab, gr)
    err_loss = float(((loss - lb) / lb.abs().clamp(min=1.0)).abs().max())
    if not (err_loss <= LOSS_TOL and bool(torch.isfinite(loss).all())):
        raise AssertionError(f"K8 bf16: loss err {err_loss} > {LOSS_TOL}")
    again, saved2 = fb.bi_loss_fwd(table, rtab, gr, csr, hot=BF)
    keys = [k for k in ("qhat", "lse", "scpos") if k in saved]
    bitwise = _bitwise([loss] + [saved[k] for k in keys],
                       [again] + [saved2[k] for k in keys])
    if not bitwise:
        raise AssertionError("K8 bf16: two runs differ")
    q = 2 * float(gr.posm.sum())
    shape = (f"B={B} N={N} E={gr.src.shape[1]} d={d} "
             f"positive queries={int(q)}")
    # the score launch scores two query sets
    k8 = {"shape": shape, "max_abs_err": float((loss - lb).abs().max()),
          "loss_rel_err": err_loss,
          "loss_gap_to_f32": float((lb - lf).abs().max()),
          "rms_ratio": None, "bitwise": bitwise,
          "ms": time_ms(lambda: fb.bi_loss_fwd(table, rtab, gr, csr,
                                               hot=BF), dev, reps=10),
          "plain_ms": time_ms(lambda: ff._loss_plain(table, rtab, gr, BF),
                              dev, reps=3),
          "plain_f32_ms": time_ms(lambda: ff._loss_plain(table, rtab, gr),
                                  dev, reps=3),
          "library_ms": None,
          **_bf16_bounds(2 * q * N * 2 * d, 4 * (B * N * d + rtab.numel()))}
    k8["bound_share"] = k8["bound_ms"] / k8["ms"]
    out["k8"] = k8

    gv = fb_["tv"]
    got4 = ff.fused_final_bwd_loss(saved, rtab, gr, gv, hot=BF)
    ref4 = ff.fused_final_bwd_loss_plain(table, rtab, gr, gv, hot=BF)
    ref4f = ff.fused_final_bwd_loss_plain(table, rtab, gr, gv)
    errs = _errs(zip(("d_table", "d_rtab"), got4, ref4, ref4f), "K4 bf16 bi")
    bitwise = _bitwise(got4, ff.fused_final_bwd_loss(saved, rtab, gr, gv,
                                                     hot=BF))
    if not bitwise:
        raise AssertionError("K4 bf16 on the bi table: two runs differ")
    out["k4_bi"] = _bf16_case(
        lambda: ff.fused_final_bwd_loss(saved, rtab, gr, gv, hot=BF),
        lambda: ff.fused_final_bwd_loss_plain(table, rtab, gr, gv, hot=BF),
        lambda: ff.fused_final_bwd_loss_plain(table, rtab, gr, gv), errs,
        q * N * 2 * d * 3, 4 * 2 * B * N * d, shape, dev, reps=10)
    out["k4_bi"]["bitwise"] = bitwise

    d_out2, _ = ff.select_bwd(ref4[0], gr.active if bg.noact else None)
    d_out2 = d_out2.contiguous()
    relu2 = fb.bi_relu_pattern(*a2, d_out2, **kw2, csr=csr, hot=BF)
    l2 = (a2, d_out2, kw2)
    rb2 = fb.bi_layer_bwd_plain(*a2, d_out2, **kw2, relu_mask=relu2, hot=BF)
    l1 = (a1, rb2[0], {})

    def both(fn, **kw):
        def run():
            res = []
            for a, up, k in (l2, l1):
                extra = ({"relu_mask": relu2} if k and fn is not
                         fb.bi_layer_bwd else {})
                res.append(fn(*a, up, **k, **extra, **kw))
            return res
        return run

    got9 = both(fb.bi_layer_bwd, csr=csr, hot=BF)()
    ref9 = both(fb.bi_layer_bwd_plain, hot=BF)()
    ref9f = both(fb.bi_layer_bwd_plain)()
    pairs = [(f"{tag} {n}", x, y, z)
             for tag, gl, rl, fl in zip(("layer2", "layer1"), got9, ref9,
                                        ref9f)
             for n, x, y, z in zip(_BI_COTANGENTS, gl, rl, fl)
             if y is not None]
    errs = _errs(pairs, "K9+K10 bf16")
    bitwise = all(_bitwise(x, y) for x, y in zip(
        got9, both(fb.bi_layer_bwd, csr=csr, hot=BF)()))
    if not bitwise:
        raise AssertionError("K9+K10 bf16: two runs differ")
    conv2 = fb._rows_plain(*a2[:8], True, kw2["hl"], kw2["imp"], BF)[0]
    # the ReLU's signs where the recompute and the forward (K6+K7, on the
    # same routines) differ: the forward's from its GRU input without the
    # blend, the ReLU's output; none may
    fwd2 = fb.bi_gru_input(*a2, relu=True, csr=csr, hot=BF)
    fwd_flips = 0 if relu2 is None else int(((relu2 > 0) != (fwd2 > 0)).sum())
    if fwd_flips:
        raise AssertionError(f"K9+K10 bf16's ReLU takes another branch than "
                             f"K6+K7's at {fwd_flips} entries")
    out["k9k10"] = _bf16_case(
        both(fb.bi_layer_bwd, csr=csr, hot=BF),
        both(fb.bi_layer_bwd_plain, hot=BF), both(fb.bi_layer_bwd_plain),
        errs, 2 * B * 78 * N * d * d + 2 * kept * 6 * d,
        _bi_bytes(fb_, 1, extra_rows=4) + _bi_bytes(fb_, 2, extra_rows=6)
        - hist_bytes, f"B={B} N={N} E={gr.src.shape[1]} d={d}, both layers",
        dev, reps=10)
    out["k9k10"].update(
        bitwise=bitwise, relu_flips=0 if relu2 is None else
        int(((relu2 > 0) != (conv2 > 0)).sum()), relu_fwd_flips=fwd_flips,
        relu_entries=int(relu2.numel()) if relu2 is not None else 0,
        launch=bf16_launch_info(
            "bi_bf16_occupancy", {"gru": (0, "bi_bwd_gru_kernel"),
                                  "weights": (1, "bi_wgrad_kernel")},
            "fused_final_bi_bf16.cu", d))
    for name, r in out.items():
        print(f"  bf16 flagship {name}: {r}", flush=True)
    return out


# the flagship's bfloat16 launches a training step (fused) and a valid sweep
_BF16_FLAGSHIP_STEP = {"fused_window_fwd": 28, "fused_window_bwd": 74,
                       "bi_layer_fwd": 2, "bi_loss_fwd": 2,
                       "fused_final_bwd_loss": 4, "bi_layer_bwd": 10}
_BF16_FLAGSHIP_SWEEP = {"spmm_fwd": 736, "fused_window_fwd": 1288}
_NOT_BF16_FLAGSHIP = ("fused_final_fwd", "fused_final_bwd_layer",
                      "fused_eval_ranks", "fused_window_mb_fwd",
                      "ring_spmm_fwd", "ring_spmm_bwd")


def phase_bf16_flagship_path(fctx, train_res, path_res) -> dict:
    """The flagship with compute_dtype="bfloat16", as ``phase_bf16_path``
    holds GRRGCN: TRAIN_STEPS steps on the fused path (K2f, K2b, K6-K10
    with K4), the unfused one (K2, K1f, K1b) and the plain versions of
    both, each kernel path's losses within TRAIN_TOL and its trained leaves
    within BF16_PARAM_TOL of its own plain versions' (beside them
    ``bf16_param_ratio`` for reading); the launches a step
    (_BF16_FLAGSHIP_STEP; none of K3, K5, K11-K13); the valid sweep with the
    kernels and with the plain versions (_BF16_FLAGSHIP_SWEEP; MRR within
    MRR_TOL of plain or within BF16_RULE of the float32 sweep's distance);
    beside them the bfloat16 - float32 gaps of the losses, parameters and
    MRR (`train_res` and `path_res` the flagship's float32 phases') and each
    run's peak memory above what the earlier phases hold."""
    import numpy as np
    import torch

    dev = fctx["device"]
    cfg = fctx["cfg"].replace(compute_dtype="bfloat16")
    if cfg.hot_dtype != torch.bfloat16:
        raise AssertionError(f"bf16 flagship: hot dtype {cfg.hot_dtype}")
    steps = fctx.get("train_steps", TRAIN_STEPS)
    res, finals, init = {}, {}, None
    for name, over in _PATHS + (("unfused_plain", {"fused_final": False,
                                                   "kernels": False}),):
        model, res[name], init, finals[name], _, _ = _train_path(
            fctx, cfg.replace(**over))
        if model.fused_final_on() != (name in ("fused", "plain")):
            raise AssertionError(f"bf16 flagship {name}: fused_final "
                                 f"resolved {model.fused_final_on()}")
        print(f"  bf16 flagship train {name}: {res[name]}", flush=True)
    losses = {n: torch.tensor(r["losses"], dtype=torch.float64)
              for n, r in res.items()}
    pairs = (("fused", "plain"), ("unfused", "unfused_plain"))
    res["max_rel_gaps"] = {
        k: float(((losses[k] - losses[pl]).abs()
                  / losses[pl].abs().clamp(min=1.0)).max()) for k, pl in pairs}
    if not all(np.isfinite(r["losses"]).all() for r in
               (res[n] for n in losses)):
        raise AssertionError("bf16 flagship train: losses not finite")
    if not all(g <= TRAIN_TOL for g in res["max_rel_gaps"].values()):
        raise AssertionError(f"bf16 flagship train: loss trajectories "
                             f"differ: {res['max_rel_gaps']} > {TRAIN_TOL}")
    # each leaf within BF16_PARAM_TOL of its plain path's change; beside
    # it, for reading, the rule's ratio against the float32 fused path's
    res["params"] = {k: param_gaps(init, finals, names=(k, pl),
                                   tol=BF16_PARAM_TOL) for k, pl in pairs}
    res["param_ratios"] = {
        k: bf16_param_ratio(finals[k], finals[pl],
                            fctx["train_ref"]["params"]) for k, pl in pairs}
    flat = {n: torch.cat([t.flatten().double().cpu() for t in v])
            for n, v in finals.items()}
    flat_f32 = torch.cat([t.flatten().double().cpu()
                          for t in fctx["train_ref"]["params"]])
    f32 = torch.tensor(train_res["plain"]["losses"], dtype=torch.float64)
    res["loss_gap_to_f32"] = float((losses["plain"] - f32).abs().max())
    res["loss_rel_gap_to_f32"] = res["loss_gap_to_f32"] / float(
        f32.abs().max())
    res["param_rel_gap_to_f32"] = _rms(flat["plain"] - flat_f32) / max(
        _rms(flat_f32 - torch.cat([t.flatten().double().cpu()
                                   for t in init])), 1e-30)
    want = {k: v * steps for k, v in _BF16_FLAGSHIP_STEP.items()}
    n = res["fused"]["launches"]
    if dev.type == "cuda":
        got = {k: n[k] for k in want}
        if got != want or any(n[k] for k in _NOT_BF16_FLAGSHIP) \
                or n["spmm_fwd"]:
            raise AssertionError(f"bf16 flagship fused train launches {n}, "
                                 f"want {want} and none of "
                                 f"{_NOT_BF16_FLAGSHIP} or K1")
        u = res["unfused"]["launches"]
        if not (u["spmm_fwd"] and u["spmm_bwd"] and u["fused_window_fwd"]
                and u["fused_window_bwd"]) or any(
                    u[k] for k in _NOT_UNFUSED):
            raise AssertionError(f"bf16 flagship unfused train launches {u}")
    for name in ("plain", "unfused_plain"):
        if any(res[name]["launches"].values()):
            raise AssertionError(f"bf16 flagship {name} train launched "
                                 f"kernels: {res[name]['launches']}")
    runs = {}
    for name, kernels in (("kernels", True), ("plain", False)):
        m, ranks, mask = _sweep(fctx, cfg.replace(kernels=kernels))
        runs[name] = (ranks, mask)
        res[f"eval_{name}"] = m
        print(f"  bf16 flagship path {name}: {m}", flush=True)
    k, pl = res["eval_kernels"], res["eval_plain"]
    (rk, mk), (rp, mp) = runs["kernels"], runs["plain"]
    mrr_f32 = path_res["plain"]["mrr"]
    if not (np.array_equal(mk, mp) and np.isfinite(k["mrr"])
            and 0.0 < k["mrr"] <= 1.0):
        raise AssertionError(f"bf16 flagship sweep: masks differ or bad MRR "
                             f"{k}")
    mrr_tol = max(MRR_TOL, BF16_RULE * abs(mrr_f32 - pl["mrr"]))
    if not abs(k["mrr"] - pl["mrr"]) <= mrr_tol:
        raise AssertionError(f"bf16 flagship sweep MRR kernels {k['mrr']} "
                             f"vs plain {pl['mrr']} (tolerance {mrr_tol})")
    if dev.type == "cuda":
        got = {x: k["launches"][x] for x in _BF16_FLAGSHIP_SWEEP}
        if got != _BF16_FLAGSHIP_SWEEP or any(
                k["launches"][x] for x in _NOT_UNFUSED + ("spmm_bwd",
                                                          "fused_window_bwd")):
            raise AssertionError(f"bf16 flagship sweep launches "
                                 f"{k['launches']}")
    if any(pl["launches"].values()):
        raise AssertionError(f"bf16 flagship plain sweep launched kernels: "
                             f"{pl['launches']}")
    res["mrr_gap_to_f32"] = pl["mrr"] - mrr_f32
    res["mrr_kernels_gap_to_plain"] = k["mrr"] - pl["mrr"]
    res["same_rank_share"] = float(np.mean(rk[mk] == rp[mp]))
    res["peak_rise_mb_fused"] = res["fused"]["peak_rise_mb"]
    # the fused bfloat16 run and sweep the batched window is held to
    fctx["bf16_ref"] = {"losses": res["fused"]["losses"],
                       "params": finals["fused"], "init": init,
                       "ranks": runs["kernels"],
                       "mrr": res["eval_kernels"]["mrr"]}
    res["peak_rise_mb_fused_f32"] = train_res["fused"]["peak_rise_mb"]
    res["eval_peak_rise_mb"] = k["peak_rise_mb"]
    res["eval_peak_rise_mb_f32"] = path_res["kernels"]["peak_rise_mb"]
    return res


# the TeMP variants in bfloat16, as ``phase_variants`` runs them
_BF16_VARIANTS = tuple(
    (tag, config, {**flags, "compute_dtype": "bfloat16"})
    for tag, config, flags in (
        ("ted", "config_bigrrgcn.json",
         {"impute": True, "post_ensemble": True}),
        ("bigrrgcn_aggregation", "config_bigrrgcn.json",
         {"post_aggregation": True}),
        ("bigrrgcn", "config_bigrrgcn.json", {}),
        ("grrgcn_impute", "config_grrgcn.json", {"impute": True})))


def phase_bf16_variants(ctx) -> dict:
    """TED, BiGRRGCN --post-aggregation, plain BiGRRGCN and the
    unidirectional GRRGCN --impute with compute_dtype="bfloat16" at full
    width and VARIANT_SEQ_LEN, as ``phase_variants`` holds them (2 steps
    and one valid batch, kernels against plain: losses within TRAIN_TOL,
    MRR within MRR_TOL; K1f, K1b, K2f and K2b launched in training, K1f
    and K2f in eval, none of K3-K13; each leaf within BF16_PARAM_TOL),
    and GRRGCN under random_dropout and under edge_dropout
    (_BF16_DROP_VARIANTS: its windows step by step in training, K1f and
    K1b, its final step through K3-K5's bfloat16 mode; eval K2f and K1f);
    beside each, from the same steps and batch in float32 (plain), the
    trained parameters' ``bf16_param_ratio`` and the bfloat16 - float32
    gaps of the plain versions' losses and the batch's MRR."""
    import numpy as np

    from temp_tpu_torch.models.objectives import metrics_from_ranks

    def against_f32(vctx, r):
        c32 = dict(vctx, cfg=vctx["cfg"].replace(compute_dtype="float32"))
        _, f32, _, finals, _, _ = _train_path(
            c32, c32["cfg"].replace(kernels=False))
        r["param_ratio"] = bf16_param_ratio(
            vctx["finals"]["kernels"], vctx["finals"]["plain"], finals)
        rp, mp, _ = _eval_batch_ranks(c32, False)
        r["loss_gap_to_f32"] = float(np.max(np.abs(
            np.array(r["train"]["plain"]["losses"])
            - np.array(f32["losses"]))))
        r["mrr_gap_to_f32"] = (r["eval"]["mrr_plain"]
                               - metrics_from_ranks(rp, mp)["mrr"])

    return phase_variants(ctx, _BF16_VARIANTS + _BF16_DROP_VARIANTS,
                          param_tol=BF16_PARAM_TOL,
                          check=against_f32)


def phase_setup_ted(ctx) -> dict:
    """TED, BiGRRGCN --impute --post-ensemble
    (grid/icews14/config_bigrrgcn.json with both flags), on the smoke's
    data at full width with seeded random weights; beside it the seconds
    its frequency features take to build on the host."""
    from temp_tpu_torch.data.frequency import build_freq_features

    tctx = phase_setup(ctx["device"].type, config="config_bigrrgcn.json",
                       data=ctx["data"], **{**ctx["setup_kw"], "impute": True,
                                            "post_ensemble": True})
    t0 = time.perf_counter()
    build_freq_features(tctx["data"], tctx["cfg"].train_seq_len, future=True)
    tctx["freq_s"] = time.perf_counter() - t0
    return tctx


def _unfused_launches_ok(dev, launches: dict, want, tag: str,
                         banned=_NOT_UNFUSED) -> None:
    """On the card the kernels `want` launched and none of `banned` (by
    default K3-K12 and the ring's: a path whose final step runs one element
    at a time)."""
    if dev.type != "cuda":
        return
    missed = [k for k in want if not launches[k] > 0]
    extra = {k: launches[k] for k in banned if launches[k]}
    if missed or extra:
        raise AssertionError(f"{tag}: missed {missed}, or launched {extra}")


def phase_ted_path(tctx) -> dict:
    """TED's valid sweep with the kernels and with their plain versions
    (``phase_path``: MRR within MRR_TOL); K2f and K1f launched, none of
    K3-K12; the gated eval's loss 0, as the reference reports it."""
    res = phase_path(tctx)
    k = res["kernels"]
    _unfused_launches_ok(tctx["device"], k["launches"],
                         ("spmm_fwd", "fused_window_fwd"), "ted eval")
    if not (k["loss"] == 0.0 == res["plain"]["loss"]):
        raise AssertionError(f"ted eval: loss {k['loss']}, not 0")
    return res


def phase_train_unfused(c, want=_UNFUSED_TRAIN, banned=_NOT_UNFUSED,
                        fused: bool = False, param_tol=PARAM_TOL) -> dict:
    """The first steps of epoch 0 (TRAIN_STEPS, or c["train_steps"]) of a
    model whose final step runs one element at a time (TED, the other
    variants, the attention, linear-recurrence and static models; with
    `fused` one whose final step runs fused, after windows that run step by
    step), with the kernels and with their plain versions, from the same
    seeded weights and draws: the losses within TRAIN_TOL, every parameter
    leaf (the gates' among them) within PARAM_TOL of the plain path's
    change (``param_gaps``), the kernels `want` launched (by default K1f,
    K1b, K2f and K2b) and none of `banned` (by default K3-K12), no K1 call
    sorting its edges (`param_tol` for the leaves, ``param_gaps``' `tol`).
    The models and the trained leaves of both runs stay in c["models"] and
    c["finals"]."""
    import numpy as np
    import torch

    dev = c["device"]
    res, finals, init, names = {}, {}, None, None
    for name, over in (("kernels", {}), ("plain", {"kernels": False})):
        model, res[name], leaves, finals[name], _, params = _train_path(
            c, c["cfg"].replace(**over))
        c.setdefault("models", {})[name] = model
        if model.fused_final_on() != fused:
            raise AssertionError(f"{name}: fused final step "
                                 f"{model.fused_final_on()}, not {fused}")
        if init is None:
            init = leaves
            names = _leaf_names(params)
        elif not all(torch.equal(a, b) for a, b in zip(leaves, init)):
            raise AssertionError(f"train {name}: other initial weights")
        print(f"  train {name}: {res[name]}", flush=True)
    x, y = np.array(res["kernels"]["losses"]), np.array(res["plain"]["losses"])
    if not np.isfinite(x).all():
        raise AssertionError(f"losses not finite: {x}")
    res["max_rel_gap"] = float(np.max(np.abs(x - y)
                                      / np.maximum(1.0, np.abs(y))))
    if not res["max_rel_gap"] <= TRAIN_TOL:
        raise AssertionError(f"loss trajectories differ: "
                             f"{res['max_rel_gap']} > {TRAIN_TOL}")
    res["params"] = param_gaps(init, finals, names=("kernels", "plain"),
                               tol=param_tol)
    c["finals"] = finals
    gates = [k for k, n in enumerate(names) if n.startswith("gates/")]
    res["gate_leaves"] = len(gates)
    res["gate_leaves_moved"] = sum(
        not torch.equal(finals["plain"][k], init[k]) for k in gates)
    _unfused_launches_ok(dev, res["kernels"]["launches"], want,
                         "train kernels", banned)
    if dev.type == "cuda" and res["kernels"]["k1_csr_builds"]:
        raise AssertionError(f"train kernels: K1 sorted "
                             f"{res['kernels']['k1_csr_builds']} calls' "
                             f"edges")
    if any(res["plain"]["launches"].values()):
        raise AssertionError(f"train plain: kernels launched: "
                             f"{res['plain']['launches']}")
    res["ms_per_step"] = res["kernels"]["ms_per_step"]
    return res


def _leaf_names(tree, path=""):
    """The paths of a parameter tree's leaves, in ``param_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{path}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{path}{i}/")]
    return [path.rstrip("/")]


def _eval_batch_ranks(c, kernels: bool):
    """One valid batch of targets (``window_batch``'s) through the model of
    c with the kernels or their plain versions, every counter from 0:
    (ranks, mask) numpy, launches."""
    import numpy as np
    import torch

    from temp_tpu_torch.models.registry import get_model

    dev, data = c["device"], c["trainer"].data
    model = get_model(c["cfg"].replace(kernels=kernels), c["data"],
                      device=dev)
    t_pos = np.arange(c["B"]) + data.num_times // 2
    _reset_counts()
    with torch.no_grad():
        ranks, mask, _ = model.eval_ranks(c["params"], data, t_pos,
                                          np.ones(c["B"], bool), "valid")
    return ranks.cpu().numpy(), mask.cpu().numpy(), _counts()


def phase_variants(ctx, variants=_VARIANTS, train_want=_UNFUSED_TRAIN,
                   eval_want=("spmm_fwd", "fused_window_fwd"),
                   banned=_NOT_UNFUSED, param_tol=PARAM_TOL,
                   check=None) -> dict:
    """The other TeMP variants at full width and VARIANT_SEQ_LEN: GRRGCN
    --impute --post-ensemble (K2's mode (a)), BiGRRGCN --post-aggregation
    and plain BiGRRGCN (mode (b)), or the (tag, config, flags[, spec]) of
    `variants`: 2 training steps with the kernels and with their plain
    versions (``phase_train_unfused``, the kernels `train_want` launched
    and none of `banned`) and one valid batch of each, held together (MRR
    within MRR_TOL, the same query mask; `eval_want` launched). A
    variant's `spec` may set its own "train_want", "train_banned",
    "eval_want", "eval_banned" and "fused" (its training's final step
    fused). A model with DropEdge's rates records their build seconds.
    `param_tol` is ``phase_train_unfused``'s; `check(vctx, r)`, when
    given, adds its checks to a variant's record."""
    import numpy as np

    from temp_tpu_torch.models.objectives import metrics_from_ranks

    out = {}
    for tag, config, flags, *more in variants:
        spec = {"train_want": train_want, "train_banned": banned,
                "eval_want": eval_want, "eval_banned": banned,
                "fused": False, **(more[0] if more else {})}
        vctx = phase_setup(ctx["device"].type, config=config,
                           data=ctx["data"],
                           **{**ctx["setup_kw"], **flags,
                              "train_seq_len": VARIANT_SEQ_LEN})
        vctx["train_steps"] = 2
        r = {"model": type(vctx["model"]).__name__,
             "train": phase_train_unfused(vctx, spec["train_want"],
                                          spec["train_banned"],
                                          spec["fused"], param_tol)}
        if getattr(vctx["model"], "drop_rates_s", None) is not None:
            r["drop_rates_s"] = vctx["model"].drop_rates_s
        (rk, mk, launches), (rp, mp, plain) = (
            _eval_batch_ranks(vctx, k) for k in (True, False))
        mk_, mp_ = metrics_from_ranks(rk, mk), metrics_from_ranks(rp, mp)
        r["eval"] = {"mrr_kernels": mk_["mrr"], "mrr_plain": mp_["mrr"],
                     "n": mk_["n"], "same_rank_share": float(
                         np.mean(rk[mk] == rp[mp])), "launches": launches}
        if not (np.array_equal(mk, mp) and mk_["n"] > 0
                and abs(mk_["mrr"] - mp_["mrr"]) <= MRR_TOL):
            raise AssertionError(f"variant {tag} eval: {r['eval']} "
                                 f"(plain {mp_})")
        _unfused_launches_ok(vctx["device"], launches, spec["eval_want"],
                             f"variant {tag} eval", spec["eval_banned"])
        if any(plain.values()):
            raise AssertionError(f"variant {tag} eval plain: {plain}")
        if check is not None:
            check(vctx, r)
        out[tag] = r
        print(f"  variant {tag}: {r}", flush=True)
    return out


# the attention models (models/selfattn.py, models/postselfattn.py): their
# training and eval launch K1 alone, no K2 and none of K3-K13
_SA_TRAIN = ("spmm_fwd", "spmm_bwd")
_NOT_SA = _NOT_UNFUSED + ("fused_window_fwd", "fused_window_bwd")
_SA_VARIANTS = (
    ("post_sargcn", "config_sargcn.json", {"post_aggregation": True}),
    ("post_bisargcn", "config_bisargcn.json", {"post_aggregation": True}),
    ("sargcn_compact_lambda_ema", "config_sargcn.json",
     {"sa_compact": True, "learnable_lambda": True, "ema": True}))


def phase_setup_config(ctx, config: str = "config_sargcn.json") -> dict:
    """The model of grid/icews14/`config` (SARGCN, BiSARGCN, RRGCN,
    BiRRGCN, SRGCN) on the smoke's data at full width with seeded random
    weights."""
    return phase_setup(ctx["device"].type, config=config, data=ctx["data"],
                       **ctx["setup_kw"])


def _sa_k1_cases(c):
    """K1's shapes on an attention model's history, in ``_k1_cases``' form:
    one element's L1 window slots side by side in one call, each slot's
    graph over all N entity rows in global ids, its time position named in
    the data's global tables: "history" a target whose window lies inside
    the data, "history_edge" one whose window runs off t = 0 (its first
    slots name the clamped position 0, every edge masked); "compact" the
    same window in ``sa_compact``'s form (each slot's A active rows, the
    data's compact tables)."""
    import torch

    from temp_tpu_torch.models.dynamic import gather_window

    dev, p, data, model = c["device"], c["params"], c["trainer"].data, \
        c["model"]
    L1, N, d = c["L1"], c["N"], c["d"]
    w = p["encoder"]["layer1"]["weight"]
    emb = p["ent_embeds"]
    dense = emb.expand(L1, N, d).reshape(L1 * N, d)
    out = []
    for tag, t in (("history", data.num_times // 2),
                   ("history_edge", L1 // 2)):
        win = gather_window(data, torch.tensor(t, device=dev), L1 + 1)
        out.append((tag, (dense, win.src[:L1], win.dst[:L1], win.rel[:L1],
                          win.emask[:L1], w),
                    (data.spmm.glob, win.t_idx[:L1])))
        if tag == "history":
            h = model._rows(p, win.act_idx[:L1]).reshape(-1, d)
            compact = ("compact", (h.contiguous(), win.src_loc[:L1],
                                   win.dst_loc[:L1], win.rel[:L1],
                                   win.emask[:L1], w),
                       (data.spmm.comp, win.t_idx[:L1]))
    return out + [compact]


def phase_sa_k1(c, cases=None) -> dict:
    """K1f and K1b at the attention history's shapes (``_sa_k1_cases``),
    or at the shapes of `cases` in that form, as ``phase_k1`` and
    ``phase_k1b`` hold them: over the data's tables (one launch, no sort,
    no host sync, two runs bit-equal), bit-equal to the in-call route,
    within K1_TOL of the plain versions; times and bounds."""
    cases = _sa_k1_cases(c) if cases is None else cases
    return {"fwd": phase_k1(c, cases),
            "bwd": phase_k1b(c, cases, tags=[t for t, _, _ in cases])}


def _rec_k1_cases(c):
    """K1's shapes on a linear-recurrence model's window step, in
    ``_k1_cases``' form: the B graphs of an eval batch side by side, A
    compact rows each, each graph naming its own time position in the
    data's compact tables, layer 1's input rows; "window" under each
    graph's own mask (eval), "window_sub" under an 80% subsample of it
    (training under random_dropout)."""
    import torch

    from temp_tpu_torch.models.dynamic import gather_window
    from temp_tpu_torch.ops.sampling import subsample_edges

    dev, p, data, model = c["device"], c["params"], c["trainer"].data, \
        c["model"]
    tp = torch.arange(c["B"], device=dev) + data.num_times // 2
    win = gather_window(data, tp, c["L1"] + 1)
    k = c["L1"] // 2
    h = model._rows(p, win.act_idx[:, k]).reshape(-1, c["d"]).contiguous()
    w = p["encoder"]["layer1"]["weight"]
    gen = torch.Generator(device=dev).manual_seed(0)
    edges = (win.src_loc[:, k], win.dst_loc[:, k], win.rel[:, k])
    tables = (data.spmm.comp, win.t_idx[:, k])
    return (("window", (h, *edges, win.emask[:, k], w), tables),
            ("window_sub", (h, *edges, subsample_edges(
                gen, win.emask[:, k], 0.8), w), tables))


def phase_k1_path(c, what: str) -> dict:
    """The valid sweep of a model whose every graph product is K1 (the
    attention, linear-recurrence and static models; `what` names it) with
    the kernels and with their plain versions (``phase_path``: MRR within
    MRR_TOL, the same query mask, no K1 call sorting its edges): K1f
    launched and no other kernel."""
    res = phase_path(c, want=["spmm_fwd"])
    _unfused_launches_ok(c["device"], res["kernels"]["launches"],
                         ("spmm_fwd",), f"{what} eval", _NOT_SA)
    return res


def phase_setup_ring(ctx) -> dict:
    """The smoke's dataset in the ring layout of RING_M ranks (ring_layout:
    each rank's edge slice holds the edges into its row shard, with K13's
    and K1's static tables of every train snapshot) and the GRRGCN model
    on it with
    the same seeded weights, under edge_partition="ring_pallas"; every
    rank on the smoke's device (one card)."""
    from temp_tpu_torch.data.snapshots import ring_layout
    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.parallel.edge_partition import ring_geometry
    from temp_tpu_torch.parallel.mesh import make_mesh
    from temp_tpu_torch.train.loop import Trainer

    dev, cfg = ctx["device"], ctx["cfg"].replace(
        edge_partition="ring_pallas", mp_size=RING_M)
    data = ring_layout(cfg, ctx["data"])
    mesh = make_mesh(1, RING_M, devices=[dev] * RING_M)
    model = get_model(cfg, data, device=dev)
    trainer = Trainer(cfg, model, data, mesh=mesh)
    A = int(data.act_idx.shape[1])
    return {"cfg": cfg, "data": data, "model": model, "mesh": mesh,
            "params": model.init_params(cfg.seed), "trainer": trainer,
            "device": dev, "N": ctx["N"], "A": A,
            "E": int(data.train.src.shape[1]), "B": ctx["B"],
            "d": ctx["d"], "rows": ring_geometry(ctx["N"], RING_M),
            "a_cap": A // RING_M, "train_steps": ctx.get("train_steps",
                                                         TRAIN_STEPS)}


def _graph_index(src):
    """The graph index of each edge of B graphs' edges [B, E]."""
    import torch

    return torch.arange(src.shape[0], device=src.device)[:, None].expand(
        src.shape)


def _ring_bound(h, w, src, rel, emask):
    """Least time for one K13 call, in either mode: what the function needs
    to move (the referenced rows of h, float32 as the caller gives them,
    and of w, the edge arrays, the written output and norm^2) against 2 s
    flops a kept edge column and the norm scale of each output entry. The
    (M - 1) shards each rank receives are the stepped route's own cost,
    not the function's: returned apart as the rotation's bytes."""
    B, n, d = h.shape
    m = emask.bool()
    s = w.shape[1] // d
    b_idx = _graph_index(src)[m]
    refs = int((b_idx * n + src[m].long()).unique().numel())
    nbytes = (refs * d * 4 + int(rel[m].unique().numel()) * d * s * 4
              + src.numel() * 13 + B * n * (d + 1) * 4)
    flops = 2 * s * int(m.sum()) * d + B * n * d
    t_b, t_f = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    return (max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"),
            (RING_M - 1) * B * n * d * 4)


def _ring_bwd_bound(h, w, src, dst, rel, emask):
    """Least time for one call of K13's backward, in either mode: the
    referenced rows of g (and their norm^2), h and w (float32), the edge
    arrays, dh and dw written once, against (1 + 4 s) d flops a
    kept edge (dmsg, dh's and dw's multiply-adds). The accumulators'
    (M - 1) passes round the ring are its own cost: returned apart as the
    rotation's bytes."""
    B, n, d = h.shape
    m = emask.bool()
    R, W = w.shape
    s = W // d
    b_idx = _graph_index(src)[m]
    g_rows = int((b_idx * n + dst[m].long()).unique().numel())
    h_rows = int((b_idx * n + src[m].long()).unique().numel())
    nbytes = (g_rows * (d + 1) * 4 + h_rows * d * 4
              + int(rel[m].unique().numel()) * W * 4 + src.numel() * 13
              + B * n * d * 4 + R * W * 4)
    flops = (1 + 4 * s) * d * int(m.sum())
    t_b, t_f = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    return (max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"),
            (RING_M - 1) * B * n * d * 4)


def _k13_cases(rctx):
    """K13's two shapes on the path's data, with the tables the path walks:
    (tag, (h, w, src, dst, rel, emask), rows, (tables, t_pos)). "final":
    all N rows padded to RING_M shards, one snapshot's regrouped train
    edges in global ids; "window": one window step's compact shape, the
    B = 8 graphs of an eval batch (A = RING_M * a_cap rows each)."""
    import torch
    import torch.nn.functional as F

    dev, p, data = rctx["device"], rctx["params"], rctx["trainer"].data
    w = p["encoder"]["layer1"]["weight"]
    N, rows = rctx["N"], rctx["rows"]
    t = data.num_times // 2
    h_final = F.pad(p["ent_embeds"], (0, 0, 0, RING_M * rows - N))[None]
    tf = torch.tensor([t], device=dev)
    final = (h_final, w, data.train.src[tf], data.train.dst[tf],
             data.train.rel[tf], data.train.emask[tf])
    tp = torch.arange(rctx["B"], device=dev) + t
    h_win = p["ent_embeds"][data.act_idx[tp].long().clamp(max=N - 1)]
    window = (h_win.contiguous(), w, data.train_src_loc[tp],
              data.train_dst_loc[tp], data.train.rel[tp], data.train.emask[tp])
    return (("final", final, rows, (data.ring.glob, tf)),
            ("window", window, rctx["a_cap"], (data.ring.comp, tp)))


def phase_k13(rctx) -> dict:
    """K13 at the final-snapshot and window-step shapes (``_k13_cases``):
    the route that walks the data's tables (the path's) and the route that
    sorts the call's edges (the in-call route), timed side by side and
    equal bit for bit, also under a 50% dynamic mask; both within
    SCALED_TOL of the largest entry of the plain version, rows without
    in-edges exactly 0, RING_M launches a call and no sort on the table
    route. Then K13's backward kernels (ring_spmm_bwd) over the tables at
    both shapes (the final step under the training's 50% subsample):
    against autograd through the plain forward and against
    ring_spmm_bwd_plain, to the same scale, and RingSpMM's gradients equal
    to theirs."""
    import torch

    from temp_tpu_torch.parallel.ring_spmm import (
        ring_spmm, ring_spmm_bwd, ring_spmm_bwd_plain, ring_spmm_fwd,
        ring_spmm_fwd_plain,
    )

    dev = rctx["device"]
    devices = rctx["mesh"].devices[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    on_card = dev.type == "cuda"  # the CPU rehearsal runs the plain versions
    out = {}
    for tag, args, r, tables in _k13_cases(rctx):
        h, w, src, dst, rel, em = args
        ring = (RING_M, r, devices)
        before, builds = ring_spmm_fwd.launches, ring_spmm_fwd.csr_builds
        got, n2 = ring_spmm_fwd(*args, *ring, tables=tables)
        per_call = ring_spmm_fwd.launches - before
        if (ring_spmm_fwd.csr_builds != builds
                or per_call != (RING_M if on_card else 0)):
            raise AssertionError(f"K13 {tag}: {per_call} launches, "
                                 f"{ring_spmm_fwd.csr_builds - builds} "
                                 f"sorts with the tables")
        own, n2o = ring_spmm_fwd(*args, *ring)
        sub = em & (torch.rand(em.shape, generator=gen, device=dev) < 0.5)
        sub_args = (h, w, src, dst, rel, sub)
        sub_t, _ = ring_spmm_fwd(*sub_args, *ring, tables=tables)
        sub_o, _ = ring_spmm_fwd(*sub_args, *ring)
        if not (torch.equal(got, own) and torch.equal(n2, n2o)
                and torch.equal(sub_t, sub_o)):
            raise AssertionError(f"K13 {tag}: the table route and the "
                                 f"in-call route differ")
        ref, n2p = ring_spmm_fwd_plain(*args, *ring)
        sub_p, _ = ring_spmm_fwd_plain(*sub_args, *ring)
        # held to the outputs' own scale (xavier weights: entries of order
        # 1e-3), as the K4/K5 checks are
        scaled = scaled_errs([(f"K13 {tag} out", got, ref),
                              (f"K13 {tag} norm^2", n2, n2p),
                              (f"K13 {tag} out, 50% mask", sub_t, sub_p)])
        err = max(e["abs"] for e in scaled.values())
        b_e = _graph_index(src)
        isolated_zero = True
        for e_mask, a, b in ((em, got, ref), (sub, sub_t, sub_p)):
            fed = torch.zeros(h.shape[:2], dtype=torch.bool, device=dev)
            fed[b_e[e_mask.bool()], dst[e_mask.bool()].long()] = True
            isolated_zero &= bool((a[~fed] == 0).all()
                                  and (b[~fed] == 0).all())
        if not isolated_zero:
            raise AssertionError(f"K13 {tag}: rows without in-edges not 0")
        # the library yardstick: one index_add_ SpMM of the same messages
        # (computed outside the timing) on the card
        emf = em.to(torch.float32)
        seg = (b_e * h.shape[1] + dst.long()).reshape(-1)
        msg = (h[b_e, src.long()] * w[rel.long()]
               * emf[..., None]).reshape(-1, h.shape[2])
        lib = torch.zeros(h.shape[0] * h.shape[1], h.shape[2], device=dev)
        bound_ms, bound_by, rot_bytes = _ring_bound(h, w, src, rel, em)
        out[tag] = {
            "shape": f"B={h.shape[0]} rows={h.shape[1]} E={src.shape[1]} "
                     f"kept={int(em.sum())} R={w.shape[0]} d={h.shape[2]} "
                     f"m={RING_M}",
            "max_abs_err": err, "scaled_errs": scaled,
            "isolated_rows_zero": isolated_zero,
            "bitwise_in_call": True, "launches_per_call": per_call,
            "ms": time_ms(lambda: ring_spmm_fwd(*args, *ring,
                                                tables=tables), dev),
            "in_call_ms": time_ms(lambda: ring_spmm_fwd(*args, *ring), dev),
            "plain_ms": time_ms(lambda: ring_spmm_fwd_plain(*args, *ring),
                                dev, reps=5),
            "library_ms": time_ms(
                lambda: lib.zero_().index_add_(0, seg, msg), dev),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "rotation_bytes": rot_bytes,
            "rotation_ms": rot_bytes / H100_BYTES_S * 1e3}
        print(f"  K13 {tag}: {out[tag]}", flush=True)
        # the backward: the final step trains on the 50% subsample
        if tag == "final":
            args = sub_args
        h, w, src, dst, rel, em = args
        _, n2 = ring_spmm_fwd(*args, *ring, tables=tables)
        g = torch.randn(h.shape, generator=gen, device=dev)
        hh, ww = h.detach().clone().requires_grad_(), w.detach().clone(
        ).requires_grad_()
        o, _ = ring_spmm_fwd_plain(hh, ww, *args[2:], *ring)
        (o * g).sum().backward()
        bwd_args = (g, n2, h, w, src, dst, rel, em, *ring)
        before = ring_spmm_bwd.launches
        dh, dw = ring_spmm_bwd(*bwd_args, tables=tables)
        per_call = ring_spmm_bwd.launches - before
        ph, pw = ring_spmm_bwd_plain(*bwd_args)
        if per_call != (RING_M + 2 if on_card else 0):
            raise AssertionError(f"K13 bwd {tag}: {per_call} launches")
        errs = scaled_errs([(f"K13 bwd {tag} dh", dh, hh.grad),
                            (f"K13 bwd {tag} dw", dw, ww.grad),
                            (f"K13 bwd {tag} dh plain", dh, ph),
                            (f"K13 bwd {tag} dw plain", dw, pw)])
        ah, aw = h.detach().clone().requires_grad_(), w.detach().clone(
        ).requires_grad_()
        (ring_spmm(ah, aw, *args[2:], *ring, tables=tables)
         * g).sum().backward()
        dh2, dw2 = ring_spmm_bwd(*bwd_args, tables=tables)
        if not (torch.equal(ah.grad, dh) and torch.equal(aw.grad, dw)
                and torch.equal(dh2, dh) and torch.equal(dw2, dw)):
            raise AssertionError(f"K13 bwd {tag}: not the same bits twice")
        # the library yardstick: the same backward as two index_add_ calls
        # on the per-edge cotangents of the same dmsg (computed outside
        # the timing), as K1b's
        emf = em.to(torch.float32)[..., None]
        d_ = h.shape[2]
        dmsg = ((g * n2[..., None])[b_e, dst.long()] * emf).reshape(-1, d_)
        mh = dmsg * w[rel.long()].reshape(-1, d_)
        mw = dmsg * h[b_e, src.long()].reshape(-1, d_)
        src_seg = (b_e * h.shape[1] + src.long()).reshape(-1)
        lib_h = torch.zeros(h.shape[0] * h.shape[1], d_, device=dev)
        lib_w = torch.zeros_like(w)

        def library():
            lib_h.zero_().index_add_(0, src_seg, mh)
            lib_w.zero_().index_add_(0, rel.long().reshape(-1), mw)

        bound_ms, bound_by, rot_bytes = _ring_bwd_bound(h, w, src, dst, rel,
                                                        em)
        out[f"bwd_{tag}"] = {
            "shape": f"B={h.shape[0]} rows={h.shape[1]} E={src.shape[1]} "
                     f"kept={int(em.sum())} R={w.shape[0]} d={d_} "
                     f"m={RING_M}",
            # against its plain version; against autograd in scaled_errs
            "max_abs_err": max(errs[f"K13 bwd {tag} {x} plain"]["abs"]
                               for x in ("dh", "dw")),
            "scaled_errs": errs, "launches_per_call": per_call,
            "ms": time_ms(lambda: ring_spmm_bwd(*bwd_args, tables=tables),
                          dev),
            "plain_ms": time_ms(lambda: ring_spmm_bwd_plain(*bwd_args), dev,
                                reps=5),
            "library_ms": time_ms(library, dev),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "rotation_bytes": rot_bytes,
            "rotation_ms": rot_bytes / H100_BYTES_S * 1e3}
        print(f"  K13 bwd {tag}: {out[f'bwd_{tag}']}", flush=True)
    return out


_NOT_ON_RING = ("spmm_fwd", "spmm_bwd", "fused_window_fwd",
                "fused_window_bwd", "fused_final_fwd", "fused_final_bwd_loss",
                "fused_final_bwd_layer", "fused_eval_ranks",
                "fused_window_mb_fwd")


def _ring_launches_ok(dev, run: dict, tag: str, train: bool) -> None:
    """The ring path launched K13 (and, training, its backward kernels)
    over the data's tables, sorting nothing in a call, and none of K1, K2,
    K3-K5, K11, K12. A sweep has no backward."""
    launches = run["launches"]
    bwd = launches["ring_spmm_bwd"]
    if dev.type == "cuda" and not (launches["ring_spmm_fwd"] > 0
                                   and (bwd > 0 if train else bwd == 0)):
        raise AssertionError(f"{tag}: K13's launches: {launches}")
    if run["csr_builds"]:
        raise AssertionError(f"{tag}: {run['csr_builds']} sorts in a call")
    if any(launches[n] for n in _NOT_ON_RING):
        raise AssertionError(f"{tag}: another kernel launched: {launches}")


def _walks_k1_tables(dev, run: dict, tag: str) -> None:
    """The run without a partition on the regrouped data launched K1 over
    the data's K1 tables of that layout, sorting nothing in a call."""
    if dev.type == "cuda" and not (run["launches"]["spmm_fwd"] > 0
                                   and run["k1_csr_builds"] == 0):
        raise AssertionError(f"{tag} unpartitioned: K1 launched "
                             f"{run['launches']['spmm_fwd']} times, sorted "
                             f"{run['k1_csr_builds']} calls' edges")


def phase_ring_path(rctx) -> dict:
    """The valid sweep with edge_partition="ring_pallas" over RING_M ranks,
    with the kernels and with their plain versions, and without a partition
    on the same regrouped data and weights: MRR within MRR_TOL of each
    other; walls, queries/s and launches."""
    import numpy as np

    cfg = rctx["cfg"]
    res = {}
    for name, c in (("kernels", cfg), ("plain", cfg.replace(kernels=False)),
                    ("unpartitioned", cfg.replace(edge_partition=False,
                                                  mp_size=1))):
        m, _, _ = _sweep(rctx, c)
        res[name] = m
        print(f"  ring path {name}: {m}", flush=True)
    k = res["kernels"]
    n_q = 2 * int(rctx["data"].valid.emask.sum())
    if not (k["n"] == res["plain"]["n"] == res["unpartitioned"]["n"] == n_q
            and np.isfinite(k["mrr"]) and 0.0 < k["mrr"] <= 1.0):
        raise AssertionError(f"ring path: bad metrics {res}")
    gaps = {f"kernels/{o}": abs(k["mrr"] - res[o]["mrr"])
            for o in ("plain", "unpartitioned")}
    if not all(g <= MRR_TOL for g in gaps.values()):
        raise AssertionError(f"ring path: MRR gaps {gaps} > {MRR_TOL}")
    _ring_launches_ok(rctx["device"], k, "ring eval", train=False)
    _walks_k1_tables(rctx["device"], res["unpartitioned"], "ring eval")
    if any(res["plain"]["launches"].values()):
        raise AssertionError(f"ring path plain: kernels launched: "
                             f"{res['plain']['launches']}")
    res["mrr_gaps"] = gaps
    return res


def phase_ring_train(rctx) -> dict:
    """TRAIN_STEPS optimizer steps from the same weights and draws with
    edge_partition="ring_pallas" (the kernels, and their plain versions)
    and without a partition (fused_final off: the final step one element
    at a time, as under the partition): losses within TRAIN_TOL, the
    parameters within PARAM_TOL of the plain path's change."""
    import numpy as np

    cfg = rctx["cfg"]
    runs = (("ring", cfg), ("plain", cfg.replace(kernels=False)),
            ("unpartitioned", cfg.replace(edge_partition=False, mp_size=1,
                                          fused_final=False)))
    res, init, finals = {}, None, {}
    for name, c in runs:
        _, res[name], leaves, finals[name], _, _ = _train_path(rctx, c)
        init = leaves if init is None else init
        print(f"  ring train {name}: {res[name]}", flush=True)
    gaps = {}
    for a, b in (("ring", "plain"), ("ring", "unpartitioned"),
                 ("unpartitioned", "plain")):
        x, y = np.array(res[a]["losses"]), np.array(res[b]["losses"])
        if not np.isfinite(x).all():
            raise AssertionError(f"ring train {a}: losses not finite: {x}")
        gaps[f"{a}/{b}"] = float(np.max(np.abs(x - y)
                                        / np.maximum(1.0, np.abs(y))))
    res["max_rel_gaps"] = gaps
    if not all(g <= TRAIN_TOL for g in gaps.values()):
        raise AssertionError(f"ring train: loss trajectories differ: {gaps}")
    res["params"] = param_gaps(init, finals,
                               names=("ring", "unpartitioned", "plain"))
    print(f"  ring train params: {res['params']}", flush=True)
    _ring_launches_ok(rctx["device"], res["ring"], "ring train",
                      train=True)
    _walks_k1_tables(rctx["device"], res["unpartitioned"], "ring train")
    if any(res["plain"]["launches"].values()):
        raise AssertionError(f"ring train plain: kernels launched: "
                             f"{res['plain']['launches']}")
    return res


# -- bfloat16 for K11, K12 and K13 --------------------------------------------

# a competitor within this share of the row's largest |score| of the
# target's score is a near-tie in bfloat16: the kernels and the plain
# versions round the final step's layers at the same points, and a float32
# sum that lands on a rounding boundary on one side only moves a table entry
# by a bfloat16 step (2^-8 of it at most)
BF16_NEAR_TIE = 1e-3


def _mixed_bounds(parts, nbytes: float) -> dict:
    """The least time of a call whose operations run at several rates:
    the larger of its bytes over the card's memory rate and the sum over
    `parts` (flops, the peak rate of their type, the rate of their design)
    of flops over rate ("bound_ms"), and the same at the designs' rates
    ("bound_tf32_ms")."""
    t_b = nbytes / H100_BYTES_S
    t_f = sum(f / rate for f, rate, _ in parts)
    t_d = sum(f / rate for f, _, rate in parts)
    return {"bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "bound_tf32_ms": max(t_b, t_d) * 1e3}


def phase_bf16_k11(ctx, bf16_path) -> dict:
    """K11 in its bfloat16 mode on ``eval_batch``'s batch at full width,
    the histories rounded to bfloat16: against its plain bfloat16 version,
    the same query mask, the ranks equal on every real query but the
    counted near-ties (BF16_NEAR_TIE); the table its layer launches write
    under BF16_RULE (the plain float32 version on the same histories the
    yardstick), the BCE within SCALED_TOL relative (as float32's K11 and
    K3's bfloat16 loss are held); four launches a call, two runs
    bit-equal; times (its two bfloat16 layer launches and its float32 rank
    launch apart) and bounds. Then GRRGCN's valid sweep
    in bfloat16 with fused_eval on, kernels and plain: the same mask, MRR
    within MRR_TOL of each other and of `bf16_path`'s sweep without the
    switch (the unfused bfloat16 eval); K11 launched, K3-K5 not."""
    import numpy as np
    import torch

    from temp_tpu_torch.ops import fused_final as ff

    BF = torch.bfloat16
    dev, eb = ctx["device"], eval_batch(ctx)
    h0, hist1, hist2, gr, q, wrel, loop1, loop2, g1, g2, rtab = eb["args"]
    h1, h2 = hist1.to(BF).contiguous(), hist2.to(BF).contiguous()
    args = (h0, h1, h2, gr, q, wrel, loop1, loop2, g1, g2, rtab)
    args32 = (h0, h1.float(), h2.float()) + args[3:]
    on_card = dev.type == "cuda"
    with torch.no_grad():
        n0 = ff.fused_eval_ranks.launches
        ranks, mask, bce = ff.fused_eval_ranks(*args, hot=BF)
        per_call = ff.fused_eval_ranks.launches - n0
        if per_call != (4 if on_card else 0):
            raise AssertionError(f"K11 bf16: {per_call} launches a call")
        r_p, m_p, bce_p = ff.fused_eval_ranks_plain(*args, hot=BF)
        table, _ = ff._encoder_plain(h0, h1, h2, gr, wrel, loop1, loop2, g1,
                                     g2, BF)
        table_f, _ = ff._encoder_plain(*args32[:4], wrel, loop1, loop2, g1,
                                       g2)
        # the table the kernel's bfloat16 layer launches write
        table_k = table
        if on_card:
            layers, _, table_k = ff.fused_eval_ranks_launchers(*args, hot=BF)
            layers()
        near = near_ties(table, rtab, q, BF16_NEAR_TIE) & mask
        if not torch.equal(mask, m_p):
            raise AssertionError("K11 bf16: query masks differ")
        off = (ranks != r_p) & mask
        if bool((off & ~near).any()):
            raise AssertionError(f"K11 bf16: {int((off & ~near).sum())} "
                                 f"ranks differ from the plain version's "
                                 f"away from a near-tie")
        # the layers' table under BF16_RULE; the BCE, a mean of softplus
        # terms where bfloat16's roundings average out below float32's
        # resolution (the rule's yardstick is then float32 noise), held as
        # float32's K11 holds it (SCALED_TOL relative), as K3's loss is
        errs = _errs([("table", table_k, table, table_f)], "K11 bf16 layers")
        bce_err = float(((bce - bce_p).abs()
                         / bce_p.abs().clamp(min=1e-30)).max())
        if not (bce_err <= SCALED_TOL and bool(torch.isfinite(bce).all())):
            raise AssertionError(f"K11 bf16: BCE relative error {bce_err} > "
                                 f"{SCALED_TOL}")
        bitwise = _bitwise((ranks, bce),
                           ff.fused_eval_ranks(*args, hot=BF)[::2])
        if not bitwise:
            raise AssertionError("K11 bf16: two runs differ")
    B, N, d = hist1.shape
    Q, E = q.src.shape[1], gr.src.shape[1]
    n_q = float(q.mask.sum())
    edges = float(gr.emf.sum())
    # K11's counts (phase_k11), the histories read in bfloat16: its layers'
    # products of bfloat16 operands, its ranks' of float32 ones
    layer_flops = B * 2 * 14 * N * d * d + 2 * edges * 3 * d
    rank_flops = 2 * n_q * (N + 1) * 2 * d
    nbytes = (4 * (N * d + 2 * B * N + wrel.numel() + 2 * 7 * d * d
                   + rtab.numel() + 5 * B * (E + Q) + 2 * B * Q + B)
              + 2 * 2 * B * N * d)
    layer_bytes = (4 * (3 * B * N * d + N * d + 2 * B * N + wrel.numel()
                        + 2 * 7 * d * d + 5 * B * E) + 2 * 2 * B * N * d)
    rank_bytes = 4 * (B * N * d + rtab.numel() + 4 * B * Q
                      + 2 * B * ff._N_SPLIT * Q + B * Q)
    with torch.no_grad():
        out = {"shape": f"B={B} N={N} E={E} Q={Q} d={d} real queries="
                        f"{int(n_q)}, bf16 histories",
               "max_abs_err": float((bce - bce_p).abs().max()),
               "bce_rel_err": bce_err, "table_max_abs_err":
                   errs["abs"]["table"]["abs"],
               "rms_ratio": errs["ratio"]["table"],
               "rank_mismatches": int(off.sum()),
               "near_ties": int(near.sum()), "bitwise": bitwise,
               "launches_per_call": per_call,
               "ms": time_ms(lambda: ff.fused_eval_ranks(*args, hot=BF), dev,
                             reps=10),
               "plain_ms": time_ms(lambda: ff.fused_eval_ranks_plain(
                   *args, hot=BF), dev, reps=5),
               "plain_f32_ms": time_ms(lambda: ff.fused_eval_ranks_plain(
                   *args32), dev, reps=5),
               "library_ms": None,
               **_mixed_bounds(((layer_flops, H100_BF16_FLOPS,
                                 H100_TF32_FLOPS),
                                (rank_flops, H100_F32_FLOPS,
                                 H100_TF32X3_FLOPS)), nbytes)}
        parts = {"layers": _mixed_bounds(((layer_flops, H100_BF16_FLOPS,
                                           H100_TF32_FLOPS),), layer_bytes),
                 "ranks": _mixed_bounds(((rank_flops, H100_F32_FLOPS,
                                          H100_TF32X3_FLOPS),), rank_bytes)}
        launchers = (ff.fused_eval_ranks_launchers(*args, hot=BF)[:2]
                     if on_card else (None, None))
        for (name, part), fn in zip(parts.items(), launchers):
            part["ms"] = None if fn is None else time_ms(fn, dev, reps=10)
            part["bound_share"] = (None if fn is None
                                   else part["bound_ms"] / part["ms"])
            out[name] = part
    out["bound_share"] = out["bound_ms"] / out["ms"]
    print(f"  K11 bf16: {out}", flush=True)

    cfg = ctx["cfg"].replace(compute_dtype="bfloat16", fused_eval=True)
    runs = {}
    for name, kernels in (("kernels", True), ("plain", False)):
        m, rk, mk = _sweep(ctx, cfg.replace(kernels=kernels))
        runs[name] = (rk, mk)
        out[f"eval_{name}"] = m
        print(f"  bf16 fused eval {name}: {m}", flush=True)
    k, pl = out["eval_kernels"], out["eval_plain"]
    (rk, mk), (rp, mp) = runs["kernels"], runs["plain"]
    if not (np.array_equal(mk, mp) and np.isfinite(k["mrr"])
            and 0.0 < k["mrr"] <= 1.0):
        raise AssertionError(f"bf16 fused eval: masks differ or bad MRR {k}")
    out["mrr_gaps"] = {"kernels/plain": abs(k["mrr"] - pl["mrr"]),
                       "kernels/unfused": abs(k["mrr"] - bf16_path[
                           "eval_kernels"]["mrr"])}
    if not all(g <= MRR_TOL for g in out["mrr_gaps"].values()):
        raise AssertionError(f"bf16 fused eval: MRR gaps {out['mrr_gaps']} "
                             f"> {MRR_TOL}")
    n = k["launches"]
    if on_card and not (n["fused_eval_ranks"] > 0 and n["fused_window_fwd"]
                        and not any(n[x] for x in (
                            "fused_final_fwd", "fused_final_bwd_loss",
                            "fused_final_bwd_layer", "fused_window_mb_fwd",
                            "ring_spmm_fwd"))):
        raise AssertionError(f"bf16 fused eval launches {n}")
    if any(pl["launches"].values()):
        raise AssertionError(f"bf16 fused eval plain launched kernels: "
                             f"{pl['launches']}")
    out["same_rank_share"] = float(np.mean(rk[mk] == rp[mp]))
    return out


def _element(a: dict, b: int) -> dict:
    """Element b of ``window_args``' dict of B windows (its per-window
    tensors sliced, the weights as they are)."""
    per = ("h0x", "src", "dst", "rel", "em", "gidx", "live", "dt", "m1",
           "m2")
    return {k: v[b:b + 1] if k in per and v is not None else v
            for k, v in a.items()}


def _k2f_bf16_work(ctx, win, conv1_in: bool, p) -> tuple:
    """(flops, bytes) of K2f's bfloat16 mode on `win`'s windows: per active
    row the gate products and the self-loops, the SpMMs over the real
    edges; the input read in float32, the two buffers written in bfloat16,
    the dropout masks read in training."""
    L1, d = ctx["L1"], ctx["d"]
    rows = int(win.act_mask[:, :L1].sum())
    edges = int(win.emask[:, :L1].sum())
    n_rel = p["encoder"]["layer1"]["weight"].shape[0]
    w_bytes = (2 * d * 3 * d * 2 + 2 * d * d + n_rel * 2 * d) * 4
    n_conv = 1 if conv1_in else 2
    flops = (rows * (4 * 2 * d * 3 * d + n_conv * 2 * d * d)
             + n_conv * edges * 3 * d)
    nbytes = (rows * d * (4 + 2 * 2 + (0 if conv1_in else 2 * 4))
              + edges * 16 + rows * 12 + w_bytes)
    return flops, nbytes


def phase_bf16_mb(ctx, fctx) -> dict:
    """fused_window_mb on in bfloat16: K12's bfloat16 mode in train mode
    (dropout masks) and in eval mode (the conv1 table) on ``window_batch``'s
    windows, bit-equal to K2f's bfloat16 launches one element at a time
    (the JAX module builds its batched window to give the values of B
    per-element windows), against its plain bfloat16 version under
    BF16_RULE, two runs bit-equal, with times and bounds; then
    TRAIN_STEPS fused bfloat16 training steps of GRRGCN and of the
    flagship and GRRGCN's bfloat16 sweep with the switch on, held to the
    bf16_path and bf16_flagship_path runs without it (losses within
    LOSS_TOL, each leaf within BF16_PARAM_TOL of the run's change, MRR
    within MRR_TOL); K12 launched there and K2f not."""
    import numpy as np
    import torch

    from temp_tpu_torch.ops import fused_window as fw
    from temp_tpu_torch.ops.fused_window_mb import (
        fused_window_mb_fwd, fused_window_mb_fwd_plain,
    )

    BF = torch.bfloat16
    dev, p, cfg = ctx["device"], ctx["params"], ctx["cfg"]
    out = {}
    for tag, conv1_in in (("train", False), ("eval", True)):
        win, kw = window_batch(ctx, conv1_in)
        kw.pop("conv1_in")
        B, L1, A, d = kw["h0_xs"].shape
        masks = None
        if not conv1_in:
            keep = 1.0 - cfg.dropout
            gen = torch.Generator(device=dev).manual_seed(0)
            masks = tuple((torch.rand(B, L1, A, d, generator=gen,
                                      device=dev) < keep)
                          .to(torch.float32) / keep for _ in range(2))
        a = dict(fw.window_args(p["encoder"], cfg, masks=masks, **kw),
                 conv1_in=conv1_in)
        with torch.no_grad():
            got = fused_window_mb_fwd(**a, hot=BF)
            per = [fw.fused_window_fwd(**_element(a, b), hot=BF)
                   for b in range(B)]
            if not all(torch.equal(x[b:b + 1], y[i]) for b, y in
                       enumerate(per) for i, x in enumerate(got)):
                raise AssertionError(f"K12 bf16 {tag}: not the per-element "
                                     f"K2f bf16 launches' bits")
            pb = fused_window_mb_fwd_plain(**a, hot=BF)
            pf = fused_window_mb_fwd_plain(**a)
            bitwise = _bitwise(got, fused_window_mb_fwd(**a, hot=BF))
            if not bitwise:
                raise AssertionError(f"K12 bf16 {tag}: two runs differ")
        errs = _errs(((f"buf{i + 1}", got[i], pb[i], pf[i])
                      for i in range(2)), f"K12 bf16 {tag}")
        flops, nbytes = _k2f_bf16_work(ctx, win, conv1_in, p)
        with torch.no_grad():
            out[tag] = _bf16_case(
                lambda: fused_window_mb_fwd(**a, hot=BF),
                lambda: fused_window_mb_fwd_plain(**a, hot=BF),
                lambda: fused_window_mb_fwd_plain(**a), errs, flops, nbytes,
                f"B={B} L1={L1} A={A} E={ctx['E']} d={d}, {tag} mode", dev,
                reps=5, plain_reps=2)
        out[tag].update(bitwise=bitwise, per_element_bitwise=True)
        print(f"  K12 bf16 {tag}: {out[tag]}", flush=True)

    for tag, c, flagship in (("train_steps", ctx, False),
                             ("flagship_train_steps", fctx, True)):
        mb_cfg = c["cfg"].replace(compute_dtype="bfloat16",
                                  fused_window_mb=True)
        model, r, _, finals, _, _ = _train_path(c, mb_cfg)
        if not model.fused_window_mb_on(mb_cfg.train_seq_len, train=True):
            raise AssertionError(f"bf16 mb {tag}: the batched window is off")
        ref = c["bf16_ref"]
        x, y = np.array(r["losses"]), np.array(ref["losses"])
        r["loss_gap"] = float(np.max(np.abs(x - y)
                                     / np.maximum(1.0, np.abs(y))))
        r["bitwise"] = bool(np.array_equal(x, y)) and all(
            torch.equal(u, v) for u, v in zip(finals, ref["params"]))
        if not (np.isfinite(x).all() and r["loss_gap"] <= LOSS_TOL):
            raise AssertionError(f"bf16 mb {tag}: losses differ from the "
                                 f"run without the switch: {r}")
        r["params"] = param_gaps(ref["init"], {"mb": finals,
                                               "fused": ref["params"]},
                                 names=("mb", "fused"), tol=BF16_PARAM_TOL)
        n = r["launches"]
        want = _train_kernels(flagship, mb=True)["fused"]
        if dev.type == "cuda" and not (all(n[k] > 0 for k in want)
                                       and n["fused_window_fwd"] == 0):
            raise AssertionError(f"bf16 mb {tag} missed a kernel: {n}")
        out[tag] = r
        print(f"  bf16 mb {tag}: {r}", flush=True)

    m, ranks, mask = _sweep(ctx, cfg.replace(compute_dtype="bfloat16",
                                             fused_window_mb=True))
    rk, mk = ctx["bf16_ref"]["ranks"]
    m["ranks_equal"] = bool(np.array_equal(mask, mk)
                            and np.array_equal(ranks[mask], rk[mk]))
    m["mrr_gap"] = abs(m["mrr"] - ctx["bf16_ref"]["mrr"])
    if not (np.array_equal(mask, mk) and m["mrr_gap"] <= MRR_TOL):
        raise AssertionError(f"bf16 mb eval: differs from the sweep without "
                             f"the switch: {m}")
    n = m["launches"]
    if dev.type == "cuda" and not (n["fused_window_mb_fwd"] > 0
                                   and n["fused_window_fwd"] == 0):
        raise AssertionError(f"bf16 mb eval missed K12: {n}")
    out["eval_sweep"] = m
    print(f"  bf16 mb eval: {m}", flush=True)
    return out


def _ring_card_launch(which: int, B: int, m: int, rows: int, n_rels: int,
                      d: int, s: int, vec: int) -> dict:
    """The whole-card bf16 ring kernel `which` (0 forward, 1 backward) as
    its launcher launches it for these arguments: the grid's blocks,
    registers and local bytes a thread, threads a block and resident blocks
    an SM, all from the library (``ring_bf16_occupancy``)."""
    import ctypes

    from temp_tpu_torch import _build

    occ = (ctypes.c_int * 5)()
    _build.check(_build.lib().ring_bf16_occupancy(
        which, B, m, rows, n_rels, d, s, vec, ctypes.addressof(occ)),
        "ring_bf16_occupancy")
    return dict(zip(("blocks", "registers", "threads", "blocks_per_sm",
                     "local_bytes"), occ))


def phase_bf16_k13(rctx) -> dict:
    """K13 and its backward in their bfloat16 mode at ``_k13_cases``'
    shapes (the final snapshot and a window step, s = 1), over the data's
    tables, on the whole-card route (every rank on the one card): out,
    norm^2, dh and dw bit-equal to the stepped bfloat16 route's
    (``_ring_fwd_steps``, ``_ring_bwd_steps``, called here on the same
    tables); against their plain bfloat16 versions under BF16_RULE (the
    plain float32 versions the yardstick), norm^2 to SCALED_TOL, rows
    without in-edges exactly 0, one launch a forward call and one a
    backward call, no sort, two runs bit-equal, RingSpMM's gradients the
    backward's bits; times (the stepped route's beside them), bounds (h
    read as float32), the library's: one ``index_add_`` of the same
    rounded messages, two of the same per-edge cotangents; each launch's
    blocks and registers. Then block-diagonal weights (s = 2) at the
    window step's shape (``_bf16_k13_blocks``)."""
    import torch

    from temp_tpu_torch.parallel import ring_spmm as rs
    from temp_tpu_torch.parallel.ring_spmm import (
        ring_spmm, ring_spmm_bwd, ring_spmm_bwd_plain, ring_spmm_fwd,
        ring_spmm_fwd_plain,
    )

    BF = torch.bfloat16
    dev = rctx["device"]
    devices = rctx["mesh"].devices[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    on_card = dev.type == "cuda"
    out = {}

    def rb(x):
        return x.to(BF).to(torch.float32)

    for tag, args, r, tables in _k13_cases(rctx):
        h, w, src, dst, rel, em = args
        ring = (RING_M, r, devices)
        with torch.no_grad():
            before = ring_spmm_fwd.launches
            builds = ring_spmm_fwd.csr_builds
            got, n2 = ring_spmm_fwd(*args, *ring, tables=tables, hot=BF)
            per_call = ring_spmm_fwd.launches - before
            if (ring_spmm_fwd.csr_builds != builds
                    or per_call != (1 if on_card else 0)):
                raise AssertionError(f"K13 bf16 {tag}: {per_call} launches, "
                                     f"{ring_spmm_fwd.csr_builds - builds} "
                                     f"sorts with the tables")
            bitwise = _bitwise((got, n2), ring_spmm_fwd(
                *args, *ring, tables=tables, hot=BF))
            pb, n2p = ring_spmm_fwd_plain(*args, *ring, hot=BF)
            pf, _ = ring_spmm_fwd_plain(*args, *ring)
            stepped, stepped_ms, launch = None, None, None
            if on_card:  # the stepped route on the same tables
                em_k = rs._kernel_args(h, w, em, devices, 1, "bf16_k13", BF)

                def steps():
                    return rs._ring_fwd_steps(h, w, em_k, *ring, 1, *tables,
                                              hot=BF)

                stepped = _bitwise((got, n2), steps())
                stepped_ms = time_ms(steps, dev)
                launch = _ring_card_launch(
                    0, h.shape[0], RING_M, r, w.shape[0], h.shape[2], 1,
                    rs._vec(h.shape[2], 1, h, w, got))
        if not bitwise:
            raise AssertionError(f"K13 bf16 {tag}: two runs differ")
        if stepped is False:
            raise AssertionError(f"K13 bf16 {tag}: the whole-card route "
                                 f"differs from the stepped route")
        errs = _errs([("out", got, pb, pf)], f"K13 bf16 {tag}")
        scaled = scaled_errs([(f"K13 bf16 {tag} norm^2", n2, n2p)])
        b_e = _graph_index(src)
        fed = torch.zeros(h.shape[:2], dtype=torch.bool, device=dev)
        fed[b_e[em.bool()], dst[em.bool()].long()] = True
        if not bool((got[~fed] == 0).all()):
            raise AssertionError(f"K13 bf16 {tag}: rows without in-edges "
                                 f"not 0")
        # the library yardstick: one index_add_ of the same rounded
        # messages (computed outside the timing)
        emf = em.to(torch.float32)
        seg = (b_e * h.shape[1] + dst.long()).reshape(-1)
        msg = (rb(rb(h[b_e, src.long()]) * rb(w[rel.long()]))
               * emf[..., None]).reshape(-1, h.shape[2])
        lib = torch.zeros(h.shape[0] * h.shape[1], h.shape[2], device=dev)
        bound_ms, bound_by, _ = _ring_bound(h, w, src, rel, em)
        with torch.no_grad():
            out[tag] = {
                "shape": f"B={h.shape[0]} rows={h.shape[1]} "
                         f"E={src.shape[1]} kept={int(em.sum())} "
                         f"R={w.shape[0]} d={h.shape[2]} m={RING_M}, bf16",
                "max_abs_err": errs["abs"]["out"]["abs"],
                "rms_ratio": errs["ratio"]["out"], "scaled_errs": scaled,
                "bitwise": bitwise, "stepped_bitwise": stepped,
                "launches_per_call": per_call, "launch": launch,
                "ms": time_ms(lambda: ring_spmm_fwd(
                    *args, *ring, tables=tables, hot=BF), dev),
                "stepped_ms": stepped_ms,
                "plain_ms": time_ms(lambda: ring_spmm_fwd_plain(
                    *args, *ring, hot=BF), dev, reps=5),
                "plain_f32_ms": time_ms(lambda: ring_spmm_fwd_plain(
                    *args, *ring), dev, reps=5),
                "library_ms": time_ms(
                    lambda: lib.zero_().index_add_(0, seg, msg), dev),
                "bound_ms": bound_ms, "bound_by": bound_by}
        out[tag]["bound_share"] = out[tag]["bound_ms"] / out[tag]["ms"]
        print(f"  K13 bf16 {tag}: {out[tag]}", flush=True)

        # the backward: the final step trains on the 50% subsample
        if tag == "final":
            sub = em & (torch.rand(em.shape, generator=gen, device=dev) < 0.5)
            args = (h, w, src, dst, rel, sub)
        h, w, src, dst, rel, em = args
        with torch.no_grad():
            _, n2 = ring_spmm_fwd(*args, *ring, tables=tables, hot=BF)
        g = torch.randn(h.shape, generator=gen, device=dev)
        bwd_args = (g, n2, h, w, src, dst, rel, em, *ring)
        before = ring_spmm_bwd.launches
        dh, dw = ring_spmm_bwd(*bwd_args, tables=tables, hot=BF)
        per_call = ring_spmm_bwd.launches - before
        if per_call != (1 if on_card else 0):
            raise AssertionError(f"K13b bf16 {tag}: {per_call} launches")
        stepped, stepped_ms, launch = None, None, None
        if on_card:  # the stepped route on the same tables
            em_k = rs._kernel_args(h, w, em, devices, 1, "bf16_k13", BF)

            def steps():
                return rs._ring_bwd_steps(g, n2, h, w, em_k, *ring, 1,
                                          *tables, hot=BF)

            stepped = _bitwise((dh, dw), steps())
            stepped_ms = time_ms(steps, dev)
            launch = _ring_card_launch(
                1, h.shape[0], RING_M, r, w.shape[0], h.shape[2], 1,
                rs._vec(h.shape[2], 1, g, h, w, dh, dw))
        if stepped is False:
            raise AssertionError(f"K13b bf16 {tag}: the whole-card route "
                                 f"differs from the stepped route")
        again = ring_spmm_bwd(*bwd_args, tables=tables, hot=BF)
        ph, pw = ring_spmm_bwd_plain(*bwd_args, hot=BF)
        fh, fw_ = ring_spmm_bwd_plain(*bwd_args)
        errs = _errs([("dh", dh, ph, fh), ("dw", dw, pw, fw_)],
                     f"K13b bf16 {tag}")
        ah, aw = h.detach().clone().requires_grad_(), w.detach().clone(
        ).requires_grad_()
        (ring_spmm(ah, aw, *args[2:], *ring, tables=tables, hot=BF)
         * g).sum().backward()
        bitwise = (_bitwise((dh, dw), again) and torch.equal(ah.grad, dh)
                   and torch.equal(aw.grad, dw))
        if not bitwise:
            raise AssertionError(f"K13b bf16 {tag}: not the same bits twice")
        # the library yardstick: two index_add_ of the per-edge cotangents
        # of the same dmsg on the rounded residuals
        emf = em.to(torch.float32)[..., None]
        d_ = h.shape[2]
        b_e = _graph_index(src)
        dmsg = ((g * n2[..., None])[b_e, dst.long()] * emf).reshape(-1, d_)
        mh = dmsg * rb(w[rel.long()]).reshape(-1, d_)
        mw = dmsg * rb(h[b_e, src.long()]).reshape(-1, d_)
        src_seg = (b_e * h.shape[1] + src.long()).reshape(-1)
        lib_h = torch.zeros(h.shape[0] * h.shape[1], d_, device=dev)
        lib_w = torch.zeros_like(w)

        def library():
            lib_h.zero_().index_add_(0, src_seg, mh)
            lib_w.zero_().index_add_(0, rel.long().reshape(-1), mw)

        bound_ms, bound_by, _ = _ring_bwd_bound(h, w, src, dst, rel, em)
        out[f"bwd_{tag}"] = {
            "shape": f"B={h.shape[0]} rows={h.shape[1]} E={src.shape[1]} "
                     f"kept={int(em.sum())} R={w.shape[0]} d={d_} "
                     f"m={RING_M}, bf16",
            "max_abs_err": max(e["abs"] for e in errs["abs"].values()),
            "rms_ratio": max(errs["ratio"].values()),
            "rms_ratios": errs["ratio"], "bitwise": bitwise,
            "stepped_bitwise": stepped, "launches_per_call": per_call,
            "launch": launch,
            "ms": time_ms(lambda: ring_spmm_bwd(*bwd_args, tables=tables,
                                                hot=BF), dev),
            "stepped_ms": stepped_ms,
            "plain_ms": time_ms(lambda: ring_spmm_bwd_plain(*bwd_args,
                                                            hot=BF),
                                dev, reps=5),
            "plain_f32_ms": time_ms(lambda: ring_spmm_bwd_plain(*bwd_args),
                                    dev, reps=5),
            "library_ms": time_ms(library, dev),
            "bound_ms": bound_ms, "bound_by": bound_by}
        out[f"bwd_{tag}"]["bound_share"] = (out[f"bwd_{tag}"]["bound_ms"]
                                            / out[f"bwd_{tag}"]["ms"])
        print(f"  K13b bf16 {tag}: {out[f'bwd_{tag}']}", flush=True)
    out["block_s2"] = _bf16_k13_blocks(rctx, gen)
    return out


def _bf16_k13_blocks(rctx, gen) -> dict:
    """K13 and K13b bf16 on the whole-card route with block-diagonal
    weights (s = 2: [R, (d / 2) * 2 * 2], seeded) at the window step's
    shape: out and dw within BF16_RULE of the plain bfloat16 versions, dh
    (its transpose reads the unrounded block weights, so its bfloat16 and
    float32 plain versions agree) within SCALED_TOL of the largest entry;
    one launch a call each."""
    import torch

    from temp_tpu_torch.parallel.ring_spmm import (
        ring_spmm_bwd, ring_spmm_bwd_plain, ring_spmm_fwd,
        ring_spmm_fwd_plain,
    )

    BF, dev = torch.bfloat16, rctx["device"]
    _, (h, w, *edges), r, tables = _k13_cases(rctx)[1]
    w2 = 0.1 * torch.randn(w.shape[0], 2 * h.shape[2], generator=gen,
                           device=dev)
    args = (h, w2, *edges)
    ring = (RING_M, r, rctx["mesh"].devices[0])
    with torch.no_grad():
        before = ring_spmm_fwd.launches
        got, n2 = ring_spmm_fwd(*args, *ring, tables=tables, hot=BF)
        per_fwd = ring_spmm_fwd.launches - before
        pb, _ = ring_spmm_fwd_plain(*args, *ring, hot=BF)
        pf, _ = ring_spmm_fwd_plain(*args, *ring)
    g = torch.randn(h.shape, generator=gen, device=dev)
    before = ring_spmm_bwd.launches
    dh, dw = ring_spmm_bwd(g, n2, *args, *ring, tables=tables, hot=BF)
    per_bwd = ring_spmm_bwd.launches - before
    ph, pw = ring_spmm_bwd_plain(g, n2, *args, *ring, hot=BF)
    _, fw = ring_spmm_bwd_plain(g, n2, *args, *ring)
    res = {"rms_ratios": bf16_rule([("out", got, pb, pf), ("dw", dw, pw, fw)],
                                   "K13 bf16 s=2 window"),
           "dh": scaled_errs([("K13b bf16 s=2 window dh", dh, ph)]),
           "launches_per_call": [per_fwd, per_bwd]}
    if dev.type == "cuda" and (per_fwd, per_bwd) != (1, 1):
        raise AssertionError(f"K13 bf16 s=2: launches {res}")
    print(f"  K13/K13b bf16 s=2 window: {res}", flush=True)
    return res


def phase_bf16_ring(rctx, ring_path, ring_train) -> dict:
    """GRRGCN with edge_partition="ring_pallas" over RING_M ranks in
    bfloat16: the valid sweep and TRAIN_STEPS optimizer steps with the
    kernels and with their plain versions, from the same weights and
    draws: the same query mask, MRR within MRR_TOL, losses within
    TRAIN_TOL and each leaf within BF16_PARAM_TOL of the plain run's
    change; K13 and its backward launched in their bfloat16 mode on the
    whole-card route, one launch a SpMM call each (the sweep's calls, the
    steps' calls and their backward), none of K1 (the float32 SpMM outside
    a partition) or K2-K12, no sort in a call. Beside them the gaps to the
    float32 ring runs (`ring_path`, `ring_train`)."""
    import numpy as np

    cfg = rctx["cfg"].replace(compute_dtype="bfloat16")
    dev = rctx["device"]
    calls = _boundary_calls(dict(rctx, L1=cfg.train_seq_len - 1,
                                 T=rctx["data"].num_times))

    def one_a_call(run, want, train, tag):
        n = run["launches"]
        if dev.type == "cuda" and (n["ring_spmm_fwd"], n["ring_spmm_bwd"]) \
                != (want, want if train else 0):
            raise AssertionError(f"{tag}: K13 {n['ring_spmm_fwd']} and K13b "
                                 f"{n['ring_spmm_bwd']} launches, want "
                                 f"{want} SpMM calls one launch each")

    res, runs = {}, {}
    for name, c in (("kernels", cfg), ("plain", cfg.replace(kernels=False))):
        m, ranks, mask = _sweep(rctx, c)
        res[f"eval_{name}"] = m
        runs[name] = (ranks, mask)
        print(f"  bf16 ring path {name}: {m}", flush=True)
    k, pl = res["eval_kernels"], res["eval_plain"]
    (rk, mk), (rp, mp) = runs["kernels"], runs["plain"]
    if not (np.array_equal(mk, mp) and np.isfinite(k["mrr"])
            and 0.0 < k["mrr"] <= 1.0 and abs(k["mrr"] - pl["mrr"])
            <= MRR_TOL):
        raise AssertionError(f"bf16 ring path: kernels {k} vs plain {pl}")
    _ring_launches_ok(dev, k, "bf16 ring eval", train=False)
    one_a_call(k, calls["sweep"], False, "bf16 ring eval")
    if any(pl["launches"].values()):
        raise AssertionError(f"bf16 ring path plain: kernels launched: "
                             f"{pl['launches']}")
    init, finals = None, {}
    for name, c in (("ring", cfg), ("plain", cfg.replace(kernels=False))):
        _, res[name], init, finals[name], _, _ = _train_path(rctx, c)
        print(f"  bf16 ring train {name}: {res[name]}", flush=True)
    x, y = np.array(res["ring"]["losses"]), np.array(res["plain"]["losses"])
    if not np.isfinite(x).all():
        raise AssertionError(f"bf16 ring train: losses not finite: {x}")
    res["max_rel_gap"] = float(np.max(np.abs(x - y)
                                      / np.maximum(1.0, np.abs(y))))
    if not res["max_rel_gap"] <= TRAIN_TOL:
        raise AssertionError(f"bf16 ring train: loss trajectories differ: "
                             f"{res['max_rel_gap']} > {TRAIN_TOL}")
    res["params"] = param_gaps(init, finals, names=("ring", "plain"),
                               tol=BF16_PARAM_TOL)
    print(f"  bf16 ring train params: {res['params']}", flush=True)
    _ring_launches_ok(dev, res["ring"], "bf16 ring train", train=True)
    one_a_call(res["ring"], calls["step"] * rctx["train_steps"], True,
               "bf16 ring train")
    if any(res["plain"]["launches"].values()):
        raise AssertionError(f"bf16 ring train plain: kernels launched: "
                             f"{res['plain']['launches']}")
    f32 = np.array(ring_train["plain"]["losses"])
    res["loss_gap_to_f32"] = float(np.max(np.abs(y - f32)))
    res["loss_rel_gap_to_f32"] = res["loss_gap_to_f32"] / float(
        np.max(np.abs(f32)))
    res["mrr_gap_to_f32"] = pl["mrr"] - ring_path["plain"]["mrr"]
    res["ms_per_step_gap_to_f32"] = (res["ring"]["ms_per_step"]
                                     - ring_train["ring"]["ms_per_step"])
    res["same_rank_share"] = float(np.mean(rk[mk] == rp[mp]))
    return res


_KERNELS = (
    ("spmm_fwd", "temp_tpu_torch/csrc/spmm.cu",
     "temp_tpu/ops/pallas_spmm.py:110"),
    ("spmm_bwd", "temp_tpu_torch/csrc/spmm.cu",
     "temp_tpu/ops/pallas_spmm.py:160"),
    ("fused_window_fwd", "temp_tpu_torch/csrc/fused_window.cu",
     "temp_tpu/ops/fused_window.py:223"),
    ("fused_window_bwd", "temp_tpu_torch/csrc/fused_window.cu",
     "temp_tpu/ops/fused_window.py:246"),
    ("fused_final_fwd", "temp_tpu_torch/csrc/fused_final.cu",
     "temp_tpu/ops/fused_final.py:227"),
    ("fused_final_bwd_loss", "temp_tpu_torch/csrc/fused_final.cu",
     "temp_tpu/ops/fused_final.py:250"),
    ("fused_final_bwd_layer", "temp_tpu_torch/csrc/fused_final.cu",
     "temp_tpu/ops/fused_final.py:343"),
    ("bi_layer_fwd", "temp_tpu_torch/csrc/fused_final_bi.cu",
     "temp_tpu/ops/fused_final_bi.py:167,237"),
    ("bi_loss_fwd", "temp_tpu_torch/csrc/fused_final.cu",
     "temp_tpu/ops/fused_final_bi.py:252"),
    ("bi_layer_bwd", "temp_tpu_torch/csrc/fused_final_bi.cu",
     "temp_tpu/ops/fused_final_bi.py:305,388"),
    ("fused_eval_ranks", "temp_tpu_torch/csrc/fused_final.cu",
     "temp_tpu/ops/fused_final.py:547"),
    ("fused_window_mb_fwd", "temp_tpu_torch/csrc/fused_window.cu",
     "temp_tpu/ops/fused_window_mb.py:78"),
    ("ring_spmm_fwd", "temp_tpu_torch/csrc/ring_spmm.cu",
     "temp_tpu/parallel/ring_pallas.py:100"),
    ("ring_spmm_bwd", "temp_tpu_torch/csrc/ring_spmm.cu",
     "temp_tpu/parallel/ring_pallas.py:270"),
)

# the bfloat16 modes (phase_bf16_kernels' records, the bf16_path's
# launches): (wrapper, record, source, TPU kernel)
_KERNELS_BF16 = (
    ("fused_window_fwd", "k2f", "temp_tpu_torch/csrc/fused_window_bf16.cu",
     "temp_tpu/ops/fused_window.py:223"),
    ("fused_window_bwd", "k2b", "temp_tpu_torch/csrc/fused_window_bf16.cu",
     "temp_tpu/ops/fused_window.py:246"),
    ("fused_final_fwd", "k3", "temp_tpu_torch/csrc/fused_final_bf16.cu",
     "temp_tpu/ops/fused_final.py:227"),
    ("fused_final_bwd_loss", "k4", "temp_tpu_torch/csrc/fused_final_bf16.cu",
     "temp_tpu/ops/fused_final.py:250"),
    ("fused_final_bwd_layer", "k5",
     "temp_tpu_torch/csrc/fused_final_bf16.cu",
     "temp_tpu/ops/fused_final.py:343"),
)

# the flagship's bfloat16 modes (phase_bf16_flagship_kernels' records, the
# bf16_flagship_path's launches): (wrapper, record, source, TPU kernel)
_KERNELS_BF16_FLAGSHIP = (
    ("bi_layer_fwd", "k6k7", "temp_tpu_torch/csrc/fused_final_bi_bf16.cu",
     "temp_tpu/ops/fused_final_bi.py:167,237"),
    ("bi_loss_fwd", "k8", "temp_tpu_torch/csrc/fused_final_bf16.cu",
     "temp_tpu/ops/fused_final_bi.py:252"),
    ("bi_layer_bwd", "k9k10", "temp_tpu_torch/csrc/fused_final_bi_bf16.cu",
     "temp_tpu/ops/fused_final_bi.py:305,388"),
)

# the kernels of the line by their ids (PERF.md's table)
_IDS = {"spmm_fwd": "K1f", "spmm_bwd": "K1b", "fused_window_fwd": "K2f",
        "fused_window_bwd": "K2b", "fused_final_fwd": "K3",
        "fused_final_bwd_loss": "K4", "fused_final_bwd_layer": "K5",
        "bi_layer_fwd": "K6+K7", "bi_loss_fwd": "K8",
        "bi_layer_bwd": "K9+K10", "fused_eval_ranks": "K11",
        "fused_window_mb_fwd": "K12", "ring_spmm_fwd": "K13",
        "ring_spmm_bwd": "K13b"}

# the bfloat16 modes of K11-K13 (phases bf16_k11, bf16_mb, bf16_k13 and
# bf16_ring): (wrapper, source, TPU kernel, their records' phase and key,
# the phase and path whose run gives "launches")
_KERNELS_BF16_LAST = (
    ("fused_eval_ranks", "temp_tpu_torch/csrc/fused_final_bf16.cu",
     "temp_tpu/ops/fused_final.py:547", ("bf16_k11", None),
     ("bf16_k11", "eval_kernels")),
    ("fused_window_mb_fwd", "temp_tpu_torch/csrc/fused_window_bf16.cu",
     "temp_tpu/ops/fused_window_mb.py:78", ("bf16_mb", "train"),
     ("bf16_mb", "train_steps")),
    ("ring_spmm_fwd", "temp_tpu_torch/csrc/ring_spmm_bf16.cu",
     "temp_tpu/parallel/ring_pallas.py:100", ("bf16_k13", "final"),
     ("bf16_ring", "ring")),
    ("ring_spmm_bwd", "temp_tpu_torch/csrc/ring_spmm_bf16.cu",
     "temp_tpu/parallel/ring_pallas.py:270", ("bf16_k13", "bwd_final"),
     ("bf16_ring", "ring")),
)

# the path whose run gives each kernel's "launches"
_HOME = {"spmm_fwd": "eval", "spmm_bwd": "train_unfused",
         "bi_layer_fwd": "flagship_train_fused",
         "bi_loss_fwd": "flagship_train_fused",
         "bi_layer_bwd": "flagship_train_fused",
         "fused_eval_ranks": "eval_fused",
         "fused_window_mb_fwd": "train_fused_mb",
         "ring_spmm_fwd": "ring_train", "ring_spmm_bwd": "ring_train"}


def _paths(res: dict) -> dict:
    """Every path the phases ran with the kernels -> its launch counts."""
    out = {}
    for prefix, key in (("", "train"), ("flagship_", "flagship_train")):
        for p in ("fused", "unfused"):
            out[f"{prefix}train_{p}"] = res[key][p]["launches"]
    out["eval"] = res["path"]["kernels"]["launches"]
    out["flagship_eval"] = res["flagship_path"]["kernels"]["launches"]
    out["eval_fused"] = res["path_fused_eval"]["kernels"]["launches"]
    out["eval_mb"] = res["mb"]["eval"]["launches"]
    out["train_fused_mb"] = res["mb"]["train"]["launches"]
    out["flagship_train_fused_mb"] = res["mb"]["flagship_train"]["launches"]
    out["ring_eval"] = res["ring_path"]["kernels"]["launches"]
    out["ring_train"] = res["ring_train"]["ring"]["launches"]
    out["ted_eval"] = res["ted_path"]["kernels"]["launches"]
    out["ted_train"] = res["ted_train"]["kernels"]["launches"]
    for tag, r in {**res["variants"], **res["sa_variants"],
                   **res["rec_variants"], **res["zoo_variants"]}.items():
        out[f"{tag}_train"] = r["train"]["kernels"]["launches"]
        out[f"{tag}_eval"] = r["eval"]["launches"]
    for tag in ("sa", "bisa", "rrgcn", "birrgcn", "srgcn", "tdyn"):
        out[f"{tag}_train"] = res[f"{tag}_train"]["kernels"]["launches"]
        out[f"{tag}_eval"] = res[f"{tag}_path"]["kernels"]["launches"]
    for module, r in res["baselines"].items():
        out[f"{module}_train"] = r["train"]["launches"]
        out[f"{module}_eval"] = r["eval"]["launches"]
    out["agg_train"] = res["agg_train"]["kernels"]["launches"]
    out["agg_eval"] = res["agg_path"]["launches"]
    # fit's training steps and valid sweeps (per call), the predictions CLI
    out["fit_train"] = res["preempt"]["launches_a_step"]
    out["fit_eval"] = res["preempt"]["launches_a_sweep"]
    out["predictions_eval"] = res["predictions"]["kernels"]["launches"]
    # the default dtype's steps, the "onehot" rounding's, the partitions'
    if "auto_dtype" in res:
        for tag in ("grrgcn", "flagship"):
            out[f"auto_{tag}_train"] = res["auto_dtype"][tag]["launches"]
    if "onehot_bf16" in res:
        out["onehot_bf16_train"] = res["onehot_bf16"]["steps"]["kernels"][
            "launches"]
    if "boundary" in res:
        for dt, pre in (("float32", ""), ("bfloat16", "bf16_")):
            for part in ("train", "eval"):
                out[f"{pre}boundary_{part}"] = res["boundary"][dt][part][
                    "kernels"]["launches"]
        out["dp_mesh_train"] = res["dp_mesh"]["train"]["kernels"]["launches"]
        for mode in ("ring_pallas", "boundary"):
            for part in ("train", "eval"):
                out[f"flagship_{mode}_{part}"] = res["flagship_partition"][
                    part][mode]["launches"]
    return out


def kernels_line(res: dict) -> dict:
    """One record per kernel from the phases' results `res` (keyed by phase
    name): its numbers at the main paths' shapes, its launches on each path
    (``launches_by_path``: the eval sweeps and each training path of GRRGCN
    and of the flagship, with and without the switches that are off by
    default), and as ``launches`` those of the path that runs it (GRRGCN's
    fused training path; the eval sweep for K1f, the unfused training path
    for K1b, the flagship's fused training path for K6-K10, the fused eval
    sweep for K11, the fused training path with the batched window for
    K12, the ring_pallas training path for K13 and its backward)."""
    measured = {"spmm_fwd": res["k1"]["final"],
                "spmm_bwd": res["k1b"]["train"],
                "fused_window_fwd": res["k2"]["conv1_in"],
                "fused_window_bwd": res["k2b"]["bwd"],
                "fused_final_fwd": res["k3"],
                "fused_final_bwd_loss": res["k4"],
                "fused_final_bwd_layer": res["k5"],
                "bi_layer_fwd": res["k6k7"], "bi_loss_fwd": res["k8"],
                "bi_layer_bwd": res["k9k10"], "fused_eval_ranks": res["k11"],
                "fused_window_mb_fwd": res["mb"]["k12"],
                "ring_spmm_fwd": res["k13"]["final"],
                "ring_spmm_bwd": res["k13"]["bwd_final"]}
    paths = _paths(res)
    rec = []
    for name, src, replaces in _KERNELS:
        m = measured[name]
        by_path = {path: n[name] for path, n in paths.items()}
        r = {"name": name, "route": "cuda", "source": src,
             "replaces": replaces,
             "launches": by_path[_HOME.get(name, "train_fused")],
             "launches_by_path": by_path,
             "max_abs_err": m["max_abs_err"], "ms": m["ms"],
             "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
             "bound_by": m["bound_by"], "library_ms": m["library_ms"],
             "bound_share": m["bound_ms"] / m["ms"], "shape": m["shape"]}
        for k in ("bound_tc_ms", "bitwise", "scaled_errs"):
            if k in m:
                r[k] = m[k]
        if name == "fused_window_fwd":
            r["train_mode"] = {k: res["k2b"]["fwd"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_tc_ms", "bound_share",
                "max_abs_err", "bitwise")}
            r["recompute_mode"] = {k: res["k2"]["recompute"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_tc_ms", "bound_share",
                "max_abs_err", "bitwise")}
        if name in ("fused_window_fwd", "fused_window_bwd"):
            part = "fwd" if name == "fused_window_fwd" else "bwd"
            keys = ("ms", "plain_ms", "bound_ms", "bound_share",
                    "bound_tc_ms", "bitwise")
            r["flagship_mode"] = {
                d: {k: res["k2_flagship"][d][f"{part}_{k}"] for k in keys}
                for d in ("fwd", "bwd")}
            # the TeMP variants' modes: (a) 3 buffers, no ReLU; (b) 2, ReLU
            r["extra_modes"] = {
                mode: {"shape": m["shape"], **{k: m[part][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms",
                    "bound_share", "max_abs_err", "bitwise")}}
                for mode, m in res["k2_modes"].items()}
        if name == "bi_layer_bwd":
            r["gru_launch"] = {k: m[f"gru_{k}"] for k in (
                "ms", "bound_ms", "bound_by", "bound_tc_ms", "bound_share")}
        if name == "fused_eval_ranks":
            r["unfused_ms"] = m["unfused_ms"]
        parts = {"fused_final_fwd": ("layers", "scores"),
                 "fused_eval_ranks": ("layers", "ranks")}
        for part in parts.get(name, ()):
            r[part] = {k: m[part][k] for k in (
                "ms", "bound_ms", "bound_by", "bound_tc_ms", "bound_share")}
        if name in ("spmm_fwd", "spmm_bwd"):
            # the table route (ms) beside the route that sorts in the call
            r["in_call_ms"], r["bitwise"] = m["in_call_ms"], m["bitwise"]
            other = (("table", "train") if name == "spmm_fwd"
                     else ("final",))
            phase_res = res["k1" if name == "spmm_fwd" else "k1b"]
            # and at the attention models' history shapes and the linear
            # recurrence's window step
            part = "fwd" if name == "spmm_fwd" else "bwd"
            for tag, case in [(t, phase_res[t]) for t in other] + [
                    (f"{pre}_{t}", c) for pre in ("sa", "rrgcn")
                    for t, c in res[f"{pre}_k1"][part].items()]:
                r[tag] = {k: case[k] for k in (
                    "ms", "in_call_ms", "plain_ms", "library_ms",
                    "bound_ms", "max_abs_err", "bitwise", "shape")}
        if name in ("ring_spmm_fwd", "ring_spmm_bwd"):
            part = "window" if name == "ring_spmm_fwd" else "bwd_window"
            r["window_step"] = {k: res["k13"][part][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
                "shape")}
        if name == "ring_spmm_fwd":
            r["in_call_ms"] = m["in_call_ms"]
            r["window_step"]["in_call_ms"] = res["k13"]["window"][
                "in_call_ms"]
        rec.append(r)
    if "bf16_kernels" in res:
        # the bfloat16 modes, their launches on the bfloat16 fused training
        # path and the sweep
        bp = res["bf16_path"]
        # and the flagship's (its path's launches beside GRRGCN's), when
        # the flagship's bfloat16 phases ran
        fk = res.get("bf16_flagship_kernels")
        fp = res.get("bf16_flagship_path")
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "bound_share", "bound_tf32_ms", "rms_ratio",
                "plain_f32_ms", "shape")

        def by_path(name):
            out = {"bf16_train_fused": bp["fused"]["launches"][name],
                   "bf16_train_unfused": bp["unfused"]["launches"][name],
                   "bf16_eval": bp["eval_kernels"]["launches"][name]}
            if fp is not None:
                out.update({
                    "bf16_flagship_train_fused": fp["fused"]["launches"][name],
                    "bf16_flagship_train_unfused":
                        fp["unfused"]["launches"][name],
                    "bf16_flagship_eval":
                        fp["eval_kernels"]["launches"][name]})
            return out

        for name, tag, src, replaces in _KERNELS_BF16:
            m = res["bf16_kernels"][tag]
            r = {"name": f"{name}_bf16", "route": "cuda", "source": src,
                 "replaces": replaces,
                 "launches": bp["fused"]["launches"][name],
                 "launches_by_path": by_path(name),
                 **{k: m[k] for k in keys}}
            if tag == "k2f":
                r["train_mode"] = {k: res["bf16_kernels"]["k2f_train"][k]
                                   for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_tf32_ms", "rms_ratio",
                                             "max_abs_err", "bitwise")}
            if tag in ("k2f", "k2b"):
                # shared memory, threads and resident blocks an SM of each
                # window launch, bfloat16 and float32
                r["bitwise"], r["occupancy"] = m["bitwise"], m["occupancy"]
            if fk is not None and tag in ("k2f", "k2b"):
                # K2's flagship modes: the flagship's windows, modes (a)
                # and (b)
                part = "fwd" if tag == "k2f" else "bwd"
                r["flagship_modes"] = {
                    mode: {k: fk[f"k2_{mode}_{part}"][k]
                           for k in keys + ("bitwise",)}
                    for mode, *_ in _K2_BF16_MODES}
            if fk is not None and tag == "k4":
                r["bi_table"] = {k: fk["k4_bi"][k] for k in keys
                                 + ("bitwise",)}
            if tag == "k5":
                r["bitwise"], r["launch"] = m["bitwise"], m["launch"]
            if tag == "k3":
                # its layer launches (native bfloat16) and its score launch
                # apart, their bits against K2f's and K5's, the layer
                # launch's occupancy
                r.update({k: m[k] for k in ("bitwise", "shares", "launch")})
                for part in ("layers", "scores"):
                    r[part] = {k: m[part][k] for k in (
                        "ms", "bound_ms", "bound_by", "bound_tf32_ms",
                        "bound_share")}
            rec.append(r)
        if fk is not None:
            for name, tag, src, replaces in _KERNELS_BF16_FLAGSHIP:
                m = fk[tag]
                rec.append({"name": f"{name}_bf16", "route": "cuda",
                            "source": src, "replaces": replaces,
                            "launches": fp["fused"]["launches"][name],
                            "launches_by_path": by_path(name),
                            "bitwise": m["bitwise"],
                            **{k: m[k] for k in keys},
                            **{k: m[k] for k in (
                                "launch", "relu_fwd_flips", "recompute",
                                "layer1", "layer2") if k in m}})
    rec += _kernels_bf16_last(res)
    rec += _kernels_bf16_k1(res)
    rec += _kernels_onehot(res)
    for r in rec:
        if "id" in r:
            continue
        base = r["name"][:-len("_bf16")] if r["name"].endswith(
            "_bf16") else r["name"]
        r["id"] = _IDS[base] + ("_bf16" if base != r["name"] else "")
    return {"kernels": rec}


def _kernels_onehot(res: dict) -> list:
    """The records of K1f's and K1b's "onehot" rounding (the SpMM method
    "onehot" in bfloat16; JAX computes it with XLA ops, no Pallas kernel),
    when phase onehot_bf16 ran: their numbers at the final step's shape
    (K1b the training final step's; ``cases`` the other shapes) and their
    launches on GRRGCN's unfused bfloat16 training steps under that
    method."""
    if "onehot_bf16" not in res:
        return []
    oh = res["onehot_bf16"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "bound_share", "shape", "bitwise", "scaled_err")
    rec = []
    for name, tag, others in (("spmm_fwd", "final", ("table", "train")),
                              ("spmm_bwd", "bwd_train", ("bwd_final",))):
        n = oh["steps"]["kernels"]["launches"][f"{name}_onehot"]
        rec.append({
            "name": f"{name}_onehot_bf16",
            "id": _IDS[name] + "_onehot_bf16", "route": "cuda",
            "source": "temp_tpu_torch/csrc/spmm_bf16.cu",
            "replaces": "temp_tpu/ops/segment.py:165",
            "launches": n, "launches_by_path": {"onehot_bf16_train": n},
            **{k: oh[tag][k] for k in keys},
            "cases": {t: {k: oh[t][k] for k in keys} for t in others}})
    return rec


def _kernels_bf16_last(res: dict) -> list:
    """The records of K11's, K12's, K13's and K13b's bfloat16 modes, when
    their phases ran: their numbers at the main paths' shapes and their
    launches on their bfloat16 paths (K11 the fused eval sweep, K12 the
    fused training steps with the batched window, K13 and K13b the
    ring_pallas training steps; ``launches_by_path`` each path's)."""
    if "bf16_ring" not in res:
        return []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "bound_share", "rms_ratio", "plain_f32_ms",
            "shape", "bitwise")
    paths = {
        "bf16_eval_fused": res["bf16_k11"]["eval_kernels"]["launches"],
        "bf16_train_fused_mb": res["bf16_mb"]["train_steps"]["launches"],
        "bf16_flagship_train_fused_mb": res["bf16_mb"][
            "flagship_train_steps"]["launches"],
        "bf16_eval_mb": res["bf16_mb"]["eval_sweep"]["launches"],
        "bf16_ring_train": res["bf16_ring"]["ring"]["launches"],
        "bf16_ring_eval": res["bf16_ring"]["eval_kernels"]["launches"]}
    rec = []
    for name, src, replaces, (ph, key), (home, run) in _KERNELS_BF16_LAST:
        m = res[ph] if key is None else res[ph][key]
        r = {"name": f"{name}_bf16", "route": "cuda", "source": src,
             "replaces": replaces,
             "launches": res[home][run]["launches"][name],
             "launches_by_path": {p: n[name] for p, n in paths.items()},
             **{k: m[k] for k in keys}}
        if "bound_tf32_ms" in m:
            r["bound_tf32_ms"] = m["bound_tf32_ms"]
        if name == "fused_eval_ranks":
            for part in ("layers", "ranks"):
                r[part] = {k: m[part][k] for k in (
                    "ms", "bound_ms", "bound_by", "bound_tf32_ms",
                    "bound_share")}
        if name == "fused_window_mb_fwd":
            r["eval_mode"] = {k: res["bf16_mb"]["eval"][k] for k in keys}
        if name in ("ring_spmm_fwd", "ring_spmm_bwd"):
            part = "window" if name == "ring_spmm_fwd" else "bwd_window"
            card = ("stepped_ms", "stepped_bitwise", "launch",
                    "launches_per_call")
            r.update({k: m[k] for k in card})
            r["window_step"] = {k: res["bf16_k13"][part][k]
                                for k in keys + card}
        rec.append(r)
    return rec


# K1's bfloat16 mode (phases bf16_k1 and bf16_spmm_pallas): (wrapper, TPU
# kernel, its bf16_k1 record, the path whose run gives "launches")
_KERNELS_BF16_K1 = (
    ("spmm_fwd", "temp_tpu/ops/pallas_spmm.py:110", "final",
     "bf16_pallas_eval"),
    ("spmm_bwd", "temp_tpu/ops/pallas_spmm.py:160", "bwd_train",
     "bf16_pallas_sa_train"),
)


def _kernels_bf16_k1(res: dict) -> list:
    """The records of K1f's and K1b's bfloat16 modes, when their phases
    ran: their numbers at the main paths' shapes (the final step's, the
    training final step's for K1b; ``cases`` every other shape), and
    their launches under the SpMM method "pallas" (K1f GRRGCN's valid
    sweep, K1b SARGCN's training steps; ``launches_by_path`` each
    path's)."""
    if "bf16_spmm_pallas" not in res:
        return []
    pallas = res["bf16_spmm_pallas"]
    paths = {"bf16_pallas_eval": pallas["eval_kernels"]["launches"],
             "bf16_pallas_sa_train": pallas["sa_train"]["kernels"][
                 "launches"],
             "bf16_pallas_sa_eval": pallas["sa_path"]["kernels"][
                 "launches"]}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "bound_share", "rms_ratio", "plain_f32_ms",
            "shape", "bitwise", "scaled_err")
    rec = []
    for name, replaces, tag, home in _KERNELS_BF16_K1:
        bwd = name == "spmm_bwd"
        m = res["bf16_k1"][tag]
        rec.append({
            "name": f"{name}_bf16", "route": "cuda",
            "source": "temp_tpu_torch/csrc/spmm_bf16.cu",
            "replaces": replaces,
            "launches": paths[home][f"{name}_bf16"],
            "launches_by_path": {p: n[f"{name}_bf16"]
                                 for p, n in paths.items()},
            **{k: m[k] for k in keys},
            "cases": {t: {k: c[k] for k in keys}
                      for t, c in res["bf16_k1"].items()
                      if isinstance(c, dict) and t != tag
                      and t.startswith("bwd_") == bwd}})
    return rec


def sa_phases(ctx, train_steps=None) -> dict:
    """The attention models' phases (28-35 above) on the data of `ctx`,
    each printing its line: SARGCN's setup, sa_k1, train and path, then
    BiSARGCN's, then sa_variants; `train_steps` (default TRAIN_STEPS) the
    steps of the train phases. Returns their results by phase name."""
    res = {}
    for tag, config in (("sa", "config_sargcn.json"),
                        ("bisa", "config_bisargcn.json")):
        with phase(f"{tag}_setup", {}) as ss:
            sctx = phase_setup_config(ctx, config)
            if train_steps:
                sctx["train_steps"] = train_steps
            ss.update({k: sctx[k] for k in ("N", "A", "E", "L1", "B", "d")})
            ss["model"] = type(sctx["model"]).__name__
        if tag == "sa":
            with phase("sa_k1", {}) as sk:
                sk.update(phase_sa_k1(sctx))
                for part in ("fwd", "bwd"):
                    for case, r in sk[part].items():
                        sk[f"{part}_{case}_ms"] = r["ms"]
            res["sa_k1"] = sk
        with phase(f"{tag}_train", {}) as st:
            st.update(phase_train_unfused(sctx, _SA_TRAIN, _NOT_SA))
            st["ms_per_step_plain"] = st["plain"]["ms_per_step"]
            st["peak_mb"] = st["kernels"]["peak_mb"]
            for k in _SA_TRAIN:
                st[f"{k}_launches"] = st["kernels"]["launches"][k]
        res[f"{tag}_train"] = st
        with phase(f"{tag}_path", {}) as sp:
            sp.update(phase_k1_path(sctx, "attention"))
            for name in ("kernels", "plain"):
                sp[f"mrr_{name}"] = sp[name]["mrr"]
                sp[f"wall_s_{name}"] = sp[name]["wall_s"]
                sp[f"queries_per_s_{name}"] = sp[name]["queries_per_s"]
            sp["spmm_fwd_launches"] = sp["kernels"]["launches"]["spmm_fwd"]
            sp["peak_mb"] = sp["kernels"]["peak_mb"]
        res[f"{tag}_path"] = sp
        del sctx
    with phase("sa_variants", {}) as sv:
        sv.update(phase_variants(ctx, _SA_VARIANTS, _SA_TRAIN, ("spmm_fwd",),
                                 _NOT_SA))
        for tag in list(sv):
            if isinstance(sv[tag], dict):
                sv[f"{tag}_ms_per_step"] = sv[tag]["train"]["ms_per_step"]
    res["sa_variants"] = {t: sv[t] for t, _, _ in _SA_VARIANTS}
    return res


# the linear-recurrence and static models (models/dynamic.py,
# models/bidynamic.py, models/static.py): every graph product K1, no other
# kernel
_REC_MODELS = (("rrgcn", "config_rrgcn.json"),
               ("birrgcn", "config_birrgcn.json"),
               ("srgcn", "config_srgcn.json"))
_K1_ONLY = {"train_want": _SA_TRAIN, "train_banned": _NOT_SA,
            "eval_want": ("spmm_fwd",), "eval_banned": _NOT_SA}
_NOT_TRAINED_AFTER_DROP = ("fused_window_fwd", "fused_window_bwd",
                           "fused_eval_ranks", "fused_window_mb_fwd",
                           "ring_spmm_fwd", "ring_spmm_bwd")
# GRRGCN under random_dropout or DropEdge: training's windows step by step
# (K1), its final step fused (K3-K5), no K2; eval (no dropout) K2f and K1f
_DROP_GRU = {"fused": True,
             "train_want": _SA_TRAIN + ("fused_final_fwd",
                                        "fused_final_bwd_loss",
                                        "fused_final_bwd_layer"),
             "train_banned": _NOT_TRAINED_AFTER_DROP + (
                 "bi_layer_fwd", "bi_loss_fwd", "bi_layer_bwd"),
             "eval_want": ("spmm_fwd", "fused_window_fwd"),
             "eval_banned": _NOT_UNFUSED}
# the flagship under DropEdge: the same with K6-K10 and K4
_DROP_FLAGSHIP = {**_DROP_GRU,
                  "train_want": _SA_TRAIN + ("bi_layer_fwd", "bi_loss_fwd",
                                             "fused_final_bwd_loss",
                                             "bi_layer_bwd"),
                  "train_banned": _NOT_TRAINED_AFTER_DROP + (
                      "fused_final_fwd", "fused_final_bwd_layer")}
# GRRGCN's step-by-step training windows in bfloat16 (bf16_variants)
_BF16_DROP_VARIANTS = (
    ("grrgcn_random_dropout", "config_grrgcn.json",
     {"random_dropout": True, "compute_dtype": "bfloat16"}, _DROP_GRU),
    ("grrgcn_edge_dropout", "config_grrgcn.json",
     {"edge_dropout": True, "compute_dtype": "bfloat16"}, _DROP_GRU))
# the recurrent options, each with the kernels it must and must not launch
_REC_VARIANTS = (
    ("grrgcn_type1_lambda_temb", "config_grrgcn.json",
     {"type1": True, "learnable_lambda": True, "use_time_embedding": True},
     _K1_ONLY),
    ("grrgcn_rec_only", "config_grrgcn.json", {"rec_only_last_layer": True},
     _K1_ONLY),
    ("grrgcn_edge_dropout", "config_grrgcn.json", {"edge_dropout": True},
     _DROP_GRU),
    ("grrgcn_random_dropout", "config_grrgcn.json", {"random_dropout": True},
     _DROP_GRU),
    ("bigrrgcn_impute_edge_dropout", "config_bigrrgcn.json",
     {"impute": True, "edge_dropout": True}, _DROP_FLAGSHIP),
    ("bigrrgcn_aggregation_temb", "config_bigrrgcn.json",
     {"post_aggregation": True, "use_time_embedding": True}, _K1_ONLY),
    ("rrgcn_random_dropout", "config_rrgcn.json", {"random_dropout": True},
     _K1_ONLY),
    ("drgcn", "config_srgcn.json", {"module": "DRGCN"}, _K1_ONLY))


def k1_launches_a_step(c) -> int:
    """K1f's (and K1b's) launches in a training step of the model of c,
    whose every graph product is K1: two a step of each window (the
    batch's graphs side by side, one a layer), two a valid element's
    final snapshot (the first steps' batches hold no padding)."""
    cfg, model = c["cfg"], c["model"]
    windows = (0 if not model.recurrent
               else 2 if cfg.module.startswith("Bi") else 1)
    return 2 * (cfg.train_seq_len - 1) * windows + 2 * cfg.batch_size


def rec_phases(ctx, train_steps=None) -> dict:
    """The linear-recurrence and static models' phases (36-46 above) on
    the data of `ctx`, each printing its line: RRGCN's setup (with the
    seconds DropEdge's rates take at its window length), train and path,
    then BiRRGCN's and SRGCN's, then rec_variants; `train_steps` (default
    TRAIN_STEPS) the steps of the train phases. Returns their results by
    phase name."""
    from temp_tpu_torch.data.frequency import build_drop_rates

    res = {}
    for tag, config in _REC_MODELS:
        with phase(f"{tag}_setup", {}) as ss:
            c = phase_setup_config(ctx, config)
            if train_steps:
                c["train_steps"] = train_steps
            ss.update({k: c[k] for k in ("N", "A", "E", "L1", "B", "d")})
            ss["model"] = type(c["model"]).__name__
            if c["model"].recurrent:
                t0 = time.perf_counter()
                build_drop_rates(c["data"], c["cfg"].train_seq_len,
                                 c["cfg"].module.startswith("Bi"))
                ss["drop_rates_s"] = time.perf_counter() - t0
        if tag == "rrgcn":
            with phase("rrgcn_k1", {}) as rk:
                rk.update(phase_sa_k1(c, _rec_k1_cases(c)))
                for part in ("fwd", "bwd"):
                    for case, r in rk[part].items():
                        rk[f"{part}_{case}_ms"] = r["ms"]
            res["rrgcn_k1"] = rk
        with phase(f"{tag}_train", {}) as st:
            st.update(phase_train_unfused(c, _SA_TRAIN, _NOT_SA))
            steps = c.get("train_steps", TRAIN_STEPS)
            n = st["kernels"]["launches"]
            st["k1_launches_a_step"] = per = k1_launches_a_step(c)
            for k in _SA_TRAIN:
                st[f"{k}_launches"] = n[k]
            if ctx["device"].type == "cuda" and not (
                    n["spmm_fwd"] == n["spmm_bwd"] == per * steps):
                raise AssertionError(f"{tag} train: K1 launches {n}, not "
                                     f"{per} a step")
            st["ms_per_step_plain"] = st["plain"]["ms_per_step"]
            st["peak_mb"] = st["kernels"]["peak_mb"]
        res[f"{tag}_train"] = st
        with phase(f"{tag}_path", {}) as sp:
            sp.update(phase_k1_path(c, tag))
            for name in ("kernels", "plain"):
                sp[f"mrr_{name}"] = sp[name]["mrr"]
                sp[f"wall_s_{name}"] = sp[name]["wall_s"]
                sp[f"queries_per_s_{name}"] = sp[name]["queries_per_s"]
            sp["spmm_fwd_launches"] = sp["kernels"]["launches"]["spmm_fwd"]
            sp["peak_mb"] = sp["kernels"]["peak_mb"]
        res[f"{tag}_path"] = sp
        del c
    with phase("rec_variants", {}) as rv:
        rv.update(phase_variants(ctx, _REC_VARIANTS))
        for tag in list(rv):
            if isinstance(rv[tag], dict):
                rv[f"{tag}_ms_per_step"] = rv[tag]["train"]["ms_per_step"]
                if "drop_rates_s" in rv[tag]:
                    rv[f"{tag}_drop_rates_s"] = rv[tag]["drop_rates_s"]
    res["rec_variants"] = {t: rv[t] for t, *_ in _REC_VARIANTS}
    return res


# TimeDynamicRGCN (models/timedynamic.py): GRRGCN's windows through K2 on
# diachronic inputs, its final step one element at a time through K1
def tdyn_launches(c, steps: int, batches: int) -> dict:
    """The launches of `steps` training steps and an eval sweep of
    `batches` batches of TimeDynamicRGCN: K1f and K1b two an element's
    final step (the first steps' batches hold no padding), K2f two a
    window step, K2b five a window step and two more; in eval K2f two a
    window step and K1f two an element, each batch (no conv1 table)."""
    L1, B, Be = c["L1"], c["cfg"].batch_size, c["cfg"].eval_batch
    return {"train": {"spmm_fwd": 2 * B * steps, "spmm_bwd": 2 * B * steps,
                      "fused_window_fwd": 2 * L1 * steps,
                      "fused_window_bwd": (5 * L1 + 2) * steps},
            "eval": {"spmm_fwd": 2 * Be * batches,
                     "fused_window_fwd": 2 * L1 * batches}}


def _exact_launches(dev, launches: dict, want: dict, tag: str) -> None:
    """On the card, each kernel of `want` launched exactly as often."""
    if dev.type != "cuda":
        return
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, predicted {want}")


def tdyn_phases(ctx, train_steps=None) -> dict:
    """TimeDynamicRGCN's phases on the data of `ctx`: tdyn_setup
    (grid/icews14/config_grrgcn.json with module TimeDynamicRGCN, L1 = 14,
    seeded weights), tdyn_train (TRAIN_STEPS, or `train_steps`, optimizer
    steps with the kernels and with their plain versions on the same
    draws: losses within TRAIN_TOL, every leaf, w_temp and b_temp among
    them, within PARAM_TOL; K2f, K2b, K1f and K1b launched as
    ``tdyn_launches`` predicts and none of K3-K13), tdyn_path (the valid
    sweep, kernels against plain, MRR within MRR_TOL and the same query
    mask, K2f and K1f launched as predicted). Returns their results."""
    res = {}
    with phase("tdyn_setup", {}) as ts:
        c = phase_setup(ctx["device"].type, config="config_grrgcn.json",
                        data=ctx["data"], **{**ctx["setup_kw"],
                                             "module": "TimeDynamicRGCN"})
        if train_steps:
            c["train_steps"] = train_steps
        ts.update({k: c[k] for k in ("N", "A", "E", "L1", "B", "d")})
        ts["model"] = type(c["model"]).__name__
    steps = c.get("train_steps", TRAIN_STEPS)
    n_batches = -(-c["T"] // c["cfg"].eval_batch)
    want = tdyn_launches(c, steps, n_batches)
    with phase("tdyn_train", {}) as tt:
        tt.update(phase_train_unfused(c))
        names = _leaf_names(c["params"])
        for leaf in ("w_temp", "b_temp"):
            if leaf not in names:
                raise AssertionError(f"tdyn: no {leaf} leaf in {names}")
        _exact_launches(ctx["device"], tt["kernels"]["launches"],
                        want["train"], "tdyn train")
        tt["ms_per_step_plain"] = tt["plain"]["ms_per_step"]
        tt["peak_mb"] = tt["kernels"]["peak_mb"]
        for k, n in want["train"].items():
            tt[f"{k}_launches"] = tt["kernels"]["launches"][k]
    res["tdyn_train"] = tt
    with phase("tdyn_path", {}) as tp:
        tp.update(phase_path(c, want=["spmm_fwd", "fused_window_fwd"]))
        k = tp["kernels"]
        _unfused_launches_ok(ctx["device"], k["launches"],
                             ("spmm_fwd", "fused_window_fwd"), "tdyn eval")
        _exact_launches(ctx["device"], k["launches"], want["eval"],
                        "tdyn eval")
        for name in ("kernels", "plain"):
            tp[f"mrr_{name}"] = tp[name]["mrr"]
            tp[f"wall_s_{name}"] = tp[name]["wall_s"]
            tp[f"queries_per_s_{name}"] = tp[name]["queries_per_s"]
        tp["peak_mb"] = k["peak_mb"]
    res["tdyn_path"] = tp
    return res


# the other decoders and negative pools on the recurrent, gated and
# attention models: the windows through K2 (K1 for the attention
# models), the final step one element at a time through K1, none of K3-K12
_ZOO_VARIANTS = (
    ("grrgcn_distmult", "config_grrgcn.json", {"score_function": "distmult"}),
    ("grrgcn_transe", "config_grrgcn.json", {"score_function": "transE"}),
    ("grrgcn_shared", "config_grrgcn.json", {"negative_pool": "shared"}),
    ("grrgcn_per_query", "config_grrgcn.json",
     {"negative_pool": "per_query"}),
    ("bigrrgcn_impute_transe_per_query", "config_bigrrgcn.json",
     {"impute": True, "score_function": "transE",
      "negative_pool": "per_query"}),
    ("grrgcn_ted_transe_shared", "config_grrgcn.json",
     {"impute": True, "post_ensemble": True, "score_function": "transE",
      "negative_pool": "shared"}),
    ("sargcn_distmult", "config_sargcn.json", {"score_function": "distmult"},
     _K1_ONLY))


def phase_zoo_variants(ctx) -> dict:
    """The ``_ZOO_VARIANTS`` at full width and VARIANT_SEQ_LEN
    (``phase_variants``: 2 steps and one valid batch each, kernels against
    plain on the same draws, the kernels each must and must not launch),
    with the peak memory of each training run."""
    out = phase_variants(ctx, _ZOO_VARIANTS)
    for tag, r in out.items():
        r["peak_mb"] = r["train"]["kernels"]["peak_mb"]
    return out


# the embedding baselines (models/baselines.py): no graph, no kernel
_BASELINE_MODULES = ("Static", "DE", "ATiSE", "Hyte", "SimplE")


def _baseline_steps(c, device, batches, draws=None, gen=True):
    """The steps `batches` of the baseline of c on `device` from its seeded
    weights (each step's draws from the Trainer's generator, or `draws`
    moved to `device`), every launch counter from 0: (losses, ms a step,
    launches, peak MiB, initial and final leaves, the draws used)."""
    import torch

    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer
    from temp_tpu_torch.train.optim import param_leaves

    dev = torch.device(device)
    model = get_model(c["cfg"], c["data"], device=dev)
    tr = Trainer(c["cfg"], model, c["data"])
    params, opt = tr.init_state()
    init = [t.detach().clone() for t in param_leaves(params)]
    if draws is None:
        draws = [model.draw_train(tr.step_generator(0, i), tr.data,
                                  torch.tensor(t_pos, device=dev))
                 for i, (t_pos, _) in enumerate(batches)]
    draws = [{k: None if v is None else v.to(dev) for k, v in d.items()}
             for d in draws]
    _reset_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    base = _allocated_mb(dev)
    t0 = time.perf_counter()
    losses = [tr.train_step(params, opt, t_pos, t_valid, draws=d)
              for (t_pos, t_valid), d in zip(batches, draws)]
    losses = torch.stack(losses).cpu().tolist()
    wall = time.perf_counter() - t0
    finals = [t.detach().clone().cpu() for t in param_leaves(params)]
    return {"losses": losses, "ms_per_step": wall * 1e3 / len(batches),
            "launches": _counts(), "peak_mb": _peak_mb(dev),
            "params": params, "init": [t.cpu() for t in init],
            "finals": finals, "draws": draws}


def phase_baseline(ctx, module: str, train_steps=None, **over) -> dict:
    """One embedding baseline (grid/icews14/config_grrgcn.json with
    `module`, d = 128, the config's fields `over`) on the card:
    TRAIN_STEPS (or `train_steps`) steps, the CPU replaying them from the
    same seeded weights on the card's draws (losses within TRAIN_TOL,
    every leaf within PARAM_TOL of the CPU's change, BF16_PARAM_TOL in
    bfloat16), then the valid sweep on the card (queries/s); no kernel
    launched anywhere."""
    import numpy as np
    import torch

    dev = ctx["device"]
    c = phase_setup(dev.type, config="config_grrgcn.json", data=ctx["data"],
                    **{**ctx["setup_kw"], "module": module, **over})
    batches = c["trainer"].epoch_batches(0)[:train_steps or TRAIN_STEPS]
    card = _baseline_steps(c, dev, batches)
    t0 = time.perf_counter()
    cpu = _baseline_steps(c, "cpu", batches, draws=card["draws"])
    res = {"model": type(c["model"]).__name__,
           "score_function": c["model"].cfg.score_function,
           "cpu_steps": len(batches), "cpu_s": time.perf_counter() - t0,
           "train": {k: card[k] for k in ("losses", "ms_per_step",
                                          "launches", "peak_mb")},
           "cpu_losses": cpu["losses"]}
    x, y = np.array(card["losses"]), np.array(cpu["losses"])
    if not np.isfinite(x).all():
        raise AssertionError(f"{module}: losses not finite: "
                             f"{card['losses']}")
    res["max_rel_gap"] = float(np.max(np.abs(x - y)
                                      / np.maximum(1.0, np.abs(y))))
    if not res["max_rel_gap"] <= TRAIN_TOL:
        raise AssertionError(f"{module}: card and CPU losses differ: "
                             f"{res['max_rel_gap']} > {TRAIN_TOL}")
    res["params"] = param_gaps(
        cpu["init"], {"card": card["finals"], "cpu": cpu["finals"]},
        names=("card", "cpu"),
        tol=BF16_PARAM_TOL if c["cfg"].hot_dtype else PARAM_TOL)
    if not all(torch.equal(a, b) for a, b in zip(card["init"], cpu["init"])):
        raise AssertionError(f"{module}: other initial weights on the CPU")
    m, _, _ = _sweep({**ctx, "params": card["params"]}, c["cfg"])
    res["eval"] = {k: m[k] for k in ("mrr", "n", "loss", "wall_s",
                                     "queries_per_s", "launches",
                                     "peak_mb")}
    n_q = 2 * int(ctx["data"].valid.emask.sum())
    if not (m["n"] == n_q and 0.0 < m["mrr"] <= 1.0
            and np.isfinite(m["loss"])):
        raise AssertionError(f"{module} eval: {res['eval']}")
    for what, launches in (("train", card["launches"]),
                           ("cpu", cpu["launches"]),
                           ("eval", m["launches"])):
        if any(launches.values()):
            raise AssertionError(f"{module} {what}: kernels launched: "
                                 f"{launches}")
    return res


def baseline_phases(ctx, train_steps=None) -> dict:
    """The baselines' phases, one a baseline (``phase_baseline``); returns
    them as {"baselines": {module: result}}."""
    out = {}
    for module in _BASELINE_MODULES:
        with phase(f"baselines_{module}", {}) as bp:
            r = phase_baseline(ctx, module, train_steps)
            bp.update(r)
            bp["ms_per_step"] = r["train"]["ms_per_step"]
            bp["peak_mb"] = r["train"]["peak_mb"]
            bp["queries_per_s"] = r["eval"]["queries_per_s"]
            bp["mrr"] = r["eval"]["mrr"]
        out[module] = r
    return {"baselines": out}


# the Aggregator (models/aggregator.py): frozen submodels in eval mode (K1f,
# K2f), the gates trained
_AGG_WANT = ("spmm_fwd", "fused_window_fwd")
_NOT_AGG = _NOT_UNFUSED + ("spmm_bwd", "fused_window_bwd")


def phase_setup_agg(ctx, tmp: str) -> dict:
    """Two port run directories under `tmp`, each with its config.json and
    checkpoints/best.pt: seeded SRGCN (config_srgcn.json, "spatial") and
    BiGRRGCN (config_bigrrgcn.json, "temporal") on the smoke's data; then
    the Aggregator (config_bigrrgcn.json, module Aggregator) that loads both
    through ``load_checkpoint_params``. "ckpt": each submodel's saved
    leaves (on the CPU)."""
    from temp_tpu_torch.train.checkpoint import save_checkpoint
    from temp_tpu_torch.train.optim import param_leaves

    runs, ckpt = {}, {}
    for name, config in (("spatial", "config_srgcn.json"),
                         ("temporal", "config_bigrrgcn.json")):
        c = phase_setup(ctx["device"].type, config=config, data=ctx["data"],
                        **ctx["setup_kw"])
        runs[name] = os.path.join(tmp, name)
        os.makedirs(runs[name])
        with open(os.path.join(runs[name], "config.json"), "w") as f:
            f.write(c["cfg"].to_json())
        save_checkpoint(os.path.join(runs[name], "checkpoints", "best.pt"),
                        c["params"], None, 0, {"mrr": 0.0})
        ckpt[name] = [t.detach().cpu() for t in param_leaves(c["params"])]
        del c
    actx = phase_setup(ctx["device"].type, config="config_bigrrgcn.json",
                       data=ctx["data"],
                       **{**ctx["setup_kw"], "module": "Aggregator",
                          "spatial_checkpoint": runs["spatial"],
                          "temporal_checkpoint": runs["temporal"]})
    actx["ckpt"] = ckpt
    actx["train_steps"] = 2
    return actx


def _frozen_leaves_ok(model, ckpt) -> None:
    """Every leaf of the Aggregator's submodels bit-equal to its saved
    checkpoint."""
    import torch

    from temp_tpu_torch.train.optim import param_leaves

    for name, params in (("spatial", model.spatial_params),
                         ("temporal", model.temporal_params)):
        leaves = param_leaves(params)
        if not (len(leaves) == len(ckpt[name]) and all(
                torch.equal(a.cpu(), b) for a, b in zip(leaves,
                                                         ckpt[name]))):
            raise AssertionError(f"agg: the {name} submodel moved")


def phase_agg_train(actx) -> dict:
    """2 steps of the Aggregator with the kernels and with their plain
    versions (``phase_train_unfused``: losses, every gate leaf, within
    BF16_PARAM_TOL in bfloat16; K1f and K2f launched, no K1b or K2b, none
    of K3-K13); every gate leaf moved, and every submodel leaf still
    bit-equal to its checkpoint."""
    res = phase_train_unfused(
        actx, _AGG_WANT, _NOT_AGG,
        param_tol=BF16_PARAM_TOL if actx["cfg"].hot_dtype else PARAM_TOL)
    if not res["gate_leaves"] == res["gate_leaves_moved"] == 8:
        raise AssertionError(f"agg: gates {res['gate_leaves']}, moved "
                             f"{res['gate_leaves_moved']}")
    for model in actx["models"].values():
        _frozen_leaves_ok(model, actx["ckpt"])
    res["ms_per_step_plain"] = res["plain"]["ms_per_step"]
    res["peak_mb"] = res["kernels"]["peak_mb"]
    return res


def _agg_near_ties(model, params, data, t_pos, split: str):
    """[B, 2Q] bool in the [head, tail] layout: the queries whose gated
    plain scores hold a column other than the target, not a true answer,
    within SCALED_TOL of the row's largest |score| of the target's score
    (``_tied``, ``near_ties``'s rule)."""
    import torch

    from temp_tpu_torch.ops.membership import true_answer_mask

    out = []
    r2 = 2 * data.num_rels
    with torch.no_grad():
        for t, tables in zip(t_pos, model._tables(data, t_pos)):
            sc_t, sc_h, src, rel, dst = model.element_scores(
                params, data, t, tables, split)
            out.append(torch.cat([
                _tied(sc, target, true_answer_mask(
                    tbl.grp[t], tbl.val[t], grp, data.num_ents))
                for sc, target, tbl, grp in (
                    (sc_h, src, data.total_head, dst * r2 + rel),
                    (sc_t, dst, data.total_tail, src * r2 + rel))]))
    return torch.stack(out).cpu().numpy()


def phase_agg_path(actx) -> dict:
    """One valid batch of the Aggregator with the kernels and with their
    plain versions: the same query mask, ranks equal on every real query
    but the plain scores' near-ties (``_agg_near_ties``; in bfloat16,
    whose rounding flips move scores by more than a near-tie, the MRR
    within MRR_TOL, as ``phase_variants`` holds the other bfloat16
    models), the gated eval's loss 0; K1f and K2f launched, no K1b or
    K2b, none of K3-K13."""
    import numpy as np

    from temp_tpu_torch.models.objectives import metrics_from_ranks
    from temp_tpu_torch.models.registry import get_model

    (rk, mk, launches), (rp, mp, plain) = (
        _eval_batch_ranks(actx, k) for k in (True, False))
    if not np.array_equal(mk, mp) or not mk.any():
        raise AssertionError("agg eval: query masks differ or are empty")
    diff = mk & (rk != rp)
    model = get_model(actx["cfg"].replace(kernels=False), actx["data"],
                      device=actx["device"])
    t_pos = [int(t) for t in np.arange(actx["B"])
             + actx["trainer"].data.num_times // 2]
    near = _agg_near_ties(model, actx["params"], actx["trainer"].data,
                          t_pos, "valid") & mk
    m_k, m_p = metrics_from_ranks(rk, mk), metrics_from_ranks(rp, mp)
    if actx["cfg"].hot_dtype is None and (diff & ~near).any():
        raise AssertionError(f"agg eval: {int((diff & ~near).sum())} ranks "
                             f"differ beyond the near-ties")
    if not abs(m_k["mrr"] - m_p["mrr"]) <= MRR_TOL:
        raise AssertionError(f"agg eval: MRR {m_k['mrr']}, plain "
                             f"{m_p['mrr']}")
    _unfused_launches_ok(actx["device"], launches, _AGG_WANT, "agg eval",
                         _NOT_AGG)
    if any(plain.values()):
        raise AssertionError(f"agg eval plain: {plain}")
    return {"mrr_kernels": m_k["mrr"], "mrr_plain": m_p["mrr"],
            "n": m_k["n"], "rank_diffs": int(diff.sum()),
            "near_ties": int(near.sum()), "launches": launches}


def agg_phases(ctx, prefix: str = "agg") -> dict:
    """The Aggregator's phases: agg_setup (two seeded submodels written as
    port checkpoints in a temporary directory, loaded by the Aggregator),
    agg_train, agg_path, each name with `prefix` for "agg"; the directory
    removed at the end."""
    import shutil
    import tempfile

    res = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_agg_")
    try:
        with phase(f"{prefix}_setup", {}) as st:
            actx = phase_setup_agg(ctx, tmp)
            st["model"] = type(actx["model"]).__name__
            st["temporal"] = type(actx["model"].temporal_model).__name__
            st["spatial"] = type(actx["model"].spatial_model).__name__
        with phase(f"{prefix}_train", {}) as at:
            at.update(phase_agg_train(actx))
        res[f"{prefix}_train"] = at
        with phase(f"{prefix}_path", {}) as ap:
            ap.update(phase_agg_path(actx))
        res[f"{prefix}_path"] = ap
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        raise AssertionError(f"agg: {tmp} not removed")
    return res


# -- K1 in bfloat16 (the SpMM method "pallas") and every model in bfloat16 --

def _bf16_k1_operands(tag, args):
    """A K1 call's (h, src, dst, rel, emask, w) as the wrapper takes it:
    float32 h and w, as the bfloat16 paths hand them (the entity table,
    the layers' outputs, an attention history); at the RRGCN window step's
    shapes ("rrgcn_" tags) h in bfloat16, so that the mode's read of a
    bfloat16 h (JAX's kernel takes one too) is held at a path's shape.
    The kernel rounds what it gathers either way."""
    import torch

    if not tag.startswith("rrgcn_"):
        return args
    h, src, dst, rel, em, w = args
    return (h.to(torch.bfloat16).contiguous(), src, dst, rel, em, w)


def _k1_scaled_err(a, b) -> float:
    """max |a - b| over the largest |b| (0 where b is 0 and a equals it)."""
    scale = float(b.abs().max())
    err = max_err(a, b)
    return err / scale if scale else (0.0 if err == 0 else math.inf)


def _k1_bf16_bound(h, src, dst, rel, em, n_out: int, w_rows: int,
                   w_size: int, bwd: bool):
    """Least time of a bfloat16 K1 call: the referenced rows of h and w in
    the dtypes they are given (and, for the backward, of g as float32, with
    norm^2), the edge arrays and the float32 outputs moved once, against 3
    (forward) or 6 (backward) float32 operations an edge column (the
    roundings not counted)."""
    m = em.bool()
    d, kept = h.shape[1], int(m.sum())
    nbytes = (int(src[m].unique().numel()) * h.element_size()
              + int(rel[m].unique().numel()) * w_size) * d + src.numel() * 16
    if bwd:
        nbytes += (int(dst[m].unique().numel()) * d * 4 + n_out * 4
                   + (n_out + w_rows) * d * 4)
    else:
        nbytes += n_out * d * 4
    flops = (6 if bwd else 3) * kept * d
    t_b, t_f = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _bf16_k1_cases(ctx):
    """K1's shapes of ``phase_k1``/``phase_k1b`` (``_k1_cases``), the
    attention history's (``_sa_k1_cases``, "sa_" tags) and the RRGCN
    window step's (``_rec_k1_cases``, "rrgcn_" tags), and the tags whose
    backward is timed (phase_k1b's and every history and window case)."""
    cases = list(_k1_cases(ctx))
    for pre, config, fn in (("sa", "config_sargcn.json", _sa_k1_cases),
                            ("rrgcn", "config_rrgcn.json", _rec_k1_cases)):
        c = phase_setup_config(ctx, config)
        cases += [(f"{pre}_{t}", a, tb) for t, a, tb in fn(c)]
        del c
    bwd = {"train", "final"} | {t for t, _, _ in cases if "_" in t}
    return cases, bwd


def phase_bf16_k1(ctx) -> dict:
    """K1f and K1b in their bfloat16 mode (``hot=torch.bfloat16``, the
    JAX kernels' bfloat16 instantiation) at every shape ``phase_k1`` and
    ``phase_k1b`` time, the attention history's and the RRGCN window
    step's (``_bf16_k1_cases``), over the data's tables, on the operands
    the paths hand the wrapper (``_bf16_k1_operands``: float32 h and w;
    at the window step's shapes a bfloat16 h), so that a time is the main
    path's call: one launch a call, no sort, no host sync, no copy; two runs
    bit-equal; within K1_TOL of the largest entry of the plain bfloat16
    version (both round at the same points, so only the order of the
    float32 sums differs), BF16_RULE's ratio against the plain float32
    version beside it; times, bounds (h and w read in their dtypes) and
    the library's: one ``index_add_`` of the same rounded messages, two of
    the same rounded cotangents."""
    import torch

    from temp_tpu_torch.ops.spmm import (
        _spmm_fwd, spmm_bwd, spmm_bwd_plain, spmm_fwd, spmm_fwd_plain,
    )

    BF = torch.bfloat16
    dev = ctx["device"]
    cases, bwd_tags = _bf16_k1_cases(ctx)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}

    def rb(x):
        return x.to(BF).to(torch.float32)

    def rule(k, pb, pf):
        gap, yard = _rms((k - pb).float()), _rms((pf - pb).float())
        return gap / yard if yard else 0.0

    for tag, args, tables in cases:
        hk = _bf16_k1_operands(tag, args)
        h, src, dst, rel, em, w = flat = _flat(hk)
        flat32 = _flat(args)
        k, n2, _ = _one_launch(
            lambda: _spmm_fwd(*hk, tables=tables, hot=BF), spmm_fwd,
            f"K1 bf16 {tag}", dev)
        bitwise = bool(torch.equal(
            k, _spmm_fwd(*hk, tables=tables, hot=BF)[0]))
        ref = spmm_fwd_plain(*flat, hot=BF)
        ref32 = spmm_fwd_plain(*flat32)
        err = _k1_scaled_err(k, ref)
        ratio = rule(k, ref, ref32)
        if not (err <= K1_TOL and bitwise):
            raise AssertionError(f"K1 bf16 {tag}: max abs err {err} of the "
                                 f"largest entry (> {K1_TOL}?), bf16_rule "
                                 f"ratio {ratio}, bit-equal twice: "
                                 f"{bitwise}")
        emf = em.to(torch.float32)[:, None]
        msg = rb(rb(h[src.long()].float()) * rb(w[rel.long()])) * emf
        lib = torch.zeros(h.shape, dtype=torch.float32, device=dev)
        bound_ms, bound_by = _k1_bf16_bound(h, src, dst, rel, em,
                                            h.shape[0], w.shape[0],
                                            w.element_size(), False)
        out[tag] = {
            "shape": f"N={h.shape[0]} B={tables[1].numel()} "
                     f"E={src.numel()} kept={int(em.sum())} "
                     f"R={w.shape[0]} d={h.shape[1]}, bf16, h {h.dtype}",
            "max_abs_err": max_err(k, ref), "scaled_err": err,
            "rms_ratio": ratio, "bitwise": bitwise,
            "ms": time_ms(lambda: spmm_fwd(*hk, tables=tables, hot=BF), dev),
            "plain_ms": time_ms(lambda: spmm_fwd_plain(*flat, hot=BF), dev,
                                reps=5),
            "plain_f32_ms": time_ms(lambda: spmm_fwd_plain(*flat32), dev,
                                    reps=5),
            "library_ms": time_ms(
                lambda: lib.zero_().index_add_(0, dst.long(), msg), dev),
            "bound_ms": bound_ms, "bound_by": bound_by}
        out[tag]["bound_share"] = out[tag]["bound_ms"] / out[tag]["ms"]
        print(f"  K1 bf16 {tag}: {out[tag]}", flush=True)
        if tag not in bwd_tags:
            continue
        g = torch.randn(hk[0].shape, generator=gen, device=dev)
        bargs = (g, n2) + hk
        dh, dw = _one_launch(
            lambda: spmm_bwd(*bargs, tables=tables, hot=BF), spmm_bwd,
            f"K1b bf16 {tag}", dev)
        ah, aw = spmm_bwd(*bargs, tables=tables, hot=BF)
        bitwise = bool(torch.equal(dh, ah) and torch.equal(dw, aw))
        rh, rw = spmm_bwd_plain(g, n2, *flat, hot=BF)
        fh, fw_ = spmm_bwd_plain(g, n2, *flat32)
        err = max(_k1_scaled_err(dh, rh), _k1_scaled_err(dw, rw))
        ratio = max(rule(dh, rh, fh), rule(dw, rw, fw_))
        if not (err <= K1_TOL and bitwise):
            raise AssertionError(f"K1b bf16 {tag}: max abs err {err} of the "
                                 f"largest entry (> {K1_TOL}?), bf16_rule "
                                 f"ratio {ratio}, bit-equal twice: "
                                 f"{bitwise}")
        dmsg = rb(g * n2[:, None])[dst.long()] * emf
        mh = rb(dmsg * rb(w[rel.long()]))
        mw = rb(dmsg * rb(h[src.long()].float()))
        lib_h = torch.zeros(h.shape, dtype=torch.float32, device=dev)
        lib_w = torch.zeros(w.shape, dtype=torch.float32, device=dev)

        def library():
            lib_h.zero_().index_add_(0, src.long(), mh)
            lib_w.zero_().index_add_(0, rel.long(), mw)

        bound_ms, bound_by = _k1_bf16_bound(h, src, dst, rel, em,
                                            h.shape[0], w.shape[0],
                                            w.element_size(), True)
        out[f"bwd_{tag}"] = {
            "shape": out[tag]["shape"],
            "max_abs_err": max(max_err(dh, rh), max_err(dw, rw)),
            "scaled_err": err, "rms_ratio": ratio, "bitwise": bitwise,
            "ms": time_ms(lambda: spmm_bwd(*bargs, tables=tables, hot=BF),
                          dev),
            "plain_ms": time_ms(lambda: spmm_bwd_plain(g, n2, *flat,
                                                       hot=BF), dev, reps=5),
            "plain_f32_ms": time_ms(lambda: spmm_bwd_plain(g, n2, *flat32),
                                    dev, reps=5),
            "library_ms": time_ms(library, dev),
            "bound_ms": bound_ms, "bound_by": bound_by}
        out[f"bwd_{tag}"]["bound_share"] = (out[f"bwd_{tag}"]["bound_ms"]
                                            / out[f"bwd_{tag}"]["ms"])
        print(f"  K1b bf16 {tag}: {out[f'bwd_{tag}']}", flush=True)
    return out


@contextmanager
def spmm_method(method):
    """``rel_spmm``'s method "auto" resolving to `method` inside, as
    ``TEMP_TPU_SPMM_METHOD`` sets it for a run."""
    from temp_tpu_torch.ops import segment

    old = segment._METHOD_OVERRIDE
    segment._METHOD_OVERRIDE = method
    try:
        yield
    finally:
        segment._METHOD_OVERRIDE = old


def _k1_modes_ok(dev, launches: dict, tag: str, fwd: int, bwd: int) -> None:
    """On the card, K1f and K1b launched `fwd` and `bwd` times, every
    launch in the bfloat16 mode (none in float32)."""
    if dev.type != "cuda":
        return
    got = {k: launches[k] for k in ("spmm_fwd", "spmm_fwd_bf16", "spmm_bwd",
                                    "spmm_bwd_bf16")}
    if got != {"spmm_fwd": fwd, "spmm_fwd_bf16": fwd, "spmm_bwd": bwd,
               "spmm_bwd_bf16": bwd}:
        raise AssertionError(f"{tag}: K1 launches {got}, want {fwd} K1f and "
                             f"{bwd} K1b, all bfloat16")


def phase_bf16_spmm_pallas(ctx, bf16_path) -> dict:
    """The SpMM method "pallas" in bfloat16 (K1's bfloat16 mode) at full
    width: GRRGCN's valid sweep (``_sweep``, conv1 table and K2f as
    bf16_path's) with the kernels and with their plain versions, MRR
    within MRR_TOL, the same query mask, K1f bf16 launched 737 times and
    float32 K1 never; beside it the gap to bf16_path's sweep (method
    "segment", K1 in float32). Then SARGCN: TRAIN_STEPS steps with the
    kernels and with their plain versions (``phase_train_unfused``:
    losses within TRAIN_TOL, leaves within BF16_PARAM_TOL), K1f and K1b
    bf16 each launched 4 a batch element a step (two layers over the
    history, two over the final snapshot) and float32 K1 never; its valid
    sweep against its plain version (``phase_k1_path``)."""
    import numpy as np

    dev = ctx["device"]
    res = {}
    cfg = ctx["cfg"].replace(compute_dtype="bfloat16")
    runs = {}
    with spmm_method("pallas"):
        for name, kernels in (("kernels", True), ("plain", False)):
            m, ranks, mask = _sweep(ctx, cfg.replace(kernels=kernels))
            runs[name] = (ranks, mask)
            res[f"eval_{name}"] = m
            print(f"  bf16 pallas sweep {name}: {m}", flush=True)
    k, pl = res["eval_kernels"], res["eval_plain"]
    (rk, mk), (rp, mp) = runs["kernels"], runs["plain"]
    if not (np.array_equal(mk, mp) and np.isfinite(k["mrr"])
            and 0.0 < k["mrr"] <= 1.0 and abs(k["mrr"] - pl["mrr"])
            <= MRR_TOL):
        raise AssertionError(f"bf16 pallas sweep: kernels {k['mrr']}, plain "
                             f"{pl['mrr']}, masks equal "
                             f"{np.array_equal(mk, mp)}")
    _k1_modes_ok(dev, k["launches"], "bf16 pallas sweep",
                 _BF16_SWEEP["spmm_fwd"], 0)
    if dev.type == "cuda" and (
            k["launches"]["fused_window_fwd"] != _BF16_SWEEP[
                "fused_window_fwd"] or k["k1_csr_builds"]
            or any(k["launches"][x] for x in _NOT_BF16)):
        raise AssertionError(f"bf16 pallas sweep launches {k['launches']}")
    if any(pl["launches"].values()):
        raise AssertionError(f"bf16 pallas plain sweep: {pl['launches']}")
    res["mrr_gap_to_segment"] = k["mrr"] - bf16_path["eval_kernels"]["mrr"]
    res["same_rank_share"] = float(np.mean(rk[mk] == rp[mp]))
    sctx = phase_setup(dev.type, config="config_sargcn.json",
                       data=ctx["data"], **{**ctx["setup_kw"],
                                            "compute_dtype": "bfloat16"})
    sctx["train_steps"] = ctx.get("train_steps", TRAIN_STEPS)
    with spmm_method("pallas"):
        tr = phase_train_unfused(sctx, _SA_TRAIN, _NOT_SA,
                                 param_tol=BF16_PARAM_TOL)
        per = 4 * sctx["cfg"].batch_size * sctx["train_steps"]
        _k1_modes_ok(dev, tr["kernels"]["launches"], "bf16 pallas SARGCN "
                     "train", per, per)
        sp = phase_k1_path(sctx, "attention bf16 pallas")
    n = sp["kernels"]["launches"]["spmm_fwd"]
    _k1_modes_ok(dev, sp["kernels"]["launches"], "bf16 pallas SARGCN eval",
                 n, 0)
    res["sa_train"], res["sa_path"] = tr, sp
    return res


# every model, decoder, pool and option in bfloat16 under the SpMM method
# "segment" (the default), at phase_zoo_variants' depth: the kernels each
# must and must not launch, as their float32 phases
_BF16_ZOO = tuple(
    (tag, config, {**flags, "compute_dtype": "bfloat16"}, *spec)
    for tag, config, flags, *spec in (
        ("rrgcn_distmult_shared_lambda", "config_rrgcn.json",
         {"score_function": "distmult", "negative_pool": "shared",
          "learnable_lambda": True}, _K1_ONLY),
        ("birrgcn_transe_per_query_options", "config_birrgcn.json",
         {"score_function": "transE", "negative_pool": "per_query",
          "rec_only_last_layer": True, "use_time_embedding": True},
         _K1_ONLY),
        ("grrgcn_type1", "config_grrgcn.json", {"type1": True}, _K1_ONLY),
        ("post_sargcn", "config_sargcn.json", {"post_aggregation": True},
         _K1_ONLY),
        ("post_bisargcn", "config_bisargcn.json",
         {"post_aggregation": True}, _K1_ONLY),
        ("srgcn", "config_srgcn.json", {}, _K1_ONLY),
        ("drgcn_temb", "config_srgcn.json",
         {"module": "DRGCN", "use_time_embedding": True}, _K1_ONLY),
        ("tdyn", "config_grrgcn.json", {"module": "TimeDynamicRGCN"})))


def phase_bf16_zoo(ctx) -> dict:
    """The ``_BF16_ZOO`` configs at full width and VARIANT_SEQ_LEN
    (``phase_variants``: 2 steps and one valid batch each, kernels
    against plain on the same draws, MRR within MRR_TOL, each leaf within
    BF16_PARAM_TOL), with each training run's peak memory."""
    out = phase_variants(ctx, _BF16_ZOO, param_tol=BF16_PARAM_TOL)
    for tag, r in out.items():
        r["peak_mb"] = r["train"]["kernels"]["peak_mb"]
    return out


def bf16_zoo_phases(ctx) -> dict:
    """bf16_zoo (``phase_bf16_zoo``), then the baselines
    (``phase_baseline``, 2 steps on the card replayed on the CPU, the
    valid sweep; "bf16_baselines_<module>") and the Aggregator
    (``agg_phases``: its two submodels and itself in bfloat16;
    "bf16_agg_*") in bfloat16. Returns their results by phase name."""
    res = {}
    with phase("bf16_zoo", {}) as bz:
        bz.update(phase_bf16_zoo(ctx))
        for tag in list(bz):
            if isinstance(bz[tag], dict):
                bz[f"{tag}_ms_per_step"] = bz[tag]["train"]["ms_per_step"]
    res["bf16_zoo"] = {t: bz[t] for t, *_ in _BF16_ZOO}
    base = {}
    for module in _BASELINE_MODULES:
        with phase(f"bf16_baselines_{module}", {}) as bp:
            r = phase_baseline(ctx, module, 2, compute_dtype="bfloat16")
            bp.update(r)
            bp["ms_per_step"] = r["train"]["ms_per_step"]
            bp["mrr"] = r["eval"]["mrr"]
        base[module] = r
    res["bf16_baselines"] = base
    bctx = dict(ctx, setup_kw={**ctx["setup_kw"],
                               "compute_dtype": "bfloat16"})
    res.update(agg_phases(bctx, prefix="bf16_agg"))
    return res


# -- the run around the model: data build, preemption, predictions, traces --

_FIT_TRAIN = ("fused_window_fwd", "fused_window_bwd", "fused_final_fwd",
              "fused_final_bwd_loss", "fused_final_bwd_layer")
_NOT_FIT_TRAIN = ("spmm_fwd", "spmm_bwd") + _NOT_UNFUSED[3:]
_SWEEP = ("spmm_fwd", "fused_window_fwd")
_NOT_SWEEP = _NOT_UNFUSED + ("spmm_bwd", "fused_window_bwd")
PREEMPT_EPOCHS = 3
CLI_EPOCHS = 8
CLI_TIMEOUT_S = 240
PARSE_LINES = 1_734_399  # GDELT's train facts


def write_dataset(root: str, name: str, quads, num_ents: int,
                  num_rels: int) -> str:
    """(train, valid, test) quadruples as a dataset directory in the
    standard text layout, <root>/interpolation/<name>; returns root."""
    import numpy as np

    path = os.path.join(root, "interpolation", name)
    os.makedirs(path)
    for split, q in zip(("train", "valid", "test"), quads):
        np.savetxt(os.path.join(path, f"{split}.txt"), q, fmt="%d",
                   delimiter="\t")
    times = len(np.unique(np.concatenate(quads)[:, 3]))
    with open(os.path.join(path, "stat.txt"), "w") as f:
        f.write(f"{num_ents}\t{num_rels}\t{times}\n")
    return root


def _arrays_equal(a, b, tag: str) -> None:
    """Every array of two TKGData (``_to_npz``) equal, dtypes included."""
    import numpy as np

    from temp_tpu_torch.data.snapshots import _to_npz

    x, y = _to_npz(a), _to_npz(b)
    bad = [k for k in x if not (x[k].dtype == y[k].dtype
                                and np.array_equal(x[k], y[k]))]
    if x.keys() != y.keys() or bad:
        raise AssertionError(f"{tag}: arrays differ: {bad}")


def phase_data_native(ctx, tmp: str) -> dict:
    """The smoke's dataset (make_synthetic's quadruples at ctx's sizes)
    written as text, then ``build_tkg_data(cache=False)`` through the
    native packer and through numpy: every array equal (and equal to the
    smoke's own data), the native path taken. Also the parse of train.txt
    alone, native against ``np.loadtxt``, at this size and at GDELT's
    (ctx "parse_lines", default PARSE_LINES). Keeps the dataset's root and
    config in ctx ("text_cfg")."""
    import numpy as np

    from temp_tpu_torch.data import native
    from temp_tpu_torch.data.snapshots import build_tkg_data, synthetic_quads

    kw = ctx["setup_kw"]
    sizes = [kw[k] for k in ("num_ents", "num_rels", "num_times",
                             "edges_per_time", "seed")]
    quads = synthetic_quads(*sizes)
    t0 = time.perf_counter()
    root = write_dataset(os.path.join(tmp, "data"), "synthetic", quads,
                         sizes[0], sizes[1])
    write_s = time.perf_counter() - t0
    cfg = ctx["cfg"].replace(data_root=root, dataset="synthetic",
                             dataset_dir="interpolation")
    ctx["text_cfg"] = cfg
    native.reset()
    t0 = time.perf_counter()
    fast = build_tkg_data(cfg, cache=False)
    native_s = time.perf_counter() - t0
    if not native.used():
        raise AssertionError("data_native: the native packer did not run")
    with native.disabled():
        native.reset()
        t0 = time.perf_counter()
        slow = build_tkg_data(cfg, cache=False)
        numpy_s = time.perf_counter() - t0
        if native.used():
            raise AssertionError("data_native: native ran while disabled")
    _arrays_equal(fast, slow, "data_native native/numpy")
    _arrays_equal(fast, ctx["data"], "data_native text/make_synthetic")
    train = os.path.join(cfg.dataset_path, "train.txt")
    t0 = time.perf_counter()
    parsed = native.parse_quads(train)
    parse_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = np.loadtxt(train, dtype=np.int64, ndmin=2)
    parse_loadtxt_s = time.perf_counter() - t0
    if not np.array_equal(parsed, ref):
        raise AssertionError("data_native: parse_quads != np.loadtxt")
    # and at GDELT's size (PARSE_LINES train facts: 500 entities, 20
    # relations, 366 times)
    lines = ctx.get("parse_lines", PARSE_LINES)
    big = synthetic_quads(500, 20, 366, -(-lines // 366), seed=2)[0][:lines]
    path = os.path.join(tmp, "gdelt_train.txt")
    np.savetxt(path, big, fmt="%d", delimiter="\t")
    t0 = time.perf_counter()
    parsed = native.parse_quads(path)
    big_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = np.loadtxt(path, dtype=np.int64, ndmin=2)
    big_loadtxt_s = time.perf_counter() - t0
    os.unlink(path)
    if not (np.array_equal(parsed, ref) and np.array_equal(parsed, big)):
        raise AssertionError("data_native: the GDELT-sized parse differs")
    return {"facts": int(sum(len(q) for q in quads)), "write_s": write_s,
            "build_native_s": native_s, "build_numpy_s": numpy_s,
            "build_speedup": numpy_s / native_s,
            "parse_native_s": parse_native_s,
            "parse_loadtxt_s": parse_loadtxt_s,
            "parse_speedup": parse_loadtxt_s / parse_native_s,
            "gdelt_lines": lines, "gdelt_parse_native_s": big_native_s,
            "gdelt_parse_loadtxt_s": big_loadtxt_s,
            "gdelt_parse_speedup": big_loadtxt_s / big_native_s}


def _count_calls(tr, out: dict) -> None:
    """Wrap the trainer's train_step and run_eval, so that each call
    appends its launch counts to out["steps"] or out["sweeps"], and
    save_last, so that its wall seconds go to out["save_last_s"]."""
    import torch

    def counted(fn, key):
        def call(*a, **k):
            before = _counts()
            res = fn(*a, **k)
            after = _counts()
            out.setdefault(key, []).append(
                {n: after[n] - before[n] for n in after})
            return res
        return call

    def timed_save(*a, **k):
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)
        t0 = time.perf_counter()
        tr_save(*a, **k)
        out.setdefault("save_last_s", []).append(time.perf_counter() - t0)

    tr_save = tr.save_last
    tr.train_step = counted(tr.train_step, "steps")
    tr.run_eval = counted(tr.run_eval, "sweeps")
    tr.save_last = timed_save


def _tb_events(run_dir: str) -> list:
    """Every scalar event under <run_dir>/tb, files in name order."""
    import glob

    from temp_tpu_torch.utils.tbevents import read_scalars

    return [e for f in sorted(glob.glob(os.path.join(
        run_dir, "tb", "events.out.tfevents.*"))) for e in read_scalars(f)]


def _state_equal(a: dict, b: dict) -> bool:
    """Two fits' parameters and Adam states equal bit for bit."""
    import torch

    from temp_tpu_torch.train.optim import param_leaves

    pa, pb = param_leaves(a["params"]), param_leaves(b["params"])
    sa = [t for st in a["optimizer"].state_dict()["state"].values()
          for t in st.values()]
    sb = [t for st in b["optimizer"].state_dict()["state"].values()
          for t in st.values()]
    return (len(pa) == len(pb) and len(sa) == len(sb) > 0
            and all(torch.equal(x.detach(), y.detach())
                    for x, y in zip(pa, pb))
            and all(torch.equal(x, y) for x, y in zip(sa, sb)))


def phase_preempt(ctx, tmp: str) -> dict:
    """GRRGCN at ctx's config with debug on (about a tenth of an epoch's
    batches, then the valid sweep): an uninterrupted PREEMPT_EPOCHS-epoch
    ``fit``; a fit that sends itself SIGTERM after epoch 0's line, stops
    there with last.pt and restores the signal handlers; ``load_last`` and
    the resumed fit. The resumed run's parameters, Adam state, best MRR and
    epoch and the replayed epochs' val MRR equal the uninterrupted run's
    bit for bit; last.pt gone at the end; each run's tb events hold the
    8 tags of every epoch; every training step launches K2f, K2b and K3-K5
    (no K1, none of K6-K13), every sweep K1f and K2f (none of K1b, K2b,
    K3-K13). Also save_last's wall and the tb writes' wall an epoch."""
    import torch

    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer
    from temp_tpu_torch.utils import tbevents

    dev, data = ctx["device"], ctx["data"]
    cfg = ctx["cfg"].replace(debug=True, patience=50)
    tb_s = []
    add = tbevents.EventWriter.add_scalars

    def timed_add(self, *a, **k):
        t0 = time.perf_counter()
        add(self, *a, **k)
        tb_s.append(time.perf_counter() - t0)

    def trainer(run):
        tr = Trainer(cfg, get_model(cfg, data, device=dev), data,
                     run_dir=os.path.join(tmp, run))
        calls = {}
        _count_calls(tr, calls)
        return tr, calls

    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGTERM, signal.SIGUSR1)}
    tbevents.EventWriter.add_scalars = timed_add
    try:
        t0 = time.perf_counter()
        tr_a, calls_a = trainer("control")
        out_a = tr_a.fit(max_epochs=PREEMPT_EPOCHS, log_fn=lambda *_: None)
        control_s = time.perf_counter() - t0
        tr_b, calls_b = trainer("stopped")

        def stop_after_epoch0(msg):
            if msg.startswith("epoch 0:"):
                os.kill(os.getpid(), signal.SIGTERM)

        out_b = tr_b.fit(max_epochs=PREEMPT_EPOCHS, log_fn=stop_after_epoch0)
        restored = all(signal.getsignal(s) is h for s, h in handlers.items())
        last_after_stop = os.path.exists(tr_b.last_ckpt_path())
        t0 = time.perf_counter()
        tr_c, calls_c = trainer("stopped")
        params, optimizer, start, best = tr_c.load_last()
        load_last_s = time.perf_counter() - t0
        out_c = tr_c.fit(params, optimizer, max_epochs=PREEMPT_EPOCHS,
                         start_epoch=start, best=best,
                         log_fn=lambda *_: None)
    finally:
        tbevents.EventWriter.add_scalars = add
    if not (out_b["preempted"] and out_b["last_epoch"] == 0
            and last_after_stop and start == 1 and restored):
        raise AssertionError(
            f"preempt: the stop: preempted {out_b['preempted']} at "
            f"{out_b['last_epoch']}, last.pt {last_after_stop}, resume at "
            f"{start}, handlers restored {restored}")
    if out_a["preempted"] or out_c["preempted"] or os.path.exists(
            tr_c.last_ckpt_path()):
        raise AssertionError("preempt: a finished run was preempted or "
                             "left last.pt")
    hist_a = {r["epoch"]: r["val"]["mrr"] for r in out_a["history"]}
    hist_c = {r["epoch"]: r["val"]["mrr"] for r in out_c["history"]}
    replay = {e: (hist_a[e], hist_c.get(e)) for e in range(1, PREEMPT_EPOCHS)}
    bitwise = (_state_equal(out_a, out_c)
               and (out_a["best_mrr"], out_a["best_epoch"])
               == (out_c["best_mrr"], out_c["best_epoch"])
               and all(a == c for a, c in replay.values()))
    if not bitwise:
        raise AssertionError(f"preempt: the resumed run differs from the "
                             f"uninterrupted one (val mrr {replay}, best "
                             f"{out_a['best_mrr']}@{out_a['best_epoch']} / "
                             f"{out_c['best_mrr']}@{out_c['best_epoch']})")
    tags = {"train/loss", "val/mrr", "val/hit_1", "val/hit_3", "val/hit_10",
            "val/loss", "time/train_s", "time/eval_s"}
    for run, want in (("control", list(range(PREEMPT_EPOCHS))),
                      ("stopped", list(range(PREEMPT_EPOCHS)))):
        events = _tb_events(os.path.join(tmp, run))
        if [e[0] for e in events] != want or any(set(s) != tags
                                                 for _, s in events):
            raise AssertionError(f"preempt: tb events of {run}: "
                                 f"{[(e[0], sorted(e[1])) for e in events]}")
    steps = calls_a["steps"] + calls_b["steps"] + calls_c["steps"]
    sweeps = calls_a["sweeps"] + calls_b["sweeps"] + calls_c["sweeps"]
    for i, n in enumerate(steps):
        _unfused_launches_ok(dev, n, _FIT_TRAIN, f"preempt step {i}",
                             _NOT_FIT_TRAIN)
    for i, n in enumerate(sweeps):
        _unfused_launches_ok(dev, n, _SWEEP, f"preempt sweep {i}",
                             _NOT_SWEEP)
    if dev.type != "cuda" and any(v for n in steps + sweeps
                                  for v in n.values()):
        raise AssertionError("preempt: kernels launched off the card")
    return {"epochs": PREEMPT_EPOCHS, "steps_an_epoch": len(calls_a["steps"])
            // PREEMPT_EPOCHS, "control_s": control_s,
            "val_mrr": [hist_a[e] for e in sorted(hist_a)],
            "bitwise": bitwise, "handlers_restored": restored,
            "save_last_s": calls_b["save_last_s"][0],
            "load_last_s": load_last_s,
            "tb_write_s_an_epoch": sum(tb_s) / len(tb_s),
            "tb_writes": len(tb_s),
            "launches_a_step": steps[0], "launches_a_sweep": sweeps[0]}


def _cli_flags(ctx) -> list:
    """ctx's config overrides (phase_setup's keywords beyond the data
    sizes) as training CLI flags."""
    from temp_tpu_torch.config import TKGConfig

    switches = {f.name for f in dataclasses.fields(TKGConfig)
                if isinstance(f.default, bool)}
    flags = []
    for k, v in ctx["setup_kw"].items():
        name = k.replace("_", "-")
        if k in ("num_ents", "num_rels", "num_times", "edges_per_time",
                 "seed"):
            continue
        if k in switches:
            flags.append(f"--{name}" if v else f"--no-{name}")
        else:
            flags += [f"--{name}", str(v)]
    return flags


def phase_preempt_cli(ctx, tmp: str) -> dict:
    """``python -m temp_tpu_torch.main`` (GRRGCN, --debug, CLI_EPOCHS
    epochs) on a small text dataset, in a subprocess on ctx's device:
    SIGTERM after its first metrics.jsonl line -> exit 75 with last.pt and
    no test evaluation; the rerun with --resume exits 0, names the epoch it
    resumed at, evaluates the test split and leaves no last.pt."""
    from temp_tpu_torch.data.snapshots import synthetic_quads

    kw = ctx["setup_kw"]
    n_ents, n_rels = min(kw["num_ents"], 600), min(kw["num_rels"], 24)
    quads = synthetic_quads(n_ents, n_rels, min(kw["num_times"], 48),
                            min(kw["edges_per_time"], 60), seed=1)
    root = write_dataset(os.path.join(tmp, "cli_data"), "cli", quads,
                         n_ents, n_rels)
    runs = os.path.join(tmp, "cli_runs")
    here = os.path.dirname(os.path.abspath(__file__))
    args = [sys.executable, "-m", "temp_tpu_torch.main", "-c",
            os.path.join(here, "grid", "icews14", "config_grrgcn.json"),
            "--device", ctx["device"].type, "--data-root", root,
            "--dataset", "cli", "--debug", "--patience", "50",
            "--max-nb-epochs", str(CLI_EPOCHS), "--experiments-dir", runs,
            "--model-name", "preempt", *_cli_flags(ctx)]
    env = dict(os.environ)
    if ctx["device"].type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    run = os.path.join(runs, "preempt")
    metrics = os.path.join(run, "metrics.jsonl")
    last = os.path.join(run, "checkpoints", "last.pt")
    t0 = time.perf_counter()
    proc = subprocess.Popen(args, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        while time.perf_counter() - t0 < CLI_TIMEOUT_S:
            if os.path.exists(metrics) and open(metrics).read().count("\n"):
                break
            if proc.poll() is not None:
                raise AssertionError(f"preempt_cli: the run ended before "
                                     f"its first epoch:\n{proc.stdout.read()}")
            time.sleep(0.02)
        first_epoch_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stopped_s = time.perf_counter() - t0
    done = open(metrics).read().count("\n")
    if not (proc.returncode == 75 and "preempted at epoch" in out
            and "test: mrr=" not in out and os.path.exists(last)
            and done < CLI_EPOCHS):
        raise AssertionError(f"preempt_cli: exit {proc.returncode}, last.pt "
                             f"{os.path.exists(last)}, {done} epochs:\n"
                             f"{out[-3000:]}")
    t0 = time.perf_counter()
    res = subprocess.run(args + ["--resume"], cwd=here, env=env,
                         capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S)
    resumed_s = time.perf_counter() - t0
    epochs = [json.loads(x)["epoch"] for x in
              open(metrics).read().splitlines()]
    if not (res.returncode == 0
            and f"resumed preempted run at epoch {done}" in res.stdout
            and "test: mrr=" in res.stdout and not os.path.exists(last)
            and epochs == list(range(CLI_EPOCHS))):
        raise AssertionError(f"preempt_cli: the resumed run: exit "
                             f"{res.returncode}, epochs {epochs}, last.pt "
                             f"{os.path.exists(last)}:\n"
                             f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
    return {"stopped_exit": 75, "stopped_after_epochs": done,
            "resumed_exit": 0, "first_epoch_s": first_epoch_s,
            "stopped_s": stopped_s, "resumed_s": resumed_s,
            "facts": int(sum(len(q) for q in quads))}


def _element_near_ties(model, params, data, t: int, split: str):
    """[2Q] bool in the [head, tail] layout: the queries of `split` at time
    position t whose plain scores (``model.forward_element``, eval mode)
    hold a column other than the target, not a true answer, within
    SCALED_TOL of the row's largest |score| of the target's (``_tied``)."""
    import torch

    from temp_tpu_torch.ops.membership import true_answer_mask

    edges, r2 = getattr(data, split), 2 * data.num_rels
    src, rel, dst = (x[t].long() for x in (edges.src, edges.rel, edges.dst))
    with torch.no_grad():
        table = model.forward_element(params, data, t)
        r_emb = params["rel_embeds"][rel]
        return torch.cat([
            _tied(model.score_all(table[ent], r_emb, table, direction),
                  target, true_answer_mask(tab.grp[t], tab.val[t], key,
                                           data.num_ents))
            for direction, ent, target, tab, key in (
                ("head", dst, src, data.total_head, dst * r2 + rel),
                ("tail", src, dst, data.total_tail, src * r2 + rel))])


def phase_predictions(ctx, tmp: str) -> dict:
    """The smoke's seeded GRRGCN written as a port run (config.json on the
    text dataset of data_native, checkpoints/best.pt), then
    ``temp_tpu_torch.test`` in process on the valid split with the kernels
    and with kernels=False: the kernel run's pickle is the records of the
    path phase's sweep (the same weights and data) element for element, 2
    records a fact; the plain run's ranks equal but for the plain scores'
    counted near-ties; K1f and K2f launched, none of the others; the wall
    and queries/s of each."""
    import numpy as np

    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.test import prediction_records, predict
    from temp_tpu_torch.train.checkpoint import save_checkpoint

    cfg, dev = ctx["text_cfg"], ctx["device"]
    run = os.path.join(tmp, "predictions")
    os.makedirs(run)
    with open(os.path.join(run, "config.json"), "w") as f:
        f.write(cfg.to_json())
    save_checkpoint(os.path.join(run, "checkpoints", "best.pt"),
                    ctx["params"], None, 0, {"mrr": 0.0})
    res, out = {}, {}
    for name, over in (("kernels", {}), ("plain", {"kernels": False})):
        _reset_counts()
        t0 = time.perf_counter()
        m, records, ranks, mask = predict(run, "valid", device=dev.type,
                                          log_fn=lambda *_: None, **over)
        wall = time.perf_counter() - t0
        res[name] = {"wall_s": wall, "sweep_s": m["n"] / m["queries_per_s"],
                     "queries_per_s": m["queries_per_s"], "mrr": m["mrr"],
                     "n": m["n"], "records": len(records),
                     "launches": _counts()}
        out[name] = (records, ranks, mask)
    (rec_k, rk, mk), (rec_p, rp, mp) = out["kernels"], out["plain"]
    data = ctx["data"]
    n_facts = int(data.valid.emask.sum())
    path_ranks = ctx["path_runs"]["kernels"][0]
    if rec_k != prediction_records(data, "valid", path_ranks,
                                   ctx["cfg"].eval_batch):
        raise AssertionError("predictions: the pickle differs from the "
                             "path sweep's ranks")
    if not (len(rec_k) == len(rec_p) == 2 * n_facts == res["kernels"]["n"]
            and np.array_equal(mk, mp)):
        raise AssertionError(f"predictions: {len(rec_k)} / {len(rec_p)} "
                             f"records for {n_facts} facts")
    _unfused_launches_ok(dev, res["kernels"]["launches"], _SWEEP,
                         "predictions", _NOT_SWEEP)
    if any(res["plain"]["launches"].values()) or (
            dev.type != "cuda" and any(res["kernels"]["launches"].values())):
        raise AssertionError(f"predictions: kernels launched on a plain "
                             f"run: {res['plain']['launches']}")
    # ranks equal but the plain scores' near-ties, judged where they differ
    diff = mk & (rk != rp)
    B = rk.shape[1]
    model = get_model(cfg.replace(kernels=False), data, device=dev)
    tdata = ctx["trainer"].data
    near = 0
    for bi, b in sorted({(int(i), int(j)) for i, j, _ in np.argwhere(diff)}):
        t = bi * B + b
        tied = _element_near_ties(model, ctx["params"], tdata, t,
                                  "valid").cpu().numpy()
        if (diff[bi, b] & ~tied).any():
            raise AssertionError(f"predictions: ranks at time position {t} "
                                 f"differ away from a near-tie")
        near += int((diff[bi, b] & tied).sum())
    res.update(rank_diffs=int(diff.sum()), near_ties=near,
               records=len(rec_k), facts=n_facts)
    for name in ("kernels", "plain"):
        for k in ("wall_s", "sweep_s", "queries_per_s"):
            res[f"{k}_{name}"] = res[name][k]
    return res


def phase_profiling(ctx, tmp: str) -> dict:
    """``trace`` around one GRRGCN training step (the main path: K2f, K2b,
    K3-K5): the Chrome trace names the hand-written kernels on the card
    (window_layer_kernel, final_layer_kernel among them);
    ``StepTimer`` over that step; ``device_memory_stats()`` with a peak
    above 0 for card 0 (empty off the card)."""
    import glob

    import torch

    from temp_tpu_torch.utils.profiling import (
        StepTimer, device_memory_stats, trace,
    )

    dev, tr = ctx["device"], ctx["trainer"]
    params, opt = tr.init_state()
    t_pos, t_valid = tr.epoch_batches(0)[0]
    tr.train_step(params, opt, t_pos, t_valid, gen=tr.step_generator(0, 0))
    timer = StepTimer()
    with trace(os.path.join(tmp, "trace")) as log_dir:
        timer.start()
        loss = tr.train_step(params, opt, t_pos, t_valid,
                             gen=tr.step_generator(0, 1))
        step_s = timer.stop(sync_on=loss)
    files = glob.glob(os.path.join(log_dir, "trace.*.json"))
    if len(files) != 1:
        raise AssertionError(f"profiling: trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    want = ("window_layer_kernel", "final_layer_kernel")
    found = {k: sum(k in n for n in names) for k in want}
    kernels = sorted(n for n in names if "kernel" in n)[:40]
    mem = device_memory_stats()
    if dev.type == "cuda":
        if not all(found.values()):
            raise AssertionError(f"profiling: the trace misses {found}: "
                                 f"{kernels}")
        if not mem.get("cuda:0", {}).get("peak_bytes_mb", 0) > 0:
            raise AssertionError(f"profiling: memory stats {mem}")
    elif mem:
        raise AssertionError(f"profiling: memory stats off the card: {mem}")
    return {"trace_mb": os.path.getsize(files[0]) / 2**20,
            "events": len(events), "kernel_names": found,
            "step_ms": step_s * 1e3, "ema_ms": timer.ema * 1e3,
            "memory": mem,
            "peak_mb": mem.get("cuda:0", {}).get("peak_bytes_mb")}


def run_phases(ctx) -> dict:
    """The run tools' phases, each printing its line: data_native, preempt,
    preempt_cli, predictions, profiling, in a temporary directory removed
    at the end. Returns their results by phase name."""
    import shutil
    import tempfile

    res = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_run_")
    try:
        for name, fn in (("data_native", phase_data_native),
                         ("preempt", phase_preempt),
                         ("preempt_cli", phase_preempt_cli),
                         ("predictions", phase_predictions),
                         ("profiling", phase_profiling)):
            with phase(name, {}) as out:
                out.update(fn(ctx, tmp))
            res[name] = out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        raise AssertionError(f"run phases: {tmp} not removed")
    return res


# -- "auto" on the card, "onehot" in bfloat16 ---------------------------------

AUTO_STEPS = 2   # the auto_dtype phase's steps of each model
PART_STEPS = 4   # the dp_mesh and flagship_partition phases' steps


def phase_auto_dtype(ctx, fctx) -> dict:
    """compute_dtype "auto" (the grid configs' and the CLI's default) on
    the card: the training CLI's parse keeps "auto", ``get_model``
    resolves it for the device (bfloat16 on CUDA, float32 on the CPU);
    AUTO_STEPS default training steps of GRRGCN and of the flagship with
    it launch their fused kernels as many times a step as bf16_path's and
    bf16_flagship_path's (_BF16_STEP, _BF16_FLAGSHIP_STEP) and give their
    losses bit for bit: the bfloat16 modes on the same weights and draws.
    The explicit "float32" of the other phases stays float32."""
    from temp_tpu_torch import main as port_main

    dev = ctx["device"]
    here = os.path.dirname(os.path.abspath(__file__))
    cli_cfg, cli_dev = port_main.parse_args(
        ["-c", os.path.join(here, "grid", "icews14", "config_grrgcn.json")])
    want_dtype = "bfloat16" if dev.type == "cuda" else "float32"
    res = {"cli_compute_dtype": cli_cfg.compute_dtype, "cli_device": cli_dev,
           "cli_resolved": cli_cfg.for_device(dev).compute_dtype}
    if (cli_cfg.compute_dtype, cli_dev) != ("auto", "cuda") \
            or res["cli_resolved"] != want_dtype:
        raise AssertionError(f"auto dtype: the CLI's default {res}")
    for tag, c, step, banned in (
            ("grrgcn", ctx, _BF16_STEP, _NOT_BF16),
            ("flagship", fctx, _BF16_FLAGSHIP_STEP, _NOT_BF16_FLAGSHIP)):
        cfg = c["cfg"].replace(compute_dtype="auto")
        model, run, *_ = _train_path(dict(c, train_steps=AUTO_STEPS), cfg)
        run["resolved"] = model.cfg.compute_dtype
        ref = c["bf16_ref"]["losses"][:AUTO_STEPS]
        run["bitwise_to_bf16_path"] = run["losses"] == ref
        run["gap_to_f32"] = abs(run["losses"][0] - c["train_ref"]["losses"][0])
        res[tag] = run
        print(f"  auto {tag}: {run}", flush=True)
        if run["resolved"] != want_dtype:
            raise AssertionError(f"auto {tag}: resolved to {run['resolved']}")
        if dev.type != "cuda":
            continue
        n = run["launches"]
        got = {k: n[k] for k in step}
        if got != {k: v * AUTO_STEPS for k, v in step.items()} or any(
                n[k] for k in banned) or n["spmm_fwd"]:
            raise AssertionError(f"auto {tag}: launches {n}, want {step} a "
                                 f"step")
        if not run["bitwise_to_bf16_path"]:
            raise AssertionError(f"auto {tag}: losses {run['losses']} are "
                                 f"not the bfloat16 path's {ref}")
    return res


def _onehot_library(h, src, dst, rel, em, w, n2=None, g=None):
    """The library's call for the "onehot" rounding's work: one
    ``index_add_`` of the same rounded scaled messages (forward), or of
    the same rounded dh terms (backward, with the forward's norm n2 and
    the cotangent g; the weights' bfloat16 sum is the kernel's own)."""
    import torch

    BF = torch.bfloat16

    def rb(x):
        return x.to(BF).to(torch.float32)

    emf = em.to(torch.float32)[:, None]
    if g is None:
        deg = torch.zeros(h.shape[0], device=h.device).index_add_(
            0, dst.long(), emf[:, 0])
        norm = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)
        msg = rb(rb(rb(h[src.long()].float()) * rb(w[rel.long()]))
                 * rb(norm[dst.long()][:, None] * emf))
        out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        return lambda: out.zero_().index_add_(0, dst.long(), msg)
    dmsg = rb(rb(g * n2[:, None])[dst.long()]
              * rb(n2[dst.long()][:, None] * emf))
    terms = rb(dmsg * rb(w[rel.long()]))
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    return lambda: out.zero_().index_add_(0, src.long(), terms)


def phase_onehot_bf16(ctx) -> dict:
    """K1's "onehot" rounding (the SpMM method "onehot" in bfloat16: the
    launchers' onehot flag of csrc/spmm_bf16.cu) at K1's main-path shapes
    (``_k1_cases``: the final step, the conv1 table, the training final
    step), forward and backward, on the operands the path hands it: one
    launch a call, no sort, no host sync; two runs bit-equal; within
    K1_TOL of the largest entry of its plain version; times, bounds and
    the library's ``index_add_`` of the same rounded values. Then
    GRRGCN's unfused bfloat16 training (fused_final off: the final step
    one element at a time through K1) for AUTO_STEPS steps under the
    method "onehot", kernels against plain: losses within TRAIN_TOL, K1f
    and K1b launched only in that rounding, 16 a step each."""
    import numpy as np
    import torch

    from temp_tpu_torch.ops.spmm import (
        _spmm_fwd, spmm_bwd, spmm_bwd_plain, spmm_fwd, spmm_fwd_plain,
    )

    BF = torch.bfloat16
    dev = ctx["device"]
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for tag, args, tables in _k1_cases(ctx):
        flat = _flat(args)
        h, src, dst, rel, em, w = flat
        k, nrm, _ = _one_launch(
            lambda: _spmm_fwd(*args, tables=tables, hot=BF, onehot=True),
            spmm_fwd, f"K1 onehot {tag}", dev)
        again = _spmm_fwd(*args, tables=tables, hot=BF, onehot=True)[0]
        ref = spmm_fwd_plain(*flat, hot=BF, onehot=True)
        rec = {"shape": f"N={h.shape[0]} B={tables[1].numel()} "
                        f"E={src.numel()} kept={int(em.sum())} "
                        f"R={w.shape[0]} d={h.shape[1]}, bf16 onehot",
               "max_abs_err": max_err(k, ref),
               "scaled_err": _k1_scaled_err(k, ref),
               "bitwise": bool(torch.equal(k, again)),
               "ms": time_ms(lambda: spmm_fwd(*args, tables=tables, hot=BF,
                                              onehot=True), dev),
               "plain_ms": time_ms(lambda: spmm_fwd_plain(
                   *flat, hot=BF, onehot=True), dev, reps=5),
               "library_ms": time_ms(_onehot_library(*flat), dev)}
        rec["bound_ms"], rec["bound_by"] = _k1_bf16_bound(
            h, src, dst, rel, em, h.shape[0], w.shape[0], 4, False)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        out[tag] = rec
        print(f"  K1 onehot {tag}: {rec}", flush=True)
        if not (rec["scaled_err"] <= K1_TOL and rec["bitwise"]):
            raise AssertionError(f"K1 onehot {tag}: {rec}")
        if tag == "table":
            continue
        g = torch.randn(h.shape, generator=gen, device=dev)
        dh, dw = _one_launch(
            lambda: spmm_bwd(g, nrm, *args, tables=tables, hot=BF,
                             onehot=True), spmm_bwd, f"K1b onehot {tag}",
            dev)
        ah, aw = spmm_bwd(g, nrm, *args, tables=tables, hot=BF, onehot=True)
        rh, rw = spmm_bwd_plain(g, nrm, *flat, hot=BF, onehot=True)
        rec = {"shape": out[tag]["shape"],
               "max_abs_err": max(max_err(dh, rh), max_err(dw, rw)),
               "scaled_err": max(_k1_scaled_err(dh, rh),
                                 _k1_scaled_err(dw, rw)),
               "bitwise": bool(torch.equal(dh, ah) and torch.equal(dw, aw)),
               "ms": time_ms(lambda: spmm_bwd(g, nrm, *args, tables=tables,
                                              hot=BF, onehot=True), dev),
               "plain_ms": time_ms(lambda: spmm_bwd_plain(
                   g, nrm, *flat, hot=BF, onehot=True), dev, reps=3),
               "library_ms": time_ms(_onehot_library(*flat, n2=nrm, g=g),
                                     dev)}
        rec["bound_ms"], rec["bound_by"] = _k1_bf16_bound(
            h, src, dst, rel, em, h.shape[0], w.shape[0], 4, True)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        out[f"bwd_{tag}"] = rec
        print(f"  K1b onehot {tag}: {rec}", flush=True)
        if not (rec["scaled_err"] <= K1_TOL and rec["bitwise"]):
            raise AssertionError(f"K1b onehot {tag}: {rec}")
    cfg = ctx["cfg"].replace(compute_dtype="bfloat16", fused_final=False)
    tctx = dict(ctx, train_steps=AUTO_STEPS)
    runs = {}
    with spmm_method("onehot"):
        for name, kernels in (("kernels", True), ("plain", False)):
            _, runs[name], *_ = _train_path(tctx,
                                            cfg.replace(kernels=kernels))
            print(f"  onehot train {name}: {runs[name]}", flush=True)
    x, y = (np.array(runs[n]["losses"]) for n in ("kernels", "plain"))
    gap = float(np.max(np.abs(x - y) / np.maximum(1.0, np.abs(y))))
    n = runs["kernels"]["launches"]
    per = 2 * ctx["cfg"].batch_size * AUTO_STEPS
    if not (np.isfinite(x).all() and gap <= TRAIN_TOL):
        raise AssertionError(f"onehot train: losses {x} against {y}")
    if dev.type == "cuda" and {k: n[k] for k in (
            "spmm_fwd", "spmm_fwd_onehot", "spmm_bwd", "spmm_bwd_onehot")} \
            != dict.fromkeys(("spmm_fwd", "spmm_fwd_onehot", "spmm_bwd",
                              "spmm_bwd_onehot"), per):
        raise AssertionError(f"onehot train: K1 launches {n}, want {per} "
                             f"of K1f and K1b, all in the onehot rounding")
    if any(runs["plain"]["launches"].values()):
        raise AssertionError(f"onehot plain train: {runs['plain']}")
    out["steps"] = dict(runs, max_rel_gap=gap)
    return out


# -- the boundary exchange, the data axis, the flagship under partitions ------

def _partition_ctx(c, mode: str, dp: int = 1, **extra) -> dict:
    """The context `c` (GRRGCN's or the flagship's) with
    edge_partition=`mode` over RING_M ranks and a data axis of `dp`, all
    on the smoke's device: its data in the partition's layout
    (ring_layout), the mesh, the same seeded weights."""
    from temp_tpu_torch.data.snapshots import ring_layout
    from temp_tpu_torch.parallel.mesh import make_mesh

    dev = c["device"]
    cfg = c["cfg"].replace(edge_partition=mode, mp_size=RING_M, dp_size=dp)
    data = ring_layout(cfg, c["data"])
    return dict(c, cfg=cfg, data=data,
                mesh=make_mesh(dp, RING_M, devices=[dev] * (dp * RING_M)),
                **extra)


def _boundary_calls(c, shards: int = 1) -> dict:
    """The SpMM calls of a training step (all B elements valid) and of a
    valid sweep of c's model under a partition: two layers a window step
    (one call for the shard's graphs side by side; the Bi models' two
    windows) and two an element in the final step."""
    L1, B, T = c["L1"], c["B"], c["T"]
    windows = 2 if c["cfg"].module.startswith("Bi") else 1
    win = 2 * L1 * windows
    return {"step": shards * win + 2 * B,
            "sweep": -(-T // B) * (win + 2 * B)}


def _k1_ranks_ok(dev, run: dict, calls: int, tag: str,
                 train: bool) -> None:
    """A boundary run launched K1 (float32, over the data's tables of the
    ranks' slices: no sort in a call) RING_M times a call (K1b as many,
    training; none in a sweep), and none of K2-K13."""
    n = run["launches"]
    want = RING_M * calls
    banned = [k for k in _NOT_ON_RING + ("ring_spmm_fwd", "ring_spmm_bwd")
              if k not in ("spmm_fwd", "spmm_bwd") and n[k]]
    if dev.type == "cuda" and (
            n["spmm_fwd"] != want or n["spmm_bwd"] != (want if train else 0)
            or n["spmm_fwd_bf16"] or n["spmm_bwd_bf16"] or banned
            or run["k1_csr_builds"]):
        raise AssertionError(f"{tag}: launches {n}, K1 sorted "
                             f"{run['k1_csr_builds']} calls; want {want} of "
                             f"K1f in float32 and nothing else")


def _loss_gap(a, b) -> float:
    import numpy as np

    x, y = np.array(a["losses"]), np.array(b["losses"])
    if not np.isfinite(x).all():
        raise AssertionError(f"losses not finite: {x}")
    return float(np.max(np.abs(x - y) / np.maximum(1.0, np.abs(y))))


def phase_boundary(ctx, ring_path, ring_train) -> dict:
    """GRRGCN with edge_partition="boundary" over RING_M ranks on the one
    card (K1 in float32 a rank over the data's tables of its edge slice,
    the cut rows read from the others), in float32 and in bfloat16 (the
    cut rows arrive rounded): TRAIN_STEPS training steps and the valid
    sweep with the kernels and with their plain versions, and in float32
    under "psum" too: losses within TRAIN_TOL of each other and of
    ring_train's ring_pallas run (float32; the same regrouped data and
    draws), leaves within PARAM_TOL (BF16_PARAM_TOL in bfloat16) of the
    plain path's change, MRR within MRR_TOL of each other and of
    ring_path's; K1 launched RING_M times a call (_k1_ranks_ok). Beside
    them the cut's capacities (Cg, Cc) and the rows a call moves, the
    cut's against the ring's rotated shards."""
    import numpy as np

    from temp_tpu_torch.parallel.edge_partition import ring_geometry

    bctx = _partition_ctx(ctx, "boundary")
    data, dev = bctx["data"], bctx["device"]
    N, A = ctx["N"], int(data.act_idx.shape[1])
    bnd_g, bnd_c = np.asarray(data.bnd_g), np.asarray(data.bnd_c)
    res = {"Cg": int(bnd_g.shape[-1]), "Cc": int(bnd_c.shape[-1]),
           "cut_rows_final": float((bnd_g < N).sum((1, 2, 3)).mean()),
           "cut_rows_window": float((bnd_c < A).sum((1, 2, 3)).mean()),
           "ring_rows_final": RING_M * (RING_M - 1) * ring_geometry(
               N, RING_M),
           "ring_rows_window": RING_M * (RING_M - 1) * ring_geometry(
               A, RING_M)}
    res["rows_share_final"] = res["cut_rows_final"] / res["ring_rows_final"]
    res["rows_share_window"] = (res["cut_rows_window"]
                                / res["ring_rows_window"])
    calls = _boundary_calls(bctx)
    steps = bctx.get("train_steps", TRAIN_STEPS)
    cfg = bctx["cfg"]
    for dt, tol in (("float32", PARAM_TOL), ("bfloat16", BF16_PARAM_TOL)):
        c = cfg.replace(compute_dtype=dt)
        runs = (("kernels", c), ("plain", c.replace(kernels=False)))
        if dt == "float32":
            runs += (("psum", c.replace(edge_partition="psum")),)
        train, finals, init, evals = {}, {}, None, {}
        for name, rc in runs:
            _, train[name], leaves, finals[name], _, _ = _train_path(bctx,
                                                                      rc)
            init = leaves if init is None else init
            evals[name], _, _ = _sweep(bctx, rc)
            print(f"  boundary {dt} {name}: train {train[name]}, eval "
                  f"{evals[name]}", flush=True)
        k = train["kernels"]
        gaps = {f"kernels/{o}": _loss_gap(k, train[o]) for o in train
                if o != "kernels"}
        mrr = {f"kernels/{o}": abs(evals["kernels"]["mrr"] - evals[o]["mrr"])
               for o in evals if o != "kernels"}
        if dt == "float32":
            gaps["kernels/ring_pallas"] = _loss_gap(k, ring_train["ring"])
            mrr["kernels/ring_pallas"] = abs(evals["kernels"]["mrr"]
                                             - ring_path["kernels"]["mrr"])
            mrr["kernels/unpartitioned"] = abs(
                evals["kernels"]["mrr"] - ring_path["unpartitioned"]["mrr"])
        if not (all(g <= TRAIN_TOL for g in gaps.values())
                and all(g <= MRR_TOL for g in mrr.values())):
            raise AssertionError(f"boundary {dt}: loss gaps {gaps}, MRR "
                                 f"gaps {mrr}")
        names = tuple(n for n, _ in runs if n != "plain") + ("plain",)
        out = {"train": train, "eval": evals, "loss_gaps": gaps,
               "mrr_gaps": mrr,
               "params": param_gaps(init, finals, names=names, tol=tol)}
        _k1_ranks_ok(dev, k, calls["step"] * steps, f"boundary {dt} train",
                     True)
        _k1_ranks_ok(dev, evals["kernels"], calls["sweep"],
                     f"boundary {dt} eval", False)
        for name in ("plain",) + (("psum",) if dt == "float32" else ()):
            if any(train[name]["launches"].values()) or any(
                    evals[name]["launches"].values()):
                raise AssertionError(f"boundary {dt} {name}: kernels "
                                     f"launched")
        res[dt] = out
    res["loss_gap_bf16_to_f32"] = _loss_gap(res["bfloat16"]["train"][
        "kernels"], res["float32"]["train"]["kernels"])
    res["mrr_gap_bf16_to_f32"] = (res["bfloat16"]["eval"]["kernels"]["mrr"]
                                  - res["float32"]["eval"]["kernels"]["mrr"])
    ctx["boundary_ref"] = res["float32"]["eval"]["kernels"]
    return res


def phase_dp_mesh(ctx) -> dict:
    """GRRGCN under "boundary" on a (2, RING_M) mesh (dp_size 2, every rank
    on the one card): PART_STEPS Trainer steps with the kernels and with
    their plain versions (each step's batch of B split into two shards of
    B / 2, each with its own draws), losses within TRAIN_TOL, leaves within
    PARAM_TOL of the plain path's change, K1 launched RING_M times a call
    (each shard's window calls apart); one eval batch's MRR and BCE equal
    to the (1, RING_M) mesh's within MRR_TOL and 1e-5 relative."""
    import numpy as np
    import torch

    from temp_tpu_torch.models.objectives import metrics_from_ranks
    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer

    # a batch that splits in two (the smoke's 8)
    B = 2 * (ctx["B"] // 2)
    dctx = _partition_ctx(ctx, "boundary", dp=2, train_steps=PART_STEPS,
                          B=B)
    dctx["cfg"] = dctx["cfg"].replace(batch_size=B)
    dev, cfg = dctx["device"], dctx["cfg"]
    train, finals, init = {}, {}, None
    for name, c in (("kernels", cfg), ("plain", cfg.replace(kernels=False))):
        _, train[name], leaves, finals[name], tr, _ = _train_path(dctx, c)
        init = leaves if init is None else init
        print(f"  dp mesh {name}: {train[name]}", flush=True)
    res = {"placement": dctx["mesh"].placement(), "train": train,
           "max_rel_gap": _loss_gap(train["kernels"], train["plain"]),
           "params": param_gaps(init, finals, names=("kernels", "plain")),
           "eval_batch": tr.eval_batch()}
    if not (res["max_rel_gap"] <= TRAIN_TOL and res["eval_batch"]
            == 2 * (dctx["cfg"].eval_batch // 2) and tr.model.dp == 2):
        raise AssertionError(f"dp mesh: {res}")
    _k1_ranks_ok(dev, train["kernels"],
                 _boundary_calls(dctx, shards=2)["step"] * PART_STEPS,
                 "dp mesh train", True)
    if any(train["plain"]["launches"].values()):
        raise AssertionError("dp mesh plain: kernels launched")
    # one eval batch on both meshes
    t_pos = np.arange(B) + ctx["T"] // 2
    out = {}
    for tag, c in (("2x4", dctx), ("1x4", _partition_ctx(ctx, "boundary"))):
        tr = Trainer(c["cfg"], get_model(c["cfg"], c["data"], device=dev),
                     c["data"], mesh=c["mesh"])
        with torch.no_grad():
            ranks, mask, bce = tr.model.eval_ranks(
                ctx["params"], tr.data, t_pos, np.ones(len(t_pos), bool),
                "valid")
        m = metrics_from_ranks(ranks.cpu().numpy()[None],
                               mask.cpu().numpy()[None])
        out[tag] = {"mrr": m["mrr"], "n": m["n"], "bce": float(bce)}
    res["eval_batch_runs"] = out
    a, b = out["2x4"], out["1x4"]
    if not (a["n"] == b["n"] and abs(a["mrr"] - b["mrr"]) <= MRR_TOL
            and abs(a["bce"] - b["bce"]) <= 1e-5 * max(1.0, abs(b["bce"]))):
        raise AssertionError(f"dp mesh eval batch: {out}")
    return res


def phase_flagship_partition(fctx, flagship_path) -> dict:
    """The flagship BiGRRGCN --impute under "ring_pallas" (K13 and K13b)
    and "boundary" (K1 a rank) over RING_M ranks on the one card, on the
    same regrouped data and draws: PART_STEPS training steps (both
    windows step by step, the bi-center + impute final step one element
    at a time, as the fused paths are off inside a partition) and the
    valid sweep. The two modes' losses within TRAIN_TOL and leaves within
    PARAM_TOL of each other's change, their MRR within MRR_TOL of each
    other and of flagship_path's unpartitioned sweep; K13 RING_M and K13b
    RING_M + 2 launches a call under ring_pallas, K1 RING_M a call under
    boundary, and nothing else."""
    train, evals, finals, init = {}, {}, {}, None
    dev = fctx["device"]
    for mode in ("ring_pallas", "boundary"):
        pctx = _partition_ctx(fctx, mode, train_steps=PART_STEPS)
        _, train[mode], leaves, finals[mode], _, _ = _train_path(
            pctx, pctx["cfg"])
        init = leaves if init is None else init
        evals[mode], _, _ = _sweep(pctx, pctx["cfg"])
        print(f"  flagship {mode}: train {train[mode]}, eval {evals[mode]}",
              flush=True)
    calls = _boundary_calls(pctx)
    res = {"train": train, "eval": evals,
           "max_rel_gap": _loss_gap(train["ring_pallas"], train["boundary"]),
           "params": param_gaps(init, finals,
                                names=("ring_pallas", "boundary")),
           "mrr_gaps": {
               "ring_pallas/boundary": abs(evals["ring_pallas"]["mrr"]
                                           - evals["boundary"]["mrr"]),
               "boundary/unpartitioned": abs(
                   evals["boundary"]["mrr"]
                   - flagship_path["kernels"]["mrr"])}}
    if not (res["max_rel_gap"] <= TRAIN_TOL
            and all(g <= MRR_TOL for g in res["mrr_gaps"].values())):
        raise AssertionError(f"flagship partitions: {res['max_rel_gap']}, "
                             f"{res['mrr_gaps']}")
    _k1_ranks_ok(dev, train["boundary"], calls["step"] * PART_STEPS,
                 "flagship boundary train", True)
    _k1_ranks_ok(dev, evals["boundary"], calls["sweep"],
                 "flagship boundary eval", False)
    for tag, run, is_train in (("train", train["ring_pallas"], True),
                               ("eval", evals["ring_pallas"], False)):
        _ring_launches_ok(dev, run, f"flagship ring_pallas {tag}", is_train)
        n = run["launches"]
        want = calls["step"] * PART_STEPS if is_train else calls["sweep"]
        if dev.type == "cuda" and (
                n["ring_spmm_fwd"] != RING_M * want or n["ring_spmm_bwd"]
                != ((RING_M + 2) * want if is_train else 0)):
            raise AssertionError(f"flagship ring_pallas {tag}: {n}, want "
                                 f"{want} calls")
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(WATCHDOG_S)
    _state["watchdog"] = True
    # backstop for a call that never returns to Python (a hung kernel under
    # synchronize): a C-level thread dumps the stacks and exits 1
    faulthandler.dump_traceback_later(WATCHDOG_S + 15, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    with phase("device", {}) as dv:
        dv.update(phase_device())
    with phase("build", {}) as b:
        b.update(phase_build())
    with phase("setup", {}) as s:
        ctx = phase_setup("cuda")
        s.update({k: ctx[k] for k in ("N", "T", "A", "E", "L1", "B", "d")})
        for sp, mb in ctx["k1_tables_mb"].items():
            s[f"k1_tables_mb_{sp}"] = mb
    with phase("k1", {}) as k1:
        k1.update(phase_k1(ctx))
    with phase("k2", {}) as k2:
        k2.update(phase_k2(ctx))
    with phase("path", {}) as pa:
        pa.update(phase_path(ctx))
        pa["mrr_kernels"] = pa["kernels"]["mrr"]
        pa["mrr_plain"] = pa["plain"]["mrr"]
    with phase("k1b", {}) as k1b:
        k1b.update(phase_k1b(ctx))
    with phase("k2b", {}) as k2b:
        k2b.update(phase_k2b(ctx))
    with phase("k3", {}) as k3:
        k3.update(phase_k3(ctx))
    with phase("k4", {}) as k4:
        k4.update(phase_k4(ctx))
    with phase("k5", {}) as k5:
        k5.update(phase_k5(ctx))
    with phase("train", {}) as tra:
        tra.update(phase_train(ctx))
        for name, _ in _PATHS:
            tra[f"ms_per_step_{name}"] = tra[name]["ms_per_step"]
    res = {"k1": k1, "k2": k2, "path": pa, "k1b": k1b, "k2b": k2b, "k3": k3,
           "k4": k4, "k5": k5, "train": tra}
    with phase("bf16_kernels", {}) as bk:
        bk.update(phase_bf16_kernels(ctx))
        for name in [n for n in bk if isinstance(bk[n], dict)]:
            bk[f"{name}_ms"] = bk[name]["ms"]
            bk[f"{name}_rms_ratio"] = bk[name]["rms_ratio"]
    res["bf16_kernels"] = bk
    with phase("bf16_path", {}) as bp:
        bp.update(phase_bf16_path(ctx, tra, pa))
        for name, _ in _PATHS:
            bp[f"ms_per_step_{name}"] = bp[name]["ms_per_step"]
        for k in ("wall_s", "mrr", "queries_per_s", "peak_mb"):
            bp[f"eval_{k}"] = bp["eval_kernels"][k]
    res["bf16_path"] = bp
    with phase("flagship_setup", {}) as fs:
        fctx = phase_setup_flagship(ctx)
        fs.update({k: fctx[k] for k in ("N", "A", "E", "L1", "B", "d")})
    for name, fn in (("k2_flagship", phase_k2_flagship), ("k6k7", phase_k6k7),
                     ("k8", phase_k8), ("k9k10", phase_k9k10)):
        with phase(name, {}) as out:
            out.update(fn(fctx))
        res[name] = out
    with phase("flagship_path", {}) as fp:
        fp.update(phase_path(fctx))
        fp["mrr_kernels"] = fp["kernels"]["mrr"]
        fp["mrr_plain"] = fp["plain"]["mrr"]
    res["flagship_path"] = fp
    with phase("flagship_train", {}) as ft:
        ft.update(phase_train(fctx, flagship=True))
        for name, _ in _PATHS:
            ft[f"ms_per_step_{name}"] = ft[name]["ms_per_step"]
    res["flagship_train"] = ft
    with phase("k11", {}) as k11:
        k11.update(phase_k11(ctx))
    res["k11"] = k11
    with phase("path_fused_eval", {}) as pf:
        pf.update(phase_path_fused_eval(ctx, pa))
        for name in ("kernels", "plain"):
            pf[f"mrr_{name}"] = pf[name]["mrr"]
            pf[f"wall_s_{name}"] = pf[name]["wall_s"]
            pf[f"queries_per_s_{name}"] = pf[name]["queries_per_s"]
    res["path_fused_eval"] = pf
    with phase("mb", {}) as mb:
        mb.update(phase_mb(ctx, fctx))
        mb["train_bitwise"] = mb["train"]["bitwise"]
        mb["flagship_train_bitwise"] = mb["flagship_train"]["bitwise"]
        mb["eval_ranks_equal"] = mb["eval"]["ranks_equal"]
    res["mb"] = mb
    with phase("k2_modes", {}) as km:
        km.update(phase_k2_modes(ctx, fctx))
        for mode in list(km):
            if isinstance(km[mode], dict):
                km[f"{mode}_fwd_ms"] = km[mode]["fwd"]["ms"]
                km[f"{mode}_bwd_ms"] = km[mode]["bwd"]["ms"]
    res["k2_modes"] = {m: km[m] for m, _, _ in _K2_MODES}
    with phase("bf16_flagship_kernels", {}) as bfk:
        bfk.update(phase_bf16_flagship_kernels(ctx, fctx))
        for name in [n for n in bfk if isinstance(bfk[n], dict)]:
            bfk[f"{name}_ms"] = bfk[name]["ms"]
            bfk[f"{name}_rms_ratio"] = bfk[name]["rms_ratio"]
    res["bf16_flagship_kernels"] = bfk
    with phase("bf16_flagship_path", {}) as bfp:
        bfp.update(phase_bf16_flagship_path(fctx, ft, fp))
        for name, _ in _PATHS:
            bfp[f"ms_per_step_{name}"] = bfp[name]["ms_per_step"]
        for k in ("wall_s", "mrr", "queries_per_s", "peak_mb"):
            bfp[f"eval_{k}"] = bfp["eval_kernels"][k]
        for k, v in bfp["param_ratios"].items():
            bfp[f"param_ratio_{k}"] = v
            bfp[f"param_max_rel_gap_{k}"] = max(
                bfp["params"][k]["max_rel_gaps"].values())
    res["bf16_flagship_path"] = bfp
    with phase("auto_dtype", {}) as au:
        au.update(phase_auto_dtype(ctx, fctx))
        for tag in ("grrgcn", "flagship"):
            au[f"{tag}_resolved"] = au[tag]["resolved"]
            au[f"{tag}_bitwise"] = au[tag]["bitwise_to_bf16_path"]
            au[f"{tag}_ms_per_step"] = au[tag]["ms_per_step"]
    res["auto_dtype"] = au
    with phase("bf16_k11", {}) as b11:
        b11.update(phase_bf16_k11(ctx, bp))
        for k in ("ms", "rms_ratio", "near_ties"):
            b11[f"k11_{k}"] = b11[k]
        b11["mrr_kernels"] = b11["eval_kernels"]["mrr"]
        b11["wall_s_kernels"] = b11["eval_kernels"]["wall_s"]
    res["bf16_k11"] = b11
    with phase("bf16_mb", {}) as b12:
        b12.update(phase_bf16_mb(ctx, fctx))
        for tag in ("train", "eval"):
            b12[f"k12_{tag}_ms"] = b12[tag]["ms"]
        for tag in ("train_steps", "flagship_train_steps"):
            b12[f"{tag}_bitwise"] = b12[tag]["bitwise"]
        b12["eval_ranks_equal"] = b12["eval_sweep"]["ranks_equal"]
    res["bf16_mb"] = b12
    with phase("bf16_variants", {}) as bv:
        bv.update(phase_bf16_variants(ctx))
        for tag in list(bv):
            if isinstance(bv[tag], dict):
                bv[f"{tag}_ms_per_step"] = bv[tag]["train"]["ms_per_step"]
                bv[f"{tag}_loss_gap_to_f32"] = bv[tag]["loss_gap_to_f32"]
                bv[f"{tag}_param_ratio"] = bv[tag]["param_ratio"]
    res["bf16_variants"] = {t: bv[t] for t, *_ in _BF16_VARIANTS
                            + _BF16_DROP_VARIANTS}
    with phase("ted_setup", {}) as ts:
        tctx = phase_setup_ted(ctx)
        ts.update({k: tctx[k] for k in ("N", "A", "E", "L1", "B", "d",
                                        "freq_s")})
    with phase("ted_path", {}) as tp:
        tp.update(phase_ted_path(tctx))
        for name in ("kernels", "plain"):
            tp[f"mrr_{name}"] = tp[name]["mrr"]
            tp[f"wall_s_{name}"] = tp[name]["wall_s"]
            tp[f"queries_per_s_{name}"] = tp[name]["queries_per_s"]
    res["ted_path"] = tp
    with phase("ted_train", {}) as tt:
        tt.update(phase_train_unfused(tctx))
        tt["ms_per_step_plain"] = tt["plain"]["ms_per_step"]
    res["ted_train"] = tt
    with phase("variants", {}) as va:
        va.update(phase_variants(ctx))
        for tag in list(va):
            if isinstance(va[tag], dict):
                va[f"{tag}_ms_per_step"] = va[tag]["train"]["ms_per_step"]
    res["variants"] = {t: va[t] for t, _, _ in _VARIANTS}
    res.update(sa_phases(ctx))
    res.update(rec_phases(ctx))
    res.update(tdyn_phases(ctx))
    with phase("zoo_variants", {}) as zv:
        zv.update(phase_zoo_variants(ctx))
        for tag in list(zv):
            if isinstance(zv[tag], dict):
                zv[f"{tag}_ms_per_step"] = zv[tag]["train"]["ms_per_step"]
                zv[f"{tag}_peak_mb"] = zv[tag]["peak_mb"]
    res["zoo_variants"] = {t: zv[t] for t, *_ in _ZOO_VARIANTS}
    res.update(baseline_phases(ctx))
    res.update(agg_phases(ctx))
    res.update(run_phases(ctx))
    with phase("ring_setup", {}) as rs:
        rctx = phase_setup_ring(ctx)
        rs.update({k: rctx[k] for k in ("N", "A", "E", "B", "d", "rows",
                                        "a_cap")})
        rs["placement"] = rctx["mesh"].placement()
        rs["device_count"] = torch.cuda.device_count()
    with phase("k13", {}) as k13:
        k13.update(phase_k13(rctx))
    res["k13"] = k13
    with phase("ring_path", {}) as rp:
        rp.update(phase_ring_path(rctx))
        for name in ("kernels", "plain", "unpartitioned"):
            rp[f"mrr_{name}"] = rp[name]["mrr"]
            rp[f"wall_s_{name}"] = rp[name]["wall_s"]
            rp[f"queries_per_s_{name}"] = rp[name]["queries_per_s"]
        rp["k13_launches"] = rp["kernels"]["launches"]["ring_spmm_fwd"]
        rp["csr_builds"] = rp["kernels"]["csr_builds"]
    res["ring_path"] = rp
    with phase("ring_train", {}) as rt:
        rt.update(phase_ring_train(rctx))
        for name in ("ring", "plain", "unpartitioned"):
            rt[f"ms_per_step_{name}"] = rt[name]["ms_per_step"]
        rt["k13_launches"] = rt["ring"]["launches"]["ring_spmm_fwd"]
        rt["k13_bwd_launches"] = rt["ring"]["launches"]["ring_spmm_bwd"]
        rt["csr_builds"] = rt["ring"]["csr_builds"]
    res["ring_train"] = rt
    with phase("bf16_k13", {}) as b13:
        b13.update(phase_bf16_k13(rctx))
        for tag in ("final", "window", "bwd_final", "bwd_window"):
            b13[f"{tag}_ms"] = b13[tag]["ms"]
            b13[f"{tag}_rms_ratio"] = b13[tag]["rms_ratio"]
    res["bf16_k13"] = b13
    with phase("bf16_ring", {}) as br:
        br.update(phase_bf16_ring(rctx, rp, rt))
        br["mrr_kernels"] = br["eval_kernels"]["mrr"]
        br["ms_per_step_ring"] = br["ring"]["ms_per_step"]
        br["k13_launches"] = br["ring"]["launches"]["ring_spmm_fwd"]
        br["k13_bwd_launches"] = br["ring"]["launches"]["ring_spmm_bwd"]
    res["bf16_ring"] = br
    with phase("boundary", {}) as bd:
        bd.update(phase_boundary(ctx, rp, rt))
        for dt in ("float32", "bfloat16"):
            r = bd[dt]
            bd[f"{dt}_ms_per_step"] = r["train"]["kernels"]["ms_per_step"]
            bd[f"{dt}_mrr"] = r["eval"]["kernels"]["mrr"]
            bd[f"{dt}_wall_s"] = r["eval"]["kernels"]["wall_s"]
            bd[f"{dt}_k1_launches"] = r["eval"]["kernels"]["launches"][
                "spmm_fwd"]
    res["boundary"] = bd
    with phase("dp_mesh", {}) as dm:
        dm.update(phase_dp_mesh(ctx))
        dm["ms_per_step"] = dm["train"]["kernels"]["ms_per_step"]
        dm["k1_launches"] = dm["train"]["kernels"]["launches"]["spmm_fwd"]
    res["dp_mesh"] = dm
    with phase("flagship_partition", {}) as fpp:
        fpp.update(phase_flagship_partition(fctx, fp))
        for mode in ("ring_pallas", "boundary"):
            fpp[f"{mode}_ms_per_step"] = fpp["train"][mode]["ms_per_step"]
            fpp[f"{mode}_mrr"] = fpp["eval"][mode]["mrr"]
            fpp[f"{mode}_wall_s"] = fpp["eval"][mode]["wall_s"]
        fpp["k13_launches"] = fpp["train"]["ring_pallas"]["launches"][
            "ring_spmm_fwd"]
        fpp["k13b_launches"] = fpp["train"]["ring_pallas"]["launches"][
            "ring_spmm_bwd"]
    res["flagship_partition"] = fpp
    with phase("bf16_k1", {}) as b1:
        b1.update(phase_bf16_k1(ctx))
        for tag in [t for t in b1 if isinstance(b1[t], dict)]:
            b1[f"{tag}_ms"] = b1[tag]["ms"]
            b1[f"{tag}_scaled_err"] = b1[tag]["scaled_err"]
    res["bf16_k1"] = b1
    with phase("onehot_bf16", {}) as oh:
        oh.update(phase_onehot_bf16(ctx))
        for tag in [t for t in oh if isinstance(oh[t], dict)
                    and "ms" in oh[t]]:
            oh[f"{tag}_ms"] = oh[tag]["ms"]
            oh[f"{tag}_scaled_err"] = oh[tag]["scaled_err"]
        oh["steps_max_rel_gap"] = oh["steps"]["max_rel_gap"]
    res["onehot_bf16"] = oh
    with phase("bf16_spmm_pallas", {}) as bs:
        bs.update(phase_bf16_spmm_pallas(ctx, bp))
        for name in ("kernels", "plain"):
            bs[f"mrr_{name}"] = bs[f"eval_{name}"]["mrr"]
            bs[f"wall_s_{name}"] = bs[f"eval_{name}"]["wall_s"]
        bs["k1f_bf16_launches"] = bs["eval_kernels"]["launches"][
            "spmm_fwd_bf16"]
        bs["sa_ms_per_step"] = bs["sa_train"]["ms_per_step"]
        bs["sa_k1b_bf16_launches"] = bs["sa_train"]["kernels"]["launches"][
            "spmm_bwd_bf16"]
        bs["sa_mrr_kernels"] = bs["sa_path"]["kernels"]["mrr"]
    res["bf16_spmm_pallas"] = bs
    res.update(bf16_zoo_phases(ctx))
    _state["phase"] = "report"
    print(json.dumps(kernels_line(res)), flush=True)
    print(f"total_s={time.perf_counter() - t_start:.3f}", flush=True)
    print(smi_line(), flush=True)
    signal.alarm(0)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
