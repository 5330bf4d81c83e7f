"""Smoke run of fedml_tpu_torch on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

1. finds the card, prints its name and power limit, builds the CUDA kernels
   from csrc/ (one nvcc per source, all started together, printing nvcc's
   -Xptxas -v lines), reads each flash kernel's registers and spills and,
   where the toolkit has cuobjdump, counts its tensor-core (HMMA)
   instructions (every flash kernel instance must have them), and prints
   the TF32 settings;
2. holds the aggregation kernel against its plain PyTorch version on the
   card, at the FedAvg CNN's shape [10, 1,206,590] and at edge shapes, and
   times kernel, plain version and one library call with CUDA events;
3. drives the CNN path through its entry point,
   ``fedml_tpu_torch.experiments.main_fedavg.main``: 5 FedAvg rounds of the
   62-class FEMNIST CNN on femnist_gen (10 clients a round, batch 20, lr
   0.1), checks that the kernel launched once per round and that the test
   loss fell, then times further rounds;
4. runs one logistic-regression round on the card and on the CPU from the
   same weights (TF32 off) and compares the parameters;
4a. drives the same path through ``main_fedavg.main --fused_rounds 5``
   (10 rounds, each a replay of a captured CUDA graph of the round with
   the aggregation kernel inside), checks the kernel's launches (one a
   round, plus a warm-up and a capture launch a graph) and that the test
   loss fell; runs the same cohorts through the host loop and a fused
   block with shuffle and dropout on (cuDNN deterministic) and bounds the
   difference by 1e-6; then times the host loop and fused blocks (median
   and spread of three runs of 5 rounds), profiles each (device ms and
   launch calls of a host round, its CUDA activity alone, and a 2-round
   fused block; the profiler must see one aggregation kernel a fused
   round, as the driver counts)
   and prints each graph's capture time and memory pool;
4b. the same in bf16 off f32 masters (the JAX headline's
   ``bench_fedavg_cnn_fused_headline``; one timed run each way), and one
   bf16 round against an f32 round from the same weights;
4c. device-sampled fused rounds (cohorts and batch orders drawn on the
   card): distinct cohorts without replacement, and the test loss falls;
5. holds the three flash-attention kernels (forward, dK/dV, dQ) against
   their plain versions on the card, at the LM path's shape [4, 2048, 4,
   64] f32 causal and at edge shapes (D = 128 at S = 2048, a ragged S,
   bf16 at the path's shape, rows that take the kernels' scalar copy
   path), and times kernels, plain versions and
   scaled_dot_product_attention (the library yardstick only: its forward
   for the forward kernel, its backward alone for the backward pair);
6. drives the LM path through ``FedAvgAPI``: 3 FedAvg nwp rounds of the
   full-width TransformerLM (vocab 1024, width 256, depth 4, 4 heads, S =
   2048) with ``make_flash_attention(128, 128)`` on a token federation (4
   clients a round, batch 4, SGD lr 0.3, evaluation at rounds 0 and 2),
   checks every kernel's launch count against the schedule and that the
   test loss fell, then times rounds and the centralized train step with
   the kernels and with SDPA as ``attn_fn``;
7. runs one small transformer round on the card and on the CPU from the
   same weights (TF32 off) and compares the parameters;
7a. runs 2 rounds of the full-width LM in bf16 (the flash kernels' bf16
   instances; launches 12 a step), times 3 more, and one small bf16
   transformer round on the card and on the CPU;
8. holds the int8 quantize kernel (also with its residual output, top-k's
   error-feedback residual in the same launch) and the dequantize kernel
   (also with a minuend) against their plain versions on the card, bit for
   bit, at the CNN's D = 1,206,590, at the top-k survivors' k = 60,330 and
   at edge shapes (D in {1, 511, 512, 513, 2570}, an all-zero block,
   values spanning 1e-30..1e30, random bits with the top bit set, NaN and
   infinite blocks, misaligned views at D and k for the scalar paths),
   checks that torch.mul on the zero-padded [rows, 512] layout gives the
   dequantize's bits, and times kernels, plain versions, that library
   call, an int8 -> f32 copy_ and an empty kernel (the floor of one CUDA
   graph node) at D and k;
9. drives the cross-silo path through ``main_fedavg.main --backend
   inproc``: 2 rounds of ``--compression none``, then 5 rounds each of
   ``delta_int8`` and ``topk_ef_int8:0.05`` of the FEMNIST CNN over 10
   silos, checks both kernels' launch counts against the schedule (54 / 94
   under each: a top-k encode is one quantize launch), that the
   test loss fell, and the uplink frames' array bytes, and prints rounds/s,
   the codec and fold times and the wire bytes a round against ``none``;
10. runs one cross-silo LR round on the card and on the CPU from the same
   weights (TF32 off) under ``none`` and ``topk_ef`` (no random bits) and
   compares the parameters;
11. drives FedOpt with a server Adam on the CNN through
   ``fedml_tpu_torch.experiments.fed_launch.main --algo fedopt``, 10 rounds
   through the host loop and 10 with ``--fused_rounds 5`` (the server step
   inside the captured round), checks the aggregation launches (one a
   round, one more a capture's warm-up round) and that the test loss fell,
   holds a fused block to the host loop (params and Adam state, 1e-6,
   cuDNN deterministic) and a round of server SGD at lr 1 to FedAvg's
   (1e-6), then times both as in 4b;
12. runs the rest of the slice through ``fed_launch.main`` for 2-3 rounds:
   ``fedavg_robust`` on the CNN under every defense (and a fused block
   under ``weak_dp`` against its host loop), ``fednova``, ``hierarchical``
   and ``turboaggregate`` on the CNN, ``centralized``, ``decentralized``
   and ``contribution`` on LR, checking finite metrics, each one's
   aggregation launches and a falling loss where the JAX tests assert one;
13. runs one LR round of FedOpt, FedNova and robust median on the card and
   on the CPU from the same weights (TF32 off) and compares the parameters
   and server state;
14. holds the aggregation kernel against its plain version at the
   cross-device anchors' D (ResNet-18-GN 11,220,132, ResNet-56 600,314
   with its BN statistics, the StackOverflow LSTM 4,050,748, the char LSTM
   820,522; 10 clients) and times it beside the plain version and
   torch.mv;
15. drives ResNet-18-GN (full width) on fed_cifar100_gen through
   ``main_fedavg.main``: 3 host-loop rounds and 3 in fused blocks of 2
   (500 clients, 10 a round, batch 20, lr 0.1), one aggregation launch a
   round (one more a capture's warm-up), a falling test loss; a fused
   block against the host loop (1e-6, cuDNN deterministic); rounds/s of
   both (median and spread of 3 runs), device ms, busy share, each
   graph's capture time and pool;
16. the same for ResNet-56 with its BatchNorm statistics on img_blob, 2
   rounds each way (the statistics move over the rounds, the fused block
   equals the host loop in params and statistics, rounds/s of one run of
   a one-round block), and FedOpt-adam on it through ``fed_launch.main``,
   whose statistics stay at FedAvg's plain average after a round (1e-6)
   while its params move;
17. drives the char LSTM on shakespeare_gen (715 clients) and the
   StackOverflow LSTM on stackoverflow_nwp_gen (cut to 20,000 clients,
   widths full) through ``main_fedavg.main`` for 2 rounds each (10
   clients a round, batch 10): one launch a round, finite metrics, a
   falling test loss; counts each one's launches a train step and the
   gated steps of a fused round (the size of its graph), times the
   Shakespeare host loop (it is not captured), and holds a fused block of
   the StackOverflow LSTM to its host loop (1e-6) with rounds/s as in 16;
18. runs one round of each new model at a cut size on the card and on the
   CPU from the same weights (TF32 off) and compares the params and BN
   statistics (atol 1e-4), beside the CPU round's drift from a 1e-7
   relative perturbation of its params;
19. holds the aggregation kernel against its plain version at the rest of
   the zoo's D (MobileNet 3,331,364, MobileNetV3-LARGE 4,353,018, VGG-11
   28,144,010 / 28,512,740 at 10 / 100 classes and 28,119,428 on
   img_blob, EfficientNet-b0 4,177,664, SegNet 196,067; each checked
   against its model's state dict) and times it beside the plain version
   and torch.mv at 10 clients;
20. drives the slice's main path, MobileNet v1 (width 1.0, 100 classes)
   on fed_cifar100_gen through ``main_fedavg.main --model mobilenet``
   with phase 15's flags: 3 host-loop rounds and 3 in fused blocks of 2,
   one aggregation launch a round (one more a capture's warm-up), finite
   metrics (a BN model's test loss rises over its first rounds: it is
   printed, not required to fall), the BN statistics moving, a fused
   block against the host loop (params and statistics, 1e-6, cuDNN
   deterministic, timed), rounds/s of both (median and spread of 3 runs
   of a round), device ms, busy share, launch calls, each graph's capture
   time and pool;
21. the same for MobileNetV3-LARGE and EfficientNet-b0 (fed_cifar100_gen)
   and VGG-11 (img_blob's 32x32 images: it needs 32x32), 2 host rounds
   and a fused block of 2 each, one timed round each way (the host and
   the fused round's wall, a replay's device ms by CUDA events, a train
   step's launch calls),
   EfficientNet's fused block against its host loop with drop-connect and
   dropout on (1e-6); then hierarchical FedAvg and TurboAggregate, 2
   rounds each on MobileNet through ``fed_launch.main``, with their
   launches;
22. drives FedSeg, SegNet (width 32) on seg_shapes through
   ``fed_launch.main --algo fedseg`` under ``ce`` and ``focal``, 3 rounds
   each: one launch a round, finite test mIoU, FWIoU and class accuracy,
   a falling test loss; then one cut round of each zoo model on the card
   and on the CPU from the same weights (TF32 off), params and BN
   statistics against atol 1e-4 beside the CPU round's own drift;
23. drives vertical FL (a guest and two hosts on blob, 2 epochs) and split
   learning (blob, 2 rotations) through ``fed_launch.main``: finite
   metrics, a falling train loss, no aggregation launch;
24. drives FedGKT through ``fed_launch.main --algo fedgkt`` on
   fed_cifar100_gen (10 clients, batch 20) with the full-width resnet8_56
   client and 18-block resnet56_server, 2 rounds: distillation on in
   round 1, client weights that differ between clients, finite test
   accuracy and loss; prints each round's wall and the launch calls of
   one server and one client train step;
25. drives FedNAS through ``fed_launch.main --algo fednas`` on the same
   federation (the search network C 8, 2 cells): 2 rounds of darts and 1
   of gdas at batch 40, 1 with ``--arch_unrolled`` and
   ``--nas_retrain_rounds 1`` at batch 80 (one step a client); the
   aggregation launches equal the rounds (search and retrain: weights, BN
   statistics and both alphas in one launch a round), the alphas move,
   the genotype prints; the kernel against its plain version at FedNAS's
   D = 215,468 (checked against the state dict plus the alphas), timed
   beside the plain version and torch.mv; the launch calls of a darts
   search step;
26. runs one cut round of each of the four (FedNAS under darts, gdas and
   ``--arch_unrolled``, FedGKT two rounds) on the card and on the CPU
   from the same weights and
   orders (TF32 off): params, BN statistics and alphas against atol 1e-4
   beside the CPU round's own drift. Phases 23-26 print their time;
27. drives the cross-silo federation of the FEMNIST CNN (10 silos, batch
   20, lr 0.1, cuDNN deterministic) across real transports: 3 rounds of
   ``delta_int8`` through ``main_fedavg.main --backend tcp`` (the CLI's
   ports 29500 + rank) and ``--backend inproc``, 2 rounds of
   ``topk_ef_int8:0.05`` over ROUTED (the port's broker built from
   ``fedml_tpu_torch/native/router.cpp``, with a token; a wrong token is
   refused) and inproc through the API, and 1 round of ``none`` over MQTT
   (3 silos, JSON frames) and inproc: each transport ends on inproc's
   model bit for bit, the int8 launches equal the schedule, and it prints
   rounds/s and the wire bytes a round beside inproc's with the card's
   name and power limit; then the FedOpt-adam server over TCP (3 rounds,
   server lr 0.003, the test loss falls) and server SGD at lr 1 against
   FedAvg (1e-6); resume: 2 + 2 rounds (the second half over TCP) against
   4 uninterrupted, bit for bit in the server's model and every silo's
   residual (uplink top-k + int8, downlink full precision), and the
   simulation's ``--checkpoint_dir`` / ``--resume`` checkpoints; the
   buffered close with the aggregation kernel's front end as
   ``aggregate_fn``, one launch a round, each round within 1e-6 of the
   streaming fold of the same reports. gRPC is not driven here (it is
   held on the CPU, where grpcio is installed);
28. runs one cross-silo LR round over TCP with the FedOpt-adam server on
   the card and on the CPU from the same weights (TF32 off): params and
   Adam state within 1e-5, beside the CPU round's drift under a 1e-7
   relative perturbation. Phases 27-28 print their time;
29. observability (the flight recorder, the FLOP counter, MFU): the CNN
   main path through FedAvgAPI's host loop for 3 rounds with obs off and
   3 with ``obs_dir`` set (same seed, cuDNN deterministic), the variables
   bit for bit equal; ``flight_rank0.jsonl`` holds round records 0-2 with
   their cohorts and one dispatch each and a perf record a round whose
   ``peak_flops`` is the card's (989.4e12 on an H100 80GB HBM3), ``0 <
   mfu < 1`` and ``round_flops`` equal to the analytic count of the same
   round on the CPU; the anomaly profiler armed for round 2, its trace
   naming the aggregation kernel once and the launches one a round; the
   CNN federation over TCP for 2 rounds of ``delta_int8`` with obs on
   against obs off (bit for bit, int8 launches as the schedule implies),
   a flight log a rank, a ``silo`` row a silo a round, ``obs merge``
   exiting 0; the fused block's ``cost_analysis`` over 2 rounds beside
   the host round's count (the padding-only steps' share). It prints
   each round's mfu and round_flops and the phase's time;
30. fault tolerance (deadline rounds with eviction, heartbeats and JOIN,
   the fault plan, the quorum and FedAsync servers): (a) the CNN over 10
   in-process silos with ``delta_int8``, the buffered close through the
   aggregation kernel, a deadline of 5x the measured round wall and
   heartbeats at half of it; a seeded ``drop`` plan takes two silos'
   round-1 replies, so round 1 closes at the deadline over 8 reports (one
   kernel launch at C = 8), both silos are evicted and come back by JOIN
   with a full-precision resync. The counts are set to 0 just before and
   read just after: one aggregation launch a round at C = each round's
   reporters, the int8 launches as the recorded broadcasts and replies
   imply, each close within 1e-6 of the streaming fold, and every silo's
   held model (the rejoined ones too) the server's mirror bit for bit at
   FINISH. The same plan on the CNN (TF32 off, no heartbeats, so the
   schedule is fixed, and no compression, whose stochastic rounding draws
   from a generator on the device), 3 rounds of one full-batch step a
   silo at lr 0.01 on the card (cuDNN's deterministic algorithms) and on
   the CPU: the same rounds, the final models within 1e-5. (b)
   ``fed_launch --algo fedavg_async --async_mode quorum --quorum 7`` on
   the CNN with three round-1 replies dropped: ``partial_rounds`` [1].
   (c) ``--async_mode fedasync``: 1 LR silo, 5 updates, card vs CPU
   within 1e-5; then 4 CNN silos, ``update_log`` of ``max_updates``
   entries, each mix ``alpha * (s + 1) ** -poly_a``. It prints the phase's
   time;
31. the WAN world (``fedml_tpu_torch/wan``): one deadline federation of
   the CNN over 4 in-process silos with ``delta_int8`` and the buffered
   close through the aggregation kernel, the deadline sized from a warm
   round as in phase 30a, under ``WAN_TRACE`` and ``WAN_PROFILES``
   (designed with ``python -m fedml_tpu_torch.wan curve`` at 200 clients
   and 4 silos: a flap takes 2 silos' devices off in rounds 1-2, they
   come back in rounds 3 and 4, the lower half of the day takes one off
   in round 6, never fewer than 2 online). The counts are set to 0 just
   before and read just after. The whole schedule closes; evictions,
   rejoins and partial rounds are each >= 1 and no cohort is forced;
   every round's cohort is trace-available at its sim time and its
   reporters are trace-online silos; each close's kernel output is
   within 1e-6 of the streaming fold; one aggregation launch a close and
   the int8 launches as the recorded broadcasts, decodes and replies
   imply; and the first broadcast a silo applies after its device was
   dark is full precision. It prints the phase's time;
32. the control plane (``fedml_tpu_torch/control``): the CNN's deadline
   federation over 4 in-process silos through the failover harness
   (``run_simulated_failover``), ``delta_int8`` on the uplink only, pace
   steering from a base deadline of 12x a warm round's wall, the async
   snapshot writer with group commit, the buffered close through the
   aggregation kernel, cuDNN deterministic; two legs of 6 rounds: an
   unkilled one, and one whose server dies before its round-3 broadcast
   (its writer killed mid-write) while a fresh server on the same router
   restores the newest snapshot and finishes. The counts are set to 0
   just before each leg and read just after: ``cp_restores`` 1 on the
   restored server, the two legs' ledger schedules and reporters equal,
   the final models bit for bit; one aggregation launch a close (the
   restored server's closes included, each within 1e-6 of the streaming
   fold) and one ledger line a close, a quantize launch a reply and a
   dequantize launch a decode. It prints ``cp_capture_ms``,
   ``cp_flush_ms``, ``cp_fsync_total``, the steered deadlines and the
   phase's time;
33. multi-job tenancy (``fedml_tpu_torch/sched``): ``launch_jobs`` over one
   in-process ``SharedFabric`` and one ``RoundInterleaver`` (cuDNN
   deterministic) with two jobs: ``cnn``, the full-width 62-class FEMNIST
   CNN on femnist_gen over 4 silos, 3 rounds, batch 20, lr 0.1,
   ``delta_int8``, share 2; and ``lr``, the LR on blob over 3 silos, 4
   deadline rounds (2.0 s, heartbeats 0.3 s), ``topk_ef_int8:0.1``, share
   1. Each runs alone through the scheduler, then both together. The
   counts are set to 0 just before each leg and read just after: each
   job's ledger, history and final model in the shared leg are its solo
   leg's bit for bit, the shared leg's int8 launches are the sum of the
   solo legs' (the CNN's as its schedule implies), both jobs held the
   device for a time > 0, and ``obs report`` on the shared obs dir gives
   one summary a job. It prints the fairness ratio, each tenant's
   ``sched_device_time`` and ``sched_gate_wait`` and the phase's time;
34. tenancy failover (``run_tenancy_failover``): the ``cnn`` job survives
   while the ``lr`` job is the victim, its silos on the card in this
   process behind the shared interleaver, its server a ``python -m
   fedml_tpu_torch.sched serve --device cuda`` subprocess, SIGKILLed after
   round 2 and started again. The survivor is bit for bit its solo leg,
   the victim restores (``cp_restores >= 1``) and finishes its 4 rounds;
   the in-process int8 launches are counted over the phase. It prints each
   server incarnation's time from spawn to its first closed round and the
   phase's time.

Any failure raises, and the script exits non-zero without printing a
result. Before the last line it prints one ``{"kernels": [...]}`` JSON
line; the last line is ``{"ok": true, "device": {...}}``. The full record
goes to runs/chip_smoke/record.json, beside the main path's metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
# one H100 SXM (NVIDIA's data sheet): HBM bytes/s, f32 (non-tensor-core)
# FLOP/s and dense TF32 tensor-core FLOP/s; f32-accurate 3xTF32 takes
# three TF32 products for each f32 one
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
TOL = dict(rtol=1e-5, atol=1e-6)
HEADLINE = (10, 1_206_590)  # clients per round x CNN parameters
LM_SHAPE = (4, 2048, 4, 64)  # B, S, H, D of the LM path's attention
LM = dict(vocab_size=1024, width=256, depth=4, num_heads=4, max_len=2048)
LM_LR = 0.3
FLASH_TOL = dict(rtol=1e-4, atol=1e-4)  # f32; bf16 takes 2e-2
SILO_K = 60_330  # top-k survivors of the CNN's delta at keep-fraction 0.05
# the main path's flags (FEMNIST CNN, 200 clients, 10 a round, batch 20)
MAIN_CLIENTS = 200
MAIN_FLAGS = ["--dataset", "femnist_gen", "--client_num_in_total",
              str(MAIN_CLIENTS), "--client_num_per_round", "10",
              "--batch_size", "20", "--epochs", "1", "--lr", "0.1",
              "--device", "cuda"]
FUSED_R = 5  # rounds a fused dispatch
# rounds of a profiled fused block on the CNN paths (4a-4b, 11): the
# whole script's time limit takes fewer than FUSED_R
PROFILED_R = 2
# FedOpt's server Adam step (Reddi et al., 2021, tune it near 1e-2.5 for
# the EMNIST CNN)
FEDOPT_LR = 0.003
# server SGD at lr 1 against FedAvg after one CNN round: w - 1.0 * (w -
# avg) is avg within an ulp of w (3.7e-9 on the card and in a CPU run at a
# cut size; a second round's max pools can route a gradient elsewhere on
# such a difference: 3.5e-4 in that CPU run)
FEDOPT_SGD_TOL = 1e-6
ROBUST_DEFENSES = ("none", "norm_diff_clipping", "weak_dp", "median",
                   "trimmed_mean", "krum")
SLICE_ROUNDS = 3  # rounds of each phase-12 run on the CNN
# bf16 against f32 after one main-path round: its relative L2 distance may
# be at most this multiple of an f32 round's from weights perturbed by
# 2**-9 (a round of ~17 SGD steps at lr 0.1 moves a bf16-sized error
# across ReLU and dropout boundaries: both land ~4% apart in a CPU run)
BF16_VS_F32_FACTOR = 2.0
# ... and at least this multiple of it: a round that ignored compute_dtype
# would land next to the f32 round (the card measured 0.375 of it, 0.0081
# against 0.0216; an f32 round differs from itself only by cuDNN's
# nondeterministic sums)
BF16_VS_F32_MIN_FACTOR = 0.125
# a bf16 transformer round, card against CPU: cuBLAS's and the CPU's bf16
# products round at other places, as the port and XLA do on the CPU
# (tests/test_torch_mixed_precision.py, LM: rtol 1e-2, atol 1e-3, there
# measured 1.4e-4), with twice the room for the flash kernels' bf16 path
LM_BF16_TOL = dict(rtol=2e-2, atol=2e-3)
# the cross-device anchors (phases 14-18): the aggregation kernel's D on
# their paths (ResNet-56: 591,322 params + 8,992 BN statistics at 10
# classes; the char LSTM: 820,522)
ANCHOR_D = {"resnet18_gn": 11_220_132, "resnet56": 600_314,
            "rnn_stackoverflow": 4_050_748, "rnn_seq": 820_522}
ANCHOR_R = 2  # rounds a fused dispatch on the anchors' paths
# ResNet-18-GN on fed_cifar100_gen at the JAX bench's round shape
R18_FLAGS = ["--dataset", "fed_cifar100_gen", "--client_num_in_total", "500",
             "--client_num_per_round", "10", "--batch_size", "20",
             "--epochs", "1", "--lr", "0.1", "--eval_train_subsample",
             "1000", "--device", "cuda"]
# ResNet-56 (BatchNorm) on img_blob: 20 clients of 32 32x32 images
IMG_FLAGS = ["--dataset", "img_blob", "--client_num_in_total", "20",
             "--client_num_per_round", "10", "--batch_size", "10",
             "--epochs", "1", "--lr", "0.05", "--device", "cuda"]
# the LSTMs at full width; the StackOverflow federation cut from 342,477
# clients (~6.9M sequences on the host) to SO_CLIENTS
SO_CLIENTS = 20_000
SH_FLAGS = ["--dataset", "shakespeare_gen", "--client_num_in_total", "715",
            "--client_num_per_round", "10", "--batch_size", "10",
            "--epochs", "1", "--lr", "1.0", "--eval_train_subsample",
            "1000", "--device", "cuda"]
SO_FLAGS = ["--dataset", "stackoverflow_nwp_gen", "--client_num_in_total",
            str(SO_CLIENTS), "--client_num_per_round", "10",
            "--batch_size", "10", "--epochs", "1", "--lr", "0.3",
            "--eval_train_subsample", "1000", "--device", "cuda"]
# one round of a cut anchor model, card against CPU, TF32 off: params and
# BN statistics (the transformer round's bound, phase 7)
ANCHOR_CPU_ATOL = 1e-4
# the rest of the zoo (phases 19-22): the aggregation kernel's D, params
# and BN statistics, at 100 classes (VGG-11 also at 10, and at img_blob's
# 4 on its path; SegNet at width 32 and 3 classes)
ZOO_D = {"mobilenet": 3_331_364, "mobilenet_v3": 4_353_018,
         "vgg11_10": 28_144_010, "vgg11": 28_512_740,
         "vgg11_img_blob": 28_119_428, "efficientnet-b0": 4_177_664,
         "segnet": 196_067}
ZOO_R = 2  # rounds a fused dispatch on the zoo's paths
# the zoo's BatchNorm models evaluate with the running statistics, which
# start at (0, 1) and move toward the clients' averaged batch statistics:
# over the first rounds their test loss rises from ln(classes) on
# fed_cifar100_gen (at lr 0.1, 0.03 and 0.01 alike) and on img_blob, as
# the JAX package's rounds do (the port's are held to them), so phases
# 20-21 require finite metrics and moving statistics, and print the loss
# VGG-11 needs inputs of at least 32x32 (five 2x2 pools): fed_cifar100's
# 24x24 crops are too small, so it runs on img_blob's 32x32 images (4
# classes), ResNet-56's path (phase 16)
ZOO_FLAGS = {"mobilenet": R18_FLAGS + ["--model", "mobilenet"],
             "mobilenet_v3": R18_FLAGS + ["--model", "mobilenet_v3"],
             "vgg11": IMG_FLAGS + ["--model", "vgg11"],
             "efficientnet-b0": R18_FLAGS + ["--model", "efficientnet-b0"]}
# FedSeg: SegNet (width 32) on seg_shapes, 10 clients of 16 32x32 images
SEG_FLAGS = ["--algo", "fedseg", "--dataset", "seg_shapes",
             "--client_num_in_total", "10", "--client_num_per_round", "5",
             "--batch_size", "8", "--epochs", "1", "--lr", "0.1",
             "--device", "cuda"]


# FedGKT and FedNAS (phases 24-25) on fed_cifar100_gen: 10 clients of 80
# 24x24 images, 100 classes, batch 20 (FedGKT) and 40 (FedNAS: 2 search
# steps a client, each ~22k launch calls; at batch 20, 4 steps took 21-26
# s a round on the card, past the phases' time); FedNAS's aggregated D is
# the search
# network's (C 8, 2 cells) 203,484 params and 11,760 BN statistics plus
# both alphas' 2 x 14 x 8
GKT_FLAGS = ["--dataset", "fed_cifar100_gen", "--client_num_in_total", "10",
             "--batch_size", "20", "--device", "cuda"]
NAS_FLAGS = ["--dataset", "fed_cifar100_gen", "--client_num_in_total", "10",
             "--client_num_per_round", "10", "--lr", "0.025", "--device",
             "cuda"]
NAS_D = 215_468


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T0:7.1f}s] {msg}",
          flush=True)


def cuda_time_ms(fn, args_list, iters: int) -> float:
    """Device ms per call: ``iters`` calls cycling through ``args_list``
    (distinct buffers, larger than L2 together) are captured in one CUDA
    graph, so the host's launch overhead is out of the time, then replayed
    once to warm up and once between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # eager warm-up, off the capture
        for a in args_list:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_time_eager_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` run eagerly ``iters`` times between
    CUDA events after one warm-up call (for calls that a CUDA graph cannot
    capture, such as autograd through a library operator; each call takes
    milliseconds, so the host's launch time is a small part of it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device_and_build():
    import torch
    from fedml_tpu_torch.ops import aggregate, flash_attention, quantize
    from fedml_tpu_torch.ops.build import load_library

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    t = time.perf_counter()
    # one nvcc per source, all started together (each waits in its thread)
    with ThreadPoolExecutor() as pool:
        libs = list(pool.map(load_library, ["aggregate", "flash_attention",
                                            "quantize"]))
    aggregate._kernel()
    flash_attention._kernel()
    quantize._kernel()
    log(f"built {[lib.path for lib in libs]} in "
        f"{time.perf_counter() - t:.1f}s (in parallel)")
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "ptxas" in line:
                print(line, flush=True)
    flash_report = _flash_kernel_report(libs[1])
    tf32 = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision":
                torch.get_float32_matmul_precision()}
    log(f"TF32 settings for the run: {tf32}")
    return {"smi": smi, "tf32": tf32, "flash_kernels": flash_report}


_FLASH_FN = (r"(flash_(?:fwd|bwd_dkdv|bwd_dq)_kernel)I(\w+?)Li(\d+)E")


def _flash_label(m) -> str:
    """``flash_bwd_dq_kernel<f32,64>`` from a match of ``_FLASH_FN``."""
    dtype = "bf16" if "bfloat16" in m.group(2) else "f32"
    return f"{m.group(1)}<{dtype},{m.group(3)}>"


def _flash_kernel_report(lib):
    """Registers and spill bytes of every flash kernel instance (from the
    build's -Xptxas -v lines, when this process built the library) and its
    count of tensor-core instructions (HMMA/HGMMA in cuobjdump -sass, where
    the toolkit has cuobjdump). Raises if an instance has none."""
    import re
    report, fn = {}, None
    for line in lib.build_log.splitlines():
        m = re.search(_FLASH_FN, line)
        if "Compiling entry function" in line:
            fn = _flash_label(m) if m else None
            if fn:
                report[fn] = {}
        elif fn:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                report[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[fn]["registers"] = int(m.group(1))
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(cuobjdump):
        log("cuobjdump not found: tensor-core instructions not counted")
        return report
    sass = subprocess.run([cuobjdump, "-sass", lib.path], capture_output=True,
                          text=True, check=True).stdout
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(_FLASH_FN, line)
            fn = _flash_label(m) if m else None
            if fn:
                report.setdefault(fn, {})["tensor_core_instructions"] = 0
        elif fn and re.search(r"\bHG?MMA\b", line):
            report[fn]["tensor_core_instructions"] += 1
    for fn in sorted(report):
        log(f"{fn}: {report[fn]}")
        if report[fn].get("tensor_core_instructions") == 0:
            raise AssertionError(f"{fn} has no tensor-core instruction")
    return report


def phase_kernel_vs_plain():
    import torch
    from fedml_tpu_torch.ops.aggregate import (takes_vec4_path,
                                               weighted_mean_flat,
                                               weighted_mean_flat_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def stack(c, d, row_padded):
        ld = -(-d // 4) * 4 if row_padded else d
        buf = torch.randn(c, ld, generator=gen, device=dev)
        w = torch.randint(20, 401, (c,), generator=gen, device=dev).float()
        return buf[:, :d], w

    cases = [("headline", *HEADLINE, True, True),
             ("one_client", 1, HEADLINE[1], True, True),
             ("fifty_clients", 50, HEADLINE[1], True, True),
             ("ragged_contiguous", 7, 1_000_003, False, False)]
    checks, max_abs = [], 0.0
    for name, c, d, row_padded, vec4 in cases:
        x, w = stack(c, d, row_padded)
        got = weighted_mean_flat(x, w)
        torch.cuda.synchronize()
        want = weighted_mean_flat_reference(x, w)
        err = (got - want).abs()
        abs_err = float(err.max())
        rel_err = float((err / want.abs().clamp(min=1e-30)).max())
        if not torch.allclose(got, want, **TOL):
            raise AssertionError(f"{name} [{c}, {d}]: kernel disagrees with "
                                 f"the plain version (max abs {abs_err})")
        if takes_vec4_path(x, got) != vec4:
            raise AssertionError(f"{name}: expected the "
                                 f"{'16-byte' if vec4 else 'scalar'} path")
        max_abs = max(max_abs, abs_err)
        checks.append({"case": name, "shape": [c, d], "vec4": vec4,
                       "max_abs_err": abs_err, "max_rel_err": rel_err})
        log(f"kernel == plain at {name} [{c}, {d}]: max abs {abs_err:.3g}, "
            f"max rel {rel_err:.3g}")

    # timing at the main path's shape and layout: four distinct stacks
    # (193 MB, beyond the 50 MB L2), as a round finds its stack cold. Each
    # timed call is the whole function from (stack, sample counts): the
    # wrapper's weight normalization (two tiny kernels) is in its time, and
    # in the plain version's and the library call's
    timing = _wmean_timed(*HEADLINE, gen, 4, 200)
    return {"checks": checks, "max_abs_err": max_abs,
            **{k: timing[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "bytes")}}


def phase_main_path():
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.experiments import main_fedavg
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.ops.aggregate import flatten_stack
    from fedml_tpu_torch.utils.metrics import read_metrics

    rounds = 5
    flags = MAIN_FLAGS + ["--comm_round", str(rounds),
                          "--frequency_of_the_test", "4"]
    run_dir = os.path.join(ROOT, "runs", "chip_smoke")
    shutil.rmtree(run_dir, ignore_errors=True)

    aggregate.weighted_mean_flat.launches = 0
    t = time.perf_counter()
    main_fedavg.main(flags + ["--run_dir", run_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = aggregate.weighted_mean_flat.launches

    if launches != rounds:
        raise AssertionError(f"aggregation kernel launched {launches} times "
                             f"in {rounds} rounds")
    recs = read_metrics(run_dir)
    for r in recs:
        for k in ("train_loss", "test_loss", "train_acc", "test_acc"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"round {r['round']}: {k}={r[k]}")
    if [r["round"] for r in recs] != [0, 4]:
        raise AssertionError(f"eval rounds {[r['round'] for r in recs]}")
    if not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"test loss did not fall: {recs[0]['test_loss']}"
                             f" -> {recs[-1]['test_loss']}")
    log(f"main path: {rounds} rounds, {launches} kernel launches, test loss "
        f"{recs[0]['test_loss']:.4f} -> {recs[-1]['test_loss']:.4f}, acc "
        f"{recs[0]['test_acc']:.4f} -> {recs[-1]['test_acc']:.4f} "
        f"(wall {wall:.1f}s with data build and eval)")

    # rounds/s on the same configuration, through the same API
    args = main_fedavg.add_federated_args(
        argparse.ArgumentParser()).parse_args(flags)
    ds, model, task = main_fedavg.build_dataset_and_model(args)
    api = FedAvgAPI(ds, model, task=task, device="cuda", config=FedAvgConfig(
        comm_round=12, client_num_per_round=10, frequency_of_the_test=100,
        train=main_fedavg.make_train_config(args)))
    api.run_round(0)
    api.run_round(1)
    torch.cuda.synchronize()
    timed = 10
    t = time.perf_counter()
    for r in range(2, 2 + timed):
        api.run_round(r)
    torch.cuda.synchronize()
    rps = timed / (time.perf_counter() - t)
    phases = {k: v * 1e3 for k, v in api.timer.means().items()}
    name = torch.cuda.get_device_name(0)
    log(f"{rps:.3f} rounds/s on {name} (FEMNIST CNN, 10 clients x batch 20, "
        f"host loop over clients); phase means ms {phases}")

    # the front end's flatten copy of one round's stacked state dicts
    stacked = {k: torch.stack([v] * 10) for k, v in api.variables.items()}
    flatten_ms = cuda_time_ms(flatten_stack, [(stacked,)], 200)
    log(f"front-end flatten of [10, {sum(v.numel() for v in api.variables.values())}]:"
        f" {flatten_ms:.4f} ms")
    return {"launches": launches, "evals": recs, "wall_s": wall,
            "rounds_per_s": rps, "phase_ms": phases,
            "flatten_ms": flatten_ms}


def phase_card_vs_cpu():
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.data.synthetic import make_blob_federated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.functional import TrainConfig

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ds = make_blob_federated(client_num=8, seed=0)
        cfg = FedAvgConfig(comm_round=1, client_num_per_round=4,
                           prefetch_depth=0,
                           train=TrainConfig(epochs=2, batch_size=16, lr=0.1,
                                             shuffle=False))
        apis = [FedAvgAPI(ds, create_model("lr", ds.class_num,
                                           input_shape=(20,)),
                          config=cfg, device=d) for d in ("cuda", "cpu")]
        for k in apis[1].variables:
            if not torch.equal(apis[0].variables[k].cpu(),
                               apis[1].variables[k]):
                raise AssertionError(f"initial {k} differs across devices")
        for api in apis:
            api.run_round(0)
        diff = max(float((apis[0].variables[k].cpu()
                          - apis[1].variables[k]).abs().max())
                   for k in apis[1].variables)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    if not diff <= 1e-5:
        raise AssertionError(f"LR round card vs CPU: max abs diff {diff}")
    log(f"LR round, card vs CPU: max abs param diff {diff:.3g} (atol 1e-5)")
    return {"max_abs_diff": diff}


def _flash_work(b, s, h, d, causal, elem_bytes=4):
    """(FLOP, bytes) of each flash kernel on these inputs: FLOP of the
    [S,S]xD products over the (query, key) pairs the causal mask leaves
    visible (all S*S without it), bytes of each input read once and each
    output written once."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    tensor = b * s * h * d * elem_bytes
    rows = b * h * s * 4  # one f32 per row: lse, delta
    return {"fwd": (2 * 2 * d * pairs, 4 * tensor + rows),
            "dkdv": (4 * 2 * d * pairs, 6 * tensor + 2 * rows),
            "dq": (3 * 2 * d * pairs, 5 * tensor + 2 * rows)}


def _bounds(flops, nbytes):
    """The least time at each rate: f32 on CUDA cores, f32-accurate 3xTF32
    and one-pass TF32 on the tensor cores. ``bound_ms`` is the 3xTF32 one,
    the fastest route to f32 accuracy on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_3x = 3 * flops / TF32_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_3x),
            "bound_ms_f32": 1e3 * max(t_bytes, flops / F32_FLOP_PER_S),
            "bound_ms_3xtf32": 1e3 * max(t_bytes, t_3x),
            "bound_ms_tf32": 1e3 * max(t_bytes, flops / TF32_FLOP_PER_S),
            "bound_by": "bytes" if t_bytes >= t_3x else "operations"}


def phase_flash_vs_plain():
    import torch
    import torch.nn.functional as F
    from fedml_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def inputs(b, s, h, d, dtype=torch.float32, strided=False):
        if strided == "misaligned":  # one element into a buffer
            return [torch.randn(b * s * h * d + 1, generator=gen,
                                device=dev)[1:].view(b, s, h, d)
                    for _ in range(4)]
        if strided:  # q, k, v as views of one qkv projection
            qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=dev)
            q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, -1))
        else:
            q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                       for _ in range(3))
        do = torch.randn(b, s, h, d, generator=gen, device=dev)
        return [t.to(dtype) for t in (q, k, v, do)]

    def rel(got, want):
        err = (got.float() - want.float()).abs()
        return (float(err.max()),
                float((err / want.float().abs().clamp(min=1e-6)).max()))

    # path_shape is the path's own layout: q, k, v as views of one
    # [4, 2048, 768] qkv projection (row stride 3 * width)
    cases = [("path_shape", LM_SHAPE, True, torch.float32, True),
             ("not_causal", LM_SHAPE, False, torch.float32, False),
             ("s32_below_tile", (2, 32, 4, 64), True, torch.float32, False),
             ("d16_ragged_s48", (2, 48, 4, 16), True, torch.float32, False),
             ("d128", (2, 256, 4, 128), True, torch.float32, False),
             ("bf16", (2, 256, 4, 64), True, torch.bfloat16, False),
             ("contiguous", (2, 512, 4, 64), True, torch.float32, False),
             # the tensor-core backward's risky tilings
             ("d128_s2048", (2, 2048, 4, 128), True, torch.float32, False),
             ("ragged_s1000", (2, 1000, 4, 64), True, torch.float32, False),
             ("bf16_path_shape", LM_SHAPE, True, torch.bfloat16, True),
             ("scalar_copy_path", (2, 200, 4, 64), True, torch.float32,
              "misaligned")]
    # the largest errors of the f32 cases (the kernels' JSON entries) and
    # of the bf16 ones, which take their own tolerance
    checks = []
    max_abs = {dt: {"fwd": 0.0, "dkdv": 0.0, "dq": 0.0}
               for dt in (torch.float32, torch.bfloat16)}
    for name, shape, causal, dtype, strided in cases:
        q, k, v, do = inputs(*shape, dtype=dtype, strided=strided)
        if fa.takes_async_copies(q, k, v, do) != (strided != "misaligned"):
            raise AssertionError(f"{name}: expected the other copy path "
                                 f"of the kernels")
        out, lse = fa.flash_fwd(q, k, v, causal)
        want_out, want_lse = fa.fwd_reference(q, k, v, causal)
        delta = fa.attention_delta(want_out, do)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, want_lse, delta, causal)
        dq = fa.flash_bwd_dq(q, k, v, do, want_lse, delta, causal)
        want_dk, want_dv = fa.bwd_dkdv_reference(q, k, v, do, want_lse,
                                                 delta, causal)
        want_dq = fa.bwd_dq_reference(q, k, v, do, want_lse, delta, causal)
        torch.cuda.synchronize()
        tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
               else FLASH_TOL)
        errs = {}
        for what, kern, got, want in (
                ("out", "fwd", out, want_out), ("lse", "fwd", lse, want_lse),
                ("dk", "dkdv", dk, want_dk), ("dv", "dkdv", dv, want_dv),
                ("dq", "dq", dq, want_dq)):
            if got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"{name} {what}: {got.dtype} "
                                     f"{tuple(got.shape)} vs {want.dtype} "
                                     f"{tuple(want.shape)}")
            if not torch.allclose(got.float(), want.float(), **tol):
                raise AssertionError(f"{name} {what}: kernel disagrees with "
                                     f"the plain version {rel(got, want)}")
            errs[what] = rel(got, want)
            max_abs[dtype][kern] = max(max_abs[dtype][kern], errs[what][0])
        checks.append({"case": name, "shape": list(shape), "causal": causal,
                       "dtype": str(dtype), "strided": strided,
                       "max_abs_rel_err": errs})
        log(f"flash kernels == plain at {name} {list(shape)} "
            f"{str(dtype)[6:]}{' causal' if causal else ''}: "
            + ", ".join(f"{w} {a:.2g}/{r:.2g}" for w, (a, r) in errs.items()))

    # timing at the path's shape and layout (q, k, v views of one qkv
    # projection): two input sets, kernels and plain versions captured in
    # CUDA graphs; SDPA on the same values laid out [B, H, S, D]
    # (contiguous): its forward, its backward alone (the forward run once
    # outside the timed window) and forward + backward
    b, s, h, d = LM_SHAPE
    sets = []
    for _ in range(2):
        q, k, v, do = inputs(b, s, h, d, strided=True)
        out, lse = fa.fwd_reference(q, k, v, True)
        sets.append((q, k, v, do, lse, fa.attention_delta(out, do)))
    fwd_args = [st[:3] + (True,) for st in sets]
    bwd_args = [st[:3] + (st[3], st[4], st[5], True) for st in sets]
    iters = 20
    t = {"fwd": (cuda_time_ms(fa.flash_fwd, fwd_args, iters),
                 cuda_time_ms(fa.fwd_reference, fwd_args, iters)),
         "dkdv": (cuda_time_ms(fa.flash_bwd_dkdv, bwd_args, iters),
                  cuda_time_ms(fa.bwd_dkdv_reference, bwd_args, iters)),
         "dq": (cuda_time_ms(fa.flash_bwd_dq, bwd_args, iters),
                cuda_time_ms(fa.bwd_dq_reference, bwd_args, iters))}
    q, k, v, do = (x.transpose(1, 2).contiguous() for x in sets[0][:4])
    sdpa_fwd = cuda_time_ms(
        lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
        [(q, k, v)], iters)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        torch.autograd.grad(o, leaves, grad_outputs=do)
    sdpa_both = cuda_time_eager_ms(sdpa_fwd_bwd, iters)
    o = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_bwd = cuda_time_eager_ms(
        lambda: torch.autograd.grad(o, leaves, grad_outputs=do,
                                    retain_graph=True), iters)
    work = _flash_work(b, s, h, d, True)
    timing = {}
    for kern, (ms, plain_ms) in t.items():
        flops, nbytes = work[kern]
        timing[kern] = {"ms": ms, "plain_ms": plain_ms,
                        "library_ms": sdpa_fwd if kern == "fwd" else sdpa_bwd,
                        "library_fwd_bwd_ms": sdpa_both,
                        "flop": flops, "bytes": nbytes,
                        "tflops": flops / ms / 1e9,
                        **_bounds(flops, nbytes)}
        log(f"flash {kern} {list(LM_SHAPE)} f32 causal: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, SDPA {timing[kern]['library_ms']:.4f}"
            f" ms ({'fwd' if kern == 'fwd' else 'bwd alone'}), bound "
            f"{timing[kern]['bound_ms_f32']:.4f} ms f32 / "
            f"{timing[kern]['bound_ms_3xtf32']:.4f} ms 3xTF32 / "
            f"{timing[kern]['bound_ms_tf32']:.4f} ms TF32 "
            f"({flops / 1e9:.2f} GFLOP) -> {timing[kern]['tflops']:.1f} "
            f"TFLOP/s")
    log(f"flash forward {t['fwd'][0]:.4f} ms against SDPA's forward "
        f"{sdpa_fwd:.4f} ms ({t['fwd'][0] / sdpa_fwd:.3f}x)")
    pair = t["dkdv"][0] + t["dq"][0]
    log(f"flash backward pair (dK/dV + dQ) {pair:.4f} ms against SDPA's "
        f"backward alone {sdpa_bwd:.4f} ms ({pair / sdpa_bwd:.3f}x); SDPA "
        f"forward + backward {sdpa_both:.4f} ms")
    return {"checks": checks, "max_abs_err": max_abs[torch.float32],
            "max_abs_err_bf16": max_abs[torch.bfloat16], "timing": timing,
            "pair_ms": pair, "sdpa_bwd_ms": sdpa_bwd}


def _lm_launches(api, rounds, evals):
    """Launches of each flash kernel that the schedule implies: every real
    SGD step runs each kernel once per layer; every evaluation runs the
    forward once per layer per eval batch of the train and test unions."""
    from fedml_tpu_torch.core.sampling import sample_clients
    cfg = api.config
    bsz = cfg.train.batch_size
    depth = len(api.module.blocks)
    steps = sum(cfg.train.epochs
                * -(-api.dataset.train_data_local_num_dict[int(c)] // bsz)
                for r in range(rounds)
                for c in sample_clients(r, api.dataset.client_num,
                                        cfg.client_num_per_round))
    eval_batches = sum(-(-len(x) // 512) for x in (
        api.dataset.train_data_global[0], api.dataset.test_data_global[0]))
    fwd = depth * (steps + evals * eval_batches)
    return {"fwd": fwd, "dkdv": depth * steps, "dq": depth * steps,
            "steps": steps}


def phase_lm_path():
    import torch
    import torch.nn.functional as F
    from torch.func import functional_call

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.synthetic import make_token_federated
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.trainer.functional import TrainConfig

    t = time.perf_counter()
    ds = make_token_federated(client_num=8, vocab_size=1024, seq_len=2048,
                              sequences_per_client=8, seed=0)
    log(f"token federation built in {time.perf_counter() - t:.1f}s")
    rounds, per_round = 3, 4
    api = FedAvgAPI(ds, TransformerLM(**LM, attn_fn=fa.make_flash_attention(
        128, 128)), task="nwp", device="cuda", config=FedAvgConfig(
            comm_round=rounds, client_num_per_round=per_round,
            frequency_of_the_test=2,
            train=TrainConfig(epochs=1, batch_size=4, lr=LM_LR)))
    kernels = (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq,
               aggregate.weighted_mean_flat)
    for fn in kernels:
        fn.launches = 0
    t = time.perf_counter()
    api.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(zip(("fwd", "dkdv", "dq", "wmean"),
                        (fn.launches for fn in kernels)))

    want = _lm_launches(api, rounds, evals=2)
    for kern in ("fwd", "dkdv", "dq"):
        if launches[kern] != want[kern]:
            raise AssertionError(f"flash {kern} launched {launches[kern]} "
                                 f"times, the schedule implies {want[kern]}")
    if launches["wmean"] != rounds:
        raise AssertionError(f"aggregation kernel launched "
                             f"{launches['wmean']} times in {rounds} rounds")
    recs = api.history
    if [r["round"] for r in recs] != [0, 2]:
        raise AssertionError(f"eval rounds {[r['round'] for r in recs]}")
    for r in recs:
        for k in ("train_loss", "test_loss", "train_acc", "test_acc",
                  "train_loss_local"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"round {r['round']}: {k}={r[k]}")
    if not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"LM test loss did not fall: "
                             f"{recs[0]['test_loss']} -> "
                             f"{recs[-1]['test_loss']}")
    name = torch.cuda.get_device_name(0)
    log(f"LM path: {rounds} rounds, {want['steps']} SGD steps, launches "
        f"{launches} (schedule {want}), test loss {recs[0]['test_loss']:.4f}"
        f" -> {recs[-1]['test_loss']:.4f} (wall {wall:.1f}s with 2 evals)")

    # one full evaluation batch (512 rows, make_eval's batch) at S = 2048:
    # the train union tiled to 512 sequences; its peak device memory
    x = torch.from_numpy(ds.train_data_global[0]).to("cuda").repeat(8, 1)
    y = torch.from_numpy(ds.train_data_global[1]).to("cuda").repeat(8, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    stats = api._eval_fn(api.variables, x, y, torch.ones(len(x),
                                                         device="cuda"))
    torch.cuda.synchronize()
    eval512 = {"rows": len(x), "s": time.perf_counter() - t,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "peak_above_inputs_gib":
                   (torch.cuda.max_memory_allocated() - base) / 2**30}
    if not math.isfinite(float(stats["loss_sum"])):
        raise AssertionError("eval batch of 512: loss not finite")
    log(f"eval batch [{len(x)}, {x.shape[1]}]: {eval512['s']:.2f}s, peak "
        f"{eval512['peak_gib']:.2f} GiB allocated "
        f"({eval512['peak_above_inputs_gib']:.2f} GiB above what was live)")
    del x, y, stats

    # rounds/s and training tokens/s on the same API, further rounds
    timed = 3
    api.run_round(rounds)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for r in range(rounds + 1, rounds + 1 + timed):
        api.run_round(r)
    torch.cuda.synchronize()
    rps = timed / (time.perf_counter() - t)
    seq_len = ds.train_data_global[0].shape[1]
    tokens_per_round = sum(
        ds.train_data_local_num_dict[int(c)] * seq_len
        for r in range(rounds + 1, rounds + 1 + timed)
        for c in sample_clients(r, ds.client_num, per_round)) / timed
    log(f"LM rounds: {rps:.3f} rounds/s, {rps * tokens_per_round:.0f} "
        f"training tokens/s on {name} (4 clients x 8 sequences x 2048)")

    # the centralized train step at the bench's shape: [4, 2048] tokens,
    # mean next-token CE, SGD lr 1e-3; the kernels, then SDPA as attn_fn
    tokens = torch.from_numpy(ds.train_data_global[0][:4]).to("cuda")

    def sdpa_attn(q, k, v, causal=True):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal).transpose(1, 2)

    step_tps = {}
    for label, attn in (("flash_kernels", fa.make_flash_attention(128, 128)),
                        ("sdpa", sdpa_attn)):
        model = TransformerLM(**LM, attn_fn=attn).to("cuda")
        params = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}

        def step(params):
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            logits = functional_call(model, leaves, (tokens,))
            loss = F.cross_entropy(logits[:, :-1].reshape(-1, LM["vocab_size"]),
                                   tokens[:, 1:].reshape(-1).long())
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                return {k: v.detach() - 1e-3 * g
                        for (k, v), g in zip(leaves.items(), grads)}
        for _ in range(2):
            params = step(params)
        torch.cuda.synchronize()
        n = 10
        t = time.perf_counter()
        for _ in range(n):
            params = step(params)
        torch.cuda.synchronize()
        step_tps[label] = n * tokens.numel() / (time.perf_counter() - t)
    log(f"centralized step [4, 2048]: {step_tps['flash_kernels']:.0f} "
        f"tokens/s with the kernels, {step_tps['sdpa']:.0f} with SDPA, on "
        f"{name}")
    return {"launches": launches, "schedule": want, "evals": recs,
            "wall_s": wall, "rounds_per_s": rps, "eval_512": eval512,
            "train_tokens_per_s": rps * tokens_per_round,
            "centralized_step_tokens_per_s": step_tps}


def phase_lm_card_vs_cpu():
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.data.synthetic import make_token_federated
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.trainer.functional import TrainConfig

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launched = fa.flash_bwd_dq.launches
    try:
        ds = make_token_federated(client_num=4, vocab_size=64, seq_len=128,
                                  sequences_per_client=8, seed=1)
        cfg = FedAvgConfig(comm_round=1, client_num_per_round=4,
                           prefetch_depth=0,
                           train=TrainConfig(epochs=1, batch_size=4, lr=0.3,
                                             shuffle=False))
        apis = [FedAvgAPI(ds, TransformerLM(
                    vocab_size=64, width=64, depth=2, num_heads=2,
                    max_len=128, attn_fn=fa.make_flash_attention(128, 128)),
                    task="nwp", config=cfg, device=d)
                for d in ("cuda", "cpu")]
        for k in apis[1].variables:
            if not torch.equal(apis[0].variables[k].cpu(),
                               apis[1].variables[k]):
                raise AssertionError(f"initial {k} differs across devices")
        for api in apis:
            api.run_round(0)
        diff = max(float((apis[0].variables[k].cpu()
                          - apis[1].variables[k]).abs().max())
                   for k in apis[1].variables)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    if fa.flash_bwd_dq.launches == launched:
        raise AssertionError("the card's transformer round ran no kernel")
    if not diff <= 1e-4:
        raise AssertionError(f"transformer round card vs CPU: max abs diff "
                             f"{diff}")
    log(f"transformer round, card vs CPU: max abs param diff {diff:.3g} "
        "(atol 1e-4)")
    return {"max_abs_diff": diff}


def _same_bits(a, b) -> bool:
    """Equal bit for bit; for floats, NaN at the same places (the card's
    NaN and the CPU's may differ in payload) and equal bits elsewhere."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a[~nan].view(torch.int32), b[~nan].view(torch.int32)
    return bool(torch.equal(a, b))


def _max_abs(a, b) -> float:
    """Largest |a - b| where neither is NaN (0 for no such entry)."""
    import torch
    a, b = a.float(), b.float()
    keep = ~(torch.isnan(a) | torch.isnan(b))
    return float((a[keep] - b[keep]).abs().max()) if keep.any() else 0.0


def _quant_work(d):
    """Bytes each kernel must move for a ``d``-vector (each input read
    once, each output written once) and its f32 operations (about 10 a
    value to quantize: abs, max, divide, shift, convert, scale, floor,
    subtract, compare, add and the clip, and 2 more for the residual; one
    to dequantize, two with a minuend, the residual of top-k's error
    feedback)."""
    blocks = -(-d // 512)
    quant_bytes = 4 * d + 4 * d + d + 4 * blocks
    return {"quant": (10 * d, quant_bytes),
            "quant_res": (12 * d, quant_bytes + 4 * d),
            "dequant": (d, d + 4 * blocks + 4 * d),
            "dequant_sub": (2 * d, d + 4 * blocks + 4 * d + 4 * d)}


def _padded_int8(q, rows):
    """``q`` zero-padded to ``[rows, 512]``, the TPU wrapper's layout."""
    import torch
    qp = torch.zeros(rows * 512, dtype=torch.int8, device=q.device)
    qp[:q.numel()] = q
    return qp.view(rows, 512)


def _library_dequant(qp, scales):
    """One PyTorch call computing the dequantize on the padded layout: the
    int8 -> f32 cast is exact and the product rounds once, so its bits are
    the kernel's."""
    import torch
    return torch.mul(qp, scales[:, None])


def phase_quant_vs_plain():
    import torch
    from fedml_tpu_torch.ops import quantize as tq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    d_cnn = HEADLINE[1]

    def inputs(d, kind="normal", offset=0):
        x = torch.randn(d + offset, generator=gen, device=dev)[offset:]
        if kind == "wide":  # magnitudes spanning 1e-30..1e30
            x = x.sign() * 10.0 ** (torch.rand(d, generator=gen, device=dev)
                                    * 60 - 30)
        if d >= 1024:
            x[512:1024] = 0.0  # an all-zero block
        bits = tq.random_bits(d + offset, gen)[offset:]
        if kind == "top_bit":
            bits = bits | torch.tensor(-2**31, dtype=torch.int32, device=dev)
        if kind == "nan_inf":  # NaN in block 0, +-inf in blocks 2 and 3
            x[3], x[1100], x[1700] = math.nan, math.inf, -math.inf
        return x, bits

    cases = [("cnn_delta", d_cnn, "normal", 0),
             ("topk_survivors", SILO_K, "normal", 0),
             ("wide_range", d_cnn, "wide", 0),
             ("top_bit_set", 70_000, "top_bit", 0),
             ("nan_inf", 2570, "nan_inf", 0),
             ("scalar_path", d_cnn, "normal", 1),
             ("scalar_path_k", SILO_K, "normal", 1)]
    cases += [(f"d{d}", d, "normal", 0) for d in (1, 511, 512, 513, 2570)]
    checks, max_abs = [], {"quant": 0.0, "dequant": 0.0}
    for name, d, kind, offset in cases:
        x, bits = inputs(d, kind, offset)
        q, s = tq.quantize_int8(x, bits)
        # the fused error-feedback residual, from the quantize kernel
        fq, fs, fres = tq.quantize_int8(x, bits, residual=True)
        want_q, want_s = tq.quantize_int8_reference(x, bits)
        q_in = torch.empty(d + offset, dtype=torch.int8, device=dev)[offset:]
        q_in.copy_(want_q)
        out = tq.dequantize_int8(q_in, want_s, d)
        want_out = tq.dequantize_int8_reference(want_q, want_s)
        # the error-feedback residual of the kept values: x - q * scale
        res = tq.dequantize_int8(q_in, want_s, d, subtract_from=x)
        want_res = tq.dequantize_int8_reference(want_q, want_s, x)
        lib_out = _library_dequant(_padded_int8(want_q, tq.num_blocks(d)),
                                   want_s).view(-1)[:d]
        vec = tq.takes_vec_paths(x, bits, q_in, out)
        vec_res = tq.takes_vec_paths(x, bits, q_in, res, x)[1]
        vec_fused = tq.takes_vec_paths(x, bits, fq, out, residual=fres)[0]
        torch.cuda.synchronize()
        ok = {"q": _same_bits(q, want_q), "scales": _same_bits(s, want_s),
              "out": _same_bits(out, want_out),
              "residual": _same_bits(res, want_res),
              "fused_q": _same_bits(fq, want_q),
              "fused_scales": _same_bits(fs, want_s),
              "fused_residual": _same_bits(fres, want_res),
              "library_out": _same_bits(lib_out, want_out)}
        if not all(ok.values()):
            raise AssertionError(f"{name} D={d}: kernel differs from the "
                                 f"plain version in {ok}")
        if (vec != (offset == 0, offset == 0) or vec_res != (offset == 0)
                or vec_fused != (offset == 0)):
            raise AssertionError(f"{name}: vector paths {vec} {vec_res} "
                                 f"{vec_fused}")
        if kind == "nan_inf" and not (
                torch.isnan(s[0]) and torch.isinf(s[2:4]).all()
                and (q[:512] == 0).all() and torch.isnan(out[:512]).all()
                and torch.isnan(out[1024:2048]).all()
                and torch.isnan(fres[:512]).all()
                and torch.isnan(fres[1024:2048]).all()):
            raise AssertionError("a NaN or inf block did not dequantize "
                                 "to NaN")
        max_abs["quant"] = max(max_abs["quant"], _max_abs(q, want_q),
                               _max_abs(fq, want_q))
        max_abs["dequant"] = max(max_abs["dequant"], _max_abs(out, want_out),
                                 _max_abs(res, want_res),
                                 _max_abs(fres, want_res))
        checks.append({"case": name, "d": d,
                       "vec": list(vec) + [vec_res, vec_fused],
                       "bit_exact": True})
        log(f"quantize (and its fused residual), dequantize == plain, bit "
            f"for bit, at {name} D={d}{' (scalar paths)' if offset else ''}")

    # timing at the path's two shapes: 6 input sets at D (65 MB of x and
    # bits, beyond the 50 MB L2; the dequantize's 6 x 1.2 MB of int8 stay
    # in it), 20 at k; kernels and plain versions in CUDA graphs. Beside
    # them the floor of one graph node (an empty kernel), PyTorch's
    # int8 -> f32 copy (the dequantize's bytes through an elementwise
    # pass) and the dequantize's library call (torch.mul on the padded
    # [rows, 512] layout)
    lib = tq._kernel()
    iters = 200
    floor_ms = cuda_time_ms(lambda: lib.fedml_empty_kernel(
        torch.cuda.current_stream().cuda_stream), [()], iters)
    log(f"empty kernel (the floor of one graph node): {floor_ms:.5f} ms")
    timing = {"floor_ms": floor_ms}
    for label, d, sets in (("cnn_delta", d_cnn, 6),
                           ("topk_survivors", SILO_K, 20)):
        qargs = [inputs(d) for _ in range(sets)]
        dargs = [tq.quantize_int8_reference(x, b) + (d,) for x, b in qargs]
        sargs = [a + (x,) for a, (x, _) in zip(dargs, qargs)]
        rows = tq.num_blocks(d)
        padded = [(_padded_int8(q, rows), s) for q, s, _ in dargs]
        copies = [(q, torch.empty(d, device=dev)) for q, _, _ in dargs]

        def plain_fused(x, b):
            q, s = tq.quantize_int8_reference(x, b)
            return q, s, tq.dequantize_int8_reference(q, s, x)
        t = {"quant": (cuda_time_ms(tq.quantize_int8, qargs, iters),
                       cuda_time_ms(tq.quantize_int8_reference, qargs,
                                    iters)),
             "quant_res": (cuda_time_ms(
                 lambda x, b: tq.quantize_int8(x, b, residual=True), qargs,
                 iters), cuda_time_ms(plain_fused, qargs, iters)),
             "dequant": (cuda_time_ms(tq.dequantize_int8, dargs, iters),
                         cuda_time_ms(lambda q, s, d:
                                      tq.dequantize_int8_reference(q, s),
                                      dargs, iters)),
             "dequant_sub": (cuda_time_ms(tq.dequantize_int8, sargs, iters),
                             cuda_time_ms(lambda q, s, d, x:
                                          tq.dequantize_int8_reference(
                                              q, s, x), sargs, iters))}
        library_ms = cuda_time_ms(_library_dequant, padded, iters)
        copy_ms = cuda_time_ms(lambda q, o: o.copy_(q), copies, iters)
        work = _quant_work(d)
        timing[label] = {"library_ms": library_ms, "copy_ms": copy_ms}
        log(f"D={d}: torch.mul on [{rows}, 512] (the dequantize's library "
            f"call) {library_ms:.5f} ms, int8 -> f32 copy_ {copy_ms:.5f} ms")
        for kern, (ms, plain_ms) in t.items():
            ops, nbytes = work[kern]
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = ops / F32_FLOP_PER_S
            timing[label][kern] = {
                "d": d, "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
                "ops": ops, "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "gb_per_s": nbytes / ms / 1e6}
            log(f"{kern} D={d}: kernel {ms:.5f} ms, plain {plain_ms:.5f} "
                f"ms, bound {1e3 * max(t_bytes, t_ops):.5f} ms "
                f"({nbytes / 1e6:.2f} MB) -> {nbytes / ms / 1e6:.0f} GB/s")
    return {"checks": checks, "max_abs_err": max_abs, "timing": timing}


def _silo_launches(rounds, silos, policy, downlink=True):
    """Launches the schedule implies: one quantize per reply and per
    compressed broadcast (rounds 1..R-1); one dequantize for the server's
    decode of each reply, and per compressed broadcast one for the
    server's mirror and one for each silo's apply. Under top-k + int8 the
    quantize launch also writes the error-feedback residual of the kept
    values (ops/sparsify.py), so an encode launches no dequantize. At 5
    rounds and 10 silos: 54 / 94 under both compressed policies; with the
    downlink off (every broadcast full precision) one of each per reply."""
    if policy == "none":
        return {"quant": 0, "dequant": 0}
    bcasts = rounds - 1 if downlink else 0
    encodes = rounds * silos + bcasts
    dequant = rounds * silos + bcasts * (silos + 1)
    return {"quant": encodes, "dequant": dequant}


def phase_cross_silo_path():
    import torch
    from fedml_tpu_torch.comm.compression import compress_for_policy
    from fedml_tpu_torch.comm.policy import parse_policy
    from fedml_tpu_torch.experiments import main_fedavg
    from fedml_tpu_torch.ops import quantize as tq
    from fedml_tpu_torch.utils.metrics import read_metrics

    silos = HEADLINE[0]
    flags = ["--backend", "inproc", "--dataset", "femnist_gen",
             "--client_num_in_total", "200", "--client_num_per_round",
             str(silos), "--batch_size", "20", "--epochs", "1", "--lr",
             "0.1", "--device", "cuda"]
    runs, launches = {}, {"quant": 0, "dequant": 0}
    tq.quantize_int8.launches = 0
    tq.dequantize_int8.launches = 0
    for policy, rounds in (("none", 2), ("delta_int8", 5),
                           ("topk_ef_int8:0.05", 5)):
        run_dir = os.path.join(ROOT, "runs", "chip_smoke",
                               "silo_" + policy.replace(":", "_"))
        shutil.rmtree(run_dir, ignore_errors=True)
        before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
        t = time.perf_counter()
        main_fedavg.main(flags + ["--comm_round", str(rounds),
                                  "--compression", policy,
                                  "--run_dir", run_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {"quant": tq.quantize_int8.launches - before[0],
               "dequant": tq.dequantize_int8.launches - before[1]}
        want = _silo_launches(rounds, silos, policy)
        if got != want:
            raise AssertionError(f"{policy}: launches {got}, the schedule "
                                 f"implies {want}")
        recs = read_metrics(run_dir)
        hist = [r for r in recs if "round" in r]
        summary = recs[-1]
        if [r["round"] for r in hist] != list(range(rounds)):
            raise AssertionError(f"{policy}: rounds {hist}")
        for r in hist:
            if not math.isfinite(r["test_loss"]):
                raise AssertionError(f"{policy}: {r}")
        if rounds == 5 and not hist[4]["test_loss"] < hist[0]["test_loss"]:
            raise AssertionError(f"{policy}: test loss did not fall "
                                 f"{hist[0]['test_loss']} -> "
                                 f"{hist[4]['test_loss']}")
        steady = summary["round_duration_s"][1:]
        runs[policy] = {
            "launches": got, "wall_s": wall, "history": hist,
            "rounds_per_s": len(steady) / sum(steady),
            "round_duration_s": summary["round_duration_s"],
            "bytes_up_per_round": summary["comm_bytes_up_per_round"],
            "bytes_down_per_round": summary["comm_bytes_down_per_round"],
            "codec_encode_ms": summary.get("gauge_codec_encode_ms"),
            "agg_fold_ms": summary["gauge_agg_fold_ms"],
            "phase_ms_per_round": {
                k[len("phase_"):-len("_ms_per_round")]: v
                for k, v in summary.items()
                if k.startswith("phase_") and k.endswith("_per_round")}}
        launches = {k: launches[k] + got[k] for k in launches}
    base = runs["none"]
    for policy, r in runs.items():
        r["up_ratio_to_none"] = base["bytes_up_per_round"] / \
            r["bytes_up_per_round"]
        r["down_ratio_to_none"] = base["bytes_down_per_round"] / \
            r["bytes_down_per_round"]
        log(f"cross-silo {policy}: launches {r['launches']}, test loss "
            f"{r['history'][0]['test_loss']:.4f} -> "
            f"{r['history'][-1]['test_loss']:.4f}, "
            f"{r['rounds_per_s']:.3f} rounds/s after round 0, wire a round "
            f"up {r['bytes_up_per_round']:.0f} B "
            f"({r['up_ratio_to_none']:.2f}x less than none), down "
            f"{r['bytes_down_per_round']:.0f} B "
            f"({r['down_ratio_to_none']:.2f}x), codec_encode_ms "
            f"{r['codec_encode_ms']}, agg_fold_ms {r['agg_fold_ms']:.3f}, "
            f"phase ms a round {r['phase_ms_per_round']}")

    # one reply's frame arrays at full width: the CNN's state dict and a
    # perturbed copy, encoded as a silo encodes them
    from fedml_tpu_torch.models import CNN_DropOut
    model = CNN_DropOut(only_digits=False).to("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    base_sd = {k: v.detach() for k, v in model.state_dict().items()}
    new_sd = {k: v + 1e-3 * torch.randn(v.shape, generator=gen,
                                        device="cuda")
              for k, v in base_sd.items()}
    frames = {}
    for policy, want in (("delta_int8", 1_216_018),
                         ("topk_ef_int8:0.05", 302_122)):
        payload, _ = compress_for_policy(new_sd, base_sd, None, gen,
                                         parse_policy(policy))
        nbytes = sum(payload[k].nbytes for k in ("i", "q", "s")
                     if k in payload)
        if nbytes != want:
            raise AssertionError(f"{policy}: reply arrays {nbytes} B, "
                                 f"expected {want}")
        frames[policy] = nbytes
        log(f"{policy}: one reply's arrays {nbytes} B "
            f"({4 * HEADLINE[1] / nbytes:.2f}x less than f32)")
    return {"runs": runs, "launches": launches, "reply_array_bytes": frames}


def phase_cross_silo_card_vs_cpu():
    import torch
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        run_fedavg_cross_silo)
    from fedml_tpu_torch.data.synthetic import make_blob_federated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.functional import TrainConfig

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    diffs = {}
    try:
        ds = make_blob_federated(client_num=8, dim=256, class_num=10, seed=2)
        for policy in ("none", "topk_ef"):
            finals = [run_fedavg_cross_silo(
                ds, create_model("lr", ds.class_num, input_shape=(256,)),
                worker_num=4, comm_round=1, compression=policy,
                train_cfg=TrainConfig(epochs=1, batch_size=16, lr=0.1,
                                      shuffle=False), device=d)[0]
                for d in ("cuda", "cpu")]
            diffs[policy] = max(float((finals[0][k].cpu()
                                       - finals[1][k]).abs().max())
                                for k in finals[1])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    for policy, diff in diffs.items():
        if not diff <= 1e-5:
            raise AssertionError(f"cross-silo LR round card vs CPU under "
                                 f"{policy}: max abs diff {diff}")
        log(f"cross-silo LR round, card vs CPU, {policy}: max abs param "
            f"diff {diff:.3g} (atol 1e-5)")
    return {"max_abs_diff": diffs}


def _main_api_parts():
    """The main path's dataset, model, task and TrainConfig, from its
    flags, built once for the phases that drive it through FedAvgAPI."""
    from fedml_tpu_torch.experiments import main_fedavg
    args = main_fedavg.add_federated_args(
        argparse.ArgumentParser()).parse_args(MAIN_FLAGS)
    ds, model, task = main_fedavg.build_dataset_and_model(args)
    return ds, model, task, main_fedavg.make_train_config(args)


def _main_api(parts, comm_round, freq=10**9, **train):
    """A FedAvgAPI on the main path's configuration (``train`` overrides
    fields of its TrainConfig)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    return _algo_api(FedAvgAPI, FedAvgConfig, parts, comm_round, freq,
                     **train)


def _algo_api(api_cls, config_cls, parts, comm_round, freq=10**9,
              config=None, **train):
    """An API of the FedAvg family on the main path's configuration
    (``config`` adds fields of its config, ``train`` overrides fields of its
    TrainConfig)."""
    ds, model, task, tc = parts
    return api_cls(ds, model, task=task, device="cuda", config=config_cls(
        comm_round=comm_round, client_num_per_round=HEADLINE[0],
        frequency_of_the_test=freq, train=dataclasses.replace(tc, **train),
        **(config or {})))


def _spread(xs):
    """Median, min and max of repeated measurements."""
    s = sorted(xs)
    return {"median": s[len(s) // 2], "min": s[0], "max": s[-1], "runs": xs}


def _rounds_per_s(run, rounds, reps=3):
    """``run()`` (``rounds`` rounds) timed ``reps`` times, synchronized."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append(rounds / (time.perf_counter() - t))
    return _spread(out)


def _profile(run, rounds, cpu_ops=True):
    """``run()`` under torch.profiler: device ms a round (the device's own
    events), launch calls a round, and the aggregation kernel's launches by
    name in the device activity. ``cpu_ops=False`` traces the CUDA activity
    alone (the runtime's launch calls and the device's kernels, no operator
    events on the host), for host rounds of tens of thousands of launches;
    it is not used where kernels are counted: in a run of this script it
    saw fewer of a fused block's aggregation kernels than ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu_ops
            else [ProfilerActivity.CUDA])
    with _profile_window(acts) as prof:
        run()
        torch.cuda.synchronize()
    # the raw events, not key_averages(): that builds an event tree first,
    # which took 35 s for a fresh driver's first block (~300k events)
    # where one pass over the raw events took 2.5 s
    return _profile_stats([(e.name(), e.device_type().name, e.duration_ns())
                           for e in prof.profiler.kineto_results.events()],
                          rounds)


PROFILE_MARGIN_S = 0.05


@contextlib.contextmanager
def _profile_window(acts):
    """A ``torch.profiler`` window with ``PROFILE_MARGIN_S`` of idle host
    time at each edge, the device drained at both. The profiler keeps a
    device activity only if it lies inside the window on the host's clock,
    as converted from the device's timestamps; a fused block's last
    aggregation kernel runs close to the block's end, and in one run of
    this script the profiler saw one aggregation kernel fewer than ran.
    The margins keep such a kernel well inside the window."""
    import torch
    from torch.profiler import profile
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(PROFILE_MARGIN_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)


def _profile_stats(events, rounds):
    """``_profile``'s figures from ``(name, device type, ns)`` events. A
    kernel counts by its device event whatever duration the profiler gave
    it (as ``key_averages()``' ``count`` counted it)."""
    device = [(name, ns) for name, kind, ns in events if kind == "CUDA"]
    return {
        "device_ms_per_round": sum(max(ns, 0) for _, ns in device) / 1e6
        / rounds,
        "wmean_kernels": sum(1 for name, _ in device if "wmean_" in name),
        "wmean_kernels_without_duration": sum(
            1 for name, ns in device if "wmean_" in name and ns <= 0),
        "device_events": len(device),
        # device kernels whose names say they compute in bf16 (cuDNN's and
        # cuBLAS's bf16 convolutions and GEMMs, and the casts)
        "bf16_kernels": sorted({name[:120] for name, _ in device if any(
            t in name.lower() for t in ("bf16", "bfloat16"))}),
        "launch_calls_per_round": {
            k: sum(1 for name, _, _ in events if name == k) / rounds
            for k in ("cudaLaunchKernel", "cudaGraphLaunch")}}


def _device_events(prof):
    """What a failed count of ``_profile``'s kernels reports beside it."""
    return (f"{prof['device_events']} device events in the window, "
            f"{prof['wmean_kernels_without_duration']} aggregation kernels "
            "without a duration")


def _padding_steps(fused, r0):
    """Device ms a round of a fused block as it runs, and of the same block
    with every step made padding-only: a gated step runs the same kernels
    whether its batch is real or not, so the second, over its steps, is
    one step's cost, and that times the block's padding-only steps is
    what they cost a round. Each timed by CUDA events, median of 3."""
    import torch
    block = fused._block_inputs(r0, FUSED_R)
    plan = block["plan"]
    steps, real = plan.has_real.numel(), int(plan.has_real.sum())
    padded = dict(block, plan=plan._replace(
        has_real=torch.zeros_like(plan.has_real),
        emit=torch.zeros_like(plan.emit)))

    def ms(b):
        out = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fused._run_graph(b, FUSED_R)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / FUSED_R)
        return sorted(out)[1]
    block_ms, all_pad_ms = ms(block), ms(padded)
    pad_ms = all_pad_ms / steps * (steps - real)
    return {"steps_per_round": steps / FUSED_R,
            "real_steps_per_round": real / FUSED_R,
            "block_ms_per_round": block_ms,
            "all_padding_ms_per_round": all_pad_ms,
            "padding_ms_per_round": pad_ms,
            "padding_share": pad_ms / block_ms}


def phase_fused_path():
    """The main path through ``--fused_rounds``, its trajectory against the
    host loop's, its launches and rounds/s beside the host loop's."""
    import torch
    from fedml_tpu_torch.experiments import main_fedavg
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.parallel.graphs import CapturedRound
    from fedml_tpu_torch.utils.metrics import read_metrics

    rounds = 2 * FUSED_R
    run_dir = os.path.join(ROOT, "runs", "chip_smoke_fused")
    shutil.rmtree(run_dir, ignore_errors=True)
    captures = CapturedRound.captures
    aggregate.weighted_mean_flat.launches = 0
    t = time.perf_counter()
    main_fedavg.main(MAIN_FLAGS + [
        "--comm_round", str(rounds), "--frequency_of_the_test", str(FUSED_R),
        "--fused_rounds", str(FUSED_R), "--run_dir", run_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = aggregate.weighted_mean_flat.launches
    captures = CapturedRound.captures - captures
    # each capture ran one eager warm-up round (one launch) and recorded
    # one launch that runs at each replay; every fused round is one replay
    if not captures or launches != rounds + captures:
        raise AssertionError(f"fused main path: {launches} aggregation "
                             f"launches in {rounds} rounds and {captures} "
                             "captures")
    recs = read_metrics(run_dir)
    if [r["round"] for r in recs] != [0, FUSED_R, rounds - 1]:
        raise AssertionError(f"fused eval rounds {[r['round'] for r in recs]}")
    for r in recs:
        for k in ("train_loss", "test_loss", "train_loss_local"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"fused round {r['round']}: {k}={r[k]}")
    if not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"fused test loss did not fall: "
                             f"{recs[0]['test_loss']} -> "
                             f"{recs[-1]['test_loss']}")
    log(f"fused main path: {rounds} rounds in dispatches of {FUSED_R}, "
        f"{captures} captures, {launches} aggregation launches, test loss "
        f"{recs[0]['test_loss']:.4f} -> {recs[-1]['test_loss']:.4f} (wall "
        f"{wall:.1f}s with data build, capture and eval)")

    # the same cohorts through the host loop and a fused block, shuffle
    # and dropout on
    parts = _main_api_parts()
    diff, _ = _fused_vs_host(parts, FUSED_R)
    if not diff <= 1e-6:
        raise AssertionError(f"fused block vs host loop: max abs diff {diff}")
    log(f"fused block == host loop over {FUSED_R} rounds (shuffle, dropout "
        f"on): max abs param diff {diff:.3g} (bound 1e-6)")

    return {"launches": launches, "captures": captures, "evals": recs,
            "wall_s": wall, "fused_vs_host_max_abs_diff": diff,
            "timing": _host_vs_fused_timing(parts)}


def _host_vs_fused_timing(parts, compute_dtype=None, reps=3,
                          make_api=None, label=None):
    """rounds/s of the host loop and of fused blocks (median and spread of
    ``reps`` runs over the same rounds), each round's launches and device
    time under the profiler, the graphs' capture time and pool bytes.
    ``make_api(parts, comm_round, **train)`` builds the API (FedAvg's by
    default)."""
    import torch
    from fedml_tpu_torch.ops import aggregate

    make_api = make_api or _main_api
    first, timed = 2, FUSED_R
    span = range(first, first + timed)
    host = make_api(parts, first + timed, compute_dtype=compute_dtype)
    for r in range(first):
        host.run_round(r)
    host_rps = _rounds_per_s(lambda: [host.run_round(r) for r in span],
                             timed, reps)
    # the first timed round under the profiler, its CUDA activity alone
    # (its ~9,000 launches' operator events made the trace's processing
    # the slowest part of this phase; no kernel is counted in it): the
    # busy share takes its device time against the rate over all the
    # timed rounds
    host_prof = _profile(lambda: host.run_round(span[0]), 1, cpu_ops=False)

    api = make_api(parts, first + timed, compute_dtype=compute_dtype)
    fused = api.fused_rounds()

    def blocks():
        for r in range(first, first + timed, FUSED_R):
            fused.run_rounds(r, FUSED_R)
    blocks()  # captures the graph of every pad bucket the rounds use
    fused_rps = _rounds_per_s(blocks, timed, reps)
    # profiled blocks of PROFILED_R rounds (the trace of a replay's ~8,600
    # kernels takes seconds to process); the block runs once first, to
    # capture its pad bucket's graph if no FUSED_R block had that bucket
    fused.run_rounds(first, PROFILED_R)
    before = aggregate.weighted_mean_flat.launches
    fused_prof = _profile(lambda: fused.run_rounds(first, PROFILED_R),
                          PROFILED_R)
    driver = aggregate.weighted_mean_flat.launches - before
    if not fused_prof["wmean_kernels"] == driver == PROFILED_R:
        raise AssertionError(
            f"a profiled fused block of {PROFILED_R} rounds: the profiler "
            f"saw {fused_prof['wmean_kernels']} aggregation kernels, the "
            f"driver counted {driver} ({_device_events(fused_prof)})")
    # a new driver's first block, under the profiler: its capture records
    # the kernel without running it, its warm-up round runs it once
    fresh = api.fused_rounds()
    before = aggregate.weighted_mean_flat.launches
    capture_prof = _profile(lambda: fresh.run_rounds(first, PROFILED_R),
                            PROFILED_R)
    counted = aggregate.weighted_mean_flat.launches - before
    if not (capture_prof["wmean_kernels"] == counted
            == PROFILED_R + len(fresh.graphs)):
        raise AssertionError(
            f"a profiled fused block with {len(fresh.graphs)} captures: the "
            f"profiler saw {capture_prof['wmean_kernels']} aggregation "
            f"kernels, the driver counted {counted}, {PROFILED_R} rounds "
            f"({_device_events(capture_prof)})")
    padding = _padding_steps(fused, first)
    bf16 = compute_dtype == "bfloat16"
    for name, prof in (("host loop", host_prof), ("fused", fused_prof)):
        if bool(prof["bf16_kernels"]) != bf16:
            raise AssertionError(
                f"{compute_dtype or 'f32'} {name}: bf16 kernels on the "
                f"device: {prof['bf16_kernels'][:8]}")
    graphs = [{"capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
               "wmean_launches_per_replay":
                   g.launches.get(aggregate.weighted_mean_flat, 0)}
              for g in fused.graphs.values()]
    out = {"rounds_per_s": host_rps, **host_prof,
           "busy_share": host_prof["device_ms_per_round"]
           * host_rps["median"] / 1e3,
           "fused": {"rounds_per_s": fused_rps, **fused_prof,
                     "busy_share": fused_prof["device_ms_per_round"]
                     * fused_rps["median"] / 1e3,
                     "driver_wmean_launches": driver, "graphs": graphs,
                     "padding_steps": padding,
                     "with_capture": {
                         "wmean_kernels": capture_prof["wmean_kernels"],
                         "driver_wmean_launches": counted,
                         "captures": len(fresh.graphs)}}}
    label = label or compute_dtype or "f32"
    for name, rec in (("host loop", out), ("fused", out["fused"])):
        rps = rec["rounds_per_s"]
        log(f"{label} {name}: {rps['median']:.3f} rounds/s (min "
            f"{rps['min']:.3f}, max {rps['max']:.3f}, {reps} runs of "
            f"{timed} rounds); device {rec['device_ms_per_round']:.2f} ms a "
            f"round, busy {100 * rec['busy_share']:.1f}%; launch calls a "
            f"round {rec['launch_calls_per_round']}")
    log(f"{label} fused: the profiler saw {fused_prof['wmean_kernels']} "
        f"aggregation kernels in {PROFILED_R} rounds (the driver counted "
        f"{driver}); in a block with {len(fresh.graphs)} capture(s), "
        f"{capture_prof['wmean_kernels']} (the driver counted {counted}); "
        f"{len(fused_prof['bf16_kernels'])} bf16 kernel names; graphs "
        "(capture s, pool MiB): "
        + ", ".join(f"({g['capture_s']:.2f}, {g['pool_bytes'] / 2**20:.0f})"
                    for g in graphs))
    log(f"{label} fused: {padding['steps_per_round']:.0f} gated steps a "
        f"round, {padding['real_steps_per_round']:.0f} of them real; the "
        f"block {padding['block_ms_per_round']:.2f} ms a round, all steps "
        f"padding-only {padding['all_padding_ms_per_round']:.2f} ms: the "
        f"padding-only steps cost {padding['padding_ms_per_round']:.2f} ms "
        f"a round ({100 * padding['padding_share']:.0f}% of the block)")
    return out


def phase_fused_bf16():
    """The JAX headline's configuration: the fused main path in bf16 off
    f32 masters."""
    import torch
    from fedml_tpu_torch.experiments import main_fedavg
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.utils.metrics import read_metrics

    rounds = 2 * FUSED_R
    run_dir = os.path.join(ROOT, "runs", "chip_smoke_bf16")
    shutil.rmtree(run_dir, ignore_errors=True)
    aggregate.weighted_mean_flat.launches = 0
    main_fedavg.main(MAIN_FLAGS + [
        "--comm_round", str(rounds), "--frequency_of_the_test", str(FUSED_R),
        "--fused_rounds", str(FUSED_R), "--compute_dtype", "bfloat16",
        "--run_dir", run_dir])
    torch.cuda.synchronize()
    launches = aggregate.weighted_mean_flat.launches
    recs = read_metrics(run_dir)
    if launches < rounds:
        raise AssertionError(f"bf16 fused path: {launches} aggregation "
                             f"launches in {rounds} rounds")
    if not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"bf16 test loss did not fall: "
                             f"{recs[0]['test_loss']} -> "
                             f"{recs[-1]['test_loss']}")
    log(f"bf16 fused main path: {rounds} rounds, {launches} aggregation "
        f"launches, test loss {recs[0]['test_loss']:.4f} -> "
        f"{recs[-1]['test_loss']:.4f}")

    # one fused round in bf16 and in f32 from the same weights, beside an
    # f32 round from weights perturbed by 2**-9 relative noise (the rounding
    # of one bf16 cast): the round's own sensitivity to bf16-sized error
    parts = _main_api_parts()
    apis = [_main_api(parts, 1, compute_dtype=d) for d in ("bfloat16", None)]
    perturbed = _main_api(parts, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    perturbed.variables = {
        k: v * (1 + 2.0**-9 * torch.randn(v.shape, generator=gen,
                                           device="cuda"))
        for k, v in perturbed.variables.items()}
    for api in apis + [perturbed]:
        api.fused_rounds().run_rounds(0, 1)

    def rel_l2(a):
        num = sum(float(((a.variables[k] - v) ** 2).sum())
                  for k, v in apis[1].variables.items())
        den = sum(float((v ** 2).sum()) for v in apis[1].variables.values())
        return math.sqrt(num / den)
    diff = max(float((apis[0].variables[k] - v).abs().max())
               for k, v in apis[1].variables.items())
    bf16_l2, ref_l2 = rel_l2(apis[0]), rel_l2(perturbed)
    if not (BF16_VS_F32_MIN_FACTOR * ref_l2 <= bf16_l2
            <= BF16_VS_F32_FACTOR * ref_l2):
        raise AssertionError(
            f"bf16 vs f32 round: relative L2 distance {bf16_l2} outside "
            f"[{BF16_VS_F32_MIN_FACTOR}, {BF16_VS_F32_FACTOR}] x the "
            f"perturbed f32 round's {ref_l2}")
    log(f"one round bf16 vs f32: relative L2 distance {bf16_l2:.4f} (max "
        f"abs {diff:.3g}); an f32 round from 2**-9-perturbed weights "
        f"{ref_l2:.4f} (bounds {BF16_VS_F32_MIN_FACTOR}x and "
        f"{BF16_VS_F32_FACTOR}x)")
    timing = _host_vs_fused_timing(parts, "bfloat16", reps=1)
    return {"launches": launches, "evals": recs,
            "bf16_vs_f32_max_abs_diff": diff, "bf16_vs_f32_rel_l2": bf16_l2,
            "perturbed_f32_rel_l2": ref_l2, "timing": timing}


def phase_fused_device_mode():
    """Device sampling: the cohorts and batch orders drawn on the card."""
    import torch
    from fedml_tpu_torch.core.sampling import (device_round_key,
                                               device_sample_clients)

    parts = _main_api_parts()
    n, k = parts[0].client_num, HEADLINE[0]
    rounds = 2 * FUSED_R
    api = _main_api(parts, rounds, freq=rounds - 1)
    fused = api.fused_rounds(device_sampling=True)
    cohorts = [device_sample_clients(device_round_key(
        api.config.seed, torch.tensor(r, device="cuda")), n, k).tolist()
        for r in range(rounds)]
    if any(len(set(c)) != k or not 0 <= min(c) <= max(c) < n
           for c in cohorts) or len({tuple(c) for c in cohorts}) < 2:
        raise AssertionError(f"device-sampled cohorts {cohorts}")
    t = time.perf_counter()
    fused.train(max_rounds_per_dispatch=FUSED_R)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    recs = api.history
    if not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"device mode: test loss did not fall: "
                             f"{recs[0]['test_loss']} -> "
                             f"{recs[-1]['test_loss']}")
    log(f"device-sampled fused rounds: {rounds} rounds, distinct cohorts of "
        f"{k} without replacement, test loss {recs[0]['test_loss']:.4f} -> "
        f"{recs[-1]['test_loss']:.4f} (wall {wall:.1f}s with capture and "
        "eval)")
    return {"cohorts": cohorts, "evals": recs, "wall_s": wall}


def phase_lm_bf16():
    """An LM round in bf16: the three flash kernels on their bf16 path."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.synthetic import make_token_federated
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.trainer.functional import TrainConfig

    ds = make_token_federated(client_num=8, vocab_size=1024, seq_len=2048,
                              sequences_per_client=8, seed=0)
    rounds, per_round, bsz = 2, 4, 4
    api = FedAvgAPI(ds, TransformerLM(**LM, attn_fn=fa.make_flash_attention(
        128, 128)), task="nwp", device="cuda", config=FedAvgConfig(
            comm_round=rounds + 3, client_num_per_round=per_round,
            frequency_of_the_test=10**9, train=TrainConfig(
                epochs=1, batch_size=bsz, lr=LM_LR,
                compute_dtype="bfloat16")))
    kernels = (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    for r in range(rounds):
        _, stats = api.run_round(r)
    torch.cuda.synchronize()
    launches = dict(zip(("fwd", "dkdv", "dq"),
                        (fn.launches for fn in kernels)))
    steps = sum(-(-ds.train_data_local_num_dict[int(c)] // bsz)
                for r in range(rounds)
                for c in sample_clients(r, ds.client_num, per_round))
    depth = LM["depth"]
    if launches != {"fwd": depth * steps, "dkdv": depth * steps,
                    "dq": depth * steps}:
        raise AssertionError(f"bf16 LM: flash launches {launches}, the "
                             f"schedule implies {depth} each a step over "
                             f"{steps} steps")
    if not math.isfinite(float(stats["loss_sum"])):
        raise AssertionError("bf16 LM round: loss not finite")
    timed = 3
    rps = _rounds_per_s(lambda: [api.run_round(r) for r in
                                 range(rounds, rounds + timed)], timed, 1)
    tokens = sum(ds.train_data_local_num_dict[int(c)] * 2048
                 for r in range(rounds, rounds + timed)
                 for c in sample_clients(r, ds.client_num, per_round)) / timed
    log(f"bf16 LM: {rounds} rounds, {steps} steps, flash launches "
        f"{launches} ({3 * depth} a step); {rps['median']:.3f} rounds/s, "
        f"{rps['median'] * tokens:.0f} training tokens/s")

    # a small transformer round in bf16, card against CPU, same weights
    small = make_token_federated(client_num=4, vocab_size=64, seq_len=128,
                                 sequences_per_client=8, seed=1)
    cfg = FedAvgConfig(comm_round=1, client_num_per_round=4,
                       prefetch_depth=0, train=TrainConfig(
                           epochs=1, batch_size=4, lr=0.3, shuffle=False,
                           compute_dtype="bfloat16"))
    apis = [FedAvgAPI(small, TransformerLM(
                vocab_size=64, width=64, depth=2, num_heads=2, max_len=128,
                attn_fn=fa.make_flash_attention(128, 128)),
                task="nwp", config=cfg, device=d) for d in ("cuda", "cpu")]
    for a in apis:
        a.run_round(0)
    diff, worst = 0.0, 0.0
    for k, want in apis[1].variables.items():
        d = (apis[0].variables[k].cpu() - want).abs()
        diff = max(diff, float(d.max()))
        worst = max(worst, float((d - LM_BF16_TOL["atol"]
                                  - LM_BF16_TOL["rtol"] * want.abs()).max()))
    if worst > 0:
        raise AssertionError(f"bf16 transformer round card vs CPU: max abs "
                             f"diff {diff} outside {LM_BF16_TOL}")
    log(f"bf16 transformer round, card vs CPU: max abs param diff "
        f"{diff:.3g} (rtol {LM_BF16_TOL['rtol']}, atol "
        f"{LM_BF16_TOL['atol']})")
    return {"launches": launches, "steps": steps, "rounds_per_s": rps,
            "train_tokens_per_s": rps["median"] * tokens,
            "card_vs_cpu_max_abs_diff": diff}


def _fedopt_api(parts, comm_round, freq=10**9, server_optimizer="adam",
                server_lr=FEDOPT_LR, **train):
    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI, FedOptConfig
    return _algo_api(FedOptAPI, FedOptConfig, parts, comm_round, freq,
                     dict(server_optimizer=server_optimizer,
                          server_lr=server_lr), **train)


def _max_diff(a, b) -> float:
    """Largest absolute difference between two nests of tensors."""
    import torch.utils._pytree as pytree
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{len(la)} leaves against {len(lb)}")
    return max(float((x.double().cpu() - y.double().cpu()).abs().max())
               for x, y in zip(la, lb))


def _launch_run(module, argv, name):
    """``module.main(argv)`` with the aggregation kernel's count set to 0
    just before and read just after; returns (final record, launches,
    captures, metrics records, wall s)."""
    import torch
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.parallel.graphs import CapturedRound
    from fedml_tpu_torch.utils.metrics import read_metrics

    run_dir = os.path.join(ROOT, "runs", name)
    shutil.rmtree(run_dir, ignore_errors=True)
    captures = CapturedRound.captures
    aggregate.weighted_mean_flat.launches = 0
    t = time.perf_counter()
    final = module.main(argv + ["--run_dir", run_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return (final, aggregate.weighted_mean_flat.launches,
            CapturedRound.captures - captures, read_metrics(run_dir), wall)


def _check_evals(name, recs, rounds, falls=True):
    """Every eval record finite, at the expected rounds, and (``falls``)
    the test loss lower at the last than at the first."""
    if [r["round"] for r in recs] != rounds:
        raise AssertionError(f"{name}: eval rounds {[r['round'] for r in recs]}"
                             f", want {rounds}")
    for r in recs:
        for k, v in r.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{name} round {r['round']}: {k}={v}")
    if falls and not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"{name}: test loss did not fall: "
                             f"{recs[0]['test_loss']} -> "
                             f"{recs[-1]['test_loss']}")


def phase_fedopt_path():
    """FedOpt-adam on the CNN through ``fed_launch.main``, host loop and
    fused blocks: launches, the fused block against the host loop (params
    and server state), server SGD at lr 1 against FedAvg, and rounds/s."""
    import torch
    from fedml_tpu_torch.experiments import fed_launch

    out = _path_runs(fed_launch, "fedopt", [
        "--algo", "fedopt", *MAIN_FLAGS, "--server_optimizer", "adam",
        "--server_lr", str(FEDOPT_LR)], 2 * FUSED_R, FUSED_R, FUSED_R)

    parts = _main_api_parts()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        host, fused_api = (_fedopt_api(parts, FUSED_R) for _ in range(2))
        for r in range(FUSED_R):
            host.run_round(r)
        fused_api.fused_rounds().run_rounds(0, FUSED_R)
        diff = _max_diff((host.variables, host.server_opt_state),
                         (fused_api.variables, fused_api.server_opt_state))
        if int(fused_api.server_opt_state["count"]) != FUSED_R:
            raise AssertionError("fused server adam count "
                                 f"{fused_api.server_opt_state['count']}")
        sgd = _fedopt_api(parts, 1, server_optimizer="sgd", server_lr=1.0)
        avg = _main_api(parts, 1)
        sgd.run_round(0)
        avg.run_round(0)
        sgd_diff = _max_diff(sgd.variables, avg.variables)
    finally:
        torch.backends.cudnn.deterministic = saved
    if not diff <= 1e-6:
        raise AssertionError(f"fedopt fused block vs host loop: {diff}")
    if not sgd_diff <= FEDOPT_SGD_TOL:
        raise AssertionError(f"fedopt sgd lr 1 vs fedavg: {sgd_diff}")
    log(f"fedopt fused block == host loop over {FUSED_R} rounds (params and "
        f"adam state): max abs diff {diff:.3g} (bound 1e-6); server sgd at "
        f"lr 1 vs fedavg after a round: {sgd_diff:.3g} (bound "
        f"{FEDOPT_SGD_TOL})")
    out.update(fused_vs_host_max_abs_diff=diff, sgd_vs_fedavg=sgd_diff,
               timing=_host_vs_fused_timing(parts, make_api=_fedopt_api,
                                            label="fedopt-adam f32", reps=1))
    return out


def _hierarchical_launches(seed, group_num, group_rounds, rounds,
                           n=MAIN_CLIENTS):
    """The aggregation launches hierarchical FedAvg makes over ``n``
    clients: a group round a launch for every group with sampled clients,
    and the global mean."""
    from fedml_tpu_torch.core.sampling import (locked_global_numpy_rng,
                                               sample_clients)
    k = HEADLINE[0]
    with locked_global_numpy_rng(seed) as rng:
        groups = rng.randint(0, group_num, n)
    return sum(len({int(groups[c]) for c in sample_clients(r, n, k)})
               * group_rounds + 1 for r in range(rounds))


def phase_slice_algorithms():
    """The rest of the slice through ``fed_launch.main`` on the card: the
    robust defenses, FedNova, hierarchical and secure aggregation on the
    CNN, centralized, decentralized and contribution on LR; launches,
    finite metrics and a falling loss where the JAX tests assert one."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobustAPI,
                                                          FedAvgRobustConfig)
    from fedml_tpu_torch.experiments import fed_launch
    from fedml_tpu_torch.ops import aggregate

    rounds = SLICE_ROUNDS
    cnn = MAIN_FLAGS + ["--comm_round", str(rounds),
                        "--frequency_of_the_test", str(rounds - 1)]
    evals = [0, rounds - 1]
    out = {}

    def run(name, algo, flags, launches, falls=True, eval_rounds=evals):
        final, got, _, recs, wall = _launch_run(
            fed_launch, ["--algo", algo, *flags], f"chip_smoke_{name}")
        if got != launches:
            raise AssertionError(f"{name}: {got} aggregation launches, "
                                 f"want {launches}")
        if eval_rounds is not None:
            _check_evals(name, recs, eval_rounds, falls)
        out[name] = {"launches": got, "final": final, "wall_s": wall}
        loss = (f"test loss {recs[0]['test_loss']:.4f} -> "
                f"{recs[-1]['test_loss']:.4f}, "
                if eval_rounds is not None else "")
        log(f"{name}: {loss}{got} aggregation launches (wall {wall:.1f}s)")
        return final

    for defense in ROBUST_DEFENSES:
        rule = defense in ("median", "trimmed_mean", "krum")
        # weak_dp adds noise to every client (the JAX test asserts only
        # that it does); Krum keeps one client's model
        run(f"robust_{defense}", "fedavg_robust",
            cnn + ["--defense_type", defense], 0 if rule else rounds,
            falls=defense not in ("weak_dp", "krum"))
    run("fednova", "fednova", cnn + ["--gmf", "0.5"], rounds)
    run("hierarchical", "hierarchical",
        cnn + ["--group_num", "2", "--group_comm_round", "2"],
        _hierarchical_launches(0, 2, 2, rounds))
    run("turboaggregate", "turboaggregate",
        MAIN_FLAGS + ["--comm_round", "2", "--frequency_of_the_test", "1"],
        0, eval_rounds=[0, 1])
    lr_flags = ["--dataset", "blob", "--client_num_in_total", "8",
                "--client_num_per_round", "4", "--batch_size", "16",
                "--lr", "0.1", "--device", "cuda"]
    cent = run("centralized", "centralized",
               lr_flags + ["--comm_round", str(rounds)], 0, eval_rounds=None)
    if not cent["test_acc"] > 0.8:
        raise AssertionError(f"centralized: {cent}")
    regrets = [run(f"decentralized_{t}", "decentralized",
                   lr_flags + ["--comm_round", str(t)], 0,
                   eval_rounds=None)["regret"] for t in (20, 200)]
    if not all(map(math.isfinite, regrets)) or not regrets[1] < regrets[0]:
        raise AssertionError(f"decentralized regret over 20 and 200 "
                             f"iterations: {regrets}")
    loo = run("contribution", "contribution",
              lr_flags + ["--client_num_in_total", "4", "--comm_round", "2"],
              5 * 2, eval_rounds=None)
    if not all(math.isfinite(v) and v >= 0 for v in loo["influence"]):
        raise AssertionError(f"contribution: {loo}")

    # weak DP's noise in a captured round: the host loop's bits
    parts = _main_api_parts()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        host, fused_api = (_algo_api(
            FedAvgRobustAPI, FedAvgRobustConfig, parts, FUSED_R,
            config=dict(defense_type="weak_dp")) for _ in range(2))
        for r in range(FUSED_R):
            host.run_round(r)
        aggregate.weighted_mean_flat.launches = 0
        fused = fused_api.fused_rounds()
        fused.run_rounds(0, FUSED_R)
        launches = aggregate.weighted_mean_flat.launches
        diff = _max_diff(host.variables, fused_api.variables)
    finally:
        torch.backends.cudnn.deterministic = saved
    if launches != FUSED_R + len(fused.graphs) or not diff <= 1e-6:
        raise AssertionError(f"weak_dp fused block: {launches} launches, "
                             f"max abs diff {diff} against the host loop")
    log(f"weak_dp fused block == host loop over {FUSED_R} rounds: max abs "
        f"diff {diff:.3g} (bound 1e-6), {launches} aggregation launches")
    out["weak_dp_fused"] = {"launches": launches, "max_abs_diff": diff}
    return out


def phase_slice_card_vs_cpu():
    """One LR round of FedOpt (adam), FedNova (momentum, the proximal term,
    server momentum) and robust median on the card and on the CPU from the
    same weights (TF32 off)."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobustAPI,
                                                          FedAvgRobustConfig)
    from fedml_tpu_torch.algorithms.fednova import FedNovaAPI, FedNovaConfig
    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI, FedOptConfig
    from fedml_tpu_torch.data.synthetic import make_blob_federated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.functional import TrainConfig

    ds = make_blob_federated(client_num=8, seed=0)
    tc = dict(epochs=2, batch_size=16, lr=0.1, shuffle=False)
    cases = {
        "fedopt": lambda d: FedOptAPI(
            ds, create_model("lr", ds.class_num, input_shape=(20,)),
            device=d, config=FedOptConfig(
                comm_round=1, client_num_per_round=4, prefetch_depth=0,
                server_optimizer="adam", server_lr=0.01,
                train=TrainConfig(**tc))),
        "fednova": lambda d: FedNovaAPI(
            ds, create_model("lr", ds.class_num, input_shape=(20,)),
            device=d, config=FedNovaConfig(
                comm_round=1, client_num_per_round=4, gmf=0.5, mu=0.01,
                train=TrainConfig(momentum=0.9, **tc))),
        "robust_median": lambda d: FedAvgRobustAPI(
            ds, create_model("lr", ds.class_num, input_shape=(20,)),
            device=d, config=FedAvgRobustConfig(
                comm_round=1, client_num_per_round=5, prefetch_depth=0,
                defense_type="median", train=TrainConfig(**tc)))}
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name, make in cases.items():
            apis = [make(d) for d in ("cuda", "cpu")]
            if _max_diff(apis[0].variables, apis[1].variables) != 0:
                raise AssertionError(f"{name}: initial weights differ")
            for api in apis:
                api.run_round(0)
            state = [(a.variables, getattr(a, "server_opt_state", {}),
                      getattr(a, "momentum_buf", {})) for a in apis]
            out[name] = _max_diff(*state)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    bad = {k: v for k, v in out.items() if not v <= 1e-5}
    if bad:
        raise AssertionError(f"LR rounds card vs CPU: {bad}")
    log("LR rounds, card vs CPU (params and server state), max abs diff: "
        + ", ".join(f"{k} {v:.3g}" for k, v in out.items()) + " (atol 1e-5)")
    return out


# -- the cross-device anchors' models (phases 14-18) ------------------------

def _wmean_timed(c, d, gen, copies, iters):
    """The aggregation kernel at ``[c, d]`` against its plain version on
    one stack, then kernel, plain version and ``torch.mv`` timed over
    ``copies`` distinct stacks (the first phase's layout: row-padded
    views, sample counts 20..400)."""
    import torch
    from fedml_tpu_torch.ops.aggregate import (weighted_mean_flat,
                                               weighted_mean_flat_reference)

    def stack():
        buf = torch.randn(c, -(-d // 4) * 4, generator=gen, device="cuda")
        w = torch.randint(20, 401, (c,), generator=gen,
                          device="cuda").float()
        return buf[:, :d], w
    bufs = [stack() for _ in range(copies)]
    x, w = bufs[0]
    got = weighted_mean_flat(x, w)
    want = weighted_mean_flat_reference(x, w)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **TOL):
        raise AssertionError(f"wmean [{c}, {d}]: kernel disagrees with the "
                             f"plain version (max abs {err})")
    ms = cuda_time_ms(weighted_mean_flat, bufs, iters)
    plain_ms = cuda_time_ms(weighted_mean_flat_reference, bufs, iters)
    library_ms = cuda_time_ms(lambda x, w: torch.mv(x.t(), w / w.sum()),
                              bufs, iters)
    nbytes = 4 * (c * d + c + d)
    flops = 2 * c * d
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= flops / F32_FLOP_PER_S else "operations")
    del bufs
    torch.cuda.empty_cache()
    log(f"wmean [{c}, {d}]: kernel == plain (max abs {err:.3g}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.mv {library_ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.0f}% of it)")
    return {"shape": [c, d], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}


def phase_anchor_kernel():
    """The aggregation kernel at the anchors' D: ResNet-18-GN, ResNet-56
    (its params and BN statistics) and the StackOverflow LSTM."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    out = {}
    for name, d in ANCHOR_D.items():
        # distinct stacks past the 50 MB L2: 4 of the small ones, 2 of the
        # 449 MB ResNet-18-GN stack
        copies = 2 if d > 5_000_000 else 4
        out[name] = _wmean_timed(HEADLINE[0], d, gen, copies,
                                 40 if d > 5_000_000 else 200)
    return out


def _anchor_parts(flags):
    """Dataset, model, task and TrainConfig from a path's flags, built once
    for the APIs a phase drives directly."""
    from fedml_tpu_torch.experiments import main_fedavg
    args = main_fedavg.add_federated_args(
        argparse.ArgumentParser()).parse_args(flags)
    ds, model, task = main_fedavg.build_dataset_and_model(args)
    return ds, model, task, main_fedavg.make_train_config(args)


def _deterministic(fn):
    """``fn()`` with cuDNN's deterministic algorithms, so that two runs of
    the same convolutions give the same bits."""
    import torch
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic = saved


def _fused_vs_host(parts, rounds, make_api=None):
    """The same cohorts through the host loop and one fused block; the
    largest difference of their variables (params and BN statistics) and
    the two APIs."""
    make_api = make_api or _main_api

    def run():
        host, fused_api = (make_api(parts, rounds) for _ in range(2))
        for r in range(rounds):
            host.run_round(r)
        fused_api.fused_rounds().run_rounds(0, rounds)
        return _max_diff(host.variables, fused_api.variables), host
    return _deterministic(run)


def _anchor_timing(parts, label, rounds=ANCHOR_R, reps=3):
    """rounds/s of the host loop and of fused blocks of ``rounds`` rounds
    (median and spread of ``reps`` runs over the same rounds), device ms a
    round and launch calls under the profiler (the host round's of the CUDA
    activity alone), the busy share, and each graph's capture time and
    pool."""
    from fedml_tpu_torch.ops import aggregate

    span = range(1, 1 + rounds)
    host = _main_api(parts, 1 + rounds)
    host.run_round(0)
    host_rps = _rounds_per_s(lambda: [host.run_round(r) for r in span],
                             rounds, reps)
    t = time.perf_counter()
    host_prof = _profile(lambda: host.run_round(1), 1, cpu_ops=False)
    host_prof["profile_s"] = time.perf_counter() - t
    api = _main_api(parts, 1 + rounds)
    fused = api.fused_rounds()
    fused.run_rounds(1, rounds)  # captures every pad bucket's graph
    fused_rps = _rounds_per_s(lambda: fused.run_rounds(1, rounds), rounds,
                              reps)
    before = aggregate.weighted_mean_flat.launches
    fused_prof = _profile(lambda: fused.run_rounds(1, rounds), rounds)
    driver = aggregate.weighted_mean_flat.launches - before
    if not fused_prof["wmean_kernels"] == driver == rounds:
        raise AssertionError(
            f"{label}: a profiled fused block of {rounds} rounds: the "
            f"profiler saw {fused_prof['wmean_kernels']} aggregation "
            f"kernels, the driver counted {driver} "
            f"({_device_events(fused_prof)})")
    graphs = [{"capture_s": g.capture_s, "pool_bytes": g.pool_bytes}
              for g in fused.graphs.values()]
    out = {"rounds_per_s": host_rps, **host_prof,
           "busy_share": host_prof["device_ms_per_round"]
           * host_rps["median"] / 1e3,
           "fused": {"rounds_per_s": fused_rps, **fused_prof,
                     "busy_share": fused_prof["device_ms_per_round"]
                     * fused_rps["median"] / 1e3, "graphs": graphs}}
    for name, rec in (("host loop", out), ("fused", out["fused"])):
        rps = rec["rounds_per_s"]
        log(f"{label} {name}: {rps['median']:.3f} rounds/s (min "
            f"{rps['min']:.3f}, max {rps['max']:.3f}, {reps} runs of "
            f"{rounds} rounds); device {rec['device_ms_per_round']:.2f} ms a "
            f"round, busy {100 * rec['busy_share']:.1f}%; launch calls a "
            f"round {rec['launch_calls_per_round']}")
    log(f"{label}: the host round's profile took "
        f"{host_prof['profile_s']:.1f} s; fused graphs (capture s, pool "
        "MiB): "
        + ", ".join(f"({g['capture_s']:.2f}, {g['pool_bytes'] / 2**20:.0f})"
                    for g in graphs))
    return out


def _path_runs(module, name, flags, rounds, freq, fused_rounds,
               falls=True):
    """The path through ``module.main`` (``main_fedavg`` or ``fed_launch``):
    ``rounds`` host-loop rounds, then as many in fused blocks of
    ``fused_rounds``; one aggregation launch a round, and one more a
    capture's warm-up round (the capture itself launches nothing)."""
    out = {}
    evals = sorted(set(range(0, rounds, freq)) | {rounds - 1})
    for label, extra in (("host", []),
                         ("fused", ["--fused_rounds", str(fused_rounds)])):
        _, launches, captures, recs, wall = _launch_run(
            module, flags + extra + [
                "--comm_round", str(rounds), "--frequency_of_the_test",
                str(freq)], f"chip_smoke_{name}_{label}")
        if (label == "fused") != bool(captures) or \
                launches != rounds + captures:
            raise AssertionError(f"{name} {label}: {launches} aggregation "
                                 f"launches in {rounds} rounds and "
                                 f"{captures} captures")
        _check_evals(f"{name} {label}", recs, evals, falls)
        out[label] = {"launches": launches, "captures": captures,
                      "evals": recs, "wall_s": wall}
        log(f"{name} {label} through {module.__name__.split('.')[-1]}: "
            f"{rounds} rounds, "
            f"{captures} captures, {launches} aggregation launches, test "
            f"loss {recs[0]['test_loss']:.4f} -> {recs[-1]['test_loss']:.4f}"
            f", acc {recs[-1]['test_acc']:.4f} (wall {wall:.1f}s with data "
            "build, capture and eval)")
    return out


def phase_resnet18_gn_path():
    """ResNet-18-GN on fed_cifar100_gen at full width (11,220,132
    parameters, 500 clients, 10 a round, batch 20, lr 0.1): host loop and
    fused blocks through main_fedavg, a fused block against the host loop,
    rounds/s."""
    from fedml_tpu_torch.experiments import main_fedavg
    out = _path_runs(main_fedavg, "resnet18_gn", R18_FLAGS, 3, 2, ANCHOR_R)
    parts = _anchor_parts(R18_FLAGS)
    diff, _ = _fused_vs_host(parts, ANCHOR_R)
    if not diff <= 1e-6:
        raise AssertionError(f"resnet18_gn fused block vs host loop: {diff}")
    log(f"resnet18_gn fused block == host loop over {ANCHOR_R} rounds: max "
        f"abs diff {diff:.3g} (bound 1e-6)")
    out.update(fused_vs_host_max_abs_diff=diff,
               timing=_anchor_timing(parts, "resnet18_gn"))
    return out


def _stats_of(variables):
    return {k: v for k, v in variables.items() if "running_" in k}


def phase_resnet56_path():
    """ResNet-56 with its BN statistics on img_blob through main_fedavg
    (host loop and fused), the statistics moving in a round, a fused block
    against the host loop (params and statistics), and FedOpt-adam through
    fed_launch with the statistics at the plain average."""
    from fedml_tpu_torch.experiments import fed_launch, main_fedavg
    out = _path_runs(main_fedavg, "resnet56", IMG_FLAGS, 2, 1, ANCHOR_R,
                     falls=False)
    parts = _anchor_parts(IMG_FLAGS)
    diff, host = _fused_vs_host(parts, ANCHOR_R)
    start = _stats_of(_main_api(parts, 1).variables)
    moved = min(float((host.variables[k] - v).abs().max())
                for k, v in start.items())
    if not diff <= 1e-6 or not moved > 0:
        raise AssertionError(f"resnet56: fused vs host loop {diff}, the "
                             f"least-moved BN statistic {moved}")
    log(f"resnet56: {len(start)} BN statistics, each moved over the rounds "
        f"(least by {moved:.3g}); fused block == host loop over {ANCHOR_R} "
        f"rounds, params and statistics: max abs diff {diff:.3g} (bound "
        "1e-6)")
    _, launches, _, recs, wall = _launch_run(fed_launch, [
        "--algo", "fedopt", *IMG_FLAGS, "--server_optimizer", "adam",
        "--server_lr", str(FEDOPT_LR), "--comm_round", "2",
        "--frequency_of_the_test", "1"], "chip_smoke_resnet56_fedopt")
    if launches != 2:
        raise AssertionError(f"resnet56 fedopt: {launches} launches")
    _check_evals("resnet56 fedopt", recs, [0, 1], falls=False)

    def one_round():
        apis = [_fedopt_api(parts, 1), _main_api(parts, 1)]
        for api in apis:
            api.run_round(0)
        return [a.variables for a in apis]
    opt_vars, avg_vars = _deterministic(one_round)
    stats_diff = _max_diff(_stats_of(opt_vars), _stats_of(avg_vars))
    params_diff = max(float((opt_vars[k] - avg_vars[k]).abs().max())
                      for k in opt_vars if "running_" not in k)
    if not stats_diff <= 1e-6 or not params_diff > 0:
        raise AssertionError(f"resnet56 fedopt: stats {stats_diff} from "
                             f"the plain average, params {params_diff}")
    log(f"resnet56 fedopt-adam through fed_launch: 2 rounds, {launches} "
        f"aggregation launches; after a round its BN statistics lie "
        f"{stats_diff:.3g} from FedAvg's plain average (bound 1e-6), its "
        f"params {params_diff:.3g} (the server's step)")
    out.update(fused_vs_host_max_abs_diff=diff, least_stat_move=moved,
               fedopt={"launches": launches, "evals": recs, "wall_s": wall,
                       "stats_vs_plain_average": stats_diff,
                       "params_vs_fedavg": params_diff},
               timing=_anchor_timing(parts, "resnet56", rounds=1, reps=1))
    return out


def _launch_calls(fn, cpu_ops=True) -> int:
    """Launch calls (kernels, copies, memsets) of one ``fn()`` on the card,
    under the profiler, after one warm-up call; ``cpu_ops=False`` traces
    the CUDA activity alone (the runtime's calls and the kernels), for a
    call of tens of thousands of launches."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    acts = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu_ops
            else [ProfilerActivity.CUDA])
    with _profile_window(acts) as prof:
        fn()
        torch.cuda.synchronize()
    # the raw events, as _profile counts them (key_averages() is slow)
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                               "cudaMemcpyAsync", "cudaMemsetAsync"))


def _step_launches(parts):
    """Launch calls of one train step of a path's model (a batch of its
    first client, on the card), under the profiler: a captured round holds
    about that many graph nodes for each of its gated steps."""
    import torch
    from fedml_tpu_torch.trainer.functional import (make_train_step,
                                                    param_names)
    ds, model, task, tc = parts
    init, step = make_train_step(model, task, tc)
    x, y, mask = (torch.from_numpy(a[0, :tc.batch_size]).cuda() for a in
                  ds.pack_clients([0], tc.batch_size))
    sd = {k: v.detach().cuda() for k, v in model.state_dict().items()}
    trained = param_names(model)
    names = [k for k in sd if k in trained]
    params = [sd[k] for k in names]
    colls = {k: v for k, v in sd.items() if k not in trained}
    gate = torch.ones((), dtype=torch.bool, device="cuda")
    return _launch_calls(lambda: step(
        names, params, colls, init(params), x, y, mask,
        torch.zeros((), dtype=torch.int64, device="cuda"), has_real=gate))


def _gated_steps(api, r0):
    """The gated steps of round ``r0``'s fused body (every client's
    ``epochs * nb`` at the round's pad bucket)."""
    return int(api.fused_rounds()._block_inputs(r0, 1)["plan"]
               .has_real.numel())


def phase_lstm_paths():
    """The char LSTM on shakespeare_gen (715 clients) and the StackOverflow
    LSTM on stackoverflow_nwp_gen (cut to SO_CLIENTS clients) at full
    width through main_fedavg: 2 host-loop rounds each, one launch a round,
    a falling test loss; a fused block of the StackOverflow LSTM against
    its host loop, with its graph's capture time and size."""
    from fedml_tpu_torch.experiments import main_fedavg
    out = {}
    for name, flags in (("shakespeare", SH_FLAGS),
                        ("stackoverflow", SO_FLAGS)):
        _, launches, _, recs, wall = _launch_run(
            main_fedavg, flags + ["--comm_round", "2",
                                  "--frequency_of_the_test", "1"],
            f"chip_smoke_{name}")
        if launches != 2:
            raise AssertionError(f"{name}: {launches} launches in 2 rounds")
        _check_evals(name, recs, [0, 1])
        out[name] = {"launches": launches, "evals": recs, "wall_s": wall}
        log(f"{name} LSTM through main_fedavg: 2 rounds, {launches} "
            f"aggregation launches, test loss {recs[0]['test_loss']:.4f} -> "
            f"{recs[-1]['test_loss']:.4f}, acc {recs[-1]['test_acc']:.4f} "
            f"(wall {wall:.1f}s with data build and eval)")
    log(f"stackoverflow_nwp_gen cut from 342,477 to {SO_CLIENTS} clients "
        "(host memory and build time); widths full: LSTM 670, vocab 10,004")
    for name, flags in (("shakespeare", SH_FLAGS),
                        ("stackoverflow", SO_FLAGS)):
        parts = _anchor_parts(flags)
        per_step = _step_launches(parts)
        api = _main_api(parts, 2)
        steps = _gated_steps(api, 1)
        out[name].update(launches_per_step=per_step, gated_steps=steps,
                         graph_nodes_estimate=per_step * steps)
        log(f"{name}: {per_step} launch calls a train step; round 1's fused "
            f"body gates {steps} steps, so its graph would hold about "
            f"{per_step * steps} nodes")
        if name == "shakespeare":
            # its first round: the path's runs above already ran the model
            rps = _rounds_per_s(lambda: api.run_round(0), 1, reps=1)
            out[name]["host_rounds_per_s"] = rps
            log(f"shakespeare host loop: {rps['median']:.3f} rounds/s (one "
                "run of round 0); it is not captured (T = 80, two "
                "layers)")
    so = _anchor_parts(SO_FLAGS)
    diff, _ = _fused_vs_host(so, ANCHOR_R)
    if not diff <= 1e-6:
        raise AssertionError(f"stackoverflow fused block vs host loop: "
                             f"{diff}")
    log(f"stackoverflow fused block == host loop over {ANCHOR_R} rounds "
        f"(T = 21): max abs diff {diff:.3g} (bound 1e-6)")
    out["stackoverflow"].update(
        fused_vs_host_max_abs_diff=diff,
        timing=_anchor_timing(so, "stackoverflow LSTM", rounds=1, reps=1))
    return out


def _cpu_drift(ds, make, cfg, api_cls):
    """How far one CPU round moves from a 1e-7 relative perturbation of its
    params: the round's own sensitivity, the scale of a card-vs-CPU
    difference that comes from rounding alone. ``api_cls(ds, model,
    config=, device=)`` builds the round's API."""
    import torch
    apis = [api_cls(ds, make(), config=cfg, device="cpu") for _ in range(2)]
    gen = torch.Generator().manual_seed(18)
    apis[1].variables = {
        k: v if "running_" in k else
        v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
        for k, v in apis[1].variables.items()}
    for api in apis:
        api.run_round(0)
    return _max_diff(apis[0].variables, apis[1].variables)


def phase_anchor_card_vs_cpu():
    """One round of each new model at a cut size on the card and on the
    CPU from the same weights (TF32 off): params and BN statistics, beside
    the CPU round's own drift under a 1e-7 relative perturbation. The
    ResNet-56 cut is one bottleneck block a stage at batch 10: deeper or
    at batch 4, a BN round at lr 0.1 is chaotic (batch statistics of a
    few values a channel), and its drift reaches the bound."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.data.flagship_gen import \
        build_stackoverflow_nwp_federation
    from fedml_tpu_torch.data.leaf_gen import build_shakespeare_federation
    from fedml_tpu_torch.data.synthetic import make_image_blob_federated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.resnet import CifarResNet
    from fedml_tpu_torch.models.resnet_gn import ResNetGN
    from fedml_tpu_torch.trainer.functional import TrainConfig

    img = make_image_blob_federated(client_num=4, samples_per_client=12,
                                    image_size=16, seed=1)
    sh = build_shakespeare_federation(client_num=4, max_windows=24)
    so = build_stackoverflow_nwp_federation(client_num=40, vocab_size=200)
    image, tokens = dict(batch_size=10, lr=0.05), dict(batch_size=4, lr=0.1)
    cases = {
        "resnet18_gn": (img, lambda: ResNetGN([1, 1, 1, 1], img.class_num),
                        "classification", image),
        "resnet56": (img, lambda: CifarResNet([1, 1, 1], img.class_num),
                     "classification", image),
        "rnn_seq": (sh, lambda: create_model("rnn_seq", sh.class_num,
                                             hidden_size=64), "nwp",
                    tokens),
        "rnn_stackoverflow": (so, lambda: create_model(
            "rnn_stackoverflow", vocab_size=200, latent_size=64,
            embedding_size=32), "nwp", tokens)}
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name, (ds, make, task, tc) in cases.items():
            cfg = FedAvgConfig(comm_round=1, client_num_per_round=4,
                               prefetch_depth=0, train=TrainConfig(
                                   epochs=1, shuffle=False, **tc))
            apis = [FedAvgAPI(ds, make(), task=task, config=cfg, device=d)
                    for d in ("cuda", "cpu")]
            if _max_diff(apis[0].variables, apis[1].variables) != 0:
                raise AssertionError(f"{name}: initial weights differ")
            for api in apis:
                api.run_round(0)
            out[name] = {
                "params": _max_diff(
                    *({k: v for k, v in a.variables.items()
                       if "running_" not in k} for a in apis)),
                "stats": (_max_diff(*(_stats_of(a.variables) for a in apis))
                          if _stats_of(apis[1].variables) else None),
                "cpu_drift_1e-7": _cpu_drift(
                    ds, make, cfg, functools.partial(FedAvgAPI, task=task))}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    bad = {k: v for k, v in out.items()
           if not all(v[f] is None or v[f] <= ANCHOR_CPU_ATOL
                      for f in ("params", "stats"))}
    if bad:
        raise AssertionError(f"anchor rounds card vs CPU: {bad}")
    log("one round of each anchor model, card vs CPU (TF32 off), max abs "
        "diff of params / BN statistics (the CPU round's drift from a 1e-7 "
        "perturbation): " + ", ".join(
            f"{k} {v['params']:.3g} / "
            + ("-" if v["stats"] is None else f"{v['stats']:.3g}")
            + f" ({v['cpu_drift_1e-7']:.3g})"
            for k, v in out.items()) + f" (atol {ANCHOR_CPU_ATOL})")
    return out

# -- the rest of the CV zoo and FedSeg (phases 19-22) ------------------------

def phase_zoo_kernel():
    """The aggregation kernel at the zoo's D (each checked against its
    model's state dict), against its plain version, timed beside it and
    torch.mv at 10 clients."""
    import torch
    from fedml_tpu_torch.models import create_model
    for name, d in ZOO_D.items():
        model, classes = {"vgg11_10": ("vgg11", 10),
                          "vgg11_img_blob": ("vgg11", 4),
                          "segnet": ("segnet", 3)}.get(name, (name, 100))
        with torch.device("meta"):
            sd = create_model(model, classes).state_dict()
        if sum(v.numel() for v in sd.values()) != d:
            raise AssertionError(f"{name}: D {d} is not its model's")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    return {name: _wmean_timed(HEADLINE[0], d, gen,
                               2 if d > 5_000_000 else 4,
                               40 if d > 5_000_000 else 200)
            for name, d in ZOO_D.items()}


def phase_mobilenet_path():
    """The slice's main path: FedAvg on MobileNet v1 (width 1.0, 100
    classes) on fed_cifar100_gen through main_fedavg, host loop and fused
    blocks; a fused block against the host loop (params and BN statistics,
    cuDNN deterministic, timed), the statistics moving, rounds/s."""
    from fedml_tpu_torch.experiments import main_fedavg
    flags = ZOO_FLAGS["mobilenet"]
    out = _path_runs(main_fedavg, "mobilenet", flags, 3, 2, ZOO_R,
                     falls=False)
    parts = _anchor_parts(flags)
    t = time.perf_counter()
    diff, host = _fused_vs_host(parts, ZOO_R)
    check_s = time.perf_counter() - t
    start = _stats_of(_main_api(parts, 1).variables)
    moved = min(float((host.variables[k] - v).abs().max())
                for k, v in start.items())
    if not diff <= 1e-6 or not moved > 0:
        raise AssertionError(f"mobilenet: fused vs host loop {diff}, the "
                             f"least-moved BN statistic {moved}")
    log(f"mobilenet: {len(start)} BN statistics, each moved over the rounds "
        f"(least by {moved:.3g}); fused block == host loop over {ZOO_R} "
        f"rounds, params and statistics: max abs diff {diff:.3g} (bound "
        f"1e-6; the check under cuDNN's deterministic algorithms took "
        f"{check_s:.1f} s)")
    out.update(fused_vs_host_max_abs_diff=diff, least_stat_move=moved,
               deterministic_check_s=check_s,
               timing=_anchor_timing(parts, "mobilenet", rounds=1))
    return out


def phase_zoo_models():
    """MobileNetV3-LARGE and EfficientNet-b0 (fed_cifar100_gen) and VGG-11
    (img_blob) at full width through main_fedavg: 2 host rounds and a
    fused block of 2 each, EfficientNet's fused block against its host
    loop with drop-connect and dropout on, one timed run each; then
    hierarchical FedAvg and TurboAggregate on MobileNet through
    fed_launch."""
    from fedml_tpu_torch.experiments import fed_launch, main_fedavg
    out = {}
    for name in ("mobilenet_v3", "vgg11", "efficientnet-b0"):
        flags = ZOO_FLAGS[name]
        out[name] = _path_runs(main_fedavg, name, flags, ZOO_R, 1, ZOO_R,
                               falls=False)
        parts = _anchor_parts(flags)
        if name == "efficientnet-b0":
            t = time.perf_counter()
            diff, _ = _fused_vs_host(parts, ZOO_R)
            check_s = time.perf_counter() - t
            if not diff <= 1e-6:
                raise AssertionError(f"efficientnet-b0 fused block vs host "
                                     f"loop (drop-connect on): {diff}")
            log(f"efficientnet-b0 fused block == host loop over {ZOO_R} "
                f"rounds with drop-connect and dropout on: max abs diff "
                f"{diff:.3g} (bound 1e-6; {check_s:.1f} s)")
            out[name].update(fused_vs_host_max_abs_diff=diff,
                             deterministic_check_s=check_s)
        out[name]["timing"] = _round_timing(parts, name)
    flags = ZOO_FLAGS["mobilenet"] + ["--comm_round", str(ZOO_R),
                                      "--frequency_of_the_test", "1"]
    for algo, extra, launches in (
            ("hierarchical", ["--group_num", "2", "--group_comm_round", "2"],
             _hierarchical_launches(0, 2, 2, ZOO_R, n=500)),
            ("turboaggregate", [], 0)):
        final, got, _, recs, wall = _launch_run(
            fed_launch, ["--algo", algo, *flags, *extra],
            f"chip_smoke_mobilenet_{algo}")
        if got != launches:
            raise AssertionError(f"mobilenet {algo}: {got} aggregation "
                                 f"launches, want {launches}")
        _check_evals(f"mobilenet {algo}", recs, list(range(ZOO_R)),
                     falls=False)
        out[f"mobilenet_{algo}"] = {"launches": got, "evals": recs,
                                    "wall_s": wall}
        log(f"mobilenet {algo} through fed_launch: {ZOO_R} rounds, {got} "
            f"aggregation launches, test loss {recs[0]['test_loss']:.4f} -> "
            f"{recs[-1]['test_loss']:.4f} (wall {wall:.1f}s)")
    return out


def _round_timing(parts, label):
    """One host round and one fused round of a model at a cut cost: the
    host round's and the fused round's wall (host clock around a
    synchronized round; the kernels' algorithms are already chosen by the
    path's runs), the fused round's device ms by CUDA events around one
    replay of its graph (median of 3; the round is device-bound, so the
    events hold its device time), the graph's capture time and pool, and
    the launch calls of one train step (every client holds whole batches
    here, so a host round makes about that many times its real steps)."""
    import torch
    api = _main_api(parts, 4)
    torch.cuda.synchronize()
    t = time.perf_counter()
    api.run_round(0)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    fused = api.fused_rounds()
    fused.run_rounds(1, 1)  # captures the round's graph
    t = time.perf_counter()
    fused.run_rounds(2, 1)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t
    block = fused._block_inputs(3, 1)
    fused._run_graph(block, 1)  # captures a new pad bucket's graph, if any
    replay_ms = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        fused._run_graph(block, 1)
        end.record()
        end.synchronize()
        replay_ms.append(start.elapsed_time(end))
    graphs = [{"capture_s": g.capture_s, "pool_bytes": g.pool_bytes}
              for g in fused.graphs.values()]
    out = {"host_rounds_per_s": 1 / host_s,
           "fused_rounds_per_s": 1 / fused_s,
           "fused_device_ms_per_round": sorted(replay_ms)[1],
           "launches_per_step": _step_launches(parts), "graphs": graphs}
    log(f"{label}: host loop {out['host_rounds_per_s']:.3f} rounds/s, fused "
        f"{out['fused_rounds_per_s']:.3f} rounds/s (one round each); a "
        f"replay {out['fused_device_ms_per_round']:.2f} ms on the device; "
        f"{out['launches_per_step']} launch calls a train step; graphs "
        "(capture s, pool MiB): "
        + ", ".join(f"({g['capture_s']:.2f}, {g['pool_bytes'] / 2**20:.0f})"
                    for g in graphs))
    return out


def phase_fedseg_path():
    """FedSeg: SegNet (width 32) on seg_shapes through ``fed_launch.main
    --algo fedseg`` under each loss, 3 rounds: one launch a round, finite
    IoU metrics, a falling test loss."""
    from fedml_tpu_torch.experiments import fed_launch
    out = {}
    for loss in ("ce", "focal"):
        final, got, _, recs, wall = _launch_run(fed_launch, [
            *SEG_FLAGS, "--seg_loss", loss, "--comm_round", "3",
            "--frequency_of_the_test", "2"], f"chip_smoke_fedseg_{loss}")
        if got != 3:
            raise AssertionError(f"fedseg {loss}: {got} launches in 3 rounds")
        _check_evals(f"fedseg {loss}", recs, [0, 2])
        for r in recs:
            for k in ("test_mIoU", "test_FWIoU", "test_acc_class"):
                if not math.isfinite(r[k]):
                    raise AssertionError(f"fedseg {loss}: {k}={r[k]}")
        out[loss] = {"launches": got, "evals": recs, "wall_s": wall}
        log(f"fedseg ({loss}) through fed_launch: 3 rounds, {got} "
            f"aggregation launches, test loss {recs[0]['test_loss']:.4f} -> "
            f"{recs[-1]['test_loss']:.4f}, mIoU {recs[-1]['test_mIoU']:.4f}, "
            f"FWIoU {recs[-1]['test_FWIoU']:.4f}, class acc "
            f"{recs[-1]['test_acc_class']:.4f} (wall {wall:.1f}s)")
    return out


def _zoo_cut_cases():
    """name -> (dataset, model factory, API factory, TrainConfig fields)
    of one cut round of each zoo model (phase 22's card-vs-CPU check)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.fedseg import FedSegAPI
    from fedml_tpu_torch.data.synthetic import (make_image_blob_federated,
                                                make_shapes_segmentation)
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.mobilenet import MobileNet
    from fedml_tpu_torch.models.mobilenet_v3 import MobileNetV3
    from fedml_tpu_torch.models.segnet import SegNet

    img = make_image_blob_federated(client_num=4, samples_per_client=12,
                                    seed=1)
    seg = make_shapes_segmentation(client_num=4, samples_per_client=8)
    fedavg = functools.partial(FedAvgAPI, task="classification")
    image = dict(batch_size=12, lr=0.01)
    # MobileNet v1 (27 BN + ReLU layers, no residual) has a chaotic
    # gradient at init, so its round steps at lr 3e-4 to keep the CPU's
    # own drift (printed beside) under the bound
    return {
        "mobilenet": (img, lambda: MobileNet(img.class_num, 0.25), fedavg,
                      dict(image, lr=3e-4)),
        "mobilenet_v3": (img, lambda: MobileNetV3(img.class_num,
                                                  multiplier=0.25),
                         fedavg, image),
        "vgg11": (img, lambda: create_model("vgg11", img.class_num),
                  fedavg, image),
        "efficientnet-b0": (img, lambda: create_model(
            "efficientnet-b0", img.class_num), fedavg, image),
        "segnet": (seg, lambda: SegNet(3, 8), FedSegAPI,
                   dict(batch_size=8, lr=0.1))}


def phase_zoo_card_vs_cpu():
    """One round of each zoo model at a cut size on the card and on the CPU
    from the same weights (TF32 off): params and BN statistics against
    ANCHOR_CPU_ATOL, beside the CPU round's own drift."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.trainer.functional import TrainConfig

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name, (ds, make, api_cls, tc) in _zoo_cut_cases().items():
            cfg = FedAvgConfig(comm_round=1, client_num_per_round=4,
                               prefetch_depth=0, train=TrainConfig(
                                   epochs=1, shuffle=False, **tc))
            apis = [api_cls(ds, make(), config=cfg, device=d)
                    for d in ("cuda", "cpu")]
            if _max_diff(apis[0].variables, apis[1].variables) != 0:
                raise AssertionError(f"{name}: initial weights differ")
            for api in apis:
                api.run_round(0)
            out[name] = {
                "params": _max_diff(
                    *({k: v for k, v in a.variables.items()
                       if "running_" not in k} for a in apis)),
                "stats": (_max_diff(*(_stats_of(a.variables) for a in apis))
                          if _stats_of(apis[1].variables) else None),
                "cpu_drift_1e-7": _cpu_drift(ds, make, cfg, api_cls)}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    bad = {k: v for k, v in out.items()
           if not all(v[f] is None or v[f] <= ANCHOR_CPU_ATOL
                      for f in ("params", "stats"))}
    if bad:
        raise AssertionError(f"zoo rounds card vs CPU: {bad}")
    log("one round of each zoo model, card vs CPU (TF32 off), max abs "
        "diff of params / BN statistics (the CPU round's drift from a 1e-7 "
        "perturbation): " + ", ".join(
            f"{k} {v['params']:.3g} / "
            + ("-" if v["stats"] is None else f"{v['stats']:.3g}")
            + f" ({v['cpu_drift_1e-7']:.3g})"
            for k, v in out.items()) + f" (atol {ANCHOR_CPU_ATOL})")
    return out


# -- split learning, vertical FL, FedGKT and FedNAS (phases 23-26) ----------

class _Watch:
    """Wrap ``cls.run_round`` while a path runs: each call's API, round,
    whether the API held server logits when it began (FedGKT's
    distillation switch), and its wall time, synchronized."""

    def __init__(self, cls, flag=None):
        self.cls, self.flag, self.calls = cls, flag, []

    def __enter__(self):
        import torch
        orig = self.orig = self.cls.run_round

        def run_round(api, r, *a, **k):
            state = getattr(api, self.flag) if self.flag else None
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(api, r, *a, **k)
            torch.cuda.synchronize()
            self.calls.append({"api": api, "round": r, "flag": state,
                               "wall_s": time.perf_counter() - t})
            return out
        self.cls.run_round = run_round
        return self

    def __exit__(self, *exc):
        self.cls.run_round = self.orig


def _finite(name, rec):
    for k, v in rec.items():
        if isinstance(v, float) and not math.isfinite(v):
            raise AssertionError(f"{name}: {k}={v} in {rec}")


def phase_split_vertical_paths():
    """Vertical FL (a guest and two hosts, 2 epochs) and split learning (2
    rotations) on blob through ``fed_launch.main``: finite metrics, a
    falling train loss, no aggregation launch (neither averages)."""
    from fedml_tpu_torch.experiments import fed_launch
    out = {}
    for algo, extra, key in (
            ("vertical_fl", ["--party_num", "3"], "epoch"),
            ("split_nn", ["--lr", "0.01"], "rotation")):
        final, got, _, recs, wall = _launch_run(fed_launch, [
            "--algo", algo, "--dataset", "blob", "--comm_round", "2",
            "--device", "cuda", *extra], f"chip_smoke_{algo}")
        for r in recs:
            _finite(algo, r)
        losses = [r["train_loss"] for r in recs if key in r]
        if got != 0 or len(losses) != 2 or not losses[1] < losses[0]:
            raise AssertionError(f"{algo}: {got} aggregation launches, "
                                 f"train loss {losses}")
        out[algo] = {"launches": got, "train_loss": losses,
                     "test_acc": final["test_acc"], "wall_s": wall,
                     "rounds_per_s": 2 / wall}
        log(f"{algo} through fed_launch on blob: 2 {key}s, train loss "
            f"{losses[0]:.4f} -> {losses[1]:.4f}, test acc "
            f"{final['test_acc']:.4f}, {got} aggregation launches (wall "
            f"{wall:.1f}s with data build)")
    return out


def phase_fedgkt_path():
    """FedGKT on fed_cifar100_gen (10 clients, batch 20) through
    ``fed_launch.main --algo fedgkt``, full-width models (resnet8_56 and
    the 18-block resnet56_server), 2 rounds: distillation on in round 1,
    client weights that differ between clients, finite test accuracy and
    loss, no aggregation launch; each round's wall, and the launch calls
    of one server and one client train step."""
    import torch
    from fedml_tpu_torch.algorithms import fedgkt
    from fedml_tpu_torch.experiments import fed_launch
    with _Watch(fedgkt.FedGKTAPI, "_have_server_logits") as watch:
        final, got, _, recs, wall = _launch_run(fed_launch, [
            "--algo", "fedgkt", *GKT_FLAGS, "--comm_round", "2"],
            "chip_smoke_fedgkt")
    api = watch.calls[-1]["api"]
    kd = [c["flag"] for c in watch.calls]
    differ = not torch.equal(api.client_vars[0]["stem.weight"],
                             api.client_vars[1]["stem.weight"])
    for r in recs:
        _finite("fedgkt", r)
    if kd != [False, True] or not differ or got != 0 or not (
            math.isfinite(final["test_acc"])
            and math.isfinite(final["test_loss"])):
        raise AssertionError(f"fedgkt: distillation by round {kd}, client "
                             f"weights differ {differ}, {got} launches, "
                             f"final {final}")
    feats = api._sweep(api.client_module, api.client_vars[0], api._x[0])
    f, cl = feats[1], feats[0]
    yy, mm = api._y[0], api._mask[0]
    idx = torch.arange(api.cfg.batch_size, device="cuda")
    server_calls = _launch_calls(lambda: api.server_step(f, cl, yy, mm, idx))
    client_calls = _launch_calls(lambda: api.client_step(0, idx, 1.0))
    walls = [c["wall_s"] for c in watch.calls]
    out = {"launches": got, "distill_by_round": kd, "round_wall_s": walls,
           "rounds_per_s": len(walls) / sum(walls),
           "server_step_launch_calls": server_calls,
           "client_step_launch_calls": client_calls,
           "test_acc": final["test_acc"], "test_loss": final["test_loss"],
           "wall_s": wall}
    log(f"fedgkt through fed_launch on fed_cifar100_gen (10 clients, batch "
        f"20): 2 rounds of " + ", ".join(f"{w:.2f}" for w in walls)
        + f" s ({out['rounds_per_s']:.3f} rounds/s), distillation by round "
        f"{kd}, client weights differ, test acc {final['test_acc']:.4f} "
        f"loss {final['test_loss']:.4f}; launch calls of a server step "
        f"{server_calls}, of a client step {client_calls}")
    return out


def phase_fednas_path():
    """FedNAS on fed_cifar100_gen (10 clients of 80 rows) through
    ``fed_launch.main --algo fednas``: 2 rounds of darts and 1 of gdas at
    batch 40, 1 with ``--arch_unrolled`` and ``--nas_retrain_rounds 1`` at
    batch 80 (one step a client: its ~84k launch calls a step make a
    batch-40 round ~40 s, a third of the phases' time). The aggregation
    launches equal the rounds (search and retrain); the alphas move; the
    genotype prints. Then the kernel against its plain version at FedNAS's
    D (checked against the search network's state dict plus both alphas),
    timed beside the plain version and torch.mv, and the launch calls of
    one darts search step (a gdas step's differ by its sampled weights' few
    dozen; the unrolled step's ~84k took ~20 s to profile, past the
    phases' time)."""
    import numpy as np
    import torch
    from fedml_tpu_torch.algorithms import fednas
    from fedml_tpu_torch.experiments import fed_launch
    from fedml_tpu_torch.models.darts import DartsNetwork
    out = {}
    for label, extra, rounds, retrain in (
            ("darts", ["--comm_round", "2", "--batch_size", "40"], 2, 0),
            ("gdas", ["--comm_round", "1", "--batch_size", "40",
                      "--nas_variant", "gdas"], 1, 0),
            ("unrolled", ["--comm_round", "1", "--batch_size", "80",
                          "--arch_unrolled", "--nas_retrain_rounds", "1"],
             1, 1)):
        start = {}
        orig_init = fednas.FedNASAPI.__init__

        def init(api, *a, **k):
            orig_init(api, *a, **k)
            start.update({k: v.clone() for k, v in api.alphas.items()})
        fednas.FedNASAPI.__init__ = init
        try:
            with _Watch(fednas.FedNASAPI) as watch:
                final, got, _, recs, wall = _launch_run(fed_launch, [
                    "--algo", "fednas", *NAS_FLAGS, *extra],
                    f"chip_smoke_fednas_{label}")
        finally:
            fednas.FedNASAPI.__init__ = orig_init
        api = watch.calls[-1]["api"]
        moved = max(float((api.alphas[k] - v).abs().max())
                    for k, v in start.items())
        for r in recs:
            _finite(f"fednas {label}", r)
        if got != rounds + retrain or not moved > 0 or not \
                final["genotype"].startswith("Genotype(") or \
                not math.isfinite(final["test_acc"]) or (
                    retrain and not math.isfinite(
                        final["retrain_test_loss"])):
            raise AssertionError(f"fednas {label}: {got} aggregation "
                                 f"launches in {rounds} search + {retrain} "
                                 f"retrain rounds, alphas moved {moved}, "
                                 f"final {final}")
        walls = [c["wall_s"] for c in watch.calls]
        out[label] = {"launches": got, "alphas_moved": moved,
                      "round_wall_s": walls,
                      "rounds_per_s": len(walls) / sum(walls),
                      "genotype": final["genotype"],
                      "test_acc": final["test_acc"], "wall_s": wall}
        log(f"fednas {label} through fed_launch: {rounds} search round(s) "
            + ", ".join(f"{w:.2f}" for w in walls)
            + f" s ({out[label]['rounds_per_s']:.3f} rounds/s)"
            + (" + 1 retrain round" if retrain else "")
            + f", {got} aggregation launches, alphas moved by {moved:.3g}, "
            f"test acc {final['test_acc']:.4f}; genotype "
            f"{final['genotype']}")
        if label != "darts":
            continue
        # one search step on the card, its launch calls
        x, y, mask = (torch.as_tensor(a[0, :40], device="cuda") for a in
                      api.ds.pack_clients([0], 40))
        y, mask = y.long(), mask.float()
        names = [k for k in api.variables if k in api._trained]
        params = [api.variables[k] for k in names]
        colls = {k: v for k, v in api.variables.items()
                 if k not in api._trained}
        alphas = [api.alphas["normal"], api.alphas["reduce"]]
        u = (torch.rand((2,) + tuple(alphas[0].shape), device="cuda")
             .clamp_(min=1e-20))
        out[label]["search_step_launch_calls"] = _launch_calls(
            lambda: api.search_step(
                names, params, colls, alphas, api._opt_w.init(params),
                api._opt_a.init(alphas), (x, y, mask), (x, y, mask),
                u, u, 1.0), cpu_ops=False)
        log(f"fednas {label}: {out[label]['search_step_launch_calls']} "
            "launch calls a search step")
    with torch.device("meta"):
        sd = DartsNetwork(C=8, num_classes=100, layers=2).state_dict()
    d = sum(v.numel() for v in sd.values()) + 2 * int(np.prod(
        api.alphas["normal"].shape))
    if d != NAS_D:
        raise AssertionError(f"fednas: D {d} != {NAS_D}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    out["kernel"] = _wmean_timed(HEADLINE[0], NAS_D, gen, 16, 400)
    log(f"fednas: the aggregation kernel at FedNAS's D = {NAS_D} "
        f"(203,484 params + 11,760 BN statistics + 224 alphas)")
    return out


def _slice_f_cut_cases():
    """name -> run(device, perturb) -> {name: tensor} of one cut round of
    each algorithm from the same weights and orders on ``device``;
    ``perturb`` scales the CPU's float params by (1 + 1e-7 noise)."""
    import numpy as np
    import torch
    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI, FedGKTConfig
    from fedml_tpu_torch.algorithms.fednas import FedNASAPI, FedNASConfig
    from fedml_tpu_torch.algorithms.split_nn import SplitNNAPI, SplitNNConfig
    from fedml_tpu_torch.algorithms.vertical_fl import VFLConfig, build_vfl
    from fedml_tpu_torch.data.synthetic import (make_blob_federated,
                                                make_image_blob_federated)
    from fedml_tpu_torch.models.darts import DartsNetwork
    from fedml_tpu_torch.models.resnet_gkt import (ResNetClientGKT,
                                                   ResNetServerGKT)
    from fedml_tpu_torch.models.vfl import VFLDenseModel, VFLFeatureExtractor

    blob = make_blob_federated(client_num=3, seed=2, n_samples=300)
    img = make_image_blob_federated(client_num=3, samples_per_client=8,
                                    image_size=8, seed=3)
    gen = torch.Generator().manual_seed(26)

    def noisy(sd, perturb):
        return {k: v * (1 + 1e-7 * torch.randn(
            v.shape, generator=gen, dtype=v.dtype).to(v.device))
                if perturb and v.is_floating_point() and
                "running_" not in k else v for k, v in sd.items()}

    def vfl(dev, perturb):
        xg, yg = blob.train_data_global
        x = np.asarray(xg, np.float32)
        y = (np.asarray(yg) % 2).astype(np.float32)
        cuts = np.array_split(np.arange(x.shape[1]), 3)
        fx = build_vfl([len(c) for c in cuts], VFLConfig(
            epochs=1, batch_size=32, lr=0.05), device=dev)
        parties = [fx.fl.guest, *fx.fl.hosts]
        for p in parties:
            for m in (p.local, p.dense):
                m.load_state_dict(noisy(m.state_dict(), perturb))
        fx.fit([x[:, c] for c in cuts], y, [x[:16, c] for c in cuts],
               y[:16])
        return {f"{i}.{n}.{k}": v for i, p in enumerate(parties)
                for n, m in (("local", p.local), ("dense", p.dense))
                for k, v in m.state_dict().items()}

    def split(dev, perturb):
        api = SplitNNAPI(blob, VFLFeatureExtractor(20, (64, 32)),
                         VFLDenseModel(32, blob.class_num),
                         config=SplitNNConfig(batch_size=16, lr=0.01),
                         device=dev)
        api.bottom_params = [noisy(p, perturb) for p in api.bottom_params]
        api.top_params = noisy(api.top_params, perturb)
        api.train_one_rotation(0)
        return {**{f"bottom{c}.{k}": v for c, p in
                   enumerate(api.bottom_params) for k, v in p.items()},
                **{f"top.{k}": v for k, v in api.top_params.items()}}

    def gkt(dev, perturb):
        api = FedGKTAPI(img, ResNetClientGKT(1, img.class_num),
                        ResNetServerGKT((1, 1), img.class_num),
                        FedGKTConfig(batch_size=4), device=dev)
        api.client_vars = [noisy(v, perturb) for v in api.client_vars]
        api.server_vars = noisy(api.server_vars, perturb)
        for r in range(2):  # the second round distills
            api.run_round(r)
        return {**{f"client{c}.{k}": v for c, p in
                   enumerate(api.client_vars) for k, v in p.items()},
                **{f"server.{k}": v for k, v in api.server_vars.items()}}

    def nas(**kw):
        """FedNAS's round under ``kw``: darts, gdas (the straight-through
        sample from the same CPU-drawn uniforms) or ``arch_unrolled`` (the
        double backward through the virtual step); one node a cell, which
        still runs every primitive in a normal and two reduction cells."""
        def run(dev, perturb):
            api = FedNASAPI(img, DartsNetwork(C=4, num_classes=img.class_num,
                                              layers=3, steps=1,
                                              multiplier=1),
                            FedNASConfig(batch_size=4, lr=0.01, **kw),
                            device=dev)
            api.variables = noisy(api.variables, perturb)
            api.run_round(0)
            return {**api.variables,
                    **{f"alphas.{k}": v for k, v in api.alphas.items()}}
        return run

    return {"vertical_fl": vfl, "split_nn": split, "fedgkt": gkt,
            "fednas": nas(), "fednas_gdas": nas(variant="gdas"),
            "fednas_unrolled": nas(arch_unrolled=True)}


def phase_slice_f_card_vs_cpu():
    """One cut round of each of the four algorithms (FedNAS under darts,
    gdas and ``arch_unrolled``; FedGKT two rounds, the second distilling)
    on the card and on
    the CPU from the same weights and orders (TF32 off): params, BN
    statistics and alphas against ANCHOR_CPU_ATOL, beside the CPU round's
    own drift from a 1e-7 relative perturbation of its params."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name, run in _slice_f_cut_cases().items():
            t0 = time.perf_counter()
            card, cpu = run("cuda", False), run("cpu", False)
            stats = {k for k in cpu if "running_" in k}
            out[name] = {
                "params": _max_diff({k: v for k, v in card.items()
                                     if k not in stats},
                                    {k: v for k, v in cpu.items()
                                     if k not in stats}),
                "stats": (_max_diff({k: card[k] for k in sorted(stats)},
                                    {k: cpu[k] for k in sorted(stats)})
                          if stats else None),
                "cpu_drift_1e-7": _max_diff(cpu, run("cpu", True))}
            out[name]["wall_s"] = time.perf_counter() - t0
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    bad = {k: v for k, v in out.items()
           if not all(v[f] is None or v[f] <= ANCHOR_CPU_ATOL
                      for f in ("params", "stats"))}
    if bad:
        raise AssertionError(f"slice F rounds card vs CPU: {bad}")
    log("one cut round of each slice-F algorithm, card vs CPU (TF32 off), "
        "max abs diff of params and alphas / BN statistics (the CPU "
        "round's drift from a 1e-7 perturbation): " + ", ".join(
            f"{k} {v['params']:.3g} / "
            + ("-" if v["stats"] is None else f"{v['stats']:.3g}")
            + f" ({v['cpu_drift_1e-7']:.3g}; {v['wall_s']:.1f} s)"
            for k, v in out.items()) + f" (atol {ANCHOR_CPU_ATOL})")
    return out


# -- the cross-silo federation across real transports (phases 27-28) -------

SOCKET_R = 3  # TCP rounds under delta_int8, and the FedOpt-adam server's
ROUTED_R = 2  # ROUTED rounds under topk_ef_int8:0.05
RESUME_R = 4  # the uninterrupted run; the resumed one stops at half
MQTT_SILOS = 3  # JSON lists of 1.2 M floats a frame: 3 silos, 1 round
SILO_TOKEN = b"chip-smoke-broker-secret"


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def _free_ports(n):
    """``n`` loopback ports the OS reports free."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return {r: ("127.0.0.1", sock.getsockname()[1])
                for r, sock in enumerate(socks)}
    finally:
        for sock in socks:
            sock.close()


def _int8_launches():
    from fedml_tpu_torch.ops import quantize as tq
    return {"quant": tq.quantize_int8.launches,
            "dequant": tq.dequantize_int8.launches}


def _launch_delta(before):
    after = _int8_launches()
    return {k: after[k] - before[k] for k in after}


def _steady_rounds_per_s(durations):
    """Rounds/s over the rounds after the first (its wall includes the
    warm-up), or over all of them when there is one."""
    steady = durations[1:] or durations
    return len(steady) / sum(steady)


def _silo_cli(backend, policy, rounds):
    """``main_fedavg.main --backend <backend>`` on the FEMNIST CNN over 10
    silos, with the int8 launches of the run, the final model (the entry
    point returns the last record; the model is taken from the launcher
    it calls) and the run's summary record."""
    import torch
    from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
    from fedml_tpu_torch.experiments import main_fedavg
    from fedml_tpu_torch.utils.metrics import read_metrics

    run_dir = os.path.join(ROOT, "runs", "chip_smoke",
                           f"sock_{backend}_{policy.replace(':', '_')}")
    shutil.rmtree(run_dir, ignore_errors=True)
    run, models = cs.run_fedavg_cross_silo, []

    def keep_model(*a, **kw):
        out = run(*a, **kw)
        models.append(out[0])
        return out
    cs.run_fedavg_cross_silo = keep_model
    before = _int8_launches()
    t = time.perf_counter()
    try:
        main_fedavg.main(MAIN_FLAGS + [
            "--backend", backend, "--compression", policy, "--comm_round",
            str(rounds), "--run_dir", run_dir])
    finally:
        cs.run_fedavg_cross_silo = run
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    recs = read_metrics(run_dir)
    summary = recs[-1]
    return {"model": models[0], "launches": _launch_delta(before),
            "history": [r for r in recs if "round" in r], "wall_s": wall,
            "rounds_per_s": _steady_rounds_per_s(
                summary["round_duration_s"]),
            "bytes_up_per_round": summary["comm_bytes_up_per_round"],
            "bytes_down_per_round": summary["comm_bytes_down_per_round"]}


def _silo_api(policy, rounds, silos=HEADLINE[0], **kw):
    """``run_fedavg_cross_silo`` on the main path's dataset and CNN, with
    the int8 launches, rounds/s and wire bytes of the run."""
    import torch
    from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
    from fedml_tpu_torch.utils.tracing import RoundTimer

    ds, model, task, tc = _main_api_parts()
    timer = RoundTimer()
    before = _int8_launches()
    t = time.perf_counter()
    final, hist = cs.run_fedavg_cross_silo(
        ds, model, task=task, worker_num=silos, comm_round=rounds,
        train_cfg=tc, compression=policy, device="cuda", timer=timer,
        join_timeout_s=300, **kw)
    torch.cuda.synchronize()
    return {"model": final, "history": hist,
            "launches": _launch_delta(before),
            "wall_s": time.perf_counter() - t,
            "rounds_per_s": _steady_rounds_per_s(
                [r["duration_s"] for r in timer.round_records()]),
            "bytes_up_per_round": timer.comm_bytes_up / max(1, len(hist)),
            "bytes_down_per_round": timer.comm_bytes_down / max(1,
                                                               len(hist))}


def _check_same_model(name, got, want):
    bad = [k for k in want if not _same_bits(got[k], want[k])]
    if bad or list(got) != list(want):
        raise AssertionError(f"{name}: differs from its reference in {bad} "
                             f"(max abs {_max_diff(got, want):.3g})")


def _check_launches(name, got, want):
    if got != want:
        raise AssertionError(f"{name}: int8 launches {got}, the schedule "
                             f"implies {want}")


def _buffered_close_path(silos, rounds):
    """The buffered close with the aggregation kernel's front end as
    ``aggregate_fn``: its launches, and each round's result against the
    streaming fold of the same reports."""
    import torch
    from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
    from fedml_tpu_torch.ops import aggregate

    ds, model, task, tc = _main_api_parts()
    diffs = []

    def fused_beside_the_fold(stacked, weights):
        out = aggregate.tree_weighted_mean_fused(stacked, weights)
        fold = cs.FedAvgAggregator(silos)
        for i, w in enumerate(weights.tolist()):
            fold.add_local_trained_result(
                i, {k: v[i] for k, v in stacked.items()}, w)
        diffs.append(_max_diff(out, fold.aggregate()))
        return out

    def server_factory(size, com, _aggregator, global_model, on_round_done):
        return cs.FedAvgServerManager(
            0, size, com, cs.FedAvgAggregator(
                size - 1, aggregate_fn=fused_beside_the_fold), rounds,
            ds.client_num, global_model, on_round_done=on_round_done)
    aggregate.weighted_mean_flat.launches = 0
    _, hist, _ = cs.launch_federation(ds, model, task, silos, tc,
                                      server_factory, device="cuda",
                                      join_timeout_s=300)
    torch.cuda.synchronize()
    launches = aggregate.weighted_mean_flat.launches
    if launches != rounds:
        raise AssertionError(f"buffered close: {launches} aggregation "
                             f"launches in {rounds} rounds")
    if len(diffs) != rounds or not max(diffs) <= 1e-6:
        raise AssertionError(f"buffered close vs the streaming fold: {diffs}")
    _check_evals("buffered close", hist, list(range(rounds)), falls=False)
    return {"launches": launches, "max_abs_diff_to_fold": diffs}


def _resume_paths(silos):
    """A silo run of RESUME_R rounds (inproc) against one stopped at half
    and resumed (over TCP): the server's model and every silo's EF
    residual bit for bit; the same for the simulation's
    ``--checkpoint_dir`` / ``--resume`` (its round-RESUME_R checkpoints).
    The uplink is top-k + int8 with its residual; the downlink is full
    precision (a resumed federation starts without the silos' mirror)."""
    import numpy as np
    import torch
    from fedml_tpu_torch.comm.policy import CompressionPolicy
    from fedml_tpu_torch.experiments import main_fedavg
    from fedml_tpu_torch.state.residuals import SiloResidualStore

    policy = CompressionPolicy("topk_ef_int8", topk_frac=0.05,
                               downlink=False)
    base = os.path.join(ROOT, "runs", "chip_smoke", "resume")
    shutil.rmtree(base, ignore_errors=True)
    dirs = {k: os.path.join(base, k) for k in ("whole", "halves", "sim_whole",
                                               "sim_halves")}
    whole = _silo_api(policy, RESUME_R, checkpoint_dir=dirs["whole"])
    half = RESUME_R // 2
    first = _silo_api(policy, half, checkpoint_dir=dirs["halves"],
                      backend="TCP", addresses=_free_ports(silos + 1))
    rest = _silo_api(policy, RESUME_R, checkpoint_dir=dirs["halves"],
                     resume=True, backend="TCP",
                     addresses=_free_ports(silos + 1))
    _check_same_model("resumed silo run", rest["model"], whole["model"])
    if [r["round"] for r in first["history"] + rest["history"]] != list(
            range(RESUME_R)):
        raise AssertionError("resumed rounds "
                             f"{first['history'] + rest['history']}")
    d = sum(v.numel() for v in whole["model"].values())
    for rank in range(1, silos + 1):
        got, want = (SiloResidualStore(os.path.join(
            dirs[k], f"silo_{rank}")).load(RESUME_R, d)
            for k in ("halves", "whole"))
        if want is None or not np.array_equal(got, want):
            raise AssertionError(f"silo {rank}: the resumed residual "
                                 "differs from the uninterrupted run's")
    launches = {k: first["launches"][k] + rest["launches"][k]
                for k in first["launches"]}
    for name, got in (("whole", whole["launches"]), ("resumed", launches)):
        _check_launches(f"resume {name}", got, _silo_launches(
            RESUME_R, silos, "topk_ef_int8", downlink=False))
    # the simulation's checkpoint and resume, through the CLI
    for name, rounds, extra in (("sim_whole", RESUME_R, []),
                                ("sim_halves", half, []),
                                ("sim_halves", RESUME_R, ["--resume"])):
        run_dir = os.path.join(base, f"run_{name}_{rounds}")
        main_fedavg.main(MAIN_FLAGS + [
            "--comm_round", str(rounds), "--checkpoint_dir", dirs[name],
            "--run_dir", run_dir] + extra)
    blobs = []
    for name in ("sim_whole", "sim_halves"):
        with np.load(os.path.join(dirs[name],
                                  f"round_{RESUME_R:08d}")) as z:
            blobs.append({k: z[k] for k in z.files})
    if list(blobs[0]) != list(blobs[1]) or not all(
            np.array_equal(blobs[0][k], blobs[1][k]) for k in blobs[0]):
        raise AssertionError("the resumed simulation's checkpoint differs")
    torch.cuda.synchronize()
    log(f"resume: {half} + {RESUME_R - half} rounds (the second half over "
        f"TCP) == {RESUME_R} uninterrupted, bit for bit: the server's model "
        f"and {silos} silos' residuals; int8 launches {launches}; the "
        f"simulation's checkpoints at round {RESUME_R} equal too")
    return {"launches": launches, "whole_launches": whole["launches"]}


def phase_cross_silo_sockets():
    """Phase 27: the cross-silo federation of the FEMNIST CNN across real
    transports, against the in-process router."""
    import torch
    from fedml_tpu_torch.comm.mqtt import MiniMqttBroker
    from fedml_tpu_torch.comm.routed import RoutedCommManager
    from fedml_tpu_torch.native import NativeRouter

    t0 = time.perf_counter()
    silos = HEADLINE[0]
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    # the transports must agree bit for bit: no run-to-run choice of
    # convolution algorithm
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {"smi": _smi()}
    try:
        # TCP through the CLI against inproc
        runs = {b: _silo_cli(b, "delta_int8", SOCKET_R)
                for b in ("inproc", "tcp")}
        want = _silo_launches(SOCKET_R, silos, "delta_int8")
        for b, r in runs.items():
            _check_launches(f"{b} delta_int8", r["launches"], want)
        _check_same_model("tcp vs inproc", runs["tcp"]["model"],
                          runs["inproc"]["model"])
        out["tcp"] = {b: {k: v for k, v in r.items() if k != "model"}
                      for b, r in runs.items()}
        # ROUTED through the API, against the port's broker, with a token
        inproc_k = _silo_api("topk_ef_int8:0.05", ROUTED_R)
        with NativeRouter(token=SILO_TOKEN) as router:
            addr = {"router": ("127.0.0.1", router.port)}
            routed = _silo_api("topk_ef_int8:0.05", ROUTED_R,
                               backend="ROUTED", addresses=addr,
                               token=SILO_TOKEN)
            frames = router.frames_routed
            try:
                RoutedCommManager(1, addr["router"], token=b"wrong")
            except ConnectionError as exc:
                refused = str(exc)
            else:
                raise AssertionError("the broker took a wrong token")
        want = _silo_launches(ROUTED_R, silos, "topk_ef_int8")
        for name, r in (("inproc", inproc_k), ("routed", routed)):
            _check_launches(f"{name} topk_ef_int8", r["launches"], want)
        _check_same_model("routed vs inproc", routed["model"],
                          inproc_k["model"])
        out["routed"] = {n: {k: v for k, v in r.items() if k != "model"}
                         for n, r in (("inproc", inproc_k),
                                      ("routed", routed))}
        out["routed"]["frames_routed"] = frames
        # MQTT over the in-process broker, JSON frames
        broker = MiniMqttBroker()
        try:
            mqtt = _silo_api("none", 1, silos=MQTT_SILOS, backend="MQTT",
                             addresses={"broker": ("127.0.0.1",
                                                   broker.port)})
        finally:
            broker.stop()
        inproc_3 = _silo_api("none", 1, silos=MQTT_SILOS)
        _check_same_model("mqtt vs inproc", mqtt["model"], inproc_3["model"])
        out["mqtt"] = {"wall_s": mqtt["wall_s"],
                       "inproc_wall_s": inproc_3["wall_s"]}
        # the FedOpt-adam server over TCP, and server SGD at lr 1 == FedAvg
        fedopt = _silo_api("delta_int8", SOCKET_R, backend="TCP",
                           addresses=_free_ports(silos + 1),
                           server_optimizer="adam", server_lr=FEDOPT_LR)
        _check_launches("fedopt over tcp", fedopt["launches"],
                        _silo_launches(SOCKET_R, silos, "delta_int8"))
        _check_evals("fedopt over tcp", fedopt["history"],
                     list(range(SOCKET_R)))
        sgd = _silo_api("none", 1, backend="TCP",
                        addresses=_free_ports(silos + 1),
                        server_optimizer="sgd", server_lr=1.0)
        avg = _silo_api("none", 1)
        sgd_diff = _max_diff(sgd["model"], avg["model"])
        if not sgd_diff <= FEDOPT_SGD_TOL:
            raise AssertionError(f"server sgd lr 1 vs fedavg: {sgd_diff}")
        out["fedopt"] = {"history": fedopt["history"],
                         "launches": fedopt["launches"],
                         "rounds_per_s": fedopt["rounds_per_s"],
                         "sgd_vs_fedavg": sgd_diff}
        out["resume"] = _resume_paths(silos)
        out["buffered_close"] = _buffered_close_path(silos, 2)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    out["launches"] = {k: runs["tcp"]["launches"][k]
                       + routed["launches"][k] for k in ("quant", "dequant")}
    tcp_r, inp_r = out["tcp"]["tcp"], out["tcp"]["inproc"]
    log(f"cross-silo over sockets on {out['smi']}: TCP == inproc bit for "
        f"bit after {SOCKET_R} delta_int8 rounds (int8 launches "
        f"{tcp_r['launches']}); rounds/s TCP {tcp_r['rounds_per_s']:.3f} vs "
        f"inproc {inp_r['rounds_per_s']:.3f}; wire a round TCP up "
        f"{tcp_r['bytes_up_per_round']:.0f} B down "
        f"{tcp_r['bytes_down_per_round']:.0f} B, inproc up "
        f"{inp_r['bytes_up_per_round']:.0f} B down "
        f"{inp_r['bytes_down_per_round']:.0f} B")
    log(f"ROUTED (token) == inproc bit for bit after {ROUTED_R} "
        f"topk_ef_int8:0.05 rounds ({frames} frames through the broker, "
        f"int8 launches {routed['launches']}); rounds/s ROUTED "
        f"{routed['rounds_per_s']:.3f} vs inproc "
        f"{inproc_k['rounds_per_s']:.3f}; wire a round ROUTED up "
        f"{routed['bytes_up_per_round']:.0f} B down "
        f"{routed['bytes_down_per_round']:.0f} B, inproc up "
        f"{inproc_k['bytes_up_per_round']:.0f} B down "
        f"{inproc_k['bytes_down_per_round']:.0f} B; a wrong token: "
        f"{refused[:60]}...")
    log(f"MQTT == inproc bit for bit ({MQTT_SILOS} silos, 1 round of none, "
        f"JSON frames): {mqtt['wall_s']:.2f} s vs {inproc_3['wall_s']:.2f} s")
    log(f"FedOpt-adam (lr {FEDOPT_LR}) over TCP: test loss "
        f"{fedopt['history'][0]['test_loss']:.4f} -> "
        f"{fedopt['history'][-1]['test_loss']:.4f}; server sgd at lr 1 vs "
        f"fedavg after a round: {sgd_diff:.3g} (bound {FEDOPT_SGD_TOL})")
    log(f"buffered close: {out['buffered_close']['launches']} aggregation "
        f"launches in 2 rounds, each round within "
        f"{max(out['buffered_close']['max_abs_diff_to_fold']):.3g} of the "
        f"streaming fold (bound 1e-6)")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 27 took {out['wall_s']:.1f} s")
    return out


def _fedopt_silo_round(ds, device, addresses, init=None):
    """One cross-silo LR round with the FedOpt-adam server over TCP;
    returns (model, server optimizer state)."""
    from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.functional import TrainConfig

    model = create_model("lr", ds.class_num, input_shape=(20,))

    def server_factory(size, com, aggregator, global_model, on_round_done):
        return cs.FedOptServerManager(
            0, size, com, aggregator, 1, ds.client_num, global_model,
            param_names=[n for n, _ in model.named_parameters()],
            server_optimizer="adam", server_lr=0.01,
            on_round_done=on_round_done)
    final, _, server = cs.launch_federation(
        ds, model, "classification", 4, TrainConfig(
            epochs=2, batch_size=16, lr=0.1, shuffle=False),
        server_factory, backend="TCP", addresses=addresses, device=device,
        init_variables=init, join_timeout_s=120)
    return final, server.server_opt_state


def phase_cross_silo_sockets_card_vs_cpu():
    """Phase 28: one cross-silo LR round over TCP with the FedOpt-adam
    server on the card and on the CPU from the same weights (TF32 off):
    params and Adam state within 1e-5, beside the CPU round's drift under a
    1e-7 relative perturbation of its weights."""
    import torch
    from fedml_tpu_torch.data.synthetic import make_blob_federated

    ds = make_blob_federated(client_num=8, seed=0)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = _fedopt_silo_round(ds, "cuda", _free_ports(5))
        cpu = _fedopt_silo_round(ds, "cpu", _free_ports(5))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    diff = _max_diff(card, cpu)
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import _initial_model
    from fedml_tpu_torch.models import create_model
    init = _initial_model(create_model("lr", ds.class_num,
                                       input_shape=(20,)), 0, "cpu", None)
    gen = torch.Generator().manual_seed(28)
    moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
             for k, v in init.items()}
    drift = _max_diff(_fedopt_silo_round(ds, "cpu", _free_ports(5), init),
                      _fedopt_silo_round(ds, "cpu", _free_ports(5), moved))
    if not diff <= 1e-5:
        raise AssertionError(f"cross-silo FedOpt-adam LR round over TCP, card "
                             f"vs CPU: {diff}")
    log(f"cross-silo FedOpt-adam LR round over TCP, card vs CPU (params and "
        f"adam state): max abs diff {diff:.3g} (atol 1e-5); the CPU round's "
        f"drift under a 1e-7 perturbation: {drift:.3g}")
    return {"max_abs_diff": diff, "cpu_drift_1e-7": drift}


OBS_R = 2  # rounds of the observed TCP federation (phase 29)
#: rounds of the deadline run (phase 30): the evicted silos' JOIN comes 1.5-2
#: deadlines (7.5-10 round walls) after round 1 opened, so they rejoined
#: by round 7-9 on the H100 runs measured; 16 leaves the rest as margin
FT_R = 16
FT_DROPPED = (3, 7)  # the silos whose round-1 replies the plan drops
QUORUM = 7  # the quorum server's count of 10 (phase 30b)
ASYNC_UPDATES = 8  # FedAsync's budget on the CNN (phase 30c)


def _obs_sim(parts, obs_dir=None, profile_round=None):
    """Phase 29's simulation: 3 host-loop rounds of the main path through
    FedAvgAPI, obs on when ``obs_dir`` is set; returns the API and the
    aggregation launches."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.ops import aggregate

    api = _algo_api(FedAvgAPI, FedAvgConfig, parts, 3,
                    config={"obs_dir": obs_dir, "job_id": "chip_smoke"}
                    if obs_dir else None)
    before = aggregate.weighted_mean_flat.launches
    for r in range(3):
        if r == profile_round:
            # a one-shot window over this round, as a slow round arms one
            api._obs.note_anomaly("chip_smoke", r)
        api.run_round(r)
    torch.cuda.synchronize()
    return api, aggregate.weighted_mean_flat.launches - before


def phase_observability():
    """Phase 29: the flight recorder, the round-FLOP counter and MFU on the
    card, on the host loop and the cross-silo federation."""
    import copy

    import torch
    from fedml_tpu_torch.algorithms.fedavg import (FLOPS_SOURCE, FedAvgAPI,
                                                   FedAvgConfig)
    from fedml_tpu_torch.obs import read_flight_log
    from fedml_tpu_torch.obs import __main__ as obs_cli
    from fedml_tpu_torch.obs.perf import device_peak_flops
    from fedml_tpu_torch.utils.flops import analytic_flops

    t0 = time.perf_counter()
    base = os.path.join(ROOT, "runs", "chip_smoke", "obs")
    shutil.rmtree(base, ignore_errors=True)
    name = torch.cuda.get_device_name(0)
    peak = device_peak_flops(name)
    if "H100 80GB HBM3" in name and peak != 989.4e12:
        raise AssertionError(f"{name}: peak {peak}")
    if not peak:
        raise AssertionError(f"no peak FLOP/s for {name!r}")
    out = {"smi": _smi(), "device": name, "peak_flops": peak}
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        # (a) the simulation, obs off and on, and (b) the profile window
        parts = _main_api_parts()
        clean, _ = _obs_sim(parts)
        sim_dir = os.path.join(base, "sim")
        api, launches = _obs_sim(parts, sim_dir, profile_round=2)
        _check_same_model("sim obs on vs off", api.variables,
                          clean.variables)
        if launches != 3:
            raise AssertionError(f"sim with obs: {launches} aggregation "
                                 "launches in 3 rounds")
        rows = read_flight_log(os.path.join(sim_dir, "flight_rank0.jsonl"))
        rounds = [r for r in rows if r["kind"] == "round"]
        perfs = [r for r in rows if r["kind"] == "perf"]
        if [r["round"] for r in rounds] != [0, 1, 2] or any(
                len(r["cohort"]) != HEADLINE[0]
                or r["phases"]["dispatch"]["n"] != 1 for r in rounds):
            raise AssertionError(f"sim round records: {rounds}")
        # each round counted on the CPU in full: counting depends on
        # shapes and on which steps run, and each round's cohort differs
        ds, model, task, tc = parts
        cpu = FedAvgAPI(ds, copy.deepcopy(model), task=task, device="cpu",
                        config=FedAvgConfig(
                            comm_round=3, client_num_per_round=HEADLINE[0],
                            train=tc))
        cpu_flops, real_steps = [], []
        for r in range(3):
            _, (x, y, mask, w, plan, agg) = cpu._prepare_round(r)
            cpu_flops.append(analytic_flops(cpu._round_fn, cpu.variables, x,
                                            y, mask, w, plan, agg, None))
            real_steps.append((int(plan.has_real.sum()),
                               int(plan.has_real.size)))
        if [p["round"] for p in perfs] != [0, 1, 2]:
            raise AssertionError(f"sim perf records: {perfs}")
        for p in perfs:
            want = cpu_flops[p["round"]]
            if not (p["peak_flops"] == peak and 0 < p["mfu"] < 1
                    and p["round_flops"] == want
                    and p["flops_source"] == FLOPS_SOURCE):
                raise AssertionError(f"perf record {p} (peak {peak}, the "
                                     f"CPU's count {want})")
            real, gated = real_steps[p["round"]]
            log(f"obs sim round {p['round']}: mfu {p['mfu']:.6g}, "
                f"round_flops {p['round_flops']:.6g} ({real} real steps of "
                f"{gated}), {p['duration_s']:.4f} s, device_mem_peak_mb "
                f"{p.get('device_mem_peak_mb')}")
        trace = os.path.join(sim_dir, "profiles", "round_000002",
                             "trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        wmean = [k for k in kernels if "wmean_" in k]
        if len(wmean) != 1:
            raise AssertionError(f"the round-2 trace names {len(wmean)} "
                                 f"aggregation kernels: {wmean[:3]}")
        out["sim"] = {"launches": launches,
                      "perf": [{k: p.get(k) for k in (
                          "round", "duration_s", "round_flops", "mfu",
                          "achieved_flops_per_s", "device_mem_peak_mb")}
                          for p in perfs],
                      "cpu_round_flops": cpu_flops,
                      "real_steps": real_steps,
                      "trace_kernels": len(kernels),
                      "trace_wmean": wmean[0]}
        log(f"obs sim: 3 rounds bit for bit with obs off, {launches} "
            f"aggregation launches, peak {peak:.6g} FLOP/s from {name!r}, "
            f"round_flops {cpu_flops} as counted on the CPU; the round-2 "
            f"trace holds {len(kernels)} kernels, the aggregation's "
            f"{wmean[0][:60]!r} once")
        # (d) the fused block's count beside the same rounds' host counts
        fused = api.fused_rounds().cost_analysis(0, 2)
        per_round = fused["flops"] / 2
        shares = [f / per_round for f in cpu_flops[:2]]
        out["fused"] = {"block_flops": fused["flops"],
                        "flops_per_round": per_round,
                        "bytes_accessed": fused["bytes accessed"],
                        "by_class": fused["flops_by_class"],
                        "host_round_flops": cpu_flops[:2],
                        "host_share": shares}
        log(f"fused 2-round block: {per_round:.6g} FLOP a round against the "
            f"host rounds' {cpu_flops[0]:.6g} and {cpu_flops[1]:.6g} "
            f"({shares[0]:.3f} and {shares[1]:.3f} of it; the rest is the "
            f"padding-only steps and the gates)")
        # (c) the federation over TCP, obs off and on
        silo_dir = os.path.join(base, "silo")
        runs = {}
        for tag, obs in (("off", None), ("on", silo_dir)):
            runs[tag] = _silo_api("delta_int8", OBS_R, silos=HEADLINE[0],
                                  backend="TCP",
                                  addresses=_free_ports(HEADLINE[0] + 1),
                                  obs_dir=obs)
        want = _silo_launches(OBS_R, HEADLINE[0], "delta_int8")
        for tag, r in runs.items():
            _check_launches(f"tcp obs {tag}", r["launches"], want)
        _check_same_model("tcp obs on vs off", runs["on"]["model"],
                          runs["off"]["model"])
        logs = sorted(os.listdir(silo_dir))
        if logs != sorted(f"flight_rank{r}.jsonl"
                          for r in range(HEADLINE[0] + 1)):
            raise AssertionError(f"flight logs {logs}")
        srv = read_flight_log(os.path.join(silo_dir, "flight_rank0.jsonl"))
        for r in range(OBS_R):
            ranks = sorted(x["silo_rank"] for x in srv
                           if x["kind"] == "silo" and x["round"] == r)
            if ranks != list(range(1, HEADLINE[0] + 1)):
                raise AssertionError(f"round {r}: silo rows {ranks}")
        merge_rc = obs_cli.main(["merge", silo_dir,
                                 "--output", os.path.join(base,
                                                          "merged.json")])
        if merge_rc != 0:
            raise AssertionError(f"obs merge exited {merge_rc}")
        silo_perf = [x for x in srv if x["kind"] == "perf"]
        out["silo"] = {"launches": runs["on"]["launches"],
                       "rounds_per_s": {t: r["rounds_per_s"]
                                        for t, r in runs.items()},
                       "perf": silo_perf}
        log(f"obs tcp: {OBS_R} delta_int8 rounds bit for bit with obs off, "
            f"int8 launches {runs['on']['launches']} (the schedule: {want}),"
            f" {len(logs)} flight logs, obs merge exit 0; rounds/s on "
            f"{runs['on']['rounds_per_s']:.3f} off "
            f"{runs['off']['rounds_per_s']:.3f}; the server's wire bytes/s "
            f"up {[x.get('wire_bytes_per_sec_up') for x in silo_perf]}")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 29 took {out['wall_s']:.1f} s")
    return out


def _drop_round1(ranks):
    """A seeded plan that drops each listed silo's round-1 reply (its
    endpoint's second reply)."""
    return "seed=30;" + ";".join(
        f"drop:direction=send,sender={r},msg_type=4,after=1,max_count=1"
        for r in ranks)


def _recording_server():
    """The deadline server, recording each broadcast: its round, whether
    it went out compressed, and to how many silos (the live set)."""
    from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
    from fedml_tpu_torch.comm.compression import is_compressed

    class Recorded(cs.FedAvgServerManager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.bcasts = []

        def _encode_broadcast(self):
            out = super()._encode_broadcast()
            self.bcasts.append((self.round_idx, is_compressed(out),
                                len(self.liveness.live_workers())))
            return out
    return Recorded


def _deadline_path(silos):
    """Phase 30a: the CNN's deadline run on the card, with its counts."""
    import torch
    from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.ops import quantize as tq
    from fedml_tpu_torch.utils.tracing import RoundTimer

    ds, model, task, tc = _main_api_parts()
    recorded = _recording_server()
    closes, fold_diffs = [], []

    def kernel_close(stacked, weights):
        out = aggregate.tree_weighted_mean_fused(stacked, weights)
        fold = cs.FedAvgAggregator(int(weights.shape[0]))
        for i, w in enumerate(weights.tolist()):
            fold.add_local_trained_result(
                i, {k: v[i] for k, v in stacked.items()}, w)
        closes.append(int(weights.shape[0]))
        fold_diffs.append(_max_diff(out, fold.aggregate()))
        return out

    def run(rounds, plan=None, deadline=None, heartbeat_s=0.0):
        def factory(size, com, _agg, global_model, on_round_done):
            return recorded(
                0, size, com, cs.FedAvgAggregator(
                    size - 1, aggregate_fn=kernel_close), rounds,
                ds.client_num, global_model, on_round_done=on_round_done,
                compression="delta_int8", round_deadline_s=deadline)
        timer = RoundTimer()
        final, hist, server = cs.launch_federation(
            ds, model, task, silos, tc, factory, compression="delta_int8",
            heartbeat_s=heartbeat_s, fault_plan=plan, timer=timer,
            device="cuda", join_timeout_s=300)
        torch.cuda.synchronize()
        return final, hist, server, timer

    # the round wall the deadline is sized from (no faults, warm)
    _, _, _, warm = run(2)
    wall = warm.round_records()[1]["duration_s"]
    deadline = max(5.0 * wall, 1.0)
    closes.clear()
    fold_diffs.clear()
    held = {}
    finish = cs.FedAvgClientManager._handle_finish

    def keep_held(self, msg):
        held[self.rank] = {k: v.clone() for k, v in self._held.items()}
        finish(self, msg)
    cs.FedAvgClientManager._handle_finish = keep_held
    aggregate.weighted_mean_flat.launches = 0
    tq.quantize_int8.launches = 0
    tq.dequantize_int8.launches = 0
    t = time.perf_counter()
    try:
        final, hist, server, timer = run(FT_R, _drop_round1(FT_DROPPED),
                                         deadline, deadline / 2)
    finally:
        cs.FedAvgClientManager._handle_finish = finish
    wall_s = time.perf_counter() - t
    launches = {"aggregate": aggregate.weighted_mean_flat.launches,
                "quant": tq.quantize_int8.launches,
                "dequant": tq.dequantize_int8.launches}
    rows = server.live_history
    reported = [len(h["reported"]) for h in rows]
    survivors = sorted(set(range(silos)) - {r - 1 for r in FT_DROPPED})
    if len(rows) != FT_R or rows[1]["reported"] != survivors \
            or not rows[1]["partial"]:
        raise AssertionError(f"deadline run: rounds {rows}")
    if closes != reported or launches["aggregate"] != FT_R:
        raise AssertionError(f"deadline run: aggregation launches "
                             f"{launches['aggregate']} at C = {closes}, the "
                             f"rounds' reporters {reported}")
    if not max(fold_diffs) <= 1e-6:
        raise AssertionError(f"deadline run: the kernel's closes against "
                             f"the streaming fold: {fold_diffs}")
    counters = {k: int(timer.counters[f"ft_{k}"]) for k in (
        "evictions", "rejoins", "join_resyncs", "partial_rounds",
        "stale_replies", "deadline_extensions", "faults_injected",
        "heartbeats")}
    if server.liveness.live_workers() != set(range(silos)) or \
            counters["evictions"] != 2 or counters["rejoins"] != 2:
        raise AssertionError(f"deadline run: live at the end "
                             f"{sorted(server.liveness.live_workers())}, "
                             f"{counters}")
    sent = sum(n for _, _, n in server.bcasts) + counters["join_resyncs"]
    if sum(reported) != sent - len(FT_DROPPED) - counters["stale_replies"]:
        raise AssertionError(f"deadline run: {sum(reported)} replies folded "
                             f"of {sent} sent")
    compressed = [n for _, c, n in server.bcasts if c]
    _check_launches("deadline run", {k: launches[k] for k in (
        "quant", "dequant")}, {
            "quant": sent + len(compressed),
            "dequant": sum(reported) + sum(1 + n for n in compressed)})
    bad = [r for r in range(1, silos + 1) if r not in held or not all(
        _same_bits(held[r][k], server._mirror[k]) for k in server._mirror)]
    if bad:
        raise AssertionError(f"deadline run: silos {bad} do not hold the "
                             "mirror at FINISH")
    _check_evals("deadline run", hist, list(range(FT_R)), falls=False)
    rejoin = next(h["round"] for h in rows[2:] if len(h["reported"]) == silos)
    log(f"deadline run ({_smi()}): CNN, 10 silos, delta_int8, round wall "
        f"{wall:.4f} s -> deadline {deadline:.3f} s, heartbeat "
        f"{deadline / 2:.3f} s; round 1 closed at the deadline over "
        f"{reported[1]} reports, silos {list(FT_DROPPED)} evicted, rejoined "
        f"by round {rejoin} with a full resync; C a round {closes}; "
        f"launches {launches}, as the schedule implies ({len(compressed)} "
        f"compressed broadcasts, {sent} replies sent, {sum(reported)} "
        f"folded); the kernel vs the fold {max(fold_diffs):.3g}; every "
        f"silo holds the mirror bit for bit; {counters}; {wall_s:.1f} s")
    return {"launches": launches, "close_c": closes, "wall_s": wall_s,
            "round_wall_s": wall, "deadline_s": deadline,
            "rejoin_round": rejoin, "counters": counters,
            "broadcasts": server.bcasts,
            "max_abs_diff_to_fold": max(fold_diffs)}


def _deadline_card_vs_cpu(silos):
    """Phase 30a's plan on the CNN at full width, TF32 off, on the card
    (cuDNN's deterministic algorithms) and on the CPU: no heartbeats, so
    the evicted silos stay out and the schedule is fixed (round 1 closes
    at its deadline over 8 reports through the buffered close, round 2
    over the 8 live silos). Round 1's deadline is 3x round 0's wall on
    each device. Each silo takes one full-batch step a round at lr 0.01:
    a convolution's weight gradient sums 10^4-10^5 products an entry in
    f32, in another order on the card than on the CPU, so at the main
    path's lr 0.1 one round parts the two by more than 1e-5 (and the
    rounds after it compound that). No compression: the int8
    codec's stochastic rounding draws from a generator on the device,
    whose stream differs between the card and the CPU; the int8 chain is
    held by the mirror check above and by phase 6."""
    import torch
    from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
    from fedml_tpu_torch.ops import aggregate

    ds, model, task, tc = _main_api_parts()
    tc = dataclasses.replace(tc, batch_size=None, lr=0.01)
    xt, yt = ds.test_data_global
    # the eval is not what is compared: a cut test set keeps the CPU's
    # rounds short
    ds = dataclasses.replace(ds, test_data_global=(xt[:1000], yt[:1000]))

    class Sized(cs.FedAvgServerManager):
        def _close_round(self, partial=False):
            if self.round_idx == 0:
                self.round_deadline_s = max(
                    3.0 * (time.monotonic() - self._bcast_at), 1.0)
            super()._close_round(partial=partial)

    def factory(size, com, _agg, global_model, on_round_done):
        return Sized(0, size, com, cs.FedAvgAggregator(
            size - 1, aggregate_fn=aggregate.tree_weighted_mean_fused),
            3, ds.client_num, global_model, on_round_done=on_round_done,
            round_deadline_s=600.0)

    def run(dev):
        t = time.perf_counter()
        final, _, server = cs.launch_federation(
            ds, model, task, silos, tc, factory,
            fault_plan=_drop_round1(FT_DROPPED), device=dev,
            join_timeout_s=300)
        return (final, [(h["reported"], h["partial"])
                        for h in server.live_history],
                time.perf_counter() - t)

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = _deterministic(lambda: run("cuda"))
        cpu = run("cpu")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    survivors = sorted(set(range(silos)) - {r - 1 for r in FT_DROPPED})
    # a close over fewer than every silo is partial, round 2's too
    want = [(list(range(silos)), False), (survivors, True),
            (survivors, True)]
    diff = _max_diff(card[0], cpu[0])
    if card[1] != want or cpu[1] != want or not diff <= 1e-5:
        raise AssertionError(f"deadline CNN run card vs CPU: rounds "
                             f"{card[1]} / {cpu[1]}, max abs diff {diff}")
    log(f"deadline CNN run (10 silos, 2 round-1 replies dropped, 3 rounds "
        f"of one full-batch step at lr 0.01, the buffered close at C = 8), "
        f"card vs CPU: max abs param diff {diff:.3g} (atol 1e-5), the same "
        f"rounds; {card[2]:.1f} s on the card, {cpu[2]:.1f} s on the CPU")
    return {"max_abs_diff": diff,
            "wall_s": {"cuda": card[2], "cpu": cpu[2]}}


def _quorum_path(deadline):
    """Phase 30b: the quorum server through fed_launch on the CNN."""
    from fedml_tpu_torch.experiments import fed_launch
    final, launches, _, _, wall = _launch_run(fed_launch, [
        "--algo", "fedavg_async", *MAIN_FLAGS, "--async_mode", "quorum",
        "--quorum", str(QUORUM), "--comm_round", "3",
        "--round_deadline_s", str(deadline),
        "--fault_plan", _drop_round1((2, 5, 9))], "chip_smoke/ft_quorum")
    if final["partial_rounds"] != [1] or final["round"] != 2 \
            or not math.isfinite(final["test_loss"]):
        raise AssertionError(f"quorum run: {final}")
    log(f"fed_launch fedavg_async quorum {QUORUM} of 10 (CNN, 3 round-1 "
        f"replies dropped, deadline {deadline:.3f} s): partial_rounds "
        f"{final['partial_rounds']}, test loss {final['test_loss']:.4f}, "
        f"{wall:.1f} s")
    return {"partial_rounds": final["partial_rounds"], "wall_s": wall,
            "aggregation_launches": launches}


def _fedasync_paths():
    """Phase 30c: FedAsync through fed_launch: one LR silo on the card and
    on the CPU, then four CNN silos."""
    import torch
    from fedml_tpu_torch.algorithms import fedavg_async as pasync
    from fedml_tpu_torch.experiments import fed_launch

    run, out = pasync.run_fedavg_async, {}

    def keep(*a, **kw):
        result = run(*a, **kw)
        out[kw["device"]] = result
        return result
    pasync.run_fedavg_async = keep
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            fed_launch.main([
                "--algo", "fedavg_async", "--async_mode", "fedasync",
                "--dataset", "blob", "--client_num_in_total", "4",
                "--client_num_per_round", "1", "--max_updates", "5",
                "--batch_size", "16", "--lr", "0.1", "--device", dev,
                "--run_dir", os.path.join(ROOT, "runs", "chip_smoke",
                                          f"ft_fedasync_lr_{dev}")])
        lr_logs = {d: out[d][2].update_log for d in out}
        diff = _max_diff(out["cuda"][0], out["cpu"][0])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        t = time.perf_counter()
        fed_launch.main(["--algo", "fedavg_async", *MAIN_FLAGS,
                         "--client_num_per_round", "4", "--async_mode",
                         "fedasync", "--max_updates", str(ASYNC_UPDATES),
                         "--run_dir", os.path.join(ROOT, "runs", "chip_smoke",
                                                   "ft_fedasync_cnn")])
        torch.cuda.synchronize()
        cnn_s = time.perf_counter() - t
    finally:
        pasync.run_fedavg_async = run
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    if lr_logs["cuda"] != lr_logs["cpu"] or not diff <= 1e-5:
        raise AssertionError(f"FedAsync LR silo card vs CPU: {diff}, logs "
                             f"{lr_logs}")
    server = out["cuda"][2]
    log_ = server.update_log
    bad = [u for u in log_ if u["mix"] != server.alpha * (
        u["staleness"] + 1) ** -server.poly_a]
    if len(log_) != ASYNC_UPDATES or bad or server.version != ASYNC_UPDATES:
        raise AssertionError(f"FedAsync CNN run: update_log {log_}")
    for k, v in out["cuda"][0].items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"FedAsync CNN run: {k} is not finite")
    log(f"fed_launch fedavg_async fedasync: 1 LR silo, 5 updates, card vs "
        f"CPU max abs diff {diff:.3g} (atol 1e-5); 4 CNN silos, "
        f"{len(log_)} updates, staleness "
        f"{[u['staleness'] for u in log_]}, each mix alpha*(s+1)^-poly_a, "
        f"{cnn_s:.1f} s")
    return {"lr_card_vs_cpu_max_abs_diff": diff,
            "cnn_update_log": log_, "cnn_s": cnn_s}


def phase_fault_tolerance():
    """Phase 30: deadline rounds with eviction, heartbeats and JOIN under a
    seeded fault plan, then the quorum and FedAsync servers."""
    t0 = time.perf_counter()
    silos = HEADLINE[0]
    deadline = _deadline_path(silos)
    out = {"deadline": deadline,
           "deadline_card_vs_cpu": _deadline_card_vs_cpu(silos),
           "quorum": _quorum_path(deadline["deadline_s"]),
           "fedasync": _fedasync_paths()}
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 30 took {out['phase_s']:.1f} s")
    return out


WAN_R = 8  # rounds of the WAN federation (phase 31)
WAN_SILOS = 4
#: designed with ``python -m fedml_tpu_torch.wan curve --trace ...
#: --population 200 --workers 4 --rounds 8``: silos [####] [##..] [##..]
#: [##.#] [####] [####] [###.] [####]
WAN_TRACE = ("seed=6;period_s=960;phase0_s=480;peak=0.98;trough=0.5;"
             "duty_jitter=0.05;slot_s=120;flap=60:120:0.5")
#: a cross-silo WAN link (100 Mbit/s floor) and a lognormal local round;
#: the sim delays are scaled by WAN_DELAY_SCALE into wall seconds
WAN_PROFILES = ("seed=5;compute_median_s=0.1;compute_sigma=0.5;"
                "up_min_bps=1.25e7;down_min_bps=1.25e7;bw_alpha=1.6;"
                "delay_cap_s=2.0")
WAN_DELAY_SCALE = 0.1


def _wan_world(deadline):
    """Phase 31's world: its timings are fractions of the deadline, so a
    trace-offline silo JOINs (and is deferred) inside the round that
    evicts it, and an online silo's injected delay never reaches the
    deadline."""
    from fedml_tpu_torch.wan import WanWorld
    return WanWorld(trace=WAN_TRACE, profiles=WAN_PROFILES, round_s=60.0,
                    delay_scale=WAN_DELAY_SCALE,
                    delay_wall_cap_s=deadline / 5,
                    offline_hold_s=0.3 * deadline,
                    join_retry_s=0.25 * deadline)


def phase_wan_world():
    """Phase 31: the CNN's deadline federation on the card under a WAN
    trace and client profiles, with its counts."""
    import torch
    from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
    from fedml_tpu_torch.comm.compression import is_compressed
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.ops import quantize as tq
    from fedml_tpu_torch.utils.tracing import RoundTimer
    from fedml_tpu_torch.wan.__main__ import cohorts_all_available

    t0 = time.perf_counter()
    ds, model, task, tc = _main_api_parts()
    closes, fold_diffs, decodes = [], [], []

    class recorded(_recording_server()):
        """Also counts the compressed replies it decodes: a live silo that
        waited out a deadline may JOIN just after the next broadcast and be
        resynced into that round, and its second reply is decoded too."""

        def _decode_model_payload(self, payload):
            decodes.append(is_compressed(payload))
            return super()._decode_model_payload(payload)

    def kernel_close(stacked, weights):
        out = aggregate.tree_weighted_mean_fused(stacked, weights)
        fold = cs.FedAvgAggregator(int(weights.shape[0]))
        for i, w in enumerate(weights.tolist()):
            fold.add_local_trained_result(
                i, {k: v[i] for k, v in stacked.items()}, w)
        closes.append(int(weights.shape[0]))
        fold_diffs.append(_max_diff(out, fold.aggregate()))
        return out

    def run(rounds, deadline, world=None, heartbeat_s=0.0):
        def factory(size, com, _agg, global_model, on_round_done):
            return recorded(
                0, size, com, cs.FedAvgAggregator(
                    size - 1, aggregate_fn=kernel_close), rounds,
                ds.client_num, global_model, on_round_done=on_round_done,
                compression="delta_int8", round_deadline_s=deadline,
                wan=world)
        timer = RoundTimer()
        _, hist, server = cs.launch_federation(
            ds, model, task, WAN_SILOS, tc, factory,
            compression="delta_int8", heartbeat_s=heartbeat_s, timer=timer,
            wan=world, device="cuda", join_timeout_s=300)
        torch.cuda.synchronize()
        return hist, server, timer

    # the round wall the deadline is sized from (no world, warm)
    _, _, warm = run(2, None)
    wall = warm.round_records()[1]["duration_s"]
    deadline = max(5.0 * wall, 1.0)
    world = _wan_world(deadline)
    # each silo's applied broadcasts (round, compressed) and dropped rounds
    events = {r: [] for r in range(1, WAN_SILOS + 1)}
    apply_, train = (cs.FedAvgClientManager._apply_broadcast,
                     cs.FedAvgClientManager._train_and_reply)

    def on_apply(self, msg):
        events[self.rank].append(("apply", msg.get(cs.MSG_ARG_KEY_ROUND),
                                  is_compressed(msg.get(
                                      cs.MSG_ARG_KEY_MODEL_PARAMS))))
        return apply_(self, msg)

    def on_train(self, msg):
        drops = self._wan_agent.counters["wan_offline_drops"]
        train(self, msg)
        if self._wan_agent.counters["wan_offline_drops"] > drops:
            events[self.rank].append(("drop", msg.get(cs.MSG_ARG_KEY_ROUND),
                                      None))
    cs.FedAvgClientManager._apply_broadcast = on_apply
    cs.FedAvgClientManager._train_and_reply = on_train
    closes.clear()
    fold_diffs.clear()
    decodes.clear()
    aggregate.weighted_mean_flat.launches = 0
    tq.quantize_int8.launches = 0
    tq.dequantize_int8.launches = 0
    t = time.perf_counter()
    try:
        hist, server, timer = run(WAN_R, deadline, world, deadline / 10)
    finally:
        cs.FedAvgClientManager._apply_broadcast = apply_
        cs.FedAvgClientManager._train_and_reply = train
    wall_s = time.perf_counter() - t
    launches = {"aggregate": aggregate.weighted_mean_flat.launches,
                "quant": tq.quantize_int8.launches,
                "dequant": tq.dequantize_int8.launches}
    ledger = [r for r in timer.round_records()]
    reported = [len(r["reported"]) for r in ledger]
    c = {k: int(v) for k, v in timer.counters.items()
         if k.startswith(("ft_", "wan_"))}
    if len(hist) != WAN_R or [r["round"] for r in ledger] != list(
            range(WAN_R)):
        raise AssertionError(f"WAN run: the schedule did not close: "
                             f"{[r['round'] for r in ledger]}")
    if min(c["ft_evictions"], c["ft_rejoins"],
           c["ft_partial_rounds"]) < 1 or c.get("wan_forced_cohorts", 0):
        raise AssertionError(f"WAN run: counters {c}")
    if not cohorts_all_available(ledger, world):
        raise AssertionError(f"WAN run: a cohort member was trace-offline: "
                             f"{[r['cohort'] for r in ledger]}")
    offline = [(r["round"], w) for r in ledger for w in r["reported"]
               if not world.silo_online(w + 1, r["round"])]
    if offline:
        raise AssertionError(f"WAN run: reports from trace-offline silos "
                             f"(round, worker) {offline}")
    if closes != reported or launches["aggregate"] != WAN_R:
        raise AssertionError(f"WAN run: aggregation launches "
                             f"{launches['aggregate']} at C = {closes}, the "
                             f"rounds' reporters {reported}")
    if not max(fold_diffs) <= 1e-6:
        raise AssertionError(f"WAN run: the kernel's closes against the "
                             f"streaming fold: {fold_diffs}")
    applies = [e for ev in events.values() for e in ev if e[0] == "apply"]
    sent = len(applies)  # every applied broadcast is replied to
    compressed = sum(1 for _, comp, _ in server.bcasts if comp)
    decoded = sum(1 for e in applies if e[2])
    if not all(decodes) or len(decodes) < sum(reported):
        raise AssertionError(f"WAN run: {len(decodes)} replies decoded "
                             f"({sum(decodes)} compressed), {sum(reported)} "
                             "folded")
    _check_launches("WAN run", {k: launches[k] for k in (
        "quant", "dequant")}, {
            "quant": sent + compressed,
            "dequant": len(decodes) + compressed + decoded})
    rebased = []
    for rank, ev in events.items():
        for i, (kind, rnd, _) in enumerate(ev):
            if kind != "drop":
                continue
            nxt = next((e for e in ev[i + 1:] if e[0] == "apply"), None)
            if nxt is not None and nxt[2]:
                raise AssertionError(f"WAN run: silo {rank} dark in round "
                                     f"{rnd} decoded a compressed broadcast "
                                     f"in round {nxt[1]}")
            if nxt is not None:
                rebased.append((rank, rnd, nxt[1]))
    if not rebased:
        raise AssertionError(f"WAN run: no silo came back after a dark "
                             f"round: {events}")
    _check_evals("WAN run", hist, list(range(WAN_R)), falls=False)
    rows = [(r["round"], r["reported"], r["partial"]) for r in ledger]
    out = {"launches": launches, "close_c": closes, "wall_s": wall_s,
           "round_wall_s": wall, "deadline_s": deadline, "rounds": rows,
           "counters": c, "rebased": rebased,
           "max_abs_diff_to_fold": max(fold_diffs),
           "available_frac": [r.get("wan_available_frac") for r in ledger]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"WAN run ({_smi()}): CNN, {WAN_SILOS} silos, delta_int8, round "
        f"wall {wall:.4f} s -> deadline {deadline:.3f} s; (round, "
        f"reporters, partial) {rows}; dark rounds -> first full-precision "
        f"apply (silo, dark round, round) {rebased}; C a round {closes}; "
        f"launches {launches}, as the schedule implies ({compressed} "
        f"compressed broadcasts, {decoded} silo decodes, {sent} replies "
        f"sent, {len(decodes)} decoded, {sum(reported)} folded); the kernel "
        f"vs the fold "
        f"{max(fold_diffs):.3g}; {c}; {wall_s:.1f} s")
    log(f"phase 31 took {out['phase_s']:.1f} s")
    return out


CP_R = 6  # rounds of each phase-32 leg
CP_SILOS = 4
CP_CRASH = 3  # the killed leg's server dies before this round's broadcast


def phase_control_plane():
    """Phase 32: the control plane on the card. The CNN's deadline
    federation over 4 in-process silos through the failover harness, with
    pace steering, the async writer (group commit) and ``delta_int8`` on
    the uplink only: an unkilled leg, and a leg whose server dies before
    its round-3 broadcast and whose fresh successor restores the newest
    snapshot and finishes. Both legs close through the aggregation
    kernel (the buffered close), cuDNN deterministic."""
    import tempfile

    import torch
    from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
    from fedml_tpu_torch.comm.compression import is_compressed
    from fedml_tpu_torch.comm.policy import CompressionPolicy
    from fedml_tpu_torch.control import ServerControlCheckpointer
    from fedml_tpu_torch.control import failover_harness as fh
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.ops import quantize as tq

    t0 = time.perf_counter()
    policy = CompressionPolicy("delta_int8", downlink=False)
    closes, fold_diffs, decodes, applies = [], [], [], []

    def fixture(workers):
        ds, model, _, tc = _main_api_parts()
        return ds, model, tc

    def kernel_close(stacked, weights):
        out = aggregate.tree_weighted_mean_fused(stacked, weights)
        fold = cs.FedAvgAggregator(int(weights.shape[0]))
        for i, w in enumerate(weights.tolist()):
            fold.add_local_trained_result(
                i, {k: v[i] for k, v in stacked.items()}, w)
        closes.append((threading.current_thread().name,
                       int(weights.shape[0])))
        fold_diffs.append(_max_diff(out, fold.aggregate()))
        return out

    decode, apply_ = (cs.FedAvgServerManager._decode_model_payload,
                      cs.FedAvgClientManager._apply_broadcast)

    def on_decode(self, payload):
        decodes.append(is_compressed(payload))
        return decode(self, payload)

    def on_apply(self, msg):
        applies.append(is_compressed(msg.get(cs.MSG_ARG_KEY_MODEL_PARAMS)))
        return apply_(self, msg)

    def leg(root, rounds, crash, deadline):
        return fh.run_simulated_failover(
            root, rounds=rounds, workers=CP_SILOS, crash_at_round=crash,
            deadline_s=deadline, pace=True, device="cuda",
            compression=policy, aggregate_fn=kernel_close, fixture=fixture,
            join_timeout_s=300)

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cs.FedAvgServerManager._decode_model_payload = on_decode
    cs.FedAvgClientManager._apply_broadcast = on_apply
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cp_") as root:
            # the round wall the deadline is sized from (warm, no crash):
            # 12x, so steering's floor (base / 4) stays 3x a round
            _, _, warm = leg(os.path.join(root, "warm"), 2, 10**9, 600.0)
            wall = warm.round_timer.round_records()[1]["duration_s"]
            deadline = max(12.0 * wall, 2.0)
            runs = {}
            for name, crash in (("unkilled", 10**9), ("killed", CP_CRASH)):
                closes.clear()
                fold_diffs.clear()
                decodes.clear()
                applies.clear()
                aggregate.weighted_mean_flat.launches = 0
                tq.quantize_int8.launches = 0
                tq.dequantize_int8.launches = 0
                d = os.path.join(root, name)
                t = time.perf_counter()
                model, ledger, server = leg(d, CP_R, crash, deadline)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t
                tm = server.round_timer
                runs[name] = {
                    "model": {k: torch.from_numpy(v)
                              for k, v in model.items()},
                    "ledger": ledger, "server": server, "wall_s": wall_s,
                    "launches": {
                        "aggregate": aggregate.weighted_mean_flat.launches,
                        "quant": tq.quantize_int8.launches,
                        "dequant": tq.dequantize_int8.launches},
                    "closes": list(closes), "decodes": list(decodes),
                    "applies": list(applies),
                    "fold_diff": max(fold_diffs),
                    "closes_logged": len(ServerControlCheckpointer(d)
                                         .read_ledger(dedup=False)),
                    "cp": {"capture_ms": tm.gauges.get("cp_capture_ms"),
                           "flush_ms": tm.gauges.get("cp_flush_ms"),
                           "fsync_total": tm.counters.get("cp_fsync_total"),
                           "ledger_fsyncs":
                               tm.counters.get("cp_ledger_fsyncs"),
                           **{k: int(v) for k, v in
                              server.cp_counters.items()}}}
    finally:
        cs.FedAvgServerManager._decode_model_payload = decode
        cs.FedAvgClientManager._apply_broadcast = apply_
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    ref, kill = runs["unkilled"], runs["killed"]
    if kill["cp"].get("restores") != 1 or ref["cp"].get("restores", 0):
        raise AssertionError(f"control plane: restores {kill['cp']} / "
                             f"{ref['cp']}")
    if fh.ledger_schedule(kill["ledger"]) != fh.ledger_schedule(
            ref["ledger"]) or [r["round"] for r in ref["ledger"]] != list(
            range(CP_R)):
        raise AssertionError(f"control plane: ledger schedules "
                             f"{fh.ledger_schedule(kill['ledger'])} / "
                             f"{fh.ledger_schedule(ref['ledger'])}")
    reported = [[r["reported"] for r in run["ledger"]] for run in (ref, kill)]
    if reported[0] != reported[1] or any(
            rep != list(range(CP_SILOS)) for rep in reported[0]):
        raise AssertionError(f"control plane: reporters {reported}")
    _check_same_model("control plane: the restored run's final model",
                      kill["model"], ref["model"])
    for name, run in runs.items():
        n = len(run["closes"])
        servers = [s for s, _ in run["closes"]]
        if run["launches"]["aggregate"] != n or n != run["closes_logged"] \
                or any(c != CP_SILOS for _, c in run["closes"]):
            raise AssertionError(
                f"control plane {name}: aggregation launches "
                f"{run['launches']['aggregate']} for {n} closes "
                f"({run['closes']}), {run['closes_logged']} ledger lines")
        if name == "killed" and (servers[:CP_CRASH] != ["server1"] * CP_CRASH
                                 or "server2" not in servers):
            raise AssertionError(f"control plane: closes by {servers}")
        if not run["fold_diff"] <= 1e-6:
            raise AssertionError(f"control plane {name}: the kernel's closes "
                                 f"against the streaming fold: "
                                 f"{run['fold_diff']}")
        # downlink off: every broadcast is full precision, every reply one
        # quantize on its silo and one dequantize where the server decodes
        if any(run["applies"]) or not all(run["decodes"]):
            raise AssertionError(f"control plane {name}: a compressed "
                                 "broadcast or a full-precision reply")
        _check_launches(f"control plane {name}", {
            k: run["launches"][k] for k in ("quant", "dequant")}, {
                "quant": len(run["applies"]),
                "dequant": len(run["decodes"])})
        if not run["cp"]["fsync_total"] or run["cp"]["capture_ms"] is None:
            raise AssertionError(f"control plane {name}: {run['cp']}")
    steered = [r["deadline_s"] for r in kill["ledger"]]
    out = {"round_wall_s": wall, "deadline_s": deadline,
           "steered_deadlines_s": {n: [r["deadline_s"] for r in run["ledger"]]
                                   for n, run in runs.items()},
           **{n: {k: run[k] for k in ("wall_s", "launches", "fold_diff",
                                      "cp")} | {
                      "closes": [c for _, c in run["closes"]],
                      "restored_closes": sum(
                          1 for s, _ in run["closes"] if s == "server2"),
                      "replies": len(run["applies"]),
                      "decodes": len(run["decodes"])}
              for n, run in runs.items()}}
    out["phase_s"] = time.perf_counter() - t0
    log(f"control plane ({_smi()}): CNN, {CP_SILOS} silos, delta_int8 up, "
        f"pace steering, async writer; round wall {wall:.4f} s -> base "
        f"deadline {deadline:.3f} s, steered {steered}; killed before the "
        f"round-{CP_CRASH} broadcast, restored once "
        f"({out['killed']['restored_closes']} closes by the restored "
        f"server), the ledger and the final model bit for bit the unkilled "
        f"run's; launches {out['unkilled']['launches']} / "
        f"{out['killed']['launches']} as the closes, replies and decodes "
        f"imply; the kernel vs the fold "
        f"{max(ref['fold_diff'], kill['fold_diff']):.3g}; cp_capture_ms "
        f"{ref['cp']['capture_ms']:.3f} / {kill['cp']['capture_ms']:.3f}, "
        f"cp_flush_ms {ref['cp']['flush_ms']:.3f} / "
        f"{kill['cp']['flush_ms']:.3f}, cp_fsync_total "
        f"{ref['cp']['fsync_total']} / {kill['cp']['fsync_total']} "
        f"(unkilled / killed); legs {ref['wall_s']:.1f} s, "
        f"{kill['wall_s']:.1f} s")
    log(f"phase 32 took {out['phase_s']:.1f} s")
    return out


#: phases 33-34's tenants (JobSpec fields): the CNN main path's model and
#: training at 4 silos, and the JAX suite's deadline tenant (``jobb``)
SCHED_CNN = dict(id="cnn", dataset="femnist_gen", workers=4, rounds=3,
                 batch_size=20, lr=0.1, epochs=1, compression="delta_int8",
                 share=2.0)
SCHED_LR = dict(id="lr", dataset="blob", workers=3, rounds=4, seed=7, dim=6,
                class_num=2, n_samples=150, batch_size=10, lr=0.1,
                compression="topk_ef_int8:0.1", round_deadline_s=2.0,
                heartbeat_s=0.3, share=1.0)


def _sched_specs():
    from fedml_tpu_torch.sched import JobSpec
    return JobSpec(**SCHED_CNN), JobSpec(**SCHED_LR)


def _zero_int8_launches() -> None:
    from fedml_tpu_torch.ops import quantize as tq
    tq.quantize_int8.launches = 0
    tq.dequantize_int8.launches = 0


def phase_tenancy(device="cuda"):
    """Phase 33: two tenants through ``launch_jobs`` on the card, each
    alone and then together, cuDNN deterministic (see the module
    docstring)."""
    import tempfile

    import torch
    from fedml_tpu_torch.obs.report import summarize
    from fedml_tpu_torch.sched import launch_jobs
    from fedml_tpu_torch.sched.chaos import solo_parity

    t0 = time.perf_counter()
    cnn, lr = _sched_specs()
    legs = {}
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sched_") as root:
            for name, specs in (("solo_cnn", [cnn]), ("solo_lr", [lr]),
                                ("shared", [cnn, lr])):
                _zero_int8_launches()
                t = time.perf_counter()
                res = launch_jobs(specs, os.path.join(root, name),
                                  obs=name == "shared", device=device,
                                  join_timeout_s=300)
                legs[name] = {"res": res,
                              "wall_s": time.perf_counter() - t,
                              "launches": _int8_launches()}
            report = summarize([os.path.join(root, "shared", "obs")])
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    shared = legs["shared"]["res"]
    for spec in (cnn, lr):
        ten = shared["jobs"][spec.id]
        solo = legs[f"solo_{spec.id}"]["res"]["jobs"][spec.id]
        err, ledger_ok, model_ok = solo_parity(solo, ten)
        if err or not (ledger_ok and model_ok) \
                or ten["history"] != solo["history"]:
            raise AssertionError(
                f"tenancy: job {spec.id} differs from its solo leg (error "
                f"{err}, ledger {ledger_ok}, model {model_ok})")
        rows = ten["ledger"]
        if [r["round"] for r in rows] != list(range(spec.rounds)) or any(
                r.get("partial") or len(r["reported"]) != spec.workers
                for r in rows):
            raise AssertionError(f"tenancy: job {spec.id}'s ledger {rows}")
        if not shared["device_time_s"].get(spec.id, 0.0) > 0.0:
            raise AssertionError(f"tenancy: job {spec.id} held the device "
                                 f"for {shared['device_time_s']}")
        if not report["jobs"].get(spec.id, {}).get("rounds"):
            raise AssertionError(
                f"tenancy: obs report {sorted(report['jobs'])}")
    solo_sum = {k: legs["solo_cnn"]["launches"][k]
                + legs["solo_lr"]["launches"][k] for k in ("quant", "dequant")}
    _check_launches("tenancy shared leg", legs["shared"]["launches"],
                    solo_sum)
    _check_launches("tenancy cnn solo leg", legs["solo_cnn"]["launches"],
                    _silo_launches(cnn.rounds, cnn.workers, cnn.compression))
    if not all(legs["solo_lr"]["launches"].values()):
        raise AssertionError(f"tenancy: the lr job launched "
                             f"{legs['solo_lr']['launches']}")
    per_job = {
        j: {"sched_device_time_s": r["phases"].get("sched_device_time"),
            "sched_gate_wait_s": r["phases"].get("sched_gate_wait"),
            "sched_device_acquires":
                r["counters"].get("sched_device_acquires"),
            "comm_bytes_up": r["counters"].get("comm_bytes_up"),
            "comm_bytes_down": r["counters"].get("comm_bytes_down")}
        for j, r in shared["jobs"].items()}
    out = {"launches": {n: leg["launches"] for n, leg in legs.items()},
           "wall_s": {n: leg["wall_s"] for n, leg in legs.items()},
           "device_time_s": shared["device_time_s"],
           "steady_device_time_s": shared["steady_device_time_s"],
           "fairness_ratio": shared["fairness_ratio"],
           "fairness_ratio_raw": shared["fairness_ratio_raw"],
           "per_job": per_job}
    out["phase_s"] = time.perf_counter() - t0
    log(f"tenancy ({_smi()}): cnn (femnist_gen CNN, 4 silos, 3 rounds, "
        f"delta_int8, share 2) and lr (blob LR, 3 silos, 4 deadline rounds, "
        f"topk_ef_int8:0.1, share 1) over one fabric and one gate: each "
        f"bit for bit its solo leg; int8 launches solo "
        f"{legs['solo_cnn']['launches']} + {legs['solo_lr']['launches']} = "
        f"shared {legs['shared']['launches']}; legs "
        + ", ".join(f"{n} {leg['wall_s']:.2f} s" for n, leg in legs.items())
        + f"; fairness_ratio {out['fairness_ratio']} (raw "
        f"{out['fairness_ratio_raw']}); per tenant "
        + "; ".join(f"{j}: sched_device_time {v['sched_device_time_s']:.4f} "
                    f"s, sched_gate_wait {v['sched_gate_wait_s']:.4f} s, "
                    f"{v['sched_device_acquires']} acquires"
                    for j, v in per_job.items()))
    log(f"phase 33 took {out['phase_s']:.1f} s")
    return out


def phase_tenancy_failover(device="cuda"):
    """Phase 34: the tenancy failover harness on the card, the ``lr`` job's
    server SIGKILLed and restarted while the ``cnn`` job survives (see the
    module docstring)."""
    import tempfile

    import torch
    from fedml_tpu_torch.sched.chaos import run_tenancy_failover

    t0 = time.perf_counter()
    cnn, lr = _sched_specs()
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as root:
            _zero_int8_launches()
            res = run_tenancy_failover(root, specs=[cnn, lr], victim=lr.id,
                                       device=device, timeout_s=240,
                                       join_timeout_s=240)
            launches = _int8_launches()
            victim = res["jobs"][lr.id]
            if not res["ok"]:
                with open(victim["server_log"]) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(f"tenancy failover: {res['jobs']}; the "
                                     f"victim server's log ends {tail}")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    surv = res["jobs"][cnn.id]
    if not (surv["ledger_identical_to_solo"]
            and surv["model_identical_to_solo"]
            and surv["ledger_rounds"] == cnn.rounds):
        raise AssertionError(f"tenancy failover: survivor {surv}")
    if victim["cp_restores"] < 1 or victim["rounds_completed"] != lr.rounds \
            or victim["killed_at_round"] != 2 \
            or len(victim["incarnations"]) != 2:
        raise AssertionError(f"tenancy failover: victim {victim}")
    # the survivor's solo and shared legs, and the victim's silos (their
    # replies and decodes; its server decodes in the subprocess)
    own = _silo_launches(cnn.rounds, cnn.workers, cnn.compression)
    if not all(launches[k] > 2 * own[k] for k in own):
        raise AssertionError(f"tenancy failover: int8 launches {launches}, "
                             f"the survivor's two legs alone {own} each")
    spawn = [inc["spawn_to_first_round_s"] for inc in victim["incarnations"]]
    out = {"launches": launches, "spawn_to_first_round_s": spawn,
           "cp_restores": victim["cp_restores"],
           "device_time_s": res["device_time_s"],
           "fairness_ratio": res["fairness_ratio"]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"tenancy failover ({_smi()}): the lr job's server (python -m "
        f"fedml_tpu_torch.sched serve --device {device}) SIGKILLed after "
        f"round 2, restarted and restored ({victim['cp_restores']} restore), "
        f"its 4 rounds complete; the cnn survivor bit for bit its solo leg; "
        f"spawn to first closed round {spawn[0]:.2f} s, then {spawn[1]:.2f} s "
        f"after the respawn; in-process int8 launches {launches}; "
        f"fairness_ratio {res['fairness_ratio']}")
    log(f"phase 34 took {out['phase_s']:.1f} s")
    return out


def _build_each_federation_once() -> None:
    """Each generated federation is built once in a run and handed to every
    later entry-point call with the same arguments: the builders are pure
    functions of them (byte-identical to the JAX package's) and no path
    writes into a dataset, so the paths see the same data while the run
    spends its time limit on the card, not on ~40 rebuilds."""
    from fedml_tpu_torch.data import flagship_gen, leaf_gen
    for mod, name in ((flagship_gen, "build_femnist_federation"),
                      (flagship_gen, "build_fedcifar100_federation"),
                      (flagship_gen, "build_stackoverflow_nwp_federation"),
                      (leaf_gen, "build_shakespeare_federation")):
        setattr(mod, name, functools.lru_cache(maxsize=None)(
            getattr(mod, name)))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    _build_each_federation_once()
    record = {"device": phase_device_and_build()}
    record["kernel"] = phase_kernel_vs_plain()
    record["main_path"] = phase_main_path()
    record["card_vs_cpu"] = phase_card_vs_cpu()
    record["fused_path"] = phase_fused_path()
    record["fused_bf16"] = phase_fused_bf16()
    record["fused_device_mode"] = phase_fused_device_mode()
    record["flash"] = phase_flash_vs_plain()
    record["lm_path"] = phase_lm_path()
    record["lm_card_vs_cpu"] = phase_lm_card_vs_cpu()
    record["lm_bf16"] = phase_lm_bf16()
    record["quant"] = phase_quant_vs_plain()
    record["silo_path"] = phase_cross_silo_path()
    record["silo_card_vs_cpu"] = phase_cross_silo_card_vs_cpu()
    record["fedopt_path"] = phase_fedopt_path()
    record["slice_algorithms"] = phase_slice_algorithms()
    record["slice_card_vs_cpu"] = phase_slice_card_vs_cpu()
    record["anchor_kernel"] = phase_anchor_kernel()
    record["resnet18_gn_path"] = phase_resnet18_gn_path()
    record["resnet56_path"] = phase_resnet56_path()
    record["lstm_paths"] = phase_lstm_paths()
    record["anchor_card_vs_cpu"] = phase_anchor_card_vs_cpu()
    record["zoo_kernel"] = phase_zoo_kernel()
    record["mobilenet_path"] = phase_mobilenet_path()
    record["zoo_models"] = phase_zoo_models()
    record["fedseg_path"] = phase_fedseg_path()
    record["zoo_card_vs_cpu"] = phase_zoo_card_vs_cpu()
    t_slice_f = time.perf_counter()
    record["split_vertical_paths"] = phase_split_vertical_paths()
    record["fedgkt_path"] = phase_fedgkt_path()
    record["fednas_path"] = phase_fednas_path()
    record["slice_f_card_vs_cpu"] = phase_slice_f_card_vs_cpu()
    record["slice_f_s"] = time.perf_counter() - t_slice_f
    log(f"phases 23-26 took {record['slice_f_s']:.1f} s")
    t_sockets = time.perf_counter()
    record["sockets"] = phase_cross_silo_sockets()
    record["sockets_card_vs_cpu"] = phase_cross_silo_sockets_card_vs_cpu()
    record["sockets_s"] = time.perf_counter() - t_sockets
    log(f"phases 27-28 took {record['sockets_s']:.1f} s")
    record["observability"] = phase_observability()
    record["fault_tolerance"] = phase_fault_tolerance()
    record["wan"] = phase_wan_world()
    record["control_plane"] = phase_control_plane()
    record["tenancy"] = phase_tenancy()
    record["tenancy_failover"] = phase_tenancy_failover()
    k = record["kernel"]
    zoo = record["zoo_models"]
    kernels = [{
        "name": "wmean_f32", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/aggregate.cu",
        "replaces": "fedml_tpu/ops/aggregate.py:27",
        "launches": record["main_path"]["launches"],
        "launches_fused": record["fused_path"]["launches"],
        "launches_fused_bf16": record["fused_bf16"]["launches"],
        "launches_fedopt": record["fedopt_path"]["host"]["launches"],
        "launches_fedopt_fused": record["fedopt_path"]["fused"]["launches"],
        "launches_slice": {k: v["launches"] for k, v in
                           record["slice_algorithms"].items()},
        "launches_anchors": {
            **{f"{m}_{mode}": record[f"{m}_path"][mode]["launches"]
               for m in ("resnet18_gn", "resnet56")
               for mode in ("host", "fused")},
            "resnet56_fedopt":
                record["resnet56_path"]["fedopt"]["launches"],
            **{m: record["lstm_paths"][m]["launches"]
               for m in ("shakespeare", "stackoverflow")}},
        "launches_zoo": {
            **{f"mobilenet_{mode}": record["mobilenet_path"][mode]["launches"]
               for mode in ("host", "fused")},
            **{f"{m}_{mode}": zoo[m][mode]["launches"]
               for m in ("mobilenet_v3", "vgg11", "efficientnet-b0")
               for mode in ("host", "fused")},
            **{f"mobilenet_{a}": zoo[f"mobilenet_{a}"]["launches"]
               for a in ("hierarchical", "turboaggregate")},
            **{f"fedseg_{loss}": record["fedseg_path"][loss]["launches"]
               for loss in ("ce", "focal")}},
        "launches_buffered_close":
            record["sockets"]["buffered_close"]["launches"],
        "launches_obs": record["observability"]["sim"]["launches"],
        "launches_deadline":
            record["fault_tolerance"]["deadline"]["launches"]["aggregate"],
        "deadline_close_c":
            record["fault_tolerance"]["deadline"]["close_c"],
        "launches_wan": record["wan"]["launches"]["aggregate"],
        "wan_close_c": record["wan"]["close_c"],
        "launches_cp": {leg: record["control_plane"][leg]["launches"][
            "aggregate"] for leg in ("unkilled", "killed")},
        "launches_slice_f": {
            **{a: record["split_vertical_paths"][a]["launches"]
               for a in ("vertical_fl", "split_nn")},
            "fedgkt": record["fedgkt_path"]["launches"],
            **{f"fednas_{v}": record["fednas_path"][v]["launches"]
               for v in ("darts", "gdas", "unrolled")}},
        "at_anchor_d": {m: {f: v[f] for f in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "library_ms")} for m, v in {
                **record["anchor_kernel"], **record["zoo_kernel"],
                "fednas": record["fednas_path"]["kernel"]}.items()},
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]}]
    for kern, name, line in (("fwd", "flash_fwd", 46),
                             ("dkdv", "flash_bwd_dkdv", 176),
                             ("dq", "flash_bwd_dq", 215)):
        t = record["flash"]["timing"][kern]
        kernels.append({
            "name": f"{name}_f32", "route": "cuda",
            "source": "fedml_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"fedml_tpu/ops/flash_attention.py:{line}",
            "launches": record["lm_path"]["launches"][kern],
            "launches_bf16": record["lm_bf16"]["launches"][kern],
            "max_abs_err": record["flash"]["max_abs_err"][kern],
            "max_abs_err_bf16": record["flash"]["max_abs_err_bf16"][kern],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_fwd_bwd_ms": t["library_fwd_bwd_ms"],
            "bound_ms_f32": t["bound_ms_f32"],
            "bound_ms_3xtf32": t["bound_ms_3xtf32"],
            "bound_ms_tf32": t["bound_ms_tf32"]})
    qt = record["quant"]["timing"]
    for kern, name, line in (("quant", "quantize_int8", 26),
                             ("dequant", "dequantize_int8", 40)):
        t, tk = qt["cnn_delta"][kern], qt["topk_survivors"][kern]
        sub = "quant_res" if kern == "quant" else "dequant_sub"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fedml_tpu_torch/csrc/quantize.cu",
            "replaces": f"fedml_tpu/ops/quantize.py:{line}",
            "launches": record["silo_path"]["launches"][kern],
            "launches_tcp": record["sockets"]["tcp"]["tcp"]["launches"][kern],
            "launches_routed":
                record["sockets"]["routed"]["routed"]["launches"][kern],
            "launches_resume": record["sockets"]["resume"]["launches"][kern],
            "launches_obs":
                record["observability"]["silo"]["launches"][kern],
            "launches_deadline":
                record["fault_tolerance"]["deadline"]["launches"][kern],
            "launches_wan": record["wan"]["launches"][kern],
            "launches_cp": {leg: record["control_plane"][leg]["launches"][
                kern] for leg in ("unkilled", "killed")},
            "launches_sched": {leg: record["tenancy"]["launches"][leg][kern]
                               for leg in ("solo_cnn", "solo_lr", "shared")},
            "launches_sched_failover":
                record["tenancy_failover"]["launches"][kern],
            "max_abs_err": record["quant"]["max_abs_err"][kern],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": (qt["cnn_delta"]["library_ms"]
                           if kern == "dequant" else None),
            "ms_at_k": tk["ms"], "bound_ms_at_k": tk["bound_ms"],
            "ms_residual_at_k": qt["topk_survivors"][sub]["ms"],
            "bound_ms_residual_at_k": qt["topk_survivors"][sub]["bound_ms"],
            "floor_ms": qt["floor_ms"]})
    kernels[-1]["library_ms_at_k"] = qt["topk_survivors"]["library_ms"]
    kernels[-1]["copy_ms"] = qt["cnn_delta"]["copy_ms"]
    kernels[-1]["copy_ms_at_k"] = qt["topk_survivors"]["copy_ms"]
    kernels = {"kernels": kernels}
    with open(os.path.join(ROOT, "runs", "chip_smoke", "record.json"),
              "w") as f:
        json.dump({**record, **kernels}, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


T0 = time.perf_counter()

if __name__ == "__main__":
    main()
