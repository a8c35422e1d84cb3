#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. the card (name and power limit from nvidia-smi), torch and CUDA;
  2. build every CUDA kernel from ``src/repro_torch/csrc`` (timed);
  3. kernels: at the main paths' shapes (P = 8 problems, N = 64
     particles, K = 12 steps, bucket (56, 144)) each of the nine kernel
     entries against its plain PyTorch version on the same inputs, float
     and quantized, τ = 0 and τ > 0: integers bit for bit, floats within
     rtol 1e-5 / atol 1e-4 (``epoch_fused``, ``masked_argmax``,
     ``pso_update`` and both ``edge_fitness`` bodies bit for bit; the
     float body also once at (P, N, n, m) = (1, 64, 203, 233), where its
     tiles pass a block's shared memory and live in device scratch);
     both timed with CUDA
     events, the kernel as the median of 5 runs (the entries the split
     epoch calls per problem are called and timed per problem),
     quantized and, for ``epoch_fused``, float, and each entry's device
     time under the profiler; ``pso_update`` also by its wrapper's host
     time alone; ``ullmann_refine_step`` also bit for bit for a uint8,
     int32 and bool M at the main path's shape, n < 32, (203, 233) and,
     past 256, (640, 700); then the nine kernels past n, m = 256 (their
     wide instantiations) on random problems at ``WIDE_CASES`` (300 x
     400, 512 x 512, 257 x 771, 1,000 x 1,100, where the bit planes
     live in device scratch, and 56 x 528; small P and N; every wide step
     and tail instantiation runs at one of them, which fails the phase
     if not), quantized and float, τ = 0 and τ > 0: every output bit for
     bit but S̄, within ``SBAR_ATOL``; then both fitness bodies past 256
     bit for bit at N = 1 on each wide case's projection tile (the
     Tier-0 call), on a swarm at (312, 528), on the all-255 tile with a
     dense G at m = 528 and past the row split's shared memory
     (``wide_fitness_cases``: every wide body ``pso_fitness.path`` can
     pick runs, or the phase fails); then ``epoch_finish`` on random
     problems with planted rows of 1.0 at the main path's (56, 144), M̂
     and the flags bit for bit and S̄'s difference recorded (a reading);
  4. the main path: 8 scheduling requests built as the IMMSched
     scheduler builds them (zoo workloads at window_stages=8 on the Cloud
     platform with a seeded set of 96 free engines, relabelled and padded
     to one bucket), solved by ``match_batch`` (quantized, early exit),
     re-validated by ``revalidate_batch`` (Tier 0), plus one float-config
     ``IMMSchedMatcher.match``; every returned mapping must be feasible
     and every kernel of the path must have been launched;
  4b. the matcher service (``core.service.MatcherService``, quantized,
     early exit) on the same 8 requests, bucketed by the service itself:
     a cold drain, a warm drain, an all-warm drain (every request at
     Tier 0, exactly one host sync) and a drift drain on a target with 4
     free engines swapped (Tier 1), then a float-config service match of
     unet, cold and warm; every served mapping must be feasible and each
     of the five main-path kernels must have been launched through the
     service. Measurement only: the warm and the all-warm drain under
     the profiler and the Tier-0 host phases per bucket;
  4c. the scheduler: the port's ``Simulator`` with ``IMMSchedScheduler`` in
     real mode (``validate=True``) on the Cloud platform at the burst's
     swarm width, over a compound-Poisson stream of bursts of 8
     (efficientnet, nasnet, pnasnet, about 70% urgent); each urgent
     arrival event is one drain of the service. Fails if the run is
     truncated or unfinished, if an invariant or the tier accounting
     fails, if a found mapping is infeasible, or if a quantized main-path
     kernel was not launched by the phase. The same simulation through
     the ``ref`` suite on the card must give the same ``SimResult`` (wall
     clocks and the suite's name aside) and every drain the same tiers,
     found, epochs and mappings. Prints one JSON line (tiers, drains,
     host syncs, matches, wall times, and the simulator's own scheduling
     times, which are cost-model seconds). Then the same scenario through
     all six schedulers in analytic mode (no launch): ``speedup_table``
     and ``energy_efficiency``;
  4d. warm restarts: 4b's service snapshots its store (after one more
     all-warm drain, the pre-restart drain), and a fresh service restores
     it and drains the same requests: every one at Tier 0, one host sync,
     the pre-restart mappings, feasible; ``verify_snapshot_roundtrip``
     holds; a cold service's first drain is timed beside it. Then a
     real-mode simulation of the simple restart scenario, cold and warm
     (``persist_dir``): every task finished, invariants held, and the
     warm run restores its snapshot and predictor states. One JSON line
     (save, restore and first-drain ms; each run's post-restart drain
     walls);
  4e. the mesh (``core/matcher.py``'s distributed paths on
     ``torch.distributed``) at the burst's width: a world of one in this
     process over NCCL and then over gloo on CUDA tensors (``FileStore``
     rendezvous), each running the particle-sharded match of every burst
     problem twice: every pass the same bits, and phase 4's found and
     epochs_run; then ``MESH_WORLD`` ranks spawned on the one card (gloo
     on CUDA tensors; ``--mesh-rank`` runs one): the particle-sharded
     match of one problem (4 × N particles), the problem-axis
     ``match_batch`` of the 8 and revalidation in both regimes bit for
     bit phase 4's, the small-B regime, and a mesh ``MatcherService``'s
     cold and warm drains (tier sums, feasible mappings). Fails on a
     check, a rank's non-zero exit or timeout, ranks that disagree, or a
     quantized main-path kernel not launched on every rank. One JSON
     line: backends, world sizes, walls of each op (the 4-rank walls are
     four processes time-sliced on one card, not a scale-out figure),
     collectives and host syncs a drain, launches per rank;
  4f. past n, m = 256, on a 512-engine platform (Cloud on a 16 x 32
     NoC, built here): (a) deepseek-7b, qwen-7b and llama3-8b mapped
     whole (window 256; buckets (312, 528) and (320, 512)) against its
     whole free engine graph, drained through a quantized service at the
     burst's swarm width, then again (Tier 0 first), then through a float
     service; the cold and float drains under the profiler (the card's
     activity alone). Every found mapping must be feasible on the host,
     (312, 528) must be among the buckets and each of the five main-path
     kernels launched. One JSON line a drain (bucket, found, feasible,
     tier a request; launches and device ms a kernel), then one
     ``wide_bucket`` line: the five at (312, 528) on deepseek-7b's
     problem (N = 64, K = 12), bit for bit against their plain versions,
     ms a call, device ms, plain ms, bound, the instantiation each ran
     and, for ``epoch_fused``, the bound of the state it moves (below,
     ``epoch_state_bound``); then one ``window_bucket`` line: the epoch
     and its tail the same way at the window-8 bucket (56, 528), on
     pnasnet's window-8 problem on the platform. (b) phase 4c's scenario on
     the platform (window 8: buckets up to (56, 528)), real mode, run to
     its end with every found mapping feasible, then once more under the
     profiler; one ``wide_sched`` line (tasks, urgent met, drains, run
     wall, idle share, and the first run's epoch calls by P, N, n, m and
     branch with the step kernel each took);
  5. the split (pre-fusion) epoch: ``core.split_epoch.split_epoch``
     through the ``cuda`` suite on each problem of the burst, float and
     quantized, plus ``masked_argmax`` through the seam on each returned
     S*; every kernel of the path must have been launched, and the
     results must equal the fused epoch's (``epoch_fused`` →
     ``epoch_finish``, τ = 0) on the same inputs (the loose scan and the
     recomputed fitness bit for bit, M̂ and the feasibility flags
     exactly, S̄ within rtol 1e-5 / atol 1e-4); both timed per problem.
     Then the same on deepseek-7b's problem at (312, 528) as phase 4f
     builds it (N = 64, K = 12), where the four run their wide
     instantiations, and one ``wide_bucket_split`` line: the four there,
     bit for bit against their plain versions, ms a call, device ms,
     plain ms, bound and the split epoch's launches;
  6. path parity: the same burst at a reduced swarm through the ``cuda``
     and the ``ref`` suite on the same draws must give the same first
     epoch;
  7. profile: device time by kernel over one more ``match_batch`` of the
     burst, and the device's idle share of its wall time;
  8. the LM serve path (``repro_torch.launch.serve``; no hand kernel: the
     JAX package's LM stack has no Pallas kernel): (a) qwen2.5-3b and
     qwen2-vl-7b at the reference smoke tests' size, float32, on the card
     against the CPU on the same weights: train logits, prefill and 8
     greedy decode steps within rtol 2e-4 / atol 2e-4, tokens equal; the
     same for deepseek-v2-236b, arctic-480b, xlstm-1.3b, zamba2-7b and
     seamless-m4t-medium, their free-running steps held with float32
     caches and each bfloat16-cache step from the CPU's caches
     (``_tiny_family_parity``); (b) qwen1.5-0.5b at its published size
     (24 layers, 463,987,712 parameters, float32 weights, bfloat16
     compute), (c) qwen2.5-3b and qwen2-vl-7b at full width with 4
     layers, and (d) those five at full width (deepseek 3 layers: its
     dense block0 and 2 MoE blocks; arctic 1 MoE block; xlstm, zamba2
     and seamless at their published depths; the parameter counts the
     reference's initialisers give), each served twice with
     launch/serve's defaults (batch 4, prompt 64, 32 tokens): finite
     logits, every token in the vocabulary, and the teacher-forcing
     identity (prefill over t + 1 tokens against prefill over t and one
     decode step) within ``SERVE_TF_ULPS`` bfloat16 units (an MoE on one
     row at t = 7, so that no pass can drop an assignment, an
     encoder-decoder with frames as long as its caches; xlstm and zamba2
     at float32 compute and caches within ``SERVE_TF_FLOAT32`` of the
     largest |logit|, their bfloat16 figure recorded). One ``serve``
     JSON line: per model the parameters, prefill ms, decode ms a token
     (median after the first step), tokens/s, the first call's ms, peak
     memory, the decode bound (parameter bytes at 3.35 TB/s) and one
     decode step under the profiler (launches, device time, idle
     share);
  9. the LM training path (``repro_torch.launch.train``,
     ``runtime/train_loop.py``, ``optim/``; no hand kernel): (a) seven
     configs at the smoke tests' size, float32, one adamw and one
     adafactor step of two microbatches on the card against the CPU on
     the same weights and batch (loss, grad norm, every gradient leaf,
     every parameter after the step); (b) qwen1.5-0.5b at its published
     size through ``launch.train.main`` at its defaults, 8 steps with
     checkpoints, then the same command resumed at step 4 with the same
     losses, then 30 steps on one repeated batch (the loss must fall by
     more than 1) and each other remat form timed; (c) qwen1.5-110b at
     full width and 2 layers with the giants' policy (adafactor,
     bfloat16 states and weights, 16 microbatches), 3 steps, finite,
     the reference's parameter count and factored state; (d)
     ``compressed_psum_tree`` over NCCL (int8 on the wire) against gloo.
     One ``train`` JSON line: per model the parameters, step ms (median
     after the first), the first step's ms, tokens/s, peak memory, the
     compute bound and one profiled step (launches, device ms, host
     syncs, idle share).
  10. the sharded LM path (``runtime/{sharding,mesh_ctx,shard}.py``,
     the train and serve steps on a mesh; no hand kernel): (a) a world
     of one over NCCL on a (1, 1) mesh: a tiny config of every family
     (phase 9 (a)'s), one adamw and one adafactor step of two
     microbatches, and phase 8 (a)'s prefill and greedy decode with
     float32 caches, through the mesh code path, against the
     one-device step and decode on the card on the same weights and
     batch (phase 9's tolerances, logits within 2e-4, equal tokens);
     (b) four ranks spawned on the one card (gloo on CUDA tensors,
     ``chip_smoke.py --lm-mesh-rank r --mesh-dir DIR``) on a (2, 2) mesh
     with qwen1.5-0.5b at full width, 6 of its 24 layers, in two
     passes, each held against a
     one-device run in this process on the same weights and batches.
     The bfloat16 pass, launch/train's defaults (batch 8 x 256, adamw,
     remat "block"), 3 steps, then launch/serve's batch and prompt (4 x
     64, 8 tokens) fed the one-device run's tokens: losses and
     grad norms within ``LM_MESH_BF16_RTOL``, every step's logits within
     ``SERVE_TF_ULPS`` units of the largest |logit|, the greedy tokens
     equal wherever the one-device top-2 margin exceeds twice that, each
     rank's resident parameters, optimizer state and accumulators at
     most ``LM_MESH_SHARE`` of the one device's. The float32 pass, the
     same at float32 compute and caches: losses and grad norms within
     1e-5, the first step's gradient slices within 1e-4 of each leaf's
     largest |g|, the parameter slices after the steps within 2e-6 (or
     Adam's sign flips), the gathered state saved in the reference's
     tree and resumed on one device with the same parameters and next
     loss, then serve on the one device's bfloat16-trained weights:
     logits within rtol 2e-4 / atol 2e-4, tokens equal. One ``lm_mesh``
     JSON line: per rank the step ms, decode ms a token, collectives and
     bytes moved a step and a token, peak memory; the 4-rank walls are
     processes time-sliced on one card, not a scale-out figure. (c)
     the MoE family on the same mesh, four ranks spawned the same way
     (``chip_smoke.py --moe-mesh-rank r``): the tiny deepseek and
     arctic of (a) at a capacity factor at which the global batch
     drops (each rank against the one device, the drop counts equal
     and above 0); deepseek-v2-236b at full width, a float32 serve at
     block0 + 1 MoE block (logits within 2e-4, equal tokens and
     drops), then a bfloat16 train step there (adafactor, one
     microbatch; loss, grad norm, each leaf's changed share, the next
     batch's loss) and a bfloat16 serve there too (each serve a prefill
     and one decode step), each
     model built by the ranks in turn from the seed and held against a
     one-device run in this process (``MOE_MESH_*``). One ``moe_mesh``
     JSON line: per rank the resident bytes, collectives and bytes a
     step and a token (the latent caches' gathers apart), step and
     decode ms, peak memory and the global drops. (d) the xLSTM,
     Mamba2-hybrid and encoder-decoder families on the same mesh
     (``chip_smoke.py --ssm-mesh-rank r``): the tiny xlstm, zamba2 and
     seamless of (a), each rank against the one device; zamba2-7b at
     full width cut to 7 layers (one group of 6 Mamba2 blocks, the
     shared attention and a tail of 1), in a float32 pass (a serve,
     logits within 2e-4 and equal tokens; two train steps at
     launch/train's defaults, loss, grad norm and the next batch's loss
     within 1e-5) and a bfloat16 pass (the same, held within the one
     device's own bfloat16 error where that is larger than the fixed
     bounds), each leaf's changed share in both; xlstm-1.3b at full
     width, one group, a float32
     serve, its resident parameters exactly its slices' bytes
     (``SSM_MESH_*``). One ``ssm_mesh`` JSON line: per rank the
     collectives and bytes a step and a token, step, first-step and
     decode ms, peak memory, the resident shares and every check's
     number.
     (e) sequence-sharded caches and batches, four ranks spawned the
     same way (``chip_smoke.py --seq-mesh-rank r``) on two meshes of
     one world, (2, 2) and (1, 4): the tiny config of every family at a
     batch of 1 on (2, 2) (the prompt and the KV, latent and memory
     caches cut on the sequence over the data axis; one KV head: also
     Dh over the model axis) and the GQA families' at 2 KV heads on
     (1, 4) (the cache cut on S over the model axis, flash-decode), a
     serve and a train step each against the one device; qwen2.5-3b at
     full width on (1, 4), a float32 serve (logits within 2e-4, equal
     tokens) and a bfloat16 one (within the one device's own bfloat16
     error), both at 4 of its 36 layers since phase 4f took the run's
     time, then a float32 and a bfloat16 train step at 4 layers
     (wk/wv's gradients against the one device's); zamba2-7b and
     xlstm-1.3b at a batch of 1 on (2, 2), float32, a prompt of 64 into
     caches of 4,096 and 3 tokens (``SEQ_MESH_*``). One ``seq_mesh`` JSON line: per
     rank the collectives and bytes a prefill, a token and a step,
     prefill, decode and step ms, peak memory, the resident shares and
     every check's number. (f) model axes that do not divide MLA's or
     Mamba2's heads, eight ranks spawned the same way
     (``chip_smoke.py --odd-mesh-rank r``): all eight as (1, 8), then
     the first six as (2, 3), each in a world of its own; the tiny
     deepseek (its latent rank cut with its heads whole on (1, 8),
     neither cut on (2, 3), at 6 heads its heads cut with the latent
     whole) and zamba2 (its conv and out_proj cut, in_proj whole and
     the state cut on N on (1, 8); in_proj and conv cut, out_proj and
     the state whole on (2, 3)), a serve and an AdamW step pair each
     against the one device; zamba2-7b at (d)'s cut on (2, 3), a
     float32 serve and two float32 train steps against (d)'s one-device
     run, each rank's resident parameters, accumulators and optimizer
     state exactly its slices' bytes. One ``odd_mesh`` JSON line: per
     rank the tiny records, step, decode and prefill ms, collectives
     and bytes, peak memory and the resident bytes beside the rules'.
  11. the last entry points (``repro_torch.examples`` and
     ``repro_torch.launch.dryrun``): (a) ``online_service``,
     ``interruptible_serving`` and ``schedule_multi_dnn`` with ``--device
     cuda`` at their defaults: every mapping the service serves is
     feasible (numpy, against its query and target) and every arrival it
     reports infeasible is one it found none for; IMMSched meets the
     urgent deadline, and the IsoSched and MoCA rows (analytic) equal
     the same example's run on the CPU (wall clocks aside); the
     multi-DNN co-schedule is found with no ILP violation; each
     example's wall ms and launches; then ``online_service`` once more
     through the ``ref`` suite (``REPRO_KERNEL_BACKEND=ref``) on the
     same draws, which must launch nothing and serve each arrival as the
     ``cuda`` suite did (bucket, cache, warm start, epochs, found, the
     mapping itself). (b) and (c) in a process of their own
     (``chip_smoke.py --dryrun-rank 0``), rank 0 of a fake process group
     of 256 (``torch.testing._internal.distributed.fake_pg``) on the
     16 x 16 mesh: the dry run's matcher cell on the card (128 x 128,
     ``PSOConfig(32, 4, 12, quantized=True)``, the swarm over all 256
     shards; its collectives, launches and bytes), held against the
     same call through the ``ref`` suite on the same streams: every
     output leaf equal bit for bit, the float consensus S̄ within
     ``DRYRUN_SBAR_ATOL``; then qwen2.5-3b's ``decode_32k`` cell on
     ``meta``, which must allocate nothing on the card; its record
     beside the card's ``total_memory``. One ``entry`` JSON line.

The second-to-last line is the ``kernels`` JSON record (one row per
kernel entry and one for ``epoch_fused``'s float branch; ``launches``
counts device launches on the main or split path, ``launches_per_call``
divides them by the wrapper calls that made them, ``service_launches``
counts the launches of phase 4b, ``sched_launches`` those of phase 4c,
``restart_launches`` those of phase 4d, ``mesh_launches`` those of
phase 4e summed over its processes, ``wide_launches`` those of phase 4f
(a)'s drains, ``entry_launches`` those of phase 11 (its examples and its
matcher cell); every row also carries ``wide_bucket``, its ms, device
ms, plain ms, bound and launches at (312, 528): phase 4f's for the five
main-path rows (launches of (a)'s drains), phase 5's for the four
others (launches of its split epoch there);
the float branch's launches are counted by its wrapper on their own and
left out of the ``epoch_fused`` row; ``device_ms`` is a call's device
time, ``host_ms`` the wrapper's host time alone, ``bound_note`` what a
bound leaves out),
the last line ``{"ok": true, "device": {...}}``. With ``--out DIR`` the
details (a JSON record and the profiler's table) are also written to DIR.
"""
import argparse
import collections
import contextlib
import copy
import dataclasses
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORKLOADS = ("pnasnet", "unet", "nasnet", "resnet50", "mobilenetv2",
             "efficientnet", "deepseek-7b", "qwen-7b")
N_FREE, FREE_SEED, SEED = 96, 0, 0
N, K = 64, 12
# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
L2_BYTES = 50e6
#: dense bfloat16 tensor-core peak, the training phase's compute bound
#: (same data sheet)
PEAK_BF16 = 989e12
PEAK = {"fp32": 67e12, "int8": 1979e12}
KERNELS = {   # entry → (CUDA source, TPU kernel it replaces)
    "prune_fixpoint": ("src/repro_torch/csrc/prune_fixpoint.cu",
                       "src/repro/kernels/prune_fixpoint.py:102"),
    "edge_fitness": ("src/repro_torch/csrc/pso_fitness.cu",
                     "src/repro/kernels/pso_fitness.py:111"),
    "edge_fitness_quantized": ("src/repro_torch/csrc/fitness_quantized.cu",
                               "src/repro/kernels/pso_fitness.py:132"),
    "epoch_fused": ("src/repro_torch/csrc/epoch_fused.cu",
                    "src/repro/kernels/epoch_fused.py:251"),
    "epoch_finish": ("src/repro_torch/csrc/finish_fused.cu",
                     "src/repro/kernels/finish_fused.py:373"),
    "pso_update": ("src/repro_torch/csrc/pso_update.cu",
                   "src/repro/kernels/pso_update.py:84"),
    "ullmann_refine_step": ("src/repro_torch/csrc/ullmann_refine.cu",
                            "src/repro/kernels/ullmann_refine.py:61"),
    "greedy_project": ("src/repro_torch/csrc/argmax_project.cu",
                       "src/repro/kernels/argmax_project.py:63"),
    "masked_argmax": ("src/repro_torch/csrc/argmax_project.cu",
                      "src/repro/kernels/argmax_project.py:97"),
}
#: the float branch of epoch_fused, timed and listed as its own row
FLOAT_EPOCH = "epoch_fused_float"
#: entries held bit for bit against their plain version in phase 3 (the
#: others' integer outputs are equal too; their float outputs are held
#: within the tolerance)
BITWISE = ("epoch_fused", "masked_argmax", "edge_fitness",
           "edge_fitness_quantized", "pso_update", "ullmann_refine_step")
#: (B, n, m) of phase 3's extra ullmann_refine_step calls, each M dtype:
#: n < 32, past a block's shared memory for an int32 M, and past 256 with
#: a matrix's bit planes in device scratch (the wide instantiation)
REFINE_EXTRA = ((5, 13, 37), (3, 203, 233), (3, 640, 700))
#: what a bound by bytes or operations leaves out: chains of dependent
#: rounds, whose length sets the kernel's time
BOUND_NOTES = {
    "prune_fixpoint": "a chain of up to 6 dependent sweeps a problem is "
                      "not counted",
    "epoch_finish": "a chain of 2n argmax rounds and up to 6 sweeps a "
                    "particle is not counted",
    "greedy_project": "a chain of up to n dependent argmax rounds a "
                      "particle (n = 56) is not counted",
}
#: (P, N, n, m) of phase 3's extra float fitness call: tiles past a
#: block's shared memory
FITNESS_LARGE = (1, 64, 203, 233)
#: the kernels of the main path, in phase 4 and through the service
MAIN_KERNELS = ("prune_fixpoint", "edge_fitness", "edge_fitness_quantized",
                "epoch_fused", "epoch_finish")
#: the kernels the split epoch phase drives (the fitness entries too)
SPLIT_KERNELS = ("pso_update", "ullmann_refine_step", "greedy_project",
                 "masked_argmax", "edge_fitness", "edge_fitness_quantized")
#: phase 4c: the scheduler's real-mode simulation on the Cloud platform,
#: at the burst's swarm width; the quantized main-path kernels it must
#: launch (the scheduler's service is quantized, so no float fitness)
SCHED_SCENARIO = dict(complexity="middle", rate_hz=30, horizon=0.4,
                      burst_size=8, burst_frac=0.8, urgent_frac=0.7, seed=5)
SCHED_SWARM = dict(num_particles=N, epochs=4, inner_steps=K)
SCHED_WINDOW = 8
SCHED_KERNELS = ("prune_fixpoint", "edge_fitness_quantized", "epoch_fused",
                 "epoch_finish")
SCHEDULERS = ("immsched", "isosched", "prema", "planaria", "moca", "cdmsa")
#: phase 3 past n, m = 256 (the nine kernels' wide instantiations): (n, m)
#: → (P, N) of random problems, K = 2 steps. Every wide step and tail
#: kernel runs at one of them: epoch_fused's cluster path at (300, 400)
#: (C = 4 quantized, 8 float) and, float, at the window-8 bucket
#: (56, 528) (C = 2), step_kernel at (512, 512), (257, 771) and,
#: quantized, (56, 528) (80 particles, past the 64 up to which the
#: clusters take a shape whose tiles fit in shared memory),
#: step_wide_kernel at (1000, 1100); epoch_finish's staged kernel at
#: (300, 400) and (56, 528), the wide one at the rest, its planes in
#: device scratch at (1000, 1100). Small P and N, so that the plain
#: versions finish in seconds
WIDE_CASES = {(300, 400): (2, 8), (512, 512): (1, 8), (257, 771): (2, 4),
              (1000, 1100): (1, 2), (56, 528): (2, 40)}
WIDE_K = 2
#: phase 3's wide fitness cases beside each WIDE_CASES problem's Tier-0
#: call (P, N, n, m): a swarm at the wide bucket's shape (the row split's
#: 32 rows a CTA), the all-255 tile with a dense G there (S G past 2^16,
#: three byte planes), and a shape past the row split's shared memory
#: (the one-CTA-a-particle bodies)
FITNESS_WIDE_SWARM = (1, 64, 312, 528)
FITNESS_DENSE = (1, 2, 312, 528)
FITNESS_FALLBACK = (1, 2, 8, 7300)
#: ``counted_fitness``: the ops entry of each fitness body, by quantized
FITNESS_OPS = {False: "edge_fitness", True: "edge_fitness_quantized"}
#: phase 3's reading of the narrow S̄ on planted rows of 1.0: (P, N, n, m)
#: at the main path's bucket
NARROW_PLANTED = (2, 64, 56, 144)
#: epoch_finish's S̄ against its plain version (another summation order
#: up to n, m = 256; the same past it)
SBAR_ATOL = 1.19e-7
#: phase 4f, the main path past 256: a 512-engine accelerator (a 16 x 32
#: NoC; the reference names no such platform, so it is built here from
#: Cloud), the complex workloads mapped whole (window 256: deepseek-7b
#: 308 tiles, bucket (312, 528); qwen-7b and llama3-8b 320, bucket
#: (320, 512)) against its whole free engine graph, drained through the
#: service at the burst's swarm width, quantized; then the same burst
#: again (Tier 0), then through a float service. (b) phase 4c's scenario
#: on it (window 8: n <= 56, m up to 528)
WIDE_PLATFORM = dict(name="cloud-512", engines=512, noc_rows=16,
                     noc_cols=32)
WIDE_WORKLOADS = ("deepseek-7b", "qwen-7b", "llama3-8b-wl")
WIDE_WINDOW = 256
WIDE_SWARM = dict(num_particles=N, epochs=4, inner_steps=K)
WIDE_BUCKET = (312, 528)
#: the window-8 bucket on that platform (phase 4f (b)'s scheduler):
#: pnasnet's first window, measured like WIDE_BUCKET
WINDOW_BUCKET = (56, 528)
WINDOW_WORKLOAD = "pnasnet"
#: phase 4e: ranks spawned on the one card, their limits, and the kernels
#: the mesh path must launch on every rank (quantized: no float fitness)
MESH_WORLD = 4
MESH_TIMEOUT_S = 480
MESH_GROUP_TIMEOUT_S = 120
MESH_KERNELS = ("prune_fixpoint", "edge_fitness_quantized", "epoch_fused",
                "epoch_finish")
#: phase 8: the LM serve path. launch/serve's defaults; qwen1.5-0.5b at
#: its published size (full width, full depth); qwen2.5-3b and qwen2-vl-7b
#: at full width and SERVE_WIDE_LAYERS layers; the card against the CPU at
#: the reference smoke tests' size, float32, within SERVE_TOL
SERVE_ARGS = dict(batch=4, prompt_len=64, gen=32)
SERVE_FULL = "qwen1.5-0.5b"
SERVE_WIDE = ("qwen2.5-3b", "qwen2-vl-7b")
SERVE_WIDE_LAYERS = 4
SERVE_TINY = ("qwen2.5-3b", "qwen2-vl-7b")
SERVE_TINY_ARGS = dict(batch=4, prompt_len=16, gen=9)   # 8 decode steps
#: the other families at full width, at these depths (None: the
#: published one): deepseek's dense block0 and 2 MoE blocks, one arctic
#: MoE block with its dense residual; each model's parameter count,
#: reckoned from the reference's initialisers (jax.eval_shape of its
#: init at that depth)
SERVE_FAMILIES = {
    "deepseek-v2-236b": (3, 9_330_795_520),
    "arctic-480b": (1, 14_069_945_344),
    "xlstm-1.3b": (None, 3_530_504_528),
    "zamba2-7b": (None, 6_727_887_072),
    "seamless-m4t-medium": (None, 978_805_760),
}
#: an MoE's teacher-forcing identity: 1 row, a prefix of 7 tokens. An
#: expert takes a token at most once, so a pass over at most 8 tokens
#: (the least capacity) drops no assignment, whatever the routing; with
#: launch/serve's batch of 4 the random router sends 9 of deepseek's 216
#: assignments past capacity at t = 8 (a CPU rehearsal at d_model 128)
SERVE_TF_MOE = dict(batch=1, t=7)
#: the recurrent families (xlstm, zamba2): prefill runs the chunked form,
#: decode the recurrent one on a state cached in bfloat16, and at
#: bfloat16 compute the two round apart by more than SERVE_TF_ULPS in the
#: reference itself (CPU, 24 layers at d_model 512 / 1024: zamba2 0.135–
#: 0.255, xlstm 0.537–0.598, against 0.125–0.25). So their identity is
#: held at float32 compute with float32 caches (the same weights), where
#: both packages stay within 1.1e-5–1.9e-4 at those sizes: within this
#: share of the largest |logit|, 2^-10, which leaves room for 48 and 81
#: layers and still fails a wrong position, mask or state (O(1)); the
#: bfloat16 figure is recorded
SERVE_TF_FLOAT32 = 2.0 ** -10
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
#: the teacher-forcing identity at bfloat16 compute, in units in the last
#: place of the largest |logit|: prefill over t + 1 tokens (the repeated-K
#: products) and prefill over t then one decode step (the grouped
#: products) sum in other orders, and every block rounds its products,
#: norms and residual adds to bfloat16 (8 significant bits), so a logit
#: may move by a few units; 8 units leaves room and still fails a wrong
#: position, mask or cache entry, which moves logits by O(1)
SERVE_TF_ULPS = 8
#: phase 9: the LM training path. (a) one model a family at tiny_config,
#: float32, the card against the CPU on the same weights and batch: one
#: adamw and one adafactor step of TRAIN_TINY_CFG, two microbatches
TRAIN_TINY = ("qwen2.5-3b", "qwen2-vl-7b", "deepseek-v2-236b",
              "arctic-480b", "xlstm-1.3b", "zamba2-7b",
              "seamless-m4t-medium")
TRAIN_TINY_CFG = dict(microbatches=2, learning_rate=1e-3, warmup_steps=1,
                      total_steps=10)
TRAIN_TINY_BATCH = dict(batch=4, seq=16, patches=8, frames=16)
#: the card against the CPU (float32, TF32 off): each gradient leaf within
#: TRAIN_GRAD_RTOL of its largest |g| (+1e-6), the loss and grad norm
#: within TRAIN_METRIC_RTOL; a parameter within TRAIN_STEP_TOL after the
#: step, or, where Adam's normalisation flips a near-zero gradient's sign,
#: within 2·lr: at most TRAIN_FLIP_SHARE of the elements
TRAIN_GRAD_RTOL = 1e-4
TRAIN_METRIC_RTOL = 1e-5
TRAIN_METRIC_RTOL_BY = dict(losses=TRAIN_METRIC_RTOL,
                            grad_norms=TRAIN_METRIC_RTOL)
TRAIN_STEP_TOL = 2e-6
TRAIN_FLIP_SHARE = 1e-3
#: phase 10's MoE: a factored leaf's row or column whose non-zero
#: gradient is rounding noise in the one-device run (at most this share
#: of the leaf's largest |g|; its exact value is 0: the router's column
#: of an expert that no token chose, which the top-k renormalisation
#: cuts off the loss) is scaled by Adafactor's factored normaliser to
#: steps of O(1), each run's from its own noise, and through the RMS
#: clip over the whole leaf moves every element of it. Such a leaf (the
#: mesh's gradient must be noise there too) is counted and left out of
#: the parameter check after the steps, and the sharded Adafactor is
#: held instead on the same gradients (``_same_grads``)
TRAIN_ZERO_GRAD = 1e-7
#: (b) qwen1.5-0.5b at its published size through launch/train's main at
#: its defaults (batch 8 x seq 256, the production policy): 8 steps
#: with a checkpoint every 4, then a resume at step 4; then
#: TRAIN_MEMO_STEPS steps on one repeated batch through make_train_step
#: at TRAIN_MEMO_CFG (the policy's 100 warmup steps would hold lr near 0),
#: whose loss must fall by more than TRAIN_MEMO_DROP (the reference's own
#: criterion, tests/test_runtime.py)
TRAIN_FULL = "qwen1.5-0.5b"
TRAIN_FULL_PARAMS = 463_987_712
TRAIN_LAUNCH_ARGS = ["--steps", "8", "--checkpoint-every", "4",
                     "--log-every", "1"]
TRAIN_RESUME_AT = 4
TRAIN_MEMO_STEPS = 30
TRAIN_MEMO_CFG = dict(learning_rate=3e-4, warmup_steps=5, total_steps=30)
TRAIN_MEMO_DROP = 1.0
#: measurement only: TRAIN_REMAT_STEPS steps of TRAIN_FULL with each other
#: remat form (a fresh model each), beside the policy's "block"
TRAIN_REMAT_STEPS = 6
TRAIN_BATCH, TRAIN_SEQ = 8, 256
#: (c) the giants' policy at qwen1.5-110b's full width, cut to
#: TRAIN_GIANT_LAYERS layers (a reckoned peak of ~50 GB: bfloat16 weights
#: 10.4 GB, float32 accumulators 20.8 GB, a microbatch's bfloat16
#: gradients 10.4 GB or the embedding leaf's float32 temporaries, 5.0 GB
#: each): adafactor with bfloat16 states, bfloat16 parameters, 16
#: microbatches of 1 x 256, TRAIN_GIANT_STEPS steps. The parameter count
#: and the factored state's shapes are the reference's (jax.eval_shape of
#: its init and of adafactor's init at 2 layers)
TRAIN_GIANT = "qwen1.5-110b"
TRAIN_GIANT_LAYERS = 2
TRAIN_GIANT_PARAMS = 5_209_387_008
TRAIN_GIANT_STEPS = 3
TRAIN_GIANT_BATCH = 16
TRAIN_GIANT_FACTORS = {
    ("blocks", "attn", "bk"): {"vr": (2, 8), "vc": (2, 128)},
    ("blocks", "attn", "bq"): {"vr": (2, 64), "vc": (2, 128)},
    ("blocks", "attn", "bv"): {"vr": (2, 8), "vc": (2, 128)},
    ("blocks", "attn", "wk"): {"vr": (2, 8192, 8), "vc": (2, 8192, 128)},
    ("blocks", "attn", "wo"): {"vr": (2, 64, 128), "vc": (2, 64, 8192)},
    ("blocks", "attn", "wq"): {"vr": (2, 8192, 64), "vc": (2, 8192, 128)},
    ("blocks", "attn", "wv"): {"vr": (2, 8192, 8), "vc": (2, 8192, 128)},
    ("blocks", "ffn", "down"): {"vr": (2, 49152), "vc": (2, 8192)},
    ("blocks", "ffn", "gate"): {"vr": (2, 8192), "vc": (2, 49152)},
    ("blocks", "ffn", "up"): {"vr": (2, 8192), "vc": (2, 49152)},
    ("blocks", "ln1", "scale"): {"vr": (2,), "vc": (8192,)},
    ("blocks", "ln2", "scale"): {"vr": (2,), "vc": (8192,)},
    ("embed",): {"vr": (152064,), "vc": (8192,)},
    ("final_ln", "scale"): {"v": (8192,)},
    ("lm_head",): {"vr": (8192,), "vc": (152064,)},
}

#: phase 10: the sharded LM path. (a) a world of one over NCCL, the tiny
#: dense and vlm configs (phase 9's tolerances; serve within SERVE_TOL);
#: (b) LM_MESH_WORLD ranks on the one card on an LM_MESH_SHAPE mesh with
#: LM_MESH_ARCH at full width and LM_MESH_LAYERS deep, LM_MESH_STEPS
#: steps at launch/train's defaults, then launch/serve's defaults, in two passes against the one
#: device on the same weights. The float32 pass (float32 compute and
#: caches) holds the state: phase 9's criteria (loss and grad norm within
#: TRAIN_METRIC_RTOL, the first step's every gradient leaf within
#: TRAIN_GRAD_RTOL of its largest |g|, the parameters after the steps
#: within TRAIN_STEP_TOL or, on at most TRAIN_FLIP_SHARE of them, within
#: twice the steps' summed learning rates), its checkpoint resumed on one
#: device the same way, logits within SERVE_TOL and equal tokens. The
#: bfloat16 pass (the production policy) gives the timings: its loss and
#: grad norm within LM_MESH_BF16_RTOL (about 20 and 10 times what the
#: (2, 2) mesh showed: 4.5e-6 and 5.2e-4; the column-parallel products'
#: input gradients still sum partials rounded to bfloat16), each step's
#: logits within SERVE_TF_ULPS units of the largest |logit| (a
#: row-parallel product's partial sums are taken at float32 and rounded
#: once, as on one device), its greedy tokens equal wherever the one
#: device's top-2 margin exceeds twice that. Each rank's resident parameters, optimizer state and
#: float32 accumulators at most LM_MESH_SHARE of the one device's (a
#: quarter, plus the norm scales and biases the rules keep whole or cut
#: over one axis)
LM_MESH_TINY = ("qwen2.5-3b", "qwen2-vl-7b", "deepseek-v2-236b",
                "arctic-480b", "xlstm-1.3b", "zamba2-7b",
                "seamless-m4t-medium")
LM_MESH_ARCH = "qwen1.5-0.5b"
#: (b)'s depth: 6 of the config's 24 layers at its published widths
#: (12 since phase 10 (f) took the whole run to 974.2 s on an H100, 6
#: since phase 4f took it to 1,140.3 s in a slow call; PERF.md §4)
LM_MESH_LAYERS = 6
LM_MESH_WORLD = 4
LM_MESH_SHAPE = (2, 2)
LM_MESH_STEPS = 3
LM_MESH_TIMEOUT_S = 600
LM_MESH_GROUP_TIMEOUT_S = 300
LM_MESH_BF16_RTOL = dict(losses=1e-4, grad_norms=5e-3)
LM_MESH_SHARE = 0.26
#: (b)'s serve: launch/serve's batch and prompt, its tokens cut from 32
#: to 8 so that phase 10 with (c) keeps within the run's time
LM_MESH_SERVE = dict(SERVE_ARGS, gen=8)
#: (c) the MoE family on LM_MESH_SHAPE, LM_MESH_WORLD ranks spawned as
#: (b)'s are. (1) the tiny deepseek-v2-236b and arctic-480b of (a) at
#: capacity factor MOE_MESH_TINY_FACTOR, at which the global batch drops
#: assignments: held as (a) is, each rank's slices against the one
#: device, the global drop counts equal and above 0. (2) deepseek-v2-236b
#: at full width, block0 + 1 MoE block (MOE_MESH_F32_PARAMS parameters,
#: the reference's count), float32 weights, compute and caches:
#: launch/serve's batch and prompt, MOE_MESH_F32_GEN tokens, against the
#: one device on the same weights: logits within SERVE_TOL, equal tokens
#: and global drops. (3) the same at bfloat16 for the timings: the train
#: steps at block0 + 1 MoE block on the arch's policy (adafactor,
#: bfloat16 states and weights) at launch/train's batch, MOE_MESH_TRAIN_M
#: microbatches in place of the policy's 16 (each gathers every weight
#: over gloo again), MOE_MESH_TRAIN_STEPS steps at MOE_MESH_TRAIN_CFG
#: (no warmup, so that the step moves the bfloat16 weights): loss and
#: grad norm within LM_MESH_BF16_RTOL, each leaf's share of elements that
#: the steps changed within MOE_MESH_CHANGED_TOL of the one device's, and
#: the loss of one more batch after the steps within LM_MESH_BF16_RTOL's
#: (an unapplied update changes no element; a stale one moves that loss);
#: then serve at block0 + 1 MoE block (MOE_MESH_BF16_LAYERS; phase 8's cut
#: of block0 + 2 until phase 11 took the whole run past 950 s) at
#: launch/serve's batch and prompt, MOE_MESH_BF16_GEN tokens: each
#: step's logits within the larger of SERVE_TF_ULPS units and the one
#: device's own bfloat16
#: error (its max |bfloat16 − float32| on the same weights and tokens:
#: at bfloat16 the mesh's rounding flips some tokens' top-k experts,
#: and a flipped token moves by an expert's output, not by units), tokens
#: equal where the one device's top-2 margin exceeds twice that. Each
#: rank's resident parameters and accumulators at most LM_MESH_SHARE of
#: the one device's, its optimizer state the bytes of its slices (a
#: factored state's vector is cut by one axis where its leaf's other dim
#: is the one the mesh cuts twice). The two serves' tokens and the train
#: steps were 3, 3 and 2 until the split epoch past 256 took the run's
#: time (a slow call ran the whole script past 1,200 s): the tiny
#: configs of (1) hold a longer decode and a second step
MOE_MESH_ARCH = "deepseek-v2-236b"
MOE_MESH_TINY = ("deepseek-v2-236b", "arctic-480b")
MOE_MESH_TINY_FACTOR = 0.5
MOE_MESH_F32_LAYERS = 2
MOE_MESH_F32_PARAMS = 5_358_679_040
MOE_MESH_F32_GEN = 2
MOE_MESH_TRAIN_LAYERS = 2
MOE_MESH_TRAIN_M = 1
MOE_MESH_TRAIN_STEPS = 1
MOE_MESH_TRAIN_CFG = dict(learning_rate=1e-3, warmup_steps=0,
                          total_steps=200)
MOE_MESH_CHANGED_TOL = 0.02
MOE_MESH_BF16_LAYERS = 2
MOE_MESH_BF16_GEN = 2
MOE_MESH_TIMEOUT_S = 600
#: ranks that build a whole full-width model at once and then cut it
#: (two float32 2-layer models, 42.9 GB, beside the others' slices fit
#: the card; four do not)
MOE_MESH_BUILDERS = 2
#: (d) the ssm, hybrid and encdec families on LM_MESH_SHAPE, LM_MESH_WORLD
#: ranks spawned as (b)'s and (c)'s are. (1) the tiny xlstm, zamba2 and
#: seamless of (a), held as (a) is, each rank's slices against the one
#: device. (2) SSM_MESH_ARCH at full width cut in depth only to
#: SSM_MESH_LAYERS (one group of 6 Mamba2 blocks, the shared attention
#: block and a tail of 1: SSM_MESH_PARAMS parameters, the reference's
#: count), against the one device on the same weights, in two passes as
#: (b)'s. Both take launch/serve's batch and prompt and SSM_MESH_GEN
#: tokens, then SSM_MESH_TRAIN_STEPS train steps on the same model at
#: launch/train's defaults, as (b)'s (``_lm_mesh_train_cfg``: batch 8 x
#: 256, AdamW as the arch's policy says at one microbatch, not its 4,
#: each of which would gather every weight over gloo again; warmup 10 of
#: 200 steps). The float32 pass (float32 compute and caches) holds the
#: state: logits within SERVE_TOL and equal tokens, losses, grad norms
#: and the next batch's loss within TRAIN_METRIC_RTOL. The bfloat16 pass
#: (the config's compute, float32 parameters) gives the timings: each
#: serve step's logits within the larger of SERVE_TF_ULPS units and the
#: one device's own bfloat16 error, tokens equal where its top-2 margin
#: exceeds twice that (the recurrent families round apart at bfloat16,
#: SERVE_TF_FLOAT32's note); losses, grad norms and the next batch's
#: loss within the larger of LM_MESH_BF16_RTOL and the one device's own
#: bfloat16 error (its bfloat16 run against its float32 pass): AdamW
#: makes each gradient whose sign the rounding flips a full step, and a
#: recurrent model's bfloat16 gradients are 9-18% (of a leaf's norm)
#: from the float32 ones on one device and on the mesh alike, so after
#: one step the next loss parted by 1.25e-4 at lr 3e-5 and 1.1e-3 at lr
#: 1e-3 from the first step (PERF.md §6). Each leaf's changed share
#: within MOE_MESH_CHANGED_TOL of the one device's in both passes;
#: parameters and accumulators at most LM_MESH_SHARE of the one
#: device's, the optimizer state its slices' bytes. (3) SSM_MESH_XLSTM
#: at full width, one group (SSM_MESH_XLSTM_LAYERS: 7 mLSTM blocks and 1
#: sLSTM block, SSM_MESH_XLSTM_PARAMS parameters), a float32 serve held
#: as (2)'s; its resident parameters exactly its slices' bytes (the
#: rules cut no FSDP dim of the mLSTM's wqkv and wif: 0.36744 of the one
#: device's)
SSM_MESH_TINY = ("xlstm-1.3b", "zamba2-7b", "seamless-m4t-medium")
SSM_MESH_ARCH = "zamba2-7b"
SSM_MESH_LAYERS = 7
SSM_MESH_PARAMS = 978_745_376
SSM_MESH_GEN = 3
SSM_MESH_TRAIN_STEPS = 2
SSM_MESH_XLSTM = "xlstm-1.3b"
SSM_MESH_XLSTM_LAYERS = 8
SSM_MESH_XLSTM_PARAMS = 760_123_448
SSM_MESH_TIMEOUT_S = 600
#: (e) sequence-sharded caches and batches (ROADMAP 10d-ii), LM_MESH_WORLD
#: ranks spawned as (b)–(d)'s are, on two meshes of the same world: (1)
#: the tiny configs of (a): each of SEQ_MESH_TINY_B1 at a batch of 1 on
#: LM_MESH_SHAPE (its prompt and its KV, latent and memory caches cut on
#: the sequence over the data axis), a dense one with one KV head there
#: too (the cache also cut on Dh over the model axis), and each of
#: SEQ_MESH_TINY_KV at launch/serve's batch on SEQ_MESH_KV_SHAPE, whose
#: model axis of 4 does not divide their 2 KV heads (the cache cut on S
#: over it, flash-decode): prefill and SEQ_MESH_TINY_GEN greedy tokens
#: at float32 caches (logits within SERVE_TOL, equal tokens and MoE
#: drops at MOE_MESH_TINY_FACTOR), and one AdamW step of the same batch
#: (loss and grad norm within TRAIN_METRIC_RTOL, every gradient leaf
#: within TRAIN_GRAD_RTOL of its largest |g|: at a batch of 1 the
#: training sequence is cut, and on SEQ_MESH_KV_SHAPE wk/wv/bk/bv are
#: whole on each model rank, their gradients summed over it). (2)
#: SEQ_MESH_ARCH at full width (16 heads over 2 KV heads, vocabulary
#: 151,936, tied) on SEQ_MESH_KV_SHAPE, SEQ_MESH_LAYERS of its 36 layers
#: (SEQ_MESH_PARAMS parameters, the reference's count; all 36, 3,085,938,688
#: parameters, until phase 4f took the run's time): launch/serve's
#: batch and prompt and SEQ_MESH_GEN tokens in a float32 pass (logits
#: within SERVE_TOL, equal tokens) and a bfloat16 pass (within the one
#: device's own bfloat16 error, as (c)); then one train step at
#: launch/train's defaults at SEQ_MESH_TRAIN_LAYERS layers
#: (SEQ_MESH_TRAIN_PARAMS; all 36 would take ~49 GB at ~16 B a
#: parameter on the one device and as much again on the ranks) in a
#: float32 pass (loss and next loss within SEQ_MESH_F32_RTOL, and
#: wk/wv's gradients within TRAIN_GRAD_RTOL of the one device's) and a
#: bfloat16 pass (as (d)'s). (3) SSM_MESH_ARCH at SSM_MESH_LAYERS and
#: SSM_MESH_XLSTM at SSM_MESH_XLSTM_LAYERS, float32, at a batch of 1 on
#: LM_MESH_SHAPE (SEQ_MESH_B1: the prompt cut 32 a data rank, caches of
#: 4,096 positions, the shared attention's cut on S over the data axis,
#: the recurrent states whole over it), SEQ_MESH_B1_GEN tokens (8 until
#: the split epoch past 256 took the run's time): logits within
#: SERVE_TOL, equal tokens. Every model's resident parameters are exactly its slices'
#: bytes
SEQ_MESH_TINY_B1 = ("qwen2.5-3b", "qwen2-vl-7b", "deepseek-v2-236b",
                    "arctic-480b", "xlstm-1.3b", "zamba2-7b",
                    "seamless-m4t-medium")
SEQ_MESH_TINY_KV = ("qwen2.5-3b", "qwen2-vl-7b", "arctic-480b", "zamba2-7b",
                    "seamless-m4t-medium")
SEQ_MESH_TINY_GEN = 4
SEQ_MESH_KV_SHAPE = (1, 4)
SEQ_MESH_ARCH = "qwen2.5-3b"
SEQ_MESH_LAYERS = 4
SEQ_MESH_PARAMS = 619_474_944
SEQ_MESH_GEN = 8
SEQ_MESH_TRAIN_LAYERS = 4
SEQ_MESH_TRAIN_PARAMS = 619_474_944
SEQ_MESH_F32_RTOL = dict(losses=1e-5, grad_norms=5e-6)
SEQ_MESH_B1 = dict(batch=1, prompt_len=64, max_len=4096)
SEQ_MESH_B1_GEN = 3
SEQ_MESH_TIMEOUT_S = 600
#: (f) model axes that do not divide MLA's or Mamba2's heads (ROADMAP
#: 10d-iii), ODD_MESH_WORLD ranks spawned as (b)–(e)'s are: (1) the tiny
#: configs of ODD_MESH_TINY on each of their meshes, first all
#: ODD_MESH_WORLD ranks as (1, 8) (deepseek's latent rank of 16 cut with
#: its 4 heads whole; zamba2's conv and out_proj cut, in_proj whole, its
#: state cut on N), then the first six as (2, 3) (deepseek's heads and
#: latent whole; at 6 heads its heads cut and the latent whole; zamba2's
#: in_proj and conv cut, out_proj and the state whole): one AdamW step
#: pair and a prefill and ODD_MESH_TINY_GEN − 1 tokens at float32
#: caches each, at _tiny_mesh_parity's limits; (2) SSM_MESH_ARCH at
#: full width and SSM_MESH_LAYERS on (2, 3), float32: (d)'s serve and
#: train steps against (d)'s float32 one-device run (logits within
#: SERVE_TOL and equal tokens; losses, grad norms and the next loss
#: within TRAIN_METRIC_RTOL_BY), each rank's resident parameters,
#: accumulators and optimizer state exactly its slices' bytes
#: (ODD_MESH_PARAMS of SSM_MESH_PARAMS a rank)
ODD_MESH_WORLD = 8
ODD_MESH_TINY = {(1, 8): (("deepseek-v2-236b", None), ("zamba2-7b", None)),
                 (2, 3): (("deepseek-v2-236b", None), ("deepseek-v2-236b", 6),
                          ("zamba2-7b", None))}
ODD_MESH_FULL = (2, 3)
ODD_MESH_TINY_GEN = 5
ODD_MESH_PARAMS = 368_148_256
ODD_MESH_TIMEOUT_S = 600


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def split_float(counts):
    """Per-kernel counts with ``epoch_fused``'s split in two rows: the
    float branch's (counted on its own by the wrapper) and the rest."""
    counts = dict(counts)
    counts["epoch_fused"] -= counts[FLOAT_EPOCH]
    return counts


def _outs(x):
    """A kernel's outputs as a tuple (one tensor or several)."""
    return x if isinstance(x, tuple) else (x,)


def cuda_ms(fn, reps, warm=1):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# requests, as IMMSchedScheduler._real_match_batch builds them
# ---------------------------------------------------------------------------

def free_engines():
    """The Cloud platform and its seeded set of ``N_FREE`` free engines."""
    from repro_torch.accel import platform
    plat = platform.CLOUD
    free = np.zeros(plat.engines, dtype=bool)
    free[np.random.default_rng(FREE_SEED).choice(plat.engines, N_FREE,
                                                 replace=False)] = True
    return plat, free


def build_requests():
    from repro_torch.accel import target_graph
    from repro_torch.core import graphs, preemptible_dag as pdag
    from repro_torch.workloads import zoo
    plat, free = free_engines()
    tgt = target_graph.free_engine_graph(plat, free)
    cap = plat.engine_tile_capacity_macs()
    reqs = []
    for i, name in enumerate(WORKLOADS):
        pd = pdag.build_preemptible_dag([(i, zoo.get_workload(name), 0)],
                                        cap, window_stages=8)
        q, order = graphs.topological_relabel(pd.graph)
        reqs.append(dict(name=name, q=q, order=order,
                         mask=graphs.compatibility_mask(q, tgt)))
    # one bucket for the burst, with room for every problem's dummy PEs
    n_pad = max(pdag.shape_bucket(r["q"].n, tgt.n)[0] for r in reqs)
    m_pad = -(-(tgt.n + n_pad - min(r["q"].n for r in reqs)) // 16) * 16
    padded = [pdag.pad_problem(r["q"].adj, tgt.adj, r["mask"], n_pad, m_pad)
              for r in reqs]
    Qb, Gb, Mb = (torch.from_numpy(np.stack(x)).cuda()
                  for x in zip(*padded))
    return reqs, tgt, (n_pad, m_pad), Qb, Gb, Mb


def feasible_np(M, Q, G):
    M = np.asarray(M, dtype=np.int64)
    return bool((M.sum(1) == 1).all() and (M.sum(0) <= 1).all()
                and ((M @ np.asarray(G, np.int64) @ M.T)
                     >= np.asarray(Q, np.int64)).all())


# ---------------------------------------------------------------------------
# bounds: bytes each input read once and each output written once over
# HBM bandwidth, against operations over the peak rate of their type
# ---------------------------------------------------------------------------

def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(byts, ops):
    t_bytes = byts / HBM_BYTES_S
    t_ops = sum(v / PEAK[k] for k, v in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_bounds(Q, G, mask, x, outs, quantized, refine_iters=6,
                  elite_k=16):
    P, n, m = mask.shape
    nnzG = float(G.sum())                       # sum over problems
    nnzQ = float(Q.sum())
    sweep_ops = 2.0 * (2 * n * m * m + 2 * n * n * m)   # 4 0/1 products
    fit_f32 = N * (n * nnzG + P * (2.0 * n * n * m + 3 * n * n))
    fit_int = fit_f32
    b = {}
    if "prune_fixpoint" in outs:
        pr_out, pr_sweeps = outs["prune_fixpoint"]
        b["prune_fixpoint"] = bound(
            nbytes(mask, Q, G, pr_out, pr_sweeps),
            {"int8": sweep_ops * float(pr_sweeps.sum())})
    if "edge_fitness" in outs:
        b["edge_fitness"] = bound(nbytes(x["S"], Q, G) + P * N * 4,
                                  {"fp32": fit_f32})
    if "edge_fitness_quantized" in outs:
        b["edge_fitness_quantized"] = bound(
            nbytes(x["S_q"], Q, G) + P * N * 4, {"int8": fit_int})
    if "epoch_fused" in outs:
        upd = 15.0 * P * N * n * m             # update, clip, normalize
        ep_ops = {"fp32": K * (upd + (0 if quantized else fit_f32))}
        if quantized:
            ep_ops["int8"] = K * (fit_int + 6.0 * P * N * n * m)
        b["epoch_fused"] = bound(
            nbytes(x["S"], x["V"], x["S"], x["f_local"], x["S_star"],
                   x["f_star"], x["S_bar"], mask, Q, G, x["r_all"],
                   *outs["epoch_fused"]), ep_ops)
        # the second bound, where the swarm's state cannot stay on chip
        b["epoch_fused_state"] = epoch_state_bound(P, N, n, m, K)
    if "epoch_finish" in outs:
        proj = 3.0 * P * N * n * (m * 8)        # 3 projections, per row
        feas = 2.0 * P * N * nnzQ / P
        b["epoch_finish"] = bound(
            nbytes(x["S"], x["f_local"], mask, Q, G, *outs["epoch_finish"]),
            {"int8": P * N * refine_iters * sweep_ops + proj + feas,
             "fp32": 2.0 * P * elite_k * n * m})
    if "pso_update" not in outs:     # the main path's five alone
        return b
    # per call of the split epoch (one problem): the mean over the burst
    S_new, V_new = outs["pso_update"][:2]
    b["pso_update"] = bound(
        nbytes(x["S"], x["V"], x["S"], x["S_star"], x["S_bar"], mask,
               x["r_all"][:, 0]) / P + nbytes(S_new, V_new),
        {"fp32": 15.0 * N * n * m})
    swept = outs["ullmann_refine_step"][0]
    b["ullmann_refine_step"] = bound(2 * nbytes(swept) + nbytes(Q, G) / P,
                                     {"int8": N * sweep_ops})
    b["greedy_project"] = bound(
        nbytes(x["S"], mask) / P + nbytes(outs["greedy_project"][0]),
        {"fp32": float(N * n * n * m)})
    b["masked_argmax"] = bound(
        nbytes(x["S_star"], mask) / P + nbytes(*outs["masked_argmax"][:2]),
        {"fp32": float(n * m)})
    return b


def pso_update_host_ms(x, Mb):
    """``pso_update``'s wrapper host time alone on problem 0's particles:
    ``time.perf_counter`` over 1,000 calls with no synchronize, after
    warm-up (the card keeps up, so the host sets the pace)."""
    from repro_torch.kernels import cases, pso_update
    args = (x["S"][0], x["V"][0], x["S"][0], x["S_star"][0], x["S_bar"][0],
            Mb[0], x["r_all"][0, 0])
    for _ in range(50):
        pso_update.pso_update_cuda(*args, **cases.HYPER)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        pso_update.pso_update_cuda(*args, **cases.HYPER)
    host_ms = time.perf_counter() - t0   # seconds / 1,000 calls = ms
    torch.cuda.synchronize()
    return host_ms


def split_phase(pso, Qb, Gb, Mb, x, counters):
    """The split epoch through the ``cuda`` suite on every problem of
    ``Mb`` (the burst, or deepseek-7b's at ``WIDE_BUCKET``), float
    and quantized, then ``masked_argmax`` through the seam on each
    returned S*: launches counted over exactly that run. Then each result
    is held against the fused epoch (``epoch_fused`` → ``epoch_finish``,
    τ = 0) on the same inputs, and both are timed per problem. The
    idle-share profile records the card's activity alone: a split epoch
    at (312, 528) makes ~20,000 launches, costly to summarise with the
    CPU's ops."""
    from repro_torch.core import split_epoch
    from repro_torch.kernels import backend, cases, ref
    from repro_torch.kernels.epoch_fused import epoch_fused_cuda
    from repro_torch.kernels.finish_fused import epoch_finish_cuda
    P, n, m = Mb.shape
    keys = ("S", "V", "S", "f_local", "S_star", "f_star", "S_bar")

    def args(p):
        return (*(x[k][p] for k in keys), Mb[p], Qb[p], Gb[p], x["r_all"][p])

    def fused(sl, cfg):
        S, S_star, f_star, f_trace, f_last = epoch_fused_cuda(
            *(x[k][sl] for k in keys), Mb[sl], Qb[sl], Gb[sl],
            x["r_all"][sl], omega=cfg.omega, c1=cfg.c1, c2=cfg.c2,
            c3=cfg.c3, v_max=cfg.v_max, quantized=cfg.quantized)
        tail = epoch_finish_cuda(
            S, f_last, None, Mb[sl], Qb[sl], Gb[sl], gumbel_tau=0.0,
            refine_threshold=cfg.refine_threshold,
            refine_iters=cfg.refine_iters, elite_k=pso.elite_k_for(cfg),
            consensus_temp=cfg.consensus_temp)
        return (S, S_star, f_star, f_trace, f_last, *tail)

    cfgs = {q: pso.PSOConfig(num_particles=N, inner_steps=K, quantized=q,
                             backend="cuda") for q in (False, True)}
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    got = {}
    for q, cfg in cfgs.items():
        bk = backend.for_config(cfg)
        for p in range(P):
            out = split_epoch.split_epoch(*args(p), cfg)
            got[q, p] = (out, bk.masked_argmax(out[1], Mb[p]))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: counters[k].count for k in SPLIT_KERNELS}
    calls = {k: counters[k].calls for k in SPLIT_KERNELS}
    log(f"split epoch at {(n, m)}: {2 * P} epochs in {wall * 1e3:.1f} ms, "
        f"launches {launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the split epoch path at "
                 f"{(n, m)}")

    names = ("S_final", "S_star", "f_star", "f_trace", "f_last", "M_hat",
             "feasible")
    s_bar_err, times = 0.0, []
    for q, cfg in cfgs.items():
        want = fused(slice(None), cfg)
        for p in range(P):
            out, (val, idx) = got[q, p]
            for k, name in enumerate(names):
                if not torch.equal(out[k], want[k][p]):
                    fail(f"split epoch at {(n, m)} (quantized={q}, problem "
                         f"{p}): {name} differs from the fused epoch")
            if not torch.equal(pso._fitness(out[0], Qb[p], Gb[p], cfg),
                               want[4][p]):
                fail(f"split epoch at {(n, m)} (quantized={q}, problem "
                     f"{p}): the recomputed fitness differs from the fused "
                     f"f_last")
            try:
                s_bar_err = max(s_bar_err, cases.compare(out[7], want[7][p]))
                cases.compare((val, idx), ref.masked_argmax(out[1], Mb[p]))
            except AssertionError as e:
                fail(f"split epoch at {(n, m)} (quantized={q}, problem "
                     f"{p}): {e}")
            split_ms = cuda_ms(lambda: split_epoch.split_epoch(*args(p), cfg),
                               reps=2)
            fused_ms = cuda_ms(lambda: fused(slice(p, p + 1), cfg), reps=5)
            times.append(dict(problem=p, quantized=q, split_ms=split_ms,
                              fused_ms=fused_ms))
            log(json.dumps(dict(split_vs_fused=p, bucket=[n, m],
                                quantized=q, split_ms=split_ms,
                                fused_ms=fused_ms)))
    log(f"split epoch == fused epoch at {(n, m)} on {P} problems, float and "
        f"quantized (S_bar max abs err {s_bar_err:.3g}); masked_argmax == "
        f"plain")
    # the card's idle share of one split and one fused epoch (problem 0)
    idle = {}
    for path, fn in (("split", lambda: split_epoch.split_epoch(
            *args(0), cfgs[True])), ("fused", lambda: fused(slice(0, 1),
                                                            cfgs[True]))):
        _, wall_ms, rows = profiled(fn, cpu=False)
        busy = sum(r[1] for r in rows)
        idle[path] = dict(wall_ms=wall_ms, device_busy_ms=busy,
                          idle_share=1.0 - busy / max(wall_ms, 1e-9),
                          device_launches=sum(r[2] for r in rows))
    log(f"split vs fused epoch at {(n, m)} under the profiler: "
        f"{json.dumps(idle)}")
    return dict(bucket=[n, m], launches=launches, calls=calls, wall_s=wall,
                s_bar_max_abs_err=s_bar_err,
                times=times, profile=idle)


def _tier_delta(stats, before):
    """Per-tier launches, checked, hits and wall ms since ``before``."""
    out = {}
    for name in ("tier0", "tier1", "tier2"):
        t, b = getattr(stats, name), getattr(before, name)
        out[name] = dict(launches=t.launches - b.launches,
                         checked=t.checked - b.checked, hits=t.hits - b.hits,
                         wall_ms=(t.wall_s - b.wall_s) * 1e3)
    return out


def tier0_phases(pso, svc, reqs, picks, tgt, sig):
    """Step 0 of the Tier-0 hand kernel (measurement only): the host
    phases of ``revalidate_batch`` on the service's own warm inputs, per
    bucket, each timed with ``time.perf_counter`` between two
    synchronizes. The phases' outputs are held against one
    ``revalidate_batch`` call on the same inputs."""
    from repro_torch.kernels import backend
    cfg = svc.cfg
    bk = backend.for_config(cfg)
    groups = {}
    for i in picks:
        req = svc._prepare(reqs[i]["q"], tgt, SEED + i, (reqs[i]["name"], sig))
        groups.setdefault(req.bucket, []).append(req)
    rows = []
    for bucket, rq in sorted(groups.items()):
        Qb, Gb, Mb = svc._upload_problems(rq)
        handles = [svc._carries._exact[svc._warm_key(r)] for r in rq]
        carry0 = svc._stack_carries(handles)
        ms = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            return out

        mask, _ = timed("prune", lambda: bk.prune_fixpoint_batch(
            Mb, Qb, Gb, cfg.prune_iters))
        S_rb, f0, _ = timed("rebase_carry",
                            lambda: pso.rebase_carry(carry0, mask))
        M_c = timed("structured_project", lambda: bk.structured_project(
            S_rb, Qb, Gb, mask).to(torch.uint8))
        f_c = timed("fitness", lambda: pso._fitness(
            M_c.float()[:, None], Qb, Gb, cfg)[:, 0])
        feas = timed("is_feasible", lambda: bk.is_feasible(M_c, Qb, Gb))
        want = timed("revalidate_batch", lambda: pso.revalidate_batch(
            Qb, Gb, Mb, cfg, carry0))
        ok = feas & (f0 > float("-inf")) & (f0 >= cfg.early_exit_fitness)
        if not (torch.equal(M_c, want["mapping"]) and torch.equal(
                ok, want["ok"]) and torch.equal(f_c, want["fitness"])):
            fail(f"Tier-0 phases at {bucket} differ from revalidate_batch")
        rows.append(dict(bucket=list(bucket), problems=len(rq), **ms))
        log(json.dumps(dict(tier0_phases_ms=rows[-1])))
    return rows


def service_phase(pso, reqs, counters, out_dir, persist_dir):
    """The matcher service at the burst's full width: the 8 requests
    submitted as the scheduler names them, bucketed by the service
    itself. Drains, in order: cold (Tier 2), warm, all-warm (the requests
    the warm drain served at Tier 0: every one must be served at Tier 0
    again for exactly one host sync), and a drift drain on a target with
    4 free engines swapped (Tier 1); then a float-config match of unet,
    cold and warm. Every served mapping is checked on the host against
    the unpadded query and target, and each of the five main-path kernels
    must have been launched through the service. Then, measurement only:
    the warm and the all-warm drain under the profiler and the Tier-0
    host phases. The service persists to ``persist_dir`` (phase 4d
    snapshots it)."""
    from repro_torch.accel import target_graph
    from repro_torch.core.service import MatcherService
    plat, free = free_engines()
    tgt = target_graph.free_engine_graph(plat, free)
    sig = target_graph.free_engine_signature(free)
    drift = free.copy()
    rng = np.random.default_rng(FREE_SEED + 1)
    drift[rng.choice(np.where(free)[0], 4, replace=False)] = False
    drift[rng.choice(np.where(~free)[0], 4, replace=False)] = True
    tgt_drift = target_graph.free_engine_graph(plat, drift)
    sig_drift = target_graph.free_engine_signature(drift)
    cfg = pso.PSOConfig(quantized=True, early_exit=True)
    svc = MatcherService(cfg, device="cuda", persist_dir=persist_dir)
    drains = {}

    def drain(label, picks, target, tsig):
        before = copy.deepcopy(svc.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in picks:
            svc.submit(reqs[i]["q"], target, key=SEED + i,
                       workload_key=(reqs[i]["name"], tsig))
        res = svc.drain()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        for i, r in zip(picks, res):
            if r.found and not feasible_np(r.mapping, reqs[i]["q"].adj,
                                           target.adj):
                fail(f"service drain {label}: {reqs[i]['name']}'s mapping "
                     f"is infeasible")
        line = dict(drain=label, wall_ms=wall,
                    tiers=_tier_delta(svc.stats, before),
                    host_syncs=svc.stats.host_syncs - before.host_syncs,
                    found=sum(r.found for r in res), requests=len(res),
                    served=[[reqs[i]["name"], r.tier, r.found, r.epochs_run]
                            for i, r in zip(picks, res)],
                    buckets=sorted({tuple(r.bucket) for r in res}))
        log(json.dumps(line))
        drains[label] = line
        return res

    for c in counters.values():
        c.reset()
    everyone = list(range(len(reqs)))
    drain("cold", everyone, tgt, sig)
    warm = drain("warm", everyone, tgt, sig)
    picks = [i for i, r in zip(everyone, warm) if r.tier == 0 and r.found]
    if not picks:
        fail("the warm drain served no request at Tier 0")
    res = drain("all_warm", picks, tgt, sig)
    if not all(r.tier == 0 and r.found for r in res):
        fail("the all-warm drain served a request off Tier 0")
    if drains["all_warm"]["host_syncs"] != 1:
        fail(f"the all-warm drain made {drains['all_warm']['host_syncs']} "
             f"host syncs, not 1")
    drain("drift", everyone, tgt_drift, sig_drift)
    # the float config (the service's default): unet, cold then warm
    fsvc = MatcherService(device="cuda")
    unet = WORKLOADS.index("unet")
    for label in ("float_cold", "float_warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fsvc.match(reqs[unet]["q"], tgt, key=SEED + unet,
                       workload_key=("unet", sig))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if r.found and not feasible_np(r.mapping, reqs[unet]["q"].adj,
                                       tgt.adj):
            fail(f"service {label}: infeasible mapping")
        drains[label] = dict(drain=label, wall_ms=wall, tier=r.tier,
                             found=r.found, epochs_run=r.epochs_run,
                             host_syncs=r.host_syncs, bucket=list(r.bucket))
        log(json.dumps(drains[label]))
    launches = split_float({k: counters[k].count
                            for k in (*MAIN_KERNELS, FLOAT_EPOCH)})
    log(f"launches through the service: {launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched through the service")

    # step 0 of the Tier-0 hand kernel, measurement only: a warm drain of
    # the 8 (Tier 0 in every bucket, then Tier 2 for the misses) and the
    # all-warm drain under the profiler, then the Tier-0 host phases on
    # the warm drain's inputs, bucket by bucket
    def warm_drain(picked):
        for i in picked:
            svc.submit(reqs[i]["q"], tgt, key=SEED + i,
                       workload_key=(reqs[i]["name"], sig))
        return svc.drain()
    profiles = {}
    for label, picked in (("warm", everyone), ("all_warm", picks)):
        prof, wall_ms, rows = profiled(lambda: warm_drain(picked))
        busy = sum(r[1] for r in rows)
        profiles[label] = dict(wall_ms=wall_ms, device_busy_ms=busy,
                               idle_share=1.0 - busy / max(wall_ms, 1e-9),
                               device_launches=sum(r[2] for r in rows),
                               top=[dict(kernel=k[:60], ms=ms, calls=c)
                                    for k, ms, c in rows[:6]])
        log(f"service {label} drain under the profiler: "
            f"{json.dumps(profiles[label])}")
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"profile_service_{label}.txt").write_text(
                prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=30))
    phases = tier0_phases(pso, svc, reqs, everyone, tgt, sig)
    return dict(drains=drains, launches=launches,
                stats=svc.stats_dict(), profiles=profiles,
                tier0_phases=phases, service=svc, all_warm=picks)


def restart_phase(pso, reqs, svc, picks, counters, persist_dir):
    """Phase 4d, warm restarts. The service of phase 4b drains its
    all-warm requests once more (the pre-restart drain) and saves a
    snapshot to ``persist_dir``; a fresh ``MatcherService`` on the same
    directory restores it and drains the same requests: every one must be
    served at Tier 0, with one host sync, with the pre-restart drain's
    mapping, feasible. ``verify_snapshot_roundtrip`` must hold. A cold
    service's first drain of the same requests is timed beside it. Then
    the scheduler: a real-mode simulation of the simple restart scenario
    (the Cloud platform at phase 4c's swarm, ``validate=True``), cold and
    then warm with a persist directory; each must finish every task and
    keep its invariants, and the warm run must restore its snapshot
    (``snapshot_restores`` 1) and its predictor
    (``restart_restored_state_sigs`` > 0). Prints one JSON line with the
    save, restore and first-drain ms and each run's post-restart drain
    walls."""
    from repro_torch.accel import platform, target_graph
    from repro_torch.core.service import MatcherService
    from repro_torch.sched import SimConfig, Simulator, get_scheduler
    from repro_torch.sched.metrics import warm_restart_stats
    from repro_torch.sched.tasks import make_restart_scenario
    plat, free = free_engines()
    tgt = target_graph.free_engine_graph(plat, free)
    sig = target_graph.free_engine_signature(free)

    def drain(service):
        for i in picks:
            service.submit(reqs[i]["q"], tgt, key=SEED + i,
                           workload_key=(reqs[i]["name"], sig))
        syncs = service.stats.host_syncs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = service.drain()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3, \
            service.stats.host_syncs - syncs

    for c in counters.values():
        c.reset()
    before, _, _ = drain(svc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = svc.save_snapshot()
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = MatcherService(svc.cfg, device="cuda", persist_dir=persist_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if fresh.restore_snapshot(step) is None:
        fail("restart: the fresh service rejected the snapshot")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    after, first_ms, syncs = drain(fresh)
    for i, a, b in zip(picks, before, after):
        if b.tier != 0 or not b.found:
            fail(f"restart: {reqs[i]['name']} was served at Tier {b.tier} "
                 f"(found={b.found}) after the restore")
        if not (a.found and (a.mapping == b.mapping).all()):
            fail(f"restart: {reqs[i]['name']}'s mapping differs from the "
                 f"pre-restart drain's")
        if not feasible_np(b.mapping, reqs[i]["q"].adj, tgt.adj):
            fail(f"restart: {reqs[i]['name']}'s mapping is infeasible")
    if syncs != 1:
        fail(f"restart: the restored service's first drain made {syncs} "
             f"host syncs, not 1")
    if not fresh.verify_snapshot_roundtrip():
        fail("restart: verify_snapshot_roundtrip failed")
    cold = MatcherService(svc.cfg, device="cuda", persist_dir=False)
    cold_res, cold_ms, cold_syncs = drain(cold)
    service = dict(
        requests=[reqs[i]["name"] for i in picks], save_ms=save_ms,
        restore_ms=restore_ms, restored_carries=fresh.stats.restored_carries,
        restored_sim_entries=fresh.stats.restored_sim_entries,
        first_drain_ms=first_ms, first_drain_host_syncs=syncs,
        cold_first_drain_ms=cold_ms, cold_first_drain_host_syncs=cold_syncs,
        cold_tiers=[r.tier for r in cold_res],
        cold_found=sum(r.found for r in cold_res), roundtrip=True)

    # the scheduler, cold then warm
    sc = make_restart_scenario("simple", rate_hz=30, phase_horizon=0.2,
                               seed=0)
    walls = []       # this run's (service, drain wall ms), in order
    orig = MatcherService.match_many

    def match_many(self, problems, **kwargs):
        t0 = time.perf_counter()
        res = orig(self, problems, **kwargs)
        walls.append((id(self), (time.perf_counter() - t0) * 1e3))
        for (q, g), r in zip(problems, res):
            if r.found and not feasible_np(r.mapping, q.adj, g.adj):
                fail("restart: the scheduler's service returned an "
                     "infeasible mapping")
        return res

    sims = {}
    with tempfile.TemporaryDirectory() as sim_dir:
        for label, pdir in (("cold", None), ("warm", sim_dir)):
            walls.clear()
            cfg = SimConfig(platform=plat, matcher_mode="real",
                            pso_cfg=pso.PSOConfig(**SCHED_SWARM),
                            window_stages=SCHED_WINDOW, validate=True,
                            persist_dir=pdir)
            MatcherService.match_many = match_many
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = Simulator(cfg, get_scheduler("immsched")).run(sc)
                wall = (time.perf_counter() - t0) * 1e3
            except AssertionError as e:
                fail(f"restart ({label}): simulator invariants failed: {e}")
            finally:
                MatcherService.match_many = orig
            if r.truncated or r.finished != r.total:
                fail(f"restart ({label}): truncated={r.truncated}, "
                     f"finished {r.finished} of {r.total}")
            st = warm_restart_stats(r)
            # the service a restart replaces serves the pre-restart drains
            first = walls[0][0] if walls else None
            sims[label] = dict(
                tasks=r.total, finished=r.finished,
                urgent_met=[r.urgent_met, r.urgent_total], run_wall_ms=wall,
                restart_count=st["restart_count"],
                snapshot_restores=st["snapshot_restores"],
                restored_carries=st["restart_restored_carries"],
                restored_state_sigs=st["restart_restored_state_sigs"],
                restored_posterior_buckets=st[
                    "restart_restored_posterior_buckets"],
                pre_restart_drain_ms=[w for s, w in walls if s == first],
                post_restart_drain_ms=[w for s, w in walls if s != first],
                post_restart_tiers={
                    f"tier{i}": r.matcher_stats[f"tier{i}_hits"]
                    for i in range(3)})
    warm = sims["warm"]
    if warm["snapshot_restores"] != 1 or warm["restored_state_sigs"] <= 0:
        fail(f"restart: the warm simulation restored "
             f"{warm['snapshot_restores']} snapshots and "
             f"{warm['restored_state_sigs']} predictor states")
    launches = split_float({k: c.count for k, c in counters.items()})
    for k in SCHED_KERNELS:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the restart phase")
    line = dict(restart=service, sims=sims,
                launches={k: launches[k] for k in (*MAIN_KERNELS,
                                                   FLOAT_EPOCH)})
    log(json.dumps(line))
    return dict(line, launches=launches)


# ---------------------------------------------------------------------------
# phase 4e: the mesh
# ---------------------------------------------------------------------------

def kernel_counters():
    """Every kernel wrapper's launch counter, by kernel row."""
    from repro_torch.kernels import (argmax_project, epoch_fused,
                                     finish_fused, prune_fixpoint,
                                     pso_fitness, pso_update,
                                     ullmann_refine)
    return {"prune_fixpoint": prune_fixpoint.launches,
            "edge_fitness": pso_fitness.launches,
            "edge_fitness_quantized": pso_fitness.launches_quantized,
            "epoch_fused": epoch_fused.launches,
            FLOAT_EPOCH: epoch_fused.launches_float,
            "epoch_finish": finish_fused.launches,
            "pso_update": pso_update.launches,
            "ullmann_refine_step": ullmann_refine.launches,
            "greedy_project": argmax_project.launches_greedy,
            "masked_argmax": argmax_project.launches_argmax}


def _host(outs):
    """A launch's outputs as numpy arrays (ints pass through)."""
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in outs.items()}


def _bitwise(got, want, keys=None):
    """Every leaf of ``got`` (bar ``host_syncs``) equals ``want``'s."""
    keys = [k for k in (keys or got) if k != "host_syncs"]
    return all(np.array_equal(got[k], want[k]) for k in keys)


def _digest(outs):
    h = hashlib.sha1()
    for k in sorted(outs):
        if k != "host_syncs":
            h.update(k.encode())
            h.update(np.ascontiguousarray(outs[k]).tobytes())
    return h.hexdigest()


def mesh_rank(rank, mesh_dir):
    """One rank of phase 4e's ``MESH_WORLD`` ranks (gloo on CUDA
    tensors, every rank on the one card). Runs the mesh path as one SPMD program with
    the other ranks, then checks on the host what it returned against
    phase 4's outputs (``phase4.npz``), and writes ``rank<r>.json``:
    checks, digests, walls, launches and the service's drains."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import pso
    from repro_torch.core.matcher import (build_distributed_match,
                                          build_distributed_match_batch,
                                          build_distributed_revalidate_batch,
                                          collect_result, shard_streams)
    from repro_torch.core.service import MatcherService
    from repro_torch.launch import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_dir = Path(mesh_dir)
    mesh_lib.init_group("gloo", init_method=f"file://{mesh_dir}/store",
                        rank=rank, world_size=MESH_WORLD, device="cuda",
                        timeout_s=MESH_GROUP_TIMEOUT_S)
    mesh = mesh_lib.make_host_mesh(MESH_WORLD, 1, backend="gloo",
                                   device="cuda")
    reqs, tgt, bucket, Qb, Gb, Mb = build_requests()
    P = Mb.shape[0]
    ph4 = np.load(mesh_dir / "phase4.npz")
    pick, pair = int(ph4["pick"]), [int(i) for i in ph4["pair"]]
    cfg = pso.PSOConfig(quantized=True, early_exit=True)
    counters = kernel_counters()
    rec = dict(rank=rank, walls_ms={}, checks={}, digests={})

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec["walls_ms"][name] = (time.perf_counter() - t0) * 1e3
        return out

    def mapping_ok(i, M):
        q = reqs[i]["q"]
        return feasible_np(M, q.adj, tgt.adj)

    for c in counters.values():
        c.reset()
    mesh_lib.collectives.reset()
    # a particle-sharded match of one burst problem: N particles a rank
    fn = build_distributed_match(bucket, mesh, cfg, ("data",))
    streams = shard_streams(SEED + pick, MESH_WORLD)
    o = _host(timed("match", lambda: fn(streams, Qb[pick], Gb[pick],
                                        Mb[pick])))
    res = collect_result(o, order=reqs[pick]["order"],
                         crop=(reqs[pick]["q"].n, tgt.n))
    rec["digests"]["match"] = _digest(o)
    # again, warm (the first call above pays each process's first use)
    again = _host(timed("match_again", lambda: fn(
        streams, Qb[pick], Gb[pick], Mb[pick])))
    rec["checks"]["match_repeats"] = _digest(again) == _digest(o)
    rec["checks"]["match_found_feasible"] = bool(
        res.found and mapping_ok(pick, res.mapping))
    rec["checks"]["match_particles"] = bool(
        res.all_feasible.shape[0]
        == cfg.epochs * cfg.num_particles * MESH_WORLD)
    rec["match"] = dict(problem=reqs[pick]["name"], found=res.found,
                        epochs_run=res.epochs_run,
                        host_syncs=int(o["host_syncs"]))
    # the problem-axis match_batch of the 8 requests (P / D a rank)
    fn = build_distributed_match_batch(bucket, mesh, cfg, ("data",), P)
    o = _host(timed("match_batch", lambda: fn(
        [SEED + b for b in range(P)], Qb, Gb, Mb)))
    rec["digests"]["match_batch"] = _digest(o)
    rec["checks"]["match_batch_bitwise_phase4"] = _bitwise(
        o, {k: ph4["mb." + k] for k in o if k != "host_syncs"})
    # the small-B regime: two problems, each particle-sharded
    pb = torch.tensor(pair, device="cuda")
    fn = build_distributed_match_batch(bucket, mesh, cfg, ("data",),
                                       len(pair))
    o = _host(timed("match_batch_small", lambda: fn(
        [SEED + b for b in pair], Qb[pb], Gb[pb], Mb[pb])))
    rec["digests"]["match_batch_small"] = _digest(o)
    small_ok = True
    for j, b in enumerate(pair):
        r = collect_result({k: (v if k == "host_syncs" else
                                v[:, j] if k in pso.PER_EPOCH else v[j])
                            for k, v in o.items()},
                           order=reqs[b]["order"],
                           crop=(reqs[b]["q"].n, tgt.n))
        small_ok &= (not r.found) or mapping_ok(b, r.mapping)
    rec["checks"]["match_batch_small_feasible"] = bool(small_ok)
    # revalidation from phase 4's carry, in both regimes
    carry = tuple(torch.from_numpy(ph4["mb." + k]).cuda()
                  for k in ("S_star", "f_star", "S_bar"))
    for B in (P, len(pair)):
        fn = build_distributed_revalidate_batch(bucket, mesh, cfg,
                                                ("data",), B)
        o = _host(timed(f"revalidate_{B}", lambda: fn(
            Qb[:B], Gb[:B], Mb[:B], tuple(c[:B] for c in carry))))
        rec["digests"][f"revalidate_{B}"] = _digest(o)
        rec["checks"][f"revalidate_{B}_bitwise_phase4"] = _bitwise(
            o, {k: ph4["rv." + k][:B] for k in o})
    # a mesh service draining the 8 requests, cold then warm
    from repro_torch.accel import target_graph
    _, free = free_engines()
    sig = target_graph.free_engine_signature(free)
    svc = MatcherService(cfg, mesh=mesh, axis_names=("data",),
                         device="cuda", persist_dir=False)
    rec["service"] = {}
    for label in ("cold", "warm"):
        before = copy.deepcopy(svc.stats)
        coll = mesh_lib.collectives.count
        for i in range(P):
            svc.submit(reqs[i]["q"], tgt, key=SEED + i,
                       workload_key=(reqs[i]["name"], sig))
        served = timed(f"service_{label}", svc.drain)
        tiers = _tier_delta(svc.stats, before)
        counts = [sum(r.tier == t for r in served) for t in range(3)]
        rec["checks"][f"service_{label}_tier_sums"] = bool(
            counts[0] == tiers["tier0"]["hits"]
            and counts[1] == tiers["tier1"]["hits"]
            and counts[2] == tiers["tier2"]["checked"]
            and sum(counts) == P)
        rec["checks"][f"service_{label}_feasible"] = all(
            (not r.found) or mapping_ok(i, r.mapping)
            for i, r in enumerate(served))
        rec["digests"][f"service_{label}"] = _digest(
            {f"{i}": np.asarray([r.tier, r.found, r.epochs_run])
             for i, r in enumerate(served)}
            | {f"{i}.M": r.mapping for i, r in enumerate(served)
               if r.found})
        rec["service"][label] = dict(
            tiers=tiers, served=[[r.tier, r.found, r.epochs_run]
                                 for r in served],
            host_syncs=svc.stats.host_syncs - before.host_syncs,
            host_bytes=(svc.stats.host_bytes_transferred
                        - before.host_bytes_transferred),
            pool_puts=svc.stats_dict()["pool_puts"],
            collectives=mesh_lib.collectives.count - coll,
            found=sum(r.found for r in served))
    # one carry path: the mesh service's carries live in its device pool
    rec["checks"]["service_carries_pooled"] = \
        svc.stats_dict()["pool_live_rows"] > 0
    rec["launches"] = {k: c.count for k, c in counters.items()}
    rec["collectives"] = mesh_lib.collectives.count
    (mesh_dir / f"rank{rank}.json").write_text(json.dumps(rec))
    torch.distributed.destroy_process_group()
    return 0


def mesh_phase(pso, reqs, tgt, bucket, Qb, Gb, Mb, phase4, counters):
    """Phase 4e, the mesh, at the burst's width (bucket (56, 144), N = 64
    a rank, T = 4, K = 12, quantized, early exit). First a world of one in
    this process over NCCL, then over gloo on CUDA tensors (``FileStore``
    rendezvous): the particle-sharded match of each burst problem must
    give the same bits on both, and phase 4's outcomes (found,
    epochs_run), every found mapping feasible. Then ``MESH_WORLD`` ranks
    spawned on the one card (gloo on CUDA tensors), each running
    ``mesh_rank``: the particle-sharded match of one found problem, the
    problem-axis ``match_batch`` of the 8 (bit for bit phase 4's), the
    small-B regime, revalidation in both regimes (bit for bit phase 4's
    Tier 0) and a mesh service's cold and warm drain (tier sums, every
    mapping feasible). Fails on any check, on a rank's non-zero exit or
    timeout, if the ranks' results differ, or if a kernel of the mesh
    path was not launched on every rank. Prints one JSON line; the D-rank
    walls are those of four processes time-sliced on one card, not a
    scale-out figure."""
    import torch.distributed as dist
    from repro_torch.core.matcher import (build_distributed_match,
                                          collect_result)
    from repro_torch.launch import mesh as mesh_lib
    cfg = pso.PSOConfig(quantized=True, early_exit=True)
    P = Mb.shape[0]
    line = dict(world_sizes=[1, 1, MESH_WORLD], backends={}, walls_ms={},
                note=f"the {MESH_WORLD}-rank walls are {MESH_WORLD} "
                     f"processes time-sliced on one card, not a scale-out "
                     f"figure")
    launches = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        # a world of one, over NCCL and over gloo on CUDA tensors
        runs = {}
        for backend in ("nccl", "gloo"):
            for c in counters.values():
                c.reset()
            mesh_lib.init_group(backend, init_method=f"file://{d}/w1{backend}",
                                rank=0, world_size=1, device="cuda",
                                timeout_s=MESH_GROUP_TIMEOUT_S)
            try:
                mesh = mesh_lib.make_host_mesh(1, 1, backend=backend,
                                               device="cuda")
                line["backends"][f"world1_{backend}"] = str(
                    dist.get_backend())
                fn = build_distributed_match(bucket, mesh, cfg, ("data",))
                # twice: the first pass pays the group's first use
                for label in ("first", "again"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runs[backend, label] = [
                        _host(fn([SEED + b], Qb[b], Gb[b], Mb[b]))
                        for b in range(P)]
                    torch.cuda.synchronize()
                    line["walls_ms"][f"world1_{backend}_match_x{P}_{label}"] \
                        = (time.perf_counter() - t0) * 1e3
            finally:
                dist.destroy_process_group()
            for k, c in counters.items():
                if k in MESH_KERNELS and c.count <= 0:
                    fail(f"phase 4e: kernel {k} was not launched in the "
                         f"world of one over {backend}")
                launches[k] += c.count
        for b in range(P):
            got = runs["nccl", "again"][b]
            if not all(_bitwise(got, runs[key][b]) for key in runs):
                fail(f"phase 4e: {reqs[b]['name']}: the world of one over "
                     f"NCCL and over gloo (each run twice) differ")
            r = collect_result(got, order=reqs[b]["order"],
                               crop=(reqs[b]["q"].n, tgt.n))
            r4 = phase4["results"][b]
            if (r.found, r.epochs_run) != (r4.found, r4.epochs_run):
                fail(f"phase 4e: {reqs[b]['name']}: the world of one found="
                     f"{r.found} in {r.epochs_run} epochs, phase 4 "
                     f"found={r4.found} in {r4.epochs_run}")
            if r.found and not feasible_np(r.mapping, reqs[b]["q"].adj,
                                           tgt.adj):
                fail(f"phase 4e: {reqs[b]['name']}: infeasible mapping")
        log(f"phase 4e: a world of one over NCCL == over gloo, bit for bit; "
            f"phase 4's outcomes on all {P} problems")
        # MESH_WORLD ranks on the one card
        found = [b for b in range(P) if phase4["results"][b].found]
        if not found:
            fail("phase 4e: phase 4 found no mapping to shard")
        missed = [b for b in range(P) if b not in found]
        pick = found[0]
        pair = [pick, missed[0] if missed else (pick + 1) % P]
        outs, rv = _host(phase4["outs"]), _host(phase4["rv"])
        np.savez(d / "phase4.npz", pick=pick, pair=np.array(pair),
                 **{f"mb.{k}": v for k, v in outs.items()},
                 **{f"rv.{k}": v for k, v in rv.items()})
        cmds = [[sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                 str(r), "--mesh-dir", str(d)] for r in range(MESH_WORLD)]
        t0 = time.perf_counter()
        try:
            mesh_lib.run_ranks(cmds, timeout_s=MESH_TIMEOUT_S,
                               cwd=str(ROOT))
        except (TimeoutError, mesh_lib.RankFailed) as e:
            fail(f"phase 4e: {e}")
        line["walls_ms"]["world4_processes"] = (time.perf_counter()
                                                - t0) * 1e3
        recs = [json.loads((d / f"rank{r}.json").read_text())
                for r in range(MESH_WORLD)]
    line["backends"]["world4"] = "cuda:gloo,cpu:gloo"
    for r, rec in enumerate(recs):
        bad = [k for k, v in rec["checks"].items() if not v]
        if bad:
            fail(f"phase 4e: rank {r} failed {bad}")
        if rec["digests"] != recs[0]["digests"]:
            fail(f"phase 4e: rank {r}'s results differ from rank 0's")
        for k in MESH_KERNELS:
            if rec["launches"][k] <= 0:
                fail(f"phase 4e: kernel {k} was not launched on rank {r}")
        for k in launches:
            launches[k] += rec["launches"][k]
    for name in recs[0]["walls_ms"]:
        line["walls_ms"][f"world4_{name}"] = max(rec["walls_ms"][name]
                                                for rec in recs)
    line["checks"] = sorted(recs[0]["checks"])
    line["match"] = recs[0]["match"]
    line["drains"] = {label: dict(
        d_, host_syncs_per_rank=[rec["service"][label]["host_syncs"]
                                 for rec in recs])
        for label, d_ in recs[0]["service"].items()}
    line["launches_per_rank"] = [
        {k: rec["launches"][k] for k in MESH_KERNELS} for rec in recs]
    line["collectives_per_rank"] = [rec["collectives"] for rec in recs]
    log(json.dumps({"mesh": line}))
    return dict(line=line, launches=split_float(launches))


@contextlib.contextmanager
def counted_fitness(calls):
    """Within the block, every call of ``ops.edge_fitness`` and
    ``ops.edge_fitness_quantized`` (the fitness outside the fused epoch:
    the Tier-0 check) adds one to ``calls[(P, N, n, m, quantized)]``."""
    from repro_torch.kernels import ops
    orig = {q: getattr(ops, FITNESS_OPS[q]) for q in FITNESS_OPS}

    def counted(q):
        def fitness(S, *a, **kw):
            calls[(*S.shape, q)] += 1
            return orig[q](S, *a, **kw)
        return fitness
    for q, name in FITNESS_OPS.items():
        setattr(ops, name, counted(q))
    try:
        yield calls
    finally:
        for q, name in FITNESS_OPS.items():
            setattr(ops, name, orig[q])


def fitness_call_list(calls):
    """``counted_fitness``'s counts as a list, each with the body that
    ``pso_fitness.path`` picks for it."""
    from repro_torch.kernels import pso_fitness
    return [dict(P=P, N=N, n=n, m=m, quantized=q, calls=c,
                 path=pso_fitness.path(P, N, n, m, q))
            for (P, N, n, m, q), c in sorted(calls.items())]


def _watched_match_many(orig, runs):
    """A ``MatcherService.match_many`` for the scheduler phases: it times
    each drain, checks every mapping the service returns as found on the
    host (an infeasible one fails the run), and appends a record of the
    drain to ``runs[-1]``."""
    def match_many(self, problems, **kwargs):
        syncs = self.stats.host_syncs
        t0 = time.perf_counter()
        res = orig(self, problems, **kwargs)
        wall = time.perf_counter() - t0
        found = 0
        for (q, g), r in zip(problems, res):
            if r.found:
                found += 1
                if not feasible_np(r.mapping, q.adj, g.adj):
                    fail(f"scheduler: the service returned an infeasible "
                         f"mapping (n={q.n}, m={g.n})")
        runs[-1].append(dict(sent=len(problems), found=found,
                             wall_ms=wall * 1e3,
                             tiers=[r.tier for r in res],
                             buckets=sorted({tuple(r.bucket) for r in res}),
                             host_syncs=self.stats.host_syncs - syncs,
                             results=res))
        return res
    return match_many


def sched_phase(pso, counters):
    """Phase 4c, the scheduler: the port's ``Simulator`` with the port's
    ``IMMSchedScheduler`` in real mode on the Cloud platform (window 8,
    N = 64, T = 4, K = 12; the scheduler makes the swarm quantized and
    the service adds early exit) over a compound-Poisson burst stream of
    efficientnet, nasnet and pnasnet, about 70% urgent. Every urgent
    arrival event is one ``MatcherService.match_many`` drain, which a
    wrapper (here, not in the package) times and checks: every mapping
    the service returns as found must be feasible. Fails if the run is
    truncated or leaves a task unfinished, if the simulator's invariants
    fail (``validate=True``: ``check_invariants`` holds among them that
    the tier decisions sum to the matcher decisions), or if a quantized
    main-path kernel was not launched by the phase. Then the same
    simulation through the ``ref`` suite on the card: the same
    ``SimResult`` (wall clocks and the suite's name aside), and in every
    drain the same tiers, found, epochs and mappings. Then the ``cuda``
    run once more under the profiler, for the card's idle share (the
    profiler's own host cost would inflate the timed run's wall). Then
    the same scenario through all six schedulers in analytic mode, which
    must launch nothing."""
    from repro_torch.accel import platform
    from repro_torch.core.service import MatcherService
    from repro_torch.sched import SimConfig, Simulator, get_scheduler
    from repro_torch.sched import metrics
    from repro_torch.sched.tasks import make_burst_scenario
    kw = dict(SCHED_SCENARIO)
    sc = make_burst_scenario(kw.pop("complexity"), **kw)
    runs = []        # per simulation, one record per drain
    orig = MatcherService.match_many
    match_many = _watched_match_many(orig, runs)

    def sim_cfg(mode, backend="cuda"):
        return SimConfig(platform=platform.CLOUD, matcher_mode=mode,
                         pso_cfg=pso.PSOConfig(**SCHED_SWARM,
                                               backend=backend),
                         window_stages=SCHED_WINDOW, validate=True)

    def simulate(backend="cuda"):
        runs.append([])
        MatcherService.match_many = match_many
        try:
            return Simulator(sim_cfg("real", backend),
                             get_scheduler("immsched")).run(sc)
        except AssertionError as e:  # check_invariants under validate=True
            fail(f"scheduler ({backend} suite): simulator invariants "
                 f"failed: {e}")
        finally:
            MatcherService.match_many = orig

    def comparable(r):
        d = dataclasses.asdict(r)
        d["matcher_stats"] = {k: v for k, v in d["matcher_stats"].items()
                              if not k.endswith("wall_s")
                              and k not in ("fe_wait_s", "epoch_backend")}
        return d

    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = split_float({k: c.count for k, c in counters.items()})
    drains = runs[0]
    ms = res.matcher_stats
    if res.truncated or res.finished != res.total:
        fail(f"scheduler: truncated={res.truncated}, finished "
             f"{res.finished} of {res.total}")
    for k in SCHED_KERNELS:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the scheduler phase")
    # the same simulation through the plain versions on the card
    t0 = time.perf_counter()
    ref_res = simulate("ref")
    ref_wall = time.perf_counter() - t0
    if comparable(res) != comparable(ref_res):
        got, want = comparable(res), comparable(ref_res)
        diff = sorted(k for k in got if got[k] != want[k])
        diff += sorted(k for k in got["matcher_stats"]
                       if got["matcher_stats"][k]
                       != want["matcher_stats"].get(k))
        fail(f"scheduler: the cuda suite's SimResult differs from the ref "
             f"suite's in {diff}")
    if [d["sent"] for d in drains] != [d["sent"] for d in runs[1]]:
        fail("scheduler: the cuda and ref suites drained different bursts")
    for i, (dc, dr) in enumerate(zip(drains, runs[1])):
        for a, b in zip(dc["results"], dr["results"]):
            if ((a.tier, a.found, a.epochs_run)
                    != (b.tier, b.found, b.epochs_run)
                    or (a.mapping is None) != (b.mapping is None)
                    or (a.mapping is not None
                        and not (a.mapping == b.mapping).all())):
                fail(f"scheduler: drain {i} differs between the cuda and "
                     f"the ref suite")
    log(f"scheduler: cuda suite == ref suite over {len(drains)} drains "
        f"(ref run {ref_wall * 1e3:.1f} ms)")
    for run in runs:
        for d in run:
            del d["results"]
    tiers = {f"tier{i}": ms[f"sched_tier{i}_decisions"] for i in range(3)}
    walls = sorted(d["wall_ms"] for d in drains)
    line = dict(
        sched=sc.name, tasks=res.total, urgent_tasks=res.urgent_total,
        urgent_met=res.urgent_met, finished=res.finished,
        deadline_met=res.deadline_met, events=res.events,
        predicted_tier_decisions=tiers,
        service_tiers={f"tier{i}": {k: ms[f"tier{i}_{k}"] for k in
                                    ("launches", "checked", "hits")}
                       for i in range(3)},
        sim_lookups=ms["sim_lookups"],
        sim_neighbor_hits=ms["sim_neighbor_hits"],
        drains=ms["drains"], host_syncs=ms["host_syncs"],
        host_syncs_per_drain=ms["host_syncs_per_drain"],
        real_matches_sent=sum(d["sent"] for d in drains),
        real_matches_found=sum(d["found"] for d in drains),
        run_wall_ms=wall * 1e3, match_many_wall_ms=sum(walls),
        match_many_ms_min_median_max=([walls[0], statistics.median(walls),
                                       walls[-1]] if walls else None),
        cost_model_s=dict(avg_sched_time=res.avg_sched_time,
                          **{k: v for k, v in res.percentiles.items()
                             if k.startswith("sched_")}),
        ref_run_wall_ms=ref_wall * 1e3,
        launches={k: launches[k] for k in (*MAIN_KERNELS, FLOAT_EPOCH)},
        per_drain=drains)
    # measurement only: the same run once more under the profiler (the
    # card's activity alone), for the card's idle share of a simulation
    _, prof_wall, rows = profiled(simulate, cpu=False)
    busy = sum(r[1] for r in rows)
    line["profile"] = dict(wall_ms=prof_wall, device_busy_ms=busy,
                           idle_share=1.0 - busy / max(prof_wall, 1e-9),
                           device_launches=sum(r[2] for r in rows),
                           top=[dict(kernel=k[:60], ms=ms, calls=c)
                                for k, ms, c in rows[:6]])
    log(json.dumps(line))
    # the same scenario, analytic, through every scheduler (host only)
    for c in counters.values():
        c.reset()
    results = {name: Simulator(sim_cfg("analytic"),
                               get_scheduler(name)).run(sc)
               for name in SCHEDULERS}
    if any(c.count for c in counters.values()):
        fail("an analytic simulation launched a kernel")
    analytic = dict(speedup_table=metrics.speedup_table(results),
                    energy_efficiency=metrics.energy_efficiency(results),
                    urgent_met={k: [r.urgent_met, r.urgent_total]
                                for k, r in results.items()})
    log(json.dumps(dict(sched_analytic=sc.name, **analytic)))
    return dict(real=line, analytic=analytic, launches=launches)


# ---------------------------------------------------------------------------
# past n, m = 256: phase 3's wide cases and phase 4f
# ---------------------------------------------------------------------------

def wide_platform():
    from repro_torch.accel import platform
    return dataclasses.replace(platform.CLOUD, **WIDE_PLATFORM)


def wide_kernel_cases(elite_k):
    """Phase 3 past 256: each of the nine kernels against its plain
    version on random problems at every shape of ``WIDE_CASES`` (the
    split epoch's four once a problem, as ``cases.kernel_pairs`` calls
    them), quantized and float, τ = 0 and τ > 0; every output bit for
    bit but ``epoch_finish``'s S̄, within ``SBAR_ATOL``. Fails unless
    every wide step kernel of both branches and both tail kernels ran at
    one of the shapes. Returns per shape the kernel's and the plain
    version's seconds a call and the instantiations it ran."""
    from repro_torch.kernels import cases, epoch_fused, finish_fused
    rec, paths = {}, set()
    for (wn, wm), (wP, wN) in WIDE_CASES.items():
        t_case = time.time()
        Q, G, mask = (t.cuda() for t in cases.random_problem(wP, wn, wm,
                                                             SEED))
        x = cases.swarm_inputs(Q, G, mask, wN, WIDE_K, seed=SEED)
        times = {}
        # the nine, then the float epoch, then the tail with Gumbel noise
        for quantized, tau, names in ((True, 0.0, (*MAIN_KERNELS,
                                                   *cases.PER_PROBLEM)),
                                      (False, 0.0, ("epoch_fused",)),
                                      (False, 0.3, ("epoch_finish",))):
            pairs = cases.kernel_pairs(Q, G, mask, x, quantized=quantized,
                                       gumbel_tau=tau,
                                       elite_k=min(elite_k, wN))
            for name in names:
                kern, plain = pairs[name]
                t0 = time.time()
                got = kern()
                torch.cuda.synchronize()
                t1 = time.time()
                want = plain()
                torch.cuda.synchronize()
                t2 = time.time()
                what = (f"{name} at {(wP, wN, wn, wm)} quantized={quantized} "
                        f"tau={tau}")
                for k, (g, w) in enumerate(zip(_outs(got), _outs(want))):
                    if name == "epoch_finish" and k == 2:
                        err = float((g - w).abs().max())
                        if not err <= SBAR_ATOL:
                            fail(f"{what}: S_bar off by {err} (limit "
                                 f"{SBAR_ATOL})")
                    elif not torch.equal(g, w):
                        fail(f"{what}: output {k} is not bit for bit its "
                             f"plain version")
                times[f"{name}/q{int(quantized)}/tau{tau}"] = [t1 - t0,
                                                               t2 - t1]
        ran = {key: instantiation(key, wP, wN, wn, wm)
               for key in ("epoch_fused", FLOAT_EPOCH, "epoch_finish")}
        paths.update((q, min(epoch_fused.path(wP, wN, wn, wm, q), 1))
                     for q in (True, False))
        paths.add(("tail", finish_fused.path(wn, wm)))
        rec[f"{wn}x{wm}"] = dict(P=wP, N=wN, K=WIDE_K, seconds=times,
                                 instantiations=ran,
                                 case_s=time.time() - t_case)
        log(f"  wide ({wn}, {wm}), P={wP} N={wN}: the nine kernels bit "
            f"for bit (S_bar within {SBAR_ATOL}) in "
            f"{rec[f'{wn}x{wm}']['case_s']:.1f} s")
        del Q, G, mask, x
        torch.cuda.empty_cache()
    want = {(q, k) for q in (True, False) for k in (-1, 0, 1)} | {
        ("tail", 1), ("tail", 2)}
    if want - paths:
        fail(f"WIDE_CASES run no case of {sorted(want - paths, key=str)} "
             f"(epoch_fused.path clipped to 1 for clusters; the tail's "
             f"finish_fused.path)")
    return rec


def wide_fitness_cases():
    """Phase 3 past 256, the two fitness bodies bit for bit against their
    plain versions: at N = 1 on the projection tile of each
    ``WIDE_CASES`` problem (the Tier-0 call: 0/255, and 0/1 for the float
    body), on a random swarm at ``FITNESS_WIDE_SWARM``, on the all-255
    tile (all-one float) with a dense G at ``FITNESS_DENSE`` and on a
    random swarm at ``FITNESS_FALLBACK``. Fails unless each wide body
    that ``pso_fitness.path`` can pick (the quantized row split at 16 and
    32 rows a CTA, the float one, and one CTA a particle in each mode)
    ran at one of them. Returns the seconds and the body of each case."""
    from repro_torch.kernels import cases, pso_fitness, ref
    rec, ran = {}, set()

    def check(what, S, Q, G, quantized):
        t0 = time.time()
        P_, N_, n_, m_ = S.shape
        name = "edge_fitness_quantized" if quantized else "edge_fitness"
        got = pso_fitness.edge_fitness_cuda(S, Q, G, quantized=quantized)
        torch.cuda.synchronize()
        want = (pso_fitness.edge_fitness_quantized_reference(S, Q, G)
                if quantized else pso_fitness.edge_fitness_reference(S, Q, G))
        if not torch.equal(got, want):
            fail(f"{name} at {(P_, N_, n_, m_)} ({what}) is not bit for bit "
                 f"its plain version")
        path = pso_fitness.path(P_, N_, n_, m_, quantized)
        ran.add((quantized, path if quantized else min(path, 1)))
        rec[f"{name} {what} {(P_, N_, n_, m_)}"] = dict(
            instantiation=pso_fitness.instantiation(P_, N_, n_, m_,
                                                    quantized),
            seconds=time.time() - t0)

    for (wn, wm), (wP, _) in WIDE_CASES.items():
        Q, G, mask = (t.cuda() for t in cases.random_problem(wP, wn, wm,
                                                             SEED))
        x = cases.swarm_inputs(Q, G, mask, 1, 1, seed=SEED)
        tile = ref.greedy_project(x["S"][:, 0], mask).float()[:, None]
        check("projection tile", ref.quantize_s(tile), Q, G, True)
        check("projection tile", tile, Q, G, False)
    for what, (P_, N_, n_, m_) in (("swarm", FITNESS_WIDE_SWARM),
                                   ("past the split", FITNESS_FALLBACK)):
        Q, G, mask = (t.cuda() for t in cases.random_problem(P_, n_, m_,
                                                             SEED))
        x = cases.swarm_inputs(Q, G, mask, N_, 1, seed=SEED)
        check(what, x["S_q"], Q, G, True)
        check(what, x["S"], Q, G, False)
        del x
    P_, N_, n_, m_ = FITNESS_DENSE
    Q = cases.random_problem(P_, n_, m_, SEED)[0].cuda()
    G = torch.ones(P_, m_, m_, dtype=torch.uint8, device="cuda")
    check("all-255 tile, dense G",
          torch.full((P_, N_, n_, m_), 255, dtype=torch.uint8,
                     device="cuda"), Q, G, True)
    check("all-one tile, dense G",
          torch.ones(P_, N_, n_, m_, device="cuda"), Q, G, False)
    want = {(True, 16), (True, 32), (True, -1), (False, 1), (False, -1)}
    if want - ran:
        fail(f"phase 3 ran no wide fitness case of {sorted(want - ran)} "
             f"((quantized, pso_fitness.path), the float row split's rows "
             f"clipped to 1)")
    log(f"  wide fitness: both bodies bit for bit at the Tier-0 tiles, "
        f"{FITNESS_WIDE_SWARM}, the dense {FITNESS_DENSE} and "
        f"{FITNESS_FALLBACK}; bodies {sorted(ran)}")
    torch.cuda.empty_cache()
    return rec


def narrow_sbar_planted(elite_k):
    """Phase 3, a reading: ``epoch_finish`` on random problems at
    ``NARROW_PLANTED`` (P, N, n, m), whose planted singleton mask rows
    hold 1.0 in every particle. Up to n, m = 256 S̄ keeps its own
    summation order (``consensus_slice``), which can round such an entry
    an ulp off the plain version's; M̂ and the feasibility flags must be
    bit for bit, S̄'s largest difference is recorded beside
    ``SBAR_ATOL`` and fails nothing."""
    from repro_torch.kernels import cases
    P_, N_, n_, m_ = NARROW_PLANTED
    Q, G, mask = (t.cuda() for t in cases.random_problem(P_, n_, m_, SEED))
    x = cases.swarm_inputs(Q, G, mask, N_, 1, seed=SEED)
    kern, plain = cases.kernel_pairs(Q, G, mask, x, quantized=True,
                                     gumbel_tau=0.0,
                                     elite_k=elite_k)["epoch_finish"]
    got, want = _outs(kern()), _outs(plain())
    for k in (0, 1):
        if not torch.equal(got[k], want[k]):
            fail(f"epoch_finish at {NARROW_PLANTED} (planted rows): output "
                 f"{k} is not bit for bit its plain version")
    err = float((got[2] - want[2]).abs().max())
    rec = dict(shape=list(NARROW_PLANTED), sbar_max_abs_err=err,
               sbar_atol=SBAR_ATOL, within=err <= SBAR_ATOL,
               entries_off=int((got[2] != want[2]).sum()))
    log(f"  epoch_finish at {NARROW_PLANTED}, planted rows of 1.0: M_hat "
        f"and feasible bit for bit; S_bar {rec['entries_off']} entries "
        f"off, max abs err {err} (reading; limit elsewhere {SBAR_ATOL})")
    return rec


def _device_by_entry(rows, quantized):
    """Profiled device ms by kernel entry: the wrappers' kernel functions
    matched by name (G's column packing counted with the fitness body
    that the drain ran), everything else under ``other``."""
    fit = "edge_fitness_quantized" if quantized else "edge_fitness"
    names = (("prune_", "prune_fixpoint"), ("fitness_u8", fit),
             ("pack_gin", fit), ("fitness_", fit),
             ("prologue_kernel", "epoch_fused"), ("step_", "epoch_fused"),
             ("prep_", "epoch_finish"), ("finish_", "epoch_finish"))
    out = {}
    for key, ms, _ in rows:
        entry = next((e for k, e in names if k in key), "other")
        out[entry] = out.get(entry, 0.0) + ms
    return out


def wide_requests(workloads=WIDE_WORKLOADS, window=WIDE_WINDOW):
    """``workloads`` mapped at ``window`` stages (by default the complex
    ones mapped whole) on ``wide_platform()`` with every engine free:
    the target graph, its signature and ``[(name, relabelled DAG)]``."""
    from repro_torch.accel import target_graph
    from repro_torch.core import graphs, preemptible_dag as pdag
    from repro_torch.workloads import zoo
    plat = wide_platform()
    free = np.ones(plat.engines, dtype=bool)
    reqs = []
    for i, name in enumerate(workloads):
        pd = pdag.build_preemptible_dag(
            [(i, zoo.get_workload(name), 0)],
            plat.engine_tile_capacity_macs(), window_stages=window)
        q, _ = graphs.topological_relabel(pd.graph)
        reqs.append((name, q))
    return (target_graph.free_engine_graph(plat, free),
            target_graph.free_engine_signature(free), reqs)


def wide_bucket_problem(tgt, reqs, bucket=WIDE_BUCKET):
    """The first of ``reqs`` in ``bucket`` (by default deepseek-7b in
    ``WIDE_BUCKET``) padded to the bucket, as (1, n, m) tensors on the
    card, and a swarm of ``N`` particles and ``K`` steps from ``SEED``:
    (name, Q, G, mask, x)."""
    from repro_torch.core import graphs, preemptible_dag as pdag
    from repro_torch.kernels import cases
    name, q = next((nm, q) for nm, q in reqs
                   if pdag.shape_bucket(q.n, tgt.n) == bucket)
    Qb, Gb, Mb = (torch.from_numpy(np.stack([a])).cuda() for a in
                  pdag.pad_problem(q.adj, tgt.adj,
                                   graphs.compatibility_mask(q, tgt),
                                   *bucket))
    return name, Qb, Gb, Mb, cases.swarm_inputs(Qb, Gb, Mb, N, K, seed=SEED)


def window_bucket_problem():
    """``WINDOW_WORKLOAD``'s window-8 problem on ``wide_platform()`` in
    ``WINDOW_BUCKET``, as ``wide_bucket_problem`` gives it."""
    tgt, _, reqs = wide_requests((WINDOW_WORKLOAD,), SCHED_WINDOW)
    return wide_bucket_problem(tgt, reqs, WINDOW_BUCKET)


def epoch_state_bound(P, N, n, m, K):
    """A second bound of ``epoch_fused`` (ms, bytes at ``HBM_BYTES_S``):
    where the swarm's S, V and S_local (3 P N n m floats) pass the card's
    50 MB of L2, they cannot stay on chip between steps (a step is a
    launch), so each step reads S, V and S_local and writes S and V of
    every particle, and reads S* and S̄ once a problem; the first bound
    counts every input read once for the whole epoch. None below the
    L2."""
    if 3 * P * N * n * m * 4 <= L2_BYTES:
        return None
    return K * (5 * P * N + 2 * P) * n * m * 4 / HBM_BYTES_S * 1e3


def instantiation(key, P, N, n, m):
    """The kernel a ``bucket_kernels`` entry runs for P problems of N
    particles at (n, m)."""
    from repro_torch.kernels import epoch_fused, finish_fused, pso_fitness
    if key in ("epoch_fused", FLOAT_EPOCH):
        return epoch_fused.instantiation(P, N, n, m, key == "epoch_fused")
    if key == "epoch_finish":
        return finish_fused.instantiation(n, m)
    if key in ("edge_fitness", "edge_fitness_quantized"):
        return pso_fitness.instantiation(P, N, n, m,
                                         key == "edge_fitness_quantized")
    return "wide" if max(n, m) > 256 else "narrow"


def bucket_kernels(Qb, Gb, Mb, x, entries, name, stage=lambda key: None):
    """Measurement on ``name``'s problem in its bucket (``WIDE_BUCKET``,
    or ``WINDOW_BUCKET``): each of
    ``entries`` (with the float epoch where ``epoch_fused`` is one)
    against its plain version (bit for bit, S̄ within ``SBAR_ATOL``), ms
    a call (CUDA events, median of 3 runs of 5), device ms of one
    profiled call (profiled again, up to 3 times, while a profile shows
    no device event), the plain version's ms, the bound, the
    instantiation it ran, ``epoch_fused``'s state bound and
    ``masked_argmax``'s library ms (``torch.argmax`` over the masked
    flat S*). Returns ``{key: record}``."""
    from repro_torch.core import pso
    from repro_torch.kernels import cases
    elite_k = pso.elite_k_for(pso.PSOConfig(**WIDE_SWARM))
    timed, outs = {}, {}
    for quantized in (True, False):
        if not quantized and "epoch_fused" not in entries:
            break
        pairs = cases.kernel_pairs(Qb, Gb, Mb, x, quantized=quantized,
                                   gumbel_tau=0.0, elite_k=elite_k)
        for entry in entries:
            key = FLOAT_EPOCH if entry == "epoch_fused" and not quantized \
                else entry
            if key in timed or (not quantized and key != FLOAT_EPOCH):
                continue
            kern, plain = pairs[entry]
            got = kern()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain()
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            for k, (g, w) in enumerate(zip(_outs(got), _outs(want))):
                ok = (float((g - w).abs().max()) <= SBAR_ATOL
                      if entry == "epoch_finish" and k == 2
                      else torch.equal(g, w))
                if not ok:
                    fail(f"{key} at {tuple(Mb.shape[1:])} ({name}): output "
                         f"{k} differs from its plain version")
            ms = statistics.median(cuda_ms(kern, reps=5, warm=1)
                                   for _ in range(3))
            for _ in range(3):
                device_ms = sum(r[1] for r in profiled(kern)[2])
                if device_ms > 0:
                    break
            timed[key] = dict(ms=ms, device_ms=device_ms or None,
                              plain_ms=plain_ms,
                              instantiation=instantiation(
                                  key, *x["S"].shape[:2], *Mb.shape[1:]))
            if entry == "masked_argmax":
                S_star, mk = x["S_star"], Mb != 0
                timed[key]["library_ms"] = statistics.median(
                    cuda_ms(lambda: [torch.argmax(torch.where(
                        mk[p], S_star[p], float("-inf")).flatten())
                        for p in range(Mb.shape[0])], reps=5, warm=1)
                    / Mb.shape[0] for _ in range(3))
            outs[key] = got
            stage(f"bucket_{key}")
    bounds = kernel_bounds(Qb, Gb, Mb, x, outs, quantized=True,
                           elite_k=elite_k)
    if FLOAT_EPOCH in outs:
        bounds[FLOAT_EPOCH] = kernel_bounds(
            Qb, Gb, Mb, x, {"epoch_fused": outs[FLOAT_EPOCH]},
            quantized=False, elite_k=elite_k)["epoch_fused"]
    for key, rec in timed.items():
        rec["bound_ms"], rec["bound_by"] = bounds[key]
        if key in ("epoch_fused", FLOAT_EPOCH):
            rec["state_bound_ms"] = bounds["epoch_fused_state"]
    return timed


def wide_phase(pso, counters):
    """Phase 4f, the main path past n, m = 256 on ``wide_platform()``:
    (a) a ``MatcherService.drain`` of the complex workloads mapped whole
    (``WIDE_WINDOW``) at ``WIDE_SWARM``, quantized, then the same burst
    again (Tier 0 over the first drain's carries), then through a float
    service, the first and the last under the profiler (the card's
    activity alone: device ms by kernel); every mapping served as found must be
    feasible on the host, the burst must fall in ``WIDE_BUCKET`` among
    its buckets, and each of the five main-path kernels (both epoch
    branches) must have been launched by the drains. Then, measurement
    only, the five at ``WIDE_BUCKET`` on the drain's own problem
    (``bucket_kernels``). (b) phase 4c's
    scenario on the platform (``IMMSchedScheduler``, real mode,
    ``validate=True``), every found mapping feasible, run to its end,
    then once more under the profiler for the idle share."""
    from repro_torch.core.service import MatcherService
    from repro_torch.kernels import epoch_fused, ops
    from repro_torch.sched import SimConfig, Simulator, get_scheduler
    from repro_torch.sched.tasks import make_burst_scenario
    plat = wide_platform()
    seconds, t_stage = {}, [time.perf_counter()]

    def stage(name):      # the seconds of each part of the phase
        now = time.perf_counter()
        seconds[name] = now - t_stage[0]
        t_stage[0] = now

    t0 = time.perf_counter()
    tgt, sig, reqs = wide_requests()
    build_ms = (time.perf_counter() - t0) * 1e3
    out = dict(platform=WIDE_PLATFORM, build_ms=build_ms, drains={},
               seconds=seconds)
    stage("build")

    def drain(label, svc):
        syncs = svc.stats.host_syncs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, (name, q) in enumerate(reqs):
            svc.submit(q, tgt, key=SEED + i, workload_key=(name, sig))
        res = svc.drain()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        served = []
        for (name, q), r in zip(reqs, res):
            feas = bool(r.found) and feasible_np(r.mapping, q.adj, tgt.adj)
            if r.found and not feas:
                fail(f"wide drain {label}: {name}'s mapping is infeasible")
            served.append(dict(name=name, n=q.n, m=tgt.n,
                               bucket=list(r.bucket), found=bool(r.found),
                               feasible=feas, tier=r.tier,
                               epochs_run=r.epochs_run))
        line = dict(wide_drain=label, wall_ms=wall,
                    host_syncs=svc.stats.host_syncs - syncs, served=served)
        out["drains"][label] = line
        return res

    for c in counters.values():
        c.reset()
    svc = MatcherService(pso.PSOConfig(**WIDE_SWARM, quantized=True),
                         device="cuda")
    fsvc = MatcherService(pso.PSOConfig(**WIDE_SWARM), device="cuda")
    # the drains' fitness calls by (P, N, n, m, quantized): the traffic
    # that the fitness bodies' row split is set for
    fit_calls = collections.Counter()
    for label, service, quantized in (("cold", svc, True),
                                      ("again", svc, True),
                                      ("float", fsvc, False)):
        before = {k: c.count for k, c in counters.items()}
        if label == "again":          # launches and wall alone
            with counted_fitness(fit_calls):
                drain(label, service)
        else:                         # and under the profiler
            with counted_fitness(fit_calls):
                _, wall_ms, rows = profiled(lambda: drain(label, service),
                                            cpu=False)
            busy = sum(r[1] for r in rows)
            out["drains"][label].update(
                idle_share=1.0 - busy / max(wall_ms, 1e-9),
                device_ms=_device_by_entry(rows, quantized))
        line = out["drains"][label]
        line["launches"] = {k: counters[k].count - before[k]
                            for k in (*MAIN_KERNELS, FLOAT_EPOCH)}
        log(json.dumps(line))
        stage(f"drain_{label}")
    launches = split_float({k: counters[k].count
                            for k in (*MAIN_KERNELS, FLOAT_EPOCH)})
    out["launches"] = launches
    out["fitness_calls"] = fitness_call_list(fit_calls)
    log(json.dumps({"wide_fitness_calls": out["fitness_calls"]}))
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched by the wide drains")
    buckets = {tuple(s["bucket"]) for d in out["drains"].values()
               for s in d["served"]}
    if WIDE_BUCKET not in buckets:
        fail(f"the wide burst's buckets {sorted(buckets)} miss "
             f"{WIDE_BUCKET}")

    # the five at WIDE_BUCKET on the drain's own problem (measurement and
    # one more check against the plain versions)
    name, Qb, Gb, Mb, x = wide_bucket_problem(tgt, reqs)
    timed = bucket_kernels(Qb, Gb, Mb, x, MAIN_KERNELS, name, stage)
    for key, rec in timed.items():
        rec["launches"] = launches[key]
    out["bucket"] = dict(bucket=list(WIDE_BUCKET), problem=name,
                         kernels=timed)
    log(json.dumps({"wide_bucket": out["bucket"]}))
    del Qb, Gb, Mb, x
    # the epoch and its tail at the window-8 bucket the same way
    name, *window = window_bucket_problem()
    out["window_bucket"] = dict(
        bucket=list(WINDOW_BUCKET), problem=name,
        kernels=bucket_kernels(*window, ("epoch_fused", "epoch_finish"),
                               name, lambda k: stage(f"window_{k}")))
    log(json.dumps({"window_bucket": out["window_bucket"]}))
    del window
    torch.cuda.empty_cache()

    # (b) the scheduler on the platform; each run also counts the epochs
    # it launched by (P, N, n, m, quantized), the traffic that the cluster
    # step's rule on P N is set for, and its fitness calls the same way
    kw = dict(SCHED_SCENARIO)
    sc = make_burst_scenario(kw.pop("complexity"), **kw)
    runs, epochs, fits = [], [], []
    orig, orig_epoch = MatcherService.match_many, ops.epoch_fused

    def counted_epoch(*a, **kw):
        epochs[-1][(*a[0].shape, bool(kw.get("quantized")))] += 1
        return orig_epoch(*a, **kw)

    def simulate():
        runs.append([])
        epochs.append(collections.Counter())
        fits.append(collections.Counter())
        MatcherService.match_many = _watched_match_many(orig, runs)
        ops.epoch_fused = counted_epoch
        try:
            with counted_fitness(fits[-1]):
                return Simulator(
                    SimConfig(platform=plat, matcher_mode="real",
                              pso_cfg=pso.PSOConfig(**SCHED_SWARM),
                              window_stages=SCHED_WINDOW, validate=True),
                    get_scheduler("immsched")).run(sc)
        except AssertionError as e:  # check_invariants under validate=True
            fail(f"wide scheduler: simulator invariants failed: {e}")
        finally:
            MatcherService.match_many = orig
            ops.epoch_fused = orig_epoch

    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    stage("sched")
    if res.truncated or res.finished != res.total:
        fail(f"wide scheduler: truncated={res.truncated}, finished "
             f"{res.finished} of {res.total}")
    sim_launches = split_float({k: c.count for k, c in counters.items()})
    for k in SCHED_KERNELS:
        if sim_launches[k] <= 0:
            fail(f"kernel {k} was not launched by the wide scheduler")
    drains = runs[0]
    _, prof_wall, rows = profiled(simulate, cpu=False)
    busy = sum(r[1] for r in rows)
    stage("sched_profiled")
    for run in runs:
        for d in run:
            del d["results"]
    sim = dict(
        sched=sc.name, tasks=res.total, finished=res.finished,
        urgent_tasks=res.urgent_total, urgent_met=res.urgent_met,
        drains=len(drains), run_wall_ms=wall,
        match_many_wall_ms=sum(d["wall_ms"] for d in drains),
        real_matches_sent=sum(d["sent"] for d in drains),
        real_matches_found=sum(d["found"] for d in drains),
        buckets=sorted({tuple(b) for d in drains for b in d["buckets"]}),
        launches={k: sim_launches[k] for k in SCHED_KERNELS},
        epoch_calls=[dict(P=P, N=N_, n=n, m=m, quantized=q, calls=c,
                          path=epoch_fused.path(P, N_, n, m, q))
                     for (P, N_, n, m, q), c in sorted(epochs[0].items())],
        fitness_calls=fitness_call_list(fits[0]),
        profile=dict(wall_ms=prof_wall, device_busy_ms=busy,
                     idle_share=1.0 - busy / max(prof_wall, 1e-9)))
    if max(b[1] for b in sim["buckets"]) <= 256:
        fail(f"wide scheduler: no bucket past m = 256 ({sim['buckets']})")
    log(json.dumps({"wide_sched": sim}))
    out["sched"] = sim
    out["sim_launches"] = sim_launches
    return out


# ---------------------------------------------------------------------------
# phase 8: the LM serve path
# ---------------------------------------------------------------------------

def _bf16_ulp(x):
    """One unit in the last place of bfloat16 at magnitude ``x``."""
    e = int(np.floor(np.log2(max(float(x), 2.0 ** -126))))
    return 2.0 ** (e - 7)


def _dropped(model):
    """Assignments the model's MoE layers dropped in its last pass."""
    from repro_torch.models.moe import MoE
    return sum(int(m.last_dropped) for m in model.modules()
               if isinstance(m, MoE))


def _teacher_forcing(model, t, seed, B=SERVE_ARGS["batch"]):
    """Prefill over t + 1 tokens against prefill over t and one decode
    step at position t (patches first for a vlm), B rows: (max |diff|,
    the tolerance, max |logit|). An encoder-decoder's frames are as long
    as the caches, so that prefill and decode see the same memory; an
    MoE must drop no assignment in any pass (its capacity follows the
    token count, so the passes could drop different ones)."""
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models.model import VLM_PATCHES
    cfg, dev = model.cfg, model.device
    full = prompt_batch(model, B, t + 1, seed)
    at = t + (VLM_PATCHES if cfg.family == "vlm" else 0)
    max_len = at + 8
    if "frames" in full:
        full["frames"] = torch.randn(
            (B, max_len, cfg.d_model),
            generator=torch.Generator().manual_seed(seed)).to(dev)
    part = dict(full, tokens=full["tokens"][:, :t])
    step = {"tokens": full["tokens"][:, t:t + 1]}
    if cfg.mrope:
        for b, S in ((full, at + 1), (part, at)):
            b["positions3"] = torch.arange(S, dtype=torch.int32,
                                           device=dev).expand(3, B, S)
        step["positions3"] = torch.full((3, B, 1), at, dtype=torch.int32,
                                        device=dev)
    lg_full, _ = model.prefill(full, max_len=max_len)
    drops = [_dropped(model)]
    _, caches = model.prefill(part, max_len=max_len)
    drops.append(_dropped(model))
    lg_step, _ = model.decode(step, caches, at)
    drops.append(_dropped(model))
    if any(drops):
        fail(f"phase 8: {cfg.name}: teacher forcing at t = {t} dropped "
             f"{drops} MoE assignments (prefill t + 1, prefill t, decode)")
    a, b = lg_full[:, 0].float(), lg_step[:, 0].float()
    top = float(a.abs().max())
    return float((a - b).abs().max()), SERVE_TF_ULPS * _bf16_ulp(top), top


@contextlib.contextmanager
def _float32_caches():
    """The models built or prefilled inside keep float32 caches (the
    shipped ``CACHE_DTYPE`` is bfloat16)."""
    from repro_torch.models import model as model_lib
    shipped = model_lib.CACHE_DTYPE
    model_lib.CACHE_DTYPE = torch.float32
    try:
        yield
    finally:
        model_lib.CACHE_DTYPE = shipped


def _teacher_forcing_float32(cfg, t):
    """A recurrent model's identity (``SERVE_TF_FLOAT32``): ``cfg`` at
    float32 compute with float32 caches, on the weights ``_serve_wide``
    drew (the same seeded generator, parameters at the same dtype)."""
    from repro_torch.models import build_model
    model = build_model(cfg.replace(compute_dtype="float32"),
                        device="cuda", generator=torch.Generator(
                            device="cuda").manual_seed(SEED))
    with _float32_caches():
        err, _, top = _teacher_forcing(model, t, SEED + 3)
    tol = SERVE_TF_FLOAT32 * top
    if not err <= tol:
        fail(f"phase 8: {cfg.name}: teacher forcing at float32 off by "
             f"{err} (tolerance {tol}, max |logit| {top})")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(teacher_forcing_float32_max_abs=err,
                teacher_forcing_float32_tol=tol)


def _close(arch, what, got, want):
    """``got`` (on the card) within ``SERVE_TOL`` of ``want`` (on the
    CPU): the max abs error, or a failed run."""
    got = got.cpu().float()
    try:
        torch.testing.assert_close(got, want.float(), **SERVE_TOL)
    except AssertionError as e:
        fail(f"phase 8: {arch} (tiny) {what} on the card differ from the "
             f"CPU's: {e}")
    return float((got - want.float()).abs().max())


def _host_syncs(fn):
    """The synchronizing CUDA calls ``fn()`` makes (torch's sync debug
    mode, warning at each): their count and the source lines that made
    them, ``file:line`` of the calling Python frame."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    at = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
          if "called a synchronizing CUDA operation" in str(w.message)]
    return dict(count=len(at), at=sorted(set(at)))


def _caches_to(caches, device):
    if isinstance(caches, dict):
        return {k: _caches_to(v, device) for k, v in caches.items()}
    return caches.to(device, copy=True)


def _tiny_family_parity(arch):
    """Phase 8 (a) for a family of ``SERVE_FAMILIES`` (MoE with MLA,
    xLSTM, the Mamba2 hybrid, the encoder-decoder): the card against the CPU on
    the same weights at ``tiny_config``, float32. Its caches are
    bfloat16, so a one-ulp float32 difference on a rounding boundary
    moves an entry by a bfloat16 unit and, since the Mamba2 and mLSTM
    states are rounded again at every step, two runs that each keep
    their own caches drift apart. So: train logits within SERVE_TOL;
    with float32 caches on both sides (``CACHE_DTYPE``, for this check
    alone) prefill and 8 greedy decode steps within SERVE_TOL, tokens
    equal; with the shipped bfloat16 caches the greedy tokens equal, and
    each decode step from a copy of the CPU's caches within SERVE_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch, serve
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import (build_model, params_from_numpy,
                                    params_to_numpy)
    cfg = tiny_config(get_config(arch))
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(SEED))
    card = params_from_numpy(build_model(cfg, device="cuda"),
                             params_to_numpy(cpu))
    batch = prompt_batch(cpu, SERVE_TINY_ARGS["batch"],
                         SERVE_TINY_ARGS["prompt_len"], SEED + 2)
    with torch.no_grad():
        errs = {"train": _close(arch, "train logits", card.train_logits(
            {k: v.cuda() for k, v in batch.items()}), cpu.train_logits(
            batch))}
    with _float32_caches():
        want = serve(cpu, seed=SEED + 1, **SERVE_TINY_ARGS)
        got = serve(card, seed=SEED + 1, **SERVE_TINY_ARGS)
    errs["float32_caches"] = max(
        _close(arch, "logits (float32 caches)", g, w)
        for g, w in zip(got["logits"], want["logits"]))
    if not torch.equal(got["tokens"].cpu(), want["tokens"]):
        fail(f"phase 8: {arch} (tiny) greedy tokens on the card differ "
             f"from the CPU's (float32 caches)")
    want = serve(cpu, seed=SEED + 1, **SERVE_TINY_ARGS)
    got = serve(card, seed=SEED + 1, **SERVE_TINY_ARGS)
    if not torch.equal(got["tokens"].cpu(), want["tokens"]):
        fail(f"phase 8: {arch} (tiny) greedy tokens on the card differ "
             f"from the CPU's")
    errs["free_running_bfloat16"] = max(
        float((g.cpu() - w).abs().max())
        for g, w in zip(got["logits"], want["logits"]))
    inputs = prompt_batch(cpu, SERVE_TINY_ARGS["batch"],
                          SERVE_TINY_ARGS["prompt_len"], SEED + 1)
    start, step_err = SERVE_TINY_ARGS["prompt_len"], 0.0
    _, caches = cpu.prefill(inputs, start + SERVE_TINY_ARGS["gen"])
    for i, tok in enumerate(want["tokens"].unbind(1)[:-1]):
        lg_g, _ = card.decode({"tokens": tok[:, None].cuda()},
                              _caches_to(caches, "cuda"), start + i)
        lg_w, caches = cpu.decode({"tokens": tok[:, None]}, caches,
                                  start + i)
        step_err = max(step_err, _close(arch, f"decode step {i} logits",
                                        lg_g, lg_w))
    errs["steps_from_the_cpu_caches"] = step_err
    log(f"  {arch} tiny: card == CPU within {SERVE_TOL} (max abs err "
        f"{errs}), tokens equal")
    return dict(arch=arch, max_abs_err=max(v for k, v in errs.items()
                                           if k != "free_running_bfloat16"),
                errors=errs, steps=SERVE_TINY_ARGS["gen"] - 1)


def _serve_wide(arch, cfg, params=None):
    """Phase 8 (b): ``cfg`` at full width with weights from a seeded
    generator on the card, served twice with launch/serve's defaults:
    finite logits, every token in the vocabulary, the teacher-forcing
    identity within ``SERVE_TF_ULPS`` units (a recurrent model's at
    float32, ``_teacher_forcing_float32``); with ``params``, the
    parameter count must equal it. Returns the model's record."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = model.num_params()
    if params is not None and n_params != params:
        fail(f"phase 8: {arch}: {n_params} parameters, the reference's "
             f"initialisers give {params}")
    pbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cold = serve(model, seed=SEED + 1, **SERVE_ARGS)
    warm = serve(model, seed=SEED + 1, **SERVE_ARGS)
    peak = torch.cuda.max_memory_allocated()
    for name, r in (("cold", cold), ("warm", warm)):
        if not all(bool(torch.isfinite(l).all()) for l in r["logits"]):
            fail(f"phase 8: {arch}: non-finite logits ({name})")
        toks = r["tokens"]
        if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            fail(f"phase 8: {arch}: a token outside the vocabulary")
    # measurement only: one more decode step (the buffer's last
    # position) under the profiler: launches and the card's idle share
    step = {"tokens": warm["tokens"][:, -1:]}
    at = warm["max_len"] - 1
    if cfg.mrope:
        step["positions3"] = torch.full(
            (3, SERVE_ARGS["batch"], 1), at, dtype=torch.int32,
            device="cuda")
    _, wall_ms, rows = profiled(
        lambda: model.decode(step, warm["caches"], at))
    busy = sum(r[1] for r in rows)
    step_profile = dict(
        wall_ms=wall_ms, device_busy_ms=busy,
        idle_share=1.0 - busy / max(wall_ms, 1e-9),
        device_launches=sum(r[2] for r in rows),
        host_syncs=_host_syncs(
            lambda: model.decode(step, warm["caches"], at)),
        top=[dict(kernel=k[:60], ms=ms, calls=c)
             for k, ms, c in rows[:5]])
    tf = SERVE_TF_MOE if cfg.moe is not None else dict(
        batch=SERVE_ARGS["batch"], t=SERVE_ARGS["prompt_len"])
    tf_t = tf["t"]
    tf_err, tf_tol, tf_top = _teacher_forcing(model, tf_t, SEED + 3,
                                              tf["batch"])
    recurrent = cfg.ssm is not None
    if not recurrent and not tf_err <= tf_tol:
        fail(f"phase 8: {arch}: teacher forcing off by {tf_err} "
             f"(tolerance {tf_tol}, max |logit| {tf_top})")
    rec = dict(
        arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
        params=n_params, param_bytes=pbytes,
        param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
        **SERVE_ARGS, init_s=init_s,
        prefill_ms=warm["prefill_ms"],
        decode_ms_per_token=warm["step_ms_median"],
        decode_ms=warm["decode_ms"], tok_s=warm["tok_s"],
        first_prefill_ms=cold["prefill_ms"],
        first_decode_step_ms=cold["first_step_ms"],
        cold_decode_ms_per_token=cold["step_ms_median"],
        cold_tok_s=cold["tok_s"], peak_memory_bytes=peak,
        bound_decode_ms=pbytes / HBM_BYTES_S * 1e3,
        bound_decode_ms_bf16=n_params * 2 / HBM_BYTES_S * 1e3,
        teacher_forcing_t=tf_t, teacher_forcing_batch=tf["batch"],
        teacher_forcing_max_abs=tf_err, teacher_forcing_tol=tf_tol,
        decode_step_profile=step_profile,
        sample=warm["tokens"][0][:8].tolist())
    log(f"  {arch} ({cfg.num_layers} layers, {n_params} params, "
        f"{pbytes} B): prefill {rec['prefill_ms']:.2f} ms (first "
        f"{rec['first_prefill_ms']:.2f}), decode "
        f"{rec['decode_ms_per_token']:.3f} ms a token "
        f"({rec['tok_s']:.1f} tok/s; first step "
        f"{rec['first_decode_step_ms']:.2f} ms), bound "
        f"{rec['bound_decode_ms']:.3f} ms; peak {peak} B; one decode step "
        f"{step_profile['device_launches']} launches, "
        f"{step_profile['host_syncs']['count']} host syncs "
        f"{step_profile['host_syncs']['at']}, idle "
        f"{step_profile['idle_share']:.3f}; teacher forcing at t = {tf_t} "
        f"{tf_err:.3g} (tolerance {tf_tol:.3g})")
    del model, cold, warm, step
    gc.collect()
    torch.cuda.empty_cache()
    if recurrent:
        rec.update(_teacher_forcing_float32(cfg, tf_t))
        log(f"  {arch}: teacher forcing at float32 "
            f"{rec['teacher_forcing_float32_max_abs']:.3g} <= "
            f"{rec['teacher_forcing_float32_tol']:.3g} (bfloat16 "
            f"{tf_err:.3g}, recorded)")
    return rec


def serve_phase():
    """Phase 8: the LM serve path (``repro_torch.launch.serve``) on the
    card. (a) the smoke tests' size, float32: the card against the CPU on
    the same weights (drawn on the CPU, carried through
    ``params_to_numpy`` / ``params_from_numpy``), train logits, prefill
    and 8 greedy decode steps within ``SERVE_TOL``, tokens equal (the
    families of ``SERVE_FAMILIES`` as ``_tiny_family_parity`` says); (b)
    qwen1.5-0.5b at its published size, (c) qwen2.5-3b and qwen2-vl-7b
    at full width, ``SERVE_WIDE_LAYERS`` layers, and (d) the models of
    ``SERVE_FAMILIES`` at full width and their depths, weights from a
    seeded generator on the card, each served twice with launch/serve's
    defaults (``_serve_wide``). Turns off cuBLAS's reduced-precision
    reduction for bfloat16 products (XLA accumulates them in float32),
    as ``launch/serve.py``'s ``main`` does."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch, serve
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import (build_model, params_from_numpy,
                                    params_to_numpy)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    out = {"parity": [], "models": []}
    for arch in SERVE_TINY:
        cfg = tiny_config(get_config(arch))
        cpu = build_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(SEED))
        card = params_from_numpy(build_model(cfg, device="cuda"),
                                 params_to_numpy(cpu))
        want = serve(cpu, seed=SEED + 1, **SERVE_TINY_ARGS)
        got = serve(card, seed=SEED + 1, **SERVE_TINY_ARGS)
        err = max(_close(arch, "logits", g, w)
                  for g, w in zip(got["logits"], want["logits"]))
        if not torch.equal(got["tokens"].cpu(), want["tokens"]):
            fail(f"phase 8: {arch} (tiny) greedy tokens on the card differ "
                 f"from the CPU's")
        batch = prompt_batch(cpu, SERVE_TINY_ARGS["batch"],
                             SERVE_TINY_ARGS["prompt_len"], SEED + 2)
        with torch.no_grad():
            err = max(err, _close(arch, "train logits", card.train_logits(
                {k: v.cuda() for k, v in batch.items()}),
                cpu.train_logits(batch)))
        out["parity"].append(dict(arch=arch, max_abs_err=err,
                                  steps=SERVE_TINY_ARGS["gen"] - 1))
        log(f"  {arch} tiny: card == CPU within {SERVE_TOL} (max abs err "
            f"{err:.3g}), tokens equal")
    for arch in SERVE_FAMILIES:
        out["parity"].append(_tiny_family_parity(arch))
    wide = [(SERVE_FULL, None, None)] + [
        (a, SERVE_WIDE_LAYERS, None) for a in SERVE_WIDE] + [
        (a, layers, params) for a, (layers, params) in
        SERVE_FAMILIES.items()]
    for arch, layers, params in wide:
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        out["models"].append(_serve_wide(arch, cfg, params))
    return out


# ---------------------------------------------------------------------------
# phase 9: the LM training path
# ---------------------------------------------------------------------------

def _train_batch(cfg, device, seed, batch, seq, patches=0, frames=0):
    """A batch of the data pipeline's tokens and labels (labels ≥ 0), on
    ``device``, with a vlm's patches and M-RoPE positions or an
    encoder-decoder's frames drawn from a host generator."""
    from repro_torch.data import DataPipeline, SyntheticLMDataset
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=seq,
                            seed=seed)
    out = {k: torch.from_numpy(v)
           for k, v in DataPipeline(ds, global_batch=batch).next().items()}
    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "vlm" and patches:
        out["patches"] = torch.randn((batch, patches, cfg.d_model),
                                     generator=gen)
        out["positions3"] = torch.arange(
            patches + seq, dtype=torch.int32).expand(3, batch, -1).clone()
    if cfg.family in ("encdec", "audio") and frames:
        out["frames"] = torch.randn((batch, frames, cfg.d_model),
                                    generator=gen)
    return {k: v.to(device) for k, v in out.items()}


def _train_tiny_parity(arch):
    """Phase 9 (a): ``arch`` at ``tiny_config``, float32, one adamw and
    one adafactor step of ``TRAIN_TINY_CFG`` (two microbatches, a fifth
    of the labels −1) on the card and on the CPU from the same weights
    (drawn on the CPU, carried by ``params_to_numpy`` /
    ``params_from_numpy``) and batch: loss, grad norm, every gradient
    leaf and every parameter after the step within the TRAIN_*
    tolerances. Returns the largest errors."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import (build_model, params_from_numpy,
                                    params_to_numpy)
    from repro_torch.optim.adamw import at
    from repro_torch.runtime.train_loop import (make_train_state,
                                                make_train_step)
    cfg = tiny_config(get_config(arch))
    weights = params_to_numpy(build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(SEED)))
    batch = _train_batch(cfg, "cpu", SEED + 4, **TRAIN_TINY_BATCH)
    batch["labels"][:, ::5] = -1
    rec = dict(arch=arch)
    for optimizer in ("adamw", "adafactor"):
        tcfg = TrainConfig(optimizer=optimizer, **TRAIN_TINY_CFG)
        runs = {}
        for device in ("cpu", "cuda"):
            model = params_from_numpy(build_model(cfg, device=device),
                                      weights)
            step = make_train_step(model, tcfg)
            _, m = step(make_train_state(model, tcfg),
                        {k: v.to(device) for k, v in batch.items()})
            runs[device] = (m, [g.cpu() for g in step.grads],
                            params_to_numpy(model), step.leaves)
        (mw, gw, pw, leaves), (mg, gg, pg, _) = runs["cpu"], runs["cuda"]
        for k in ("loss", "grad_norm", "lr"):
            a, b = float(mg[k]), float(mw[k])
            if not abs(a - b) <= TRAIN_METRIC_RTOL * abs(b):
                fail(f"phase 9: {arch} (tiny) {optimizer}: {k} on the card "
                     f"{a} against the CPU's {b}")
        grad_err = 0.0
        for leaf, a, b in zip(leaves, gg, gw):
            err = float((a - b).abs().max())
            tol = TRAIN_GRAD_RTOL * float(b.abs().max()) + 1e-6
            if not err <= tol:
                fail(f"phase 9: {arch} (tiny) {optimizer}: gradient of "
                     f"{'/'.join(leaf.path)} off by {err} (tolerance {tol})")
            grad_err = max(grad_err, err / max(float(b.abs().max()), 1e-30))
        flips = total = 0
        step_err = 0.0
        for leaf in leaves:
            d = np.abs(at(pg, leaf.path) - at(pw, leaf.path))
            if not d.max() <= 2 * tcfg.learning_rate + TRAIN_STEP_TOL:
                fail(f"phase 9: {arch} (tiny) {optimizer}: parameter "
                     f"{'/'.join(leaf.path)} off by {d.max()} after the "
                     f"step")
            flips += int((d > TRAIN_STEP_TOL).sum())
            total += d.size
            step_err = max(step_err, float(np.where(
                d > TRAIN_STEP_TOL, 0.0, d).max()))
        if flips > TRAIN_FLIP_SHARE * total:
            fail(f"phase 9: {arch} (tiny) {optimizer}: {flips} of {total} "
                 f"parameters past {TRAIN_STEP_TOL} after the step")
        rec[optimizer] = dict(
            loss=float(mg["loss"]),
            loss_abs_err=abs(float(mg["loss"]) - float(mw["loss"])),
            grad_norm_abs_err=abs(float(mg["grad_norm"])
                                  - float(mw["grad_norm"])),
            grad_max_rel_err=grad_err, param_max_abs_err=step_err,
            adam_flips=flips, params=total)
    log(f"  {arch} tiny: card == CPU, adamw and adafactor steps of 2 "
        f"microbatches ({json.dumps(rec)})")
    return rec


def _train_bound_ms(cfg, n_params, batch, seq):
    """6 · parameters · tokens, plus attention's 12 · layers · d · S² ·
    batch, at the dense bfloat16 peak."""
    flops = 6 * n_params * batch * seq + \
        12 * cfg.num_layers * cfg.d_model * seq ** 2 * batch
    return flops / PEAK_BF16 * 1e3


def _timed_steps(step, state, batches, steps):
    """``steps`` train steps over ``batches`` (cycled), each between two
    CUDA events, read after one synchronisation: (state, losses, grad
    norms, ms a step)."""
    marks, metrics = [], []
    for i in range(steps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state, m = step(state, batches[i % len(batches)])
        t1.record()
        marks.append((t0, t1))
        metrics.append(m)
    torch.cuda.synchronize()
    return (state, [float(m["loss"]) for m in metrics],
            [float(m["grad_norm"]) for m in metrics],
            [a.elapsed_time(b) for a, b in marks])


def _train_record(arch, cfg, step, state, batch, n_params, ms):
    """The train line's record of a model: step ms (median after the
    first step), the first step's ms, tokens/s, the peak memory, the
    compute bound, and one more step under the profiler (launches,
    device ms, idle share)."""
    peak = torch.cuda.max_memory_allocated()
    B, S = batch["labels"].shape
    _, wall_ms, rows = profiled(lambda: step(state, batch))
    syncs = _host_syncs(lambda: step(state, batch))
    busy = sum(r[1] for r in rows)
    med = statistics.median(ms[1:])
    return dict(
        arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
        params=n_params, param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype, remat=cfg.remat,
        optimizer=step.cfg.optimizer,
        opt_state_dtype=step.cfg.opt_state_dtype,
        microbatches=step.cfg.microbatches, batch=B, seq=S,
        step_ms=med, first_step_ms=ms[0], step_ms_all=ms,
        tokens_per_s=B * S / (med / 1e3), peak_memory_bytes=peak,
        bound_ms=_train_bound_ms(cfg, n_params, B, S),
        step_profile=dict(wall_ms=wall_ms, device_busy_ms=busy,
                          idle_share=1.0 - busy / max(wall_ms, 1e-9),
                          device_launches=sum(r[2] for r in rows),
                          host_syncs=syncs,
                          top=[dict(kernel=k[:60], ms=t, calls=c)
                               for k, t, c in rows[:5]]))


@contextlib.contextmanager
def _recorded_losses(train_mod, losses):
    """launch/train's ``make_train_step`` wrapped so that each step's
    loss is appended to ``losses`` (the launcher reads it anyway)."""
    made = train_mod.make_train_step

    def recording(model, tcfg):
        step = made(model, tcfg)

        def call(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m
        return call
    train_mod.make_train_step = recording
    try:
        yield
    finally:
        train_mod.make_train_step = made


def _train_full():
    """Phase 9 (b): ``TRAIN_FULL`` at its published size through
    ``launch.train.main`` at its defaults: 8 steps with checkpoints at 4
    and 8; ``step_000000008`` removed, the same command resumes at step 4
    and its steps 4–7 must give run 1's losses (deterministic algorithms
    for the two runs, so that the embedding's backward adds in one
    order). Then ``TRAIN_MEMO_STEPS`` steps on one repeated batch through
    ``make_train_step``: the loss must fall by more than
    ``TRAIN_MEMO_DROP``; these steps are the timed ones."""
    import io
    import shutil
    from repro_torch.configs import get_config, get_train_config
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import (make_train_state,
                                                make_train_step)
    runs = []
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--arch", TRAIN_FULL, "--checkpoint-dir", ckpt,
                *TRAIN_LAUNCH_ARGS]
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for run in range(2):
                losses, out = [], io.StringIO()
                t0 = time.time()
                with _recorded_losses(train_mod, losses), \
                        contextlib.redirect_stdout(out), \
                        warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    rc = train_mod.main(argv)
                wall = time.time() - t0
                text = out.getvalue()
                log("    " + text.strip().replace("\n", "\n    "))
                if rc != 0:
                    fail(f"phase 9: launch/train main returned {rc} "
                         f"(run {run + 1})")
                runs.append(dict(losses=losses, wall_s=wall,
                                 log=text.splitlines()))
                if run == 0:
                    shutil.rmtree(Path(ckpt) / "step_000000008")
        finally:
            torch.use_deterministic_algorithms(False)
    first, second = runs
    if f"resumed from step {TRAIN_RESUME_AT}" not in "\n".join(
            second["log"]):
        fail(f"phase 9: the second run did not resume at step "
             f"{TRAIN_RESUME_AT}")
    if len(first["losses"]) != 8 or len(second["losses"]) != 4:
        fail(f"phase 9: {len(first['losses'])} and "
             f"{len(second['losses'])} steps, expected 8 and 4")
    resume_err = max(abs(a - b) for a, b in zip(
        first["losses"][TRAIN_RESUME_AT:], second["losses"]))
    if resume_err != 0.0:
        fail(f"phase 9: the resumed steps' losses {second['losses']} differ "
             f"from run 1's {first['losses'][TRAIN_RESUME_AT:]}")
    if not all(np.isfinite(first["losses"])):
        fail("phase 9: non-finite loss in the launcher's run")
    log(f"  {TRAIN_FULL}: launch/train 8 steps {first['losses']}, resumed "
        f"at {TRAIN_RESUME_AT}: {second['losses']} (equal)")

    # TRAIN_MEMO_STEPS steps on one batch, timed, then one profiled
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_FULL)
    tcfg = dataclasses.replace(get_train_config(TRAIN_FULL),
                               **TRAIN_MEMO_CFG)
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    n_params = model.num_params()
    if n_params != TRAIN_FULL_PARAMS:
        fail(f"phase 9: {TRAIN_FULL}: {n_params} parameters, the "
             f"reference's initialisers give {TRAIN_FULL_PARAMS}")
    step = make_train_step(model, tcfg)
    batch = _train_batch(cfg, "cuda", SEED + 5, TRAIN_BATCH, TRAIN_SEQ)
    state, losses, gnorms, ms = _timed_steps(
        step, make_train_state(model, tcfg), [batch], TRAIN_MEMO_STEPS)
    if not all(np.isfinite(losses + gnorms)):
        fail(f"phase 9: {TRAIN_FULL}: non-finite loss or grad norm")
    if not losses[-1] < losses[0] - TRAIN_MEMO_DROP:
        fail(f"phase 9: {TRAIN_FULL}: the loss on a repeated batch went "
             f"{losses[0]} -> {losses[-1]} in {TRAIN_MEMO_STEPS} steps")
    rec = _train_record(TRAIN_FULL, cfg, step, state, batch, n_params, ms)
    del step, state
    rec["remat_forms"] = {"block": dict(step_ms=rec["step_ms"],
                                        peak_memory_bytes=rec[
                                            "peak_memory_bytes"])}
    for form in ("none", "full"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        other = build_model(cfg.replace(remat=form), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(SEED))
        st = make_train_step(other, tcfg)
        _, _, _, fms = _timed_steps(st, make_train_state(other, tcfg),
                                    [batch], TRAIN_REMAT_STEPS)
        rec["remat_forms"][form] = dict(
            step_ms=statistics.median(fms[1:]),
            peak_memory_bytes=torch.cuda.max_memory_allocated())
        del other, st
    rec.update(launcher=dict(losses=first["losses"],
                             resumed_losses=second["losses"],
                             resume_max_abs_diff=resume_err,
                             wall_s=[first["wall_s"], second["wall_s"]]),
               memorise=dict(**TRAIN_MEMO_CFG, losses=losses,
                             drop=losses[0] - losses[-1]))
    log(f"  {TRAIN_FULL} ({n_params} params): {TRAIN_MEMO_STEPS} steps on "
        f"one batch, loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{rec['step_ms']:.2f} ms (first {rec['first_step_ms']:.2f}), "
        f"{rec['tokens_per_s']:.0f} tok/s, bound {rec['bound_ms']:.3f} ms, "
        f"peak {rec['peak_memory_bytes']} B, one step "
        f"{rec['step_profile']['device_launches']} launches, "
        f"{rec['step_profile']['host_syncs']['count']} host syncs, idle "
        f"{rec['step_profile']['idle_share']:.3f}; remat forms "
        f"{json.dumps(rec['remat_forms'])}")
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _train_giant():
    """Phase 9 (c): ``TRAIN_GIANT`` at full width and
    ``TRAIN_GIANT_LAYERS`` layers with its production policy (adafactor,
    bfloat16 states and parameters, 16 microbatches), a global batch of
    ``TRAIN_GIANT_BATCH`` x ``TRAIN_SEQ``, ``TRAIN_GIANT_STEPS`` steps:
    finite losses and grad norms, the reference's parameter count and
    factored state shapes, bfloat16 states, float32 accumulators and no
    ``.grad`` left on any parameter."""
    from repro_torch.configs import get_config, get_train_config
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import at
    from repro_torch.runtime.train_loop import (make_train_state,
                                                make_train_step)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_GIANT).replace(num_layers=TRAIN_GIANT_LAYERS)
    tcfg = get_train_config(TRAIN_GIANT)
    if (tcfg.optimizer, tcfg.opt_state_dtype, tcfg.microbatches,
            cfg.param_dtype) != ("adafactor", "bfloat16", 16, "bfloat16"):
        fail(f"phase 9: {TRAIN_GIANT}'s policy is not the giants' "
             f"({tcfg}, {cfg.param_dtype} parameters)")
    t0 = time.time()
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = model.num_params()
    if n_params != TRAIN_GIANT_PARAMS:
        fail(f"phase 9: {TRAIN_GIANT} ({TRAIN_GIANT_LAYERS} layers): "
             f"{n_params} parameters, the reference's initialisers give "
             f"{TRAIN_GIANT_PARAMS}")
    step = make_train_step(model, tcfg)
    state = make_train_state(model, tcfg)
    for path, want in TRAIN_GIANT_FACTORS.items():
        got = at(state["opt"]["f"], path)
        if {k: tuple(v.shape) for k, v in got.items()} != want or any(
                v.dtype != torch.bfloat16 for v in got.values()):
            fail(f"phase 9: {TRAIN_GIANT}: adafactor's state of "
                 f"{'/'.join(path)} is "
                 f"{ {k: (tuple(v.shape), v.dtype) for k, v in got.items()} }"
                 f", the reference's {want} in bfloat16")
    if len(step.leaves) != len(TRAIN_GIANT_FACTORS):
        fail(f"phase 9: {TRAIN_GIANT}: {len(step.leaves)} leaves, the "
             f"reference's tree has {len(TRAIN_GIANT_FACTORS)}")
    batches = [_train_batch(cfg, "cuda", SEED + 6 + i, TRAIN_GIANT_BATCH,
                            TRAIN_SEQ) for i in range(TRAIN_GIANT_STEPS)]
    state, losses, gnorms, ms = _timed_steps(step, state, batches,
                                             TRAIN_GIANT_STEPS)
    if not all(np.isfinite(losses + gnorms)):
        fail(f"phase 9: {TRAIN_GIANT}: non-finite loss or grad norm "
             f"{losses} {gnorms}")
    if any(g.dtype != torch.float32 for g in step.grads):
        fail(f"phase 9: {TRAIN_GIANT}: a gradient accumulator is not "
             f"float32")
    if any(p.grad is not None for p in model.parameters()):
        fail(f"phase 9: {TRAIN_GIANT}: a parameter holds a .grad")
    if any(p.dtype != torch.bfloat16 for p in model.parameters()):
        fail(f"phase 9: {TRAIN_GIANT}: a parameter is not bfloat16")
    rec = _train_record(TRAIN_GIANT, cfg, step, state, batches[0], n_params,
                        ms)
    rec.update(init_s=init_s, losses=losses, grad_norms=gnorms,
               accumulators="float32",
               state_dtype=str(at(state["opt"]["f"], ("embed",))["vr"].dtype))
    log(f"  {TRAIN_GIANT} ({TRAIN_GIANT_LAYERS} layers, {n_params} params, "
        f"bfloat16, adafactor, 16 microbatches): losses {losses}, grad "
        f"norms {gnorms}; step {rec['step_ms']:.1f} ms (first "
        f"{rec['first_step_ms']:.1f}), {rec['tokens_per_s']:.0f} tok/s, "
        f"bound {rec['bound_ms']:.2f} ms, peak {rec['peak_memory_bytes']} "
        f"B, idle {rec['step_profile']['idle_share']:.3f}")
    del model, step, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _train_compress():
    """Phase 9 (d): ``compressed_psum_tree`` in a world of one over NCCL
    on CUDA tensors (int8 on the wire), against the same call over a
    gloo group of the same world on CPU tensors: mean and error bit for
    bit."""
    import torch.distributed as dist
    from repro_torch.optim import compressed_psum_tree, init_compression
    gen = torch.Generator().manual_seed(SEED + 7)
    tree = {"w": torch.randn((64, 256), generator=gen),
            "b": [torch.randn(300, generator=gen) * 1e-3]}
    wire = []
    all_reduce = dist.all_reduce

    def recording(t, *a, **k):
        wire.append((str(t.dtype), t.device.type))
        return all_reduce(t, *a, **k)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1)
        try:
            gloo = dist.new_group(backend="gloo")
            dist.all_reduce = recording
            try:
                out = {}
                for name, group, dev in (("nccl", None, "cuda"),
                                         ("gloo", gloo, "cpu")):
                    g = {"w": tree["w"].to(dev), "b": [tree["b"][0].to(dev)]}
                    comp = init_compression(g)
                    for _ in range(3):      # error feedback carries over
                        mean, comp = compressed_psum_tree(g, comp, group, 1)
                    out[name] = (mean, comp)
            finally:
                dist.all_reduce = all_reduce
        finally:
            dist.destroy_process_group()
    (mn, cn), (mg, cg) = out["nccl"], out["gloo"]
    same = (torch.equal(mn["w"].cpu(), mg["w"])
            and torch.equal(mn["b"][0].cpu(), mg["b"][0])
            and torch.equal(cn["w"].error.cpu(), cg["w"].error)
            and torch.equal(cn["b"][0].error.cpu(), cg["b"][0].error))
    if not same:
        fail("phase 9: compressed_psum_tree over NCCL differs from gloo's")
    if ("torch.int8", "cuda") not in wire:
        fail(f"phase 9: no int8 all_reduce on the card ({wire})")
    err = float((mn["w"].cpu() - tree["w"]).abs().max())
    log(f"  compressed_psum_tree over NCCL (world of one): int8 on the "
        f"wire, == gloo's bit for bit; |mean - g| <= {err:.3g}")
    return dict(wire=sorted(set(wire)), bitwise_gloo=True,
                max_abs_err_vs_g=err)


def train_phase():
    """Phase 9: the LM training path on the card, (a)–(d) as their
    functions say. cuBLAS's reduced-precision bfloat16 reduction stays
    off (phase 8 turned it off), TF32 too."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    t0 = time.time()
    out = {"parity": [_train_tiny_parity(a) for a in TRAIN_TINY]}
    out["models"] = [_train_full(), _train_giant()]
    out["compress"] = _train_compress()
    out["phase_s"] = time.time() - t0
    return out


# ---------------------------------------------------------------------------
# phase 10: the sharded LM path
# ---------------------------------------------------------------------------

def _lm_mesh_train_cfg(arch):
    """launch/train's training config at its defaults (200 steps, one
    microbatch, the arch's policy)."""
    from repro_torch.configs import get_train_config
    return dataclasses.replace(get_train_config(arch), microbatches=1,
                               total_steps=200, warmup_steps=10)


def _lm_mesh_batches(cfg):
    """launch/train's first ``LM_MESH_STEPS`` + 1 global batches (its data
    pipeline at batch 8 x 256, seed ``SEED``), on the host."""
    from repro_torch.data import DataPipeline, SyntheticLMDataset
    pipe = DataPipeline(SyntheticLMDataset(vocab_size=cfg.vocab_size,
                                           seq_len=TRAIN_SEQ, seed=SEED),
                        global_batch=TRAIN_BATCH)
    return [{k: torch.from_numpy(v) for k, v in pipe.next().items()}
            for _ in range(LM_MESH_STEPS + 1)]


def _weights_digest(model):
    """A float64 sum of every parameter: equal weights give equal sums.
    Summed in pieces of 2^26 elements: a float64 copy of a full-width
    expert leaf would take 10 GB."""
    with torch.no_grad():
        return float(sum(c.sum(dtype=torch.float64)
                         for p in model.parameters()
                         for c in p.reshape(-1).split(1 << 26)))


def _same_grads(both, grads, mine, where):
    """Adafactor on the mesh and on one device fed the same gradients
    (the one device's ``grads``, each rank its slice), two updates at
    ``TRAIN_TINY_CFG``'s learning rate from fresh models: every
    parameter within ``TRAIN_STEP_TOL``. This holds the sharded update
    where a leaf's step depends on its gradient's rounding noise
    (``TRAIN_ZERO_GRAD``). Returns the largest difference."""
    from repro_torch.models.model import ref_leaves
    from repro_torch.optim import get_optimizer
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import shard
    opt = get_optimizer(TrainConfig(optimizer="adafactor"))
    one, sh = both()
    l1, l2 = ref_leaves(one), ref_leaves(sh)
    g2 = [torch.from_numpy(mine(g, leaf.spec)).to(g.device)
          for leaf, g in zip(l2, grads)]
    lr = torch.full((), TRAIN_TINY_CFG["learning_rate"],
                    device=grads[0].device)
    s1, s2 = opt.init(l1), opt.init(l2)
    for _ in range(2):
        s1 = opt.update([g.clone() for g in grads], s1, l1, lr)
        s2 = opt.update([g.clone() for g in g2], s2, l2, lr)
    pw = dict(_flat(tmodel.params_to_numpy(one)))
    worst = 0.0
    for path, a in _flat(shard.gather_params(sh)):
        worst = max(worst, float(np.abs(a - pw[path]).max()))
    if not worst <= TRAIN_STEP_TOL:
        fail(f"phase 10: {where}: adafactor fed the same gradients moves "
             f"the mesh's parameters {worst} from one device's")
    return worst


def _tiny_mesh_parity(arch, mesh, capacity_factor=None, heads=None,
                      optimizers=("adamw", "adafactor"),
                      gen=SERVE_TINY_ARGS["gen"]):
    """Phase 10 (a), and (c), (d) and (f)'s tiny configs on each rank of
    their mesh, for one tiny config: two steps (the first at lr 0) of
    each of ``optimizers``, then prefill and ``gen`` − 1 greedy decode
    steps with float32 caches, the mesh's path on this rank's rows
    against the one-device path on the whole batch, both on the card,
    same weights and batch; each rank holds its slice of the one
    device's gradients, logits (its vocabulary columns where the model
    axis cuts the head) and tokens (``_mesh_slice``), and the whole
    parameters (gathered). An MoE's global drop counts equal the one
    device's after every pass (``capacity_factor`` overrides the
    config's, ``heads`` its query and KV heads)."""
    from repro_torch.checkpoint.manager import _mesh_slice
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import serve_loop as sl
    from repro_torch.runtime import shard
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import train_loop as tl
    dev = "cuda"
    cfg = tiny_config(get_config(arch))
    if capacity_factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    if heads is not None:
        cfg = cfg.replace(num_heads=heads, kv_heads=heads)
    weights = tmodel.params_to_numpy(tmodel.build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(SEED)))
    where = (f"{arch} (tiny{'' if heads is None else f', {heads} heads'}) "
             f"on {tuple(shd.mesh_shape(mesh).values())}")

    def mine(t, spec):
        return _mesh_slice(t.detach().float().cpu().numpy(), mesh, spec)

    def both():
        one = tmodel.params_from_numpy(tmodel.build_model(cfg, device=dev),
                                       weights)
        sh = tmodel.params_from_numpy(shard.shard_model(tmodel.build_model(
            cfg, device=dev), mesh), weights)
        return one, sh
    drops = []

    def same_drops(one, sh, what):
        pair = [_dropped(one), _dropped(sh)]
        if pair[0] != pair[1]:
            fail(f"phase 10: {where} {what}: {pair[1]} assignments dropped "
                 f"on the mesh, {pair[0]} on one device")
        drops.append(pair[0])
    batch = _train_batch(cfg, dev, SEED + 4, **TRAIN_TINY_BATCH)
    batch["labels"][:, ::5] = -1
    rec = dict(arch=arch, heads=cfg.num_heads)
    mesh_lib.collectives.reset()
    for optimizer in optimizers:
        tcfg = TrainConfig(optimizer=optimizer, **TRAIN_TINY_CFG)
        one, sh = both()
        s1, s2 = tl.make_train_state(one, tcfg), tl.make_train_state(sh,
                                                                     tcfg)
        step1 = tl.make_train_step(one, tcfg)
        step2 = tl.make_train_step(sh, tcfg, mesh)
        local = shard.shard_batch(batch, mesh)
        metric_err = 0.0
        for _ in range(2):
            s1, m1 = step1(s1, batch)
            s2, m2 = step2(s2, local)
            same_drops(one, sh, f"{optimizer} step")
            for k in ("loss", "grad_norm"):
                a, b = float(m2[k]), float(m1[k])
                if not abs(a - b) <= TRAIN_METRIC_RTOL * abs(b):
                    fail(f"phase 10: {where} {optimizer}: {k} on the mesh "
                         f"{a}, one device {b}")
                metric_err = max(metric_err, abs(a - b) / abs(b))
        grad_err = 0.0
        noisy = set()
        for leaf, g1, g2 in zip(step2.leaves, step1.grads, step2.grads):
            err = float(np.abs(mine(g1, leaf.spec)
                               - g2.cpu().numpy()).max())
            tol = TRAIN_GRAD_RTOL * float(g1.abs().max()) + 1e-6
            if not err <= tol:
                fail(f"phase 10: {where} {optimizer}: gradient of "
                     f"{'/'.join(leaf.path)} off by {err} (tolerance {tol})")
            grad_err = max(grad_err, err / max(float(g1.abs().max()), 1e-30))
            if optimizer == "adafactor" and g1.dim() >= 2:
                floor = TRAIN_ZERO_GRAD * float(g1.abs().max())
                a = g1.abs()
                mask = ((a.amax(-2, keepdim=True) <= floor)
                        | (a.amax(-1, keepdim=True) <= floor)) & (a > 0)
                if bool(mask.any()):
                    sel = mine(mask, leaf.spec) > 0
                    if sel.any() and not np.abs(
                            g2.cpu().numpy()[sel]).max() <= floor:
                        fail(f"phase 10: {where}: {'/'.join(leaf.path)}'s "
                             f"gradient is noise on one device only")
                    noisy.add(leaf.path)
        pw = dict(_flat(tmodel.params_to_numpy(one)))
        flips = total = excused = 0
        step_err = 0.0
        for path, a in _flat(shard.gather_params(sh)):
            if path in noisy:
                excused += a.size
                continue
            d = np.abs(a - pw[path])
            if not d.max() <= 2 * tcfg.learning_rate + TRAIN_STEP_TOL:
                fail(f"phase 10: {where} {optimizer}: parameter "
                     f"{'/'.join(path)} off by {d.max()}")
            flips += int((d > TRAIN_STEP_TOL).sum())
            total += d.size
            step_err = max(step_err, float(np.where(d > TRAIN_STEP_TOL, 0.0,
                                                    d).max()))
        if flips > TRAIN_FLIP_SHARE * total:
            fail(f"phase 10: {where} {optimizer}: {flips} of {total} "
                 f"parameters past {TRAIN_STEP_TOL}")
        rec[optimizer] = dict(metric_rel_err=metric_err,
                              grad_max_rel_err=grad_err,
                              param_max_abs_err=step_err, adam_flips=flips,
                              noise_leaf_elements=excused)
        if optimizer == "adafactor":
            rec[optimizer]["same_grads_param_max_abs_err"] = _same_grads(
                both, step1.grads, mine, where)
    saved = tmodel.CACHE_DTYPE
    tmodel.CACHE_DTYPE = torch.float32
    try:
        one, sh = both()
        B, P, G = SERVE_TINY_ARGS["batch"], SERVE_TINY_ARGS["prompt_len"], gen
        lspec = shd.logits_spec(mesh)[:2] + (
            None if sh.vocab_axes() is None else "model",)
        prompt = prompt_batch(one, B, P, SEED + 1)
        start = P + (tmodel.VLM_PATCHES if cfg.family == "vlm" else 0)
        l1, c1 = sl.make_prefill_step(one, max_len=start + G)(prompt)
        l2, c2 = sl.make_prefill_step(sh, mesh, max_len=start + G)(
            shard.shard_batch(prompt, mesh))
        same_drops(one, sh, "prefill")
        t1, t2 = sl.greedy_token(one, l1), sl.greedy_token(sh, l2)
        dec1, dec2 = sl.make_decode_step(one), sl.make_decode_step(sh, mesh)
        errs, same = [], True

        def score(l1, l2, t1, t2):
            nonlocal same
            errs.append(float(np.abs(mine(l1, lspec)
                                     - l2.float().cpu().numpy()).max()))
            same &= bool(np.array_equal(mine(t1, lspec[:1]),
                                        t2.cpu().numpy()))
        score(l1, l2, t1, t2)
        for i in range(G - 1):
            inp1, inp2 = {"tokens": t1[:, None]}, {"tokens": t2[:, None]}
            if cfg.mrope:
                for inp in (inp1, inp2):
                    inp["positions3"] = torch.full(
                        (3, inp["tokens"].shape[0], 1), start + i,
                        dtype=torch.int32, device=dev)
            t1, l1, c1 = dec1(inp1, c1, start + i)
            t2, l2, c2 = dec2(inp2, c2, start + i)
            same_drops(one, sh, f"decode step {i}")
            score(l1, l2, t1, t2)
    finally:
        tmodel.CACHE_DTYPE = saved
    if not same or not max(errs) <= SERVE_TOL["atol"]:
        fail(f"phase 10: {where} decode: tokens equal {same}, logits off "
             f"by {max(errs)}")
    rec["serve_logits_max_abs_err"] = max(errs)
    rec["collectives"] = mesh_lib.collectives.count
    if cfg.moe is not None:
        rec["drops"] = drops
    return rec


def _flat(tree, prefix=()):
    """``(path, leaf)`` of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _lm_mesh_world1():
    """Phase 10 (a): ``LM_MESH_TINY`` on a (1, 1) mesh over NCCL in this
    process (``_tiny_mesh_parity``)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    with tempfile.TemporaryDirectory() as d:
        mesh_lib.init_group("nccl", init_method=f"file://{d}/store", rank=0,
                            world_size=1, device="cuda",
                            timeout_s=LM_MESH_GROUP_TIMEOUT_S)
        try:
            mesh = mesh_lib.make_host_mesh(1, 1, backend="nccl",
                                           device="cuda")
            out = [_tiny_mesh_parity(a, mesh) for a in LM_MESH_TINY]
        finally:
            dist.destroy_process_group()
    for rec in out:
        log(f"  {rec['arch']} (tiny) on a (1, 1) mesh over NCCL == one "
            f"device: {json.dumps(rec)}")
    return out


def _leaf_file(d, path):
    """Where ``_save_leaves`` keeps the leaf at ``path``."""
    return d / (".".join(path) + ".npy")


def _save_leaves(tree, d):
    """Each leaf of a nested dict of arrays as float32 ``.npy`` under
    ``d``, one file a leaf, so that a rank reads only what it cuts."""
    d.mkdir(parents=True, exist_ok=True)
    for path, v in _flat(tree):
        np.save(_leaf_file(d, path), np.asarray(v, dtype=np.float32))


def _slices_of(d, leaves, mesh):
    """``{path: this rank's slice}`` of each leaf saved under ``d``
    (``_mesh_slice`` by the leaf's spec)."""
    from repro_torch.checkpoint.manager import _mesh_slice
    return {l.path: _mesh_slice(np.load(_leaf_file(d, l.path)), mesh,
                                l.spec) for l in leaves}


def _param_errs(got, want):
    """(largest |Δ| within TRAIN_STEP_TOL, elements past it, elements,
    largest |Δ|) of two lists of arrays."""
    within = worst = 0.0
    past = total = 0
    for a, b in zip(got, want):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        past += int((d > TRAIN_STEP_TOL).sum())
        total += d.size
        worst = max(worst, float(d.max()))
        within = max(within, float(np.where(d > TRAIN_STEP_TOL, 0.0,
                                            d).max()))
    return dict(within=within, past=past, total=total, worst=worst)


def _counted(fn):
    """``fn()`` timed on the host clock between two synchronizes, with
    the collectives and the bytes gathered, all-reduced and gathered of
    the latent caches that it made: (out, (ms, collectives, gathered,
    reduced, cache_gathered))."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import mesh_ctx
    mesh_lib.collectives.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    tr = mesh_ctx.traffic
    return out, ((time.perf_counter() - t0) * 1e3,
                 mesh_lib.collectives.count, tr.gathered, tr.reduced,
                 tr.cache_gathered)


def _mesh_serve(model, mesh, want_logits, tokens, G,
                batch=SERVE_ARGS["batch"],
                prompt_len=SERVE_ARGS["prompt_len"], max_len=None):
    """Prefill of launch/serve's prompt (``batch`` x ``prompt_len``,
    this rank's slice: its rows, or at a batch the data axis does not
    divide, its part of the sequence; caches of ``max_len``, P + G by
    default) and G − 1 greedy decode steps fed the one device's
    ``tokens`` (B, G), on a model laid out on ``mesh``: each step's (max
    |Δ| logits, max (|Δ| − rtol |want|)) against this rank's slice of
    ``want_logits`` (G, B, V), its tokens and the MoE's global drops,
    the prefill's and the decode steps' ms, collectives and bytes
    moved, and this rank's rows."""
    from repro_torch.checkpoint.manager import _mesh_slice
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.runtime import serve_loop as sl
    from repro_torch.runtime import shard
    from repro_torch.runtime import sharding as shd
    B, P = batch, prompt_len
    prompt = shard.shard_batch(prompt_batch(model, B, P, SEED + 1), mesh)
    # the logits' rows are cut as the batch's are, or whole on every
    # rank; their vocabulary where the model axis cuts the head
    lspec = (prompt.specs["tokens"][0], None,
             None if model.vocab_axes() is None else "model")
    rows = _mesh_slice(np.arange(B), mesh, lspec[:1])
    (logits, caches), prefill = _counted(
        lambda: sl.make_prefill_step(model, mesh, max_len=max_len or P + G)(
            prompt))
    out = dict(prefill_ms=prefill[0], err=[], excess=[], tokens=[],
               drops=[], ms=[], collectives=[], gathered=[], reduced=[],
               cache_gathered=[], rows=rows.tolist(), prefill_collectives=(
                   prefill[1]), prefill_gathered=prefill[2],
               prefill_reduced=prefill[3])

    def score(i, logits):
        got = logits[:, -1].float().cpu().numpy()
        want = _mesh_slice(want_logits[i], mesh, lspec[::2])
        diff = np.abs(got - want)
        out["err"].append(float(diff.max()))
        out["excess"].append(float((diff - SERVE_TOL["rtol"]
                                    * np.abs(want)).max()))
        out["tokens"].append(sl.greedy_token(model, logits).cpu().tolist())
        out["drops"].append(_dropped(model))
    score(0, logits)
    step_tok = {"tokens": torch.zeros((B, 1), dtype=torch.int32)}
    decode = sl.jit_decode_step(model, mesh, caches,
                                shd.infer_batch_specs(step_tok, mesh))
    for i in range(G - 1):
        inp = {"tokens": torch.from_numpy(
            tokens[rows, i][:, None]).to(model.device)}
        (_, logits, caches), c = _counted(
            lambda: decode(inp, caches, P + i))
        for k, v in zip(("ms", "collectives", "gathered", "reduced",
                         "cache_gathered"), c):
            out[k].append(v)
        score(i + 1, logits)
    return out


def lm_mesh_rank(rank, mesh_dir):
    """One rank of phase 10 (b): ``LM_MESH_ARCH`` (``LM_MESH_LAYERS``
    deep) on the
    ``LM_MESH_SHAPE`` mesh (gloo on CUDA tensors, every rank on the one
    card), built from the seed and cut to this rank's slice, in two
    passes. The bfloat16 pass (launch/train's and launch/serve's
    defaults): the train steps, then prefill and decode fed the one-device
    run's tokens, timed and counted. The float32 pass (float32 compute
    and caches): the train steps, the first step's gradients and the
    parameters after the steps held against the one device's slices, the
    gathered state saved (first rank) and one more step, then the one
    device's bfloat16-trained weights loaded and prefill and decode fed
    its tokens. Writes ``rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint.manager import CheckpointManager, _mesh_slice
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import build_model
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import shard
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import train_loop as tl
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dev = "cuda"
    torch.cuda.set_device(0)
    d = Path(mesh_dir)
    mesh_lib.init_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=LM_MESH_WORLD, device=dev,
                        timeout_s=LM_MESH_GROUP_TIMEOUT_S)
    mesh = mesh_lib.make_host_mesh(*LM_MESH_SHAPE, backend="gloo",
                                   device=dev)
    cfg = get_config(LM_MESH_ARCH).replace(num_layers=LM_MESH_LAYERS)
    tcfg = _lm_mesh_train_cfg(LM_MESH_ARCH)
    batches = [shard.shard_batch({k: v.to(dev) for k, v in b.items()}, mesh)
               for b in _lm_mesh_batches(cfg)]
    ref = np.load(d / "serve.npz")
    G = LM_MESH_SERVE["gen"]
    rows = _mesh_slice(np.arange(SERVE_ARGS["batch"]), mesh,
                       shd.logits_spec(mesh)[:1])

    def build(c):
        model = build_model(c, device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        digest = _weights_digest(model)
        shard.shard_model(model, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        return model, digest

    def train(model, rec, after_step=None):
        state = tl.make_train_state(model, tcfg)
        step = tl.make_train_step(model, tcfg, mesh)
        for i in range(LM_MESH_STEPS):
            (state, m), (ms, n, g, r, _) = _counted(
                lambda: step(state, batches[i]))
            for k, v in (("losses", float(m["loss"])),
                         ("grad_norms", float(m["grad_norm"])),
                         ("lrs", float(m["lr"])), ("step_ms", ms),
                         ("collectives_per_step", n),
                         ("bytes_gathered_per_step", g),
                         ("bytes_reduced_per_step", r)):
                rec.setdefault(k, []).append(v)
            if after_step is not None:
                after_step(i, step)
        return state, step

    def decode_run(model, logits_key):
        return _mesh_serve(model, mesh, ref[logits_key], ref["tokens"], G)

    # the bfloat16 pass
    model, digest = build(cfg)
    rec = dict(rank=rank, rows=rows.tolist(), digest=digest)
    torch.cuda.reset_peak_memory_stats()
    state, step = train(model, rec)
    rec["resident_bytes"] = dict(
        params=shard.resident_bytes(model),
        opt=shard.resident_bytes(state["opt"]),
        grads=shard.resident_bytes(step.grads))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    rec["serve"] = decode_run(model, "logits")
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # the float32 pass
    gmax = json.loads((d / "f32.json").read_text())["grad_max"]
    model, digest = build(cfg.replace(compute_dtype="float32"))
    f32 = dict(digest=digest)

    def check_grads(i, step):
        if i:
            return
        want = _slices_of(d / "g0", step.leaves, mesh)
        worst, bad = 0.0, []
        for leaf, g in zip(step.leaves, step.grads):
            err = float(np.abs(g.cpu().numpy() - want[leaf.path]).max())
            tol = TRAIN_GRAD_RTOL * gmax["/".join(leaf.path)] + 1e-6
            worst = max(worst, err / tol)
            if not err <= tol:
                bad.append(f"{'/'.join(leaf.path)} off by {err} ({tol})")
        f32.update(grad_err_share_of_tol=worst, grad_bad=bad)
    state, step = train(model, f32, check_grads)
    want = _slices_of(d / "w", step.leaves, mesh)
    f32["params"] = _param_errs(
        [l.value().detach().float().cpu().numpy() for l in step.leaves],
        [want[l.path] for l in step.leaves])
    del want
    t0 = time.perf_counter()
    tree = shard.gather_state(state, shard.abstract_state(
        model.cfg, tcfg))
    if mesh_lib.mesh_writer(mesh):
        CheckpointManager(str(d / "ckpt"), async_save=False).save(
            LM_MESH_STEPS, tree, extras={"step": LM_MESH_STEPS})
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    mesh_lib.barrier()
    f32["gather_save_ms"] = (time.perf_counter() - t0) * 1e3
    state, m = step(state, batches[LM_MESH_STEPS])
    f32["next_loss"] = float(m["loss"])
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    tmodel.params_from_numpy(model, tmodel.nest(_slices_of(
        d / "w_bf16", model.layout.leaves, mesh).items()))
    saved = tmodel.CACHE_DTYPE
    tmodel.CACHE_DTYPE = torch.float32
    try:
        f32["serve"] = decode_run(model, "logits32")
    finally:
        tmodel.CACHE_DTYPE = saved
    rec["f32"] = f32
    (d / f"rank{rank}.json").write_text(json.dumps(rec))
    mesh_lib.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def _lm_mesh_one_device(d):
    """Phase 10 (b)'s one-device bfloat16 run on the card, the same
    weights (``SEED``), batches and prompt as the ranks': the train
    steps, the resident bytes, and launch/serve's ``serve`` (tokens and
    every step's logits); the weights after the steps saved under
    ``d/w_bf16``. Returns its record and the serve arrays."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import shard
    from repro_torch.runtime import train_loop as tl
    cfg = get_config(LM_MESH_ARCH).replace(num_layers=LM_MESH_LAYERS)
    tcfg = _lm_mesh_train_cfg(LM_MESH_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    rec = dict(digest=_weights_digest(model), losses=[], grad_norms=[],
               step_ms=[])
    state = tl.make_train_state(model, tcfg)
    step = tl.make_train_step(model, tcfg)
    batches = [{k: v.cuda() for k, v in b.items()}
               for b in _lm_mesh_batches(cfg)]
    for i in range(LM_MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        rec["losses"].append(float(m["loss"]))
        rec["grad_norms"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
    rec["resident_bytes"] = dict(
        params=shard.resident_bytes(model),
        opt=shard.resident_bytes(state["opt"]),
        grads=shard.resident_bytes(step.grads))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    r = serve(model, seed=SEED + 1, **LM_MESH_SERVE)
    logits = torch.stack([l[:, -1].float() for l in r["logits"]]
                         ).cpu().numpy()                    # (G, B, V)
    rec.update(decode_ms_per_token=r["step_ms_median"],
               prefill_ms=r["prefill_ms"],
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    arrays = dict(tokens=r["tokens"].cpu().numpy(), logits=logits)
    weights = tmodel.params_to_numpy(model)
    _save_leaves(weights, d / "w_bf16")
    del model, r
    gc.collect()
    torch.cuda.empty_cache()
    arrays["logits32"], rec["bf16_noise"] = _lm_mesh_float32_serve(
        cfg, weights, arrays)
    arrays["tokens32"] = arrays["logits32"].argmax(-1).T     # (B, G)
    rec["float32_token_mismatches"] = int(
        (arrays["tokens32"] != arrays["tokens"]).sum())
    return rec, arrays


def _lm_mesh_float32_serve(cfg, weights, arrays):
    """The one-device run's weights (``weights``, after its train steps)
    at float32 compute with float32 caches, fed its tokens: every step's
    last logits (G, B, V), and the bfloat16 run's noise at each step (the
    largest |difference| of its logits from these)."""
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import build_model
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import serve_loop as sl
    B, P, G = (LM_MESH_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    model = tmodel.params_from_numpy(build_model(
        cfg.replace(compute_dtype="float32"), device="cuda"), weights)
    saved = tmodel.CACHE_DTYPE
    tmodel.CACHE_DTYPE = torch.float32
    try:
        logits, caches = sl.make_prefill_step(model, max_len=P + G)(
            prompt_batch(model, B, P, SEED + 1))
        out = [logits[:, -1].float().cpu().numpy()]
        decode = sl.make_decode_step(model)
        for i in range(G - 1):
            tok = torch.from_numpy(arrays["tokens"][:, i][:, None]).cuda()
            _, logits, caches = decode({"tokens": tok}, caches, P + i)
            out.append(logits[:, -1].float().cpu().numpy())
    finally:
        tmodel.CACHE_DTYPE = saved
    out = np.stack(out)
    noise = [float(np.abs(a - b).max()) for a, b in zip(out,
                                                        arrays["logits"])]
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    return out, noise


def _lm_mesh_one_device_f32(d):
    """Phase 10 (b)'s float32 pass on one device: the same weights and
    batches at float32 compute: the train steps' losses, grad norms and
    learning rates, the first step's gradients (``d/g0``, and each leaf's
    largest |g|) and the parameters after the steps (``d/w``) saved, then
    one more step's loss."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import train_loop as tl
    cfg = get_config(LM_MESH_ARCH).replace(
        num_layers=LM_MESH_LAYERS, compute_dtype="float32")
    tcfg = _lm_mesh_train_cfg(LM_MESH_ARCH)
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    rec = dict(digest=_weights_digest(model), losses=[], grad_norms=[],
               lrs=[])
    state = tl.make_train_state(model, tcfg)
    step = tl.make_train_step(model, tcfg)
    batches = [{k: v.cuda() for k, v in b.items()}
               for b in _lm_mesh_batches(cfg)]
    for i in range(LM_MESH_STEPS):
        state, m = step(state, batches[i])
        for k, v in (("losses", m["loss"]), ("grad_norms", m["grad_norm"]),
                     ("lrs", m["lr"])):
            rec[k].append(float(v))
        if i == 0:
            grads = tmodel.nest((l.path, g.cpu().numpy())
                                for l, g in zip(step.leaves, step.grads))
            _save_leaves(grads, d / "g0")
            rec["grad_max"] = {"/".join(p): float(np.abs(v).max())
                               for p, v in _flat(grads)}
            del grads
    _save_leaves(tmodel.params_to_numpy(model), d / "w")
    state, m = step(state, batches[LM_MESH_STEPS])
    rec["next_loss"] = float(m["loss"])
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _lm_mesh_resume(d, one32, ranks_next_loss):
    """The ranks' float32 checkpoint (the gathered state after the train
    steps) restored on one device: its parameters against the one
    device's after the same steps, and the next step's loss against the
    one device's and the ranks' (TRAIN_METRIC_RTOL); ``ok`` when every
    one holds."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import train_loop as tl
    cfg = get_config(LM_MESH_ARCH).replace(
        num_layers=LM_MESH_LAYERS, compute_dtype="float32")
    tcfg = _lm_mesh_train_cfg(LM_MESH_ARCH)
    model = build_model(cfg, device="cuda")
    state = tl.make_train_state(model, tcfg)
    t0 = time.perf_counter()
    tree, extras = CheckpointManager(str(d / "ckpt")).restore(
        tl.train_state_tree(state))
    state = tl.load_train_state(state, tree)
    restore_ms = (time.perf_counter() - t0) * 1e3
    leaves = tmodel.ref_leaves(model)
    params = _param_errs(
        [l.value().detach().float().cpu().numpy() for l in leaves],
        [np.load(_leaf_file(d / "w", l.path)) for l in leaves])
    batch = {k: v.cuda() for k, v in _lm_mesh_batches(cfg)[-1].items()}
    state, m = tl.make_train_step(model, tcfg)(state, batch)
    loss = float(m["loss"])
    ok = (int(extras["step"]) == LM_MESH_STEPS
          and int(state["step"]) == LM_MESH_STEPS + 1
          and _params_ok(params, one32["lrs"])
          and abs(loss - one32["next_loss"])
          <= TRAIN_METRIC_RTOL * abs(one32["next_loss"])
          and abs(loss - ranks_next_loss)
          <= TRAIN_METRIC_RTOL * abs(ranks_next_loss))
    del model, state, tree
    gc.collect()
    torch.cuda.empty_cache()
    return dict(restore_ms=restore_ms, resumed_step=int(extras["step"]),
                params=params, resumed_loss=loss,
                one_device_next_loss=one32["next_loss"],
                ranks_next_loss=ranks_next_loss, ok=ok)


def _params_ok(errs, lrs):
    """Phase 9's rule after several steps: every element within
    TRAIN_STEP_TOL, or (Adam's sign flips) within twice the steps' summed
    learning rates on at most TRAIN_FLIP_SHARE of them."""
    return (errs["within"] <= TRAIN_STEP_TOL
            and errs["past"] <= TRAIN_FLIP_SHARE * errs["total"]
            and errs["worst"] <= 2 * sum(lrs) + TRAIN_STEP_TOL)


def lm_mesh_phase():
    """Phase 10, as the module's docstring says: (a) in this process,
    then (b)'s one-device runs here and ``LM_MESH_WORLD`` ranks spawned
    on the one card (``lm_mesh_rank``), held against them. Fails on any
    check, a rank's non-zero exit or timeout. One ``lm_mesh`` JSON
    line."""
    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.time()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    line = dict(card=card_line(), world1=_lm_mesh_world1(),
                arch=LM_MESH_ARCH, mesh=list(LM_MESH_SHAPE),
                steps=LM_MESH_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                serve=dict(LM_MESH_SERVE),
                note=f"the {LM_MESH_WORLD}-rank walls are {LM_MESH_WORLD} "
                     f"processes time-sliced on one card over gloo, not a "
                     f"scale-out figure")
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        one, arrays = _lm_mesh_one_device(d)
        one32 = _lm_mesh_one_device_f32(d)
        line["one_device"], line["one_device_f32"] = one, {
            k: v for k, v in one32.items() if k != "grad_max"}
        np.savez(d / "serve.npz", **arrays)
        (d / "f32.json").write_text(json.dumps(one32))
        cmds = [[sys.executable, str(ROOT / "chip_smoke.py"),
                 "--lm-mesh-rank", str(r), "--mesh-dir", str(d)]
                for r in range(LM_MESH_WORLD)]
        t0 = time.perf_counter()
        try:
            mesh_lib.run_ranks(cmds, timeout_s=LM_MESH_TIMEOUT_S,
                               cwd=str(ROOT))
        except (TimeoutError, mesh_lib.RankFailed) as e:
            fail(f"phase 10: {e}")
        line["ranks_wall_ms"] = (time.perf_counter() - t0) * 1e3
        recs = [json.loads((d / f"rank{r}.json").read_text())
                for r in range(LM_MESH_WORLD)]
        line["resume"] = _lm_mesh_resume(d, one32,
                                         recs[0]["f32"]["next_loss"])
    logits, tokens = arrays["logits"], arrays["tokens"]
    top2 = np.sort(logits, axis=-1)[..., -2:]               # (G, B, 2)
    margin = top2[..., 1] - top2[..., 0]
    tols = [SERVE_TF_ULPS * _bf16_ulp(np.abs(l).max()) for l in logits]
    bad = [] if line["resume"]["ok"] else [
        f"the (2, 2) float32 checkpoint resumed on one device: "
        f"{line['resume']}"]
    mism = set()
    for r, rec in enumerate(recs):
        f32 = rec["f32"]
        for what, got, want in (("bfloat16", rec, one),
                                ("float32", f32, one32)):
            if abs(got["digest"] - want["digest"]) > 1e-9 * abs(
                    want["digest"]):
                bad.append(f"rank {r} built other {what} weights "
                           f"({got['digest']} against {want['digest']})")
        for k in ("losses", "grad_norms"):
            for what, got, want, rtol in (
                    ("bfloat16", rec[k], one[k], LM_MESH_BF16_RTOL[k]),
                    ("float32", f32[k], one32[k], TRAIN_METRIC_RTOL)):
                if not all(abs(a - b) <= rtol * abs(b)
                           for a, b in zip(got, want)):
                    bad.append(f"rank {r} {what}: {k} {got} on the mesh, "
                               f"{want} on one device")
        if f32["grad_bad"]:
            bad.append(f"rank {r} float32 gradients: {f32['grad_bad'][:3]}")
        if not _params_ok(f32["params"], one32["lrs"]):
            bad.append(f"rank {r} float32 parameters after "
                       f"{LM_MESH_STEPS} steps: {f32['params']}")
        for k, v in rec["resident_bytes"].items():
            if not v <= LM_MESH_SHARE * one["resident_bytes"][k]:
                bad.append(f"rank {r} holds {v} B of {k}, the one device "
                           f"{one['resident_bytes'][k]}")
        sv, sv32 = rec["serve"], f32["serve"]
        for i, (err, tol) in enumerate(zip(sv["err"], tols)):
            if not err <= tol:
                bad.append(f"rank {r}: bfloat16 step {i}'s logits off by "
                           f"{err} (tolerance {tol})")
            if not sv32["excess"][i] <= SERVE_TOL["atol"]:
                bad.append(f"rank {r}: float32 step {i}'s logits off by "
                           f"{sv32['err'][i]}")
            for j, row in enumerate(rec["rows"]):
                want = int(tokens[row, i])
                if sv["tokens"][i][j] != want:
                    mism.add((row, i))
                if sv["tokens"][i][j] != want and margin[i, row] > 2 * tol:
                    bad.append(f"rank {r}: bfloat16 step {i} row {row}: "
                               f"token {sv['tokens'][i][j]}, one device "
                               f"{want} (margin {margin[i, row]})")
                if sv32["tokens"][i][j] != int(arrays["tokens32"][row, i]):
                    bad.append(f"rank {r}: float32 step {i} row {row}: "
                               f"token {sv32['tokens'][i][j]}, one device "
                               f"{int(arrays['tokens32'][row, i])}")
    line["ranks"] = [dict(
        rank=rec["rank"], losses=rec["losses"], grad_norms=rec["grad_norms"],
        step_ms=rec["step_ms"], collectives_per_step=rec[
            "collectives_per_step"],
        bytes_gathered_per_step=rec["bytes_gathered_per_step"],
        bytes_reduced_per_step=rec["bytes_reduced_per_step"],
        resident_bytes=rec["resident_bytes"],
        resident_share={k: v / one["resident_bytes"][k]
                        for k, v in rec["resident_bytes"].items()},
        prefill_ms=rec["serve"]["prefill_ms"],
        decode_ms_per_token=statistics.median(rec["serve"]["ms"][1:]),
        decode_collectives_per_token=rec["serve"]["collectives"][-1],
        decode_bytes_gathered_per_token=rec["serve"]["gathered"][-1],
        decode_bytes_reduced_per_token=rec["serve"]["reduced"][-1],
        logits_max_abs_err=max(rec["serve"]["err"]),
        peak_memory_bytes=rec["peak_memory_bytes"],
        f32=dict(losses=rec["f32"]["losses"],
                 grad_norms=rec["f32"]["grad_norms"],
                 step_ms=rec["f32"]["step_ms"],
                 grad_err_share_of_tol=rec["f32"]["grad_err_share_of_tol"],
                 params=rec["f32"]["params"],
                 gather_save_ms=rec["f32"]["gather_save_ms"],
                 next_loss=rec["f32"]["next_loss"],
                 logits_max_abs_err=max(rec["f32"]["serve"]["err"]),
                 decode_ms_per_token=statistics.median(
                     rec["f32"]["serve"]["ms"][1:])))
        for rec in recs]
    line["checks"] = dict(
        loss_rel_err=max(abs(a - b) / abs(b) for rec in recs
                         for a, b in zip(rec["losses"], one["losses"])),
        grad_norm_rel_err=max(abs(a - b) / abs(b) for rec in recs
                              for a, b in zip(rec["grad_norms"],
                                              one["grad_norms"])),
        f32_loss_rel_err=max(abs(a - b) / abs(b) for rec in recs
                             for a, b in zip(rec["f32"]["losses"],
                                             one32["losses"])),
        f32_grad_norm_rel_err=max(
            abs(a - b) / abs(b) for rec in recs
            for a, b in zip(rec["f32"]["grad_norms"], one32["grad_norms"])),
        logits_max_abs_err=max(max(rec["serve"]["err"]) for rec in recs),
        logits_tol=[min(tols), max(tols)],
        f32_logits_max_abs_err=max(max(rec["f32"]["serve"]["err"])
                                   for rec in recs),
        token_mismatches=len(mism), tokens=int(tokens.size),
        failed=bad)
    line["phase_s"] = time.time() - t_phase
    log(json.dumps({"lm_mesh": line}))
    if bad:
        fail("phase 10: " + "; ".join(bad[:5]))
    return line


# ---------------------------------------------------------------------------
# phase 10 (c): the MoE family on the mesh
# ---------------------------------------------------------------------------

def _moe_cfg(layers, dtype=None):
    """``MOE_MESH_ARCH`` at full width cut to ``layers`` (block0 and
    layers − 1 MoE blocks), its weights and compute at ``dtype`` (None:
    the config's bfloat16)."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_MESH_ARCH).replace(num_layers=layers)
    if dtype is not None:
        cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    return cfg


def _moe_train_cfg():
    """The arch's policy (adafactor, bfloat16 states) at
    ``MOE_MESH_TRAIN_M`` microbatches and ``MOE_MESH_TRAIN_CFG``."""
    from repro_torch.configs import get_train_config
    return dataclasses.replace(get_train_config(MOE_MESH_ARCH),
                               microbatches=MOE_MESH_TRAIN_M,
                               **MOE_MESH_TRAIN_CFG)


def _build_seeded(cfg):
    """``cfg``'s model on the card from ``SEED`` and its digest."""
    from repro_torch.models import build_model
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    return model, _weights_digest(model)


def _free():
    """Free what the card's and the host's caches hold: gloo stages a
    collective on CUDA tensors through pinned host buffers, which
    PyTorch's host allocator keeps (a full-width expert leaf's are
    gigabytes a rank)."""
    gc.collect()
    torch.cuda.empty_cache()
    empty_host = getattr(torch._C, "_host_emptyCache", None)   # CUDA builds
    if empty_host is not None:
        empty_host()


def _mem_line(what):
    """This process's allocated and reserved bytes, the card's free
    bytes and this process's resident host bytes, on stderr (a rank that
    fails shows the tail of its stderr)."""
    free, total = torch.cuda.mem_get_info()
    rss = next((int(l.split()[1]) * 1024 for l in
                Path("/proc/self/status").read_text().splitlines()
                if l.startswith("VmRSS:")), None)
    print(f"memory {what}: allocated {torch.cuda.memory_allocated()}, "
          f"reserved {torch.cuda.memory_reserved()}, card free {free} of "
          f"{total}, host resident {rss}", file=sys.stderr, flush=True)


def _changed_shares(leaves, before):
    """Each leaf's share of elements that differ from ``before`` (the
    leaves' values before the steps, on the host or the card)."""
    return {"/".join(l.path): int((l.value().detach().to(b.device) != b)
                                  .sum()) / b.numel()
            for l, b in zip(leaves, before)}


def _train_steps(model, tcfg, steps, mesh=None, rank=None, grads_of=()):
    """``steps`` train steps of ``model`` (laid out on ``mesh``, or on
    one device) on launch/train's first batches (this rank's rows on a
    mesh), then the loss of the next batch (the global batch's). Returns
    the losses, grad norms, learning rates, step ms, collectives and
    bytes gathered and all-reduced a step, the MoE's drops, each leaf's
    share of elements the steps changed, the resident parameters,
    optimizer state and accumulators (on a mesh also the optimizer
    state's slices' bytes) and the peak memory; with ``grads_of`` (leaf
    names), also the last step's clipped gradients of those leaves
    under ``"kept"`` (host arrays, this rank's slices). A rank keeps the
    leaves' values before the steps on the host (four ranks share the
    card)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import shard
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import train_loop as tl
    torch.cuda.reset_peak_memory_stats()
    batches = [{k: v.cuda() for k, v in b.items()}
               for b in _lm_mesh_batches(model.cfg)]
    if mesh is not None:
        batches = [shard.shard_batch(b, mesh) for b in batches]
    state = tl.make_train_state(model, tcfg)
    step = tl.make_train_step(model, tcfg, mesh)
    keep = model.device if mesh is None else "cpu"
    before = [l.value().detach().to(keep, copy=True) for l in step.leaves]
    tr = {}
    with torch.no_grad():   # the next batch before the steps
        loss = step.loss(batches[steps])
        if mesh is not None:
            loss = mesh_lib.all_reduce(loss, dist.ReduceOp.SUM,
                                       model.layout.dp)
        tr["next_loss_before"] = float(loss)
    for i in range(steps):
        (state, m), c = _counted(lambda: step(state, batches[i]))
        for k, v in (("losses", float(m["loss"])),
                     ("grad_norms", float(m["grad_norm"])),
                     ("lrs", float(m["lr"])), ("drops", _dropped(model)),
                     *zip(("step_ms", "collectives_per_step",
                           "bytes_gathered_per_step",
                           "bytes_reduced_per_step"), c)):
            tr.setdefault(k, []).append(v)
        if mesh is not None:
            _mem_line(f"rank {rank} after train step {i}")
    tr["changed"] = _changed_shares(step.leaves, before)
    del before
    if grads_of:
        tr["kept"] = {"/".join(l.path): g.cpu().numpy()
                      for l, g in zip(step.leaves, step.grads)
                      if l.path[-1] in grads_of}
    with torch.no_grad():
        loss = step.loss(batches[steps])
        if mesh is not None:
            loss = mesh_lib.all_reduce(loss, dist.ReduceOp.SUM,
                                       model.layout.dp)
        tr["next_loss"] = float(loss)
    tr["resident_bytes"] = dict(
        params=shard.resident_bytes(model),
        opt=shard.resident_bytes(state["opt"]),
        grads=shard.resident_bytes(step.grads))
    if mesh is not None:
        tr["param_slices_bytes"] = _slices_bytes(model)
        abstract = shard.abstract_state(model.cfg, tcfg)
        specs = tl.state_specs(abstract, mesh)
        tr["opt_slices_bytes"] = sum(
            t.element_size() * int(np.prod(shd.local_shape(
                tuple(t.shape), s, mesh)))
            for (_, t), (_, s) in zip(_flat(abstract["opt"]),
                                      _flat(specs["opt"])))
    tr["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return tr


def _serve_one(model, G, feed=None, batch=SERVE_ARGS["batch"],
               prompt_len=SERVE_ARGS["prompt_len"], max_len=None):
    """The one device's prefill of launch/serve's prompt (``batch`` x
    ``prompt_len``, into caches of ``max_len``, P + G by default) and
    G − 1 greedy decode steps (fed the tokens ``feed`` (B, G) in place
    of its own when given): (record with prefill and decode ms and each
    pass's drops, arrays with each step's last logits (G, B, V) and the
    tokens (B, G))."""
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.runtime import serve_loop as sl
    B, P = batch, prompt_len
    prompt = prompt_batch(model, B, P, SEED + 1)
    (logits, caches), (ms, *_) = _counted(
        lambda: sl.make_prefill_step(model, max_len=max_len or P + G)(
            prompt))
    rec = dict(prefill_ms=ms, decode_ms=[], drops=[_dropped(model)])
    decode = sl.make_decode_step(model)
    tok = sl.greedy_token(model, logits)
    out, toks = [logits[:, -1].float().cpu().numpy()], [tok]
    for i in range(G - 1):
        if feed is not None:
            tok = torch.from_numpy(feed[:, i]).to(model.device)
        (tok, logits, caches), (ms, *_) = _counted(
            lambda: decode({"tokens": tok[:, None]}, caches, P + i))
        rec["decode_ms"].append(ms)
        rec["drops"].append(_dropped(model))
        out.append(logits[:, -1].float().cpu().numpy())
        toks.append(tok)
    return rec, dict(logits=np.stack(out),
                     tokens=torch.stack(toks, dim=1).cpu().numpy())


def _moe_one_device():
    """Phase 10 (c)'s one-device runs on the card, each model built from
    ``SEED`` and freed after: (2)'s float32 serve, (3)'s bfloat16 train
    steps (losses, grad norms, the leaves' changed shares, the next
    batch's loss, resident bytes) and bfloat16 serve. Returns the record
    and the arrays the ranks are held against."""
    from repro_torch.models import model as tmodel
    rec, arrays = {}, {}
    _free()
    saved = tmodel.CACHE_DTYPE
    tmodel.CACHE_DTYPE = torch.float32
    try:
        model, digest = _build_seeded(_moe_cfg(MOE_MESH_F32_LAYERS,
                                               "float32"))
        if model.num_params() != MOE_MESH_F32_PARAMS:
            fail(f"phase 10: {MOE_MESH_ARCH} at {MOE_MESH_F32_LAYERS} "
                 f"layers has {model.num_params()} parameters, the "
                 f"reference's {MOE_MESH_F32_PARAMS}")
        r, a = _serve_one(model, MOE_MESH_F32_GEN)
    finally:
        tmodel.CACHE_DTYPE = saved
    rec["f32_serve"] = dict(digest=digest, params=model.num_params(), **r)
    arrays.update(f32_logits=a["logits"], f32_tokens=a["tokens"])
    del model
    _free()

    model, digest = _build_seeded(_moe_cfg(MOE_MESH_TRAIN_LAYERS))
    rec["train"] = dict(digest=digest, **_train_steps(
        model, _moe_train_cfg(), MOE_MESH_TRAIN_STEPS))
    del model
    _free()

    cfg = _moe_cfg(MOE_MESH_BF16_LAYERS)
    model, digest = _build_seeded(cfg)
    r, a = _serve_one(model, MOE_MESH_BF16_GEN)
    rec["serve"] = dict(digest=digest, params=model.num_params(), **r)
    arrays.update(logits=a["logits"], tokens=a["tokens"])
    del model
    _free()
    # the one device's own bfloat16 error: the same weights at float32
    # compute with float32 caches, fed the same tokens
    tmodel.CACHE_DTYPE = torch.float32
    try:
        model, digest32 = _build_seeded(cfg.replace(compute_dtype="float32"))
        _, a32 = _serve_one(model, MOE_MESH_BF16_GEN, feed=a["tokens"])
    finally:
        tmodel.CACHE_DTYPE = saved
    if digest32 != digest:
        fail(f"phase 10 (c): the float32-compute model's weights differ "
             f"({digest32} against {digest})")
    rec["serve"]["bf16_error"] = [float(np.abs(x - y).max()) for x, y in
                                  zip(a["logits"], a32["logits"])]
    del model
    _free()
    return rec, arrays


def moe_mesh_rank(rank, mesh_dir):
    """One rank of phase 10 (c) on the ``LM_MESH_SHAPE`` mesh (gloo on
    CUDA tensors, every rank on the one card): (1) the tiny MoE configs
    (``_tiny_mesh_parity``, which fails this rank on a miss); (2) the
    full-width float32 serve and (3) the bfloat16 train steps and serve,
    each model built in turn by every rank from the seed and cut to its
    slice, fed the one device's tokens. Writes ``rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import _mesh_slice
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import shard
    from repro_torch.runtime import sharding as shd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dev = "cuda"
    torch.cuda.set_device(0)
    d = Path(mesh_dir)
    mesh_lib.init_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=LM_MESH_WORLD, device=dev,
                        timeout_s=LM_MESH_GROUP_TIMEOUT_S)
    mesh = mesh_lib.make_host_mesh(*LM_MESH_SHAPE, backend="gloo",
                                   device=dev)
    ref = np.load(d / "moe.npz")
    rows = _mesh_slice(np.arange(SERVE_ARGS["batch"]), mesh,
                       shd.logits_spec(mesh)[:1])
    rec = dict(rank=rank, rows=rows.tolist(), tiny=[
        _tiny_mesh_parity(a, mesh, MOE_MESH_TINY_FACTOR)
        for a in MOE_MESH_TINY])
    _free()
    _mem_line(f"rank {rank} after the tiny configs")

    def build_in_turn(cfg):
        return _build_in_turn(cfg, mesh, rank)

    # (2) float32 serve
    saved = tmodel.CACHE_DTYPE
    tmodel.CACHE_DTYPE = torch.float32
    try:
        model, digest = build_in_turn(_moe_cfg(MOE_MESH_F32_LAYERS,
                                               "float32"))
        torch.cuda.reset_peak_memory_stats()
        rec["f32_serve"] = dict(digest=digest, **_mesh_serve(
            model, mesh, ref["f32_logits"], ref["f32_tokens"],
            MOE_MESH_F32_GEN))
        rec["f32_serve"]["peak_memory_bytes"] = \
            torch.cuda.max_memory_allocated()
    finally:
        tmodel.CACHE_DTYPE = saved
    del model
    _free()
    _mem_line(f"rank {rank} after the float32 serve")

    # (3) bfloat16 train steps
    model, digest = build_in_turn(_moe_cfg(MOE_MESH_TRAIN_LAYERS))
    rec["train"] = dict(digest=digest, **_train_steps(
        model, _moe_train_cfg(), MOE_MESH_TRAIN_STEPS, mesh, rank))
    del model
    _free()
    _mem_line(f"rank {rank} after the train steps")

    # (3) bfloat16 serve
    model, digest = build_in_turn(_moe_cfg(MOE_MESH_BF16_LAYERS))
    torch.cuda.reset_peak_memory_stats()
    rec["serve"] = dict(digest=digest, **_mesh_serve(
        model, mesh, ref["logits"], ref["tokens"], MOE_MESH_BF16_GEN))
    rec["serve"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["serve"]["resident_param_bytes"] = shard.resident_bytes(model)
    (d / f"rank{rank}.json").write_text(json.dumps(rec))
    mesh_lib.barrier()
    dist.destroy_process_group()
    return 0


def _build_in_turn(cfg, mesh, rank):
    """``cfg``'s model from ``SEED``, cut to this rank's slice:
    ``MOE_MESH_BUILDERS`` ranks of the world at a time build the whole
    model and cut it (four whole full-width models would not fit on the
    card at once).
    Returns (model, digest of the whole weights)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import shard
    import torch.distributed as dist
    model = digest = None
    for turn in range(0, dist.get_world_size(), MOE_MESH_BUILDERS):
        if turn <= rank < turn + MOE_MESH_BUILDERS:
            _mem_line(f"rank {rank} before building {cfg.num_layers} "
                      f"layers at {cfg.param_dtype}")
            model, digest = _build_seeded(cfg)
            shard.shard_model(model, mesh)
            _free()
            _mem_line(f"rank {rank} cut")
        mesh_lib.barrier()
    return model, digest


def _bf16_tolerances(logits, own_error):
    """Each bfloat16 serve step's tolerance, the larger of
    ``SERVE_TF_ULPS`` units of its largest |logit| and the one device's
    own bfloat16 error, and the one device's top-2 margins (G, B)."""
    margin = np.diff(np.sort(logits, axis=-1)[..., -2:], axis=-1)[..., 0]
    return [max(SERVE_TF_ULPS * _bf16_ulp(np.abs(l).max()), e)
            for l, e in zip(logits, own_error)], margin


def _bf16_serve_misses(r, sv, rows, tokens, tols, margin):
    """A rank's bfloat16 serve against the one device: each step's
    logits within its tolerance, tokens equal where the one device's
    top-2 margin exceeds twice that."""
    bad = []
    for i, (err, tol) in enumerate(zip(sv["err"], tols)):
        if not err <= tol:
            bad.append(f"rank {r}: bfloat16 step {i}'s logits off by "
                       f"{err} (tolerance {tol})")
        for j, row in enumerate(rows):
            if sv["tokens"][i][j] != int(tokens[row, i]) and \
                    margin[i, row] > 2 * tol:
                bad.append(f"rank {r}: bfloat16 step {i} row {row}: "
                           f"token {sv['tokens'][i][j]}, one device "
                           f"{int(tokens[row, i])}")
    return bad


def _f32_serve_misses(r, what, f32, rows, tokens):
    """A rank's float32 serve against the one device's: logits within
    ``SERVE_TOL``, equal tokens."""
    bad = []
    for i, excess in enumerate(f32["excess"]):
        if not excess <= SERVE_TOL["atol"]:
            bad.append(f"rank {r}: {what} step {i}'s logits off by "
                       f"{f32['err'][i]}")
        if f32["tokens"][i] != tokens[rows, i].tolist():
            bad.append(f"rank {r}: {what} step {i}'s tokens "
                       f"{f32['tokens'][i]}, one device "
                       f"{tokens[rows, i].tolist()}")
    return bad


def _train_misses(r, tr, tr1, rtol=LM_MESH_BF16_RTOL, own=None,
                  share=LM_MESH_SHARE):
    """A rank's train steps against the one device's (``_train_steps``):
    losses, grad norms and the next batch's loss within ``rtol`` (a
    dict by "losses" and "grad_norms"), or within the one device's own
    bfloat16 error where ``own`` gives it and it is larger (``own``: the
    one device's float32-compute run, ``_own_errors``), parameters and
    accumulators at most ``share`` of the one device's (None: exactly
    the bytes of the parameters' slices, float32 parameters), the
    optimizer state its slices' bytes."""
    bad = []
    tol = {k: [rtol[k] * abs(b) for b in tr1[k]]
           for k in ("losses", "grad_norms")}
    tol["next_loss"] = rtol["losses"] * abs(tr1["next_loss"])
    if own is not None:
        tol = {k: (max(t, own[k]) if k == "next_loss" else
                   [max(a, b) for a, b in zip(t, own[k])])
               for k, t in tol.items()}
    for k in ("losses", "grad_norms"):
        if not all(abs(a - b) <= t
                   for a, b, t in zip(tr[k], tr1[k], tol[k])):
            bad.append(f"rank {r}: {k} {tr[k]} on the mesh, {tr1[k]} on "
                       f"one device (tolerances {tol[k]})")
    if not abs(tr["next_loss"] - tr1["next_loss"]) <= tol["next_loss"]:
        bad.append(f"rank {r}: the loss after the steps {tr['next_loss']}, "
                   f"one device {tr1['next_loss']} (tolerance "
                   f"{tol['next_loss']})")
    res, res1 = tr["resident_bytes"], tr1["resident_bytes"]
    for k in ("params", "grads"):
        if share is None and res[k] != tr["param_slices_bytes"]:
            bad.append(f"rank {r} holds {res[k]} B of {k}, its slices "
                       f"{tr['param_slices_bytes']}")
        elif share is not None and not res[k] <= share * res1[k]:
            bad.append(f"rank {r} holds {res[k]} B of {k}, the one device "
                       f"{res1[k]}")
    if res["opt"] != tr["opt_slices_bytes"]:
        bad.append(f"rank {r} holds {res['opt']} B of optimizer state, its "
                   f"slices {tr['opt_slices_bytes']}")
    return bad


def _own_errors(tr1, tr32):
    """The one device's own bfloat16 error in each train metric: its
    bfloat16 run's losses, grad norms and next batch's loss against its
    float32-compute run's on the same weights and batches."""
    own = {k: [abs(a - b) for a, b in zip(tr1[k], tr32[k])]
           for k in ("losses", "grad_norms")}
    own["next_loss"] = abs(tr1["next_loss"] - tr32["next_loss"])
    return own


def _changed_misses(tr1, recs, what="train"):
    """Each leaf's share of elements the steps changed (of ``what``),
    the ranks' mean against the one device's, within
    ``MOE_MESH_CHANGED_TOL``."""
    bad = []
    for path, want in tr1["changed"].items():
        got = float(np.mean([rec[what]["changed"][path] for rec in recs]))
        if not abs(got - want) <= MOE_MESH_CHANGED_TOL:
            bad.append(f"{path}: the steps changed {got} of its elements "
                       f"on the mesh, {want} on one device")
    return bad


def _moe_checks(one, arrays, recs):
    """What phase 10 (c)'s ranks must meet against the one device: a
    list of the misses."""
    bad = []
    tr1 = one["train"]
    tols, margin = _bf16_tolerances(arrays["logits"],
                                    one["serve"]["bf16_error"])
    for r, rec in enumerate(recs):
        for t in rec["tiny"]:
            if not sum(t["drops"]) > 0:
                bad.append(f"rank {r}: {t['arch']} (tiny) dropped nothing")
        for what in ("f32_serve", "train", "serve"):
            if abs(rec[what]["digest"] - one[what]["digest"]) > 1e-9 * abs(
                    one[what]["digest"]):
                bad.append(f"rank {r} built other {what} weights")
        f32, rows = rec["f32_serve"], rec["rows"]
        bad += _f32_serve_misses(r, "float32", f32, rows,
                                 arrays["f32_tokens"])
        if f32["drops"] != one["f32_serve"]["drops"]:
            bad.append(f"rank {r}: float32 drops {f32['drops']}, one "
                       f"device {one['f32_serve']['drops']}")
        bad += _train_misses(r, rec["train"], tr1)
        bad += _bf16_serve_misses(r, rec["serve"], rows, arrays["tokens"],
                                  tols, margin)
    return bad + _changed_misses(tr1, recs)


def _moe_reckon(cfg, weight_bytes, shape=LM_MESH_SHAPE):
    """What the rules give a rank of a mesh of ``shape`` for ``cfg``,
    from the shapes alone (a model on ``meta``): its share of
    the parameters, and the bytes its FSDP gathers receive in one
    forward with weights at ``weight_bytes`` (the float32 router at 4),
    those of the stacked blocks apart (gathered again under remat), and
    the float32 gradients their backward all-reduces."""
    from repro_torch.models import build_model
    from repro_torch.models.model import ref_leaves
    from repro_torch.runtime import sharding as shd
    mesh = dict(zip(("data", "model"), shape))
    dp = mesh["data"]
    whole = mine = gathered = blocks = reduced = 0
    for leaf in ref_leaves(build_model(cfg, device="meta",
                                       generator=torch.Generator())):
        spec = shd.spec_for_param(leaf.path, leaf.shape, mesh) or \
            (None,) * len(leaf.shape)
        n = int(np.prod(shd.local_shape(leaf.shape, spec, mesh)))
        whole += int(np.prod(leaf.shape))
        mine += n
        if "data" in shd.spec_axes(spec):
            b = n * (dp - 1) * (4 if leaf.path[-1] == "router"
                                else weight_bytes)
            gathered += b
            blocks += b if leaf.path[0] == "blocks" else 0
            reduced += n * dp * 4
    return dict(param_share=mine / whole, gathered_forward=gathered,
                gathered_blocks=blocks, reduced_weight_grads=reduced)


def moe_mesh_phase():
    """Phase 10 (c), as the module's docstring says: the one-device runs
    here, then ``LM_MESH_WORLD`` ranks spawned on the one card
    (``moe_mesh_rank``), held against them. Fails on any check, a rank's
    non-zero exit or timeout. One ``moe_mesh`` JSON line."""
    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.time()
    one, arrays = _moe_one_device()
    line = dict(card=card_line(), arch=MOE_MESH_ARCH,
                mesh=list(LM_MESH_SHAPE), one_device=one, reckoned=dict(
                    f32_serve=_moe_reckon(_moe_cfg(MOE_MESH_F32_LAYERS), 4),
                    train=_moe_reckon(_moe_cfg(MOE_MESH_TRAIN_LAYERS), 2),
                    serve=_moe_reckon(_moe_cfg(MOE_MESH_BF16_LAYERS), 2)),
                note=f"the {LM_MESH_WORLD}-rank walls are {LM_MESH_WORLD} "
                     f"processes time-sliced on one card over gloo, not a "
                     f"scale-out figure")
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        np.savez(d / "moe.npz", **arrays)
        cmds = [[sys.executable, str(ROOT / "chip_smoke.py"),
                 "--moe-mesh-rank", str(r), "--mesh-dir", str(d)]
                for r in range(LM_MESH_WORLD)]
        _mem_line("phase 10 (c) before the ranks")
        t0 = time.perf_counter()
        try:
            # four ranks share the card: segments that grow keep a freed
            # gather's memory from stranding in a rank's cache
            outs = mesh_lib.run_ranks(
                cmds, timeout_s=MOE_MESH_TIMEOUT_S, cwd=str(ROOT),
                env=dict(os.environ,
                         PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
        except (TimeoutError, mesh_lib.RankFailed) as e:
            fail(f"phase 10 (c): {e}")
        line["ranks_wall_ms"] = (time.perf_counter() - t0) * 1e3
        line["rank_memory"] = [[m for m in err.splitlines()
                                if m.startswith("memory")]
                               for _, _, err in outs]
        recs = [json.loads((d / f"rank{r}.json").read_text())
                for r in range(LM_MESH_WORLD)]
    bad = _moe_checks(one, arrays, recs)
    tr1 = one["train"]["resident_bytes"]
    line["ranks"] = [dict(
        rank=rec["rank"], tiny=rec["tiny"],
        f32_serve={k: v for k, v in rec["f32_serve"].items()
                   if k not in ("tokens", "digest")},
        train={k: v for k, v in rec["train"].items()
               if k not in ("changed", "digest")},
        resident_share={k: v / tr1[k] for k, v in
                        rec["train"]["resident_bytes"].items()},
        serve={k: v for k, v in rec["serve"].items()
               if k not in ("tokens", "digest")},
        decode_ms_per_token=statistics.median(rec["serve"]["ms"][1:]
                                              or rec["serve"]["ms"]),
        f32_decode_ms_per_token=statistics.median(
            rec["f32_serve"]["ms"][1:] or rec["f32_serve"]["ms"]))
        for rec in recs]
    line["changed_share_max_diff"] = max(
        abs(float(np.mean([rec["train"]["changed"][p] for rec in recs]))
            - w) for p, w in one["train"]["changed"].items())
    line["failed"] = bad
    line["phase_s"] = time.time() - t_phase
    log(json.dumps({"moe_mesh": line}))
    if bad:
        fail("phase 10 (c): " + "; ".join(bad[:5]))
    return line


# ---------------------------------------------------------------------------
# phase 10 (d): the ssm, hybrid and encdec families on the mesh
# ---------------------------------------------------------------------------

def _ssm_cfg(arch, layers, dtype=None):
    """``arch`` at full width cut to ``layers``, its weights and compute
    at ``dtype`` (None: the config's bfloat16)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(num_layers=layers)
    if dtype is not None:
        cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    return cfg


def _ssm_one_device():
    """Phase 10 (d)'s one-device runs on the card, each model built from
    ``SEED`` and freed after: (2)'s bfloat16 serve and train steps on one
    model, then its float32 serve, the same serve fed the bfloat16 run's
    tokens (the one device's own bfloat16 error) and the float32 train
    steps on one model, and (3)'s float32 serve. Returns the record and
    the arrays the ranks are held against."""
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import shard
    rec, arrays = {}, {}
    saved = tmodel.CACHE_DTYPE
    tcfg = _lm_mesh_train_cfg(SSM_MESH_ARCH)
    _free()
    model, digest = _build_seeded(_ssm_cfg(SSM_MESH_ARCH, SSM_MESH_LAYERS))
    r, a = _serve_one(model, SSM_MESH_GEN)
    rec["serve"] = dict(digest=digest, **r)
    arrays.update(logits=a["logits"], tokens=a["tokens"])
    rec["train"] = dict(digest=digest, **_train_steps(
        model, tcfg, SSM_MESH_TRAIN_STEPS))
    del model
    _free()
    tmodel.CACHE_DTYPE = torch.float32
    try:
        for key, arch, layers, want in (
                ("f32_serve", SSM_MESH_ARCH, SSM_MESH_LAYERS,
                 SSM_MESH_PARAMS),
                ("xlstm_f32_serve", SSM_MESH_XLSTM, SSM_MESH_XLSTM_LAYERS,
                 SSM_MESH_XLSTM_PARAMS)):
            model, digest = _build_seeded(_ssm_cfg(arch, layers, "float32"))
            if model.num_params() != want:
                fail(f"phase 10 (d): {arch} at {layers} layers has "
                     f"{model.num_params()} parameters, the reference's "
                     f"{want}")
            r, a32 = _serve_one(model, SSM_MESH_GEN)
            rec[key] = dict(digest=digest, params=model.num_params(),
                            resident_param_bytes=shard.resident_bytes(model),
                            **r)
            arrays.update({f"{key}_logits": a32["logits"],
                           f"{key}_tokens": a32["tokens"]})
            if arch == SSM_MESH_ARCH:
                # the same weights as the bfloat16 run's (float32
                # parameters, the compute at float32): its own bfloat16
                # error in the serve, fed the same tokens, and in the
                # train steps
                if digest != rec["serve"]["digest"]:
                    fail(f"phase 10 (d): the float32 model's weights "
                         f"differ ({digest} against "
                         f"{rec['serve']['digest']})")
                _, fed = _serve_one(model, SSM_MESH_GEN, feed=a["tokens"])
                rec["serve"]["bf16_error"] = [
                    float(np.abs(x - y).max())
                    for x, y in zip(a["logits"], fed["logits"])]
                rec["f32_train"] = dict(digest=digest, **_train_steps(
                    model, tcfg, SSM_MESH_TRAIN_STEPS))
            del model
            _free()
    finally:
        tmodel.CACHE_DTYPE = saved
    return rec, arrays


def _slices_bytes(model):
    """The bytes of the slices the rules give this rank of every
    parameter leaf, at the parameters' dtypes."""
    from repro_torch.runtime import sharding as shd
    return sum(l.params[0].element_size() * int(np.prod(shd.local_shape(
        l.global_shape, l.spec, l.mesh))) for l in model.layout.leaves)


def ssm_mesh_rank(rank, mesh_dir):
    """One rank of phase 10 (d) on the ``LM_MESH_SHAPE`` mesh (gloo on
    CUDA tensors, every rank on the one card): (1) the tiny xlstm,
    zamba2 and seamless configs (``_tiny_mesh_parity``, which fails this
    rank on a miss); (2) zamba2-7b's float32 serve and train steps on
    one model, then its bfloat16 serve and train steps on another; (3)
    xlstm-1.3b's float32 serve;
    each model built in turn by every rank from the seed and cut to its
    slice, fed the one device's tokens. Writes ``rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import _mesh_slice
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import shard
    from repro_torch.runtime import sharding as shd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dev = "cuda"
    torch.cuda.set_device(0)
    d = Path(mesh_dir)
    mesh_lib.init_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=LM_MESH_WORLD, device=dev,
                        timeout_s=LM_MESH_GROUP_TIMEOUT_S)
    mesh = mesh_lib.make_host_mesh(*LM_MESH_SHAPE, backend="gloo",
                                   device=dev)
    ref = np.load(d / "ssm.npz")
    rows = _mesh_slice(np.arange(SERVE_ARGS["batch"]), mesh,
                       shd.logits_spec(mesh)[:1])
    t0 = time.perf_counter()
    rec = dict(rank=rank, rows=rows.tolist(), tiny=[
        _tiny_mesh_parity(a, mesh) for a in SSM_MESH_TINY])
    rec["tiny_ms"] = (time.perf_counter() - t0) * 1e3
    _free()

    saved = tmodel.CACHE_DTYPE
    tmodel.CACHE_DTYPE = torch.float32
    try:
        for key, arch, layers in (
                ("f32_serve", SSM_MESH_ARCH, SSM_MESH_LAYERS),
                ("xlstm_f32_serve", SSM_MESH_XLSTM, SSM_MESH_XLSTM_LAYERS)):
            model, digest = _build_in_turn(_ssm_cfg(arch, layers, "float32"),
                                           mesh, rank)
            torch.cuda.reset_peak_memory_stats()
            rec[key] = dict(digest=digest, **_mesh_serve(
                model, mesh, ref[f"{key}_logits"], ref[f"{key}_tokens"],
                SSM_MESH_GEN))
            rec[key].update(
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                resident_param_bytes=shard.resident_bytes(model),
                slices_bytes=_slices_bytes(model))
            if arch == SSM_MESH_ARCH:
                rec["f32_train"] = dict(digest=digest, **_train_steps(
                    model, _lm_mesh_train_cfg(SSM_MESH_ARCH),
                    SSM_MESH_TRAIN_STEPS, mesh, rank))
            del model
            _free()
    finally:
        tmodel.CACHE_DTYPE = saved

    model, digest = _build_in_turn(_ssm_cfg(SSM_MESH_ARCH, SSM_MESH_LAYERS),
                                   mesh, rank)
    torch.cuda.reset_peak_memory_stats()
    rec["serve"] = dict(digest=digest, **_mesh_serve(
        model, mesh, ref["logits"], ref["tokens"], SSM_MESH_GEN))
    rec["serve"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["train"] = dict(digest=digest, **_train_steps(
        model, _lm_mesh_train_cfg(SSM_MESH_ARCH), SSM_MESH_TRAIN_STEPS,
        mesh, rank))
    (d / f"rank{rank}.json").write_text(json.dumps(rec))
    mesh_lib.barrier()
    dist.destroy_process_group()
    return 0


def _ssm_checks(one, arrays, recs):
    """What phase 10 (d)'s ranks must meet against the one device: a list
    of the misses."""
    bad = []
    tr1 = one["train"]
    tols, margin = _bf16_tolerances(arrays["logits"],
                                    one["serve"]["bf16_error"])
    for r, rec in enumerate(recs):
        for what in ("f32_serve", "xlstm_f32_serve", "train", "serve",
                     "f32_train"):
            if abs(rec[what]["digest"] - one[what]["digest"]) > 1e-9 * abs(
                    one[what]["digest"]):
                bad.append(f"rank {r} built other {what} weights")
        rows = rec["rows"]
        for key in ("f32_serve", "xlstm_f32_serve"):
            bad += _f32_serve_misses(r, key, rec[key], rows,
                                     arrays[f"{key}_tokens"])
        xl = rec["xlstm_f32_serve"]
        if xl["resident_param_bytes"] != xl["slices_bytes"]:
            bad.append(f"rank {r} holds {xl['resident_param_bytes']} B of "
                       f"xlstm parameters, its slices {xl['slices_bytes']}")
        bad += _train_misses(r, rec["f32_train"], one["f32_train"],
                             TRAIN_METRIC_RTOL_BY)
        bad += _train_misses(r, rec["train"], tr1,
                             own=_own_errors(tr1, one["f32_train"]))
        bad += _bf16_serve_misses(r, rec["serve"], rows, arrays["tokens"],
                                  tols, margin)
    return (bad + _changed_misses(tr1, recs)
            + _changed_misses(one["f32_train"], recs, "f32_train"))


def ssm_mesh_phase():
    """Phase 10 (d), as the module's docstring says: the one-device runs
    here, then ``LM_MESH_WORLD`` ranks spawned on the one card
    (``ssm_mesh_rank``), held against them. Fails on any check, a rank's
    non-zero exit or timeout. One ``ssm_mesh`` JSON line."""
    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.time()
    one, arrays = _ssm_one_device()
    line = dict(card=card_line(), arch=SSM_MESH_ARCH,
                layers=SSM_MESH_LAYERS, xlstm_layers=SSM_MESH_XLSTM_LAYERS,
                mesh=list(LM_MESH_SHAPE), one_device=one,
                one_device_s=time.time() - t_phase, reckoned=dict(
                    f32_serve=_moe_reckon(_ssm_cfg(
                        SSM_MESH_ARCH, SSM_MESH_LAYERS), 4),
                    train=_moe_reckon(_ssm_cfg(SSM_MESH_ARCH,
                                               SSM_MESH_LAYERS), 2),
                    xlstm_f32_serve=_moe_reckon(_ssm_cfg(
                        SSM_MESH_XLSTM, SSM_MESH_XLSTM_LAYERS), 4)),
                note=f"the {LM_MESH_WORLD}-rank walls are {LM_MESH_WORLD} "
                     f"processes time-sliced on one card over gloo, not a "
                     f"scale-out figure")
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        np.savez(d / "ssm.npz", **arrays)
        cmds = [[sys.executable, str(ROOT / "chip_smoke.py"),
                 "--ssm-mesh-rank", str(r), "--mesh-dir", str(d)]
                for r in range(LM_MESH_WORLD)]
        t0 = time.perf_counter()
        try:
            outs = mesh_lib.run_ranks(
                cmds, timeout_s=SSM_MESH_TIMEOUT_S, cwd=str(ROOT),
                env=dict(os.environ,
                         PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
        except (TimeoutError, mesh_lib.RankFailed) as e:
            fail(f"phase 10 (d): {e}")
        line["ranks_wall_ms"] = (time.perf_counter() - t0) * 1e3
        line["rank_memory"] = [[m for m in err.splitlines()
                                if m.startswith("memory")][-2:]
                               for _, _, err in outs]
        recs = [json.loads((d / f"rank{r}.json").read_text())
                for r in range(LM_MESH_WORLD)]
    bad = _ssm_checks(one, arrays, recs)
    _SSM_ONE_DEVICE["ssm"] = (one, arrays)
    tr1 = one["train"]["resident_bytes"]

    def per_token(sv):
        return dict(decode_ms_per_token=statistics.median(sv["ms"][1:]
                                                          or sv["ms"]),
                    collectives_per_token=sv["collectives"][-1],
                    bytes_gathered_per_token=sv["gathered"][-1],
                    bytes_reduced_per_token=sv["reduced"][-1],
                    prefill_ms=sv["prefill_ms"],
                    logits_max_abs_err=max(sv["err"]),
                    peak_memory_bytes=sv["peak_memory_bytes"])
    line["ranks"] = [dict(
        rank=rec["rank"], tiny=rec["tiny"], tiny_ms=rec["tiny_ms"],
        f32_serve=per_token(rec["f32_serve"]),
        xlstm_f32_serve=dict(
            per_token(rec["xlstm_f32_serve"]),
            resident_param_share=rec["xlstm_f32_serve"][
                "resident_param_bytes"]
            / one["xlstm_f32_serve"]["resident_param_bytes"],
            resident_param_bytes=rec["xlstm_f32_serve"][
                "resident_param_bytes"],
            slices_bytes=rec["xlstm_f32_serve"]["slices_bytes"]),
        serve=per_token(rec["serve"]),
        train={k: v for k, v in rec["train"].items()
               if k not in ("changed", "digest")},
        f32_train={k: v for k, v in rec["f32_train"].items()
                   if k not in ("changed", "digest")},
        first_step_ms=rec["train"]["step_ms"][0],
        resident_share={k: v / tr1[k] for k, v in
                        rec["train"]["resident_bytes"].items()})
        for rec in recs]
    def rel_errs(what):
        """The largest relative gap of the ranks' train metrics to the
        one device's: losses, grad norms, next loss; and the changed
        shares' largest gap."""
        tr1 = one[what]
        out = {k: max(abs(a - b) / abs(b) for rec in recs
                      for a, b in zip(rec[what][k], tr1[k]))
               for k in ("losses", "grad_norms")}
        out["next_loss"] = max(abs(rec[what]["next_loss"]
                                   - tr1["next_loss"]) / abs(tr1["next_loss"])
                               for rec in recs)
        out["changed_share_max_diff"] = max(
            abs(float(np.mean([rec[what]["changed"][p] for rec in recs]))
                - w) for p, w in tr1["changed"].items())
        return out
    own = _own_errors(one["train"], one["f32_train"])
    line["checks"] = dict(
        bf16_train_rel_err=rel_errs("train"),
        bf16_train_own_rel_err=dict(
            losses=max(e / abs(b) for e, b in zip(
                own["losses"], one["train"]["losses"])),
            grad_norms=max(e / abs(b) for e, b in zip(
                own["grad_norms"], one["train"]["grad_norms"])),
            next_loss=own["next_loss"] / abs(one["train"]["next_loss"])),
        f32_train_rel_err=rel_errs("f32_train"),
        f32_logits_max_abs_err=max(max(rec["f32_serve"]["err"])
                                   for rec in recs),
        xlstm_f32_logits_max_abs_err=max(max(rec["xlstm_f32_serve"]["err"])
                                         for rec in recs),
        bf16_logits_max_abs_err=max(max(rec["serve"]["err"])
                                    for rec in recs),
        bf16_own_error=one["serve"]["bf16_error"],
        failed=bad)
    line["phase_s"] = time.time() - t_phase
    log(json.dumps({"ssm_mesh": line}))
    if bad:
        fail("phase 10 (d): " + "; ".join(bad[:5]))
    return line


def _tiny_seq_parity(arch, mesh, batch, kv=None):
    """Phase 10 (e) (1) on each rank for one tiny config at ``batch``
    (``kv``: its KV heads, the config's if None): the prefill and
    ``SEQ_MESH_TINY_GEN`` greedy tokens at float32 caches, then one
    AdamW step of a batch of as many rows, the mesh's path on this
    rank's slice against the one device's on the whole batch, both on
    the card: logits, tokens, drops, every cache leaf as its slice
    (``infer_cache_specs``), loss, grad norm and every gradient leaf.
    Fails this rank on a miss."""
    from repro_torch.checkpoint.manager import _mesh_slice
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import mesh_ctx
    from repro_torch.runtime import serve_loop as sl
    from repro_torch.runtime import shard
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import train_loop as tl
    dev = "cuda"
    cfg = tiny_config(get_config(arch))
    if kv is not None:
        cfg = cfg.replace(kv_heads=kv)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_MESH_TINY_FACTOR))
    weights = tmodel.params_to_numpy(tmodel.build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(SEED)))
    shape = list(shd.mesh_shape(mesh).values())
    where = (f"phase 10 (e): {arch} (tiny, {cfg.kv_heads} KV heads) at a "
             f"batch of {batch} on {tuple(shape)}")

    def mine(t, spec):
        return _mesh_slice(t.detach().float().cpu().numpy(), mesh, spec)

    def both():
        one = tmodel.params_from_numpy(tmodel.build_model(cfg, device=dev),
                                       weights)
        sh = tmodel.params_from_numpy(shard.shard_model(tmodel.build_model(
            cfg, device=dev), mesh), weights)
        return one, sh
    rec = dict(arch=arch, batch=batch, kv_heads=cfg.kv_heads, mesh=shape)
    mesh_lib.collectives.reset()
    saved = tmodel.CACHE_DTYPE
    tmodel.CACHE_DTYPE = torch.float32
    try:
        one, sh = both()
        P, G = SERVE_TINY_ARGS["prompt_len"], SEQ_MESH_TINY_GEN
        prompt = prompt_batch(one, batch, P, SEED + 1)
        local = shard.shard_batch(prompt, mesh)
        lspec = (local.specs["tokens"][0], None, shd.logits_spec(mesh)[2])
        start = P + (tmodel.VLM_PATCHES if cfg.family == "vlm" else 0)
        l1, c1 = sl.make_prefill_step(one, max_len=start + G)(prompt)
        l2, c2 = sl.make_prefill_step(sh, mesh, max_len=start + G)(local)
        errs, same, drops = [], True, []

        def score(l1, l2, t1, t2):
            nonlocal same
            errs.append(float(np.abs(mine(l1, lspec)
                                     - l2.float().cpu().numpy()).max()))
            same &= bool(np.array_equal(mine(t1, lspec[:1]),
                                        t2.cpu().numpy()))
            drops.append([_dropped(one), _dropped(sh)])
        t1, t2 = sl.greedy_token(one, l1), sl.greedy_token(sh, l2)
        score(l1, l2, t1, t2)
        dec1 = sl.make_decode_step(one)
        dec2 = sl.jit_decode_step(sh, mesh, c2, shd.infer_batch_specs(
            {"tokens": t1[:, None]}, mesh))
        for i in range(G - 1):
            t1, l1, c1 = dec1({"tokens": t1[:, None]}, c1, start + i)
            t2, l2, c2 = dec2({"tokens": t2[:, None]}, c2, start + i)
            score(l1, l2, t1, t2)
        cache_err = 0.0
        for (path, a), (_, b), (_, spec) in zip(
                _flat(c2), _flat(c1), _flat(shd.infer_cache_specs(c1,
                                                                  mesh))):
            want = mine(b, spec)
            if tuple(a.shape) != want.shape:
                fail(f"{where}: cache {'/'.join(path)} {tuple(a.shape)} on "
                     f"this rank, its slice {want.shape}")
            cache_err = max(cache_err, float(np.abs(
                a.float().cpu().numpy() - want).max()))
            if path[-1] in ("k", "ckv", "memory"):
                rec[f"{path[-1]}_spec"] = [
                    e if e is None or isinstance(e, str) else list(e)
                    for e in spec]
    finally:
        tmodel.CACHE_DTYPE = saved
    if not (same and max(errs) <= SERVE_TOL["atol"]
            and cache_err <= SERVE_TOL["atol"]
            and all(a == b for a, b in drops)):
        fail(f"{where}: tokens equal {same}, logits off by {max(errs)}, "
             f"caches by {cache_err}, drops {drops}")
    rec.update(serve_logits_max_abs_err=max(errs), cache_max_abs_err=cache_err,
               drops=[a for a, _ in drops])
    if _slices_bytes(sh) != shard.resident_bytes(sh):
        fail(f"{where}: {shard.resident_bytes(sh)} B of parameters, its "
             f"slices {_slices_bytes(sh)}")
    del one, sh
    tcfg = TrainConfig(optimizer="adamw", microbatches=1,
                       learning_rate=1e-3, warmup_steps=1, total_steps=10)
    one, sh = both()
    data = _train_batch(cfg, dev, SEED + 4, batch, TRAIN_TINY_BATCH["seq"],
                        TRAIN_TINY_BATCH["patches"],
                        TRAIN_TINY_BATCH["frames"])
    data["labels"][:, ::5] = -1
    step1, step2 = tl.make_train_step(one, tcfg), tl.make_train_step(
        sh, tcfg, mesh)
    _, m1 = step1(tl.make_train_state(one, tcfg), data)
    _, m2 = step2(tl.make_train_state(sh, tcfg), shard.shard_batch(data,
                                                                   mesh))
    metric_err = max(abs(float(m2[k]) - float(m1[k])) / abs(float(m1[k]))
                     for k in ("loss", "grad_norm"))
    grad_err = max(float(np.abs(mine(g1, leaf.spec) - g2.cpu().numpy()).max())
                   / (TRAIN_GRAD_RTOL * float(g1.abs().max()) + 1e-6)
                   for leaf, g1, g2 in zip(step2.leaves, step1.grads,
                                           step2.grads))
    if not (metric_err <= TRAIN_METRIC_RTOL and grad_err <= 1.0):
        fail(f"{where}: train loss / grad norm off by {metric_err} "
             f"relative, gradients by {grad_err} of their tolerance")
    rec.update(train_metric_rel_err=metric_err, grad_err_of_tol=grad_err,
               collectives=mesh_lib.collectives.count,
               gathered=mesh_ctx.traffic.gathered,
               reduced=mesh_ctx.traffic.reduced)
    return rec


def _seq_one_device():
    """Phase 10 (e)'s one-device runs on the card, each model built from
    ``SEED`` and freed after: (2)'s bfloat16 serve, its float32 serve
    and the same fed the bfloat16 tokens (the one device's own bfloat16
    error), its float32 then bfloat16 train step at
    ``SEQ_MESH_TRAIN_LAYERS`` (wk/wv's gradients kept), and (3)'s
    float32 serves at a batch of 1. Returns the record and the arrays
    the ranks are held against."""
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import shard
    rec, arrays = {}, {}
    saved = tmodel.CACHE_DTYPE
    tcfg = _lm_mesh_train_cfg(SEQ_MESH_ARCH)

    def build(arch, layers, dtype, want):
        _free()
        model, digest = _build_seeded(_ssm_cfg(arch, layers, dtype))
        if model.num_params() != want:
            fail(f"phase 10 (e): {arch} at {layers} layers has "
                 f"{model.num_params()} parameters, the reference's {want}")
        return model, digest
    model, digest = build(SEQ_MESH_ARCH, SEQ_MESH_LAYERS, None,
                          SEQ_MESH_PARAMS)
    r, a = _serve_one(model, SEQ_MESH_GEN)
    rec["serve"] = dict(digest=digest, **r)
    arrays.update(logits=a["logits"], tokens=a["tokens"])
    del model
    tmodel.CACHE_DTYPE = torch.float32
    try:
        model, digest = build(SEQ_MESH_ARCH, SEQ_MESH_LAYERS, "float32",
                              SEQ_MESH_PARAMS)
        r, a32 = _serve_one(model, SEQ_MESH_GEN)
        rec["f32_serve"] = dict(digest=digest, params=model.num_params(),
                                resident_param_bytes=shard.resident_bytes(
                                    model), **r)
        arrays.update(f32_serve_logits=a32["logits"],
                      f32_serve_tokens=a32["tokens"])
        _, fed = _serve_one(model, SEQ_MESH_GEN, feed=a["tokens"])
        rec["serve"]["bf16_error"] = [float(np.abs(x - y).max()) for x, y
                                      in zip(a["logits"], fed["logits"])]
        del model
        for key, arch, layers, want in (
                ("zamba2_b1", SSM_MESH_ARCH, SSM_MESH_LAYERS,
                 SSM_MESH_PARAMS),
                ("xlstm_b1", SSM_MESH_XLSTM, SSM_MESH_XLSTM_LAYERS,
                 SSM_MESH_XLSTM_PARAMS)):
            model, digest = build(arch, layers, "float32", want)
            r, a1 = _serve_one(model, SEQ_MESH_B1_GEN, **SEQ_MESH_B1)
            rec[key] = dict(digest=digest, params=model.num_params(),
                            resident_param_bytes=shard.resident_bytes(model),
                            **r)
            arrays.update({f"{key}_logits": a1["logits"],
                           f"{key}_tokens": a1["tokens"]})
            del model
        model, digest = build(SEQ_MESH_ARCH, SEQ_MESH_TRAIN_LAYERS,
                              "float32", SEQ_MESH_TRAIN_PARAMS)
        tr = _train_steps(model, tcfg, 1, grads_of=("wk", "wv"))
        arrays.update({f"grad:{k}": v for k, v in tr.pop("kept").items()})
        rec["f32_train"] = dict(digest=digest, **tr)
        del model
    finally:
        tmodel.CACHE_DTYPE = saved
    model, digest = build(SEQ_MESH_ARCH, SEQ_MESH_TRAIN_LAYERS, None,
                          SEQ_MESH_TRAIN_PARAMS)
    tr = _train_steps(model, tcfg, 1, grads_of=("wk", "wv"))
    arrays.update({f"bf16_grad:{k}": v for k, v in tr.pop("kept").items()})
    rec["train"] = dict(digest=digest, **tr)
    del model
    _free()
    return rec, arrays


def seq_mesh_rank(rank, mesh_dir):
    """One rank of phase 10 (e), every rank on the one card (gloo on CUDA
    tensors), on two meshes of the same world, ``LM_MESH_SHAPE`` and
    ``SEQ_MESH_KV_SHAPE``: (1) the tiny configs
    (``_tiny_seq_parity``, which fails this rank on a miss); (2)
    qwen2.5-3b's float32 serve, then its float32 train step at
    ``SEQ_MESH_TRAIN_LAYERS`` (wk/wv's gradients against the one
    device's); (3) zamba2-7b's and xlstm-1.3b's float32 serves at a
    batch of 1; then (2)'s bfloat16 serve and train step; each model
    built in turn by every rank from the seed and cut to its slice, fed
    the one device's tokens. Writes ``rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import shard
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dev = "cuda"
    torch.cuda.set_device(0)
    d = Path(mesh_dir)
    mesh_lib.init_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=LM_MESH_WORLD, device=dev,
                        timeout_s=LM_MESH_GROUP_TIMEOUT_S)
    mesh = mesh_lib.make_host_mesh(*LM_MESH_SHAPE, backend="gloo",
                                   device=dev)
    kv_mesh = mesh_lib.make_host_mesh(*SEQ_MESH_KV_SHAPE, backend="gloo",
                                      device=dev)
    ref = np.load(d / "seq.npz")
    t0 = time.perf_counter()
    rec = dict(rank=rank, tiny=[
        *[_tiny_seq_parity(a, mesh, 1) for a in SEQ_MESH_TINY_B1],
        _tiny_seq_parity(SEQ_MESH_ARCH, mesh, 1, kv=1),
        *[_tiny_seq_parity(a, kv_mesh, SERVE_ARGS["batch"],
                           kv=2 if a == SSM_MESH_ARCH else None)
          for a in SEQ_MESH_TINY_KV]])
    rec["tiny_ms"] = (time.perf_counter() - t0) * 1e3
    _free()

    def served(key, cfg, on, gen=SEQ_MESH_GEN, **kw):
        model, digest = _build_in_turn(cfg, on, rank)
        torch.cuda.reset_peak_memory_stats()
        name = key if f"{key}_logits" in ref.files else None
        rec[key] = dict(digest=digest, **_mesh_serve(
            model, on, ref[f"{name}_logits" if name else "logits"],
            ref[f"{name}_tokens" if name else "tokens"], gen, **kw))
        rec[key].update(peak_memory_bytes=torch.cuda.max_memory_allocated(),
                        resident_param_bytes=shard.resident_bytes(model),
                        slices_bytes=_slices_bytes(model))
        del model
        _free()

    def trained(key, cfg, prefix):
        model, digest = _build_in_turn(cfg, kv_mesh, rank)
        tr = _train_steps(model, _lm_mesh_train_cfg(SEQ_MESH_ARCH), 1,
                          kv_mesh, rank, grads_of=("wk", "wv"))
        tr["kv_grad_err"] = {
            k: float(np.abs(g - ref[f"{prefix}:{k}"]).max()
                     / np.abs(ref[f"{prefix}:{k}"]).max())
            for k, g in tr.pop("kept").items()}
        rec[key] = dict(digest=digest, **tr)
        del model
        _free()

    saved = tmodel.CACHE_DTYPE
    tmodel.CACHE_DTYPE = torch.float32
    try:
        served("f32_serve", _ssm_cfg(SEQ_MESH_ARCH, SEQ_MESH_LAYERS,
                                     "float32"), kv_mesh)
        trained("f32_train", _ssm_cfg(SEQ_MESH_ARCH, SEQ_MESH_TRAIN_LAYERS,
                                      "float32"), "grad")
        for key, arch, layers in (
                ("zamba2_b1", SSM_MESH_ARCH, SSM_MESH_LAYERS),
                ("xlstm_b1", SSM_MESH_XLSTM, SSM_MESH_XLSTM_LAYERS)):
            served(key, _ssm_cfg(arch, layers, "float32"), mesh,
                   gen=SEQ_MESH_B1_GEN, **SEQ_MESH_B1)
    finally:
        tmodel.CACHE_DTYPE = saved
    served("serve", _ssm_cfg(SEQ_MESH_ARCH, SEQ_MESH_LAYERS), kv_mesh)
    trained("train", _ssm_cfg(SEQ_MESH_ARCH, SEQ_MESH_TRAIN_LAYERS),
            "bf16_grad")
    (d / f"rank{rank}.json").write_text(json.dumps(rec))
    mesh_lib.barrier()
    dist.destroy_process_group()
    return 0


def _seq_checks(one, arrays, recs):
    """What phase 10 (e)'s ranks must meet against the one device: a list
    of the misses."""
    bad = []
    tols, margin = _bf16_tolerances(arrays["logits"],
                                    one["serve"]["bf16_error"])
    own = _own_errors(one["train"], one["f32_train"])
    for r, rec in enumerate(recs):
        for what in ("f32_serve", "zamba2_b1", "xlstm_b1", "serve",
                     "f32_train", "train"):
            if abs(rec[what]["digest"] - one[what]["digest"]) > 1e-9 * abs(
                    one[what]["digest"]):
                bad.append(f"rank {r} built other {what} weights")
        for key in ("f32_serve", "zamba2_b1", "xlstm_b1"):
            bad += _f32_serve_misses(r, key, rec[key], rec[key]["rows"],
                                     arrays[f"{key}_tokens"])
        for key in ("f32_serve", "zamba2_b1", "xlstm_b1", "serve"):
            if rec[key]["resident_param_bytes"] != rec[key]["slices_bytes"]:
                bad.append(f"rank {r} holds {rec[key]['resident_param_bytes']}"
                           f" B of {key}'s parameters, its slices "
                           f"{rec[key]['slices_bytes']}")
        bad += _bf16_serve_misses(r, rec["serve"], rec["serve"]["rows"],
                                  arrays["tokens"], tols, margin)
        bad += _train_misses(r, rec["f32_train"], one["f32_train"],
                             SEQ_MESH_F32_RTOL)
        bad += _train_misses(r, rec["train"], one["train"], own=own)
        for key in ("f32_train", "train"):
            got = rec[key]["resident_bytes"]["params"]
            if got != rec[key]["param_slices_bytes"]:
                bad.append(f"rank {r} holds {got} B of {key}'s parameters, "
                           f"its slices {rec[key]['param_slices_bytes']}")
        for k, err in rec["f32_train"]["kv_grad_err"].items():
            if not err <= TRAIN_GRAD_RTOL:
                bad.append(f"rank {r}: float32 gradient of {k} off by {err} "
                           f"of its largest |g|")
    return (bad + _changed_misses(one["train"], recs)
            + _changed_misses(one["f32_train"], recs, "f32_train"))


def seq_mesh_phase():
    """Phase 10 (e), as the module's docstring says: the one-device runs
    here, then ``LM_MESH_WORLD`` ranks spawned on the one card
    (``seq_mesh_rank``), held against them. Fails on any check, a rank's
    non-zero exit or timeout. One ``seq_mesh`` JSON line."""
    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.time()
    one, arrays = _seq_one_device()
    line = dict(card=card_line(), arch=SEQ_MESH_ARCH,
                kv_mesh=list(SEQ_MESH_KV_SHAPE), mesh=list(LM_MESH_SHAPE),
                layers=SEQ_MESH_LAYERS, train_layers=SEQ_MESH_TRAIN_LAYERS,
                one_device={k: {n: x for n, x in v.items()
                                if n not in ("changed",)}
                            for k, v in one.items()},
                one_device_s=time.time() - t_phase,
                note=f"the {LM_MESH_WORLD}-rank walls are {LM_MESH_WORLD} "
                     f"processes time-sliced on one card over gloo, not a "
                     f"scale-out figure")
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        np.savez(d / "seq.npz", **arrays)
        cmds = [[sys.executable, str(ROOT / "chip_smoke.py"),
                 "--seq-mesh-rank", str(r), "--mesh-dir", str(d)]
                for r in range(LM_MESH_WORLD)]
        t0 = time.perf_counter()
        try:
            outs = mesh_lib.run_ranks(
                cmds, timeout_s=SEQ_MESH_TIMEOUT_S, cwd=str(ROOT),
                env=dict(os.environ,
                         PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
        except (TimeoutError, mesh_lib.RankFailed) as e:
            fail(f"phase 10 (e): {e}")
        line["ranks_wall_ms"] = (time.perf_counter() - t0) * 1e3
        recs = [json.loads((d / f"rank{r}.json").read_text())
                for r in range(LM_MESH_WORLD)]
    bad = _seq_checks(one, arrays, recs)

    def serve_line(key, sv):
        whole = one["f32_serve" if key == "serve" else key]
        return dict(decode_ms_per_token=statistics.median(sv["ms"][1:]
                                                          or sv["ms"]),
                    collectives_per_token=sv["collectives"][-1],
                    bytes_gathered_per_token=sv["gathered"][-1],
                    bytes_reduced_per_token=sv["reduced"][-1],
                    prefill_ms=sv["prefill_ms"],
                    prefill_collectives=sv["prefill_collectives"],
                    prefill_bytes_gathered=sv["prefill_gathered"],
                    prefill_bytes_reduced=sv["prefill_reduced"],
                    logits_max_abs_err=max(sv["err"]),
                    peak_memory_bytes=sv["peak_memory_bytes"],
                    resident_param_share=sv["resident_param_bytes"]
                    / whole["resident_param_bytes"],
                    resident_param_bytes=sv["resident_param_bytes"],
                    slices_bytes=sv["slices_bytes"])

    def train_line(tr):
        return {k: v for k, v in tr.items() if k not in ("changed", "digest")}
    line["ranks"] = [dict(
        rank=rec["rank"], tiny=rec["tiny"], tiny_ms=rec["tiny_ms"],
        **{k: serve_line(k, rec[k]) for k in ("f32_serve", "serve",
                                           "zamba2_b1", "xlstm_b1")},
        **{k: train_line(rec[k]) for k in ("f32_train", "train")})
        for rec in recs]
    line["checks"] = dict(
        f32_logits_max_abs_err={k: max(max(rec[k]["err"]) for rec in recs)
                                for k in ("f32_serve", "zamba2_b1",
                                          "xlstm_b1")},
        bf16_logits_max_abs_err=max(max(rec["serve"]["err"])
                                    for rec in recs),
        bf16_own_error=one["serve"]["bf16_error"],
        f32_train_rel_err={k: max(abs(a - b) / abs(b) for rec in recs
                                  for a, b in zip(rec["f32_train"][k],
                                                  one["f32_train"][k]))
                           for k in ("losses", "grad_norms")},
        f32_next_loss_rel_err=max(
            abs(rec["f32_train"]["next_loss"]
                - one["f32_train"]["next_loss"])
            / abs(one["f32_train"]["next_loss"]) for rec in recs),
        kv_grad_err={w: max(max(rec[w]["kv_grad_err"].values())
                            for rec in recs) for w in ("f32_train", "train")},
        failed=bad)
    line["phase_s"] = time.time() - t_phase
    log(json.dumps({"seq_mesh": line}))
    if bad:
        fail("phase 10 (e): " + "; ".join(bad[:5]))
    return line


def _odd_one_device():
    """Phase 10 (f)'s one-device run on the card, where (d) has not run
    in this process: ``SSM_MESH_ARCH``'s float32 serve and train steps
    on one model from ``SEED``, as (d) makes them. Returns (d)'s record
    and arrays for those keys."""
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import shard
    saved = tmodel.CACHE_DTYPE
    tmodel.CACHE_DTYPE = torch.float32
    try:
        _free()
        model, digest = _build_seeded(_ssm_cfg(SSM_MESH_ARCH,
                                               SSM_MESH_LAYERS, "float32"))
        r, a = _serve_one(model, SSM_MESH_GEN)
        one = dict(f32_serve=dict(
            digest=digest, params=model.num_params(),
            resident_param_bytes=shard.resident_bytes(model), **r))
        one["f32_train"] = dict(digest=digest, **_train_steps(
            model, _lm_mesh_train_cfg(SSM_MESH_ARCH), SSM_MESH_TRAIN_STEPS))
        del model
        _free()
    finally:
        tmodel.CACHE_DTYPE = saved
    return one, {"f32_serve_logits": a["logits"],
                 "f32_serve_tokens": a["tokens"]}


def odd_mesh_rank(rank, mesh_dir):
    """One rank of phase 10 (f): (1) with all ``ODD_MESH_WORLD`` ranks
    as (1, 8), then with the first six as (2, 3) (a group of its own),
    the tiny configs of ``ODD_MESH_TINY`` (``_tiny_mesh_parity``, which
    fails this rank on a miss); (2) on (2, 3), ``SSM_MESH_ARCH``'s
    float32 serve and train steps, the model built in turn from the
    seed, fed the one device's tokens. Writes ``rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import _mesh_slice
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import shard
    from repro_torch.runtime import sharding as shd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dev = "cuda"
    torch.cuda.set_device(0)
    d = Path(mesh_dir)
    rec = dict(rank=rank, tiny={}, tiny_ms={})
    for shape in ODD_MESH_TINY:
        world = shape[0] * shape[1]
        if rank >= world:
            continue
        mesh_lib.init_group("gloo", init_method=f"file://{d}/store{world}",
                            rank=rank, world_size=world, device=dev,
                            timeout_s=LM_MESH_GROUP_TIMEOUT_S)
        mesh = mesh_lib.make_host_mesh(*shape, backend="gloo", device=dev)
        key = f"{shape[0]}x{shape[1]}"
        t0 = time.perf_counter()
        rec["tiny"][key] = [
            _tiny_mesh_parity(a, mesh, heads=h, optimizers=("adamw",),
                              gen=ODD_MESH_TINY_GEN)
            for a, h in ODD_MESH_TINY[shape]]
        rec["tiny_ms"][key] = (time.perf_counter() - t0) * 1e3
        _free()
        if shape != ODD_MESH_FULL:
            mesh_lib.barrier()
            dist.destroy_process_group()
            continue
        ref = np.load(d / "odd.npz")
        rec["rows"] = _mesh_slice(np.arange(SERVE_ARGS["batch"]), mesh,
                                  shd.logits_spec(mesh)[:1]).tolist()
        saved = tmodel.CACHE_DTYPE
        tmodel.CACHE_DTYPE = torch.float32
        try:
            model, digest = _build_in_turn(
                _ssm_cfg(SSM_MESH_ARCH, SSM_MESH_LAYERS, "float32"), mesh,
                rank)
            torch.cuda.reset_peak_memory_stats()
            rec["f32_serve"] = dict(digest=digest, **_mesh_serve(
                model, mesh, ref["f32_serve_logits"],
                ref["f32_serve_tokens"], SSM_MESH_GEN))
            rec["f32_serve"].update(
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                resident_param_bytes=shard.resident_bytes(model),
                slices_bytes=_slices_bytes(model))
            rec["f32_train"] = dict(digest=digest, **_train_steps(
                model, _lm_mesh_train_cfg(SSM_MESH_ARCH),
                SSM_MESH_TRAIN_STEPS, mesh, rank))
            del model
            _free()
        finally:
            tmodel.CACHE_DTYPE = saved
        (d / f"rank{rank}.json").write_text(json.dumps(rec))
        mesh_lib.barrier()
        dist.destroy_process_group()
    if rank >= ODD_MESH_FULL[0] * ODD_MESH_FULL[1]:
        (d / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def _odd_checks(one, arrays, recs):
    """What phase 10 (f)'s (2, 3) ranks must meet against (d)'s float32
    one-device run: a list of the misses."""
    bad = []
    for r, rec in enumerate(recs):
        for what in ("f32_serve", "f32_train"):
            if abs(rec[what]["digest"] - one[what]["digest"]) > 1e-9 * abs(
                    one[what]["digest"]):
                bad.append(f"rank {r} built other {what} weights")
        bad += _f32_serve_misses(r, "f32_serve", rec["f32_serve"],
                                 rec["rows"], arrays["f32_serve_tokens"])
        sv = rec["f32_serve"]
        if not sv["resident_param_bytes"] == sv["slices_bytes"] == \
                4 * ODD_MESH_PARAMS:
            bad.append(f"rank {r} holds {sv['resident_param_bytes']} B of "
                       f"parameters, its slices {sv['slices_bytes']}, the "
                       f"rules {4 * ODD_MESH_PARAMS}")
        bad += _train_misses(r, rec["f32_train"], one["f32_train"],
                             TRAIN_METRIC_RTOL_BY, share=None)
    return bad + _changed_misses(one["f32_train"], recs, "f32_train")


#: phase 10 (d)'s one-device record and arrays, which (f) is held
#: against too (the same model, weights and batches)
_SSM_ONE_DEVICE = {}


def odd_mesh_phase():
    """Phase 10 (f), as the module's docstring says: ``ODD_MESH_WORLD``
    ranks spawned on the one card (``odd_mesh_rank``), the full-width
    model held against (d)'s one-device run (made here when (d) has not
    run). Fails on any check, a rank's non-zero exit or timeout. One
    ``odd_mesh`` JSON line."""
    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.time()
    one, arrays = _SSM_ONE_DEVICE.get("ssm") or _odd_one_device()
    full = ODD_MESH_FULL[0] * ODD_MESH_FULL[1]
    line = dict(card=card_line(), arch=SSM_MESH_ARCH,
                layers=SSM_MESH_LAYERS, full_mesh=list(ODD_MESH_FULL),
                tiny={f"{a}x{b}": [f"{c}{'' if h is None else f' ({h} heads)'}"
                                   for c, h in v]
                      for (a, b), v in ODD_MESH_TINY.items()},
                one_device_s=time.time() - t_phase,
                reckoned=_moe_reckon(_ssm_cfg(SSM_MESH_ARCH,
                                              SSM_MESH_LAYERS), 4,
                                     ODD_MESH_FULL),
                note=f"the walls are {ODD_MESH_WORLD} and then {full} "
                     f"processes time-sliced on one card over gloo, not a "
                     f"scale-out figure")
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        np.savez(d / "odd.npz", **{k: arrays[k] for k in (
            "f32_serve_logits", "f32_serve_tokens")})
        cmds = [[sys.executable, str(ROOT / "chip_smoke.py"),
                 "--odd-mesh-rank", str(r), "--mesh-dir", str(d)]
                for r in range(ODD_MESH_WORLD)]
        t0 = time.perf_counter()
        try:
            outs = mesh_lib.run_ranks(
                cmds, timeout_s=ODD_MESH_TIMEOUT_S, cwd=str(ROOT),
                env=dict(os.environ,
                         PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
        except (TimeoutError, mesh_lib.RankFailed) as e:
            fail(f"phase 10 (f): {e}")
        line["ranks_wall_ms"] = (time.perf_counter() - t0) * 1e3
        line["rank_memory"] = [[m for m in err.splitlines()
                                if m.startswith("memory")][-1:]
                               for _, _, err in outs[:full]]
        recs = [json.loads((d / f"rank{r}.json").read_text())
                for r in range(ODD_MESH_WORLD)]
    bad = _odd_checks(one, arrays, recs[:full])
    tr1 = one["f32_train"]

    def train_line(tr):
        return {k: v for k, v in tr.items() if k not in ("changed", "digest")}
    line["ranks"] = [dict(
        rank=rec["rank"], tiny=rec["tiny"], tiny_ms=rec["tiny_ms"],
        **({} if "f32_serve" not in rec else dict(
            f32_serve=dict(
                decode_ms_per_token=statistics.median(
                    rec["f32_serve"]["ms"][1:] or rec["f32_serve"]["ms"]),
                collectives_per_token=rec["f32_serve"]["collectives"][-1],
                bytes_gathered_per_token=rec["f32_serve"]["gathered"][-1],
                bytes_reduced_per_token=rec["f32_serve"]["reduced"][-1],
                prefill_ms=rec["f32_serve"]["prefill_ms"],
                logits_max_abs_err=max(rec["f32_serve"]["err"]),
                peak_memory_bytes=rec["f32_serve"]["peak_memory_bytes"],
                resident_param_bytes=rec["f32_serve"][
                    "resident_param_bytes"],
                slices_bytes=rec["f32_serve"]["slices_bytes"],
                rules_bytes=4 * ODD_MESH_PARAMS,
                resident_param_share=rec["f32_serve"][
                    "resident_param_bytes"]
                / one["f32_serve"]["resident_param_bytes"]),
            f32_train=train_line(rec["f32_train"]),
            resident_share={k: v / tr1["resident_bytes"][k] for k, v in
                            rec["f32_train"]["resident_bytes"].items()})))
        for rec in recs]
    line["checks"] = dict(
        f32_logits_max_abs_err=max(max(rec["f32_serve"]["err"])
                                   for rec in recs[:full]),
        f32_train_rel_err={k: max(abs(a - b) / abs(b) for rec in recs[:full]
                                  for a, b in zip(rec["f32_train"][k],
                                                  tr1[k]))
                           for k in ("losses", "grad_norms")},
        f32_next_loss_rel_err=max(
            abs(rec["f32_train"]["next_loss"] - tr1["next_loss"])
            / abs(tr1["next_loss"]) for rec in recs[:full]),
        tiny_serve_logits_max_abs_err={
            k: max(t["serve_logits_max_abs_err"] for rec in recs
                   for t in rec["tiny"].get(k, ())) for k in line["tiny"]},
        failed=bad)
    line["phase_s"] = time.time() - t_phase
    log(json.dumps({"odd_mesh": line}))
    if bad:
        fail("phase 10 (f): " + "; ".join(bad[:5]))
    return line


# ---------------------------------------------------------------------------
# phase 11: the last entry points (the examples and the dry run)
# ---------------------------------------------------------------------------

#: the dry run's cells on the card: the matcher's share of rank 0 of 256
#: on the single-pod mesh, and one LM cell on ``meta``
DRYRUN_MESH = "pod-16x16"
DRYRUN_LM = ("qwen2.5-3b", "decode_32k")
#: what the dry-run subprocess may take, its start included
DRYRUN_TIMEOUT_S = 240
#: the quantized main-path kernels the matcher cell must launch
DRYRUN_KERNELS = ("prune_fixpoint", "edge_fitness_quantized", "epoch_fused",
                  "epoch_finish")
#: S̄, the elite consensus, is a float sum whose order the kernel
#: (``epoch_finish``) and its plain version choose apart; every other
#: leaf of the matcher cell is held bit for bit
DRYRUN_SBAR_ATOL = 1e-6
#: the float main-path kernels the examples' float swarms must launch
ENTRY_KERNELS = ("prune_fixpoint", "edge_fitness", FLOAT_EPOCH,
                 "epoch_finish")


def _sim_dict(r):
    """A ``SimResult`` as a dict without its host wall clocks."""
    d = dataclasses.asdict(r)
    d["matcher_stats"] = {k: v for k, v in d["matcher_stats"].items()
                          if not k.endswith("wall_s")
                          and k not in ("fe_wait_s",)}
    return d


def _example(mod, counters, argv):
    """``mod.main(argv)`` with its printout captured: (its return, the
    printout, wall ms, the launches it made)."""
    import io
    for c in counters.values():
        c.reset()
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, buf.getvalue(), ms, split_float(
        {k: c.count for k, c in counters.items()})


def _matcher_parity(got, want):
    """The matcher cell through the ``cuda`` suite (``got``) against the
    ``ref`` suite (``want``): the leaves that differ (S̄ beyond
    ``DRYRUN_SBAR_ATOL``), S̄'s largest difference, and the ``ref``
    run's launches, which must be none."""
    a, b = got.pop("outputs"), want.pop("outputs")
    differ = sorted(k for k in set(a) | set(b) if k != "S_bar" and (
        k not in a or k not in b or (
            not torch.equal(a[k], b[k]) if torch.is_tensor(a[k])
            else a[k] != b[k])))
    err = (a["S_bar"].float() - b["S_bar"].float()).abs().max().item()
    if err > DRYRUN_SBAR_ATOL:
        differ.append("S_bar")
    return dict(differ=differ, s_bar_max_abs_err=err,
                epochs_run=[got["epochs_run"], want["epochs_run"]],
                launches=sum(got["launches"].values()),
                ref_launches=sum(want["launches"].values()))


def dryrun_rank(mesh_dir):
    """Phase 11 (b) and (c), in a process of their own so that the fake
    group never meets phases 4e's and 10's groups: rank 0 of a fake group
    of 256 runs the dry run's matcher cell on the card and one LM cell
    on ``meta``. Writes ``dryrun.json`` into ``mesh_dir``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import arch_shapes
    from repro_torch.core.pso import PSOConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    arch, shape = DRYRUN_LM
    torch.backends.cuda.matmul.allow_tf32 = False
    with mesh_lib.fake_group(256):
        matcher_mesh = mesh_lib.make_production_mesh(device="cuda")
        cell = dryrun.run_cell(dryrun.MATCHER, "matcher_128x128", None,
                               DRYRUN_MESH, matcher_mesh, "cuda")
        torch.cuda.synchronize()
        # the same call through the plain versions, on the same streams
        if cell["ok"]:
            cfg = PSOConfig(num_particles=32, epochs=4, inner_steps=12,
                            quantized=True)
            got = dryrun.run_matcher(matcher_mesh, "cuda", cfg=cfg,
                                     outputs=True)
            want = dryrun.run_matcher(matcher_mesh, "cuda",
                                      cfg=cfg.replace(backend="ref"),
                                      outputs=True)
            cell["ref_parity"] = _matcher_parity(got, want)
        mesh = mesh_lib.make_production_mesh(device="cpu")
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lm = dryrun.run_cell(arch, next(s for s in arch_shapes(arch)
                                        if s.name == shape), mesh,
                             DRYRUN_MESH)
        lm["device_bytes_allocated"] = \
            torch.cuda.max_memory_allocated() - before
    props = torch.cuda.get_device_properties(0)
    (Path(mesh_dir) / "dryrun.json").write_text(json.dumps(dict(
        matcher=cell, lm=lm, total_memory=props.total_memory,
        fake_backend=True)))
    return 0


def entry_phase(counters):
    """Phase 11, as the module's docstring says. One ``entry`` JSON
    line; fails on any check."""
    from repro_torch.core import ilp
    from repro_torch.examples import (interruptible_serving,
                                      online_service, schedule_multi_dnn)
    from repro_torch.kernels import backend
    t_phase = time.time()
    bad, line, launches = [], dict(card=card_line()), {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # (a) the three examples on the card at their defaults
    recs, text, ms, n = _example(online_service, counters,
                                 ["--device", "cuda"])
    add(n)
    for r in recs:
        ok = r["mapping"] is not None and feasible_np(
            r["mapping"], r["query"].adj, r["target"].adj)
        if ok != r["found"]:
            bad.append(f"online_service: {r['name']} found={r['found']} "
                       f"but its mapping feasible={ok}")
    if sum(("(infeasible)" in l) for l in text.splitlines()) != \
            sum(not r["found"] for r in recs):
        bad.append("online_service: the infeasible arrivals are not the "
                   "ones reported as infeasible")
    line["online_service"] = dict(
        wall_ms=ms, launches=n, arrivals=len(recs),
        found=sum(r["found"] for r in recs),
        warm=sum(r["warm"] for r in recs),
        compiled=sum(r["compiled"] for r in recs),
        summary=text.strip().splitlines()[-1])
    # the same arrivals through the plain versions, on the same draws
    saved = os.environ.get(backend.ENV_VAR)
    os.environ[backend.ENV_VAR] = "ref"
    try:
        plain, _, plain_ms, pn = _example(online_service, counters,
                                          ["--device", "cuda"])
    finally:
        if saved is None:
            os.environ.pop(backend.ENV_VAR)
        else:
            os.environ[backend.ENV_VAR] = saved
    keys = ("bucket", "compiled", "warm", "epochs", "found")
    differ = [r["name"] + f" #{i}" for i, (r, p) in enumerate(
        zip(recs, plain)) if any(r[k] != p[k] for k in keys)
        or (r["mapping"] is None) != (p["mapping"] is None)
        or (r["mapping"] is not None
            and not np.array_equal(r["mapping"], p["mapping"]))]
    if len(plain) != len(recs) or differ or sum(pn.values()):
        bad.append(f"online_service: the ref suite served {differ} "
                   f"otherwise than the cuda suite, launching "
                   f"{sum(pn.values())} kernels")
    line["online_service"].update(ref_wall_ms=plain_ms,
                                  ref_differ=differ)

    res, text, ms, n = _example(interruptible_serving, counters,
                                ["--device", "cuda"])
    add(n)
    cpu, _, _, _ = _example(interruptible_serving, counters,
                            ["--device", "cpu"])
    imm = res["immsched"]
    if imm.urgent_total < 1 or imm.urgent_met != imm.urgent_total:
        bad.append(f"interruptible_serving: IMMSched met "
                   f"{imm.urgent_met}/{imm.urgent_total} urgent deadlines")
    for name in ("isosched", "moca"):
        if _sim_dict(res[name]) != _sim_dict(cpu[name]):
            bad.append(f"interruptible_serving: {name} on the card differs "
                       f"from its CPU run")
    line["interruptible_serving"] = dict(
        wall_ms=ms, launches=n,
        rows={k: dict(urgent_met=r.urgent_met, urgent_total=r.urgent_total,
                      avg_total_latency=r.avg_total_latency,
                      avg_sched_time=r.avg_sched_time)
              for k, r in res.items()})

    (pdag, match, st), text, ms, n = _example(schedule_multi_dnn, counters,
                                              ["--device", "cuda"])
    add(n)
    errs = ilp.validate_schedule(st, pdag)
    if not match.found or errs:
        bad.append(f"schedule_multi_dnn: found={match.found}, ILP "
                   f"violations {errs}")
    line["schedule_multi_dnn"] = dict(
        wall_ms=ms, launches=n, tiles=pdag.n, found=bool(match.found),
        feasible_count=int(match.feasible_count), violations=len(errs))
    for k in ENTRY_KERNELS:
        if launches.get(k, 0) <= 0:
            bad.append(f"the examples launched no {k}")

    # (b), (c): the dry run in a process of its own
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--dryrun-rank", "0", "--mesh-dir", d], cwd=str(ROOT),
                capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"phase 11: the dry run took over {DRYRUN_TIMEOUT_S} s")
        if proc.returncode:
            fail(f"phase 11: the dry run exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        dry = json.loads((Path(d) / "dryrun.json").read_text())
        line["dryrun_wall_ms"] = (time.perf_counter() - t0) * 1e3
    cell, lm = dry["matcher"], dry["lm"]
    for rec in (cell, lm):
        if not rec["ok"]:
            bad.append(f"dry run {rec['arch']} {rec['shape']}: "
                       f"{rec.get('error')}")
    if cell["ok"]:
        for k in DRYRUN_KERNELS:
            if cell["launches"].get(k, 0) <= 0:
                bad.append(f"the dry run's matcher cell launched no {k}")
        par = cell["ref_parity"]
        if par["differ"] or par["ref_launches"] or not par["launches"] \
                or par["epochs_run"][0] != cell["epochs_run"]:
            bad.append(f"the matcher cell through the cuda suite against "
                       f"the ref suite: {par}")
        add(split_float({k: cell["launches"].get(k, 0) for k in counters}))
    if lm["ok"]:
        if lm["device_bytes_allocated"]:
            bad.append(f"the LM cell allocated "
                       f"{lm['device_bytes_allocated']} B on the card")
        if lm["memory"]["peak_bytes"] > dry["total_memory"]:
            bad.append("the LM cell's peak is over the card's memory")
    line["dryrun"] = dict(
        total_memory=dry["total_memory"],
        matcher={k: cell.get(k) for k in (
            "ok", "mesh", "wall_s", "epochs_run", "shards",
            "mappings_shape", "launches", "collectives", "memory",
            "ref_parity")},
        lm={k: lm.get(k) for k in (
            "ok", "arch", "shape", "mesh", "wall_s", "memory", "flops",
            "model_flops", "collectives", "params_bytes",
            "device_bytes_allocated")})
    line["launches"] = launches
    line["phase_s"] = time.time() - t_phase
    line["failed"] = bad
    log(json.dumps({"entry": line}))
    if bad:
        fail("phase 11: " + "; ".join(bad[:5]))
    return line


#: spin kernels that open each profiler session (``profiled``)
PROFILE_WARMUP = 8


def profiled(fn, cpu=True):
    """Run ``fn()`` once under the profiler, synchronized. Returns
    ``(profile, wall ms, [(device event, ms, count)] by time)``: the
    device-side events only (kernels, copies), since an aten op's device
    time repeats that of the kernels it launched. ``cpu=False`` records
    the card's activity alone: a run of many torch ops then costs seconds
    to summarise, not tens of seconds. A session can lose its first few
    device events (on the H100 machine a profiled single call of
    ``prune_fixpoint`` once showed none), so each starts with
    ``PROFILE_WARMUP`` spin kernels, synchronized and left out of the
    rows."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        for _ in range(PROFILE_WARMUP):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = []
    for ev in prof.key_averages():
        if (not str(getattr(ev, "device_type", "")).endswith("CUDA")
                or "spin_kernel" in ev.key):
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((ev.key, dev / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return prof, wall * 1e3, rows


def profile_burst(pso, Qb, Gb, Mb, cfg, out_dir):
    """Device time by kernel over one ``match_batch`` of the burst, and
    the device's busy share of the synchronized wall time."""
    seeds = [SEED + 100 + b for b in range(Mb.shape[0])]
    prof, wall_ms, rows = profiled(
        lambda: pso.match_batch(Qb, Gb, Mb, cfg, streams=seeds))
    busy_ms = sum(r[1] for r in rows)
    if out_dir is not None:
        (out_dir / "profile.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40))
    return dict(summary=dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / max(wall_ms, 1e-9),
        top=[dict(kernel=k[:60], ms=ms, calls=c) for k, ms, c in rows[:8]]))


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the detailed JSON and profile")
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase 4e's ranks
    ap.add_argument("--mesh-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--lm-mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase 10 (b)'s ranks
    ap.add_argument("--moe-mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase 10 (c)'s ranks
    ap.add_argument("--ssm-mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase 10 (d)'s ranks
    ap.add_argument("--seq-mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase 10 (e)'s ranks
    ap.add_argument("--odd-mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase 10 (f)'s ranks
    ap.add_argument("--dryrun-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase 11 (b), (c)
    args = ap.parse_args()
    out_dir = args.out
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.mesh_rank is not None:
        return mesh_rank(args.mesh_rank, args.mesh_dir)
    if args.lm_mesh_rank is not None:
        return lm_mesh_rank(args.lm_mesh_rank, args.mesh_dir)
    if args.moe_mesh_rank is not None:
        return moe_mesh_rank(args.moe_mesh_rank, args.mesh_dir)
    if args.ssm_mesh_rank is not None:
        return ssm_mesh_rank(args.ssm_mesh_rank, args.mesh_dir)
    if args.seq_mesh_rank is not None:
        return seq_mesh_rank(args.seq_mesh_rank, args.mesh_dir)
    if args.odd_mesh_rank is not None:
        return odd_mesh_rank(args.odd_mesh_rank, args.mesh_dir)
    if args.dryrun_rank is not None:
        return dryrun_rank(args.mesh_dir)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import pso
    from repro_torch.core.matcher import (IMMSchedMatcher,
                                          collect_batch_results)
    from repro_torch.kernels import (_build, cases, pso_fitness, ref,
                                     ullmann_refine)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    t_all = time.time()
    detail = {}

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    detail["card"] = card

    # 2. build
    t0 = time.time()
    reports = _build.build_all()
    detail["build_s"] = time.time() - t0
    log(f"build: {len(reports)} libraries compiled in "
        f"{detail['build_s']:.2f} s")
    for name, rep in reports.items():
        regs = [l.strip() for l in rep.splitlines() if "registers" in l]
        log(f"  {name}: {'; '.join(regs)}")

    # 3. kernels against their plain versions at the main path's shapes
    reqs, tgt, bucket, Qb, Gb, Mb = build_requests()
    P, n, m = Mb.shape
    log(f"requests: {[(r['name'], r['q'].n) for r in reqs]} target "
        f"{tgt.n} engines, bucket {bucket}")
    if bucket != (56, 144):
        fail(f"bucket {bucket} is not the main path's (56, 144)")
    elite_k = pso.elite_k_for(pso.PSOConfig())
    x = cases.swarm_inputs(Qb, Gb, Mb, N, K, seed=SEED)
    errs = {k: 0.0 for k in (*KERNELS, FLOAT_EPOCH)}
    timed = {}
    for quantized, tau in ((True, 0.0), (False, 0.0), (True, 0.3),
                           (False, 0.3)):
        pairs = cases.kernel_pairs(Qb, Gb, Mb, x, quantized=quantized,
                                   gumbel_tau=tau, elite_k=elite_k)
        for name, (kern, plain) in pairs.items():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            key = (FLOAT_EPOCH if name == "epoch_fused" and not quantized
                   else name)
            try:
                errs[key] = max(errs[key], cases.compare(got, want))
            except AssertionError as e:
                fail(f"{name} (quantized={quantized}, tau={tau}) "
                     f"disagrees with its plain version: {e}")
            if name in BITWISE and not all(
                    torch.equal(g, w)
                    for g, w in zip(_outs(got), _outs(want))):
                fail(f"{name} (quantized={quantized}, tau={tau}) is not "
                     f"bit for bit its plain version")
            log(f"  {name} quantized={quantized} tau={tau}: agrees "
                f"(max abs err {errs[key]:.3g})")
            if tau == 0.0 and (quantized or key == FLOAT_EPOCH):
                timed[key] = (kern, plain, got)   # the main path's modes
    # the float fitness where its tiles live in device scratch
    lP, lN, ln, lm = FITNESS_LARGE
    lQ, lG, lmask = (t.cuda() for t in cases.random_problem(lP, ln, lm,
                                                             SEED))
    lS = cases.swarm_inputs(lQ, lG, lmask, lN, 1, seed=SEED)["S"]
    got = pso_fitness.edge_fitness_cuda(lS, lQ, lG)
    torch.cuda.synchronize()
    if not torch.equal(got, pso_fitness.edge_fitness_reference(lS, lQ, lG)):
        fail(f"edge_fitness at {FITNESS_LARGE} is not bit for bit its "
             f"plain version")
    log(f"  edge_fitness at {FITNESS_LARGE} (tiles in device scratch): "
        f"bit for bit")
    detail["narrow_sbar_planted"] = narrow_sbar_planted(elite_k)
    # ullmann_refine_step for every M dtype (entries 0..3 kept as they
    # are), at the main path's shape and at REFINE_EXTRA
    gen = torch.Generator().manual_seed(SEED)
    for B, rn, rm in ((N, n, m), *REFINE_EXTRA):
        vals = torch.randint(0, 4, (B, rn, rm), generator=gen) * (
            torch.rand(B, rn, rm, generator=gen) < 0.6)
        rQ = torch.triu(torch.rand(rn, rn, generator=gen) < 3.0 / rn,
                        1).to(torch.uint8).cuda()
        rG = torch.triu(torch.rand(rm, rm, generator=gen) < 4.0 / rm,
                        1).to(torch.uint8).cuda()
        for dt in (torch.uint8, torch.int32, torch.bool):
            rM = ((vals != 0) if dt == torch.bool else vals.to(dt)).cuda()
            got = ullmann_refine.ullmann_refine_step_cuda(rM, rQ, rG)
            torch.cuda.synchronize()
            if not torch.equal(got, ref.ullmann_refine_step(rM, rQ, rG)):
                fail(f"ullmann_refine_step at {(B, rn, rm)}, M {dt}, is not "
                     f"bit for bit its plain version")
        log(f"  ullmann_refine_step at {(B, rn, rm)}, M uint8 / int32 / "
            f"bool: bit for bit")
    # the five main-path kernels past n, m = 256
    detail["wide_kernels"] = wide_kernel_cases(elite_k)
    detail["wide_fitness"] = wide_fitness_cases()
    outs = {k: v[2] for k, v in timed.items()}
    bounds = kernel_bounds(Qb, Gb, Mb, x, outs, quantized=True,
                           elite_k=elite_k)
    bounds[FLOAT_EPOCH] = kernel_bounds(
        Qb, Gb, Mb, x, {**outs, "epoch_fused": outs[FLOAT_EPOCH]},
        quantized=False, elite_k=elite_k)["epoch_fused"]
    # one PyTorch call pair for the masked argmax: where, then argmax
    keep = Mb != 0
    neg = torch.full_like(x["S_star"], torch.finfo(torch.float32).min)

    def library_argmax():
        return [torch.argmax(torch.where(keep[p], x["S_star"][p],
                                         neg[p]).reshape(-1))
                for p in range(P)]
    library = {"masked_argmax": library_argmax}
    records = {}
    for name, (kern, plain, _) in timed.items():
        calls = P if name in cases.PER_PROBLEM else 1   # ms per call
        # the median of 5 runs of 10 calls; a library call pair is timed
        # in turns with the kernel, so that both see the same host
        runs = {}
        for _ in range(5):
            for key, fn in (("ms", kern), ("library_ms", library.get(name))):
                if fn is not None:
                    runs.setdefault(key, []).append(
                        cuda_ms(fn, reps=10, warm=2) / calls)
        ms = statistics.median(runs["ms"])
        plain_ms = cuda_ms(plain, reps=2, warm=1) / calls
        bms, by = bounds[name]
        # device time alone (kernels and the wrapper's copies): where it is
        # far below ms, the host's dispatch sets the pace
        device_ms = sum(r[1] for r in profiled(kern)[2]) / calls
        records[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=(statistics.median(runs["library_ms"])
                        if name in library else None),
            device_ms=device_ms)
        if name in library:
            records[name]["library_device_ms"] = sum(
                r[1] for r in profiled(library[name])[2]) / calls
    records["pso_update"]["host_ms"] = pso_update_host_ms(x, Mb)
    for name, rec in records.items():
        log(json.dumps(dict(kernel=name, **rec, max_abs_err=errs[name])))

    # 4. the main path
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    cfg = pso.PSOConfig(quantized=True, early_exit=True)
    torch.cuda.synchronize()
    t0 = time.time()
    outs = pso.match_batch(Qb, Gb, Mb, cfg,
                           streams=[SEED + b for b in range(P)])
    torch.cuda.synchronize()
    t_match = time.time() - t0
    results = collect_batch_results(
        outs, P, orders=[r["order"] for r in reqs],
        crops=[(r["q"].n, tgt.n) for r in reqs])
    found = 0
    for r, res, b in zip(reqs, results, range(P)):
        if res.found:
            found += 1
            q_orig = r["q"].adj[np.ix_(np.argsort(r["order"]),
                                      np.argsort(r["order"]))]
            if not feasible_np(res.mapping, q_orig, tgt.adj):
                fail(f"{r['name']}: found mapping is infeasible")
        log(f"  {r['name']:13s} n={r['q'].n:3d} found={res.found} "
            f"epochs_run={res.epochs_run} prune_sweeps={res.prune_sweeps}")
    log(f"match_batch: {found}/{P} found, host_syncs={outs['host_syncs']}, "
        f"wall {t_match * 1e3:.1f} ms ({t_match * 1e3 / P:.1f} ms "
        f"per decision)")
    carry = (outs["S_star"], outs["f_star"], outs["S_bar"])
    torch.cuda.synchronize()
    t0 = time.time()
    rv = pso.revalidate_batch(Qb, Gb, Mb, cfg, carry)
    torch.cuda.synchronize()
    t_reval = time.time() - t0
    ok = rv["ok"].cpu().numpy()
    for b in np.where(ok)[0]:
        if not feasible_np(rv["mapping"][b].cpu().numpy(),
                           Qb[b].cpu().numpy(), Gb[b].cpu().numpy()):
            fail(f"revalidated hit {b} is infeasible")
    log(f"revalidate_batch (Tier 0): {int(ok.sum())}/{P} hits, wall "
        f"{t_reval * 1e3:.1f} ms")
    fcfg = pso.PSOConfig()
    unet = reqs[WORKLOADS.index("unet")]
    torch.cuda.synchronize()
    t0 = time.time()
    res = IMMSchedMatcher(fcfg).match(unet["q"], tgt, stream=SEED)
    torch.cuda.synchronize()
    t_single = time.time() - t0
    if res.found and not feasible_np(res.mapping, unet["q"].adj, tgt.adj):
        fail("float-config match returned an infeasible mapping")
    log(f"IMMSchedMatcher.match (float, unet): found={res.found} "
        f"epochs_run={res.epochs_run} prune_sweeps={res.prune_sweeps} "
        f"wall {t_single * 1e3:.1f} ms")
    launches = split_float({k: counters[k].count
                            for k in (*MAIN_KERNELS, FLOAT_EPOCH)})
    main_calls = split_float({k: counters[k].calls
                              for k in (*MAIN_KERNELS, FLOAT_EPOCH)})
    log(f"launches on the main path: {launches} in wrapper calls "
        f"{main_calls}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main path")
    if found == 0:
        fail("the main path found no mapping at all")
    phase4 = dict(outs=outs, rv=rv, results=results)
    detail["main_path"] = dict(
        found=found, epochs_run=[r.epochs_run for r in results],
        prune_sweeps=[r.prune_sweeps for r in results],
        host_syncs=outs["host_syncs"], match_batch_s=t_match,
        revalidate_s=t_reval, reval_hits=int(ok.sum()),
        single_match_s=t_single, single_found=res.found,
        launches=launches, calls=main_calls)

    # 4b. the matcher service: its drains at the burst's full width, with
    # a persist directory for phase 4d's snapshot
    persist = tempfile.TemporaryDirectory()
    detail["service"] = service_phase(pso, reqs, counters, out_dir,
                                      persist.name)
    service_launches = detail["service"]["launches"]
    svc = detail["service"].pop("service")
    all_warm = detail["service"].pop("all_warm")

    # 4c. the scheduler: a real-mode simulation through the service
    detail["sched"] = sched_phase(pso, counters)
    sched_launches = detail["sched"]["launches"]

    # 4d. warm restarts: a snapshot of 4b's service restored into a fresh
    # one, and the scheduler's restart scenario cold and warm
    detail["restart"] = restart_phase(pso, reqs, svc, all_warm, counters,
                                      persist.name)
    restart_launches = detail["restart"]["launches"]
    del svc
    persist.cleanup()

    # 4e. the mesh: a world of one over NCCL and gloo in this process,
    # then MESH_WORLD ranks on the one card
    detail["mesh"] = mesh_phase(pso, reqs, tgt, bucket, Qb, Gb, Mb, phase4,
                                counters)
    mesh_launches = detail["mesh"]["launches"]
    del phase4

    # 4f. past n, m = 256: a drain of the complex workloads mapped whole
    # on a 512-engine platform, and the scheduler on it
    detail["wide"] = wide_phase(pso, counters)
    wide_launches = split_float({**detail["wide"]["launches"],
                                 **{k: 0 for k in KERNELS
                                    if k not in MAIN_KERNELS}})
    wide_bucket = detail["wide"]["bucket"]["kernels"]

    # 5. the split (pre-fusion) epoch against the fused one, on the burst
    # and on phase 4f's problem at WIDE_BUCKET
    detail["split_epoch"] = split_phase(pso, Qb, Gb, Mb, x, counters)
    split_launches = detail["split_epoch"]["launches"]
    tgt_w, _, reqs_w = wide_requests()
    name_w, *wide_problem = wide_bucket_problem(tgt_w, reqs_w)
    split_wide = split_phase(pso, *wide_problem, counters)
    four = bucket_kernels(*wide_problem, cases.PER_PROBLEM, name_w)
    for k, rec in four.items():
        rec["launches"] = split_wide["launches"][k]
    split_wide["bucket_kernels"] = four
    detail["split_epoch_wide"] = split_wide
    wide_bucket.update(four)
    log(json.dumps({"wide_bucket_split": dict(bucket=list(WIDE_BUCKET),
                                              problem=name_w,
                                              kernels=four)}))
    del tgt_w, reqs_w, wide_problem
    torch.cuda.empty_cache()

    # 6. path parity: cuda suite against ref suite, same draws
    small = pso.PSOConfig(num_particles=16, epochs=1, inner_steps=4,
                          quantized=True)
    d = {"init": torch.rand((1, P, 16, n, m), device="cuda") * 0.95 + 0.05,
         "steps": torch.rand((1, P, 4, 16, 3), device="cuda")}
    oc = pso.match_batch(Qb, Gb, Mb, small.replace(backend="cuda"), draws=d)
    orf = pso.match_batch(Qb, Gb, Mb, small.replace(backend="ref"), draws=d)
    for k in ("mappings", "feasible", "prune_sweeps", "epochs_run"):
        if not torch.equal(oc[k], orf[k]):
            fail(f"path parity: {k} differs between cuda and ref suites")
    torch.testing.assert_close(oc["f_star"], orf["f_star"], rtol=1e-5,
                               atol=1e-4)
    log("path parity: cuda suite == ref suite on the same draws")

    # 7. where the burst's time goes: one match_batch under the profiler
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    detail["profile"] = profile_burst(pso, Qb, Gb, Mb, cfg, out_dir)
    log(f"profile: {json.dumps(detail['profile']['summary'])}")

    # 8. the LM serve path: the card against the CPU, then qwen1.5-0.5b at
    # its published size and two models at full width
    card_now = card_line()
    detail["serve"] = dict(card=card_now, **serve_phase())
    log(json.dumps({"serve": detail["serve"]}))

    # 9. the LM training path: card against CPU, qwen1.5-0.5b through the
    # launcher with a resume, the giants' policy at full width, int8
    # compression over NCCL
    detail["train"] = dict(card=card_line(), **train_phase())
    log(json.dumps({"train": detail["train"]}))

    # 10. the sharded LM path: a world of one over NCCL, then four ranks
    # on a (2, 2) mesh with qwen1.5-0.5b at full width, then the MoE
    # family there (tiny, and deepseek-v2-236b at full width), then the
    # ssm, hybrid and encdec families (tiny, zamba2-7b and xlstm-1.3b at
    # full width), then sequence-sharded caches and batches (tiny,
    # qwen2.5-3b's 2 KV heads on a model axis of 4, zamba2-7b and
    # xlstm-1.3b at a batch of 1), then model axes that do not divide
    # MLA's or Mamba2's heads (tiny on (1, 8) and (2, 3), zamba2-7b at
    # full width on (2, 3))
    detail["lm_mesh"] = lm_mesh_phase()
    detail["moe_mesh"] = moe_mesh_phase()
    detail["ssm_mesh"] = ssm_mesh_phase()
    detail["seq_mesh"] = seq_mesh_phase()
    detail["odd_mesh"] = odd_mesh_phase()

    # 11. the last entry points: the three scheduling examples on the
    # card, then the dry run's matcher cell and one LM cell on meta
    detail["entry"] = entry_phase(counters)
    entry_launches = detail["entry"]["launches"]

    kern = []
    split_calls = detail["split_epoch"]["calls"]
    rows = [(k, *v) for k, v in KERNELS.items()]
    rows.insert(4, (FLOAT_EPOCH, *KERNELS["epoch_fused"]))
    for name, src, replaces in rows:
        rec = records[name]
        detail.setdefault("device_ms", {})[name] = rec["device_ms"]
        n_launch = launches.get(name, split_launches.get(name))
        n_calls = main_calls.get(name, split_calls.get(name))
        kern.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=n_launch,
                         service_launches=service_launches.get(name),
                         sched_launches=sched_launches.get(name),
                         restart_launches=restart_launches.get(name),
                         mesh_launches=mesh_launches.get(name),
                         entry_launches=entry_launches.get(name),
                         wide_launches=wide_launches.get(name),
                         launches_per_call=(n_launch / n_calls
                                            if n_calls else None),
                         max_abs_err=errs[name], ms=rec["ms"],
                         plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                         bound_by=rec["bound_by"],
                         library_ms=rec["library_ms"],
                         device_ms=rec["device_ms"],
                         **({"host_ms": rec["host_ms"]} if "host_ms" in rec
                            else {}),
                         **({"bound_note": BOUND_NOTES[name]}
                            if name in BOUND_NOTES else {}),
                         **({"wide_bucket": dict(bucket=list(WIDE_BUCKET),
                                                 **wide_bucket[name])}
                            if name in wide_bucket else {})))
    detail["kernels"] = kern
    detail["total_s"] = time.time() - t_all
    if out_dir is not None:
        (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log(f"total {detail['total_s']:.1f} s")
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
