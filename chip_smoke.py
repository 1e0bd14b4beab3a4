#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel to its plain PyTorch version on the card, times them, serves
full-width gemma3-1b (random weights from a seed) through
``ContinuousEngine`` and the legacy ``ServeEngine``, serves full-width
mamba2-370m through ``ContinuousEngine``, trains the paper's CNN6 and then
full-width, full-depth gemma3-1b with synchronous WASGD+ through
``Trainer.run``, runs the paper's baseline rules and a checkpoint round
trip on CNN6, swaps the trained gemma3-1b consensus into a running engine
and evaluates it, trains CNN6 and gemma3-1b with Alg. 4 straggler rounds
(the masked ``wagg_fused``) and CNN6 with elastic membership, trains
full-width, full-depth stablelm-3b with the int4 payload and ``remat``,
serves full-width yi-6b, trains full-width, full-depth mamba2-370m
(ssd_chunk in the training forward) and olmoe-1b-7b (one copy of the
experts), serves olmoe-1b-7b and one full-width period of jamba-v0.1-52b,
serves full-width llama-3.2-vision-11b (with media) and musicgen-large
(codebooks) through the legacy ``ServeEngine``, trains musicgen-large and
one full-width period of llama-3.2-vision-11b, runs CNN6 and gemma3-1b
through the pipelined round (bitwise the unpipelined one), records
telemetry from every producer, runs the mesh schedules of decentralized
WASGD on a one-rank NCCL group (CNN6 and gemma3-1b) with the baseline
rules, elastic resizes and a sharded checkpoint under it, runs the
training launcher on gemma3-1b, holds the dry run's prediction of the
gemma3-1b round (a meta-device trace) to the measured round, and checks
that the served and the trained paths went through their kernels.
Prints one JSON object per phase:

  env           card, power limit, torch/CUDA versions, build time, ptxas
                (registers, shared memory, spills), ssd_chunk's tensor-core
                instructions (HMMA) per entry in the built SASS
  kernel_check  paged_decode_attn vs its plain version over layouts, all four
                (q, cache) dtype pairs, g 1/4/7/8 and hd 64/80/128/256;
                one launch a call
  kernel_time   paged_decode_attn, plain version, library call and bound at
                the serve run's shapes, and at the GQA shapes of yi-6b (kv 4,
                g 8), jamba (kv 8, g 4) and olmoe (kv 16, g 1): b 4, hd 128,
                528 of 1024 positions, bf16
  wagg_check    wagg_fused vs its plain version over x dtype x payload
                (none, bf16, int8, int4 in int8) x mask x p x N; grouped
                wagg_fused_many calls over trees of mixed N with a
                misaligned leaf and over 83 leaves (two launches), every
                leaf bitwise the one-leaf call
  wagg_time     wagg_fused, plain version, library call (torch.mm(M, x),
                f32 without a payload), two-call reference and bound at
                the CNN6 round's leaves (one grouped call) and at a
                gemma3-1b MLP leaf; the masked kernel at that leaf (one row
                inactive) against torch.mm and GEMV + lerp + where; the
                int4 payload at a stablelm-3b MLP leaf (p 3)
  rmsnorm_check rmsnorm and the fused residual add (forward and backward)
                vs their plain versions over dtype x d x rows x groups, and
                unaligned rows; the fused sum bitwise equal to x + delta
  rmsnorm_time  rmsnorm and the fused op, plain versions, F.rms_norm (after
                x + delta for the fused op) and bounds at the LM training
                shape and at the decode shape
  ce_check      fused_ce (forward and backward) vs its plain version over
                V x T (llama-3.2-vision's V 128256 too), musicgen's
                codebook logits (2, 640, 4, 2048), out-of-vocab labels and
                unaligned rows
  ce_time       fused_ce, plain version, F.cross_entropy and bound at one
                local step's gemma3-1b logits
  decode_attn_check  decode_attn vs its plain version over g x hd (with
                g 7, hd 80), S, all four dtype pairs, cache_len and window;
                a batch that fills the card (a cluster of one block), the
                global layer's full 1024 positions, a device cache_len at 0
                and S; one device kernel a call (profiler)
  decode_attn_time   decode_attn, plain version, SDPA, bound and device
                kernels a call at the legacy serve run's two cache shapes,
                a llama-3.2-vision cross layer (b 4, 1600 media positions,
                kv 8, g 4, hd 128: bound by its 26.2 MB of K/V) and
                musicgen-large's layers (kv 32, g 1, hd 64, S 1024)
  ssd_check     ssd_chunk vs its plain version (dtypes, mamba2 and jamba
                widths, ds 20, padded tails, steep decay, unaligned inputs)
                and ssd_chunked_kernel vs ssd_chunked
  ssd_time      ssd_chunk, plain version, bound (products at the bf16
                tensor-core rate), bytes_ms and f32_ops_ms (the products at
                the f32 rate, the bound of PRs 15-16) at mamba2-370m's
                prefill shapes (b 1 and b 4, 512 tokens)
  agree         full-width decode steps through the kernels vs through the
                plain versions: logits agree, all finite
  legacy_agree  full-width decode_step (monolithic cache) through
                decode_attn and rmsnorm vs the plain versions; ServeEngine
                and ContinuousEngine greedy tokens equal in f32
  serve         ContinuousEngine on gemma3-1b: tokens, tokens/s, peak memory,
                launches == 26 x decode steps (paged_decode_attn) and 53 x
                (decode steps + prefills) (rmsnorm, 52 of them fused)
  serve_profile device busy time and idle share of a serve run (profiler);
                device kernels of paged_decode_attn == its launches;
                device operations of one decode step
  legacy_serve  ServeEngine on gemma3-1b, 4 x 480 tokens + 96 new: tokens/s,
                launches == 26 x decode steps (decode_attn); under the
                profiler the same tokens, device kernels == launches, and
                its device ms
  f32_cache_serve  the bf16 model on an f32 cache through both engines (the
                (bf16 q, f32 cache) pair of both decode kernels)
  ssm_agree     full-width mamba2-370m prefill and paged decode through
                ssd_chunk and rmsnorm vs the plain versions; 48 ssd_chunk
                launches a prefill
  ssm_serve     ContinuousEngine on mamba2-370m: tokens/s, peak memory,
                launches == 48 x prefills (ssd_chunk)
  ssm_serve_profile  device busy time, idle share, top kernels and the
                device operations of one decode step
  train_agree   one CNN6 round through pallas_wagg vs through einsum, in
                the f32, int8 and int4 codecs (the same payload): params
                agree; pallas_wagg:int4 within int4's error_bound of f32
  int4_codec    the int4 draw on the card vs the CPU (equal but within an
                ulp of an integer), within error_bound of f32 (einsum,
                pallas_wagg, masked), unbiased over 64 keys, its encode
                time; CNN6 with pallas_wagg:int4 through Trainer.run
  train         Trainer.run, WASGD+, CNN6 at its published width, p=8,
                tau=8, 30 rounds: seconds per round, losses, peak memory,
                launches == rounds (6 worker leaves in one launch)
  train_profile device busy time and idle share of 5 training rounds
  lm_agree      one local step of full-width gemma3-1b: per-worker losses
                and gradients through the kernels vs the plain versions,
                f32 and bf16 compute
  lm_remat      gemma3-1b, p=4: one local step with remat off and on
                (losses and gradients within 2e-2, peak over the backward),
                the update tree-wise and leaf-wise (peaks), and a timed
                round each way (s/round, peak)
  lm_train      Trainer.run, WASGD+, gemma3-1b at full width and depth,
                remat on, p=4, tau=4, 8 rounds after 2: s/round, tokens/s,
                losses, peak memory, launches of rmsnorm (4 L + 1 a step),
                fused_ce and wagg_fused
  lm_train_profile device busy time, idle share and top kernels of a round
  dryrun        the dry run (repro_torch.launch.dryrun, a meta-device trace
                on the host) of lm_train's round on a one-card mesh: the
                predicted state and batch bytes equal to the trainer's
                (1%), the predicted peak within [0.5, 2] of lm_train's and
                at or above the arguments, the predicted compute seconds
                under lm_train_profile's device busy time; input_specs of
                all 40 (arch, shape) combinations; no device byte
                allocated, no kernel launched
  lm_pipeline   gemma3-1b, lm_train's settings, Trainer(pipeline="parity")
                from the same seed and data for 2 + 8 rounds: bitwise
                lm_train's rounds and params, the same launches a round,
                s/round and peak beside lm_train's; 2 profiled rounds:
                idle share, the staging copies on a side stream
  telemetry     one JsonlSink: ContinuousEngine on gemma3-1b with a sink
                (a ServeSample a step, greedy tokens as without, device
                operations of the default sink, NullSink() and a sink),
                a HotSwap through a bridge that takes the engine's sink;
                2 NullSink and 2 phase-fenced gemma3-1b rounds on
                lm_train's trainer (the phase breakdown); a CNN6 elastic
                run with checkpoints (MembershipChange, CheckpointSave);
                the file read back with read_events
  baselines     the CNN6 training smoke's settings (10 timed rounds) with
                each of spsgd, easgd (alpha 0.9/16), omwu, mmwu and seq:
                s/round beside train's wasgd+, first and last loss, peak
                memory; each rule's invariant in one more round (spsgd and
                MWU rows bitwise equal, MWU's the argmax worker's; seq's
                rows apart; EASGD's center moved by the sum of the pulls);
                the MLP harness run of each rule, 10 rounds on the card
                against the CPU (params atol 1e-5)
  checkpoint    CNN6: save_checkpoint (sharded, in the background): bytes,
                the time save blocks the caller and the time to wait();
                resume into a fresh trainer bitwise; 2 rounds, save, resume,
                2 more equal 4 straight (bitwise, deterministic cuDNN)
  async_agree   Alg. 4 on the MLP harness (p 4 + b 2, 4 rounds, one
                schedule): run_parallel_sgd_on_device through the masked
                wagg_fused on the card against the host simulation
                run_parallel_sgd on the CPU, boltzmann and best, within
                max(1e-5, twice the CPU run's spread); masked launches and
                masked device kernels (profiler)
  async_train   CNN6, p 6 + b 2, the stragglers and uniform regimes of
                benchmarks/async_straggler.py: Alg. 4 through
                Trainer.run(straggler_schedule=) and Alg. 1 (synchronous
                trainer), 30 rounds each: s/round, the schedules' simulated
                walls, losses, dropped worker-rounds, masked launches, peak
                memory; per round the recorded mask, stragglers' theta 0,
                theta summing to 1; 5 Alg. 4 rounds profiled (idle share)
  async_measured  run_parallel_sgd_on_device(measure_times=True) with
                ema(0.9)|time_aware on CNN6, 10 rounds: measured times (one
                card: the same for every worker) and masks
  elastic       CNN6 through run(membership_schedule=): p 8 -> 6 (round
                10) -> 10 (round 20), and a chaos walk, 30 rounds each;
                at each resize survivors bitwise and newcomers the
                aggregate (1e-6); s/round by p, resize ms; a p = 8
                checkpoint resumed at p = 6 and 10 bitwise equal to
                resize_train_state of the saved state
  pipeline_agree  CNN6 at train's settings, 14 rounds over an
                OrderedDataset with boundary_delay = the prefetcher's
                run-ahead (an OrderGen decision at round 12): two
                unpipelined runs with cuDNN's default and with
                deterministic algorithms; Trainer(pipeline="parity")
                bitwise the unpipelined run (per-round h, theta, losses,
                scores, final params, order seeds, wagg_fused launches),
                also under Alg. 4 (p 6 + b 2, stragglers: the masked
                kernel); "speculative": spec_dev <= 2 spec_bound + 1e-6,
                exactly 0 at beta 0
  train_to_serve  lm_train's gemma3-1b trainer serves what it trains: a
                ContinuousEngine from consensus_params takes the serve
                requests, 3 rounds with serve_hook (a decode chunk, then
                HotSwapBridge), metrics_path and log_every; swap records,
                s/round with serving, peak memory, launches (wagg_fused,
                fused_ce, paged_decode_attn, rmsnorm); evaluate_lm on the
                consensus over 4 held-out batches of 4 x 128 tokens
  lm_async      gemma3-1b at full width and depth, Alg. 4 with p 3 + b 1
                (stragglers regime), 2 + 3 rounds after the earlier LM
                trainer is freed: the first masked round's wagg_fused held
                to the plain version leaf by leaf (1e-4); s/round, peak
                memory, launches (wagg_fused all masked)
  lm_windowed   gemma3-1b's loss at one 2048-token sequence with
                windowed_qblock off and on: logits within 2e-2, ms each
  lm3b_train    Trainer.run, WASGD+, stablelm-3b at full width and depth,
                p=3, tau=4, seq 640, pallas_wagg:int4, remat on, 1 round
                after 1: the first round's wagg_fused held to the plain
                version leaf by leaf (1e-4) with its int4 payload checked
                and its peak split at the aggregate; s/round, tokens/s,
                peak memory, launches; one profiled round (idle share)
  yi_agree      agree on yi-6b at full width (GQA group 8, head_dim 128)
  yi_serve      serve on yi-6b at full width in bf16
  ssd_train_check  SSDChunkFunction under vmap over p = 4 workers, each
                with its own decay rates, at mamba2-370m's and jamba's
                widths (seq 640): one ssd_chunk launch a call, outputs and
                the gradients of xs, dt, a, B, C against autograd through
                the plain version
  ssm_lm_agree  one local step of full-width, full-depth mamba2-370m at
                p=2 (remat on): f32 losses and gradients through the
                kernels vs the plain versions; bf16 each SSM layer on its
                own inputs (output and gradients)
  ssm_lm_train  Trainer.run, WASGD+, mamba2-370m at full width and depth,
                lm_train's settings, 1 round after 1: s/round,
                tokens/s, peak, launches (ssd_chunk 2 x 48 x tau a round
                with remat), one profiled round
  moe_agree     olmoe-1b-7b at full width (64 experts, top 8): decode
                steps through the kernels, each rmsnorm and
                paged_decode_attn call held to its plain version on its
                own inputs, against the plain versions routed alike: f32
                logits within 1e-4; bf16 logits reported beside the
                model's sensitivity to a one-ulp change
  olmoe_serve   serve on olmoe-1b-7b at full width in bf16
  olmoe_train   Trainer.run, WASGD+, olmoe-1b-7b at full width and depth,
                p=4, remat on, 1 round after 1: the experts one copy,
                wagg_fused on every worker leaf once a round (grouped)
                and never on an expert leaf; s/round, tokens/s, peak, one
                profiled round; round 0's h, theta and two leaves kept for
                mesh_olmoe
  mesh_olmoe    olmoe_train's round 0 again without a mesh (the run's own
                spread), then olmoe-1b-7b at olmoe_train's settings
                through rs_ag:f32 on a one-rank NCCL group (the experts
                one copy, their gradient all-reduced): round 0's h, theta,
                an expert leaf and a worker leaf within max(1e-6, 4 x the
                spread) of olmoe_train's, relative; 1 timed round
                (s/round, peak within 2 GiB of olmoe_train's, rmsnorm and
                fused_ce launches, no wagg_fused) and 1 profiled round
  jamba_serve   jamba-v0.1-52b at full width with n_layers cut to 8 (one
                period: 7 Mamba layers, 1 attention, MoE every other),
                13.3B params in bf16: every kernel call of a prefill and
                decode steps held to its plain version on its own inputs
                (logits reported as moe_agree's), then ContinuousEngine on
                the serve
                requests: tokens/s, peak, launches of ssd_chunk,
                paged_decode_attn and rmsnorm
  vlm_agree     llama-3.2-vision-11b at full width and depth (10.1B params,
                init in bf16, every cross gate U(0.5, 1.0) from the seed):
                a prefill with media (2, 1600, 4096) and 4 decode_steps
                through the kernels, each rmsnorm and decode_attn call
                (self and cross layers) held to its plain version on its
                own inputs; logits against the plain path's beside the
                model's sensitivity to a one-ulp change; all finite
  vlm_serve     ServeEngine on it at the legacy serve run's settings with
                media (4, 1600, 4096) float32: tokens/s, peak memory,
                decode_attn launches == 48 x decode steps (40 self, 8
                cross), rmsnorm == 89 x (decode steps + prefills); under
                the profiler the same tokens, device kernels == launches
  audio_agree, audio_serve  the same on musicgen-large (3.26B params):
                prompts (4, 480, 4) codebook tokens, output (4, 96, 4);
                48 decode_attn and 97 rmsnorm launches a step
  audio_train   Trainer.run, WASGD+, musicgen-large at full width and
                depth, lm_train's settings at p 2 (remat on), 1 round
                after 1: s/round, tokens/s, peak, launches (wagg_fused on
                435 leaves a round in 6 launches), one profiled round
  vlm_train     the same on llama-3.2-vision-11b with n_layers cut from 40
                to 5 (one period: 4 self layers, 1 cross layer; 2.18B
                params) and a media leaf (n, 1600, 4096) float32 in the
                dataset, riding the vmapped, rematerialised round
                (wagg_fused on 54 leaves a round in 1 launch)
  mesh_agree    a one-rank NCCL group and a ("data",) DeviceMesh: one
                aggregate of CNN6's worker-stacked params (p 8) through
                shard_map:f32, rs_ag:{f32,bf16,int8,int4},
                async_shard_map and async_rs_ag (masked), pallas_wagg:f32
                (gathered, masked) and auto under the mesh, each against
                the meshless einsum of its codec on the card; the device
                operations the profiler sees in one rs_ag aggregate and
                one rs_ag round; s/round of each spec's CNN6 round under
                the group against einsum:f32 and pallas_wagg:f32 (under
                the group and without it); 3 CNN6 rounds through rs_ag:f32
                unpipelined and pipeline="parity", bitwise equal
                (deterministic cuDNN)
  mesh_baselines  CNN6 at baselines' settings (p 8) through spsgd, easgd,
                omwu, mmwu and seq, 1 + 3 rounds on the group and without
                it (deterministic cuDNN): omwu, mmwu and seq bitwise every
                round, spsgd and easgd within 1e-6 relative after the
                first; s/round each way
  mesh_lm       gemma3-1b at lm_train's settings through rs_ag:f32 with
                pipeline="parity" on the group, 1 + 1 rounds: round 0's h
                and theta bitwise the meshless einsum:f32 round's, its
                aggregated params within 1e-6 relative of that round's;
                rmsnorm and fused_ce launches a round, s/round, peak, one
                profiled round (idle share)
  mesh_elastic  mesh_lm's trainer through run(membership_schedule=): one
                round 4 -> 2 and one 2 -> 4 (survivors bitwise, newcomers
                within 1e-6 relative of the survivors' mean, each resize's
                ms); at p 2 an 8 GB sharded save under the mesh (seconds
                it blocks, to wait()), one round, a resume and the round
                again (bitwise); rmsnorm and fused_ce launches, peak
  launch_train  repro_torch.launch.train.main in process: gemma3-1b at full
                width, --workers 2 --rounds 2, --telemetry, --checkpoint-
                dir/--checkpoint-every 2 (one save), --ckpt: the printed
                params= against cfg.param_count() and one worker's numel, the
                telemetry read back, the flat checkpoint restored bitwise,
                the kernels launched
  examples      examples/torch_train_e2e.py at its ~100M config (JAX's
                flags, 3 rounds, a sharded checkpoint each round, metrics
                JSONL, the consensus evaluated on 4 held-out batches) and
                examples/torch_serve_demo.py on the card, in process:
                their own asserts, the e2e header, rmsnorm and fused_ce
                launches against its steps and evaluation batches, and
                paged_decode_attn, rmsnorm, decode_attn and ssd_chunk
                launched by the demo

then the ``kernels`` summary, the card's name and power limit as
nvidia-smi gives them, and ``{"ok": true, "device": {...}}`` as the last
line. Any failed check raises and the script exits non-zero. Without a
card, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12        # bf16 on the tensor cores

ARCH = "gemma3-1b"
N_SLOTS, MAX_LEN, BLOCK, CHUNK = 4, 1024, 16, 32
# (prompt, new tokens); more requests than slots, and (480, 96) wraps the
# 512-token ring of the local layers
REQUESTS = [(32, 64), (100, 16), (480, 96), (17, 128), (256, 8), (64, 40)]
TOL = {"bfloat16": 2e-2, "float32": 1e-4}

# WASGD+ training of the paper's CNN6 (Sec. 5.2.1): 28x28x1 images, 10
# classes, published widths
TRAIN = {"p": 8, "tau": 8, "b_local": 64, "lr": 0.05, "rounds": 30,
         "n_images": 8192, "n_segments": 2, "order_seed": 7,
         "backend": "pallas_wagg:f32"}
CNN6_LEAVES = 6
# wagg_fused vs its plain version: relative to max|plain|
WAGG_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
LM_LEAF = (4, 1152 * 6912)      # p=4 workers x one gemma3-1b MLP matrix
# leaf sizes of wagg_check's grouped trees: one column, the vector path, and
# two sizes not a multiple of 4
WAGG_GROUP_N = (1, 1000, 4097, 2 ** 20 + 3)

# WASGD+ training of gemma3-1b at full width and depth (the quickstart's
# settings: SGD lr 0.03, beta 0.9, Boltzmann): seq_len 640 exceeds the
# local layers' 512-token window. The data is make_tokens' bigram language,
# 32 sequences that the workers revisit every few rounds. 8 timed rounds,
# not more: the whole script has to fit its time limit.
LM = {"p": 4, "tau": 4, "b_local": 1, "seq_len": 640, "lr": 0.03,
      "warmup_rounds": 2, "rounds": 8, "n_seq": 32, "n_segments": 2,
      "order_seed": 7, "backend": "pallas_wagg:f32", "beta": 0.9}
LM_PROFILE_ROUNDS = 1           # lm_train_profile: 1 round each way
LM_AGREE_P = 2                  # workers in lm_agree (two gradient trees)
# WASGD+ training of stablelm-3b at full width and depth: lm_train's
# settings at p=3 with the int4 payload; remat on (the config's), the
# leaf-wise update; params and gradients are 31.25 GiB each at p=3
LM3B_ARCH = "stablelm-3b"
LM3B = {**LM, "p": 3, "warmup_rounds": 1, "rounds": 1,
        "backend": "pallas_wagg:int4"}
LM3B_LEAF = (3, 2560 * 6912)    # p=3 x one stablelm-3b MLP matrix
# yi-6b served at full width in bf16 (GQA group 8, head_dim 128)
YI_ARCH = "yi-6b"
# gemma3-1b's loss at one 2048-token sequence, where the q-blocked
# windowed attention skips half the key blocks of its local layers
WINDOWED = {"b": 1, "seq_len": 2048, "reps": 3}
# rmsnorm vs its plain version, relative to max|plain|: f32 the order of
# the sum of squares; bf16 output one ulp (2^-8); gradients: two formulas
# of the same derivative (the Function's, autograd's of the plain ops)
RMS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
RMS_GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# fused_ce vs its plain version, absolute: nll and lse of order 20 summed
# over up to 262,144 terms in another order; dlogits lie in [-1, 1]
CE_TOL = {"nll": 1e-4, "dlogits": 1e-5}
# the legacy ServeEngine on gemma3-1b: 4 prompts of 480 tokens, 96 new; the
# local layers' 512-token ring wraps
LEGACY = {"b": 4, "prompt": 480, "n_new": 96, "max_len": 1024}
# mamba2-370m served through ContinuousEngine with the settings above
SSM_ARCH = "mamba2-370m"
# ssd_chunk vs its plain version, relative to max|plain|
SSD_TOL = 1e-5


# SSM training: mamba2-370m at full width and depth with lm_train's
# settings (p 4, tau 4, b_local 1, seq 640, lr 0.03, pallas_wagg:f32,
# remat as configured: on), 1 + 1 rounds, not more: the whole script has
# to fit its time limit
SSM_LM = {**LM, "warmup_rounds": 1, "rounds": 1}
# olmoe-1b-7b at full width and depth: served in bf16 with the serve
# smoke's settings, and trained with lm_train's settings at p 4, remat on,
# 1 + 1 rounds; the experts are one f32 copy (their params and gradients
# 48.0 GiB), the other 476M params four copies (14.2 GiB)
OLMOE_ARCH = "olmoe-1b-7b"
OLMOE_TRAIN = {**LM, "warmup_rounds": 1, "rounds": 1}
# jamba-v0.1-52b at full width, n_layers cut from 32 to 8: one period of
# its 1:7 interleave (layers 0-6 Mamba, 7 attention; MoE on 1, 3, 5, 7),
# 13.3B params initialised in bf16
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_LAYERS = 8
# llama-3.2-vision-11b at full width and depth (10.1B params, initialised
# in bf16) and musicgen-large (3.26B) served through the legacy
# ServeEngine at LEGACY's settings: media (4, 1600, 4096) float32 from the
# seed, and (4, 480, 4) codebook prompts. Both trained with lm_train's
# settings at p 2 (musicgen's f32 params and gradients are 48.5 GiB at
# p 2, 72.8 at p 3), 1 + 1 rounds; llama-3.2-vision as one period at full
# width, n_layers cut from 40 to 5 (layers 0-3 self-attention, 4 cross:
# 2.18B params; all 40 layers' f32 params and gradients are 81 GB at p 1)
VLM_ARCH = "llama-3.2-vision-11b"
AUDIO_ARCH = "musicgen-large"
MEDIA_TRAIN = {**LM, "p": 2, "warmup_rounds": 1, "rounds": 1}
VLM_TRAIN_LAYERS = 5
# decode_attn's new shapes, (b, kv, g, hd, S): a vision cross layer over
# its 1600 media positions, a vision self-attention layer over vlm_serve's
# cache, and musicgen-large's self-attention
CROSS_SHAPE = (LEGACY["b"], 8, 4, 128, 1600)
VLM_SELF_SHAPE = (LEGACY["b"], 8, 4, 128, LEGACY["max_len"])
MUSICGEN_SHAPE = (LEGACY["b"], 32, 1, 64, 1024)


def emit(obj):
    print(json.dumps(obj), flush=True)


def run_phase(fn, *args):
    """Runs one phase, stamps its seconds and prints its record."""
    t0 = time.perf_counter()
    rec = fn(*args)
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def entry_name(name):
    """The kernel and its template arguments, from a mangled entry name."""
    starts = [name.find(k) for k in PORT_KERNELS]
    start = next((i for i in starts if i >= 0), 0)
    end = name.find("Ev", start)
    return name[start:end if end >= 0 else len(name)]


def ptxas_summary(lines):
    """Pairs each compiled entry (template arguments of the mangled name)
    with its ptxas register, shared memory and spill lines."""
    out, entry, spill = [], None, ""
    for ln in lines:
        if "Compiling entry function" in ln:
            entry, spill = entry_name(ln.split("'")[1]), ""
        elif "spill" in ln and entry is not None:
            spill = "; " + ln.strip()
        elif "Used" in ln and entry is not None:
            out.append([entry, ln.split(":", 1)[1].strip() + spill])
            entry = None
    return out


def sass_mma(lib):
    """Tensor-core instructions (HMMA) in each entry of a built library, by
    cuobjdump -sass beside nvcc."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            fn = entry_name(ln.split("Function :", 1)[1].strip())
            counts[fn] = 0
        elif fn is not None and "HMMA" in ln:
            counts[fn] += 1
    return counts


def assert_close(name, out, ref, tol):
    import torch
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def paged_inputs(b, kv, g, hd, n_blk, q_dtype, kv_dtype, gen, dev,
                 trash_row=None):
    """Random q and pools and a shuffled block table; ``trash_row`` points a
    whole row of the table at the trash block (the last pool row)."""
    import torch
    n_pool = b * n_blk + 1
    q = torch.randn(b, kv, g, hd, generator=gen, device=dev).to(q_dtype)
    kp = torch.randn(n_pool, BLOCK, kv, hd, generator=gen,
                     device=dev).to(kv_dtype)
    vp = torch.randn(n_pool, BLOCK, kv, hd, generator=gen,
                     device=dev).to(kv_dtype)
    tab = torch.randperm(b * n_blk, generator=gen, device=dev)
    tab = tab.reshape(b, n_blk).to(torch.int32)
    if trash_row is not None:
        tab[trash_row] = n_pool - 1
    return q, kp, vp, tab


# every (q, cache) dtype pair the decode kernels take
DTYPE_PAIRS = (("bfloat16", "bfloat16"), ("bfloat16", "float32"),
               ("float32", "bfloat16"), ("float32", "float32"))


def phase_kernel_check(dev):
    """paged_decode_attn against its plain version over (kv, g, hd): gemma3-
    1b's (1, 4, 256), stablelm-1.6b's g 1 hd 64, a wide GQA (2, 8, 128) and
    the generic path's (2, 7, 80) (arctic's g, stablelm-3b's hd); linear,
    ring and windowed-ring layouts; all four dtype pairs; a row at the trash
    block. Then a batch whose rows fill the card (b 40 x kv 4: one split a
    row: a cluster of one block) and a 10-row batch whose splits take 3
    tiles each (the double-buffered stage). Each call must launch one
    kernel."""
    import torch
    from repro_torch.kernels.decode_attn import (paged_decode_attn,
                                                 paged_decode_attn_ref)
    from repro_torch.kernels.decode_attn.paged import split_plan
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = []
    b = 5
    layouts = (("linear", 64, None, None, [0, 37, 511, 700, 1023]),
               ("ring512", 32, 512, 512, [0, 37, 511, 700, 2047]),
               ("ring512_window384", 32, 512, 384, [0, 37, 511, 700, 2047]))
    cases = [(b, kv, g, hd, lay, qd, kd)
             for kv, g, hd in ((1, 4, 256), (4, 1, 64), (2, 8, 128),
                               (2, 7, 80))
             for lay in layouts for qd, kd in DTYPE_PAIRS]
    cases += [(40, 4, 2, 64, ("linear8", 8, None, None,
                              list(range(0, 120, 3))), "bfloat16", "float32"),
              (10, 1, 4, 256, ("linear64", 64, None, None,
                               list(range(50, 1024, 100))), "bfloat16",
               "bfloat16")]
    for bb, kv, g, hd, (layout, n_blk, ring, window, index), qd, kd in cases:
        q, kp, vp, tab = paged_inputs(bb, kv, g, hd, n_blk,
                                      getattr(torch, qd), getattr(torch, kd),
                                      gen, dev, trash_row=bb - 1)
        idx = torch.tensor(index, dtype=torch.int32, device=dev)
        before = paged_decode_attn.launches
        out = paged_decode_attn(q, kp, vp, tab, idx, ring=ring,
                                window=window)
        if paged_decode_attn.launches != before + 1:
            raise AssertionError("kernel_check: no launch counted")
        ref = paged_decode_attn_ref(q, kp, vp, tab, idx, ring=ring,
                                    window=window)
        torch.cuda.synchronize()
        tol = TOL[qd]
        name = f"b{bb}_kv{kv}_g{g}_hd{hd}_{layout}_{qd}/{kd}"
        checks.append({"case": name, "index": index[:5],
                       "splits": split_plan(bb, kv, n_blk, BLOCK),
                       "max_abs_err": assert_close(name, out, ref, tol),
                       "tol": tol})
    return {"phase": "kernel_check", "cases": len(checks),
            "rows_at_trash_block": "the last of each batch",
            "tol_reason": "bf16 output: one bf16 ulp of a value below 4 is at "
                          "most 2^-6; f32: summation order over <= 1024 tokens",
            "checks": checks}


def graph_ms(fns, reps_per_graph, replays=10):
    """Device time of one call: the calls ``fns`` (one per working set, so
    the sets together exceed the 50 MB L2 as a decode step's layers do)
    captured into a CUDA graph, replayed, timed with CUDA events."""
    import torch
    for f in fns:
        f()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns[:2]:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps_per_graph):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps_per_graph)


# paged_decode_attn's GQA shapes on the main path (kv, g, hd), each timed
# at b 4 over a linear 1024-position cache with 528 valid positions a row
PAGED_GQA = {"yi-6b": (4, 8, 128), "jamba-v0.1-52b": (8, 4, 128),
             "olmoe-1b-7b": (16, 1, 128)}
PAGED_GQA_INDEX = [527] * N_SLOTS


def paged_time_case(b, kv, g, hd, n_blk, ring, index, gen, dev, n_sets=32):
    """paged_decode_attn, its plain version and SDPA (K/V gathered and
    expanded to the query heads, the valid positions as a mask) at one
    shape, bf16, over ``n_sets`` working sets; the bound from the bytes
    the call must move (q, out, the valid K/V rows, table, index) and
    its f32 operations."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import (paged_decode_attn,
                                                 paged_decode_attn_ref)
    from repro_torch.kernels.decode_attn.ref import slot_valid
    idx = torch.tensor(index, dtype=torch.int32, device=dev)
    S = n_blk * BLOCK
    sets = [paged_inputs(b, kv, g, hd, n_blk, torch.bfloat16,
                         torch.bfloat16, gen, dev) for _ in range(n_sets)]
    valid = slot_valid(torch.arange(S, device=dev)[None, :],
                       idx.long()[:, None], ring, ring)
    gathered = []
    for q, kp, vp, tab in sets:
        k = kp[tab.long()].reshape(b, S, kv, hd).transpose(1, 2)
        v = vp[tab.long()].reshape(b, S, kv, hd).transpose(1, 2)
        gathered.append((q.reshape(b, kv * g, 1, hd),
                         k[:, :, None].expand(b, kv, g, S, hd)
                         .reshape(b, kv * g, S, hd).contiguous(),
                         v[:, :, None].expand(b, kv, g, S, hd)
                         .reshape(b, kv * g, S, hd).contiguous()))
    mask = valid[:, None, None, :]

    def kern(st):
        return lambda: paged_decode_attn(*st, idx, ring=ring, window=ring)

    def plain(st):
        return lambda: paged_decode_attn_ref(*st, idx, ring=ring,
                                             window=ring)

    def library(st):
        return lambda: F.scaled_dot_product_attention(
            st[0], st[1], st[2], attn_mask=mask)

    ms = graph_ms([kern(st) for st in sets], n_sets)
    plain_ms = graph_ms([plain(st) for st in sets], n_sets)
    library_ms = graph_ms([library(st) for st in gathered], n_sets)
    q, kp, vp, tab = sets[0]
    out = paged_decode_attn(q, kp, vp, tab, idx, ring=ring, window=ring)
    ref = paged_decode_attn_ref(q, kp, vp, tab, idx, ring=ring, window=ring)
    lib = F.scaled_dot_product_attention(*gathered[0], attn_mask=mask)
    name = f"time/b{b}_kv{kv}_g{g}_hd{hd}_S{S}"
    err = assert_close(name, out, ref, TOL["bfloat16"])
    lib_err = (lib.reshape(out.shape).float() - ref.float()).abs().max()
    n_valid = int(valid.sum().item())
    elem = 2                                        # bf16
    bytes_moved = (2 * q.numel() * elem             # q in, out out
                   + 2 * n_valid * kv * hd * elem   # valid K and V rows
                   + tab.numel() * 4 + idx.numel() * 4)
    flops = 4 * n_valid * kv * g * hd               # q.k and p.v
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return {
        "shape": {"b": b, "kv": kv, "g": g, "hd": hd, "bs": BLOCK,
                  "n_blk": n_blk, "ring": ring, "index": index,
                  "dtypes": "bfloat16/bfloat16"},
        "valid_tokens": n_valid, "bytes": bytes_moved, "flops": flops,
        "max_abs_err": err, "library_max_abs_err": float(lib_err),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "working_sets": n_sets}


def phase_kernel_time(dev):
    """paged_decode_attn at the serve run's shapes (gemma3-1b: kv 1, g 4,
    hd 256; its 512 ring and a linear 1024 cache) and at the GQA shapes
    of yi-6b, jamba-v0.1-52b and olmoe-1b-7b (``PAGED_GQA``: b 4, linear
    1024, 528 valid positions a row), each beside its plain version, SDPA
    and its bound."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    res = {layout: paged_time_case(N_SLOTS, 1, 4, 256, n_blk, ring,
                                   [100, 480, 575, 1000], gen, dev)
           for layout, n_blk, ring in (("ring512", 32, 512),
                                       ("linear", 64, None))}
    for arch, (kv, g, hd) in PAGED_GQA.items():
        res[arch] = paged_time_case(N_SLOTS, kv, g, hd, 64, None,
                                    PAGED_GQA_INDEX, gen, dev)
        torch.cuda.empty_cache()
    return {"phase": "kernel_time",
            "method": "CUDA graph of 32 calls on 32 distinct working sets "
                      "(> 50 MB L2), 10 replays, CUDA events", **res}


def ulp_pattern(t):
    """A fixed pseudo-random pattern in [-1, 1] of ``t``'s shape (no random
    op, so it also runs under ``vmap``)."""
    import torch
    i = torch.arange(t.numel(), device=t.device).reshape(t.shape)
    return torch.sin(i * 12.9898)


def nudged_norm(x, scale, eps):
    """``rmsnorm_ref`` of x moved by up to one float32 ulp (2^-23 relative)
    before the norm: a float32-level difference, as between the kernel
    and its plain version, that changes a bf16 output only where it lies
    next to a rounding boundary."""
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    xf = x.float() * (1 + 2.0 ** -23 * ulp_pattern(x))
    return rmsnorm_ref(xf, scale, eps).to(x.dtype)


def max_rel(out, ref):
    """max|out - ref| / max|ref| in float32."""
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1e-30)).item()


def held_kernels(errs):
    """(norm, attn, ssd): the kernels' ops as a model call takes them, each
    call also run through its plain version on the call's own inputs, the
    error (``max_rel``) appended to ``errs[name]``; the kernel's output is
    what the model goes on with. The fused residual add must equal
    ``x + delta`` bitwise."""
    import torch
    from repro_torch.kernels.decode_attn import (paged_decode_attn,
                                                 paged_decode_attn_ref)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunked_kernel
    from repro_torch.models import ssd_chunked
    for name in ("rmsnorm", "paged_decode_attn", "ssd_chunk"):
        errs.setdefault(name, [])

    def norm(x, scale, eps):
        y = rmsnorm(x, scale, eps)
        errs["rmsnorm"].append(max_rel(y, rmsnorm_ref(x, scale, eps)))
        return y

    def fused(x, delta, scale, eps):
        s, y = rmsnorm.fused_add(x, delta, scale, eps)
        ref = x + delta
        if not torch.equal(s, ref):
            raise AssertionError("held rmsnorm: the fused sum differs from "
                                 "x + delta")
        errs["rmsnorm"].append(max_rel(y, rmsnorm_ref(ref, scale, eps)))
        return s, y

    norm.fused_add = fused

    def attn(*args, **kw):
        out = paged_decode_attn(*args, **kw)
        errs["paged_decode_attn"].append(
            max_rel(out, paged_decode_attn_ref(*args, **kw)))
        return out

    def ssd(*args, **kw):
        y, st = ssd_chunked_kernel(*args, **kw)
        y_ref, st_ref = ssd_chunked(*args, **kw)
        errs["ssd_chunk"].append(max(max_rel(y, y_ref), max_rel(st, st_ref)))
        return y, st

    return norm, attn, ssd


@contextlib.contextmanager
def moe_routing(record=None, replay=None):
    """Records (``record``, a list) or replays (``replay``, the list a
    recording filled) the expert choices of every ``moe_ffn`` call: its
    ``torch.topk`` of the router's probabilities. A replayed call keeps
    its own probabilities at the recorded experts (gates and aux losses
    from its own router logits). Routing is a discontinuous function of
    its inputs: a one-ulp difference of a bf16 hidden state can swap a
    near-tied expert, after which two paths compute different functions,
    so an agreement check routes both paths alike and reports how many
    choices each path would have made differently on its own."""
    import torch
    from repro_torch.models import moe as MOE
    real = torch.topk
    calls = iter(replay) if replay is not None else None

    class _Torch:
        """``torch`` as ``models.moe`` sees it, with its topk wrapped."""

        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def topk(x, k, dim=-1, **kw):
            vals, idx = real(x, k, dim=dim, **kw)
            if calls is not None:
                want = next(calls)
                replay_flips.append(int((torch.sort(idx, dim=-1).values
                                         != torch.sort(want, dim=-1)
                                         .values).any(dim=-1).sum()))
                idx, vals = want, torch.gather(x, dim, want)
            elif record is not None:
                record.append(idx)
            return vals, idx

    replay_flips = []
    MOE.torch = _Torch()
    try:
        yield replay_flips
    finally:
        MOE.torch = torch


def phase_agree(cfg, params_f32, dev):
    """A few full-width decode steps through the kernels (paged_decode_attn
    and rmsnorm) and through their plain versions, on the same caches and
    tokens."""
    import torch
    from repro_torch.kernels.decode_attn import (paged_decode_attn,
                                                 paged_decode_attn_ref)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    from repro_torch.models import (cast_params, decode_step_paged,
                                    init_cache, prefill)
    from repro_torch.serve import PagedCache
    steps = 4
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (600, 37)]                 # 600 wraps the ring
    feed = rng.integers(0, cfg.vocab_size, (steps, 2, 1)).astype(np.int32)
    results = []
    for dtype, limit in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        c = dataclasses.replace(cfg, compute_dtype=str(dtype).split(".")[1])
        params = cast_params(params_f32, dtype)
        caches = [PagedCache(c, 2, MAX_LEN, BLOCK, dtype=dtype, device=dev)
                  for _ in range(2)]
        for slot, p in enumerate(prompts):
            mono = init_cache(c, 1, MAX_LEN, dtype, dev)
            prefill(c, params, torch.from_numpy(p[None]).to(dev), mono)
            for cache in caches:
                cache.reserve(slot, len(p) + steps)
                cache.write_prefill(slot, mono, len(p))
        index = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                             device=dev)
        worst = 0.0
        for t in range(steps):
            tok = torch.from_numpy(feed[t]).to(dev)
            lg = [decode_step_paged(c, params, tok, cache.pools, cache.tables,
                                    index, max_len=MAX_LEN, block_size=BLOCK,
                                    attn_kernel=kern, norm=norm)[0].float()
                  for cache, kern, norm in zip(
                      caches, (paged_decode_attn, paged_decode_attn_ref),
                      (rmsnorm, rmsnorm_ref))]
            if not (bool(torch.isfinite(lg[0]).all())
                    and bool(torch.isfinite(lg[1]).all())):
                raise AssertionError(f"agree/{dtype}: non-finite logits")
            if lg[0].shape != (2, 1, cfg.padded_vocab):
                raise AssertionError(f"agree: logits shape {lg[0].shape}")
            rel = ((lg[0] - lg[1]).abs().max()
                   / lg[1].abs().max()).item()
            worst = max(worst, rel)
            index += 1
        if not worst <= limit:
            raise AssertionError(f"agree/{dtype}: rel_err {worst} > {limit}")
        results.append({"dtype": str(dtype).split(".")[1], "rel_err": worst,
                        "limit": limit})
        del params, caches
    return {"phase": "agree", "prompts": [len(p) for p in prompts],
            "decode_steps": steps, "finite": True, "checks": results,
            "limit_reason": "f32: summation order; bf16: one-ulp differences "
                            "in attention and norm outputs carried through "
                            f"{cfg.n_layers} layers"}


def serve_requests(cfg, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, p).astype(np.int32), n)
            for p, n in REQUESTS]


def run_engine(eng, reqs):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, n) for p, n in reqs]
    done = eng.run()
    torch.cuda.synchronize()
    return [done[r] for r in rids], time.perf_counter() - t0


def phase_serve(cfg, eng):
    import torch
    from repro_torch.kernels.decode_attn import paged_decode_attn
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
    n_norms = 2 * cfg.n_layers + 1
    run_engine(eng, [(p[:16], 4) for p, _ in serve_requests(cfg, 99)[:2]])
    reqs = serve_requests(cfg, 0)
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attn.launches = rmsnorm_fwd.launches = 0
    add_rmsnorm_fwd.launches = 0
    eng.decode_steps = eng.prefills = 0
    outs, wall = run_engine(eng, reqs)
    launches, steps = paged_decode_attn.launches, eng.decode_steps
    norms, prefills = rmsnorm_fwd.launches, eng.prefills
    fused = add_rmsnorm_fwd.launches
    if launches == 0 or launches != n_attn * steps:
        raise AssertionError(f"serve: {launches} kernel launches for {steps} "
                             f"decode steps x {n_attn} attention layers")
    if norms == 0 or norms != n_norms * (steps + prefills) \
            or fused != (n_norms - 1) * (steps + prefills):
        raise AssertionError(f"serve: {norms} rmsnorm launches ({fused} "
                             f"fused) for {steps} decode steps + {prefills} "
                             f"prefills x {n_norms} norms")
    for (p, n), toks in zip(reqs, outs):
        if toks.shape != (n,) or toks.min() < 0 \
                or toks.max() >= cfg.padded_vocab:
            raise AssertionError(f"serve: bad output for request "
                                 f"({len(p)}, {n}): {toks}")
    tokens = sum(len(t) for t in outs)
    return {"phase": "serve", "arch": cfg.name, "dtype": cfg.compute_dtype,
           "n_slots": N_SLOTS, "max_len": MAX_LEN, "block_size": BLOCK,
           "chunk": CHUNK, "requests": REQUESTS, "decode_steps": steps,
           "attn_layers": n_attn, "launches": launches,
           "prefills": prefills, "rmsnorm_launches": norms,
           "rmsnorm_fused_launches": fused, "tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


# the device kernels of the port's CUDA sources, by entry name
PORT_KERNELS = ("paged_decode_kernel", "wagg_fused_kernel", "rmsnorm_kernel",
                "fused_ce_kernel", "decode_attn_kernel",
                "ssd_chunk_kernel")


PROFILE_PAD_S = 0.25


@contextlib.contextmanager
def device_profile():
    """torch.profiler over device activity, with PROFILE_PAD_S of idle
    host time on either side of the profiled work. The profiler drops the
    device records whose card timestamps fall outside its window (kineto's
    "Out-of-range" count at KINETO_LOG_LEVEL=1), and those timestamps
    stray from the host clock by up to some tens of milliseconds, which
    cost a run's first or last kernels without the pad."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        time.sleep(PROFILE_PAD_S)


def device_summary(prof, wall_s, top_n):
    """Device busy time (the sum of the kernels' times), idle share against
    the unprofiled wall ``wall_s``, launches and the ``top_n`` kernels of
    a torch.profiler run."""
    import torch
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:top_n]
    port = {}
    for name in PORT_KERNELS:
        hits = [e for e in kernels if name in e.key]
        if hits:
            port[name] = {"count": sum(e.count for e in hits),
                          "device_ms": sum(dev_us(e) for e in hits) / 1e3}
    return {"device_busy_ms": busy_ms, "port_kernels": port,
            "device_idle_share": (1 - busy_ms / (wall_s * 1e3)
                                  if busy_ms > 0 else None),
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": dev_us(e) / 1e3} for e in top]}


def step_launches(eng, reqs, at_step=8):
    """Device operations (kernels, copies, fills) of one engine decode step
    (the model's step, sampling, the state update): the run's
    ``at_step``-th decode step profiled alone."""
    import torch
    orig, seen = eng._decode_once, []

    def once(*args):
        if not seen and eng.decode_steps == at_step:
            torch.cuda.synchronize()
            with device_profile() as prof:
                orig(*args)
                torch.cuda.synchronize()
            seen.append(sum(
                e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA))
        else:
            orig(*args)

    eng._decode_once = once
    try:
        eng.decode_steps = 0
        run_engine(eng, reqs)
    finally:
        del eng._decode_once
    return seen[0]


def phase_serve_profile(cfg, eng):
    """One more serve run under torch.profiler: device busy time (sum of
    kernel times on the one stream) against the wall of an unprofiled run
    of the same requests; the device kernels named paged_decode_kernel
    must number paged_decode_attn.launches (one kernel a call, no merge
    kernel). Then the device operations of one decode step, profiled
    alone, and the run's operations over its decode steps."""
    import torch
    from repro_torch.kernels.decode_attn import paged_decode_attn
    reqs = serve_requests(cfg, 0)
    _, wall = run_engine(eng, reqs)
    paged_decode_attn.launches = eng.decode_steps = 0
    # device activity only: host events of a run this long take minutes
    # to post-process
    with device_profile() as prof:
        _, wall_prof = run_engine(eng, reqs)
    steps, launches = eng.decode_steps, paged_decode_attn.launches
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    paged = sum(e.count for e in events if "paged_decode" in e.key)
    if paged != launches or launches == 0:
        raise AssertionError(f"serve_profile: {paged} paged_decode device "
                             f"kernels for {launches} paged_decode_attn "
                             f"calls")
    summary = device_summary(prof, wall, 10)
    return {"phase": "serve_profile", "wall_ms": wall * 1e3,
            "wall_ms_profiled": wall_prof * 1e3,
            "paged_decode_device_kernels": paged,
            "paged_decode_attn_launches": launches, "decode_steps": steps,
            "kernel_launches_per_decode_step_whole_run":
                summary["kernel_launches"] / steps,
            "kernel_launches_one_decode_step": step_launches(eng, reqs),
            **summary}


def wagg_inputs(p, n, x_dtype, payload, mask, gen, dev):
    """x (p, n), theta (p,) positive summing to 1 (the int8 codec's scale
    folded in when the payload is int8), payload and an activity mask."""
    import torch
    x = torch.randn(p, n, generator=gen, device=dev).to(x_dtype)
    theta = torch.rand(p, generator=gen, device=dev) + 0.05
    theta = theta / theta.sum()
    q = None
    if payload == "bfloat16":
        q = torch.randn(p, n, generator=gen, device=dev).to(torch.bfloat16)
    elif payload == "int8":
        q = torch.randint(-127, 128, (p, n), generator=gen, device=dev,
                          dtype=torch.int8)
        theta = theta * (4.0 / 127.0)
    elif payload == "int4":                 # int4 values carried in int8
        q = torch.randint(-7, 8, (p, n), generator=gen, device=dev,
                          dtype=torch.int8)
        theta = theta * (4.0 / 7.0)
    act = None
    if mask == "mixed":
        act = (torch.arange(p, device=dev) % 3 != 1).float()
    elif mask == "one_active":
        act = torch.zeros(p, device=dev)
        act[p // 2] = 1.0
    elif mask == "one_inactive":
        act = torch.ones(p, device=dev)
        act[p - 1] = 0.0
    return x, theta, q, act


def rel_err(out, ref):
    """max |out - ref| over max |ref|, in float32."""
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def wagg_group_tree(p, x_dtype, payload, mask, gen, dev, ns=None):
    """A tree for the grouped wagg_fused_many: leaves of mixed sizes (``ns``,
    default WAGG_GROUP_N) and one more of 1000 columns whose x and payload
    rows start one element past an aligned address (a storage offset);
    theta (p,) and the mask shared; an int payload's scale per leaf (float32,
    the last one bfloat16)."""
    import torch
    ns = list(WAGG_GROUP_N if ns is None else ns)
    xs, qs, scales = [], [], []
    _, theta, _, act = wagg_inputs(p, 1, x_dtype, "none", mask, gen, dev)
    for i, n in enumerate(ns + [1000]):
        x, _, q, _ = wagg_inputs(p, n, x_dtype, payload, "none", gen, dev)
        if i == len(ns):                    # misaligned rows
            x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(p, n)
            if q is not None:
                q = torch.cat([q.new_zeros(1), q.reshape(-1)])[1:].view(p, n)
        s = None
        if payload in ("int8", "int4"):
            s = torch.tensor((4.0 / (127 if payload == "int8" else 7))
                             * (1 + 0.25 * i), device=dev)
            if i == len(ns):
                s = s.to(torch.bfloat16)
        xs.append(x)
        qs.append(q)
        scales.append(s)
    return xs, theta, qs, scales, act


def wagg_group_case(xs, theta, beta, qs, scales, act, name):
    """One wagg_fused_many call: every leaf bitwise equal to a one-leaf
    wagg_fused call with the scale folded into theta (theta * scale, one
    float32 rounding, as the kernel folds it) and within WAGG_TOL of the
    plain version. Returns (launches, worst rel. err)."""
    import torch
    from repro_torch.kernels.wagg import (wagg_fused, wagg_fused_many,
                                          wagg_fused_ref)
    launches, leaves = wagg_fused.launches, wagg_fused.leaves
    outs = wagg_fused_many(xs, theta, beta, payloads=qs, scales=scales,
                           active=act)
    launches = wagg_fused.launches - launches
    if wagg_fused.leaves - leaves != len(xs):
        raise AssertionError(f"wagg group {name}: leaves counter "
                             f"{wagg_fused.leaves - leaves} for {len(xs)}")
    worst = 0.0
    for i, (x, q, s, out) in enumerate(zip(xs, qs, scales, outs)):
        t = theta if s is None else theta * s.float()
        one = wagg_fused(x, t, beta, payload=q, active=act)
        ref = wagg_fused_ref(x, t, beta, payload=q, active=act)
        torch.cuda.synchronize()
        if out.shape != x.shape or out.dtype != x.dtype:
            raise AssertionError(f"wagg group {name} leaf {i}: output "
                                 f"{out.shape} {out.dtype}")
        if not torch.equal(out, one):
            raise AssertionError(f"wagg group {name} leaf {i} "
                                 f"({tuple(x.shape)}): not bitwise the "
                                 f"one-leaf call")
        xname = str(x.dtype).split(".")[1]
        rel = rel_err(out, ref)
        if not rel <= WAGG_TOL[xname]:
            raise AssertionError(f"wagg group {name} leaf {i}: rel_err "
                                 f"{rel} > {WAGG_TOL[xname]}")
        worst = max(worst, rel)
    return launches, worst


def wagg_group_cases(dev, beta):
    """wagg_fused_many over trees of mixed leaf sizes plus a misaligned
    leaf, over x dtype x payload x mask x p; and over MAX_LEAVES + 3
    leaves (two launches)."""
    import torch
    from repro_torch.kernels.wagg import wagg as wagg_mod
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    worst, n_trees = {}, 0
    for xd in (torch.float32, torch.bfloat16):
        xname = str(xd).split(".")[1]
        for payload in ("none", "bfloat16", "int8", "int4"):
            for mask in ("none", "mixed", "one_active"):
                for p in (1, 3, 8, 33):
                    tree = wagg_group_tree(p, xd, payload, mask, gen, dev)
                    name = f"{xname}/{payload}/{mask}/p{p}"
                    launches, rel = wagg_group_case(*tree[:2], beta,
                                                    *tree[2:], name)
                    if launches != 1:
                        raise AssertionError(f"wagg group {name}: "
                                             f"{launches} launches, want 1")
                    key = f"{xname}/{payload}"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    n_trees += 1
                    del tree
            many = wagg_mod.MAX_LEAVES + 3
            ns = [int(v) for v in torch.randint(1, 3000, (many - 1,),
                                                generator=gen, device=dev)]
            tree = wagg_group_tree(3, xd, payload, "mixed", gen, dev, ns=ns)
            launches, _ = wagg_group_case(*tree[:2], beta, *tree[2:],
                                          f"{xname}/{payload}/{many}")
            if launches != 2:
                raise AssertionError(f"wagg group of {many} leaves: "
                                     f"{launches} launches, want 2")
            n_trees += 1
    return {"trees": n_trees, "leaf_n": list(WAGG_GROUP_N) + [1000],
            "misaligned_leaf": "1000 columns, x and payload at a storage "
                               "offset of one element",
            "max_leaves_case": wagg_mod.MAX_LEAVES + 3,
            "worst_rel_err": worst,
            "bitwise": "every leaf equal to a one-leaf wagg_fused call"}


def phase_wagg_check(dev):
    """wagg_fused against its plain version over x dtype x payload (none,
    bf16, int8, int4 values in [-7, 7] carried in int8) x mask x p x N
    (N = 1000 takes the vector path; 1, 4097 and 2^20 + 3, which are not
    multiples of 4, the strided path, or the vector path and a scalar tail
    at p = 1); then the grouped cases (``wagg_group_cases``)."""
    import torch
    from repro_torch.kernels.wagg import wagg_fused, wagg_fused_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    beta = 0.9
    worst = {}
    n_cases = 0
    for xd in (torch.float32, torch.bfloat16):
        xname = str(xd).split(".")[1]
        for payload in ("none", "bfloat16", "int8", "int4"):
            for mask in ("none", "mixed", "one_active"):
                for p in (1, 3, 8, 33):
                    for n in (1, 1000, 4097, 2 ** 20 + 3):
                        x, theta, q, act = wagg_inputs(p, n, xd, payload,
                                                       mask, gen, dev)
                        out = wagg_fused(x, theta, beta, payload=q,
                                         active=act)
                        ref = wagg_fused_ref(x, theta, beta, payload=q,
                                             active=act)
                        torch.cuda.synchronize()
                        name = f"{xname}/{payload}/{mask}/p{p}/n{n}"
                        if not bool(torch.isfinite(out.float()).all()):
                            raise AssertionError(f"wagg {name}: non-finite")
                        if out.shape != x.shape or out.dtype != x.dtype:
                            raise AssertionError(f"wagg {name}: output "
                                                 f"{out.shape} {out.dtype}")
                        rel = rel_err(out, ref)
                        if not rel <= WAGG_TOL[xname]:
                            raise AssertionError(
                                f"wagg {name}: rel_err {rel} > "
                                f"{WAGG_TOL[xname]}")
                        key = f"{xname}/{payload}"
                        worst[key] = max(worst.get(key, 0.0), rel)
                        n_cases += 1
                        del x, q, out, ref
    return {"phase": "wagg_check", "cases": n_cases, "beta": beta,
            "p": [1, 3, 8, 33], "n": [1, 1000, 4097, 2 ** 20 + 3],
            "masks": ["none", "mixed", "one_active"],
            "worst_rel_err": worst, "tol": WAGG_TOL,
            "grouped": wagg_group_cases(dev, beta),
            "tol_reason": "rel. to max|plain|; f32: summation order over "
                          "<= 33 rows; bf16 output: one bf16 ulp (2^-8)"}


def wagg_work(p, n, x_bytes, q_bytes, masked=False):
    """Bytes one call must move (x and the payload read once, theta and
    the mask read, out written once; an inactive row's x is read for m
    anyway) and its float32 operations (p FMAs per column for m, 3 per
    output element)."""
    return (p * n * (2 * x_bytes + q_bytes) + p * 4 * (2 if masked else 1),
            5 * p * n)


def eq10_matrix(theta, beta, active=None):
    """M (p, p) with out = M @ x for Eq. 10 on a float32 x that is its own
    payload: (1 - beta) I + beta 1 theta^T, an inactive row theta^T."""
    import torch
    p = theta.shape[0]
    m = ((1.0 - beta) * torch.eye(p, device=theta.device)
         + beta * theta[None, :].expand(p, p))
    if active is not None:
        m = torch.where(active[:, None] != 0, m, theta[None, :].expand(p, p))
    return m.contiguous()


def phase_wagg_time(dev):
    """wagg_fused at the shapes of the CNN6 round (its 6 worker leaves at
    p=8 in one wagg_fused_many call, as the schedule hands them over: one
    call = one round's aggregation), at one gemma3-1b MLP leaf (p=4,
    N=1152*6912, f32 x: 127 MB, past the 50 MB L2) and, with the int4
    payload of the stablelm-3b run, at one stablelm-3b MLP leaf (p=3,
    N=2560*6912). The library call, where one PyTorch call computes the
    function (f32 x, no payload), is torch.mm(M, x) a leaf; the two-call
    GEMV + lerp stays beside it."""
    import torch
    from repro_torch.kernels.wagg import (wagg_fused, wagg_fused_many,
                                          wagg_fused_ref)
    from repro_torch.models import init_cnn6
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    beta = 0.9
    p_cnn = TRAIN["p"]
    cnn_n = [v.numel() for _, v in sorted(init_cnn6(0, device=dev).items())]
    shapes = {"cnn6_round": [(p_cnn, n) for n in cnn_n],
              "lm_mlp_leaf": [LM_LEAF], "lm3b_mlp_leaf": [LM3B_LEAF]}
    payloads = {"cnn6_round": ("none", "bfloat16", "int8"),
                "lm_mlp_leaf": ("none", "bfloat16", "int8"),
                "lm3b_mlp_leaf": ("int4",)}
    res = {}
    for shape_name, leaves in shapes.items():
        for payload in payloads[shape_name]:
            sets = [wagg_inputs(p, n, torch.float32, payload, "none", gen,
                                dev) for p, n in leaves]
            xs, qs = [x for x, _, _, _ in sets], [q for _, _, q, _ in sets]
            t = sets[0][1]                  # one theta for the tree

            def kern():
                return wagg_fused_many(xs, t, beta, payloads=qs)

            def plain():
                return [wagg_fused_ref(x, t, beta, payload=q)
                        for x, q in zip(xs, qs)]

            def two_calls():            # GEMV, then lerp
                return [torch.lerp(x, (t @ (x if q is None else q.float())
                                       )[None].expand_as(x), beta)
                        for x, q in zip(xs, qs)]

            reps = 32 if shape_name == "cnn6_round" else 4
            launches = wagg_fused.launches
            kern()
            launches = wagg_fused.launches - launches
            ms = graph_ms([kern], reps)
            plain_ms = graph_ms([plain], reps)
            two_ms = graph_ms([two_calls], reps)
            pairs = list(zip(kern(), plain()))
            abs_err = max((o.float() - r.float()).abs().max().item()
                          for o, r in pairs)
            err = max(rel_err(o, r) for o, r in pairs)
            two_err = max(rel_err(o, r) for o, r in zip(two_calls(),
                                                        plain()))
            if not err <= WAGG_TOL["float32"]:
                raise AssertionError(f"wagg_time {shape_name}/{payload}: "
                                     f"rel_err {err}")
            q_bytes = {"none": 0, "bfloat16": 2, "int8": 1, "int4": 1}[payload]
            bytes_moved, flops = map(sum, zip(*(wagg_work(p, n, 4, q_bytes)
                                                for p, n in leaves)))
            t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
            t_o = flops / F32_FLOP_PER_S * 1e3
            rec = {
                "leaves": [list(lf) for lf in leaves], "x": "float32",
                "payload": payload, "launches_per_call": launches,
                "bytes": bytes_moved, "flops": flops,
                "max_abs_err": abs_err, "max_rel_err": err,
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "library": None, "two_call_ms": two_ms,
                "two_call_max_rel_err": two_err,
                "two_call": "m = theta @ src.float(), then "
                            "torch.lerp(x, m, beta)",
                "bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations"}
            if payload == "none":
                rec.update(wagg_mm_time(xs, t, beta, None, plain, reps))
            res[f"{shape_name}/{payload}"] = rec
            del sets, xs, qs
    res["lm_mlp_leaf/none/masked"] = wagg_masked_time(dev, gen, beta)
    # cuBLAS keeps a workspace for each stream it ran on, the graph
    # captures' streams included: free them, or they stay allocated and
    # count in every later phase's peak
    held = torch.cuda.memory_allocated(dev)
    torch._C._cuda_clearCublasWorkspaces()
    return {"phase": "wagg_time",
            "method": "CUDA graph of 32 (CNN6 round) or 4 (LM leaf) calls, "
                      "10 replays, CUDA events; beta 0.9",
            "cublas_workspaces_freed_bytes":
                held - torch.cuda.memory_allocated(dev), **res}


def wagg_mm_time(xs, theta, beta, active, plain, reps):
    """The one-call yardstick of an f32 x without a payload: torch.mm(M, x)
    a leaf, M from ``eq10_matrix`` (made once, outside the timing)."""
    import torch
    mat = eq10_matrix(theta, beta, active)

    def library():
        return [torch.mm(mat, x) for x in xs]

    ms = graph_ms([library], reps)
    err = max(rel_err(o, r) for o, r in zip(library(), plain()))
    return {"library_ms": ms, "library_max_rel_err": err,
            "library": "torch.mm(M, x) a leaf, M = (1 - beta) I + beta "
                       "1 theta^T (an inactive row theta^T)"}


def wagg_masked_time(dev, gen, beta):
    """The masked kernel (Alg. 4) at one gemma3-1b MLP leaf (p 4, f32 x,
    the last row inactive), its plain version, torch.mm(M, x) and three
    calls (GEMV, torch.lerp, torch.where)."""
    import torch
    from repro_torch.kernels.wagg import wagg_fused, wagg_fused_ref
    p, n = LM_LEAF
    x, t, _, act = wagg_inputs(p, n, torch.float32, "none", "one_inactive",
                               gen, dev)

    def kern():
        return [wagg_fused(x, t, beta, active=act)]

    def plain():
        return [wagg_fused_ref(x, t, beta, active=act)]

    def three_calls():
        m = (t @ x)[None].expand_as(x)
        return [torch.where(act[:, None] != 0, torch.lerp(x, m, beta), m)]

    ms, plain_ms, three_ms = (graph_ms([f], 4) for f in (kern, plain,
                                                          three_calls))
    out, ref = kern()[0], plain()[0]
    err = rel_err(out, ref)
    if not err <= WAGG_TOL["float32"]:
        raise AssertionError(f"wagg_time masked LM leaf: rel_err {err}")
    bytes_moved, flops = wagg_work(p, n, 4, 0, masked=True)
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_FLOP_PER_S * 1e3
    return {"leaves": [[p, n]], "x": "float32", "payload": "none",
            "mask": "one_inactive", "bytes": bytes_moved, "flops": flops,
            "max_abs_err": (out - ref).abs().max().item(),
            "max_rel_err": err, "ms": ms, "plain_ms": plain_ms,
            "three_call_ms": three_ms,
            "three_call_max_rel_err": rel_err(three_calls()[0], ref),
            "three_call": "m = theta @ x, torch.lerp(x, m, beta), "
                          "torch.where(active != 0, ., m)",
            **wagg_mm_time([x], t, beta, act, plain, 4),
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def cnn6_setup():
    """The paper's CNN6 task: make_images(seed=0, n=8192), an
    OrderedDataset with order search, the classification loss."""
    from repro_torch.configs import TrainConfig, WASGDConfig
    from repro_torch.data import OrderedDataset, make_images
    from repro_torch.models import classification_loss, cnn6_apply

    def loss_fn(params, batch):
        return classification_loss(cnn6_apply(params, batch["x"]),
                                   batch["y"]), {}

    def tcfg(backend, async_mode="host_sim", beta=0.9):
        return TrainConfig(learning_rate=TRAIN["lr"], optimizer="sgd",
                           wasgd=WASGDConfig(tau=TRAIN["tau"], beta=beta,
                                             backend=backend,
                                             async_mode=async_mode))

    X, y = make_images(0, TRAIN["n_images"])

    def dataset(p=TRAIN["p"], boundary_delay=0):
        return OrderedDataset({"x": X, "y": y}, p, TRAIN["tau"],
                              TRAIN["b_local"],
                              n_segments=TRAIN["n_segments"],
                              seed=TRAIN["order_seed"],
                              boundary_delay=boundary_delay)
    return loss_fn, tcfg, dataset


def phase_train_agree(dev):
    """One CNN6 round from the same params and batch: the tau local steps
    run once (cuDNN's weight gradients are not bitwise reproducible, and
    CNN6 amplifies a last-bit difference across 8 steps), then each spec's
    rule aggregates the same pre-aggregate params and energies. The int4
    codec's draw depends on the params' bits, so both int4 specs encode
    the same payload: pallas_wagg:int4 within 1e-5 of einsum:int4, and
    within int4's error_bound of pallas_wagg:f32."""
    import torch
    from repro_torch.core import get_codec, replicate_workers, shared_axes
    from repro_torch.models import init_cnn6
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (build_train_step, init_comm_state,
                                   init_state, wasgd_rule)
    loss_fn, tcfg, dataset = cnn6_setup()
    p = TRAIN["p"]
    base = init_cnn6(0, device=dev)
    params, axes = replicate_workers(base, shared_axes(base), p)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in next(dataset().batches()).items()}
    cfg = tcfg("einsum:f32")
    opt = make_optimizer("sgd", TRAIN["lr"])
    seen = {}

    def recording(prm, ax, h, cs, rule=wasgd_rule(cfg.wasgd)):
        seen.update(params=prm, h=h, comm_state=cs)
        return rule(prm, ax, h, cs)

    step = build_train_step(loss_fn, opt, axes, cfg.wasgd, p, rule=recording)
    comm = init_comm_state("wasgd+", params, axes, p, cfg.wasgd)
    state, metrics = step(init_state(params, opt.init(params), p, comm),
                          batch)
    out = {"einsum:f32": state.params}
    for spec in ("pallas_wagg:f32", "pallas_wagg:int8", "einsum:int8",
                 "pallas_wagg:int4", "einsum:int4"):
        out[spec] = wasgd_rule(tcfg(spec).wasgd)(
            seen["params"], axes, seen["h"], seen["comm_state"])[0]
    torch.cuda.synchronize()
    theta = metrics["theta"]
    checks = []
    # (spec, spec, the bound's codec): the same payload on both sides but
    # for the last pair, where int4 stands against f32 within its bound
    for a, b, codec in (("pallas_wagg:f32", "einsum:f32", "f32"),
                        ("pallas_wagg:int8", "einsum:int8", "int8"),
                        ("pallas_wagg:int4", "einsum:int4", "f32"),
                        ("pallas_wagg:int4", "pallas_wagg:f32", "int4")):
        worst, worst_ratio = 0.0, 0.0
        for k in sorted(out[a]):
            if not bool(torch.isfinite(out[a][k]).all()):
                raise AssertionError(f"train_agree {a}/{k}: non-finite")
            diff = (out[a][k] - out[b][k]).abs().max().item()
            bound = (1e-5 if codec == "f32" else get_codec(codec)
                     .error_bound(seen["params"][k], theta, 0.9).item())
            worst = max(worst, diff)
            worst_ratio = max(worst_ratio, diff / bound)
            if not diff <= bound:
                raise AssertionError(f"train_agree {a} vs {b} leaf {k}: "
                                     f"{diff} > {bound}")
        checks.append({"specs": [a, b], "max_abs_diff": worst,
                       "max_diff_over_bound": worst_ratio,
                       "bound": "1e-5" if codec == "f32" else
                                f"{codec} error_bound per leaf"})
    int8_vs_f32 = max((out["pallas_wagg:int8"][k] - out["einsum:f32"][k])
                      .abs().max().item() for k in out["einsum:f32"])
    return {"phase": "train_agree", "p": p, "tau": TRAIN["tau"],
            "b_local": TRAIN["b_local"], "theta": theta.tolist(),
            "checks": checks, "int8_vs_f32_max_abs_diff": int8_vs_f32}


INT4 = {"seed": 5, "leaf_index": 7, "keys": 64, "unbiased_shape": (4, 16384),
        "cnn6_rounds": 5, "encode_reps": 3}


def phase_int4_codec(dev):
    """The int4 codec's counter-based draw on the card, at one stablelm-3b
    MLP leaf (p=3 x 2560*6912, the largest matrix the lm3b_train round
    encodes): the card's payload equals the CPU's but where
    x / scale + u lies within one float32 ulp of an integer (counted on
    the CPU; there the two may round apart), the keys and scales are
    equal; einsum:int4 and pallas_wagg:int4 (unmasked and masked, whose
    stragglers adopt m whole: its bound at beta 1) stay within error_bound
    of einsum:f32; the mean over 64 keys of
    q * scale is unbiased (the leaf's mean error within 4 standard
    errors, each element's standard deviation scale * sqrt(f (1 - f)) for
    its fractional part f); the encode's time; CNN6 through
    Trainer.run with pallas_wagg:int4 (the int8-carried payload in
    wagg_fused): launches, finite and falling losses."""
    import torch
    from repro_torch.core import backends
    from repro_torch.core.codecs import (get_codec, int4_key, int4_uniform,
                                         INT4_CHUNK)
    from repro_torch.train import Trainer
    codec = get_codec("int4")
    gen = torch.Generator(device=dev)
    gen.manual_seed(INT4["seed"])
    p, n = LM3B_LEAF
    x = torch.randn(p, n, generator=gen, device=dev) * 0.02
    ctx = backends.AggregationContext(leaf_index=INT4["leaf_index"])
    codec.encode(x, ctx)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(INT4["encode_reps"]):
        q_dev, s_dev = codec.encode(x, ctx)
    end.record()
    torch.cuda.synchronize()
    encode_ms = start.elapsed_time(end) / INT4["encode_reps"]
    xc = x.cpu()
    q_cpu, s_cpu = codec.encode(xc, ctx)
    key_dev = int4_key(x, None, INT4["leaf_index"]).item()
    key_cpu_t = int4_key(xc, None, INT4["leaf_index"])
    key_cpu = key_cpu_t.item()
    flat, qd, qc = xc.reshape(-1), q_dev.cpu().reshape(-1), q_cpu.reshape(-1)
    n_diff = n_near = n_diff_not_near = 0
    for a in range(0, flat.numel(), INT4_CHUNK):
        b = min(a + INT4_CHUNK, flat.numel())
        v = torch.addcdiv(int4_uniform(key_cpu_t, a, b), flat[a:b], s_cpu)
        ulp = torch.nextafter(v.abs(), torch.tensor(float("inf"))) - v.abs()
        near = (v - torch.round(v)).abs() <= ulp
        diff = qd[a:b] != qc[a:b]
        n_diff += int(diff.sum())
        n_near += int(near.sum())
        n_diff_not_near += int((diff & ~near).sum())
    draw = {"elements": flat.numel(), "key_card": key_dev,
            "key_cpu": key_cpu, "scale_equal": bool(s_dev.cpu() == s_cpu),
            "payload_differs": n_diff, "within_one_ulp_of_an_integer": n_near,
            "differs_elsewhere": n_diff_not_near, "encode_ms": encode_ms}
    if not (key_dev == key_cpu and draw["scale_equal"]
            and n_diff_not_near == 0 and int(q_dev.abs().max()) <= 7):
        raise AssertionError(f"int4_codec: card vs CPU draw {draw}")
    del xc, flat, qd, qc, q_cpu

    h = torch.rand(p, generator=gen, device=dev) + 0.5
    theta = torch.softmax(-h, dim=0)
    params, axes = {"leaf": x}, {"leaf": ("worker", None)}
    bounds = {}
    for spec, act in (("einsum:int4", None), ("pallas_wagg:int4", None),
                      ("pallas_wagg:int4", "masked")):
        active = (None if act is None else
                  (torch.arange(p, device=dev) != 1).float())
        th = theta if active is None else theta * active / (theta * active
                                                            ).sum()
        # a straggler adopts m whole: a masked round's bound is at beta 1
        bound = codec.error_bound(x, th, 0.9 if act is None else 1.0).item()
        c = backends.AggregationContext(active=active)
        out = backends.aggregate_with(spec, params, axes, th, 0.9, ctx=c)
        ref = backends.aggregate_with("einsum:f32", params, axes, th, 0.9,
                                      ctx=c)
        err = (out["leaf"] - ref["leaf"]).abs().max().item()
        name = spec + ("" if act is None else "/masked")
        bounds[name] = {"max_abs_err": err, "error_bound": bound}
        if not err <= bound:
            raise AssertionError(f"int4_codec {name}: {err} > {bound}")
        del out, ref
    del x, q_dev, params

    xs = torch.randn(*INT4["unbiased_shape"], generator=gen, device=dev)
    scale = codec.encode(xs)[1]
    acc = torch.zeros_like(xs)
    for k in range(INT4["keys"]):
        acc += codec.encode(xs, backends.AggregationContext(key=k))[0]
    mean_err = acc / INT4["keys"] * scale - xs
    f = xs / scale - torch.floor(xs / scale)
    var = scale ** 2 * f * (1 - f) / INT4["keys"]
    z_leaf = (mean_err.mean() / (var.sum().sqrt() / xs.numel())).item()
    z = mean_err.abs() / var.sqrt().clamp_min(1e-30)
    unbiased = {"keys": INT4["keys"], "elements": xs.numel(),
                "leaf_mean_err_in_se": z_leaf,
                "elements_over_3_se": int((z > 3).sum()),
                "elements_over_4_se": int((z > 4).sum()),
                "normal_tail_over_3_se": 0.0027 * xs.numel()}
    if not abs(z_leaf) <= 4:
        raise AssertionError(f"int4_codec: biased, {unbiased}")

    loss_fn, tcfg, dataset = cnn6_setup()
    from repro_torch.core import shared_axes
    from repro_torch.models import init_cnn6
    params = init_cnn6(0, device=dev)
    tr = Trainer(loss_fn, params, shared_axes(params),
                 tcfg("pallas_wagg:int4"), TRAIN["p"], rule="wasgd+",
                 device=dev)
    reset_wagg()
    wall, _ = run_trainer(tr, dataset, INT4["cnn6_rounds"])
    losses = tr.losses()
    counts = wagg_counts("int4_codec", INT4["cnn6_rounds"], wagg_tree_plan(
        tr.state.params, tr.axes, "pallas_wagg:int4"))
    launches = counts["launches"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"int4_codec: CNN6 int4 run, losses {losses}")
    return {"phase": "int4_codec", "leaf": list(LM3B_LEAF), "draw": draw,
            "within_error_bound": bounds, "unbiased": unbiased,
            "cnn6": {"backend": "pallas_wagg:int4",
                     "rounds": INT4["cnn6_rounds"], "launches": launches,
                     "leaves": counts["leaves"],
                     "seconds_per_round": wall / INT4["cnn6_rounds"],
                     "losses": [float(v) for v in losses]}}


def run_trainer(tr, dataset, rounds, **kw):
    """``tr.run`` over a fresh ``dataset()`` for ``rounds`` rounds (``kw``
    to ``run``); returns the wall seconds and the dataset."""
    import torch
    ds = dataset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(ds, rounds, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, ds


def new_trainer(dev, p=TRAIN["p"], async_mode="host_sim", pipeline=None,
                beta=0.9):
    """A CNN6 WASGD+ trainer at ``TRAIN``'s settings with ``p`` workers
    (pipelined as ``pipeline`` says), and the dataset for it."""
    import functools
    from repro_torch.core import shared_axes
    from repro_torch.models import init_cnn6
    from repro_torch.train import Trainer
    loss_fn, tcfg, dataset = cnn6_setup()
    params = init_cnn6(0, device=dev)
    tr = Trainer(loss_fn, params, shared_axes(params),
                 tcfg(TRAIN["backend"], async_mode, beta), p, rule="wasgd+",
                 device=dev, pipeline=pipeline)
    return tr, functools.partial(dataset, p)


def phase_train(dev):
    import torch
    from repro_torch.core.order import OrderState
    warm, dataset = new_trainer(dev)
    warm_s, _ = run_trainer(warm, dataset, 2)
    del warm
    tr, dataset = new_trainer(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_wagg()
    wall, ds = run_trainer(tr, dataset, TRAIN["rounds"])
    plan = wagg_tree_plan(tr.state.params, tr.axes, TRAIN["backend"])
    if plan != (CNN6_LEAVES, 1):
        raise AssertionError(f"train: CNN6's aggregate plan {plan}, want "
                             f"{CNN6_LEAVES} leaves in one launch")
    counts = wagg_counts("train", TRAIN["rounds"], plan)
    launches = counts["launches"]
    losses = tr.losses()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train: losses {losses}")
    for k, v in tr.state.params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"train: non-finite params {k}")
    theta = np.stack([h["theta"] for h in tr.history])
    seeds0 = OrderState(TRAIN["p"], TRAIN["n_segments"],
                        TRAIN["order_seed"]).seeds
    return {"phase": "train", "model": "cnn6", **TRAIN,
            "rule": "wasgd+", "launches": launches,
            "leaves": counts["leaves"],
            "seconds_per_round": wall / TRAIN["rounds"], "wall_s": wall,
            "warmup_2_rounds_s": warm_s,
            "samples_per_s": TRAIN["rounds"] * TRAIN["p"] * TRAIN["tau"]
            * TRAIN["b_local"] / wall,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "losses": [float(x) for x in losses],
            "theta_min": float(theta.min()), "theta_max": float(theta.max()),
            "rounds_per_segment": ds.rounds_per_segment,
            "order_decisions": (TRAIN["rounds"] - 1)
            // ds.rounds_per_segment,
            "seeds_reshuffled": int((ds.order.seeds != seeds0).sum()),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_train_profile(dev):
    """A fresh trainer: 2 warm-up rounds, 5 rounds unprofiled (wall), then
    5 under torch.profiler on device activity: busy time against that
    wall."""
    rounds = 5
    tr, dataset = new_trainer(dev)
    run_trainer(tr, dataset, 2)
    wall, _ = run_trainer(tr, dataset, rounds)
    with device_profile() as prof:
        wall_prof, _ = run_trainer(tr, dataset, rounds)
    return {"phase": "train_profile", "rounds": rounds,
            "wall_ms": wall * 1e3, "wall_ms_profiled": wall_prof * 1e3,
            **device_summary(prof, wall, 12)}


# -- the paper's baseline rules and checkpoints (CNN6) -----------------------

BASELINE_RULES = ("spsgd", "easgd", "omwu", "mmwu", "seq")
EASGD_ALPHA = 0.9 / 16
BASELINE_ROUNDS = 10            # timed CNN6 rounds a rule (the time limit)
# the MLP run of the harness in benchmarks/common.py, cut as the CPU tests
# cut it (tests/test_torch_baselines.py), held between the card and the
# CPU with the CPU tests' tolerances, or within twice the CPU run's own
# spread under a 1e-7 perturbation of its start where that is larger: the
# easgd and omwu runs move by 1e-4 to 8e-4 from round 2 under such a
# perturbation (a ReLU or an argmax that flips), as CNN6 does in
# tests/test_torch_train.py
MLP = {"p": 4, "tau": 8, "b_local": 8, "n_samples": 512, "rounds": 10,
       "lr": 0.05, "d": 64, "hidden": 128, "classes": 10, "n_segments": 2,
       "order_seed": 7, "perturb": 1e-7}
MLP_TOL = {"params_atol": 1e-5, "h_loss_rtol": 1e-5, "theta_atol": 1e-6}


def new_baseline_trainer(dev, rule):
    from repro_torch.core import shared_axes
    from repro_torch.models import init_cnn6
    from repro_torch.train import Trainer
    loss_fn, tcfg, dataset = cnn6_setup()
    params = init_cnn6(0, device=dev)
    tr = Trainer(loss_fn, params, shared_axes(params), tcfg("einsum:f32"),
                 TRAIN["p"], rule=rule, device=dev,
                 easgd_alpha=EASGD_ALPHA if rule == "easgd" else None)
    return tr, loss_fn, dataset


def rule_invariant(tr, rule, loss_fn, batch):
    """One more round through ``build_train_step`` with a rule that records
    what it is given: after spsgd and MWU every worker row is bitwise equal
    (MWU: to the argmax worker's row before the round); seq returns the
    rows untouched and they stay apart; EASGD moves its center by the sum
    of the pulls alpha (x_i - c) and pulls each worker by its own."""
    import torch
    from repro_torch.train import RULES, build_train_step, easgd_rule
    rule_fn = (easgd_rule(EASGD_ALPHA) if rule == "easgd"
               else RULES[rule](tr.tcfg))
    seen = {}

    def recording(prm, ax, h, cs):
        seen.update(before=dict(prm), cs=cs)
        return rule_fn(prm, ax, h, cs)

    step = build_train_step(loss_fn, tr.optimizer, tr.axes, tr.tcfg.wasgd,
                            tr.n_workers, rule=recording)
    state, metrics = step(tr.state, batch)
    torch.cuda.synchronize()
    before, after = seen["before"], state.params
    out = {}
    if rule in ("spsgd", "omwu", "mmwu"):
        out["rows_bitwise_equal"] = all(
            bool((v == v[:1]).all()) for v in after.values())
        if rule != "spsgd":
            a = int(torch.argmax(metrics["theta"]))
            out["argmax_worker"] = a
            out["rows_equal_argmax_worker"] = all(
                torch.equal(after[k][0], before[k][a]) for k in after)
        ok = out["rows_bitwise_equal"] and out.get(
            "rows_equal_argmax_worker", True)
    elif rule == "seq":
        out["params_untouched"] = all(after[k] is before[k] for k in after)
        out["rows_apart_max_abs"] = max(
            (v - v[:1]).abs().max().item() for v in after.values())
        ok = out["params_untouched"] and out["rows_apart_max_abs"] > 0
    else:
        c0, c1 = seen["cs"].center, state.comm_state.center
        pull_err = center_err = 0.0
        for k in after:
            x, c = before[k].double(), c0[k].double()[None]
            pull = EASGD_ALPHA * (x - c)
            pull_err = max(pull_err, (after[k].double() - (x - pull))
                           .abs().max().item())
            center_err = max(center_err, (c1[k].double() - c0[k].double()
                                          - pull.sum(0)).abs().max().item())
        out.update(pull_max_abs_err=pull_err, center_max_abs_err=center_err,
                   tol=1e-6)
        ok = pull_err <= 1e-6 and center_err <= 1e-6
    if not ok:
        raise AssertionError(f"baselines/{rule}: invariant {out}")
    return out


def mlp_run(rule, dev, perturb=0.0):
    """The MLP run of ``rule`` through the port's Trainer on ``dev``, from
    the port's init plus ``perturb`` times seeded noise; returns each
    round's metrics and params (on the host)."""
    import torch
    from repro_torch.configs import TrainConfig, WASGDConfig
    from repro_torch.data import OrderedDataset, make_classification
    from repro_torch.models import classification_loss, init_mlp, mlp_apply
    from repro_torch.train import Trainer

    def loss_fn(params, batch):
        return classification_loss(mlp_apply(params, batch["x"]),
                                   batch["y"]), {}

    X, y = make_classification(0, 8192, d=MLP["d"],
                               n_classes=MLP["classes"], noise=0.25)
    n = MLP["n_samples"]
    params = init_mlp(0, MLP["d"], MLP["hidden"], MLP["classes"],
                      device="cpu")
    gen = torch.Generator().manual_seed(1)
    params = {k: v + perturb * torch.randn(v.shape, generator=gen)
              for k, v in params.items()}
    tr = Trainer(loss_fn, params,
                 {k: (None,) * v.dim() for k, v in params.items()},
                 TrainConfig(learning_rate=MLP["lr"], optimizer="sgd",
                             wasgd=WASGDConfig(tau=MLP["tau"], beta=0.9)),
                 MLP["p"], rule=rule, device=dev)
    ds = OrderedDataset({"x": X[:n], "y": y[:n]}, MLP["p"], MLP["tau"],
                        MLP["b_local"], n_segments=MLP["n_segments"],
                        seed=MLP["order_seed"])
    snaps, step = [], tr._step

    def recording_step(state, batch):
        out = step(state, batch)
        snaps.append({k: v.cpu() for k, v in out[0].params.items()})
        return out

    tr._step = recording_step
    tr.run(ds, MLP["rounds"])
    return tr.history, snaps


def mlp_devs(a, b):
    """Per round: max |params| difference, max relative h/loss difference
    and max |theta| difference between two runs."""
    out = []
    for (ha, pa), (hb, pb) in zip(zip(*a), zip(*b)):
        rel = max(float((np.abs(ha[k] - hb[k])
                         / np.maximum(np.abs(hb[k]), 1e-30)).max())
                  for k in ("h", "loss", "loss_last"))
        out.append((max((pa[k] - pb[k]).abs().max().item() for k in pb), rel,
                    float(np.abs(ha["theta"] - hb["theta"]).max())))
    return out


def mlp_card_vs_cpu(rule, dev):
    """Each round: card against CPU within max(the CPU tests' tolerance,
    twice the CPU run's spread under ``MLP["perturb"]``)."""
    cpu = mlp_run(rule, "cpu")
    dev_ = mlp_devs(mlp_run(rule, dev), cpu)
    spread = mlp_devs(mlp_run(rule, "cpu", MLP["perturb"]), cpu)
    tol = (MLP_TOL["params_atol"], MLP_TOL["h_loss_rtol"],
           MLP_TOL["theta_atol"])
    for r, (d, sp) in enumerate(zip(dev_, spread)):
        lim = [max(t, 2 * x) for t, x in zip(tol, sp)]
        if not all(x <= y for x, y in zip(d, lim)):
            raise AssertionError(f"baselines/{rule}: MLP round {r}: card vs "
                                 f"CPU (params, h/loss rel, theta) {d} over "
                                 f"{lim} (CPU spread {sp})")
    names = ("params", "h_loss_rel", "theta")
    return {"card_vs_cpu": dict(zip(names, map(max, zip(*dev_)))),
            "cpu_spread": dict(zip(names, map(max, zip(*spread)))),
            "rounds_over_tests_tol": sum(
                any(x > t for x, t in zip(d, tol)) for d in dev_)}


def phase_baselines(dev, wasgd_s_per_round):
    """The CNN6 training smoke's settings (``TRAIN``) with each baseline
    rule: a throwaway trainer for 2 warm-up rounds, then a fresh one for
    ``BASELINE_ROUNDS`` timed rounds, one invariant round on the card, and
    the MLP harness run on the card against the CPU."""
    import torch
    res = {}
    for rule in BASELINE_RULES:
        warm, _, dataset = new_baseline_trainer(dev, rule)
        run_trainer(warm, dataset, 2)
        del warm
        tr, loss_fn, dataset = new_baseline_trainer(dev, rule)
        torch.cuda.reset_peak_memory_stats()
        wall, ds = run_trainer(tr, dataset, BASELINE_ROUNDS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = tr.losses()
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"baselines/{rule}: losses {losses}")
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in next(ds.batches(BASELINE_ROUNDS)).items()}
        inv = rule_invariant(tr, rule, loss_fn, batch)
        res[rule] = {"seconds_per_round": wall / BASELINE_ROUNDS,
                     "vs_wasgd+": wall / BASELINE_ROUNDS / wasgd_s_per_round,
                     "loss_first": float(losses[0]),
                     "loss_last": float(losses[-1]),
                     "peak_mem_gib": peak, "invariant": inv,
                     "mlp_card_vs_cpu": mlp_card_vs_cpu(rule, dev)}
        del tr
    return {"phase": "baselines", "model": "cnn6", **TRAIN,
            "backend": "einsum:f32 (the baseline rules aggregate in float32 "
                       "torch ops, as JAX's do)",
            "easgd_alpha": EASGD_ALPHA,
            "wasgd+_seconds_per_round": wasgd_s_per_round, "rules": res,
            "mlp": MLP, "mlp_tol": MLP_TOL}


def state_bitwise_equal(a, b):
    import torch
    from repro_torch.checkpoint.io import _flatten
    fa, fb = _flatten(a), _flatten(b)
    return sorted(fa) == sorted(fb) and all(
        (torch.equal(fa[k], fb[k]) and fa[k].dtype == fb[k].dtype)
        if isinstance(fb[k], torch.Tensor) else fa[k] == fb[k] for k in fb)


def phase_checkpoint(dev):
    """CNN6 (``TRAIN``'s settings): 2 rounds, ``save_checkpoint`` (sharded,
    in the background), a resume into a fresh trainer (the state bitwise
    equal), and a run resumed from that checkpoint for 2 more rounds
    against 4 rounds straight through, twice (bitwise). cuDNN runs
    deterministic algorithms in this phase: its default weight gradients
    differ in the last bit from run to run."""
    import tempfile
    import torch
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "round_2")
            tr, dataset = new_trainer(dev)
            tr.run(dataset(), 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.save_checkpoint(path, 2)
            block_s = time.perf_counter() - t0
            tr._ckpt.wait()
            wait_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
            back, _ = new_trainer(dev)
            t0 = time.perf_counter()
            round_at = back.resume(path)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            same = state_bitwise_equal(back.state, tr.state)
            del back
            resumed, dataset = new_trainer(dev)
            resumed.run(dataset(), 4, resume_from=path)
            straight = []
            for _ in range(2):
                s, dataset = new_trainer(dev)
                s.run(dataset(), 4)
                straight.append(s)
            torch.cuda.synchronize()
            eq = [state_bitwise_equal(resumed.state, s.state)
                  for s in straight]
            straight_twice = state_bitwise_equal(straight[0].state,
                                                 straight[1].state)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    if not (same and round_at == 2 and all(eq)):
        raise AssertionError(f"checkpoint: restored state equal {same} "
                             f"(round {round_at}); resumed run equal to the "
                             f"straight runs {eq} (straight runs equal each "
                             f"other: {straight_twice})")
    return {"phase": "checkpoint", "model": "cnn6", "p": TRAIN["p"],
            "format": "wasgd-sharded-v1, one shard", "bytes": nbytes,
            "save_blocks_s": block_s, "save_to_wait_s": wait_s,
            "resume_s": restore_s, "restored_bitwise": same,
            "resumed_run_bitwise_equals_straight": eq,
            "straight_runs_bitwise_equal": straight_twice,
            "cudnn": "deterministic"}


# -- Alg. 4 straggler rounds and elastic membership --------------------------

# p + b workers of the async phases, the straggler regimes of
# benchmarks/async_straggler.py:44-48 (StepTimeModel(seed=3))
ASYNC = {"p": 6, "b": 2, "warmup_rounds": 2, "rounds": 30, "seed": 3}
REGIMES = {"uniform": {"sigma": 0.05, "straggle_p": 0.0},
           "stragglers": {"sigma": 0.2, "straggle_p": 0.05,
                          "straggle_mult": 20.0}}
# async_agree: the MLP harness (MLP), p 4 + b 2, 4 rounds, the CPU tests'
# schedule (tests/test_torch_async.py)
ASYNC_AGREE = {"p": 4, "b": 2, "tau": 2, "rounds": 4, "lr": 0.05,
               "sigma": 0.3, "straggle_p": 0.2, "straggle_mult": 10,
               "seed": 3, "atol": 1e-5}
MEASURED = {"rounds": 10, "policy": "ema(0.9)|time_aware"}
LM_ASYNC = {"p": 3, "b": 1, "warmup_rounds": 2, "rounds": 3,
            "regime": "stragglers", "atol": 1e-4}
ELASTIC = {"rounds": 30, "events": {10: 6, 20: 10}, "chaos_seed": 7,
           "resume_p": (6, 10)}


def worker_grad_fn(loss_fn):
    """``grad_fn(params_stacked, batch) -> (losses (w,), grads)`` for
    ``run_parallel_sgd`` and ``run_parallel_sgd_on_device``: autograd
    through the vmapped loss, as the round's ``worker_grads`` takes it."""
    import torch
    from torch.func import vmap
    from repro_torch.tree import tree_leaves, tree_map

    def grad_fn(ps, batch):
        with torch.enable_grad():
            tracked = tree_map(lambda x: x.detach().requires_grad_(), ps)
            losses = vmap(lambda p, b: loss_fn(p, b)[0])(tracked, batch)
            flat = iter(torch.autograd.grad(losses.sum(),
                                            tree_leaves(tracked)))
        return losses.detach(), tree_map(lambda x: next(flat), tracked)
    return grad_fn


def wagg_tree_plan(params, axes, spec):
    """(worker leaves, wagg_fused launches) of one meshless aggregate of
    this tree under a ``pallas_wagg`` spec (``core.backends.
    pallas_wagg_plan``: f32 payloads in one call, grouped by dtype pair,
    at most MAX_LEAVES leaves a launch)."""
    from repro_torch.core.aggregate import is_worker_leaf
    from repro_torch.core.backends import resolve_spec
    from repro_torch.tree import tree_leaves
    return wagg_leaves_plan([x for x, ax in zip(tree_leaves(params),
                                                tree_leaves(axes))
                             if is_worker_leaf(ax)],
                            resolve_spec(spec)[1] or "f32")


def wagg_leaves_plan(leaves, codec="f32"):
    """(leaves, wagg_fused launches) of one meshless aggregate of these
    worker leaves with the codec named."""
    from repro_torch.core.backends import pallas_wagg_plan
    return len(leaves), len(pallas_wagg_plan(
        [(x.numel(), x.dtype) for x in leaves], codec))


def wagg_counts(name, aggregates, plan, masked=0, prof=None):
    """wagg_fused's counters, zeroed before the run, against ``aggregates``
    aggregates of ``plan`` = (worker leaves, launches) each, ``masked`` of
    them masked; with a profile, its wagg_fused device kernels (all,
    masked) against the launches. Returns the counts."""
    from repro_torch.kernels.wagg import wagg_fused
    leaves, launches = plan
    got = {"launches": wagg_fused.launches, "leaves": wagg_fused.leaves,
           "masked_launches": wagg_fused.masked_launches}
    want = {"launches": aggregates * launches,
            "leaves": aggregates * leaves,
            "masked_launches": masked * launches}
    if prof is not None:
        got["device_kernels"], got["device_kernels_masked"] = \
            wagg_device_kernels(prof)
        want["device_kernels"] = want["launches"]
        want["device_kernels_masked"] = want["masked_launches"]
    if got != want:
        raise AssertionError(f"{name}: wagg_fused {got}, want {want}")
    return got


def wagg_payload_cap(params, axes, spec):
    """Payload bytes a batch of the grouped aggregate of this tree may hold
    (``core.backends.payload_batches``): the cap, or the largest leaf's
    payload where that is larger."""
    from repro_torch.core import get_codec, is_worker_leaf
    from repro_torch.core.backends import (WAGG_PAYLOAD_CAP, payload_bytes,
                                           resolve_spec)
    from repro_torch.tree import tree_leaves
    name = resolve_spec(spec)[1] or "f32"
    wire = get_codec(name).wire_dtype
    return max([WAGG_PAYLOAD_CAP] + [
        payload_bytes(x.numel(), name, wire)
        for x, ax in zip(tree_leaves(params), tree_leaves(axes))
        if is_worker_leaf(ax)])


def reset_wagg():
    from repro_torch.kernels.wagg import wagg_fused
    wagg_fused.launches = wagg_fused.leaves = wagg_fused.masked_launches = 0


@contextlib.contextmanager
def wagg_watched(on_leaf):
    """Calls ``on_leaf(x, out, ref, payload)`` for every leaf of every
    grouped call the ``pallas_wagg`` schedule makes inside the block:
    ``ref`` the plain version on the same inputs (the scale folded into
    theta as the kernel folds it)."""
    from repro_torch.kernels.wagg import ops as wagg_ops
    from repro_torch.kernels.wagg import wagg_fused_ref
    real = wagg_ops.wagg_fused_many

    def watched(xs, theta, beta, payloads=None, scales=None, active=None):
        outs = real(xs, theta, beta, payloads=payloads, scales=scales,
                    active=active)
        for i, (x, out) in enumerate(zip(xs, outs)):
            q = None if payloads is None else payloads[i]
            s = None if scales is None else scales[i]
            t = theta if s is None else theta * s.float()
            on_leaf(x, out, wagg_fused_ref(x, t, beta, payload=q,
                                           active=active), q)
        return outs

    wagg_ops.wagg_fused_many = watched
    try:
        yield
    finally:
        wagg_ops.wagg_fused_many = real


def wagg_device_kernels(prof):
    """wagg_fused device kernels of a profile: (all, masked). The masked
    instantiation carries MASKED=true (``...true>`` demangled, ``Lb1E``
    mangled)."""
    import torch
    n = masked = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and "wagg_fused_kernel" in e.key:
            n += e.count
            if "true>" in e.key or "Lb1E" in e.key:
                masked += e.count
    return n, masked


def mlp_async_run(dev, strategy, perturb=0.0):
    """ASYNC_AGREE's schedule on the MLP harness: through
    ``run_parallel_sgd_on_device`` (pallas_wagg) on ``dev``, or through the
    port's host simulation ``run_parallel_sgd`` on the CPU (``dev`` None),
    from the port's init plus ``perturb`` times seeded noise."""
    import torch
    from repro_torch.core import async_device, async_sim
    from repro_torch.data import make_classification
    from repro_torch.models import classification_loss, init_mlp, mlp_apply
    a = ASYNC_AGREE
    w = a["p"] + a["b"]

    def loss_fn(params, batch):
        return classification_loss(mlp_apply(params, batch["x"]),
                                   batch["y"]), {}

    X, y = make_classification(0, 8192, d=MLP["d"],
                               n_classes=MLP["classes"], noise=0.25)
    X, y = X[:MLP["n_samples"]], y[:MLP["n_samples"]]

    def batches():
        rng = np.random.default_rng(0)
        while True:
            idx = rng.integers(0, len(X), size=(w, a["tau"] * MLP["b_local"]))
            yield {"x": X[idx], "y": y[idx]}

    params = init_mlp(0, MLP["d"], MLP["hidden"], MLP["classes"],
                      device="cpu")
    gen = torch.Generator().manual_seed(1)
    params = {k: v + perturb * torch.randn(v.shape, generator=gen)
              for k, v in params.items()}
    axes = {k: (None,) * v.dim() for k, v in params.items()}
    sched = async_sim.make_schedule(
        async_sim.StepTimeModel(w, sigma=a["sigma"],
                                straggle_p=a["straggle_p"],
                                straggle_mult=a["straggle_mult"],
                                seed=a["seed"]),
        rounds=a["rounds"], tau=a["tau"], n_workers=a["p"], backups=a["b"])
    kw = dict(n_workers=a["p"], backups=a["b"], tau=a["tau"],
              rounds=a["rounds"], lr=a["lr"], schedule=sched,
              strategy=strategy)
    if dev is None:
        return async_sim.run_parallel_sgd(loss_fn, worker_grad_fn(loss_fn),
                                          params, axes, batches(), **kw), sched
    return async_device.run_parallel_sgd_on_device(
        worker_grad_fn(loss_fn), params, axes, batches(),
        backend="pallas_wagg", device=dev, **kw), sched


def phase_async_agree(dev):
    """Alg. 4 on the card against the port's host simulation on the CPU:
    the MLP harness, one schedule (p 4 + b 2, 4 rounds), strategies
    boltzmann and best; params and losses within max(1e-5, twice the CPU
    run's own spread under a 1e-7 perturbation of its start). The card
    run goes through the masked wagg_fused, counted by its wrapper and by
    the profiler."""
    import torch
    out = {}
    for strategy in ("boltzmann", "best"):
        cpu, sched = mlp_async_run(None, strategy)
        spread_run, _ = mlp_async_run(None, strategy, perturb=1e-7)
        reset_wagg()
        with device_profile() as prof:
            card, _ = mlp_async_run(dev, strategy)
            torch.cuda.synchronize()
        counts = wagg_counts(f"async_agree/{strategy}",
                             ASYNC_AGREE["rounds"],
                             wagg_leaves_plan(list(card.params.values())),
                             masked=ASYNC_AGREE["rounds"], prof=prof)
        launches = (counts["launches"], counts["masked_launches"])
        kernels = (counts["device_kernels"], counts["device_kernels_masked"])

        def dev_of(a, b):
            return (max((a.params[k].cpu() - b.params[k]).abs().max().item()
                        for k in b.params),
                    float(np.abs(a.losses - b.losses).max()))

        got, spread = dev_of(card, cpu), dev_of(spread_run, cpu)
        lim = [max(ASYNC_AGREE["atol"], 2 * x) for x in spread]
        finite = all(bool(torch.isfinite(v).all())
                     for v in card.params.values())
        if not (finite and got[0] <= lim[0] and got[1] <= lim[1]
                and card.wall == cpu.wall
                and card.dropped_rounds == cpu.dropped_rounds):
            raise AssertionError(f"async_agree/{strategy}: card vs CPU "
                                 f"(params, losses) {got} over {lim}, "
                                 f"finite {finite}, wall {card.wall} vs "
                                 f"{cpu.wall}, dropped {card.dropped_rounds}"
                                 f" vs {cpu.dropped_rounds}")
        out[strategy] = {"card_vs_cpu": {"params": got[0], "losses": got[1]},
                         "cpu_spread": {"params": spread[0],
                                        "losses": spread[1]},
                         "limit": lim, "losses": card.losses.tolist(),
                         "sim_wall": card.wall,
                         "dropped_worker_rounds": card.dropped_rounds,
                         "wagg_launches_masked": launches[1],
                         "wagg_leaves": counts["leaves"],
                         "wagg_device_kernels_masked": kernels[1]}
    return {"phase": "async_agree", "model": "mlp", "mlp": MLP,
            **ASYNC_AGREE, "backend": "pallas_wagg (card), einsum host "
            "simulation (CPU)", "active_per_round":
            sched.active.astype(int).tolist(), "strategies": out}


def async_train_run(dev, regime, sync):
    """One timed run of ``phase_async_train``: a fresh trainer, 30 rounds
    of Alg. 4 (the regime's schedule through ``straggler_schedule=``) or
    Alg. 1 (the synchronous trainer); each round's mask and theta
    checked; returns the trainer, the schedule and the record."""
    import torch
    from repro_torch.core.async_sim import StepTimeModel, make_schedule
    p, b, rounds = ASYNC["p"], ASYNC["b"], ASYNC["rounds"]
    w = p + b
    name = f"async_train/{regime}/{'alg1' if sync else 'alg4'}"
    sched = make_schedule(StepTimeModel(w, seed=ASYNC["seed"],
                                        **REGIMES[regime]),
                          rounds=rounds, tau=TRAIN["tau"], n_workers=p,
                          backups=b, synchronous=sync)
    kw = {} if sync else {"straggler_schedule": sched}
    tr, dataset = new_trainer(dev, w, "host_sim" if sync else "on_device")
    torch.cuda.reset_peak_memory_stats()
    reset_wagg()
    wall, _ = run_trainer(tr, dataset, rounds, **kw)
    counts = wagg_counts(name, rounds, wagg_tree_plan(
        tr.state.params, tr.axes, TRAIN["backend"]),
        masked=0 if sync else rounds)
    launches = (counts["launches"], counts["masked_launches"])
    for r, h in enumerate(tr.history):
        act = sched.active[r]
        rec = h.get("active", np.ones(w, np.float32))
        if not (np.array_equal(rec, act.astype(np.float32))
                and (h["theta"][~act] == 0.0).all()
                and abs(float(h["theta"].sum()) - 1.0) <= 1e-5):
            raise AssertionError(f"{name} round {r}: active {rec} vs {act}, "
                                 f"theta {h['theta']}")
    losses = tr.losses()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: losses {losses}")
    return tr, dataset, sched, {
        "seconds_per_round": wall / rounds,
        "sim_wall": float(sched.round_wall.sum()),
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "dropped_worker_rounds": int((~sched.active).sum()),
        "wagg_launches": launches[0], "wagg_masked_launches": launches[1],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_async_train(dev):
    """CNN6 at the training smoke's settings with w = p 6 + b 2 workers,
    in each straggler regime: Alg. 4 through
    ``Trainer.run(straggler_schedule=)`` (``async_mode="on_device"``,
    pallas_wagg:f32, the masked kernel) and Alg. 1 (the synchronous
    trainer, unmasked). After a throwaway trainer's 2 warm-up rounds of
    each, four fresh trainers run 30 rounds in the order Alg. 4, Alg. 1,
    Alg. 1, Alg. 4 (the host's speed drifts within a call): s/round on
    the card; the simulated wall of each schedule (the paper's Sec. 3.5
    quantity, which the card does not measure); per round the recorded
    mask equals the schedule's, the stragglers' theta is exactly 0 and
    theta sums to 1. Then 5 rounds of the stragglers regime's Alg. 4
    trainer under the profiler: idle share and masked device kernels."""
    from repro_torch.core.async_sim import StepTimeModel, make_schedule
    w = ASYNC["p"] + ASYNC["b"]
    res, masked = {}, 0
    for regime in REGIMES:
        for sync in (False, True):
            sched = make_schedule(
                StepTimeModel(w, seed=ASYNC["seed"], **REGIMES[regime]),
                rounds=ASYNC["warmup_rounds"], tau=TRAIN["tau"],
                n_workers=ASYNC["p"], backups=ASYNC["b"], synchronous=sync)
            warm, dataset = new_trainer(dev, w, "host_sim" if sync else
                                        "on_device")
            run_trainer(warm, dataset, ASYNC["warmup_rounds"],
                        **({} if sync else {"straggler_schedule": sched}))
            del warm
        runs = {"alg4": [], "alg1": []}
        for sync in (False, True, True, False):
            tr, dataset, sched, rec = async_train_run(dev, regime, sync)
            runs["alg1" if sync else "alg4"].append(rec)
            masked += rec["wagg_masked_launches"]
            if regime == "stragglers" and not sync \
                    and len(runs["alg4"]) == 2:
                prof_rounds, kw = 5, {"straggler_schedule": sched}
                wall5, _ = run_trainer(tr, dataset, prof_rounds, **kw)
                reset_wagg()
                with device_profile() as prof:
                    run_trainer(tr, dataset, prof_rounds, **kw)
                counts = wagg_counts(
                    "async_train profile", prof_rounds, wagg_tree_plan(
                        tr.state.params, tr.axes, TRAIN["backend"]),
                    masked=prof_rounds, prof=prof)
                kernels = (counts["device_kernels"],
                           counts["device_kernels_masked"])
                rec["profile"] = {
                    "rounds": prof_rounds, "wall_ms": wall5 * 1e3,
                    "wagg_device_kernels_masked": kernels[1],
                    **device_summary(prof, wall5, 8)}
            del tr
        out = {}
        for mode, recs in runs.items():
            out[mode] = {**recs[0], "runs_s_per_round": [
                r["seconds_per_round"] for r in recs],
                "seconds_per_round": float(np.mean(
                    [r["seconds_per_round"] for r in recs]))}
            if "profile" in recs[-1]:
                out[mode]["profile"] = recs[-1]["profile"]
        out["alg4_over_alg1_s_per_round"] = (
            out["alg4"]["seconds_per_round"]
            / out["alg1"]["seconds_per_round"])
        out["sim_wall_alg1_over_alg4"] = (out["alg1"]["sim_wall"]
                                          / out["alg4"]["sim_wall"])
        res[regime] = {"time_model": {"seed": ASYNC["seed"],
                                      **REGIMES[regime]}, **out}
    return {"phase": "async_train", "model": "cnn6", **TRAIN, **ASYNC,
            "w": w, "rule": "wasgd+", "order": "alg4, alg1, alg1, alg4",
            "regimes": res, "masked_launches": masked}


def phase_async_measured(dev):
    """``run_parallel_sgd_on_device(measure_times=True)`` with
    ``ema(0.9)|time_aware`` on CNN6 (p 6 + b 2, one SGD step a round on a
    (w, 64) image batch, 10 rounds): the measured round times and masks.
    One card runs every worker in one program, so every worker gets the
    same time and the first p workers aggregate every round."""
    import torch
    from repro_torch.core.async_device import run_parallel_sgd_on_device
    from repro_torch.data import make_images
    from repro_torch.models import init_cnn6
    loss_fn, _, _ = cnn6_setup()
    p, b, rounds = ASYNC["p"], ASYNC["b"], MEASURED["rounds"]
    w = p + b
    X, y = make_images(0, TRAIN["n_images"])

    def batches():
        rng = np.random.default_rng(0)
        while True:
            idx = rng.integers(0, len(X), size=(w, TRAIN["b_local"]))
            yield {"x": X[idx], "y": y[idx]}

    params = init_cnn6(0, device=dev)
    reset_wagg()
    t0 = time.perf_counter()
    res = run_parallel_sgd_on_device(
        worker_grad_fn(loss_fn), params,
        {k: (None,) * v.dim() for k, v in params.items()}, batches(),
        n_workers=p, backups=b, tau=1, rounds=rounds, lr=TRAIN["lr"],
        measure_times=True, policy=MEASURED["policy"], backend="pallas_wagg",
        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = wagg_counts("async_measured", rounds,
                         wagg_leaves_plan(list(params.values())),
                         masked=rounds)
    launches = (counts["launches"], counts["masked_launches"])
    times = res.round_times
    equal = bool((times == times[:, :1]).all())
    if not (equal and np.isfinite(res.losses).all()
            and res.dropped_rounds == rounds * b):
        raise AssertionError(f"async_measured: times equal per round "
                             f"{equal}, launches {launches}, losses "
                             f"{res.losses}, dropped {res.dropped_rounds}")
    return {"phase": "async_measured", "model": "cnn6", "p": p, "b": b,
            "rounds": rounds, "policy": MEASURED["policy"],
            "backend": "pallas_wagg", "b_local": TRAIN["b_local"],
            "round_times_ms": (times * 1e3).tolist(),
            "active_workers_each_round": list(range(p)),
            "measured_wall_s": res.wall, "seconds_per_round": wall / rounds,
            "losses": res.losses.tolist(),
            "dropped_worker_rounds": res.dropped_rounds,
            "wagg_launches": launches[0], "wagg_masked_launches": launches[1],
            "wagg_leaves": counts["leaves"]}


def check_resize(tr, events):
    """Wraps ``tr.resize``: on the card, survivors' rows bitwise unchanged
    and newcomers' rows the equal-weight aggregate within 1e-6 (against
    float64); records the resize's milliseconds."""
    import torch
    real = tr.resize

    def resize(new_p, round=None):
        before = {k: v.clone() for k, v in tr.state.params.items()}
        old_p = tr.n_workers
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = real(new_p, round=round)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        keep = min(old_p, new_p)
        survivors = all(torch.equal(tr.state.params[k][:keep], v[:keep])
                        for k, v in before.items())
        new_err = max(((tr.state.params[k][old_p:].double()
                        - v.double().mean(0, keepdim=True)).abs().max()
                       .item() if new_p > old_p else 0.0)
                      for k, v in before.items())
        if not (survivors and new_err <= 1e-6):
            raise AssertionError(f"elastic: resize {old_p} -> {new_p} at "
                                 f"round {round}: survivors bitwise "
                                 f"{survivors}, newcomers vs aggregate "
                                 f"{new_err}")
        events.append({"round": round, "old_p": old_p, "new_p": new_p,
                       "ms": ms, "newcomer_max_abs_err": new_err})
        return ev

    tr.resize = resize


def elastic_run(dev, sched):
    """A CNN6 trainer (``TRAIN``'s settings, an OrderedDataset) through
    ``run(membership_schedule=sched)``: per-round seconds by p, each
    resize checked and timed."""
    tr, dataset = new_trainer(dev, sched.p0)
    events, stamps = [], []
    check_resize(tr, events)
    reset_wagg()
    t0 = time.perf_counter()
    wall, _ = run_trainer(tr, dataset, ELASTIC["rounds"],
                          membership_schedule=sched,
                          serve_hook=lambda r, ps, ax: stamps.append(
                              time.perf_counter()))
    per_round = np.diff([t0] + stamps)
    by_p = {}
    for h, s in zip(tr.history, per_round):
        by_p.setdefault(int(h["p"]), []).append(float(s))
    ps = [int(h["p"]) for h in tr.history]
    want = [sched.p_of(r) for r in range(ELASTIC["rounds"])]
    losses = tr.losses()
    counts = wagg_counts("elastic", ELASTIC["rounds"], wagg_tree_plan(
        tr.state.params, tr.axes, TRAIN["backend"]))
    if ps != want or not np.isfinite(losses).all():
        raise AssertionError(f"elastic: p by round {ps}, want {want}; "
                             f"losses {losses}")
    return {"events": events, "wall_s": wall,
            "median_s_per_round_by_p": {p: float(np.median(v))
                                        for p, v in sorted(by_p.items())},
            "rounds_by_p": {p: len(v) for p, v in sorted(by_p.items())},
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "wagg_launches": counts["launches"],
            "wagg_leaves": counts["leaves"]}


def phase_elastic(dev, fixed_p_loss_last):
    """Elastic membership on CNN6: a scripted schedule (p 8, 6 at round
    10, 10 at round 20) and a seeded chaos walk, 30 rounds each; then a
    sharded checkpoint at p = 8 resumed at p = 6 and p = 10, equal
    bitwise to ``resize_train_state`` of the saved state."""
    import tempfile
    import torch
    from repro_torch.core.membership import (MembershipSchedule,
                                             make_chaos_schedule,
                                             resize_train_state)
    scripted = MembershipSchedule(TRAIN["p"], ELASTIC["events"])
    chaos = make_chaos_schedule(TRAIN["p"], ELASTIC["rounds"],
                                seed=ELASTIC["chaos_seed"])
    runs = {"scripted": {"events_scheduled": scripted.events,
                         **elastic_run(dev, scripted)},
            "chaos": {"events_scheduled": chaos.events,
                      **elastic_run(dev, chaos)}}
    resumes = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "p8")
        tr, dataset = new_trainer(dev)
        tr.run(dataset(), 2)
        tr.save_checkpoint(path, 2)
        tr._ckpt.wait()
        for new_p in ELASTIC["resume_p"]:
            back, _ = new_trainer(dev, new_p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            at = back.resume(path)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            expect = resize_train_state(tr.state, tr.axes, new_p)
            same = state_bitwise_equal(back.state, expect)
            if not (same and at == 2 and back.n_workers == new_p):
                raise AssertionError(f"elastic: resume at p={new_p}: "
                                     f"bitwise {same}, round {at}")
            resumes[new_p] = {"bitwise_equal_resize_of_saved": same,
                              "resume_ms": ms}
            del back
        del tr
    return {"phase": "elastic", "model": "cnn6", **TRAIN,
            "rounds": ELASTIC["rounds"], "runs": runs,
            "checkpoint_p8_resumed_at": resumes,
            "fixed_p_train_loss_last": fixed_p_loss_last}


def rmsnorm_case(x, s, gen):
    """One rmsnorm case: forward through the kernel against the plain
    version; backward through the Function (kernel forward, PyTorch
    backward) against autograd of the plain version, for the same output
    cotangent. Returns the errors relative to max|plain|."""
    import torch
    from repro_torch.kernels.rmsnorm import (RMSNormFunction, rmsnorm_fwd,
                                             rmsnorm_fwd_ref)
    y, rstd = rmsnorm_fwd(x, s)
    y_ref, rstd_ref = rmsnorm_fwd_ref(x, s)
    g = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    grads = []
    for fn in (lambda a, b: RMSNormFunction.apply(a, b, 1e-6)[0],
               lambda a, b: rmsnorm_fwd_ref(a, b)[0]):
        xa, sa = x.clone().requires_grad_(), s.clone().requires_grad_()
        fn(xa, sa).backward(g)
        grads.append((xa.grad, sa.grad))
    torch.cuda.synchronize()
    for name, t in (("y", y), ("rstd", rstd), ("dx", grads[0][0]),
                    ("dscale", grads[0][1])):
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"rmsnorm: non-finite {name}")
    if y.dtype != x.dtype or y.shape != x.shape:
        raise AssertionError(f"rmsnorm: output {y.shape} {y.dtype}")
    return {"y": rel_err(y, y_ref), "rstd": rel_err(rstd, rstd_ref),
            "dx": rel_err(grads[0][0], grads[1][0]),
            "dscale": rel_err(grads[0][1], grads[1][1])}


def add_rmsnorm_case(x, delta, s, gen):
    """One case of the fused residual add: s bitwise against torch's
    ``x + delta``, y and rstd against the plain version; the backward
    through the Function (cotangents on s and y) against autograd of the
    plain add and norm. Returns the errors relative to max|plain|."""
    import torch
    from repro_torch.kernels.rmsnorm import (AddRMSNormFunction,
                                             add_rmsnorm_fwd,
                                             add_rmsnorm_fwd_ref)
    out_s, y, rstd = add_rmsnorm_fwd(x, delta, s)
    s_ref, y_ref, rstd_ref = add_rmsnorm_fwd_ref(x, delta, s)
    torch.cuda.synchronize()
    if not torch.equal(out_s, x + delta):
        raise AssertionError("add_rmsnorm: s differs from torch's x + delta "
                             "in some bit")
    g_s, g_y = (torch.randn(x.shape, generator=gen, device=x.device)
                .to(x.dtype) for _ in range(2))
    grads = []
    for fn in (lambda a, b, c: AddRMSNormFunction.apply(a, b, c, 1e-6)[:2],
               lambda a, b, c: add_rmsnorm_fwd_ref(a, b, c)[:2]):
        xa, da, sa = (t.clone().requires_grad_() for t in (x, delta, s))
        torch.autograd.backward(fn(xa, da, sa), (g_s, g_y))
        grads.append((xa.grad, da.grad, sa.grad))
    torch.cuda.synchronize()
    for name, t in (("y", y), ("rstd", rstd), ("dx", grads[0][0]),
                    ("ddelta", grads[0][1]), ("dscale", grads[0][2])):
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"add_rmsnorm: non-finite {name}")
    return {"y": rel_err(y, y_ref), "rstd": rel_err(rstd, rstd_ref),
            "dx": rel_err(grads[0][0], grads[1][0]),
            "ddelta": rel_err(grads[0][1], grads[1][1]),
            "dscale": rel_err(grads[0][2], grads[1][2])}


RMS_CHECK = {"d": [1152, 2048, 2560, 1000, 1001, 4096],
             "rows": [1, 4, 640, 2560, 2561], "groups": [1, 3, 4]}


def phase_rmsnorm_check(dev):
    """rmsnorm against its plain version over dtype x d x rows x groups:
    d = 1152 (gemma3-1b), 2048 (stablelm-1.6b), 2560 (stablelm-3b), 1000
    (16-byte vectors), 1001 (the one-element path) and 4096 (yi-6b; past
    the 2048 elements a warp holds in registers: the two-pass path); rows
    1, 4 (a decode step), 640 (a worker's local step of the LM runs),
    2560, 2561; G = 1 (one scale), 3 (x (3, rows, d), a scale per worker:
    the stablelm-3b round) or 4 (the gemma3-1b round). The fused residual add over the same
    grid, its s bitwise equal to torch's x + delta. One case of each starts
    one element past an aligned base."""
    import torch
    from repro_torch.kernels.rmsnorm.rmsnorm import vector_width
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    worst, n_cases, paths = {}, 0, set()

    def record(key, errs, dname):
        nonlocal n_cases
        for k, e in errs.items():
            tol = (RMS_TOL[dname] if k in ("y", "rstd") else
                   RMS_GRAD_TOL[dname] if k in ("dx", "ddelta") else 1e-4)
            if not e <= tol:
                raise AssertionError(f"rmsnorm {key} {k}: rel_err {e} > {tol}")
            wk = ("fused/" if key.startswith("fused/") else "") + \
                f"{dname}/{k}"
            worst[wk] = max(worst.get(wk, 0.0), e)
        n_cases += 1

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for d in RMS_CHECK["d"]:
            for rows in RMS_CHECK["rows"]:
                for groups in RMS_CHECK["groups"]:
                    shape = (rows, d) if groups == 1 else (groups, rows, d)
                    x = torch.randn(shape, generator=gen, device=dev).to(dt)
                    delta = torch.randn(shape, generator=gen,
                                        device=dev).to(dt)
                    s = 1.0 + 0.5 * torch.randn(
                        (d,) if groups == 1 else (groups, d), generator=gen,
                        device=dev)
                    paths.add((dname, d, vector_width(d, x)))
                    key = f"{dname}/d{d}/rows{rows}/G{groups}"
                    record(key, rmsnorm_case(x, s, gen), dname)
                    record(f"fused/{key}", add_rmsnorm_case(x, delta, s, gen),
                           dname)
                    del x, delta, s
        buf = torch.randn(2, 4 * 1152 + 1, generator=gen, device=dev).to(dt)
        x, delta = buf[0, 1:].view(4, 1152), buf[1, 1:].view(4, 1152)
        s = 1.0 + 0.5 * torch.randn(1152, generator=gen, device=dev)
        paths.add((dname, "1152 unaligned", vector_width(1152, x)))
        record(f"{dname}/unaligned", rmsnorm_case(x, s, gen), dname)
        record(f"fused/{dname}/unaligned",
               add_rmsnorm_case(x, delta, s, gen), dname)
    return {"phase": "rmsnorm_check", "cases": n_cases, **RMS_CHECK,
            "fused_s_bitwise": True,
            "paths": sorted(map(str, paths)),
            "worst_rel_err": worst,
            "tol": {"y/rstd": RMS_TOL, "dx/ddelta": RMS_GRAD_TOL,
                    "dscale": 1e-4},
            "tol_reason": "rel. to max|plain|; y/rstd f32: order of the sum "
                          "of squares; bf16 output: one ulp (2^-8); dx and "
                          "dscale: the Function's formula against autograd "
                          "of the plain ops, dscale summed over <= 2561 rows"}


def norm_work(rows, d, x_bytes, groups, fused=False):
    """Bytes one call must move (x read, y written, the scales read, rstd
    written; fused: delta read and s written too) and its float32
    operations (4 per element, 5 fused)."""
    arrays = 4 if fused else 2
    return (arrays * rows * d * x_bytes + groups * d * 4 + rows * 4,
            (5 if fused else 4) * rows * d)


def phase_rmsnorm_time(dev):
    """rmsnorm at one local step of the LM run (x (4, 640, 1152) bf16, a
    scale per worker: G = 4, the vmap rule's launch) and at a decode step
    of the serve run (x (4, 1, 1152) bf16, one scale), each over working
    sets that together exceed the 50 MB L2: the plain norm (the first
    layer's), and the fused residual add and norm (every other norm of the
    models) beside its plain version and the library pair (x + delta, then
    F.rms_norm) in the same kind of graph."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import (add_rmsnorm_fwd,
                                             add_rmsnorm_fwd_ref,
                                             rmsnorm_fwd, rmsnorm_fwd_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    d = 1152
    res = {}
    for name, xshape, groups, n_sets in (
            ("train", (4, 640, d), 4, 16), ("decode", (4, 1, d), 1, 64)):
        sets = [(torch.randn(xshape, generator=gen, device=dev)
                 .to(torch.bfloat16),
                 1.0 + 0.5 * torch.randn((groups, d) if groups > 1 else (d,),
                                         generator=gen, device=dev))
                for _ in range(n_sets)]
        deltas = [torch.randn(xshape, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(n_sets)]
        # the library call takes one weight (d,) in x's dtype
        lib_w = [s.reshape(-1, d)[0].to(torch.bfloat16) for _, s in sets]

        def kern(i):
            return lambda: rmsnorm_fwd(*sets[i])

        def plain(i):
            return lambda: rmsnorm_fwd_ref(*sets[i])

        def library(i):
            return lambda: F.rms_norm(sets[i][0], (d,), lib_w[i], 1e-6)

        idx = range(n_sets)
        ms = graph_ms([kern(i) for i in idx], n_sets)
        plain_ms = graph_ms([plain(i) for i in idx], n_sets)
        library_ms = graph_ms([library(i) for i in idx], n_sets)
        x, s = sets[0]
        y, rstd = rmsnorm_fwd(x, s)
        y_ref, _ = rmsnorm_fwd_ref(x, s)
        err = assert_close(f"rmsnorm_time/{name}", y, y_ref,
                           RMS_TOL["bfloat16"] * y_ref.float().abs().max())
        rows = x.numel() // d
        bytes_moved, flops = norm_work(rows, d, 2, groups)
        t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_o = flops / F32_FLOP_PER_S * 1e3
        res[name] = {"x": list(xshape), "dtype": "bfloat16", "groups": groups,
                     "bytes": bytes_moved, "flops": flops,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "library": "F.rms_norm(x, (d,), one bf16 weight)",
                     "bound_ms": max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations",
                     "working_sets": n_sets}

        def fused(i):
            return lambda: add_rmsnorm_fwd(sets[i][0], deltas[i], sets[i][1])

        def fused_plain(i):
            return lambda: add_rmsnorm_fwd_ref(sets[i][0], deltas[i],
                                               sets[i][1])

        def fused_library(i):
            return lambda: F.rms_norm(sets[i][0] + deltas[i], (d,), lib_w[i],
                                      1e-6)

        ms = graph_ms([fused(i) for i in idx], n_sets)
        plain_ms = graph_ms([fused_plain(i) for i in idx], n_sets)
        library_ms = graph_ms([fused_library(i) for i in idx], n_sets)
        s_out, y, _ = add_rmsnorm_fwd(x, deltas[0], s)
        _, y_ref, _ = add_rmsnorm_fwd_ref(x, deltas[0], s)
        if not torch.equal(s_out, x + deltas[0]):
            raise AssertionError(f"rmsnorm_time/fused_{name}: s differs")
        err = assert_close(f"rmsnorm_time/fused_{name}", y, y_ref,
                           RMS_TOL["bfloat16"] * y_ref.float().abs().max())
        bytes_moved, flops = norm_work(rows, d, 2, groups, fused=True)
        t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_o = flops / F32_FLOP_PER_S * 1e3
        res[f"fused_{name}"] = {
            "x": list(xshape), "dtype": "bfloat16", "groups": groups,
            "bytes": bytes_moved, "flops": flops, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "x + delta, then F.rms_norm(s, (d,), one bf16 weight)",
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "working_sets": n_sets}
        del sets, lib_w, deltas
    return {"phase": "rmsnorm_time",
            "method": "CUDA graph of one call per working set, 10 replays, "
                      "CUDA events", **res}


CE_CHECK = {"V": [262144, 100352, 1000, 1001], "T": [1, 7, 2560],
            # stablelm-3b's padded vocabulary at one worker's tokens and at
            # the round's three workers' (the vmap rule's one launch), and
            # llama-3.2-vision's at one worker's and at vlm_train's two
            # workers' (one launch)
            "V_T": [[50432, 640], [50432, 1920], [128256, 640],
                    [128256, 1280]],
            # musicgen-large's codebook logits at the round's two workers:
            # (p, seq, n_q, V), a row a (worker, position, codebook)
            "codebook": [2, 640, 4, 2048]}


def phase_ce_check(dev):
    """fused_ce against its plain version over V = 262,144 (gemma3-1b),
    100,352 (stablelm-1.6b), 1000 and 1001 (the one-element path) x T = 1,
    7, 2560, at V = 50,432 (stablelm-3b) with T = 640 and 1920, at V =
    128,256 (llama-3.2-vision) with T = 640 and 1280, and musicgen's codebook
    logits (2, 640, 4, 2048) as they come, one row a codebook: nll
    and lse, and the backward through the Function (kernel forward,
    PyTorch backward) against autograd of the plain version. At T = 7 two
    labels lie outside [0, V) (nll = lse). One case starts one element
    past an aligned base."""
    import torch
    from repro_torch.kernels.fused_ce import (FusedCEFunction, fused_ce_fwd,
                                              fused_ce_fwd_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    worst = {"nll": 0.0, "lse": 0.0, "dlogits": 0.0}
    n_cases = 0

    def case(logits, labels, key):
        nonlocal n_cases
        nll, lse = fused_ce_fwd(logits, labels)
        nll_ref, lse_ref = fused_ce_fwd_ref(logits, labels)
        g = torch.rand(labels.shape, generator=gen, device=dev)
        grads = []
        for fn in (lambda a: FusedCEFunction.apply(a, labels)[0],
                   lambda a: fused_ce_fwd_ref(a, labels)[0]):
            a = logits.clone().requires_grad_()
            fn(a).backward(g)
            grads.append(a.grad)
            del a
        torch.cuda.synchronize()
        for name, out, ref, tol in (
                ("nll", nll, nll_ref, CE_TOL["nll"]),
                ("lse", lse, lse_ref, CE_TOL["nll"]),
                ("dlogits", grads[0], grads[1], CE_TOL["dlogits"])):
            worst[name] = max(worst[name], assert_close(
                f"fused_ce {key} {name}", out, ref, tol))
        outside = (labels < 0) | (labels >= logits.shape[-1])
        if not torch.equal(nll[outside], lse[outside]):
            raise AssertionError(f"fused_ce {key}: out-of-vocab label's nll "
                                 f"is not its lse")
        n_cases += 1

    grid = [(v, t) for v in CE_CHECK["V"] for t in CE_CHECK["T"]]
    for v, t in grid + [tuple(vt) for vt in CE_CHECK["V_T"]]:
        logits = 4.0 * torch.randn(t, v, generator=gen, device=dev)
        labels = torch.randint(0, v, (t,), generator=gen, device=dev)
        if t == 7:
            labels[0], labels[1] = -1, v
        case(logits, labels, f"V{v}/T{t}")
        del logits, labels
        torch.cuda.empty_cache()
    shape = CE_CHECK["codebook"]
    logits = 4.0 * torch.randn(*shape, generator=gen, device=dev)
    labels = torch.randint(0, shape[-1], shape[:-1], generator=gen,
                           device=dev)
    case(logits, labels, "codebook/" + "x".join(map(str, shape)))
    del logits, labels
    buf = 4.0 * torch.randn(7 * 1000 + 1, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (7,), generator=gen, device=dev)
    case(buf[1:].view(7, 1000), labels, "V1000/T7/unaligned")
    return {"phase": "ce_check", "cases": n_cases, **CE_CHECK,
            "worst_abs_err": worst, "tol": CE_TOL,
            "tol_reason": "f32; nll/lse of order 20: the sum of exps over "
                          "<= 262,144 terms in another order; dlogits in "
                          "[-1, 1]: exp(l - lse) with lse differing in its "
                          "last bits"}


def phase_ce_time(dev):
    """fused_ce at one local step of the LM run: 2560 x 262,144 float32
    logits (2.68 GB, far past the L2)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_ce import fused_ce_fwd, fused_ce_fwd_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    t, v = LM["p"] * LM["b_local"] * LM["seq_len"], 262144
    logits = 4.0 * torch.randn(t, v, generator=gen, device=dev)
    labels = torch.randint(0, v, (t,), generator=gen, device=dev)
    ms = graph_ms([lambda: fused_ce_fwd(logits, labels)], 4, replays=5)
    plain_ms = graph_ms([lambda: fused_ce_fwd_ref(logits, labels)], 4,
                        replays=5)
    library_ms = graph_ms([lambda: F.cross_entropy(logits, labels.long(),
                                                   reduction="none")], 4,
                          replays=5)
    nll, _ = fused_ce_fwd(logits, labels)
    nll_ref, _ = fused_ce_fwd_ref(logits, labels)
    lib = F.cross_entropy(logits, labels.long(), reduction="none")
    err = assert_close("ce_time", nll, nll_ref, CE_TOL["nll"])
    bytes_moved = t * v * 4 + t * 4 + 2 * t * 4
    flops = 4 * t * v                     # max, subtract, exp, add
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_FLOP_PER_S * 1e3
    return {"phase": "ce_time", "T": t, "V": v, "dtype": "float32",
            "bytes": bytes_moved, "flops": flops, "max_abs_err": err,
            "library_max_abs_err": (lib - nll_ref).abs().max().item(),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "F.cross_entropy(logits, labels, reduction='none')",
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "method": "CUDA graph of 4 calls, 5 replays, CUDA events"}


def lm_batch_on(cfg, p, seed, dev):
    """A (p, b_local, seq_len) batch of make_tokens' bigram language."""
    import torch
    from repro_torch.data import lm_batch
    b = lm_batch(seed, p * LM["b_local"], LM["seq_len"], cfg.vocab_size)
    return {k: torch.as_tensor(v).to(dev).reshape(p, LM["b_local"], -1)
            for k, v in b.items()}


def tree_sq(tree_a, tree_b=None):
    """Per-worker squared L2 norm over the leaves of a worker-stacked tree
    (of tree_a - tree_b when tree_b is given): (p,) float64. One worker's
    slice at a time, so the float64 temporaries stay a slice's size."""
    import torch
    from repro_torch.tree import tree_leaves
    la = tree_leaves(tree_a)
    lb = tree_leaves(tree_b) if tree_b is not None else [None] * len(la)
    total = torch.zeros(la[0].shape[0], dtype=torch.float64,
                        device=la[0].device)
    for a, b in zip(la, lb):
        for w in range(a.shape[0]):
            d = a[w].double() if b is None else a[w].double() - b[w].double()
            total[w] += d.square().sum()
    return total


def phase_lm_agree(cfg, dev, phase="lm_agree"):
    """One local step of ``cfg`` at full width and depth on p = 2 workers
    (seq 640, b_local 1), as the round takes it (``worker_grads`` of
    ``train/step.py``: autograd through ``make_lm_loss(c).stacked``, each
    layer vmapped over the worker-stacked params and, with the config's
    remat, recomputed in the backward): per-worker losses and gradients
    through the kernels and through the plain versions, on the same params
    and batch, in f32 and bf16 compute. The kernels' path must launch each
    norm once for both workers (the vmap rules; twice a layer with remat)
    and fused_ce once. Run on gemma3-1b and on stablelm-3b (``lm3b_agree``:
    the params, and both paths' gradients, 62.5 GiB)."""
    import torch
    from repro_torch.configs import WASGDConfig
    from repro_torch.core import replicate_workers
    from repro_torch.kernels.fused_ce import fused_ce_fwd, fused_ce_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd, rmsnorm_ref
    from repro_torch.models import init_params, param_axes
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_lm_loss
    from repro_torch.train.step import _round_parts
    from repro_torch.tree import tree_leaves
    p = LM_AGREE_P
    base = init_params(cfg, seed=1, device=dev)
    params, axes = replicate_workers(base, param_axes(base), p)
    del base
    mb = lm_batch_on(cfg, p, 1, dev)
    n_norms = norms_per_step(cfg)[0]
    checks = []
    for dtype, limit in (("float32", 1e-4), ("bfloat16", 2e-2)):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        out = {}
        for path, kw in (("kernels", {}),
                         ("plain", {"norm": rmsnorm_ref,
                                    "ce": fused_ce_ref})):
            parts = _round_parts(make_lm_loss(c, **kw),
                                 make_optimizer("sgd", LM["lr"]), axes,
                                 WASGDConfig(tau=1), p)
            rmsnorm_fwd.launches = fused_ce_fwd.launches = 0
            grads, losses = parts.worker_grads(params, mb)
            torch.cuda.synchronize()
            out[path] = (grads, losses,
                         (rmsnorm_fwd.launches, fused_ce_fwd.launches))
            del grads, losses
        (gk, lk, nk), (gp, lp, npl) = out["kernels"], out["plain"]
        if nk != (n_norms, 1) or npl != (0, 0):
            raise AssertionError(f"lm_agree/{dtype}: launches (rmsnorm, "
                                 f"fused_ce) {nk} through the kernels, {npl} "
                                 f"through the plain versions; want "
                                 f"({n_norms}, 1) and (0, 0)")
        finite = all(bool(torch.isfinite(t).all())
                     for t in [lk, lp] + tree_leaves(gk))
        loss_rel = ((lk - lp).abs() / lp.abs()).max().item()
        grad_rel = (tree_sq(gk, gp) / tree_sq(gp)).sqrt().max().item()
        if not (finite and loss_rel <= limit and grad_rel <= limit):
            raise AssertionError(f"lm_agree/{dtype}: finite {finite}, loss "
                                 f"rel_err {loss_rel}, grad rel_err "
                                 f"{grad_rel} (limit {limit})")
        checks.append({"compute_dtype": dtype, "losses": lk.tolist(),
                       "loss_rel_err": loss_rel, "grad_rel_l2_err": grad_rel,
                       "limit": limit, "launches_rmsnorm_fused_ce": list(nk)})
        del out, gk, gp
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params
    torch.cuda.empty_cache()
    n = cfg.n_layers
    return {"phase": phase, "arch": cfg.name, "p": p,
            "b_local": LM["b_local"], "seq_len": LM["seq_len"],
            "remat": cfg.remat, "finite": True, "checks": checks,
            "peak_mem_gib": peak,
            "limit_reason": "per worker: loss relative error, and the L2 "
                            "norm of the gradient difference over all "
                            "leaves relative to the gradient's; f32: "
                            f"summation order through {n} layers; bf16: "
                            "one-ulp differences of the norm outputs "
                            f"carried through {n} layers and the backward"}


REMAT = {"warmup_rounds": 1, "rounds": 1}


def phase_lm_remat(cfg, dev):
    """gemma3-1b at full width, p=4 (seq 640, b_local 1), remat off and on:
    (a) one local step's per-worker losses and gradients on the same
    params and batch through ``_round_parts(make_lm_loss(c))`` (the
    round's worker-stacked loss), within the bf16 limit (2e-2), with
    max_memory_allocated over the backward pass (as if only the params
    were alive before it); (b) the update of those gradients, tree-wise
    (``update``: new params beside the old and the gradients) and
    leaf-wise (``apply``, the round's), with max_memory_allocated over
    each; (c) a fresh trainer each way, 1 warm-up and 1 timed round:
    s/round and peak, then 1 profiled round (device busy time, idle share
    against the timed round's wall, kernel launches and the top kernels:
    where remat's recompute spends its time)."""
    import torch
    from repro_torch.configs import WASGDConfig
    from repro_torch.core import replicate_workers
    from repro_torch.models import init_params, param_axes
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_lm_loss
    from repro_torch.train.step import _round_parts
    from repro_torch.tree import tree_leaves
    gib = 2 ** 30
    p, limit = LM["p"], 2e-2
    base = init_params(cfg, seed=1, device=dev)
    params, axes = replicate_workers(base, param_axes(base), p)
    del base
    params_gib = sum(x.numel() * x.element_size()
                     for x in tree_leaves(params)) / gib
    mb = lm_batch_on(cfg, p, 1, dev)
    opt = make_optimizer("sgd", LM["lr"])
    step, out = {}, {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        parts = _round_parts(make_lm_loss(c), opt, axes, WASGDConfig(tau=1),
                             p)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grads, losses = parts.worker_grads(params, mb)
        torch.cuda.synchronize()
        step[f"remat_{remat}"] = {
            "backward_s": time.perf_counter() - t0,
            "peak_backward_gib": params_gib + (
                torch.cuda.max_memory_allocated() - before) / gib}
        out[remat] = (grads, losses)
        del grads, losses
    (g_off, l_off), (g_on, l_on) = out[False], out[True]
    loss_rel = ((l_on - l_off).abs() / l_off.abs()).max().item()
    grad_rel = (tree_sq(g_on, g_off) / tree_sq(g_off)).sqrt().max().item()
    finite = all(bool(torch.isfinite(t).all())
                 for t in [l_on, l_off] + tree_leaves(g_on))
    if not (finite and loss_rel <= limit and grad_rel <= limit):
        raise AssertionError(f"lm_remat: finite {finite}, loss rel_err "
                             f"{loss_rel}, grad rel_err {grad_rel}")
    del out, g_off
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    new, _ = opt.update(g_on, (), params)
    torch.cuda.synchronize()
    update = {"treewise_peak_gib": torch.cuda.max_memory_allocated() / gib}
    del new
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt.apply(g_on, (), params)
    torch.cuda.synchronize()
    update["leafwise_peak_gib"] = torch.cuda.max_memory_allocated() / gib
    del g_on, params
    torch.cuda.empty_cache()

    rounds = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        tr, ds = new_lm_trainer(c, dev), lm_dataset(c)
        batches = ds.batches()
        run_lm_rounds(tr, ds, batches, REMAT["warmup_rounds"], 0)
        torch.cuda.reset_peak_memory_stats()
        wall = run_lm_rounds(tr, ds, batches, REMAT["rounds"],
                             REMAT["warmup_rounds"])
        peak = torch.cuda.max_memory_allocated() / gib
        done = REMAT["warmup_rounds"] + REMAT["rounds"]
        wall1 = wall / REMAT["rounds"]
        with device_profile() as prof:
            wall_prof = run_lm_rounds(tr, ds, batches, 1, done)
        losses = tr.losses()
        if not np.isfinite(losses).all():
            raise AssertionError(f"lm_remat: losses {losses}")
        rounds[f"remat_{remat}"] = {
            "seconds_per_round": wall / REMAT["rounds"],
            "peak_mem_gib": peak, "losses": [float(v) for v in losses],
            "profile": {"rounds": 1, "wall_ms": wall1 * 1e3,
                        "wall_ms_profiled": wall_prof * 1e3,
                        **device_summary(prof, wall1, 10)}}
        del tr, batches
        torch.cuda.empty_cache()
    return {"phase": "lm_remat", "arch": cfg.name, "p": p,
            "seq_len": LM["seq_len"], "b_local": LM["b_local"],
            "params_gib": params_gib, "losses_remat": l_on.tolist(),
            "loss_rel_err": loss_rel, "grad_rel_l2_err": grad_rel,
            "limit": limit, "local_step": step, "update": update,
            "rounds": rounds, "round_settings": {**LM, **REMAT}}


def lm_dataset(cfg, st=LM, boundary_delay=0):
    """``lm_batch``'s data for ``cfg`` (seed 0): make_tokens' bigram
    language, or codebook streams, and media for a model with cross
    layers."""
    from repro_torch.data import OrderedDataset, lm_batch
    data = lm_batch(0, st["n_seq"], st["seq_len"], cfg.vocab_size,
                    n_codebooks=cfg.n_codebooks,
                    media_tokens=cfg.n_media_tokens, d_model=cfg.d_model)
    return OrderedDataset(data, st["p"], st["tau"], st["b_local"],
                          n_segments=st["n_segments"], seed=st["order_seed"],
                          boundary_delay=boundary_delay)


def open_gates(params, seed):
    """Sets every ``cross_gate`` (zeros at init, which makes the cross
    branch's output exactly zero and hides any fault in it) to U(0.5, 1.0)
    drawn from ``seed``, in place; a model without cross layers is
    unchanged. Returns the params."""
    import torch
    gates = [lp["cross_gate"] for lp in params["layers"].values()
             if "cross_gate" in lp]
    if gates:
        gen = torch.Generator(device=gates[0].device)
        gen.manual_seed(seed)
        for g in gates:
            g.uniform_(0.5, 1.0, generator=gen)
    return params


def new_lm_trainer(cfg, dev, st=LM, pipeline=None, mesh=None):
    """A WASGD+ trainer of ``cfg`` (random weights, seed 0, cross gates
    opened) at the settings ``st``, pipelined as ``pipeline`` says, on
    ``mesh`` if given."""
    from repro_torch.configs import TrainConfig, WASGDConfig
    from repro_torch.models import init_params, param_axes
    from repro_torch.train import Trainer, make_lm_loss
    tcfg = TrainConfig(learning_rate=st["lr"], optimizer="sgd",
                       wasgd=WASGDConfig(tau=st["tau"], beta=st["beta"],
                                         backend=st["backend"]))
    params = open_gates(init_params(cfg, seed=0, device=dev), 0)
    return Trainer(make_lm_loss(cfg), params, param_axes(params), tcfg,
                   st["p"], rule="wasgd+", device=dev, pipeline=pipeline,
                   mesh=mesh)


def layer_norms(cfg, i):
    """RMSNorms of layer ``i``: one before attention, one before the
    cross-attention (with media), one before the SSM mixer, one before the
    FFN (an MLP or the MoE FFN)."""
    ffn = cfg.layer_is_moe(i) or (cfg.d_ff > 0 and (
        cfg.layer_is_attn(i) or cfg.family == "hybrid"))
    return (int(cfg.layer_is_attn(i)) + int(cfg.layer_is_cross_attn(i))
            + int(cfg.layer_is_ssm(i)) + int(ffn))


def norms_per_step(cfg):
    """rmsnorm launches of one local step of the LM round (forward and
    backward), all and fused: the layers' norms (2 a layer for a dense or
    MoE model, 1 for mamba2) and the final one in the forward, all but the
    first layer's first fused; with remat each layer's norms run again in
    the backward pass."""
    n = sum(layer_norms(cfg, i) for i in range(cfg.n_layers))
    if cfg.remat:
        return 2 * n + 1, 2 * n - 1
    return n + 1, n


def ssm_layers(cfg):
    return sum(cfg.layer_is_ssm(i) for i in range(cfg.n_layers))


def run_lm_rounds(tr, ds, batches, rounds, done, **kw):
    """``rounds`` more rounds of ``tr`` over ``batches`` (one iterator of
    ``ds`` for the whole run; ``done`` rounds came before). Returns wall
    seconds."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(batches, rounds, order_state=ds.order,
           segment_fn=lambda r: ds.segment_of_round(r + done), **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_lm_train(cfg, tr, ds, batches):
    import torch
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.wagg import wagg_fused
    from repro_torch.tree import tree_leaves
    warm, rounds, tau = LM["warmup_rounds"], LM["rounds"], LM["tau"]
    warm_s = run_lm_rounds(tr, ds, batches, warm, 0)
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_fwd.launches = fused_ce_fwd.launches = 0
    add_rmsnorm_fwd.launches = 0
    reset_wagg()
    wall = run_lm_rounds(tr, ds, batches, rounds, warm)
    launches = {"rmsnorm": rmsnorm_fwd.launches,
                "rmsnorm_fused": add_rmsnorm_fwd.launches,
                "fused_ce": fused_ce_fwd.launches,
                "wagg_fused": wagg_fused.launches,
                "wagg_leaves": wagg_fused.leaves}
    n_leaves, n_groups = wagg_tree_plan(tr.state.params, tr.axes,
                                        LM["backend"])
    norms, fused = norms_per_step(cfg)
    want = {"rmsnorm": rounds * tau * norms,
            "rmsnorm_fused": rounds * tau * fused,
            "fused_ce": rounds * tau, "wagg_fused": rounds * n_groups,
            "wagg_leaves": rounds * n_leaves}
    if launches != want:
        raise AssertionError(f"lm_train: launches {launches}, want {want}")
    losses = tr.losses()
    measured = losses[warm:]
    if not (np.isfinite(losses).all() and measured[-1] < measured[0]):
        raise AssertionError(f"lm_train: losses {losses}")
    for x in tree_leaves(tr.state.params):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("lm_train: non-finite params")
    theta = np.stack([h["theta"] for h in tr.history])
    tokens = rounds * LM["p"] * tau * LM["b_local"] * LM["seq_len"]
    return {"phase": "lm_train", "arch": cfg.name,
            "params": sum(x[0].numel() for x in tree_leaves(tr.state.params)),
            "compute_dtype": cfg.compute_dtype, "remat": cfg.remat, **LM,
            "rule": "wasgd+",
            "optimizer": "sgd", "launches": launches,
            "worker_leaves": n_leaves, "wagg_launches_per_round": n_groups,
            "seconds_per_round": wall / rounds,
            "wall_s": wall, "warmup_s": warm_s, "tokens_per_s": tokens / wall,
            "loss_first": float(measured[0]), "loss_last": float(measured[-1]),
            "losses": [float(x) for x in losses],
            "theta_min": float(theta.min()), "theta_max": float(theta.max()),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_lm_train_profile(cfg, tr, ds, batches):
    """``LM_PROFILE_ROUNDS`` more rounds unprofiled (wall), then as many
    under torch.profiler on device activity: busy time against that
    wall, and the top kernels."""
    rounds = LM_PROFILE_ROUNDS
    done = LM["warmup_rounds"] + LM["rounds"]
    wall = run_lm_rounds(tr, ds, batches, rounds, done)
    reset_wagg()
    with device_profile() as prof:
        wall_prof = run_lm_rounds(tr, ds, batches, rounds, done + rounds)
    wagg = wagg_counts("lm_train_profile", rounds, wagg_tree_plan(
        tr.state.params, tr.axes, LM["backend"]), prof=prof)
    return {"phase": "lm_train_profile", "rounds": rounds,
            "wall_ms": wall * 1e3, "wall_ms_profiled": wall_prof * 1e3,
            "wagg": wagg, **device_summary(prof, wall, 15)}


def distinct_bytes(tree):
    """Bytes of the tensors of ``tree`` (dicts, tuples, NamedTuples),
    each storage counted once."""
    import torch
    from torch.utils._pytree import tree_flatten
    seen = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[(t.device, st.data_ptr())] = st.nbytes()
    return sum(seen.values())


def phase_dryrun(cfg, tr, lm, lm_prof, dev):
    """The dry run (``repro_torch.launch.dryrun``: a trace on the meta
    device, on the host) of lm_train's round, on a one-card mesh with p
    workers, against what lm_train measured on this card: the predicted
    state and batch bytes equal to the trainer's state tensors' and its
    batch's (distinct storages, 1%); the predicted peak (the plain
    versions' temporaries) at or above the arguments and within [0.5, 2]
    of lm_train's peak; the predicted compute seconds (FLOPs / 989e12)
    under lm_train_profile's device busy time a round, beside its wall.
    Then ``input_specs`` alone for all 40 (arch, shape) combinations. The
    dry run allocates no device byte and launches no kernel."""
    import torch
    from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                     TrainConfig, WASGDConfig, get_config)
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.wagg import wagg_fused
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import input_specs
    from repro_torch.parallel.sharding import MeshShape, leaves_with_axes
    st = LM
    shape = InputShape("lm_train", st["seq_len"],
                       st["p"] * st["tau"] * st["b_local"], "train")
    tcfg = TrainConfig(learning_rate=st["lr"], optimizer="sgd",
                       wasgd=WASGDConfig(tau=st["tau"], beta=st["beta"],
                                         backend=st["backend"]))
    counters = (rmsnorm_fwd, add_rmsnorm_fwd, fused_ce_fwd, wagg_fused)
    before = [c.launches for c in counters]
    allocated = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    rec = dryrun.run_one(cfg.name, shape, False, tcfg, verbose=False,
                         mesh=MeshShape({"data": 1}), workers=st["p"])
    trace_s = time.perf_counter() - t0
    if [c.launches for c in counters] != before:
        raise AssertionError("dryrun: the meta trace launched a kernel")
    if torch.cuda.memory_allocated(dev) != allocated:
        raise AssertionError("dryrun: the meta trace allocated on the card")
    pm = rec["port_memory"]
    state_pred, batch_pred = pm["per_argument"]
    state_bytes = distinct_bytes(tr.state)
    first = next(iter(lm_dataset(cfg, st).batches()))
    batch = {k: torch.as_tensor(v).to(dev) for k, v in first.items()}
    batch_bytes = distinct_bytes(batch)
    del batch
    for name, pred, real in (("state", state_pred, state_bytes),
                             ("batch", batch_pred, batch_bytes)):
        if abs(pred - real) > 0.01 * real:
            raise AssertionError(f"dryrun: predicted {name} bytes {pred}, "
                                 f"the trainer's {real}")
    gib = 2 ** 30
    peak_ratio = pm["peak"] / (lm["peak_mem_gib"] * gib)
    if pm["peak"] < pm["arguments"] or not 0.5 <= peak_ratio <= 2.0:
        raise AssertionError(f"dryrun: predicted peak {pm['peak']} B, "
                             f"arguments {pm['arguments']} B, lm_train's "
                             f"peak {lm['peak_mem_gib']} GiB")
    busy_s = lm_prof["device_busy_ms"] / 1e3 / lm_prof["rounds"]
    wall_s = lm_prof["wall_ms"] / 1e3 / lm_prof["rounds"]
    compute_s = rec["roofline"]["compute_s"]
    if not 0 < compute_s <= busy_s:
        raise AssertionError(f"dryrun: predicted compute {compute_s} s a "
                             f"round, device busy {busy_s} s")
    t1 = time.perf_counter()
    combos = {}
    for arch in ARCH_IDS:
        acfg = get_config(arch)
        for shp in INPUT_SHAPES:
            wl = input_specs(acfg, shp, 16, TrainConfig(
                wasgd=WASGDConfig(tau=1)))
            leaves = [t for s, a in zip(wl.arg_shapes, wl.arg_axes)
                      for t, _ in leaves_with_axes(s, a)]
            if not all(t.is_meta for t in leaves):
                raise AssertionError(f"dryrun: {arch} x {shp.name}: a "
                                     f"leaf off the meta device")
            combos[f"{arch}/{shp.name}"] = len(leaves)
    specs_s = time.perf_counter() - t1
    if torch.cuda.memory_allocated(dev) != allocated:
        raise AssertionError("dryrun: input_specs allocated on the card")
    return {"phase": "dryrun", "arch": cfg.name, **st,
            "trace_s": trace_s, "t_trace_s": rec["t_trace_s"],
            "dispatched_ops": rec["dispatched_ops"],
            "flops": rec["hlo_flops_per_chip"],
            "model_flops": rec["model_flops"],
            "predicted": {"state_bytes": state_pred,
                          "batch_bytes": batch_pred,
                          "peak_bytes": pm["peak"],
                          "peak_gib": pm["peak"] / gib,
                          "compute_s": compute_s,
                          "memory_s": rec["roofline"]["memory_s"],
                          "op_bytes": rec["hlo_bytes_per_chip"]},
            "measured": {"state_bytes": state_bytes,
                         "batch_bytes": batch_bytes,
                         "peak_gib": lm["peak_mem_gib"],
                         "device_busy_s_per_round": busy_s,
                         "wall_s_per_round": wall_s,
                         "seconds_per_round": lm["seconds_per_round"]},
            "peak_ratio": peak_ratio,
            "compute_over_busy": compute_s / busy_s,
            "compute_over_wall": compute_s / wall_s,
            "input_specs": {"combinations": len(combos), "seconds": specs_s,
                            "leaves": combos}}


EVAL = {"n_batches": 4, "b": 4, "seq": 128, "seed": 999}
TRAIN_TO_SERVE_ROUNDS = 3


def phase_train_to_serve(cfg, tr, ds, batches, done, dev):
    """The LM trainer of ``lm_train`` (gemma3-1b, full width and depth,
    p=4) serves what it trains: a ``ContinuousEngine`` (the serve smoke's
    settings) built from the consensus takes the serve smoke's six
    requests; 3 more rounds run with ``serve_hook`` (a chunk of decode
    steps, then ``HotSwapBridge``) after each, a metrics JSONL and a log
    line a round; the engine is drained. Then ``evaluate_lm`` on the
    consensus over 4 held-out batches of 4 x 128 tokens."""
    import tempfile
    import torch
    from repro_torch.data import make_tokens
    from repro_torch.kernels.decode_attn import paged_decode_attn
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
    from repro_torch.kernels.wagg import wagg_fused
    from repro_torch.serve import ContinuousEngine, HotSwapBridge
    from repro_torch.train.evaluate import consensus_params, evaluate_lm
    rounds, tau = TRAIN_TO_SERVE_ROUNDS, LM["tau"]
    n_norms, n_attn = 2 * cfg.n_layers + 1, cfg.n_layers
    train_norms = norms_per_step(cfg)[0]
    n_leaves, n_groups = wagg_tree_plan(tr.state.params, tr.axes,
                                        LM["backend"])
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attn.launches = rmsnorm_fwd.launches = 0
    fused_ce_fwd.launches = 0
    reset_wagg()
    eng = ContinuousEngine(cfg, consensus_params(tr.state.params, tr.axes),
                           n_slots=N_SLOTS, max_len=MAX_LEN,
                           block_size=BLOCK, chunk=CHUNK, device=dev)
    bridge = HotSwapBridge(eng)
    reqs = serve_requests(cfg, 0)
    rids = [eng.submit(p, n) for p, n in reqs]
    hook_s = []

    def hook(r, params, axes):
        t0 = time.perf_counter()
        eng.step()
        bridge(r, params, axes)
        torch.cuda.synchronize()
        hook_s.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as d:
        mpath = os.path.join(d, "metrics.jsonl")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(batches, rounds, order_state=ds.order,
               segment_fn=lambda r: ds.segment_of_round(r + done),
               log_every=1, metrics_path=mpath, serve_hook=hook,
               serve_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(mpath) as f:
            lines = [json.loads(line) for line in f]
    train_launches = {"wagg_fused": wagg_fused.launches,
                      "wagg_leaves": wagg_fused.leaves,
                      "fused_ce": fused_ce_fwd.launches}
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = {"paged_decode_attn": paged_decode_attn.launches,
                "rmsnorm": rmsnorm_fwd.launches, **train_launches}
    steps, prefills = eng.decode_steps, eng.prefills
    want = {"paged_decode_attn": n_attn * steps,
            "rmsnorm": rounds * tau * train_norms
            + n_norms * (steps + prefills),
            "wagg_fused": rounds * n_groups, "wagg_leaves": rounds * n_leaves,
            "fused_ce": rounds * tau}
    swaps = bridge.swaps
    keys = {"loss", "loss_last", "h", "theta", "scores", "theta_entropy",
            "omega", "round"}
    checks = {
        "full_budgets": all(len(outs[r]) == n for r, (_, n) in
                            zip(rids, reqs)),
        "n_swaps": eng.n_swaps == rounds,
        "in_flight_at_a_swap": any(s["in_flight"] > 0 for s in swaps),
        "later_drifts_positive": all(s["param_drift_l2"] > 0
                                     for s in swaps[1:]),
        "jsonl_lines_and_keys": len(lines) == rounds
        and all(set(x) == keys for x in lines),
        "launches": launches == want,
    }
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng, bridge
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"train_to_serve: checks {checks}; launches "
                             f"{launches}, want {want}; swaps {swaps}")
    held = make_tokens(EVAL["seed"], EVAL["n_batches"] * EVAL["b"],
                       EVAL["seq"] + 1, cfg.vocab_size)

    def eval_batches():
        for i in range(EVAL["n_batches"]):
            sl = held[i * EVAL["b"]:(i + 1) * EVAL["b"]]
            yield {"tokens": sl[:, :-1], "labels": sl[:, 1:]}

    served = consensus_params(tr.state.params, tr.axes)
    fused_ce_fwd.launches = rmsnorm_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = evaluate_lm(cfg, served, eval_batches(), n_batches=EVAL["n_batches"])
    eval_s = time.perf_counter() - t0
    eval_launches = {"fused_ce": fused_ce_fwd.launches,
                     "rmsnorm": rmsnorm_fwd.launches}
    del served
    if not (np.isfinite(ev["nll"]) and eval_launches == {
            "fused_ce": EVAL["n_batches"],
            "rmsnorm": EVAL["n_batches"] * n_norms}):
        raise AssertionError(f"train_to_serve: eval {ev}, launches "
                             f"{eval_launches}")
    tokens = sum(len(t) for t in outs.values())
    return {"phase": "train_to_serve", "arch": cfg.name, "p": LM["p"],
            "rounds": rounds, "serve_every": 1, "requests": REQUESTS,
            "seconds_per_round_with_serving": wall / rounds,
            "hook_s": hook_s, "drain_s": drain_s, "tokens": tokens,
            "decode_steps": steps, "prefills": prefills,
            "swaps": swaps, "launches": launches, "checks": checks,
            "metrics_losses": [x["loss"] for x in lines],
            "peak_mem_gib": peak, "eval": ev, "eval_s": eval_s,
            "eval_launches": eval_launches, "eval_settings": EVAL}


# -- decode_attn (contiguous cache) and the legacy ServeEngine ---------------

def phase_lm_async(cfg, dev):
    """Alg. 4 on gemma3-1b at full width and depth: ``lm_train``'s
    settings with w = p 3 + b 1, the stragglers regime, pallas_wagg:f32,
    2 warm-up and 3 timed rounds through
    ``Trainer.run(straggler_schedule=)`` (a fresh trainer; the earlier LM
    trainer is freed first). Every leaf's wagg_fused call of the first
    masked round is held to the plain version on the same inputs."""
    import torch
    from repro_torch.configs import TrainConfig, WASGDConfig
    from repro_torch.core.async_sim import StepTimeModel, make_schedule
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.wagg import wagg_fused
    from repro_torch.models import init_params, param_axes
    from repro_torch.train import Trainer, make_lm_loss
    a = LM_ASYNC
    w, warm, rounds, tau = a["p"] + a["b"], a["warmup_rounds"], a["rounds"], \
        LM["tau"]
    sched = make_schedule(StepTimeModel(w, seed=ASYNC["seed"],
                                        **REGIMES[a["regime"]]),
                          rounds=warm + rounds, tau=tau, n_workers=a["p"],
                          backups=a["b"])
    tcfg = TrainConfig(learning_rate=LM["lr"], optimizer="sgd",
                       wasgd=WASGDConfig(tau=tau, beta=LM["beta"],
                                         backend=LM["backend"],
                                         async_mode="on_device"))
    params = init_params(cfg, seed=0, device=dev)
    tr = Trainer(make_lm_loss(cfg), params, param_axes(params), tcfg, w,
                 rule="wasgd+", device=dev)
    del params
    ds = lm_dataset(cfg)
    batches = ds.batches()
    errs = []
    with wagg_watched(lambda x, out, ref, q: errs.append(
            (out.float() - ref.float()).abs().max())):
        warm_s = run_lm_rounds(tr, ds, batches, 1, 0,
                               straggler_schedule=sched.active[:1])
    err = torch.stack(errs).max().item()
    n_leaves, n_groups = wagg_tree_plan(tr.state.params, tr.axes,
                                        LM["backend"])
    if not (len(errs) == n_leaves and err <= a["atol"]):
        raise AssertionError(f"lm_async: first masked round, {len(errs)} "
                             f"leaves held, wagg_fused vs plain max_abs_err "
                             f"{err} (limit {a['atol']})")
    warm_s += run_lm_rounds(tr, ds, batches, warm - 1, 1,
                            straggler_schedule=sched.active[1:warm])
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_fwd.launches = fused_ce_fwd.launches = 0
    add_rmsnorm_fwd.launches = 0
    reset_wagg()
    wall = run_lm_rounds(tr, ds, batches, rounds, warm,
                         straggler_schedule=sched.active[warm:])
    launches = {"rmsnorm": rmsnorm_fwd.launches,
                "rmsnorm_fused": add_rmsnorm_fwd.launches,
                "fused_ce": fused_ce_fwd.launches,
                "wagg_fused": wagg_fused.launches,
                "wagg_fused_masked": wagg_fused.masked_launches,
                "wagg_leaves": wagg_fused.leaves}
    norms, fused = norms_per_step(cfg)
    want = {"rmsnorm": rounds * tau * norms,
            "rmsnorm_fused": rounds * tau * fused,
            "fused_ce": rounds * tau, "wagg_fused": rounds * n_groups,
            "wagg_fused_masked": rounds * n_groups,
            "wagg_leaves": rounds * n_leaves}
    if launches != want:
        raise AssertionError(f"lm_async: launches {launches}, want {want}")
    for r, h in enumerate(tr.history):
        act = sched.active[r]
        if not (np.array_equal(h["active"], act.astype(np.float32))
                and (h["theta"][~act] == 0.0).all()):
            raise AssertionError(f"lm_async round {r}: active {h['active']}"
                                 f" vs {act}, theta {h['theta']}")
    losses = tr.losses()
    if not np.isfinite(losses).all():
        raise AssertionError(f"lm_async: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del tr
    return {"phase": "lm_async", "arch": cfg.name, **LM, **a, "w": w,
            "time_model": {"seed": ASYNC["seed"], **REGIMES[a["regime"]]},
            "active": sched.active.astype(int).tolist(),
            "first_round_wagg_max_abs_err": err, "leaves_held": len(errs),
            "launches": launches, "worker_leaves": n_leaves,
            "seconds_per_round": wall / rounds, "warmup_s": warm_s,
            "losses": [float(x) for x in losses], "peak_mem_gib": peak}


def phase_lm3b_train(dev):
    """WASGD+ on stablelm-3b at full width and depth (2.80B parameters, f32
    params, bf16 compute), ``LM3B``'s settings: p=3, tau=4, b_local 1, seq
    640, SGD lr 0.03, pallas_wagg:int4, remat on, through Trainer.run
    (a fresh trainer; the gemma3-1b trainers are freed first). The first
    round holds every leaf's wagg_fused call to the plain version (1e-4)
    and checks its int4 payload (int8, |q| <= 7), and splits the round's
    peak memory at the aggregate (the local steps', then the
    aggregate's). Then ``LM3B``'s timed rounds (s/round,
    tokens/s, peak, launches of rmsnorm, fused_ce and wagg_fused) and 1
    profiled round (idle share against the timed rounds' wall)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import backends
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.wagg import wagg_fused
    from repro_torch.tree import tree_leaves
    gib = 2 ** 30
    st = LM3B
    cfg = get_config(LM3B_ARCH)
    torch.cuda.reset_peak_memory_stats()
    tr, ds = new_lm_trainer(cfg, dev, st), lm_dataset(cfg, st)
    batches = ds.batches()
    init_peak = torch.cuda.max_memory_allocated() / gib
    warm, rounds, tau = st["warmup_rounds"], st["rounds"], st["tau"]
    errs, payloads, split = [], set(), {}
    real_agg = backends.aggregate_from_config

    def held(x, out, ref, payload):
        errs.append((out.float() - ref.float()).abs().max())
        payloads.add((str(payload.dtype), int(payload.abs().max()) <= 7))

    def split_peak(*args, **kw):
        torch.cuda.synchronize()
        split["local_steps_peak_gib"] = torch.cuda.max_memory_allocated() / gib
        torch.cuda.reset_peak_memory_stats()
        out = real_agg(*args, **kw)
        torch.cuda.synchronize()
        split["aggregate_peak_gib"] = torch.cuda.max_memory_allocated() / gib
        return out

    backends.aggregate_from_config = split_peak
    torch.cuda.reset_peak_memory_stats()
    try:
        with wagg_watched(held):
            warm_s = run_lm_rounds(tr, ds, batches, 1, 0)
    finally:
        backends.aggregate_from_config = real_agg
    err = torch.stack(errs).max().item()
    n_leaves, n_groups = wagg_tree_plan(tr.state.params, tr.axes,
                                        st["backend"])
    cap = wagg_payload_cap(tr.state.params, tr.axes, st["backend"])
    if not (len(errs) == n_leaves and err <= 1e-4
            and payloads == {("torch.int8", True)}):
        raise AssertionError(f"lm3b_train: first round, {len(errs)} leaves "
                             f"held, max_abs_err {err}, payloads {payloads}")
    warm_s += run_lm_rounds(tr, ds, batches, warm - 1, 1)
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_fwd.launches = add_rmsnorm_fwd.launches = 0
    fused_ce_fwd.launches = 0
    reset_wagg()
    wall = run_lm_rounds(tr, ds, batches, rounds, warm)
    peak = torch.cuda.max_memory_allocated() / gib
    launches = {"rmsnorm": rmsnorm_fwd.launches,
                "rmsnorm_fused": add_rmsnorm_fwd.launches,
                "fused_ce": fused_ce_fwd.launches,
                "wagg_fused": wagg_fused.launches,
                "wagg_leaves": wagg_fused.leaves}
    norms, fused = norms_per_step(cfg)
    want = {"rmsnorm": rounds * tau * norms,
            "rmsnorm_fused": rounds * tau * fused,
            "fused_ce": rounds * tau, "wagg_fused": rounds * n_groups,
            "wagg_leaves": rounds * n_leaves}
    if launches != want:
        raise AssertionError(f"lm3b_train: launches {launches}, want {want}")
    done = warm + rounds
    wall1 = wall / rounds
    reset_wagg()
    with device_profile() as prof:
        wall_prof = run_lm_rounds(tr, ds, batches, 1, done)
    wagg_prof = wagg_counts("lm3b_train profile", 1, (n_leaves, n_groups),
                            prof=prof)
    losses = tr.losses()
    if not np.isfinite(losses).all():
        raise AssertionError(f"lm3b_train: losses {losses}")
    for x in tree_leaves(tr.state.params):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("lm3b_train: non-finite params")
    n_params = sum(x[0].numel() for x in tree_leaves(tr.state.params))
    theta = np.stack([h["theta"] for h in tr.history])
    del tr, batches
    torch.cuda.empty_cache()
    tokens = rounds * st["p"] * tau * st["b_local"] * st["seq_len"]
    return {"phase": "lm3b_train", "arch": cfg.name, "params": n_params,
            "compute_dtype": cfg.compute_dtype, "remat": cfg.remat, **st,
            "rule": "wasgd+", "optimizer": "sgd", "launches": launches,
            "worker_leaves": n_leaves, "wagg_launches_per_round": n_groups,
            "wagg_payload_cap_bytes": cap,
            "first_round_wagg_max_abs_err": err,
            "first_round_payloads": sorted(map(list, payloads)),
            "first_round_peak_split": split, "init_peak_gib": init_peak,
            "seconds_per_round": wall / rounds, "wall_s": wall,
            "warmup_s": warm_s, "tokens_per_s": tokens / wall,
            "losses": [float(v) for v in losses],
            "theta_min": float(theta.min()), "theta_max": float(theta.max()),
            "peak_mem_gib": peak,
            "profile": {"rounds": 1, "wall_ms": wall1 * 1e3,
                        "wall_ms_profiled": wall_prof * 1e3, "wagg": wagg_prof,
                        **device_summary(prof, wall1, 12)}}


LM3B_F32 = {**LM3B, "backend": "pallas_wagg:f32", "warmup_rounds": 1,
            "rounds": 1}


def phase_lm3b_f32(dev, int4_s_per_round):
    """``lm3b_train``'s run with the f32 payload (pallas_wagg:f32) in place
    of int4, a fresh trainer once that one is freed: 1 warm-up and 1
    timed round, s/round beside int4's, peak, launches."""
    import torch
    from repro_torch.configs import get_config
    st = LM3B_F32
    cfg = get_config(LM3B_ARCH)
    tr, ds = new_lm_trainer(cfg, dev, st), lm_dataset(cfg, st)
    batches = ds.batches()
    warm, rounds = st["warmup_rounds"], st["rounds"]
    warm_s = run_lm_rounds(tr, ds, batches, warm, 0)
    torch.cuda.reset_peak_memory_stats()
    reset_wagg()
    wall = run_lm_rounds(tr, ds, batches, rounds, warm)
    counts = wagg_counts("lm3b_f32", rounds, wagg_tree_plan(
        tr.state.params, tr.axes, st["backend"]))
    launches = counts["launches"]
    losses = tr.losses()
    if not np.isfinite(losses).all():
        raise AssertionError(f"lm3b_f32: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del tr, batches
    torch.cuda.empty_cache()
    return {"phase": "lm3b_f32", "arch": cfg.name, **st,
            "wagg_fused_launches": launches, "wagg_leaves": counts["leaves"],
            "warmup_s": warm_s,
            "seconds_per_round": wall / rounds,
            "int4_seconds_per_round": int4_s_per_round,
            "int4_over_f32": int4_s_per_round / (wall / rounds),
            "losses": [float(v) for v in losses], "peak_mem_gib": peak}


def phase_lm_windowed(dev):
    """gemma3-1b at full width (f32 params, bf16 compute): loss_fn at one
    2048-token sequence with windowed_qblock off and on (the local layers'
    512-token window: the q-blocked form attends 1024 keys a query block
    where the chunked one walks all 2048), alternated off on on off, no
    gradient: logits within the bf16 limit (2e-2 of max|logit|), the
    losses within 2e-2, and each form's ms."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.models import forward, init_params, loss_fn
    cfg = get_config(ARCH)
    params = init_params(cfg, seed=2, device=dev)
    raw = lm_batch(3, WINDOWED["b"], WINDOWED["seq_len"], cfg.vocab_size)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in raw.items()}
    cfgs = {flag: dataclasses.replace(cfg, windowed_qblock=flag)
            for flag in (False, True)}
    times = {False: [], True: []}
    with torch.no_grad():
        logits = {f: forward(c, params, batch["tokens"])[0].float()
                  for f, c in cfgs.items()}
        losses = {f: loss_fn(c, params, batch)[0].item()
                  for f, c in cfgs.items()}
        for flag in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(WINDOWED["reps"]):
                loss_fn(cfgs[flag], params, batch)
            torch.cuda.synchronize()
            times[flag].append((time.perf_counter() - t0)
                               / WINDOWED["reps"] * 1e3)
    rel = ((logits[True] - logits[False]).abs().max()
           / logits[False].abs().max()).item()
    loss_rel = abs(losses[True] - losses[False]) / abs(losses[False])
    if not (bool(torch.isfinite(logits[True]).all()) and rel <= 2e-2
            and loss_rel <= 2e-2):
        raise AssertionError(f"lm_windowed: logits rel_err {rel}, losses "
                             f"{losses}")
    del params, logits
    torch.cuda.empty_cache()
    return {"phase": "lm_windowed", "arch": cfg.name, **WINDOWED,
            "window": cfg.attn_window, "block": 512,
            "logits_rel_err": rel, "loss": losses[False],
            "loss_windowed": losses[True], "loss_rel_err": loss_rel,
            "limit": 2e-2, "chunked_ms": times[False],
            "windowed_ms": times[True]}


def phase_yi_agree(cfg, params_f32, dev):
    """``agree`` on yi-6b at full width: decode steps through
    paged_decode_attn and rmsnorm vs the plain versions, f32 and bf16."""
    rec = phase_agree(cfg, params_f32, dev)
    rec.update(phase="yi_agree", arch=cfg.name)
    return rec


def phase_yi_serve(cfg, eng):
    """``serve`` on yi-6b at full width in bf16: the serve smoke's settings
    and six requests; tokens/s, peak memory, launches."""
    rec = phase_serve(cfg, eng)
    rec["phase"] = "yi_serve"
    return rec


def phase_ssm_lm_agree(cfg, dev):
    """One local step of mamba2-370m at full width and depth on p = 2
    workers (each with its own A_log, so the Function's vmap rule takes a
    row of decay rates per worker), as the round takes it
    (``worker_grads`` over ``make_lm_loss(c).stacked``, remat as
    configured): f32 per-worker losses and gradients through the kernels
    (ssd_chunk, rmsnorm, fused_ce) against the plain versions: losses
    within 1e-4, gradients within 1e-4 or twice the model's own
    sensitivity to a 2^-20 relative change of every SSD output, the
    larger (a random 48-layer Mamba2 amplifies last-bit differences; the
    plain path against itself with the SSD's outputs nudged measures
    it).
    The kernels' path launches ssd_chunk once per SSM layer for both
    workers (twice with remat), rmsnorm norms_per_step times and fused_ce
    once. bf16: a random-weight Mamba2 of 48 layers turns a last-bit
    change into percents of its output (``ssm_agree``), so each SSM layer
    is held on its own inputs instead: the plain bf16 forward of each
    worker records every SSM layer's normed input, and the layer (vmapped
    over the workers) runs through ssd_chunked_kernel and through
    ssd_chunked; outputs and the gradients of the input and of every
    parameter of the layer, for a random cotangent, within 2e-2 of the
    plain ones' largest entry."""
    import torch
    from torch.func import vmap
    from repro_torch.configs import WASGDConfig
    from repro_torch.core import replicate_workers
    from repro_torch.kernels.fused_ce import fused_ce_fwd, fused_ce_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd, rmsnorm_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunked_kernel
    from repro_torch.models import forward, init_params, param_axes
    from repro_torch.models import ssm as SSM
    from repro_torch.models import ssd_chunked
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_lm_loss
    from repro_torch.train.step import _round_parts
    from repro_torch.tree import tree_leaves
    p = LM_AGREE_P
    base = init_params(cfg, seed=1, device=dev)
    params, axes = replicate_workers(base, param_axes(base), p)
    del base
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for lp in params["layers"].values():
        a = lp["ssm"]["A_log"]
        lp["ssm"]["A_log"] = a + 0.1 * torch.randn(a.shape, generator=gen,
                                                   device=dev)
    mb = lm_batch_on(cfg, p, 1, dev)
    n_norms = norms_per_step(cfg)[0]
    n_ssd = ssm_layers(cfg) * (2 if cfg.remat else 1)
    c = dataclasses.replace(cfg, compute_dtype="float32")

    def nudged(*args, **kw):
        """The plain SSD with every output moved by up to 2^-20 relative
        (8 float32 ulps, below the kernel's measured error against its
        plain version: 1.4e-6 to 2.1e-6 of max|plain| in ssd_check), by a
        fixed pseudo-random pattern (no random op under the round's
        vmap)."""
        y, st = ssd_chunked(*args, **kw)
        return y * (1 + 2.0 ** -20 * ulp_pattern(y[0])), st

    plain = {"norm": rmsnorm_ref, "ce": fused_ce_ref, "ssd": ssd_chunked}
    out = {}
    for path, kw in (("kernels", {}), ("plain", plain),
                     ("nudged", {**plain, "ssd": nudged})):
        parts = _round_parts(make_lm_loss(c, **kw),
                             make_optimizer("sgd", LM["lr"]), axes,
                             WASGDConfig(tau=1), p)
        rmsnorm_fwd.launches = fused_ce_fwd.launches = 0
        ssd_chunk.launches = 0
        grads, losses = parts.worker_grads(params, mb)
        torch.cuda.synchronize()
        out[path] = (grads, losses, (rmsnorm_fwd.launches,
                                     fused_ce_fwd.launches,
                                     ssd_chunk.launches))
        del grads, losses
    (gk, lk, nk), (gp, lp_, npl) = out["kernels"], out["plain"]
    floor = (tree_sq(out["nudged"][0], gp) / tree_sq(gp)).sqrt().max().item()
    limit = max(1e-4, 2 * floor)
    if nk != (n_norms, 1, n_ssd) or npl != (0, 0, 0):
        raise AssertionError(f"ssm_lm_agree: launches (rmsnorm, fused_ce, "
                             f"ssd_chunk) {nk} through the kernels, {npl} "
                             f"through the plain versions; want "
                             f"({n_norms}, 1, {n_ssd}) and (0, 0, 0)")
    finite = all(bool(torch.isfinite(t).all())
                 for t in [lk, lp_] + tree_leaves(gk))
    loss_rel = ((lk - lp_).abs() / lp_.abs()).max().item()
    grad_rel = (tree_sq(gk, gp) / tree_sq(gp)).sqrt().max().item()
    if not (finite and loss_rel <= 1e-4 and grad_rel <= limit):
        raise AssertionError(f"ssm_lm_agree/float32: finite {finite}, loss "
                             f"rel_err {loss_rel}, grad rel_err {grad_rel} "
                             f"(limit {limit})")
    f32 = {"losses": lk.tolist(), "loss_rel_err": loss_rel,
           "grad_rel_l2_err": grad_rel, "loss_limit": 1e-4,
           "grad_limit": limit, "grad_sensitivity_2e-20": floor,
           "launches_rmsnorm_fused_ce_ssd_chunk": list(nk)}
    del out, gk, gp
    torch.cuda.empty_cache()

    c = dataclasses.replace(cfg, compute_dtype="bfloat16")
    seen = [[] for _ in range(cfg.n_layers)]    # each layer's inputs
    real_layer, calls = SSM.ssm_layer, [0]

    def recording(lp, h, *args, **kw):
        seen[calls[0] % cfg.n_layers].append(h.detach())
        calls[0] += 1
        return real_layer(lp, h, *args, **kw)

    SSM.ssm_layer = recording
    try:
        with torch.no_grad():
            for w in range(p):
                forward(c, _worker_slice(params, w), mb["tokens"][w],
                        norm=rmsnorm_ref, ssd=ssd_chunked)
    finally:
        SSM.ssm_layer = real_layer
    worst, by_leaf = {"y": 0.0, "grad": 0.0}, {}
    ssd_chunk.launches = 0
    for i in range(cfg.n_layers):
        lp = params["layers"][f"L{i}"]["ssm"]
        h = torch.stack(seen[i])                          # (p, b, s, d) bf16
        cot = torch.randn(h.shape, generator=gen, device=dev).to(h.dtype)
        res = []
        for ssd in (ssd_chunked_kernel, ssd_chunked):
            leaves = {k: v.detach().requires_grad_() for k, v in lp.items()}
            hh = h.detach().requires_grad_()
            y = vmap(lambda q, x: real_layer(q, x, c.ssm, c.d_model,
                                             torch.bfloat16, ssd=ssd)[0])(
                leaves, hh)
            names = ["h"] + sorted(leaves)
            g = torch.autograd.grad(y, [hh] + [leaves[k] for k in names[1:]],
                                    cot)
            res.append((y.detach(), dict(zip(names, g))))
        (yk, gk), (yp, gpl) = res
        err_y = ((yk.float() - yp.float()).abs().max()
                 / yp.float().abs().max()).item()
        errs = {k: ((gk[k].float() - gpl[k].float()).abs().max()
                    / gpl[k].float().abs().max().clamp(min=1e-30)).item()
                for k in gk}
        err_g = max(errs.values())
        for k, e in errs.items():
            by_leaf[k] = max(by_leaf.get(k, 0.0), e)
        if not (bool(torch.isfinite(yk).all()) and err_y <= 2e-2
                and err_g <= 2e-2):
            raise AssertionError(f"ssm_lm_agree/bf16 layer {i}: y rel_err "
                                 f"{err_y}, grad rel_err {err_g}")
        worst = {"y": max(worst["y"], err_y), "grad": max(worst["grad"],
                                                           err_g)}
    if ssd_chunk.launches != cfg.n_layers:
        raise AssertionError(f"ssm_lm_agree/bf16: {ssd_chunk.launches} "
                             f"ssd_chunk launches for {cfg.n_layers} layers "
                             f"vmapped over {p} workers")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, seen
    torch.cuda.empty_cache()
    return {"phase": "ssm_lm_agree", "arch": cfg.name, "p": p,
            "b_local": LM["b_local"], "seq_len": LM["seq_len"],
            "remat": cfg.remat, "finite": True, "float32": f32,
            "bfloat16_layers": {"layers": cfg.n_layers,
                                "worst_y_rel_err": worst["y"],
                                "worst_grad_rel_err": worst["grad"],
                                "worst_grad_rel_err_by_leaf": by_leaf,
                                "limit": 2e-2,
                                "ssd_chunk_launches": cfg.n_layers},
            "peak_mem_gib": peak,
            "limit_reason": "f32: per worker, loss relative error (1e-4) "
                            "and the gradient difference's L2 norm over all "
                            "leaves relative to the gradient's, within 1e-4 "
                            "or twice the model's own sensitivity (the plain "
                            "path against itself with every SSD output moved "
                            "by up to 2^-20 relative), the larger: summation "
                            "order "
                            "through 48 layers of a random Mamba2, which "
                            "amplifies a last-bit change; bf16: each layer "
                            "on its own "
                            "inputs, relative to the plain output's and each "
                            "plain gradient's largest entry (one-ulp "
                            "differences of the bf16 casts after the SSD)"}


def _worker_slice(params, w):
    """Worker ``w``'s copy of a worker-stacked tree (every leaf stacked)."""
    if isinstance(params, dict):
        return {k: _worker_slice(v, w) for k, v in params.items()}
    return params[w]


def round0_snapshot(keys, out):
    """A ``serve_hook`` that puts round 0's params of the flat ``keys``
    (host copies, float32) in ``out``; the round's h and theta are read
    from the history afterwards (``round0_of``)."""
    from repro_torch.checkpoint.io import _flatten

    def hook(r, params, axes):
        if r == 0:
            flat = _flatten(params)
            out.update({k: flat[k].detach().float().cpu() for k in keys})
    return hook


def round0_of(tr, leaves):
    return {"h": np.asarray(tr.history[0]["h"], np.float64),
            "theta": np.asarray(tr.history[0]["theta"], np.float64),
            **{k: v.double().numpy() for k, v in leaves.items()}}


def lm_train_run(cfg, st, phase, dev, round0=None):
    """WASGD+ on ``cfg`` at ``st``'s settings through Trainer.run (a fresh
    trainer, random weights from seed 0, f32 params): ``warmup_rounds``,
    then ``rounds`` timed rounds (s/round, tokens/s, peak memory; launches
    of rmsnorm, fused_ce, wagg_fused and ssd_chunk against the round's
    counts: wagg_fused on every worker leaf once a round, in the grouped
    launches of ``wagg_tree_plan``, and on nothing else, the shapes it
    was handed recorded), then 1 profiled round (device busy time, idle
    share against the timed rounds' wall, top kernels, wagg_fused device
    kernels = its launches). ``round0`` (a
    dict) receives round 0's h, theta and the params of the flat keys
    ``MESH_OLMOE_KEYS`` on the host (``mesh_olmoe`` holds its round to
    them)."""
    import torch
    from repro_torch.core import is_worker_leaf
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.kernels.wagg import ops as wagg_ops
    from repro_torch.kernels.wagg import wagg_fused
    from repro_torch.tree import tree_leaves
    gib = 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    tr, ds = new_lm_trainer(cfg, dev, st), lm_dataset(cfg, st)
    batches = ds.batches()
    init_peak = torch.cuda.max_memory_allocated() / gib
    pairs = list(zip(tree_leaves(tr.state.params), tree_leaves(tr.axes)))
    # (rows, elements a row) of each leaf, as wagg_fused takes it: (p, N)
    worker = [(x.shape[0], x[0].numel()) for x, ax in pairs
              if is_worker_leaf(ax)]
    shared = [tuple(x.shape) for x, ax in pairs if not is_worker_leaf(ax)]
    n_params = (sum(x[0].numel() for x, ax in pairs if is_worker_leaf(ax))
                + sum(x.numel() for x, ax in pairs if not is_worker_leaf(ax)))
    del pairs           # the round replaces the leaves: keep no old ones
    warm, rounds, tau = st["warmup_rounds"], st["rounds"], st["tau"]
    leaves0 = {}
    warm_s = run_lm_rounds(
        tr, ds, batches, warm, 0, serve_hook=None if round0 is None
        else round0_snapshot(MESH_OLMOE_KEYS, leaves0))
    if round0 is not None:
        round0.update(round0_of(tr, leaves0))
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_fwd.launches = add_rmsnorm_fwd.launches = 0
    fused_ce_fwd.launches = ssd_chunk.launches = 0
    reset_wagg()
    handed, real = [], wagg_ops.wagg_fused_many

    def recording(xs, *args, **kw):
        handed.extend((x.shape[0], x[0].numel()) for x in xs)
        return real(xs, *args, **kw)

    wagg_ops.wagg_fused_many = recording
    try:
        wall = run_lm_rounds(tr, ds, batches, rounds, warm)
    finally:
        wagg_ops.wagg_fused_many = real
    peak = torch.cuda.max_memory_allocated() / gib
    launches = {"rmsnorm": rmsnorm_fwd.launches,
                "rmsnorm_fused": add_rmsnorm_fwd.launches,
                "fused_ce": fused_ce_fwd.launches,
                "wagg_fused": wagg_fused.launches,
                "wagg_leaves": wagg_fused.leaves,
                "ssd_chunk": ssd_chunk.launches}
    norms, fused = norms_per_step(cfg)
    n_groups = wagg_tree_plan(tr.state.params, tr.axes, st["backend"])[1]
    want = {"rmsnorm": rounds * tau * norms,
            "rmsnorm_fused": rounds * tau * fused,
            "fused_ce": rounds * tau, "wagg_fused": rounds * n_groups,
            "wagg_leaves": rounds * len(worker),
            "ssd_chunk": rounds * tau * ssm_layers(cfg)
            * (2 if cfg.remat else 1)}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, want {want}")
    if sorted(handed) != sorted(worker * rounds):
        raise AssertionError(f"{phase}: wagg_fused was handed other leaves "
                             f"than the worker leaves")
    done = warm + rounds
    wall1 = wall / rounds
    reset_wagg()
    with device_profile() as prof:
        wall_prof = run_lm_rounds(tr, ds, batches, 1, done)
    wagg_prof = wagg_counts(f"{phase} profile", 1, (len(worker), n_groups),
                            prof=prof)
    losses = tr.losses()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{phase}: losses {losses}")
    for x in tree_leaves(tr.state.params):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{phase}: non-finite params")
    theta = np.stack([h["theta"] for h in tr.history])
    measured = losses[warm:warm + rounds]
    del tr, batches
    torch.cuda.empty_cache()
    tokens = rounds * st["p"] * tau * st["b_local"] * st["seq_len"]
    return {"phase": phase, "arch": cfg.name, "params": n_params,
            "compute_dtype": cfg.compute_dtype, "remat": cfg.remat, **st,
            "rule": "wasgd+", "optimizer": "sgd", "launches": launches,
            "worker_leaves": len(worker), "wagg_launches_per_round": n_groups,
            "shared_leaves": len(shared),
            "shared_leaf_shapes": sorted(set(shared)),
            "init_peak_gib": init_peak,
            "seconds_per_round": wall / rounds, "wall_s": wall,
            "warmup_s": warm_s, "tokens_per_s": tokens / wall,
            "loss_first": float(measured[0]),
            "loss_last": float(measured[-1]),
            "losses": [float(v) for v in losses],
            "theta_min": float(theta.min()), "theta_max": float(theta.max()),
            "peak_mem_gib": peak,
            "profile": {"rounds": 1, "wall_ms": wall1 * 1e3,
                        "wall_ms_profiled": wall_prof * 1e3, "wagg": wagg_prof,
                        **device_summary(prof, wall1, 12)}}


def phase_ssm_lm_train(cfg, dev):
    """WASGD+ on mamba2-370m at full width and depth (368M params, f32
    params, bf16 compute, remat on), ``SSM_LM``'s settings: ssd_chunk
    launches once per SSM layer per local step for all four workers, and
    again in the backward pass's recompute (2 x 48 x tau a round)."""
    return lm_train_run(cfg, SSM_LM, "ssm_lm_train", dev)


def phase_moe_agree(cfg, params_f32, dev):
    """olmoe-1b-7b at full width (64 experts top-8; kv 16, g 1, hd 128):
    two prompts (600 and 37 tokens) prefilled once into three paged
    caches, then 4 decode steps along three paths: through the kernels
    (rmsnorm, paged_decode_attn), each call also held to its plain
    version on that call's own inputs (``held_kernels``); through the
    plain versions; and through the plain versions with every norm's
    input moved by up to one float32 ulp (``nudged_norm``: the model's
    own sensitivity). The later paths route as the kernels' path
    (``moe_routing``), and the expert choices they would have made
    otherwise are counted.

    Each held call is within TOL of its plain version (f32 1e-4, bf16
    2e-2: one ulp), and the f32 logits within 1e-4. The bf16 logits are
    reported beside the model's own sensitivity, not held to a limit:
    the expert weights are drawn with std n_experts^-0.5 (``ParamBuilder``'s
    shape[0] rule, as JAX's), so each random MoE layer's output outweighs
    the residual it joins and a one-ulp difference of a bf16 output is
    carried undamped through the 16 layers (on an H100: 4.0e-2 between
    the paths, 1.4e-2 from the one-ulp nudge alone)."""
    import torch
    from repro_torch.kernels.decode_attn import paged_decode_attn_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    from repro_torch.models import (cast_params, decode_step_paged,
                                    init_cache, prefill)
    from repro_torch.serve import PagedCache
    steps = 4
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (600, 37)]
    feed = rng.integers(0, cfg.vocab_size, (steps, 2, 1)).astype(np.int32)
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        c = dataclasses.replace(cfg, compute_dtype=name)
        params = cast_params(params_f32, dtype)
        errs = {}
        held_norm, held_attn, _ = held_kernels(errs)
        paths = [(held_attn, held_norm),
                 (paged_decode_attn_ref, rmsnorm_ref),
                 (paged_decode_attn_ref, nudged_norm)]
        caches = [PagedCache(c, 2, MAX_LEN, BLOCK, dtype=dtype, device=dev)
                  for _ in paths]
        for slot, p in enumerate(prompts):
            mono = init_cache(c, 1, MAX_LEN, dtype, dev)
            prefill(c, params, torch.from_numpy(p[None]).to(dev), mono)
            for cache in caches:
                cache.reserve(slot, len(p) + steps)
                cache.write_prefill(slot, mono, len(p))
            del mono
        index = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                             device=dev)
        worst, floor, flips = 0.0, 0.0, [0, 0]
        for t in range(steps):
            tok = torch.from_numpy(feed[t]).to(dev)
            lg, routes = [], []
            for i, (cache, (kern, norm)) in enumerate(zip(caches, paths)):
                with (moe_routing(replay=routes) if routes
                      else moe_routing(record=routes)) as replayed:
                    lg.append(decode_step_paged(
                        c, params, tok, cache.pools, cache.tables, index,
                        max_len=MAX_LEN, block_size=BLOCK, attn_kernel=kern,
                        norm=norm)[0].float())
                if i:
                    flips[i - 1] += sum(replayed)
            if not all(bool(torch.isfinite(x).all()) for x in lg) \
                    or lg[0].shape != (2, 1, cfg.padded_vocab):
                raise AssertionError(f"moe_agree/{name}: logits "
                                     f"{tuple(lg[0].shape)} or not finite")
            worst = max(worst, max_rel(lg[0], lg[1]))
            floor = max(floor, max_rel(lg[2], lg[1]))
            index += 1
        held = {k: max(v) for k, v in errs.items() if v}
        calls = {k: len(v) for k, v in errs.items() if v}
        if not all(e <= TOL[name] for e in held.values()) \
                or (dtype == torch.float32 and not worst <= TOL[name]):
            raise AssertionError(f"moe_agree/{name}: held calls {held} "
                                 f"(limit {TOL[name]}), logits rel_err "
                                 f"{worst}")
        results.append({"dtype": name, "held_calls": calls,
                        "held_max_rel_err": held, "held_limit": TOL[name],
                        "logits_rel_err": worst,
                        "logits_limit": TOL[name] if name == "float32"
                        else None,
                        "sensitivity_one_f32_ulp": floor,
                        "routing_differs_token_layers": {
                            "plain": flips[0], "nudged": flips[1]}})
        del params, caches
        torch.cuda.empty_cache()
    return {"phase": "moe_agree", "arch": cfg.name,
            "prompts": [len(p) for p in prompts], "decode_steps": steps,
            "finite": True, "checks": results,
            "limit_reason": "each kernel call against its plain version on "
                            "its own inputs, relative to max|plain| (f32: "
                            "summation order; bf16: one ulp); f32 logits "
                            "1e-4; bf16 logits reported beside the model's "
                            "own sensitivity (see the docstring)"}


def phase_olmoe_serve(cfg, eng):
    """``serve`` on olmoe-1b-7b at full width in bf16: the serve smoke's
    settings and six requests; tokens/s, peak memory, launches. Every
    decode step routes all four slots' rows together, as JAX's does."""
    rec = phase_serve(cfg, eng)
    rec["phase"] = "olmoe_serve"
    return rec


def phase_olmoe_train(cfg, dev, round0):
    """WASGD+ on olmoe-1b-7b at full width and depth (6.92B params: 6.44B
    in the experts, one copy; f32 params, bf16 compute, remat on),
    ``OLMOE_TRAIN``'s settings: wagg_fused on every worker leaf once a
    round and never on an expert leaf. ``round0`` receives round 0's h, theta
    and two leaves (``mesh_olmoe``'s reference)."""
    return lm_train_run(cfg, OLMOE_TRAIN, "olmoe_train", dev, round0)


def hybrid_agree(cfg, params, dev):
    """bf16 prefill of two prompts (300 and 37 tokens) and 4 decode steps
    along three paths, each into its own paged cache: through the kernels
    (ssd_chunk, rmsnorm, paged_decode_attn), each call also held to its
    plain version on that call's own inputs (``held_kernels``: within
    2e-2 of max|plain|, the SSD within 1e-4); through the plain versions
    (ssd_chunked, rmsnorm_ref, paged_decode_attn_ref); and through the
    plain versions with every norm's input moved by up to one float32 ulp
    (``nudged_norm``). The later paths route as the kernels' path
    (``moe_routing``). The prefill's and each step's logits are reported
    against the plain path's beside that sensitivity, as ``moe_agree``
    reports olmoe's bf16 logits."""
    import torch
    from repro_torch.kernels.decode_attn import paged_decode_attn_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.models import (decode_step_paged, init_cache, prefill,
                                    ssd_chunked)
    from repro_torch.serve import PagedCache
    steps, limits = 4, {"rmsnorm": 2e-2, "paged_decode_attn": 2e-2,
                        "ssd_chunk": 1e-4}
    rng = np.random.default_rng(7)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))
                                .astype(np.int32)).to(dev) for n in (300, 37)]
    feed = rng.integers(0, cfg.vocab_size, (steps, 2, 1)).astype(np.int32)
    errs = {}
    held_norm, held_attn, held_ssd = held_kernels(errs)
    paths = ((held_ssd, held_norm, held_attn),
             (ssd_chunked, rmsnorm_ref, paged_decode_attn_ref),
             (ssd_chunked, nudged_norm, paged_decode_attn_ref))
    caches = [PagedCache(cfg, 2, MAX_LEN, BLOCK, dtype=torch.bfloat16,
                         device=dev) for _ in paths]
    worst = {"prefill": 0.0, "decode": 0.0}
    floor, flips = dict(worst), [0, 0]

    def run(fn, i, routes):
        with (moe_routing(replay=routes) if routes
              else moe_routing(record=routes)) as replayed:
            out = fn()
        if i:
            flips[i - 1] += sum(replayed)
        return out

    ssd_chunk.launches = 0
    for slot, p in enumerate(prompts):
        lg, routes = [], []
        for i, (cache, (ssd, norm, _)) in enumerate(zip(caches, paths)):
            mono = init_cache(cfg, 1, MAX_LEN, torch.bfloat16, dev)
            lg.append(run(lambda: prefill(cfg, params, p, mono, norm=norm,
                                          ssd=ssd)[0].float(), i, routes))
            cache.reserve(slot, p.shape[1] + steps)
            cache.write_prefill(slot, mono, p.shape[1])
            del mono
        worst["prefill"] = max(worst["prefill"], max_rel(lg[0], lg[1]))
        floor["prefill"] = max(floor["prefill"], max_rel(lg[2], lg[1]))
    if ssd_chunk.launches != ssm_layers(cfg) * len(prompts):
        raise AssertionError(f"jamba agree: {ssd_chunk.launches} ssd_chunk "
                             f"launches for {len(prompts)} prefills")
    index = torch.tensor([p.shape[1] for p in prompts], dtype=torch.int32,
                         device=dev)
    for t in range(steps):
        tok = torch.from_numpy(feed[t]).to(dev)
        lg, routes = [], []
        for i, (cache, (_, norm, attn)) in enumerate(zip(caches, paths)):
            lg.append(run(lambda: decode_step_paged(
                cfg, params, tok, cache.pools, cache.tables, index,
                max_len=MAX_LEN, block_size=BLOCK, attn_kernel=attn,
                norm=norm)[0].float(), i, routes))
        if not all(bool(torch.isfinite(x).all()) for x in lg) \
                or lg[0].shape != (2, 1, cfg.padded_vocab):
            raise AssertionError(f"jamba agree: logits "
                                 f"{tuple(lg[0].shape)} or not finite")
        worst["decode"] = max(worst["decode"], max_rel(lg[0], lg[1]))
        floor["decode"] = max(floor["decode"], max_rel(lg[2], lg[1]))
        index += 1
    held = {k: max(v) for k, v in errs.items() if v}
    if set(held) != set(limits) \
            or not all(held[k] <= limits[k] for k in held):
        raise AssertionError(f"jamba agree: held calls {held}, limits "
                             f"{limits}")
    del caches
    torch.cuda.empty_cache()
    return {"prompts": [p.shape[1] for p in prompts], "decode_steps": steps,
            "dtype": "bfloat16",
            "held_calls": {k: len(v) for k, v in errs.items()},
            "held_max_rel_err": held, "held_limits": limits,
            "logits_rel_err": worst, "sensitivity_one_f32_ulp": floor,
            "routing_differs_token_layers": {"plain": flips[0],
                                             "nudged": flips[1]}}


def phase_jamba_serve(dev):
    """jamba-v0.1-52b at full width (d 4096; 16 experts of d_ff 14336,
    top-2; Mamba nh 128, ds 16; GQA kv 8, g 4), n_layers cut from 32 to 8
    (one period of the 1:7 interleave), 13.3B params initialised directly
    in bf16 (seed 0): ``hybrid_agree`` (kernels against the plain
    versions), then ContinuousEngine with the serve smoke's settings and
    six requests, greedy: tokens/s, peak memory, launches of ssd_chunk (7
    a prefill), paged_decode_attn (1 a decode step) and rmsnorm."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import paged_decode_attn
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.models import init_params
    from repro_torch.serve import ContinuousEngine
    from repro_torch.tree import tree_leaves
    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=dev,
                         param_dtype=torch.bfloat16)
    n_params = sum(x.numel() for x in tree_leaves(params))
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    agree = hybrid_agree(cfg, params, dev)
    eng = ContinuousEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                           block_size=BLOCK, chunk=CHUNK, device=dev)
    del params
    n_ssm, n_attn = ssm_layers(cfg), cfg.n_layers - ssm_layers(cfg)
    n_norms = sum(layer_norms(cfg, i) for i in range(cfg.n_layers)) + 1
    run_engine(eng, [(p[:16], 4) for p, _ in serve_requests(cfg, 99)[:2]])
    reqs = serve_requests(cfg, 0)
    torch.cuda.reset_peak_memory_stats()
    ssd_chunk.launches = paged_decode_attn.launches = 0
    rmsnorm_fwd.launches = add_rmsnorm_fwd.launches = 0
    eng.decode_steps = eng.prefills = 0
    outs, wall = run_engine(eng, reqs)
    steps, prefills = eng.decode_steps, eng.prefills
    launches = {"ssd_chunk": ssd_chunk.launches,
                "paged_decode_attn": paged_decode_attn.launches,
                "rmsnorm": rmsnorm_fwd.launches,
                "rmsnorm_fused": add_rmsnorm_fwd.launches}
    want = {"ssd_chunk": n_ssm * prefills,
            "paged_decode_attn": n_attn * steps,
            "rmsnorm": n_norms * (steps + prefills),
            "rmsnorm_fused": (n_norms - 1) * (steps + prefills)}
    if launches != want or steps == 0:
        raise AssertionError(f"jamba_serve: launches {launches}, want {want}")
    for (p, n), toks in zip(reqs, outs):
        if toks.shape != (n,) or toks.min() < 0 \
                or toks.max() >= cfg.padded_vocab:
            raise AssertionError(f"jamba_serve: bad output for request "
                                 f"({len(p)}, {n}): {toks}")
    tokens = sum(len(t) for t in outs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng
    torch.cuda.empty_cache()
    return {"phase": "jamba_serve", "arch": cfg.name,
            "cut": {"n_layers": [full.n_layers, JAMBA_LAYERS]},
            "params": n_params, "param_dtype": "bfloat16",
            "init_peak_gib": init_peak, "agree": agree,
            "n_slots": N_SLOTS, "max_len": MAX_LEN, "block_size": BLOCK,
            "chunk": CHUNK, "requests": REQUESTS, "decode_steps": steps,
            "prefills": prefills, "launches": launches, "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "peak_mem_gib": peak}


def media_prompts(cfg, b, n, seed):
    """(b, n) prompt tokens, or (b, n, n_q) codebook tokens, and media
    (b, n_media_tokens, d) float32 for a model with cross layers (else
    None), numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    shape = (b, n, cfg.n_codebooks) if cfg.n_codebooks else (b, n)
    prompts = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    media = (rng.normal(size=(b, cfg.n_media_tokens, cfg.d_model))
             .astype(np.float32) if cfg.n_media_tokens else None)
    return prompts, media


def decode_attn_calls(cfg):
    """decode_attn launches of one decode_step: a self-attention layer's
    and a cross layer's each."""
    return sum(int(cfg.layer_is_attn(i)) + int(cfg.layer_is_cross_attn(i))
               for i in range(cfg.n_layers))


def legacy_agree_media(cfg, params, dev, phase):
    """bf16 prefill of two prompts of LEGACY's 480 tokens (with media for a
    vision model) and 4 decode_steps along three paths, each into its own
    monolithic cache: through the kernels (rmsnorm; decode_attn in every
    self and cross layer), each call also held to its plain version on
    that call's own inputs (within 2e-2 of max|plain|: one bf16 ulp);
    through the plain versions (rmsnorm_ref, decode_attn_ref); and
    through the plain versions with every norm's input moved by up to one
    float32 ulp (``nudged_norm``: the model's own sensitivity). The
    prefill's and each step's logits, all finite, are reported against
    the plain path's beside that sensitivity, as ``jamba_serve`` reports
    its own."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn, decode_attn_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.tree import tree_leaves
    steps, b, limit = 4, 2, TOL["bfloat16"]
    prompts, media = media_prompts(cfg, b, LEGACY["prompt"], 4)
    prompt = torch.from_numpy(prompts).to(dev)
    media = None if media is None else torch.from_numpy(media).to(dev)
    feed = media_prompts(dataclasses.replace(cfg, n_media_tokens=0), b,
                         steps, 5)[0]
    errs = {"decode_attn": []}
    held_norm, _, _ = held_kernels(errs)

    def held_attn(*args, **kw):
        out = decode_attn(*args, **kw)
        errs["decode_attn"].append(max_rel(out, decode_attn_ref(*args,
                                                                **kw)))
        return out

    paths = ((held_attn, held_norm), (decode_attn_ref, rmsnorm_ref),
             (decode_attn_ref, nudged_norm))
    caches = [init_cache(cfg, b, LEGACY["max_len"], torch.bfloat16, dev)
              for _ in paths]
    lg = [prefill(cfg, params, prompt, cache, media, norm=norm)[0].float()
          for cache, (_, norm) in zip(caches, paths)]
    worst = {"prefill": max_rel(lg[0], lg[1]), "decode": 0.0}
    floor = {"prefill": max_rel(lg[2], lg[1]), "decode": 0.0}
    finite = all(bool(torch.isfinite(x).all()) for x in lg)
    decode_attn.launches = 0
    s = prompts.shape[1]
    for t in range(steps):
        tok = torch.from_numpy(feed[:, t:t + 1]).to(dev)
        lg = [decode_step(cfg, params, tok, cache, s + t, attn=attn,
                          norm=norm)[0].float()
              for cache, (attn, norm) in zip(caches, paths)]
        finite &= all(bool(torch.isfinite(x).all()) for x in lg)
        worst["decode"] = max(worst["decode"], max_rel(lg[0], lg[1]))
        floor["decode"] = max(floor["decode"], max_rel(lg[2], lg[1]))
    want_shape = (b, 1) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()) \
        + (cfg.padded_vocab,)
    if not finite or tuple(lg[0].shape) != want_shape:
        raise AssertionError(f"{phase}: logits {tuple(lg[0].shape)} (want "
                             f"{want_shape}) or not finite")
    n_norms = sum(layer_norms(cfg, i) for i in range(cfg.n_layers)) + 1
    calls = {k: len(v) for k, v in errs.items() if v}
    want = {"decode_attn": decode_attn_calls(cfg) * steps,
            "rmsnorm": n_norms * (steps + 1)}
    if calls != want or decode_attn.launches != want["decode_attn"]:
        raise AssertionError(f"{phase}: held calls {calls}, want {want}")
    held = {k: max(v) for k, v in errs.items() if v}
    if not all(e <= limit for e in held.values()):
        raise AssertionError(f"{phase}: held calls {held}, limit {limit}")
    del caches
    torch.cuda.empty_cache()
    return {"phase": phase, "arch": cfg.name, "dtype": "bfloat16",
            "params": sum(x.numel() for x in tree_leaves(params)),
            "batch": b, "prompt": s, "media": None if media is None
            else list(media.shape), "decode_steps": steps, "finite": True,
            "held_calls": calls, "held_max_rel_err": held,
            "held_limit": limit, "logits_rel_err": worst,
            "sensitivity_one_f32_ulp": floor,
            "limit_reason": "each kernel call against its plain version on "
                            "its own inputs, relative to max|plain| (bf16: "
                            "one ulp); the logits reported beside the "
                            "model's own sensitivity"}


def legacy_serve_media(cfg, params, dev, phase):
    """ServeEngine.generate at LEGACY's settings (b 4, 480-token prompts,
    96 new, max_len 1024), greedy, with media (4, 1600, d) float32 for a
    vision model, codebook prompts (4, 480, 4) for an audio one: tokens/s,
    peak memory; decode_attn launches == (self + cross layers) x decode
    steps and rmsnorm launches == norms x (decode steps + prefills); the
    run's first quarter again, unprofiled for its wall and then under the
    profiler (the profiler's post-processing of a whole run takes half a
    minute): the same tokens, one decode_attn device kernel a launch, the
    idle share."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.serve import ServeEngine
    b, n_new = LEGACY["b"], LEGACY["n_new"]
    prompts, media = media_prompts(cfg, b, LEGACY["prompt"], 6)
    n_norms = sum(layer_norms(cfg, i) for i in range(cfg.n_layers)) + 1
    per_step = decode_attn_calls(cfg)
    eng = ServeEngine(cfg, params, max_len=LEGACY["max_len"], device=dev)
    eng.generate(prompts[:, :16], 4, media=media)         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode_attn.launches = rmsnorm_fwd.launches = 0
    add_rmsnorm_fwd.launches = 0
    eng.decode_steps = eng.prefills = 0
    t0 = time.perf_counter()
    toks = eng.generate(prompts, n_new, media=media)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps, prefills = eng.decode_steps, eng.prefills
    launches = {"decode_attn": decode_attn.launches,
                "rmsnorm": rmsnorm_fwd.launches,
                "rmsnorm_fused": add_rmsnorm_fwd.launches}
    want = {"decode_attn": per_step * steps,
            "rmsnorm": n_norms * (steps + prefills),
            "rmsnorm_fused": (n_norms - 1) * (steps + prefills)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != want or steps != n_new - 1:
        raise AssertionError(f"{phase}: launches {launches}, want {want} "
                             f"({steps} decode steps)")
    shape = (b, n_new) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    if toks.shape != shape or toks.min() < 0 \
            or toks.max() >= cfg.padded_vocab:
        raise AssertionError(f"{phase}: bad output {toks.shape}")
    n_prof = n_new // 4
    t0 = time.perf_counter()            # the unprofiled wall of that run
    eng.generate(prompts, n_prof, media=media)
    torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    decode_attn.launches = 0
    with device_profile() as prof:
        toks_prof = eng.generate(prompts, n_prof, media=media)
        torch.cuda.synchronize()
    if not np.array_equal(toks_prof, toks[:, :n_prof]):
        raise AssertionError(f"{phase}: the profiled run's tokens differ "
                             f"from the timed run's")
    summary = device_summary(prof, wall_prof, 8)
    seen = summary["port_kernels"].get("decode_attn_kernel",
                                       {"count": 0, "device_ms": 0.0})
    if seen["count"] != decode_attn.launches:
        raise AssertionError(f"{phase}: {seen['count']} decode_attn device "
                             f"kernels for {decode_attn.launches} launches")
    del eng
    torch.cuda.empty_cache()
    n_tokens = b * n_new
    return {"phase": phase, "arch": cfg.name, "dtype": cfg.compute_dtype,
            "batch": b, "prompt": LEGACY["prompt"], "n_new": n_new,
            "max_len": LEGACY["max_len"], "out_shape": list(toks.shape),
            "media": None if media is None else list(media.shape),
            "decode_steps": steps, "prefills": prefills,
            "decode_attn_per_step": per_step, "norms_per_step": n_norms,
            "launches": launches, "tokens": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall,
            "codebook_tokens_per_s": toks.size / wall,
            "peak_mem_gib": peak,
            "decode_attn_device": {"kernels": seen["count"],
                                   "launches": decode_attn.launches,
                                   "device_ms": seen["device_ms"]},
            "profile": {"n_new": n_prof, "wall_s": wall_prof, **summary},
            "row0_first8": toks[0, :8].tolist()}


def media_model(arch, dev):
    """``arch`` at full width and depth, initialised in bf16 from seed 0,
    every cross gate opened: (cfg, params)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch)
    return cfg, open_gates(init_params(cfg, seed=0, device=dev,
                                       param_dtype=torch.bfloat16), 0)


def phase_vlm_agree(cfg, params, dev):
    """``legacy_agree_media`` on llama-3.2-vision-11b at full width and
    depth (40 layers, 8 of them cross layers over 1600 media positions),
    bf16, cross gates U(0.5, 1.0)."""
    return legacy_agree_media(cfg, params, dev, "vlm_agree")


def phase_vlm_serve(cfg, params, dev):
    """``legacy_serve_media`` on llama-3.2-vision-11b: 48 decode_attn
    launches a step (40 self, 8 cross), 89 rmsnorm launches a step and a
    prefill."""
    return legacy_serve_media(cfg, params, dev, "vlm_serve")


def phase_audio_agree(cfg, params, dev):
    """``legacy_agree_media`` on musicgen-large at full width and depth
    (48 layers, kv 32, g 1, hd 64; four codebook streams), bf16."""
    return legacy_agree_media(cfg, params, dev, "audio_agree")


def phase_audio_serve(cfg, params, dev):
    """``legacy_serve_media`` on musicgen-large: output (4, 96, 4); 48
    decode_attn and 97 rmsnorm launches a step."""
    return legacy_serve_media(cfg, params, dev, "audio_serve")


def phase_audio_train(dev):
    """WASGD+ on musicgen-large at full width and depth (3.26B params,
    f32 params, bf16 compute, remat on), ``MEDIA_TRAIN``'s settings (p 2):
    codebook tokens and labels (n, 640, 4), the CE over (p, b, 640, 4,
    2048) logits in one fused_ce launch a step; wagg_fused on 435 leaves
    a round in 6 launches."""
    from repro_torch.configs import get_config
    rec = lm_train_run(get_config(AUDIO_ARCH), MEDIA_TRAIN, "audio_train",
                       dev)
    rec["cut"] = {"p": [LM["p"], MEDIA_TRAIN["p"]]}
    return rec


def phase_vlm_train(dev):
    """WASGD+ on one period of llama-3.2-vision-11b at full width
    (n_layers cut from 40 to 5: 4 self-attention layers, then a cross
    layer; 2.18B params), ``MEDIA_TRAIN``'s settings with a ``media``
    leaf (n, 1600, 4096) float32 in the dataset: the media ride through
    the vmapped, rematerialised round; cross gates opened; wagg_fused on
    54 leaves a round in one launch."""
    from repro_torch.configs import get_config
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_TRAIN_LAYERS)
    rec = lm_train_run(cfg, MEDIA_TRAIN, "vlm_train", dev)
    rec["cut"] = {"n_layers": [full.n_layers, VLM_TRAIN_LAYERS],
                  "p": [LM["p"], MEDIA_TRAIN["p"]]}
    return rec


def decode_inputs(b, S, kv, g, hd, q_dtype, kv_dtype, gen, dev):
    import torch
    q = torch.randn(b, kv, g, hd, generator=gen, device=dev).to(q_dtype)
    k = torch.randn(b, S, kv, hd, generator=gen, device=dev).to(kv_dtype)
    v = torch.randn(b, S, kv, hd, generator=gen, device=dev).to(kv_dtype)
    return q, k, v


def device_kernels(fn, calls):
    """The device operations (kernels, copies, fills) of ``calls`` calls
    of ``fn`` under torch.profiler: {name: count}."""
    import torch
    fn()
    torch.cuda.synchronize()
    with device_profile() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def phase_decode_attn_check(dev):
    """decode_attn against its plain version over g x hd (the fast paths'
    (4, 256) and (1, 64), and the generic path's (8, 128) and (7, 80)), S
    (512, and 1000: no multiple of the split), all four dtype pairs,
    cache_len (1, mid-cache, S) and a window; one case reads cache_len from
    device memory. Then a batch whose rows fill the card (b 66 x kv 4: one
    split a row, a cluster of one block, its 1024 positions through the
    two-stage ring), the global layer's 1024 positions at cache_len 1024
    (the largest split, whole in flight), a device cache_len at S and at 0
    (no valid position: the Pallas kernel's floored denominator gives 0,
    where the plain version's softmax over an all-masked row is uniform),
    a llama-3.2-vision cross layer (b 4, 1600 media positions, kv 8, g 4,
    hd 128), its self-attention layers as vlm_serve runs them (b 4, kv 8,
    g 4, hd 128, S 1024, cache_len 480 to 575 and full) and musicgen-large's
    self-attention (kv 32, g 1, hd 64, 1024 positions), and, under the
    profiler, one device kernel a call."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn, decode_attn_ref
    from repro_torch.kernels.decode_attn.decode_attn import split_plan
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    worst = {}
    n_cases = 0
    b, kv = 3, 2
    for g, hd in ((1, 64), (4, 256), (8, 128), (7, 80)):
        for S in (512, 1000):
            for qn, kn in DTYPE_PAIRS:
                qd, kd = getattr(torch, qn), getattr(torch, kn)
                q, k, v = decode_inputs(b, S, kv, g, hd, qd, kd, gen, dev)
                for cache_len in (1, S // 2 + 3, S):
                    for window in (None, 100):
                        out = decode_attn(q, k, v, cache_len, window=window)
                        ref = decode_attn_ref(q, k, v, cache_len,
                                              window=window)
                        torch.cuda.synchronize()
                        key = str(qd).split(".")[1]
                        name = (f"g{g}_hd{hd}_S{S}_len{cache_len}_w{window}_"
                                f"{key}/{str(kd).split('.')[1]}")
                        worst[key] = max(worst.get(key, 0.0), assert_close(
                            name, out, ref, TOL[key]))
                        n_cases += 1
    q, k, v = decode_inputs(b, 1000, kv, 4, 256, torch.bfloat16,
                            torch.bfloat16, gen, dev)
    out = decode_attn(q, k, v, torch.tensor(777, dtype=torch.int32,
                                            device=dev), window=300)
    ref = decode_attn_ref(q, k, v, 777, window=300)
    worst["bfloat16"] = max(worst["bfloat16"], assert_close(
        "device_cache_len", out, ref, TOL["bfloat16"]))
    n_cases += 1
    extra = []
    # (name, b, kv, g, hd, S, dtypes, [(cache_len, window, on device)])
    for name, bb, kvv, g, hd, S, (qn, kn), lens in (
            ("fill_card", 66, 4, 2, 64, 1024, ("bfloat16", "float32"),
             [(1000, None, False), (1000, 300, False), (1024, None, True)]),
            ("global1024_full", LEGACY["b"], 1, 4, 256, 1024,
             ("bfloat16", "bfloat16"),
             [(1024, None, False), (1024, None, True), (0, None, True)]),
            ("global1024_full_f32", LEGACY["b"], 1, 4, 256, 1024,
             ("float32", "float32"), [(1024, None, False)]),
            # a llama-3.2-vision cross layer over its 1600 media positions
            ("cross1600", *CROSS_SHAPE, ("bfloat16", "bfloat16"),
             [(1600, None, False), (1600, None, True)]),
            # its self-attention layers at vlm_serve's batch and cache
            ("vlm_self1024", *VLM_SELF_SHAPE, ("bfloat16", "bfloat16"),
             [(480, None, False), (528, None, False), (575, None, True),
              (1024, None, True)]),
            ("musicgen1024", *MUSICGEN_SHAPE, ("bfloat16", "bfloat16"),
             [(528, None, False), (1024, None, True)])):
        q, k, v = decode_inputs(bb, S, kvv, g, hd, getattr(torch, qn),
                                getattr(torch, kn), gen, dev)
        for cache_len, window, on_dev in lens:
            arg = (torch.tensor(cache_len, dtype=torch.int32, device=dev)
                   if on_dev else cache_len)
            out = decode_attn(q, k, v, arg, window=window)
            case = f"{name}_len{cache_len}_w{window}_dev{int(on_dev)}"
            if cache_len == 0:
                ref = torch.zeros_like(out)
            else:
                ref = decode_attn_ref(q, k, v, cache_len, window=window)
            torch.cuda.synchronize()
            err = assert_close(case, out, ref, TOL[qn])
            worst[qn] = max(worst[qn], err)
            extra.append({"case": case, "splits": split_plan(bb, kvv, S),
                          "max_abs_err": err})
            n_cases += 1
        del q, k, v
    # one device kernel a call: no merge kernel, no scratch fills
    sets = [decode_inputs(LEGACY["b"], S, 1, 4, 256, torch.bfloat16,
                          torch.bfloat16, gen, dev) for S in (512, 1024)]
    dev_len = torch.tensor(528, dtype=torch.int32, device=dev)
    calls = [lambda: decode_attn(*sets[0], 512),
             lambda: decode_attn(*sets[1], 528),
             lambda: decode_attn(*sets[1], dev_len, window=300)]
    kernels = device_kernels(lambda: [f() for f in calls], 4)
    n_calls = 4 * len(calls)
    if (sum(kernels.values()) != n_calls
            or any("decode_attn_kernel" not in k for k in kernels)):
        raise AssertionError(f"decode_attn_check: {kernels} for {n_calls} "
                             f"calls, not one decode_attn_kernel each")
    return {"phase": "decode_attn_check", "cases": n_cases,
            "b": b, "kv": kv, "g_hd": [[1, 64], [4, 256], [8, 128], [7, 80]],
            "dtype_pairs": DTYPE_PAIRS,
            "S": [512, 1000], "extra": extra,
            "device_kernels_per_call": sum(kernels.values()) / n_calls,
            "worst_abs_err": worst, "tol": TOL,
            "tol_reason": "bf16 output: one bf16 ulp of a value below 4 is "
                          "at most 2^-6; f32: summation order over <= 1000 "
                          "positions"}


def decode_work(b, kv, g, hd, cache_len, elem):
    """Bytes one call must move (q read and the output written, the valid
    K and V rows read once) and its operations (q.k and p.v)."""
    return (2 * b * kv * g * hd * elem + 2 * b * cache_len * kv * hd * elem,
            4 * b * cache_len * kv * g * hd)


def phase_decode_attn_time(dev):
    """decode_attn at the legacy serve runs' shapes (b = 4, bf16): on
    gemma3-1b (kv 1, g 4, hd 256) a local layer's 512-position ring, full
    after the wrap, and a global layer's 1024-position cache at a mid-run
    cache_len of 528; a llama-3.2-vision cross layer over all 1600 media
    positions (kv 8, g 4, hd 128: 26.2 MB of K/V, the first shape bound by
    its bytes rather than by latency); musicgen-large's self-attention
    (kv 32, g 1, hd 64) at cache_len 528 of 1024. The plain version and
    SDPA on the same caches with the same boolean mask (K/V expanded to
    the query heads)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import decode_attn, decode_attn_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    n_sets = 32
    res = {}
    gemma = (LEGACY["b"], 1, 4, 256)
    for layer, (b, kv, g, hd), S, cache_len in (
            ("ring512", gemma, 512, 512),
            ("global1024", gemma, 1024, 528),
            ("cross1600", CROSS_SHAPE[:4], 1600, 1600),
            ("musicgen1024", MUSICGEN_SHAPE[:4], 1024, 528)):
        sets = [decode_inputs(b, S, kv, g, hd, torch.bfloat16,
                              torch.bfloat16, gen, dev)
                for _ in range(n_sets)]
        mask = (torch.arange(S, device=dev) < cache_len)[None, None, None]
        # each query head's K/V: KV head h serves query heads h*g..h*g+g-1
        lib_sets = [(q.reshape(b, kv * g, 1, hd),
                     k.transpose(1, 2).repeat_interleave(g, dim=1),
                     v.transpose(1, 2).repeat_interleave(g, dim=1))
                    for q, k, v in sets]

        def kern(s):
            return lambda: decode_attn(*s, cache_len)

        def plain(s):
            return lambda: decode_attn_ref(*s, cache_len)

        def library(s):
            return lambda: F.scaled_dot_product_attention(*s, attn_mask=mask)

        ms = graph_ms([kern(s) for s in sets], n_sets)
        plain_ms = graph_ms([plain(s) for s in sets], n_sets)
        library_ms = graph_ms([library(s) for s in lib_sets], n_sets)
        kernels = device_kernels(kern(sets[0]), 8)
        out = decode_attn(*sets[0], cache_len)
        ref = decode_attn_ref(*sets[0], cache_len)
        lib = F.scaled_dot_product_attention(*lib_sets[0], attn_mask=mask)
        err = assert_close(f"decode_attn_time/{layer}", out, ref,
                           TOL["bfloat16"])
        lib_err = (lib.reshape(out.shape).float() - ref.float()).abs().max()
        bytes_moved, flops = decode_work(b, kv, g, hd, cache_len, 2)
        t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_o = flops / F32_FLOP_PER_S * 1e3
        res[layer] = {
            "shape": {"b": b, "kv": kv, "g": g, "hd": hd, "S": S,
                      "cache_len": cache_len, "dtypes": "bfloat16/bfloat16"},
            "bytes": bytes_moved, "flops": flops, "max_abs_err": err,
            "library_max_abs_err": float(lib_err), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention(boolean mask, K/V "
                       "expanded)",
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "kernels_per_call": sum(kernels.values()) / 8,
            "working_sets": n_sets}
        del sets, lib_sets
    return {"phase": "decode_attn_time",
            "method": "CUDA graph of 32 calls on 32 distinct working sets "
                      "(> 50 MB L2), 10 replays, CUDA events", **res}


def phase_legacy_agree(cfg, params_f32, dev):
    """A few full-width decode_step steps of gemma3-1b on the monolithic
    cache through the kernels (decode_attn, rmsnorm) and through their
    plain versions, on the same caches and tokens, in f32 and bf16; then
    the two engines in f32 on one 480-token prompt: ServeEngine's greedy
    tokens must equal ContinuousEngine's."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn, decode_attn_ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    from repro_torch.models import cast_params, decode_step, init_cache, \
        prefill
    from repro_torch.serve import ContinuousEngine, ServeEngine
    # 608 tokens at the real size: past the 512-token ring
    steps, b, s = 4, 2, LEGACY["prompt"] + LEGACY["max_len"] // 8
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)
    feed = rng.integers(0, cfg.vocab_size, (steps, b, 1)).astype(np.int32)
    checks = []
    n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
    for dtype, limit in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        c = dataclasses.replace(cfg, compute_dtype=str(dtype).split(".")[1])
        params = cast_params(params_f32, dtype)
        caches = [init_cache(c, b, LEGACY["max_len"], dtype, dev)
                  for _ in range(2)]
        for cache in caches:
            prefill(c, params, prompt, cache)
        worst = 0.0
        decode_attn.launches = 0
        for t in range(steps):
            tok = torch.from_numpy(feed[t]).to(dev)
            lg = [decode_step(c, params, tok, cache, s + t, attn=attn,
                              norm=norm)[0].float()
                  for cache, attn, norm in zip(
                      caches, (decode_attn, decode_attn_ref),
                      (rmsnorm, rmsnorm_ref))]
            if not all(bool(torch.isfinite(x).all()) for x in lg):
                raise AssertionError(f"legacy_agree/{dtype}: non-finite")
            if lg[0].shape != (b, 1, cfg.padded_vocab):
                raise AssertionError(f"legacy_agree: shape {lg[0].shape}")
            worst = max(worst, ((lg[0] - lg[1]).abs().max()
                                / lg[1].abs().max()).item())
        if decode_attn.launches != n_attn * steps:
            raise AssertionError(f"legacy_agree: {decode_attn.launches} "
                                 f"decode_attn launches, want "
                                 f"{n_attn * steps}")
        if not worst <= limit:
            raise AssertionError(f"legacy_agree/{dtype}: rel_err {worst} > "
                                 f"{limit}")
        checks.append({"dtype": str(dtype).split(".")[1], "rel_err": worst,
                       "limit": limit})
        del params, caches
        torch.cuda.empty_cache()
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    p0 = prompt[:1].cpu().numpy()[:, :LEGACY["prompt"]]
    n_new = 16
    legacy = ServeEngine(c32, params_f32, max_len=LEGACY["max_len"],
                         cache_dtype=torch.float32, device=dev)
    toks_legacy = legacy.generate(p0, n_new)[0]
    del legacy
    cont = ContinuousEngine(c32, params_f32, n_slots=1,
                            max_len=LEGACY["max_len"], block_size=BLOCK,
                            cache_dtype=torch.float32, chunk=CHUNK,
                            device=dev)
    toks_cont = cont.generate(p0, n_new)[0]
    del cont
    torch.cuda.empty_cache()
    if not np.array_equal(toks_legacy, toks_cont):
        raise AssertionError(f"legacy_agree: f32 engines differ: "
                             f"{toks_legacy} vs {toks_cont}")
    return {"phase": "legacy_agree", "arch": cfg.name, "batch": b,
            "prompt": s, "decode_steps": steps, "finite": True,
            "checks": checks, "engines_f32": {
                "prompt": LEGACY["prompt"], "n_new": n_new,
                "tokens_equal": True, "tokens": toks_legacy.tolist()},
            "limit_reason": "f32: summation order; bf16: one-ulp differences "
                            "in attention and norm outputs carried through "
                            f"{cfg.n_layers} layers"}


def phase_legacy_serve(cfg, params, cont_eng, dev):
    """ServeEngine.generate on gemma3-1b at full width and depth, bf16:
    b = 4 prompts of 480 tokens, 96 new, max_len 1024 (the local layers'
    512-token ring wraps). decode_attn launches == 26 x decode steps; the
    run again under the profiler: the same tokens, one device kernel a
    launch, decode_attn's device time. Row
    0's greedy tokens against ContinuousEngine's for the same prompt, as
    a matching prefix: bf16 prefill at batch 4 and batch 1 differ in
    their last bits, which can flip a near-tie of random weights."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.serve import ServeEngine
    b, n_prompt, n_new = LEGACY["b"], LEGACY["prompt"], LEGACY["n_new"]
    n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
    n_norms = 2 * cfg.n_layers + 1
    eng = ServeEngine(cfg, params, max_len=LEGACY["max_len"], device=dev)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (b, n_prompt)).astype(np.int32)
    eng.generate(prompts[:, :16], 4)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode_attn.launches = rmsnorm_fwd.launches = 0
    add_rmsnorm_fwd.launches = 0
    eng.decode_steps = eng.prefills = 0
    t0 = time.perf_counter()
    toks = eng.generate(prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, steps = decode_attn.launches, eng.decode_steps
    norms, fused = rmsnorm_fwd.launches, add_rmsnorm_fwd.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if steps != n_new - 1 or launches != n_attn * steps:
        raise AssertionError(f"legacy_serve: {launches} decode_attn launches "
                             f"for {steps} decode steps x {n_attn} layers")
    if norms != n_norms * (steps + 1) or fused != (n_norms - 1) * (steps + 1):
        raise AssertionError(f"legacy_serve: {norms} rmsnorm launches "
                             f"({fused} fused)")
    if toks.shape != (b, n_new) or toks.min() < 0 \
            or toks.max() >= cfg.padded_vocab:
        raise AssertionError(f"legacy_serve: bad output {toks.shape}")
    cont = cont_eng.generate(prompts[:1], n_new)[0]
    agree = int(np.argmax(np.append(toks[0] != cont, True)))
    # the same run under the profiler: the same tokens (greedy), one
    # device kernel a launch, and decode_attn's device time
    decode_attn.launches = 0
    with device_profile() as prof:
        toks_prof = eng.generate(prompts, n_new)
        torch.cuda.synchronize()
    if not np.array_equal(toks_prof, toks):
        raise AssertionError("legacy_serve: the profiled run's tokens differ "
                             "from the timed run's")
    seen = device_summary(prof, wall, 0)["port_kernels"].get(
        "decode_attn_kernel", {"count": 0, "device_ms": 0.0})
    if seen["count"] != decode_attn.launches:
        raise AssertionError(f"legacy_serve: {seen['count']} decode_attn "
                             f"device kernels for {decode_attn.launches} "
                             f"launches")
    return {"phase": "legacy_serve", "arch": cfg.name,
            "dtype": cfg.compute_dtype, "batch": b, "prompt": n_prompt,
            "n_new": n_new, "max_len": LEGACY["max_len"],
            "decode_steps": steps, "attn_layers": n_attn,
            "launches": launches, "rmsnorm_launches": norms,
            "rmsnorm_fused_launches": fused,
            "tokens": int(toks.size), "wall_s": wall,
            "tokens_per_s": toks.size / wall, "peak_mem_gib": peak,
            "row0_prefix_equal_to_continuous": agree,
            "decode_attn_device": {"kernels": seen["count"],
                                   "launches": decode_attn.launches,
                                   "device_ms": seen["device_ms"]},
            "row0_tokens_first8": toks[0, :8].tolist(),
            "continuous_tokens_first8": cont[:8].tolist()}


def phase_f32_cache_serve(cfg, params, dev):
    """The bf16 gemma3-1b model on an f32 cache, the (bf16 q, f32 cache)
    pair of both decode kernels: ContinuousEngine serves three of the serve
    smoke's requests (one wraps the ring) and ServeEngine two 480-token
    prompts; each through its kernel (launches == attention layers x decode
    steps), outputs in the vocabulary. Row 0 of both engines takes the same
    prompt; their greedy tokens are reported as a matching prefix."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn, paged_decode_attn
    from repro_torch.serve import ContinuousEngine, ServeEngine
    n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
    reqs = serve_requests(cfg, 0)[1:4]
    n_new = 24
    res = {}
    cont = ContinuousEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                            block_size=BLOCK, chunk=CHUNK,
                            cache_dtype=torch.float32, device=dev)
    if cont.cache_dtype != torch.float32 or cont.compute_dtype != \
            torch.bfloat16:
        raise AssertionError("f32_cache_serve: engine dtypes")
    paged_decode_attn.launches = cont.decode_steps = 0
    outs, wall = run_engine(cont, [(p, n) for p, n in reqs])
    steps, launches = cont.decode_steps, paged_decode_attn.launches
    if launches == 0 or launches != n_attn * steps:
        raise AssertionError(f"f32_cache_serve: {launches} paged launches "
                             f"for {steps} steps")
    for (p, n), toks in zip(reqs, outs):
        if toks.shape != (n,) or toks.min() < 0 \
                or toks.max() >= cfg.padded_vocab:
            raise AssertionError(f"f32_cache_serve: bad output {toks}")
    res["continuous"] = {"requests": [[len(p), n] for p, n in reqs],
                         "decode_steps": steps, "launches": launches,
                         "tokens": int(sum(len(x) for x in outs)),
                         "wall_s": wall}
    prompts = np.stack([reqs[1][0], serve_requests(cfg, 5)[2][0]])
    cont_row0 = cont.generate(prompts[:1], n_new)[0]
    del cont
    torch.cuda.empty_cache()
    legacy = ServeEngine(cfg, params, max_len=LEGACY["max_len"],
                         cache_dtype=torch.float32, device=dev)
    decode_attn.launches = legacy.decode_steps = 0
    t0 = time.perf_counter()
    toks = legacy.generate(prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps, launches = legacy.decode_steps, decode_attn.launches
    del legacy
    torch.cuda.empty_cache()
    if launches == 0 or launches != n_attn * steps:
        raise AssertionError(f"f32_cache_serve: {launches} decode_attn "
                             f"launches for {steps} steps")
    if toks.shape != (2, n_new) or toks.min() < 0 \
            or toks.max() >= cfg.padded_vocab:
        raise AssertionError(f"f32_cache_serve: bad legacy output {toks}")
    agree = int(np.argmax(np.append(toks[0] != cont_row0, True)))
    res["legacy"] = {"batch": 2, "prompt": LEGACY["prompt"], "n_new": n_new,
                     "decode_steps": steps, "launches": launches,
                     "wall_s": wall, "row0_prefix_equal_to_continuous": agree}
    return {"phase": "f32_cache_serve", "arch": cfg.name,
            "compute_dtype": cfg.compute_dtype, "cache_dtype": "float32",
            **res}


# -- ssd_chunk and mamba2-370m serving ----------------------------------------

def ssd_inputs(b, nc, L, nh, hd, ds, x_dtype, gen, dev, pad_tail=0):
    """xs, B, C in ``x_dtype``; dt > 0 and a < 0 in f32, as prefill gives
    them; the last ``pad_tail`` steps padded as prefill pads (dt = 0)."""
    import torch
    xs = torch.randn(b, nc, L, nh, hd, generator=gen, device=dev)
    dt = 0.01 + 0.3 * torch.rand(b, nc, L, nh, generator=gen, device=dev)
    a = -torch.exp(2 * torch.rand(nh, generator=gen, device=dev) - 1)
    B = torch.randn(b, nc, L, ds, generator=gen, device=dev)
    C = torch.randn(b, nc, L, ds, generator=gen, device=dev)
    if pad_tail:
        for t in (xs, dt, B, C):
            t[:, -1, L - pad_tail:] = 0
    return xs.to(x_dtype), dt, a, B.to(x_dtype), C.to(x_dtype)


def rel_close(name, out, ref, tol):
    """max|out - ref| / max|ref| <= tol, all finite."""
    import torch
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = ((out.float() - ref.float()).abs().max()
           / ref.float().abs().max().clamp(min=1e-30)).item()
    if not err <= tol:
        raise AssertionError(f"{name}: rel_err {err} > {tol}")
    return err


def phase_ssd_check(dev):
    """ssd_chunk against its plain version over f32/bf16 inputs (the f32
    path at full width too), smoke and full widths of mamba2 and jamba, a
    d_state that is no multiple of the MMA depth (20), padded tails, a
    steep decay and inputs one element off 16-byte alignment;
    ssd_chunked_kernel (the kernel plus the inter-chunk recurrence)
    against the plain ssd_chunked at full width with and without an
    init_state."""
    import torch
    from repro_torch.kernels.ssd_chunk import (ssd_chunk, ssd_chunk_ref,
                                               ssd_chunked_kernel)
    from repro_torch.models import ssd_chunked
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    worst = 0.0
    n_cases = 0
    shapes = [(2, 3, 16, 8, 32, 16),      # mamba2 smoke: L 16, hd 32, ds 16
              (1, 8, 64, 32, 64, 128),    # mamba2-370m, a 512-token prompt
              (2, 2, 32, 4, 128, 64),     # the other L and hd the kernel takes
              (1, 2, 64, 128, 64, 16),    # jamba-52b: 128 heads, ds 16
              (1, 4, 16, 8, 32, 16),      # jamba smoke
              (2, 2, 64, 4, 64, 20)]      # ds 20: padded to 32 in the MMA
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for pad in (0, 7):
                args = ssd_inputs(*shape, dtype, gen, dev, pad_tail=pad)
                outs, refs = ssd_chunk(*args), ssd_chunk_ref(*args)
                torch.cuda.synchronize()
                for part, o, r in zip(("y", "states", "totals"), outs, refs):
                    worst = max(worst, rel_close(
                        f"ssd_chunk {shape} {dtype} pad{pad} {part}", o, r,
                        SSD_TOL))
                n_cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        # every input one element past a 16-byte boundary: narrower copies
        args = list(ssd_inputs(1, 2, 64, 4, 64, 20, dtype, gen, dev))
        for i in (0, 3, 4):
            buf = torch.empty(args[i].numel() + 1, dtype=dtype, device=dev)
            args[i] = buf[1:].view(args[i].shape).copy_(args[i])
        for part, o, r in zip(("y", "states", "totals"), ssd_chunk(*args),
                              ssd_chunk_ref(*args)):
            worst = max(worst, rel_close(f"ssd_chunk unaligned {dtype} {part}",
                                         o, r, SSD_TOL))
        n_cases += 1
    steep = list(ssd_inputs(1, 2, 64, 4, 64, 128, torch.float32, gen, dev))
    steep[1].fill_(10.0)
    steep[2].fill_(-3.0)                  # exp(+30 per step) above the diagonal
    for part, o, r in zip(("y", "states", "totals"), ssd_chunk(*steep),
                          ssd_chunk_ref(*steep)):
        worst = max(worst, rel_close(f"ssd_chunk steep {part}", o, r,
                                     SSD_TOL))
    n_cases += 1
    b, s, nh, hd, ds, L = 2, 512, 32, 64, 128, 64
    for dtype, with_init in ((torch.bfloat16, False), (torch.float32, True)):
        xs, dt, a, B, C = ssd_inputs(b, s // L, L, nh, hd, ds, dtype, gen,
                                     dev, pad_tail=9)
        args = (xs.reshape(b, s, nh, hd), dt.reshape(b, s, nh), a,
                B.reshape(b, s, ds), C.reshape(b, s, ds), L)
        init = (torch.randn(b, nh, ds, hd, generator=gen, device=dev)
                if with_init else None)
        before = ssd_chunk.launches
        y, st = ssd_chunked_kernel(*args, init_state=init)
        if ssd_chunk.launches != before + 1:
            raise AssertionError("ssd_chunked_kernel: no launch")
        y_ref, st_ref = ssd_chunked(*args, init_state=init)
        worst = max(worst, rel_close(f"ssd_chunked {dtype} y", y, y_ref,
                                     SSD_TOL),
                    rel_close(f"ssd_chunked {dtype} state", st, st_ref,
                              SSD_TOL))
        n_cases += 1
    return {"phase": "ssd_check", "cases": n_cases, "shapes": shapes,
            "worst_rel_err": worst, "tol": SSD_TOL,
            "tol_reason": "relative to max|plain|: f32 sums of <= 128 "
                          "products (and the chained chunk states) in "
                          "another order; the kernel's tensor-core products "
                          "take bf16 inputs as they are and split each f32 "
                          "operand into three bf16 parts (24 bits)"}


def ssd_work(b, nc, L, nh, hd, ds, x_elem):
    """Bytes one call must move (xs, B, C, dt, a read once; y, states,
    totals written once) and the operations the function needs: the
    products (C B^T on and below the diagonal once per chunk, and per head
    the masked product with x and the state product; 2 FLOP a
    multiply-add), and the decays and the cumulative sum."""
    tri = L * (L + 1) // 2
    bytes_moved = (b * nc * L * nh * hd * x_elem + 2 * b * nc * L * ds * x_elem
                   + b * nc * L * nh * 4 + nh * 4
                   + b * nc * L * nh * hd * 4 + b * nc * nh * ds * hd * 4
                   + b * nc * nh * 4)
    product_flops = b * nc * (2 * tri * ds
                              + nh * (2 * tri * hd + 2 * L * ds * hd))
    other_flops = b * nc * nh * (3 * tri + 4 * L)
    return bytes_moved, product_flops, other_flops


def phase_ssd_time(dev):
    """ssd_chunk and its plain version at mamba2-370m's widths (L 64, nh
    32, hd 64, ds 128, bf16 xs/B/C as prefill gives them): the serve run's
    longest prefill (one 480-token prompt padded to 512: b 1, nc 8) and a
    batch of four 512-token prompts (b 4, nc 8). No single PyTorch call
    computes this function: no library time."""
    import torch
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    L, nh, hd, ds = 64, 32, 64, 128
    res = {}
    for name, b, n_sets in (("prefill_b1", 1, 16), ("prefill_b4", 4, 8)):
        nc = 8
        sets = [ssd_inputs(b, nc, L, nh, hd, ds, torch.bfloat16, gen, dev,
                           pad_tail=32) for _ in range(n_sets)]
        ms = graph_ms([(lambda s=s: ssd_chunk(*s)) for s in sets], n_sets)
        plain_ms = graph_ms([(lambda s=s: ssd_chunk_ref(*s)) for s in sets],
                            n_sets)
        outs, refs = ssd_chunk(*sets[0]), ssd_chunk_ref(*sets[0])
        err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
        rel = max(rel_close(f"ssd_time/{name}", o, r, SSD_TOL)
                  for o, r in zip(outs, refs))
        bytes_moved, mm_flops, ew_flops = ssd_work(b, nc, L, nh, hd, ds, 2)
        t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
        # the products take bf16 inputs on the tensor cores; the decays
        # and the sum run in f32 outside them
        t_o = (mm_flops / BF16_FLOP_PER_S
               + ew_flops / F32_FLOP_PER_S) * 1e3
        res[name] = {"shape": {"b": b, "nc": nc, "L": L, "nh": nh, "hd": hd,
                               "ds": ds, "x_dtype": "bfloat16"},
                     "bytes": bytes_moved, "flops": mm_flops + ew_flops,
                     "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": max(t_b, t_o), "bytes_ms": t_b,
                     "ops_ms": t_o,
                     "f32_ops_ms": (mm_flops + ew_flops) / F32_FLOP_PER_S
                     * 1e3,
                     "bound_by": "bytes" if t_b >= t_o else "operations",
                     "working_sets": n_sets}
        del sets
    return {"phase": "ssd_time",
            "method": "CUDA graph of one call per working set, 10 replays, "
                      "CUDA events", **res}


# the SSD Function's gradients against autograd through the plain version,
# relative to max|plain|: both backwards are the plain version's own, on
# the same saved inputs; what differs is the forward the cotangents meet
# (none) and the order of float32 sums of the folded batch; a bf16 input's
# gradient is rounded to bf16 in both
SSD_GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# (name, b_local, nc, L, nh, hd, ds): mamba2-370m's round (seq 640) and
# jamba's widths (128 heads, d_state 16) at the same length
SSD_TRAIN_SHAPES = (("mamba2-370m", 1, 10, 64, 32, 64, 128),
                    ("jamba-v0.1-52b", 1, 10, 64, 128, 64, 16))
SSD_TRAIN_P = 4


def phase_ssd_train_check(dev):
    """``SSDChunkFunction`` under ``vmap`` over p = 4 workers, each with
    its own decay rates ``a`` (a worker leaf's A_log), as the training
    round runs it: one ``ssd_chunk`` launch a call whatever p is; y_diag,
    states and totals against the plain version worker by worker
    (SSD_TOL), and the gradients of xs, dt, a, B and C for random
    cotangents against autograd through ``ssd_chunk_ref``
    (SSD_GRAD_TOL), in f32 and bf16 inputs, at mamba2-370m's and jamba's
    widths."""
    import torch
    from torch.func import vmap
    from repro_torch.kernels.ssd_chunk import (SSDChunkFunction, ssd_chunk,
                                               ssd_chunk_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    p = SSD_TRAIN_P
    cases, worst_fwd, worst_grad = [], 0.0, 0.0
    for name, b, nc, L, nh, hd, ds in SSD_TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            sets = [ssd_inputs(b, nc, L, nh, hd, ds, dtype, gen, dev,
                               pad_tail=7 * (w % 2)) for w in range(p)]
            inputs = [torch.stack(parts) for parts in zip(*sets)]
            cot = [torch.randn(shape, generator=gen, device=dev) for shape in
                   ((p, b, nc, L, nh, hd), (p, b, nc, nh, ds, hd),
                    (p, b, nc, nh))]
            leaves = [t.detach().requires_grad_() for t in inputs]
            before = ssd_chunk.launches
            outs = vmap(SSDChunkFunction.apply)(*leaves)
            launches = ssd_chunk.launches - before
            grads = torch.autograd.grad(outs, leaves, cot)
            torch.cuda.synchronize()
            if launches != 1 or ssd_chunk.launches != before + 1:
                raise AssertionError(f"ssd_train_check/{name}: {launches} "
                                     f"launches under vmap over p={p}, "
                                     f"{ssd_chunk.launches - before} after "
                                     f"the backward; want 1")
            ref_leaves = [t.detach().requires_grad_() for t in inputs]
            ref_outs = [torch.stack(o) for o in zip(*(
                ssd_chunk_ref(*(t[w] for t in ref_leaves))
                for w in range(p)))]
            ref_grads = torch.autograd.grad(ref_outs, ref_leaves, cot)
            tol = SSD_GRAD_TOL[str(dtype).split(".")[-1]]
            fwd = max(rel_close(f"ssd_train_check/{name}/{dtype} {part}",
                                o, r, SSD_TOL)
                      for part, o, r in zip(("y", "states", "totals"), outs,
                                            ref_outs))
            grad = {part: rel_close(f"ssd_train_check/{name}/{dtype} "
                                    f"d{part}", g, r, tol)
                    for part, g, r in zip(("xs", "dt", "a", "B", "C"),
                                          grads, ref_grads)}
            worst_fwd = max(worst_fwd, fwd)
            worst_grad = max(worst_grad, max(grad.values()))
            cases.append({"shape": name, "x_dtype": str(dtype).split(".")[-1],
                          "p": p, "b_local": b, "nc": nc, "L": L, "nh": nh,
                          "hd": hd, "ds": ds, "launches": launches,
                          "fwd_rel_err": fwd, "grad_rel_err": grad,
                          "grad_tol": tol})
            del sets, inputs, leaves, outs, grads, ref_leaves, ref_outs
            del ref_grads
    torch.cuda.empty_cache()
    return {"phase": "ssd_train_check", "cases": cases,
            "worst_fwd_rel_err": worst_fwd, "worst_grad_rel_err": worst_grad,
            "fwd_tol": SSD_TOL, "grad_tol": SSD_GRAD_TOL,
            "tol_reason": "relative to max|plain|; the backward is the "
                          "plain version's on the saved inputs in both "
                          "paths, so the gradients differ by the order of "
                          "float32 sums over the folded batch; bf16 "
                          "inputs' gradients are rounded to bf16"}


def phase_ssm_agree(cfg, params_f32, dev):
    """mamba2-370m at full width and depth: two prompts (300 and 37
    tokens: a padded tail, and a prompt shorter than a chunk).

    f32: prefill into a paged cache and 4 decode_step_paged steps through
    the kernels (ssd_chunk, rmsnorm) and through their plain versions
    (ssd_chunked, rmsnorm_ref): logits within 1e-4 relative. Every SSM
    layer launches ssd_chunk once per prefill.

    bf16: a random-weight Mamba2 of 48 layers amplifies a last-bit change
    of one layer's output into a change of several percent of its logits
    (the plain path against itself with the SSD output moved by 1e-6
    relative is measured here as ``sensitivity``), so the end-to-end bf16
    logits are reported, not held to a tolerance. The kernel is held in
    place instead: the plain bf16 prefill hands every SSM layer's own
    bf16 inputs to both ssd_chunked_kernel and ssd_chunked and goes on
    with the plain output. Each output element must agree with the plain
    one within a tolerance of the sum of its terms' magnitudes (the state
    sums 64 products a chunk and cancels, so an error relative to
    max|state| says less about the order of float32 sums): SSD_TOL plus 4
    ulps of the layer's largest |cumsum(dt a)|, the decay exponents'
    rounding."""
    import torch
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunked_kernel
    from repro_torch.models import (cast_params, decode_step_paged,
                                    init_cache, prefill, ssd_chunked)
    from repro_torch.serve import PagedCache
    steps = 4
    rng = np.random.default_rng(6)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))
                                .astype(np.int32)).to(dev) for n in (300, 37)]
    feed = rng.integers(0, cfg.vocab_size, (steps, 2, 1)).astype(np.int32)
    n_ssm = sum(cfg.layer_is_ssm(i) for i in range(cfg.n_layers))
    paths = ((ssd_chunked_kernel, rmsnorm), (ssd_chunked, rmsnorm_ref))

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def run_paths(c, params, dtype, ssds):
        """Prefill both prompts and decode ``steps`` steps along each path;
        returns the worst relative logit difference of prefill and decode
        between the paths."""
        caches = [PagedCache(c, 2, MAX_LEN, BLOCK, dtype=dtype, device=dev)
                  for _ in paths]
        worst = {"prefill": 0.0, "decode": 0.0}
        for slot, p in enumerate(prompts):
            lg = []
            for cache, ssd, (_, norm) in zip(caches, ssds, paths):
                mono = init_cache(c, 1, MAX_LEN, dtype, dev)
                lg.append(prefill(c, params, p, mono, norm=norm,
                                  ssd=ssd)[0].float())
                cache.reserve(slot, p.shape[1] + steps)
                cache.write_prefill(slot, mono, p.shape[1])
            worst["prefill"] = max(worst["prefill"], rel(lg[0], lg[1]))
        index = torch.tensor([p.shape[1] for p in prompts],
                             dtype=torch.int32, device=dev)
        for t in range(steps):
            tok = torch.from_numpy(feed[t]).to(dev)
            lg = [decode_step_paged(c, params, tok, cache.pools, cache.tables,
                                    index, max_len=MAX_LEN, block_size=BLOCK,
                                    norm=norm)[0].float()
                  for cache, (_, norm) in zip(caches, paths)]
            if not all(bool(torch.isfinite(x).all()) for x in lg):
                raise AssertionError(f"ssm_agree/{dtype}: non-finite logits")
            if lg[0].shape != (2, 1, cfg.padded_vocab):
                raise AssertionError(f"ssm_agree: shape {lg[0].shape}")
            worst["decode"] = max(worst["decode"], rel(lg[0], lg[1]))
            index += 1
        return worst

    c = dataclasses.replace(cfg, compute_dtype="float32")
    ssd_chunk.launches = 0
    f32 = run_paths(c, params_f32, torch.float32, [s for s, _ in paths])
    if ssd_chunk.launches != n_ssm * len(prompts):
        raise AssertionError(f"ssm_agree: {ssd_chunk.launches} ssd_chunk "
                             f"launches for {len(prompts)} prefills x "
                             f"{n_ssm} SSM layers")
    if not max(f32.values()) <= 1e-4:
        raise AssertionError(f"ssm_agree/float32: rel_err {f32} > 1e-4")
    torch.cuda.empty_cache()

    c = dataclasses.replace(cfg, compute_dtype="bfloat16")
    params = cast_params(params_f32, torch.bfloat16)
    layer_err = []

    def both(xs, dt, a, B, C, chunk):
        y, st = ssd_chunked_kernel(xs, dt, a, B, C, chunk)
        y_ref, st_ref = ssd_chunked(xs, dt, a, B, C, chunk)
        # the sums of the terms' magnitudes: the same scan on |x|, |B|, |C|
        # (every decay and dt is >= 0)
        mags = ssd_chunked(xs.abs(), dt, a, B.abs(), C.abs(), chunk)
        # each term's decay is exp(cum_i - cum_j); the two versions sum
        # cum in another order, so an exponent may differ by a few ulps of
        # the largest |cum| of the layer (some 200 here: 1 ulp = 1.5e-5)
        cum = torch.cumsum((dt * a).reshape(dt.shape[0], -1, chunk,
                                            dt.shape[-1]), dim=2)
        tol = SSD_TOL + 4 * 2.0 ** -23 * cum.abs().max().item()
        errs = []
        for name, o, r, m in zip(("y", "state"), (y, st), (y_ref, st_ref),
                                 mags):
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"ssm_agree/bf16 layer {name}: "
                                     f"non-finite")
            errs.append(((o - r).abs() / (m + 1e-30)).max().item())
            if not errs[-1] <= tol:
                raise AssertionError(f"ssm_agree/bf16 layer {name}: error "
                                     f"over the terms' magnitude "
                                     f"{errs[-1]} > {tol}")
        layer_err.append((max(errs), tol))
        return y_ref, st_ref

    def nudged(*args, **kw):
        y, st = ssd_chunked(*args, **kw)
        gen = torch.Generator(device=dev)
        gen.manual_seed(len(layer_err))
        return y * (1 + 1e-6 * torch.randn(y.shape, generator=gen,
                                           device=dev)), st

    ssd_chunk.launches = 0
    for p in prompts:
        prefill(c, params, p, init_cache(c, 1, MAX_LEN, torch.bfloat16, dev),
                norm=rmsnorm_ref, ssd=both)
    if ssd_chunk.launches != n_ssm * len(prompts) \
            or len(layer_err) != n_ssm * len(prompts):
        raise AssertionError(f"ssm_agree/bf16: {ssd_chunk.launches} launches, "
                             f"{len(layer_err)} layers compared")
    bf16 = run_paths(c, params, torch.bfloat16, [s for s, _ in paths])
    floor = run_paths(c, params, torch.bfloat16, [nudged, ssd_chunked])
    del params
    torch.cuda.empty_cache()
    return {"phase": "ssm_agree", "arch": cfg.name,
            "prompts": [p.shape[1] for p in prompts], "decode_steps": steps,
            "finite": True, "ssd_chunk_launches_per_path": n_ssm * 2,
            "float32": {"rel_err": f32, "limit": 1e-4},
            "bfloat16": {"layer_ssd_err_over_magnitude":
                         max(e for e, _ in layer_err),
                         "layer_limit_range": [min(t for _, t in layer_err),
                                               max(t for _, t in layer_err)],
                         "layers_compared": len(layer_err),
                         "logits_rel_err": bf16,
                         "sensitivity": floor},
            "limit_reason": "f32 logits relative to max|plain|: summation "
                            "order through 48 layers; bf16 layers: both "
                            "versions compute in f32 from the same bf16 "
                            "inputs, error over the sum of the terms' "
                            "magnitudes, within SSD_TOL + 4 ulps of the "
                            "layer's max |cumsum(dt a)|; bf16 logits: "
                            "reported beside the "
                            "model's own sensitivity, no limit"}


def phase_ssm_serve(cfg, eng):
    """ContinuousEngine on mamba2-370m at full width and depth, bf16, the
    serve smoke's six requests: ssd_chunk launches == 48 x prefills and
    rmsnorm launches == 49 x (decode steps + prefills)."""
    import torch
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    n_ssm = sum(cfg.layer_is_ssm(i) for i in range(cfg.n_layers))
    n_norms = cfg.n_layers + 1
    run_engine(eng, [(p[:16], 4) for p, _ in serve_requests(cfg, 99)[:2]])
    reqs = serve_requests(cfg, 0)
    torch.cuda.reset_peak_memory_stats()
    ssd_chunk.launches = rmsnorm_fwd.launches = 0
    add_rmsnorm_fwd.launches = 0
    eng.decode_steps = eng.prefills = 0
    outs, wall = run_engine(eng, reqs)
    launches, prefills = ssd_chunk.launches, eng.prefills
    steps, norms = eng.decode_steps, rmsnorm_fwd.launches
    fused = add_rmsnorm_fwd.launches
    if launches == 0 or launches != n_ssm * prefills:
        raise AssertionError(f"ssm_serve: {launches} ssd_chunk launches for "
                             f"{prefills} prefills x {n_ssm} SSM layers")
    if norms != n_norms * (steps + prefills) \
            or fused != (n_norms - 1) * (steps + prefills):
        raise AssertionError(f"ssm_serve: {norms} rmsnorm launches ({fused} "
                             f"fused) for {steps} steps + {prefills} "
                             f"prefills x {n_norms}")
    for (p, n), toks in zip(reqs, outs):
        if toks.shape != (n,) or toks.min() < 0 \
                or toks.max() >= cfg.padded_vocab:
            raise AssertionError(f"ssm_serve: bad output for request "
                                 f"({len(p)}, {n}): {toks}")
    tokens = sum(len(t) for t in outs)
    return {"phase": "ssm_serve", "arch": cfg.name,
            "dtype": cfg.compute_dtype, "n_slots": N_SLOTS,
            "max_len": MAX_LEN, "block_size": BLOCK, "chunk": CHUNK,
            "requests": REQUESTS, "decode_steps": steps,
            "ssm_layers": n_ssm, "prefills": prefills, "launches": launches,
            "rmsnorm_launches": norms, "rmsnorm_fused_launches": fused,
            "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_ssm_serve_profile(cfg, eng):
    """A shorter mamba2 serve run under torch.profiler (device activity):
    the (480, 96) and (32, 64) requests cut to 32 new tokens each, some
    2,700 launches a decode step (post-processing the whole run's 360,000
    events takes the profiler about 90 s). Busy time against the wall of
    an unprofiled run of the same requests, and the top kernels."""
    reqs = [(p, 32) for p, _ in serve_requests(cfg, 0)[:3:2]]
    _, wall = run_engine(eng, reqs)
    eng.decode_steps = 0
    with device_profile() as prof:
        _, wall_prof = run_engine(eng, reqs)
    steps = eng.decode_steps
    summary = device_summary(prof, wall, 12)
    return {"phase": "ssm_serve_profile", "wall_ms": wall * 1e3,
            "wall_ms_profiled": wall_prof * 1e3, "decode_steps": steps,
            "kernel_launches_per_decode_step_whole_run":
                summary["kernel_launches"] / steps,
            "kernel_launches_one_decode_step": step_launches(eng, reqs),
            **summary}


# -- pipelined rounds and telemetry -------------------------------------------

# CNN6 at TRAIN's settings through the pipelined round: 14 rounds, so that
# segment 0's OrderGen decision, deferred by boundary_delay =
# RoundPrefetcher.run_ahead() = 4, fires at round 12 inside the run; the
# Alg. 4 runs take w = p 6 + b 2 and ASYNC's stragglers schedule
PIPE = {"rounds": 14, "regime": "stragglers"}
# speculative rounds: |spec - true| <= SPEC_SLACK[0] * bound + SPEC_SLACK[1]
# (the endpoint-gradient surrogate's 2x, as tests/test_pipeline.py states)
SPEC_SLACK = (2.0, 1e-6)
# lm_pipeline's profiled rounds: 2, so that staging copies also fall
# mid-window (with 1, every copy falls at the window's start, and one run
# of the whole script recorded none of them)
LM_PIPE_PROFILE_ROUNDS = 2


def history_bitwise(a, b, keys=("h", "theta", "loss", "loss_last",
                                 "scores")):
    return len(a) == len(b) and all(np.array_equal(x[k], y[k])
                                    for x, y in zip(a, b) for k in keys)


def params_bitwise(a, b):
    import torch
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def pipe_run(dev, pipeline, p=TRAIN["p"], async_mode="host_sim", beta=0.9,
             **kw):
    """A fresh CNN6 trainer (init seed 0), ``PIPE["rounds"]`` rounds over
    an OrderedDataset with boundary_delay = the prefetcher's run-ahead;
    returns the trainer and the run's record (wall, wagg_fused launches,
    the OrderGen decisions and the order seeds after them)."""
    import torch
    from repro_torch.data import RoundPrefetcher
    from repro_torch.kernels.wagg import wagg_fused
    tr, dataset = new_trainer(dev, p, async_mode, pipeline=pipeline,
                              beta=beta)
    ds = dataset(boundary_delay=RoundPrefetcher.run_ahead())
    decisions, end = [], ds.order.end_segment

    def counted_end(segment):
        decisions.append(segment)
        return end(segment)

    ds.order.end_segment = counted_end
    reset_wagg()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(ds, PIPE["rounds"], **kw)
    torch.cuda.synchronize()
    return tr, {"wall_s": time.perf_counter() - t0,
                "launches": wagg_fused.launches,
                "leaves": wagg_fused.leaves,
                "masked_launches": wagg_fused.masked_launches,
                "decisions": decisions, "seeds": ds.order.seeds.copy()}


def pipe_pair(ref, other):
    """Bitwise agreement of two CNN6 runs: per-round metrics, final
    params, the order seeds, the wagg_fused launches."""
    (ta, ra), (tb, rb) = ref, other
    return {"history_bitwise": history_bitwise(ta.history, tb.history),
            "params_bitwise": params_bitwise(ta.state.params,
                                             tb.state.params),
            "orders_equal": ra["decisions"] == rb["decisions"]
            and bool(np.array_equal(ra["seeds"], rb["seeds"])),
            "launches_equal": (ra["launches"], ra["masked_launches"])
            == (rb["launches"], rb["masked_launches"])}


def phase_pipeline_agree(dev):
    """CNN6 at ``train``'s settings (p 8, tau 8, b_local 64,
    pallas_wagg:f32), every run from init seed 0 and an OrderedDataset
    with boundary_delay = RoundPrefetcher.run_ahead(), 14 rounds (the
    deferred OrderGen decision fires at round 12). Two unpipelined runs
    with cuDNN's default algorithms, then with deterministic ones
    (bitwise expected there); the ``"parity"`` run against the
    unpipelined one: per-round h, theta, losses, Judge scores, the final
    params, the order seeds, wagg_fused launches. The same under Alg. 4
    (w = p 6 + b 2, the stragglers schedule: the masked wagg_fused).
    ``"speculative"``: spec_dev <= 2 spec_bound + 1e-6 every round, round
    0's deviation 0; at beta 0 the deviation exactly 0 and the params
    bitwise the parity run's."""
    import torch
    from repro_torch.core.async_sim import StepTimeModel, make_schedule
    default = [pipe_run(dev, None) for _ in range(2)]
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        sync = [pipe_run(dev, None), pipe_run(dev, None),
                pipe_run(dev, "parity")]
        w = ASYNC["p"] + ASYNC["b"]
        sched = make_schedule(StepTimeModel(w, seed=ASYNC["seed"],
                                            **REGIMES[PIPE["regime"]]),
                              rounds=PIPE["rounds"], tau=TRAIN["tau"],
                              n_workers=ASYNC["p"], backups=ASYNC["b"])
        alg4 = [pipe_run(dev, mode, w, "on_device", straggler_schedule=sched)
                for mode in (None, "parity")]
        spec = pipe_run(dev, "speculative")
        beta0 = [pipe_run(dev, mode, beta=0.0)
                 for mode in ("parity", "speculative")]
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    checks = {"unpipelined_twice": pipe_pair(sync[0], sync[1]),
              "parity_vs_unpipelined": pipe_pair(sync[0], sync[2]),
              "alg4_parity_vs_unpipelined": pipe_pair(alg4[0], alg4[1])}
    hist = spec[0].history
    devs = np.stack([h["spec_dev"] for h in hist])
    bounds = np.stack([h["spec_bound"] for h in hist])
    slack, atol = SPEC_SLACK
    b0 = beta0[1][0].history
    spec_checks = {
        "round0_dev_zero": float(devs[0].max()) == 0.0,
        "stale_after_round0": bool((devs[1:] > 0).any()),
        "within_bound": bool((devs <= slack * bounds + atol).all()),
        "beta0_dev_exactly_zero": all(float(np.abs(h["spec_dev"]).max())
                                      == 0.0 for h in b0),
        "beta0_params_bitwise_parity": params_bitwise(
            beta0[0][0].state.params, beta0[1][0].state.params)}
    masked = alg4[1][1]["masked_launches"]
    n_leaves, n_groups = wagg_tree_plan(sync[2][0].state.params,
                                        sync[2][0].axes, TRAIN["backend"])
    ok = (all(all(v.values()) for v in checks.values())
          and all(spec_checks.values())
          and masked == PIPE["rounds"] * n_groups
          and sync[2][1]["launches"] == PIPE["rounds"] * n_groups
          and sync[2][1]["leaves"] == PIPE["rounds"] * n_leaves
          and alg4[1][1]["leaves"] == PIPE["rounds"] * n_leaves
          and len(sync[2][1]["decisions"]) >= 1)
    rec = {"phase": "pipeline_agree", "model": "cnn6", **TRAIN,
           "rounds": PIPE["rounds"],
           "boundary_delay": "RoundPrefetcher.run_ahead() = 4",
           "cudnn_default_unpipelined_twice": pipe_pair(*default),
           "cudnn": "deterministic for the compared runs", **checks,
           "speculative": {**spec_checks, "slack": list(SPEC_SLACK),
                           "max_dev": float(devs.max()),
                           "max_dev_over_bound": float(np.max(
                               devs / np.maximum(bounds, 1e-30))),
                           "rounds_over_1x_bound": int(
                               (devs > bounds).any(axis=1).sum())},
           "wagg_launches": {"unpipelined": sync[0][1]["launches"],
                             "parity": sync[2][1]["launches"],
                             "alg4_parity_masked": masked},
           "s_per_round": {"unpipelined": sync[0][1]["wall_s"]
                           / PIPE["rounds"],
                           "parity": sync[2][1]["wall_s"] / PIPE["rounds"],
                           "speculative": spec[1]["wall_s"]
                           / PIPE["rounds"]},
           "order_decisions": sync[2][1]["decisions"]}
    if not ok:
        raise AssertionError(f"pipeline_agree: {rec}")
    return rec


def lm_snapshot(tr):
    """The LM trainer's history and a host copy of its params (16 GB for
    gemma3-1b at p 4; on the card it would count in the later phases'
    peaks): the unpipelined reference of ``lm_pipeline``."""
    from repro_torch.tree import tree_leaves
    return {"history": [dict(h) for h in tr.history],
            "params": [x.cpu() for x in tree_leaves(tr.state.params)]}


def stream_check(prof_trace):
    """From a chrome trace of device activity: the streams of the port's
    kernels and of the host-to-device copies, and the copies on a stream
    that runs no port kernel (the prefetcher's side stream)."""
    with open(prof_trace) as f:
        events = json.load(f).get("traceEvents", [])
    kern, copies = set(), []
    for e in events:
        args = e.get("args") or {}
        if "stream" not in args:
            continue
        cat, name = str(e.get("cat", "")).lower(), str(e.get("name", ""))
        if cat == "kernel" and any(k in name for k in PORT_KERNELS):
            kern.add(args["stream"])
        elif "memcpy" in cat and "HtoD" in name:
            copies.append((args["stream"], int(args.get("bytes", 0))))
    side = [c for c in copies if c[0] not in kern]
    return {"port_kernel_streams": sorted(kern),
            "htod_copies_by_stream": {
                str(st): sum(1 for c in copies if c[0] == st)
                for st in sorted({c[0] for c in copies})},
            "side_stream_copies": len(side),
            "side_stream_bytes": sum(b for _, b in side)}


def phase_lm_pipeline(cfg, dev, ref, lm):
    """gemma3-1b at full width and depth, ``lm_train``'s settings, through
    ``Trainer(pipeline="parity")``: a fresh trainer from the same seed
    over the same OrderedDataset (boundary_delay = run-ahead) for 2 + 8
    rounds in one ``run``. Its per-round h, theta, losses and scores and
    its final params bitwise ``lm_train``'s run (the same start, data and
    rounds); launches of wagg_fused, rmsnorm and fused_ce equal
    ``lm_train``'s a round; s/round (rounds 3-12, by the round hook)
    beside ``lm_train``'s; peak memory beside its. Then a round under the
    profiler: the idle share (busy time against the timed rounds'
    s/round), and the staging copies on a stream that runs none of the
    port's kernels."""
    import tempfile
    import torch
    from repro_torch.data import RoundPrefetcher
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.wagg import wagg_fused
    from repro_torch.tree import tree_leaves
    warm, rounds = LM["warmup_rounds"], LM["rounds"]
    total = warm + rounds
    tr = new_lm_trainer(cfg, dev, pipeline="parity")
    ds = lm_dataset(cfg, boundary_delay=RoundPrefetcher.run_ahead())
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_fwd.launches = fused_ce_fwd.launches = 0
    add_rmsnorm_fwd.launches = 0
    reset_wagg()
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(ds, total,
           serve_hook=lambda r, p, a: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"rmsnorm": rmsnorm_fwd.launches,
                "rmsnorm_fused": add_rmsnorm_fwd.launches,
                "fused_ce": fused_ce_fwd.launches,
                "wagg_fused": wagg_fused.launches,
                "wagg_leaves": wagg_fused.leaves}
    want = {k: v * total // rounds for k, v in lm["launches"].items()}
    hist_eq = [history_bitwise([a], [b]) for a, b in
               zip(ref["history"][:total], tr.history)]
    leaves = tree_leaves(tr.state.params)
    params_eq = len(leaves) == len(ref["params"]) and all(
        torch.equal(x.cpu(), y) for x, y in zip(leaves, ref["params"]))
    ref["params"].clear()
    s_round = (stamps[-1] - stamps[warm - 1]) / rounds
    gen = ds.batches(start_round=total)
    prof_rounds = LM_PIPE_PROFILE_ROUNDS
    prof_wall = prof_rounds * s_round             # the unprofiled rounds'
    with tempfile.TemporaryDirectory() as d:
        trace = os.path.join(d, "trace.json")
        with device_profile() as prof:
            tr.run(gen, prof_rounds)
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        streams = stream_check(trace)
    summary = device_summary(prof, prof_wall, 10)
    losses = tr.losses()
    del tr
    torch.cuda.empty_cache()
    checks = {"history_bitwise_lm_train": all(hist_eq),
              "params_bitwise_lm_train": params_eq,
              "launches_equal_lm_train": launches == want,
              "staging_on_side_stream": streams["side_stream_copies"] > 0,
              "finite": bool(np.isfinite(losses).all())}
    rec = {"phase": "lm_pipeline", "arch": cfg.name, **LM,
           "pipeline": "parity", "boundary_delay": 4, "checks": checks,
           "history_bitwise_by_round": hist_eq, "launches": launches,
           "launches_want": want, "seconds_per_round": s_round,
           "lm_train_seconds_per_round": lm["seconds_per_round"],
           "wall_s": wall, "peak_mem_gib": peak,
           "lm_train_peak_mem_gib": lm["peak_mem_gib"],
           "profile_rounds": prof_rounds, "streams": streams,
           **summary, "losses": [float(x) for x in losses]}
    if not all(checks.values()):
        raise AssertionError(f"lm_pipeline: {rec}")
    return rec


class TeeSink:
    """A telemetry sink that keeps the events (``RingSink``) and also
    writes them to a ``JsonlSink``."""
    enabled = True

    def __init__(self, jsonl):
        from repro_torch.obs import RingSink
        self.ring, self.jsonl = RingSink(maxlen=1 << 16), jsonl

    def emit(self, event):
        self.ring.emit(event)
        self.jsonl.emit(event)

    def close(self):
        pass


def dispatched_ops(fn):
    """PyTorch operations that ``fn()`` dispatches (every ATen call, on the
    card or not), counted by a dispatch mode: the same program gives the
    same count. The port's own kernels, launched through ctypes, are
    counted by their wrappers instead."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def telemetry_serve(cfg, eng, sink):
    """The gemma3-1b ``ContinuousEngine`` of ``serve`` with a sink: one
    ServeSample a ``step()``, its tokens and time to first token, greedy
    tokens equal to a run without a sink; the PyTorch operations that a
    run dispatches with the default sink and with a fresh ``NullSink()``
    (equal; the profiler's count of a run's device operations varies by
    a few of 128k records from run to run, 127,765 to 127,782 on an H100
    whatever the sink, so it is not the count compared), counted
    after the sink's run, which warms what a first run allocates and is
    itself not counted (the count slows a run);
    a ``HotSwap`` through a bridge
    that takes the engine's sink (the engine's own weights, one worker:
    its drift is that of the bf16 copy from the f32 weights it was
    given)."""
    from repro_torch.kernels.decode_attn import paged_decode_attn
    from repro_torch.obs import NULL, NullSink, to_record
    from repro_torch.serve import HotSwapBridge
    from repro_torch.tree import tree_map
    reqs = serve_requests(cfg, 0)
    tee = TeeSink(sink)
    dispatched = {}

    def counted_run(name):
        out = []
        dispatched[name] = dispatched_ops(
            lambda: out.append(run_engine(eng, reqs)))
        return out[0]

    steps, real_step = [], eng.step

    def counted():
        steps.append(1)
        return real_step()

    eng.step, eng.telemetry = counted, tee
    paged_decode_attn.launches = eng.decode_steps = 0
    try:
        outs, wall = run_engine(eng, reqs)       # timed: not counted
    finally:
        del eng.step
        eng.telemetry = NULL
    launches, decode_steps = paged_decode_attn.launches, eng.decode_steps
    samples = tee.ring.by_kind("serve_sample")
    ref, _ = counted_run("default")      # after the sink's run: both warm
    eng.telemetry = NullSink()
    counted_run("null_sink")
    eng.telemetry = tee
    bridge = HotSwapBridge(eng)
    eng.telemetry = NULL
    stacked = tree_map(lambda x: x.unsqueeze(0), eng.params)
    axes = tree_map(lambda x: ("worker",) + (None,) * (x.dim() - 1), stacked)
    bridge(0, stacked, axes)
    swaps = tee.ring.by_kind("hot_swap")
    tokens = sum(len(t) for t in outs)
    checks = {
        "one_sample_a_step": len(samples) == len(steps) > 0,
        "tokens": sum(x.tokens for x in samples) == tokens,
        "ttft_each_request": len([t for x in samples for t in x.ttft_s])
        == len(reqs),
        "e2e_each_request": len([t for x in samples for t in x.e2e_s])
        == len(reqs),
        "greedy_tokens_equal_no_sink": all(np.array_equal(a, b)
                                           for a, b in zip(ref, outs)),
        "null_sink_dispatched_ops_equal_default":
        dispatched["null_sink"] == dispatched["default"],
        "hot_swap": len(swaps) == 1 and bridge.telemetry is tee,
        "paged_launches": launches == decode_steps * sum(
            cfg.layer_is_attn(i) for i in range(cfg.n_layers)) > 0}
    itl = [x.itl_s for x in samples if x.steps]
    return {"checks": checks, "samples": len(samples), "steps": len(steps),
            "paged_decode_attn_launches": launches, "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_s": sorted(t for x in samples for t in x.ttft_s),
            "itl_ms_median": float(np.median(itl)) * 1e3 if itl else None,
            "dispatched_ops": dispatched,
            "hot_swap": to_record(swaps[0]) if swaps else None}


def telemetry_lm(cfg, tr, ds, batches, done, sink):
    """``lm_train``'s trainer (gemma3-1b), 2 rounds with ``NullSink`` (the
    fused rounds) and 2 with a sink (the phase-fenced rounds): a phased
    RoundTrace a round, its phases named in PHASE_NAMES, and a
    WorkerAssessment; s/round each way, each round's phases."""
    from repro_torch.obs import NULL, PHASE_NAMES
    rounds = 2
    null_s = run_lm_rounds(tr, ds, batches, rounds, done, telemetry=NULL)
    tee = TeeSink(sink)
    sink_s = run_lm_rounds(tr, ds, batches, rounds, done + rounds,
                           telemetry=tee)
    traces = tee.ring.by_kind("round_trace")
    names = {"local_steps", "judge", "reduce", "finalize"}
    checks = {
        "phased_trace_a_round": len(traces) == rounds
        and all(t.detail == "phased" and set(t.phases) == names
                and set(t.phases) <= set(PHASE_NAMES) for t in traces),
        "assessment_a_round": len(tee.ring.by_kind("worker_assessment"))
        == rounds}
    phases = {k: float(np.mean([t.phases[k] for t in traces]))
              for k in sorted(names)} if traces else {}
    return {"checks": checks, "rounds": rounds,
            "null_sink_s_per_round": null_s / rounds,
            "phased_s_per_round": sink_s / rounds,
            "phases_mean_s": phases,
            "phases_by_round": [t.phases for t in traces],
            "total_s": [t.total_s for t in traces],
            "host_staging_s": [t.host_staging_s for t in traces]}


def phase_telemetry(dev, path, sink, serve_part, lm_part):
    """Telemetry through one ``JsonlSink``: the serving and gemma3-1b
    parts (``telemetry_serve``, ``telemetry_lm``, run while their engine
    and trainer lived), then a CNN6 elastic run with checkpoints (p 8 ->
    6 at round 3 -> 10 at round 5, a save every 4 rounds, 8 rounds):
    MembershipChange and CheckpointSave. The file is read back with
    ``repro_torch.obs.read_events``: every record there."""
    import tempfile
    from repro_torch.core.membership import MembershipSchedule
    from repro_torch.obs import read_events
    tee = TeeSink(sink)
    tr, dataset = new_trainer(dev)
    events = {3: 6, 5: 10}
    with tempfile.TemporaryDirectory() as d:
        tr.run(dataset(), 8, telemetry=tee,
               membership_schedule=MembershipSchedule(TRAIN["p"], events),
               checkpoint_every=4, checkpoint_path=d)
    mc = [(e.round, e.old_p, e.new_p) for e in
          tee.ring.by_kind("membership_change")]
    cs = tee.ring.by_kind("checkpoint_save")
    sink.close()
    kinds = {}
    for e in read_events(path):
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    checks = {
        "membership_changes": mc == [(3, 8, 6), (5, 6, 10)],
        "checkpoint_saves": sorted(e.round for e in cs) == [4, 8]
        and all(e.nbytes > 0 and e.duration_s > 0 for e in cs),
        "read_back": kinds.get("serve_sample") == serve_part["samples"]
        and kinds.get("hot_swap") == 1
        and kinds.get("membership_change") == 2
        and kinds.get("checkpoint_save") == 2
        and kinds.get("round_trace") == lm_part["rounds"] + 8
        and kinds.get("worker_assessment") == lm_part["rounds"] + 8,
        **{f"serve/{k}": v for k, v in serve_part["checks"].items()},
        **{f"lm/{k}": v for k, v in lm_part["checks"].items()}}
    rec = {"phase": "telemetry", "records_by_kind": kinds,
           "checks": checks, "serve": serve_part, "lm": lm_part,
           "cnn6_elastic": {"membership_changes": mc,
                            "checkpoint_saves": [
                                {"round": e.round, "nbytes": e.nbytes,
                                 "duration_s": e.duration_s}
                                for e in cs]}}
    if not all(checks.values()):
        raise AssertionError(f"telemetry: {rec}")
    return rec


# -- decentralized WASGD on a one-rank NCCL group, and the launcher ----------

# mesh_agree: one aggregate each (spec, Alg. 4 mask); the CNN6 rounds timed
# per spec (1 warm-up + MESH["time_rounds"]); the parity runs' rounds
MESH = {"time_rounds": 3, "parity_rounds": 3, "noise": 0.01, "seed": 11,
        "masked": (2, 5)}
MESH_AGREE = (("shard_map:f32", False), ("rs_ag:f32", False),
              ("rs_ag:bf16", False), ("rs_ag:int8", False),
              ("rs_ag:int4", False), ("async_shard_map", True),
              ("async_rs_ag", True), ("pallas_wagg:f32", True),
              ("auto", False))
MESH_TIMED = ("shard_map:f32", "rs_ag:f32", "rs_ag:bf16", "rs_ag:int8",
              "rs_ag:int4", "einsum:f32", "pallas_wagg:f32")
MESH_LM = {**LM, "backend": "rs_ag:f32", "warmup_rounds": 1, "rounds": 1}
# mesh_baselines: each baseline rule on CNN6 at baselines' settings, 1 + 3
# rounds under the group and without it
MESH_BASELINES = {"warmup_rounds": 1, "rounds": 3}
# mesh_elastic: mesh_lm's trainer through one round 4 -> 2, a sharded save
# at p 2 and a resume (the round after it run twice), one round 2 -> 4
MESH_ELASTIC = {"low_p": 2}
# the launcher at --workers 2: 2 rounds and one 8 GB sharded save (the
# time limit)
LAUNCH = {"workers": 2, "rounds": 2, "checkpoint_every": 2}


@contextlib.contextmanager
def nccl_mesh(dev):
    """A one-rank NCCL process group (a FileStore in a temporary
    directory; ``device_id`` starts NCCL at once, so a failure to start
    fails here) and a ``("data",)`` DeviceMesh over it; the group is
    destroyed on exit."""
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1, device_id=dev)
        try:
            yield init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        finally:
            dist.destroy_process_group()


def device_ops(prof):
    """Every device operation of a profiler run by name: count and ms."""
    import torch
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            out[e.key[:80]] = {"count": e.count, "device_ms": us / 1e3}
    return out


def mesh_cnn6_run(dev, mesh, spec, rounds, pipeline=None):
    """A fresh CNN6 WASGD+ trainer at ``TRAIN``'s settings through
    ``spec`` on ``mesh`` (None: meshless), ``rounds`` rounds over an
    OrderedDataset with boundary_delay = the prefetcher's run-ahead (every
    worker's rows; the trainer takes its own), after a one-round warm-up
    on another trainer. Returns the trainer, the timed wall and the
    wagg_fused launches of the timed run."""
    import torch
    from repro_torch.core import shared_axes
    from repro_torch.data import OrderedDataset, RoundPrefetcher
    from repro_torch.kernels.wagg import wagg_fused
    from repro_torch.models import init_cnn6
    from repro_torch.train import Trainer
    from repro_torch.data import make_images
    loss_fn, tcfg, _ = cnn6_setup()
    X, y = make_images(0, TRAIN["n_images"])

    def trainer():
        params = init_cnn6(0, device=dev)
        return Trainer(loss_fn, params, shared_axes(params), tcfg(spec),
                       TRAIN["p"], rule="wasgd+", device=dev, mesh=mesh,
                       pipeline=pipeline)

    def dataset():
        return OrderedDataset(
            {"x": X, "y": y}, TRAIN["p"], TRAIN["tau"], TRAIN["b_local"],
            n_segments=TRAIN["n_segments"], seed=TRAIN["order_seed"],
            boundary_delay=RoundPrefetcher.run_ahead())

    trainer().run(dataset(), 1)
    tr = trainer()
    reset_wagg()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(dataset(), rounds)
    torch.cuda.synchronize()
    return tr, time.perf_counter() - t0, wagg_fused.launches


def phase_mesh_agree(dev, mesh):
    import torch
    from repro_torch.core import backends as B
    from repro_torch.core import shared_axes
    from repro_torch.core.codecs import get_codec
    from repro_torch.kernels.wagg import wagg_fused
    from repro_torch.models import init_cnn6
    p = TRAIN["p"]
    base = init_cnn6(0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(MESH["seed"])
    params = {k: v.unsqueeze(0) + MESH["noise"] * torch.randn(
        (p,) + tuple(v.shape), generator=gen, device=dev)
        for k, v in base.items()}
    axes = {k: ("worker",) + ax for k, ax in shared_axes(base).items()}
    theta = torch.softmax(torch.randn(p, generator=gen, device=dev), 0)
    active = torch.ones(p, dtype=torch.bool, device=dev)
    active[list(MESH["masked"])] = False
    theta_m = torch.where(active, theta, 0.0)
    theta_m = theta_m / theta_m.sum()
    agree, ok = {}, True
    reset_wagg()
    for spec, masked in MESH_AGREE:
        th = theta_m if masked else theta
        act = active if masked else None
        name = (B.select_auto_spec(params, axes, mesh) if spec == "auto"
                else spec)
        codec = B.resolve_spec(name)[1] or "f32"
        got = B.get_backend(name).aggregate(
            params, axes, th, 0.9, ctx=B.AggregationContext(mesh=mesh,
                                                            active=act))
        ref = B.get_backend(f"einsum:{codec}").aggregate(
            params, axes, th, 0.9, ctx=B.AggregationContext(active=act))
        rec = {"spec": name, "masked": masked, "codec": codec}
        worst = 0.0
        for k in params:
            err = float((got[k].float() - ref[k].float()).abs().max())
            scale = float(ref[k].float().abs().max())
            # bf16: two rounding paths, each within the codec's bound
            tol = (2 * float(get_codec("bf16").error_bound(params[k], th,
                                                           0.9))
                   if codec == "bf16" else 1e-6 * scale)
            worst = max(worst, err / tol)
        rec["max_err_over_tol"] = worst
        ok &= worst <= 1.0
        agree[spec] = rec
    agg_launches = wagg_fused.launches
    # the device operations of one rs_ag aggregate and of one rs_ag round
    with device_profile() as prof:
        B.get_backend("rs_ag:f32").aggregate(
            params, axes, theta, 0.9, ctx=B.AggregationContext(mesh=mesh))
        torch.cuda.synchronize()
    agg_ops = device_ops(prof)
    tr, _, _ = mesh_cnn6_run(dev, mesh, "rs_ag:f32", 1)
    gen = cnn6_setup()[2](p).batches(start_round=1)   # every worker's rows
    batch = next(gen)
    with device_profile() as prof:
        tr.run(iter([batch]), 1)
        torch.cuda.synchronize()
    round_ops = device_ops(prof)
    del tr, gen
    nccl = {k: v for k, v in {**agg_ops, **round_ops}.items()
            if "nccl" in k.lower()}
    # s/round of each spec under the group, and the meshless references
    timed, launches, leaves = {}, {}, {}
    for spec in MESH_TIMED:
        _, wall, n = mesh_cnn6_run(dev, mesh, spec, MESH["time_rounds"])
        timed[spec] = wall / MESH["time_rounds"]
        launches[spec], leaves[spec] = n, wagg_fused.leaves
    for spec in ("einsum:f32", "pallas_wagg:f32"):
        _, wall, n = mesh_cnn6_run(dev, None, spec, MESH["time_rounds"])
        timed[f"{spec} (meshless)"] = wall / MESH["time_rounds"]
        launches[f"{spec} (meshless)"] = n
        leaves[f"{spec} (meshless)"] = wagg_fused.leaves
    # under the mesh each gathered leaf is a launch of its own; meshless,
    # the tree is one grouped launch
    want_wagg = MESH["time_rounds"] * CNN6_LEAVES
    # pipelined rs_ag against unpipelined, deterministic cuDNN
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        runs = [mesh_cnn6_run(dev, mesh, "rs_ag:f32", MESH["parity_rounds"],
                              pipeline=pipe)[0] for pipe in (None, "parity")]
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    parity = {"history_bitwise": history_bitwise(runs[0].history,
                                                 runs[1].history),
              "params_bitwise": params_bitwise(runs[0].state.params,
                                               runs[1].state.params)}
    checks = {"agree": ok, "parity": all(parity.values()),
              "wagg_launches_gathered": agg_launches == CNN6_LEAVES
              and launches["pallas_wagg:f32"] == want_wagg
              and leaves["pallas_wagg:f32"] == want_wagg,
              "wagg_grouped_meshless":
                  launches["pallas_wagg:f32 (meshless)"]
                  == MESH["time_rounds"]
                  and leaves["pallas_wagg:f32 (meshless)"] == want_wagg,
              "wagg_none_through_rs_ag": launches["rs_ag:f32"] == 0,
              "finite": all(bool(np.isfinite(r.losses()).all())
                            for r in runs)}
    rec = {"phase": "mesh_agree", "model": "cnn6", **TRAIN,
           "group": "nccl, world 1", "mesh": "('data',) of 1",
           "checks": checks, "agree": agree, "parity": parity,
           "parity_rounds": MESH["parity_rounds"],
           "seconds_per_round": timed, "time_rounds": MESH["time_rounds"],
           "wagg_launches": {"aggregates": agg_launches, **launches},
           "wagg_leaves": leaves,
           "nccl_ops": nccl,
           "device_ops_rs_ag_aggregate": agg_ops,
           "device_ops_rs_ag_round_count": sum(
               v["count"] for v in round_ops.values())}
    if not all(checks.values()):
        raise AssertionError(f"mesh_agree: {rec}")
    return rec


def phase_mesh_baselines(dev, mesh):
    """CNN6 at baselines' settings (``TRAIN``, p 8;
    ``benchmarks/convergence.py:12-19``) through each baseline rule for 1
    + 3 rounds on the group and without it, deterministic cuDNN: omwu,
    mmwu and seq bitwise the meshless run (every round's h and theta, the
    params after each round read); spsgd and easgd within 1e-6 relative
    after the first round, whose local steps are the meshless ones bit
    for bit (the all-reduce sums the rows in its own order, and CNN6
    amplifies a last bit over a round's 8 steps, so later rounds are
    read, not held). s/round of the 3 rounds after the first, each way,
    from the round hook's stamps."""
    import torch
    from repro_torch.core import shared_axes
    from repro_torch.models import init_cnn6
    from repro_torch.train import Trainer
    loss_fn, tcfg, dataset = cnn6_setup()
    warm, rounds = MESH_BASELINES["warmup_rounds"], MESH_BASELINES["rounds"]
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    res, ok = {}, True
    try:
        for rule in BASELINE_RULES:
            runs = {}
            for name, m in (("mesh", mesh), ("meshless", None)):
                params = init_cnn6(0, device=dev)
                tr = Trainer(loss_fn, params, shared_axes(params),
                             tcfg("einsum:f32"), TRAIN["p"], rule=rule,
                             device=dev, mesh=m,
                             easgd_alpha=EASGD_ALPHA if rule == "easgd"
                             else None)
                snaps, stamps = [], []

                def hook(r, prm, axes):
                    stamps.append(time.perf_counter())
                    snaps.append({k: v.clone() for k, v in prm.items()})

                tr.run(dataset(), warm + rounds, serve_hook=hook)
                runs[name] = (tr, snaps, (stamps[-1] - stamps[warm - 1])
                              / rounds)
            (tr_m, sn_m, s_m), (tr_p, sn_p, s_p) = (runs["mesh"],
                                                    runs["meshless"])
            rel = [max(float((a[k] - b[k]).abs().max())
                       / max(float(b[k].abs().max()), 1e-30) for k in b)
                   for a, b in zip(sn_m, sn_p)]
            hist = [all(np.array_equal(a[k], b[k]) for k in ("h", "theta"))
                    for a, b in zip(tr_m.history, tr_p.history)]
            if rule in ("omwu", "mmwu", "seq"):
                held = all(hist) and all(x == 0.0 for x in rel) and all(
                    torch.equal(tr_m.state.params[k], v)
                    for k, v in tr_p.state.params.items())
            else:
                held = hist[0] and rel[0] <= 1e-6
            losses = tr_m.losses()
            held &= bool(np.isfinite(losses).all())
            ok &= held
            res[rule] = {"held": held, "max_rel_per_round": rel,
                         "h_theta_bitwise_per_round": hist,
                         "seconds_per_round": s_m,
                         "meshless_seconds_per_round": s_p,
                         "loss_first": float(losses[0]),
                         "loss_last": float(losses[-1])}
            del runs, tr_m, tr_p, sn_m, sn_p
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    rec = {"phase": "mesh_baselines", "model": "cnn6", **TRAIN,
           "group": "nccl, world 1", "rounds": f"{warm} + {rounds}",
           "easgd_alpha": EASGD_ALPHA, "cudnn": "deterministic",
           "checks": {"held": ok}, "rules": res}
    if not ok:
        raise AssertionError(f"mesh_baselines: {rec}")
    return rec


def phase_mesh_lm(cfg, dev, mesh, keep=None):
    """gemma3-1b at lm_train's settings: a meshless einsum:f32 round, then
    a fresh pipelined trainer through rs_ag:f32 on the group for
    ``MESH_LM``'s rounds (seconds from the round hook's stamps) and one
    profiled
    round. ``keep["tr"]`` receives the trainer (mesh_elastic goes on with
    it)."""
    import torch
    from repro_torch.data import RoundPrefetcher
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.tree import tree_leaves
    delay = RoundPrefetcher.run_ahead()
    ref = new_lm_trainer(cfg, dev, st={**MESH_LM, "backend": "einsum:f32"})
    ref.run(lm_dataset(cfg, MESH_LM, boundary_delay=delay), 1)
    ref_params = tree_leaves(ref.state.params)
    ref_hist = ref.history[0]
    del ref
    warm, rounds = MESH_LM["warmup_rounds"], MESH_LM["rounds"]
    total = warm + rounds
    tr = new_lm_trainer(cfg, dev, st=MESH_LM, pipeline="parity", mesh=mesh)
    ds = lm_dataset(cfg, MESH_LM, boundary_delay=delay)
    seen, stamps = {}, []

    def hook(r, params, axes):
        stamps.append(time.perf_counter())
        if r == 0:
            worst = 0.0
            for x, y in zip(tree_leaves(params), ref_params):
                err = float((x - y).abs().max())
                worst = max(worst, err / max(float(y.abs().max()), 1e-30))
            seen["params_max_rel"] = worst
            ref_params.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for k in counters:
                k.launches = 0

    counters = (rmsnorm_fwd, add_rmsnorm_fwd, fused_ce_fwd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(ds, total, serve_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after0 = total - 1
    launches = {"rmsnorm": rmsnorm_fwd.launches,
                "rmsnorm_fused": add_rmsnorm_fwd.launches,
                "fused_ce": fused_ce_fwd.launches}
    norms, fused = norms_per_step(cfg)
    tau = MESH_LM["tau"]
    want = {"rmsnorm": after0 * tau * norms,
            "rmsnorm_fused": after0 * tau * fused,
            "fused_ce": after0 * tau}
    s_round = (stamps[-1] - stamps[warm - 1]) / rounds
    # every worker's rows (the trainer takes its own)
    gen = lm_dataset(cfg, MESH_LM, boundary_delay=delay).batches(
        start_round=total)
    with device_profile() as prof:
        tr.run(gen, 1)
        torch.cuda.synchronize()
    summary = device_summary(prof, s_round, 10)
    h0 = tr.history[0]
    losses = tr.losses()
    if keep is not None:
        keep["tr"] = tr
    del tr
    torch.cuda.empty_cache()
    checks = {"round0_h_bitwise": np.array_equal(h0["h"], ref_hist["h"]),
              "round0_theta_bitwise": np.array_equal(h0["theta"],
                                                     ref_hist["theta"]),
              "round0_params_within_1e-6": seen["params_max_rel"] <= 1e-6,
              "launches": launches == want,
              "finite": bool(np.isfinite(losses).all())}
    rec = {"phase": "mesh_lm", "arch": cfg.name, **MESH_LM,
           "pipeline": "parity", "group": "nccl, world 1",
           "checks": checks,
           "round0_params_max_rel_vs_einsum": seen["params_max_rel"],
           "launches_after_round_0": launches, "launches_want": want,
           "launches_per_round": {k: v / after0 for k, v in
                                  launches.items()},
           "seconds_per_round": s_round, "wall_s": wall,
           "peak_mem_gib_after_round_0": peak, **summary,
           "losses": [float(x) for x in losses]}
    if not all(checks.values()):
        raise AssertionError(f"mesh_lm: {rec}")
    return rec


def phase_mesh_elastic(cfg, dev, keep):
    """mesh_lm's gemma3-1b trainer (p 4, rs_ag:f32, "parity", on the
    one-rank group) through ``run(membership_schedule=)``: one round
    4 -> 2; at p 2 a sharded save under the mesh (the seconds it blocks,
    then to ``wait()``), one round, a ``resume`` (timed) and the same
    round again, bitwise; one round 2 -> 4. ``Trainer.resize`` is wrapped
    to hold each resize on its own: the survivors' rows bitwise, the
    newcomers within 1e-6 relative of the survivors' mean (the meshless
    formula, ``tensordot`` of 1/p)."""
    import tempfile
    import torch
    from repro_torch.core.membership import MembershipSchedule
    from repro_torch.data import RoundPrefetcher
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.tree import tree_leaves
    tr = keep.pop("tr")
    p, low = MESH_LM["p"], MESH_ELASTIC["low_p"]
    delay = RoundPrefetcher.run_ahead()
    resizes = []
    plain_resize = tr.resize

    def resize(new_p, round=None):
        old_p = tr.n_workers
        keep_rows = min(old_p, new_p)
        before = [x[:keep_rows].clone()
                  for x in tree_leaves(tr.state.params)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        event = plain_resize(new_p, round=round)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = tree_leaves(tr.state.params)
        survivors = all(torch.equal(x[:keep_rows], v)
                        for x, v in zip(after, before))
        newcomers = 0.0
        if new_p > old_p:
            t = torch.full((old_p,), 1.0 / old_p, device=dev)
            for x, v in zip(after, before):
                mean = torch.tensordot(t, v.float(), dims=1)
                err = float((x[old_p:].float() - mean).abs().max())
                newcomers = max(newcomers, err / max(
                    float(mean.abs().max()), 1e-30))
        resizes.append({"from": old_p, "to": new_p, "ms": ms,
                        "survivors_bitwise": survivors,
                        "newcomers_max_rel": newcomers if new_p > old_p
                        else None})
        del before
        return event

    tr.resize = resize
    counters = (rmsnorm_fwd, add_rmsnorm_fwd, fused_ce_fwd)
    for k in counters:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()

    def ds(p0):
        return lm_dataset(cfg, {**MESH_LM, "p": p0}, boundary_delay=delay)

    t_run = time.perf_counter()
    tr.run(ds(p), 1, membership_schedule=MembershipSchedule(p, {0: low}))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "round_1")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save_checkpoint(path, 1)
        block_s = time.perf_counter() - t0
        tr._ckpt.wait()
        wait_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        tr.run(ds(low).batches(start_round=1), 1)
        first = tr.history[-1]
        snap = [x.clone() for x in tree_leaves(tr.state.params)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        at = tr.resume(path)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        tr.run(ds(low).batches(start_round=1), 1)
    again = tr.history[-1]
    rerun = {"round": at, "history_bitwise": all(
        np.array_equal(first[k], again[k]) for k in ("h", "theta", "loss")),
        "params_bitwise": all(torch.equal(x, v) for x, v in zip(
            tree_leaves(tr.state.params), snap))}
    del snap
    tr.run(ds(low), 1, membership_schedule=MembershipSchedule(low, {0: p}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tr.resize = plain_resize
    launches = {"rmsnorm": rmsnorm_fwd.launches,
                "rmsnorm_fused": add_rmsnorm_fwd.launches,
                "fused_ce": fused_ce_fwd.launches}
    norms, fused = norms_per_step(cfg)
    n_rounds, tau = 4, MESH_LM["tau"]
    want = {"rmsnorm": n_rounds * tau * norms,
            "rmsnorm_fused": n_rounds * tau * fused,
            "fused_ce": n_rounds * tau}
    losses = [float(h["loss"]) for h in tr.history[-n_rounds:]]
    ps = [int(h["p"]) for h in tr.history[-n_rounds:] if "p" in h]
    workers = tr.n_workers
    del tr
    torch.cuda.empty_cache()
    checks = {"resizes": [(r["from"], r["to"]) for r in resizes]
              == [(p, low), (low, p)]
              and all(r["survivors_bitwise"] for r in resizes)
              and resizes[1]["newcomers_max_rel"] <= 1e-6,
              "resume_rerun_bitwise": at == 1 and rerun["history_bitwise"]
              and rerun["params_bitwise"],
              "p_recorded": ps == [low, p] and workers == p,
              "launches": launches == want,
              "finite": bool(np.isfinite(losses).all())}
    rec = {"phase": "mesh_elastic", "arch": cfg.name, **MESH_LM,
           "pipeline": "parity", "group": "nccl, world 1",
           "checks": checks, "resizes": resizes, "rerun": rerun,
           "checkpoint_bytes": nbytes, "save_blocks_s": block_s,
           "save_to_wait_s": wait_s, "resume_s": resume_s,
           "peak_mem_gib": peak, "wall_s": wall, "launches": launches,
           "launches_want": want, "losses": losses}
    if not all(checks.values()):
        raise AssertionError(f"mesh_elastic: {rec}")
    return rec


def phase_launch_train(cfg, dev):
    """``repro_torch.launch.train.main`` in this process on ``cfg`` at
    full width: ``LAUNCH``'s --workers and --rounds with telemetry,
    sharded checkpoints every 2 rounds and the final flat checkpoint, in
    a temporary directory."""
    import contextlib as ctxlib
    import io
    import tempfile
    import torch
    from repro_torch.checkpoint import restore
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.wagg import wagg_fused
    from repro_torch.launch.train import main as train_main
    from repro_torch.obs import read_events
    from repro_torch.tree import tree_leaves
    counters = (rmsnorm_fwd, add_rmsnorm_fwd, fused_ce_fwd, wagg_fused)
    for k in counters:
        k.launches = 0
    with tempfile.TemporaryDirectory() as d:
        tele, ck = os.path.join(d, "run.jsonl"), os.path.join(d, "final")
        cdir = os.path.join(d, "ckpts")
        argv = ["--arch", cfg.name, "--workers", str(LAUNCH["workers"]),
                "--rounds", str(LAUNCH["rounds"]), "--telemetry", tele,
                "--checkpoint-dir", cdir, "--checkpoint-every",
                str(LAUNCH["checkpoint_every"]), "--ckpt", ck,
                "--device", "cuda"]
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctxlib.redirect_stdout(buf):
            tr = train_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"rmsnorm": rmsnorm_fwd.launches,
                    "rmsnorm_fused": add_rmsnorm_fwd.launches,
                    "fused_ce": fused_ce_fwd.launches,
                    "wagg_fused": wagg_fused.launches}
        out = buf.getvalue().splitlines()
        printed = int(out[0].split("params=")[1].split()[0].replace(",", ""))
        numel = sum(x[0].numel() for x in tree_leaves(tr.state.params))
        kinds = [e.kind for e in read_events(tele)]
        t1 = time.perf_counter()
        restored, meta = restore(ck, tr.state.params)
        flat_bitwise = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(restored), tree_leaves(tr.state.params)))
        restore_s = time.perf_counter() - t1
        del restored
        disk = {name: sum(os.path.getsize(os.path.join(r, f))
                          for r, _, fs in os.walk(os.path.join(d, name))
                          for f in fs) for name in ("final", "ckpts")}
        ckpts = sorted(os.listdir(cdir))
    losses = tr.losses()
    del tr
    torch.cuda.empty_cache()
    norms, fused = norms_per_step(cfg)
    steps = LAUNCH["rounds"] * 4                  # the launcher's tau 4
    want = {"rmsnorm": steps * norms, "rmsnorm_fused": steps * fused,
            "fused_ce": steps, "wagg_fused": 0}
    n_saves = LAUNCH["rounds"] // LAUNCH["checkpoint_every"]
    checks = {"params_printed_is_param_count": printed == cfg.param_count(),
              "header": out[0] == (f"arch={cfg.name} family={cfg.family} "
                                   f"params={cfg.param_count():,} "
                                   f"workers={LAUNCH['workers']}"),
              "telemetry_read_back": kinds.count("round_trace")
              == LAUNCH["rounds"] and kinds.count("checkpoint_save")
              == n_saves,
              "sharded_checkpoints": ckpts == [
                  f"round_{r}" for r in range(LAUNCH["checkpoint_every"],
                                              LAUNCH["rounds"] + 1,
                                              LAUNCH["checkpoint_every"])],
              "flat_checkpoint_bitwise": flat_bitwise
              and meta.get("rounds") == LAUNCH["rounds"],
              "launches": launches == want,
              "finite": bool(np.isfinite(losses).all())}
    rec = {"phase": "launch_train", "arch": cfg.name, "argv": argv,
           "checks": checks, "stdout": out, "params_printed": printed,
           "param_count": cfg.param_count(), "worker_numel": numel,
           "launches": launches, "launches_want": want, "wall_s": wall,
           "restore_s": restore_s, "checkpoint_bytes": disk,
           "telemetry_events": len(kinds),
           "losses": [float(x) for x in losses]}
    if not all(checks.values()):
        raise AssertionError(f"launch_train: {rec}")
    return rec


# mesh_olmoe: olmoe-1b-7b at OLMOE_TRAIN's settings through rs_ag:f32 on the
# one-rank NCCL group (the experts one copy, their gradient all-reduced
# over the worker group), round 0 held to olmoe_train's, then 1 timed and
# 1 profiled round. Round 0's h, theta and the two leaves of
# MESH_OLMOE_KEYS (an expert leaf and a worker leaf) may differ from
# olmoe_train's by MESH_OLMOE_SPREAD times the difference between two
# meshless round 0s of this run (the MoE backward's index adds run in
# another order each time), and always by MESH_OLMOE_FLOOR relative
# (float32 summation order: rs_ag's aggregate against wagg_fused's)
MESH_OLMOE = {**OLMOE_TRAIN, "backend": "rs_ag:f32", "warmup_rounds": 1,
              "rounds": 1}
MESH_OLMOE_KEYS = ("layers//L0//moe//experts//w_up", "layers//L0//attn//wq")
MESH_OLMOE_SPREAD = 4.0
MESH_OLMOE_FLOOR = 1e-6
# the examples on the card: torch_train_e2e at its ~100M config (JAX's
# flags, 3 rounds: a sharded checkpoint every round) and torch_serve_demo
EXAMPLES = {"e2e_rounds": 3, "e2e_tau": 4, "eval_batches": 4}


def olmoe_round0(cfg, dev, st, mesh=None):
    """A fresh olmoe trainer at ``st``'s settings (on ``mesh`` if given)
    after its round 0: the trainer, its dataset and batches, round 0's h,
    theta and ``MESH_OLMOE_KEYS`` leaves on the host, and the round's
    seconds."""
    tr, ds = new_lm_trainer(cfg, dev, st, mesh=mesh), lm_dataset(cfg, st)
    batches = ds.batches()
    leaves = {}
    wall = run_lm_rounds(tr, ds, batches, 1, 0, serve_hook=round0_snapshot(
        MESH_OLMOE_KEYS, leaves))
    return tr, ds, batches, round0_of(tr, leaves), wall


def phase_mesh_olmoe(cfg, dev, ref, olmoe_peak_gib):
    """olmoe-1b-7b at full width and depth (the experts one f32 copy, no
    worker axis) through ``rs_ag:f32`` on a one-rank NCCL group: round 0
    against ``olmoe_train``'s round 0 (``ref``) within the run's own
    spread (``MESH_OLMOE``'s comment), then 1 timed round (s/round, peak
    beside olmoe_train's, launches of rmsnorm and fused_ce, none of
    wagg_fused) and 1 profiled round (idle share)."""
    import torch
    from repro_torch.core import is_worker_leaf
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.wagg import wagg_fused
    from repro_torch.tree import tree_leaves
    gib = 2 ** 30
    tr, _, _, again, rerun_s = olmoe_round0(cfg, dev, OLMOE_TRAIN)
    del tr
    torch.cuda.empty_cache()
    with nccl_mesh(dev) as mesh:
        tr, ds, batches, got, warm_s = olmoe_round0(cfg, dev, MESH_OLMOE,
                                                    mesh)
        experts = [tuple(x.shape) for x, ax in zip(
            tree_leaves(tr.state.params), tree_leaves(tr.axes))
            if not is_worker_leaf(ax)]
        torch.cuda.reset_peak_memory_stats()
        counters = (rmsnorm_fwd, add_rmsnorm_fwd, fused_ce_fwd, wagg_fused)
        for k in counters:
            k.launches = 0
        wall = run_lm_rounds(tr, ds, batches, 1, 1)
        peak = torch.cuda.max_memory_allocated() / gib
        launches = {"rmsnorm": rmsnorm_fwd.launches,
                    "rmsnorm_fused": add_rmsnorm_fwd.launches,
                    "fused_ce": fused_ce_fwd.launches,
                    "wagg_fused": wagg_fused.launches}
        with device_profile() as prof:
            wall_prof = run_lm_rounds(tr, ds, batches, 1, 2)
        summary = device_summary(prof, wall, 12)
        losses = tr.losses()
        del tr, batches
    torch.cuda.empty_cache()

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    spread = {k: rel(again[k], ref[k]) for k in ref}
    dev_ = {k: rel(got[k], ref[k]) for k in ref}
    tol = {k: max(MESH_OLMOE_FLOOR, MESH_OLMOE_SPREAD * spread[k])
           for k in ref}
    tau = MESH_OLMOE["tau"]
    norms, fused = norms_per_step(cfg)
    want = {"rmsnorm": tau * norms, "rmsnorm_fused": tau * fused,
            "fused_ce": tau, "wagg_fused": 0}
    m = cfg.moe
    checks = {"round0_within_tolerance": all(dev_[k] <= tol[k] for k in ref),
              "experts_one_copy": experts and all(
                  e == (m.n_experts, cfg.d_model, m.d_ff_expert)
                  or e == (m.n_experts, m.d_ff_expert, cfg.d_model)
                  for e in experts if len(e) == 3),
              "launches": launches == want,
              "peak_within_2_gib": abs(peak - olmoe_peak_gib) <= 2.0,
              "finite": bool(np.isfinite(losses).all())}
    rec = {"phase": "mesh_olmoe", "arch": cfg.name, **MESH_OLMOE,
           "group": "nccl, world 1", "checks": checks,
           "round0_rel_dev_vs_olmoe_train": dev_,
           "round0_rel_spread_meshless_rerun": spread,
           "round0_tolerance": tol, "tolerance_rule": (
               f"max({MESH_OLMOE_FLOOR}, {MESH_OLMOE_SPREAD} x the rerun's "
               f"spread), relative to max|olmoe_train's|"),
           "shared_leaf_shapes": sorted(set(experts)),
           "launches": launches, "launches_want": want,
           "seconds_per_round": wall, "round0_s": warm_s,
           "meshless_rerun_round0_s": rerun_s,
           "peak_mem_gib": peak, "olmoe_train_peak_mem_gib": olmoe_peak_gib,
           "profile": {"rounds": 1, "wall_ms_profiled": wall_prof * 1e3,
                       **summary},
           "losses": [float(v) for v in losses]}
    if not all(checks.values()):
        raise AssertionError(f"mesh_olmoe: {rec}")
    return rec


def load_example(name):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(dev):
    """The port's examples as a user runs them, on their default device
    (cuda), in this process: ``torch_train_e2e`` at its ~100M config
    (``EXAMPLES``' rounds, its metrics and checkpoints in a temporary
    directory; rmsnorm and fused_ce launches counted against its local
    steps and its 4 evaluation batches) and ``torch_serve_demo`` (its own
    asserts; paged_decode_attn, rmsnorm, decode_attn and ssd_chunk
    launched)."""
    import contextlib as ctxlib
    import io
    import tempfile
    import torch
    from repro_torch.kernels.decode_attn import decode_attn, paged_decode_attn
    from repro_torch.kernels.fused_ce import fused_ce_fwd
    from repro_torch.kernels.rmsnorm import add_rmsnorm_fwd, rmsnorm_fwd
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.kernels.wagg import wagg_fused
    counters = {"rmsnorm": rmsnorm_fwd, "rmsnorm_fused": add_rmsnorm_fwd,
                "fused_ce": fused_ce_fwd, "wagg_fused": wagg_fused,
                "paged_decode_attn": paged_decode_attn,
                "decode_attn": decode_attn, "ssd_chunk": ssd_chunk}

    def run(fn):
        for k in counters.values():
            k.launches = 0
        buf = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctxlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
        return (out, buf.getvalue().splitlines(),
                {k: v.launches for k, v in counters.items()},
                time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 2 ** 30)

    e2e = load_example("torch_train_e2e")
    rounds = EXAMPLES["e2e_rounds"]
    with tempfile.TemporaryDirectory() as d:
        metrics_path, ck = os.path.join(d, "m.jsonl"), os.path.join(d, "ck")
        (tr, held), lines, e2e_launches, e2e_s, e2e_peak = run(
            lambda: e2e.main(["--rounds", str(rounds), "--metrics",
                              metrics_path, "--ckpt", ck]))
        n_records = len(open(metrics_path).read().splitlines())
        ckpts = sorted(os.listdir(ck))
    losses = tr.losses()
    del tr
    torch.cuda.empty_cache()
    cfg = e2e.model_100m()
    norms, fused = norms_per_step(cfg)
    calls = rounds * EXAMPLES["e2e_tau"] + EXAMPLES["eval_batches"]
    want = {"rmsnorm": calls * norms, "rmsnorm_fused": calls * fused,
            "fused_ce": calls}
    demo = load_example("torch_serve_demo")
    _, demo_lines, demo_launches, demo_s, demo_peak = run(lambda: demo.main(
        []))
    torch.cuda.empty_cache()
    checks = {
        "e2e_header": lines[0] == (
            f"model={cfg.name} params={cfg.param_count():,} workers=4 "
            f"tau={EXAMPLES['e2e_tau']}"),
        "e2e_launches": {k: e2e_launches[k] for k in want} == want,
        "e2e_outputs": n_records == rounds and ckpts == [
            f"round_{r}" for r in range(1, rounds + 1)]
        and bool(np.isfinite(losses).all())
        and all(np.isfinite(v) for v in held.values()),
        "serve_demo_ok": demo_lines[-1] == "serving demo OK",
        "serve_demo_kernels": all(demo_launches[k] > 0 for k in (
            "paged_decode_attn", "rmsnorm", "decode_attn", "ssd_chunk"))}
    rec = {"phase": "examples", "checks": checks,
           "train_e2e": {"config": cfg.name, "params": cfg.param_count(),
                         "rounds": rounds, "launches": e2e_launches,
                         "launches_want": want, "wall_s": e2e_s,
                         "peak_mem_gib": e2e_peak, "held_out": held,
                         "losses": [float(v) for v in losses],
                         "stdout": lines},
           "serve_demo": {"launches": demo_launches, "wall_s": demo_s,
                          "peak_mem_gib": demo_peak, "stdout": demo_lines}}
    if not all(checks.values()):
        raise AssertionError(f"examples: {rec}")
    return rec


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this "
                 "script measures the port on an NVIDIA card only")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import RoundPrefetcher
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attn import paged_decode_attn
    from repro_torch.models import cast_params, init_params
    from repro_torch.obs import JsonlSink
    from repro_torch.serve import ContinuousEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = build.build()
    build_s = time.perf_counter() - t0
    hmma = sass_mma(built["ssd_chunk"].path)
    if not hmma or not all(n > 0 for n in hmma.values()):
        raise AssertionError(f"ssd_chunk: an entry without HMMA: {hmma}")
    emit({"phase": "env", "seconds": build_s, "nvidia_smi": smi,
          "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "build_s": build_s, "nvcc_flags": " ".join(build.NVCC_FLAGS),
          "ptxas": {k: ptxas_summary(v.ptxas) for k, v in built.items()},
          "ssd_chunk_sass_hmma": hmma})

    run_phase(phase_kernel_check, dev)
    timing = run_phase(phase_kernel_time, dev)
    run_phase(phase_wagg_check, dev)
    wagg_timing = run_phase(phase_wagg_time, dev)
    run_phase(phase_rmsnorm_check, dev)
    norm_timing = run_phase(phase_rmsnorm_time, dev)
    run_phase(phase_ce_check, dev)
    ce_timing = run_phase(phase_ce_time, dev)
    run_phase(phase_decode_attn_check, dev)
    da_timing = run_phase(phase_decode_attn_time, dev)
    run_phase(phase_ssd_check, dev)
    ssd_timing = run_phase(phase_ssd_time, dev)
    torch.cuda.empty_cache()
    tele_dir = tempfile.TemporaryDirectory()
    tele_path = os.path.join(tele_dir.name, "telemetry.jsonl")
    tele_sink = JsonlSink(tele_path)

    cfg = get_config(ARCH)
    params = init_params(cfg, seed=0, device=dev)          # float32
    run_phase(phase_agree, cfg, params, dev)
    run_phase(phase_legacy_agree, cfg, params, dev)
    eng = ContinuousEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                           block_size=BLOCK, chunk=CHUNK, device=dev)
    del params                          # the engine keeps its bf16 copy
    torch.cuda.empty_cache()
    serve = run_phase(phase_serve, cfg, eng)
    serve_prof = run_phase(phase_serve_profile, cfg, eng)
    legacy = run_phase(phase_legacy_serve, cfg, eng.params, eng, dev)
    tele_serve = telemetry_serve(cfg, eng, tele_sink)
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    run_phase(phase_f32_cache_serve, cfg, params, dev)
    del params
    torch.cuda.empty_cache()

    scfg = get_config(SSM_ARCH)
    sparams = init_params(scfg, seed=0, device=dev)        # float32
    run_phase(phase_ssm_agree, scfg, sparams, dev)
    seng = ContinuousEngine(scfg, sparams, n_slots=N_SLOTS, max_len=MAX_LEN,
                            block_size=BLOCK, chunk=CHUNK, device=dev)
    del sparams
    ssm_serve = run_phase(phase_ssm_serve, scfg, seng)
    ssm_prof = run_phase(phase_ssm_serve_profile, scfg, seng)
    del seng
    torch.cuda.empty_cache()

    run_phase(phase_train_agree, dev)
    int4 = run_phase(phase_int4_codec, dev)
    train = run_phase(phase_train, dev)
    run_phase(phase_train_profile, dev)
    run_phase(phase_baselines, dev, train["seconds_per_round"])
    run_phase(phase_checkpoint, dev)
    async_agree = run_phase(phase_async_agree, dev)
    async_train = run_phase(phase_async_train, dev)
    measured = run_phase(phase_async_measured, dev)
    run_phase(phase_elastic, dev, train["loss_last"])
    pipe = run_phase(phase_pipeline_agree, dev)
    torch.cuda.empty_cache()

    run_phase(phase_lm_agree, cfg, dev)
    torch.cuda.empty_cache()
    run_phase(phase_lm_remat, cfg, dev)
    # the OrderGen decisions deferred past the prefetcher's run-ahead, so
    # that lm_pipeline's pipelined run can be held to this one bitwise
    tr = new_lm_trainer(cfg, dev)
    ds = lm_dataset(cfg, boundary_delay=RoundPrefetcher.run_ahead())
    batches = ds.batches()
    lm = run_phase(phase_lm_train, cfg, tr, ds, batches)
    lm_ref = lm_snapshot(tr)
    lm_prof = run_phase(phase_lm_train_profile, cfg, tr, ds, batches)
    run_phase(phase_dryrun, cfg, tr, lm, lm_prof, dev)
    done = LM["warmup_rounds"] + LM["rounds"] + 2 * LM_PROFILE_ROUNDS
    t2s = run_phase(phase_train_to_serve, cfg, tr, ds, batches, done, dev)
    tele_lm = telemetry_lm(cfg, tr, ds, batches,
                           done + TRAIN_TO_SERVE_ROUNDS, tele_sink)
    del tr, batches
    torch.cuda.empty_cache()
    lm_pipe = run_phase(phase_lm_pipeline, cfg, dev, lm_ref, lm)
    del lm_ref
    torch.cuda.empty_cache()
    run_phase(phase_telemetry, dev, tele_path, tele_sink, tele_serve,
              tele_lm)
    tele_dir.cleanup()
    with nccl_mesh(dev) as mesh:
        mesh_cnn6 = run_phase(phase_mesh_agree, dev, mesh)
        run_phase(phase_mesh_baselines, dev, mesh)
        torch.cuda.empty_cache()
        keep = {}
        mesh_lm = run_phase(phase_mesh_lm, cfg, dev, mesh, keep)
        mesh_el = run_phase(phase_mesh_elastic, cfg, dev, keep)
    torch.cuda.empty_cache()
    launch = run_phase(phase_launch_train, cfg, dev)
    torch.cuda.empty_cache()
    lm_async = run_phase(phase_lm_async, cfg, dev)
    torch.cuda.empty_cache()
    run_phase(phase_lm_windowed, dev)
    run_phase(phase_lm_agree, get_config(LM3B_ARCH), dev, "lm3b_agree")
    torch.cuda.empty_cache()
    lm3b = run_phase(phase_lm3b_train, dev)
    run_phase(phase_lm3b_f32, dev, lm3b["seconds_per_round"])

    ycfg = get_config(YI_ARCH)
    yparams = init_params(ycfg, seed=0, device=dev)        # float32
    run_phase(phase_yi_agree, ycfg, yparams, dev)
    ybf16 = cast_params(yparams, torch.bfloat16)
    del yparams             # the engine keeps what it is handed: 12 GB, not 24
    torch.cuda.empty_cache()
    yeng = ContinuousEngine(ycfg, ybf16, n_slots=N_SLOTS, max_len=MAX_LEN,
                            block_size=BLOCK, chunk=CHUNK, device=dev)
    del ybf16
    yi_serve = run_phase(phase_yi_serve, ycfg, yeng)
    del yeng
    torch.cuda.empty_cache()

    ssd_train = run_phase(phase_ssd_train_check, dev)
    run_phase(phase_ssm_lm_agree, scfg, dev)
    torch.cuda.empty_cache()
    ssm_lm = run_phase(phase_ssm_lm_train, scfg, dev)
    torch.cuda.empty_cache()
    ocfg = get_config(OLMOE_ARCH)
    oparams = init_params(ocfg, seed=0, device=dev)        # float32
    run_phase(phase_moe_agree, ocfg, oparams, dev)
    obf16 = cast_params(oparams, torch.bfloat16)
    del oparams             # the engine keeps what it is handed
    torch.cuda.empty_cache()
    oeng = ContinuousEngine(ocfg, obf16, n_slots=N_SLOTS, max_len=MAX_LEN,
                            block_size=BLOCK, chunk=CHUNK, device=dev)
    del obf16
    olmoe_serve = run_phase(phase_olmoe_serve, ocfg, oeng)
    del oeng
    torch.cuda.empty_cache()
    olmoe_round0 = {}
    olmoe_train = run_phase(phase_olmoe_train, ocfg, dev, olmoe_round0)
    torch.cuda.empty_cache()
    mesh_olmoe = run_phase(phase_mesh_olmoe, ocfg, dev, olmoe_round0,
                           olmoe_train["peak_mem_gib"])
    del olmoe_round0
    torch.cuda.empty_cache()
    jamba = run_phase(phase_jamba_serve, dev)
    torch.cuda.empty_cache()

    vcfg, vparams = media_model(VLM_ARCH, dev)           # 20 GB in bf16
    run_phase(phase_vlm_agree, vcfg, vparams, dev)
    vlm_serve = run_phase(phase_vlm_serve, vcfg, vparams, dev)
    del vparams
    torch.cuda.empty_cache()
    acfg, aparams = media_model(AUDIO_ARCH, dev)
    run_phase(phase_audio_agree, acfg, aparams, dev)
    audio_serve = run_phase(phase_audio_serve, acfg, aparams, dev)
    del aparams
    torch.cuda.empty_cache()
    audio_train = run_phase(phase_audio_train, dev)
    torch.cuda.empty_cache()
    vlm_train = run_phase(phase_vlm_train, dev)
    media_train = {"audio_train": audio_train, "vlm_train": vlm_train}
    torch.cuda.empty_cache()
    examples = run_phase(phase_examples, dev)
    demo = examples["serve_demo"]["launches"]

    t = timing["ring512"]
    w = wagg_timing["cnn6_round/none"]
    lm_leaf = wagg_timing["lm_mlp_leaf/none"]
    lm_leaf_masked = wagg_timing["lm_mlp_leaf/none/masked"]
    lm3b_leaf = wagg_timing["lm3b_mlp_leaf/int4"]
    nt = norm_timing["fused_train"]
    keys = ("x", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{
        "name": "paged_decode_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attn/csrc/"
                  "paged_decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn/paged.py:92",
        "launches": serve["launches"], "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": t["shape"],
        "linear": {k: timing["linear"][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "train_to_serve_launches": t2s["launches"]["paged_decode_attn"],
        "telemetry_serve_launches": tele_serve["paged_decode_attn_launches"],
        "yi_serve_launches": yi_serve["launches"],
        "olmoe_serve_launches": olmoe_serve["launches"],
        "jamba_serve_launches": jamba["launches"]["paged_decode_attn"],
        "examples_serve_demo_launches": demo["paged_decode_attn"],
        **{f"{arch}_linear1024": {k: timing[arch][k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")} for arch in PAGED_GQA},
        "serve_profile_device_kernels": serve_prof[
            "paged_decode_device_kernels"],
        "kernel_launches_one_decode_step": {
            "gemma3-1b": serve_prof["kernel_launches_one_decode_step"],
            "mamba2-370m": ssm_prof["kernel_launches_one_decode_step"]}}, {
        "name": "wagg_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/wagg/csrc/wagg_fused.cu",
        "replaces": "src/repro/kernels/wagg/wagg.py:88",
        "launches": train["launches"], "leaves": train["leaves"],
        "max_abs_err": w["max_abs_err"],
        "ms": w["ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"], "library_ms": w["library_ms"],
        "library": w["library"], "two_call_ms": w["two_call_ms"],
        "shape": w["leaves"],
        "launches_per_call": w["launches_per_call"],
        "note": "one call = one CNN6 round's aggregation (6 leaves in one "
                "wagg_fused_many call, f32 x, no payload); lm_mlp_leaf: "
                "p=4 x 1152*6912 f32",
        "lm_mlp_leaf": {k: lm_leaf[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "two_call_ms")},
        "lm_train_launches": lm["launches"]["wagg_fused"],
        "lm_train_leaves": lm["launches"]["wagg_leaves"],
        "lm_pipeline_launches": lm_pipe["launches"]["wagg_fused"],
        "pipeline_agree_launches": pipe["wagg_launches"],
        "mesh_agree_launches": {
            "aggregates": mesh_cnn6["wagg_launches"]["aggregates"],
            "pallas_wagg_under_the_mesh": mesh_cnn6["wagg_launches"][
                "pallas_wagg:f32"]},
        "train_to_serve_launches": t2s["launches"]["wagg_fused"],
        "lm3b_train_int4_launches": lm3b["launches"]["wagg_fused"],
        "ssm_lm_train_launches": ssm_lm["launches"]["wagg_fused"],
        "olmoe_train_launches": olmoe_train["launches"]["wagg_fused"],
        **{f"{k}_launches": v["launches"]["wagg_fused"]
           for k, v in media_train.items()},
        "cnn6_int4_launches": int4["cnn6"]["launches"],
        "lm3b_mlp_leaf_int4": {k: lm3b_leaf[k] for k in (
            "leaves", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "lm_mlp_leaf_masked": {k: lm_leaf_masked[k] for k in (
            "mask", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library", "three_call_ms")},
        "masked_launches": {
            "async_train": async_train["masked_launches"],
            "lm_async": lm_async["launches"]["wagg_fused_masked"],
            "async_agree": sum(v["wagg_launches_masked"] for v in
                               async_agree["strategies"].values()),
            "async_measured": measured["wagg_masked_launches"]},
        "lm_train_profile": lm_prof["port_kernels"].get(
            "wagg_fused_kernel")}, {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:29",
        "launches": lm["launches"]["rmsnorm"],
        "lm_pipeline_launches": lm_pipe["launches"]["rmsnorm"],
        "mesh_lm_launches": mesh_lm["launches_after_round_0"]["rmsnorm"],
        "mesh_elastic_launches": mesh_el["launches"]["rmsnorm"],
        "launch_train_launches": launch["launches"]["rmsnorm"],
        "max_abs_err": nt["max_abs_err"], "ms": nt["ms"],
        "plain_ms": nt["plain_ms"], "bound_ms": nt["bound_ms"],
        "bound_by": nt["bound_by"], "library_ms": nt["library_ms"],
        "library": nt["library"], "shape": nt["x"],
        "note": "the residual add fused in (s = x + delta, then the norm), "
                "at one local step of the LM run: x (4, 640, 1152) bf16, a "
                "scale per worker; launches from lm_train (all, fused or "
                "not; remat runs each layer's norms again in the backward)",
        "decode": {k: norm_timing["fused_decode"][k] for k in keys},
        "plain_norm": {k: norm_timing["train"][k] for k in keys},
        "plain_norm_decode": {k: norm_timing["decode"][k] for k in keys},
        "serve_launches": serve["rmsnorm_launches"],
        "serve_fused_launches": serve["rmsnorm_fused_launches"],
        "ssm_serve_launches": ssm_serve["rmsnorm_launches"],
        "legacy_serve_launches": legacy["rmsnorm_launches"],
        "train_to_serve_launches": t2s["launches"]["rmsnorm"],
        "evaluate_lm_launches": t2s["eval_launches"]["rmsnorm"],
        "lm3b_train_launches": lm3b["launches"]["rmsnorm"],
        "yi_serve_launches": yi_serve["rmsnorm_launches"],
        "ssm_lm_train_launches": ssm_lm["launches"]["rmsnorm"],
        "olmoe_serve_launches": olmoe_serve["rmsnorm_launches"],
        "olmoe_train_launches": olmoe_train["launches"]["rmsnorm"],
        "mesh_olmoe_launches": mesh_olmoe["launches"]["rmsnorm"],
        "examples_train_e2e_launches": examples["train_e2e"]["launches"][
            "rmsnorm"],
        "examples_serve_demo_launches": demo["rmsnorm"],
        "jamba_serve_launches": jamba["launches"]["rmsnorm"],
        "vlm_serve_launches": vlm_serve["launches"]["rmsnorm"],
        "audio_serve_launches": audio_serve["launches"]["rmsnorm"],
        **{f"{k}_launches": v["launches"]["rmsnorm"]
           for k, v in media_train.items()}}, {
        "name": "fused_ce", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_ce/csrc/fused_ce.cu",
        "replaces": "src/repro/kernels/fused_ce/fused_ce.py:67",
        "launches": lm["launches"]["fused_ce"],
        "lm_pipeline_launches": lm_pipe["launches"]["fused_ce"],
        "mesh_lm_launches": mesh_lm["launches_after_round_0"]["fused_ce"],
        "mesh_elastic_launches": mesh_el["launches"]["fused_ce"],
        "launch_train_launches": launch["launches"]["fused_ce"],
        "max_abs_err": ce_timing["max_abs_err"], "ms": ce_timing["ms"],
        "plain_ms": ce_timing["plain_ms"], "bound_ms": ce_timing["bound_ms"],
        "bound_by": ce_timing["bound_by"],
        "library_ms": ce_timing["library_ms"],
        "library": ce_timing["library"],
        "shape": [ce_timing["T"], ce_timing["V"]],
        "note": "one local step of the LM run: 2560 x 262144 f32 logits; "
                "launches from lm_train",
        "train_to_serve_launches": t2s["launches"]["fused_ce"],
        "evaluate_lm_launches": t2s["eval_launches"]["fused_ce"],
        "lm3b_train_launches": lm3b["launches"]["fused_ce"],
        "ssm_lm_train_launches": ssm_lm["launches"]["fused_ce"],
        "olmoe_train_launches": olmoe_train["launches"]["fused_ce"],
        "mesh_olmoe_launches": mesh_olmoe["launches"]["fused_ce"],
        "examples_train_e2e_launches": examples["train_e2e"]["launches"][
            "fused_ce"],
        **{f"{k}_launches": v["launches"]["fused_ce"]
           for k, v in media_train.items()}}, {
        "name": "decode_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn/decode_attn.py:78",
        "launches": legacy["launches"],
        "max_abs_err": da_timing["global1024"]["max_abs_err"],
        "ms": da_timing["global1024"]["ms"],
        "plain_ms": da_timing["global1024"]["plain_ms"],
        "bound_ms": da_timing["global1024"]["bound_ms"],
        "bound_by": da_timing["global1024"]["bound_by"],
        "library_ms": da_timing["global1024"]["library_ms"],
        "library": da_timing["global1024"]["library"],
        "shape": da_timing["global1024"]["shape"],
        "note": "a global layer of the legacy serve run (b 4, 1024-position "
                "cache, cache_len 528, bf16); launches from legacy_serve",
        "kernels_per_call": da_timing["global1024"]["kernels_per_call"],
        "legacy_serve_profile": legacy["decode_attn_device"],
        "vlm_serve_launches": vlm_serve["launches"]["decode_attn"],
        "audio_serve_launches": audio_serve["launches"]["decode_attn"],
        "vlm_serve_profile": vlm_serve["decode_attn_device"],
        "audio_serve_profile": audio_serve["decode_attn_device"],
        "examples_serve_demo_launches": demo["decode_attn"],
        **{layer: {k: da_timing[layer][k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "kernels_per_call")}
           for layer in ("ring512", "cross1600", "musicgen1024")}}, {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_chunk/ssd_chunk.py:61",
        "launches": ssm_serve["launches"],
        "max_abs_err": ssd_timing["prefill_b1"]["max_abs_err"],
        "ms": ssd_timing["prefill_b1"]["ms"],
        "plain_ms": ssd_timing["prefill_b1"]["plain_ms"],
        "bound_ms": ssd_timing["prefill_b1"]["bound_ms"],
        "bound_by": ssd_timing["prefill_b1"]["bound_by"],
        "library_ms": None, "shape": ssd_timing["prefill_b1"]["shape"],
        "note": "the mamba2-370m serve run's longest prefill (480 tokens "
                "padded to 512: b 1, nc 8); no single PyTorch call computes "
                "it; launches from ssm_serve",
        "bytes_ms": ssd_timing["prefill_b1"]["bytes_ms"],
        "f32_ops_ms": ssd_timing["prefill_b1"]["f32_ops_ms"],
        "ssm_serve_profile": ssm_prof["port_kernels"].get("ssd_chunk_kernel"),
        "ssm_lm_train_launches": ssm_lm["launches"]["ssd_chunk"],
        "ssm_lm_train_profile": ssm_lm["profile"].get(
            "port_kernels", {}).get("ssd_chunk_kernel"),
        "ssd_train_check_launches_per_call": [
            c["launches"] for c in ssd_train["cases"]],
        "jamba_serve_launches": jamba["launches"]["ssd_chunk"],
        "examples_serve_demo_launches": demo["ssd_chunk"],
        "prefill_b4": {k: ssd_timing["prefill_b4"][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bytes_ms", "f32_ops_ms",
            "bound_by")}}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
