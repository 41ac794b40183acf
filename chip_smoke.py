"""Smoke run of the PyTorch/CUDA port (``mmvae_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device and build: the card's name and power limit, TF32 off, and the
   hand-written kernels built from ``mmvae_torch/ops/csrc`` with ``nvcc``
   (the port's four sources and the launch-floor probe, one ``nvcc``
   each, started together; ``conv_s2.cu`` holds K4, its backward and its
   input gradient, and is compiled three times, at 32, 16 and 8 output
   channels);
2. each kernel held against its plain PyTorch version on the card, at the
   main paths' shapes and at ragged, odd and large ones (rtol 1e-5; atol
   1e-5 * D for the row reductions, 1e-5 * S * log V for the sequence
   cross-entropy, 1e-5 * 16 * C for the f32 conv, 1e-6 * 128 for K4's
   input gradient (4 taps x 32 channels an entry): the kernels sum in
   another order; the bf16 conv atol 2e-2, one bf16 rounding of outputs
   below 4; the fused PoE + KL atol 1e-6 for the posteriors and 1e-5 * L
   for the KL, whose rows with every expert absent must give exactly 0;
   the elementwise gradients of K1, K2 and K3 atol 1e-6, a pad token's K3
   gradient exactly 0; the fused PoE + KL's backward atol 1e-5 * T times
   its largest gradient, as it sums T terms; K4's backward atol 1e-6 * N,
   N = B * ceil(H/2) * ceil(W/2) the terms each entry of dW and db sums,
   and two of its launches equal to the bit, as two of K4's input
   gradient's are, whose upstream gradient is also taken transposed);
   K2 and its VJP on bf16 targets and K4 and its backward on a bf16 image
   (the ``data_dtype="bfloat16"`` train splits; f32 tolerances, a bf16
   value being exact in f32 and TF32), K3 and its VJP at a mounted CUB
   corpus's V = 2,004;
   among them CUB's train step's shapes, the mixture objectives' (the
   fused PoE + KL and its backward at MNIST's 2 mmvae and 3 mopoe
   components, K2 and its VJP on MNIST mopoe's 300 image rows and CelebA
   mopoe's 1,280 image and 23,040 attribute rows) and the IWAE's: K2 on
   b-major image rows, K2 through its map over examples of 18 attribute
   rows (``bce_rows_inner``), K3 on b-major tiled tokens and the fused PoE
   + KL at T = 1;
3. the main paths at full width, with seeded random weights, each with
   the launch counts set to 0 just before it and read just after:
   every eval runs the fused PoE + KL once per batch and K1 no time;
   - ``mnist`` (n_latents 64, 512-wide MLP experts): ``eval_elbo`` over
     the 2,000-example synthetic test split, ``generate`` from labels and
     ``sample``;
   - ``fashionmnist`` (n_latents 64, a conv image expert of features 32,
     64 over 28x28 grayscale on cuDNN, the label expert): ``eval_elbo``
     over its 2,000-example split, ``generate`` from labels and from
     images, and ``sample``;
   - ``multimnist`` (n_latents 256, conv features 32-256 over 50x50, GRU
     text experts of width 256): ``eval_elbo`` over its 2,000-example
     split, ``generate`` from text, from images and from nothing, and
     ``sample``;
   - ``celeba`` (n_latents 100, conv features 32-256 over 64x64 RGB, 18
     attribute experts, 19 experts in the PoE, batch 64): ``eval_elbo``
     over its 2,000-example split (32 batches), ``generate`` from
     images, from all 18 attributes, from ``attr_4`` and ``attr_8``
     alone and from nothing, and ``sample``;
   - ``cub`` (n_latents 256, conv features 32-256 over 64x64 RGB, GRU
     caption experts of embed 128 and hidden 256 over the 23-id
     vocabulary, batch 64): ``eval_elbo`` over its 2,000-example split (32
     batches), ``generate`` from images, from captions and from nothing,
     and ``sample``;
   then each eval again with the plain ``torch`` backend (rel 1e-5) and a
   CPU reference on a small split (rel 1e-4: CPU and card matmuls round
   differently; generated probabilities within 1e-4, tokens and labels
   generated at temperature 0 equal);
   - the IWAE: ``log_likelihood`` at k = 64 of every config over its
     2,000-example test split (one decode pass of 64 samples an example,
     folded b-major), launching per batch the fused PoE + KL once, K2 once
     per bernoulli key, K3 once per token modality and K4 once per RGB
     encoder; again with the ``torch`` backend from the same generator
     seed (rel 1e-5), and on a 10-example split at batch 4 on the card
     against the CPU with the noise passed in (rel 1e-4);
   - ``mnist`` training: ``api.train`` for one epoch at full width (100
     steps of batch 100 over the 10,000-example train split, then the test
     ELBO) on the CUDA-graph runners (each epoch and each eval split
     replays of one captured step), launching the fused PoE + KL and K2
     forward 120 times each and their backward kernels 100 times each,
     counted by the wrappers through the replays; its first-epoch test
     ELBO below the untrained model's; then the graph runner against the
     eager loop from the same weights, noise seed and batches over an
     epoch (loss and gradient norm each step, every parameter: rel 1e-6,
     and whether the bits are equal), one epoch of each timed in turns
     (train samples/s; the first calls too; what the capture adds), a profiled graph epoch (its
     idle share and device events a step; the profiler's count of each
     kernel's launches equal to the wrappers') and a profiled eager step
     with the card's capturable Adam and the CPU's plain one; three steps of the graph
     runner on the card against the eager loop on the CPU from the same
     weights, noise and batches (the loss each step at rel 1e-4, every
     parameter tensor at a relative 2-norm of 1e-4);
   - ``multimnist`` training (cross-recon, the cycle term on the soft and
     the thresholded render, clipping at 500): ``api.train`` for one epoch
     at full width over a train split cut to 2,000 examples (20 steps of
     batch 100, then the test ELBO) on the graph runners, launching the
     fused PoE + KL 80 times, K2 40, K3 80 and
     their backward kernels 60, 20 and 60; its first-epoch test ELBO below
     the untrained model's; the graph against the eager loop, timed in
     turns (one epoch each after the first calls), and profiled, as for
     ``mnist``; three steps at batch 20 on
     cuDNN's deterministic algorithms of the graph runner against the
     eager loop on the card (rel 1e-6) and against the CPU under the same
     gates as ``mnist`` (rel 1e-4), with the render pixels that land on
     other sides of 0.5 reported;
   - ``celeba`` training (4 random subset terms, T = 24, clipping at 500;
     K4 in stage 0 of the image encoder and its backward kernel):
     ``api.train`` for one epoch at full width over a train split cut to
     1,280 examples (20 steps of batch 64, then the 2,000-example test
     ELBO) on the graph runners, launching the fused PoE + KL 52 times, K2
     104, K4 52 and their backward kernels 20, 40 and 20; its first-epoch
     test ELBO below the untrained model's; the graph against the eager
     loop over an epoch on cuDNN's deterministic algorithms (rel 1e-6, the
     bits compared), and on its default ones timed in turns (one epoch each
     after the first calls) and profiled, as for ``mnist``; three steps at
     batch 16 of the graph runner on the card (cuDNN's deterministic
     algorithms) against the eager loop on the CPU, the random subset masks
     and the noise passed in, under the same gates as ``mnist``;
   - ``cub`` training (cross-recon, the cycle term at weight 0.1 on the
     soft render, its image decoder live on it; K4 on the encode and on the
     cycle's re-encode of the render, K4's backward twice and K4's input
     gradient once a step): ``api.train`` for one epoch at full width over a
     train split cut to 1,280 examples (20 steps of batch 64, then the
     2,000-example test ELBO) on the graph runners, launching the fused PoE
     + KL 72 times, K2 52, K3 72, K4 72 and the backward kernels 40, 20,
     40, 40 and K4's input gradient 20; its first-epoch test ELBO below the
     untrained model's; the graph against the eager loop gated as
     ``celeba``'s, both timed in turns and profiled (the device time split
     by kernel family); the step's caption experts (the GRUs) forward and
     backward timed alone; three steps at batch 16 on the card against the
     CPU with the noise passed in, under ``mnist``'s gates, the CPU's Adam
     fed the card's gradient components below 9 x Adam's eps (at rounding
     level, where Adam's normalisation has not saturated; the unfed reading
     reported beside it);
   - ``fashionmnist`` training: ``api.train`` for one epoch at full width
     (100 steps of batch 100, then the test ELBO), launching what
     ``mnist``'s does, under ``celeba``'s gates, the card against the CPU
     at batch 100 fed as ``cub``'s;
   - the mixture objectives (``mixture_train``): ``mnist`` at full width
     under mmvae, mopoe and mvtcae, each trained one epoch under
     ``celeba``'s gates (launching what ``mnist``'s does: the decode-all
     pass of the objective's terms is one K2 launch), its ``eval_elbo``
     and ``generate`` from the image alone and from the label alone, the
     mixture's mean and a draw (the fused PoE + KL once a mixture's
     generate), the eval and generate against the CPU, and three steps on
     the card against the CPU under ``mnist``'s gates;
   - ``celeba`` under mopoe (``celeba_mopoe_train``: 19 modalities fall
     back to the 20 terms of the joint and the unimodal rows, every key
     decoded on all of them, K2 on 1,280 image rows and 23,040 attribute
     rows a step), trained one epoch over 1,280 examples under
     ``celeba``'s gates, its ``eval_elbo`` and ``generate`` from the
     attributes alone, three steps on the card against the CPU;
   - ``multimnist`` with the three loss knobs no named config sets
     (``multimnist_knobs_train``: the cross entries from a second
     decode-all pass on detached decoders, the unimodal alignment at 0.1,
     the cycle render's contrast penalty at 1.0), trained one epoch as
     ``multimnist``'s, launching K2 and K3 once more a step, forward and
     backward, under its gates;
   - a workdir: ``mnist`` at full width over a train split cut to 2,000
     trained 2 epochs into a temporary workdir and resumed for a third,
     against an uninterrupted 3-epoch run (rel 1e-6), its ``metrics.jsonl``
     records counted by kind (3 eval records, the JAX loop's train records);
     ``eval_elbo`` from the workdir against the best epoch's recorded test
     ELBO (rel 1e-6), and ``generate`` and ``sample`` from it;
   - the training extras (``train_extras``): ``mnist`` at full width over
     a train split cut to 2,000 (20 micro-steps an epoch), 3 epochs of
     ``accum_steps`` 3 (an update straddles each epoch boundary), the
     cosine schedule warming up over epoch 1, clipping at 1, EMA 0.999, a
     train record every 5 steps: the epoch runner's graph (two captured
     bodies, a micro-step and one that commits the update) against its
     eager loop over 2 epochs to the bit on deterministic algorithms, the
     card against the CPU over the first 6 micro-steps (rel 1e-4), a run
     stopped after epoch 2 and resumed against an uninterrupted one (rel
     1e-6), ``ckpt_async`` against the synchronous saves to the bit (each
     stage's and save's wall), a NaN after epoch 2 rolled back to epoch 1
     and a NaN after every epoch raising, each run's ``metrics.jsonl``
     records by kind against the JAX loop's, the launches of the
     uninterrupted run (``mnist_accum_train``), samples/s and busy time a
     micro-step against the plain step; ``celeba`` with ``accum_steps`` 2
     (20 micro-steps of 64) graph against eager to the bit, its launches
     (``celeba_accum_train``: K4, its backward, the fused PoE + KL and its
     backward once a micro-step, K2 and its VJP twice) and its rate; and
     the CLI in processes of its own while the untimed gates run
     (``python -m mmvae_torch.cli train``, then ``eval`` of the test and
     the train split against ``api.eval_elbo`` (rel 1e-6), ``sample`` to
     a PNG, ``generate``), each exiting 0;
   - serving (``serving``): for each config, and ``mnist`` under
     mopoe, at full width on seed-0 weights, ``generate`` exported on the
     card with ``torch.export`` as a static batch-8 per-row artifact
     (``serving.export_generate``) and loaded with ``load_generate``: the
     loaded graph holds ``mmvae::poe_kl`` (and ``mmvae::conv4x4s2_swish``
     for CelebA and CUB), one call launches the fused PoE + KL once and K4
     once where the graph holds it (``serve_<config>``), each op's output
     inside the artifact (recorded by a dispatch mode) equals its plain
     version under the check phase's tolerances, the outputs at temperature
     0 equal ``api.generate``'s on the card (probabilities at rel 1e-6,
     labels and tokens equal) and the same artifact's loaded on the CPU
     (rel 1e-4, TF32 off); an artifact that draws z, exported by a process
     of its own while those gates run, serves requests of 1, 3 and 2 rows
     coalesced into one call by the host's ``Batcher`` to the bit of each
     served alone at temperature 1, on cuDNN's deterministic algorithms as
     the host runs (on its default ones reported, with whether two solo
     calls agree), and the HTTP host
     (``serve.make_handler``) on 127.0.0.1:0 answers a JSON and an npz
     request with equal outputs; the export and load seconds, the artifact's
     bytes, the call's p50 and p90 and the HTTP round trip of one row are
     printed. ``mnist`` and ``celeba`` also export a dynamic artifact: its
     call at batch 1, 8 and 64, and the first row's largest difference
     between those batches (printed, not gated); and, gated, one row
     through the host's ``Batcher`` served alone and coalesced with 7 and
     with 63 strangers, the same bits each time (on the card the host calls
     a dynamic artifact at its ``max_batch`` of 64 always);
   - the data layer (``data``): in a temporary ``$MMVAE_DATA_DIR`` the
     phase writes, from the port's generators with fixed seeds, MNIST as
     the distribution's IDX files (train gzipped, test plain) at their
     60,000 and 10,000 rows of uint8, a CUB ``.npz`` with captions over a
     corpus vocabulary of 2,004 ids (``vocab.json``) and a CelebA ``.npz``.
     ``mnist`` at full width trains 2 epochs of batch 100 on the IDX data
     under ``data_dtype`` float32, uint8 and bfloat16: the uint8 split
     dequantized on the card equals the f32 split to the bit, the uint8
     run's losses equal the f32 run's (rel 1e-6), the launches of the three
     runs are equal, and the bf16 run's losses and each run's resident
     train bytes are printed; ``cub`` at full width trains 10 steps on the
     corpus (its caption decoder has 2,004 outputs), then ``eval_elbo`` and
     ``generate``; ``celeba`` trains 10 steps under float32, bfloat16 and
     uint8 with equal launches; K2 and its VJP at bf16 targets, K4 and its
     backward at a bf16 image and K3 and its VJP at V = 2,004 are held
     against their plain versions at the runs' shapes; ``eval_elbo`` and
     ``log_likelihood`` of the mounted MNIST and CelebA test splits whole
     and in segments of 3 batches are equal to the bit (their walls
     printed); under ``MMVAE_DATAGEN=native`` the C++ generators, built
     into ``mmvae_torch/_build/``, give the same arrays twice and a CelebA
     epoch of 10 steps trains on their data;
   - the deep-trunk configs (``deep``): ``deep_mnist`` (residual trunks of
     4 stages at 256 with ReZero gates in both image experts; 100 steps of
     100) and ``deep_cub`` (trunks of 4 stages at 512 at both image
     experts' bottlenecks; 20 steps of 64 over a split cut to 1,280) trained
     one epoch at full width, launching what ``mnist`` and ``cub`` launch,
     under ``celeba``'s gates; each step's wall against the shallow
     config's in turns (``deep_rate``: samples/s, the trunks' share); three
     steps on the card against the CPU; ``deep_mnist``'s eval and
     ``generate`` against the CPU; ``deep_cub``'s batch-8 artifact,
     exported by a process of its own while ``deep`` and ``conv_variants``
     run, under ``serving``'s gates (``deep_export``);
   - the conv stack variants (``conv_variants``): CelebA with
     ``space_to_depth=2`` (stage 0 a 2x2 conv over 12 channels on cuDNN:
     K4 and its backward launch no time), CelebA and CUB with
     ``upsample_mode="shuffle"``: eval over 128 examples and ``generate``
     with their launch counts and against the CPU, 3 ``api.train`` steps
     with their counts, three steps on the card against the CPU;
   - the grain backend (``grain``): ``mnist`` for 3 epochs with the train
     split on the host, whole epochs and segments of 30 steps equal to the
     bit, ``stream_hit_rate``, epoch walls against the device backend;
   - the shuffle modes (``shuffle``): ``mnist`` for 5 epochs under
     ``reshuffle_every`` 4 with rolls and with block orders, and with
     4-row groups, each run's steps, history and launches;
   - bf16 models (``bf16``): K4, its backward and its input gradient on
     all-bf16 operands at the path's (64, 64, 64, 3) (K4 also at a served
     batch of 8) against their plain versions (bf16 outputs; K4 atol 2e-2,
     the backward kernels rtol 2^-7 beside their f32 atols: each side sums
     in f32 and rounds once, so one bf16 step apart at most), two launches
     to the bit, and timed; ``api.train(dtype=bf16)`` of ``celeba`` (20
     steps of 64 at T = 24, the test ELBO over 2,000 examples, then
     ``log_likelihood`` at k = 64 over 4 batches), ``cub`` (20 steps, K4's
     dx on the cycle) and ``mnist`` (100 steps of 100), each launching
     what its f32 path launches; the graph runner against the eager loop
     over 5 bf16 steps of ``celeba`` and ``cub`` to the bit; each step's
     wall at bf16 and at f32 in turns (``bf16_rate``) and its device time
     by kernel family; the card against the CPU at bf16 (encode and decode
     within 2^-5 of the CPU's bf16 outputs' largest and, together, nearer
     them than the CPU's f32 outputs; a loss at rel 2e-3; each gradient
     within 2^-4 of the f32 control's largest, widened by the CPU's own
     bf16-to-f32 distance); ``celeba``'s batch-8 artifact with bf16
     experts, exported by a process of its own meanwhile: its ops, one
     call's launches, against ``api.generate(dtype=bf16)`` (rel 1e-6) and
     against itself on the CPU under the same gates;
   - ``dp`` (data parallelism): 20 ``celeba`` steps of 64 under the "b"
     fold on the graph runner, launching K2's VJP at its map over
     examples of 18 attribute rows (``bce_rows_grad_inner``) 20 times
     with the other counts of ``EXPECTED_LAUNCHES["celeba_b_train"]``,
     timed against the "t" fold in turns with the ``(T, B, L) -> (B, T,
     L)`` copy of its posteriors alone, and three steps of the card
     against the CPU under the "b" fold (the "t" gate's noise in the fold's
     layout, the tails fed); a one-rank NCCL group, 5 ``mnist`` and
     ``celeba`` steps under "st" with the all-reduce in each: the graph
     runner (the collective captured) equal to the eager loop to the bit,
     and the eager loop given the noise ``(B, T, L)`` equal to the
     single-process "t" loop given it as ``(T, B, L)`` to the bit, on
     deterministic algorithms, then each step's wall on the mesh against
     the single-process one in turns; two processes on the one card over
     gloo's CUDA all-reduce (NCCL refuses two ranks on a device), started
     with torchrun's variables: 3 ``mnist`` and ``celeba`` steps (the
     loss against world 1 at rel 1e-4, the parameters within rtol 2e-3 and
     atol 1e-5), ``eval_elbo`` and ``log_likelihood`` with the mesh on a
     333-example split (rel 1e-5), and one ``mnist`` epoch through
     ``python -m mmvae_torch.cli train --multihost`` (its history against
     world 1's at rel 1e-4; rank 1 writes nothing); with two cards or
     more the same world-2 runs on NCCL across cards;
   - ``tp_fsdp`` (FSDP and tensor parallelism): ``celeba``'s 3
     steps of 64 at T = 24 under the "b" fold at world 1 (eager, native
     convolutions, the gradients recorded), then two processes on the one
     card over gloo: ``celeba`` under TP (one model group of 2: each
     rank's stage 0 is K4 at 16 channels, its backward too, the attribute
     banks 9 of 18 a rank) and under FSDP (ZeRO-3: the parameters
     gathered each step, the gradients reduce-scattered), each against
     world 1 under the world-2 gates with the tails fed, each rank's
     persistent state bytes against world 1's less the blocks it does not
     hold, and ``cub`` under TP (K4, its backward and its input gradient at
     16 channels); four processes for ``cub`` under TP at tp = 4 (all three
     at 8 channels); each path's launches against ``EXPECTED_LAUNCHES``;
     with two cards or more the world-2 runs again on NCCL across cards,
     in the graph;
4. timings: each kernel and its plain version on the device (CUDA-graph
   replay, median of 15) and eagerly (host overhead included), the
   library call that computes the same function where there is one, the
   kernel and the library call again L2-cold where the inputs fit in the
   50 MB L2 (the graph cycles through 6 to 512 copies of the inputs,
   twice the L2 where that fits); beside the fused PoE + KL, the chain of
   launches it replaced (the mask product, ``core.product_of_experts``,
   then K1); the floor of an empty launch at K1's, K4's and the fused
   kernel's grids and at one warp, graph-replayed and eager; and for each
   config the eval wall of its test split through a graph runner built
   once and through the eager loop, in turns, ``eval_elbo``'s own wall
   (a capture each call) and a profile of where the graph runner's device
   time goes (its device busy time with and without the host-to-device
   copies; each runner's idle share from its walls against that busy
   time), the same for ``mnist`` under each mixture objective and
   ``celeba`` under mopoe, and the same for each config's ``log_likelihood`` through an
   IWAE graph runner built once and the eager loop (``iwae_wall``,
   ``iwae_profile``). The
   backward kernels are timed at MNIST's, MultiMNIST's and CelebA's train
   shapes beside their plain versions and the autograd backward of the
   library forward (for K4's backward: cuDNN's wgrad and the silu's
   backward, for the weight and bias alone; for K4's input gradient:
   cuDNN's dgrad and the silu's backward, for the image alone), K4's input
   gradient also at an odd size, C = 1 and 4 and a transposed upstream
   gradient; K4, its backward and its dx at 16 and 8 output channels at
   the batch of 64 (a rank's stage 0 at tp = 2 and 4).

It prints one JSON line per result, the ``nvidia-smi`` line, the kernel
summary (K4, its backward and its dx four times: at f32, at all-bf16 with
the bf16 paths' launches, and at 16 and 8 channels with the
tensor-parallel paths' launches), and as the last line ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gzip
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from mmvae_torch import api, configs, ops
from mmvae_torch.core import component_masks, elbo_subset_masks
from mmvae_torch.data import Dataset, load_dataset
from mmvae_torch.models.text import STOP
from mmvae_torch.ops import kernels
from mmvae_torch.parallel import (
    fsdp_shard,
    make_mesh,
    make_mesh_2d,
    multihost,
    shard_batch,
    state_bytes,
    tp_shard,
)
from mmvae_torch.train import (
    create_train_state,
    make_epoch_runner,
    make_eval_runner,
    make_gather_epoch_runner,
    make_iwae_runner,
    make_train_step,
    multi_term_loss,
)
from mmvae_torch.train.checkpoint import AsyncCheckpointWriter
from mmvae_torch.train.state import learning_rate

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 rate, L2 size, the f32 rate outside the
# tensor cores and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# The dense TF32 tensor-core rate (K4's backward runs its products there).
PEAK_TF32_OPS_PER_S = 495e12
# Per element: KL 4 flops + exp; BCE 5 flops + exp + log1p; seq CE a
# compare, a subtract, an add and an exp per logit. Per conv output: 2
# flops for each of the 16 * C products, a bias add and the swish's exp,
# add, divide and multiply. The fused PoE + KL: per expert element a clamp,
# an exp, an add and a divide; per (term, expert element) the weight
# product and its sum, the mean product and its sum; per output the prior
# add, a divide, a log, a negation and K1's 5.
# K4's backward and its input gradient, per (output pixel, channel): the
# recompute's 16 * C multiply-adds and the second product's 16 * C (dW's
# accumulation, or dx's T = S W), each taken as three TF32 products on the
# tensor cores (3xTF32), and about 9 on the CUDA cores for
# the bias add, swish' (an exp, an add, a divide, a subtract, 2 products, an
# add) and the product with g.
# The gradients: KL's 1 + 4 (a product; a product, an exp, a subtract and
# a product); BCE's an exp, an add, a divide, a subtract and a product; the
# sequence cross-entropy's per logit of a non-pad token the forward's 4
# (max, subtract, exp, add) and a subtract, an exp, a divide, the one-hot's
# subtract and the product with g.
# The PoE's backward: per expert element the precision's 4 and its
# derivative's 3; per (term, expert element) the weight product, the mean
# and precision shares (3 products, a subtract, a subtract, 2 adds); per
# output the total's prior add, K1's VJP (a product, an add; an exp, a
# subtract, 2 products, an add) and 2 divides.
OPS_PER_ELEM = {"kl": 5, "bce": 7, "seq_ce": 4, "kl_bwd": 5, "bce_bwd": 5, "bce_bwd_inner": 5,
                "seq_ce_bwd": 9}
CONV_OPS_PER_OUT = 5
CONV_BWD_OPS_PER_OUT = 9
POE_OPS = {"expert": 4, "term_expert": 4, "out": 9}
POE_BWD_OPS = {"expert": 7, "term_expert": 9, "out": 11}
OPS = ("kl", "bce", "seq_ce", "conv", "poe_kl", "kl_bwd", "bce_bwd", "bce_bwd_inner",
       "seq_ce_bwd", "poe_kl_bwd", "conv_bwd", "conv_dx")
BWD_OPS = ("kl_bwd", "bce_bwd", "bce_bwd_inner", "seq_ce_bwd", "poe_kl_bwd", "conv_bwd",
           "conv_dx")
CONFIGS = ("mnist", "fashionmnist", "multimnist", "celeba", "cub")
MIXTURE_OBJECTIVES = ("mmvae", "mopoe", "mvtcae")
# The evals of the mixture paths that are timed beside the configs' own.
MIXTURE_EVALS = (*(configs.get_config("mnist").replace(objective=o) for o in MIXTURE_OBJECTIVES),
                 configs.get_config("celeba").replace(objective="mopoe", n_random_subsets=0))
# The IWAE's importance samples per example (``api.log_likelihood``'s default).
IWAE_K = 64
META = {
    "kl": {
        "name": "kl_std_normal",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/row_reduce.cu",
        "replaces": "mmvae_tpu/ops/kernels.py:139",
        "note": "on the ported paths its function runs as poe_kl's epilogue",
    },
    "bce": {
        "name": "bernoulli_nll",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/row_reduce.cu",
        "replaces": "mmvae_tpu/ops/kernels.py:168",
    },
    "seq_ce": {
        "name": "masked_seq_ce",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/seq_ce.cu",
        "replaces": "mmvae_tpu/ops/kernels.py:230",
    },
    "conv": {
        "name": "conv4x4s2_swish",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/conv_s2.cu",
        "replaces": "tools/pallas_conv_probe.py:64",
    },
    "poe_kl": {
        "name": "poe_kl",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/poe_kl.cu",
        "replaces": "mmvae_tpu/ops/kernels.py:139",
    },
    "kl_bwd": {
        "name": "kl_rows_grad",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/row_reduce.cu",
        "replaces": "mmvae_tpu/ops/kernels.py:155",
        "note": "K1's VJP; on the train path it runs inside poe_kl_bwd",
    },
    "bce_bwd": {
        "name": "bce_rows_grad",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/row_reduce.cu",
        "replaces": "mmvae_tpu/ops/kernels.py:312",
    },
    "bce_bwd_inner": {
        "name": "bce_rows_grad_inner",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/row_reduce.cu",
        "replaces": "mmvae_tpu/ops/kernels.py:312",
        "note": "K2's VJP at its b-major map over examples of several rows (CelebA's 18 "
                "attribute rows under the \"b\" fold)",
    },
    "seq_ce_bwd": {
        "name": "seq_ce_rows_grad",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/seq_ce.cu",
        "replaces": "mmvae_tpu/ops/kernels.py:295",
        "note": "K3's VJP",
    },
    "poe_kl_bwd": {
        "name": "poe_kl_bwd",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/poe_kl.cu",
        "replaces": "mmvae_tpu/ops/kernels.py:155",
        "note": "K1's VJP carried back through the PoE to the expert stack",
    },
    "conv_bwd": {
        "name": "conv4x4s2_swish_bwd",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/conv_s2.cu",
        "replaces": "mmvae_tpu/models/experts.py:220",
        "note": "K4's backward in its weight and bias; the TPU side has no Pallas VJP for "
                "K4 and leaves stage 0's gradient to XLA (tools/pallas_conv_probe.py:55 "
                "xla_conv0)",
    },
    "conv_dx": {
        "name": "conv4x4s2_swish_dx",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/conv_s2.cu",
        "replaces": "tools/pallas_conv_probe.py:55",
        "note": "K4's backward in its image (dx), the input half of XLA's gradient of "
                "stage 0 (xla_conv0); the cycle term's re-encode of a render takes it",
    },
}
# K4, its backward and its input gradient at a rank's F = 32 / tp output
# channels of stage 0 under tensor parallelism: conv_s2.cu compiled with
# CONV_F = 16 and 8 (libraries conv_s2_f16 and conv_s2_f8).
for _f, _tp in ((16, 2), (8, 4)):
    for _op in ("conv", "conv_bwd", "conv_dx"):
        META[f"{_op}_f{_f}"] = {
            **{k: v for k, v in META[_op].items() if k != "note"},
            "out_channels": _f,
            "note": f"at F = {_f}: a rank's block of stage 0's 32 channels under tensor "
                    f"parallelism at tp = {_tp} (column-parallel, parallel/tp.py)"}
# Shapes of each kernel: (N, D, n_x, fold) of the row reductions, (N, S, V)
# of the sequence cross-entropy, (B, H, W, C, dtype) of the conv, (T, B, M,
# L, case) of the fused PoE + KL (cases as ``inputs`` makes them). One
# MNIST or MultiMNIST eval batch of 100 gives KL T=3 terms of posteriors,
# image BCE 2 member terms against one untiled copy of the targets, and
# text CE 2 member terms of 5 tokens over 13 symbols. One CelebA eval
# batch of 64 gives KL T=20 terms, image BCE 2 member terms of 64x64x3
# pixels, attribute BCE 19 member terms x 18 attributes as rows of D = 1
# against 64 x 18 untiled targets, and the conv over the 64 images. The
# synthetic CUB vocabulary (3 reserved + 20 words) at 32 tokens and a
# large odd vocabulary stand for the caption configs. The fused PoE + KL
# takes the (B, M, L) expert stack of each eval batch under its (T, M)
# subset masks: T = 3 terms of 2 experts for MNIST and MultiMNIST, 20
# terms of 19 experts for CelebA. One CelebA train step (4 random subset
# terms, T = 24) gives the fused PoE + KL at 24 terms of 19 experts, image
# BCE at the image's 6 member terms (1 + 1 + 4) against the 64 untiled
# targets, attribute BCE at 23 member terms (1 + 18 + 4) x 64 x 18 rows of D
# = 1 against 64 x 18 targets, K4 on the 64 images, and each one's backward.
# One CUB train step (cross-recon, T = 3, the cycle term on the soft render)
# gives the fused PoE + KL at its 3 terms of 2 experts (no presence) and at
# the cycle's re-encode (T = 1, the image alone), image BCE at the decode-all
# pass's 3 terms (192 rows of 64x64x3) against the 64 untiled targets, K3 at
# its 3 terms of 64 captions (32 tokens, V = 23) and at the cycle's re-read
# of 64, K4 twice (the encode, the re-encode), each one's backward, and K4's
# input gradient once (the re-encode's input is the render).
TIMED_SHAPES = {
    "kl": {"mnist_eval": (300, 64, 300, None), "multimnist_eval": (300, 256, 300, None),
           "celeba_eval": (1280, 100, 1280, None), "large": (12288, 64, 12288, None)},
    # The IWAE folds k = 64 samples of each example b-major: MNIST's and
    # MultiMNIST's 100 images, CelebA's and CUB's 64 (the same rows), and
    # CelebA's 18 attributes of 64 examples through the map over examples of
    # 18 rows (the fifth field).
    "bce": {"mnist_eval": (200, 784, 100, kernels.FOLD_T),
            "mnist_iwae": (6400, 784, 100, kernels.FOLD_B),
            "multimnist_iwae": (6400, 2500, 100, kernels.FOLD_B),
            "celeba_iwae_image": (4096, 12288, 64, kernels.FOLD_B),
            "celeba_iwae_attrs": (73728, 1, 1152, kernels.FOLD_B, 18),
            "multimnist_eval": (200, 2500, 100, kernels.FOLD_T),
            "multimnist_train": (300, 2500, 100, kernels.FOLD_T),
            "celeba_image": (128, 12288, 64, kernels.FOLD_T),
            "celeba_attrs": (21888, 1, 1152, kernels.FOLD_T),
            "celeba_train_image": (384, 12288, 64, kernels.FOLD_T),
            "celeba_train_attrs": (26496, 1, 1152, kernels.FOLD_T),
            "cub_train": (192, 12288, 64, kernels.FOLD_T),
            # The mixture objectives' decode-all passes: MNIST mopoe's 3
            # terms of images, CelebA mopoe's 20 of images and attributes.
            "mnist_mopoe": (300, 784, 100, kernels.FOLD_T),
            "celeba_mopoe_image": (1280, 12288, 64, kernels.FOLD_T),
            "celeba_mopoe_attrs": (23040, 1, 1152, kernels.FOLD_T),
            "large": (8192, 784, 4096, kernels.FOLD_T),
            # data_dtype="bfloat16": the train steps' targets in bf16 (the
            # dtype last), MNIST's and CelebA's.
            "mnist_train_bf16": (200, 784, 100, kernels.FOLD_T, torch.bfloat16),
            "celeba_train_image_bf16": (384, 12288, 64, kernels.FOLD_T, torch.bfloat16),
            "celeba_train_attrs_bf16": (26496, 1, 1152, kernels.FOLD_T, torch.bfloat16)},
    # A fourth field: the tokens of that many examples tiled b-major to the
    # rows (the IWAE's); CUB's eval: its 2 member terms of 64 captions.
    "seq_ce": {"multimnist_eval": (200, 5, 13), "multimnist_train": (300, 5, 13),
               "multimnist_iwae": (6400, 5, 13, 100), "cub_eval": (128, 32, 23),
               "cub_iwae": (4096, 32, 23, 64), "cub_train": (192, 32, 23),
               "cub_cycle": (64, 32, 23),
               "cub_synthetic": (4096, 32, 23), "large": (2048, 8, 5003),
               # A mounted CUB corpus's V = 2,004: a train step's decode-all
               # pass, the cycle's re-read, an eval batch's member terms.
               "cub_corpus_train": (192, 32, 2004), "cub_corpus_cycle": (64, 32, 2004),
               "cub_corpus_eval": (128, 32, 2004)},
    "conv": {"celeba_eval": (64, 64, 64, 3, torch.float32),
             # A bf16 train batch into the f32 encoder ("bf16_x").
             "celeba_train_bf16_x": (64, 64, 64, 3, "bf16_x"),
             "probe": (256, 64, 64, 3, torch.bfloat16),
             # A served batch of 8 (CelebA's and CUB's artifacts).
             "serve": (8, 64, 64, 3, torch.float32),
             # A bf16 model's stage 0 (all operands bf16): the CelebA and
             # CUB train batch, and a served batch of 8.
             "celeba_train_bf16": (64, 64, 64, 3, torch.bfloat16),
             "serve_bf16": (8, 64, 64, 3, torch.bfloat16)},
    "poe_kl": {"mnist_eval": (3, 100, 2, 64, "eval"),
               "multimnist_eval": (3, 100, 2, 256, "eval"),
               "multimnist_train": (3, 100, 2, 256, "text"),
               "celeba_eval": (20, 64, 19, 100, "eval"),
               "celeba_train": (24, 64, 19, 100, "subsets"),
               "cub_eval": (3, 64, 2, 256, "eval"),
               "cub_train": (3, 64, 2, 256, "none"), "cub_cycle": (1, 64, 2, 256, "cycle"),
               # MNIST under mmvae (the identity, T = 2) and mopoe (the powerset, T = 3).
               "mnist_mmvae": (2, 100, 2, 64, "mmvae"), "mnist_mopoe": (3, 100, 2, 64, "mopoe"),
               # The IWAE's joint posterior: one all-ones mask, no presence.
               "mnist_iwae": (1, 100, 2, 64, "joint"),
               "multimnist_iwae": (1, 100, 2, 256, "joint"),
               "celeba_iwae": (1, 64, 19, 100, "joint"),
               "cub_iwae": (1, 64, 2, 256, "joint"),
               # A served batch of 8: the PoE of the observed experts, one
               # all-ones mask under the presence.
               "serve_mnist": (1, 8, 2, 64, "serve"), "serve_multimnist": (1, 8, 2, 256, "serve"),
               "serve_celeba": (1, 8, 19, 100, "serve")},
    # One MNIST train step: K1's VJP at the (T * B, L) posteriors (no path
    # runs it alone), K2's at the image's 2 member terms against 100
    # untiled targets, the fused PoE + KL's at the batch's expert stack.
    # One MultiMNIST train step: K2's at the decode-all pass's 3 terms of
    # images, K3's at its 3 terms of text and at one cycle re-read, the
    # fused PoE + KL's at the loss's 3 terms and at a re-read's one.
    "kl_bwd": {"mnist_train": (300, 64, 300, None), "celeba_eval": (1280, 100, 1280, None)},
    "bce_bwd": {"mnist_train": (200, 784, 100, kernels.FOLD_T),
                "multimnist_train": (300, 2500, 100, kernels.FOLD_T),
                "celeba_image": (128, 12288, 64, kernels.FOLD_T),
                "celeba_train_image": (384, 12288, 64, kernels.FOLD_T),
                "celeba_train_attrs": (26496, 1, 1152, kernels.FOLD_T),
                "cub_train": (192, 12288, 64, kernels.FOLD_T),
                "mnist_mopoe": (300, 784, 100, kernels.FOLD_T),
                "celeba_mopoe_image": (1280, 12288, 64, kernels.FOLD_T),
                "celeba_mopoe_attrs": (23040, 1, 1152, kernels.FOLD_T),
                "mnist_train_bf16": (200, 784, 100, kernels.FOLD_T, torch.bfloat16),
                "celeba_train_image_bf16": (384, 12288, 64, kernels.FOLD_T, torch.bfloat16),
                "celeba_train_attrs_bf16": (26496, 1, 1152, kernels.FOLD_T, torch.bfloat16)},
    # K2's VJP at the map over examples of 18 attribute rows: CelebA's
    # train step under the "b" fold (64 examples, the attributes' 23 member
    # terms), one rank's 32 examples at world 2, CelebA mopoe's 20 terms,
    # and the train step on bf16 targets.
    "bce_bwd_inner": {"celeba_b_train_attrs": (26496, 1, 1152, kernels.FOLD_B, 18),
                      "celeba_b_world2_attrs": (13248, 1, 576, kernels.FOLD_B, 18),
                      "celeba_b_mopoe_attrs": (23040, 1, 1152, kernels.FOLD_B, 18),
                      "celeba_b_train_attrs_bf16": (26496, 1, 1152, kernels.FOLD_B, 18,
                                                    torch.bfloat16)},
    "seq_ce_bwd": {"multimnist_train": (300, 5, 13), "multimnist_cycle": (100, 5, 13),
                   "cub_train": (192, 32, 23), "cub_cycle": (64, 32, 23),
                   "cub_synthetic": (4096, 32, 23), "large": (2048, 8, 5003),
                   "cub_corpus_train": (192, 32, 2004), "cub_corpus_cycle": (64, 32, 2004),
                   "cub_corpus_eval": (128, 32, 2004)},
    "poe_kl_bwd": {"mnist_train": (3, 100, 2, 64, "eval"),
                   "multimnist_train": (3, 100, 2, 256, "text"),
                   "multimnist_cycle": (1, 100, 2, 256, "cycle"),
                   "celeba_eval": (20, 64, 19, 100, "eval"),
                   "celeba_train": (24, 64, 19, 100, "subsets"),
                   "cub_train": (3, 64, 2, 256, "none"), "cub_cycle": (1, 64, 2, 256, "cycle"),
                   "mnist_mmvae": (2, 100, 2, 64, "mmvae"),
                   "mnist_mopoe": (3, 100, 2, 64, "mopoe")},
    "conv_bwd": {"celeba_train": (64, 64, 64, 3),
                 "celeba_train_bf16": (64, 64, 64, 3, torch.bfloat16),
                 "celeba_train_all_bf16": (64, 64, 64, 3, "all_bf16")},
    # K4's input gradient: CUB's train batch (the cycle term's re-encode of
    # its 64 renders), an odd size, C = 1 and 4, and CUB's batch with a
    # transposed upstream gradient (the fifth field).
    "conv_dx": {"cub_train": (64, 64, 64, 3), "odd": (3, 33, 31, 3), "c1": (64, 64, 64, 1),
                "c4": (64, 64, 64, 4), "transposed_g": (64, 64, 64, 3, "transposed"),
                "cub_train_all_bf16": (64, 64, 64, 3, "all_bf16")},
}
CHECKED_SHAPES = {
    "kl": [(300, 64, 300, None), (300, 256, 300, None), (1280, 100, 1280, None),
           (37, 100, 37, None), (12288, 64, 12288, None)],
    "bce": [
        (200, 784, 200, kernels.FOLD_NONE),
        (200, 784, 100, kernels.FOLD_T),
        (200, 784, 100, kernels.FOLD_B),
        (200, 2500, 100, kernels.FOLD_T),
        (300, 2500, 100, kernels.FOLD_T),
        (128, 12288, 64, kernels.FOLD_T),
        (21888, 1, 1152, kernels.FOLD_T),
        (37, 1000, 37, kernels.FOLD_NONE),
        (8192, 784, 4096, kernels.FOLD_T),
        (384, 12288, 64, kernels.FOLD_T),
        (26496, 1, 1152, kernels.FOLD_T),
        # CelebA's image rows in the other folds; fewer rows than SMs at
        # an odd D (scalar loads, a cluster a row); D not a multiple of 4.
        (128, 12288, 128, kernels.FOLD_NONE),
        (128, 12288, 64, kernels.FOLD_B),
        (16, 50001, 16, kernels.FOLD_NONE),
        (128, 12290, 128, kernels.FOLD_NONE),
        # The IWAE's b-major image rows; CelebA's attributes through the
        # map over examples of 18 rows; ragged examples (5 of 3 rows, k =
        # 7), examples wider than a block (300 rows), rows of D = 7.
        (6400, 784, 100, kernels.FOLD_B),
        (6400, 2500, 100, kernels.FOLD_B),
        (4096, 12288, 64, kernels.FOLD_B),
        (73728, 1, 1152, kernels.FOLD_B, 18),
        (105, 1, 15, kernels.FOLD_B, 3),
        (1800, 1, 900, kernels.FOLD_B, 300),
        (60, 7, 20, kernels.FOLD_B, 5),
        # CUB's train step: the decode-all pass's image rows.
        (192, 12288, 64, kernels.FOLD_T),
        # The mixture objectives' decode-all passes: MNIST mopoe's 3 terms
        # (mmvae's 2 are the mvae eval's rows), CelebA mopoe's 20 terms of
        # images and of attributes.
        (300, 784, 100, kernels.FOLD_T),
        (1280, 12288, 64, kernels.FOLD_T),
        (23040, 1, 1152, kernels.FOLD_T),
        # bf16 targets (data_dtype="bfloat16"): MNIST's and CelebA's train
        # rows and CUB's, a b-major fold, D not a multiple of 4, the map over
        # examples of 18 rows, rows split over clusters at an odd D.
        *((*shape, torch.bfloat16) for shape in (
            (200, 784, 100, kernels.FOLD_T), (384, 12288, 64, kernels.FOLD_T),
            (26496, 1, 1152, kernels.FOLD_T), (192, 12288, 64, kernels.FOLD_T),
            (128, 12288, 64, kernels.FOLD_B), (37, 1002, 37, kernels.FOLD_NONE),
            (73728, 1, 1152, kernels.FOLD_B, 18), (16, 50001, 16, kernels.FOLD_NONE))),
    ],
    # MultiMNIST eval and train (the decode-all pass, a cycle re-read);
    # ragged with all-pad rows; the synthetic CUB vocabulary (3 reserved +
    # 20 words); a large odd vocabulary; S above the tokens a block runs at
    # once, at an odd V; V just below a warp.
    "seq_ce": [(200, 5, 13), (300, 5, 13), (100, 5, 13), (37, 7, 13), (4096, 32, 23),
               (2048, 8, 5003), (3, 40, 1001), (5, 3, 31), (6400, 5, 13, 100),
               (4096, 32, 23, 64), (128, 32, 23), (192, 32, 23), (64, 32, 23),
               # A mounted CUB corpus's V = 2,004.
               (192, 32, 2004), (64, 32, 2004), (128, 32, 2004)],
    # CelebA eval; the probe's shape and type (more units than the grid
    # has warps); a ragged batch; an odd grayscale size, which pads (1, 2)
    # and takes scalar loads; widths that are not a multiple of the 32
    # pixels a warp covers (scalar stores at 35 and 45 outputs); C = 1, 2
    # and 4 in both types; rows wider than a tile (550 outputs).
    "conv": [(64, 64, 64, 3, torch.float32), (256, 64, 64, 3, torch.bfloat16),
             (37, 64, 64, 3, torch.float32), (5, 25, 25, 1, torch.float32),
             (600, 64, 64, 3, torch.float32), (4, 30, 70, 3, torch.float32),
             (3, 20, 90, 3, torch.bfloat16),
             *((6, 32, 40, c, dt) for c in (1, 2, 4) for dt in (torch.float32, torch.bfloat16)),
             (2, 7, 1100, 4, torch.float32), (8, 64, 64, 3, torch.float32),
             # A bf16 image into f32 weights and outputs ("bf16_x").
             (64, 64, 64, 3, "bf16_x"), (5, 25, 25, 1, "bf16_x"), (4, 30, 70, 3, "bf16_x"),
             # A bf16 model's stage 0: the train batch, a served batch of 8.
             (64, 64, 64, 3, torch.bfloat16), (8, 64, 64, 3, torch.bfloat16)],
    # The three eval batches; CelebA's padded last batch (16 rows present,
    # 48 absent); no presence mask; log-variances past the +-11 clamp; an
    # odd L; experts one element into their storage; a CelebA train step's 24
    # terms, one random subset row all zero.
    "poe_kl": [(3, 100, 2, 64, "eval"), (3, 100, 2, 256, "eval"), (20, 64, 19, 100, "eval"),
               (20, 64, 19, 100, "ragged"), (3, 100, 2, 64, "none"),
               (20, 64, 19, 100, "wide"), (20, 10, 19, 37, "eval"),
               (20, 64, 19, 100, "unaligned"), (3, 100, 2, 256, "text"),
               (1, 100, 2, 256, "cycle"), (24, 64, 19, 100, "subsets"),
               (3, 64, 2, 256, "eval"), (1, 100, 2, 64, "joint"), (1, 100, 2, 256, "joint"),
               (1, 64, 19, 100, "joint"), (1, 64, 2, 256, "joint"),
               (3, 64, 2, 256, "none"), (1, 64, 2, 256, "cycle"),
               (2, 100, 2, 64, "mmvae"), (3, 100, 2, 64, "mopoe"),
               (1, 8, 2, 64, "serve"), (1, 8, 19, 100, "serve"), (1, 8, 2, 256, "serve")],
    "kl_bwd": [(300, 64, 300, None), (1280, 100, 1280, None), (37, 100, 37, None),
               (5, 3, 5, None)],
    # The MNIST and MultiMNIST train rows in every fold, CelebA's image and
    # attribute rows (eval and train), D not a multiple of 4 (b-major), and
    # more target rows than a grid axis holds (65,535).
    "bce_bwd": [
        (200, 784, 100, kernels.FOLD_T),
        (384, 12288, 64, kernels.FOLD_T),
        (26496, 1, 1152, kernels.FOLD_T),
        (300, 2500, 100, kernels.FOLD_T),
        (200, 784, 200, kernels.FOLD_NONE),
        (200, 784, 100, kernels.FOLD_B),
        (128, 12288, 64, kernels.FOLD_T),
        (21888, 1, 1152, kernels.FOLD_T),
        (36, 1002, 18, kernels.FOLD_B),
        (70000, 3, 70000, kernels.FOLD_NONE),
        (192, 12288, 64, kernels.FOLD_T),
        (300, 784, 100, kernels.FOLD_T),
        (1280, 12288, 64, kernels.FOLD_T),
        (23040, 1, 1152, kernels.FOLD_T),
        # bf16 targets: MNIST's and CelebA's train rows, an odd D b-major.
        *((*shape, torch.bfloat16) for shape in (
            (200, 784, 100, kernels.FOLD_T), (384, 12288, 64, kernels.FOLD_T),
            (26496, 1, 1152, kernels.FOLD_T), (36, 1002, 18, kernels.FOLD_B),
            (192, 12288, 64, kernels.FOLD_T))),
    ],
    # K2's VJP at the map over examples of several rows: the timed shapes,
    # a ragged example of 5 rows (k = 7), rows of D = 7 (off the float4
    # width), examples wider than a block (300 rows), one example of two
    # rows, and bf16 targets at CelebA's shape, ragged and at D = 7.
    "bce_bwd_inner": [
        (26496, 1, 1152, kernels.FOLD_B, 18), (13248, 1, 576, kernels.FOLD_B, 18),
        (23040, 1, 1152, kernels.FOLD_B, 18), (175, 1, 25, kernels.FOLD_B, 5),
        (60, 7, 20, kernels.FOLD_B, 5), (1800, 1, 900, kernels.FOLD_B, 300),
        (2, 1, 2, kernels.FOLD_B, 2),
        *((*shape, torch.bfloat16) for shape in (
            (26496, 1, 1152, kernels.FOLD_B, 18), (175, 1, 25, kernels.FOLD_B, 5),
            (60, 7, 20, kernels.FOLD_B, 5)))],
    # MultiMNIST's train shapes (the decode-all pass, a cycle re-read)
    # with pad runs; the synthetic CUB vocabulary; a large odd vocabulary;
    # S above the tokens a block runs at once; V just below a warp; a last
    # chunk with fewer examples than the others (7 a chunk); V at the
    # staged path's limit of 128 and just past it (a warp a token row).
    "seq_ce_bwd": [(300, 5, 13), (100, 5, 13), (4096, 32, 23), (2048, 8, 5003),
                   (3, 40, 1001), (5, 3, 31), (1000, 7, 13), (512, 9, 128), (512, 9, 129),
                   (192, 32, 23), (64, 32, 23), (192, 32, 2004), (64, 32, 2004),
                   (128, 32, 2004)],
    # The fused PoE + KL's cases, log-variances at exactly +-11, and
    # MultiMNIST's train step: the text expert at exactly +11 on its last
    # 128 dims (``text``), and a cycle re-read (``cycle``: T = 1, the image
    # expert alone, the log-variance and KL gradients zero). CelebA's L =
    # 100 and L = 100 at 100 rows end in a narrower latent tile (28, 28,
    # 28, 16; 32, 32, 32, 4); L = 37 is ragged in scalar tiles of 2.
    "poe_kl_bwd": [(3, 100, 2, 64, "eval"), (3, 100, 2, 256, "eval"),
                   (20, 64, 19, 100, "eval"), (20, 64, 19, 100, "ragged"),
                   (3, 100, 2, 64, "none"), (20, 64, 19, 100, "wide"),
                   (20, 64, 19, 100, "ties"), (20, 10, 19, 37, "unaligned"),
                   (3, 100, 2, 256, "text"), (1, 100, 2, 256, "cycle"),
                   (3, 100, 2, 100, "eval"), (24, 64, 19, 100, "subsets"),
                   (3, 64, 2, 256, "none"), (1, 64, 2, 256, "cycle"),
                   (2, 100, 2, 64, "mmvae"), (3, 100, 2, 64, "mopoe")],
    # K4's backward (f32): the CelebA train batch; the forward's ragged and
    # odd cases: 37 images, a 25 x 25 grayscale image that pads (1, 2),
    # widths off the 32-pixel tile (35 and 33 outputs), C = 1, 2 and 4, rows
    # wider than a tile (550 outputs).
    "conv_bwd": [(64, 64, 64, 3), (37, 64, 64, 3), (5, 25, 25, 1), (4, 30, 70, 3),
                 (2, 10, 66, 3), (6, 32, 40, 1), (6, 32, 40, 2), (6, 32, 40, 4),
                 (2, 7, 1100, 4),
                 # A bf16 image (data_dtype="bfloat16"): the CelebA train
                 # batch, ragged, odd and off-tile (scalar staging).
                 (64, 64, 64, 3, torch.bfloat16), (37, 64, 64, 3, torch.bfloat16),
                 (5, 25, 25, 1, torch.bfloat16), (4, 30, 70, 3, torch.bfloat16),
                 # All operands bf16 (a bf16 model's stage 0): the train
                 # batch, odd H and W.
                 (64, 64, 64, 3, "all_bf16"), (3, 33, 31, 3, "all_bf16")],
    # K4's input gradient (f32): CUB's train batch; odd H and W (tiles that
    # end at the image's last row); a 25 x 25 grayscale image that pads (1,
    # 2); C = 1, 2 and 4; a second tile of 3 columns; rows of 18 tiles; a
    # last tile of one row; one pixel; the upstream gradient transposed.
    "conv_dx": [(64, 64, 64, 3), (3, 33, 31, 3), (5, 25, 25, 1), (64, 64, 64, 1),
                (64, 64, 64, 4), (6, 32, 40, 2), (4, 30, 70, 3), (2, 7, 1100, 4),
                (2, 18, 10, 3), (1, 1, 1, 3), (64, 64, 64, 3, "transposed"),
                (3, 33, 31, 3, "transposed"),
                # All operands bf16: CUB's train batch, odd H and W.
                (64, 64, 64, 3, "all_bf16"), (3, 33, 31, 3, "all_bf16")],
}
# K4, its backward and its input gradient at F = 16 and 8 (a rank's stage 0
# at tp = 2 and 4): timed at the CelebA and CUB batch of 64 (the
# column-parallel stage 0 of both), checked there and at ragged, odd,
# grayscale and bf16 shapes; the marker ("f16", "f8") before a dtype.
for _f in ("f16", "f8"):
    _tp = {"f16": "tp2", "f8": "tp4"}[_f]
    TIMED_SHAPES["conv"][f"stage0_{_tp}"] = (64, 64, 64, 3, torch.float32, _f)
    TIMED_SHAPES["conv_bwd"][f"stage0_{_tp}_train"] = (64, 64, 64, 3, _f)
    TIMED_SHAPES["conv_dx"][f"stage0_{_tp}_dx"] = (64, 64, 64, 3, _f)
    CHECKED_SHAPES["conv"] += [
        (64, 64, 64, 3, torch.float32, _f), (37, 64, 64, 3, torch.float32, _f),
        (3, 33, 31, 3, torch.float32, _f), (5, 25, 25, 1, torch.float32, _f),
        (6, 32, 40, 4, torch.float32, _f), (64, 64, 64, 3, "bf16_x", _f),
        (64, 64, 64, 3, torch.bfloat16, _f), (3, 33, 31, 3, torch.bfloat16, _f)]
    CHECKED_SHAPES["conv_bwd"] += [
        (64, 64, 64, 3, _f), (37, 64, 64, 3, _f), (3, 33, 31, 3, _f), (5, 25, 25, 1, _f),
        (6, 32, 40, 2, _f), (64, 64, 64, 3, _f, torch.bfloat16),
        (64, 64, 64, 3, _f, "all_bf16"), (3, 33, 31, 3, _f, "all_bf16")]
    CHECKED_SHAPES["conv_dx"] += [
        (64, 64, 64, 3, _f), (3, 33, 31, 3, _f), (5, 25, 25, 1, _f), (6, 32, 40, 4, _f),
        (64, 64, 64, 3, _f, "transposed"), (64, 64, 64, 3, _f, "all_bf16")]
# The (path, timed shape) each kernel's entry of the final line reports:
# this slice's paths -- CelebA under mopoe for the kernels it runs (K4 and
# the fused PoE + KL at CelebA's batch, which the eval labels time at the
# same shapes), MultiMNIST with the loss knobs for K3 -- else the path that
# runs the kernel.
_MOPOE = "celeba_mopoe_train"
REPORTED = {"kl": ("celeba", "celeba_eval"), "bce": (_MOPOE, "celeba_mopoe_image"),
            "seq_ce": ("multimnist_knobs_train", "multimnist_train"),
            "conv": (_MOPOE, "celeba_eval"), "poe_kl": (_MOPOE, "celeba_eval"),
            "kl_bwd": ("mnist_train", "mnist_train"),
            "bce_bwd": (_MOPOE, "celeba_mopoe_image"),
            "bce_bwd_inner": ("celeba_b_train", "celeba_b_train_attrs"),
            "seq_ce_bwd": ("multimnist_knobs_train", "multimnist_train"),
            "poe_kl_bwd": (_MOPOE, "celeba_eval"), "conv_bwd": (_MOPOE, "celeba_train"),
            "conv_dx": ("cub_train", "cub_train"),
            # K4's all-bf16 forms, on the bf16 paths (``phase_bf16``).
            "conv_bf16": ("celeba_bf16_train", "celeba_train_bf16"),
            "conv_bwd_bf16": ("celeba_bf16_train", "celeba_train_all_bf16"),
            "conv_dx_bf16": ("cub_bf16_train", "cub_train_all_bf16"),
            # K4 at a rank's 16 and 8 channels, on the tensor-parallel paths
            # (``phase_tp_fsdp``): CelebA's and CUB's at tp = 2, CUB's at 4.
            "conv_f16": ("celeba_tp_train", "stage0_tp2"),
            "conv_bwd_f16": ("celeba_tp_train", "stage0_tp2_train"),
            "conv_dx_f16": ("cub_tp_train", "stage0_tp2_dx"),
            "conv_f8": ("cub_tp4_train", "stage0_tp4"),
            "conv_bwd_f8": ("cub_tp4_train", "stage0_tp4_train"),
            "conv_dx_f8": ("cub_tp4_train", "stage0_tp4_dx")}
# The entries of the kernels line -> the op each times: one an op, and K4's
# forward, backward and input gradient on all-bf16 operands apart.
ENTRIES = {**{op: op for op in OPS}, "conv_bf16": "conv", "conv_bwd_bf16": "conv_bwd",
           "conv_dx_bf16": "conv_dx",
           **{f"{op}_f{f}": op for f in (16, 8) for op in ("conv", "conv_bwd", "conv_dx")}}
_NO_BWD = {"kl_bwd": 0, "bce_bwd": 0, "bce_bwd_inner": 0, "seq_ce_bwd": 0, "poe_kl_bwd": 0,
           "conv_bwd": 0, "conv_dx": 0}
EXPECTED_LAUNCHES = {
    # 20 eval batches, each the fused PoE + KL and K2 once; the fused PoE +
    # KL once per generate or sample call (the mvae fusion).
    "mnist": {"kl": 0, "bce": 20, "seq_ce": 0, "conv": 0, "poe_kl": 22, **_NO_BWD},
    # As MNIST's: 20 eval batches of 100; the grayscale stage 0 on cuDNN.
    "fashionmnist": {"kl": 0, "bce": 20, "seq_ce": 0, "conv": 0, "poe_kl": 23, **_NO_BWD},
    "multimnist": {"kl": 0, "bce": 20, "seq_ce": 20, "conv": 0, "poe_kl": 24, **_NO_BWD},
    # 32 eval batches, each the fused PoE + KL once and K2 twice (image,
    # attributes); K4 once per eval batch; K4 and the fused PoE + KL once
    # per generate or sample call.
    "celeba": {"kl": 0, "bce": 64, "seq_ce": 0, "conv": 37, "poe_kl": 37, **_NO_BWD},
    # 32 eval batches, each the fused PoE + KL, K2 (the image), K3 (the
    # captions) and K4 once; K4 and the fused PoE + KL once per generate or
    # sample call.
    "cub": {"kl": 0, "bce": 32, "seq_ce": 32, "conv": 36, "poe_kl": 36, **_NO_BWD},
    # ``log_likelihood`` over the 2,000-example test splits, k = 64: per
    # batch the fused PoE + KL once (the joint posterior), K2 once per
    # bernoulli decode key (CelebA: the image and the attributes), K3 once
    # per caption or digit string, K4 once in an RGB image encoder. 20
    # batches of 100 (MNIST, MultiMNIST), 32 of 64 (CelebA, CUB).
    "mnist_iwae": {"kl": 0, "bce": 20, "seq_ce": 0, "conv": 0, "poe_kl": 20, **_NO_BWD},
    "fashionmnist_iwae": {"kl": 0, "bce": 20, "seq_ce": 0, "conv": 0, "poe_kl": 20,
                          **_NO_BWD},
    "multimnist_iwae": {"kl": 0, "bce": 20, "seq_ce": 20, "conv": 0, "poe_kl": 20, **_NO_BWD},
    "celeba_iwae": {"kl": 0, "bce": 64, "seq_ce": 0, "conv": 32, "poe_kl": 32, **_NO_BWD},
    "cub_iwae": {"kl": 0, "bce": 32, "seq_ce": 32, "conv": 32, "poe_kl": 32, **_NO_BWD},
    # 100 train steps, each the fused PoE + KL and K2 (the image's 2 member
    # terms) forward and backward once, then the 20 batches of the test
    # ELBO, forward only.
    "mnist_train": {"kl": 0, "bce": 120, "seq_ce": 0, "conv": 0, "poe_kl": 120,
                    "kl_bwd": 0, "bce_bwd": 100, "seq_ce_bwd": 0, "poe_kl_bwd": 100,
                    "conv_bwd": 0, "conv_dx": 0},
    # As MNIST's: 100 steps of batch 100 (the grayscale convs on cuDNN).
    "fashionmnist_train": {"kl": 0, "bce": 120, "seq_ce": 0, "conv": 0, "poe_kl": 120,
                           "kl_bwd": 0, "bce_bwd": 100, "seq_ce_bwd": 0, "poe_kl_bwd": 100,
                           "conv_bwd": 0, "conv_dx": 0},
    # 20 train steps, each the fused PoE + KL 3 times (the loss, the cycle's
    # soft and hard re-reads), K2 once (the decode-all pass's images) and K3
    # 3 times (its text, each re-read), and every one's backward kernel as
    # often; then the 20 batches of the test ELBO, forward only (the fused
    # PoE + KL, K2 and K3 once each).
    "multimnist_train": {"kl": 0, "bce": 40, "seq_ce": 80, "conv": 0, "poe_kl": 80,
                         "kl_bwd": 0, "bce_bwd": 20, "seq_ce_bwd": 60, "poe_kl_bwd": 60,
                         "conv_bwd": 0, "conv_dx": 0},
    # 20 train steps (4 random subsets, T = 24), each the fused PoE + KL
    # once, K2 twice (the image's 6 member terms, the attributes' 23) and K4
    # once (stage 0 of the image encoder), and every one's backward kernel as
    # often; then the 32 batches of the test ELBO, forward only (the fused
    # PoE + KL once, K2 twice, K4 once each).
    # ``train_extras`` (PR 19): ``mnist`` with accum_steps 3 over 3 epochs of
    # 20 micro-steps, each the fused PoE + KL and K2 forward and backward once
    # (an update launches no kernel of the port), then the 20 batches of the
    # test ELBO an epoch, forward only.
    "mnist_accum_train": {"kl": 0, "bce": 120, "seq_ce": 0, "conv": 0, "poe_kl": 120,
                          "kl_bwd": 0, "bce_bwd": 60, "seq_ce_bwd": 0, "poe_kl_bwd": 60,
                          "conv_bwd": 0, "conv_dx": 0},
    # ``celeba`` with accum_steps 2: 20 micro-steps of 64 through the epoch
    # runner (no eval), each the fused PoE + KL once, K2 twice and K4 once,
    # and every one's backward kernel as often.
    "celeba_accum_train": {"kl": 0, "bce": 40, "seq_ce": 0, "conv": 20, "poe_kl": 20,
                           "kl_bwd": 0, "bce_bwd": 40, "seq_ce_bwd": 0, "poe_kl_bwd": 20,
                           "conv_bwd": 20, "conv_dx": 0},
    "celeba_train": {"kl": 0, "bce": 104, "seq_ce": 0, "conv": 52, "poe_kl": 52,
                     "kl_bwd": 0, "bce_bwd": 40, "seq_ce_bwd": 0, "poe_kl_bwd": 20,
                     "conv_bwd": 20, "conv_dx": 0},
    # 20 train steps (cross-recon, T = 3, the cycle term on the soft render),
    # each: the encode (K4 once), the fused PoE + KL at the 3 terms, the
    # decode-all pass (K2 once on the image, K3 once on the captions), then
    # the cycle term's render of the caption's unimodal z, its re-encode (K4
    # again, on the render), the fused PoE + KL at T = 1 and the caption read
    # back (K3 again): the fused PoE + KL 2, K2 1, K3 2, K4 2. Backward: each
    # one's backward kernel as often (K4's dW and db twice, the encoders
    # live on both), and K4's input gradient once, for the re-encode's input
    # (the encode's input is the data). Then the 32 batches of the test
    # ELBO, forward only (the fused PoE + KL, K2, K3 and K4 once each).
    "cub_train": {"kl": 0, "bce": 52, "seq_ce": 72, "conv": 72, "poe_kl": 72,
                  "kl_bwd": 0, "bce_bwd": 20, "seq_ce_bwd": 40, "poe_kl_bwd": 40,
                  "conv_bwd": 40, "conv_dx": 20},
    # MNIST under each mixture objective: 100 train steps, each the fused
    # PoE + KL once (mmvae's 2 components, mopoe's 3, mvtcae's joint and
    # 2 unimodal rows) and K2 once (the decode-all pass's images), forward
    # and backward; then the 20 batches of the test ELBO, forward only.
    **{f"mnist_{o}_train": {"kl": 0, "bce": 120, "seq_ce": 0, "conv": 0, "poe_kl": 120,
                            "kl_bwd": 0, "bce_bwd": 100, "seq_ce_bwd": 0, "poe_kl_bwd": 100,
                            "conv_bwd": 0, "conv_dx": 0} for o in MIXTURE_OBJECTIVES},
    # ``eval_elbo`` (20 batches: the fused PoE + KL and K2 once each) and 4
    # ``generate`` calls, each of which fuses its mixture's components (or,
    # under mvtcae, its PoE) with the fused PoE + KL once.
    "mnist_mmvae": {"kl": 0, "bce": 20, "seq_ce": 0, "conv": 0, "poe_kl": 24, **_NO_BWD},
    "mnist_mopoe": {"kl": 0, "bce": 20, "seq_ce": 0, "conv": 0, "poe_kl": 24, **_NO_BWD},
    "mnist_mvtcae": {"kl": 0, "bce": 20, "seq_ce": 0, "conv": 0, "poe_kl": 24, **_NO_BWD},
    # 20 CelebA mopoe steps (T = 20, every key decoded on all terms), each:
    # K4 once, the fused PoE + KL once, K2 twice (the image on 1,280 rows,
    # the attributes on 23,040), and each one's backward kernel as often;
    # then the 32 batches of the test ELBO, forward only.
    "celeba_mopoe_train": {"kl": 0, "bce": 104, "seq_ce": 0, "conv": 52, "poe_kl": 52,
                           "kl_bwd": 0, "bce_bwd": 40, "seq_ce_bwd": 0, "poe_kl_bwd": 20,
                           "conv_bwd": 20, "conv_dx": 0},
    # ``eval_elbo`` (32 batches) and ``generate`` from the attributes (K4 on
    # the placeholder image, the fused PoE + KL for the mixture).
    "celeba_mopoe": {"kl": 0, "bce": 64, "seq_ce": 0, "conv": 33, "poe_kl": 33, **_NO_BWD},
    # 20 MultiMNIST steps with the three loss knobs: ``multimnist_train``'s
    # step and a second decode-all pass on detached decoders (K2 and K3
    # once more, forward and backward); the alignment and the contrast
    # penalty launch no kernel. Then the 20 batches of the test ELBO.
    "multimnist_knobs_train": {"kl": 0, "bce": 60, "seq_ce": 100, "conv": 0, "poe_kl": 80,
                               "kl_bwd": 0, "bce_bwd": 40, "seq_ce_bwd": 80, "poe_kl_bwd": 60,
                               "conv_bwd": 0, "conv_dx": 0},
    # ``serving``: one call of a loaded batch-8 artifact, the fused
    # PoE + KL once (the fusion, of the PoE or of a mixture's components)
    # and K4 once in an RGB image encoder; the decode launches no kernel of
    # the port (its outputs are postprocessed, not scored).
    **{f"serve_{name}": {"kl": 0, "bce": 0, "seq_ce": 0, "poe_kl": 1,
                         "conv": int(name.split("_")[0] in ("celeba", "cub")), **_NO_BWD}
       for name in ("mnist", "fashionmnist", "multimnist", "celeba", "cub", "mnist_mopoe")},
    # ``deep`` (PR 22): the trunks sit between dense layers, so each deep
    # config launches what its shallow one does (``mnist_train``,
    # ``cub_train``, ``serve_cub``).
    "deep_mnist_train": {"kl": 0, "bce": 120, "seq_ce": 0, "conv": 0, "poe_kl": 120,
                         "kl_bwd": 0, "bce_bwd": 100, "seq_ce_bwd": 0, "poe_kl_bwd": 100,
                         "conv_bwd": 0, "conv_dx": 0},
    "deep_cub_train": {"kl": 0, "bce": 52, "seq_ce": 72, "conv": 72, "poe_kl": 72,
                       "kl_bwd": 0, "bce_bwd": 20, "seq_ce_bwd": 40, "poe_kl_bwd": 40,
                       "conv_bwd": 40, "conv_dx": 20},
    "serve_deep_cub": {"kl": 0, "bce": 0, "seq_ce": 0, "poe_kl": 1, "conv": 1, **_NO_BWD},
    # ``conv_variants`` (PR 22): 2 eval batches of 64 and one ``generate``
    # from images. CelebA's ``space_to_depth=2`` stage 0 is a 2x2 conv over
    # 12 channels on cuDNN, not K4: K4 and its backward launch no time; K2
    # twice an eval batch, the fused PoE + KL once an eval batch and once
    # for the generate. A shuffle decoder (CelebA's, CUB's) leaves K4 in
    # stage 0 (once an eval batch and once for the generate's encode).
    "celeba_s2d": {"kl": 0, "bce": 4, "seq_ce": 0, "conv": 0, "poe_kl": 3, **_NO_BWD},
    "celeba_shuffle": {"kl": 0, "bce": 4, "seq_ce": 0, "conv": 3, "poe_kl": 3, **_NO_BWD},
    "cub_shuffle": {"kl": 0, "bce": 2, "seq_ce": 2, "conv": 3, "poe_kl": 3, **_NO_BWD},
    # 3 train steps, then the 2 test batches: ``celeba_train``'s and
    # ``cub_train``'s counts a step and an eval batch, less K4 and its
    # backward on the space_to_depth encoder.
    "celeba_s2d_train": {"kl": 0, "bce": 10, "seq_ce": 0, "conv": 0, "poe_kl": 5,
                         "kl_bwd": 0, "bce_bwd": 6, "seq_ce_bwd": 0, "poe_kl_bwd": 3,
                         "conv_bwd": 0, "conv_dx": 0},
    "celeba_shuffle_train": {"kl": 0, "bce": 10, "seq_ce": 0, "conv": 5, "poe_kl": 5,
                             "kl_bwd": 0, "bce_bwd": 6, "seq_ce_bwd": 0, "poe_kl_bwd": 3,
                             "conv_bwd": 3, "conv_dx": 0},
    "cub_shuffle_train": {"kl": 0, "bce": 5, "seq_ce": 8, "conv": 8, "poe_kl": 8,
                          "kl_bwd": 0, "bce_bwd": 3, "seq_ce_bwd": 6, "poe_kl_bwd": 6,
                          "conv_bwd": 6, "conv_dx": 3},
    # ``bf16``: the bf16 paths launch what the f32 ones do (the
    # experts cast around the same kernels): ``celeba_train``'s,
    # ``cub_train``'s and ``mnist_train``'s counts; ``log_likelihood`` of
    # CelebA over 4 batches of 64 at k = 64 (``celeba_iwae``'s a batch), and
    # one call of the bf16 artifact (``serve_celeba``'s).
    "celeba_bf16_train": {"kl": 0, "bce": 104, "seq_ce": 0, "conv": 52, "poe_kl": 52,
                          "kl_bwd": 0, "bce_bwd": 40, "seq_ce_bwd": 0, "poe_kl_bwd": 20,
                          "conv_bwd": 20, "conv_dx": 0},
    "cub_bf16_train": {"kl": 0, "bce": 52, "seq_ce": 72, "conv": 72, "poe_kl": 72,
                       "kl_bwd": 0, "bce_bwd": 20, "seq_ce_bwd": 40, "poe_kl_bwd": 40,
                       "conv_bwd": 40, "conv_dx": 20},
    "mnist_bf16_train": {"kl": 0, "bce": 120, "seq_ce": 0, "conv": 0, "poe_kl": 120,
                         "kl_bwd": 0, "bce_bwd": 100, "seq_ce_bwd": 0, "poe_kl_bwd": 100,
                         "conv_bwd": 0, "conv_dx": 0},
    "celeba_bf16_iwae": {"kl": 0, "bce": 8, "seq_ce": 0, "conv": 4, "poe_kl": 4, **_NO_BWD},
    "serve_celeba_bf16": {"kl": 0, "bce": 0, "seq_ce": 0, "poe_kl": 1, "conv": 1, **_NO_BWD},
    # ``grain`` and ``shuffle`` (PR 22): 3 and 5 epochs of ``mnist_train``.
    **{f"mnist_{kind}_train": {"kl": 0, "bce": 120 * n, "seq_ce": 0, "conv": 0,
                               "poe_kl": 120 * n, "kl_bwd": 0, "bce_bwd": 100 * n,
                               "seq_ce_bwd": 0, "poe_kl_bwd": 100 * n, "conv_bwd": 0,
                               "conv_dx": 0}
       for kind, n in (("grain", 3), ("shuffle", 5))},
    # ``dp``: 20 CelebA steps of 64 under the "b" fold, each the
    # fused PoE + KL once, K2 twice (the image's 6 member terms b-major, the
    # attributes' 23 through the map over examples of 18 rows) and K4 once,
    # and each one's backward: the image's through bce_rows_grad, the
    # attributes' through bce_rows_grad_inner. No eval.
    "celeba_b_train": {"kl": 0, "bce": 40, "seq_ce": 0, "conv": 20, "poe_kl": 20,
                       "kl_bwd": 0, "bce_bwd": 20, "bce_bwd_inner": 20, "seq_ce_bwd": 0,
                       "poe_kl_bwd": 20, "conv_bwd": 20, "conv_dx": 0},
    # ``tp_fsdp``: rank 0's 3 steps under the "b" fold, as
    # ``celeba_b_train``'s a step: CelebA under TP at 2 ranks (K4 at 16
    # channels) and under FSDP (K4 at 32, the whole gathered weights).
    **{path: {"kl": 0, "bce": 6, "seq_ce": 0, "conv": 3, "poe_kl": 3, "kl_bwd": 0,
              "bce_bwd": 3, "bce_bwd_inner": 3, "seq_ce_bwd": 0, "poe_kl_bwd": 3,
              "conv_bwd": 3, "conv_dx": 0}
       for path in ("celeba_tp_train", "celeba_fsdp_train")},
    # CUB's 3 steps under TP at 2 ranks (K4 at 16) and at 4 (K4 at 8), as
    # ``cub_train``'s a step: the encode and the cycle's re-encode of the
    # render, K4's input gradient once.
    **{path: {"kl": 0, "bce": 3, "seq_ce": 6, "conv": 6, "poe_kl": 6, "kl_bwd": 0,
              "bce_bwd": 3, "bce_bwd_inner": 0, "seq_ce_bwd": 6, "poe_kl_bwd": 6,
              "conv_bwd": 6, "conv_dx": 3}
       for path in ("cub_tp_train", "cub_tp4_train")},
}
# K2's VJP at the map over examples of several rows runs on the "b" fold's
# CelebA step alone: every other path launches it no time.
for _expected in EXPECTED_LAUNCHES.values():
    _expected.setdefault("bce_bwd_inner", 0)
# Names of the hand-written kernels' __global__ functions, to find them
# in a profile.
PORT_KERNELS = ("kl_rows_kernel", "bce_rows_kernel", "bce_split_kernel", "bce_thread_rows_kernel",
                "bce_inner_rows_kernel", "bce_inner_grad_rows_kernel",
                "seq_ce_tokens_kernel", "conv_s2_tiles_kernel", "poe_kl_kernel",
                "kl_rows_grad_kernel", "bce_rows_grad_kernel", "seq_ce_grad_kernel",
                "seq_ce_grad_staged_kernel", "seq_ce_grad_warp_kernel", "poe_kl_bwd_kernel",
                "conv_s2_bwd_partials_kernel", "conv_s2_bwd_reduce_kernel", "conv_s2_dx_kernel")
# The launch count each of them adds to: one wrapper call launches one of
# its kernels (K4's backward two, its partial sums and their reduction: the
# count follows the first).
KERNEL_OP = {"kl_rows_kernel": "kl", "bce_rows_kernel": "bce", "bce_split_kernel": "bce",
             "bce_thread_rows_kernel": "bce", "bce_inner_rows_kernel": "bce",
             "bce_inner_grad_rows_kernel": "bce_bwd_inner",
             "seq_ce_tokens_kernel": "seq_ce",
             "conv_s2_tiles_kernel": "conv", "poe_kl_kernel": "poe_kl",
             "kl_rows_grad_kernel": "kl_bwd", "bce_rows_grad_kernel": "bce_bwd",
             "seq_ce_grad_kernel": "seq_ce_bwd", "seq_ce_grad_staged_kernel": "seq_ce_bwd",
             "seq_ce_grad_warp_kernel": "seq_ce_bwd", "poe_kl_bwd_kernel": "poe_kl_bwd",
             "conv_s2_bwd_partials_kernel": "conv_bwd", "conv_s2_dx_kernel": "conv_dx"}
PAD = 0
# Replays (of 20 calls) or eager rounds a kernel timing takes the median of.
REPS = 15


START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a result line carries ``t_s``, its seconds since the
    start of the run."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def data_dtype(shape) -> torch.dtype:
    """The type of the data a shape of ``CHECKED_SHAPES`` or
    ``TIMED_SHAPES`` feeds a kernel: its last field where that is a dtype
    (bf16 targets of K2 and its VJP, a bf16 image of K4's backward), else
    float32."""
    return shape[-1] if isinstance(shape[-1], torch.dtype) else torch.float32


def conv_out(shape) -> int:
    """K4's output channels F at a conv shape: 16 or 8 where it names
    ``"f16"`` or ``"f8"`` past its (B, H, W, C), else 32."""
    return next((int(f[1:]) for f in shape[4:] if f in ("f16", "f8")), kernels.CONV_OUT)


def entry_of(op: str, shape) -> str:
    """The entry of the kernels line a shape of ``CHECKED_SHAPES`` or
    ``TIMED_SHAPES`` belongs to: K4's forward, backward and input gradient
    on all-bf16 operands (a bf16 model's stage 0) apart from their other
    forms, and at F = 16 and 8 (``conv_out``) apart from F = 32."""
    if (op == "conv" and shape[4] == torch.bfloat16) or (
            op in ("conv_bwd", "conv_dx") and "all_bf16" in shape[4:]):
        return f"{op}_bf16"
    if op in ("conv", "conv_bwd", "conv_dx") and conv_out(shape) != kernels.CONV_OUT:
        return f"{op}_f{conv_out(shape)}"
    return op


def describe(op: str, shape) -> dict:
    if op in ("conv", "conv_bwd", "conv_dx"):
        return {**_describe_conv(op, shape), "out_channels": conv_out(shape)}
    return _describe(op, shape)


def _describe_conv(op: str, shape) -> dict:
    if op in ("conv_bwd", "conv_dx") and "all_bf16" in shape[4:]:
        return {"shape": list(shape[:4]), "dtype": "bfloat16 (all operands)"}
    if op == "conv_bwd":
        return {"shape": list(shape[:4]), "dtype": str(data_dtype(shape)).removeprefix("torch.")}
    if op == "conv_dx":
        g = [f for f in shape[4:] if f == "transposed"]
        return {"shape": list(shape[:4]), "g": g[0] if g else "contiguous"}
    return {"shape": list(shape[:4]), "dtype": str(shape[4]).removeprefix("torch.")}


def _describe(op: str, shape) -> dict:
    if op in ("poe_kl", "poe_kl_bwd"):
        return {"shape": list(shape[:4]), "case": shape[4]}
    if op == "seq_ce":
        return {"shape": list(shape[:3]), "tiled_b_major_from": shape[3] if len(shape) > 3 else None}
    out = {"shape": list(shape[:3]), "fold": shape[3] if len(shape) > 3 else None}
    inner = [f for f in shape[4:] if isinstance(f, int)]
    if inner:
        out["inner"] = inner[0]
    if op in ("bce", "bce_bwd", "bce_bwd_inner"):
        out["dtype"] = str(data_dtype(shape)).removeprefix("torch.")
    return out


def inputs(op: str, shape, gen: torch.Generator):
    dev = gen.device
    if op == "kl":
        n, d = shape[:2]
        return (torch.randn(n, d, generator=gen, device=dev),
                torch.randn(n, d, generator=gen, device=dev))
    if op == "bce":
        n, d, n_x, fold = shape[:4]
        logits = 3.0 * torch.randn(n, d, generator=gen, device=dev)
        x = torch.rand(n_x, d, generator=gen, device=dev).to(data_dtype(shape))
        # and the rows an example holds
        return (logits, x, fold, *(f for f in shape[4:] if isinstance(f, int)))
    if op == "conv":
        # As the probe draws them: image in [0, 1], weights N(0, 0.01);
        # "bf16_x": a bf16 image into f32 weights.
        b, h, w, c, dtype = shape[:5]
        f = conv_out(shape)
        x = torch.rand(b, h, w, c, generator=gen, device=dev)
        weight = 0.1 * torch.randn(f, c, 4, 4, generator=gen, device=dev)
        bias = 0.1 * torch.randn(f, generator=gen, device=dev)
        if dtype == "bf16_x":
            return x.bfloat16(), weight, bias
        return tuple(t.to(dtype) for t in (x, weight, bias))
    if op == "poe_kl":
        return poe_inputs(shape, gen)
    if op in ("conv_bwd", "conv_dx"):
        # K4's input gradient may take its upstream gradient transposed (a
        # view whose rows are its columns' storage).
        # "all_bf16": every operand bf16 (a bf16 model's stage 0).
        f = conv_out(shape)
        x, weight, bias = inputs("conv", (*shape[:4], torch.float32, f"f{f}"), gen)
        x = x.to(data_dtype(shape))
        b, h, w = shape[:3]
        g = torch.randn(b, f, -(-h // 2), -(-w // 2), generator=gen, device=dev)
        if "transposed" in shape[4:]:
            g = g.transpose(2, 3).contiguous().transpose(2, 3)
        if "all_bf16" in shape[4:]:
            return tuple(t.to(torch.bfloat16) for t in (x, weight, bias, g))
        return (x, weight, bias, g)
    if op == "kl_bwd":
        return (*inputs("kl", shape, gen), torch.randn(shape[0], generator=gen, device=dev))
    if op in ("bce_bwd", "bce_bwd_inner"):
        logits, x, fold, *inner = inputs("bce", shape, gen)
        return (logits, x, torch.randn(shape[0], generator=gen, device=dev), fold, *inner)
    if op == "seq_ce_bwd":
        return (*inputs("seq_ce", shape, gen), torch.randn(shape[0], generator=gen, device=dev))
    if op == "poe_kl_bwd":
        t, b, _, l, case = shape
        args = poe_inputs((*shape[:4], "wide" if case == "ties" else case), gen)
        if case == "ties":
            args[1][:, :, ::3] = 11.0
            args[1][:, :, 1::3] = -11.0
        mu_f, lv_f, _ = kernels.poe_kl_torch(*args)
        g_mu = torch.randn(t, b, l, generator=gen, device=dev)
        g_lv = torch.randn(t, b, l, generator=gen, device=dev)
        g_kl = torch.randn(t, b, generator=gen, device=dev)
        if case == "cycle":  # a re-read uses only the posterior mean
            g_lv, g_kl = torch.zeros_like(g_lv), torch.zeros_like(g_kl)
        return (*args, mu_f, lv_f, g_mu, g_lv, g_kl)
    # Tokens whose rows end in PAD runs of random length; the first rows
    # are all PAD. With a fourth field, the tokens of that many examples
    # tiled b-major to the rows (each example's k rows the same).
    n, s, v = shape[:3]
    n_tok = shape[3] if len(shape) > 3 else n
    logits = 3.0 * torch.randn(n, s, v, generator=gen, device=dev)
    tokens = torch.randint(1, v, (n_tok, s), generator=gen, device=dev, dtype=torch.int32)
    lengths = torch.randint(0, s + 1, (n_tok,), generator=gen, device=dev)
    lengths[: max(1, n_tok // 50)] = 0
    tokens[torch.arange(s, device=dev)[None, :] >= lengths[:, None]] = PAD
    return (logits, kernels.tile_rows(tokens, n, kernels.FOLD_B), PAD)


def poe_inputs(shape, gen: torch.Generator):
    """Expert stack, subset masks and presence of the fused PoE + KL at
    (T, B, M, L). ``eval``: every modality present; ``ragged``: CelebA's
    padded last batch, rows from 16 on absent; ``none``: no presence mask;
    ``wide``: log-variances past the +-11 clamp; ``unaligned``: experts one
    element into their storage (scalar loads); ``text``: MultiMNIST's text
    expert (the last), its mean 0 and log-variance exactly +11 on the
    latter half of the dims; ``cycle``: the same experts under a cycle
    re-read's one mask, every expert but the last, and no presence;
    ``subsets``: a train step's masks, the 1 + M of the eval and T - 1 - M
    random rows (Bernoulli(0.5)), the first of them all zero; ``joint``:
    the IWAE's joint posterior, one all-ones mask and no presence;
    ``mmvae`` and ``mopoe``: the mixture objectives' component masks
    (``core.component_masks``), every modality present; ``serve``: a served
    batch's fusion, one all-ones mask under a presence of Bernoulli(0.5)
    rows, the first observing nothing."""
    t, b, m, l, case = shape
    dev = gen.device
    n = b * m * l
    lo = 1 if case == "unaligned" else 0
    mu = torch.randn(n + lo, generator=gen, device=dev)[lo:].view(b, m, l)
    lv = torch.randn(n + lo, generator=gen, device=dev)[lo:].view(b, m, l)
    if case == "wide":
        lv = 20.0 * lv
    if case in ("text", "cycle"):
        mu[:, -1, l // 2:] = 0.0
        lv[:, -1, l // 2:] = 11.0
    masks = elbo_subset_masks(m, device=dev)
    if case == "subsets":
        rows = (torch.rand(t - 1 - m, m, generator=gen, device=dev) < 0.5).float()
        rows[0] = 0.0
        masks = torch.cat([masks, rows])
    if case == "cycle":
        masks = torch.ones(1, m, device=dev)
        masks[0, -1] = 0.0
    if case in ("joint", "serve"):
        masks = torch.ones(1, m, device=dev)
    if case in ("mmvae", "mopoe"):
        masks = component_masks(case, m, device=dev)
    if masks.shape[0] != t:
        raise AssertionError(f"{m} experts give {masks.shape[0]} terms, not {t}")
    presence = torch.ones(b, m, device=dev)
    if case == "ragged":
        presence[16:] = 0.0
    if case == "serve":
        presence = (torch.rand(b, m, generator=gen, device=dev) < 0.5).float()
        presence[0] = 0.0
    return mu, lv, masks, None if case in ("none", "cycle", "joint") else presence


def parent_chain(*args):
    """The launches the eval ran before the fused kernel, as its step ran
    them: the mask product, ``core.product_of_experts``, then K1."""
    mu_f, lv_f = kernels.masked_poe_torch(*args)
    l = mu_f.shape[-1]
    return kernels.kl_std_normal_kernel(mu_f.reshape(-1, l), lv_f.reshape(-1, l))


def bce_kernel(logits, x, fold, inner=1):
    """K2 as ``inputs`` gives its arguments (the rows an example holds
    last)."""
    return kernels.bernoulli_nll_kernel(logits, x, fold, inner=inner)


def bce_grad_inner_kernel(logits, x, g, fold, inner):
    """K2's VJP at the map over examples of ``inner`` rows, as ``inputs``
    gives its arguments."""
    return kernels.bce_rows_grad_kernel(logits, x, g, fold, inner=inner)


KERNEL_FN = {"kl": kernels.kl_std_normal_kernel, "bce": bce_kernel,
             "seq_ce": kernels.masked_seq_ce_kernel, "conv": kernels.conv4x4s2_swish_kernel,
             "poe_kl": kernels.poe_kl_kernel, "kl_bwd": kernels.kl_rows_grad_kernel,
             "bce_bwd": kernels.bce_rows_grad_kernel, "bce_bwd_inner": bce_grad_inner_kernel,
             "seq_ce_bwd": kernels.masked_seq_ce_grad_kernel,
             "poe_kl_bwd": kernels.poe_kl_grad_kernel,
             "conv_bwd": kernels.conv4x4s2_swish_grad_kernel,
             "conv_dx": kernels.conv4x4s2_swish_input_grad_kernel}
PLAIN_FN = {"kl": kernels.kl_std_normal_torch, "bce": kernels.bernoulli_nll_torch,
            "seq_ce": kernels.masked_seq_ce_torch, "conv": kernels.conv4x4s2_swish_torch,
            "poe_kl": kernels.poe_kl_torch, "kl_bwd": kernels.kl_rows_grad_torch,
            "bce_bwd": kernels.bce_rows_grad_torch, "bce_bwd_inner": kernels.bce_rows_grad_torch,
            "seq_ce_bwd": kernels.masked_seq_ce_grad_torch,
            "poe_kl_bwd": kernels.poe_kl_grad_torch,
            "conv_bwd": kernels.conv4x4s2_swish_grad_torch,
            "conv_dx": kernels.conv4x4s2_swish_input_grad_torch}


def library_fn(op: str, args):
    """A call of no arguments that runs one PyTorch call computing the
    same function on ``args``, or None. Timed as a yardstick; the port
    never calls it. What the library call needs in another form (tiled
    targets, an NCHW copy of the image) is made here, before the timing."""
    if op == "bce":
        logits, x, fold, *inner = args
        tiled = kernels.tile_rows(x, logits.shape[0], fold, *inner).float()  # bf16 upcast
        return lambda: F.binary_cross_entropy_with_logits(
            logits, tiled, reduction="none").sum(-1)
    if op == "seq_ce":
        logits, tokens, pad = args
        n, s, v = logits.shape
        flat, labels = logits.view(-1, v), tokens.view(-1).long()
        return lambda: F.cross_entropy(
            flat, labels, ignore_index=pad, reduction="none").view(n, s).sum(-1)
    if op == "conv":
        # padding=1 is XLA's SAME only at even sizes, as timed here.
        x, weight, bias = args
        x_nchw = x.permute(0, 3, 1, 2).to(weight.dtype).contiguous()  # a bf16 image upcast
        return lambda: F.silu(F.conv2d(x_nchw, weight, bias, stride=2, padding=1))
    if op in ("bce_bwd", "bce_bwd_inner", "seq_ce_bwd", "poe_kl_bwd", "conv_bwd", "conv_dx"):
        return autograd_backward(op, args)
    return None


def autograd_backward(op: str, args):
    """The library forward of ``op``'s function run with autograd on, and a
    call that runs only its backward on ``args``' output gradients (the
    graph is kept). Autograd runs a backward op on its forward op's stream,
    so this runs on the stream that will run the call (``graph_ms`` makes
    it there)."""
    if op in ("bce_bwd", "bce_bwd_inner"):
        # The targets tiled first (at the inner map, example by example).
        logits, x, g, fold, *inner = args
        leaves = (logits.detach().requires_grad_(True),)
        tiled = kernels.tile_rows(x, logits.shape[0], fold, *inner).float()  # bf16 upcast
        outs = (F.binary_cross_entropy_with_logits(leaves[0], tiled, reduction="none").sum(-1),)
        grads = (g,)
    elif op == "conv_bwd":
        # cuDNN's wgrad and the silu's backward, for the weight and bias
        # alone (padding=1 is XLA's SAME at the even sizes timed here).
        x, weight, bias, g = args
        x_nchw = x.permute(0, 3, 1, 2).to(weight.dtype).contiguous()  # a bf16 image upcast
        leaves = (weight.detach().requires_grad_(True), bias.detach().requires_grad_(True))
        outs = (F.silu(F.conv2d(x_nchw, *leaves, stride=2, padding=1)),)
        grads = (g,)
    elif op == "conv_dx":
        # cuDNN's dgrad and the silu's backward, for the image alone (XLA's
        # SAME pad, which is asymmetric at odd sizes, as an F.pad).
        x, weight, bias, g = args
        leaves = (x.permute(0, 3, 1, 2).contiguous().requires_grad_(True),)
        padded = F.pad(leaves[0], kernels.same_pad(x.shape[1:3]))
        outs = (F.silu(F.conv2d(padded, weight, bias, stride=2)),)
        grads = (g,)
    elif op == "seq_ce_bwd":
        logits, tokens, pad, g = args
        n, s, v = logits.shape
        leaves = (logits.detach().requires_grad_(True),)
        outs = (F.cross_entropy(leaves[0].view(-1, v), tokens.view(-1).long(), ignore_index=pad,
                                reduction="none").view(n, s).sum(-1),)
        grads = (g,)
    else:
        mu_e, lv_e, masks, presence = args[:4]
        leaves = (mu_e.detach().requires_grad_(True), lv_e.detach().requires_grad_(True))
        outs = kernels.poe_kl_torch(*leaves, masks, presence)
        grads = args[6:]
    return lambda: torch.autograd.grad(outs, leaves, grads, retain_graph=True)


def tolerance(op: str, shape) -> tuple[float, float]:
    """(rtol, atol) of a kernel against its plain version; for the fused
    PoE + KL, of its KL (its posteriors: atol 1e-6); for its backward, the
    atol per unit of the largest gradient; for K4's backward, atol 1e-6
    times the B * ceil(H/2) * ceil(W/2) terms each entry of dW and db sums
    (each below 1 in size: an image in [0, 1] times g * swish'), in another
    order than the plain version's batched product; for K4's input
    gradient, atol 1e-6 times the 4 taps x 32 channels each entry of dx
    sums (each below 1 in size: g * swish' times a weight). Both on
    all-bf16 operands: rtol 2^-7 beside those atols, the two sides summing
    in f32 and each rounding once to bf16, so one bf16 step (2^-7 of the
    value at most) apart where their f32 sums straddle a rounding. K4 on
    all-bf16 operands: rtol 2^-7 and atol 0, one bf16 step: both sides sum
    the conv in f32 and round it, the bias add, the sigmoid and the
    product to bf16, as Flax does."""
    if op in ("kl_bwd", "bce_bwd", "bce_bwd_inner", "seq_ce_bwd"):
        return 1e-5, 1e-6
    rtol = 2.0**-7 if "all_bf16" in shape[4:] else 1e-5
    if op == "conv_bwd":
        b, h, w = shape[:3]
        return rtol, 1e-6 * b * -(-h // 2) * -(-w // 2)
    if op == "conv_dx":
        return rtol, 1e-6 * 4 * conv_out(shape)
    if op == "poe_kl_bwd":
        return 1e-5, 1e-5 * shape[0]
    if op == "poe_kl":
        return 1e-5, 1e-5 * shape[3]
    if op == "conv":
        # A bf16 image into f32 weights is exact in f32: f32's tolerance.
        c, dtype = shape[3], shape[4]
        return (1e-5, 1e-5 * 16 * c) if dtype in (torch.float32, "bf16_x") else (2.0**-7, 0.0)
    return 1e-5, 1e-5 * (shape[1] * math.log(shape[2]) if op == "seq_ce" else shape[1])


def bound(op: str, args) -> tuple[float, str]:
    """Least time on the card for this call's inputs: each input byte the
    function needs read once, the output written once, or the operations
    at the peak rate of their type (f32: 67 TFLOP/s, TF32 off as the path
    runs; bf16: 989 TFLOP/s). The sequence cross-entropy needs no logit of
    a pad token, so only the non-pad token rows' logits count. The fused PoE
    + KL reads the expert stack, the masks and the presence and writes the
    posteriors and the KLs."""
    if op in ("poe_kl", "poe_kl_bwd"):
        # The backward also reads the saved posteriors and the three output
        # gradients and writes two expert-stack gradients.
        mu_e, _, masks, presence = args[:4]
        (b, m, l), t = mu_e.shape, masks.shape[0]
        bwd = op == "poe_kl_bwd"
        n_bytes = 4 * ((4 if bwd else 2) * b * m * l + t * m
                       + (0 if presence is None else b * m)
                       + (4 if bwd else 2) * t * b * l + t * b)
        counts = POE_BWD_OPS if bwd else POE_OPS
        n_ops = (counts["expert"] * b * m * l + counts["term_expert"] * t * b * m * l
                 + counts["out"] * t * b * l)
        t_bytes = n_bytes / HBM_BYTES_PER_S
        t_ops = n_ops / PEAK_OPS_PER_S[torch.float32]
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    if op in ("conv_bwd", "conv_dx"):
        # x, g, the weight and bias read; dW and db written (the backward)
        # or dx (the input gradient). Per (output pixel, channel): pre
        # recomputed and the second product (dW's accumulation, or T = S W
        # of dx), 16 C multiply-adds each as three TF32 products, and
        # CONV_BWD_OPS_PER_OUT in f32 for swish' and the product with g.
        # On all-bf16 operands the products are bf16 ones, once each, at the
        # bf16 tensor-core rate, and every byte is counted at its size.
        x, weight, bias, g = args
        c = x.shape[3]
        out = x.numel() if op == "conv_dx" else weight.numel() + bias.numel()
        n_bytes = (x.element_size() * x.numel()
                   + g.element_size() * (g.numel() + weight.numel() + bias.numel() + out))
        t_bytes = n_bytes / HBM_BYTES_PER_S
        products = (2 * 2 * 16 * c * g.numel() / PEAK_OPS_PER_S[torch.bfloat16]
                    if weight.dtype == torch.bfloat16
                    else 3 * 2 * 2 * 16 * c * g.numel() / PEAK_TF32_OPS_PER_S)
        t_ops = products + CONV_BWD_OPS_PER_OUT * g.numel() / PEAK_OPS_PER_S[torch.float32]
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    if op == "conv":
        # The output in the weights' type; the FMAs at the weights' rate (f32
        # on the CUDA cores for a bf16 image into f32 weights).
        x, weight, bias = args
        b, h, w, c = x.shape
        n_out = b * weight.shape[0] * -(-h // 2) * -(-w // 2)
        n_bytes = (x.element_size() * x.numel()
                   + weight.element_size() * (weight.numel() + bias.numel() + n_out))
        t_bytes = n_bytes / HBM_BYTES_PER_S
        t_ops = n_out * (2 * 16 * c + CONV_OPS_PER_OUT) / PEAK_OPS_PER_S[weight.dtype]
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    if op in ("seq_ce", "seq_ce_bwd"):
        # The gradient also reads g and writes every position's gradient,
        # a pad token's zeros too.
        logits, tokens, pad = args[:3]
        n, _, v = logits.shape
        n_elems = int((tokens != pad).sum()) * v
        n_bytes = 4 * n_elems + tokens.numel() * tokens.element_size() + 4 * n
        if op == "seq_ce_bwd":
            n_bytes += 4 * logits.numel()
    elif op in ("kl_bwd", "bce_bwd", "bce_bwd_inner"):
        # The rows and their partner (lv or the untiled targets, f32 or
        # bf16) and the row gradients read, one (KL: two) (N, D) gradients
        # written.
        n, d = args[0].shape
        n_elems = n * d
        n_bytes = (4 * (n * d + n + (2 if op == "kl_bwd" else 1) * n * d)
                   + args[1].element_size() * args[1].numel())
    else:
        n, d = args[0].shape
        n_elems = n * d
        n_bytes = 4 * (n * d + n) + args[1].element_size() * args[1].numel()
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = OPS_PER_ELEM[op] * n_elems / PEAK_OPS_PER_S[torch.float32]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------ phase 1 ----


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = kernels.build(*kernels.SOURCES, *kernels.PROBE_SOURCES)
    seconds = time.perf_counter() - t0
    for name, so in libs.items():
        ptxas = [
            line.strip() for line in so.with_suffix(".log").read_text().splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line
        ]
        extra = {}
        if name == "conv_s2":
            # K4's input gradient: the plan at CUB's train batch, and each
            # instantiation's registers and spills (C, 16-byte input copies).
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            extra["conv_dx_plan"] = kernels.conv_dx_plan(64, 64, 64, 3, sms)._asdict()
            extra["conv_dx_ptxas"] = dx_ptxas(ptxas)
        emit({"phase": "build", "seconds_all": seconds,
              "library": str(so.relative_to(ROOT)), "ptxas": ptxas, **extra})
    return kind


def dx_ptxas(lines: list[str]) -> dict[str, str]:
    """``-Xptxas -v``'s registers and spills of each instantiation of K4's
    input gradient, keyed ``<f32|bf16> C=<c> vec=<0|1>`` from the mangled
    name."""
    out, key = {}, None
    for line in lines:
        if "Compiling entry" in line:
            found = re.search(r"conv_s2_dx_kernelI(f|13__nv_bfloat16)Li(\d)ELb(\d)E", line)
            key = (f"{'f32' if found.group(1) == 'f' else 'bf16'} C={found.group(2)} "
                   f"vec={found.group(3)}") if found else None
        elif key:
            out[key] = (out.get(key, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


# ------------------------------------------------------------ phase 2 ----


def check_grads(op: str, got, want, shape) -> float:
    """A backward kernel's gradients against its plain version's (the atol
    of the fused PoE + KL's per unit of its largest gradient). Returns the
    largest error."""
    rtol, atol = tolerance(op, shape)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        scale = w.abs().max().item() if op == "poe_kl_bwd" else 1.0
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol * scale)
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def check_poe_kl(args, got, want, shape) -> float:
    """The fused PoE + KL against its plain version: the posteriors at
    rtol 1e-5, atol 1e-6, the KL at ``tolerance``; rows with every expert
    absent give the prior and exactly 0 KL. Returns the largest error."""
    rtol, atol = tolerance("poe_kl", shape)
    for g, w, a in zip(got, want, (1e-6, 1e-6, atol)):
        torch.testing.assert_close(g, w, rtol=rtol, atol=a)
    presence = args[3]
    if presence is not None:
        absent = presence.sum(-1) == 0
        if not all(torch.all(g[:, absent] == 0) for g in got):
            raise AssertionError("a row with no expert did not give the prior and 0 KL")
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def phase_check() -> dict[str, float]:
    """Each kernel against its plain version at every shape of
    ``CHECKED_SHAPES`` (K4's backward and input gradient twice, to the
    bit). Returns each entry's largest error (``entry_of``)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {}
    for op, shapes in CHECKED_SHAPES.items():
        for shape in shapes:
            entry = entry_of(op, shape)
            args = inputs(op, shape, gen)
            got = KERNEL_FN[op](*args)
            want = PLAIN_FN[op](*args)
            torch.cuda.synchronize()
            if entry.endswith("_bf16") and any(t.dtype != torch.bfloat16 for t in
                                               ((got,) if torch.is_tensor(got) else got)):
                raise AssertionError(f"{entry}: an output of the kernel is not bf16")
            if op == "poe_kl":
                err = check_poe_kl(args, got, want, shape)
            elif op in BWD_OPS:
                err = check_grads(op, got, want, shape)
            else:
                err = (got.float() - want.float()).abs().max().item()
                rtol, atol = tolerance(op, shape)
                torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            if op == "seq_ce" and not torch.all(got[(args[1] == PAD).all(-1)] == 0):
                raise AssertionError("an all-pad row did not give exactly 0")
            if op == "seq_ce_bwd" and not torch.all(got[args[1] == PAD] == 0):
                raise AssertionError("a pad token's gradient is not exactly 0")
            if op == "conv_bwd" and not all(
                    torch.equal(a, b) for a, b in zip(got, KERNEL_FN[op](*args))):
                raise AssertionError("two launches of conv4x4s2_swish_bwd differ")
            if op == "conv_dx" and not torch.equal(got, KERNEL_FN[op](*args)):
                raise AssertionError("two launches of conv4x4s2_swish_dx differ")
            if op == "bce_bwd_inner" and not torch.equal(got, KERNEL_FN[op](*args)):
                raise AssertionError("two launches of bce_rows_grad_inner differ")
            max_err[entry] = max(max_err.get(entry, 0.0), err)
            emit({"phase": "check", "kernel": META[op]["name"], **describe(op, shape),
                  "max_abs_err": err})
    return max_err


# ------------------------------------------------------------ phase 3 ----


def drive(config, calls) -> tuple[dict, dict[str, int]]:
    """``config``'s eval over its 2,000-example test split, then ``calls``
    (name -> function of the model), all with the "kernel" backend (every
    reduction runs in its kernel or raises) and the launch counts set to 0
    just before and read just after. ``config`` is a name or an
    ``ExperimentConfig`` (another objective)."""
    cfg = configs.get_config(config) if isinstance(config, str) else config
    model = configs.build_model(cfg, seed=0)
    test = load_dataset(cfg.dataset, "test")
    if test.size != 2000:
        raise AssertionError(f"{cfg.name}: test split of {test.size}, not 2000")
    ops.set_backend("kernel")
    try:
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        elbo = api.eval_elbo(cfg, model=model, dataset=test)
        outs = {name: call(model) for name, call in calls.items()}
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        ops.set_backend("auto")
    emit({"phase": "main_path", "config": cfg.name, "objective": cfg.objective,
          "eval_elbo": elbo, "launches": launches})

    ops.set_backend("torch")
    try:
        elbo_plain = api.eval_elbo(cfg, model=model, dataset=test)
    finally:
        ops.set_backend("auto")
    if kernels.LAUNCHES != launches:
        raise AssertionError("the torch backend launched a kernel")
    rel = abs(elbo - elbo_plain) / abs(elbo_plain)
    emit({"phase": "kernel_vs_torch_backend", "config": cfg.name, "objective": cfg.objective,
          "eval_elbo_kernel": elbo, "eval_elbo_torch": elbo_plain, "rel": rel})
    if not rel <= 1e-5:
        raise AssertionError(f"{cfg.name}: kernel and torch backends differ: rel {rel}")
    return outs, launches


def check_image(img, n: int, hw: tuple[int, ...]) -> None:
    if img.shape != (n, *hw):
        raise AssertionError(f"bad image shape {tuple(img.shape)}")
    if not (torch.isfinite(img).all() and img.min() >= 0 and img.max() <= 1):
        raise AssertionError("generated image not finite or outside [0, 1]")


def check_text(text, n: int, max_len: int = 5, vocab: int = 13) -> None:
    """Token strings: (n, max_len) tokens below ``vocab``, PAD after the
    first STOP (MultiMNIST's digit strings by default)."""
    if text.shape != (n, max_len) or text.min() < 0 or text.max() >= vocab:
        raise AssertionError(f"bad text {tuple(text.shape)} {text.min()} {text.max()}")
    is_stop = (text == STOP).int()
    after_stop = is_stop.cumsum(1) - is_stop > 0
    if not torch.all(text[after_stop] == PAD):
        raise AssertionError("a token after STOP is not PAD")


def check_probs(probs, shape: tuple[int, ...]) -> None:
    if probs.shape != shape:
        raise AssertionError(f"bad shape {tuple(probs.shape)}, not {shape}")
    if not (torch.isfinite(probs).all() and probs.min() >= 0 and probs.max() <= 1):
        raise AssertionError("generated probabilities not finite or outside [0, 1]")


def card_vs_cpu(config, n: int, condition: dict, on_card: dict) -> None:
    """The eval on an ``n``-example split and ``generate`` at temperature 0
    from ``condition``, on the card and on the CPU, from the same seed:
    generated probabilities within 1e-4, tokens and labels equal.
    ``config`` is a name or an ``ExperimentConfig``."""
    cfg = configs.get_config(config) if isinstance(config, str) else config
    config = cfg.name
    model = configs.build_model(cfg, seed=0)
    cpu_model = configs.build_model(cfg, seed=0, device="cpu")
    small = load_dataset(cfg.dataset, "test", n=n)
    elbo_card = api.eval_elbo(cfg, model=model, dataset=small)
    elbo_cpu = api.eval_elbo(cfg, model=cpu_model, dataset=small, device="cpu")
    gen_cpu = api.generate(cfg, condition, model=cpu_model, device="cpu", temperature=0.0)
    rel = abs(elbo_card - elbo_cpu) / abs(elbo_cpu)
    kinds = cpu_model.decode_kinds()
    probs = [k for k in gen_cpu if kinds.get(k) == "bernoulli"]
    errs = {k: (on_card[k].cpu() - gen_cpu[k]).abs().max().item() for k in probs}
    emit({"phase": "card_vs_cpu", "config": config, "path": variant_label(cfg),
          "objective": cfg.objective, "examples": n,
          "eval_elbo_card": elbo_card, "eval_elbo_cpu": elbo_cpu, "rel": rel,
          "generate_max_abs_err": errs})
    if not rel <= 1e-4 or not all(e <= 1e-4 for e in errs.values()):
        raise AssertionError(f"{config}: card and CPU differ: rel {rel}, generated {errs}")
    for key in set(gen_cpu) - set(probs):
        if not torch.equal(on_card[key].cpu(), gen_cpu[key]):
            raise AssertionError(f"{config}: generated {key} differs between card and CPU")


def phase_main_path() -> dict[str, dict[str, int]]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    labels = {"label": [3, 5, 7]}
    outs, mnist = drive("mnist", {
        "generate": lambda m: api.generate("mnist", labels, model=m),
        "sample": lambda m: api.sample("mnist", n=64, model=m, generator=gen),
    })
    if mnist != EXPECTED_LAUNCHES["mnist"]:
        raise AssertionError(f"mnist: expected launches {EXPECTED_LAUNCHES['mnist']}, got {mnist}")
    for out, n in ((outs["generate"], 3), (outs["sample"], 64)):
        check_image(out["image"], n, (28, 28))
        if not (out["label"].min() >= 0 and out["label"].max() < 10):
            raise AssertionError("generated label out of range")
    card_vs_cpu("mnist", 250, labels, outs["generate"])

    images = {"image": load_dataset("fashionmnist", "test", n=3).arrays["image"]}
    outs, fashionmnist = drive("fashionmnist", {
        "from_labels": lambda m: api.generate("fashionmnist", labels, model=m),
        "from_images": lambda m: api.generate("fashionmnist", images, model=m),
        "sample": lambda m: api.sample("fashionmnist", n=64, model=m, generator=gen),
    })
    if fashionmnist != EXPECTED_LAUNCHES["fashionmnist"]:
        raise AssertionError(f"fashionmnist: expected launches "
                             f"{EXPECTED_LAUNCHES['fashionmnist']}, got {fashionmnist}")
    for out, n in ((outs["from_labels"], 3), (outs["from_images"], 3), (outs["sample"], 64)):
        check_image(out["image"], n, (28, 28))
        if not (out["label"].min() >= 0 and out["label"].max() < 10):
            raise AssertionError("generated label out of range")
    card_vs_cpu("fashionmnist", 250, images, outs["from_images"])

    data = load_dataset("multimnist", "test", n=3).arrays
    text = {"text": data["text"]}
    outs, multimnist = drive("multimnist", {
        "from_text": lambda m: api.generate("multimnist", text, model=m, temperature=0.0),
        "from_image": lambda m: api.generate(
            "multimnist", {"image": data["image"]}, model=m, generator=gen),
        "from_nothing": lambda m: api.generate("multimnist", {}, n=8, model=m, generator=gen),
        "sample": lambda m: api.sample("multimnist", n=64, model=m, generator=gen),
    })
    if multimnist != EXPECTED_LAUNCHES["multimnist"]:
        raise AssertionError(
            f"multimnist: expected launches {EXPECTED_LAUNCHES['multimnist']}, got {multimnist}")
    for name, n in (("from_text", 3), ("from_image", 3), ("from_nothing", 8), ("sample", 64)):
        check_image(outs[name]["image"], n, (50, 50))
        check_text(outs[name]["text"], n)
    emit({"phase": "generated_text", "from_text": outs["from_text"]["text"].tolist(),
          "from_image": outs["from_image"]["text"].tolist()})
    card_vs_cpu("multimnist", 200, text, outs["from_text"])

    data = load_dataset("celeba", "test", n=3).arrays
    images = {"image": data["image"]}
    pair = {"attr_4": [1.0, 0.0, 1.0, 0.0], "attr_8": [0.0, 0.0, 1.0, 1.0]}
    outs, celeba = drive("celeba", {
        "from_image": lambda m: api.generate("celeba", images, model=m),
        "from_attrs": lambda m: api.generate("celeba", {"attrs": data["attrs"]}, model=m),
        "from_attr_4_8": lambda m: api.generate("celeba", pair, model=m),
        "from_nothing": lambda m: api.generate("celeba", {}, n=8, model=m),
        "sample": lambda m: api.sample("celeba", n=64, model=m, generator=gen),
    })
    if celeba != EXPECTED_LAUNCHES["celeba"]:
        raise AssertionError(f"celeba: expected launches {EXPECTED_LAUNCHES['celeba']}, got {celeba}")
    for name, n in (("from_image", 3), ("from_attrs", 3), ("from_attr_4_8", 4),
                    ("from_nothing", 8), ("sample", 64)):
        check_image(outs[name]["image"], n, (64, 64, 3))
        check_probs(outs[name]["attrs"], (n, 18))
    card_vs_cpu("celeba", 128, images, outs["from_image"])

    data = load_dataset("cub", "test", n=3).arrays
    captions = {"text": data["text"]}
    outs, cub = drive("cub", {
        "from_image": lambda m: api.generate("cub", {"image": data["image"]}, model=m,
                                             generator=gen),
        "from_text": lambda m: api.generate("cub", captions, model=m, temperature=0.0),
        "from_nothing": lambda m: api.generate("cub", {}, n=8, model=m, generator=gen),
        "sample": lambda m: api.sample("cub", n=64, model=m, generator=gen),
    })
    if cub != EXPECTED_LAUNCHES["cub"]:
        raise AssertionError(f"cub: expected launches {EXPECTED_LAUNCHES['cub']}, got {cub}")
    vocab = configs.cub_vocab_size()
    for name, n in (("from_image", 3), ("from_text", 3), ("from_nothing", 8), ("sample", 64)):
        check_image(outs[name]["image"], n, (64, 64, 3))
        check_text(outs[name]["text"], n, 32, vocab)
    emit({"phase": "generated_text", "config": "cub",
          "from_text": outs["from_text"]["text"].tolist(),
          "from_image": outs["from_image"]["text"].tolist()})
    card_vs_cpu("cub", 128, captions, outs["from_text"])
    return {"mnist": mnist, "fashionmnist": fashionmnist, "multimnist": multimnist,
            "celeba": celeba, "cub": cub}


IWAE_CPU_EXAMPLES, IWAE_CPU_BATCH = 10, 4  # three batches, the last half pad


def phase_iwae() -> dict[str, dict[str, int]]:
    """``api.log_likelihood`` at k = 64 of every config over its
    2,000-example test split with the "kernel" backend, the launch counts
    set to 0 just before and read just after (through the graph replays);
    then with the ``torch`` backend from the same generator seed (rel
    1e-5), and on a 10-example split at batch 4 (a padded last batch) on
    the card against the CPU with the noise passed in (rel 1e-4: log w is
    about -8,000 on CelebA and CUB, so the gate is relative)."""
    out = {}
    for config in CONFIGS:
        model = configs.build_model(config, seed=0)
        test = load_dataset(config, "test")
        ops.set_backend("kernel")
        try:
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            ll = api.log_likelihood(config, model=model, dataset=test, k=IWAE_K, seed=0)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            ops.set_backend("auto")
        emit({"phase": "main_path", "config": config, "log_likelihood": ll, "k": IWAE_K,
              "examples": test.size, "api_wall_s": wall_s, "launches": launches})
        expected = EXPECTED_LAUNCHES[f"{config}_iwae"]
        if launches != expected:
            raise AssertionError(f"{config} iwae: expected launches {expected}, got {launches}")
        if not math.isfinite(ll):
            raise AssertionError(f"{config}: log_likelihood {ll} is not finite")
        ops.set_backend("torch")
        try:
            ll_plain = api.log_likelihood(config, model=model, dataset=test, k=IWAE_K, seed=0)
        finally:
            ops.set_backend("auto")
        if kernels.LAUNCHES != launches:
            raise AssertionError("the torch backend launched a kernel")
        rel = abs(ll - ll_plain) / abs(ll_plain)
        emit({"phase": "kernel_vs_torch_backend", "config": config, "path": "log_likelihood",
              "log_likelihood_kernel": ll, "log_likelihood_torch": ll_plain, "rel": rel})
        if not rel <= 1e-5:
            raise AssertionError(f"{config} iwae: kernel and torch backends differ: rel {rel}")

        cpu_model = configs.build_model(config, seed=0, device="cpu")
        small = load_dataset(config, "test", n=IWAE_CPU_EXAMPLES)
        n_batches = -(-IWAE_CPU_EXAMPLES // IWAE_CPU_BATCH)
        eps = torch.randn((n_batches, IWAE_CPU_BATCH, IWAE_K, model.n_latents),
                          generator=torch.Generator().manual_seed(5))
        kw = dict(dataset=small, k=IWAE_K, batch_size=IWAE_CPU_BATCH)
        ll_card = api.log_likelihood(config, model=model, eps=eps.cuda(), **kw)
        ll_cpu = api.log_likelihood(config, model=cpu_model, device="cpu", eps=eps, **kw)
        rel = abs(ll_card - ll_cpu) / abs(ll_cpu)
        emit({"phase": "card_vs_cpu", "config": config, "path": "log_likelihood",
              "examples": IWAE_CPU_EXAMPLES, "batch": IWAE_CPU_BATCH,
              "log_likelihood_card": ll_card, "log_likelihood_cpu": ll_cpu, "rel": rel})
        if not rel <= 1e-4:
            raise AssertionError(f"{config} iwae: card and CPU differ: rel {rel}")
        out[f"{config}_iwae"] = launches
    return out


def train_batches(n_steps: int, bs: int, device, seed: int = 0,
                  config: str = "mnist") -> dict[str, torch.Tensor]:
    """``n_steps`` batches of ``bs`` from the head of a seeded permutation of
    ``config``'s train split, stacked on ``device``."""
    train = load_dataset(config, "train", n=max(n_steps * bs, 100))
    perm = torch.randperm(train.size, generator=torch.Generator().manual_seed(seed))
    idx = perm[: n_steps * bs].numpy()
    return {k: torch.as_tensor(v[idx], device=device).reshape((n_steps, bs) + v.shape[1:])
            for k, v in train.arrays.items()}


def train_path(cfg) -> str:
    """The name of ``cfg``'s train path in ``EXPECTED_LAUNCHES`` and the
    result lines: ``<config>_train``, ``<config>_<objective>_train`` under
    another objective than mvae, ``<config>_knobs_train`` with the loss
    knobs no named config sets, ``<config>_accum_train`` under gradient
    accumulation."""
    if cfg.accum_steps > 1:
        return f"{cfg.name}_accum_train"
    if cfg.objective != "mvae":
        return f"{cfg.name}_{cfg.objective}_train"
    if cfg.cross_recon_stopgrad or cfg.unimodal_align_weight or cfg.cycle_contrast_weight:
        return f"{cfg.name}_knobs_train"
    return f"{variant_label(cfg)}_train"


def n_terms(cfg, n_mod: int) -> int:
    """The terms T of ``cfg``'s train loss over ``n_mod`` modalities: the
    rows of a step's posterior noise."""
    if cfg.objective in ("mmvae", "mopoe"):
        return component_masks(cfg.objective, n_mod).shape[0]
    if cfg.objective == "mvtcae":
        return 1
    return 1 + n_mod + cfg.n_random_subsets


def train_counted(cfg, dtype: torch.dtype = torch.float32, path: str | None = None) -> tuple:
    """``api.train`` of ``cfg`` (seed 0) at the compute ``dtype`` with the
    "kernel" backend and the launch counts set to 0 just before and read
    just after (the replays' launches included), held to
    ``EXPECTED_LAUNCHES[path]`` (by default ``train_path(cfg)``): the
    result, the counts and the wall."""
    ops.set_backend("kernel")
    try:
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        result = api.train(cfg, seed=0, verbose=False, dtype=dtype)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        ops.set_backend("auto")
    path = path or train_path(cfg)
    if launches != EXPECTED_LAUNCHES[path]:
        raise AssertionError(
            f"{path}: expected launches {EXPECTED_LAUNCHES[path]}, got {launches}")
    return result, launches, wall_s


def profile_counted(fn, attempts: int = 3) -> tuple[dict, list]:
    """``profile_summary`` of ``fn`` whose per-kernel launch counts, as the
    profiler saw them (the replays' kernels are device events too, so the
    counts are not bookkeeping alone), equal the wrappers' over the same
    call. The profiler can lose records: an H100 run once saw 97 of 100
    replays' kernels in a profile, so a mismatch profiles ``fn`` again, up
    to ``attempts`` times; every attempt's counts are returned, and none
    matching raises."""
    seen = []
    for _ in range(attempts):
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        summary = profile_summary(fn)
        seen.append(summary["port_launches"])
        if summary["port_launches"] == kernels.LAUNCHES:
            return summary, seen
    raise AssertionError(
        f"the profiler counted {seen}, the wrappers {dict(kernels.LAUNCHES)}")


def phase_train() -> dict[str, int]:
    """``api.train`` of ``mnist`` for one epoch at full width on the graph
    runners (the launch counts through the replays, and the profiler's);
    then the graph against the eager loop (``train_rate``), a profiled
    step and the card against the CPU over three steps."""
    cfg = configs.get_config("mnist").replace(epochs=1)
    untrained = api.eval_elbo(cfg, model=configs.build_model(cfg, seed=0))
    result, launches, wall_s = train_counted(cfg)
    record = result.history[0]
    emit({"phase": "train", "config": "mnist", "epochs": 1, "steps": result.state.step,
          "train_loss": record["train_loss"], "test_elbo": record["test_elbo"],
          "untrained_test_elbo": untrained, "api_train_wall_s": wall_s, "launches": launches})
    if result.state.step != 100 or not all(map(math.isfinite, record.values())):
        raise AssertionError(f"train: {result.state.step} steps, history {record}")
    if not record["test_elbo"] < untrained:
        raise AssertionError(
            f"train: test ELBO {record['test_elbo']} not below the untrained {untrained}")
    train_rate(cfg, 100, rounds=1, profiled_steps=20)
    train_card_vs_cpu()
    return launches


def run_metrics(metrics: dict) -> tuple[list, list]:
    return metrics["loss"].tolist(), metrics["grad_norm"].tolist()


def graph_vs_eager(runs: dict) -> dict:
    """Graph against eager on the card: the largest relative difference of
    the loss and the raw gradient norm of any step and of any parameter
    (its 2-norm), and whether every bit is equal."""
    (g_metrics, g_model), (e_metrics, e_model) = runs["graph"], runs["eager"]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item() if b.norm() > 0 else (a - b).norm().item()

    step_rel = max(((g_metrics[k] - e_metrics[k]).abs() / e_metrics[k].abs()).max().item()
                   for k in ("loss", "grad_norm"))
    param_rel = max(rel(a, b) for a, b in zip(g_model.parameters(), e_model.parameters()))
    bits = (all(torch.equal(g_metrics[k], e_metrics[k]) for k in e_metrics)
            and all(torch.equal(a, b) for a, b in zip(g_model.parameters(), e_model.parameters())))
    return {"step_rel_max": step_rel, "param_rel_max": param_rel, "bits_equal": bits}


def first_epochs(cfg, batches: dict, dtype: torch.dtype = torch.float32
                 ) -> tuple[dict, dict, dict]:
    """A graph runner and an eager loop from the same seed-0 weights and
    generator seed at the compute ``dtype``, each over ``batches`` once:
    the runners and their states, the first calls' walls (to a sync), and
    each run's metrics and model."""
    runners, first, runs = {}, {}, {}
    for kind in ("graph", "eager"):
        model = configs.build_model(cfg, seed=0, dtype=dtype)
        state = create_train_state(model, cfg.learning_rate, grad_clip=cfg.grad_clip,
                                   ema_decay=cfg.ema_decay)
        gen = torch.Generator(device="cuda").manual_seed(1)
        runner = make_epoch_runner(model, graph=kind == "graph", annealing_steps=1000,
                                   generator=gen, **api.step_options(cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = runner(state, batches)
        torch.cuda.synchronize()
        first[kind] = time.perf_counter() - t0
        runners[kind] = (runner, state)
        runs[kind] = (metrics, model)
    return runners, first, runs


def train_rate(cfg, n_steps: int, rounds: int, profiled_steps: int, gate: bool = True) -> None:
    """The graph runner and the eager loop from the same seed-0 weights,
    generator seed and ``n_steps`` batches of the train split: their first
    epochs compared (gated at rel 1e-6 when ``gate``), then ``rounds``
    epochs of each timed in turns (train samples/s, host clock from a sync to a
    sync); the graph's first call (its first step eager, the capture, the
    replays) less a later call is what the capture adds. Then a profile of
    a graph epoch of ``profiled_steps`` steps (its idle share, device events
    a step, and the profiler's kernel counts against the wrappers'), and of
    one eager step with the card's capturable Adam (for ``mnist`` also with
    the CPU's plain one)."""
    name, bs, path = cfg.name, cfg.batch_size, train_path(cfg)
    batches = train_batches(n_steps, bs, "cuda", seed=1, config=cfg.dataset)
    runners, first, runs = first_epochs(cfg, batches)
    compared = graph_vs_eager(runs)
    emit({"phase": "train_graph_vs_eager", "config": name, "path": path, "steps": n_steps,
          "batch": bs, "cudnn": "default algorithms", "gated": gate, **compared})
    if gate and not max(compared["step_rel_max"], compared["param_rel_max"]) <= 1e-6:
        raise AssertionError(f"{name}: graph and eager epochs differ: {compared}")
    walls = {"graph": [], "eager": []}
    for _ in range(rounds):
        for kind, (runner, state) in runners.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = runner(state, batches)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
            if not torch.isfinite(metrics["loss"]).all():
                raise AssertionError(f"{name} train: a non-finite loss in a timed epoch")
    samples = n_steps * bs
    emit({"phase": "train_rate", "config": name, "path": path, "steps": n_steps, "batch": bs,
          "wall_s": walls, "samples_per_s": {k: [samples / w for w in v] for k, v in walls.items()},
          "first_call_wall_s": first,
          "first_call_samples_per_s": {k: samples / w for k, w in first.items()},
          "capture_added_s": first["graph"] - statistics.median(walls["graph"])})
    # The profile: replays of a graph of the same step over the first
    # ``profiled_steps`` batches (the profiler's cost grows with its events).
    _, state = runners["graph"]
    head = {k: v[:profiled_steps] for k, v in batches.items()}
    runner = make_epoch_runner(state.model, annealing_steps=1000,
                               generator=torch.Generator(device="cuda").manual_seed(2),
                               **api.step_options(cfg))
    runner(state, head)
    ops.set_backend("kernel")
    try:
        summary, seen = profile_counted(lambda: runner(state, head))
    finally:
        ops.set_backend("auto")
    busy = summary["device_busy_us"]
    per_step = busy / profiled_steps if busy != "not measured" else busy
    # The profiler's window carries its own cost (its first replay of a
    # graph under tracing): the epoch's idle share is also read from the
    # unprofiled graph epochs' walls against the profiled busy time a step.
    emit({"phase": "train_graph_profile", "config": name, "path": path, "steps": profiled_steps,
          "wrapper_launches": dict(kernels.LAUNCHES), "profiler_launches_by_attempt": seen,
          "device_busy_us_per_step": per_step,
          "device_events_per_step": summary["device_events"] / profiled_steps,
          "epoch_idle_share_unprofiled": (
              1 - per_step * n_steps / (1e6 * statistics.median(walls["graph"]))
              if busy != "not measured" else busy),
          **summary})
    step = make_train_step(state.model, annealing_steps=1000,
                           generator=torch.Generator(device="cuda").manual_seed(2),
                           **api.step_options(cfg))
    batch = {k: v[0] for k, v in batches.items()}
    step(state, batch)
    emit({"phase": "train_step_profile", "config": name, "path": path, "adam": "capturable",
          **profile_summary(lambda: step(state, batch))})
    if path == "mnist_train":
        # The same eager step with the CPU's Adam (not capturable, its step
        # counts on the host): what the capturable form costs on the device.
        plain = dataclasses.replace(state, optimizer=torch.optim.Adam(
            state.model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8))
        step(plain, batch)
        emit({"phase": "train_step_profile", "config": name, "path": path, "adam": "plain",
              **profile_summary(lambda: step(plain, batch))})


def train_card_vs_cpu(cfg=None, n_steps: int = 3) -> None:
    """``n_steps`` of ``cfg``'s epoch runner (the ``mnist`` config's by
    default, its objective's loss, and its clipping, EMA, gradient
    accumulation and LR schedule) on the card (the graph runner, its
    kernels) and on the CPU (the eager loop) from the same seeded weights,
    noise and batches, each at rel 1e-4 (CPU and card matmuls round
    differently; the card's Adam is the capturable one): the loss and the
    raw gradients' global norm each step (Adam would hide a gradient off by
    a constant factor; the norm does not), and every parameter tensor
    after, both its difference against its own 2-norm and against the
    2-norm of its update over the run."""
    cfg = cfg or configs.get_config("mnist")
    bs, n_mod = cfg.batch_size, 2
    batches = train_batches(n_steps, bs, "cpu", seed=2, config=cfg.dataset)
    batches["eps"] = torch.randn((n_steps, n_terms(cfg, n_mod), bs, cfg.n_latents),
                                 generator=torch.Generator().manual_seed(3))
    init = dict(configs.build_model(cfg, seed=0, device="cpu").named_parameters())
    runs = {}
    for dev in ("cuda", "cpu"):
        model = configs.build_model(cfg, seed=0, device=dev)
        state = create_train_state(
            model, learning_rate(cfg, cfg.train_size // bs), grad_clip=cfg.grad_clip,
            ema_decay=cfg.ema_decay, accum_steps=cfg.accum_steps)
        runner = make_epoch_runner(model, annealing_steps=1000, **api.step_options(cfg))
        _, metrics = runner(state, {k: v.to(dev) for k, v in batches.items()})
        runs[dev] = (*run_metrics(metrics),
                     {k: p.detach().cpu() for k, p in model.named_parameters()})
    (card_l, card_g, card_p), (cpu_l, cpu_g, cpu_p) = runs["cuda"], runs["cpu"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l)]
    grad_norm_rel = [abs(a - b) / abs(b) for a, b in zip(card_g, cpu_g)]
    param_rel = {k: ((card_p[k] - w).norm() / w.norm()).item() for k, w in cpu_p.items()}
    update_rel = {k: ((card_p[k] - w).norm() / (w - init[k]).norm()).item()
                  for k, w in cpu_p.items()}
    emit({"phase": "train_card_vs_cpu", "config": cfg.name, "path": train_path(cfg),
          "steps": n_steps, "card": "graph runner", "cpu": "eager loop",
          "loss_card": card_l, "loss_cpu": cpu_l, "loss_rel": loss_rel,
          "grad_norm_card": card_g, "grad_norm_cpu": cpu_g, "grad_norm_rel": grad_norm_rel,
          "param_rel_max": max(param_rel.values()), "update_rel_max": max(update_rel.values()),
          "update_rel_top": sorted(update_rel.items(), key=lambda kv: -kv[1])[:3],
          "param_max_abs_err": max((card_p[k] - w).abs().max().item() for k, w in cpu_p.items())})
    worst = max(max(loss_rel), max(grad_norm_rel), max(param_rel.values()),
                max(update_rel.values()))
    if not worst <= 1e-4:
        raise AssertionError(
            f"{train_path(cfg)}: card and CPU differ: loss {loss_rel}, grad norm {grad_norm_rel}, "
            f"params {param_rel}, updates {update_rel}")


MULTIMNIST_TRAIN_SIZE = 2000  # one epoch of 20 steps of batch 100


# The loss knobs no named config sets, as the ``multimnist_knobs_train``
# path turns them on.
LOSS_KNOBS = dict(cross_recon_stopgrad=True, unimodal_align_weight=0.1, cycle_contrast_weight=1.0)


def phase_multimnist_train(knobs: dict | None = None) -> dict[str, int]:
    """``api.train`` of ``multimnist`` (cross-recon, the cycle term on both
    render forms, clipping at 500; with ``knobs``, ``LOSS_KNOBS`` on top)
    for one epoch at full width over a train split cut to 2,000 examples on
    the graph runners (the launch counts through the replays, and the
    profiler's); then the graph against the eager loop (``train_rate``), a
    profiled step and the card against the CPU over three steps, where the
    graph is gated against the eager loop on cuDNN's deterministic
    algorithms."""
    cfg = configs.get_config("multimnist").replace(
        epochs=1, train_size=MULTIMNIST_TRAIN_SIZE, **(knobs or {}))
    path = train_path(cfg)
    untrained = api.eval_elbo(cfg, model=configs.build_model(cfg, seed=0))
    result, launches, wall_s = train_counted(cfg)
    record = result.history[0]
    steps = MULTIMNIST_TRAIN_SIZE // cfg.batch_size
    emit({"phase": "train", "config": "multimnist", "path": path, "epochs": 1,
          "steps": result.state.step, "train_size": MULTIMNIST_TRAIN_SIZE,
          **{k: v for k, v in record.items() if k != "epoch"},
          "untrained_test_elbo": untrained, "api_train_wall_s": wall_s, "launches": launches})
    if result.state.step != steps or not all(map(math.isfinite, record.values())):
        raise AssertionError(f"{path}: {result.state.step} steps, history {record}")
    if not record["test_elbo"] < untrained:
        raise AssertionError(
            f"{path}: test ELBO {record['test_elbo']} not below the untrained {untrained}")
    # cuDNN's default algorithms may sum in another order run to run: the
    # gate is the deterministic run of multimnist_card_vs_cpu.
    train_rate(cfg, steps, rounds=1, profiled_steps=5, gate=False)
    multimnist_card_vs_cpu(cfg)
    return launches


def compare_runs(run_a, run_b, init: dict) -> dict:
    """Two runs' losses, raw gradient norms and parameters (``run_metrics``
    and a name -> tensor dict on the CPU each), the second the reference,
    from the parameters ``init``: the relative errors the card-vs-CPU gates
    read, the three parameters with the largest update error, and whether
    every bit is equal."""
    (l_a, g_a, p_a), (l_b, g_b, p_b) = run_a, run_b
    update_rel = {k: ((p_a[k] - w).norm() / (w - init[k]).norm()).item()
                  for k, w in p_b.items()}
    return {"loss_rel": [abs(a - b) / abs(b) for a, b in zip(l_a, l_b)],
            "grad_norm_rel": [abs(a - b) / abs(b) for a, b in zip(g_a, g_b)],
            "param_rel_max": max(((p_a[k] - w).norm() / w.norm()).item()
                                 for k, w in p_b.items()),
            "update_rel_max": max(update_rel.values()),
            "update_rel_top": sorted(update_rel.items(), key=lambda kv: -kv[1])[:3],
            "param_max_abs_err": max((p_a[k] - w).abs().max().item()
                                     for k, w in p_b.items()),
            "bits_equal": l_a == l_b and g_a == g_b
            and all(torch.equal(p_a[k], w) for k, w in p_b.items())}


def multimnist_card_vs_cpu(cfg, n_steps: int = 3, bs: int = 20) -> None:
    """``n_steps`` of the ``multimnist`` step at full width and batch
    ``bs`` on the card (its kernels) and on the CPU from the same seeded
    weights, noise and batches, under ``train_card_vs_cpu``'s gates (rel
    1e-4). The card runs cuDNN's deterministic algorithms, and the CPU
    thresholds the cycle's render with the card's own 0/1 mask (as the
    noise is fed in): a render pixel within rounding of 0.5 cannot land on
    different sides, and the reading is the same in every run. The card's
    render is read from an eager run (a graph cannot hand the host its
    renders); the gated card run is the graph runner, itself gated against
    that eager run at rel 1e-6 (graph against eager over the MultiMNIST
    steps). Reported beside the gates: the parameters with the largest
    update error, the render pixels the CPU's own threshold would have put
    on the other side and the smallest |soft - 0.5|; and two controls, a
    repeat of the eager card run and a card run on cuDNN's default
    algorithms (those ``api.train`` takes), each against the gated card
    run and the CPU."""
    from mmvae_torch.train import step as step_module

    batches = train_batches(n_steps, bs, "cpu", seed=2, config="multimnist")
    batches["eps"] = torch.randn((n_steps, n_terms(cfg, 2), bs, cfg.n_latents),
                                 generator=torch.Generator().manual_seed(3))
    init = dict(configs.build_model(cfg, seed=0, device="cpu").named_parameters())
    straight_through = step_module._straight_through

    def run(dev: str, deterministic: bool, renders: list | None = None, fed=None,
            graph: bool = False):
        """Losses, raw gradient norms and parameters after ``n_steps``; the
        soft renders go to ``renders``; ``fed`` (soft renders) sets the
        0/1 mask of each step's threshold."""
        masks = iter(fed) if fed is not None else None

        def binarize(p):
            if renders is not None:
                renders.append(p.detach().cpu())
            if masks is None:
                return straight_through(p)
            hard = (next(masks) > 0.5).to(device=p.device, dtype=p.dtype)
            return p + (hard - p).detach()

        step_module._straight_through = binarize
        torch.backends.cudnn.deterministic = deterministic
        try:
            model = configs.build_model(cfg, seed=0, device=dev)
            state = create_train_state(model, cfg.learning_rate, grad_clip=cfg.grad_clip)
            runner = make_epoch_runner(model, graph=graph, annealing_steps=1000,
                                       **api.step_options(cfg))
            _, metrics = runner(state, {k: v.to(dev) for k, v in batches.items()})
        finally:
            step_module._straight_through = straight_through
            torch.backends.cudnn.deterministic = False
        return (*run_metrics(metrics),
                {k: p.detach().cpu() for k, p in model.named_parameters()})

    def compare(run_a, run_b) -> dict:
        return compare_runs(run_a, run_b, init)

    card_renders, cpu_renders = [], []
    eager = run("cuda", True, card_renders)
    card = run("cuda", True, graph=True)
    repeat = run("cuda", True)
    default = run("cuda", False)
    cpu = run("cpu", False, cpu_renders, fed=card_renders)
    graph_eager = compare(card, eager)
    path = train_path(cfg)
    emit({"phase": "train_graph_vs_eager", "config": "multimnist", "path": path,
          "steps": n_steps, "batch": bs, "cudnn": "deterministic algorithms", "gated": True,
          **graph_eager})
    if not max(max(graph_eager["loss_rel"]), max(graph_eager["grad_norm_rel"]),
               graph_eager["param_rel_max"]) <= 1e-6:
        raise AssertionError(f"{path}: graph and eager steps differ: {graph_eager}")
    gated = compare(card, cpu)
    flips = [int(((a > 0.5) != (b > 0.5)).sum()) for a, b in zip(card_renders, cpu_renders)]
    margins = [(b - 0.5).abs().min().item() for b in cpu_renders]
    emit({"phase": "train_card_vs_cpu", "config": "multimnist", "path": path,
          "steps": n_steps, "batch": bs, "card": "graph runner", "cpu": "eager loop",
          "loss_card": card[0], "loss_cpu": cpu[0], "grad_norm_card": card[1],
          "grad_norm_cpu": cpu[1], **gated,
          "render_pixels": cpu_renders[0].numel(), "render_flips": flips,
          "render_min_abs_soft_minus_half": margins,
          "control_repeat_vs_card": compare(repeat, card),
          "control_default_vs_card": compare(default, card),
          "control_default_vs_cpu": compare(default, cpu)})
    worst = max(max(gated["loss_rel"]), max(gated["grad_norm_rel"]), gated["param_rel_max"],
                gated["update_rel_max"])
    if not worst <= 1e-4:
        raise AssertionError(
            f"{path}: card and CPU differ: {gated}, render flips {flips}")


CELEBA_TRAIN_SIZE = 1280  # one epoch of 20 steps of batch 64
CUB_TRAIN_SIZE = 1280  # one epoch of 20 steps of batch 64


@contextlib.contextmanager
def deterministic(on: bool = True):
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations (``torch.use_deterministic_algorithms``, warning where
    an op has none): the caption embedding's gradient is summed with
    atomics otherwise, and CUB's steps then differ run to run in its
    last bits."""
    saved = torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled()
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1])


def train_phase(cfg, profiled_steps: int) -> tuple[dict[str, int], int]:
    """``api.train`` of ``cfg`` (one epoch) on the graph runners with the
    launch counts through the replays, its first-epoch test ELBO gated
    below the untrained model's, and the epoch's graph against its eager
    loop on deterministic algorithms (``deterministic``; gated at rel 1e-6:
    cuDNN's default algorithms may sum in another order run to run), the masks,
    noise and dropout drawn inside the steps; then both on cuDNN's default
    algorithms timed in turns and profiled (``train_rate``). Returns the
    counts and the steps of an epoch."""
    path = train_path(cfg)
    untrained = api.eval_elbo(cfg, model=configs.build_model(cfg, seed=0))
    result, launches, wall_s = train_counted(cfg)
    record = result.history[0]
    steps = cfg.train_size // cfg.batch_size
    emit({"phase": "train", "config": cfg.name, "path": path, "objective": cfg.objective,
          "epochs": 1, "steps": result.state.step,
          "train_size": cfg.train_size, "n_random_subsets": cfg.n_random_subsets,
          **{k: v for k, v in record.items() if k != "epoch"},
          "untrained_test_elbo": untrained, "api_train_wall_s": wall_s, "launches": launches})
    if result.state.step != steps or not all(map(math.isfinite, record.values())):
        raise AssertionError(f"{path}: {result.state.step} steps, history {record}")
    if not record["test_elbo"] < untrained:
        raise AssertionError(
            f"{path}: test ELBO {record['test_elbo']} not below the untrained {untrained}")
    batches = train_batches(steps, cfg.batch_size, "cuda", seed=1, config=cfg.dataset)
    with deterministic():
        _, _, runs = first_epochs(cfg, batches)
    compared = graph_vs_eager(runs)
    emit({"phase": "train_graph_vs_eager", "config": cfg.name, "path": path, "steps": steps,
          "batch": cfg.batch_size, "cudnn": "deterministic algorithms, cuDNN and torch",
          "gated": True, **compared})
    if not max(compared["step_rel_max"], compared["param_rel_max"]) <= 1e-6:
        raise AssertionError(f"{path}: graph and eager epochs differ: {compared}")
    train_rate(cfg, steps, rounds=1, profiled_steps=profiled_steps, gate=False)
    return launches, steps


def phase_celeba_train() -> dict[str, int]:
    """``api.train`` of ``celeba`` (4 random subsets, T = 24, clipping at
    500; K4 and its backward kernel in stage 0) for one epoch at full width
    over a train split cut to 1,280 examples (``train_phase``), then the
    card against the CPU over three steps."""
    cfg = configs.get_config("celeba").replace(epochs=1, train_size=CELEBA_TRAIN_SIZE)
    launches, _ = train_phase(cfg, profiled_steps=10)
    conv_card_vs_cpu(cfg)
    return launches


def phase_cub_train() -> dict[str, int]:
    """``api.train`` of ``cub`` (cross-recon, the cycle term at weight 0.1
    on the soft render, its image decoder live on the render; K4 on the
    encode and on the cycle's re-encode, its backward twice and its input
    gradient once a step) for one epoch at full width over a train split
    cut to 1,280 examples (``train_phase``); the step's caption experts
    (the GRUs) timed alone (``gru_step_ms``); then the card against the CPU
    over three steps."""
    cfg = configs.get_config("cub").replace(epochs=1, train_size=CUB_TRAIN_SIZE)
    launches, _ = train_phase(cfg, profiled_steps=10)
    model = configs.build_model(cfg, seed=0)
    batch = {k: v[0] for k, v in train_batches(1, cfg.batch_size, "cuda", config="cub").items()}
    emit({"phase": "train_gru", "config": "cub", "batch": cfg.batch_size,
          "gru_device_ms_per_step": gru_step_ms(model, batch, terms=3)})
    conv_card_vs_cpu(cfg, feed_tail=True)
    return launches


def phase_fashionmnist_train() -> dict[str, int]:
    """``api.train`` of ``fashionmnist`` for one epoch at full width (100
    steps of batch 100 over the 10,000-example train split; the grayscale
    convs on cuDNN), under ``mnist``'s gates (``train_phase``), then the
    card against the CPU over three steps at batch 100."""
    cfg = configs.get_config("fashionmnist").replace(epochs=1)
    launches, _ = train_phase(cfg, profiled_steps=20)
    conv_card_vs_cpu(cfg, bs=100, feed_tail=True)
    return launches


def phase_mixture_train() -> dict[str, dict[str, int]]:
    """``mnist`` at full width under each mixture objective (mmvae, mopoe,
    mvtcae): ``api.train`` for one epoch (100 steps of batch 100, then the
    test ELBO) on the graph runners under ``mnist``'s gates
    (``train_phase``: the counts through the replays, the graph against the
    eager loop at rel 1e-6 on deterministic algorithms, both timed and
    profiled); ``eval_elbo`` over the 2,000-example test split and
    ``generate`` from the image alone and from the label alone, each as
    the mixture's mean and as a draw (``drive``: the counts, the ``torch``
    backend at rel 1e-5), the eval and the mean's generate on the card
    against the CPU (``card_vs_cpu``); three steps on the card against the
    CPU's eager loop, the noise passed in (``train_card_vs_cpu``)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    data = load_dataset("mnist", "test", n=3).arrays
    conditions = {"image": {"image": data["image"]}, "label": {"label": data["label"]}}
    out = {}
    for objective in MIXTURE_OBJECTIVES:
        cfg = configs.get_config("mnist").replace(epochs=1, objective=objective)
        out[train_path(cfg)], _ = train_phase(cfg, profiled_steps=20)
        calls = {f"from_{key}_{'draw' if draw else 'mean'}":
                 lambda m, c=c, draw=draw: api.generate(cfg, c, model=m, sample_z=draw,
                                                        generator=gen)
                 for key, c in conditions.items() for draw in (False, True)}
        outs, launches = drive(cfg, calls)
        path = f"mnist_{objective}"
        if launches != EXPECTED_LAUNCHES[path]:
            raise AssertionError(
                f"{path}: expected launches {EXPECTED_LAUNCHES[path]}, got {launches}")
        for name, generated in outs.items():
            check_image(generated["image"], 3, (28, 28))
            if not (generated["label"].min() >= 0 and generated["label"].max() < 10):
                raise AssertionError(f"{path} {name}: generated label out of range")
        out[path] = launches
        card_vs_cpu(cfg, 250, conditions["label"], outs["from_label_mean"])
        train_card_vs_cpu(cfg)
    return out


def phase_celeba_mopoe_train() -> dict[str, dict[str, int]]:
    """``celeba`` at full width under mopoe (no random subsets; 19
    modalities fall back to the 20 terms of the joint and the unimodal
    rows, every key decoded on all of them): ``api.train`` for one epoch
    over a train split cut to 1,280 examples (20 steps of 64, then the
    2,000-example test ELBO) under ``celeba_train``'s gates
    (``train_phase``: the counts, graph against eager at rel 1e-6 on
    deterministic algorithms, timed in turns, a profiled epoch and step
    with their kernel families); ``eval_elbo`` and ``generate`` from the
    attributes alone (``drive``); three steps at batch 16 on the card
    against the CPU, the noise passed in (``conv_card_vs_cpu``)."""
    cfg = configs.get_config("celeba").replace(
        epochs=1, train_size=CELEBA_TRAIN_SIZE, objective="mopoe", n_random_subsets=0)
    launches, _ = train_phase(cfg, profiled_steps=10)
    attrs = {"attrs": load_dataset("celeba", "test", n=3).arrays["attrs"]}
    outs, ev = drive(cfg, {"from_attrs": lambda m: api.generate(cfg, attrs, model=m)})
    if ev != EXPECTED_LAUNCHES["celeba_mopoe"]:
        raise AssertionError(
            f"celeba_mopoe: expected launches {EXPECTED_LAUNCHES['celeba_mopoe']}, got {ev}")
    check_image(outs["from_attrs"]["image"], 3, (64, 64, 3))
    check_probs(outs["from_attrs"]["attrs"], (3, 18))
    conv_card_vs_cpu(cfg)
    return {"celeba_mopoe_train": launches, "celeba_mopoe": ev}


def gru_step_ms(model, batch: dict, terms: int) -> float:
    """Device time of the caption experts' work in one CUB train step,
    forward and backward, graph-replayed: the encoder on the batch's
    captions twice (the encode and the cycle's re-encode), the decoder
    teacher-forced on the decode-all pass's ``terms`` x B rows and on the
    cycle's read-back of B, each gradient in the experts' weights and the
    decoders' latent inputs taken."""
    text = batch["text"]
    b = text.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(4)
    z_all = torch.randn(terms * b, model.n_latents, generator=gen, device="cuda")
    z_one = torch.randn(b, model.n_latents, generator=gen, device="cuda")
    tiled = kernels.tile_rows(text, terms * b, kernels.FOLD_T)
    weights = [*model.text_enc.parameters(), *model.text_dec.parameters()]

    def call():
        leaves = (z_all.requires_grad_(True), z_one.requires_grad_(True))
        outs = (*model.text_enc(text), *model.text_enc(text),
                model.text_dec(leaves[0], tiled), model.text_dec(leaves[1], text))
        torch.autograd.grad(sum(o.sum() for o in outs), [*leaves, *weights])

    return device_ms(call, inner=3)


# Adam's eps (``create_train_state``); a gradient component below 9 eps has
# not saturated Adam's normalisation g / (|g| + eps) (its first update is
# under 0.9 lr), so its update follows the bits of a gradient at rounding
# level: ``conv_card_vs_cpu`` feeds the card's value of a component that
# both the card and the CPU compute below it to the CPU.
ADAM_EPS = 1e-8
TAIL_BELOW = 9 * ADAM_EPS
# The share of the CPU's own count of such components that may sit below
# TAIL_BELOW on one side only: components that straddle the threshold, as
# the two runs' parameters part at rounding level over the steps (2.2% at
# CUB's third step on an H100). Such a component is not fed, so the update
# gate reads it as it would unfed; a zeroed or unwritten gradient slice
# puts thousands there.
TAIL_SLACK = 0.05


def conv_card_vs_cpu(cfg, n_steps: int = 3, bs: int = 16, feed_tail: bool = False,
                     term_fold: str = "t", path: str | None = None, draw: str | None = None,
                     gate: bool = True) -> None:
    """``n_steps`` of ``cfg``'s step at full width and batch ``bs`` on the
    card (the graph runner, its kernels) and on the CPU (the eager loop)
    from the same seeded weights, batches, random subset masks (where the
    config draws them) and noise (passed in), under ``train_card_vs_cpu``'s
    gates (rel 1e-4). The card runs deterministic algorithms
    (``deterministic``), so the reading repeats. Reported beside the gates:
    the parameters with the largest update error and, for the worst, how many of its components
    differ by more than half the learning rate (Adam's sign of a gradient
    component at its rounding level), the share of its squared error in its
    1% largest differences, and the CPU's median update there and over the
    tensor (whether small or large components carry the error).

    ``feed_tail``: the gradient components that both the card and the CPU
    compute below TAIL_BELOW (CUB's and FashionMNIST's encoder heads hold
    whole rows of them at the first step, where beta is 0 and a latent
    dimension's fused variance is tiny: their f32 bits differ between any
    two summation orders, and Adam's normalisation turns that into up to
    0.1 lr) take the card's value in the CPU's Adam, from an eager card run,
    as the card's render mask is handed to the CPU for MultiMNIST; the graph
    runner is gated against that eager run at rel 1e-6. A component below
    TAIL_BELOW on one side only keeps the CPU's own value, and each step's
    count of such components, on either side, is gated at TAIL_SLACK of the
    CPU's own count below TAIL_BELOW: a card gradient that comes out tiny
    where the CPU's is not (a zeroed or unwritten slice) fails that gate as
    well as the update gate. Reported: the counts each step and, ungated,
    the reading without feeding.

    ``term_fold`` is the steps' fold, ``draw`` the fold whose layout the
    noise is drawn in (``(T, B, L)`` for "t", ``(B, T, L)`` for "b"; the
    fold's own by default), handed over in the steps' layout, and ``path``
    the label of the result line (``train_path(cfg)`` by default).
    ``gate=False`` reads and reports without raising."""
    path = path or train_path(cfg)
    n_mod, k = configs.build_model(cfg, seed=0, device="cpu").n_modalities, cfg.n_random_subsets
    batches = train_batches(n_steps, bs, "cpu", seed=2, config=cfg.dataset)
    gen = torch.Generator().manual_seed(3)
    if k:
        batches["subset_masks"] = (torch.rand((n_steps, k, n_mod), generator=gen) < 0.5).float()
    t_major = (draw or term_fold) == "t"
    eps = torch.randn((n_steps, *((n_terms(cfg, n_mod), bs) if t_major
                                  else (bs, n_terms(cfg, n_mod))), cfg.n_latents), generator=gen)
    if t_major != (term_fold == "t"):  # the same draws in the steps' layout
        eps = eps.transpose(1, 2).contiguous()
    batches["eps"] = eps
    init = dict(configs.build_model(cfg, seed=0, device="cpu").named_parameters())

    def run(dev: str, graph: bool, record: list | None = None, fed: list | None = None,
            counts: list | None = None):
        """Losses, raw gradient norms and parameters after ``n_steps``;
        each step's gradients go to ``record``; ``fed`` (per step, the
        card's gradients) sets the components below TAIL_BELOW on both
        sides, and each step's tail counts go to ``counts``."""
        with deterministic(dev == "cuda"):
            model = configs.build_model(cfg, seed=0, device=dev)
            state = create_train_state(model, cfg.learning_rate, grad_clip=cfg.grad_clip)
            apply = state.apply_gradients
            steps = iter(fed) if fed is not None else None

            def apply_gradients(commit=None):
                named = list(model.named_parameters())
                if record is not None:
                    record.append({n: p.grad.detach().cpu().clone() for n, p in named})
                if steps is not None:
                    card, tally = next(steps), dict.fromkeys(("card", "cpu", "fed"), 0)
                    # The largest |g| the other side gives a component below
                    # TAIL_BELOW on one side only.
                    tally.update(card_only_cpu_abs_max=0.0, cpu_only_card_abs_max=0.0)
                    for n, p in named:
                        on_card, on_cpu = card[n].abs() < TAIL_BELOW, p.grad.abs() < TAIL_BELOW
                        both = on_card & on_cpu
                        for key, mask in (("card", on_card), ("cpu", on_cpu), ("fed", both)):
                            tally[key] += int(mask.sum())
                        for key, mask, other in (("card_only_cpu_abs_max", on_card & ~on_cpu, p.grad),
                                                 ("cpu_only_card_abs_max", on_cpu & ~on_card, card[n])):
                            if mask.any():
                                tally[key] = max(tally[key], other[mask].abs().max().item())
                        p.grad[both] = card[n][both]
                    counts.append(tally)
                apply(commit)

            # The hook is the state's attribute only for this run: it holds
            # the state, and left in place the two would form a cycle.
            state.apply_gradients = apply_gradients
            try:
                runner = make_epoch_runner(model, graph=graph, annealing_steps=1000,
                                           term_fold=term_fold, **api.step_options(cfg))
                _, metrics = runner(state, {k: v.to(dev) for k, v in batches.items()})
            finally:
                del state.apply_gradients
        return (*run_metrics(metrics), {k: p.detach().cpu() for k, p in model.named_parameters()})

    card_grads = []
    card = run("cuda", graph=True)
    extra = {}
    if feed_tail:
        eager = run("cuda", graph=False, record=card_grads)
        graph_eager = compare_runs(card, eager, init)
        emit({"phase": "train_graph_vs_eager", "config": cfg.name, "path": path,
              "steps": n_steps, "batch": bs, "cudnn": "deterministic algorithms, cuDNN and torch",
              "gated": gate, **graph_eager})
        if gate and not max(max(graph_eager["loss_rel"]), max(graph_eager["grad_norm_rel"]),
                            graph_eager["param_rel_max"]) <= 1e-6:
            raise AssertionError(f"{path}: graph and eager steps differ: {graph_eager}")
        extra = {"tail_below": TAIL_BELOW,
                 "unfed_control": compare_runs(card, run("cpu", graph=False), init)}
    counts = []
    cpu = run("cpu", graph=False, fed=card_grads if feed_tail else None, counts=counts)
    gated = compare_runs(card, cpu, init)
    worst = gated["update_rel_top"][0][0]
    diff = (card[2][worst] - cpu[2][worst]).abs().flatten()
    update = (cpu[2][worst] - init[worst].detach()).abs().flatten()
    top = diff.argsort(descending=True)[: max(1, diff.numel() // 100)]
    conv0 = "image_enc.convs.0.weight"  # K4's weight on RGB: conv4x4s2_swish_bwd's gradient
    emit({"phase": "train_card_vs_cpu", "config": cfg.name, "path": path,
          "steps": n_steps, "batch": bs, "term_fold": term_fold, "draw": draw or term_fold,
          "gated": gate,
          "card": "graph runner", "cpu": "eager loop", "loss_card": card[0], "loss_cpu": cpu[0],
          "grad_norm_card": card[1], "grad_norm_cpu": cpu[1], **gated, **extra,
          "tail_counts_per_step": counts,
          "update_rel_conv0_weight": ((card[2][conv0] - cpu[2][conv0]).norm()
                                      / (cpu[2][conv0] - init[conv0].detach()).norm()).item(),
          "worst_tensor": {
              "name": worst, "numel": diff.numel(), "max_abs_diff": diff.max().item(),
              "components_over_half_lr": int((diff > 0.5 * cfg.learning_rate).sum()),
              "top_1pct_share_of_squared_error": ((diff[top] ** 2).sum() / (diff ** 2).sum()).item(),
              "update_median_at_top_1pct": update[top].median().item(),
              "update_median": update.median().item()}})
    if not gate:
        return
    if not max(max(gated["loss_rel"]), max(gated["grad_norm_rel"]), gated["param_rel_max"],
               gated["update_rel_max"]) <= 1e-4:
        raise AssertionError(f"{path}: card and CPU differ: {gated}")
    for i, tally in enumerate(counts):
        one_side = max(tally["card"], tally["cpu"]) - tally["fed"]
        if not one_side <= TAIL_SLACK * tally["cpu"]:
            raise AssertionError(
                f"{cfg.name} train step {i}: {tally['card'] - tally['fed']} gradient components "
                f"below {TAIL_BELOW} on the card only, {tally['cpu'] - tally['fed']} on the CPU "
                f"only, against the CPU's {tally['cpu']}: {counts}")


def phase_workdir() -> None:
    """``mnist`` at full width over a train split cut to 2,000 (20 steps an
    epoch) trained into a workdir for 2 epochs and resumed for a third,
    against an uninterrupted 3-epoch run (each epoch's train loss and test
    ELBO, and every parameter, rel 1e-6 on the card); ``eval_elbo`` from
    the workdir against the best epoch's recorded test ELBO (rel 1e-6);
    ``generate`` and ``sample`` from it; ``metrics.jsonl`` holding 3 eval
    records and exactly the train records the JAX loop writes."""
    cfg = configs.get_config("mnist").replace(epochs=3, train_size=2000)
    with tempfile.TemporaryDirectory() as tmp:
        full = api.train(cfg, f"{tmp}/full", seed=0, verbose=False)
        first = api.train(cfg.replace(epochs=2), f"{tmp}/split", seed=0, verbose=False)
        resumed = api.train(cfg, f"{tmp}/split", seed=0, verbose=False, resume=True)
        history = first.history + resumed.history
        if [r["epoch"] for r in resumed.history] != [3]:
            raise AssertionError(f"resume ran epochs {[r['epoch'] for r in resumed.history]}")
        history_rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(history, full.history)
                          for k in ("train_loss", "test_elbo"))
        param_rel = max(((a - b).norm() / b.norm()).item() for a, b in
                        zip(resumed.model.parameters(), full.model.parameters()))
        best = min(r["test_elbo"] for r in history)
        elbo = api.eval_elbo("mnist", workdir=f"{tmp}/split")
        elbo_rel = abs(elbo - best) / abs(best)
        gen = api.generate("mnist", {"label": [3, 5, 7]}, workdir=f"{tmp}/split")
        smp = api.sample("mnist", n=16, workdir=f"{tmp}/split",
                         generator=torch.Generator(device="cuda").manual_seed(0))
        listing = sorted(os.listdir(f"{tmp}/split/ckpt"))
        # By kind: an eval record an epoch, and the train records the JAX
        # loop writes (one every log_interval = 100 steps of each epoch of
        # 20: its first step).
        got = records(f"{tmp}/split")
    n_records = {kind: len(v) for kind, v in got.items()}
    train_records = [(r["epoch"], r["step"]) for r in got["train"]]
    want_train = jax_train_records([(e, 20 * (e - 1)) for e in (1, 2, 3)], 20, cfg.log_interval)
    emit({"phase": "workdir", "config": "mnist", "history": history,
          "uninterrupted_history": full.history, "history_rel_max": history_rel,
          "param_rel_max": param_rel, "eval_elbo_workdir": elbo, "best_test_elbo": best,
          "eval_elbo_rel": elbo_rel, "ckpt": listing, "metrics_records": n_records,
          "train_records": train_records})
    if not (history_rel <= 1e-6 and param_rel <= 1e-6 and elbo_rel <= 1e-6
            and n_records["eval"] == 3 and n_records["event"] == 0
            and train_records == want_train and resumed.best_test_elbo == best):
        raise AssertionError(f"workdir: resumed run, workdir eval or records differ: history "
                             f"{history_rel}, params {param_rel}, eval {elbo_rel}, records "
                             f"{n_records} {train_records} (the JAX loop's {want_train})")
    for out, n in ((gen, 3), (smp, 16)):
        check_image(out["image"], n, (28, 28))
        if not (out["label"].min() >= 0 and out["label"].max() < 10):
            raise AssertionError("generated label out of range")


# The training extras' MNIST run: 20 micro-steps an epoch, an update of 3
# straddling each epoch boundary (20 % 3 = 2), the cosine schedule warming
# up over the first epoch, clipping and the EMA on, a train record every 5
# steps.
EXTRAS = dict(train_size=2000, epochs=3, accum_steps=3, lr_schedule="cosine", warmup_epochs=1,
              grad_clip=1.0, ema_decay=0.999, log_interval=5)
CELEBA_ACCUM = 2


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item() if b.norm() > 0 else (a - b).norm().item()


def state_tensors(state) -> dict[str, torch.Tensor]:
    """Every tensor of a train state by name: the parameters, the EMA
    shadow, the running mean, Adam's moments and counts, a scheduled
    rate."""
    out = {f"param {n}": p for n, p in state.model.named_parameters()}
    if state.ema_model is not None:
        out.update({f"ema {n}": p for n, p in state.ema_model.named_parameters()})
    out.update({f"acc {i}": a for i, a in enumerate(state.acc_grads or [])})
    for i, p in enumerate(state.model.parameters()):
        out.update({f"adam {i} {k}": v for k, v in state.optimizer.state.get(p, {}).items()})
    lr = state.optimizer.param_groups[0]["lr"]
    if torch.is_tensor(lr):
        out["lr"] = lr
    return out


def accum_graph_vs_eager(cfg, batches: dict, epochs: int) -> tuple[dict, dict, dict]:
    """``cfg``'s epoch runner (its accumulation, clipping, EMA and schedule
    over the split's steps) as replays and as the eager loop from the same
    seed-0 weights, generator seed and batches, ``epochs`` calls each, on
    deterministic algorithms: whether every metric, state tensor
    (``state_tensors``) and the noise generator's state are equal to the
    bit, the largest relative differences, and each run's launch counts."""
    n_steps = next(iter(batches.values())).shape[0]
    runs = {}
    ops.set_backend("kernel")
    try:
        with deterministic():
            for kind in ("graph", "eager"):
                model = configs.build_model(cfg, seed=0)
                state = create_train_state(
                    model, learning_rate(cfg, n_steps), grad_clip=cfg.grad_clip,
                    ema_decay=cfg.ema_decay, accum_steps=cfg.accum_steps)
                gen = torch.Generator(device="cuda").manual_seed(1)
                runner = make_epoch_runner(model, graph=kind == "graph", annealing_steps=1000,
                                           generator=gen, **api.step_options(cfg))
                for k in kernels.LAUNCHES:
                    kernels.LAUNCHES[k] = 0
                metrics = [runner(state, batches)[1] for _ in range(epochs)]
                torch.cuda.synchronize()
                runs[kind] = (state, metrics, dict(kernels.LAUNCHES), gen.get_state())
    finally:
        ops.set_backend("auto")
    (s_g, m_g, l_g, gen_g), (s_e, m_e, l_e, gen_e) = runs["graph"], runs["eager"]
    t_g, t_e = state_tensors(s_g), state_tensors(s_e)
    metric_pairs = [(a[k], b[k]) for a, b in zip(m_g, m_e) for k in b]
    compared = {
        "epochs": epochs, "steps_per_epoch": n_steps, "accum_steps": cfg.accum_steps,
        "micro_steps": s_g.step, "micro_step_at_end": s_g.micro_step,
        "metric_rel_max": max(_rel_err(a, b) for a, b in metric_pairs),
        "state_rel_max": max(_rel_err(t_g[k], t_e[k]) for k in t_e),
        "bits_equal": (t_g.keys() == t_e.keys() and torch.equal(gen_g, gen_e)
                       and all(torch.equal(a, b) for a, b in metric_pairs)
                       and all(torch.equal(t_g[k], t_e[k]) for k in t_e)),
        "launches_equal": l_g == l_e,
    }
    return compared, l_g, l_e


def accum_rate(cfg, n_steps: int, rounds: int, profiled_steps: int) -> dict:
    """Graph epochs of ``n_steps`` micro-steps of ``cfg`` with its
    ``accum_steps`` and with 1 (the plain step: the same clipping, EMA and
    schedule, an update a step), from the same weights and batches, timed
    in turns (samples/s and the wall a micro-step, host clock from a sync to
    a sync), and a profile of ``profiled_steps`` of each (device busy µs a
    micro-step)."""
    batches = train_batches(n_steps, cfg.batch_size, "cuda", seed=1, config=cfg.dataset)
    runners = {}
    for k in (cfg.accum_steps, 1):
        model = configs.build_model(cfg, seed=0)
        state = create_train_state(model, learning_rate(cfg, n_steps), grad_clip=cfg.grad_clip,
                                   ema_decay=cfg.ema_decay, accum_steps=k)
        runner = make_epoch_runner(model, annealing_steps=1000,
                                   generator=torch.Generator(device="cuda").manual_seed(1),
                                   **api.step_options(cfg))
        runner(state, batches)  # the first call captures
        runners[k] = (runner, state)
    walls = {k: [] for k in runners}
    for _ in range(rounds):
        for k, (runner, state) in runners.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner(state, batches)
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    busy = {}
    head = {key: v[:profiled_steps] for key, v in batches.items()}
    for k, (_, state) in runners.items():
        runner = make_epoch_runner(state.model, annealing_steps=1000,
                                   generator=torch.Generator(device="cuda").manual_seed(2),
                                   **api.step_options(cfg))
        runner(state, head)
        summary = profile_summary(lambda: runner(state, head))
        b = summary["device_busy_us"]
        busy[f"accum_{k}"] = b / profiled_steps if b != "not measured" else b
    samples = n_steps * cfg.batch_size
    return {"steps": n_steps, "batch": cfg.batch_size,
            "wall_s": {f"accum_{k}": w for k, w in walls.items()},
            "samples_per_s": {f"accum_{k}": [samples / x for x in w] for k, w in walls.items()},
            "wall_us_per_micro_step": {f"accum_{k}": [1e6 * x / n_steps for x in w]
                                       for k, w in walls.items()},
            "profiled_steps": profiled_steps, "device_busy_us_per_micro_step": busy}


@contextlib.contextmanager
def save_walls(walls: dict[str, list]):
    """The wall (host clock) each synchronous save and each stage of an
    overlapped one holds ``api.train``'s loop, appended to
    ``walls["sync"]`` and ``walls["stage"]``."""
    sync, stage = api.save_checkpoint, AsyncCheckpointWriter.stage

    def timed_sync(*args, **kw):
        t0 = time.perf_counter()
        sync(*args, **kw)
        walls["sync"].append(time.perf_counter() - t0)

    def timed_stage(self, *args, **kw):
        t0 = time.perf_counter()
        staged = stage(self, *args, **kw)
        walls["stage"].append(time.perf_counter() - t0)
        return staged

    api.save_checkpoint, AsyncCheckpointWriter.stage = timed_sync, timed_stage
    try:
        yield walls
    finally:
        api.save_checkpoint, AsyncCheckpointWriter.stage = sync, stage


def records(workdir: str) -> dict[str, list[dict]]:
    """``metrics.jsonl``'s records by kind."""
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    kinds = {r["kind"] for r in lines}
    if not kinds <= {"train", "eval", "event"}:
        raise AssertionError(f"{workdir}: unknown record kinds {kinds}")
    return {kind: [r for r in lines if r["kind"] == kind] for kind in ("train", "eval", "event")}


def jax_train_records(passes: list[tuple[int, int]], steps: int, log_interval: int) -> list:
    """The (epoch, step) of each train record the JAX loop writes for epoch
    passes ``(epoch, micro-steps before it)`` of ``steps`` steps each
    (``mmvae_tpu/api.py:803-840``: steps ``i`` = 0, ``log_interval``, ...,
    numbered ``base + i + 1``)."""
    return [(epoch, base + i + 1) for epoch, base in passes for i in range(0, steps, log_interval)]


def check_records(name: str, workdir: str, passes: list, evals: list[int], events: int) -> dict:
    """``workdir``'s records against the JAX loop's: the train records of
    ``passes`` exactly, the eval records of ``evals``, ``events`` events."""
    got = records(workdir)
    steps = EXTRAS["train_size"] // 100
    want_train = jax_train_records(passes, steps, EXTRAS["log_interval"])
    counts = {kind: len(v) for kind, v in got.items()}
    if ([(r["epoch"], r["step"]) for r in got["train"]] != want_train
            or [r["epoch"] for r in got["eval"]] != evals or counts["event"] != events):
        raise AssertionError(f"{name}: records {counts} ({[(r['epoch'], r['step']) for r in got['train']]}),"
                             f" the JAX loop's train {want_train}, evals {evals}, events {events}")
    return counts


def _poison(every: bool = False, at: int = 2):
    """A ``fault_hook`` that fills one parameter and its EMA shadow (which
    the test ELBO reads) with NaN after epoch ``at``'s train pass once (or
    after every epoch's)."""
    done = []

    def hook(epoch, state):
        if every or (epoch == at and not done):
            done.append(epoch)
            with torch.no_grad():
                next(state.model.parameters()).fill_(float("nan"))
                next(state.ema_model.parameters()).fill_(float("nan"))
        return state

    return hook


class _Preempted(Exception):
    pass


def _stop_after(last_epoch: int):
    def hook(epoch, state):
        if epoch > last_epoch:
            raise _Preempted
        return state

    return hook


class CliRuns(threading.Thread):
    """``python -m mmvae_torch.cli`` in processes of its own on the card,
    run from a thread while this process goes on: ``train`` of ``mnist``
    for 1 epoch over 2,000 examples into a workdir, then together ``eval``
    (the test and the train split), ``sample`` to a PNG and ``generate``
    from labels to an npz. The thread only waits for the processes (none
    outlives it); :meth:`check`, on the main thread, reads what they
    printed."""

    def __init__(self, tmp: str):
        super().__init__(daemon=True)
        self.tmp, self.wd = tmp, f"{tmp}/cli"
        self.out, self.error, self.walls = {}, None, {}

    def _start(self, *args):
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        return subprocess.Popen([sys.executable, "-m", "mmvae_torch.cli", *args], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)

    def _finish(self, procs: dict) -> None:
        try:
            for name, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=300)
                if proc.returncode != 0:
                    raise AssertionError(f"cli {name} exited {proc.returncode}: {stderr[-3000:]}")
                self.out[name] = json.loads(stdout.strip().splitlines()[-1])
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

    def run(self):
        t0 = time.perf_counter()
        try:
            self._finish({"train": self._start("train", "--config", "mnist", "--epochs", "1",
                                               "--train-size", "2000", "--workdir", self.wd)})
            self.walls["train_s"] = time.perf_counter() - t0
            wd = self.wd
            self._finish({
                "eval": self._start("eval", "--config", "mnist", "--workdir", wd),
                "eval_train": self._start("eval", "--config", "mnist", "--workdir", wd,
                                          "--split", "train"),
                "sample": self._start("sample", "--config", "mnist", "--workdir", wd, "--n", "16",
                                      "--out", f"{self.tmp}/samples.png"),
                "generate": self._start("generate", "--config", "mnist", "--workdir", wd,
                                        "--condition-on", "label=[3,5,7]",
                                        "--out", f"{self.tmp}/gen.npz"),
            })
            self.walls["all_s"] = time.perf_counter() - t0
        except BaseException as e:  # raised again by check, on the main thread
            self.error = e

    def check(self) -> dict:
        """Wait for the processes; each must have exited 0, and each eval
        equal ``api.eval_elbo`` of the same workdir and split (rel 1e-6)."""
        self.join()
        if self.error is not None:
            raise self.error
        out, wd = self.out, self.wd
        rel = {split: abs(out[name]["elbo"] - want) / abs(want)
               for split, name in (("test", "eval"), ("train", "eval_train"))
               for want in [api.eval_elbo("mnist", workdir=wd, split=split)]}
        with open(f"{self.tmp}/samples.png", "rb") as f:
            png = f.read(8) == b"\x89PNG\r\n\x1a\n"
        if not (max(rel.values()) <= 1e-6 and png and out["eval"]["split"] == "test"
                and out["eval_train"]["split"] == "train"
                and out["sample"]["shapes"]["image"] == [16, 28, 28]
                and out["generate"]["shapes"] == {"image": [3, 28, 28], "label": [3]}
                and math.isfinite(out["train"]["best_test_elbo"])):
            raise AssertionError(f"cli: {out}, eval rel {rel}, png header {png}")
        return {"cli_wall_s": self.walls, "eval_rel": rel, "outputs": out}


def phase_train_extras() -> dict[str, dict[str, int]]:
    """The training extras at full width (``EXTRAS``: ``mnist``, 3 epochs
    of 20 micro-steps, accum_steps 3, the cosine schedule, clipping, EMA,
    a train record every 5 steps). While the CLI runs in processes of its
    own (``CliRuns``), the untimed gates: graph against eager to the bit
    on deterministic algorithms (2 epochs, an update straddling the
    boundary; ``celeba`` with accum_steps 2 over 20 micro-steps of 64, and
    its launches); the card against the CPU over the first 6 micro-steps
    (2 updates, the first at rate 0; rel 1e-4); a run stopped after epoch
    2 and resumed; a NaN in one parameter and its EMA shadow after epoch 2
    rolled back to epoch 1 (``nan_rollback=2``), and a NaN after every
    epoch raising (``nan_rollback=1``). Then, the CLI checked, the timed
    runs alone on the card: ``api.train`` with its launches counted and
    each synchronous save's wall, the resumed run against it (rel 1e-6),
    ``ckpt_async`` against it to the bit (the history and the last
    checkpoint) with each stage's wall, every run's records against the
    JAX loop's, and samples/s and busy time against the plain step."""
    cfg = configs.get_config("mnist").replace(**EXTRAS)
    steps = EXTRAS["train_size"] // cfg.batch_size
    path = train_path(cfg)
    celeba = configs.get_config("celeba").replace(accum_steps=CELEBA_ACCUM,
                                                  train_size=CELEBA_TRAIN_SIZE)
    c_path, c_steps = train_path(celeba), CELEBA_TRAIN_SIZE // celeba.batch_size
    out, counts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        cli = CliRuns(tmp)
        cli.start()
        try:
            batches = train_batches(steps, cfg.batch_size, "cuda", seed=1, config="mnist")
            compared, _, _ = accum_graph_vs_eager(cfg, batches, epochs=2)
            emit({"phase": "train_graph_vs_eager", "config": "mnist", "path": path,
                  "cudnn": "deterministic algorithms, cuDNN and torch", "gated": True, **compared})
            if not (compared["bits_equal"] and compared["launches_equal"]):
                raise AssertionError(f"{path}: graph and eager epochs differ: {compared}")
            compared, graph_launches, eager_launches = accum_graph_vs_eager(
                celeba, train_batches(c_steps, celeba.batch_size, "cuda", seed=1,
                                      config="celeba"), 1)
            emit({"phase": "train_graph_vs_eager", "config": "celeba", "path": c_path,
                  "cudnn": "deterministic algorithms, cuDNN and torch", "gated": True,
                  "launches": graph_launches, **compared})
            if not compared["bits_equal"]:
                raise AssertionError(f"{c_path}: graph and eager epochs differ: {compared}")
            for kind, got in (("graph", graph_launches), ("eager", eager_launches)):
                if got != EXPECTED_LAUNCHES[c_path]:
                    raise AssertionError(f"{c_path} {kind}: expected launches "
                                         f"{EXPECTED_LAUNCHES[c_path]}, got {got}")
            out[c_path] = graph_launches
            train_card_vs_cpu(cfg, n_steps=6)

            with contextlib.suppress(_Preempted):
                api.train(cfg, f"{tmp}/split", seed=0, verbose=False, fault_hook=_stop_after(2))
            resumed = api.train(cfg, f"{tmp}/split", seed=0, verbose=False, resume=True)
            counts["resumed"] = check_records(
                "resumed", f"{tmp}/split", [(e, (e - 1) * steps) for e in (1, 2, 3)], [1, 2, 3], 0)
            rolled = api.train(cfg.replace(nan_rollback=2), f"{tmp}/rollback", seed=0,
                               verbose=False, fault_hook=_poison())
            (event,) = records(f"{tmp}/rollback")["event"]
            counts["rollback"] = check_records(
                "rollback", f"{tmp}/rollback", [(1, 0), (2, steps), (2, steps), (3, 2 * steps)],
                [1, 2, 3], 1)
            if not ((event["failed_epoch"], event["restored_epoch"], event["rollbacks"])
                    == (2, 1, 1) and [r["epoch"] for r in rolled.history] == [1, 2, 3]
                    and all(math.isfinite(r["test_elbo"]) for r in rolled.history)
                    and rolled.state.step == 3 * steps):
                raise AssertionError(f"{path}: rollback: event {event}, history {rolled.history}")
            try:
                api.train(cfg.replace(nan_rollback=1), f"{tmp}/spent", seed=0, verbose=False,
                          fault_hook=_poison(every=True))
                raise AssertionError(f"{path}: a NaN after every epoch did not raise")
            except RuntimeError as e:
                if "nan_rollback budget" not in str(e):
                    raise
            counts["spent"] = {kind: len(v) for kind, v in records(f"{tmp}/spent").items()}
            if counts["spent"] != {"train": 2 * len(range(0, steps, EXTRAS["log_interval"])),
                                   "eval": 0, "event": 1}:
                raise AssertionError(f"{path}: the spent budget's records {counts['spent']}")
        finally:
            cli.join()
        emit({"phase": "train_extras_cli", **cli.check()})

        walls = {"sync": [], "stage": []}
        ops.set_backend("kernel")
        try:
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            with deterministic(), save_walls(walls):
                full = api.train(cfg, f"{tmp}/full", seed=0, verbose=False)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        finally:
            ops.set_backend("auto")
        if launches != EXPECTED_LAUNCHES[path]:
            raise AssertionError(
                f"{path}: expected launches {EXPECTED_LAUNCHES[path]}, got {launches}")
        out[path] = launches
        if not (full.state.step == 3 * steps and [r["epoch"] for r in full.history] == [1, 2, 3]
                and all(map(math.isfinite, (r[k] for r in full.history for k in r)))):
            raise AssertionError(f"{path}: {full.state.step} steps, history {full.history}")
        counts["full"] = check_records(
            "full", f"{tmp}/full", [(e, (e - 1) * steps) for e in (1, 2, 3)], [1, 2, 3], 0)
        split_evals = records(f"{tmp}/split")["eval"]
        resume_rel = max(
            [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(split_evals, full.history)
             for k in ("train_loss", "test_elbo")]
            + [_rel_err(a, b) for a, b in zip(resumed.model.parameters(), full.model.parameters())]
            + [_rel_err(a, b) for a, b in zip(resumed.state.acc_grads, full.state.acc_grads)])
        if not (resume_rel <= 1e-6 and [r["epoch"] for r in resumed.history] == [3]):
            raise AssertionError(f"{path}: the resumed run differs: rel {resume_rel}")
        sync_walls = list(walls["sync"])
        with deterministic(), save_walls(walls):
            overlapped = api.train(cfg.replace(ckpt_async=True), f"{tmp}/async", seed=0,
                                   verbose=False)
        trees = [torch.load(f"{tmp}/{d}/ckpt/last_00003/state.pt", weights_only=True)
                 for d in ("full", "async")]
        async_bits = (
            overlapped.history == full.history
            and all(torch.equal(t, trees[1][key][n]) for key in ("model", "ema_model")
                    for n, t in trees[0][key].items())
            and all(torch.equal(a, b) for a, b in zip(trees[0]["acc_grads"], trees[1]["acc_grads"])))
        async_evals = records(f"{tmp}/async")["eval"]
        counts["async"] = check_records(
            "async", f"{tmp}/async", [(e, (e - 1) * steps) for e in (1, 2, 3)], [1, 2, 3], 0)
        if not (async_bits and all("ckpt_saved" in r and "ckpt_skipped" in r for r in async_evals)):
            raise AssertionError(f"{path}: ckpt_async differs from the synchronous saves")
    emit({"phase": "train_extras", "config": "mnist", "path": path, **EXTRAS,
          "steps_per_epoch": steps, "history": full.history, "launches": launches,
          "resume_rel_max": resume_rel, "async_bits_equal": async_bits,
          "save_wall_s": {"sync": sync_walls, "stage": list(walls["stage"]),
                          "async_last_sync": walls["sync"][len(sync_walls):]},
          "ckpt_counts": {k: async_evals[-1][k] for k in ("ckpt_saved", "ckpt_skipped")},
          "rollback_event": {k: event[k] for k in ("failed_epoch", "restored_epoch", "rollbacks")},
          "rollback_history": rolled.history, "records": counts})
    emit({"phase": "train_accum_rate", "config": "mnist", "path": path,
          **accum_rate(cfg.replace(train_size=10000), 100, rounds=3, profiled_steps=21)})
    emit({"phase": "train_accum_rate", "config": "celeba", "path": c_path,
          **accum_rate(celeba, c_steps, rounds=2, profiled_steps=c_steps)})
    return out


# ------------------------------------------------------------ serving ----

SERVE_BATCH = 8
# (config, objective, the batch keys a request observes): each config at
# full width on seed-0 weights, and MNIST under mopoe.
SERVED = (("mnist", "mvae", ("label",)), ("fashionmnist", "mvae", ("image",)),
          ("multimnist", "mvae", ("text",)), ("celeba", "mvae", ("attrs",)),
          ("cub", "mvae", ("text",)), ("mnist", "mopoe", ("image",)))
DYNAMIC_SERVED = ("mnist", "celeba")
SERVE_REPS = 20


class OpOutputs(TorchDispatchMode):
    """The inputs and output of each ``mmvae`` op a call runs."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "mmvae":
            self.calls.append((str(func), args, out))
        return out


def check_op_outputs(calls) -> list[dict]:
    """Each ``mmvae`` op's output inside an artifact against its plain
    version on the same inputs, under ``phase_check``'s tolerances."""
    rows = []
    for name, args, out in calls:
        if name == "mmvae.conv4x4s2_swish.default":
            shape = (*args[0].shape, args[0].dtype)
            want = kernels.conv4x4s2_swish_torch(*args)
            rtol, atol = tolerance("conv", shape)
            torch.testing.assert_close(out, want, rtol=rtol, atol=atol)
            err = (out - want).abs().max().item()
        elif name == "mmvae.poe_kl.default":
            mu_e, _, masks, _ = args
            shape = (masks.shape[0], *mu_e.shape, "serve")
            err = check_poe_kl(args, out, kernels.poe_kl_torch(*args), shape)
        else:
            raise AssertionError(f"an artifact ran the unknown op {name}")
        rows.append({"op": name, "shape": [str(d) for d in shape], "max_abs_err": err})
    return rows


def serve_inputs(cfg, meta: dict, keys, n: int, seed: int = 0):
    """``n`` rows of ``cfg``'s synthetic test data observing ``keys``: the
    batch (zeros in the other keys), the presence and ``api.generate``'s
    condition."""
    data = load_dataset(cfg.dataset, "test", n=n + seed).arrays
    batch = {k: np.zeros([n, *shape[1:]], dtype) for k, (shape, dtype) in meta["batch_shapes"].items()}
    presence = np.zeros((n, len(meta["modalities"])), np.float32)
    for key in keys:
        batch[key] = np.asarray(data[key][seed:seed + n], batch[key].dtype)
        for m in meta["batch_modalities"][key]:
            presence[:, meta["modalities"].index(m)] = 1.0
    return batch, presence, {k: batch[k] for k in keys}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.to(got.device)
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def check_outputs(got: dict, want: dict, rtol: float, what: str) -> dict[str, float]:
    """Probabilities within ``rtol`` of the largest, labels and tokens
    equal. Returns each float output's relative error."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} and {sorted(want)} differ")
    errs = {}
    for k, w in want.items():
        if w.is_floating_point():
            errs[k] = rel_err(got[k], w)
            if not errs[k] <= rtol:
                raise AssertionError(f"{what}: {k} differs by rel {errs[k]} > {rtol}")
        elif not torch.equal(got[k].cpu(), w.cpu()):
            raise AssertionError(f"{what}: {k} differs")
    return errs


def call_ms(call, batch, presence, temperature: float = 0.0) -> dict[str, float]:
    """p50 and p90 of a call's wall, to a sync, over SERVE_REPS calls after 3."""
    seeds = np.arange(len(presence))
    walls = []
    for i in range(3 + SERVE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(batch, presence, seed=seeds, temperature=temperature)
        torch.cuda.synchronize()
        if i >= 3:
            walls.append(1e3 * (time.perf_counter() - t0))
    q = statistics.quantiles(walls, n=10)
    return {"p50": statistics.median(walls), "p90": q[-1]}


def coalesced_vs_alone(call, meta: dict, cfg, keys, gate: bool = True) -> dict:
    """Three requests of 1, 3 and 2 rows through one ``Batcher`` (one call)
    against each served alone, padded to the static batch, at temperature
    1, and each alone again: whether every output is equal to the bit,
    raised on when ``gate``. Returns the device calls and the two
    comparisons."""
    from mmvae_torch.serve import Batcher

    shapes = {k: (tuple(v[0]), np.dtype(v[1])) for k, v in meta["batch_shapes"].items()}
    requests = []
    for i, n in enumerate((1, 3, 2)):
        batch, presence, _ = serve_inputs(cfg, meta, keys, n, seed=4 * i)
        requests.append((batch, presence, 100 * i + np.arange(n)))
    batcher = Batcher(call, shapes, len(meta["modalities"]), static_batch=SERVE_BATCH,
                      max_wait_ms=500)
    results = [None] * len(requests)

    def submit(i):
        batch, presence, seeds = requests[i]
        results[i] = batcher.submit(batch, presence, seeds, 1.0, len(seeds))

    try:
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        if any(th.is_alive() for th in threads):
            raise AssertionError("a coalesced request did not return")
    finally:
        batcher.close(timeout=60)
    coalesced = repeated = True
    for (batch, presence, seeds), got in zip(requests, results):
        n = len(seeds)

        def pad(a, n=n):
            return np.concatenate([a, np.zeros((SERVE_BATCH - n,) + a.shape[1:], a.dtype)])

        alone, again = (call({k: pad(v) for k, v in batch.items()}, pad(presence),
                             seed=pad(seeds), temperature=1.0) for _ in range(2))
        for k, v in alone.items():
            coalesced &= np.array_equal(got[k], v[:n].cpu().numpy())
            repeated &= torch.equal(v, again[k])
    if gate and not coalesced:
        raise AssertionError(f"{cfg.name}: a coalesced request differs from it served alone")
    return {"device_calls": batcher.stats["device_calls"], "coalesced_bits_equal": coalesced,
            "alone_twice_bits_equal": repeated}


def http_round_trips(meta: dict, call, cfg, keys) -> dict:
    """The host (``serve.make_handler``, a ``Batcher``) on 127.0.0.1:0: one
    JSON and one npz request of the same row, their outputs equal; the
    JSON round trip of one row, p50 over SERVE_REPS."""
    import http.client
    import io
    from http.server import ThreadingHTTPServer

    from mmvae_torch.serve import Batcher, make_handler

    shapes = {k: (tuple(v[0]), np.dtype(v[1])) for k, v in meta["batch_shapes"].items()}
    batcher = Batcher(call, shapes, len(meta["modalities"]), static_batch=SERVE_BATCH,
                      max_wait_ms=1)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(meta, call, batcher))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    batch, _, condition = serve_inputs(cfg, meta, keys, 1)

    def post(body: bytes):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        try:
            conn.request("POST", "/generate", body=body)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise AssertionError(f"{cfg.name}: the host answered {resp.status}: {data[:200]}")
            return data
        finally:
            conn.close()

    try:
        body = json.dumps({"condition": {k: v.tolist() for k, v in condition.items()},
                           "seed": 7, "temperature": 1.0}).encode()
        reply = json.loads(post(body))["outputs"]
        buf = io.BytesIO()
        np.savez(buf, seed=np.int64(7), temperature=np.float32(1.0), **condition)
        with np.load(io.BytesIO(post(buf.getvalue()))) as z:
            npz = {k: z[k] for k in z.files if k != "n"}
        for k, v in npz.items():
            if not np.array_equal(np.asarray(reply[k], v.dtype), v):
                raise AssertionError(f"{cfg.name}: the JSON and npz replies differ in {k}")
        walls = []
        for _ in range(SERVE_REPS):
            t0 = time.perf_counter()
            post(body)
            walls.append(1e3 * (time.perf_counter() - t0))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.close(timeout=60)
    return {"json_equals_npz": True, "round_trip_ms_p50": statistics.median(walls),
            "round_trip_ms_p90": statistics.quantiles(walls, n=10)[-1]}


def served_path(cfg) -> str:
    return cfg.name if cfg.objective == "mvae" else f"{cfg.name}_{cfg.objective}"


def export_drawn(tmp: str) -> None:
    """Run by ``phase_serving`` in a process of its own (``python -c``), so
    that these exports overlap the static artifacts' gates: each served
    config's batch-8 artifact that draws z (``<path>_sample_z.mmvaept`` in
    ``tmp``) and, for ``DYNAMIC_SERVED``, its dynamic one
    (``<name>_dynamic.mmvaept``), exported on the card from the same seed-0
    weights. Prints each export's seconds as one JSON line."""
    from mmvae_torch import serving

    seconds = {}
    for name, objective, _ in SERVED:
        cfg = configs.get_config(name).replace(objective=objective)
        model = configs.build_model(cfg, seed=0)
        kinds = {"sample_z": SERVE_BATCH}
        if objective == "mvae" and name in DYNAMIC_SERVED:
            kinds["dynamic"] = "dynamic"
        for kind, batch_size in kinds.items():
            t0 = time.perf_counter()
            serving.export_generate(cfg, os.path.join(tmp, f"{served_path(cfg)}_{kind}.mmvaept"),
                                    batch_size=batch_size, model=model, sample_z=True)
            seconds[f"{served_path(cfg)}_{kind}"] = time.perf_counter() - t0
    print(json.dumps(seconds), flush=True)


def serve_static(cfg, model, keys, tmp: str, export_s: float | None = None) -> dict[str, int]:
    """``cfg``'s static batch-8 per-row artifact exported on the card (by
    another process already, where ``export_s`` gives its seconds) and
    loaded with ``load_generate``: the graph's ops, one call's launches,
    each op's output against its plain version, the outputs against
    ``api.generate`` on the card (rel 1e-6) and against the same artifact
    on the CPU (rel 1e-4), the call's walls."""
    from mmvae_torch import serving

    path = served_path(cfg)
    out_path = os.path.join(tmp, f"{path}.mmvaept")
    if export_s is None:
        t0 = time.perf_counter()
        serving.export_generate(cfg, out_path, batch_size=SERVE_BATCH, model=model)
        export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    meta, call = serving.load_generate(out_path)
    load_s = time.perf_counter() - t0
    targets = {str(n.target) for n in call.exported.graph.nodes if n.op == "call_function"}
    want_ops = {"mmvae.poe_kl.default"}
    if cfg.dataset in ("celeba", "cub") and cfg.model_kwargs.get("space_to_depth", 1) == 1:
        want_ops.add("mmvae.conv4x4s2_swish.default")
    if not want_ops <= targets:
        raise AssertionError(f"{path}: the graph lacks {sorted(want_ops - targets)}")
    batch, presence, condition = serve_inputs(cfg, meta, keys, SERVE_BATCH)
    seeds = np.arange(SERVE_BATCH)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    got = call(batch, presence, seed=seeds, temperature=0.0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches != EXPECTED_LAUNCHES[f"serve_{path}"]:
        raise AssertionError(f"serve_{path}: expected launches "
                             f"{EXPECTED_LAUNCHES[f'serve_{path}']}, got {launches}")
    with OpOutputs() as recorded:
        call(batch, presence, seed=seeds, temperature=0.0)
    torch.cuda.synchronize()
    op_rows = check_op_outputs(recorded.calls)
    vs_generate = check_outputs(
        got, api.generate(cfg, condition, model=model, temperature=0.0), 1e-6,
        f"{path}: artifact vs api.generate")
    t0 = time.perf_counter()
    _, cpu_call = serving.load_generate(out_path, device="cpu")
    cpu_load_s = time.perf_counter() - t0
    vs_cpu = check_outputs(got, cpu_call(batch, presence, seed=seeds, temperature=0.0), 1e-4,
                           f"{path}: card vs CPU")
    emit({"phase": "serving", "config": path, "batch_size": SERVE_BATCH,
          "export_s": export_s, "load_s": load_s, "cpu_load_s": cpu_load_s,
          "artifact_bytes": os.path.getsize(out_path), "graph_nodes": len(call.exported.graph.nodes),
          "launches": launches, "op_outputs": op_rows,
          "rel_vs_api_generate": vs_generate, "rel_card_vs_cpu": vs_cpu,
          "call_ms_batch8": call_ms(call, batch, presence)})
    return launches


def serve_drawn(cfg, keys, tmp: str, export_s: float) -> None:
    """``cfg``'s batch-8 artifact that draws z (``export_drawn``'s): requests
    coalesced through the ``Batcher`` against each served alone, gated on
    cuDNN's deterministic algorithms as the host runs them (``serve.main``)
    and reported on its default ones; the HTTP host; the call's walls at
    temperature 1."""
    from mmvae_torch import serving

    path = f"{served_path(cfg)}_sample_z"
    out_path = os.path.join(tmp, f"{path}.mmvaept")
    t0 = time.perf_counter()
    meta, call = serving.load_generate(out_path)
    load_s = time.perf_counter() - t0
    default_algorithms = coalesced_vs_alone(call, meta, cfg, keys, gate=False)
    with deterministic():
        coalescing = coalesced_vs_alone(call, meta, cfg, keys)
        http = http_round_trips(meta, call, cfg, keys)
    batch, presence, _ = serve_inputs(cfg, meta, keys, SERVE_BATCH)
    emit({"phase": "serving_drawn", "config": path, "batch_size": SERVE_BATCH,
          "export_s": export_s, "load_s": load_s, "artifact_bytes": os.path.getsize(out_path),
          "graph_nodes": len(call.exported.graph.nodes),
          "call_ms_batch8": call_ms(call, batch, presence, temperature=1.0),
          "coalescing_deterministic": coalescing,
          "coalescing_default_algorithms": default_algorithms, "http": http})


def serve_dynamic(cfg, keys, tmp: str, export_s: float) -> None:
    """``cfg``'s dynamic artifact that draws z (``export_drawn``'s): the
    call's walls at batch 1, 8 and 64, and the largest difference of the
    first row's outputs between those batches (reported, not gated: the
    card's libraries may take another algorithm at another batch)."""
    from mmvae_torch import serving

    out_path = os.path.join(tmp, f"{cfg.name}_dynamic.mmvaept")
    meta, call = serving.load_generate(out_path)
    walls, first = {}, {}
    for n in (1, 8, 64):
        batch, presence, _ = serve_inputs(cfg, meta, keys, n)
        walls[f"batch{n}"] = call_ms(call, batch, presence, temperature=1.0)
        out = call(batch, presence, seed=np.arange(n), temperature=1.0)
        first[n] = {k: v[:1] for k, v in out.items()}
    diff = {f"batch{n}": {k: (first[n][k].double() - first[1][k].double()).abs().max().item()
                          for k in first[1]} for n in (8, 64)}
    with deterministic():
        coalescing = coalesced_with_strangers(call, meta, cfg, keys)
    emit({"phase": "serving_dynamic", "config": cfg.name, "export_s": export_s,
          "artifact_bytes": os.path.getsize(out_path), "call_ms": walls,
          "row0_max_abs_diff_vs_batch1": diff, "coalescing_fixed_batch": coalescing})


def coalesced_with_strangers(call, meta: dict, cfg, keys, strangers=(0, 7, 63)) -> dict:
    """One request of one row through the host's ``Batcher`` (on the card a
    dynamic artifact's calls all run at ``max_batch``, 64), served alone
    and then coalesced into one call with each count of ``strangers``' rows
    (one request of them, submitted beside it), at temperature 1. Gated:
    its outputs are the same bits every time. Returns the calls and rows
    each took."""
    from mmvae_torch.serve import Batcher

    shapes = {k: (tuple(v[0]), np.dtype(v[1])) for k, v in meta["batch_shapes"].items()}
    target = serve_inputs(cfg, meta, keys, 1, seed=9)[:2] + (np.array([5]),)
    replies, stats = [], []
    for n in strangers:
        requests = [target]
        if n:
            batch, presence, _ = serve_inputs(cfg, meta, keys, n, seed=20)
            requests.append((batch, presence, 1000 + np.arange(n)))
        batcher = Batcher(call, shapes, len(meta["modalities"]), static_batch=None,
                          max_batch=64, max_wait_ms=500)
        results = [None] * len(requests)

        def submit(i, requests=requests, results=results, batcher=batcher):
            batch, presence, seeds = requests[i]
            results[i] = batcher.submit(batch, presence, seeds, 1.0, len(seeds))

        try:
            threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(requests))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            if any(th.is_alive() for th in threads):
                raise AssertionError("a coalesced request did not return")
        finally:
            batcher.close(timeout=60)
        replies.append(results[0])
        stats.append({"strangers": n, "device_calls": batcher.stats["device_calls"],
                      "padded_rows": batcher.stats["padded_rows"]})
    equal = all(np.array_equal(r[k], replies[0][k]) for r in replies[1:] for k in replies[0])
    if not equal:
        raise AssertionError(f"{cfg.name}: a row coalesced with strangers differs from it alone")
    if any(s["device_calls"] != 1 for s in stats):
        raise AssertionError(f"{cfg.name}: the strangers were not coalesced into one call: {stats}")
    return {"bits_equal": equal, "calls": stats}


def phase_serving() -> dict[str, dict[str, int]]:
    """The serving path (``mmvae_torch/serving.py``, ``serve.py``) at full
    width on seed-0 weights: for each config, and MNIST under mopoe, a
    static batch-8 per-row artifact (``serve_static``) and one that draws z
    (``serve_drawn``); for MNIST and CelebA a dynamic one too
    (``serve_dynamic``). The artifacts that draw are exported by a process
    of their own (``export_drawn``) while the static ones are gated.
    Returns the launches of one call of each static artifact."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        worker = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.export_drawn({tmp!r})"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            for name, objective, keys in SERVED:
                cfg = configs.get_config(name).replace(objective=objective)
                out[f"serve_{served_path(cfg)}"] = serve_static(
                    cfg, configs.build_model(cfg, seed=0), keys, tmp)
            stdout, stderr = worker.communicate(timeout=900)
        finally:
            if worker.poll() is None:
                worker.kill()
                worker.communicate()
        if worker.returncode != 0:
            raise RuntimeError(f"export_drawn failed ({worker.returncode}):\n{stderr[-4000:]}")
        seconds = json.loads(stdout.strip().splitlines()[-1])
        for name, objective, keys in SERVED:
            cfg = configs.get_config(name).replace(objective=objective)
            serve_drawn(cfg, keys, tmp, seconds[f"{served_path(cfg)}_sample_z"])
            if objective == "mvae" and name in DYNAMIC_SERVED:
                serve_dynamic(cfg, keys, tmp, seconds[f"{name}_dynamic"])
    return out


# --------------------------------------------------------------- data ----

MNIST_IDX_ROWS = {"train": 60000, "test": 10000}  # the real files' rows
DATA_STEPS = 10  # train steps of the CUB, CelebA and native runs
DATA_BATCH = 64
CUB_CORPUS_V = 2004  # 3 reserved ids, <unk> and 2,000 words
DATA_SEGMENTS = 3  # batches a segment of the segmented evals


def _idx(arr: np.ndarray) -> bytes:
    """An IDX file of uint8 ``arr``."""
    return (struct.pack(">HBB", 0, 0x08, arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
            + arr.astype(np.uint8).tobytes())


def write_data_fixtures(root: Path) -> dict[str, int]:
    """The data phase's mounted data under ``root`` (``$MMVAE_DATA_DIR``),
    from the port's generators with fixed seeds: ``mnist/`` as the IDX
    files of the distribution (train gzipped, test plain) at its 60,000
    and 10,000 rows of uint8; ``cub/train.npz`` and ``test.npz`` with
    captions over a corpus vocabulary of 2,004 ids (``cub/vocab.json``);
    ``celeba/train.npz`` and ``test.npz``. Returns the rows written."""
    from mmvae_torch.data import make_celeba, make_cub, make_mnist, quantize_uint8

    rows = {}
    (root / "mnist").mkdir(parents=True)
    for split, n in MNIST_IDX_ROWS.items():
        data = make_mnist(n, seed={"train": 11, "test": 12}[split])
        stems = (("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz") if split == "train"
                 else ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"))
        for stem, arr in zip(stems, (quantize_uint8(data["image"]), data["label"])):
            blob = _idx(arr)
            if stem.endswith(".gz"):
                with gzip.open(root / "mnist" / stem, "wb", compresslevel=1) as f:
                    f.write(blob)
            else:
                (root / "mnist" / stem).write_bytes(blob)
        rows[f"mnist_{split}"] = n
    rng = np.random.default_rng(13)
    (root / "cub").mkdir()
    itos = ["<pad>", "<start>", "<stop>", "<unk>"] + [f"word{i}" for i in range(CUB_CORPUS_V - 4)]
    (root / "cub" / "vocab.json").write_text(json.dumps({"itos": itos}))
    (root / "celeba").mkdir()
    for split, n, seed in (("train", DATA_STEPS * DATA_BATCH, 14), ("test", 5 * DATA_BATCH, 15)):
        data = make_cub(n, seed=seed)
        tokens = rng.integers(3, CUB_CORPUS_V, (n, 32)).astype(np.int32)
        lengths = rng.integers(4, 31, n)
        tokens[np.arange(32)[None] == lengths[:, None]] = STOP
        tokens[np.arange(32)[None] > lengths[:, None]] = PAD
        np.savez(root / "cub" / f"{split}.npz", image=data["image"], text=tokens)
        np.savez(root / "celeba" / f"{split}.npz", **make_celeba(n, seed=seed))
        rows[f"cub_{split}"] = rows[f"celeba_{split}"] = n
    return rows


@contextlib.contextmanager
def environ(**values):
    """``os.environ`` with ``values`` set (None: unset) for the block."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def counted_train(cfg) -> tuple[api.TrainResult, dict[str, int], float]:
    """``api.train(cfg)`` on the card with the launch counts set to 0 just
    before and read just after; its wall."""
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = api.train(cfg, verbose=False)
    torch.cuda.synchronize()
    return result, dict(kernels.LAUNCHES), time.perf_counter() - t0


def resident_bytes(cfg) -> int:
    """Bytes of the train split the card holds under ``cfg.data_dtype``
    (what ``api.train`` stacks each epoch from)."""
    from mmvae_torch.data import dataset_astype

    ds = dataset_astype(load_dataset(cfg.dataset, "train", n=cfg.train_size), cfg.data_dtype)
    return sum(torch.as_tensor(v).nbytes for v in ds.arrays.values())


def check_at(op: str, shape) -> float:
    """``op``'s kernel against its plain version at ``shape`` on the card,
    under ``phase_check``'s tolerance; returns the largest error."""
    args = inputs(op, shape, torch.Generator(device="cuda").manual_seed(7))
    got, want = KERNEL_FN[op](*args), PLAIN_FN[op](*args)
    torch.cuda.synchronize()
    if op in BWD_OPS:
        return check_grads(op, got, want, shape)
    rtol, atol = tolerance(op, shape)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    return (got.float() - want.float()).abs().max().item()


def data_mnist_idx() -> dict[str, dict[str, int]]:
    """MNIST from the mounted IDX files, ``api.train`` for 2 epochs at full
    width (batch 100, the 60,000 train rows, the 10,000 test rows) under
    ``data_dtype`` float32, uint8 and bfloat16. Gated: the uint8 split
    dequantized on the card equals the float32 split to the bit; the uint8
    run's train losses and test ELBOs equal the float32 run's at rel 1e-6;
    every run's launches equal the float32 run's; K2 and its VJP at MNIST's
    bf16 train targets equal their plain versions."""
    from mmvae_torch.data import dataset_astype
    from mmvae_torch.train.step import _dequant_data

    f32 = load_dataset("mnist", "train")
    if f32.size != MNIST_IDX_ROWS["train"]:
        raise AssertionError(f"the mounted IDX gave {f32.size} rows")
    u8 = dataset_astype(f32, "uint8").arrays["image"]
    on_card = _dequant_data({"image": torch.as_tensor(u8, device="cuda")})["image"]
    if not torch.equal(on_card, torch.as_tensor(f32.arrays["image"], device="cuda")):
        raise AssertionError("the uint8 split dequantized on the card differs from the f32 split")
    cfg = configs.get_config("mnist").replace(epochs=2, train_size=MNIST_IDX_ROWS["train"],
                                              test_size=MNIST_IDX_ROWS["test"])
    runs, launches = {}, {}
    for dtype in ("float32", "uint8", "bfloat16"):
        result, launches[dtype], wall = counted_train(cfg.replace(data_dtype=dtype))
        runs[dtype] = result.history
        emit({"phase": "data", "part": "mnist_idx", "data_dtype": dtype, "history": result.history,
              "train_wall_s": wall, "resident_train_bytes": resident_bytes(
                  cfg.replace(data_dtype=dtype)), "launches": launches[dtype]})
    for key in ("train_loss", "test_elbo"):
        want = [r[key] for r in runs["float32"]]
        got = [r[key] for r in runs["uint8"]]
        rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        if not rel <= 1e-6:
            raise AssertionError(f"mnist: uint8 {key} {got} differ from f32 {want} (rel {rel})")
    if not launches["uint8"] == launches["bfloat16"] == launches["float32"]:
        raise AssertionError(f"mnist: launches differ across data dtypes: {launches}")
    errs = {op: check_at(op, (200, 784, 100, kernels.FOLD_T, torch.bfloat16))
            for op in ("bce", "bce_bwd")}
    emit({"phase": "data", "part": "mnist_idx", "uint8_equals_f32_batch": True,
          "bf16_vs_f32_train_loss_rel": [
              abs(b["train_loss"] - a["train_loss"]) / abs(a["train_loss"])
              for a, b in zip(runs["float32"], runs["bfloat16"])],
          "bf16_targets_max_abs_err": errs})
    return {f"data_mnist_{d}": n for d, n in launches.items()}


def data_cub_corpus() -> dict[str, dict[str, int]]:
    """CUB from a mounted ``.npz`` with a corpus vocabulary of 2,004 ids:
    ``api.train`` at full width (n_latents 256, batch 64) for DATA_STEPS
    steps, then ``eval_elbo`` and ``generate`` from captions (temperature
    0) from its state. Gated: the caption decoder has 2,004 outputs, the
    generated tokens lie in the vocabulary, K3 and its VJP at (192, 32,
    2004), (64, 32, 2004) and (128, 32, 2004) equal their plain versions."""
    v = configs.cub_vocab_size()
    cfg = configs.get_config("cub").replace(epochs=1, train_size=DATA_STEPS * DATA_BATCH,
                                            test_size=5 * DATA_BATCH)
    result, launches, wall = counted_train(cfg)
    out_features = result.model.text_dec.out_proj.out_features
    if not v == out_features == CUB_CORPUS_V:
        raise AssertionError(f"cub: vocabulary {v}, text decoder outputs {out_features}")
    t0 = time.perf_counter()
    elbo = api.eval_elbo(cfg, model=result.model)
    eval_s = time.perf_counter() - t0
    captions = load_dataset("cub", "test", n=4).arrays["text"]
    tokens = api.generate(cfg, {"text": captions}, model=result.model, temperature=0.0)["text"]
    check_text(tokens, 4, 32, v)
    errs = {f"{op}_{n}": check_at(op, (n, 32, CUB_CORPUS_V))
            for op in ("seq_ce", "seq_ce_bwd") for n in (192, 64, 128)}
    emit({"phase": "data", "part": "cub_corpus", "vocab": v, "history": result.history,
          "train_wall_s": wall, "eval_elbo": elbo, "eval_s": eval_s,
          "generated": tokens[:2].tolist(), "launches": launches, "max_abs_err": errs})
    return {"data_cub_corpus": launches}


def data_celeba_npz() -> dict[str, dict[str, int]]:
    """CelebA from a mounted ``.npz``, DATA_STEPS train steps at full width
    under ``data_dtype`` float32, bfloat16 and uint8. Gated: every run's
    launches equal the float32 run's; K4's backward at a bf16 (64, 64, 64,
    3) image, K4 from it into f32, and K2 at the bf16 image and attribute
    targets of a train step equal their plain versions."""
    cfg = configs.get_config("celeba").replace(epochs=1, train_size=DATA_STEPS * DATA_BATCH,
                                               test_size=5 * DATA_BATCH)
    launches = {}
    for dtype in ("float32", "bfloat16", "uint8"):
        result, launches[dtype], wall = counted_train(cfg.replace(data_dtype=dtype))
        emit({"phase": "data", "part": "celeba_npz", "data_dtype": dtype,
              "history": result.history, "train_wall_s": wall, "launches": launches[dtype],
              "resident_train_bytes": resident_bytes(cfg.replace(data_dtype=dtype))})
    if not launches["bfloat16"] == launches["uint8"] == launches["float32"]:
        raise AssertionError(f"celeba: launches differ across data dtypes: {launches}")
    errs = {"conv_bwd": check_at("conv_bwd", (64, 64, 64, 3, torch.bfloat16)),
            "conv": check_at("conv", (64, 64, 64, 3, "bf16_x")),
            "bce_image": check_at("bce", (384, 12288, 64, kernels.FOLD_T, torch.bfloat16)),
            "bce_attrs": check_at("bce", (26496, 1, 1152, kernels.FOLD_T, torch.bfloat16))}
    emit({"phase": "data", "part": "celeba_npz", "bf16_max_abs_err": errs})
    return {f"data_celeba_{d}": n for d, n in launches.items()}


def data_native() -> dict[str, dict[str, int]]:
    """``MMVAE_DATAGEN=native``: the C++ generators built into
    ``mmvae_torch/_build/``; gated to give the same arrays twice for a
    seed; a CelebA train epoch of DATA_STEPS steps on their data."""
    from mmvae_torch.data import native

    t0 = time.perf_counter()
    library = native.build()
    build_s = time.perf_counter() - t0
    for make in (native.make_celeba_native, native.make_multimnist_native):
        one, two = make(256, seed=3), make(256, seed=3)
        if not all(np.array_equal(one[k], two[k]) for k in one):
            raise AssertionError(f"{make.__name__} differs between two calls of one seed")
    with environ(MMVAE_DATAGEN="native", MMVAE_DATA_DIR=None):
        t0 = time.perf_counter()
        data = load_dataset("celeba", "train", n=DATA_STEPS * DATA_BATCH)
        load_s = time.perf_counter() - t0
        want = native.make_celeba_native(DATA_STEPS * DATA_BATCH, seed=0)
        if not np.array_equal(data.arrays["image"], want["image"]):
            raise AssertionError("load_dataset did not take the native CelebA generator")
        cfg = configs.get_config("celeba").replace(
            epochs=1, train_size=DATA_STEPS * DATA_BATCH, test_size=2 * DATA_BATCH)
        result, launches, wall = counted_train(cfg)
    emit({"phase": "data", "part": "native", "library": str(library.relative_to(ROOT)),
          "build_s": build_s, "same_twice": True, "celeba_load_s": load_s,
          "history": result.history, "train_wall_s": wall, "launches": launches})
    return {"data_native_celeba": launches}


def data_segmented_eval() -> None:
    """``eval_elbo`` and ``log_likelihood`` (k = 64) of the mounted MNIST
    (10,000 rows, 100 batches) and CelebA (320, 5 batches) test splits,
    whole (``segment_steps`` 0) and in segments of DATA_SEGMENTS batches
    (the last padded): gated equal to the bit; the walls of both. Both on
    PyTorch's own convolutions (``native_convs``): cuDNN picks an algorithm
    a call from the memory it finds free: CelebA's IWAE has read
    -8619.264276123047 whole and -8619.264273071289 segmented in one run on
    the same input, and either value in other runs."""
    for name in ("mnist", "celeba"):
        cfg = configs.get_config(name)
        model = configs.build_model(cfg, seed=0)
        dataset = load_dataset(name, "test")
        row = {"phase": "data", "part": "segmented_eval", "config": name,
               "examples": dataset.size}
        for fn in ("eval_elbo", "log_likelihood"):
            values = {}
            for segs in (0, DATA_SEGMENTS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with native_convs():
                    values[segs] = getattr(api, fn)(cfg, model=model, dataset=dataset,
                                                    segment_steps=segs)
                row[f"{fn}_wall_s_segments_{segs}"] = time.perf_counter() - t0
            if values[0] != values[DATA_SEGMENTS]:
                raise AssertionError(f"{name}: {fn} whole {values[0]} and segmented "
                                     f"{values[DATA_SEGMENTS]} differ")
            row[fn] = values[0]
        emit(row)


def phase_data() -> dict[str, dict[str, int]]:
    """The data layer on the card (``mmvae_torch/data``): the fixtures of
    ``write_data_fixtures`` in a temporary ``$MMVAE_DATA_DIR``, then
    ``data_mnist_idx``, ``data_cub_corpus``, ``data_celeba_npz``,
    ``data_segmented_eval`` and ``data_native``. Returns each run's
    launches."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rows = write_data_fixtures(Path(tmp))
        emit({"phase": "data", "part": "fixtures", "rows": rows,
              "seconds": time.perf_counter() - t0})
        with environ(MMVAE_DATA_DIR=tmp, MMVAE_DATAGEN=None):
            out.update(data_mnist_idx())
            out.update(data_cub_corpus())
            out.update(data_celeba_npz())
            data_segmented_eval()
    out.update(data_native())
    return out


# ------------------------------------------------- deep trunks (PR 22) ----

DEEP_CONFIGS = {"deep_mnist": {}, "deep_cub": {"train_size": CUB_TRAIN_SIZE}}
DEEP_TIMED_ROUNDS = 2


def graph_epoch_walls(cfg, batches: dict, rounds: int) -> list[float]:
    """``rounds`` epochs over ``batches`` of a graph runner from ``cfg``'s
    seed-0 weights, each after its capture, timed from a sync to a sync."""
    model = configs.build_model(cfg, seed=0)
    state = create_train_state(model, cfg.learning_rate, grad_clip=cfg.grad_clip)
    runner = make_epoch_runner(model, annealing_steps=1000,
                               generator=torch.Generator(device="cuda").manual_seed(1),
                               **api.step_options(cfg))
    runner(state, batches)
    walls = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = runner(state, batches)
        float(metrics["loss"].sum())  # a sync
        walls.append(time.perf_counter() - t0)
    return walls


def deep_train(cfg) -> dict[str, int]:
    """``api.train`` of a deep-trunk config for one epoch at full width on
    the graph runners, with the launch counts through the replays
    (``train_counted``) and its test ELBO below the untrained model's; the
    epoch's graph against its eager loop on deterministic algorithms (rel
    1e-6); the step's wall through the graph runner against the shallow
    config's (``mnist``, ``cub``) over the same batches, in turns (the
    trunks' share of a step); three steps on the card against the CPU under
    ``mnist``'s gates (``deep_cub`` at batch 16, fed as ``cub``'s); for
    ``deep_mnist`` the eval of 200 test examples and ``generate`` from
    their labels on the card against the CPU (``card_vs_cpu``)."""
    path = train_path(cfg)
    untrained = api.eval_elbo(cfg, model=configs.build_model(cfg, seed=0))
    result, launches, wall_s = train_counted(cfg)
    record = result.history[0]
    steps, bs = cfg.train_size // cfg.batch_size, cfg.batch_size
    emit({"phase": "train", "config": cfg.name, "path": path, "epochs": 1,
          "steps": result.state.step, "train_size": cfg.train_size,
          **{k: v for k, v in record.items() if k != "epoch"},
          "untrained_test_elbo": untrained, "api_train_wall_s": wall_s, "launches": launches})
    if result.state.step != steps or not all(map(math.isfinite, record.values())):
        raise AssertionError(f"{path}: {result.state.step} steps, history {record}")
    if not record["test_elbo"] < untrained:
        raise AssertionError(
            f"{path}: test ELBO {record['test_elbo']} not below the untrained {untrained}")
    del result
    batches = train_batches(steps, bs, "cuda", seed=1, config=cfg.dataset)
    with deterministic():
        _, _, runs = first_epochs(cfg, batches)
    compared = graph_vs_eager(runs)
    del runs
    emit({"phase": "train_graph_vs_eager", "config": cfg.name, "path": path, "steps": steps,
          "batch": bs, "cudnn": "deterministic algorithms, cuDNN and torch", "gated": True,
          **compared})
    if not max(compared["step_rel_max"], compared["param_rel_max"]) <= 1e-6:
        raise AssertionError(f"{path}: graph and eager epochs differ: {compared}")
    shallow = configs.get_config(cfg.name.removeprefix("deep_")).replace(
        train_size=cfg.train_size)
    walls = {"deep": [], "shallow": []}
    for _ in range(2):
        walls["deep"] += graph_epoch_walls(cfg, batches, DEEP_TIMED_ROUNDS)
        walls["shallow"] += graph_epoch_walls(shallow, batches, DEEP_TIMED_ROUNDS)
    step_ms = {k: 1e3 * statistics.median(v) / steps for k, v in walls.items()}
    emit({"phase": "deep_rate", "config": cfg.name, "shallow": shallow.name, "steps": steps,
          "batch": bs, "epoch_wall_s": walls, "step_ms_median": step_ms,
          "samples_per_s": {k: 1e3 * bs / v for k, v in step_ms.items()},
          "trunk_share_of_step": 1 - step_ms["shallow"] / step_ms["deep"]})
    if cfg.dataset == "cub":
        conv_card_vs_cpu(cfg, feed_tail=True)
    else:
        train_card_vs_cpu(cfg)
        condition = {"label": [3, 5, 7]}
        card_vs_cpu(cfg, 200, condition, api.generate(cfg, condition, model=configs.build_model(
            cfg, seed=0), temperature=0.0))
    return launches


def export_deep_cub(tmp: str) -> None:
    """Run in a process of its own (``python -c``) while ``deep`` and
    ``conv_variants`` run: ``deep_cub``'s static batch-8 artifact, exported
    on the card from the seed-0 weights into ``tmp`` (the trace is host
    work). Prints the export's seconds."""
    from mmvae_torch import serving

    cfg = configs.get_config("deep_cub")
    t0 = time.perf_counter()
    serving.export_generate(cfg, os.path.join(tmp, f"{served_path(cfg)}.mmvaept"),
                            batch_size=SERVE_BATCH, model=configs.build_model(cfg, seed=0))
    print(json.dumps({"export_s": time.perf_counter() - t0}), flush=True)


def phase_deep() -> tuple[dict[str, dict[str, int]], Callable]:
    """The deep-trunk configs at full width (``deep_mnist``: trunks of 4
    stages at 256 in both MNIST image experts, 100 steps of batch 100;
    ``deep_cub``: trunks of 4 stages at 512 at both CUB image experts'
    bottlenecks, 20 steps of batch 64 over a train split cut to 1,280):
    ``deep_train``, with ``export_deep_cub`` started first beside it.
    Returns the launches and ``finish``, which waits for that process and
    holds ``deep_cub``'s artifact (``generate`` from the images) against
    ``api.generate`` (``serve_static``), returning one call's launches."""
    tmp = tempfile.mkdtemp()
    worker = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.export_deep_cub({tmp!r})"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for name, cut in DEEP_CONFIGS.items():
            out[f"{name}_train"] = deep_train(configs.get_config(name).replace(epochs=1, **cut))
    except BaseException:
        worker.kill()
        worker.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
        raise

    def finish() -> dict[str, int]:
        try:
            stdout, stderr = worker.communicate(timeout=600)
            if worker.returncode != 0:
                raise RuntimeError(
                    f"export_deep_cub failed ({worker.returncode}):\n{stderr[-4000:]}")
            cfg = configs.get_config("deep_cub")
            return serve_static(cfg, configs.build_model(cfg, seed=0), ("image",), tmp,
                                json.loads(stdout.strip().splitlines()[-1])["export_s"])
        finally:
            if worker.poll() is None:
                worker.kill()
                worker.communicate()
            shutil.rmtree(tmp, ignore_errors=True)

    return out, finish


# --------------------------------------- the conv stack variants (PR 22) ----

CONV_VARIANTS = {"celeba_s2d": ("celeba", dict(space_to_depth=2)),
                 "celeba_shuffle": ("celeba", dict(upsample_mode="shuffle")),
                 "cub_shuffle": ("cub", dict(upsample_mode="shuffle"))}
VARIANT_EVAL = 128  # 2 test batches of 64


def variant_label(cfg) -> str:
    """``cfg``'s name with its conv stack variant: ``_s2d`` for
    ``space_to_depth`` > 1, ``_shuffle`` for the pixel-shuffle decoder."""
    kw = cfg.model_kwargs
    return (cfg.name + ("_s2d" if kw.get("space_to_depth", 1) > 1 else "")
            + ("_shuffle" if kw.get("upsample_mode") == "shuffle" else ""))


def phase_conv_variants() -> dict[str, dict[str, int]]:
    """CelebA with ``space_to_depth=2`` (the encoder's stage 0 a 2x2 conv
    over 12 channels on cuDNN: K4 launches no time), CelebA with
    ``upsample_mode="shuffle"`` and CUB with ``upsample_mode="shuffle"``
    (K4 in stage 0), at full width on seed-0 weights: ``eval_elbo`` over
    128 test examples and ``generate`` from 8 of their images with the
    launch counts, the card against the CPU (``card_vs_cpu``);
    ``api.train`` for 3 steps of 64, then the 128-example test ELBO, with
    the launch counts; three steps at batch 16 on the card against the CPU
    (``conv_card_vs_cpu``, the CPU's Adam fed the card's gradient
    components below 9 x eps, as ``cub``'s: unfed, CelebA's ``space_to_depth``
    and shuffle stacks read 1.52e-4 on the image encoder's head, an Adam
    step at rounding level). Returns the launches."""
    out = {}
    for label, (name, kw) in CONV_VARIANTS.items():
        cfg = configs.get_config(name).replace(model_kwargs=kw)
        model = configs.build_model(cfg, seed=0)
        small = load_dataset(cfg.dataset, "test", n=VARIANT_EVAL)
        condition = {"image": small.arrays["image"][:8]}
        ops.set_backend("kernel")
        try:
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            elbo = api.eval_elbo(cfg, model=model, dataset=small)
            generated = api.generate(cfg, condition, model=model, temperature=0.0)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        finally:
            ops.set_backend("auto")
        emit({"phase": "conv_variants", "config": label, "eval_elbo": elbo,
              "launches": launches})
        if launches != EXPECTED_LAUNCHES[label]:
            raise AssertionError(
                f"{label}: expected launches {EXPECTED_LAUNCHES[label]}, got {launches}")
        card_vs_cpu(cfg, VARIANT_EVAL, condition, generated)
        out[label] = launches
        tcfg = cfg.replace(epochs=1, train_size=3 * cfg.batch_size, test_size=VARIANT_EVAL)
        result, out[f"{label}_train"], wall_s = train_counted(tcfg)
        record = result.history[0]
        emit({"phase": "train", "config": label, "path": train_path(tcfg), "steps": 3,
              **{k: v for k, v in record.items() if k != "epoch"},
              "api_train_wall_s": wall_s, "launches": out[f"{label}_train"]})
        if result.state.step != 3 or not all(map(math.isfinite, record.values())):
            raise AssertionError(f"{label}: {result.state.step} steps, history {record}")
        del result
        conv_card_vs_cpu(cfg, feed_tail=True)
    return out


# --------------------------------------- the grain backend (PR 22) ----

GRAIN_EPOCHS = 3
GRAIN_SEGMENT = 30  # 100 steps an epoch: segments of 30, 30, 30 and 10


def grain_run(cfg, workdir: str) -> tuple:
    """``api.train`` of ``cfg`` into ``workdir`` with the "kernel" backend,
    the launch counts set to 0 just before and read just after, and each
    epoch's wall from the end of its train pass to the next's (the
    ``fault_hook``, after a sync): the result, the counts, the walls and
    the eval records."""
    marks = []

    def hook(epoch, state):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return state

    ops.set_backend("kernel")
    try:
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        result = api.train(cfg, workdir, seed=0, verbose=False, fault_hook=hook)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        ops.set_backend("auto")
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if r["kind"] == "eval"]
    return result, launches, [b - a for a, b in zip(marks, marks[1:])], evals


def phase_grain() -> dict[str, dict[str, int]]:
    """``mnist`` at full width on the grain backend (the train split on the
    host, each epoch planned there and gathered by the stream's worker
    thread), 3 epochs: the whole epoch a segment, and segments of 30 steps
    (the last of each epoch 10): the two runs' histories and parameters
    equal to the bit, the launches those of 3 ``mnist`` epochs, each eval
    record's ``stream_hit_rate``; then the device backend in the same run,
    and each run's epoch walls after the first (samples/s). Returns the
    launches."""
    # One checkpoint, after the last epoch: the epoch walls hold no save.
    base = configs.get_config("mnist").replace(epochs=GRAIN_EPOCHS, ckpt_every=GRAIN_EPOCHS)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, fields in (("grain_whole", dict(data_backend="grain")),
                              ("grain_segments", dict(data_backend="grain",
                                                      grain_stream_steps=GRAIN_SEGMENT)),
                              ("device", {})):
            runs[label] = grain_run(base.replace(**fields), os.path.join(tmp, label))
    steps = base.train_size // base.batch_size
    for label, (result, launches, walls, evals) in runs.items():
        emit({"phase": "grain", "run": label, "epochs": GRAIN_EPOCHS, "steps": result.state.step,
              "history": result.history, "launches": launches,
              "stream_hit_rate": [r.get("stream_hit_rate") for r in evals],
              "epoch_wall_s": walls,
              "samples_per_s": [steps * base.batch_size / w for w in walls]})
        if launches != EXPECTED_LAUNCHES["mnist_grain_train"]:
            raise AssertionError(f"{label}: expected launches "
                                 f"{EXPECTED_LAUNCHES['mnist_grain_train']}, got {launches}")
        if result.state.step != GRAIN_EPOCHS * steps:
            raise AssertionError(f"{label}: {result.state.step} steps")
    whole, segs = runs["grain_whole"][0], runs["grain_segments"][0]
    params_equal = all(torch.equal(a, b) for a, b in zip(whole.model.parameters(),
                                                          segs.model.parameters()))
    emit({"phase": "grain_segments_vs_whole", "history_equal": whole.history == segs.history,
          "params_bits_equal": params_equal})
    if not (params_equal and whole.history == segs.history):
        raise AssertionError("grain: the segmented epochs differ from the whole ones")
    return {"mnist_grain_train": runs["grain_whole"][1]}


# ---------------------------------------------- the shuffle modes (PR 22) ----

SHUFFLE_EPOCHS = 5
SHUFFLE_RUNS = {"roll": dict(reshuffle_every=4, shuffle_mode="roll"),
                "block": dict(reshuffle_every=4, shuffle_mode="block"),
                "groups": dict(shuffle_granularity=4)}


def phase_shuffle() -> dict[str, dict[str, int]]:
    """``mnist`` at full width for 5 epochs in each shuffle mode on the
    device backend: a true reshuffle every 4 epochs with rolls between, or
    with the batches read in a new order between, and a reshuffle of 4-row
    groups every epoch: every run's steps those of 5 epochs, its history
    finite, its launches those of 5 ``mnist`` epochs. Returns them."""
    out = {}
    for label, fields in SHUFFLE_RUNS.items():
        cfg = configs.get_config("mnist").replace(epochs=SHUFFLE_EPOCHS, **fields)
        ops.set_backend("kernel")
        try:
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            result = api.train(cfg, seed=0, verbose=False)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            ops.set_backend("auto")
        emit({"phase": "shuffle", "run": label, **fields, "steps": result.state.step,
              "train_loss": [r["train_loss"] for r in result.history],
              "test_elbo": [r["test_elbo"] for r in result.history], "api_train_wall_s": wall_s,
              "launches": launches})
        losses = [v for r in result.history for v in r.values()]
        if result.state.step != SHUFFLE_EPOCHS * 100 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"shuffle {label}: {result.state.step} steps, {result.history}")
        if launches != EXPECTED_LAUNCHES["mnist_shuffle_train"]:
            raise AssertionError(f"shuffle {label}: expected launches "
                                 f"{EXPECTED_LAUNCHES['mnist_shuffle_train']}, got {launches}")
        out[f"mnist_shuffle_{label}_train"] = launches
    return out


# ------------------------------------------------------------ phase 4 ----


# ------------------------------------------------------------- bf16 models ----

BF16 = torch.bfloat16
# Each bf16 path's train split, cut to one epoch of these steps at the
# config's batch (64, 64, 100).
BF16_STEPS = {"celeba": 20, "cub": 20, "mnist": 100}
BF16_IWAE_BATCHES = 4
BF16_GRAPH_STEPS = 5  # the graph-against-eager epochs at bf16
BF16_TIMED_ROUNDS = 3  # epochs of each dtype timed in turns
# The steps of each profiled epoch (a shorter call replays the captured
# step on the leading batches; CUB's 2,000 device events a step make its
# profile slow).
BF16_PROFILED_STEPS = {"celeba": 10, "cub": 4, "mnist": 20}
# The card-against-CPU batch: CelebA's and CUB's 16 (the CPU's share of the
# phase), MNIST's 100.
BF16_CPU_BATCH = {"celeba": 16, "cub": 16, "mnist": 100}
# Card against CPU at bf16 (tests/test_torch_bf16.py's bounds): each
# output within 2^-5 of the CPU's bf16 output's largest magnitude (a bf16
# step or two of the largest entries: the two sides round in their own
# orders), and the outputs together nearer the CPU's bf16 outputs than its
# f32 ones; a loss at rel 2e-3; each gradient within 2^-4 of the f32
# control's largest, widened entry by entry by the CPU's own bf16-to-f32
# distance, and the gradients together nearer the CPU's bf16 gradients
# than its f32 ones (the sums of absolute differences).
BF16_TOL = 2.0**-5
BF16_GRAD_TOL = 2.0**-4
BF16_LOSS_RTOL = 2e-3
META.update({entry: {**META[op], "dtype": "bfloat16 (all operands)"}
             for entry, op in ENTRIES.items() if entry.endswith("_bf16")})


def export_celeba_bf16(tmp: str) -> None:
    """Run in a process of its own (``python -c``) while ``phase_bf16``
    trains: ``celeba``'s static batch-8 per-row artifact with bf16 experts,
    exported on the card from the seed-0 weights into ``tmp``. Prints the
    export's seconds."""
    from mmvae_torch import serving

    cfg = configs.get_config("celeba")
    t0 = time.perf_counter()
    serving.export_generate(cfg, os.path.join(tmp, "celeba_bf16.mmvaept"),
                            batch_size=SERVE_BATCH, model=configs.build_model(cfg, seed=0),
                            dtype=BF16)
    print(json.dumps({"export_s": time.perf_counter() - t0}), flush=True)


def bf16_train(name: str) -> dict[str, dict[str, int]]:
    """``api.train(dtype=bf16)`` of ``name`` for one epoch at full width over
    a train split cut to ``BF16_STEPS`` batches (then its test ELBO over the
    2,000-example split), counted against ``EXPECTED_LAUNCHES``, the
    parameters f32 and the test ELBO finite and below the untrained
    model's; for ``celeba`` then ``log_likelihood`` at k = 64 over 4 test
    batches, counted likewise. Returns each path's launches."""
    cfg = configs.get_config(name).replace(
        epochs=1, train_size=BF16_STEPS[name] * configs.get_config(name).batch_size)
    path = f"{name}_bf16_train"
    untrained = api.eval_elbo(cfg, model=configs.build_model(cfg, seed=0), dtype=BF16)
    result, launches, wall_s = train_counted(cfg, BF16, path)
    record = result.history[0]
    emit({"phase": "train", "config": name, "path": path, "dtype": "bfloat16", "epochs": 1,
          "steps": result.state.step, "train_size": cfg.train_size,
          **{k: v for k, v in record.items() if k != "epoch"},
          "untrained_test_elbo": untrained, "api_train_wall_s": wall_s, "launches": launches})
    if result.state.step != BF16_STEPS[name] or not all(map(math.isfinite, record.values())):
        raise AssertionError(f"{path}: {result.state.step} steps, history {record}")
    if not record["test_elbo"] < untrained:
        raise AssertionError(
            f"{path}: test ELBO {record['test_elbo']} not below the untrained {untrained}")
    if any(p.dtype != torch.float32 for p in result.model.parameters()):
        raise AssertionError(f"{path}: a parameter is not f32")
    if name == "celeba":
        test = load_dataset("celeba", "test")
        n = BF16_IWAE_BATCHES * cfg.batch_size
        subset = Dataset(arrays={k: v[:n] for k, v in test.arrays.items()}, size=n)
        ops.set_backend("kernel")
        try:
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            ll = api.log_likelihood(cfg, model=result.model, dataset=subset, k=IWAE_K, dtype=BF16)
            wall = time.perf_counter() - t0
            iwae = dict(kernels.LAUNCHES)
        finally:
            ops.set_backend("auto")
        emit({"phase": "iwae", "config": "celeba", "path": "celeba_bf16_iwae", "k": IWAE_K,
              "examples": n, "log_likelihood": ll, "wall_s": wall, "launches": iwae})
        if iwae != EXPECTED_LAUNCHES["celeba_bf16_iwae"] or not math.isfinite(ll):
            raise AssertionError(f"celeba_bf16_iwae: {ll}, launches {iwae}")
        return {path: launches, "celeba_bf16_iwae": iwae}
    return {path: launches}


def bf16_graph_vs_eager(name: str) -> None:
    """``BF16_GRAPH_STEPS`` steps of ``name``'s bf16 step through the graph
    runner and the eager loop from the same weights, generator seed and
    batches, on deterministic algorithms: every loss, gradient norm and
    parameter equal to the bit."""
    cfg = configs.get_config(name)
    batches = train_batches(BF16_GRAPH_STEPS, cfg.batch_size, "cuda", seed=1, config=cfg.dataset)
    with deterministic():
        _, _, runs = first_epochs(cfg, batches, BF16)
    compared = graph_vs_eager(runs)
    emit({"phase": "train_graph_vs_eager", "config": name, "path": f"{name}_bf16_train",
          "dtype": "bfloat16", "steps": BF16_GRAPH_STEPS, "batch": cfg.batch_size,
          "cudnn": "deterministic algorithms, cuDNN and torch", "gated": True, **compared})
    if not compared["bits_equal"]:
        raise AssertionError(f"{name} bf16: graph and eager steps differ: {compared}")


def bf16_rate(name: str) -> None:
    """A graph runner of ``name``'s step at bf16 and one at f32 from the
    same weights and batches (an epoch of ``BF16_STEPS``), each captured
    once, then ``BF16_TIMED_ROUNDS`` epochs of each timed in turns (host
    clock, a sync to a sync): the step's wall at each dtype; then a profile
    of a call of each over ``BF16_PROFILED_STEPS`` of the batches, its
    device time a step by kernel family."""
    cfg = configs.get_config(name)
    steps, bs = BF16_STEPS[name], cfg.batch_size
    batches = train_batches(steps, bs, "cuda", seed=1, config=cfg.dataset)
    runners = {}
    for label, dtype in (("bf16", BF16), ("f32", torch.float32)):
        model = configs.build_model(cfg, seed=0, dtype=dtype)
        state = create_train_state(model, cfg.learning_rate, grad_clip=cfg.grad_clip)
        runner = make_epoch_runner(model, annealing_steps=1000,
                                   generator=torch.Generator(device="cuda").manual_seed(1),
                                   **api.step_options(cfg))
        runner(state, batches)  # the capture
        runners[label] = (runner, state)
    walls = {k: [] for k in runners}
    for _ in range(BF16_TIMED_ROUNDS):
        for label, (runner, state) in runners.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = runner(state, batches)
            float(metrics["loss"].sum())  # a sync
            walls[label].append(time.perf_counter() - t0)
    step_ms = {k: 1e3 * statistics.median(v) / steps for k, v in walls.items()}
    busy = {}
    n = BF16_PROFILED_STEPS[name]
    head = {k: v[:n] for k, v in batches.items()}
    for label, (runner, state) in runners.items():
        summary = profile_summary(lambda runner=runner, state=state: runner(state, head))
        by_family = summary["device_busy_by_family_us"]
        busy[label] = {
            "profiled_steps": n,
            "device_busy_us_per_step": (summary["device_busy_us"] / n
                                        if by_family != "not measured" else by_family),
            "by_family_us_per_step": ({k: v / n for k, v in by_family.items()}
                                      if by_family != "not measured" else by_family),
            "top": summary["top"][:6]}
    emit({"phase": "bf16_rate", "config": name, "steps": steps, "batch": bs,
          "epoch_wall_s": walls, "step_ms_median": step_ms,
          "bf16_over_f32": step_ms["bf16"] / step_ms["f32"], "profile": busy})


def bf16_card_vs_cpu(name: str) -> None:
    """One batch of ``name``'s test split (``BF16_CPU_BATCH``) at full width
    on seed-0 weights:
    ``encode`` and ``decode`` (z from a seeded normal) with bf16 experts on
    the card against the CPU at bf16 (the reference) and at f32 (the
    control), under the ``BF16_TOL`` gates; then one loss and its
    gradients, the random subset masks and the noise passed in, under
    ``BF16_LOSS_RTOL`` and ``BF16_GRAD_TOL``, the gradients nearer the
    CPU's bf16 ones than its f32 ones."""
    cfg = configs.get_config(name)
    bs = BF16_CPU_BATCH[name]
    data = load_dataset(cfg.dataset, "test", n=bs).arrays
    gen = torch.Generator().manual_seed(4)
    z = torch.randn(bs, cfg.n_latents, generator=gen)
    knobs = {k: v for k, v in api.step_options(cfg).items() if k != "p_modality_drop"}
    model = configs.build_model(cfg, seed=0, device="cpu")
    if cfg.n_random_subsets:
        knobs["subset_masks"] = (torch.rand((cfg.n_random_subsets, model.n_modalities),
                                            generator=gen) < 0.5).float()
    eps = torch.randn((n_terms(cfg, model.n_modalities), bs, cfg.n_latents), generator=gen)
    outs, losses, grads = {}, {}, {}
    for where, dev, dtype in (("card", "cuda", BF16), ("cpu", "cpu", BF16),
                              ("cpu_f32", "cpu", torch.float32)):
        with deterministic(dev == "cuda"):
            model = configs.build_model(cfg, seed=0, device=dev, dtype=dtype)
            batch = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
            with torch.no_grad():
                mu, lv = model.encode(batch)
                rec = model.decode(z.to(dev), batch)
            outs[where] = {k: v.double().cpu() for k, v in {"mu": mu, "logvar": lv, **rec}.items()}
            loss, _ = multi_term_loss(model, batch, 0.3, eps=eps.to(dev),
                                      **{k: v.to(dev) if torch.is_tensor(v) else v
                                         for k, v in knobs.items()})
            loss.backward()
            losses[where] = loss.item()
            grads[where] = {k: p.grad.double().cpu() for k, p in model.named_parameters()}
    dist, d16, d32 = {}, 0.0, 0.0
    for k, ref in outs["cpu"].items():
        got, scale = outs["card"][k], ref.abs().max().item()
        err = (got - ref).abs().max().item() / scale
        dist[k] = {"max_rel": err, "mean_to_bf16": (got - ref).abs().mean().item() / scale,
                   "mean_to_f32": (got - outs["cpu_f32"][k]).abs().mean().item() / scale}
        d16, d32 = d16 + dist[k]["mean_to_bf16"], d32 + dist[k]["mean_to_f32"]
        if not err <= BF16_TOL:
            raise AssertionError(f"{name} bf16 card vs CPU: {k} at {err} > {BF16_TOL}")
    over = {}
    for k, ref in grads["cpu"].items():
        f32 = grads["cpu_f32"][k]
        bound_ = BF16_GRAD_TOL * f32.abs().max() + (ref - f32).abs()
        over[k] = int(((grads["card"][k] - ref).abs() > bound_).sum())
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    g16, g32 = (sum((grads["card"][k] - g).abs().sum().item() for k, g in grads[ref].items())
                for ref in ("cpu", "cpu_f32"))
    emit({"phase": "bf16_card_vs_cpu", "config": name, "batch": bs, "outputs": dist,
          "outputs_mean_to_bf16": d16, "outputs_mean_to_f32": d32, "losses": losses,
          "loss_rel": loss_rel, "grad_entries_past_bound": sum(over.values()),
          "grad_abs_diff_sum_to_bf16": g16, "grad_abs_diff_sum_to_f32": g32})
    if not d16 < d32:
        raise AssertionError(f"{name} bf16 card vs CPU: nearer the f32 control ({d16}, {d32})")
    if not g16 < g32:
        raise AssertionError(f"{name} bf16 card vs CPU: gradients nearer the f32 control "
                             f"({g16}, {g32})")
    if not loss_rel <= BF16_LOSS_RTOL or sum(over.values()):
        raise AssertionError(f"{name} bf16 card vs CPU: loss rel {loss_rel}, gradients past "
                             f"the bound {over}")


def serve_bf16(tmp: str, export_s: float) -> dict[str, int]:
    """The bf16 CelebA artifact (``export_celeba_bf16``) loaded on the
    card: the graph holds ``mmvae.conv4x4s2_swish`` on bf16 operands and
    ``mmvae.poe_kl``; one call's launches; each op's output against its
    plain version; the outputs at temperature 0 against
    ``api.generate(dtype=bf16)`` on the card (rel 1e-6) and against the same
    artifact on the CPU under the ``BF16_TOL`` gates (the CPU's f32
    ``api.generate`` the control)."""
    from mmvae_torch import serving

    cfg = configs.get_config("celeba")
    out_path = os.path.join(tmp, "celeba_bf16.mmvaept")
    meta, call = serving.load_generate(out_path)
    convs = [n for n in call.exported.graph.nodes
             if str(n.target) == "mmvae.conv4x4s2_swish.default"]
    if not convs or any(a.meta["val"].dtype != BF16 for a in convs[0].args):
        raise AssertionError("celeba bf16 artifact: no mmvae conv on bf16 operands")
    batch, presence, condition = serve_inputs(cfg, meta, ("image",), SERVE_BATCH)
    seeds = np.arange(SERVE_BATCH)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    got = call(batch, presence, seed=seeds, temperature=0.0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches != EXPECTED_LAUNCHES["serve_celeba_bf16"]:
        raise AssertionError(f"serve_celeba_bf16: launches {launches}")
    with OpOutputs() as recorded:
        call(batch, presence, seed=seeds, temperature=0.0)
    op_rows = check_op_outputs(recorded.calls)
    model = configs.build_model(cfg, seed=0, dtype=BF16)
    vs_generate = check_outputs(got, api.generate(cfg, condition, model=model, temperature=0.0),
                                1e-6, "celeba bf16: artifact vs api.generate")
    _, cpu_call = serving.load_generate(out_path, device="cpu")
    cpu = cpu_call(batch, presence, seed=seeds, temperature=0.0)
    f32 = api.generate(cfg, condition, model=configs.build_model(cfg, seed=0, device="cpu"),
                       temperature=0.0, device="cpu")
    vs_cpu = check_outputs(got, cpu, BF16_TOL, "celeba bf16: card vs CPU")
    d16 = sum((got[k].cpu() - cpu[k]).abs().mean().item() / cpu[k].abs().max().item()
              for k in cpu if cpu[k].is_floating_point())
    d32 = sum((got[k].cpu() - f32[k]).abs().mean().item() / cpu[k].abs().max().item()
              for k in cpu if cpu[k].is_floating_point())
    emit({"phase": "serving", "config": "celeba_bf16", "dtype": "bfloat16",
          "batch_size": SERVE_BATCH, "export_s": export_s, "launches": launches,
          "op_outputs": op_rows, "rel_vs_api_generate": vs_generate, "rel_card_vs_cpu": vs_cpu,
          "mean_to_cpu_bf16": d16, "mean_to_cpu_f32": d32,
          "call_ms_batch8": call_ms(call, batch, presence)})
    if not d16 < d32:
        raise AssertionError(f"celeba bf16 artifact: nearer the f32 control ({d16}, {d32})")
    return launches


def phase_bf16() -> dict[str, dict[str, int]]:
    """The bf16 paths at full width (the experts' compute dtype; the
    parameters and the losses f32): ``celeba`` (20 steps of 64 at T = 24,
    its test ELBO over 2,000 examples, ``log_likelihood`` at k = 64 over 4
    batches), ``cub`` (20 steps of 64, K4's input gradient on the cycle's
    re-encode) and ``mnist`` (100 steps of 100) through ``api.train`` with
    their launches (K4, its backward and its dx at bf16 are checked and
    timed with the other kernels, ``entry_of``); graph against eager to the bit
    (``bf16_graph_vs_eager``); each step's wall against f32's in turns
    with its busy time by kernel family (``bf16_rate``); the card against
    the CPU at bf16 (``bf16_card_vs_cpu``); and CelebA's batch-8 bf16
    artifact, exported by a process of its own meanwhile, served
    (``serve_bf16``). Returns the launches."""
    tmp = tempfile.mkdtemp()
    worker = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.export_celeba_bf16({tmp!r})"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        launches = {}
        for name in BF16_STEPS:
            launches.update(bf16_train(name))
        for name in ("celeba", "cub"):
            bf16_graph_vs_eager(name)
        for name in BF16_STEPS:
            bf16_rate(name)
        for name in BF16_STEPS:
            bf16_card_vs_cpu(name)
        stdout, stderr = worker.communicate(timeout=600)
        if worker.returncode != 0:
            raise RuntimeError(f"export_celeba_bf16 failed ({worker.returncode}):\n"
                               f"{stderr[-4000:]}")
        export_s = json.loads(stdout.strip().splitlines()[-1])["export_s"]
        launches["serve_celeba_bf16"] = serve_bf16(tmp, export_s)
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------- dp ----

DP_STEPS = 5  # world 1 on NCCL: steps of each config
DP_W2_STEPS = 3  # world 2: steps of each config
DP_EVAL_N = 333  # the eval split of world 2 (does not divide the batches or the ranks)
DP_TRAIN_SIZE = 2000  # the CLI's one MNIST epoch at world 2: 20 steps of 100
DP_CONFIGS = ("mnist", "celeba")


@contextlib.contextmanager
def native_convs():
    """Deterministic algorithms (``deterministic``) and PyTorch's own
    convolutions in place of cuDNN's: cuDNN picks its algorithm by the
    shape, so a rank's half batch and the whole batch round a conv's
    gradient differently (FFT, Winograd), where PyTorch's im2col and GEMM
    sum the same products; the world-2 gates compare under it."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        with deterministic():
            yield
    finally:
        torch.backends.cudnn.enabled = saved


def free_port() -> int:
    """A free TCP port on this machine's loopback."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dp_batches(cfg, n_steps: int, seed: int) -> dict[str, torch.Tensor]:
    """``n_steps`` global batches of ``cfg`` on the card, with its random
    subset masks: every rank makes the same ones."""
    batches = train_batches(n_steps, cfg.batch_size, "cuda", seed=seed, config=cfg.dataset)
    if cfg.n_random_subsets:
        n_mod = configs.build_model(cfg, seed=0, device="cpu").n_modalities
        gen = torch.Generator().manual_seed(seed)
        batches["subset_masks"] = (torch.rand(
            (n_steps, cfg.n_random_subsets, n_mod), generator=gen) < 0.5).float().cuda()
    return batches


def dp_steps(cfg, batches: dict, term_fold: str, mesh=None, graph: bool | None = None,
             record: list | None = None, fed: list | None = None, mode: str | None = None):
    """``cfg``'s steps over ``batches`` (this rank's rows where a ``mesh``
    is given) from the seed-0 weights and a noise generator seeded 6:
    the metrics, the model, the wall of the call (to a sync) and the runner
    with its state. Each step's gradients, as the update reads them (the
    mesh's all-reduced), go to ``record``; ``fed`` (a step's gradients of
    another run, each) sets the components both runs compute below
    TAIL_BELOW to the other run's value before the update (``conv_card_vs_
    cpu``'s feeding: Adam turns a component's rounding at eps into up to a
    step of lr), and each step's tail counts, the components above it whose
    signs differ and the three tensors with the largest difference relative
    to the other run's largest component are the last item returned.
    ``mode`` ``"tp"`` or ``"fsdp"`` shards the state over ``mesh``
    (``parallel.tp_shard`` on a model built with it, ``parallel.fsdp_
    shard``): the model holds this rank's blocks, and ``fed`` is cut to
    them."""
    model = configs.build_model(cfg, seed=0, tp_mesh=mesh if mode == "tp" else None)
    state = create_train_state(model, cfg.learning_rate, grad_clip=cfg.grad_clip)
    if mode is not None:
        state = (tp_shard if mode == "tp" else fsdp_shard)(state, mesh)
    gen = torch.Generator(device="cuda").manual_seed(6)
    apply, steps, counts = state.apply_gradients, iter(fed or ()), []

    def apply_gradients(commit=None):
        named = list(model.named_parameters())
        if record is not None:
            record.append({n: p.grad.detach().cpu().clone() for n, p in named})
        if fed is not None:
            other, tally = next(steps), dict.fromkeys(("this", "other", "fed", "signs"), 0)
            tally["rel_top"] = []
            for n, p in named:
                o = other[n].to(p.device)
                if state.layout is not None:
                    o = state.layout.shard(n, o)
                here, there = p.grad.abs() < TAIL_BELOW, o.abs() < TAIL_BELOW
                both = here & there
                for key, mask in (("this", here), ("other", there), ("fed", both)):
                    tally[key] += int(mask.sum())
                tally["signs"] += int(((p.grad * o < 0) & ~here & ~there).sum())
                scale = o.abs().max().item()
                tally["rel_top"].append(
                    (n, ((p.grad - o).abs().max().item() / scale) if scale else 0.0))
                p.grad[both] = o[both]
            tally["rel_top"] = sorted(tally["rel_top"], key=lambda kv: -kv[1])[:3]
            counts.append(tally)
        apply(commit)

    if record is not None or fed is not None:
        state.apply_gradients = apply_gradients
    try:
        runner = make_epoch_runner(state.compute_model, graph=graph, annealing_steps=1000,
                                   generator=gen, term_fold=term_fold, mesh=mesh,
                                   **api.step_options(cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = runner(state, batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if "apply_gradients" in vars(state):
            del state.apply_gradients
    return metrics, model, wall, (runner, state), counts


def steady_step_ms(runner, state, batches: dict, rounds: int = 3) -> float:
    """The median wall (to a sync) of ``rounds`` more calls of a runner
    over ``batches``, a step's share."""
    walls = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner(state, batches)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0) / _rows(batches))
    return statistics.median(walls)


def _rows(batches: dict) -> int:
    return next(iter(batches.values())).shape[0]


def dp_reference_epoch(cfg) -> dict:
    """World 1 of ``api.train``'s data-parallel epoch at 2 ranks (the
    ``--multihost`` CLI run's): the split host-shuffled with
    ``default_rng(seed ^ 0x5EED)``, one epoch of 2-shard orders
    (``make_gather_epoch_runner(n_shards=2)``, the "b" fold over the whole
    batch, which draws the noise in the layout the ranks' "st" fold draws
    it), then the test ELBO."""
    steps = cfg.train_size // cfg.batch_size
    model = configs.build_model(cfg, seed=0)
    state = create_train_state(model, learning_rate(cfg, steps), grad_clip=cfg.grad_clip,
                               ema_decay=cfg.ema_decay, accum_steps=cfg.accum_steps)
    train = load_dataset(cfg.dataset, "train", n=cfg.train_size)
    perm = torch.as_tensor(np.random.default_rng(0 ^ 0x5EED).permutation(train.size))
    arrays = {k: torch.as_tensor(v)[perm].cuda() for k, v in train.arrays.items()}
    runner = make_gather_epoch_runner(
        model, steps, cfg.batch_size, n_shards=2, order=torch.Generator().manual_seed(0),
        generator=torch.Generator(device="cuda").manual_seed(0),
        annealing_steps=cfg.annealing_epochs * steps, **api.step_options(cfg))
    state, _, metrics = runner(state, arrays, None, True)
    test = load_dataset(cfg.dataset, "test", n=cfg.test_size)
    return {"train_loss": float(metrics["loss"].double().mean()),
            "test_elbo": api.eval_elbo(cfg, model=state.eval_model, dataset=test)}


def dp_worker(out: str, fed: str, backend: str) -> None:
    """One rank of the world-2 runs (``phase_dp``), its group on
    ``backend`` from the environment (torchrun's variables): 3 steps of ``mnist`` and
    ``celeba`` under the "st" fold on its rows of each global batch (the
    subset masks whole), on native convolutions as world 1's, the
    gradients' tails fed from world 1's (``fed``, ``dp_steps``), a step's
    steady wall over 3 more calls, then
    ``eval_elbo`` and ``log_likelihood`` with the mesh on a split of 333.
    Rank 0 writes what it got to ``out``."""
    multihost.initialize(backend=backend)
    mesh = make_mesh()
    res = {"backend": mesh.backend, "size": mesh.size}
    w1_grads = torch.load(fed, weights_only=False)
    for name in DP_CONFIGS:
        cfg = configs.get_config(name)
        batches = dp_batches(cfg, DP_W2_STEPS, seed=5)
        local = {**shard_batch({k: v for k, v in batches.items() if k != "subset_masks"}, mesh,
                               dim=1),
                 **{k: v for k, v in batches.items() if k == "subset_masks"}}
        # The gated steps run eagerly (the feeding reads the gradients on
        # the host) on deterministic algorithms, as world 1's; the timed ones
        # on cuDNN's default algorithms and the runner the backend takes (a
        # graph holding the collective on NCCL, the eager loop on gloo).
        with native_convs():
            metrics, model, wall, _, counts = dp_steps(cfg, local, "st", mesh, graph=False,
                                                       fed=w1_grads[name])
        _, _, _, (runner, state), _ = dp_steps(cfg, local, "st", mesh)
        res[name] = {"loss": metrics["loss"].tolist(), "grad_norm": metrics["grad_norm"].tolist(),
                     "wall_s": wall, "graph": mesh.backend == "nccl", "tail_counts": counts,
                     "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
                     "step_ms": steady_step_ms(runner, state, local)}
        test = load_dataset(cfg.dataset, "test", n=DP_EVAL_N)
        fresh = configs.build_model(cfg, seed=0)
        res[name]["eval_elbo"] = api.eval_elbo(cfg, model=fresh, dataset=test, mesh=mesh)
        res[name]["log_likelihood"] = api.log_likelihood(
            cfg, model=fresh, dataset=test, k=IWAE_K, seed=0, mesh=mesh)
    if mesh.rank == 0:
        torch.save(res, out)
    multihost.sync()


def run_ranks(argvs: list[list[str]], envs: list[dict], timeout: float) -> list[str]:
    """Processes, one a rank, started together; each one's standard
    output. A rank that fails raises, and every other is stopped."""
    procs = [subprocess.Popen(argv, cwd=ROOT, env={**os.environ, **env}, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for argv, env in zip(argvs, envs)]
    outs = []
    try:
        for i, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"rank {i} of {argvs[i][-6:]} failed ({proc.returncode}):\n"
                                   f"{stderr[-4000:]}")
            outs.append(stdout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's variables for ``rank`` of one host. Under NCCL rank ``r``
    takes card ``r``; gloo's ranks stay on the current card, card 0."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def dp_world2(backend: str, tmp: str) -> dict:
    """``dp_worker`` at 2 ranks on ``backend``: its rank 0's results."""
    out = os.path.join(tmp, f"w2_{backend}.pt")
    fed = os.path.join(tmp, "w1_grads.pt")
    port = free_port()
    argv = [sys.executable, "-c",
            f"import chip_smoke; chip_smoke.dp_worker({out!r}, {fed!r}, {backend!r})"]
    t0 = time.perf_counter()
    run_ranks([argv, argv], [rank_env(r, 2, port) for r in range(2)], timeout=600)
    res = torch.load(out, weights_only=False)
    res["wall_s"] = time.perf_counter() - t0
    return res


def dp_cli(tmp: str, backend: str) -> dict:
    """One MNIST epoch (20 steps of 100, the 2,000-example test ELBO)
    through the CLI's ``train --multihost`` at 2 ranks under torchrun's
    variables, rank r writing to its own ``--workdir``: rank 0's history,
    and the files each workdir holds. Each rank forms its group on
    ``backend`` first (``multihost.initialize``, which the CLI's own call
    then finds formed), as two ranks on one card cannot be NCCL's."""
    port = free_port()
    dirs = [os.path.join(tmp, f"cli_rank{r}") for r in range(2)]
    argvs = [[sys.executable, "-c",
              "import sys; from mmvae_torch import cli; from mmvae_torch.parallel import "
              f"multihost; multihost.initialize(backend={backend!r}); sys.exit(cli.main(["
              f"'train', '--config', 'mnist', '--multihost', '--workdir', {d!r}, "
              f"'--epochs', '1', '--train-size', '{DP_TRAIN_SIZE}']))"] for d in dirs]
    t0 = time.perf_counter()
    outs = run_ranks(argvs, [rank_env(r, 2, port) for r in range(2)], timeout=600)
    wall = time.perf_counter() - t0
    files = [sorted(str(p.relative_to(d)) for p in Path(d).rglob("*")) if os.path.isdir(d)
             else [] for d in dirs]
    history = [json.loads(line) for line in Path(dirs[0], "metrics.jsonl").read_text().splitlines()]
    evals = [r for r in history if r.get("kind") == "eval"]
    return {"wall_s": wall, "files": files, "eval": evals,
            "best": json.loads(outs[0].strip().splitlines()[-1])}


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def param_excess(got: dict, want: dict, init: dict) -> tuple[float, dict]:
    """The largest excess of a parameter's difference over rtol 2e-3 of the
    reference, and where: the tensor, the elements past atol 1e-5, and the
    worst element's values and its update from ``init``."""
    worst, where = -math.inf, {}
    for n, w in want.items():
        excess = (got[n] - w).abs() - 2e-3 * w.abs()
        i = int(excess.flatten().argmax())
        if excess.flatten()[i].item() > worst:
            worst = excess.flatten()[i].item()
            where = {"tensor": n, "past_atol": int((excess > 1e-5).sum()),
                     "got": got[n].flatten()[i].item(), "want": w.flatten()[i].item(),
                     "update_want": (w.flatten()[i] - init[n].flatten()[i]).item()}
    return worst, where


def check_world2(res: dict, ref: dict, backend: str) -> list[str]:
    """World 2's steps, evals and IWAE against world 1's: the loss at rel
    1e-4, the parameters within rtol 2e-3 and atol 1e-5 (the JAX DP test's
    ``tests/test_dp.py:57-60``), the ELBO and the IWAE at rel 1e-5. Returns
    the failures."""
    failures = []
    for name in DP_CONFIGS:
        got, want = res[name], ref[name]
        loss_rel = max(rel(a, b) for a, b in zip(got["loss"], want["loss"]))
        init = dict(configs.build_model(configs.get_config(name), seed=0,
                                        device="cpu").named_parameters())
        param_err, where = param_excess(got["params"], want["params"], init)
        elbo_rel = rel(got["eval_elbo"], want["eval_elbo"])
        ll_rel = rel(got["log_likelihood"], want["log_likelihood"])
        emit({"phase": "dp_world2", "backend": backend, "config": name, "steps": DP_W2_STEPS,
              "loss_w2": got["loss"], "loss_w1": want["loss"], "loss_rel_max": loss_rel,
              "param_excess_over_rtol_max": param_err, "param_worst": where,
              "eval_elbo_w2": got["eval_elbo"],
              "eval_elbo_w1": want["eval_elbo"], "eval_elbo_rel": elbo_rel,
              "log_likelihood_w2": got["log_likelihood"],
              "log_likelihood_w1": want["log_likelihood"], "log_likelihood_rel": ll_rel,
              "steps_wall_s_w2": got["wall_s"], "steps_wall_s_w1": want["wall_s"],
              "step_ms_w2": got["step_ms"], "step_ms_w1": want["step_ms"],
              "tail_below": TAIL_BELOW, "tail_counts_per_step": got["tail_counts"],
              "w2_graph": got["graph"], "eval_n": DP_EVAL_N})
        for i, tally in enumerate(got["tail_counts"]):
            one_side = max(tally["this"], tally["other"]) - tally["fed"]
            if not one_side <= TAIL_SLACK * tally["other"]:
                failures.append(f"dp world 2 ({backend}) {name} step {i}: {one_side} gradient "
                                f"components below {TAIL_BELOW} on one side only: {tally}")
        if not (loss_rel <= 1e-4 and param_err <= 1e-5 and elbo_rel <= 1e-5
                and ll_rel <= 1e-5):
            failures.append(f"dp world 2 ({backend}) {name}: loss rel {loss_rel}, "
                            f"param excess {param_err} at {where}, ELBO rel {elbo_rel}, "
                            f"IWAE rel {ll_rel}")
    return failures


def dp_bits(runs: dict) -> dict:
    """Two runs' metrics and parameters: the largest relative difference
    and whether every bit is equal."""
    (m_a, model_a), (m_b, model_b) = runs
    step_rel = max(((m_a[k] - m_b[k]).abs() / m_b[k].abs()).max().item()
                   for k in ("loss", "grad_norm"))
    bits = (all(torch.equal(m_a[k], m_b[k]) for k in ("loss", "grad_norm"))
            and all(torch.equal(a, b) for a, b in zip(model_a.parameters(), model_b.parameters())))
    return {"step_rel_max": step_rel, "bits_equal": bits}


def dp_world1(name: str, mesh) -> dict:
    """``name``'s 5 steps on the one-rank NCCL mesh under "st" (the
    all-reduce in each step): the graph runner (the collective captured)
    against the eager loop, and the eager loop given the noise ``(B, T,
    L)`` against the single-process "t" loop given it as ``(T, B, L)``,
    both to the bit on cuDNN's deterministic algorithms; then each step's
    wall of the graph runner on the mesh against the single-process one,
    in turns."""
    cfg = configs.get_config(name)
    batches = dp_batches(cfg, DP_STEPS, seed=4)
    n_mod = configs.build_model(cfg, seed=0, device="cpu").n_modalities
    gen = torch.Generator(device="cuda").manual_seed(8)
    eps = torch.randn((DP_STEPS, cfg.batch_size, n_terms(cfg, n_mod), cfg.n_latents),
                      generator=gen, device="cuda")
    with deterministic():
        g_m, g_model, _, _, _ = dp_steps(cfg, {**batches, "eps": eps}, "st", mesh, True)
        e_m, e_model, _, _, _ = dp_steps(cfg, {**batches, "eps": eps}, "st", mesh, False)
        t_m, t_model, _, _, _ = dp_steps(
            cfg, {**batches, "eps": eps.transpose(1, 2).contiguous()}, "t", None, False)
    graph_eager = dp_bits([(g_m, g_model), (e_m, e_model)])
    st_t = dp_bits([(e_m, e_model), (t_m, t_model)])
    # Walls in turns, both graphs captured on cuDNN's default algorithms:
    # the mesh's graph epoch (the collective in each step) against the
    # single-process "t" graph epoch, the same 5 batches.
    graph_run = dp_steps(cfg, {**batches, "eps": eps}, "st", mesh, True)[3]
    single_run = dp_steps(cfg, {**batches, "eps": eps.transpose(1, 2).contiguous()},
                          "t", None, True)[3]
    walls = {"mesh_st": [], "single_t": []}
    for _ in range(3):
        for kind, (runner, state), feed in (
                ("mesh_st", graph_run, {**batches, "eps": eps}),
                ("single_t", single_run, {**batches, "eps": eps.transpose(1, 2).contiguous()})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner(state, feed)
            torch.cuda.synchronize()
            walls[kind].append(1e3 * (time.perf_counter() - t0) / DP_STEPS)
    step_ms = {k: statistics.median(v) for k, v in walls.items()}
    runner, state = graph_run
    prof = profile_summary(lambda: runner(state, {**batches, "eps": eps}))
    out = {"phase": "dp_world1_nccl", "config": name, "steps": DP_STEPS,
           "mesh_epoch_profile": {k: prof[k] for k in ("wall_us", "device_busy_us",
                                                       "device_events", "top")},
           "graph_vs_eager": graph_eager, "st_vs_t": st_t,
           "step_ms_median": step_ms, "step_ms_rounds": walls,
           "collective_ms_per_step": step_ms["mesh_st"] - step_ms["single_t"]}
    emit(out)
    if not (graph_eager["bits_equal"] and st_t["bits_equal"]):
        raise AssertionError(f"dp world 1 {name}: graph vs eager {graph_eager}, "
                             f"st vs t {st_t}")
    return out


def celeba_b_train() -> dict[str, int]:
    """20 CelebA steps of 64 under the "b" fold on the graph runner with
    the "kernel" backend and the launch counts (K2's VJP at the map over
    examples of 18 attribute rows 20 times), then the graph epoch against
    the "t" one in turns (what the fold's layout costs a step), the
    ``(T, B, L) -> (B, T, L)`` copies of a step's posteriors timed alone,
    and three steps of the card against the CPU under the "b" fold."""
    cfg = configs.get_config("celeba")
    batches = dp_batches(cfg, 20, seed=1)
    ops.set_backend("kernel")
    try:
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        metrics, _, first_s, b_run, _ = dp_steps(cfg, batches, "b", None, True)
        launches = dict(kernels.LAUNCHES)
    finally:
        ops.set_backend("auto")
    if launches != EXPECTED_LAUNCHES["celeba_b_train"]:
        raise AssertionError(f"celeba_b_train: expected launches "
                             f"{EXPECTED_LAUNCHES['celeba_b_train']}, got {launches}")
    if not torch.isfinite(metrics["loss"]).all():
        raise AssertionError(f"celeba_b_train: loss {metrics['loss'].tolist()}")
    t_run = dp_steps(cfg, batches, "t", None, True)[3]
    walls = {"b": [], "t": []}
    for _ in range(3):
        for kind, (runner, state) in (("b", b_run), ("t", t_run)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner(state, batches)
            torch.cuda.synchronize()
            walls[kind].append(1e3 * (time.perf_counter() - t0) / 20)
    t, b, l = n_terms(cfg, 19), cfg.batch_size, cfg.n_latents
    mu = torch.randn(t, b, l, device="cuda")
    copy_ms = device_ms(lambda: mu.transpose(0, 1).contiguous())
    emit({"phase": "celeba_b_train", "steps": 20, "batch": b, "terms": t, "launches": launches,
          "first_call_s": first_s, "loss": metrics["loss"].tolist(),
          "step_ms_median": {k: statistics.median(v) for k, v in walls.items()},
          "step_ms_rounds": walls, "tb_to_bt_copy_ms": copy_ms,
          "tb_to_bt_copies_per_step": "2 forward (mu, log-variance), 2 backward"})
    # The first steps' tails (beta 0): as for CUB and FashionMNIST, the
    # components both sides compute below TAIL_BELOW take the card's value.
    # The noise is the "t" gate's draw (``fold_draw_witness``).
    conv_card_vs_cpu(cfg, feed_tail=True, term_fold="b", path="celeba_b_train", draw="t")
    return launches


def fold_draw_witness() -> None:
    """CelebA's card against the CPU (``conv_card_vs_cpu``, tails fed,
    ungated) under the "b" and the "t" fold, each on the "b" fold's own
    ``(B, T, L)`` draw and on the "t" gate's ``(T, B, L)`` one, the same
    values for both folds: whether an update reading over the gate's 1e-4
    follows the draw or the fold. Run after ``phase_device``:
    ``python3 -c 'import chip_smoke as c; c.phase_device(); c.fold_draw_witness()'``."""
    cfg = configs.get_config("celeba")
    for draw in ("b", "t"):
        for fold in ("b", "t"):
            conv_card_vs_cpu(cfg, feed_tail=True, term_fold=fold, draw=draw, gate=False,
                             path=f"witness_{fold}_fold_{draw}_draw")


def phase_dp() -> dict[str, dict[str, int]]:
    """Data parallelism on the card: CelebA's step under the "b" fold
    (``celeba_b_train``: K2's VJP at the map over examples of several rows
    on the path); a one-rank NCCL group, MNIST's and CelebA's "st" steps
    with the all-reduce in each (``dp_world1``); two processes on the one
    card over gloo's CUDA all-reduce (NCCL refuses two ranks on one
    device) -- 3 steps of MNIST and CelebA, ``eval_elbo`` and
    ``log_likelihood`` with the mesh, each against world 1
    (``check_world2``), and one MNIST epoch through the CLI's
    ``--multihost``, its history against world 1's (``dp_reference_epoch``)
    at rel 1e-4 with only rank 0 writing; with two cards or more, the same
    world-2 runs on NCCL across cards. Returns the launches."""
    import torch.distributed as dist

    tmp, world2 = tempfile.mkdtemp(), None
    try:
        launches = {"celeba_b_train": celeba_b_train()}
        multihost.initialize(f"localhost:{free_port()}", 1, 0, backend="nccl")
        try:
            mesh = make_mesh()
            for name in DP_CONFIGS:
                dp_world1(name, mesh)
        finally:
            dist.destroy_process_group()
        # World 1's steps (eager, as world 2's over gloo) and their
        # gradients, which world 2 feeds its tails from; then world 2 in
        # processes of its own while this one makes the eval references.
        ref, grads = {}, {}
        for name in DP_CONFIGS:
            cfg = configs.get_config(name)
            batches = dp_batches(cfg, DP_W2_STEPS, seed=5)
            grads[name] = []
            with native_convs():
                metrics, model, wall, _, _ = dp_steps(cfg, batches, "b", graph=False,
                                                      record=grads[name])
            runner, state = dp_steps(cfg, batches, "b", graph=False)[3]
            ref[name] = {"loss": metrics["loss"].tolist(), "wall_s": wall,
                         "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
                         "step_ms": steady_step_ms(runner, state, batches)}
        torch.save(grads, os.path.join(tmp, "w1_grads.pt"))
        del grads
        world2 = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.dp_world2_main({tmp!r})"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in DP_CONFIGS:
            cfg = configs.get_config(name)
            test = load_dataset(cfg.dataset, "test", n=DP_EVAL_N)
            fresh = configs.build_model(cfg, seed=0)
            ref[name].update(
                eval_elbo=api.eval_elbo(cfg, model=fresh, dataset=test),
                log_likelihood=api.log_likelihood(cfg, model=fresh, dataset=test, k=IWAE_K,
                                                  seed=0))
        cli_ref = dp_reference_epoch(
            configs.get_config("mnist").replace(epochs=1, train_size=DP_TRAIN_SIZE))
        _, stderr = world2.communicate(timeout=900)
        if world2.returncode != 0:
            raise RuntimeError(f"dp world 2 failed ({world2.returncode}):\n{stderr[-6000:]}")
        results = torch.load(os.path.join(tmp, "world2.pt"), weights_only=False)
        failures = []  # every gate of world 2 read before any raises
        for backend, res in results["steps"].items():
            failures += check_world2(res, ref, backend)
        for backend, cli in results["cli"].items():
            (record,) = cli["eval"]
            train_rel = rel(record["train_loss"], cli_ref["train_loss"])
            test_rel = rel(record["test_elbo"], cli_ref["test_elbo"])
            rank1_files = cli["files"][1]
            emit({"phase": "dp_cli", "backend": backend, "wall_s": cli["wall_s"],
                  "world2_steps_wall_s": results["steps"][backend]["wall_s"],
                  "history_w2": record, "history_w1": cli_ref, "train_loss_rel": train_rel,
                  "test_elbo_rel": test_rel, "rank0_files": cli["files"][0],
                  "rank1_files": rank1_files})
            if not (train_rel <= 1e-4 and test_rel <= 1e-4):
                failures.append(f"dp cli ({backend}): train rel {train_rel}, "
                                f"test rel {test_rel}")
            if rank1_files or "metrics.jsonl" not in cli["files"][0]:
                failures.append(f"dp cli ({backend}): rank 0 wrote {cli['files'][0]}, "
                                f"rank 1 {rank1_files}")
        if failures:
            raise AssertionError("; ".join(failures))
    finally:
        if world2 is not None and world2.poll() is None:
            world2.kill()
            world2.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def dp_world2_main(tmp: str) -> None:
    """The world-2 runs of ``phase_dp`` in a process of their own (the
    ranks' processes under it): gloo on the one card, NCCL across cards
    where there are two. Writes ``world2.pt`` to ``tmp``."""
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
    steps, cli = {}, {}
    for backend in backends:
        steps[backend] = dp_world2(backend, tmp)
        cli[backend] = dp_cli(tmp, backend)
    torch.save({"steps": steps, "cli": cli}, os.path.join(tmp, "world2.pt"))


TP_STEPS = 3  # the gated steps of each sharded run


def sharded_worker(out: str, fed: str, backend: str, tp: int) -> None:
    """One rank of ``phase_tp_fsdp``'s runs over ``backend`` (its group from
    torchrun's variables). At ``tp = 2`` (two ranks, one model group):
    CelebA's 3 steps under the "b" fold on a state sharded by tensor
    parallelism (stage 0's K4 at 16 channels) and by FSDP, each eager on
    native convolutions with the gradients' tails fed from world 1's
    (``fed``), then a step's steady wall on the runner the backend takes (a
    graph holding the collectives on NCCL, the eager loop on gloo), the
    whole parameters after, the launch counts of the gated steps and the
    state's bytes; then CUB's 3 steps under TP (K4 at 16, its backward and
    its input gradient). At ``tp = 4`` (four ranks): CUB's 3 steps under TP
    (K4 at 8). Rank 0 writes what it got to ``out``."""
    multihost.initialize(backend=backend)
    res = {"backend": backend, "world": torch.distributed.get_world_size()}
    runs = [("celeba", "tp"), ("celeba", "fsdp"), ("cub", "tp")] if tp == 2 else [("cub", "tp")]
    w1 = torch.load(fed, weights_only=False)
    mesh_tp, mesh_dp = make_mesh_2d(tp), make_mesh()
    for name, mode in runs:
        cfg = configs.get_config(name)
        mesh = mesh_tp if mode == "tp" else mesh_dp
        batches = dp_batches(cfg, TP_STEPS, seed=5)
        local = {**shard_batch({k: v for k, v in batches.items() if k != "subset_masks"}, mesh,
                               dim=1),
                 **{k: v for k, v in batches.items() if k == "subset_masks"}}
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        with native_convs():
            metrics, model, wall, (_, state), counts = dp_steps(
                cfg, local, "b", mesh, graph=False, fed=w1.get(name), mode=mode)
        launches = dict(kernels.LAUNCHES)
        whole = {n: state.layout.gather(n, p.detach()).cpu() for n, p in model.named_parameters()}
        key = f"{name}_{mode}" + ("4" if tp == 4 else "")
        res[key] = {
            "loss": metrics["loss"].tolist(), "grad_norm": metrics["grad_norm"].tolist(),
            "wall_s": wall, "tail_counts": counts, "launches": launches, "params": whole,
            "stage0_out_channels": state.model.image_enc.convs[0].weight.shape[0],
            "bytes": state_bytes(state),
            "sharded_numel": sum(p.numel() * state.layout.size
                                 for n, p in model.named_parameters()
                                 if state.layout.sharded(n)),
            "copies": 3, "layout_size": state.layout.size}
        if name == "celeba":
            runner, state = dp_steps(cfg, local, "b", mesh, mode=mode)[3]
            res[key].update(step_ms=steady_step_ms(runner, state, local),
                            graph=mesh.backend == "nccl")
    if torch.distributed.get_rank() == 0:
        torch.save(res, out)
    multihost.sync()


def phase_tp_fsdp() -> dict[str, dict[str, int]]:
    """FSDP and tensor parallelism on the card (``parallel/fsdp.py``,
    ``parallel/tp.py``): CelebA's 3 steps at world 1 under the "b" fold
    (eager, native convolutions, the gradients recorded), then two
    processes on the one card over gloo -- CelebA under TP (one model group
    of 2: each rank's stage 0 is K4 at 16 channels, its attribute banks 9
    of the 18) and under FSDP, each held to world 1 under the world-2 gates
    (``check_world2``'s loss at rel 1e-4 and parameters within rtol 2e-3
    and atol 1e-5, the tails fed), each rank's persistent state against an
    unsharded one's by the layout, CUB's 3 steps under TP (K4 at 16, its
    backward and input gradient) -- and four processes for CUB under TP at
    tp = 4 (K4 at 8); each path's launches against ``EXPECTED_LAUNCHES``.
    With two cards or more the world-2 runs again on NCCL across cards, in
    the graph. Returns the launches."""
    tmp = tempfile.mkdtemp()
    procs = []
    try:
        cfg = configs.get_config("celeba")
        batches = dp_batches(cfg, TP_STEPS, seed=5)
        grads = []
        with native_convs():
            metrics, model, wall, (_, state), _ = dp_steps(cfg, batches, "b", graph=False,
                                                           record=grads)
        ref = {"loss": metrics["loss"].tolist(), "wall_s": wall, "bytes": state_bytes(state),
               "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}
        runner, state = dp_steps(cfg, batches, "b", graph=False)[3]  # eager, as gloo's
        ref["step_ms"] = steady_step_ms(runner, state, batches)
        fed = os.path.join(tmp, "w1_grads.pt")
        torch.save({"celeba": grads}, fed)
        del grads, runner, state
        backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
        worlds = [(b, 2) for b in backends] + [("gloo", 4)]
        for backend, world in worlds:
            out = os.path.join(tmp, f"{backend}_{world}.pt")
            port = free_port()
            argv = [sys.executable, "-c", f"import chip_smoke; chip_smoke.sharded_worker("
                    f"{out!r}, {fed!r}, {backend!r}, {world})"]
            procs.append((backend, world, out, [subprocess.Popen(
                argv, cwd=ROOT, env={**os.environ, **rank_env(r, world, port)}, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(world)]))
            if backend == "nccl":  # one NCCL world at a time on the cards
                _wait_ranks(procs[-1][3])
        failures, launches = [], {}
        for backend, world, out, ranks in procs:
            _wait_ranks(ranks)
            res = torch.load(out, weights_only=False)
            for key, got in res.items():
                if not isinstance(got, dict):
                    continue
                path = {"celeba_tp": "celeba_tp_train", "celeba_fsdp": "celeba_fsdp_train",
                        "cub_tp": "cub_tp_train", "cub_tp4": "cub_tp4_train"}[key]
                if backend == "gloo":
                    launches[path] = got["launches"]
                failures += check_sharded(key, path, got, ref, backend, world)
        if failures:
            raise AssertionError("; ".join(failures))
    finally:
        for *_, ranks in procs:
            for proc in ranks:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _wait_ranks(ranks: list, timeout: float = 600) -> None:
    for i, proc in enumerate(ranks):
        _, stderr = proc.communicate(timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"rank {i} of a sharded run failed ({proc.returncode}):\n"
                               f"{stderr[-4000:]}")


def check_sharded(key: str, path: str, got: dict, ref: dict, backend: str,
                  world: int) -> list[str]:
    """A sharded run's gates: its launches against ``EXPECTED_LAUNCHES`` and
    stage 0's K4 at 32 / tp channels (FSDP: 32, the whole gathered
    weight); CelebA's steps against world 1's (the world-2 gates and the
    tails), and its state's bytes against world 1's less the blocks it does
    not hold (``copies`` f32 tensors a parameter: itself and Adam's two
    moments); CUB's loss finite. Returns the failures."""
    failures = []
    tp = world if key.startswith("cub") or key.endswith("_tp") else 1
    want_f = kernels.CONV_OUT // (tp if "_tp" in key else 1)
    if got["launches"] != EXPECTED_LAUNCHES[path] or got["stage0_out_channels"] != want_f:
        failures.append(f"{path} ({backend}): launches {got['launches']}, stage 0 at "
                        f"{got['stage0_out_channels']} channels, want "
                        f"{EXPECTED_LAUNCHES[path]} at {want_f}")
    row = {"phase": "tp_fsdp", "path": path, "backend": backend, "world": world,
           "steps": TP_STEPS, "loss": got["loss"], "stage0_out_channels": want_f,
           "launches": got["launches"], "bytes_per_rank": got["bytes"]}
    if key.startswith("celeba"):
        loss_rel = max(rel(a, b) for a, b in zip(got["loss"], ref["loss"]))
        init = dict(configs.build_model(configs.get_config("celeba"), seed=0,
                                        device="cpu").named_parameters())
        param_err, where = param_excess(got["params"], ref["params"], init)
        shed = got["copies"] * 4 * got["sharded_numel"] * (got["layout_size"] - 1) \
            // got["layout_size"]
        row.update(loss_w1=ref["loss"], loss_rel_max=loss_rel,
                   param_excess_over_rtol_max=param_err, param_worst=where,
                   tail_below=TAIL_BELOW, tail_counts_per_step=got["tail_counts"],
                   bytes_per_rank_w1=ref["bytes"], bytes_expected=ref["bytes"] - shed,
                   step_ms=got["step_ms"], step_ms_w1=ref["step_ms"], graph=got["graph"],
                   steps_wall_s=got["wall_s"], steps_wall_s_w1=ref["wall_s"])
        if not (loss_rel <= 1e-4 and param_err <= 1e-5):
            failures.append(f"{path} ({backend}): loss rel {loss_rel}, param excess "
                            f"{param_err} at {where}")
        for i, tally in enumerate(got["tail_counts"]):
            one_side = max(tally["this"], tally["other"]) - tally["fed"]
            if not one_side <= TAIL_SLACK * tally["other"]:
                failures.append(f"{path} ({backend}) step {i}: {one_side} gradient "
                                f"components below {TAIL_BELOW} on one side only: {tally}")
        if got["bytes"] != ref["bytes"] - shed:
            failures.append(f"{path} ({backend}): {got['bytes']} state bytes a rank, want "
                            f"{ref['bytes'] - shed}")
    elif not all(math.isfinite(v) for v in got["loss"]):
        failures.append(f"{path} ({backend}): loss {got['loss']}")
    emit(row)
    return failures


def graph_ms(calls, reps: int = REPS) -> float:
    """Device time of one call: CUDA-graph replay of ``calls`` in turn,
    timed by CUDA events, median over ``reps`` replays. ``calls`` may be a
    function that makes the list: it runs on the stream the graph is
    captured on (an autograd backward must be made there)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        if callable(calls):
            calls = calls()
        for call in calls[:3]:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # capture_begin/end rather than ``torch.cuda.graph``, which also empties
    # the allocator's cache and collects garbage at each of these captures.
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for call in calls:
                call()
        finally:
            graph.capture_end()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def device_ms(fn, reps: int = REPS, inner: int = 20) -> float:
    """Device time of one call on the same inputs, ``inner`` calls a
    replay: inputs that fit in the L2 stay there."""
    return graph_ms([fn] * inner, reps)


def cold_copies(args) -> int:
    """Copies of ``args`` that hold at least twice the L2 together (at
    least 6, at most 512), or 0 when one copy does not fit in the L2."""
    n_bytes = sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))
    if n_bytes >= L2_BYTES:
        return 0
    return min(512, max(6, math.ceil(2 * L2_BYTES / n_bytes)))


def cold_ms(make_call, args, copies: int) -> float:
    """Device time of one call L2-cold: the graph cycles through
    ``copies`` copies of ``args``, so each call finds its inputs evicted
    by the calls on the others. ``make_call(args)`` gives the call."""
    sets = [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            for _ in range(copies)]
    return graph_ms(lambda: [make_call(a) for a in sets], reps=20)


def eager_ms(fn, reps: int = REPS, inner: int = 20) -> float:
    """Time of one eager call, host overhead included (median of ``reps``)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def timing_row(op: str, args) -> dict:
    """The times of ``op``'s kernel on ``args``: on the device in the L2
    and L2-cold, eagerly, its plain version's, the library call's, and the
    bound."""
    k, p = KERNEL_FN[op], PLAIN_FN[op]
    has_lib = library_fn(op, args) is not None
    row = {
        "kernel_ms": device_ms(lambda: k(*args)),
        "plain_ms": device_ms(lambda: p(*args)),
        "kernel_eager_ms": eager_ms(lambda: k(*args)),
        "plain_eager_ms": eager_ms(lambda: p(*args)),
        "library_ms": graph_ms(lambda: [library_fn(op, args)] * 20) if has_lib else None,
    }
    copies = cold_copies(args)
    row["cold_copies"] = copies
    row["kernel_cold_ms"] = (
        cold_ms(lambda a: functools.partial(k, *a), args, copies) if copies else None)
    row["library_cold_ms"] = (
        cold_ms(lambda a: library_fn(op, a), args, copies) if copies and has_lib else None)
    row["bound_ms"], row["bound_by"] = bound(op, args)
    return row


def phase_timings(launches: dict[str, dict[str, int]]) -> dict[str, dict]:
    """Each kernel at every shape of ``TIMED_SHAPES`` (``timing_row``).
    Returns the rows the kernels line reports, by entry (``REPORTED``)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    reported = {}
    for op in OPS:
        for label, shape in TIMED_SHAPES[op].items():
            args = inputs(op, shape, gen)
            row = timing_row(op, args)
            if op == "poe_kl":
                row["parent_chain_ms"] = device_ms(lambda: parent_chain(*args))
                row["parent_chain_eager_ms"] = eager_ms(lambda: parent_chain(*args))
            emit({"phase": "timing", "kernel": META[op]["name"], "label": label,
                  **describe(op, shape), **row,
                  "launches_per_config": {c: n[op] for c, n in launches.items()}})
            for entry, of in ENTRIES.items():
                if of == op and label == REPORTED[entry][1]:
                    reported[entry] = row
    return reported


def phase_launch_floor() -> None:
    """An empty kernel launched through the same ``ctypes`` path as the
    port's kernels, graph-replayed (``device_ms``) and eager (``eager_ms``,
    host included), at one warp and at the grids of K1 (CelebA's (1280,
    100)), K4 (the CelebA eval batch) and the fused PoE + KL (CelebA's eval
    shape): the floor the small kernels sit on."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    conv = kernels.conv_plan(64, 64, 64, 3, sms)
    poe = kernels.poe_kl_plan(20, 64, 19, 100, sms)
    grids = {"one_warp": (1, 32), "kl_rows_celeba": (-(-1280 // 8), 256),
             "conv_celeba": (conv.blocks, 32 * conv.warps),
             "poe_kl_celeba": (poe.blocks, 32 * poe.warps)}
    for label, (blocks, threads) in grids.items():
        def call(blocks=blocks, threads=threads):
            kernels._launch("launch_floor", "empty_launch", dev, blocks, threads)
        emit({"phase": "launch_floor", "label": label, "blocks": blocks, "threads": threads,
              "device_ms": device_ms(call), "eager_ms": eager_ms(call)})


def phase_eval_wall(config) -> None:
    """The eval of ``config``'s (a name, or an ``ExperimentConfig`` under
    another objective) 2,000-example test split through a graph
    runner built once (as ``api.train`` keeps it) and through the eager
    loop, timed in turns (three each, to a sync); the graph's first call
    (one batch eager, the capture, the replays); ``api.eval_elbo``'s own
    wall, which captures anew each call; and a profile of the graph
    runner, whose busy time gives each runner's idle share against its
    unprofiled walls (the eager loop runs the same kernels: its busy time
    read within 5% of the graph's in every config, and its profile took 20
    s of the run on CUB's 40,000 events)."""
    cfg = configs.get_config(config) if isinstance(config, str) else config
    model = configs.build_model(cfg, seed=0)
    test = load_dataset(cfg.dataset, "test")
    stacked = api._padded_split(test, cfg.batch_size, model.n_modalities, torch.device("cuda"))
    runners = {kind: make_eval_runner(model, cfg.objective, cfg.mvtcae_alpha, graph=kind == "graph")
               for kind in ("graph", "eager")}
    first = {}
    for kind, runner in runners.items():
        t0 = time.perf_counter()
        float(runner(stacked)["loss"].sum())
        first[kind] = 1e3 * (time.perf_counter() - t0)
    walls = {"graph": [], "eager": []}
    for _ in range(3):
        for kind, runner in runners.items():
            t0 = time.perf_counter()
            float(runner(stacked)["loss"].sum())  # a sync
            walls[kind].append(1e3 * (time.perf_counter() - t0))
    entry = []
    for _ in range(2):
        t0 = time.perf_counter()
        api.eval_elbo(cfg, model=model, dataset=test)
        entry.append(1e3 * (time.perf_counter() - t0))
    config = cfg.name if cfg.objective == "mvae" else f"{cfg.name}_{cfg.objective}"
    emit({"phase": "eval_wall", "config": config, "examples": test.size,
          "batches": stacked["presence"].shape[0],
          "wall_ms_median": {k: statistics.median(v) for k, v in walls.items()},
          "wall_ms": walls, "first_call_ms": first, "eval_elbo_wall_ms": entry})
    emit_graph_profile("eval_profile", config, runners["graph"], stacked, walls)


def emit_graph_profile(phase: str, config: str, runner, stacked: dict, walls: dict) -> None:
    """A profile of one call of a graph ``runner`` on ``stacked``, with the
    idle share of each runner's unprofiled walls against its busy time."""
    summary = profile_summary(lambda: runner(stacked))
    busy = summary["device_busy_us"]
    emit({"phase": phase, "config": config, "runner": "graph",
          "idle_share_unprofiled": {
              kind: 1 - busy / (1e3 * statistics.median(w)) if busy != "not measured" else busy
              for kind, w in walls.items()},
          **summary})


def phase_iwae_wall(config: str) -> None:
    """``log_likelihood`` of ``config``'s 2,000-example test split at k =
    64 through an IWAE graph runner built once and through the eager loop,
    timed in turns (two each, to a sync), their first calls, the entry
    point's own wall (a capture each call), and a profile of the graph
    runner (as ``phase_eval_wall``'s): where the device time goes and each
    runner's idle share."""
    model = configs.build_model(config, seed=0)
    test = load_dataset(config, "test")
    stacked = api._valid_split(test, configs.get_config(config).batch_size, torch.device("cuda"))
    runners = {kind: make_iwae_runner(model, IWAE_K, graph=kind == "graph",
                                      generator=torch.Generator(device="cuda").manual_seed(0))
               for kind in ("graph", "eager")}
    first, walls = {}, {"graph": [], "eager": []}
    for kind, runner in runners.items():
        t0 = time.perf_counter()
        float(runner(stacked)["log_likelihood"].sum())
        first[kind] = 1e3 * (time.perf_counter() - t0)
    for _ in range(2):
        for kind, runner in runners.items():
            t0 = time.perf_counter()
            float(runner(stacked)["log_likelihood"].sum())  # a sync
            walls[kind].append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    api.log_likelihood(config, model=model, dataset=test, k=IWAE_K)
    entry = 1e3 * (time.perf_counter() - t0)
    emit({"phase": "iwae_wall", "config": config, "examples": test.size, "k": IWAE_K,
          "batches": stacked["valid"].shape[0],
          "wall_ms_median": {k: statistics.median(v) for k, v in walls.items()},
          "wall_ms": walls, "first_call_ms": first, "log_likelihood_wall_ms": entry})
    emit_graph_profile("iwae_profile", config, runners["graph"], stacked, walls)


# Device events by family, in this order of tests: the port's kernels;
# cuDNN's convolutions (fprop, dgrad, wgrad and their layout transposes);
# the matrix products (cuBLAS, the GRU's and the dense layers'); casts and
# copies on the SMs (PyTorch's copy kernel, which casts between types);
# copies and fills by the copy engines; the rest (elementwise, reductions,
# the optimizer).
FAMILIES = ("port", "cudnn_conv", "gemm", "cast", "copy", "other")


def kernel_family(key: str) -> str:
    if any(n in key for n in PORT_KERNELS):
        return "port"
    if re.search(r"fprop|dgrad|wgrad|cudnn|[Cc]onv|nchwToNhwc|nhwcToNchw", key):
        return "cudnn_conv"
    if re.search(r"gemm|Gemm|GEMM|cublas|cutlass", key):
        return "gemm"
    if re.search(r"copy_kernel", key):
        return "cast"
    if re.search(r"Memcpy|Memset", key):
        return "copy"
    return "other"


def profile_summary(fn) -> dict:
    """Where the device time of one call of ``fn`` goes: its wall (to a
    sync), device busy time with and without every host-to-device copy, the
    idle share, the device events, the top device ops, the port's kernels,
    and the launches of each kernel as the profiler counted them (a CUDA
    graph's replays included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)

    # Device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched, and so does a user
    # annotation's span on the device (the optimizer step's).
    rows = sorted(
        ((dev_us(e), e.key, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    # Every host-to-device copy, not only those in the top list: the
    # profiler counts the pageable upload in some evals and not others.
    h2d = sum(r[0] for r in rows if "HtoD" in r[1])
    port_launches = {k: 0 for k in kernels.LAUNCHES}
    by_family = {family: 0.0 for family in FAMILIES}
    for us, key, _ in rows:
        by_family[kernel_family(key)] += us
    for _, key, count in rows:
        for name, op in KERNEL_OP.items():
            if re.search(rf"\b{name}\b", key):
                port_launches[op] += count
    return {
        "wall_us": wall_us,
        "device_busy_us": busy if busy else "not measured",
        "device_busy_less_h2d_us": busy - h2d if busy else "not measured",
        "h2d_us": h2d if busy else "not measured",
        "device_idle_share": 1 - busy / wall_us if busy else "not measured",
        "device_events": sum(r[2] for r in rows),
        "top": [{"name": k[:80], "device_us": us, "count": c}
                for us, k, c in rows[:12] if us > 0],
        "port_kernels": [{"name": k[:80], "device_us": us, "count": c}
                         for us, k, c in rows if any(n in k for n in PORT_KERNELS)],
        "port_launches": port_launches,
        "device_busy_by_family_us": by_family if busy else "not measured",
    }


def main() -> None:
    seconds, held, t0 = {}, {}, time.perf_counter()

    def timed(name: str, phase, *args):
        start = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - start
        held[name] = torch.cuda.memory_allocated() / 2**30  # what the phase left behind
        return out

    kind = timed("device_and_build", phase_device)
    max_err = timed("check", phase_check)
    launches = timed("main_path", phase_main_path)
    launches.update(timed("iwae", phase_iwae))
    launches["mnist_train"] = timed("train", phase_train)
    launches["multimnist_train"] = timed("multimnist_train", phase_multimnist_train)
    launches["celeba_train"] = timed("celeba_train", phase_celeba_train)
    launches["cub_train"] = timed("cub_train", phase_cub_train)
    launches["fashionmnist_train"] = timed("fashionmnist_train", phase_fashionmnist_train)
    launches.update(timed("mixture_train", phase_mixture_train))
    launches.update(timed("celeba_mopoe_train", phase_celeba_mopoe_train))
    launches["multimnist_knobs_train"] = timed(
        "multimnist_knobs_train", phase_multimnist_train, LOSS_KNOBS)
    timed("workdir", phase_workdir)
    launches.update(timed("train_extras", phase_train_extras))
    launches.update(timed("serving", phase_serving))
    launches.update(timed("data", phase_data))
    deep, finish_deep_export = timed("deep", phase_deep)
    launches.update(deep)
    try:
        launches.update(timed("conv_variants", phase_conv_variants))
    finally:
        launches["serve_deep_cub"] = timed("deep_export", finish_deep_export)
    launches.update(timed("grain", phase_grain))
    launches.update(timed("shuffle", phase_shuffle))
    launches.update(timed("bf16", phase_bf16))
    launches.update(timed("dp", phase_dp))
    launches.update(timed("tp_fsdp", phase_tp_fsdp))
    reported = timed("timings", phase_timings, launches)
    timed("launch_floor", phase_launch_floor)
    for config in CONFIGS:
        timed(f"eval_wall_{config}", phase_eval_wall, config)
    for config in MIXTURE_EVALS:
        timed(f"eval_wall_{config.name}_{config.objective}", phase_eval_wall, config)
    for config in CONFIGS:
        timed(f"iwae_wall_{config}", phase_iwae_wall, config)
    emit({"phase": "phase_seconds", **seconds, "total": time.perf_counter() - t0})
    emit({"phase": "phase_allocated_gib", **held})
    emit({"kernels": [
        {**META[entry], "launches": launches[REPORTED[entry][0]][op],
         "config": REPORTED[entry][0], "shape": REPORTED[entry][1],
         "launches_per_config": {c: n[op] for c, n in launches.items()
                                 if entry == op or ("bf16" if entry.endswith("bf16")
                                                    else "_tp") in c},
         "max_abs_err": max_err[entry],
         "ms": reported[entry]["kernel_ms"], "plain_ms": reported[entry]["plain_ms"],
         "bound_ms": reported[entry]["bound_ms"], "bound_by": reported[entry]["bound_by"],
         "library_ms": reported[entry]["library_ms"]}
        for entry, op in ENTRIES.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
