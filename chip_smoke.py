"""Smoke run of the PyTorch/CUDA port (``mmvae_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device and build: the card's name and power limit, TF32 off, and the
   hand-written kernels built from ``mmvae_torch/ops/csrc`` with ``nvcc``
   (the port's four sources and the launch-floor probe, one ``nvcc``
   each, started together);
2. each kernel held against its plain PyTorch version on the card, at the
   main paths' shapes and at ragged, odd and large ones (rtol 1e-5; atol
   1e-5 * D for the row reductions, 1e-5 * S * log V for the sequence
   cross-entropy, 1e-5 * 16 * C for the f32 conv: the kernels sum in
   another order; the bf16 conv atol 2e-2, one bf16 rounding of outputs
   below 4; the fused PoE + KL atol 1e-6 for the posteriors and 1e-5 * L
   for the KL, whose rows with every expert absent must give exactly 0;
   the elementwise gradients of K1, K2 and K3 atol 1e-6, a pad token's K3
   gradient exactly 0; the fused PoE + KL's backward atol 1e-5 * T times
   its largest gradient, as it sums T terms);
3. the main paths at full width, with seeded random weights, each with
   the launch counts set to 0 just before it and read just after:
   every eval runs the fused PoE + KL once per batch and K1 no time;
   - ``mnist`` (n_latents 64, 512-wide MLP experts): ``eval_elbo`` over
     the 2,000-example synthetic test split, ``generate`` from labels and
     ``sample``;
   - ``multimnist`` (n_latents 256, conv features 32-256 over 50x50, GRU
     text experts of width 256): ``eval_elbo`` over its 2,000-example
     split, ``generate`` from text, from images and from nothing, and
     ``sample``;
   - ``celeba`` (n_latents 100, conv features 32-256 over 64x64 RGB, 18
     attribute experts, 19 experts in the PoE, batch 64): ``eval_elbo``
     over its 2,000-example split (32 batches), ``generate`` from
     images, from all 18 attributes, from ``attr_4`` and ``attr_8``
     alone and from nothing, and ``sample``;
   then each eval again with the plain ``torch`` backend (rel 1e-5) and a
   CPU reference on a small split (rel 1e-4: CPU and card matmuls round
   differently; generated probabilities within 1e-4, tokens and labels
   generated at temperature 0 equal);
   - ``mnist`` training: ``api.train`` for one epoch at full width (100
     steps of batch 100 over the 10,000-example train split, then the test
     ELBO) on the CUDA-graph runners (each epoch and each eval split
     replays of one captured step), launching the fused PoE + KL and K2
     forward 120 times each and their backward kernels 100 times each,
     counted by the wrappers through the replays; its first-epoch test
     ELBO below the untrained model's; then the graph runner against the
     eager loop from the same weights, noise seed and batches over an
     epoch (loss and gradient norm each step, every parameter: rel 1e-6,
     and whether the bits are equal), two epochs of each timed in turns
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
   - a workdir: ``mnist`` at full width over a train split cut to 2,000
     trained 2 epochs into a temporary workdir and resumed for a third,
     against an uninterrupted 3-epoch run (rel 1e-6);
     ``eval_elbo`` from the workdir against the best epoch's recorded test
     ELBO (rel 1e-6), and ``generate`` and ``sample`` from it;
4. timings: each kernel and its plain version on the device (CUDA-graph
   replay, median of 25) and eagerly (host overhead included), the
   library call that computes the same function where there is one, the
   kernel and the library call again L2-cold where the inputs fit in the
   50 MB L2 (the graph cycles through 6 to 512 copies of the inputs,
   twice the L2 where that fits); beside the fused PoE + KL, the chain of
   launches it replaced (the mask product, ``core.product_of_experts``,
   then K1); the floor of an empty launch at K1's, K4's and the fused
   kernel's grids and at one warp, graph-replayed and eager; and for each
   config the eval wall of its test split through a graph runner built
   once and through the eager loop, in turns, ``eval_elbo``'s own wall
   (a capture each call) and a profile of where each runner's device time
   goes (its device busy time with and without the host-to-device
   copies). The
   backward kernels are timed at MNIST's and MultiMNIST's train shapes
   beside their plain versions and the autograd backward of the library
   forward.

It prints one JSON line per result, the ``nvidia-smi`` line, the kernel
summary, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from mmvae_torch import api, configs, ops
from mmvae_torch.core import elbo_subset_masks
from mmvae_torch.data import load_dataset
from mmvae_torch.models.text import STOP
from mmvae_torch.ops import kernels
from mmvae_torch.train import (
    create_train_state,
    make_epoch_runner,
    make_eval_runner,
    make_train_step,
)

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 rate, L2 size, the f32 rate outside the
# tensor cores and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# Per element: KL 4 flops + exp; BCE 5 flops + exp + log1p; seq CE a
# compare, a subtract, an add and an exp per logit. Per conv output: 2
# flops for each of the 16 * C products, a bias add and the swish's exp,
# add, divide and multiply. The fused PoE + KL: per expert element a clamp,
# an exp, an add and a divide; per (term, expert element) the weight
# product and its sum, the mean product and its sum; per output the prior
# add, a divide, a log, a negation and K1's 5.
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
OPS_PER_ELEM = {"kl": 5, "bce": 7, "seq_ce": 4, "kl_bwd": 5, "bce_bwd": 5, "seq_ce_bwd": 9}
CONV_OPS_PER_OUT = 5
POE_OPS = {"expert": 4, "term_expert": 4, "out": 9}
POE_BWD_OPS = {"expert": 7, "term_expert": 9, "out": 11}
OPS = ("kl", "bce", "seq_ce", "conv", "poe_kl", "kl_bwd", "bce_bwd", "seq_ce_bwd", "poe_kl_bwd")
BWD_OPS = ("kl_bwd", "bce_bwd", "seq_ce_bwd", "poe_kl_bwd")
CONFIGS = ("mnist", "multimnist", "celeba")
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
}
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
# terms of 19 experts for CelebA.
TIMED_SHAPES = {
    "kl": {"mnist_eval": (300, 64, 300, None), "multimnist_eval": (300, 256, 300, None),
           "celeba_eval": (1280, 100, 1280, None), "large": (12288, 64, 12288, None)},
    "bce": {"mnist_eval": (200, 784, 100, kernels.FOLD_T),
            "multimnist_eval": (200, 2500, 100, kernels.FOLD_T),
            "multimnist_train": (300, 2500, 100, kernels.FOLD_T),
            "celeba_image": (128, 12288, 64, kernels.FOLD_T),
            "celeba_attrs": (21888, 1, 1152, kernels.FOLD_T),
            "large": (8192, 784, 4096, kernels.FOLD_T)},
    "seq_ce": {"multimnist_eval": (200, 5, 13), "multimnist_train": (300, 5, 13),
               "cub_synthetic": (4096, 32, 23), "large": (2048, 8, 5003)},
    "conv": {"celeba_eval": (64, 64, 64, 3, torch.float32),
             "probe": (256, 64, 64, 3, torch.bfloat16)},
    "poe_kl": {"mnist_eval": (3, 100, 2, 64, "eval"),
               "multimnist_eval": (3, 100, 2, 256, "eval"),
               "multimnist_train": (3, 100, 2, 256, "text"),
               "celeba_eval": (20, 64, 19, 100, "eval")},
    # One MNIST train step: K1's VJP at the (T * B, L) posteriors (no path
    # runs it alone), K2's at the image's 2 member terms against 100
    # untiled targets, the fused PoE + KL's at the batch's expert stack.
    # One MultiMNIST train step: K2's at the decode-all pass's 3 terms of
    # images, K3's at its 3 terms of text and at one cycle re-read, the
    # fused PoE + KL's at the loss's 3 terms and at a re-read's one.
    "kl_bwd": {"mnist_train": (300, 64, 300, None), "celeba_eval": (1280, 100, 1280, None)},
    "bce_bwd": {"mnist_train": (200, 784, 100, kernels.FOLD_T),
                "multimnist_train": (300, 2500, 100, kernels.FOLD_T),
                "celeba_image": (128, 12288, 64, kernels.FOLD_T)},
    "seq_ce_bwd": {"multimnist_train": (300, 5, 13), "multimnist_cycle": (100, 5, 13),
                   "cub_synthetic": (4096, 32, 23), "large": (2048, 8, 5003)},
    "poe_kl_bwd": {"mnist_train": (3, 100, 2, 64, "eval"),
                   "multimnist_train": (3, 100, 2, 256, "text"),
                   "multimnist_cycle": (1, 100, 2, 256, "cycle"),
                   "celeba_eval": (20, 64, 19, 100, "eval")},
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
        # CelebA's image rows in the other folds; fewer rows than SMs at
        # an odd D (scalar loads, a cluster a row); D not a multiple of 4.
        (128, 12288, 128, kernels.FOLD_NONE),
        (128, 12288, 64, kernels.FOLD_B),
        (16, 50001, 16, kernels.FOLD_NONE),
        (128, 12290, 128, kernels.FOLD_NONE),
    ],
    # MultiMNIST eval and train (the decode-all pass, a cycle re-read);
    # ragged with all-pad rows; the synthetic CUB vocabulary (3 reserved +
    # 20 words); a large odd vocabulary; S above the tokens a block runs at
    # once, at an odd V; V just below a warp.
    "seq_ce": [(200, 5, 13), (300, 5, 13), (100, 5, 13), (37, 7, 13), (4096, 32, 23),
               (2048, 8, 5003), (3, 40, 1001), (5, 3, 31)],
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
             (2, 7, 1100, 4, torch.float32)],
    # The three eval batches; CelebA's padded last batch (16 rows present,
    # 48 absent); no presence mask; log-variances past the +-11 clamp; an
    # odd L; experts one element into their storage.
    "poe_kl": [(3, 100, 2, 64, "eval"), (3, 100, 2, 256, "eval"), (20, 64, 19, 100, "eval"),
               (20, 64, 19, 100, "ragged"), (3, 100, 2, 64, "none"),
               (20, 64, 19, 100, "wide"), (20, 10, 19, 37, "eval"),
               (20, 64, 19, 100, "unaligned"), (3, 100, 2, 256, "text"),
               (1, 100, 2, 256, "cycle")],
    "kl_bwd": [(300, 64, 300, None), (1280, 100, 1280, None), (37, 100, 37, None),
               (5, 3, 5, None)],
    # The MNIST and MultiMNIST train rows in every fold, CelebA's image and
    # attribute rows, D not a multiple of 4 (b-major), and more target rows
    # than a grid axis holds (65,535).
    "bce_bwd": [
        (200, 784, 100, kernels.FOLD_T),
        (300, 2500, 100, kernels.FOLD_T),
        (200, 784, 200, kernels.FOLD_NONE),
        (200, 784, 100, kernels.FOLD_B),
        (128, 12288, 64, kernels.FOLD_T),
        (21888, 1, 1152, kernels.FOLD_T),
        (36, 1002, 18, kernels.FOLD_B),
        (70000, 3, 70000, kernels.FOLD_NONE),
    ],
    # MultiMNIST's train shapes (the decode-all pass, a cycle re-read)
    # with pad runs; the synthetic CUB vocabulary; a large odd vocabulary;
    # S above the tokens a block runs at once; V just below a warp; a last
    # chunk with fewer examples than the others (7 a chunk); V at the
    # staged path's limit of 128 and just past it (a warp a token row).
    "seq_ce_bwd": [(300, 5, 13), (100, 5, 13), (4096, 32, 23), (2048, 8, 5003),
                   (3, 40, 1001), (5, 3, 31), (1000, 7, 13), (512, 9, 128), (512, 9, 129)],
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
                   (3, 100, 2, 100, "eval")],
}
# The (config, timed shape) each kernel's entry of the final line reports:
# this slice's path (MultiMNIST training) for the kernels it runs, else the
# path that runs the kernel.
_MM_TRAIN = ("multimnist_train", "multimnist_train")
REPORTED = {"kl": ("celeba", "celeba_eval"), "bce": _MM_TRAIN, "seq_ce": _MM_TRAIN,
            "conv": ("celeba", "celeba_eval"), "poe_kl": _MM_TRAIN,
            "kl_bwd": ("mnist_train", "mnist_train"), "bce_bwd": _MM_TRAIN,
            "seq_ce_bwd": _MM_TRAIN, "poe_kl_bwd": _MM_TRAIN}
_NO_BWD = {"kl_bwd": 0, "bce_bwd": 0, "seq_ce_bwd": 0, "poe_kl_bwd": 0}
EXPECTED_LAUNCHES = {
    "mnist": {"kl": 0, "bce": 20, "seq_ce": 0, "conv": 0, "poe_kl": 20, **_NO_BWD},
    "multimnist": {"kl": 0, "bce": 20, "seq_ce": 20, "conv": 0, "poe_kl": 20, **_NO_BWD},
    # 32 eval batches, each the fused PoE + KL once and K2 twice (image,
    # attributes); K4 once per eval batch and once per generate or sample
    # call.
    "celeba": {"kl": 0, "bce": 64, "seq_ce": 0, "conv": 37, "poe_kl": 32, **_NO_BWD},
    # 100 train steps, each the fused PoE + KL and K2 (the image's 2 member
    # terms) forward and backward once, then the 20 batches of the test
    # ELBO, forward only.
    "mnist_train": {"kl": 0, "bce": 120, "seq_ce": 0, "conv": 0, "poe_kl": 120,
                    "kl_bwd": 0, "bce_bwd": 100, "seq_ce_bwd": 0, "poe_kl_bwd": 100},
    # 20 train steps, each the fused PoE + KL 3 times (the loss, the cycle's
    # soft and hard re-reads), K2 once (the decode-all pass's images) and K3
    # 3 times (its text, each re-read), and every one's backward kernel as
    # often; then the 20 batches of the test ELBO, forward only (the fused
    # PoE + KL, K2 and K3 once each).
    "multimnist_train": {"kl": 0, "bce": 40, "seq_ce": 80, "conv": 0, "poe_kl": 80,
                         "kl_bwd": 0, "bce_bwd": 20, "seq_ce_bwd": 60, "poe_kl_bwd": 60},
}
# Names of the hand-written kernels' __global__ functions, to find them
# in a profile.
PORT_KERNELS = ("kl_rows_kernel", "bce_rows_kernel", "bce_split_kernel", "bce_thread_rows_kernel",
                "seq_ce_tokens_kernel", "conv_s2_tiles_kernel", "poe_kl_kernel",
                "kl_rows_grad_kernel", "bce_rows_grad_kernel", "seq_ce_grad_kernel",
                "seq_ce_grad_staged_kernel", "seq_ce_grad_warp_kernel", "poe_kl_bwd_kernel")
# The launch count each of them adds to: one wrapper call launches one of
# its kernels.
KERNEL_OP = {"kl_rows_kernel": "kl", "bce_rows_kernel": "bce", "bce_split_kernel": "bce",
             "bce_thread_rows_kernel": "bce", "seq_ce_tokens_kernel": "seq_ce",
             "conv_s2_tiles_kernel": "conv", "poe_kl_kernel": "poe_kl",
             "kl_rows_grad_kernel": "kl_bwd", "bce_rows_grad_kernel": "bce_bwd",
             "seq_ce_grad_kernel": "seq_ce_bwd", "seq_ce_grad_staged_kernel": "seq_ce_bwd",
             "seq_ce_grad_warp_kernel": "seq_ce_bwd", "poe_kl_bwd_kernel": "poe_kl_bwd"}
PAD = 0
# Replays (of 20 calls) or eager rounds a kernel timing takes the median of.
REPS = 25


START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a result line carries ``t_s``, its seconds since the
    start of the run."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def describe(op: str, shape) -> dict:
    if op == "conv":
        return {"shape": list(shape[:4]), "dtype": str(shape[4]).removeprefix("torch.")}
    if op in ("poe_kl", "poe_kl_bwd"):
        return {"shape": list(shape[:4]), "case": shape[4]}
    return {"shape": list(shape[:3]), "fold": shape[3] if len(shape) > 3 else None}


def inputs(op: str, shape, gen: torch.Generator):
    dev = gen.device
    if op == "kl":
        n, d = shape[:2]
        return (torch.randn(n, d, generator=gen, device=dev),
                torch.randn(n, d, generator=gen, device=dev))
    if op == "bce":
        n, d, n_x, fold = shape
        logits = 3.0 * torch.randn(n, d, generator=gen, device=dev)
        x = torch.rand(n_x, d, generator=gen, device=dev)
        return (logits, x, fold)
    if op == "conv":
        # As the probe draws them: image in [0, 1], weights N(0, 0.01).
        b, h, w, c, dtype = shape
        x = torch.rand(b, h, w, c, generator=gen, device=dev)
        weight = 0.1 * torch.randn(kernels.CONV_OUT, c, 4, 4, generator=gen, device=dev)
        bias = 0.1 * torch.randn(kernels.CONV_OUT, generator=gen, device=dev)
        return tuple(t.to(dtype) for t in (x, weight, bias))
    if op == "poe_kl":
        return poe_inputs(shape, gen)
    if op == "kl_bwd":
        return (*inputs("kl", shape, gen), torch.randn(shape[0], generator=gen, device=dev))
    if op == "bce_bwd":
        logits, x, fold = inputs("bce", shape, gen)
        return (logits, x, torch.randn(shape[0], generator=gen, device=dev), fold)
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
    # are all PAD.
    n, s, v = shape
    logits = 3.0 * torch.randn(n, s, v, generator=gen, device=dev)
    tokens = torch.randint(1, v, (n, s), generator=gen, device=dev, dtype=torch.int32)
    lengths = torch.randint(0, s + 1, (n,), generator=gen, device=dev)
    lengths[: max(1, n // 50)] = 0
    tokens[torch.arange(s, device=dev)[None, :] >= lengths[:, None]] = PAD
    return (logits, tokens, PAD)


def poe_inputs(shape, gen: torch.Generator):
    """Expert stack, subset masks and presence of the fused PoE + KL at
    (T, B, M, L). ``eval``: every modality present; ``ragged``: CelebA's
    padded last batch, rows from 16 on absent; ``none``: no presence mask;
    ``wide``: log-variances past the +-11 clamp; ``unaligned``: experts one
    element into their storage (scalar loads); ``text``: MultiMNIST's text
    expert (the last), its mean 0 and log-variance exactly +11 on the
    latter half of the dims; ``cycle``: the same experts under a cycle
    re-read's one mask, every expert but the last, and no presence."""
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
    if case == "cycle":
        masks = torch.ones(1, m, device=dev)
        masks[0, -1] = 0.0
    if masks.shape[0] != t:
        raise AssertionError(f"{m} experts give {masks.shape[0]} terms, not {t}")
    presence = torch.ones(b, m, device=dev)
    if case == "ragged":
        presence[16:] = 0.0
    return mu, lv, masks, None if case in ("none", "cycle") else presence


def parent_chain(*args):
    """The launches the eval ran before the fused kernel, as its step ran
    them: the mask product, ``core.product_of_experts``, then K1."""
    mu_f, lv_f = kernels.masked_poe_torch(*args)
    l = mu_f.shape[-1]
    return kernels.kl_std_normal_kernel(mu_f.reshape(-1, l), lv_f.reshape(-1, l))


KERNEL_FN = {"kl": kernels.kl_std_normal_kernel, "bce": kernels.bernoulli_nll_kernel,
             "seq_ce": kernels.masked_seq_ce_kernel, "conv": kernels.conv4x4s2_swish_kernel,
             "poe_kl": kernels.poe_kl_kernel, "kl_bwd": kernels.kl_rows_grad_kernel,
             "bce_bwd": kernels.bce_rows_grad_kernel,
             "seq_ce_bwd": kernels.masked_seq_ce_grad_kernel,
             "poe_kl_bwd": kernels.poe_kl_grad_kernel}
PLAIN_FN = {"kl": kernels.kl_std_normal_torch, "bce": kernels.bernoulli_nll_torch,
            "seq_ce": kernels.masked_seq_ce_torch, "conv": kernels.conv4x4s2_swish_torch,
            "poe_kl": kernels.poe_kl_torch, "kl_bwd": kernels.kl_rows_grad_torch,
            "bce_bwd": kernels.bce_rows_grad_torch,
            "seq_ce_bwd": kernels.masked_seq_ce_grad_torch,
            "poe_kl_bwd": kernels.poe_kl_grad_torch}


def library_fn(op: str, args):
    """A call of no arguments that runs one PyTorch call computing the
    same function on ``args``, or None. Timed as a yardstick; the port
    never calls it. What the library call needs in another form (tiled
    targets, an NCHW copy of the image) is made here, before the timing."""
    if op == "bce":
        logits, x, fold = args
        tiled = kernels.tile_rows(x, logits.shape[0], fold)
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
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        return lambda: F.silu(F.conv2d(x_nchw, weight, bias, stride=2, padding=1))
    if op in ("bce_bwd", "seq_ce_bwd", "poe_kl_bwd"):
        return autograd_backward(op, args)
    return None


def autograd_backward(op: str, args):
    """The library forward of ``op``'s function run with autograd on, and a
    call that runs only its backward on ``args``' output gradients (the
    graph is kept). Autograd runs a backward op on its forward op's stream,
    so this runs on the stream that will run the call (``graph_ms`` makes
    it there)."""
    if op == "bce_bwd":
        logits, x, g, fold = args
        leaves = (logits.detach().requires_grad_(True),)
        tiled = kernels.tile_rows(x, logits.shape[0], fold)
        outs = (F.binary_cross_entropy_with_logits(leaves[0], tiled, reduction="none").sum(-1),)
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
    atol per unit of the largest gradient."""
    if op in ("kl_bwd", "bce_bwd", "seq_ce_bwd"):
        return 1e-5, 1e-6
    if op == "poe_kl_bwd":
        return 1e-5, 1e-5 * shape[0]
    if op == "poe_kl":
        return 1e-5, 1e-5 * shape[3]
    if op == "conv":
        c, dtype = shape[3], shape[4]
        return (1e-5, 1e-5 * 16 * c) if dtype == torch.float32 else (0.0, 2e-2)
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
    if op == "conv":
        x, weight, bias = args
        b, h, w, c = x.shape
        n_out = b * kernels.CONV_OUT * -(-h // 2) * -(-w // 2)
        n_bytes = x.element_size() * (x.numel() + weight.numel() + bias.numel() + n_out)
        t_bytes = n_bytes / HBM_BYTES_PER_S
        t_ops = n_out * (2 * 16 * c + CONV_OPS_PER_OUT) / PEAK_OPS_PER_S[x.dtype]
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
    elif op in ("kl_bwd", "bce_bwd"):
        # The rows and their partner (lv or the untiled targets) and the
        # row gradients read, one (KL: two) (N, D) gradients written.
        n, d = args[0].shape
        n_elems = n * d
        n_bytes = 4 * (n * d + args[1].numel() + n + (2 if op == "kl_bwd" else 1) * n * d)
    else:
        n, d = args[0].shape
        n_elems = n * d
        n_bytes = 4 * (n * d + args[1].numel() + n)
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
        emit({"phase": "build", "seconds_all": seconds,
              "library": str(so.relative_to(ROOT)), "ptxas": ptxas})
    return kind


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
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {}
    for op, shapes in CHECKED_SHAPES.items():
        max_err[op] = 0.0
        for shape in shapes:
            args = inputs(op, shape, gen)
            got = KERNEL_FN[op](*args)
            want = PLAIN_FN[op](*args)
            torch.cuda.synchronize()
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
            max_err[op] = max(max_err[op], err)
            emit({"phase": "check", "kernel": META[op]["name"], **describe(op, shape),
                  "max_abs_err": err})
    return max_err


# ------------------------------------------------------------ phase 3 ----


def drive(config: str, calls) -> tuple[dict, dict[str, int]]:
    """``config``'s eval over its 2,000-example test split, then ``calls``
    (name -> function of the model), all with the "kernel" backend (every
    reduction runs in its kernel or raises) and the launch counts set to 0
    just before and read just after."""
    model = configs.build_model(config, seed=0)
    test = load_dataset(config, "test")
    if test.size != 2000:
        raise AssertionError(f"{config}: test split of {test.size}, not 2000")
    ops.set_backend("kernel")
    try:
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        elbo = api.eval_elbo(config, model=model, dataset=test)
        outs = {name: call(model) for name, call in calls.items()}
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        ops.set_backend("auto")
    emit({"phase": "main_path", "config": config, "eval_elbo": elbo, "launches": launches})

    ops.set_backend("torch")
    try:
        elbo_plain = api.eval_elbo(config, model=model, dataset=test)
    finally:
        ops.set_backend("auto")
    if kernels.LAUNCHES != launches:
        raise AssertionError("the torch backend launched a kernel")
    rel = abs(elbo - elbo_plain) / abs(elbo_plain)
    emit({"phase": "kernel_vs_torch_backend", "config": config, "eval_elbo_kernel": elbo,
          "eval_elbo_torch": elbo_plain, "rel": rel})
    if not rel <= 1e-5:
        raise AssertionError(f"{config}: kernel and torch backends differ: rel {rel}")
    return outs, launches


def check_image(img, n: int, hw: tuple[int, ...]) -> None:
    if img.shape != (n, *hw):
        raise AssertionError(f"bad image shape {tuple(img.shape)}")
    if not (torch.isfinite(img).all() and img.min() >= 0 and img.max() <= 1):
        raise AssertionError("generated image not finite or outside [0, 1]")


def check_text(text, n: int) -> None:
    """Digit strings: (n, 5) tokens below 13, PAD after the first STOP."""
    if text.shape != (n, 5) or text.min() < 0 or text.max() >= 13:
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


def card_vs_cpu(config: str, n: int, condition: dict, on_card: dict) -> None:
    """The eval on an ``n``-example split and ``generate`` at temperature 0
    from ``condition``, on the card and on the CPU, from the same seed:
    generated probabilities within 1e-4, tokens and labels equal."""
    model = configs.build_model(config, seed=0)
    cpu_model = configs.build_model(config, seed=0, device="cpu")
    small = load_dataset(config, "test", n=n)
    elbo_card = api.eval_elbo(config, model=model, dataset=small)
    elbo_cpu = api.eval_elbo(config, model=cpu_model, dataset=small, device="cpu")
    gen_cpu = api.generate(config, condition, model=cpu_model, device="cpu", temperature=0.0)
    rel = abs(elbo_card - elbo_cpu) / abs(elbo_cpu)
    kinds = cpu_model.decode_kinds()
    probs = [k for k in gen_cpu if kinds.get(k) == "bernoulli"]
    errs = {k: (on_card[k].cpu() - gen_cpu[k]).abs().max().item() for k in probs}
    emit({"phase": "card_vs_cpu", "config": config, "examples": n,
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
    return {"mnist": mnist, "multimnist": multimnist, "celeba": celeba}


def train_batches(n_steps: int, bs: int, device, seed: int = 0,
                  config: str = "mnist") -> dict[str, torch.Tensor]:
    """``n_steps`` batches of ``bs`` from the head of a seeded permutation of
    ``config``'s train split, stacked on ``device``."""
    train = load_dataset(config, "train", n=max(n_steps * bs, 100))
    perm = torch.randperm(train.size, generator=torch.Generator().manual_seed(seed))
    idx = perm[: n_steps * bs].numpy()
    return {k: torch.as_tensor(v[idx], device=device).reshape((n_steps, bs) + v.shape[1:])
            for k, v in train.arrays.items()}


def train_counted(cfg) -> tuple:
    """``api.train`` of ``cfg`` (seed 0) with the "kernel" backend and the
    launch counts set to 0 just before and read just after (the replays'
    launches included): the result, the counts and the wall."""
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
    expected = EXPECTED_LAUNCHES[f"{cfg.name}_train"]
    if launches != expected:
        raise AssertionError(f"{cfg.name}_train: expected launches {expected}, got {launches}")
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
    train_rate(cfg, 100, rounds=2, profiled_steps=20)
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
    name, bs = cfg.name, cfg.batch_size
    batches = train_batches(n_steps, bs, "cuda", seed=1, config=name)
    runners, first, runs = {}, {}, {}
    for kind in ("graph", "eager"):
        model = configs.build_model(cfg, seed=0)
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
    compared = graph_vs_eager(runs)
    emit({"phase": "train_graph_vs_eager", "config": name, "steps": n_steps, "batch": bs,
          "cudnn": "default algorithms", "gated": gate, **compared})
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
    emit({"phase": "train_rate", "config": name, "steps": n_steps, "batch": bs,
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
    emit({"phase": "train_graph_profile", "config": name, "steps": profiled_steps,
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
    emit({"phase": "train_step_profile", "config": name, "adam": "capturable",
          **profile_summary(lambda: step(state, batch))})
    if name == "mnist":
        # The same eager step with the CPU's Adam (not capturable, its step
        # counts on the host): what the capturable form costs on the device.
        plain = dataclasses.replace(state, optimizer=torch.optim.Adam(
            state.model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8))
        step(plain, batch)
        emit({"phase": "train_step_profile", "config": name, "adam": "plain",
              **profile_summary(lambda: step(plain, batch))})


def train_card_vs_cpu(n_steps: int = 3) -> None:
    """``n_steps`` of the ``mnist`` epoch runner on the card (the graph
    runner, its kernels) and on the CPU (the eager loop) from the same
    seeded weights, noise and batches, each at rel 1e-4 (CPU and card
    matmuls round differently; the card's Adam is the capturable one): the
    loss and the raw gradients' global norm each step (Adam would hide a
    gradient off by a constant factor; the norm does not), and every
    parameter tensor after, both its difference against its own 2-norm
    and against the 2-norm of its update over the run."""
    batches = train_batches(n_steps, 100, "cpu", seed=2)
    batches["eps"] = torch.randn((n_steps, 3, 100, 64), generator=torch.Generator().manual_seed(3))
    init = dict(configs.build_model("mnist", seed=0, device="cpu").named_parameters())
    runs = {}
    for dev in ("cuda", "cpu"):
        model = configs.build_model("mnist", seed=0, device=dev)
        state = create_train_state(model, 1e-3)
        runner = make_epoch_runner(model, annealing_steps=1000)
        _, metrics = runner(state, {k: v.to(dev) for k, v in batches.items()})
        runs[dev] = (*run_metrics(metrics),
                     {k: p.detach().cpu() for k, p in model.named_parameters()})
    (card_l, card_g, card_p), (cpu_l, cpu_g, cpu_p) = runs["cuda"], runs["cpu"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l)]
    grad_norm_rel = [abs(a - b) / abs(b) for a, b in zip(card_g, cpu_g)]
    param_rel = {k: ((card_p[k] - w).norm() / w.norm()).item() for k, w in cpu_p.items()}
    update_rel = {k: ((card_p[k] - w).norm() / (w - init[k]).norm()).item()
                  for k, w in cpu_p.items()}
    emit({"phase": "train_card_vs_cpu", "config": "mnist", "steps": n_steps,
          "card": "graph runner", "cpu": "eager loop",
          "loss_card": card_l, "loss_cpu": cpu_l, "loss_rel": loss_rel,
          "grad_norm_card": card_g, "grad_norm_cpu": cpu_g, "grad_norm_rel": grad_norm_rel,
          "param_rel_max": max(param_rel.values()), "update_rel_max": max(update_rel.values()),
          "update_rel_top": sorted(update_rel.items(), key=lambda kv: -kv[1])[:3],
          "param_max_abs_err": max((card_p[k] - w).abs().max().item() for k, w in cpu_p.items())})
    worst = max(max(loss_rel), max(grad_norm_rel), max(param_rel.values()),
                max(update_rel.values()))
    if not worst <= 1e-4:
        raise AssertionError(
            f"train: card and CPU differ: loss {loss_rel}, grad norm {grad_norm_rel}, "
            f"params {param_rel}, updates {update_rel}")


MULTIMNIST_TRAIN_SIZE = 2000  # one epoch of 20 steps of batch 100


def phase_multimnist_train() -> dict[str, int]:
    """``api.train`` of ``multimnist`` (cross-recon, the cycle term on both
    render forms, clipping at 500) for one epoch at full width over a train
    split cut to 2,000 examples on the graph runners (the launch counts
    through the replays, and the profiler's); then the graph against the
    eager loop (``train_rate``), a profiled step and the card against the
    CPU over three steps, where the graph is gated against the eager loop
    on cuDNN's deterministic algorithms."""
    cfg = configs.get_config("multimnist").replace(epochs=1, train_size=MULTIMNIST_TRAIN_SIZE)
    untrained = api.eval_elbo(cfg, model=configs.build_model(cfg, seed=0))
    result, launches, wall_s = train_counted(cfg)
    record = result.history[0]
    steps = MULTIMNIST_TRAIN_SIZE // cfg.batch_size
    emit({"phase": "train", "config": "multimnist", "epochs": 1, "steps": result.state.step,
          "train_size": MULTIMNIST_TRAIN_SIZE, "train_loss": record["train_loss"],
          "cycle_ce": record["cycle_ce"], "test_elbo": record["test_elbo"],
          "untrained_test_elbo": untrained, "api_train_wall_s": wall_s, "launches": launches})
    if result.state.step != steps or not all(map(math.isfinite, record.values())):
        raise AssertionError(f"multimnist train: {result.state.step} steps, history {record}")
    if not record["test_elbo"] < untrained:
        raise AssertionError(
            f"multimnist train: test ELBO {record['test_elbo']} not below the untrained "
            f"{untrained}")
    # cuDNN's default algorithms may sum in another order run to run: the
    # gate is the deterministic run of multimnist_card_vs_cpu.
    train_rate(cfg, steps, rounds=1, profiled_steps=5, gate=False)
    multimnist_card_vs_cpu(cfg)
    return launches


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
    batches["eps"] = torch.randn((n_steps, 3, bs, cfg.n_latents),
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

    card_renders, cpu_renders = [], []
    eager = run("cuda", True, card_renders)
    card = run("cuda", True, graph=True)
    repeat = run("cuda", True)
    default = run("cuda", False)
    cpu = run("cpu", False, cpu_renders, fed=card_renders)
    graph_eager = compare(card, eager)
    emit({"phase": "train_graph_vs_eager", "config": "multimnist", "steps": n_steps, "batch": bs,
          "cudnn": "deterministic algorithms", "gated": True, **graph_eager})
    if not max(max(graph_eager["loss_rel"]), max(graph_eager["grad_norm_rel"]),
               graph_eager["param_rel_max"]) <= 1e-6:
        raise AssertionError(f"multimnist: graph and eager steps differ: {graph_eager}")
    gated = compare(card, cpu)
    flips = [int(((a > 0.5) != (b > 0.5)).sum()) for a, b in zip(card_renders, cpu_renders)]
    margins = [(b - 0.5).abs().min().item() for b in cpu_renders]
    emit({"phase": "train_card_vs_cpu", "config": "multimnist", "steps": n_steps, "batch": bs,
          "card": "graph runner", "cpu": "eager loop",
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
            f"multimnist train: card and CPU differ: {gated}, render flips {flips}")


def phase_workdir() -> None:
    """``mnist`` at full width over a train split cut to 2,000 (20 steps an
    epoch) trained into a workdir for 2 epochs and resumed for a third,
    against an uninterrupted 3-epoch run (each epoch's train loss and test
    ELBO, and every parameter, rel 1e-6 on the card); ``eval_elbo`` from
    the workdir against the best epoch's recorded test ELBO (rel 1e-6);
    ``generate`` and ``sample`` from it."""
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
        with open(f"{tmp}/split/metrics.jsonl") as f:
            n_records = sum(1 for _ in f)
    emit({"phase": "workdir", "config": "mnist", "history": history,
          "uninterrupted_history": full.history, "history_rel_max": history_rel,
          "param_rel_max": param_rel, "eval_elbo_workdir": elbo, "best_test_elbo": best,
          "eval_elbo_rel": elbo_rel, "ckpt": listing, "metrics_records": n_records})
    if not (history_rel <= 1e-6 and param_rel <= 1e-6 and elbo_rel <= 1e-6 and n_records == 3
            and resumed.best_test_elbo == best):
        raise AssertionError(f"workdir: resumed run or workdir eval differ: history "
                             f"{history_rel}, params {param_rel}, eval {elbo_rel}")
    for out, n in ((gen, 3), (smp, 16)):
        check_image(out["image"], n, (28, 28))
        if not (out["label"].min() >= 0 and out["label"].max() < 10):
            raise AssertionError("generated label out of range")


# ------------------------------------------------------------ phase 4 ----


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


def phase_timings(launches: dict[str, dict[str, int]]) -> dict[str, dict]:
    gen = torch.Generator(device="cuda").manual_seed(1)
    reported = {}
    for op in OPS:
        for label, shape in TIMED_SHAPES[op].items():
            args = inputs(op, shape, gen)
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
                cold_ms(lambda a: library_fn(op, a), args, copies)
                if copies and has_lib else None)
            row["bound_ms"], row["bound_by"] = bound(op, args)
            if op == "poe_kl":
                row["parent_chain_ms"] = device_ms(lambda: parent_chain(*args))
                row["parent_chain_eager_ms"] = eager_ms(lambda: parent_chain(*args))
            emit({"phase": "timing", "kernel": META[op]["name"], "label": label,
                  **describe(op, shape), **row,
                  "launches_per_config": {c: n[op] for c, n in launches.items()}})
            if label == REPORTED[op][1]:
                reported[op] = row
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


def phase_eval_wall(config: str) -> None:
    """The eval of ``config``'s 2,000-example test split through a graph
    runner built once (as ``api.train`` keeps it) and through the eager
    loop, timed in turns (three each, to a sync); the graph's first call
    (one batch eager, the capture, the replays); ``api.eval_elbo``'s own
    wall, which captures anew each call; and a profile of each runner."""
    model = configs.build_model(config, seed=0)
    test = load_dataset(config, "test")
    batch_size = configs.get_config(config).batch_size
    stacked = api._padded_split(test, batch_size, model.n_modalities, torch.device("cuda"))
    runners = {"graph": make_eval_runner(model), "eager": make_eval_runner(model, graph=False)}
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
        api.eval_elbo(config, model=model, dataset=test)
        entry.append(1e3 * (time.perf_counter() - t0))
    emit({"phase": "eval_wall", "config": config, "examples": test.size,
          "batches": stacked["presence"].shape[0],
          "wall_ms_median": {k: statistics.median(v) for k, v in walls.items()},
          "wall_ms": walls, "first_call_ms": first, "eval_elbo_wall_ms": entry})
    for kind, runner in runners.items():
        summary = profile_summary(lambda: runner(stacked))
        busy = summary["device_busy_us"]
        emit({"phase": "eval_profile", "config": config, "runner": kind,
              "idle_share_unprofiled": (1 - busy / (1e3 * statistics.median(walls[kind]))
                                        if busy != "not measured" else busy),
              **summary})


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
    }


def main() -> None:
    seconds, t0 = {}, time.perf_counter()

    def timed(name: str, phase, *args):
        start = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - start
        return out

    kind = timed("device_and_build", phase_device)
    max_err = timed("check", phase_check)
    launches = timed("main_path", phase_main_path)
    launches["mnist_train"] = timed("train", phase_train)
    launches["multimnist_train"] = timed("multimnist_train", phase_multimnist_train)
    timed("workdir", phase_workdir)
    reported = timed("timings", phase_timings, launches)
    timed("launch_floor", phase_launch_floor)
    for config in CONFIGS:
        timed(f"eval_wall_{config}", phase_eval_wall, config)
    emit({"phase": "phase_seconds", **seconds, "total": time.perf_counter() - t0})
    emit({"kernels": [
        {**META[op], "launches": launches[REPORTED[op][0]][op],
         "config": REPORTED[op][0], "shape": REPORTED[op][1],
         "launches_per_config": {c: n[op] for c, n in launches.items()},
         "max_abs_err": max_err[op],
         "ms": reported[op]["kernel_ms"], "plain_ms": reported[op]["plain_ms"],
         "bound_ms": reported[op]["bound_ms"], "bound_by": reported[op]["bound_by"],
         "library_ms": reported[op]["library_ms"]}
        for op in OPS
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
