"""Times every launch layout of K2 (``bce_rows``), K3 (``seq_ce_rows``),
K4 (``conv4x4s2_swish``), the fused PoE + KL (``poe_kl``) and the
backward kernels of K2 (``bce_rows_grad``), K3 (``seq_ce_rows_grad``), the
fused PoE + KL (``poe_kl_bwd``) and K4 (``conv4x4s2_swish_bwd`` and its
input gradient ``conv4x4s2_swish_dx``) on one NVIDIA card, at the shapes
``chip_smoke.py`` times and checks.

    python3 kernel_plans.py [bce|seq_ce|conv|poe_kl|seq_ce_bwd|poe_kl_bwd|bce_bwd|conv_bwd|conv_dx ...]

``mmvae_torch/ops/kernels.py``'s ``bce_plan``, ``seq_ce_plan``,
``conv_plan``, ``poe_kl_plan``, ``bce_grad_plan``, ``seq_ce_grad_plan``
and ``poe_kl_bwd_plan`` pick a layout from the shape; this script shows
what the others would give (for K4: warps a block, and blocks an SM from
one to more than fit at once, or a warp for every unit; for the fused PoE +
KL: the terms of a batch row split over 1 to T blocks; for K2's VJP: 128
to 1,024 threads a block with the rule's lanes, a block a chunk of the
row and a power of two of lanes, at the path shapes and at D = 1 to 2,500
with 100 and 21,888 rows; for K3's VJP:
the staged path at 1 to 16 examples a block and every lane group, the
lane-group layout at the forward's lane groups and at a warp a token row,
and a warp a token row at 4 to 16 warps at 1 or 2 examples a chunk; for
the fused PoE + KL's backward: latent tiles of 4 to 256 in float4s and in
scalars, each at 3 block sizes; for K4's backward: tiles of 2 or 4
output rows, 4 or 8 warps a block and 1 to 4 blocks an SM, at CelebA's
train shape and at C = 1 and 4; for K4's input gradient: tiles of 1 to 8
output rows, 4, rows + 2 or 12 warps and 1 or 2 blocks an SM, at CUB's
train shape, at C = 1 and 4 and at an odd size). The arguments name the
kernels to time (all by default).
For each (kernel, shape, plan) it prints one JSON line: whether the plan
is the one the wrapper picks, the max abs error against the plain
version, whether two calls gave the same bits and whether the plan gave
the first plan's (every plan of K2's VJP and of K4's input gradient
computes each element alone, so they must), and the device time with the inputs in L2 (``ms``) and
L2-cold (``cold_ms``), beside the library call's and the bound, as
``chip_smoke.py`` times them. The lines are also written to
``chiprun_out/kernel_plans.jsonl``. Exits non-zero without a card or when
a plan disagrees with the plain version.
"""

from __future__ import annotations

import functools
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from mmvae_torch.ops import kernels as K

BCE_SHAPES = {
    "celeba_image": (128, 12288, 64, K.FOLD_T),
    "multimnist_eval": (200, 2500, 100, K.FOLD_T),
    "mnist_eval": (200, 784, 100, K.FOLD_T),
    "large": (8192, 784, 4096, K.FOLD_T),
    "celeba_attrs": (21888, 1, 1152, K.FOLD_T),
    "few_odd_rows": (16, 50001, 16, K.FOLD_NONE),
    "odd_d": (128, 12290, 128, K.FOLD_NONE),
    # Where a warp a row and a block a row cross over.
    **{f"rows_{n}_{d}": (n, d, n, K.FOLD_NONE)
       for n in (264, 528, 1056, 2112) for d in (784, 12288)},
}
SEQ_SHAPES = {
    "multimnist_eval": (200, 5, 13),
    "large": (2048, 8, 5003),
    "cub_synthetic": (4096, 32, 23),
    "ragged": (37, 7, 13),
    "long_odd": (3, 40, 1001),
    # Where a few lanes a token row and a warp a token row cross over.
    "vocab_48": (1024, 16, 48),
    "vocab_96": (1024, 16, 96),
    "vocab_200": (1024, 16, 200),
}
CONV_SHAPES = {
    "celeba_eval": (64, 64, 64, 3, torch.float32),
    "probe": (256, 64, 64, 3, torch.bfloat16),
    "ragged": (37, 64, 64, 3, torch.float32),
}
POE_SHAPES = {
    "celeba_eval": (20, 64, 19, 100, "eval"),
    "multimnist_eval": (3, 100, 2, 256, "eval"),
    "mnist_eval": (3, 100, 2, 64, "eval"),
}
SEQ_BWD_SHAPES = {
    "multimnist_train": (300, 5, 13),
    "multimnist_cycle": (100, 5, 13),
    "cub_synthetic": (4096, 32, 23),
    "large": (2048, 8, 5003),
    # Where the staged path and a warp a token row cross over.
    "vocab_64": (2048, 16, 64),
    "vocab_128": (1024, 16, 128),
    "vocab_256": (1024, 16, 256),
}
BCE_BWD_SHAPES = {
    "mnist_train": (200, 784, 100, K.FOLD_T),
    "multimnist_train": (300, 2500, 100, K.FOLD_T),
    "celeba_image": (128, 12288, 64, K.FOLD_T),
    "celeba_attrs": (21888, 1, 1152, K.FOLD_T),
    # Where the lanes and the rows a block cross over.
    **{f"rows_{n}_{d}": (n, d, n, K.FOLD_NONE)
       for d in (1, 3, 13, 64, 784, 2500) for n in (100, 21888)},
    "rows_100_1_t": (100, 1, 50, K.FOLD_T),
}
CONV_BWD_SHAPES = {
    "celeba_train": (64, 64, 64, 3),
    "c1": (64, 64, 64, 1),
    "c4": (64, 64, 64, 4),
}
CONV_DX_SHAPES = {
    "cub_train": (64, 64, 64, 3),
    "c1": (64, 64, 64, 1),
    "c4": (64, 64, 64, 4),
    "odd": (3, 33, 31, 3),
}
POE_BWD_SHAPES = {
    "mnist_train": (3, 100, 2, 64, "eval"),
    "multimnist_train": (3, 100, 2, 256, "text"),
    "multimnist_cycle": (1, 100, 2, 256, "cycle"),
    "celeba_eval": (20, 64, 19, 100, "eval"),
}


def bce_plans(n: int, d: int, sms: int) -> list[K.BcePlan]:
    plans = [K.BcePlan(K.BCE_WARP, 256, 1, min(-(-n // 8), 4096))]
    if d <= 64:
        plans += [K.BcePlan(K.BCE_THREAD, t, 1, min(-(-n // t), 4096)) for t in (128, 256, 512)]
    else:
        plans += [K.BcePlan(K.BCE_SPLIT, t, s, n * s)
                  for s in (1, 2, 4, 8) if s == 1 or n * s <= 8 * sms
                  for t in (128, 256, 512, 1024)]
    auto = K.bce_plan(n, d, sms)
    return plans if auto in plans else plans + [auto]


def seq_plans(n: int, s: int, v: int, sms: int) -> list[K.SeqCePlan]:
    plans = [K.SeqCePlan(lanes, max(1, min(warps, -(-s * lanes // 32))), n)
             for lanes in (1, 2, 4, 8, 16, 32) if lanes * 16 >= v or lanes == 32
             for warps in sorted({8, 32 if n < sms else 8})]
    auto = K.seq_ce_plan(n, s, v, sms)
    plans = list(dict.fromkeys(plans))
    return plans if auto in plans else plans + [auto]


def conv_plans(b: int, h: int, w: int, c: int, sms: int) -> list[K.ConvPlan]:
    units = K.conv_units(b, h, w)
    plans = [K.conv_plan(b, h, w, c, sms, blocks_per_sm, warps)
             for warps in (2, 4, 8) for blocks_per_sm in (1, 2, 4, 8)]
    plans += [K.conv_plan(b, h, w, c, sms, units, warps) for warps in (4, 8)]
    auto = K.conv_plan(b, h, w, c, sms)
    plans = list(dict.fromkeys(plans))
    return plans if auto in plans else plans + [auto]


def poe_plans(t: int, b: int, m: int, l: int, sms: int) -> list[K.PoeKlPlan]:
    plans = [K.poe_kl_plan(t, b, m, l, sms, groups)
             for groups in (1, 2, 3, 4, 5, 10, 20) if groups <= t]
    plans = list(dict.fromkeys(plans))
    auto = K.poe_kl_plan(t, b, m, l, sms)
    return plans if auto in plans else plans + [auto]


def seq_bwd_plans(n: int, s: int, v: int, sms: int) -> list[K.SeqCeGradPlan]:
    plans = []
    if K.seq_ce_grad_smem(1, s, v) <= K.SEQ_GRAD_MAX_SMEM:
        for examples in (1, 2, 4, 8, 16):
            if examples > n or K.seq_ce_grad_smem(examples, s, v) > K.SEQ_GRAD_MAX_SMEM:
                continue
            for lanes in (1, 2, 4, 8, 16, 32):
                if lanes > 2 * v:
                    continue
                warps = max(1, min(K.SEQ_GRAD_MAX_WARPS, -(-examples * s * lanes // 32)))
                plans.append(K.SeqCeGradPlan(K.SEQ_GRAD_STAGED, lanes, examples, warps,
                                             -(-n // examples)))
    fwd = K.seq_ce_plan(n, s, v, sms)
    for lanes in sorted({fwd.lanes, min(32, 1 << max(0, v - 1).bit_length()), 32}):
        warps = max(1, min(K.SEQ_GRAD_MAX_WARPS, -(-s * lanes // 32)))
        plans.append(K.SeqCeGradPlan(K.SEQ_GRAD_GROUPS, lanes, 1, warps, n))
    for warps in (4, 8, 16):
        for examples in (1, 2):
            chunks = -(-n // examples)
            for blocks in sorted({chunks, min(chunks, 2 * sms)}):
                plans.append(K.SeqCeGradPlan(K.SEQ_GRAD_WARP, 32, examples, warps, blocks))
    auto = K.seq_ce_grad_plan(n, s, v, sms)
    plans = list(dict.fromkeys(plans))
    return plans if auto in plans else plans + [auto]


def bce_bwd_plans(n: int, d: int, n_x: int) -> list[K.BceGradPlan]:
    pow2 = 1 << max(0, K.bce_grad_units(d) - 1).bit_length()
    plans = [K.bce_grad_plan(n, d, n_x, threads, lanes)
             for threads in (128, 256, 512, 1024)
             for lanes in (None, threads, min(pow2, threads))]
    auto = K.bce_grad_plan(n, d, n_x)
    plans = list(dict.fromkeys(plans))
    return plans if auto in plans else plans + [auto]


def poe_bwd_plans(t: int, b: int, m: int, l: int, sms: int) -> list[K.PoeKlBwdPlan]:
    auto = K.poe_kl_bwd_plan(t, b, m, l, sms)
    plans = []
    for tile in sorted({4, 8, 16, 32, 64, 128, 256, auto.tile}):
        if tile > -(-l // 4) * 4 or K.poe_kl_bwd_smem(t, m, tile) > K.POE_MAX_SMEM:
            continue
        for vec in (0, 1):
            base = K.poe_kl_bwd_plan(t, b, m, l, sms, tile=tile, vec=vec)
            for threads in sorted({base.threads, 64, 256}):
                plans.append(base._replace(threads=threads))
    plans = list(dict.fromkeys(plans))
    return plans if auto in plans else plans + [auto]


def conv_bwd_plans(b: int, h: int, w: int, c: int, sms: int) -> list[K.ConvBwdPlan]:
    plans = [K.conv_bwd_plan(b, h, w, c, sms, rows, warps, blocks_per_sm)
             for rows in (2, 4) for warps in (4, 8) for blocks_per_sm in (1, 2, 3, 4)]
    auto = K.conv_bwd_plan(b, h, w, c, sms)
    plans = list(dict.fromkeys(plans))
    return plans if auto in plans else plans + [auto]


def conv_dx_plans(b: int, h: int, w: int, c: int, sms: int) -> list[K.ConvDxPlan]:
    plans = [K.conv_dx_plan(b, h, w, c, sms, rows, warps, blocks_per_sm)
             for rows in (1, 2, 4, 6, 8)
             for warps in sorted({4, min(rows + 2, K.CONV_DX_MAX_WARPS), K.CONV_DX_MAX_WARPS})
             for blocks_per_sm in (1, 2)]
    auto = K.conv_dx_plan(b, h, w, c, sms)
    plans = list(dict.fromkeys(plans))
    return plans if auto in plans else plans + [auto]


def auto_plan(op: str, shape, sms: int):
    if op == "bce":
        return K.bce_plan(shape[0], shape[1], sms)
    if op == "seq_ce":
        return K.seq_ce_plan(*shape, sms)
    if op == "conv":
        return K.conv_plan(*shape[:4], sms)
    if op == "poe_kl":
        return K.poe_kl_plan(*shape[:4], sms)
    if op == "seq_ce_bwd":
        return K.seq_ce_grad_plan(*shape, sms)
    if op == "bce_bwd":
        return K.bce_grad_plan(*shape[:3])
    if op == "conv_bwd":
        return K.conv_bwd_plan(*shape, sms)
    if op == "conv_dx":
        return K.conv_dx_plan(*shape, sms)
    return K.poe_kl_bwd_plan(*shape[:4], sms)


def agrees(op: str, shape, got, want) -> bool:
    """The tolerance ``chip_smoke.py`` holds each kernel to: the fused PoE
    + KL's posteriors at atol 1e-6, its KL at ``tolerance``; its
    backward's atol per unit of the largest gradient."""
    rtol, atol = cs.tolerance(op, shape)
    if op == "poe_kl":
        atols = (1e-6, 1e-6, atol)
    elif op == "poe_kl_bwd":
        atols = tuple(atol * w.abs().max().item() for w in want)
    else:
        atols = (atol,) * len(want)
    return all(torch.allclose(g, w, rtol=rtol, atol=a) for g, w, a in zip(got, want, atols))


def outputs(got):
    """A kernel's outputs as a tuple (the fused PoE + KL gives three)."""
    return got if isinstance(got, tuple) else (got,)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_plans: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wanted = sys.argv[1:] or ["bce", "seq_ce", "conv", "poe_kl", "seq_ce_bwd", "poe_kl_bwd",
                              "bce_bwd", "conv_bwd", "conv_dx"]
    K.build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out_path = Path(cs.ROOT) / "chiprun_out" / "kernel_plans.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    lines, bad = [], []
    cases = [("bce", label, shape, bce_plans(shape[0], shape[1], sms))
             for label, shape in BCE_SHAPES.items()]
    cases += [("seq_ce", label, shape, seq_plans(*shape, sms))
              for label, shape in SEQ_SHAPES.items()]
    cases += [("conv", label, shape, conv_plans(*shape[:4], sms))
              for label, shape in CONV_SHAPES.items()]
    cases += [("poe_kl", label, shape, poe_plans(*shape[:4], sms))
              for label, shape in POE_SHAPES.items()]
    cases += [("seq_ce_bwd", label, shape, seq_bwd_plans(*shape, sms))
              for label, shape in SEQ_BWD_SHAPES.items()]
    cases += [("poe_kl_bwd", label, shape, poe_bwd_plans(*shape[:4], sms))
              for label, shape in POE_BWD_SHAPES.items()]
    cases += [("bce_bwd", label, shape, bce_bwd_plans(*shape[:3]))
              for label, shape in BCE_BWD_SHAPES.items()]
    cases += [("conv_bwd", label, shape, conv_bwd_plans(*shape, sms))
              for label, shape in CONV_BWD_SHAPES.items()]
    cases += [("conv_dx", label, shape, conv_dx_plans(*shape, sms))
              for label, shape in CONV_DX_SHAPES.items()]
    for op, label, shape, plans in cases:
        if op not in wanted:
            continue
        args = cs.inputs(op, shape, gen)
        want = cs.PLAIN_FN[op](*args)
        # An autograd backward is made on the stream that captures it, so
        # the library call is made inside graph_ms, as chip_smoke.py does.
        has_lib = cs.library_fn(op, args) is not None
        copies = cs.cold_copies(args)
        common = {
            "kernel": cs.META[op]["name"], "label": label, **cs.describe(op, shape),
            "library_ms": cs.graph_ms(lambda: [cs.library_fn(op, args)] * 20)
            if has_lib else None,
            "library_cold_ms": cs.cold_ms(lambda a: cs.library_fn(op, a), args, copies)
            if copies and has_lib else None,
            "bound_ms": cs.bound(op, args)[0], "cold_copies": copies,
        }
        auto = auto_plan(op, shape, sms)
        first = None
        for plan in plans:
            call = functools.partial(cs.KERNEL_FN[op], *args, plan=plan)
            got = outputs(call())
            torch.cuda.synchronize()
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, outputs(want)))
            if not agrees(op, shape, got, outputs(want)):
                bad.append((op, label, plan))
            again = outputs(call())
            first = first or got
            line = {
                **common, "plan": plan._asdict(), "picked": plan == auto,
                "max_abs_err": err,
                "same_bits": all(torch.equal(g, a) for g, a in zip(got, again)),
                "bits_of_first_plan": all(torch.equal(g, f) for g, f in zip(got, first)),
                "ms": cs.device_ms(call),
                "cold_ms": cs.cold_ms(
                    lambda a: functools.partial(cs.KERNEL_FN[op], *a, plan=plan), args, copies)
                if copies else None,
            }
            lines.append(line)
            print(json.dumps(line), flush=True)
        del args, want
    out_path.write_text("".join(json.dumps(line) + "\n" for line in lines))
    if bad:
        raise SystemExit(f"kernel_plans: plans disagree with the plain version: {bad}")


if __name__ == "__main__":
    main()
