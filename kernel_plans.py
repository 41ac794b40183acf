"""Times every launch layout of K2 (``bce_rows``), K3 (``seq_ce_rows``)
and K4 (``conv4x4s2_swish``) on one NVIDIA card, at the shapes
``chip_smoke.py`` times and checks.

    python3 kernel_plans.py [bce|seq_ce|conv ...]

``mmvae_torch/ops/kernels.py``'s ``bce_plan``, ``seq_ce_plan`` and
``conv_plan`` pick a layout from the shape; this script shows what the
others would give (for K4: warps a block, and blocks an SM from one to
more than fit at once, or a warp for every unit). The arguments name the
kernels to time (all by default).
For each (kernel, shape, plan) it prints one JSON line: whether the plan
is the one the wrapper picks, the max abs error against the plain
version, whether two calls gave the same bits, and the device time with
the inputs in L2 (``ms``) and L2-cold (``cold_ms``), beside the library
call's and the bound, as ``chip_smoke.py`` times them. The lines are also
written to ``chiprun_out/kernel_plans.jsonl``. Exits non-zero without a
card or when a plan disagrees with the plain version.
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_plans: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wanted = sys.argv[1:] or ["bce", "seq_ce", "conv"]
    K.build("row_reduce", "seq_ce", "conv_s2")
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
    for op, label, shape, plans in cases:
        if op not in wanted:
            continue
        args = cs.inputs(op, shape, gen)
        want = cs.PLAIN_FN[op](*args)
        lib = cs.library_fn(op, args)
        copies = cs.cold_copies(args)
        common = {
            "kernel": cs.META[op]["name"], "label": label, **cs.describe(op, shape),
            "library_ms": cs.device_ms(lib),
            "library_cold_ms": cs.cold_ms(lambda a: cs.library_fn(op, a), args, copies)
            if copies else None,
            "bound_ms": cs.bound(op, args)[0], "cold_copies": copies,
        }
        auto = (K.bce_plan(shape[0], shape[1], sms) if op == "bce"
                else K.seq_ce_plan(*shape, sms) if op == "seq_ce"
                else K.conv_plan(*shape[:4], sms))
        for plan in plans:
            call = functools.partial(cs.KERNEL_FN[op], *args, plan=plan)
            got = call()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rtol, atol = cs.tolerance(op, shape)
            if not torch.allclose(got, want, rtol=rtol, atol=atol):
                bad.append((op, label, plan))
            line = {
                **common, "plan": plan._asdict(), "picked": plan == auto,
                "max_abs_err": err, "same_bits": bool(torch.equal(got, call())),
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
