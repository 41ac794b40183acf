"""Times the fused PoE + KL forward (``poe_kl``) of this tree against the
one of another checkout, in turns on one NVIDIA card, at every shape of
``chip_smoke.py``'s ``TIMED_SHAPES["poe_kl"]`` and at a slab above 48 KB
(``large_slab``, (41, 8, 40, 200), where the other checkout may refuse
it: then only this tree is timed).

    python3 poe_kl_ab.py --parent DIR [--pairs N] [--out NAME]

``DIR`` holds another checkout of the repository (for instance the parent
commit, unpacked with ``git archive``); its ``mmvae_torch/ops/kernels.py``
is loaded as a module of its own, builds its own ``poe_kl.cu`` into
``DIR/mmvae_torch/_build/`` and plans its own launches. At each shape both
versions run on the same inputs: their outputs are held against the plain
version (``chip_smoke.py``'s tolerance), then each is timed as
``chip_smoke.py`` times a kernel -- CUDA-graph replay of 20 calls, the
median of 15 replays, in L2, and L2-cold over copies of the inputs -- in
``N`` pairs (2 by default), parent then this tree in even pairs and the
other way round in odd ones. Prints the card's ``nvidia-smi`` line, one
JSON line per shape (both plans, every time of each version in L2 and
cold, the bound, and whether this tree's slowest time stays within the
other's range plus its spread, max + (max - min), in L2 and cold) and
writes them to ``chiprun_out/NAME`` (``poe_kl_ab.jsonl``). Exits non-zero
without a card or when a version disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from mmvae_torch.ops import kernels as K

EXTRA_SHAPES = {"large_slab": (41, 8, 40, 200, "eval")}


def load_parent(root: Path):
    """``root``'s ``mmvae_torch/ops/kernels.py`` as the module
    ``parent_kernels``."""
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", root / "mmvae_torch" / "ops" / "kernels.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def times(call, args, copies: int) -> tuple[float, float | None]:
    """``call``'s device time in L2 and L2-cold, as ``chip_smoke.py``
    times a kernel."""
    warm = cs.device_ms(functools.partial(call, *args))
    cold = cs.cold_ms(lambda a: functools.partial(call, *a), args, copies) if copies else None
    return warm, cold


def within_spread(change: list[float], parent: list[float]) -> bool | None:
    """Whether the slowest of ``change`` stays within ``parent``'s range
    plus that range's spread."""
    if not change or not parent or None in change or None in parent:
        return None
    return max(change) <= 2 * max(parent) - min(parent)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True)
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--out", default="poe_kl_ab.jsonl")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("poe_kl_ab: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    parent = load_parent(opts.parent.resolve())
    parent.build("poe_kl")
    K.build("poe_kl")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1)
    out_path = Path(cs.ROOT) / "chiprun_out" / opts.out
    out_path.parent.mkdir(exist_ok=True)
    lines, bad = [], []
    for label, shape in {**cs.TIMED_SHAPES["poe_kl"], **EXTRA_SHAPES}.items():
        (t, b, m, l) = shape[:4]
        args = cs.inputs("poe_kl", shape, gen)
        want = K.poe_kl_torch(*args)
        versions = {"change": K.poe_kl_kernel}
        try:
            parent_plan = parent.poe_kl_plan(t, b, m, l, sms)._asdict()
            versions["parent"] = parent.poe_kl_kernel
        except ValueError as exc:  # a shape the other checkout refuses
            parent_plan = str(exc)
        errs = {}
        for name, call in versions.items():
            got = call(*args)
            torch.cuda.synchronize()
            try:
                errs[name] = cs.check_poe_kl(args, got, want, shape)
            except AssertionError as exc:
                bad.append((label, name, str(exc)[:200]))
        copies = cs.cold_copies(args)
        runs = {"parent": [], "change": []}
        for i in range(opts.pairs):
            for name in ("parent", "change") if i % 2 == 0 else ("change", "parent"):
                if name in versions:
                    runs[name].append(times(versions[name], args, copies))
        line = {
            "kernel": "poe_kl", "label": label, **cs.describe("poe_kl", shape),
            "nvidia_smi": smi, "pairs": opts.pairs,
            "plan": K.poe_kl_plan(t, b, m, l, sms)._asdict(), "parent_plan": parent_plan,
            "ms": [w for w, _ in runs["change"]], "cold_ms": [c for _, c in runs["change"]],
            "parent_ms": [w for w, _ in runs["parent"]],
            "parent_cold_ms": [c for _, c in runs["parent"]],
            "within_spread": within_spread([w for w, _ in runs["change"]],
                                           [w for w, _ in runs["parent"]]),
            "cold_within_spread": within_spread([c for _, c in runs["change"]],
                                                [c for _, c in runs["parent"]]),
            "bound_ms": cs.bound("poe_kl", args)[0], "max_abs_err": errs,
        }
        lines.append(line)
        print(json.dumps(line), flush=True)
    out_path.write_text("".join(json.dumps(line) + "\n" for line in lines))
    if bad:
        raise SystemExit(f"poe_kl_ab: outputs disagree with the plain version: {bad}")


if __name__ == "__main__":
    main()
