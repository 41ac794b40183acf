"""Which cuDNN setting holds a segmented eval to the bits of the whole one,
and at what IWAE wall, on one NVIDIA card.

    python3 eval_conv_algos.py [--f32] [SETTING ...]

With no setting the script runs every setting of SETTINGS, each in a
process of its own (cuDNN's plans are cached for a process), and prints
one JSON line a config and setting, also written to
``chiprun_out/eval_conv_algos[_f32].jsonl``. ``--f32`` turns cuDNN's TF32
off (``cudnn.allow_tf32``, as ``chip_smoke.py`` runs; PyTorch's default
lets cuDNN's convolutions round their inputs to TF32). The settings:

- ``default``: PyTorch's defaults (cuDNN's heuristic pick of a plan for
  each convolution, its nondeterministic engines allowed);
- ``benchmark``: ``cudnn.benchmark``, the fastest plan cuDNN finds for a
  convolution, kept for the process;
- ``deterministic``: ``cudnn.deterministic``, what ``api.eval_elbo`` and
  ``api.log_likelihood`` capture under (``api.deterministic_convs``);
- ``deterministic_benchmark``: both, the fastest deterministic plan.

For each config of CONFIGS, its test split (``test_size`` examples), the
model from seed 0 and one fixed IWAE noise (k = 64): the IWAE graph runner
(``train.make_iwae_runner``) captured under the setting, called twice
(``replay_equal``: two replays of one capture give the same bits), a
second runner captured the same way (``recapture_equal``), a third called
in segments of SEGMENTS batches as ``segment_steps`` calls it
(``segmented_equal``); the same three for the eval runner
(``train.make_eval_runner``, ``eval_*``); and the IWAE wall, the median of
WALL_CALLS calls of the first runner after its capture, each to a sync.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from mmvae_torch import api, configs
from mmvae_torch.data import load_dataset
from mmvae_torch.train import make_eval_runner, make_iwae_runner

SETTINGS = {"default": {}, "benchmark": {"benchmark": True},
            "deterministic": {"deterministic": True},
            "deterministic_benchmark": {"deterministic": True, "benchmark": True}}
CONFIGS = ("fashionmnist", "celeba", "cub", "mnist")
K = 64
SEGMENTS = 3
WALL_CALLS = 3
OUT = Path(__file__).resolve().parent / "chiprun_out"


@contextlib.contextmanager
def cudnn_flags(**flags):
    """``torch.backends.cudnn``'s ``flags`` while open, the caller's after."""
    saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)


def _values(runner, key: str, stacked: dict, segments: int = 0) -> torch.Tensor:
    device = next(iter(stacked.values())).device
    return api._split_values(runner, key, stacked, segments, device)


def probe(config: str, setting: str, device: str = "cuda", n: int | None = None) -> dict:
    """``config``'s row for ``setting`` (``n`` test examples, the config's
    ``test_size`` by default)."""
    cfg = configs.get_config(config)
    model = configs.build_model(cfg, seed=0, device=device)
    test = load_dataset(config, "test", n=n or cfg.test_size)
    cuda = torch.device(device)
    stacked = api._valid_split(test, cfg.batch_size, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    stacked["eps"] = torch.randn((*stacked["valid"].shape, K, model.n_latents),
                                 generator=g, device=cuda)
    evals = api._padded_split(test, cfg.batch_size, model.n_modalities, cuda)
    row = {"config": config, "setting": setting, "cudnn_tf32": torch.backends.cudnn.allow_tf32,
           "examples": test.size,
           "batches": stacked["valid"].shape[0], "k": K}
    with cudnn_flags(**SETTINGS[setting]):
        for name, make, key, data in (
                ("iwae", lambda: make_iwae_runner(model, K), "log_likelihood", stacked),
                ("eval", lambda: make_eval_runner(model, cfg.objective, cfg.mvtcae_alpha),
                 "loss", evals)):
            first = make()
            t0 = time.perf_counter()
            a = _values(first, key, data)
            row[f"{name}_first_call_ms"] = 1e3 * (time.perf_counter() - t0)
            b = _values(first, key, data)
            c = _values(make(), key, data)
            s = _values(make(), key, data, SEGMENTS)
            row[f"{name}_replay_equal"] = torch.equal(a, b)
            row[f"{name}_recapture_equal"] = torch.equal(a, c)
            row[f"{name}_segmented_equal"] = torch.equal(a, s)
            row[f"{name}_rows_differing_segmented"] = int((a != s).sum())
            row[f"{name}_sum"] = float(a.sum())
            row[f"{name}_sum_segmented"] = float(s.sum())
            if name == "iwae":
                walls = []
                for _ in range(WALL_CALLS):
                    t0 = time.perf_counter()
                    float(first(stacked)["log_likelihood"].sum())  # a sync
                    walls.append(1e3 * (time.perf_counter() - t0))
                row["iwae_wall_ms_median"], row["iwae_wall_ms"] = statistics.median(walls), walls
    return row


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("eval_conv_algos: torch.cuda.is_available() is false")
    f32 = argv[:1] == ["--f32"]
    argv = argv[f32:]
    torch.backends.cudnn.allow_tf32 = not f32
    if argv:
        for setting in argv:
            for config in CONFIGS:
                print(json.dumps(probe(config, setting)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    OUT.mkdir(exist_ok=True)
    with (OUT / f"eval_conv_algos{'_f32' if f32 else ''}.jsonl").open("w") as out:
        for setting in SETTINGS:
            run = subprocess.run([sys.executable, __file__, *["--f32"][:f32], setting],
                                 capture_output=True, text=True, check=True)
            for line in run.stdout.splitlines():
                out.write(line + "\n")
                print(line, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
