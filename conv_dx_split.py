"""Splits the time of K4's input gradient (``conv4x4s2_swish_dx``) on one
NVIDIA card, for the kernel in ``mmvae_torch/ops/csrc/conv_s2.cu`` and for
its first form, f32 on the CUDA cores (``conv_dx_cuda_cores.cu``).

    python3 conv_dx_split.py

Builds each source with one part compiled but never run (a loop whose
condition also asks for a negative size), and times each build at CUB's
train shape (64, 64, 64, 3): the call replayed in a CUDA graph (median of
15 replays of 20 calls, in L2) and the kernel's device time from the
profiler. The differences to ``full`` are what each part costs:

- ``no_recompute``: pre not formed (CUDA cores: no window loads and no
  FMAs; tensor cores: no product 1), S from constants;
- ``no_gather``: S formed but dx not (CUDA cores: no gather; tensor
  cores: no product 2 and no fold);
- ``no_fold`` (tensor cores): product 2 runs, the fold into dx does not;
- ``no_g``: g not read, constants in its place;
- ``empty``: no tile at all (CUDA cores: the weights staged and nothing
  else; tensor cores: the launch, the weights and the first tile's copy).

Both ``full`` builds are timed first and again last. Prints one JSON line
each and writes them to ``chiprun_out/conv_dx_split.jsonl``. Exits
non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from mmvae_torch.ops import kernels as K

SHAPE = (64, 64, 64, 3)
CORES_SRC = Path(__file__).resolve().parent / "conv_dx_cuda_cores.cu"

# (needle, replacement) pairs of each part, per source; each needle must be
# found exactly once.
CORES = {
    "no_recompute": [
        ("        const bool ok = iy >= 0 && iy < h && ix >= 0 && ix < wd;\n",
         "        const bool ok = h < 0;\n"),
        ("      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n#pragma unroll\n"
         "      for (int k = 0; k < kTaps * C; ++k) {",
         "      float a[4] = {0.5f, 0.25f, -0.5f, 1.0f};\n#pragma unroll\n"
         "      for (int k = 0; k < kTaps * C && h < 0; ++k) {"),
    ],
    "no_gather": [
        ("  for (int qd = threadIdx.x; qd < rows * kDxTileW; qd += blockDim.x) {",
         "  for (int qd = threadIdx.x; qd < rows * kDxTileW && h < 0; qd += blockDim.x) {"),
    ],
    "no_g": [
        ("        s[e] = __ldg(gp + o * so) * dswish(a[e] + __ldg(bias + o));",
         "        s[e] = 0.5f * dswish(a[e] + __ldg(bias + o));"),
    ],
    "empty": [
        ("  for (int p = threadIdx.x; p < s_pixels; p += blockDim.x) {",
         "  for (int p = threadIdx.x; p < s_pixels && h < 0; p += blockDim.x) {"),
        ("  for (int qd = threadIdx.x; qd < rows * kDxTileW; qd += blockDim.x) {",
         "  for (int qd = threadIdx.x; qd < rows * kDxTileW && h < 0; qd += blockDim.x) {"),
    ],
}
_FOLD = ("  for (int p0 = tid; p0 < n_px; p0 += 2 * nthreads) {",
         "  for (int p0 = tid; p0 < n_px && h < 0; p0 += 2 * nthreads) {")
TENSOR = {
    "no_recompute": [
        ("      float pre[2][4][4] = {};\n#pragma unroll\n"
         "      for (int ks = 0; ks < KS; ++ks) {",
         "      float pre[2][4][4] = {};\n#pragma unroll\n"
         "      for (int ks = 0; ks < KS && tiles < 0; ++ks) {"),
    ],
    "no_gather": [
        ("      for (int mp = 0; mp < MT; mp += kPass) {",
         "      for (int mp = 0; mp < MT && tiles < 0; mp += kPass) {"),
        _FOLD,
    ],
    "no_fold": [_FOLD],
    "no_g": [
        ("            gv[mi][hf][nt][0] = ok ? __ldg(gp + 8 * nt * so) : 0.0f;\n"
         "            gv[mi][hf][nt][1] = ok ? __ldg(gp + (8 * nt + 1) * so) : 0.0f;\n",
         "            gv[mi][hf][nt][0] = ok ? 0.5f : 0.0f;\n"
         "            gv[mi][hf][nt][1] = ok ? -0.25f : 0.0f;\n"),
    ],
    "empty": [
        ("  for (; t < tiles; t += gridDim.x) {\n"
         "    asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n"
         "    __syncthreads();  // this tile's input has landed",
         "  for (; t < tiles && tiles < 0; t += gridDim.x) {\n"
         "    asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n"
         "    __syncthreads();  // this tile's input has landed"),
    ],
}


def variant(src: str, parts: list[tuple[str, str]]) -> str:
    """``src`` with each needle replaced; raises if one is not found once."""
    for needle, repl in parts:
        if src.count(needle) != 1:
            raise SystemExit(f"conv_dx_split: the source no longer has {needle[:60]!r} once")
        src = src.replace(needle, repl)
    return src


def build(out: Path, sources: dict[str, str]) -> None:
    """``nvcc`` of each source into ``out``, started together."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"conv_dx_split: nvcc {name} failed:\n{err}")


def load_tensor(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in K._SIGNATURES["conv_s2"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.conv_s2_error_string.argtypes = [ctypes.c_int]
    lib.conv_s2_error_string.restype = ctypes.c_char_p
    return lib


def cores_call(path: Path, args):
    """A call of the first form with its own plan: 128 threads, tiles of 4
    output rows, one block a tile."""
    lib = ctypes.CDLL(str(path))
    fn = lib.conv_dx_cuda_cores
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x, w, b, g = args
    batch, h, wd, c = x.shape
    rows = 4
    smem = 4 * (K.CONV_OUT * 16 * c + (rows + 2) * 34 * 36)
    out = torch.empty_like(x)

    def call():
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), *g.stride(),
                out.data_ptr(), batch, h, wd, c, 128, rows, smem,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"conv_dx_split: conv_dx_cuda_cores launch failed ({rc})")
        return out
    return call


def kernel_us(call) -> float | str:
    """The dx kernel's mean device time over 20 calls, from the profiler."""
    prof = cs.profile_summary(lambda: [call() for _ in range(20)])
    found = [k for k in prof["top"] if re.search(r"conv_s2_dx_kernel", k["name"])]
    return found[0]["device_us"] / found[0]["count"] if found else "not measured"


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("conv_dx_split: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = K.BUILD_DIR / "conv_dx_split"
    tensor_src = K.SOURCES["conv_s2"].read_text()
    cores_src = CORES_SRC.read_text()
    sources = {"tensor_full": tensor_src, "cores_full": cores_src}
    sources.update({f"tensor_{n}": variant(tensor_src, p) for n, p in TENSOR.items()})
    sources.update({f"cores_{n}": variant(cores_src, p) for n, p in CORES.items()})
    build(out, sources)
    lines = []

    def emit(obj):
        obj = {**obj, "device": smi}
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(1)
    args = cs.inputs("conv_dx", SHAPE, gen)
    want = K.conv4x4s2_swish_input_grad_torch(*args)
    plan = K.conv_dx_plan(*SHAPE, torch.cuda.get_device_properties(0).multi_processor_count)
    order = (["tensor_full", "cores_full"] + [f"tensor_{n}" for n in TENSOR]
             + [f"cores_{n}" for n in CORES] + ["cores_full", "tensor_full"])
    for name in order:
        if name.startswith("tensor"):
            K._libs["conv_s2"] = load_tensor(out / f"{name}.so")

            def call():
                return K.conv4x4s2_swish_input_grad_kernel(*args, plan=plan)
            line = {"kernel": "tensor", "plan": plan._asdict()}
        else:
            call = cores_call(out / f"{name}.so", args)
            line = {"kernel": "cores", "plan": {"threads": 128, "rows": 4}}
        got = call()
        torch.cuda.synchronize()
        if name.endswith("full"):
            rtol, atol = cs.tolerance("conv_dx", SHAPE)
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        emit({**line, "part": name.split("_", 1)[1], "shape": list(SHAPE),
              "graph_us": 1e3 * cs.device_ms(call), "kernel_us": kernel_us(call)})
    K._libs.pop("conv_s2")
    path = Path(cs.ROOT) / "chiprun_out" / "conv_dx_split.jsonl"
    path.parent.mkdir(exist_ok=True)
    path.write_text("".join(json.dumps(line) + "\n" for line in lines))


if __name__ == "__main__":
    main()
