"""The serving path's custom ops and artifacts on the card.

The ``mmvae`` ops' CUDA registrations (K4 and the fused PoE + KL) against
their CPU registrations (the plain versions), one launch each; a program
exported on the card that holds both ops and launches both kernels,
against ``api.generate`` on the card; and a static per-row artifact that
coalesces rows to the bit through the host's ``Batcher``. Tests marked
``gpu`` skip without a card. This file imports nothing of JAX, so on a
machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_card.py

Tolerance as in ``tests/test_torch_kernels.py``: rtol 1e-5 and atol 1e-5
* 16 * C for K4 in f32, rtol 1e-5 and atol 1e-6 for the fused posteriors
and 1e-5 * L for their KL (the kernels sum in another order); TF32 off.
The artifact against ``api.generate`` on the card: both launch the same
kernels on the same weights, so rel 1e-6.
"""

import threading

import numpy as np
import pytest
import torch

from mmvae_torch import api, configs, serving
from mmvae_torch.ops import kernels
from mmvae_torch.serve import Batcher

pytestmark = pytest.mark.gpu

CELEBA = configs.get_config("celeba").replace(
    n_latents=16, model_kwargs=dict(image_hw=(32, 32), conv_features=(32, 16)))
MNIST = configs.get_config("mnist").replace(n_latents=16)


@pytest.fixture
def cuda():
    """The card, with TF32 off for cuDNN and matmuls, so that the plain
    versions compute in f32 as the kernels do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _launches(fn):
    before = dict(kernels.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}


@pytest.mark.parametrize("shape", [(8, 64, 64, 3), (5, 33, 31, 3), (2, 16, 70, 1), (3, 9, 9, 4)])
def test_conv_op_cuda_against_cpu(cuda, shape):
    gen = torch.Generator().manual_seed(0)
    c = shape[-1]
    args = (torch.rand(shape, generator=gen), 0.2 * torch.randn((32, c, 4, 4), generator=gen),
            0.1 * torch.randn((32,), generator=gen))
    got, launched = _launches(
        lambda: torch.ops.mmvae.conv4x4s2_swish(*(a.to(cuda) for a in args)))
    assert launched == {"conv": 1}
    want = torch.ops.mmvae.conv4x4s2_swish(*args)
    assert got.is_contiguous() and got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5 * 16 * c)


@pytest.mark.parametrize("shape", [(1, 8, 2, 64), (1, 8, 19, 100), (3, 5, 4, 7), (1, 1, 2, 256)])
@pytest.mark.parametrize("with_presence", [True, False])
def test_poe_kl_op_cuda_against_cpu(cuda, shape, with_presence):
    t, b, m, l = shape
    gen = torch.Generator().manual_seed(1)
    mu, lv = torch.randn((b, m, l), generator=gen), 3 * torch.randn((b, m, l), generator=gen)
    lv[0, 0, :2] = torch.tensor([11.0, -14.0])
    masks = (torch.rand((t, m), generator=gen) > 0.3).float()
    presence = None
    if with_presence:
        presence = (torch.rand((b, m), generator=gen) > 0.5).float()
        presence[-1] = 0.0
    args = (mu, lv, masks, presence)
    got, launched = _launches(lambda: torch.ops.mmvae.poe_kl(
        *(None if a is None else a.to(cuda) for a in args)))
    assert launched == {"poe_kl": 1}
    want = torch.ops.mmvae.poe_kl(*args)
    for g, w, atol in zip(got, want, (1e-6, 1e-6, 1e-5 * l)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=atol)
    if with_presence:
        assert all(torch.all(g[:, -1] == 0) for g in got)


def test_export_on_the_card_holds_and_launches_both_ops(cuda, tmp_path):
    model = configs.build_model(CELEBA, seed=0)
    path = str(tmp_path / "celeba.mmvaept")
    serving.export_generate(CELEBA, path, batch_size=4, model=model)
    meta, call = serving.load_generate(path)
    assert meta["device"] == "cuda"
    targets = {str(n.target) for n in call.exported.graph.nodes if n.op == "call_function"}
    assert {"mmvae.poe_kl.default", "mmvae.conv4x4s2_swish.default"} <= targets
    attrs = (torch.rand((4, 18), generator=torch.Generator().manual_seed(2)) > 0.5).float()
    batch = {"image": torch.zeros((4, 32, 32, 3)), "attrs": attrs}
    presence = torch.cat([torch.zeros(4, 1), torch.ones(4, 18)], 1)
    got, launched = _launches(lambda: call(batch, presence, temperature=0.0))
    assert launched == {"poe_kl": 1, "conv": 1}
    want = api.generate(CELEBA, {"attrs": attrs}, model=model, temperature=0.0)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7)


def test_a_static_artifact_coalesces_to_the_bit_on_the_card(cuda, tmp_path):
    model = configs.build_model(MNIST, seed=0)
    path = str(tmp_path / "mnist.mmvaept")
    serving.export_generate(MNIST, path, batch_size=8, model=model, sample_z=True)
    meta, call = serving.load_generate(path)
    shapes = {k: (tuple(v[0]), np.dtype(v[1])) for k, v in meta["batch_shapes"].items()}
    rng = np.random.default_rng(0)
    requests = []
    for i, n in enumerate((1, 3, 2)):
        batch = {"image": rng.random((n, 28, 28)).astype(np.float32),
                 "label": rng.integers(0, 10, n)}
        requests.append((batch, rng.integers(0, 2, (n, 2)).astype(np.float32),
                         10 * i + np.arange(n)))
    batcher = Batcher(call, shapes, 2, static_batch=8, max_wait_ms=500)
    results = [None] * len(requests)

    def submit(i):
        batch, presence, seeds = requests[i]
        results[i] = batcher.submit(batch, presence, seeds, 1.0, len(seeds))

    try:
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        batcher.close(timeout=60)
    assert batcher.stats["device_calls"] == 1 and batcher.stats["coalesced_calls"] == 1
    for (batch, presence, seeds), got in zip(requests, results):
        n = len(seeds)
        pad = lambda a: np.concatenate([a, np.zeros((8 - n,) + a.shape[1:], a.dtype)])  # noqa: E731
        alone = call({k: pad(v) for k, v in batch.items()}, pad(presence), seed=pad(seeds),
                     temperature=1.0)
        for k, v in alone.items():
            np.testing.assert_array_equal(got[k], v[:n].cpu().numpy())


def _coalesced(batcher, requests):
    """Each request's reply, all submitted at once through ``batcher``."""
    results = [None] * len(requests)

    def submit(i):
        batch, presence, seeds = requests[i]
        results[i] = batcher.submit(batch, presence, seeds, 1.0, len(seeds))

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(requests))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    return results


def test_a_dynamic_artifact_coalesces_to_the_bit_on_the_card(cuda, tmp_path):
    """On the card the host calls a dynamic artifact at ``max_batch`` rows
    always, so one request served alone, then coalesced with 7 and with 63
    strangers (one call each), gives the same bits; a request of more rows
    than ``max_batch`` goes out as several calls of it."""
    model = configs.build_model(MNIST, seed=0)
    path = str(tmp_path / "mnist_dynamic.mmvaept")
    serving.export_generate(MNIST, path, batch_size="dynamic", model=model, sample_z=True)
    meta, call = serving.load_generate(path)
    shapes = {k: (tuple(v[0]), np.dtype(v[1])) for k, v in meta["batch_shapes"].items()}
    rng = np.random.default_rng(1)

    def request(n, first_seed):
        batch = {"image": rng.random((n, 28, 28)).astype(np.float32),
                 "label": rng.integers(0, 10, n)}
        return batch, rng.integers(0, 2, (n, 2)).astype(np.float32), first_seed + np.arange(n)

    target = request(1, 5)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        replies = []
        for strangers in (0, 7, 63):
            batcher = Batcher(call, shapes, 2, static_batch=None, max_batch=64, max_wait_ms=500)
            try:
                requests = [target] + ([request(strangers, 100)] if strangers else [])
                replies.append(_coalesced(batcher, requests)[0])
            finally:
                batcher.close(timeout=60)
            assert batcher.stats["device_calls"] == 1
            assert batcher.stats["padded_rows"] == 63 - strangers
        for other in replies[1:]:
            assert set(other) == set(replies[0])
            for k in replies[0]:
                np.testing.assert_array_equal(other[k], replies[0][k])
        big = request(100, 7)
        batcher = Batcher(call, shapes, 2, static_batch=None, max_batch=64, max_wait_ms=1)
        try:
            (got,) = _coalesced(batcher, [big])
        finally:
            batcher.close(timeout=60)
        assert batcher.stats["device_calls"] == 2 and batcher.stats["padded_rows"] == 28
        assert all(v.shape[0] == 100 for v in got.values())
    finally:
        torch.backends.cudnn.deterministic = saved
