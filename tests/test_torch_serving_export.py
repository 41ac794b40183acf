"""The port's serving artifacts and their per-row draws, on the CPU.

The artifact's structure (``mmvae_torch/serving.py``): the header read
without deserializing the program, a wrong magic refused, a fresh process
that imports only ``mmvae_torch.serving`` loading and calling it, a
dynamic batch serving 1 and 5 rows, the platforms refused, a bf16 export
equal to ``api.generate(dtype=bf16)``, and the card asked for by default. The draws (``mmvae_torch/core/rowrng.py``):
Philox-4x32-10 against Random123's known answers and a pure-Python
Philox, a row's outputs independent of its batch position, a scalar seed
expanding to ``seed + arange(n)``, and tokens drawn at a temperature
following the softmax of fixed logits. Small MNIST and MultiMNIST models
(n_latents 8) from the port's seeded init; no JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmvae_torch import api, configs, serving
from mmvae_torch.core import rowrng
from mmvae_torch.core.rowrng import RowRng

ROOT = Path(__file__).resolve().parent.parent
B = 4
MNIST = configs.get_config("mnist").replace(n_latents=8)
MULTIMNIST = configs.get_config("multimnist").replace(
    n_latents=8, model_kwargs=dict(conv_features=(4, 8), text_embed=8, text_hidden=16,
                                   text_latent_dims=4))
HEADER_KEYS = {"config", "batch_size", "sample_z", "objective", "seed_mode", "modalities",
               "batch_modalities", "batch_shapes", "platforms", "device", "torch"}


@pytest.fixture(scope="module")
def mnist():
    return configs.build_model(MNIST, seed=0, device="cpu")


@pytest.fixture(scope="module")
def artifact(mnist, tmp_path_factory):
    """A static batch-B per-row MNIST artifact that draws z, and its
    ``(meta, call)`` on the CPU."""
    path = str(tmp_path_factory.mktemp("art") / "mnist.mmvaept")
    serving.export_generate(MNIST, path, batch_size=B, model=mnist, device="cpu", sample_z=True)
    return (path, *serving.load_generate(path, device="cpu"))


def _inputs(meta, n, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"image": rng.random((n, 28, 28)).astype(np.float32),
             "label": rng.integers(0, 10, n)}
    presence = rng.integers(0, 2, (n, len(meta["modalities"]))).astype(np.float32)
    return batch, presence


def test_header_is_read_without_deserializing(artifact, monkeypatch):
    path, meta, _ = artifact

    def refuse(*args, **kwargs):
        raise AssertionError("read_meta deserialized the program")

    monkeypatch.setattr(torch.export, "load", refuse)
    got = serving.read_meta(path)
    assert got == meta and set(got) == HEADER_KEYS
    assert got["config"] == "mnist" and got["batch_size"] == B
    assert got["platforms"] == ["cuda", "cpu"] and got["device"] == "cpu"
    assert got["seed_mode"] == "per_row" and got["sample_z"] is True
    assert got["modalities"] == ["image", "label"]
    assert got["batch_shapes"] == {"image": [[B, 28, 28], "float32"], "label": [[B], "int64"]}


def test_a_wrong_magic_is_refused(artifact, tmp_path):
    bad = tmp_path / "bad.mmvaept"
    bad.write_bytes(b"MMVAEXP1" + Path(artifact[0]).read_bytes()[8:])
    for load in (serving.read_meta, lambda p: serving.load_generate(p, device="cpu")):
        with pytest.raises(ValueError, match="not an mmvae_torch export artifact"):
            load(str(bad))


def test_loading_asks_for_the_card_unless_told_cpu(artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.load_generate(artifact[0])


def test_platforms_and_dtypes_the_port_cannot_serve_raise(mnist, tmp_path):
    """A platform the port cannot serve raises. bf16 experts export: the
    graph holds the casts to bf16, the inputs and outputs keep their types,
    and at temperature 0 the artifact on the CPU gives what
    ``api.generate(dtype=bf16)`` gives to rel 1e-6 (the same ops on the same
    inputs; ``tests/test_torch_serving.py`` holds it against the JAX program
    at bf16)."""
    path = str(tmp_path / "x.mmvaept")
    with pytest.raises(ValueError, match="cannot be served"):
        serving.export_generate(MNIST, path, model=mnist, device="cpu", platforms=("tpu",))
    assert serving._platforms(("gpu", "cpu", "cuda")) == ["cuda", "cpu"]
    model = configs.build_model(MNIST, seed=0, device="cpu")
    serving.export_generate(MNIST, path, batch_size=B, model=model, device="cpu",
                            dtype=torch.bfloat16)
    assert model.dtype == torch.float32  # the dtype held for the call alone
    meta, call = serving.load_generate(path, device="cpu")
    assert meta["batch_shapes"]["image"][1] == "float32"
    casts = [n for n in call.exported.graph.nodes
             if n.op == "call_function" and n.kwargs.get("dtype") == torch.bfloat16]
    assert casts
    batch, presence = _inputs(meta, B)
    want = api.generate(MNIST, {"image": batch["image"]}, model=model, device="cpu",
                        temperature=0.0, dtype=torch.bfloat16)
    presence[:] = [1.0, 0.0]
    got = call(batch, presence, temperature=0.0)
    assert got["image"].dtype == torch.float32
    torch.testing.assert_close(got["image"], want["image"], rtol=1e-6, atol=1e-6)
    assert torch.equal(got["label"], want["label"])


def test_a_fresh_process_loads_it_with_serving_alone(artifact):
    """Importing ``mmvae_torch.serving`` registers the ``mmvae`` ops: a
    process that imports nothing else loads and calls the artifact, and
    gets the bits this process gets."""
    path, meta, call = artifact
    batch, presence = _inputs(meta, B)
    want = call(batch, presence, seed=11, temperature=1.0)
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from mmvae_torch.serving import load_generate\n"
        f"meta, call = load_generate({path!r}, device='cpu')\n"
        "arrays = json.loads(sys.stdin.read())\n"
        "batch = {k: np.asarray(v) for k, v in arrays['batch'].items()}\n"
        "out = call(batch, np.asarray(arrays['presence'], np.float32), seed=11)\n"
        "assert not any(m.split('.')[0] in ('jax', 'mmvae_tpu') for m in sys.modules)\n"
        "print(json.dumps({k: v.tolist() for k, v in out.items()}))\n"
    )
    payload = json.dumps({"batch": {k: v.tolist() for k, v in batch.items()},
                          "presence": presence.tolist()})
    run = subprocess.run([sys.executable, "-c", code], input=payload, capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert run.returncode == 0, run.stderr
    got = json.loads(run.stdout.splitlines()[-1])
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k], v.numpy().dtype), v.numpy())


def test_a_dynamic_artifact_serves_1_and_5_rows(mnist, tmp_path):
    path = str(tmp_path / "dyn.mmvaept")
    serving.export_generate(MNIST, path, batch_size="dynamic", model=mnist, device="cpu")
    meta, call = serving.load_generate(path, device="cpu")
    assert meta["batch_size"] == "dynamic"
    assert meta["batch_shapes"]["image"] == [[None, 28, 28], "float32"]
    program = serving.make_generate_fn(mnist, per_row_seed=True)
    for n in (1, 5):
        batch, presence = _inputs(meta, n, seed=n)
        got = call(batch, presence, seed=3, temperature=0.0)
        with torch.no_grad():
            want = program({k: torch.as_tensor(v) for k, v in batch.items()},
                           torch.as_tensor(presence), 3 + torch.arange(n), torch.tensor(0.0))
        assert got["image"].shape == (n, 28, 28) and got["label"].shape == (n,)
        torch.testing.assert_close(got["image"], want["image"], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got["label"], want["label"])


def test_a_scalar_seed_expands_to_arange(artifact):
    _, meta, call = artifact
    batch, presence = _inputs(meta, B)
    a = call(batch, presence, seed=5, temperature=1.0)
    b = call(batch, presence, seed=np.arange(5, 5 + B), temperature=1.0)
    c = call(batch, presence, seed=6, temperature=1.0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["image"], c["image"])


def test_a_rows_outputs_do_not_depend_on_its_batch_position(artifact):
    """Row i at any position of a batch, beside any rows, gives the same
    bits: the artifact's z draw, and the text decode's Gumbel noise at
    temperature 1 (MultiMNIST's program, eager). The batch stays B rows:
    the CPU's products may round otherwise at another batch size."""
    _, meta, call = artifact
    batch, presence = _inputs(meta, B)
    seeds = np.array([7, 100, 3, 42])
    base = call(batch, presence, seed=seeds)
    perm = np.array([2, 0, 3, 1])
    other, other_presence = _inputs(meta, B, seed=9)
    other["image"][1], other["label"][1], other_presence[1] = (
        batch["image"][2], batch["label"][2], presence[2])
    moved = call({k: v[perm] for k, v in batch.items()}, presence[perm], seed=seeds[perm])
    mixed = call(other, other_presence, seed=np.array([1, seeds[2], 5, 6]))
    for k in base:
        assert torch.equal(moved[k], base[k][perm])
        assert torch.equal(mixed[k][1], base[k][2])

    model = configs.build_model(MULTIMNIST, seed=0, device="cpu")
    program = serving.make_generate_fn(model, sample_z=True, per_row_seed=True)
    text = torch.randint(3, 13, (2 * B, 5), generator=torch.Generator().manual_seed(0))
    images = torch.rand((2 * B, 50, 50), generator=torch.Generator().manual_seed(1))
    run = lambda idx, s: program({"image": images[idx], "text": text[idx]},  # noqa: E731
                                 torch.ones(len(idx), 2), torch.tensor(s), torch.tensor(1.0))
    with torch.no_grad():
        full = run([0, 1, 2, 3], [5, 6, 7, 8])
        moved = run([3, 2, 1, 0], [8, 7, 6, 5])
        mixed = run([4, 5, 2, 6], [1, 2, 7, 3])
    for k in full:
        assert torch.equal(moved[k][1], full[k][2]) and torch.equal(mixed[k][2], full[k][2])
    assert len({tuple(r) for r in full["text"].tolist()}) > 1


# --- the draws ---------------------------------------------------------------


def _philox_py(ctr, key, rounds=10):
    """Philox-4x32 in Python integers (Random123's ``philox4x32_R``)."""
    m0, m1, w0, w1, mask = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85, 0xFFFFFFFF
    c, k = list(ctr), list(key)
    for r in range(rounds):
        if r:
            k = [(k[0] + w0) & mask, (k[1] + w1) & mask]
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & mask, (p0 >> 32) ^ c[3] ^ k[1], p0 & mask]
    return c


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(ctr, key, want):
    assert tuple(_philox_py(ctr, key)) == want
    got = rowrng.philox4x32(*(torch.tensor(v, dtype=torch.int64) for v in (*ctr, *key)))
    assert tuple(int(w) for w in got) == want


def test_philox_matches_python_on_random_words():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(6, 64), dtype=np.uint64).astype(np.int64)
    got = torch.stack(rowrng.philox4x32(*torch.from_numpy(words)), 0)
    for j in range(words.shape[1]):
        want = _philox_py(words[:4, j].tolist(), words[4:, j].tolist())
        assert got[:, j].tolist() == want


def test_uniforms_normals_and_the_scalar_mode():
    rng = RowRng.from_seed(torch.arange(4000), 4000, per_row=True)
    u = rng.uniform(0, 64)
    assert 0 < u.min() and u.max() < 1 and abs(u.mean().item() - 0.5) < 0.01
    z = rng.normal(1, 63)
    assert z.shape == (4000, 63) and abs(z.mean().item()) < 0.01
    assert abs(z.std().item() - 1) < 0.01
    # A shared key: the rows differ through the row word of the counter.
    shared = RowRng.from_seed(torch.tensor(3), 5, per_row=False).bits(2, 9)
    assert len({tuple(r) for r in shared.tolist()}) == 5
    assert torch.equal(shared[2], RowRng(torch.tensor([[3]]), torch.tensor([[2]])).bits(2, 9)[0])
    # Prefetched streams give the words each stream gives alone.
    one = RowRng.from_seed(torch.tensor([9, -4]), 2, per_row=True)
    one.prefetch({0: 7, 2: 30})
    alone = RowRng.from_seed(torch.tensor([9, -4]), 2, per_row=True)
    assert torch.equal(one.bits(0, 7), alone.bits(0, 7))
    assert torch.equal(one.bits(2, 30), alone.bits(2, 30))


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_tokens_follow_the_softmax_of_their_logits(temperature):
    logits = torch.tensor([[1.0, 0.0, -1.0, 2.0, 0.5]])
    n = 20000
    rng = RowRng.from_seed(torch.arange(n), n, per_row=True)
    tokens = rowrng.categorical(logits.expand(n, -1), rng.gumbel(2, 5),
                                rowrng.temperature_terms(torch.tensor(temperature)))
    freq = torch.bincount(tokens, minlength=5).double() / n
    want = torch.softmax(logits[0].double() / temperature, -1)
    assert (freq - want).abs().max() < 0.015
    greedy = rowrng.categorical(logits.expand(n, -1), rng.gumbel(2, 5),
                                rowrng.temperature_terms(torch.tensor(0.0)))
    assert torch.all(greedy == 3)
