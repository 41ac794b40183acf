"""The port's HTTP serving host (``mmvae_torch/serve.py``) and the CLI's
``export``, on the CPU.

The ``Batcher`` coalesces concurrent requests into one call, each request
getting the bits it gets alone, and splits them by temperature; a dynamic
artifact is called at power-of-two batches on the CPU and at one batch,
``max_batch``, on the card; a scalar-seed artifact is
served a request a call; the JSON and npz wire formats give equal outputs;
malformed requests get 400 and failures of the program 500; ``python -m
mmvae_torch.cli export`` writes an artifact that gives ``api.generate``'s
outputs. A small MNIST (n_latents 8) from the port's seeded init; no JAX.
"""

import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

from mmvae_torch import api, configs, serving
from mmvae_torch.cli import main
from mmvae_torch.serve import Batcher, make_handler, make_server
from torch_threads import _one_torch_thread  # noqa: F401

B = 4
MNIST = configs.get_config("mnist").replace(n_latents=8)


@pytest.fixture(scope="module")
def model():
    return configs.build_model(MNIST, seed=0, device="cpu")


@pytest.fixture(scope="module")
def exported(model, tmp_path_factory):
    """Artifacts that draw z: ``"static"`` (batch B, per-row seeds),
    ``"dynamic"`` and ``"scalar"`` (batch B, one seed)."""
    root = tmp_path_factory.mktemp("art")
    paths = {}
    for name, kw in (("static", {}), ("dynamic", dict(batch_size="dynamic")),
                     ("scalar", dict(seed_mode="scalar"))):
        paths[name] = str(root / f"{name}.mmvaept")
        serving.export_generate(MNIST, paths[name], model=model, device="cpu", sample_z=True,
                                **{"batch_size": B, **kw})
    return paths


@pytest.fixture(scope="module")
def static(exported):
    return serving.load_generate(exported["static"], device="cpu")


def _shapes(meta):
    return {k: (tuple(v[0]), np.dtype(v[1])) for k, v in meta["batch_shapes"].items()}


def _request(n, seed):
    rng = np.random.default_rng(seed)
    batch = {"image": rng.random((n, 28, 28)).astype(np.float32),
             "label": rng.integers(0, 10, n).astype(np.int64)}
    presence = rng.integers(0, 2, (n, 2)).astype(np.float32)
    return batch, presence, 100 * seed + np.arange(n, dtype=np.int64)


def _alone(call, batch, presence, seeds, temperature, alloc=B):
    """A request's rows served alone: padded with zero rows to ``alloc``."""
    n = len(seeds)
    pad = lambda a: np.concatenate([a, np.zeros((alloc - n,) + a.shape[1:], a.dtype)])  # noqa: E731
    out = call({k: pad(v) for k, v in batch.items()}, pad(presence), seed=pad(seeds),
               temperature=temperature)
    return {k: v[:n].numpy() for k, v in out.items()}


def test_batcher_coalesces_exactly_and_splits_by_temperature(static):
    meta, call = static
    calls = []

    def logged(batch, presence, seed, temperature):
        calls.append((len(seed), temperature))
        return call(batch, presence, seed=seed, temperature=temperature)

    batcher = Batcher(logged, _shapes(meta), 2, static_batch=B, max_wait_ms=500)
    requests = [(*_request(n, i), t) for i, (n, t) in enumerate([(1, 1.0), (2, 1.0), (1, 0.5)])]
    results = [None] * len(requests)

    def submit(i):
        batch, presence, seeds, t = requests[i]
        results[i] = batcher.submit(batch, presence, seeds, t, len(seeds))

    try:
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        batcher.close(timeout=60)
    assert sorted(t for _, t in calls) == [0.5, 1.0], calls
    assert batcher.stats["device_calls"] == 2 and batcher.stats["coalesced_calls"] == 1
    assert batcher.stats["requests"] == 3 and batcher.stats["rows"] == 4
    assert batcher.stats["padded_rows"] == 2 * B - 4
    for (batch, presence, seeds, t), got in zip(requests, results):
        want = _alone(call, batch, presence, seeds, t)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_dynamic_buckets():
    dyn = Batcher(None, {}, 2, static_batch=None, max_batch=64)
    fixed = Batcher(None, {}, 2, static_batch=8)
    try:
        assert [dyn._alloc(n) for n in (1, 2, 3, 5, 9, 33, 64, 65)] == [
            1, 2, 4, 8, 16, 64, 64, 65]
        assert {fixed._alloc(n) for n in (1, 3, 8)} == {8} and fixed.max_batch == 8
    finally:
        dyn.close(timeout=10)
        fixed.close(timeout=10)


def test_a_dynamic_artifact_on_the_card_takes_one_batch(exported):
    """Where the call runs on the card, a dynamic artifact is called at
    ``max_batch`` rows always: a group padded to it, a request of more rows
    cut into calls of it; each request's rows as served alone at that
    batch. (The artifact runs on the CPU here; the Batcher is told the
    card.)"""
    meta, call = serving.load_generate(exported["dynamic"], device="cpu")
    sizes = []

    def logged(batch, presence, seed, temperature):
        sizes.append(len(seed))
        return call(batch, presence, seed=seed, temperature=temperature)

    batcher = Batcher(logged, _shapes(meta), 2, static_batch=None, max_batch=8,
                      max_wait_ms=1, device="cuda")
    assert {batcher._alloc(n) for n in (1, 5, 8, 20)} == {8}
    try:
        small, big = _request(3, 0), _request(19, 1)
        got_small = batcher.submit(*small, 1.0, 3)
        got_big = batcher.submit(*big, 1.0, 19)
    finally:
        batcher.close(timeout=60)
    assert sizes == [8, 8, 8, 8]
    assert batcher.stats["device_calls"] == 4 and batcher.stats["padded_rows"] == 5 + 5
    want = _alone(call, *small, 1.0, alloc=8)
    for k in want:
        np.testing.assert_array_equal(got_small[k], want[k])
    for i in range(0, 19, 8):
        part = _alone(call, {k: v[i:i + 8] for k, v in big[0].items()}, big[1][i:i + 8],
                      big[2][i:i + 8], 1.0, alloc=8)
        for k in part:
            np.testing.assert_array_equal(got_big[k][i:i + 8], part[k])


class _Host:
    """A server on a free port, serving from a thread."""

    def __init__(self, server):
        self.server = server
        self.port = server.server_address[1]
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.getheader("Content-Type"), resp.read()
        finally:
            conn.close()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


@pytest.fixture
def host(exported):
    hosts = []

    def start(name, **kw):
        server, meta, batcher = make_server(exported[name], 0, device="cpu", **kw)
        hosts.append((_Host(server), batcher))
        return hosts[-1][0], meta, batcher

    yield start
    for h, batcher in hosts:
        h.close()
        if batcher is not None:
            batcher.close(timeout=30)


@pytest.mark.parametrize("name", ["static", "dynamic"])
def test_json_and_npz_give_equal_outputs(host, static, name):
    h, meta, batcher = host(name, max_wait_ms=1)
    assert batcher is not None
    status, _, body = h.request("GET", "/meta")
    assert status == 200 and json.loads(body) == meta
    label = [3, 5, 7]
    status, _, body = h.request("POST", "/generate", json.dumps(
        {"condition": {"label": label}, "seed": 4, "temperature": 1.0}))
    assert status == 200
    reply = json.loads(body)
    assert reply["n"] == 3 and set(reply["outputs"]) == {"image", "label"}
    buf = io.BytesIO()
    np.savez(buf, label=np.asarray(label), seed=np.int64(4), temperature=np.float32(1.0))
    status, ctype, body = h.request("POST", "/generate", buf.getvalue())
    assert status == 200 and ctype == "application/x-npz"
    with np.load(io.BytesIO(body)) as z:
        npz = {k: z[k] for k in z.files}
    assert int(npz.pop("n")) == 3
    for k, v in npz.items():
        np.testing.assert_array_equal(np.asarray(reply["outputs"][k], v.dtype), v)
    # The reply is what the artifact gives these rows alone.
    _, call = static
    presence = np.tile(np.float32([0, 1]), (3, 1))
    batch = {"image": np.zeros((3, 28, 28), np.float32), "label": np.asarray(label)}
    want = _alone(call, batch, presence, 4 + np.arange(3), 1.0)
    for k, v in want.items():
        np.testing.assert_array_equal(npz[k], v)
    status, _, body = h.request("GET", "/stats")
    stats = json.loads(body)
    assert stats["batching"] == "on" and stats["requests"] == 2 and stats["rows"] == 6


def test_a_scalar_seed_artifact_is_served_a_request_a_call(host, exported):
    h, meta, batcher = host("scalar")
    assert batcher is None and meta["seed_mode"] == "scalar"
    status, _, body = h.request("GET", "/stats")
    assert json.loads(body) == {"batching": "off"}
    status, _, body = h.request("POST", "/generate", json.dumps(
        {"condition": {"label": [1, 2]}, "seed": 9}))
    assert status == 200
    out = json.loads(body)["outputs"]
    meta, call = serving.load_generate(exported["scalar"], device="cpu")
    batch = {"image": np.zeros((B, 28, 28), np.float32), "label": np.asarray([1, 2, 0, 0])}
    presence = np.float32([[0, 1], [0, 1], [0, 0], [0, 0]])
    want = call(batch, presence, seed=9, temperature=1.0)
    np.testing.assert_array_equal(np.asarray(out["image"], np.float32), want["image"][:2].numpy())


def test_request_validation_is_400_and_program_failures_500(host, static):
    h, meta, _ = host("static", max_wait_ms=1)
    bad = [
        b"not json",
        json.dumps([1, 2]).encode(),
        json.dumps({"condition": {"voice": [1]}}).encode(),
        json.dumps({"condition": {"label": [1, 2], "image": np.zeros((3, 28, 28)).tolist()}}),
        json.dumps({"condition": {"label": list(range(B + 1))}}).encode(),
        json.dumps({"condition": {"image": [[1.0, 2.0]]}}).encode(),
        json.dumps({"condition": {"label": [1]}, "seed": "x"}).encode(),
        b"PK-not-a-zip",
    ]
    for body in bad:
        status, _, reply = h.request("POST", "/generate", body)
        assert status == 400, (body[:40], reply)
        assert "error" in json.loads(reply)
    assert h.request("GET", "/nowhere")[0] == 404
    assert h.request("POST", "/elsewhere", b"{}")[0] == 404

    def broken(*args, **kwargs):
        raise RuntimeError("device lost")

    handler = make_handler(meta, broken)
    from http.server import ThreadingHTTPServer

    h2 = _Host(ThreadingHTTPServer(("127.0.0.1", 0), handler))
    try:
        status, _, reply = h2.request("POST", "/generate", json.dumps(
            {"condition": {"label": [1]}}))
        assert status == 500 and "device lost" in json.loads(reply)["error"]
    finally:
        h2.close()


def test_cli_export_round_trips_and_gives_api_generate(model, tmp_path, capsys):
    path = str(tmp_path / "cli.mmvaept")
    assert main(["export", "--config", "mnist", "--n-latents", "8", "--device", "cpu",
                 "--out", path, "--batch-size-export", "3", "--platforms", "gpu,cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["written"] == path and printed["platforms"] == ["cuda", "cpu"]
    meta, call = serving.load_generate(path, device="cpu")
    assert meta["batch_size"] == 3 and meta["seed_mode"] == "per_row"
    labels = np.asarray([3, 5, 7])
    batch = {"image": np.zeros((3, 28, 28), np.float32), "label": labels}
    got = call(batch, np.float32([[0, 1]] * 3), temperature=0.0)
    want = api.generate(MNIST, {"label": labels}, model=model, device="cpu", temperature=0.0)
    torch.testing.assert_close(got["image"], want["image"], rtol=1e-6, atol=1e-7)
    assert torch.equal(got["label"], want["label"])
    with pytest.raises(ValueError, match="cannot be served"):
        main(["export", "--config", "mnist", "--n-latents", "8", "--device", "cpu",
              "--out", path, "--platforms", "cpu,tpu"])
