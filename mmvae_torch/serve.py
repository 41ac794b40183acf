"""Serving host for an exported generation artifact, with dynamic batching.

    python -m mmvae_torch.serve model.mmvaept [port] [--max-batch 64]
                                [--max-wait-ms 5] [--no-batch] [--device cpu]

The port's own copy of the JAX package's host (``tools/serve.py``), which
it does not import. It loads a ``python -m mmvae_torch.cli export``
artifact (``mmvae_torch/serving.py``) on the card, or on ``--device``, and
serves it over HTTP with the stdlib and torch alone:

  GET  /meta      -> the artifact's JSON interface header
  GET  /stats     -> batching counters (requests, device calls, rows)
  POST /generate  -> body {"condition": {<modality>: [...], ...},
                           "seed": 0, "temperature": 1.0}
                     -> {"outputs": {<modality>: nested lists}, "n": n}

Wire formats, as the reference host's: JSON (above) or npz. An npz POST
body (found by the zip magic or ``Content-Type: application/x-npz``)
carries each condition modality as an array and optional 0-d ``seed`` and
``temperature``; the reply is an npz of the output arrays and ``n``
whenever the request was npz (or ``Accept: application/x-npz`` asks for
it), JSON otherwise. Both go through the same validation and the same
batcher, so their outputs are equal to the bit.

Conditioning is ``api.generate``'s: the modalities in ``condition`` are
observed (their experts enter the fusion), the others are generated. A
stacked key (CelebA's ``attrs``) observes all its experts, and each of
its columns (``attr_3``) may be given alone. Requests are padded to a
static artifact's batch and the padding is stripped from the reply.

Dynamic batching: concurrent requests are coalesced into ONE call of the
program (up to a static artifact's batch, or ``--max-batch`` rows for a
dynamic one, waiting at most ``--max-wait-ms`` for more). Coalescing is
exact -- each request gets what it would get alone -- because a
``seed_mode="per_row"`` artifact makes row i's output a function of row
i's data, presence and seed and of the temperature alone, not of its
batch position (``serving.make_generate_fn``). A request with seed s and
n rows takes row seeds s..s+n-1, the expansion ``load_generate`` applies.
Requests coalesce only at equal ``temperature`` (one scalar a call). On
the card exactness also needs calls that repeat to the bit, so
:func:`main` selects cuDNN's deterministic algorithms, and it needs ONE
batch a call: at another batch cuBLAS and cuDNN pick other algorithms,
which sum in another order, so the same row served at batch 1, 8 and 64
differs in its last bits (up to 1.19e-7 in MNIST's image on an H100), and
a reply would depend on the strangers it was coalesced with. So on the
card a dynamic artifact is called at ``--max-batch`` rows always (a group
padded to it, a larger request cut into calls of it): a request of one
row costs a call of ``max_batch``. On the CPU, where a row's output does
not depend on the batch, a dynamic artifact is called at power-of-two
batches, so that a host sees few distinct shapes. A direct ``call`` of a
dynamic artifact at another batch may differ from the host's replies in
the last bit. A static artifact always runs at its batch. A scalar-seed
artifact serves one request a call (coalescing would change its draws);
``/stats`` says which mode is live.
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

__all__ = ["ClientError", "Batcher", "make_handler", "make_server", "main"]

# Names the npz wire format takes for itself: the request's scalars and the
# reply's row count.
RESERVED = ("seed", "temperature", "n")


class ClientError(ValueError):
    """A malformed request (bad payload shape or keys): HTTP 400.

    Raised only by request parsing; a failure of the program (the device,
    memory) raises what it raises and is a 500."""


def _npz_payload(raw: bytes) -> dict:
    """An npz request body -> the payload dict the JSON path builds.

    The arrays named after modalities are the condition; optional 0-d
    ``seed`` and ``temperature`` arrays are the scalars. The npz layer is
    transport alone: ``parse_rows`` validates both formats alike. The
    names in ``RESERVED`` cannot be modalities (``make_server`` refuses an
    artifact that has one)."""
    try:
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            files = {k: z[k] for k in z.files}
    except Exception as e:
        raise ClientError(f"bad npz body: {e}") from e
    payload = {}
    if "seed" in files:
        payload["seed"] = int(files.pop("seed"))
    if "temperature" in files:
        payload["temperature"] = float(files.pop("temperature"))
    payload["condition"] = files
    return payload


def _host(out: dict) -> dict[str, np.ndarray]:
    """The program's output tensors as host arrays."""
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


class _Item:
    __slots__ = ("batch", "presence", "seeds", "temperature", "n", "event", "out", "error")

    def __init__(self, batch, presence, seeds, temperature, n):
        self.batch = batch
        self.presence = presence
        self.seeds = seeds
        self.temperature = temperature
        self.n = n
        self.event = threading.Event()
        self.out = None
        self.error = None


class Batcher:
    """Coalesce concurrent requests into one call of the program.

    For ``seed_mode="per_row"`` artifacts only, whose rows do not depend
    on their batch position: splitting a coalesced call's outputs back per
    request is then exact. A worker thread forms the groups; :meth:`close`
    stops it. ``device`` is where ``call`` runs (``call.device`` by
    default, as ``serving.load_generate`` sets it; the CPU when it has
    none). On the card a dynamic artifact is called at ``max_batch`` rows
    always, the group padded to it (a group of more rows as several calls
    of ``max_batch``), because the card's libraries sum in another order at
    another batch and a row's bits would follow its batch: the module
    docstring says why and what it costs.
    """

    def __init__(self, call, shapes, n_modalities, *, static_batch, max_batch=64,
                 max_wait_ms=5.0, device=None):
        self.call = call
        self.shapes = shapes
        self.n_modalities = n_modalities
        self.static_batch = static_batch  # None for a dynamic artifact
        self.max_batch = static_batch or max_batch
        device = torch.device(device or getattr(call, "device", None) or "cpu")
        # One batch for every call: a static artifact's, or on the card a
        # dynamic artifact's max_batch.
        self.fixed_batch = static_batch or (max_batch if device.type == "cuda" else None)
        self.max_wait = max_wait_ms / 1e3
        self.q: queue.Queue[_Item | None] = queue.Queue()
        self.stats = {"requests": 0, "device_calls": 0, "rows": 0, "padded_rows": 0,
                      "coalesced_calls": 0}
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def close(self, timeout: float | None = None) -> None:
        """Stop the worker once the requests queued before are served."""
        self.q.put(None)
        self._thread.join(timeout)

    def submit(self, batch, presence, seeds, temperature, n):
        """Blocking: the outputs of this request's ``n`` rows."""
        with self._lock:
            self.stats["requests"] += 1
            self.stats["rows"] += n
        item = _Item(batch, presence, seeds, temperature, n)
        self.q.put(item)
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.out

    def _alloc(self, total):
        """The batch a call of ``total`` rows runs at: ``fixed_batch`` where
        there is one (a group of more rows takes several calls of it), else
        the next power of two up to ``max_batch`` (past it, ``total``), so
        that the program sees few distinct batch sizes."""
        if self.fixed_batch:
            return self.fixed_batch
        b = 1
        while b < total:
            b *= 2
        return min(b, self.max_batch) if total <= self.max_batch else total

    def _worker(self):
        pending, closing = None, False
        while not closing:
            first = pending if pending is not None else self.q.get()
            pending = None
            if first is None:
                return
            group, total = [first], first.n
            deadline = time.monotonic() + self.max_wait
            while total < self.max_batch:
                timeout = deadline - time.monotonic()
                try:
                    nxt = self.q.get(timeout=timeout) if timeout > 0 else self.q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:  # close(): serve this group, then stop
                    closing = True
                    break
                if nxt.temperature != first.temperature or total + nxt.n > self.max_batch:
                    pending = nxt  # the next group leads with it
                    break
                group.append(nxt)
                total += nxt.n
            self._run(group, total)

    def _run(self, group, total):
        alloc = self._alloc(total)
        calls = -(-total // alloc)
        rows = calls * alloc
        try:
            batch = {k: np.zeros((rows,) + shp[1:], dt) for k, (shp, dt) in self.shapes.items()}
            presence = np.zeros((rows, self.n_modalities), np.float32)
            seeds = np.zeros((rows,), np.int64)
            off = 0
            for it in group:
                for k, v in it.batch.items():
                    batch[k][off:off + it.n] = v
                presence[off:off + it.n] = it.presence
                seeds[off:off + it.n] = it.seeds
                off += it.n
            parts = [_host(self.call({k: v[i:i + alloc] for k, v in batch.items()},
                                     presence[i:i + alloc], seed=seeds[i:i + alloc],
                                     temperature=group[0].temperature))
                     for i in range(0, rows, alloc)]
            out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
            with self._lock:
                self.stats["device_calls"] += calls
                self.stats["padded_rows"] += rows - total
                if len(group) > 1:
                    self.stats["coalesced_calls"] += 1
            off = 0
            for it in group:
                it.out = {k: v[off:off + it.n] for k, v in out.items()}
                off += it.n
            # Wake the waiters only once every item's output is assigned,
            # so a later item's failure cannot mark a woken one as failed.
            for it in group:
                it.event.set()
        except Exception as e:  # noqa: BLE001 -- reported to every waiter
            for it in group:
                if not it.event.is_set():
                    it.error = e
                    it.event.set()


def make_handler(meta, call, batcher=None):
    """The request handler class of an artifact's ``(meta, call)``."""
    dynamic = meta["batch_size"] == "dynamic"
    batch_size = None if dynamic else int(meta["batch_size"])
    per_row = meta["seed_mode"] == "per_row"
    modalities = list(meta["modalities"])
    shapes = {k: (tuple(v[0]), np.dtype(v[1])) for k, v in meta["batch_shapes"].items()}
    # Batch key -> the experts it feeds. A stacked key like CelebA's
    # "attrs" observes all its experts; each column's expert name
    # ("attr_3") is a condition key too, writing one column and one
    # presence bit (as in api.generate).
    groups = meta["batch_modalities"]
    column_of = {name: (bkey, j) for bkey, names in groups.items() if len(names) > 1
                 for j, name in enumerate(names)}

    def parse_rows(payload):
        """Request body -> (n, row arrays, presence rows, seeds, temperature)."""
        if not isinstance(payload, dict):
            raise ClientError("request body must be a JSON object")
        cond = payload.get("condition", {}) or {}
        if not isinstance(cond, dict):
            raise ClientError("'condition' must map modality -> rows")
        unknown = set(cond) - set(shapes) - set(column_of)
        if unknown:
            raise ClientError(f"unknown modalities {sorted(unknown)}; have "
                              f"{sorted(set(shapes) | set(column_of))}")
        try:
            lengths = {k: len(v) for k, v in cond.items()}
        except TypeError as e:
            raise ClientError(f"condition rows must be arrays: {e}") from e
        if len(set(lengths.values())) > 1:
            raise ClientError(f"condition modalities disagree on batch size: {lengths}")
        n = next(iter(lengths.values()), batch_size or 1)
        if not dynamic and n > batch_size:
            raise ClientError(
                f"request batch {n} exceeds the artifact's static batch size {batch_size} "
                f"(export with --batch-size-export dynamic for arbitrary sizes)")
        batch = {k: np.zeros((n,) + shp[1:], dt) for k, (shp, dt) in shapes.items()}
        presence = np.zeros((n, len(modalities)), np.float32)
        idx = {m: i for i, m in enumerate(modalities)}
        try:
            for key, value in cond.items():
                if key in column_of:
                    bkey, col = column_of[key]
                    arr = np.asarray(value, shapes[bkey][1])
                    batch[bkey][: len(arr), col] = arr
                    presence[: len(arr), idx[key]] = 1.0
                    continue
                arr = np.asarray(value, shapes[key][1])
                batch[key][: len(arr)] = arr
                for name in groups.get(key, []):
                    presence[: len(arr), idx[name]] = 1.0
            seed = int(payload.get("seed", 0))
            # load_generate's expansion of a scalar seed, so that a
            # coalesced reply equals the solo one.
            seeds = seed + np.arange(n, dtype=np.int64)
            temperature = float(payload.get("temperature", 1.0))
        except (ValueError, TypeError) as e:
            # Wrong row shapes or dtypes, a seed or temperature not a number.
            raise ClientError(str(e)) from e
        return n, batch, presence, seeds, temperature

    def run_generate_arrays(payload):
        """Request payload -> ({modality: (n, ...) array}, n), the core both
        wire formats share."""
        n, batch, presence, seeds, temperature = parse_rows(payload)
        if batcher is not None:
            return batcher.submit(batch, presence, seeds, temperature, n), n
        # No batcher: one call a request, padded to a static batch.
        alloc = n if dynamic else batch_size
        if alloc != n:
            batch = {k: np.concatenate([v, np.zeros((alloc - n,) + v.shape[1:], v.dtype)])
                     for k, v in batch.items()}
            presence = np.concatenate(
                [presence, np.zeros((alloc - n, len(modalities)), np.float32)])
            seeds = np.concatenate([seeds, np.zeros((alloc - n,), np.int64)])
        out = call(batch, presence, seed=seeds if per_row else int(payload.get("seed", 0)),
                   temperature=temperature)
        return {k: v[:n] for k, v in _host(out).items()}, n

    def run_generate(payload):
        rows, n = run_generate_arrays(payload)
        return {"outputs": {k: v.tolist() for k, v in rows.items()}, "n": n}

    class Handler(BaseHTTPRequestHandler):
        # Keep-alive (Content-Length is always set) and no Nagle: the
        # header and the body go out in separate writes.
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/meta":
                self._reply(200, meta)
            elif self.path == "/stats":
                if batcher is None:
                    self._reply(200, {"batching": "off"})
                else:
                    with batcher._lock:
                        stats = dict(batcher.stats)
                    self._reply(200, {"batching": "on", **stats})
            else:
                self._reply(404, {"error": "unknown path"})

        def _reply_npz(self, rows, n):
            buf = io.BytesIO()
            np.savez(buf, n=np.int64(n), **rows)
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-npz")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length)
                    # An npz body by its zip magic or its content type, so
                    # that a JSON body needs no header.
                    is_npz = raw[:2] == b"PK" or "npz" in (self.headers.get("Content-Type") or "")
                    payload = _npz_payload(raw) if is_npz else json.loads(raw or b"{}")
                except ClientError:
                    raise
                except (ValueError, TypeError) as e:
                    raise ClientError(f"bad request body: {e}") from e
                accept = self.headers.get("Accept") or ""
                if "npz" in accept or (is_npz and "json" not in accept):
                    self._reply_npz(*run_generate_arrays(payload))
                else:
                    self._reply(200, run_generate(payload))
            except ClientError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 -- the server's failure, not the client's
                self._reply(500, {"error": str(e)})

        def log_message(self, fmt, *args):  # no log line a request
            pass

    return Handler


def make_server(path, port, *, max_batch=64, max_wait_ms=5.0, batching=True, device=None):
    """``(server, meta, batcher)`` for the artifact at ``path``, loaded on
    ``device`` (the card by default) and bound to ``127.0.0.1:port``
    (``port`` 0 takes a free one). ``batcher`` is None when batching is off
    or the artifact's seed is scalar."""
    from mmvae_torch.serving import load_generate

    meta, call = load_generate(path, device=device)
    reserved = set(RESERVED) & (set(meta["modalities"]) | set(meta["batch_shapes"]))
    if reserved:
        # Refused at startup rather than reading a modality named 'seed' as
        # the seed of an npz request.
        raise ValueError(
            f"modality names {sorted(reserved)} collide with the npz wire format's reserved "
            f"names {list(RESERVED)}; rename the modality")
    batcher = None
    if batching and meta["seed_mode"] == "per_row":
        shapes = {k: (tuple(v[0]), np.dtype(v[1])) for k, v in meta["batch_shapes"].items()}
        dynamic = meta["batch_size"] == "dynamic"
        batcher = Batcher(call, shapes, len(meta["modalities"]),
                          static_batch=None if dynamic else int(meta["batch_size"]),
                          max_batch=max_batch, max_wait_ms=max_wait_ms, device=call.device)
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(meta, call, batcher))
    return server, meta, batcher


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mmvae_torch.serve")
    ap.add_argument("artifact")
    ap.add_argument("port", nargs="?", type=int, default=8901)
    ap.add_argument("--max-batch", type=int, default=64,
                    help="coalescing cap for dynamic artifacts (static artifacts cap at their "
                    "batch)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="how long a request waits for others to share its call")
    ap.add_argument("--no-batch", action="store_true", help="one request a call")
    ap.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)
    # Coalescing is exact only where a call is repeatable: cuDNN's default
    # transposed convolutions (the image decoders) may sum in another order
    # from call to call.
    torch.backends.cudnn.deterministic = True
    server, meta, batcher = make_server(
        args.artifact, args.port, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        batching=not args.no_batch, device=args.device)
    print(json.dumps({"serving": args.artifact, "port": server.server_address[1],
                      "config": meta["config"],
                      "batching": "on" if batcher is not None else "off"}), flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
