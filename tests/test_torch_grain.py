"""The port's grain backend against the JAX package's, on the CPU.

The plan (``epoch_plan``: numpy's ``default_rng``), the gather
(``gather_batches``) and a whole host epoch (``_grain_epoch_host``) equal
the JAX package's to the bit, over three epochs and a rollback's seed, at
``p_modality_drop`` 0 and 0.3 and in each ``data_dtype`` (bf16 compared
by its bits). ``make_grain_loader``'s elements equal the JAX source's
(the JAX loader wraps it in ``grain.MapDataset``; the port has no
``grain``). The segmented stream equals the whole epoch, batch for batch
and trained state for trained state; its hits and misses; the batches
``api.train(data_backend="grain")`` feeds its runner are JAX's;
``resolve_eval_segments`` is JAX's; ``sample_presence`` with JAX's
``bernoulli`` draw passed in is JAX's mask.
"""

import json
import warnings

import jax
import numpy as np
import pytest
import torch

from mmvae_tpu import api as japi
from mmvae_tpu.configs import get_config as j_get_config
from mmvae_tpu.data import grain_pipeline as jgrain
from mmvae_tpu.data.pipelines import Dataset as JDataset
from mmvae_tpu.data.pipelines import sample_presence as j_sample_presence
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_torch import api, configs
from mmvae_torch.data import Dataset, load_dataset, make_celeba, sample_presence
from mmvae_torch.data import grain_pipeline
from mmvae_torch.models import MnistMVAE
from torch_threads import _one_torch_thread  # noqa: F401

N, BS = 70, 16  # 4 batches, 6 rows dropped


def _bits(v) -> np.ndarray:
    """An array's bits to compare: bf16 (a torch tensor here, an ml_dtypes
    array in JAX) as uint16, everything else as it is."""
    if torch.is_tensor(v):
        return v.view(torch.int16).numpy().view(np.uint16) if v.dtype == torch.bfloat16 \
            else v.numpy()
    v = np.asarray(v)
    return v.view(np.uint16) if v.dtype.name == "bfloat16" else v


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def data():
    return load_dataset("mnist", n=N)


def _cfg(**kw):
    return configs.get_config("mnist").replace(n_latents=8, batch_size=BS, train_size=N, **kw)


def _jcfg(**kw):
    return j_get_config("mnist").replace(n_latents=8, batch_size=BS, train_size=N, **kw)


@pytest.mark.parametrize("p_drop", [0.0, 0.3, 0.9])
@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_plan_and_gather_match_jax(data, p_drop, shuffle):
    """Seeds 0-2 and a rollback's: the order, the presence mask (at 0.9 rows
    with every modality dropped get one back) and the stacked batches."""
    for seed in (0, 1, 2, japi._grain_seed(0, 2, 1)):
        got = grain_pipeline.epoch_plan(N, BS, seed, n_modalities=2, p_drop=p_drop,
                                        shuffle=shuffle)
        want = jgrain.epoch_plan(N, BS, seed, n_modalities=2, p_drop=p_drop, shuffle=shuffle)
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None) == (p_drop == 0)
        if p_drop:
            np.testing.assert_array_equal(got[1], want[1])
            assert got[1].sum(1).min() >= 1
        _assert_same(grain_pipeline.gather_batches(data.arrays, *got, BS),
                     jgrain.gather_batches(data.arrays, *want, BS))


@pytest.mark.parametrize("data_dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("p_drop", [0.0, 0.3])
def test_grain_epoch_host_matches_jax(data, data_dtype, p_drop):
    """Three epochs and a rollback's retry of ``_grain_epoch_host`` (the
    ``data_dtype`` cast at the source, then the gather) to the bit."""
    cfg = _cfg(data_dtype=data_dtype, p_modality_drop=p_drop)
    jcfg = _jcfg(data_dtype=data_dtype, p_modality_drop=p_drop)
    model, jmodel = MnistMVAE(n_latents=8), JMnistMVAE(n_latents=8)
    jds = JDataset(arrays=dict(data.arrays), size=N)
    for epoch, rollbacks in ((1, 0), (2, 0), (3, 0), (2, 1)):
        seed = api._grain_seed(5, epoch, rollbacks)
        assert seed == japi._grain_seed(5, epoch, rollbacks)
        got = api._grain_epoch_host(data, cfg, model, seed)
        _assert_same(got, japi._grain_epoch_host(jds, jcfg, jmodel, seed))
        assert ("presence" in got) == (p_drop > 0)
        if p_drop:
            assert got["presence"].dtype == np.float32


def test_make_grain_loader_elements_match_the_jax_source(data):
    """Two epochs of 4 batches: element i is the JAX source's element i;
    iteration gives them in order; past the end is an IndexError."""
    kw = dict(names=["image", "label"], p_drop=0.4, shuffle=True, seed=3, num_epochs=2)
    want = jgrain._BatchSource(dict(data.arrays), BS, **kw)
    loader = grain_pipeline.make_grain_loader(data, BS, modality_names=["image", "label"],
                                              p_modality_drop=0.4, seed=3, num_epochs=2)
    assert len(loader) == len(want) == 8
    for i, batch in enumerate(loader):
        _assert_same(batch, want[i])
    with pytest.raises(IndexError):
        loader[8]
    it = grain_pipeline.GrainEpochIterator(data, BS, seed=3)
    assert len(list(it)) == 4


def _stream(data, **kw):
    return api._GrainStream(data, _cfg(data_backend="grain", **kw), MnistMVAE(n_latents=8),
                            torch.device("cpu"))


def _record_runner(seen):
    def runner(state, batches):
        seen.append({k: v.clone() for k, v in batches.items()})
        return state, {"loss": batches["label"].float().sum((1,))}
    return runner


@pytest.mark.parametrize("seg", [1, 3, 4, 9])
def test_segments_concatenate_to_the_whole_epoch(data, seg):
    """At 4 batches an epoch, segments of 1, 3 (a short last one of 1), 4
    and 9 (the whole epoch) give the whole epoch's batches in order, with
    the plan's presence, in the cast dtype (bf16 through its int16 bits)."""
    whole = api._grain_epoch_host(data, _cfg(data_dtype="bfloat16", p_modality_drop=0.3),
                                  MnistMVAE(n_latents=8), 11)
    seen = []
    stream = _stream(data, grain_stream_steps=seg, data_dtype="bfloat16", p_modality_drop=0.3)
    try:
        _, metrics = stream.run_epoch(None, _record_runner(seen), 11)
    finally:
        stream.close()
    assert [len(s["label"]) for s in seen] == {1: [1] * 4, 3: [3, 1], 4: [4], 9: [4]}[seg]
    got = {k: torch.cat([s[k] for s in seen]) for k in seen[0]}
    assert got["image"].dtype == torch.bfloat16
    _assert_same(got, {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                       for k, v in whole.items()})
    assert metrics["loss"].shape == (4,)


def test_hits_and_misses(data):
    """A scheduled key is a hit; a take of another key (a rollback's
    perturbed seed) a miss that gathers inline; both give the serial
    epoch's batches. Over a streamed epoch each segment's take after the
    first hits."""
    stream = _stream(data, grain_stream_steps=2)
    serial = api._grain_epoch_host(data, _cfg(), MnistMVAE(n_latents=8), 7)
    try:
        stream.schedule((7, 1))
        _assert_same(stream.take((7, 1)), {k: v[2:] for k, v in serial.items()})
        assert (stream.hits, stream.misses) == (1, 0)
        stream.schedule((7, 0))
        got = stream.take((8, 0))
        _assert_same(got, {k: v[:2] for k, v in
                           api._grain_epoch_host(data, _cfg(), MnistMVAE(n_latents=8),
                                                 8).items()})
        assert (stream.hits, stream.misses) == (1, 1) and stream.hit_rate == 0.5
        stream.run_epoch(None, _record_runner([]), 9, next_seed=10)
        stream.run_epoch(None, _record_runner([]), 10)
        assert (stream.hits, stream.misses) == (4, 2)
    finally:
        stream.close()
    assert np.isnan(_stream(data).hit_rate)


def test_the_streamed_run_trains_to_the_whole_run_s_state(tmp_path):
    """``api.train`` on the grain backend over 2 epochs of 4 batches with
    presence dropout: segments of 3 (and a short last one) and the whole
    epoch end at the same parameters and history to the bit; each eval
    record carries ``stream_hit_rate`` (the first take of the run misses)."""
    cfg = _cfg(epochs=2, test_size=32, p_modality_drop=0.3, data_backend="grain")
    whole = api.train(cfg, device="cpu", verbose=False)
    streamed = api.train(cfg.replace(grain_stream_steps=3), str(tmp_path), device="cpu",
                         verbose=False)
    assert streamed.history == whole.history
    for k, v in whole.model.state_dict().items():
        assert torch.equal(streamed.model.state_dict()[k], v), k
    with open(tmp_path / "metrics.jsonl") as f:
        evals = [r for r in map(json.loads, f) if r["kind"] == "eval"]
    assert [r["stream_hit_rate"] for r in evals] == [0.5, 0.75]
    device = api.train(cfg.replace(data_backend="device"), device="cpu", verbose=False)
    assert device.history != whole.history  # another order and presence


def test_api_train_feeds_jax_s_grain_batches(monkeypatch):
    """The batches (and presence masks) the runner gets in each of 2
    epochs are the JAX ``_grain_epoch_host``'s of ``_grain_seed(seed,
    epoch, 0)``, stored as uint8."""
    seen = []
    real = api.make_epoch_runner

    def recording(*args, **kw):
        runner = real(*args, **kw)

        def run(state, batches):
            seen.append({k: v.clone() for k, v in batches.items()})
            return runner(state, batches)

        return run

    monkeypatch.setattr(api, "make_epoch_runner", recording)
    cfg = _cfg(epochs=2, test_size=16, p_modality_drop=0.3, data_backend="grain",
               data_dtype="uint8")
    api.train(cfg, seed=4, device="cpu", verbose=False)
    jcfg = _jcfg(p_modality_drop=0.3, data_dtype="uint8")
    jds = JDataset(arrays=dict(load_dataset("mnist", n=N).arrays), size=N)
    assert len(seen) == 2
    for epoch, batches in zip((1, 2), seen):
        want = japi._grain_epoch_host(jds, jcfg, JMnistMVAE(n_latents=8),
                                      japi._grain_seed(4, epoch, 0))
        _assert_same(batches, {k: torch.from_numpy(np.asarray(v)) for k, v in want.items()})


def test_reshuffle_every_warns_on_grain_and_an_unknown_backend_raises():
    cfg = _cfg(epochs=1, test_size=16, data_backend="grain", reshuffle_every=2)
    with pytest.warns(UserWarning, match="reshuffle_every>1 only applies"):
        api.train(cfg, device="cpu", verbose=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        api.train(cfg.replace(reshuffle_every=1), device="cpu", verbose=False)
    with pytest.raises(ValueError, match="unknown data_backend"):
        api.train(cfg.replace(data_backend="disk"), device="cpu", verbose=False)


@pytest.mark.parametrize("fields", [
    {}, {"eval_segment_steps": 0}, {"eval_segment_steps": 3}, {"data_backend": "grain"},
    {"data_backend": "grain", "grain_stream_steps": 5},
    {"data_backend": "grain", "grain_stream_steps": 5, "eval_segment_steps": 2},
    {"data_backend": "device", "grain_stream_steps": 5},
])
def test_resolve_eval_segments_matches_jax(fields):
    assert api.resolve_eval_segments(configs.get_config("mnist").replace(**fields)) == \
        japi.resolve_eval_segments(j_get_config("mnist").replace(**fields))


@pytest.mark.parametrize("p_drop", [0.3, 0.8])
def test_sample_presence_with_jax_s_draw(p_drop):
    """JAX's ``bernoulli(rng, 1 - p)`` passed in as ``keep``: JAX's mask, a
    row with every modality dropped keeping all of them (at 0.8 some do);
    drawn from a generator: the same rule, and None at p 0."""
    for seed in range(4):
        rng = jax.random.key(seed)
        keep = np.array(jax.random.bernoulli(rng, 1.0 - p_drop, shape=(32, 3)))
        got = sample_presence(None, 32, 3, p_drop, keep=keep)
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_sample_presence(rng, 32, 3,
                                                                                p_drop)))
    assert (~keep.any(1)).any() or p_drop < 0.5
    drawn = sample_presence(torch.Generator().manual_seed(0), 1000, 3, p_drop)
    assert drawn.shape == (1000, 3) and drawn.sum(1).min() >= 1
    assert sample_presence(torch.Generator(), 4, 3, 0.0) is None
    assert j_sample_presence(jax.random.key(0), 4, 3, 0.0) is None


def test_a_celeba_grain_epoch_matches_jax():
    """CelebA's 19 modalities (the ``attrs`` key carries 18): the plan's
    presence is per modality, as in JAX."""
    from mmvae_tpu.models import CelebAMVAE as JCelebAMVAE
    from mmvae_torch.models import CelebAMVAE

    arrays = make_celeba(40, hw=16)
    kw = dict(n_latents=8, image_hw=(16, 16), conv_features=(8, 8))
    cfg = configs.get_config("celeba").replace(batch_size=8, p_modality_drop=0.5)
    jcfg = j_get_config("celeba").replace(batch_size=8, p_modality_drop=0.5)
    got = api._grain_epoch_host(Dataset(arrays, 40), cfg, CelebAMVAE(**kw), 3)
    want = japi._grain_epoch_host(JDataset(arrays=arrays, size=40), jcfg, JCelebAMVAE(**kw), 3)
    _assert_same(got, want)
    assert got["presence"].shape == (5, 8, 19)
