"""The port's space_to_depth and pixel-shuffle conv stacks against the JAX
package, on the CPU.

``_space_to_depth`` and ``_depth_to_space`` against JAX's at C = 3 with
values distinct in every channel; then a narrow CelebA (16x16 images,
conv features (8, 16)) with ``space_to_depth=2``, with
``upsample_mode="shuffle"`` and with both, a CelebA at 18x18 with
``space_to_depth=2`` (the 2x2 layers over an odd 9x9 grid, where Flax's
one-sided SAME padding shows), and a narrow CUB with
``upsample_mode="shuffle"``: the modules, the loss and every gradient,
and an exported serving artifact. Random JAX trees in the init's shapes
move across with ``convert``; both sides see the same numpy data.
Tolerances as in ``tests/test_torch_cub_train.py``: rtol 2e-4, each
gradient tensor with an atol of 2e-4 of its largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import serving as jserving
from mmvae_tpu.models import CelebAMVAE as JCelebAMVAE
from mmvae_tpu.models import CubMVAE as JCubMVAE
from mmvae_tpu.models.experts import _depth_to_space as j_depth_to_space
from mmvae_tpu.models.experts import _space_to_depth as j_space_to_depth
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs, serving
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import make_celeba, make_cub
from mmvae_torch.models import CelebAMVAE, CubMVAE
from mmvae_torch.models.experts import _depth_to_space, _space_to_depth
from mmvae_torch.models.text import STOP
from mmvae_torch.train import multi_term_loss

RTOL = 2e-4
L, B = 8, 4
NARROW = dict(n_latents=L, conv_features=(8, 16))
CUB_KNOBS = dict(cross_recon=True, cycle_weight=0.1, cycle_render_grad=True,
                 cycle_render_binarize=False)
# case -> (config, JAX class, port class, model kwargs, data maker)
VARIANTS = {
    "celeba-s2d": ("celeba", JCelebAMVAE, CelebAMVAE,
                   dict(NARROW, image_hw=(16, 16), space_to_depth=2),
                   lambda n, s: make_celeba(n, seed=s, hw=16)),
    "celeba-shuffle": ("celeba", JCelebAMVAE, CelebAMVAE,
                       dict(NARROW, image_hw=(16, 16), upsample_mode="shuffle"),
                       lambda n, s: make_celeba(n, seed=s, hw=16)),
    "celeba-s2d-shuffle": ("celeba", JCelebAMVAE, CelebAMVAE,
                           dict(NARROW, image_hw=(16, 16), space_to_depth=2,
                                upsample_mode="shuffle"),
                           lambda n, s: make_celeba(n, seed=s, hw=16)),
    "celeba-s2d-odd": ("celeba", JCelebAMVAE, CelebAMVAE,
                       dict(NARROW, image_hw=(18, 18), space_to_depth=2),
                       lambda n, s: make_celeba(n, seed=s, hw=18)),
    "cub-shuffle": ("cub", JCubMVAE, CubMVAE,
                    dict(NARROW, vocab_size=23, image_hw=(16, 16), upsample_mode="shuffle"),
                    lambda n, s: make_cub(n, seed=s, hw=16)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: these ops are small, and the suite's
    parallel workers, each with a pool of every core's threads, slow them
    down by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jbatch(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _tbatch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def matched(request):
    """(case, JAX model, JAX params, port model, data maker): each kernel
    N(0, 1/fan-in), each vector N(0, 0.1^2)."""
    _, jcls, tcls, kwargs, make = VARIANTS[request.param]
    jmodel = jcls(**kwargs)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda d: jmodel.init(jax.random.key(0), d, rng=jax.random.key(1)),
                            _jbatch(make(2, 0)))

    def draw(s):
        std = (s.shape[-1] / np.prod(s.shape)) ** 0.5 if len(s.shape) > 1 else 0.1
        return (std * rng.normal(size=s.shape)).astype(np.float32)

    params = jax.tree.map(draw, shapes["params"])
    if "text_dec" in params:
        params["text_dec"]["out_proj"]["bias"][STOP] += 1.5
    tmodel = tcls(**kwargs)
    tmodel.load_state_dict(from_flax_params(params))
    return request.param, jmodel, params, tmodel, make


@pytest.mark.parametrize("r", [2, 4])
def test_space_to_depth_and_back_match_jax(r):
    """Channel ``(ry * r + rx) * C + c`` both ways, at C = 3 with each
    channel's values apart from the others' (a channel order that differs,
    as ``F.pixel_shuffle``'s does, cannot pass)."""
    x = np.arange(2 * 8 * 12 * 3, dtype=np.float32).reshape(2, 8, 12, 3)
    x[..., 1] += 1e4
    x[..., 2] += 2e4
    packed = _space_to_depth(torch.from_numpy(x), r)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_space_to_depth(jnp.asarray(x), r)))
    assert packed.shape == (2, 8 // r, 12 // r, 3 * r * r)
    back = _depth_to_space(packed, r)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_depth_to_space(jnp.asarray(packed.numpy()), r)))
    shuffled = torch.nn.functional.pixel_shuffle(packed.permute(0, 3, 1, 2), r)
    assert not torch.equal(shuffled.permute(0, 2, 3, 1), back)


def test_the_layers_and_flax_names():
    """``space_to_depth=2``: stage 0 a 2x2 ``Conv2d`` over 12 channels, a
    2x2 transposed conv to 12 last; ``"shuffle"``: ``Conv_*`` where the
    deconv stack has ``ConvTranspose_*``."""
    s2d = CelebAMVAE(**VARIANTS["celeba-s2d"][3])
    assert s2d.image_enc.convs[0].kernel_size == (2, 2) and s2d.image_enc.convs[0].in_channels == 12
    assert s2d.image_dec.deconvs[-1].kernel_size == (2, 2)
    assert s2d.image_dec.deconvs[-1].out_channels == 12
    params = JCelebAMVAE(**VARIANTS["celeba-s2d-shuffle"][3]).init(
        jax.random.key(0), _jbatch(make_celeba(2, hw=16)), rng=jax.random.key(1))["params"]
    assert sorted(k for k in params["image_dec"] if "Conv" in k) == ["ConvTranspose_0", "Conv_0"]
    both = CelebAMVAE(**VARIANTS["celeba-s2d-shuffle"][3])
    assert len(both.image_dec.convs) == 1 and len(both.image_dec.deconvs) == 1


@pytest.mark.parametrize("method", ["encode", "decode", "nll_all"])
def test_model_matches_jax(matched, method):
    _, jmodel, params, tmodel, make = matched
    data = make(B, 5)
    vs, jb, tb = {"params": params}, _jbatch(data), _tbatch(data)
    if method == "encode":
        with torch.no_grad():
            got = tmodel.encode(tb)
        for g, w in zip(got, jmodel.apply(vs, jb, method="encode")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-4)
        return
    z = np.random.default_rng(2).normal(size=(B, L)).astype(np.float32)
    want = jmodel.apply(vs, jnp.asarray(z), jb, method="decode")
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z), tb)
        if method == "decode":
            assert got["image"].shape == data["image"].shape
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL,
                                           atol=1e-4, err_msg=k)
            return
        nll = tmodel.nll_all(got, tb)
    np.testing.assert_allclose(
        nll.numpy(), np.asarray(jmodel.apply(vs, want, jb, method="nll_all")),
        rtol=RTOL, atol=1e-3)


def test_loss_and_every_gradient_match_jax(matched):
    """One loss at beta 0.3 with sample=True and JAX's noise: CelebA's
    joint and unimodal terms, CUB's config knobs (cross-recon, the cycle
    term re-encoding the soft render through the variant encoder)."""
    case, jmodel, params, tmodel, make = matched
    knobs = CUB_KNOBS if case.startswith("cub") else {}
    batch = make(B, 11)
    rng = jax.random.key(3)
    (j_loss, _), j_grads = jax.jit(lambda q: jax.value_and_grad(
        lambda p: j_multi_term_loss(jmodel, p, _jbatch(batch), rng, 0.3, sample=True,
                                    term_fold="t", **knobs), has_aux=True)(q))(params)
    n_terms = tmodel.n_modalities + 1
    eps = torch.from_numpy(np.array(jax.random.normal(jax.random.split(rng)[1], (n_terms, B, L))))
    model = VARIANTS[case][2](**VARIANTS[case][3])
    model.load_state_dict(from_flax_params(params))
    loss, _ = multi_term_loss(model, _tbatch(batch), 0.3, eps=eps, **knobs)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    want = from_flax_params(_np_tree(j_grads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL,
                                   atol=2e-4 * w.abs().max().item(), err_msg=k)


def test_exported_artifact_matches_jax_generate(matched, tmp_path):
    """A batch-4 per-row artifact exported on the CPU, from the images at
    temperature 0, against the JAX ``make_generate_fn`` under ``jax.jit``.
    K4 is in the graph where stage 0 is the 4x4 stride-2 conv, not where it
    is the 2x2 conv of ``space_to_depth``."""
    case, jmodel, params, tmodel, make = matched
    name = VARIANTS[case][0]
    cfg = configs.get_config(name).replace(n_latents=L, model_kwargs=VARIANTS[case][3])
    path = serving.export_generate(cfg, str(tmp_path / "a.mmvaept"), batch_size=B, model=tmodel,
                                   device="cpu")
    meta, call = serving.load_generate(path, device="cpu")
    data = make(B, 7)
    presence = np.zeros((B, len(meta["modalities"])), np.float32)
    presence[:, 0] = 1.0  # the image
    seeds = np.arange(B, dtype=np.int32)
    got = call(data, presence, seed=seeds, temperature=0.0)
    fn = jax.jit(jserving.make_generate_fn(jmodel, params, per_row_seed=True))
    want = fn(_jbatch(data), jnp.asarray(presence), jnp.asarray(seeds), jnp.float32(0.0))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got[k].numpy(), w, rtol=RTOL, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    targets = {str(n.target) for n in call.exported.graph.nodes if n.op == "call_function"}
    has_k4 = "mmvae.conv4x4s2_swish.default" in targets
    assert has_k4 == ("s2d" not in case)


def test_train_and_generate_through_the_entry_points():
    """``api.train`` of each variant at a small size to a finite history,
    and ``api.generate`` from its model."""
    for case in ("celeba-s2d-shuffle", "cub-shuffle"):
        name, _, _, kwargs, _ = VARIANTS[case]
        model_kwargs = {k: v for k, v in kwargs.items() if k != "n_latents"}
        cfg = configs.get_config(name).replace(
            n_latents=L, epochs=1, train_size=16, test_size=8, batch_size=8,
            model_kwargs=model_kwargs, data_kwargs={"hw": 16})
        result = api.train(cfg, device="cpu", verbose=False)
        assert np.isfinite(result.history[0]["test_elbo"])
        image = make_celeba(2, hw=16)["image"]
        out = api.generate(cfg, {"image": image}, model=result.model, device="cpu",
                           temperature=0.0)
        assert out["image"].shape == image.shape
