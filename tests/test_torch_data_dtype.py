"""The train split's storage dtypes and segmented eval against the JAX package.

``data_dtype`` stores the train split's float modalities as uint8 (the
1/255 grid, dequantized in the step) or bf16 (which meets the f32 model
promoted, and reaches the BCE and K4 as it is). Checked on the CPU on
weights converted from the Flax tree:

  * the casts (``quantize_uint8``, ``dataset_astype``) and the step's
    dequant equal JAX's to the bit;
  * with uint8 and bf16 batches the loss and every gradient of the train
    step match ``jax.value_and_grad`` of the JAX ``multi_term_loss``
    (MNIST, and a narrow CelebA whose stage 0 is K4's plain version), and
    five Adam steps on ``api.train``'s cast of the split match five JAX
    steps on its own cast;
  * the plain BCE on bf16 targets matches the Pallas kernel's own
    ``_bce_fwd_impl(..., interpret=True)`` in the t and b row maps and at
    ``event_ndims=0``; the plain K4 weight gradient at a bf16 image
    matches ``jax.vjp`` of ``tools/pallas_conv_probe.py::xla_conv0`` on
    the image promoted as Flax promotes it.

Segmented eval is ``tests/test_torch_data_eval.py``'s, a CUB model on a
mounted corpus ``tests/test_torch_data_formats.py``'s.

Tolerances as in ``tests/test_torch_train.py``: rtol 2e-4 (XLA-CPU's
transcendentals are approximate), each gradient tensor with an atol of
2e-4 of its largest element; Adam steps by the relative 2-norm of the two
updates' difference (below 1e-4) and elementwise within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.data import dataset_astype as j_dataset_astype
from mmvae_tpu.data.pipelines import Dataset as JDataset
from mmvae_tpu.data.pipelines import quantize_uint8 as j_quantize_uint8
from mmvae_tpu.models import CelebAMVAE as JCelebAMVAE
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.ops.kernels import _bce_fwd_impl
from mmvae_tpu.train.state import create_train_state as j_create_train_state
from mmvae_tpu.train.step import _dequant_data as j_dequant_data
from mmvae_tpu.train.step import make_train_step as j_make_train_step
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import Dataset, dataset_astype, make_celeba, make_mnist, quantize_uint8
from mmvae_torch.models import CelebAMVAE, MnistMVAE
from mmvae_torch.ops import kernels
from mmvae_torch.train import create_train_state, make_train_step, multi_term_loss
from mmvae_torch.train.step import _dequant_data
from tools.pallas_conv_probe import xla_conv0

RTOL = 2e-4
STEP_ATOL = 1e-4
STEP_REL = 1e-4
B = 8
HW = 16
# (port model, JAX model, keywords, data maker, terms of the mvae loss)
MODELS = {
    "mnist": (MnistMVAE, JMnistMVAE, dict(n_latents=16), lambda n, s: make_mnist(n, seed=s), 3),
    "celeba": (CelebAMVAE, JCelebAMVAE, dict(n_latents=8, image_hw=(HW, HW),
                                              conv_features=(32, 8)),
               lambda n, s: make_celeba(n, seed=s, hw=HW), 20),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a) -> np.ndarray:
    """An array's bits: bf16 as int16 (numpy has no bf16)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _cast(data: dict, dtype: str):
    """``data`` cast by the port (torch) and by JAX (jnp), each its own
    way; the same bits (checked in ``test_casts_equal_jax``)."""
    size = len(next(iter(data.values())))
    got = dataset_astype(Dataset(data, size), dtype).arrays
    want = j_dataset_astype(JDataset(data, size), getattr(jnp, dtype)).arrays
    return ({k: torch.as_tensor(v) for k, v in got.items()},
            {k: jnp.asarray(v) for k, v in want.items()})


@pytest.fixture(scope="module", params=list(MODELS))
def matched(request):
    """(name, port model class and keywords, JAX model, its params, data maker, T)."""
    name = request.param
    tcls, jcls, kwargs, make, t = MODELS[name]
    jmodel = jcls(**kwargs)
    batch = {k: jnp.asarray(v) for k, v in make(2, 5).items()}
    init = jax.jit(lambda b: jmodel.init(jax.random.key(0), b, rng=jax.random.key(1)))
    params = _np_tree(init(batch)["params"])
    return name, tcls, kwargs, jmodel, params, make, t


def _tmodel(tcls, kwargs, params):
    model = tcls(**kwargs)
    model.load_state_dict(from_flax_params(params))
    return model


@pytest.mark.parametrize("name", list(MODELS))
def test_casts_equal_jax(name):
    """``quantize_uint8`` and ``dataset_astype`` (uint8 and bf16) against
    JAX's on data with values off the grid, below 0 and above 1; the labels
    and tokens untouched; the step's dequant against JAX's ``_dequant_data``
    (255 gives exactly 1)."""
    data = MODELS[name][3](16, 3)
    data = {k: (v * 1.2 - 0.1 if v.dtype == np.float32 else v) for k, v in data.items()}
    for k, v in data.items():
        if v.dtype == np.float32:
            np.testing.assert_array_equal(quantize_uint8(v), np.asarray(j_quantize_uint8(v)))
    for dtype in ("uint8", "bfloat16"):
        got, want = _cast(data, dtype)
        for k in data:
            assert got[k].dtype == getattr(torch, dtype if data[k].dtype == np.float32
                                           else str(data[k].dtype))
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
        if dtype == "uint8":
            deq, j_deq = _dequant_data(got), j_dequant_data(want, jnp.float32)
            for k in data:
                np.testing.assert_array_equal(deq[k].numpy(), np.asarray(j_deq[k]), err_msg=k)
    assert _dequant_data({"x": torch.tensor([0, 255], dtype=torch.uint8)})["x"].tolist() == [0, 1]
    assert dataset_astype(Dataset(data, 16), "float32").arrays is data


def _grads_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL,
                                   atol=2e-4 * w.abs().max().item(), err_msg=k)


@pytest.mark.parametrize("dtype", ["uint8", "bfloat16"])
def test_loss_and_every_gradient_match_jax(matched, dtype):
    """One loss evaluation of the train step (sample=True, beta 0.3) on a
    uint8 or bf16 batch: the loss and the gradient of every parameter
    against ``jax.value_and_grad`` of the JAX ``multi_term_loss`` on its
    cast of the same batch, JAX's noise passed in."""
    _, tcls, kwargs, jmodel, params, make, t = matched
    tb, jb = _cast(make(B, 7), dtype)
    rng = jax.random.key(3)

    def loss_fn(p):
        return j_multi_term_loss(jmodel, p, jb, rng, 0.3, sample=True, term_fold="t")

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    eps = jax.random.normal(jax.random.split(rng)[1], (t, B, kwargs["n_latents"]))
    model = _tmodel(tcls, kwargs, params)
    loss, _ = multi_term_loss(model, tb, 0.3, sample=True, eps=torch.from_numpy(np.array(eps)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    _grads_close({k: p.grad for k, p in model.named_parameters()},
                 from_flax_params(_np_tree(j_grads)))


@pytest.mark.parametrize("dtype", ["uint8"])
def test_five_adam_steps_on_the_cast_split_match_jax(dtype):
    """``api.train``'s cast of an MNIST split (``dataset_astype``), five
    steps of the port's train step against five JAX steps on JAX's cast
    (its own noise passed in): the loss each step, the parameters after.
    (bf16 batches meet JAX in ``test_loss_and_every_gradient_match_jax``.)"""
    _, jcls, kwargs, make, t = MODELS["mnist"]
    jmodel = jcls(**kwargs)
    data = make(5 * B, 9)
    tb, jb = _cast(data, dtype)
    batches = [({k: v[i * B:(i + 1) * B] for k, v in tb.items()},
                {k: v[i * B:(i + 1) * B] for k, v in jb.items()}) for i in range(5)]
    state = j_create_train_state(jmodel, batches[0][1], jax.random.key(7), 1e-3, grad_clip=1.0)
    init = _np_tree(state.params)
    j_step = j_make_train_step(jmodel, annealing_steps=4, term_fold="t")
    model = _tmodel(MnistMVAE, kwargs, init)
    t_state = create_train_state(model, 1e-3, grad_clip=1.0)
    step = make_train_step(model, annealing_steps=4)
    for t_batch, j_batch in batches:
        rng = jax.random.split(state.rng, 3)[0]
        eps = jax.random.normal(jax.random.split(rng)[1], (t, B, kwargs["n_latents"]))
        state, j_metrics = j_step(state, j_batch)
        t_state, metrics = step(t_state, t_batch, eps=torch.from_numpy(np.array(eps)))
        np.testing.assert_allclose(metrics["loss"].item(), float(j_metrics["loss"]), rtol=RTOL)
    want, init = from_flax_params(_np_tree(state.params)), from_flax_params(init)
    got = t_state.params
    diff = sum(((got[k].detach() - w) ** 2).sum() for k, w in want.items())
    update = sum(((w - init[k]) ** 2).sum() for k, w in want.items())
    assert update > 0 and (diff / update).sqrt() < STEP_REL
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=0, atol=STEP_ATOL)


def test_api_train_casts_the_train_split_only():
    """``api.train`` under each ``data_dtype`` on the CPU: uint8 gives the
    float32 run's losses where the data is on the 1/255 grid (MNIST's
    synthetic glyphs are not, so within the grid's rounding), bf16 within
    its rounding; the test ELBO is always of the f32 split."""
    cfg = configs.get_config("mnist").replace(n_latents=8, epochs=1, train_size=48,
                                              test_size=20, batch_size=16)
    runs = {d: api.train(cfg.replace(data_dtype=d), device="cpu", verbose=False).history[0]
            for d in ("float32", "uint8", "bfloat16")}
    for d in ("uint8", "bfloat16"):
        np.testing.assert_allclose(runs[d]["train_loss"], runs["float32"]["train_loss"],
                                   rtol=1e-3)
        np.testing.assert_allclose(runs[d]["test_elbo"], runs["float32"]["test_elbo"],
                                   rtol=1e-3)


@pytest.mark.parametrize("fold, event_ndims", [("t", 1), ("b", 1), ("t", 0), ("b", 0)])
def test_plain_bce_on_bf16_targets_matches_the_pallas_kernel(fold, event_ndims):
    """``bernoulli_nll_torch`` on untiled bf16 targets against
    ``_bce_fwd_impl(..., interpret=True)`` on the targets tiled by the same
    map (the Pallas kernel upcasts them on load)."""
    rng = np.random.default_rng(4)
    n_x, k = 6, 3
    shape = (n_x, 40) if event_ndims else (n_x, 18)
    logits = (3 * rng.standard_normal((n_x * k, shape[1]))).astype(np.float32)
    x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    tiled = jnp.tile(jx, (k, 1)) if fold == "t" else jnp.repeat(jx, k, axis=0)
    want = np.asarray(_bce_fwd_impl(jnp.asarray(logits), tiled, event_ndims, interpret=True))
    mode = kernels.FOLD_T if fold == "t" else kernels.FOLD_B
    tl = torch.from_numpy(logits)
    if event_ndims:
        got = kernels.bernoulli_nll_torch(tl, x, mode)
    else:  # rows of D = 1, b-major over examples of 18 rows (as ops reads them)
        inner = shape[1] if fold == "b" else 1
        got = kernels.bernoulli_nll_torch(tl.reshape(-1, 1), x.reshape(-1, 1), mode,
                                          inner).reshape(n_x * k, -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)


def test_plain_conv_weight_grad_at_a_bf16_image_matches_jax_vjp():
    """``conv4x4s2_swish_grad_torch`` (dW, db) at a bf16 image against
    ``jax.vjp`` of ``xla_conv0`` in the weight and bias, the bf16 image
    promoted to f32 as Flax's ``promote_dtype`` promotes it; the forward
    too."""
    rng = np.random.default_rng(8)
    shape = (4, 32, 32, 3)
    x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(torch.bfloat16)
    w = (0.1 * rng.standard_normal((32, 3, 4, 4))).astype(np.float32)
    b = (0.1 * rng.standard_normal(32)).astype(np.float32)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    out, vjp = jax.vjp(lambda w_, b_: xla_conv0(jx.astype(jnp.float32), w_, b_),
                       jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b))
    g = rng.standard_normal(out.shape).astype(np.float32)
    j_dw, j_db = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    tg = torch.from_numpy(g).permute(0, 3, 1, 2)
    y = kernels.conv4x4s2_swish_torch(x, tw, tb)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(out), rtol=RTOL,
                               atol=1e-5)
    d_w, d_b = kernels.conv4x4s2_swish_grad_torch(x, tw, tb, tg)
    for got, want in ((d_w, j_dw.transpose(3, 2, 0, 1)), (d_b, j_db)):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=2e-4 * np.abs(want).max())
