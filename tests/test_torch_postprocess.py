"""``generate``'s post-processing (``api._postprocess``) against the JAX
package's, on the CPU.

A stub model names some of its decoded keys in ``decode_kinds`` and leaves
others out; the same numpy decodes go through both functions. The rule is
JAX's: a key that ``decode_kinds`` does not name is bernoulli (a sigmoid),
categorical gives the argmax, and any other kind is returned as decoded.
Tolerance: rtol 1e-6, atol 1e-7 for the sigmoid (XLA's and PyTorch's
differ in the last bits); the argmax and the raw values are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import api as japi
from mmvae_torch import api
from torch_threads import _one_torch_thread  # noqa: F401


class _Stub:
    """A model with no sequence modality whose ``decode_kinds`` is given."""

    def __init__(self, kinds: dict[str, str]):
        self._kinds = kinds

    def decode_kinds(self) -> dict[str, str]:
        return dict(self._kinds)

    def specs(self) -> list:
        return []


# (decode_kinds, the decoded keys): a key missing from the kinds, an
# unknown kind ("gaussian"), both beside the two known kinds, and a model
# whose kinds name nothing.
CASES = [
    ({"image": "bernoulli", "label": "categorical"}, ("image", "label", "extra")),
    ({"image": "bernoulli", "depth": "gaussian"}, ("image", "depth")),
    ({"label": "categorical", "depth": "gaussian"}, ("label", "depth", "extra")),
    ({}, ("image", "extra")),
]


def _decodes(keys, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: (3.0 * rng.standard_normal((5, 10))).astype(np.float32) for k in keys}


@pytest.mark.parametrize("kinds, keys", CASES)
def test_postprocess_matches_jax(kinds, keys):
    """Each key of the stub's decode against JAX's ``_postprocess``: a
    missing kind read as bernoulli, an unknown kind returned raw."""
    recons = _decodes(keys, 7)
    stub = _Stub(kinds)
    want = japi._postprocess(stub, None, {k: jnp.asarray(v) for k, v in recons.items()},
                             jnp.zeros((5, 4)), None, 1.0)
    got = api._postprocess(stub, {k: torch.from_numpy(v) for k, v in recons.items()},
                           torch.zeros(5, 4), 1.0, None)
    assert set(got) == set(want) == set(keys)
    for key in keys:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape
        kind = kinds.get(key, "bernoulli")
        if kind == "bernoulli":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w)
            if kind != "categorical":
                np.testing.assert_array_equal(g, recons[key])
