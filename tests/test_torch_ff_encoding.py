"""The port's Fourier-feature encoding, polyhedron basis and embedding table
against the JAX package's, on the CPU.

- `FFEncoding`, the plain branch (sin of the projected input and of its
  pi/2 shift at 2^linspace frequencies) and the integrated one (full
  covariances through `expected_sin`), with and without `include_input`,
  on seeded inputs: f32, atol and rtol 1e-5 (the same sums in another
  order, sin of moderate arguments; tests/test_torch_modules.py's F32).
- The bases of `make_rff_encoding` (np.random.default_rng(seed) in both
  packages) and of `make_polyhedron_ff_encoding` /
  `generate_polyhedron_basis` (octahedron and icosahedron, 1-2
  subdivisions): equal arrays.
- `Embedding` with the JAX module's initialized table carried by
  `utils/jax_params.py`: lookups and `mean` within 1e-6, and the table
  exported back unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.ops import embeddings as jemb
from nerfstudio_thermal_tpu.ops import encodings as jenc
from nerfstudio_thermal_tpu.utils import math as jmath

from nerfstudio_thermal_torch.ops import Embedding
from nerfstudio_thermal_torch.ops import encodings as tenc
from nerfstudio_thermal_torch.utils import jax_params
from nerfstudio_thermal_torch.utils import math as tmath

torch.set_num_threads(1)

F32 = 1e-5


def _inputs(seed, in_dim, n=64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, in_dim)).astype(np.float32)
    a = rng.normal(0.0, 0.05, (n, in_dim, in_dim)).astype(np.float32)
    covs = (a @ np.swapaxes(a, -1, -2)).astype(np.float32)  # symmetric PSD
    return x, covs


def _jax_ff(enc, x, covs=None):
    return np.asarray(enc.apply({}, jnp.asarray(x), None if covs is None else jnp.asarray(covs)))


@pytest.mark.parametrize("include_input", [False, True])
@pytest.mark.parametrize("integrated", [False, True])
@pytest.mark.parametrize("kind", ["polyhedron", "rff", "basis"])
def test_ff_encoding_matches_jax(kind, integrated, include_input):
    if kind == "polyhedron":
        args = dict(num_frequencies=3, min_freq_exp=0.0, max_freq_exp=2.0, basis_shape="icosahedron",
                    basis_subdivisions=2, include_input=include_input)
        want_enc = jenc.make_polyhedron_ff_encoding(**args)
        got_enc = tenc.make_polyhedron_ff_encoding(**args)
        in_dim = 3
    elif kind == "rff":
        args = dict(in_dim=4, num_frequencies=8, scale=2.5, include_input=include_input, seed=7)
        want_enc = jenc.make_rff_encoding(**args)
        got_enc = tenc.make_rff_encoding(**args)
        in_dim = 4
    else:
        basis = np.random.default_rng(3).normal(size=(2, 5)).astype(np.float32)
        want_enc = jenc.FFEncoding(basis=tuple(map(tuple, basis)), num_frequencies=4, min_freq_exp=-1.0,
                                   max_freq_exp=1.5, include_input=include_input)
        got_enc = tenc.FFEncoding(basis, num_frequencies=4, min_freq_exp=-1.0, max_freq_exp=1.5,
                                  include_input=include_input)
        in_dim = 2
    x, covs = _inputs(in_dim + 10 * integrated, in_dim)
    covs = covs if integrated else None
    want = _jax_ff(want_enc, x, covs)
    got = got_enc(torch.as_tensor(x), None if covs is None else torch.as_tensor(covs))
    assert got_enc.out_dim == want_enc.out_dim == want.shape[-1]
    assert got_enc.in_dim == want_enc.in_dim == in_dim
    np.testing.assert_allclose(got.numpy(), want, atol=F32, rtol=F32)


@pytest.mark.parametrize("shape", ["octahedron", "icosahedron"])
@pytest.mark.parametrize("subdivisions", [1, 2])
def test_polyhedron_bases_equal_jax(shape, subdivisions):
    want = jmath.generate_polyhedron_basis(shape, subdivisions)
    got = tmath.generate_polyhedron_basis(shape, subdivisions)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    enc_args = dict(num_frequencies=2, min_freq_exp=0.0, max_freq_exp=1.0, basis_shape=shape,
                    basis_subdivisions=subdivisions)
    np.testing.assert_array_equal(tenc.make_polyhedron_ff_encoding(**enc_args).basis,
                                  np.asarray(jenc.make_polyhedron_ff_encoding(**enc_args).basis, np.float32))


@pytest.mark.parametrize("seed", [0, 5])
def test_rff_basis_equals_jax(seed):
    want = np.asarray(jenc.make_rff_encoding(3, 6, 1.5, seed=seed).basis, np.float32)
    got = tenc.make_rff_encoding(3, 6, 1.5, seed=seed).basis
    np.testing.assert_array_equal(got, want)
    for make in (jenc.make_rff_encoding, tenc.make_rff_encoding):
        with pytest.raises(ValueError, match="scale"):
            make(3, 6, 0.0)


def test_embedding_matches_jax():
    module = jemb.Embedding(num_embeddings=7, features=5)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))["params"]
    port = Embedding(7, 5, generator=torch.Generator().manual_seed(0))
    jax_params.load_module(port, jax.tree.map(np.asarray, params), "embedding")
    idx = np.array([0, 6, 3, 3, 1], np.int32)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(idx)))
    np.testing.assert_allclose(port(torch.as_tensor(idx).long()).detach().numpy(), want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(port.mean().detach().numpy(), np.asarray(module.mean(params)), atol=1e-6, rtol=1e-6)
    exported = jax_params.export_module(port)
    np.testing.assert_array_equal(exported["embedding"], np.asarray(params["embedding"]))
    with pytest.raises(KeyError):
        jax_params.load_module(port, {"table": params["embedding"]}, "embedding")


def test_embedding_init_is_a_unit_normal_draw():
    """flax's normal(stddev=1.0): mean ~0, std ~1, drawn from the given
    generator (the same seed gives the same table)."""
    a = Embedding(256, 64, generator=torch.Generator().manual_seed(3)).embedding.detach()
    b = Embedding(256, 64, generator=torch.Generator().manual_seed(3)).embedding.detach()
    assert torch.equal(a, b)
    assert abs(float(a.mean())) < 0.02 and abs(float(a.std()) - 1.0) < 0.02
