"""uspace_tpu_torch FID pieces held to the JAX package on the CPU.

``frechet_distance`` and ``activation_statistics`` are copies of the JAX
functions: the same statistics give the same value to rel 1e-9, and the
closed forms of ``tests/test_fid.py`` hold. ``InceptionV3`` runs JAX's
seeded parameters carried across by ``inception_flax_to_torch``, at an
upscale (80 -> 299) and a downscale (320 -> 299) of the same images, the
resize included: f32 features within rel-L2 1e-4 and max-abs 1e-4 of the
largest (the two libraries sum the 94 convolutions' products in other
orders; the resizes alone agree to 1e-6). A pytorch-fid-named state dict
(with the ``fc`` head pytorch-fid's file carries) loads strictly into the
port and, through ``inception_torch_to_flax``, into JAX's tree.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uspace_tpu.evals import fid as jfid
from uspace_tpu.evals.inception import InceptionV3 as JaxInception
from uspace_tpu.evals.inception import inception_torch_to_flax
from uspace_tpu_torch.codecs.convert import inception_flax_to_torch
from uspace_tpu_torch.evals import fid
from uspace_tpu_torch.evals.inception import (
    InceptionV3,
    load_pytorch_fid_state_dict,
)

SIZES = (80, 320)  # an upscale and a downscale to 299


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: torch and the host's BLAS otherwise
    oversubscribe the CPU under Tier-1's six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stats(seed, n=300, d=12, shift=0.0):
    r = np.random.default_rng(seed)
    a = r.standard_normal((n, d)) @ r.standard_normal((d, d)) * 0.3 + shift
    return a


def test_frechet_and_statistics_match_jax():
    a, b = _stats(0), _stats(1, shift=0.4)
    for x in (a, b):
        for mine, ref in zip(fid.activation_statistics(x),
                             jfid.activation_statistics(x)):
            np.testing.assert_array_equal(mine, ref)
    m1, s1 = fid.activation_statistics(a)
    m2, s2 = fid.activation_statistics(b)
    got = fid.frechet_distance(m1, s1, m2, s2)
    want = jfid.frechet_distance(m1, s1, m2, s2)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-9)
    # a rank-deficient pair (fewer samples than dimensions) takes the same
    # path in both
    c, d = _stats(2, n=6), _stats(3, n=7)
    args = (*fid.activation_statistics(c), *fid.activation_statistics(d))
    np.testing.assert_allclose(fid.frechet_distance(*args),
                               jfid.frechet_distance(*args), rtol=1e-9)


def test_frechet_closed_forms():
    acts = np.random.default_rng(0).normal(size=(500, 8))
    mu, sigma = fid.activation_statistics(acts)
    assert abs(fid.frechet_distance(mu, sigma, mu, sigma)) < 1e-6
    # equal covariance, mean shift d -> |d|^2
    np.testing.assert_allclose(
        fid.frechet_distance(np.zeros(4), np.eye(4),
                             np.array([1.0, 2.0, 0.0, 0.0]), np.eye(4)),
        5.0, rtol=1e-6)
    # N(0, a I) vs N(0, b I) in d dims: d (sqrt(a) - sqrt(b))^2
    np.testing.assert_allclose(
        fid.frechet_distance(np.zeros(3), 4.0 * np.eye(3), np.zeros(3),
                             np.eye(3)), 3.0, rtol=1e-6)
    base = np.random.default_rng(1).normal(size=(1000, 6))
    m0, s0 = fid.activation_statistics(base)
    small = fid.frechet_distance(m0, s0,
                                 *fid.activation_statistics(base + 0.1))
    big = fid.frechet_distance(m0, s0, *fid.activation_statistics(base + 1))
    assert 0 < small < big


def test_fid_given_npz_paths_and_missing_weights(tmp_path):
    a = np.random.default_rng(0).normal(size=(400, 16))
    for name, acts in (("a.npz", a), ("b.npz", a + 0.5)):
        np.savez(tmp_path / name, mu=acts.mean(0),
                 sigma=np.cov(acts, rowvar=False))
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert abs(fid.fid_given_paths(pa, pa)) < 1e-6
    np.testing.assert_allclose(fid.fid_given_paths(pa, pb),
                               jfid.fid_given_paths(pa, pb), rtol=1e-9)
    with pytest.raises(FileNotFoundError, match="pt_inception"):
        fid.InceptionFeaturizer("/nonexistent/weights.pth", device="cpu")


def test_resize_matches_jax_at_the_borders():
    """Bilinear resize to 299 without antialiasing, up and down, against
    jax.image.resize (antialias=False), border rows and columns included."""
    r = np.random.default_rng(5)
    for s in SIZES:
        x = r.random((2, s, s + 3, 3)).astype(np.float32)
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                          method="bilinear", antialias=False))
        got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                            size=(299, 299), mode="bilinear",
                            align_corners=False, antialias=False)
        got = got.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)
        for edge in (0, -1):
            np.testing.assert_allclose(got[:, edge], ref[:, edge], atol=1e-6)
            np.testing.assert_allclose(got[:, :, edge], ref[:, :, edge],
                                       atol=1e-6)


@pytest.fixture(scope="module")
def jax_inception():
    """JAX's seeded InceptionV3 parameters (flax init; batchnorm running
    statistics drawn so that the frozen normalisation is not the
    identity) and its features of seeded images at both sizes."""
    m = JaxInception()
    params = jax.jit(m.init)(jax.random.PRNGKey(0),
                             jnp.zeros((1, 80, 80, 3)))["params"]
    r = np.random.default_rng(3)

    def stats(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = stats(v)
            elif k == "bn_mean":
                out[k] = (0.1 * r.standard_normal(v.shape)).astype(np.float32)
            elif k == "bn_var":
                out[k] = (0.5 + r.random(v.shape)).astype(np.float32)
            elif k in ("bn_scale", "bn_bias"):
                base = 1.0 if k == "bn_scale" else 0.0
                out[k] = (base + 0.1 * r.standard_normal(v.shape)
                          ).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    params = stats(params)
    apply = jax.jit(lambda p, x: m.apply({"params": p}, x))
    imgs = {s: r.random((2, s, s, 3)).astype(np.float32) for s in SIZES}
    feats = {s: np.asarray(apply(params, jnp.asarray(x)))
             for s, x in imgs.items()}
    return params, imgs, feats


def test_inception_matches_jax_up_and_down(jax_inception):
    params, imgs, feats = jax_inception
    model = InceptionV3(device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           inception_flax_to_torch(params).items()},
                          strict=True)
    for s in SIZES:
        got = model(torch.from_numpy(imgs[s])).numpy()
        ref = feats[s]
        assert got.shape == (2, 2048) and got.dtype == np.float32
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel < 1e-4, (s, rel)
        assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max(), s


def test_pytorch_fid_state_dict_loads_in_both(jax_inception):
    """A pytorch-fid-named file (its 1008-way fc head included) loads with
    strict=True into the port, and into JAX's tree unchanged."""
    params, imgs, feats = jax_inception
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          inception_flax_to_torch(params).items()}
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    model = load_pytorch_fid_state_dict(InceptionV3(device="cpu"), sd)
    back = inception_torch_to_flax(sd)
    flat = lambda t: {"/".join(map(str, (getattr(k, "key", k) for k in p))):
                      np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(back), flat(params)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    got = model(torch.from_numpy(imgs[SIZES[0]])).numpy()
    np.testing.assert_allclose(got, feats[SIZES[0]], rtol=0,
                               atol=1e-4 * np.abs(feats[SIZES[0]]).max())
    with pytest.raises(RuntimeError, match="Missing key"):
        sd.pop("Mixed_7c.branch_pool.bn.running_var")
        load_pytorch_fid_state_dict(InceptionV3(device="cpu"), sd)


def test_random_featurizer_and_statistics_of_a_directory(tmp_path):
    """The "random" featurizer is seeded (two builds agree bit for bit);
    an image directory's statistics are those of its PNGs' features, and
    ``cli/fid_stats`` writes them in pytorch-fid's format."""
    from uspace_tpu_torch.utils.vis import save_image_batch

    imgs = np.random.default_rng(0).random((2, 16, 16, 3)).astype(np.float32)
    save_image_batch(imgs, str(tmp_path / "imgs"))
    a = fid.InceptionFeaturizer("random", device="cpu")
    b = fid.InceptionFeaturizer("random", device="cpu")
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    pix = np.round(imgs * 255) / 255
    fa = a(iter(pix), batch_size=1)  # a lazy iterable, one image a batch
    assert fa.shape == (2, 2048) and np.isfinite(fa).all() and fa.std() > 0
    out = str(tmp_path / "s.npz")
    from uspace_tpu_torch.cli import fid_stats

    fid_stats.main(["--images", str(tmp_path / "imgs"), "--out", out,
                    "--inception", "random", "--device", "cpu"])
    with np.load(out) as f:
        mu, sigma = f["mu"], f["sigma"]
    want_mu, want_sigma = fid.activation_statistics(fa)
    np.testing.assert_allclose(mu, want_mu, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sigma, want_sigma, rtol=1e-4, atol=1e-9)
    assert os.path.exists(out)
