"""The port's data path held to the JAX package's: ``data/loader.
DataLoader`` against ``uspace_tpu.data.loader.DataLoader`` batch for batch,
the ``synthetic`` factory against JAX's ``Synthetic``, the editing proofs'
toy configs against the JAX configs, the batches ``cli/train_lfm.run``
feeds against the JAX loop's loader for the same seed, and every feature
dataset and factory of the registry against JAX's on files the tests write
(the four npy layouts, h5, raw image folders), over three epochs of draws.
Every comparison is exact: both sides draw the same numpy samples in the
same order.
"""

import numpy as np
import pytest
import torch

from uspace_tpu.configs import (
    synthetic_attr_e2e,
    synthetic_attr_pixel_e2e,
    synthetic_attr_unet_e2e,
)
from uspace_tpu.data import datasets as jds
from uspace_tpu.data.datasets import get_dataset as jax_get_dataset
from uspace_tpu.data.loader import DataLoader as JaxLoader
from uspace_tpu_torch.cli import train_lfm
from uspace_tpu_torch.configs import get_config
from uspace_tpu_torch.data import datasets as tds
from uspace_tpu_torch.data.datasets import SyntheticAttr, get_dataset
from uspace_tpu_torch.data.loader import DataLoader

JAX_TOYS = {"synthetic_attr_e2e": synthetic_attr_e2e,
            "synthetic_attr_unet_e2e": synthetic_attr_unet_e2e,
            "synthetic_attr_pixel_e2e": synthetic_attr_pixel_e2e}


@pytest.fixture(autouse=True)
def one_thread():
    """The toys' models are small: one intra-op thread builds them as fast
    and keeps them from spinning against other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("process_count", [1, 2])
def test_loader_epochs_are_the_jax_batches(shuffle, drop_last,
                                           process_count):
    """Three epochs of every process's shard over 37 SyntheticAttr samples
    (a short last batch, shards of 19 and 18): the same batches, batch
    counts and epoch announcements as JAX's loader."""
    data = SyntheticAttr(num=37).get_split("train")
    for p in range(process_count):
        kw = dict(shuffle=shuffle, drop_last=drop_last, seed=5,
                  num_workers=2, process_index=p,
                  process_count=process_count)
        mine, ref = DataLoader(data, 4, **kw), JaxLoader(data, 4, **kw)
        assert mine.n_batches() == ref.n_batches()
        for epoch in range(3):
            got, want = list(mine.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want) == mine.n_batches()
            for a, b in zip(got, want):
                _same(a, b)
        _same(next(iter(mine)), next(iter(ref)))


@pytest.mark.parametrize("start_step", [0, 3, 9, 20])
def test_loader_infinite_resumes_where_jax_does(start_step):
    """``infinite(start_step)`` yields JAX's batches from the same step
    across epoch boundaries (10 batches an epoch), with each epoch announced
    to a dataset that listens; a loader of no batches refuses."""
    class Listening:
        def __init__(self):
            self.data, self.epochs = SyntheticAttr(num=40).train, []

        def __len__(self):
            return len(self.data)

        def __getitem__(self, i):
            return self.data[i]

        def set_epoch(self, e):
            self.epochs.append(e)

    mine_ds, ref_ds = Listening(), Listening()
    mine = DataLoader(mine_ds, 4, seed=1, num_workers=2).infinite(start_step)
    ref = JaxLoader(ref_ds, 4, seed=1, num_workers=2).infinite(start_step)
    for a, b in zip(_take(mine, 12), _take(ref, 12)):
        _same(a, b)
    assert mine_ds.epochs == ref_ds.epochs and mine_ds.epochs[0] == \
        start_step // 10
    with pytest.raises(ValueError, match="0 batches"):
        next(DataLoader(mine_ds, 64).infinite())


def test_synthetic_factory_is_the_jax_one():
    """``get_dataset("synthetic")``: the JAX ``Synthetic`` factory's train
    and test splits, sample for sample."""
    mine = get_dataset("synthetic", num=12, shape=(4, 4, 8))
    ref = jax_get_dataset(name="synthetic", num=12, shape=(4, 4, 8))
    for split in ("train", "test"):
        a, b = mine.get_split(split), ref.get_split(split)
        assert len(a) == len(b)
        for i in (0, len(a) - 1):
            _same(a[i], b[i])
    assert mine.data_shape == ref.data_shape == (4, 4, 4)
    with pytest.raises(NotImplementedError, match="no_such_dataset"):
        get_dataset("no_such_dataset")


def _plain(v):
    if hasattr(v, "to_dict"):
        v = v.to_dict()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    return v


# what one side has and the other has not: the port's U-ViT view switch
# (the dissection blocks carry the same keys since the port has the base
# config's every key)
PORT_ONLY = {"uvit": {"quant"}}
JAX_ONLY = {}


@pytest.mark.parametrize("name", sorted(JAX_TOYS))
def test_toy_configs_are_the_jax_configs(name):
    """The toys' nnet, dataset, train, dissection, optimizer and solver
    blocks, seed and latent shape equal the JAX configs' key for key (the
    tap None there is "mid" here, the JAX harness's default)."""
    mine, ref = _plain(get_config(name)), _plain(JAX_TOYS[name].get_config())
    for k in ("seed", "z_shape", "compute_dtype"):
        assert mine[k] == ref[k], k
    for blk in ("nnet", "dataset", "train", "dissection", "optimizer",
                "lr_scheduler", "dynamic"):
        a, b = mine[blk], ref[blk]
        port_only = PORT_ONLY.get(a["name"], set()) if blk == "nnet" else set()
        assert set(a) - set(b) == port_only, blk
        assert set(b) - set(a) == JAX_ONLY.get(blk, set()), blk
        for key in set(a) & set(b):
            want = b[key]
            if (blk, key) == ("dissection", "edit_loc"):
                want = want or "mid"
            assert a[key] == want, (blk, key)
    assert mine["sample"]["solver_kwargs"] == ref["sample"]["solver_kwargs"]


@pytest.mark.parametrize("name", sorted(JAX_TOYS))
def test_train_lfm_feeds_the_jax_loops_batches(monkeypatch, tmp_path, name):
    """``train_lfm.run`` on a toy config feeds its step the batches the JAX
    loop draws for the config's seed (``uspace_tpu/train/loop.py:59-69``:
    the config's dataset, its batch, its seed; ``:399``: ``infinite``),
    moments or raw latents as the config says, and trains
    ``train.n_steps`` when not told otherwise."""
    fed, made = [], {}

    def fake_step(model, tx, **kw):
        made.update(kw)

        def step(state, batch, gen):
            fed.append(batch["x"].numpy().copy())
            z = torch.zeros(())
            return dict(loss=z, grad_norm=z, lr=z, nonfinite_skip=z)
        return step

    monkeypatch.setattr(train_lfm, "make_train_step", fake_step)
    monkeypatch.setattr(train_lfm.checkpoint, "save",
                        lambda root, state: str(tmp_path / "ck.pt"))
    cfg = get_config(name)
    cfg["train"]["n_steps"] = 3
    out = train_lfm.run(cfg, device="cpu", workdir=str(tmp_path),
                        log=lambda s: None)
    assert len(out["history"]) == len(fed) == 3
    jcfg = JAX_TOYS[name].get_config()
    ref = JaxLoader(jax_get_dataset(**dict(jcfg.dataset)).get_split("train"),
                    jcfg.train.batch_size, seed=jcfg.seed,
                    num_workers=jcfg.dl.num_workers).infinite(start_step=0)
    for x, want in zip(fed, _take(ref, 3)):
        np.testing.assert_array_equal(x, want["x"])
    assert made["latents_from_moments"] == jcfg.train.from_moments
    assert fed[0].shape == ((256, 8, 8, 8) if jcfg.train.from_moments
                            else (256, 8, 8, 4))


def test_loader_surfaces_errors_and_leaves_no_thread():
    """A sample that raises reaches the consumer; an epoch left after one
    batch and an epoch that raised leave no producer thread behind."""
    import threading
    import time

    class Failing:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            if i == 9:
                raise KeyError(f"sample {i}")
            return {"x": np.full((2,), i, np.float32)}

    before = set(threading.enumerate())

    def started():
        return [t for t in threading.enumerate() if t not in before]

    loader = DataLoader(Failing(), 2, shuffle=False, num_workers=2,
                        prefetch=1)
    with pytest.raises(KeyError, match="sample 9"):
        list(loader.epoch(0))
    it = loader.epoch(0)
    np.testing.assert_array_equal(next(it)["x"][:, 0], [0, 1])
    it.close()
    deadline = time.monotonic() + 5.0
    while started() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not started()


# ---------------------------------------------------------------------------
# the feature datasets and the registry's factories on files
# ---------------------------------------------------------------------------


def _moments(r, shape=(8, 4, 4)):
    return r.standard_normal(shape).astype(np.float32)


def _write_npy(d, fmt, n, r):
    """n files of one layout (CHW moments, as the reference stores them)."""
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        z = _moments(r)
        obj = {"plain": z,
               "pair": np.array((z, z), dtype=object),
               "cond": np.array((z, np.zeros((1,), np.uint8),
                                 r.integers(0, 2, 40)), dtype=object),
               "labeled": np.array((z, np.int64(i % 7)), dtype=object)}[fmt]
        np.save(d / f"{i}.npy", obj, allow_pickle=fmt != "plain")
    return str(d)


def _same_split(a, b, epochs=3):
    """Two datasets item for item over ``epochs`` announced epochs."""
    assert len(a) == len(b)
    for epoch in range(epochs):
        for ds in (a, b):
            getattr(ds, "set_epoch", lambda e: None)(epoch)
        for i in range(len(a)):
            _same(a[i], b[i])


@pytest.mark.parametrize("fmt", tds.NpyFeatureDataset.FORMATS)
def test_npy_feature_dataset_is_the_jax_one(tmp_path, fmt):
    path = _write_npy(tmp_path / fmt, fmt, 5, np.random.default_rng(0))
    (tmp_path / fmt / "0_0.npy").write_bytes(b"")  # a context: not counted
    for num in (None, 3):
        mine = tds.NpyFeatureDataset(path, num, fmt)
        ref = jds.NpyFeatureDataset(path, num, fmt)
        assert len(mine) == (num or 5)
        _same_split(mine, ref, epochs=1)
    x = tds.NpyFeatureDataset(path, fmt=fmt)[0]["x"]
    assert x.shape == (4, 4, 8) and x.dtype == np.float32
    with pytest.raises(ValueError):
        tds.NpyFeatureDataset(path, fmt="npz")


def _factory_cases(tmp_path):
    """(name, kwargs) of every registry name but the synthetic ones and
    the captioned ones (tests/test_torch_extraction.py), each on files of
    its layout."""
    r = np.random.default_rng(1)
    pair = _write_npy(tmp_path / "pair", "pair", 4, r)
    cond = _write_npy(tmp_path / "cond", "cond", 4, r)
    labeled = _write_npy(tmp_path / "labeled", "labeled", 6, r)
    import h5py
    from PIL import Image

    h5 = str(tmp_path / "f.h5")
    with h5py.File(h5, "w") as f:
        f["train_feat"] = r.standard_normal((5, 8, 4, 4)).astype(np.float32)
        f["train_attr"] = r.integers(0, 2, (5, 11))
        f["train_label"] = np.arange(5)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(3):
        Image.fromarray((r.random((12, 10, 3)) * 255).astype(np.uint8)).save(
            imgs / f"{i}.png")
    attr = tmp_path / "attr.txt"
    attr.write_text("3\n" + " ".join(f"a{j}" for j in range(40)) + "\n" + "".join(
        f"{i}.jpg " + " ".join(map(str, r.choice([-1, 1], 40))) + "\n"
        for i in range(3)))
    cases = [("celebamask256_features", dict(path=pair, num=4)),
             ("celebamask256_features_cond", dict(path=cond, num=4)),
             ("imagenet256_features", dict(path=labeled, num=6)),
             ("imagenet256_features", dict(path=labeled, num=6, cfg=True,
                                           p_uncond=0.5)),
             ("imagenet512_features", dict(path=labeled, num=6))]
    cases += [(n, dict(path=h5)) for n in (
        "ffhq256_features", "metfaces256_features", "AFHQ256_cat_features",
        "AFHQ256_dog_features", "churches256_features")]
    cases += [(n, dict(path=str(imgs), resolution=8)) for n in (
        "real_img", "ffhq256", "celeba", "imagenet", "cifar10")]
    cases += [("celeba", dict(path=str(imgs), resolution=8,
                              attr_file=str(attr)))]
    cases += [("synthetic_class", dict(num=12, cfg=True, p_uncond=0.5)),
              ("synthetic_t2i", dict(num=12, cfg=True, p_uncond=0.5)),
              ("synthetic_attr", dict(num=12, raw=True))]
    return cases


def test_every_factory_is_the_jax_one(tmp_path):
    """Each factory's splits item for item over three epochs (the CFG drop
    draws), its data_shape, classes, null label, null context and FID
    statistics, against JAX's for the same arguments."""
    cases = _factory_cases(tmp_path)
    assert {n for n, _ in cases} | {
        "synthetic", "mscoco256_features",
        "mmcelebahq256_features_withcaptioncontext"} == set(jds._REGISTRY)
    for name, kw in cases:
        mine, ref = get_dataset(name, **kw), jax_get_dataset(name, **kw)
        assert type(mine).__name__ == type(ref).__name__, name
        for split in ("train", "test"):
            if getattr(ref, split, None) is None:
                with pytest.raises(ValueError):
                    mine.get_split(split)
                continue
            _same_split(mine.get_split(split), ref.get_split(split))
        for attr in ("K", "has_label", "fid_stat", "null_label",
                     "resolution"):
            assert getattr(mine, attr, None) == getattr(ref, attr, None), \
                (name, attr)
        try:
            want = ref.data_shape
        except AttributeError:  # JAX's reads the CFG-wrapped train split's
            want = ref.test.latent_shape
        assert mine.data_shape == want, name
        if getattr(ref, "empty_context", None) is not None:
            np.testing.assert_array_equal(mine.empty_context,
                                          ref.empty_context)


def test_factory_base_and_refusals(tmp_path):
    pair = _write_npy(tmp_path / "pair", "pair", 2, np.random.default_rng(2))
    for mod in (tds, jds):  # CFG on a dataset without a null condition
        with pytest.raises(NotImplementedError):
            mod.get_dataset("celebamask256_features", path=pair, cfg=True)
    ds = get_dataset("imagenet256_features", path=pair, num=2)
    gen = torch.Generator().manual_seed(3)
    y = ds.sample_label(gen, 64)
    assert y.shape == (64,) and y.dtype == torch.int64
    assert 0 <= int(y.min()) and int(y.max()) < 1000
    assert torch.equal(y, ds.sample_label(torch.Generator().manual_seed(3),
                                          64))
    with pytest.raises(NotImplementedError):
        get_dataset("celebamask256_features", path=pair).sample_label(gen, 2)
    x = np.linspace(-2, 2, 9, dtype=np.float32)
    np.testing.assert_array_equal(ds.unpreprocess(x),
                                  jds.DatasetFactory.unpreprocess(x))
    np.testing.assert_array_equal(tds.unpreprocess(x), ds.unpreprocess(x))
    got = get_dataset("celebamask256_features", path=pair, num=2,
                      fid_stat="s.npz")
    assert got.fid_stat == "s.npz"
    assert get_dataset("celebamask256_features", path=pair).fid_stat == \
        jds.CM256Features.fid_stat
