"""The port's raw image datasets (``data/raw.py``), feature extraction
(``data/extraction.py``) and ``cli/extract_features`` held to the JAX
package's on files the tests write (32-pixel PNG and JPEG images, a tiny
SD-layout VAE).

What is held, and why:
- the raw datasets on the same files: images equal (both decode with the
  host's PIL), attributes, captions, labels and flips equal for the same
  seed and epoch;
- the writers on the same moments and contexts (a numpy stand-in encoder
  both packages call): every file byte for byte the same, h5 datasets of
  the same names, dtypes and values; then each package's feature datasets
  read the other's files item for item;
- extraction through the tiny VAE (JAX's params converted by
  ``load_vae_from_jax``): names, pickles, labels, attributes and h5 keys
  equal, the moments within 1e-4 of their scale (the same f32 arithmetic
  summed in another order);
- ``cli/extract_features`` on the CPU against JAX's
  ``extract_features_npy``, its VAE loaded strictly from a ``.pth`` in the
  reference's keys; its T2I format against JAX's writers with JAX's CLIP
  tower on the same Hugging Face weights (a toy tower and a stand-in
  tokenizer: the real vocabulary is not in the repository), contexts
  within 1e-5; its refusals.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from uspace_tpu.codecs import vae as jvae_mod
from uspace_tpu.codecs.clip_text import CLIPTextEncoder as JaxCLIP
from uspace_tpu.codecs.clip_text import clip_torch_to_flax
from uspace_tpu.codecs.convert import vae_torch_to_flax
from uspace_tpu.data import datasets as jds
from uspace_tpu.data import extraction as jex
from uspace_tpu.data import raw as jraw
from uspace_tpu_torch.cli import extract_features
from uspace_tpu_torch.codecs import clip_text
from uspace_tpu_torch.codecs import vae as tvae_mod
from uspace_tpu_torch.codecs.convert import load_vae_from_jax
from uspace_tpu_torch.data import datasets as tds
from uspace_tpu_torch.data import extraction as tex
from uspace_tpu_torch.data import raw as traw

TINY_DD = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
               attn_resolutions=(), in_channels=3, resolution=32,
               z_channels=4, double_z=True)
N = 6
RES = 16


def _same(a, b):
    """Two samples: the same keys, arrays equal exactly, scalars equal."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], (str, list)):
            assert a[k] == b[k], k
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _same_items(port, ref):
    assert len(port) == len(ref)
    for i in range(len(ref)):
        _same(port[i], ref[i])


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """N images, PNG and JPEG, square and not (the centre crop), with
    sidecar captions."""
    d = tmp_path_factory.mktemp("imgs")
    r = np.random.default_rng(0)
    for i in range(N):
        shape = (32, 32, 3) if i % 2 else (24, 40, 3)
        arr = (r.random(shape) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"{i}.{'png' if i < 3 else 'jpg'}")
        with open(d / f"{i}.txt", "w") as f:
            f.write(f"caption {i} a\ncaption {i} b\n")
    return str(d)


# ---------------------------------------------------------------------------
# the raw datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resolution", [None, RES])
def test_image_folder_and_load_image_match_jax(image_dir, resolution):
    files = traw.list_images(image_dir)
    assert files == jraw.list_images(image_dir)
    assert traw.list_images(image_dir, recursive=False) == files
    for f in files:
        for kw in ({}, dict(center_crop=False, resample=Image.BILINEAR)):
            a = traw.load_image(f, resolution, **kw)
            np.testing.assert_array_equal(a, jraw.load_image(f, resolution,
                                                             **kw))
            assert a.dtype == np.float32 and -1 <= a.min() <= a.max() <= 1
    if resolution:
        _same_items(traw.ImageFolder(image_dir, resolution),
                    jraw.ImageFolder(image_dir, resolution))


def _celeba_files(tmp_path, image_dir, n_rows):
    """A CelebA list_attr file (-1/1) for the first ``n_rows`` originals
    and an HQ -> CelebA mapping file."""
    r = np.random.default_rng(1)
    names = [f"attr{j}" for j in range(40)]
    attr = tmp_path / "list_attr.txt"
    with open(attr, "w") as f:
        f.write(f"{N}\n{' '.join(names)}\n")
        for i in range(n_rows):
            vals = r.choice([-1, 1], 40)
            f.write(f"{i + 1:06d}.jpg " + " ".join(map(str, vals)) + "\n")
    mapping = tmp_path / "mapping.txt"
    with open(mapping, "w") as f:
        f.write("idx orig_idx orig_file\n")
        for i in range(N):
            f.write(f"{i} {i} {i + 1:06d}.jpg\n")
    return str(attr), str(mapping)


def test_celeba_attrs_and_celebamask_hq_match_jax(image_dir, tmp_path):
    attr, mapping = _celeba_files(tmp_path, image_dir, N)
    mine, ref = traw.parse_celeba_attrs(attr), jraw.parse_celeba_attrs(attr)
    assert mine.keys() == ref.keys() and len(mine) == N
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k])
        assert mine[k].dtype == np.int64
    _same_items(traw.CelebAMaskHQ(image_dir, RES, attr, mapping),
                jraw.CelebAMaskHQ(image_dir, RES, attr, mapping))
    _same_items(traw.CelebAMaskHQ(image_dir, RES),
                jraw.CelebAMaskHQ(image_dir, RES))
    # no mapping: no HQ stem matches a CelebA name; a missing file
    for args in ((image_dir, RES, attr),
                 (image_dir, RES, str(tmp_path / "missing.txt"))):
        errors = []
        for mod in (traw, jraw):
            with pytest.raises((ValueError, FileNotFoundError)) as e:
                mod.CelebAMaskHQ(*args)
            errors.append(type(e.value))
        assert errors[0] is errors[1]
    # a row missing: zeros and a warning
    attr4, _ = _celeba_files(tmp_path, image_dir, 4)
    with pytest.warns(UserWarning):
        mine = traw.CelebAMaskHQ(image_dir, RES, attr4, mapping)
    with pytest.warns(UserWarning):
        ref = jraw.CelebAMaskHQ(image_dir, RES, attr4, mapping)
    _same_items(mine, ref)


def test_captioned_folder_and_txt_list_match_jax(image_dir, tmp_path):
    _same_items(traw.CaptionedImageFolder(image_dir, resolution=RES),
                jraw.CaptionedImageFolder(image_dir, resolution=RES))
    empty = tmp_path / "caps"
    empty.mkdir()
    a = traw.CaptionedImageFolder(image_dir, str(empty), RES)
    _same_items(a, jraw.CaptionedImageFolder(image_dir, str(empty), RES))
    assert a[0]["captions"] == [""]
    lst = tmp_path / "list.txt"
    names = sorted(os.listdir(image_dir))
    lst.write_text("\n".join(n for n in names if not n.endswith(".txt")))
    mine = traw.TxtListedImages(str(lst), image_dir, RES, seed=3)
    ref = jraw.TxtListedImages(str(lst), image_dir, RES, seed=3)
    flips = []
    for epoch in range(3):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        _same_items(mine, ref)
        flips.append([not np.array_equal(
            mine[i]["image"], traw.load_image(mine.files[i], RES))
            for i in range(len(mine))])
    assert any(map(any, flips)) and not all(map(all, flips))
    assert flips[0] != flips[1] or flips[1] != flips[2]
    _same_items(traw.TxtListedImages(str(lst), image_dir, RES, flip_p=0.0),
                jraw.TxtListedImages(str(lst), image_dir, RES, flip_p=0.0))


def _face(r):
    return {"gender": r.choice(["female", "male"]),
            "smile": float(r.random()),
            "glasses": r.choice(["NoGlasses", "ReadingGlasses"]),
            "emotion": {k: float(r.random())
                        for k in traw.FFHQ_ATTR11_KEYS[3:]}}


def test_ffhq_attr11_from_both_sources_matches_jax(image_dir, tmp_path):
    r = np.random.default_rng(2)
    faces = {str(i): _face(r) for i in range(N)}
    for face in faces.values():
        np.testing.assert_array_equal(traw.face_attributes_to_attr11(face),
                                      jraw.face_attributes_to_attr11(face))
    per_image = tmp_path / "json"
    per_image.mkdir()
    for k, face in faces.items():
        if k != "2":  # image 2: no face detected
            (per_image / f"{k}.json").write_text(
                json.dumps([{"faceAttributes": face}]))
    (per_image / "2.json").write_text("[]")
    consolidated = tmp_path / "attr.json"
    consolidated.write_text(json.dumps(
        {k: traw.face_attributes_to_attr11(f).tolist()
         for k, f in faces.items() if k != "4"}))
    for src in (str(per_image), str(consolidated)):
        mine, ref = traw.load_ffhq_attr11(src), jraw.load_ffhq_attr11(src)
        assert mine.keys() == ref.keys() and len(mine) == N - 1
        for k in ref:
            np.testing.assert_array_equal(mine[k], ref[k])
        _same_items(traw.FFHQAttr11(image_dir, src, resolution=RES),
                    jraw.FFHQAttr11(image_dir, src, resolution=RES))
    split = tmp_path / "split.txt"
    split.write_text("1.png\n3.jpg\n5.jpg\n")
    _same_items(traw.FFHQAttr11(image_dir, str(per_image), str(split), RES),
                jraw.FFHQAttr11(image_dir, str(per_image), str(split), RES))


def test_imagenet100_and_mscoco_match_jax(image_dir, tmp_path):
    root = tmp_path / "in100"
    for j, wnid in enumerate(("n02", "n01")):
        (root / wnid).mkdir(parents=True)
        for i in range(j + 2):
            Image.open(os.path.join(image_dir, f"{i}.png")).save(
                root / wnid / f"{wnid}_{i}.png")
    classes = tmp_path / "classes.txt"
    classes.write_text("n02\nn01\n")
    mine = traw.ImageNet100(str(root), str(classes), RES)
    _same_items(mine, jraw.ImageNet100(str(root), str(classes), RES))
    assert [int(mine[i]["y"]) for i in range(len(mine))] == [0, 0, 1, 1, 1]
    ann = tmp_path / "captions.json"
    ann.write_text(json.dumps({
        "images": [{"id": 7, "file_name": "1.png"},
                   {"id": 3, "file_name": "0.png"},
                   {"id": 5, "file_name": "4.jpg"}],
        "annotations": [{"image_id": 3, "caption": "a"},
                        {"image_id": 7, "caption": "b"},
                        {"image_id": 3, "caption": "c"}]}))
    mine = traw.MSCOCODatabase(image_dir, str(ann), RES)
    _same_items(mine, jraw.MSCOCODatabase(image_dir, str(ann), RES))
    # images by id (3, 5, 7), captions in file order
    assert [mine[i]["captions"] for i in range(3)] == [["a", "c"], [""],
                                                       ["b"]]


# ---------------------------------------------------------------------------
# the writers, byte for byte, and cross reads
# ---------------------------------------------------------------------------


def _stand_in_encoder(images):
    """Moments from pixels without a VAE: [B, h/2, w/2, 8], the same in
    both packages (numpy on whatever array comes in)."""
    x = np.asarray(images, np.float32)[:, ::2, ::2]
    return np.concatenate([x, -x, x * x, x[..., :2] - 30.0], axis=-1) \
        .astype(np.float32)


def _text(caps):
    return np.stack([np.full((5, 16), float(len(c)) + 0.5 * i, np.float32)
                     for i, c in enumerate(caps)])


def _bytes(d):
    out = {}
    for base, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


class _InMemory:
    """Samples from memory (both packages' writers read ``image`` and the
    sample's ``attr``, ``y`` or ``captions``)."""

    def __init__(self, n, **extra):
        r = np.random.default_rng(4)
        self.images = r.uniform(-1, 1, (n, RES, RES, 3)).astype(np.float32)
        self.extra = extra

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        s = {"image": self.images[i]}
        for k, f in self.extra.items():
            s[k] = f(i)
        return s


DATASETS = {
    "cond": dict(attr=lambda i: (np.arange(40) % (i + 2) == 0)
                 .astype(np.int64)),
    "labeled": dict(y=lambda i: i % 3),
}


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("kind", sorted(DATASETS))
def test_npy_files_are_the_jax_files(tmp_path, kind, flip):
    ds = _InMemory(N, **DATASETS[kind])
    mine, ref = tmp_path / "port", tmp_path / "jax"
    n = tex.extract_features_npy(ds, _stand_in_encoder, str(mine), 4, flip)
    assert n == jex.extract_features_npy(ds, _stand_in_encoder, str(ref), 4,
                                         flip) == N * (2 if flip else 1)
    assert _bytes(mine) == _bytes(ref)
    # each package reads the other's files
    _same_items(tds.NpyFeatureDataset(str(ref), fmt=kind),
                jds.NpyFeatureDataset(str(mine), fmt=kind))
    got = tds.NpyFeatureDataset(str(mine), fmt=kind)
    assert len(got) == n
    want = _stand_in_encoder(ds.images[:1])[0]
    np.testing.assert_array_equal(got[0]["x"], want)
    if flip:
        np.testing.assert_array_equal(
            got[N]["x"], _stand_in_encoder(ds.images[:1, :, ::-1])[0])


def test_t2i_files_are_the_jax_files(tmp_path):
    ds = _InMemory(N, captions=lambda i: [f"cap {i}"] * (1 + i % 3))
    mine, ref = tmp_path / "port", tmp_path / "jax"
    for mod, d in ((tex, mine), (jex, ref)):
        assert mod.extract_t2i_features(ds, _stand_in_encoder, _text,
                                        str(d / "train"), 4) == N
        mod.extract_t2i_features(ds, _stand_in_encoder, _text,
                                 str(d / "val"), 4)
        mod.extract_empty_context(_text, str(d))
        mod.extract_test_prompts(["a cat", "a dog", "x"], _text, str(d))
    assert _bytes(mine) == _bytes(ref)
    assert tds.get_feature_dir_info(str(mine / "train")) == \
        jds.get_feature_dir_info(str(ref / "train"))
    for name in ("mmcelebahq256_features_withcaptioncontext",
                 "mscoco256_features", "mscoco256_features_withcaptioncontext"):
        kw = dict(path=str(mine))
        if name.startswith("mscoco"):
            kw["expected_sizes"] = (N, N)
        port, jax_ = (tds.get_dataset(name, **kw),
                      jds.get_dataset(name, **dict(kw, path=str(ref))))
        for split in ("train", "test"):
            a, b = port.get_split(split), jax_.get_split(split)
            for epoch in range(3):  # the caption draws
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                _same_items(a, b)
        np.testing.assert_array_equal(port.empty_context, jax_.empty_context)
        assert port.prompts == jax_.prompts == ["a cat", "a dog", "x"]
        np.testing.assert_array_equal(port.contexts, jax_.contexts)
    with pytest.raises(ValueError):
        tds.get_dataset("mscoco256_features", path=str(mine))


def test_h5_files_hold_the_jax_datasets(tmp_path):
    import h5py

    ds = _InMemory(N, **DATASETS["cond"])
    mine, ref = str(tmp_path / "p" / "f.h5"), str(tmp_path / "j" / "f.h5")
    assert tex.extract_features_h5(ds, _stand_in_encoder, mine, 4) == N
    jex.extract_features_h5(ds, _stand_in_encoder, ref, 4)
    with h5py.File(mine, "r") as a, h5py.File(ref, "r") as b:
        assert sorted(a) == sorted(b) == ["train_attr", "train_feat"]
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k][:], b[k][:])
    for load_in_mem in (True, False):
        _same_items(tds.H5FeatureDataset(ref, load_in_mem),
                    jds.H5FeatureDataset(mine, load_in_mem))
    with h5py.File(str(tmp_path / "l.h5"), "w") as f:
        f["train_feat"] = np.ones((3, 8, 4, 4), np.float32)
        f["train_label"] = np.array([2, 0, 1])
    for name in ("ffhq256_features", "churches256_features"):
        a = tds.get_dataset(name, path=str(tmp_path / "l.h5"), fid_stat="s")
        b = jds.get_dataset(name, path=str(tmp_path / "l.h5"), fid_stat="s")
        _same_items(a.train, b.train)
        assert a.fid_stat == b.fid_stat == "s"


# ---------------------------------------------------------------------------
# extraction through a tiny VAE, and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_vae(tmp_path_factory):
    """(JAX params, the port's VAE on them, its ``.pth`` in the reference's
    keys)."""
    src = tvae_mod.AutoencoderKL(TINY_DD, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    params = {"params": vae_torch_to_flax(src.state_dict())}
    vae = load_vae_from_jax(tvae_mod.AutoencoderKL(TINY_DD, device="cpu"),
                            params).eval()
    pth = str(tmp_path_factory.mktemp("vae") / "autoencoder_kl.pth")
    torch.save(vae.state_dict(), pth)
    return params, vae, pth


def _moments_close(port, ref):
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def _same_npy_dirs(mine, ref):
    """Two npy feature directories: the same files, each pickle's moments
    within the f32 tolerance and its other fields equal."""
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref))
    for f in os.listdir(ref):
        a = np.load(os.path.join(mine, f), allow_pickle=True)
        b = np.load(os.path.join(ref, f), allow_pickle=True)
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype != object:
            _moments_close(a, b)
            continue
        assert a[0].dtype == b[0].dtype == np.float32
        _moments_close(a[0], b[0])
        for x, y in zip(a[1:], b[1:]):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)


def test_tiny_vae_extraction_matches_jax(tiny_vae, tmp_path):
    params, vae, _ = tiny_vae
    jv = jvae_mod.AutoencoderKL(ddconfig=TINY_DD)
    jenc = jax.jit(lambda x: jv.apply(params, x, method=jv.encode_moments))
    tenc = tex.make_vae_encoder(vae)
    x = _InMemory(2).images
    got = tenc(x)
    assert got.shape == (2, RES // 2, RES // 2, 8) and got.dtype == np.float32
    _moments_close(got, np.asarray(jenc(jnp.asarray(x))))
    _moments_close(tenc(torch.from_numpy(x)), got)
    ds = _InMemory(N, **DATASETS["cond"])
    tex.extract_features_npy(ds, tenc, str(tmp_path / "p"), 4, flip=True)
    jex.extract_features_npy(ds, jenc, str(tmp_path / "j"), 4, flip=True)
    _same_npy_dirs(str(tmp_path / "p"), str(tmp_path / "j"))


def test_cli_matches_jax_extraction(tiny_vae, image_dir, tmp_path,
                                    monkeypatch):
    """``cli/extract_features`` (CelebAMask-HQ with attributes, the VAE from
    the ``.pth``) against JAX's ``extract_features_npy`` on the same raw
    dataset and weights; the SD layout is the tiny one on both sides."""
    params, _, pth = tiny_vae
    monkeypatch.setattr(tvae_mod, "SD_CONFIG", TINY_DD)
    monkeypatch.setattr(jvae_mod, "SD_CONFIG", TINY_DD)
    attr, mapping = _celeba_files(tmp_path, image_dir, N)
    # the JAX CLI reads no mapping file: name the images as CelebA does
    hq = tmp_path / "hq"
    hq.mkdir()
    for i, f in enumerate(traw.list_images(image_dir)):
        Image.open(f).save(hq / f"{i + 1:06d}.png")
    out = str(tmp_path / "port")
    assert extract_features.main([
        "--images", str(hq), "--attr_file", attr, "--vae", pth, "--out", out,
        "--resolution", str(RES), "--batch_size", "4",
        "--device", "cpu"]) == out
    ref = str(tmp_path / "jax")
    jex.extract_features_npy(jraw.CelebAMaskHQ(str(hq), RES, attr),
                             jex.make_vae_encoder(params), ref, 4)
    _same_npy_dirs(out, ref)
    got = tds.get_dataset("celebamask256_features_cond", path=out, num=N)
    assert len(got.train) == N and got.train[0]["x"].shape == (8, 8, 8)
    assert got.train[0]["attr"].shape == (40,)


def test_cli_refusals(tmp_path, image_dir):
    with pytest.raises(SystemExit):  # t2i without CLIP, before any file
        extract_features.main(["--images", image_dir, "--out",
                               str(tmp_path / "o"), "--format", "t2i",
                               "--device", "cpu"])
    assert not (tmp_path / "o").exists()
    with pytest.raises(FileNotFoundError):  # no VAE weights
        extract_features.main(["--images", image_dir, "--vae",
                               str(tmp_path / "none.pth"), "--out",
                               str(tmp_path / "o"), "--device", "cpu"])
    with pytest.raises(RuntimeError if not torch.cuda.is_available()
                       else FileNotFoundError):  # the card by default
        extract_features.main(["--images", image_dir, "--vae",
                               str(tmp_path / "none.pth"), "--out",
                               str(tmp_path / "o")])


CLIP_TOY = dict(vocab_size=50, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=4, max_length=7)
_HF_LAYER = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "out": "self_attn.out_proj",
             "ln1": "layer_norm1", "ln2": "layer_norm2", "fc1": "mlp.fc1",
             "fc2": "mlp.fc2"}


def _hf_state_dict(enc):
    """The port's CLIP tower's weights under Hugging Face
    ``CLIPTextModel``'s names, with its ``position_ids`` buffer."""
    out = {"text_model.embeddings.position_ids":
           torch.arange(CLIP_TOY["max_length"])[None]}
    for k, v in enc.state_dict().items():
        parts = k.split(".")
        if parts[0] == "layers":
            k = f"encoder.layers.{parts[1]}.{_HF_LAYER[parts[2]]}.{parts[3]}"
        elif parts[0] in ("token_embedding", "position_embedding"):
            k = "embeddings." + k
        else:
            k = k.replace("final_ln", "final_layer_norm")
        out["text_model." + k] = v.clone()
    return out


class _Tokenizer:
    """CLIP's tokenizer interface with ids from the text's words (its
    vocabulary is not in the repository): start 48, end 49 as padding."""

    def __call__(self, texts, truncation=True, max_length=77,
                 padding="max_length", return_tensors="np"):
        ids = np.full((len(texts), max_length), 49, np.int64)
        ids[:, 0] = 48
        for i, t in enumerate(texts):
            w = [1 + sum(map(ord, x)) % 40 for x in t.split()]
            w = w[:max_length - 2]
            ids[i, 1:1 + len(w)] = w
        return {"input_ids": ids}


def test_hf_clip_weights_load_as_jax_loads_them():
    """``clip_hf_to_torch`` maps a Hugging Face state dict onto the port's
    tower as JAX's ``clip_torch_to_flax`` maps it onto JAX's: the same
    contexts (1e-5), the original's exactly."""
    src = clip_text.build_clip(CLIP_TOY, "cpu", seed=3)
    hf = _hf_state_dict(src)
    enc = clip_text.CLIPTextEncoder(**CLIP_TOY, device="cpu")
    enc.load_state_dict(clip_text.clip_hf_to_torch(hf), strict=True)
    ids = _Tokenizer()(["a red car", "", "x y z w v u t"], max_length=7)[
        "input_ids"]
    with torch.no_grad():
        got = enc(torch.from_numpy(ids))
        assert torch.equal(got, src(torch.from_numpy(ids)))
    ref = JaxCLIP(**CLIP_TOY).apply({"params": clip_torch_to_flax(hf)},
                                    jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_cli_t2i_matches_jax(tiny_vae, image_dir, tmp_path, monkeypatch):
    """``--format t2i`` with ``--clip`` (Hugging Face weights of the toy
    tower, the stand-in tokenizer), ``--empty_context`` and ``--prompts``
    against JAX's writers with JAX's VAE and tower on the same weights:
    the same files, captions byte for byte, moments and contexts within
    their f32 tolerances."""
    import transformers

    params, _, pth = tiny_vae
    monkeypatch.setattr(tvae_mod, "SD_CONFIG", TINY_DD)
    monkeypatch.setattr(jvae_mod, "SD_CONFIG", TINY_DD)
    monkeypatch.setattr(clip_text, "CLIP_L14", CLIP_TOY)
    monkeypatch.setattr(transformers.CLIPTokenizer, "from_pretrained",
                        lambda *a, **k: _Tokenizer())
    clip_dir = tmp_path / "clip"
    clip_dir.mkdir()
    hf = _hf_state_dict(clip_text.build_clip(CLIP_TOY, "cpu", seed=4))
    torch.save(hf, clip_dir / "pytorch_model.bin")
    mine, ref = tmp_path / "port", tmp_path / "jax"
    extract_features.main([
        "--images", image_dir, "--clip", str(clip_dir), "--format", "t2i",
        "--vae", pth, "--out", str(mine / "train"), "--resolution", str(RES),
        "--batch_size", "4", "--empty_context", "--prompts", "a cat,a dog",
        "--device", "cpu"])
    jclip, jp = JaxCLIP(**CLIP_TOY), {"params": clip_torch_to_flax(hf)}

    def jax_text(caps):
        ids = _Tokenizer()(list(caps), max_length=7)["input_ids"]
        return np.asarray(jclip.apply(jp, jnp.asarray(ids)))

    jex.extract_t2i_features(jraw.CaptionedImageFolder(image_dir, None, RES),
                             jex.make_vae_encoder(params), jax_text,
                             str(ref / "train"), 4)
    jex.extract_empty_context(jax_text, str(ref))
    jex.extract_test_prompts(["a cat", "a dog"], jax_text, str(ref))
    a, b = _bytes(mine), _bytes(ref)
    assert sorted(a) == sorted(b)
    for name in b:
        if name.endswith(".txt"):
            assert a[name] == b[name], name
            continue
        x = np.load(mine / name, allow_pickle=True)
        y = np.load(ref / name, allow_pickle=True)
        if x.dtype == object:  # run_vis: (prompt, context)
            assert x[0] == y[0]
            x, y = x[1], y[1]
        if x.shape[-1] == CLIP_TOY["hidden_size"]:  # a context
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-5)
        else:
            _moments_close(x, y)
