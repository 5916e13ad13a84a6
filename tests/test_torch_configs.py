"""The port's configs (``uspace_tpu_torch/configs.py``) held to the JAX
package's config modules key by key, the batch rule on every config, the
stand-ins' derivation, the dataset names every config reads, and the
provenance path helpers against ``uspace_tpu/configs/provenance.py``.

A JAX config is flattened (``to_dict``, lists as tuples) and compared with
its port counterpart on every key of either. What may differ is listed
here, each with its reason, and nothing else:
- keys of the port's own: the VAE module's layout (``autoencoder.ddconfig``,
  ``autoencoder.embed_dim``) and the U-ViT's int8 switch (``nnet.quant``);
- ``train.batch_size``: the port's is one card's, by the rule
  (``configs.per_card``), checked on its own below;
- the toys' documented choices (``TOY_CHOICES``).
"""

import importlib
import pkgutil

import pytest

import uspace_tpu.configs as jax_configs
from uspace_tpu.configs import provenance as jprov
from uspace_tpu.data import datasets as jds
from uspace_tpu_torch import configs
from uspace_tpu_torch.data import datasets as tds

JAX_MODULES = sorted(m.name for m in pkgutil.iter_modules(
    jax_configs.__path__) if m.name not in ("common", "provenance"))
PORT_ONLY = ("autoencoder.ddconfig", "autoencoder.embed_dim", "nnet.quant")
# the stand-ins and the JAX module each derives from
STAND_INS = {"uvit_large": "lfm_cm256_uvit_large",
             "unet_large": "lfm_cm256_unet_large",
             "unet_large_512": "lfm_cm256_unet_large",
             "uvit_t2i_large": "lfm_mscoco_uvit_from_in256",
             "uvit_t2i_small_deep16": "lfm_mscoco_uvit_small_deep16_v2"}
# the keys a stand-in sets beside its dataset: the editing harness's
# dissection (the mid tap, Euler at 0.02), and the 512-px UNet's two
# overrides of the JAX command line (--config.nnet.image_size=64,
# --config.z_shape="(4, 64, 64)")
STAND_IN_KEYS = {"uvit_large": ("dissection",),
                 "unet_large_512": ("dissection", "nnet.image_size",
                                    "z_shape")}
# the toys' choices: the mid tap named where JAX leaves edit_loc unset
# (both harnesses read None as "mid"); one loader thread (the draws are
# Python: more threads only contend for the interpreter lock); the CPU
# smoke config trains on attribute-structured moments (64) so that the
# dissect CLI's read and attr directions run on it, at CPU-sized
# dissection counts and solve
_HARNESS = {"dissection.edit_loc": "mid", "dl.num_workers": 1}
TOY_CHOICES = {
    "synthetic_attr_e2e": _HARNESS,
    "synthetic_attr_unet_e2e": _HARNESS,
    "synthetic_attr_pixel_e2e": _HARNESS,
    "synthetic_cond_e2e": _HARNESS,
    "synthetic_t2i_e2e": _HARNESS,
    "synthetic_t2i_unet_e2e": _HARNESS,
    "synthetic_smoke": {
        "dataset.name": "synthetic_attr", "dataset.num": 64,
        "dataset.num_attrs": 4, "dissection.edit_loc": "mid",
        "dissection.n_samples": 8, "dissection.mini_batch_size": 4,
        "dissection.pca_n": 4, "dissection.write_scales": (-100, 0, 100),
        "dissection.solver_kwargs.solver_fix_step": 0.25,
        "dissection.solver_kwargs.solver_adaptive": None,
        "dissection.solver_kwargs.solver_adaptive_prec": None},
}
MISSING = object()


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = tuple(v) if isinstance(v, list) else v
    return out


def _jax(name):
    return importlib.import_module(f"uspace_tpu.configs.{name}") \
        .get_config()


def _diff(port, ref):
    """{key: (port value, JAX value)} over the keys of either."""
    return {k: (port.get(k, MISSING), ref.get(k, MISSING))
            for k in set(port) | set(ref)
            if port.get(k, MISSING) != ref.get(k, MISSING)}


def _port_only(k):
    return any(k == p or k.startswith(p + ".") for p in PORT_ONLY)


def test_every_jax_config_module_has_a_counterpart():
    assert len(JAX_MODULES) == 21
    assert set(JAX_MODULES) <= set(configs.CONFIGS)


@pytest.mark.parametrize("name", JAX_MODULES)
def test_config_matches_the_jax_module_key_by_key(name):
    port, ref = _flat(configs.get_config(name)), _flat(_jax(name).to_dict())
    diff = {k: v for k, v in _diff(port, ref).items()
            if not _port_only(k) and k != "train.batch_size"}
    want = TOY_CHOICES.get(name, {})
    assert {k: v[0] if v[0] is not MISSING else None
            for k, v in diff.items()} == want


@pytest.mark.parametrize("name", sorted(STAND_INS))
def test_stand_ins_are_their_jax_config_but_the_dataset(name):
    port = _flat(configs.get_config(name))
    src = _flat(configs.get_config(STAND_INS[name]))
    diff = {k.split(".")[0] if k.startswith(("dataset.", "dissection."))
            else k for k in _diff(port, src)}
    assert diff == {"dataset", *STAND_IN_KEYS.get(name, ())}
    # the stand-in's data has the JAX dataset's shapes
    cfg = configs.get_config(name)
    shape = cfg["dataset"]["shape"]
    c, h, w = cfg["z_shape"]
    assert shape == (h, w, 2 * c)
    if cfg["train"]["mode"] == "t2i":
        nnet = cfg["nnet"]
        assert (cfg["dataset"]["num_tokens"], cfg["dataset"]["ctx_dim"]) == \
            (nnet["num_clip_token"], nnet["clip_dim"])


@pytest.mark.parametrize("name", sorted(configs.CONFIGS))
def test_batch_rule(name):
    """train.batch_size is one card's: the JAX config's global batch over
    ``configs.cards(name)`` cards (4 for the reference's experiments and
    their stand-ins, 1 for the toys and CPU configs)."""
    batch = configs.get_config(name)["train"]["batch_size"]
    n_cards = configs.cards(name)
    assert n_cards == (1 if name.startswith("synthetic")
                       else configs.REFERENCE_CARDS)
    jax_name = STAND_INS.get(name, name)
    if jax_name in JAX_MODULES:
        assert batch * n_cards == _jax(jax_name).train.batch_size
    else:  # a CPU config with no JAX module (synthetic_unet)
        assert n_cards == 1 and batch == configs.per_card(batch, 1)


def test_batch_rule_values():
    """The values the rule gives the configs the chip runs: U-ViT-large's
    128 (512 over 4), U-ViT-T2I-large's 64 (256) and U-ViT-small-deep16
    T2I's 256 (1024)."""
    got = {n: configs.get_config(n)["train"]["batch_size"]
           for n in ("uvit_large", "lfm_cm256_uvit_large", "uvit_t2i_large",
                     "uvit_t2i_small_deep16", "synthetic_attr_e2e")}
    assert got == {"uvit_large": 128, "lfm_cm256_uvit_large": 128,
                   "uvit_t2i_large": 64, "uvit_t2i_small_deep16": 256,
                   "synthetic_attr_e2e": 256}
    with pytest.raises(ValueError):
        configs.per_card(96, 5)


@pytest.mark.parametrize("name", sorted(configs.CONFIGS))
def test_every_config_names_a_registered_dataset(name):
    ds = configs.get_config(name)["dataset"]["name"]
    assert ds in tds._REGISTRY or ds == tds.CAPTION_ALIAS


def test_registry_has_every_jax_name():
    assert set(tds._REGISTRY) == set(jds._REGISTRY)
    for name, factory in jds._REGISTRY.items():
        assert tds._REGISTRY[name].__name__ == factory.__name__
    with pytest.raises(NotImplementedError):
        tds.get_dataset("no_such_dataset")


SOLVES = [dict(solver="fixed", solver_fix="euler", solver_fix_step=0.01),
          dict(solver="adaptive", solver_adaptive="dopri5"),
          dict(solver="fixadp", solver_fix="heun", solver_fix_step=0.05,
               solver_adaptive="dopri5")]


@pytest.mark.parametrize("sk", SOLVES)
def test_solver_desc_matches_jax(sk):
    assert configs.solver_desc(sk) == jprov.solver_desc(sk)


@pytest.mark.parametrize("path", ["", "ckpts/130000", "x/130000.ckpt/nnet.pth",
                                  "a/b/c.pth", "/w/ckpts/20/"])
def test_epoch_id_matches_jax(path):
    assert configs.epoch_id_from_path(path) == jprov.epoch_id_from_path(path)


@pytest.mark.parametrize("name,ith_attr", [
    ("lfm_cm256_uvit_large", 31), ("lfm_mscoco_uvit_from_in256", 7),
    ("synthetic_attr_e2e", 2)])
def test_update_config_matches_jax(name, ith_attr):
    """The provenance paths of both packages' configs, set and unset."""
    port, ref = configs.get_config(name), _jax(name)
    for cfg in (port["dissection"], ref.dissection):
        cfg["ith_attr"] = ith_attr
        cfg["ckpt_path_to_dissect"] = "runs/ckpts/25000"
        cfg["vis_path"] = ""
        cfg["read_path_root"] = ""
        cfg["edit_loc"] = "mid"  # a toy's choice (TOY_CHOICES)
    configs.update_config(port)
    jprov.update_config(ref)
    for k in ("vis_path", "read_path_root"):
        assert port["dissection"][k] == ref.dissection[k]
    assert "ep25000" in port["dissection"]["vis_path"]
    port["dissection"]["vis_path"] = "kept"
    assert configs.update_config(port)["dissection"]["vis_path"] == "kept"
