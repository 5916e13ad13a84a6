"""Model, training, sampling and dissection configurations as plain dicts.

Counterpart of ``uspace_tpu/configs`` (ml_collections there; plain dicts
here, so the port needs neither ml_collections nor absl). Every JAX config
module is registered here under its module name, built the same way from
:func:`base_config` (``configs/common.py``): the reference's experiments
(``lfm_cm256_*``, ``lfm_mmcelebahq256_*``, ``lfm_mscoco_*``, ``ffmm_pixel``)
with their real datasets and pretrained paths, and the toys. The names the
port's chip runs and benchmarks use (``uvit_large``, ``unet_large``,
``unet_large_512``, ``uvit_t2i_large``, ``uvit_t2i_small_deep16``) derive
from a JAX-named config with its dataset replaced by a synthetic stand-in
(:func:`_stand_in`). The path helpers of ``configs/provenance.py`` close the
module.

One batch rule holds for every config: ``train.batch_size`` is the batch of
one process (one card; the training loop's global batch is it times the
processes), the JAX config's global batch over the cards its experiment ran
on (:func:`per_card`): ``REFERENCE_CARDS`` for the reference's experiments
and the stand-ins derived from them, 1 for the toys and CPU configs
(``synthetic_*``), which the JAX package trains on one device
(:func:`cards`).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict


def uvit_nnet(embed_dim: int = 512, depth: int = 16, num_heads: int = 8,
              **kw) -> Dict[str, Any]:
    cfg = dict(name="uvit", img_size=32, patch_size=2, in_chans=4,
               embed_dim=embed_dim, depth=depth, num_heads=num_heads,
               mlp_ratio=4.0, qkv_bias=False, mlp_time_embed=False,
               num_classes=-1, use_checkpoint=True, remat_exempt=0,
               quant=False)
    cfg.update(kw)
    return cfg


def uvit_t2i_nnet(embed_dim: int = 1024, depth: int = 20, num_heads: int = 16,
                  **kw) -> Dict[str, Any]:
    """configs/common.py's ``uvit_t2i_nnet``: 77 CLIP tokens of 768."""
    cfg = dict(name="uvit_t2i", img_size=32, patch_size=2, in_chans=4,
               embed_dim=embed_dim, depth=depth, num_heads=num_heads,
               mlp_ratio=4.0, qkv_bias=False, mlp_time_embed=False,
               clip_dim=768, num_clip_token=77, use_checkpoint=True,
               remat_exempt=0, quant=False)
    cfg.update(kw)
    return cfg


def unet_nnet(model_channels: int = 256, **kw) -> Dict[str, Any]:
    """The SD-UNet block of configs/lfm_cm256_unet_large.py:45-58."""
    cfg = dict(name="unet_t2i", image_size=32, in_channels=4, out_channels=4,
               model_channels=model_channels, attention_resolutions=(4, 2, 1),
               num_res_blocks=2, channel_mult=(1, 2, 4), num_head_channels=32,
               use_spatial_transformer=True, transformer_depth=1,
               context_dim=768)
    cfg.update(kw)
    return cfg


# the SD VAE of every 256-pixel config (configs/common.py autoencoder block;
# uspace_tpu/codecs/vae.py SD_CONFIG), scale factor 0.18215; ddconfig and
# embed_dim are the port's (the module's layout; None: the SD layout)
_AUTOENCODER = dict(ddconfig=None, embed_dim=4, scale_factor=0.18215)
# the SD layout at 32 channels and one res block, for the CPU configs
_TINY_AUTOENCODER = dict(_AUTOENCODER, ddconfig=dict(
    ch=32, out_ch=3, ch_mult=(1, 2, 2, 2), num_res_blocks=1,
    attn_resolutions=(), in_channels=3, resolution=256, z_channels=4,
    double_z=True))

# configs/common.py:35-51 (base_config): train, optimizer, lr_scheduler,
# dynamic. Every config sets its batch_size by the rule above.
_TRAIN = dict(n_steps=500_000, batch_size=256, mode="uncond", log_interval=100,
              eval_interval=5000, save_interval=10_000, ema_rate=0.9999,
              grad_clip=-1.0, from_moments=True)
_OPTIMIZER = dict(name="adam", lr=1e-4, weight_decay=0.03, betas=(0.9, 0.999))
_LR_SCHEDULER = dict(name="customized", warmup_steps=0)
_DYNAMIC = dict(sigma_min=1e-4)

# configs/common.py:53-74: fixed Euler by default; solver="adaptive" runs
# the reference's eval decode (dopri5 at rtol = atol = 1e-5) with the keys
# below. solver_fix_step <= 0 derives the step from sample_steps.
_SAMPLE = dict(sample_steps=50, n_samples=50_000, mini_batch_size=50,
               cfg_scale=0.0,  # > 0: classifier-free guidance
               solver_kwargs=dict(solver="fixed", solver_fix="euler",
                                  solver_fix_step=-1.0,
                                  solver_adaptive="dopri5", rtol=1e-5,
                                  atol=1e-5, controller="pi"))

# configs/common.py:80-121 (base_config's dissection block)
_WRITE_SCALES = (-500, -400, -300, -200, -100, -50, -10, 0,
                 10, 50, 100, 200, 300, 400, 500)
# configs/common.py:108-117, the prompt-to-prompt and local-prompt keys of
# the T2I dissection (target_block_id -1: every block)
_TOKEN_KWARGS = dict(token_dissect=None, lp_replace_from="", lp_replace_to="",
                     lp_to_add="", lp_to_remove="", p2p_to_multiply="",
                     p2p_multiplier=1.9, target_block_id=-1)
_BASE_DISSECTION = dict(
    has_attr=False, dissect_task="uspace_uvit", dissect_name=None,
    n_samples=100, mini_batch_size=100, ckpt_path_to_dissect="",
    fixed_z_path="", read_path_root="dissect/read", write_path_root="",
    vis_path="", write_scales=_WRITE_SCALES, ith_component=1, pca_n=50,
    ith_attr=0, class_label=0, t_edit=1.0, e2e_min_effect=1.0,
    edit_loc=None, solver_kwargs=dict(solver="fixed", solver_fix="euler",
                                      solver_fix_step=0.01,
                                      solver_adaptive="dopri5",
                                      solver_adaptive_prec=0.01),
    token_kwargs=_TOKEN_KWARGS)
# the port's editing harness (the dissect and editing_e2e CLIs on the chip
# configs and the CPU configs): the mid tap and the Euler solve of
# configs/synthetic_attr_e2e.py (solver_fix_step 0.02: 50 read and write
# steps)
_DISSECTION = dict(_BASE_DISSECTION, edit_loc="mid",
                   solver_kwargs=dict(solver="fixed", solver_fix="euler",
                                      solver_fix_step=0.02))


def base_config() -> Dict[str, Any]:
    """configs/common.py's ``base_config`` as plain dicts: every block and
    key with the JAX package's defaults (``None`` for its string
    placeholders), the autoencoder block with the port's module keys."""
    return copy.deepcopy(dict(
        seed=1234, z_shape=(4, 32, 32),  # CHW, reference convention
        vis_num=16, workdir="workdir", pretrained_path=None,
        pretrained_surgery=None,
        autoencoder=dict(_AUTOENCODER, pretrained_path="assets/"
                         "stable-diffusion/autoencoder_kl.pth"),
        clip=dict(pretrained_path="", max_length=77),
        train=dict(_TRAIN, profile_dir=None), optimizer=_OPTIMIZER,
        lr_scheduler=_LR_SCHEDULER, dynamic=_DYNAMIC,
        dl=dict(num_workers=8), sample=dict(_SAMPLE, path=""),
        parallel=dict(dp=-1, fsdp=1, tp=1),  # dp -1: every process
        compute_dtype="bfloat16", dissection=_BASE_DISSECTION))


REFERENCE_CARDS = 4  # the reference's 256-px experiments ran on 4 GPUs


def cards(name: str) -> int:
    """The cards the experiment of config ``name`` is laid out for (the
    batch rule): 1 for the toys and CPU configs, else REFERENCE_CARDS."""
    return 1 if name.startswith("synthetic") else REFERENCE_CARDS


def per_card(global_batch: int, n_cards: int = REFERENCE_CARDS) -> int:
    """A JAX config's global batch as the batch of one of ``n_cards``."""
    if global_batch % n_cards:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {n_cards} cards")
    return global_batch // n_cards


def _train(cfg: Dict[str, Any], global_batch: int, **kw) -> None:
    """Set ``cfg``'s train keys, its batch by the rule."""
    cfg["train"].update(batch_size=per_card(global_batch), **kw)


def _samples(cfg: Dict[str, Any], n: int, mini_batch: int) -> None:
    """The sample block's counts, its path named after the dataset."""
    cfg["sample"].update(n_samples=n, mini_batch_size=mini_batch,
                         path="samples/" + cfg["dataset"]["name"])


# the JAX configs' datasets (the features are not in the repository)
_CM256 = dict(name="celebamask256_features_cond",
              path="assets/datasets/celebamask256_features_with_supervision",
              cfg=False, p_uncond=0.15)
_MMCELEBAHQ = dict(name="mmcelebahq256_features_withcaptioncontext",
                   path="assets/datasets/mmcelebahq256_features", cfg=False,
                   p_uncond=0.1)
_MSCOCO = dict(name="mscoco256_features",
               path="assets/datasets/coco256_features", cfg=False,
               p_uncond=0.1)
_WEIGHTS = "assets/pretrained_weights/"


def lfm_cm256_uvit_large() -> Dict[str, Any]:
    """CelebAMask-HQ 256, U-ViT-large: embed 1024, depth 20, 16 heads,
    patch 2 (L = 257), 300k steps at a global batch of 512."""
    cfg = base_config()
    _train(cfg, 512, n_steps=300_000)
    cfg["optimizer"]["weight_decay"] = 0.03
    cfg["nnet"] = uvit_nnet(embed_dim=1024, depth=20, num_heads=16)
    cfg["dataset"] = dict(_CM256)
    _samples(cfg, 50_000, 50)
    cfg["dissection"].update(has_attr=True)
    return cfg


def lfm_cm256_unet_large() -> Dict[str, Any]:
    """CelebAMask-HQ 256, SD-UNet-large (lfm_cm256_unet_large.py:43-128):
    256 channels x (1, 2, 4), a SpatialTransformer at every level."""
    cfg = base_config()
    _train(cfg, 512, n_steps=300_000)
    cfg["nnet"] = unet_nnet()
    cfg["dataset"] = dict(_CM256)
    _samples(cfg, 50_000, 50)
    cfg["dissection"].update(dissect_task="hspace_unet", has_attr=True)
    return cfg


def lfm_cm256_uvit_small_deep16_scratch() -> Dict[str, Any]:
    """CelebAMask-HQ 256, U-ViT-small-deep16 (embed 512, depth 16, 8
    heads) from scratch."""
    cfg = base_config()
    cfg["seed"] = 12340
    _train(cfg, 256, n_steps=500_000)
    cfg["nnet"] = uvit_nnet(embed_dim=512, depth=16, num_heads=8)
    cfg["dataset"] = dict(_CM256)
    _samples(cfg, 50_000, 50)
    cfg["dissection"].update(has_attr=True)
    return cfg


def lfm_cm256_uvit_small_deep16_fromcoco() -> Dict[str, Any]:
    """The same from the MS-COCO U-ViT-small-deep16's weights."""
    cfg = lfm_cm256_uvit_small_deep16_scratch()
    cfg.update(pretrained_path=_WEIGHTS + "mscoco_uvit_small_deep.pth",
               pretrained_surgery="nnet_only")
    return cfg


def lfm_mmcelebahq256_unet_large() -> Dict[str, Any]:
    """MM-CelebA-HQ 256 T2I, the SD-UNet from an SD LDM checkpoint."""
    cfg = lfm_cm256_unet_large()
    cfg["pretrained_path"] = _WEIGHTS + "sd_unet.pth"
    _train(cfg, 96, n_steps=3_000_000, mode="t2i")
    cfg["dataset"] = dict(_MMCELEBAHQ)
    _samples(cfg, 30, 8)
    return cfg


def lfm_mmcelebahq256_unet_scratch() -> Dict[str, Any]:
    cfg = lfm_mmcelebahq256_unet_large()
    cfg["pretrained_path"] = None
    _train(cfg, 256, n_steps=1_000_000)
    return cfg


def lfm_mmcelebahq256_uvit_large() -> Dict[str, Any]:
    """MM-CelebA-HQ 256 T2I, U-ViT-large (77 CLIP tokens, L = 334)."""
    cfg = base_config()
    _train(cfg, 512, n_steps=300_000, mode="t2i")
    cfg["optimizer"]["weight_decay"] = 0.0
    cfg["nnet"] = uvit_t2i_nnet(embed_dim=1024, depth=20, num_heads=16)
    cfg["dataset"] = dict(_MMCELEBAHQ)
    _samples(cfg, 30, 10)
    return cfg


def lfm_mmcelebahq256_uvit_large_scratch() -> Dict[str, Any]:
    cfg = lfm_mmcelebahq256_uvit_large()
    cfg["pretrained_path"] = None
    _train(cfg, 256, n_steps=1_000_000)
    return cfg


def lfm_mmcelebahq256_uvit_small_deep16() -> Dict[str, Any]:
    """MM-CelebA-HQ 256 T2I, U-ViT-small-deep16 from MS-COCO weights."""
    cfg = base_config()
    cfg.update(pretrained_path=_WEIGHTS + "mscoco_uvit_small_deep.pth",
               pretrained_surgery="mscoco_or_in256")
    _train(cfg, 256, n_steps=1_000_000, mode="t2i")
    cfg["optimizer"]["weight_decay"] = 0.0
    cfg["nnet"] = uvit_t2i_nnet(embed_dim=512, depth=16, num_heads=8)
    cfg["dataset"] = dict(_MMCELEBAHQ)
    _samples(cfg, 30, 8)
    return cfg


def lfm_mmcelebahq256_uvit_small_deep16_scratch() -> Dict[str, Any]:
    cfg = lfm_mmcelebahq256_uvit_small_deep16()
    cfg.update(pretrained_path=None, pretrained_surgery=None)
    return cfg


def lfm_mscoco_unet_from_in256() -> Dict[str, Any]:
    """MS-COCO T2I, the SD-UNet from an SD LDM checkpoint with its
    cross-attention drawn anew (surgery ``unet_remove_attention``)."""
    cfg = lfm_cm256_unet_large()
    cfg.update(pretrained_path=_WEIGHTS + "sd_unet.pth",
               pretrained_surgery="unet_remove_attention")
    _train(cfg, 1024, n_steps=300_000, mode="t2i")
    cfg["dataset"] = dict(_MSCOCO)
    _samples(cfg, 16, 8)
    return cfg


def lfm_mscoco_uvit_from_in256() -> Dict[str, Any]:
    """MS-COCO T2I, U-ViT-large from ImageNet-256 weights (seed 1230)."""
    cfg = base_config()
    cfg.update(seed=1230,
               pretrained_path=_WEIGHTS + "imagenet256_uvit_large.pth",
               pretrained_surgery="mscoco_or_in256")
    _train(cfg, 256, n_steps=300_000, mode="t2i", log_interval=10,
           eval_interval=500, save_interval=5000)
    cfg["optimizer"]["weight_decay"] = 0.0
    cfg["nnet"] = uvit_t2i_nnet(embed_dim=1024, depth=20, num_heads=16)
    cfg["dataset"] = dict(_MSCOCO)
    _samples(cfg, 16, 8)
    cfg["dissection"].update(dissect_task="uspace_uvit", ith_attr=7,
                             pca_n=100)
    return cfg


def lfm_mscoco_uvit_small_deep16_v2() -> Dict[str, Any]:
    """MS-COCO T2I, U-ViT-small-deep16 (embed 512, depth 16, 8 heads)."""
    cfg = lfm_mscoco_uvit_from_in256()
    cfg.update(pretrained_path=_WEIGHTS + "mscoco_uvit_small_deep.pth",
               pretrained_surgery="mscoco_or_in256")
    _train(cfg, 1024)
    cfg["nnet"] = uvit_t2i_nnet(embed_dim=512, depth=16, num_heads=8)
    return cfg


def ffmm_pixel() -> Dict[str, Any]:
    """Pixel-space flow matching without a VAE (reference train_ffmm.py):
    3 x 32 x 32 images, global-norm clipping at 1.0 (:144-146)."""
    cfg = base_config()
    cfg["z_shape"] = (3, 32, 32)
    _train(cfg, 128, n_steps=500_000, from_moments=False, grad_clip=1.0)
    cfg["nnet"] = uvit_nnet(embed_dim=512, depth=12, num_heads=8,
                            img_size=32, in_chans=3)
    cfg["dataset"] = dict(name="synthetic", num=1024, shape=(32, 32, 3))
    cfg["sample"].update(n_samples=10_000, mini_batch_size=100)
    return cfg


_JAX_NAMED = (lfm_cm256_uvit_large, lfm_cm256_unet_large,
              lfm_cm256_uvit_small_deep16_scratch,
              lfm_cm256_uvit_small_deep16_fromcoco,
              lfm_mmcelebahq256_unet_large, lfm_mmcelebahq256_unet_scratch,
              lfm_mmcelebahq256_uvit_large,
              lfm_mmcelebahq256_uvit_large_scratch,
              lfm_mmcelebahq256_uvit_small_deep16,
              lfm_mmcelebahq256_uvit_small_deep16_scratch,
              lfm_mscoco_unet_from_in256, lfm_mscoco_uvit_from_in256,
              lfm_mscoco_uvit_small_deep16_v2, ffmm_pixel)


def _synthetic_dataset(latent_hw: int, num: int = 256) -> Dict[str, Any]:
    """The moments a config trains on where its own features are not in the
    repository: ``SyntheticFeatures`` at its latent shape (the JAX
    package's ``synthetic`` dataset)."""
    return dict(name="synthetic", num=num, shape=(latent_hw, latent_hw, 8))


def _attr_dataset(latent_hw: int, num: int = 4096) -> Dict[str, Any]:
    """The read's dataset: ``SyntheticAttrFeatures`` moments at a config's
    latent shape (configs/synthetic_attr_e2e.py; the CelebAMask-HQ features
    with attributes are not in the repository)."""
    return dict(name="synthetic_attr", num=num,
                shape=(latent_hw, latent_hw, 8), num_attrs=4)


# the T2I stand-in: synthetic_t2i moments and contexts at MS-COCO's shapes
# (77 CLIP tokens of 768); cfg off and p_uncond carried, as in the JAX config
_T2I_DATA = dict(name="synthetic_t2i", num=4096, shape=(32, 32, 8),
                 num_tokens=77, ctx_dim=768, cfg=False, p_uncond=0.1)


def _stand_in(make, dataset: Dict[str, Any], **overrides) -> Dict[str, Any]:
    """The JAX-named config ``make()`` with its dataset replaced by a
    synthetic stand-in of the same shapes, and ``overrides`` (top-level
    keys) set."""
    cfg = make()
    cfg.update(dataset=dict(dataset), **copy.deepcopy(overrides))
    return cfg


CONFIGS: Dict[str, Dict[str, Any]] = {f.__name__: f() for f in _JAX_NAMED}
CONFIGS.update({
    # U-ViT-large on SyntheticAttrFeatures moments, with the editing
    # harness's dissection
    "uvit_large": _stand_in(lfm_cm256_uvit_large, _attr_dataset(32),
                            dissection=_DISSECTION),
    # SD-UNet-large (bf16 field; uncond mode, so its context is the zeros
    # token), sampled at batch 50 and decoded to 256-pixel images by the f32
    # SD VAE
    "unet_large": _stand_in(lfm_cm256_unet_large, _synthetic_dataset(32)),
    # the same SD-UNet-large at SD 1.x's native 512 x 512: 4x64x64 latents,
    # so its top attention level runs L = 4096 tokens in 8 heads of 32 (the
    # blocked attention kernel, _flash_kernel) and ds 2 L = 1024. The JAX
    # package runs it as configs/lfm_cm256_unet_large.py with two overrides:
    #   --config.nnet.image_size=64 --config.z_shape="(4, 64, 64)"
    # decoded by the f32 SD VAE to 512-pixel images
    "unet_large_512": _stand_in(
        lfm_cm256_unet_large, _attr_dataset(64), z_shape=(4, 64, 64),
        nnet=unet_nnet(image_size=64), dissection=_DISSECTION),
    # U-ViT-T2I-large (configs/lfm_mscoco_uvit_from_in256.py: embed 1024,
    # depth 20, 16 heads of 64, L = 334) and U-ViT-small-deep16 T2I
    # (lfm_mscoco_uvit_small_deep16_v2.py: embed 512, depth 16, 8 heads of
    # 64) on synthetic_t2i; the weights they start from are not in the
    # repository, so the loop draws the reference init
    "uvit_t2i_large": _stand_in(lfm_mscoco_uvit_from_in256, _T2I_DATA),
    "uvit_t2i_small_deep16": _stand_in(lfm_mscoco_uvit_small_deep16_v2,
                                       _T2I_DATA),
    # tiny CPU UNet config (tests/test_unet.py TINY): 4x16x16 latents, 32
    # channels x (1, 2), attention at ds 2, f32; a VAE of the SD layout at
    # 32 channels (--decode: 128-pixel images)
    "synthetic_unet": dict(
        seed=0,
        z_shape=(4, 16, 16),
        compute_dtype="float32",
        nnet=unet_nnet(model_channels=32, image_size=16, num_res_blocks=1,
                       attention_resolutions=(2,), channel_mult=(1, 2),
                       num_head_channels=16, context_dim=24),
        autoencoder=_TINY_AUTOENCODER,
        train=dict(_TRAIN, n_steps=10, batch_size=per_card(8, 1)),
        optimizer=_OPTIMIZER,
        lr_scheduler=_LR_SCHEDULER,
        dynamic=_DYNAMIC,
        sample=dict(_SAMPLE, sample_steps=4, n_samples=4, mini_batch_size=4),
        dataset=_attr_dataset(16, num=64),
        dissection=dict(_DISSECTION, n_samples=8, mini_batch_size=4,
                        pca_n=4, write_scales=(-100, 0, 100),
                        solver_kwargs=dict(_DISSECTION["solver_kwargs"],
                                           solver_fix_step=0.25)),
    ),
    # tiny CPU smoke config (configs/synthetic_smoke.py): 4x8x8 latents,
    # embed 32, depth 2, f32, a vis grid of 4
    "synthetic_smoke": dict(
        seed=0,
        z_shape=(4, 8, 8),
        vis_num=4,
        compute_dtype="float32",
        nnet=uvit_nnet(embed_dim=32, depth=2, num_heads=4, img_size=8,
                       use_checkpoint=False),
        autoencoder=_TINY_AUTOENCODER,
        train=dict(_TRAIN, n_steps=10, batch_size=per_card(8, 1),
                   log_interval=5, eval_interval=10, save_interval=5),
        optimizer=_OPTIMIZER,
        lr_scheduler=_LR_SCHEDULER,
        dynamic=_DYNAMIC,
        sample=dict(_SAMPLE, sample_steps=4, n_samples=4, mini_batch_size=4),
        dataset=_attr_dataset(8, num=64),
        dl=dict(num_workers=2),
        dissection=dict(_DISSECTION, n_samples=8, mini_batch_size=4,
                        pca_n=4, write_scales=(-100, 0, 100),
                        solver_kwargs=dict(_DISSECTION["solver_kwargs"],
                                           solver_fix_step=0.25)),
    ),
})


def _toy_e2e(nnet: Dict[str, Any], write_scales, **dissection
             ) -> Dict[str, Any]:
    """The editing proofs' toys (configs/synthetic_attr_e2e.py:14-45):
    4x8x8 attribute-structured latents, 3000 steps at batch 256 with lr
    2e-4, no weight decay and EMA 0.999 (0.9999 would still be mostly the
    random init at 3000 steps), the read and write on 256 samples with
    Euler steps of 0.02."""
    return dict(
        seed=0,
        z_shape=(4, 8, 8),
        compute_dtype="bfloat16",
        nnet=nnet,
        autoencoder=_AUTOENCODER,
        train=dict(_TRAIN, n_steps=3000, batch_size=per_card(256, 1),
                   log_interval=100,
                   eval_interval=1500, save_interval=1500, ema_rate=0.999),
        optimizer=dict(_OPTIMIZER, lr=2e-4, weight_decay=0.0),
        lr_scheduler=_LR_SCHEDULER,
        dynamic=_DYNAMIC,
        sample=dict(_SAMPLE, sample_steps=50, n_samples=16,
                    mini_batch_size=64),
        dataset=_attr_dataset(8),
        # one loader worker: the samples are drawn in Python, where more
        # threads only contend for the interpreter lock (the toys train
        # about 1.2x faster than with eight, docs/editing_e2e_torch.md)
        dl=dict(num_workers=1),
        # the adaptive keys of configs/common.py's dissection solve, which the
        # UNet toy's adaptive check starts from
        dissection=dict(_DISSECTION, has_attr=True, n_samples=256,
                        mini_batch_size=64, write_scales=write_scales,
                        solver_kwargs=dict(_DISSECTION["solver_kwargs"],
                                           solver_adaptive="dopri5",
                                           solver_adaptive_prec=0.01),
                        **dissection),
    )


# the U-ViT toy (configs/synthetic_attr_e2e.py): embed 128, depth 6, 4
# heads of 32, L = 17
CONFIGS["synthetic_attr_e2e"] = _toy_e2e(
    uvit_nnet(embed_dim=128, depth=6, num_heads=4, img_size=8,
              use_checkpoint=False),
    (-300, -200, -100, 0, 100, 200, 300))
# the SD-UNet toy (configs/synthetic_attr_unet_e2e.py:21-67): 32 channels x
# (1, 2), one res block, self-attention at ds 2 in heads of 16 channels, no
# spatial transformer; its mid tap saturates past |100|, so the sweep stays
# inside +-120; the adaptive and fixadp check after the sweeps
CONFIGS["synthetic_attr_unet_e2e"] = _toy_e2e(
    dict(name="unet_t2i", image_size=8, in_channels=4, out_channels=4,
         model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
         channel_mult=(1, 2), num_head_channels=16,
         use_spatial_transformer=False),
    (-120, -80, -40, 0, 40, 80, 120), dissect_task="hspace_unet",
    adaptive_check=True)
# the pixel-space toy (configs/synthetic_attr_pixel_e2e.py): the U-ViT toy
# on raw latents (no moments to sample from) with global-norm clipping at
# 1.0 (the reference's train_ffmm.py:144-146)
CONFIGS["synthetic_attr_pixel_e2e"] = copy.deepcopy(
    CONFIGS["synthetic_attr_e2e"])
CONFIGS["synthetic_attr_pixel_e2e"]["train"].update(from_moments=False,
                                                    grad_clip=1.0)
CONFIGS["synthetic_attr_pixel_e2e"]["dataset"]["raw"] = True


def _toy_cond(nnet: Dict[str, Any], dataset: Dict[str, Any], mode: str,
              n_steps: int, **sample) -> Dict[str, Any]:
    """The conditional proofs' toys (configs/synthetic_cond_e2e.py,
    synthetic_t2i_e2e.py, synthetic_t2i_unet_e2e.py): 4x4x4 latents, batch
    256 with lr 3e-4, no weight decay and EMA 0.999, CFG dropout 0.15, the
    harness on 128 samples in batches of 64 with Euler steps of 0.02."""
    return dict(
        seed=0,
        z_shape=(4, 4, 4),
        compute_dtype="bfloat16",
        nnet=nnet,
        autoencoder=_AUTOENCODER,
        train=dict(_TRAIN, mode=mode, n_steps=n_steps,
                   batch_size=per_card(256, 1),
                   log_interval=100, eval_interval=n_steps // 2,
                   save_interval=n_steps // 2, ema_rate=0.999),
        optimizer=dict(_OPTIMIZER, lr=3e-4, weight_decay=0.0),
        lr_scheduler=_LR_SCHEDULER,
        dynamic=_DYNAMIC,
        sample=dict(_SAMPLE, sample_steps=50, n_samples=16,
                    mini_batch_size=64, **sample),
        dataset=dataset,
        # one loader worker, as the attribute toys (the draws are Python)
        dl=dict(num_workers=1),
        dissection=dict(_DISSECTION, n_samples=128, mini_batch_size=64,
                        token_kwargs=dict(_TOKEN_KWARGS),
                        solver_kwargs=dict(_DISSECTION["solver_kwargs"],
                                           solver_adaptive="dopri5",
                                           solver_adaptive_prec=0.01)),
    )


# the caption-structured data of the T2I toys (configs/synthetic_t2i_e2e.py:
# 6 words, 8 context tokens of 32, amp 5) with CFG dropout
_T2I_TOY_DATA = dict(name="synthetic_t2i", num=4096, shape=(4, 4, 8),
                     vocab=6, num_tokens=8, ctx_dim=32, amp=5.0, cfg=True,
                     p_uncond=0.15)
# the class-conditional toy (configs/synthetic_cond_e2e.py): a U-ViT with a
# label token over 6 classes and the learned null class 6, L = 6
CONFIGS["synthetic_cond_e2e"] = _toy_cond(
    uvit_nnet(embed_dim=128, depth=6, num_heads=4, img_size=4,
              num_classes=7, use_checkpoint=False),
    dict(name="synthetic_class", num=4096, shape=(4, 4, 8), num_classes=6,
         amp=5.0, cfg=True, p_uncond=0.15),
    "cond", 8000, cfg_scale=1.0)
# the U-ViT-T2I toy (configs/synthetic_t2i_e2e.py): embed 128, depth 6, 4
# heads of 32, 8 context tokens of 32, L = 1 + 8 + 4 = 13
CONFIGS["synthetic_t2i_e2e"] = _toy_cond(
    uvit_t2i_nnet(embed_dim=128, depth=6, num_heads=4, img_size=4,
                  clip_dim=32, num_clip_token=8, use_checkpoint=False),
    dict(_T2I_TOY_DATA), "t2i", 16_000)
CONFIGS["synthetic_t2i_e2e"]["dissection"]["token_kwargs"][
    "p2p_multiplier"] = 0.0
# the SD-UNet T2I toy (configs/synthetic_t2i_unet_e2e.py): 64 channels x
# (1, 2), cross-attention to the 32-wide context at ds 1 and 2
CONFIGS["synthetic_t2i_unet_e2e"] = _toy_cond(
    unet_nnet(model_channels=64, image_size=4, attention_resolutions=(1, 2),
              num_res_blocks=1, channel_mult=(1, 2), num_head_channels=32,
              context_dim=32, use_checkpoint=False),
    dict(_T2I_TOY_DATA), "t2i", 8000)


def with_defaults(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """``cfg`` with the keys of :func:`base_config` it does not set: a
    missing block whole, a missing key of a block it has (one level down).
    Keys the JAX loop reads with ``.get`` stay optional here too:
    train.skip_nonfinite (True), tracker (none), sample.fid_decode
    ("vae"), sample.fid_weights (pytorch-fid's file) and dataset.fid_stat
    (the dataset's own)."""
    for k, v in base_config().items():
        if k not in cfg:
            cfg[k] = v
        elif isinstance(v, dict) and isinstance(cfg[k], dict):
            for kk, vv in v.items():
                cfg[k].setdefault(kk, vv)
    return cfg


def get_config(name) -> Dict[str, Any]:
    """A copy of the config registered as ``name``, or of ``name`` itself
    when it is a config (a dict), with the base config's defaults
    (:func:`with_defaults`)."""
    if isinstance(name, dict):
        return with_defaults(copy.deepcopy(name))
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    return with_defaults(copy.deepcopy(CONFIGS[name]))


def solver_kwargs(config: Dict[str, Any], sample_steps: int = 0,
                  **overrides) -> dict:
    """The sampling solve of ``config``, every key passed through and the
    keys of ``overrides`` that are not None replaced (``solver``, ``rtol``,
    ...); a non-positive solver_fix_step becomes 1 / sample_steps for the
    fixed solve and the fixed part of "fixadp"."""
    steps = sample_steps or config["sample"]["sample_steps"]
    sk = dict(config["sample"]["solver_kwargs"])
    sk.update({k: v for k, v in overrides.items() if v is not None})
    if sk.get("solver") in ("fixed", "fixadp") and \
            sk.get("solver_fix_step", -1.0) <= 0:
        sk["solver_fix_step"] = 1.0 / steps
    return sk


# configs/provenance.py: dissection paths that encode the experiment (nnet,
# dataset, solver, checkpoint step, edit target), so that artefacts of
# different settings never collide (the reference's update_config,
# configs/config_utils.py:11-56, configs_utils_common.py:4-12)


def solver_desc(solver_kwargs) -> str:
    """A solve as a path part: ``euler_step0.01``, ``dopri5`` or
    ``euler_step0.01-dopri5`` (construct_solver_desc)."""
    sk = dict(solver_kwargs)
    kind = sk.get("solver", "adaptive")
    if kind == "fixed":
        return f"{sk['solver_fix']}_step{sk['solver_fix_step']}"
    if kind == "adaptive":
        return f"{sk['solver_adaptive']}"
    if kind == "fixadp":
        return (f"{sk['solver_fix']}_step{sk['solver_fix_step']}"
                f"-{sk['solver_adaptive']}")
    raise NotImplementedError(f"unknown solver {kind!r}")


def epoch_id_from_path(path: str) -> int:
    """The checkpoint step in ``.../130000.ckpt/nnet.pth`` or
    ``.../ckpts/130000`` (the last numeric path part; 0 without one)."""
    for part in reversed([p for p in (path or "").split("/") if p]):
        stem = part.split(".")[0]
        if stem.isdigit():
            return int(stem)
    return 0


def update_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Fill ``dissection.vis_path`` and ``read_path_root`` with provenance
    strings where they are unset; returns ``config``."""
    from .editing.directions import attr_name

    d = config["dissection"]
    num_attrs = 40 if "celeba" in config["dataset"]["name"].lower() else 11
    ep = epoch_id_from_path(d.get("ckpt_path_to_dissect") or "")
    sdesc = solver_desc(d["solver_kwargs"])
    if not d.get("vis_path"):
        d["vis_path"] = os.path.join("dissections_vis", "_".join([
            config["nnet"]["name"], config["dataset"]["name"],
            str(d.get("dissect_name")),
            attr_name(int(d["ith_attr"]), num_attrs),
            f"attr{int(d['ith_attr'])}",
            f"fixz{0 if not d.get('fixed_z_path') else 1}", f"ep{ep}",
            sdesc, f"t_edit{d['t_edit']}", str(d.get("edit_loc")),
            f"com{int(d['ith_component'])}"]))
    if not d.get("read_path_root"):
        d["read_path_root"] = "mid_feat/" + "_".join([
            config["nnet"]["name"], "realimg", config["dataset"]["name"],
            f"ep{ep}", sdesc, str(d.get("edit_loc")),
            f"n{d['n_samples']}"])
    return config
