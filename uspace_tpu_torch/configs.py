"""Model, training, sampling and dissection configurations as plain dicts.

Counterpart of the ``nnet``, ``train``, ``optimizer``, ``lr_scheduler``,
``dynamic``, ``sample``, ``dataset`` and ``dissection`` blocks of
``uspace_tpu/configs`` (ml_collections
there; plain dicts here, so the port needs neither ml_collections nor
absl).
"""

from __future__ import annotations

import copy
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
# uspace_tpu/codecs/vae.py SD_CONFIG), scale factor 0.18215
_AUTOENCODER = dict(ddconfig=None, embed_dim=4, scale_factor=0.18215)
# the SD layout at 32 channels and one res block, for the CPU configs
_TINY_AUTOENCODER = dict(_AUTOENCODER, ddconfig=dict(
    ch=32, out_ch=3, ch_mult=(1, 2, 2, 2), num_res_blocks=1,
    attn_resolutions=(), in_channels=3, resolution=256, z_channels=4,
    double_z=True))

# configs/common.py:35-51 (base_config): train, optimizer, lr_scheduler,
# dynamic. batch_size is the per-card batch here.
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

# configs/common.py:80-121 (base_config's dissection block), the keys the
# dissect and editing_e2e CLIs read, with the Euler solve of
# configs/synthetic_attr_e2e.py (solver_fix_step 0.02: 50 read and write
# steps) and the mid tap
_WRITE_SCALES = (-500, -400, -300, -200, -100, -50, -10, 0,
                 10, 50, 100, 200, 300, 400, 500)
_DISSECTION = dict(has_attr=False, dissect_task="uspace_uvit",
                   dissect_name=None, n_samples=100, mini_batch_size=100,
                   ckpt_path_to_dissect="", fixed_z_path="",
                   read_path_root="dissect/read", write_scales=_WRITE_SCALES,
                   ith_component=1, pca_n=50, ith_attr=0, class_label=0,
                   t_edit=1.0, e2e_min_effect=1.0, edit_loc="mid",
                   solver_kwargs=dict(solver="fixed", solver_fix="euler",
                                      solver_fix_step=0.02))


# configs/common.py:108-117, the prompt-to-prompt and local-prompt keys of
# the T2I dissection (target_block_id -1: every block)
_TOKEN_KWARGS = dict(token_dissect=None, lp_replace_from="", lp_replace_to="",
                     lp_to_add="", lp_to_remove="", p2p_to_multiply="",
                     p2p_multiplier=1.9, target_block_id=-1)


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


CONFIGS: Dict[str, Dict[str, Any]] = {
    # CelebAMask-HQ 256 U-ViT-large (configs/lfm_cm256_uvit_large.py):
    # 4x32x32 latents, embed 1024, depth 20, 16 heads, patch 2, L = 257
    # training (configs/lfm_cm256_uvit_large.py:8-12): 300k steps at a
    # global batch of 512, i.e. 128 per card over the reference's 4 GPUs
    "uvit_large": dict(
        z_shape=(4, 32, 32),  # CHW, reference convention
        compute_dtype="bfloat16",
        nnet=uvit_nnet(embed_dim=1024, depth=20, num_heads=16),
        autoencoder=_AUTOENCODER,
        train=dict(_TRAIN, n_steps=300_000, batch_size=128),
        optimizer=_OPTIMIZER,
        lr_scheduler=_LR_SCHEDULER,
        dynamic=_DYNAMIC,
        sample=_SAMPLE,
        dataset=_attr_dataset(32),
        dissection=_DISSECTION,
    ),
    # CelebAMask-HQ 256 SD-UNet-large (configs/lfm_cm256_unet_large.py):
    # 4x32x32 latents, 256 channels x (1, 2, 4), 2 res blocks, a
    # SpatialTransformer (head channels 32, context 768, depth 1) at every
    # level, bf16 field; uncond mode, so the context is the zeros token;
    # sampled at batch 50 and decoded to 256-pixel images by the f32 SD VAE
    "unet_large": dict(
        z_shape=(4, 32, 32),
        compute_dtype="bfloat16",
        nnet=unet_nnet(),
        autoencoder=_AUTOENCODER,
        train=dict(_TRAIN, n_steps=300_000, batch_size=128),
        optimizer=_OPTIMIZER,
        lr_scheduler=_LR_SCHEDULER,
        dynamic=_DYNAMIC,
        sample=_SAMPLE,
        dataset=_synthetic_dataset(32),
    ),
    # the same SD-UNet-large at SD 1.x's native 512 x 512: 4x64x64 latents,
    # so its top attention level runs L = 4096 tokens in 8 heads of 32 (the
    # blocked attention kernel, _flash_kernel) and ds 2 L = 1024. The JAX
    # package runs it as configs/lfm_cm256_unet_large.py with two overrides:
    #   --config.nnet.image_size=64 --config.z_shape="(4, 64, 64)"
    # decoded by the f32 SD VAE to 512-pixel images
    "unet_large_512": dict(
        z_shape=(4, 64, 64),
        compute_dtype="bfloat16",
        nnet=unet_nnet(image_size=64),
        autoencoder=_AUTOENCODER,
        train=dict(_TRAIN, n_steps=300_000, batch_size=128),
        optimizer=_OPTIMIZER,
        lr_scheduler=_LR_SCHEDULER,
        dynamic=_DYNAMIC,
        sample=_SAMPLE,
        dataset=_attr_dataset(64),
        dissection=_DISSECTION,
    ),
    # tiny CPU UNet config (tests/test_unet.py TINY): 4x16x16 latents, 32
    # channels x (1, 2), attention at ds 2, f32; a VAE of the SD layout at
    # 32 channels (--decode: 128-pixel images)
    "synthetic_unet": dict(
        z_shape=(4, 16, 16),
        compute_dtype="float32",
        nnet=unet_nnet(model_channels=32, image_size=16, num_res_blocks=1,
                       attention_resolutions=(2,), channel_mult=(1, 2),
                       num_head_channels=16, context_dim=24),
        autoencoder=_TINY_AUTOENCODER,
        train=dict(_TRAIN, n_steps=10, batch_size=8),
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
        z_shape=(4, 8, 8),
        vis_num=4,
        compute_dtype="float32",
        nnet=uvit_nnet(embed_dim=32, depth=2, num_heads=4, img_size=8,
                       use_checkpoint=False),
        autoencoder=_TINY_AUTOENCODER,
        train=dict(_TRAIN, n_steps=10, batch_size=8, log_interval=5,
                   eval_interval=10, save_interval=5),
        optimizer=_OPTIMIZER,
        lr_scheduler=_LR_SCHEDULER,
        dynamic=_DYNAMIC,
        sample=dict(_SAMPLE, sample_steps=4, n_samples=4, mini_batch_size=4),
        dataset=_attr_dataset(8, num=64),
        dissection=dict(_DISSECTION, n_samples=8, mini_batch_size=4,
                        pca_n=4, write_scales=(-100, 0, 100),
                        solver_kwargs=dict(_DISSECTION["solver_kwargs"],
                                           solver_fix_step=0.25)),
    ),
}


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
        train=dict(_TRAIN, n_steps=3000, batch_size=256, log_interval=100,
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
        clip=dict(pretrained_path="", max_length=77),
        train=dict(_TRAIN, mode=mode, n_steps=n_steps, batch_size=256,
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


def _t2i_large(nnet: Dict[str, Any], batch: int) -> Dict[str, Any]:
    """configs/lfm_mscoco_uvit_from_in256.py: MS-COCO 256 T2I, 4x32x32
    latents, 77 CLIP tokens of 768 (L = 334), 300k steps at a batch of
    ``batch`` (the JAX config's global batch), no weight decay, seed 1230.
    The MS-COCO features and the ImageNet-256 weights it starts from are not
    in the repository: it trains from the reference init on
    ``synthetic_t2i`` moments and contexts of the same shapes. As in the
    JAX config, ``cfg`` is off (no context dropout; p_uncond 0.1 is
    carried but unused)."""
    return dict(
        seed=1230,
        z_shape=(4, 32, 32),
        compute_dtype="bfloat16",
        nnet=nnet,
        autoencoder=_AUTOENCODER,
        clip=dict(pretrained_path="", max_length=77),
        train=dict(_TRAIN, mode="t2i", n_steps=300_000, batch_size=batch,
                   log_interval=10, eval_interval=500, save_interval=5000),
        optimizer=dict(_OPTIMIZER, weight_decay=0.0),
        lr_scheduler=_LR_SCHEDULER,
        dynamic=_DYNAMIC,
        sample=dict(_SAMPLE, n_samples=16, mini_batch_size=8),
        dataset=dict(name="synthetic_t2i", num=4096, shape=(32, 32, 8),
                     num_tokens=77, ctx_dim=768, cfg=False, p_uncond=0.1),
        dissection=dict(_DISSECTION, ith_attr=7, pca_n=100,
                        token_kwargs=dict(_TOKEN_KWARGS)),
    )


# U-ViT-T2I-large (embed 1024, depth 20, 16 heads of 64, patch 2)
CONFIGS["uvit_t2i_large"] = _t2i_large(uvit_t2i_nnet(), 256)
# U-ViT-small-deep16 T2I (configs/lfm_mscoco_uvit_small_deep16_v2.py:
# embed 512, depth 16, 8 heads of 64, batch 1024)
CONFIGS["uvit_t2i_small_deep16"] = _t2i_large(
    uvit_t2i_nnet(embed_dim=512, depth=16, num_heads=8), 1024)


# configs/common.py:20-77 (base_config), the keys the training loop reads
# beside the blocks above, with the JAX package's defaults: the vis grid's
# size, a reference checkpoint to start from and its surgery
# (train/checkpoint.load_pretrained_nnet), the reference VAE's file (the
# loop decodes through it where it exists), the loader's threads and the
# data-parallel layout (dp -1: every process; fsdp and tp are not ported
# and must stay 1). Keys the JAX loop reads with .get stay optional here
# too: train.skip_nonfinite (True), tracker (none), sample.fid_decode
# ("vae"), sample.fid_weights (pytorch-fid's file) and dataset.fid_stat
# (none: no FID).
_COMMON = dict(vis_num=16, pretrained_path=None, pretrained_surgery=None,
               dl=dict(num_workers=8), parallel=dict(dp=-1, fsdp=1, tp=1))
_COMMON_BLOCKS = dict(
    autoencoder=dict(
        pretrained_path="assets/stable-diffusion/autoencoder_kl.pth"),
    train=dict(profile_dir=None))


def with_defaults(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """``cfg`` with the base config's keys it does not set."""
    for k, v in _COMMON.items():
        cfg.setdefault(k, copy.deepcopy(v))
    for blk, keys in _COMMON_BLOCKS.items():
        if blk in cfg:
            for k, v in keys.items():
                cfg[blk].setdefault(k, v)
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
