"""Model, training and sampling configurations as plain dicts.

Counterpart of the ``nnet``, ``train``, ``optimizer``, ``lr_scheduler``,
``dynamic`` and ``sample`` blocks of ``uspace_tpu/configs`` (ml_collections
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
               solver_kwargs=dict(solver="fixed", solver_fix="euler",
                                  solver_fix_step=-1.0,
                                  solver_adaptive="dopri5", rtol=1e-5,
                                  atol=1e-5, controller="pi"))

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
    ),
    # tiny CPU smoke config (configs/synthetic_smoke.py): 4x8x8 latents,
    # embed 32, depth 2, f32
    "synthetic_smoke": dict(
        z_shape=(4, 8, 8),
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
    ),
}


def get_config(name) -> Dict[str, Any]:
    """A copy of the config registered as ``name``, or of ``name`` itself
    when it is a config (a dict)."""
    if isinstance(name, dict):
        return copy.deepcopy(name)
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    return copy.deepcopy(CONFIGS[name])


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
