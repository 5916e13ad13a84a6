"""Where one evaluation of the sampling field, or one train step, spends
its device time.

Builds a config's field (seeded random weights, compute dtype; the
U-ViT's or the SD-UNet's), warms it up, then traces ``--evals``
evaluations at ``--batch`` with ``torch.profiler`` and prints the device
time per kernel name, grouped into the layers that launch them, beside the
host wall time (the difference is the device's idle share). With ``--train`` it traces
``--evals`` train steps instead (f32 master weights, ``--attn_impl``
default the training rule of ``train_lfm.train_attn_impl``: pallas_packed
for the U-ViT, auto for the SD-UNet; ``--remat_exempt`` U-ViT blocks
exempt from remat, the JAX bench's optimizer) and also reports peak device
memory and img/s.
``--quant`` profiles an int8 sampling view (f32 weights, quantized once in
the warm-up): the model's own (the flag's default: W8A8 for the U-ViT, the
convs for the SD-UNet) or another (``--quant w8``, ``conv8``, ``dense8``,
...).
``--field stage_delta_int8`` profiles the base-anchored stage-delta int8
field instead (``core/delta_field.py``, ``--hidden_mode exact|gelu|grad``,
default ``grad``): one base evaluation (the stage that writes the step's
cache) and one delta evaluation on that cache at a point 1e-2 away, each
traced on its own.
Needs a CUDA card.

    python -m uspace_tpu_torch.cli.profile_field --config uvit_large \\
        --batch 50 --attn_impl auto --out profile_field.json
    python -m uspace_tpu_torch.cli.profile_field --config unet_large \\
        --attn_impl auto --out profile_unet.json
    python -m uspace_tpu_torch.cli.profile_field --config unet_large_512 \\
        --out profile_unet_512.json
    python -m uspace_tpu_torch.cli.profile_field --quant --out q.json
    python -m uspace_tpu_torch.cli.profile_field --quant w8 --out w8.json
    python -m uspace_tpu_torch.cli.profile_field --attn_impl pallas_block \
        --quant --out block_int8.json
    python -m uspace_tpu_torch.cli.profile_field --field stage_delta_int8 \\
        --hidden_mode exact --out delta.json
    python -m uspace_tpu_torch.cli.profile_field --train --batch 128 \\
        --remat_exempt 21 --out profile_train.json
    python -m uspace_tpu_torch.cli.profile_field --train --config unet_large \\
        --batch 128 --out profile_unet_train.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict
from typing import Optional

import torch

from .. import resolve_device
from ..configs import get_config
from .sample_lfm import QUANT_CHOICES, build_model
from .train_lfm import train_attn_impl

# rows 20, 21 and 22 are the f32 code pass, their fc1 instance
# (delta_fc1_kernel<5> for rows 20 and 21, <4> for row 22) and fc2 storing
# m (delta_fc2_kernel<true, true>); the delta rows are each a code pass,
# their fc1 instance (delta_fc1_kernel<Dg>: rows 25, 23 and 24) and the
# shared fc2 (delta_fc2_kernel<false, false>). The pieces the base rows
# share go to the profiled hidden mode's row.
_BASE_ROW = {m: f"stage-delta MLP, {m} base: f32 code pass, fc1 and fc2 "
             f"with m on wgmma (ours: row {row})"
             for m, row in (("grad", 22), ("gelu", 21), ("exact", 20))}
_BASE_SHARED = "stage-delta MLP base: code pass, fc1 of rows 20-21 and fc2"
_DELTA_MLP = (
    (_BASE_ROW["grad"], ("delta_fc1_kernel<4>",)),
    (_BASE_SHARED, ("base_code_pass_kernel", "delta_fc1_kernel<5>",
                    "delta_fc2_kernel<true, true>"))
) + tuple(
    (f"stage-delta MLP, {what} delta fc1 on wgmma (ours: row {row})",
     (f"delta_fc1_kernel<{dg}>",))
    for dg, what, row in ((0, "exact", 25), (1, "grad", 23), (2, "gelu", 24)))

# kernel-name fragments -> the layer that launches them
GROUPS = (
    ("stage-delta row passes (ours: rows 18-19's LN codes and difference "
     "codes; rows 19 and 23-25's code pass)", (
         "row_codes_kernel<", "ln_delta_codes_kernel")),
    # row 15's GEMMs are instances of the delta rows' fc1 and fc2 bodies
    ("W8A8 MLP sub-block, code pass, fc1 and fc2 on wgmma (ours: row 15)",
     ("mlp_code_pass_kernel", "delta_fc1_kernel<3>",
      "delta_fc2_kernel<true, false>")),
    *_DELTA_MLP,
    ("stage-delta MLP, delta fc2 on wgmma (ours: rows 23-25)",
     ("delta_fc2_kernel<false",)),
    # rows 4 and 8 share one body, templated on the layout
    ("packed attention backward (ours: row 4)", (
        "fused_bwd_dq_kernel<64, true", "fused_bwd_dkdv_kernel<64, true")),
    ("[B, H, L, D] attention backward kernel (ours: row 8)", (
        "fused_bwd_dq_kernel", "fused_bwd_dkdv_kernel")),
    ("int8 attention row-code pass and projection (ours: rows 6, 11)",
     ("row_codes_kernel", "proj_residual_kernel")),
    ("blocked attention kernel (ours: row 9)", ("flash_attention_kernel",)),
    ("attention LN pass (ours: row 3)", ("ln_rows_kernel",)),
    ("int8 attention LN code pass (ours: row 5)", ("ln_codes_kernel",)),
    # before "matmul (cuBLAS)": their names contain "gemm"
    ("QKV projection on wgmma (ours: rows 2-3)", ("qkv_gemm_kernel<false",)),
    ("stage-delta qkv and xm GEMMs on wgmma (ours: row 19)",
     ("qkv_gemm_kernel<true, 1>", "qkv_gemm_kernel<true, 2>")),
    ("stage-delta base qkv GEMM, amax and code passes on wgmma (ours: "
     "row 18)", ("qkv_gemm_kernel<true, 3>", "qkv_gemm_kernel<true, 4>")),
    ("int8 QKV projection on wgmma (ours: rows 5, 6, 11)",
     ("qkv_gemm_kernel<true",)),
    ("bf16-chain LN pass (ours: rows 16, 13, 10-11)", ("w8_ln_kernel",)),
    ("w8 MLP fc1 on wgmma (ours: rows 16-17)", ("w8_gemm_kernel<0",)),
    ("w8 MLP sub-block, fc2 on wgmma (ours: row 16)", ("w8_gemm_kernel<1",)),
    ("w8 MLP, fc2 on wgmma (ours: row 17)", ("w8_gemm_kernel<2",)),
    ("bf16 GEMMs on wgmma (ours: rows 12-13 fc1 and fc2, row 10's "
     "projection)", ("::gemm_kernel<",)),
    ("attention core (ours: rows 1-3, 5, 6, 11)", ("packed_core_kernel",)),
    ("[B, H, L, D] attention kernel (ours)", ("attention_fwd_kernel",)),
    ("int8 MLP kernel (ours: row 14)", ("mlp_int8_kernel",)),
    ("layout transposes (NHWC <-> NCHW)", ("nchwToNhwc", "nhwcToNchw")),
    ("conv (cuDNN)", ("conv", "Conv", "cudnn", "fprop")),
    ("matmul (cuBLAS)", ("gemm", "Gemm", "cutlass", "sm90_xmma", "nvjet")),
    ("softmax", ("softmax", "Softmax")),
    ("reduction", ("reduce", "Reduce")),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "Copy",
                            "cat", "Cat", "fill", "Fill")),
)


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def _field_fn(cfg, dev, batch, attn_impl, seed, quant=None):
    """One sampling-field evaluation, without autograd."""
    model = build_model(cfg, dev, seed, attn_impl=attn_impl, quant=quant)
    c, h, w = cfg["z_shape"]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((batch, h, w, c), generator=g, device=dev)
    t = torch.full((batch,), 0.5, device=dev)

    @torch.no_grad()
    def run():
        model(x, t)
    return run


def _delta_fns(cfg, dev, batch, attn_impl, seed, hidden_mode=None):
    """One base and one delta evaluation of the stage-delta field in
    ``hidden_mode`` (the delta on the base's cache at x + 1e-2 n), without
    autograd."""
    from ..core import delta_field

    model = build_model(cfg, dev, seed, attn_impl=attn_impl)
    dp = delta_field.prepare_delta_params(model)
    vf_base, vf_delta = delta_field.make_delta_field(model, dp,
                                                     hidden_mode=hidden_mode)
    c, h, w = cfg["z_shape"]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((batch, h, w, c), generator=g, device=dev)
    x1 = x + 1e-2 * torch.randn(x.shape, generator=g, device=dev)
    t = torch.tensor(0.5)
    with torch.no_grad():
        _, cache = vf_base(t, x)

    @torch.no_grad()
    def base():
        vf_base(t, x)

    @torch.no_grad()
    def delta():
        vf_delta(t, x1, cache)
    return {"base": base, "delta": delta}


def _train_fn(cfg, dev, batch, attn_impl, seed, remat_exempt):
    """One train step of the JAX bench's setup (bench.py:567-581) on a
    fixed batch of synthetic moments."""
    from ..data.datasets import SyntheticFeatures
    from ..train.state import TrainState, get_lr_schedule, get_optimizer
    from ..train.step import make_train_step
    from .train_lfm import build_train_model

    model = build_train_model(cfg, dev, seed, attn_impl, remat_exempt)
    lr = get_lr_schedule("customized", 2e-4, warmup_steps=100)
    tx = get_optimizer("adam", lr, betas=(0.99, 0.99), weight_decay=0.03)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, lr_schedule=lr, ema_rate=0.995,
                           latents_from_moments=True)
    c, h, w = cfg["z_shape"]
    data = SyntheticFeatures(num=batch, shape=(h, w, 2 * c), seed=seed)
    x = torch.from_numpy(data.batch(range(batch))["x"]).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    return lambda: step(state, {"x": x}, g)


def _trace(fn, batch: int, evals: int, hidden_mode: str = "grad") -> dict:
    """Warm ``fn`` up, trace ``evals`` calls: device time by kernel and by
    layer (rows 20-22's shared pieces under ``hidden_mode``'s row), host
    wall time, idle share, peak memory."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(evals):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / evals
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name][0] += e.time_range.elapsed_us() / 1e3 / evals
            kernels[e.name][1] += 1
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    groups = defaultdict(float)
    for name, (ms, _) in kernels.items():
        group = _group(name)
        if group == _BASE_SHARED:
            group = _BASE_ROW.get(hidden_mode, group)
        groups[group] += ms
    busy = sum(groups.values())
    return dict(
        wall_ms_per_eval=wall * 1e3,
        imgs_per_s=batch / wall,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        device_ms_per_eval=busy,
        idle_share=max(0.0, 1.0 - busy / (wall * 1e3)),
        groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=n[:120], ms=ms, calls=cnt // evals)
                     for n, (ms, cnt) in sorted(kernels.items(),
                                                key=lambda kv: -kv[1][0])[:15]],
    )


def profile(config: str = "uvit_large", batch: int = 50, evals: int = 3,
            attn_impl: Optional[str] = None, seed: int = 0, device=None,
            train: bool = False, remat_exempt: Optional[int] = None,
            quant=None, field: Optional[str] = None,
            hidden_mode: Optional[str] = None) -> dict:
    """``attn_impl`` defaults to auto, or with ``train`` to the training
    rule; ``remat_exempt`` to the config's (U-ViT only). With ``field`` the
    report's ``parts`` hold the base's and the delta's traces, of the
    stage-delta field in ``hidden_mode`` (default its ``grad``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_field measures the card; it needs CUDA")
    if field not in (None, "stage_delta_int8"):
        raise ValueError(f"unknown field {field!r}")
    cfg = get_config(config)
    if attn_impl is None:
        attn_impl = train_attn_impl(cfg) if train else "auto"
    head = dict(config=config, batch=batch, attn_impl=attn_impl, quant=quant,
                field=field, hidden_mode=hidden_mode if field else None,
                evals=evals, train=train,
                remat_exempt=remat_exempt if train else None,
                card=torch.cuda.get_device_name(0))
    if field:
        fns = _delta_fns(cfg, dev, batch, attn_impl, seed, hidden_mode)
        return dict(head, parts={k: _trace(f, batch, evals,
                                           hidden_mode or "grad")
                                 for k, f in fns.items()})
    fn = (_train_fn(cfg, dev, batch, attn_impl, seed, remat_exempt) if train
          else _field_fn(cfg, dev, batch, attn_impl, seed, quant))
    return dict(head, **_trace(fn, batch, evals))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="uvit_large")
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--evals", type=int, default=3)
    ap.add_argument("--attn_impl", default=None,
                    help="default: auto, or with --train the training rule "
                    "(pallas_packed for the U-ViT, auto for the SD-UNet)")
    ap.add_argument("--train", action="store_true",
                    help="trace train steps instead of field evaluations")
    ap.add_argument("--remat_exempt", type=int, default=None,
                    help="U-ViT blocks exempt from remat (default: the "
                    "config's)")
    ap.add_argument("--quant", nargs="?", const=True, default=None,
                    choices=QUANT_CHOICES,
                    help="profile an int8 sampling view (flag alone: the "
                    "model's own)")
    ap.add_argument("--field", default=None, choices=["stage_delta_int8"],
                    help="profile one base and one delta evaluation of the "
                    "stage-delta int8 field")
    ap.add_argument("--hidden_mode", default=None,
                    choices=["exact", "gelu", "grad"],
                    help="the stage-delta field's MLP hidden cache (default "
                    "grad)")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    rep = profile(a.config, a.batch, a.evals, a.attn_impl, train=a.train,
                  remat_exempt=a.remat_exempt, quant=a.quant, field=a.field,
                  hidden_mode=a.hidden_mode)
    what = (f"train step, remat_exempt {a.remat_exempt}" if a.train
            else f"field evaluation, quant={a.quant}")
    parts = rep.get("parts") or {what: rep}
    for name, p in parts.items():
        if a.field:
            name = f"{a.field} ({rep['hidden_mode'] or 'grad'}) {name} " \
                "evaluation"
        print(f"{rep['card']}: {rep['config']} batch {rep['batch']} "
              f"attn_impl={rep['attn_impl']} ({name}): wall "
              f"{p['wall_ms_per_eval']:.2f} ms/eval, device "
              f"{p['device_ms_per_eval']:.2f} ms/eval, idle "
              f"{p['idle_share']:.3f}, {p['imgs_per_s']:.3f} img/s, peak "
              f"{p['peak_gib']:.2f} GiB")
        for g, ms in p["groups_ms"].items():
            print(f"  {g:34s} {ms:9.3f} ms")
        for k in p["top_kernels"]:
            print(f"  {k['ms']:9.3f} ms x{k['calls']:4d}  {k['name']}")
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(rep, f, indent=1)


if __name__ == "__main__":
    main()
