"""Cross-check the editing verdict of the UNet toy between the PyTorch port
and the JAX package (docs/editing_e2e_torch.md).

The port's `cli/editing_e2e` failed the `synthetic_attr_unet_e2e` toy that
the JAX harness passes on its own trained weights. This script separates
the training from the harness: it trains the toy with the JAX loop, and it
runs either harness on either set of EMA weights (the port's, as
`cli/train_lfm` saves them, or the JAX loop's), optionally with the JAX
harness's noise draws fed to the port's harness, and the port's harness at
other seeds (the config's ``seed``, which draws the read's latents and the
sweeps' noise) on the CPU or the card.

    # the JAX loop's toy (3000 steps on the CPU, about 20 minutes; the
    # config's seed, which draws the init, the data order and the noise)
    python experiments/torch_unet_editing_crosscheck.py train-jax out.npz \\
        [--seed 1]
    # a verdict: weights port:<ema_params.pt or a cli/train_lfm checkpoint>
    # or jax:<out.npz>
    python experiments/torch_unet_editing_crosscheck.py verdict \\
        port:ema_params.pt jax /tmp/v [--jax-noise]
    # the port's harness at seeds 0..7 on the card (imports no JAX)
    python experiments/torch_unet_editing_crosscheck.py verdict \\
        jax:out.npz port /tmp/v --device cuda --seeds 0,1,2,3,4,5,6,7

`ema_params.pt` is `torch.load(<ckpts>/3000.pt)["ema_params"]`. Prints one
JSON line a seed: the seed, the verdict, each attribute's effect,
supported and raw monotone fractions, supported pairs, proxy and
ground-truth curves, the adaptive and fixadp ratios, the roundtrip.

    # the OT-CFM loss of each set of weights on the toy's training set,
    # every set on the same draws of t and the noise, by tenths of t
    python experiments/torch_unet_editing_crosscheck.py eval-loss \\
        port:ema_params.pt jax:out.npz [--repeats 4]
"""

import argparse
import json
import os

import numpy as np
import torch


def _jax():
    """The JAX package on the CPU (imported only where a step needs it)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import uspace_tpu  # noqa: F401  (pins the JAX platform first)
    import jax

    return jax


TOY = "synthetic_attr_unet_e2e"


def train_jax(out_npz, seed=None):
    jax = _jax()
    from uspace_tpu.configs.synthetic_attr_unet_e2e import get_config
    from uspace_tpu.train.loop import train

    cfg = get_config()
    if seed is not None:
        cfg.seed = seed
    cfg.train.eval_interval = 10**9  # no in-loop sampling
    state = train(cfg, os.path.splitext(out_npz)[0] + "_train")
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + [k], v)
        else:
            flat["/".join(prefix)] = np.asarray(node)

    walk([], dict(jax.device_get(state.ema_params)))
    np.savez(out_npz, **flat)


def port_model(weights, device):
    from uspace_tpu_torch.cli import sample_lfm
    from uspace_tpu_torch.codecs.convert import load_unet_from_jax, unflatten
    from uspace_tpu_torch.configs import get_config

    kind, path = weights.split(":", 1)
    model = sample_lfm.build_model(get_config(TOY), torch.device(device))
    if kind == "port":
        sd = torch.load(path, map_location=device)
        model.load_state_dict(sd.get("ema_params", sd))
    else:
        load_unet_from_jax(model, unflatten(dict(np.load(path))))
    return model


def jax_noise_into_port(seed):
    """Feed the port's harness the JAX harness's draws: the read's moment
    noise ``normal(fold_in(PRNGKey(seed), batch))`` and the sweeps' z
    ``normal(PRNGKey(seed), (16, 8, 8, 4))``."""
    jax = _jax()
    from uspace_tpu_torch.editing import drivers

    key = jax.random.PRNGKey(seed)
    count = [0]

    def sample_from_moments(moments, generator, scale_factor=0.18215):
        mean, logvar = moments.float().chunk(2, dim=-1)
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        eps = np.array(jax.random.normal(jax.random.fold_in(key, count[0]),
                                         tuple(mean.shape)))
        count[0] += 1
        return (mean + std * torch.from_numpy(eps)) * scale_factor

    z = torch.from_numpy(np.array(jax.random.normal(key, (16, 8, 8, 4))))
    sweep = drivers.DissectSession.write_sweep

    def write_sweep(self, *args, **kw):
        kw["fixed_z"] = z
        return sweep(self, *args, **kw)

    drivers.sample_from_moments = sample_from_moments
    drivers.DissectSession.write_sweep = write_sweep


def verdict(weights, harness, out, jax_noise=False, device="cpu",
            seed=None):
    from uspace_tpu_torch.configs import get_config

    model = port_model(weights, device)
    cfg = get_config(TOY)
    if seed is not None:
        cfg["seed"] = seed
    if harness == "port":
        from uspace_tpu_torch.cli import editing_e2e
        from uspace_tpu_torch.editing import drivers

        if jax_noise:
            jax_noise_into_port(cfg["seed"])
        editing_e2e.build_session = lambda c, d, s: (drivers.DissectSession(
            model, solver_kwargs=c["dissection"]["solver_kwargs"]), None)
        rep = editing_e2e.run(cfg, out, device=device)
    else:
        _jax()
        from uspace_tpu.cli import dissect_common
        from uspace_tpu.cli import editing_e2e as jax_e2e
        from uspace_tpu.codecs.convert import unet_torch_to_flax
        from uspace_tpu.configs.synthetic_attr_unet_e2e import get_config as jc

        params = {"params": unet_torch_to_flax(
            {k: v.float() for k, v in model.state_dict().items()})}
        dissect_common.load_nnet_params = lambda c, m, a: params
        jcfg = jc()
        jcfg.seed = cfg["seed"]
        rep = jax_e2e.run(jcfg, out)
    print(json.dumps({
        "seed": cfg["seed"],
        "passed": rep["passed"],
        "attrs": [dict(attr=r["attr"], effect=round(r["effect_size"], 2),
                       mono=r.get("monotone_fraction_supported"),
                       raw=round(r["monotone_fraction"], 3),
                       supported=r.get("supported_pairs"),
                       curve=[round(x, 3) for x in r["proj_latentz_delta"]],
                       gt=[round(x, 3) for x in r["proj_ground_truth"]])
                  for r in rep["attrs"]],
        "checks": [(c["solver"], round(c["response_vs_fixed"], 3))
                   for c in rep["adaptive_checks"]],
        "roundtrip": rep["roundtrip"]}), flush=True)


def eval_loss(weights, repeats=4, device="cpu", batch=512):
    """One JSON line a set of weights: the mean OT-CFM loss over the toy's
    training set, ``repeats`` draws of t and the noise a sample (the same
    draws for every set), and its means by tenths of t."""
    from uspace_tpu_torch.configs import get_config
    from uspace_tpu_torch.core import interpolant
    from uspace_tpu_torch.data.datasets import get_dataset
    from uspace_tpu_torch.train.step import sample_from_moments

    cfg = get_config(TOY)
    data = get_dataset(**cfg["dataset"]).get_split("train")
    moments = torch.from_numpy(np.stack([data[i]["x"]
                                         for i in range(len(data))]))
    sigma_min = cfg["dynamic"]["sigma_min"]
    for w in weights:
        model = port_model(w, device).eval()
        g = torch.Generator().manual_seed(0)
        losses, ts = [], []
        with torch.no_grad():
            for _ in range(repeats):
                for lo in range(0, len(moments), batch):
                    x1 = sample_from_moments(moments[lo:lo + batch], g)
                    t, x_t, u_t = interpolant.sample_path(x1, sigma_min, g)
                    v = model(x_t.to(device), t.to(device))
                    v = v[0] if isinstance(v, tuple) else v
                    losses.append(interpolant.cfm_loss(
                        v.float().cpu(), u_t))
                    ts.append(t)
        loss, t = torch.cat(losses), torch.cat(ts)
        bins = (t * 10).long().clamp(max=9)
        print(json.dumps({
            "weights": w, "loss": round(float(loss.mean()), 5),
            "sem": round(float(loss.std() / len(loss) ** 0.5), 5),
            "by_tenth_of_t": [round(float(loss[bins == b].mean()), 4)
                              for b in range(10)]}), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    tj = sub.add_parser("train-jax")
    tj.add_argument("out_npz")
    tj.add_argument("--seed", type=int, default=None,
                    help="default: the config's")
    vd = sub.add_parser("verdict")
    vd.add_argument("weights", help="port:<ema_params.pt or <step>.pt> or "
                    "jax:<out.npz>")
    vd.add_argument("harness", choices=("port", "jax"))
    vd.add_argument("out")
    vd.add_argument("--jax-noise", action="store_true")
    vd.add_argument("--device", default="cpu")
    vd.add_argument("--seeds", default=None,
                    help="comma-separated seeds (default: the config's)")
    ev = sub.add_parser("eval-loss")
    ev.add_argument("weights", nargs="+")
    ev.add_argument("--repeats", type=int, default=4)
    ev.add_argument("--device", default="cpu")
    a = ap.parse_args()
    if a.cmd == "eval-loss":
        eval_loss(a.weights, a.repeats, a.device)
    elif a.cmd == "train-jax":
        train_jax(a.out_npz, a.seed)
    elif a.seeds is None:
        verdict(a.weights, a.harness, a.out, a.jax_noise, a.device)
    else:
        for s in (int(x) for x in a.seeds.split(",")):
            verdict(a.weights, a.harness, os.path.join(a.out, f"seed{s}"),
                    a.jax_noise, a.device, s)
