"""How far a one-token prompt-to-prompt edit moves U-ViT-T2I-large's
decode on seeded weights, against the kernel route's own distance to the
plain route (the yardstick of `chip_smoke.py` phase 27).

Builds `uvit_t2i_large` with seeded weights, CLIP-L/14 contexts of 10
seeded prompts and the empty prompt, and decodes Euler-50 with CFG: the
plain route (`xla`) and the kernel route (`auto`) unedited, then the
plain route under an `AttnEdit` of one context token at a multiplier in
the prompts' half (the null prompts' at 1, or at the same multiplier),
for several tokens, at guidance 3 and 1. Prints each move as a share of
|x1| and as a multiple of the routes' distance. Run on a machine with a
card, from the repository root:

    python experiments/torch_t2i_p2p_probe.py
"""

import os
import sys

import torch

sys.path.insert(0, os.getcwd())

from uspace_tpu_torch.cli import sample_lfm  # noqa: E402
from uspace_tpu_torch.codecs.clip_text import CLIP_L14, build_clip  # noqa: E402
from uspace_tpu_torch.configs import get_config  # noqa: E402
from uspace_tpu_torch.core import flow  # noqa: E402
from uspace_tpu_torch.editing.specs import AttnEdit, p2p_col_mult  # noqa: E402
from uspace_tpu_torch.evals.sampling import cfg_velocity_fn  # noqa: E402
from uspace_tpu_torch.ops import _build  # noqa: E402

N, L = 10, 334
SOT, EOT = 49406, 49407


def main():
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    _build.build()
    dev = torch.device("cuda")
    cfg = get_config("uvit_t2i_large")
    g = torch.Generator(device=dev).manual_seed(23)
    clip = build_clip(CLIP_L14, dev, seed=0)
    ids = torch.randint(0, CLIP_L14["vocab_size"], (50, 77), generator=g,
                        device=dev)
    empty = torch.full((1, 77), EOT, dtype=torch.int64, device=dev)
    empty[0, 0] = SOT
    with torch.no_grad():
        ctx = clip(ids)[:N]
        null = clip(empty).expand(N, -1, -1).contiguous()
    kernel = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="auto")
    plain = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="xla")
    plain.load_state_dict(kernel.state_dict())
    z = torch.randn((50, 32, 32, 4), generator=g, device=dev)[:N]
    sk = {"solver": "fixed", "solver_fix": "euler", "solver_fix_step": 0.02}

    def solve(model, scale, **kw):
        with torch.no_grad():
            return flow.decode(cfg_velocity_fn(
                model, {"context": ctx}, {"context": null}, scale, **kw),
                z, sk)

    def edit(token, m_cond, m_null):
        tgt = torch.full((2 * N, 1), token, dtype=torch.int64)
        return AttnEdit(p2p_col_mult(2 * N, L, tgt,
                                     [m_cond] * N + [m_null] * N,
                                     device=dev))

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    for scale, cases in ((3.0, ((1, 0.0, 1.0), (1, 2.0, 1.0), (1, 0.0, 0.0),
                                (20, 0.0, 1.0), (60, 0.0, 1.0),
                                (0, 0.0, 1.0), (76, 0.0, 1.0))),
                         (1.0, ((1, 0.0, 1.0), (1, 0.0, 0.0)))):
        x1 = solve(plain, scale)
        noise = rel(solve(kernel, scale), x1)
        print(f"s={scale}: route distance {noise:.3e}", flush=True)
        for token, m_cond, m_null in cases:
            x = solve(kernel, scale, attn_edit=edit(token, m_cond, m_null))
            print(f"  token {token} cond x{m_cond} null x{m_null}: moved "
                  f"{rel(x, x1):.3e} = {rel(x, x1) / noise:.2f}x",
                  flush=True)


if __name__ == "__main__":
    main()
