"""One process of tests/test_torch_ddp.py's 2-process gloo group.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_ddp_worker.py <out.npz> <workdir> <steps>

Joins the group through ``parallel/distributed.initialize``, trains
``synthetic_smoke`` at 4 samples a process (a global batch of 8) through
``train/loop.fit`` into the shared ``<workdir>/run``, then exercises the
collectives and the loader's shards, then a second run into
``<workdir>/stop`` in which rank 1 alone receives a SIGTERM after its
second step. Writes what the test compares to ``out.npz``. Imports no JAX.
"""

import os
import signal
import sys

# `python tests/_torch_ddp_worker.py` puts tests/ (not the repo root) on
# sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(steps: int) -> dict:
    from uspace_tpu_torch.configs import get_config

    cfg = get_config("synthetic_smoke")
    cfg["train"].update(batch_size=4, n_steps=steps, log_interval=1,
                        eval_interval=1000, save_interval=1000)
    cfg["dl"]["num_workers"] = 1
    return cfg


def main() -> None:
    import numpy as np
    import torch

    from uspace_tpu_torch.data.loader import DataLoader
    from uspace_tpu_torch.parallel import distributed
    from uspace_tpu_torch.train import loop
    from uspace_tpu_torch.train.step import make_train_step

    out_path, workdir, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
    torch.set_num_threads(2)
    distributed.initialize()
    rank, world = distributed.process_index(), distributed.process_count()
    assert world == 2, world

    exp = loop.Experiment(config(steps), os.path.join(workdir, "run"),
                          device="cpu")
    history = []
    res = loop.fit(exp, log=lambda s: None, history=history)
    out = dict(rank=rank, losses=np.array([h["loss"] for h in history]),
               grad_norms=np.array([h["grad_norm"] for h in history]),
               step=res["step"])
    for k, v in res["state"].params.items():
        out["p/" + k] = v.detach().numpy()
    for k, v in res["state"].ema_params.items():
        out["e/" + k] = v.detach().numpy()

    # the collectives and the loader's shards (tests/_mp_worker.py)
    local = np.full((2, 3), float(rank), np.float32) + np.arange(3)
    out["allgather"] = distributed.process_allgather(local)
    distributed.barrier("after-allgather")

    class Ids:
        def __len__(self):
            return 32

        def __getitem__(self, i):
            return {"x": np.float32(i)}

    ids = np.concatenate([b["x"] for b in DataLoader(
        Ids(), 4, seed=3, num_workers=1, process_index=rank,
        process_count=world).epoch(0)]).astype(np.int64)
    out["loader_ids"] = ids
    out["loader_ids_all"] = distributed.process_allgather(ids)

    # a SIGTERM that reaches rank 1 alone, after its second step
    def make_step(*a, **kw):
        step = make_train_step(*a, **kw)

        def interrupted(state, batch, gen):
            m = step(state, batch, gen)
            if rank == 1 and int(state.step) == 2:
                signal.raise_signal(signal.SIGTERM)
            return m
        return interrupted

    exp2 = loop.Experiment(config(steps), os.path.join(workdir, "stop"),
                           device="cpu", make_step=make_step)
    res2 = loop.fit(exp2, log=lambda s: None)
    out["stop_step"] = res2["step"]
    out["stop_preempted"] = res2["preempted"]
    distributed.barrier("end")
    np.savez(out_path, **out)


if __name__ == "__main__":
    main()
