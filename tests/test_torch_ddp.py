"""Data-parallel training over ``torch.distributed``: a real 2-process gloo
group on the CPU (tests/_torch_ddp_worker.py) against one process.

Both train ``synthetic_smoke`` at a global batch of 8 (4 a process, 8 on
one) through ``train/loop.fit`` for 6 steps. The two ranks agree bit for
bit (one all-reduce gives every process the same gradients); against one
process the losses agree within f32 summation order (rtol 1e-6: each
rank's mean over 4 rows, then the mean of the two, against the mean over
8; measured 9.6e-8 on the CPU) and the params and EMA within 2e-6 (six
Adam steps of lr 1e-4 move a weight by at most 6e-4; measured 3.6e-8 and
5.8e-11). Only rank 0 writes
(one checkpoint, one metrics record a step); the loader's shards
partition the data; a SIGTERM that reaches one rank stops both at the same
step boundary with one checkpoint.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import _torch_ddp_worker as worker
from uspace_tpu_torch.train import loop

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_ddp_worker.py")
STEPS = 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    port = str(_free_port())
    procs, outs = [], []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS="2")
        out = tmp / f"r{rank}.npz"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER, str(out), str(tmp), str(STEPS)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (so, se) in zip(procs, logs):
        assert p.returncode == 0, (f"rank failed\n--- stdout ---\n"
                                   f"{so[-3000:]}\n--- stderr ---\n"
                                   f"{se[-3000:]}")
    return tmp, [dict(np.load(o)) for o in outs]


def test_two_ranks_reproduce_one_process(ranks, tmp_path):
    tmp, (r0, r1) = ranks
    assert int(r0["rank"]) == 0 and int(r1["rank"]) == 1
    for k in r0.keys() - {"rank", "loader_ids"}:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    cfg = worker.config(STEPS)
    cfg["train"]["batch_size"] = 8
    exp = loop.Experiment(cfg, str(tmp_path / "one"), device="cpu")
    history = []
    res = loop.fit(exp, log=lambda s: None, history=history)
    np.testing.assert_allclose(r0["losses"], [h["loss"] for h in history],
                               rtol=1e-6)
    np.testing.assert_allclose(r0["grad_norms"],
                               [h["grad_norm"] for h in history], rtol=1e-5)
    for prefix, d in (("p/", res["state"].params),
                      ("e/", res["state"].ema_params)):
        for k, v in d.items():
            np.testing.assert_allclose(r0[prefix + k], v.detach().numpy(),
                                       rtol=0, atol=2e-6, err_msg=k)


def test_only_rank_zero_writes(ranks):
    tmp, (r0, _) = ranks
    run = tmp / "run"
    assert sorted(os.listdir(run / "ckpts")) == [f"{STEPS}.pt"]
    recs = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in recs] == list(range(1, STEPS + 1))
    assert int(r0["step"]) == STEPS


def test_collectives_and_loader_shards(ranks):
    _, (r0, r1) = ranks
    ag = r0["allgather"]
    assert ag.shape == (2, 2, 3)
    np.testing.assert_array_equal(ag[1] - ag[0], np.ones_like(ag[0]))
    ids0, ids1 = set(r0["loader_ids"]), set(r1["loader_ids"])
    assert ids0.isdisjoint(ids1) and ids0 | ids1 == set(range(32))
    np.testing.assert_array_equal(r0["loader_ids_all"], r1["loader_ids_all"])


def test_sigterm_on_one_rank_stops_both(ranks):
    tmp, (r0, r1) = ranks
    assert int(r0["stop_step"]) == int(r1["stop_step"]) == 2
    assert bool(r0["stop_preempted"]) and bool(r1["stop_preempted"])
    stop = tmp / "stop"
    assert sorted(os.listdir(stop / "ckpts")) == ["2.pt"]
    recs = [json.loads(line) for line in open(stop / "metrics.jsonl")]
    assert [r["step"] for r in recs if r.get("preempted")] == [2]
