"""One rank of a multi-process horovod_tpu_torch world on gloo/CPU.

Imports only torch, numpy and the port (never jax or horovod_tpu), so a
spawned rank starts in about two seconds. Run by the ``test_torch_*`` files:

    python tests/torch_worker.py SCENARIO RANK SIZE PORT OUT_FILE [DEVICE]

DEVICE is ``cpu`` (gloo, the default) or ``cuda`` (NCCL, rank r on card r).

Each scenario makes its inputs from a seed with numpy, drives the port's
public API, and pickles a dict of numpy results to OUT_FILE. The tests call
:func:`run_world`.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT_S = 120


def mlp_data():
    """Regression data of the optimizer scenario: 8 rows, 4 features."""
    rng = np.random.RandomState(7)
    return (rng.randn(8, 4).astype(np.float32),
            rng.randn(8, 2).astype(np.float32))


def mlp_params():
    """Rank 0's starting weights, (in, out) like a flax Dense kernel."""
    rng = np.random.RandomState(8)
    return (0.5 * rng.randn(4, 8).astype(np.float32),
            0.5 * rng.randn(8, 2).astype(np.float32))


def shard_rows(rank: int, size: int, n: int) -> slice:
    """The rows of an n-row batch that ``rank`` trains on."""
    return slice(rank * n // size, (rank + 1) * n // size)


def run_world(scenario: str, size: int, out_dir, device="cpu") -> list:
    """Run ``scenario`` in ``size`` fresh processes and return each rank's
    result dict, in rank order."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    outs = [Path(out_dir) / f"{scenario}.rank{r}.pkl" for r in range(size)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(size), str(port),
         str(outs[r]), device], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(size)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {scenario!r} exited "
                               f"{p.returncode}:\n{logs[r]}")
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def _engine_scenario(hvd, rank: int, size: int) -> dict:
    import torch
    out = {"rank": hvd.rank(), "size": hvd.size(),
           "local_rank": hvd.local_rank(), "local_size": hvd.local_size(),
           "cross_rank": hvd.cross_rank(), "cross_size": hvd.cross_size()}
    rng = np.random.RandomState(100 + rank)
    x = rng.randn(5, 3).astype(np.float32)
    out["x"] = x
    out["allreduce_sum"] = hvd.allreduce(torch.from_numpy(x), name="ar.s",
                                         op=hvd.Sum).cpu().numpy()
    out["allreduce_avg"] = hvd.allreduce(torch.from_numpy(x), name="ar.a",
                                         op=hvd.Average,
                                         prescale_factor=2.0,
                                         postscale_factor=0.5).cpu().numpy()
    out["allreduce_max"] = hvd.allreduce(torch.from_numpy(x), name="ar.m",
                                         op=hvd.Max).cpu().numpy()
    shapes = [(4,), (3, 5), (2, 2, 2), (7,), (1,)]
    group = [rng.randn(*s).astype(np.float32) for s in shapes]
    out["group"] = group
    for op_name, op in (("sum", hvd.Sum), ("avg", hvd.Average)):
        # HOROVOD_FUSION_THRESHOLD=64 (set by main) cuts the group into
        # several buckets
        res = hvd.grouped_allreduce([torch.from_numpy(g) for g in group],
                                    name=f"g.{op_name}", op=op,
                                    prescale_factor=3.0,
                                    postscale_factor=0.25)
        out[f"grouped_{op_name}"] = [r.cpu().numpy() for r in res]
    ints = torch.arange(6, dtype=torch.int32) * (rank + 1)
    out["grouped_int_sum"] = [
        r.cpu().numpy() for r in hvd.grouped_allreduce(
            [ints, ints[:2]], name="g.int", op=hvd.Sum)]
    b = torch.full((3,), float(rank + 1))
    out["broadcast"] = hvd.broadcast(b, root_rank=size - 1,
                                     name="bc").cpu().numpy()
    rows = rng.randn(rank + 1, 2).astype(np.float32)
    out["gather_in"] = rows
    out["allgather"] = hvd.allgather(torch.from_numpy(rows),
                                     name="ag").cpu().numpy()
    h = hvd.allreduce_async(torch.ones(4) * (rank + 1), name="async")
    out["async"] = hvd.synchronize(h).cpu().numpy()
    out["async_poll_after"] = hvd.poll(h)
    out["objects"] = hvd.allgather_object({"rank": rank})
    out["object_bcast"] = hvd.broadcast_object(
        {"from": rank} if rank == 0 else None, root_rank=0)
    hvd.barrier()
    return out


def _optimizer_scenario(hvd, rank: int, size: int) -> dict:
    import torch
    data_x, data_y = mlp_data()
    w1, w2 = mlp_params()
    # every rank starts from its own weights: broadcast_parameters must
    # make them rank 0's
    model = torch.nn.Sequential(torch.nn.Linear(4, 8, bias=False),
                                torch.nn.Tanh(),
                                torch.nn.Linear(8, 2, bias=False))
    with torch.no_grad():
        model[0].weight.copy_(torch.from_numpy(w1.T) + rank)
        model[2].weight.copy_(torch.from_numpy(w2.T) + rank)
    model.to(hvd.device())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        op=hvd.Average)
    shard = shard_rows(rank, size, len(data_x))
    xs = torch.from_numpy(data_x[shard]).to(hvd.device())
    ys = torch.from_numpy(data_y[shard]).to(hvd.device())
    traj = []
    for _ in range(3):
        opt.zero_grad()
        loss = ((model(xs) - ys) ** 2).mean()
        loss.backward()
        opt.step()
        traj.append([model[0].weight.detach().cpu().numpy().T.copy(),
                     model[2].weight.detach().cpu().numpy().T.copy()])
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    return {"traj": traj}


SCENARIOS = {"engine": _engine_scenario, "optimizer": _optimizer_scenario}


def main(argv):
    scenario, rank, size, port, out_file = argv[:5]
    device = argv[5] if len(argv) > 5 else "cpu"
    os.environ.update({
        "HOROVOD_TPU_COORDINATOR": f"127.0.0.1:{port}",
        "HOROVOD_TPU_NUM_PROCESSES": size,
        "HOROVOD_TPU_PROCESS_ID": rank,
        "HOROVOD_LOCAL_RANK": rank,
        "HOROVOD_LOCAL_SIZE": size,
        "HOROVOD_TPU_SHUTDOWN_TIMEOUT": "60",
        "HOROVOD_FUSION_THRESHOLD": "64",
    })
    import horovod_tpu_torch as hvd
    hvd.init(device=device)
    try:
        result = SCENARIOS[scenario](hvd, int(rank), int(size))
    finally:
        hvd.shutdown()
    with open(out_file, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1:])
