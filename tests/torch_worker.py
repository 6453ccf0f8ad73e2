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


class World:
    """``scenario`` running in ``size`` fresh processes; :meth:`results`
    waits for them (at most ``WORLD_TIMEOUT_S``, so a hang fails instead of
    stalling) and returns each rank's result dict, in rank order."""

    def __init__(self, scenario: str, size: int, out_dir, device="cpu"):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=str(REPO))
        self.scenario = scenario
        self.outs = [Path(out_dir) / f"{scenario}.rank{r}.pkl"
                     for r in range(size)]
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, scenario, str(r), str(size),
             str(port), str(self.outs[r]), device], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(size)]

    def results(self) -> list:
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(self.procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {self.scenario!r} exited "
                                   f"{p.returncode}:\n{logs[r]}")
        results = []
        for path in self.outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results


def run_world(scenario: str, size: int, out_dir, device="cpu") -> list:
    """Run ``scenario`` in ``size`` fresh processes and return each rank's
    result dict, in rank order."""
    return World(scenario, size, out_dir, device).results()


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


def lm_config():
    """The tiny fp32 decoder LM of the ``lm`` scenario."""
    import torch
    from horovod_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                             n_layers=2, d_ff=64, max_seq=16,
                             dtype=torch.float32, attention="flash")


def lm_tokens():
    """4 sequences of 17 tokens: inputs are [:, :-1], targets [:, 1:]."""
    return np.random.RandomState(9).randint(0, 64, size=(4, 17))


LM_STEPS = 3


def _lm_scenario(hvd, rank: int, size: int) -> dict:
    """The flagship loop at toy size: broadcast_parameters, then
    DistributedOptimizer(AdamW) on this rank's rows of the batch."""
    import torch
    from horovod_tpu_torch.models.transformer import Transformer, lean_lm_loss
    # every rank starts from its own weights: broadcast_parameters must make
    # them rank 0's
    model = Transformer(lm_config(),
                        generator=torch.Generator().manual_seed(rank))
    model.to(hvd.device())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        op=hvd.Average)
    tokens = lm_tokens()[shard_rows(rank, size, 4)]
    x = torch.from_numpy(tokens[:, :-1]).to(hvd.device())
    y = torch.from_numpy(tokens[:, 1:]).to(hvd.device())
    losses = []
    for _ in range(LM_STEPS):
        opt.zero_grad()
        loss = lean_lm_loss(model, x, y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return {"losses": losses,
            "params": {n: p.detach().cpu().numpy()
                       for n, p in model.named_parameters()}}


RING_DIMS = (2, 4, 4, 8)     # B, T_local, H, D of the ring worlds
# (attention, causal, layout) of each case of the ``ring`` scenario
RING_CASES = tuple((att, causal, layout)
                   for causal in (True, False)
                   for att, layout in (("ring", "contiguous"),
                                       ("ring", "zigzag"),
                                       ("ulysses", "contiguous")))


def ring_inputs(n: int, causal: bool, layout: str):
    """Global fp32 q, k, v and the output cotangent [B, n*T_local, H, D],
    their sequence already in ``layout`` order (zig-zag permuted)."""
    b, t, h, d = RING_DIMS
    rng = np.random.RandomState(20 + n + 2 * causal)
    xs = [rng.randn(b, n * t, h, d).astype(np.float32) for _ in range(4)]
    if layout == "zigzag":
        idx = zigzag_order(n * t, n)
        xs = [x[:, idx] for x in xs]
    return xs


def zigzag_order(t_global: int, n: int) -> np.ndarray:
    """The port's zigzag permutation as a numpy index (the tests hold it
    equal to the reference's)."""
    from horovod_tpu_torch.parallel.ring_attention import zigzag_indices
    return zigzag_indices(t_global, n)[0].numpy()


def _ring_scenario(hvd, rank: int, size: int) -> dict:
    """Ring attention (both layouts) and Ulysses over the whole world as
    the sequence group: each rank's output block, its q/k/v gradients and
    the segments each pass ran."""
    import torch
    import torch.distributed as dist
    from horovod_tpu_torch.parallel import ring_attention as R
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention_p
    torch.set_num_threads(1)     # tiny tensors; the ranks share the cores
    group = dist.new_group(list(range(size)))
    t = RING_DIMS[1]
    out = {}
    for att, causal, layout in RING_CASES:
        q, k, v, do = (torch.from_numpy(x[:, rank * t:(rank + 1) * t].copy())
                       for x in ring_inputs(size, causal, layout))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        R.SEGMENTS.update(forward=0, backward=0)
        if att == "ring":
            o = R.ring_attention_p(q, k, v, group, size, causal=causal,
                                   layout=layout)
        else:
            o = ulysses_attention_p(q, k, v, group, size, causal=causal)
        o.backward(do)
        out[(att, causal, layout)] = {
            "out": o.detach().numpy(),
            "grads": [x.grad.numpy() for x in (q, k, v)],
            "segments": dict(R.SEGMENTS)}
    return out


SP_DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
               max_seq=16)
SP_MESHES = ((1, 4), (2, 2))                 # (data, seq)
SP_VARIANTS = (("ring", "contiguous"), ("ring", "zigzag"),
               ("ulysses", "contiguous"))
SP_STEPS = 2
SP_LRS = {"sgd": 0.1, "adamw": 1e-3}


def sp_params() -> dict:
    """The LM's weights in the reference's tree (layers stacked), fp32,
    with the reference's scales and norm scales away from 1."""
    rng = np.random.RandomState(11)
    d, h, f, v, n = (SP_DIMS[k] for k in ("d_model", "n_heads", "d_ff",
                                           "vocab_size", "n_layers"))
    dh = d // h

    def normal(shape, fan_in):
        return (rng.randn(*shape) * fan_in ** -0.5).astype(np.float32)

    layers = {"ln1": (1 + 0.1 * rng.randn(n, d)).astype(np.float32),
              "wq": normal((n, d, h, dh), d), "wk": normal((n, d, h, dh), d),
              "wv": normal((n, d, h, dh), d), "wo": normal((n, h, dh, d), d),
              "ln2": (1 + 0.1 * rng.randn(n, d)).astype(np.float32),
              "w1": normal((n, d, f), d), "w2": normal((n, f, d), f)}
    return {"embed": normal((v, d), 1) * 0.5, "layers": layers,
            "ln_f": (1 + 0.1 * rng.randn(d)).astype(np.float32)}


def sp_tokens():
    """(inputs, targets) [4, 16] of the SP scenario."""
    rng = np.random.RandomState(12)
    return (rng.randint(0, SP_DIMS["vocab_size"], size=(4, 16)),
            rng.randint(0, SP_DIMS["vocab_size"], size=(4, 16)))


def _sp_lm_scenario(hvd, rank: int, size: int) -> dict:
    """The LM's sequence-parallel loss and train steps on (data, seq)
    meshes, for each attention variant and optimizer."""
    import torch
    from horovod_tpu_torch.models.convert import transformer_from_jax
    from horovod_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, make_spmd_loss, make_train_step,
        shard_tokens)
    from horovod_tpu_torch.parallel.mesh import training_mesh
    torch.set_num_threads(1)     # tiny tensors; the ranks share the cores
    out = {}
    try:
        training_mesh({"data": 1, "seq": size // 2, "tensor": 2})
    except NotImplementedError as e:
        out["tensor_error"] = str(e)
    meshes = {shape: training_mesh({"data": shape[0], "seq": shape[1],
                                    "tensor": 1}) for shape in SP_MESHES}
    inputs, targets = sp_tokens()
    for (d, s), mesh in meshes.items():
        for attention, layout in SP_VARIANTS:
            cfg = TransformerConfig(dtype=torch.float32, attention=attention,
                                    sp_layout=layout, **SP_DIMS)
            x, y = inputs, targets
            if layout == "zigzag":
                idx = zigzag_order(x.shape[1], s)
                x, y = x[:, idx], y[:, idx]
            x, y = (shard_tokens(mesh, torch.from_numpy(a)) for a in (x, y))
            state = transformer_from_jax(sp_params(), cfg)
            model = Transformer(cfg)
            model.load_state_dict(state)
            case = {"loss": float(make_spmd_loss(mesh, cfg)(model, x, y))}
            for name, lr in SP_LRS.items():
                model.load_state_dict(state)
                opt = (torch.optim.SGD(model.parameters(), lr=lr)
                       if name == "sgd" else
                       torch.optim.AdamW(model.parameters(), lr=lr,
                                         betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=1e-4))
                step = make_train_step(mesh, cfg, opt)
                losses = [float(step(model, x, y)) for _ in range(SP_STEPS)]
                case[name] = {"losses": losses, "params": {
                    n: p.detach().numpy().copy()
                    for n, p in model.named_parameters()}}
            out[((d, s), attention, layout)] = case
    return out


SP_CARD_DIMS = dict(vocab_size=256, d_model=256, n_heads=4, n_layers=2,
                    d_ff=512, max_seq=256)


def sp_card_tokens():
    """(inputs, targets) [2, 256] of the card SP scenario."""
    rng = np.random.RandomState(13)
    return (rng.randint(0, 256, size=(2, 256)),
            rng.randint(0, 256, size=(2, 256)))


def sp_card_model(cfg, device):
    """The bf16 LM of the card SP scenario, the same weights on every rank
    and in the one-card reference."""
    import torch
    from horovod_tpu_torch.models.transformer import Transformer
    return Transformer(cfg, generator=torch.Generator().manual_seed(0)).to(
        device)


def _sp_cards_scenario(hvd, rank: int, size: int) -> dict:
    """Two SGD steps of the bf16 LM, the whole world on the seq axis, on
    the card (NCCL, kernels K6/K7), for each attention variant."""
    import torch
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig, make_train_step, shard_tokens)
    from horovod_tpu_torch.parallel.mesh import training_mesh
    mesh = training_mesh({"data": 1, "seq": size, "tensor": 1})
    inputs, targets = sp_card_tokens()
    out = {}
    for attention, layout in SP_VARIANTS:
        cfg = TransformerConfig(dtype=torch.bfloat16, attention=attention,
                                sp_layout=layout, **SP_CARD_DIMS)
        x, y = inputs, targets
        if layout == "zigzag":
            idx = zigzag_order(x.shape[1], size)
            x, y = x[:, idx], y[:, idx]
        x, y = (shard_tokens(mesh, torch.from_numpy(a)).to(hvd.device())
                for a in (x, y))
        model = sp_card_model(cfg, hvd.device())
        step = make_train_step(mesh, cfg, torch.optim.SGD(
            model.parameters(), lr=SP_LRS["sgd"]))
        losses = [float(step(model, x, y)) for _ in range(SP_STEPS)]
        out[(attention, layout)] = {"losses": losses, "params": {
            n: p.detach().cpu().numpy() for n, p in model.named_parameters()}}
    return out


SCENARIOS = {"engine": _engine_scenario, "optimizer": _optimizer_scenario,
             "lm": _lm_scenario, "ring": _ring_scenario,
             "sp_lm": _sp_lm_scenario, "sp_cards": _sp_cards_scenario}


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
