"""One rank of a multi-process horovod_tpu_torch world on gloo/CPU.

Imports only torch, numpy and the port (never jax or horovod_tpu), so a
spawned rank starts in about two seconds. Run by the ``test_torch_*`` files:

    python tests/torch_worker.py SCENARIO RANK SIZE PORT OUT_FILE [DEVICE
                                 [LOCAL_SIZE]]

DEVICE is ``cpu`` (gloo, the default) or ``cuda`` (NCCL, rank r on card r).
LOCAL_SIZE (default SIZE) lays the ranks out as nodes of that many ranks
(``HOROVOD_LOCAL_SIZE``, local rank = rank % LOCAL_SIZE).

Each scenario makes its inputs from a seed with numpy, drives the port's
public API, and pickles a dict of numpy results to OUT_FILE. The tests call
:func:`run_world`.
"""

from __future__ import annotations

import faulthandler
import os
import pickle
import socket
import subprocess
import sys
import time
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

    def __init__(self, scenario: str, size: int, out_dir, device="cpu",
                 local_size=None, env=None, timeout=WORLD_TIMEOUT_S):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   TORCH_WORKER_TIMEOUT_S=str(timeout), **(env or {}))
        self.scenario = scenario
        self.timeout = timeout
        tag = f"{scenario}.n{size}.l{local_size or size}"
        self.outs = [Path(out_dir) / f"{tag}.rank{r}.pkl"
                     for r in range(size)]
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, scenario, str(r), str(size),
             str(port), str(self.outs[r]), device,
             str(local_size or size)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(size)]

    def results(self) -> list:
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0])
        except subprocess.TimeoutExpired:
            # each rank dumped its threads' stacks just before the timeout
            for p in self.procs:
                p.kill()
            raise RuntimeError(f"{self.scenario!r} timed out after "
                               f"{self.timeout} s:\n" + "\n".join(
                                   f"--- rank {r}:\n{p.communicate()[0]}"
                                   for r, p in enumerate(self.procs)))
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


def run_world(scenario: str, size: int, out_dir, device="cpu",
              **kwargs) -> list:
    """Run ``scenario`` in ``size`` fresh processes and return each rank's
    result dict, in rank order (``kwargs`` as :class:`World` takes them)."""
    return World(scenario, size, out_dir, device, **kwargs).results()


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


OPT_STEPS = 5           # the optimizer scenario: replay's warm-up + 2


def _replay_counters(hvd) -> tuple:
    r = hvd.global_state().engine.replay
    return (r.captured_streams, r.replayed_steps, r.fallbacks)


def _mlp_trajectory(hvd, rank: int, size: int, steps: int):
    """``steps`` SGD-momentum steps of the MLP on this rank's shard through
    DistributedOptimizer(op=Average), every rank starting from its own
    weights, which broadcast_parameters makes rank 0's: the weights after
    each step, the optimizer, and the replay counters' change."""
    import torch
    data_x, data_y = mlp_data()
    w1, w2 = mlp_params()
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
    before = _replay_counters(hvd)
    traj = []
    for _ in range(steps):
        opt.zero_grad()
        loss = ((model(xs) - ys) ** 2).mean()
        loss.backward()
        opt.step()
        traj.append([model[0].weight.detach().cpu().numpy().T.copy(),
                     model[2].weight.detach().cpu().numpy().T.copy()])
    counters = tuple(a - b for a, b in zip(_replay_counters(hvd), before))
    hvd.global_state().engine.replay.invalidate_all("next run")
    return traj, opt, counters


def _optimizer_scenario(hvd, rank: int, size: int) -> dict:
    """OPT_STEPS steps with step replay on (the warm-up, then replayed
    steps), then the same steps from the same start with it off."""
    cfg = hvd.global_state().config
    traj, opt, counters = _mlp_trajectory(hvd, rank, size, OPT_STEPS)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    cfg.step_replay = False
    traj_off, _, counters_off = _mlp_trajectory(hvd, rank, size, OPT_STEPS)
    cfg.step_replay = True
    return {"traj": traj, "traj_off": traj_off, "replay": counters,
            "replay_off": counters_off}


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


ADASUM_MLP_SIZES = (12, 16, 8, 4)    # the MLP of the ``adasum`` scenario
ADASUM_ROWS = 4                      # its rows of data per rank
ADASUM_STEPS = 2
ADASUM_SGD_LR = 0.1
ADASUM_ADAMW = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=1e-4)
ADASUM_GROUP_SHAPES = ((4,), (3, 5), (1,), (1000,))


def adasum_mlp_params():
    """The MLP's starting weights as the reference's ``init_mlp`` list,
    biases away from zero."""
    rng = np.random.RandomState(21)
    sizes = ADASUM_MLP_SIZES
    return [{"w": (rng.randn(i, o) * (2.0 / i) ** 0.5).astype(np.float32),
             "b": (0.1 * rng.randn(o)).astype(np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])]


def adasum_mlp_data(size: int):
    """(inputs, int labels) of the world's batch, ADASUM_ROWS a rank."""
    rng = np.random.RandomState(22)
    n = size * ADASUM_ROWS
    return (rng.randn(n, ADASUM_MLP_SIZES[0]).astype(np.float32),
            rng.randint(0, ADASUM_MLP_SIZES[-1], size=n))


def adasum_inputs(rank: int) -> dict:
    """A rank's tensors for the ``adasum`` scenario's collectives."""
    rng = np.random.RandomState(300 + rank)
    return {"single": rng.randn(7, 5).astype(np.float32),
            "group": [rng.randn(*s).astype(np.float32)
                      for s in ADASUM_GROUP_SHAPES],
            "bf16": rng.randn(64).astype(np.float32),
            "rs": rng.randn(5, 3).astype(np.float32)}


def _adasum_scenario(hvd, rank: int, size: int) -> dict:
    """op=Adasum through allreduce (plain, scaled, bf16, async) and
    grouped_allreduce, reducescatter (Sum, Average), and two steps each of
    DistributedOptimizer(SGD, op=Adasum) and
    DistributedDeltaAdasumOptimizer(AdamW) on the MLP."""
    import torch
    from horovod_tpu_torch.core.state import engine
    from horovod_tpu_torch.models.convert import mlp_from_jax
    from horovod_tpu_torch.models.mlp import MLP, mlp_loss
    from horovod_tpu_torch.ops.adasum import hierarchical_local_size
    torch.set_num_threads(1)     # tiny tensors; the ranks share the cores
    ins = adasum_inputs(rank)
    t = {k: torch.from_numpy(v) for k, v in ins.items() if k != "group"}
    out = {"local_size": hierarchical_local_size(engine())}
    out["single"] = hvd.allreduce(t["single"], name="ad.single",
                                  op=hvd.Adasum).numpy()
    out["scaled"] = hvd.allreduce(t["single"], name="ad.scaled",
                                  op=hvd.Adasum, prescale_factor=0.5,
                                  postscale_factor=3.0).numpy()
    out["group"] = [g.numpy() for g in hvd.grouped_allreduce(
        [torch.from_numpy(g) for g in ins["group"]], name="ad.group",
        op=hvd.Adasum)]
    out["bf16"] = hvd.allreduce(t["bf16"].bfloat16(), name="ad.bf16",
                                op=hvd.Adasum).float().numpy()
    h = hvd.allreduce_async(t["single"], name="ad.async", op=hvd.Adasum)
    out["async"] = hvd.synchronize(h).numpy()
    out["async_poll_after"] = hvd.poll(h)
    h = hvd.reducescatter_async(t["rs"], name="rs.sum")
    out["rs_sum"] = h.synchronize().numpy()
    out["rs_sizes"] = h.recv_sizes
    out["rs_avg"] = hvd.reducescatter(t["rs"], name="rs.avg",
                                      op=hvd.Average).numpy()
    x, y = adasum_mlp_data(size)
    shard = shard_rows(rank, size, len(x))
    batch = (torch.from_numpy(x[shard]), torch.from_numpy(y[shard]))
    for kind in ("grad", "delta"):
        model = MLP(ADASUM_MLP_SIZES)
        model.load_state_dict(mlp_from_jax(adasum_mlp_params()))
        if kind == "grad":
            opt = hvd.DistributedOptimizer(torch.optim.SGD(
                model.parameters(), lr=ADASUM_SGD_LR), op=hvd.Adasum)
        else:
            opt = hvd.DistributedDeltaAdasumOptimizer(torch.optim.AdamW(
                model.parameters(), **ADASUM_ADAMW))
        traj = []
        for _ in range(ADASUM_STEPS):
            opt.zero_grad()
            mlp_loss(model, batch).backward()
            opt.step()
            traj.append({n: p.detach().numpy().copy()
                         for n, p in model.named_parameters()})
        out[kind] = traj
    return out


ADASUM_CARD_STEPS = 3
ADASUM_CARD_DIMS = dict(vocab_size=32768, d_model=2048, n_heads=16,
                        n_layers=4, d_ff=8192, max_seq=2048)  # flagship LM
ADASUM_CPU_DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, max_seq=16)


def _adasum_cards_scenario(hvd, rank: int, size: int) -> dict:
    """Three AdamW steps of the bf16 LM (the flagship on the card, a tiny
    one on the CPU rehearsal), one sequence a rank, through
    DistributedOptimizer(op=Adasum) and DistributedDeltaAdasumOptimizer.
    After the first grad-Adasum step every reduced gradient is held against
    ``adasum_stacked`` of the gathered per-rank gradients. Returns the
    losses, a digest of the parameters (ranks must agree bitwise), K4/K5
    launches, step times and the time of one Adasum reduction of the
    gradients."""
    import hashlib
    import time
    import torch
    from horovod_tpu_torch.core.state import engine
    from horovod_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, lean_lm_loss)
    from horovod_tpu_torch.ops import adasum as A, kernels as K
    dev = hvd.device()
    if dev.type == "cpu":
        torch.set_num_threads(1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    dims = ADASUM_CARD_DIMS if dev.type == "cuda" else ADASUM_CPU_DIMS
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="flash", **dims)
    local = A.hierarchical_local_size(engine())
    tokens = np.random.RandomState(14).randint(
        0, cfg.vocab_size, size=(size, cfg.max_seq + 1))
    x = torch.from_numpy(tokens[rank:rank + 1, :-1]).to(dev)
    y = torch.from_numpy(tokens[rank:rank + 1, 1:]).to(dev)
    out = {"local_size": local, "tokens_per_step": cfg.max_seq}
    names = ("adasum_triple", "adasum_scale")
    for kind in ("grad", "delta"):
        model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
        model.to(dev)
        params = list(model.parameters())
        inner = torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=1e-4)
        opt = (hvd.DistributedOptimizer(inner, op=hvd.Adasum)
               if kind == "grad" else
               hvd.DistributedDeltaAdasumOptimizer(inner))
        res = {"losses": [], "step_s": [], "launches": dict.fromkeys(names, 0)}
        for step in range(ADASUM_CARD_STEPS):
            sync()
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = lean_lm_loss(model, x, y)
            loss.backward()
            check = kind == "grad" and step == 0
            if check:
                local_grads = [p.grad.detach().clone() for p in params]
            n0 = K.launch_counts()
            opt.step()
            n1 = K.launch_counts()
            sync()
            res["step_s"].append(time.perf_counter() - t0)
            res["losses"].append(float(loss.detach()))
            for k in names:
                res["launches"][k] += n1[k] - n0[k]
            if check:
                # the reduced gradients (p.grad after the step) against the
                # one-process schedule on the gathered local gradients
                res["rel_err"] = []
                for i, (g, p) in enumerate(zip(local_grads, params)):
                    want = A.adasum_stacked(
                        hvd.allgather(g[None], name=f"check.{i}"),
                        local_size=local)
                    res["rel_err"].append(float(
                        (p.grad - want).abs().max()
                        / want.abs().max().clamp_min(1e-30)))
                del local_grads, want
        if kind == "grad":
            grads = [p.grad for p in params]
            times = []
            for rep in range(3):
                sync()
                t0 = time.perf_counter()
                hvd.grouped_allreduce(grads, name=f"time.{rep}",
                                      op=hvd.Adasum)
                sync()
                times.append(time.perf_counter() - t0)
            res["adasum_s"] = sorted(times)[1]
            del grads
        digest = hashlib.sha256()
        for p in params:
            digest.update(p.detach().cpu().numpy().tobytes())
        res["digest"] = digest.hexdigest()
        out[kind] = res
        del model, params, inner, opt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# -- SyncBatchNorm, alltoall, allreduce_sparse, join -------------------------

SYNC_BN_EPS = 1e-5
SYNC_BN_DTYPES = ("float32", "bfloat16", "float16")
SYNC_BN_CHANNELS = (3, 12, 64)
# "nhwc": an (8, 3, 3, C) batch, N split evenly; "ragged": a (24, C) batch
# whose ranks hold these row counts (at np=4 one rank holds none)
SYNC_BN_LAYOUTS = ("nhwc", "ragged")
SYNC_BN_RAGGED = {1: [24], 2: [5, 19], 4: [0, 4, 8, 12]}


def sync_bn_case(dtype: str, c: int, layout: str) -> dict:
    """The global batch, cotangent, parameters and running statistics of
    one SyncBatchNorm case, as float32 numpy (x and dy hold values of
    ``dtype``: rounded through torch)."""
    import torch
    seed = 1000 + 10 * SYNC_BN_CHANNELS.index(c) \
        + SYNC_BN_LAYOUTS.index(layout)
    rng = np.random.RandomState(seed)
    shape = (8, 3, 3, c) if layout == "nhwc" else (24, c)

    def rounded(a):
        t = torch.from_numpy(a.astype(np.float32))
        return t.to(getattr(torch, dtype)).float().numpy()

    return {"x": rounded(rng.randn(*shape) * 2 + 0.5),
            "dy": rounded(rng.randn(*shape)),
            "scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
            "bias": (0.1 * rng.randn(c)).astype(np.float32),
            "mean": rng.randn(c).astype(np.float32),
            "var": (1 + rng.rand(c)).astype(np.float32)}


def sync_bn_rows(layout: str, rank: int, size: int) -> slice:
    """The rows of dim 0 of a case's global batch that ``rank`` holds."""
    if layout == "nhwc":
        return shard_rows(rank, size, 8)
    counts = SYNC_BN_RAGGED[size]
    start = sum(counts[:rank])
    return slice(start, start + counts[rank])


def sync_bn_run(rank: int, size: int, dtype: str, c: int, layout: str,
                device="cpu") -> dict:
    """One rank's SyncBatchNorm training step on its rows of a case on
    ``device``, a second forward, then eval mode: outputs as float32 numpy
    in the reference's layout (channels last)."""
    import torch
    from horovod_tpu_torch.models.convert import sync_batch_norm_from_flax
    from horovod_tpu_torch.ops.sync_batch_norm import (SyncBatchNorm,
                                                       sync_batch_stats)
    case = sync_bn_case(dtype, c, layout)
    rows = sync_bn_rows(layout, rank, size)
    tdtype = getattr(torch, dtype)

    def to_port(a):
        t = torch.from_numpy(np.ascontiguousarray(a[rows])).to(device,
                                                                 tdtype)
        return t.permute(0, 3, 1, 2) if t.dim() == 4 else t

    def to_ref(t):
        t = t.detach().float().cpu()
        return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()

    mod = SyncBatchNorm(c, momentum=0.9, eps=SYNC_BN_EPS, device=device)
    mod.load_state_dict(sync_batch_norm_from_flax(
        {"params": {k: case[k] for k in ("scale", "bias")},
         "batch_stats": {k: case[k] for k in ("mean", "var")}}))
    x = to_port(case["x"]).requires_grad_()
    y = mod(x)
    y.backward(to_port(case["dy"]))
    out = {"y": to_ref(y), "dx": to_ref(x.grad),
           "dscale": mod.weight.grad.cpu().numpy(),
           "dbias": mod.bias.grad.cpu().numpy(),
           "mean1": mod.running_mean.cpu().numpy().copy(),
           "var1": mod.running_var.cpu().numpy().copy(),
           "stats": [s.cpu().numpy() for s in sync_batch_stats(x.detach())]}
    with torch.no_grad():
        mod(x)
    out["mean2"] = mod.running_mean.cpu().numpy().copy()
    out["var2"] = mod.running_var.cpu().numpy().copy()
    mod.eval()
    with torch.no_grad():
        out["y_eval"] = to_ref(mod(x))
    return out


def _sync_bn_scenario(hvd, rank: int, size: int) -> dict:
    import torch
    torch.set_num_threads(1)
    return {(dtype, c, layout): sync_bn_run(rank, size, dtype, c, layout,
                                            hvd.device())
            for dtype in SYNC_BN_DTYPES for c in SYNC_BN_CHANNELS
            for layout in SYNC_BN_LAYOUTS}


def alltoall_input(rank: int, size: int):
    """A rank's (tensor, splits) of the seeded uneven alltoall: 0-3 rows to
    each rank, rows of 3 float32."""
    rng = np.random.RandomState(40 + rank)
    splits = rng.randint(0, 4, size=size)
    return (rng.randn(int(splits.sum()), 3).astype(np.float32),
            splits.tolist())


def sparse_input(rank: int):
    """A rank's (indices, values) of the seeded sparse allreduce over 10
    rows: 4 rows, duplicates allowed."""
    rng = np.random.RandomState(60 + rank)
    return (rng.randint(0, 10, size=4),
            rng.randn(4, 2).astype(np.float32))


def _collectives_scenario(hvd, rank: int, size: int) -> dict:
    """alltoall even, uneven and seeded-uneven, its two ValueError paths,
    and allreduce_sparse against the dense allreduce."""
    import torch
    out = {}
    x = torch.stack([torch.full((2,), float(100 * rank + d))
                     for d in range(size)])
    out["even"] = hvd.alltoall(x, name="at").cpu().numpy()
    xs = torch.full(((rank + 1) * size, 1), float(rank))
    recv, counts = hvd.alltoall(xs, splits=[rank + 1] * size, name="atv")
    out["recv_counts"] = counts.tolist()
    out["recv_rows"] = int(recv.shape[0])
    t, splits = alltoall_input(rank, size)
    h = hvd.alltoall_async(torch.from_numpy(t), splits=splits, name="atr")
    recv, counts = hvd.synchronize(h)
    out["random"], out["random_counts"] = recv.cpu().numpy(), counts.tolist()
    errors = []
    for bad in (dict(tensor=torch.ones(size + 1, 2)),
                dict(tensor=torch.ones(3, 2), splits=[1] * size)):
        try:
            hvd.alltoall(name="bad", **bad)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    idx, val = sparse_input(rank)
    out["sparse_sum"] = [a.cpu().numpy() for a in hvd.allreduce_sparse(
        idx, val, n_rows=10, name="sp.sum", average=False)]
    out["sparse_avg"] = [a.cpu().numpy() for a in hvd.allreduce_sparse(
        idx, val, n_rows=10, name="sp.avg")]
    dense = torch.zeros(10, 2).index_add_(0, torch.from_numpy(idx),
                                          torch.from_numpy(val))
    out["dense"] = hvd.allreduce(dense, name="sp.dense",
                                 op=hvd.Sum).cpu().numpy()
    # tests/test_multiprocess.py's case
    idx = np.array([1, 3]) if rank == 0 else np.array([3, 5])
    out["sparse_ref"] = [a.cpu().numpy() for a in hvd.allreduce_sparse(
        idx, np.full((2, 2), float(rank + 1), np.float32), n_rows=8,
        name="sp.ref", average=False)]
    return out


JOIN_TENSORS = 24      # a grouped call past the 16 inline metadata slots


def join_adasum_inputs(rank: int) -> list:
    """A rank's two tensors of the join scenario's Adasum reductions."""
    rng = np.random.RandomState(80 + rank)
    return [rng.randn(6).astype(np.float32) for _ in range(2)]


def _join_optimizer(hvd, rank: int, size: int, steps: int) -> list:
    """``steps`` SGD-momentum steps of the optimizer scenario's MLP on this
    rank's shard through DistributedOptimizer(op=Average); the weights
    after each step."""
    dev = hvd.device()
    import torch
    data_x, data_y = mlp_data()
    w1, w2 = mlp_params()
    model = torch.nn.Sequential(torch.nn.Linear(4, 8, bias=False),
                                torch.nn.Tanh(),
                                torch.nn.Linear(8, 2, bias=False))
    with torch.no_grad():
        model[0].weight.copy_(torch.from_numpy(w1.T))
        model[2].weight.copy_(torch.from_numpy(w2.T))
    model.to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        op=hvd.Average)
    shard = shard_rows(rank, size, len(data_x))
    xs = torch.from_numpy(data_x[shard]).to(dev)
    ys = torch.from_numpy(data_y[shard]).to(dev)
    traj = []
    for _ in range(steps):
        opt.zero_grad()
        ((model(xs) - ys) ** 2).mean().backward()
        opt.step()
        traj.append([model[0].weight.detach().cpu().numpy().T.copy(),
                     model[2].weight.detach().cpu().numpy().T.copy()])
    return traj


def _join_scenario(hvd, rank: int, size: int) -> dict:
    """At np=2 the join cases of the reference's tests/test_join.py, one
    after another in one world (rank 0 runs out of data first), plus
    alltoall, Adasum and DistributedOptimizer under join, the overflow
    exchange and HOROVOD_JOIN_DISABLE. At np=4 the reference's round test
    (rank r runs r + 1 allreduces, then joins)."""
    import torch
    from horovod_tpu_torch.core.state import global_state
    out = {}
    if size == 4:
        sums = [float(hvd.allreduce(torch.ones(3) * (rank + 1), name=f"j{k}",
                                    op=hvd.Sum)[0]) for k in range(rank + 1)]
        return {"sums": sums, "last": hvd.join()}
    # ragged allreduce: 3 batches against 6
    res = [float(hvd.allreduce(torch.ones(4) * (rank + 1), name=f"b{b}",
                               op=hvd.Sum)[0])
           for b in range(3 if rank == 0 else 6)]
    out["ragged"] = (res, hvd.join())
    # ragged grouped: 2 batches against 4
    sums = []
    for b in range(2 if rank == 0 else 4):
        outs = hvd.grouped_allreduce(
            [torch.ones(3) * (rank + 1), torch.ones(2, 2) * (rank + 1)],
            name=f"g{b}", op=hvd.Sum)
        sums.append([float(o.reshape(-1)[0]) for o in outs])
    out["grouped"] = (sums, hvd.join())
    # mixed ops after rank 0 joined
    if rank == 0:
        out["mixed"] = {"last": hvd.join()}
    else:
        mixed = {"bcast": float(hvd.broadcast(torch.full((3,), 7.0), 1,
                                              name="bc")[0])}
        mixed["gather_rows"] = int(hvd.allgather(torch.ones(2, 2),
                                                 name="ag").shape[0])
        mixed["rs"] = float(hvd.reducescatter(torch.ones(4, 2),
                                              name="rs")[0, 0])
        recv, counts = hvd.alltoall(torch.arange(1.0, 4.0)[:, None],
                                    splits=[1, 2], name="a2a")
        mixed["alltoall"] = (recv.reshape(-1).tolist(), counts.tolist())
        mixed["last"] = hvd.join()
        out["mixed"] = mixed
    # a broadcast from a joined root raises on both ranks
    try:
        if rank == 0:
            hvd.join()
        else:
            hvd.broadcast(torch.ones(3), root_rank=0, name="bad")
        out["dead_root"] = "no-error"
    except hvd.HorovodInternalError as e:
        out["dead_root"] = str(e)
    # 24 tensors a grouped call: the metadata overflow exchange
    sums = []
    for b in range(2 if rank == 0 else 4):
        outs = hvd.grouped_allreduce(
            [torch.ones(2, i + 1) * (rank + 1) for i in range(JOIN_TENSORS)],
            name=f"ov{b}", op=hvd.Sum)
        sums.append([float(o.reshape(-1)[0]) for o in outs])
    out["overflow"] = (sums, hvd.join())
    # Adasum: 1 reduction against 2
    xs = join_adasum_inputs(rank)
    out["adasum"] = ([hvd.allreduce(torch.from_numpy(x), name=f"ad{i}",
                                    op=hvd.Adasum).cpu().numpy()
                      for i, x in enumerate(xs[:1 if rank == 0 else 2])],
                     hvd.join())
    # DistributedOptimizer: 1 step against 3, the joined rank's zeros in
    # the Average
    out["optimizer"] = (_join_optimizer(hvd, rank, size,
                                        1 if rank == 0 else 3), hvd.join())
    # the active ranks' round issues no host read of a device value
    dev = hvd.device()
    ones = torch.ones(5, device=dev)
    reads = []
    names = ("item", "tolist", "cpu", "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def counting(n):
        def f(self, *a, **k):
            reads.append(n)
            return saved[n](self, *a, **k)
        return f

    for n in names:
        setattr(torch.Tensor, n, counting(n))
    try:
        h = hvd.allreduce_async(ones, name="noread")
    finally:
        for n in names:
            setattr(torch.Tensor, n, saved[n])
    h.synchronize()
    out["reads"] = reads
    if dev.type == "cuda":
        # nor does it wait on the card: issued behind a second of device
        # sleep, it returns while the sleep runs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(2_000_000_000)
        torch.cuda.set_sync_debug_mode("error")
        try:
            h = hvd.allreduce_async(ones, name="nowait")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        issue_s = time.perf_counter() - t0
        h.synchronize()
        torch.cuda.synchronize()
        out["wait"] = (issue_s, time.perf_counter() - t0)
    # HOROVOD_JOIN_DISABLE: join is a barrier and returns size - 1
    cfg = global_state().config
    cfg.join_enabled = False
    out["disabled"] = hvd.join()
    cfg.join_enabled = True
    return out


REPLAY_STEPS = 6        # DistributedOptimizer steps of the replay scenario
REPLAY_EXTRA = 3        # steps the active ranks replay after rank 0 joined


def replay_leaf(rank: int, i: int) -> np.ndarray:
    """Rank ``rank``'s i-th tensor of the replay scenario's per-leaf
    stream."""
    return np.random.RandomState(90 + 7 * rank + i).randn(3 + i, 2) \
        .astype(np.float32)


def _replay_scenario(hvd, rank: int, size: int) -> dict:
    """Step replay at size > 1: DistributedOptimizer's trajectory with
    replay on, off and off again (REPLAY_STEPS steps each from the same
    start); a per-leaf allreduce stream that arms and replays; rank 0
    joining after the warm-up while the others replay REPLAY_EXTRA steps of
    a grouped Sum of JOIN_TENSORS tensors (the advertisement's overflow
    rows included); and on the card a profile of one replayed step."""
    import torch
    from horovod_tpu_torch.core.state import global_state
    eng = global_state().engine
    cfg = global_state().config
    dev = hvd.device()
    out = {}
    for mode in ("on", "off", "off2"):
        cfg.step_replay = mode == "on"
        traj, _, counters = _mlp_trajectory(hvd, rank, size, REPLAY_STEPS)
        out[mode] = {"traj": traj, "replay": counters}
    cfg.step_replay = True
    warm = cfg.step_replay_warmup
    # per-leaf allreduce_async calls, fused by the armed program
    before = _replay_counters(hvd)
    leaves = [torch.from_numpy(replay_leaf(rank, i)).to(dev)
              for i in range(3)]
    sums = []
    for step in range(warm + 2):
        with hvd.step():
            hs = [hvd.allreduce_async(x, name=f"leaf.{step}.{i}", op=hvd.Sum)
                  for i, x in enumerate(leaves)]
        sums.append([h.synchronize().cpu().numpy() for h in hs])
    out["leaf"] = {"sums": sums, "replay": tuple(
        a - b for a, b in zip(_replay_counters(hvd), before))}
    eng.replay.invalidate_all("next case")
    # rank 0 joins after the warm-up; the others replay against its
    # substitutes
    before = _replay_counters(hvd)
    ts = [torch.full((2, i + 1), float(rank + 1), device=dev)
          for i in range(JOIN_TENSORS)]
    sums = []
    for step in range(warm + (0 if rank == 0 else REPLAY_EXTRA)):
        with hvd.step():
            hs = hvd.grouped_allreduce_async(ts, name=f"ej.{step}",
                                             op=hvd.Sum)
        sums.append([float(h.synchronize().reshape(-1)[0]) for h in hs])
    counters = tuple(a - b for a, b in zip(_replay_counters(hvd), before))
    out["early_join"] = {"sums": sums, "replay": counters,
                         "last": hvd.join()}
    if dev.type == "cuda":
        out["trace"] = _replay_trace(hvd, torch, ts, warm)
    return out


def trace_events(fn, ok, tries: int = 6):
    """(host events, device operations) by name of one ``fn()`` on the card:
    the active step of a torch.profiler schedule whose warm-up step runs
    ``fn()`` too, each padded with 20 ms of idle host time, traced again
    (at most ``tries`` times) while ``ok(host, device)`` is false. A trace
    started cold, or a short step's, can lose kernel events that ran
    (PERF.md)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    cpu = torch.autograd.DeviceType.CPU
    seen = {}

    def read(prof):
        events = prof.events()
        seen["host"] = [e.name for e in events if e.device_type == cpu]
        # the schedule's step annotation spans the step on the device too
        seen["device"] = [e.name for e in events if e.device_type != cpu
                          and not e.name.startswith("ProfilerStep")]

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=read) as prof:
            for _ in range(2):
                time.sleep(0.02)
                fn()
                torch.cuda.synchronize()
                time.sleep(0.02)
                prof.step()
        if ok(seen["host"], seen["device"]):
            break
    return seen["host"], seen["device"]


def _replay_trace(hvd, torch, ts, warm: int) -> dict:
    """Trace one replayed grouped Sum: the host's events and the device
    operations (the graph's among them)."""
    from horovod_tpu_torch.core.engine import bucket_by_size
    names = iter(range(1 << 20))

    def step():
        with hvd.step():
            hs = hvd.grouped_allreduce_async(ts, name=f"tr.{next(names)}",
                                             op=hvd.Sum)
        [h.synchronize() for h in hs]

    for _ in range(warm + 1):
        step()
    n_buckets = len(bucket_by_size(
        ts, hvd.global_state().config.fusion_threshold_bytes))
    host, device = trace_events(
        step, lambda h, d: sum("pack_kernel" in k for k in d) == n_buckets)
    return {"host": host, "device": device, "replay": _replay_counters(hvd)}


RESNET_CARD_STEPS = 10         # steps in each timed window
# the join round on, off, off, on, ... (a window each; ranks flip together)
RESNET_CARD_MODES = (True, False, False, True) * 2


def _resnet_cards_scenario(hvd, rank: int, size: int) -> dict:
    """ResNet-50 (bf16, FusedBatchNorm, batch 64 a rank, SGD momentum
    through DistributedOptimizer(op=Average)) on the card; a tiny ResNet
    at batch 2 on the CPU rehearsal. After 3 warm-up steps, windows of
    RESNET_CARD_STEPS steps (2 on the CPU) with the join round on and off
    in turns (every rank flips at the same step): each window's img/s on
    this rank."""
    import torch
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models.resnet import ResNet18ish, ResNet50
    dev = hvd.device()
    cuda = dev.type == "cuda"
    if not cuda:
        torch.set_num_threads(1)     # the ranks share the cores
    batch, image = (64, 224) if cuda else (2, 32)
    model = (ResNet50 if cuda else ResNet18ish)(
        num_classes=1000, dtype=torch.bfloat16, fused_bn=True,
        generator=torch.Generator().manual_seed(0)).to(dev)
    gen = torch.Generator().manual_seed(rank)
    images = torch.rand(batch, image, image, 3, generator=gen).to(dev)
    labels = torch.randint(0, 1000, (batch,), generator=gen).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        op=hvd.Average)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = global_state().config

    def step():
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [float(step()) for _ in range(3)]
    steps = RESNET_CARD_STEPS if cuda else 2
    windows = []
    for join_on in RESNET_CARD_MODES:
        cfg.join_enabled = join_on
        sync()
        t0 = time.perf_counter()
        timed = [step() for _ in range(steps)]
        sync()
        windows.append((join_on, batch * steps
                        / (time.perf_counter() - t0)))
        losses += [float(v) for v in timed]
    cfg.join_enabled = True
    return {"windows": windows, "losses": losses, "batch": batch}


SHARDED_SIZES = (5, 7, 3)       # the MLP of the ``sharded`` scenario
SHARDED_ROWS = 8                 # its batch, split over the data replicas
SHARDED_STEPS = 5
# at 256 bytes the buckets are [w1, b1, w2] (63 floats) and [b2] (3): no
# total divides 2 or 4, and at 4 ranks the last rank's shard of [b2] is
# all padding
SHARDED_THRESHOLD = 256
SHARDED_OPTS = {"sgd_momentum": ("SGD", dict(lr=0.05, momentum=0.9)),
                "adam": ("Adam", dict(lr=1e-2))}
SHARDED_GROUP_LRS = (0.05, 0.01)  # the two param groups' case, SGD momentum
SHARDED_JOIN_STEPS = 4           # rank 0's steps before it joins


def sharded_params() -> list:
    """The MLP's starting weights: w1 (5, 7), b1, w2 (7, 3), b2, (in, out)
    like a flax Dense kernel."""
    rng = np.random.RandomState(21)
    d0, d1, d2 = SHARDED_SIZES
    return [0.5 * rng.randn(d0, d1).astype(np.float32),
            0.1 * rng.randn(d1).astype(np.float32),
            0.5 * rng.randn(d1, d2).astype(np.float32),
            0.1 * rng.randn(d2).astype(np.float32)]


def sharded_data():
    rng = np.random.RandomState(22)
    return (rng.randn(SHARDED_ROWS, SHARDED_SIZES[0]).astype(np.float32),
            rng.randn(SHARDED_ROWS, SHARDED_SIZES[2]).astype(np.float32))


def sharded_model(device):
    """The MLP with the seeded weights; its parameters in the order of
    :func:`sharded_params`."""
    import torch
    d0, d1, d2 = SHARDED_SIZES
    model = torch.nn.Sequential(torch.nn.Linear(d0, d1), torch.nn.Tanh(),
                                torch.nn.Linear(d1, d2))
    w1, b1, w2, b2 = sharded_params()
    with torch.no_grad():
        for p, v in zip(model.parameters(), (w1.T, b1, w2.T, b2)):
            p.copy_(torch.from_numpy(np.ascontiguousarray(v)))
    return model.to(device)


def sharded_weights(model) -> list:
    """The parameters as numpy, in :func:`sharded_params`' layout."""
    w1, b1, w2, b2 = (p.detach().cpu().numpy() for p in model.parameters())
    return [w1.T.copy(), b1.copy(), w2.T.copy(), b2.copy()]


def _sharded_run(hvd, rows, steps, make_opt, groups=None):
    """``steps`` steps of the MLP on ``rows`` through ``make_opt(params)``
    (a list of param-group dicts when ``groups`` gives their lrs): the
    weights after each step, the engine dispatches each step took, and the
    optimizer."""
    import torch
    from horovod_tpu_torch.core.state import global_state
    eng = global_state().engine
    model = sharded_model(hvd.device())
    ps = list(model.parameters())
    opt = make_opt([{"params": ps[:2], "lr": groups[0]},
                    {"params": ps[2:], "lr": groups[1]}]
                   if groups else ps)
    x, y = (torch.from_numpy(a[rows]).to(hvd.device())
            for a in sharded_data())
    traj, dispatches = [], []
    for _ in range(steps):
        opt.zero_grad()
        ((model(x) - y) ** 2).mean().backward()
        d0 = eng.dispatch_count
        opt.step()
        dispatches.append(eng.dispatch_count - d0)
        traj.append(sharded_weights(model))
    return traj, dispatches, opt


def _sharded_scenario(hvd, rank: int, size: int) -> dict:
    """ZeRO-1 at ``size`` ranks: DistributedOptimizer(sharded=True) with
    SGD momentum and Adam against the dense one (replay on, and off),
    backward_passes_per_step=2, two param groups of different lr, the
    shard layout and state, hvd.distributed dense and sharded over the
    world and (4 ranks) over the data axis of a {"data": 2, "seq": 2}
    mesh, and rank 0 joining against the others' sharded step."""
    import torch
    from horovod_tpu_torch.core.state import global_state
    torch.set_num_threads(1)
    cfg = global_state().config
    rep = global_state().engine.replay
    cfg.fusion_threshold_bytes = SHARDED_THRESHOLD
    # ZeRO-1's reduce-scatter is always the flat ring (shard ownership):
    # the dense runs it is held to bitwise take the flat ring too, where
    # auto would take the tree for these small buckets at 4 ranks
    cfg.collective_algo = "flat"
    rows = shard_rows(rank, size, SHARDED_ROWS)
    out = {}

    def make(kind, **kw):
        cls, args = SHARDED_OPTS[kind]
        return lambda ps: hvd.DistributedOptimizer(
            getattr(torch.optim, cls)(ps, **args), op=hvd.Average, **kw)

    def counters():
        return (rep.captured_streams, rep.replayed_steps, rep.fallbacks)

    for kind in SHARDED_OPTS:
        res = {}
        res["dense"], _, dense = _sharded_run(hvd, rows, SHARDED_STEPS,
                                              make(kind))
        rep.invalidate_all("next run")
        before = counters()
        res["sharded"], res["dispatches"], opt = _sharded_run(
            hvd, rows, SHARDED_STEPS, make(kind, sharded=True))
        res["replay"] = tuple(a - b for a, b in zip(counters(), before))
        res["layout"] = [(b.total, b.shard, b.padded)
                         for b in opt._zero.buckets]
        res["state_shapes"] = sorted(
            tuple(v.shape) for st in opt._zero.optimizer.state.values()
            for v in st.values() if v.dim())
        res["state_bytes"] = opt._zero.state_bytes()
        res["dense_state_bytes"] = sum(
            v.nbytes for st in dense.optimizer.state.values()
            for v in st.values() if torch.is_tensor(v))
        rep.invalidate_all("next run")
        cfg.step_replay = False
        res["sharded_off"], res["dispatches_off"], _ = _sharded_run(
            hvd, rows, SHARDED_STEPS, make(kind, sharded=True))
        cfg.step_replay = True
        out[kind] = res
    # k = 2 local passes a step, summed
    sgd = lambda **kw: lambda ps: hvd.DistributedOptimizer(  # noqa: E731
        torch.optim.SGD(ps, lr=0.1), backward_passes_per_step=2, **kw)
    out["accum"] = {"dense": _sharded_run(hvd, rows, 4, sgd())[0],
                    "sharded": _sharded_run(hvd, rows, 4,
                                            sgd(sharded=True))[0]}
    rep.invalidate_all("next run")
    out["groups"] = {
        "dense": _sharded_run(hvd, rows, SHARDED_STEPS, make("sgd_momentum"),
                              SHARDED_GROUP_LRS)[0],
        "sharded": _sharded_run(hvd, rows, SHARDED_STEPS,
                                make("sgd_momentum", sharded=True),
                                SHARDED_GROUP_LRS)[0]}
    rep.invalidate_all("next run")
    # hvd.distributed over the world
    adam = SHARDED_OPTS["adam"][1]
    for key, kw in (("world", {}), ("world_sharded",
                                    {"shard_optimizer": True})):
        out[key] = _sharded_run(
            hvd, rows, SHARDED_STEPS, lambda ps, kw=kw: hvd.distributed(
                torch.optim.Adam(ps, **adam),
                fusion_threshold_bytes=SHARDED_THRESHOLD, **kw))[0]
    if size == 4:
        from horovod_tpu_torch.parallel.mesh import training_mesh
        mesh = training_mesh({"data": 2, "seq": 2})
        data_rows = shard_rows(mesh.index["data"], 2, SHARDED_ROWS)
        for key, kw in (("mesh", {}), ("mesh_sharded",
                                       {"shard_optimizer": True})):
            out[key] = _sharded_run(
                hvd, data_rows, SHARDED_STEPS,
                lambda ps, kw=kw: hvd.distributed(
                    torch.optim.Adam(ps, **adam), axis_name="data",
                    mesh=mesh, fusion_threshold_bytes=SHARDED_THRESHOLD,
                    **kw))[0]
        out["data_index"] = mesh.index["data"]
    if size > 1:
        # rank 0 joins after SHARDED_JOIN_STEPS sharded steps (the last
        # replayed); the others' next step meets it: every rank raises
        errors = []
        try:
            _sharded_run(hvd, rows, SHARDED_JOIN_STEPS + (rank > 0),
                         make("sgd_momentum", sharded=True))
            hvd.join()
        except hvd.HorovodInternalError as e:
            errors.append(str(e))
        # and the world goes on
        out["join"] = {"errors": errors, "after": float(hvd.allreduce(
            torch.ones(1, device=hvd.device()), name="after.join",
            op=hvd.Sum))}
    return out


SHARDED_CARD_STEPS = 5          # replay's warm-up (3) + 2 replayed steps


def _sharded_cards_scenario(hvd, rank: int, size: int) -> dict:
    """The bf16 LM with fp32 parameters (the flagship on the card, a tiny
    one on the CPU rehearsal), one sequence a rank, SHARDED_CARD_STEPS
    AdamW steps through the dense DistributedOptimizer and then through
    DistributedOptimizer(sharded=True) from the same seed, at the default
    64 MB fusion threshold. Returns the losses, a digest of each run's
    parameters (ranks must agree bitwise), the largest difference between
    the two runs' parameters beside the largest entry, each run's
    optimizer-state bytes on this rank, the buckets, the replay counters,
    and on the card a trace of one replayed sharded step."""
    import hashlib
    import torch
    from horovod_tpu_torch.common.env import DEFAULT_FUSION_THRESHOLD_BYTES
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, lean_lm_loss)
    dev = hvd.device()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    cfg = global_state().config
    cfg.fusion_threshold_bytes = DEFAULT_FUSION_THRESHOLD_BYTES
    rep = global_state().engine.replay
    dims = ADASUM_CARD_DIMS if dev.type == "cuda" else ADASUM_CPU_DIMS
    lm = TransformerConfig(dtype=torch.bfloat16, attention="flash", **dims)
    tokens = np.random.RandomState(15).randint(
        0, lm.vocab_size, size=(size, lm.max_seq + 1))
    x = torch.from_numpy(tokens[rank:rank + 1, :-1]).to(dev)
    y = torch.from_numpy(tokens[rank:rank + 1, 1:]).to(dev)
    out, finals = {}, {}
    for kind in ("dense", "sharded"):
        model = Transformer(lm, generator=torch.Generator().manual_seed(0))
        model.to(dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=3e-4,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4),
            op=hvd.Average, sharded=kind == "sharded")
        before = (rep.captured_streams, rep.replayed_steps, rep.fallbacks)

        def step():
            opt.zero_grad()
            loss = lean_lm_loss(model, x, y)
            loss.backward()
            opt.step()
            return float(loss.detach())

        res = {"losses": [step() for _ in range(SHARDED_CARD_STEPS)]}
        res["replay"] = tuple(a - b for a, b in zip(
            (rep.captured_streams, rep.replayed_steps, rep.fallbacks),
            before))
        digest = hashlib.sha256()
        for p in model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        res["digest"] = digest.hexdigest()
        inner = opt._zero.optimizer if kind == "sharded" else opt.optimizer
        res["state_bytes"] = sum(
            v.nbytes for st in inner.state.values() for v in st.values()
            if torch.is_tensor(v))
        if kind == "sharded":
            res["buckets"] = [(b.total, b.shard, b.padded)
                              for b in opt._zero.buckets]
            with torch.no_grad():
                diffs = [float((p - q).abs().max()) for p, q in
                         zip(model.parameters(), finals["dense"])]
                res["max_diff"] = max(diffs)
                res["max_entry"] = max(float(q.abs().max())
                                       for q in finals["dense"])
                res["bitwise"] = all(torch.equal(p, q) for p, q in zip(
                    model.parameters(), finals["dense"]))
            if dev.type == "cuda":
                # replayed optimizer steps on the last gradients: they
                # move the parameters, so they come after the comparison
                n = len(opt._zero.buckets)
                host, device = trace_events(
                    opt.step, lambda h, d: sum(
                        "pack_kernel" in k for k in d) == n)
                res["trace"] = {"host": host, "device": device}
        finals[kind] = [p.detach().clone() for p in model.parameters()]
        out[kind] = res
        rep.invalidate_all("next run")
        del model, opt, inner
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# the wire codecs' worlds (tests/test_torch_compression.py)
CODEC_NAMES = ("int8", "fp8", "bf16")
CODEC_OPS = ("SUM", "AVERAGE")
CODEC_TOTALS = (7, 1001)        # buckets that divide neither 2 nor 4
CODEC_STEPS = 5                 # steps a residual is carried across
CODEC_OPT_STEPS = 5             # replay's warm-up (3) + 2 replayed steps
CODEC_SGD_LR = 0.1
CODEC_CLOSE_STEPS = 12          # the reference's int8-trains-close case
CODEC_CLOSE_LR = 0.05
CODEC_CLOSE_DIM = 16


def codec_input(rank: int, step: int, total: int) -> np.ndarray:
    """Rank ``rank``'s float32 bucket of ``total`` elements at ``step``."""
    rng = np.random.RandomState(1000 * rank + 100 * step + total % 97)
    return rng.randn(total).astype(np.float32)


def codec_close_data(size: int) -> np.ndarray:
    """(size, 16): each rank's row of the reference's 16-float problem."""
    return np.random.RandomState(3).randn(size, CODEC_CLOSE_DIM).astype(
        np.float32)


def _codec_run(hvd, rows, steps, make_opt, residuals=None):
    """``steps`` steps of the sharded scenario's MLP on ``rows`` through
    ``make_opt(params)``: the parameters before the first step, then per
    step this rank's gradients before the step and the parameters after it
    (torch's layout, as numpy), and ``residuals(opt)`` after it."""
    import torch
    model = sharded_model(hvd.device())
    params = list(model.parameters())
    opt = make_opt(params)
    x, y = (torch.from_numpy(a[rows]).to(hvd.device())
            for a in sharded_data())

    def numpy(ts):
        return [t.detach().cpu().numpy().copy() for t in ts]

    out = {"init": numpy(params), "grads": [], "traj": [], "residuals": []}
    for _ in range(steps):
        opt.zero_grad()
        ((model(x) - y) ** 2).mean().backward()
        out["grads"].append(numpy(p.grad for p in params))
        opt.step()
        out["traj"].append(numpy(params))
        if residuals is not None:
            out["residuals"].append(residuals(opt))
    return out


def engine_residuals(eng) -> dict:
    """The engine's error-feedback residuals by key, as numpy."""
    return {k: v["buf"].cpu().numpy().copy()
            for k, v in eng._residuals.items()}


def _codec_scenario(hvd, rank: int, size: int) -> dict:
    """The wire codecs at ``size`` ranks: the flat compressed reduction
    (``codec_allreduce``) of every codec, Sum and Average, buckets of 7
    and 1001 elements, a residual carried over CODEC_STEPS steps; the
    ZeRO-1 compressed reduce-scatter (``scatter_shards``); the engine's
    codec rules (the op rule, a non-float bucket, the knob) and a joined
    rank's substitute; DistributedOptimizer(compression=int8) with replay
    on and off, sharded=True with int8, hvd.distributed(compression=int8)
    on the MLP, and the reference's int8-trains-close problem."""
    import collections
    import torch
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import compression as comp
    torch.set_num_threads(1)
    eng = global_state().engine
    cfg = global_state().config
    rep = eng.replay
    cpu = torch.device("cpu")
    out = {"flat": {}, "rs": {}}
    for codec in CODEC_NAMES:
        ef = codec in comp.EF_CODECS
        for op in CODEC_OPS:
            avg = size if op == "AVERAGE" else 1
            for total in CODEC_TOTALS:
                padded = C.shard_spec(total, size)[0]
                res = torch.zeros(padded) if ef else None
                steps = []
                for step in range(CODEC_STEPS):
                    flat = C.padded_bucket(total, size, torch.float32, cpu)
                    C.pack_padded([torch.from_numpy(
                        codec_input(rank, step, total))], flat, True)
                    p, sc = C.codec_allreduce(flat, total, res, codec, size,
                                              rank, avg, 1.0, 1.0, None)
                    steps.append({
                        "out": flat[:total].numpy().copy(),
                        "payload": p.view(torch.uint8).numpy().copy(),
                        "scale": None if sc is None else sc.numpy().copy(),
                        "residual": None if res is None
                        else res.numpy().copy()})
                out["flat"][(codec, op, total)] = steps
                # the ZeRO-1 leg: one step of the compressed reduce-scatter
                b = C.ShardBucket((0,), (total,), torch.float32, cpu, size,
                                  rank)
                r0 = torch.zeros(b.padded) if ef else None
                C.scatter_shards([b], [torch.from_numpy(
                    codec_input(rank, 0, total))], True, avg, 1.0, 1.0,
                    None, True, (codec,), [r0])
                out["rs"][(codec, op, total)] = {
                    "shard": b.grad_shard.numpy().copy(),
                    "residual": None if r0 is None else r0.numpy().copy()}
    # the engine's rules
    out["call_codec"] = {op.name: eng._call_codec("int8", op)
                         for op in hvd.ReduceOp if op != hvd.Adasum}
    before = collections.Counter(eng.codec_selections)
    ints = torch.arange(6, dtype=torch.int32) * (rank + 1)
    hs = eng.grouped_allreduce(
        [ints, torch.from_numpy(codec_input(rank, 0, 33))],
        name="codec.mixed", op=hvd.Sum, codec="int8")
    out["mixed"] = [h.synchronize().numpy().copy() for h in hs]
    out["mixed_selections"] = dict(eng.codec_selections - before)
    cfg.compression = "int8"
    out["knob"] = hvd.allreduce(
        torch.from_numpy(codec_input(rank, 1, 1001)), name="codec.knob.7",
        op=hvd.Sum).numpy().copy()
    cfg.compression = "none"
    out["knob_residuals"] = engine_residuals(eng)
    out["plain"] = hvd.allreduce(
        torch.from_numpy(codec_input(rank, 1, 1001)), name="codec.plain",
        op=hvd.Sum).numpy().copy()
    # rank 0 joins; the others' compressed grouped call meets its
    # substitute, which runs the same compressed program
    before = collections.Counter(eng.codec_selections)
    values = None
    if rank > 0:
        hs = eng.grouped_allreduce(
            [torch.from_numpy(codec_input(rank, 2, 1001)),
             torch.from_numpy(codec_input(rank, 3, 7))],
            name="codec.join", op=hvd.Sum, codec="int8")
        values = [h.synchronize().numpy().copy() for h in hs]
    last = hvd.join()
    out["join"] = {"values": values, "last": last,
                   "selections": dict(eng.codec_selections - before),
                   "residuals_after": len(eng._residuals)}
    # the optimizers on the MLP
    cfg.fusion_threshold_bytes = SHARDED_THRESHOLD
    rows = shard_rows(rank, size, SHARDED_ROWS)

    def dense(**kw):
        return lambda ps: hvd.DistributedOptimizer(
            torch.optim.SGD(ps, lr=CODEC_SGD_LR), op=hvd.Average,
            compression=hvd.Compression.int8, **kw)

    def counters():
        return (rep.captured_streams, rep.replayed_steps, rep.fallbacks)

    runs = {}
    for key, make, replay in (("dense_on", dense(), True),
                              ("dense_off", dense(), False),
                              ("sharded", dense(sharded=True), True)):
        rep.invalidate_all("next run")
        cfg.step_replay = replay
        start = counters()
        runs[key] = _codec_run(hvd, rows, CODEC_OPT_STEPS, make,
                               lambda opt: engine_residuals(eng))
        runs[key]["replay"] = tuple(a - b for a, b in zip(counters(), start))
        if key == "dense_on":
            out["held"] = _held_residuals_case(eng, cfg)
    cfg.step_replay = True
    rep.invalidate_all("next run")
    runs["axis"] = _codec_run(
        hvd, rows, CODEC_OPT_STEPS, lambda ps: hvd.distributed(
            torch.optim.SGD(ps, lr=CODEC_SGD_LR),
            compression=hvd.Compression.int8),
        lambda opt: [r.numpy().copy() for r in opt.residuals])
    out["runs"] = runs
    # the reference's int8-trains-close problem (12 SGD steps at lr 0.05)
    data = torch.from_numpy(codec_close_data(size)[rank])
    close = {}
    for key, wrap, compression in (
            ("dense_none", "dense", hvd.Compression.none),
            ("dense_int8", "dense", hvd.Compression.int8),
            ("axis_none", "axis", hvd.Compression.none),
            ("axis_int8", "axis", hvd.Compression.int8)):
        rep.invalidate_all("next run")
        w = torch.nn.Parameter(torch.ones(CODEC_CLOSE_DIM))
        inner = torch.optim.SGD([w], lr=CODEC_CLOSE_LR)
        opt = (hvd.DistributedOptimizer(inner, compression=compression)
               if wrap == "dense" else
               hvd.distributed(inner, compression=compression))
        for _ in range(CODEC_CLOSE_STEPS):
            opt.zero_grad()
            ((w - data) ** 2).sum().backward()
            opt.step()
        res = (engine_residuals(eng) if wrap == "dense" else
               {0: opt.residuals[0].numpy().copy()}
               if opt.residuals else {})
        close[key] = {"w": w.detach().numpy().copy(),
                      "residual_max": max([float(np.abs(v).max())
                                           for v in res.values()] or [0.0])}
    out["close"] = close
    return out


def _held_residuals_case(eng, cfg) -> dict:
    """With an armed program holding residuals: a new key past
    ``cache_capacity`` evicts none of them, and an invalidation zeroes
    them in place and keeps them."""
    import torch
    held = eng.replay.held_residuals()
    bufs = {k: eng._residuals[k]["buf"] for k in held}
    nonzero = all(bool(b.abs().max() > 0) for b in bufs.values())
    cap = cfg.cache_capacity
    cfg.cache_capacity = 1
    try:
        extra = ("gar", "extra", 0, "int8", 8, "torch.float32")
        eng._residual_fetch(extra, 8, torch.float32)
        kept = all(eng._residuals[k]["buf"] is b for k, b in bufs.items())
        n_after_store = len(eng._residuals)
    finally:
        cfg.cache_capacity = cap
    eng.invalidate_residuals("test")
    return {"held": sorted(held), "nonzero": nonzero, "kept": kept,
            "entries_after_store": n_after_store,
            "zeroed_in_place": all(
                eng._residuals[k]["buf"] is b and not bool(b.any())
                for k, b in bufs.items()),
            "extra_dropped": extra not in eng._residuals}


CODEC_CARD_STEPS = 7            # replay's warm-up (3) + 4 replayed steps
# (run, compression, HOROVOD_TPU_COMPRESSION, sharded, step replay)
CODEC_CARD_RUNS = (("none", "none", "none", False, True),
                   ("int8", "int8", "none", False, True),
                   ("int8_eager", "int8", "none", False, False),
                   ("fp8", "fp8", "none", False, True),
                   ("bf16", "none", "bf16", False, True),
                   ("int8_sharded", "int8", "none", True, True))


def _codec_cards_scenario(hvd, rank: int, size: int) -> dict:
    """The bf16 LM with fp32 parameters (the flagship on the card, a tiny
    one on the CPU rehearsal), one sequence a rank, CODEC_CARD_STEPS AdamW
    steps each of CODEC_CARD_RUNS from the same seed, at the default 64 MB
    fusion threshold: uncompressed, DistributedOptimizer(compression=
    Compression.int8) with step replay on and off, then fp8, then the bf16
    codec through HOROVOD_TPU_COMPRESSION, then sharded=True with int8.
    Returns per run
    the losses, the host ms of each step (ending in the loss's read), a
    digest of the parameters (ranks must agree bitwise), the replay
    counters and codec selections, and on the card a trace of one replayed
    step."""
    import collections
    import hashlib
    import torch
    from horovod_tpu_torch.common.env import DEFAULT_FUSION_THRESHOLD_BYTES
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, lean_lm_loss)
    dev = hvd.device()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    cfg = global_state().config
    cfg.fusion_threshold_bytes = DEFAULT_FUSION_THRESHOLD_BYTES
    eng = global_state().engine
    rep = eng.replay
    dims = ADASUM_CARD_DIMS if dev.type == "cuda" else ADASUM_CPU_DIMS
    lm = TransformerConfig(dtype=torch.bfloat16, attention="flash", **dims)
    tokens = np.random.RandomState(16).randint(
        0, lm.vocab_size, size=(size, lm.max_seq + 1))
    x = torch.from_numpy(tokens[rank:rank + 1, :-1]).to(dev)
    y = torch.from_numpy(tokens[rank:rank + 1, 1:]).to(dev)
    out = {}
    for run, codec, knob, sharded, replay in CODEC_CARD_RUNS:
        cfg.compression = knob
        cfg.step_replay = replay
        model = Transformer(lm, generator=torch.Generator().manual_seed(0))
        model.to(dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=3e-4,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4),
            op=hvd.Average, sharded=sharded,
            compression=getattr(hvd.Compression, codec))
        before = (rep.captured_streams, rep.replayed_steps, rep.fallbacks)
        selections = collections.Counter(eng.codec_selections)

        def step():
            opt.zero_grad()
            loss = lean_lm_loss(model, x, y)
            loss.backward()
            opt.step()
            return float(loss.detach())

        res = {"losses": [], "step_ms": []}
        for _ in range(CODEC_CARD_STEPS):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res["losses"].append(step())
            res["step_ms"].append(1e3 * (time.perf_counter() - t0))
        res["replay"] = tuple(a - b for a, b in zip(
            (rep.captured_streams, rep.replayed_steps, rep.fallbacks),
            before))
        res["selections"] = dict(eng.codec_selections - selections)
        digest = hashlib.sha256()
        for p in model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        res["digest"] = digest.hexdigest()
        res["residual_bytes"] = sum(v["buf"].nbytes
                                    for v in eng._residuals.values())
        if dev.type == "cuda" and run != "none" and replay:
            # a replayed step on the last gradients (it moves the
            # parameters, so it comes after the digest)
            host, device = trace_events(
                opt.step, lambda h, d: any("pack_kernel" in k for k in d))
            res["trace"] = {"host": host, "device": device}
        out[run] = res
        cfg.compression = "none"
        cfg.step_replay = True
        rep.invalidate_all("next run")
        del model, opt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# -- algorithm selection (the ``algo`` and ``algo_cards`` scenarios) --------

ALGO_TOTALS = (7, 1001)         # divide neither 2 nor 4
ALGO_OPS = ("SUM", "AVERAGE")
ALGO_SCALES = ((1.0, 1.0), (2.0, 0.5))
ALGO_FORMS = ("flat", "tree", "hierarchical")
ALGO_CODECS = ("int8", "fp8", "bf16")
ALGO_CODEC_STEPS = 2
ALGO_A2A_ROWS = 3               # rows a rank sends each peer
ALGO_JOIN_BIG = 100_000         # float32: past the 256 KiB tree band
ALGO_OPT_STEPS = 5              # replay's warm-up (3) + 2 replayed steps


def algo_input(rank: int, seed: int, total: int) -> np.ndarray:
    """Rank ``rank``'s float32 bucket of ``total`` elements."""
    rng = np.random.RandomState(500 + 97 * rank + 13 * seed + total % 89)
    return rng.randn(total).astype(np.float32)


def algo_split(total: int) -> list:
    """The two tensors one bucket of ``total`` elements is packed from."""
    return [(total // 3,), (total - total // 3,)]


def algo_grid(n: int, local: int, elems: int = 512) -> np.ndarray:
    """(n, elems) integers on the int8 grid of the ladder's cross leg (the
    reference's test_hierarchical_ici_legs_bit_exact): each island's sum of
    each local chunk has amax exactly 127 (scale 1), every other entry
    small, so the cross leg's encode is exact."""
    data = np.random.RandomState(11).randint(-7, 8, size=(n, elems)).astype(
        np.float32)
    chunk = elems // local
    for j in range(local):
        data[:, j * chunk] = 0.0
        data[::local, j * chunk] = 127.0
    return data


def algo_a2a_input(rank: int, size: int) -> np.ndarray:
    """A rank's (size·ALGO_A2A_ROWS, 5) alltoall input."""
    rng = np.random.RandomState(700 + rank)
    return rng.randn(size * ALGO_A2A_ROWS, 5).astype(np.float32)


def _selections(eng, before) -> dict:
    return dict(eng.algo_selections - before)


def _algo_scenario(hvd, rank: int, size: int) -> dict:
    """The collective algorithms at ``size`` ranks (laid out in nodes of
    the launch's local size): each forced form's grouped Sum and Average
    of one bucket of 7 and of 1001 elements, with and without scales; the
    codec's hierarchical arm over ALGO_CODEC_STEPS steps with its
    residual carried; the two-level allgather (even and uneven rows) and
    the two-phase alltoall (plain and with each codec) against the flat
    ones; the reference's exact-integer parity under auto, flat, tree and
    hierarchical; a world of 2's demotion warning; rank 0 joining
    against tree and ladder buckets; ZeRO-1's flat reduce-scatter beside a
    hierarchical all-gather; DistributedOptimizer replayed under each
    form; and, on a flat world of 4, two ranks whose topology view
    factorizes agreeing with the others on flat."""
    import collections
    import logging
    import torch
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import compression as comp
    torch.set_num_threads(1)
    eng = global_state().engine
    cfg = global_state().config
    cpu = torch.device("cpu")
    warnings = []

    class _Catch(logging.Handler):
        def emit(self, record):
            if "using flat" in record.getMessage():
                warnings.append(record.getMessage())

    logging.getLogger("horovod_tpu_torch").addHandler(_Catch())
    out = {"topology": eng.topology.describe(),
           "hier_ok": eng._hierarchical_ok(),
           "tree_rounds": len(eng._tree_groups or [])}
    if cfg.collective_algo != "auto":
        return _algo_forced_case(hvd, eng, cfg, out, warnings)
    if eng.topology.local_size == size and size == 4:
        return _algo_hetero_case(hvd, eng, cfg, out, rank)
    cfg.fusion_threshold_bytes = 1 << 30
    # each forced form on one bucket, through the engine
    red, sel = {}, {}
    for form in ALGO_FORMS:
        cfg.collective_algo = form
        before = collections.Counter(eng.algo_selections)
        for op in ALGO_OPS:
            for pre, post in ALGO_SCALES:
                for total in ALGO_TOTALS:
                    x = algo_input(rank, 0, total)
                    parts = np.split(x, [algo_split(total)[0][0]])
                    hs = eng.grouped_allreduce(
                        [torch.from_numpy(p) for p in parts],
                        name=f"red.{form}.{op}.{pre}.{total}",
                        op=getattr(hvd.ReduceOp, op), prescale_factor=pre,
                        postscale_factor=post)
                    red[(form, op, pre, total)] = np.concatenate(
                        [h.synchronize().numpy() for h in hs])
        sel[form] = _selections(eng, before)
    out["reduce"], out["reduce_selections"] = red, sel
    cfg.collective_algo = "auto"
    # the codec's hierarchical arm on the agreed groups
    codec_out = {}
    if eng._hierarchical_ok():
        groups = eng.hierarchical_groups()
        local, cross = eng._hier_sizes()
        for codec in ALGO_CODECS:
            ef = codec in comp.EF_CODECS
            for op in ALGO_OPS:
                avg = size if op == "AVERAGE" else 1
                for total in ALGO_TOTALS:
                    res = (torch.zeros(C.shard_spec(total, local)[1])
                           if ef else None)
                    steps = []
                    for step in range(ALGO_CODEC_STEPS):
                        flat = C.padded_bucket(total, local, torch.float32,
                                               cpu)
                        C.pack_padded([torch.from_numpy(
                            algo_input(rank, 1 + step, total))], flat, True)
                        p, sc = C.codec_hier_allreduce(
                            flat, total, res, codec, local, cross, avg,
                            1.0, 1.0, *groups)
                        steps.append({
                            "out": flat[:total].numpy().copy(),
                            "payload": p.view(torch.uint8).numpy().copy(),
                            "scale": None if sc is None
                            else sc.numpy().copy(),
                            "residual": None if res is None
                            else res.numpy().copy()})
                    codec_out[(codec, op, total)] = steps
        grid = algo_grid(size, local)[rank]
        flat = C.padded_bucket(grid.size, local, torch.float32, cpu)
        C.pack_padded([torch.from_numpy(grid)], flat, True)
        res = torch.zeros(C.shard_spec(grid.size, local)[1])
        C.codec_hier_allreduce(flat, grid.size, res, "int8", local, cross,
                               1, 1.0, 1.0, *groups)
        codec_out["grid"] = {"out": flat.numpy().copy(),
                             "residual": res.numpy().copy()}
    out["codec_hier"] = codec_out
    # allgather and alltoall, flat against two-level
    gathers, a2a = {}, {}
    even = np.random.RandomState(800 + rank).randn(3, 4).astype(np.float32)
    ragged = np.full((rank + 1, 2), float(rank), np.float32)
    for form in ("flat", "hierarchical"):
        cfg.collective_algo = form
        before = collections.Counter(eng.algo_selections)
        gathers[form] = {
            "even": hvd.allgather(torch.from_numpy(even)).numpy(),
            "ragged": hvd.allgather(torch.from_numpy(ragged)).numpy(),
            "selections": _selections(eng, before)}
    cfg.collective_algo = "auto"
    xa = torch.from_numpy(algo_a2a_input(rank, size))
    for form, codec in (("flat", "none"), ("hierarchical", "none"),
                        ("hierarchical", "int8"), ("hierarchical", "fp8"),
                        ("hierarchical", "bf16"), ("flat", "int8")):
        cfg.alltoall_algo, cfg.alltoall_codec = form, codec
        before = collections.Counter(eng.algo_selections)
        got = hvd.alltoall(xa)
        a2a[(form, codec)] = {"out": got.numpy(),
                              "selections": _selections(eng, before)}
    # uneven splits keep the flat exchange
    cfg.alltoall_algo, cfg.alltoall_codec = "hierarchical", "none"
    before = collections.Counter(eng.algo_selections)
    t, splits = alltoall_input(rank, size)
    got, recv = hvd.alltoall(torch.from_numpy(t),
                             splits=torch.tensor(splits))
    a2a["uneven"] = {"out": got.numpy(), "recv": recv.numpy(),
                     "selections": _selections(eng, before)}
    cfg.alltoall_algo, cfg.alltoall_codec = "auto", "none"
    out["allgather"], out["alltoall"] = gathers, a2a
    # the reference's exact-integer parity under every forcing
    parity = {}
    for form in ("auto",) + ALGO_FORMS:
        cfg.collective_algo = form
        x = torch.arange(8.0) * (rank + 1)
        g0, g1 = hvd.grouped_allreduce([x, x + 1.0], name=f"g.{form}",
                                       op=hvd.Sum)
        parity[form] = {
            "allreduce": hvd.allreduce(x, name=f"ar.{form}",
                                       op=hvd.Sum).numpy(),
            "grouped": [g0.numpy(), g1.numpy()],
            "allgather": hvd.allgather(torch.tensor([float(rank)]),
                                       name=f"ag.{form}").numpy(),
            "reducescatter": hvd.reducescatter(
                torch.ones(size, 3) * (rank + 1), name=f"rs.{form}",
                op=hvd.Sum).numpy()}
    cfg.collective_algo = "auto"
    out["parity"] = parity
    # the legacy switch: a forced preference for the ladder, no warning
    cfg.hierarchical_allreduce = True
    before = collections.Counter(eng.algo_selections)
    warned = len(warnings)
    out["legacy"] = {
        "sum": hvd.allreduce(torch.ones(16384), name="legacy",
                             op=hvd.Sum)[:4].numpy(),
        "selections": _selections(eng, before),
        "warnings": warnings[warned:]}
    cfg.hierarchical_allreduce = False
    # auto's choices: a 64 KiB allreduce, a 1 MiB one
    before = collections.Counter(eng.algo_selections)
    hvd.allreduce(torch.ones(16384), name="auto.small", op=hvd.Sum)
    hvd.allreduce(torch.ones(262144), name="auto.big", op=hvd.Sum)
    out["auto_selections"] = _selections(eng, before)
    out["link_bytes"] = dict(eng.link_bytes)
    # rank 0 joins; the others' tree and ladder buckets meet its substitute
    cfg.fusion_threshold_bytes = 64 * 1024
    before = collections.Counter(eng.algo_selections)
    values = None
    if rank > 0:
        hs = eng.grouped_allreduce(
            [torch.full((16,), float(rank)),
             torch.full((ALGO_JOIN_BIG,), float(rank))],
            name="algo.join", op=hvd.Sum)
        values = [h.synchronize().numpy().copy() for h in hs]
    out["join"] = {"values": values, "last": hvd.join(),
                   "selections": _selections(eng, before)}
    # ZeRO-1: a flat reduce-scatter beside a two-level all-gather, against
    # every leg flat; DistributedOptimizer replayed under each form
    cfg.fusion_threshold_bytes = SHARDED_THRESHOLD
    rows = shard_rows(rank, size, SHARDED_ROWS)
    runs = {}
    for key, form, sharded, replay in (
            ("sharded_auto", "auto", True, True),
            ("sharded_flat", "flat", True, True),
            ("dense_tree", "tree", False, True),
            ("dense_tree_off", "tree", False, False),
            ("dense_hier", "hierarchical", False, True),
            ("dense_hier_off", "hierarchical", False, False),
            ("dense_hier_int8", "hierarchical", False, True),
            ("dense_hier_int8_off", "hierarchical", False, False)):
        cfg.collective_algo, cfg.step_replay = form, replay
        eng.replay.invalidate_all("next run")
        before = collections.Counter(eng.algo_selections)
        codec = hvd.Compression.int8 if key.startswith(
            "dense_hier_int8") else hvd.Compression.none
        start = _replay_counters(hvd)
        runs[key] = _codec_run(hvd, rows, ALGO_OPT_STEPS, lambda ps: (
            hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=CODEC_SGD_LR),
                                     op=hvd.Average, sharded=sharded,
                                     compression=codec)),
            lambda opt: engine_residuals(eng))
        runs[key]["replay"] = tuple(
            a - b for a, b in zip(_replay_counters(hvd), start))
        runs[key]["selections"] = _selections(eng, before)
    cfg.collective_algo, cfg.step_replay = "auto", True
    eng.replay.invalidate_all("done")
    out["runs"] = runs
    out["warnings"] = warnings
    return out


def _algo_forced_case(hvd, eng, cfg, out, warnings) -> dict:
    """A world launched with HOROVOD_TPU_COLLECTIVE_ALGO forced: one Sum of
    each kind, the selections and the warnings."""
    import collections
    import torch
    rank = hvd.rank()
    before = collections.Counter(eng.algo_selections)
    x = torch.arange(8.0) * (rank + 1)
    out["allreduce"] = hvd.allreduce(x, name="f.ar", op=hvd.Sum).numpy()
    out["grouped"] = [h.numpy() for h in hvd.grouped_allreduce(
        [x, x + 1.0], name="f.g", op=hvd.Sum)]
    out["allgather"] = hvd.allgather(torch.tensor([float(rank)])).numpy()
    out["selections"] = _selections(eng, before)
    out["warnings"] = warnings
    return out


def _algo_hetero_case(hvd, eng, cfg, out, rank) -> dict:
    """Ranks 0 and 1 hold a topology view that factorizes, ranks 2 and 3
    the launcher's flat one: the agreement, run again by every rank at
    the next selection, agrees on no hierarchy, and a large allreduce
    runs flat on every rank without a deadlock (the reference's
    tests/test_multiprocess.py:935-985)."""
    import collections
    import dataclasses
    import torch
    if rank < 2:
        eng.topology = dataclasses.replace(eng.topology, local_size=2)
    out["view_ok"] = eng.topology.hierarchical_ok
    out["local"] = eng.topology.local_size
    eng._hier_ok = None
    before = collections.Counter(eng.algo_selections)
    big = torch.ones(128 * 1024)           # 512 KiB: past the tree band
    out["sum"] = hvd.allreduce(big, name="het", op=hvd.Sum)[:4].numpy()
    out["hier_ok"] = eng._hierarchical_ok()
    out["selections"] = _selections(eng, before)
    return out


ALGO_CARD_STEPS = 5             # replay's warm-up (3) + 2 replayed steps
ALGO_CARD_FORMS = ("auto", "flat", "tree", "hierarchical")


def _algo_cards_scenario(hvd, rank: int, size: int) -> dict:
    """The bf16 LM with fp32 parameters (the flagship on the card, a tiny
    one on the CPU rehearsal), one sequence a rank, ALGO_CARD_STEPS AdamW
    steps through DistributedOptimizer under each of ALGO_CARD_FORMS from
    the same seed at the default 64 MB fusion threshold, replayed after
    the warm-up. Per form: the losses, the host ms of each step, a digest
    of the parameters, the replay counters, the selections, and the first
    step's reduced gradients against the flat run's (the largest ratio of
    their difference to 2 fp32 units of the sum of the ranks' |terms|).
    Then: a 64 KiB allreduce's selection; the two-level allgather and
    the two-phase alltoall (plain and int8) against the flat ones;
    sharded=True under auto against every leg flat; int8 on the ladder
    replayed; and the warnings the forcings gave."""
    import collections
    import hashlib
    import logging
    import torch
    import torch.distributed as dist
    from horovod_tpu_torch.common.env import DEFAULT_FUSION_THRESHOLD_BYTES
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, lean_lm_loss)
    dev = hvd.device()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    cfg = global_state().config
    cfg.fusion_threshold_bytes = DEFAULT_FUSION_THRESHOLD_BYTES
    eng = global_state().engine
    rep = eng.replay
    warnings = []

    class _Catch(logging.Handler):
        def emit(self, record):
            if "using flat" in record.getMessage():
                warnings.append(record.getMessage())

    logging.getLogger("horovod_tpu_torch").addHandler(_Catch())
    dims = ADASUM_CARD_DIMS if dev.type == "cuda" else ADASUM_CPU_DIMS
    lm = TransformerConfig(dtype=torch.bfloat16, attention="flash", **dims)
    tokens = np.random.RandomState(19).randint(
        0, lm.vocab_size, size=(size, lm.max_seq + 1))
    x = torch.from_numpy(tokens[rank:rank + 1, :-1]).to(dev)
    y = torch.from_numpy(tokens[rank:rank + 1, 1:]).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def digest(model):
        h = hashlib.sha256()
        for p in model.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def train(form, sharded=False, codec="none", steps=ALGO_CARD_STEPS,
              first=None):
        cfg.collective_algo = form
        rep.invalidate_all("next run")
        model = Transformer(lm, generator=torch.Generator().manual_seed(0))
        model.to(dev)
        params = list(model.parameters())
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4),
            op=hvd.Average, sharded=sharded,
            compression=getattr(hvd.Compression, codec))
        seen = {}
        if first is not None:
            # the first step's reduced gradients, read by the wrapped
            # optimizer's step
            def keep(optimizer, args, kwargs):
                seen.setdefault("reduced",
                                [p.grad.detach().clone() for p in params])

            hook = opt.optimizer.register_step_pre_hook(keep)
        before = (rep.captured_streams, rep.replayed_steps, rep.fallbacks)
        selections = collections.Counter(eng.algo_selections)
        warned = len(warnings)
        res = {"losses": [], "step_ms": []}
        for step in range(steps):
            sync()
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = lean_lm_loss(model, x, y)
            loss.backward()
            if step == 0 and first is not None:
                # 2 fp32 units of the sum of the ranks' |terms| (Average)
                terms = [p.grad.detach().abs() / size for p in params]
                for t in terms:
                    dist.all_reduce(t)
                seen["bound"] = [t.mul_(2.0 ** -22) for t in terms]
            opt.step()
            res["losses"].append(float(loss.detach()))
            sync()
            res["step_ms"].append(1e3 * (time.perf_counter() - t0))
            if step == 0 and first is not None:
                hook.remove()
        res["replay"] = tuple(a - b for a, b in zip(
            (rep.captured_streams, rep.replayed_steps, rep.fallbacks),
            before))
        res["selections"] = dict(eng.algo_selections - selections)
        res["warnings"] = warnings[warned:]
        res["digest"] = digest(model)
        res["finite"] = all(bool(torch.isfinite(p).all()) for p in params)
        if first is not None:
            reduced = seen["reduced"]
            if form == "flat":
                first["flat"] = reduced
            ratio = 0.0
            for got, want, bound in zip(reduced, first["flat"],
                                        seen["bound"]):
                diff = (got - want).abs()
                over = diff / bound.clamp_min(1e-38)
                ratio = max(ratio, float(over.max()))
            res["grad_ratio"] = ratio
            res["grad_bitwise"] = all(torch.equal(a, b) for a, b in
                                      zip(reduced, first["flat"]))
        del model, opt, params, seen
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return res

    out = {"topology": eng.topology.describe(),
           "hier_ok": eng._hierarchical_ok(),
           "tree_rounds": len(eng._tree_groups or []), "forms": {}}
    first = {}
    for form in ("flat",) + tuple(f for f in ALGO_CARD_FORMS
                                  if f != "flat"):
        out["forms"][form] = train(form, first=first)
    del first
    cfg.collective_algo = "auto"
    before = collections.Counter(eng.algo_selections)
    hvd.allreduce(torch.ones(16384, device=dev), name="card.64k", op=hvd.Sum)
    out["small_selections"] = dict(eng.algo_selections - before)
    # the two-level allgather and the two-phase alltoall
    g = torch.from_numpy(np.random.RandomState(30 + rank).randn(
        4096, 256).astype(np.float32)).to(dev)
    a = torch.from_numpy(np.random.RandomState(40 + rank).randn(
        size * 1024, 512).astype(np.float32)).to(dev).to(torch.bfloat16)
    ex = {}
    for form in ("flat", "hierarchical"):
        cfg.collective_algo = form
        ex[f"allgather_{form}"] = hvd.allgather(g)
    cfg.collective_algo = "auto"
    for form, codec in (("flat", "none"), ("hierarchical", "none"),
                        ("hierarchical", "int8")):
        cfg.alltoall_algo, cfg.alltoall_codec = form, codec
        before = collections.Counter(eng.algo_selections)
        ex[f"alltoall_{form}_{codec}"] = hvd.alltoall(a)
        out[f"alltoall_{form}_{codec}_selections"] = dict(
            eng.algo_selections - before)
    cfg.alltoall_algo, cfg.alltoall_codec = "auto", "none"
    out["allgather_bitwise"] = torch.equal(ex["allgather_flat"],
                                           ex["allgather_hierarchical"])
    out["alltoall_bitwise"] = torch.equal(ex["alltoall_flat_none"],
                                          ex["alltoall_hierarchical_none"])
    # the int8 codec on the cross phase: each received element within half
    # a step of its sender's scale (its payload's amax / 127, at most the
    # world's amax / 127) plus the rounding back to bf16 (2^-8 of amax)
    err = (ex["alltoall_hierarchical_int8"].float()
           - ex["alltoall_flat_none"].float()).abs().max()
    amax = a.float().abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    out["alltoall_int8_err"] = (float(err),
                                float(amax) * (0.5 / 127 + 2.0 ** -8))
    del ex, g, a
    # ZeRO-1 under auto (the all-gather two-level where the world
    # factorizes) against every leg flat; int8 on the ladder, replayed
    out["sharded_auto"] = train("auto", sharded=True)
    out["sharded_flat"] = train("flat", sharded=True)
    out["int8_hier"] = train("hierarchical", codec="int8")
    out["warnings"] = warnings
    cfg.collective_algo = "auto"
    return out


def check_algo_cards(res, n: int, lm_algo: str):
    """The checks of the ``algo_cards`` scenario's results on ``n`` ranks
    (``lm_algo``: the form auto picks for the LM's buckets): every form's
    parameters alike on every rank, replayed after the warm-up, finite,
    its first reduced gradients within 2 fp32 units of the sum of the
    ranks' |terms| of the flat run's and its losses within 0.1% of that
    run's; each forced form resolved as the world can express it (at 2
    ranks the ladder demotes with one warning and the tree is one pair
    round); a 64 KiB allreduce on the tree at 4 ranks; the two-level
    allgather and alltoall bitwise the flat ones, int8 on the alltoall
    within its error; ZeRO-1 under auto bitwise every leg flat; int8 on
    the ladder finite and replayed."""
    for r in res:
        flat = r["forms"]["flat"]["losses"]     # this rank's sequence
        assert r["hier_ok"] == (n == 4)
        for form, run in r["forms"].items():
            assert run["digest"] == res[0]["forms"][form]["digest"], form
            assert run["replay"] == (1, 2, 0), (form, run["replay"])
            assert run["finite"]
            assert run["grad_ratio"] <= 1.0, (form, run["grad_ratio"])
            assert max(abs(a - b) / abs(b) for a, b in
                       zip(run["losses"], flat)) < 1e-3, form
        assert set(r["forms"]["auto"]["selections"]) == {
            ("allreduce", lm_algo)}
        for form in ("tree", "hierarchical"):
            want = form if (form, n) != ("hierarchical", 2) else "flat"
            assert set(r["forms"][form]["selections"]) == {
                ("allreduce", want)}
        warned = r["forms"]["hierarchical"]["warnings"]
        assert len(warned) == (n == 2), warned
        assert r["tree_rounds"] == int(np.log2(n))
        assert r["small_selections"] == {
            ("allreduce", "tree" if n == 4 else "flat"): 1}
        assert r["allgather_bitwise"] and r["alltoall_bitwise"]
        err, bound = r["alltoall_int8_err"]
        assert err <= bound, (err, bound)
        assert r["sharded_auto"]["digest"] == r["sharded_flat"]["digest"]
        assert r["sharded_auto"]["losses"] == r["sharded_flat"]["losses"]
        assert r["int8_hier"]["finite"]
        assert r["int8_hier"]["replay"] == (1, 2, 0)


SCENARIOS = {"engine": _engine_scenario, "optimizer": _optimizer_scenario,
             "lm": _lm_scenario, "ring": _ring_scenario,
             "sp_lm": _sp_lm_scenario, "sp_cards": _sp_cards_scenario,
             "adasum": _adasum_scenario,
             "adasum_cards": _adasum_cards_scenario,
             "sync_bn": _sync_bn_scenario,
             "collectives": _collectives_scenario, "join": _join_scenario,
             "resnet_cards": _resnet_cards_scenario,
             "replay": _replay_scenario, "sharded": _sharded_scenario,
             "sharded_cards": _sharded_cards_scenario,
             "codec": _codec_scenario, "codec_cards": _codec_cards_scenario,
             "algo": _algo_scenario, "algo_cards": _algo_cards_scenario}


def main(argv):
    # a rank still running near the world's timeout prints its stacks
    faulthandler.dump_traceback_later(
        max(float(os.environ.get("TORCH_WORKER_TIMEOUT_S",
                                 WORLD_TIMEOUT_S)) - 5, 1))
    scenario, rank, size, port, out_file = argv[:5]
    device = argv[5] if len(argv) > 5 else "cpu"
    local = int(argv[6]) if len(argv) > 6 else int(size)
    os.environ.update({
        "HOROVOD_TPU_COORDINATOR": f"127.0.0.1:{port}",
        "HOROVOD_TPU_NUM_PROCESSES": size,
        "HOROVOD_TPU_PROCESS_ID": rank,
        "HOROVOD_LOCAL_RANK": str(int(rank) % local),
        "HOROVOD_LOCAL_SIZE": str(local),
        "HOROVOD_TPU_SHUTDOWN_TIMEOUT": "60",
        "HOROVOD_FUSION_THRESHOLD": "64",
    })
    import horovod_tpu_torch as hvd
    # rank r on card r, whatever its local rank
    hvd.init(device=f"cuda:{rank}" if device == "cuda" else device)
    try:
        result = SCENARIOS[scenario](hvd, int(rank), int(size))
    finally:
        hvd.shutdown()
    with open(out_file, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1:])
