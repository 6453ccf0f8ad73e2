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
    try:     # a tensor axis the heads do not split over
        make_spmd_loss(training_mesh({"data": 1, "seq": 1, "tensor": size}),
                       TransformerConfig(dtype=torch.float32,
                                         **dict(SP_DIMS, n_heads=2)))
    except ValueError as e:
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


# tensor parallelism (test_torch_tensor_parallel.py): (data, seq, tensor)
TP_MESHES = ((2, 1, 2), (1, 2, 2), (1, 1, 4))
TP_EXPERTS = 4
TP_MOE_FACTOR = 4.0          # test_transformer_spmd.py:137's
TP_PAD_FACTOR = 8.0          # :173's
TP_MULTISLICE = ({"data": 2}, {"seq": 1, "tensor": 2})


def tp_params(moe: bool = False) -> dict:
    """The LM's weights in the reference's tree, as :func:`sp_params`, with
    the MoE FFN's stacked ``router`` [L, D, E], ``w1`` [L, E, D, F] and
    ``w2`` [L, E, F, D] in place of the dense MLP's for ``moe``."""
    params = sp_params()
    rng = np.random.RandomState(111)
    d, f, n = (SP_DIMS[k] for k in ("d_model", "d_ff", "n_layers"))
    if moe:
        e = TP_EXPERTS
        params["layers"]["router"] = (
            rng.randn(n, d, e) * d ** -0.5 * 0.1).astype(np.float32)
        params["layers"]["w1"] = (rng.randn(n, e, d, f)
                                  * d ** -0.5).astype(np.float32)
        params["layers"]["w2"] = (rng.randn(n, e, f, d)
                                  * f ** -0.5).astype(np.float32)
    return params


def tp_pad_tokens():
    """(inputs, targets) [3, 6]: 18 tokens over tensor 4, a pad of 2."""
    rng = np.random.RandomState(7)
    return (rng.randint(0, SP_DIMS["vocab_size"], size=(3, 6)),
            rng.randint(0, SP_DIMS["vocab_size"], size=(3, 6)))


def tp_config(torch, moe: bool, factor: float = TP_MOE_FACTOR, **kw):
    from horovod_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(dtype=torch.float32, use_moe=moe,
                             n_experts=TP_EXPERTS,
                             moe_capacity_factor=factor, **SP_DIMS, **kw)


def _tp_case(hvd, mesh, cfg, params, tokens, opts):
    """One mesh's loss, data x seq-reduced gradients and, per optimizer in
    ``opts``, two steps' losses and parameters: this rank's slices."""
    import torch
    from horovod_tpu_torch.models.convert import transformer_from_jax
    from horovod_tpu_torch.models.transformer import (
        Transformer, make_spmd_loss, make_train_step, shard_params,
        shard_tokens)
    from horovod_tpu_torch.optimizer import allreduce_gradients
    full = transformer_from_jax(params, cfg)
    x, y = (shard_tokens(mesh, torch.from_numpy(a)) for a in tokens)

    def model():
        m = Transformer(cfg)
        m.load_state_dict(full)
        return shard_params(m, mesh, cfg)

    m = model()
    loss = make_spmd_loss(mesh, cfg)(m, x, y)
    loss.backward()
    rest = tuple(a for a in mesh.axis_names if a != "tensor")
    names = [n for n, _ in m.named_parameters()]
    grads = allreduce_gradients([p.grad for p in m.parameters()],
                                axis_name=rest, mesh=mesh, op=hvd.Sum)
    case = {"loss": float(loss), "grads": {
        n: g.numpy().copy() for n, g in zip(names, grads)}}
    for name in opts:
        m = model()
        lr = SP_LRS[name]
        opt = (torch.optim.SGD(m.parameters(), lr=lr) if name == "sgd" else
               torch.optim.AdamW(m.parameters(), lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4))
        step = make_train_step(mesh, cfg, opt)
        losses = [float(step(m, x, y)) for _ in range(SP_STEPS)]
        case[name] = {"losses": losses, "params": {
            n: p.detach().numpy().copy() for n, p in m.named_parameters()}}
    return case


def _tp_lm_scenario(hvd, rank: int, size: int) -> dict:
    """The LM under tensor parallelism on (data, seq, tensor) meshes: dense
    (SGD and AdamW), the MoE FFN with the experts over the tensor axis
    (AdamW), the pad-row case and a multislice mesh's SGD steps."""
    import torch
    from horovod_tpu_torch.parallel import mesh as pm
    torch.set_num_threads(1)     # tiny tensors; the ranks share the cores
    out = {"world_mesh": hvd.mesh().shape}
    tokens = sp_tokens()
    for shape in TP_MESHES:
        mesh = pm.training_mesh(dict(zip(("data", "seq", "tensor"), shape)))
        out[("dense", shape)] = _tp_case(hvd, mesh, tp_config(torch, False),
                                         tp_params(), tokens, SP_LRS)
        out[("moe", shape)] = _tp_case(hvd, mesh, tp_config(torch, True),
                                       tp_params(True), tokens, ("adamw",))
        out[("coords", shape)] = dict(mesh.index)
    mesh = pm.training_mesh({"data": 1, "seq": 1, "tensor": 4})
    out["pad"] = _tp_case(hvd, mesh, tp_config(torch, True, TP_PAD_FACTOR),
                          tp_params(True), tp_pad_tokens(), ())
    mesh = pm.multislice_mesh(*TP_MULTISLICE)
    out["multislice"] = _tp_case(hvd, mesh, tp_config(torch, False),
                                 tp_params(), tokens, ("sgd",))
    out["multislice_axes"] = (mesh.axis_names, dict(mesh.shape),
                              dict(mesh.index))
    hier = pm.hierarchical_mesh()
    out["hierarchical"] = (hier.axis_names, dict(hier.shape),
                           dict(hier.index))
    out["pp_dp_sp"] = dict(pm.pp_dp_sp_mesh(2, seq=1).shape)
    return out


# the MoE layer and the MoE-EP train step (test_torch_moe.py): the
# reference's test_moe.py shapes
MOE_LAYER = dict(experts=8, d=16, f=32, tokens=64, factor=8.0)
MOE_EP_DIMS = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                   d_ff=64, max_seq=16)
MOE_EP_EXPERTS = 4
MOE_EP_FACTOR = 2.0
MOE_EP_LR = 0.1
MOE_EP_STEPS = 5


def moe_layer_inputs():
    """(x [T, d], router [d, E], w_in [E, d, f], w_out [E, f, d]) of the
    MoE layer case, the reference's ``init_moe`` scales."""
    rng = np.random.RandomState(31)
    e, d, f, t = (MOE_LAYER[k] for k in ("experts", "d", "f", "tokens"))
    return (rng.randn(t, d).astype(np.float32),
            (rng.randn(d, e) * 0.02).astype(np.float32),
            (rng.randn(e, d, f) * (2.0 / d) ** 0.5).astype(np.float32),
            (rng.randn(e, f, d) * (2.0 / f) ** 0.5).astype(np.float32))


def moe_ep_params() -> dict:
    """The MoE LM's weights in the reference's tree: :func:`tp_params`'s
    scales at the MoE-EP case's dims."""
    rng = np.random.RandomState(41)
    d, h, f, v, n = (MOE_EP_DIMS[k] for k in ("d_model", "n_heads", "d_ff",
                                               "vocab_size", "n_layers"))
    e, dh = MOE_EP_EXPERTS, d // h

    def normal(shape, fan_in):
        return (rng.randn(*shape) * fan_in ** -0.5).astype(np.float32)

    layers = {"ln1": (1 + 0.1 * rng.randn(n, d)).astype(np.float32),
              "wq": normal((n, d, h, dh), d), "wk": normal((n, d, h, dh), d),
              "wv": normal((n, d, h, dh), d), "wo": normal((n, h, dh, d), d),
              "ln2": (1 + 0.1 * rng.randn(n, d)).astype(np.float32),
              "router": normal((n, d, e), d) * 0.1,
              "w1": normal((n, e, d, f), d), "w2": normal((n, e, f, d), f)}
    return {"embed": normal((v, d), d) * 0.02 * d ** 0.5, "layers": layers,
            "ln_f": (1 + 0.1 * rng.randn(d)).astype(np.float32)}


def moe_ep_tokens(rank: int):
    """(inputs, targets) [2, 16] of rank ``rank`` in the MoE-EP case."""
    rng = np.random.RandomState(50 + rank)
    v = MOE_EP_DIMS["vocab_size"]
    return rng.randint(0, v, (2, 16)), rng.randint(0, v, (2, 16))


def moe_ep_config(torch, device_dtype=None):
    from horovod_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(dtype=device_dtype or torch.float32,
                             attention="flash", use_moe=True,
                             n_experts=MOE_EP_EXPERTS,
                             moe_capacity_factor=MOE_EP_FACTOR,
                             **MOE_EP_DIMS)


def moe_ep_trajectory(hvd, eng, rank: int, size: int, steps: int,
                      device="cpu") -> dict:
    """``steps`` MoE-EP SGD steps from :func:`moe_ep_params` on this rank's
    tokens: the losses, this rank's parameters after them, and per step
    (engine dispatches, replayed steps, fallbacks so far)."""
    import torch
    from horovod_tpu_torch.models.convert import transformer_from_jax
    from horovod_tpu_torch.models.transformer import (
        Transformer, make_moe_ep_train_step, moe_ep_partition)
    cfg = moe_ep_config(torch)
    model = Transformer(cfg)
    model.load_state_dict(transformer_from_jax(moe_ep_params(), cfg))
    model.to(device)
    shared, expert = moe_ep_partition(model, rank, size, cfg)
    opt = torch.optim.SGD(model.parameters(), lr=MOE_EP_LR)
    step = make_moe_ep_train_step(eng, cfg, opt)
    x, y = (torch.from_numpy(a).to(device) for a in moe_ep_tokens(rank))
    losses, marks = [], []
    for _ in range(steps):
        d0, r0 = eng.dispatch_count, eng.replay.replayed_steps
        losses.append(float(step(model, x, y)))
        marks.append((eng.dispatch_count - d0,
                      eng.replay.replayed_steps - r0, eng.replay.fallbacks))
    return {"losses": losses, "marks": marks,
            "shared": sorted(shared), "expert": sorted(expert),
            "params": {n: p.detach().cpu().numpy().copy()
                       for n, p in model.named_parameters()}}


def _moe_ep_scenario(hvd, rank: int, size: int) -> dict:
    """The MoE layer over the world (at size 4), the MoE-EP train step
    (twice from the same start, the metrics and the replay counters), and
    at size 2 grouped_alltoall's join substitute and debug check."""
    import torch
    import torch.distributed as dist
    from horovod_tpu_torch.core.state import engine
    from horovod_tpu_torch.metrics import registry
    from horovod_tpu_torch.parallel.moe import MoEParams, moe_layer_p
    torch.set_num_threads(1)
    eng = engine()
    out = {}
    if size == 4:
        x, router, w_in, w_out = (torch.from_numpy(a)
                                  for a in moe_layer_inputs())
        el = MOE_LAYER["experts"] // size
        params = [t.clone().requires_grad_() for t in (
            router, w_in[rank * el:(rank + 1) * el],
            w_out[rank * el:(rank + 1) * el])]
        xg = x.clone().requires_grad_()
        y, aux = moe_layer_p(xg, MoEParams(*params), dist.group.WORLD, size,
                             capacity_factor=MOE_LAYER["factor"])
        (y.pow(2).sum() + 0.01 * aux).backward()
        out["layer"] = {"y": y.detach().numpy(), "aux": float(aux),
                        "grads": [xg.grad.numpy()] + [
                            p.grad.numpy() for p in params]}
    eng.replay.invalidate_all("moe_ep scenario")
    before = registry().snapshot()
    out["ep"] = moe_ep_trajectory(hvd, eng, rank, size, MOE_EP_STEPS)
    out["metrics"] = (before, registry().snapshot())
    eng.replay.invalidate_all("moe_ep scenario")
    out["ep_again"] = moe_ep_trajectory(hvd, eng, rank, size, 4)["losses"]
    if size == 2:
        out["join"] = _a2a_join_case(hvd, eng, rank)
    return out


def _a2a_join_case(hvd, eng, rank: int) -> dict:
    """Rank 1 joins while rank 0 runs a grouped alltoall (the kind-11
    substitute), then a shape mismatch under the debug check."""
    import torch
    res = {}
    eng.config.join_enabled = True       # on every rank at this point
    a = torch.arange(1.0, 13.0).reshape(4, 3)
    b = torch.arange(1.0, 3.0)
    if rank == 0:
        outs = [h.synchronize()
                for h in eng.grouped_alltoall([a, b], name="join.a2a")]
        res["outs"] = [o.numpy() for o in outs]
    res["last"] = hvd.join()
    eng.config.join_enabled = False
    eng.config.debug_consistency = True
    try:
        eng.grouped_alltoall([torch.zeros(2 + 2 * rank, 3)], name="dc.a2a")
    except Exception as e:  # noqa: BLE001
        res["mismatch"] = type(e).__name__
    eng.config.debug_consistency = False
    return res


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


# tensor parallelism and MoE-EP on the card (test_torch_cuda.py -k "cards
# and (tensor or moe)"): the bf16 LM of sp_cards, K6 attention
TP_CARD_STEPS = 2              # SGD steps held to the one-card run
TP_CARD_TIMED = 5              # steps timed after them
MOE_CARD_EXPERTS = 8
MOE_CARD_STEPS = 6             # MoE-EP steps: the first held to one card,
MOE_CARD_WARM = 3              # the warm-up, then replayed


def tp_card_cases(size: int) -> list:
    """(kind, mesh axes) of the tp_cards scenario on ``size`` cards: the
    whole world on the tensor axis, dense and with the MoE FFN, and on 4
    cards (data 2, tensor 2)."""
    whole = {"data": 1, "seq": 1, "tensor": size}
    cases = [("dense", whole), ("moe", whole)]
    if size == 4:
        cases.append(("dense", {"data": 2, "seq": 1, "tensor": 2}))
    return cases


def tp_card_config(torch, kind: str, factor: float = 8.0,
                   aux_weight: float = 0.0):
    """The LM of the card scenarios (K6 attention): dense in bf16, or with
    the MoE FFN in fp32 (K6 on its tf32 route). In bf16 the router's
    logits tie often, and the card's expert products batched another way
    (the world's [E/n, n·C, d] against one card's [E, C, d]) flip ties:
    fp32 keeps the multi-card run and its one-card run on the same
    routes. tp_cards holds the MoE under the tensor axis to one card's
    single shard, so it takes no aux loss (the tensor axis's aux is the
    mean of each rank's share's, not the whole batch's: the CPU tests
    hold it to the reference's) and a factor that drops no token."""
    from horovod_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(dtype=torch.float32 if kind == "moe"
                             else torch.bfloat16, attention="flash",
                             use_moe=kind == "moe",
                             n_experts=MOE_CARD_EXPERTS,
                             moe_capacity_factor=factor,
                             moe_aux_weight=aux_weight, **SP_CARD_DIMS)


def moe_card_tokens(rank: int):
    """(inputs, targets) [2, 256] of rank ``rank`` in moe_cards."""
    rng = np.random.RandomState(60 + rank)
    return (rng.randint(0, 256, size=(2, 256)),
            rng.randint(0, 256, size=(2, 256)))


def _timed(torch, fn):
    """``(fn(), its ms by the host clock)``, the card drained on each
    side."""
    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def _tp_cards_scenario(hvd, rank: int, size: int) -> dict:
    """The LM under tensor parallelism on the card (NCCL, K6 on this
    rank's heads): per case of :func:`tp_card_cases`, two SGD steps'
    losses, this rank's parameters after the first (its change is the
    gradient), the K6 launches, and the time of the steps after them."""
    import torch
    from horovod_tpu_torch.models.transformer import (
        make_train_step, shard_params, shard_tokens)
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel.mesh import training_mesh
    dev = hvd.device()
    inputs, targets = sp_card_tokens()
    out = {}
    for kind, axes in tp_card_cases(size):
        mesh = training_mesh(axes)
        cfg = tp_card_config(torch, kind)
        model = shard_params(sp_card_model(cfg, dev), mesh, cfg)
        x, y = (shard_tokens(mesh, torch.from_numpy(a)).to(dev)
                for a in (inputs, targets))
        step = make_train_step(mesh, cfg, torch.optim.SGD(
            model.parameters(), lr=SP_LRS["sgd"]))
        K.reset_launch_counts()
        losses = [float(step(model, x, y))]
        params1 = {n: p.detach().float().cpu().numpy().copy()
                   for n, p in model.named_parameters()}
        losses += [float(step(model, x, y))
                   for _ in range(TP_CARD_STEPS - 1)]
        counts = K.launch_counts()
        ms = [_timed(torch, lambda: step(model, x, y))[1]
              for _ in range(TP_CARD_TIMED)]
        out[(kind, tuple(axes.values()))] = {
            "losses": losses, "params1": params1, "step_ms": ms,
            "tensor_index": mesh.index["tensor"],
            "k6": {n: counts.get(n, 0) for n in (
                "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}}
    return out


def _moe_cards_scenario(hvd, rank: int, size: int) -> dict:
    """The MoE LM's MoE-EP step on the card (NCCL, the experts over
    the world, join off so the exchanges replay): the losses, this rank's
    parameters before and after the first step, each step's dispatches,
    replayed rounds and staged sub-launches, and the step times."""
    import torch
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.core.state import engine
    from horovod_tpu_torch.models.transformer import (
        make_moe_ep_train_step, moe_ep_partition)
    from horovod_tpu_torch.ops import kernels as K
    dev = hvd.device()
    eng = engine()
    cfg = tp_card_config(torch, "moe", factor=2.0, aux_weight=0.01)
    model = sp_card_model(cfg, dev)
    moe_ep_partition(model, rank, size, cfg)
    step = make_moe_ep_train_step(eng, cfg, torch.optim.SGD(
        model.parameters(), lr=SP_LRS["sgd"]))
    x, y = (torch.from_numpy(a).to(dev) for a in moe_card_tokens(rank))
    out = {"losses": [], "marks": [], "step_ms": []}
    K.reset_launch_counts()
    def stages():
        return M.counter_total(M.snapshot(),
                               "hvd_tpu_overlap_stage_launches_total")

    for i in range(MOE_CARD_STEPS):
        d0, r0, s0 = (eng.dispatch_count, eng.replay.replayed_steps,
                      stages())
        loss, ms = _timed(torch, lambda: step(model, x, y))
        out["losses"].append(float(loss))
        out["step_ms"].append(ms)
        out["marks"].append((eng.dispatch_count - d0,
                             eng.replay.replayed_steps - r0,
                             stages() - s0))
        if i == 0:
            out["params1"] = {n: p.detach().float().cpu().numpy().copy()
                              for n, p in model.named_parameters()}
    out["counts"] = K.launch_counts()
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


# -- observability: the metrics parity sequence, the consistency grid, the
# straggler -------------------------------------------------------------------

# the metric series both packages must count alike (hvd_tpu_dispatches_total
# is not among them: the reference counts XLA launches, metadata exchanges
# included, the port its own collective and graph launches)
OBS_COUNTERS = ("hvd_tpu_wire_bytes_total", "hvd_tpu_collectives_total",
                "hvd_tpu_fusion_buckets_total",
                "hvd_tpu_fusion_bucket_bytes_total",
                "hvd_tpu_collective_algo_total",
                "hvd_tpu_compression_codec_total",
                "hvd_tpu_compression_bytes_saved_total",
                "hvd_tpu_steps_total", "hvd_tpu_replay_armed_total",
                "hvd_tpu_replay_replayed_steps_total",
                "hvd_tpu_replay_fallbacks_total")
OBS_GAUGES = ("hvd_tpu_fusion_bucket_fill_pct",)
OBS_REPLAY_STEPS = 6


def obs_series(snap: dict) -> dict:
    """{metric: {sorted label items: value}} of the shared series."""
    out = {}
    for section, names in (("counters", OBS_COUNTERS),
                           ("gauges", OBS_GAUGES)):
        for name in names:
            ent = snap.get(section, {}).get(name, {"values": []})
            out[name] = {tuple(sorted(labels.items())): float(v)
                         for labels, v in ent["values"]}
    return out


def obs_delta(before: dict, after: dict) -> dict:
    """What the sequence added to each counter series (zeros dropped), and
    each gauge's value after it."""
    out = {}
    for name, series in after.items():
        if name in OBS_GAUGES:
            out[name] = series
            continue
        prev = before.get(name, {})
        out[name] = {k: v - prev.get(k, 0.0) for k, v in series.items()
                     if v != prev.get(k, 0.0)}
    return out


def obs_sequence(hvd, engine, tensor, rank: int, size: int):
    """The metrics parity sequence, for either package (``tensor(x, bf16)``
    makes its tensor from numpy): allreduce in float32 and bfloat16, a
    grouped allreduce of two buckets at a 64-byte threshold, allgather
    (uneven at size > 1), broadcast, alltoall, reducescatter, a grouped
    allreduce with the int8 codec, OBS_REPLAY_STEPS bracketed grouped
    steps (armed after the warm-up, then replayed) and a divergent step
    (a fallback)."""
    rng = np.random.RandomState(40 + rank)

    def f(*shape):
        return rng.randn(*shape).astype(np.float32)

    s = hvd.Sum
    hvd.allreduce(tensor(f(16)), name="obs.ar", op=s)
    hvd.allreduce(tensor(f(8), True), name="obs.bf", op=s)
    hvd.grouped_allreduce([tensor(f(12)), tensor(f(10))], name="obs.g",
                          op=s)
    hvd.allgather(tensor(f(rank + 1, 2)), name="obs.ag")
    hvd.broadcast(tensor(f(3)), 0, name="obs.bc")
    hvd.alltoall(tensor(f(2 * size, 2)), name="obs.a2a")
    hvd.reducescatter(tensor(f(2 * size, 3)), name="obs.rs", op=s)
    for h in engine.grouped_allreduce([tensor(f(30))], name="obs.codec",
                                      op=s, codec="int8"):
        h.synchronize()
    for i in range(OBS_REPLAY_STEPS):
        hvd.step_begin()
        hs = hvd.grouped_allreduce_async([tensor(f(8)), tensor(f(2, 2))],
                                         name=f"obs.s{i}", op=s)
        hvd.step_end()
        for h in hs:
            hvd.synchronize(h)
    hvd.step_begin()
    hvd.allreduce(tensor(f(4)), name="obs.div", op=s)
    hvd.step_end()


def _torch_obs_tensor(x, bf16=False):
    import torch
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if bf16 else t


def _obs_metrics_scenario(hvd, rank: int, size: int) -> dict:
    eng = hvd.global_state().engine
    before = obs_series(hvd.metrics_snapshot())
    obs_sequence(hvd, eng, _torch_obs_tensor, rank, size)
    return {"delta": obs_delta(before, obs_series(hvd.metrics_snapshot()))}


CONSISTENCY_CASES = ("shape", "dtype", "op", "name",
                     "grouped-broadcast-shape", "matching")


def _consistency_scenario(hvd, rank: int, size: int) -> dict:
    """HOROVOD_TPU_DEBUG_CONSISTENCY=1 at np=2, one case of the reference's
    grid (tests/test_consistency.py) named by OBS_CASE: the mismatch cases
    report the exception class raised and whether its message names the
    mismatch; "matching" runs matching submissions (an uneven allgather
    among them), then rank 1 joins while rank 0 reduces against its zero
    substitute's wildcard rows."""
    import torch
    case = os.environ["OBS_CASE"]
    mismatch = {
        "shape": (lambda: hvd.allreduce(
            torch.ones((4,) if rank == 0 else (5,)), name="t", op=hvd.Sum),
            "Mismatched shape"),
        "dtype": (lambda: hvd.allreduce(
            torch.ones(3, dtype=torch.float32 if rank == 0
                       else torch.int32), name="t", op=hvd.Sum),
            "Mismatched dtype"),
        "op": (lambda: hvd.allreduce(
            torch.ones(3), name="t", op=hvd.Sum if rank == 0 else hvd.Min),
            "reduce op"),
        "name": (lambda: hvd.allreduce(
            torch.ones(3), name="a" if rank == 0 else "b", op=hvd.Sum),
            "different tensor name"),
        "grouped-broadcast-shape": (lambda: hvd.broadcast_parameters(
            {"w": torch.ones((2, 2) if rank == 0 else (3, 2))},
            root_rank=0), "Mismatched shape"),
    }
    if case in mismatch:
        fn, text = mismatch[case]
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            return {"raised": type(e).__name__, "text": text in str(e)}
        return {"raised": None, "text": None}
    out = {"matching": (
        float(hvd.allreduce(torch.ones(3), name="ok", op=hvd.Sum)[0]),
        int(hvd.allgather(torch.zeros(rank + 1, 2), name="ag").shape[0]),
        len(hvd.grouped_allreduce([torch.ones(2), torch.ones(2, 2)],
                                  name="grp", op=hvd.Average)))}
    if rank == 0:
        out["joined_sum"] = [float(hvd.allreduce(
            torch.full((2,), 3.0), name=f"j{i}", op=hvd.Sum)[0])
            for i in range(2)]
    out["last"] = hvd.join()
    return out


def _obs_straggler_scenario(hvd, rank: int, size: int) -> dict:
    """The step-health monitor at np=2 (the reference's
    tests/test_step_health.py::test_two_rank_straggler_anomaly_end_to_end,
    without its KV scrape): 14 steady steps of one allreduce, then a delay
    failpoint at rank 1's enqueue for 3 of 6 more. Launch with
    HOROVOD_TPU_STEP_REPLAY=0 and HOROVOD_TPU_TRACE_DUMP_DIR."""
    import torch
    from horovod_tpu_torch import faults
    gs = hvd.global_state()
    warm = 14

    def one_step(i):
        # the step's compute: 10 ms on rank 1, 10-30 ms on rank 0 by a
        # deterministic cycle, so rank 1's collective wait and both ranks'
        # step times spread over milliseconds, as a training step's do,
        # not over the fraction of one a bare collective takes, which the
        # host's scheduling exceeds; the cycle's shortest step comes just
        # before the delayed ones, whose spike must open a new episode
        time.sleep(0.010 + (0.005 * ((i + 2) % 5) if rank == 0 else 0.0))
        hvd.step_begin()
        hvd.allreduce(torch.ones(64), name=f"sh.b{i}", op=hvd.Sum)
        hvd.step_end()

    for i in range(warm):
        one_step(i)
    # the sleep runs BEFORE the handle's enqueue time, so rank 1's own
    # collective wait stays flat while its peer's grows
    if rank == 1:
        faults.arm("engine.enqueue=3*delay(0.25)")
    for i in range(warm, warm + 6):
        one_step(i)
    faults.disarm()
    mon = gs.step_health
    anomalies = mon.recent_anomalies()
    dump = os.path.join(os.environ["HOROVOD_TPU_TRACE_DUMP_DIR"],
                        f"hvd_tpu_flight_rank{rank}.json")
    snap = hvd.metrics_snapshot()
    return {"classes": sorted({a.cls for a in anomalies}),
            "details": [a.detail for a in anomalies],
            "digests": len(mon.recent()), "dump": dump,
            "dump_exists": os.path.exists(dump),
            "anomaly_series": snap["counters"].get(
                "hvd_tpu_step_anomalies_total", {"values": []})["values"]}


def _obs_faults_scenario(hvd, rank: int, size: int) -> dict:
    """compression.encode at np=2: its hits at one eager int8 call and
    over a codec stream's replayed steps, then raise() there on both
    ranks, then a plain allreduce."""
    import torch
    from horovod_tpu_torch import faults
    eng = hvd.global_state().engine
    out = {}
    faults.arm("compression.encode=*noop()")
    for h in eng.grouped_allreduce([torch.ones(30)], name="fe.g",
                                   op=hvd.Sum, codec="int8"):
        h.synchronize()
    out["eager_hits"] = faults.hits("compression.encode")
    warm = eng.config.step_replay_warmup
    for i in range(warm + 2):
        hvd.step_begin()
        hs = eng.grouped_allreduce([torch.ones(30)], name=f"fe.s{i}",
                                   op=hvd.Sum, codec="int8")
        hvd.step_end()
        for h in hs:
            h.synchronize()
    out["replayed"] = eng.replay.replayed_steps
    out["replay_hits"] = faults.hits("compression.encode") - 1 - warm
    assert out["replay_hits"] == out["replayed"], out
    faults.arm("compression.encode=raise(HorovodInternalError)")
    try:
        eng.grouped_allreduce([torch.ones(30)], name="fe.r", op=hvd.Sum,
                              codec="int8")
        out["raised"] = None
    except Exception as e:  # noqa: BLE001
        out["raised"] = type(e).__name__
    faults.disarm()
    out["after"] = hvd.allreduce(torch.ones(4), name="fe.after",
                                 op=hvd.Sum).numpy()
    return out


# -- the pipeline (parallel/pipeline.py, the pipelined flagship) ----------

PP_STAGES = 4                  # the pipe axis of the schedule suite
PP_CELLS, PP_D, PP_BM = 8, 16, 6   # its tanh cells, width, microbatch rows
PP_SCHEDULES = (("1f1b", 1), ("interleaved", 2), ("zb", 1))
PP_MICRO = (8, 6, 2)           # divisible, ragged, fewer than the stages
PP_SUITE_STEPS = 2
PP_APPLY_D, PP_APPLY_V = 8, 12    # pipeline_apply_p's widths and vocab
PP_DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
               max_seq=16)
PP_BATCH, PP_MB = 8, 4         # the flagship's batch and microbatches
# (name, mesh axes, remat, schedule, n_virtual) of the flagship cases
PP_FLAGSHIP = (("pipe4", {"pipe": 4}, "none", "1f1b", 1),
               ("pipe4_block", {"pipe": 4}, "block", "1f1b", 1),
               ("pipe4_zb", {"pipe": 4}, "none", "zb", 1),
               ("dp2pp2", {"data": 2, "pipe": 2}, "none", "1f1b", 1),
               ("dp2pp2_interleaved", {"data": 2, "pipe": 2}, "none",
                "interleaved", 2))
PP_ENGINE_STEPS = 2            # engine steps held to make_pp_train_step's
PP_MOE_DIMS = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2,
                   d_ff=32, max_seq=8)
PP_MOE_STEPS = 4


def pp_cells():
    """(w [NC, D, D], b [NC, D]) of the schedule suite's tanh cells."""
    rng = np.random.RandomState(0)
    return ((rng.randn(PP_CELLS, PP_D, PP_D) * 0.3).astype(np.float32),
            (rng.randn(PP_CELLS, PP_D) * 0.1).astype(np.float32))


def pp_cell_data(n_micro: int):
    """(inputs, targets) [n_micro·BM, D] of the schedule suite."""
    rng = np.random.RandomState(100)
    return (rng.randn(n_micro * PP_BM, PP_D).astype(np.float32),
            rng.randn(n_micro * PP_BM, PP_D).astype(np.float32))


def pp_cell_order(schedule: str, v: int, p: int = PP_STAGES) -> np.ndarray:
    """The cells' physical order under a resolved (schedule, v)."""
    if v > 1 and schedule != "1f1b":
        lpc = PP_CELLS // (p * v)
        return np.concatenate([np.arange((j * p + s) * lpc,
                                         (j * p + s + 1) * lpc)
                               for s in range(p) for j in range(v)])
    return np.arange(PP_CELLS)


def pp_apply_params(kind: str, seed: int) -> dict:
    """pipeline_apply_p's weights (test_pipeline.py's): ``tanh`` stages
    (w [4, D, D], b [4, D]) or the ``lm`` form (emb, w, b, out)."""
    rng = np.random.RandomState(seed)
    d, v = PP_APPLY_D, PP_APPLY_V
    if kind == "tanh":
        return {"w": rng.randn(PP_STAGES, d, d).astype(np.float32) * 0.5,
                "b": rng.randn(PP_STAGES, d).astype(np.float32) * 0.1}
    return {"emb": rng.randn(v, d).astype(np.float32) * 0.3,
            "w": rng.randn(PP_STAGES, d, d).astype(np.float32) * 0.4,
            "b": rng.randn(PP_STAGES, d).astype(np.float32) * 0.1,
            "out": rng.randn(d, v).astype(np.float32) * 0.3}


def pp_apply_data(kind: str, seed: int):
    """pipeline_apply_p's inputs: [16 or 8, D] rows, or (tokens, targets)
    [8, 5] of the lm form."""
    rng = np.random.RandomState(seed)
    if kind == "tanh":
        return rng.randn(16 if seed == 1 else 8, PP_APPLY_D).astype(
            np.float32)
    return (rng.randint(0, PP_APPLY_V, size=(8, 5)).astype(np.int32),
            rng.randint(0, PP_APPLY_V, size=(8, 5)).astype(np.int32))


def pp_params(dims=None, moe_experts: int = 0) -> dict:
    """The pipelined flagship's weights in the reference's tree (layers
    stacked), fp32 (with ``moe_experts`` the MoE FFN's leaves)."""
    dims = dims or PP_DIMS
    rng = np.random.RandomState(21)
    d, h, f, v, n = (dims[k] for k in ("d_model", "n_heads", "d_ff",
                                       "vocab_size", "n_layers"))
    dh = d // h

    def normal(shape, fan_in):
        return (rng.randn(*shape) * fan_in ** -0.5).astype(np.float32)

    layers = {"ln1": (1 + 0.1 * rng.randn(n, d)).astype(np.float32),
              "wq": normal((n, d, h, dh), d), "wk": normal((n, d, h, dh), d),
              "wv": normal((n, d, h, dh), d), "wo": normal((n, h, dh, d), d),
              "ln2": (1 + 0.1 * rng.randn(n, d)).astype(np.float32)}
    if moe_experts:
        e = moe_experts
        layers.update(router=normal((n, d, e), d) * 0.1,
                      w1=normal((n, e, d, f), d), w2=normal((n, e, f, d), f))
    else:
        layers.update(w1=normal((n, d, f), d), w2=normal((n, f, d), f))
    return {"embed": normal((v, d), 1) * 0.5, "layers": layers,
            "ln_f": (1 + 0.1 * rng.randn(d)).astype(np.float32)}


def pp_tokens(dims=None, batch: int = PP_BATCH):
    """(inputs, targets) [batch, T] of the flagship cases."""
    dims = dims or PP_DIMS
    rng = np.random.RandomState(11)
    shape = (batch, dims["max_seq"])
    return (rng.randint(0, dims["vocab_size"], size=shape),
            rng.randint(0, dims["vocab_size"], size=shape))


def pp_config(torch, dims=None, **kw):
    from horovod_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(dtype=torch.float32, attention="flash",
                             **(dims or PP_DIMS), **kw)


def _pp_cell_run(torch, PL, mesh, schedule, v, n_micro, codec=None):
    """PP_SUITE_STEPS SGD steps of the tanh cells: (losses, this stage's
    rows of (w, b) after them, in the physical order)."""
    p, s, group = (mesh.size("pipe"), mesh.rank_in("pipe"),
                   mesh.group("pipe"))
    sched, vv = PL.resolve_pipeline_schedule(schedule, p, n_micro, v)
    order = pp_cell_order(sched, vv, p)
    w, b = pp_cells()
    rows = PP_CELLS // p
    mine = order[s * rows:(s + 1) * rows]
    W, B = torch.from_numpy(w[mine]), torch.from_numpy(b[mine])
    x, t = (torch.from_numpy(a) for a in pp_cell_data(n_micro))
    mi, mt = PL.split_microbatches(x, n_micro), PL.split_microbatches(
        t, n_micro)

    def stage_fn(sp, h):
        for i in range(sp["w"].shape[0]):
            h = torch.tanh(h @ sp["w"][i] + sp["b"][i])
        return h

    def loss_fn(y, tgt):
        return ((y - tgt) ** 2).mean()

    lpc = rows // vv
    losses = []
    for _ in range(PP_SUITE_STEPS):
        sp = ([{"w": W[j * lpc:(j + 1) * lpc], "b": B[j * lpc:(j + 1) * lpc]}
               for j in range(vv)] if vv > 1 else {"w": W, "b": B})
        loss, gs, _, _ = PL.pipeline_train_step(
            stage_fn, sp, mi, mt, loss_fn, group, p, schedule=sched,
            n_virtual=vv, boundary_codec=codec)
        if vv > 1:
            gs = {k: torch.cat([g[k] for g in gs]) for k in ("w", "b")}
        W, B = W - 0.1 * gs["w"], B - 0.1 * gs["b"]
        losses.append(float(loss))
    return losses, (W.numpy().copy(), B.numpy().copy())


def _pp_apply_cases(torch, PL, mesh) -> dict:
    """pipeline_apply_p on pipe 4: the tanh stages' outputs at m 1, 4, 8,
    their gradients, and the lm form's loss and gradients (remat off and
    on); every result this rank's (its stage's rows of w and b)."""
    p, s, group = (mesh.size("pipe"), mesh.rank_in("pipe"),
                   mesh.group("pipe"))

    def tanh_stage(sp, x):
        return torch.tanh(x @ sp["w"] + sp["b"])

    def block(sp, x):
        return x + torch.tanh(x @ sp["w"] + sp["b"])

    out = {}
    prm = pp_apply_params("tanh", 0)
    sp = {"w": torch.from_numpy(prm["w"][s]), "b": torch.from_numpy(
        prm["b"][s])}
    x = torch.from_numpy(pp_apply_data("tanh", 1))
    for m in (1, 4, 8):
        y = PL.pipeline_apply_p(tanh_stage, sp, PL.split_microbatches(x, m),
                                group, p)
        out[f"tanh_m{m}"] = PL.merge_microbatches(y).detach().numpy()
    prm = pp_apply_params("tanh", 2)
    sp = {"w": torch.from_numpy(prm["w"][s]).requires_grad_(),
          "b": torch.from_numpy(prm["b"][s]).requires_grad_()}
    x = torch.from_numpy(pp_apply_data("tanh", 3))
    y = PL.pipeline_apply_p(tanh_stage, sp, PL.split_microbatches(x, 4),
                            group, p)
    (PL.merge_microbatches(y) ** 2).sum().backward()
    out["tanh_grads"] = {k: v.grad.numpy().copy() for k, v in sp.items()}
    prm = pp_apply_params("lm", 5)
    tok, tgt = (torch.from_numpy(a).long() for a in pp_apply_data("lm", 6))
    for remat in (False, True):
        emb = torch.from_numpy(prm["emb"]).requires_grad_()
        head = torch.from_numpy(prm["out"]).requires_grad_()
        sp = {"w": torch.from_numpy(prm["w"][s]).requires_grad_(),
              "b": torch.from_numpy(prm["b"][s]).requires_grad_()}
        logits = PL.pipeline_apply_p(
            block, sp, PL.split_microbatches(tok, 4), group, p,
            first_fn=lambda fp, t: fp["emb"][t], first_params={"emb": emb},
            last_fn=lambda lp, h: h @ lp["out"], last_params={"out": head},
            remat=remat)
        logp = torch.log_softmax(PL.merge_microbatches(logits), -1)
        loss = -logp.gather(-1, tgt[..., None]).mean()
        loss.backward()
        out[f"lm_remat{int(remat)}"] = {
            "loss": float(loss.detach()), "emb": emb.grad.numpy().copy(),
            "out": head.grad.numpy().copy(), "w": sp["w"].grad.numpy().copy(),
            "b": sp["b"].grad.numpy().copy()}
    return out


def _pp_flagship(torch, hvd, mesh, remat, schedule, v) -> dict:
    """One SGD(0.1) step of make_pp_train_step from pp_params on this
    data shard's rows of pp_tokens: the loss and this stage's state."""
    from horovod_tpu_torch.models import transformer as tm
    from horovod_tpu_torch.models.convert import transformer_from_jax
    from horovod_tpu_torch.parallel import pipeline as PL
    cfg = pp_config(torch, remat=remat)
    p, d = mesh.size("pipe"), mesh.size("data")
    sched, vv = PL.resolve_pipeline_schedule(schedule, p, PP_MB, v)
    order = tm.pp_layer_order(cfg.n_layers, p, vv, sched)
    model = tm.Transformer(cfg)
    model.load_state_dict(transformer_from_jax(pp_params(), cfg))
    tm.pp_shard_layers(tm.pp_permute_layers(model, order), mesh)
    step = tm.make_pp_train_step(mesh, cfg, torch.optim.SGD(
        model.parameters(), lr=0.1), n_micro=PP_MB, schedule=schedule,
        n_virtual=v)
    x, y = pp_tokens()
    rows = shard_rows(mesh.index.get("data", 0), d, PP_BATCH)
    loss = step(model, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
    return {"loss": float(loss), "order": order,
            "state": {k: t.detach().numpy().copy()
                      for k, t in model.state_dict().items()}}


def _pp_engine_cases(torch, hvd, eng) -> dict:
    """make_pp_engine_train_step on data 2 x pipe 2 with
    DistributedOptimizer(sharded=True, op=Sum): PP_ENGINE_STEPS steps
    beside make_pp_train_step's on the same mesh, the steady-state
    dispatches a step at m = 4 and 8, and the 2-expert MoE trajectory
    twice from the same state."""
    from horovod_tpu_torch.models import transformer as tm
    from horovod_tpu_torch.models.convert import transformer_from_jax
    from horovod_tpu_torch.parallel.mesh import training_mesh
    mesh = training_mesh({"data": 2, "pipe": 2})
    cfg = pp_config(torch)
    x, y = pp_tokens()
    rows = shard_rows(mesh.index["data"], 2, PP_BATCH)
    x, y = torch.from_numpy(x[rows]), torch.from_numpy(y[rows])
    out = {}

    def engine_model(cfg, tree):
        model = tm.Transformer(cfg)
        model.load_state_dict(transformer_from_jax(tree, cfg))
        return model

    # the engine step against make_pp_train_step, SGD(0.1)
    model = engine_model(cfg, pp_params())
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1),
                                   op=hvd.Sum, sharded=True)
    step = tm.make_pp_engine_train_step(mesh, cfg, opt, PP_MB,
                                        schedule="1f1b")
    out["engine_losses"] = [float(step(model, x, y))
                            for _ in range(PP_ENGINE_STEPS)]
    out["engine_state"] = {k: t.detach().numpy().copy()
                           for k, t in model.state_dict().items()}
    model = engine_model(cfg, pp_params())
    tm.pp_shard_layers(model, mesh)
    step = tm.make_pp_train_step(mesh, cfg, torch.optim.SGD(
        model.parameters(), lr=0.1), PP_MB)
    out["pp_losses"] = [float(step(model, x, y))
                        for _ in range(PP_ENGINE_STEPS)]
    out["pp_state"] = {k: t.detach().numpy().copy()
                       for k, t in model.state_dict().items()}
    # steady-state dispatches a step: the same at m = 4 and m = 8 (the
    # whole batch on each replica: 8 rows)
    fx, fy = (torch.from_numpy(a) for a in pp_tokens())
    for m in (4, 8):
        eng.replay.invalidate_all("pipeline scenario")
        c0, r0 = eng.replay.captured_streams, eng.replay.replayed_steps
        model = engine_model(cfg, pp_params())
        opt = hvd.DistributedOptimizer(torch.optim.SGD(
            model.parameters(), lr=0.05), op=hvd.Sum, sharded=True)
        step = tm.make_pp_engine_train_step(mesh, cfg, opt, m,
                                            schedule="zb")
        for _ in range(eng.config.step_replay_warmup + 2):
            step(model, fx, fy)
        d0 = eng.dispatch_count
        loss = step(model, fx, fy)
        out[f"dispatches_m{m}"] = eng.dispatch_count - d0
        out[f"captured_m{m}"] = eng.replay.captured_streams - c0
        out[f"replayed_m{m}"] = eng.replay.replayed_steps - r0
        out[f"loss_m{m}"] = float(loss)
    # the MoE FFN, 2 experts a stage-local layer: twice from one state
    mcfg = pp_config(torch, PP_MOE_DIMS, use_moe=True, n_experts=2,
                     moe_capacity_factor=2.0)
    # the reference's batch, 4 x 8, on each replica (one row a microbatch)
    mx, my = (torch.from_numpy(a) for a in pp_tokens(PP_MOE_DIMS, 4))
    trajectories = []
    for _ in range(2):
        eng.replay.invalidate_all("pipeline scenario")
        model = engine_model(mcfg, pp_params(PP_MOE_DIMS, moe_experts=2))
        opt = hvd.DistributedOptimizer(torch.optim.SGD(
            model.parameters(), lr=0.05), op=hvd.Sum, sharded=True)
        step = tm.make_pp_engine_train_step(mesh, mcfg, opt, 4,
                                            schedule="1f1b")
        trajectories.append([float(step(model, mx, my))
                             for _ in range(PP_MOE_STEPS)])
    out["moe_trajectories"] = trajectories
    return out


def _pipeline_scenario(hvd, rank: int, size: int) -> dict:
    """The pipeline at 4 ranks (laid out as two islands of 2): the
    schedule suite's tanh cells under each schedule and microbatch count
    on pipe 4, pipeline_apply_p, the pipelined flagship's cases, the
    engine step, the boundary codec, the mesh's pipe neighbours."""
    import torch
    from horovod_tpu_torch.parallel import pipeline as PL
    from horovod_tpu_torch.parallel.mesh import (pipeline_boundary_edges,
                                                 training_mesh)
    torch.set_num_threads(1)
    eng = hvd.global_state().engine
    eng.config.fusion_threshold_bytes = 64 * 1024 * 1024
    pipe4 = training_mesh({"pipe": PP_STAGES})
    out = {"suite": {}}
    for sched, v in PP_SCHEDULES:
        for m in PP_MICRO:
            out["suite"][sched, v, m] = _pp_cell_run(torch, PL, pipe4, sched,
                                                     v, m)
    out["apply"] = _pp_apply_cases(torch, PL, pipe4)
    # the boundary codec: bf16 on the hops that cross islands
    edges = pipeline_boundary_edges(eng.topology, PP_STAGES)
    out["edges"] = edges
    PL.reset_wire_bytes()
    out["raw_run"] = _pp_cell_run(torch, PL, pipe4, "1f1b", 1, 8)
    out["raw_bytes"] = PL.wire_bytes()
    PL.reset_wire_bytes()
    out["coded_run"] = _pp_cell_run(torch, PL, pipe4, "1f1b", 1, 8,
                                    codec=("bf16", edges))
    out["coded_bytes"] = PL.wire_bytes()
    meshes = {}
    out["flagship"] = {}
    for name, axes, remat, sched, v in PP_FLAGSHIP:
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = training_mesh(axes)
        mesh = meshes[key]
        out["flagship"][name] = _pp_flagship(torch, hvd, mesh, remat, sched,
                                             v)
        out["flagship"][name]["index"] = dict(mesh.index)
    dp2pp2 = meshes[(("data", 2), ("pipe", 2))]
    out["neighbours"] = dp2pp2.neighbours("pipe")
    out["stage"] = dp2pp2.rank_in("pipe")
    out.update(_pp_engine_cases(torch, hvd, eng))
    return out


# the pipeline on the card (pp_cards): the flagship LM's widths
# (chip_smoke.py's LM_DIMS), bf16 on fp32 parameters, AdamW, microbatches
# of one sequence; a tiny LM for the gloo rehearsal
PP_CARD_DIMS = dict(vocab_size=32768, d_model=2048, n_heads=16, n_layers=4,
                    d_ff=8192, max_seq=2048)
PP_CARD_CPU_DIMS = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=4,
                        d_ff=128, max_seq=64)
PP_CARD_MICRO = (8, 4)         # a step's sequences: the marginal bubble
PP_CARD_STEPS = 2              # steps held bitwise across schedules
PP_CARD_TIMED = 5              # steps timed after them


def pp_card_cases(size: int) -> list:
    """(name, mesh axes, schedule, n_virtual, n_layers, engine step?) of
    pp_cards on ``size`` cards: every schedule on the whole world as the
    pipe axis (interleaved at 8 layers on 4 stages, beside 1f1b there),
    and the engine step (data 2 x pipe 2 on 4 cards)."""
    pipe = {"pipe": size}
    cases = [("1f1b", pipe, "1f1b", 1, 4, False),
             ("zb", pipe, "zb", 1, 4, False)]
    if size == 2:
        cases.append(("interleaved", pipe, "interleaved", 2, 4, False))
        cases.append(("engine", pipe, "1f1b", 1, 4, True))
    else:
        cases.append(("1f1b_l8", pipe, "1f1b", 1, 8, False))
        cases.append(("interleaved_l8", pipe, "interleaved", 2, 8, False))
        cases.append(("engine", {"data": 2, "pipe": 2}, "1f1b", 1, 4, True))
    return cases


def pp_card_tokens(dims, batch: int):
    """(inputs, targets) [batch, T] of pp_cards."""
    rng = np.random.RandomState(22)
    shape = (batch, dims["max_seq"])
    return (rng.randint(0, dims["vocab_size"], size=shape),
            rng.randint(0, dims["vocab_size"], size=shape))


def pp_card_config(torch, dims, n_layers: int):
    from horovod_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(dtype=torch.bfloat16, attention="flash",
                             **dict(dims, n_layers=n_layers))


def _pp_cards_scenario(hvd, rank: int, size: int) -> dict:
    """The pipelined flagship on the card (NCCL, K6 in each stage's
    recompute): per case of :func:`pp_card_cases` and microbatch count of
    PP_CARD_MICRO, PP_CARD_STEPS AdamW steps from seed-0 weights (losses,
    the embedding's float64 sum after them, K6's launches), then the ms of
    PP_CARD_TIMED more."""
    import copy
    import torch
    from horovod_tpu_torch.models import transformer as tm
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel import pipeline as PL
    from horovod_tpu_torch.parallel.mesh import training_mesh
    dev = hvd.device()
    dims = PP_CARD_DIMS if dev.type == "cuda" else PP_CARD_CPU_DIMS
    if dev.type != "cuda":
        torch.set_num_threads(1)
    x_all, y_all = pp_card_tokens(dims, max(PP_CARD_MICRO))
    templates, meshes, out = {}, {}, {}
    for name, axes, sched, v, n_layers, engine in pp_card_cases(size):
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = training_mesh(axes)
        mesh = meshes[key]
        cfg = pp_card_config(torch, dims, n_layers)
        if n_layers not in templates:
            templates[n_layers] = tm.Transformer(
                cfg, generator=torch.Generator().manual_seed(0))
        p, d = mesh.size("pipe"), mesh.size("data")
        res = {"index": dict(mesh.index)}
        for m in PP_CARD_MICRO:
            model = copy.deepcopy(templates[n_layers])
            resolved = PL.resolve_pipeline_schedule(sched, p, m // d, v)
            tm.pp_permute_layers(model, tm.pp_layer_order(n_layers, p,
                                                          resolved[1],
                                                          resolved[0]))
            if not engine:
                tm.pp_shard_layers(model, mesh)
            model.to(dev)
            adamw = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                      betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)
            if engine:
                opt = hvd.DistributedOptimizer(adamw, op=hvd.Average,
                                               sharded=True)
                step = tm.make_pp_engine_train_step(mesh, cfg, opt, m // d,
                                                    schedule=sched,
                                                    n_virtual=v)
            else:
                step = tm.make_pp_train_step(mesh, cfg, adamw, m // d,
                                             schedule=sched, n_virtual=v)
            rows = shard_rows(mesh.index.get("data", 0), d, m)
            x, y = (torch.from_numpy(a[:m][rows]).to(dev)
                    for a in (x_all, y_all))
            K.reset_launch_counts()
            losses = [float(step(model, x, y))
                      for _ in range(PP_CARD_STEPS)]
            counts = K.launch_counts()
            embed_sum = float(model.embed.detach().double().sum())
            ms = [_timed(torch, lambda: float(step(model, x, y)))[1]
                  for _ in range(PP_CARD_TIMED)]
            res[m] = {"losses": losses, "embed_sum": embed_sum, "ms": ms,
                      "resolved": resolved,
                      "k6": {n: counts.get(n, 0) for n in (
                          "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}}
            del model, step, adamw
            if dev.type == "cuda":
                res[m]["peak_gib"] = torch.cuda.max_memory_allocated(
                    dev) / 2**30
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
        out[name] = res
    return out


# the ckpt scenario: the sharded scenario's MLP under AdamW, a snapshot at
# every step through the engine's step hook (HOROVOD_TPU_CHECKPOINT_DIR
# and _INTERVAL_STEPS=1 set by the test), then ZeRO-1 steps whose state
# goes through checkpoint_payload() into CKPT_ZERO1_DIR when the test sets it
CKPT_STEPS = 5
CKPT_ZERO1_STEPS = 3
CKPT_ADAMW = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)


def ckpt_model_and_opt(hvd, device, sharded=False):
    """The MLP and its DistributedOptimizer(AdamW) of the ckpt scenario."""
    import torch
    model = sharded_model(device)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **CKPT_ADAMW), op=hvd.Average,
        sharded=sharded)
    return model, opt


def ckpt_numpy(tree):
    """A copy of a training_state tree's tensors as numpy, keyed as in a
    state dict: ``model.<name>`` and ``opt.<index>.<key>``."""
    out = {f"model.{k}": v.detach().cpu().numpy().copy()
           for k, v in tree["model"].items()}
    for i, st in tree["opt"]["state"].items():
        for k, v in st.items():
            out[f"opt.{i}.{k}"] = v.detach().cpu().numpy().copy()
    return out


def _ckpt_steps(torch, model, opt, xs, ys, steps, mgr=None):
    """``steps`` steps; with ``mgr``, each lets the snapshot its step hook
    took finish before the next, so both ranks write every generation and
    each takes the other's shard as its replica at once (a rank whose
    pending request was replaced makes its peer wait for its next
    commit)."""
    for _ in range(steps):
        opt.zero_grad()
        loss = ((model(xs) - ys) ** 2).mean()
        loss.backward()
        opt.step()
        if mgr is not None:
            assert mgr.wait_idle(60)


def _ckpt_scenario(hvd, rank: int, size: int) -> dict:
    """CKPT_STEPS steps of the MLP on this rank's rows; the provider
    returns training_state(model, opt) and records a copy of what it
    returned, by step. Then, where CKPT_ZERO1_DIR is set, CKPT_ZERO1_STEPS
    sharded steps at SHARDED_THRESHOLD and one snapshot_zero1 of
    checkpoint_payload() through a manager of this world on that
    directory."""
    import torch
    from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                              training_state)
    from horovod_tpu_torch.core.state import global_state
    torch.set_num_threads(1)
    gs = global_state()
    mgr = gs.checkpoint_manager
    dev = hvd.device()
    data_x, data_y = sharded_data()
    rows = shard_rows(rank, size, len(data_x))
    xs = torch.from_numpy(data_x[rows]).to(dev)
    ys = torch.from_numpy(data_y[rows]).to(dev)
    model, opt = ckpt_model_and_opt(hvd, dev)
    provided = {}

    def provider():
        step = len(provided) + 1
        tree = training_state(model, opt)
        provided[step] = ckpt_numpy(tree)
        return tree, step, {"batch": step}

    mgr.register_provider(provider)
    _ckpt_steps(torch, model, opt, xs, ys, CKPT_STEPS, mgr)
    out = {"idle": mgr.wait_idle(60), "interval": mgr.interval_steps,
           "kv": gs.kv is not None, "last_written": mgr.last_written_step,
           "provided": provided}
    mgr.register_provider(None)
    zdir = os.environ.get("CKPT_ZERO1_DIR")
    if zdir:
        gs.config.fusion_threshold_bytes = SHARDED_THRESHOLD
        model, opt = ckpt_model_and_opt(hvd, dev, sharded=True)
        _ckpt_steps(torch, model, opt, xs, ys, CKPT_ZERO1_STEPS)
        shards, leaves, layout = opt.checkpoint_payload()
        zm = CheckpointManager(zdir, rank=rank, world_size=size)
        try:
            zm.snapshot_zero1(shards, leaves, layout, step=CKPT_ZERO1_STEPS)
            out["zero1_idle"] = zm.wait_idle(60)
            out["zero1_written"] = zm.last_written_step
        finally:
            zm.close(flush=False)
        out["zero1"] = {
            "params": [p.detach().cpu().numpy().copy()
                       for p in model.parameters()],
            "shards": [s.detach().cpu().numpy().copy() for s in shards],
            "state": [l.detach().cpu().numpy().copy() for l in leaves],
            "layout": layout}
    return out


# the ckpt_cards scenario: the SP card LM (SP_CARD_DIMS, bf16 compute on
# fp32 parameters; a tiny one in the CPU rehearsal), one sequence a rank,
# CKPT_CARD_STEPS AdamW steps with a snapshot at each through the step
# hook, then as many ZeRO-1 steps snapshotted through checkpoint_payload();
# with CKPT_PHASE=restore the world restores both instead
CKPT_CARD_STEPS = 3


def ckpt_card_lm(hvd, dev, sharded):
    import torch
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    dims = SP_CARD_DIMS if dev.type == "cuda" else ADASUM_CPU_DIMS
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="flash", **dims)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    model.to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        op=hvd.Average, sharded=sharded)
    return cfg, model, opt


def _ckpt_cards_scenario(hvd, rank: int, size: int) -> dict:
    import torch
    from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                              load_training_state,
                                              training_state,
                                              training_template)
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models.transformer import lean_lm_loss
    gs = global_state()
    dev = hvd.device()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    mgr = gs.checkpoint_manager
    zdir = os.environ["CKPT_ZERO1_DIR"]
    # ZeRO-1 at the default threshold: one bucket of the LM's parameters
    from horovod_tpu_torch.common.env import DEFAULT_FUSION_THRESHOLD_BYTES
    gs.config.fusion_threshold_bytes = DEFAULT_FUSION_THRESHOLD_BYTES
    out = {}
    if os.environ.get("CKPT_PHASE") == "restore":
        cfg, model, opt = ckpt_card_lm(hvd, dev, sharded=False)
        res = mgr.restore_latest(template=training_template(model, opt))
        load_training_state(res.tree, model, opt)
        out["step"] = res.step
        out["restored"] = ckpt_numpy(training_state(model, opt))
        cfg, model, opt = ckpt_card_lm(hvd, dev, sharded=True)
        zm = CheckpointManager(zdir, rank=rank, world_size=size)
        try:
            zres = zm.restore_latest()
        finally:
            zm.close(flush=False)
        opt.restore_from_durable(zres.tree)
        z = opt._zero
        out["zero1"] = {
            "params": [p.detach().cpu().numpy().copy()
                       for p in model.parameters()],
            "shards": [s.detach().cpu().numpy().copy() for s in z.shards],
            "state": [v.detach().cpu().numpy().copy()
                      for v in opt.checkpoint_payload()[1]],
            "totals": [b.total for b in z.buckets]}
        return out
    cfg, model, opt = ckpt_card_lm(hvd, dev, sharded=False)
    tokens = np.random.RandomState(23).randint(
        0, cfg.vocab_size, size=(size, cfg.max_seq + 1))
    x = torch.from_numpy(tokens[rank:rank + 1, :-1]).to(dev)
    y = torch.from_numpy(tokens[rank:rank + 1, 1:]).to(dev)
    provided = {}

    def provider():
        step = len(provided) + 1
        tree = training_state(model, opt)
        provided[step] = ckpt_numpy(tree)
        return tree, step

    def train(opt, wait=False):
        # wait: each step's snapshot drains before the next (see
        # _ckpt_steps), so every rank writes every generation
        losses = []
        for _ in range(CKPT_CARD_STEPS):
            opt.zero_grad()
            loss = lean_lm_loss(model, x, y)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if wait:
                assert mgr.wait_idle(120)
        return losses

    mgr.register_provider(provider)
    out["losses"] = train(opt, wait=True)
    out["idle"] = mgr.wait_idle(120)
    out["last_written"] = mgr.last_written_step
    out["provided"] = provided if rank == 0 else {}
    mgr.register_provider(None)
    cfg, model, opt = ckpt_card_lm(hvd, dev, sharded=True)
    out["zero1_losses"] = train(opt)
    shards, leaves, layout = opt.checkpoint_payload()
    # its own manager on the shared disk: the KV holds one generation
    # keyspace a world, the replicated manager's
    zm = CheckpointManager(zdir, rank=rank, world_size=size)
    try:
        zm.snapshot_zero1(shards, leaves, layout, step=CKPT_CARD_STEPS)
        out["zero1_idle"] = zm.wait_idle(120)
    finally:
        zm.close(flush=False)
    out["zero1"] = {
        "params": [p.detach().cpu().numpy().copy()
                   for p in model.parameters()],
        "shards": [s.detach().cpu().numpy().copy() for s in shards],
        "state": [l.detach().cpu().numpy().copy() for l in leaves],
        "totals": [b.total for b in opt._zero.buckets]}
    return out


def run_ckpt_cards(out_dir, device: str, n: int, m: int, timeout=900):
    """The ckpt_cards scenario written by ``n`` ranks through a
    KVStoreServer of this process, then, with the last rank's directories
    deleted, restored by ``m`` ranks: (the writers' results, the
    restorers')."""
    import shutil
    from horovod_tpu_torch.runner.http_server import KVStoreServer
    out_dir = Path(out_dir)
    server = KVStoreServer(("127.0.0.1", 0))
    server.start()
    try:
        env = {"HOROVOD_TPU_CHECKPOINT_DIR": str(out_dir / "ckpt"),
               "HOROVOD_TPU_CHECKPOINT_INTERVAL_STEPS": "1",
               "HOROVOD_TPU_CHECKPOINT_REDUNDANCY": "1",
               "CKPT_ZERO1_DIR": str(out_dir / "zero1"),
               "HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
               "HOROVOD_GLOO_RENDEZVOUS_PORT": str(server.port)}
        (out_dir / "write").mkdir(parents=True, exist_ok=True)
        (out_dir / "restore").mkdir(parents=True, exist_ok=True)
        written = run_world("ckpt_cards", n, out_dir / "write", device,
                            env=env, timeout=timeout)
        for sub in ("ckpt", "zero1"):
            shutil.rmtree(out_dir / sub / f"rank{n - 1}")
        restored = run_world("ckpt_cards", m, out_dir / "restore", device,
                             env=dict(env, CKPT_PHASE="restore"),
                             timeout=timeout)
    finally:
        server.stop()
    return written, restored


def check_ckpt_cards(written, restored):
    """The checks of run_ckpt_cards: every writer drained its snapshots;
    each restorer's parameters and AdamW state are bitwise what rank 0's
    provider returned at the restored step; the ZeRO-1 restore's
    parameters are the writers', its moments the writers' shards joined
    and re-cut for the smaller world, its count the writers'."""
    assert all(r["idle"] and r["zero1_idle"] for r in written)
    assert all(r["last_written"] == CKPT_CARD_STEPS for r in written)
    assert all(np.isfinite(r["losses"]).all() for r in written)
    want = written[0]["provided"]
    for r in restored:
        assert r["step"] == CKPT_CARD_STEPS
        ref = want[r["step"]]
        assert r["restored"].keys() == ref.keys()
        for k in ref:
            assert r["restored"][k].tobytes() == ref[k].tobytes(), k
        z, w0 = r["zero1"], written[0]["zero1"]
        for a, b in zip(z["params"], w0["params"]):
            assert a.tobytes() == b.tobytes()
        assert z["totals"] == w0["totals"]
        assert z["state"][0] == w0["state"][0]
    nb = len(written[0]["zero1"]["totals"])
    for j in range(1, len(written[0]["zero1"]["state"])):
        total = written[0]["zero1"]["totals"][(j - 1) % nb]
        joined = [np.concatenate([r["zero1"]["state"][j]
                                  for r in res])[:total]
                  for res in (written, restored)]
        assert joined[0].tobytes() == joined[1].tobytes(), j



def _elastic_zero1_scenario(hvd, rank: int, size: int) -> dict:
    """A ZeRO-1 optimizer steps in this world of 2, which then ends; rank
    0 inits the world of 1 that follows, where the frozen layout must
    refuse to step, and a new optimizer must step."""
    import torch
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Linear(8, 3))

    def step(opt):
        opt.zero_grad()
        model(torch.ones(4, 8)).square().mean().backward()
        opt.step()

    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2), sharded=True)
    step(opt)
    hvd.shutdown()
    out = {"raised": False, "message": "", "fresh_ok": False}
    if rank != 0:
        return out
    os.environ["HOROVOD_TPU_NUM_PROCESSES"] = "1"
    os.environ.pop("HOROVOD_TPU_COORDINATOR", None)
    hvd.init(device="cpu")
    try:
        step(opt)
    except ValueError as e:
        out.update(raised=True, message=str(e))
    fresh = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2), sharded=True)
    step(fresh)
    out["fresh_ok"] = True
    return out



def _group_timeouts_scenario(hvd, rank: int, size: int) -> dict:
    """The timeout of every process group the port makes: the world's,
    the engine's tree pairs and island groups, and a training mesh's."""
    import torch
    from horovod_tpu_torch.parallel.mesh import training_mesh
    eng = hvd._engine()

    def seconds(g):
        return g._get_backend(torch.device("cpu")).options._timeout \
            .total_seconds()

    groups = [g for g in (eng._tree_groups or []) if g is not None]
    groups += [g for g in eng.hierarchical_groups() if g is not None]
    mesh = training_mesh({"data": 2, "seq": size // 2})
    groups += [mesh.group("data"), mesh.group("seq"),
               mesh.group(("data", "seq"))]
    return {"world": seconds(torch.distributed.group.WORLD),
            "groups": [seconds(g) for g in groups]}

def elastic_main(argv):
    """One worker of an elastic job, launched by the port's elastic
    launcher (``python -m horovod_tpu_torch.runner ... python
    tests/torch_worker.py elastic OUT_DIR DEVICE``): its rank comes from
    the rendezvous. It trains an LM under ``hvd.elastic.run`` with a
    ``TPUState`` committed every batch, each rank on its own tokens of the
    batch, for ``TEST_TOTAL_BATCHES`` batches; ``TEST_CRASH_RANK`` dies
    hard at ``TEST_CRASH_BATCH`` on its first life. The tiny fp32 LM on
    the CPU, the 256-wide bf16 LM (``SP_CARD_DIMS``) on ``cuda``. Writes
    ``done_<rank>_<pid>.pkl`` (rank, size, batches, the parameters'
    digest, the attention kernels' launches) or ``removed_<pid>.pkl``."""
    out_dir, device = argv[0], argv[1]
    import hashlib
    import signal
    # a hung worker writes its threads' stacks on SIGUSR1
    stacks = open(os.path.join(out_dir, f"stacks_{os.getpid()}.txt"), "w")
    faulthandler.register(signal.SIGUSR1, file=stacks)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig,
                                                      lean_lm_loss)
    from horovod_tpu_torch.ops import kernels as K
    torch.set_num_threads(1)
    total = int(os.environ["TEST_TOTAL_BATCHES"])
    crash_rank = int(os.environ.get("TEST_CRASH_RANK", "-1"))
    crash_batch = int(os.environ.get("TEST_CRASH_BATCH", "-1"))
    mark_batch = int(os.environ.get("TEST_MARK_BATCH", "-1"))
    pause = float(os.environ.get("TEST_BATCH_SLEEP", "0"))
    marker = os.path.join(out_dir, "crashed.marker")
    hvd.init(device="cpu" if device == "cpu" else None)
    # a worker scaled out before its first world has no device: it
    # builds its model on the CPU and trains nothing
    removed = hvd.global_state().backend.removed
    dev = torch.device("cpu") if removed else hvd.device()
    if device == "cpu":
        cfg = lm_config()
    else:
        cfg = TransformerConfig(dtype=torch.bfloat16, attention="flash",
                                **SP_CARD_DIMS)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    model.to(dev)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=3e-4, weight_decay=1e-4))
    restores = []

    class _State(hvd.elastic.TPUState):
        def restore(self):
            restores.append(self.batch)
            super().restore()

    state = _State(params=model, opt_state=opt, batch=0)
    lives = []

    def tokens(batch: int, rank: int):
        rng = np.random.RandomState(1000 * batch + rank)
        t = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                         size=(2, cfg.max_seq + 1)))
        return t[:, :-1].to(dev), t[:, 1:].to(dev)

    @hvd.elastic.run
    def train(state):
        lives.append((hvd.rank(), hvd.size()))
        while state.batch < total:
            if (state.batch == crash_batch and hvd.rank() == crash_rank
                    and not os.path.exists(marker)):
                with open(marker, "w") as f:
                    f.write(str(os.getpid()))
                os._exit(137)   # a hard crash, no teardown
            x, y = tokens(state.batch, hvd.rank())
            opt.zero_grad()
            lean_lm_loss(model, x, y).backward()
            opt.step()
            state.batch += 1
            state.commit()
            if state.batch == mark_batch and hvd.rank() == 0:
                open(os.path.join(out_dir, f"batch{mark_batch}"),
                     "w").close()
            started = os.path.join(out_dir, "started")
            if not os.path.exists(started):
                open(started, "w").close()
            if pause:
                time.sleep(pause)
        digest = hashlib.sha256()
        for t in model.state_dict().values():
            digest.update(t.detach().float().cpu().numpy().tobytes())
        return {"rank": hvd.rank(), "size": hvd.size(),
                "batch": state.batch, "digest": digest.hexdigest(),
                "lives": list(lives), "restores": list(restores),
                "pid": os.getpid(),
                "pack_launches": {k: v for k, v in K.launch_counts().items()
                                  if k.startswith("pack")},
                "flash_launches": {k: v for k, v in
                                   K.launch_counts().items()
                                   if k.startswith("flash")}}

    result = train(state)
    if result is not None:
        path = os.path.join(out_dir,
                            f"done_{result['rank']}_{os.getpid()}.pkl")
    else:
        path = os.path.join(out_dir, f"removed_{os.getpid()}.pkl")
        result = {"removed": True}
    with open(path, "wb") as f:
        pickle.dump(result, f)
    hvd.shutdown()


def _kill_tree(proc):
    """Kill a launcher and every process under it: its workers run in
    process groups of their own and outlive it otherwise."""
    try:
        import psutil
        kids = psutil.Process(proc.pid).children(recursive=True)
    except Exception:  # noqa: BLE001  gone already, or no psutil
        kids = []
    proc.kill()
    for k in kids:
        try:
            k.kill()
        except Exception:  # noqa: BLE001  exited meanwhile
            pass
    proc.wait()


def run_elastic_job(out_dir, hosts_text: str, np_: int, max_np: int,
                    total: int, device: str = "cpu", env=None,
                    timeout: float = 120.0, on_world=None, min_np=None):
    env_extra = env
    """Launch ``elastic_main`` workers through the port's elastic launcher
    (``python -m horovod_tpu_torch.runner``, ``--min-np`` ``min_np``, by
    default ``np_``) with a discovery script that
    reads ``hosts.txt`` in ``out_dir``. ``on_world(hostsfile)``, if given,
    runs once the launcher's first world has finished a batch (a worker's
    first commit: the file ``out_dir/started``). Returns (the launcher's
    exit code and output, done results, removed results, the pids of
    workers still running 20 s after the job, each killed after its
    stacks were taken into the output)."""
    out = Path(out_dir)
    hostsfile = out / "hosts.txt"
    hostsfile.write_text(hosts_text)
    env = dict(os.environ, PYTHONPATH=str(REPO),
               TEST_TOTAL_BATCHES=str(total),
               HOROVOD_STALL_CHECK_DISABLE="1",
               HOROVOD_TPU_SHUTDOWN_TIMEOUT="20",
               HOROVOD_ELASTIC_FAILURE_BACKOFF="0.2")
    env.update(env_extra or {})
    if device == "cpu":
        env["HOROVOD_TPU_PLATFORM"] = "cpu"
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "--elastic",
           "-np", str(np_), "--min-np", str(min_np or np_),
           "--max-np", str(max_np),
           "--host-discovery-script", f"cat {hostsfile}",
           sys.executable, str(Path(__file__).resolve()), "elastic",
           str(out), device]
    # the workers' flight dumps land in their working directory
    proc = subprocess.Popen(cmd, env=env, cwd=str(out),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        if on_world is not None:
            deadline = time.monotonic() + timeout
            while not (out / "started").exists() and \
                    time.monotonic() < deadline and proc.poll() is None:
                time.sleep(0.1)
            on_world(hostsfile)
        log = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            _kill_tree(proc)
    done = [pickle.load(open(p, "rb")) for p in sorted(out.glob("done_*"))]
    removed = [pickle.load(open(p, "rb"))
               for p in sorted(out.glob("removed_*"))]
    lingering = _lingering(out)
    if lingering:
        log += "\nworkers still running after the job:\n" + "\n".join(
            f"--- pid {pid}:\n{stacks}" for pid, stacks in lingering)
    return proc.returncode, log, done, removed, [p for p, _ in lingering]


def _lingering(out: Path, grace: float = 20.0) -> list:
    """Workers whose result file exists but whose process has not exited
    ``grace`` seconds after the job: (pid, its stacks), each then killed."""
    import signal
    pids = [int(p.stem.rsplit("_", 1)[1]) for p in
            list(out.glob("done_*")) + list(out.glob("removed_*"))]

    def alive(pid):
        try:
            os.kill(pid, 0)
        except OSError:
            return False
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().split()[2] != "Z"
        except OSError:
            return False

    deadline = time.monotonic() + grace
    while any(alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    found = []
    for pid in pids:
        if not alive(pid):
            continue
        os.kill(pid, signal.SIGUSR1)
        time.sleep(1.0)
        path = out / f"stacks_{pid}.txt"
        found.append((pid, path.read_text() if path.exists() else ""))
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return found


def cp_primary_main(argv):
    """The control-plane job's primary (``torch_worker.py cp_primary P1 P2
    HOSTS MIN_NP MAX_NP``): a replicated ``ElasticRendezvousServer`` on P1,
    role primary, and, after a line on stdin, a journaled ``ElasticDriver``
    over ``cat HOSTS`` whose workers the test spawns itself (so they
    outlive this process's SIGKILL). Prints REPL, then V1, then serves
    until it is killed. Imports only ``horovod_tpu_torch``."""
    from horovod_tpu_torch.elastic.discovery import HostDiscoveryScript
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    from horovod_tpu_torch.elastic.failover import DriverJournal
    from horovod_tpu_torch.elastic.rendezvous import ElasticRendezvousServer
    from horovod_tpu_torch.runner.replication import ReplicationConfig
    p1, p2, hosts = int(argv[0]), int(argv[1]), argv[2]
    min_np, max_np = int(argv[3]), int(argv[4])
    reps = [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"]
    server = ElasticRendezvousServer(("127.0.0.1", p1))
    server.start()
    server.enable_replication(reps[0], reps, role="primary",
                              config=ReplicationConfig.from_env())
    print("REPL", flush=True)
    sys.stdin.readline()
    driver = ElasticDriver(server, HostDiscoveryScript(f"cat {hosts}"),
                           min_np=min_np, max_np=max_np, timeout=60)
    server.set_driver(driver)
    driver.attach_journal(DriverJournal(server))
    driver.start(min_np, lambda slot: print(
        f"START {slot.hostname}:{slot.local_rank}", flush=True))
    print("V1", flush=True)
    while True:
        time.sleep(1)


def _line_with(proc, want: str, timeout: float) -> str:
    import selectors
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            if not sel.select(timeout=max(0.0, deadline - time.monotonic())):
                break
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"the primary exited ({proc.poll()}) "
                                   f"before printing {want!r}")
            if want in line:
                return line
    finally:
        sel.close()
    raise RuntimeError(f"the primary printed no {want!r} in {timeout} s")


def run_control_plane_job(out_dir, n: int, total: int, kill_batch: int,
                          device: str = "cpu", env=None,
                          timeout: float = 180.0, min_np=None, max_np=None,
                          after_promotion=None):
    """An elastic job of ``n`` ``elastic_main`` workers whose rendezvous
    is a replicated pair: the primary (KV and journaled driver) a
    subprocess of ``cp_primary_main``, the standby (a replica and a
    ``DriverStandby``) in this process, its lease clock started once the
    primary is up. The workers get the comma spec of both replicas as
    ``HOROVOD_GLOO_RENDEZVOUS_ADDR``; after rank 0 commits batch
    ``kill_batch`` the primary is SIGKILLed. ``after_promotion(hostsfile)``
    runs once both tiers of the standby have promoted. Returns a dict:
    the done and removed results, the workers' exit codes and output, the
    seconds from the kill to each promotion, the standby's journal audit,
    its request stats from the kill on and the seconds they cover, its
    ``/metrics`` text and ``/agg`` summary, the promoted driver's finish,
    and the slots the promoted driver spawned."""
    import json
    import signal
    import urllib.request
    from horovod_tpu_torch.elastic.discovery import HostDiscoveryScript
    from horovod_tpu_torch.elastic.failover import DriverStandby
    from horovod_tpu_torch.elastic.rendezvous import ElasticRendezvousServer
    from horovod_tpu_torch.runner.http_server import find_free_port
    from horovod_tpu_torch.runner.replication import ReplicationConfig
    out = Path(out_dir)
    hosts = out / "hosts.txt"
    hosts.write_text(f"localhost:{n}\n")
    min_np, max_np = min_np or n, max_np or n
    p1, p2 = find_free_port(), find_free_port()
    reps = [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"]
    spec = ",".join(reps)
    base = {k: v for k, v in os.environ.items()
            if k not in ("HOROVOD_TPU_FAULTS", "HOROVOD_KV_ENDPOINTS",
                         "HOROVOD_TPU_WORLD_VERSION")}
    base["PYTHONPATH"] = str(REPO)
    standby_server = ElasticRendezvousServer(("127.0.0.1", p2))
    standby_server.start()
    spawned, workers, standby = [], [], None
    primary = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "cp_primary",
         str(p1), str(p2), str(hosts), str(min_np), str(max_np)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, env=base, text=True)
    res = {"spec": spec}
    try:
        _line_with(primary, "REPL", 60)
        standby_server.enable_replication(reps[1], reps, role="standby",
                                          config=ReplicationConfig.from_env())
        wenv = dict(base, HOROVOD_ELASTIC="1", HOROVOD_HOSTNAME="localhost",
                    HOROVOD_TPU_COORDINATOR="@rendezvous",
                    HOROVOD_GLOO_RENDEZVOUS_ADDR=spec,
                    HOROVOD_GLOO_RENDEZVOUS_PORT=str(p1),
                    TEST_TOTAL_BATCHES=str(total),
                    TEST_MARK_BATCH=str(kill_batch),
                    HOROVOD_TPU_SHUTDOWN_TIMEOUT="20",
                    HOROVOD_ELASTIC_FAILURE_BACKOFF="0.2")
        if device == "cpu":
            wenv["HOROVOD_TPU_PLATFORM"] = "cpu"
        wenv.update(env or {})

        def spawn(slot):
            logf = open(out / f"worker{len(workers)}.log", "w")
            workers.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "elastic",
                 str(out), device],
                env=dict(wenv, HOROVOD_LOCAL_RANK=str(slot.local_rank)),
                cwd=str(out), stdout=logf, stderr=subprocess.STDOUT), logf))

        def spawn_promoted(slot):
            spawned.append((slot.hostname, slot.local_rank))
            spawn(slot)

        standby = DriverStandby(
            standby_server, HostDiscoveryScript(f"cat {hosts}"),
            min_np=min_np, max_np=max_np, timeout=60.0,
            create_worker_fn=spawn_promoted)
        standby.start()
        primary.stdin.write("GO\n")
        primary.stdin.flush()
        _line_with(primary, "V1", 60)
        from types import SimpleNamespace
        for r in range(n):
            spawn(SimpleNamespace(hostname="localhost", local_rank=r))
        marker = out / f"batch{kill_batch}"
        deadline = time.monotonic() + timeout
        while not marker.exists() and time.monotonic() < deadline and \
                all(w.poll() is None for w, _ in workers):
            time.sleep(0.02)
        if not marker.exists():
            raise RuntimeError(f"rank 0 never committed batch {kill_batch}")
        t_kill = time.monotonic()
        before = standby_server.request_stats()
        os.kill(primary.pid, signal.SIGKILL)
        primary.wait(timeout=30)
        t_kv = t_drv = None
        while time.monotonic() < t_kill + 60 and t_drv is None:
            if t_kv is None and standby_server.replication.is_primary():
                t_kv = time.monotonic()
            if standby.driver is not None:
                t_drv = time.monotonic()
            time.sleep(0.01)
        res["kill_to_kv_s"] = None if t_kv is None else t_kv - t_kill
        res["kill_to_driver_s"] = None if t_drv is None else t_drv - t_kill
        if t_drv is not None and after_promotion is not None:
            after_promotion(hosts)
        codes, logs = [], []
        for w, logf in workers:
            try:
                codes.append(w.wait(timeout=max(
                    1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        t_end = time.monotonic()
        for w, logf in workers:
            logf.close()
        for i in range(len(workers)):
            logs.append((out / f"worker{i}.log").read_text()[-4000:])
        after = standby_server.request_stats()
        res["requests"] = {k: (v[0] - before.get(k, (0, 0))[0],
                               v[1] - before.get(k, (0, 0))[1])
                           for k, v in after.items()}
        res["requests_s"] = t_end - t_kill
        promoted = standby.driver
        if promoted is not None:
            wait_end = time.monotonic() + 30
            while not promoted.finished() and time.monotonic() < wait_end:
                time.sleep(0.05)
        res["finished"] = promoted is not None and promoted.finished()
        res["results"] = promoted.get_results() if promoted else {}
        res["audit"] = standby_server.replication.audit_journal()
        with urllib.request.urlopen(f"http://127.0.0.1:{p2}/metrics",
                                    timeout=10) as resp:
            res["metrics"] = resp.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{p2}/agg",
                                    timeout=10) as resp:
            res["agg"] = json.loads(resp.read())
        res["codes"], res["logs"], res["spawned"] = codes, logs, spawned
    finally:
        if primary.poll() is None:
            primary.kill()
            primary.wait()
        for w, logf in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        if standby is not None:
            standby.stop()
        standby_server.stop()
    res["done"] = [pickle.load(open(p, "rb"))
                   for p in sorted(out.glob("done_*"))]
    res["removed"] = [pickle.load(open(p, "rb"))
                      for p in sorted(out.glob("removed_*"))]
    return res


def prom_ranks(text: str, family: str) -> set:
    """The ``rank`` labels of ``family``'s samples in a scrape."""
    import re
    return set(re.findall(rf'^{family}{{[^}}]*rank="([^"]+)"', text,
                          re.MULTILINE))


def telemetry_puts(requests: dict) -> int:
    """PUTs of the telemetry scopes (the publishers' and the rollups')
    in a server's request stats."""
    return sum(n for (verb, scope), (n, _) in requests.items()
               if verb == "put" and scope in ("metrics", "trace", "stall",
                                              "agg"))


def set_hosts(hostsfile, text: str):
    """Replace the discovery script's host list atomically (a plain write
    truncates first, and the script can read the empty file)."""
    tmp = Path(str(hostsfile) + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, hostsfile)

def _agg_world_scenario(hvd, rank: int, size: int) -> dict:
    """The telemetry tier ``hvd.init()`` wires with a KV and two islands:
    whether this rank hosts its slice's aggregator and routes through it;
    then a few reductions and time for the publishers and the rollups to
    tick (``HOROVOD_TPU_*_INTERVAL`` set by the test)."""
    import torch
    gs = hvd.global_state()
    route = gs.telemetry_route
    for i in range(4):
        hvd.allreduce(torch.ones(8), name=f"agg.{i}")
    time.sleep(1.5)
    return {"rank": rank, "aggregator": gs.slice_aggregator is not None,
            "hierarchical": bool(route is not None and route.hierarchical),
            "slice": None if route is None else route.slice_index}


def _tensor_bytes(t) -> bytes:
    import torch
    return t.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy().tobytes()


def estimator_join_fn():
    """One rank of the np=2 uneven-shards estimator run, through the port's
    runner (``TEST_SHARD_DIR``: 3 npz shards, rank 0 holds 2 of them;
    ``TEST_OPTIMIZER``: ``sgd`` 0.05 or ``adam`` 1e-2): the MLP (8, 16, 3)
    for 2 unshuffled epochs of batch 16. Returns the batches it trained an
    epoch, the final parameters and the optimizer's state tensors."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.data import ShardedNpzDataset
    from horovod_tpu_torch.estimator import Estimator
    from horovod_tpu_torch.models.mlp import MLP, softmax_cross_entropy
    torch.set_num_threads(1)
    opts, batches = [], []

    def optimizer(ps):
        opts.append(torch.optim.SGD(ps, lr=0.05)
                    if os.environ["TEST_OPTIMIZER"] == "sgd"
                    else torch.optim.Adam(ps, lr=1e-2))
        return opts[-1]

    def loss_fn(m, x, y):
        batches.append(1)
        return softmax_cross_entropy(m(x), y.long())

    est = Estimator(init_fn=lambda g: MLP((8, 16, 3), generator=g),
                    forward_fn=lambda m, x: m(x), loss_fn=loss_fn,
                    optimizer=optimizer, epochs=2, batch_size=16,
                    shuffle=False)
    model = est.fit(ShardedNpzDataset(os.environ["TEST_SHARD_DIR"]))
    opt = opts[-1]
    return {"rank": hvd.rank(), "epochs": len(model.history),
            "batches": len(batches) // 2,
            "losses_finite": all(np.isfinite(h["train_loss"])
                                 for h in model.history),
            "params": [p.detach().numpy().copy()
                       for p in model.params.parameters()],
            "state": [v.detach().numpy().copy()
                      for p in opt.param_groups[0]["params"]
                      for _, v in sorted(opt.state[p].items())]}


def metric_average_fn():
    """``MetricAverageCallback`` at the epoch's end on this rank's logs
    ({"loss": rank + 1, "acc": 0.25 * rank}); returns the averaged logs."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.callbacks import (MetricAverageCallback,
                                             TrainLoopState)
    logs = {"loss": float(hvd.rank() + 1), "acc": 0.25 * hvd.rank()}
    MetricAverageCallback().on_epoch_end(TrainLoopState(epoch=3), logs)
    return logs


# the estimator scenario: the flagship's widths at 2 layers on the card, the
# tiny LM on gloo, bf16 on fp32 parameters, AdamW, through Estimator.fit on
# a ShardedNpzDataset of 3 shards of ESTIMATOR_SHARD_SEQS sequences: rank 0
# holds shards 0 and 2, rank 1 shard 1, so rank 1 joins halfway each epoch
ESTIMATOR_CARD_DIMS = dict(ADASUM_CARD_DIMS, n_layers=2)
ESTIMATOR_SHARD_SEQS = 8
ESTIMATOR_BATCH = 2
ESTIMATOR_EPOCHS = 2
ESTIMATOR_VAL_SEQS = 2


def estimator_dims(device: str) -> dict:
    return ESTIMATOR_CARD_DIMS if device == "cuda" else ADASUM_CPU_DIMS


def write_estimator_data(out_dir, device: str):
    """The scenario's shards (``<out_dir>/shards``) and validation tokens
    (``<out_dir>/val.npy``), from a seed: sequences of max_seq + 1 tokens,
    ``x`` the first max_seq and ``y`` the last."""
    from horovod_tpu_torch.data import ShardedNpzDataset
    dims = estimator_dims(device)
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, dims["vocab_size"],
                         (3 * ESTIMATOR_SHARD_SEQS + ESTIMATOR_VAL_SEQS,
                          dims["max_seq"] + 1)).astype(np.int64)
    train, val = tokens[:-ESTIMATOR_VAL_SEQS], tokens[-ESTIMATOR_VAL_SEQS:]
    ShardedNpzDataset.write_shards(os.path.join(out_dir, "shards"),
                                   train[:, :-1], train[:, 1:], 3)
    np.save(os.path.join(out_dir, "val.npy"), val)


def _estimator_scenario(hvd, rank: int, size: int) -> dict:
    """``Estimator.fit`` for ESTIMATOR_EPOCHS epochs with a rank-0
    ``LocalStore`` on the shared ``ESTIMATOR_DIR``, then a second
    estimator on the same store that resumes on every rank. Returns the
    epochs' losses, a sha256 of the model's and AdamW's tensors after each
    epoch (taken by a validation metric, after the re-broadcast from the
    last joiner), the batches this rank trained, the join substitutes it
    ran by kind code, K1's launches and the fusion buckets of a step, the
    resumed run's history and digest, and the seconds and peak memory."""
    import hashlib
    import torch
    from horovod_tpu_torch.common.env import DEFAULT_FUSION_THRESHOLD_BYTES
    from horovod_tpu_torch.core.engine import bucket_by_size
    from horovod_tpu_torch.data import ShardedNpzDataset
    from horovod_tpu_torch.estimator import Estimator
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig,
                                                      lean_lm_loss)
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.store import LocalStore
    gs = hvd.global_state()
    dev = hvd.device()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    # the LM's gradients in 64 MB buckets, K1 packing each
    gs.config.fusion_threshold_bytes = DEFAULT_FUSION_THRESHOLD_BYTES
    root = os.environ["ESTIMATOR_DIR"]
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="flash",
                            **estimator_dims(dev.type))
    val = np.load(os.path.join(root, "val.npy"))
    ds = ShardedNpzDataset(os.path.join(root, "shards"))
    store = LocalStore(os.path.join(root, "store"))
    eng = gs.engine
    subs, opts, digests, batches = [], [], [], []
    dispatch = eng._dispatch_substitute

    def counted(kind_code, metas):
        subs.append(int(kind_code))
        return dispatch(kind_code, metas)
    eng._dispatch_substitute = counted

    def adamw(ps):
        opts.append(torch.optim.AdamW(ps, lr=3e-4, betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=1e-4))
        return opts[-1]

    def model_digest(model) -> str:
        h = hashlib.sha256()
        for t in model.state_dict().values():
            h.update(_tensor_bytes(t))
        return h.hexdigest()

    def digest(model, x, y):
        h = hashlib.sha256(model_digest(model).encode())
        opt = opts[-1]
        for p in opt.param_groups[0]["params"]:
            for _, v in sorted(opt.state[p].items()):
                h.update(_tensor_bytes(v))
        digests.append(h.hexdigest())
        return torch.zeros(())

    def loss_fn(m, a, b):
        batches.append(1)
        return lean_lm_loss(m, a, b)

    def make(epochs):
        return Estimator(
            init_fn=lambda g: Transformer(cfg, generator=g),
            forward_fn=lambda m, t: m(t), loss_fn=loss_fn, optimizer=adamw,
            store=store, run_id="lm", epochs=epochs,
            batch_size=ESTIMATOR_BATCH,
            metric_fns={"loss": lambda m, a, b: lean_lm_loss(m, a, b),
                        "digest": digest})

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    model = make(ESTIMATOR_EPOCHS).fit(
        ds, val_data=(val[:, :-1], val[:, 1:]))
    seconds = time.perf_counter() - t0
    counts = K.launch_counts()
    n_buckets = len(bucket_by_size(list(model.params.parameters()),
                                   DEFAULT_FUSION_THRESHOLD_BYTES))
    final = model_digest(model.params)
    trained = len(batches)
    history = model.history
    del model
    hvd.barrier()     # rank 0's last checkpoint is on the disk
    t0 = time.perf_counter()
    resumed = make(ESTIMATOR_EPOCHS).fit(ds)
    resume_s = time.perf_counter() - t0
    return {
        "rank": rank, "history": history, "digests": digests,
        "batches": trained,
        "subs": subs, "pack": counts.get("pack", 0),
        "pack_graph": counts.get("pack_graph", 0), "n_buckets": n_buckets,
        "flash": {k: v for k, v in counts.items() if k.startswith("flash")},
        "final": final, "resumed_history": resumed.history,
        "resumed": model_digest(resumed.params),
        "steps": store.checkpoint_steps("lm"), "seconds": seconds,
        "resume_s": resume_s,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if dev.type == "cuda" else None)}


def check_estimator_world(res: list, device: str):
    """What the estimator scenario must show at np=2: both ranks trained
    every epoch to finite losses, equal on both; rank 1 joined halfway
    each epoch (its grouped allreduces substituted); the model and AdamW
    state bitwise equal on both ranks after each epoch; on the card K1
    packed every bucket of every reduction, the substitutes included, and
    K6 ran; rank 0's two checkpoints, resumed by both ranks, the trained
    model bitwise."""
    from horovod_tpu_torch.core.engine import _KIND_CODES
    r0, r1 = res
    per_epoch = ESTIMATOR_SHARD_SEQS // ESTIMATOR_BATCH
    assert (r0["batches"], r1["batches"]) == \
        (2 * per_epoch * ESTIMATOR_EPOCHS, per_epoch * ESTIMATOR_EPOCHS)
    assert r0["subs"] == []
    assert r1["subs"] == [_KIND_CODES["grouped_allreduce"]] * \
        (per_epoch * ESTIMATOR_EPOCHS), r1["subs"]
    for r in res:
        assert [h["epoch"] for h in r["history"]] == \
            list(range(ESTIMATOR_EPOCHS)), r["history"]
        assert all(np.isfinite(h[k]) for h in r["history"]
                   for k in ("train_loss", "val_loss")), r["history"]
        assert len(r["digests"]) == ESTIMATOR_EPOCHS
        if device == "cuda":
            reductions = r["batches"] + len(r["subs"])
            assert r["pack"] + r["pack_graph"] >= \
                r["n_buckets"] * reductions, r
            assert r["flash"]["flash_fwd"] >= \
                ESTIMATOR_CARD_DIMS["n_layers"] * r["batches"], r["flash"]
        assert r["steps"] == list(range(ESTIMATOR_EPOCHS))
        assert r["resumed_history"] == []
        assert r["resumed"] == r0["final"]
    for a, b in zip(r0["history"], r1["history"]):
        assert (a["train_loss"], a["val_loss"]) == \
            (b["train_loss"], b["val_loss"])
    assert r0["digests"] == r1["digests"]
    assert r0["final"] == r1["final"]


# the steady-state size cache's worlds (tests/test_torch_meta_cache.py)
META_WARM_ROUNDS = 3     # the reference's warm-up: hot at streak 2
META_ROUNDS = 10         # measured rounds of an allgather and an alltoall


def _meta_cache_scenario(hvd, rank: int, size: int) -> dict:
    """The steady-state size cache (the reference's
    tests/test_multiprocess.py:201-336): META_ROUNDS rounds of an uneven
    allgather, an uneven alltoall and a broadcast after the warm-up, with
    the blocking host fetches and deferred checks they made; then rank
    1's rows change after its ``mm.ag`` entry went hot (every rank must
    raise, then a fresh negotiation gathers 1 + 2 rows); then, on gloo,
    rank 1 joins while rank 0 runs one more hot uneven allgather (the
    substitute contributes zeros of its earlier 3 rows)."""
    import torch
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.core.state import engine
    eng, dev = engine(), hvd.device()
    d0, splits = rank + 1, [rank + 1] * size

    def one_round():
        g = hvd.allgather(torch.full((d0, 2), float(rank), device=dev),
                          name="ss.ag")
        recv, counts = hvd.alltoall(
            torch.full(((rank + 1) * size, 1), float(rank), device=dev),
            splits=splits, name="ss.a2a")
        b = hvd.broadcast(torch.tensor([rank + 7.0], device=dev),
                          root_rank=0, name="ss.bc")
        return g.cpu().numpy(), recv.cpu().numpy(), counts.numpy(), \
            b.cpu().numpy()

    for _ in range(META_WARM_ROUNDS):
        one_round()
    f0, c0 = eng.host_fetches, eng.deferred_meta_checks
    rounds = [one_round() for _ in range(META_ROUNDS)]
    g, recv, counts, b = rounds[-1]
    out = {"fetches": eng.host_fetches - f0,
           "checks": eng.deferred_meta_checks - c0,
           "g": g, "recv": recv, "counts": counts.tolist(),
           "b": float(b[0])}
    # a size change after the entry went hot
    for _ in range(META_WARM_ROUNDS):
        hvd.allgather(torch.ones((1, 2), device=dev) * rank, name="mm.ag")
    d1 = 2 if rank == 1 else 1
    h = eng.allgather(torch.ones((d1, 2), device=dev), name="mm.ag")
    errors = []
    for _ in range(2):      # every extract of the handle raises again
        try:
            h.synchronize()
        except HorovodInternalError as e:
            errors.append(str(e))
    again = hvd.allgather(torch.ones((d1, 2), device=dev) * (rank + 1),
                          name="mm.ag")
    out["mismatch"] = {"errors": errors, "after": again.cpu().numpy()}
    if dev.type == "cpu":
        d2 = rank + 2
        for _ in range(META_WARM_ROUNDS):
            hvd.allgather(torch.full((d2, 2), float(rank)), name="ju.ag")
        if rank == 0:
            out["join_gather"] = hvd.allgather(
                torch.full((d2, 2), 7.0), name="ju.ag").numpy()
        out["last_joined"] = hvd.join()
    return out


# the overlap worlds (tests/test_torch_overlap.py)
OVERLAP_SIZES = (5, 13, 2, 31, 7)    # fp32: 4 buckets at 64 bytes
OVERLAP_STEPS = 6                    # the knob flips after OVERLAP_FLIP
OVERLAP_FLIP = 3
OVERLAP_ZERO1_STEPS = 8              # replay's warm-up (3), then replays
OVERLAP_BUMP = 5                     # a world-version bump before this step


def overlap_input(rank: int, step: int, i: int) -> np.ndarray:
    """Rank ``rank``'s i-th float32 tensor of the single-launch runs."""
    return np.random.RandomState(1000 * rank + 10 * step + i).randn(
        OVERLAP_SIZES[i]).astype(np.float32)


def _overlap_scenario(hvd, rank: int, size: int) -> dict:
    """The overlap remainder at ``size`` ranks with join off (so "staged"
    stays staged): OVERLAP_STEPS grouped Sums of OVERLAP_SIZES, with
    single_launch on throughout, off throughout and flipped on -> off
    after OVERLAP_FLIP steps, each uncompressed and int8 (the residuals
    fresh before each run; every step's outputs and the last residuals);
    then ZeRO-1 (DistributedOptimizer(sharded=True), SGD momentum) for
    OVERLAP_ZERO1_STEPS steps under "off" and under "staged" with the
    prefetch on, a world-version bump before step OVERLAP_BUMP of each:
    the parameters after every step, the legs launched, the legs held
    before the bump and the invalidations, the replay counters."""
    import torch
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.core.state import engine
    eng, cfg = engine(), engine().config
    dev = hvd.device()

    def ctr(name):
        return M.counter_total(M.snapshot(), name)

    out = {}
    for codec in ("none", "int8"):
        for run, forms in (("on", (True,) * OVERLAP_STEPS),
                           ("off", (False,) * OVERLAP_STEPS),
                           ("flip", (True,) * OVERLAP_FLIP
                            + (False,) * (OVERLAP_STEPS - OVERLAP_FLIP))):
            eng.invalidate_residuals("next run")
            steps = []
            for step, single in enumerate(forms):
                cfg.single_launch = single
                hs = eng.grouped_allreduce(
                    [torch.from_numpy(overlap_input(rank, step, i)).to(dev)
                     for i in range(len(OVERLAP_SIZES))],
                    name=f"ov.s{step}", op=hvd.Sum, codec=codec)
                steps.append([h.synchronize().cpu().numpy() for h in hs])
            out[(codec, run)] = {
                "steps": steps,
                "residuals": {k: v["buf"].cpu().numpy().copy()
                              for k, v in eng._residuals.items()}}
    cfg.single_launch = True
    rep = eng.replay
    x = torch.ones(2, 4, device=dev) * (rank + 1)
    for mode in ("off", "staged"):
        cfg.overlap_pipeline = mode
        rep.invalidate_all(f"mode {mode}")
        w = torch.nn.Parameter(torch.ones(4, 4, device=dev))
        b = torch.nn.Parameter(torch.zeros(4, device=dev))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w, b], lr=0.1, momentum=0.9), sharded=True)
        legs0 = ctr("hvd_tpu_overlap_prefetch_total")
        inval0 = ctr("hvd_tpu_overlap_prefetch_invalidations_total")
        before = (rep.captured_streams, rep.replayed_steps, rep.fallbacks)
        res = {"params": []}
        for step in range(OVERLAP_ZERO1_STEPS):
            if step == OVERLAP_BUMP:
                res["held_before_bump"] = len(eng._zero1_prefetch)
                os.environ["HOROVOD_TPU_WORLD_VERSION"] = str(
                    eng.world_version + 1)
            opt.zero_grad()
            ((x @ w + b) ** 2).sum().backward()
            opt.step()
            res["params"].append([w.detach().cpu().numpy().copy(),
                                  b.detach().cpu().numpy().copy()])
        res["legs"] = ctr("hvd_tpu_overlap_prefetch_total") - legs0
        res["invalidations"] = ctr(
            "hvd_tpu_overlap_prefetch_invalidations_total") - inval0
        res["held_after"] = len(eng._zero1_prefetch)
        res["replay"] = tuple(a - b for a, b in zip(
            (rep.captured_streams, rep.replayed_steps, rep.fallbacks),
            before))
        out[("zero1", mode)] = res
    cfg.overlap_pipeline = "auto"
    return out


OVERLAP_CARD_STEPS = 5          # replay's warm-up (3) + 2 replayed steps
# (run, sharded, overlap mode, HOROVOD_PALLAS_PACK) of overlap_cards; each
# run is held bitwise to the first of its arm (dense_, sharded_), and
# sharded_off to dense_off as test_cuda_cards_sharded_on_nccl holds them
OVERLAP_CARD_RUNS = (("dense_off", False, "off", True),
                     ("dense_staged", False, "staged", True),
                     ("dense_single_staged", False, "staged", False),
                     ("sharded_off", True, "off", True),
                     ("sharded_staged", True, "staged", True))
# the card scenario's LM: the flagship's widths at 2 layers (9 buckets),
# so four ranks' five model builds stay short
OVERLAP_CARD_DIMS = dict(ADASUM_CARD_DIMS, n_layers=2)


def _overlap_cards_scenario(hvd, rank: int, size: int) -> dict:
    """The overlap modes on the bf16 LM with fp32 parameters (the
    flagship's widths at 2 layers on the card, a tiny LM on the CPU
    rehearsal), one sequence a rank, AdamW at the default 64 MB fusion
    threshold (4 KB on the CPU), join off: each run of OVERLAP_CARD_RUNS
    trains OVERLAP_CARD_STEPS steps from the same seed (the dense ones
    through the per-bucket K1 form or, with the pack off, the
    single-launch form; the sharded ones with the prefetch leg under
    staged). Returns each run's losses, a digest of its parameters, the
    largest difference of its parameters from the first run's and the
    first run's largest entry, its replay counters, its buckets, its
    dispatches and its moves of the overlap counters (stage launches,
    overlap steps, prefetch legs)."""
    import hashlib
    import torch
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.common.env import DEFAULT_FUSION_THRESHOLD_BYTES
    from horovod_tpu_torch.core.engine import bucket_by_size
    from horovod_tpu_torch.core.state import engine
    from horovod_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, lean_lm_loss)
    dev = hvd.device()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    eng = engine()
    cfg, rep = eng.config, eng.replay
    # the tiny LM's buckets at 4 KB: several, as the flagship's 17 at 64 MB
    cfg.fusion_threshold_bytes = (DEFAULT_FUSION_THRESHOLD_BYTES
                                  if dev.type == "cuda" else 4096)
    dims = OVERLAP_CARD_DIMS if dev.type == "cuda" else ADASUM_CPU_DIMS
    lm = TransformerConfig(dtype=torch.bfloat16, attention="flash", **dims)
    tokens = np.random.RandomState(16).randint(
        0, lm.vocab_size, size=(size, lm.max_seq + 1))
    x = torch.from_numpy(tokens[rank:rank + 1, :-1]).to(dev)
    y = torch.from_numpy(tokens[rank:rank + 1, 1:]).to(dev)
    names = ("hvd_tpu_overlap_stage_launches_total",
             "hvd_tpu_overlap_steps_total", "hvd_tpu_overlap_prefetch_total")
    out, first = {}, None
    for run, sharded, mode, pack in OVERLAP_CARD_RUNS:
        cfg.overlap_pipeline, cfg.pack_kernel = mode, pack
        rep.invalidate_all(f"run {run}")
        model = Transformer(lm, generator=torch.Generator().manual_seed(0))
        model.to(dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=3e-4,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4),
            op=hvd.Average, sharded=sharded)
        before = (rep.captured_streams, rep.replayed_steps, rep.fallbacks)
        c0 = [M.counter_total(M.snapshot(), n) for n in names]
        d0 = eng.dispatch_count
        losses = []
        for _ in range(OVERLAP_CARD_STEPS):
            opt.zero_grad()
            loss = lean_lm_loss(model, x, y)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        digest = hashlib.sha256()
        for p in model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        if first is None:
            first = [p.detach().clone() for p in model.parameters()]
        with torch.no_grad():
            max_diff = max(float((p - q).abs().max())
                           for p, q in zip(model.parameters(), first))
        out[run] = {
            "losses": losses, "digest": digest.hexdigest(),
            "max_diff": max_diff,
            "max_entry": max(float(q.abs().max()) for q in first),
            "buckets": len(bucket_by_size(list(model.parameters()),
                                          cfg.fusion_threshold_bytes)),
            "replay": tuple(a - b for a, b in zip(
                (rep.captured_streams, rep.replayed_steps, rep.fallbacks),
                before)),
            "dispatches": eng.dispatch_count - d0,
            "counters": [M.counter_total(M.snapshot(), n) - c for n, c in
                         zip(names, c0)]}
        del model, opt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    del first
    rep.invalidate_all("done")
    return out


SCENARIOS = {"engine": _engine_scenario, "optimizer": _optimizer_scenario,
             "lm": _lm_scenario, "ring": _ring_scenario,
             "sp_lm": _sp_lm_scenario, "sp_cards": _sp_cards_scenario,
             "tp_lm": _tp_lm_scenario, "moe_ep": _moe_ep_scenario,
             "tp_cards": _tp_cards_scenario,
             "moe_cards": _moe_cards_scenario,
             "adasum": _adasum_scenario,
             "adasum_cards": _adasum_cards_scenario,
             "sync_bn": _sync_bn_scenario,
             "collectives": _collectives_scenario, "join": _join_scenario,
             "resnet_cards": _resnet_cards_scenario,
             "replay": _replay_scenario, "sharded": _sharded_scenario,
             "sharded_cards": _sharded_cards_scenario,
             "codec": _codec_scenario, "codec_cards": _codec_cards_scenario,
             "algo": _algo_scenario, "algo_cards": _algo_cards_scenario,
             "obs_metrics": _obs_metrics_scenario,
             "consistency": _consistency_scenario,
             "obs_straggler": _obs_straggler_scenario,
             "obs_faults": _obs_faults_scenario,
             "pipeline": _pipeline_scenario,
             "pp_cards": _pp_cards_scenario,
             "ckpt": _ckpt_scenario, "ckpt_cards": _ckpt_cards_scenario,
             "elastic_zero1": _elastic_zero1_scenario,
             "group_timeouts": _group_timeouts_scenario,
             "agg_world": _agg_world_scenario,
             "estimator": _estimator_scenario,
             "meta_cache": _meta_cache_scenario,
             "overlap": _overlap_scenario,
             "overlap_cards": _overlap_cards_scenario}


def main(argv):
    if argv[0] == "elastic":
        return elastic_main(argv[1:])
    if argv[0] == "cp_primary":
        return cp_primary_main(argv[1:])
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
