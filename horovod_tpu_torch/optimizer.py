"""Distributed optimizers around a ``torch.optim.Optimizer``: gradient
allreduce, ZeRO-1 optimizer-state sharding, the delta-model Adasum form, and
the mesh-axis wrapper :func:`distributed`.

The port's counterpart of ``horovod_tpu/optimizer.py``'s
``DistributedEagerOptimizer`` (:458-949) in the shape of Horovod's torch
frontend: ``step()`` grouped-allreduces every ``p.grad`` through the engine's
fused, bucketed path (with ``op=Adasum``, one Adasum reduction per gradient,
named as the reference names them), then runs the wrapped optimizer's step.
Like the reference it adds no backward hooks, sums (not averages) gradients
over ``backward_passes_per_step`` local passes, and skips the engine entirely
in a size-1 world.

    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.01, momentum=0.9))
    for batch in data:
        opt.zero_grad()
        loss_fn(model, batch).backward()
        opt.step()

``sharded=True`` is ZeRO-1 (Rajbhandari et al., 2020; the reference's
``sharded=``, :458-684): at the first step the wrapped optimizer's
parameters are cut into fusion buckets (frozen from then on) and moved,
one K1 pack a bucket, into padded flat buffers of which each parameter
becomes a view; the wrapped optimizer is rebuilt over this rank's
``ceil(total / size)`` slice of each bucket, so its state and its update's
work shrink by the world size. Each step is one ``Engine.sharded_step``:
the gradients are packed and reduce-scattered into the shards' ``.grad``,
the rebuilt optimizer steps the shards, and an all-gather writes every
rank's shard back into the flat buffers, which updates the model's
parameters in place. The step runs at size 1 too.

:class:`DistributedDeltaAdasumOptimizer` is the reference's
``DistributedDeltaAdasumOptimizer`` (:1021-1131): the wrapped optimizer
steps on the local gradients and the parameter delta is Adasum-reduced.

:func:`distributed` is the reference's SPMD wrapper (:149-440) in torch's
per-process form: the same reduction, or ZeRO-1 with
``shard_optimizer=True``, over one axis of a training mesh, issued straight
to the axis's process group with K1's packs (no engine names, join rounds
or replay, as the reference's in-graph ``psum`` has none).

Wire codecs (``compression=Compression.fp8`` or ``.int8``; the reference's
:73-135, :143-265, :498-569): the optimizers leave the gradients as they
are and pass the codec to the engine, which encodes each fusion bucket
inside the collective with an error-feedback residual it keeps
(``core/engine.py``); ``sharded=True`` compresses its reduce-scatter
legs. :func:`distributed` carries the residual in the wrapper's state
(:attr:`DistributedAxisOptimizer.residuals`, one per parameter) through
a compressed reduction of each gradient over the axis, and
:func:`allreduce_gradients` runs the codec once, with no residual. Adasum
takes no wire codec, and the cast compressors (``fp16``, ``bf16``) do not
compose with ZeRO-1.
"""

from __future__ import annotations

import inspect
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from .common.env import DEFAULT_FUSION_THRESHOLD_BYTES
from .common.lru import lru_get, lru_put
from .common.reduce_ops import Adasum, Average, ReduceOp, Sum
from .core.state import engine as _engine, global_state
from .metrics import registry as _metrics_registry
from .ops import collectives as C
from .ops import compression as comp
from .ops import kernels
from .ops.adasum import adasum_allreduce_handle
from .ops.compression import Compression

# the reference's refusals (optimizer.py:353-360, :510-539, :1039-1043)
WIRE_CODEC_OP_ERROR = ("wire-codec compression (Compression.fp8/int8) "
                       "supports op=Average|Sum only")
SHARDED_CAST_ERROR = (
    "sharded=True composes only with wire-codec compression "
    "(Compression.fp8/int8, applied to the reduce-scatter legs) or "
    "Compression.none — cast compressors would change the packed buffers' "
    "dtype-uniform layout")
AXIS_SHARDED_COMPRESSION_ERROR = (
    "the shard_optimizer=True path of distributed() does not compose with "
    "compression; the DistributedOptimizer(sharded=True, "
    "compression=Compression.int8) path compresses its reduce-scatter legs")
DELTA_ADASUM_CODEC_ERROR = (
    "delta-Adasum has no wire-codec path (Adasum mixes whole updates, not "
    "additive sums); use Compression.none/fp16/bf16")


def _wire_codec(compression) -> Optional[str]:
    return getattr(compression, "wire_codec", None)


def _check_shardable(op: ReduceOp, what: str):
    """The reference's op restriction of ZeRO-1 (:497-560, :353-370)."""
    if op not in (Average, Sum):
        raise ValueError(f"{what} supports op=Average|Sum only (Adasum "
                         "mixes whole updates, not shards)")


def _shards_with(compression) -> bool:
    """Whether ZeRO-1 composes with ``compression``: none, or a wire codec
    (applied to the reduce-scatter legs)."""
    return compression is Compression.none or \
        _wire_codec(compression) is not None


def _zero1_plan(optimizer: torch.optim.Optimizer, n: int, threshold: int):
    """The ZeRO-1 bucket layout of ``optimizer``'s trainable parameters
    over ``n`` ranks (the reference's ``_zero1_layout``, :292-308):
    ``bucket_by_size`` over each param group's parameters in turn, so a
    bucket holds parameters of one group and one dtype. Returns the plan,
    per bucket ``(group, positions, sizes, shard)`` with positions into the
    flat list of parameters, that list, and a label of each parameter."""
    from .core.engine import bucket_by_size
    plan, params, labels = [], [], []
    for gi, group in enumerate(optimizer.param_groups):
        ps = [(j, p) for j, p in enumerate(group["params"])
              if p.requires_grad]
        for idxs in bucket_by_size([p for _, p in ps], threshold):
            sizes = tuple(ps[i][1].numel() for i in idxs)
            plan.append((gi, tuple(len(params) + i for i in idxs), sizes,
                         C.shard_spec(sum(sizes), n)[1]))
        params += [p for _, p in ps]
        labels += [f"param_groups[{gi}]['params'][{j}] "
                   f"{tuple(p.shape)}" for j, p in ps]
    return tuple(plan), params, labels


class _Zero1:
    """One wrapped optimizer's ZeRO-1 state on this rank (the reference's
    ``ShardedEagerState``, :443-455): the frozen plan; per bucket a
    :class:`~.ops.collectives.ShardBucket` whose parameter buffer is the
    home of the bucket's parameters (each ``p.data`` a view of it, moved
    there by one K1 pack) and whose shard is a leaf ``nn.Parameter``
    sharing its storage; and the wrapped optimizer rebuilt over those shard
    parameters, one param group per source group with that group's
    hyperparameters (its ``foreach``/``fused`` flags among them). The
    rebuilt optimizer's ``state_dict()`` is this rank's alone."""

    def __init__(self, source: torch.optim.Optimizer, n: int, rank: int,
                 threshold: int):
        self.source = source
        self.plan, self.params, self.labels = _zero1_plan(source, n,
                                                          threshold)
        if not self.plan:
            raise ValueError("a sharded optimizer needs at least one "
                             "parameter that requires grad")
        self.buckets = []
        with torch.no_grad():
            for _, idxs, sizes, _ in self.plan:
                ps = [self.params[i] for i in idxs]
                if any(p.device != ps[0].device for p in ps):
                    raise ValueError("a sharded optimizer's parameters must "
                                     "lie on one device")
                b = C.ShardBucket(idxs, sizes, ps[0].dtype, ps[0].device, n,
                                  rank)
                kernels.pack([p.detach().contiguous() for p in ps],
                             out=b.params)
                for p, view in zip(ps, C.unpack_flat(
                        b.params, [tuple(p.shape) for p in ps])):
                    p.data = view
                self.buckets.append(b)
        self.shards = [torch.nn.Parameter(b.param_shard)
                       for b in self.buckets]
        groups = {}
        for (gi, _, _, _), sp in zip(self.plan, self.shards):
            groups.setdefault(gi, []).append(sp)
        # the source group of each rebuilt group
        self.group_of = sorted(groups)
        accepted = inspect.signature(type(source).__init__).parameters
        self.optimizer = type(source)(
            [dict(_hyper(source.param_groups[gi]), params=groups[gi])
             for gi in self.group_of],
            **{k: v for k, v in source.defaults.items() if k in accepted})

    def grads(self) -> List[torch.Tensor]:
        """The layout's gradients, in its order; a parameter with no
        gradient raises (a zero would move it under momentum or weight
        decay, where the replicated path leaves it alone)."""
        out = []
        for p, label in zip(self.params, self.labels):
            if p.grad is None:
                raise ValueError(
                    f"sharded optimizer: parameter {label} has no gradient; "
                    "every parameter of the layout needs one at each step "
                    "(set requires_grad=False on parameters left out of the "
                    "loss before the first step)")
            out.append(p.grad.contiguous())
        return out

    def update(self):
        """The wrapped optimizer's step on this rank's shards, with the
        source groups' hyperparameters (where a scheduler moves them)."""
        for dst, gi in zip(self.optimizer.param_groups, self.group_of):
            dst.update(_hyper(self.source.param_groups[gi]))
        for b, sp in zip(self.buckets, self.shards):
            sp.grad = b.grad_shard
        self.optimizer.step()
        # what an LR scheduler bound to the wrapped optimizer reads to know
        # that it stepped (torch.optim.lr_scheduler's step counting)
        self.source._opt_called = True

    def state_bytes(self) -> int:
        """Bytes of the rebuilt optimizer's state tensors on this rank."""
        return sum(v.nbytes for st in self.optimizer.state.values()
                   for v in st.values() if isinstance(v, torch.Tensor))


def _hyper(group: dict) -> dict:
    return {k: v for k, v in group.items() if k != "params"}


class _Wrapper:
    """What the optimizers share: attributes the wrapper does not define
    (``param_groups``, ``state``, ``defaults``, ...) are the wrapped
    optimizer's, and ``step()`` steps on every ``backward_passes_per_step``-th
    call, ``zero_grad()`` leaving the summed gradients alone in between."""

    def __init__(self, optimizer: torch.optim.Optimizer, compression,
                 backward_passes_per_step: int):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._count = 0
        self._step = 0
        # the ZeRO-1 state, made at the first sharded step
        self._zero: Optional[_Zero1] = None
        # the engine's wire codec this wrapper's reductions run (None: the
        # HOROVOD_TPU_COMPRESSION knob decides)
        self._wire_codec = _wire_codec(compression)

    def __getattr__(self, name):
        # only reached for names this wrapper does not define
        return getattr(self.__dict__["optimizer"], name)

    def _params_with_grads(self) -> List[torch.nn.Parameter]:
        return [p for group in self.optimizer.param_groups
                for p in group["params"] if p.grad is not None]

    def _due(self) -> bool:
        """Count a backward pass; True on the one that steps."""
        if self.backward_passes_per_step > 1:
            self._count += 1
            if self._count < self.backward_passes_per_step:
                return False
            self._count = 0
        return True

    def _next_step_name(self) -> int:
        # per-step names let one step's reduction be in flight while the
        # next is submitted; a 1024-step window bounds the name table
        step = self._step
        self._step = (self._step + 1) % 1024
        return step

    def zero_grad(self, set_to_none: bool = True):
        if self._count == 0:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    def _is_sharded(self) -> bool:
        return False

    def _zero1(self) -> _Zero1:
        raise NotImplementedError

    def _closure(self, closure):
        if closure is None:
            return None
        with torch.enable_grad():
            return closure()

    def state_dict(self):
        """The wrapped optimizer's; sharded, this rank's shard optimizer's
        (rank-local: ``broadcast_optimizer_state`` refuses it)."""
        if self._is_sharded():
            return self._zero1().optimizer.state_dict()
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        if self._is_sharded():
            self._zero1().optimizer.load_state_dict(state_dict)
        else:
            self.optimizer.load_state_dict(state_dict)


class DistributedOptimizer(_Wrapper):
    """Wraps ``optimizer``; ``step()`` reduces every ``p.grad`` with ``op``
    (Average, Sum, ..., or Adasum) and then steps the wrapped optimizer.

    With ``backward_passes_per_step=k`` call ``step()`` after every backward
    pass: the first k-1 calls return without stepping and ``zero_grad()``
    leaves the gradients alone meanwhile, so autograd sums the k passes into
    ``p.grad``; the k-th call reduces that sum and steps.

    ``compression=Compression.fp8`` or ``.int8`` selects the engine's wire
    codec for every reduction (op Average or Sum only); the cast
    compressors cast the gradients around it.

    ``sharded=True`` selects ZeRO-1 (see the module's docstring; op Average
    or Sum, compression none or a wire codec). ``sharded=None`` defers to
    ``HOROVOD_TPU_SHARD_OPTIMIZER`` (off by default), read at the first step,
    and stays replicated for an optimizer ZeRO-1 does not suit. Sharded,
    the wrapped optimizer (whose ``param_groups`` a scheduler may move)
    lends its hyperparameters to the shard optimizer at every step, and
    the layout is frozen at the first step: a later move of
    ``HOROVOD_FUSION_THRESHOLD`` does not re-bucket a live run."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: ReduceOp = Average, compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 sharded: Optional[bool] = None):
        super().__init__(optimizer, compression, backward_passes_per_step)
        self.op = ReduceOp(op)
        if self._wire_codec is not None and self.op not in (Average, Sum):
            raise ValueError(WIRE_CODEC_OP_ERROR)
        if sharded:
            _check_shardable(self.op, "sharded=True")
            if not _shards_with(compression):
                raise ValueError(SHARDED_CAST_ERROR)
        self._sharded = None if sharded is None else bool(sharded)
        # the frozen layout's plans, by world size and parameter shapes
        self._layout_cache: dict = {}
        # the host time of a sharded step's dispatch (the reference's
        # optimizer.py:557)
        self._m_sharded_step = _metrics_registry().histogram(
            "hvd_tpu_sharded_step_seconds")

    def _is_sharded(self) -> bool:
        """Resolved once the world is up (the reference's ``_is_sharded``,
        :560-574)."""
        if self._sharded is None:
            st = global_state()
            if not st.initialized:
                return False
            self._sharded = bool(st.config.shard_optimizer
                                 and self.op in (Average, Sum)
                                 and _shards_with(self.compression))
        return self._sharded

    def _zero1(self) -> _Zero1:
        """The ZeRO-1 state, made at the first use. The plan is cached by
        world size and parameter shapes; a plan recomputed after the cache
        lost it (at the fusion threshold and world size of now) must be the
        live one, or the step raises rather than run on mismatched
        shards (the reference's :640-651)."""
        eng = _engine()
        n, threshold = eng.backend.size(), eng.config.fusion_threshold_bytes
        key = (n, tuple(tuple((tuple(p.shape), p.dtype) for p in g["params"]
                              if p.requires_grad)
                        for g in self.optimizer.param_groups))
        if self._zero is None:
            self._zero = _Zero1(self.optimizer, n, eng.backend.rank(),
                                threshold)
        elif lru_get(self._layout_cache, key) is None:
            plan = _zero1_plan(self.optimizer, n, threshold)[0]
            if plan != self._zero.plan:
                raise ValueError(
                    f"sharded state layout mismatch: {len(plan)} buckets "
                    f"({[b[3] for b in plan]} shards) at the fusion "
                    f"threshold and world size of now, {len(self._zero.plan)}"
                    f" ({[b[3] for b in self._zero.plan]}) in the live "
                    "state: the fusion threshold, the parameters or the "
                    "world size changed after the layout froze; build a new "
                    "optimizer over the (broadcast) parameters instead")
        lru_put(self._layout_cache, key, self._zero.plan, 16)
        return self._zero

    def synchronize(self):
        """Reduce every ``p.grad`` in place (a no-op in a size-1 world)."""
        if self._is_sharded():
            raise ValueError("a sharded optimizer reduces its gradients "
                             "inside step(); synchronize() is the "
                             "replicated path's")
        eng = _engine()
        if eng.backend.size() == 1:
            return
        params = self._params_with_grads()
        if not params:
            return
        packed = [self.compression.compress(p.grad) for p in params]
        step = self._next_step_name()
        # the reduction is one step of the collective stream: after
        # step_replay_warmup identical steps the engine services it from
        # its armed program (core/replay.py; the reference's :810-818)
        eng.step_begin()
        try:
            if self.op == Adasum:
                # the coefficients are per tensor: one reduction per
                # gradient
                handles = [adasum_allreduce_handle(
                    eng, c, f"grad.adasum.s{step}.{i}")
                    for i, (c, _) in enumerate(packed)]
            else:
                handles = eng.grouped_allreduce([c for c, _ in packed],
                                                name=f"grad.s{step}",
                                                op=self.op,
                                                codec=self._wire_codec)
        finally:
            eng.step_end()
        for p, (_, ctx), h in zip(params, packed, handles):
            g = self.compression.decompress(h.synchronize(), ctx)
            if g.dtype == p.grad.dtype and g.device == p.grad.device:
                # the reduced tensor becomes the gradient: no copy
                p.grad = g
            else:
                p.grad.copy_(g)

    def step(self, closure=None):
        if not self._due():
            return None
        if not self._is_sharded():
            self.synchronize()
            return self.optimizer.step(closure)
        loss = self._closure(closure)
        zero = self._zero1()
        eng = _engine()
        grads = zero.grads()
        step = self._next_step_name()
        # one step of the collective stream, at size 1 too: after the
        # warm-up its first half is the armed program (core/replay.py)
        t0 = time.perf_counter()
        eng.step_begin()
        try:
            eng.sharded_step(grads, zero.buckets, zero.update,
                             name=f"grad.zero.s{step}", op=self.op,
                             codec=self._wire_codec)
        finally:
            eng.step_end()
        self._m_sharded_step.observe(time.perf_counter() - t0)
        return loss


    # -- durable checkpointing of the ZeRO-1 state (the reference's
    # optimizer.py:700-756) -------------------------------------------------

    def checkpoint_payload(self):
        """``(shards, state_leaves, layout)`` for
        ``CheckpointManager.snapshot_zero1``: this rank's per-bucket flat
        parameter shards, the shard optimizer's state in optax's leaf
        order (:func:`_zero1_state_order`), and the FROZEN bucket layout
        ``[(idxs, sizes, total, shard)]`` — each rank persists exactly its
        1/world slice, and a restore at a different world size re-slices
        it (``checkpoint.shard_io.zero1_reshard``). The tensors are the
        live ones: the snapshot copies them."""
        if not self._is_sharded():
            raise ValueError(
                "checkpoint_payload needs a ZeRO-1 optimizer (sharded="
                "True); replicated state checkpoints through "
                "CheckpointManager.snapshot directly")
        zero = self._zero
        if zero is None:
            raise ValueError(
                "checkpoint_payload: the ZeRO-1 layout and state exist "
                "from the first sharded step on; step before taking a "
                "payload")
        states = [zero.optimizer.state.get(sp) for sp in zero.shards]
        if not all(states):
            raise ValueError("checkpoint_payload: the shard optimizer has "
                             "no state yet; step before taking a payload")
        leaves = []
        for key, per_bucket in _zero1_state_order(zero):
            if per_bucket:
                leaves += [st[key] for st in states]
            else:
                # optax's count: one int32 scalar
                leaves.append(states[0][key].to(torch.int32))
        layout = [(idxs, sizes, sum(sizes), shard)
                  for _, idxs, sizes, shard in zero.plan]
        return [b.param_shard for b in zero.buckets], leaves, layout

    def restore_from_durable(self, restore_tree):
        """Load a zero1 ``RestoreResult.tree`` (the reshard dict) into this
        optimizer for THIS world, in place: the full parameters from the
        unpacked logical buckets (this rank's shards are views of them),
        the shard optimizer's state from the new-world reslice —
        optimizer momenta survive an N→M elastic resize. Before the first
        step the layout is made here, as the first step would make it; a
        layout other than the generation's raises."""
        header = restore_tree["header"]
        zero = self._zero1()
        if len(zero.plan) != len(header["buckets"]) or any(
                tuple(p[1]) != tuple(b["idxs"]) or sum(p[2]) != b["total"]
                for p, b in zip(zero.plan, header["buckets"])):
            raise ValueError(
                "durable ZeRO-1 checkpoint bucket layout does not match "
                "this optimizer's (fusion threshold or tree changed); "
                "restore the parameters and re-run init() instead")
        order = _zero1_state_order(zero)
        want = sum(len(zero.shards) if per else 1 for _, per in order)
        restored = restore_tree["state_leaves"]
        if len(restored) != want:
            raise ValueError(
                f"inner optimizer state has {want} leaves, checkpoint has "
                f"{len(restored)} — different inner transform; re-run "
                f"init() instead")
        opt = zero.optimizer
        with torch.no_grad():
            for b, flat in zip(zero.buckets, restore_tree["full_buckets"]):
                # the padded tail stays zero
                b.params[:b.total].copy_(flat)
            it = iter(restored)
            for key, per_bucket in order:
                vals = ([next(it) for _ in zero.shards] if per_bucket
                        else [next(it)] * len(zero.shards))
                for sp, v in zip(zero.shards, vals):
                    st = opt.state[sp]
                    if key in st:
                        st[key].copy_(v)
                    elif per_bucket:
                        st[key] = v.to(sp.device) if v.dim() else v.clone()
                    else:
                        st[key] = _step_tensor(opt, sp, v)


def _zero1_state_order(zero: _Zero1) -> list:
    """The shard optimizer's state as optax lays it out, ``[(key,
    per_bucket)]``: a per-bucket key contributes every bucket's tensor in
    turn, the count one int32 scalar. Adam/AdamW: the count, every
    bucket's ``exp_avg``, every bucket's ``exp_avg_sq`` (optax: count,
    mu[0..B-1], nu[0..B-1]; with amsgrad, nu_max after them); SGD with
    momentum: every bucket's ``momentum_buffer`` (optax's trace); any
    other optimizer its state keys in sorted order, per bucket."""
    opt = zero.optimizer
    if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        order = [("step", False), ("exp_avg", True), ("exp_avg_sq", True)]
        if any(g.get("amsgrad") for g in opt.param_groups):
            order.append(("max_exp_avg_sq", True))
        return order
    if isinstance(opt, torch.optim.SGD):
        return ([("momentum_buffer", True)]
                if any(g.get("momentum") for g in opt.param_groups) else [])
    keys = sorted({k for sp in zero.shards
                   for k in opt.state.get(sp, {})})
    return [(k, True) for k in keys]


def _step_tensor(opt: torch.optim.Optimizer, param, count) -> torch.Tensor:
    """A restored step count as the optimizer keeps it: float32, on the
    parameter's device where the group is ``capturable`` or ``fused``,
    else on the CPU."""
    group = next(g for g in opt.param_groups
                 if any(p is param for p in g["params"]))
    on_dev = group.get("capturable") or group.get("fused")
    return torch.tensor(float(count), dtype=torch.float32,
                        device=param.device if on_dev else "cpu")


class DistributedDeltaAdasumOptimizer(_Wrapper):
    """Delta-model Adasum (Horovod's torch ``_DistributedAdasumOptimizer``):
    each ``step()`` stashes the parameters, runs the wrapped optimizer's
    step on the LOCAL gradients, Adasum-reduces each parameter's delta
    (new − stash) and sets the parameter to stash + reduced delta. The
    wrapped optimizer's state (AdamW's moments) advances from the local
    gradients. In a size-1 world it is exactly the wrapped step.

    The delta is a difference of fp32 parameters, so it differs from the
    update the optimizer computed by the rounding of (p + u) − p."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1):
        if _wire_codec(compression) is not None:
            raise ValueError(DELTA_ADASUM_CODEC_ERROR)
        super().__init__(optimizer, compression, backward_passes_per_step)

    def step(self, closure=None):
        if not self._due():
            return None
        eng = _engine()
        if eng.backend.size() == 1:
            return self.optimizer.step(closure)
        params = self._params_with_grads()
        stash = [p.detach().clone() for p in params]
        loss = self.optimizer.step(closure)
        step = self._next_step_name()
        with torch.no_grad():
            pending = []
            for i, (p, s) in enumerate(zip(params, stash)):
                c, ctx = self.compression.compress(p - s)
                pending.append((adasum_allreduce_handle(
                    eng, c, f"delta.adasum.s{step}.{i}"), ctx))
            for p, s, (h, ctx) in zip(params, stash, pending):
                p.copy_(s.add_(self.compression.decompress(h.synchronize(),
                                                           ctx)))
        return loss


def _axis(axis_name, mesh):
    """``(group, size, rank, collective)`` of the ranks ``axis_name`` names:
    the world for ``"world"`` with no mesh, else the axis of ``mesh`` (a
    ``parallel.mesh.TrainingMesh``), whose process group is this rank's
    line of ranks along it, or a tuple of its axes (the reference's
    ``psum`` over several axes), whose group is this rank's block of ranks
    across them. ``collective`` is False where the size is 1, which has no
    group: its reduction is the identity."""
    if mesh is None:
        if axis_name != "world":
            raise ValueError(
                f"axis_name {axis_name!r} needs mesh= (a TrainingMesh of "
                "horovod_tpu_torch.parallel.mesh.training_mesh); without "
                "one only 'world' names a group")
        backend = _engine().backend
        return None, backend.size(), backend.rank(), True
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    for name in names:
        if name not in mesh.shape:
            raise ValueError(f"mesh {mesh.shape} has no axis {name!r}")
    n = mesh.size(names)
    return mesh.group(names), n, mesh.rank_in(names), n > 1


def allreduce_gradients(grads, axis_name: str = "world", mesh=None,
                        op: ReduceOp = Average, compression=Compression.none,
                        fusion_threshold_bytes: Optional[int] = None
                        ) -> List[torch.Tensor]:
    """Reduce ``grads`` (a list of tensors) over ``axis_name``, the
    reference's ``allreduce_gradients`` (:73-135) in per-process form: the
    compressed gradients in per-dtype buckets of at most
    ``fusion_threshold_bytes`` (default 64 MB), one K1 pack and one
    ``all_reduce`` on the axis's group a bucket, Average's divide, then the
    decompressed results (views of the reduced buckets). No engine: no
    names, join rounds or replay. op Adasum over an axis is not ported.
    A wire codec (``Compression.fp8``/``.int8``) runs once a gradient
    whose dtype takes it, with no residual (:func:`distributed` carries
    one); its other gradients take the plain reduction."""
    op = ReduceOp(op)
    if op == Adasum:
        raise ValueError("op=Adasum over a mesh axis is not ported yet "
                         "(ROADMAP A9): use DistributedOptimizer(op=Adasum) "
                         "over the world")
    return _axis_reduce(list(grads), axis_name, mesh, op, compression,
                        fusion_threshold_bytes, None)


def _axis_reduce(grads, axis_name, mesh, op, compression,
                 fusion_threshold_bytes, residuals):
    """:func:`allreduce_gradients`' reduction; with a wire codec, each
    gradient it resolves for runs the compressed reduction, carrying
    ``residuals[i]`` (the padded length, in place) when given."""
    from .core.engine import _dist_op, bucket_by_size
    group, n, rank, collective = _axis(axis_name, mesh)
    wire = _wire_codec(compression)
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    plain = list(range(len(grads)))
    if wire is not None:
        if op not in (Average, Sum):
            raise ValueError(WIRE_CODEC_OP_ERROR)
        plain = []
        for i, g in enumerate(grads):
            codec = comp.resolve_codec(wire, g.dtype)
            if codec == comp.CODEC_NONE:
                plain.append(i)
                continue
            out[i] = C.ef_allreduce(
                g, None if residuals is None else residuals[i], codec,
                op == Average, group, n, rank, collective)
        if not plain:
            return out
    grads = [grads[i] for i in plain]
    packed = [compression.compress(g) for g in grads]
    cs = [c.contiguous() for c, _ in packed]
    launches = []
    for idxs in bucket_by_size(
            cs, fusion_threshold_bytes or DEFAULT_FUSION_THRESHOLD_BYTES):
        flat = kernels.pack([cs[i] for i in idxs])
        work = (dist.all_reduce(flat, op=_dist_op(op), group=group,
                                async_op=True) if collective else None)
        launches.append((idxs, flat, work))
    for idxs, flat, work in launches:
        if work is not None:
            work.wait()
        C.finish_reduce(flat, n if op == Average else 1, 1.0)
        for i, v in zip(idxs, C.unpack_flat(flat, [tuple(cs[i].shape)
                                                  for i in idxs])):
            out[plain[i]] = compression.decompress(v, packed[i][1])
    return out


class DistributedAxisOptimizer(_Wrapper):
    """What :func:`distributed` returns: ``step()`` reduces every ``p.grad``
    over the axis (:func:`allreduce_gradients`) and steps the wrapped
    optimizer; with ``shard_optimizer=True`` it is ZeRO-1 over the axis's
    group (the module's docstring), issued straight to that group. Under
    an error-feedback wire codec ``residuals`` holds each parameter's
    residual (zeros at the first reduction, ``shard_spec(numel, axis
    size)[0]`` elements, a parameter the codec does not take None), which
    each reduction carries forward in place (the reference's
    ``DistributedState.residual``)."""

    def __init__(self, optimizer: torch.optim.Optimizer, axis_name: str,
                 mesh, op, compression, backward_passes_per_step: int,
                 shard_optimizer: bool,
                 fusion_threshold_bytes: Optional[int]):
        super().__init__(optimizer, compression, backward_passes_per_step)
        self.op = ReduceOp(op)
        if self._wire_codec is not None and self.op not in (Average, Sum):
            raise ValueError(WIRE_CODEC_OP_ERROR)
        if shard_optimizer:
            _check_shardable(self.op, "shard_optimizer=True")
            if compression is not Compression.none:
                raise ValueError(AXIS_SHARDED_COMPRESSION_ERROR)
            if backward_passes_per_step != 1:
                raise ValueError(
                    "shard_optimizer=True requires backward_passes_per_step"
                    "=1 (accumulate the passes in .grad before calling step "
                    "instead)")
        elif self.op == Adasum:
            raise ValueError("op=Adasum over a mesh axis is not ported yet "
                             "(ROADMAP A9): use DistributedOptimizer("
                             "op=Adasum) over the world")
        self.axis_name, self.mesh = axis_name, mesh
        self.shard_optimizer = bool(shard_optimizer)
        self.fusion_threshold_bytes = int(fusion_threshold_bytes
                                          or DEFAULT_FUSION_THRESHOLD_BYTES)
        self.residuals: Optional[List[Optional[torch.Tensor]]] = None

    def _is_sharded(self) -> bool:
        return self.shard_optimizer

    def _residuals_of(self, params) -> Optional[list]:
        """The error-feedback residuals of ``params`` (made at the first
        reduction, for the parameters the codec takes), or None."""
        if self._wire_codec not in comp.EF_CODECS:
            return None
        if self.residuals is None:
            _, n, _, _ = _axis(self.axis_name, self.mesh)
            self.residuals = [
                None if comp.resolve_codec(self._wire_codec, p.dtype)
                not in comp.EF_CODECS else
                torch.zeros(C.shard_spec(p.numel(), n)[0], dtype=p.dtype,
                            device=p.device)
                for p in params]
        if len(self.residuals) != len(params):
            raise ValueError(
                f"distributed(): {len(params)} parameters have gradients, "
                f"{len(self.residuals)} carried a residual before; every "
                "parameter needs a gradient at each step under an "
                "error-feedback codec")
        return self.residuals

    def _zero1(self) -> _Zero1:
        if self._zero is None:
            _, n, rank, _ = _axis(self.axis_name, self.mesh)
            self._zero = _Zero1(self.optimizer, n, rank,
                                self.fusion_threshold_bytes)
        return self._zero

    def step(self, closure=None):
        if not self._due():
            return None
        if not self.shard_optimizer:
            params = self._params_with_grads()
            reduced = _axis_reduce(
                [p.grad for p in params], self.axis_name, self.mesh,
                self.op, self.compression, self.fusion_threshold_bytes,
                self._residuals_of(params))
            for p, g in zip(params, reduced):
                if g.dtype == p.grad.dtype:
                    p.grad = g
                else:
                    p.grad.copy_(g)
            return self.optimizer.step(closure)
        loss = self._closure(closure)
        zero = self._zero1()
        group, n, _, collective = _axis(self.axis_name, self.mesh)
        C.scatter_shards(zero.buckets, zero.grads(), True,
                         n if self.op == Average else 1, 1.0, 1.0, group,
                         collective)
        zero.update()
        C.gather_shards(zero.buckets, group, collective)
        return loss


def distributed(optimizer: torch.optim.Optimizer, axis_name: str = "world",
                mesh=None, op: ReduceOp = Average,
                compression=Compression.none,
                backward_passes_per_step: int = 1,
                shard_optimizer: bool = False,
                fusion_threshold_bytes: Optional[int] = None
                ) -> DistributedAxisOptimizer:
    """The reference's ``distributed`` (:149-277) for one process a device:
    wrap ``optimizer`` so that ``step()`` sees gradients reduced over
    ``axis_name`` (``"world"``, or an axis of ``mesh``, a
    ``parallel.mesh.TrainingMesh``: ``{"data": 2, "seq": 2}``'s ``"data"``
    averages over the data replicas of each seq position)::

        mesh = training_mesh({"data": 2, "seq": 2})
        opt = hvd.distributed(torch.optim.AdamW(model.parameters()),
                              axis_name="data", mesh=mesh)

    ``backward_passes_per_step=k`` sums k local passes before a reduction,
    as :class:`DistributedOptimizer` does. ``shard_optimizer=True`` is ZeRO-1
    over the axis (op Average or Sum, no compression,
    ``backward_passes_per_step=1``, the reference's restrictions :353-370).
    ``compression=Compression.fp8`` or ``.int8`` reduces each gradient
    with the wire codec and its error-feedback residual, carried in the
    wrapper (``residuals``). The packs are K1's, the collectives go
    straight to the axis's group: no engine names, join rounds or step
    replay."""
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    return DistributedAxisOptimizer(optimizer, axis_name, mesh, op,
                                    compression, backward_passes_per_step,
                                    shard_optimizer, fusion_threshold_bytes)
