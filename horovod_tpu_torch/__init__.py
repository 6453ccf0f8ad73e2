"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

The same public API, semantics and ``HOROVOD_*`` knobs as the JAX package,
on ``torch.distributed`` (NCCL on CUDA, gloo on the CPU), with the JAX
package's Pallas kernels rewritten by hand in CUDA C++ for Hopper::

    import horovod_tpu_torch as hvd
    hvd.init()                       # cuda; hvd.init(device="cpu") for gloo
    h = hvd.allreduce_async(grad, name="grad", op=hvd.Average)
    out = hvd.synchronize(h)

Ported so far: the world, the eager engine (allreduce, grouped allreduce,
allgather, broadcast, reducescatter, alltoall with uneven splits, barrier,
async handles, ``join`` for ranks that run out of data, step-capture
replay between ``step_begin``/``step_end`` as one CUDA graph), Adasum (flat
and hierarchical, ``op=hvd.Adasum``), ``DistributedOptimizer`` (ZeRO-1 with
``sharded=True``), ``DistributedDeltaAdasumOptimizer`` and the mesh-axis
wrapper ``distributed`` (``shard_optimizer=True``), the broadcast helpers and
``allreduce_sparse``, ResNet with the fused BatchNorm, ``SyncBatchNorm``
(``horovod_tpu_torch.ops.sync_batch_norm``), the decoder LM and ViT on the
flash-attention kernel, and sequence parallelism (ring attention, Ulysses,
the LM's loss and train step over a (data, seq) mesh;
``horovod_tpu_torch.parallel``), and the observability around them: the
metrics registry (``metrics_snapshot``), the trace recorder and its flight
dump, the Chrome-trace timeline (``HOROVOD_TIMELINE``), the stall inspector
and collective watchdog (``step_heartbeat``), the step-health monitor,
failpoints (``faults``) and the debug consistency check.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .common.reduce_ops import (ReduceOp, Average, Sum, Adasum, Min, Max,
                                Product,
                                handle_average_backwards_compatibility)
from .common.exceptions import (HorovodInternalError, HostsUpdatedInterrupt,
                                DuplicateNameError)
from .core.state import engine as _engine, global_state
from .version import __version__


def init(device=None):
    """Initialize the runtime on ``device`` (default ``cuda``; ``cpu`` runs
    on gloo). In a multi-process launch (``HOROVOD_TPU_COORDINATOR`` and
    ``HOROVOD_TPU_NUM_PROCESSES`` set) this joins the world; standalone it
    is a size-1 world."""
    global_state().init(device)


def shutdown():
    global_state().shutdown()


def is_initialized() -> bool:
    return global_state().initialized




def _backend():
    return _engine().backend


def rank() -> int:
    return _backend().rank()


def size() -> int:
    return _backend().size()


def local_rank() -> int:
    return _backend().local_rank()


def local_size() -> int:
    return _backend().local_size()


def cross_rank() -> int:
    return _backend().cross_rank()


def cross_size() -> int:
    return _backend().cross_size()


def is_homogeneous() -> bool:
    return _backend().is_homogeneous()


def device():
    """The ``torch.device`` this process's collectives run on."""
    return _backend().device


def mesh():
    """The 1-D world mesh of the running ``init()`` (one rank per process,
    axis ``world`` on the default process group): a
    :class:`~.parallel.mesh.TrainingMesh`, as ``training_mesh`` builds
    them."""
    _backend()
    from .parallel.mesh import world_mesh
    return world_mesh()


# Build introspection: the port's data plane is NCCL on CUDA (gloo on CPU).
def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def nccl_built() -> bool:
    return True


def gloo_built() -> bool:
    return True


def ccl_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def xla_enabled() -> bool:
    return False


def cuda_built() -> bool:
    return True


def rocm_built() -> bool:
    return False


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def allreduce_async(tensor, name: Optional[str] = None, op=None,
                    average=None, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0):
    op = handle_average_backwards_compatibility(op, average)
    if op == Adasum:
        from .ops.adasum import adasum_allreduce_handle
        return adasum_allreduce_handle(_engine(), tensor, name,
                                       prescale_factor=prescale_factor,
                                       postscale_factor=postscale_factor)
    return _engine().allreduce(tensor, name=name, op=op,
                               prescale_factor=prescale_factor,
                               postscale_factor=postscale_factor)


def allreduce(tensor, name: Optional[str] = None, op=None, average=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0):
    return allreduce_async(tensor, name, op, average, prescale_factor,
                           postscale_factor).synchronize()


def grouped_allreduce_async(tensors: Sequence, name: Optional[str] = None,
                            op=None, average=None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0):
    op = handle_average_backwards_compatibility(op, average)
    if op == Adasum:
        # Adasum's coefficients are per tensor, so fusing tensors into one
        # buffer would change the numerics: one reduction per tensor
        from .ops.adasum import adasum_allreduce_handle
        eng = _engine()
        return [adasum_allreduce_handle(
            eng, t, None if name is None else f"{name}.{i}",
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor)
            for i, t in enumerate(tensors)]
    return _engine().grouped_allreduce(tensors, name=name, op=op,
                                       prescale_factor=prescale_factor,
                                       postscale_factor=postscale_factor)


def grouped_allreduce(tensors: Sequence, name: Optional[str] = None, op=None,
                      average=None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0):
    return [h.synchronize() for h in
            grouped_allreduce_async(tensors, name, op, average,
                                    prescale_factor, postscale_factor)]


def allgather_async(tensor, name: Optional[str] = None):
    return _engine().allgather(tensor, name=name)


def allgather(tensor, name: Optional[str] = None):
    return allgather_async(tensor, name).synchronize()


def broadcast_async(tensor, root_rank: int, name: Optional[str] = None):
    return _engine().broadcast(tensor, root_rank, name=name)


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    return broadcast_async(tensor, root_rank, name).synchronize()


def alltoall_async(tensor, splits=None, name: Optional[str] = None):
    return _engine().alltoall(tensor, splits=splits, name=name)


def alltoall(tensor, splits=None, name: Optional[str] = None):
    """Without ``splits``: the received tensor alone (dim 0 divides by the
    size; rank r gets block r). With ``splits`` (rows of dim 0 for each
    rank, in rank order): ``(received tensor, received splits)``, the
    splits an int64 CPU tensor (operations.cc:951-1002)."""
    out, recv_splits = alltoall_async(tensor, splits, name).synchronize()
    if splits is None:
        return out
    return out, recv_splits


def reducescatter_async(tensor, name: Optional[str] = None, op=None):
    op = ReduceOp.SUM if op is None else ReduceOp(op)
    return _engine().reducescatter(tensor, name=name, op=op)


def reducescatter(tensor, name: Optional[str] = None, op=None):
    """Sum (or Average) over the world, this rank keeping its rows of dim 0
    (rows [r·c, min((r+1)·c, d0)), c = ceil(d0 / size))."""
    return reducescatter_async(tensor, name, op).synchronize()


def barrier():
    _engine().barrier()


def metrics_snapshot() -> dict:
    """Plain nested dict of every registered metric (counters, gauges,
    histograms, event logs) from the process-wide registry (``metrics``):
    wire bytes by op kind, dtype and link, launches, fusion-bucket fill,
    enqueue-to-complete latency, replay's counters, step health. Works
    before ``init()`` (the registry is process-wide);
    ``HOROVOD_TPU_METRICS=0`` disables collection (the snapshot is then
    empty)."""
    from . import metrics as _metrics
    return _metrics.snapshot()


def step_heartbeat(step: Optional[int] = None):
    """Liveness signal for the stall inspector: call once per train step
    (the step number, or None to count on)."""
    st = global_state()
    if st.stall_inspector is not None:
        st.stall_inspector.record_heartbeat(step)


def join() -> int:
    """This rank is out of data: keep matching the other ranks' collectives
    with zero tensors until every rank has joined, then return the last
    rank to join (the same on every rank; 0 at size 1)."""
    return _engine().join()


def poll(handle) -> bool:
    return handle.poll()


def synchronize(handle):
    return handle.synchronize()


from .optimizer import (  # noqa: E402
    DistributedDeltaAdasumOptimizer, DistributedOptimizer, distributed)
from .ops.compression import Compression  # noqa: E402
from .functions import (  # noqa: E402
    allgather_object, allreduce_sparse, broadcast_object,
    broadcast_optimizer_state, broadcast_parameters, step, step_begin,
    step_end)
from . import metrics  # noqa: E402
from . import faults  # noqa: E402
# hvd.checkpoint.CheckpointManager, as the reference reaches it (not in its
# __all__ either)
from . import checkpoint  # noqa: E402,F401

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous", "device",
    "mesh",
    "allreduce", "allreduce_async", "grouped_allreduce",
    "grouped_allreduce_async", "allgather", "allgather_async", "broadcast",
    "broadcast_async", "alltoall", "alltoall_async", "reducescatter",
    "reducescatter_async", "barrier", "join", "poll", "synchronize",
    "step_heartbeat", "step_begin", "step_end", "step", "metrics_snapshot",
    "metrics", "faults", "broadcast_parameters", "broadcast_object", "allgather_object",
    "allreduce_sparse",
    "broadcast_optimizer_state", "DistributedOptimizer",
    "DistributedDeltaAdasumOptimizer", "distributed", "Compression",
    "optimizer",
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max", "Product",
    "HorovodInternalError", "HostsUpdatedInterrupt", "DuplicateNameError",
    "__version__",
]
