"""Elastic state: the in-memory checkpoint contract.

The port of ``horovod_tpu/elastic/state.py``. Parity: reference
``horovod/common/elastic.py`` — ``State`` (commit / save / restore / sync /
reset-callbacks / check_host_updates, elastic.py:26-144) and
``ObjectState``, which are the reference's line for line; plus
``TPUState``, which keeps its name so that a script written for one package
runs on the other, and plays the role of Horovod's ``TorchState``
(``torch/elastic.py:51``). Where torch requires it, ``TPUState`` differs
from the reference's pytree state:

- ``params`` is an ``nn.Module`` or a dict of tensors, ``opt_state`` a
  ``torch.optim.Optimizer`` or one of the port's distributed wrappers
  (``DistributedOptimizer``);
- ``save()`` keeps host-RAM copies of their ``state_dict()`` tensors, as
  the reference keeps ``jax.device_get`` copies: a host copy survives a
  failed world. The host buffers are kept and refilled in place by the
  next save (a pageable copy; no page is allocated twice);
- ``restore()`` loads the copies back **in place** (``load_state_dict``,
  ``copy_``), so the optimizer's parameter references stay valid: torch
  tensors change in place where jax pytrees are rebound. An optimizer
  whose state changed its layout since the save (none then, some now)
  reloads through ``load_state_dict`` instead;
- ``reset()`` restores only the plain attributes: in torch the device and
  its tensors survive a reset (the card stays the process's), where the
  reference's device arrays die with the backend and must be rehydrated;
- ``sync()`` is ``broadcast_parameters`` of each module's (or dict's)
  tensors and ``broadcast_optimizer_state`` from rank 0; a ZeRO-1
  optimizer's rank-local shards are not broadcast (build a new optimizer
  after a resize, as the reference's semantics ask);
- the durable tier goes through the port's ``CheckpointManager``: every
  save snapshots the live state dicts (``{"pytrees": {"params": ...,
  "opt_state": ...}}``, the plain attributes as extras), and a fresh
  process restores the newest generation in place
  (``training_template``'s optimizer state as the template). A ZeRO-1
  optimizer is excluded with the reference's warning.
"""

from __future__ import annotations

import copy
import logging
import queue
from typing import Any, Callable, Dict, List, Optional

import torch

from ..common.exceptions import HostsUpdatedInterrupt
from .discovery import HostUpdateResult

_LOG = logging.getLogger("horovod_tpu_torch.elastic")


class State:
    """Base elastic state (reference common/elastic.py:26-101).

    - ``commit()``: save a restore point, then check for host updates.
    - ``check_host_updates()``: raise HostsUpdatedInterrupt if the driver
      notified us of membership changes (cheap; call every batch).
    - ``save()/restore()``: host-RAM checkpoint of the tracked values.
    - ``sync()``: broadcast state from rank 0 to all workers.
    """

    def __init__(self, bcast_object: Optional[Callable] = None,
                 get_rank: Optional[Callable] = None):
        import horovod_tpu_torch as hvd
        from .. import functions
        self._bcast_object = bcast_object or functions.broadcast_object
        self._rank = get_rank or hvd.rank
        self._host_messages: "queue.Queue" = queue.Queue()
        self._last_updated_timestamp = 0
        self._reset_callbacks: List[Callable] = []

    # -- user hooks ---------------------------------------------------------

    def register_reset_callbacks(self, callbacks: List[Callable]):
        """Callbacks invoked after a reset (world resize), e.g. to rescale the
        learning rate to the new world size (reference elastic.py:44-52)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self._host_messages = queue.Queue()
        self.reset()
        for callback in self._reset_callbacks:
            callback()

    def on_hosts_updated(self, timestamp: int, update_res: int):
        """Notification-manager listener entry point."""
        self._host_messages.put((timestamp, update_res))

    # -- commit protocol ----------------------------------------------------

    def commit(self):
        self.save()
        # monotone progress marker, bumped only AFTER save() succeeds: the
        # elastic run-loop uses it to tell "training advanced since the
        # last failure" from "failing on the very same step every retry"
        # (bounded-retry escalation) — a commit whose save raises must not
        # count as progress
        self._commit_count = getattr(self, "_commit_count", 0) + 1
        self.check_host_updates()

    def check_host_updates(self):
        """Drain pending host-update messages; decide *on rank 0* whether
        membership changed, and broadcast that decision so every worker
        interrupts at the same batch (reference elastic.py:73-93 — the
        (prev, last, res) triple is synced from rank 0 before raising)."""
        prev_timestamp = self._last_updated_timestamp
        last = prev_timestamp
        all_res = HostUpdateResult.NO_UPDATE
        while not self._host_messages.empty():
            timestamp, res = self._host_messages.get()
            if timestamp > last:
                last = timestamp
            all_res |= res
        prev_timestamp, last, all_res = self._bcast_object(
            (prev_timestamp, last, all_res), name="elastic.host_updates")
        self._last_updated_timestamp = last
        if last > prev_timestamp:
            # Additions-only updates keep existing state valid: skip the
            # next sync (reference HostsUpdatedInterrupt(res == added)).
            raise HostsUpdatedInterrupt(
                skip_sync=(all_res == HostUpdateResult.ADDED))

    # -- to be implemented by subclasses ------------------------------------

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def reset(self):
        pass


class ObjectState(State):
    """State of arbitrary picklable attributes (reference
    common/elastic.py:104-144). Attributes are set via kwargs and tracked;
    ``sync`` broadcasts the attribute dict from rank 0."""

    def __init__(self, bcast_object: Optional[Callable] = None,
                 get_rank: Optional[Callable] = None, **kwargs):
        self._saved_state: Dict[str, Any] = kwargs
        super().__init__(bcast_object=bcast_object, get_rank=get_rank)
        self._set_attrs()

    def save(self):
        new_state = {}
        for attr in self._saved_state.keys():
            new_state[attr] = getattr(self, attr)
        self._saved_state = new_state

    def restore(self):
        self._set_attrs()

    def sync(self):
        if self._saved_state:
            self._saved_state = self._bcast_object(
                self._saved_state, name="elastic.object_state")
            self._set_attrs()

    def _set_attrs(self):
        for attr, value in self._saved_state.items():
            setattr(self, attr, value)


# -- the tracked objects of TPUState ----------------------------------------

def _is_optimizer(obj) -> bool:
    return isinstance(obj, torch.optim.Optimizer) or isinstance(
        getattr(obj, "optimizer", None), torch.optim.Optimizer)


def _is_sharded(obj) -> bool:
    """A ZeRO-1 optimizer: its state is this rank's shard."""
    return bool(getattr(obj, "_is_sharded", lambda: False)())


def _torch_optimizer(obj) -> torch.optim.Optimizer:
    """The ``torch.optim`` optimizer whose ``state_dict()`` ``obj``'s is."""
    if isinstance(obj, torch.optim.Optimizer):
        return obj
    if _is_sharded(obj):
        return obj._zero1().optimizer
    return obj.optimizer


def _live(obj):
    """The tracked object's tensors, as a state-dict tree of the live
    tensors (no copy)."""
    if isinstance(obj, torch.nn.Module) or _is_optimizer(obj):
        return obj.state_dict()
    if isinstance(obj, dict):
        return obj
    raise TypeError(f"TPUState tracks an nn.Module, a dict of tensors or "
                    f"an optimizer, not {type(obj).__name__}")


def _host_copy(tree, into=None):
    """``tree`` with every tensor copied to host memory, into the matching
    tensor of ``into`` (a previous copy) where there is one."""
    if isinstance(tree, torch.Tensor):
        src = tree.detach()
        if (isinstance(into, torch.Tensor) and into.device.type == "cpu"
                and into.shape == src.shape and into.dtype == src.dtype
                and into.data_ptr() != src.data_ptr()):
            into.copy_(src)
            return into
        return src.to("cpu", copy=True)
    if isinstance(tree, dict):
        out = type(tree)()
        for k, v in tree.items():
            out[k] = _host_copy(v, into.get(k) if isinstance(into, dict)
                                else None)
        meta = getattr(tree, "_metadata", None)
        if meta is not None:   # nn.Module.state_dict()'s versions
            out._metadata = copy.deepcopy(meta)
        return out
    if isinstance(tree, (list, tuple)):
        same = isinstance(into, (list, tuple)) and len(into) == len(tree)
        return type(tree)(_host_copy(v, into[i] if same else None)
                          for i, v in enumerate(tree))
    return copy.deepcopy(tree)


def _clone(tree):
    """``tree`` with every tensor cloned: a load must never alias the
    saved copy (``load_state_dict`` keeps a tensor already on the target
    device as it is, and the optimizer updates its state in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        out = type(tree)((k, _clone(v)) for k, v in tree.items())
        meta = getattr(tree, "_metadata", None)
        if meta is not None:
            out._metadata = meta
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return copy.deepcopy(tree)


def _same_layout(live, saved) -> bool:
    """Whether two trees have the same structure and tensor shapes."""
    if isinstance(live, torch.Tensor) or isinstance(saved, torch.Tensor):
        return (isinstance(live, torch.Tensor)
                and isinstance(saved, torch.Tensor)
                and live.shape == saved.shape and live.dtype == saved.dtype)
    if isinstance(live, dict) or isinstance(saved, dict):
        return (isinstance(live, dict) and isinstance(saved, dict)
                and live.keys() == saved.keys()
                and all(_same_layout(live[k], saved[k]) for k in live))
    if isinstance(live, (list, tuple)) or isinstance(saved, (list, tuple)):
        return (isinstance(live, (list, tuple))
                and isinstance(saved, (list, tuple))
                and len(live) == len(saved)
                and all(_same_layout(a, b) for a, b in zip(live, saved)))
    return True


def _load_optimizer(obj, saved: dict):
    """Load a saved optimizer state dict, in place where its layout is
    the live one's."""
    live = obj.state_dict()
    if not (_same_layout(live["state"], saved["state"])
            and len(live["param_groups"]) == len(saved["param_groups"])):
        obj.load_state_dict(_clone(saved))
        return
    opt = _torch_optimizer(obj)
    with torch.no_grad():
        for idx, entry in saved["state"].items():
            dst = live["state"][idx]   # the optimizer's own dict
            for key, value in entry.items():
                if isinstance(value, torch.Tensor):
                    dst[key].copy_(value)
                else:
                    dst[key] = copy.deepcopy(value)
    for group, want in zip(opt.param_groups, saved["param_groups"]):
        for key, value in want.items():
            if key != "params":
                group[key] = copy.deepcopy(value)


def _load(obj, saved):
    """Load ``saved`` (a host copy or a restored tree) into the tracked
    object in place. Returns the object, or the tree to rebind a dict
    whose layout changed to."""
    if isinstance(obj, torch.nn.Module):
        obj.load_state_dict(saved)
        return obj
    if _is_optimizer(obj):
        _load_optimizer(obj, saved)
        return obj
    if _same_layout(obj, saved):
        with torch.no_grad():
            for k, t in obj.items():
                if isinstance(t, torch.Tensor):
                    t.copy_(saved[k])
                else:
                    obj[k] = copy.deepcopy(saved[k])
        return obj
    return _clone(saved)


class TPUState(ObjectState):
    """Elastic state of a torch training loop: tracks ``params`` (an
    ``nn.Module`` or a dict of tensors) and ``opt_state`` (an optimizer)
    plus plain object attributes. The name is the JAX package's; the role
    is Horovod's ``TorchState`` (torch/elastic.py:51): the tensors are
    committed to host RAM and restored in place, and broadcast from the
    longest-surviving rank 0 after a reset (module docstring)."""

    PYTREE_ATTRS = ("params", "opt_state")

    def __init__(self, params=None, opt_state=None,
                 bcast_object: Optional[Callable] = None,
                 get_rank: Optional[Callable] = None, **kwargs):
        self._pytrees: Dict[str, Any] = {}
        self._saved_pytrees: Dict[str, Any] = {}
        # durable-tier bookkeeping: the number of saves this process has
        # made — compared against the newest on-disk/peer generation's
        # step so a SURVIVING process keeps trusting its in-memory commit
        # while a fresh one (preempted host) restores from the durable tier
        self._durable_step = 0
        self._warned_sharded = False
        if params is not None:
            self._pytrees["params"] = params
        if opt_state is not None:
            self._pytrees["opt_state"] = opt_state
        super().__init__(bcast_object=bcast_object, get_rank=get_rank,
                         **kwargs)
        self._save_pytrees()

    # tracked objects are exposed as normal attributes
    def __getattr__(self, name):
        trees = self.__dict__.get("_pytrees", {})
        if name in trees:
            return trees[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self.PYTREE_ATTRS:
            self._pytrees[name] = value
        else:
            super().__setattr__(name, value)

    def _host_copies(self) -> Dict[str, Any]:
        return {k: _host_copy(_live(v), self._saved_pytrees.get(k))
                for k, v in self._pytrees.items()}

    def _save_pytrees(self):
        from ..core.engine import _translate_failure
        # commit() is the per-batch sync point of an elastic loop: a failed
        # world first surfaces HERE, at the device-to-host copy — translate
        # it so the run-loop's restore/retry sees HorovodInternalError
        self._saved_pytrees = _translate_failure(self._host_copies)

    def save(self):
        self._save_pytrees()
        super().save()
        self._durable_delegate()

    # -- durable tier (checkpoint/) -----------------------------------------

    @staticmethod
    def _checkpoint_manager():
        from ..core.state import global_state
        return global_state().checkpoint_manager

    def _durable_delegate(self):
        """When ``HOROVOD_TPU_CHECKPOINT_DIR`` is set (the manager
        exists), every save also requests an async durable snapshot —
        captured now on the device, written off the step path (see
        CheckpointManager). A ZeRO-1 optimizer is excluded: its state is
        rank-local shards (the same reason ``broadcast_optimizer_state``
        refuses it) — after a durable restore build it anew; direct users
        keep momenta via ``CheckpointManager.snapshot_zero1``."""
        mgr = self._checkpoint_manager()
        if mgr is None:
            return
        trees = {k: _live(v) for k, v in self._pytrees.items()
                 if not _is_sharded(v)}
        if len(trees) != len(self._pytrees) and not self._warned_sharded:
            self._warned_sharded = True
            _LOG.warning(
                "durable checkpoint excludes the ZeRO-1 sharded optimizer "
                "state (rank-local shards; build the optimizer anew after a "
                "durable restore). Use CheckpointManager.snapshot_zero1 to "
                "persist momenta.")
        self._durable_step += 1
        mgr.snapshot({"pytrees": trees}, self._durable_step,
                     extras=dict(self._saved_state))

    def _template(self) -> Dict[str, Any]:
        from ..checkpoint.manager import optimizer_template
        out = {}
        for k, v in self._pytrees.items():
            if _is_sharded(v):
                continue
            out[k] = optimizer_template(v) if _is_optimizer(v) else _live(v)
        return out

    def _restore_durable(self, mgr) -> bool:
        """Load the newest durable generation into this state. Returns
        False (with a WARNING) when nothing restorable exists or the
        checkpoint does not fit the live state — the caller then falls
        back to the in-memory commit."""
        from ..checkpoint import CheckpointRestoreError
        try:
            # no generation: the common clean case (a durable-enabled job
            # reset before its first commit) — and the template's
            # optimizer step must not run then
            if mgr.latest_generation() is None:
                _LOG.debug("no durable generation to restore")
                return False
            res = mgr.restore_latest(template={"pytrees": self._template()})
        except CheckpointRestoreError as e:
            _LOG.debug("no durable generation to restore (%s)", e)
            return False
        except Exception as e:  # noqa: BLE001  fall back, loudly
            _LOG.warning("durable restore failed (%s); falling back to "
                         "the in-memory commit", e)
            return False
        for k, tree in res.tree["pytrees"].items():
            self._pytrees[k] = _load(self._pytrees[k], tree)
        self._save_pytrees()
        if res.extras:
            self._saved_state = dict(res.extras)
            self._set_attrs()
        self._durable_step = res.step
        _LOG.info("restored durable checkpoint generation step=%d "
                  "(world_version=%d, mode=%s)", res.step,
                  res.world_version, res.mode)
        return True

    def restore(self):
        # Durable tier first — but only when this process has no
        # in-memory commit of its own (``_durable_step == 0``: a fresh
        # process after host preemption, or a crash before the first
        # commit). A surviving process's in-memory commit is always at
        # least as new as anything durable (saves precede snapshots), so
        # it keeps the cheap path and pays no discovery I/O per reset.
        mgr = self._checkpoint_manager()
        if mgr is not None and self._durable_step == 0 and \
                self._restore_durable(mgr):
            super().restore()
            return
        for k, saved in self._saved_pytrees.items():
            self._pytrees[k] = _load(self._pytrees[k], saved)
        super().restore()

    def reset(self):
        # the tensors survive the reset in place: only the plain
        # attributes go back to the last commit
        ObjectState.restore(self)

    def sync(self):
        from .. import functions
        for obj in self._pytrees.values():
            if _is_optimizer(obj):
                if not _is_sharded(obj):
                    functions.broadcast_optimizer_state(obj, root_rank=0)
            else:
                functions.broadcast_parameters(_live(obj), root_rank=0)
        self._save_pytrees()
        super().sync()
