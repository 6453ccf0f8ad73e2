"""Exception types (parity: horovod/common/exceptions.py:1-31)."""


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective routine is shut down or fails.

    In the elastic run loop this triggers state restore + re-rendezvous
    (reference: common/elastic.py:147-168).
    """


class HostsUpdatedInterrupt(RuntimeError):
    """Raised when the set of available hosts changed mid-training.

    ``skip_sync`` mirrors the reference's distinction between an update caused
    by host addition (state still valid, no re-sync needed) vs a failure.
    """

    def __init__(self, skip_sync: bool = False):
        super().__init__("hosts updated")
        self.skip_sync = skip_sync


class WorkerRemovedError(RuntimeError):
    """This worker's slot no longer exists in the elastic job (its host was
    scaled away). The elastic run loop exits cleanly on this (reference:
    gloo_context.cc:157-204 throws when the host is removed from the
    rendezvous plan)."""


class ConsistencyError(ValueError):
    """Cross-rank collective-submission disagreement detected by the
    debug-mode consistency checker (HOROVOD_TPU_DEBUG_CONSISTENCY=1) — the
    TPU-native analog of the coordinator's ConstructResponse validation
    (controller.cc:380-623), which rejects mismatched name/op/shape/dtype
    with the same descriptive error on every rank."""


class TensorShapeMismatchError(ConsistencyError):
    """Cross-rank shape disagreement (reference surfaces these as ERROR
    responses built in controller.cc:380-623)."""


class TensorDtypeMismatchError(ConsistencyError):
    """Cross-rank dtype disagreement (controller.cc:380-623)."""


class DuplicateNameError(ValueError):
    """A tensor with the same name was submitted twice before completion
    (reference: common.h:163-166 DUPLICATE_NAME_ERROR, tensor_queue.h:32)."""
