"""Elastic (fault-tolerant, auto-scaling) training.

The port of ``horovod_tpu/elastic/``. Parity map (reference → here):

- ``horovod/common/elastic.py`` State/ObjectState/run_fn → :mod:`.state`,
  :mod:`.run`
- ``horovod/torch/elastic.py`` TorchState → :class:`.state.TPUState`
- ``horovod/runner/elastic/discovery.py`` → :mod:`.discovery`
- ``horovod/runner/elastic/registration.py`` → :mod:`.registration`
- ``horovod/runner/elastic/driver.py`` → :mod:`.driver`
- ``horovod/runner/elastic/rendezvous.py`` → :mod:`.rendezvous`
- ``horovod/runner/elastic/worker.py`` → :mod:`.worker`

Usage (the JAX package's shape, on torch)::

    import horovod_tpu_torch as hvd

    hvd.init()
    model = Net().cuda()
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()))
    state = hvd.elastic.TPUState(params=model, opt_state=opt, batch=0)

    @hvd.elastic.run
    def train(state):
        while state.batch < n_batches:
            step(model, opt)
            state.batch += 1
            if state.batch % 10 == 0:
                state.commit()

    train(state)

launched with ``python -m horovod_tpu_torch.runner -np 2 --min-np 1
--host-discovery-script ./hosts.sh python train.py``. The driver's
journal and standby (``failover.py``) come with ROADMAP A14b: the driver
runs without them, as the reference's does when no journal is attached.
"""

from .state import State, ObjectState, TPUState
from .run import run, run_fn
from .discovery import (HostDiscovery, HostDiscoveryScript, FixedHosts,
                        HostManager, HostUpdateResult)
from .registration import WorkerStateRegistry, READY, SUCCESS, FAILURE
from .driver import ElasticDriver
from .rendezvous import ElasticRendezvousServer
from .worker import (WorkerNotificationManager, WorkerNotificationClient,
                     WorkerNotificationService, notification_manager)

__all__ = [
    "State", "ObjectState", "TPUState", "run", "run_fn",
    "HostDiscovery", "HostDiscoveryScript", "FixedHosts", "HostManager",
    "HostUpdateResult", "WorkerStateRegistry", "ElasticDriver",
    "ElasticRendezvousServer", "WorkerNotificationManager",
    "WorkerNotificationClient", "WorkerNotificationService",
    "notification_manager", "READY", "SUCCESS", "FAILURE",
]
